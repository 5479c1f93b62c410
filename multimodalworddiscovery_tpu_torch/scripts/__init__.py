"""Command-line scripts of the port (run with ``python -m``):

run_pipeline      config #4 end to end: waveforms -> K5 -> K4 EM -> K3 decode
extract_features  speech: .npz of waveforms -> .npz of MFCC / fbank features
"""
