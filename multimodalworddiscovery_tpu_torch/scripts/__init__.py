"""Command-line scripts of the port (run with ``python -m``):

run_pipeline      config #4 end to end: waveforms -> K5 -> K4 EM -> K3 decode
extract_features  speech: .npz of waveforms -> .npz of MFCC / fbank features
bench_kernels     K1 / K7 (counts) and K8 (log_matmul) timed on the card -> JSON lines
bench_assoc       the sequential and matrix-product forward passes timed on the card
"""
