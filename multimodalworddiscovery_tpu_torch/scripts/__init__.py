"""Command-line scripts of the port (run with ``python -m``):

run_pipeline      config #4 end to end: waveforms -> K5 -> K4 EM -> K3 decode
run_pipeline_fullscale  config #4 out of core at N=131,072 through the CLI
extract_features  speech: .npz of waveforms -> .npz of MFCC / fbank features
bench_kernels     K1 / K7 (counts) and K8 (log_matmul) timed on the card -> JSON lines
bench_assoc       the sequential and matrix-product forward passes timed on the card
"""
