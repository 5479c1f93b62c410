"""Float64 NumPy oracles.

Per-utterance-loop reimplementations of every algorithm, written the way the
reference writes them (Python ``for`` loops over utterances, NumPy inner
math, float64).  The port keeps its own copies: they import numpy and scipy
only, so they run on any host the port runs on.  They serve two purposes:

1. Parity oracles for the port's batched torch paths and CUDA kernels.
2. The CPU reference whose throughput is the denominator of a benchmark
   of the port (``numpy_hmm.NumpyHMM`` over bench.py's oracle corpus).
"""
