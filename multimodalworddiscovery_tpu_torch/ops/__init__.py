"""Hand-written CUDA kernels for Hopper, each with its plain-torch version.

counts       K1 emission-table lookup    (csrc/counts.cu)
hmm_fwdbwd   K2 fused E-step with counts (csrc/hmm_fwdbwd.cu)
             K4 general E-step -> gamma  (csrc/hmm_fwdbwd.cu)
viterbi      K3 Viterbi decode           (csrc/viterbi.cu)
_build       nvcc build at first use + ctypes binding

A wrapper takes the plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises); each counts its launches in ``.launches``.
"""
