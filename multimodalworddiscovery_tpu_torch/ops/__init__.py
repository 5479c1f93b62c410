"""Hand-written CUDA kernels for Hopper, each with its plain-torch version.

counts       K1 emission-table lookup    (csrc/counts.cu)
             K7 pair counts from gamma   (csrc/counts.cu)
hmm_fwdbwd   K2 fused E-step with counts (csrc/hmm_estep_counts.cu), and K2-bf16
             K4 general E-step -> gamma  (csrc/hmm_estep.cu), and K4-bf16
             K6 K4 with rematerialized alphas (hmm_estep(remat=True), csrc/hmm_estep.cu)
             (K2's and K4's kernel bodies: csrc/estep.cuh)
viterbi      K3 Viterbi decode           (csrc/viterbi.cu)
             (the length order of K2, K3 and K4: csrc/order.cuh)
mfcc         K5 fused MFCC / log-mels    (csrc/mfcc.cu)
log_semiring K8 log-semiring matmul      (csrc/log_semiring.cu), and K8-bf16
_build       nvcc build at first use + ctypes binding

A wrapper takes the plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises); each counts its launches in ``.launches``
(the E-step wrappers and ``log_matmul`` count their variants apart, in
``.launches_bf16`` and ``.launches_remat``).
Callers that choose between a kernel and its plain version take
``use_kernels=None`` and resolve it with ``kernels_for``.
"""

from __future__ import annotations

import torch


def kernels_for(use_kernels: bool | None, device: torch.device) -> bool:
    """``use_kernels`` as given, or for None whether ``device`` is a CUDA
    device."""
    return device.type == "cuda" if use_kernels is None else bool(use_kernels)
