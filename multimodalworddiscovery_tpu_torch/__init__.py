"""multimodalworddiscovery_tpu_torch — the PyTorch + CUDA port.

Counterpart of ``multimodalworddiscovery_tpu`` (the JAX reference, which
stays beside it): module paths mirror the reference so each function's
counterpart is easy to find.  Plain tensor code is PyTorch; every Pallas
kernel on the ported path is a hand-written CUDA kernel for Hopper
(``csrc/``, built at first use by ``ops/_build.py``), with its plain-torch
version beside it in the same ``ops`` module.

This package imports torch, numpy and the standard library only — never
jax, flax, optax, orbax or the reference package.

Ported so far (slice 1, the headline discrete-HMM path; slice 2, the
Gaussian-HMM aligner of the stretch config):

core      NEG_INF log-semiring helpers, masking, gather/scatter counts
data      torch ``Corpus`` (ids or frames), ``GoldAnnotations``,
          ``make_flickr8k_mini``, ``phones_to_frames``
ops       K1 emission lookup, K2 fused E-step, K4 general E-step and K3
          Viterbi decode (CUDA) + plain versions
models    hmm_core (state space, fwd/bwd, Viterbi), hmm (discrete EM,
          align) and hmm_gaussian (GMM emissions, VQ teacher, annealed EM)
frontend  vq (k-means frame quantizer)
segment   alignment -> word units, boundaries
eval      alignment, word IoU, boundary, purity and NMI metrics
"""

__version__ = "0.1.0"
