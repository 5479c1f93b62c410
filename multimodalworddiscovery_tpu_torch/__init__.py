"""multimodalworddiscovery_tpu_torch — the PyTorch + CUDA port.

Counterpart of ``multimodalworddiscovery_tpu`` (the JAX reference, which
stays beside it): module paths mirror the reference so each function's
counterpart is easy to find.  Plain tensor code is PyTorch; every Pallas
kernel on the ported path is a hand-written CUDA kernel for Hopper
(``csrc/``, built at first use by ``ops/_build.py``), with its plain-torch
version beside it in the same ``ops`` module.

This package imports torch, numpy and the standard library only — never
jax, flax, optax, orbax or the reference package.

Ported so far (slice 1, the headline discrete-HMM path):

core      NEG_INF log-semiring helpers, masking, gather/scatter counts
data      torch ``Corpus``, ``GoldAnnotations``, ``make_flickr8k_mini``
ops       K1 emission lookup and K2 fused E-step (CUDA) + plain versions
models    hmm_core (state space, fwd/bwd, Viterbi) and hmm (EM, align)
segment   alignment -> word units
eval      alignment P/R/F1 + AER
"""

__version__ = "0.1.0"
