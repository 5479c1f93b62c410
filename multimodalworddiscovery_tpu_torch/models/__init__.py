"""Aligner models (functional API, as in the reference):

  init(corpus, ...) -> params
  em_step(params, corpus) -> (params, stats)
  align(params, corpus) -> [N, Ts] int32   # 0 = NULL, else 1-based trg position
  loglik(params, corpus) -> scalar

Ported so far: ``hmm`` (discrete HMM) and ``hmm_gaussian`` (Gaussian /
GMM-emission HMM) on ``hmm_core``.
"""
