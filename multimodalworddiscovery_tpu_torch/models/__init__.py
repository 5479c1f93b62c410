"""Aligner models (functional API, as in the reference):

  init(corpus, ...) -> params
  em_step(params, corpus) -> (params, stats)
  align(params, corpus) -> [N, Ts] int32   # 0 = NULL, else 1-based trg position
  loglik(params, corpus) -> scalar

Ported so far, on ``hmm_core``: ``hmm`` (discrete HMM), ``hmm_gaussian``
(Gaussian / GMM-emission HMM), ``hmm_dnn`` (DNN-HMM hybrid, generalized EM)
and ``hmm_crf`` (its end-to-end differentiable variant, optionally learning
the transitions); and ``model1`` (IBM Model-1), ``attention`` (transformer
aligner, optionally HMM-guided), ``grounding`` (audio-visual matchmap
baseline) and ``segmental_kmeans`` (audio-only ES-KMeans / GMM).
``minibatch`` runs the gradient models' steps on on-device minibatches;
``registry.get_model`` maps the reference's names onto these modules.
"""
