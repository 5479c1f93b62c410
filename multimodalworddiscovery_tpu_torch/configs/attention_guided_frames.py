"""Guided attention on continuous frames as a plain ``mwd-torch train``
config: a GMM-HMM teacher (model.guide=hmm_gaussian, trained inline for
guide_iters EM iterations) -> an attention student supervised by the
teacher's posteriors.

Pairs with hmm_gaussian_mini.py (the standalone teacher config) to
reproduce the teacher-student alternation from the CLI.  Synthetic-frames
corpus; scale n_utterances up and set train.batch_size for larger runs.
"""

from multimodalworddiscovery_tpu_torch.core.config import base_config


def get_config():
    cfg = base_config()
    cfg.model.name = "attention"
    cfg.model.guide = "hmm_gaussian"
    cfg.model.guide_iters = 15
    cfg.model.guide_weight = 1.0
    cfg.model.n_components = 2
    cfg.model.dim = 128
    cfg.model.learning_rate = 3e-4
    cfg.data.continuous = True
    cfg.data.feat_dim = 13
    cfg.data.n_utterances = 800
    cfg.train.num_iterations = 400
    cfg.train.checkpoint_every = 100
    cfg.eval.retrieval = False
    return cfg
