"""End-to-end differentiable DNN-HMM (models/hmm_crf.py) on continuous
frames: marginal-likelihood gradients through the aligner with a
self-consistent prior (see also hmm_gaussian_mini.py)."""

from multimodalworddiscovery_tpu_torch.core.config import base_config


def get_config():
    cfg = base_config()
    cfg.model.name = "hmm_crf"
    cfg.model.hidden = 256
    cfg.model.n_sgd = 4
    cfg.model.learning_rate = 1e-3
    cfg.data.continuous = True
    cfg.data.feat_dim = 12
    cfg.data.n_utterances = 400
    cfg.train.num_iterations = 10
    cfg.eval.retrieval = False
    return cfg
