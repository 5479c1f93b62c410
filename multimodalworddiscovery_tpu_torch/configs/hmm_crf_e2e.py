"""Fully end-to-end differentiable DNN-HMM: emissions and transitions
trained by Adam through the marginal likelihood (models/hmm_crf.py:
logmarginal_e2e, exact CRF moment gradients for log_jump / log_p0)."""

from multimodalworddiscovery_tpu_torch.core.config import base_config


def get_config():
    cfg = base_config()
    cfg.model.name = "hmm_crf"
    cfg.model.learn_transitions = True
    cfg.model.hidden = 256
    cfg.model.n_sgd = 4
    cfg.model.learning_rate = 1e-3
    cfg.data.continuous = True
    cfg.data.feat_dim = 12
    cfg.data.n_utterances = 400
    cfg.train.num_iterations = 20
    cfg.eval.retrieval = False
    return cfg
