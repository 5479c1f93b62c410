"""BASELINE.json config #2 (continuous variant): Gaussian-emission HMM on
MFCC-like frames + image concepts (synthetic frames via phones_to_frames)."""

from multimodalworddiscovery_tpu_torch.core.config import base_config


def get_config():
    cfg = base_config()
    cfg.model.name = "hmm_gaussian"
    cfg.model.max_jump = 3
    cfg.data.source = "synthetic"
    cfg.data.n_utterances = 100
    cfg.data.continuous = True
    cfg.data.feat_dim = 16
    cfg.train.num_iterations = 12
    return cfg
