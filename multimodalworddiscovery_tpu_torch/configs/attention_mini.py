"""BASELINE.json config #3: attention-based seq2seq speech -> image-concept
aligner (SpeechCOCO in the reference; synthetic corpus here)."""

from multimodalworddiscovery_tpu_torch.core.config import base_config


def get_config():
    cfg = base_config()
    cfg.model.name = "attention"
    cfg.data.source = "synthetic"
    cfg.data.n_utterances = 500
    cfg.train.num_iterations = 300  # gradient steps
    cfg.train.checkpoint_every = 100
    cfg.eval.retrieval = False
    return cfg
