"""BASELINE.json config #1: IBM Model-1 / mixture aligner EM on phone
transcripts + concept labels, here on the synthetic flickr8k-mini (real
Flickr8k loads via data.source='disk')."""

from multimodalworddiscovery_tpu_torch.core.config import base_config


def get_config():
    cfg = base_config()
    cfg.model.name = "model1"
    cfg.data.source = "synthetic"
    cfg.data.n_utterances = 200
    cfg.train.num_iterations = 20
    return cfg
