"""BASELINE.json config #2: discrete HMM aligner with forward-backward /
Viterbi on phone transcripts + image concepts (synthetic flickr8k-mini; real
Flickr8k loads via data.source='disk').  On the card EM runs through K1 +
K2 and decode through K3."""

from multimodalworddiscovery_tpu_torch.core.config import base_config


def get_config():
    cfg = base_config()
    cfg.model.name = "hmm"
    cfg.model.max_jump = 3
    cfg.data.source = "synthetic"
    cfg.data.n_utterances = 200
    cfg.train.num_iterations = 15
    return cfg
