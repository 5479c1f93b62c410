"""BASELINE.json config #5 (stretch): HuBERT speech + CLIP region
embeddings at the documented dimensionalities, with random-projection
stand-ins for the pretrained features (no network to fetch weights).  Swap
data.source='disk' archives of real embeddings in and nothing else
changes."""

from multimodalworddiscovery_tpu_torch.core.config import base_config


def get_config():
    cfg = base_config()
    cfg.model.name = "hmm_gaussian"
    cfg.model.max_jump = 5
    cfg.data.source = "synthetic"
    cfg.data.n_utterances = 4000
    cfg.data.continuous = True
    cfg.data.feat_dim = 64  # stand-in for (PCA'd) HuBERT features
    # dense-region images: up to 32 concepts/image -> S = 64 alignment
    # states (K4 for the Gaussian E-step, K1 + K2 for the VQ teacher)
    cfg.data.n_concepts = 200
    cfg.data.min_concepts = 16
    cfg.data.max_concepts = 32
    # the dense-region seeding recipe: k-means codebook -> discrete-HMM
    # teacher -> emission fit from teacher posteriors, then annealed EM
    cfg.model.init = "vq_teacher"
    cfg.model.anneal_iters = 6
    cfg.train.num_iterations = 10
    cfg.train.data_parallel = True
    # the E-step over 4 corpus chunks: a quarter of the activation memory,
    # the same counts
    cfg.train.corpus_chunks = 4
    # full N x N retrieval re-pairs every caption with all 4000 dense-region
    # images; score 100-image candidate pools instead (the O(N*C) protocol)
    cfg.eval.retrieval_pool = 100
    return cfg
