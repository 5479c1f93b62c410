"""BASELINE.json config #4: end-to-end pipeline, Gaussian HMM alignment +
word segmentation over a full corpus (MSCOCO in the reference; synthetic
continuous corpus here; the MFCC frontend, K5, runs in
scripts/run_pipeline.py when raw waveforms are the input).

This config is the RESIDENT variant (corpus in memory).  The
reference-corpus-scale run (N=131,072 utterances, waveforms -> K5 MFCC ->
shards -> streamed EM -> streamed align / segment / evaluate, host RSS
bounded by one batch) is
``python -m multimodalworddiscovery_tpu_torch.scripts.run_pipeline_fullscale``."""

from multimodalworddiscovery_tpu_torch.core.config import base_config


def get_config():
    cfg = base_config()
    cfg.model.name = "hmm_gaussian"
    cfg.data.source = "synthetic"
    cfg.data.n_utterances = 2000
    cfg.data.continuous = True
    cfg.data.feat_dim = 16
    cfg.train.num_iterations = 15
    cfg.train.data_parallel = True
    return cfg
