"""Model registry: name -> aligner module implementing the functional API
(init / em_step or train / align / loglik), under the reference's names
(``multimodalworddiscovery_tpu/models/registry.py``)."""

from __future__ import annotations

import importlib
from types import ModuleType

MODELS = ("model1", "hmm", "hmm_gaussian", "hmm_dnn", "hmm_crf", "attention", "grounding",
          "segmental_kmeans")


def get_model(name: str) -> ModuleType:
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {', '.join(MODELS)}")
    return importlib.import_module(f"multimodalworddiscovery_tpu_torch.models.{name}")
