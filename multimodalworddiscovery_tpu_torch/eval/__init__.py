"""Evaluation metrics, computed on the device (alignment P/R/F1 + AER so far)."""

from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf

__all__ = ["alignment_prf"]
