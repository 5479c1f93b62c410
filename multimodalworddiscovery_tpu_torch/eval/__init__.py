"""Evaluation metrics, computed on the device: alignment, word IoU,
boundary, purity and NMI."""

from multimodalworddiscovery_tpu_torch.eval.metrics import (
    alignment_prf,
    boundary_prf,
    cluster_nmi,
    cluster_purity,
    word_iou,
)

__all__ = ["alignment_prf", "boundary_prf", "cluster_nmi", "cluster_purity", "word_iou"]
