"""Evaluation on the device: alignment, word IoU, boundary, purity and NMI
metrics (``metrics``), cross-modal retrieval scores and recall
(``retrieval``) and segment DTW (``dtw``)."""

from multimodalworddiscovery_tpu_torch.eval.metrics import (
    alignment_prf,
    boundary_prf,
    cluster_nmi,
    cluster_purity,
    word_iou,
)

__all__ = ["alignment_prf", "boundary_prf", "cluster_nmi", "cluster_purity", "word_iou"]
