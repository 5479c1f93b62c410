"""Core utilities: log-semiring math, masking, expected-count helpers."""

from multimodalworddiscovery_tpu_torch.core.logsemiring import (
    NEG_INF,
    log_matmul,
    log_normalize,
    masked_log,
    masked_logsumexp,
    max_matmul,
)
from multimodalworddiscovery_tpu_torch.core.masking import (
    lengths_to_mask,
    pad_and_stack,
    pair_mask,
)

__all__ = [
    "NEG_INF",
    "log_matmul",
    "log_normalize",
    "masked_log",
    "masked_logsumexp",
    "max_matmul",
    "lengths_to_mask",
    "pad_and_stack",
    "pair_mask",
]
