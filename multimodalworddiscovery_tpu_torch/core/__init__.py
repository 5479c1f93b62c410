"""Core utilities: log-semiring math, masking, expected-count helpers."""

from multimodalworddiscovery_tpu_torch.core.logsemiring import (
    NEG_INF,
    log_normalize,
    masked_logsumexp,
)
from multimodalworddiscovery_tpu_torch.core.masking import (
    lengths_to_mask,
    pad_and_stack,
)

__all__ = [
    "NEG_INF",
    "log_normalize",
    "masked_logsumexp",
    "lengths_to_mask",
    "pad_and_stack",
]
