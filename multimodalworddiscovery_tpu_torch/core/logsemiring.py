"""Log-semiring primitives shared by every aligner.

Counterpart of ``multimodalworddiscovery_tpu/core/logsemiring.py``.
Everything is batched float32 in log space; padding carries ``NEG_INF``
and must never poison a reduction with ``inf - inf = nan``.
"""

from __future__ import annotations

import torch

# Large finite negative instead of -inf: exp(NEG_INF) == 0 in f32, and
# NEG_INF + NEG_INF does not overflow to nan.
NEG_INF = -1e30


def masked_logsumexp(
    x: torch.Tensor, dim: int = -1, keepdim: bool = False
) -> torch.Tensor:
    """logsumexp along ``dim`` of NEG_INF-padded values; all-padding -> NEG_INF.

    Safe against every entry being NEG_INF (returns NEG_INF, not nan).
    """
    m = torch.amax(x, dim=dim, keepdim=True)
    # rows that are entirely NEG_INF: shift by 0 so exp(NEG_INF) == 0 cleanly
    m_safe = torch.where(m > NEG_INF / 2, m, 0.0)
    s = torch.sum(torch.exp(x - m_safe), dim=dim, keepdim=True)
    out = torch.where(m > NEG_INF / 2, torch.log(s) + m_safe, NEG_INF)
    if not keepdim:
        out = out.squeeze(dim)
    return out


def log_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Normalize in log space: x - logsumexp(x); all-padding rows stay NEG_INF."""
    z = masked_logsumexp(x, dim=dim, keepdim=True)
    z = torch.where(z > NEG_INF / 2, z, 0.0)  # avoid NEG_INF - NEG_INF
    return x - z
