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


def masked_log(p: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """log(p) with zeros (and masked entries) mapped to NEG_INF, never nan."""
    safe = torch.where(p > 0, p, 1.0)
    out = torch.where(p > 0, torch.log(safe), NEG_INF)
    if mask is not None:
        out = torch.where(mask, out, NEG_INF)
    return out


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


# Bytes of the broadcast [rows, K, J] block ``log_matmul`` builds at a time.
LOG_MATMUL_CHUNK_BYTES = 1 << 28


def log_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Log-semiring "matmul": out[..., i, j] = logsumexp_k a[..., i, k] + b[..., k, j].

    The broadcast form of the reference (``core/logsemiring.log_matmul``),
    with its masking: a row or column of all NEG_INF gives NEG_INF, never
    nan.  Leading dimensions broadcast.  The [..., I, K, J] sum it reduces
    is built a block of matrices (or of rows of one matrix) at a time, at
    most ``LOG_MATMUL_CHUNK_BYTES``, so memory stays bounded however many
    products the batch holds.  This is K8's plain version (``ops/log_semiring``).
    """
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    ni, nk = a.shape[-2:]
    nj = b.shape[-1]
    a3 = a.expand(*batch, ni, nk).reshape(-1, ni, nk)
    b3 = b.expand(*batch, nk, nj).reshape(-1, nk, nj)
    out = torch.empty((a3.shape[0], ni, nj), dtype=a3.dtype, device=a3.device)
    rows = max(1, LOG_MATMUL_CHUNK_BYTES // max(1, nk * nj * a3.element_size()))
    mats = max(1, rows // max(1, ni))
    rows = min(rows, ni)
    for z in range(0, a3.shape[0], mats):
        for i in range(0, ni, rows):
            x = a3[z:z + mats, i:i + rows, :, None] + b3[z:z + mats, None, :, :]
            out[z:z + mats, i:i + rows] = masked_logsumexp(x, dim=-2)
    return out.reshape(*batch, ni, nj)


def max_matmul(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-plus semiring product with argmax, for Viterbi: (values, argmax_k)
    with values[..., i, j] = max_k a[..., i, k] + b[..., k, j].  The index
    is ``torch.argmax``'s, the first maximum, as ``jnp.argmax`` gives it."""
    x = a[..., :, :, None] + b[..., None, :, :]
    return torch.amax(x, dim=-2), torch.argmax(x, dim=-2)
