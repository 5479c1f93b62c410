"""Emission-table lookups and expected-count accumulation, plain torch.

Counterpart of ``multimodalworddiscovery_tpu/core/counts.py``.  The
reference writes both as one-hot matmuls because gathers and scatters were
slow on the TPU; on a GPU an index gather is exact and the natural form, and
a scatter-add (``index_add_``) accumulates the counts.  These are the plain
versions of the K1 lookup kernel and of K2's count half (``ops/``);
``select_columns`` picks each state's column of per-concept emissions.
"""

from __future__ import annotations

import torch


def table_lookup(
    table: torch.Tensor,    # [F, E]
    row_ids: torch.Tensor,  # [N, T] int
    col_ids: torch.Tensor,  # [N, K] int
) -> torch.Tensor:
    """out[n, t, k] = table[row_ids[n, t], col_ids[n, k]]  ->  [N, T, K]."""
    return table[row_ids.long()[:, :, None], col_ids.long()[:, None, :]]


def select_columns(
    values: torch.Tensor,   # [N, T, E]
    col_ids: torch.Tensor,  # [N, K] int
) -> torch.Tensor:
    """out[n, t, k] = values[n, t, col_ids[n, k]]  ->  [N, T, K]."""
    n, t, _ = values.shape
    idx = col_ids.long()[:, None, :].expand(n, t, col_ids.shape[1])
    return torch.gather(values, 2, idx)


def pair_counts(
    gamma: torch.Tensor,    # [N, T, K] posteriors, 0 wherever (t, k) is padding
    row_ids: torch.Tensor,  # [N, T] int (phone ids)
    col_ids: torch.Tensor,  # [N, K] int (concept id per state)
    n_rows: int,
    n_cols: int,
) -> torch.Tensor:
    """counts[f, e] = sum_{n,t,k} gamma[n,t,k] 1[row_ids[n,t]=f] 1[col_ids[n,k]=e]."""
    flat = row_ids.long()[:, :, None] * n_cols + col_ids.long()[:, None, :]
    out = torch.zeros(n_rows * n_cols, dtype=gamma.dtype, device=gamma.device)
    out.index_add_(0, flat.reshape(-1), gamma.reshape(-1))
    return out.reshape(n_rows, n_cols)
