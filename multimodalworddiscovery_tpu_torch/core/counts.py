"""Emission-table lookups and expected-count accumulation, plain torch.

Counterpart of ``multimodalworddiscovery_tpu/core/counts.py``.  The
reference writes both as one-hot matmuls because gathers and scatters were
slow on the TPU; on a GPU an index gather is exact and the natural form.
A float scatter-add (``index_add_``, ``scatter_add_``) is not: on a CUDA
tensor it adds with atomics, in an order that changes from run to run, and
so do its sums' last bits.  The EM statistics therefore sum by
``segment_sum`` and ``pool_columns``, one-hot products taken a chunk at a
time in a fixed order, which give the same bits in every run as the
reference's contractions do.  ``table_lookup`` and ``pair_counts`` are the
plain versions of the K1 lookup kernel and of K7 / K2's count half
(``ops/``); ``select_columns`` picks each state's column of per-concept
emissions, and its gradient pools back by ``pool_columns``; ``embed_rows``
is an embedding lookup whose gradient sums back by ``segment_sum``.
"""

from __future__ import annotations

import math

import torch

# Elements of one one-hot operand (64 MB in float32): the chunk of rows (or
# utterances) that segment_sum and pool_columns take at a time.
ONEHOT_ELEMENTS = 1 << 24


def table_lookup(
    table: torch.Tensor,    # [F, E]
    row_ids: torch.Tensor,  # [N, T] int
    col_ids: torch.Tensor,  # [N, K] int
) -> torch.Tensor:
    """out[n, t, k] = table[row_ids[n, t], col_ids[n, k]]  ->  [N, T, K]."""
    return table[row_ids.long()[:, :, None], col_ids.long()[:, None, :]]


def _gather_columns(values: torch.Tensor, col_ids: torch.Tensor) -> torch.Tensor:
    n, t, _ = values.shape
    idx = col_ids.long()[:, None, :].expand(n, t, col_ids.shape[1])
    return torch.gather(values, 2, idx)


class _SelectColumns(torch.autograd.Function):
    """The gather with ``pool_columns`` as its backward (torch.gather's own
    backward is a scatter-add)."""

    @staticmethod
    def forward(ctx, values, col_ids):
        ctx.save_for_backward(col_ids)
        ctx.n_cols = values.shape[2]
        return _gather_columns(values, col_ids)

    @staticmethod
    def backward(ctx, grad):
        (col_ids,) = ctx.saved_tensors
        return pool_columns(grad, col_ids, ctx.n_cols), None


def select_columns(
    values: torch.Tensor,   # [N, T, E]
    col_ids: torch.Tensor,  # [N, K] int
) -> torch.Tensor:
    """out[n, t, k] = values[n, t, col_ids[n, k]]  ->  [N, T, K].  Its
    gradient with respect to ``values`` is ``pool_columns`` of the output's
    gradient, so a gradient step through it gives the same bits in every
    run."""
    return _SelectColumns.apply(values, col_ids)


class _EmbedRows(torch.autograd.Function):
    """The row gather with ``segment_sum`` as its backward (autograd's
    backward of an index gather adds rows into the weight with atomics on
    the card)."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = weight.shape[0]
        return weight[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        d = grad.shape[-1]
        return segment_sum(grad.reshape(-1, d), ids.reshape(-1), ctx.n_rows), None


def embed_rows(
    weight: torch.Tensor,  # [V, D]
    ids: torch.Tensor,     # [...] int in [0, V)
) -> torch.Tensor:
    """out[...] = weight[ids[...]]  ->  [..., D], the exact index gather.
    Its gradient with respect to ``weight`` is ``segment_sum`` of the
    output's gradient over ``ids`` (``jnp.take``'s VJP, the same terms in a
    fixed order), so a gradient step through it gives the same bits in
    every run."""
    return _EmbedRows.apply(weight, ids.long())


def segment_sum(
    data: torch.Tensor,  # [M] or [M, D]
    ids: torch.Tensor,   # [M] int in [0, num_segments)
    num_segments: int,
) -> torch.Tensor:
    """out[k] = sum of data[i] over the rows i with ids[i] = k  ->  [K] or
    [K, D] (``jax.ops.segment_sum``).  A one-hot product over
    ``ONEHOT_ELEMENTS // K`` rows at a time, the chunks added in order: no
    atomics, so the same bits in every run.  The products are IEEE float32
    while TF32 is off (``torch.backends.cuda.matmul.allow_tf32``, off by
    default), as the reference's HIGHEST-precision contractions are."""
    m = ids.shape[0]
    x = data.reshape(m, math.prod(data.shape[1:]))
    cols = torch.arange(num_segments, device=ids.device)
    step = max(1, ONEHOT_ELEMENTS // max(num_segments, 1))
    out = None
    for i in range(0, m, step):
        part = (ids[i:i + step, None] == cols).to(data.dtype).T @ x[i:i + step]
        out = part if out is None else out + part
    if out is None:
        out = x.new_zeros((num_segments, x.shape[1]))
    return out.reshape((num_segments,) + tuple(data.shape[1:]))


def pool_columns(
    values: torch.Tensor,   # [N, T, K]
    col_ids: torch.Tensor,  # [N, K] int in [0, n_cols)
    n_cols: int,
) -> torch.Tensor:
    """out[n, t, e] = sum_k values[n, t, k] 1[col_ids[n, k] = e]  ->  [N, T,
    n_cols], the adjoint of ``select_columns`` (the reference's einsum with
    a one-hot [N, K, E]).  A batched one-hot product over
    ``ONEHOT_ELEMENTS // (K n_cols)`` utterances at a time: no atomics, so
    the same bits in every run; IEEE float32 while TF32 is off."""
    n, t, k = values.shape
    cols = torch.arange(n_cols, device=values.device)
    step = max(1, ONEHOT_ELEMENTS // max(k * n_cols, 1))

    def part(i):
        onehot = (col_ids[i:i + step, :, None] == cols).to(values.dtype)
        return values[i:i + step], onehot

    if n <= step:
        return torch.bmm(*part(0))
    if values.requires_grad:  # out= takes no gradient
        return torch.cat([torch.bmm(*part(i)) for i in range(0, n, step)])
    out = values.new_empty((n, t, n_cols))
    for i in range(0, n, step):
        torch.bmm(*part(i), out=out[i:i + step])
    return out


def pair_counts(
    gamma: torch.Tensor,    # [N, T, K] posteriors, 0 wherever (t, k) is padding
    row_ids: torch.Tensor,  # [N, T] int (phone ids)
    col_ids: torch.Tensor,  # [N, K] int (concept id per state)
    n_rows: int,
    n_cols: int,
) -> torch.Tensor:
    """counts[f, e] = sum_{n,t,k} gamma[n,t,k] 1[row_ids[n,t]=f] 1[col_ids[n,k]=e].

    The plain version of K7 and of K2's counts, the oracle they are held
    to.  It keeps the float scatter-add: on the card it runs only in those
    comparisons (``use_kernels=False``), each of which sums in float64 or
    allows a tolerance for the atomics' order."""
    flat = row_ids.long()[:, :, None] * n_cols + col_ids.long()[:, None, :]
    out = torch.zeros(n_rows * n_cols, dtype=gamma.dtype, device=gamma.device)
    out.index_add_(0, flat.reshape(-1), gamma.reshape(-1))
    return out.reshape(n_rows, n_cols)
