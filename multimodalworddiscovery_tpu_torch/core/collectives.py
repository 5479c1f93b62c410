"""Collectives of the parallel layer on ``torch.distributed``.

Every exchange between ranks goes through here, and each function is the
identity when ``group`` is None (one process), so a model step calls them
unconditionally:

all_sum      ONE all_reduce(SUM) of a whole tree of tensors (dicts, tuples,
             lists), flattened into one buffer: an E-step's counts with its
             loglik (the reference's single ``psum``), a gradient step's
             gradients (in ``hmm_dnn.adam_update``)
all_max      the same with MAX (ranks agreeing on a padded size)
sum_ranks    a differentiable all_reduce(SUM) of a statistic every rank's
             part of a global loss uses (a mean over the global batch)
gather       every rank's tensor stacked [W, ...] (``all_gather``, which
             NCCL and gloo both take, gloo on CUDA tensors too)
gather_rows  every rank's rows in rank order, ragged, differentiable
broadcast    every tensor of a parameter tree from the group's rank 0

The tensors stay on the rank's device; nothing here copies through the
host (gloo does so inside the backend for CUDA tensors).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from multimodalworddiscovery_tpu_torch.core.mesh import check_mesh


def group_of(mesh):
    """The process group of a 1-D mesh, or None without one."""
    return None if mesh is None else check_mesh(mesh).get_group()


def _flatten(tree, out: list) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _flatten(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _flatten(v, out)
    else:
        out.append(tree)


def _unflatten(tree, leaves):
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _all_reduce_tree(tree, group, op):
    if group is None:
        return tree
    leaves: list[torch.Tensor] = []
    _flatten(tree, leaves)
    dtypes = {t.dtype for t in leaves}
    # one buffer, one call: a common dtype, else float64 (exact for the
    # float32 counts and the integer counts alike)
    dtype = leaves[0].dtype if len(dtypes) == 1 else torch.float64
    buf = torch.cat([t.detach().reshape(-1).to(dtype) for t in leaves])
    dist.all_reduce(buf, op=op, group=group)
    out, off = [], 0
    for t in leaves:
        out.append(buf[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return _unflatten(tree, iter(out))


def all_sum(tree, group):
    """The tree summed over the ranks (one all_reduce)."""
    return _all_reduce_tree(tree, group, dist.ReduceOp.SUM)


def all_max(tree, group):
    """The tree's elementwise maximum over the ranks (one all_reduce)."""
    return _all_reduce_tree(tree, group, dist.ReduceOp.MAX)


class _SumRanks(torch.autograd.Function):
    """all_reduce(SUM) whose backward is the all_reduce(SUM) of the
    gradients: the global loss is the sum of the ranks' parts, and each part
    uses the summed statistic, so each rank's contribution to it takes the
    gradient of every part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably (see ``_SumRanks``)."""
    return x if group is None else _SumRanks.apply(x, group)


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """[W, *x.shape]: every rank's ``x`` (same shape on every rank)."""
    if group is None:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


class _GatherRows(torch.autograd.Function):
    """Rows of every rank, concatenated in rank order.  The backward is the
    slice of this rank's rows: the consumer of the gathered rows computes
    the same (global) function on every rank, so each rank's gradient of
    its own rows is already the gradient of that one function, and the
    parameter gradients are then summed over the ranks (``all_sum``)."""

    @staticmethod
    def forward(ctx, x, group, sizes, rank):
        pad = x.new_zeros((max(sizes) - x.shape[0], *x.shape[1:]))
        parts = gather(torch.cat([x, pad]), group)
        ctx.lo, ctx.n = sum(sizes[:rank]), x.shape[0]
        return torch.cat([p[:s] for p, s in zip(parts, sizes)])

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.lo:ctx.lo + ctx.n], None, None, None


def gather_rows(tensors, group) -> list[torch.Tensor]:
    """Each of ``tensors`` (same leading size on this rank; the size may
    differ between ranks) gathered over the ranks, rows in rank order;
    differentiable where the input is (see ``_GatherRows``)."""
    tensors = list(tensors)
    if group is None:
        return tensors
    n = torch.tensor([tensors[0].shape[0]], device=tensors[0].device)
    sizes = gather(n, group).view(-1).tolist()
    rank = dist.get_rank(group)
    return [_GatherRows.apply(t, group, sizes, rank) for t in tensors]


def tensors_of(tree) -> list[torch.Tensor]:
    """Every tensor of a parameter tree (dataclasses, dicts, sequences,
    ``nn.Module`` parameters and buffers), in a fixed order."""
    out: list[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def broadcast(tree, group):
    """A copy of ``tree`` whose every tensor is the group's rank 0's."""
    if group is None:
        return tree
    tree = copy.deepcopy(tree)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in tensors_of(tree):
            dist.broadcast(t, src=src, group=group)
    return tree


def max_disagreement(tree, group) -> float:
    """The largest |p - p on rank 0| over every tensor of ``tree`` and
    every rank (a check that replicated parameters agree; 0 means bit for
    bit)."""
    ref = broadcast(tree, group)
    worst = max((float((a.double() - b.double()).abs().max()) if a.numel() else 0.0)
                for a, b in zip(tensors_of(tree), tensors_of(ref)))
    if group is None:
        return worst
    dev = tensors_of(tree)[0].device
    return float(all_max(torch.tensor(worst, dtype=torch.float64, device=dev), group))
