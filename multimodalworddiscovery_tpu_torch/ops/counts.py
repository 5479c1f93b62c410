"""K1 (emission-table lookup) and K7 (pair counts) kernels and their plain
versions.  CUDA source of both: ``csrc/counts.cu``.

K1: emit[n, t, k] = table[src[n, t], concepts[n, k]]  ->  [N, Ts, S] float32.
Replaces ``multimodalworddiscovery_tpu/ops/counts_pallas.py:
table_lookup_pallas`` (body ``_lookup_kernel``).  On the H100 the lookup is a
gather bound by the bytes it writes, so the kernel is a persistent grid of a
few blocks an SM, each over a contiguous range of utterances: a chunk's src
and concept rows staged in shared memory, its contiguous output written with
16-byte stores, 32-bit index math inside the chunk, and the table in shared
memory where it fits (else read through the cache).  The output is
utterance-major and unpadded, so the TPU kernel's padded-state rows
(``k_real``) and NULL-row shortcut have no counterpart: NULL states already
carry concept 0 in ``hmm_core.state_concepts``.

K7: counts[f, e] = sum_{n,t,k} gamma[n, t, k] [src[n, t] = f] [concepts[n, k] = e]
-> [F, E] float32, the emission counts of the discrete HMM's general route
(after K4).  Replaces ``counts_pallas.py:pair_counts_pallas`` (body
``_counts_kernel``).  It reads gamma in the layout K4 writes, [N, Ts, S],
with no transpose (the reference's padded time-major layout was the TPU's
lane layout), on K2's count consumer (``csrc/counts.cuh``): a segment of a
warp (32 lanes, or fewer for short rows, so several rows share a warp)
reads a (n, t) row, the posteriors of concept 0 (the null states, wherever
they sit) are summed by shuffles and added once, the others go into a
per-block [F, E] table in shared memory, and a persistent grid (up to two
blocks of 512 threads an SM, or one of 1024 where the table fits only once)
flushes each table's nonzero entries into the counts.  A table larger than
shared memory is skipped and the adds go straight into the counts, so it
takes every shape K4 does and any vocabulary.  The adds are integer adds
in fixed point (64-bit numbers at a scale of 2^48, exact for values from
2^-24 up; float32 at the end), so one input gives the same counts in every
run; gamma must be nonnegative (a negative or NaN element adds nothing).
The plain version is the scatter-add ``core.counts.pair_counts``.
"""

from __future__ import annotations

import torch

from multimodalworddiscovery_tpu_torch.core.counts import pair_counts as pair_counts_plain
from multimodalworddiscovery_tpu_torch.core.counts import table_lookup as table_lookup_plain
from multimodalworddiscovery_tpu_torch.ops import _build
from multimodalworddiscovery_tpu_torch.utils.profiling import span


def table_lookup(
    table: torch.Tensor,     # [F, E] float32
    src: torch.Tensor,       # [N, Ts] int32
    concepts: torch.Tensor,  # [N, S] int32
) -> torch.Tensor:
    """[N, Ts, S] emissions.  CPU tensors take the plain gather; CUDA
    tensors launch the kernel (ids must lie inside the table — an id outside
    it gives NaN)."""
    if table.device.type == "cpu":
        return table_lookup_plain(table, src, concepts)
    with span("mwd.ops.table_lookup"):
        if table.device.type != "cuda":
            raise ValueError(f"table_lookup runs on cpu or cuda, got {table.device}")
        dev = table.device
        f, e = table.shape
        n, ts = src.shape
        s = concepts.shape[1]
        _build.require(table, "table", torch.float32, (f, e), dev)
        _build.require(src, "src", torch.int32, (n, ts), dev)
        _build.require(concepts, "concepts", torch.int32, (n, s), dev)
        out = torch.empty((n, ts, s), dtype=torch.float32, device=dev)
        if out.numel() == 0:
            return out
        lib = _build.load()
        with torch.cuda.device(dev):
            status = lib.mwd_table_lookup(
                table.data_ptr(), src.data_ptr(), concepts.data_ptr(), out.data_ptr(),
                n, ts, s, f, e, torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(status, "mwd_table_lookup")
        table_lookup.launches += 1
    return out


table_lookup.launches = 0


def pair_counts(
    gamma: torch.Tensor,     # [N, Ts, S] float32, 0 wherever (t, k) is padding
    src: torch.Tensor,       # [N, Ts] int32
    concepts: torch.Tensor,  # [N, S] int32
    n_rows: int,
    n_cols: int,
) -> torch.Tensor:
    """[n_rows, n_cols] expected pair counts.  CPU tensors take the plain
    scatter-add; CUDA tensors launch the kernel (a pair whose id lies
    outside the table adds nothing)."""
    if gamma.device.type == "cpu":
        return pair_counts_plain(gamma, src, concepts, n_rows, n_cols)
    with span("mwd.ops.pair_counts"):
        if gamma.device.type != "cuda":
            raise ValueError(f"pair_counts runs on cpu or cuda, got {gamma.device}")
        dev = gamma.device
        n, ts, s = gamma.shape
        _build.require(gamma, "gamma", torch.float32, (n, ts, s), dev)
        _build.require(src, "src", torch.int32, (n, ts), dev)
        _build.require(concepts, "concepts", torch.int32, (n, s), dev)
        if gamma.numel() == 0 or n_rows * n_cols == 0:
            return torch.zeros((n_rows, n_cols), dtype=torch.float32, device=dev)
        counts = torch.empty((n_rows, n_cols), dtype=torch.float32, device=dev)
        acc = torch.empty((2, n_rows * n_cols), dtype=torch.int64, device=dev)
        lib = _build.load()
        with torch.cuda.device(dev):
            status = lib.mwd_pair_counts(
                gamma.data_ptr(), src.data_ptr(), concepts.data_ptr(), acc.data_ptr(),
                counts.data_ptr(), n, ts, s, n_rows, n_cols,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(status, "mwd_pair_counts")
        pair_counts.launches += 1
    return counts


pair_counts.launches = 0
