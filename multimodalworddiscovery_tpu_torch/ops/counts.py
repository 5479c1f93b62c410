"""K1: emission-table lookup kernel and its plain version.

emit[n, t, k] = table[src[n, t], concepts[n, k]]  ->  [N, Ts, S] float32.

Replaces ``multimodalworddiscovery_tpu/ops/counts_pallas.py:
table_lookup_pallas`` (body ``_lookup_kernel``).  CUDA source:
``csrc/counts.cu``.  On the H100 the lookup is a gather bound by memory (it
writes N*Ts*S floats; the table stays in cache), so the kernel is one
thread per output element with coalesced stores.  The output is
utterance-major and unpadded, so the TPU kernel's padded-state rows
(``k_real``) and NULL-row shortcut have no counterpart: NULL states already
carry concept 0 in ``hmm_core.state_concepts``.
"""

from __future__ import annotations

import torch

from multimodalworddiscovery_tpu_torch.core.counts import table_lookup as table_lookup_plain
from multimodalworddiscovery_tpu_torch.ops import _build


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
