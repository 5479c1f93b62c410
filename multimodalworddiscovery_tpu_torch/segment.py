"""Word segmentation: alignment -> word-like units.

Counterpart of ``multimodalworddiscovery_tpu/segment.py``: maximal runs of
source positions assigned to the same target concept become
(start, end_exclusive, concept) word units; NULL-aligned runs are not word
units.  Vectorized over the corpus with scatter-min/max over run ids, so
segmentation stays on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus


def segments_from_alignment(
    alignment: torch.Tensor, trg: torch.Tensor, src_len: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Group maximal same-assignment runs into word units.

    alignment: [N, Ts] int — 0 = NULL, j >= 1 = 1-based trg position.
    trg:       [N, Tt] int concept ids (used to label segments).
    src_len:   [N] int.

    Returns (segments [N, Ts, 3] int32, seg_mask [N, Ts] bool): valid slots
    hold (start, end_exclusive, concept_id) in order of appearance; invalid
    slots are zeros.  NULL runs consume a run slot but are masked out.
    """
    n, ts = alignment.shape
    dev = alignment.device
    i32 = torch.int32
    t = torch.arange(ts, dtype=i32, device=dev).expand(n, ts)
    valid = t < src_len[:, None]
    a = torch.where(valid, alignment, 0).to(i32)
    prev = torch.cat([torch.full((n, 1), -1, dtype=i32, device=dev), a[:, :-1]], dim=1)
    is_start = (a != prev) & valid
    run_id = torch.cumsum(is_start.to(i32), dim=1) - 1
    # invalid positions scatter into a discard slot (index ts)
    rid = torch.where(valid, run_id, ts).long()

    def scatter(fill, src, reduce):
        out = torch.full((n, ts + 1), fill, dtype=i32, device=dev)
        return out.scatter_reduce(1, rid, src.to(i32), reduce=reduce)[:, :ts]

    starts = scatter(ts, torch.where(valid, t, ts), "amin")
    ends = scatter(0, torch.where(valid, t + 1, 0), "amax")
    vals = scatter(0, a, "amax")
    n_runs = is_start.sum(dim=1, dtype=i32)
    slot_valid = (t < n_runs[:, None]) & (vals > 0)
    trg_ext = torch.cat([torch.zeros((n, 1), dtype=trg.dtype, device=dev), trg], dim=1)
    concept = torch.where(slot_valid, trg_ext.gather(1, vals.long()), 0)
    segs = torch.stack(
        [
            torch.where(slot_valid, starts, 0),
            torch.where(slot_valid, ends, 0),
            concept.to(i32),
        ],
        dim=-1,
    ).to(i32)
    return segs, slot_valid


def boundaries_from_segments(
    segments: torch.Tensor, seg_mask: torch.Tensor, max_len: int
) -> torch.Tensor:
    """[N, S, 3] segments -> [N, max_len + 1] bool boundary indicators: a
    boundary sits at position p if some word unit starts or ends there."""
    n = segments.shape[0]
    # column max_len + 1 is a discard bucket for masked segment slots
    out = torch.zeros((n, max_len + 2), dtype=torch.bool, device=segments.device)
    discard = max_len + 1
    for col in (0, 1):
        idx = torch.where(seg_mask, segments[..., col], discard).long()
        out.scatter_(1, idx, True)
    return out[:, : max_len + 1]


def segments_to_host(segments, seg_mask) -> list[list[tuple[int, int, int]]]:
    """Device segment arrays -> per-utterance python lists for JSON dumps."""
    segments = np.asarray(torch.as_tensor(segments).cpu())
    seg_mask = np.asarray(torch.as_tensor(seg_mask).cpu())
    return [
        [tuple(int(x) for x in segments[i, s]) for s in np.where(seg_mask[i])[0]]
        for i in range(segments.shape[0])
    ]


def segment_corpus(alignment: torch.Tensor, corpus: Corpus):
    """Convenience wrapper used by the ``segment`` entry point."""
    return segments_from_alignment(alignment, corpus.trg, corpus.src_len)
