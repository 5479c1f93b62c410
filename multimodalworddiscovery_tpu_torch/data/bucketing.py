"""Length bucketing: split a corpus into padded buckets to cut padding waste.

Counterpart of ``multimodalworddiscovery_tpu/data/bucketing.py``.  Expected
counts are additive, so running the E-step per bucket and pooling the
counts before one M-step is exact (``models/bucketed.py``), and each bucket
pays only for its own padding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus


def _take_rows(corpus: Corpus, idx: np.ndarray, max_t: int | None = None) -> Corpus:
    """Rows ``idx`` of the corpus (on its device), the source axis cut to
    ``max_t``."""
    rows = torch.as_tensor(idx, dtype=torch.long, device=corpus.device)
    src = corpus.src.index_select(0, rows)
    if max_t is not None:
        src = src[:, :max_t].contiguous()
    return dataclasses.replace(
        corpus, src=src, src_len=corpus.src_len.index_select(0, rows),
        trg=corpus.trg.index_select(0, rows), trg_len=corpus.trg_len.index_select(0, rows))


def bucket_corpus(
    corpus: Corpus, bucket_edges: list[int], min_bucket_size: int = 1
) -> list[tuple[Corpus, np.ndarray]]:
    """Split by source length -> [(bucket corpus, original indices)].

    ``bucket_edges``: ascending inclusive upper bounds on src_len;
    utterances longer than the last edge go into a final overflow bucket.
    Each bucket is padded to its own longest source; the target axis keeps
    the corpus's width, so the state space is the same in every bucket.  A
    bucket smaller than ``min_bucket_size`` is left for a later one (or the
    final rest bucket): no utterance is dropped.
    """
    src_len = corpus.src_len.cpu().numpy()
    edges = list(bucket_edges) + [int(src_len.max(initial=1))]
    out: list[tuple[Corpus, np.ndarray]] = []
    assigned = np.zeros(corpus.n, dtype=bool)
    for edge in edges:
        sel = (~assigned) & (src_len <= edge)
        idx = np.where(sel)[0]
        if len(idx) < min_bucket_size:
            continue
        assigned |= sel
        max_t = max(int(src_len[idx].max(initial=1)), 1)
        out.append((_take_rows(corpus, idx, max_t), idx))
    rest = np.where(~assigned)[0]
    if len(rest):
        out.append((_take_rows(corpus, rest), rest))
    return out


def padding_waste(corpus: Corpus) -> float:
    """Fraction of source positions that are padding."""
    total = corpus.n * corpus.max_src_len
    return 1.0 - float(corpus.src_len.sum()) / max(total, 1)
