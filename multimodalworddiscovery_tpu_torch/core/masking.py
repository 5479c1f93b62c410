"""Padding / masking helpers for variable-length utterances.

Counterpart of ``multimodalworddiscovery_tpu/core/masking.py``.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[N] lengths -> [N, max_len] bool mask (True = valid position)."""
    pos = torch.arange(max_len, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def pair_mask(src_mask: torch.Tensor, trg_mask: torch.Tensor) -> torch.Tensor:
    """[N,Ts] x [N,Tt] -> [N,Ts,Tt] joint validity mask."""
    return src_mask[:, :, None] & trg_mask[:, None, :]


def pad_and_stack(
    seqs: Sequence[np.ndarray], max_len: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged [T_i, ...] arrays into ([N, T, ...], lengths[N]),
    zero-padded and cut at ``max_len``.

    Host-side (NumPy): runs once at corpus-build time.
    """
    seqs = [np.asarray(s) for s in seqs]
    lengths = np.array([s.shape[0] for s in seqs], dtype=np.int32)
    T = int(max_len if max_len is not None else (lengths.max() if len(seqs) else 0))
    trailing = seqs[0].shape[1:] if seqs else ()
    dtype = seqs[0].dtype if seqs else np.float32
    out = np.zeros((len(seqs), T, *trailing), dtype=dtype)
    for i, s in enumerate(seqs):
        t = min(s.shape[0], T)
        out[i, :t] = s[:t]
    return out, np.minimum(lengths, T)


def bucket_by_length(lengths: np.ndarray, bucket_edges: Sequence[int]) -> np.ndarray:
    """Length bucket of each utterance (edges are inclusive upper bounds;
    past the last edge, ``len(bucket_edges)``).  Host-side (NumPy)."""
    return np.searchsorted(np.asarray(bucket_edges), np.asarray(lengths), side="left")
