"""Padded paired corpus as torch tensors.

Counterpart of ``multimodalworddiscovery_tpu/data/corpus.py``: one padded
batch of the whole corpus, so every EM step is a batched call over all
utterances.  The constructors from host arrays put the tensors on ``device``,
"cuda" unless the caller names another; a corpus moves with ``.to``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.core.masking import (
    lengths_to_mask,
    pad_and_stack,
)


def _as_field(x) -> np.ndarray:
    """int32 for integer arrays (ids, lengths), float32 for the rest."""
    x = np.asarray(x)
    return x.astype(np.int32 if x.dtype.kind in "iu" else np.float32)


@dataclasses.dataclass(frozen=True)
class Corpus:
    """Padded paired corpus.

    src: [N, Ts] int32 token ids (phones) OR [N, Ts, D] float32 frames.
    trg: [N, Tt] int32 concept ids OR [N, Tt, D] float32 region embeddings.
    src_len / trg_len: [N] int32 true lengths.
    """

    src: torch.Tensor
    src_len: torch.Tensor
    trg: torch.Tensor
    trg_len: torch.Tensor
    src_vocab: int = 0
    trg_vocab: int = 0

    @property
    def n(self) -> int:
        return self.src.shape[0]

    @property
    def max_src_len(self) -> int:
        return self.src.shape[1]

    @property
    def max_trg_len(self) -> int:
        return self.trg.shape[1]

    @property
    def device(self) -> torch.device:
        return self.src.device

    def src_mask(self) -> torch.Tensor:
        return lengths_to_mask(self.src_len, self.max_src_len)

    def trg_mask(self) -> torch.Tensor:
        return lengths_to_mask(self.trg_len, self.max_trg_len)

    def to(self, device) -> "Corpus":
        return dataclasses.replace(
            self,
            src=self.src.to(device),
            src_len=self.src_len.to(device),
            trg=self.trg.to(device),
            trg_len=self.trg_len.to(device),
        )

    def pad_to(self, n: int) -> "Corpus":
        """Pad the utterance axis to ``n`` with zero-length utterances."""
        if n < self.n:
            raise ValueError(f"cannot shrink corpus from {self.n} to {n}")
        extra = n - self.n

        def pad_leading(x):
            pad = torch.zeros((extra, *x.shape[1:]), dtype=x.dtype, device=x.device)
            return torch.cat([x, pad], dim=0)

        return dataclasses.replace(
            self,
            src=pad_leading(self.src),
            src_len=pad_leading(self.src_len),
            trg=pad_leading(self.trg),
            trg_len=pad_leading(self.trg_len),
        )

    @classmethod
    def from_numpy(
        cls,
        src: np.ndarray,
        src_len: np.ndarray,
        trg: np.ndarray,
        trg_len: np.ndarray,
        src_vocab: int = 0,
        trg_vocab: int = 0,
        device="cuda",
    ) -> "Corpus":
        """Build from padded host arrays.  Integer ids become int32 and
        anything else float32, as in the reference.  Ids are checked against
        the vocab sizes here, once, because the CUDA kernels index tables
        with them unchecked."""
        src, trg = _as_field(src), _as_field(trg)
        for name, ids, vocab in (("src", src, src_vocab), ("trg", trg, trg_vocab)):
            if ids.dtype != np.int32:
                continue
            if ids.size and vocab and (ids.min() < 0 or ids.max() >= vocab):
                raise ValueError(
                    f"{name} ids must lie in [0, {vocab}), got "
                    f"[{ids.min()}, {ids.max()}]"
                )

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device)

        return cls(
            src=t(src),
            src_len=t(_as_field(src_len)),
            trg=t(trg),
            trg_len=t(_as_field(trg_len)),
            src_vocab=src_vocab,
            trg_vocab=trg_vocab,
        )

    @classmethod
    def from_ragged(
        cls,
        src_seqs,
        trg_seqs,
        src_vocab: int = 0,
        trg_vocab: int = 0,
        max_src_len: int | None = None,
        max_trg_len: int | None = None,
        device="cuda",
    ) -> "Corpus":
        src, src_len = pad_and_stack(src_seqs, max_len=max_src_len)
        trg, trg_len = pad_and_stack(trg_seqs, max_len=max_trg_len)
        return cls.from_numpy(
            src, src_len, trg, trg_len, src_vocab, trg_vocab, device=device
        )


@dataclasses.dataclass
class GoldAnnotations:
    """Host-side gold labels for evaluation.

    alignment: [N, Ts] int32 — for each source token, the 1-based position of
      the aligned target concept in that utterance's trg sequence; 0 = NULL.
    segments: per utterance, list of (start, end_exclusive, concept_id) word
      units — the gold word segmentation.
    """

    alignment: np.ndarray
    segments: list[list[tuple[int, int, int]]]
