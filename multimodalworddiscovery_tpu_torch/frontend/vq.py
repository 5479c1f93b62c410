"""k-means VQ frontend: continuous frames -> discrete code corpora.

Counterpart of ``multimodalworddiscovery_tpu/frontend/vq.py``.  Fit a codebook
over the masked frames, replace each frame with its code id, and the
discrete aligners run unchanged on the result: the time axis is kept, so
gold frame alignments and segment boundaries stay valid.  The codebook is
a model artifact, saved beside a run and reloaded for decode, so a new
process quantizes with the same centroids.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.models.hmm_gaussian import (
    _kmeans_assign,
    fit_codebook_reservoir,
    fit_frame_codebook,
)


def fit_codebook(
    corpus: Corpus,
    n_codes: int = 64,
    num_iterations: int = 10,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """[n_codes, D] codebook by the one resident fit protocol
    (``hmm_gaussian.fit_frame_codebook``), shared with ``quantize_frames``
    so the frontend's and the VQ teacher's code spaces cannot drift."""
    return fit_frame_codebook(corpus, n_codes, num_iterations, generator)


def fit_codebook_streaming(
    reader,
    n_codes: int = 64,
    num_iterations: int = 10,
    generator: torch.Generator | None = None,
    n_sample: int = 65536,
    frames=None,
) -> torch.Tensor:
    """Out-of-core codebook over a ``data.stream.ShardedCorpusReader``
    corpus, by the one streaming fit protocol
    (``hmm_gaussian.fit_codebook_reservoir``), shared with the VQ teacher's
    seeding so the two recipes' code spaces cannot drift.  ``frames``: a
    reservoir drawn already (``hmm_gaussian._reservoir_frames``' order)."""
    return fit_codebook_reservoir(reader, n_codes, num_iterations, generator, n_sample, frames)


def quantize(corpus: Corpus, codebook: torch.Tensor) -> Corpus:
    """Replace each frame with its nearest-centroid code id -> a DISCRETE
    corpus (``src_vocab`` = codebook rows; lengths and targets unchanged)."""
    x = corpus.src
    codes = _kmeans_assign(codebook.to(x.device), x.reshape(-1, x.shape[-1]))
    return dataclasses.replace(
        corpus, src=codes.reshape(x.shape[:2]).to(torch.int32),
        src_vocab=int(codebook.shape[0]),
    )


def save_codebook(path: str | Path, codebook: torch.Tensor) -> None:
    """Atomic write (tmp + rename): a concurrent reader sees either no file
    or a complete one, never a truncated .npy."""
    path = Path(path)
    tmp = path.with_suffix(".npy.tmp.npy")
    np.save(tmp, codebook.detach().cpu().numpy())
    os.replace(tmp, path)


def load_codebook(path: str | Path, device="cuda") -> torch.Tensor:
    """The saved codebook, on ``device``."""
    return torch.as_tensor(np.load(Path(path)), device=device)
