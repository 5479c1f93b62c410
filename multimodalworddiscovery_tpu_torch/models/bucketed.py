"""Exact length-bucketed EM.

Counterpart of ``multimodalworddiscovery_tpu/models/bucketed.py``.  Running
the E-step per length bucket and pooling the additive expected counts
before one M-step is the same EM as over one max-padded tensor, but each
bucket pays only for its own padding (``data/bucketing.py``).  Works for
any aligner with ``expected_counts(params, corpus) -> (counts, loglik)``
and ``m_step(params, counts, smoothing)`` (model1, hmm, hmm_gaussian,
hmm_dnn).  hmm_dnn's MLP update is not a sum of counts: modules with
``frame_posteriors`` and ``neural_m_step(params, [(bucket, r), ...])`` pool
the per-bucket CE gradients instead, which is again the unbucketed update.

On this card K2, K3 and K4 already order a launch's utterances by length
(``csrc/order.cuh``), so a bucket saves the padded steps' memory traffic
and the plain versions' work, at the cost of one launch per bucket.
"""

from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import Callable

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.core.collectives import all_sum, group_of
from multimodalworddiscovery_tpu_torch.data.bucketing import bucket_corpus
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.data.stream import takes, tree_map


def _kernel_kwargs(fn: Callable, use_kernels: bool | None) -> dict:
    """``use_kernels`` for a function that takes it (Model-1's E-step has
    no HMM recursion and does not)."""
    return {"use_kernels": use_kernels} if takes(fn, "use_kernels") else {}


def train_bucketed(
    mod: ModuleType,
    params,
    corpus: Corpus,
    bucket_edges: list[int],
    num_iterations: int,
    smoothing: float = 1e-8,
    mesh=None,
    use_kernels: bool | None = None,
    on_iteration: Callable[[int, object, float], None] | None = None,
):
    """EM over length buckets -> (params, [loglik per iteration]).

    Each iteration runs one E-step per bucket (``use_kernels`` as the
    module takes it; None: the kernels on a CUDA corpus), adds the counts
    into one total on the device and runs one M-step; the loglik is read
    once an iteration.  ``on_iteration(it, params, loglik)`` runs after
    every M-step.  With ``mesh`` every rank holds the whole corpus and the
    same parameters, each bucket is padded and split over the ranks
    (``parallel.shard_corpus``), and one all_reduce an iteration pools the
    ranks' counts (the neural M-step all-reduces its gradients).
    """
    buckets = bucket_corpus(corpus, bucket_edges)
    if mesh is not None:
        from multimodalworddiscovery_tpu_torch.parallel.data_parallel import shard_corpus

        buckets = [(shard_corpus(b, mesh), idx) for b, idx in buckets]
    group = group_of(mesh)
    neural = getattr(mod, "neural_m_step", None)
    if neural is None:
        ekw = _kernel_kwargs(mod.expected_counts, use_kernels)
    else:
        ekw = _kernel_kwargs(mod.frame_posteriors, use_kernels)
    logliks = []
    for it in range(num_iterations):
        total, total_ll, batches = None, None, []
        for bucket, _ in buckets:
            if neural is not None:
                # the frame posteriors r, from the pre-M-step parameters,
                # feed both the additive counts and the neural CE targets
                r, width, logz = mod.frame_posteriors(params, bucket, **ekw)
                w = bucket.src_mask().to(r.dtype)[..., None]
                counts, ll = {"prior": (r * w).sum(dim=(0, 1)), "width": width}, logz.sum()
                batches.append((bucket, r))
            else:
                counts, ll = mod.expected_counts(params, bucket, **ekw)
            total = counts if total is None else tree_map(torch.add, total, counts)
            total_ll = ll if total_ll is None else total_ll + ll
        total, total_ll = all_sum((total, total_ll), group)
        params = mod.m_step(params, total, smoothing)
        if neural is not None:
            params, _ = neural(params, batches, mesh=mesh)
        logliks.append(float(total_ll))
        if on_iteration is not None:
            on_iteration(it, params, logliks[-1])
    return params, logliks


def chunked_expected_counts(
    mod: ModuleType,
    params,
    corpus: Corpus,
    num_chunks: int,
    use_kernels: bool | None = None,
    **estep_kwargs,
):
    """The E-step over ``num_chunks`` equal slices of the corpus, their
    counts added into one running total: the [N, Ts, S] intermediates exist
    for one slice at a time.  Equals the unchunked E-step up to addition
    order (the padding rows that fill the last slice are zero-length
    utterances: loglik 0, zero counts).  ``estep_kwargs`` flow through
    (e.g. hmm_gaussian's ``emit_scale``)."""
    per = -(-corpus.n // num_chunks)
    padded = corpus.pad_to(per * num_chunks)
    ekw = {**_kernel_kwargs(mod.expected_counts, use_kernels), **estep_kwargs}
    total = None
    for i in range(num_chunks):
        sl = slice(i * per, (i + 1) * per)
        chunk = dataclasses.replace(
            padded, src=padded.src[sl], src_len=padded.src_len[sl],
            trg=padded.trg[sl], trg_len=padded.trg_len[sl])
        out = mod.expected_counts(params, chunk, **ekw)
        total = out if total is None else tree_map(torch.add, total, out)
    return total


def align_bucketed(
    mod: ModuleType, params, corpus: Corpus, bucket_edges: list[int],
    use_kernels: bool | None = None,
) -> np.ndarray:
    """Decode per bucket -> [N, Ts] int32 alignments in the corpus's order."""
    kw = _kernel_kwargs(mod.align, use_kernels)
    out = np.zeros((corpus.n, corpus.max_src_len), np.int32)
    for bucket, idx in bucket_corpus(corpus, bucket_edges):
        a = mod.align(params, bucket, **kw).cpu().numpy()
        out[idx, : a.shape[1]] = a
    return out
