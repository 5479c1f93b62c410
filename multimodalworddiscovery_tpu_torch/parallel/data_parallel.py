"""Data-parallel EM and gradient steps over a mesh of ranks.

Counterpart of ``multimodalworddiscovery_tpu/parallel/data_parallel.py``.
The corpus is padded to a multiple of the mesh size and each rank keeps its
contiguous rows (``shard_corpus``); parameters are identical on every rank.

- ``make_shard_map_em_step`` is the reference's explicit ``shard_map``
  step: every rank computes the expected counts of its rows (K1 + K2, or
  K4, on the card), ONE all_reduce sums the count tree and the loglik, and
  the closed-form M-step runs on every rank.  Counts are additive over
  utterances, so this is the single-process ``em_step`` up to addition
  order.
- ``make_data_parallel_step``: JAX partitions any jitted step (GSPMD);
  torch cannot, so the step's module decides.  A closed-form module's
  ``em_step`` (model1, hmm, hmm_gaussian, segmental_kmeans) becomes
  ``make_shard_map_em_step``; a gradient step that takes ``mesh=``
  (attention, grounding, hmm_crf, hmm_dnn) runs on the rank's rows with
  its gradient all-reduce (``core.collectives.all_sum``); anything else is
  a TypeError.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Any, Callable

from multimodalworddiscovery_tpu_torch.core.collectives import all_sum, group_of
from multimodalworddiscovery_tpu_torch.core.mesh import check_mesh, pad_to_multiple, shard_rows
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus


def take_rows(corpus: Corpus, lo: int, hi: int) -> Corpus:
    """Rows [lo, hi) of a corpus (views)."""
    return dataclasses.replace(corpus, src=corpus.src[lo:hi], src_len=corpus.src_len[lo:hi],
                               trg=corpus.trg[lo:hi], trg_len=corpus.trg_len[lo:hi])


def shard_corpus(corpus: Corpus, mesh) -> Corpus:
    """Pad N to a multiple of the mesh size with zero-length utterances and
    keep this rank's contiguous rows [r N'/W, (r+1) N'/W)."""
    padded = corpus.pad_to(pad_to_multiple(corpus.n, check_mesh(mesh).size()))
    return take_rows(padded, *shard_rows(padded.n, mesh))


def make_shard_map_em_step(
    mod: Any,
    mesh,
    count_kwargs: dict | None = None,
    m_step_kwargs: dict | None = None,
):
    """``step(params, shard) -> (params, {"loglik"})`` for a closed-form
    module (``expected_counts(params, corpus, **kw) -> (counts, loglik)`` and
    ``m_step(params, counts, **kw)``): the rank's counts, one all_reduce of
    the counts and the loglik, and the M-step on every rank."""
    group = group_of(mesh)
    ckw = dict(count_kwargs or {})
    mkw = dict(m_step_kwargs or {})

    def step(params, shard: Corpus):
        counts, ll = mod.expected_counts(params, shard, **ckw)
        counts, ll = all_sum((counts, ll), group)
        return mod.m_step(params, counts, **mkw), {"loglik": ll}

    return step


def _takes(fn: Callable, name: str) -> bool:
    return name in inspect.signature(fn).parameters


def _closed_form_module(fn: Callable):
    """The module whose ``em_step`` ``fn`` is (through a partial), if that
    module is closed-form EM (expected counts and an M-step, no neural
    M-step)."""
    base = fn.func if isinstance(fn, functools.partial) else fn
    mod = inspect.getmodule(base)
    if (mod is not None and getattr(mod, "em_step", None) is base
            and hasattr(mod, "expected_counts") and hasattr(mod, "m_step")
            and not hasattr(mod, "neural_m_step")):
        return mod
    return None


def make_data_parallel_step(step_fn: Callable[..., tuple[Any, dict]], mesh):
    """``step(params, shard, ...) -> (params, stats)`` on this rank's rows,
    equal on every rank to ``step_fn`` on the whole corpus.

    - A closed-form module's ``em_step``, or a ``functools.partial`` of it:
      ``make_shard_map_em_step``, each bound keyword going to
      ``expected_counts`` or ``m_step``, whichever takes it (an annealing
      temperature: ``partial(hmm_gaussian.em_step, emit_scale=beta)``).
    - A gradient step taking ``mesh=``: called with the mesh (and any
      further arguments), so its normalisers, gradients and statistics are
      the global batch's.
    """
    check_mesh(mesh)
    if _takes(step_fn, "mesh"):
        return lambda params, shard, *args, **kw: step_fn(params, shard, *args, mesh=mesh, **kw)
    mod = _closed_form_module(step_fn)
    if mod is None:
        raise TypeError(
            "make_data_parallel_step takes a closed-form module's em_step (model1, hmm, "
            "hmm_gaussian, segmental_kmeans: make_shard_map_em_step) or a gradient step with "
            f"a mesh= parameter (attention, grounding, hmm_crf, hmm_dnn), got {step_fn!r}")
    ckw, mkw = {}, {}
    for k, v in (step_fn.keywords if isinstance(step_fn, functools.partial) else {}).items():
        (ckw if _takes(mod.expected_counts, k) else mkw)[k] = v
    return make_shard_map_em_step(mod, mesh, count_kwargs=ckw, m_step_kwargs=mkw)
