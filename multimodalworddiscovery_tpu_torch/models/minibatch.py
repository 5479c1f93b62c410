"""Minibatch training for the gradient-based aligners (attention, grounding).

Counterpart of ``multimodalworddiscovery_tpu/models/minibatch.py``: the
corpus stays on the device, and each step gathers a
random minibatch there (one ``index_select`` per corpus field) and runs the
model step on it.  Teacher signals (the HMM guide of guided attention) are
computed per batch inside the step function.  The draws come from a
``torch.Generator``: a CPU generator draws on the CPU (one seed, one
sequence on every machine) and the indices go to the corpus's device.

``train_minibatch_streaming`` trains on ``data/stream`` shards, one
resident at a time.

Data parallelism (a ``core.mesh`` mesh of ranks): each rank holds its own
rows (``parallel.shard_corpus``) and the same state; the step function
takes ``mesh=`` and all-reduces its normalisers and gradients, so every
rank takes the global batch's step.  ``sample="global"`` and ``"valid"``
draw the global index set from one CPU generator on every rank and each
rank takes the rows it holds (the single-process batch, spread over the
ranks); ``sample="local"`` (``sample_local_batch``) draws each rank's
share from its own rows with its own generator.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.core.collectives import gather, group_of
from multimodalworddiscovery_tpu_torch.core.mesh import DATA_AXIS, check_mesh, shard_rows
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.data.stream import takes

StepFn = Callable[[Any, Corpus], tuple[Any, dict]]


def gather_batch(corpus: Corpus, idx: torch.Tensor) -> Corpus:
    """Static-shape minibatch: one gather per corpus field, on its device."""
    idx = idx.to(corpus.device).long()
    take = lambda x: x.index_select(0, idx)  # noqa: E731
    return Corpus(src=take(corpus.src), src_len=take(corpus.src_len), trg=take(corpus.trg),
                  trg_len=take(corpus.trg_len), src_vocab=corpus.src_vocab,
                  trg_vocab=corpus.trg_vocab)


def sample_local_batch(corpus: Corpus, generator: torch.Generator, batch_size: int, mesh,
                       axis_name: str = DATA_AXIS) -> Corpus:
    """This rank's share of a stratified minibatch: ``batch_size / W`` rows
    drawn uniformly without replacement from the rank's own rows
    (``corpus``) with the rank's own ``generator`` (e.g.
    ``step_generator(seed, step, rank)``), so no row crosses ranks.  Real
    rows (src_len > 0) sort before zero-length padding, so padding is drawn
    only when the rank holds fewer real rows than its share.  Unbiased for
    SGD when the ranks' rows are uniform random subsets (write shards with
    ``write_shards(..., shuffle=seed)``)."""
    w = check_mesh(mesh).size()
    if batch_size % w:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh size {w}")
    b_local = batch_size // w
    if b_local > corpus.n:
        # a permutation prefix cannot fill the share from a smaller shard
        raise ValueError(f"batch_size/device {b_local} exceeds the per-device corpus "
                         f"shard of {corpus.n} rows")
    u = torch.rand(corpus.n, generator=generator, device=generator.device).to(corpus.device)
    u = u + torch.where(corpus.src_len > 0, 0.0, 2.0)
    return gather_batch(corpus, torch.argsort(u)[:b_local])


def make_minibatch_step(
    step_fn: StepFn,
    corpus: Corpus,
    batch_size: int,
    mesh=None,
    axis_name: str = DATA_AXIS,
    sample: str = "global",
    bind_corpus: bool = True,
):
    """``(state, generator) -> (state, stats)`` sampling a fresh minibatch.

    ``step_fn(state, batch) -> (state, stats)`` is any model step (its guide
    or teacher logic runs inside, per batch).  ``sample="global"`` draws
    uniformly without replacement from the whole corpus (a prefix of a
    random permutation); ``sample="valid"`` uniformly with replacement over
    the rows with src_len > 0 (a shard padded with zero-length utterances
    never burns steps on padding).  With ``bind_corpus=False`` the step is
    ``(state, generator, corpus)``, one step for same-shape corpora.

    With ``mesh`` the corpus is this rank's equal share of the rows
    (``parallel.shard_corpus``), ``step_fn`` must take ``mesh=`` (the
    gradient steps of attention, grounding, hmm_crf and hmm_dnn do) and
    ``batch_size`` must divide by the mesh size.  "global" and "valid" draw
    the global index set from ``generator`` (the same seed on every rank;
    "valid" gathers the ranks' row validity) and each rank takes the
    drawn rows it holds; "local" (mesh only) draws ``batch_size / W`` of
    the rank's own rows with ``generator``, which must then be the rank's
    own (``step_generator(seed, step, rank)``).
    """
    if sample not in ("global", "local", "valid"):
        raise ValueError(f"sample must be global|local|valid, got {sample!r}")
    if sample == "local" and mesh is None:
        raise ValueError("sample='local' requires a mesh")
    w = 1
    if mesh is not None:
        w = check_mesh(mesh).size()
        if not takes(step_fn, "mesh"):
            raise TypeError("under a mesh step_fn must take mesh= (its gradient all-reduce), "
                            f"got {step_fn!r}")
        if batch_size % w:
            raise ValueError(f"batch_size {batch_size} not divisible by mesh size {w}")
        step_fn = functools.partial(step_fn, mesh=mesh)
    n = corpus.n * w
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > corpus size {n}")
    group = group_of(mesh)

    def step(state, generator: torch.Generator, c: Corpus):
        if sample == "local":
            return step_fn(state, sample_local_batch(c, generator, batch_size, mesh))
        if sample == "valid":
            valid = gather((c.src_len > 0).to(torch.int32), group).reshape(-1)
            probs = valid.to(torch.float32).to(generator.device)
            idx = torch.multinomial(probs, batch_size, replacement=True, generator=generator)
        else:
            idx = torch.randperm(c.n * w, generator=generator,
                                 device=generator.device)[:batch_size]
        if mesh is not None:  # the drawn rows this rank holds, in draw order
            lo, hi = shard_rows(c.n * w, mesh)
            idx = idx[(idx >= lo) & (idx < hi)] - lo
        return step_fn(state, gather_batch(c, idx))

    if not bind_corpus:
        return step
    return lambda state, generator: step(state, generator, corpus)


def step_generator(seed: int, step: int, rank: int | None = None) -> torch.Generator:
    """The CPU generator of global step ``step``, derived from (seed, step)
    alone (the JAX package's ``fold_in(key, step)``), so a run resumed at
    a step draws what the uninterrupted run drew there; with ``rank``, that
    rank's own generator of the step (the reference's per-device
    ``fold_in``)."""
    entropy = [int(seed), int(step)] + ([] if rank is None else [int(rank)])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def train_minibatch_streaming(
    step_fn: StepFn,
    state,
    reader,
    batch_size: int,
    num_steps: int,
    seed: int = 0,
    steps_per_shard: int | None = None,
    prefetch: int = 1,
    mesh=None,
    start_step: int = 0,
    on_step=None,
):
    """Out-of-core minibatch SGD over a ``data.stream.ShardedCorpusReader``
    corpus: shards stream to the device (``prefetch`` of them read ahead),
    and ``steps_per_shard`` steps (default shard_size // batch_size) sample
    within the resident shard before the next one loads; shards are
    visited cyclically until ``num_steps`` steps have run.

    Sampling is ``sample="valid"``: uniform with replacement over the
    shard's real rows, never the last shard's padding.  It is unbiased only
    when shards are uniform random subsets (write ordered corpora with
    ``write_shards(..., shuffle=seed)``).  Step ``it``'s draws come from
    ``step_generator(seed, it)`` and the shard cycle position from ``it``,
    so a run resumed with ``start_step`` continues the exact schedule.

    With ``mesh`` each shard splits over the ranks (shard_size a multiple
    of the mesh size): every rank reads only its rows of each shard, the
    draws are the single-process ones, and ``step_fn`` takes ``mesh=``
    (``make_minibatch_step``).

    Returns (state, per-step losses as floats, the step stats' "loglik",
    read once at the end); ``on_step(global_step, state, loss)`` runs after
    every step (and reads its loss then).
    """
    rows = None
    if mesh is not None:
        w = check_mesh(mesh).size()
        if reader.shard_size % w:
            raise ValueError(f"shard_size {reader.shard_size} must divide by the mesh's "
                             f"{w} ranks")
        rows = shard_rows(reader.shard_size, mesh)
    if steps_per_shard is None:
        steps_per_shard = max(1, reader.shard_size // batch_size)
    stop = start_step + num_steps
    first_block = start_step // steps_per_shard
    last_block = max((stop - 1) // steps_per_shard, first_block)
    blocks = list(range(first_block, last_block + 1))
    step = None
    losses = []
    it = start_step
    for b, shard in zip(blocks, reader.shards(prefetch, [b % reader.num_shards
                                                         for b in blocks], rows)):
        if step is None:  # one step for every shard: they share one shape
            step = make_minibatch_step(step_fn, shard, batch_size, mesh=mesh, sample="valid",
                                       bind_corpus=False)
        block_stop = min((b + 1) * steps_per_shard, stop)
        while it < block_stop:
            state, stats = step(state, step_generator(seed, it), shard)
            losses.append(stats["loglik"])
            if on_step is not None:
                on_step(it, state, float(stats["loglik"]))
            it += 1
    return state, (torch.stack(losses).tolist() if losses else [])


def train_minibatch(
    step_fn: StepFn,
    state,
    corpus: Corpus,
    batch_size: int,
    num_steps: int,
    generator: torch.Generator | None = None,
    mesh=None,
):
    """``num_steps`` minibatch steps -> (state, per-step logliks as floats).
    The draws come from ``generator`` (a CPU generator seeded 0 when None;
    under a mesh the same seed on every rank); the logliks stay on the
    device until the loop ends."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    one = make_minibatch_step(step_fn, corpus, batch_size, mesh=mesh)
    lls = []
    for _ in range(num_steps):
        state, stats = one(state, generator)
        lls.append(stats["loglik"])
    return state, (torch.stack(lls).tolist() if lls else [])
