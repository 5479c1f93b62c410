"""Minibatch training for the gradient-based aligners (attention, grounding).

Counterpart of ``multimodalworddiscovery_tpu/models/minibatch.py``, its
single-device half: the corpus stays on the device, and each step gathers a
random minibatch there (one ``index_select`` per corpus field) and runs the
model step on it.  Teacher signals (the HMM guide of guided attention) are
computed per batch inside the step function.  The draws come from a
``torch.Generator``: a CPU generator draws on the CPU (one seed, one
sequence on every machine) and the indices go to the corpus's device.

``train_minibatch_streaming`` trains on ``data/stream`` shards, one
resident at a time.  The data-parallel forms (a mesh, ``sample="local"``,
``sample_local_batch``) wait for the port's mesh (ROADMAP queue 1, item 5:
``parallel/`` on torch.distributed); until then they raise
NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus

StepFn = Callable[[Any, Corpus], tuple[Any, dict]]
DATA_AXIS = "data"
_WAITS = ("waits for the port's {} (ROADMAP queue 1, item 5: parallel/ on "
          "torch.distributed)")


def gather_batch(corpus: Corpus, idx: torch.Tensor) -> Corpus:
    """Static-shape minibatch: one gather per corpus field, on its device."""
    idx = idx.to(corpus.device).long()
    take = lambda x: x.index_select(0, idx)  # noqa: E731
    return Corpus(src=take(corpus.src), src_len=take(corpus.src_len), trg=take(corpus.trg),
                  trg_len=take(corpus.trg_len), src_vocab=corpus.src_vocab,
                  trg_vocab=corpus.trg_vocab)


def sample_local_batch(corpus: Corpus, generator, batch_size: int, mesh,
                       axis_name: str = DATA_AXIS):
    """Per-device stratified minibatch over a sharded corpus."""
    raise NotImplementedError("sample_local_batch " + _WAITS.format("mesh"))


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
    """
    n = corpus.n
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > corpus size {n}")
    if sample not in ("global", "local", "valid"):
        raise ValueError(f"sample must be global|local|valid, got {sample!r}")
    if mesh is not None or sample == "local":
        raise NotImplementedError("make_minibatch_step with a mesh or sample='local' "
                                  + _WAITS.format("mesh"))

    def step(state, generator: torch.Generator, c: Corpus):
        if sample == "valid":
            probs = (c.src_len > 0).to(torch.float32).to(generator.device)
            idx = torch.multinomial(probs, batch_size, replacement=True, generator=generator)
        else:
            idx = torch.randperm(c.n, generator=generator, device=generator.device)[:batch_size]
        return step_fn(state, gather_batch(c, idx))

    if not bind_corpus:
        return step
    return lambda state, generator: step(state, generator, corpus)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of global step ``step``, derived from (seed, step)
    alone (the JAX package's ``fold_in(key, step)``), so a run resumed at
    a step draws what the uninterrupted run drew there."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
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

    Returns (state, per-step losses as floats, the step stats' "loglik",
    read once at the end); ``on_step(global_step, state, loss)`` runs after
    every step (and reads its loss then).
    """
    if mesh is not None:
        raise NotImplementedError("train_minibatch_streaming with a mesh "
                                  + _WAITS.format("mesh"))
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
                                                         for b in blocks])):
        if step is None:  # one step for every shard: they share one shape
            step = make_minibatch_step(step_fn, shard, batch_size, sample="valid",
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
    The draws come from ``generator`` (a CPU generator seeded 0 when None);
    the logliks stay on the device until the loop ends."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    one = make_minibatch_step(step_fn, corpus, batch_size, mesh=mesh)
    lls = []
    for _ in range(num_steps):
        state, stats = one(state, generator)
        lls.append(stats["loglik"])
    return state, (torch.stack(lls).tolist() if lls else [])
