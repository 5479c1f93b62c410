"""Multi-process data parallelism: process groups, per-rank data and the
out-of-core trainers across ranks.

Counterpart of ``multimodalworddiscovery_tpu/parallel/multihost.py``.  JAX
runs one controller per host over a global mesh of global arrays; here
every device is one rank of a ``torch.distributed`` process group (NCCL
for CUDA, gloo for the CPU, or gloo on CUDA tensors where the caller names
it), every rank holds only its own rows, and the ranks meet in explicit
collectives (``core/collectives.py``):

- ``initialize`` joins the group from torchrun's variables (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or an
  ``init_method`` (a ``file://`` store for local worlds); ``spawn`` runs a
  function on a local world of new processes and returns each rank's
  result.
- ``process_slice`` gives the rows a process loads; ``global_corpus_from_
  local`` pads the ranks' rows to one agreed size (an all_reduce(MAX));
  ``replicate_to_global`` broadcasts rank 0's parameters.
- The out-of-core trainers stream shards from disk: in round r rank p
  loads shard r P + p (an all-zero shard past the end, zero counts) and
  each EM iteration ends in one all_reduce of its counts; the minibatch
  trainer visits shards cyclically, (r P + p) mod K, and samples within
  each rank's own rows.
- ``reservoir_frames_multihost`` merges the ranks' frame reservoirs into
  exactly the single-process sample, and ``init_vq_teacher_streaming_
  multihost`` runs the whole streaming VQ-teacher recipe across ranks.
- Checkpoint and metric writes are gated on ``is_coordinator()``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodalworddiscovery_tpu_torch.core.collectives import (
    all_max,
    all_sum,
    broadcast,
    gather,
    group_of,
)
from multimodalworddiscovery_tpu_torch.core.mesh import DATA_AXIS, check_mesh, make_mesh
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    device="cuda",
    local_rank: int | None = None,
    timeout: float | None = None,
) -> None:
    """Join the process group (a second call is a no-op).

    Without ``init_method`` torch reads ``MASTER_ADDR`` / ``MASTER_PORT``
    (``env://``), and ``world_size`` / ``rank`` default to ``WORLD_SIZE`` /
    ``RANK``, as torchrun sets them.  ``backend`` follows ``device``: NCCL
    for "cuda", gloo for "cpu"; a caller may name it (gloo on CUDA tensors
    runs several ranks on one card, which NCCL refuses).  On CUDA the rank
    takes device ``local_rank`` (default ``LOCAL_RANK``, else the rank
    modulo the device count).  ``timeout`` (seconds) bounds every
    collective's wait."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize(device='cuda') on a host without CUDA; pass device='cpu'")
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if dev.type == "cuda":
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local_rank)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)


def is_coordinator() -> bool:
    """True on the process that writes checkpoints and metrics (rank 0, or
    a process outside any group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(axis_name: str = DATA_AXIS):
    """1-D mesh over every rank of the group."""
    return make_mesh(None, axis_name)


def process_slice(n_total: int, process_id: int | None = None,
                  num_processes: int | None = None) -> tuple[int, int]:
    """[start, stop) of the rows this process loads: as even as possible,
    the first ``n_total % P`` processes one row more."""
    if process_id is None:
        process_id = dist.get_rank() if dist.is_initialized() else 0
    if num_processes is None:
        num_processes = dist.get_world_size() if dist.is_initialized() else 1
    base, extra = divmod(n_total, num_processes)
    start = process_id * base + min(process_id, extra)
    return start, start + base + (1 if process_id < extra else 0)


def global_corpus_from_local(local: Corpus, mesh=None, axis_name: str = DATA_AXIS) -> Corpus:
    """This rank's rows padded with zero-length utterances to the largest
    rank's count (one all_reduce(MAX)), so every rank runs the same shapes.
    The padded widths (Ts, Tt) and the vocabularies must already agree:
    they are corpus-level constants, not the slice's."""
    if mesh is None:
        mesh = global_mesh(axis_name)
    n = all_max(torch.tensor(local.n, device=local.device), group_of(mesh))
    return local.pad_to(int(n))


def replicate_to_global(tree, mesh=None):
    """A copy of a parameter tree with every tensor broadcast from rank 0,
    so a deterministic init (or a restored checkpoint) is identical on
    every rank whatever each computed."""
    if mesh is None:
        mesh = global_mesh()
    return broadcast(tree, group_of(mesh))


def _zero_shard(reader) -> Corpus:
    """An all-zero corpus of the reader's shard shape (zero counts)."""
    c = reader.load_shard(0)
    return dataclasses.replace(c, src=torch.zeros_like(c.src), src_len=torch.zeros_like(c.src_len),
                               trg=torch.zeros_like(c.trg), trg_len=torch.zeros_like(c.trg_len))


def streamed_round_corpora(readers, mesh=None, axis_name: str = DATA_AXIS, prefetch: int = 1):
    """Yield, round by round, this rank's tuple of shards, one per reader:
    in round r rank p loads shard r P + p of each reader (``prefetch``
    ahead), or an all-zero shard past the end; ceil(K/P) rounds cover the
    corpus.  Paired readers (a frame corpus and its code corpus) must have
    the same shard structure, so a round's shards are row-aligned."""
    if mesh is None:
        mesh = global_mesh(axis_name)
    n_proc, pid = check_mesh(mesh).size(), mesh.get_local_rank()
    readers = tuple(readers)
    for rd in readers:
        if (rd.num_shards, rd.shard_size) != (readers[0].num_shards, readers[0].shard_size):
            raise ValueError("paired readers must have identical shard structure, got "
                             f"{(rd.num_shards, rd.shard_size)} vs "
                             f"{(readers[0].num_shards, readers[0].shard_size)}")
    k = readers[0].num_shards
    rounds = -(-k // n_proc)
    ids = [r * n_proc + pid for r in range(rounds) if r * n_proc + pid < k]
    yield from zip(*(rd.shards(prefetch, ids) for rd in readers))
    if len(ids) < rounds:
        yield tuple(_zero_shard(rd) for rd in readers)


def train_streaming_multihost(
    mod,
    params,
    reader,
    num_iterations: int,
    mesh=None,
    count_kwargs: dict | None = None,
    m_step_kwargs: dict | None = None,
    axis_name: str = DATA_AXIS,
    prefetch: int = 1,
    on_iteration=None,
    scale_schedule=None,
    use_kernels: bool | None = None,
):
    """Out-of-core EM across ranks: every rank streams its own shards
    (``streamed_round_corpora``), sums their counts on its device, one
    all_reduce an iteration pools counts and loglik over the ranks, and the
    M-step runs on every rank.  Exact: resident EM up to addition order.
    ``params`` are broadcast from rank 0 first; ``scale_schedule`` and
    ``use_kernels`` as in ``data.stream.train_streaming``.  Returns
    (params, [loglik per iteration])."""
    from multimodalworddiscovery_tpu_torch.data.stream import stream_em

    if mesh is None:
        mesh = global_mesh(axis_name)
    return stream_em(
        mod, replicate_to_global(params, mesh),
        lambda: (c for (c,) in streamed_round_corpora((reader,), mesh, prefetch=prefetch)),
        num_iterations, count_kwargs, m_step_kwargs, group_of(mesh), on_iteration,
        scale_schedule, use_kernels)


def round_shards(r: int, n_proc: int, num_shards: int) -> list[int]:
    """The shards of round ``r`` of the cyclic schedule, one per rank:
    (r P + p) mod K.  Any ceil(K / P) consecutive rounds cover every
    shard."""
    return [(r * n_proc + p) % num_shards for p in range(n_proc)]


def train_minibatch_streaming_multihost(
    step_fn,
    state,
    reader,
    batch_size: int,
    num_steps: int,
    seed: int = 0,
    steps_per_round: int | None = None,
    mesh=None,
    axis_name: str = DATA_AXIS,
    prefetch: int = 1,
    start_step: int = 0,
    on_step=None,
):
    """Out-of-core minibatch SGD across ranks: in round r rank p holds shard
    (r P + p) mod K (the cyclic schedule: P consecutive shards at stride P
    cover every shard for any P and K, and no rank ever holds a placeholder
    shard), ``steps_per_round`` (default P shard_size // batch_size) steps
    sample ``batch_size / P`` real rows on each rank (``sample="local"``),
    and the step all-reduces its gradients (``step_fn`` takes ``mesh=``).
    Step ``it`` on rank p draws from ``step_generator(seed, it, p)`` and its
    round is ``it // steps_per_round``, so a run resumed at ``start_step``
    continues the schedule.  ``state`` is broadcast from rank 0 first.
    Returns (state, per-step losses: the steps' global "loglik")."""
    from multimodalworddiscovery_tpu_torch.models.minibatch import (
        make_minibatch_step,
        step_generator,
    )

    if mesh is None:
        mesh = global_mesh(axis_name)
    n_proc, pid = check_mesh(mesh).size(), mesh.get_local_rank()
    if steps_per_round is None:
        steps_per_round = max(1, n_proc * reader.shard_size // batch_size)
    stop = start_step + num_steps
    first_round = start_step // steps_per_round
    last_round = max((stop - 1) // steps_per_round, first_round)
    rounds = list(range(first_round, last_round + 1))
    ids = [round_shards(r, n_proc, reader.num_shards)[pid] for r in rounds]
    state = replicate_to_global(state, mesh)
    step, losses, it = None, [], start_step
    for r, corpus in zip(rounds, reader.shards(prefetch, ids)):
        if step is None:  # one step for every round: the shards share one shape
            step = make_minibatch_step(step_fn, corpus, batch_size, mesh=mesh, sample="local",
                                       bind_corpus=False)
        while it < min((r + 1) * steps_per_round, stop):
            state, stats = step(state, step_generator(seed, it, pid), corpus)
            losses.append(stats["loglik"])
            if on_step is not None:
                on_step(it, state, float(stats["loglik"]))
            it += 1
    return state, (torch.stack(losses).tolist() if losses else [])


def bucket_local_static(local: Corpus, bucket_edges: list[int],
                        max_src_len: int | None = None) -> list:
    """Bucket this rank's rows by STATIC edges: always ``len(bucket_edges)
    + 1`` buckets, bucket i's time axis padded to edge i (the last to
    ``max_src_len``), an empty bucket as one zero-length row, so every rank
    has the same bucket count and widths and their collectives line up
    (``data.bucketing.bucket_corpus`` pads to each bucket's own maximum and
    merges small buckets: data-dependent).  Returns [(bucket corpus, local
    row indices)]."""
    if max_src_len is None:
        max_src_len = local.max_src_len
    src_len = local.src_len.cpu().numpy()
    edges = [min(int(e), max_src_len) for e in bucket_edges] + [max_src_len]
    out = []
    assigned = np.zeros(local.n, dtype=bool)
    for edge in edges:
        sel = (~assigned) & (src_len <= edge)
        idx = np.where(sel)[0]
        assigned |= sel
        rows = torch.as_tensor(idx, dtype=torch.long, device=local.device)
        sub = Corpus(src=local.src[rows][:, :max(edge, 1)], src_len=local.src_len[rows],
                     trg=local.trg[rows], trg_len=local.trg_len[rows],
                     src_vocab=local.src_vocab, trg_vocab=local.trg_vocab)
        out.append((sub.pad_to(max(sub.n, 1)), idx))
    return out


def train_bucketed_multihost(
    mod,
    params,
    local: Corpus,
    bucket_edges: list[int],
    num_iterations: int,
    smoothing: float = 1e-8,
    mesh=None,
    use_kernels: bool | None = None,
    axis_name: str = DATA_AXIS,
    on_iteration=None,
):
    """Exact length-bucketed EM across ranks, each holding its own rows
    (``local``): static buckets (``bucket_local_static``), each padded to
    the ranks' largest count (``global_corpus_from_local``), the counts
    summed over the buckets on the device and over the ranks in one
    all_reduce an iteration, one M-step on every rank.  Closed-form modules
    only: the DNN-HMM's neural M-step takes per-bucket posteriors, which
    would move O(corpus) between ranks.  Returns (params, [loglik per
    iteration])."""
    from multimodalworddiscovery_tpu_torch.data.stream import tree_sum_bounded
    from multimodalworddiscovery_tpu_torch.models.bucketed import _kernel_kwargs

    if hasattr(mod, "neural_m_step"):
        raise ValueError(f"{mod.__name__}: train_bucketed_multihost takes closed-form "
                         "modules (model1, hmm, hmm_gaussian)")
    if mesh is None:
        mesh = global_mesh(axis_name)
    group = group_of(mesh)
    buckets = [global_corpus_from_local(b, mesh) for b, _ in
               bucket_local_static(local, bucket_edges)]
    ekw = _kernel_kwargs(mod.expected_counts, use_kernels)
    params = replicate_to_global(params, mesh)
    logliks = []
    for it in range(num_iterations):
        counts, ll = all_sum(tree_sum_bounded(mod.expected_counts(params, b, **ekw)
                                              for b in buckets), group)
        params = mod.m_step(params, counts, smoothing)
        logliks.append(float(ll))
        if on_iteration is not None:
            on_iteration(it, params, logliks[-1])
    return params, logliks


def reservoir_frames_multihost(reader, n_sample: int = 65536, seed: int = 0,
                               mesh=None) -> np.ndarray:
    """Cross-rank uniform frame reservoir: each rank runs the sort-key
    reservoir over its own shards (p, p + P, ...; the keys of shard k are a
    function of (seed, k)), the ranks' (key, frame) tops are gathered
    (padded to the longest with the length's all_reduce(MAX)), and the
    ``n_sample`` smallest keys win.  Exactly the single-process
    ``hmm_gaussian._reservoir_frames`` sample, in its ascending-key order:
    every frame of the global top n is in its rank's top n."""
    from multimodalworddiscovery_tpu_torch.models.hmm_gaussian import _reservoir_frames

    if mesh is None:
        mesh = global_mesh()
    group = group_of(mesh)
    n_proc, pid = check_mesh(mesh).size(), mesh.get_local_rank()
    buf, keys = _reservoir_frames(reader, n_sample, seed=seed,
                                  shards=range(pid, reader.num_shards, n_proc),
                                  return_keys=True)
    m, d = buf.shape
    dev = reader.device
    m_max = int(all_max(torch.tensor(m, device=dev), group))
    keys_pad = np.full((m_max,), np.inf)
    keys_pad[:m] = keys
    buf_pad = np.zeros((m_max, d), np.float32)
    buf_pad[:m] = buf
    gk = gather(torch.from_numpy(keys_pad).to(dev), group).reshape(-1).cpu().numpy()
    gb = gather(torch.from_numpy(buf_pad).to(dev), group).reshape(-1, d).cpu().numpy()
    real = np.isfinite(gk)
    gk, gb = gk[real], gb[real]
    if gk.shape[0] > n_sample:
        top = np.argpartition(gk, n_sample - 1)[:n_sample]
        gk, gb = gk[top], gb[top]
    return gb[np.argsort(gk, kind="stable")]


def init_vq_teacher_streaming_multihost(
    reader,
    code_dir,
    max_jump: int = 3,
    n_components: int = 1,
    generator: torch.Generator | None = None,
    *,
    n_codes: int = 64,
    teacher_iters: int = 10,
    seed_rounds: int = 3,
    use_kernels: bool | None = None,
    prefetch: int = 1,
    n_sample: int = 65536,
    mesh=None,
    axis_name: str = DATA_AXIS,
):
    """``hmm_gaussian.init_vq_teacher_streaming`` with every pass over the
    corpus split over the ranks, stage by stage (each stage is additive
    over shards or deterministic, so the result is the single-process
    recipe's up to addition order):

      1. base parameters from whole-corpus moments: each rank's shards,
         one all_reduce;
      2. the codebook from the merged reservoir (``reservoir_frames_
         multihost``: the single-process sample), fitted on every rank;
         each rank quantizes its own shards into the shared ``code_dir``
         (rank 0 writes the manifest), then a barrier;
      3. the discrete teacher by ``train_streaming_multihost`` over the code
         shards (K1 + K2 on the card);
      4. ``seed_rounds`` rounds of pinned-assignment GMM EM over paired
         (frame, code) round shards (K1 + K4), one all_reduce a round;
      5. the teacher's transitions copied over.

    ``generator`` (the same seed on every rank) draws the initial jitter,
    then the codebook's seed frames, as the single-process recipe does.
    Returns parameters identical on every rank."""
    from multimodalworddiscovery_tpu_torch.data.stream import (
        ShardedCorpusReader,
        tree_sum_bounded,
    )
    from multimodalworddiscovery_tpu_torch.models import hmm as dhmm
    from multimodalworddiscovery_tpu_torch.models import hmm_gaussian as hg

    if mesh is None:
        mesh = global_mesh(axis_name)
    group = group_of(mesh)
    n_proc, pid = check_mesh(mesh).size(), mesh.get_local_rank()
    mine = list(range(pid, reader.num_shards, n_proc))
    gen = hg._generator(generator)

    shard0 = reader.load_shard(0)
    shift = hg.feature_shift(shard0)
    if mine:
        local = tree_sum_bounded(hg.init_moments(s, shift, with_diagonal=False)
                                 for s in reader.shards(prefetch, mine))
    else:
        local = {k: torch.zeros_like(v)
                 for k, v in hg.init_moments(shard0, shift, with_diagonal=False).items()}
    del shard0
    base = hg.init_from_moments(all_sum(local, group), max_jump=max_jump,
                                n_components=n_components, generator=gen, mode="global",
                                shift=shift)

    frames = reservoir_frames_multihost(reader, n_sample=n_sample, mesh=mesh)
    cb = hg.fit_codebook_reservoir(reader, n_codes=n_codes, generator=gen, frames=frames)
    hg.quantize_shards_streaming(reader, code_dir, codebook=cb, shard_ids=mine,
                                 write_manifest=pid == 0)
    dist.barrier(group=group)
    code_reader = ShardedCorpusReader(code_dir, device=reader.device)

    tp = dhmm.init(code_reader.load_shard(0), max_jump=max_jump)  # vocabularies only
    tp, _ = train_streaming_multihost(dhmm, tp, code_reader, teacher_iters, mesh=mesh,
                                      prefetch=prefetch, use_kernels=use_kernels)
    zero_w = torch.zeros(2 * max_jump + 3, device=base.means.device)

    def seed_counts(gp, fshard, cshard):
        gamma = dhmm.posteriors(tp, cshard, use_kernels=use_kernels)
        r = hg.teacher_responsibilities(gamma, fshard)
        return hg.counts_from_responsibilities(gp, fshard, r, zero_w)

    gp = base
    for _ in range(max(int(seed_rounds), 1)):
        total = tree_sum_bounded(
            seed_counts(gp, f, c) for f, c in streamed_round_corpora(
                (reader, code_reader), mesh, prefetch=prefetch))
        gp = hg.m_step(gp, all_sum(total, group))
    return dataclasses.replace(gp, log_jump=tp.log_jump, log_p0=tp.log_p0)


def _to_host(x):
    """Tensors (in dicts, lists and tuples) as numpy arrays, so a rank's
    result crosses the process boundary by value."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, world_size, init_method, backend, device, timeout, fn, args, results):
    if torch.device(device).type == "cpu":  # the host's cores shared between the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        initialize(init_method, world_size, rank, backend=backend, device=device,
                   timeout=timeout)
        results.put((rank, True, _to_host(fn(*args))))
    except Exception:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (), device="cuda", backend: str | None = None,
          timeout: float = 600.0, store_dir=None) -> list:
    """Run ``fn(*args)`` on a local world of ``world_size`` new processes
    (start method "spawn"), each a rank of one process group initialized
    through a ``file://`` store in a temporary directory under
    ``store_dir``; returns the ranks' results in rank order, tensors as
    numpy arrays.  ``fn`` must be importable (a module-level function).
    ``device`` and ``backend`` are ``initialize``'s: on "cuda" (without
    CUDA this raises) rank r takes card r modulo the card count, so more
    ranks than cards need ``backend="gloo"``; pass ``device="cpu"`` for
    gloo ranks on the CPU.  A rank that raises makes this raise with its
    traceback, after the other ranks are stopped; ``timeout`` (seconds)
    bounds the whole run and each collective."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn(device='cuda') on a host without CUDA; pass device='cpu'")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as d:
        init_method = "file://" + os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, world_size, init_method, backend,
                                                      str(device), timeout, fn, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        done, failed = {}, {}
        deadline = time.monotonic() + timeout
        try:
            while len(done) + len(failed) < world_size and not failed:
                try:
                    rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.1))
                except queue_mod.Empty:
                    raise TimeoutError(f"spawn: {world_size - len(done)} ranks gave no result "
                                       f"in {timeout} s") from None
                (done if ok else failed)[rank] = value
        finally:
            for p in procs:
                if failed:
                    p.terminate()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed:
        rank = min(failed)
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n{failed[rank]}")
    return [done[r] for r in range(world_size)]
