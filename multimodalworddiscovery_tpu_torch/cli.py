"""Command-line entry points of the port: train / align / segment / evaluate
and the rest of the reference's ``mwd`` subcommands.

Counterpart of ``multimodalworddiscovery_tpu/cli.py``, with the same
subcommands, flags, config keys and files in the workdir (``config.json``,
``train_metrics.jsonl``, ``alignment.json``, ``segments.json``,
``metrics.json``, ``retrieval.json``, ``lexicon.json``, ``model.npz``), so
the documented commands run unchanged under ``mwd-torch`` (or ``python -m
multimodalworddiscovery_tpu_torch.cli``):

  mwd-torch train    --config multimodalworddiscovery_tpu_torch/configs/hmm_mini.py --workdir RUN
  mwd-torch align    --workdir RUN [--output alignment.json]
  mwd-torch segment  --workdir RUN [--output segments.json]
  mwd-torch evaluate --workdir RUN [--output metrics.json]

Each subcommand also takes ``--device`` (default ``cuda``): the run is on
the card, through the hand-written kernels, unless ``--device cpu`` is
given, and on a host without CUDA a command without it stops with an
error (it never falls back to the CPU).  Checkpoints are ``torch.save``
files under ``<workdir>/ckpt`` (``utils/checkpoint.py``; a JAX workdir's
orbax checkpoints are refused, not read).  Random draws (initial weights,
codebook seeds, candidate pools, minibatches) come from CPU
``torch.Generator``s seeded from ``seed``, so one config gives the same run
on the CPU and on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import inspect
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from multimodalworddiscovery_tpu_torch.core.config import apply_overrides, base_config, load_config
from multimodalworddiscovery_tpu_torch.core.metrics_io import MetricsWriter, _to_jsonable
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus, GoldAnnotations
from multimodalworddiscovery_tpu_torch.data.io import load_corpus, save_alignment_json
from multimodalworddiscovery_tpu_torch.data.synthetic import make_flickr8k_mini
from multimodalworddiscovery_tpu_torch.models.registry import get_model
from multimodalworddiscovery_tpu_torch.parallel import multihost
from multimodalworddiscovery_tpu_torch.parallel.data_parallel import take_rows
from multimodalworddiscovery_tpu_torch.segment import (
    boundaries_from_segments,
    segments_from_alignment,
    segments_to_host,
)
from multimodalworddiscovery_tpu_torch.utils.checkpoint import CheckpointManager

EM_MODELS = ("model1", "hmm", "hmm_gaussian", "hmm_dnn")
# hmm_crf is gradient-trained too (n_sgd Adam steps through the marginal per
# call + closed-form transition M-step), so it minibatches like the neural
# models
GRAD_MODELS = ("attention", "grounding", "hmm_crf")
HMM_FAMILY = ("hmm", "hmm_gaussian", "hmm_dnn", "hmm_crf")
_RETRIEVAL_MODELS = ("model1", *HMM_FAMILY, "grounding")


# ---------------------------------------------------------------------------
# devices, seeds, process groups
# ---------------------------------------------------------------------------


def _device(args) -> torch.device:
    """The run's device: ``--device`` (default "cuda").  Without CUDA a cuda
    run stops here: nothing falls back to the CPU."""
    dev = torch.device(getattr(args, "device", None) or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mwd-torch runs on the card (--device cuda, the default), and this "
                         "host has no CUDA device; pass --device cpu to run on the CPU")
    return dev


def _generator(seed: int) -> torch.Generator:
    """The CPU generator of a seed (the reference's PRNGKey(seed)): one
    seed, one sequence of draws on every host."""
    return torch.Generator().manual_seed(int(seed))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _process_group(cfg, dev: torch.device):
    """The process group a training run needs: with ``train.distributed``
    torchrun's world (``parallel.multihost.initialize``: RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT); with ``train.data_parallel``
    alone a world of one rank in this process (NCCL on the card, gloo on
    the CPU), destroyed afterwards.  A group that exists already is used as
    it is."""
    if dist.is_initialized() or not (cfg.train.get("distributed", False)
                                     or cfg.train.data_parallel):
        yield
        return
    if cfg.train.get("distributed", False):
        multihost.initialize(device=dev)
        try:
            yield
        finally:
            dist.destroy_process_group()
        return
    with tempfile.TemporaryDirectory(prefix="mwd_torch_group_") as d:
        multihost.initialize("file://" + str(Path(d) / "store"), world_size=1, rank=0,
                             device=dev)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _mesh(cfg):
    """The data-parallel mesh over every rank of the group, or None."""
    if not (cfg.train.get("distributed", False) or cfg.train.data_parallel):
        return None
    from multimodalworddiscovery_tpu_torch.core.mesh import make_mesh

    return make_mesh()


# ---------------------------------------------------------------------------
# data, models, decode
# ---------------------------------------------------------------------------


def _load_data(cfg, device) -> tuple[Corpus, GoldAnnotations | None]:
    if cfg.data.source == "synthetic":
        corpus, gold, _ = make_flickr8k_mini(
            n_utterances=cfg.data.n_utterances,
            n_concepts=cfg.data.n_concepts,
            n_phones=cfg.data.n_phones,
            min_concepts=cfg.data.get("min_concepts", 2),
            max_concepts=cfg.data.get("max_concepts", 4),
            seed=cfg.seed,
            device=device,
        )
        if cfg.data.continuous:
            from multimodalworddiscovery_tpu_torch.data.synthetic import phones_to_frames

            corpus, gold, _ = phones_to_frames(
                corpus, gold, feat_dim=cfg.data.feat_dim, seed=cfg.seed, device=device
            )
        return corpus, gold
    if cfg.data.source == "disk":
        return load_corpus(cfg.data.dir, cfg.data.name, device=device)
    if cfg.data.source == "stream":
        # decode/eval-time convenience: materialize the sharded corpus (the
        # TRAIN path never calls this: cmd_train streams shard by shard)
        from multimodalworddiscovery_tpu_torch.data.stream import ShardedCorpusReader

        return ShardedCorpusReader(cfg.data.dir, device=device).materialize()
    raise ValueError(f"unknown data.source {cfg.data.source!r}")


def _resolve_use_pallas(cfg, corpus) -> bool | None:
    """model.use_pallas = auto|on|off -> the HMM family's ``use_kernels``.

    The reference's rule is the TPU's (the fused kernel only past a state
    space or corpus size).  On the H100 every kernel of the E-step is far
    ahead of its plain version at every shape the paths give it (PERF.md
    §6: K2 0.0855 ms against 23.62 plain at the headline), so ``auto`` is
    None, the kernels on a CUDA corpus and their plain versions on a CPU
    one; ``on`` is True and refuses a CPU corpus; ``off`` is False, the
    plain versions on any device."""
    mode = str(cfg.model.get("use_pallas", "auto")).lower()
    if mode in ("on", "true", "1"):
        if corpus.device.type != "cuda":
            raise ValueError("model.use_pallas=on runs the CUDA kernels, and this corpus is on "
                             f"{corpus.device}; use auto or off off the card")
        return True
    if mode in ("off", "false", "0"):
        return False
    if mode != "auto":
        raise ValueError(f"model.use_pallas must be auto|on|off, got {mode!r}")
    return None


def _resolve_decode_pallas(cfg, corpus) -> bool | None:
    """``use_kernels`` of DECODE (Viterbi).  Unlike the reference, whose
    ``auto`` keeps decode on the scan decoder (its kernel's memory at large
    S, and ties broken differently), ``auto`` decodes through K3 on a CUDA
    corpus: K3 keeps 8- or 16-bit backpointers, is 100x its plain version
    at the headline, and on the headline corpus its paths equal the plain
    ``viterbi_factored``'s except at the ties counted in PERF.md (the
    measurement behind this rule).  on / off as for the E-step."""
    return _resolve_use_pallas(cfg, corpus)


def _make_teacher(cfg, corpus):
    """Train the guide teacher (discrete or Gaussian HMM) for guided
    attention; returns (teacher_params, posteriors_fn)."""
    teacher = cfg.model.guide
    iters = cfg.model.get("guide_iters", 15)
    if teacher == "hmm":
        from multimodalworddiscovery_tpu_torch.models import hmm as tmod
    elif teacher == "hmm_gaussian":
        from multimodalworddiscovery_tpu_torch.models import hmm_gaussian as tmod
    else:
        raise ValueError(f"model.guide must be ''|hmm|hmm_gaussian, got {teacher!r}")
    if teacher == "hmm":
        tp = tmod.init(corpus, max_jump=cfg.model.max_jump)
    else:
        tp = tmod.init(
            corpus, max_jump=cfg.model.max_jump,
            n_components=cfg.model.get("n_components", 2),
            generator=_generator(cfg.seed + 1),
        )
    tp, _ = tmod.train(tp, corpus, iters, use_kernels=_resolve_use_pallas(cfg, corpus))
    print(f"trained {teacher} teacher ({iters} EM iters); attention will be guided")
    return tp, tmod.posteriors


def _make_model(cfg, corpus, init_only: bool = False):
    """Build (module, params, step) for the configured model.

    ``init_only`` skips expensive step construction (e.g. training the HMM
    teacher for guided attention): restore paths only need the parameter
    template, never the training step.
    """
    mod = get_model(cfg.model.name)
    name = cfg.model.name
    gen = _generator(cfg.seed)
    if name == "model1":
        params = mod.init(corpus)
        step = functools.partial(mod.em_step, smoothing=cfg.model.smoothing)
    elif name in HMM_FAMILY:
        use_kernels = _resolve_use_pallas(cfg, corpus)
        dot_dtype = cfg.model.get("dot_dtype", "float32")
        if name == "hmm":
            params = mod.init(corpus, max_jump=cfg.model.max_jump)
            step = functools.partial(
                mod.em_step, smoothing=cfg.model.smoothing,
                use_kernels=use_kernels, dot_dtype=dot_dtype,
            )
        elif name == "hmm_gaussian":
            init_mode = str(cfg.model.get("init", "global"))
            if init_mode not in ("global", "diagonal", "vq_teacher"):
                raise SystemExit(
                    "model.init must be global|diagonal|vq_teacher, "
                    f"got {init_mode!r}"
                )
            # restore paths (init_only) need only the parameter TEMPLATE:
            # skip the seeding work (every init gives the same shapes)
            init_kw = {}
            if init_only or init_mode == "global":
                init_fn = mod.init
            elif init_mode == "diagonal":
                init_fn = mod.init_diagonal
            else:
                init_fn = mod.init_vq_teacher
                init_kw = dict(
                    n_codes=cfg.model.get("vq_codes", 64),
                    teacher_iters=cfg.model.get("teacher_iters", 10),
                    seed_rounds=cfg.model.get("seed_rounds", 3),
                    use_kernels=use_kernels,
                    chunks=int(cfg.train.get("corpus_chunks", 1)),
                )
            params = init_fn(
                corpus,
                max_jump=cfg.model.max_jump,
                n_components=cfg.model.get("n_components", 2),
                generator=gen,
                **init_kw,
            )
            step = functools.partial(mod.em_step, use_kernels=use_kernels, dot_dtype=dot_dtype)
        else:
            learn_trans = bool(cfg.model.get("learn_transitions", False))
            if learn_trans and name != "hmm_crf":
                raise SystemExit(
                    "model.learn_transitions requires model.name=hmm_crf "
                    "(the end-to-end differentiable aligner)"
                )
            init_fn = mod.init_e2e if learn_trans else mod.init
            params = init_fn(
                corpus, max_jump=cfg.model.max_jump,
                hidden=cfg.model.get("hidden", 256),
                learning_rate=cfg.model.get("learning_rate", 1e-3),
                n_sgd=cfg.model.get("n_sgd", 4),
                generator=gen,
            )
            step_kw = dict(use_kernels=use_kernels, dot_dtype=dot_dtype)
            if name == "hmm_crf":
                step_kw["learn_transitions"] = learn_trans
            step = functools.partial(mod.em_step, **step_kw)
        if use_kernels is not False and corpus.device.type == "cuda" and not init_only:
            print("E-step: hand-written CUDA kernels (model.use_pallas)")
    elif name == "attention":
        params = mod.init(
            corpus, dim=cfg.model.get("dim", 128),
            learning_rate=cfg.model.get("learning_rate", 3e-4),
            entropy_weight=cfg.model.get("entropy_weight", 0.0),
            subsample=cfg.model.get("subsample", 1),
            generator=gen,
        )
        step = mod.em_step
        if cfg.model.get("guide", "") and not init_only:
            # Teacher-guided attention: the guide matrix is computed INSIDE
            # the step from the teacher's parameters, so it works for full
            # corpora, a rank's rows and minibatches alike; under a mesh the
            # step takes and forwards mesh= (its gradient all-reduce)
            tp, posteriors_fn = _make_teacher(cfg, corpus)
            gw = cfg.model.get("guide_weight", 1.0)

            def step(state, c, mesh=None, _tp=tp, _pf=posteriors_fn, _gw=gw):
                g = mod.hmm_guide_matrix(_tp, c, posteriors_fn=_pf)
                return mod.em_step(state, c, guide=g, guide_weight=_gw, mesh=mesh)

    elif name == "grounding":
        params = mod.init(
            corpus, dim=cfg.model.get("dim", 128),
            learning_rate=cfg.model.get("learning_rate", 1e-3),
            margin=cfg.model.get("margin", 1.0),
            generator=gen,
        )
        step = mod.em_step
    else:
        params = mod.init(corpus, generator=gen)
        step = mod.em_step
    return mod, params, step


def _decode_kwargs(cfg, mod, corpus) -> dict:
    """Model-specific decode knobs from config (e.g. the attention aligner's
    NULL threshold) when the model's ``align`` supports them."""
    kw = {}
    sig = inspect.signature(mod.align).parameters
    nt = float(cfg.model.get("null_threshold", 0.0) or 0.0)
    if nt and "null_threshold" in sig:
        kw["null_threshold"] = nt
    if "use_kernels" in sig:
        kw["use_kernels"] = _resolve_decode_pallas(cfg, corpus)
    return kw


def _align_call(cfg, mod, params, corpus):
    kw = _decode_kwargs(cfg, mod, corpus)
    with torch.no_grad():
        return mod.align(params, corpus, **kw)


def _save_config(cfg, workdir: Path) -> None:
    (workdir / "config.json").write_text(cfg.to_json(indent=2))


def _load_workdir_config(workdir: Path):
    cfg = base_config()
    saved = json.loads((workdir / "config.json").read_text())

    def merge(node, d):
        for k, v in d.items():
            if isinstance(v, dict) and hasattr(node, k):
                merge(getattr(node, k), v)
            else:
                setattr(node, k, v)

    with cfg.unlocked():  # custom config files may carry extra keys
        merge(cfg, saved)
    return cfg


def _floats(tree):
    """Every leaf of a metrics tree (tensors, numbers) as a Python float."""
    if isinstance(tree, dict):
        return {k: _floats(v) for k, v in tree.items()}
    return float(tree)


def _anneal_schedule(cfg, n_anneal: int) -> np.ndarray:
    """The emission temperature per iteration: beta0 -> 1 over the first
    ``n_anneal`` iterations, then 1 (float32, as the models round it)."""
    beta0 = float(cfg.model.get("anneal_beta0", 0.25))
    total = cfg.train.num_iterations
    return np.concatenate(
        [np.linspace(beta0, 1.0, max(n_anneal, 1)), np.ones(max(total - n_anneal, 0))]
    )[:total].astype(np.float32)


def _checkpoint_due(cfg, it: int) -> bool:
    return (it + 1) % cfg.train.checkpoint_every == 0 or it == cfg.train.num_iterations - 1


def _writer(cfg, workdir: Path) -> MetricsWriter:
    return MetricsWriter(
        workdir / "train_metrics.jsonl",
        tensorboard_dir=(workdir / "tb") if cfg.train.get("tensorboard", False) else None,
    )


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def _train_minibatch_streaming_cmd(cfg, args, workdir: Path, batch_size: int, dev) -> None:
    """Out-of-core minibatch SGD (attention / grounding / hmm_crf): shards
    stream to the device with prefetch; minibatch steps sample within the
    resident shard (models/minibatch.train_minibatch_streaming).  With
    train.distributed every rank streams its own shards and samples its
    own rows (parallel/multihost.train_minibatch_streaming_multihost)."""
    from multimodalworddiscovery_tpu_torch.data.stream import ShardedCorpusReader
    from multimodalworddiscovery_tpu_torch.models.minibatch import train_minibatch_streaming

    if cfg.model.get("guide", ""):
        raise SystemExit(
            "model.guide + data.source=stream would train the teacher on "
            "shard 0 only (silently degraded guidance); train the teacher "
            "with streamed EM first, then guide on a resident corpus "
            "(data.source=disk)"
        )
    distributed = bool(cfg.train.get("distributed", False))
    is_coord = multihost.is_coordinator()
    reader = ShardedCorpusReader(cfg.data.dir, device=dev)
    mesh = _mesh(cfg)
    shard0 = reader.load_shard(0)
    mod, params, step = _make_model(cfg, shard0)

    ckpt = CheckpointManager(workdir / "ckpt")
    writer = _writer(cfg, workdir)
    start = 0
    if ckpt.latest_step() is not None and not args.fresh:
        params, start = ckpt.restore(params)
        start += 1
        if is_coord:
            print(f"resumed from step {start}")

    def on_step(it, p, loss):
        if is_coord:
            writer.write(it, loglik=loss, batch_size=batch_size)
            if it % 20 == 0 or it == cfg.train.num_iterations - 1:
                print(f"step {it:5d}  loglik {loss:.3f}")
        if _checkpoint_due(cfg, it):
            ckpt.save(it, p)  # every rank: rank 0 writes, the others wait

    t0 = time.perf_counter()
    common = dict(seed=cfg.seed, prefetch=int(cfg.train.get("stream_prefetch", 1)),
                  start_step=start, on_step=on_step)
    if distributed:
        params, losses = multihost.train_minibatch_streaming_multihost(
            step, params, reader, batch_size, cfg.train.num_iterations - start,
            mesh=mesh, **common)
    else:
        params, losses = train_minibatch_streaming(
            step, params, reader, batch_size, cfg.train.num_iterations - start,
            mesh=mesh, **common)
    ckpt.close()
    writer.close()
    if is_coord:
        print(
            f"streamed {len(losses)} minibatch steps (B={batch_size}, "
            f"{reader.num_shards} shards x {reader.shard_size}"
            + (f", {mesh.size()}-rank mesh" if mesh is not None else "")
            + f") in {time.perf_counter() - t0:.2f}s"
        )


def _train_streaming_cmd(cfg, args, workdir: Path, dev) -> None:
    """Out-of-core EM: the corpus never materializes; fixed-shape shards
    stream from disk (data/stream.py) with I/O prefetch, counts accumulate
    on the device, one M-step per iteration.  Exact (counts are additive)."""
    from multimodalworddiscovery_tpu_torch.core.collectives import all_sum, group_of
    from multimodalworddiscovery_tpu_torch.data.stream import (
        ShardedCorpusReader,
        train_streaming,
        tree_sum_bounded,
    )

    # gate BEFORE the gradient-model dispatch: silently ignoring the flag
    # at train time would leave a workdir whose own decode/eval commands
    # (which do apply it) all fail
    _vq_frontend_gate(cfg)
    batch_size = int(cfg.train.get("batch_size", 0))
    if cfg.model.name in GRAD_MODELS:
        if not batch_size:
            raise SystemExit(
                "gradient models with data.source=stream need "
                "train.batch_size (minibatch steps sample within each "
                "streamed shard)"
            )
        _train_minibatch_streaming_cmd(cfg, args, workdir, batch_size, dev)
        return
    if cfg.model.name not in EM_MODELS:
        raise SystemExit(
            "data.source=stream trains the EM aligners "
            "(model1/hmm/hmm_gaussian/hmm_dnn) and the gradient models "
            "(attention/grounding/hmm_crf, with train.batch_size)"
        )
    if cfg.model.name == "hmm_dnn" and (
        cfg.train.get("distributed", False) or cfg.train.data_parallel
    ):
        raise SystemExit(
            "streamed hmm_dnn runs single-device: its incremental neural "
            "M-step CHAINS optimizer state through the shards (each shard's "
            "gradient step uses the previous shard's weights), which has no "
            "data-parallel decomposition the way additive counts do.  Use "
            "train.bucket_edges or train.corpus_chunks for a data-parallel "
            "hmm_dnn, or stream without the mesh"
        )
    if (
        str(cfg.train.get("bucket_edges", "")).strip()
        or batch_size
        or int(cfg.train.get("corpus_chunks", 1)) > 1
    ):
        raise SystemExit(
            "data.source=stream already bounds memory by shard_size; it does "
            "not compose with bucket_edges/batch_size/corpus_chunks "
            "for the EM aligners"
        )
    n_anneal = int(cfg.model.get("anneal_iters", 0) or 0)
    if n_anneal and cfg.model.name != "hmm_gaussian":
        raise SystemExit(
            "model.anneal_iters (deterministic annealing) requires "
            "model.name=hmm_gaussian"
        )
    distributed = bool(cfg.train.get("distributed", False))
    is_coord = multihost.is_coordinator()
    mesh = _mesh(cfg)
    prefetch = int(cfg.train.get("stream_prefetch", 1))

    reader = ShardedCorpusReader(cfg.data.dir, device=dev)
    reader = _apply_vq_frontend_streaming(cfg, reader, workdir, distributed, fresh=args.fresh)
    shard0 = reader.load_shard(0)
    # streamed vq_teacher seeding happens below over ALL shards: resident
    # seeding on shard 0 here would be both wasted work and wrong
    stream_vq_seed = (
        cfg.model.name == "hmm_gaussian"
        and str(cfg.model.get("init", "global")) == "vq_teacher"
    )
    mod, params, _ = _make_model(cfg, shard0, init_only=stream_vq_seed)
    use_kernels = None if cfg.model.name == "model1" else _resolve_use_pallas(cfg, shard0)

    ckpt = CheckpointManager(workdir / "ckpt")
    will_resume = ckpt.latest_step() is not None and not args.fresh

    if stream_vq_seed and not will_resume:
        from multimodalworddiscovery_tpu_torch.models import hmm_gaussian

        seed_kwargs = dict(
            max_jump=cfg.model.max_jump,
            n_components=cfg.model.get("n_components", 2),
            generator=_generator(cfg.seed),
            n_codes=cfg.model.get("vq_codes", 64),
            teacher_iters=cfg.model.get("teacher_iters", 10),
            seed_rounds=cfg.model.get("seed_rounds", 3),
            use_kernels=use_kernels,
            prefetch=prefetch,
        )
        if distributed:
            # every stage split over the ranks (the workdir must be a SHARED
            # filesystem: each rank writes its own code shards into it)
            params = multihost.init_vq_teacher_streaming_multihost(
                reader, workdir / "vq_codes", mesh=mesh, **seed_kwargs
            )
        else:
            params = hmm_gaussian.init_vq_teacher_streaming(
                reader, workdir / "vq_codes", **seed_kwargs
            )
        if is_coord:
            print(
                "hmm_gaussian seeded from the streamed VQ-teacher recipe"
                + (" (distributed)" if distributed else "")
                + f" (code shards in {workdir / 'vq_codes'})"
            )

    if (
        not will_resume  # the restore below would discard the seed anyway
        and cfg.model.name == "hmm_gaussian"
        and str(cfg.model.get("init", "global")) in ("global", "diagonal")
    ):
        # re-seed from WHOLE-corpus moments (additive across shards) rather
        # than shard 0's: exact parity with the resident init.  Squared
        # sums are taken about shard 0's mean (the same shift on every
        # shard and rank) for variance stability.
        from multimodalworddiscovery_tpu_torch.models import hmm_gaussian

        shift = hmm_gaussian.feature_shift(shard0)
        # init=global never reads the diagonal evidence: skip its [N,Ts,E]
        # one-hot contraction per shard
        with_diag = str(cfg.model.get("init", "global")) == "diagonal"

        def moments_of(shards):
            return tree_sum_bounded(hmm_gaussian.init_moments(s, shift, with_diagonal=with_diag)
                                    for s in shards)

        if distributed:
            # each rank scans only ITS shards; one all_reduce sums them
            rank, world = dist.get_rank(), dist.get_world_size()
            mine = list(range(rank, reader.num_shards, world))
            local = (moments_of(reader.shards(prefetch, mine)) if mine else
                     {k: torch.zeros_like(v) for k, v in hmm_gaussian.init_moments(
                         shard0, shift, with_diagonal=with_diag).items()})
            moments = all_sum(local, group_of(mesh))
        else:
            moments = moments_of(reader.shards(prefetch))
        params = hmm_gaussian.init_from_moments(
            moments, max_jump=cfg.model.max_jump,
            n_components=cfg.model.get("n_components", 2),
            generator=_generator(cfg.seed),
            mode=str(cfg.model.get("init", "global")), shift=shift,
        )
        if is_coord:
            print("hmm_gaussian seeded from streamed whole-corpus moments")

    if cfg.model.name == "model1":
        ckw: dict = {}
        mkw: dict = {"smoothing": cfg.model.smoothing}
    else:
        ckw = {"use_kernels": use_kernels, "dot_dtype": cfg.model.get("dot_dtype", "float32")}
        mkw = {"smoothing": cfg.model.smoothing} if cfg.model.name == "hmm" else {}

    writer = _writer(cfg, workdir)
    start = 0
    if will_resume:
        params, start = ckpt.restore(params)
        start += 1
        if is_coord:
            print(f"resumed from iteration {start}")

    scale_schedule = None
    if n_anneal:
        # sliced at `start` so a resumed run continues the exact schedule
        scale_schedule = _anneal_schedule(cfg, n_anneal)[start:]
        if is_coord:
            print(
                f"deterministic annealing: emission temperature "
                f"{float(cfg.model.get('anneal_beta0', 0.25)):g} -> 1 over {n_anneal} "
                "iterations (streamed)"
            )

    def on_iteration(i, p, ll):
        it = start + i
        if is_coord:
            writer.write(it, loglik=ll)
            print(f"iter {it:4d}  loglik {ll:.2f}")
        if _checkpoint_due(cfg, it):
            ckpt.save(it, p)  # every rank: rank 0 writes, the others wait

    t0 = time.perf_counter()
    iters = cfg.train.num_iterations - start
    if distributed:
        # every rank streams ITS OWN shards, one all_reduce an iteration
        params, lls = multihost.train_streaming_multihost(
            mod, params, reader, iters, mesh=mesh, count_kwargs=ckw, m_step_kwargs=mkw,
            prefetch=prefetch, on_iteration=on_iteration, scale_schedule=scale_schedule,
        )
    elif cfg.model.name == "hmm_dnn":
        # incremental generalized EM: per-shard neural updates, exact pooled
        # prior/transition counts (models/hmm_dnn.train_streaming)
        params, lls = mod.train_streaming(
            params, reader, iters, use_kernels=ckw["use_kernels"], dot_dtype=ckw["dot_dtype"],
            prefetch=prefetch, on_iteration=on_iteration,
        )
    else:
        params, lls = train_streaming(
            mod, params, reader, iters, count_kwargs=ckw, m_step_kwargs=mkw, mesh=mesh,
            prefetch=prefetch, on_iteration=on_iteration, scale_schedule=scale_schedule,
        )
    ckpt.close()
    writer.close()
    if is_coord:
        print(
            f"streamed EM over {reader.num_shards} shards x {reader.shard_size} "
            f"utterances ({reader.n} total"
            + (f", {mesh.size()}-rank mesh" if mesh is not None else "")
            + f") in {time.perf_counter() - t0:.2f}s"
        )


def _chunked_em_step(mod, chunks: int, smoothing: float, use_kernels):
    """``step(params, corpus, mesh=None, **estep_kwargs)``: the E-step over
    ``chunks`` corpus chunks (``models/bucketed.chunked_expected_counts``),
    the counts summed over the mesh's ranks (one all_reduce), one M-step."""
    from multimodalworddiscovery_tpu_torch.core.collectives import all_sum, group_of
    from multimodalworddiscovery_tpu_torch.models.bucketed import chunked_expected_counts

    def step(p, c, mesh=None, **kw):
        counts, ll = chunked_expected_counts(mod, p, c, chunks, use_kernels=use_kernels, **kw)
        counts, ll = all_sum((counts, ll), group_of(mesh))
        return mod.m_step(p, counts, smoothing), {"loglik": ll}

    return step


def _train(cfg, args, dev) -> None:
    from multimodalworddiscovery_tpu_torch.parallel.data_parallel import (
        make_data_parallel_step,
        shard_corpus,
    )

    distributed = bool(cfg.train.get("distributed", False))
    is_coord = multihost.is_coordinator()
    workdir = Path(args.workdir)
    if is_coord:
        workdir.mkdir(parents=True, exist_ok=True)
    if args.fresh and is_coord:
        # drop old checkpoints ENTIRELY: merely skipping the restore leaves
        # stale higher-step checkpoints behind, and a fresh run with fewer
        # iterations would then lose latest_step() to them at decode time
        shutil.rmtree(workdir / "ckpt", ignore_errors=True)
    if is_coord:
        _save_config(cfg, workdir)
    if dist.is_initialized():
        dist.barrier()

    if cfg.data.source == "stream":
        _train_streaming_cmd(cfg, args, workdir, dev)
        return

    corpus, _ = _load_data(cfg, dev)
    corpus = _apply_vq_frontend(cfg, corpus, workdir, distributed, fresh=args.fresh)
    mod, params, step = _make_model(cfg, corpus)

    edges = [int(e) for e in str(cfg.train.get("bucket_edges", "")).split(",") if e.strip()]
    batch_size = int(cfg.train.get("batch_size", 0))
    if edges and cfg.model.name not in EM_MODELS:
        raise SystemExit(
            f"train.bucket_edges requires an EM aligner {EM_MODELS}; "
            f"{cfg.model.name!r} is gradient-trained — use train.batch_size"
        )
    if batch_size and cfg.model.name not in GRAD_MODELS:
        raise SystemExit(
            f"train.batch_size requires a gradient model {GRAD_MODELS}; "
            f"EM aligners use train.bucket_edges for ragged corpora"
        )
    n_anneal = int(cfg.model.get("anneal_iters", 0) or 0)
    if n_anneal and cfg.model.name != "hmm_gaussian":
        raise SystemExit(
            "model.anneal_iters (deterministic annealing) requires "
            "model.name=hmm_gaussian"
        )
    if n_anneal and edges:
        raise SystemExit(
            "model.anneal_iters does not compose with train.bucket_edges; "
            "use train.corpus_chunks for memory instead"
        )
    if distributed and edges and cfg.model.name == "hmm_dnn":
        raise SystemExit(
            "train.distributed + train.bucket_edges supports the closed-form "
            "EM aligners only: hmm_dnn's neural M-step consumes per-bucket "
            "POSTERIORS (sharded activations — pooling them would ship "
            "O(corpus) across hosts every iteration: 1.06 GB/iter at the "
            "Flickr8k bench shape, 13.4 GB/iter at MSCOCO scale, vs <= 1.4 MB "
            "for the supported paths; docs/PERFORMANCE.md 'Rejected "
            "compositions').  Use single-host bucketed EM or the chunked "
            "path for hmm_dnn"
        )

    ckpt = CheckpointManager(workdir / "ckpt")
    writer = _writer(cfg, workdir)
    mesh = _mesh(cfg)

    if edges:
        # --- exact length-bucketed EM (optionally over a mesh of ranks) ---
        from multimodalworddiscovery_tpu_torch.models.bucketed import train_bucketed

        smoothing = cfg.model.smoothing if cfg.model.name in ("model1", "hmm") else 1e-6
        use_kernels = None if cfg.model.name == "model1" else _resolve_use_pallas(cfg, corpus)
        t0 = time.perf_counter()

        def on_iteration(it, p, ll):
            if is_coord:
                writer.write(it, loglik=ll)
                print(f"iter {it:4d}  loglik {ll:.2f}")
            if _checkpoint_due(cfg, it):
                ckpt.save(it, p)

        if distributed:
            lo, hi = multihost.process_slice(corpus.n)
            params, _ = multihost.train_bucketed_multihost(
                mod, params, take_rows(corpus, lo, hi), edges, cfg.train.num_iterations,
                smoothing=smoothing, mesh=mesh, use_kernels=use_kernels,
                on_iteration=on_iteration,
            )
        else:
            params, _ = train_bucketed(
                mod, params, corpus, edges, cfg.train.num_iterations,
                smoothing=smoothing, mesh=mesh, use_kernels=use_kernels,
                on_iteration=on_iteration,
            )
        ckpt.close()
        writer.close()
        if is_coord:
            print(
                f"bucketed EM ({len(edges) + 1} buckets"
                + (f", {mesh.size()}-rank mesh" if mesh is not None else "")
                + f") in {time.perf_counter() - t0:.2f}s"
            )
        return

    chunks = int(cfg.train.get("corpus_chunks", 1))
    if chunks > 1:
        if cfg.model.name not in ("model1", "hmm", "hmm_gaussian"):
            raise SystemExit(
                "train.corpus_chunks requires a closed-form EM aligner "
                "(model1/hmm/hmm_gaussian); hmm_dnn's neural M-step needs "
                "the per-chunk posteriors — use train.bucket_edges instead"
            )
        # exact chunked E-step: activation memory / chunks
        step = _chunked_em_step(
            mod, chunks, cfg.model.smoothing if cfg.model.name in ("model1", "hmm") else 1e-6,
            None if cfg.model.name == "model1" else _resolve_use_pallas(cfg, corpus))
        print(f"E-step scans {chunks} corpus chunks per iteration")

    anneal_sched = None
    if n_anneal:
        # deterministic annealing: emission temperature beta0 -> 1 over the
        # first anneal_iters EM iterations, then exact EM; resume indexes
        # the same schedule
        anneal_sched = _anneal_schedule(cfg, n_anneal)
        print(
            f"deterministic annealing: emission temperature "
            f"{float(cfg.model.get('anneal_beta0', 0.25)):g} -> 1 over {n_anneal} iterations"
        )

    if distributed or mesh is not None:
        # this rank's rows: a contiguous slice of the corpus (a from-disk
        # loader would read just the slice), padded to the ranks' largest
        if distributed:
            lo, hi = multihost.process_slice(corpus.n)
            corpus = multihost.global_corpus_from_local(take_rows(corpus, lo, hi), mesh)
        else:
            corpus = shard_corpus(corpus, mesh)

    if batch_size:
        # --- minibatch SGD for the gradient models (device-resident corpus,
        # per-step on-device gather; guide computed per batch inside step) ---
        from multimodalworddiscovery_tpu_torch.models.minibatch import (
            make_minibatch_step,
            step_generator,
        )

        # under train.distributed each rank draws its share of the batch
        # from its own rows with its own generator (no rows cross ranks)
        rank = dist.get_rank() if distributed else None
        mb_step = make_minibatch_step(step, corpus, batch_size, mesh=mesh,
                                      sample="local" if distributed else "global")
        start = 0
        if ckpt.latest_step() is not None and not args.fresh:
            params, start = ckpt.restore(params)
            start += 1
            if is_coord:
                print(f"resumed from step {start}")
        if mesh is not None:
            params = multihost.replicate_to_global(params, mesh)
        t_total = 0.0
        for it in range(start, cfg.train.num_iterations):
            t0 = time.perf_counter()
            # step it's draws depend on (seed, it) alone: a resumed run
            # draws what the uninterrupted run drew
            params, stats = mb_step(params, step_generator(cfg.seed, it, rank))
            ll = float(stats["loglik"])
            _sync(dev)
            dt = time.perf_counter() - t0
            t_total += dt
            if is_coord:
                writer.write(it, loglik=ll, seconds=dt, batch_size=batch_size)
                if it % 20 == 0 or it == cfg.train.num_iterations - 1:
                    print(f"step {it:5d}  loglik {ll:.2f}  ({dt * 1e3:.1f} ms)")
            if _checkpoint_due(cfg, it):
                ckpt.save(it, params)
        ckpt.close()
        writer.close()
        if is_coord:
            print(
                f"trained {cfg.train.num_iterations - start} minibatch steps "
                f"(B={batch_size}"
                + (f", {mesh.size()}-rank mesh" if mesh is not None else "")
                + f") in {t_total:.2f}s"
            )
        return

    start = 0
    if ckpt.latest_step() is not None and not args.fresh:
        params, start = ckpt.restore(params)
        start += 1
        if is_coord:
            print(f"resumed from iteration {start}")
    if mesh is not None:
        # identical parameters on every rank (the same init, or the same
        # restored checkpoint): broadcast rank 0's
        params = multihost.replicate_to_global(params, mesh)

    t_total = 0.0
    for it in range(start, cfg.train.num_iterations):
        t0 = time.perf_counter()
        fn = step
        if anneal_sched is not None:
            fn = functools.partial(step, emit_scale=float(anneal_sched[it]))
        if mesh is not None:
            # the closed-form em_step as its shard-map form (one all_reduce
            # of the counts), a gradient step with its gradient all-reduce
            fn = make_data_parallel_step(fn, mesh)
        params, stats = fn(params, corpus)
        ll = float(stats["loglik"])
        _sync(dev)
        dt = time.perf_counter() - t0
        t_total += dt
        if is_coord:
            writer.write(it, loglik=ll, seconds=dt)
            print(f"iter {it:4d}  loglik {ll:.2f}  ({dt * 1e3:.1f} ms)")
        if _checkpoint_due(cfg, it):
            ckpt.save(it, params)  # every rank: rank 0 writes, the others wait
    ckpt.close()
    writer.close()
    if is_coord:
        print(f"trained {cfg.train.num_iterations - start} iterations in {t_total:.2f}s")


def cmd_train(args) -> None:
    cfg = load_config(args.config) if args.config else base_config()
    apply_overrides(cfg, args.override)
    dev = _device(args)
    if cfg.train.get("distributed", False) and not cfg.train.data_parallel:
        raise SystemExit("train.distributed requires train.data_parallel=true")
    with _process_group(cfg, dev):
        if cfg.train.get("profile", False):
            # trace the WHOLE training run (corpus build, kernel launches,
            # steps) as a torch.profiler Chrome trace
            from multimodalworddiscovery_tpu_torch.utils.profiling import trace

            prof_dir = Path(args.workdir) / "profile"
            with trace(prof_dir) if multihost.is_coordinator() else contextlib.nullcontext():
                _train(cfg, args, dev)
            if multihost.is_coordinator():
                print(f"wrote device trace to {prof_dir}")
        else:
            _train(cfg, args, dev)


# ---------------------------------------------------------------------------
# shard, restore, vq frontend
# ---------------------------------------------------------------------------


def cmd_shard(args) -> None:
    """Split a corpus (synthetic or disk) into fixed-shape shards for
    streaming EM (data/stream.py)."""
    from multimodalworddiscovery_tpu_torch.data.stream import write_shards

    cfg = load_config(args.config) if args.config else base_config()
    apply_overrides(cfg, args.override)
    if cfg.data.source == "stream":
        raise SystemExit("source corpus must be synthetic or disk, not stream")
    corpus, gold = _load_data(cfg, _device(args))
    if args.storage_dtype == "float16" and not corpus.src.is_floating_point() \
            and not corpus.trg.is_floating_point():
        raise SystemExit(
            "--storage-dtype float16 only compresses FLOAT fields; this "
            "corpus is fully discrete (int tokens) — drop the flag"
        )
    n = write_shards(
        corpus, args.output, args.shard_size, gold=gold, shuffle=args.shuffle,
        storage_dtype=args.storage_dtype,
    )
    note = f", shuffled (seed {args.shuffle})" if args.shuffle is not None else ""
    if args.storage_dtype:
        note += f", float fields stored {args.storage_dtype}"
    print(
        f"wrote {n} shards x {args.shard_size} utterances "
        f"({corpus.n} total{note}) to {args.output}"
    )


def _restore(workdir: Path, dev, overrides: list[str] | None = None, cfg=None):
    if cfg is None:
        cfg = _load_workdir_config(workdir)
        if overrides:
            # eval-time knobs (retrieval_pool, dtw sampling, null_threshold, ...)
            apply_overrides(cfg, overrides)
    elif overrides:
        raise ValueError(
            "pass EITHER a pre-built cfg (with overrides already applied) "
            "OR overrides, not both — overrides are ignored when cfg is given"
        )
    corpus, gold = _load_data(cfg, dev)
    corpus = _apply_vq_frontend(cfg, corpus, workdir, fit_allowed=False)
    mod, params, _ = _make_model(cfg, corpus, init_only=True)
    ckpt = CheckpointManager(workdir / "ckpt")
    params, _ = ckpt.restore(params)
    ckpt.close()
    return cfg, corpus, gold, mod, params


def _vq_frontend_gate(cfg) -> bool:
    """True iff model.vq_frontend is on; raises for non-discrete aligners
    (the ONE model gate: three call sites must never drift)."""
    if not bool(cfg.model.get("vq_frontend", False)):
        return False
    if cfg.model.name not in ("model1", "hmm"):
        raise SystemExit(
            "model.vq_frontend quantizes inputs for the discrete aligners "
            f"(model1/hmm); {cfg.model.name!r} consumes frames directly"
        )
    return True


def _apply_vq_frontend(cfg, corpus, workdir: Path, distributed: bool = False,
                       fit_allowed: bool = True, fresh: bool = False):
    """model.vq_frontend: k-means-quantize continuous frames for the
    DISCRETE aligners.  The codebook is a workdir artifact: fit once at
    train time, reloaded afterwards so every process and restart quantizes
    with the SAME centroids.  Without the flag, a continuous corpus into a
    discrete aligner errors loudly (the models also refuse at init)."""
    if not _vq_frontend_gate(cfg):
        if cfg.model.name in ("model1", "hmm") and corpus.src.ndim == 3:
            raise SystemExit(
                f"model.name={cfg.model.name} has discrete emissions but the "
                "corpus is continuous frames; set model.vq_frontend=true to "
                "k-means-quantize them (model.vq_codes ids), or use "
                "hmm_gaussian / hmm_dnn"
            )
        return corpus
    if corpus.src.ndim != 3:
        raise SystemExit(
            "model.vq_frontend needs continuous [N,Ts,D] frames; this "
            "corpus is already discrete"
        )
    from multimodalworddiscovery_tpu_torch.frontend import vq

    want_codes = int(cfg.model.get("vq_codes", 64))
    path = workdir / "vq_codebook.npy"
    refit = fresh and fit_allowed
    if path.exists() and not refit:
        cb = vq.load_codebook(path, device=corpus.device)
        if int(cb.shape[0]) != want_codes or int(cb.shape[1]) != int(corpus.src.shape[-1]):
            # a silently reused stale codebook would quantize into a
            # different code space than the config says
            raise SystemExit(
                f"workdir codebook is {int(cb.shape[0])}x{int(cb.shape[1])} "
                f"but the config wants {want_codes} codes over "
                f"{int(corpus.src.shape[-1])}-d frames: retrain with "
                "--fresh or use a new workdir"
            )
    elif not fit_allowed:
        # decode/eval must quantize with the TRAINING codebook
        raise SystemExit(
            f"vq_frontend codebook missing ({path}): this workdir was not "
            "trained with model.vq_frontend, or the artifact was deleted"
        )
    else:
        cb = vq.fit_codebook(corpus, n_codes=want_codes, generator=_generator(cfg.seed))
        # deterministic fit: every rank computes the same codebook; only
        # the coordinator writes the artifact (an atomic save)
        if multihost.is_coordinator():
            vq.save_codebook(path, cb)
            print(
                f"vq_frontend: frames quantized into {cb.shape[0]} codes "
                f"(codebook -> {path})"
            )
        if distributed:
            dist.barrier()
    return vq.quantize(corpus, cb)


def _apply_vq_frontend_streaming(cfg, reader, workdir: Path, distributed: bool,
                                 fit_allowed: bool = True, fresh: bool = False):
    """Streamed vq_frontend: quantize every shard ONCE into a parallel
    discrete shard dir in the workdir (codebook from a cross-shard
    reservoir), then stream the code shards.  Later commands (and
    distributed resumes) reuse the artifacts read-only."""
    if not _vq_frontend_gate(cfg):
        return reader
    src0 = np.load(reader.directory / "src_0.npy", mmap_mode="r")
    if src0.ndim != 3:
        raise SystemExit(
            "model.vq_frontend needs continuous [N,Ts,D] frame shards; "
            "this shard dir is already discrete"
        )
    from multimodalworddiscovery_tpu_torch.data.stream import ShardedCorpusReader
    from multimodalworddiscovery_tpu_torch.frontend import vq
    from multimodalworddiscovery_tpu_torch.models.hmm_gaussian import quantize_shards_streaming

    code_dir = workdir / "vq_frontend_codes"
    path = workdir / "vq_codebook.npy"
    want_codes = int(cfg.model.get("vq_codes", 64))
    have = path.exists() and (code_dir / "manifest.json").exists()
    if fresh and fit_allowed:
        have = False  # --fresh: refit (the checkpoint is ignored too)
    elif have:
        # staleness checks: streaming an OLD corpus's code shards (or an old
        # code space) would train on the wrong data, and a silent REFIT
        # would be worse (a checkpoint's emission table is indexed by the
        # old code ids), so mismatches always raise
        creader = ShardedCorpusReader(code_dir, device=reader.device)
        same_corpus = (
            (creader.n, creader.num_shards, creader.shard_size)
            == (reader.n, reader.num_shards, reader.shard_size)
        )
        if not (same_corpus and creader.src_vocab == want_codes):
            raise SystemExit(
                f"vq_frontend artifacts in {code_dir} were built for a "
                f"different corpus/codebook (codes {creader.src_vocab} "
                f"vs {want_codes}, shards {creader.num_shards}x"
                f"{creader.shard_size}/{creader.n} vs {reader.num_shards}"
                f"x{reader.shard_size}/{reader.n}): retrain single-host "
                "with --fresh or use a new workdir"
            )
    if not have:
        if not fit_allowed:
            raise SystemExit(
                f"vq_frontend artifacts missing ({path} / {code_dir}): this "
                "workdir was not trained with model.vq_frontend, or they "
                "were deleted"
            )
        if distributed:
            # partitioned writes into the SHARED workdir: codebook from the
            # ranks' merged reservoir (the same on every rank), rank p
            # quantizes and writes its own shards, rank 0 the manifest and
            # codebook, one barrier orders the writes before any read
            pid, n_proc = dist.get_rank(), dist.get_world_size()
            frames = multihost.reservoir_frames_multihost(reader)
            cb = vq.fit_codebook_streaming(reader, n_codes=want_codes,
                                           generator=_generator(cfg.seed), frames=frames)
            if pid == 0:
                vq.save_codebook(path, cb)
            quantize_shards_streaming(
                reader, code_dir, codebook=cb,
                shard_ids=range(pid, reader.num_shards, n_proc),
                write_manifest=(pid == 0),
            )
            dist.barrier()
        else:
            cb = vq.fit_codebook_streaming(reader, n_codes=want_codes,
                                           generator=_generator(cfg.seed))
            vq.save_codebook(path, cb)
            quantize_shards_streaming(reader, code_dir, codebook=cb)
        if multihost.is_coordinator():
            print(
                f"vq_frontend: {reader.num_shards} shards quantized into "
                f"{int(cb.shape[0])} codes ({code_dir})"
            )
    return ShardedCorpusReader(code_dir, device=reader.device)


def _restore_streaming(cfg, workdir: Path, dev):
    """(reader, shard0, mod, params) for a streamed workdir: the parameter
    TEMPLATE comes from shard 0 (every shard shares shapes and vocabularies,
    manifest constants), then the checkpoint restore overwrites it."""
    from multimodalworddiscovery_tpu_torch.data.stream import ShardedCorpusReader

    reader = ShardedCorpusReader(cfg.data.dir, device=dev)
    reader = _apply_vq_frontend_streaming(
        cfg, reader, workdir, distributed=False, fit_allowed=False
    )
    shard0 = reader.load_shard(0)
    mod, params, _ = _make_model(cfg, shard0, init_only=True)
    ckpt = CheckpointManager(workdir / "ckpt")
    params, _ = ckpt.restore(params)
    ckpt.close()
    return reader, shard0, mod, params


# ---------------------------------------------------------------------------
# align, segment, evaluate
# ---------------------------------------------------------------------------


def _decode_streaming(cfg, workdir: Path, args, with_segments: bool) -> None:
    """Out-of-core decode: align (and optionally segment) shard by shard,
    every shard at one padded shape; only the int32 alignment rows and
    segment triples reach the host."""
    reader, shard0, mod, params = _restore_streaming(cfg, workdir, _device(args))
    kw = _decode_kwargs(cfg, mod, shard0)
    alignment = np.zeros((reader.n, reader.max_src_len), dtype=np.int32)
    src_len = np.zeros((reader.n,), dtype=np.int32)
    segments: list[list[tuple[int, int, int]]] = []
    # prefetch overlaps the next shard's disk read and copy with this
    # shard's decode
    with torch.no_grad():
        for k, shard in enumerate(reader.shards(int(cfg.train.get("stream_prefetch", 1)))):
            a = mod.align(params, shard, **kw)
            lo = k * reader.shard_size
            hi = min(lo + reader.shard_size, reader.n)
            alignment[lo:hi] = a.cpu().numpy()[: hi - lo]
            src_len[lo:hi] = shard.src_len.cpu().numpy()[: hi - lo]
            if with_segments:
                segs, mask = segments_from_alignment(a, shard.trg, shard.src_len)
                segments.extend(segments_to_host(segs, mask)[: hi - lo])
    name = "segments.json" if with_segments else "alignment.json"
    out = Path(args.output or workdir / name)
    save_alignment_json(alignment, src_len, out, segments=segments if with_segments else None)
    print(f"wrote {out} (streamed {reader.num_shards} shards)")


def _workdir_cfg(args):
    _device(args)  # refuse a missing card before reading anything
    workdir = Path(args.workdir)
    cfg = _load_workdir_config(workdir)
    if getattr(args, "override", None):
        apply_overrides(cfg, args.override)
    return workdir, cfg


def cmd_align(args) -> None:
    workdir, cfg = _workdir_cfg(args)
    if cfg.data.source == "stream":
        _decode_streaming(cfg, workdir, args, with_segments=False)
        return
    cfg, corpus, _, mod, params = _restore(workdir, _device(args), cfg=cfg)
    alignment = _align_call(cfg, mod, params, corpus).cpu().numpy()
    out = Path(args.output or workdir / "alignment.json")
    save_alignment_json(alignment, corpus.src_len.cpu().numpy(), out)
    print(f"wrote {out}")


def cmd_segment(args) -> None:
    workdir, cfg = _workdir_cfg(args)
    if cfg.data.source == "stream":
        _decode_streaming(cfg, workdir, args, with_segments=True)
        return
    cfg, corpus, _, mod, params = _restore(workdir, _device(args), cfg=cfg)
    alignment = _align_call(cfg, mod, params, corpus)
    segs, mask = segments_from_alignment(alignment, corpus.trg, corpus.src_len)
    out = Path(args.output or workdir / "segments.json")
    save_alignment_json(alignment.cpu().numpy(), corpus.src_len.cpu().numpy(), out,
                        segments=segments_to_host(segs, mask))
    print(f"wrote {out}")


def _pooled_scores(cfg, mod, params, corpus, cand, direction: str):
    """[Nq, C] pooled pair scores for the configured model: the one scoring
    dispatch shared by resident pooled retrieval and the streamed
    within-shard protocol."""
    from multimodalworddiscovery_tpu_torch.eval.retrieval import (
        retrieval_scores_hmm_family_pooled,
        retrieval_scores_model1_pooled,
    )

    name = cfg.model.name
    if name == "model1":
        return retrieval_scores_model1_pooled(params, corpus, cand, direction=direction)
    if name in HMM_FAMILY:
        return retrieval_scores_hmm_family_pooled(mod, params, corpus, cand, direction=direction)
    return mod.retrieval_scores_pooled(params, corpus, cand, direction=direction)


def _retrieval_metrics(cfg, mod, params, corpus) -> dict:
    """recall@k: dense N x N by default, or over candidate pools when
    eval.retrieval_pool > 0 (the scalable protocol)."""
    from multimodalworddiscovery_tpu_torch.eval.retrieval import (
        recall_at_k,
        recall_at_k_pooled,
        retrieval_scores_hmm_family,
        retrieval_scores_model1,
        sample_candidate_pools,
    )

    name = cfg.model.name
    pool = int(cfg.eval.get("retrieval_pool", 0))
    if pool:
        cand = sample_candidate_pools(corpus.n, min(pool, corpus.n), _generator(cfg.seed),
                                      device=corpus.device)
        out: dict = {}
        for direction in ("c2i", "i2c"):
            scores = _pooled_scores(cfg, mod, params, corpus, cand, direction)
            out.update(recall_at_k_pooled(scores, direction=direction))
        return out
    if name == "model1":
        scores = retrieval_scores_model1(params, corpus)
    elif name in HMM_FAMILY:
        scores = retrieval_scores_hmm_family(mod, params, corpus)
    else:
        scores = mod.retrieval_scores(params, corpus)
    return recall_at_k(scores)


def _check_stream_pool(pool_cfg: int, reader) -> None:
    """Loud upfront rejection when NO shard can fill the configured pool
    (the within-shard protocol draws a query's distractors from its own
    shard), and a loud warning when the shard directory was written
    WITHOUT a shuffle: an unshuffled shard's candidates are correlated with
    its queries on ordered corpora, which biases within-shard recall."""
    feasible = reader.shard_size if reader.num_shards > 1 else reader.n
    if pool_cfg > feasible:
        raise SystemExit(
            f"eval.retrieval_pool={pool_cfg} exceeds the within-shard "
            f"candidate supply ({feasible} rows per shard): lower the pool, "
            f"re-shard with a larger --shard-size, or materialize "
            f"(data.source=disk) for cross-corpus pools"
        )
    if reader.shuffle_seed is None and reader.num_shards > 1:
        print(
            "WARNING: streamed retrieval over an UNSHUFFLED multi-shard "
            f"corpus ({reader.directory}): each query ranks only against "
            "same-shard candidates, which are concept-correlated on ordered "
            "corpora — recall@k is biased. Re-shard with "
            "`mwd-torch shard --shuffle SEED` for unbiased within-shard pools."
        )


def _shard_pool(pool_cfg: int, nv: int, seed: int, k: int, device):
    """Candidate pools for shard k's ``nv`` valid rows: dense within-shard
    when pool_cfg == 0, sampled pools otherwise (drawn from (seed, k)
    alone); None when the (tail) shard is smaller than the pool.  Shared by
    streamed evaluate and streamed retrieve, so the two report identical
    retrieval numbers for the same workdir."""
    from multimodalworddiscovery_tpu_torch.eval.retrieval import (
        dense_candidate_pools,
        sample_candidate_pools,
    )
    from multimodalworddiscovery_tpu_torch.models.minibatch import step_generator

    if pool_cfg == 0:
        return dense_candidate_pools(nv, device=device)
    if nv >= pool_cfg:
        return sample_candidate_pools(nv, pool_cfg, step_generator(seed, k), device=device)
    return None


def _streamed_dtw(cfg, res: dict, ga: np.ndarray, device) -> dict:
    """Score a reservoir sample of utterances (``_evaluate_streaming``'s
    ``res`` buffers) with the SAME DTW metrics as the resident path, rows
    in global utterance order (a sample covering the whole corpus matches
    resident DTW on the same utterances)."""
    from multimodalworddiscovery_tpu_torch.eval.dtw import cluster_dtw_coherence, dtw_to_gold

    order = np.argsort(res["idx"])

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    feats = t(res["src"][order].astype(np.float32))
    src_len = t(res["src_len"][order])
    trg = t(res["trg"][order])
    pred_segs, pred_mask = segments_from_alignment(t(res["pred"][order]), trg, src_len)
    gold_segs, gold_mask = segments_from_alignment(t(ga[res["idx"][order]]), trg, src_len)
    max_len = int(cfg.eval.get("dtw_max_seg_len", 32))
    k_seg = min(pred_segs.shape[1], int(cfg.eval.get("dtw_segments", 8)))
    ps, pm = pred_segs[:, :k_seg], pred_mask[:, :k_seg]
    gs, gm = gold_segs[:, :k_seg], gold_mask[:, :k_seg]
    coh = cluster_dtw_coherence(feats, ps, pm, max_len)
    return dict(coh, to_gold=dtw_to_gold(feats, ps, pm, gs, gm, max_len))


def _evaluate_streaming(cfg, workdir: Path, args) -> None:
    """Out-of-core evaluation, EVERY metric family, no resident corpus:

    - alignment / word-IoU / boundary / purity / NMI decompose into additive
      per-utterance sufficient statistics (eval/metrics.py ``*_stats`` /
      ``*_from_stats``) summed over the shards;
    - retrieval runs the WITHIN-SHARD pooled protocol: each query is ranked
      against candidates from its own shard (the whole shard when
      eval.retrieval_pool=0, else sampled pools), and the per-query ranks
      concatenate across shards; on a single-shard corpus the dense variant
      equals resident dense recall exactly;
    - DTW coherence / to-gold scores a RESERVOIR sample of utterances drawn
      uniformly across all shards (numpy's generator of the seed: the
      reference's draw)."""
    from multimodalworddiscovery_tpu_torch.data.io import load_alignment_json
    from multimodalworddiscovery_tpu_torch.data.stream import tree_sum_bounded
    from multimodalworddiscovery_tpu_torch.eval.metrics import (
        alignment_from_stats,
        alignment_stats,
        boundary_from_stats,
        boundary_stats,
        nmi_from_counts,
        purity_counts,
        purity_from_counts,
        word_iou_from_stats,
        word_iou_stats,
    )
    from multimodalworddiscovery_tpu_torch.eval.retrieval import (
        ranks_from_pooled,
        recall_from_ranks,
    )

    dev = _device(args)
    reader, shard0, mod, params = _restore_streaming(cfg, workdir, dev)
    gold_path = reader.directory / "gold.json"
    if not gold_path.exists():
        raise SystemExit(f"no gold annotations ({gold_path}) in the shard dir")
    # gold alignments for the FULL corpus are [N, Ts] int32: tiny next to
    # the feature arrays, which never leave disk
    gold = load_alignment_json(gold_path, reader.n, reader.max_src_len)
    ga = np.zeros((reader.num_shards * reader.shard_size, reader.max_src_len), np.int32)
    ga[: reader.n] = gold.alignment

    kw = _decode_kwargs(cfg, mod, shard0)
    tol = int(cfg.eval.boundary_tolerance)
    thr = float(cfg.eval.iou_threshold)
    n_concepts = reader.trg_vocab

    def shard_stats(p, shard, gold_align):
        alignment = mod.align(p, shard, **kw)
        pred_segs, pred_mask = segments_from_alignment(alignment, shard.trg, shard.src_len)
        gold_segs, gold_mask = segments_from_alignment(gold_align, shard.trg, shard.src_len)
        pb = boundaries_from_segments(pred_segs, pred_mask, shard.max_src_len)
        gb = boundaries_from_segments(gold_segs, gold_mask, shard.max_src_len)
        return {
            "alignment": alignment_stats(alignment, gold_align, shard.src_mask()),
            "word_iou": word_iou_stats(pred_segs, pred_mask, gold_segs, gold_mask, thr),
            "boundary": boundary_stats(pb, gb, tol),
            "purity": purity_counts(pred_segs, pred_mask, gold_segs, gold_mask, n_concepts),
        }, alignment

    do_retrieval = bool(cfg.eval.retrieval) and cfg.model.name in _RETRIEVAL_MODELS
    do_dtw = bool(cfg.eval.get("dtw", True)) and shard0.src.ndim == 3
    pool_cfg = int(cfg.eval.get("retrieval_pool", 0))
    if do_retrieval:
        _check_stream_pool(pool_cfg, reader)
    ranks: dict[str, list[np.ndarray]] = {"c2i": [], "i2c": []}
    retrieval_skipped = 0

    # DTW reservoir (Algorithm R, seeded): uniform over the WHOLE corpus
    k_utt = min(reader.n, int(cfg.eval.get("dtw_utterances", 64)))
    seen = 0
    if do_dtw:
        rng = np.random.default_rng(cfg.seed)
        feat_dim = shard0.src.shape[-1]
        res = {
            "idx": np.zeros(k_utt, np.int64),
            "src": np.zeros((k_utt, reader.max_src_len, feat_dim), np.float32),
            "src_len": np.zeros(k_utt, np.int32),
            "trg": np.zeros((k_utt, reader.max_trg_len), np.int32),
            "trg_len": np.zeros(k_utt, np.int32),
            "pred": np.zeros((k_utt, reader.max_src_len), np.int32),
        }

    def per_shard():
        nonlocal retrieval_skipped, seen
        prefetch = int(cfg.train.get("stream_prefetch", 1))
        for k, shard in enumerate(reader.shards(prefetch)):
            lo = k * reader.shard_size
            nv = min(reader.shard_size, reader.n - lo)  # valid (non-pad) rows
            gold_k = torch.as_tensor(ga[lo: lo + reader.shard_size], device=dev)
            stats, alignment = shard_stats(params, shard, gold_k)

            if do_retrieval:
                sub = take_rows(shard, 0, nv)
                cand = _shard_pool(pool_cfg, nv, cfg.seed, k, dev)
                if cand is None:  # tail shard smaller than the pool
                    retrieval_skipped += nv
                else:
                    for direction in ("c2i", "i2c"):
                        scores = _pooled_scores(cfg, mod, params, sub, cand, direction)
                        ranks[direction].append(ranks_from_pooled(scores).cpu().numpy())

            if do_dtw:
                # row reads from the shard files: the features never go
                # from the card back to the host
                src_mm = np.load(reader.directory / f"src_{k}.npy", mmap_mode="r")
                slen_mm = np.load(reader.directory / f"src_len_{k}.npy", mmap_mode="r")
                trg_mm = np.load(reader.directory / f"trg_{k}.npy", mmap_mode="r")
                tlen_mm = np.load(reader.directory / f"trg_len_{k}.npy", mmap_mode="r")
                align_host = None
                for j in range(nv):
                    slot = seen if seen < k_utt else None
                    if slot is None:
                        r = int(rng.integers(0, seen + 1))
                        slot = r if r < k_utt else None
                    seen += 1
                    if slot is None:
                        continue
                    if align_host is None:
                        align_host = alignment.cpu().numpy()
                    res["idx"][slot] = lo + j
                    res["src"][slot] = src_mm[j]
                    res["src_len"][slot] = slen_mm[j]
                    res["trg"][slot] = trg_mm[j]
                    res["trg_len"][slot] = tlen_mm[j]
                    res["pred"][slot] = align_host[j]

            yield stats

    with torch.no_grad():
        acc = tree_sum_bounded(per_shard())
        results = {
            "alignment": alignment_from_stats(acc["alignment"]),
            "word_iou": word_iou_from_stats(acc["word_iou"]),
            "boundary": boundary_from_stats(acc["boundary"]),
            "purity": purity_from_counts(acc["purity"]),
            "nmi": nmi_from_counts(acc["purity"]),
        }
        if do_dtw:
            results["dtw"] = _streamed_dtw(cfg, res, ga, dev)
            if k_utt < reader.n:
                print(f"dtw: scored a {k_utt}/{reader.n}-utterance reservoir "
                      "sample (eval.dtw_utterances)")
    if do_retrieval and any(ranks.values()):
        pool_size = pool_cfg if pool_cfg else reader.shard_size
        for direction in ("c2i", "i2c"):
            r = torch.as_tensor(np.concatenate(ranks[direction]))
            results.setdefault("retrieval", {}).update(
                _floats(recall_from_ranks(r, pool_size, direction=direction)))
        proto = ("dense within-shard" if pool_cfg == 0
                 else f"within-shard pools (C={pool_cfg})")
        note = (f"; {retrieval_skipped} tail rows skipped (shard smaller than "
                "the pool)" if retrieval_skipped else "")
        print(f"retrieval: {proto} protocol over {reader.num_shards} shards{note}")

    results = _to_jsonable(_floats(results))
    out = Path(args.output or workdir / "metrics.json")
    out.write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))
    print(f"wrote {out} (streamed {reader.num_shards} shards)")


def cmd_evaluate(args) -> None:
    from multimodalworddiscovery_tpu_torch.eval import (
        alignment_prf,
        boundary_prf,
        cluster_nmi,
        cluster_purity,
        word_iou,
    )

    workdir, cfg = _workdir_cfg(args)
    if cfg.data.source == "stream":
        _evaluate_streaming(cfg, workdir, args)
        return
    cfg, corpus, gold, mod, params = _restore(workdir, _device(args), cfg=cfg)
    if gold is None:
        raise SystemExit("no gold annotations available for this dataset")

    with torch.no_grad():
        alignment = _align_call(cfg, mod, params, corpus)
        gold_alignment = torch.as_tensor(gold.alignment, device=corpus.device)
        pred_segs, pred_mask = segments_from_alignment(alignment, corpus.trg, corpus.src_len)
        gold_segs, gold_mask = segments_from_alignment(gold_alignment, corpus.trg,
                                                       corpus.src_len)
        pb = boundaries_from_segments(pred_segs, pred_mask, corpus.max_src_len)
        gb = boundaries_from_segments(gold_segs, gold_mask, corpus.max_src_len)
        results = {
            "alignment": alignment_prf(alignment, gold_alignment, corpus.src_mask()),
            "word_iou": word_iou(pred_segs, pred_mask, gold_segs, gold_mask,
                                 cfg.eval.iou_threshold),
            "boundary": boundary_prf(pb, gb, tolerance=cfg.eval.boundary_tolerance),
            "purity": cluster_purity(pred_segs, pred_mask, gold_segs, gold_mask,
                                     corpus.trg_vocab),
            "nmi": cluster_nmi(pred_segs, pred_mask, gold_segs, gold_mask, corpus.trg_vocab),
        }
        if cfg.eval.get("dtw", True) and corpus.src.ndim == 3:
            # DTW scoring of discovered word units on acoustic frames; the
            # all-pairs matrix is O((utts * segs)^2) DTW DPs, so it runs on
            # an explicit, LOGGED sample
            from multimodalworddiscovery_tpu_torch.eval.dtw import (
                cluster_dtw_coherence,
                dtw_to_gold,
            )

            max_len = int(cfg.eval.get("dtw_max_seg_len", 32))
            k_utt = min(corpus.n, int(cfg.eval.get("dtw_utterances", 64)))
            k_seg = min(pred_segs.shape[1], int(cfg.eval.get("dtw_segments", 8)))
            if k_utt < corpus.n or k_seg < pred_segs.shape[1]:
                print(
                    f"dtw: scoring first {k_utt}/{corpus.n} utterances, "
                    f"{k_seg} segments each (eval.dtw_utterances/dtw_segments)"
                )
            feats = corpus.src[:k_utt]
            ps, pm = pred_segs[:k_utt, :k_seg], pred_mask[:k_utt, :k_seg]
            gs, gm = gold_segs[:k_utt, :k_seg], gold_mask[:k_utt, :k_seg]
            coh = cluster_dtw_coherence(feats, ps, pm, max_len)
            results["dtw"] = dict(coh, to_gold=dtw_to_gold(feats, ps, pm, gs, gm, max_len))

        if cfg.eval.retrieval and cfg.model.name in _RETRIEVAL_MODELS:
            results["retrieval"] = _retrieval_metrics(cfg, mod, params, corpus)

    results = _to_jsonable(_floats(results))
    out = Path(args.output or workdir / "metrics.json")
    out.write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))
    print(f"wrote {out}")


# ---------------------------------------------------------------------------
# discover, retrieve, preprocess, export, lexicon, plot
# ---------------------------------------------------------------------------


def _discover_streaming(cfg, workdir: Path, args, dev) -> None:
    """Out-of-core audio-only discovery: segmental k-means EM streams shards
    (its centroid statistics are additive), then a per-shard discover pass
    writes segments and sums the boundary/purity statistics the way
    streamed evaluate does."""
    from multimodalworddiscovery_tpu_torch.data.io import load_alignment_json
    from multimodalworddiscovery_tpu_torch.data.stream import (
        ShardedCorpusReader,
        train_streaming,
        tree_sum_bounded,
    )
    from multimodalworddiscovery_tpu_torch.eval.metrics import (
        boundary_from_stats,
        boundary_stats,
        nmi_from_counts,
        purity_counts,
        purity_from_counts,
    )
    from multimodalworddiscovery_tpu_torch.models import segmental_kmeans as skm

    reader = ShardedCorpusReader(cfg.data.dir, device=dev)
    shard0 = reader.load_shard(0)
    params = skm.init(shard0, n_clusters=args.clusters,
                      generator=_generator(cfg.seed))  # seeded from shard 0's candidates
    prefetch = int(cfg.train.get("stream_prefetch", 1))

    writer = MetricsWriter(workdir / "train_metrics.jsonl")

    def on_iteration(it, p, ll):
        writer.write(it, loglik=ll)
        print(f"iter {it:3d}  -distortion {ll:.1f}")

    params, _ = train_streaming(skm, params, reader, cfg.train.num_iterations,
                                prefetch=prefetch, on_iteration=on_iteration)
    writer.close()

    has_gold = (reader.directory / "gold.json").exists()
    ga = np.zeros((reader.num_shards * reader.shard_size, reader.max_src_len), np.int32)
    if has_gold:
        ga[: reader.n] = load_alignment_json(reader.directory / "gold.json", reader.n,
                                             reader.max_src_len).alignment
    n_lbl = max(args.clusters + 2, reader.trg_vocab)
    tol = int(cfg.eval.boundary_tolerance)

    recs = []
    all_stats = []
    for k, shard in enumerate(reader.shards(prefetch)):
        lo = k * reader.shard_size
        hi = min(lo + reader.shard_size, reader.n)
        segs, mask = skm.discover(params, shard)
        if has_gold:
            gold_k = torch.as_tensor(ga[lo: lo + reader.shard_size], device=dev)
            gs, gm = segments_from_alignment(gold_k, shard.trg, shard.src_len)
            pb = boundaries_from_segments(segs, mask, shard.max_src_len)
            gb = boundaries_from_segments(gs, gm, shard.max_src_len)
            all_stats.append({"boundary": boundary_stats(pb, gb, tol),
                              "purity": purity_counts(segs, mask, gs, gm, n_lbl)})
        host_segs = segments_to_host(segs, mask)[: hi - lo]
        recs.extend(
            {"index": lo + i, "segments": [[int(a) for a in s] for s in host_segs[i]]}
            for i in range(hi - lo)
        )
    out = Path(args.output or workdir / "discovered_segments.json")
    out.write_text(json.dumps(recs, indent=1))
    print(f"wrote {out} (streamed {reader.num_shards} shards)")

    if all_stats:
        acc = tree_sum_bounded(iter(all_stats))
        results = {
            "boundary": _floats(boundary_from_stats(acc["boundary"])),
            "purity": float(purity_from_counts(acc["purity"])),
            "nmi": float(nmi_from_counts(acc["purity"])),
        }
        (workdir / "metrics.json").write_text(json.dumps(results, indent=2))
        print(json.dumps(results, indent=2))


def cmd_discover(args) -> None:
    """Audio-only word discovery: segmental k-means over a continuous corpus
    (the reference's comparison models).  No concepts used."""
    from multimodalworddiscovery_tpu_torch.eval.metrics import boundary_prf, cluster_purity
    from multimodalworddiscovery_tpu_torch.models import segmental_kmeans as skm

    cfg = load_config(args.config) if args.config else base_config()
    cfg.data.continuous = True
    apply_overrides(cfg, args.override)
    dev = _device(args)
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    _save_config(cfg, workdir)

    if cfg.data.source == "stream":
        _discover_streaming(cfg, workdir, args, dev)
        return

    corpus, gold = _load_data(cfg, dev)
    params = skm.init(corpus, n_clusters=args.clusters, generator=_generator(cfg.seed))
    writer = _writer(cfg, workdir)
    for it in range(cfg.train.num_iterations):
        t0 = time.perf_counter()
        params, stats = skm.em_step(params, corpus)
        ll, n_seg = float(stats["loglik"]), int(stats["n_segments"])
        writer.write(it, loglik=ll, n_segments=n_seg, seconds=time.perf_counter() - t0)
        print(f"iter {it:3d}  -distortion {ll:.1f}  segments {n_seg}")
    writer.close()

    segs, mask = skm.discover(params, corpus)
    out = Path(args.output or workdir / "discovered_segments.json")
    host_segs = segments_to_host(segs, mask)
    recs = [{"index": i, "segments": [[int(a) for a in s] for s in host_segs[i]]}
            for i in range(corpus.n)]
    out.write_text(json.dumps(recs, indent=1))
    print(f"wrote {out}")

    if gold is not None:
        gold_segs, gold_mask = segments_from_alignment(
            torch.as_tensor(gold.alignment, device=dev), corpus.trg, corpus.src_len
        )
        pb = boundaries_from_segments(segs, mask, corpus.max_src_len)
        gb = boundaries_from_segments(gold_segs, gold_mask, corpus.max_src_len)
        n_lbl = max(args.clusters + 2, corpus.trg_vocab)
        results = {
            "boundary": _floats(boundary_prf(pb, gb, tolerance=cfg.eval.boundary_tolerance)),
            "purity": float(cluster_purity(segs, mask, gold_segs, gold_mask, n_lbl)),
        }
        (workdir / "metrics.json").write_text(json.dumps(results, indent=2))
        print(json.dumps(results, indent=2))


def _retrieve_streaming(cfg, workdir: Path, args) -> None:
    """Out-of-core retrieval: the same within-shard pooled protocol as
    streamed evaluation (dense = the whole shard when no pool is set), with
    top-k rankings reported as GLOBAL utterance indices."""
    from multimodalworddiscovery_tpu_torch.eval.retrieval import (
        ranks_from_pooled,
        recall_from_ranks,
    )

    if cfg.model.name not in _RETRIEVAL_MODELS:
        raise SystemExit(f"retrieval not supported for model {cfg.model.name!r}")
    dev = _device(args)
    reader, shard0, mod, params = _restore_streaming(cfg, workdir, dev)
    pool_cfg = int(getattr(args, "pool", 0) or cfg.eval.get("retrieval_pool", 0) or 0)
    _check_stream_pool(pool_cfg, reader)

    ranks: dict[str, list[np.ndarray]] = {"c2i": [], "i2c": []}
    rankings: list[dict] = []
    skipped = 0
    with torch.no_grad():
        for k, shard in enumerate(reader.shards(int(cfg.train.get("stream_prefetch", 1)))):
            lo = k * reader.shard_size
            nv = min(reader.shard_size, reader.n - lo)
            sub = take_rows(shard, 0, nv)
            cand = _shard_pool(pool_cfg, nv, cfg.seed, k, dev)
            if cand is None:  # tail shard smaller than the pool
                skipped += nv
                continue
            for direction in ("c2i", "i2c"):
                scores = _pooled_scores(cfg, mod, params, sub, cand, direction)
                ranks[direction].append(ranks_from_pooled(scores).cpu().numpy())
                if direction == "c2i" and pool_cfg == 0:
                    s = scores.cpu().numpy()
                    cn = cand.cpu().numpy()
                    order = np.argsort(-s, axis=1)[:, : args.top_k]
                    for i in range(nv):
                        rankings.append({
                            "caption": lo + i,
                            "top_images": (lo + cn[i, order[i]]).tolist(),
                            "scores": [round(float(s[i, j]), 3) for j in order[i]],
                        })

    pool_size = pool_cfg if pool_cfg else reader.shard_size
    metrics: dict = {}
    for direction in ("c2i", "i2c"):
        r = torch.as_tensor(np.concatenate(ranks[direction]))
        metrics.update({k: round(float(v), 4)
                        for k, v in recall_from_ranks(r, pool_size, direction=direction).items()})
    payload: dict = {"recall": metrics, "protocol": (
        "dense within-shard" if pool_cfg == 0 else f"within-shard pools (C={pool_cfg})")}
    if rankings:
        payload["rankings"] = rankings
    out = Path(args.output or workdir / "retrieval.json")
    out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(metrics, indent=2))
    note = f"; {skipped} tail rows skipped" if skipped else ""
    print(f"wrote {out} (streamed {reader.num_shards} shards{note})")


def cmd_retrieve(args) -> None:
    """Cross-modal retrieval: rank images for every caption (and captions
    for every image) by alignment score; dump top-k + recall metrics."""
    from multimodalworddiscovery_tpu_torch.eval.retrieval import (
        recall_at_k,
        retrieval_scores_hmm_family,
        retrieval_scores_model1,
    )

    workdir, cfg = _workdir_cfg(args)
    if cfg.data.source == "stream":
        _retrieve_streaming(cfg, workdir, args)
        return
    cfg, corpus, _, mod, params = _restore(workdir, _device(args), cfg=cfg)
    if args.pool:
        cfg.eval.retrieval_pool = args.pool
    with torch.no_grad():
        if int(cfg.eval.get("retrieval_pool", 0)):
            # pooled protocol: rankings are within each caption's candidate pool
            metrics = {k: round(float(v), 4)
                       for k, v in _retrieval_metrics(cfg, mod, params, corpus).items()}
            out = Path(args.output or workdir / "retrieval.json")
            out.write_text(json.dumps({"recall": metrics}, indent=1))
            print(json.dumps(metrics, indent=2))
            print(f"wrote {out}")
            return
        if cfg.model.name == "model1":
            scores = retrieval_scores_model1(params, corpus)
        elif cfg.model.name in HMM_FAMILY:
            scores = retrieval_scores_hmm_family(mod, params, corpus)
        elif cfg.model.name == "grounding":
            scores = mod.retrieval_scores(params, corpus)
        else:
            raise SystemExit(f"retrieval not supported for model {cfg.model.name!r}")
        recall = _floats(recall_at_k(scores))

    s = scores.cpu().numpy()
    top = np.argsort(-s, axis=1)[:, : args.top_k]
    recs = [
        {"caption": i, "top_images": top[i].tolist(),
         "scores": [round(float(s[i, j]), 3) for j in top[i]]}
        for i in range(s.shape[0])
    ]
    out = Path(args.output or workdir / "retrieval.json")
    out.write_text(json.dumps({"recall": recall, "rankings": recs}, indent=1))
    print(json.dumps({k: round(v, 4) for k, v in recall.items()}, indent=2))
    print(f"wrote {out}")


def cmd_preprocess(args) -> None:
    """Build a corpus directory from public dataset artifacts."""
    from multimodalworddiscovery_tpu_torch.data.io import save_corpus

    dev = _device(args)
    if args.dataset == "flickr8k":
        from multimodalworddiscovery_tpu_torch.data import flickr8k

        corpus, gold, meta = flickr8k.build_corpus(args.captions, args.lexicon, args.concepts,
                                                   device=dev)
    elif args.dataset == "mscoco":
        from multimodalworddiscovery_tpu_torch.data import mscoco

        corpus, gold, meta = mscoco.build_corpus(args.instances, args.captions, args.lexicon,
                                                 device=dev)
    else:
        raise SystemExit(f"unknown dataset {args.dataset!r}")

    out = Path(args.output)
    save_corpus(corpus, gold, out, args.name)
    (out / f"{args.name}_vocab.json").write_text(
        json.dumps(
            {"phones": meta["phone_vocab"], "concepts": meta["concept_vocab"],
             "utterance_ids": meta["utterance_ids"]},
            indent=1,
        )
    )
    print(
        f"wrote {out}/{args.name}_*: {corpus.n} utterances, "
        f"{corpus.src_vocab - 1} phones, {corpus.trg_vocab - 1} concepts"
    )


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _flax_arrays(model, rename: dict, tensors) -> dict[str, np.ndarray]:
    """A module's tensors (in ``model.parameters()`` order: the weights, or
    an optimizer moment of them) as the reference's flax tree, flattened to
    "a/b/leaf" paths in flax's (sorted) order, each in flax's layout: Dense
    kernels [in, out], the attention heads' DenseGeneral kernels [in, h, d]
    (q, k, v; biases [h, d]) and [h, d, out] (o), Conv kernels [w, in,
    out]."""
    from torch import nn

    from multimodalworddiscovery_tpu_torch.models import attention
    from multimodalworddiscovery_tpu_torch.models.flax_params import flax_paths

    heads = {}
    for m in model.modules():
        if isinstance(m, attention._Attention):
            for role in ("q", "k", "v"):
                heads[id(getattr(m, role))] = ("in", m.heads, m.head_dim)
            heads[id(m.o)] = ("out", m.heads, m.head_dim)
    owners = [(m, pname) for _, m in model.named_modules()
              for pname, _ in m.named_parameters(recurse=False)]
    out = {}
    for (m, pname), path, t in zip(owners, flax_paths(model, rename), tensors):
        a = _host(t)
        if isinstance(m, nn.Linear):
            role = heads.get(id(m))
            if pname == "weight":
                a = a.T
                if role is not None:
                    _, h, d = role
                    a = a.reshape(a.shape[0], h, d) if role[0] == "in" else a.reshape(h, d, -1)
            elif role is not None and role[0] == "in":
                a = a.reshape(role[1], role[2])
        elif isinstance(m, nn.Conv1d) and pname == "weight":
            a = a.transpose(2, 1, 0)
        out[path] = a
    return {"/".join(p): out[p] for p in sorted(out)}


def _mlp_arrays(mlp, tensors) -> dict[str, np.ndarray]:
    """The DNN-HMM's emission MLP tensors as flax's {Dense_i: {bias, kernel}}."""
    ts = list(tensors)
    out = {}
    for i in range(len(mlp.dense)):
        out[f"Dense_{i}/bias"] = _host(ts[2 * i + 1])
        out[f"Dense_{i}/kernel"] = _host(ts[2 * i]).T
    return out


def _adam_arrays(prefix: str, state, tree, moment_key: str = "params") -> dict[str, np.ndarray]:
    """An Adam state as optax's ScaleByAdamState leaves under ``prefix``."""
    arrays = {f"{prefix}/count": np.int32(state.count)}
    for m in ("mu", "nu"):
        arrays.update({f"{prefix}/{m}/{moment_key}/{k}": v
                       for k, v in tree(getattr(state, m)).items()})
    return arrays


def _export_arrays(params) -> dict[str, np.ndarray]:
    """A parameter tree as the reference's export: the leaves of its pytree
    under their paths joined by "/" (``cli.py`` of the JAX package), in
    flax's layout, so either package's ``model.npz`` carries the same keys
    and each model's ``params_from_numpy`` reads them."""
    from multimodalworddiscovery_tpu_torch.models import attention, grounding, hmm_dnn

    if isinstance(params, hmm_dnn.DnnHMMParams):
        def mlp_tree(ts):
            return _mlp_arrays(params.mlp, ts)

        arrays = {f"mlp/params/{k}": v
                  for k, v in mlp_tree(list(params.mlp.parameters())).items()}
        opt = params.opt_state
        if "trans" in opt:  # the fully end-to-end CRF: optax.multi_transform
            arrays.update(_adam_arrays("opt_state/inner_states/mlp/inner_state/0", opt["mlp"],
                                       mlp_tree, "0/params"))
            pre = "opt_state/inner_states/trans/inner_state/0"
            arrays[f"{pre}/count"] = np.int32(opt["trans"].count)
            for m in ("mu", "nu"):
                lj, lp0 = getattr(opt["trans"], m)
                arrays[f"{pre}/{m}/1"] = _host(lj)
                arrays[f"{pre}/{m}/2"] = _host(lp0)
        else:
            arrays.update(_adam_arrays("opt_state/0", opt["mlp"], mlp_tree))
        arrays.update(log_prior=_host(params.log_prior), log_jump=_host(params.log_jump),
                      log_p0=_host(params.log_p0))
        return arrays
    if isinstance(params, (attention.AttentionParams, grounding.GroundingParams)):
        model = params.model
        rename = (attention._FLAX_NAMES if isinstance(params, attention.AttentionParams)
                  else grounding._flax_names(model))

        def tree(ts):
            return _flax_arrays(model, rename, ts)

        arrays = {f"params/params/{k}": v for k, v in tree(list(model.parameters())).items()}
        arrays.update(_adam_arrays("opt_state/0", params.opt_state, tree))
        arrays["step"] = np.int32(params.step)
        return arrays
    return {f.name: _host(getattr(params, f.name)) for f in dataclasses.fields(params)
            if isinstance(getattr(params, f.name), torch.Tensor)}


def cmd_export(args) -> None:
    """Export trained model parameters as a plain .npz (the reference's
    printModel-style artifact: inspectable tables, no checkpoint reader
    needed), with the JAX package's keys."""
    dev = _device(args)
    workdir = Path(args.workdir)
    cfg = _load_workdir_config(workdir)
    if cfg.data.source == "stream":
        # export needs only the parameter template, never the corpus
        _, _, _, params = _restore_streaming(cfg, workdir, dev)
    else:
        cfg, _, _, _, params = _restore(workdir, dev, cfg=cfg)
    arrays = _export_arrays(params)
    out = Path(args.output or workdir / "model.npz")
    np.savez(out, **arrays)
    print(f"wrote {out}: " + ", ".join(f"{k}{v.shape}" for k, v in list(arrays.items())[:6]))


def _lexicon_counts(cfg, workdir: Path, dev):
    """For each concept, a counter of the phone sequences decoded onto it;
    streamed workdirs decode shard by shard (the counters are O(lexicon),
    so the lexicon never needs the resident corpus)."""
    from collections import Counter, defaultdict

    by_concept: dict[int, Counter] = defaultdict(Counter)

    def count(host_segs, src):
        for i, utt_segs in enumerate(host_segs):
            for s, e, c in utt_segs:
                by_concept[c][" ".join(str(int(p)) for p in src[i, s:e])] += 1

    with torch.no_grad():
        if cfg.data.source == "stream":
            reader, shard0, mod, params = _restore_streaming(cfg, workdir, dev)
            kw = _decode_kwargs(cfg, mod, shard0)
            for k, shard in enumerate(reader.shards(int(cfg.train.get("stream_prefetch", 1)))):
                nv = min(reader.shard_size, reader.n - k * reader.shard_size)
                segs, mask = segments_from_alignment(mod.align(params, shard, **kw), shard.trg,
                                                     shard.src_len)
                count(segments_to_host(segs, mask)[:nv],
                      np.load(reader.directory / f"src_{k}.npy", mmap_mode="r"))
        else:
            cfg, corpus, _, mod, params = _restore(workdir, dev, cfg=cfg)
            segs, mask = segments_from_alignment(_align_call(cfg, mod, params, corpus),
                                                 corpus.trg, corpus.src_len)
            count(segments_to_host(segs, mask), corpus.src.cpu().numpy())
    return by_concept


def cmd_lexicon(args) -> None:
    """Dump the discovered lexicon: for each concept, the most frequent
    phone sequences among its discovered word segments."""
    dev = _device(args)
    workdir = Path(args.workdir)
    cfg = _load_workdir_config(workdir)
    by_concept = _lexicon_counts(cfg, workdir, dev)
    out = {}
    for c in sorted(by_concept):
        out[str(c)] = [{"phones": w, "count": n} for w, n in by_concept[c].most_common(args.top_k)]
    path = Path(args.output or workdir / "lexicon.json")
    path.write_text(json.dumps(out, indent=1))
    for c in sorted(by_concept)[:15]:
        tops = ", ".join(f"[{w}]x{n}" for w, n in by_concept[c].most_common(3))
        print(f"concept {c:4d}: {tops}")
    print(f"wrote {path}")


def cmd_plot(args) -> None:
    from multimodalworddiscovery_tpu_torch.utils.plotting import (
        plot_alignment_matrix,
        plot_segmentation,
    )

    dev = _device(args)
    workdir = Path(args.workdir)
    cfg = _load_workdir_config(workdir)
    i = label = args.utterance  # label = GLOBAL index (file/title naming);
    # under streaming i is rebound to the shard-local row for indexing
    if cfg.data.source == "stream":
        # out-of-core: only the shard holding the requested utterance loads
        from multimodalworddiscovery_tpu_torch.data.io import load_alignment_json

        reader, shard0, mod, params = _restore_streaming(cfg, workdir, dev)
        if not 0 <= i < reader.n:
            raise SystemExit(f"utterance {i} out of range (corpus has {reader.n})")
        k = i // reader.shard_size
        corpus = reader.load_shard(k) if k else shard0
        gold = None
        if (reader.directory / "gold.json").exists():
            gold_full = load_alignment_json(reader.directory / "gold.json", reader.n,
                                            reader.max_src_len)
            lo = k * reader.shard_size
            gold = GoldAnnotations(alignment=None, segments=[
                gold_full.segments[lo + j] if lo + j < reader.n else []
                for j in range(reader.shard_size)
            ])  # indexed by the SHARD-LOCAL row below
        i = i % reader.shard_size
    else:
        cfg, corpus, gold, mod, params = _restore(workdir, dev, cfg=cfg)
    with torch.no_grad():
        alignment = _align_call(cfg, mod, params, corpus)
        segs, mask = segments_from_alignment(alignment, corpus.trg, corpus.src_len)
        seg_list = segments_to_host(segs, mask)[i]
        sl = int(corpus.src_len[i])
        out_dir = Path(args.output or workdir / "plots")
        out_dir.mkdir(parents=True, exist_ok=True)

        gold_list = gold.segments[i] if gold is not None else None
        plot_segmentation(alignment[i, :sl].cpu().numpy(), seg_list, gold_segments=gold_list,
                          title=f"utt {label}", path=out_dir / f"segmentation_{label}.png")
        if hasattr(mod, "posteriors"):
            post = mod.posteriors(params, corpus)[i, :sl].T.cpu().numpy()
            plot_alignment_matrix(post, title=f"posteriors utt {label}",
                                  path=out_dir / f"posteriors_{label}.png")
        if hasattr(mod, "attention_matrix"):
            attn = mod.attention_matrix(params, corpus)[i, :, :sl].cpu().numpy()
            plot_alignment_matrix(attn, title=f"attention utt {label}",
                                  path=out_dir / f"attention_{label}.png")
    print(f"wrote plots to {out_dir}")


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mwd-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    def add(name, fn, **kw):
        p = sub.add_parser(name, **kw)
        p.add_argument("--device", default="cuda",
                       help="torch device of the run (default cuda: the card and its kernels; "
                            "cpu: the kernels' plain versions)")
        p.set_defaults(fn=fn)
        return p

    p_train = add("train", cmd_train, help="train an aligner")
    p_train.add_argument("--config", default=None, help="python config file")
    p_train.add_argument("--workdir", required=True)
    p_train.add_argument("--fresh", action="store_true", help="ignore existing checkpoints")
    p_train.add_argument("--override", nargs="*", default=[], help="key.path=value overrides")

    p_disc = add("discover", cmd_discover,
                 help="audio-only word discovery (segmental k-means)")
    p_disc.add_argument("--config", default=None)
    p_disc.add_argument("--workdir", required=True)
    p_disc.add_argument("--clusters", type=int, default=64)
    p_disc.add_argument("--output", default=None)
    p_disc.add_argument("--override", nargs="*", default=[])

    p_ret = add("retrieve", cmd_retrieve, help="cross-modal retrieval rankings + recall@k")
    p_ret.add_argument("--workdir", required=True)
    p_ret.add_argument("--top-k", type=int, default=10)
    p_ret.add_argument("--pool", type=int, default=0,
                       help="candidate-pool size (0 = dense N x N scoring)")
    p_ret.add_argument("--output", default=None)
    p_ret.add_argument("--override", nargs="*", default=[],
                       help="eval-time key.path=value overrides")

    p_pre = add("preprocess", cmd_preprocess,
                help="build a corpus dir from public dataset files")
    p_pre.add_argument("--dataset", choices=["flickr8k", "mscoco"], required=True)
    p_pre.add_argument("--captions", required=True, help="Flickr8k.token.txt / captions json")
    p_pre.add_argument("--lexicon", required=True, help="word -> phones dictionary")
    p_pre.add_argument("--concepts", default=None, help="per-image concepts (flickr8k)")
    p_pre.add_argument("--instances", default=None, help="COCO instances json (mscoco)")
    p_pre.add_argument("--output", required=True)
    p_pre.add_argument("--name", default="corpus")

    p_shard = add(
        "shard", cmd_shard,
        help="split a corpus into fixed-shape shards for out-of-core "
             "streaming EM (then train with data.source=stream data.dir=...)",
    )
    p_shard.add_argument("--config", default=None, help="python config file")
    p_shard.add_argument("--output", required=True, help="shard directory")
    p_shard.add_argument("--shard-size", type=int, required=True)
    p_shard.add_argument(
        "--shuffle", type=int, default=None, metavar="SEED",
        help="permute utterances once at write time (recorded in the "
             "manifest).  Recommended for ORDERED corpora feeding streamed "
             "minibatch SGD, which samples within the resident shard",
    )
    p_shard.add_argument(
        "--storage-dtype", default=None, choices=["float32", "float16"],
        help="on-disk dtype for FLOAT fields (frames/region embeddings). "
             "float16 halves disk + host-to-device bytes per pass (streaming "
             "upcasts to float32 on the device before any compute); LOSSY: "
             "one f16 rounding at write time",
    )
    p_shard.add_argument("--override", nargs="*", default=[])

    p_exp = add("export", cmd_export, help="export model params as plain .npz")
    p_exp.add_argument("--workdir", required=True)
    p_exp.add_argument("--output", default=None)

    p_lex = add("lexicon", cmd_lexicon, help="dump the discovered concept->word lexicon")
    p_lex.add_argument("--workdir", required=True)
    p_lex.add_argument("--top-k", type=int, default=5)
    p_lex.add_argument("--output", default=None)

    p_plot = add("plot", cmd_plot, help="plot alignments/segmentations for inspection")
    p_plot.add_argument("--workdir", required=True)
    p_plot.add_argument("--utterance", type=int, default=0)
    p_plot.add_argument("--output", default=None)

    for name, fn in (("align", cmd_align), ("segment", cmd_segment),
                     ("evaluate", cmd_evaluate)):
        p = add(name, fn, help=f"{name} with a trained model")
        p.add_argument("--workdir", required=True)
        p.add_argument("--output", default=None)
        p.add_argument("--override", nargs="*", default=[],
                       help="eval-time key.path=value overrides")
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
