"""Rank functions of the port's parallel tests (tests/test_torch_parallel.py,
test_torch_sequence.py, test_torch_multihost.py).

Each runs on every rank of a local gloo world started by
``parallel.multihost.spawn`` (fresh interpreters, so this module imports no
JAX) and returns its results, tensors as numpy arrays; the tests compare
them with the port in one process and with the JAX package.  Every world
runs all its scenarios in one spawn: a world costs seconds to start.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from multimodalworddiscovery_tpu_torch.core import collectives
from multimodalworddiscovery_tpu_torch.core.mesh import make_mesh
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
from multimodalworddiscovery_tpu_torch.data.stream import ShardedCorpusReader, train_streaming
from multimodalworddiscovery_tpu_torch.models import (
    attention,
    grounding,
    hmm,
    hmm_core,
    hmm_crf,
    hmm_dnn,
    hmm_gaussian,
    model1,
    segmental_kmeans,
)
from multimodalworddiscovery_tpu_torch.models import minibatch as mb
from multimodalworddiscovery_tpu_torch.parallel import (
    make_data_parallel_step,
    make_shard_map_em_step,
    multihost,
    shard_corpus,
)
from multimodalworddiscovery_tpu_torch.parallel.data_parallel import take_rows
from multimodalworddiscovery_tpu_torch.parallel.sequence import (
    estep_time_sharded,
    forward_time_sharded,
)

# the corpora of the scenarios (the reference tests' where one exists)
DP_CORPORA = {"model1": dict(n_utterances=36, seed=1), "hmm": dict(n_utterances=21, seed=2)}
FRAMES_CORPUS = dict(n_utterances=24, n_concepts=10, seed=4)
FRAMES = dict(feat_dim=8, noise=0.05, seed=0)
MB_CORPUS = dict(n_utterances=24, seed=8)
MB_ROWS = list(range(0, 24, 3))  # the global batch of the step scenarios, B = 8
SEQ_CORPORA = {"forward": dict(n_utterances=10, seed=4), "estep": dict(n_utterances=10, seed=7)}
SEQ_PAD = 8  # Ts padded to a multiple of 8, the reference's mesh size


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def params_np(tree) -> list[np.ndarray]:
    return [t.detach().cpu().numpy().copy() for t in collectives.tensors_of(tree)]


def resolved(nu, steps: int) -> np.ndarray:
    """The weights whose RMS gradient over ``steps`` Adam steps (from the
    second moment ``nu``) is at least 1e-6, a hundred times Adam's eps.
    Below it a gradient is rounding noise (the attention key biases, to
    which the softmax is invariant, have gradients of 1e-9; embedding rows
    of tokens outside the batch have 0), and Adam's normalised step moves
    the weight by up to the learning rate whichever way the noise points,
    so two summation orders may end a learning rate apart there."""
    rms = np.sqrt(np.asarray(nu) / (1 - hmm_dnn.ADAM_B2 ** steps))
    return rms >= 1e-6


def close_weights(got, want, nu, steps: int, lr: float) -> None:
    """Model weights after ``steps`` Adam steps against another run's:
    rtol 1e-5, atol 1e-6, except the weights whose gradient is rounding
    noise (``resolved`` on the second moments ``nu``), held to ``steps``
    learning rates of movement on each side instead."""
    assert len(got) == len(want) == len(nu)
    for a, b, v in zip(got, want, nu):
        a, b = np.asarray(a), np.asarray(b)
        ok = resolved(v, steps)
        assert np.all(np.abs(a - b)[~ok] <= 2 * steps * lr)
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-5, atol=1e-6)


def close_state(got_params, new, adam, steps):
    """The W-rank state against the one-process state: the model's weights
    (which lead the state's tensors, in ``adam``'s order) by
    ``close_weights``, every other tensor rtol 1e-5, atol 1e-6."""
    want = params_np(new)
    k = len(adam.nu)
    close_weights(got_params[:k], want[:k], adam.nu, steps, new.learning_rate)
    for a, b in zip(got_params[k:], want[k:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def fields_np(params) -> dict[str, np.ndarray]:
    """A parameter dataclass's tensor fields by name."""
    return {f.name: getattr(params, f.name).detach().cpu().numpy().copy()
            for f in dataclasses.fields(params) if torch.is_tensor(getattr(params, f.name))}


def frames_corpus():
    corpus, gold, _ = make_flickr8k_mini(**FRAMES_CORPUS, device="cpu")
    return phones_to_frames(corpus, gold, **FRAMES, device="cpu")[0]


def mb_states(fc, trees: dict):
    """The minibatch scenarios' initial states, the same on every rank:
    attention and grounding carry the JAX package's initial flax trees
    (``trees``, numpy arrays), the CRF is the port's ``init_e2e``."""
    return {"attention": attention.params_from_numpy(trees["attention"], device="cpu"),
            "grounding": grounding.params_from_numpy(trees["grounding"], device="cpu"),
            "crf": hmm_crf.init_e2e(fc, hidden=16, n_sgd=2, generator=gen(0))}


MB_STEPS = {"attention": attention.em_step, "grounding": grounding.em_step,
            "crf": functools.partial(hmm_crf.em_step, learn_transitions=True)}


def mb_frames(corpus):
    """The CRF's frames of the minibatch corpus."""
    c, gold, _ = make_flickr8k_mini(**MB_CORPUS, device="cpu")
    return phones_to_frames(c, gold, feat_dim=8, noise=0.1, seed=0, device="cpu")[0]


def _error(fn) -> str:
    """The type and message of what ``fn()`` raises ("" if nothing)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the type and message
        return f"{type(e).__name__}: {e}"
    return ""


def parallel_world(gauss_np: dict, trees: dict) -> dict:
    """Data-parallel EM (Model-1, HMM with and without the kernels' plain
    versions, Gaussian, segmental k-means), the minibatch gradient steps
    (from ``mb_states(fc, trees)``), the samplers and the mesh's errors."""
    mesh = make_mesh()
    group = collectives.group_of(mesh)
    w, rank = mesh.size(), mesh.get_local_rank()
    out = {"world": w, "rank": rank, "em": {}, "steps": {}}

    def em(name, mod, corpus, p0, step):
        shard = shard_corpus(corpus, mesh)
        p, stats = step(p0, shard)
        out["em"][name] = {"n_local": shard.n, "loglik": stats["loglik"], "params": fields_np(p),
                           "disagree": collectives.max_disagreement(p, group)}

    for name, mod in (("model1", model1), ("hmm", hmm)):
        corpus, _, _ = make_flickr8k_mini(**DP_CORPORA[name], device="cpu")
        em(name, mod, corpus, mod.init(corpus), make_data_parallel_step(mod.em_step, mesh))
    corpus, _, _ = make_flickr8k_mini(**DP_CORPORA["hmm"], device="cpu")
    em("hmm_shard_map_kernels", hmm, corpus, hmm.init(corpus),
       make_shard_map_em_step(hmm, mesh, count_kwargs={"use_kernels": True}))
    em("hmm_partial", hmm, corpus, hmm.init(corpus), make_data_parallel_step(
        functools.partial(hmm.em_step, smoothing=1e-6, use_kernels=True), mesh))
    fc = frames_corpus()
    em("hmm_gaussian", hmm_gaussian, fc, hmm_gaussian.params_from_numpy(**gauss_np, device="cpu"),
       make_data_parallel_step(hmm_gaussian.em_step, mesh))
    em("segmental_kmeans", segmental_kmeans, fc,
       segmental_kmeans.init(fc, n_clusters=8, generator=gen(0)),
       make_data_parallel_step(segmental_kmeans.em_step, mesh))

    # the gradient steps: rank r holds its block of the global batch's rows
    corpus, _, _ = make_flickr8k_mini(**MB_CORPUS, device="cpu")
    fc_mb = mb_frames(corpus)
    states = mb_states(fc_mb, trees)
    b_local = len(MB_ROWS) // w
    mine = torch.tensor(MB_ROWS[rank * b_local:(rank + 1) * b_local])
    for name, step_fn in MB_STEPS.items():
        c = fc_mb if name == "crf" else corpus
        new, stats = step_fn(states[name], mb.gather_batch(c, mine), mesh=mesh)
        out["steps"][name] = {"params": params_np(new), "stats": stats,
                              "fields": fields_np(new),
                              "disagree": collectives.max_disagreement(new, group)}
    # the same through make_minibatch_step's samplers (one generator seed)
    for name, sample in (("attention", "global"), ("attention", "valid"),
                         ("grounding", "global"), ("crf", "global")):
        c = fc_mb if name == "crf" else corpus
        step = mb.make_minibatch_step(MB_STEPS[name], shard_corpus(c, mesh), len(MB_ROWS),
                                      mesh=mesh, sample=sample)
        new, stats = step(states[name], gen(5))
        out["steps"][f"{name}_{sample}"] = {"params": params_np(new), "stats": stats,
                                            "fields": fields_np(new)}

    # sample_local_batch on 21 rows padded over the ranks
    small, _, _ = make_flickr8k_mini(n_utterances=21, seed=8, device="cpu")
    shard = shard_corpus(small, mesh)
    real = int((shard.src_len > 0).sum())
    draws = {}
    for share in (1, 3, shard.n):
        b = mb.sample_local_batch(shard, mb.step_generator(0, 0, rank), share * w, mesh)
        draws[share] = {"n": b.n, "padding": int((b.src_len == 0).sum()),
                        "rows": b.src.numpy()}
    out["local"] = {"n_local": shard.n, "real": real, "draws": draws, "errors": {
        "indivisible": _error(lambda: mb.sample_local_batch(shard, gen(0), w + 1, mesh)),
        "too_big": _error(lambda: mb.sample_local_batch(shard, gen(0), w * (shard.n + 1),
                                                        mesh)),
        "step_without_mesh_param": _error(lambda: mb.make_minibatch_step(
            lambda s, b: (s, {}), shard, w, mesh=mesh)),
        "closed_form_only": _error(lambda: make_data_parallel_step(lambda p, c: (p, {}), mesh)),
        "too_many_devices": _error(lambda: make_mesh(w + 1)),
        "batch_indivisible": _error(lambda: mb.make_minibatch_step(
            attention.em_step, shard, w + 1, mesh=mesh)),
    }}
    if w == 4:  # a mesh over the first two ranks
        sub = make_mesh(2)
        if rank < 2:
            out["sub_mesh_sum"] = collectives.all_sum(torch.tensor(rank + 1),
                                                      collectives.group_of(sub))
    return out


def _padded_in_time(corpus, multiple: int):
    ts = corpus.max_src_len
    pad = -(-ts // multiple) * multiple - ts
    return dataclasses.replace(corpus, src=F.pad(corpus.src, (0, pad)))


def sequence_inputs(name: str):
    """(padded corpus, params, log_init, log_trans, log_emit) of a scenario."""
    corpus, _, _ = make_flickr8k_mini(**SEQ_CORPORA[name], device="cpu")
    corpus = _padded_in_time(corpus, SEQ_PAD)
    params = hmm.init(corpus)
    return (corpus, params, *hmm._machinery(params, corpus))


def sequence_world() -> dict:
    """The time-sharded forward and E-step on a "seq" mesh, through the
    plain log-semiring product and through K8's plain version."""
    mesh = make_mesh(None, "seq")
    out = {"rank": mesh.get_local_rank(), "world": mesh.size()}
    corpus, _, log_init, log_trans, log_emit = sequence_inputs("forward")
    out["forward"] = dict(zip(("alphas", "logz"), forward_time_sharded(
        log_init, log_trans, log_emit, corpus.src_len, mesh)))
    corpus, _, log_init, log_trans, log_emit = sequence_inputs("estep")
    for route, use_kernels in (("plain", None), ("k8", True)):
        out[f"estep_{route}"] = dict(zip(("gamma", "xi", "logz"), estep_time_sharded(
            log_init, log_trans, log_emit, corpus.src_len, hmm_core.state_mask(corpus), mesh,
            use_kernels=use_kernels)))
    out["indivisible"] = _error(lambda: forward_time_sharded(
        log_init, log_trans, log_emit[:, :-1], corpus.src_len, mesh))
    return out


def multihost_world(dirs: dict, store: str, attention_tree: dict) -> dict:
    """The multi-rank trainers over shard directories written by the test:
    ``dirs["ids"]`` (20 utterances in 5 shards of 4), ``dirs["shuffled"]``
    (24 in 3 shards of 8, shuffled), ``dirs["frames"]`` (frames in 3 shards
    of 8), ``dirs["frames3"]`` (the frames in shards of 3); ``store`` a
    shared scratch directory; ``attention_tree`` the streamed minibatch
    trainers' initial attention weights (a flax tree of numpy arrays)."""
    mesh = multihost.global_mesh()
    group = collectives.group_of(mesh)
    p, w = mesh.get_local_rank(), mesh.size()
    out = {"rank": p, "world": w}
    multihost.initialize(device="cpu")  # a second call is a no-op
    out["coordinator"] = multihost.is_coordinator()

    reader = ShardedCorpusReader(dirs["ids"], device="cpu")
    full, _ = reader.materialize()
    p0 = hmm.init(full)
    params, lls = multihost.train_streaming_multihost(hmm, p0, reader, 3, mesh=mesh)
    out["stream_multihost"] = {"lls": lls, "params": fields_np(params)}
    params, lls = train_streaming(hmm, p0, reader, 3, mesh=mesh, prefetch=2)
    out["stream_mesh"] = {"lls": lls, "params": fields_np(params)}
    params, lls = train_streaming(model1, model1.init(full), reader, 3, mesh=mesh)
    out["stream_mesh_model1"] = {"lls": lls, "params": fields_np(params)}
    out["stream_mesh_indivisible"] = _error(lambda: train_streaming(
        hmm, p0, ShardedCorpusReader(dirs["frames3"], device="cpu"), 1, mesh=mesh))

    # the streamed minibatch trainer over the mesh: the single-process draws
    shuffled = ShardedCorpusReader(dirs["shuffled"], device="cpu")
    st0 = attention.params_from_numpy(attention_tree, device="cpu")
    st, losses = mb.train_minibatch_streaming(attention.em_step, st0, shuffled, 8, 4, seed=3,
                                              mesh=mesh)
    out["minibatch_streaming_mesh"] = {"losses": losses, "params": params_np(st)}
    st, losses = multihost.train_minibatch_streaming_multihost(
        attention.em_step, st0, shuffled, 8, 4, seed=3, mesh=mesh, steps_per_round=1)
    out["minibatch_multihost"] = {"losses": losses, "params": params_np(st),
                                  "disagree": collectives.max_disagreement(st, group)}
    st, resumed = multihost.train_minibatch_streaming_multihost(
        attention.em_step, st0, shuffled, 8, 2, seed=3, mesh=mesh, steps_per_round=1)
    st, rest = multihost.train_minibatch_streaming_multihost(
        attention.em_step, st, shuffled, 8, 2, seed=3, mesh=mesh, steps_per_round=1,
        start_step=2)
    out["minibatch_multihost_resumed"] = {"losses": resumed + rest, "params": params_np(st)}

    # bucketed EM with each rank holding its process slice
    corpus, _, _ = make_flickr8k_mini(n_utterances=24, seed=7, device="cpu")
    lo, hi = multihost.process_slice(corpus.n)
    params, lls = multihost.train_bucketed_multihost(hmm, hmm.init(corpus),
                                                     take_rows(corpus, lo, hi), [10], 3,
                                                     mesh=mesh)
    out["bucketed_multihost"] = {"lls": lls, "params": fields_np(params)}
    # and train_bucketed with every bucket split over the ranks
    from multimodalworddiscovery_tpu_torch.models.bucketed import train_bucketed

    params, lls = train_bucketed(hmm, hmm.init(corpus), corpus, [10], 3, mesh=mesh)
    out["bucketed_mesh"] = {"lls": lls, "params": fields_np(params)}

    # global_corpus_from_local and replicate_to_global
    local = take_rows(corpus, 0, 3 + p)
    out["global_n"] = multihost.global_corpus_from_local(local, mesh).n
    mine = {"x": torch.full((3,), float(p))}
    out["replicated"] = multihost.replicate_to_global(mine, mesh)["x"]

    # the frame reservoir and the VQ-teacher recipe over the ranks
    frames = ShardedCorpusReader(dirs["frames"], device="cpu")
    out["reservoir"] = {n: multihost.reservoir_frames_multihost(frames, n, seed=s, mesh=mesh)
                        for n, s in ((40, 1), (10**6, 0))}
    gp = multihost.init_vq_teacher_streaming_multihost(
        frames, os.path.join(store, "codes"), max_jump=3, n_components=2, generator=gen(0),
        n_codes=8, teacher_iters=2, seed_rounds=2, mesh=mesh)
    out["vq_teacher"] = {"params": fields_np(gp),
                         "disagree": collectives.max_disagreement(gp, group)}
    dist.barrier()
    return out


def cli_world(argvs: list) -> list:
    """Each ``mwd-torch`` command line of ``argvs`` in turn on this rank
    (tests/test_torch_cli.py: ``train.distributed=true`` over the spawned
    world); returns the ranks' world size and rank."""
    from multimodalworddiscovery_tpu_torch import cli

    for argv in argvs:
        cli.main(argv)
    return [dist.get_world_size(), dist.get_rank()]
