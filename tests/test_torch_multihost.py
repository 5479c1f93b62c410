"""The port's multi-process layer (parallel/multihost.py) and the streaming
``mesh=`` forms (data/stream.train_streaming, models/minibatch's streamed
trainer, models/bucketed.train_bucketed, hmm_gaussian's quantize hooks) on a
local gloo world of 2 CPU ranks, against resident single-process EM, the
port's single-process streaming trainers and the JAX package.

The reference's multi-process tests (tests/test_multihost.py) run two OS
processes of 4 virtual devices and are ``slow``; here one spawned world
runs every scenario once per module (tests/torch_parallel_workers.py).  The
shard directories are the reference tests': 20 utterances in 5 shards of 4
(3 rounds over 2 ranks, rank 1's last shard all zero), their frames in 3
shards of 8, and 24 utterances in 3 shuffled shards of 8 (2 does not
divide 3: the cyclic schedule).  Bounds: streamed and bucketed EM against
resident EM, loglik rtol 1e-5 and parameters atol 1e-4
(tests/test_stream.py:68-73, tests/test_multihost.py:278); the reservoir
equal bit for bit; the streamed minibatch trainer over the mesh against
one process and against the JAX package's single-device steps on the same
rows, from the JAX package's initial weights, rtol 1e-5 and atol 1e-6
(``torch_parallel_workers.close_weights``); the multi-rank VQ-teacher recipe
against the single-process one, rtol / atol 1e-4 (every stage sums the
same numbers in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as w
from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data.corpus import Corpus as JCorpus
from multimodalworddiscovery_tpu.models import attention as jatt
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu.parallel import multihost as jmh
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import phones_to_frames
from multimodalworddiscovery_tpu_torch.data import stream as tstream
from multimodalworddiscovery_tpu_torch.models import (
    attention,
    flax_params,
    hmm,
    hmm_gaussian,
    model1,
)
from multimodalworddiscovery_tpu_torch.models import minibatch as mb
from multimodalworddiscovery_tpu_torch.parallel import multihost

IDS = dict(n_utterances=20, n_concepts=10, n_phones=16, seed=5)
SHUFFLED = dict(n_utterances=24, n_concepts=10, n_phones=16, seed=1)
BUCKETS = dict(n_utterances=24, seed=7)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh_shards")
    corpus, gold, _ = torch_make(**IDS, device="cpu")
    assert tstream.write_shards(corpus, d / "ids", 4, gold=gold) == 5
    fc, fg, _ = phones_to_frames(corpus, gold, feat_dim=8, noise=0.1, seed=0, device="cpu")
    assert tstream.write_shards(fc, d / "frames", 8, gold=fg) == 3
    tstream.write_shards(fc, d / "frames3", 3)
    sc, _, _ = torch_make(**SHUFFLED, device="cpu")
    assert tstream.write_shards(sc, d / "shuffled", 8, shuffle=2) == 3
    return {k: str(d / k) for k in ("ids", "frames", "frames3", "shuffled")}


def _reader(d):
    return tstream.ShardedCorpusReader(d, device="cpu")


def _jax_corpus(c) -> JCorpus:
    """A port corpus (on the CPU) as the JAX package's."""
    return JCorpus(src=jnp.asarray(c.src.numpy()), src_len=jnp.asarray(c.src_len.numpy()),
                   trg=jnp.asarray(c.trg.numpy()), trg_len=jnp.asarray(c.trg_len.numpy()),
                   src_vocab=c.src_vocab, trg_vocab=c.trg_vocab)


@pytest.fixture(scope="module")
def attention_jax(dirs):
    """The JAX package's initial attention state on the shuffled corpus
    (the streamed minibatch trainers start from it), and its flax tree."""
    whole, _ = _reader(dirs["shuffled"]).materialize()
    js = jatt.init(_jax_corpus(whole), dim=16, key=jax.random.PRNGKey(0))
    return js, jax.tree.map(np.asarray, js.params)


@pytest.fixture(scope="module")
def world(dirs, tmp_path_factory, attention_jax):
    store = str(tmp_path_factory.mktemp("mh_store"))
    return multihost.spawn(w.multihost_world, 2, (dirs, store, attention_jax[1]), device="cpu",
                           timeout=300, store_dir=store)


def _close_em(got, lls, params, fields):
    np.testing.assert_allclose(got["lls"], lls, rtol=1e-5)
    for f in fields:
        np.testing.assert_allclose(got["params"][f], getattr(params, f).numpy(), atol=1e-4,
                                   err_msg=f)


@pytest.fixture(scope="module")
def resident(dirs):
    """Resident EM (3 iterations) on the ids corpus: the port's and the JAX
    package's logliks."""
    full, _ = _reader(dirs["ids"]).materialize()
    p, lls = hmm.train(hmm.init(full), full, 3)
    jc, _, _ = jax_make(**IDS)
    _, jlls = jax.jit(lambda p, c: jhmm.train(p, c, 3))(jhmm.init(jc), jc)
    return full, p, lls.numpy(), np.asarray(jlls)


@pytest.mark.parametrize("name", ["stream_multihost", "stream_mesh"])
def test_streamed_em_over_ranks_matches_resident(world, resident, name):
    """train_streaming_multihost (rank p streams shards p, p + 2, ...; the
    uneven tail as an all-zero shard) and train_streaming(mesh=) (each
    shard split over the ranks) against resident EM and the JAX package."""
    _, p, lls, jlls = resident
    for r in world:
        _close_em(r[name], lls, p, ("log_emit", "log_jump", "log_p0"))
    np.testing.assert_allclose(world[0][name]["lls"], jlls, rtol=1e-5)


def test_streamed_model1_over_the_mesh(world, resident):
    full = resident[0]
    p, lls = model1.train(model1.init(full), full, 3)
    _close_em(world[0]["stream_mesh_model1"], lls.numpy(), p, ("log_t",))


def test_streaming_mesh_needs_divisible_shards(world):
    err = world[0]["stream_mesh_indivisible"]
    assert err.startswith("ValueError") and "shard_size 3" in err


@pytest.mark.parametrize("name", ["bucketed_multihost", "bucketed_mesh"])
def test_bucketed_em_over_ranks_matches_resident(world, name):
    """train_bucketed_multihost (each rank its process slice, static
    buckets) and train_bucketed(mesh=) against resident EM and the JAX
    package (tests/test_multihost.py:278)."""
    corpus, _, _ = torch_make(**BUCKETS, device="cpu")
    p, lls = hmm.train(hmm.init(corpus), corpus, 3)
    jc, _, _ = jax_make(**BUCKETS)
    _, jlls = jax.jit(lambda p, c: jhmm.train(p, c, 3))(jhmm.init(jc), jc)
    for r in world:
        _close_em(r[name], lls.numpy(), p, ("log_emit", "log_jump"))
    np.testing.assert_allclose(world[0][name]["lls"], np.asarray(jlls), rtol=1e-5)


@pytest.fixture(scope="module")
def streamed_one_process(dirs, attention_jax):
    """The streamed minibatch trainer in one process -> (state, losses, the
    batches its steps took)."""
    taken = []

    def recorded(state, batch):
        taken.append(batch)
        return attention.em_step(state, batch)

    st0 = attention.params_from_numpy(attention_jax[1], device="cpu")
    st, losses = mb.train_minibatch_streaming(recorded, st0, _reader(dirs["shuffled"]), 8, 4,
                                              seed=3)
    return st, losses, taken


def test_minibatch_streaming_over_the_mesh_equals_one_process(world, streamed_one_process):
    """Each rank reads its half of every shard; the draws are the
    single-process ones, so the run is the single-process run."""
    st, losses, _ = streamed_one_process
    got = world[0]["minibatch_streaming_mesh"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=1e-6)
    w.close_state(got["params"], st, st.opt_state, 4)


def test_minibatch_streaming_over_the_mesh_matches_jax(world, streamed_one_process,
                                                       attention_jax):
    """The run over the mesh is the JAX package's single-device attention
    steps on the batches the single-process trainer draws."""
    st, _, taken = streamed_one_process
    js, step = attention_jax[0], jax.jit(jatt.em_step)
    jlosses = []
    for batch in taken:
        js, stats = step(js, _jax_corpus(batch))
        jlosses.append(float(stats["loglik"]))
    got = world[0]["minibatch_streaming_mesh"]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5, atol=1e-6)

    def load(tree):
        return flax_params.load_flax_tree(st.model, jax.tree.map(np.asarray, tree),
                                          attention._FLAX_NAMES, "cpu")

    want = load(js.params)
    w.close_weights(got["params"][:len(want)], want, load(js.opt_state[0].nu), len(taken),
                    st.learning_rate)


def test_minibatch_multihost_ranks_agree_and_resume(world):
    """The cyclic streamed trainer: state bit-identical on the ranks, finite
    losses, and a run resumed at step 2 equal to the uninterrupted one."""
    got = world[0]["minibatch_multihost"]
    assert got["disagree"] == 0.0
    assert len(got["losses"]) == 4 and np.all(np.isfinite(got["losses"]))
    for a, b in zip(world[1]["minibatch_multihost"]["params"], got["params"]):
        assert np.array_equal(a, b)
    res = world[0]["minibatch_multihost_resumed"]
    np.testing.assert_allclose(res["losses"], got["losses"], rtol=1e-6)
    for a, b in zip(res["params"], got["params"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_proc,num_shards", [(2, 3), (2, 5), (3, 4), (4, 6), (3, 3)])
def test_cyclic_schedule_covers_every_shard(n_proc, num_shards):
    """(r P + p) mod K over ceil(K / P) rounds covers every shard, also for
    P not dividing K, and matches the reference's schedule."""
    rounds = -(-num_shards // n_proc)
    seen = {k for r in range(rounds) for k in multihost.round_shards(r, n_proc, num_shards)}
    assert seen == set(range(num_shards))
    for r in range(rounds):
        assert multihost.round_shards(r, n_proc, num_shards) == [
            (r * n_proc + p) % num_shards for p in range(n_proc)]


def test_process_slice_partition():
    """tests/test_multihost.py:243, and equal to the reference's slices."""
    for n, p in [(24, 2), (7, 3), (8, 8), (5, 8)]:
        spans = [multihost.process_slice(n, i, p) for i in range(p)]
        assert spans == [jmh.process_slice(n, i, p) for i in range(p)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        for (a, b), (c, d) in zip(spans, spans[1:]):
            assert b == c and b - a >= d - c >= 0


def test_bucket_local_static_structure():
    """tests/test_multihost.py:253: a fixed bucket count, edge-padded time
    axes, every row once, the empty last bucket one zero-length row; the
    reference's buckets row for row."""
    corpus, _, _ = torch_make(n_utterances=20, seed=3, device="cpu")
    jc, _, _ = jax_make(n_utterances=20, seed=3)
    edges = [6, 10, corpus.max_src_len + 5]
    buckets = multihost.bucket_local_static(corpus, edges)
    want = jmh.bucket_local_static(jc, edges)
    assert len(buckets) == len(edges) + 1
    assert [b.max_src_len for b, _ in buckets] == [6, 10, corpus.max_src_len,
                                                   corpus.max_src_len]
    np.testing.assert_array_equal(np.sort(np.concatenate([i for _, i in buckets])),
                                  np.arange(20))
    last, last_idx = buckets[-1]
    assert len(last_idx) == 0 and last.n == 1 and int(last.src_len.sum()) == 0
    for (b, idx), (jb, jidx) in zip(buckets, want):
        np.testing.assert_array_equal(idx, jidx)
        for f in ("src", "src_len", "trg", "trg_len"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(jb, f)))


def test_global_corpus_replicate_and_coordinator(world):
    """Rank p holds 3 + p rows: both pad to the largest; rank 0's tensors
    reach every rank; rank 0 alone is the coordinator; a second initialize
    is a no-op."""
    assert [r["global_n"] for r in world] == [4, 4]
    for r in world:
        np.testing.assert_array_equal(r["replicated"], np.zeros(3, np.float32))
    assert [r["coordinator"] for r in world] == [True, False]
    assert multihost.is_coordinator()  # no process group here


def test_reservoir_frames_multihost_is_the_single_process_sample(world, dirs):
    """The merged reservoir equals _reservoir_frames bit for bit, in its
    key order (a sample, and every frame)."""
    reader = _reader(dirs["frames"])
    for n, seed in ((40, 1), (10**6, 0)):
        want = hmm_gaussian._reservoir_frames(reader, n, seed=seed)
        for r in world:
            np.testing.assert_array_equal(r["reservoir"][n], want)


def test_vq_teacher_multihost(world, dirs, tmp_path):
    """Parameters identical on every rank, the code shards and manifest
    written once into the shared directory, and the single-process
    streaming recipe's parameters up to addition order."""
    got = world[0]["vq_teacher"]
    assert got["disagree"] == 0.0
    for a, b in zip(world[1]["vq_teacher"]["params"].values(), got["params"].values()):
        assert np.array_equal(a, b)
    want = hmm_gaussian.init_vq_teacher_streaming(
        _reader(dirs["frames"]), tmp_path / "codes", max_jump=3, n_components=2,
        generator=w.gen(0), n_codes=8, teacher_iters=2, seed_rounds=2)
    for f, v in got["params"].items():
        np.testing.assert_allclose(v, getattr(want, f).numpy(), rtol=1e-4, atol=1e-4, err_msg=f)


def test_quantize_hooks(dirs, tmp_path):
    """shard_ids / write_manifest: two partial writers produce the one
    writer's directory."""
    reader = _reader(dirs["frames"])
    cb = hmm_gaussian.fit_codebook_reservoir(reader, 8, generator=w.gen(0))
    hmm_gaussian.quantize_shards_streaming(reader, tmp_path / "one", codebook=cb)
    hmm_gaussian.quantize_shards_streaming(reader, tmp_path / "two", codebook=cb,
                                           shard_ids=[1], write_manifest=False)
    assert not (tmp_path / "two" / "manifest.json").exists()
    hmm_gaussian.quantize_shards_streaming(reader, tmp_path / "two", codebook=cb,
                                           shard_ids=[0, 2])
    for f in sorted(p.name for p in (tmp_path / "one").iterdir()):
        assert (tmp_path / "one" / f).read_bytes() == (tmp_path / "two" / f).read_bytes(), f
    np.testing.assert_array_equal(torch.cat([c.src for c in _reader(tmp_path / "two").shards()]),
                                  torch.cat([c.src for c in _reader(tmp_path / "one").shards()]))
