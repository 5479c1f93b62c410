"""The port's out-of-core streaming (data/stream.py and the streaming halves
of hmm_gaussian, frontend/vq, hmm_dnn and minibatch) against the JAX
reference, on the CPU.

The corpora are the reference tests' (tests/test_stream.py): 30 utterances
(10 concepts, 16 phones, seed 3) from the same numpy generator on both
sides, in shards of 8 (the last padded with two zero-length utterances)
or 10; frames of 8 dims (noise 0.1, seed 0).  Tolerances, and why:

- shard files, manifests, gold dumps, reservoirs and code shards: equal
  bit for bit (the on-disk layout is the contract between the packages);
- streamed EM against resident EM: loglik rtol 1e-5, parameters atol 1e-4
  (tests/test_stream.py:68-73 and :127-133; only the float addition order
  differs);
- Lloyd's sweeps, and the MLP weights after streamed DNN-HMM shard steps,
  against JAX from the same starting point: atol 1e-5 (float32 sums in
  another order); the shard's counts (sums of about 70) and loglik rtol
  1e-5;
- streamed moments against the resident init: rtol 1e-5, atol 1e-2 on
  means near 3000 (tests/test_stream.py:76-113).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crf_reference import mlp_to_numpy, to_jax
from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data import stream as jstream
from multimodalworddiscovery_tpu.data.synthetic import phones_to_frames as jax_frames
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu.models import hmm_dnn as jdnn
from multimodalworddiscovery_tpu.models import hmm_gaussian as jg
from multimodalworddiscovery_tpu.models import model1 as jm1
from multimodalworddiscovery_tpu.models import segmental_kmeans as jskm
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import phones_to_frames as torch_frames
from multimodalworddiscovery_tpu_torch.data import stream as tstream
from multimodalworddiscovery_tpu_torch.frontend import vq as tvq
from multimodalworddiscovery_tpu_torch.models import attention
from multimodalworddiscovery_tpu_torch.models import hmm as thmm
from multimodalworddiscovery_tpu_torch.models import hmm_dnn as tdnn
from multimodalworddiscovery_tpu_torch.models import hmm_gaussian as tg
from multimodalworddiscovery_tpu_torch.models import minibatch as tmb
from multimodalworddiscovery_tpu_torch.models import model1 as tm1
from multimodalworddiscovery_tpu_torch.models import segmental_kmeans as tskm

GEN = dict(n_utterances=30, n_concepts=10, n_phones=16, seed=3)
FRAMES = dict(feat_dim=8, noise=0.1, seed=0)
G_FIELDS = ("means", "log_vars", "log_mix", "log_jump", "log_p0")
MODS = {"model1": (jm1, tm1), "hmm": (jhmm, thmm)}


def _reader(d):
    return tstream.ShardedCorpusReader(d, device="cpu")


def _arrays(corpus):
    return {f: np.asarray(getattr(corpus, f)) for f in tstream.FIELDS}


def _g_to_torch(jp):
    return tg.params_from_numpy(*(np.asarray(getattr(jp, f)) for f in G_FIELDS),
                                jp.max_jump, device="cpu")


@pytest.fixture(scope="module")
def corpora():
    """(JAX corpus, JAX gold, port corpus, port gold)."""
    jc, jgold, _ = jax_make(**GEN)
    tc, tgold, _ = torch_make(**GEN, device="cpu")
    return jc, jgold, tc, tgold


@pytest.fixture(scope="module")
def frames(corpora):
    """(JAX frames, JAX frame gold, port frames, port frame gold)."""
    jc, jgold, tc, tgold = corpora
    jf, jfg, _ = jax_frames(jc, jgold, **FRAMES)
    tf, tfg, _ = torch_frames(tc, tgold, **FRAMES, device="cpu")
    return jf, jfg, tf, tfg


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory, corpora, frames):
    """Shard directories written by the JAX package: the phone corpus in 8s
    with gold, the frames in 8s with gold, and the frames in 10s."""
    jc, jgold, _, _ = corpora
    jf, jfg, _, _ = frames
    d = tmp_path_factory.mktemp("jax_shards")
    assert jstream.write_shards(jc, d / "ids", 8, gold=jgold) == 4
    jstream.write_shards(jf, d / "f8", 8, gold=jfg)
    jstream.write_shards(jf, d / "f10", 10)
    return d


@pytest.fixture(scope="module")
def jax_resident():
    """The JAX package's resident runs, memoized across tests (one compile
    each)."""
    return {}


def _files(d):
    return sorted(p.name for p in d.iterdir())


# ---- the on-disk layout ---------------------------------------------------


@pytest.mark.parametrize("case", ["ids", "ids_shuffled", "frames_f16"])
def test_write_shards_files_equal_jax(tmp_path, corpora, frames, case):
    """The port writes the JAX package's shard files byte for byte, its
    manifest and its gold dump."""
    jc, jgold, tc, tgold = corpora
    kw = {"ids": {}, "ids_shuffled": {"shuffle": 3},
          "frames_f16": {"storage_dtype": "float16"}}[case]
    if case == "frames_f16":
        jc, jgold, tc, tgold = frames
    nj = jstream.write_shards(jc, tmp_path / "j", 8, gold=jgold, **kw)
    nt = tstream.write_shards(tc, tmp_path / "t", 8, gold=tgold, **kw)
    assert nj == nt == 4
    assert _files(tmp_path / "j") == _files(tmp_path / "t")
    for name in _files(tmp_path / "j"):
        a, b = (tmp_path / "j" / name), (tmp_path / "t" / name)
        if name.endswith(".npy"):
            assert a.read_bytes() == b.read_bytes(), name
        else:
            assert json.loads(a.read_text()) == json.loads(b.read_text()), name


def test_jax_shards_read_by_port(jax_shards, corpora):
    """A JAX-written directory through the port's reader: every shard, the
    padding rows, the bounds check and ``materialize`` with its gold."""
    jc, jgold, _, _ = corpora
    r = _reader(jax_shards / "ids")
    jr = jstream.ShardedCorpusReader(jax_shards / "ids")
    assert (r.num_shards, r.shard_size, r.n) == (4, 8, 30)
    assert (r.shuffle_seed, r.storage_dtype) == (None, None)
    for k, shard in enumerate(r.shards(prefetch=2)):
        want = _arrays(jr.load_shard(k))
        for f, got in _arrays(shard).items():
            np.testing.assert_array_equal(got, want[f], err_msg=f"{f} {k}")
        assert (shard.src_vocab, shard.trg_vocab) == (jc.src_vocab, jc.trg_vocab)
    assert int(r.load_shard(3).src_len[-2:].sum()) == 0  # zero-length padding
    with pytest.raises(IndexError):
        r.load_shard(4)
    full, gold = r.materialize()
    for f, got in _arrays(full).items():
        np.testing.assert_array_equal(got, np.asarray(getattr(jc, f)), err_msg=f)
    np.testing.assert_array_equal(gold.alignment, jgold.alignment)
    assert gold.segments == [[tuple(s) for s in seg] for seg in jgold.segments]


def test_port_shards_read_by_jax(tmp_path, frames):
    """The reverse direction, with float16 storage and a shuffle."""
    _, _, tf, tfg = frames
    tstream.write_shards(tf, tmp_path, 10, gold=tfg, shuffle=5, storage_dtype="float16")
    jr = jstream.ShardedCorpusReader(tmp_path)
    assert (jr.shuffle_seed, jr.storage_dtype) == (5, "float16")
    full, gold = jr.materialize()
    perm = np.random.default_rng(5).permutation(30)
    rounded = tf.src.numpy().astype(np.float16).astype(np.float32)[perm]
    np.testing.assert_array_equal(np.asarray(full.src), rounded)
    np.testing.assert_array_equal(np.asarray(full.trg), tf.trg.numpy()[perm])
    np.testing.assert_array_equal(gold.alignment, tfg.alignment[perm])
    mine, my_gold = _reader(tmp_path).materialize()
    np.testing.assert_array_equal(mine.src.numpy(), np.asarray(full.src))
    assert my_gold.segments == [tfg.segments[i] for i in perm]


@pytest.mark.parametrize("storage_dtype", [None, "float16"])
def test_shard_writer_matches_write_shards(tmp_path, frames, storage_dtype):
    """Batches appended to the port's ShardWriter give the JAX package's
    write_shards files byte for byte, and its misuse errors."""
    jf, jfg, tf, tfg = frames
    jstream.write_shards(jf, tmp_path / "a", 8, gold=jfg, storage_dtype=storage_dtype)
    with tstream.ShardWriter(tmp_path / "b", 8, storage_dtype=storage_dtype) as w:
        for lo in range(0, tf.n, 8):
            sl = slice(lo, min(lo + 8, tf.n))
            batch = tstream.Corpus(tf.src[sl], tf.src_len[sl], tf.trg[sl], tf.trg_len[sl],
                                   tf.src_vocab, tf.trg_vocab)
            assert w.append(batch, gold_alignment=tfg.alignment[sl]) == lo // 8
    for k in range(4):
        for f in tstream.FIELDS:
            name = f"{f}_{k}.npy"
            assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    ra, rb = jstream.ShardedCorpusReader(tmp_path / "a"), _reader(tmp_path / "b")
    assert (ra.num_shards, ra.shard_size, ra.n, ra.storage_dtype) == (
        rb.num_shards, rb.shard_size, rb.n, rb.storage_dtype)
    np.testing.assert_array_equal(rb.materialize()[1].alignment, jfg.alignment)
    with pytest.raises(ValueError, match="shard_size"):
        tstream.ShardWriter(tmp_path / "c", shard_size=4).append(tf)
    w2 = tstream.ShardWriter(tmp_path / "d", shard_size=tf.n)
    w2.append(tf)
    small = tstream.Corpus(tf.src[:, :5], torch.clamp(tf.src_len, max=5), tf.trg, tf.trg_len,
                           tf.src_vocab, tf.trg_vocab)
    with pytest.raises(ValueError, match="drift"):
        w2.append(small)
    with pytest.raises(ValueError, match="storage_dtype"):
        tstream.ShardWriter(tmp_path / "e", 8, storage_dtype="bfloat16")


def test_manifest_without_shuffle_or_storage_keys(tmp_path, corpora):
    """Manifests older than the shuffle and storage options still read."""
    jc, _, _, _ = corpora
    jstream.write_shards(jc, tmp_path, 8)
    m = json.loads((tmp_path / "manifest.json").read_text())
    del m["shuffle_seed"], m["storage_dtype"]
    (tmp_path / "manifest.json").write_text(json.dumps(m))
    r = _reader(tmp_path)
    assert (r.shuffle_seed, r.storage_dtype) == (None, None)
    np.testing.assert_array_equal(r.materialize()[0].src.numpy(), np.asarray(jc.src))


def test_float16_storage_load_and_size(tmp_path, frames):
    """float16 storage: the float field halves on disk, load_shard upcasts
    to exactly the float16 rounding, int fields are untouched."""
    _, _, tf, _ = frames
    tstream.write_shards(tf, tmp_path / "f32", 10)
    tstream.write_shards(tf, tmp_path / "f16", 10, storage_dtype="float16")
    s32, s16 = _reader(tmp_path / "f32").load_shard(0), _reader(tmp_path / "f16").load_shard(0)
    assert s16.src.dtype == torch.float32 and s16.trg.dtype == s32.trg.dtype
    np.testing.assert_array_equal(s16.src.numpy(),
                                  s32.src.numpy().astype(np.float16).astype(np.float32))
    sz32 = (tmp_path / "f32" / "src_0.npy").stat().st_size
    sz16 = (tmp_path / "f16" / "src_0.npy").stat().st_size
    assert sz16 < 0.55 * sz32


# ---- streamed EM ----------------------------------------------------------


def _jax_train(cache, key, fn):
    if key not in cache:
        cache[key] = fn()
    return cache[key]


@pytest.mark.parametrize("mod_name", ["model1", "hmm"])
@pytest.mark.parametrize("prefetch", [1, 3])
def test_streaming_em_matches_jax(jax_shards, corpora, jax_resident, mod_name, prefetch):
    """Streamed EM over JAX-written shards equals the JAX package's
    resident EM (Model-1's statistics recounted per shard)."""
    jc, _, _, _ = corpora
    jmod, tmod = MODS[mod_name]
    r = _reader(jax_shards / "ids")
    ps, lls = tstream.train_streaming(tmod, tmod.init(r.load_shard(0)), r, 3,
                                      prefetch=prefetch, use_kernels=False)
    pr, lls_ref = _jax_train(jax_resident, mod_name, lambda: jax.jit(
        lambda p, c: jmod.train(p, c, 3))(jmod.init(jc), jc))
    np.testing.assert_allclose(lls, np.asarray(lls_ref), rtol=1e-5)
    for name, got in vars(ps).items():
        if isinstance(got, torch.Tensor):
            np.testing.assert_allclose(got.numpy(), np.asarray(getattr(pr, name)), atol=1e-4)


@pytest.mark.parametrize("annealed", [False, True])
def test_streaming_gaussian_matches_jax(jax_shards, frames, annealed):
    """Streamed Gaussian EM (with the anneal ramp as ``scale_schedule``)
    from the JAX package's initial parameters equals its resident EM."""
    jf, _, _, _ = frames
    jp0 = jg.init(jf, key=jax.random.PRNGKey(0))
    r = _reader(jax_shards / "f10")
    if annealed:
        sched = np.concatenate([np.linspace(0.3, 1.0, 3), np.ones(1)])
        ps, lls = tstream.train_streaming(tg, _g_to_torch(jp0), r, 4, scale_schedule=sched)
        pr, lls_ref = jax.jit(lambda p, c: jg.train(p, c, 4, anneal=(0.3, 3)))(jp0, jf)
    else:
        ps, lls = tstream.train_streaming(tg, _g_to_torch(jp0), r, 2, prefetch=2)
        pr, lls_ref = jax.jit(lambda p, c: jg.train(p, c, 2))(jp0, jf)
    np.testing.assert_allclose(lls, np.asarray(lls_ref), rtol=1e-5)
    np.testing.assert_allclose(ps.means.numpy(), np.asarray(pr.means), atol=1e-4)


def test_float16_storage_em_matches_resident_on_rounded(tmp_path, frames):
    """Streamed EM on float16 shards equals resident EM on the
    float16-rounded corpus: the rounding happens once, at write time."""
    jf, _, tf, _ = frames
    tstream.write_shards(tf, tmp_path, 10, storage_dtype="float16")
    rounded = jf.replace(src=jnp.asarray(
        np.asarray(jf.src).astype(np.float16).astype(np.float32)))
    jp0 = jg.init(rounded, key=jax.random.PRNGKey(0))
    ps, lls = tstream.train_streaming(tg, _g_to_torch(jp0), _reader(tmp_path), 2)
    pr, lls_ref = jax.jit(lambda p, c: jg.train(p, c, 2))(jp0, rounded)
    np.testing.assert_allclose(lls, np.asarray(lls_ref), rtol=1e-5)
    np.testing.assert_allclose(ps.means.numpy(), np.asarray(pr.means), atol=1e-4)


def test_streaming_segmental_kmeans_matches_resident(jax_shards, frames):
    """ES-KMeans statistics are additive: streamed over the padded shards
    of 8 it equals the resident port and the JAX package's resident run
    from the same centroids."""
    jf, _, tf, _ = frames
    p0 = tskm.init(tf, n_clusters=12, generator=torch.Generator().manual_seed(0))
    r = _reader(jax_shards / "f8")
    ps, lls = tstream.train_streaming(tskm, p0, r, 3)
    pr, lls_res = tskm.train(p0, tf, 3)
    np.testing.assert_allclose(lls, lls_res.numpy(), rtol=1e-5)
    np.testing.assert_allclose(ps.centroids.numpy(), pr.centroids.numpy(), atol=1e-4)
    jp = jskm.SegKMeansParams(centroids=jnp.asarray(p0.centroids.numpy()))
    for _ in range(3):
        jp, _ = jskm.em_step(jp, jf)
    np.testing.assert_allclose(ps.centroids.numpy(), np.asarray(jp.centroids), atol=1e-4)


def test_degenerate_single_utterance(tmp_path):
    """One utterance in one mostly padded shard."""
    tc, _, _ = torch_make(n_utterances=1, n_concepts=5, n_phones=8, seed=0, device="cpu")
    tstream.write_shards(tc, tmp_path, 4)
    r = _reader(tmp_path)
    assert (r.num_shards, r.n) == (1, 1)
    ps, lls = tstream.train_streaming(thmm, thmm.init(r.load_shard(0)), r, 2)
    pr, lls_ref = thmm.train(thmm.init(tc), tc, 2)
    np.testing.assert_allclose(lls, lls_ref.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(r.materialize()[0].src.numpy(), tc.src.numpy())


def test_stream_counts_match_single_call(jax_shards, corpora):
    """The counts summed over the shards equal one E-step on the padded
    corpus, and the JAX package's."""
    jc, _, tc, _ = corpora
    r = _reader(jax_shards / "ids")
    params = thmm.init(tc)
    (emit_s, width_s), ll_s = tstream.stream_expected_counts(
        thmm.expected_counts, params, r, prefetch=2)
    (emit_r, width_r), ll_r = thmm.expected_counts(params, tc.pad_to(32))
    np.testing.assert_allclose(float(ll_s), float(ll_r), rtol=1e-6)
    np.testing.assert_allclose(emit_s.numpy(), emit_r.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(width_s.numpy(), width_r.numpy(), rtol=1e-4)
    (_, jwidth), jll = jhmm.expected_counts(jhmm.init(jc), jc)
    np.testing.assert_allclose(float(ll_s), float(jll), rtol=1e-5)
    np.testing.assert_allclose(width_s.numpy(), np.asarray(jwidth), rtol=1e-4)


def test_mesh_forms_raise(jax_shards):
    """The streaming mesh forms take a 1-D DeviceMesh (they run on gloo
    ranks in tests/test_torch_multihost.py): any other object is a
    TypeError."""
    r = _reader(jax_shards / "ids")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstream.train_streaming(thmm, thmm.init(r.load_shard(0)), r, 1, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmb.train_minibatch_streaming(attention.em_step, None, r, 4, 1, mesh=object())


# ---- the Gaussian streaming half ------------------------------------------


def test_reservoir_frames_match_jax(tmp_path, jax_shards, frames):
    """The frame reservoir is the JAX package's bit for bit: the whole
    corpus, samples, shard subsets with their keys, and float16 shards."""
    jf, _, tf, _ = frames
    r = _reader(jax_shards / "f8")
    jr = jstream.ShardedCorpusReader(jax_shards / "f8")
    for n_sample, seed in ((10**6, 1), (100, 2), (64, 0)):
        np.testing.assert_array_equal(tg._reservoir_frames(r, n_sample, seed=seed),
                                      jg._reservoir_frames(jr, n_sample, seed=seed))
    got = tg._reservoir_frames(r, 64, seed=0, shards=range(1, 4, 2), return_keys=True)
    want = jg._reservoir_frames(jr, 64, seed=0, shards=range(1, 4, 2), return_keys=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    all_frames = tf.src.numpy()[tf.src_mask().numpy()]
    assert tg._reservoir_frames(r, 10**6).shape == all_frames.shape
    tstream.write_shards(tf, tmp_path, 10, storage_dtype="float16")
    b16 = tg._reservoir_frames(_reader(tmp_path), 64, seed=5)
    assert b16.dtype == np.float32
    np.testing.assert_array_equal(
        b16, jg._reservoir_frames(jstream.ShardedCorpusReader(tmp_path), 64, seed=5))


def test_fit_codebook_reservoir_matches_jax_lloyd(jax_shards):
    """Lloyd's sweeps on the reservoir from the same initial rows (drawn on
    the CPU generator) equal the JAX package's ``_kmeans_fit``; the VQ
    frontend's streaming fit is the same protocol."""
    r = _reader(jax_shards / "f8")
    cb = tg.fit_codebook_reservoir(r, n_codes=16, generator=torch.Generator().manual_seed(5))
    frames_ = tg._reservoir_frames(r, 65536)
    idx0 = torch.multinomial(torch.ones(frames_.shape[0], dtype=torch.float64), 16,
                             replacement=False, generator=torch.Generator().manual_seed(5))
    flat = jnp.asarray(frames_)
    want = jg._kmeans_fit(flat[idx0.numpy()], flat, jnp.ones(flat.shape[0]), n_codes=16,
                          num_iterations=10)
    np.testing.assert_allclose(cb.numpy(), np.asarray(want), atol=1e-5)
    again = tvq.fit_codebook_streaming(r, n_codes=16, generator=torch.Generator().manual_seed(5))
    assert torch.equal(again, cb)
    with pytest.raises(ValueError, match="real frames"):
        tg.fit_codebook_reservoir(r, n_codes=16, frames=frames_[:8])


def test_quantize_shards_streaming_matches_jax(tmp_path, jax_shards):
    """One codebook, two packages: the same code shards, lengths, targets,
    gold and manifest."""
    r = _reader(jax_shards / "f8")
    cb = tg.quantize_shards_streaming(r, tmp_path / "t", n_codes=16,
                                      generator=torch.Generator().manual_seed(4))
    jg.quantize_shards_streaming(jstream.ShardedCorpusReader(jax_shards / "f8"),
                                 tmp_path / "j", codebook=jnp.asarray(cb.numpy()))
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    for name in _files(tmp_path / "t"):
        a, b = tmp_path / "t" / name, tmp_path / "j" / name
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=name)
        else:
            assert json.loads(a.read_text()) == json.loads(b.read_text()), name
    cr = _reader(tmp_path / "t")
    assert cr.src_vocab == 16 and cr.num_shards == 4
    codes = cr.materialize()[0].src.numpy()
    assert codes.dtype == np.int32 and codes.min() >= 0 and codes.max() < 16


def test_streamed_moments_match_resident_init(tmp_path, frames):
    """Moments summed over the shards, about shard 0's feature mean, give
    the resident init and init_diagonal for the same generator seed, even
    with a large offset that a one-pass variance would cancel."""
    _, _, tf, _ = frames
    fc = tstream.Corpus(tf.src + 3000.0, tf.src_len, tf.trg, tf.trg_len, tf.src_vocab,
                        tf.trg_vocab)
    tstream.write_shards(fc, tmp_path, 8)
    r = _reader(tmp_path)
    shift = tg.feature_shift(r.load_shard(0))
    moments = tstream.tree_sum_bounded(tg.init_moments(s, shift) for s in r.shards())
    for mode, ref_fn in (("global", tg.init), ("diagonal", tg.init_diagonal)):
        got = tg.init_from_moments(moments, n_components=2, mode=mode, shift=shift,
                                   generator=torch.Generator().manual_seed(3))
        want = ref_fn(fc, n_components=2, generator=torch.Generator().manual_seed(3))
        np.testing.assert_allclose(got.means.numpy(), want.means.numpy(), rtol=1e-5,
                                   atol=1e-2, err_msg=mode)
        np.testing.assert_allclose(got.log_vars.numpy(), want.log_vars.numpy(), atol=1e-2)
        assert np.all(want.log_vars.numpy() > -5), "variance collapsed"


def test_vq_teacher_streaming_matches_resident_stages(tmp_path, jax_shards, frames):
    """The out-of-core recipe equals its resident stages run on the same
    code corpus: the teacher's EM on the materialized code shards, then
    ``seed_from_teacher`` from the base of the same generator seed."""
    _, _, tf, _ = frames
    r = _reader(jax_shards / "f8")
    kw = dict(max_jump=3, n_components=2, n_codes=16)
    ps = tg.init_vq_teacher_streaming(r, tmp_path / "codes", **kw, teacher_iters=4,
                                      seed_rounds=2, prefetch=2,
                                      generator=torch.Generator().manual_seed(0))
    codes, _ = _reader(tmp_path / "codes").materialize()
    tp, _ = thmm.train(thmm.init(codes, max_jump=3), codes, 4)
    base = tg.init(tf, max_jump=3, n_components=2, generator=torch.Generator().manual_seed(0))
    want = tg.seed_from_teacher(base, tf, codes, tp, seed_rounds=2)
    for f in G_FIELDS:
        np.testing.assert_allclose(getattr(ps, f).numpy(), getattr(want, f).numpy(),
                                   atol=1e-3, err_msg=f)


# ---- the DNN-HMM ----------------------------------------------------------


def test_streamed_shard_step_matches_jax(jax_shards, frames):
    """One shard's step (posteriors, counts, n_sgd Adam steps) from weights
    carried across equals the JAX package's, and the next shard's step
    chains from the stepped weights and Adam state."""
    _, _, tf, _ = frames
    tp = tdnn.init(tf, hidden=32, n_sgd=2, generator=torch.Generator().manual_seed(0))
    jp = to_jax(tp)
    r = _reader(jax_shards / "f10")
    jr = jstream.ShardedCorpusReader(jax_shards / "f10")
    for k in range(2):
        tp, counts, ll = tdnn.streamed_shard_step(tp, r.load_shard(k))
        jp, jcounts, jll = jdnn.streamed_shard_step(jp, jr.load_shard(k))
        np.testing.assert_allclose(float(ll), float(jll), rtol=1e-5)
        for name in ("prior", "width"):
            np.testing.assert_allclose(counts[name].numpy(), np.asarray(jcounts[name]),
                                       rtol=1e-5)
        got = mlp_to_numpy(tp.mlp)["params"]
        for name, layer in jp.mlp["params"].items():
            for w in ("kernel", "bias"):
                np.testing.assert_allclose(got[name][w], np.asarray(layer[w]), atol=1e-5,
                                           err_msg=f"shard {k} {name}.{w}")
    assert tp.opt_state["mlp"].count == 4


def test_dnn_train_streaming_improves_and_keeps_its_input(jax_shards, frames):
    _, _, tf, _ = frames
    p0 = tdnn.init(tf, hidden=32, generator=torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in p0.mlp.parameters()]
    ps, lls = tdnn.train_streaming(p0, _reader(jax_shards / "f10"), 4, prefetch=2)
    assert len(lls) == 4 and lls[-1] > lls[0]
    assert all(torch.equal(a, b) for a, b in zip(before, p0.mlp.parameters()))
    assert ps.opt_state["mlp"].count == 4 * 3 * p0.n_sgd  # 3 shards an iteration


# ---- streamed minibatch SGD -----------------------------------------------


def _rows(corpus):
    return {tuple(row) for row in corpus.src.numpy().tolist()}


def test_minibatch_streaming_cycle_and_padding(jax_shards):
    """Shards are visited cyclically, ``steps_per_shard`` steps each, and
    every batch comes from the resident shard's real rows."""
    r = _reader(jax_shards / "ids")
    shards = [r.load_shard(k) for k in range(r.num_shards)]
    seen = []

    def step_fn(state, batch):
        seen.append(batch)
        return state, {"loglik": batch.src_len.sum().float()}

    _, losses = tmb.train_minibatch_streaming(step_fn, None, r, batch_size=8, num_steps=11,
                                              steps_per_shard=2, seed=3)
    assert len(losses) == 11
    for it, batch in enumerate(seen):
        shard = shards[(it // 2) % r.num_shards]
        real = tstream.Corpus(shard.src[shard.src_len > 0], None, None, None)
        assert bool((batch.src_len > 0).all()), it  # never a padding row
        assert _rows(batch) <= _rows(real), it
    assert losses == [float(b.src_len.sum()) for b in seen]


def test_minibatch_streaming_resumes_the_exact_schedule(jax_shards):
    """A run resumed at ``start_step`` from the state at that step gives the
    uninterrupted run's remaining losses (the draws come from (seed, step))."""
    r = _reader(jax_shards / "ids")

    def fresh():
        return attention.init(r.load_shard(0), dim=16, generator=torch.Generator().manual_seed(0))

    _, full = tmb.train_minibatch_streaming(attention.em_step, fresh(), r, 4, 6, seed=1,
                                            steps_per_shard=2)
    state, first = tmb.train_minibatch_streaming(attention.em_step, fresh(), r, 4, 3, seed=1,
                                                 steps_per_shard=2)
    _, rest = tmb.train_minibatch_streaming(attention.em_step, state, r, 4, 3, seed=1,
                                            steps_per_shard=2, start_step=3)
    np.testing.assert_allclose(first + rest, full, rtol=1e-6)
    g1, g2 = tmb.step_generator(1, 7), tmb.step_generator(1, 7)
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    assert not torch.equal(torch.rand(4, generator=tmb.step_generator(1, 8)),
                           torch.rand(4, generator=tmb.step_generator(1, 7)))


# ---- the primitives (tests/test_stream_primitives.py) ---------------------


@pytest.mark.parametrize("total", [1, 2, 7])
@pytest.mark.parametrize("prefetch", [1, 2, 5])
def test_prefetched_order_and_coverage(total, prefetch):
    calls = []

    def load(k):
        calls.append(k)
        return k * 10

    assert list(tstream.prefetched(load, total, prefetch)) == [k * 10 for k in range(total)]
    assert sorted(calls) == list(range(total))  # each loaded exactly once


def test_prefetched_runs_ahead_and_validates():
    started = []

    def load(k):
        started.append(k)
        return k

    gen = tstream.prefetched(load, 4, prefetch=2)
    assert next(gen) == 0
    deadline = time.monotonic() + 5.0
    while 1 not in started and time.monotonic() < deadline:
        time.sleep(0.005)
    assert 1 in started
    assert list(gen) == [1, 2, 3]
    with pytest.raises(ValueError, match="prefetch"):
        list(tstream.prefetched(lambda k: k, 3, 0))


@pytest.mark.parametrize("n_items", [1, 2, 16, 17, 53])
def test_tree_sum_bounded_matches_direct_sum(n_items):
    rng = np.random.default_rng(n_items)
    items = [{"a": torch.as_tensor(rng.normal(size=(4, 3)).astype(np.float32)),
              "b": (torch.as_tensor(rng.normal(size=(2,)).astype(np.float32)),
                    torch.tensor(float(rng.normal()), dtype=torch.float32))}
             for _ in range(n_items)]
    got = tstream.tree_sum_bounded(iter(items))
    np.testing.assert_allclose(got["a"].numpy(), sum(i["a"].numpy() for i in items), rtol=1e-5)
    np.testing.assert_allclose(got["b"][0].numpy(), sum(i["b"][0].numpy() for i in items),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["b"][1]), sum(float(i["b"][1]) for i in items),
                               rtol=1e-5)


@pytest.mark.parametrize("version", [(1, 0), (2, 0), (3, 0)])
def test_read_npy_into_matches_np_load(tmp_path, version):
    """The reader's one-``readinto`` path reads every ``.npy`` version as
    ``np.load`` does, parses a header once for files that share it, and
    refuses truncated files."""
    rng = np.random.default_rng(0)
    headers = {}
    for i, arr in enumerate((rng.integers(0, 50, (8, 5)).astype(np.int32),
                             rng.normal(size=(8, 5, 3)).astype(np.float16),
                             rng.integers(0, 50, (8, 5)).astype(np.int32),
                             np.zeros((0, 4), np.float32))):
        p = tmp_path / f"a{i}.npy"
        with open(p, "wb") as f:
            np.lib.format.write_array(f, arr, version=version)
        got = tstream.read_npy_into(p, np.empty, headers)
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, np.load(p))
    assert len(headers) == 3  # the two int32 arrays share one header
    bad = tmp_path / "a0.npy"
    bad.write_bytes(bad.read_bytes()[:-4])
    with pytest.raises(ValueError, match="truncated"):
        tstream.read_npy_into(bad, np.empty)
