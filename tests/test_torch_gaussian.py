"""Port Gaussian / GMM-emission HMM vs the JAX reference, on the CPU.

The frame corpus comes from the same numpy generator on both sides (and
must be identical, dtype included); parameters are drawn by the reference
and carried across with ``params_from_numpy``; k-means gets the same
initial codebook on both sides.  The corpus is padded with zero-length
utterances.  Tolerances, and why:

- one E-step's statistics and loglik: rtol 1e-5 on the loglik, rtol 1e-4
  (atol 1e-4 x the statistic's scale) on the moments.  Both sides sum the
  same float32 terms in another order over ~10^3 frames;
- one M-step from the same statistics: rtol/atol 1e-5 (elementwise);
- EM trajectories: the reference's own bound for parameters after several
  iterations, rtol 1e-3 atol 1e-3 (tests/test_hmm_estep_pallas.py:102-114),
  and rtol 1e-5 on each iteration's loglik;
- decode: exact equality of the alignment (same float32 ops, ties to the
  lowest state on both sides);
- the float64 NumPy oracle: rtol 1e-4 on the loglik and rtol/atol 5e-3 on
  the parameters (tests/test_hmm_gaussian.py:124-136).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.core import counts as jcounts
from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data.corpus import Corpus as JCorpus
from multimodalworddiscovery_tpu.data.synthetic import phones_to_frames as jax_frames
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu.models import hmm_gaussian as jg
from multimodalworddiscovery_tpu.oracles.numpy_hmm_gaussian import NumpyGaussianHMM
from multimodalworddiscovery_tpu_torch.core import counts as tcounts
from multimodalworddiscovery_tpu_torch.data import Corpus
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import phones_to_frames as torch_frames
from multimodalworddiscovery_tpu_torch.frontend import vq as tvq
from multimodalworddiscovery_tpu_torch.models import hmm as thmm
from multimodalworddiscovery_tpu_torch.models import hmm_gaussian as tg

GEN = dict(n_utterances=24, seed=7)
FRAMES = dict(feat_dim=8, seed=7)
N_EMPTY = 3
FIELDS = ("means", "log_vars", "log_mix", "log_jump", "log_p0")


def _np(x):
    return np.asarray(x)


def _to_torch(jp):
    return tg.params_from_numpy(*(_np(getattr(jp, f)) for f in FIELDS), jp.max_jump,
                                device="cpu")


def _close_params(tp, jp, rtol, atol):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tp, f).numpy(), _np(getattr(jp, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


@pytest.fixture(scope="module")
def frames():
    pc_j, pg_j, _ = jax_make(**GEN)
    pc_t, pg_t, _ = torch_make(**GEN, device="cpu")
    jc, jgold, _ = jax_frames(pc_j, pg_j, **FRAMES)
    tc, tgold, _ = torch_frames(pc_t, pg_t, **FRAMES, device="cpu")
    jc, tc = jc.pad_to(jc.n + N_EMPTY), tc.pad_to(tc.n + N_EMPTY)
    gold = np.zeros((tc.n, tc.max_src_len), np.int32)
    gold[: jgold.alignment.shape[0]] = jgold.alignment
    return jc, tc, gold


@pytest.fixture(scope="module")
def params(frames):
    """Reference parameters with K=2 components, one EM step from init (so
    they are not the symmetric start), and their port copy."""
    jc, _, _ = frames
    jp = jg.init(jc, max_jump=3, n_components=2, key=jax.random.PRNGKey(1))
    jp, _ = jg.em_step(jp, jc)
    return jp, _to_torch(jp)


@pytest.mark.parametrize("seed", [0, 7])
def test_frame_corpus_identical_to_jax(seed):
    """phones_to_frames gives the reference's frames, gold and phone means,
    with float32 frames (the corpus used to cast every src to int32)."""
    pc_j, pg_j, _ = jax_make(n_utterances=12, seed=seed)
    pc_t, pg_t, _ = torch_make(n_utterances=12, seed=seed, device="cpu")
    jc, jgold, jmeans = jax_frames(pc_j, pg_j, feat_dim=6, seed=seed)
    tc, tgold, tmeans = torch_frames(pc_t, pg_t, feat_dim=6, seed=seed, device="cpu")
    for field in ("src", "src_len", "trg", "trg_len"):
        want, got = _np(getattr(jc, field)), getattr(tc, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert tc.src.dtype == torch.float32 and tc.src.ndim == 3
    assert (tc.src_vocab, tc.trg_vocab) == (jc.src_vocab, jc.trg_vocab)
    np.testing.assert_array_equal(tgold.alignment, jgold.alignment)
    assert tgold.segments == jgold.segments
    np.testing.assert_array_equal(tmeans, jmeans)
    np.testing.assert_array_equal(tc.trg_mask().numpy(), _np(jc.trg_mask()))


def test_from_ragged_keeps_float_frames():
    rng = np.random.default_rng(0)
    seqs = [rng.normal(size=(k, 3)).astype(np.float32) for k in (4, 2)]
    trg = [np.array([1, 2]), np.array([3])]
    want = JCorpus.from_ragged(seqs, trg, trg_vocab=4)
    got = Corpus.from_ragged(seqs, trg, trg_vocab=4, device="cpu")
    assert got.src.dtype == torch.float32 and got.trg.dtype == torch.int32
    np.testing.assert_array_equal(got.src.numpy(), _np(want.src))
    np.testing.assert_array_equal(got.pad_to(3).src.numpy(), _np(want.pad_to(3).src))
    with pytest.raises(ValueError, match="trg ids"):
        Corpus.from_ragged(seqs, [np.array([1, 9]), np.array([3])], trg_vocab=4, device="cpu")


@pytest.mark.parametrize("k", [3, 40])
def test_select_columns_matches_jax(k):
    rng = np.random.default_rng(k)
    values = rng.normal(size=(5, 7, 50)).astype(np.float32)
    cols = rng.integers(0, 50, size=(5, k)).astype(np.int32)
    want = _np(jcounts.select_columns(jnp.asarray(values), jnp.asarray(cols)))
    got = tcounts.select_columns(torch.as_tensor(values), torch.as_tensor(cols))
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_moments_and_diagonal_seeding_match_jax(frames):
    """The seeding statistics and the diagonal flat-start means of every
    concept the diagonal sees (only unseen concepts take the random
    jitter, which the two packages draw from different generators)."""
    jc, tc, _ = frames
    shift_j, shift_t = jg.feature_shift(jc), tg.feature_shift(tc)
    np.testing.assert_allclose(shift_t.numpy(), _np(shift_j), rtol=1e-5, atol=1e-6)
    mj, mt = jg.init_moments(jc, shift_j), tg.init_moments(tc, shift_t)
    for name in mj:
        np.testing.assert_allclose(mt[name].numpy(), _np(mj[name]), rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    jp = jg.init_diagonal(jc, max_jump=3, key=jax.random.PRNGKey(0))
    tp = tg.init_diagonal(tc, max_jump=3, generator=torch.Generator().manual_seed(0))
    seen = _np(mj["ccnt"]) > 0
    assert seen.sum() > 10 and not seen[0]
    np.testing.assert_allclose(tp.means.numpy()[seen], _np(jp.means)[seen], rtol=1e-5, atol=1e-5)
    for f in ("log_vars", "log_mix", "log_jump", "log_p0"):
        np.testing.assert_allclose(getattr(tp, f).numpy(), _np(getattr(jp, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    # the same generator seed gives the same parameters
    tp2 = tg.init_diagonal(tc, max_jump=3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tp.means, tp2.means)


@pytest.mark.parametrize("n_components", [1, 2])
def test_component_logdensity_matches_jax(frames, n_components):
    jc, tc, _ = frames
    jp = jg.init(jc, n_components=n_components, key=jax.random.PRNGKey(n_components))
    tp = _to_torch(jp)
    want = _np(jg._component_logdensity(jp, jc))
    got = tg._component_logdensity(tp, tc).numpy()
    # x @ (mu/var) - x^2 @ (.5/var) + const: float32 cancellation of terms
    # of size ~|x|^2/var, so an absolute bound on top of the relative one
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tg._log_emissions(tp, tc).numpy(),
                               _np(jg._log_emissions(jp, jc)), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_expected_counts_matches_jax(frames, params, use_kernels):
    """One annealed E-step (emit_scale 0.5): the plain dense route and K4's
    plain version against the reference's scan E-step."""
    jc, tc, _ = frames
    jp, tp = params
    want, ll_w = jg.expected_counts(jp, jc, emit_scale=0.5)
    got, ll_g = tg.expected_counts(tp, tc, use_kernels=use_kernels, emit_scale=0.5)
    np.testing.assert_allclose(float(ll_g), float(ll_w), rtol=1e-5)
    for name in want:
        w = _np(want[name])
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


def test_m_step_matches_jax(frames, params):
    jc, tc, _ = frames
    jp, tp = params
    cj, _ = jg.expected_counts(jp, jc)
    ct = {k: torch.tensor(_np(v)) for k, v in cj.items()}
    _close_params(tg.m_step(tp, ct), jg.m_step(jp, cj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_annealed_train_and_align_match_jax(frames, params, use_kernels):
    jc, tc, _ = frames
    jp0, tp0 = params
    jp, j_lls = jg.train(jp0, jc, 4, anneal=(0.25, 3))
    tp, lls = tg.train(tp0, tc, 4, use_kernels=use_kernels, anneal=(0.25, 3))
    assert tg.anneal_scales(4, (0.25, 3)) == pytest.approx([0.25, 0.625, 1.0, 1.0])
    np.testing.assert_allclose(lls.numpy(), _np(j_lls), rtol=1e-5)
    _close_params(tp, jp, rtol=1e-3, atol=1e-3)
    want = _np(jg.align(jp, jc))
    got = tg.align(_to_torch(jp), tc, use_kernels=use_kernels)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want[-N_EMPTY:] == 0)


def test_loglik_and_posteriors_match_jax(frames, params):
    jc, tc, _ = frames
    jp, tp = params
    np.testing.assert_allclose(float(tg.loglik(tp, tc)), float(jg.loglik(jp, jc)), rtol=1e-5)
    want = _np(jg.posteriors(jp, jc))
    got = tg.posteriors(tp, tc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    # normalized per frame within the reference's bound
    # (tests/test_hmm_gaussian.py:test_posterior_gamma_normalized)
    sums = got.sum(-1)[tc.src_mask().numpy()]
    np.testing.assert_allclose(sums, 1.0, rtol=1e-3)


def test_supervised_fit_matches_jax(frames, params):
    """Gold-pinned GMM fit, with NULL runs injected inside utterances so the
    jump widths are measured across them."""
    jc, tc, gold = frames
    gold = gold.copy()
    gold[: jc.n - N_EMPTY, 2:4] = 0
    jp0, tp0 = params
    want = jg.supervised_fit(jp0, jc, jnp.asarray(gold), num_iterations=2)
    got = tg.supervised_fit(tp0, tc, torch.as_tensor(gold), num_iterations=2)
    _close_params(got, want, rtol=1e-4, atol=1e-4)


def test_kmeans_and_quantize_match_jax(frames):
    """Lloyd's sweeps and the frame -> code assignment from the same initial
    codebook (the two packages draw their seed frames differently)."""
    jc, tc, _ = frames
    x = _np(jc.src).reshape(-1, _np(jc.src).shape[-1])
    w = _np(jc.src_mask()).reshape(-1).astype(np.float32)
    cb0 = x[np.flatnonzero(w)[:: 17][:12]]
    want = _np(jg._kmeans_fit(jnp.asarray(cb0), jnp.asarray(x), jnp.asarray(w),
                              n_codes=12, num_iterations=5))
    got = tg._kmeans_fit(torch.as_tensor(cb0), tc.src.reshape(-1, x.shape[-1]),
                         tc.src_mask().reshape(-1).float(), 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    codes = tvq.quantize(tc, got)
    assert codes.src.dtype == torch.int32 and codes.src_vocab == 12
    np.testing.assert_array_equal(
        codes.src.numpy().reshape(-1), _np(jg._kmeans_assign(jnp.asarray(want), jnp.asarray(x)))
    )
    assert torch.equal(codes.trg, tc.trg) and torch.equal(codes.src_len, tc.src_len)


def test_quantize_frames_codebook_round_trip(frames, tmp_path):
    _, tc, _ = frames
    gen = torch.Generator().manual_seed(4)
    cc = tg.quantize_frames(tc, n_codes=16, generator=gen)
    real = cc.src[tc.src_mask()]
    assert cc.src_vocab == 16 and int(real.min()) >= 0 and int(real.max()) < 16
    assert len(torch.unique(real)) >= 8
    cb = tvq.fit_codebook(tc, n_codes=16, generator=torch.Generator().manual_seed(4))
    assert torch.equal(tvq.quantize(tc, cb).src, cc.src)
    tvq.save_codebook(tmp_path / "cb.npy", cb)
    assert torch.equal(tvq.load_codebook(tmp_path / "cb.npy", device="cpu"), cb)
    with pytest.raises(ValueError, match="real frames"):
        tg.fit_frame_codebook(tc, n_codes=10**6)


def test_seed_from_teacher_matches_jax(frames, params):
    """The VQ-teacher seeding stage from the same code corpus, the same
    discrete teacher and the same base parameters."""
    jc, tc, _ = frames
    jp0, tp0 = params
    jcc = jg.quantize_frames(jc, n_codes=16, key=jax.random.PRNGKey(4))
    tcc = dataclasses.replace(tc, src=torch.tensor(_np(jcc.src)), src_vocab=16)
    jt, _ = jhmm.train(jhmm.init(jcc), jcc, 3)
    tt = thmm.params_from_numpy(_np(jt.log_emit), _np(jt.log_jump), _np(jt.log_p0), jt.max_jump,
                                device="cpu")
    want = jg.seed_from_teacher(jp0, jc, jcc, jt, seed_rounds=2)
    got = tg.seed_from_teacher(tp0, tc, tcc, tt, seed_rounds=2)
    _close_params(got, want, rtol=1e-4, atol=1e-4)
    chunked = tg.seed_from_teacher(tp0, tc, tcc, tt, seed_rounds=2, chunks=3)
    _close_params(chunked, want, rtol=1e-4, atol=1e-4)


def test_em_step_matches_numpy_oracle(frames, params):
    """One EM step against the float64 per-utterance oracle (which imports
    no JAX)."""
    _, tc, _ = frames
    _, tp = params
    n = 10
    sub = tg._take(tc, slice(0, n))
    x, sl = sub.src.numpy(), sub.src_len.numpy()
    trg, tl = sub.trg.numpy(), sub.trg_len.numpy()
    oracle = NumpyGaussianHMM([x[i, : sl[i]] for i in range(n)],
                              [trg[i, : tl[i]] for i in range(n)], sub.trg_vocab,
                              n_components=2)
    oracle.set_params(*(getattr(tp, f).numpy() for f in FIELDS))
    np.testing.assert_allclose(float(tg.loglik(tp, sub)), oracle.loglik(), rtol=1e-4)
    oracle_ll = oracle.em_iteration()
    got, stats = tg.em_step(tp, sub, use_kernels=True)
    np.testing.assert_allclose(float(stats["loglik"]), oracle_ll, rtol=1e-4)
    np.testing.assert_allclose(got.means.numpy(), oracle.means, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got.log_jump.numpy(), oracle.log_jump, rtol=5e-3, atol=5e-3)


def test_vq_teacher_recipe_runs_and_improves(frames):
    """init_vq_teacher -> annealed train on the kernel route's plain
    versions: finite, improving after the ramp, and above chance."""
    _, tc, gold = frames
    pv = tg.init_vq_teacher(tc, max_jump=3, generator=torch.Generator().manual_seed(0),
                            n_codes=16, teacher_iters=4, seed_rounds=2, use_kernels=True)
    tp, lls = tg.train(pv, tc, 5, use_kernels=True, anneal=(0.25, 3))
    assert torch.isfinite(lls).all() and lls[-1] > lls[2]
    pred = tg.align(tp, tc, use_kernels=True).numpy()
    mask = tc.src_mask().numpy() & (gold > 0)
    assert (pred == gold)[mask].mean() > 0.3
