"""The port's core helpers, dense Viterbi and CRF on minibatches against the
JAX reference, and the port's discrete HMM and metrics against the float64
NumPy oracles, on the CPU.

Inputs come from numpy generators with fixed seeds.  Tolerances, and why:

- ``max_matmul`` (argmax included, ties too) and ``pair_mask``: exact
  (one float32 operation an element, the same in both); ``masked_log``'s
  NEG_INF entries exact and its logs within rtol 3e-7 (XLA's and torch's
  log differ in the last bit);
- the dense ``viterbi``: the JAX path exactly on random continuous inputs
  with ragged lengths (ties are measure-zero there), and equal to the
  factored decoder's path on ``build_log_trans`` inputs after an EM step;
- the discrete HMM against ``oracles/numpy_hmm.NumpyHMM`` (float64): the
  E-step loglik rtol 1e-5, the expected counts atol 1e-4 x their largest,
  the Viterbi alignment on 99% of the frames (float32 against float64 may
  flip a near-tie, as tests/test_hmm.py allows);
- the metrics against ``oracles/numpy_metrics``: rtol 1e-5, as
  tests/test_eval.py holds the reference;
- the CRF on minibatches: three steps from the same parameters and draws
  as the reference's, parameters rtol 1e-3 atol 1e-4 (tests/
  test_torch_hmm_crf.py's em_step bound), then the counterpart of
  tests/test_hmm_crf.py:172 at its size (acc > 0.9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp

from crf_reference import corpora as crf_corpora
from crf_reference import mlp_to_numpy, port_init, to_jax
from multimodalworddiscovery_tpu import segment as jseg
from multimodalworddiscovery_tpu.core import logsemiring as jls
from multimodalworddiscovery_tpu.core import masking as jmask
from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.models import hmm_core as jcore
from multimodalworddiscovery_tpu.models import hmm_crf as jcrf
from multimodalworddiscovery_tpu.models.minibatch import gather_batch as jgather
from multimodalworddiscovery_tpu.oracles import numpy_metrics as om
from multimodalworddiscovery_tpu.oracles.numpy_hmm import NumpyHMM
from multimodalworddiscovery_tpu_torch import core as tcore_pkg
from multimodalworddiscovery_tpu_torch import segment as tseg
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.eval import metrics as tm
from multimodalworddiscovery_tpu_torch.models import hmm as thmm
from multimodalworddiscovery_tpu_torch.models import hmm_core as tcore
from multimodalworddiscovery_tpu_torch.models import hmm_crf as tcrf
from multimodalworddiscovery_tpu_torch.models import minibatch as tmb


def test_core_exports_the_references_helpers():
    for name in ("masked_log", "pair_mask", "log_matmul", "max_matmul"):
        assert hasattr(tcore_pkg, name), name


def test_masked_log_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 1, size=(5, 7)).astype(np.float32)
    p[rng.uniform(size=p.shape) < 0.3] = 0.0
    mask = rng.uniform(size=p.shape) < 0.7
    for m in (None, mask):
        want = np.asarray(jls.masked_log(jnp.asarray(p), None if m is None else jnp.asarray(m)))
        got = tcore_pkg.masked_log(torch.as_tensor(p), None if m is None else torch.as_tensor(m))
        got = got.numpy()
        np.testing.assert_array_equal(got == -1e30, want == -1e30)
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
        assert np.isfinite(got).all()


def test_max_matmul_matches_jax_with_ties():
    """Values and argmax equal, also where whole rows tie (small integers:
    many sums are equal, and both take the first maximum)."""
    rng = np.random.default_rng(1)
    for a, b in (
        (rng.normal(size=(3, 4, 6)), rng.normal(size=(3, 6, 5))),
        (rng.integers(-2, 3, size=(2, 5, 7)), rng.integers(-2, 3, size=(7, 4))),
    ):
        a, b = a.astype(np.float32), b.astype(np.float32)
        jv, ji = jls.max_matmul(jnp.asarray(a), jnp.asarray(b))
        tv, ti = tcore_pkg.max_matmul(torch.as_tensor(a), torch.as_tensor(b))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_pair_mask_matches_jax():
    rng = np.random.default_rng(2)
    sm, tmk = rng.uniform(size=(3, 6)) < 0.6, rng.uniform(size=(3, 4)) < 0.5
    want = np.asarray(jmask.pair_mask(jnp.asarray(sm), jnp.asarray(tmk)))
    got = tcore_pkg.pair_mask(torch.as_tensor(sm), torch.as_tensor(tmk))
    np.testing.assert_array_equal(got.numpy(), want)


def _random_dense(seed: int, n=9, ts=11, s=6):
    rng = np.random.default_rng(seed)
    init = rng.normal(size=(n, s)).astype(np.float32)
    trans = rng.normal(size=(n, s, s)).astype(np.float32)
    emit = rng.normal(size=(n, ts, s)).astype(np.float32)
    lens = rng.integers(0, ts + 1, size=n).astype(np.int32)
    lens[0], lens[1] = ts, 1
    return init, trans, emit, lens


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_viterbi_matches_jax(seed):
    arrays = _random_dense(seed)
    want = np.asarray(jcore.viterbi(*map(jnp.asarray, arrays)))
    got = tcore.viterbi(*map(torch.as_tensor, arrays))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_viterbi_equals_factored():
    """On ``build_log_trans`` inputs (after an EM step) the dense decoder's
    paths equal ``viterbi_factored``'s."""
    tc, _, _ = torch_make(n_utterances=30, seed=4, device="cpu")
    tc = tc.pad_to(tc.n + 3)
    p, _ = thmm.em_step(thmm.init(tc), tc)
    li, lt, le = thmm._machinery(p, tc)
    base, rowz, colmask = tcore.factor_log_trans(p.log_jump, p.log_p0, tc, p.max_jump)
    dense = tcore.viterbi(li, lt, le, tc.src_len)
    fact = tcore.viterbi_factored(li, base, rowz, colmask, le, tc.src_len, use_kernels=False)
    mask = tc.src_mask()
    np.testing.assert_array_equal(torch.where(mask, dense, 0).numpy(),
                                  torch.where(mask, fact, 0).numpy())


# --- the discrete HMM and the metrics against the float64 oracles ---

ORACLE_GEN = dict(n_utterances=24, seed=8)


@pytest.fixture(scope="module")
def oracle_setup():
    tc, gold, _ = torch_make(**ORACLE_GEN, device="cpu")
    sl, tl = tc.src_len.numpy(), tc.trg_len.numpy()
    src = [tc.src[i, : sl[i]].numpy() for i in range(tc.n)]
    trg = [tc.trg[i, : tl[i]].numpy() for i in range(tc.n)]
    return tc, gold, src, trg


def _oracle_counts(oracle: NumpyHMM, src, trg):
    """The oracle's emission counts, from its per-utterance float64
    forward-backward (``NumpyHMM._fb``), as its ``em_iteration`` sums them."""
    counts = np.zeros((oracle.v_src, oracle.v_trg))
    for s, t in zip(src, trg):
        alpha, beta, logz, _, _, concepts, _, _ = oracle._fb(s, t)
        gamma = np.exp(alpha + beta - logz)
        for i in range(len(s)):
            np.add.at(counts, (s[i], concepts), gamma[i])
    return counts


@pytest.mark.parametrize("use_kernels", [False, True])
def test_discrete_hmm_matches_numpy_oracle(oracle_setup, use_kernels):
    """Three EM iterations: each E-step's loglik and counts against the
    oracle's from the same parameters (the port's parameters carried into
    the oracle each iteration), then the Viterbi alignment."""
    tc, _, src, trg = oracle_setup
    oracle = NumpyHMM(src, trg, tc.src_vocab, tc.trg_vocab)
    p = thmm.init(tc)
    w = 2 * p.max_jump + 1
    for it in range(3):
        oracle.log_emit = p.log_emit.double().numpy()
        oracle.log_jump = p.log_jump.double().numpy()
        oracle.log_p0 = float(p.log_p0)
        emit_want = _oracle_counts(oracle, src, trg)
        ll_want = oracle.em_iteration()  # updates the oracle's tables from its counts
        width_want = np.exp(oracle.log_jump) - 1e-8
        p0_want = np.exp(oracle.log_p0) - 1e-8
        (emit, width), ll = thmm.expected_counts(p, tc, use_kernels=use_kernels)
        np.testing.assert_allclose(float(ll), ll_want, rtol=1e-5, err_msg=f"iter {it}")
        for got, want in ((emit.numpy(), emit_want), (width[:w].numpy(), width_want),
                          (width[w].numpy(), p0_want)):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-4 * float(np.abs(want).max()),
                                       err_msg=f"iter {it}")
        p = thmm.m_step(p, (emit, width), smoothing=1e-8)
    oracle.log_emit = p.log_emit.double().numpy()
    oracle.log_jump = p.log_jump.double().numpy()
    oracle.log_p0 = float(p.log_p0)
    got = thmm.align(p, tc, use_kernels=use_kernels).numpy()
    want = oracle.align()
    same = sum(int((got[i, : len(a)] == a).sum()) for i, a in enumerate(want))
    assert same / sum(len(a) for a in want) >= 0.99


def test_forward_logz_matches_oracle(oracle_setup):
    tc, _, src, trg = oracle_setup
    oracle = NumpyHMM(src, trg, tc.src_vocab, tc.trg_vocab)
    want = np.array([oracle._fb(s, t)[2] for s, t in zip(src, trg)])
    li, lt, le = thmm._machinery(thmm.init(tc), tc)
    _, logz = tcore.forward(li, lt, le, tc.src_len)
    np.testing.assert_allclose(logz.numpy(), want, rtol=1e-5)
    assert np.isfinite(logsumexp(want))


@pytest.fixture(scope="module")
def metric_segs():
    jc, jgold, _ = jax_make(n_utterances=40, seed=9)
    tc, _, _ = torch_make(n_utterances=40, seed=9, device="cpu")
    rng = np.random.default_rng(9)
    sl, tl = tc.src_len.numpy(), tc.trg_len.numpy()
    pred = jgold.alignment.copy()
    for i in range(tc.n):
        for t in range(sl[i]):
            if rng.random() < 0.25:
                pred[i, t] = rng.integers(0, tl[i] + 1)
    ps, pm = tseg.segments_from_alignment(torch.as_tensor(pred), tc.trg, tc.src_len)
    gs, gm = tseg.segments_from_alignment(torch.as_tensor(jgold.alignment), tc.trg,
                                          tc.src_len)
    host_p, host_g = tseg.segments_to_host(ps, pm), tseg.segments_to_host(gs, gm)
    # the segmenter against the oracle's per-utterance loop
    assert host_p == [om.segments_from_alignment_np(pred[i], jc.trg[i], sl[i])
                      for i in range(tc.n)]
    assert host_p == jseg.segments_to_host(
        *jseg.segments_from_alignment(jnp.asarray(pred), jc.trg, jc.src_len))
    return tc, jgold, pred, (ps, pm, gs, gm), (host_p, host_g)


def test_metrics_match_numpy_oracle(metric_segs):
    tc, gold, pred, (ps, pm, gs, gm), (host_p, host_g) = metric_segs
    sl = tc.src_len.numpy()

    def close(got, want):
        for k in want:
            np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5, err_msg=k)

    close(tm.alignment_prf(torch.as_tensor(pred), torch.as_tensor(gold.alignment),
                           tc.src_mask()), om.alignment_prf_np(pred, gold.alignment, sl))
    close(tm.word_iou(ps, pm, gs, gm), om.word_iou_np(host_p, host_g))
    pb = tseg.boundaries_from_segments(ps, pm, tc.max_src_len)
    gb = tseg.boundaries_from_segments(gs, gm, tc.max_src_len)
    for tol in (0, 1, 2):
        close(tm.boundary_prf(pb, gb, tolerance=tol),
              om.boundary_prf_np(host_p, host_g, sl, tolerance=tol))
    np.testing.assert_allclose(float(tm.cluster_purity(ps, pm, gs, gm, tc.trg_vocab)),
                               om.cluster_purity_np(host_p, host_g, tc.trg_vocab), rtol=1e-5)
    np.testing.assert_allclose(float(tm.cluster_nmi(ps, pm, gs, gm, tc.trg_vocab)),
                               om.cluster_nmi_np(host_p, host_g, tc.trg_vocab), rtol=1e-5)


# --- the CRF on minibatches (tests/test_hmm_crf.py:172) ---

CRF_CORPUS = dict(n_utterances=80, seed=41)
CRF_FRAMES = dict(feat_dim=12, noise=0.1, seed=41)
CRF_MODEL = dict(max_jump=3, hidden=256, learning_rate=1e-3, n_sgd=4)
CRF_BATCH, CRF_STEPS = 40, 40


@pytest.fixture(scope="module")
def crf_setup():
    return crf_corpora(CRF_CORPUS, CRF_FRAMES)


def test_crf_minibatch_steps_match_jax(crf_setup):
    """``make_minibatch_step(hmm_crf.em_step)`` composes: three steps from
    the port's parameters and batch draws equal the reference's
    ``em_step`` on the same gathered batches."""
    fc, _, tfc = crf_setup
    tp = port_init(tfc, False, CRF_MODEL, seed=2)
    jp = to_jax(tp)
    gen, draws = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    step = tmb.make_minibatch_step(tcrf.em_step, tfc, batch_size=CRF_BATCH)
    jstep = jax.jit(jcrf.em_step)
    for _ in range(3):
        tp, _ = step(tp, gen)
        idx = torch.randperm(tfc.n, generator=draws)[:CRF_BATCH].numpy()
        jp, _ = jstep(jp, jgather(fc, jnp.asarray(idx)))
    want = mlp_to_numpy(tp.mlp)["params"]
    for name, layer in jax.tree.map(np.asarray, jp.mlp)["params"].items():
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(want[name][leaf], layer[leaf], rtol=1e-3, atol=1e-4)
    for got, ref in ((tp.log_jump, jp.log_jump), (tp.log_p0, jp.log_p0),
                     (tp.log_prior, jp.log_prior)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)


def test_crf_minibatch_training(crf_setup):
    """The counterpart of tests/test_hmm_crf.py:172: 40 minibatch steps of
    B=40 on N=80 learn the aligner (acc > 0.9).  At B=40 the positional
    accuracy swings from step to step (the reference's docstring: the
    self-consistent prior is a batch statistic), so where it ends depends
    on the initial weights and the draws, in both packages alike
    (``test_crf_minibatch_steps_match_jax`` holds the two together); the
    reference test's bound is for its JAX keys, these are the port's CPU
    generators seeded 0 and 0."""
    _, fg, tfc = crf_setup
    params = port_init(tfc, False, CRF_MODEL, seed=0)
    step = tmb.make_minibatch_step(tcrf.em_step, tfc, batch_size=CRF_BATCH)
    gen = torch.Generator().manual_seed(0)
    for _ in range(CRF_STEPS):
        params, stats = step(params, gen)
    assert np.isfinite(float(stats["loglik"]))
    pred = tcrf.align(params, tfc).numpy()
    mask = tfc.src_mask().numpy() & (fg.alignment > 0)
    acc = (pred == fg.alignment)[mask].mean()
    assert acc > 0.9, acc
