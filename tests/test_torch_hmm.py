"""Port discrete HMM (init, EM, M-step, align) vs the JAX reference.

Inputs come from the numpy generator with a fixed seed, padded with
zero-length utterances; parameters cross over with ``params_from_numpy``.
The 5-iteration EM comparison uses the reference's own tolerance for
log_emit after 5 iterations (rtol 1e-3, atol 1e-3,
tests/test_hmm_estep_pallas.py:102-114).
"""

import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu.models import hmm_core as jcore
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.models import hmm as thmm
from multimodalworddiscovery_tpu_torch.models import hmm_core as tcore

GEN = dict(n_utterances=40, seed=3)
N_EMPTY = 4
EM_ITERS = 5


def _np(x):
    return np.array(x)


def _to_torch(jp):
    return thmm.params_from_numpy(
        _np(jp.log_emit), _np(jp.log_jump), _np(jp.log_p0), jp.max_jump, device="cpu"
    )


@pytest.fixture(scope="module")
def corpora():
    jc, _, _ = jax_make(**GEN)
    tc, _, _ = torch_make(**GEN, device="cpu")
    return jc.pad_to(jc.n + N_EMPTY), tc.pad_to(tc.n + N_EMPTY)


@pytest.fixture(scope="module")
def jax_runs(corpora):
    """JAX EM trajectories from init: plain scan and interpret-mode fused."""
    jc, _ = corpora
    runs = {}
    for name, kw in (("plain", {}), ("fused", dict(use_pallas=True, interpret=True))):
        p, lls = jhmm.init(jc), []
        for _ in range(EM_ITERS):
            p, stats = jhmm.em_step(p, jc, **kw)
            lls.append(float(stats["loglik"]))
        runs[name] = (p, np.array(lls))
    return runs


def test_params_from_numpy_round_trip():
    rng = np.random.default_rng(0)
    emit = rng.normal(size=(7, 5)).astype(np.float32)
    jump = rng.normal(size=(9,)).astype(np.float32)
    p = thmm.params_from_numpy(emit, jump, np.float32(-1.5), max_jump=4, device="cpu")
    np.testing.assert_array_equal(p.log_emit.numpy(), emit)
    np.testing.assert_array_equal(p.log_jump.numpy(), jump)
    assert p.log_p0.shape == () and float(p.log_p0) == -1.5 and p.max_jump == 4
    assert p.log_emit.dtype == torch.float32 and p.log_emit.is_contiguous()


def test_init_matches_jax(corpora):
    jc, tc = corpora
    jp, tp = jhmm.init(jc), thmm.init(tc)
    np.testing.assert_allclose(tp.log_emit.numpy(), _np(jp.log_emit), rtol=1e-6)
    np.testing.assert_array_equal(tp.log_jump.numpy(), _np(jp.log_jump))
    np.testing.assert_allclose(float(tp.log_p0), float(jp.log_p0), rtol=1e-6)
    assert tp.max_jump == jp.max_jump


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("jax_route", ["plain", "fused"])
def test_train_trajectory_matches_jax(corpora, jax_runs, use_kernels, jax_route):
    _, tc = corpora
    jp, j_lls = jax_runs[jax_route]
    tp, lls = thmm.train(thmm.init(tc), tc, EM_ITERS, use_kernels=use_kernels)
    assert lls.shape == (EM_ITERS,)
    np.testing.assert_allclose(lls.numpy(), j_lls, rtol=1e-5)
    np.testing.assert_allclose(tp.log_emit.numpy(), _np(jp.log_emit), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tp.log_jump.numpy(), _np(jp.log_jump), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(tp.log_p0), float(jp.log_p0), rtol=1e-3, atol=1e-3)


def test_m_step_matches_jax(corpora, jax_runs):
    jc, tc = corpora
    jp = jax_runs["plain"][0]
    counts_j, _ = jhmm.expected_counts(jp, jc)
    ec, wc = (_np(c) for c in counts_j)
    want = jhmm.m_step(jp, counts_j)
    got = thmm.m_step(_to_torch(jp), (torch.as_tensor(ec), torch.as_tensor(wc)))
    np.testing.assert_allclose(got.log_emit.numpy(), _np(want.log_emit), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.log_jump.numpy(), _np(want.log_jump), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got.log_p0), float(want.log_p0), rtol=1e-6)


def test_loglik_matches_jax(corpora, jax_runs):
    jc, tc = corpora
    jp = jax_runs["plain"][0]
    np.testing.assert_allclose(
        float(thmm.loglik(_to_torch(jp), tc)), float(jhmm.loglik(jp, jc)), rtol=1e-6
    )


@pytest.mark.parametrize("jax_route", ["plain", "fused"])
def test_align_matches_jax(corpora, jax_runs, jax_route):
    """Same parameters -> the same Viterbi alignment.  Both sides compute the
    same float32 ops in the same order and break ties toward the lowest state,
    so the paths agree exactly."""
    jc, tc = corpora
    jp = jax_runs[jax_route][0]
    want = _np(jhmm.align(jp, jc))
    got = thmm.align(_to_torch(jp), tc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want[-N_EMPTY:] == 0)


def test_viterbi_factored_matches_dense_viterbi_path(corpora, jax_runs):
    """The port's factored decoder finds a path as good as the reference's
    dense Viterbi (equal path scores)."""
    jc, tc = corpora
    jp = jax_runs["plain"][0]
    j_init, j_trans, j_emit = jhmm._machinery(jp, jc)
    want = _np(jcore.viterbi(j_init, j_trans, j_emit, jc.src_len))
    tp = _to_torch(jp)
    base, rowz, colmask = tcore.factor_log_trans(tp.log_jump, tp.log_p0, tc, tp.max_jump)
    got = tcore.viterbi_factored(
        tcore.build_log_init(tp.log_p0, tc), base, rowz, colmask,
        thmm._log_emissions(tp, tc), tc.src_len,
    ).numpy()
    init, trans, emit = _np(j_init), _np(j_trans), _np(j_emit)
    lens = _np(jc.src_len)

    def score(n, path):
        s = init[n, path[0]] + emit[n, 0, path[0]]
        for t in range(1, lens[n]):
            s += trans[n, path[t - 1], path[t]] + emit[n, t, path[t]]
        return s

    for n in range(tc.n):
        if lens[n]:
            np.testing.assert_allclose(score(n, got[n]), score(n, want[n]), rtol=1e-5)


# Outside K2's gate (S=80 > 64, V_trg=301 > 256): the general route, whose
# kernels on the card are K1, K4 and K7 and whose plain versions run here.
GENERAL_GEN = dict(n_utterances=6, n_concepts=300, min_concepts=36, max_concepts=40,
                   min_word_len=2, max_word_len=3, seed=5)


@pytest.fixture(scope="module")
def general_corpora():
    jc, _, _ = jax_make(**GENERAL_GEN)
    tc, _, _ = torch_make(**GENERAL_GEN, device="cpu")
    return jc.pad_to(jc.n + N_EMPTY), tc.pad_to(tc.n + N_EMPTY)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_general_route_expected_counts_match_jax(general_corpora, use_kernels):
    """hmm.expected_counts outside the gate against the reference's (its
    dense scan E-step), from one JAX EM step's parameters: counts atol 1e-4
    x scale, widths rtol 1e-4 atol 1e-3, loglik rtol 1e-5."""
    jc, tc = general_corpora
    assert 2 * tc.max_trg_len > thmm.FUSED_MAX_STATES and tc.trg_vocab > thmm.FUSED_MAX_TRG_VOCAB
    s, v_src, v_trg = 2 * tc.max_trg_len, tc.src_vocab, tc.trg_vocab
    route = thmm.estep_route(s, v_src, v_trg, use_kernels, "float32")
    assert route == ("general" if use_kernels else "plain")
    jp, _ = jhmm.em_step(jhmm.init(jc), jc)
    (ec_w, wc_w), ll_w = jhmm.expected_counts(jp, jc)
    (ec, wc), ll = thmm.expected_counts(_to_torch(jp), tc, use_kernels=use_kernels)
    ec_w = _np(ec_w)
    assert ec.shape == ec_w.shape == (v_src, v_trg)
    np.testing.assert_allclose(ec.numpy(), ec_w, rtol=0, atol=1e-4 * max(ec_w.max(), 1.0))
    np.testing.assert_allclose(wc.numpy(), _np(wc_w), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(ll), float(ll_w), rtol=1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_general_route_train_matches_jax(general_corpora, use_kernels):
    """2 EM iterations from init outside the gate against hmm.train."""
    jc, tc = general_corpora
    jp, j_lls = jhmm.train(jhmm.init(jc), jc, 2)
    tp, lls = thmm.train(thmm.init(tc), tc, 2, use_kernels=use_kernels)
    np.testing.assert_allclose(lls.numpy(), _np(j_lls), rtol=1e-5)
    np.testing.assert_allclose(tp.log_emit.numpy(), _np(jp.log_emit), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tp.log_jump.numpy(), _np(jp.log_jump), rtol=1e-3, atol=1e-3)
