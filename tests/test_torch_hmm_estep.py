"""K2's and K4's plain versions and the plain E-step vs the JAX reference.

The same corpus (numpy generator, fixed seed, padded with zero-length
utterances) and the same parameters (one JAX EM step from init, carried
across with ``params_from_numpy``) go through the JAX Pallas kernels in
interpret mode, the JAX scan E-step, and the port.  Tolerances are the
reference's own (tests/test_hmm_estep_pallas.py): logZ rtol/atol 1e-4,
counts atol 1e-4 x scale, widths rtol 1e-4 atol 1e-3, loglik rtol 1e-6;
for K4's gamma rtol 1e-3 atol 1e-4 and xi rtol 1e-3 atol 1e-3 (:74-80).
"""

import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu.models import hmm_core as jcore
from multimodalworddiscovery_tpu.ops.hmm_fwdbwd_pallas import hmm_estep_pallas
from multimodalworddiscovery_tpu_torch.core.logsemiring import NEG_INF
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.models import hmm as thmm
from multimodalworddiscovery_tpu_torch.models import hmm_core as tcore
from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k2

CASES = {
    "S8": dict(n_utterances=40, seed=3),
    "S40": dict(n_utterances=8, n_concepts=200, min_concepts=17,
                max_concepts=20, min_word_len=2, max_word_len=3, seed=21),
}
# K4 also runs outside K2's gate: S=128 is the discrete route's general case
# and above the 160 states the kernels once took (S=170)
K4_CASES = dict(CASES, S128=dict(n_utterances=4, n_concepts=200, min_concepts=62,
                                 max_concepts=64, min_word_len=2, max_word_len=3,
                                 seed=21),
                S170=dict(n_utterances=4, n_concepts=200, min_concepts=85,
                          max_concepts=85, min_word_len=2, max_word_len=3, seed=21))
N_EMPTY = 3


def _case(kw):
    jc, _, _ = jax_make(**kw)
    tc, _, _ = torch_make(**kw, device="cpu")
    jc, tc = jc.pad_to(jc.n + N_EMPTY), tc.pad_to(tc.n + N_EMPTY)
    jp, _ = jhmm.em_step(jhmm.init(jc), jc)
    tp = thmm.params_from_numpy(
        np.asarray(jp.log_emit), np.asarray(jp.log_jump), np.asarray(jp.log_p0),
        jp.max_jump, device="cpu",
    )
    return jc, jp, tc, tp


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return _case(CASES[request.param])


@pytest.fixture(scope="module", params=sorted(K4_CASES))
def k4_case(request):
    return _case(K4_CASES[request.param])


def _factored(tc, tp):
    base, rowz, colmask = tcore.factor_log_trans(tp.log_jump, tp.log_p0, tc, tp.max_jump)
    return tcore.build_log_init(tp.log_p0, tc), base, rowz, colmask


def test_state_space_matches_jax(case):
    jc, jp, tc, tp = case
    np.testing.assert_array_equal(
        tcore.state_concepts(tc).numpy(), np.asarray(jcore.state_concepts(jc))
    )
    np.testing.assert_array_equal(
        tcore.state_mask(tc).numpy(), np.asarray(jcore.state_mask(jc))
    )
    np.testing.assert_array_equal(
        tcore.jump_width_ids(tc.max_trg_len, 3).numpy(),
        np.asarray(jcore.jump_width_ids(jc.max_trg_len, 3)),
    )


def test_factor_log_trans_and_init_match_jax(case):
    jc, jp, tc, tp = case
    want = jcore.factor_log_trans(jp.log_jump, jp.log_p0, jc, jp.max_jump)
    got = tcore.factor_log_trans(tp.log_jump, tp.log_p0, tc, tp.max_jump)
    # rowz is a float32 logsumexp over S terms: the two libraries' exp and
    # summation order differ by a few ulps per term
    for name, w, g in zip(("base", "rowz", "colmask"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(
        tcore.build_log_init(tp.log_p0, tc).numpy(),
        np.asarray(jcore.build_log_init(jp.log_p0, jc)), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        tcore.build_log_trans(tp.log_jump, tp.log_p0, tc, tp.max_jump).numpy(),
        np.asarray(jcore.build_log_trans(jp.log_jump, jp.log_p0, jc, jp.max_jump)),
        rtol=1e-5, atol=1e-6,
    )


def test_plain_k2_matches_fused_pallas_pipeline(case):
    """The port's fused route (K1 + K2, plain versions on the CPU) against
    the reference's _expected_counts_fused in interpret mode."""
    jc, jp, tc, tp = case
    (ec_w, wc_w), ll_w = jhmm.expected_counts(jp, jc, use_pallas=True, interpret=True)
    concepts = tcore.state_concepts(tc)
    (ec_g, wc_g), ll_g = thmm._expected_counts_fused(tp, tc, concepts)
    scale = max(float(np.max(ec_w)), 1.0)
    np.testing.assert_allclose(ec_g.numpy(), np.asarray(ec_w), atol=1e-4 * scale)
    np.testing.assert_allclose(wc_g.numpy(), np.asarray(wc_w), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(ll_g), float(ll_w), rtol=1e-6)


def test_plain_k2_matches_scan_estep(case):
    """K2's plain version against the JAX scan E-step + pair counts."""
    jc, jp, tc, tp = case
    (ec_w, wc_w), ll_w = jhmm.expected_counts(jp, jc)
    log_init, base, rowz, colmask = _factored(tc, tp)
    concepts = tcore.state_concepts(tc)
    emit = thmm._log_emissions(tp, tc, concepts)
    v_src, v_trg = tp.log_emit.shape
    counts, xi, logz = k2.hmm_estep_counts(
        log_init, base, rowz, colmask, emit, tc.src, concepts, tc.src_len,
        v_src, v_trg,
    )
    scale = max(float(np.max(ec_w)), 1.0)
    np.testing.assert_allclose(counts.numpy(), np.asarray(ec_w), atol=1e-4 * scale)
    wc = tcore.project_widths(xi, tc.max_trg_len, tp.max_jump)
    np.testing.assert_allclose(wc.numpy(), np.asarray(wc_w), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(logz.sum()), float(ll_w), rtol=1e-6)


def test_plain_k2_logz_and_xi_match_pallas_estep(case):
    """logZ and pooled xi of K2's plain version against the reference's
    general E-step kernel (shared forward and step math)."""
    jc, jp, tc, tp = case
    j_init = jcore.build_log_init(jp.log_p0, jc)
    j_base, j_rowz, j_colmask = jcore.factor_log_trans(jp.log_jump, jp.log_p0, jc, jp.max_jump)
    j_emit = jhmm._log_emissions(jp, jc)
    _, xi_w, logz_w = hmm_estep_pallas(
        j_init, j_base, j_rowz, j_colmask, j_emit, jc.src_len, interpret=True
    )
    log_init, base, rowz, colmask = _factored(tc, tp)
    concepts = tcore.state_concepts(tc)
    _, xi, logz = k2.hmm_estep_counts_plain(
        log_init, base, rowz, colmask, thmm._log_emissions(tp, tc, concepts),
        tc.src, concepts, tc.src_len, *tp.log_emit.shape,
    )
    np.testing.assert_allclose(logz.numpy(), np.asarray(logz_w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xi.numpy(), np.asarray(xi_w), rtol=1e-4, atol=1e-3)


def test_zero_length_utterances_have_logz_zero(case):
    jc, jp, tc, tp = case
    log_init, base, rowz, colmask = _factored(tc, tp)
    concepts = tcore.state_concepts(tc)
    emit = thmm._log_emissions(tp, tc, concepts)
    _, _, logz = k2.hmm_estep_counts_plain(
        log_init, base, rowz, colmask, emit, tc.src, concepts, tc.src_len,
        *tp.log_emit.shape,
    )
    _, _, logz_dense = tcore.estep(tp.log_jump, tp.log_p0, tp.max_jump, emit, tc)
    assert torch.all(logz[-N_EMPTY:] == 0) and torch.all(logz_dense[-N_EMPTY:] == 0)
    assert torch.all(logz[:-N_EMPTY] < 0) and torch.all(logz[:-N_EMPTY] > NEG_INF / 2)


def test_dense_estep_matches_jax(case):
    """The port's plain dense E-step (the use_kernels=False route)."""
    jc, jp, tc, tp = case
    j_emit = jhmm._log_emissions(jp, jc)
    g_w, wc_w, logz_w = jcore.estep(jp.log_jump, jp.log_p0, jp.max_jump, j_emit, jc)
    g, wc, logz = tcore.estep(
        tp.log_jump, tp.log_p0, tp.max_jump, thmm._log_emissions(tp, tc), tc
    )
    np.testing.assert_allclose(logz.numpy(), np.asarray(logz_w), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_w), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(wc.numpy(), np.asarray(wc_w), rtol=1e-4, atol=1e-3)


def test_forward_backward_match_jax(case):
    jc, jp, tc, tp = case
    j_init, j_trans, j_emit = jhmm._machinery(jp, jc)
    a_w, z_w = jcore.forward(j_init, j_trans, j_emit, jc.src_len)
    b_w = jcore.backward(j_trans, j_emit, jc.src_len)
    t_trans = tcore.build_log_trans(tp.log_jump, tp.log_p0, tc, tp.max_jump)
    t_emit = thmm._log_emissions(tp, tc)
    a, z = tcore.forward(tcore.build_log_init(tp.log_p0, tc), t_trans, t_emit, tc.src_len)
    b = tcore.backward(t_trans, t_emit, tc.src_len)
    valid = np.asarray(a_w) > NEG_INF / 2
    np.testing.assert_allclose(a.numpy()[valid], np.asarray(a_w)[valid], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_w), rtol=1e-5, atol=1e-4)
    valid = np.asarray(b_w) > NEG_INF / 2
    np.testing.assert_allclose(b.numpy()[valid], np.asarray(b_w)[valid], rtol=1e-5, atol=1e-3)


def test_plain_k4_matches_pallas_estep(k4_case):
    """K4's plain version against the reference's general E-step kernel
    (hmm_estep_pallas, interpret mode) at S=8, S=40 and S=128."""
    jc, jp, tc, tp = k4_case
    j_init = jcore.build_log_init(jp.log_p0, jc)
    j_base, j_rowz, j_colmask = jcore.factor_log_trans(jp.log_jump, jp.log_p0, jc, jp.max_jump)
    g_w, xi_w, logz_w = hmm_estep_pallas(
        j_init, j_base, j_rowz, j_colmask, jhmm._log_emissions(jp, jc), jc.src_len,
        interpret=True,
    )
    log_init, base, rowz, colmask = _factored(tc, tp)
    before = k2.hmm_estep.launches
    gamma, xi, logz = k2.hmm_estep(
        log_init, base, rowz, colmask, thmm._log_emissions(tp, tc), tc.src_len
    )
    assert k2.hmm_estep.launches == before  # CPU tensors take the plain version
    assert gamma.shape == (tc.n, tc.max_src_len, 2 * tc.max_trg_len)
    np.testing.assert_allclose(logz.numpy(), np.asarray(logz_w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(logz.sum()), float(np.asarray(logz_w).sum()), rtol=1e-6)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(g_w), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(xi.numpy(), np.asarray(xi_w), rtol=1e-3, atol=1e-3)
    assert torch.all(logz[-N_EMPTY:] == 0) and torch.all(gamma[-N_EMPTY:] == 0)


def test_kernel_route_estep_matches_jax_scan_estep(k4_case):
    """hmm_core.estep(use_kernels=True) -- K4's plain version on the CPU --
    against the reference's scan E-step: gamma, jump widths and logZ."""
    jc, jp, tc, tp = k4_case
    g_w, wc_w, logz_w = jcore.estep(
        jp.log_jump, jp.log_p0, jp.max_jump, jhmm._log_emissions(jp, jc), jc
    )
    g, wc, logz = tcore.estep(
        tp.log_jump, tp.log_p0, tp.max_jump, thmm._log_emissions(tp, tc), tc,
        use_kernels=True,
    )
    np.testing.assert_allclose(logz.numpy(), np.asarray(logz_w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_w), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(wc.numpy(), np.asarray(wc_w), rtol=1e-4, atol=1e-3)


def test_posteriors_match_jax(k4_case):
    jc, jp, tc, tp = k4_case
    np.testing.assert_allclose(
        thmm.posteriors(tp, tc).numpy(), np.asarray(jhmm.posteriors(jp, jc)),
        rtol=1e-3, atol=1e-5,
    )


# --- the bf16 variants (K2-bf16, K4-bf16) and the remat E-step (K6) ---
# Plain bf16 against the reference's bf16 kernels in interpret mode: both
# round the same operands to bf16 and their products are exact in float32,
# so K2's and K4's float32 tolerances above hold.  bf16 against float32:
# the reference's bound, rtol 2e-2 atol 2e-2 (tests/test_hmm_estep_pallas.py
# :216-223).  K6 against the reference's remat kernel and against the
# streaming E-step: logZ rtol 1e-5, gamma rtol 1e-4 atol 1e-5, xi rtol 1e-4
# atol 1e-4 (:241-261).


def test_plain_k2_bf16_matches_fused_pallas_pipeline(case):
    jc, jp, tc, tp = case
    (ec_w, wc_w), ll_w = jhmm.expected_counts(jp, jc, use_pallas=True, interpret=True,
                                              dot_dtype="bfloat16")
    (ec_g, wc_g), ll_g = thmm.expected_counts(tp, tc, use_kernels=True, dot_dtype="bfloat16")
    scale = max(float(np.max(ec_w)), 1.0)
    np.testing.assert_allclose(ec_g.numpy(), np.asarray(ec_w), atol=1e-4 * scale)
    np.testing.assert_allclose(wc_g.numpy(), np.asarray(wc_w), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(ll_g), float(ll_w), rtol=1e-6)


def _jax_factored(jc, jp):
    j_base, j_rowz, j_colmask = jcore.factor_log_trans(jp.log_jump, jp.log_p0, jc, jp.max_jump)
    return (jcore.build_log_init(jp.log_p0, jc), j_base, j_rowz, j_colmask,
            jhmm._log_emissions(jp, jc), jc.src_len)


def test_plain_k4_bf16_matches_pallas_estep(k4_case):
    jc, jp, tc, tp = k4_case
    g_w, xi_w, logz_w = hmm_estep_pallas(*_jax_factored(jc, jp), dot_dtype="bfloat16",
                                         interpret=True)
    gamma, xi, logz = k2.hmm_estep(*_factored(tc, tp), thmm._log_emissions(tp, tc),
                                   tc.src_len, dot_dtype="bfloat16")
    np.testing.assert_allclose(logz.numpy(), np.asarray(logz_w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(logz.sum()), float(np.asarray(logz_w).sum()), rtol=1e-6)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(g_w), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(xi.numpy(), np.asarray(xi_w), rtol=1e-3, atol=1e-3)
    assert torch.all(logz[-N_EMPTY:] == 0) and torch.all(gamma[-N_EMPTY:] == 0)


def test_bf16_within_the_reference_bound_of_f32(k4_case):
    jc, jp, tc, tp = k4_case
    args = (*_factored(tc, tp), thmm._log_emissions(tp, tc), tc.src_len)
    g32, _, z32 = k2.hmm_estep(*args)
    g16, _, z16 = k2.hmm_estep(*args, dot_dtype="bfloat16")
    assert not torch.equal(z16, z32)  # the variant really rounds
    torch.testing.assert_close(z16, z32, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(g16, g32, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("chunk_t", [5, 11])
def test_plain_k6_matches_pallas_remat_and_streaming(k4_case, chunk_t):
    """chunk_t 11 divides none of the cases' Ts (18, 54, 175), 5 two of
    them; the reference runs block_n=16, chunk_t=5 as its own test does."""
    jc, jp, tc, tp = k4_case
    g_w, xi_w, z_w = hmm_estep_pallas(*_jax_factored(jc, jp), remat=True, block_n=16,
                                      chunk_t=5, interpret=True)
    args = (*_factored(tc, tp), thmm._log_emissions(tp, tc), tc.src_len)
    before = k2.hmm_estep.launches_remat
    gamma, xi, logz = k2.hmm_estep(*args, remat=True, chunk_t=chunk_t)
    assert k2.hmm_estep.launches_remat == before  # CPU tensors take the plain version
    for want_g, want_xi, want_z in ((g_w, xi_w, z_w), k2.hmm_estep_plain(*args)):
        np.testing.assert_allclose(logz.numpy(), np.asarray(want_z), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gamma.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(xi.numpy(), np.asarray(want_xi), rtol=1e-4, atol=1e-4)
    assert torch.all(logz[-N_EMPTY:] == 0) and torch.all(gamma[-N_EMPTY:] == 0)


def test_plain_k6_recomputes_the_streaming_alphas_bit_for_bit(k4_case):
    """The remat plain version's chunk bookkeeping recomputes exactly the
    streaming version's alphas, in float32 and in bf16, whether or not the
    chunk divides Ts."""
    _, _, tc, tp = k4_case
    args = (*_factored(tc, tp), thmm._log_emissions(tp, tc), tc.src_len)
    for dot_dtype in ("float32", "bfloat16"):
        want = k2.hmm_estep_plain(*args, dot_dtype)
        for chunk_t in (1, 4, 11, 64):
            got = k2.hmm_estep_remat_plain(*args, dot_dtype, chunk_t)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (dot_dtype, chunk_t)


def test_estep_options_are_validated(case):
    _, _, tc, tp = case
    args = (*_factored(tc, tp), thmm._log_emissions(tp, tc), tc.src_len)
    with pytest.raises(ValueError, match="chunk_t"):
        k2.hmm_estep(*args, remat=True, chunk_t=k2.MAX_CHUNK + 1)
    with pytest.raises(ValueError, match="dot_dtype"):
        k2.hmm_estep(*args, dot_dtype="float16")
    with pytest.raises(ValueError, match="dot_dtype"):
        thmm.expected_counts(tp, tc, use_kernels=True, dot_dtype="float16")


def test_kernel_route_estep_threads_dot_dtype(k4_case):
    """hmm_core.estep passes dot_dtype to K4's plain version on the kernel
    route, and the plain dense route ignores it, as the reference's scan
    path does."""
    jc, jp, tc, tp = k4_case
    emit = thmm._log_emissions(tp, tc)
    g_w, wc_w, logz_w = jcore.estep(jp.log_jump, jp.log_p0, jp.max_jump,
                                    jhmm._log_emissions(jp, jc), jc, use_pallas=True,
                                    interpret=True, dot_dtype="bfloat16")
    g, wc, logz = tcore.estep(tp.log_jump, tp.log_p0, tp.max_jump, emit, tc,
                              use_kernels=True, dot_dtype="bfloat16")
    np.testing.assert_allclose(logz.numpy(), np.asarray(logz_w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_w), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(wc.numpy(), np.asarray(wc_w), rtol=1e-4, atol=1e-3)
    dense = tcore.estep(tp.log_jump, tp.log_p0, tp.max_jump, emit, tc, use_kernels=False)
    dense16 = tcore.estep(tp.log_jump, tp.log_p0, tp.max_jump, emit, tc, use_kernels=False,
                          dot_dtype="bfloat16")
    assert all(torch.equal(a, b) for a, b in zip(dense, dense16))


def test_length_order_blocks_give_the_plain_outputs(k4_case):
    """What K4's and K6's blocks rest on: utterances taken longest first
    (ties in index order, the order their preparation kernel ranks on the
    card), each block of 4 run alone and only up to its longest length, its
    outputs put back in the caller's order, give the whole batch's gamma,
    logZ and xi, empty utterances included."""
    _, _, tc, tp = k4_case
    log_init, base, rowz, colmask = _factored(tc, tp)
    emit = thmm._log_emissions(tp, tc)
    perm = torch.argsort(tc.src_len, descending=True, stable=True)
    assert tc.src_len[perm[-N_EMPTY:]].tolist() == [0] * N_EMPTY
    gamma_w, xi_w, logz_w = k2.hmm_estep_plain(log_init, base, rowz, colmask, emit, tc.src_len)
    gamma, xi, logz = torch.zeros_like(gamma_w), torch.zeros_like(xi_w), torch.zeros_like(logz_w)
    for b0 in range(0, tc.n, 4):
        idx = perm[b0:b0 + 4]
        tmax = int(tc.src_len[idx].max())
        if tmax == 0:
            continue
        g, x, z = k2.hmm_estep_plain(log_init[idx], base, rowz[idx], colmask[idx],
                                     emit[idx, :tmax], tc.src_len[idx])
        gamma[idx, :tmax], logz[idx] = g, z
        xi = xi + x
    # the two differ only in the batch shapes of the float32 products
    torch.testing.assert_close(gamma, gamma_w, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(logz, logz_w, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(xi, xi_w, rtol=1e-4, atol=1e-4)
