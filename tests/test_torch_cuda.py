"""The port's CUDA kernels on the card against their plain versions, at
small shapes.  Marked ``cuda``; each test skips when no CUDA device is
present.  This file imports no JAX, so on a GPU host without JAX run it
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
from multimodalworddiscovery_tpu_torch.frontend import speech
from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core, hmm_crf, hmm_dnn, hmm_gaussian
from multimodalworddiscovery_tpu_torch.core.logsemiring import NEG_INF
from multimodalworddiscovery_tpu_torch.ops import counts as k1
from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k2
from multimodalworddiscovery_tpu_torch.ops import _build
from multimodalworddiscovery_tpu_torch.ops import log_semiring as k8
from multimodalworddiscovery_tpu_torch.ops import mfcc as k5
from multimodalworddiscovery_tpu_torch.ops import viterbi as k3
from multimodalworddiscovery_tpu_torch.scripts import run_pipeline

pytestmark = pytest.mark.cuda

CASES = {
    "S12": dict(n_utterances=40, n_concepts=60, min_concepts=3, max_concepts=6, seed=3),
    "S40": dict(n_utterances=12, n_concepts=200, min_concepts=17,
                max_concepts=20, min_word_len=2, max_word_len=3, seed=21),
}
# K3 and K4 also take the discrete route outside K2's gate (S=128)
GENERAL_CASES = dict(CASES, S128=dict(n_utterances=8, n_concepts=200, min_concepts=60,
                                      max_concepts=64, min_word_len=2, max_word_len=3,
                                      seed=21))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(name, dev):
    corpus, _, _ = make_flickr8k_mini(**GENERAL_CASES[name])
    corpus = corpus.pad_to(corpus.n + 3).to(dev)
    params, _ = hmm.em_step(hmm.init(corpus), corpus)
    concepts = hmm_core.state_concepts(corpus)
    base, rowz, colmask = hmm_core.factor_log_trans(
        params.log_jump, params.log_p0, corpus, params.max_jump
    )
    log_init = hmm_core.build_log_init(params.log_p0, corpus)
    return corpus, params, concepts, (log_init, base, rowz, colmask)


@pytest.mark.parametrize("name", sorted(CASES))
def test_k1_kernel_exact(dev, name):
    corpus, params, concepts, _ = _inputs(name, dev)
    before = k1.table_lookup.launches
    got = k1.table_lookup(params.log_emit, corpus.src, concepts)
    assert k1.table_lookup.launches == before + 1
    want = k1.table_lookup_plain(params.log_emit, corpus.src, concepts)
    assert torch.equal(got, want)


@pytest.mark.parametrize("f, e", [(49, 61), (49, 401), (300, 250)])
@pytest.mark.parametrize("s, n, ts", [(12, 1003, 31), (64, 67, 401), (128, 9, 181), (7, 301, 23),
                                      (13, 50, 1)])
def test_k1_launch_shapes_bit_equal(dev, s, n, ts, f, e):
    """K1 at S = 12, 64, 128 and at S not a multiple of 4, its table in
    shared memory and (300 x 250 floats, above 227 KB) read through the
    cache: equal to the plain gather bit for bit; an id outside the table
    gives NaN there and nowhere else."""
    rng = np.random.default_rng(s * n + f)
    table = torch.as_tensor(rng.normal(size=(f, e)).astype(np.float32), device=dev)
    src = torch.as_tensor(rng.integers(0, f, (n, ts)), dtype=torch.int32, device=dev)
    conc = torch.as_tensor(rng.integers(0, e, (n, s)), dtype=torch.int32, device=dev)
    before = k1.table_lookup.launches
    got = k1.table_lookup(table, src, conc)
    assert k1.table_lookup.launches == before + 1
    assert torch.equal(got, k1.table_lookup_plain(table, src, conc))
    src[n // 2, ts // 2] = f
    conc[n - 1, s - 1] = -1
    got = k1.table_lookup(table, src, conc)
    bad = torch.zeros_like(got, dtype=torch.bool)
    bad[n // 2, ts // 2, :] = True
    bad[n - 1, :, s - 1] = True
    assert torch.equal(torch.isnan(got), bad)
    want = k1.table_lookup_plain(table, src.clamp(0, f - 1), conc.clamp(0, e - 1))
    assert torch.equal(got[~bad], want[~bad])


def test_k1_table_sizes_in_any_order(dev):
    """Tables of 150 KB, then 80 KB, then 150 KB again in shared memory (the
    launch configuration is cached per shape, so a later launch must not
    find the shared-memory opt-in lowered by an earlier, smaller one)."""
    rng = np.random.default_rng(9)
    for f, e in ((60, 640), (50, 400), (60, 640)):
        table = torch.as_tensor(rng.normal(size=(f, e)).astype(np.float32), device=dev)
        src = torch.as_tensor(rng.integers(0, f, (2000, 400)), dtype=torch.int32, device=dev)
        conc = torch.as_tensor(rng.integers(0, e, (2000, 64)), dtype=torch.int32, device=dev)
        assert torch.equal(k1.table_lookup(table, src, conc),
                           k1.table_lookup_plain(table, src, conc))


@pytest.mark.parametrize("name", sorted(CASES))
def test_k2_kernel_matches_plain(dev, name):
    corpus, params, concepts, (log_init, base, rowz, colmask) = _inputs(name, dev)
    emit = k1.table_lookup(params.log_emit, corpus.src, concepts)
    args = (log_init, base, rowz, colmask, emit, corpus.src, concepts,
            corpus.src_len, *params.log_emit.shape)
    before = k2.hmm_estep_counts.launches
    counts, xi, logz = k2.hmm_estep_counts(*args)
    assert k2.hmm_estep_counts.launches == before + 1
    counts_p, xi_p, logz_p = k2.hmm_estep_counts_plain(*args)
    torch.testing.assert_close(logz, logz_p, rtol=1e-4, atol=1e-4)
    assert torch.all(logz[-3:] == 0)
    torch.testing.assert_close(logz.sum(), logz_p.sum(), rtol=1e-6, atol=0)
    scale = max(float(counts_p.max()), 1.0)
    torch.testing.assert_close(counts, counts_p, rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(xi, xi_p, rtol=1e-4, atol=1e-3)


def test_kernel_route_matches_plain_em(dev):
    corpus, params, _, _ = _inputs("S12", dev)
    p_k, lls_k = hmm.train(params, corpus, 3, use_kernels=True)
    p_p, lls_p = hmm.train(params, corpus, 3, use_kernels=False)
    torch.testing.assert_close(lls_k, lls_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(p_k.log_emit, p_p.log_emit, rtol=1e-3, atol=1e-3)


def test_wrappers_validate_inputs(dev):
    corpus, params, concepts, _ = _inputs("S12", dev)
    with pytest.raises(TypeError, match="int32"):
        k1.table_lookup(params.log_emit, corpus.src.long(), concepts)
    with pytest.raises(ValueError, match="contiguous"):
        k1.table_lookup(params.log_emit.t().contiguous().t(), corpus.src, concepts)


def test_bf16_routes_launch_the_bf16_kernels(dev):
    """dot_dtype="bfloat16" on CUDA runs K2-bf16 inside the fused gate and
    K4-bf16 outside it; an unknown dtype raises."""
    for name, wrapper in (("S12", k2.hmm_estep_counts), ("S128", k2.hmm_estep)):
        corpus, params, _, _ = _inputs(name, dev)
        before = (wrapper.launches, wrapper.launches_bf16)
        hmm.expected_counts(params, corpus, use_kernels=True, dot_dtype="bfloat16")
        assert (wrapper.launches, wrapper.launches_bf16) == (before[0], before[1] + 1)
    with pytest.raises(ValueError, match="dot_dtype"):
        hmm.expected_counts(params, corpus, use_kernels=True, dot_dtype="float16")


# A bf16 kernel against its plain bf16 version: the products are exact in
# float32 on both sides, but the float32 operands entering each bf16
# rounding differ in their last bits (another summation order, another
# exp), so now and then one rounds the other way, 2^-8 relative, and shifts
# that utterance's posteriors.  The posterior terms (counts, gamma, xi) are
# held to the float32 kernel's bounds on all but FLIP_SHARE of their
# elements (rounded up), and every element to 2^-7 of their scale, two such
# ulps; logZ keeps the float32 bounds.
BF16_FLIP = 2.0**-7
FLIP_SHARE = 1e-3


def _assert_close_but_flips(got, want, rtol, atol):
    outside = int((~torch.isclose(got, want, rtol=rtol, atol=atol)).sum())
    assert outside <= math.ceil(FLIP_SHARE * got.numel()), (outside, got.numel())
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got, want, rtol=0, atol=BF16_FLIP * scale)


def _assert_rounds(got, plain_bf16, f32):
    """A bf16 kernel's output shows its rounding: it differs from the
    float32 kernel's and lies closer to its plain bf16 version than to it."""
    d_plain = float((got - plain_bf16).abs().max())
    d_f32 = float((got - f32).abs().max())
    assert not torch.equal(got, f32) and d_plain < d_f32, (d_plain, d_f32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_k2_bf16_kernel_matches_plain(dev, name):
    """K2-bf16 against its plain bf16 version with K2's bounds (the counts
    and xi as FLIP_SHARE says), then against K2 in float32 within the
    reference's bf16 bound, rtol 2e-2 atol 2e-2
    (tests/test_hmm_estep_pallas.py:216-223), and closer to the plain bf16
    version than to K2."""
    corpus, params, concepts, (log_init, base, rowz, colmask) = _inputs(name, dev)
    emit = k1.table_lookup(params.log_emit, corpus.src, concepts)
    args = (log_init, base, rowz, colmask, emit, corpus.src, concepts,
            corpus.src_len, *params.log_emit.shape)
    before = k2.hmm_estep_counts.launches_bf16
    counts, xi, logz = k2.hmm_estep_counts(*args, dot_dtype="bfloat16")
    assert k2.hmm_estep_counts.launches_bf16 == before + 1
    counts_p, xi_p, logz_p = k2.hmm_estep_counts_plain(*args, dot_dtype="bfloat16")
    torch.testing.assert_close(logz, logz_p, rtol=1e-4, atol=1e-4)
    assert torch.all(logz[-3:] == 0)
    torch.testing.assert_close(logz.sum(), logz_p.sum(), rtol=1e-6, atol=0)
    scale = max(float(counts_p.max()), 1.0)
    _assert_close_but_flips(counts, counts_p, rtol=0, atol=1e-4 * scale)
    _assert_close_but_flips(xi, xi_p, rtol=1e-4, atol=1e-3)
    counts32, _, logz32 = k2.hmm_estep_counts(*args)
    torch.testing.assert_close(logz, logz32, rtol=2e-2, atol=2e-2)
    _assert_rounds(logz, logz_p, logz32)
    _assert_rounds(counts, counts_p, counts32)


@pytest.mark.parametrize("name", sorted(GENERAL_CASES))
def test_k4_bf16_kernel_matches_plain(dev, name):
    """K4-bf16 against its plain bf16 version with K4's bounds (gamma and xi
    as FLIP_SHARE says), against K4 within rtol 2e-2 atol 2e-2, and closer
    to the plain bf16 version than to K4."""
    corpus, params, concepts, (log_init, base, rowz, colmask) = _inputs(name, dev)
    args = (log_init, base, rowz, colmask,
            k1.table_lookup(params.log_emit, corpus.src, concepts), corpus.src_len)
    before = k2.hmm_estep.launches_bf16
    gamma, xi, logz = k2.hmm_estep(*args, dot_dtype="bfloat16")
    assert k2.hmm_estep.launches_bf16 == before + 1
    gamma_p, xi_p, logz_p = k2.hmm_estep_plain(*args, dot_dtype="bfloat16")
    torch.testing.assert_close(logz, logz_p, rtol=1e-4, atol=1e-4)
    assert torch.all(logz[-3:] == 0) and torch.all(gamma[-3:] == 0)
    torch.testing.assert_close(logz.sum(), logz_p.sum(), rtol=1e-6, atol=0)
    _assert_close_but_flips(gamma, gamma_p, rtol=1e-3, atol=1e-4)
    _assert_close_but_flips(xi, xi_p, rtol=1e-3, atol=1e-3)
    gamma32, _, logz32 = k2.hmm_estep(*args)
    torch.testing.assert_close(logz, logz32, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(gamma, gamma32, rtol=2e-2, atol=2e-2)
    _assert_rounds(logz, logz_p, logz32)
    _assert_rounds(gamma, gamma_p, gamma32)


@pytest.mark.parametrize("chunk_t", [11, 32])
@pytest.mark.parametrize("name", sorted(GENERAL_CASES))
def test_k6_kernel_matches_plain_and_k4(dev, name, chunk_t):
    """K6 (remat) against its plain version with K4's bounds (in bf16 as
    FLIP_SHARE says, and closer to it than to K6 in float32), and against K4
    in the same dtype with the reference's remat bounds (logZ rtol 1e-5,
    gamma rtol 1e-4 atol 1e-5, xi rtol 1e-4 atol 1e-4;
    tests/test_hmm_estep_pallas.py:241-261).  chunk_t = 11 divides none of
    the cases' Ts (26, 60, 175)."""
    corpus, params, concepts, (log_init, base, rowz, colmask) = _inputs(name, dev)
    args = (log_init, base, rowz, colmask,
            k1.table_lookup(params.log_emit, corpus.src, concepts), corpus.src_len)
    assert corpus.max_src_len % 11 != 0
    logz32 = None
    for dot_dtype in ("float32", "bfloat16"):
        before = k2.hmm_estep.launches_remat
        gamma, xi, logz = k2.hmm_estep(*args, dot_dtype=dot_dtype, remat=True,
                                       chunk_t=chunk_t)
        assert k2.hmm_estep.launches_remat == before + 1
        gamma_p, xi_p, logz_p = k2.hmm_estep_remat_plain(*args, dot_dtype, chunk_t)
        torch.testing.assert_close(logz, logz_p, rtol=1e-4, atol=1e-4)
        assert torch.all(logz[-3:] == 0) and torch.all(gamma[-3:] == 0)
        if logz32 is None:
            torch.testing.assert_close(gamma, gamma_p, rtol=1e-3, atol=1e-4)
            torch.testing.assert_close(xi, xi_p, rtol=1e-3, atol=1e-3)
            logz32 = logz
        else:
            _assert_close_but_flips(gamma, gamma_p, rtol=1e-3, atol=1e-4)
            _assert_close_but_flips(xi, xi_p, rtol=1e-3, atol=1e-3)
            _assert_rounds(logz, logz_p, logz32)
        gamma4, xi4, logz4 = k2.hmm_estep(*args, dot_dtype=dot_dtype)
        torch.testing.assert_close(logz, logz4, rtol=1e-5, atol=0)
        torch.testing.assert_close(gamma, gamma4, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(xi, xi4, rtol=1e-4, atol=1e-4)


def test_k6_rejects_a_chunk_longer_than_its_local_array(dev):
    corpus, params, concepts, fact = _inputs("S12", dev)
    args = (*fact, k1.table_lookup(params.log_emit, corpus.src, concepts), corpus.src_len)
    with pytest.raises(ValueError, match="chunk_t"):
        k2.hmm_estep(*args, remat=True, chunk_t=k2.MAX_CHUNK + 1)


def test_crf_gradient_through_k4_matches_plain(dev):
    """The CRF's MLP gradient through K4 (logmarginal on the card) against
    the same gradient through the plain dense E-step: rtol 1e-4, with atol
    1e-4 x the largest gradient entry for entries near 0."""
    pc, pg, _ = make_flickr8k_mini(n_utterances=24, seed=31)
    fc, _, _ = phones_to_frames(pc, pg, feat_dim=8, noise=0.1, seed=31, device=dev)
    params = hmm_dnn.init(fc, hidden=32, n_sgd=3, generator=torch.Generator().manual_seed(0))
    weights = list(params.mlp.parameters())
    grads = {}
    for use_kernels in (True, False):
        before = k2.hmm_estep.launches
        ll = hmm_crf.logmarginal(params.max_jump, use_kernels, "float32", params.log_jump,
                                 params.log_p0, hmm_crf._log_emit_from_mlp(params.mlp, fc), fc)
        grads[use_kernels] = torch.autograd.grad(ll, weights)
        assert k2.hmm_estep.launches == before + int(use_kernels)
    for g, g_p in zip(grads[True], grads[False]):
        torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4 * float(g_p.abs().max()))


@pytest.mark.parametrize("name", sorted(GENERAL_CASES))
def test_k4_kernel_matches_plain(dev, name):
    """Tolerances of tests/test_hmm_estep_pallas.py:74-80; xi is summed with
    atomics in a varying order."""
    corpus, params, concepts, (log_init, base, rowz, colmask) = _inputs(name, dev)
    emit = k1.table_lookup(params.log_emit, corpus.src, concepts)
    args = (log_init, base, rowz, colmask, emit, corpus.src_len)
    before = k2.hmm_estep.launches
    gamma, xi, logz = k2.hmm_estep(*args)
    assert k2.hmm_estep.launches == before + 1
    gamma_p, xi_p, logz_p = k2.hmm_estep_plain(*args)
    torch.testing.assert_close(logz, logz_p, rtol=1e-4, atol=1e-4)
    assert torch.all(logz[-3:] == 0) and torch.all(gamma[-3:] == 0)
    torch.testing.assert_close(logz.sum(), logz_p.sum(), rtol=1e-6, atol=0)
    torch.testing.assert_close(gamma, gamma_p, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(xi, xi_p, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", sorted(GENERAL_CASES))
def test_k3_kernel_matches_plain(dev, name):
    """Paths agree on >= 0.99 of valid frames and scores to rtol 1e-5 atol
    1e-3 (tests/test_viterbi_pallas.py:61-65)."""
    corpus, params, concepts, (log_init, base, rowz, colmask) = _inputs(name, dev)
    args = (log_init, base, rowz, colmask, hmm._log_emissions(params, corpus, concepts),
            corpus.src_len)
    before = k3.viterbi.launches
    path = k3.viterbi(*args)
    assert k3.viterbi.launches == before + 1 and path.dtype == torch.int32
    path_p = k3.viterbi_plain(*args)
    mask = corpus.src_mask()
    assert (path == path_p)[mask].float().mean() >= 0.99
    torch.testing.assert_close(k3.path_score(path, *args), k3.path_score(path_p, *args),
                               rtol=1e-5, atol=1e-3)


def test_k3_backpointers_in_global_scratch(dev):
    """Ts * S bytes beyond shared memory: the backpointers go to a global
    scratch.  Random inputs have no ties, so the paths are equal."""
    gen = torch.Generator().manual_seed(0)
    n, ts, s = 3, 1400, 128
    f32 = dict(dtype=torch.float32)
    args = (torch.randn(n, s, generator=gen, **f32), torch.randn(s, s, generator=gen, **f32),
            torch.randn(n, s, generator=gen, **f32), torch.zeros(n, s, **f32),
            torch.randn(n, ts, s, generator=gen, **f32),
            torch.tensor([ts, 700, 0], dtype=torch.int32))
    args = tuple(a.to(dev) for a in args)
    assert not _build.load().mwd_viterbi_bp_in_smem(ts, s)
    assert torch.equal(k3.viterbi(*args), k3.viterbi_plain(*args))


def _random_factored(n, ts, s, lens, seed, dev):
    """Factored inputs from a seed: a random jump table, utterances with
    7 or 14 of their S states masked (every row keeps valid columns), random
    emissions, lengths ``lens`` (ragged, zeros included)."""
    gen = torch.Generator().manual_seed(seed)
    n_valid = torch.tensor([s - 7 * (i % 3) for i in range(n)])
    colmask = torch.where(torch.arange(s)[None, :] < n_valid[:, None], 0.0, NEG_INF)
    base = 2.0 * torch.randn(s, s, generator=gen)
    rowz = torch.logsumexp(base[None, :, :] + colmask[:, None, :], dim=-1)
    log_init = torch.log_softmax(torch.randn(n, s, generator=gen) + colmask, dim=-1)
    emit = 3.0 * torch.randn(n, ts, s, generator=gen)
    src_len = torch.tensor(lens, dtype=torch.int32)
    return tuple(x.contiguous().to(dev) for x in (log_init, base, rowz, colmask, emit, src_len))


def _k4_k6_k3_against_plain(args, chunks=(11, 32)):
    """K4, K4-bf16 and K6 against their plain versions with K4's bounds (bf16
    as FLIP_SHARE says), K6 against K4 with the reference's remat bounds, and
    K3's paths and scores against the plain decoder's."""
    gamma_p, xi_p, logz_p = k2.hmm_estep_plain(*args)
    before = (k2.hmm_estep.launches, k2.hmm_estep.launches_bf16, k2.hmm_estep.launches_remat)
    gamma, xi, logz = k2.hmm_estep(*args)
    torch.testing.assert_close(logz, logz_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(logz.sum(), logz_p.sum(), rtol=1e-6, atol=0)
    torch.testing.assert_close(gamma, gamma_p, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(xi, xi_p, rtol=1e-3, atol=1e-3)
    empty = args[5] == 0
    assert torch.all(logz[empty] == 0) and torch.all(gamma[empty] == 0)
    g16, xi16, z16 = k2.hmm_estep(*args, dot_dtype="bfloat16")
    g16_p, xi16_p, z16_p = k2.hmm_estep_plain(*args, dot_dtype="bfloat16")
    torch.testing.assert_close(z16, z16_p, rtol=1e-4, atol=1e-4)
    _assert_close_but_flips(g16, g16_p, rtol=1e-3, atol=1e-4)
    _assert_close_but_flips(xi16, xi16_p, rtol=1e-3, atol=1e-3)
    _assert_rounds(z16, z16_p, logz)
    for chunk_t in chunks:
        g6, xi6, z6 = k2.hmm_estep(*args, remat=True, chunk_t=chunk_t)
        torch.testing.assert_close(z6, logz, rtol=1e-5, atol=0)
        torch.testing.assert_close(g6, gamma, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(xi6, xi, rtol=1e-4, atol=1e-4)
    assert (k2.hmm_estep.launches, k2.hmm_estep.launches_bf16,
            k2.hmm_estep.launches_remat) == (before[0] + 1, before[1] + 1, before[2] + len(chunks))
    path, path_p = k3.viterbi(*args), k3.viterbi_plain(*args)
    valid = torch.arange(args[4].shape[1], device=path.device)[None, :] < args[5][:, None]
    assert (path == path_p)[valid].float().mean() >= 0.99
    torch.testing.assert_close(k3.path_score(path, *args), k3.path_score(path_p, *args),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("s", [161, 200, 260, 1300, 2000])
def test_kernels_take_many_states(dev, s):
    """Above the old 160-state limit (S = 260 is past K3's 8-bit
    backpointers; at S = 1300 K4's backward and at S = 2000 its forward keep
    their block buffers in device memory, and K3's threads loop over the
    states) K4, K4-bf16, K6 and K3 answer as their plain versions do, on
    ragged and zero lengths."""
    args = _random_factored(6, 40, s, [40, 33, 0, 17, 40, 1], s, dev)
    _k4_k6_k3_against_plain(args)


@pytest.mark.parametrize("s", [8, 40])
def test_k4_empty_batch_launches_nothing(dev, s):
    """A batch of no utterances gives empty outputs and a zero xi, launches
    no kernel, and leaves every variant's launch count as it was."""
    args = _random_factored(0, 5, s, [], s, dev)
    before = (k2.hmm_estep.launches, k2.hmm_estep.launches_bf16, k2.hmm_estep.launches_remat)
    for kw in ({}, {"dot_dtype": "bfloat16"}, {"remat": True}):
        gamma, xi, logz = k2.hmm_estep(*args, **kw)
        assert gamma.shape == (0, 5, s) and logz.shape == (0,)
        assert xi.shape == (s, s) and torch.all(xi == 0)
    assert (k2.hmm_estep.launches, k2.hmm_estep.launches_bf16,
            k2.hmm_estep.launches_remat) == before


@pytest.mark.parametrize("s, n, ts", [(8, 13, 37), (12, 9, 23), (20, 5, 30), (40, 300, 30)])
def test_kernels_batch_utterances(dev, s, n, ts):
    """Several utterances a warp (S = 8: four; S = 12: two) or a block
    (S = 40, 75 blocks: the two-pass xi reduction), with lengths that
    differ within a warp and a block and some zero."""
    lens = [(7 * i) % (ts + 1) for i in range(n)]
    _k4_k6_k3_against_plain(_random_factored(n, ts, s, lens, 100 + s, dev))


# (S, N): several utterances a warp (S <= 32) or a block (S > 32; N = 2100
# gives blocks of 8), N a multiple of neither
K2_SHAPES = [(8, 37), (12, 29), (20, 13), (33, 9), (40, 30), (64, 21), (64, 2100)]


@pytest.mark.parametrize("vocab", [(49, 61), (128, 256)])
@pytest.mark.parametrize("s, n", K2_SHAPES)
def test_k2_kernels_batch_utterances(dev, s, n, vocab):
    """K2 and K2-bf16 on ragged and zero lengths, with the headline's counts
    table and the gate's largest (V_src=128, V_trg=256: on the warp path
    the posteriors go straight into device memory), each one launch:
    against the plain versions with K2's bounds (xi with K4's, as K2's xi is
    K4's code; bf16 as FLIP_SHARE says), logZ bit-identical to K4's (the
    same forward), xi within rtol 1e-4 of K4's (only its chunking differs)
    and the counts within K2's bound of K7 on K4's gamma."""
    ts = 23
    lens = [(7 * i) % (ts + 1) for i in range(n)]
    args6 = _random_factored(n, ts, s, lens, 200 + s, dev)
    v_src, v_trg = vocab
    gen = torch.Generator().manual_seed(s)
    src = torch.randint(0, v_src, (n, ts), generator=gen, dtype=torch.int32).to(dev)
    conc = torch.randint(0, v_trg, (n, s), generator=gen, dtype=torch.int32).to(dev)
    args = (*args6[:5], src, conc, args6[5], v_src, v_trg)
    empty = args6[5] == 0
    for dot_dtype, attr in (("float32", "launches"), ("bfloat16", "launches_bf16")):
        before = getattr(k2.hmm_estep_counts, attr)
        counts, xi, logz = k2.hmm_estep_counts(*args, dot_dtype=dot_dtype)
        assert getattr(k2.hmm_estep_counts, attr) == before + 1
        counts_p, xi_p, logz_p = k2.hmm_estep_counts_plain(*args, dot_dtype=dot_dtype)
        torch.testing.assert_close(logz, logz_p, rtol=1e-4, atol=1e-4)
        assert torch.all(logz[empty] == 0)
        torch.testing.assert_close(logz.sum(), logz_p.sum(), rtol=1e-6, atol=0)
        scale = max(float(counts_p.max()), 1.0)
        if dot_dtype == "float32":
            torch.testing.assert_close(counts, counts_p, rtol=0, atol=1e-4 * scale)
            torch.testing.assert_close(xi, xi_p, rtol=1e-3, atol=1e-3)
        else:
            _assert_close_but_flips(counts, counts_p, rtol=0, atol=1e-4 * scale)
            _assert_close_but_flips(xi, xi_p, rtol=1e-3, atol=1e-3)
        gamma4, xi4, logz4 = k2.hmm_estep(*args6, dot_dtype=dot_dtype)
        assert torch.equal(logz, logz4)
        torch.testing.assert_close(xi, xi4, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(counts, k1.pair_counts(gamma4, src, conc, v_src, v_trg),
                                   rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("v_trg", [61, 4096])
@pytest.mark.parametrize("s, n", [(12, 29), (12, 2100), (64, 21), (64, 2100)])
def test_k2_same_bits_twice(dev, s, n, v_trg):
    """K2 and K2-bf16 called twice on one input give the same counts, xi
    and logZ bit for bit (the counts' adds are integer adds, in any order),
    on the warp path (S=12) and the block path (S=64, blocks of 4 and 8),
    with the count table in shared memory (V_trg=61) and the counts in
    device memory (V_trg=4096)."""
    ts = 41
    lens = [(5 * i) % (ts + 1) for i in range(n)]
    args6 = _random_factored(n, ts, s, lens, 300 + s, dev)
    gen = torch.Generator().manual_seed(n)
    src = torch.randint(0, 49, (n, ts), generator=gen, dtype=torch.int32).to(dev)
    conc = torch.randint(0, 61, (n, s), generator=gen, dtype=torch.int32).to(dev)
    args = (*args6[:5], src, conc, args6[5], 49, v_trg)
    for dot_dtype in ("float32", "bfloat16"):
        first = k2.hmm_estep_counts(*args, dot_dtype=dot_dtype)
        second = k2.hmm_estep_counts(*args, dot_dtype=dot_dtype)
        for a, b in zip(first, second):
            assert torch.equal(a, b)
        assert first[0].any()


@pytest.mark.parametrize("name", ["S12", "S64"])
def test_hmm_train_same_bits_twice(dev, name):
    """hmm.train through the kernels twice from one init: every
    iteration's loglik and the final parameters equal bit for bit, at the
    headline's S=12 and at S=64 (both through K1 + K2)."""
    gen = CASES["S12"] if name == "S12" else dict(
        n_utterances=300, n_concepts=200, min_concepts=29, max_concepts=32, min_word_len=2,
        max_word_len=3, seed=5)
    corpus, _, _ = make_flickr8k_mini(**gen)
    assert 2 * corpus.max_trg_len == int(name[1:])
    runs = []
    for _ in range(2):
        before = k2.hmm_estep_counts.launches
        runs.append(hmm.train(hmm.init(corpus), corpus, 5))
        assert k2.hmm_estep_counts.launches == before + 5
    (p1, l1), (p2, l2) = runs
    assert torch.equal(l1, l2)
    for f in ("log_emit", "log_jump", "log_p0"):
        assert torch.equal(getattr(p1, f), getattr(p2, f))


EM_CASES = {"S12": CASES["S12"],
            "S64": dict(n_utterances=300, n_concepts=200, min_concepts=29, max_concepts=32,
                        min_word_len=2, max_word_len=3, seed=5)}
GRAPH_COUNTERS = ("graph_calls", "captures", "replays")


def _graph_counters():
    return {c: getattr(hmm.em_step, c) for c in GRAPH_COUNTERS}


def _em_outputs(params, stats):
    return params.log_emit, params.log_jump, params.log_p0, stats["loglik"]


@pytest.mark.parametrize("dot_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(EM_CASES))
def test_em_step_graph_same_bits_as_eager(dev, name, dot_dtype):
    """Three hmm.em_step calls from one set of parameters on a new corpus
    (the eager call, the capturing call, a replay) give the same bits in
    every field and in the loglik, and each adds one to K1's and to K2's
    launch counter of its dtype."""
    corpus, _, _ = make_flickr8k_mini(**EM_CASES[name])
    p0 = hmm.init(corpus)
    k2_attr = "launches_bf16" if dot_dtype == "bfloat16" else "launches"
    before = _graph_counters()
    outs = []
    for _ in range(3):
        k1_n, k2_n = k1.table_lookup.launches, getattr(k2.hmm_estep_counts, k2_attr)
        outs.append(_em_outputs(*hmm.em_step(p0, corpus, dot_dtype=dot_dtype)))
        assert k1.table_lookup.launches == k1_n + 1
        assert getattr(k2.hmm_estep_counts, k2_attr) == k2_n + 1
    after = _graph_counters()
    assert [after[c] - before[c] for c in GRAPH_COUNTERS] == [3, 1, 2]
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            assert torch.equal(a, b)


def test_em_step_returns_fresh_tensors(dev):
    """What one call returned is unchanged after the calls that follow (each
    replay writes the graph's own buffers, and the call hands back clones)."""
    corpus, _, _ = make_flickr8k_mini(**EM_CASES["S12"])
    params, kept = hmm.init(corpus), []
    for _ in range(5):
        params, stats = hmm.em_step(params, corpus)
        out = _em_outputs(params, stats)
        kept.append((out, tuple(t.clone() for t in out)))
    torch.cuda.synchronize()
    for out, copy in kept:
        for a, b in zip(out, copy):
            assert torch.equal(a, b)
    assert not torch.equal(kept[1][0][0], kept[2][0][0])  # the iterations moved
    ptrs = [t.data_ptr() for out, _ in kept for t in out]
    assert len(set(ptrs)) == len(ptrs)


def test_em_step_graphs_per_corpus_and_bounded(dev):
    """Each corpus of another shape captures anew, the cache keeps at most
    MAX_GRAPHS keys, and a plain or CPU call never captures."""
    before = _graph_counters()
    corpora = [make_flickr8k_mini(**dict(CASES["S12"], n_utterances=20 + 4 * i, seed=i))[0]
               for i in range(hmm.MAX_GRAPHS + 2)]
    for corpus in corpora:
        params = hmm.init(corpus)
        for _ in range(3):
            params, _ = hmm.em_step(params, corpus)
        assert len(hmm._GRAPHS) <= hmm.MAX_GRAPHS
    after = _graph_counters()
    assert after["captures"] - before["captures"] == len(corpora)
    held = [g.corpus for g in hmm._GRAPHS.values() if g is not None]
    assert all(any(c is k for k in corpora[-hmm.MAX_GRAPHS:]) for c in held)
    keys = list(hmm._GRAPHS)
    corpus = corpora[-1]
    cpu = corpus.to("cpu")
    for _ in range(3):
        hmm.em_step(params, corpus, use_kernels=False)
        hmm.em_step(hmm.init(cpu), cpu)
    assert _graph_counters() == after and list(hmm._GRAPHS) == keys


@pytest.fixture
def cudnn_unpinned():
    """cuDNN free to pick any algorithm outside the steps (another test may
    have pinned it); restored afterwards."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, False
    yield
    cudnn.benchmark, cudnn.deterministic = saved


def _all_equal(first, second):
    """Every tensor of two (state, stats) results equal bit for bit."""
    def leaves(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, torch.nn.Module):
            yield from x.state_dict().values()
        elif hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                yield from leaves(getattr(x, f))
        elif isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from leaves(v)

    a, b = list(leaves(first)), list(leaves(second))
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["discrete", "frames"])
def test_attention_step_same_bits_twice(dev, cudnn_unpinned, kind):
    """One attention step twice from one state: the loss, the parameters
    and the AdamW moments equal bit for bit.  Discrete: the embeddings'
    fixed-order backward, guided by K4's posteriors on K1's emissions;
    frames: the subsampling convolution's backward, guided by a Gaussian
    teacher."""
    from multimodalworddiscovery_tpu_torch.models import attention

    c, g, _ = make_flickr8k_mini(**CASES["S12"], device=dev)
    if kind == "discrete":
        corpus, sub = c, 1
        teacher, _ = hmm.train(hmm.init(corpus), corpus, 3)
        guide = attention.hmm_guide_matrix(teacher, corpus)
    else:
        corpus, _, _ = phones_to_frames(c, g, feat_dim=13, seed=3, device=dev)
        sub = 2
        teacher = hmm_gaussian.init(corpus, n_components=2,
                                    generator=torch.Generator().manual_seed(0))
        teacher, _ = hmm_gaussian.train(teacher, corpus, 3)
        guide = attention.hmm_guide_matrix(teacher, corpus,
                                           posteriors_fn=hmm_gaussian.posteriors)
    state = attention.init(corpus, dim=32, subsample=sub,
                           generator=torch.Generator().manual_seed(0))
    first = attention.em_step(state, corpus, guide=guide)
    _all_equal(first, attention.em_step(state, corpus, guide=guide))
    assert not torch.backends.cudnn.deterministic


@pytest.mark.parametrize("kind", ["ids", "frames"])
def test_grounding_step_same_bits_twice(dev, cudnn_unpinned, kind):
    """One grounding step twice from one state (the embeddings' and the
    convolutions' backward): the loss, the parameters and the Adam moments
    equal bit for bit."""
    from multimodalworddiscovery_tpu_torch.models import grounding

    corpus, g, _ = make_flickr8k_mini(**CASES["S12"], device=dev)
    if kind == "frames":
        corpus, _, _ = phones_to_frames(corpus, g, feat_dim=13, seed=3, device=dev)
    state = grounding.init(corpus, dim=32, generator=torch.Generator().manual_seed(0))
    first = grounding.em_step(state, corpus)
    _all_equal(first, grounding.em_step(state, corpus))
    assert not torch.backends.cudnn.deterministic


def test_detector_step_same_bits_twice(dev, cudnn_unpinned):
    """Three detector Adam steps twice from one initialisation (the
    convolutions' backward under the step's deterministic context): every
    step's stats, the weights and the Adam moments equal bit for bit."""
    from multimodalworddiscovery_tpu_torch.data import make_boxes_mini
    from multimodalworddiscovery_tpu_torch.frontend import detector

    cfg = detector.DetectorConfig(image_size=32, widths=(8, 16, 32), channels=16)
    images, boxes, mask = (torch.as_tensor(a, device=dev)
                           for a in make_boxes_mini(n_images=6, image_size=32, seed=2))
    runs = []
    for _ in range(2):
        model = detector.init(cfg, torch.Generator().manual_seed(0), dev)
        step = detector.make_train_step(model, torch.as_tensor(cfg.anchors(), device=dev), 1e-3)
        opt, stats = hmm_dnn.adam_init(model.parameters()), []
        for _ in range(3):
            opt, st = step(opt, images, boxes, mask)
            stats.append(st)
        runs.append((model, opt, stats))
    _all_equal(*runs)
    assert not torch.backends.cudnn.deterministic


@pytest.mark.parametrize("s, n, ts", [(12, 300, 31), (128, 64, 181)])
def test_k7_same_bits_twice(dev, s, n, ts):
    """K7 called twice gives the same counts bit for bit, on K4's
    posteriors and on random nonnegative weights (rows summing to far more
    than 1), with the table in shared memory and in device memory."""
    gamma, src, conc = (x.to(dev) for x in _k7_random(n, ts, s, 49, 401, s))
    for n_cols in (401, 4096):
        first = k1.pair_counts(gamma, src, conc, 49, n_cols)
        assert torch.equal(first, k1.pair_counts(gamma, src, conc, 49, n_cols))
    corpus, params, concepts, fact = _inputs("S128", dev)
    post = k2.hmm_estep(*fact, k1.table_lookup(params.log_emit, corpus.src, concepts),
                        corpus.src_len)[0]
    f, e = params.log_emit.shape
    for n_cols in (e, 4096):
        first = k1.pair_counts(post, corpus.src, concepts, f, n_cols)
        assert torch.equal(first, k1.pair_counts(post, corpus.src, concepts, f, n_cols))


@pytest.mark.parametrize("s", [12, 40])
def test_k2_empty_batch_launches_nothing(dev, s):
    """A batch of no utterances gives zero counts and xi and an empty logZ,
    and launches and counts nothing."""
    args6 = _random_factored(0, 5, s, [], s, dev)
    src = torch.zeros((0, 5), dtype=torch.int32, device=dev)
    conc = torch.zeros((0, s), dtype=torch.int32, device=dev)
    args = (*args6[:5], src, conc, args6[5], 7, 9)
    before = (k2.hmm_estep_counts.launches, k2.hmm_estep_counts.launches_bf16)
    for dot_dtype in ("float32", "bfloat16"):
        counts, xi, logz = k2.hmm_estep_counts(*args, dot_dtype=dot_dtype)
        assert counts.shape == (7, 9) and torch.all(counts == 0)
        assert xi.shape == (s, s) and torch.all(xi == 0) and logz.shape == (0,)
    assert (k2.hmm_estep_counts.launches, k2.hmm_estep_counts.launches_bf16) == before


# (S, N, Ts): the warp path (S <= 32; at Ts = 700 its backpointers in device
# memory), the block path with split chains (S <= 128, and S = 161 on 1024
# threads; one utterance a block in small batches, odd S among them;
# N = 2100: blocks of 8, two an SM), 16-bit backpointers (S = 260), base
# and backpointers in device memory (S = 1300) and the block's buffers too
# (S = 2600)
K3_SHAPES = [(8, 37, 45), (12, 37, 45), (20, 37, 45), (20, 9, 700), (40, 37, 45),
             (41, 37, 45), (40, 2100, 12), (64, 37, 45), (128, 13, 40), (161, 7, 30),
             (260, 9, 30), (1300, 5, 12), (2600, 5, 10)]


@pytest.mark.parametrize("kind", ["ties", "random"])
@pytest.mark.parametrize("s, n, ts", K3_SHAPES)
def test_k3_batches_utterances_and_breaks_ties_low(dev, s, n, ts, kind):
    """K3 on several utterances a warp or a block, ragged and zero lengths:
    the path equals the plain decoder's on the CPU (the same float32 sums,
    ties to the lowest state), also where integer-valued inputs make exact
    ties everywhere (kind "ties"), frozen tails and empty utterances
    included; one launch a call."""
    lens = [(7 * i) % (ts + 1) for i in range(n)]
    args = _random_factored(n, ts, s, lens, 300 + s, dev)
    if kind == "ties":
        args = tuple(torch.round(a) if a.is_floating_point() else a for a in args)
    before = k3.viterbi.launches
    path = k3.viterbi(*args)
    assert k3.viterbi.launches == before + 1
    want = k3.viterbi_plain(*(a.cpu() for a in args))
    assert torch.equal(path.cpu(), want)


def test_general_route_matches_plain_em(dev):
    """S=128 discrete EM through K1 + K4 against the plain dense route."""
    corpus, params, _, _ = _inputs("S128", dev)
    before = k2.hmm_estep.launches
    p_k, lls_k = hmm.train(params, corpus, 2, use_kernels=True)
    assert k2.hmm_estep.launches == before + 2
    p_p, lls_p = hmm.train(params, corpus, 2, use_kernels=False)
    torch.testing.assert_close(lls_k, lls_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(p_k.log_emit, p_p.log_emit, rtol=1e-3, atol=1e-3)


def test_gaussian_kernel_route_matches_plain(dev):
    """Annealed Gaussian EM and decode through K4 and K3 against the plain
    path on the card."""
    pc, pg, _ = make_flickr8k_mini(n_utterances=40, seed=23)
    fc, fg, _ = phones_to_frames(pc, pg, feat_dim=12, noise=0.1, seed=23, device=dev)
    p0 = hmm_gaussian.init_diagonal(fc, generator=torch.Generator().manual_seed(0))
    runs = {}
    for use_kernels in (True, False):
        p, lls = hmm_gaussian.train(p0, fc, 4, use_kernels=use_kernels, anneal=(0.25, 2))
        runs[use_kernels] = (lls, hmm_gaussian.align(p, fc, use_kernels=use_kernels))
    torch.testing.assert_close(runs[True][0], runs[False][0], rtol=1e-4, atol=0)
    same = (runs[True][1] == runs[False][1])[fc.src_mask()].float().mean()
    assert same >= 0.99


# K5 against its plain version: the JAX package's K5 bound
# (tests/test_mfcc_pallas.py:33) on valid frames
MFCC_TOL = dict(rtol=1e-3, atol=2e-3)


def _waveforms(dev, lens, length):
    rng = np.random.default_rng(len(lens))
    wav = np.zeros((len(lens), length), np.float32)
    t = np.arange(length) / 16000
    for i, n in enumerate(lens):
        wav[i, :n] = (0.1 * rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * (300 + 150 * i)
                                                                 * t[:n]))
    return (torch.as_tensor(wav, device=dev),
            torch.as_tensor(np.asarray(lens, np.int32), device=dev))


@pytest.mark.parametrize("kind", ["mfcc", "fbank"])
def test_k5_extract_matches_plain(dev, kind):
    """Utterances of 8000, 6000, 3000 samples and the edge lengths 0, 399,
    400 and 401 in one batch."""
    wav, lens = _waveforms(dev, [8000, 6000, 3000, 0, 399, 400, 401], 8000)
    cfg = speech.MfccConfig()
    before = k5.extract.launches
    got, fl = k5.extract(wav, lens, cfg, kind)
    assert k5.extract.launches == before + 1
    want, fl_p = k5.extract_plain(wav, lens, cfg, kind)
    assert torch.equal(fl, fl_p) and fl[-4:].tolist() == [0, 0, 1, 1]
    assert got.shape == want.shape == (7, 48, 26 if kind == "fbank" else 13)
    valid = torch.arange(got.shape[1], device=dev)[None, :] < fl[:, None]
    torch.testing.assert_close(got[valid], want[valid], **MFCC_TOL)


@pytest.mark.parametrize("n_fft", [512, 400, 255])
@pytest.mark.parametrize("m", [0, 1, 63, 65, 1000])
def test_k5_frames_matches_plain(dev, m, n_fft):
    """Frame counts around and off a block's run of frames; M = 0 launches
    nothing.  The frame stride is the window: through the FFT (512), and
    the direct DFT with its span padded (400) or not (255)."""
    cfg = speech.MfccConfig(n_mfcc=13, n_mels=26, n_fft=n_fft, win_length=min(400, n_fft))
    gen = torch.Generator().manual_seed(m)
    frames = (0.2 * torch.randn(m, cfg.win_length, generator=gen)).to(dev)
    before = k5.mfcc_from_frames.launches
    for kind, n_out in (("mfcc", 13), ("fbank", 26)):
        got = k5.mfcc_from_frames(frames, cfg, kind)
        assert got.shape == (m, n_out)
        torch.testing.assert_close(got, k5.mfcc_from_frames_plain(frames, cfg, kind),
                                   **MFCC_TOL)
    assert k5.mfcc_from_frames.launches == before + (2 if m else 0)


def test_k5_short_batch_has_no_frames(dev):
    wav, lens = _waveforms(dev, [0, 399], 399)
    got, fl = k5.extract(wav, lens)
    assert got.shape == (2, 0, 13) and fl.tolist() == [0, 0]


def test_k5_wrappers_validate_inputs(dev):
    wav, lens = _waveforms(dev, [8000, 3000], 8000)
    with pytest.raises(ValueError, match="cpu"):
        k5.extract(wav, lens.cpu())
    with pytest.raises(TypeError, match="float32"):
        k5.extract(wav.double(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        k5.extract(wav[:, ::2], lens)
    frames = torch.zeros((10, 400), device=dev)
    with pytest.raises(TypeError, match="float32"):
        k5.mfcc_from_frames(frames.double())
    with pytest.raises(ValueError, match="contiguous"):
        k5.mfcc_from_frames(torch.zeros((400, 10), device=dev).t())
    with pytest.raises(ValueError, match="shape"):
        k5.mfcc_from_frames(frames[:, :399].contiguous())
    with pytest.raises(ValueError, match="win_length"):
        k5.mfcc_from_frames(torch.zeros((10, 4000), device=dev),
                            speech.MfccConfig(win_length=4000, n_fft=2048))


@pytest.mark.parametrize("n_fft", [255, 256, 400, 401, 402, 512, 1024, 2048])
def test_k5_n_fft_matches_plain(dev, n_fft):
    """Every n_fft the kernel takes through either branch: powers of two
    through the FFT, the rest through the direct DFT (400 and 402 folded,
    401 and 255, with a 255-sample window, unfolded, their shared-memory
    regions after an odd-sized twiddle table); both kinds, launched."""
    wav, lens = _waveforms(dev, [8000, 6000, 3000, 0, 399, 400, 401], 8000)
    cfg = speech.MfccConfig(n_fft=n_fft, win_length=min(400, n_fft))
    for kind in ("mfcc", "fbank"):
        before = k5.extract.launches
        got, fl = k5.extract(wav, lens, cfg, kind)
        assert k5.extract.launches == before + 1
        want, _ = k5.extract_plain(wav, lens, cfg, kind)
        valid = torch.arange(got.shape[1], device=dev)[None, :] < fl[:, None]
        torch.testing.assert_close(got[valid], want[valid], **MFCC_TOL)


@pytest.mark.parametrize("n_fft,n_mels", [(4096, 26), (8192, 26), (3000, 26), (32768, 26),
                                           (512, 300), (512, 512), (4096, 300)])
def test_k5_large_n_fft_and_mels_match_plain(dev, n_fft, n_mels):
    """Past the run kernel's old limits: powers of two above 2048 through the
    frame-a-warp FFT (32768: its buffers in the device workspace), 3000
    through its direct DFT, and 300 / 512 mels (runs shrunk to fit, the
    log-mel outputs wider than a block's staging); extract and
    mfcc_from_frames, both kinds, launched."""
    wav, lens = _waveforms(dev, [8000, 6000, 3000, 0, 399, 400, 401], 8000)
    cfg = speech.MfccConfig(n_fft=n_fft, n_mels=n_mels)
    frames = speech.frame_signal(speech.preemphasize(wav[:2], cfg.preemphasis), cfg)
    frames = frames.reshape(-1, cfg.win_length)[:70].contiguous()
    for kind in ("mfcc", "fbank"):
        before = k5.extract.launches, k5.mfcc_from_frames.launches
        got, fl = k5.extract(wav, lens, cfg, kind)
        want, _ = k5.extract_plain(wav, lens, cfg, kind)
        valid = torch.arange(got.shape[1], device=dev)[None, :] < fl[:, None]
        torch.testing.assert_close(got[valid], want[valid], **MFCC_TOL)
        torch.testing.assert_close(k5.mfcc_from_frames(frames, cfg, kind),
                                   k5.mfcc_from_frames_plain(frames, cfg, kind), **MFCC_TOL)
        assert (k5.extract.launches, k5.mfcc_from_frames.launches) == (before[0] + 1,
                                                                       before[1] + 1)


@pytest.mark.parametrize("n_fft,win,hop", [(512, 400, 160), (400, 400, 160), (401, 400, 161),
                                           (255, 255, 100)])
@pytest.mark.parametrize("length", [4000, 9921, 28160])
def test_k5_runs_straddle_blocks_and_row_ends(dev, length, n_fft, win, hop):
    """Rows whose frame count is not a multiple of a block's run (23, 60
    and 174 frames at the defaults), rows cut from one buffer at an offset
    that leaves their samples unaligned, and rows whose last samples are
    large, so a pre-emphasis that reached across a row start would show;
    through the FFT (512) and the direct DFT, its span padded (an even hop)
    or not (an odd one)."""
    rng = np.random.default_rng(length)
    flat = (0.2 * rng.standard_normal(5 * length + 3)).astype(np.float32)
    flat[length - 2: length + 1] = 50.0  # the end of row 0 and the start of row 1
    buf = torch.as_tensor(flat, device=dev)
    cfg = speech.MfccConfig(n_fft=n_fft, win_length=win, hop_length=hop)
    for off in (0, 1, 3):
        wav = buf[off: off + 5 * length].view(5, length)
        got, fl = k5.extract(wav, None, cfg)
        want, _ = k5.extract_plain(wav, None, cfg)
        assert got.shape == want.shape == (5, speech.num_frames(length, cfg), 13)
        torch.testing.assert_close(got, want, **MFCC_TOL)


def test_k5_preemphasis_starts_each_row(dev):
    """y[0] = x[0] at the start of every row: row 1's first frame equals
    that of a batch holding row 1 alone, and differs from a row whose
    first sample were pre-emphasized against row 0's last."""
    cfg = speech.MfccConfig()
    wav = torch.zeros((2, 800), device=dev)
    wav[0, -1] = 1.0
    wav[1, 0] = 0.5
    got, _ = k5.extract(wav, None, cfg, "fbank")
    alone, _ = k5.extract(wav[1:].contiguous(), None, cfg, "fbank")
    torch.testing.assert_close(got[1], alone[0], rtol=0, atol=0)
    want, _ = k5.extract_plain(wav, None, cfg, "fbank")
    torch.testing.assert_close(got, want, **MFCC_TOL)


def test_entry_points_default_to_the_card(dev):
    """With no device named, the data and parameter entry points build on
    cuda:0."""
    corpus, gold, _ = make_flickr8k_mini(n_utterances=4, seed=1)
    assert corpus.src.device == dev and corpus.trg_len.device == dev
    fc, _, _ = phones_to_frames(corpus, gold, feat_dim=4)
    assert fc.src.device == dev
    p = hmm.params_from_numpy(np.zeros((3, 2), np.float32), np.zeros(7, np.float32),
                              np.float32(-1.0))
    assert p.log_emit.device == dev


def test_models_default_to_the_kernels_on_the_card(dev):
    """With no use_kernels, a CUDA corpus goes through the kernels: the
    discrete EM through K1 and K2, the Gaussian EM through K4, decode
    through K3, and the waveform pipeline through K5 as well."""
    corpus, _, _ = make_flickr8k_mini(**CASES["S12"])
    counters = (k1.table_lookup, k2.hmm_estep_counts, k2.hmm_estep, k3.viterbi, k5.extract)
    for w in counters:
        w.launches = 0
    hmm.train(hmm.init(corpus), corpus, 1)
    hmm.align(hmm.init(corpus), corpus)
    assert k1.table_lookup.launches > 0 and k2.hmm_estep_counts.launches > 0
    assert k3.viterbi.launches > 0
    for w in counters:
        w.launches = 0
    out = run_pipeline.run_pipeline(n_utterances=16, iters=2)
    assert k5.extract.launches == 1 and k2.hmm_estep.launches == 2 and k3.viterbi.launches == 1
    assert np.all(np.isfinite(out["loglik"]))


@pytest.mark.parametrize("name", sorted(GENERAL_CASES))
def test_k7_kernel_matches_plain(dev, name):
    """K7 on K4's gamma against the plain scatter-add: rtol 1e-5, atol 1e-4
    x the largest count (the atomics order the sums)."""
    corpus, params, concepts, fact = _inputs(name, dev)
    gamma = k2.hmm_estep(*fact, k1.table_lookup(params.log_emit, corpus.src, concepts),
                         corpus.src_len)[0]
    f, e = params.log_emit.shape
    before = k1.pair_counts.launches
    got = k1.pair_counts(gamma, corpus.src, concepts, f, e)
    assert k1.pair_counts.launches == before + 1
    want = k1.pair_counts_plain(gamma, corpus.src, concepts, f, e)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * float(want.max()))


def test_k7_validates_inputs(dev):
    corpus, params, concepts, fact = _inputs("S12", dev)
    gamma = torch.zeros((corpus.n, corpus.max_src_len, concepts.shape[1]), device=dev)
    with pytest.raises(TypeError, match="int32"):
        k1.pair_counts(gamma, corpus.src.long(), concepts, 4, 4)
    with pytest.raises(ValueError, match="shape"):
        k1.pair_counts(gamma[:, :-1].contiguous(), corpus.src, concepts, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        k1.pair_counts(gamma.transpose(1, 2).contiguous().transpose(1, 2), corpus.src,
                       concepts, 4, 4)


def _k7_random(n, ts, s, f, e, seed, all_null=False):
    rng = np.random.default_rng(seed)
    gamma = rng.random((n, ts, s)).astype(np.float32)
    gamma[rng.random((n, ts, s)) < 0.3] = 0.0
    src = rng.integers(0, f, (n, ts)).astype(np.int32)
    conc = rng.integers(1, e, (n, s)).astype(np.int32)
    conc[rng.random((n, s)) < 0.5] = 0
    if all_null:
        conc[:] = 0
    return [torch.as_tensor(x) for x in (gamma, src, conc)]


def test_k7_table_in_device_memory(dev):
    """The same posteriors with n_cols=4096 (a 49 x 4096 table, beyond
    shared memory, added straight into counts): the first 401 columns equal
    the narrow result (table in shared memory) and the rest stay 0."""
    gamma, src, conc = (x.to(dev) for x in _k7_random(64, 181, 128, 49, 401, 0))
    narrow = k1.pair_counts(gamma, src, conc, 49, 401)
    wide = k1.pair_counts(gamma, src, conc, 49, 4096)
    scale = float(narrow.max())
    torch.testing.assert_close(wide[:, :401], narrow, rtol=1e-5, atol=1e-4 * scale)
    assert not wide[:, 401:].any()
    want = k1.pair_counts_plain(gamma, src, conc, 49, 4096)
    torch.testing.assert_close(wide, want, rtol=1e-5, atol=1e-4 * scale)


@pytest.mark.parametrize("s", [12, 128, 200, 33, 5, 64])
@pytest.mark.parametrize("all_null", [False, True])
def test_k7_null_rows_match_plain(dev, s, all_null):
    """Rows whose states are all null (every posterior to concept 0), and
    nulls scattered over the row, at S = 12 (float4 loads, a row a segment
    of 4 lanes, 8 rows a warp), 5 (scalar loads, segments of 8 lanes), 64
    (float4, segments of 16), 128 (float4, a row a warp), 200 and 33
    (scalar loads over chunks of 32)."""
    gamma, src, conc = (x.to(dev) for x in _k7_random(40, 30, s, 49, 401, s, all_null))
    before = k1.pair_counts.launches
    got = k1.pair_counts(gamma, src, conc, 49, 401)
    assert k1.pair_counts.launches == before + 1
    want = k1.pair_counts_plain(gamma, src, conc, 49, 401)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * float(want.max()))
    if all_null:
        assert not got[:, 1:].any()


def test_k7_empty_gamma_launches_nothing(dev):
    before = k1.pair_counts.launches
    for n, ts in ((0, 5), (4, 0)):
        got = k1.pair_counts(torch.zeros((n, ts, 12), device=dev),
                             torch.zeros((n, ts), dtype=torch.int32, device=dev),
                             torch.zeros((n, 12), dtype=torch.int32, device=dev), 49, 61)
        assert got.shape == (49, 61) and not got.any()
    assert k1.pair_counts.launches == before


def _normal(shape, scale, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((scale * rng.normal(size=shape)).astype(np.float32), device=dev)


@pytest.mark.parametrize("shape", [(128, 128, 128), (64, 200, 96), (300, 140, 260)])
def test_k8_kernel_matches_plain(dev, shape):
    """K8 against the broadcast oracle at the reference's shapes and bound,
    rtol 1e-4 atol 1e-4 (tests/test_log_semiring_pallas.py:10-18)."""
    i, k, j = shape
    a, b = _normal((i, k), 5.0, i, dev), _normal((k, j), 5.0, j, dev)
    before = k8.log_matmul.launches
    got = k8.log_matmul(a, b)
    assert k8.log_matmul.launches == before + 1
    torch.testing.assert_close(got, k8.log_matmul_plain(a, b), rtol=1e-4, atol=1e-4)


def test_k8_neg_inf_and_wide_range(dev):
    """A fully masked row and column give NEG_INF; a row spanning 300 nats
    whose largest product lies 250 nats below its maximum keeps that term."""
    a, b = _normal((64, 64), 1.0, 0, dev), _normal((64, 64), 1.0, 1, dev)
    a[3, :] = NEG_INF
    b[:, 7] = NEG_INF
    got = k8.log_matmul(a, b)
    assert torch.all(got[3] == NEG_INF) and torch.all(got[:, 7] == NEG_INF)
    torch.testing.assert_close(got, k8.log_matmul_plain(a, b), rtol=1e-4, atol=1e-4)
    a = torch.full((64, 96), -300.0, device=dev)
    b = torch.full((96, 48), -300.0, device=dev)
    a[1:, :10], b[:10, 1:] = _normal((63, 10), 2.0, 2, dev), _normal((10, 47), 2.0, 3, dev)
    a[0, 0], a[0, 5], b[0, 0], b[5, 0] = 0.0, -250.0, -400.0, 240.0
    got = k8.log_matmul(a, b)
    assert abs(float(got[0, 0]) + 10.0) < 1e-4
    torch.testing.assert_close(got, k8.log_matmul_plain(a, b), rtol=1e-4, atol=1e-4)


def test_k8_batches_strided_views(dev):
    """The associative scan's operands: step-2 slices along the time axis
    of [T, N, S, S] (two strided batch dimensions), a broadcast operand, and
    leading dimensions that do not merge (copied)."""
    m = _normal((7, 5, 24, 24), 3.0, 4, dev)
    a, b = m[0:-1:2], m[1::2]
    assert not a.is_contiguous()
    torch.testing.assert_close(k8.log_matmul(a, b), k8.log_matmul_plain(a, b),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k8.log_matmul(m[0], m), k8.log_matmul_plain(m[0], m),
                               rtol=1e-4, atol=1e-4)
    x = m.transpose(0, 1)[:, 0:-1:2]  # [5, 3, 24, 24]: two strided dimensions
    y = _normal((4, 4, 4, 24, 24), 3.0, 7, dev)[::2, ::2, ::2]  # three that do not merge
    for v in (x, y):
        torch.testing.assert_close(k8.log_matmul(v, v), k8.log_matmul_plain(v, v),
                                   rtol=1e-4, atol=1e-4)


def test_k8_bf16_matches_plain(dev):
    """K8-bf16 against its plain bf16 version at 2e-2 (two bf16 roundings
    that fall apart on a product's operands), against K8 within the
    reference's 5e-2 (tests/test_log_semiring_pallas.py:57-67), and closer
    to the plain bf16 version than to K8."""
    a, b = _normal((96, 160), 4.0, 5, dev), _normal((160, 72), 4.0, 6, dev)
    before = k8.log_matmul.launches_bf16
    got = k8.log_matmul(a, b, "bfloat16")
    assert k8.log_matmul.launches_bf16 == before + 1
    torch.testing.assert_close(got, k8.log_matmul_plain(a, b, "bfloat16"), rtol=0, atol=2e-2)
    f32 = k8.log_matmul(a, b)
    torch.testing.assert_close(got, f32, rtol=0, atol=5e-2)
    _assert_rounds(got, k8.log_matmul_plain(a, b, "bfloat16"), f32)


def _oracle64(a, b):
    return torch.logsumexp(a.double()[..., :, :, None] + b.double()[..., None, :, :],
                           dim=-2).float().clamp(min=NEG_INF)


@pytest.mark.parametrize("k", [96, 200])
def test_k8_guard_keeps_terms_below_the_maxima(dev, k):
    """A log-space identity (a frozen carry) times a b whose columns span 200
    nats: out[i, j] = b[i, j], most of it more than 87 nats below its
    column's maximum, where the factored form flushes it; the guard sums
    those elements again (its count rises), with K in one tile (96) and
    streamed (200)."""
    eye = torch.full((k, k), NEG_INF, device=dev)
    eye.fill_diagonal_(0.0)
    b = -200.0 * torch.as_tensor(np.random.default_rng(k).random((k, 72)), dtype=torch.float32,
                                 device=dev)
    k8.reset_guard(dev)
    got = k8.log_matmul(eye, b)
    took, summed = k8.guard_counts(dev)
    assert took >= summed > 0
    torch.testing.assert_close(got, b, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, k8.log_matmul_plain(eye, b), rtol=1e-4, atol=1e-4)
    # and as the scan meets it: b's rows spanning 200 nats times the identity
    torch.testing.assert_close(k8.log_matmul(b.t().contiguous(), eye), b.t(), rtol=1e-4,
                               atol=1e-4)


def test_k8_wide_range_rows_against_float64(dev):
    """The 250-nat wide-range rows against the float64 oracle, taking the
    guard (row 0's dominant term lies 250 nats below its maximum)."""
    a = torch.full((64, 96), -300.0, device=dev)
    b = torch.full((96, 48), -300.0, device=dev)
    a[1:, :10], b[:10, 1:] = _normal((63, 10), 5.0, 12, dev), _normal((10, 47), 5.0, 13, dev)
    a[0, 0], a[0, 5], b[0, 0], b[5, 0] = 0.0, -250.0, -400.0, 240.0
    k8.reset_guard(dev)
    got = k8.log_matmul(a, b)
    assert k8.guard_counts(dev)[1] >= 1
    torch.testing.assert_close(got, _oracle64(a, b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 1, 1), (17, 130, 257), (257, 17, 130), (130, 257, 17),
                                   (1, 257, 130), (257, 1, 17), (200, 129, 200)])
def test_k8_odd_shapes_and_masked_tiles(dev, shape):
    """I, J and K off every tile, in one K tile and streamed; NEG_INF rows,
    columns and a whole 64 x 64 tile's rows over a K range (zero support)."""
    i, k, j = shape
    a, b = _normal((i, k), 5.0, i + k, dev), _normal((k, j), 5.0, k + j, dev)
    for dot_dtype in ("float32", "bfloat16"):
        torch.testing.assert_close(k8.log_matmul(a, b, dot_dtype),
                                   k8.log_matmul_plain(a, b, dot_dtype), rtol=1e-4,
                                   atol=1e-4 if dot_dtype == "float32" else 2e-2)
    a[: i // 2, : k // 2] = NEG_INF
    b[k // 2:, : j // 3] = NEG_INF
    a[-1] = NEG_INF
    b[:, -1] = NEG_INF
    got = k8.log_matmul(a, b)
    torch.testing.assert_close(got, k8.log_matmul_plain(a, b), rtol=1e-4, atol=1e-4)
    assert torch.all(got[-1] == NEG_INF) and torch.all(got[:, -1] == NEG_INF)


@pytest.mark.parametrize("shape", [(17, 130, 33), (50, 257, 70), (1, 5, 3), (96, 64, 130)])
def test_k8_bf16_odd_shapes_match_plain(dev, shape):
    """K8-bf16 (tensor cores) against its plain bf16 version at sizes that
    are not multiples of 16, within 2e-2, and within 5e-2 of K8."""
    i, k, j = shape
    a, b = _normal((i, k), 4.0, i, dev), _normal((k, j), 4.0, j + 1, dev)
    got = k8.log_matmul(a, b, "bfloat16")
    torch.testing.assert_close(got, k8.log_matmul_plain(a, b, "bfloat16"), rtol=0, atol=2e-2)
    torch.testing.assert_close(got, k8.log_matmul(a, b), rtol=0, atol=5e-2)


@pytest.mark.parametrize("name", ["S12", "S40"])
def test_matrix_forwards_through_k8(dev, name):
    """forward_associative and forward_blocked on the card (K8) against the
    sequential forward: logZ rtol 1e-4, alphas rtol 1e-3 atol 1e-3 at valid
    (t, state) positions (tests/test_hmm.py:168-205)."""
    corpus, params, _, _ = _inputs(name, dev)
    log_init, log_trans, log_emit = hmm._machinery(params, corpus)
    a_s, z_s = hmm_core.forward(log_init, log_trans, log_emit, corpus.src_len)
    valid = ((torch.arange(a_s.shape[0], device=dev)[:, None, None]
              < corpus.src_len[None, :, None]) & hmm_core.state_mask(corpus)[None])
    for fn in (hmm_core.forward_associative, hmm_core.forward_blocked):
        before = k8.log_matmul.launches
        a, z = fn(log_init, log_trans, log_emit, corpus.src_len)
        assert k8.log_matmul.launches > before
        torch.testing.assert_close(z, z_s, rtol=1e-4, atol=0)
        torch.testing.assert_close(a[valid], a_s[valid], rtol=1e-3, atol=1e-3)


def test_general_route_launches_k1_k4_k7(dev):
    """Outside K2's gate the discrete E-step launches K1, K4 and K7 once
    each (K4-bf16 and K7 in bf16), never K2, and its counts match the plain
    route's."""
    corpus, params, _, _ = _inputs("S128", dev)
    counters = (k1.table_lookup, k1.pair_counts, k2.hmm_estep, k2.hmm_estep_counts)
    for dot_dtype in ("float32", "bfloat16"):
        before = [(w.launches, getattr(w, "launches_bf16", 0)) for w in counters]
        (ec, _), _ = hmm.expected_counts(params, corpus, use_kernels=True, dot_dtype=dot_dtype)
        after = [(w.launches, getattr(w, "launches_bf16", 0)) for w in counters]
        k4 = (0, 1) if dot_dtype == "bfloat16" else (1, 0)
        assert [(x - y, u - v) for (x, u), (y, v) in zip(after, before)] == [
            (1, 0), (1, 0), k4, (0, 0)]
    (ec, _), _ = hmm.expected_counts(params, corpus, use_kernels=True)
    (ec_p, _), _ = hmm.expected_counts(params, corpus, use_kernels=False)
    torch.testing.assert_close(ec, ec_p, rtol=0, atol=1e-4 * float(ec_p.max()))


@pytest.mark.parametrize("gen", [
    dict(n_utterances=300, n_concepts=60, min_concepts=3, max_concepts=6, seed=0),
    dict(n_utterances=64, n_concepts=200, min_concepts=24, max_concepts=32, min_word_len=3,
         max_word_len=5, seed=1),
])
def test_k1_at_model1_shapes_exact(dev, gen):
    """K1 on Model-1's pair log-probs (concepts [N, 1+Tt] with the NULL
    column 0) equals the plain gather bit for bit, and so do Model-1's
    posteriors and align through it; ``_align_concept_space`` equals the
    dense decode on the card."""
    from multimodalworddiscovery_tpu_torch.models import model1

    corpus, _, _ = make_flickr8k_mini(**gen, device=dev)
    corpus = corpus.pad_to(corpus.n + 3)
    params, _ = model1.train(model1.init(corpus), corpus, 3)
    trg_ext, _ = model1._extended_targets(corpus)
    before = k1.table_lookup.launches
    got = k1.table_lookup(params.log_t, corpus.src, trg_ext)
    assert k1.table_lookup.launches == before + 1
    assert torch.equal(got, k1.table_lookup_plain(params.log_t, corpus.src, trg_ext))
    assert torch.equal(model1.posteriors(params, corpus),
                       model1.posteriors(params, corpus, use_kernels=False))
    dense = model1.align(params, corpus)
    assert torch.equal(dense, model1.align(params, corpus, use_kernels=False))
    assert torch.equal(dense, model1._align_concept_space(params, corpus))


@pytest.mark.parametrize("direction", ["c2i", "i2c"])
def test_k1_at_pooled_retrieval_rows_exact(dev, direction):
    """Pooled retrieval's K1 launch (rows x C paired rows) equals the plain
    gather bit for bit, one launch a chunk, and the scores equal the plain
    route's."""
    from multimodalworddiscovery_tpu_torch.eval import retrieval
    from multimodalworddiscovery_tpu_torch.models import model1

    corpus, _, _ = make_flickr8k_mini(n_utterances=200, n_concepts=60, min_concepts=3,
                                      max_concepts=6, seed=2, device=dev)
    params, _ = model1.train(model1.init(corpus), corpus, 3)
    cand = retrieval.sample_candidate_pools(corpus.n, 16, torch.Generator().manual_seed(0),
                                            device=dev)
    paired = retrieval._paired(corpus, torch.arange(corpus.n, device=dev), cand, direction)
    trg_ext, _ = model1._extended_targets(paired)
    got = k1.table_lookup(params.log_t, paired.src, trg_ext)
    assert torch.equal(got, k1.table_lookup_plain(params.log_t, paired.src, trg_ext))
    before = k1.table_lookup.launches
    scores = retrieval.retrieval_scores_model1_pooled(params, corpus, cand, direction)
    assert k1.table_lookup.launches == before + 1  # one chunk at this size
    plain = retrieval.retrieval_scores_model1_pooled(params, corpus, cand, direction,
                                                     use_kernels=False)
    assert torch.equal(scores, plain)


def test_guide_k4_gamma_matches_plain_posteriors(dev):
    """The guide's posteriors through K4 (discrete teacher on K1's
    emissions; Gaussian teacher) against the plain forward-backward: K4's
    bounds (gamma rtol 1e-3 atol 1e-4), and the guides built from them."""
    from multimodalworddiscovery_tpu_torch.models import attention

    corpus, gold, _ = make_flickr8k_mini(**CASES["S12"], device=dev)
    corpus = corpus.pad_to(corpus.n + 3)
    hp, _ = hmm.train(hmm.init(corpus), corpus, 3)
    before = k2.hmm_estep.launches
    gamma = hmm.posteriors(hp, corpus)
    assert k2.hmm_estep.launches == before + 1
    torch.testing.assert_close(gamma, hmm.posteriors(hp, corpus, use_kernels=False),
                               rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(attention.hmm_guide_matrix(hp, corpus),
                               attention.hmm_guide_matrix(hp, corpus, use_kernels=False),
                               rtol=1e-3, atol=1e-4)
    c, g, _ = make_flickr8k_mini(n_utterances=40, seed=3)
    fc, _, _ = phones_to_frames(c, g, feat_dim=13, seed=3, device=dev)
    gp = hmm_gaussian.init(fc, n_components=2, generator=torch.Generator().manual_seed(0))
    gp, _ = hmm_gaussian.train(gp, fc, 3)
    torch.testing.assert_close(hmm_gaussian.posteriors(gp, fc),
                               hmm_gaussian.posteriors(gp, fc, use_kernels=False),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["S12", "S128"])
def test_dense_viterbi_agrees_with_k3(dev, name):
    """The dense ``hmm_core.viterbi`` (plain torch on the card) against
    ``viterbi_factored`` through K3: equal paths except at exact ties, and
    every path's score within rtol 1e-5 of K3's."""
    corpus, params, _, fact = _inputs(name, dev)
    li, lt, le = hmm._machinery(params, corpus)
    dense = hmm_core.viterbi(li, lt, le, corpus.src_len)
    before = k3.viterbi.launches
    fast = hmm_core.viterbi_factored(*fact, le, corpus.src_len)
    assert k3.viterbi.launches == before + 1
    valid = corpus.src_mask()
    same = (torch.where(valid, dense, 0) == torch.where(valid, fast, 0)).all(dim=1)
    s_dense = k3.path_score(dense, *fact, le, corpus.src_len)
    s_fast = k3.path_score(fast, *fact, le, corpus.src_len)
    torch.testing.assert_close(s_dense, s_fast, rtol=1e-5, atol=0)
    assert float(same.float().mean()) >= 0.9


def test_crf_minibatch_step_through_k4(dev):
    """``make_minibatch_step(hmm_crf.em_step)`` on a CUDA corpus: n_sgd + 1
    K4 launches a step, and the step's parameters within the CRF's bounds
    of the plain route's from the same state and draw."""
    from multimodalworddiscovery_tpu_torch.models import minibatch

    c, g, _ = make_flickr8k_mini(n_utterances=40, seed=41)
    fc, _, _ = phones_to_frames(c, g, feat_dim=12, noise=0.1, seed=41, device=dev)
    p0 = hmm_dnn.init(fc, hidden=32, generator=torch.Generator().manual_seed(0))
    out = {}
    for use_kernels in (True, False):
        step = minibatch.make_minibatch_step(
            lambda p, b, u=use_kernels: hmm_crf.em_step(p, b, use_kernels=u), fc, 16)
        before = k2.hmm_estep.launches
        out[use_kernels] = step(p0, torch.Generator().manual_seed(1))[0]
        launched = k2.hmm_estep.launches - before
        assert launched == ((p0.n_sgd + 1) if use_kernels else 0)
    for a, b in zip(out[True].mlp.parameters(), out[False].mlp.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(out[True].log_jump, out[False].log_jump, rtol=1e-3, atol=1e-4)


def test_vgg16_on_the_card_matches_the_cpu(dev):
    """The narrow VGG16 (32 x 32 input) on the card against the same weights
    on the CPU, TF32 off: rtol 1e-3, atol 1e-4 x the largest |ref|."""
    from multimodalworddiscovery_tpu_torch.frontend import image

    torch.backends.cudnn.allow_tf32 = False
    cpu = image.init_vgg16(num_classes=10, fc_dim=64, input_size=32, device="cpu")
    gpu = image.init_vgg16(num_classes=10, fc_dim=64, input_size=32, device=dev)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, size=(48, 40, 3)).astype(np.float32)
    boxes = np.array([[0.1, 0.1, 0.6, 0.5], [0.3, 0.2, 0.9, 0.95]], np.float32)
    want = image.region_embeddings(cpu, torch.as_tensor(img), torch.as_tensor(boxes))
    got = image.region_embeddings(gpu, torch.as_tensor(img, device=dev),
                                  torch.as_tensor(boxes, device=dev)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4 * float(want.abs().max()))
    x = torch.as_tensor(img)
    want = image.image_concepts(cpu, image.resize(x, 32, 32)[None])
    got = image.image_concepts(gpu, image.resize(x.to(dev), 32, 32)[None]).cpu()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4 * float(want.abs().max()))


def test_detector_steps_on_the_card_match_the_cpu(dev):
    """Three detector Adam steps from the same weights on the card and on
    the CPU (cuDNN deterministic, TF32 off), then equal proposals' keep."""
    from multimodalworddiscovery_tpu_torch.data import make_boxes_mini
    from multimodalworddiscovery_tpu_torch.frontend import detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = detector.DetectorConfig(image_size=32, widths=(8, 16, 32), channels=16)
    arrays = make_boxes_mini(n_images=6, image_size=32, seed=2)
    runs = {}
    for d in ("cpu", dev):
        images, boxes, mask = (torch.as_tensor(a, device=d) for a in arrays)
        model, hist = detector.train(cfg, images, boxes, mask, num_steps=3,
                                     generator=torch.Generator().manual_seed(0))
        anchors = torch.as_tensor(cfg.anchors(), device=d)
        runs[str(d)] = (model, hist, detector.propose(model, anchors, images, k=8,
                                                      score_thresh=0.3))
    (m_c, h_c, p_c), (m_g, h_g, p_g) = runs["cpu"], runs[str(dev)]
    assert abs(h_c[-1]["loss"] - h_g[-1]["loss"]) <= 1e-4 * abs(h_c[-1]["loss"])
    for a, b in zip(m_g.parameters(), m_c.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0, atol=1e-5)
    assert torch.equal(p_g[2].cpu(), p_c[2])


@pytest.mark.parametrize("prefetch", [1, 2])
def test_streamed_shards_on_the_card(dev, tmp_path, prefetch):
    """Shards copied from pinned memory on the reader's stream (float16
    frames upcast on the card) equal the files, and streamed EM through K1
    + K2 over the padded shards equals resident EM on the card."""
    from multimodalworddiscovery_tpu_torch.data.stream import (
        FIELDS, ShardedCorpusReader, train_streaming, write_shards)

    corpus, gold, _ = make_flickr8k_mini(**CASES["S12"], device=dev)
    write_shards(corpus, tmp_path / "ids", 16, gold=gold)  # 40 -> 3 shards, the last padded
    reader = ShardedCorpusReader(tmp_path / "ids", device=dev)
    for k, shard in enumerate(reader.shards(prefetch)):
        for f in FIELDS:
            want = np.load(tmp_path / "ids" / f"{f}_{k}.npy")
            np.testing.assert_array_equal(getattr(shard, f).cpu().numpy(), want, err_msg=f)
    k1.table_lookup.launches = k2.hmm_estep_counts.launches = 0
    ps, lls = train_streaming(hmm, hmm.init(corpus), reader, 3, prefetch=prefetch,
                              use_kernels=True)
    assert k2.hmm_estep_counts.launches == 3 * reader.num_shards
    pr, lls_ref = hmm.train(hmm.init(corpus), corpus, 3, use_kernels=True)
    np.testing.assert_allclose(lls, lls_ref.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(ps.log_emit.cpu().numpy(), pr.log_emit.cpu().numpy(), atol=1e-4)
    frames, _, _ = phones_to_frames(corpus, gold, feat_dim=8, seed=0, device=dev)
    write_shards(frames, tmp_path / "f16", 16, storage_dtype="float16")
    r16 = ShardedCorpusReader(tmp_path / "f16", device=dev)
    got = torch.cat([s.src for s in r16.shards(prefetch)])[: frames.n]
    assert got.dtype == torch.float32
    assert torch.equal(got, frames.src.half().float())
