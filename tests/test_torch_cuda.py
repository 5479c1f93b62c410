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


@pytest.mark.parametrize("m", [0, 1, 63, 65, 1000])
def test_k5_frames_matches_plain(dev, m):
    """Frame counts around and off the kernel's 64-frame tile; M = 0
    launches nothing."""
    cfg = speech.MfccConfig(n_mfcc=13, n_mels=26)
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
    with pytest.raises(ValueError, match="n_fft"):
        k5.mfcc_from_frames(torch.zeros((10, 1000), device=dev),
                            speech.MfccConfig(win_length=1000, n_fft=1024))


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
