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


def test_kernels_reject_too_many_states(dev):
    n, ts, s = 2, 4, k2.MAX_STATES_GENERAL + 1
    z = torch.zeros
    args = (z(n, s, device=dev), z(s, s, device=dev), z(n, s, device=dev),
            z(n, s, device=dev), z(n, ts, s, device=dev),
            torch.full((n,), ts, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="160"):
        k2.hmm_estep(*args)
    with pytest.raises(ValueError, match="160"):
        k3.viterbi(*args)


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
