"""Port speech frontend (MFCC / log-mel, deltas, CMVN), the plain version
of K5, the waveform synthesizers and the WAV helpers vs the JAX reference,
on the CPU.  Inputs come from numpy with a seed and go to both packages.

Tolerances, and why:

- tables (mel filterbank, DCT, Hann window), frame counts, frames and the
  synthetic waveforms: exact (the same numpy code, or the same samples);
- MFCC / log-mel features: rtol 1e-3, atol 2e-3 on valid frames, the JAX
  package's own K5 bound (tests/test_mfcc_pallas.py:33): a float32 FFT or
  DFT differs from another in the last digits, and log and DCT amplify
  that on quiet bins near the log floor;
- deltas and CMVN from the same features: rtol/atol 1e-5 (float32 sums in
  another order);
- the kernel's twiddle table times the window against the reference's
  cos/sin tables with the window folded in: rtol 1e-6, atol 1e-7 (one
  float32 product against a float64 product rounded once);
- the float64 models of the kernel's FFT and direct-DFT plans against
  np.fft.rfft: rtol/atol 1e-9 (float64 rounding only).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data import synthetic as jsynth
from multimodalworddiscovery_tpu.frontend import speech as jspeech
from multimodalworddiscovery_tpu.ops import mfcc_pallas as jmfcc
from multimodalworddiscovery_tpu.utils import audio as jaudio
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import synthetic as tsynth
from multimodalworddiscovery_tpu_torch.frontend import speech as tspeech
from multimodalworddiscovery_tpu_torch.ops import mfcc as tmfcc
from multimodalworddiscovery_tpu_torch.utils import audio as taudio

MFCC_TOL = dict(rtol=1e-3, atol=2e-3)
CONFIGS = {
    "default": dict(),
    "pipeline": dict(n_mfcc=13, n_mels=26),
    "40 mels, band-limited": dict(n_mels=40, n_mfcc=20, fmin=100.0, fmax=7000.0),
    "8 kHz, 256-point": dict(sample_rate=8000, win_length=200, hop_length=80, n_fft=256),
}
EDGE_LENGTHS = [0, 1, 399, 400, 401, 559, 560, 8000]


def _cfgs(name):
    return jspeech.MfccConfig(**CONFIGS[name]), tspeech.MfccConfig(**CONFIGS[name])


@pytest.fixture(scope="module")
def wavs():
    """tests/test_mfcc_pallas.py:10-18: noise plus one tone per utterance."""
    rng = np.random.default_rng(1)
    n, length = 3, 8000
    t = np.arange(length) / 16000
    wav = (0.1 * rng.normal(size=(n, length))).astype(np.float32)
    for i in range(n):
        wav[i] += 0.3 * np.sin(2 * np.pi * (300 + 150 * i) * t).astype(np.float32)
    lens = np.array([8000, 6000, 3000], dtype=np.int32)
    return wav, lens


def _valid_close(got, want, flens, **tol):
    assert got.shape == want.shape
    for i, fl in enumerate(flens):
        np.testing.assert_allclose(got[i, :fl], want[i, :fl], **tol, err_msg=f"utterance {i}")


def test_config_fields_and_defaults_match_jax():
    assert dataclasses.asdict(tspeech.MfccConfig()) == dataclasses.asdict(jspeech.MfccConfig())
    with pytest.raises(dataclasses.FrozenInstanceError):
        tspeech.MfccConfig().n_fft = 256


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tables_equal_jax(name):
    jcfg, tcfg = _cfgs(name)
    fb = tspeech.mel_filterbank(tcfg)
    assert fb.dtype == np.float32
    np.testing.assert_array_equal(fb, jspeech.mel_filterbank(jcfg))
    dct = tspeech.dct_matrix(tcfg.n_mfcc, tcfg.n_mels)
    assert dct.dtype == np.float32
    np.testing.assert_array_equal(dct, jspeech.dct_matrix(jcfg.n_mfcc, jcfg.n_mels))
    # the symmetric window of both packages (speech.py:110), not
    # torch.hann_window's periodic one
    window = tspeech.hann_window(tcfg.win_length)
    np.testing.assert_array_equal(window, np.hanning(jcfg.win_length).astype(np.float32))
    assert not np.array_equal(window, torch.hann_window(tcfg.win_length).numpy())
    np.testing.assert_allclose(tspeech.hz_to_mel(tspeech.mel_to_hz([0.0, 1000.0])),
                               [0.0, 1000.0], atol=1e-9)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_tables_match_reference_operands(name):
    """K5's tables against the reference kernel's operands
    (mfcc_pallas.py:_operands): one n_fft-entry twiddle table indexed by
    (t * k) mod n_fft, times the window, gives its cos/sin tables; the FFT
    stages' twiddles are rows of that table; the filters' pieces, with
    the packed weights, rebuild its filterbank (each piece inside its mel's
    range of pieces), and the transposed DCT is its DCT."""
    jcfg, tcfg = _cfgs(name)
    cos_w, sin_w, fb_t, dct_t = jmfcc._operands(jcfg)
    tw, stw, window, fb_w, plan, dct = (
        x.numpy() for x in tmfcc._tables(tcfg, torch.device("cpu")))
    win, n_bins = tcfg.win_length, tcfg.n_fft // 2 + 1
    idx = (np.arange(win)[:, None] * np.arange(n_bins)[None, :]) % tcfg.n_fft
    tol = dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tw[idx, 0] * window[:, None], cos_w[:win, :n_bins], **tol)
    np.testing.assert_allclose(-tw[idx, 1] * window[:, None], sin_w[:win, :n_bins], **tol)
    assert tmfcc.uses_fft(tcfg.n_fft)
    np.testing.assert_array_equal(stw, tw[tmfcc.stage_twiddle_index(tcfg.n_fft)])
    _, pieces, first = tmfcc.mel_pieces(tcfg)
    assert plan.dtype == np.int32
    np.testing.assert_array_equal(plan, np.concatenate([pieces.reshape(-1), first]))
    fb = np.zeros((tcfg.n_mels, n_bins), np.float32)
    for q, (m, lo, hi, off) in enumerate(pieces):
        assert first[m] <= q < first[m + 1] and lo < hi
        fb[m, lo:hi] = fb_w[off:off + hi - lo]
    np.testing.assert_array_equal(fb, fb_t[:n_bins, : tcfg.n_mels].T)
    np.testing.assert_array_equal(dct, dct_t[: tcfg.n_mels, : tcfg.n_mfcc])


def _stockham_power(x, n_fft):
    """csrc/mfcc.cu's FFT branch in float64: pack z[m] = x[2m] + i x[2m+1]
    (zero-padded to N = n_fft / 2), the Stockham stages in the kernel's
    order with the stages' twiddles as the kernel indexes them, then the
    split of each pair (k, N - k) and power / n_fft."""
    n = n_fft // 2
    xp = np.zeros((x.shape[0], n_fft))
    xp[:, : x.shape[1]] = x
    z = xp[:, 0::2] + 1j * xp[:, 1::2]
    ang = 2 * np.pi * np.arange(n_fft) / n_fft
    tw = np.cos(ang) + 1j * np.sin(ang)  # the host's (cos, sin) table
    stw = tw[tmfcc.stage_twiddle_index(n_fft)]
    ns, off = 1, 0
    for s, r_ in enumerate(tmfcc.fft_radices(n_fft)):
        nb = n // r_
        out = np.empty_like(z)
        for jb in range(nb):
            jm = jb % ns
            v = z[:, jb + nb * np.arange(r_)]
            if s > 0:
                v[:, 1:] *= np.conj(stw[off + jm * (r_ - 1): off + (jm + 1) * (r_ - 1)])
            v = np.fft.fft(v, axis=1)  # the radix-r_ butterfly
            out[:, (jb // ns) * ns * r_ + jm + ns * np.arange(r_)] = v
        if s > 0:
            off += ns * (r_ - 1)
        z, ns = out, ns * r_
    power = np.zeros((x.shape[0], n + 1))
    for k in range(n // 2 + 1):
        a, b = z[:, k], z[:, (n - k) % n]
        for kk, p, q in ((k, a, b), (n - k, b, a)):
            e, d = (p + np.conj(q)) / 2, p - np.conj(q)
            xk = e - 0.5j * np.conj(tw[kk]) * d
            power[:, kk] = np.abs(xk) ** 2 / n_fft
    return power


@pytest.mark.parametrize("n_fft", [32, 256, 512, 1024, 2048, 4096, 8192])
def test_kernel_fft_plan_gives_the_power_spectrum(n_fft):
    """The FFT plan of csrc/mfcc.cu (radix-8, then radix-4 stages of a
    Stockham FFT of n_fft / 2 points, then the real split) against
    np.fft.rfft's power spectrum; above 2048 the frame-a-warp kernel runs
    the same plan between two buffers."""
    rng = np.random.default_rng(n_fft)
    x = rng.normal(size=(3, n_fft * 3 // 4 + 1))  # odd: the last pair's odd sample is padding
    assert np.prod(tmfcc.fft_radices(n_fft)) == n_fft // 2
    assert set(tmfcc.fft_radices(n_fft)) <= {4, 8}
    want = np.abs(np.fft.rfft(x, n=n_fft)) ** 2 / n_fft
    np.testing.assert_allclose(_stockham_power(x, n_fft), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n_fft", [384, 400, 401, 402])
def test_kernel_dft_plan_gives_the_power_spectrum(n_fft):
    """The direct-DFT branch of csrc/mfcc.cu, for n_fft that is not a power
    of two, in float64 numpy: one twiddle table indexed by (t * k) mod
    n_fft; where n_fft is even (384, 400, 402) base bins k < (n_fft + 2)/4
    from even / odd partial sums, bin n_fft/2 - k as E - O (its twiddles
    are bin k's up to (-1)^t), and where n_fft % 4 == 0 (384, 400) bin
    n_fft/4 on its own; where it is odd (401) every bin as E + O on its
    own.  It gives rfft's power spectrum."""
    assert not tmfcc.uses_fft(n_fft)
    rng = np.random.default_rng(n_fft)
    win = n_fft * 3 // 4 + 1  # odd, so the last pair's odd sample is padding
    x = rng.normal(size=(5, win))
    ang = 2 * np.pi * np.arange(n_fft) / n_fft
    cos, sin = np.cos(ang), np.sin(ang)
    power = np.zeros((5, n_fft // 2 + 1))
    xp = np.pad(x, ((0, 0), (0, 1)))
    t = np.arange(0, win, 2)
    even = n_fft % 2 == 0
    for k in range((n_fft + 2) // 4 if even else n_fft // 2 + 1):
        we, wo = (t * k) % n_fft, ((t + 1) * k) % n_fft
        ec, es = xp[:, t] @ cos[we], xp[:, t] @ sin[we]
        oc, os_ = xp[:, t + 1] @ cos[wo], xp[:, t + 1] @ sin[wo]
        power[:, k] = (ec + oc) ** 2 + (es + os_) ** 2
        if even:
            power[:, n_fft // 2 - k] = (ec - oc) ** 2 + (es - os_) ** 2
    if n_fft % 4 == 0:
        quarter = n_fft // 4
        tq = (np.arange(win) % 4) * quarter  # (t * n_fft/4) mod n_fft
        power[:, quarter] = (x @ cos[tq]) ** 2 + (x @ sin[tq]) ** 2
    want = np.abs(np.fft.rfft(x, n=n_fft)) ** 2
    np.testing.assert_allclose(power, want, rtol=1e-9, atol=1e-9)


def test_num_frames_frame_lengths_and_frames_equal_jax():
    jcfg, tcfg = _cfgs("default")
    for n in EDGE_LENGTHS:
        assert tspeech.num_frames(n, tcfg) == jspeech.num_frames(n, jcfg), n
    lens = np.array(EDGE_LENGTHS, np.int32)
    want = np.maximum(0, (lens - jcfg.win_length) // jcfg.hop_length + 1)
    got = tspeech.frame_lengths(torch.as_tensor(lens), tcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(0)
    for length in (399, 400, 401, 1000):
        x = rng.normal(size=(2, length)).astype(np.float32)
        jf = np.asarray(jspeech.frame_signal(jnp.asarray(x), jcfg))
        tf = tspeech.frame_signal(torch.as_tensor(x), tcfg).numpy()
        assert tf.shape == jf.shape, length
        np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("kind", ["mfcc", "fbank"])
def test_extract_matches_jax_and_reference_kernel(wavs, kind):
    """The port's plain extract against the reference's jnp extract and its
    Pallas kernel in interpret mode; the K5 wrapper on CPU tensors is the
    plain version."""
    wav, lens = wavs
    jcfg, tcfg = _cfgs("default")
    want, jl = jspeech.extract(jnp.asarray(wav), jnp.asarray(lens), jcfg, kind=kind)
    want_k, _ = jmfcc.extract_pallas(jnp.asarray(wav), jnp.asarray(lens), jcfg, kind=kind,
                                     interpret=True)
    got, tl = tspeech.extract(torch.as_tensor(wav), torch.as_tensor(lens), tcfg, kind=kind)
    assert got.dtype == torch.float32 and tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for ref in (want, want_k):
        _valid_close(got.numpy(), np.asarray(ref), np.asarray(jl), **MFCC_TOL)
    wrapped, wl = tmfcc.extract(torch.as_tensor(wav), torch.as_tensor(lens), tcfg, kind)
    assert torch.equal(wrapped, got) and torch.equal(wl, tl)


@pytest.mark.parametrize("kind", ["mfcc", "fbank"])
def test_mfcc_from_frames_matches_reference_kernel(wavs, kind):
    """M = 100 frames, not a multiple of any tile, through the plain version
    (the K5 wrapper on CPU tensors) and the reference kernel in interpret
    mode."""
    wav, _ = wavs
    jcfg, tcfg = _cfgs("pipeline")
    pre = tspeech.preemphasize(torch.as_tensor(wav), tcfg.preemphasis)
    frames = tspeech.frame_signal(pre, tcfg).reshape(-1, tcfg.win_length)[:100].contiguous()
    want = np.asarray(jmfcc.mfcc_from_frames(jnp.asarray(frames.numpy()), jcfg, kind=kind,
                                             interpret=True))
    got = tmfcc.mfcc_from_frames(frames, tcfg, kind)
    n_out = tcfg.n_mels if kind == "fbank" else tcfg.n_mfcc
    assert got.shape == (100, n_out)
    np.testing.assert_allclose(got.numpy(), want, **MFCC_TOL)
    assert tmfcc.mfcc_from_frames(frames[:0], tcfg, kind).shape == (0, n_out)


def test_extract_short_and_empty_waveforms():
    """Utterances of 0, 399, 400 and 401 samples in one batch (1 or 0 valid
    frames), and a batch shorter than one window (no frames at all)."""
    jcfg, tcfg = _cfgs("default")
    rng = np.random.default_rng(5)
    lens = np.array([0, 399, 400, 401], np.int32)
    wav = np.zeros((4, 401), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = 0.3 * rng.standard_normal(n)
    want, jl = jspeech.extract(jnp.asarray(wav), jnp.asarray(lens), jcfg)
    got, tl = tspeech.extract(torch.as_tensor(wav), torch.as_tensor(lens), tcfg)
    np.testing.assert_array_equal(tl.numpy(), [0, 0, 1, 1])
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _valid_close(got.numpy(), np.asarray(want), np.asarray(jl), **MFCC_TOL)
    for kind, n_out in (("mfcc", 13), ("fbank", 26)):
        feats, fl = tspeech.extract(torch.zeros((2, 399)), None, tcfg, kind)
        assert feats.shape == (2, 0, n_out) and fl.tolist() == [0, 0]


def test_kernel_config_limits():
    """What K5 takes and refuses (checked before a CUDA launch): any n_fft
    from win_length up (powers of two from 32 through the FFT, the rest
    through the direct DFT; above RUN_N_FFT a frame a warp) and any n_mels
    from n_mfcc up, as the reference; a window longer than n_fft, more
    MFCCs than mels or a hop of 0 are refused, and an unknown kind fails on
    every device."""
    assert tmfcc.RUN_N_FFT == 2048
    for good in (dict(), dict(n_fft=384, win_length=384), dict(n_fft=400), dict(n_fft=1024),
                 dict(n_fft=1024, win_length=1000), dict(n_fft=2048, win_length=2048),
                 dict(n_fft=4096), dict(n_fft=8192, win_length=8192), dict(n_fft=3000),
                 dict(n_mels=300), dict(n_mels=300, n_mfcc=300)):
        tmfcc._check_config(tspeech.MfccConfig(**good), "mfcc")
    assert [tmfcc.uses_fft(n) for n in (16, 32, 384, 400, 512, 1024, 2048, 3000, 4096, 8192)] == [
        False, True, False, False, True, True, True, False, True, True]
    for bad in (dict(n_fft=384), dict(win_length=600), dict(n_fft=2049, win_length=2050),
                dict(n_mfcc=30, n_mels=26), dict(hop_length=0), dict(n_mels=0, n_mfcc=0)):
        with pytest.raises(ValueError):
            tmfcc._check_config(tspeech.MfccConfig(**bad), "mfcc")
    with pytest.raises(ValueError, match="win_length"):
        tmfcc._check_config(tspeech.MfccConfig(n_fft=256), "mfcc")
    with pytest.raises(ValueError, match="kind"):
        tmfcc.extract(torch.zeros((1, 800)), None, tspeech.MfccConfig(), "spectrogram")


@pytest.mark.parametrize("n_fft", [400, 1024, 4096, 3000])
def test_extract_other_n_fft_matches_reference_kernel(wavs, n_fft):
    """An n_fft the kernel takes through its direct DFT (400), one past the
    old 512 limit (1024), and two past the old 2048 limit (4096, a power
    of two, and 3000): the port's plain extract against the reference
    kernel in interpret mode, which takes any n_fft >= win."""
    wav, lens = wavs
    jcfg = jspeech.MfccConfig(n_fft=n_fft)
    tcfg = tspeech.MfccConfig(n_fft=n_fft)
    tmfcc._check_config(tcfg, "mfcc")
    want, jl = jmfcc.extract_pallas(jnp.asarray(wav), jnp.asarray(lens), jcfg, interpret=True)
    got, tl = tmfcc.extract(torch.as_tensor(wav), torch.as_tensor(lens), tcfg)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _valid_close(got.numpy(), np.asarray(want), np.asarray(jl), **MFCC_TOL)


@pytest.mark.parametrize("kind", ["mfcc", "fbank"])
@pytest.mark.parametrize("cfg_kw", [dict(n_mels=300), dict(n_fft=4096, n_mels=40, n_mfcc=20),
                                    dict(n_fft=8192, n_mels=300)])
def test_large_configs_match_reference_kernel(wavs, cfg_kw, kind):
    """Past the old limits (n_mels 256, n_fft 2048): the port's plain extract
    and mfcc_from_frames (the K5 wrappers on CPU tensors) against the
    reference kernel in interpret mode, on a batch of three waveforms."""
    wav, lens = wavs
    jcfg, tcfg = jspeech.MfccConfig(**cfg_kw), tspeech.MfccConfig(**cfg_kw)
    tmfcc._check_config(tcfg, kind)
    want, jl = jmfcc.extract_pallas(jnp.asarray(wav), jnp.asarray(lens), jcfg, kind=kind,
                                    interpret=True)
    got, tl = tmfcc.extract(torch.as_tensor(wav), torch.as_tensor(lens), tcfg, kind)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _valid_close(got.numpy(), np.asarray(want), np.asarray(jl), **MFCC_TOL)
    pre = tspeech.preemphasize(torch.as_tensor(wav), tcfg.preemphasis)
    frames = tspeech.frame_signal(pre, tcfg).reshape(-1, tcfg.win_length)[:40].contiguous()
    want_f = np.asarray(jmfcc.mfcc_from_frames(jnp.asarray(frames.numpy()), jcfg, kind=kind,
                                               interpret=True))
    np.testing.assert_allclose(tmfcc.mfcc_from_frames(frames, tcfg, kind).numpy(), want_f,
                               **MFCC_TOL)


@pytest.mark.parametrize("width", [1, 2])
def test_deltas_and_cmvn_match_jax(width):
    rng = np.random.default_rng(width)
    feats = rng.normal(size=(5, 11, 4)).astype(np.float32)
    flens = np.array([11, 7, 1, 0, 3], np.int32)
    want = np.asarray(jspeech.add_deltas(jnp.asarray(feats), jnp.asarray(flens), width))
    got = tspeech.add_deltas(torch.as_tensor(feats), torch.as_tensor(flens), width)
    assert got.shape == (5, 11, 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jspeech.cmvn(jnp.asarray(feats), jnp.asarray(flens)))
    got = tspeech.cmvn(torch.as_tensor(feats), torch.as_tensor(flens))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not got[3].any()  # an empty utterance stays zero


@pytest.mark.parametrize("seed", [0, 3])
def test_waveform_synthesis_identical_to_jax(seed):
    kw = dict(n_utterances=6, n_phones=24, seed=seed)
    jc, jg, _ = jax_make(**kw)
    tc, tg, _ = torch_make(**kw, device="cpu")
    jw, jl, _ = jsynth.phones_to_waveforms(jc, jg, noise=0.02, seed=seed)
    tw, tl, gold = tsynth.phones_to_waveforms(tc, tg, noise=0.02, seed=seed)
    assert tw.dtype == np.float32 and gold is tg
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tsynth.phone_templates(tc.src_vocab, seed=seed),
                                  jsynth.phone_templates(jc.src_vocab, seed=seed))
    for noise, pad in ((0.0, None), (0.0, 40), (0.02, None)):
        jb, jbl = jsynth.phones_to_waveforms_batched(jc, noise=noise, seed=seed, pad_phones=pad)
        tb, tbl = tsynth.phones_to_waveforms_batched(tc, noise=noise, seed=seed, pad_phones=pad)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tbl, jbl)
    frame_lens = np.maximum(0, (tl - 400) // 160 + 1)
    want = jsynth.expand_gold_to_frames(jg, np.asarray(jc.src_len), frame_lens)
    got = tsynth.expand_gold_to_frames(tg, tc.src_len.numpy(), frame_lens)
    np.testing.assert_array_equal(got.alignment, want.alignment)
    assert got.segments == want.segments


@pytest.mark.parametrize("rate", [16000, 8000])
def test_wav_round_trip_matches_jax(tmp_path, rate):
    rng = np.random.default_rng(rate)
    x = np.clip(0.4 * rng.standard_normal(4000), -1.0, 1.0).astype(np.float32)
    taudio.write_wav(tmp_path / "t.wav", x, rate=rate)
    jaudio.write_wav(tmp_path / "j.wav", x, rate=rate)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got = taudio.read_wav(tmp_path / "t.wav")
    np.testing.assert_array_equal(got, jaudio.read_wav(tmp_path / "t.wav"))
    assert got.dtype == np.float32 and len(got) == 4000 * 16000 // rate
    if rate == 16000:
        np.testing.assert_allclose(got, x, atol=1.0 / 32767 + 1e-6)
