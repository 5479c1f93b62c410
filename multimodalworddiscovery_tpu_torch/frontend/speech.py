"""Speech frontend: MFCC / log-mel filterbank, deltas and CMVN, batched.

Counterpart of ``multimodalworddiscovery_tpu/frontend/speech.py``: 13-dim
MFCCs (or log-mels) from 25 ms windows at a 10 ms hop, optional delta and
delta-delta, per-utterance CMVN.  Variable-length audio is a padded batch
plus a sample-length array; frames past each utterance's length are
computed and masked by the returned frame lengths.

``extract`` here is plain torch (pre-emphasis, ``Tensor.unfold`` framing,
a symmetric Hann window, ``torch.fft.rfft``, the mel and DCT products) and
is the plain version of K5, the fused MFCC kernel in ``ops/mfcc.py``.
``add_deltas`` and ``cmvn`` have no kernel in either package.  The
filterbank and DCT tables are the reference's numpy code, copied, so both
packages build the same float32 tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MfccConfig:
    sample_rate: int = 16000
    win_length: int = 400  # 25 ms
    hop_length: int = 160  # 10 ms
    n_fft: int = 512
    n_mels: int = 26
    n_mfcc: int = 13
    fmin: float = 0.0
    fmax: float | None = None  # default sr/2
    preemphasis: float = 0.97
    delta_width: int = 2
    log_floor: float = 1e-10


KINDS = ("mfcc", "fbank")


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(cfg: MfccConfig) -> np.ndarray:
    """[n_mels, n_fft//2 + 1] triangular mel filters (HTK-style)."""
    fmax = cfg.fmax or cfg.sample_rate / 2
    mels = np.linspace(hz_to_mel(cfg.fmin), hz_to_mel(fmax), cfg.n_mels + 2)
    hz = mel_to_hz(mels)
    bins = np.floor((cfg.n_fft + 1) * hz / cfg.sample_rate).astype(int)
    fb = np.zeros((cfg.n_mels, cfg.n_fft // 2 + 1), dtype=np.float32)
    for m in range(1, cfg.n_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, c):
            if c > lo:
                fb[m - 1, k] = (k - lo) / (c - lo)
        for k in range(c, hi):
            if hi > c:
                fb[m - 1, k] = (hi - k) / (hi - c)
    return fb


def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """[n_mfcc, n_mels] orthonormal DCT-II."""
    k = np.arange(n_mfcc)[:, None]
    n = np.arange(n_mels)[None, :]
    d = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels)) * np.sqrt(2.0 / n_mels)
    d[0] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """The symmetric Hann window of the reference (``np.hanning``), float32.
    ``torch.hann_window`` is periodic by default and differs from it."""
    return np.hanning(win_length).astype(np.float32)


def num_frames(n_samples: int, cfg: MfccConfig) -> int:
    return max(0, (n_samples - cfg.win_length) // cfg.hop_length + 1)


def frame_lengths(wav_len: torch.Tensor, cfg: MfccConfig) -> torch.Tensor:
    """[N] int32 valid frames per utterance from sample counts (0 below one
    window)."""
    f = torch.div(wav_len.long() - cfg.win_length, cfg.hop_length, rounding_mode="floor") + 1
    return torch.clamp(f, min=0).to(torch.int32)


def preemphasize(wav: torch.Tensor, coef: float) -> torch.Tensor:
    """y[t] = x[t] - coef * x[t-1] along the last axis (y[0] = x[0])."""
    return torch.cat([wav[..., :1], wav[..., 1:] - coef * wav[..., :-1]], dim=-1)


def frame_signal(wav: torch.Tensor, cfg: MfccConfig) -> torch.Tensor:
    """[..., L] -> [..., F, win] overlapping frames (a strided view)."""
    f = num_frames(wav.shape[-1], cfg)
    if f == 0:
        return wav.new_zeros((*wav.shape[:-1], 0, cfg.win_length))
    return wav.unfold(-1, cfg.win_length, cfg.hop_length)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")


def features_from_frames(
    frames: torch.Tensor, cfg: MfccConfig = MfccConfig(), kind: str = "mfcc"
) -> torch.Tensor:
    """[M, win] pre-emphasized frames -> [M, n_mfcc] MFCCs (or [M, n_mels]
    log-mels for kind='fbank'): Hann window, zero-padded rfft of n_fft
    points, power / n_fft, mel filterbank, log with a floor, DCT-II."""
    _check_kind(kind)
    dev = frames.device
    if frames.shape[0] == 0:  # no frames: FFT back ends refuse empty input
        n_out = cfg.n_mels if kind == "fbank" else cfg.n_mfcc
        return frames.new_zeros((0, n_out))
    window = torch.as_tensor(hann_window(cfg.win_length), device=dev)
    spec = torch.fft.rfft(frames * window, n=cfg.n_fft, dim=-1)
    power = (spec.real**2 + spec.imag**2) / cfg.n_fft  # [M, n_fft//2+1]
    mel = power @ torch.as_tensor(mel_filterbank(cfg), device=dev).T
    logmel = torch.log(torch.clamp(mel, min=cfg.log_floor))
    if kind == "fbank":
        return logmel
    return logmel @ torch.as_tensor(dct_matrix(cfg.n_mfcc, cfg.n_mels), device=dev).T


def extract(
    wav: torch.Tensor,
    wav_len: torch.Tensor | None = None,
    cfg: MfccConfig = MfccConfig(),
    kind: str = "mfcc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched features.

    wav: [N, L] float32 in [-1, 1]; wav_len: [N] sample counts (None => full).
    kind: 'mfcc' -> [N, F, n_mfcc], 'fbank' -> [N, F, n_mels] log-mels.
    Returns (features, frame_lens [N] int32).
    """
    n, length = wav.shape
    if wav_len is None:
        wav_len = torch.full((n,), length, dtype=torch.int32, device=wav.device)
    frames = frame_signal(preemphasize(wav, cfg.preemphasis), cfg)  # [N, F, win]
    f = frames.shape[1]
    feats = features_from_frames(frames.reshape(n * f, cfg.win_length), cfg, kind)
    return feats.reshape(n, f, feats.shape[-1]), frame_lengths(wav_len, cfg)


def add_deltas(
    feats: torch.Tensor, frame_lens: torch.Tensor, width: int = 2
) -> torch.Tensor:
    """[N, F, D] -> [N, F, 3D] (static, delta, delta-delta).

    Regression deltas with edge replication inside the valid region:
    d[t] = sum_n n * (c[t+n] - c[t-n]) / (2 * sum n^2), indices clipped to
    [0, len-1] per utterance.
    """
    n, f, d = feats.shape
    denom = 2.0 * sum(i * i for i in range(1, width + 1))
    t = torch.arange(f, device=feats.device)[None, :]
    last = torch.clamp(frame_lens.long() - 1, min=0)[:, None]  # [N, 1]

    def regress(x):
        out = torch.zeros_like(x)
        for i in range(1, width + 1):
            hi = torch.minimum(t + i, last)
            lo = torch.minimum(torch.clamp(t - i, min=0), last)
            xp = torch.gather(x, 1, hi[:, :, None].expand(n, f, d))
            xm = torch.gather(x, 1, lo[:, :, None].expand(n, f, d))
            out = out + i * (xp - xm)
        return out / denom

    d1 = regress(feats)
    d2 = regress(d1)
    return torch.cat([feats, d1, d2], dim=-1)


def cmvn(feats: torch.Tensor, frame_lens: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-utterance cepstral mean/variance normalization (masked)."""
    n, f, d = feats.shape
    mask = (torch.arange(f, device=feats.device)[None, :] < frame_lens[:, None])[..., None]
    cnt = torch.clamp(mask.sum(dim=1), min=1)  # [N, 1]
    mean = torch.where(mask, feats, 0.0).sum(dim=1, keepdim=True) / cnt[:, None]
    var = torch.where(mask, (feats - mean) ** 2, 0.0).sum(dim=1, keepdim=True) / cnt[:, None]
    out = (feats - mean) * torch.rsqrt(var + eps)
    return torch.where(mask, out, 0.0)
