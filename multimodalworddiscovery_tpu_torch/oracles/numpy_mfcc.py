"""Per-utterance float64 NumPy MFCC oracle (reference-style loop: frame ->
window -> FFT -> mel -> log -> DCT -> deltas, one wav at a time).  Its
configuration and tables come from the port's ``frontend/speech``."""

from __future__ import annotations

import numpy as np

from multimodalworddiscovery_tpu_torch.frontend.speech import (
    MfccConfig,
    dct_matrix,
    mel_filterbank,
    num_frames,
)


def mfcc_np(wav: np.ndarray, cfg: MfccConfig = MfccConfig(), kind: str = "mfcc") -> np.ndarray:
    """One utterance [L] -> [F, n_mfcc] (or [F, n_mels] for 'fbank')."""
    wav = np.asarray(wav, dtype=np.float64)
    pre = np.concatenate([wav[:1], wav[1:] - cfg.preemphasis * wav[:-1]])
    f = num_frames(len(wav), cfg)
    window = np.hanning(cfg.win_length)
    out = []
    fb = mel_filterbank(cfg).astype(np.float64)
    dct = dct_matrix(cfg.n_mfcc, cfg.n_mels).astype(np.float64)
    for i in range(f):
        frame = pre[i * cfg.hop_length : i * cfg.hop_length + cfg.win_length] * window
        spec = np.fft.rfft(frame, n=cfg.n_fft)
        power = (spec.real**2 + spec.imag**2) / cfg.n_fft
        mel = fb @ power
        logmel = np.log(np.maximum(mel, cfg.log_floor))
        out.append(logmel if kind == "fbank" else dct @ logmel)
    return np.asarray(out)


def deltas_np(feats: np.ndarray, width: int = 2) -> np.ndarray:
    """[F, D] -> [F, 3D] with clipped-edge regression deltas."""
    f = feats.shape[0]
    denom = 2.0 * sum(i * i for i in range(1, width + 1))

    def regress(x):
        out = np.zeros_like(x)
        for t in range(f):
            for i in range(1, width + 1):
                out[t] += i * (x[min(t + i, f - 1)] - x[max(t - i, 0)])
        return out / denom

    d1 = regress(feats)
    d2 = regress(d1)
    return np.concatenate([feats, d1, d2], axis=-1)
