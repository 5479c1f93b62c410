"""K5: fused MFCC / log-mel kernel, and its plain version.

Replaces ``multimodalworddiscovery_tpu/ops/mfcc_pallas.py``:
``mfcc_from_frames`` (body ``_kernel``) and ``extract_pallas``, which
frames the waveform and calls it.  CUDA source: ``csrc/mfcc.cu``.

Per frame: Hann window, the n_fft-point DFT of the zero-padded frame,
power / n_fft, mel filterbank, log with a floor, DCT-II (``kind="fbank"``
stops at the log-mels).  What bounds it on the H100 is arithmetic: the
kernel computes the DFT directly in fp32 FMAs from one shared-memory
twiddle table, folding bin n_fft/2 - k onto bin k (0.2 MFLOP per frame),
and ``extract`` hands it the pre-emphasized waveform with the hop as the
frame stride, so the overlapping frame tensor never reaches device memory
(see the CUDA source's header).

The plain versions are ``frontend/speech.features_from_frames`` and
``frontend/speech.extract`` (``torch.fft.rfft``).  A wrapper takes them for
CPU tensors only; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.frontend import speech
from multimodalworddiscovery_tpu_torch.frontend.speech import MfccConfig
from multimodalworddiscovery_tpu_torch.ops import _build

MAX_N_FFT = 512  # csrc/mfcc.cu MWD_MFCC_MAX_NFFT: 16 warps x 8 bins = n_fft / 4
MAX_MELS = 256   # csrc/mfcc.cu MWD_MFCC_MAX_MELS

mfcc_from_frames_plain = speech.features_from_frames
extract_plain = speech.extract


def _check_config(cfg: MfccConfig, kind: str) -> None:
    speech._check_kind(kind)
    n = cfg.n_fft
    if not (32 <= n <= MAX_N_FFT and n & (n - 1) == 0):
        raise ValueError(f"the MFCC kernel takes n_fft a power of two in [32, {MAX_N_FFT}], "
                         f"got {n}")
    if not 1 <= cfg.win_length <= n:
        raise ValueError(f"win_length must lie in [1, n_fft={n}], got {cfg.win_length}")
    if not 1 <= cfg.n_mfcc <= cfg.n_mels <= MAX_MELS:
        raise ValueError(f"the MFCC kernel takes 1 <= n_mfcc <= n_mels <= {MAX_MELS}, got "
                         f"n_mfcc={cfg.n_mfcc}, n_mels={cfg.n_mels}")
    if cfg.hop_length < 1:
        raise ValueError(f"hop_length must be >= 1, got {cfg.hop_length}")


@functools.lru_cache(maxsize=16)
def _tables(cfg: MfccConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    """(twiddles [n_fft, 2], window [win], filterbank [n_mels, n_bins],
    nonzero bin range of each filter [n_mels, 2], DCT [n_mfcc, n_mels]) on
    ``device``; twiddles and window are float64 on the host, then float32."""
    j = np.arange(cfg.n_fft)
    ang = 2.0 * np.pi * j / cfg.n_fft
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    fb = speech.mel_filterbank(cfg)
    ranges = np.zeros((cfg.n_mels, 2), np.int32)
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        if nz.size:
            ranges[m] = (nz[0], nz[-1] + 1)
    dct = speech.dct_matrix(cfg.n_mfcc, cfg.n_mels)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (tw, speech.hann_window(cfg.win_length), fb, ranges, dct))


def _launch(sig: torch.Tensor, n_rows: int, frames_per_row: int, row_stride: int,
            frame_stride: int, cfg: MfccConfig, kind: str) -> torch.Tensor:
    """Features [n_rows * frames_per_row, n_out] of the frames at
    sig + r * row_stride + j * frame_stride (no launch when there are none)."""
    dev = sig.device
    n_out = cfg.n_mels if kind == "fbank" else cfg.n_mfcc
    m = n_rows * frames_per_row
    out = torch.empty((m, n_out), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    if m >= 2**31 or sig.numel() >= 2**31:
        raise ValueError(f"the MFCC kernel takes < 2^31 frames and samples, got {m} "
                         f"frames of {sig.numel()} samples")
    tw, window, fb, ranges, dct = _tables(cfg, dev)
    with torch.cuda.device(dev):
        status = _build.load().mwd_mfcc(
            sig.data_ptr(), tw.data_ptr(), window.data_ptr(), fb.data_ptr(),
            ranges.data_ptr(), dct.data_ptr(), out.data_ptr(), n_rows, frames_per_row,
            row_stride, frame_stride, cfg.win_length, cfg.n_fft, cfg.n_mels, n_out,
            int(kind == "mfcc"), cfg.log_floor, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "mwd_mfcc")
    return out


def mfcc_from_frames(
    frames: torch.Tensor,  # [M, win_length] float32, pre-emphasized
    cfg: MfccConfig = MfccConfig(),
    kind: str = "mfcc",
) -> torch.Tensor:
    """[M, n_mfcc] MFCCs (or [M, n_mels] log-mels for kind='fbank').

    CPU tensors take ``mfcc_from_frames_plain``; CUDA tensors launch the
    kernel (M = 0 launches nothing)."""
    if frames.device.type == "cpu":
        return mfcc_from_frames_plain(frames, cfg, kind)
    if frames.device.type != "cuda":
        raise ValueError(f"mfcc_from_frames runs on cpu or cuda, got {frames.device}")
    _check_config(cfg, kind)
    m = frames.shape[0]
    _build.require(frames, "frames", torch.float32, (m, cfg.win_length), frames.device)
    out = _launch(frames, m, 1, cfg.win_length, 0, cfg, kind)
    if m:
        mfcc_from_frames.launches += 1
    return out


mfcc_from_frames.launches = 0


def extract(
    wav: torch.Tensor,                    # [N, L] float32
    wav_len: torch.Tensor | None = None,  # [N] int32 sample counts (None => L)
    cfg: MfccConfig = MfccConfig(),
    kind: str = "mfcc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(features [N, F, n_out], frame_lens [N] int32), F = num_frames(L).

    CPU tensors take ``extract_plain``; CUDA tensors pre-emphasize in torch
    and launch the kernel on the waveform itself (frames are strided views
    of it, never copied out).  Frames past an utterance's length are
    computed and masked by ``frame_lens``."""
    if wav.device.type == "cpu":
        return extract_plain(wav, wav_len, cfg, kind)
    if wav.device.type != "cuda":
        raise ValueError(f"extract runs on cpu or cuda, got {wav.device}")
    _check_config(cfg, kind)
    dev = wav.device
    if wav.ndim != 2:
        raise ValueError(f"wav must be [N, L], got shape {tuple(wav.shape)}")
    n, length = wav.shape
    _build.require(wav, "wav", torch.float32, (n, length), dev)
    if wav_len is None:
        wav_len = torch.full((n,), length, dtype=torch.int32, device=dev)
    _build.require(wav_len, "wav_len", torch.int32, (n,), dev)
    f = speech.num_frames(length, cfg)
    pre = speech.preemphasize(wav, cfg.preemphasis)
    feats = _launch(pre, n, f, length, cfg.hop_length, cfg, kind)
    if n * f:
        extract.launches += 1
    return feats.reshape(n, f, feats.shape[-1]), speech.frame_lengths(wav_len, cfg)


extract.launches = 0
