"""K5: fused MFCC / log-mel kernel, and its plain version.

Replaces ``multimodalworddiscovery_tpu/ops/mfcc_pallas.py``:
``mfcc_from_frames`` (body ``_kernel``) and ``extract_pallas``, which
frames the waveform and calls it.  CUDA source: ``csrc/mfcc.cu``.

Per frame: pre-emphasis, Hann window, the n_fft-point DFT of the
zero-padded frame, power / n_fft, mel filterbank, log with a floor, DCT-II
(``kind="fbank"`` stops at the log-mels).  Its bound on the H100 is bytes,
and the design keeps them to one read: a block loads a run of consecutive
frames' samples once and pre-emphasizes them as they land (``extract``
hands the kernel the raw waveform, with the hop as the frame stride, so
neither the pre-emphasized waveform nor the overlapping frame tensor
reaches device memory), and a warp computes a frame's spectrum by a real
FFT in fp32 (n_fft a power of two from 32: a complex Stockham FFT of n_fft /
2 points in radix-8 and radix-4 stages, then the split), or by a direct DFT
for any other n_fft.  The frames' work in shared memory, not the bytes, sets
its pace in practice (see the CUDA source's header).  Above n_fft = 2048
(``RUN_N_FFT``), or where a block's run of frames would not fit in shared
memory (many mels), a second kernel takes a frame a warp, its buffers in
shared memory or, past 227 KB a warp, in a workspace in device memory; so
any n_fft >= win_length and any n_mels are taken, as by the reference.

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

RUN_N_FFT = 2048  # csrc/mfcc.cu MWD_MFCC_RUN_NFFT: above it, a frame a warp
MIN_FFT = 32      # the smallest n_fft the FFT branch takes (16 complex points)

mfcc_from_frames_plain = speech.features_from_frames
extract_plain = speech.extract


def _check_config(cfg: MfccConfig, kind: str) -> None:
    speech._check_kind(kind)
    n = cfg.n_fft
    if n < 1:
        raise ValueError(f"n_fft must be >= 1, got {n}")
    if not 1 <= cfg.win_length <= n:
        raise ValueError(f"win_length must lie in [1, n_fft={n}], got {cfg.win_length}")
    if not 1 <= cfg.n_mfcc <= cfg.n_mels:
        raise ValueError(f"the MFCC kernel takes 1 <= n_mfcc <= n_mels, got "
                         f"n_mfcc={cfg.n_mfcc}, n_mels={cfg.n_mels}")
    if cfg.hop_length < 1:
        raise ValueError(f"hop_length must be >= 1, got {cfg.hop_length}")


def uses_fft(n_fft: int) -> bool:
    """Whether the kernel takes the FFT branch (else the direct DFT)."""
    return MIN_FFT <= n_fft and n_fft & (n_fft - 1) == 0


def fft_radices(n_fft: int) -> list[int]:
    """The radices of the kernel's FFT of n_fft / 2 complex points, in its
    stage order (csrc/mfcc.cu MwdFftPlan): radix-8 stages, then the one or
    two radix-4 stages that log2(n_fft / 2) = 3a + 2b leaves."""
    p = (n_fft // 2).bit_length() - 1
    b4 = (0, 2, 1)[p % 3]
    return [8] * ((p - 2 * b4) // 3) + [4] * b4


def stage_twiddle_index(n_fft: int) -> np.ndarray:
    """Index into the n_fft-entry twiddle table of each entry of the FFT
    stages' table: stages 1.. (stage 0 has no twiddles), each [Ns, R - 1]
    with entry (j, r) at j * r * n_fft / (Ns * R), the angle 2 pi j r /
    (Ns R) of the n_fft / 2-point transform."""
    idx, ns = [], 1
    for s, r_ in enumerate(fft_radices(n_fft)):
        if s > 0:
            j, r = np.meshgrid(np.arange(ns), np.arange(1, r_), indexing="ij")
            idx.append((j * r * (n_fft // (ns * r_))).reshape(-1))
        ns *= r_
    return np.concatenate(idx) if idx else np.zeros(0, np.int64)


@functools.lru_cache(maxsize=16)
def mel_pieces(cfg: MfccConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The mel filterbank as the kernel sums it: (the filters' nonzero
    weights packed [n_fbw], the pieces [n_pieces, 4] (mel, lo, hi, offset
    into the weights), each mel's first piece [n_mels + 1]).  Each filter's
    nonzero bins [lo, hi) are cut into pieces of at most P bins, P chosen so
    that a warp spends the least time: lanes over pieces (rounds of 32
    pieces x P bins), then lanes over mels (each summing its pieces).  At
    the defaults the widest filter has 46 bins, and P = 9: 63 pieces, two
    rounds of 9 bins, then at most 6 pieces a mel."""
    fb = speech.mel_filterbank(cfg)
    ranges = []
    for row in fb:
        nz = np.flatnonzero(row)
        ranges.append((nz[0], nz[-1] + 1) if nz.size else (0, 0))
    widths = np.array([hi - lo for lo, hi in ranges])
    widest = max(int(widths.max()), 1)

    def cost(p):  # the lanes' loop over a piece's bins, then each mel's over its pieces
        per_mel = -(-widths // p)
        return (-(-int(per_mel.sum()) // 32) * p
                + -(-cfg.n_mels // 32) * int(per_mel.max()))

    size = min(range(widest, 0, -1), key=cost)  # the largest P of least cost
    weights, pieces, first = [], [], [0]
    off = 0
    for m, (lo, hi) in enumerate(ranges):
        weights.append(fb[m, lo:hi])
        for a in range(lo, hi, size):
            pieces.append((m, a, min(hi, a + size), off + a - lo))
        off += hi - lo
        first.append(len(pieces))
    fb_w = np.concatenate(weights + [np.zeros(1, np.float32)]).astype(np.float32)
    return fb_w, np.asarray(pieces, np.int32).reshape(-1, 4), np.asarray(first, np.int32)


@functools.lru_cache(maxsize=16)
def _tables(cfg: MfccConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    """(twiddles [n_fft, 2], the FFT stages' twiddles [n_stw, 2] (rows of
    the first, [1, 2] of zeros for the direct DFT), window [win], the
    filters' packed weights [n_fbw], the mel plan (the pieces [n_pieces,
    4] then each mel's first piece [n_mels + 1], flat int32), DCT
    transposed [n_mels, n_mfcc]) on ``device``; twiddles and window are
    float64 on the host, then float32."""
    j = np.arange(cfg.n_fft)
    ang = 2.0 * np.pi * j / cfg.n_fft
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    stw = tw[stage_twiddle_index(cfg.n_fft)] if uses_fft(cfg.n_fft) else np.zeros((0, 2))
    if not len(stw):
        stw = np.zeros((1, 2), np.float32)
    fb_w, pieces, first = mel_pieces(cfg)
    plan = np.concatenate([pieces.reshape(-1), first]).astype(np.int32)
    dct = np.ascontiguousarray(speech.dct_matrix(cfg.n_mfcc, cfg.n_mels).T)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (tw, stw, speech.hann_window(cfg.win_length), fb_w, plan, dct))


def _launch(sig: torch.Tensor, n_rows: int, frames_per_row: int, row_stride: int,
            frame_stride: int, coef: float, cfg: MfccConfig, kind: str) -> torch.Tensor:
    """Features [n_rows * frames_per_row, n_out] of the frames at
    sig + r * row_stride + j * frame_stride, pre-emphasized by ``coef``
    along each row in the kernel (no launch when there are none)."""
    dev = sig.device
    n_out = cfg.n_mels if kind == "fbank" else cfg.n_mfcc
    m = n_rows * frames_per_row
    out = torch.empty((m, n_out), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    if m >= 2**31:
        raise ValueError(f"the MFCC kernel takes < 2^31 frames, got {m}")
    tw, stw, window, fb_w, fb_plan, dct = _tables(cfg, dev)
    n_stw = stw.shape[0] if uses_fft(cfg.n_fft) else 0
    n_pieces = (fb_plan.numel() - cfg.n_mels - 1) // 4
    lib = _build.load()
    do_dct = int(kind == "mfcc")
    with torch.cuda.device(dev):
        # the frame-a-warp kernel's buffers where one passes shared memory
        work = torch.empty((int(lib.mwd_mfcc_work(
            n_rows, frames_per_row, frame_stride, cfg.win_length, cfg.n_fft, n_stw,
            fb_w.numel(), n_pieces, cfg.n_mels, n_out, do_dct)),),
            dtype=torch.float32, device=dev)
        status = lib.mwd_mfcc(
            sig.data_ptr(), tw.data_ptr(), stw.data_ptr(), window.data_ptr(), fb_w.data_ptr(),
            fb_plan.data_ptr(), dct.data_ptr(), out.data_ptr(),
            work.data_ptr() if work.numel() else None, n_rows, frames_per_row,
            row_stride, frame_stride, sig.numel(), cfg.win_length, cfg.n_fft, n_stw,
            fb_w.numel(), n_pieces, cfg.n_mels, n_out, do_dct, coef,
            cfg.log_floor,
            torch.cuda.current_stream(dev).cuda_stream,
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
    # the frames as one row of M, end to end, with the pre-emphasis off
    out = _launch(frames, 1, m, 0, cfg.win_length, 0.0, cfg, kind)
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

    CPU tensors take ``extract_plain``; CUDA tensors launch the kernel on
    the raw waveform, which pre-emphasizes and frames it (nothing is copied
    out).  Frames past an utterance's length are computed and masked by
    ``frame_lens``."""
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
    feats = _launch(wav, n, f, length, cfg.hop_length, cfg.preemphasis, cfg, kind)
    if n * f:
        extract.launches += 1
    return feats.reshape(n, f, feats.shape[-1]), speech.frame_lengths(wav_len, cfg)


extract.launches = 0
