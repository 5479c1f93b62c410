"""Host-side audio IO (no external codec dependencies: scipy WAV only).

Counterpart of ``multimodalworddiscovery_tpu/utils/audio.py``, copied.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_wav(path: str | Path, target_rate: int = 16000) -> np.ndarray:
    """PCM WAV -> float32 mono [-1, 1] at target_rate (naive resample)."""
    from scipy.io import wavfile

    rate, data = wavfile.read(str(path))
    data = np.asarray(data)
    if data.ndim == 2:  # downmix
        data = data.mean(axis=1)
    if np.issubdtype(data.dtype, np.integer):
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    else:
        data = data.astype(np.float32)
    if rate != target_rate:
        # linear-interpolation resample (preprocessing side, not on the device)
        n_out = int(round(len(data) * target_rate / rate))
        x_old = np.linspace(0.0, 1.0, num=len(data), endpoint=False)
        x_new = np.linspace(0.0, 1.0, num=n_out, endpoint=False)
        data = np.interp(x_new, x_old, data).astype(np.float32)
    return data


def write_wav(path: str | Path, data: np.ndarray, rate: int = 16000) -> None:
    from scipy.io import wavfile

    pcm = np.clip(np.asarray(data, np.float32), -1.0, 1.0)
    wavfile.write(str(path), rate, (pcm * 32767).astype(np.int16))
