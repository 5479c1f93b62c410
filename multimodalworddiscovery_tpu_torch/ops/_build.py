"""Build the CUDA kernels in ``csrc/`` at first use and bind them with ctypes.

All ``csrc/*.cu`` files compile with one ``nvcc`` call into a shared library
with a plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/mwd_kernels/libmwd_kernels-<hash>.so csrc/*.cu

``<hash>`` covers the sources and the flags, so an edited source rebuilds.
The library lands under the repository's ``build/`` directory (ignored by
git), written to a temporary name and renamed, so concurrent first uses do
not see a half-written file.  Nothing is downloaded; a missing ``nvcc`` or a
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "mwd_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points (csrc/*.cu): pointers and the stream as void*, sizes as int;
# each returns cudaGetLastError() after its launch.
SIGNATURES = {
    "mwd_table_lookup": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mwd_hmm_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "mwd_hmm_bwd_counts": [_P] * 11 + [_I] * 5 + [_P],
    "mwd_hmm_bwd_gamma": [_P] * 9 + [_I] * 3 + [_P],
    "mwd_viterbi": [_P] * 8 + [_I] * 3 + [_P],
    "mwd_viterbi_bp_in_smem": [_I, _I],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # compiler output of this process's build ("" if cached)


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmwd_kernels-{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in CUDA_HOME/bin and on PATH): the port's "
        "CUDA kernels are built from csrc/ at first use and need the CUDA "
        "toolkit"
    )


def build() -> pathlib.Path:
    """Compile csrc/*.cu unless a library for these sources exists."""
    global build_log
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)
    build_log = proc.stdout + proc.stderr
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mwd_error_string.argtypes = [_I]
            lib.mwd_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def require(x, name: str, dtype, shape: tuple, device) -> None:
    """Validate a tensor before its pointer goes to a kernel."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if status != 0:
        text = load().mwd_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch ({text})")
