"""Build the CUDA kernels in ``csrc/`` at first use and bind them with ctypes.

Each ``csrc/*.cu`` file compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), one ``nvcc`` per
source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/mwd_kernels/lib<name>-<hash>.so csrc/<name>.cu

``<hash>`` covers the flags, the source and the shared headers, so an edited
source rebuilds.  The libraries land under the repository's ``build/``
directory (ignored by git), each written to a temporary name and renamed, so
concurrent first uses do not see a half-written file.  Nothing is
downloaded; a missing ``nvcc`` or a failed build raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import types

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "mwd_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points (csrc/*.cu): pointers and the stream as void*, sizes as int,
# strides as long long; each returns cudaGetLastError() after its launch.
SIGNATURES = {
    "mwd_table_lookup": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mwd_pair_counts": [_P] * 5 + [_I] * 5 + [_P],
    "mwd_log_matmul": [_P] * 5 + [_I] * 5 + [_L] * 4 + [_I, ctypes.c_float, _P],
    "mwd_log_matmul_work": [_I] * 6,
    "mwd_estep_counts_work": [_I] * 3,
    "mwd_estep_counts": [_P] * 13 + [_I] * 6 + [_P],
    "mwd_estep_work": [_I] * 4,
    "mwd_estep": [_P] * 10 + [_I] * 5 + [_P],
    "mwd_viterbi": [_P] * 8 + [_I] * 3 + [_P],
    "mwd_viterbi_work": [_I] * 3,
    "mwd_viterbi_bp_in_smem": [_I, _I],
    "mwd_mfcc": [_P] * 9 + [_I, _I, _L, _I, _L] + [_I] * 8 + [ctypes.c_float] * 2 + [_P],
    "mwd_mfcc_work": [_I] * 11,
}
RESTYPES = {"mwd_error_string": ctypes.c_char_p, "mwd_estep_work": _L,
            "mwd_estep_counts_work": _L, "mwd_viterbi_work": _L, "mwd_log_matmul_work": _L,
            "mwd_mfcc_work": _L}

_lock = threading.Lock()
_lib: types.SimpleNamespace | None = None
build_log = ""  # compiler output of this process's build ("" if cached)


def library_paths() -> dict[pathlib.Path, pathlib.Path]:
    """{source: its library} for every csrc/*.cu."""
    shared = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    paths = {}
    for src in sorted(CSRC.glob("*.cu")):
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + shared + src.read_bytes())
        paths[src] = BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"
    return paths


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


def build() -> list[pathlib.Path]:
    """Compile every csrc/*.cu whose library does not exist yet, one nvcc
    per source, all started together; the libraries."""
    global build_log
    paths = library_paths()
    todo = {src: lib for src, lib in paths.items() if not lib.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        tmps = {src: lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so") for src, lib in todo.items()}
        cmds = [[nvcc, *NVCC_FLAGS, "-o", str(tmps[src]), str(src)] for src in todo]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                for tmp in tmps.values():
                    tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{log}")
        for src, lib in todo.items():
            os.replace(tmps[src], lib)
        build_log = "".join(logs)
    return list(paths.values())


def load() -> types.SimpleNamespace:
    """The kernels' C entry points (as attributes), built and loaded once
    per process."""
    global _lib
    with _lock:
        if _lib is None:
            libs = [ctypes.CDLL(str(p)) for p in build()]
            fns = {}
            for name, argtypes in {**SIGNATURES, "mwd_error_string": [_I]}.items():
                fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
                fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
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
