"""Per-phase clock shares of K8's float32 kernel at path 9's first combines.

    python -m multimodalworddiscovery_tpu_torch.scripts.k8_phases

Builds a copy of ``csrc/log_semiring.cu`` under ``build/k8_phases/`` with
``clock64`` marks at the resident kernel's phase boundaries (load wait,
maxima and live ranges, exps, product, epilogue, guard), added by thread 0
of each block into a device array, runs it on the first combine of
``scripts/bench_assoc.py``'s S64 and S128 step matrices (parameters after
10 EM iterations, as ``chip_smoke.py``'s path 9) and on normal inputs of
the same shapes, and prints each phase's share of the summed clocks with
the call's time (CUDA events).  The marks go in at fixed lines of the
kernel's source: the script fails, naming the line, where an edit moved
one.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import torch

from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core
from multimodalworddiscovery_tpu_torch.ops import _build
from multimodalworddiscovery_tpu_torch.ops import log_semiring as k8
from multimodalworddiscovery_tpu_torch.scripts import bench_assoc
from multimodalworddiscovery_tpu_torch.scripts.bench_kernels import gpu_ms, require_cuda

OUT = pathlib.Path(__file__).resolve().parents[2] / "build" / "k8_phases"
PHASES = ("load", "maxima", "exps", "product", "epilogue", "guard")
MARKS = '''
__device__ unsigned long long mwd_ph[8];
#define MWD_T(n) do { if (threadIdx.x == 0) { const unsigned long long c_ = clock64(); \\
    if (n > 0) atomicAdd(&mwd_ph[n], c_ - t_prev); t_prev = c_; } } while (0)
extern "C" int mwd_phases(unsigned long long* out, int reset) {
    if (reset) {
        const unsigned long long z[8] = {0};
        return (int)cudaMemcpyToSymbol(mwd_ph, z, sizeof(z));
    }
    return (int)cudaMemcpyFromSymbol(out, mwd_ph, sizeof(mwd_ph));
}
'''
# (line of the kernel after which a mark goes, mark); a phase's clocks run
# from the previous mark to its own
AFTER = (
    ("    int it = 0;\n", "    unsigned long long t_prev = 0;\n"),
    ("        __syncthreads();  // the previous matrix's readers are done\n", "        MWD_T(0);\n"),
    ("                asm volatile(\"cp.async.wait_group 0;\\n\");\n            }\n"
     "            __syncthreads();\n", "            MWD_T(1);\n"),
    ("                    sb[jj] = s;\n                }\n            }\n            __syncthreads();\n",
     "            MWD_T(2);\n"),
    ("                                                 mwd_lm_safe(sb[jj + 3].m)));\n"
     "            }\n            __syncthreads();\n", "            MWD_T(3);\n"),
    ("            product(P + cur * BM * pk, Q + cur * tk * qk, tk);\n", "            MWD_T(4);\n"),
    ("        int n_trip = n_took, n_sum = __popcll(trip);\n", "        MWD_T(5);\n"),
    ("            op[(long long)i * p.nj + j] = mwd_lm_live(m) && s > 0.f ? m + logf(s) : "
     "MWD_NEG_INF;\n        }\n", "        MWD_T(6);\n"),
)


def build() -> ctypes.CDLL:
    src = (_build.CSRC / "log_semiring.cu").read_text()
    src = src.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + MARKS, 1)
    for line, mark in AFTER:
        if src.count(line) != 1:
            raise SystemExit(f"the kernel's source no longer has this line once: {line!r}")
        src = src.replace(line, line + mark)
    (OUT / "csrc").mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (OUT / "csrc" / header.name).write_text(header.read_text())
    (OUT / "csrc" / "lm.cu").write_text(src)
    lib = OUT / "liblm_phases.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(OUT / "csrc" / "lm.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{done.stdout}\n{done.stderr}")
    lib = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    lib.mwd_log_matmul.argtypes = ([p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
                                   + [ctypes.c_int, ctypes.c_float, p])
    lib.mwd_phases.argtypes = [p, ctypes.c_int]
    return lib


def main() -> None:
    dev = require_cuda()
    lib = build()
    guard = torch.zeros(2, dtype=torch.int64, device=dev)
    for label, gen in bench_assoc.SHAPES:
        corpus, _, _ = make_flickr8k_mini(**gen, device=dev)
        params = hmm.train(hmm.init(corpus), corpus, 10)[0]
        _, log_trans, log_emit = hmm._machinery(params, corpus)
        m = hmm_core.step_matrices(log_trans, log_emit, corpus.src_len)
        for inputs, (a, b) in (("path 9", (m[0:-1:2], m[1::2])),
                               ("normal - 3", (torch.randn_like(m[0:-1:2]) - 3,
                                               torch.randn_like(m[1::2]) - 3))):
            nb1, nb2, s = a.shape[0], a.shape[1], a.shape[-1]
            out = torch.empty((nb1, nb2, s, s), device=dev)
            args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), None, guard.data_ptr(), nb1, nb2,
                    s, s, s, a.stride(0), a.stride(1), b.stride(0), b.stride(1), 0,
                    k8.guard_threshold(s), torch.cuda.current_stream(dev).cuda_stream)
            lib.mwd_log_matmul(*args)
            torch.cuda.synchronize()
            clocks = (ctypes.c_ulonglong * 8)()
            lib.mwd_phases(None, 1)
            lib.mwd_log_matmul(*args)
            torch.cuda.synchronize()
            lib.mwd_phases(ctypes.cast(clocks, ctypes.c_void_p), 0)
            total = sum(clocks[1:7])
            shares = {name: round(clocks[i + 1] / total, 3) for i, name in enumerate(PHASES)}
            print(f"{label} {inputs}: {shares}, {total / 1e6:.1f} M clocks summed over blocks, "
                  f"{gpu_ms(lambda: lib.mwd_log_matmul(*args), 5):.4f} ms a call")
        del corpus, params, m
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
