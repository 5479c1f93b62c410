"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
In order: load the cell (``BENCHMARK.json`` and the files it names), make
the inputs from the seed, build the program around them (the port's
kernels build on first use into ``build/mwd_kernels`` in the checkout, or
load from there), warm up the cell's own shapes, measure for ``--seconds``,
compare what the window produced with the plain reference, and print one
JSON line last on standard output.  With ``--trace 1`` the line carries the
per-layer metrics, read from a traced stretch of the window, in place of
the end-to-end ones.  A machine without the cards exits non-zero and
prints no result.
"""

from __future__ import annotations

import os
import pathlib
import sys
import time

T_IMPORT = time.perf_counter()
if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    # one hash seed for every run: string hashing decides the layout of the
    # host's dicts, and so part of the host-paced cells' time
    os.execve(sys.executable, [sys.executable, *sys.argv], {**os.environ, "PYTHONHASHSEED": "0"})
ROOT = pathlib.Path(__file__).resolve().parents[1]
# run as a script, the script's own folder would shadow the standard library
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT / "portbench"]
sys.path.insert(0, str(ROOT))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import types  # noqa: E402

import torch  # noqa: E402

from portbench import compare, gen, spec  # noqa: E402
from portbench.tracing import CAP_S, Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "multimodalworddiscovery_tpu")


def process_age_s() -> float:
    """Seconds since this process started (from /proc; else since this
    module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name begins with the latter)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_note() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             log=print, build=None, note=None) -> dict:
    """Run ``cell`` on ``device``; the result line as a dict.  ``build``
    replaces the family's ``build`` (the tests break the program with it);
    ``note()``, logged after the window, describes the card."""
    config, traffic = cell.config, cell.traffic
    family = importlib.import_module(f"portbench.families.{config['model']}")
    loop = importlib.import_module(f"portbench.loops.{traffic['loop']}")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False  # the configuration is float32
    torch.backends.cudnn.allow_tf32 = False
    inp = gen.make(config, traffic, seed, device)
    prog = (build or family.build)(config, traffic, inp)
    kind = traffic["loop"]
    if kind == "em":
        per_iter = loop.warm(prog)
        log(f"route {prog.route}; kernel launches an iteration {per_iter}")
    else:
        trained, per_pass = loop.warm(prog, traffic["train_iterations"])
        log(f"kernel launches a pass {per_pass}")
    _sync(device)
    setup_s = process_age_s()
    args = (prog,) if kind == "em" else (prog, trained)
    out = loop.window(*args, seconds, seed)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if note is not None:
        log(note())
    tracer = None
    if trace:
        tracer = Tracer()
        loop.window(*args, CAP_S, seed, tracer)
    del args
    work = prog.work[kind]
    del prog
    if kind != "em":
        del trained
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"window {out['window_s']:.3f} s: " + ", ".join(
        f"{k} {v}" for k, v in out.items() if k in ("iterations", "jobs", "passes",
                                                    "jobs_unlike_first")))
    t_check = time.perf_counter()
    numbers, failed = check(kind, family, cell, inp, out)
    log(f"check {time.perf_counter() - t_check:.2f} s")
    correct, shown = compare.judge(numbers, cell.limits["compared"])
    failed += out.get("failed", 0)
    correct = correct and failed == 0
    result = {"correct": correct, "attempted": out["attempted"], "failed": failed}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        traced = tracer.read()
        ctx = types.SimpleNamespace(trace=traced, window=out, work=work)
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        if traced is not None:
            device_info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
            result["device"] = device_info
            result["breakdown"] = traced["breakdown"]
            log(f"traced {traced['units']} units in {traced['window_s']:.4f} s")
    else:
        # a name's part after the first dot tells apart cells' copies of
        # one quantity (``em_throughput.fused``)
        values = {**out["metrics"], "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"].split(".")[0]],
                                         "unit": m["unit"]} for m in cell.end_to_end}
    result.setdefault("device", device_info)
    for name, (value, limit) in shown.items():
        log(f"compared {name}: {value!r} (limit {limit!r})")
    result["compared"] = {name: {"value": v, "limit": lim} for name, (v, lim) in shown.items()}
    return result


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def check(kind: str, family, cell: spec.Cell, inp: dict, out: dict,
          detail: bool = False) -> tuple[dict, int]:
    """The numbers compared, worst over the answers the window kept, and how
    many answers failed their limit."""
    config = cell.config
    if kind == "em":
        return family.judge(config, inp, out["lls"], list(out["kept"].values()), detail), 0
    params_r, best = family.reference_align(config, inp, cell.traffic["train_iterations"])
    limit = cell.limits["compared"]["viterbi_gap"]
    gaps, failed = [], 0
    for alignment in out["kept"].values():
        g = family.align_gaps(config, inp, params_r, best, alignment)
        bad = ~torch.isfinite(g) | (g > limit)
        failed += int(bad.sum())
        gaps.append(float(g.max()) if bool(torch.isfinite(g).all()) else math.inf)
    return {"viterbi_gap": compare.worst(gaps)}, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, pathlib.Path.cwd() / "BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    note = lambda: f"card: {card_note()}; torch {torch.__version__}, CUDA {torch.version.cuda}"  # noqa: E731
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", log=log, note=note)
    bad = forbidden_modules()
    if bad:
        log(f"portbench: JAX or the JAX package was loaded: {', '.join(bad)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
