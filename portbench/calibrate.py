"""The readings that a cell's limits are set from, on the card at the cell's
own size (the benchmark's runs do not run this):

- the program's: a short window through the cell's own loop on each seed,
  judged by the reference as a run judges it;
- the control's: the reference in the nearest precision below the
  configuration's (TF32 products for the float32 EM; a bfloat16 decode)
  put in the program's place;
- the faults': half of the corpus left out and its counts doubled, and
  one parameter altered (EM cells), read through the reference put in the
  program's place.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 --control-seeds 4 5 6

prints one JSON line a reading.  All seeds share one process, so the
kernels build once.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT / "portbench"]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare, gen, spec  # noqa: E402
from portbench.run import check  # noqa: E402


def program_reading(cell, seed: int, seconds: float, device: str, plain: bool = False) -> dict:
    config, traffic = cell.config, cell.traffic
    family = importlib.import_module(f"portbench.families.{config['model']}")
    loop = importlib.import_module(f"portbench.loops.{traffic['loop']}")
    inp = gen.make(config, traffic, seed, device)
    prog = family.build(config, traffic, inp, use_kernels=False if plain else None)
    t0 = time.perf_counter()
    if traffic["loop"] == "em":
        loop.warm(prog)
        # a window of at least one whole job (the plain path is slow)
        out = loop.window(prog, max(seconds, 1.5 * (time.perf_counter() - t0)), seed)
    else:
        params, _ = loop.warm(prog, traffic["train_iterations"])
        out = loop.window(prog, params, seconds, seed)
    del prog
    numbers, failed = check(traffic["loop"], family, cell, inp, out, detail=True)
    return {"numbers": numbers, "failed": failed, "metrics": out["metrics"]}


def control_reading(cell, seed: int, device: str) -> dict:
    config, traffic = cell.config, cell.traffic
    family = importlib.import_module(f"portbench.families.{config['model']}")
    inp = gen.make(config, traffic, seed, device)
    if traffic["loop"] == "em":
        # each put in the program's place and judged as a run's outputs are
        lls_c, ps_c = family.reference_job(config, inp, control=True)
        out = {"control": family.judge(config, inp, [lls_c], [ps_c], detail=True)}
        half = {**inp, **{k: inp[k][: inp["src"].shape[0] // 2]
                          for k in ("src", "src_len", "trg", "trg_len")}}
        lls_h, ps_h = family.reference_job(config, half)
        out["half_batch"] = family.judge(config, inp, [[2 * x for x in lls_h]], [ps_h],
                                         detail=True)
        # one parameter altered where each M-step makes it: the first
        # log-space leaf's entry [1, 0] (phone 1 under NULL; concept 1's
        # first mixture weight) moved by 1
        def alter(p):
            field = "log_emit" if "log_emit" in p else "log_mix"
            value = p[field].clone()
            value[1, 0] += 1.0
            return {**p, field: value}

        lls_a, ps_a = family.reference_job(config, inp, after_step=alter)
        out["altered"] = family.judge(config, inp, [lls_a], [ps_a], detail=True)
        return out
    params_r, best = family.reference_align(config, inp, traffic["train_iterations"])
    alignment = family.control_alignment(config, inp, params_r)
    gaps = family.align_gaps(config, inp, params_r, best, alignment)
    # one token of the reference's own best alignment altered
    path = family.ref.viterbi(params_r, gen.corpus_tuple(inp), config["max_jump"], path=True)[1]
    path[0, 0] = 1 if int(path[0, 0]) != 1 else 2
    altered = family.align_gaps(config, inp, params_r, best, path)
    return {"control": {"viterbi_gap": compare.worst([float(gaps.max())]),
                        "share_changed": float((gaps > 0).double().mean())},
            "altered": {"viterbi_gap": compare.worst([float(altered.max())])}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--plain-seeds", type=int, nargs="*", default=[],
                    help="seeds read with the port's plain path (a second witness)")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, pathlib.Path.cwd() / "BENCHMARK.json")
    device = "cuda" if torch.cuda.is_available() else sys.exit("calibrate needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "program",
                          **program_reading(cell, seed, args.seconds, device)}), flush=True)
        torch.cuda.empty_cache()
    for seed in args.plain_seeds:
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "plain",
                          **program_reading(cell, seed, args.seconds, device, plain=True)}),
              flush=True)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "control",
                          **control_reading(cell, seed, device)}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
