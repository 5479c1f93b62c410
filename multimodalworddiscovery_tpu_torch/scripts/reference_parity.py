"""Reference parity harness: the port's aligner against a reference's dump.

Counterpart of ``scripts/reference_parity.py``.  When reference code or
artifacts appear under the reference mount, this is the one-command
re-check of the alignment-JSON conventions, NULL handling and metric
definitions:

    python -m multimodalworddiscovery_tpu_torch.scripts.reference_parity \
        --reference /root/reference/outputs --workdir /tmp/parity [--device cpu]

What it does:
  1. SCAN the reference directory for recognizable artifacts:
       * phone caption text files  (one utterance per line, space-separated)
       * concept/label text files
       * alignment dumps (.json) in any of the common shapes:
           - [{"index": i, "alignment": [...]}, ...]      (ours)
           - {"alignments": [[...], ...]}                 (dict-of-lists)
           - [[...], ...]                                 (bare lists)
           - JSONL, one record per line
  2. CONVERT the caption pair into the on-disk corpus format
     (data/io.py: <name>_src.txt / <name>_trg.txt) and load it through the
     standard loader onto ``--device``.
  3. TRAIN the matched aligner (model1 / hmm; on the card through its
     kernels) on that corpus.
  4. DIFF the decoded alignments against the reference dump: per-token
     agreement and alignment P/R/F1 treating the dump as gold.
  5. Print a parity report JSON (and write it with ``--output``); the exit
     code is 0 for "parity" and "reference-mount-empty", else 1, so CI can
     gate on it.

Every format assumption lives in a small adapter below — when the real
layout differs, fix the adapter, not the pipeline.  The device is "cuda"
unless ``--device`` names another ("cpu" runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

OK_STATUSES = ("parity", "reference-mount-empty")


# --------------------------------------------------------------------------
# adapters: tolerant readers for reference-side artifacts
# --------------------------------------------------------------------------

def read_alignment_dump(path: Path) -> list[list[int]]:
    """Parse a reference alignment dump in any of the known shapes."""
    text = path.read_text().strip()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        # JSONL: one record per line
        data = [json.loads(ln) for ln in text.splitlines() if ln.strip()]

    if isinstance(data, dict):
        for key in ("alignments", "alignment", "data"):
            if key in data:
                data = data[key]
                break
        else:
            raise ValueError(f"{path}: dict dump without a known alignment key")

    if not isinstance(data, list) or not data:
        raise ValueError(f"{path}: empty or non-list alignment dump")

    if isinstance(data[0], dict):
        # ours / reference record style: {"index": i, "alignment": [...]}
        by_index: dict[int, list[int]] = {}
        for i, rec in enumerate(data):
            al = next(
                (rec[k] for k in ("alignment", "align", "a") if k in rec), None
            )
            if al is None:
                raise ValueError(f"{path}: record without alignment: {rec.keys()}")
            by_index[int(rec.get("index", i))] = [int(x) for x in al]
        return [by_index[i] for i in sorted(by_index)]
    if isinstance(data[0], list):
        return [[int(x) for x in al] for al in data]
    raise ValueError(f"{path}: unrecognized alignment dump shape")


def find_artifacts(ref_dir: Path) -> dict[str, list[Path]]:
    """Locate caption/alignment artifacts under the reference directory."""
    found: dict[str, list[Path]] = {"captions": [], "alignments": [], "npz": []}
    for p in sorted(ref_dir.rglob("*")):
        if not p.is_file():
            continue
        if p.suffix == ".json" and any(
            k in p.name.lower() for k in ("align", "gold")
        ):
            found["alignments"].append(p)
        elif p.suffix == ".txt" and any(
            k in p.name.lower()
            for k in ("caption", "phone", "src", "trg", "concept")
        ):
            found["captions"].append(p)
        elif p.suffix == ".npz":
            found["npz"].append(p)
    return found


def pair_captions(captions: list[Path]) -> tuple[Path, Path] | None:
    """Heuristically pick the (source=phones, target=concepts) pair."""
    srcs = [p for p in captions if any(k in p.name.lower() for k in ("src", "phone", "caption"))]
    trgs = [p for p in captions if any(k in p.name.lower() for k in ("trg", "concept", "label"))]
    if srcs and trgs:
        return srcs[0], trgs[0]
    if len(captions) >= 2:
        return captions[0], captions[1]
    return None


# --------------------------------------------------------------------------
# parity pipeline
# --------------------------------------------------------------------------

def run_parity(ref_dir: Path, workdir: Path, model_name: str, iters: int,
               threshold: float, device="cuda") -> dict:
    from multimodalworddiscovery_tpu_torch.data.io import load_corpus
    from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf
    from multimodalworddiscovery_tpu_torch.models.registry import get_model

    report: dict = {"reference": str(ref_dir), "model": model_name}
    found = find_artifacts(ref_dir)
    report["found"] = {k: [str(p) for p in v] for k, v in found.items()}
    if not found["captions"] and not found["alignments"]:
        report["status"] = "empty-or-unrecognized"
        return report

    pair = pair_captions(found["captions"])
    if pair is None:
        report["status"] = "no-caption-pair"
        return report
    src_path, trg_path = pair
    report["pair"] = [str(src_path), str(trg_path)]

    # convert into the on-disk corpus format and round-trip the loader
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "ref_src.txt").write_text(src_path.read_text())
    (workdir / "ref_trg.txt").write_text(trg_path.read_text())
    corpus, _ = load_corpus(workdir, "ref", device=device)
    report["corpus"] = {
        "n": corpus.n, "max_src_len": corpus.max_src_len,
        "src_vocab": corpus.src_vocab, "trg_vocab": corpus.trg_vocab,
    }

    mod = get_model(model_name)
    params, _ = mod.train(mod.init(corpus), corpus, iters)
    ours = mod.align(params, corpus).cpu().numpy()
    mask = corpus.src_mask()

    for dump in found["alignments"]:
        try:
            ref_al = read_alignment_dump(dump)
        except ValueError as e:
            report.setdefault("skipped_dumps", []).append(str(e))
            continue
        if len(ref_al) != corpus.n:
            report.setdefault("skipped_dumps", []).append(
                f"{dump}: {len(ref_al)} records != corpus n {corpus.n}"
            )
            continue
        ref_padded = np.zeros_like(ours)
        for i, al in enumerate(ref_al):
            al = al[: ours.shape[1]]
            ref_padded[i, : len(al)] = al
        agree = float((ours == ref_padded)[mask.cpu().numpy()].mean())
        prf = alignment_prf(torch.as_tensor(ours, device=corpus.device),
                            torch.as_tensor(ref_padded, device=corpus.device), mask)
        report.setdefault("dumps", {})[str(dump)] = {
            "token_agreement": round(agree, 4),
            "f1_vs_reference": round(float(prf["f1"]), 4),
        }

    scores = [d["f1_vs_reference"] for d in report.get("dumps", {}).values()]
    report["best_f1"] = max(scores) if scores else None
    report["status"] = (
        "parity" if scores and max(scores) >= threshold
        else ("diverged" if scores else "no-comparable-dump")
    )
    return report


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", default="/root/reference")
    ap.add_argument("--workdir", default="/tmp/mwd_parity")
    ap.add_argument("--model", default="hmm", choices=["model1", "hmm"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--threshold", type=float, default=0.95,
                    help="min alignment F1 vs the reference dump for parity")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    ref_dir = Path(args.reference)
    if not ref_dir.exists() or not any(ref_dir.iterdir()):
        report = {"status": "reference-mount-empty", "reference": str(ref_dir)}
        print(json.dumps(report))
        return report
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    report = run_parity(ref_dir, Path(args.workdir), args.model, args.iters,
                        args.threshold, device=args.device)
    out = json.dumps(report, indent=2)
    print(out)
    if args.output:
        Path(args.output).write_text(out)
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["status"] in OK_STATUSES else 1)
