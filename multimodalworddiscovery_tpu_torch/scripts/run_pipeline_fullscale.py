"""BASELINE.json config #4 at reference-corpus scale, fully out of core.

Counterpart of ``scripts/run_pipeline_fullscale.py``.  The reference runs
its end-to-end pipeline (preprocess -> train -> align -> evaluate) over
full MSCOCO as separate host-resident scripts; this script runs the same
pipeline at six-figure utterance counts on one card with host RSS bounded
by a batch, not the corpus:

  stage 1  synthesize waveforms in shard-sized batches (the shared-lexicon
           batched generator, data/synthetic.make_flickr8k_mini_batches;
           each sub-batch rendered on the host from the phone templates,
           as a loader would read audio) -> MFCC through K5 per sub-batch
           -> frame-level gold -> data.stream.ShardWriter (each batch one
           shard; generation order is an iid draw, i.e. pre-shuffled, and
           the seed is recorded in the manifest)
  stage 2  streamed Gaussian-HMM EM        (mwd-torch train, data.source=stream)
  stage 3  streamed Viterbi alignment      (mwd-torch align)
  stage 4  streamed word segmentation      (mwd-torch segment)
  stage 5  streamed evaluation, every metric family incl. within-shard
           pooled retrieval and reservoir DTW (mwd-torch evaluate)
  stage 6  cross-check: shard 0 evaluated RESIDENT (corpus on the device,
           same parameters) against STREAMED over a single-shard manifest;
           the metrics must agree to float tolerance (streamed evaluation
           is exact)

    python -m multimodalworddiscovery_tpu_torch.scripts.run_pipeline_fullscale   # N=131,072
    python -m multimodalworddiscovery_tpu_torch.scripts.run_pipeline_fullscale \\
        --utterances 512 --shard-size 128 --mfcc-batch 128 --iters 3 --device cpu

Prints a per-stage wall-time / peak-RSS table and writes it with the
metrics as JSON (``--report``, default ``<workdir>/report.json``).  The
device is "cuda" unless ``--device`` names another ("cpu" runs the
kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import resource
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_PHONES = 24  # the reference script's phone inventory
SAMPLE_RATE = 16000
PHONE_MS = 80
NOISE = 0.02


def _rss_gb() -> float:
    """Peak resident set size of this process so far, GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _run_cli(argv: list[str]) -> None:
    from multimodalworddiscovery_tpu_torch import cli

    cli.main(argv)


def render_waveforms(src: np.ndarray, src_len: np.ndarray, s_max: int, templates: np.ndarray,
                     noise_rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Phone ids [B, <= s_max] -> (waveforms [B, s_max * spp] float32, sample
    counts [B] int32) on the host: each phone token its id's template
    (``data.synthetic.phone_templates``), silence past the length, then
    Gaussian noise from ``noise_rng`` (one stream across the sub-batches)."""
    spp = templates.shape[1]
    b = src.shape[0]
    ids = np.zeros((b, s_max), src.dtype)
    ids[:, : src.shape[1]] = src
    lens = (src_len * spp).astype(np.int32)
    wavs = templates[ids].reshape(b, s_max * spp)
    valid = np.arange(s_max * spp)[None, :] < lens[:, None]
    wavs = np.where(valid, wavs, np.float32(0.0))
    wavs += np.float32(NOISE) * noise_rng.standard_normal(wavs.shape, dtype=np.float32) * valid
    return wavs, lens


def stage_synthesize(args, shards_dir: Path) -> dict:
    """Waveforms -> K5 MFCC -> frame shards, O(batch) host residency."""
    from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
    from multimodalworddiscovery_tpu_torch.data.stream import ShardWriter
    from multimodalworddiscovery_tpu_torch.data.synthetic import (
        expand_gold_to_frames,
        make_flickr8k_mini_batches,
        phone_templates,
    )
    from multimodalworddiscovery_tpu_torch.scripts.run_pipeline import MFCC, frontend

    dev = torch.device(args.device)
    _, s_max, batches = make_flickr8k_mini_batches(
        n_utterances=args.utterances, batch_size=args.shard_size,
        n_concepts=args.concepts, n_phones=N_PHONES, seed=args.seed, device=dev,
    )
    templates = phone_templates(N_PHONES + 1, SAMPLE_RATE, PHONE_MS, seed=args.seed)
    spp = templates.shape[1]  # samples per phone
    noise_rng = np.random.default_rng(args.seed + 1)
    n_batches = -(-args.utterances // args.shard_size)
    f_pad = None
    wav_seconds = 0.0
    with ShardWriter(shards_dir, args.shard_size, name="fullscale", shuffle_seed=args.seed,
                     storage_dtype=args.storage_dtype) as writer:
        for bi, (phone_corpus, gold) in enumerate(batches):
            b = phone_corpus.n
            src_np = phone_corpus.src.cpu().numpy()
            len_np = phone_corpus.src_len.cpu().numpy()
            feats_parts, flen_parts = [], []
            # a sub-batch of waveforms at a time: host and device memory are
            # O(mfcc_batch)
            for lo in range(0, b, args.mfcc_batch):
                hi = min(lo + args.mfcc_batch, b)
                wavs, lens = render_waveforms(src_np[lo:hi], len_np[lo:hi], s_max, templates,
                                              noise_rng)
                wav_seconds += float(lens.sum()) / SAMPLE_RATE
                feats, flens = frontend(torch.as_tensor(wavs, device=dev),
                                        torch.as_tensor(lens, device=dev), MFCC)
                feats_parts.append(feats)
                flen_parts.append(flens)
            feats = torch.cat(feats_parts)
            frame_lens = torch.cat(flen_parts)
            if f_pad is None:
                f_pad = int(feats.shape[1])  # fixed: the waveform width is global
            assert feats.shape[1] == f_pad, (feats.shape, f_pad)

            frame_gold = expand_gold_to_frames(gold, len_np, frame_lens.cpu().numpy())
            ga = np.zeros((b, f_pad), np.int32)
            ga[:, : frame_gold.alignment.shape[1]] = frame_gold.alignment
            writer.append(Corpus(src=feats, src_len=frame_lens, trg=phone_corpus.trg,
                                 trg_len=phone_corpus.trg_len, src_vocab=0,
                                 trg_vocab=phone_corpus.trg_vocab), gold_alignment=ga)
            if (bi + 1) % max(1, n_batches // 8) == 0 or bi + 1 == n_batches:
                print(f"  shard {bi + 1}/{n_batches} written (rss {_rss_gb():.2f} GB)",
                      flush=True)
    return {"shards": n_batches, "frames_pad": f_pad, "wav_pad": s_max * spp,
            "audio_hours": wav_seconds / 3600.0}


def stage_crosscheck(args, shards_dir: Path, workdir: Path) -> dict:
    """Shard 0 evaluated RESIDENT against STREAMED with the trained params."""
    from multimodalworddiscovery_tpu_torch.data.io import load_alignment_json, save_alignment_json
    from multimodalworddiscovery_tpu_torch.data.stream import FIELDS, ShardedCorpusReader
    from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf
    from multimodalworddiscovery_tpu_torch.models import hmm_gaussian
    from multimodalworddiscovery_tpu_torch.parallel.data_parallel import take_rows
    from multimodalworddiscovery_tpu_torch.utils.checkpoint import CheckpointManager

    dev = torch.device(args.device)
    reader = ShardedCorpusReader(shards_dir, device=dev)
    sub_dir = workdir / "shard0_only"
    sub_dir.mkdir(parents=True, exist_ok=True)
    for field in FIELDS:
        shutil.copy(shards_dir / f"{field}_0.npy", sub_dir / f"{field}_0.npy")
    n_sub = min(reader.shard_size, reader.n)
    manifest = json.loads((shards_dir / "manifest.json").read_text())
    manifest.update(num_shards=1, n=n_sub, name="fullscale-shard0")
    (sub_dir / "manifest.json").write_text(json.dumps(manifest))
    gold = load_alignment_json(shards_dir / "gold.json", reader.n, reader.max_src_len)
    sub0 = reader.load_shard(0)
    save_alignment_json(gold.alignment[:n_sub], sub0.src_len.cpu().numpy()[:n_sub],
                        sub_dir / "gold.json")

    # streamed evaluation over the single-shard manifest (stage 5's code
    # path, restricted to shard 0's rows)
    _run_cli(["evaluate", "--workdir", str(workdir), "--device", args.device,
              "--output", str(workdir / "metrics_shard0_streamed.json"),
              "--override", f"data.dir={sub_dir}", "eval.retrieval=false", "eval.dtw=false"])
    streamed = json.loads((workdir / "metrics_shard0_streamed.json").read_text())

    # resident: shard 0 on the device, the same checkpoint, decode + metrics
    corpus = take_rows(sub0, 0, n_sub)
    params, _ = CheckpointManager(workdir / "ckpt").restore(
        hmm_gaussian.init(corpus, n_components=args.components))
    with torch.no_grad():
        alignment = hmm_gaussian.align(params, corpus)
        resident = {k: float(v) for k, v in alignment_prf(
            alignment, torch.as_tensor(gold.alignment[:n_sub], device=dev),
            corpus.src_mask()).items()}
    delta = max(abs(resident[k] - streamed["alignment"][k])
                for k in ("precision", "recall", "f1"))
    print(f"  resident shard-0 F1 {resident['f1']:.4f} vs streamed "
          f"{streamed['alignment']['f1']:.4f} (max |delta| {delta:.2e})")
    if delta > 1e-5:
        raise SystemExit(f"streamed/resident mismatch on shard 0: {delta} "
                         f"({resident} vs {streamed['alignment']})")
    return {"resident_f1": resident["f1"], "streamed_f1": streamed["alignment"]["f1"],
            "max_abs_delta": delta}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--utterances", type=int, default=131072)
    ap.add_argument("--shard-size", type=int, default=8192)
    ap.add_argument("--mfcc-batch", type=int, default=2048,
                    help="waveforms per MFCC launch (bounds host and device memory)")
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--components", type=int, default=2)
    ap.add_argument("--concepts", type=int, default=40)
    ap.add_argument("--retrieval-pool", type=int, default=100)
    ap.add_argument("--recipe", action="store_true",
                    help="train with the streamed VQ-teacher recipe (init=vq_teacher + "
                         "annealed EM) instead of flat-start EM")
    ap.add_argument("--storage-dtype", default=None, choices=["float32", "float16"],
                    help="on-disk dtype of the frame shards; float16 halves the disk bytes "
                         "and each EM pass's host-to-device copy (values round to float16 "
                         "once, at write time; compute stays float32)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="run directory (default: mwd_torch_fullscale in the temp dir)")
    ap.add_argument("--report", default=None, help="JSON report path")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    ap.add_argument("--keep-shards", action="store_true",
                    help="reuse an existing shard dir (skip stage 1)")
    args = ap.parse_args(argv)
    if args.shard_size % args.mfcc_batch:
        raise SystemExit("--shard-size must be a multiple of --mfcc-batch")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    workdir = Path(args.workdir or Path(tempfile.gettempdir()) / "mwd_torch_fullscale")
    shards_dir = workdir / "shards"
    if not args.keep_shards and workdir.exists():
        shutil.rmtree(workdir)
    workdir.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    stages: list[dict] = []
    report: dict = {"config": vars(args)}

    def stage(name, fn):
        t = time.perf_counter()
        out = fn()
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        stages.append({"stage": name, "seconds": dt, "rss_gb": _rss_gb()})
        print(f"[{time.perf_counter() - t0:7.1f}s] {name}: {dt:.1f}s "
              f"(rss {_rss_gb():.2f} GB)", flush=True)
        return out

    print(f"device: {args.device}"
          + (f" ({torch.cuda.get_device_name(0)})" if torch.cuda.is_available()
             and torch.device(args.device).type == "cuda" else ""), flush=True)

    if args.keep_shards and (shards_dir / "manifest.json").exists():
        print("stage 1 skipped (--keep-shards)")
        report["synthesize"] = json.loads((shards_dir / "manifest.json").read_text())
    else:
        report["synthesize"] = stage("synthesize+mfcc+shard",
                                     lambda: stage_synthesize(args, shards_dir))

    train_overrides = [
        "data.source=stream", f"data.dir={shards_dir}",
        "model.name=hmm_gaussian", f"model.n_components={args.components}",
        f"train.num_iterations={args.iters}", f"train.checkpoint_every={args.iters}",
        "train.stream_prefetch=2",
    ]
    if args.recipe:
        # flat-start Gaussian EM finds the degenerate likelihood optimum at
        # scale; the streamed VQ-teacher + annealing recipe is the fix and
        # runs fully out of core
        train_overrides += ["model.init=vq_teacher", "model.vq_codes=64",
                            "model.teacher_iters=10", "model.seed_rounds=3",
                            "model.anneal_iters=6"]
    dev_flag = ["--device", args.device]
    stage("streamed EM" + (" (vq_teacher + anneal)" if args.recipe else ""),
          lambda: _run_cli(["train", "--workdir", str(workdir), *dev_flag, "--fresh",
                            "--override", *train_overrides]))
    stage("streamed align", lambda: _run_cli(["align", "--workdir", str(workdir), *dev_flag]))
    stage("streamed segment",
          lambda: _run_cli(["segment", "--workdir", str(workdir), *dev_flag]))
    stage("streamed evaluate", lambda: _run_cli(
        ["evaluate", "--workdir", str(workdir), *dev_flag, "--override",
         f"eval.retrieval_pool={args.retrieval_pool}", "eval.dtw_utterances=64"]))
    report["crosscheck"] = stage("resident/streamed cross-check",
                                 lambda: stage_crosscheck(args, shards_dir, workdir))

    report["stages"] = stages
    report["metrics"] = json.loads((workdir / "metrics.json").read_text())
    report["train_loglik"] = [json.loads(line)["loglik"] for line in
                              (workdir / "train_metrics.jsonl").read_text().splitlines()]
    report["total_seconds"] = time.perf_counter() - t0

    print("\n| stage | wall time | peak RSS |")
    print("|---|---|---|")
    for s in stages:
        print(f"| {s['stage']} | {s['seconds']:.1f} s | {s['rss_gb']:.2f} GB |")
    print(f"| TOTAL | {report['total_seconds']:.1f} s | |")
    out = Path(args.report or workdir / "report.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(f"\nwrote {out}")
    return report


if __name__ == "__main__":
    main()
