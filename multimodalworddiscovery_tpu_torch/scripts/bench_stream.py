"""Out-of-core streamed EM against resident EM on the same corpus -> JSON
lines.

    python -m multimodalworddiscovery_tpu_torch.scripts.bench_stream \\
        [--n 65536] [--shard-size 8192] [--iters 5] [--reps 3] \\
        [--device cuda|cpu] [--out build/bench/stream.jsonl]

The discrete ``hmm`` on the headline corpus family (60 concepts, 48
phones, 3-6 concepts an image, seed 0), N utterances: the resident loop
(``hmm.em_step`` on the whole corpus, its loglik read every iteration)
against ``data.stream.train_streaming`` over shards of ``--shard-size``
written to a temporary directory (the shards read from disk, copied to the
device and summed every iteration, the loglik read once an iteration), at
prefetch 1 and 2.  On a CUDA device both run through K1 + K2.

Each side is warmed up, then timed ``--reps`` times over ``--iters``
iterations with the host clock around work that ends in a synchronize; a
record holds the median ms per iteration, utterance-iterations per second
and, for the streamed rows, the overlap efficiency (streamed throughput
over resident).  A last record breaks a streamed iteration down: the ms to
read and copy one shard on the calling thread, and the ms of one EM
iteration over the shards already on the device and over shards loaded
in the same loop, with no reader thread.  Records are printed and
appended to ``--out``, each with the device's name and, on a card, its
name and power limit as nvidia-smi prints them.  ``--device cpu`` runs the plain versions on the host (a
timing of the host's CPU, not of any card).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
from multimodalworddiscovery_tpu_torch.data.stream import (
    ShardedCorpusReader,
    train_streaming,
    tree_map,
    write_shards,
)
from multimodalworddiscovery_tpu_torch.models import hmm

DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[2] / "build" / "bench" / "stream.jsonl"
CORPUS = dict(n_concepts=60, n_phones=48, min_concepts=3, max_concepts=6, seed=0)
PREFETCH = (1, 2)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_s(fn, reps: int, dev: torch.device) -> float:
    """Median host seconds of ``fn()`` over ``reps`` runs, each ended by a
    synchronize."""
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _stamp(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"device": "cpu", "card": None}
    from multimodalworddiscovery_tpu_torch.scripts.bench_kernels import card

    return {"device": torch.cuda.get_device_name(dev), "card": card()}


def run(n: int, shard_size: int, iters: int, reps: int, dev: torch.device,
        out: pathlib.Path | None = None) -> list[dict]:
    """The benchmark's records: resident, one per prefetch, the breakdown."""
    corpus, _, _ = make_flickr8k_mini(n_utterances=n, **CORPUS, device=dev)
    stamp = _stamp(dev)
    records = []

    def record(**rec):
        rec.update(ts=time.time(), **stamp)
        records.append(rec)
        print(json.dumps(rec))
        if out is not None:
            out.parent.mkdir(parents=True, exist_ok=True)
            with out.open("a") as f:
                f.write(json.dumps(rec) + "\n")

    params0 = hmm.init(corpus)

    def resident():
        p = params0
        for _ in range(iters):
            p, stats = hmm.em_step(p, corpus)
            float(stats["loglik"])  # read every iteration, as the streamed loop does

    resident()  # warm-up (kernel load, allocator)
    res_s = _median_s(resident, reps, dev)
    res_thr = n * iters / res_s
    record(bench="stream_resident_em", n=n, iters=iters, reps=reps,
           ms_per_iter=res_s / iters * 1e3, utt_iter_per_s=res_thr)
    with tempfile.TemporaryDirectory() as td:
        n_shards = write_shards(corpus, td, shard_size)
        reader = ShardedCorpusReader(td, device=dev)
        for prefetch in PREFETCH:
            def streamed():
                train_streaming(hmm, params0, reader, iters, prefetch=prefetch)

            train_streaming(hmm, params0, reader, 1, prefetch=prefetch)  # warm-up
            s = _median_s(streamed, reps, dev)
            thr = n * iters / s
            record(bench="stream_shards_em", n=n, shard_size=shard_size, num_shards=n_shards,
                   prefetch=prefetch, iters=iters, reps=reps, ms_per_iter=s / iters * 1e3,
                   utt_iter_per_s=thr, overlap_efficiency=thr / res_thr)

        # where a streamed iteration goes: reading and copying the shards
        # alone, EM over the same shards already on the device, and both
        # in one loop with no reader thread
        def em_iteration(shards):
            total = None
            for shard in shards:
                counts = hmm.expected_counts(params0, shard)
                total = counts if total is None else tree_map(torch.add, total, counts)
            hmm.m_step(params0, total[0])
            float(total[1])

        on_device = [reader.load_shard(k) for k in range(n_shards)]
        record(bench="stream_breakdown", n=n, shard_size=shard_size, num_shards=n_shards,
               reps=reps,
               read_ms_per_shard=_median_s(lambda: [reader.load_shard(k) for k in
                                                    range(n_shards)], reps, dev) / n_shards * 1e3,
               em_on_device_shards_ms_per_iter=_median_s(
                   lambda: em_iteration(on_device), reps, dev) * 1e3,
               em_no_thread_ms_per_iter=_median_s(
                   lambda: em_iteration(reader.load_shard(k) for k in range(n_shards)),
                   reps, dev) * 1e3)
        del on_device
    return records


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--shard-size", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=pathlib.Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda needs a CUDA device (pass --device cpu to run "
                             "the plain versions on the host)")
        torch.backends.cuda.matmul.allow_tf32 = False
    return run(args.n, args.shard_size, args.iters, args.reps, dev, args.out)


if __name__ == "__main__":
    main()
