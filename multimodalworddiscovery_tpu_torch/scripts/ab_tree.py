"""Time one source tree's K1 / K5 / K7 / K8 benchmarks, path 8's EM and path
9's associative forward, on the card.

To compare two trees in one call, unpack the parent with ``git archive``
under ``build/parent`` (copy this tree's ``scripts/bench_kernels.py`` in
where the parent's lacks an entry: K1's device times and shapes, K8's
path-9 shapes, K5's larger configurations) and run the trees in turns:

    for t in build/parent . . build/parent; do
        python multimodalworddiscovery_tpu_torch/scripts/ab_tree.py "$(realpath $t)"
    done

For the tree at ROOT it prints one JSON line for path 8 (chip_smoke.py's
dense-caption corpus: ms per EM iteration over 3 runs of 10 iterations by
CUDA events, and K7's device time per iteration from torch.profiler), one
for path 9 (``forward_associative`` at bench_assoc's S64 and S128 shapes,
parameters after 10 EM iterations as in chip_smoke.py: ms per call over 3
calls by CUDA events), then runs that tree's ``scripts/bench_kernels.py
--only mfcc counts log_matmul`` (JSON lines on stdout, records under
ROOT/build/bench/).
"""

from __future__ import annotations

import json
import os
import sys

# chip_smoke.py's DENSE: the dense-caption corpus of path 8
DENSE = dict(n_utterances=512, n_concepts=400, n_phones=48, min_concepts=48,
             max_concepts=64, min_word_len=2, max_word_len=3, seed=2)
ITERS, RUNS = 10, 3


def main(argv: list[str]) -> None:
    root = os.path.realpath(argv[0])
    reps = argv[1] if len(argv) > 1 else "20"
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import multimodalworddiscovery_tpu_torch as pkg
    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core
    from multimodalworddiscovery_tpu_torch.scripts import bench_assoc, bench_kernels

    if not pkg.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {pkg.__file__}, not the tree at {root}")
    dev = bench_kernels.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    corpus, _, _ = make_flickr8k_mini(**DENSE, device=dev)
    p0 = hmm.init(corpus)
    hmm.train(p0, corpus, 2)
    torch.cuda.synchronize()
    runs = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        hmm.train(p0, corpus, ITERS)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / ITERS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(RUNS):
            hmm.em_step(p0, corpus)
        torch.cuda.synchronize()
    k7 = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and "mwd_pair_counts" in e.key)
    print(json.dumps({"tree": root, "card": bench_kernels.card(), "path8_ms_per_iter": runs,
                      "path8_k7_device_ms_per_iter": k7 / 1e3 / RUNS}))
    del corpus, p0
    assoc = {}
    for label, gen in bench_assoc.SHAPES:
        corpus, _, _ = make_flickr8k_mini(**gen, device=dev)
        params = hmm.train(hmm.init(corpus), corpus, ITERS)[0]
        log_init, log_trans, log_emit = hmm._machinery(params, corpus)
        args = (log_init, log_trans, log_emit, corpus.src_len)
        assoc[label] = bench_kernels.gpu_ms(lambda: hmm_core.forward_associative(*args), RUNS)
        del corpus, params, args
        torch.cuda.empty_cache()
    print(json.dumps({"tree": root, "card": bench_kernels.card(),
                      "path9_forward_associative_ms": assoc}))
    bench_kernels.main(["--only", "mfcc", "counts", "log_matmul", "--reps", reps])


if __name__ == "__main__":
    main(sys.argv[1:])
