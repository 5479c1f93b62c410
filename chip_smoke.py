#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodalworddiscovery_tpu_torch/csrc``
into ``build/``, checks each kernel against its plain PyTorch version at the
shapes the main path gives it, then drives the main path once: the
headline discrete-HMM EM workload (synthetic Flickr8k-scale corpus, N=8000
utterances, S=12 states) for 10 EM iterations through the kernels, then
Viterbi align, segmentation and alignment P/R/F1, and the same run through
the plain path on the same card for comparison.  It then times the kernel
path against the plain path with CUDA events.

Exits nonzero, printing no result, when there is no CUDA device or any
check fails.  On success the next-to-last line is a JSON object describing
each kernel, and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HEADLINE = dict(n_utterances=8000, n_concepts=60, n_phones=48, min_concepts=3,
                max_concepts=6, seed=0)  # bench.py's corpus
GATE_EDGE = dict(n_utterances=1024, n_concepts=200, min_concepts=28,
                 max_concepts=32, min_word_len=2, max_word_len=3, seed=21)
EM_ITERS = 10
# alignment F1 of the JAX reference on the CPU after 10 EM iterations from
# init on the headline corpus (plain scan path)
REFERENCE_F1 = 0.9396
ZERO_LENGTH_PAD = 4  # zero-length utterances appended in the parity phase


def _run(cmd: list[str]) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (out.stdout or out.stderr).strip()


def _check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        raise AssertionError(what)


def _max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _gpu_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _estep_inputs(params, corpus):
    """(state concepts, (log_init, base, rowz, colmask)) for the E-step."""
    from multimodalworddiscovery_tpu_torch.models import hmm_core

    concepts = hmm_core.state_concepts(corpus)
    base, rowz, colmask = hmm_core.factor_log_trans(
        params.log_jump, params.log_p0, corpus, params.max_jump
    )
    log_init = hmm_core.build_log_init(params.log_p0, corpus)
    return concepts, (log_init, base, rowz, colmask)


def parity(name, gen, dev) -> dict:
    """K1 and K2 against their plain versions on the card at one shape."""
    import torch

    from multimodalworddiscovery_tpu_torch.core.counts import pair_counts
    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core
    from multimodalworddiscovery_tpu_torch.ops import counts as k1
    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k2

    corpus, _, _ = make_flickr8k_mini(**gen)
    corpus = corpus.pad_to(corpus.n + ZERO_LENGTH_PAD).to(dev)
    params = hmm.init(corpus)
    params, _ = hmm.em_step(params, corpus)  # non-uniform parameters
    v_src, v_trg = params.log_emit.shape
    concepts, (log_init, base, rowz, colmask) = _estep_inputs(params, corpus)
    n, ts, s = corpus.n, corpus.max_src_len, concepts.shape[1]
    print(f"parity at {name}: N={n} (incl. {ZERO_LENGTH_PAD} empty), Ts={ts}, "
          f"S={s}, V_src={v_src}, V_trg={v_trg}")

    emit = k1.table_lookup(params.log_emit, corpus.src, concepts)
    emit_plain = k1.table_lookup_plain(params.log_emit, corpus.src, concepts)
    torch.cuda.synchronize()
    k1_err = _max_abs(emit, emit_plain)
    _check(torch.equal(emit, emit_plain), f"K1 exact vs plain gather (max abs err {k1_err})")

    args = (log_init, base, rowz, colmask, emit, corpus.src, concepts,
            corpus.src_len, v_src, v_trg)
    counts, xi, logz = k2.hmm_estep_counts(*args)
    counts_p, xi_p, logz_p = k2.hmm_estep_counts_plain(*args)
    torch.cuda.synchronize()
    errs = {"logz": _max_abs(logz, logz_p), "counts": _max_abs(counts, counts_p),
            "xi": _max_abs(xi, xi_p)}
    print(f"  K2 max abs err vs plain: {errs}")
    _check(torch.allclose(logz, logz_p, rtol=1e-4, atol=1e-4), "K2 logZ rtol 1e-4 atol 1e-4")
    _check(bool((logz[-ZERO_LENGTH_PAD:] == 0).all()), "K2 logZ = 0 on zero-length utterances")
    ll, ll_p = float(logz.sum()), float(logz_p.sum())
    _check(abs(ll - ll_p) <= 1e-6 * abs(ll_p),
           f"K2 total loglik rtol 1e-6 ({ll} vs {ll_p})")
    scale = max(float(counts_p.max()), 1.0)
    _check(errs["counts"] <= 1e-4 * scale, f"K2 emission counts atol 1e-4 x {scale}")
    _check(torch.allclose(xi, xi_p, rtol=1e-4, atol=1e-3), "K2 xi rtol 1e-4 atol 1e-3")

    # and against the dense plain E-step (the use_kernels=False route)
    gamma, wc_d, logz_d = hmm_core.estep(
        params.log_jump, params.log_p0, params.max_jump,
        hmm._log_emissions(params, corpus, concepts), corpus,
    )
    counts_d = pair_counts(gamma, corpus.src, concepts, v_src, v_trg)
    wc = hmm_core.project_widths(xi, corpus.max_trg_len, params.max_jump)
    _check(torch.allclose(logz, logz_d, rtol=1e-4, atol=1e-4), "K2 logZ vs dense fwd-bwd")
    scale = max(float(counts_d.max()), 1.0)
    _check(_max_abs(counts, counts_d) <= 1e-4 * scale, "K2 counts vs dense fwd-bwd")
    _check(torch.allclose(wc, wc_d, rtol=1e-4, atol=1e-3), "K2 width counts vs dense fwd-bwd")
    return {"k1_err": k1_err, "k2_err": errs["logz"]}


def main_path(corpus, gold, use_kernels: bool):
    import torch

    from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf
    from multimodalworddiscovery_tpu_torch.models import hmm
    from multimodalworddiscovery_tpu_torch.segment import segment_corpus

    params = hmm.init(corpus)
    params, lls = hmm.train(params, corpus, EM_ITERS, use_kernels=use_kernels)
    alignment = hmm.align(params, corpus)
    segs, seg_mask = segment_corpus(alignment, corpus)
    gold_t = torch.as_tensor(gold.alignment, device=corpus.device)
    prf = alignment_prf(alignment, gold_t, corpus.src_mask())
    torch.cuda.synchronize()
    return {
        "params": params, "lls": lls.cpu().numpy(), "alignment": alignment,
        "segs": segs, "seg_mask": seg_mask,
        "prf": {k: float(v) for k, v in prf.items()},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import multimodalworddiscovery_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    import numpy as np

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.models import hmm
    from multimodalworddiscovery_tpu_torch.ops import _build
    from multimodalworddiscovery_tpu_torch.ops import counts as k1
    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    print(f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(lib_path, here)}")
    print(_run([_build.find_nvcc(), "--version"]).splitlines()[-1])
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # --- kernel parity at the main path's shape and at the K2 gate edge ---
    errs = parity("headline shape", HEADLINE, dev)
    parity("K2 gate edge (S=64)", GATE_EDGE, dev)

    # --- the main path, through the kernels, then through the plain path ---
    corpus, gold, _ = make_flickr8k_mini(**HEADLINE, device=dev)
    print(f"main path: N={corpus.n}, Ts={corpus.max_src_len}, "
          f"S={2 * corpus.max_trg_len}, V_src={corpus.src_vocab}, "
          f"V_trg={corpus.trg_vocab}, {EM_ITERS} EM iterations")
    k1.table_lookup.launches = 0
    k2.hmm_estep_counts.launches = 0
    kern = main_path(corpus, gold, use_kernels=True)
    launches = {"table_lookup": k1.table_lookup.launches,
                "hmm_estep_counts": k2.hmm_estep_counts.launches}
    plain = main_path(corpus, gold, use_kernels=False)

    lw = kern["lls"]
    print(f"  kernel-path loglik per iteration: {lw.tolist()}")
    print(f"  plain-path loglik per iteration:  {plain['lls'].tolist()}")
    print(f"  kernel launches on the main path: {launches}")
    print(f"  kernel path alignment: {kern['prf']}")
    print(f"  plain path alignment:  {plain['prf']}")
    _check(all(v > 0 for v in launches.values()), "K1 and K2 launched on the main path")
    _check(bool(np.all(np.isfinite(lw))), "loglik finite")
    _check(bool(np.all(np.diff(lw) > -1e-3 * np.abs(lw[:-1]))) and lw[-1] > lw[0],
           "loglik monotone within bench.py's bound and improving")
    ll, ll_p = float(lw[-1]), float(plain["lls"][-1])
    _check(abs(ll - ll_p) <= 1e-4 * abs(ll_p), f"final loglik within rtol 1e-4 of plain ({ll} vs {ll_p})")
    f1, f1_p = kern["prf"]["f1"], plain["prf"]["f1"]
    _check(abs(f1 - f1_p) <= 0.002, f"F1 within 0.002 of plain ({f1:.4f} vs {f1_p:.4f})")
    _check(abs(f1 - REFERENCE_F1) <= 0.005,
           f"F1 within 0.005 of the JAX reference {REFERENCE_F1} ({f1:.4f})")
    segs, seg_mask = kern["segs"], kern["seg_mask"]
    _check(tuple(segs.shape) == (corpus.n, corpus.max_src_len, 3), "segments shape [N, Ts, 3]")
    valid = segs[seg_mask]
    _check(bool(((valid[:, 0] < valid[:, 1]) & (valid[:, 2] > 0)).all())
           and int(seg_mask.sum()) > 0, f"{int(seg_mask.sum())} word units, each non-empty with a concept")
    same = (kern["alignment"] == plain["alignment"]).all(dim=1).float().mean().item()
    _check(same >= 0.99, f"alignments equal to the plain path's on {same:.4f} of utterances")

    # --- times (CUDA events), each beside the card's name and power limit;
    # the two paths alternate (plain, kernels, kernels, plain, ...) ---
    p0 = hmm.init(corpus)

    def em(use_kernels):
        return lambda: hmm.train(p0, corpus, EM_ITERS, use_kernels=use_kernels)

    em_ms = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain") * 3:
        em_ms[which].append(_gpu_ms(em(which == "kernels"), 2) / EM_ITERS)
    ms_k, ms_p = float(np.median(em_ms["kernels"])), float(np.median(em_ms["plain"]))
    print(f"  [{card}] EM ms/iter, median of {len(em_ms['kernels'])} runs of "
          f"2x{EM_ITERS} iterations: kernel path {ms_k:.4f}, plain path {ms_p:.4f} "
          f"(all runs: {em_ms})")
    print(f"  [{card}] EM throughput: kernel path {corpus.n * 1e3 / ms_k:.1f} "
          f"utt*iter/s, plain path {corpus.n * 1e3 / ms_p:.1f} utt*iter/s")

    params = kern["params"]
    concepts, (log_init, base, rowz, colmask) = _estep_inputs(params, corpus)
    emit = k1.table_lookup(params.log_emit, corpus.src, concepts)
    args = (log_init, base, rowz, colmask, emit, corpus.src, concepts,
            corpus.src_len, corpus.src_vocab, corpus.trg_vocab)
    k1_ms = _gpu_ms(lambda: k1.table_lookup(params.log_emit, corpus.src, concepts), 50)
    k1_plain_ms = _gpu_ms(lambda: k1.table_lookup_plain(params.log_emit, corpus.src, concepts), 50)
    k2_ms = _gpu_ms(lambda: k2.hmm_estep_counts(*args), 20)
    k2_plain_ms = _gpu_ms(lambda: k2.hmm_estep_counts_plain(*args), 5)
    print(f"  [{card}] K1 table_lookup: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")
    print(f"  [{card}] K2 hmm_estep_counts: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms")

    kernels = [
        {"name": "table_lookup", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/counts.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/counts_pallas.py:92",
         "launches": launches["table_lookup"], "max_abs_err": errs["k1_err"],
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "hmm_estep_counts", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/hmm_fwdbwd.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/hmm_fwdbwd_pallas.py:758",
         "launches": launches["hmm_estep_counts"], "max_abs_err": errs["k2_err"],
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
