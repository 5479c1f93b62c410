#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodalworddiscovery_tpu_torch/csrc``
into ``build/``, checks each kernel against its plain PyTorch version at the
shapes the main paths give it, then drives nine paths through the kernels
(paths 1-4, 6 and 8 also through the plain path) on the same card:

1. the headline discrete-HMM EM workload (synthetic Flickr8k-scale corpus,
   N=8000 utterances, S=12 states): 10 EM iterations through K1 + K2, then
   Viterbi align through K3, segmentation and alignment P/R/F1;
2. the Gaussian-HMM parity run on the stretch config's corpus (N=4000
   utterances of 64-dim frames, S=64 states, 201 concepts): diagonal flat
   start, 10 annealed EM iterations through K4, decode through K3, F1
   against the JAX reference's value for the same initial parameters; each
   iteration's E-step also runs through the plain route from the same
   parameters, and the final logliks are held to the float64 plain path's
   and to that of K4's plain version in the kernel route;
3. the stretch recipe as users run it: VQ teacher (k-means codebook, then
   discrete-HMM EM through K1 + K2), annealed Gaussian EM (K=2) through K4,
   decode through K3, alignment and boundary F1;
4. config #4's waveform pipeline (``scripts/run_pipeline.run_pipeline`` at
   N=2000 utterances, 12 EM iterations): synthetic waveforms, MFCCs
   through K5, Gaussian EM (K=2) through K4, decode through K3,
   segmentation, alignment P/R/F1 against the JAX reference's value for the
   same initial parameters, word IoU, boundary F1 and purity;
5. path 1's EM at ``dot_dtype="bfloat16"``: K1, K2-bf16, K3;
6. ``configs/hmm_crf_frames.py`` at full width (N=400 utterances of 12-dim
   frames, S=8, hidden 256): 10 iterations of the end-to-end CRF aligner
   (``hmm_crf.train``: 4 Adam steps a iteration with the MLP's gradient
   through K4's gamma, then a closed-form M-step), decode through K3,
   alignment F1 and positional accuracy against the JAX reference's values
   for the same initial parameters; through K4, through the plain path and
   through K4-bf16; and ``hmm_dnn.train`` (the generalized-EM DNN-HMM) on
   the same corpus;
7. ``configs/hmm_crf_e2e.py``: the same corpus, 20 iterations with the
   transitions learned through the CRF moment gradient;
8. the dense-caption discrete HMM at the reference's S=128 row
   (``scripts/bench_kernels.py:261-263``: N=512 utterances, Ts=181, S=128,
   V_src=49, V_trg=401, outside K2's gate): 10 EM iterations through the
   general route K1 -> K4 -> K7, decode through K3, segmentation and
   alignment F1 against the JAX reference's value from the same
   (deterministic) initial parameters, kernels and plain;
9. the associative and blocked forward passes (``forward_associative``,
   ``forward_blocked(block=16)``) with K8 as their combine, at
   ``scripts/bench_assoc.py``'s S64 (N=256, Ts=147) and S128 (N=64, Ts=176)
   shapes, held to the sequential plain forward and to K4's logZ; then the
   port's ``scripts/bench_assoc.py`` and ``scripts/bench_kernels.py --only
   counts log_matmul`` once each, with few repetitions.

K1, K2 and K2-bf16 are checked and timed at the headline shape, at K2's
gate edge and at the VQ teacher's shape (the recipe's code corpus: N=4000,
Ts=401, S=64, V_src=64), where the teacher's EM trajectory is also held
against the plain path's and one of its EM iterations is profiled; the
JSON line gives K2's and K2-bf16's launches, time and bound per launch
shape, and K3's at each shape it decodes.  K4,
K4-bf16 and K6 (the remat E-step, reached through its entry point
``hmm_estep(remat=True)``, which no model path calls) are checked at the
stretch shape and at S=128, K6 at two chunk lengths and against K4; each
bf16 kernel is also shown to round (closer to its plain bf16 version than
to the float32 kernel, and not equal to the latter).  K4, K4-bf16 and K6
are also checked and timed at the two S=8 shapes the pipeline and the CRF
paths launch them at (inputs from ``scripts/bench_estep.py``; K3 there
too), and the
JSON line gives K4's launches, time and bound per launch shape.  Above the
160 states the kernels once took, K4, K4-bf16, K6 and K3 are held to their
plain versions on a corpus of 96-100 concepts an image (S~200) and one of
126-130 (S~260, past 8-bit backpointers), and on random inputs at S=2000
(K4's block buffers in device memory, K3's threads looping over the
states), and ``hmm.train`` (3 iterations) and ``hmm.align`` run on the
S~200 corpus through K1 -> K4 -> K7 and K3 against the plain route.  K5 is
checked at the pipeline's batch (N=2000 waveforms of
28,160 samples, plus waveforms of 0, 399, 400 and 401 samples), for MFCCs
and log-mels, and on 1000 frames; the ``extract_features speech`` command
runs once on a small .npz under ``build/``.  K7 is checked on K4's
posteriors at the headline shape and at path 8's; K8 at 512 x 512 and
1024 x 1024 from 5 * normal, on the even / odd step-matrix slices that path
9's scan hands it, on a synthetic row whose largest product lies 250 nats
below its maximum (where the factored form underflows), and on the prefix
products of path 9's step matrices (their widest row's span and the
factored form's error there are printed); K8-bf16 against its plain bf16
version, against K8 and as rounding.

Each path's kernel launch counts are set to 0 just before it and read just
after.  It then times kernels and paths against their plain versions with
CUDA events, computes each timed kernel call's bound (bytes over the
memory rate or operations over the peak rate for their type), and profiles one
Gaussian EM iteration and the waveform pipeline after synthesis.

Exits nonzero, printing no result, when there is no CUDA device or any
check fails.  On success the next-to-last line is a JSON object describing
each kernel, and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

HEADLINE = dict(n_utterances=8000, n_concepts=60, n_phones=48, min_concepts=3,
                max_concepts=6, seed=0)  # bench.py's corpus
GATE_EDGE = dict(n_utterances=1024, n_concepts=200, min_concepts=28,
                 max_concepts=32, min_word_len=2, max_word_len=3, seed=21)
# configs/stretch_hubert_clip.py's synthetic corpus at full size (S=64)
STRETCH = dict(n_utterances=4000, n_concepts=200, n_phones=48, min_concepts=16,
               max_concepts=32, seed=0)
STRETCH_FRAMES = dict(feat_dim=64, seed=0)
# the discrete route outside K2's gate, near docs/PERFORMANCE.md:115 (S=128)
S128 = dict(n_utterances=512, n_concepts=200, min_concepts=60, max_concepts=64,
            min_word_len=2, max_word_len=3, seed=21)
EM_ITERS = 10
ANNEAL = (0.25, 6)  # the stretch config's emission temperature ramp
MAX_JUMP = 5  # configs/stretch_hubert_clip.py model.max_jump
N_CODES = 64  # the stretch recipe's VQ codebook size (V_src of its teacher)
SEED = 0  # CPU generator seed of the Gaussian paths' random draws
# alignment F1 of the JAX reference on the CPU after 10 EM iterations from
# init on the headline corpus (plain scan path)
REFERENCE_F1 = 0.9396
# alignment F1 of the JAX reference for the Gaussian parity run: this
# script's init_diagonal(max_jump=5, n_components=1) parameters from the CPU
# generator with seed 0, carried into the JAX package as numpy arrays, then
# its hmm_gaussian.expected_counts / m_step for 10 annealed iterations and
# hmm_gaussian.align, on the CPU (P 0.42275, R 0.37392)
REFERENCE_GAUSS_F1 = 0.3968
REFERENCE_GAUSS_LL = -37503604.5  # its loglik at the 10th iteration
PIPELINE_N = 2000  # configs/pipeline_full.py:19
PIPELINE_ITERS = 12  # scripts/run_pipeline.py:30
# alignment F1 of the JAX reference for the waveform pipeline: the JAX
# package's steps of scripts/run_pipeline.py (features from its K5,
# extract_pallas in interpret mode), started from the port's initial
# parameters (run_pipeline.init_params on those features, CPU generator
# with seed 0) carried across as numpy arrays, on the CPU:
# tests/pipeline_reference.py --utterances 2000 --iters 12 (P 0.77181,
# R 0.59372)
REFERENCE_PIPELINE_F1 = 0.6711
REFERENCE_PIPELINE_LL = -4057964.25  # its loglik at the 12th iteration
EDGE_WAV_LENS = (0, 399, 400, 401)  # samples: 0, 0, 1 and 1 frames
MFCC_TOL = dict(rtol=1e-3, atol=2e-3)  # K5's bound, tests/test_mfcc_pallas.py:33
# one NVIDIA H100 SXM at its full 700 W (data sheet, dense rates): device
# memory rate, the float32 rate outside the tensor cores, and the bf16
# tensor-core rate.  The bf16 variants' products take bf16 operands and sum
# in float32, which the card runs at the bf16 rate (the kernels here run
# them on float32 FMAs all the same); their xi update's multiply by the
# float32 exp(base0) stays at the float32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# the JAX package's documented F1 of the stretch recipe at N=4000
# (docs/PERFORMANCE.md:457-461); it draws other random numbers, so only
# printed beside this run's value
DOCUMENTED_RECIPE_F1 = 0.431
ZERO_LENGTH_PAD = 4  # zero-length utterances appended in the parity phases
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # bf16 against f32, tests/test_hmm_estep_pallas.py:222
# A bf16 kernel against its plain bf16 version is held to the float32
# kernel's bounds, except K4-bf16's gamma and xi at the stretch shape and
# at MANY_RANDOM's S=2000 (2000-term sums), and K2-bf16's counts and xi at
# the VQ teacher's shape (tests/test_torch_cuda.py holds every S so).  There the products are exact in float32 on both sides, but
# the float32 operands entering each bf16 rounding differ in their last bits (another
# summation order, another exp), so now and then one rounds the other way,
# 2^-8 relative, and shifts that utterance's posteriors.  Those two are held
# to the float32 bounds on all but FLIP_SHARE of their elements (rounded
# up), and every element to 2^-7 of their scale, two such ulps; the
# elements (and utterances) outside the float32 bounds are counted and
# printed.  logZ and the total loglik keep the float32 bounds everywhere.
BF16_FLIP = 2.0**-7
FLIP_SHARE = 1e-3
K6_CHUNKS = (32, 7)  # K6's default chunk and a second one; neither divides Ts=401 or 181
# configs/hmm_crf_frames.py and configs/hmm_crf_e2e.py (on core/config.py's
# base_config: seed 0, max_jump 3), copied here: configs/ imports the JAX
# package.  The corpus as the CLI's _load_data builds it.
CRF_CORPUS = dict(n_utterances=400, n_concepts=40, n_phones=48, min_concepts=2,
                  max_concepts=4, seed=0)
CRF_FRAMES = dict(feat_dim=12, seed=0)
CRF_MODEL = dict(max_jump=3, hidden=256, learning_rate=1e-3, n_sgd=4)
CRF_ITERS, CRF_E2E_ITERS, DNN_ITERS = 10, 20, 10
# alignment F1 and positional accuracy of the JAX reference on the CPU from
# this script's initial parameters (hmm_dnn.init / hmm_crf.init_e2e with a
# CPU generator seeded 0), carried across as numpy arrays with fresh Adam
# states: tests/crf_reference.py
REFERENCE_CRF_F1 = 0.95053  # hmm_crf_frames (P 0.93659, R 0.96489)
REFERENCE_CRF_ACC = 0.96489
REFERENCE_CRF_E2E_F1 = 0.96064  # hmm_crf_e2e (P 0.94561, R 0.97615)
REFERENCE_DNN_F1 = 0.94252  # hmm_dnn on the hmm_crf_frames corpus (P 0.93188, R 0.95341)
# path 8: the reference's dense-caption S=128 row (scripts/bench_kernels.py:
# 261-263, docs/PERFORMANCE.md:115), outside K2's gate
DENSE = dict(n_utterances=512, n_concepts=400, n_phones=48, min_concepts=48,
             max_concepts=64, min_word_len=2, max_word_len=3, seed=2)
# alignment F1 of the JAX reference on the CPU after 10 EM iterations from
# hmm.init (deterministic, so the port starts from the same parameters) on
# the DENSE corpus, its dense scan path, then hmm.align:
# tests/discrete_reference.py (P 0.26373, R 0.27946)
REFERENCE_DENSE_F1 = 0.27137
REFERENCE_DENSE_LL = -287512.34  # its loglik at the 10th iteration
K7_TOL = dict(rtol=1e-5)  # and atol 1e-4 x the largest count: atomics order the sums
# the many-states phase: corpora above the 160 states K4, K6 and K3 once
# took; S~200, and S~260, past K3's 8-bit backpointers
MANY_200 = dict(n_utterances=64, n_concepts=400, min_concepts=96, max_concepts=100,
                min_word_len=2, max_word_len=3, seed=5)
MANY_260 = dict(n_utterances=32, n_concepts=400, min_concepts=126, max_concepts=130,
                min_word_len=2, max_word_len=2, seed=5)
MANY_ITERS = 3
# random factored inputs above every shared-memory plan of K4 (S, N with
# ZERO_LENGTH_PAD of them empty, Ts, seed)
MANY_RANDOM = dict(s=2000, n=12, ts=48, seed=7)
K8_SIZES = (512, 1024)  # scripts/bench_kernels.py:58's sizes where the library form fits
K8_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_log_semiring_pallas.py:18
K8_BF16_VS_F32 = 5e-2  # tests/test_log_semiring_pallas.py:67
# K8-bf16 against its plain bf16 version: the two round exp(A - m_a) and
# exp(B - m_b) to bf16 from float32 values whose last bits differ, so an
# operand may round one bf16 ulp (<= 2^-7 relative) apart on each side of a
# product: about 0.016 in log space
K8_BF16_VS_PLAIN = 2e-2
ASSOC_BLOCK = 16  # forward_blocked's default block
# the exp rate of the special-function units: 16 a clock per SM against the
# 128 fp32 FMAs (CUDA's throughput table for compute capability 9.0), an
# eighth of the FMA rate, FP32_OPS_PER_S / 2 / 8
EXP_PER_S = 67e12 / 2 / 8


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


def _alternate(fns: dict, reps: int, rounds: int) -> dict[str, float]:
    """Median ms of each of two callables over ``rounds`` alternations
    (a, b, b, a) of ``reps`` timed runs each."""
    import numpy as np

    a, b = fns
    ms = {a: [], b: []}
    for which in (a, b, b, a) * rounds:
        ms[which].append(_gpu_ms(fns[which], reps))
    return {k: float(np.median(v)) for k, v in ms.items()} | {"runs": ms}


def _counters():
    """(name, wrapper, attribute) of every kernel's launch count: each
    wrapper adds one to the attribute where it launches that kernel."""
    from multimodalworddiscovery_tpu_torch.ops import counts as k1
    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k24
    from multimodalworddiscovery_tpu_torch.ops import log_semiring as k8
    from multimodalworddiscovery_tpu_torch.ops import mfcc as k5
    from multimodalworddiscovery_tpu_torch.ops import viterbi as k3

    return (("table_lookup", k1.table_lookup, "launches"),
            ("pair_counts", k1.pair_counts, "launches"),
            ("log_matmul", k8.log_matmul, "launches"),
            ("log_matmul_bf16", k8.log_matmul, "launches_bf16"),
            ("hmm_estep_counts", k24.hmm_estep_counts, "launches"),
            ("hmm_estep_counts_bf16", k24.hmm_estep_counts, "launches_bf16"),
            ("hmm_estep", k24.hmm_estep, "launches"),
            ("hmm_estep_bf16", k24.hmm_estep, "launches_bf16"),
            ("hmm_estep_remat", k24.hmm_estep, "launches_remat"),
            ("viterbi", k3.viterbi, "launches"),
            ("extract", k5.extract, "launches"),
            ("mfcc_from_frames", k5.mfcc_from_frames, "launches"))


def _reset(counters) -> None:
    for _, w, attr in counters:
        setattr(w, attr, 0)


def _counts(counters) -> dict[str, int]:
    return {name: getattr(w, attr) for name, w, attr in counters}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, ops: float, bf16_ops: float = 0.0) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations (float32 ``ops`` over the float32 rate plus ``bf16_ops``,
    products of bf16 operands summed in float32, over the bf16 tensor-core
    rate), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / FP32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _recursion_ops(src_len, s: int, per_step: int) -> float:
    """Operations of an HMM recursion over this batch's valid time steps:
    ``per_step`` x S^2 per utterance-step (the E-step's forward product,
    backward product and xi accumulation are 2 + 2 + 3; Viterbi's add and
    max are 2)."""
    return float(per_step * s * s * int(src_len.sum()))


def _estep_bound(nbytes: float, src_len, s: int, bf16: bool) -> dict:
    """The E-step's bound: 7 S^2 float32 operations per valid
    utterance-step; in bf16 the 6 of them in the three products (2 + 2 + 2:
    forward, backward, xi's outer product) take bf16 operands and only xi's
    multiply by the float32 exp(base0) stays float32."""
    if not bf16:
        return _bound(nbytes, _recursion_ops(src_len, s, 7))
    return _bound(nbytes, _recursion_ops(src_len, s, 1), _recursion_ops(src_len, s, 6))


def _mfcc_ops(cfg, kind: str, n_frames: int, n_samples: int) -> float:
    """Operations the MFCC function needs, with its DFT counted as a real
    FFT (2.5 n log2(n) / 2 for n = n_fft; K5's direct DFT does about 20x
    more): pre-emphasis (2 a sample), the window (1 a frame sample), the
    FFT, power (3 a bin), the mel sums over each filter's nonzero bins (2 a
    weight), the log, and the DCT."""
    from multimodalworddiscovery_tpu_torch.frontend import speech

    n_bins = cfg.n_fft // 2 + 1
    fft = 2.5 * cfg.n_fft * math.log2(cfg.n_fft) / 2
    weights = int((speech.mel_filterbank(cfg) != 0).sum())
    dct = 2 * cfg.n_mels * cfg.n_mfcc if kind == "mfcc" else 0
    per_frame = cfg.win_length + fft + 3 * n_bins + 2 * weights + cfg.n_mels + dct
    return float(per_frame * n_frames + 2 * n_samples)


def _estep_inputs(params, corpus):
    """(state concepts, (log_init, base, rowz, colmask)) for the E-step."""
    from multimodalworddiscovery_tpu_torch.models import hmm_core

    concepts = hmm_core.state_concepts(corpus)
    base, rowz, colmask = hmm_core.factor_log_trans(
        params.log_jump, params.log_p0, corpus, params.max_jump
    )
    log_init = hmm_core.build_log_init(params.log_p0, corpus)
    return concepts, (log_init, base, rowz, colmask)


def _posterior_check(what, name, got, want, bounds: dict, flips: bool = False) -> None:
    """``got`` within ``bounds`` (allclose's rtol and atol) of ``want``; with
    ``flips`` (see BF16_FLIP) only all but FLIP_SHARE of its elements, and
    all within BF16_FLIP x its scale, printing how many elements, and of
    gamma [N, Ts, S] how many utterances, lie outside ``bounds``."""
    import torch

    close = torch.isclose(got, want, **bounds)
    tol = f"rtol {bounds['rtol']:g} atol {bounds['atol']:g}"
    if not flips:
        _check(bool(close.all()), f"{what} {name} {tol}")
        return
    out = ~close
    n_out, allowed = int(out.sum()), math.ceil(FLIP_SHARE * out.numel())
    where = (f" in {int(out.flatten(1).any(dim=1).sum())} of {got.shape[0]} utterances"
             if got.dim() == 3 else "")
    _check(n_out <= allowed, f"{what} {name}: {n_out} of {out.numel()} elements{where} "
                             f"outside the float32 kernel's bounds ({tol}), at most {allowed}")
    scale = max(float(want.abs().max()), 1.0)
    _check(_max_abs(got, want) <= BF16_FLIP * scale, f"{what} {name} atol 2^-7 x {scale}")


def _rounding_check(what, pairs) -> None:
    """A bf16 kernel rounds: each (name, kernel output, its plain bf16
    version, the float32 kernel's output) differs from float32 and lies
    closer to the plain bf16 version than to float32."""
    import torch

    for name, got, plain_bf16, f32 in pairs:
        d_plain, d_f32 = _max_abs(got, plain_bf16), _max_abs(got, f32)
        _check(not torch.equal(got, f32) and d_plain < d_f32,
               f"{what} {name} rounds in bf16: max abs err {d_plain} against its plain bf16 "
               f"version, {d_f32} against the float32 kernel")


def _exact_counts(args, dot_dtype: str = "float32"):
    """The counts of ``hmm_estep_counts_plain(*args)`` with its posteriors
    summed in float64: its float32 scatter adds up to ~1e5 posteriors into
    one entry in arbitrary order, and the smallest fall below half an ulp
    of sums near 1e3 and are lost."""
    from multimodalworddiscovery_tpu_torch.core.counts import pair_counts
    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k2

    gamma = k2.hmm_estep_plain(*args[:5], args[7], dot_dtype)[0]
    return pair_counts(gamma.double(), args[5], args[6], args[8], args[9])


def _k2_checks(what, out, want, n_pad: int, flips: bool = False, exact=None) -> dict:
    """K2's checks of one kernel run ``out`` against its plain version's
    ``want``, both (counts, xi, logz): the max abs errors; with ``flips``
    the counts and xi as BF16_FLIP says; with ``exact`` (``_exact_counts``)
    the counts against that, the plain version's float32 counts' own error
    printed beside them."""
    import torch

    counts, xi, logz = out
    counts_p, xi_p, logz_p = want
    errs = {"logz": _max_abs(logz, logz_p), "counts": _max_abs(counts, counts_p),
            "xi": _max_abs(xi, xi_p)}
    print(f"  {what} max abs err vs plain: {errs}")
    if exact is not None:
        print(f"  {what} counts: max abs err {_max_abs(counts, exact)} against the plain "
              f"posteriors summed in float64, the plain version's own {_max_abs(counts_p, exact)}")
        counts_p = exact.float()
    _check(torch.allclose(logz, logz_p, rtol=1e-4, atol=1e-4), f"{what} logZ rtol 1e-4 atol 1e-4")
    _check(bool((logz[-n_pad:] == 0).all()), f"{what} logZ = 0 on zero-length utterances")
    ll, ll_p = float(logz.sum()), float(logz_p.sum())
    _check(abs(ll - ll_p) <= 1e-6 * abs(ll_p),
           f"{what} total loglik rtol 1e-6 ({ll} vs {ll_p})")
    scale = max(float(counts_p.max()), 1.0)
    _posterior_check(what, "emission counts", counts, counts_p,
                     dict(rtol=0.0, atol=1e-4 * scale), flips)
    _posterior_check(what, "xi", xi, xi_p, dict(rtol=1e-4, atol=1e-3), flips)
    return errs


def parity(name, corpus, max_jump: int = 3, reps: int = 10, bf16_flips: bool = False) -> dict:
    """K1, K2 and K2-bf16 against their plain versions on the card at the
    shape of the discrete ``corpus`` (on the card), with ZERO_LENGTH_PAD
    empty utterances appended (K2-bf16 with K2's bounds, its counts and xi
    as BF16_FLIP says with ``bf16_flips``, and against K2); then K2 and
    K2-bf16 timed with their plain versions and their bounds (``reps``
    kernel runs, a tenth as many plain ones)."""
    import torch

    from multimodalworddiscovery_tpu_torch.core.counts import pair_counts
    from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core
    from multimodalworddiscovery_tpu_torch.ops import counts as k1
    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k2

    corpus = corpus.pad_to(corpus.n + ZERO_LENGTH_PAD)
    params = hmm.init(corpus, max_jump=max_jump)
    params, _ = hmm.em_step(params, corpus, use_kernels=False)  # non-uniform parameters
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
    errs = _k2_checks("K2", (counts, xi, logz), k2.hmm_estep_counts_plain(*args),
                      ZERO_LENGTH_PAD, exact=_exact_counts(args))
    got = k2.hmm_estep_counts(*args, dot_dtype="bfloat16")
    want = k2.hmm_estep_counts_plain(*args, dot_dtype="bfloat16")
    errs_bf = _k2_checks("K2-bf16", got, want, ZERO_LENGTH_PAD, flips=bf16_flips,
                         exact=_exact_counts(args, "bfloat16"))
    _rounding_check("K2-bf16", (("logZ", got[2], want[2], logz),
                                ("emission counts", got[0], want[0], counts)))
    scale = max(float(counts.max()), 1.0)
    print(f"  K2-bf16 against K2: max abs err logZ {_max_abs(got[2], logz)}, counts "
          f"{_max_abs(got[0], counts)} (scale {scale})")
    _check(torch.allclose(got[2], logz, **BF16_TOL), "K2-bf16 logZ within rtol 2e-2 "
                                                     "atol 2e-2 of K2")
    _check(torch.allclose(got[0], counts, rtol=2e-2, atol=2e-2 * scale),
           "K2-bf16 counts within rtol 2e-2, atol 2e-2 x scale of K2's")
    del got, want
    nbytes = _nbytes(*args[:8], counts, xi, logz)
    plain_reps = max(reps // 10, 1)
    out = {"k1_err": k1_err, "k2_err": errs["logz"], "k2bf_err": errs_bf["logz"],
           "k2": {"ms": _gpu_ms(lambda: k2.hmm_estep_counts(*args), reps),
                  "plain_ms": _gpu_ms(lambda: k2.hmm_estep_counts_plain(*args), plain_reps),
                  **_estep_bound(nbytes, corpus.src_len, s, bf16=False)},
           "k2bf": {"ms": _gpu_ms(lambda: k2.hmm_estep_counts(*args, dot_dtype="bfloat16"), reps),
                    "plain_ms": _gpu_ms(lambda: k2.hmm_estep_counts_plain(
                        *args, dot_dtype="bfloat16"), plain_reps),
                    **_estep_bound(nbytes, corpus.src_len, s, bf16=True)}}
    for what, r in (("K2", out["k2"]), ("K2-bf16", out["k2bf"])):
        print(f"  {what} at {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    # and against the dense plain E-step (the use_kernels=False route)
    gamma, wc_d, logz_d = hmm_core.estep(
        params.log_jump, params.log_p0, params.max_jump,
        hmm._log_emissions(params, corpus, concepts), corpus, use_kernels=False,
    )
    counts_d = pair_counts(gamma, corpus.src, concepts, v_src, v_trg)
    wc = hmm_core.project_widths(xi, corpus.max_trg_len, params.max_jump)
    _check(torch.allclose(logz, logz_d, rtol=1e-4, atol=1e-4), "K2 logZ vs dense fwd-bwd")
    scale = max(float(counts_d.max()), 1.0)
    _check(_max_abs(counts, counts_d) <= 1e-4 * scale, "K2 counts vs dense fwd-bwd")
    _check(torch.allclose(wc, wc_d, rtol=1e-4, atol=1e-3), "K2 width counts vs dense fwd-bwd")
    return out


def _k4_checks(what, out, want, n_pad: int, flips: bool = False) -> dict:
    """K4's checks (tolerances of tests/test_hmm_estep_pallas.py:74-80) of
    one kernel run ``out`` against ``want``, both (gamma, xi, logz); with
    ``flips`` gamma and xi as BF16_FLIP says."""
    import torch

    gamma, xi, logz = out
    gamma_p, xi_p, logz_p = want
    errs = {"logz": _max_abs(logz, logz_p), "gamma": _max_abs(gamma, gamma_p),
            "xi": _max_abs(xi, xi_p)}
    print(f"  {what} max abs err vs plain: {errs}")
    _check(torch.allclose(logz, logz_p, rtol=1e-4, atol=1e-4), f"{what} logZ rtol 1e-4 atol 1e-4")
    if n_pad:
        _check(bool((logz[-n_pad:] == 0).all() and (gamma[-n_pad:] == 0).all()),
               f"{what} logZ = 0 and gamma = 0 on zero-length utterances")
    ll, ll_p = float(logz.sum()), float(logz_p.sum())
    _check(abs(ll - ll_p) <= 1e-6 * abs(ll_p), f"{what} total loglik rtol 1e-6 ({ll} vs {ll_p})")
    _posterior_check(what, "gamma", gamma, gamma_p, dict(rtol=1e-3, atol=1e-4), flips)
    _posterior_check(what, "xi", xi, xi_p, dict(rtol=1e-3, atol=1e-3), flips)
    return errs


def k4_parity(name, inputs, reps: int, bf16_flips: bool = False) -> dict:
    """K4, K4-bf16 and K6 against their plain versions on the card (K4-bf16's
    gamma and xi as BF16_FLIP says with ``bf16_flips``), K4-bf16 against K4
    (rtol 2e-2 atol 2e-2) and K6 against K4 at K6_CHUNKS (the reference's
    remat bounds, tests/test_hmm_estep_pallas.py:241-261), and each timed
    with its plain version.  ``inputs`` = (log_init, base, rowz, colmask,
    log_emit, src_len) with ZERO_LENGTH_PAD empty utterances last."""
    import torch

    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k4

    n, ts, s = inputs[4].shape
    print(f"K4 parity at {name}: N={n} (incl. {ZERO_LENGTH_PAD} empty), Ts={ts}, S={s}")
    out = k4.hmm_estep(*inputs)
    errs = _k4_checks("K4", out, k4.hmm_estep_plain(*inputs), ZERO_LENGTH_PAD)
    gamma, xi, logz = out
    nbytes = _nbytes(*inputs, gamma, xi, logz)
    bound = _estep_bound(nbytes, inputs[5], s, bf16=False)
    bound_bf = _estep_bound(nbytes, inputs[5], s, bf16=True)

    bf = k4.hmm_estep(*inputs, dot_dtype="bfloat16")
    want = k4.hmm_estep_plain(*inputs, dot_dtype="bfloat16")
    errs_bf = _k4_checks("K4-bf16", bf, want, ZERO_LENGTH_PAD, flips=bf16_flips)
    _rounding_check("K4-bf16", (("logZ", bf[2], want[2], logz),
                                ("gamma", bf[0], want[0], gamma)))
    del want
    print(f"  K4-bf16 against K4: max abs err logZ {_max_abs(bf[2], logz)}, gamma "
          f"{_max_abs(bf[0], gamma)}")
    _check(torch.allclose(bf[2], logz, **BF16_TOL)
           and torch.allclose(bf[0], gamma, **BF16_TOL),
           "K4-bf16 logZ and gamma within rtol 2e-2 atol 2e-2 of K4's")
    del bf

    errs_k6, same = {}, []
    for tc in K6_CHUNKS:
        k6 = k4.hmm_estep(*inputs, remat=True, chunk_t=tc)
        e = _k4_checks(f"K6 (chunk {tc})", k6,
                       k4.hmm_estep_remat_plain(*inputs, chunk_t=tc), ZERO_LENGTH_PAD)
        errs_k6 = {k: max(v, errs_k6.get(k, 0.0)) for k, v in e.items()}
        g6, xi6, z6 = k6
        bits = (torch.equal(z6, logz), torch.equal(g6, gamma))
        same.append(bits)
        print(f"  K6 (chunk {tc}) against K4: max abs err logZ {_max_abs(z6, logz)}, gamma "
              f"{_max_abs(g6, gamma)}, xi {_max_abs(xi6, xi)}; logZ bit-identical {bits[0]}, "
              f"gamma bit-identical {bits[1]}")
        _check(torch.allclose(z6, logz, rtol=1e-5, atol=0)
               and torch.allclose(g6, gamma, rtol=1e-4, atol=1e-5)
               and torch.allclose(xi6, xi, rtol=1e-4, atol=1e-4),
               f"K6 (chunk {tc}) against K4: logZ rtol 1e-5, gamma rtol 1e-4 atol 1e-5, "
               f"xi rtol 1e-4 atol 1e-4")
        del k6, g6
    g6bf = k4.hmm_estep(*inputs, dot_dtype="bfloat16", remat=True, chunk_t=K6_CHUNKS[1])
    g4bf = k4.hmm_estep(*inputs, dot_dtype="bfloat16")
    _check(torch.allclose(g6bf[2], g4bf[2], rtol=1e-5, atol=0)
           and torch.allclose(g6bf[0], g4bf[0], rtol=1e-4, atol=1e-5),
           f"K6 in bf16 (chunk {K6_CHUNKS[1]}) against K4-bf16: logZ rtol 1e-5, gamma rtol "
           f"1e-4 atol 1e-5")
    del gamma, out, g6bf, g4bf
    times = {
        "ms": _gpu_ms(lambda: k4.hmm_estep(*inputs), reps),
        "plain_ms": _gpu_ms(lambda: k4.hmm_estep_plain(*inputs), max(reps // 10, 1)),
        "bf16_ms": _gpu_ms(lambda: k4.hmm_estep(*inputs, dot_dtype="bfloat16"), reps),
        "bf16_plain_ms": _gpu_ms(lambda: k4.hmm_estep_plain(*inputs, dot_dtype="bfloat16"),
                                 max(reps // 10, 1)),
        "k6_ms": _gpu_ms(lambda: k4.hmm_estep(*inputs, remat=True), reps),
        "k6_plain_ms": _gpu_ms(lambda: k4.hmm_estep_remat_plain(*inputs),
                               max(reps // 10, 1)),
    }
    return {"err": max(errs.values()), "bf16_err": max(errs_bf.values()),
            "k6_err": max(errs_k6.values()), "k6_bit_identical": same,
            "bf16_bound": bound_bf} | times | bound


def k3_parity(name, inputs, reps: int) -> dict:
    """K3 against the plain decoder on the card, and both timed: paths agree
    on >= 0.99 of valid frames and scores to rtol 1e-5 atol 1e-3
    (tests/test_viterbi_pallas.py:61-65)."""
    import torch

    from multimodalworddiscovery_tpu_torch.ops import viterbi as k3

    n, ts, s = inputs[4].shape
    print(f"K3 parity at {name}: N={n}, Ts={ts}, S={s}")
    path = k3.viterbi(*inputs)
    path_p = k3.viterbi_plain(*inputs)
    torch.cuda.synchronize()
    src_len = inputs[5]
    valid = torch.arange(ts, device=path.device)[None, :] < src_len[:, None]
    agree = float((path == path_p)[valid].float().mean())
    score, score_p = k3.path_score(path, *inputs), k3.path_score(path_p, *inputs)
    err = _max_abs(score, score_p)
    print(f"  K3 path agreement {agree:.6f}, max abs path-score err {err}")
    _check(agree >= 0.99, "K3 paths agree with the plain decoder on >= 0.99 of valid frames")
    _check(torch.allclose(score, score_p, rtol=1e-5, atol=1e-3), "K3 path scores rtol 1e-5 atol 1e-3")
    ms = _gpu_ms(lambda: k3.viterbi(*inputs), reps)
    plain_ms = _gpu_ms(lambda: k3.viterbi_plain(*inputs), max(reps // 10, 1))
    return ({"err": err, "ms": ms, "plain_ms": plain_ms}
            | _bound(_nbytes(*inputs, path), _recursion_ops(src_len, s, 2)))


def teacher_phase(fc, card: str) -> dict:
    """K1 and K2 at the VQ teacher's shape: the stretch recipe's code corpus,
    built as ``init_vq_teacher`` builds it (the same generator, drawn in the
    same order).  Then the teacher's EM trajectory, the one the recipe runs,
    through the kernels and through the plain path."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core, hmm_gaussian
    from multimodalworddiscovery_tpu_torch.ops import counts as k1

    gen = torch.Generator().manual_seed(SEED)
    hmm_gaussian.init(fc, max_jump=MAX_JUMP, n_components=2, generator=gen)  # the jitter
    codes = hmm_gaussian.quantize_frames(fc, n_codes=N_CODES, generator=gen)
    errs = parity("VQ teacher shape", codes, max_jump=MAX_JUMP, reps=5, bf16_flips=True)

    p0 = hmm.init(codes, max_jump=MAX_JUMP)
    lw = hmm.train(p0, codes, EM_ITERS, use_kernels=True)[1].cpu().numpy()
    lp = hmm.train(p0, codes, EM_ITERS, use_kernels=False)[1].cpu().numpy()
    rel = np.abs(lw - lp) / np.abs(lp)
    print(f"  teacher EM, kernel-path loglik per iteration: {lw.tolist()}")
    print(f"  teacher EM, plain-path loglik per iteration:  {lp.tolist()}")
    print(f"  teacher EM, relative loglik difference per iteration: {rel.tolist()}")
    _check(bool(np.all(np.isfinite(lw))), "teacher loglik finite")
    _check(bool(np.all(np.diff(lw) > -1e-3 * np.abs(lw[:-1]))) and lw[-1] > lw[0],
           "teacher loglik monotone within bench.py's bound and improving")
    _check(rel[-1] <= 1e-4, f"teacher final loglik within rtol 1e-4 of plain "
                            f"({lw[-1]} vs {lp[-1]}, rel {rel[-1]:.3e})")

    concepts = hmm_core.state_concepts(codes)
    times = {
        "k1_ms": _gpu_ms(lambda: k1.table_lookup(p0.log_emit, codes.src, concepts), 20),
        "k1_plain_ms": _gpu_ms(lambda: k1.table_lookup_plain(p0.log_emit, codes.src,
                                                             concepts), 20),
    }
    print(f"  [{card}] at the VQ teacher's shape: K1 table_lookup kernel "
          f"{times['k1_ms']:.4f} ms, plain {times['k1_plain_ms']:.4f} ms; K2 hmm_estep_counts "
          f"kernel {errs['k2']['ms']:.4f} ms, plain {errs['k2']['plain_ms']:.4f} ms")
    _profile(lambda: hmm.em_step(p0, codes), "one VQ-teacher EM iteration (K1, K2, M-step)", card)
    return errs | times


def _as_float64(params):
    """Gaussian HMM parameters with every float tensor in float64."""
    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name).double()
        for f in dataclasses.fields(params) if f.name != "max_jump"})


def headline_path(corpus, gold, use_kernels: bool, dot_dtype: str = "float32"):
    import torch

    from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf
    from multimodalworddiscovery_tpu_torch.models import hmm
    from multimodalworddiscovery_tpu_torch.segment import segment_corpus

    params = hmm.init(corpus)
    params, lls = hmm.train(params, corpus, EM_ITERS, use_kernels=use_kernels,
                            dot_dtype=dot_dtype)
    alignment = hmm.align(params, corpus, use_kernels=use_kernels)
    segs, seg_mask = segment_corpus(alignment, corpus)
    gold_t = torch.as_tensor(gold.alignment, device=corpus.device)
    prf = alignment_prf(alignment, gold_t, corpus.src_mask())
    torch.cuda.synchronize()
    return {
        "params": params, "lls": lls.cpu().numpy(), "alignment": alignment,
        "segs": segs, "seg_mask": seg_mask,
        "prf": {k: float(v) for k, v in prf.items()},
    }


def gaussian_path(corpus, gold, params, use_kernels: bool):
    """Annealed Gaussian EM from ``params``, decode, segmentation, alignment
    and boundary P/R/F1."""
    import torch

    from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf, boundary_prf
    from multimodalworddiscovery_tpu_torch.models import hmm_gaussian
    from multimodalworddiscovery_tpu_torch.segment import (
        boundaries_from_segments,
        segments_from_alignment,
    )

    params, lls = hmm_gaussian.train(params, corpus, EM_ITERS, use_kernels=use_kernels,
                                     anneal=ANNEAL)
    alignment = hmm_gaussian.align(params, corpus, use_kernels=use_kernels)
    gold_t = torch.as_tensor(gold.alignment, device=corpus.device)
    ps, pm = segments_from_alignment(alignment, corpus.trg, corpus.src_len)
    gs, gm = segments_from_alignment(gold_t, corpus.trg, corpus.src_len)
    bf = boundary_prf(boundaries_from_segments(ps, pm, corpus.max_src_len),
                      boundaries_from_segments(gs, gm, corpus.max_src_len), tolerance=1)
    prf = alignment_prf(alignment, gold_t, corpus.src_mask())
    torch.cuda.synchronize()
    return {
        "params": params, "lls": lls.cpu().numpy(), "alignment": alignment,
        "prf": {k: float(v) for k, v in prf.items()},
        "boundary": {k: float(v) for k, v in bf.items()},
    }


def crf_run(name: str, fc, fg, params, iters: int, use_kernels: bool,
            dot_dtype: str = "float32") -> dict:
    """Train ``params`` on the frame corpus ``fc`` with the aligner of
    ``name`` (hmm_crf_frames, hmm_crf_e2e or hmm_dnn), decode through K3
    (plain decoder with ``use_kernels=False``), and score; ms per iteration
    by CUDA events around the training loop."""
    import torch

    from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf
    from multimodalworddiscovery_tpu_torch.models import hmm_crf, hmm_dnn

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    if name == "hmm_dnn":
        params, lls = hmm_dnn.train(params, fc, iters, use_kernels=use_kernels,
                                    dot_dtype=dot_dtype)
    else:
        params, lls = hmm_crf.train(params, fc, iters, use_kernels=use_kernels,
                                    dot_dtype=dot_dtype,
                                    learn_transitions=name == "hmm_crf_e2e")
    end.record()
    alignment = hmm_crf.align(params, fc, use_kernels=use_kernels)
    gold_t = torch.as_tensor(fg.alignment, device=fc.device)
    prf = alignment_prf(alignment, gold_t, fc.src_mask())
    mask = fc.src_mask() & (gold_t > 0)
    acc = float((alignment == gold_t)[mask].float().mean())
    torch.cuda.synchronize()
    return {"lls": lls.cpu().numpy(), "prf": {k: float(v) for k, v in prf.items()},
            "acc": acc, "ms_per_iter": start.elapsed_time(end) / iters,
            "alignment": alignment}


def _crf_grads(params, fc, use_kernels: bool):
    """The MLP's gradient of the CRF's first Adam step: -logZ / frames
    through ``logmarginal``."""
    import torch

    from multimodalworddiscovery_tpu_torch.models import hmm_crf

    n_frames = torch.clamp(fc.src_mask().sum(), min=1).to(torch.float32)
    log_emit = hmm_crf._log_emit_from_mlp(params.mlp, fc)
    loss = -hmm_crf.logmarginal(params.max_jump, use_kernels, "float32", params.log_jump,
                                params.log_p0, log_emit, fc) / n_frames
    return torch.autograd.grad(loss, list(params.mlp.parameters()))


def crf_phase(card: str, counters, dev) -> dict:
    """Paths 6 and 7 and hmm_dnn on configs/hmm_crf_frames.py's corpus: the
    counted launches of each kernel run, and ms per iteration."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
    from multimodalworddiscovery_tpu_torch.models import hmm_crf, hmm_dnn

    pc, pg, _ = make_flickr8k_mini(**CRF_CORPUS, device=dev)
    fc, fg, _ = phones_to_frames(pc, pg, **CRF_FRAMES, device=dev)
    print(f"CRF corpus (configs/hmm_crf_frames.py): N={fc.n}, Ts={fc.max_src_len}, "
          f"S={2 * fc.max_trg_len}, C={fc.trg_vocab}, D={fc.src.shape[-1]}; model {CRF_MODEL}")

    def initial(e2e: bool = False):
        init = hmm_crf.init_e2e if e2e else hmm_dnn.init
        return init(fc, **CRF_MODEL, generator=torch.Generator().manual_seed(SEED))

    # the first Adam step's MLP gradient through K4 and through the plain path
    p0 = initial()
    g_k, g_p = _crf_grads(p0, fc, True), _crf_grads(p0, fc, False)
    rel = max(_max_abs(a, b) / float(b.abs().max()) for a, b in zip(g_k, g_p))
    print(f"  first Adam step's MLP gradient, K4 against plain: max abs err / max |grad| "
          f"per tensor, largest {rel:.3e}")
    _check(all(torch.allclose(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
               for a, b in zip(g_k, g_p)),
           "first Adam step's MLP gradients through K4 within rtol 1e-4 (atol 1e-4 x the "
           "tensor's largest entry) of the plain path's")

    runs, launches = {}, {}
    for key, name, iters, use_kernels, dot_dtype in (
            ("crf K4", "hmm_crf_frames", CRF_ITERS, True, "float32"),
            ("crf plain", "hmm_crf_frames", CRF_ITERS, False, "float32"),
            ("crf K4-bf16", "hmm_crf_frames", CRF_ITERS, True, "bfloat16"),
            ("dnn K4", "hmm_dnn", DNN_ITERS, True, "float32"),
            ("e2e K4", "hmm_crf_e2e", CRF_E2E_ITERS, True, "float32")):
        _reset(counters)
        r = crf_run(name, fc, fg, initial(name == "hmm_crf_e2e"), iters, use_kernels, dot_dtype)
        launches[key] = _counts(counters)
        runs[key] = r
        print(f"  {key} ({name}, {iters} iterations): loglik {r['lls'].tolist()}")
        print(f"    alignment {r['prf']}, positional accuracy {r['acc']:.5f}, launches "
              f"{launches[key]}")
        print(f"    [{card}] {key}: {r['ms_per_iter']:.4f} ms per iteration (CUDA events)")
        _check(bool(np.all(np.isfinite(r["lls"]))), f"{key} loglik finite")
    n_sgd = CRF_MODEL["n_sgd"]
    _check(launches["crf K4"]["hmm_estep"] == (n_sgd + 1) * CRF_ITERS
           and launches["crf K4"]["viterbi"] == 1,
           f"path 6: K4 launched {n_sgd + 1} times an iteration and K3 once")
    _check(not any(launches["crf plain"].values()), "no kernel launched on the plain path")
    _check(launches["crf K4-bf16"]["hmm_estep_bf16"] == (n_sgd + 1) * CRF_ITERS
           and launches["crf K4-bf16"]["hmm_estep"] == 0,
           f"path 6 in bf16: K4-bf16 launched {n_sgd + 1} times an iteration, K4 never")
    _check(launches["dnn K4"]["hmm_estep"] == DNN_ITERS, "hmm_dnn: K4 once an iteration")
    _check(launches["e2e K4"]["hmm_estep"] == (n_sgd + 1) * CRF_E2E_ITERS,
           f"path 7: K4 launched {n_sgd + 1} times an iteration")
    f1 = {k: r["prf"]["f1"] for k, r in runs.items()}
    _check(abs(f1["crf K4"] - REFERENCE_CRF_F1) <= 0.01,
           f"path 6 F1 within 0.01 of the JAX reference {REFERENCE_CRF_F1} ({f1['crf K4']:.5f})")
    _check(abs(f1["crf K4"] - f1["crf plain"]) <= 0.01,
           f"path 6 F1 within 0.01 of the plain path ({f1['crf K4']:.5f} vs "
           f"{f1['crf plain']:.5f})")
    _check(runs["crf K4"]["acc"] >= 0.90,
           f"path 6 positional accuracy >= 0.90 ({runs['crf K4']['acc']:.5f}; JAX reference "
           f"{REFERENCE_CRF_ACC})")
    _check(abs(f1["crf K4-bf16"] - f1["crf K4"]) <= 0.01,
           f"path 6 in bf16: F1 within 0.01 of float32 ({f1['crf K4-bf16']:.5f} vs "
           f"{f1['crf K4']:.5f})")
    _check(abs(f1["dnn K4"] - REFERENCE_DNN_F1) <= 0.01,
           f"hmm_dnn F1 within 0.01 of the JAX reference {REFERENCE_DNN_F1} "
           f"({f1['dnn K4']:.5f})")
    _check(abs(f1["e2e K4"] - REFERENCE_CRF_E2E_F1) <= 0.01,
           f"path 7 F1 within 0.01 of the JAX reference {REFERENCE_CRF_E2E_F1} "
           f"({f1['e2e K4']:.5f})")
    lls = runs["e2e K4"]["lls"]
    _check(lls[-1] > lls[0], f"path 7 loglik rises from the first iteration to the last "
                             f"({lls[0]} -> {lls[-1]})")
    p_fit = initial()
    _profile(lambda: hmm_crf.em_step(p_fit, fc), "one CRF iteration (hmm_crf_frames, "
                                                 "4 Adam steps through K4, then the M-step)",
             card)
    return {"launches": launches, "ms": {k: r["ms_per_iter"] for k, r in runs.items()}}


def _profile(fn, what: str, card: str) -> None:
    """Device time by kernel family and device idle share of ``fn()``
    (torch.profiler), after one run outside the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"K1 lookup": ("mwd_table_lookup",), "K7 pair counts": ("mwd_pair_counts",),
                "K8 log_matmul": ("mwd_log_matmul",),
                "K5 mfcc": ("mwd_mfcc",), "K2 forward": ("mwd_estep_counts_fwd",),
                "K2 backward with counts": ("mwd_estep_counts_bwd",),
                "K2 table and xi sum": ("mwd_estep_counts_prep", "mwd_estep_counts_xi"),
                "K4 forward": ("mwd_estep_fwd",), "K4 backward": ("mwd_estep_bwd",),
                "K4 table and xi sum": ("mwd_estep_prep", "mwd_estep_xi"),
                "length order rank (K2, K3, K4)": ("mwd_length_rank",),
                "K3 viterbi (and its order)": ("mwd_viterbi",),
                "fft": ("fft",), "matmul": ("gemm", "cutlass", "xmma"),
                "softmax": ("softmax",), "reductions": ("reduce",),
                "elementwise": ("elementwise", "vectorized")}
    sums = {k: 0.0 for k in (*families, "other")}
    busy, kernels = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        busy += ms
        kernels += e.count
        key = e.key.lower()
        fam = next((f for f, tags in families.items() if any(t in key for t in tags)), "other")
        sums[fam] += ms
    if busy == 0.0:
        print(f"  [{card}] profile of {what}: no device time in the trace (not measured)")
        return
    print(f"  [{card}] profile of {what} (kernel path, profiler on): "
          f"wall {wall_ms:.4f} ms, device busy {busy:.4f} ms in {kernels} kernels, "
          f"idle share {1 - busy / wall_ms:.4f}")
    for fam, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        if ms > 0:
            print(f"    {fam}: {ms:.4f} ms ({ms / busy:.4f} of busy)")
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"    top kernel: {e.self_device_time_total / 1e3:.4f} ms x{e.count} {e.key[:90]}")


def k5_phase(card: str, synth) -> dict:
    """K5 against its plain version on the card at the pipeline's batch
    (``synth``, from ``run_pipeline.synthesize``, with the edge waveforms
    appended), for MFCCs and log-mels, and on 1000 frames (not a multiple
    of the kernel's 64-frame tile); then both timed at the pipeline's batch,
    and the bound of that call."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.frontend import speech
    from multimodalworddiscovery_tpu_torch.ops import mfcc as k5
    from multimodalworddiscovery_tpu_torch.scripts import run_pipeline as rp

    dev = torch.device("cuda", 0)
    cfg = rp.MFCC
    _, _, wavs, lens = synth
    rng = np.random.default_rng(SEED)
    extra = np.zeros((len(EDGE_WAV_LENS), wavs.shape[1]), np.float32)
    for i, n in enumerate(EDGE_WAV_LENS):
        extra[i, :n] = 0.3 * rng.standard_normal(n)
    wav = torch.as_tensor(np.concatenate([wavs, extra]), device=dev)
    wav_len = torch.as_tensor(np.concatenate([lens, np.asarray(EDGE_WAV_LENS, np.int32)]),
                              device=dev)
    print(f"K5 parity at the pipeline's batch: N={PIPELINE_N} + {len(EDGE_WAV_LENS)} "
          f"waveforms of {EDGE_WAV_LENS} samples, L={wav.shape[1]}, "
          f"F={speech.num_frames(wav.shape[1], cfg)}")
    errs = {}
    for kind in speech.KINDS:
        got, fl = k5.extract(wav, wav_len, cfg, kind)
        want, fl_p = k5.extract_plain(wav, wav_len, cfg, kind)
        torch.cuda.synchronize()
        _check(torch.equal(fl, fl_p) and fl[-len(EDGE_WAV_LENS):].tolist() == [0, 0, 1, 1],
               f"K5 {kind}: frame lengths equal to the plain version's, 0 0 1 1 at the edges")
        valid = torch.arange(got.shape[1], device=dev)[None, :] < fl[:, None]
        errs[kind] = _max_abs(got[valid], want[valid])
        _check(torch.allclose(got[valid], want[valid], **MFCC_TOL),
               f"K5 {kind} {tuple(got.shape)}: valid frames within rtol 1e-3 atol 2e-3 of "
               f"plain (max abs err {errs[kind]})")
        del got, want
    pre = speech.preemphasize(wav[:6], cfg.preemphasis)
    frames = speech.frame_signal(pre, cfg).reshape(-1, cfg.win_length)[:1000].contiguous()
    for kind in speech.KINDS:
        got = k5.mfcc_from_frames(frames, cfg, kind)
        want = k5.mfcc_from_frames_plain(frames, cfg, kind)
        err = _max_abs(got, want)
        errs[f"frames {kind}"] = err
        _check(torch.allclose(got, want, **MFCC_TOL),
               f"K5 mfcc_from_frames {kind} at M=1000: within rtol 1e-3 atol 2e-3 of plain "
               f"(max abs err {err})")

    wav, wav_len = wav[:PIPELINE_N], wav_len[:PIPELINE_N]
    feats, fl = k5.extract(wav, wav_len, cfg)
    r = {"err": max(errs.values()),
         "ms": _gpu_ms(lambda: k5.extract(wav, wav_len, cfg), 10),
         "plain_ms": _gpu_ms(lambda: k5.extract_plain(wav, wav_len, cfg), 3)}
    r |= _bound(_nbytes(wav, wav_len, feats, fl),
                _mfcc_ops(cfg, "mfcc", feats.shape[0] * feats.shape[1], wav.numel()))
    m = feats.shape[0] * feats.shape[1]
    print(f"  [{card}] K5 extract at N={PIPELINE_N}, L={wav.shape[1]} ({m} frames, mfcc): "
          f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
          f"ms ({r['bound_by']})")
    return r


def pipeline_phase(card: str, counters, synth) -> dict:
    """Path 4: run_pipeline at full width on the synthesized corpus
    ``synth`` through the kernels (the default on the card) and through the
    plain path; then the device part of the kernel path profiled."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.scripts import run_pipeline as rp

    runs = {}
    for use_kernels in (None, False):
        _reset(counters)
        out = rp.run_pipeline(n_utterances=PIPELINE_N, iters=PIPELINE_ITERS, device="cuda",
                              use_kernels=use_kernels, data=synth)
        out["launches"] = _counts(counters)
        runs["kernel" if use_kernels is None else "plain"] = out
    k, p = runs["kernel"], runs["plain"]
    print(f"waveform pipeline: shape {k['shape']}, {PIPELINE_ITERS} EM iterations")
    for name, r in runs.items():
        print(f"  {name} path loglik per iteration: {r['loglik']}")
        print(f"  {name} path alignment {r['alignment']}, word IoU {r['word_iou']}, "
              f"boundary {r['boundary']}, purity {r['purity']}")
        print(f"  [{card}] {name} path stage ms (host clock, each stage ends in a "
              f"synchronize): {r['stage_ms']}")
    launches = k["launches"]
    print(f"  kernel launches on the waveform pipeline path: {launches}")
    _check(launches["extract"] >= 1 and launches["hmm_estep"] == PIPELINE_ITERS
           and launches["viterbi"] >= 1,
           "K5 launched, K4 once per EM iteration and K3 on the pipeline path")
    _check(not any(p["launches"].values()), "no kernel launched on the plain path")
    lw = np.asarray(k["loglik"])
    _check(bool(np.all(np.isfinite(lw))) and lw[-1] > lw[0], "pipeline loglik finite, improving")
    ll, ll_p = float(lw[-1]), float(p["loglik"][-1])
    _check(abs(ll - ll_p) <= 1e-3 * abs(ll_p),
           f"pipeline final loglik within rtol 1e-3 of plain ({ll} vs {ll_p}, rel "
           f"{(ll - ll_p) / abs(ll_p):+.3e}; JAX reference {REFERENCE_PIPELINE_LL})")
    f1, f1_p = k["alignment"]["f1"], p["alignment"]["f1"]
    _check(abs(f1 - f1_p) <= 0.002, f"pipeline F1 within 0.002 of plain ({f1:.5f} vs {f1_p:.5f})")
    _check(abs(f1 - REFERENCE_PIPELINE_F1) <= 0.005,
           f"pipeline F1 within 0.005 of the JAX reference {REFERENCE_PIPELINE_F1} ({f1:.5f})")

    phone_corpus, gold, wavs, wav_lens = synth
    wav, wav_len = torch.as_tensor(wavs, device="cuda"), torch.as_tensor(wav_lens, device="cuda")

    def after_synthesis():
        feats, frame_lens = rp.frontend(wav, wav_len)
        rp.fit_and_score(feats, frame_lens, phone_corpus, gold, PIPELINE_ITERS)

    _profile(after_synthesis, f"the waveform pipeline after synthesis (frontend, "
                              f"{PIPELINE_ITERS} EM iterations, decode, metrics)", card)
    return k


def extract_features_phase(here: str) -> None:
    """``extract_features speech`` on the card: ragged waveforms in an .npz
    under build/, features back in an .npz, against the plain version on
    the CPU."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.frontend import speech
    from multimodalworddiscovery_tpu_torch.ops import mfcc as k5
    from multimodalworddiscovery_tpu_torch.scripts import extract_features

    out_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(SEED)
    wavs = {f"arr_{i}": (0.2 * rng.standard_normal(n)).astype(np.float32)
            for i, n in enumerate((16000, 399, 401, 5000, 28160))}
    src, dst = os.path.join(out_dir, "wavs.npz"), os.path.join(out_dir, "feats.npz")
    np.savez(src, **wavs)
    before = k5.extract.launches
    extract_features.main(["speech", "--input", src, "--output", dst, "--batch-size", "2"])
    _check(k5.extract.launches == before + 3, "extract_features speech: 3 batches through K5")
    cfg = speech.MfccConfig()
    with np.load(dst) as z:
        _check(sorted(z.files) == sorted(wavs), "extract_features speech: one entry per input")
        for key, w in wavs.items():
            want = speech.extract(torch.as_tensor(w[None]), None, cfg)[0][0].numpy()
            _check(z[key].shape == want.shape and np.allclose(z[key], want, **MFCC_TOL),
                   f"extract_features speech {key}: {z[key].shape} within rtol 1e-3 atol 2e-3 "
                   f"of the plain version on the CPU")


def k7_check(what: str, gamma, src, concepts, f: int, e: int, reps: int) -> dict:
    """K7 on K4's posteriors ``gamma`` against its plain version (rtol
    1e-5, atol 1e-4 x the largest count) and the library scatter
    (``torch.bincount`` on the pairs' flat ids, timed only as a yardstick;
    the port never calls it); the three timed, and the bound of the call."""
    import torch

    from multimodalworddiscovery_tpu_torch.ops import counts as k7

    got = k7.pair_counts(gamma, src, concepts, f, e)
    want = k7.pair_counts_plain(gamma, src, concepts, f, e)
    flat = (src.long()[:, :, None] * e + concepts.long()[:, None, :]).reshape(-1)
    weights = gamma.reshape(-1)
    lib = torch.bincount(flat, weights=weights, minlength=f * e).reshape(f, e)
    scale = float(want.max())
    err = _max_abs(got, want)
    nonzero = int((gamma != 0).sum())
    print(f"K7 at {what}: gamma {tuple(gamma.shape)} ({nonzero} nonzero), counts [{f}, {e}]; "
          f"max abs err vs plain {err} (largest count {scale}), vs bincount "
          f"{_max_abs(got, lib)}")
    _check(torch.allclose(got, want, atol=1e-4 * scale, **K7_TOL),
           f"K7 at {what} within rtol 1e-5, atol 1e-4 x the largest count of plain")
    r = {"err": err,
         "ms": _gpu_ms(lambda: k7.pair_counts(gamma, src, concepts, f, e), reps),
         "plain_ms": _gpu_ms(lambda: k7.pair_counts_plain(gamma, src, concepts, f, e), reps),
         "library_ms": _gpu_ms(lambda: torch.bincount(flat, weights=weights,
                                                      minlength=f * e), reps)}
    # one add per element read; each input read once, the counts written once
    return r | _bound(_nbytes(gamma, src, concepts, got), float(gamma.numel()))


def _k8_bound(a, b, out, bf16: bool) -> dict:
    """K8's bound: the bytes of a, b and out, or 2 I J K operations per
    product (its terms' add and sum, a plain product's count) at the fp32
    rate, or for the bf16 variant at the bf16 tensor-core rate; with the
    exp-rate bound (one exp per term at EXP_PER_S) of the float32 kernel's
    design beside it."""
    nz = out.numel() // (out.shape[-1] * out.shape[-2])
    terms = float(nz) * a.shape[-2] * a.shape[-1] * b.shape[-1]
    ops = (0.0, 2 * terms) if bf16 else (2 * terms, 0.0)
    return _bound(_nbytes(a, b, out), *ops) | {"exp_bound_ms": terms / EXP_PER_S * 1e3}


def k8_check(what: str, a, b, want=None, bf16_too: bool = False, reps: int = 0,
             library: bool = False) -> dict:
    """K8 (and with ``bf16_too`` K8-bf16) against the plain versions on
    ``a`` x ``b``: K8 within rtol 1e-4 atol 1e-4 of the broadcast oracle
    (``want`` if given); K8-bf16 within 2e-2 of its plain bf16 version and
    5e-2 of K8, and rounding.  With ``reps``, each timed with its plain
    version and, with ``library``, the broadcast torch.logsumexp."""
    import torch

    from multimodalworddiscovery_tpu_torch.ops import log_semiring as k8

    got = k8.log_matmul(a, b)
    if want is None:
        want = k8.log_matmul_plain(a, b)
    err = _max_abs(got, want)
    live = want > -1e30 / 2
    print(f"K8 at {what}: a {tuple(a.shape)} x b {tuple(b.shape)}; max abs err vs plain {err}; "
          f"NEG_INF outputs {int((~live).sum())} of {want.numel()} (equal: "
          f"{bool(torch.equal(got[~live], want[~live]))})")
    _check(torch.allclose(got, want, **K8_TOL), f"K8 at {what} within rtol 1e-4 atol 1e-4 of "
                                                f"the broadcast oracle")
    r = {"err": err}
    if bf16_too:
        bf = k8.log_matmul(a, b, "bfloat16")
        bf_plain = k8.log_matmul_plain(a, b, "bfloat16")
        r["bf16_err"] = _max_abs(bf, bf_plain)
        print(f"  K8-bf16: max abs err vs its plain bf16 version {r['bf16_err']}, vs K8 "
              f"{_max_abs(bf, got)}")
        _check(torch.allclose(bf, bf_plain, rtol=0, atol=K8_BF16_VS_PLAIN)
               and torch.allclose(bf, got, rtol=0, atol=K8_BF16_VS_F32),
               f"K8-bf16 at {what} within 2e-2 of its plain bf16 version and 5e-2 of K8")
        _rounding_check(f"K8-bf16 at {what}", (("output", bf, bf_plain, got),))
    if reps:
        r |= {"ms": _gpu_ms(lambda: k8.log_matmul(a, b), reps),
              "plain_ms": _gpu_ms(lambda: k8.log_matmul_plain(a, b), max(reps // 5, 1)),
              "library_ms": (_gpu_ms(lambda: torch.logsumexp(a[..., :, :, None]
                                                             + b[..., None, :, :], dim=-2),
                                     max(reps // 5, 1)) if library else None)}
        r |= _k8_bound(a, b, got, bf16=False)
        if bf16_too:
            r |= {"bf16_ms": _gpu_ms(lambda: k8.log_matmul(a, b, "bfloat16"), reps),
                  "bf16_plain_ms": _gpu_ms(lambda: k8.log_matmul_plain(a, b, "bfloat16"),
                                           max(reps // 5, 1)),
                  "bf16_bound": _k8_bound(a, b, got, bf16=True)}
    return r


def _wide_range(dev):
    """Row 0 of a spans 300 nats; its largest product a[0, k] + b[k, 0] is
    -10, at k = 5, where a[0, 5] lies 250 nats below the row's maximum (the
    factored form's exp(-250) is 0 in float32).  Other rows and columns are
    5 * normal beside -300 entries."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    a = np.full((64, 96), -300.0, np.float32)
    b = np.full((96, 48), -300.0, np.float32)
    a[1:, :10] = 5 * rng.standard_normal((63, 10))
    b[:10, 1:] = 5 * rng.standard_normal((10, 47))
    a[0, 0], a[0, 5], b[0, 0], b[5, 0] = 0.0, -250.0, -400.0, 240.0
    return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)


def k8_phase(card: str, dev) -> dict:
    """K8 and K8-bf16 at 512 and 1024 from 5 * normal (bench_kernels'
    inputs) and on the synthetic wide-range rows; times and bounds at 1024,
    the largest size where the broadcast library form fits."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    out = {}
    for size in K8_SIZES:
        a, b = (torch.as_tensor((5 * rng.standard_normal((size, size))).astype(np.float32),
                                device=dev) for _ in range(2))
        out[size] = k8_check(f"{size} x {size} (5 * normal)", a, b, bf16_too=True,
                             reps=20 if size == K8_SIZES[-1] else 0, library=True)
    a, b = _wide_range(dev)
    want = torch.logsumexp(a.double()[:, :, None] + b.double()[None], dim=1).float()
    _check(abs(float(want[0, 0]) + 10.0) < 1e-4, "wide-range input: its row 0's largest "
                                                 "product is -10, 250 nats below a[0, 0]")
    out["wide"] = k8_check("the synthetic wide-range rows (float64 oracle)", a, b, want=want)
    r = out[K8_SIZES[-1]]
    print(f"  [{card}] K8 log_matmul at {K8_SIZES[-1]}^3: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
          f"ms ({r['bound_by']}), exp-rate bound {r['exp_bound_ms']:.4f} ms")
    b = r["bf16_bound"]
    print(f"  [{card}] K8-bf16 log_matmul(dot_dtype='bfloat16') at {K8_SIZES[-1]}^3: kernel "
          f"{r['bf16_ms']:.4f} ms, plain {r['bf16_plain_ms']:.4f} ms, bound {b['bound_ms']:.4f} "
          f"ms ({b['bound_by']}; its products at the bf16 rate)")
    return out


def dense_phase(card: str, counters, dev) -> dict:
    """Path 8: the dense-caption discrete EM through K1 -> K4 -> K7, decode
    through K3, segmentation and F1, kernels then plain; K7 at this shape;
    EM times and a profile of one iteration."""
    import numpy as np

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.models import hmm
    from multimodalworddiscovery_tpu_torch.ops import counts as k1
    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k24

    corpus, gold, _ = make_flickr8k_mini(**DENSE, device=dev)
    s, v_src, v_trg = 2 * corpus.max_trg_len, corpus.src_vocab, corpus.trg_vocab
    route = hmm.estep_route(s, v_src, v_trg, True, "float32")
    print(f"path 8 (dense-caption discrete EM): N={corpus.n}, Ts={corpus.max_src_len}, S={s}, "
          f"V_src={v_src}, V_trg={v_trg}, {int(corpus.src_len.sum())} valid steps; E-step route "
          f"{route!r}, {EM_ITERS} EM iterations")
    _check(route == "general", "path 8 takes the general route (outside K2's gate)")
    _reset(counters)
    kern = headline_path(corpus, gold, use_kernels=True)
    launches = _counts(counters)
    plain = headline_path(corpus, gold, use_kernels=False)
    lw, lp = kern["lls"], plain["lls"]
    print(f"  kernel-path loglik per iteration: {lw.tolist()}")
    print(f"  plain-path loglik per iteration:  {lp.tolist()}")
    print(f"  kernel launches on path 8: {launches}")
    print(f"  kernel path alignment: {kern['prf']}")
    print(f"  plain path alignment:  {plain['prf']}")
    _check(launches["pair_counts"] == EM_ITERS and launches["hmm_estep"] == EM_ITERS
           and launches["table_lookup"] == EM_ITERS and launches["viterbi"] == 1
           and launches["hmm_estep_counts"] == 0 and launches["hmm_estep_counts_bf16"] == 0,
           f"path 8: K1, K4 and K7 launched once per EM iteration ({EM_ITERS} K7 launches), K3 "
           f"once, K2 never")
    _check(bool(np.all(np.isfinite(lw))), "path 8 loglik finite")
    _check(bool(np.all(np.diff(lw) > -1e-3 * np.abs(lw[:-1]))) and lw[-1] > lw[0],
           "path 8 loglik monotone within bench.py's bound and improving")
    ll, ll_p = float(lw[-1]), float(lp[-1])
    _check(abs(ll - ll_p) <= 1e-4 * abs(ll_p),
           f"path 8 final loglik within rtol 1e-4 of plain ({ll} vs {ll_p}; JAX reference "
           f"{REFERENCE_DENSE_LL})")
    f1, f1_p = kern["prf"]["f1"], plain["prf"]["f1"]
    _check(abs(f1 - f1_p) <= 0.002, f"path 8 F1 within 0.002 of plain ({f1:.5f} vs {f1_p:.5f})")
    _check(abs(f1 - REFERENCE_DENSE_F1) <= 0.005,
           f"path 8 F1 within 0.005 of the JAX reference {REFERENCE_DENSE_F1} ({f1:.5f})")

    # K7 on K4's posteriors from the trained parameters
    params = kern["params"]
    concepts, fact = _estep_inputs(params, corpus)
    gamma = k24.hmm_estep(*fact, k1.table_lookup(params.log_emit, corpus.src, concepts),
                          corpus.src_len)[0]
    k7 = k7_check("path 8's shape", gamma, corpus.src, concepts, v_src, v_trg, 20)
    del gamma
    p0 = hmm.init(corpus)
    em = _alternate({
        "plain": lambda: hmm.train(p0, corpus, EM_ITERS, use_kernels=False),
        "kernels": lambda: hmm.train(p0, corpus, EM_ITERS, use_kernels=True),
    }, reps=1, rounds=1)
    ms_k, ms_p = em["kernels"] / EM_ITERS, em["plain"] / EM_ITERS
    print(f"  [{card}] path 8 EM ms/iter, median of 2 runs of {EM_ITERS} iterations: kernel path "
          f"{ms_k:.4f}, plain path {ms_p:.4f} (all runs: {em['runs']}); K7 {k7['ms']:.4f} ms, "
          f"{k7['ms'] / ms_k:.4f} of the kernel path's iteration")
    print(f"  [{card}] K7 pair_counts at path 8's shape: kernel {k7['ms']:.4f} ms, plain "
          f"{k7['plain_ms']:.4f} ms, library bincount {k7['library_ms']:.4f} ms, bound "
          f"{k7['bound_ms']:.4f} ms ({k7['bound_by']})")
    _profile(lambda: hmm.em_step(p0, corpus), "one path 8 EM iteration (K1, K4, K7, M-step)", card)
    return {"launches": launches, "k7": k7, "ms_per_iter": (ms_k, ms_p)}


def assoc_phase(card: str, counters, dev) -> dict:
    """Path 9: forward_associative and forward_blocked through K8 at
    bench_assoc's shapes against the sequential plain forward (logZ rtol
    1e-4, alphas rtol 1e-3 atol 1e-3 at valid positions) and K4's logZ; K8
    on the scan's first even / odd slices and on the prefix products of the
    step matrices; times of the forwards."""
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core
    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k24
    from multimodalworddiscovery_tpu_torch.ops import log_semiring as k8
    from multimodalworddiscovery_tpu_torch.scripts import bench_assoc

    launches, out = None, {}
    for label, gen in bench_assoc.SHAPES:
        corpus, _, _ = make_flickr8k_mini(**gen, device=dev)
        # trained emissions: peaked, so the prefix products spread further
        params = hmm.train(hmm.init(corpus), corpus, EM_ITERS)[0]
        log_init, log_trans, log_emit = hmm._machinery(params, corpus)
        args = (log_init, log_trans, log_emit, corpus.src_len)
        n, ts, s = log_emit.shape
        print(f"path 9 at {label}: N={n}, Ts={ts}, S={s}, parameters after {EM_ITERS} EM "
              f"iterations from hmm.init")
        alphas, logz = hmm_core.forward(*args)
        _, fact = _estep_inputs(params, corpus)
        logz4 = k24.hmm_estep(*fact, log_emit, corpus.src_len)[2]
        valid = ((torch.arange(ts, device=dev)[:, None, None] < corpus.src_len[None, :, None])
                 & hmm_core.state_mask(corpus)[None])
        _reset(counters)
        runs = {"associative": hmm_core.forward_associative(*args),
                f"blocked({ASSOC_BLOCK})": hmm_core.forward_blocked(*args, block=ASSOC_BLOCK)}
        torch.cuda.synchronize()
        got = _counts(counters)
        print(f"  kernel launches: {got}")
        _check(got["log_matmul"] > 0 and sum(got.values()) == got["log_matmul"],
               f"path 9 at {label}: the combines launched K8 and nothing else")
        launches = got if launches is None else {k: v + got[k] for k, v in launches.items()}
        for name, (a, z) in runs.items():
            rel = float(((z - logz).abs() / logz.abs().clamp(min=1e-30)).max())
            rel4 = float(((z - logz4).abs() / logz4.abs().clamp(min=1e-30)).max())
            err = _max_abs(a[valid], alphas[valid])
            print(f"  {name}: logZ max rel err vs sequential {rel:.3e}, vs K4 {rel4:.3e}; "
                  f"alphas max abs err at valid positions {err}")
            _check(torch.allclose(z, logz, rtol=1e-4, atol=0)
                   and torch.allclose(z, logz4, rtol=1e-4, atol=0),
                   f"path 9 {name} at {label}: logZ within rtol 1e-4 of the sequential forward "
                   f"and of K4")
            _check(torch.allclose(a[valid], alphas[valid], rtol=1e-3, atol=1e-3),
                   f"path 9 {name} at {label}: alphas within rtol 1e-3 atol 1e-3 at valid "
                   f"(t, state) positions")
        del runs
        m = hmm_core.step_matrices(log_trans, log_emit, corpus.src_len)
        r = k8_check(f"path 9's first combine at {label}", m[0:-1:2], m[1::2], reps=5)
        prefixes = hmm_core.associative_scan(k8.log_matmul, m)
        live = prefixes > -1e30 / 2
        span = (torch.where(live, prefixes, -torch.inf).amax(-1)
                - torch.where(live, prefixes, torch.inf).amin(-1))
        print(f"  prefix products at {label}: widest row spans {float(span.max()):.1f} nats, "
              f"{float(live.float().mean()):.4f} of entries above NEG_INF")
        want = k8.log_matmul_plain(prefixes[:-1], m[1:])
        r["prefix_err"] = k8_check(f"path 9's prefix products at {label}", prefixes[:-1],
                                   m[1:], want=want)["err"]
        bf = k8.log_matmul(prefixes[:-1], m[1:], "bfloat16")
        print(f"  the factored form there (K8-bf16): max abs err {_max_abs(bf, want):.4g} "
              f"against the oracle; {int(((bf - want).abs() > 1.0).sum())} of {want.numel()} "
              f"outputs off by more than 1 nat")
        bcast = 4.0 * ((ts - 1) // 2) * n * s**3
        del m, prefixes, span, live, want, bf
        times = {"sequential plain": lambda: hmm_core.forward(*args),
                 "K4 E-step": lambda: k24.hmm_estep(*fact, log_emit, corpus.src_len),
                 "associative (K8)": lambda: hmm_core.forward_associative(*args),
                 "associative (plain)": lambda: hmm_core.forward_associative(
                     *args, use_kernels=False),
                 f"blocked({ASSOC_BLOCK}) (K8)": lambda: hmm_core.forward_blocked(
                     *args, block=ASSOC_BLOCK)}
        r["times"] = {k: _gpu_ms(fn, 1) for k, fn in times.items()}
        print(f"  [{card}] path 9 at {label}, ms per call (CUDA events): {r['times']}")
        print(f"  [{card}] K8 at the first combine: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), exp-rate "
              f"bound {r['exp_bound_ms']:.4f} ms; library broadcast: not run (its [B, I, K, J] "
              f"sum would take {bcast:.3g} bytes)")
        out[label] = r
        if label == bench_assoc.SHAPES[-1][0]:
            _profile(lambda: hmm_core.forward_associative(*args),
                     f"forward_associative at {label} (K8 combines)", card)
        del corpus, params, args, alphas, fact
        torch.cuda.empty_cache()
    return {"launches": launches, "shapes": out}


def k4_s8_phase(card: str, dev) -> dict:
    """K4, K4-bf16, K6 and K3 at the two S=8 shapes the pipeline (N=2000,
    Ts=174) and the CRF and DNN-HMM paths (N=400, Ts=64) launch them at,
    their inputs built as ``scripts/bench_estep.py`` builds them: each
    against its plain version (K4's bounds; K6 also against K4; K3 as
    k3_parity), and timed with its bound."""
    import torch

    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k4
    from multimodalworddiscovery_tpu_torch.scripts import bench_estep

    out = {}
    for label in ("S8_pipeline", "S8_crf"):
        inputs = bench_estep.shape_inputs(label, dev)
        n, ts, s = inputs[4].shape
        print(f"K4 at {label}: N={n}, Ts={ts}, S={s}, {int(inputs[5].sum())} valid steps")
        want = k4.hmm_estep_plain(*inputs)
        got = k4.hmm_estep(*inputs)
        errs = _k4_checks(f"K4 at {label}", got, want, 0)
        bf = k4.hmm_estep(*inputs, dot_dtype="bfloat16")
        bf_p = k4.hmm_estep_plain(*inputs, dot_dtype="bfloat16")
        errs_bf = _k4_checks(f"K4-bf16 at {label}", bf, bf_p, 0)
        g6 = k4.hmm_estep(*inputs, remat=True)
        _check(torch.allclose(g6[2], got[2], rtol=1e-5, atol=0)
               and torch.allclose(g6[0], got[0], rtol=1e-4, atol=1e-5)
               and torch.allclose(g6[1], got[1], rtol=1e-4, atol=1e-4),
               f"K6 at {label} against K4: logZ rtol 1e-5, gamma rtol 1e-4 atol 1e-5, xi rtol "
               f"1e-4 atol 1e-4")
        nbytes = _nbytes(*inputs, *got)
        r = {"err": max(errs.values()), "bf16_err": max(errs_bf.values()),
             "ms": _gpu_ms(lambda: k4.hmm_estep(*inputs), 20),
             "plain_ms": _gpu_ms(lambda: k4.hmm_estep_plain(*inputs), 2),
             "bf16_ms": _gpu_ms(lambda: k4.hmm_estep(*inputs, dot_dtype="bfloat16"), 20),
             "bf16_plain_ms": _gpu_ms(lambda: k4.hmm_estep_plain(*inputs, dot_dtype="bfloat16"),
                                      2),
             "k6_ms": _gpu_ms(lambda: k4.hmm_estep(*inputs, remat=True), 20),
             "bf16_bound": _estep_bound(nbytes, inputs[5], s, bf16=True)}
        r |= _estep_bound(nbytes, inputs[5], s, bf16=False)
        r["k3"] = k3_parity(label, inputs, 20)
        print(f"  [{card}] K3 at {label}: kernel {r['k3']['ms']:.4f} ms, plain "
              f"{r['k3']['plain_ms']:.4f} ms, bound {r['k3']['bound_ms']:.4f} ms "
              f"({r['k3']['bound_by']})")
        print(f"  [{card}] K4 at {label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); K4-bf16 {r['bf16_ms']:.4f} ms, "
              f"plain {r['bf16_plain_ms']:.4f} ms, bound {r['bf16_bound']['bound_ms']:.4f} ms; "
              f"K6 {r['k6_ms']:.4f} ms")
        out[label] = r
        del inputs, want, got, bf, bf_p, g6
        torch.cuda.empty_cache()
    return out


def _random_factored(s: int, n: int, ts: int, seed: int, dev) -> tuple:
    """E-step inputs from a seed: a random jump table, utterances with 0, 7
    or 14 of their S states masked, emissions 3 * normal, ragged lengths
    and ZERO_LENGTH_PAD empty utterances last."""
    import torch

    from multimodalworddiscovery_tpu_torch.core.logsemiring import NEG_INF

    gen = torch.Generator().manual_seed(seed)
    n_valid = torch.tensor([s - 7 * (i % 3) for i in range(n)])
    colmask = torch.where(torch.arange(s)[None, :] < n_valid[:, None], 0.0, NEG_INF)
    base = 2.0 * torch.randn(s, s, generator=gen)
    rowz = torch.logsumexp(base[None, :, :] + colmask[:, None, :], dim=-1)
    log_init = torch.log_softmax(torch.randn(n, s, generator=gen) + colmask, dim=-1)
    emit = 3.0 * torch.randn(n, ts, s, generator=gen)
    lens = [ts - (5 * i) % ts for i in range(n - ZERO_LENGTH_PAD)] + [0] * ZERO_LENGTH_PAD
    src_len = torch.tensor(lens, dtype=torch.int32)
    return tuple(x.contiguous().to(dev) for x in (log_init, base, rowz, colmask, emit, src_len))


def many_states_phase(card: str, counters, dev) -> dict:
    """Above the 160 states K4, K6 and K3 once took: K4, K4-bf16, K6 and K3
    against their plain versions (k4_parity, k3_parity) on a corpus with
    96-100 concepts an image (S~200) and one with 126-130 (S~260, past 8-bit
    backpointers), each with ZERO_LENGTH_PAD empty utterances, and on
    MANY_RANDOM's inputs (S=2000: K4's buffers in device memory); then
    hmm.train for MANY_ITERS iterations and hmm.align on the S~200 corpus
    through K1 -> K4 -> K7 and K3, against the plain route."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf
    from multimodalworddiscovery_tpu_torch.models import hmm
    from multimodalworddiscovery_tpu_torch.ops import counts as k1

    out = {}
    for label, gen in (("S~200", MANY_200), ("S~260", MANY_260)):
        corpus, _, _ = make_flickr8k_mini(**gen, device=dev)
        padded = corpus.pad_to(corpus.n + ZERO_LENGTH_PAD)
        params, _ = hmm.em_step(hmm.init(padded), padded, use_kernels=False)
        concepts, fact = _estep_inputs(params, padded)
        inputs = (*fact, k1.table_lookup(params.log_emit, padded.src, concepts), padded.src_len)
        name = f"many states ({label}, S={concepts.shape[1]})"
        out[label] = {"k4": k4_parity(name, inputs, 3), "k3": k3_parity(name, inputs, 3),
                      "S": concepts.shape[1]}
        del corpus, padded, params, fact, inputs
        torch.cuda.empty_cache()
    inputs = _random_factored(**MANY_RANDOM, dev=dev)
    name = f"many states (random, S={MANY_RANDOM['s']})"
    out["random"] = {"k4": k4_parity(name, inputs, 3, bf16_flips=True),
                     "k3": k3_parity(name, inputs, 3), "S": MANY_RANDOM["s"]}
    del inputs
    torch.cuda.empty_cache()

    corpus, gold, _ = make_flickr8k_mini(**MANY_200, device=dev)
    s, v_src, v_trg = 2 * corpus.max_trg_len, corpus.src_vocab, corpus.trg_vocab
    route = hmm.estep_route(s, v_src, v_trg, True, "float32")
    print(f"many states, EM: N={corpus.n}, Ts={corpus.max_src_len}, S={s}, V_src={v_src}, "
          f"V_trg={v_trg}; E-step route {route!r}, {MANY_ITERS} EM iterations, then align")
    _check(route == "general", "the S~200 corpus takes the general route")
    gold_t = torch.as_tensor(gold.alignment, device=dev)
    runs, launches = {}, None
    for use_kernels in (True, False):
        _reset(counters)
        p, lls = hmm.train(hmm.init(corpus), corpus, MANY_ITERS, use_kernels=use_kernels)
        alignment = hmm.align(p, corpus, use_kernels=use_kernels)
        prf = alignment_prf(alignment, gold_t, corpus.src_mask())
        torch.cuda.synchronize()
        if use_kernels:
            launches = _counts(counters)
        else:
            _check(not any(_counts(counters).values()), "no kernel launched on the plain path")
        runs[use_kernels] = (lls.cpu().numpy(), float(prf["f1"]))
    (lw, f1), (lp, f1_p) = runs[True], runs[False]
    print(f"  kernel-path loglik per iteration: {lw.tolist()}, F1 {f1:.5f}")
    print(f"  plain-path loglik per iteration:  {lp.tolist()}, F1 {f1_p:.5f}")
    print(f"  kernel launches: {launches}")
    _check(launches["table_lookup"] == MANY_ITERS and launches["hmm_estep"] == MANY_ITERS
           and launches["pair_counts"] == MANY_ITERS and launches["viterbi"] == 1
           and launches["hmm_estep_counts"] == 0,
           f"S~200: K1, K4 and K7 launched once per EM iteration, K3 once, K2 never")
    _check(bool(np.all(np.isfinite(lw))), "S~200 loglik finite")
    _check(abs(float(lw[-1]) - float(lp[-1])) <= 1e-4 * abs(float(lp[-1])),
           f"S~200 final loglik within rtol 1e-4 of plain ({lw[-1]} vs {lp[-1]})")
    _check(abs(f1 - f1_p) <= 0.002, f"S~200 F1 within 0.002 of plain ({f1:.5f} vs {f1_p:.5f})")
    for label, r in out.items():
        k4r, k3r = r["k4"], r["k3"]
        print(f"  [{card}] {label} (S={r['S']}): K4 {k4r['ms']:.4f} ms (plain "
              f"{k4r['plain_ms']:.4f}, bound {k4r['bound_ms']:.4f}), K4-bf16 {k4r['bf16_ms']:.4f} "
              f"ms, K6 {k4r['k6_ms']:.4f} ms; K3 {k3r['ms']:.4f} ms (plain "
              f"{k3r['plain_ms']:.4f}, bound {k3r['bound_ms']:.4f})")
    return {"shapes": out, "launches": launches}


def bench_phase(here: str, counters) -> dict:
    """The port's bench_kernels (counts, log_matmul) and bench_assoc, once
    each with few repetitions, records under build/chip_smoke/; K8-bf16's
    launches come from bench_kernels' log_matmul entry, its entry point."""
    from multimodalworddiscovery_tpu_torch.scripts import bench_assoc, bench_kernels

    out_dir = os.path.join(here, "build", "chip_smoke")
    _reset(counters)
    bench_kernels.main(["--only", "counts", "log_matmul", "--reps", "3",
                        "--out", os.path.join(out_dir, "bench_kernels.jsonl")])
    launches = _counts(counters)
    print(f"  kernel launches in bench_kernels --only counts log_matmul: {launches}")
    _check(launches["pair_counts"] > 0 and launches["log_matmul"] > 0
           and launches["log_matmul_bf16"] > 0,
           "bench_kernels launched K7, K8 and K8-bf16")
    bench_assoc.main(["--reps", "2", "--out", os.path.join(out_dir, "bench_assoc.jsonl")])
    return launches


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

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
    from multimodalworddiscovery_tpu_torch.models import hmm, hmm_gaussian
    from multimodalworddiscovery_tpu_torch.ops import _build
    from multimodalworddiscovery_tpu_torch.ops import counts as k1
    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k24
    from multimodalworddiscovery_tpu_torch.ops import mfcc as k5
    from multimodalworddiscovery_tpu_torch.ops import viterbi as k3

    t_start = time.perf_counter()
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
    kernels_all = _counters()

    def elapsed() -> str:
        return f"[{time.perf_counter() - t_start:.1f} s]"

    t0 = time.perf_counter()
    libs = _build.build()
    _build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(os.path.relpath(p, here) for p in libs)}")
    print(_run([_build.find_nvcc(), "--version"]).splitlines()[-1])
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # --- K1 / K2 parity at the headline shape and at the K2 gate edge ---
    errs = parity("headline shape", make_flickr8k_mini(**HEADLINE)[0].to(dev), reps=20)
    errs_edge = parity("K2 gate edge (S=64)", make_flickr8k_mini(**GATE_EDGE)[0].to(dev))
    print(elapsed())

    # --- path 1: the headline discrete EM, kernels then plain ---
    corpus, gold, _ = make_flickr8k_mini(**HEADLINE, device=dev)
    print(f"headline path: N={corpus.n}, Ts={corpus.max_src_len}, "
          f"S={2 * corpus.max_trg_len}, V_src={corpus.src_vocab}, "
          f"V_trg={corpus.trg_vocab}, {EM_ITERS} EM iterations")
    _reset(kernels_all)
    kern = headline_path(corpus, gold, use_kernels=True)
    launches_headline = _counts(kernels_all)
    plain = headline_path(corpus, gold, use_kernels=False)

    lw = kern["lls"]
    print(f"  kernel-path loglik per iteration: {lw.tolist()}")
    print(f"  plain-path loglik per iteration:  {plain['lls'].tolist()}")
    print(f"  kernel launches on the headline path: {launches_headline}")
    print(f"  kernel path alignment: {kern['prf']}")
    print(f"  plain path alignment:  {plain['prf']}")
    _check(launches_headline["table_lookup"] > 0 and launches_headline["viterbi"] > 0
           and launches_headline["hmm_estep_counts"] == EM_ITERS
           and launches_headline["hmm_estep"] == 0 and launches_headline["pair_counts"] == 0,
           "K1 and K3 launched on the headline path, K2 once per EM iteration, K4 and K7 never")
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

    # headline times (CUDA events), each beside the card's name and power
    # limit; the two paths alternate (plain, kernels, kernels, plain, ...)
    p0 = hmm.init(corpus)
    em = _alternate({
        "plain": lambda: hmm.train(p0, corpus, EM_ITERS, use_kernels=False),
        "kernels": lambda: hmm.train(p0, corpus, EM_ITERS, use_kernels=True),
    }, reps=2, rounds=2)
    ms_k, ms_p = em["kernels"] / EM_ITERS, em["plain"] / EM_ITERS
    print(f"  [{card}] headline EM ms/iter, median of 4 runs of 2x{EM_ITERS} "
          f"iterations: kernel path {ms_k:.4f}, plain path {ms_p:.4f} (all runs, "
          f"ms per {EM_ITERS} iterations: {em['runs']})")
    print(f"  [{card}] headline EM throughput: kernel path {corpus.n * 1e3 / ms_k:.1f} "
          f"utt*iter/s, plain path {corpus.n * 1e3 / ms_p:.1f} utt*iter/s")
    _profile(lambda: hmm.em_step(p0, corpus), "one headline EM iteration (K1, K2, M-step)", card)
    params = kern["params"]
    concepts, (log_init, base, rowz, colmask) = _estep_inputs(params, corpus)
    emit = k1.table_lookup(params.log_emit, corpus.src, concepts)
    k1_ms = _gpu_ms(lambda: k1.table_lookup(params.log_emit, corpus.src, concepts), 50)
    k1_plain_ms = _gpu_ms(lambda: k1.table_lookup_plain(params.log_emit, corpus.src, concepts), 50)
    # the one PyTorch call that computes K1's gather (without its masking
    # of padded states); timed only, the port never calls it
    k1_library_ms = _gpu_ms(lambda: params.log_emit[corpus.src[..., None],
                                                    concepts[:, None, :]], 50)
    k1_bound = _bound(_nbytes(params.log_emit, corpus.src, concepts, emit), 0)
    print(f"  [{card}] K1 table_lookup: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, "
          f"library gather {k1_library_ms:.4f} ms, bound {k1_bound['bound_ms']:.4f} ms "
          f"({k1_bound['bound_by']})")
    k3_s12 = k3_parity("headline shape (S=12)", (log_init, base, rowz, colmask, emit,
                                                 corpus.src_len), 20)
    print(f"  [{card}] K3 viterbi at S=12: kernel {k3_s12['ms']:.4f} ms, "
          f"plain {k3_s12['plain_ms']:.4f} ms, bound {k3_s12['bound_ms']:.4f} ms "
          f"({k3_s12['bound_by']})")
    # K7 on K4's posteriors at the headline shape
    gamma = k24.hmm_estep(log_init, base, rowz, colmask, emit, corpus.src_len)[0]
    k7_head = k7_check("the headline shape", gamma, corpus.src, concepts,
                       *params.log_emit.shape, 20)
    print(f"  [{card}] K7 pair_counts at the headline shape: kernel {k7_head['ms']:.4f} ms, "
          f"plain {k7_head['plain_ms']:.4f} ms, library bincount {k7_head['library_ms']:.4f} ms, "
          f"bound {k7_head['bound_ms']:.4f} ms ({k7_head['bound_by']})")
    del emit, gamma
    print(elapsed())

    # --- path 5: the headline EM at dot_dtype="bfloat16" (K1, K2-bf16, K3) ---
    _reset(kernels_all)
    kern_bf = headline_path(corpus, gold, use_kernels=True, dot_dtype="bfloat16")
    launches_bf16 = _counts(kernels_all)
    lb = kern_bf["lls"]
    print(f"path 5 (headline EM, dot_dtype='bfloat16'): loglik per iteration {lb.tolist()}")
    print(f"  alignment {kern_bf['prf']}; launches {launches_bf16}")
    _check(launches_bf16["hmm_estep_counts_bf16"] == EM_ITERS
           and launches_bf16["hmm_estep_counts"] == 0 and launches_bf16["hmm_estep_bf16"] == 0
           and launches_bf16["pair_counts"] == 0
           and launches_bf16["table_lookup"] > 0 and launches_bf16["viterbi"] > 0,
           "path 5: K1 and K3 launched, K2-bf16 on every EM iteration, K2, K4-bf16 and K7 never")
    _check(bool(np.all(np.isfinite(lb))), "path 5 loglik finite")
    rel = (float(lb[-1]) - float(lw[-1])) / abs(float(lw[-1]))
    _check(abs(rel) <= 1e-3, f"path 5 final loglik within rtol 1e-3 of the float32 kernel "
                             f"path ({lb[-1]} vs {lw[-1]}, rel {rel:+.3e})")
    f1_bf, f1_k = kern_bf["prf"]["f1"], kern["prf"]["f1"]
    _check(abs(f1_bf - f1_k) <= 0.005, f"path 5 F1 within 0.005 of the float32 kernel path "
                                       f"({f1_bf:.5f} vs {f1_k:.5f})")
    em_bf = _gpu_ms(lambda: hmm.train(p0, corpus, EM_ITERS, use_kernels=True,
                                      dot_dtype="bfloat16"), 2) / EM_ITERS
    print(f"  [{card}] path 5 EM ms/iter (CUDA events, mean of 2 runs of {EM_ITERS} "
          f"iterations): {em_bf:.4f}")
    del corpus, kern, kern_bf, plain
    print(elapsed())

    # --- the stretch corpus (frames) ---
    pc, pg, _ = make_flickr8k_mini(**STRETCH)
    fc, fg, _ = phones_to_frames(pc, pg, **STRETCH_FRAMES, device=dev)
    print(f"stretch corpus: N={fc.n}, Ts={fc.max_src_len}, S={2 * fc.max_trg_len}, "
          f"C={fc.trg_vocab}, D={fc.src.shape[-1]} {elapsed()}")

    # --- K1 / K2 at the VQ teacher's shape, and the teacher's trajectory ---
    teacher = teacher_phase(fc, card)
    print(elapsed())

    # --- K4 / K3 parity and times at the stretch shape (Gaussian emissions
    # from init_diagonal) and at S=128 on the discrete route ---
    p_diag = hmm_gaussian.init_diagonal(fc, max_jump=MAX_JUMP, n_components=1,
                                        generator=torch.Generator().manual_seed(SEED))
    padded = fc.pad_to(fc.n + ZERO_LENGTH_PAD)
    _, fact = _estep_inputs(p_diag, padded)
    inputs64 = (*fact, hmm_gaussian._log_emissions(p_diag, padded), padded.src_len)
    k4_stretch = k4_parity("stretch shape (S=64)", inputs64, 5, bf16_flips=True)
    # K6 through its entry point, the way a caller reaches it (no model path
    # passes remat=True): one E-step of these Gaussian emissions, counted
    _reset(kernels_all)
    k24.hmm_estep(*inputs64, remat=True)
    torch.cuda.synchronize()
    launches_k6 = _counts(kernels_all)
    _check(launches_k6["hmm_estep_remat"] == 1 and launches_k6["hmm_estep"] == 0,
           "K6 launched through hmm_estep(remat=True) at the stretch shape")
    del inputs64
    _, fact = _estep_inputs(p_diag, fc)
    k3_stretch = k3_parity("stretch shape (S=64)",
                           (*fact, hmm_gaussian._log_emissions(p_diag, fc), fc.src_len), 10)
    del padded, fact
    c128, _, _ = make_flickr8k_mini(**S128)
    c128 = c128.pad_to(c128.n + ZERO_LENGTH_PAD).to(dev)
    p128, _ = hmm.em_step(hmm.init(c128), c128, use_kernels=True)
    concepts, fact = _estep_inputs(p128, c128)
    inputs128 = (*fact, k1.table_lookup(p128.log_emit, c128.src, concepts), c128.src_len)
    k4_128 = k4_parity("discrete route outside the gate (S=128)", inputs128, 10)
    k3_128 = k3_parity("discrete route outside the gate (S=128)", inputs128, 10)
    for name, r in (("K4 hmm_estep at S=64", k4_stretch), ("K4 hmm_estep at S=128", k4_128),
                    ("K3 viterbi at S=64", k3_stretch), ("K3 viterbi at S=128", k3_128)):
        print(f"  [{card}] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    for s_, r in ((64, k4_stretch), (128, k4_128)):
        b = r["bf16_bound"]
        print(f"  [{card}] K4-bf16 hmm_estep(dot_dtype='bfloat16') at S={s_}: kernel "
              f"{r['bf16_ms']:.4f} ms, plain {r['bf16_plain_ms']:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; its products at the bf16 rate); K6 "
              f"hmm_estep(remat=True, chunk_t=32) at S={s_}: kernel {r['k6_ms']:.4f} ms, plain "
              f"{r['k6_plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"K4's); K6 logZ and gamma bit-identical to K4's at chunks {K6_CHUNKS}: "
              f"{r['k6_bit_identical']}")
    del c128, inputs128
    # --- K4, K4-bf16 and K6 at the S=8 shapes of the pipeline and the CRF ---
    k4_s8 = k4_s8_phase(card, dev)
    print(elapsed())

    # --- path 2: the Gaussian parity run, kernels then plain ---
    print(f"Gaussian parity run: init_diagonal(max_jump={MAX_JUMP}, n_components=1), "
          f"{EM_ITERS} EM iterations, anneal={ANNEAL}")
    _reset(kernels_all)
    g_kern = gaussian_path(fc, fg, p_diag, use_kernels=True)
    launches_gauss = _counts(kernels_all)
    g_plain = gaussian_path(fc, fg, p_diag, use_kernels=False)
    lw = g_kern["lls"]
    print(f"  kernel-path loglik per iteration: {lw.tolist()}")
    print(f"  plain-path loglik per iteration:  {g_plain['lls'].tolist()}")
    print(f"  kernel launches on the Gaussian parity path: {launches_gauss}")
    print(f"  kernel path alignment: {g_kern['prf']}, boundary: {g_kern['boundary']}")
    print(f"  plain path alignment:  {g_plain['prf']}, boundary: {g_plain['boundary']}")
    _check(launches_gauss["hmm_estep"] == EM_ITERS and launches_gauss["viterbi"] == 1,
           "K4 launched once per EM iteration and K3 once on the Gaussian path")
    _check(bool(np.all(np.isfinite(lw))), "loglik finite")
    _check(bool(np.all(np.diff(lw[ANNEAL[1] - 1:]) > 0)),
           f"loglik rises at every step after the ramp (iterations {ANNEAL[1]}-{EM_ITERS - 1})")
    # E-step drift, iteration by iteration: along the kernel path's
    # trajectory, each iteration's E-step runs through K4 and through the
    # plain dense route from the same parameters at the same temperature
    p_at, step_rel = p_diag, []
    for scale in hmm_gaussian.anneal_scales(EM_ITERS, ANNEAL):
        counts, ll_k = hmm_gaussian.expected_counts(p_at, fc, use_kernels=True,
                                                    emit_scale=scale)
        ll_d = hmm_gaussian.expected_counts(p_at, fc, use_kernels=False, emit_scale=scale)[1]
        step_rel.append((float(ll_k) - float(ll_d)) / abs(float(ll_d)))
        p_at = hmm_gaussian.m_step(p_at, counts)
    del counts, p_at
    print(f"  one E-step from each iteration's parameters, (K4 - plain dense) / |plain| "
          f"loglik: {step_rel}")
    _check(max(map(abs, step_rel)) <= 1e-5,
           "every iteration's E-step: K4 loglik within rtol 1e-5 of the plain dense "
           "E-step from the same parameters")
    # The 10 annealed iterations amplify float32 rounding: the plain path in
    # float64 (where the factored and the dense routes agree to 1e-12) is
    # the reference each float32 path is held to, and the kernel route with
    # K4 replaced by its plain version (K4's own math, without the atomics)
    # is the one the kernel path is held to.  Float32 final logliks scatter
    # by up to 8.3e-4 around float64 on the card, and the route the kernel
    # shares with the reference kernel (gamma = exp(min(lg, 0))) ends a few
    # 1e-4 below the dense route (PERF.md, Findings), so the bounds are
    # rtol 1e-3 and kernel against dense plain is printed, not held.
    fc64 = dataclasses.replace(fc, src=fc.src.double())
    ll64 = hmm_gaussian.train(_as_float64(p_diag), fc64, EM_ITERS, use_kernels=False,
                              anneal=ANNEAL)[1].cpu().numpy()
    del fc64
    with mock.patch.object(k24, "hmm_estep", k24.hmm_estep_plain):
        ll_k4p = hmm_gaussian.train(p_diag, fc, EM_ITERS, use_kernels=True,
                                    anneal=ANNEAL)[1].cpu().numpy()
    torch.cuda.empty_cache()
    print(f"  float64 plain-path loglik per iteration: {ll64.tolist()}")
    print(f"  K4's plain version in the kernel route, loglik per iteration: {ll_k4p.tolist()}")
    ll, ll_p, ll_kp = float(lw[-1]), float(g_plain["lls"][-1]), float(ll_k4p[-1])
    print(f"  final loglik, kernel path against the dense plain path: {ll} vs {ll_p}, "
          f"rel {(ll - ll_p) / abs(ll_p):+.3e} (JAX reference {REFERENCE_GAUSS_LL})")
    for what, ll_f32 in (("kernel path", ll), ("plain path", ll_p),
                         ("K4's plain version", ll_kp)):
        rel = (ll_f32 - float(ll64[-1])) / abs(float(ll64[-1]))
        _check(abs(rel) <= 1e-3, f"{what}: final loglik within rtol 1e-3 of the float64 "
                                 f"plain path ({ll_f32} vs {ll64[-1]}, rel {rel:+.3e})")
    _check(abs(ll - ll_kp) <= 1e-3 * abs(ll_kp),
           f"kernel path: final loglik within rtol 1e-3 of K4's plain version in the "
           f"same route (rel {(ll - ll_kp) / abs(ll_kp):+.3e})")
    f1, f1_p = g_kern["prf"]["f1"], g_plain["prf"]["f1"]
    _check(abs(f1 - f1_p) <= 0.002, f"F1 within 0.002 of plain ({f1:.4f} vs {f1_p:.4f})")
    _check(abs(f1 - REFERENCE_GAUSS_F1) <= 0.005,
           f"F1 within 0.005 of the JAX reference {REFERENCE_GAUSS_F1} ({f1:.4f})")
    print(elapsed())

    # Gaussian EM and decode times (CUDA events, alternating)
    em = _alternate({
        "plain": lambda: hmm_gaussian.train(p_diag, fc, 2, use_kernels=False),
        "kernels": lambda: hmm_gaussian.train(p_diag, fc, 2, use_kernels=True),
    }, reps=1, rounds=2)
    gem_k, gem_p = em["kernels"] / 2, em["plain"] / 2
    print(f"  [{card}] Gaussian EM ms/iter (stretch shape, K=1), median of 4 runs of "
          f"2 iterations: kernel path {gem_k:.4f}, plain path {gem_p:.4f} "
          f"(all runs, ms per 2 iterations: {em['runs']})")
    p_fit = g_kern["params"]
    dec = _alternate({
        "plain": lambda: hmm_gaussian.align(p_fit, fc, use_kernels=False),
        "kernels": lambda: hmm_gaussian.align(p_fit, fc, use_kernels=True),
    }, reps=2, rounds=2)
    print(f"  [{card}] Gaussian decode (align, stretch shape) ms, median of 4 runs: "
          f"through K3 {dec['kernels']:.4f}, plain decoder {dec['plain']:.4f}")
    _profile(lambda: hmm_gaussian.em_step(p_fit, fc, use_kernels=True),
             "one Gaussian EM iteration", card)
    del g_kern, g_plain, p_fit
    print(elapsed())

    # --- path 3: the stretch recipe (VQ teacher, K=2), kernels then plain ---
    print(f"stretch recipe: init_vq_teacher(n_codes={N_CODES}, teacher_iters={EM_ITERS}, "
          f"seed_rounds=3, n_components=2, max_jump={MAX_JUMP}), {EM_ITERS} EM iterations, "
          f"anneal={ANNEAL}")
    recipe = {}
    for use_kernels in (True, False):
        _reset(kernels_all)
        t0 = time.perf_counter()
        pv = hmm_gaussian.init_vq_teacher(
            fc, max_jump=MAX_JUMP, n_components=2,
            generator=torch.Generator().manual_seed(SEED), n_codes=N_CODES,
            teacher_iters=EM_ITERS, seed_rounds=3, use_kernels=use_kernels,
        )
        torch.cuda.synchronize()
        teacher_launches = _counts(kernels_all)
        t_seed = time.perf_counter() - t0
        _reset(kernels_all)
        t0 = time.perf_counter()
        run = gaussian_path(fc, fg, pv, use_kernels=use_kernels)
        run["seconds"] = (t_seed, time.perf_counter() - t0)
        run["launches"] = (teacher_launches, _counts(kernels_all))
        recipe[use_kernels] = run
        print(f"  {'kernel' if use_kernels else 'plain'} path: seeding {t_seed:.2f} s, "
              f"EM + decode {run['seconds'][1]:.2f} s, loglik {run['lls'].tolist()}")
        print(f"    alignment {run['prf']}, boundary {run['boundary']}, "
              f"launches (teacher, Gaussian) {run['launches']}")
    r_k, r_p = recipe[True], recipe[False]
    teach, gauss = r_k["launches"]
    _check(teach["table_lookup"] > 0 and teach["hmm_estep_counts"] == EM_ITERS
           and teach["hmm_estep"] == 0 and teach["pair_counts"] == 0,
           "K1 launched in the VQ teacher, K2 once per EM iteration, K4 and K7 never")
    _check(gauss["hmm_estep"] > 0 and gauss["viterbi"] > 0,
           "K4 and K3 launched on the recipe's Gaussian EM and decode")
    _check(bool(np.all(np.isfinite(r_k["lls"]))), "recipe loglik finite")
    f1, f1_p = r_k["prf"]["f1"], r_p["prf"]["f1"]
    _check(abs(f1 - f1_p) <= 0.005, f"recipe F1 within 0.005 of plain ({f1:.4f} vs {f1_p:.4f})")
    _check(f1 >= 0.30, f"recipe F1 >= 0.30 ({f1:.4f}; the JAX package documents "
                       f"{DOCUMENTED_RECIPE_F1} for this config at N=4000)")
    print(f"  recipe boundary F1 (tolerance 1): kernel path {r_k['boundary']['f1']:.4f}, "
          f"plain path {r_p['boundary']['f1']:.4f}")
    del fc, fg, recipe, r_k, r_p
    torch.cuda.empty_cache()
    print(elapsed())

    # --- K5 parity and times at the pipeline's batch (one synthesis, used
    # by K5's phase and path 4) ---
    from multimodalworddiscovery_tpu_torch.scripts import run_pipeline as rp

    synth = rp.synthesize(PIPELINE_N, dev)
    print(f"pipeline corpus synthesized {elapsed()}")
    k5_r = k5_phase(card, synth)
    print(elapsed())

    # --- path 4: the waveform pipeline, kernels then plain ---
    pipe = pipeline_phase(card, kernels_all, synth)["launches"]
    extract_features_phase(here)
    del synth
    torch.cuda.empty_cache()
    print(elapsed())

    # --- paths 6 and 7: the DNN-HMM and CRF aligners ---
    crf = crf_phase(card, kernels_all, dev)
    torch.cuda.empty_cache()
    print(elapsed())

    # --- K8 and K8-bf16 at bench_kernels' sizes and on wide-range rows ---
    k8_r = k8_phase(card, dev)
    torch.cuda.empty_cache()
    print(elapsed())

    # --- path 8: the dense-caption discrete EM (K1 -> K4 -> K7), kernels then plain ---
    dense = dense_phase(card, kernels_all, dev)
    torch.cuda.empty_cache()
    print(elapsed())

    # --- above 160 states: K4, K4-bf16, K6 and K3 at S~200 and S~260, and
    # the discrete EM and decode at S~200 ---
    many = many_states_phase(card, kernels_all, dev)
    torch.cuda.empty_cache()
    print(elapsed())

    # --- path 9: the associative and blocked forwards through K8 ---
    assoc = assoc_phase(card, kernels_all, dev)
    print(elapsed())

    # --- the port's bench_kernels (counts, log_matmul) and bench_assoc ---
    launches_bench = bench_phase(here, kernels_all)
    torch.cuda.empty_cache()
    print(elapsed())

    runs = (launches_headline, launches_gauss, teach, gauss, pipe, launches_bf16, launches_k6,
            *crf["launches"].values(), dense["launches"], assoc["launches"], many["launches"])
    launches = {name: sum(r[name] for r in runs) for name in launches_headline}
    launches["log_matmul_bf16"] = launches_bench["log_matmul_bf16"]
    print(f"kernel launches, summed over the paths' kernel runs (K6: its entry-point run; "
          f"K8-bf16: bench_kernels' log_matmul entry, its entry point): {launches}")
    # K4's launch shapes: launches on the paths' kernel runs, time, bound and
    # plain time of each (K4-bf16: path 6's bf16 run at the CRF's S=8)
    crf_l = crf["launches"]
    k4_runs = {
        "S64": (k4_stretch, launches_gauss["hmm_estep"] + gauss["hmm_estep"], 0),
        "S128": (k4_128, dense["launches"]["hmm_estep"], 0),
        "S8_pipeline": (k4_s8["S8_pipeline"], pipe["hmm_estep"], 0),
        "S8_crf": (k4_s8["S8_crf"], sum(r["hmm_estep"] for r in crf_l.values()),
                   sum(r["hmm_estep_bf16"] for r in crf_l.values())),
        **{f"{k} (S={r['S']})": (r["k4"], many["launches"]["hmm_estep"] if k == "S~200" else 0,
                                 0) for k, r in many["shapes"].items()},
    }
    k4_shapes = {k: {"launches": n, "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
                 for k, (r, n, _) in k4_runs.items()}
    k4bf_shapes = {k: {"launches": nb, "ms": r["bf16_ms"], "plain_ms": r["bf16_plain_ms"],
                       **r["bf16_bound"]} for k, (r, _, nb) in k4_runs.items()}
    # K3's launch shapes: launches on the paths' kernel runs (S=12: paths 1
    # and 5; S=64: paths 2 and 3), time, bound and plain time of each
    k3_runs = {
        "S12": (k3_s12, launches_headline["viterbi"] + launches_bf16["viterbi"]),
        "S64": (k3_stretch, launches_gauss["viterbi"] + gauss["viterbi"]),
        "S128": (k3_128, dense["launches"]["viterbi"]),
        "S8_pipeline": (k4_s8["S8_pipeline"]["k3"], pipe["viterbi"]),
        "S8_crf": (k4_s8["S8_crf"]["k3"], sum(r["viterbi"] for r in crf_l.values())),
        **{f"{k} (S={r['S']})": (r["k3"], many["launches"]["viterbi"] if k == "S~200" else 0)
           for k, r in many["shapes"].items()},
    }
    k3_shapes = {k: {"launches": n, "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
                 for k, (r, n) in k3_runs.items()}
    # K2's and K2-bf16's: the headline (paths 1 and 5), the gate edge (no
    # path) and the VQ teacher (path 3's seeding)
    k2_runs = {"S12_headline": (errs, launches_headline["hmm_estep_counts"],
                                launches_bf16["hmm_estep_counts_bf16"]),
               "S64_gate": (errs_edge, 0, 0),
               "S64_teacher": (teacher, teach["hmm_estep_counts"], 0)}
    k2_shapes = {k: {"launches": n, **r["k2"]} for k, (r, n, _) in k2_runs.items()}
    k2bf_shapes = {k: {"launches": nb, **r["k2bf"]} for k, (r, _, nb) in k2_runs.items()}
    print(f"[{card}] K2 per launch shape: {json.dumps(k2_shapes)}")
    print(f"[{card}] K2-bf16 per launch shape: {json.dumps(k2bf_shapes)}")
    print(f"[{card}] K4 per launch shape: {json.dumps(k4_shapes)}")
    print(f"[{card}] K4-bf16 per launch shape: {json.dumps(k4bf_shapes)}")
    print(f"[{card}] K6 per shape (ms): "
          f"{json.dumps({k: r['k6_ms'] for k, (r, _, _) in k4_runs.items()})}")
    print(f"[{card}] K3 per shape: {json.dumps(k3_shapes)}")
    k8_big = k8_r[K8_SIZES[-1]]
    k8_errs = [r["err"] for r in k8_r.values()] + [
        e for r in assoc["shapes"].values() for e in (r["err"], r["prefix_err"])]
    kernels = [
        {"name": "table_lookup", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/counts.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/counts_pallas.py:92",
         "launches": launches["table_lookup"],
         "max_abs_err": max(errs["k1_err"], teacher["k1_err"]),
         "ms": k1_ms, "plain_ms": k1_plain_ms, **k1_bound, "library_ms": k1_library_ms},
        {"name": "hmm_estep_counts", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/hmm_estep_counts.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/hmm_fwdbwd_pallas.py:758",
         "launches": launches["hmm_estep_counts"],
         "max_abs_err": max(r["k2_err"] for r, _, _ in k2_runs.values()),
         **errs["k2"], "library_ms": None, "shapes": k2_shapes},
        {"name": "hmm_estep_counts_bf16", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/hmm_estep_counts.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/hmm_fwdbwd_pallas.py:758",
         "launches": launches["hmm_estep_counts_bf16"],
         "max_abs_err": max(r["k2bf_err"] for r, _, _ in k2_runs.values()),
         **errs["k2bf"], "library_ms": None, "shapes": k2bf_shapes},
        {"name": "viterbi", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/viterbi.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/viterbi_pallas.py:162",
         "launches": launches["viterbi"],
         "max_abs_err": max(r["err"] for r, _ in k3_runs.values()),
         "ms": k3_stretch["ms"], "plain_ms": k3_stretch["plain_ms"],
         "bound_ms": k3_stretch["bound_ms"], "bound_by": k3_stretch["bound_by"],
         "library_ms": None, "shapes": k3_shapes},
        {"name": "hmm_estep", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/hmm_estep.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/hmm_fwdbwd_pallas.py:580",
         "launches": launches["hmm_estep"],
         "max_abs_err": max(r["err"] for r, _, _ in k4_runs.values()),
         "ms": k4_stretch["ms"], "plain_ms": k4_stretch["plain_ms"],
         "bound_ms": k4_stretch["bound_ms"], "bound_by": k4_stretch["bound_by"],
         "library_ms": None, "shapes": k4_shapes},
        {"name": "hmm_estep_bf16", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/hmm_estep.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/hmm_fwdbwd_pallas.py:580",
         "launches": launches["hmm_estep_bf16"],
         "max_abs_err": max(r["bf16_err"] for r, _, _ in k4_runs.values() if "bf16_err" in r),
         "ms": k4_stretch["bf16_ms"], "plain_ms": k4_stretch["bf16_plain_ms"],
         **k4_stretch["bf16_bound"], "library_ms": None, "shapes": k4bf_shapes},
        {"name": "mfcc", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/mfcc.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/mfcc_pallas.py:93",
         "launches": launches["extract"] + launches["mfcc_from_frames"],
         "max_abs_err": k5_r["err"], "ms": k5_r["ms"], "plain_ms": k5_r["plain_ms"],
         "bound_ms": k5_r["bound_ms"], "bound_by": k5_r["bound_by"], "library_ms": None},
        {"name": "hmm_estep_remat", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/hmm_estep.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/hmm_fwdbwd_pallas.py:580",
         "launches": launches["hmm_estep_remat"], "max_abs_err": k4_stretch["k6_err"],
         "ms": k4_stretch["k6_ms"], "plain_ms": k4_stretch["k6_plain_ms"],
         "bound_ms": k4_stretch["bound_ms"], "bound_by": k4_stretch["bound_by"],
         "library_ms": None},
        {"name": "pair_counts", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/counts.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/counts_pallas.py:200",
         "launches": launches["pair_counts"],
         "max_abs_err": max(k7_head["err"], dense["k7"]["err"]),
         "ms": dense["k7"]["ms"], "plain_ms": dense["k7"]["plain_ms"],
         "bound_ms": dense["k7"]["bound_ms"], "bound_by": dense["k7"]["bound_by"],
         "library_ms": dense["k7"]["library_ms"]},
        {"name": "log_matmul", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/log_semiring.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/log_semiring.py:90",
         "launches": launches["log_matmul"], "max_abs_err": max(k8_errs),
         "ms": k8_big["ms"], "plain_ms": k8_big["plain_ms"], "bound_ms": k8_big["bound_ms"],
         "bound_by": k8_big["bound_by"], "library_ms": k8_big["library_ms"]},
        {"name": "log_matmul_bf16", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/log_semiring.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/log_semiring.py:90",
         "launches": launches["log_matmul_bf16"],
         "max_abs_err": max(k8_r[n]["bf16_err"] for n in K8_SIZES),
         "ms": k8_big["bf16_ms"], "plain_ms": k8_big["bf16_plain_ms"],
         "bound_ms": k8_big["bf16_bound"]["bound_ms"],
         "bound_by": k8_big["bf16_bound"]["bound_by"], "library_ms": k8_big["library_ms"]},
    ]
    print(f"total {elapsed()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
