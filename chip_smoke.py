#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodalworddiscovery_tpu_torch/csrc``
into ``build/``, checks each kernel against its plain PyTorch version at the
shapes the main paths give it, then drives twenty-one paths through the kernels
(paths 1-4, 6, 8, 10 and 12 also through the plain path) on the same card:

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
   counts log_matmul`` once each, with few repetitions;
10. Model-1 (BASELINE config #1) on the headline corpus (the reference's
    ``model1_align`` Tt6 shape): 10 EM iterations (the final loglik held
    to the JAX reference's), align through K1, segmentation and the four
    metric families, the decode through K1 equal to the plain gather's, F1
    against the JAX reference's value; the concept-space decode against
    the dense one there and at the Tt32 shape (N=2048, 24-32 concepts);
11. config #3's attention aligner on the N=8192 corpus of the reference's
    ``bench_models`` at dim 128: B=512 AdamW minibatch steps, unguided and
    guided by the discrete HMM teacher (``hmm.train`` through K1 + K2; each
    batch's guide from K4's gamma on K1's emissions), the guided run's F1
    above the unguided one's; then ``configs/attention_guided_frames.py``
    (N=800, 13-dim frames) with its Gaussian teacher (15 EM iterations
    through K4, the guide from K4 at every step);
12. grounding (B=256 Adam minibatch steps on the same corpus, its pooled
    recall@5 rising) and pooled retrieval (pool 32, both directions) for
    Model-1 through K1 (against its plain route), the discrete HMM and
    grounding, with recall@1/5/10;
13. segmental k-means and its GMM variant on 13-dim frames at the
    pipeline's scale (N=2000, 10 iterations each), boundary recall against
    a uniform segmentation, and the DTW coherence of the gold segments of
    ``test_golden_dtw_coherence``'s corpus against tests/golden_metrics.json;
14. the image branch, whose convolutions and products are cuDNN's and
    cuBLAS's (no Pallas kernel in the reference; none of K1-K8 runs):
    VGG16 at full width (1000 classes, fc 4096, 224 x 224 crops; random
    weights from a CPU generator) on 16 rendered images of 128 x 128, region
    embeddings of 8 boxes each and the images' concepts after the resize to
    224, held on 2 images to the same weights on the CPU (rtol 1e-3, atol
    1e-4 x the largest |ref|), ms per image and crops/s;
    ``scripts/train_detector`` at its defaults (256 images, 400 steps; loss
    falling, train and held-out recall@0.5 >= 0.7); and
    ``scripts/image_pipeline.run_image_pipeline`` at its defaults (N=400:
    render, detector, proposals, crops, grounding): detector recall and
    alignment accuracy within 0.05 of the JAX reference from the same
    initial weights (tests/image_reference.py), recall@1/5/10 printed
    beside it; and its grounding stage run from the reference's own
    proposals: the loss over steps 0-5 within rtol 1e-4 of the JAX
    stage's, alignment accuracy within 0.05;
15. the end-to-end CRF on minibatches through K4 (the port's
    bench_kernels hmm_crf_minibatch_step row: N=2048, B=256, learned
    transitions, 40 steps; and tests/test_hmm_crf.py:172's size, N=80,
    B=40, accuracy > 0.9), K4 checked at each run's batch shape and K3 at
    its decode; then the dense ``hmm_core.viterbi`` at the reference's
    viterbi_dense rows (S12 N=8000, S128 N=512) after one EM step, its
    emissions from K1, against ``viterbi_factored`` through K3 (paths
    equal except at counted ties, scores within rtol 1e-5), ms per decode.
16. out-of-core and bucketed discrete EM: ``scripts/bench_stream.py``'s
    corpus (the headline family at N=65536) written to disk in shards of
    8192; ``data.stream.train_streaming(hmm, ...)`` at prefetch 1 and 2 (K1
    + K2 once a shard an iteration) against resident ``hmm.train`` (K1 + K2
    at N=65536), 5 iterations, logliks within rtol 1e-5 and parameters
    within atol 1e-4 (tests/test_stream.py:68-73), Model-1 the same way
    over the same shards; bench_stream's rows (ms per iteration, overlap
    efficiency); then ``train_bucketed`` on the headline corpus with edges
    [12, 20] (K1 + K2 per bucket, K3 per bucket in ``align_bucketed``)
    against resident EM: logliks rtol 1e-4, log_emit atol 1e-3, decode
    agreement > 0.999, padding waste and ms per iteration printed;
17. the stretch recipe out of core: path 3's corpus in shards of 1000 with
    gold, ``init_vq_teacher_streaming`` (64 codes from a 65,536-frame
    reservoir, the teacher's EM over the code shards through K1 + K2, 3
    seeding rounds through K1 + K4, K=2, max_jump 5), 10 streamed annealed
    Gaussian EM iterations (K4 once a shard an iteration), decode shard by
    shard (K3): F1 >= 0.30 and within 0.10 of path 3's resident recipe;
    from path 3's initial parameters 2 streamed iterations against 2
    resident ones (logliks rtol 1e-5; the means within the resident float32
    run's own distance from the same EM in float64: their sums run over
    1.6M frames, where addition order alone moves them by about 2e-4), on
    float32 shards and on float16 shards (under 0.55x the bytes) against
    the float16-rounded corpus;
18. the streamed gradient trainers: ``hmm_dnn.train_streaming`` on the
    DNN-HMM path's corpus in 4 shards (K4 once a shard an iteration), held
    to the JAX package's streamed run from the same initial parameters
    (``tests/stream_reference.py``; both collapse there, which is printed),
    and at tests/test_stream.py:854-882's own configuration held to its
    bounds (loglik rising, accuracy at least the resident trainer's minus
    0.05); ``train_minibatch_streaming`` of the attention step on path 11's
    corpus in 4 shards (B=512, 60 steps): the loss falls, and a run resumed
    at step 30 gives the uninterrupted run's losses within rtol 1e-5.
    Shards go to a temporary directory removed at the end.
19. the parallel layer (``parallel/``, ``core/mesh``, ``core/collectives``).
    19a at world size 1 over NCCL (a one-rank group in this process, its
    ``file://`` store under ``build/chip_smoke/``, destroyed afterwards):
    ``make_shard_map_em_step(hmm)`` for 10 iterations on path 1's corpus (K1
    + K2) and the decode (K3) against path 1 (logliks rtol 1e-5, log_emit
    and log_jump atol 1e-4, decode agreement > 0.999), 2 annealed
    iterations of ``make_shard_map_em_step(hmm_gaussian)`` on path 2's
    corpus (K4) against path 2's (rtol 1e-5), ``train_streaming_multihost``
    over path 16's 8 shards (one rank, 8 rounds) against path 16's resident
    EM (rtol 1e-5, atol 1e-4), and ``estep_time_sharded`` on one rank (K8).
    19b on 2 spawned ranks over gloo with CUDA tensors on the one card
    (NCCL refuses two ranks on one device): the headline EM at N=4000 a
    rank against path 1 with 19a's bounds; ``estep_time_sharded`` at path
    9's S64 shape (N=256, Ts=147 padded to 148; K8 for the composes)
    against K4 (logZ rtol 1e-4, gamma at valid positions and xi rtol / atol
    1e-3); one data-parallel attention step at path 11's configuration
    (B=512, 256 rows a rank) and one grounding step (B=256) against one
    process on the same rows (parameters rtol 1e-5, atol 1e-6; weights
    whose gradient is rounding noise within a learning rate), then 20
    attention steps with a falling loss; ``reservoir_frames_multihost`` on
    path 17's shards equal to ``_reservoir_frames``; and
    ``train_streaming_multihost`` over path 16's shards (4 rounds of 2)
    against path 16 with 19a's bounds.  The ranks report their launch
    counts; ms per data-parallel EM iteration at world size 1 and 2 and the
    all-reduce's share of it, and the time-sharded E-step against K4, are
    printed.
20. the port's CLI, ``mwd-torch``, as a user runs it: each command through
    ``cli.main`` in this process, at full width.  20a:
    ``configs/hmm_mini.py`` with bench.py's corpus as overrides (N=8000,
    S=12, seed 0), 10 iterations (K1 + K2), each iteration's loglik in
    ``train_metrics.jsonl`` within rtol 1e-5 of path 1's, the CLI's ms per
    iteration printed beside path 1's; ``align``, ``segment``, ``evaluate``
    (alignment F1 within 0.002 of path 1's), ``retrieve --pool 100``,
    ``export`` (the JAX export's keys) and ``lexicon`` (K3); K3 against the
    plain decoder on the trained parameters, differing utterances and ties
    counted (the measurement behind the CLI's decode rule); a run cut at 5
    iterations and resumed to 10 giving the uninterrupted logliks; and
    ``python -m ...cli train`` with ``train.profile=true`` in a fresh
    process, whose Chrome trace must name K1's and K2's kernels.  20b:
    ``configs/stretch_hubert_clip.py`` as written (N=4000, Ts=401, S=64,
    the VQ teacher through K1 + K2, its seeding and 4-chunk annealed EM
    through K1 + K4, ``data_parallel`` on a world of one NCCL rank that the
    CLI starts), then ``evaluate`` with DTW and pooled retrieval (K3): it
    draws path 3's seeding numbers, so its first loglik is held to path 3's
    kernel run (rtol 1e-4) and its F1 to path 3's (within 0.005; >= 0.30);
    the chunks sum the counts in another order, which the annealing
    amplifies, so the final loglik is printed beside path 3's.  20c: ``shard`` of 20a's corpus in
    shards of 2000, streamed ``train``, ``align`` and ``evaluate`` (K1, K2,
    K3 a shard): logliks within rtol 1e-5 and F1 within 1e-6 of 20a's, the
    streamed decode equal to the resident decode of the same checkpoint;
    K1, K2 and K3 checked at the shard's shape.  20d:
    ``scripts/run_pipeline_fullscale`` at 16,384 utterances in shards of
    4096, 5 iterations (K5 a sub-batch of 2048, K4 and K3 a shard), its
    stage 6 (streamed equals resident) passing, stage times and host RSS
    printed; K5 checked at its sub-batch, K4 and K3 at its shard.
21. the port's study and parity drivers through their ``main()``, at their
    own sizes, each leg in its own launch window: 21a
    ``scripts/exp_gauss_dense`` (N=1000, K=2, D=64, 10 iterations, 4
    chunks: K1 + K2 for the discrete control and the VQ teacher, K1 + K4 for
    the teacher's posteriors, K4 for the chunked EM, K3 for the chunked
    decodes), every variant within 0.05 of the JAX package's documented
    frame accuracy (docs/PERFORMANCE.md:426-438) and ceiling > ceiling+EM >
    recipe > anneal > diagonal; 21b ``scripts/exp_ceiling_fullscale``
    (N=4000, S=64, 8 chunks: K4, K3) within 0.03 of the JAX package's own
    run in float32 on the CPU (REFERENCE_CEILING_CPU), the ceiling also of
    its documented value (the documented +EM value, taken on a TPU with the
    densities' products in bf16 passes, printed beside); 21c
    ``scripts/exp_crf40k`` (N=40,000, B=512, 500 steps, both transition
    modes: K4 on every batch, K3 over 8 chunks) within 0.02 of the
    documented accuracies, e2e_trans >= em_trans, ms per step by CUDA
    events; 21d ``scripts/self_train`` at its defaults (N=800, 2
    rounds: K4 for the teacher and the guide, K3 for its decode), the
    teacher within 0.03 of 0.820 and the re-seeded teacher's gain at least
    half the documented one, then a B=512 minibatch leg (the guide through
    K4 per batch); 21e ``scripts/reference_parity`` on a reference mocked
    from the port's HMM on bench.py's corpus (parity, token agreement 1.0),
    on its dump shifted by one target position (diverged) and on an empty
    directory; and bench.py's oracle corpus (N=512, 4 iterations) through
    ``hmm.train`` (K1 + K2) against the port's float64 ``NumpyHMM``, which
    runs meanwhile in a process of its own (logliks rtol 1e-5; its
    utt*iter/s on this host printed as information).  Each new K1-K4 launch
    shape is checked against plain; K4 at 21a's chunk is held at the
    trained parameters, and at the flat start (per-utterance logZ near
    -24,000, where one float32 ulp moves gamma by 0.2%) only its logZ and
    loglik are held.

K1, K2 and K2-bf16 are checked and timed at the headline shape, at K2's
gate edge and at the VQ teacher's shape (the recipe's code corpus: N=4000,
Ts=401, S=64, V_src=64), where the teacher's EM trajectory is also held
against the plain path's and one of its EM iterations is profiled; the
JSON line gives K2's and K2-bf16's launches, time and bound per launch
shape, K3's at each shape it decodes, and K1's at each of its launch shapes
(bit-equal to the plain gather, CUDA-event and device time, bound, the
library double-index gather); K1, K2, K3 and K4 are also checked at the
shapes paths 10-12 give them (Model-1's two shapes, path 11's teacher
corpus, guide batch and guided frames, pooled retrieval's chunk) and at
those of paths 16-18 (the N=65536 corpus and its N=8192 shard, each
bucket and its decode, the stretch recipe's code and frame shards of
1000, the DNN-HMM's shards) and of path 19 (a rank's half of the headline
corpus), and the script fails unless every launch of
K1-K4 on the paths lies at a checked shape.  K4,
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
and log-mels, at n_fft 512 and 1024 (its FFT branch) and 400 (its
direct-DFT branch), and on 1000 frames; ``torch.fft.rfft`` of the windowed
frames is timed beside it as a yardstick of the spectrum alone; the
``extract_features speech`` command runs once on a small .npz under
``build/``.  K7 is checked on K4's posteriors at the headline shape and at
path 8's, against its plain version and against the plain posteriors
summed in float64, and with a table too wide for shared memory
(n_cols=4096) against its narrow result; K8 at 512 x 512 and
1024 x 1024 from 5 * normal, on the even / odd step-matrix slices that path
9's scan hands it, on a synthetic row whose largest product lies 250 nats
below its maximum (where the factored form underflows), and on the prefix
products of path 9's step matrices (their widest row's span and the
factored form's error there are printed), each with the share of elements
its underflow guard took and summed again (and over the forwards'
combines); path 9's library time is the broadcast torch.logsumexp in batch
chunks; K8-bf16 against its plain bf16 version, against K8 and as
rounding.  K5 also runs at n_fft 4096 and at 300 mels (past its old
limits) against plain.

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
import pathlib
import shutil
import subprocess
import sys
import tempfile
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
# K5's n_fft in its phase: the pipeline's (its FFT branch), the direct-DFT
# branch's 400 (an unpadded 25 ms window), a 64 ms window's 1024, and two
# odd ones through the unfolded direct DFT: 401, and 255 (with a 255-sample
# window)
K5_N_FFT = (512, 400, 1024, 401, 255)
# past the run kernel's old limits (n_fft 2048, 256 mels): a 256 ms window
# (a frame a warp) and 300 mels at the pipeline's n_fft
K5_LARGE = ((4096, None), (512, 300))
# the JAX package's documented F1 of the stretch recipe at N=4000
# (docs/PERFORMANCE.md:457-461); it draws other random numbers, so only
# printed beside this run's value
DOCUMENTED_RECIPE_F1 = 0.431
ZERO_LENGTH_PAD = 4  # zero-length utterances appended in the parity phases
PROFILE_LEAD_KERNELS = 32  # marker kernels opening a profile's window
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
# path 10: Model-1 (BASELINE config #1) at the reference's model1_align
# shapes, bench_kernels.MODEL1_SHAPES (its Tt6 row is HEADLINE); paths 11-13
# take their corpora, widths, batches and pool from bench_kernels too.
# Alignment F1 of the JAX reference on the CPU after 10 EM iterations from
# model1.init (deterministic) on the headline corpus, then model1.align:
# tests/model1_reference.py (P 0.87923, R 0.89028)
REFERENCE_MODEL1_F1 = 0.88472
REFERENCE_MODEL1_LL = -353686.75  # its loglik at the 10th iteration
# paths 11 and 12: steps on bench_kernels.MODELS_CORPUS
ATT_STEPS = 200  # cut from config #3's 300 steps
GROUND_STEPS = 150
TEACHER_ITERS = 10  # the discrete teacher's EM iterations (the guide's default is 15)
# configs/attention_guided_frames.py on core/config.py's base_config (seed
# 0, max_jump 3), copied here: configs/ imports the JAX package.  The corpus
# as the CLI's _load_data builds it; the Gaussian teacher seeded seed + 1.
GUIDED_FRAMES = dict(n_utterances=800, n_concepts=40, n_phones=48, min_concepts=2,
                     max_concepts=4, seed=0)
GUIDED_FRAMES_FEAT = dict(feat_dim=13, seed=0)
GUIDED_TEACHER_ITERS = 15
GUIDED_STEPS = 60  # cut from the config's 400
SEGKMEANS_ITERS = 10  # path 13: on bench_kernels' SEGKMEANS_CORPUS frames
# tests/test_golden_metrics.py test_golden_dtw_coherence: its corpus and
# tests/golden_metrics.json "dtw_gold_segments", held within rtol 0.02
# (atol 1e-3) as that test holds them
DTW_CORPUS = dict(n_utterances=60, seed=42)
DTW_FRAMES = dict(feat_dim=8, noise=0.05, seed=42)
DTW_MAX_SEG_LEN = 16
GOLDEN_DTW = {"within": 0.0787, "across": 6.9912, "ratio": 0.0113}
# path 14, the image branch.  (a) VGG16 at full width (1000 classes, fc
# 4096, 224 x 224 crops), random-init from a CPU generator seeded 0, on 16
# rendered images of 128 x 128 with 8 boxes each (images_for_corpus on a
# corpus of 8 concepts an image); the card held to the same weights on the
# CPU on 2 of them, rtol 1e-3 and atol 1e-4 x the largest |ref|
VGG_IMAGES = dict(n_utterances=16, n_concepts=12, min_concepts=8, max_concepts=8, seed=0)
VGG_IMAGE_SIZE = 128
VGG_CPU_IMAGES = 2
# (b) scripts/train_detector at its defaults: train and held-out recall@0.5
# at least tests/test_detector.py:116's bound; the JAX package documents
# 0.96 / 0.86 for its CPU run of 64 images and 300 steps
# (scripts/train_detector.py:10, docs/ARCHITECTURE.md:10)
DETECTOR_MIN_RECALL = 0.7
DOCUMENTED_DETECTOR_RECALL = (0.96, 0.86)
# (c) run_image_pipeline at its defaults (N=400, 12 concepts, 64 x 64, 300
# detector steps, 300 grounding steps, 8 proposals, crop 16) against the
# JAX package's steps of scripts/image_pipeline.py on the CPU from the
# port's initial detector and grounding weights (tests/image_reference.py,
# 423 s on the CPU).  End to end, the detector recall and the alignment
# accuracy are held within IMAGE_TOL.  Recall@k is printed, not held: 300
# full-batch Adam steps amplify float32 rounding (Adam's step on a gradient
# that is zero up to rounding is noise of the learning rate's size), and
# from the same proposals the JAX package and the port on the same CPU end
# 0.09 apart in recall@10 i2c (PERF.md §6).  Then the port's grounding
# stage (score_proposals) runs from the reference's own proposals
# (IMAGE_PROPOSALS, written by tests/image_reference.py --proposals-out):
# its loss over steps 0-5, before the rounding has grown, within
# GROUNDING_LOSS_RTOL of the JAX stage's, and its alignment accuracy within
# IMAGE_TOL.  The README documents detector recall 0.895 and alignment
# accuracy 0.59 (README.md:68).
REFERENCE_IMAGE = {"detector_recall@0.5": 0.895, "alignment_acc": 0.555,
                   "recall@1_c2i": 0.117, "recall@1_i2c": 0.047, "recall@5_c2i": 0.367,
                   "recall@5_i2c": 0.153, "recall@10_c2i": 0.55, "recall@10_i2c": 0.332}
IMAGE_TOL = 0.05
# the JAX stage's grounding loss at steps 0-5 from IMAGE_PROPOSALS
# (tests/image_reference.py, the first of "grounding_loss_steps_0_10"; by
# step 10 the rounding has grown to 4.2e-5 on the card)
REFERENCE_GROUNDING_LOSS = [1.0009301900863647, 0.9910921454429626, 0.9735208749771118,
                            0.9496217966079712, 0.9271820187568665, 0.9009367227554321]
GROUNDING_LOSS_RTOL = 1e-4
IMAGE_END_TO_END = ("detector_recall@0.5", "alignment_acc")
IMAGE_PROPOSALS = os.path.join("tests", "image_reference_proposals.npz")
README_IMAGE = {"detector_recall@0.5": 0.895, "alignment_acc": 0.59}
# path 15: the CRF on minibatches (bench_kernels' hmm_crf_minibatch_step
# row, and tests/test_hmm_crf.py:172's size: N=80, seed 41, B=40, the
# port's weights and draws seeded 0, as tests/test_torch_core_helpers.py),
# then the dense Viterbi at the reference's viterbi_dense rows
# (scripts/bench_kernels.py:320-327: HEADLINE, and DENSE's S=128)
CRF_MB_STEPS = 40
CRF_MB_REF = dict(corpus=dict(n_utterances=80, seed=41),
                  frames=dict(feat_dim=12, noise=0.1, seed=41), batch=40, min_acc=0.9)
VITERBI_DENSE_ROWS = {"S12": HEADLINE, "S128": DENSE}
# path 16: scripts/bench_stream.py's corpus (the headline family at N=65536)
# in shards of 8192, 5 EM iterations (tests/test_stream.py's bounds); the
# headline corpus bucketed at source lengths 12 and 20
STREAM = dict(n_utterances=65536, n_concepts=60, n_phones=48, min_concepts=3, max_concepts=6,
              seed=0)
STREAM_SHARD = 8192
STREAM_ITERS = 5
BUCKET_EDGES = [12, 20]
# path 17: path 3's corpus in shards of 1000; path 18: the DNN-HMM path's
# corpus in 4 shards, and path 11's in 4 shards for 60 attention steps, the
# second half resumed from the state after 30
STRETCH_SHARD = 1000
DNN_SHARDS = 4
# the JAX package's streamed DNN-HMM at path 18's configuration from the
# port's initial parameters, and its resident trainer's accuracy:
# tests/stream_reference.py.  The streamed trainer collapses there (loglik
# to about 0.1, every frame decoded to NULL)
REFERENCE_STREAM_DNN = {"loglik": [13198.3125, 1339.096435546875, 3.6383719444274902,
                                   0.1300397515296936, 0.07324731349945068,
                                   0.06586867570877075, 0.0770372748374939,
                                   0.08069294691085815, 0.0727548599243164,
                                   0.09100145101547241],
                        "positional_accuracy": 0.0, "resident_accuracy": 0.9534108584549292}
# tests/test_stream.py:854-882's configuration: its 30-utterance corpus and
# frames, hidden 64, shards of 10, 5 iterations
STREAM_TEST_CORPUS = dict(n_utterances=30, n_concepts=10, n_phones=16, seed=3)
STREAM_TEST_FRAMES = dict(feat_dim=8, noise=0.1, seed=0)
STREAM_TEST_MODEL = dict(hidden=64)
STREAM_TEST_SHARD = 10
STREAM_TEST_ITERS = 5
ATT_STREAM_SHARDS = 4
ATT_STREAM_STEPS, ATT_RESUME = 60, 30
# path 19: the parallel layer.  19a at world size 1 over NCCL: path 1's EM
# (make_shard_map_em_step), 2 of path 2's annealed Gaussian iterations and
# path 16's streamed EM (train_streaming_multihost).  19b on 2 ranks over
# gloo with CUDA tensors on the one card (NCCL refuses two ranks on one
# device): path 1's EM at N=4000 a rank, the time-sharded E-step at path
# 9's S64 shape (Ts=147 padded to 148) against K4, one data-parallel
# attention step at path 11's configuration (B=512, 256 rows a rank) and
# one grounding step (B=256) against one process on the same rows, then
# PAR_ATT_STEPS attention steps, the merged frame reservoir of path 17's
# shards and path 16's streamed EM in 4 rounds of 2 shards
PAR_RANKS = 2
PAR_GAUSS_ITERS = 2
PAR_ATT_STEPS = 20
PAR_SEQ_PAD = 148
PAR_RESERVOIR = 65536
PAR_SEQ_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_parallel.py:177's bounds, tightened


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


def _json_safe(x):
    """``x`` with every non-finite float (a device time the profiler's
    trace did not keep) as None, so the line stays strict JSON."""
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    return None if isinstance(x, float) and not math.isfinite(x) else x


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, ops: float, bf16_ops: float = 0.0) -> dict:
    """The least time the card could take: ``scripts/bench_kernels.bound``
    at one H100 SXM's data-sheet rates.  The bf16 variants' products take
    bf16 operands and sum in float32, which the card runs at the bf16
    tensor-core rate (the kernels here run them on float32 FMAs all the
    same); their xi update's multiply by the float32 exp(base0) stays at
    the float32 rate."""
    from multimodalworddiscovery_tpu_torch.scripts.bench_kernels import bound

    return bound(nbytes, ops, bf16_ops)


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

    # and against the dense plain E-step (the use_kernels=False route), its
    # posteriors summed in float64 as _exact_counts does: the float32 scatter's
    # own error at S=64 and Ts~400 comes within a factor of two of the bound,
    # and its atomics make it vary from run to run
    gamma, wc_d, logz_d = hmm_core.estep(
        params.log_jump, params.log_p0, params.max_jump,
        hmm._log_emissions(params, corpus, concepts), corpus, use_kernels=False,
    )
    counts_d = pair_counts(gamma.double(), corpus.src, concepts, v_src, v_trg)
    print(f"  K2 counts: max abs err {_max_abs(counts, counts_d)} against the dense route's "
          f"posteriors summed in float64, its float32 scatter's own "
          f"{_max_abs(pair_counts(gamma, corpus.src, concepts, v_src, v_trg), counts_d)}")
    del gamma
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


def k4_check(name, inputs, reps: int) -> dict:
    """K4 alone against its plain version (``_k4_checks``) at a launch
    shape where only the float32 kernel runs, timed with its plain version
    and its bound; K4-bf16's errors there are printed, not held.
    ``inputs`` as ``k4_parity``'s."""
    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k4

    n, ts, s = inputs[4].shape
    print(f"K4 at {name}: N={n} (incl. {ZERO_LENGTH_PAD} empty), Ts={ts}, S={s}")
    out = k4.hmm_estep(*inputs)
    errs = _k4_checks("K4", out, k4.hmm_estep_plain(*inputs), ZERO_LENGTH_PAD)
    bf = k4.hmm_estep(*inputs, dot_dtype="bfloat16")
    want = k4.hmm_estep_plain(*inputs, dot_dtype="bfloat16")
    print(f"  K4-bf16 there (not launched at this shape; printed): max abs err against its "
          f"plain bf16 version logZ {_max_abs(bf[2], want[2])}, gamma "
          f"{_max_abs(bf[0], want[0])}, xi {_max_abs(bf[1], want[1])}; against K4 logZ "
          f"{_max_abs(bf[2], out[2])}, gamma {_max_abs(bf[0], out[0])}")
    del bf, want
    bound = _estep_bound(_nbytes(*inputs, *out), inputs[5], s, bf16=False)
    return ({"err": max(errs.values()), "ms": _gpu_ms(lambda: k4.hmm_estep(*inputs), reps),
             "plain_ms": _gpu_ms(lambda: k4.hmm_estep_plain(*inputs), max(reps // 10, 1))}
            | bound)


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
    times = {"k1": k1_check("the VQ teacher's shape", p0.log_emit, codes.src, concepts, 20)}
    print(f"  [{card}] at the VQ teacher's shape: K1 table_lookup kernel "
          f"{times['k1']['ms']:.4f} ms (device {times['k1']['device_ms']:.4f}), plain "
          f"{times['k1']['plain_ms']:.4f} ms; K2 hmm_estep_counts kernel "
          f"{errs['k2']['ms']:.4f} ms, plain {errs['k2']['plain_ms']:.4f} ms")
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


def _profile(fn, what: str, card: str) -> dict[str, float]:
    """Device time by kernel family (returned, ms) and device idle share of
    ``fn()`` (torch.profiler), after one run outside the profiler.  The
    window opens with PROFILE_LEAD_KERNELS short marker kernels (ATen's
    spin_kernel, left out of the sums): the trace loses the first kernels
    of its window, more of them the older the process (none at this
    script's first profile, all 8 markers at its last; the pipeline's
    frontend, K5 and its small kernels, went missing so, while a fresh
    process traced them, and 50 ms of idle time ahead of them did not
    bring them back).  How many markers the trace kept is printed; none
    kept means the profiled run may have lost kernels too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"K1 lookup": ("mwd_table_lookup",), "K7 pair counts": ("mwd_pair_counts",),
                "K8 log_matmul": ("mwd_lm_",),
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
        if (e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0
                or "spin_kernel" in e.key):
            continue
        ms = e.self_device_time_total / 1e3
        busy += ms
        kernels += e.count
        key = e.key.lower()
        fam = next((f for f, tags in families.items() if any(t in key for t in tags)), "other")
        sums[fam] += ms
    if busy == 0.0:
        print(f"  [{card}] profile of {what}: no device time in the trace (not measured)")
        return sums
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
    kept = sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" in e.key)
    print(f"    the trace kept {kept} of its {PROFILE_LEAD_KERNELS} marker kernels"
          + ("" if kept else " (the profiled run may have lost its first kernels)"))
    return sums


def k5_phase(card: str, synth) -> dict:
    """K5 against its plain version on the card at the pipeline's batch
    (``synth``, from ``run_pipeline.synthesize``, with the edge waveforms
    appended), for MFCCs and log-mels, at the pipeline's n_fft (512, the
    FFT branch) and at 400 (the direct-DFT branch) and 1024, and on 1000
    frames (not a multiple of a block's run); then both timed at the
    pipeline's batch, with the bound of that call, the direct branch's time
    at n_fft 400, and ``torch.fft.rfft`` of the windowed frame tensor as a
    yardstick of the spectrum alone (``spectrum_library_ms``; timed only,
    the port never calls it)."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.frontend import speech
    from multimodalworddiscovery_tpu_torch.ops import mfcc as k5
    from multimodalworddiscovery_tpu_torch.scripts import run_pipeline as rp
    # the MFCC function's operations, its DFT counted as a real FFT
    from multimodalworddiscovery_tpu_torch.scripts.bench_kernels import mfcc_ops

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
    for n_fft in K5_N_FFT:
        cfg_n = dataclasses.replace(cfg, n_fft=n_fft, win_length=min(cfg.win_length, n_fft))
        for kind in speech.KINDS:
            what = f"K5 {kind} n_fft {n_fft} ({'FFT' if k5.uses_fft(n_fft) else 'direct DFT'})"
            before = k5.extract.launches
            got, fl = k5.extract(wav, wav_len, cfg_n, kind)
            want, fl_p = k5.extract_plain(wav, wav_len, cfg_n, kind)
            torch.cuda.synchronize()
            _check(k5.extract.launches == before + 1, f"{what}: launched")
            edges = [0, 0, 1, 1] if cfg_n.win_length == 400 else [0, 1, 1, 1]
            _check(torch.equal(fl, fl_p) and fl[-len(EDGE_WAV_LENS):].tolist() == edges,
                   f"{what}: frame lengths equal to the plain version's, {edges} at the edges")
            valid = torch.arange(got.shape[1], device=dev)[None, :] < fl[:, None]
            key = kind if n_fft == cfg.n_fft else f"{kind} n_fft {n_fft}"
            errs[key] = _max_abs(got[valid], want[valid])
            _check(torch.allclose(got[valid], want[valid], **MFCC_TOL),
                   f"{what} {tuple(got.shape)}: valid frames within rtol 1e-3 atol 2e-3 of "
                   f"plain (max abs err {errs[key]})")
            del got, want
    large = {}
    for n_fft, n_mels in K5_LARGE:
        cfg_n = dataclasses.replace(cfg, n_fft=n_fft, n_mels=n_mels or cfg.n_mels)
        key = f"n_fft {n_fft}" if n_mels is None else f"n_mels {n_mels}"
        for kind in speech.KINDS:
            what = f"K5 {kind} {key}"
            before = k5.extract.launches
            got, fl = k5.extract(wav, wav_len, cfg_n, kind)
            want, _ = k5.extract_plain(wav, wav_len, cfg_n, kind)
            _check(k5.extract.launches == before + 1, f"{what}: launched")
            valid = torch.arange(got.shape[1], device=dev)[None, :] < fl[:, None]
            errs[f"{kind} {key}"] = err = _max_abs(got[valid], want[valid])
            _check(torch.allclose(got[valid], want[valid], **MFCC_TOL),
                   f"{what} {tuple(got.shape)}: valid frames within rtol 1e-3 atol 2e-3 of "
                   f"plain (max abs err {err})")
            del got, want
        large[key] = (cfg_n, {
            "ms": _gpu_ms(lambda: k5.extract(wav[:PIPELINE_N], wav_len[:PIPELINE_N], cfg_n), 3),
            "plain_ms": _gpu_ms(lambda: k5.extract_plain(wav[:PIPELINE_N], wav_len[:PIPELINE_N],
                                                         cfg_n), 2)})
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
    windowed = (speech.frame_signal(speech.preemphasize(wav, cfg.preemphasis), cfg)
                * torch.as_tensor(speech.hann_window(cfg.win_length), device=dev))
    windowed = windowed.reshape(-1, cfg.win_length)
    cfg_400 = dataclasses.replace(cfg, n_fft=400)
    r = {"err": max(errs.values()),
         "ms": _gpu_ms(lambda: k5.extract(wav, wav_len, cfg), 10),
         "plain_ms": _gpu_ms(lambda: k5.extract_plain(wav, wav_len, cfg), 3),
         "spectrum_library_ms": _gpu_ms(lambda: torch.fft.rfft(windowed, n=cfg.n_fft, dim=-1), 10),
         "direct_400_ms": _gpu_ms(lambda: k5.extract(wav, wav_len, cfg_400), 3),
         "direct_400_plain_ms": _gpu_ms(lambda: k5.extract_plain(wav, wav_len, cfg_400), 3)}
    del windowed
    r |= _bound(_nbytes(wav, wav_len, feats, fl),
                mfcc_ops(cfg, "mfcc", feats.shape[0] * feats.shape[1], wav.numel()))
    r["direct_400_bound_ms"] = _bound(_nbytes(wav, wav_len, feats, fl), mfcc_ops(
        cfg_400, "mfcc", feats.shape[0] * feats.shape[1], wav.numel()))["bound_ms"]
    m = feats.shape[0] * feats.shape[1]
    for key, (cfg_n, t) in large.items():
        t["bound_ms"] = _bound(_nbytes(wav, wav_len, feats, fl), mfcc_ops(
            cfg_n, "mfcc", m, wav.numel()))["bound_ms"]
        r[key.replace(" ", "_")] = t
        print(f"  [{card}] K5 extract at {key} (pipeline batch, mfcc): kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
    print(f"  [{card}] K5 extract at N={PIPELINE_N}, L={wav.shape[1]} ({m} frames, mfcc): "
          f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
          f"ms ({r['bound_by']}); torch.fft.rfft of the windowed frames (the spectrum alone) "
          f"{r['spectrum_library_ms']:.4f} ms; the direct-DFT branch at n_fft 400: kernel "
          f"{r['direct_400_ms']:.4f} ms, plain {r['direct_400_plain_ms']:.4f} ms, bound "
          f"{r['direct_400_bound_ms']:.4f} ms")
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

    sums = _profile(after_synthesis, f"the waveform pipeline after synthesis (frontend, "
                                     f"{PIPELINE_ITERS} EM iterations, decode, metrics)", card)
    print(f"  K5 in the pipeline's trace: {sums['K5 mfcc']:.4f} ms of device time"
          + ("" if sums["K5 mfcc"] > 0 else " (missing: the trace lost its first kernels)"))
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


def k1_check(what: str, table, src, concepts, reps: int) -> dict:
    """K1 at one launch shape: bit-equal to its plain gather, then timed by
    CUDA events over back-to-back calls (paced by the host at these sizes)
    and by its device time (torch.profiler), beside the plain gather, the
    library double-index gather (timed only; the port never calls it) and
    the bound (table and ids read once, the output written once)."""
    import torch

    from multimodalworddiscovery_tpu_torch.ops import counts as k1
    from multimodalworddiscovery_tpu_torch.scripts.bench_kernels import device_ms

    got = k1.table_lookup(table, src, concepts)
    want = k1.table_lookup_plain(table, src, concepts)
    _check(torch.equal(got, want), f"K1 at {what} {tuple(got.shape)}: bit-equal to the plain "
                                   f"gather")
    lib = lambda: table[src.long()[..., None], concepts.long()[:, None, :]]  # noqa: E731
    r = {"err": _max_abs(got, want),
         "ms": _gpu_ms(lambda: k1.table_lookup(table, src, concepts), reps),
         "device_ms": device_ms(lambda: k1.table_lookup(table, src, concepts), reps,
                                "table_lookup"),
         "plain_ms": _gpu_ms(lambda: k1.table_lookup_plain(table, src, concepts), reps),
         "library_ms": _gpu_ms(lib, reps)} | _bound(_nbytes(table, src, concepts, got), 0)
    print(f"  K1 table_lookup at {what} {tuple(got.shape)}, table {tuple(table.shape)}: kernel "
          f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
          f"library gather {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']})")
    return r


def k7_check(what: str, gamma, src, concepts, f: int, e: int, reps: int) -> dict:
    """K7 on K4's posteriors ``gamma`` against its plain version and
    against the plain posteriors summed in float64 (rtol 1e-5, atol 1e-4 x
    the largest count, each), with n_cols=4096 (the table in device memory)
    against its narrow result, and the library scatter
    (``torch.bincount`` on the pairs' flat ids, timed only as a yardstick;
    the port never calls it); the three timed, and the bound of the call."""
    import torch

    from multimodalworddiscovery_tpu_torch.ops import counts as k7

    got = k7.pair_counts(gamma, src, concepts, f, e)
    want = k7.pair_counts_plain(gamma, src, concepts, f, e)
    # the plain posteriors summed in float64 (K2's comparison): the float32
    # scatter drifts where ~1e5 posteriors add into one entry
    exact = k7.pair_counts_plain(gamma.double(), src, concepts, f, e)
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
    err64, plain64 = _max_abs(got.double(), exact), _max_abs(want.double(), exact)
    print(f"  K7 at {what}: max abs err {err64} against the plain posteriors summed in "
          f"float64, the plain float32 scatter's own {plain64}")
    _check(torch.allclose(got.double(), exact, atol=1e-4 * scale, **K7_TOL),
           f"K7 at {what} within rtol 1e-5, atol 1e-4 x the largest count of the plain "
           f"posteriors summed in float64")
    # n_cols = 4096: a table beyond shared memory, added straight into counts
    wide = k7.pair_counts(gamma, src, concepts, f, 4096)
    _check(torch.allclose(wide[:, :e], got, atol=1e-4 * scale, **K7_TOL)
           and not bool(wide[:, e:].any()),
           f"K7 at {what} with n_cols=4096 (the table in device memory): the first {e} "
           f"columns within rtol 1e-5, atol 1e-4 x the largest count of the narrow result, "
           f"the rest 0 (max abs err {_max_abs(wide[:, :e], got)})")
    del wide
    r = {"err": err,
         "ms": _gpu_ms(lambda: k7.pair_counts(gamma, src, concepts, f, e), reps),
         "plain_ms": _gpu_ms(lambda: k7.pair_counts_plain(gamma, src, concepts, f, e), reps),
         "library_ms": _gpu_ms(lambda: torch.bincount(flat, weights=weights,
                                                      minlength=f * e), reps)}
    # one add per element read; each input read once, the counts written once
    return r | {"err64": err64, "plain_err64": plain64} | _bound(
        _nbytes(gamma, src, concepts, got), float(gamma.numel()))


def _k8_bound(a, b, out, bf16: bool) -> dict:
    """K8's bound: the bytes of a, b and out, or 2 I J K operations per
    product (its terms' add and sum, a plain product's count) at the fp32
    rate, or for the bf16 variant at the bf16 tensor-core rate; with the
    exp-rate bound (one exp per term) of the float32 kernel's design beside
    it: the special-function units take 16 exps a clock per SM against the
    128 fp32 FMAs (CUDA's throughput table for compute capability 9.0), an
    eighth of the FMA rate."""
    from multimodalworddiscovery_tpu_torch.scripts.bench_kernels import FP32_OPS_PER_S

    nz = out.numel() // (out.shape[-1] * out.shape[-2])
    terms = float(nz) * a.shape[-2] * a.shape[-1] * b.shape[-1]
    ops = (0.0, 2 * terms) if bf16 else (2 * terms, 0.0)
    exp_per_s = FP32_OPS_PER_S / 2 / 8
    return _bound(_nbytes(a, b, out), *ops) | {"exp_bound_ms": terms / exp_per_s * 1e3}


def k8_check(what: str, a, b, want=None, bf16_too: bool = False, reps: int = 0,
             library: bool = False) -> dict:
    """K8 (and with ``bf16_too`` K8-bf16) against the plain versions on
    ``a`` x ``b``: K8 within rtol 1e-4 atol 1e-4 of the broadcast oracle
    (``want`` if given); K8-bf16 within 2e-2 of its plain bf16 version and
    5e-2 of K8, and rounding.  With ``reps``, each timed with its plain
    version and, with ``library``, the broadcast torch.logsumexp."""
    import torch

    from multimodalworddiscovery_tpu_torch.ops import log_semiring as k8
    from multimodalworddiscovery_tpu_torch.scripts.bench_kernels import device_ms

    k8.reset_guard(a.device)
    got = k8.log_matmul(a, b)
    took, summed = k8.guard_counts(a.device)
    if want is None:
        want = k8.log_matmul_plain(a, b)
    err = _max_abs(got, want)
    live = want > -1e30 / 2
    print(f"K8 at {what}: a {tuple(a.shape)} x b {tuple(b.shape)}; max abs err vs plain {err}; "
          f"NEG_INF outputs {int((~live).sum())} of {want.numel()} (equal: "
          f"{bool(torch.equal(got[~live], want[~live]))}); the guard took {took} elements "
          f"({took / got.numel():.4g}), {summed} of them summed again ({summed / got.numel():.4g})")
    _check(torch.allclose(got, want, **K8_TOL), f"K8 at {what} within rtol 1e-4 atol 1e-4 of "
                                                f"the broadcast oracle")
    r = {"err": err, "guard_share": took / got.numel(), "guard_summed_share": summed / got.numel()}
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
              "device_ms": device_ms(lambda: k8.log_matmul(a, b), reps, "mwd_lm_", "mwd_lm_f32"),
              "plain_ms": _gpu_ms(lambda: k8.log_matmul_plain(a, b), max(reps // 5, 1)),
              "library_ms": (_gpu_ms(lambda: torch.logsumexp(a[..., :, :, None]
                                                             + b[..., None, :, :], dim=-2),
                                     max(reps // 5, 1)) if library else None)}
        r |= _k8_bound(a, b, got, bf16=False)
        if bf16_too:
            r |= {"bf16_ms": _gpu_ms(lambda: k8.log_matmul(a, b, "bfloat16"), reps),
                  "bf16_device_ms": device_ms(lambda: k8.log_matmul(a, b, "bfloat16"), reps,
                                              "mwd_lm_bf16"),
                  "bf16_plain_ms": _gpu_ms(lambda: k8.log_matmul_plain(a, b, "bfloat16"),
                                           max(reps // 5, 1)),
                  "bf16_bound": _k8_bound(a, b, got, bf16=True)}
    return r


K8_LIBRARY_CHUNK_BYTES = 8 << 30  # the broadcast library form's batch chunks at path 9


def _logsumexp_chunked(a, b):
    """The library form of K8 (one broadcast torch.logsumexp over [B, I, K,
    J]) in chunks of the batch small enough to fit the card."""
    import torch

    a3, b3 = a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:])
    per = a.shape[-2] * a.shape[-1] * b.shape[-1] * 4
    step = max(1, K8_LIBRARY_CHUNK_BYTES // per)
    out = torch.empty((a3.shape[0], a.shape[-2], b.shape[-1]), device=a.device)
    for z in range(0, a3.shape[0], step):
        out[z:z + step] = torch.logsumexp(a3[z:z + step, :, :, None] + b3[z:z + step, None],
                                          dim=-2)
    return out


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
    k1r = k1_check("path 8's shape", params.log_emit, corpus.src, concepts, 20)
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
    return {"launches": launches, "k1": k1r, "k7": k7, "ms_per_iter": (ms_k, ms_p)}


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
        k8.reset_guard(dev)
        elements = k8.log_matmul.elements
        runs = {"associative": hmm_core.forward_associative(*args),
                f"blocked({ASSOC_BLOCK})": hmm_core.forward_blocked(*args, block=ASSOC_BLOCK)}
        torch.cuda.synchronize()
        got = _counts(counters)
        took, summed = k8.guard_counts(dev)
        elements = k8.log_matmul.elements - elements
        guard = {"guard_share": took / elements, "guard_summed_share": summed / elements}
        print(f"  kernel launches: {got}; K8's guard took {took} of the combines' {elements} "
              f"output elements ({guard['guard_share']:.4g}), {summed} of them summed again "
              f"({guard['guard_summed_share']:.4g}; the rest had no live term in common)")
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
        r["library_ms"] = _gpu_ms(lambda: _logsumexp_chunked(m[0:-1:2], m[1::2]), 1)
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
        r["combines"] = guard
        print(f"  [{card}] path 9 at {label}, ms per call (CUDA events): {r['times']}")
        print(f"  [{card}] K8 at the first combine: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), exp-rate "
              f"bound {r['exp_bound_ms']:.4f} ms; library: the broadcast torch.logsumexp in "
              f"batch chunks of at most {K8_LIBRARY_CHUNK_BYTES / 2**30:.0f} GiB (its whole "
              f"[B, I, K, J] sum would take {bcast:.3g} bytes) {r['library_ms']:.4f} ms")
        out[label] = r
        if label == bench_assoc.SHAPES[-1][0]:
            _profile(lambda: hmm_core.forward_associative(*args),
                     f"forward_associative at {label} (K8 combines)", card)
        del corpus, params, args, alphas, fact
        torch.cuda.empty_cache()
    return {"launches": launches, "shapes": out}


def _k4_at(label: str, inputs, card: str) -> dict:
    """K4, K4-bf16, K6 and K3 at one launch shape: each against its plain
    version (K4's bounds; K6 also against K4; K3 as k3_parity), and timed
    with its bound.  ``inputs`` = (log_init, base, rowz, colmask, log_emit,
    src_len)."""
    import torch

    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k4

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
    return r


def k4_s8_phase(card: str, dev) -> dict:
    """K4, K4-bf16, K6 and K3 at the two S=8 shapes the pipeline (N=2000,
    Ts=174) and the CRF and DNN-HMM paths (N=400, Ts=64) launch them at,
    their inputs built as ``scripts/bench_estep.py`` builds them
    (``_k4_at``)."""
    import torch

    from multimodalworddiscovery_tpu_torch.scripts import bench_estep

    out = {}
    for label in ("S8_pipeline", "S8_crf"):
        out[label] = _k4_at(label, bench_estep.shape_inputs(label, dev), card)
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
    from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core
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
    k1r = k1_check("the S~200 corpus", p.log_emit, corpus.src, hmm_core.state_concepts(corpus), 10)
    for label, r in out.items():
        k4r, k3r = r["k4"], r["k3"]
        print(f"  [{card}] {label} (S={r['S']}): K4 {k4r['ms']:.4f} ms (plain "
              f"{k4r['plain_ms']:.4f}, bound {k4r['bound_ms']:.4f}), K4-bf16 {k4r['bf16_ms']:.4f} "
              f"ms, K6 {k4r['k6_ms']:.4f} ms; K3 {k3r['ms']:.4f} ms (plain "
              f"{k3r['plain_ms']:.4f}, bound {k3r['bound_ms']:.4f})")
    return {"shapes": out, "launches": launches, "k1": k1r}


def bench_phase(here: str, counters) -> dict:
    """The port's bench_kernels (mfcc, counts, log_matmul) and bench_assoc, once
    each with few repetitions, records under build/chip_smoke/; K8-bf16's
    launches come from bench_kernels' log_matmul entry, its entry point."""
    from multimodalworddiscovery_tpu_torch.scripts import bench_assoc, bench_kernels

    out_dir = os.path.join(here, "build", "chip_smoke")
    _reset(counters)
    bench_kernels.main(["--only", "mfcc", "counts", "log_matmul", "--reps", "3",
                        "--out", os.path.join(out_dir, "bench_kernels.jsonl")])
    launches = _counts(counters)
    print(f"  kernel launches in bench_kernels --only mfcc counts log_matmul: {launches}")
    _check(launches["extract"] > 0 and launches["pair_counts"] > 0
           and launches["log_matmul"] > 0 and launches["log_matmul_bf16"] > 0,
           "bench_kernels launched K5, K7, K8 and K8-bf16")
    bench_assoc.main(["--reps", "2", "--out", os.path.join(out_dir, "bench_assoc.jsonl")])
    return launches


def _timed(fn):
    """(fn(), its CUDA-event time in ms) for one run."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _unit_metrics(alignment, corpus, gold) -> dict:
    """The four metric families of an alignment against the gold: alignment
    P/R/F1, word IoU F1, boundary F1 (tolerance 1) and purity."""
    import torch

    from multimodalworddiscovery_tpu_torch.eval import metrics
    from multimodalworddiscovery_tpu_torch.segment import boundaries_from_segments, segment_corpus

    gold_t = torch.as_tensor(gold.alignment, device=corpus.device)
    segs, mask = segment_corpus(alignment, corpus)
    gsegs, gmask = segment_corpus(gold_t, corpus)
    t = corpus.max_src_len
    prf = metrics.alignment_prf(alignment, gold_t, corpus.src_mask())
    return {"alignment": {k: float(v) for k, v in prf.items()},
            "word_iou_f1": float(metrics.word_iou(segs, mask, gsegs, gmask)["f1"]),
            "boundary_f1": float(metrics.boundary_prf(
                boundaries_from_segments(segs, mask, t), boundaries_from_segments(gsegs, gmask, t),
                tolerance=1)["f1"]),
            "purity": float(metrics.cluster_purity(segs, mask, gsegs, gmask, corpus.trg_vocab)),
            "segs": segs, "seg_mask": mask}


def model1_phase(card: str, counters, dev) -> dict:
    """Path 10: Model-1 (config #1) at the model1_align Tt6 shape: 10 EM
    iterations (two float32 products over the corpus's count statistics, no
    kernel; the loglik held to the JAX reference's), then align through K1,
    segmentation and the four metric families; align through the plain
    gather, its alignment held equal; the concept-space decode against the
    dense one at Tt6 and Tt32; K1 at Model-1's shapes."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.models import model1
    from multimodalworddiscovery_tpu_torch.scripts import bench_kernels as bk

    corpus, gold, _ = make_flickr8k_mini(**bk.MODEL1_SHAPES["Tt6"], device=dev)
    print(f"path 10 (Model-1): N={corpus.n}, Ts={corpus.max_src_len}, 1+Tt="
          f"{1 + corpus.max_trg_len}, V_src={corpus.src_vocab}, V_trg={corpus.trg_vocab}, "
          f"{EM_ITERS} EM iterations")
    _reset(counters)
    params, lls = model1.train(model1.init(corpus), corpus, EM_ITERS)
    runs = {}
    for use_kernels in (True, False):
        if not use_kernels:
            _reset(counters)
        alignment = model1.align(params, corpus, use_kernels=use_kernels)
        metrics = _unit_metrics(alignment, corpus, gold)
        torch.cuda.synchronize()
        runs[use_kernels] = dict(alignment=alignment, metrics=metrics, launches=_counts(counters))
    kern, plain = runs[True], runs[False]
    launches = kern["launches"]
    lw = lls.cpu().numpy()
    print(f"  loglik per iteration: {lw.tolist()}")
    print(f"  kernel launches on path 10: {launches}")
    for name, r in (("kernel", kern), ("plain", plain)):
        m = r["metrics"]
        print(f"  {name} path: alignment {m['alignment']}, word IoU F1 {m['word_iou_f1']:.5f}, "
              f"boundary F1 {m['boundary_f1']:.5f}, purity {m['purity']:.5f}")
    _check(launches["table_lookup"] == 1 and sum(launches.values()) == 1,
           "path 10: K1 launched once (the decode's pair log-probs), no other kernel")
    _check(sum(plain["launches"].values()) == 0, "path 10 plain decode: no kernel launched")
    _check(bool(np.all(np.isfinite(lw))) and bool(np.all(np.diff(lw) >= -1e-6 * np.abs(lw[:-1])))
           and lw[-1] > lw[0], "path 10 loglik finite, monotone and improving")
    ll = float(lw[-1])
    _check(abs(ll - REFERENCE_MODEL1_LL) <= 1e-5 * abs(REFERENCE_MODEL1_LL),
           f"path 10 final loglik within rtol 1e-5 of the JAX reference {REFERENCE_MODEL1_LL} "
           f"({ll})")
    _check(torch.equal(kern["alignment"], plain["alignment"]),
           "path 10: the alignment through K1 equals the plain gather's")
    f1 = kern["metrics"]["alignment"]["f1"]
    _check(abs(f1 - REFERENCE_MODEL1_F1) <= 0.005,
           f"path 10 F1 within 0.005 of the JAX reference {REFERENCE_MODEL1_F1} ({f1:.5f})")
    segs, mask = kern["metrics"]["segs"], kern["metrics"]["seg_mask"]
    valid = segs[mask]
    _check(tuple(segs.shape) == (corpus.n, corpus.max_src_len, 3)
           and bool(((valid[:, 0] < valid[:, 1]) & (valid[:, 2] > 0)).all())
           and int(mask.sum()) > 0, f"path 10: {int(mask.sum())} word units, each non-empty "
                                    f"with a concept")
    c32, _, _ = make_flickr8k_mini(**bk.MODEL1_SHAPES["Tt32"], device=dev)
    p32, _ = model1.train(model1.init(c32), c32, EM_ITERS)
    dense_launches = {}
    for label, c, p in (("Tt6", corpus, params), ("Tt32", c32, p32)):
        _reset(counters)
        _check(torch.equal(model1._align_concept_space(p, c), model1._align_dense(p, c)),
               f"path 10 at {label} (N={c.n}, 1+Tt={1 + c.max_trg_len}): the concept-space "
               f"decode equals the dense decode through K1")
        dense_launches[label] = _counts(counters)
    k1r = {label: k1_check(f"Model-1's shape ({label})", p.log_t, c.src,
                           model1._extended_targets(c)[0], 20)
           for label, c, p in (("Tt6", corpus, params), ("Tt32", c32, p32))}
    stats = model1._count_stats(corpus)
    em_ms = _gpu_ms(lambda: model1.em_step(params, corpus, stats=stats), 10)
    times = {}
    for label, c, p in (("Tt6", corpus, params), ("Tt32", c32, p32)):
        dec = _alternate({"plain": lambda c=c, p=p: model1.align(p, c, use_kernels=False),
                          "kernels": lambda c=c, p=p: model1.align(p, c, use_kernels=True)},
                         reps=5, rounds=2)
        cs = _gpu_ms(lambda c=c, p=p: model1._align_concept_space(p, c), 5)
        times[label] = (dec["kernels"], dec["plain"], cs)
        print(f"  [{card}] path 10 align at {label}, median of 4 runs of 5: dense through K1 "
              f"{dec['kernels']:.4f} ms, dense plain {dec['plain']:.4f} ms, concept space "
              f"{cs:.4f} ms")
    print(f"  [{card}] path 10 EM ms/iter (CUDA events, mean of 10, the count statistics "
          f"counted once as train does): {em_ms:.4f} ({corpus.n * 1e3 / em_ms:.1f} utt*iter/s)")
    _profile(lambda: model1.em_step(params, corpus, stats=stats), "one path 10 EM iteration",
             card)
    _profile(lambda: model1.align(params, corpus), "path 10's align (K1)", card)
    del c32, p32, stats
    return {"launches": launches, "dense_launches": dense_launches, "k1": k1r,
            "em_ms": em_ms, "align_ms": times}


def _recording(step_fn, losses: list):
    """``step_fn`` that also keeps each step's loss (on the device)."""
    def step(state, batch):
        state, stats = step_fn(state, batch)
        losses.append(stats["loss"])
        return state, stats
    return step


def attention_phase(card: str, counters, dev, corpus, gold) -> dict:
    """Path 11: config #3's attention aligner on the N=8192 corpus at dim
    128, B=512 AdamW minibatch steps, unguided and guided by the discrete
    HMM teacher (hmm.train through K1 + K2; each batch's guide from K4's
    gamma on K1's emissions); then configs/attention_guided_frames.py with
    its Gaussian teacher (15 EM iterations through K4, the guide from K4
    every step)."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
    from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf
    from multimodalworddiscovery_tpu_torch.models import attention, hmm, hmm_gaussian, minibatch
    from multimodalworddiscovery_tpu_torch.ops import counts as k1
    from multimodalworddiscovery_tpu_torch.scripts import bench_kernels as bk

    print(f"path 11 (attention, config #3): N={corpus.n}, Ts={corpus.max_src_len}, "
          f"Tt={corpus.max_trg_len}, dim {bk.MODEL_DIM}, B={bk.ATT_BATCH}, {ATT_STEPS} steps; the "
          f"discrete teacher {TEACHER_ITERS} EM iterations")
    gold_t = torch.as_tensor(gold.alignment, device=dev)
    _reset(counters)
    teacher, t_lls = hmm.train(hmm.init(corpus), corpus, TEACHER_ITERS)
    t_f1 = float(alignment_prf(hmm.align(teacher, corpus), gold_t, corpus.src_mask())["f1"])
    launches = {"teacher": _counts(counters)}
    runs = {}
    for name in ("unguided", "guided"):
        state = attention.init(corpus, dim=bk.MODEL_DIM,
                               generator=torch.Generator().manual_seed(SEED))
        step_fn = attention.em_step
        if name == "guided":
            def step_fn(s, b):
                return attention.em_step(s, b, guide=attention.hmm_guide_matrix(teacher, b))
        losses = []
        _reset(counters)
        (state, _), ms = _timed(lambda: minibatch.train_minibatch(
            _recording(step_fn, losses), state, corpus, bk.ATT_BATCH, ATT_STEPS,
            generator=torch.Generator().manual_seed(SEED)))
        launches[name] = _counts(counters)
        prf = alignment_prf(attention.align(state, corpus), gold_t, corpus.src_mask())
        runs[name] = dict(loss=(float(losses[0]), float(losses[-1])), ms=ms,
                          prf={k: float(v) for k, v in prf.items()})
        print(f"  {name}: loss {runs[name]['loss'][0]:.5f} at the first step, "
              f"{runs[name]['loss'][1]:.5f} at the last; alignment {runs[name]['prf']}; "
              f"launches {launches[name]}")
        print(f"  [{card}] path 11 {name}: {ATT_STEPS} steps in {ms:.1f} ms, "
              f"{ATT_STEPS * 1e3 / ms:.2f} steps/s (CUDA events)")
        _check(runs[name]["loss"][1] < runs[name]["loss"][0],
               f"path 11 {name}: the loss falls from the first step to the last")
        batch = minibatch.gather_batch(corpus, torch.arange(bk.ATT_BATCH, device=dev))
        _profile(lambda: step_fn(state, batch), f"one path 11 {name} step (B={bk.ATT_BATCH})", card)
    print(f"  discrete teacher: loglik {t_lls.tolist()}, alignment F1 {t_f1:.5f}, launches "
          f"{launches['teacher']}")
    _check(launches["teacher"]["table_lookup"] > 0
           and launches["teacher"]["hmm_estep_counts"] == TEACHER_ITERS,
           "path 11: the discrete teacher trains through K1 and K2 (once per EM iteration)")
    _check(launches["guided"]["hmm_estep"] == ATT_STEPS
           and launches["guided"]["table_lookup"] == ATT_STEPS,
           "path 11 guided: each batch's guide through K1 and K4")
    _check(sum(launches["unguided"].values()) == 0, "path 11 unguided: no kernel")
    f1_g, f1_u = runs["guided"]["prf"]["f1"], runs["unguided"]["prf"]["f1"]
    _check(f1_g > f1_u, f"path 11: the guided run's alignment F1 exceeds the unguided run's "
                        f"({f1_g:.5f} vs {f1_u:.5f})")
    # the kernels at the shapes this path launches them: the teacher's corpus
    # (K1, K2 as parity checks them, K3) and the guide's batch (K1, K4)
    k2_teacher = parity(f"path 11's teacher corpus (N={corpus.n})", corpus)
    concepts, fact = _estep_inputs(teacher, corpus)
    k1_teacher = k1_check("path 11's teacher corpus", teacher.log_emit, corpus.src, concepts, 20)
    k3_teacher = k3_parity(f"path 11's teacher corpus (S={concepts.shape[1]})",
                           (*fact, k1.table_lookup(teacher.log_emit, corpus.src, concepts),
                            corpus.src_len), 10)
    batch = minibatch.gather_batch(corpus, torch.arange(bk.ATT_BATCH, device=dev))
    k1_guide = k1_check(f"path 11's guide batch (B={bk.ATT_BATCH})", teacher.log_emit, batch.src,
                        _estep_inputs(teacher, batch)[0], 20)
    batch = batch.pad_to(batch.n + ZERO_LENGTH_PAD)
    concepts, fact = _estep_inputs(teacher, batch)
    k4_guide = k4_parity(f"path 11's guide batch (S={2 * batch.max_trg_len}, B={bk.ATT_BATCH})",
                         (*fact, k1.table_lookup(teacher.log_emit, batch.src, concepts),
                          batch.src_len), 10)
    del batch, fact, concepts

    # configs/attention_guided_frames.py: Gaussian teacher, full-batch steps
    pc, pg, _ = make_flickr8k_mini(**GUIDED_FRAMES)
    fc, fg, _ = phones_to_frames(pc, pg, **GUIDED_FRAMES_FEAT, device=dev)
    print(f"path 11, configs/attention_guided_frames.py: N={fc.n}, Ts={fc.max_src_len}, "
          f"D={fc.src.shape[-1]}, S={2 * fc.max_trg_len}, Gaussian teacher (K=2) "
          f"{GUIDED_TEACHER_ITERS} EM iterations, {GUIDED_STEPS} full-batch steps")
    _reset(counters)
    gt = hmm_gaussian.init(fc, max_jump=3, n_components=2,
                           generator=torch.Generator().manual_seed(SEED + 1))
    gt, g_lls = hmm_gaussian.train(gt, fc, GUIDED_TEACHER_ITERS)
    state = attention.init(fc, dim=bk.MODEL_DIM, learning_rate=3e-4,
                           generator=torch.Generator().manual_seed(SEED))
    losses = []

    def guided_frames():
        s = state
        for _ in range(GUIDED_STEPS):
            g = attention.hmm_guide_matrix(gt, fc, posteriors_fn=hmm_gaussian.posteriors)
            s, stats = attention.em_step(s, fc, guide=g)
            losses.append(stats["loss"])
        return s

    state, ms = _timed(guided_frames)
    launches["guided_frames"] = _counts(counters)
    gold_f = torch.as_tensor(fg.alignment, device=dev)
    f1_s = float(alignment_prf(attention.align(state, fc), gold_f, fc.src_mask())["f1"])
    f1_t = float(alignment_prf(hmm_gaussian.align(gt, fc), gold_f, fc.src_mask())["f1"])
    print(f"  teacher loglik {g_lls.tolist()}; loss {float(losses[0]):.5f} at the first step, "
          f"{float(losses[-1]):.5f} at the last; alignment F1 student {f1_s:.5f}, teacher "
          f"{f1_t:.5f}; launches {launches['guided_frames']}")
    print(f"  [{card}] path 11 guided frames: {GUIDED_STEPS} steps in {ms:.1f} ms, "
          f"{GUIDED_STEPS * 1e3 / ms:.2f} steps/s (CUDA events, the guide's K4 included)")
    _check(bool(np.all(np.isfinite(g_lls.cpu().numpy()))) and float(losses[-1]) < float(losses[0]),
           "path 11 guided frames: teacher loglik finite, the student's loss falls")
    _check(launches["guided_frames"]["hmm_estep"] == GUIDED_TEACHER_ITERS + GUIDED_STEPS,
           "path 11 guided frames: K4 launched once per teacher EM iteration and per step")
    # K4 at the guided frames' shape, on the trained Gaussian teacher's emissions
    padded = fc.pad_to(fc.n + ZERO_LENGTH_PAD)
    _, fact = _estep_inputs(gt, padded)
    k4_frames = k4_parity(f"path 11's guided frames (S={2 * fc.max_trg_len}, N={fc.n})",
                          (*fact, hmm_gaussian._log_emissions(gt, padded), padded.src_len), 10)
    del padded, fact
    return {"launches": launches, "teacher": teacher, "runs": runs,
            "guided_frames_f1": (f1_s, f1_t),
            "checks": {"k1_teacher": k1_teacher, "k1_guide": k1_guide, "k2_teacher": k2_teacher,
                       "k3_teacher": k3_teacher, "k4_guide": k4_guide, "k4_frames": k4_frames}}


def grounding_retrieval_phase(card: str, counters, dev, corpus, teacher) -> dict:
    """Path 12: grounding (B=256 Adam minibatch steps on the N=8192 corpus
    at dim 128; its pooled recall@5 c2i before and after), then pooled
    retrieval (pool 32, both directions) for Model-1 through K1 (against
    its plain route), the discrete HMM (path 11's teacher) and grounding."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.eval import retrieval
    from multimodalworddiscovery_tpu_torch.models import grounding, hmm, minibatch, model1
    from multimodalworddiscovery_tpu_torch.scripts import bench_kernels as bk

    cand = retrieval.sample_candidate_pools(corpus.n, bk.RETRIEVAL_POOL,
                                            torch.Generator().manual_seed(SEED), device=dev)
    print(f"path 12 (grounding and pooled retrieval): N={corpus.n}, pool {bk.RETRIEVAL_POOL}, "
          f"grounding dim {bk.MODEL_DIM}, B={bk.GROUND_BATCH}, {GROUND_STEPS} steps")
    state = grounding.init(corpus, dim=bk.MODEL_DIM, generator=torch.Generator().manual_seed(SEED))

    def recall5(s):
        scores = grounding.retrieval_scores_pooled(s, corpus, cand, "c2i")
        return float(retrieval.recall_at_k_pooled(scores, direction="c2i")["recall@5_c2i"])

    r5_before = recall5(state)
    losses = []
    _reset(counters)
    (state, _), ms = _timed(lambda: minibatch.train_minibatch(
        _recording(grounding.em_step, losses), state, corpus, bk.GROUND_BATCH, GROUND_STEPS,
        generator=torch.Generator().manual_seed(SEED)))
    launches = {"grounding": _counts(counters)}
    r5_after = recall5(state)
    print(f"  grounding: loss {float(losses[0]):.5f} at the first step, {float(losses[-1]):.5f} "
          f"at the last; pooled recall@5 c2i {r5_before:.5f} before, {r5_after:.5f} after")
    print(f"  [{card}] path 12 grounding: {GROUND_STEPS} steps in {ms:.1f} ms, "
          f"{GROUND_STEPS * 1e3 / ms:.2f} steps/s (CUDA events)")
    _check(float(losses[-1]) < float(losses[0]) and r5_after > r5_before,
           "path 12 grounding: the loss falls and pooled recall@5 c2i rises")
    batch = minibatch.gather_batch(corpus, torch.arange(bk.GROUND_BATCH, device=dev))
    _profile(lambda: grounding.em_step(state, batch), f"one grounding step (B={bk.GROUND_BATCH})",
             card)
    m1, _ = model1.train(model1.init(corpus), corpus, EM_ITERS)
    scorers = {
        "model1": lambda d: retrieval.retrieval_scores_model1_pooled(m1, corpus, cand, d),
        "hmm": lambda d: retrieval.retrieval_scores_hmm_family_pooled(hmm, teacher, corpus,
                                                                      cand, d),
        "grounding": lambda d: grounding.retrieval_scores_pooled(state, corpus, cand, d),
    }
    protocols = {}
    _reset(counters)
    for d in ("c2i", "i2c"):
        for name, fn in scorers.items():
            scores, ms = _timed(lambda: fn(d))
            rec = retrieval.recall_at_k_pooled(scores, direction=d)
            protocols[f"{name}_{d}"] = {"ms": ms, **{k: float(v) for k, v in rec.items()}}
            _check(bool(torch.isfinite(scores).all()) and tuple(scores.shape)
                   == (corpus.n, bk.RETRIEVAL_POOL), f"path 12 {name} {d}: finite [N, C] scores")
    launches["retrieval"] = _counts(counters)
    _profile(lambda: scorers["model1"]("c2i"), "path 12's pooled Model-1 scores, c2i (K1)",
             card)
    _profile(lambda: scorers["hmm"]("c2i"), "path 12's pooled HMM scores, c2i", card)
    for k, r in protocols.items():
        print(f"  [{card}] path 12 pooled {k}: {r['ms']:.3f} ms (CUDA events), recall@1 "
              f"{r['recall@1_' + k[-3:]]:.5f}, @5 {r['recall@5_' + k[-3:]]:.5f}, @10 "
              f"{r['recall@10_' + k[-3:]]:.5f}, median rank {r['median_rank_' + k[-3:]]}")
    print(f"  kernel launches in path 12's retrieval: {launches['retrieval']}")
    _check(launches["retrieval"]["table_lookup"] >= 2,
           "path 12: Model-1's pooled scores through K1 in both directions")
    for d in ("c2i", "i2c"):
        got = scorers["model1"](d)
        want = retrieval.retrieval_scores_model1_pooled(m1, corpus, cand, d, use_kernels=False)
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        _check(torch.allclose(got, want, rtol=1e-5, atol=0),
               f"path 12 Model-1 pooled {d}: K1's scores within rtol 1e-5 of plain (max rel "
               f"{rel:.3e})")
    rows = retrieval.PAIR_CHUNK_BYTES // (retrieval._model1_pair_bytes(corpus) * bk.RETRIEVAL_POOL)
    paired = retrieval._paired(corpus, torch.arange(min(rows, corpus.n), device=dev),
                               cand[:rows], "c2i")
    k1r = k1_check("pooled retrieval's chunk (rows x C)", m1.log_t, paired.src,
                   model1._extended_targets(paired)[0], 10)
    del paired
    return {"launches": launches, "k1": k1r, "protocols": protocols,
            "recall5": (r5_before, r5_after)}


def _uniform_bounds(seg_mask, src_len, t: int):
    """The uniform baseline's boundaries [N, t+1]: as many segments per
    utterance as ``seg_mask`` holds, of equal length (rounded down)."""
    import torch

    n = seg_mask.shape[0]
    k = seg_mask.sum(dim=1)
    j = torch.arange(t + 1, device=seg_mask.device)[None, :]
    pos = torch.div(j * src_len[:, None].long(), k.clamp(min=1)[:, None], rounding_mode="floor")
    ok = (j <= k[:, None]) & (k[:, None] > 0)
    out = torch.zeros((n, t + 2), dtype=torch.bool, device=seg_mask.device)
    out.scatter_(1, torch.where(ok, pos, t + 1), True)
    return out[:, : t + 1]


def segkmeans_dtw_phase(card: str, counters, dev) -> dict:
    """Path 13: segmental k-means and its GMM variant on 13-dim frames of
    N=2000 utterances (10 iterations each), boundary recall against the
    uniform baseline; the DTW coherence of the gold segments of the golden
    test's corpus against tests/golden_metrics.json."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
    from multimodalworddiscovery_tpu_torch.eval import dtw, metrics
    from multimodalworddiscovery_tpu_torch.models import segmental_kmeans as skm
    from multimodalworddiscovery_tpu_torch.segment import (
        boundaries_from_segments, segments_from_alignment,
    )
    from multimodalworddiscovery_tpu_torch.scripts import bench_kernels as bk

    tok, tok_gold, _ = make_flickr8k_mini(**bk.SEGKMEANS_CORPUS)
    fc, fg, _ = phones_to_frames(tok, tok_gold, **bk.SEGKMEANS_FRAMES, device=dev)
    t = fc.max_src_len
    gs, gm = segments_from_alignment(torch.as_tensor(fg.alignment, device=dev), fc.trg, fc.src_len)
    gold_b = boundaries_from_segments(gs, gm, t)
    print(f"path 13 (segmental k-means, DTW): N={fc.n}, Ts={t}, D={fc.src.shape[-1]}, "
          f"{SEGKMEANS_ITERS} iterations each")
    _reset(counters)
    out = {}
    for name in ("kmeans", "gmm"):
        gen = torch.Generator().manual_seed(2)
        if name == "kmeans":
            p = skm.init(fc, n_clusters=64, generator=gen)
            (p, lls), ms = _timed(lambda: skm.train(p, fc, SEGKMEANS_ITERS))
            lls = lls.cpu().numpy()
        else:
            p = skm.init_gmm(fc, n_clusters=64, generator=gen)

            def run(p=p):
                lls = []
                for _ in range(SEGKMEANS_ITERS):
                    p, stats = skm.em_step_gmm(p, fc)
                    lls.append(stats["loglik"])
                return p, torch.stack(lls)

            (p, lls), ms = _timed(run)
            lls = lls.cpu().numpy()
        (segs, mask), d_ms = _timed(lambda: skm.discover(p, fc))
        pred = metrics.boundary_prf(boundaries_from_segments(segs, mask, t), gold_b, tolerance=1)
        uni = metrics.boundary_prf(_uniform_bounds(mask, fc.src_len, t), gold_b, tolerance=1)
        out[name] = dict(lls=lls, ms=ms / SEGKMEANS_ITERS, discover_ms=d_ms,
                         recall=float(pred["recall"]), uniform_recall=float(uni["recall"]),
                         f1=float(pred["f1"]), n_segments=int(mask.sum()))
        print(f"  {name}: -distortion per iteration {lls.tolist()}; {int(mask.sum())} "
              f"segments; boundary recall {out[name]['recall']:.5f} (F1 {out[name]['f1']:.5f}), "
              f"uniform baseline recall {out[name]['uniform_recall']:.5f}")
        print(f"  [{card}] path 13 {name}: {out[name]['ms']:.3f} ms/iter, discover "
              f"{d_ms:.3f} ms (CUDA events)")
        _check(bool(np.all(np.isfinite(lls))), f"path 13 {name}: objective finite")
        _check(out[name]["recall"] > out[name]["uniform_recall"],
               f"path 13 {name}: boundary recall beats the uniform baseline")
    _profile(lambda: skm.em_step(skm.init(fc, n_clusters=64,
                                          generator=torch.Generator().manual_seed(2)), fc),
             "one path 13 k-means iteration", card)
    d = -out["kmeans"]["lls"]
    _check(bool(np.all(np.diff(d) <= 1e-5 * np.abs(d[:-1]))),
           "path 13 k-means: the distortion does not increase (rtol 1e-5)")
    launches = _counts(counters)
    _check(sum(launches.values()) == 0, "path 13 k-means: no kernel (plain torch, as the "
                                        "reference computes it in plain JAX)")
    c, g, _ = make_flickr8k_mini(**DTW_CORPUS)
    dfc, dfg, _ = phones_to_frames(c, g, **DTW_FRAMES, device=dev)
    segs, mask = segments_from_alignment(torch.as_tensor(dfg.alignment, device=dev), dfc.trg,
                                         dfc.src_len)
    coh, ms = _timed(lambda: dtw.cluster_dtw_coherence(dfc.src, segs, mask,
                                                       max_seg_len=DTW_MAX_SEG_LEN))
    coh = {k: float(v) for k, v in coh.items()}
    print(f"  DTW coherence of the gold segments (N={dfc.n}, {int(mask.sum())} segments): "
          f"{coh}; golden {GOLDEN_DTW}")
    print(f"  [{card}] path 13 cluster_dtw_coherence: {ms:.3f} ms (CUDA events)")
    for k, want in GOLDEN_DTW.items():
        _check(abs(coh[k] - want) <= 1e-3 + 0.02 * abs(want),
               f"path 13 DTW {k} within rtol 0.02 (atol 1e-3) of tests/golden_metrics.json")
    return {"launches": launches, "runs": out, "dtw": coh, "dtw_ms": ms}


def vgg_phase(card: str, dev) -> dict:
    """Path 14 (a): VGG16 at full width on the card, region embeddings of 8
    boxes on each of 16 rendered images and the images' concepts after the
    resize to 224; the card held to the same weights on the CPU on 2 of
    them.  Times by CUDA events."""
    import copy

    import torch

    from multimodalworddiscovery_tpu_torch.data import images_for_corpus, make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.frontend import image

    t0 = time.perf_counter()
    cpu = image.init_vgg16(generator=torch.Generator().manual_seed(SEED), device="cpu")
    model = copy.deepcopy(cpu).to(dev)
    corpus, _, _ = make_flickr8k_mini(**VGG_IMAGES, device="cpu")
    imgs, boxes, mask, _ = images_for_corpus(corpus, image_size=VGG_IMAGE_SIZE, seed=0)
    _check(bool(mask.all()) and mask.shape[1] == 8, "16 rendered images with 8 boxes each")
    print(f"VGG16 at full width: {sum(p.numel() for p in cpu.parameters())} parameters, "
          f"{model.num_classes} classes, fc {model.fc_dim}, input {model.input_size}; "
          f"{len(imgs)} images of {VGG_IMAGE_SIZE}^2 with {mask.shape[1]} boxes each "
          f"(set-up {time.perf_counter() - t0:.1f} s)")
    x = torch.as_tensor(imgs, device=dev)
    b = torch.as_tensor(boxes, device=dev)
    size = model.input_size

    def regions():
        return torch.stack([image.region_embeddings(model, x[i], b[i]) for i in range(len(x))])

    def concepts():
        resized = torch.stack([image.resize(x[i], size, size) for i in range(len(x))])
        return image.image_concepts(model, resized)

    emb, probs = regions(), concepts()
    _check(tuple(emb.shape) == (len(x), 8, model.fc_dim) and bool(torch.isfinite(emb).all()),
           f"region embeddings [16, 8, {model.fc_dim}], finite")
    _check(tuple(probs.shape) == (len(x), model.num_classes)
           and bool(torch.allclose(probs.sum(-1), torch.ones(len(x), device=dev), rtol=1e-4)),
           "concept posteriors [16, 1000], each summing to 1")
    errs = {}
    for name, got, want in (
            ("region embeddings", emb[:VGG_CPU_IMAGES].cpu(), torch.stack([
                image.region_embeddings(cpu, torch.as_tensor(imgs[i]), torch.as_tensor(boxes[i]))
                for i in range(VGG_CPU_IMAGES)])),
            ("concept posteriors", probs[:VGG_CPU_IMAGES].cpu(), image.image_concepts(
                cpu, torch.stack([image.resize(torch.as_tensor(imgs[i]), size, size)
                                  for i in range(VGG_CPU_IMAGES)])))):
        scale = float(want.abs().max())
        errs[name] = _max_abs(got, want)
        print(f"  {name}, card against CPU on {VGG_CPU_IMAGES} images: max abs err "
              f"{errs[name]:.3e} (largest |ref| {scale:.3e})")
        _check(torch.allclose(got, want, rtol=1e-3, atol=1e-4 * scale),
               f"{name} on the card within rtol 1e-3 atol 1e-4 x the largest |ref| of the CPU's")
    ms_regions = _gpu_ms(regions, 3)
    ms_concepts = _gpu_ms(concepts, 3)
    n_crops = len(x) * 8
    print(f"  [{card}] region embeddings: {ms_regions / len(x):.3f} ms per image of 8 boxes, "
          f"{n_crops * 1e3 / ms_regions:.1f} crops/s; concepts (resize + VGG16): "
          f"{ms_concepts / len(x):.3f} ms per image (CUDA events, mean of 3 runs)")
    del cpu, model
    torch.cuda.empty_cache()
    return {"ms_per_image_regions": ms_regions / len(x), "crops_per_s": n_crops * 1e3 / ms_regions,
            "ms_per_image_concepts": ms_concepts / len(x), "err": errs}


def image_phase(here: str, card: str, counters, dev) -> dict:
    """Path 14: VGG16 (a), ``scripts/train_detector`` at its defaults (b)
    and ``run_image_pipeline`` at its defaults, then its grounding stage
    from the reference's proposals (c); their convolutions and products are
    cuDNN's and cuBLAS's, and none of K1-K8 runs (counted)."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.scripts import image_pipeline, train_detector

    _reset(counters)
    vgg = vgg_phase(card, dev)
    # the training phases: one convolution algorithm, chosen the same way
    # in every run
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    det = train_detector.run_train_detector(device=dev)
    end.record()
    torch.cuda.synchronize()
    print(f"path 14 (b) train_detector at its defaults {train_detector.DEFAULTS}: "
          f"{json.dumps(det)}")
    losses = det["loss_history"]
    _check(losses[-1] < losses[0], f"detector loss falls ({losses[0]:.5f} -> {losses[-1]:.5f})")
    for k, doc in zip(("recall_at_0.5_train", "recall_at_0.5_heldout"),
                      DOCUMENTED_DETECTOR_RECALL):
        _check(det[k] >= DETECTOR_MIN_RECALL,
               f"detector {k} >= {DETECTOR_MIN_RECALL} ({det[k]}; the JAX package documents "
               f"{doc} for its CPU run)")
    print(f"  [{card}] train_detector: {start.elapsed_time(end) / 1e3:.2f} s in all, "
          f"training {det['train_seconds']} s")
    pipe = image_pipeline.run_image_pipeline(device=dev)
    print(f"path 14 (c) run_image_pipeline at its defaults {image_pipeline.DEFAULTS}: "
          f"{json.dumps(pipe)}")
    print(f"  [{card}] image pipeline stages (ms): {pipe['stage_ms']}")
    for k, ref in REFERENCE_IMAGE.items():
        readme = f"; the README documents {README_IMAGE[k]}" if k in README_IMAGE else ""
        if k in IMAGE_END_TO_END:
            _check(abs(pipe[k] - ref) <= IMAGE_TOL,
                   f"image pipeline {k} within {IMAGE_TOL} of the JAX reference {ref} "
                   f"({pipe[k]}{readme})")
        else:
            print(f"  image pipeline {k} {pipe[k]} (the JAX reference {ref}, from other "
                  f"proposals: {pipe[k] - ref:+.3f})")
    with np.load(os.path.join(here, IMAGE_PROPOSALS)) as z:
        boxes, keep = z["boxes"], z["keep"]
    data = image_pipeline.paired_corpus(image_pipeline.DEFAULTS["n_utterances"],
                                        image_pipeline.DEFAULTS["n_concepts"],
                                        image_pipeline.DEFAULTS["image_size"], dev)
    stage = image_pipeline.score_proposals(data, boxes, keep, device=dev)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    print(f"path 14 (c) the grounding stage from the reference's proposals "
          f"({IMAGE_PROPOSALS}): "
          f"{json.dumps({k: v for k, v in stage.items() if k != 'grounding_loss'})}")
    _check(abs(stage["proposals_per_image"] - float(keep.sum(1).mean())) < 0.01,
           "the stage took the reference's proposals")
    loss = np.asarray(stage["grounding_loss"][:len(REFERENCE_GROUNDING_LOSS)])
    rel = np.abs(loss - REFERENCE_GROUNDING_LOSS) / np.abs(REFERENCE_GROUNDING_LOSS)
    print(f"  grounding loss at steps 0-5, relative difference to the JAX stage's: "
          f"{rel.tolist()}")
    _check(bool(np.all(rel <= GROUNDING_LOSS_RTOL)),
           f"grounding stage from the reference's proposals: loss at steps 0-5 within rtol "
           f"{GROUNDING_LOSS_RTOL} of the JAX stage's")
    for k, ref in REFERENCE_IMAGE.items():
        if k == "alignment_acc":
            _check(abs(stage[k] - ref) <= IMAGE_TOL,
                   f"grounding stage from the reference's proposals: {k} within {IMAGE_TOL} "
                   f"of the JAX reference {ref} ({stage[k]})")
        elif k != "detector_recall@0.5":
            print(f"  grounding stage {k} {stage[k]} (the JAX stage {ref}: {stage[k] - ref:+.3f})")
    launches = _counts(counters)
    _check(not any(launches.values()), "no kernel of K1-K8 launched on path 14")
    return {"vgg": vgg, "detector": det, "pipeline": pipe, "stage": stage,
            "launches": launches}


def crf_minibatch_phase(card: str, counters, dev) -> dict:
    """Path 15 (a): the end-to-end CRF on minibatches through K4, at the
    bench row's settings (B=256, learned transitions) and at the
    reference test's size (B=40, hmm_dnn.init, positional accuracy > 0.9).
    K4 and K3 are checked at each run's first batch and decode."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
    from multimodalworddiscovery_tpu_torch.models import hmm_crf, hmm_dnn, minibatch
    from multimodalworddiscovery_tpu_torch.scripts import bench_kernels as bk

    def inputs_of(params, c, log_emit):
        _, fact = _estep_inputs(params, c)
        return (*fact, log_emit, c.src_len)

    runs = {}
    rf = CRF_MB_REF
    pc, pg, _ = make_flickr8k_mini(**rf["corpus"])
    ref_fc, ref_fg, _ = phones_to_frames(pc, pg, **rf["frames"], device=dev)
    ref_step = minibatch.make_minibatch_step(hmm_crf.em_step, ref_fc, rf["batch"])
    bench_fc, bench_fg, bench_p, bench_step = bk.crf_minibatch_setup(dev)
    for key, fc, fg, params, step, batch, seed in (
            ("bench_B256", bench_fc, bench_fg, bench_p, bench_step, bk.CRF_MB_BATCH, 3),
            ("reference_B40", ref_fc, ref_fg,
             hmm_dnn.init(ref_fc, generator=torch.Generator().manual_seed(0)), ref_step,
             rf["batch"], 0)):
        # K4 at the run's first batch (the draw the run makes first)
        idx = torch.randperm(fc.n, generator=torch.Generator().manual_seed(seed))[:batch]
        b = minibatch.gather_batch(fc, idx)
        with torch.no_grad():
            le = hmm_crf._log_emit_from_mlp(params.mlp, b)
        k4r = _k4_at(f"the CRF minibatch ({key})", inputs_of(params, b, le), card)
        gen = torch.Generator().manual_seed(seed)
        _reset(counters)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        lls = []
        start.record()
        for _ in range(CRF_MB_STEPS):
            params, stats = step(params, gen)
            lls.append(stats["loglik"])
        end.record()
        alignment = hmm_crf.align(params, fc)
        launches = _counts(counters)
        lls = torch.stack(lls).cpu().numpy()
        gold = torch.as_tensor(fg.alignment, device=dev)
        mask = fc.src_mask() & (gold > 0)
        acc = float((alignment == gold)[mask].float().mean())
        ms = start.elapsed_time(end) / CRF_MB_STEPS
        k3r = k3_parity(f"the CRF minibatch decode ({key})",
                        inputs_of(params, fc, hmm_dnn._log_emissions(params, fc)), 10)
        print(f"path 15 (a) CRF minibatch {key}: N={fc.n}, Ts={fc.max_src_len}, "
              f"S={2 * fc.max_trg_len}, B={batch}, {CRF_MB_STEPS} steps; batch logliks "
              f"{lls.tolist()}")
        print(f"  positional accuracy {acc:.5f}; launches {launches}; [{card}] {ms:.4f} ms "
              f"per step (CUDA events)")
        _check(bool(np.all(np.isfinite(lls))), f"{key}: batch logliks finite")
        n_sgd = params.n_sgd
        _check(launches["hmm_estep"] == (n_sgd + 1) * CRF_MB_STEPS and launches["viterbi"] == 1
               and launches["hmm_estep_counts"] == 0 and launches["table_lookup"] == 0,
               f"{key}: K4 launched {n_sgd + 1} times a step (every batch), K3 once")
        runs[key] = {"k4": k4r, "k3": k3r, "launches": launches, "acc": acc, "ms": ms,
                     "lls": lls.tolist()}
    acc = runs["reference_B40"]["acc"]
    _check(acc > rf["min_acc"], f"the reference test's size: positional accuracy > "
                                f"{rf['min_acc']} ({acc:.5f})")
    del bench_fc, ref_fc
    torch.cuda.empty_cache()
    return runs


def viterbi_dense_phase(card: str, counters, dev) -> dict:
    """Path 15 (b): the dense ``hmm_core.viterbi`` (plain torch) at the
    reference's viterbi_dense rows after one EM step, on ``hmm._machinery``'s
    inputs with the emissions through K1, against ``viterbi_factored``
    through K3: equal paths except at exact ties (counted), every path's
    score within rtol 1e-5 of K3's."""
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core
    from multimodalworddiscovery_tpu_torch.ops import counts as k1
    from multimodalworddiscovery_tpu_torch.ops import viterbi as k3

    out = {}
    for label, gen in VITERBI_DENSE_ROWS.items():
        corpus, _, _ = make_flickr8k_mini(**gen, device=dev)
        params, _ = hmm.em_step(hmm.init(corpus), corpus)
        concepts, fact = _estep_inputs(params, corpus)
        _reset(counters)
        # hmm._machinery's dense inputs, its emissions through K1 (the
        # lookup of the port's kernel route; bit-equal to its plain gather)
        li, lt = fact[0], hmm_core.build_log_trans(params.log_jump, params.log_p0, corpus,
                                                   params.max_jump)
        le = k1.table_lookup(params.log_emit, corpus.src, concepts)
        dense = hmm_core.viterbi(li, lt, le, corpus.src_len)
        fast = hmm_core.viterbi_factored(*fact, le, corpus.src_len)
        torch.cuda.synchronize()
        launches = _counts(counters)
        print(f"  launches: {launches}")
        _check(launches["table_lookup"] == 1 and launches["viterbi"] == 1
               and sum(launches.values()) == 2,
               f"viterbi_dense {label}: K1 once (the emissions), K3 once, nothing else")
        machinery = hmm._machinery(params, corpus)
        _check(all(torch.equal(a, b) for a, b in zip((li, lt, le), machinery)),
               f"viterbi_dense {label}: the inputs equal hmm._machinery's")
        del machinery
        inputs = (*fact, le, corpus.src_len)
        s_dense = k3.path_score(dense, *inputs)
        s_fast = k3.path_score(fast, *inputs)
        valid = corpus.src_mask()
        differ = ~(torch.where(valid, dense, 0) == torch.where(valid, fast, 0)).all(dim=1)
        ties = int(differ.sum())
        err = float(((s_dense - s_fast).abs() / s_fast.abs().clamp(min=1e-30)).max())
        print(f"path 15 (b) viterbi_dense {label}: N={corpus.n}, Ts={corpus.max_src_len}, "
              f"S={2 * corpus.max_trg_len}; paths differing from K3's: {ties} utterances "
              f"(exact ties), largest relative path-score difference {err:.3e}")
        _check(torch.allclose(s_dense, s_fast, rtol=1e-5, atol=0),
               f"viterbi_dense {label}: every path's score within rtol 1e-5 of K3's (the "
               f"{ties} differing paths are ties)")
        ms_dense = _gpu_ms(lambda: hmm_core.viterbi(li, lt, le, corpus.src_len), 5)
        k3r = k3_parity(f"viterbi_dense {label}", inputs, 20)
        k1r = k1_check(f"viterbi_dense {label}", params.log_emit, corpus.src, concepts, 20)
        print(f"  [{card}] ms per decode: dense (plain torch) {ms_dense:.4f}, factored through "
              f"K3 {k3r['ms']:.4f}, factored plain {k3r['plain_ms']:.4f}")
        out[label] = {"ties": ties, "err": err, "ms_dense": ms_dense, "k3": k3r, "k1": k1r,
                      "launches": launches}
        del corpus, params, li, lt, le, dense, fast
        torch.cuda.empty_cache()
    return out



def _stream_em_checks(what: str, lls, want_lls, params, want_params, fields) -> None:
    """Streamed EM against resident EM (tests/test_stream.py:68-73): the
    logliks within rtol 1e-5, each parameter in ``fields`` within atol
    1e-4."""
    import numpy as np

    lls, want_lls = np.asarray(lls, np.float64), np.asarray(want_lls, np.float64)
    rel = float(np.max(np.abs(lls - want_lls) / np.abs(want_lls)))
    print(f"  {what}: loglik per iteration {lls.tolist()} (resident {want_lls.tolist()}), "
          f"largest relative difference {rel:.3e}")
    _check(rel <= 1e-5, f"{what}: logliks within rtol 1e-5 of resident EM")
    errs = {f: _max_abs(getattr(params, f), getattr(want_params, f)) for f in fields}
    _check(max(errs.values()) <= 1e-4, f"{what}: parameters within atol 1e-4 of resident EM "
                                       f"(max abs err {errs})")


def _stream_gauss_checks(what: str, lls, want_lls, params, want_params, means64) -> None:
    """Streamed Gaussian EM against resident EM at the stretch shape: the
    logliks within rtol 1e-5 (tests/test_stream.py:127-133); the means,
    whose float32 sums run over 1.6M frames here, within the resident
    float32 run's own distance from the same EM in float64 (``means64``):
    streaming adds nothing beyond float32 rounding.  The reference test's
    atol 1e-4, set on 30 utterances, is printed beside it."""
    import numpy as np

    lls, want_lls = np.asarray(lls, np.float64), np.asarray(want_lls, np.float64)
    rel = float(np.max(np.abs(lls - want_lls) / np.abs(want_lls)))
    print(f"  {what}: loglik per iteration {lls.tolist()} (resident {want_lls.tolist()}), "
          f"largest relative difference {rel:.3e}")
    _check(rel <= 1e-5, f"{what}: logliks within rtol 1e-5 of resident EM")
    d = _max_abs(params.means, want_params.means)
    e_res, e_str = _max_abs(want_params.means, means64), _max_abs(params.means, means64)
    print(f"  {what}: means, max abs difference streamed - resident {d:.3e} (atol 1e-4 "
          f"{'met' if d <= 1e-4 else 'not met'}); against float64 resident {e_res:.3e}, "
          f"streamed {e_str:.3e}; largest |mean| {float(means64.abs().max()):.4f}")
    _check(d <= e_res, f"{what}: means within the resident float32 run's distance from "
                       f"float64 ({d:.3e} <= {e_res:.3e})")


def stream_phase(here: str, card: str, counters, dev, tmp: str) -> dict:
    """Path 16: the headline discrete EM streamed from disk (bench_stream's
    N=65536 corpus in shards of 8192: K1 + K2 at the shard shape) against
    resident EM (K1 + K2 at N=65536) at prefetch 1 and 2, Model-1 over the
    same shards, bench_stream's rows, then bucketed EM and decode on the
    headline corpus (K1 + K2 and K3 at each bucket's shape)."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.data.bucketing import bucket_corpus, padding_waste
    from multimodalworddiscovery_tpu_torch.data.stream import (
        ShardedCorpusReader,
        train_streaming,
        write_shards,
    )
    from multimodalworddiscovery_tpu_torch.models import bucketed, hmm, hmm_core, model1
    from multimodalworddiscovery_tpu_torch.scripts import bench_stream

    t_path = time.perf_counter()
    corpus, _, _ = make_flickr8k_mini(**STREAM, device=dev)
    d = os.path.join(tmp, "stream")
    t0 = time.perf_counter()
    n_shards = write_shards(corpus, d, STREAM_SHARD)
    reader = ShardedCorpusReader(d, device=dev)
    print(f"path 16 (streamed and bucketed discrete EM): N={corpus.n}, Ts={corpus.max_src_len}, "
          f"S={2 * corpus.max_trg_len}, {n_shards} shards of {STREAM_SHARD} written in "
          f"{time.perf_counter() - t0:.2f} s, {STREAM_ITERS} EM iterations")
    shard0 = reader.load_shard(0)
    checks = {"stream_resident": parity("path 16 resident (N=65536)", corpus, reps=5),
              "stream_shard": parity("path 16 shard (N=8192)", shard0, reps=5)}
    p0 = hmm.init(corpus)
    k1s = {"stream_resident": k1_check("path 16 resident", p0.log_emit, corpus.src,
                                       hmm_core.state_concepts(corpus), 50),
           "stream_shard": k1_check("path 16 shard", p0.log_emit, shard0.src,
                                    hmm_core.state_concepts(shard0), 50)}
    del shard0

    _reset(counters)
    (pr, lls_r), ms_res = _timed(lambda: hmm.train(p0, corpus, STREAM_ITERS, use_kernels=True))
    launches = {"stream_resident": _counts(counters)}
    _reset(counters)
    ms_str = {}
    for prefetch in (1, 2):
        (ps, lls), ms_str[prefetch] = _timed(lambda: train_streaming(
            hmm, p0, reader, STREAM_ITERS, prefetch=prefetch, use_kernels=True))
        _stream_em_checks(f"path 16 streamed hmm (prefetch {prefetch})", lls,
                          lls_r.cpu().numpy(), ps, pr, ("log_emit", "log_jump", "log_p0"))
    launches["stream_shard"] = _counts(counters)
    _check(launches["stream_resident"]["hmm_estep_counts"] == STREAM_ITERS
           and launches["stream_shard"]["hmm_estep_counts"] == 2 * STREAM_ITERS * n_shards
           and launches["stream_shard"]["table_lookup"] == 2 * STREAM_ITERS * n_shards,
           f"path 16: K1 and K2 once an iteration resident, once a shard an iteration streamed")
    print(f"  [{card}] path 16 ms per EM iteration (one run, CUDA events): resident "
          f"{ms_res / STREAM_ITERS:.3f}, streamed prefetch 1 {ms_str[1] / STREAM_ITERS:.3f}, "
          f"prefetch 2 {ms_str[2] / STREAM_ITERS:.3f}")

    _reset(counters)
    m0 = model1.init(corpus)
    pm_r, lm_r = model1.train(m0, corpus, STREAM_ITERS)
    for prefetch in (1, 2):
        pm_s, lm_s = train_streaming(model1, m0, reader, STREAM_ITERS, prefetch=prefetch,
                                     use_kernels=True)
        _stream_em_checks(f"path 16 streamed Model-1 (prefetch {prefetch})", lm_s,
                          lm_r.cpu().numpy(), pm_s, pm_r, ("log_t",))
    launches["model1"] = _counts(counters)
    _check(sum(launches["model1"].values()) == 0,
           "path 16: Model-1's EM launches no kernel (its counts are index_add_ statistics)")
    del pm_r, pm_s, ps

    rows = bench_stream.run(STREAM["n_utterances"], STREAM_SHARD, STREAM_ITERS, 3, dev,
                            pathlib.Path(here, "build", "chip_smoke", "bench_stream.jsonl"))
    for r in rows:
        if r["bench"] == "stream_breakdown":
            print(f"  [{card}] bench_stream breakdown: {r['read_ms_per_shard']:.3f} ms to read "
                  f"and copy a shard; an EM iteration over the shards on the device "
                  f"{r['em_on_device_shards_ms_per_iter']:.3f} ms, loading them in the same "
                  f"loop (no reader thread) {r['em_no_thread_ms_per_iter']:.3f} ms")
            continue
        print(f"  [{card}] bench_stream {r['bench']}"
              + (f" prefetch {r['prefetch']}" if "prefetch" in r else "")
              + f": {r['ms_per_iter']:.3f} ms per iteration, {r['utt_iter_per_s']:.0f} "
                f"utt*iter/s" + (f", overlap efficiency {r['overlap_efficiency']:.4f}"
                                 if "overlap_efficiency" in r else ""))
    del corpus, reader
    torch.cuda.empty_cache()

    # bucketed EM and decode on the headline corpus
    hc, _, _ = make_flickr8k_mini(**HEADLINE, device=dev)
    buckets = bucket_corpus(hc, BUCKET_EDGES)
    waste = {"resident": padding_waste(hc),
             **{f"bucket_{i}": padding_waste(b) for i, (b, _) in enumerate(buckets)}}
    waste["buckets_total"] = (sum(padding_waste(b) * b.n * b.max_src_len for b, _ in buckets)
                              / sum(b.n * b.max_src_len for b, _ in buckets))
    print(f"  bucketed (edges {BUCKET_EDGES}): buckets of "
          f"{[(b.n, b.max_src_len) for b, _ in buckets]} (N, Ts); padding waste {waste}")
    ph = hmm.init(hc)
    for i, (b, _) in enumerate(buckets):
        name = f"bucket_{i}"
        checks[name] = parity(f"path 16 bucket {i} (N={b.n}, Ts={b.max_src_len})", b, reps=5)
        k1s[name] = k1_check(f"path 16 bucket {i}", ph.log_emit, b.src,
                             hmm_core.state_concepts(b), 50)
    _reset(counters)
    (pf, lls_f), ms_full = _timed(lambda: hmm.train(ph, hc, STREAM_ITERS, use_kernels=True))
    a_full = hmm.align(pf, hc, use_kernels=True).cpu().numpy()
    launches["headline"] = _counts(counters)
    _reset(counters)
    (pb, lls_b), ms_b = _timed(lambda: bucketed.train_bucketed(
        hmm, ph, hc, BUCKET_EDGES, STREAM_ITERS, use_kernels=True))
    a_b = bucketed.align_bucketed(hmm, pb, hc, BUCKET_EDGES, use_kernels=True)
    launches["buckets"] = _counts(counters)
    nb = len(buckets)
    _check(launches["buckets"]["hmm_estep_counts"] == nb * STREAM_ITERS
           and launches["buckets"]["table_lookup"] == nb * STREAM_ITERS
           and launches["buckets"]["viterbi"] == nb,
           f"path 16 bucketed: K1 and K2 once a bucket an iteration, K3 once a bucket")
    lf, lb = lls_f.cpu().numpy(), np.asarray(lls_b)
    rel = float(np.max(np.abs(lb - lf) / np.abs(lf)))
    print(f"  bucketed loglik {lb.tolist()} (resident {lf.tolist()}), largest relative "
          f"difference {rel:.3e}")
    _check(rel <= 1e-4, "path 16 bucketed: logliks within rtol 1e-4 of resident EM")
    err = _max_abs(pb.log_emit, pf.log_emit)
    _check(err <= 1e-3, f"path 16 bucketed: log_emit within atol 1e-3 of resident ({err})")
    agree = float((a_b == a_full).mean())
    _check(agree > 0.999, f"path 16 bucketed decode agrees with the resident decode on "
                          f"{agree:.6f} > 0.999 of positions")
    k3s = {}
    for i, (b, _) in enumerate(buckets):
        _, fact = _estep_inputs(pb, b)
        k3s[f"bucket_{i}"] = k3_parity(f"path 16 bucket {i} decode",
                                       (*fact, hmm._log_emissions(pb, b), b.src_len), 10)
    print(f"  [{card}] path 16 bucketed against resident, ms per EM iteration (one run of "
          f"{STREAM_ITERS}, CUDA events): bucketed {ms_b / STREAM_ITERS:.3f}, resident "
          f"{ms_full / STREAM_ITERS:.3f}")
    print(f"path 16 wall time {time.perf_counter() - t_path:.1f} s")
    return {"checks": checks, "k1": k1s, "k3": k3s, "launches": launches, "n_buckets": nb,
            "rows": rows, "waste": waste, "dir": d,
            "resident": {"p0": p0, "params": pr, "lls": lls_r.cpu().numpy()},
            "ms": {"resident": ms_res / STREAM_ITERS,
                   **{f"streamed_prefetch{p}": m / STREAM_ITERS for p, m in ms_str.items()},
                   "bucketed": ms_b / STREAM_ITERS, "headline_resident": ms_full / STREAM_ITERS}}


def stream_recipe_phase(card: str, counters, dev, tmp: str, fc, fg, p_recipe,
                        f1_recipe: float) -> dict:
    """Path 17: the stretch recipe out of core on path 3's corpus, written
    with gold in shards of 1000: ``init_vq_teacher_streaming`` (K1 + K2 on
    the code shards, K1 + K4 in the seeding rounds), streamed annealed
    Gaussian EM (K4), decode shard by shard (K3); then 2 streamed
    iterations from path 3's initial parameters against 2 resident ones, on
    float32 and on float16 shards."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.data.stream import (
        ShardedCorpusReader,
        train_streaming,
        write_shards,
    )
    from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf
    from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core, hmm_gaussian

    t_path = time.perf_counter()
    d32, d16, dcode = (os.path.join(tmp, n) for n in ("stretch32", "stretch16", "codes"))
    t0 = time.perf_counter()
    n_shards = write_shards(fc, d32, STRETCH_SHARD, gold=fg)
    reader = ShardedCorpusReader(d32, device=dev)
    print(f"path 17 (the stretch recipe out of core): N={fc.n} in {n_shards} shards of "
          f"{STRETCH_SHARD}, written in {time.perf_counter() - t0:.2f} s")
    # the launch shapes: the code shards (K1, K2 and K4 on the teacher's
    # emissions) and the frame shards (K4 on Gaussian emissions, K3)
    shard0 = reader.load_shard(0)
    pad0 = shard0.pad_to(shard0.n + ZERO_LENGTH_PAD)
    _, fact = _estep_inputs(p_recipe, pad0)
    k4_shard = k4_check("path 17 frame shard (N=1000)",
                        (*fact, hmm_gaussian._log_emissions(p_recipe, pad0), pad0.src_len), 10)
    _, fact = _estep_inputs(p_recipe, shard0)
    k3_shard = k3_parity("path 17 frame shard (N=1000)",
                         (*fact, hmm_gaussian._log_emissions(p_recipe, shard0), shard0.src_len),
                         10)
    del pad0, fact

    _reset(counters)
    t0 = time.perf_counter()
    pv = hmm_gaussian.init_vq_teacher_streaming(
        reader, dcode, max_jump=MAX_JUMP, n_components=2,
        generator=torch.Generator().manual_seed(SEED), n_codes=N_CODES,
        teacher_iters=EM_ITERS, seed_rounds=3, use_kernels=True, prefetch=2)
    torch.cuda.synchronize()
    t_seed = time.perf_counter() - t0
    teach = _counts(counters)
    code_reader = ShardedCorpusReader(dcode, device=dev)
    _check(teach["table_lookup"] == (EM_ITERS + 3) * n_shards
           and teach["hmm_estep_counts"] == EM_ITERS * n_shards
           and teach["hmm_estep"] == 3 * n_shards,
           "path 17 teacher: K1 and K2 once a code shard an EM iteration, K1 and K4 once a "
           "code shard a seeding round")
    code0 = code_reader.load_shard(0)
    tp0 = hmm.init(code0, max_jump=MAX_JUMP)
    teacher_checks = parity("path 17 code shard (N=1000)", code0, max_jump=MAX_JUMP, reps=5,
                            bf16_flips=True)
    teacher_k1 = k1_check("path 17 code shard", tp0.log_emit, code0.src,
                          hmm_core.state_concepts(code0), 50)
    del code0

    _reset(counters)
    t0 = time.perf_counter()
    sched = hmm_gaussian.anneal_scales(EM_ITERS, ANNEAL)
    ps, lls = train_streaming(hmm_gaussian, pv, reader, EM_ITERS, scale_schedule=sched,
                              prefetch=2, use_kernels=True)
    alignment = torch.cat([hmm_gaussian.align(ps, s, use_kernels=True)
                           for s in reader.shards(2)])[: fc.n]
    torch.cuda.synchronize()
    t_em = time.perf_counter() - t0
    gauss = _counts(counters)
    _check(gauss["hmm_estep"] == EM_ITERS * n_shards and gauss["viterbi"] == n_shards,
           "path 17: K4 once a shard an EM iteration, K3 once a shard")
    gold_t = torch.as_tensor(fg.alignment, device=dev)
    prf = {k: float(v) for k, v in alignment_prf(alignment, gold_t, fc.src_mask()).items()}
    f1 = prf["f1"]
    print(f"  streamed recipe: seeding {t_seed:.2f} s, EM + decode {t_em:.2f} s; loglik "
          f"{lls}; alignment {prf}; launches (teacher, Gaussian) {(teach, gauss)}")
    _check(bool(np.all(np.isfinite(lls))), "path 17 loglik finite")
    _check(f1 >= 0.30, f"path 17 streamed recipe F1 >= 0.30 ({f1:.4f})")
    _check(abs(f1 - f1_recipe) <= 0.10, f"path 17 streamed recipe F1 within 0.10 of path 3's "
                                        f"resident recipe ({f1:.4f} vs {f1_recipe:.4f})")

    # (b) two streamed iterations from path 3's initial parameters
    _reset(counters)
    sched2 = hmm_gaussian.anneal_scales(2, ANNEAL)
    ps2, lls2 = train_streaming(hmm_gaussian, p_recipe, reader, 2, scale_schedule=sched2,
                                use_kernels=True)
    exact = _counts(counters)
    _reset(counters)
    pr2, lls_r2 = hmm_gaussian.train(p_recipe, fc, 2, use_kernels=True, anneal=ANNEAL)
    exact_res = _counts(counters)

    def means64(corpus):
        """The same 2 resident iterations in float64 (the plain route)."""
        c64 = dataclasses.replace(corpus, src=corpus.src.double())
        return hmm_gaussian.train(_as_float64(p_recipe), c64, 2, use_kernels=False,
                                  anneal=ANNEAL)[0].means

    _stream_gauss_checks("path 17 streamed Gaussian EM (float32 shards)", lls2,
                         lls_r2.cpu().numpy(), ps2, pr2, means64(fc))

    # (c) float16 storage
    _reset(counters)
    write_shards(fc, d16, STRETCH_SHARD, storage_dtype="float16")
    sz32 = os.path.getsize(os.path.join(d32, "src_0.npy"))
    sz16 = os.path.getsize(os.path.join(d16, "src_0.npy"))
    print(f"  float16 storage: src_0.npy {sz16} bytes against {sz32} ({sz16 / sz32:.4f})")
    _check(sz16 < 0.55 * sz32, "path 17: float16 shards under 0.55x the float32 bytes")
    r16 = ShardedCorpusReader(d16, device=dev)
    ps16, lls16 = train_streaming(hmm_gaussian, p_recipe, r16, 2, scale_schedule=sched2,
                                  use_kernels=True)
    exact16 = _counts(counters)
    _reset(counters)
    rounded = dataclasses.replace(fc, src=fc.src.half().float())
    pr16, lls_r16 = hmm_gaussian.train(p_recipe, rounded, 2, use_kernels=True, anneal=ANNEAL)
    exact16_res = _counts(counters)
    _stream_gauss_checks("path 17 streamed Gaussian EM (float16 shards, against the rounded "
                         "corpus)", lls16, lls_r16.cpu().numpy(), ps16, pr16, means64(rounded))
    del rounded
    torch.cuda.empty_cache()
    print(f"path 17 wall time {time.perf_counter() - t_path:.1f} s")
    shard_k4 = exact["hmm_estep"] + exact16["hmm_estep"] + gauss["hmm_estep"] + teach["hmm_estep"]
    return {"f1": f1, "prf": prf, "k4": k4_shard, "k3": k3_shard, "k2": teacher_checks,
            "k1": teacher_k1,
            "launches": {"teacher": teach, "gauss": gauss, "exact": exact,
                         "exact16": exact16, "resident": exact_res,
                         "resident16": exact16_res},
            "shard_k4": shard_k4, "seconds": (t_seed, t_em)}


def _dnn_streamed_against_resident(what: str, card: str, counters, dev, tmp: str, corpus_kw,
                                   frames_kw, model_kw, shard_size: int, iters: int) -> dict:
    """The streamed DNN-HMM (K4 at the shard shape) and the resident one
    (K4 at the corpus's shape) from the same initial parameters, each
    decoded through K3 and scored by positional accuracy; K4 (and K3) held
    to their plain versions at both shapes first."""
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
    from multimodalworddiscovery_tpu_torch.data.stream import ShardedCorpusReader, write_shards
    from multimodalworddiscovery_tpu_torch.models import hmm_dnn

    pc, pg, _ = make_flickr8k_mini(**corpus_kw, device=dev)
    fc, fg, _ = phones_to_frames(pc, pg, **frames_kw, device=dev)
    d = os.path.join(tmp, what.replace(" ", "_"))
    n_shards = write_shards(fc, d, shard_size, gold=fg)
    reader = ShardedCorpusReader(d, device=dev)
    print(f"  {what}: N={fc.n}, Ts={fc.max_src_len}, S={2 * fc.max_trg_len}, D="
          f"{fc.src.shape[-1]} in {n_shards} shards of {shard_size}; model {model_kw}, "
          f"{iters} iterations")

    def initial():
        return hmm_dnn.init(fc, **model_kw, generator=torch.Generator().manual_seed(SEED))

    p0 = initial()
    shapes = {}
    for key, c in (("shard", reader.load_shard(0)), ("resident", fc)):
        _, fact = _estep_inputs(p0, c)
        shapes[key] = _k4_at(f"{what} {key} (N={c.n})",
                             (*fact, hmm_dnn._log_emissions(p0, c), c.src_len), card)
    gold_t = torch.as_tensor(fg.alignment, device=dev)
    mask = fc.src_mask() & (gold_t > 0)
    _reset(counters)
    ps, lls_s = hmm_dnn.train_streaming(p0, reader, iters, use_kernels=True, prefetch=2)
    launches = {"shard": _counts(counters)}
    _reset(counters)
    pr, lls_r = hmm_dnn.train(initial(), fc, iters, use_kernels=True)
    acc = {name: float((hmm_dnn.align(params, fc, use_kernels=True) == gold_t)[mask]
                       .float().mean()) for name, params in (("streamed", ps), ("resident", pr))}
    launches["resident"] = _counts(counters)
    print(f"  {what} streamed: loglik {lls_s}, positional accuracy {acc['streamed']:.5f}")
    print(f"  {what} resident: loglik {lls_r.tolist()}, positional accuracy "
          f"{acc['resident']:.5f}; launches {launches}")
    _check(launches["shard"]["hmm_estep"] == iters * n_shards
           and launches["resident"]["hmm_estep"] == iters
           and launches["resident"]["viterbi"] == 2,
           f"{what}: K4 once a shard an iteration streamed, once an iteration resident, K3 "
           f"once a decode")
    return {"lls": lls_s, "acc": acc, "shapes": shapes, "launches": launches}


def stream_gradient_phase(card: str, counters, dev, tmp: str) -> dict:
    """Path 18: the streamed DNN-HMM (hmm_dnn.train_streaming) against the
    resident trainer on the DNN-HMM path's corpus in 4 shards, held to the
    JAX package's streamed run from the same initial parameters
    (REFERENCE_STREAM_DNN), and at tests/test_stream.py:854-882's own
    configuration, held to its bounds; then the attention step on path
    11's corpus in 4 shards (train_minibatch_streaming, B=512), with a
    resumed run against the uninterrupted one."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.data.stream import ShardedCorpusReader, write_shards
    from multimodalworddiscovery_tpu_torch.models import attention, minibatch
    from multimodalworddiscovery_tpu_torch.scripts import bench_kernels as bk

    t_path = time.perf_counter()
    print(f"path 18 (streamed gradient trainers): the DNN-HMM at the DNN-HMM path's "
          f"configuration and at the reference test's; attention on path 11's corpus in "
          f"{ATT_STREAM_SHARDS} shards, B={bk.ATT_BATCH}, {ATT_STREAM_STEPS} steps")
    dnn = {"crf": _dnn_streamed_against_resident(
        "path 18 DNN-HMM (hmm_crf_frames corpus)", card, counters, dev, tmp, CRF_CORPUS,
        CRF_FRAMES, CRF_MODEL, CRF_CORPUS["n_utterances"] // DNN_SHARDS, DNN_ITERS)}
    r, ref = dnn["crf"], REFERENCE_STREAM_DNN
    rel = [abs(a - b) / abs(b) for a, b in zip(r["lls"][:2], ref["loglik"][:2])]
    print(f"  JAX reference, streamed from the same parameters: loglik {ref['loglik']}, "
          f"accuracy {ref['positional_accuracy']}; relative loglik differences of the first "
          f"two iterations {rel}")
    _check(rel[0] <= 1e-4 and rel[1] <= 1e-3,
           "path 18 streamed DNN-HMM: the first iteration's loglik within rtol 1e-4 and the "
           "second's within rtol 1e-3 of the JAX package's streamed run")
    _check(abs(r["acc"]["streamed"] - ref["positional_accuracy"]) <= 0.01
           and abs(r["lls"][-1]) <= 1.0,
           f"path 18 streamed DNN-HMM collapses as the JAX package's does at this "
           f"configuration: accuracy within 0.01 of its {ref['positional_accuracy']} "
           f"({r['acc']['streamed']:.5f}), final |loglik| <= 1 ({r['lls'][-1]:.5f})")
    print(f"  at this configuration tests/test_stream.py:881-882's bounds fail in both "
          f"packages (reference fault, ROADMAP queue 3): the loglik rises "
          f"{r['lls'][-1] > r['lls'][0]}, accuracy at least the resident's minus 0.05 "
          f"{r['acc']['streamed'] >= r['acc']['resident'] - 0.05}")
    dnn["test"] = _dnn_streamed_against_resident(
        "path 18 DNN-HMM (tests/test_stream.py's configuration)", card, counters, dev, tmp,
        STREAM_TEST_CORPUS, STREAM_TEST_FRAMES, STREAM_TEST_MODEL, STREAM_TEST_SHARD,
        STREAM_TEST_ITERS)
    r = dnn["test"]
    _check(r["lls"][-1] > r["lls"][0], "path 18 streamed DNN-HMM at the reference test's "
                                       "configuration: the loglik rises")
    _check(r["acc"]["streamed"] >= r["acc"]["resident"] - 0.05,
           f"path 18 streamed DNN-HMM at the reference test's configuration: accuracy at "
           f"least the resident's minus 0.05 ({r['acc']['streamed']:.5f} vs "
           f"{r['acc']['resident']:.5f})")
    launches = {f"dnn_{k}_{w}": v for k, r in dnn.items() for w, v in r["launches"].items()}
    torch.cuda.empty_cache()

    mc, _, _ = make_flickr8k_mini(**bk.MODELS_CORPUS, device=dev)
    da = os.path.join(tmp, "attention")
    write_shards(mc, da, mc.n // ATT_STREAM_SHARDS)
    ra = ShardedCorpusReader(da, device=dev)
    del mc

    def fresh():
        return attention.init(ra.load_shard(0), dim=bk.MODEL_DIM,
                              generator=torch.Generator().manual_seed(SEED))

    def run(state, steps, start=0):
        losses = []
        (state, _), ms = _timed(lambda: minibatch.train_minibatch_streaming(
            _recording(attention.em_step, losses), state, ra, bk.ATT_BATCH, steps, seed=SEED,
            start_step=start, prefetch=2))
        return state, torch.stack(losses).cpu().numpy(), ms

    _reset(counters)
    _, full, ms = run(fresh(), ATT_STREAM_STEPS)
    state, first, _ = run(fresh(), ATT_RESUME)
    _, rest, _ = run(state, ATT_STREAM_STEPS - ATT_RESUME, start=ATT_RESUME)
    launches["attention"] = _counts(counters)
    print(f"  attention streamed: loss {full[0]:.5f} at the first step, {full[-1]:.5f} at the "
          f"last; [{card}] {ATT_STREAM_STEPS} steps in {ms:.1f} ms (CUDA events)")
    _check(full[-1] < full[0], "path 18 streamed attention: the loss falls")
    _check(np.allclose(first, full[:ATT_RESUME], rtol=1e-5, atol=0)
           and np.allclose(rest, full[ATT_RESUME:], rtol=1e-5, atol=0),
           f"path 18: the run resumed at step {ATT_RESUME} gives the uninterrupted run's "
           f"losses within rtol 1e-5 (max rel "
           f"{float(np.max(np.abs(rest - full[ATT_RESUME:]) / np.abs(full[ATT_RESUME:]))):.3e})")
    _check(sum(launches["attention"].values()) == 0, "path 18 attention: no kernel")
    print(f"path 18 wall time {time.perf_counter() - t_path:.1f} s")
    return {"dnn": dnn, "launches": launches}


def _adam_resolved_close(what: str, got: list, new, adam, steps: int) -> float:
    """A data-parallel state (``got``: its tensors in
    ``core.collectives.tensors_of`` order, the model's weights first)
    against the one-process state ``new``: within rtol 1e-5, atol 1e-6,
    except the model weights whose RMS gradient over ``steps`` Adam steps
    lies below 1e-6 (a hundred times Adam's eps: the attention key biases,
    to which the softmax is invariant, and embedding rows outside the
    batch), where Adam's normalised step turns rounding noise into up to a
    learning rate of movement either way; those are held to their steps of
    the learning rate.  Returns the largest difference at the others."""
    import numpy as np

    from multimodalworddiscovery_tpu_torch.core.collectives import tensors_of
    from multimodalworddiscovery_tpu_torch.models.hmm_dnn import ADAM_B2

    worst, noise, ok_all = 0.0, 0, True
    for i, (a, b) in enumerate(zip(got, tensors_of(new))):
        b = b.detach().cpu().numpy()
        ok = np.ones(b.shape, bool)
        if i < len(adam.nu):
            ok = np.sqrt(adam.nu[i].cpu().numpy() / (1 - ADAM_B2 ** steps)) >= 1e-6
            noise += int((~ok).sum())
            ok_all &= bool(np.all(np.abs(a - b)[~ok] <= 2 * steps * new.learning_rate))
        d = np.abs(a[ok].astype(np.float64) - b[ok])
        if d.size:
            worst = max(worst, float(d.max()))
            ok_all &= bool(np.all(d <= 1e-6 + 1e-5 * np.abs(b[ok])))
    print(f"  {what}: largest parameter difference {worst:.3e} ({noise} weights with a "
          f"rounding-noise gradient, held to {steps} learning rates)")
    _check(ok_all, f"{what}: parameters within rtol 1e-5, atol 1e-6 of one process on the "
                   f"same rows")
    return worst


def _path19b_rank(cfg: dict) -> dict:
    """One rank of path 19b (spawned by ``parallel.multihost.spawn`` on the
    one card, gloo with CUDA tensors): every leg on this rank's rows, its
    kernel launch counts per leg, its results on the host."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.core.collectives import group_of, tensors_of
    from multimodalworddiscovery_tpu_torch.core.mesh import make_mesh
    from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
    from multimodalworddiscovery_tpu_torch.data.stream import ShardedCorpusReader
    from multimodalworddiscovery_tpu_torch.models import attention, grounding, hmm, minibatch
    from multimodalworddiscovery_tpu_torch.ops import _build
    from multimodalworddiscovery_tpu_torch.parallel import make_shard_map_em_step, multihost
    from multimodalworddiscovery_tpu_torch.parallel import shard_corpus
    from multimodalworddiscovery_tpu_torch.parallel.sequence import estep_time_sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    counters = _counters()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh()
    rank = mesh.get_local_rank()
    out = {"launches": {}}

    def host(t):
        return [x.detach().cpu().numpy() for x in t]

    def load(path):
        return {k: v.to(dev) for k, v in torch.load(path).items()}

    # the headline EM, N/2 a rank (K1 + K2 at the rank's shard)
    f = load(cfg["headline"])
    corpus = Corpus(f["src"], f["src_len"], f["trg"], f["trg_len"], cfg["vocab"][0],
                    cfg["vocab"][1])
    shard = shard_corpus(corpus, mesh)
    p0 = hmm.init(corpus)
    step = make_shard_map_em_step(hmm, mesh)
    _reset(counters)
    p, lls = p0, []
    for _ in range(EM_ITERS):
        p, st = step(p, shard)
        lls.append(st["loglik"])
    torch.cuda.synchronize()
    out["launches"]["headline"] = _counts(counters)
    out["headline"] = {"lls": torch.stack(lls).cpu().numpy(), "n_local": shard.n,
                       "params": {k: getattr(p, k).cpu().numpy()
                                  for k in ("log_emit", "log_jump", "log_p0")}}
    out["headline"]["timing"] = _dp_iteration_ms(hmm, p0, shard, group_of(mesh))

    # the time-sharded E-step (K8 for the composes)
    f = load(cfg["seq"])
    seq_mesh = make_mesh(axis_name="seq")
    args = (f["log_init"], f["log_trans"], f["log_emit"], f["src_len"], f["smask"], seq_mesh)
    _reset(counters)
    gamma, xi, logz = estep_time_sharded(*args)
    torch.cuda.synchronize()
    out["launches"]["seq"] = _counts(counters)
    out["seq"] = {"gamma": gamma.cpu().numpy(), "xi": xi.cpu().numpy(),
                  "logz": logz.cpu().numpy(), "timing": _wall_ms(lambda: estep_time_sharded(*args),
                                                    group_of(seq_mesh))}

    # one data-parallel attention step and one grounding step against the
    # parent's one-process steps on the same rows, then PAR_ATT_STEPS steps
    f = load(cfg["models"])
    mc = Corpus(f["src"], f["src_len"], f["trg"], f["trg_len"], cfg["models_vocab"][0],
                cfg["models_vocab"][1])
    mshard = shard_corpus(mc, mesh)
    for name, mod, batch in (("attention", attention, cfg["att_batch"]),
                             ("grounding", grounding, cfg["ground_batch"])):
        state = mod.init(mc, dim=cfg["dim"], generator=torch.Generator().manual_seed(SEED))
        mstep = minibatch.make_minibatch_step(mod.em_step, mshard, batch, mesh=mesh)
        _reset(counters)
        new, st = mstep(state, torch.Generator().manual_seed(SEED + 1))
        torch.cuda.synchronize()
        out["launches"][name] = _counts(counters)
        out[name] = {"params": host(tensors_of(new)), "loss": float(st["loss"])}
        if name == "attention":
            losses = []
            gen = torch.Generator().manual_seed(SEED + 2)
            t0 = time.perf_counter()
            for _ in range(PAR_ATT_STEPS):
                new, st = mstep(new, gen)
                losses.append(st["loss"])
            out[name]["losses"] = torch.stack(losses).cpu().numpy()
            out[name]["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / PAR_ATT_STEPS
    del mc, mshard

    # the merged reservoir, and streamed EM in rounds of PAR_RANKS shards
    frames = ShardedCorpusReader(cfg["frames_dir"], device=dev)
    res = multihost.reservoir_frames_multihost(frames, PAR_RESERVOIR, mesh=mesh)
    out["reservoir"] = res if rank == 0 else None
    out["reservoir_digest"] = float(np.asarray(res, np.float64).sum())
    reader = ShardedCorpusReader(cfg["stream_dir"], device=dev)
    f = load(cfg["stream_p0"])
    sp0 = hmm.HMMParams(f["log_emit"], f["log_jump"], f["log_p0"], max_jump=cfg["max_jump"])
    _reset(counters)
    ps, slls = multihost.train_streaming_multihost(hmm, sp0, reader, STREAM_ITERS, mesh=mesh)
    torch.cuda.synchronize()
    out["launches"]["stream"] = _counts(counters)
    out["stream"] = {"lls": np.asarray(slls), "params": {
        k: getattr(ps, k).cpu().numpy() for k in ("log_emit", "log_jump", "log_p0")}}
    return out


TIMING_WINDOWS = 5  # path 19's timings: the median and range over this many windows
WINDOW_ITERS, WINDOW_S = 50, 1.0  # a window: 50 iterations, or fewer once it passes 1 s


def _spread(xs) -> dict:
    """Median and range of the windows' values."""
    import numpy as np

    return {"median": float(np.median(xs)), "min": float(min(xs)), "max": float(max(xs)),
            "windows": len(xs)}


def _fmt(d: dict, scale: float = 1.0, digits: int = 4) -> str:
    return (f"{d['median'] * scale:.{digits}f} (range {d['min'] * scale:.{digits}f}-"
            f"{d['max'] * scale:.{digits}f} over {d['windows']} windows)")


def _wall_ms(fn, group=None) -> dict:
    """Wall time of ``fn()`` in ms, the device synchronized around each
    window (a collective's host side included): after two warm-up calls,
    ``TIMING_WINDOWS`` windows of ``WINDOW_ITERS`` calls, or of as many as
    the second warm-up says fill ``WINDOW_S`` where that is fewer (the
    largest count over ``group``'s ranks, whose calls must pair up); the
    median and range of the windows' means, and the calls a window ran."""
    import math

    import torch

    from multimodalworddiscovery_tpu_torch.core.collectives import all_max

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = min(WINDOW_ITERS, math.ceil(WINDOW_S / max(time.perf_counter() - t0, 1e-6)))
    n = int(all_max(torch.tensor(n, device="cuda"), group))
    means = []
    for _ in range(TIMING_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        means.append((time.perf_counter() - t0) * 1e3 / n)
    return _spread(means) | {"iters": n}


def _dp_iteration_ms(mod, params, shard, group) -> dict:
    """ms per data-parallel EM iteration (the E-step, the one all_reduce of
    counts and loglik, the M-step) and the all-reduce's share of it, after
    one warm-up iteration, over ``TIMING_WINDOWS`` windows of
    ``WINDOW_ITERS`` iterations: a window's time runs from a CUDA event
    before its first iteration to one after its last, the all_reduce is
    bracketed by events in every iteration (the device waits for gloo's
    copies through the host inside it).  The median and range of the
    windows' values."""
    import torch

    from multimodalworddiscovery_tpu_torch.core.collectives import all_sum

    def iteration(ev=None):
        counts = mod.expected_counts(params, shard)
        if ev:
            ev[0].record()
        counts, ll = all_sum(counts, group)
        if ev:
            ev[1].record()
        mod.m_step(params, counts)

    iteration()
    windows = []
    for _ in range(TIMING_WINDOWS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ars = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(WINDOW_ITERS)]
        start.record()
        for ev in ars:
            iteration(ev)
        end.record()
        torch.cuda.synchronize()
        total = start.elapsed_time(end)
        windows.append((total / WINDOW_ITERS, sum(a.elapsed_time(b) for a, b in ars) / total))
    return {"ms": _spread([w[0] for w in windows]), "share": _spread([w[1] for w in windows]),
            "iters": WINDOW_ITERS}


def parallel_phase(here: str, card: str, counters, dev, head: dict, gauss: dict,
                   s16: dict, frames_dir: str) -> dict:
    """Path 19: the parallel layer.  19a at world size 1 over NCCL in this
    process: path 1's EM through ``make_shard_map_em_step`` (K1 + K2) and
    its decode (K3) against path 1, path 2's first annealed iterations
    (K4) against path 2, path 16's streamed EM through
    ``train_streaming_multihost`` (K1 + K2 at the shard) against path 16's
    resident run, and the time-sharded E-step (K8) at one rank.  19b on
    PAR_RANKS spawned ranks over gloo with CUDA tensors (``_path19b_rank``),
    each held here: the EM against path 1, the time-sharded E-step against
    K4, the attention and grounding steps against one process on the same
    rows, the reservoir against ``_reservoir_frames``, the streamed EM
    against path 16.  Every new launch shape of K1 and K2 (the rank's
    headline shard) and K8 at the sequence composes is held against its
    plain version here."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from multimodalworddiscovery_tpu_torch.core.collectives import group_of
    from multimodalworddiscovery_tpu_torch.core.mesh import make_mesh
    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.data.stream import ShardedCorpusReader
    from multimodalworddiscovery_tpu_torch.models import (
        attention,
        grounding,
        hmm,
        hmm_core,
        hmm_gaussian,
        minibatch,
    )
    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k24
    from multimodalworddiscovery_tpu_torch.parallel import (
        make_shard_map_em_step,
        multihost,
        sequence,
    )
    from multimodalworddiscovery_tpu_torch.parallel.data_parallel import take_rows
    from multimodalworddiscovery_tpu_torch.scripts import bench_assoc
    from multimodalworddiscovery_tpu_torch.scripts import bench_kernels as bk

    t_path = time.perf_counter()
    work = pathlib.Path(here, "build", "chip_smoke", "path19")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    launches, shape_launches = {}, {}

    def add(kernel: str, shape: str, n: int) -> None:
        d = shape_launches.setdefault(kernel, {})
        d[shape] = d.get(shape, 0) + n

    def held_em(what, lls, want_lls, params, want, rtol=1e-5, atol=1e-4):
        lls, want_lls = np.asarray(lls, np.float64), np.asarray(want_lls, np.float64)
        rel = float(np.max(np.abs(lls - want_lls) / np.abs(want_lls)))
        errs = {k: _max_abs(torch.as_tensor(v).cpu(), getattr(want, k).cpu())
                for k, v in params.items()}
        print(f"  {what}: loglik {lls.tolist()}, largest relative difference {rel:.3e}; "
              f"parameters max abs err {errs}")
        _check(rel <= rtol, f"{what}: logliks within rtol {rtol}")
        _check(max(errs.values()) <= atol, f"{what}: parameters within atol {atol}")

    # ---- 19a: world size 1 over NCCL ----
    multihost.initialize("file://" + str(work / "nccl_store"), 1, 0, device="cuda")
    try:
        mesh = make_mesh()
        print(f"path 19a (world size 1 over {dist.get_backend()}): mesh {mesh}")
        corpus = head["corpus"]
        _reset(counters)
        step = make_shard_map_em_step(hmm, mesh)
        p, lls = hmm.init(corpus), []
        for _ in range(EM_ITERS):
            p, st = step(p, corpus)
            lls.append(st["loglik"])
        align = hmm.align(p, corpus)
        torch.cuda.synchronize()
        launches["19a_headline"] = got = _counts(counters)
        _check(got["hmm_estep_counts"] == EM_ITERS and got["viterbi"] == 1
               and got["hmm_estep"] == 0, "path 19a headline: K2 once an iteration, K3 once")
        add("table_lookup", "S12_headline", got["table_lookup"])
        add("hmm_estep_counts", "S12_headline", got["hmm_estep_counts"])
        add("viterbi", "S12", got["viterbi"])
        held_em("path 19a data-parallel headline EM against path 1", torch.stack(lls).cpu(),
                head["lls"], {k: getattr(p, k) for k in ("log_emit", "log_jump")},
                head["params"])
        agree = float((align == hmm.align(head["params"], corpus)).float().mean())
        print(f"  path 19a decode agrees with path 1's on {agree:.6f} of positions")
        _check(agree > 0.999, "path 19a decode (K3) agrees with path 1's on > 0.999")
        dp1 = _dp_iteration_ms(hmm, hmm.init(corpus), corpus, group_of(mesh))
        print(f"  [{card}] path 19a data-parallel EM at world size 1 (N={corpus.n}): "
              f"{_fmt(dp1['ms'])} ms per iteration, the all_reduce {_fmt(dp1['share'], 100, 2)}"
              f" % of it (CUDA events, windows of {dp1['iters']} iterations)")

        fc, p_diag = gauss["corpus"], gauss["p0"]
        scales = hmm_gaussian.anneal_scales(EM_ITERS, ANNEAL)[:PAR_GAUSS_ITERS]
        _reset(counters)
        p, glls = p_diag, []
        for scale in scales:
            p, st = make_shard_map_em_step(hmm_gaussian, mesh,
                                           count_kwargs={"emit_scale": scale})(p, fc)
            glls.append(float(st["loglik"]))
        torch.cuda.synchronize()
        launches["19a_gaussian"] = got = _counts(counters)
        _check(got["hmm_estep"] == PAR_GAUSS_ITERS, "path 19a Gaussian: K4 once an iteration")
        add("hmm_estep", "S64", got["hmm_estep"])
        rel = float(np.max(np.abs(np.asarray(glls) - gauss["lls"]) / np.abs(gauss["lls"])))
        print(f"  path 19a data-parallel Gaussian EM: loglik {glls} (path 2 "
              f"{gauss['lls'].tolist()}), largest relative difference {rel:.3e}")
        _check(rel <= 1e-5, "path 19a Gaussian EM: logliks within rtol 1e-5 of path 2's")

        reader = ShardedCorpusReader(s16["dir"], device=dev)
        res = s16["resident"]
        _reset(counters)
        ps, slls = multihost.train_streaming_multihost(hmm, res["p0"], reader, STREAM_ITERS,
                                                       mesh=mesh)
        torch.cuda.synchronize()
        launches["19a_stream"] = got = _counts(counters)
        _check(got["hmm_estep_counts"] == STREAM_ITERS * reader.num_shards,
               f"path 19a streamed: K2 once a shard an iteration ({reader.num_shards} rounds "
               f"on one rank)")
        add("table_lookup", "path16_stream_shard", got["table_lookup"])
        add("hmm_estep_counts", "path16_stream_shard", got["hmm_estep_counts"])
        held_em("path 19a train_streaming_multihost against path 16's resident EM", slls,
                res["lls"], {k: getattr(ps, k) for k in ("log_emit", "log_jump", "log_p0")},
                res["params"])
    finally:
        dist.destroy_process_group()

    # ---- the inputs of 19b: path 9's S64 shape, path 11's corpus ----
    label, gen = bench_assoc.SHAPES[0]
    sc, _, _ = make_flickr8k_mini(**gen, device=dev)
    sparams = hmm.train(hmm.init(sc), sc, EM_ITERS)[0]
    sc = dataclasses.replace(sc, src=torch.nn.functional.pad(
        sc.src, (0, PAR_SEQ_PAD - sc.max_src_len)))
    log_init, log_trans, log_emit = hmm._machinery(sparams, sc)
    smask = hmm_core.state_mask(sc)
    torch.save({"log_init": log_init.cpu(), "log_trans": log_trans.cpu(),
                "log_emit": log_emit.cpu(), "src_len": sc.src_len.cpu(), "smask": smask.cpu()},
               work / "seq.pt")
    _, fact = _estep_inputs(sparams, sc)
    k4_ms = _gpu_ms(lambda: k24.hmm_estep(*fact, log_emit, sc.src_len), 10)
    gamma4, xi4, logz4 = k24.hmm_estep(*fact, log_emit, sc.src_len)
    # K8 at the composes of rank 0's chunk: the tree's first level and the
    # chunk products' combine
    chunk = PAR_SEQ_PAD // PAR_RANKS
    m0 = sequence._chunk_matrices(log_trans, log_emit, sc.src_len, 0, chunk)
    m1 = sequence._chunk_matrices(log_trans, log_emit, sc.src_len, chunk, 2 * chunk)
    a, b = m0[0:-1:2], m0[1::2]
    k8_seq = {"tree": k8_check(f"path 19 sequence compose (rank 0's chunk, {label})", a, b,
                               reps=10)}
    k8_seq["tree"]["library_ms"] = _gpu_ms(lambda: _logsumexp_chunked(a, b), 2)
    r = k8_seq["tree"]
    print(f"  [{card}] K8 at the sequence compose {tuple(a.shape)}: kernel {r['ms']:.4f} ms "
          f"(device {r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library (broadcast "
          f"logsumexp in batch chunks) {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']})")
    del a, b
    from multimodalworddiscovery_tpu_torch.core.logsemiring import log_matmul as plain_mm
    k8_seq["chunks"] = k8_check("path 19 sequence chunk products' combine",
                                sequence._product(plain_mm, m0), sequence._product(plain_mm, m1))
    del m0, m1

    # 19a's time-sharded E-step at one rank (the whole chain on one card)
    multihost.initialize("file://" + str(work / "nccl_store_seq"), 1, 0, device="cuda")
    try:
        seq1 = make_mesh(axis_name="seq")
        _reset(counters)
        g1, x1, z1 = sequence.estep_time_sharded(log_init, log_trans, log_emit, sc.src_len,
                                                 smask, seq1)
        torch.cuda.synchronize()
        launches["19a_seq"] = got = _counts(counters)
        _check(got["log_matmul"] > 0 and sum(got.values()) == got["log_matmul"],
               "path 19a time-sharded E-step: the composes launched K8 and nothing else")
        seq1_t = _wall_ms(lambda: sequence.estep_time_sharded(
            log_init, log_trans, log_emit, sc.src_len, smask, seq1))
    finally:
        dist.destroy_process_group()

    valid = (torch.arange(PAR_SEQ_PAD, device=dev)[None, :, None] < sc.src_len[:, None, None]) \
        & smask[:, None, :]

    def held_seq(what, gamma, xi, logz):
        gamma, xi, logz = (torch.as_tensor(x, device=dev) for x in (gamma, xi, logz))
        errs = {"logz_rel": float(((logz - logz4).abs() / logz4.abs().clamp(min=1e-30)).max()),
                "gamma": _max_abs(gamma[valid], gamma4[valid]), "xi": _max_abs(xi, xi4)}
        print(f"  {what} against K4: {errs}")
        _check(torch.allclose(logz, logz4, rtol=1e-4, atol=0), f"{what}: logZ within rtol 1e-4")
        _check(torch.allclose(gamma[valid], gamma4[valid], **PAR_SEQ_TOL)
               and torch.allclose(xi, xi4, **PAR_SEQ_TOL),
               f"{what}: gamma (valid positions) and xi within rtol 1e-3, atol 1e-3")
        return errs

    seq_errs = {"w1": held_seq("path 19a time-sharded E-step (one rank)", g1, x1, z1)}
    del g1, x1, z1

    hc = head["corpus"]
    torch.save({f: getattr(hc, f).cpu() for f in ("src", "src_len", "trg", "trg_len")},
               work / "headline.pt")
    mc, _, _ = make_flickr8k_mini(**bk.MODELS_CORPUS, device=dev)
    torch.save({f: getattr(mc, f).cpu() for f in ("src", "src_len", "trg", "trg_len")},
               work / "models.pt")
    rp0 = s16["resident"]["p0"]
    torch.save({k: getattr(rp0, k).cpu() for k in ("log_emit", "log_jump", "log_p0")},
               work / "stream_p0.pt")
    # the rank shard's launch shape (rank 0's rows; rank 1's has its shape)
    hshard = hc.pad_to(-(-hc.n // PAR_RANKS) * PAR_RANKS)
    hshard = take_rows(hshard, 0, hshard.n // PAR_RANKS)
    checks = {"parity": parity(f"path 19b rank shard (N={hshard.n})", hshard, reps=5)}
    hp = hmm.init(hc)
    checks["k1"] = k1_check("path 19b rank shard", hp.log_emit, hshard.src,
                            hmm_core.state_concepts(hshard), 50)
    cfg = {"headline": str(work / "headline.pt"), "vocab": (hc.src_vocab, hc.trg_vocab),
           "seq": str(work / "seq.pt"), "models": str(work / "models.pt"),
           "models_vocab": (mc.src_vocab, mc.trg_vocab), "dim": bk.MODEL_DIM,
           "att_batch": bk.ATT_BATCH, "ground_batch": bk.GROUND_BATCH,
           "frames_dir": frames_dir, "stream_dir": s16["dir"],
           "stream_p0": str(work / "stream_p0.pt"), "max_jump": rp0.max_jump}

    # ---- 19b: PAR_RANKS ranks over gloo with CUDA tensors on this card ----
    t0 = time.perf_counter()
    ranks = multihost.spawn(_path19b_rank, PAR_RANKS, (cfg,), device="cuda", backend="gloo",
                            timeout=600, store_dir=str(work))
    print(f"path 19b ({PAR_RANKS} ranks over gloo with CUDA tensors on one card): "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start")
    for name in ranks[0]["launches"]:
        launches[f"19b_{name}"] = {k: sum(r["launches"][name][k] for r in ranks)
                                   for k in ranks[0]["launches"][name]}
    got = launches["19b_headline"]
    _check(got["hmm_estep_counts"] == PAR_RANKS * EM_ITERS,
           "path 19b headline: K2 once an iteration on every rank")
    add("table_lookup", "path19_rank_shard", got["table_lookup"])
    add("hmm_estep_counts", "path19_rank_shard", got["hmm_estep_counts"])
    for i, r in enumerate(ranks):
        _check(r["headline"]["n_local"] == hshard.n, f"path 19b rank {i} holds {hshard.n} rows")
        held_em(f"path 19b data-parallel headline EM (rank {i}) against path 1",
                r["headline"]["lls"], head["lls"], r["headline"]["params"], head["params"])
    dp2 = max((r["headline"]["timing"] for r in ranks), key=lambda t: t["ms"]["median"])
    print(f"  [{card}] path 19b data-parallel EM at world size {PAR_RANKS} (N={hshard.n} a rank, "
          f"the ranks sharing the card; the slower rank): {_fmt(dp2['ms'])} ms per iteration, "
          f"the all_reduce {_fmt(dp2['share'], 100, 2)} % of it (CUDA events, windows of "
          f"{dp2['iters']} iterations)")

    got = launches["19b_seq"]
    _check(got["log_matmul"] > 0 and sum(got.values()) == got["log_matmul"],
           "path 19b time-sharded E-step: the composes launched K8 and nothing else")
    seq_errs["w2"] = held_seq(f"path 19b time-sharded E-step ({PAR_RANKS} ranks)",
                              np.concatenate([r["seq"]["gamma"] for r in ranks], axis=1),
                              ranks[0]["seq"]["xi"], ranks[0]["seq"]["logz"])
    seq2 = max((r["seq"]["timing"] for r in ranks), key=lambda t: t["median"])
    print(f"  [{card}] time-sharded E-step at {label} (N={sc.n}, Ts={PAR_SEQ_PAD}, S="
          f"{log_emit.shape[-1]}): world size 1 {_fmt(seq1_t, digits=3)} ms (windows of "
          f"{seq1_t['iters']} calls), {PAR_RANKS} ranks {_fmt(seq2, digits=3)} ms (windows of "
          f"{seq2['iters']} calls; wall, synchronized); K4 on the whole E-step {k4_ms:.4f} ms "
          f"(CUDA events)")

    for name, mod, batch in (("attention", attention, bk.ATT_BATCH),
                             ("grounding", grounding, bk.GROUND_BATCH)):
        state = mod.init(mc, dim=bk.MODEL_DIM, generator=torch.Generator().manual_seed(SEED))
        new, st = minibatch.make_minibatch_step(mod.em_step, mc, batch)(
            state, torch.Generator().manual_seed(SEED + 1))
        got = ranks[0][name]
        print(f"  path 19b {name} step (B={batch}, {batch // PAR_RANKS} rows a rank): loss "
              f"{got['loss']:.6f} (one process {float(st['loss']):.6f})")
        _check(abs(got["loss"] - float(st["loss"])) <= 1e-5 * abs(float(st["loss"])) + 1e-6,
               f"path 19b {name}: the loss is the global batch's (rtol 1e-5)")
        _adam_resolved_close(f"path 19b {name} step", got["params"], new, new.opt_state, 1)
        for r in ranks[1:]:
            _check(all(np.array_equal(a, b) for a, b in zip(r[name]["params"], got["params"])),
                   f"path 19b {name}: parameters equal on every rank")
        _check(sum(launches[f"19b_{name}"].values()) == 0,
               f"path 19b {name}: the step launches no kernel")
    att = ranks[0]["attention"]["losses"]
    print(f"  path 19b attention: {PAR_ATT_STEPS} more steps, loss {att[0]:.4f} -> {att[-1]:.4f}; "
          f"[{card}] {max(r['attention']['ms_per_step'] for r in ranks):.2f} ms per step (wall)")
    _check(bool(np.all(np.isfinite(att))) and att[-5:].mean() < att[:5].mean(),
           "path 19b attention: the loss falls over the steps")
    del mc

    want = hmm_gaussian._reservoir_frames(ShardedCorpusReader(frames_dir, device=dev),
                                          PAR_RESERVOIR)
    _check(np.array_equal(ranks[0]["reservoir"], want)
           and all(r["reservoir_digest"] == ranks[0]["reservoir_digest"] for r in ranks),
           f"path 19b reservoir_frames_multihost equals _reservoir_frames exactly "
           f"({want.shape[0]} frames of path 17's shards)")
    got = launches["19b_stream"]
    _check(got["hmm_estep_counts"] == STREAM_ITERS * ShardedCorpusReader(s16["dir"]).num_shards,
           "path 19b streamed: K2 once a shard an iteration over the ranks")
    add("table_lookup", "path16_stream_shard", got["table_lookup"])
    add("hmm_estep_counts", "path16_stream_shard", got["hmm_estep_counts"])
    for i, r in enumerate(ranks):
        held_em(f"path 19b train_streaming_multihost (rank {i}) against path 16's resident EM",
                r["stream"]["lls"], s16["resident"]["lls"], r["stream"]["params"],
                s16["resident"]["params"])
    shutil.rmtree(work, ignore_errors=True)
    print(f"path 19 wall time {time.perf_counter() - t_path:.1f} s")
    return {"launches": launches, "shape_launches": shape_launches, "checks": checks,
            "k8": k8_seq, "seq_errs": seq_errs,
            "ms": {"dp_em_w1": dp1, "dp_em_w2": dp2, "seq_w1": seq1_t, "seq_w2": seq2,
                   "k4_seq_shape": k4_ms}}


# ---------------------------------------------------------------------------
# path 20: the port's CLI on the card, as a user runs it
# ---------------------------------------------------------------------------

# bench.py's corpus as overrides of the port's configs/hmm_mini.py (seed 0,
# S=12); 20a trains it CLI_ITERS iterations, resumes a run cut at
# CLI_RESUME_AT, and scores retrieval over pools of CLI_POOL
CLI_HEADLINE = ["data.n_utterances=8000", "data.n_concepts=60", "data.n_phones=48",
                "data.min_concepts=3", "data.max_concepts=6", "seed=0"]
CLI_ITERS = 10
CLI_RESUME_AT = 5
CLI_POOL = 100
CLI_SHARD = 2000  # 20c's shards of the headline corpus
CLI_STRETCH_CHUNKS = 4  # configs/stretch_hubert_clip.py's train.corpus_chunks
FULLSCALE = ["--utterances", "16384", "--shard-size", "4096", "--iters", "5"]
FULLSCALE_SHARDS, FULLSCALE_SUB, FULLSCALE_ITERS = 4, 2048, 5


def _cli(argv: list[str]) -> None:
    """One ``mwd-torch`` command line, in this process (its launches count)."""
    from multimodalworddiscovery_tpu_torch import cli

    print(f"  $ mwd-torch {' '.join(argv)}", flush=True)
    cli.main(argv)


def _train_records(workdir: str) -> list[dict]:
    with open(os.path.join(workdir, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _restored(workdir: str, template):
    from multimodalworddiscovery_tpu_torch.utils.checkpoint import CheckpointManager

    return CheckpointManager(os.path.join(workdir, "ckpt")).restore(template)[0]


def elapsed_since(t0: float) -> str:
    return f"[path 20: {time.perf_counter() - t0:.1f} s]"


def _decode_ties(params, corpus) -> dict:
    """K3 against the plain ``viterbi_factored`` on the same trained
    parameters: the utterances whose paths differ, and how many of them are
    ties (equal path scores, rtol 1e-6); the measurement behind the CLI's
    decode rule.  These are check launches, outside any path's count."""
    import torch

    from multimodalworddiscovery_tpu_torch.models import hmm
    from multimodalworddiscovery_tpu_torch.ops import viterbi as k3

    _, fact = _estep_inputs(params, corpus)
    inputs = (*fact, hmm._log_emissions(params, corpus), corpus.src_len)
    path, path_p = k3.viterbi(*inputs), k3.viterbi_plain(*inputs)
    valid = torch.arange(corpus.max_src_len, device=path.device)[None, :] < corpus.src_len[:, None]
    differ = ((path != path_p) & valid).any(dim=1)
    score, score_p = k3.path_score(path, *inputs), k3.path_score(path_p, *inputs)
    tie = torch.isclose(score, score_p, rtol=1e-6, atol=0.0)
    return {"utterances": corpus.n, "differ": int(differ.sum()),
            "differ_tied": int((differ & tie).sum()),
            "frames_differ": int(((path != path_p) & valid).sum()),
            "max_score_gap": float((score - score_p).abs().max())}


def cli_phase(here: str, card: str, counters, dev, head: dict, recipe: dict) -> dict:
    """Path 20: ``mwd-torch`` driven as a user drives it, each command
    through ``cli.main`` in this process (the profiled run through
    ``python -m`` in a fresh one), in a temporary directory removed at the
    end.  20a: configs/hmm_mini.py with bench.py's corpus, 10 iterations
    (K1 + K2), then align, segment, evaluate, retrieve --pool 100, export
    and lexicon (K3), a run cut at 5 iterations and resumed, and
    ``train.profile=true``; 20b: configs/stretch_hubert_clip.py as written
    (VQ teacher through K1 + K2, seeding and chunked annealed EM through K1
    + K4, a world of one NCCL rank), then evaluate with DTW and pooled
    retrieval (K3); 20c: shard, streamed train, align and evaluate (K1, K2,
    K3 on shards of 2000); 20d: scripts/run_pipeline_fullscale at 16,384
    utterances in shards of 4096, 5 iterations (K5, K4, K3)."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.data.stream import ShardedCorpusReader
    from multimodalworddiscovery_tpu_torch.data.synthetic import (
        make_flickr8k_mini_batches,
        phone_templates,
    )
    from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core, hmm_gaussian
    from multimodalworddiscovery_tpu_torch.ops import mfcc as k5
    from multimodalworddiscovery_tpu_torch.scripts import run_pipeline as rp
    from multimodalworddiscovery_tpu_torch.scripts import run_pipeline_fullscale as fs

    t_path = time.perf_counter()
    cfgs = os.path.join(here, "multimodalworddiscovery_tpu_torch", "configs")
    hmm_cfg = os.path.join(cfgs, "hmm_mini.py")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    wa, wr, wp, wb, wc, dc, wf = (os.path.join(tmp, n) for n in (
        "20a", "20a_resume", "20a_profile", "20b", "20c", "20c_shards", "20d"))
    launches: dict[str, dict] = {}
    times: dict[str, float] = {}

    def run(key: str, argvs: list[list[str]]) -> dict:
        _reset(counters)
        t0 = time.perf_counter()
        for argv in argvs:
            _cli(argv)
        torch.cuda.synchronize()
        times[key] = time.perf_counter() - t0
        launches[key] = _counts(counters)
        print(f"  [{key}: {times[key]:.2f} s] launches {launches[key]}", flush=True)
        return launches[key]

    def train(workdir, *override, config=hmm_cfg):
        return ["train", "--config", config, "--workdir", workdir, "--override", *override]

    # ---- 20a: the headline through the CLI ----
    head_ov = [*CLI_HEADLINE, f"train.num_iterations={CLI_ITERS}"]
    la = run("20a_train", [train(wa, *head_ov)])
    recs = _train_records(wa)
    lls = np.array([r["loglik"] for r in recs])
    cli_ms = [1e3 * r["seconds"] for r in recs]
    print(f"path 20a train: loglik per iteration {lls.tolist()}")
    _check(la["table_lookup"] == CLI_ITERS and la["hmm_estep_counts"] == CLI_ITERS
           and la["hmm_estep"] == 0 and la["viterbi"] == 0 and la["pair_counts"] == 0,
           "path 20a train: K1 and K2 once an EM iteration, no K3, K4 or K7")
    rel = _rel(lls, head["lls"])
    _check(len(lls) == CLI_ITERS and rel <= 1e-5,
           f"path 20a: each iteration's loglik within rtol 1e-5 of path 1's hmm.train "
           f"(max rel {rel:.3e})")
    ms_cli = float(np.median(cli_ms[1:]))
    print(f"  [{card}] path 20a CLI ms per EM iteration (host clock, each iteration ended by a "
          f"synchronize and the loglik's read; median of iterations 1-{CLI_ITERS - 1}, "
          f"iteration 0 {cli_ms[0]:.2f}): {ms_cli:.4f}; path 1's hmm.train (CUDA events, no "
          f"read per iteration): {head['ms']:.4f}; CLI overhead {ms_cli - head['ms']:+.4f} ms")
    ov_pool = ["--override", f"eval.retrieval_pool={CLI_POOL}"]
    ld = run("20a_decode", [
        ["align", "--workdir", wa], ["segment", "--workdir", wa],
        ["evaluate", "--workdir", wa, *ov_pool],
        ["retrieve", "--workdir", wa, "--pool", str(CLI_POOL)],
        ["export", "--workdir", wa], ["lexicon", "--workdir", wa]])
    _check(ld["viterbi"] == 4 and ld["table_lookup"] == 0 and ld["hmm_estep_counts"] == 0
           and ld["hmm_estep"] == 0,
           "path 20a: K3 once for align, segment, evaluate and lexicon; no E-step kernel")
    with open(os.path.join(wa, "metrics.json")) as f:
        metrics_a = json.load(f)
    f1_a = metrics_a["alignment"]["f1"]
    _check(abs(f1_a - head["f1"]) <= 0.002,
           f"path 20a evaluate: alignment F1 within 0.002 of path 1's ({f1_a:.5f} vs "
           f"{head['f1']:.5f})")
    ret = metrics_a["retrieval"]
    with open(os.path.join(wa, "retrieval.json")) as f:
        ret_cmd = json.load(f)["recall"]
    print(f"  path 20a metrics: alignment {metrics_a['alignment']}, boundary "
          f"{metrics_a['boundary']}, purity {metrics_a['purity']:.4f}, nmi "
          f"{metrics_a['nmi']:.4f}; pooled retrieval (C={CLI_POOL}) {ret}")
    _check(ret["pool_size"] == CLI_POOL and ret_cmd["pool_size"] == CLI_POOL
           and all(0.0 <= ret[k] <= 1.0 for k in ret if k.startswith("recall@"))
           and abs(ret_cmd["recall@1_c2i"] - round(ret["recall@1_c2i"], 4)) <= 1e-4,
           "path 20a: evaluate's and retrieve's pooled recall agree and lie in [0, 1]")
    corpus, gold, _ = make_flickr8k_mini(**HEADLINE, device=dev)
    params_a = _restored(wa, hmm.init(corpus))
    with np.load(os.path.join(wa, "model.npz")) as z:
        _check(z.files == ["log_emit", "log_jump", "log_p0"]
               and np.array_equal(z["log_emit"], params_a.log_emit.cpu().numpy()),
               "path 20a export: the JAX export's keys, the checkpoint's values")
    with open(os.path.join(wa, "lexicon.json")) as f:
        lex = json.load(f)
    _check(len(lex) > 30 and all(v and v[0]["count"] >= 1 for v in lex.values()),
           f"path 20a lexicon: {len(lex)} concepts with phone strings")
    ties = _decode_ties(params_a, corpus)
    print(f"  [{card}] decode rule: K3 against the plain viterbi_factored on the CLI's trained "
          f"headline parameters: {ties}")
    del corpus

    lr = run("20a_resume", [train(wr, *CLI_HEADLINE, f"train.num_iterations={CLI_RESUME_AT}"),
                            train(wr, *head_ov)])
    lls_r = [r["loglik"] for r in _train_records(wr)]
    rel_r = _rel(lls_r, lls)
    _check(len(lls_r) == CLI_ITERS and lr["hmm_estep_counts"] == CLI_ITERS and rel_r <= 1e-5,
           f"path 20a: a run cut at {CLI_RESUME_AT} iterations and resumed gives the "
           f"uninterrupted logliks (rtol 1e-5; max rel {rel_r:.3e})")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "multimodalworddiscovery_tpu_torch.cli",
                           *train(wp, *CLI_HEADLINE, "train.num_iterations=3",
                                  "train.profile=true")],
                          cwd=here, capture_output=True, text=True, timeout=600)
    times["20a_profile"] = time.perf_counter() - t0
    print(proc.stdout[-1500:])
    _check(proc.returncode == 0, f"path 20a: python -m ...cli train with train.profile=true "
                                 f"ran ({proc.stderr[-2000:]})")
    with open(os.path.join(wp, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    named = {k: sum(k in n for n in kernels) for k in ("mwd_table_lookup", "mwd_estep_counts")}
    print(f"  path 20a profile: {len(kernels)} device kernel events in "
          f"{os.path.join('20a_profile', 'profile', 'trace.json')}, K1 / K2 events {named}")
    _check(all(v > 0 for v in named.values()),
           "path 20a: the Chrome trace of train.profile=true names K1's and K2's kernels")
    print(elapsed_since(t_path))

    # ---- 20b: the stretch config as written ----
    stretch_cfg = os.path.join(cfgs, "stretch_hubert_clip.py")
    lb = run("20b_train", [["train", "--config", stretch_cfg, "--workdir", wb]])
    lbe = run("20b_evaluate", [["evaluate", "--workdir", wb]])
    lls_b = [r["loglik"] for r in _train_records(wb)]
    with open(os.path.join(wb, "metrics.json")) as f:
        metrics_b = json.load(f)
    f1_b = metrics_b["alignment"]["f1"]
    seed_k1 = 3 * CLI_STRETCH_CHUNKS  # seed_rounds x chunks: the teacher's posteriors
    _check(lb["table_lookup"] == EM_ITERS + seed_k1 and lb["hmm_estep_counts"] == EM_ITERS
           and lb["hmm_estep"] == seed_k1 + EM_ITERS * CLI_STRETCH_CHUNKS
           and lb["viterbi"] == 0 and lbe["viterbi"] == 1
           and lbe["table_lookup"] + lbe["hmm_estep"] + lbe["hmm_estep_counts"] == 0,
           "path 20b: K1 + K2 once a teacher iteration, K1 + K4 once a chunk a seeding round, "
           "K4 once a chunk an EM iteration; K3 once in evaluate")
    rels_b = [(a - float(b)) / abs(float(b)) for a, b in zip(lls_b, recipe["lls"])]
    print(f"path 20b: loglik {lls_b}; path 3's kernel run {list(map(float, recipe['lls']))}; "
          f"relative differences {[f'{r:+.3e}' for r in rels_b]}; alignment "
          f"{metrics_b['alignment']}; boundary {metrics_b['boundary']}; dtw "
          f"{metrics_b.get('dtw')}; retrieval {metrics_b.get('retrieval')}")
    # Both draw the seeding numbers from one CPU generator seeded 0 (the
    # jitter, then the codebook's seed frames), so the first iteration's
    # loglik agrees up to the teacher's rounding: K2's count atomics vary in
    # the last bits between runs (two calls of path 3 began 1.7e-5 apart),
    # and the config's corpus_chunks=4, which path 3 cut, sums the counts
    # in another order.  The annealed EM amplifies that to a few 1e-3 by
    # the last iteration, so the final loglik is printed, not held (PERF.md
    # §6); the F1 is held to path 3's and to the recipe's floor.
    _check(abs(rels_b[0]) <= 1e-4, f"path 20b: the first iteration's loglik within rtol 1e-4 "
                                   f"of path 3's (the same seeding numbers; rel "
                                   f"{rels_b[0]:+.3e})")
    _check(f1_b >= 0.30 and abs(f1_b - recipe["f1"]) <= 0.005,
           f"path 20b: F1 >= 0.30 and within 0.005 of path 3's ({f1_b:.5f} vs "
           f"{recipe['f1']:.5f}; the final loglik {rels_b[-1]:+.3e} from path 3's, the chunks' "
           f"summation order amplified by the annealing)")
    _check("dtw" in metrics_b and metrics_b["retrieval"]["pool_size"] == 100,
           "path 20b evaluate: DTW and pooled retrieval (C=100) scored")
    print(elapsed_since(t_path))

    # ---- 20c: streamed ----
    stream_ov = ["data.source=stream", f"data.dir={dc}"]
    _cli(["shard", "--config", hmm_cfg, "--output", dc, "--shard-size", str(CLI_SHARD),
          "--override", *CLI_HEADLINE])
    lc = run("20c_train", [train(wc, *head_ov, *stream_ov)])
    lcd = run("20c_decode", [["align", "--workdir", wc],
                             ["evaluate", "--workdir", wc, *ov_pool]])
    lcr = run("20c_resident_decode", [["align", "--workdir", wc, "--output",
                                       os.path.join(wc, "alignment_resident.json"),
                                       "--override", "data.source=synthetic"]])
    n_sh = -(-8000 // CLI_SHARD)
    _check(lc["table_lookup"] == CLI_ITERS * n_sh and lc["hmm_estep_counts"] == CLI_ITERS * n_sh
           and lcd["viterbi"] == 2 * n_sh and lcr["viterbi"] == 1,
           "path 20c: K1 + K2 once a shard an EM iteration, K3 once a shard a decode")
    lls_c = [r["loglik"] for r in _train_records(wc)]
    rel_c = _rel(lls_c, lls)
    with open(os.path.join(wc, "metrics.json")) as f:
        f1_c = json.load(f)["alignment"]["f1"]
    with open(os.path.join(wc, "alignment.json")) as f:
        streamed_align = f.read()
    with open(os.path.join(wc, "alignment_resident.json")) as f:
        resident_align = f.read()
    print(f"path 20c: loglik {lls_c}; F1 {f1_c:.6f} (20a {f1_a:.6f})")
    _check(rel_c <= 1e-5, f"path 20c: streamed logliks within rtol 1e-5 of 20a's "
                          f"(max rel {rel_c:.3e})")
    _check(abs(f1_c - f1_a) <= 1e-6, f"path 20c: streamed alignment F1 within 1e-6 of 20a's "
                                     f"({f1_c} vs {f1_a})")
    _check(streamed_align == resident_align,
           "path 20c: the streamed decode equals the resident decode of the same checkpoint")
    reader = ShardedCorpusReader(dc, device=dev)
    shard0 = reader.load_shard(0)
    checks = {"k2_shard": parity(f"path 20c shard (N={CLI_SHARD})", shard0, reps=5)}
    p_c = _restored(wc, hmm.init(shard0))
    checks["k1_shard"] = k1_check("path 20c shard", p_c.log_emit, shard0.src,
                                  hmm_core.state_concepts(shard0), 20)
    _, fact = _estep_inputs(p_c, shard0)
    checks["k3_shard"] = k3_parity(f"path 20c shard (N={CLI_SHARD})",
                                   (*fact, hmm._log_emissions(p_c, shard0), shard0.src_len), 10)
    del shard0, reader, fact
    print(elapsed_since(t_path))

    # ---- 20d: run_pipeline_fullscale ----
    _reset(counters)
    t0 = time.perf_counter()
    rep = fs.main([*FULLSCALE, "--workdir", wf])
    torch.cuda.synchronize()
    times["20d"] = time.perf_counter() - t0
    launches["20d"] = ldf = _counts(counters)
    print(f"  [20d: {times['20d']:.2f} s] launches {ldf}")
    _check(ldf["extract"] == FULLSCALE_SHARDS * 4096 // FULLSCALE_SUB
           and ldf["hmm_estep"] == FULLSCALE_ITERS * FULLSCALE_SHARDS
           and ldf["viterbi"] == 3 * FULLSCALE_SHARDS + 2,
           "path 20d: K5 once a sub-batch, K4 once a shard an EM iteration, K3 once a shard "
           "for align, segment and evaluate and twice in the cross-check")
    _check(rep["crosscheck"]["max_abs_delta"] <= 1e-5,
           "path 20d stage 6: shard 0 streamed equals resident")
    print(f"  [{card}] path 20d stages: " + "; ".join(
        f"{s['stage']} {s['seconds']:.2f} s (rss {s['rss_gb']:.2f} GB)" for s in rep["stages"])
        + f"; metrics alignment {rep['metrics']['alignment']}")
    # K5 at the pipeline's sub-batch, K4 and K3 at its shard, against plain
    _, s_max, batches = make_flickr8k_mini_batches(
        n_utterances=FULLSCALE_SUB, batch_size=FULLSCALE_SUB, n_concepts=40,
        n_phones=fs.N_PHONES, seed=0, device=dev)
    pc, _ = next(batches)
    wavs, lens = fs.render_waveforms(pc.src.cpu().numpy(), pc.src_len.cpu().numpy(), s_max,
                                     phone_templates(fs.N_PHONES + 1, seed=0),
                                     np.random.default_rng(1))
    wav, wav_len = torch.as_tensor(wavs, device=dev), torch.as_tensor(lens, device=dev)
    got, fl = k5.extract(wav, wav_len, rp.MFCC)
    want, fl_p = k5.extract_plain(wav, wav_len, rp.MFCC)
    valid = torch.arange(got.shape[1], device=dev)[None, :] < fl[:, None]
    k5_err = _max_abs(got[valid], want[valid])
    _check(torch.equal(fl, fl_p) and torch.allclose(got[valid], want[valid], **MFCC_TOL),
           f"K5 at path 20d's sub-batch {tuple(wav.shape)}: valid frames within rtol 1e-3 atol "
           f"2e-3 of plain (max abs err {k5_err})")
    checks["k5_fullscale"] = {"err": k5_err,
                              "ms": _gpu_ms(lambda: k5.extract(wav, wav_len, rp.MFCC), 10),
                              "plain_ms": _gpu_ms(lambda: k5.extract_plain(wav, wav_len,
                                                                           rp.MFCC), 2)}
    print(f"  [{card}] K5 at path 20d's sub-batch: kernel {checks['k5_fullscale']['ms']:.4f} ms, "
          f"plain {checks['k5_fullscale']['plain_ms']:.4f} ms")
    del wav, wav_len, got, want, valid
    reader = ShardedCorpusReader(os.path.join(wf, "shards"), device=dev)
    shard0 = reader.load_shard(0)
    p_f = _restored(wf, hmm_gaussian.init(shard0, n_components=2))
    pad0 = shard0.pad_to(shard0.n + ZERO_LENGTH_PAD)
    _, fact = _estep_inputs(p_f, pad0)
    checks["k4_fullscale"] = k4_check(f"path 20d shard (N={shard0.n})",
                                      (*fact, hmm_gaussian._log_emissions(p_f, pad0),
                                       pad0.src_len), 10)
    _, fact = _estep_inputs(p_f, shard0)
    checks["k3_fullscale"] = k3_parity(f"path 20d shard (N={shard0.n})",
                                       (*fact, hmm_gaussian._log_emissions(p_f, shard0),
                                        shard0.src_len), 10)
    del shard0, pad0, reader, fact
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"path 20 wall time {time.perf_counter() - t_path:.1f} s; by part (s) {times}")

    # each K1-K4 launch of path 20 at its checked shape
    shape_launches = {
        "table_lookup": {"S12_headline": la["table_lookup"] + lr["table_lookup"],
                         "S64_teacher": EM_ITERS, "S64_teacher_shard": seed_k1,
                         "path20c_shard": lc["table_lookup"]},
        "hmm_estep_counts": {"S12_headline": la["hmm_estep_counts"] + lr["hmm_estep_counts"],
                             "S64_teacher": lb["hmm_estep_counts"],
                             "path20c_shard": lc["hmm_estep_counts"]},
        "hmm_estep": {"S64_stretch_shard": lb["hmm_estep"], "path20d_shard": ldf["hmm_estep"]},
        "viterbi": {"S12": ld["viterbi"] + lcr["viterbi"], "S64": lbe["viterbi"],
                    "path20c_shard": lcd["viterbi"], "path20d_shard": ldf["viterbi"]},
    }
    return {"launches": launches, "shape_launches": shape_launches, "checks": checks,
            "times": times, "ms_per_iteration": ms_cli, "ties": ties,
            "fullscale": {s["stage"]: (s["seconds"], s["rss_gb"]) for s in rep["stages"]},
            "f1": {"20a": f1_a, "20b": f1_b, "20c": f1_c}}


# ---------------------------------------------------------------------------
# path 21: the study and parity drivers through their main(), and the port's
# float64 NumPy HMM oracle on the card's host
# ---------------------------------------------------------------------------

STUDY_TOL = 0.05  # 21a: each variant's frame accuracy against the JAX package's
CEILING_TOL = 0.03  # 21b: frame accuracy and alignment F1 against the JAX package's
# 21b's JAX values in float32: the JAX package's own scripts/exp_ceiling_fullscale.py
# on the CPU (PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/exp_ceiling_fullscale.py
# --cpu), frame accuracy / F1.  Its documented values (exp_ceiling_fullscale.DOCUMENTED)
# were taken on a TPU, whose default matmul precision takes the Gaussian
# log-densities' two products (models/hmm_gaussian.py:228-229) in bf16 passes: there
# the EM walks further from gold (0.466 / 0.469 against 0.503 / 0.506), so 21b holds
# the port to this run and the ceiling also to the documented value.
REFERENCE_CEILING_CPU = {"supervised_ceiling": (0.524, 0.5147),
                         "ceiling_plus_10_em": (0.503, 0.506)}
CRF40K_TOL = 0.02  # 21c: positional accuracy against the JAX package's (its 500 steps)
SELF_TRAIN_TOL = 0.03  # 21d: the round-0 teacher against the JAX package's 0.820
SELF_TRAIN_MB_STEPS = 20  # 21d's minibatch leg: B=512 student steps
# bench.py's oracle corpus (bench.py:85-95) and its EM iterations
ORACLE_CORPUS = dict(n_utterances=512, n_concepts=60, n_phones=48, min_concepts=3,
                     max_concepts=6, seed=0)
ORACLE_ITERS = 4


def oracle_leg() -> None:
    """The port's ``NumpyHMM`` (float64, a Python loop an utterance) on
    bench.py's oracle corpus, ORACLE_ITERS EM iterations on this host; one
    JSON line with the logliks and the seconds.  Run in a process of its own
    beside path 21's card legs (``python3 -c 'import chip_smoke;
    chip_smoke.oracle_leg()'``)."""
    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.oracles.numpy_hmm import NumpyHMM

    c, _, _ = make_flickr8k_mini(**ORACLE_CORPUS, device="cpu")
    src, trg = c.src.numpy(), c.trg.numpy()
    sl, tl = c.src_len.numpy(), c.trg_len.numpy()
    oracle = NumpyHMM([src[i, : sl[i]] for i in range(c.n)], [trg[i, : tl[i]] for i in range(c.n)],
                      c.src_vocab, c.trg_vocab)
    t0 = time.perf_counter()
    lls = [oracle.em_iteration() for _ in range(ORACLE_ITERS)]
    print(json.dumps({"lls": lls, "seconds": time.perf_counter() - t0, "utterances": c.n}),
          flush=True)


def _pad_time(corpus, ts: int):
    """``corpus`` with its frames padded along time to ``ts`` (masked)."""
    import torch

    pad = ts - corpus.max_src_len
    return dataclasses.replace(corpus, src=torch.nn.functional.pad(
        corpus.src, (0, 0, 0, pad) if corpus.src.dim() == 3 else (0, pad)))


def _gauss_inputs(params, corpus, pad: int = 0):
    """K4's / K3's inputs for Gaussian emissions on ``corpus`` (with ``pad``
    zero-length utterances appended)."""
    from multimodalworddiscovery_tpu_torch.models import hmm_gaussian

    c = corpus.pad_to(corpus.n + pad)
    _, fact = _estep_inputs(params, c)
    return (*fact, hmm_gaussian._log_emissions(params, c), c.src_len)


def _discrete_inputs(params, corpus):
    from multimodalworddiscovery_tpu_torch.models import hmm

    _, fact = _estep_inputs(params, corpus)
    return (*fact, hmm._log_emissions(params, corpus), corpus.src_len)


def _k4_rounding(label: str, inputs) -> dict:
    """K4 against its plain version where the per-utterance logZ is so large
    (tens of thousands of nats at path 21a's flat start) that an ulp of it
    in float32 moves gamma by more than K4's gamma bound: logZ (rtol 1e-4)
    and the total loglik (rtol 1e-6) are held, and gamma's and xi's errors
    printed beside that ulp."""
    import numpy as np
    import torch

    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k4

    gamma, xi, logz = k4.hmm_estep(*inputs)
    gamma_p, xi_p, logz_p = k4.hmm_estep_plain(*inputs)
    ulp = float(np.spacing(np.float32(logz_p.abs().max().item())))
    errs = {"logz": _max_abs(logz, logz_p), "gamma": _max_abs(gamma, gamma_p),
            "xi": _max_abs(xi, xi_p), "logz_ulp": ulp}
    print(f"  K4 at {label}: max |logZ| {float(logz_p.abs().max())}, one float32 ulp of it "
          f"{ulp}; max abs err vs plain {errs} (gamma and xi printed, not held)")
    _check(torch.allclose(logz, logz_p, rtol=1e-4, atol=1e-4),
           f"K4 at {label}: logZ rtol 1e-4 atol 1e-4")
    ll, ll_p = float(logz.sum()), float(logz_p.sum())
    _check(abs(ll - ll_p) <= 1e-6 * abs(ll_p), f"K4 at {label}: total loglik rtol 1e-6 "
                                               f"({ll} vs {ll_p})")
    return errs


def _write_mock_reference(ref: str, corpus, alignment, shift: bool = False) -> None:
    """A reference-style output directory: phone captions, concept labels
    and a records-form alignment dump; with ``shift`` each link moved to the
    next target position of its utterance."""
    import numpy as np

    os.makedirs(ref, exist_ok=True)
    src, trg = corpus.src.cpu().numpy(), corpus.trg.cpu().numpy()
    sl, tl = corpus.src_len.cpu().numpy(), corpus.trg_len.cpu().numpy()
    with open(os.path.join(ref, "phone_captions.txt"), "w") as f:
        f.write("\n".join(" ".join(map(str, src[i, : sl[i]])) for i in range(corpus.n)) + "\n")
    with open(os.path.join(ref, "concept_labels.txt"), "w") as f:
        f.write("\n".join(" ".join(map(str, trg[i, : tl[i]])) for i in range(corpus.n)) + "\n")
    recs = []
    for i in range(corpus.n):
        a = alignment[i, : sl[i]].astype(np.int64)
        if shift:
            a = np.where(a > 0, a % tl[i] + 1, 0)
        recs.append({"index": i, "alignment": a.tolist()})
    with open(os.path.join(ref, "alignment_dump.json"), "w") as f:
        json.dump(recs, f)


def studies_phase(here: str, card: str, counters, dev, stretch, stretch_gold) -> dict:
    """Path 21: the port's study and parity drivers through their main(),
    at their own full sizes, each leg in its own launch window: 21a
    exp_gauss_dense (N=1000), 21b exp_ceiling_fullscale (N=4000, on the
    ``stretch`` frames' shape), 21c exp_crf40k (N=40,000, B=512), 21d
    self_train (N=800, 2 rounds, full batch; then a B=512 minibatch leg),
    21e reference_parity on a mocked reference (parity, shifted, empty);
    ``stretch_gold``: the stretch frames' gold alignment;
    then bench.py's oracle corpus through the port's ``hmm.train`` against
    the port's ``NumpyHMM``, which runs meanwhile in a process of its own.
    Each K1-K4 launch shape of the path is checked against plain."""
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
    from multimodalworddiscovery_tpu_torch.data.io import load_corpus
    from multimodalworddiscovery_tpu_torch.models import (
        hmm,
        hmm_core,
        hmm_crf,
        hmm_dnn,
        hmm_gaussian,
    )
    from multimodalworddiscovery_tpu_torch.models.minibatch import gather_batch
    from multimodalworddiscovery_tpu_torch.scripts import exp_ceiling_fullscale as cf
    from multimodalworddiscovery_tpu_torch.scripts import exp_crf40k as crf
    from multimodalworddiscovery_tpu_torch.scripts import exp_gauss_dense as gd
    from multimodalworddiscovery_tpu_torch.scripts import reference_parity as rpar
    from multimodalworddiscovery_tpu_torch.scripts import self_train as st

    t_path = time.perf_counter()
    oracle = subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke.oracle_leg()"],
                              cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    launches: dict[str, dict] = {}
    times: dict[str, float] = {}
    checks: dict[str, dict] = {"k1": {}, "k2": {}, "k3": {}, "k4": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_studies_")

    def run(key: str, fn):
        _reset(counters)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[key] = time.perf_counter() - t0
        launches[key] = _counts(counters)
        print(f"  [{card}] [{key}: {times[key]:.2f} s] launches {launches[key]}", flush=True)
        return out

    def launched(key: str, **want) -> None:
        got = {k: launches[key][k] for k in want}
        _check(got == want and launches[key]["pair_counts"] == 0
               and all(launches[key][k] == 0 for k in ("hmm_estep_bf16", "hmm_estep_counts_bf16",
                                                         "hmm_estep_remat", "log_matmul")),
               f"path {key}: launches {want}, no K7, K8 or bf16 variant")

    try:
        # ---- 21a: the dense-region study at its defaults ----
        out = run("21a", lambda: gd.main([]))
        res, doc = out["results"], gd.DOCUMENTED
        for k, want in doc.items():
            _check(abs(res[k] - want) <= STUDY_TOL,
                   f"path 21a {k}: frame accuracy {res[k]:.4f} within {STUDY_TOL} of the JAX "
                   f"package's {want}")
        order = ("ceiling_supervised", "ceiling_plus_em", "vq_seed_plus_em", "em_diag_anneal",
                 "em_diagonal")
        _check(all(res[a] > res[b] for a, b in zip(order, order[1:])),
               f"path 21a: {' > '.join(f'{k} {res[k]:.4f}' for k in order)}")
        it, ch = 10, 4  # the study's iterations and chunks
        launched("21a", table_lookup=2 * it + 3 * ch, hmm_estep_counts=2 * it,
                 hmm_estep=5 * it * ch + 3 * ch, viterbi=8 * ch + 2)
        pc, _, fc, _ = gd.build_corpus(1000, 64, dev)
        _check(list(fc.src.shape) == out["corpus"] and list(pc.src.shape) == out["phone_corpus"],
               f"path 21a's checks at its corpora's shapes {out['corpus']}, {out['phone_corpus']}")
        chunk = gd.chunks_of(fc, ch)[0]
        # the flat start's first E-step (init_diagonal, K=2, seed 0: the
        # path's inputs), then em_diagonal's last parameters
        p_init = hmm_gaussian.init_diagonal(fc, max_jump=gd.MAX_JUMP, n_components=2)
        rounding = {"path21a_init": _k4_rounding(f"path 21a chunk (N={chunk.n}) at the flat "
                                                 f"start", _gauss_inputs(p_init, chunk))}
        p_chunk, _ = gd.chunked_train(p_init, fc, it, ch)
        checks["k4"]["path21a_chunk"] = k4_check(
            f"path 21a chunk (N={chunk.n})", _gauss_inputs(p_chunk, chunk, ZERO_LENGTH_PAD), 10)
        checks["k3"]["path21a_chunk"] = k3_parity(f"path 21a chunk (N={chunk.n})",
                                                  _gauss_inputs(p_chunk, chunk), 10)
        cc = hmm_gaussian.quantize_frames(fc, n_codes=gd.N_CODES,
                                          generator=torch.Generator().manual_seed(1))
        code_chunk = gd.chunks_of(cc, ch)[0]
        for label, c, at in (("path21a_phones", pc, pc), ("path21a_codes", cc, cc),
                             ("path21a_code_chunk", cc, code_chunk)):
            p_c, _ = hmm.em_step(hmm.init(c, max_jump=gd.MAX_JUMP), c, use_kernels=False)
            checks["k1"][label] = k1_check(label, p_c.log_emit, at.src,
                                           hmm_core.state_concepts(at), 20)
            if at is c:
                checks["k2"][label] = parity(f"{label} (N={c.n}, V_src={c.src_vocab})", c,
                                             max_jump=gd.MAX_JUMP, reps=5)
                checks["k3"][label] = k3_parity(label, _discrete_inputs(p_c, c), 10)
        del pc, fc, cc, chunk, code_chunk, p_init, p_chunk, p_c
        torch.cuda.empty_cache()
        print(f"path 21a: {json.dumps(res)}")

        # ---- 21b: the ceiling at the stretch config's shape ----
        out = run("21b", lambda: cf.main([]))
        for k, (acc_w, f1_w) in REFERENCE_CEILING_CPU.items():
            v = out["variants"][k]
            acc_d, f1_d = cf.DOCUMENTED[k]
            got = f"frame accuracy / F1 {v['frame_acc']:.4f} / {v['alignment_f1']:.4f}"
            _check(abs(v["frame_acc"] - acc_w) <= CEILING_TOL
                   and abs(v["alignment_f1"] - f1_w) <= CEILING_TOL,
                   f"path 21b {k}: {got} within {CEILING_TOL} of the JAX package's float32 "
                   f"run on the CPU, {acc_w} / {f1_w}")
            near = (abs(v["frame_acc"] - acc_d) <= CEILING_TOL
                    and abs(v["alignment_f1"] - f1_d) <= CEILING_TOL)
            if k == "supervised_ceiling":
                _check(near, f"path 21b {k}: {got} within {CEILING_TOL} of the documented "
                             f"{acc_d} / {f1_d}")
            else:
                print(f"  path 21b {k}: the documented {acc_d} / {f1_d}, taken on a TPU with "
                      f"its products in bf16 passes: {v['frame_acc'] - acc_d:+.4f} / "
                      f"{v['alignment_f1'] - f1_d:+.4f} (within {CEILING_TOL}: {near})")
        launched("21b", table_lookup=0, hmm_estep_counts=0, hmm_estep=10 * 8, viterbi=2)
        _check(list(stretch.src.shape) == out["corpus"], "path 21b ran at path 3's corpus shape")
        chunk = gd.chunks_of(stretch, 8)[0]
        # the path's first E-step: the supervised ceiling's parameters
        p_chunk = cf.chunked_supervised_fit(
            hmm_gaussian.init(stretch, max_jump=gd.MAX_JUMP, n_components=2), stretch,
            torch.as_tensor(stretch_gold, device=dev), 8)
        checks["k4"]["path21b_chunk"] = k4_check(
            f"path 21b chunk (N={chunk.n})", _gauss_inputs(p_chunk, chunk, ZERO_LENGTH_PAD), 10)
        del chunk
        print(f"path 21b: {json.dumps(out['variants'])}")

        # ---- 21c: the minibatch CRF at 40,000 utterances ----
        out = run("21c", lambda: crf.main([]))
        rows = out["modes"]
        for mode, want in crf.DOCUMENTED.items():
            acc = rows[mode]["acc"]
            _check(abs(acc - want) <= CRF40K_TOL and rows[mode]["steps"] == 500,
                   f"path 21c {mode}: accuracy {acc:.4f} after {rows[mode]['steps']} steps "
                   f"within {CRF40K_TOL} of the JAX package's {want} after 500")
            print(f"  [{card}] path 21c {mode}: {rows[mode]['ms_per_step']:.4f} ms a step "
                  f"(CUDA events), accuracy {acc:.4f}, loglik {rows[mode]['ll_first']:.1f} -> "
                  f"{rows[mode]['ll_last']:.1f}")
        _check(rows["e2e_trans"]["acc"] >= rows["em_trans"]["acc"],
               "path 21c: e2e_trans accuracy >= em_trans accuracy")
        n_sgd = 4  # hmm_dnn.init's default: n_sgd Adam steps and one E-step a batch
        launched("21c", table_lookup=0, hmm_estep_counts=0,
                 hmm_estep=2 * 500 * (n_sgd + 1), viterbi=2 * crf.DECODE_CHUNKS)
        n, ts, _ = out["corpus"]
        fc, _ = st.build_corpus(n // 8, dev)  # the first decode chunk: a prefix of the corpus
        fc = _pad_time(fc, ts)
        _check(2 * fc.max_trg_len == out["states"], "path 21c's checks at its states")
        params = hmm_dnn.init(fc, generator=torch.Generator().manual_seed(0))
        batch = gather_batch(fc, torch.arange(512)).pad_to(512 + ZERO_LENGTH_PAD)
        with torch.no_grad():
            le = hmm_crf._log_emit_from_mlp(params.mlp, batch)
        _, fact = _estep_inputs(params, batch)
        checks["k4"]["path21c_batch"] = k4_check("path 21c batch (B=512)",
                                                 (*fact, le, batch.src_len), 10)
        _, fact = _estep_inputs(params, fc)
        with torch.no_grad():
            le = hmm_dnn._log_emissions(params, fc)
        checks["k3"]["path21c_decode"] = k3_parity(f"path 21c decode chunk (N={fc.n})",
                                                   (*fact, le, fc.src_len), 10)
        del fc, batch, le, fact, params
        torch.cuda.empty_cache()

        # ---- 21d: the teacher-student loop at its defaults, then B=512 ----
        out = run("21d", lambda: st.main([]))
        acc = out["accuracies"]
        doc = st.DOCUMENTED[800]
        print(f"path 21d stages: {json.dumps(out['stages'])} (the JAX package: {doc})")
        _check(abs(acc[0] - doc[0]) <= SELF_TRAIN_TOL,
               f"path 21d: the round-0 teacher {acc[0]:.4f} within {SELF_TRAIN_TOL} of {doc[0]}")
        gain, gain_doc = acc[2] - acc[0], doc[2] - doc[0]
        _check(gain >= gain_doc / 2, f"path 21d: the re-seeded teacher gains {gain:+.4f} over "
                                     f"round 0's, at least half the documented {gain_doc:+.3f}")
        hmm_iters = 15
        launched("21d", table_lookup=0, hmm_estep_counts=0, hmm_estep=2 * (hmm_iters + 1),
                 viterbi=2)
        out_mb = run("21d_minibatch", lambda: st.main(
            ["--batch-size", "512", "--attn-iters", str(SELF_TRAIN_MB_STEPS), "--rounds", "1"]))
        print(f"path 21d minibatch leg (B=512, {SELF_TRAIN_MB_STEPS} steps): "
              f"{json.dumps(out_mb['stages'])}")
        launched("21d_minibatch", table_lookup=0, hmm_estep_counts=0,
                 hmm_estep=hmm_iters + SELF_TRAIN_MB_STEPS, viterbi=1)
        fc, _ = st.build_corpus(800, dev)
        _check(list(fc.src.shape) == out["corpus"], "path 21d's checks at its corpus's shape")
        hp, _ = st.teacher(fc, 2)
        checks["k4"]["path21d_teacher"] = k4_check(
            f"path 21d teacher (N={fc.n})", _gauss_inputs(hp, fc, ZERO_LENGTH_PAD), 10)
        checks["k3"]["path21d_teacher"] = k3_parity(f"path 21d teacher (N={fc.n})",
                                                    _gauss_inputs(hp, fc), 10)
        checks["k4"]["path21d_batch"] = k4_check(
            "path 21d guide batch (B=512)",
            _gauss_inputs(hp, gather_batch(fc, torch.arange(512)), ZERO_LENGTH_PAD), 10)
        del fc, hp
        torch.cuda.empty_cache()

        # ---- 21e: reference_parity on a mocked reference ----
        corpus, _, _ = make_flickr8k_mini(**HEADLINE, device=dev)
        p_mock, _ = hmm.train(hmm.init(corpus), corpus, 20)
        mock_al = hmm.align(p_mock, corpus).cpu().numpy()
        ref, shifted, empty = (os.path.join(tmp, d) for d in ("ref", "shifted", "empty"))
        _write_mock_reference(ref, corpus, mock_al)
        _write_mock_reference(shifted, corpus, mock_al, shift=True)
        os.makedirs(empty)
        del corpus, p_mock
        reports = {}
        for key, d in (("parity", ref), ("shifted", shifted), ("empty", empty)):
            reports[key] = run(f"21e_{key}", lambda d=d, key=key: rpar.main(
                ["--reference", d, "--workdir", os.path.join(tmp, f"wd_{key}"),
                 "--output", os.path.join(tmp, f"report_{key}.json")]))
        (dump,) = reports["parity"]["dumps"].values()
        print(f"path 21e: parity {dump}; shifted {reports['shifted'].get('dumps')}; "
              f"empty {reports['empty']}")
        _check(reports["parity"]["status"] == "parity" and dump["token_agreement"] == 1.0,
               f"path 21e: status parity, token agreement 1.0 on the mock ({dump})")
        _check(reports["shifted"]["status"] == "diverged",
               "path 21e: the dump shifted by one target position: diverged")
        _check(reports["empty"]["status"] == "reference-mount-empty"
               and "reference-mount-empty" in rpar.OK_STATUSES,
               "path 21e: an empty directory: reference-mount-empty")
        for key in ("parity", "shifted"):
            launched(f"21e_{key}", table_lookup=20, hmm_estep_counts=20, hmm_estep=0, viterbi=1)
        launched("21e_empty", table_lookup=0, hmm_estep_counts=0, hmm_estep=0, viterbi=0)
        with tempfile.TemporaryDirectory(dir=tmp) as wd:
            with open(os.path.join(ref, "phone_captions.txt")) as f, \
                    open(os.path.join(wd, "ref_src.txt"), "w") as g:
                g.write(f.read())
            with open(os.path.join(ref, "concept_labels.txt")) as f, \
                    open(os.path.join(wd, "ref_trg.txt"), "w") as g:
                g.write(f.read())
            mock, _ = load_corpus(wd, "ref", device=dev)
        checks["k2"]["path21e_mock"] = parity(f"path 21e mock (N={mock.n})", mock, reps=5)
        p_m, _ = hmm.em_step(hmm.init(mock), mock, use_kernels=False)
        checks["k3"]["path21e_mock"] = k3_parity("path 21e mock", _discrete_inputs(p_m, mock), 10)
        checks["k1"]["path21e_mock"] = k1_check("path 21e mock", p_m.log_emit, mock.src,
                                                hmm_core.state_concepts(mock), 20)
        del mock, p_m

        # ---- the oracle corpus through hmm.train, against the port's NumpyHMM ----
        small, _, _ = make_flickr8k_mini(**ORACLE_CORPUS, device=dev)
        lls = run("21_oracle", lambda: hmm.train(hmm.init(small), small, ORACLE_ITERS)[1])
        launched("21_oracle", table_lookup=ORACLE_ITERS, hmm_estep_counts=ORACLE_ITERS,
                 hmm_estep=0, viterbi=0)
        checks["k2"]["path21_oracle"] = parity(f"path 21 oracle corpus (N={small.n})", small,
                                               reps=5)
        p_o, _ = hmm.em_step(hmm.init(small), small, use_kernels=False)
        checks["k1"]["path21_oracle"] = k1_check("path 21 oracle corpus", p_o.log_emit, small.src,
                                                 hmm_core.state_concepts(small), 20)
        del small, p_o
        o_out, o_err = oracle.communicate(timeout=600)
        _check(oracle.returncode == 0, f"the oracle's process ran ({o_err[-2000:]})")
        o = json.loads(o_out.strip().splitlines()[-1])
        rel = _rel(lls.cpu().numpy(), o["lls"])
        print(f"path 21 oracle: the port's NumpyHMM loglik per iteration {o['lls']}; hmm.train "
              f"through K1 + K2 {lls.tolist()}; max rel {rel:.3e}")
        _check(rel <= 1e-5, "path 21 oracle: each EM iteration's loglik within rtol 1e-5 of "
                            "the float64 NumpyHMM's (tests/test_torch_core_helpers.py's bound)")
        rate = o["utterances"] * ORACLE_ITERS / o["seconds"]
        print(f"  information: the port's NumpyHMM on this card's host, in a process of its own "
              f"beside path 21's legs: {rate:.2f} utt*iter/s ({o['utterances']} utterances x "
              f"{ORACLE_ITERS} iterations in {o['seconds']:.2f} s)")
    finally:
        if oracle.poll() is None:
            oracle.kill()
            oracle.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"path 21 wall time {time.perf_counter() - t_path:.1f} s; by leg (s) {times}")

    # each K1-K4 launch of path 21 at its checked shape
    la = launches
    shape_launches = {
        "table_lookup": {"path21a_phones": 10, "path21a_codes": 10, "path21a_code_chunk": 12,
                         "path21e_mock": 40, "path21_oracle": ORACLE_ITERS},
        "hmm_estep_counts": {"path21a_phones": 10, "path21a_codes": 10, "path21e_mock": 40,
                             "path21_oracle": ORACLE_ITERS},
        "hmm_estep": {"path21a_chunk": la["21a"]["hmm_estep"],
                      "path21b_chunk": la["21b"]["hmm_estep"],
                      "path21c_batch": la["21c"]["hmm_estep"],
                      "path21d_teacher": la["21d"]["hmm_estep"] + hmm_iters,
                      "path21d_batch": SELF_TRAIN_MB_STEPS},
        "viterbi": {"path21a_chunk": 32, "path21a_phones": 1, "path21a_codes": 1, "S64": 2,
                    "path21c_decode": la["21c"]["viterbi"],
                    "path21d_teacher": la["21d"]["viterbi"] + 1, "path21e_mock": 2},
    }
    return {"launches": launches, "shape_launches": shape_launches, "checks": checks,
            "rounding": rounding, "times": times, "wall": time.perf_counter() - t_path}


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
    from multimodalworddiscovery_tpu_torch.scripts import bench_kernels as bk

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
    k1_head = k1_check("the headline shape", params.log_emit, corpus.src, concepts, 50)
    print(f"  [{card}] K1 at the headline shape: kernel {k1_head['ms']:.4f} ms (device "
          f"{k1_head['device_ms']:.4f}), bound {k1_head['bound_ms']:.4f} ms")
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
    head19 = {"corpus": corpus, "params": kern["params"], "lls": kern["lls"]}  # path 19a's
    head20 = {"lls": kern["lls"], "f1": kern["prf"]["f1"], "ms": ms_k}  # path 20a's
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
    gauss19 = {"corpus": fc, "p0": p_diag, "lls": g_kern["lls"][:PAR_GAUSS_ITERS]}  # path 19a's
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
        run["p0"] = pv
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
           and teach["hmm_estep"] == 3 and teach["pair_counts"] == 0,
           "K1 launched in the VQ teacher, K2 once per EM iteration, K4 once per seeding "
           "round (the teacher's posteriors), K7 never")
    _check(sum(r_p["launches"][0].values()) + sum(r_p["launches"][1].values()) == 0,
           "the recipe's plain route launched no kernel")
    _check(gauss["hmm_estep"] > 0 and gauss["viterbi"] > 0,
           "K4 and K3 launched on the recipe's Gaussian EM and decode")
    _check(bool(np.all(np.isfinite(r_k["lls"]))), "recipe loglik finite")
    f1, f1_p = r_k["prf"]["f1"], r_p["prf"]["f1"]
    _check(abs(f1 - f1_p) <= 0.005, f"recipe F1 within 0.005 of plain ({f1:.4f} vs {f1_p:.4f})")
    _check(f1 >= 0.30, f"recipe F1 >= 0.30 ({f1:.4f}; the JAX package documents "
                       f"{DOCUMENTED_RECIPE_F1} for this config at N=4000)")
    print(f"  recipe boundary F1 (tolerance 1): kernel path {r_k['boundary']['f1']:.4f}, "
          f"plain path {r_p['boundary']['f1']:.4f}")
    # path 17 streams this corpus from path 3's initial parameters
    stretch_resident = (fc, fg, r_k["p0"], f1)
    recipe20 = {"lls": r_k["lls"], "f1": f1}  # path 20b's
    stretch21 = (fc, fg.alignment)  # path 21b's shape
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

    # --- path 10: Model-1 (K1), kernels then plain ---
    m1 = model1_phase(card, kernels_all, dev)
    torch.cuda.empty_cache()
    print(elapsed())

    # --- path 11: the attention aligner, unguided and guided (K1, K2, K4) ---
    mc, mg, _ = make_flickr8k_mini(**bk.MODELS_CORPUS, device=dev)
    att = attention_phase(card, kernels_all, dev, mc, mg)
    torch.cuda.empty_cache()
    print(elapsed())

    # --- path 12: grounding and pooled retrieval (K1) ---
    ground = grounding_retrieval_phase(card, kernels_all, dev, mc, att["teacher"])
    del mc, mg
    torch.cuda.empty_cache()
    print(elapsed())

    # --- path 13: segmental k-means and DTW ---
    skd = segkmeans_dtw_phase(card, kernels_all, dev)
    torch.cuda.empty_cache()
    print(elapsed())

    # --- path 14: the image branch (VGG16, the detector, the image pipeline) ---
    img = image_phase(here, card, kernels_all, dev)
    torch.cuda.empty_cache()
    print(elapsed())

    # --- path 15: the CRF on minibatches (K4, K3) and the dense Viterbi (K1, K3) ---
    crf_mb = crf_minibatch_phase(card, kernels_all, dev)
    vd = viterbi_dense_phase(card, kernels_all, dev)
    print(elapsed())

    # --- paths 16-18: out-of-core and bucketed EM, the streamed trainers;
    # their shards in a temporary directory removed at the end ---
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shards_") as tmp:
        s16 = stream_phase(here, card, kernels_all, dev, tmp)
        torch.cuda.empty_cache()
        print(elapsed())
        s17 = stream_recipe_phase(card, kernels_all, dev, tmp, *stretch_resident)
        del stretch_resident
        torch.cuda.empty_cache()
        print(elapsed())
        s18 = stream_gradient_phase(card, kernels_all, dev, tmp)
        torch.cuda.empty_cache()
        print(elapsed())
        # --- path 19: the parallel layer (world size 1 over NCCL; 2 ranks over
        # gloo on this card), on path 16's and path 17's shards ---
        s19 = parallel_phase(here, card, kernels_all, dev, head19, gauss19, s16,
                             os.path.join(tmp, "stretch32"))
        del head19, gauss19
        torch.cuda.empty_cache()
        print(elapsed())

    # --- path 20: the port's CLI on the card, as a user runs it ---
    s20 = cli_phase(here, card, kernels_all, dev, head20, recipe20)
    torch.cuda.empty_cache()
    print(elapsed())

    # --- path 21: the study and parity drivers through their main() (K1-K4) ---
    s21 = studies_phase(here, card, kernels_all, dev, *stretch21)
    del stretch21
    torch.cuda.empty_cache()
    print(elapsed())

    # --- the port's bench_kernels (counts, log_matmul) and bench_assoc ---
    launches_bench = bench_phase(here, kernels_all)
    torch.cuda.empty_cache()
    print(elapsed())

    runs = (launches_headline, launches_gauss, teach, gauss, pipe, launches_bf16, launches_k6,
            *crf["launches"].values(), dense["launches"], assoc["launches"], many["launches"],
            m1["launches"], *m1["dense_launches"].values(), *att["launches"].values(),
            *ground["launches"].values(), skd["launches"], img["launches"],
            *(r["launches"] for r in crf_mb.values()), *(r["launches"] for r in vd.values()),
            *s16["launches"].values(), *s17["launches"].values(), *s18["launches"].values(),
            *s19["launches"].values(), *s20["launches"].values(), *s21["launches"].values())
    launches = {name: sum(r[name] for r in runs) for name in launches_headline}
    launches["log_matmul_bf16"] = launches_bench["log_matmul_bf16"]
    print(f"kernel launches, summed over the paths' kernel runs (K6: its entry-point run; "
          f"K8-bf16: bench_kernels' log_matmul entry, its entry point): {launches}")
    # K4's launch shapes: launches on the paths' kernel runs, time, bound and
    # plain time of each (K4-bf16: path 6's bf16 run at the CRF's S=8)
    crf_l = crf["launches"]
    al, ac = att["launches"], att["checks"]
    k4_runs = {
        "S64": (k4_stretch, launches_gauss["hmm_estep"] + gauss["hmm_estep"]
                + teach["hmm_estep"] + s17["launches"]["resident"]["hmm_estep"]
                + s17["launches"]["resident16"]["hmm_estep"], 0),
        "S128": (k4_128, dense["launches"]["hmm_estep"], 0),
        "S8_pipeline": (k4_s8["S8_pipeline"], pipe["hmm_estep"], 0),
        "S8_crf": (k4_s8["S8_crf"], sum(r["hmm_estep"] for r in crf_l.values())
                   + s18["launches"]["dnn_crf_resident"]["hmm_estep"],
                   sum(r["hmm_estep_bf16"] for r in crf_l.values())),
        **{f"{k} (S={r['S']})": (r["k4"], many["launches"]["hmm_estep"] if k == "S~200" else 0,
                                 0) for k, r in many["shapes"].items()},
        "S12_guide": (ac["k4_guide"], al["guided"]["hmm_estep"], 0),
        "S8_guided_frames": (ac["k4_frames"], al["guided_frames"]["hmm_estep"], 0),
        **{f"crf_minibatch_{k}": (r["k4"], r["launches"]["hmm_estep"], 0)
           for k, r in crf_mb.items()},
        "S64_stretch_shard": (s17["k4"], s17["shard_k4"], 0),
        "S8_dnn_shard": (s18["dnn"]["crf"]["shapes"]["shard"],
                         s18["launches"]["dnn_crf_shard"]["hmm_estep"], 0),
        "S8_stream_test_shard": (s18["dnn"]["test"]["shapes"]["shard"],
                                 s18["launches"]["dnn_test_shard"]["hmm_estep"], 0),
        "S8_stream_test": (s18["dnn"]["test"]["shapes"]["resident"],
                           s18["launches"]["dnn_test_resident"]["hmm_estep"], 0),
    }
    s19l, s20l, s20c = s19["shape_launches"], s20["shape_launches"], s20["checks"]
    s21l, s21c = s21["shape_launches"], s21["checks"]
    k4_runs["path20d_shard"] = (s20c["k4_fullscale"], 0, 0)
    k4_runs.update({k: (r, 0, 0) for k, r in s21c["k4"].items()})
    for k, n in [*s19l.get("hmm_estep", {}).items(),  # paths 19's to 21's launches
                 *s20l["hmm_estep"].items(), *s21l["hmm_estep"].items()]:
        r, n0, nb = k4_runs[k]
        k4_runs[k] = (r, n0 + n, nb)
    k4_shapes = {k: {"launches": n, "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
                 for k, (r, n, _) in k4_runs.items()}
    k4bf_shapes = {k: {"launches": nb, "ms": r["bf16_ms"], "plain_ms": r["bf16_plain_ms"],
                       **r["bf16_bound"]} for k, (r, _, nb) in k4_runs.items()
                   if "bf16_ms" in r}
    # K3's launch shapes: launches on the paths' kernel runs (S=12: paths 1
    # and 5; S=64: paths 2 and 3), time, bound and plain time of each
    k3_runs = {
        "S12": (k3_s12, launches_headline["viterbi"] + launches_bf16["viterbi"]
                + s16["launches"]["headline"]["viterbi"]),
        "S64": (k3_stretch, launches_gauss["viterbi"] + gauss["viterbi"]),
        "S128": (k3_128, dense["launches"]["viterbi"]),
        "S8_pipeline": (k4_s8["S8_pipeline"]["k3"], pipe["viterbi"]),
        "S8_crf": (k4_s8["S8_crf"]["k3"], sum(r["viterbi"] for r in crf_l.values())
                   + s18["launches"]["dnn_crf_resident"]["viterbi"]),
        "S8_stream_test": (s18["dnn"]["test"]["shapes"]["resident"]["k3"],
                           s18["launches"]["dnn_test_resident"]["viterbi"]),
        **{f"{k} (S={r['S']})": (r["k3"], many["launches"]["viterbi"] if k == "S~200" else 0)
           for k, r in many["shapes"].items()},
        "S12_teacher": (ac["k3_teacher"], al["teacher"]["viterbi"]),
        **{f"crf_minibatch_{k}_decode": (r["k3"], r["launches"]["viterbi"])
           for k, r in crf_mb.items()},
        **{f"viterbi_dense_{k}": (r["k3"], r["launches"]["viterbi"]) for k, r in vd.items()},
        **{f"path16_{k}": (r, 1) for k, r in s16["k3"].items()},
        "S64_stretch_shard": (s17["k3"], s17["launches"]["gauss"]["viterbi"]),
    }
    k3_runs["path20c_shard"] = (s20c["k3_shard"], 0)
    k3_runs["path20d_shard"] = (s20c["k3_fullscale"], 0)
    k3_runs.update({k: (r, 0) for k, r in s21c["k3"].items()})
    for k, n in [*s19l.get("viterbi", {}).items(), *s20l["viterbi"].items(),
                 *s21l["viterbi"].items()]:
        r, n0 = k3_runs[k]
        k3_runs[k] = (r, n0 + n)
    k3_shapes = {k: {"launches": n, "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
                 for k, (r, n) in k3_runs.items()}
    # K2's and K2-bf16's: the headline (paths 1 and 5), the gate edge (no
    # path), the VQ teacher (path 3's seeding) and path 11's discrete teacher
    s16l = s16["launches"]
    k2_runs = {"S12_headline": (errs, launches_headline["hmm_estep_counts"]
                                + s16l["headline"]["hmm_estep_counts"],
                                launches_bf16["hmm_estep_counts_bf16"]),
               "S64_gate": (errs_edge, 0, 0),
               "S64_teacher": (teacher, teach["hmm_estep_counts"], 0),
               "S12_teacher": (ac["k2_teacher"], al["teacher"]["hmm_estep_counts"], 0),
               **{f"path16_{k}": (r, s16l[k]["hmm_estep_counts"] if k in s16l
                                  else STREAM_ITERS, 0) for k, r in s16["checks"].items()},
               "S64_teacher_shard": (s17["k2"], s17["launches"]["teacher"]["hmm_estep_counts"],
                                     0)}
    k2_runs["path19_rank_shard"] = (s19["checks"]["parity"], 0, 0)
    k2_runs["path20c_shard"] = (s20c["k2_shard"], 0, 0)
    k2_runs.update({k: (r, 0, 0) for k, r in s21c["k2"].items()})
    for k, n in [*s19l.get("hmm_estep_counts", {}).items(),
                 *s20l["hmm_estep_counts"].items(), *s21l["hmm_estep_counts"].items()]:
        r, n0, nb = k2_runs[k]
        k2_runs[k] = (r, n0 + n, nb)
    k2_shapes = {k: {"launches": n, **r["k2"]} for k, (r, n, _) in k2_runs.items()}
    k2bf_shapes = {k: {"launches": nb, **r["k2bf"]} for k, (r, _, nb) in k2_runs.items()}
    print(f"[{card}] K2 per launch shape: {json.dumps(k2_shapes)}")
    print(f"[{card}] K2-bf16 per launch shape: {json.dumps(k2bf_shapes)}")
    print(f"[{card}] K4 per launch shape: {json.dumps(k4_shapes)}")
    print(f"[{card}] K4-bf16 per launch shape: {json.dumps(k4bf_shapes)}")
    print(f"[{card}] K6 per shape (ms): "
          f"{json.dumps({k: r['k6_ms'] for k, (r, _, _) in k4_runs.items()
                         if 'k6_ms' in r})}")
    print(f"[{card}] K3 per shape: {json.dumps(k3_shapes)}")
    # K1's launch shapes: the headline (paths 1 and 5), path 8, the VQ
    # teacher (path 3's seeding), the S~200 EM, Model-1 (path 10's decode
    # and its dense decodes against the concept space), path 11's teacher
    # and guide batches, pooled retrieval (path 12)
    m1l = {k: m1["dense_launches"][k]["table_lookup"] for k in ("Tt6", "Tt32")}
    m1l["Tt6"] += m1["launches"]["table_lookup"]
    k1_launch = {"S12_headline": (k1_head, launches_headline["table_lookup"]
                                  + launches_bf16["table_lookup"]
                                  + s16l["headline"]["table_lookup"]),
                 "S128_dense": (dense["k1"], dense["launches"]["table_lookup"]),
                 "S64_teacher": (teacher["k1"], teach["table_lookup"]),
                 "S~200": (many["k1"], many["launches"]["table_lookup"]),
                 "model1_Tt6": (m1["k1"]["Tt6"], m1l["Tt6"]),
                 "model1_Tt32": (m1["k1"]["Tt32"], m1l["Tt32"]),
                 "S12_teacher": (ac["k1_teacher"], al["teacher"]["table_lookup"]),
                 "S12_guide": (ac["k1_guide"], al["guided"]["table_lookup"]),
                 "retrieval_pooled": (ground["k1"],
                                      ground["launches"]["retrieval"]["table_lookup"]),
                 **{f"viterbi_dense_{k}": (r["k1"], r["launches"]["table_lookup"])
                    for k, r in vd.items()},
                 **{f"path16_{k}": (r, s16l[k]["table_lookup"] if k in s16l else STREAM_ITERS)
                    for k, r in s16["k1"].items()},
                 "S64_teacher_shard": (s17["k1"], s17["launches"]["teacher"]["table_lookup"])}
    k1_launch["path19_rank_shard"] = (s19["checks"]["k1"], 0)
    k1_launch["path20c_shard"] = (s20c["k1_shard"], 0)
    k1_launch.update({k: (r, 0) for k, r in s21c["k1"].items()})
    for k, n in [*s19l.get("table_lookup", {}).items(), *s20l["table_lookup"].items(),
                 *s21l["table_lookup"].items()]:
        r, n0 = k1_launch[k]
        k1_launch[k] = (r, n0 + n)
    k1_runs = [r for r, _ in k1_launch.values()]
    k1_shapes = {k: {"launches": n, **{f: r[f] for f in ("ms", "device_ms", "plain_ms",
                                                         "bound_ms", "bound_by", "library_ms")}}
                 for k, (r, n) in k1_launch.items()}
    print(f"[{card}] K1 per launch shape: {json.dumps(k1_shapes)}")
    # every launch of K1-K4 on the paths' kernel runs lies at a shape whose
    # kernel was held against its plain version above
    for name, shapes in (("table_lookup", k1_shapes), ("hmm_estep_counts", k2_shapes),
                         ("hmm_estep_counts_bf16", k2bf_shapes), ("viterbi", k3_shapes),
                         ("hmm_estep", k4_shapes), ("hmm_estep_bf16", k4bf_shapes)):
        at = sum(r["launches"] for r in shapes.values())
        _check(at == launches[name], f"{name}: the {launches[name]} launches on the paths all "
                                     f"lie at checked shapes ({at})")
    k8_big = k8_r[K8_SIZES[-1]]
    k8_errs = [r["err"] for r in k8_r.values()] + [
        e for r in assoc["shapes"].values() for e in (r["err"], r["prefix_err"])] + [
        r["err"] for r in s19["k8"].values()]
    kernels = [
        {"name": "table_lookup", "route": "cuda",
         "source": "multimodalworddiscovery_tpu_torch/csrc/counts.cu",
         "replaces": "multimodalworddiscovery_tpu/ops/counts_pallas.py:92",
         "launches": launches["table_lookup"],
         "max_abs_err": max(errs["k1_err"], teacher["k1_err"], *(r["err"] for r in k1_runs)),
         **{k: k1_head[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}, "shapes": k1_shapes},
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
         "max_abs_err": max(k5_r["err"], s20c["k5_fullscale"]["err"]), "ms": k5_r["ms"],
         "plain_ms": k5_r["plain_ms"],
         "bound_ms": k5_r["bound_ms"], "bound_by": k5_r["bound_by"], "library_ms": None,
         "spectrum_library_ms": k5_r["spectrum_library_ms"],
         "direct_400_ms": k5_r["direct_400_ms"]},
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
         "bound_by": k8_big["bound_by"], "library_ms": k8_big["library_ms"],
         "guard_share": k8_big["guard_share"], "shapes": {
             f"path9_first_combine_{k}": {f: r[f] for f in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "guard_share",
                 "guard_summed_share", "combines")} for k, r in assoc["shapes"].items()},
             "path19_sequence_compose": {f: s19["k8"]["tree"][f] for f in (
                 "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "guard_share", "guard_summed_share")}},
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
    print(json.dumps({"kernels": _json_safe(kernels)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
