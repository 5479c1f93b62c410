"""K4, K4-bf16 and K6 (``ops/hmm_fwdbwd.hmm_estep``) at the four shapes the
main paths launch them at, K2 and K2-bf16 (``hmm_estep_counts``) at the
three shapes of the fused E-step, and K3 (``ops/viterbi.viterbi``) at every
shape, on one GPU -> JSON lines.

    python -m multimodalworddiscovery_tpu_torch.scripts.bench_estep \\
        [--reps 10] [--only S64 S128 S8_pipeline S8_crf S12_headline S64_gate \\
        S64_teacher S200 S260] [--profile] [--out build/bench/estep.jsonl]

The shapes, built as the paths build their E-step inputs:

- ``S64``: the stretch config's corpus (N=4000 frames of 64 dims, S=64,
  Ts=401) with 4 zero-length utterances appended, Gaussian emissions from
  ``init_diagonal`` (paths 2 and 3);
- ``S128``: the discrete route outside K2's gate (N=512 + 4 empty, Ts=181,
  S=128), K1's emissions after one EM step (path 8's shape);
- ``S8_pipeline``: config #4's waveform pipeline (N=2000, Ts=174, S=8),
  emissions of ``run_pipeline.init_params`` on its MFCCs (path 4);
- ``S8_crf``: ``configs/hmm_crf_frames.py`` (N=400, Ts=64, S=8), the
  emission MLP of ``hmm_dnn.init`` (paths 6 and 7, the DNN-HMM);
- ``S12_headline``: the headline corpus (N=8000 + 4 empty, Ts=31, S=12),
  K1's emissions after one EM step: K2 and K2-bf16 (``hmm_estep_counts``)
  and K3 at the headline path's shape;
- ``S64_gate``: ``chip_smoke.py``'s K2 gate edge (N=1024 + 4 empty, S=64,
  V_trg=201), K1's emissions after one EM step: K2, K2-bf16 and K3;
- ``S64_teacher``: the stretch recipe's VQ teacher, the code corpus built
  as ``chip_smoke.py``'s ``teacher_phase`` and ``init_vq_teacher`` build it
  (N=4000 + 4 empty, Ts=401, S=64, V_src=64, V_trg=201), K1's emissions
  after one EM step (max_jump 5): K2, K2-bf16 and K3 (path 3's teacher);
- ``S200``: ``chip_smoke.py``'s many-states corpus with 96-100 concepts an
  image (N=64 + 4 empty, S~200), K1's emissions after one plain EM step;
- ``S260``: ``chip_smoke.py``'s many-states corpus with 126-130 concepts an
  image (N=32 + 4 empty, S=260), K1's emissions after one plain EM step:
  K3 past 8-bit backpointers, with base in device memory.

Each record holds the ms per call of K4, K4-bf16, K6 (``remat=True``,
chunk 32), K4's plain version and K3 (K2 and K2-bf16 too, with their
bounds, at the three K2 shapes; CUDA events after a warm-up and a synchronize), the valid
utterance-steps and the E-step's bound (the larger of the
bytes over 3.35 TB/s and 7 S^2 operations per valid utterance-step over
67 TFLOP/s; in bf16 the 6 S^2 of the products at 989 TFLOP/s), with the
card's name and power limit; with ``--profile`` also each kernel's device
time in one call of K4, K4-bf16, K3 and (at its shapes) K2
(torch.profiler).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core, hmm_crf, hmm_dnn, hmm_gaussian
from multimodalworddiscovery_tpu_torch.ops import counts as k1
from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k4
from multimodalworddiscovery_tpu_torch.ops import viterbi as k3
from multimodalworddiscovery_tpu_torch.scripts import run_pipeline as rp
from multimodalworddiscovery_tpu_torch.scripts.bench_kernels import (
    Recorder, bound, gpu_ms, require_cuda)

DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[2] / "build" / "bench" / "estep.jsonl"
SHAPES = ("S64", "S128", "S8_pipeline", "S8_crf", "S12_headline", "S64_gate", "S64_teacher",
          "S200", "S260")
K2_SHAPES = ("S12_headline", "S64_gate", "S64_teacher")  # inside the fused route's gate
N_EMPTY = 4  # zero-length utterances appended at S64 and S128, as chip_smoke.py does
STRETCH = dict(n_utterances=4000, n_concepts=200, n_phones=48, min_concepts=16,
               max_concepts=32, seed=0)
S128 = dict(n_utterances=512, n_concepts=200, min_concepts=60, max_concepts=64,
            min_word_len=2, max_word_len=3, seed=21)
CRF_CORPUS = dict(n_utterances=400, n_concepts=40, n_phones=48, min_concepts=2,
                  max_concepts=4, seed=0)
HEADLINE = dict(n_utterances=8000, n_concepts=60, n_phones=48, min_concepts=3,
                max_concepts=6, seed=0)  # chip_smoke.py's HEADLINE
GATE_EDGE = dict(n_utterances=1024, n_concepts=200, min_concepts=28, max_concepts=32,
                 min_word_len=2, max_word_len=3, seed=21)  # chip_smoke.py's GATE_EDGE
MANY_200 = dict(n_utterances=64, n_concepts=400, min_concepts=96, max_concepts=100,
                min_word_len=2, max_word_len=3, seed=5)  # chip_smoke.py's MANY_200
MANY_260 = dict(n_utterances=32, n_concepts=400, min_concepts=126, max_concepts=130,
                min_word_len=2, max_word_len=2, seed=5)  # chip_smoke.py's MANY_260


def _factored(log_jump, log_p0, corpus, max_jump):
    base, rowz, colmask = hmm_core.factor_log_trans(log_jump, log_p0, corpus, max_jump)
    return hmm_core.build_log_init(log_p0, corpus), base, rowz, colmask


def _discrete(corpus, use_kernels: bool, max_jump: int = 3) -> tuple:
    """The E-step inputs of a discrete corpus after one EM step from
    ``hmm.init``, and K2's extra arguments (src, concepts, V_src, V_trg)."""
    p, _ = hmm.em_step(hmm.init(corpus, max_jump=max_jump), corpus, use_kernels=use_kernels)
    concepts = hmm_core.state_concepts(corpus)
    inputs = (*_factored(p.log_jump, p.log_p0, corpus, p.max_jump),
              k1.table_lookup(p.log_emit, corpus.src, concepts), corpus.src_len)
    return inputs, (corpus.src, concepts, corpus.src_vocab, corpus.trg_vocab)


def teacher_codes(fc):
    """The VQ teacher's code corpus of the stretch frames ``fc``, drawn as
    ``hmm_gaussian.init_vq_teacher`` draws it (the generator seeded 0, the
    jitter of ``hmm_gaussian.init`` first)."""
    gen = torch.Generator().manual_seed(0)
    hmm_gaussian.init(fc, max_jump=5, n_components=2, generator=gen)
    return hmm_gaussian.quantize_frames(fc, n_codes=64, generator=gen)


def discrete_inputs(label: str, dev) -> tuple:
    """(E-step inputs, K2's extra arguments) of one of K2_SHAPES or a
    discrete many-states shape."""
    if label == "S64_teacher":
        pc, pg, _ = make_flickr8k_mini(**STRETCH, device=dev)
        fc, _, _ = phones_to_frames(pc, pg, feat_dim=64, seed=0, device=dev)
        codes = teacher_codes(fc)
        return _discrete(codes.pad_to(codes.n + N_EMPTY), True, max_jump=5)
    gen = {"S128": S128, "S12_headline": HEADLINE, "S64_gate": GATE_EDGE, "S200": MANY_200,
           "S260": MANY_260}[label]
    c, _, _ = make_flickr8k_mini(**gen, device=dev)
    return _discrete(c.pad_to(c.n + N_EMPTY), label not in ("S200", "S260"))


def shape_inputs(label: str, dev) -> tuple:
    """(log_init, base, rowz, colmask, log_emit, src_len) of one launch shape."""
    if label == "S64":
        pc, pg, _ = make_flickr8k_mini(**STRETCH, device=dev)
        fc, _, _ = phones_to_frames(pc, pg, feat_dim=64, seed=0, device=dev)
        p = hmm_gaussian.init_diagonal(fc, max_jump=5, n_components=1,
                                       generator=torch.Generator().manual_seed(0))
        fc = fc.pad_to(fc.n + N_EMPTY)
        return (*_factored(p.log_jump, p.log_p0, fc, p.max_jump),
                hmm_gaussian._log_emissions(p, fc), fc.src_len)
    if label in ("S128", "S200", "S260", *K2_SHAPES):
        return discrete_inputs(label, dev)[0]
    if label == "S8_pipeline":
        phone_corpus, _, wavs, wav_lens = rp.synthesize(2000, dev)
        feats, frame_lens = rp.frontend(torch.as_tensor(wavs, device=dev),
                                        torch.as_tensor(wav_lens, device=dev))
        c = rp.frame_corpus(feats, frame_lens, phone_corpus)
        p = rp.init_params(c)
        return (*_factored(p.log_jump, p.log_p0, c, p.max_jump),
                hmm_gaussian._log_emissions(p, c), c.src_len)
    if label == "S8_crf":
        pc, pg, _ = make_flickr8k_mini(**CRF_CORPUS, device=dev)
        fc, _, _ = phones_to_frames(pc, pg, feat_dim=12, seed=0, device=dev)
        p = hmm_dnn.init(fc, max_jump=3, hidden=256, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            emit = hmm_crf._log_emit_from_mlp(p.mlp, fc)
        return (*_factored(p.log_jump, p.log_p0, fc, p.max_jump), emit.contiguous(), fc.src_len)
    raise ValueError(f"unknown shape {label!r}; one of {SHAPES}")


def estep_bound(nbytes: float, src_len, s: int, bf16: bool) -> dict:
    """chip_smoke.py's ``_estep_bound``: bytes over the memory rate, or 7 S^2
    float32 operations per valid utterance-step (bf16: 6 of them at the bf16
    tensor-core rate), whichever is larger."""
    steps = float(int(src_len.sum())) * s * s
    return bound(nbytes, steps, 6 * steps) if bf16 else bound(nbytes, 7 * steps)


def k3_bound(inputs) -> dict:
    """chip_smoke.py's K3 bound: the bytes of the inputs and the path over
    the memory rate, or 2 S^2 float32 operations (add, max) per valid
    utterance-step, whichever is larger."""
    n, ts, s = inputs[4].shape
    nbytes = sum(t.numel() * t.element_size() for t in inputs) + 4 * n * ts
    return bound(nbytes, 2.0 * s * s * float(int(inputs[5].sum())))


def time_shape(inputs, reps: int) -> dict:
    """ms per call of K4, K4-bf16, K6, K4's plain version and K3, and the
    E-step's bounds."""
    n, ts, s = inputs[4].shape
    gamma, xi, logz = k4.hmm_estep(*inputs)
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, gamma, xi, logz))
    del gamma, xi, logz
    return {
        "N": n, "Ts": ts, "S": s, "valid_steps": int(inputs[5].sum()),
        "k4_ms": gpu_ms(lambda: k4.hmm_estep(*inputs), reps),
        "k4_bf16_ms": gpu_ms(lambda: k4.hmm_estep(*inputs, dot_dtype="bfloat16"), reps),
        "k6_ms": gpu_ms(lambda: k4.hmm_estep(*inputs, remat=True), reps),
        "plain_ms": gpu_ms(lambda: k4.hmm_estep_plain(*inputs), max(reps // 10, 1)),
        "k3_ms": gpu_ms(lambda: k3.viterbi(*inputs), reps),
        "k3_bound": k3_bound(inputs),
        "bound": estep_bound(nbytes, inputs[5], s, False),
        "bf16_bound": estep_bound(nbytes, inputs[5], s, True),
    }


def k2_args(inputs, extra) -> tuple:
    """``hmm_estep_counts``'s arguments from ``discrete_inputs``' pair."""
    return (*inputs[:5], *extra[:2], inputs[5], *extra[2:])


def time_k2(args, reps: int) -> dict:
    """ms per call of K2 and K2-bf16 on ``k2_args``, and their bounds: the
    bytes of the inputs and of the counts, xi and logZ, or K4's operations."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args[:8], *k4.hmm_estep_counts(*args)))
    s = args[4].shape[2]
    return {"k2_ms": gpu_ms(lambda: k4.hmm_estep_counts(*args), reps),
            "k2_bf16_ms": gpu_ms(lambda: k4.hmm_estep_counts(*args, dot_dtype="bfloat16"), reps),
            "k2_bound": estep_bound(nbytes, args[7], s, False),
            "k2_bf16_bound": estep_bound(nbytes, args[7], s, True)}


def kernel_ms(fn) -> dict[str, float]:
    """Device ms of each kernel ``fn()`` launches (torch.profiler, one run
    after a warm-up), by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.self_device_time_total > 0}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", nargs="+", choices=SHAPES, default=list(SHAPES))
    ap.add_argument("--out", type=pathlib.Path, default=DEFAULT_OUT)
    ap.add_argument("--profile", action="store_true",
                    help="also record each kernel's device time in one K4, K4-bf16 and K3 call "
                         "(and K2 at its shapes)")
    args = ap.parse_args(argv)
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    record = Recorder(args.out)
    out = []
    for label in args.only:
        k2a = None
        if label in K2_SHAPES:
            inputs, extra = discrete_inputs(label, dev)
            k2a = k2_args(inputs, extra)
        else:
            inputs = shape_inputs(label, dev)
        rec = time_shape(inputs, args.reps)
        if k2a is not None:
            rec |= time_k2(k2a, args.reps)
            if args.profile:
                rec["k2_kernels_ms"] = kernel_ms(lambda: k4.hmm_estep_counts(*k2a))
        if args.profile:
            rec["k4_kernels_ms"] = kernel_ms(lambda: k4.hmm_estep(*inputs))
            rec["k4_bf16_kernels_ms"] = kernel_ms(
                lambda: k4.hmm_estep(*inputs, dot_dtype="bfloat16"))
            rec["k3_kernels_ms"] = kernel_ms(lambda: k3.viterbi(*inputs))
        out.append(record(bench="estep", shape=label, **rec))
        del inputs, k2a
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
