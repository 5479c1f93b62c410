"""End-to-end pipeline of BASELINE.json config #4 on the port:

  raw waveforms -> MFCC frontend (K5; optional deltas and CMVN)
               -> Gaussian-mixture HMM alignment EM (K4)
               -> Viterbi decode (K3) -> word segmentation -> metrics

Counterpart of ``scripts/run_pipeline.py``.  Without real audio, waveforms
are synthesized from the flickr8k-mini phone corpus (each phone a fixed
formant pair), which gives gold alignments for the final metrics.

    python -m multimodalworddiscovery_tpu_torch.scripts.run_pipeline \\
        [--utterances 200] [--iters 12] [--deltas] [--cmvn] [--device cuda]

The device is "cuda" unless ``--device`` names another ("cpu" runs the
kernels' plain versions).  Prints the JSON of the metrics, the per-iteration
logliks and the stage times.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from multimodalworddiscovery_tpu_torch.data import (
    Corpus,
    expand_gold_to_frames,
    make_flickr8k_mini,
    phones_to_waveforms,
)
from multimodalworddiscovery_tpu_torch.eval.metrics import (
    alignment_prf,
    boundary_prf,
    cluster_purity,
    word_iou,
)
from multimodalworddiscovery_tpu_torch.frontend import speech
from multimodalworddiscovery_tpu_torch.models import hmm_gaussian
from multimodalworddiscovery_tpu_torch.ops import kernels_for
from multimodalworddiscovery_tpu_torch.ops import mfcc as mfcc_ops
from multimodalworddiscovery_tpu_torch.segment import (
    boundaries_from_segments,
    segments_from_alignment,
)

N_PHONES = 24  # the script's phone inventory (scripts/run_pipeline.py:75)
SEED = 0
MFCC = speech.MfccConfig(n_mfcc=13, n_mels=26)
N_COMPONENTS = 2  # words span several phones, so emissions are multimodal
BOUNDARY_TOLERANCE = 4  # frames


class Clock:
    """Host-clock laps in ms; each lap first waits for the device."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.ms: dict[str, float] = {}
        self._last = self._now()

    def _now(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def lap(self, name: str) -> None:
        now = self._now()
        self.ms[name] = (now - self._last) * 1e3
        self._last = now


def synthesize(n_utterances: int, device="cuda"):
    """(phone corpus on ``device``, phone-level gold, wavs [N, L] float32,
    wav_lens [N] int32) of the pipeline's synthetic corpus."""
    phone_corpus, gold, _ = make_flickr8k_mini(
        n_utterances=n_utterances, n_phones=N_PHONES, seed=SEED, device=device
    )
    wavs, wav_lens, _ = phones_to_waveforms(phone_corpus, gold, seed=SEED)
    return phone_corpus, gold, wavs, wav_lens


def frontend(
    wav: torch.Tensor,
    wav_len: torch.Tensor,
    cfg: speech.MfccConfig = MFCC,
    deltas: bool = False,
    cmvn: bool = False,
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(features [N, F, D], frame_lens [N]): MFCCs through K5 with
    ``use_kernels`` (None: on CUDA tensors), then optional deltas and CMVN."""
    if kernels_for(use_kernels, wav.device):
        feats, frame_lens = mfcc_ops.extract(wav, wav_len, cfg)
    else:
        feats, frame_lens = speech.extract(wav, wav_len, cfg)
    if deltas:
        feats = speech.add_deltas(feats, frame_lens)
    if cmvn:
        feats = speech.cmvn(feats, frame_lens)
    return feats, frame_lens


def frame_corpus(feats: torch.Tensor, frame_lens: torch.Tensor, phone_corpus: Corpus) -> Corpus:
    """The frame-level corpus: features as src, the phone corpus's concepts
    as trg (float32 frames, int32 lengths and ids, on the features' device)."""
    dev = feats.device
    return Corpus(
        src=feats, src_len=frame_lens, trg=phone_corpus.trg.to(dev),
        trg_len=phone_corpus.trg_len.to(dev), src_vocab=0,
        trg_vocab=phone_corpus.trg_vocab,
    )


def init_params(corpus: Corpus, generator: torch.Generator | None = None):
    """The pipeline's initial parameters: ``hmm_gaussian.init`` with
    N_COMPONENTS components from a CPU generator (seed 0 by default)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(SEED)
    return hmm_gaussian.init(corpus, n_components=N_COMPONENTS, generator=gen)


def score(alignment: torch.Tensor, corpus: Corpus, frame_gold) -> dict:
    """Alignment P/R/F1, word IoU, boundary P/R/F1 and cluster purity."""
    gold = torch.as_tensor(frame_gold.alignment[:, : corpus.max_src_len], device=corpus.device)
    pred_segs, pred_mask = segments_from_alignment(alignment, corpus.trg, corpus.src_len)
    gold_segs, gold_mask = segments_from_alignment(gold, corpus.trg, corpus.src_len)
    pb = boundaries_from_segments(pred_segs, pred_mask, corpus.max_src_len)
    gb = boundaries_from_segments(gold_segs, gold_mask, corpus.max_src_len)

    def floats(d):
        return {k: float(v) for k, v in d.items()}

    return {
        "alignment": floats(alignment_prf(alignment, gold, corpus.src_mask())),
        "word_iou": floats(word_iou(pred_segs, pred_mask, gold_segs, gold_mask)),
        "boundary": floats(boundary_prf(pb, gb, tolerance=BOUNDARY_TOLERANCE)),
        "purity": float(cluster_purity(pred_segs, pred_mask, gold_segs, gold_mask,
                                       corpus.trg_vocab)),
    }


def fit_and_score(
    feats: torch.Tensor,
    frame_lens: torch.Tensor,
    phone_corpus: Corpus,
    gold,
    iters: int,
    use_kernels: bool | None = None,
    generator: torch.Generator | None = None,
    clock: Clock | None = None,
) -> dict:
    """EM (no anneal) from ``init_params``, decode, segment, score.  Returns
    the metrics and the per-iteration logliks ("loglik"); ``clock`` takes
    a lap after each stage."""
    clock = clock or Clock(feats.device)
    frame_gold = expand_gold_to_frames(
        gold, phone_corpus.src_len.cpu().numpy(), frame_lens.cpu().numpy()
    )
    corpus = frame_corpus(feats, frame_lens, phone_corpus)
    params, lls = hmm_gaussian.train(init_params(corpus, generator), corpus, iters,
                                     use_kernels=use_kernels)
    clock.lap("em")
    alignment = hmm_gaussian.align(params, corpus, use_kernels=use_kernels)
    clock.lap("decode")
    out = score(alignment, corpus, frame_gold)
    clock.lap("metrics")
    return out | {"loglik": lls.cpu().tolist()}


def run_pipeline(
    n_utterances: int = 200,
    iters: int = 12,
    deltas: bool = False,
    cmvn: bool = False,
    device="cuda",
    use_kernels: bool | None = None,
    generator: torch.Generator | None = None,
    data: tuple | None = None,
) -> dict:
    """The whole pipeline on ``device``: synthetic corpus and waveforms,
    the MFCC frontend (raw MFCCs by default; deltas and CMVN on request),
    Gaussian-mixture HMM EM, decode, segmentation and metrics.

    ``use_kernels`` (None: on a CUDA device) sends the frontend through K5,
    the E-step through K4 and decode through K3; False runs the plain
    versions on the same device.  ``data`` is the output of ``synthesize``
    for ``n_utterances`` when the caller made it already (it is made here
    when None).  Returns the metrics, "loglik" and "stage_ms" (host clock;
    each stage ends with a device synchronize)."""
    dev = torch.device(device)
    clock = Clock(dev)
    if data is None:
        data = synthesize(n_utterances, dev)
    phone_corpus, gold, wavs, wav_lens = data
    wav = torch.as_tensor(wavs, device=dev)
    wav_len = torch.as_tensor(wav_lens, device=dev)
    clock.lap("waveforms")
    feats, frame_lens = frontend(wav, wav_len, MFCC, deltas, cmvn, use_kernels)
    clock.lap("frontend")
    out = fit_and_score(feats, frame_lens, phone_corpus, gold, iters, use_kernels,
                        generator, clock)
    ms = clock.ms
    ms["em_per_iteration"] = ms["em"] / max(iters, 1)
    return out | {"stage_ms": ms, "shape": {
        "N": n_utterances, "L": int(wav.shape[1]), "F": int(feats.shape[1]),
        "D": int(feats.shape[2]), "S": 2 * phone_corpus.max_trg_len,
        "C": phone_corpus.trg_vocab, "K": N_COMPONENTS}}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--utterances", type=int, default=200)
    ap.add_argument("--iters", type=int, default=12)
    # raw MFCCs beat +deltas/+CMVN here: a single diagonal Gaussian per
    # concept cannot absorb per-utterance normalization shifts
    ap.add_argument("--deltas", action="store_true")
    ap.add_argument("--cmvn", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    out = run_pipeline(args.utterances, args.iters, args.deltas, args.cmvn, args.device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
