"""The JAX reference of config #4's waveform pipeline, started from the
port's initial parameters.

The steps are those of ``scripts/run_pipeline.py``: the synthetic phone
corpus (24 phones, seed 0), its waveforms, MFCCs through the JAX package's
K5 (``extract_pallas`` in interpret mode, raw MFCC(13, 26)), the
frame-level corpus and gold, ``hmm_gaussian.train`` (no anneal) and
``align``, then segmentation and the metrics.  Only the initial parameters
differ: they are the port's (``run_pipeline.init_params``: a CPU
``torch.Generator`` with seed 0, on the JAX features), carried into the JAX
package as numpy arrays, so both packages start EM from the same point.

``tests/test_torch_pipeline.py`` runs it at a small size.  At the size
``chip_smoke.py`` runs (2000 utterances, 12 iterations) it gives the value
of ``chip_smoke.REFERENCE_PIPELINE_F1``:

    JAX_PLATFORMS=cpu python tests/pipeline_reference.py --utterances 2000 --iters 12
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini
from multimodalworddiscovery_tpu.data.corpus import Corpus
from multimodalworddiscovery_tpu.data.synthetic import expand_gold_to_frames, phones_to_waveforms
from multimodalworddiscovery_tpu.eval.metrics import (
    alignment_prf,
    boundary_prf,
    cluster_purity,
    word_iou,
)
from multimodalworddiscovery_tpu.frontend.speech import MfccConfig
from multimodalworddiscovery_tpu.models import hmm_gaussian
from multimodalworddiscovery_tpu.ops.mfcc_pallas import extract_pallas
from multimodalworddiscovery_tpu.segment import boundaries_from_segments, segments_from_alignment
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.scripts import run_pipeline as port

FIELDS = ("means", "log_vars", "log_mix", "log_jump", "log_p0")
BATCH = 250  # utterances per extract call: bounds host memory at full size


def features(n_utterances: int):
    """(phone corpus, phone-level gold, MFCCs [N, F, 13], frame_lens [N]) as
    scripts/run_pipeline.py makes them, in batches of BATCH utterances (each
    utterance's frames are independent of the others')."""
    phone_corpus, gold, _ = make_flickr8k_mini(n_utterances=n_utterances,
                                               n_phones=port.N_PHONES, seed=port.SEED)
    wavs, wav_lens, _ = phones_to_waveforms(phone_corpus, gold, seed=port.SEED)
    cfg = MfccConfig(n_mfcc=13, n_mels=26)
    feats, lens = [], []
    for lo in range(0, n_utterances, BATCH):
        f, fl = extract_pallas(jnp.asarray(wavs[lo:lo + BATCH]),
                               jnp.asarray(wav_lens[lo:lo + BATCH]), cfg, interpret=True)
        feats.append(np.asarray(f))
        lens.append(np.asarray(fl))
    return phone_corpus, gold, np.concatenate(feats), np.concatenate(lens)


def port_initial_params(feats: np.ndarray, frame_lens: np.ndarray, n_utterances: int) -> dict:
    """The port's initial parameters on these features, as numpy arrays."""
    phone_corpus, _, _ = torch_make(n_utterances=n_utterances, n_phones=port.N_PHONES,
                                    seed=port.SEED, device="cpu")
    corpus = port.frame_corpus(torch.as_tensor(feats), torch.as_tensor(frame_lens),
                               phone_corpus)
    p = port.init_params(corpus)
    return {f: getattr(p, f).numpy() for f in FIELDS} | {"max_jump": p.max_jump}


def fit_and_score(phone_corpus, gold, feats, frame_lens, iters: int, init: dict) -> dict:
    """EM from ``init``, decode, segmentation and the metrics of
    scripts/run_pipeline.py; also the alignment and the logliks."""
    frame_gold = expand_gold_to_frames(gold, np.asarray(phone_corpus.src_len), frame_lens)
    corpus = Corpus(src=jnp.asarray(feats), src_len=jnp.asarray(frame_lens),
                    trg=phone_corpus.trg, trg_len=phone_corpus.trg_len, src_vocab=0,
                    trg_vocab=phone_corpus.trg_vocab)
    params = hmm_gaussian.GaussianHMMParams(
        **{f: jnp.asarray(init[f]) for f in FIELDS}, max_jump=init["max_jump"])
    params, lls = jax.jit(lambda p: hmm_gaussian.train(p, corpus, iters))(params)
    alignment = jax.jit(hmm_gaussian.align)(params, corpus)
    gold_alignment = jnp.asarray(frame_gold.alignment[:, : corpus.max_src_len])
    pred_segs, pred_mask = segments_from_alignment(alignment, corpus.trg, corpus.src_len)
    gold_segs, gold_mask = segments_from_alignment(gold_alignment, corpus.trg, corpus.src_len)
    pb = boundaries_from_segments(pred_segs, pred_mask, corpus.max_src_len)
    gb = boundaries_from_segments(gold_segs, gold_mask, corpus.max_src_len)

    def floats(d):
        return {k: float(v) for k, v in d.items()}

    return {
        "alignment": floats(alignment_prf(alignment, gold_alignment, corpus.src_mask())),
        "word_iou": floats(word_iou(pred_segs, pred_mask, gold_segs, gold_mask)),
        "boundary": floats(boundary_prf(pb, gb, tolerance=port.BOUNDARY_TOLERANCE)),
        "purity": float(cluster_purity(pred_segs, pred_mask, gold_segs, gold_mask,
                                       corpus.trg_vocab)),
        "loglik": np.asarray(lls).tolist(),
        "path": np.asarray(alignment),
        "frame_gold": frame_gold,
    }


def reference(n_utterances: int, iters: int) -> dict:
    """Everything the comparison needs: the JAX features, the port's initial
    parameters on them, and the JAX run from those parameters."""
    phone_corpus, gold, feats, frame_lens = features(n_utterances)
    init = port_initial_params(feats, frame_lens, n_utterances)
    run = fit_and_score(phone_corpus, gold, feats, frame_lens, iters, init)
    return {"feats": feats, "frame_lens": frame_lens, "init": init, "run": run}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--utterances", type=int, default=2000)
    ap.add_argument("--iters", type=int, default=12)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    run = reference(args.utterances, args.iters)["run"]
    print(json.dumps({k: v for k, v in run.items() if k not in ("path", "frame_gold")},
                     indent=2))


if __name__ == "__main__":
    main()
