"""End-to-end image pipeline on the port: detector proposals -> region crops
-> grounding.

Counterpart of ``scripts/image_pipeline.py``: the reference's image branch
with the learned box source (``frontend/detector.py``) and no annotation
boxes at alignment time:

  1. render images for a synthetic paired corpus (one colored rectangle per
     concept, ``data.synthetic.images_for_corpus``);
  2. train the RPN detector on the rendered boxes (full batch);
  3. propose boxes on every image, crop and resize each proposal
     (``frontend/image.crop_and_resize``), flatten to region features, and
     compact the kept proposals to a prefix;
  4. train the audio-visual grounding aligner (``models/grounding.py``) on
     (phone captions, detected-region features);
  5. evaluate: alignment accuracy by IoU-matching proposals to gold boxes,
     and caption <-> image retrieval recall@k.

    python -m multimodalworddiscovery_tpu_torch.scripts.image_pipeline \\
        [--utterances 400] [--det-steps 300] [--align-iters 300] [--device cuda]

The device is "cuda" unless ``--device`` names another.  Prints the
reference's JSON keys.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.data import (
    Corpus,
    images_for_corpus,
    make_flickr8k_mini,
)
from multimodalworddiscovery_tpu_torch.eval.retrieval import recall_at_k
from multimodalworddiscovery_tpu_torch.frontend import detector, image
from multimodalworddiscovery_tpu_torch.models import grounding
from multimodalworddiscovery_tpu_torch.scripts.run_pipeline import Clock

# scripts/image_pipeline.py's defaults
DEFAULTS = dict(n_utterances=400, n_concepts=12, image_size=64, det_steps=300,
                align_iters=300, proposals=8, crop=16)
GROUNDING_DIM = 64
DET_LR = 1e-3
DET_SEED, GROUNDING_SEED = 0, 1  # CPU generator seeds of the initial weights
NULL_THRESHOLD = -2.0  # the IoU-matched metric scores region choice only
MATCH_IOU = 0.5


def paired_corpus(n_utterances: int, n_concepts: int, image_size: int, device="cuda"):
    """(phone corpus on ``device``, gold, images, gt boxes, gt mask, gt
    positions) of the pipeline: the numpy generators at seed 0."""
    corpus, gold, _ = make_flickr8k_mini(n_utterances=n_utterances, n_concepts=n_concepts,
                                         min_concepts=2, max_concepts=4, seed=0, device=device)
    images, gt_boxes, gt_mask, gt_pos = images_for_corpus(corpus, image_size=image_size, seed=0)
    return corpus, gold, images, gt_boxes, gt_mask, gt_pos


def region_features(images: torch.Tensor, boxes: torch.Tensor, crop: int) -> torch.Tensor:
    """[N, K, crop * crop * 3]: each proposal cropped and resized, flattened."""
    return torch.stack([image.crop_and_resize(img, bx, size=crop).reshape(bx.shape[0], -1)
                        for img, bx in zip(images, boxes)])


def compact(feats: np.ndarray, keep: np.ndarray):
    """Kept proposals moved to a prefix (a corpus holds prefix lengths):
    (trg features [N, K, D], slot -> proposal index [N, K] (-1 empty),
    kept count [N])."""
    n, k = keep.shape
    trg_feats = np.zeros((n, k, feats.shape[-1]), np.float32)
    slot_to_prop = np.full((n, k), -1, np.int32)
    trg_len = keep.sum(axis=1).astype(np.int32)
    for i in range(n):
        props = np.nonzero(keep[i])[0]
        trg_feats[i, : len(props)] = feats[i, props]
        slot_to_prop[i, : len(props)] = props
    return trg_feats, slot_to_prop, trg_len


def slot_gold_positions(boxes: np.ndarray, slot_to_prop, trg_len, gt_boxes, gt_mask, gt_pos):
    """[N, K + 1]: for each 1-based slot, the 1-based gold trg position of
    the gold box its proposal overlaps most at IoU >= 0.5 (0 otherwise)."""
    n, k = slot_to_prop.shape
    out = np.zeros((n, k + 1), np.int32)
    for i in range(n):
        gm = gt_mask[i].astype(bool)
        if not gm.any():
            continue
        for s_ in range(trg_len[i]):
            p = slot_to_prop[i, s_]
            ious = detector.iou_matrix(boxes[i, p : p + 1], gt_boxes[i][gm])[0]
            j = int(np.argmax(ious))
            if ious[j] >= MATCH_IOU:
                out[i, s_ + 1] = gt_pos[i][gm][j]
    return out


def regions_corpus(data, boxes: np.ndarray, keep: np.ndarray, crop: int = DEFAULTS["crop"],
                   device="cuda"):
    """(speech-to-regions corpus, slot -> proposal index, kept count) of
    the corpus ``data`` (``paired_corpus``'s tuple) and given proposals
    (host arrays: boxes [N, k, 4], keep [N, k]): the phone captions against
    their images' cropped proposals, kept ones first."""
    dev = torch.device(device)
    corpus, _, images = data[:3]
    feats = region_features(torch.as_tensor(images, device=dev),
                            torch.as_tensor(boxes, device=dev), crop).cpu().numpy()
    trg_feats, slot_to_prop, trg_len = compact(feats, keep)
    region_corpus = Corpus(
        src=corpus.src, src_len=corpus.src_len,
        trg=torch.as_tensor(trg_feats, device=dev),
        trg_len=torch.as_tensor(np.maximum(trg_len, 1), device=dev),
        src_vocab=corpus.src_vocab, trg_vocab=0,
    )
    return region_corpus, slot_to_prop, trg_len


def score_proposals(data, boxes: np.ndarray, keep: np.ndarray,
                    align_iters: int = DEFAULTS["align_iters"], crop: int = DEFAULTS["crop"],
                    device="cuda", clock: Clock | None = None) -> dict:
    """Steps 3-5 from given proposals (host arrays: boxes [N, k, 4], keep
    [N, k]) of the corpus ``data`` (``paired_corpus``'s tuple): crops,
    compaction, grounding, evaluation -> the record's alignment and
    retrieval keys, and the grounding loss of every step
    ("grounding_loss")."""
    dev = torch.device(device)
    clock = clock or Clock(dev)
    corpus, gold, _, gt_boxes, gt_mask, gt_pos = data
    region_corpus, slot_to_prop, trg_len = regions_corpus(data, boxes, keep, crop, dev)
    clock.lap("crop")
    state = grounding.init(region_corpus, dim=GROUNDING_DIM,
                           generator=torch.Generator().manual_seed(GROUNDING_SEED))
    state, lls = grounding.train(state, region_corpus, align_iters)
    clock.lap("grounding_train")

    slot_to_goldpos = slot_gold_positions(boxes, slot_to_prop, trg_len, gt_boxes, gt_mask,
                                          gt_pos)
    pred_slots = grounding.align(state, region_corpus, null_threshold=NULL_THRESHOLD)
    pred = np.take_along_axis(slot_to_goldpos, pred_slots.cpu().numpy(), axis=1)
    mask = corpus.src_mask().cpu().numpy() & (gold.alignment > 0)
    align_acc = float((pred == gold.alignment)[mask].mean())
    scores = grounding.retrieval_scores(state, region_corpus)
    rec = {k: round(float(v), 3) for k, v in recall_at_k(scores, ks=(1, 5, 10)).items()}
    clock.lap("evaluate")
    return {"proposals_per_image": round(float(trg_len.mean()), 2),
            "alignment_acc": round(align_acc, 3), **rec,
            "grounding_loss": (-lls).tolist()}


def run_image_pipeline(
    n_utterances: int = DEFAULTS["n_utterances"],
    n_concepts: int = DEFAULTS["n_concepts"],
    image_size: int = DEFAULTS["image_size"],
    det_steps: int = DEFAULTS["det_steps"],
    align_iters: int = DEFAULTS["align_iters"],
    proposals: int = DEFAULTS["proposals"],
    crop: int = DEFAULTS["crop"],
    device="cuda",
) -> dict:
    """The pipeline on ``device`` -> the reference's JSON record, with the
    stage times (ms, host clock after a synchronize) under "stage_ms"."""
    dev = torch.device(device)
    clock = Clock(dev)
    t_all = time.perf_counter()
    data = paired_corpus(n_utterances, n_concepts, image_size, dev)
    corpus, _, images, gt_boxes, gt_mask, _ = data
    imgs = torch.as_tensor(images, device=dev)
    clock.lap("data")

    dcfg = detector.DetectorConfig(image_size=image_size)
    model, _ = detector.train(dcfg, imgs, torch.as_tensor(gt_boxes, device=dev),
                              torch.as_tensor(gt_mask, device=dev), num_steps=det_steps,
                              learning_rate=DET_LR,
                              generator=torch.Generator().manual_seed(DET_SEED))
    clock.lap("detector_train")
    anchors = torch.as_tensor(dcfg.anchors(), device=dev)
    pb, _, pk = detector.propose(model, anchors, imgs, k=proposals)
    pb, keep = pb.cpu().numpy(), pk.cpu().numpy()
    det_recall = detector.detection_recall(pb, keep, gt_boxes, gt_mask)
    clock.lap("propose")
    rec = score_proposals(data, pb, keep, align_iters, crop, dev, clock)
    del rec["grounding_loss"]
    return {
        "n": corpus.n,
        "detector_recall@0.5": round(det_recall, 3),
        **rec,
        "total_seconds": round(time.perf_counter() - t_all, 1),
        "stage_ms": clock.ms,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--utterances", type=int, default=DEFAULTS["n_utterances"])
    ap.add_argument("--concepts", type=int, default=DEFAULTS["n_concepts"])
    ap.add_argument("--size", type=int, default=DEFAULTS["image_size"])
    ap.add_argument("--det-steps", type=int, default=DEFAULTS["det_steps"])
    ap.add_argument("--align-iters", type=int, default=DEFAULTS["align_iters"])
    ap.add_argument("--proposals", type=int, default=DEFAULTS["proposals"])
    ap.add_argument("--crop", type=int, default=DEFAULTS["crop"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    # products and convolutions in full float32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(run_image_pipeline(
        args.utterances, args.concepts, args.size, args.det_steps, args.align_iters,
        args.proposals, args.crop, device=args.device)))


if __name__ == "__main__":
    main()
