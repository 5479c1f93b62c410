"""Train the learned region-proposal detector and report its recall.

Counterpart of ``scripts/train_detector.py``: the anchor-based RPN
(``frontend/detector.py``) trained full-batch on the synthetic boxes corpus
(``make_boxes_mini``, seed 0), its recall@0.5 on those images and on 64
held-out ones (seed 7), and its proposals cropped for the region-embedding
path (``frontend/image.crop_and_resize``).

    python -m multimodalworddiscovery_tpu_torch.scripts.train_detector \\
        [--images 256] [--size 64] [--steps 400] [--lr 1e-3] [--proposals 16] \\
        [--device cuda]

The device is "cuda" unless ``--device`` names another.  Prints the
reference's JSON keys.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from multimodalworddiscovery_tpu_torch.data import make_boxes_mini
from multimodalworddiscovery_tpu_torch.frontend import detector, image

# scripts/train_detector.py's defaults
DEFAULTS = dict(n_images=256, image_size=64, steps=400, lr=1e-3, proposals=16)
HELD_OUT = dict(n_images=64, seed=7)
CROP = 32
SEED = 0  # CPU generator seed of the initial weights


def run_train_detector(
    n_images: int = DEFAULTS["n_images"],
    image_size: int = DEFAULTS["image_size"],
    steps: int = DEFAULTS["steps"],
    lr: float = DEFAULTS["lr"],
    proposals: int = DEFAULTS["proposals"],
    device="cuda",
) -> dict:
    """Train and evaluate on ``device`` -> the reference's JSON record, with
    the loss history (every 50th step and the last) under "loss_history"."""
    dev = torch.device(device)
    cfg = detector.DetectorConfig(image_size=image_size)
    images, boxes, mask = make_boxes_mini(n_images=n_images, image_size=image_size, seed=0)
    imgs = torch.as_tensor(images, device=dev)
    t0 = time.perf_counter()
    model, hist = detector.train(cfg, imgs, torch.as_tensor(boxes, device=dev),
                                 torch.as_tensor(mask, device=dev), num_steps=steps,
                                 learning_rate=lr, generator=torch.Generator().manual_seed(SEED))
    train_s = time.perf_counter() - t0  # the history's last read waited for the device
    anchors = torch.as_tensor(cfg.anchors(), device=dev)

    pb, _, pk = detector.propose(model, anchors, imgs, k=proposals)
    rec_train = detector.detection_recall(pb.cpu().numpy(), pk.cpu().numpy(), boxes, mask)
    im2, b2, m2 = make_boxes_mini(image_size=image_size, **HELD_OUT)
    pb2, _, pk2 = detector.propose(model, anchors, torch.as_tensor(im2, device=dev),
                                   k=proposals)
    rec_held = detector.detection_recall(pb2.cpu().numpy(), pk2.cpu().numpy(), b2, m2)
    # proposals -> region crops (the detector -> region-embedding handoff)
    crops = image.crop_and_resize(torch.as_tensor(im2[0], device=dev), pb2[0], size=CROP)
    return {
        "train_seconds": round(train_s, 1),
        "final_loss": round(hist[-1]["loss"], 5),
        "recall_at_0.5_train": round(rec_train, 3),
        "recall_at_0.5_heldout": round(rec_held, 3),
        "kept_per_image": round(float(pk2.cpu().numpy().sum(1).mean()), 2),
        "region_crops_shape": list(crops.shape),
        "loss_history": [h["loss"] for h in hist],
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=DEFAULTS["n_images"])
    ap.add_argument("--size", type=int, default=DEFAULTS["image_size"])
    ap.add_argument("--steps", type=int, default=DEFAULTS["steps"])
    ap.add_argument("--lr", type=float, default=DEFAULTS["lr"])
    ap.add_argument("--proposals", type=int, default=DEFAULTS["proposals"])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False  # convolutions in full float32
    rec = run_train_detector(args.images, args.size, args.steps, args.lr, args.proposals,
                             device=args.device)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
