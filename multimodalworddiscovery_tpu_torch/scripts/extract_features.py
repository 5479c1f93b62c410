"""Feature-extraction script (counterpart of ``scripts/extract_features.py``).

speech: .npz of raw waveforms (keys arr_0..arr_N, float32 [L_i]) ->
        .npz of MFCC / fbank features (arr_i [F_i, D]) through K5.
image:  .npz of images (arr_i [H, W, 3]) + boxes JSON ({"arr_i": [[y1, x1,
        y2, x2], ...]}, normalized) -> .npz of VGG16 region embeddings
        [B_i, 4096] for the images with boxes, whole-image concept
        posteriors [1000] (after a bilinear resize to 224 x 224) for the rest.

    python -m multimodalworddiscovery_tpu_torch.scripts.extract_features speech \\
        --input wavs.npz --output feats.npz [--batch-size 256] [--device cuda]
    python -m multimodalworddiscovery_tpu_torch.scripts.extract_features image \\
        --input imgs.npz --boxes boxes.json --output regions.npz \\
        [--weights vgg16_torch.pt] [--device cuda]

The device is "cuda" unless ``--device`` names another ("cpu" runs the
kernel's plain version).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.frontend import image, speech
from multimodalworddiscovery_tpu_torch.ops import mfcc as mfcc_ops


def cmd_speech(args) -> None:
    with np.load(args.input) as z:
        keys = sorted(z.files, key=lambda k: int(k.split("_")[-1]))
        wavs = [z[k].astype(np.float32) for k in keys]
    n = len(wavs)
    if n == 0:
        raise SystemExit(f"{args.input} holds no waveforms")
    if args.batch_size < 0:
        raise SystemExit(f"--batch-size must be >= 0, got {args.batch_size}")
    max_len = max(len(w) for w in wavs)
    cfg = speech.MfccConfig(n_mfcc=args.n_mfcc, n_mels=args.n_mels)
    dev = torch.device(args.device)
    b = args.batch_size or n
    # fixed-size batches padded to the global max length: device memory is
    # O(batch) and every batch has one shape
    out: dict[str, np.ndarray] = {}
    for lo in range(0, n, b):
        hi = min(lo + b, n)
        wb = np.zeros((b, max_len), np.float32)
        lb = np.zeros((b,), np.int32)
        for i in range(lo, hi):
            wb[i - lo, : len(wavs[i])] = wavs[i]
            lb[i - lo] = len(wavs[i])
        feats, flens = mfcc_ops.extract(torch.as_tensor(wb, device=dev),
                                        torch.as_tensor(lb, device=dev), cfg, kind=args.kind)
        if args.deltas:
            feats = speech.add_deltas(feats, flens)
        if args.cmvn:
            feats = speech.cmvn(feats, flens)
        feats, flens = feats.cpu().numpy(), flens.cpu().numpy()
        for i in range(hi - lo):
            out[f"arr_{lo + i}"] = feats[i, : flens[i]]
    np.savez(args.output, **out)
    dim = next(iter(out.values())).shape[-1]
    print(f"wrote {args.output}: {n} utterances, dim {dim}"
          + (f" ({-(-n // b)} batches of {b})" if args.batch_size else ""))


def cmd_image(args) -> None:
    dev = torch.device(args.device)
    if args.weights:
        model = image.load_torch_weights(args.weights, device=dev)
        print(f"loaded torchvision weights from {args.weights}")
    else:
        model = image.init_vgg16(device=dev)
        print("WARNING: random-init VGG16 (no --weights given); embeddings are "
              "untrained — use precomputed features for real experiments")
    with np.load(args.input) as z:
        imgs = {k: z[k] for k in z.files}
    boxes = {}
    if args.boxes:
        with open(args.boxes) as f:
            boxes = json.load(f)
    size = model.input_size
    out = {}
    for k, img in imgs.items():
        x = torch.as_tensor(img.astype(np.float32), device=dev)
        if boxes.get(k):
            b = torch.as_tensor(np.asarray(boxes[k], np.float32), device=dev)
            out[k] = image.region_embeddings(model, x, b).cpu().numpy()
        else:
            probs = image.image_concepts(model, image.resize(x, size, size)[None])
            out[k] = probs[0].cpu().numpy()
    np.savez(args.output, **out)
    print(f"wrote {args.output}: {len(out)} images")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("speech")
    s.add_argument("--input", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--kind", choices=list(speech.KINDS), default="mfcc")
    s.add_argument("--n-mfcc", type=int, default=13)
    s.add_argument("--n-mels", type=int, default=26)
    s.add_argument("--deltas", action="store_true")
    s.add_argument("--cmvn", action="store_true")
    s.add_argument("--batch-size", type=int, default=0,
                   help="utterances per device call (0 = the whole corpus at once); "
                        "bounds device memory")
    s.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain version)")
    s.set_defaults(fn=cmd_speech)

    i = sub.add_parser("image")
    i.add_argument("--input", required=True)
    i.add_argument("--boxes", default=None)
    i.add_argument("--output", required=True)
    i.add_argument("--weights", default=None,
                   help="a torchvision VGG16 state dict on disk (default: random init)")
    i.add_argument("--device", default="cuda", help="torch device (default cuda)")
    i.set_defaults(fn=cmd_image)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
