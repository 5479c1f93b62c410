"""Pretrained embedding frontends (HuBERT speech, CLIP regions) from local
checkpoints.

Counterpart of ``multimodalworddiscovery_tpu/frontend/pretrained.py``,
which already runs these torch models from ``transformers``: the same code,
with a ``device`` for the models and their inputs.  ``transformers`` is
imported only when an extractor runs, and only local checkpoint
directories are read (``from_pretrained`` on a path; nothing is
downloaded).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def checkpoint_available(path: str | Path) -> bool:
    p = Path(path)
    return p.is_dir() and (any(p.glob("*.safetensors")) or any(p.glob("*.bin")))


def extract_hubert(
    wavs: list[np.ndarray], checkpoint_dir: str | Path, layer: int = 9, device="cuda"
) -> list[np.ndarray]:
    """Raw 16 kHz waveforms -> per-utterance HuBERT hidden states [T_i, D]
    of ``layer``, from a local checkpoint directory (config.json and
    weights), run on ``device``."""
    from transformers import HubertModel

    model = HubertModel.from_pretrained(str(checkpoint_dir)).to(device)
    model.eval()
    out = []
    with torch.no_grad():
        for w in wavs:
            x = torch.from_numpy(np.asarray(w, np.float32))[None].to(device)
            h = model(x, output_hidden_states=True).hidden_states[layer]
            out.append(h[0].cpu().numpy())
    return out


def extract_clip_regions(
    image: np.ndarray, boxes: np.ndarray, checkpoint_dir: str | Path, device="cuda"
) -> np.ndarray:
    """[H, W, 3] image + [B, 4] normalized boxes -> [B, D] CLIP image
    embeddings, from a local checkpoint directory, run on ``device``.  The
    crops are cut and resized on the host by CLIP's image processor."""
    from transformers import CLIPImageProcessor, CLIPModel

    model = CLIPModel.from_pretrained(str(checkpoint_dir)).to(device)
    proc = CLIPImageProcessor.from_pretrained(str(checkpoint_dir))
    model.eval()
    h, w = image.shape[:2]
    crops = []
    for y1, x1, y2, x2 in np.asarray(boxes, np.float32):
        ys, ye = int(y1 * h), max(int(y2 * h), int(y1 * h) + 1)
        xs, xe = int(x1 * w), max(int(x2 * w), int(x1 * w) + 1)
        crops.append(image[ys:ye, xs:xe])
    inputs = {k: v.to(device) for k, v in proc(images=crops, return_tensors="pt").items()}
    with torch.no_grad():
        emb = model.get_image_features(**inputs)
    return emb.cpu().numpy()
