"""Float64 NumPy oracle for the region-proposal detector geometry.

Every algorithm gets a per-example float64 NumPy reimplementation as the
parity reference for the batched path.  This covers the detector's
pure-geometry pieces — pairwise IoU, box encode/decode, and greedy NMS —
mirroring ``frontend/detector.py``'s reference-style per-box loops (the
batched versions are vectorized; the conv net itself has no oracle).
"""

from __future__ import annotations

import numpy as np

_MAX_DSIZE = 4.0


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, per-pair loop in float64.  a [Na, 4], b [Nb, 4]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    out = np.zeros((len(a), len(b)))
    for i, (ay1, ax1, ay2, ax2) in enumerate(a):
        for j, (by1, bx1, by2, bx2) in enumerate(b):
            ih = max(min(ay2, by2) - max(ay1, by1), 0.0)
            iw = max(min(ax2, bx2) - max(ax1, bx1), 0.0)
            inter = ih * iw
            area_a = max(ay2 - ay1, 0.0) * max(ax2 - ax1, 0.0)
            area_b = max(by2 - by1, 0.0) * max(bx2 - bx1, 0.0)
            out[i, j] = inter / max(area_a + area_b - inter, 1e-12)
    return out


def _centers(boxes: np.ndarray):
    y1, x1, y2, x2 = boxes.T
    return (y1 + y2) / 2, (x1 + x2) / 2, y2 - y1, x2 - x1


def decode_boxes(anchors: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    anchors = np.asarray(anchors, np.float64)
    deltas = np.asarray(deltas, np.float64)
    acy, acx, ah, aw = _centers(anchors)
    dy, dx, dh, dw = deltas.T
    cy = acy + dy * ah
    cx = acx + dx * aw
    h = ah * np.exp(np.clip(dh, -_MAX_DSIZE, _MAX_DSIZE))
    w = aw * np.exp(np.clip(dw, -_MAX_DSIZE, _MAX_DSIZE))
    out = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], axis=-1)
    return np.clip(out, 0.0, 1.0)


def encode_boxes(anchors: np.ndarray, gt: np.ndarray) -> np.ndarray:
    anchors = np.asarray(anchors, np.float64)
    gt = np.asarray(gt, np.float64)
    acy, acx, ah, aw = _centers(anchors)
    gcy, gcx, gh, gw = _centers(gt)
    eps = 1e-8
    return np.stack(
        [
            (gcy - acy) / (ah + eps),
            (gcx - acx) / (aw + eps),
            np.log((gh + eps) / (ah + eps)),
            np.log((gw + eps) / (aw + eps)),
        ],
        axis=-1,
    )


def greedy_nms(
    boxes: np.ndarray,
    scores: np.ndarray,
    iou_thresh: float = 0.5,
    score_thresh: float = 0.0,
) -> list[int]:
    """Classic greedy NMS: visit boxes score-descending, keep a box iff no
    higher-scored kept box overlaps it above ``iou_thresh``.  Returns kept
    indices into the input arrays (score order)."""
    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    kept: list[int] = []
    for i in order:
        if scores[i] <= score_thresh:
            continue
        ok = True
        for j in kept:
            if iou_matrix(boxes[i : i + 1], boxes[j : j + 1])[0, 0] > iou_thresh:
                ok = False
                break
        if ok:
            kept.append(int(i))
    return kept
