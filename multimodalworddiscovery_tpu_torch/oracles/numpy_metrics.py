"""Per-utterance NumPy oracles for segmentation + metrics + DTW.

Reference-style implementations: explicit Python loops over
utterances, segments, and boundary sets — the parity contract for the
vectorized on-device versions in ``eval/``.
"""

from __future__ import annotations

import numpy as np


def segments_from_alignment_np(alignment, trg, length) -> list[tuple[int, int, int]]:
    """Maximal same-assignment runs -> (start, end, concept) word units."""
    segs = []
    t = 0
    while t < length:
        a = alignment[t]
        s = t
        while t < length and alignment[t] == a:
            t += 1
        if a > 0:
            segs.append((s, t, int(trg[a - 1])))
    return segs


def alignment_prf_np(pred, gold, lengths) -> dict[str, float]:
    tp = n_pred = n_gold = 0
    for i, L in enumerate(lengths):
        for t in range(L):
            p, g = pred[i][t], gold[i][t]
            if p > 0:
                n_pred += 1
            if g > 0:
                n_gold += 1
            if p > 0 and p == g:
                tp += 1
    prec = tp / n_pred if n_pred else 0.0
    rec = tp / n_gold if n_gold else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    aer = 1.0 - (2 * tp / (n_pred + n_gold)) if (n_pred + n_gold) else 0.0
    return {"precision": prec, "recall": rec, "f1": f1, "aer": aer}


def _iou(a, b) -> float:
    inter = max(0, min(a[1], b[1]) - max(a[0], b[0]))
    union = (a[1] - a[0]) + (b[1] - b[0]) - inter
    return inter / union if union else 0.0


def word_iou_np(pred_segs, gold_segs, iou_threshold: float = 0.5) -> dict[str, float]:
    """pred_segs/gold_segs: per-utterance lists of (start, end, concept)."""
    best_ious, hit_gold, hit_pred, n_pred, n_gold = [], 0, 0, 0, 0
    for ps, gs in zip(pred_segs, gold_segs):
        n_pred += len(ps)
        n_gold += len(gs)
        for g in gs:
            cands = [_iou(p, g) for p in ps if p[2] == g[2]]
            best = max(cands, default=0.0)
            best_ious.append(best)
            if best >= iou_threshold:
                hit_gold += 1
        for p in ps:
            cands = [_iou(p, g) for g in gs if g[2] == p[2]]
            if max(cands, default=0.0) >= iou_threshold:
                hit_pred += 1
    mean_iou = float(np.mean(best_ious)) if best_ious else 0.0
    prec = hit_pred / n_pred if n_pred else 0.0
    rec = hit_gold / n_gold if n_gold else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"mean_iou": mean_iou, "precision": prec, "recall": rec, "f1": f1}


def boundary_prf_np(pred_segs, gold_segs, lengths, tolerance: int = 0) -> dict[str, float]:
    tp_p = tp_g = n_pred = n_gold = 0
    for i, _L in enumerate(lengths):
        pb = sorted({b for s in pred_segs[i] for b in (s[0], s[1])})
        gb = sorted({b for s in gold_segs[i] for b in (s[0], s[1])})
        n_pred += len(pb)
        n_gold += len(gb)
        for b in pb:
            if any(abs(b - g) <= tolerance for g in gb):
                tp_p += 1
        for g in gb:
            if any(abs(g - b) <= tolerance for b in pb):
                tp_g += 1
    prec = tp_p / n_pred if n_pred else 0.0
    rec = tp_g / n_gold if n_gold else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"precision": prec, "recall": rec, "f1": f1}


def _best_gold_class(p, gs) -> int:
    """Gold class of the max-IoU gold segment; FIRST segment wins ties —
    matching the device side's jnp.argmax first-occurrence semantics
    (a max() over (iou, class) tuples would break ties toward the LARGEST
    class id and diverge from purity_counts on tied overlaps)."""
    best_iou, gold_class = 0.0, 0
    for g in gs:
        i = _iou(p, g)
        if i > best_iou:
            best_iou, gold_class = i, g[2]
    return gold_class if best_iou > 0 else 0


def cluster_purity_np(pred_segs, gold_segs, n_concepts: int) -> float:
    counts = np.zeros((n_concepts, n_concepts))
    for ps, gs in zip(pred_segs, gold_segs):
        for p in ps:
            counts[p[2], _best_gold_class(p, gs)] += 1
    total = counts.sum()
    return float(counts.max(axis=1).sum() / total) if total else 0.0


def cluster_nmi_np(pred_segs, gold_segs, n_concepts: int) -> float:
    """NMI = 2 I(C;G) / (H(C)+H(G)) over the same contingency matrix as
    purity (float64, explicit loops — the parity oracle)."""
    counts = np.zeros((n_concepts, n_concepts))
    for ps, gs in zip(pred_segs, gold_segs):
        for p in ps:
            counts[p[2], _best_gold_class(p, gs)] += 1
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts / total
    pc = p.sum(axis=1)
    pg = p.sum(axis=0)
    mi = 0.0
    for i in range(n_concepts):
        for j in range(n_concepts):
            if p[i, j] > 0:
                mi += p[i, j] * np.log(p[i, j] / (pc[i] * pg[j]))
    hc = -sum(x * np.log(x) for x in pc if x > 0)
    hg = -sum(x * np.log(x) for x in pg if x > 0)
    return float(2 * mi / (hc + hg)) if hc + hg > 0 else 0.0


def dtw_np(x, y, metric: str = "sqeuclidean") -> float:
    """Classic O(T1*T2) DTW DP, one pair."""
    if metric == "sqeuclidean":
        cost = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    elif metric == "euclidean":
        cost = np.sqrt(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1) + 1e-12)
    elif metric == "cosine":
        xn = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
        yn = y / np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), 1e-12)
        cost = 1.0 - xn @ yn.T
    else:
        raise ValueError(metric)
    t1, t2 = cost.shape
    D = np.full((t1 + 1, t2 + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, t1 + 1):
        for j in range(1, t2 + 1):
            D[i, j] = cost[i - 1, j - 1] + min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return float(D[t1, t2])
