"""On-device alignment and segmentation metrics.

Counterpart of ``multimodalworddiscovery_tpu/eval/metrics.py``: alignment
P/R/F1 + AER, word IoU and word-discovery P/R/F1, boundary P/R/F1, and
cluster purity and NMI.  Every metric is a masked tensor computation over
the whole corpus; only the final scalars leave the device.  Each family's
``*_stats`` / ``*_counts`` are additive across corpus shards.

Conventions:
  alignment arrays [N, Ts]: 0 = NULL, j >= 1 = 1-based trg position.
  segment arrays   [N, S, 3]: (start, end_exclusive, concept_id) + bool mask.
"""

from __future__ import annotations

import torch


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(b > 0, a / torch.clamp(b, min=1), 0.0)


def _f1(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.where(p + r > 0, 2 * p * r / torch.clamp(p + r, min=1e-12), 0.0)


def _prf(
    tp: torch.Tensor, n_pred: torch.Tensor, n_gold: torch.Tensor
) -> dict[str, torch.Tensor]:
    p = _safe_div(tp, n_pred)
    r = _safe_div(tp, n_gold)
    return {"precision": p, "recall": r, "f1": _f1(p, r)}


def alignment_stats(
    pred: torch.Tensor, gold: torch.Tensor, src_mask: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Additive sufficient statistics of ``alignment_prf`` (summable across
    corpus shards)."""
    pred = torch.where(src_mask, pred, 0)
    gold = torch.where(src_mask, gold, 0)
    f32 = torch.float32
    return {
        "tp": ((pred == gold) & (gold > 0) & (pred > 0)).sum().to(f32),
        "n_pred": (pred > 0).sum().to(f32),
        "n_gold": (gold > 0).sum().to(f32),
    }


def alignment_from_stats(s: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    out = _prf(s["tp"], s["n_pred"], s["n_gold"])
    out["aer"] = 1.0 - _safe_div(2.0 * s["tp"], s["n_pred"] + s["n_gold"])
    return out


def alignment_prf(
    pred: torch.Tensor, gold: torch.Tensor, src_mask: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Alignment-link precision/recall/F1 (+ alignment error rate).

    A link is a (source position, target position) pair with target != NULL;
    an alignment assigns at most one target per source position, so the set
    intersection is positionwise equality on non-NULL entries.
    """
    return alignment_from_stats(alignment_stats(pred, gold, src_mask))


def _segment_iou_matrix(
    pred_segs: torch.Tensor, pred_mask: torch.Tensor,
    gold_segs: torch.Tensor, gold_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairwise interval IoU [N, Sp, Sg] + joint validity mask."""
    ps, pe = pred_segs[..., 0], pred_segs[..., 1]  # [N, Sp]
    gs, ge = gold_segs[..., 0], gold_segs[..., 1]  # [N, Sg]
    inter = torch.clamp(
        torch.minimum(pe[:, :, None], ge[:, None, :])
        - torch.maximum(ps[:, :, None], gs[:, None, :]),
        min=0,
    ).float()
    union = ((pe - ps)[:, :, None] + (ge - gs)[:, None, :]).float() - inter
    iou = _safe_div(inter, union)
    mask = pred_mask[:, :, None] & gold_mask[:, None, :]
    return torch.where(mask, iou, 0.0), mask


def word_iou_stats(
    pred_segs: torch.Tensor,
    pred_mask: torch.Tensor,
    gold_segs: torch.Tensor,
    gold_mask: torch.Tensor,
    iou_threshold: float = 0.5,
) -> dict[str, torch.Tensor]:
    """Additive sufficient statistics of ``word_iou`` (matching is within
    each utterance, so every count sums across shards)."""
    iou, mask = _segment_iou_matrix(pred_segs, pred_mask, gold_segs, gold_mask)
    same = (pred_segs[..., 2][:, :, None] == gold_segs[..., 2][:, None, :]) & mask
    iou_c = torch.where(same, iou, 0.0)
    best_per_gold = iou_c.amax(dim=1)  # [N, Sg]
    best_per_pred = iou_c.amax(dim=2)  # [N, Sp]
    f32 = torch.float32
    return {
        "sum_best_iou": torch.where(gold_mask, best_per_gold, 0.0).sum().to(f32),
        "hit_gold": ((best_per_gold >= iou_threshold) & gold_mask).sum().to(f32),
        "hit_pred": ((best_per_pred >= iou_threshold) & pred_mask).sum().to(f32),
        "n_gold": gold_mask.sum().to(f32),
        "n_pred": pred_mask.sum().to(f32),
    }


def word_iou_from_stats(s: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    p = _safe_div(s["hit_pred"], s["n_pred"])
    r = _safe_div(s["hit_gold"], s["n_gold"])
    return {
        "mean_iou": _safe_div(s["sum_best_iou"], s["n_gold"]),
        "precision": p,
        "recall": r,
        "f1": _f1(p, r),
    }


def word_iou(
    pred_segs: torch.Tensor,
    pred_mask: torch.Tensor,
    gold_segs: torch.Tensor,
    gold_mask: torch.Tensor,
    iou_threshold: float = 0.5,
) -> dict[str, torch.Tensor]:
    """Word IoU + word-discovery P/R/F1 at an IoU threshold.

    mean_iou: for each gold unit, the best IoU among predicted units with
    the SAME concept label, averaged over gold units.  A unit matches if its
    best same-concept IoU reaches the threshold (both sides).
    """
    return word_iou_from_stats(
        word_iou_stats(pred_segs, pred_mask, gold_segs, gold_mask, iou_threshold)
    )


def _shift(b: torch.Tensor, d: int) -> torch.Tensor:
    """Zero-padded shift along positions (a roll would wrap around)."""
    pad = torch.zeros((b.shape[0], abs(d)), dtype=b.dtype, device=b.device)
    if d > 0:
        return torch.cat([pad, b[:, :-d]], dim=1)
    return torch.cat([b[:, -d:], pad], dim=1)


def boundary_stats(
    pred_bounds: torch.Tensor, gold_bounds: torch.Tensor, tolerance: int = 0
) -> dict[str, torch.Tensor]:
    """Additive sufficient statistics of ``boundary_prf`` ([N, L+1] bools;
    matching is within each utterance)."""
    def dilate(b: torch.Tensor) -> torch.Tensor:
        out = b
        for d in range(1, tolerance + 1):
            out = out | _shift(b, d) | _shift(b, -d)
        return out

    gold_d, pred_d = dilate(gold_bounds), dilate(pred_bounds)
    f32 = torch.float32
    return {
        "tp_p": (pred_bounds & gold_d).sum().to(f32),
        "tp_g": (gold_bounds & pred_d).sum().to(f32),
        "n_pred": pred_bounds.sum().to(f32),
        "n_gold": gold_bounds.sum().to(f32),
    }


def boundary_from_stats(s: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    p = _safe_div(s["tp_p"], s["n_pred"])
    r = _safe_div(s["tp_g"], s["n_gold"])
    return {"precision": p, "recall": r, "f1": _f1(p, r)}


def boundary_prf(
    pred_bounds: torch.Tensor, gold_bounds: torch.Tensor, tolerance: int = 0
) -> dict[str, torch.Tensor]:
    """Boundary precision/recall/F1 with +-tolerance positions: a predicted
    boundary counts if a gold one lies within ``tolerance``; recall is
    symmetric."""
    return boundary_from_stats(boundary_stats(pred_bounds, gold_bounds, tolerance))


def purity_counts(
    pred_segs: torch.Tensor,
    pred_mask: torch.Tensor,
    gold_segs: torch.Tensor,
    gold_mask: torch.Tensor,
    n_concepts: int,
) -> torch.Tensor:
    """The [C, C] (cluster, gold-class) contingency matrix behind purity and
    NMI.  A predicted unit's cluster is its concept label; its gold class is
    the concept of the max-overlap gold unit (0 if none)."""
    iou, mask = _segment_iou_matrix(pred_segs, pred_mask, gold_segs, gold_mask)
    has_overlap = (mask & (iou > 0)).any(dim=2)  # [N, Sp]
    best_gold = torch.argmax(torch.where(mask, iou, -1.0), dim=2)  # [N, Sp]
    gold_class = gold_segs[..., 2].gather(1, best_gold)
    gold_class = torch.where(has_overlap & pred_mask, gold_class, 0)
    cluster = torch.where(pred_mask, pred_segs[..., 2], 0)
    pair = (cluster.long() * n_concepts + gold_class.long()).reshape(-1)
    counts = torch.zeros(n_concepts * n_concepts, device=pred_segs.device)
    counts.index_add_(0, pair, pred_mask.reshape(-1).float())
    counts = counts.reshape(n_concepts, n_concepts)
    counts[0, :] = 0.0  # drop masked slots bucketed at cluster 0
    return counts


def purity_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """Purity from a (cluster, gold-class) contingency matrix."""
    return _safe_div(counts.amax(dim=1).sum(), counts.sum())


def nmi_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """2 I(C;G) / (H(C) + H(G)) from a (cluster, gold-class) contingency
    matrix."""
    total = torch.clamp(counts.sum(), min=1.0)
    p = counts / total  # joint
    pc = p.sum(dim=1, keepdim=True)  # cluster marginal
    pg = p.sum(dim=0, keepdim=True)  # gold-class marginal

    def xlogy(x, y):
        return torch.where(x > 0, x * torch.log(torch.clamp(y, min=1e-30)), 0.0)

    mi = xlogy(p, p / torch.clamp(pc * pg, min=1e-30)).sum()
    hc = -xlogy(pc, pc).sum()
    hg = -xlogy(pg, pg).sum()
    return _safe_div(2.0 * mi, hc + hg)


def cluster_purity(
    pred_segs: torch.Tensor,
    pred_mask: torch.Tensor,
    gold_segs: torch.Tensor,
    gold_mask: torch.Tensor,
    n_concepts: int,
) -> torch.Tensor:
    """Cluster purity of discovered word units: the dominant gold class
    count of each cluster, summed, over all units."""
    return purity_from_counts(
        purity_counts(pred_segs, pred_mask, gold_segs, gold_mask, n_concepts)
    )


def cluster_nmi(
    pred_segs: torch.Tensor,
    pred_mask: torch.Tensor,
    gold_segs: torch.Tensor,
    gold_mask: torch.Tensor,
    n_concepts: int,
) -> torch.Tensor:
    """Normalized mutual information between discovered clusters and gold
    classes, from the same contingency matrix as purity."""
    return nmi_from_counts(
        purity_counts(pred_segs, pred_mask, gold_segs, gold_mask, n_concepts)
    )
