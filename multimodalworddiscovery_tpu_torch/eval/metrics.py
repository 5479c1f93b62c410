"""On-device alignment metrics.

Counterpart of ``multimodalworddiscovery_tpu/eval/metrics.py`` (the
alignment family; the segment, boundary and cluster families come later).
Every metric is a masked tensor computation over the whole corpus; only the
final scalars leave the device.

Conventions: alignment arrays [N, Ts]: 0 = NULL, j >= 1 = 1-based trg
position.
"""

from __future__ import annotations

import torch


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(b > 0, a / torch.clamp(b, min=1), 0.0)


def _prf(
    tp: torch.Tensor, n_pred: torch.Tensor, n_gold: torch.Tensor
) -> dict[str, torch.Tensor]:
    p = _safe_div(tp, n_pred)
    r = _safe_div(tp, n_gold)
    f1 = torch.where(p + r > 0, 2 * p * r / torch.clamp(p + r, min=1e-12), 0.0)
    return {"precision": p, "recall": r, "f1": f1}


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
