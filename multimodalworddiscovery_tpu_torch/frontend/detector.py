"""Learned region-proposal detector: anchor-based RPN over conv features.

Counterpart of ``multimodalworddiscovery_tpu/frontend/detector.py``: a
single-stage region-proposal network that predicts boxes directly from
images, whose proposals feed ``image.region_embeddings`` as annotation
boxes do.  The convolutions are cuDNN's (the reference runs them in XLA,
outside any Pallas kernel); the box geometry, the anchor matching and the
NMS are plain torch, batched over images.

What keeps it equal to the reference:
- the RPN head's outputs flatten in (h, w, anchor) order, as flax's NHWC
  ``reshape`` does, so they line up with ``anchor_grid``'s [H, W, A] order;
- the pre-NMS top k is a stable descending sort: ties go to the lower
  index, as ``lax.top_k`` gives them (after training, confident anchors
  saturate ``sigmoid`` to exactly 1.0, so ties are common);
- the forced matches of ``match_anchors`` are a scatter-max
  (``scatter_reduce(..., "amax")``), as ``.at[].max()`` resolves
  collisions; every argmax is ``torch.argmax``'s first maximum.

Adam is optax's (``hmm_dnn.adam_update``); a training step takes its loss
and gradient under ``core.determinism.deterministic_convolutions``, so it
gives the same bits in every run.  Keep cuDNN's TF32 off
(``torch.backends.cudnn.allow_tf32``) where a result is held to float32.
Boxes are normalized (y1, x1, y2, x2) in [0, 1] throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from multimodalworddiscovery_tpu_torch.core.determinism import deterministic_convolutions
from multimodalworddiscovery_tpu_torch.models import flax_params, hmm_dnn

# clamp on predicted log-size deltas: exp(4) ~ 55x an anchor's size
_MAX_DSIZE = 4.0


# ---------------------------------------------------------------------------
# anchors + box geometry
# ---------------------------------------------------------------------------


def anchor_grid(
    feat_h: int,
    feat_w: int,
    scales: tuple[float, ...] = (0.15, 0.3, 0.5),
    ratios: tuple[float, ...] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """Fixed anchor grid in normalized coordinates: one anchor per (cell,
    scale, ratio), centered on the cells of an (feat_h, feat_w) map, a scale
    ``s`` with aspect ``r`` spanning height s*sqrt(r) and width s/sqrt(r).
    Returns [feat_h * feat_w * len(scales) * len(ratios), 4] float32."""
    cy = (np.arange(feat_h) + 0.5) / feat_h
    cx = (np.arange(feat_w) + 0.5) / feat_w
    hs, ws = [], []
    for s in scales:
        for r in ratios:
            hs.append(s * np.sqrt(r))
            ws.append(s / np.sqrt(r))
    hs = np.asarray(hs, np.float32)  # [A]
    ws = np.asarray(ws, np.float32)
    cyg, cxg = np.meshgrid(cy, cx, indexing="ij")  # [H, W]
    cyg = cyg[:, :, None]
    cxg = cxg[:, :, None]
    boxes = np.stack(
        [cyg - hs / 2, cxg - ws / 2, cyg + hs / 2, cxg + ws / 2], axis=-1
    )  # [H, W, A, 4]
    return boxes.reshape(-1, 4).astype(np.float32)


def _center_form(boxes: torch.Tensor) -> tuple[torch.Tensor, ...]:
    y1, x1, y2, x2 = boxes.unbind(-1)
    return (y1 + y2) / 2, (x1 + x2) / 2, y2 - y1, x2 - x1


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """(dy, dx, dh, dw) deltas w.r.t. anchors -> (y1, x1, y2, x2) in [0, 1]:
    center shifts in units of the anchor's size, log-scaled sizes.
    Broadcasts anchors [..., A, 4] against deltas [..., A, 4]."""
    acy, acx, ah, aw = _center_form(anchors)
    dy, dx, dh, dw = deltas.unbind(-1)
    cy = acy + dy * ah
    cx = acx + dx * aw
    h = ah * torch.exp(torch.clamp(dh, -_MAX_DSIZE, _MAX_DSIZE))
    w = aw * torch.exp(torch.clamp(dw, -_MAX_DSIZE, _MAX_DSIZE))
    out = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], dim=-1)
    return torch.clamp(out, 0.0, 1.0)


def encode_boxes(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Inverse of ``decode_boxes`` (regression targets for matched anchors)."""
    acy, acx, ah, aw = _center_form(anchors)
    gcy, gcx, gh, gw = _center_form(gt)
    eps = 1e-8
    return torch.stack(
        [
            (gcy - acy) / (ah + eps),
            (gcx - acx) / (aw + eps),
            torch.log((gh + eps) / (ah + eps)),
            torch.log((gw + eps) / (aw + eps)),
        ],
        dim=-1,
    )


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a [..., Na, 4], b [..., Nb, 4] -> [..., Na, Nb]
    (leading dimensions broadcast)."""
    ay1, ax1, ay2, ax2 = a[..., :, None, :].unbind(-1)
    by1, bx1, by2, bx2 = b[..., None, :, :].unbind(-1)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0.0)
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0.0)
    inter = ih * iw
    area_a = torch.clamp(ay2 - ay1, min=0.0) * torch.clamp(ax2 - ax1, min=0.0)
    area_b = torch.clamp(by2 - by1, min=0.0) * torch.clamp(bx2 - bx1, min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest scores along the last axis, ties
    to the lower index, as ``lax.top_k`` orders them (a stable descending
    sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    k: int,
    iou_thresh: float = 0.5,
    score_thresh: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape greedy NMS, batched over leading dimensions.

    boxes [..., A, 4], scores [..., A] -> (boxes [..., k, 4], scores
    [..., k], keep [..., k]): ``top_k`` prunes to the k best candidates
    (greedy-NMS visitation order), then k steps walk their [k, k] IoU
    matrix, each suppressing the lower-ranked overlaps of a kept box."""
    vals, idx = top_k(scores, k)
    cand = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    iou = box_iou(cand, cand)
    ranks = torch.arange(k, device=boxes.device)
    keep = vals > score_thresh
    for i in range(k):
        sup = (iou[..., i, :] > iou_thresh) & (ranks > i) & keep[..., i:i + 1]
        keep = keep & ~sup
    return cand, vals, keep


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class ConvBackbone(nn.Module):
    """Strided conv stack: [N, 3, H, W] -> [N, widths[-1], H/2^d, W/2^d],
    3x3 kernels at stride 2, padding 1, each followed by a relu."""

    def __init__(self, widths: tuple[int, ...] = (32, 64, 128)):
        super().__init__()
        ins = (3, *widths[:-1])
        self.conv = nn.ModuleList(nn.Conv2d(i, w, 3, stride=2, padding=1)
                                  for i, w in zip(ins, widths))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.conv:
            x = torch.relu(conv(x))
        return x


class RPNHead(nn.Module):
    """Feature map [N, C, fh, fw] -> (objectness [N, A_tot], deltas
    [N, A_tot, 4]) with A_tot = fh * fw * num_anchors, in (h, w, anchor)
    order."""

    def __init__(self, in_channels: int, num_anchors: int, channels: int = 128):
        super().__init__()
        self.trunk = nn.Conv2d(in_channels, channels, 3, padding=1)
        self.objectness = nn.Conv2d(channels, num_anchors, 1)
        self.deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        n = feat.shape[0]
        x = torch.relu(self.trunk(feat))
        obj = self.objectness(x).permute(0, 2, 3, 1)  # [N, fh, fw, A]
        deltas = self.deltas(x).permute(0, 2, 3, 1)  # [N, fh, fw, A * 4]
        return obj.reshape(n, -1), deltas.reshape(n, -1, 4)


class Detector(nn.Module):
    """Backbone + RPN head; images [N, H, W, 3] -> (obj, deltas)."""

    def __init__(self, num_anchors: int, widths: tuple[int, ...] = (32, 64, 128),
                 channels: int = 128):
        super().__init__()
        self.backbone = ConvBackbone(widths)
        self.rpn = RPNHead(widths[-1], num_anchors, channels)

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.rpn(self.backbone(images.permute(0, 3, 1, 2)))


class DetectorConfig(NamedTuple):
    """Static geometry shared by init / train / propose."""

    image_size: int
    scales: tuple[float, ...] = (0.15, 0.3, 0.5)
    ratios: tuple[float, ...] = (0.5, 1.0, 2.0)
    widths: tuple[int, ...] = (32, 64, 128)
    channels: int = 128

    @property
    def feat_size(self) -> int:
        return self.image_size // (2 ** len(self.widths))

    @property
    def num_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)

    def anchors(self) -> np.ndarray:
        return anchor_grid(self.feat_size, self.feat_size, self.scales, self.ratios)

    def module(self) -> Detector:
        return Detector(self.num_anchors, self.widths, self.channels)


def init(config: DetectorConfig, generator: torch.Generator | None = None,
         device="cuda") -> Detector:
    """Random-init detector for ``config`` on ``device``, drawn as flax
    initialises its layers from ``generator`` (a CPU generator seeded 0
    when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = config.module()
    flax_params.flax_init(model, generator)
    return model.to(device)


def params_from_flax(tree: dict, device="cuda") -> Detector:
    """A detector from the reference's flax variables (numpy arrays,
    optionally under "params"): {"backbone": {"conv_i"}, "rpn": {"trunk",
    "objectness", "deltas"}}, each Conv kernel [kh, kw, in, out] becoming
    a weight [out, in, kh, kw].  Sizes come from the tree's shapes."""
    t = tree.get("params", tree)
    bb = t["backbone"]
    widths = tuple(np.asarray(bb[f"conv_{i}"]["kernel"]).shape[-1] for i in range(len(bb)))
    rpn = t["rpn"]
    model = Detector(num_anchors=np.asarray(rpn["objectness"]["kernel"]).shape[-1],
                     widths=widths, channels=np.asarray(rpn["trunk"]["kernel"]).shape[-1])
    flax_params.copy_into(model, flax_params.load_flax_tree(model, t, {}, "cpu"))
    return model.to(device)


# ---------------------------------------------------------------------------
# training (anchor matching + one step)
# ---------------------------------------------------------------------------


def match_anchors(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    pos_iou: float = 0.5,
    neg_iou: float = 0.3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-anchor training labels, batched over images.

    anchors [A, 4]; gt_boxes [..., G, 4] padded; gt_mask [..., G] bool.
    Returns (labels [..., A] in {1 pos, 0 neg, -1 ignore}, matched [..., A]
    int32 gt index).  Positives: IoU >= pos_iou with some valid gt, plus
    the best anchor of every valid gt (forced, so no gt goes unsupervised;
    where two gts force one anchor the larger gt index wins, as the
    reference's scatter-max resolves it); negatives: best IoU < neg_iou;
    the band between is ignored."""
    iou = box_iou(anchors, gt_boxes)  # [..., A, G]
    iou = torch.where(gt_mask[..., None, :], iou, -1.0)
    best_iou = torch.amax(iou, dim=-1)
    matched = torch.argmax(iou, dim=-1)
    labels = torch.where(best_iou >= pos_iou, 1, torch.where(best_iou < neg_iou, 0, -1))
    g = gt_boxes.shape[-2]
    best_anchor = torch.argmax(iou, dim=-2)  # [..., G]
    zeros = torch.zeros_like(matched)
    force = zeros.scatter_reduce(-1, best_anchor, gt_mask.long(), "amax", include_self=True)
    gt_ids = torch.where(gt_mask, torch.arange(g, device=gt_mask.device), 0)
    forced_gt = zeros.scatter_reduce(-1, best_anchor, gt_ids, "amax", include_self=True)
    labels = torch.where(force > 0, 1, labels)
    matched = torch.where(force > 0, forced_gt, matched).to(torch.int32)
    return labels.to(torch.int32), matched


def loss_fn(
    model: Detector,
    anchors: torch.Tensor,
    images: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    pos_iou: float = 0.5,
    neg_iou: float = 0.3,
    box_weight: float = 1.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Sigmoid-BCE objectness + Huber box regression over a batch."""
    obj, deltas = model(images)  # [N, A], [N, A, 4]
    labels, matched = match_anchors(anchors, gt_boxes, gt_mask, pos_iou, neg_iou)
    pos = labels == 1
    valid = labels >= 0
    tgt = pos.to(obj.dtype)
    bce = torch.clamp(obj, min=0) - obj * tgt + torch.log1p(torch.exp(-torch.abs(obj)))
    obj_loss = torch.where(valid, bce, 0.0).sum() / torch.clamp(valid.sum(), min=1)
    idx = matched.long()[..., None].expand(*matched.shape, 4)
    matched_boxes = torch.gather(gt_boxes, -2, idx)  # [N, A, 4]
    tdeltas = encode_boxes(anchors[None], matched_boxes)
    diff = deltas - tdeltas
    huber = torch.where(torch.abs(diff) < 1.0, 0.5 * diff**2, torch.abs(diff) - 0.5)
    n_pos = pos.sum()
    box_loss = torch.where(pos[..., None], huber, 0.0).sum() / torch.clamp(n_pos, min=1)
    loss = obj_loss + box_weight * box_loss
    return loss, {"loss": loss, "obj_loss": obj_loss, "box_loss": box_loss, "n_pos": n_pos}


def make_train_step(model: Detector, anchors: torch.Tensor, learning_rate: float):
    """``(opt_state, images, gt_boxes, gt_mask) -> (opt_state, stats)``: one
    Adam step (optax.adam's, ``hmm_dnn.adam_update``) on ``model``'s weights
    in place; the stats stay on the device."""
    weights = list(model.parameters())

    def step(opt_state, images, gt_boxes, gt_mask):
        with deterministic_convolutions():
            loss, stats = loss_fn(model, anchors, images, gt_boxes, gt_mask)
            grads = torch.autograd.grad(loss, weights)
        updates, opt_state = hmm_dnn.adam_update(grads, opt_state, learning_rate)
        hmm_dnn.apply_updates(model, updates)
        return opt_state, {k: v.detach() for k, v in stats.items()}

    return step


def train(
    config: DetectorConfig,
    images: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    num_steps: int = 300,
    learning_rate: float = 1e-3,
    generator: torch.Generator | None = None,
) -> tuple[Detector, list[dict[str, float]]]:
    """Full-batch training of ``init(config, generator)`` on (images, padded
    gt boxes, mask), on their device -> (model, stats history).  The
    history holds the stats of every 50th step and of the last, the only
    steps whose stats are read on the host."""
    model = init(config, generator, images.device)
    anchors = torch.as_tensor(config.anchors(), device=images.device)
    opt_state = hmm_dnn.adam_init(model.parameters())
    step = make_train_step(model, anchors, learning_rate)
    history = []
    for it in range(num_steps):
        opt_state, stats = step(opt_state, images, gt_boxes, gt_mask)
        if (it + 1) % 50 == 0 or it == num_steps - 1:
            history.append({k: float(v) for k, v in stats.items()})
    return model, history


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------


def propose(
    model: Detector,
    anchors: torch.Tensor,
    images: torch.Tensor,
    k: int = 16,
    iou_thresh: float = 0.5,
    score_thresh: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Images [N, H, W, 3] -> (boxes [N, k, 4], scores [N, k], keep [N, k]):
    ``boxes[i][keep[i]]`` feeds ``image.region_embeddings`` as annotation
    boxes do."""
    with torch.no_grad():
        obj, deltas = model(images)
    boxes = decode_boxes(anchors[None], deltas)
    return nms(boxes, torch.sigmoid(obj), k, iou_thresh, score_thresh)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU in float64 on the host, a [Na, 4], b [Nb, 4]: the
    reference's float64 oracle (``oracles/numpy_detector.iou_matrix``),
    its per-pair arithmetic over whole arrays."""
    a = np.asarray(a, np.float64)[:, None, :]
    b = np.asarray(b, np.float64)[None, :, :]
    ih = np.maximum(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), 0.0)
    iw = np.maximum(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), 0.0)
    inter = ih * iw
    area_a = np.maximum(a[..., 2] - a[..., 0], 0.0) * np.maximum(a[..., 3] - a[..., 1], 0.0)
    area_b = np.maximum(b[..., 2] - b[..., 0], 0.0) * np.maximum(b[..., 3] - b[..., 1], 0.0)
    return inter / np.maximum(area_a + area_b - inter, 1e-12)


def detection_recall(
    pred_boxes: np.ndarray,
    pred_keep: np.ndarray,
    gt_boxes: np.ndarray,
    gt_mask: np.ndarray,
    iou_thresh: float = 0.5,
) -> float:
    """Fraction of valid gt boxes covered by some kept proposal at IoU >=
    ``iou_thresh`` (host-side evaluation)."""
    hit = 0
    total = 0
    for i in range(len(gt_boxes)):
        gt = gt_boxes[i][gt_mask[i].astype(bool)]
        kept = pred_boxes[i][pred_keep[i].astype(bool)]
        total += len(gt)
        if len(gt) == 0 or len(kept) == 0:
            continue
        m = iou_matrix(kept, gt)
        hit += int(np.sum(np.max(m, axis=0) >= iou_thresh))
    return hit / max(total, 1)
