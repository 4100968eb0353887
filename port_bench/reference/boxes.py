"""Box arithmetic of the reference: IoU, the delta codec, clipping, greedy
NMS and the FPN level of a box (detectron2 ``structures/boxes.py``,
``modeling/box_regression.py``, ``layers/nms.py``, ``poolers.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

SCALE_CLAMP = math.log(1000.0 / 16.0)


def area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M); 0 where the boxes do not intersect."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[:, None] + area(b)[None, :] - inter
    return torch.where(inter > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def encode(src: torch.Tensor, dst: torch.Tensor, weights) -> torch.Tensor:
    """Deltas that move ``src`` boxes onto ``dst`` boxes; a box of no width
    or height divides by 1 (its rows are masked out by the caller)."""
    sw, sh = src[..., 2] - src[..., 0], src[..., 3] - src[..., 1]
    tw, th = dst[..., 2] - dst[..., 0], dst[..., 3] - dst[..., 1]
    sx, sy = src[..., 0] + 0.5 * sw, src[..., 1] + 0.5 * sh
    tx, ty = dst[..., 0] + 0.5 * tw, dst[..., 1] + 0.5 * th
    sw, sh = torch.where(sw > 0, sw, 1.0), torch.where(sh > 0, sh, 1.0)
    tw, th = torch.where(tw > 0, tw, 1.0), torch.where(th > 0, th, 1.0)
    wx, wy, ww, wh = weights
    return torch.stack([wx * (tx - sx) / sw, wy * (ty - sy) / sh,
                        ww * torch.log(tw / sw), wh * torch.log(th / sh)], -1)


def decode(deltas: torch.Tensor, boxes: torch.Tensor, weights) -> torch.Tensor:
    """``deltas`` (..., K*4) applied to ``boxes`` (..., 4): (..., K*4)."""
    shape = deltas.shape
    d = deltas.reshape(shape[:-1] + (-1, 4))
    w = (boxes[..., 2] - boxes[..., 0])[..., None]
    h = (boxes[..., 3] - boxes[..., 1])[..., None]
    cx = boxes[..., 0, None] + 0.5 * w
    cy = boxes[..., 1, None] + 0.5 * h
    wx, wy, ww, wh = weights
    dw = (d[..., 2] / ww).clamp(max=SCALE_CLAMP)
    dh = (d[..., 3] / wh).clamp(max=SCALE_CLAMP)
    px, py = d[..., 0] / wx * w + cx, d[..., 1] / wy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], -1).reshape(shape)


def clip(boxes: torch.Tensor, h: float, w: float) -> torch.Tensor:
    x = boxes[..., 0::2].clamp(0, w)
    y = boxes[..., 1::2].clamp(0, h)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)


def order_by_score(scores: torch.Tensor) -> torch.Tensor:
    """Indices by descending score, ties to the lower index."""
    return torch.sort(scores, descending=True, stable=True).indices


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, thresh: float) -> torch.Tensor:
    """Indices kept by greedy NMS, best first: a box is dropped when a kept
    box of higher rank overlaps it by IoU > ``thresh``."""
    if boxes.shape[0] == 0:
        return torch.zeros(0, dtype=torch.long, device=boxes.device)
    order = order_by_score(scores)
    over = (iou(boxes[order], boxes[order]) > thresh).cpu().numpy()
    keep = np.ones(len(order), bool)
    for i in range(len(order)):
        if keep[i]:
            keep[i + 1:] &= ~over[i, i + 1:]
    return order[torch.from_numpy(np.nonzero(keep)[0]).to(order.device)]


def fpn_level(boxes: torch.Tensor, lo: int, hi: int, canonical_size=224.0, canonical_level=4):
    """detectron2's ``assign_boxes_to_levels``: floor(4 + log2(sqrt(area) /
    224)), clamped to [lo, hi]."""
    size = torch.sqrt(area(boxes).clamp(min=1e-6))
    lvl = torch.floor(canonical_level + torch.log2(size / canonical_size + 1e-8))
    return lvl.clamp(lo, hi).long()
