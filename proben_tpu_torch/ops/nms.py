"""Exact greedy NMS as a batched Jacobi fixpoint (counterpart of
``proben_tpu/ops/nms.py``).

The greedy recurrence

    keep[j] = valid[j] and not any(keep[i] and iou[i, j] > t for i < j)

over score-sorted boxes is solved by iterating ``keep <- valid & ~(keep @
suppress)`` until nothing changes; suppression only flows from earlier to
later boxes, so this converges to the exact greedy answer in at most the
length of the longest suppression chain. Every function takes leading batch
dimensions (images, FPN levels): one iteration is one batched matvec for all
problems, and the loop pays one host sync per iteration, not one per image.
"""

from __future__ import annotations

import torch

from ..structures.boxes import pairwise_iou
from ..utils.analysis import reported_work

_NEG_INF = -1e10


def nms_mask(
    boxes: torch.Tensor,  # (..., N, 4)
    scores: torch.Tensor,  # (..., N)
    valid: torch.Tensor,  # (..., N) bool; padded slots never suppress, never kept
    iou_threshold: float,
) -> torch.Tensor:
    """Exact greedy NMS; bool keep mask in the ORIGINAL box order. Ties in
    score go to the lower index; suppression needs IoU > threshold."""
    n = boxes.shape[-2]
    masked = torch.where(valid, scores, _NEG_INF)
    # jnp.argsort(-x) sorts NaN last; torch's descending sort puts it first
    masked = torch.where(torch.isnan(masked), float("-inf"), masked)
    _, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    svalid = torch.gather(valid, -1, order)

    iou = pairwise_iou(sboxes, sboxes)
    tri = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (iou > iou_threshold) & tri & svalid[..., :, None] & svalid[..., None, :]
    # 0/1 products summed in f32 are exact for any n the detector uses
    suppress_f = suppress.to(torch.float32)

    keep = svalid
    with reported_work(0):  # NMS is no model work for utils.analysis.flop_count
        for _ in range(n):
            hit = torch.matmul(keep.to(torch.float32)[..., None, :], suppress_f)[..., 0, :]
            new_keep = svalid & ~(hit > 0.5)
            if torch.equal(new_keep, keep):
                break
            keep = new_keep
    return torch.zeros_like(valid).scatter(-1, order, keep)


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,  # (..., N) group ids (class); groups never interact
    valid: torch.Tensor,
    iou_threshold: float,
    coordinate_bound: float = 8192.0,
) -> torch.Tensor:
    """Per-group NMS by the coordinate-offset trick; ``coordinate_bound``
    must exceed every box coordinate."""
    offsets = idxs.to(boxes.dtype)[..., None] * (coordinate_bound + 1.0)
    return nms_mask(boxes + offsets, scores, valid, iou_threshold)
