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
The loop is the ``torch.library`` custom op ``proben::nms_fixpoint``, the
same code on every device: ``torch.export`` keeps it as one opaque node
(its fake gives the mask's shape), and ``utils.analysis.flop_count`` counts
it as nothing (no flop formula: its 0/1 products solve the greedy
recurrence, they are no model work). It runs in the span ``nms.fixpoint``
and counts ``nms.calls`` and ``nms.iters`` (``utils/tracing.py``).
"""

from __future__ import annotations

import torch

from ..structures.boxes import pairwise_iou
from ..utils import tracing

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
    keep = torch.ops.proben.nms_fixpoint(suppress, svalid)
    return torch.zeros_like(valid).scatter(-1, order, keep)


@torch.library.custom_op("proben::nms_fixpoint", mutates_args=())
def nms_fixpoint(suppress: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The greedy keep mask over score-sorted boxes: ``keep <- valid &
    ~(keep @ suppress)`` from ``keep = valid`` until nothing changes.
    ``suppress`` (..., N, N) bool, [i, j] where box i suppresses box j;
    ``valid`` (..., N) bool."""
    # 0/1 products summed in f32 are exact for any n the detector uses
    with tracing.span("nms.fixpoint"):
        suppress_f = suppress.to(torch.float32)
        keep = valid
        iters = 0
        for _ in range(valid.shape[-1]):
            iters += 1
            hit = torch.matmul(keep.to(torch.float32)[..., None, :], suppress_f)[..., 0, :]
            new_keep = valid & ~(hit > 0.5)
            if torch.equal(new_keep, keep):
                break
            keep = new_keep
        tracing.count("nms.calls")
        tracing.count("nms.iters", iters)
        return keep.clone()


@nms_fixpoint.register_fake
def _nms_fixpoint_fake(suppress, valid):
    return torch.empty_like(valid)


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
