"""ProbEn late fusion of padded detections, batched over images
(counterpart of ``proben_tpu/fusion/proben_jax.py::fuse_detections_jax``).

The same masked-matrix formulation of the reference's per-box loop
(``demo_probEn.py:92-196``): class-offset +1-convention IoU, the exact
greedy keep set (heads) as a Jacobi fixpoint, every box joining the
highest-scoring kept head it overlaps, per-cluster score and box fusion,
singleton passthrough and head-score output order. Every tensor carries a
leading image axis, so one call fuses a whole batch. Where the JAX function
leaves choices to XLA, the port fixes them so that no setting of the card
changes a result:

  * the fixpoint runs on the host's loop, one sync per iteration for the
    whole batch (as ``ops/nms.py``), over boolean products;
  * the per-cluster sums (JAX: membership matmuls at ``Precision.HIGHEST``)
    are broadcast f32 products summed along the member axis, so
    ``torch.backends.cuda.matmul.allow_tf32`` cannot reach them;
  * the output top-k is the stable sort of ``ops/topk.py`` (``lax.top_k``'s
    tie order, lower index first).

The call is the span ``proben.fuse`` and its fixpoint the span
``proben.fixpoint``; it counts ``proben.calls`` and ``proben.iters`` (one
host read each) in ``utils/tracing.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.topk import topk_stable
from ..utils import tracing

Tensor = torch.Tensor

_NEG_INF = -1e10
SCORE_METHODS = ("probEn", "avg", "max")
BOX_METHODS = ("v-avg", "s-avg", "avg", "argmax")


def _plus1_offset_iou(boxes: Tensor, classes: Tensor, offx: float, offy: float) -> Tensor:
    """(B, N, N) IoU with the legacy +1 convention and per-class coordinate
    offsets."""
    x1 = boxes[..., 0] + classes * offx
    y1 = boxes[..., 1] + classes * offy
    x2 = boxes[..., 2] + classes * offx
    y2 = boxes[..., 3] + classes * offy
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = torch.clamp(xx2 - xx1 + 1.0, min=0.0)
    h = torch.clamp(yy2 - yy1 + 1.0, min=0.0)
    inter = w * h
    return inter / (areas[..., :, None] + areas[..., None, :] - inter)


def _cluster_sum(member_f: Tensor, x: Tensor) -> Tensor:
    """(B, N, N) 0/1 membership x (B, N, D) -> (B, N, D): each head's sum
    over its members, in f32 products and sums."""
    return (member_f[..., None] * x[:, None, :, :]).sum(dim=2)


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """Rows ``idx`` (B, K) of ``x`` (B, N, ...)."""
    return torch.gather(x, 1, idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


def _keep_set(suppress: Tensor, valid: Tensor) -> Tensor:
    """The greedy keep set: ``keep <- valid & ~any(keep & suppress)`` from
    ``keep = valid`` until nothing changes, one ``torch.equal`` (host read)
    an iteration."""
    with tracing.span("proben.fixpoint"):
        keep, iters = valid, 0
        for _ in range(valid.shape[-1]):
            new_keep = valid & ~(keep[..., :, None] & suppress).any(dim=-2)
            iters += 1
            if torch.equal(new_keep, keep):
                break
            keep = new_keep
        tracing.count("proben.calls")
        tracing.count("proben.iters", iters)
        return keep


def fuse_detections_torch(
    boxes: Tensor,  # (B, N, 4) per image, concatenated over models (padded)
    scores: Tensor,  # (B, N)
    classes: Tensor,  # (B, N) int
    probs: Tensor,  # (B, N, C) foreground probabilities
    variances: Optional[Tensor],  # (B, N) or (B, N, 1); needed for v-avg
    valid: Tensor,  # (B, N) bool
    score_method: str = "probEn",
    box_method: str = "v-avg",
    thresh: float = 0.5,
    class_offset: Tuple[float, float] = (640.0, 512.0),
    topk: int = 100,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fused (boxes (B, K, 4), scores (B, K), classes (B, K) int32,
    valid (B, K)), K = min(topk, N), sorted by cluster-head score; invalid
    slots are zeros. Runs where the inputs are."""
    if score_method not in SCORE_METHODS:
        raise ValueError(f"score_method {score_method!r} not in {SCORE_METHODS}")
    if box_method not in BOX_METHODS:
        raise ValueError(f"box_method {box_method!r} not in {BOX_METHODS}")
    if box_method == "v-avg" and variances is None:
        raise ValueError("box_method 'v-avg' needs per-box variances")
    with tracing.span("proben.fuse"):
        b, n = scores.shape
        dev = scores.device
        boxes, scores, probs = boxes.float(), scores.float(), probs.float()
        classes = classes.long()
        iou = _plus1_offset_iou(boxes, classes.float(), *class_offset)

        # ---- greedy keep set (heads)
        masked = torch.where(valid, scores, _NEG_INF)
        order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
        rank = torch.empty_like(order).scatter_(-1, order, torch.arange(n, device=dev).expand(b, n))
        earlier = rank[..., :, None] < rank[..., None, :]  # i ranks before j
        overlap = (iou > thresh) & valid[..., :, None] & valid[..., None, :]
        suppress = overlap & earlier
        keep = _keep_set(suppress, valid)

        # ---- cluster assignment: a non-head joins its highest-scoring kept head
        head_scores = torch.where(keep, masked, _NEG_INF)
        claim = torch.where(overlap & keep[..., :, None], head_scores[..., :, None], _NEG_INF)
        head_of = claim.argmax(dim=-2)  # (B, N) first best head per column
        is_member = valid & ~keep & (claim.amax(dim=-2) > _NEG_INF / 2)
        idx = torch.arange(n, device=dev)
        member = ((idx[:, None] == head_of[..., None, :]) & is_member[..., None, :]) | (
            torch.eye(n, dtype=torch.bool, device=dev) & keep[..., :, None])
        member_f = member.float()
        multi = keep & (member_f.sum(dim=-1) > 1.5)

        # ---- score fusion
        if score_method == "probEn":
            ext = torch.cat([probs, 1.0 - probs.sum(dim=-1, keepdim=True)], dim=-1)
            sum_logits = _cluster_sum(member_f, torch.log(ext.clamp(min=1e-30)))
            sum_logits = sum_logits - sum_logits.amax(dim=-1, keepdim=True)
            expd = torch.exp(sum_logits)
            norm = expd / expd.sum(dim=-1, keepdim=True).clamp(min=1e-30)
            fused_score, fused_class = norm.amax(dim=-1), norm.argmax(dim=-1)
        elif score_method == "avg":
            msum = _cluster_sum(member_f, torch.where(valid, scores, 0.0)[..., None])[..., 0]
            fused_score, fused_class = msum / member_f.sum(dim=-1).clamp(min=1.0), classes
        else:  # max
            big = torch.where(member, probs.amax(dim=-1)[..., None, :], _NEG_INF)
            fused_score, fused_class = big.amax(dim=-1), classes

        # ---- box fusion
        if box_method == "argmax":
            best = torch.where(member, scores[..., None, :], _NEG_INF).argmax(dim=-1)
            fused_boxes = _take(boxes, best)
        else:
            if box_method == "v-avg":
                w = 1.0 / variances.reshape(b, n).float().clamp(min=1e-20)
            elif box_method == "s-avg":
                w = scores
            else:
                w = torch.ones_like(scores)
            w = torch.where(valid, w, 0.0)
            wsum = _cluster_sum(member_f, w[..., None])
            fused_boxes = _cluster_sum(member_f, boxes * w[..., None]) / wsum.clamp(min=1e-20)

        # ---- singleton passthrough and assembly in head-score order
        out_scores = torch.where(multi, fused_score, scores)
        out_classes = torch.where(multi, fused_class, classes)
        out_boxes = torch.where(multi[..., None], fused_boxes, boxes)
        top_scores, top_idx = topk_stable(head_scores, min(topk, n))
        out_valid = top_scores > _NEG_INF / 2
        top_idx = torch.where(out_valid, top_idx, 0)
        return (
            torch.where(out_valid[..., None], _take(out_boxes, top_idx), 0.0),
            torch.where(out_valid, _take(out_scores, top_idx), 0.0),
            torch.where(out_valid, _take(out_classes, top_idx), 0).to(torch.int32),
            out_valid,
        )
