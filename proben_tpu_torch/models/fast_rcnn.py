"""Fast R-CNN outputs (counterpart of ``proben_tpu/models/fast_rcnn.py``),
batched over images with static shapes: the losses on sampled proposals,
and the inference decoding as a masked candidate set, class-wise NMS and a
fixed top-k with validity bits. Top-k selections use the stable descending
sort, because invalid slots carry many exact ``-1.0`` ties.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..ops.box_transform import apply_deltas, get_deltas
from ..ops.nms import batched_nms_mask
from ..ops.topk import topk_stable
from ..structures.boxes import clip_boxes
from ..structures.detections import Detections

ROI_BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


@dataclasses.dataclass(frozen=True)
class FastRCNNConfig:
    """Loss and decoding hyperparameters."""

    num_classes: int = 3
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    topk_per_image: int = 100
    smooth_l1_beta: float = 0.0
    cls_agnostic_bbox_reg: bool = False
    box_reg_weights: Tuple[float, float, float, float] = ROI_BOX_WEIGHTS
    enable_gaussian_nll: bool = False
    # static cap on NMS candidates (R*C flattened, pre-NMS)
    max_candidates: int = 4096


def smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    """Elementwise smooth-L1 (pure L1 at ``beta == 0``)."""
    if beta <= 0:
        return diff.abs()
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * diff * diff / beta, ad - 0.5 * beta)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, j], ...] for (B, N, ...) x and (B, M) idx."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


def fast_rcnn_inference(
    logits: torch.Tensor,  # (B, R, C+1) f32
    deltas: torch.Tensor,  # (B, R, C*4), or (B, R, 4) class-agnostic
    proposal_boxes: torch.Tensor,  # (B, R, 4)
    proposal_valid: torch.Tensor,  # (B, R)
    image_sizes: torch.Tensor,  # (B, 2) true (h, w)
    cfg: FastRCNNConfig,
    variance: Optional[torch.Tensor] = None,  # (B, R, 1)
    coordinate_bound: float = 8192.0,
) -> Detections:
    """``fast_rcnn_inference_single_image`` for every image of the batch; a
    class-agnostic (B, R, 4) box serves every class of its RoI."""
    b, r = logits.shape[:2]
    c = cfg.num_classes
    dev = logits.device
    scores = torch.softmax(logits, dim=-1)[..., :-1]  # drop background

    boxes = apply_deltas(deltas, proposal_boxes, cfg.box_reg_weights)
    h = image_sizes[:, 0].to(torch.float32)[:, None, None]
    w = image_sizes[:, 1].to(torch.float32)[:, None, None]
    boxes = clip_boxes(boxes.reshape(b, r, -1, 4), (h, w))  # (B, R, C or 1, 4)
    boxes = boxes.expand(b, r, c, 4)

    cand_scores = scores.reshape(b, -1)
    cand_boxes = boxes.reshape(b, -1, 4)
    cand_classes = torch.arange(c, dtype=torch.int32, device=dev).repeat(r)
    cand_rows = torch.arange(r, device=dev).repeat_interleave(c)
    finite = torch.isfinite(cand_boxes).all(-1) & torch.isfinite(cand_scores)
    cand_valid = (cand_scores > cfg.score_thresh) & proposal_valid[:, cand_rows] & finite

    m = min(cfg.max_candidates, r * c)
    top_scores, top_idx = topk_stable(torch.where(cand_valid, cand_scores, -1.0), m)
    sel_valid = top_scores > 0
    sel_boxes = take_rows(cand_boxes, top_idx)
    sel_classes = cand_classes[top_idx]
    sel_rows = cand_rows[top_idx]

    keep = batched_nms_mask(sel_boxes, top_scores, sel_classes, sel_valid, cfg.nms_thresh,
                            coordinate_bound)
    kept_scores = torch.where(keep, top_scores, -1.0)
    final_scores, final_pos = topk_stable(kept_scores, cfg.topk_per_image)
    final_valid = final_scores > 0
    final_pos = torch.where(final_valid, final_pos, 0)

    rows = torch.gather(sel_rows, 1, final_pos)
    fv = final_valid[..., None]
    return Detections(
        boxes=torch.where(fv, take_rows(sel_boxes, final_pos), 0.0),
        scores=torch.where(final_valid, final_scores, 0.0),
        classes=torch.where(final_valid, torch.gather(sel_classes, 1, final_pos), 0),
        valid=final_valid,
        probs=torch.where(fv, take_rows(scores, rows), 0.0),
        class_logits=torch.where(fv, take_rows(logits, rows), 0.0),
        variance=None if variance is None else torch.where(fv, take_rows(variance, rows), 0.0),
    )


def fast_rcnn_losses(
    logits: torch.Tensor,  # (B, S, C+1) on the sampled proposals
    deltas: torch.Tensor,  # (B, S, C*4), or (B, S, 4) class-agnostic
    variance: Optional[torch.Tensor],  # (B, S, 1) or None
    proposal_boxes: torch.Tensor,  # (B, S, 4)
    gt_classes: torch.Tensor,  # (B, S) int in [0, C], C = background
    sample_valid: torch.Tensor,  # (B, S) bool
    gt_boxes: torch.Tensor,  # (B, S, 4) matched gt box per sampled proposal
    cfg: FastRCNNConfig,
) -> Dict[str, torch.Tensor]:
    """Per-image losses, each (B,): softmax cross-entropy averaged over the
    valid sampled proposals; smooth-L1 on the foreground rows' gt-class
    deltas, divided by the same count; with the variance head, the Gaussian
    NLL 0.5 * (log v + d^2 / v) over the foreground rows x 4 coordinates
    (torch's ``GaussianNLLLoss``, eps 1e-6)."""
    b, s = logits.shape[:2]
    c = cfg.num_classes
    num_valid = sample_valid.to(torch.float32).sum(-1).clamp(min=1.0)
    ce = -torch.gather(torch.log_softmax(logits, -1), -1, gt_classes.long()[..., None])[..., 0]
    loss_cls = torch.where(sample_valid, ce, 0.0).sum(-1) / num_valid

    fg = sample_valid & (gt_classes < c)
    gt_deltas = get_deltas(proposal_boxes, gt_boxes, cfg.box_reg_weights)
    if cfg.cls_agnostic_bbox_reg:
        pred = deltas
    else:
        cls_idx = gt_classes.long().clamp(0, c - 1)
        pred = torch.gather(deltas.reshape(b, s, c, 4), 2,
                            cls_idx[..., None, None].expand(b, s, 1, 4))[:, :, 0]
    diff = pred - gt_deltas
    per = smooth_l1(diff, cfg.smooth_l1_beta)
    loss_box = torch.where(fg[..., None], per, 0.0).sum((-2, -1)) / num_valid
    losses = {"loss_cls": loss_cls, "loss_box_reg": loss_box}

    if cfg.enable_gaussian_nll and variance is not None:
        var = variance.clamp(min=1e-6)  # (B, S, 1) broadcasts over the 4 coordinates
        nll = 0.5 * (torch.log(var) + diff * diff / var)
        num_fg = fg.to(torch.float32).sum(-1).clamp(min=1.0)
        losses["gaussian_loss"] = torch.where(fg[..., None], nll, 0.0).sum((-2, -1)) / (num_fg * 4.0)
    return losses
