"""Region Proposal Network (counterpart of ``proben_tpu/models/rpn.py``):
the shared head, proposal selection and the training losses, batched over
images.

Objectness is flattened in (H, W, A) order and deltas kept in the head's
(H*W, A*4) layout, as in the JAX package. Per-level top-k and the global
post-NMS top-k use a stable descending sort (``ops/topk.py``) so ties go to
the lower index as with ``lax.top_k``; the per-level NMS problems of all
images and levels run as one batched fixpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.box_transform import apply_deltas, get_deltas
from ..ops.matcher import match
from ..ops.nms import nms_mask
from ..ops.sampling import Draws, sample_topk_indices
from ..ops.topk import topk_stable
from ..structures.boxes import clip_boxes, nonempty_boxes, pairwise_iou
from .fast_rcnn import smooth_l1, take_rows
from .layers import Conv, conv2d, init_conv

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    """Static RPN hyperparameters (reference config/defaults.py RPN
    section)."""

    pre_nms_topk_train: int = 2000  # per level
    pre_nms_topk_test: int = 1000
    post_nms_topk_train: int = 1000  # total
    post_nms_topk_test: int = 1000
    nms_thresh: float = 0.7
    min_box_side_len: float = 0.0
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5
    iou_thresholds: Tuple[float, float] = (0.3, 0.7)
    smooth_l1_beta: float = 0.0
    loss_weight: float = 1.0


class RPNHead(nn.Module):
    def __init__(self, in_channels: int, num_anchors: int = 3):
        super().__init__()
        self.conv = Conv(in_channels, in_channels, 3)
        self.objectness = Conv(in_channels, num_anchors, 1)
        self.deltas = Conv(in_channels, num_anchors * 4, 1)


def init_rpn_head(rng: np.random.Generator, in_channels: int, num_anchors: int = 3) -> Dict:
    return {
        "conv": init_conv(rng, 3, 3, in_channels, in_channels, init_std=0.01),
        "objectness": init_conv(rng, 1, 1, in_channels, num_anchors, init_std=0.01),
        "deltas": init_conv(rng, 1, 1, in_channels, num_anchors * 4, init_std=0.01),
    }


def apply_rpn_head(
    head: RPNHead, features: Sequence[Tensor], dtype=None
) -> Tuple[List[Tensor], List[Tensor]]:
    """Per level: logits (N, H*W*A) and deltas (N, H*W, A*4), f32, (H, W, A)
    order. Objectness and deltas run as one 1x1 conv with concatenated output
    channels (bit-identical to two convs: output channels are independent)."""
    a = head.objectness.weight.shape[0]
    w = torch.cat([head.objectness.weight, head.deltas.weight], 0)
    b = torch.cat([head.objectness.bias, head.deltas.bias], 0)
    logits, deltas = [], []
    for f in features:
        t = torch.relu(conv2d(f, head.conv.weight, head.conv.bias, 1, 1, dtype))
        od = conv2d(t, w, b, 1, 0, dtype).permute(0, 2, 3, 1)  # NHWC view
        n, h, wd, _ = od.shape
        logits.append(od[..., :a].reshape(n, -1).float())
        deltas.append(od[..., a:].reshape(n, h * wd, -1).float())
    return logits, deltas


def gather_deltas(deltas_hw: Tensor, idx: Tensor) -> Tensor:
    """(B, H*W, A*4) head layout + (B, k) flat (H, W, A) indices -> (B, k, 4)."""
    a = deltas_hw.shape[-1] // 4
    rows = torch.gather(deltas_hw, 1, (idx // a)[..., None].expand(-1, -1, 4 * a))
    rows = rows.reshape(idx.shape + (a, 4))
    return torch.gather(rows, 2, (idx % a)[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]


def find_top_proposals(
    logits: Sequence[Tensor],  # per level (B, HWA)
    deltas: Sequence[Tensor],  # per level (B, HW, A*4)
    anchors: Sequence[Tensor],  # per level (HWA, 4)
    image_sizes: Tensor,  # (B, 2) true (h, w)
    pre_nms_topk: int,
    post_nms_topk: int,
    nms_thresh: float,
    min_box_side_len: float = 0.0,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Batched ``find_top_proposals``: (boxes (B, P, 4), scores (B, P),
    valid (B, P)) with P = post_nms_topk."""
    h = image_sizes[:, 0:1].to(torch.float32)
    w = image_sizes[:, 1:2].to(torch.float32)
    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    for lg, dl, an in zip(logits, deltas, anchors):
        k = min(pre_nms_topk, lg.shape[1])
        top_scores, top_idx = topk_stable(lg, k)
        boxes = apply_deltas(gather_deltas(dl, top_idx), an[top_idx])
        boxes = clip_boxes(boxes, (h, w))
        lvl_boxes.append(boxes)
        lvl_scores.append(top_scores)
        lvl_valid.append(nonempty_boxes(boxes, min_box_side_len))

    # every (image, level) NMS as one batch; levels padded to a common k with
    # invalid slots, which sort last and never suppress
    kmax = max(s.shape[1] for s in lvl_scores)

    def stack(ts):
        out = ts[0].new_zeros((ts[0].shape[0], len(ts), kmax) + ts[0].shape[2:])
        for i, t in enumerate(ts):
            out[:, i, : t.shape[1]] = t
        return out

    keep = nms_mask(stack(lvl_boxes), stack(lvl_scores), stack(lvl_valid), nms_thresh)
    kept_scores = torch.cat(
        [
            torch.where(keep[:, i, : s.shape[1]], s, float("-inf"))
            for i, s in enumerate(lvl_scores)
        ],
        1,
    )
    all_boxes = torch.cat(lvl_boxes, 1)
    final_scores, final_idx = topk_stable(kept_scores, post_nms_topk)
    final_valid = torch.isfinite(final_scores)
    final_idx = torch.where(final_valid, final_idx, 0)
    boxes = torch.gather(all_boxes, 1, final_idx[..., None].expand(-1, -1, 4))
    return boxes, torch.where(final_valid, final_scores, 0.0), final_valid


def label_anchors_idx(
    anchors: Tensor,  # (R, 4) all levels concatenated
    gt_boxes: Tensor,  # (B, G, 4)
    gt_valid: Tensor,  # (B, G)
    iou_thresholds: Tuple[float, float] = (0.3, 0.7),
) -> Tuple[Tensor, Tensor]:
    """Per-anchor labels (1 fg, 0 bg, -1 ignore) and matched gt index, both
    (B, R), with low-quality matches forced positive."""
    iou = pairwise_iou(gt_boxes, anchors)  # (B, G, R)
    matched_idx, labels = match(
        iou, gt_valid, list(iou_thresholds), [0, -1, 1], allow_low_quality_matches=True
    )
    return labels.to(torch.int32), matched_idx


def rpn_losses(
    logits: Sequence[Tensor],  # per level (B, HWA)
    deltas: Sequence[Tensor],  # per level (B, HW, A*4)
    anchors: Sequence[Tensor],  # per level (HWA, 4)
    gt_boxes: Tensor,  # (B, G, 4)
    gt_valid: Tensor,  # (B, G)
    generator: Draws,
    cfg: RPNConfig,
) -> Dict[str, Tensor]:
    """Per-image RPN losses, each (B,): objectness BCE over the sampled
    anchors and smooth-L1 box regression over the sampled positives, both
    normalized by ``batch_size_per_image``; the caller averages over
    images. The anchors are sampled to a fixed index set, positives first,
    so the targets are computed for the sampled rows only."""
    cat_logits = torch.cat(list(logits), 1)
    cat_deltas = torch.cat(list(deltas), 1)
    cat_anchors = torch.cat(list(anchors), 0)
    labels, matched_idx = label_anchors_idx(cat_anchors, gt_boxes, gt_valid, cfg.iou_thresholds)
    normalizer = float(cfg.batch_size_per_image)
    sel, pos_s, sampled_s = sample_topk_indices(
        labels, cfg.batch_size_per_image, cfg.positive_fraction, generator
    )

    sel_logits = torch.gather(cat_logits, 1, sel)
    targets = pos_s.to(sel_logits.dtype)
    per_anchor = (sel_logits.clamp(min=0) - sel_logits * targets
                  + torch.log1p(torch.exp(-sel_logits.abs())))
    loss_cls = torch.where(sampled_s, per_anchor, 0.0).sum(-1) / normalizer

    matched = take_rows(gt_boxes, torch.gather(matched_idx, 1, sel))
    gt_deltas = get_deltas(cat_anchors[sel], matched)
    diff = gather_deltas(cat_deltas, sel) - gt_deltas
    per_coord = smooth_l1(diff, cfg.smooth_l1_beta)
    loss_loc = torch.where(pos_s[..., None], per_coord, 0.0).sum((-2, -1)) / normalizer
    return {
        "loss_rpn_cls": loss_cls * cfg.loss_weight,
        "loss_rpn_loc": loss_loc * cfg.loss_weight,
    }
