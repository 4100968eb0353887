"""StandardROIHeads (counterpart of ``proben_tpu/models/roi_heads.py``),
batched over images: proposal labeling and sampling for training, and box
head + output layers + decoding on already pooled features."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn as nn

from ..ops.matcher import match
from ..ops.roi_align_cuda import multilevel_roi_align
from ..ops.sampling import Draws, sample_topk_indices
from ..structures.boxes import pairwise_iou
from ..structures.detections import Detections, GroundTruth
from .box_head import BoxHead, OutputLayers, apply_box_head, apply_output_layers
from .fast_rcnn import FastRCNNConfig, fast_rcnn_inference, take_rows


@dataclasses.dataclass(frozen=True)
class ROIHeadsConfig:
    """Proposal sampling and pooler hyperparameters."""

    num_classes: int = 3
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    iou_threshold: float = 0.5
    pooler_resolution: int = 7
    pooler_sampling_ratio: int = 0
    in_strides: Tuple[int, ...] = (4, 8, 16, 32)  # p2..p5
    canonical_box_size: float = 224.0
    canonical_level: int = 4
    # exact whole-map re-pooling capacity (per image) for out-of-window RoIs
    fallback_capacity: int = 32

    @property
    def pooler_args(self) -> dict:
        """Keyword arguments of ``roi_align_cuda.window_inputs`` (and of
        ``multilevel_roi_align``) for the p2..p5 pooler."""
        return dict(
            strides=self.in_strides, output_size=self.pooler_resolution,
            sampling_ratio=self.pooler_sampling_ratio, min_level=2,
            canonical_box_size=self.canonical_box_size, canonical_level=self.canonical_level,
        )


class ROIHeads(nn.Module):
    def __init__(self, in_channels: int, pooler_resolution: int, num_classes: int,
                 enable_variance: bool):
        super().__init__()
        self.box_head = BoxHead(in_channels, pooler_resolution)
        self.output = OutputLayers(num_classes=num_classes, enable_variance=enable_variance)


def label_and_sample_proposals(
    proposal_boxes: torch.Tensor,  # (B, P, 4)
    proposal_valid: torch.Tensor,  # (B, P)
    gt: GroundTruth,  # batched (B, G)
    generator: Draws,
    cfg: ROIHeadsConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gt boxes are appended to the proposals, matched at
    ``iou_threshold`` (IoU masked to the valid slots) and sampled to
    ``batch_size_per_image`` rows with ``positive_fraction`` foreground,
    positives first. Returns (sampled_boxes (B, S, 4), gt_classes (B, S)
    with background = ``num_classes``, sampled_gt_boxes (B, S, 4),
    sampled_valid (B, S), sampled_is_fg (B, S))."""
    boxes = torch.cat([proposal_boxes, gt.boxes], 1)  # (B, P+G, 4)
    valid = torch.cat([proposal_valid, gt.valid], 1)
    iou = torch.where(valid[:, None, :], pairwise_iou(gt.boxes, boxes), 0.0)  # (B, G, P+G)
    matched_idx, matched_labels = match(iou, gt.valid, [cfg.iou_threshold], [0, 1])

    has_gt = gt.valid.any(-1, keepdim=True)
    fg = (matched_labels == 1) & valid & has_gt
    bg = (matched_labels == 0) & valid
    labels = torch.where(fg, 1, torch.where(bg, 0, -1))
    idx, is_pos, sampled_valid = sample_topk_indices(
        labels, cfg.batch_size_per_image, cfg.positive_fraction, generator
    )
    sampled_matched = torch.gather(matched_idx, 1, idx)
    gt_classes = torch.where(is_pos, torch.gather(gt.classes, 1, sampled_matched), cfg.num_classes)
    gt_classes = torch.where(sampled_valid, gt_classes, cfg.num_classes)
    return (take_rows(boxes, idx), gt_classes, take_rows(gt.boxes, sampled_matched),
            sampled_valid, is_pos)


def pool_box_features(
    levels: List[torch.Tensor],  # p2..p5 (B, H_l, W_l, C), contiguous NHWC
    boxes: torch.Tensor,  # (B, K, 4)
    cfg: ROIHeadsConfig,
    impl: str = "kernel",
) -> torch.Tensor:
    """(B, K, P, P, C) pooled features (JAX ``pool_box_features``): K2 and K3
    on the card with ``impl="kernel"``."""
    return multilevel_roi_align(levels, boxes, **cfg.pooler_args,
                                fallback_capacity=cfg.fallback_capacity, impl=impl)


def roi_heads_predict_from_pooled(
    roi: ROIHeads,
    pooled: torch.Tensor,  # (B, K, P, P, C)
    proposal_boxes: torch.Tensor,  # (B, K, 4)
    proposal_valid: torch.Tensor,  # (B, K)
    image_sizes: torch.Tensor,  # (B, 2)
    rcnn_cfg: FastRCNNConfig,
    dtype=None,
) -> Detections:
    x = apply_box_head(roi.box_head, pooled, dtype=dtype)
    logits, deltas, variance = apply_output_layers(roi.output, x)
    return fast_rcnn_inference(
        logits, deltas, proposal_boxes, proposal_valid, image_sizes, rcnn_cfg, variance
    )
