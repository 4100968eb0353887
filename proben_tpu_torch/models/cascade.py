"""Cascade R-CNN RoI heads (counterpart of ``proben_tpu/models/cascade.py``;
reference ``modeling/roi_heads/cascade_rcnn.py:30``): three box-head stages
with rising IoU thresholds (0.5 / 0.6 / 0.7) and per-stage box-regression
weights, class-agnostic; each stage refines the previous stage's boxes, and
at inference the stages' class probabilities are averaged on the final
boxes.

Batched over images like the port's other heads (JAX's functions take one
image): features are the p2..p5 pooler levels (B, H_l, W_l, C), pooled by
K2 on the card (three launches per batch) with K3 in the backward (three
per training step).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from ..ops.box_transform import apply_deltas
from ..ops.sampling import Draws
from ..structures.boxes import clip_boxes
from ..structures.detections import Detections, GroundTruth
from .box_head import (
    BoxHead,
    OutputLayers,
    apply_box_head,
    apply_output_layers,
    init_box_head,
    init_output_layers,
)
from .fast_rcnn import FastRCNNConfig, fast_rcnn_inference, fast_rcnn_losses
from .rcnn import load_module
from .roi_heads import ROIHeadsConfig, label_and_sample_proposals, pool_box_features

Tensor = torch.Tensor

CASCADE_IOUS = (0.5, 0.6, 0.7)
CASCADE_WEIGHTS = (
    (10.0, 10.0, 5.0, 5.0),
    (20.0, 20.0, 10.0, 10.0),
    (30.0, 30.0, 15.0, 15.0),
)


class CascadeStage(nn.Module):
    def __init__(self, in_channels: int, pooler_resolution: int, num_classes: int):
        super().__init__()
        self.box_head = BoxHead(in_channels, pooler_resolution)
        self.output = OutputLayers(num_classes=num_classes, cls_agnostic_bbox_reg=True)


class CascadeROIHeads(nn.Module):
    """The three stages; names mirror ``init_cascade_roi_heads``'s pytree."""

    def __init__(self, in_channels: int = 256, num_classes: int = 3, pooler_resolution: int = 7):
        super().__init__()
        self.stages = nn.ModuleList(CascadeStage(in_channels, pooler_resolution, num_classes)
                                    for _ in CASCADE_IOUS)


def init_cascade_roi_heads(seed: int, in_channels: int = 256, num_classes: int = 3,
                           pooler_resolution: int = 7) -> Dict:
    """The port's random init in ``proben_tpu``'s layout (numpy)."""
    rng = np.random.default_rng(seed)
    return {"stages": [
        {"box_head": init_box_head(rng, in_channels, pooler_resolution),
         "output": init_output_layers(rng, num_classes=num_classes, cls_agnostic_bbox_reg=True)}
        for _ in CASCADE_IOUS
    ]}


def build_cascade_heads(params: Optional[Dict] = None, seed: int = 0, in_channels: int = 256,
                        num_classes: int = 3, pooler_resolution: int = 7,
                        device: Union[str, torch.device] = "cuda") -> CascadeROIHeads:
    """The heads on ``device`` (default CUDA; raises without a GPU), with
    ``params`` or the port's random init from ``seed``."""
    if params is None:
        params = init_cascade_roi_heads(seed, in_channels, num_classes, pooler_resolution)
    return load_module(CascadeROIHeads(in_channels, num_classes, pooler_resolution), params, device)


def _run_stage(stage: CascadeStage, levels: List[Tensor], boxes: Tensor, roi_cfg: ROIHeadsConfig,
               weights, image_sizes, dtype, impl: str):
    """A stage's class logits on ``boxes`` (B, R, 4) and its refined, clipped
    boxes (class-agnostic deltas)."""
    return _refine(stage, pool_box_features(levels, boxes, roi_cfg, impl), boxes, weights,
                   image_sizes, dtype)


def _refine(stage: CascadeStage, pooled: Tensor, boxes: Tensor, weights, image_sizes, dtype):
    """``_run_stage`` after the pooling: the box head on ``pooled``
    (B, R, P, P, C), then the logits and the refined, clipped boxes."""
    x = apply_box_head(stage.box_head, pooled, dtype=dtype)
    logits, deltas, _ = apply_output_layers(stage.output, x)
    return logits, clip_boxes(apply_deltas(deltas, boxes, weights), image_sizes)


def _size_bounds(image_sizes: Tensor):
    """(h, w) clip bounds (B, 1) from (B, 2) sizes."""
    return image_sizes[:, 0:1].to(torch.float32), image_sizes[:, 1:2].to(torch.float32)


@torch.inference_mode()
def cascade_inference(
    heads: CascadeROIHeads,
    levels: List[Tensor],  # p2..p5 (B, H_l, W_l, C)
    proposal_boxes: Tensor,  # (B, R, 4)
    proposal_valid: Tensor,  # (B, R)
    image_sizes: Tensor,  # (B, 2) true (h, w)
    roi_cfg: ROIHeadsConfig,
    rcnn_cfg: FastRCNNConfig,
    dtype=None,
    impl: str = "kernel",
) -> Detections:
    """The three stages in turn; the mean of their softmax probabilities on
    the final boxes, fed as log-probabilities (so the decode's softmax gives
    the mean back) with zero class-agnostic deltas to the Fast R-CNN
    decode."""
    boxes = proposal_boxes
    probs = []
    hw = _size_bounds(image_sizes)
    for stage, weights in zip(heads.stages, CASCADE_WEIGHTS):
        logits, boxes = _run_stage(stage, levels, boxes, roi_cfg, weights, hw, dtype, impl)
        probs.append(torch.softmax(logits, dim=-1))
    mean_logits = torch.log(torch.stack(probs).mean(0).clamp(min=1e-30))
    zero_deltas = torch.zeros(boxes.shape, dtype=torch.float32, device=boxes.device)
    cfg = dataclasses.replace(rcnn_cfg, cls_agnostic_bbox_reg=True)
    return fast_rcnn_inference(mean_logits, zero_deltas, boxes, proposal_valid, image_sizes, cfg)


def cascade_train_losses(
    heads: CascadeROIHeads,
    levels: List[Tensor],  # p2..p5 (B, H_l, W_l, C)
    proposal_boxes: Tensor,  # (B, R, 4), detached
    proposal_valid: Tensor,  # (B, R)
    gt: GroundTruth,  # batched (B, G)
    generator: Draws,
    roi_cfg: ROIHeadsConfig,
    rcnn_cfg: FastRCNNConfig,
    dtype=None,
    impl: str = "kernel",
) -> Dict[str, Tensor]:
    """Per-stage losses ``loss_cls_stage{i}`` / ``loss_box_reg_stage{i}``,
    each the mean over images. Stage i samples at ``CASCADE_IOUS[i]`` with
    ``generator``, regresses class-agnostically with ``CASCADE_WEIGHTS[i]``,
    then refines ALL current proposals (not just the sampled ones; clipped
    to [0, inf), as JAX clips to (inf, inf)) for the next stage, detached
    (JAX ``stop_gradient``: that pass adds no gradient, so it runs without
    autograd and K3 runs once per stage)."""
    losses: Dict[str, Tensor] = {}
    boxes, valid = proposal_boxes, proposal_valid
    unbounded = (float("inf"), float("inf"))
    for si, (stage, weights, iou) in enumerate(zip(heads.stages, CASCADE_WEIGHTS, CASCADE_IOUS)):
        stage_roi = dataclasses.replace(roi_cfg, iou_threshold=iou)
        s_boxes, gt_classes, gt_boxes, s_valid, _ = label_and_sample_proposals(
            boxes, valid, gt, generator, stage_roi)
        x = apply_box_head(stage.box_head, pool_box_features(levels, s_boxes, stage_roi, impl),
                           dtype=dtype)
        logits, deltas, _ = apply_output_layers(stage.output, x)
        cfg = dataclasses.replace(rcnn_cfg, cls_agnostic_bbox_reg=True, box_reg_weights=weights)
        stage_losses = fast_rcnn_losses(logits, deltas, None, s_boxes, gt_classes, s_valid,
                                        gt_boxes, cfg)
        for k, v in stage_losses.items():
            losses[f"{k}_stage{si}"] = v.mean()
        with torch.no_grad():
            _, boxes = _run_stage(stage, levels, boxes, stage_roi, weights, unbounded, dtype, impl)
    return losses
