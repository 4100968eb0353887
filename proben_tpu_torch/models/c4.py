"""C4 Faster R-CNN (counterpart of ``proben_tpu/models/c4.py``; reference
``Base-RCNN-C4.yaml``, ``Res5ROIHeads``): a ResNet through res4, the RPN on
the single res4 map (stride 16, 15 anchors per cell), RoIs pooled at 14x14
from res4 (kernel K2 at P = 14 on the card, K3 in its backward), the res5
stage run on every RoI, the global average pool and the box predictor.

Batched over images like the port's other heads (JAX vmaps one image).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from ..ops.roi_align_cuda import single_level_roi_align
from ..ops.sampling import Draws
from ..structures.detections import Detections, GroundTruth
from .anchors import multilevel_anchors
from .box_head import OutputLayers, apply_output_layers, init_output_layers
from .fast_rcnn import fast_rcnn_inference, fast_rcnn_losses
from .rcnn import ModelConfig, load_module, nhwc, preprocess
from .resnet import ResNet, _bottleneck, apply_resnet, init_resnet
from .roi_heads import label_and_sample_proposals
from .rpn import RPNHead, apply_rpn_head, find_top_proposals, init_rpn_head, rpn_losses

C4_ANCHOR_SIZES = ((32.0, 64.0, 128.0, 256.0, 512.0),)
C4_ASPECT_RATIOS = (0.5, 1.0, 2.0)
C4_STRIDE = 16
C4_POOLER_RESOLUTION = 14
NUM_ANCHORS = len(C4_ANCHOR_SIZES[0]) * len(C4_ASPECT_RATIOS)


class RCNNC4(nn.Module):
    """All parameters; names mirror ``init_rcnn_c4``'s pytree keys. The
    backbone keeps its res5 stage, which runs on the pooled RoIs."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet(cfg.depth, in_channels=cfg.num_in_channels)
        self.rpn_head = RPNHead(1024, NUM_ANCHORS)
        self.roi = nn.ModuleDict({"output": OutputLayers(
            in_dim=2048, num_classes=cfg.num_classes, enable_variance=cfg.enable_gaussian_nll)})


def init_rcnn_c4(seed: int, cfg: ModelConfig) -> Dict:
    """The port's random init in ``proben_tpu``'s C4 layout (numpy)."""
    rng = np.random.default_rng(seed)
    return {
        "backbone": init_resnet(rng, cfg.depth, in_channels=cfg.num_in_channels),
        "rpn_head": init_rpn_head(rng, 1024, NUM_ANCHORS),
        "roi": {"output": init_output_layers(rng, in_dim=2048, num_classes=cfg.num_classes,
                                             enable_variance=cfg.enable_gaussian_nll)},
    }


def build_c4_model(cfg: ModelConfig, params: Optional[Dict] = None, seed: int = 0,
                   device: Union[str, torch.device] = "cuda") -> RCNNC4:
    """The C4 detector on ``device`` (default CUDA; raises without a GPU),
    with ``params`` or the port's random init from ``seed``."""
    return load_module(RCNNC4(cfg), init_rcnn_c4(seed, cfg) if params is None else params, device)


def _res4(model: RCNNC4, cfg: ModelConfig, images: torch.Tensor, freeze_at: int = 0):
    x = preprocess(cfg, images).contiguous().permute(0, 3, 1, 2)  # NCHW, channels_last
    return apply_resnet(model.backbone, x, dtype=cfg.dtype, stem_impl=cfg.stem_impl,
                        freeze_at=freeze_at, out_features=("res4",))["res4"]


def c4_anchors(res4: torch.Tensor) -> List[torch.Tensor]:
    return [torch.from_numpy(a).to(res4.device) for a in multilevel_anchors(
        [tuple(res4.shape[-2:])], [C4_STRIDE], C4_ANCHOR_SIZES, C4_ASPECT_RATIOS)]


def _res5(model: RCNNC4, pooled: torch.Tensor, dtype=None) -> torch.Tensor:
    """The res5 stage on pooled (B, K, 14, 14, 1024) features -> the average
    pool (B, K, 2048) f32, taken in f32 and rounded to the compute dtype as
    JAX's ``jnp.mean`` does."""
    b, k = pooled.shape[:2]
    h = pooled.reshape((b * k,) + pooled.shape[2:]).permute(0, 3, 1, 2)  # channels_last view
    for i, block in enumerate(model.backbone.res5):
        h = _bottleneck(block, h, 2 if i == 0 else 1, dtype)  # -> (B*K, 2048, 7, 7)
    return h.float().mean((2, 3)).to(h.dtype).float().reshape(b, k, -1)


def _pool(cfg: ModelConfig, res4: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    return single_level_roi_align(nhwc(res4), boxes, C4_STRIDE, C4_POOLER_RESOLUTION,
                                  cfg.roi.pooler_sampling_ratio, impl=cfg.roi_align_impl)


@torch.inference_mode()
def rcnn_c4_inference(
    model: RCNNC4,
    cfg: ModelConfig,
    images: torch.Tensor,  # (N, H, W, C) raw 0..255
    image_sizes: torch.Tensor,  # (N, 2) true (h, w)
) -> Detections:
    """Batched C4 inference; boxes in the model-input frame."""
    res4 = _res4(model, cfg, images)
    logits, deltas = apply_rpn_head(model.rpn_head, [res4], dtype=cfg.dtype)
    boxes, _, valid = find_top_proposals(
        logits, deltas, c4_anchors(res4), image_sizes, cfg.rpn.pre_nms_topk_test,
        cfg.rpn.post_nms_topk_test, cfg.rpn.nms_thresh, cfg.rpn.min_box_side_len,
    )
    vec = _res5(model, _pool(cfg, res4, boxes), cfg.dtype)
    cls_logits, box_deltas, variance = apply_output_layers(model.roi["output"], vec)
    return fast_rcnn_inference(cls_logits, box_deltas, boxes, valid, image_sizes, cfg.rcnn,
                               variance)


def rcnn_c4_train_losses(
    model: RCNNC4,
    cfg: ModelConfig,
    images: torch.Tensor,  # (N, H, W, C) raw 0..255
    image_sizes: torch.Tensor,  # (N, 2)
    gt: GroundTruth,  # batched (N, G)
    generator: Draws,
) -> Dict[str, torch.Tensor]:
    """Training losses, each the mean over images: the RPN's, then the box
    predictor's on the sampled RoIs (sampled with ``generator``, detached
    proposals), whose 14x14 pooling differentiates through K3 on the card."""
    res4 = _res4(model, cfg, images, cfg.freeze_at)
    logits, deltas = apply_rpn_head(model.rpn_head, [res4], dtype=cfg.dtype)
    anchors = c4_anchors(res4)
    losses = rpn_losses(logits, deltas, anchors, gt.boxes, gt.valid, generator, cfg.rpn)
    with torch.no_grad():
        boxes, _, valid = find_top_proposals(
            logits, deltas, anchors, image_sizes, cfg.rpn.pre_nms_topk_train,
            cfg.rpn.post_nms_topk_train, cfg.rpn.nms_thresh, cfg.rpn.min_box_side_len,
        )
    s_boxes, gt_classes, gt_boxes, s_valid, _ = label_and_sample_proposals(
        boxes, valid, gt, generator, cfg.roi)
    vec = _res5(model, _pool(cfg, res4, s_boxes), cfg.dtype)
    cls_logits, box_deltas, variance = apply_output_layers(model.roi["output"], vec)
    losses.update(fast_rcnn_losses(cls_logits, box_deltas, variance, s_boxes, gt_classes, s_valid,
                                   gt_boxes, cfg.rcnn))
    return {k: v.mean() for k, v in losses.items()}
