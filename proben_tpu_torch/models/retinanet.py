"""RetinaNet one-stage detector (counterpart of
``proben_tpu/models/retinanet.py``; reference
``detectron2/modeling/meta_arch/retinanet.py:59``): ResNet-FPN p3-p7 (the
FPN over res3..res5 with no max-pool top block, P6/P7 convs on res5),
shared 4-conv class and box towers, focal loss and smooth-L1 in training,
per-level top-k then class-batched NMS at inference. The stem is kernel K1
on the card in bf16.

Maps are NCHW in channels_last memory; logits and deltas keep the JAX
(H, W, A) flatten order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.box_transform import apply_deltas, get_deltas
from ..ops.matcher import match
from ..ops.nms import batched_nms_mask
from ..ops.topk import topk_stable
from ..structures.boxes import clip_boxes, pairwise_iou
from ..structures.detections import Detections, GroundTruth
from .anchors import multilevel_anchors
from .fast_rcnn import smooth_l1, take_rows
from .fpn import FPN, apply_fpn, init_fpn
from .layers import Conv, conv2d, init_conv
from .rcnn import load_module
from .resnet import STAGE_OUT_CHANNELS, ResNet, apply_resnet, init_resnet

Tensor = torch.Tensor

RETINA_LEVELS = ("p3", "p4", "p5", "p6", "p7")
RETINA_STRIDES = {"p3": 8, "p4": 16, "p5": 32, "p6": 64, "p7": 128}
# per level: 3 octave scales x 3 aspect ratios = 9 anchors
RETINA_SIZES = tuple(
    tuple(base * (2 ** (o / 3.0)) for o in range(3))
    for base in (32.0, 64.0, 128.0, 256.0, 512.0)
)
RETINA_ASPECT_RATIOS = (0.5, 1.0, 2.0)
NUM_ANCHORS = len(RETINA_ASPECT_RATIOS) * 3


@dataclasses.dataclass(frozen=True)
class RetinaNetConfig:
    depth: int = 50
    num_classes: int = 3
    fpn_channels: int = 256
    num_convs: int = 4
    prior_prob: float = 0.01
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_beta: float = 0.1
    iou_thresholds: Tuple[float, float] = (0.4, 0.5)
    score_thresh: float = 0.05
    topk_candidates: int = 1000
    nms_thresh: float = 0.5
    topk_per_image: int = 100
    pixel_mean: Tuple[float, ...] = (103.53, 116.28, 123.675)
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    freeze_at: int = 2
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None


class RetinaHead(nn.Module):
    def __init__(self, c: int, num_classes: int, num_convs: int):
        super().__init__()
        self.cls_tower = nn.ModuleList(Conv(c, c, 3) for _ in range(num_convs))
        self.box_tower = nn.ModuleList(Conv(c, c, 3) for _ in range(num_convs))
        self.cls_score = Conv(c, NUM_ANCHORS * num_classes, 3)
        self.bbox_pred = Conv(c, NUM_ANCHORS * 4, 3)


class RetinaNet(nn.Module):
    """All parameters; names mirror ``init_retinanet``'s pytree keys."""

    def __init__(self, cfg: RetinaNetConfig):
        super().__init__()
        c = cfg.fpn_channels
        self.backbone = ResNet(cfg.depth)
        self.fpn = FPN(STAGE_OUT_CHANNELS[1:], c)
        self.p6 = Conv(STAGE_OUT_CHANNELS[-1], c, 3)
        self.p7 = Conv(c, c, 3)
        self.head = RetinaHead(c, cfg.num_classes, cfg.num_convs)


def init_retinanet(seed: int, cfg: RetinaNetConfig) -> Dict:
    """The port's random init in ``proben_tpu``'s layout (numpy), with the
    focal-loss prior bias on ``cls_score``."""
    rng = np.random.default_rng(seed)
    c = cfg.fpn_channels
    params: Dict = {
        "backbone": init_resnet(rng, cfg.depth),
        "fpn": init_fpn(rng, STAGE_OUT_CHANNELS[1:], c),
        "p6": init_conv(rng, 3, 3, STAGE_OUT_CHANNELS[-1], c),
        "p7": init_conv(rng, 3, 3, c, c),
    }
    cls_score = init_conv(rng, 3, 3, c, NUM_ANCHORS * cfg.num_classes, init_std=0.01)
    cls_score["b"] = np.full_like(cls_score["b"], -math.log((1 - cfg.prior_prob) / cfg.prior_prob))
    params["head"] = {
        "cls_tower": [init_conv(rng, 3, 3, c, c, init_std=0.01) for _ in range(cfg.num_convs)],
        "box_tower": [init_conv(rng, 3, 3, c, c, init_std=0.01) for _ in range(cfg.num_convs)],
        "cls_score": cls_score,
        "bbox_pred": init_conv(rng, 3, 3, c, NUM_ANCHORS * 4, init_std=0.01),
    }
    return params


def build_retinanet(cfg: RetinaNetConfig, params: Optional[Dict] = None, seed: int = 0,
                    device: Union[str, torch.device] = "cuda") -> RetinaNet:
    """RetinaNet on ``device`` (default CUDA; raises without a GPU), with
    ``params`` or the port's random init from ``seed``."""
    return load_module(RetinaNet(cfg), init_retinanet(seed, cfg) if params is None else params,
                       device)


def _features(model: RetinaNet, cfg: RetinaNetConfig, images: Tensor, training: bool) -> List[Tensor]:
    """p3..p7 (NCHW channels_last) of raw (N, H, W, 3) images."""
    dev = images.device
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=dev)
    x = ((images.to(torch.float32) - mean) / std).contiguous().permute(0, 3, 1, 2)
    dtype = cfg.dtype
    names = ("res3", "res4", "res5")
    bottom = apply_resnet(model.backbone, x, dtype=dtype, freeze_at=cfg.freeze_at if training else 0,
                          out_features=names)
    fpn = apply_fpn(model.fpn, bottom, in_features=names, top_block_maxpool=False, dtype=dtype)
    # apply_fpn names its outputs from p2, as JAX's does: p2..p4 are p3..p5
    p6 = conv2d(bottom["res5"], model.p6.weight, model.p6.bias, 2, 1, dtype)
    p7 = conv2d(torch.relu(p6), model.p7.weight, model.p7.bias, 2, 1, dtype)
    return [fpn["p2"], fpn["p3"], fpn["p4"], p6, p7]


def _head(model: RetinaNet, cfg: RetinaNetConfig, feats: List[Tensor]):
    """Per level: logits (N, H*W*A, K) and deltas (N, H*W*A, 4), f32."""
    head, dtype = model.head, cfg.dtype

    def tower(f, convs, out):
        t = f
        for conv in convs:
            t = torch.relu(conv2d(t, conv.weight, conv.bias, 1, 1, dtype))
        return conv2d(t, out.weight, out.bias, 1, 1, dtype).permute(0, 2, 3, 1)  # NHWC view

    logits, deltas = [], []
    for f in feats:
        n = f.shape[0]
        logits.append(tower(f, head.cls_tower, head.cls_score).reshape(n, -1, cfg.num_classes).float())
        deltas.append(tower(f, head.box_tower, head.bbox_pred).reshape(n, -1, 4).float())
    return logits, deltas


def _anchors(feats: List[Tensor]) -> List[Tensor]:
    shapes = [tuple(f.shape[-2:]) for f in feats]
    strides = [RETINA_STRIDES[name] for name in RETINA_LEVELS]
    return [torch.from_numpy(a).to(feats[0].device)
            for a in multilevel_anchors(shapes, strides, RETINA_SIZES, RETINA_ASPECT_RATIOS)]


@torch.inference_mode()
def retinanet_inference(
    model: RetinaNet, cfg: RetinaNetConfig, images: Tensor, image_sizes: Tensor
) -> Detections:
    """Batched inference: per level the ``topk_candidates`` best (anchor,
    class) sigmoid scores, decoded and clipped; candidates above
    ``score_thresh`` through class-batched NMS; the ``topk_per_image``
    best kept. Boxes in the model-input frame."""
    feats = _features(model, cfg, images, training=False)
    logits, deltas = _head(model, cfg, feats)
    hw = (image_sizes[:, 0:1].to(torch.float32), image_sizes[:, 1:2].to(torch.float32))
    k_cls = cfg.num_classes
    boxes, scores, classes = [], [], []
    for lg, dl, an in zip(logits, deltas, _anchors(feats)):
        flat = torch.sigmoid(lg).reshape(lg.shape[0], -1)
        top, idx = topk_stable(flat, min(cfg.topk_candidates, flat.shape[1]))
        box_idx = idx // k_cls
        boxes.append(clip_boxes(apply_deltas(take_rows(dl, box_idx), an[box_idx]), hw))
        scores.append(top)
        classes.append((idx % k_cls).to(torch.int32))
    boxes, scores, classes = torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(classes, 1)
    keep = batched_nms_mask(boxes, scores, classes, scores > cfg.score_thresh, cfg.nms_thresh)
    final, pos = topk_stable(torch.where(keep, scores, -1.0), cfg.topk_per_image)
    ok = final > 0
    pos = torch.where(ok, pos, 0)
    return Detections(
        boxes=torch.where(ok[..., None], take_rows(boxes, pos), 0.0),
        scores=torch.where(ok, final, 0.0),
        classes=torch.where(ok, torch.gather(classes, 1, pos), 0),
        valid=ok,
    )


def retinanet_losses(
    model: RetinaNet, cfg: RetinaNetConfig, images: Tensor, image_sizes: Tensor, gt: GroundTruth
) -> Dict[str, Tensor]:
    """Focal loss over the anchors that are not ignored and smooth-L1 (beta
    ``smooth_l1_beta``) over the foreground ones, both divided by the
    foreground count; anchors matched at ``iou_thresholds`` with
    low-quality matches forced positive. Each loss the mean over images."""
    feats = _features(model, cfg, images, training=True)
    logits, deltas = _head(model, cfg, feats)
    anchors = torch.cat(_anchors(feats))
    lg, dl = torch.cat(logits, 1), torch.cat(deltas, 1)  # (B, R, K), (B, R, 4)
    midx, mlabels = match(pairwise_iou(gt.boxes, anchors), gt.valid, list(cfg.iou_thresholds),
                          [0, -1, 1], True)
    fg = (mlabels == 1) & gt.valid.any(-1, keepdim=True)
    onehot = F.one_hot(torch.gather(gt.classes.long(), 1, midx), cfg.num_classes).float()
    onehot = onehot * fg[..., None]
    p = torch.sigmoid(lg)
    ce = lg.clamp(min=0) - lg * onehot + torch.log1p(torch.exp(-lg.abs()))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = cfg.focal_alpha * onehot + (1 - cfg.focal_alpha) * (1 - onehot)
    focal = alpha_t * (1 - p_t) ** cfg.focal_gamma * ce
    num_fg = fg.to(torch.float32).sum(-1).clamp(min=1.0)
    loss_cls = torch.where((mlabels >= 0)[..., None], focal, 0.0).sum((-2, -1)) / num_fg
    diff = dl - get_deltas(anchors, take_rows(gt.boxes, midx))
    loss_box = torch.where(fg[..., None], smooth_l1(diff, cfg.smooth_l1_beta), 0.0).sum((-2, -1))
    return {"loss_cls": loss_cls.mean(), "loss_box_reg": (loss_box / num_fg).mean()}
