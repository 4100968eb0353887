"""GeneralizedRCNN inference and training losses (counterpart of
``proben_tpu/models/rcnn.py``).

Input formats: ``BGR`` (3-channel; thermal-only or RGB-only runs feed that
image), ``BGRT`` (4-channel early fusion: one backbone with a 4-channel stem)
and ``BGRTTT`` (middle fusion: the 6-channel input split into an RGB and a
thermal stream, each through its own ResNet-FPN, the per-level maps
concatenated along C, RGB first, before the RPN and the RoI heads).

Public tensors keep the JAX layout: images (N, H, W, C) raw 0..255, pooled
RoI features (N, K, P, P, C), batched ``Detections``. Internally feature
maps are NCHW in channels_last memory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..device import resolve_device
from ..ops.sampling import Draws
from ..structures.boxes import clip_boxes
from ..structures.detections import Detections, GroundTruth
from ..utils import tracing
from .anchors import multilevel_anchors
from .box_head import apply_box_head, apply_output_layers, init_box_head, init_output_layers
from .fast_rcnn import FastRCNNConfig, fast_rcnn_losses
from .fpn import FPN, FPN_STRIDES, apply_fpn, init_fpn
from .gaussian_blur import gaussian_blur
from .layers import max_pool
from .resnet import STAGE_OUT_CHANNELS, ResNet, apply_resnet, init_resnet
from .roi_heads import (
    ROIHeads,
    ROIHeadsConfig,
    label_and_sample_proposals,
    pool_box_features,
    roi_heads_predict_from_pooled,
)
from .rpn import (
    RPNConfig,
    RPNHead,
    apply_rpn_head,
    find_top_proposals,
    init_rpn_head,
    rpn_losses,
)

RPN_IN_FEATURES = ("p2", "p3", "p4", "p5", "p6")
ROI_IN_FEATURES = ("p2", "p3", "p4", "p5")
ANCHOR_SIZES = ((32.0,), (64.0,), (128.0,), (256.0,), (512.0,))
ANCHOR_ASPECT_RATIOS = (0.5, 1.0, 2.0)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters (the MODEL.* keys the ProbEn path uses)."""

    depth: int = 50
    input_format: str = "BGR"  # BGR | BGRT | BGRTTT
    num_classes: int = 3
    pixel_mean: Tuple[float, ...] = (103.53, 116.28, 123.675)
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    freeze_at: int = 2  # training: 1 freezes the stem, 2 also res2, ...
    fpn_channels: int = 256
    enable_gaussian_nll: bool = False
    compute_dtype: str = "float32"  # "bfloat16" for tensor-core speed
    # "kernel": the hand-written CUDA kernels on CUDA tensors (their plain
    # versions on CPU tensors); "plain": the PyTorch compositions everywhere
    roi_align_impl: str = "kernel"
    stem_impl: str = "kernel"
    # BGRTTT at inference: the thermal stream through ``backbone``/``fpn``
    # (the reference's eval-time quirk, for bug-parity experiments)
    middle_fusion_inference_shares_backbone: bool = False
    # BGRTTT training-only ablations (reference MODEL.BLUR_RGB / MAX_POOL_RGB)
    blur_rgb: bool = False
    max_pool_rgb: bool = False
    # training: recompute each backbone block in the backward (memory only)
    remat_backbone: bool = False
    rpn: RPNConfig = dataclasses.field(default_factory=RPNConfig)
    roi: ROIHeadsConfig = dataclasses.field(default_factory=ROIHeadsConfig)
    rcnn: FastRCNNConfig = dataclasses.field(default_factory=FastRCNNConfig)

    @property
    def num_in_channels(self) -> int:
        return {"BGR": 3, "BGRT": 4, "BGRTTT": 6}[self.input_format]

    @property
    def dual(self) -> bool:
        """Middle fusion: two 3-channel backbones."""
        return self.input_format == "BGRTTT"

    @property
    def head_in_channels(self) -> int:
        return self.fpn_channels * (2 if self.dual else 1)

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def build_config(**kw) -> ModelConfig:
    """ModelConfig with ``num_classes`` and ``enable_gaussian_nll`` threaded
    into the sub-configs."""
    num_classes = kw.pop("num_classes", 3)
    enable_gnll = kw.pop("enable_gaussian_nll", False)
    rcnn = kw.pop("rcnn", FastRCNNConfig(num_classes=num_classes, enable_gaussian_nll=enable_gnll))
    roi = kw.pop("roi", ROIHeadsConfig(num_classes=num_classes))
    return ModelConfig(num_classes=num_classes, enable_gaussian_nll=enable_gnll, rcnn=rcnn, roi=roi,
                       **kw)


class RCNN(nn.Module):
    """All parameters of the detector; module names mirror ``init_rcnn``'s
    pytree keys, so a JAX pytree maps onto ``state_dict`` names directly."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet(cfg.depth, in_channels=3 if cfg.dual else cfg.num_in_channels)
        self.fpn = FPN(STAGE_OUT_CHANNELS, cfg.fpn_channels)
        self.rpn_head = RPNHead(cfg.head_in_channels, len(ANCHOR_ASPECT_RATIOS))
        self.roi = ROIHeads(cfg.head_in_channels, cfg.roi.pooler_resolution, cfg.num_classes,
                            cfg.enable_gaussian_nll)
        if cfg.dual:
            self.backbone_2 = ResNet(cfg.depth, in_channels=3)
            self.fpn_2 = FPN(STAGE_OUT_CHANNELS, cfg.fpn_channels)


def init_rcnn(seed: int, cfg: ModelConfig) -> Dict:
    """The port's own random init, as a pytree of numpy arrays in
    ``proben_tpu``'s layout (the same distribution families as its
    ``init_rcnn``; the draws differ). Load it with ``build_model``."""
    rng = np.random.default_rng(seed)
    params = {
        "backbone": init_resnet(rng, cfg.depth, in_channels=3 if cfg.dual else cfg.num_in_channels),
        "fpn": init_fpn(rng, STAGE_OUT_CHANNELS, cfg.fpn_channels),
        "rpn_head": init_rpn_head(rng, cfg.head_in_channels, len(ANCHOR_ASPECT_RATIOS)),
        "roi": {
            "box_head": init_box_head(rng, cfg.head_in_channels, cfg.roi.pooler_resolution),
            "output": init_output_layers(rng, num_classes=cfg.num_classes,
                                         enable_variance=cfg.enable_gaussian_nll),
        },
    }
    if cfg.dual:
        params["backbone_2"] = init_resnet(rng, cfg.depth, in_channels=3)
        params["fpn_2"] = init_fpn(rng, STAGE_OUT_CHANNELS, cfg.fpn_channels)
    return params


def random_affines(params: Dict, seed: int) -> Dict:
    """``params`` with every folded-BN affine drawn at random, as a trained
    checkpoint holds them: scale U(0.5, 1.5) (``norm3``: U(0.1, 0.3)), bias
    U(-0.1, 0.1). ``init_rcnn``'s identity affines and zero ``norm3`` (a
    training init) would leave every residual branch out of the output."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if not isinstance(node, dict):
            return node
        if set(node) == {"scale", "bias"}:
            lo, hi = (0.1, 0.3) if name == "norm3" else (0.5, 1.5)
            n = node["scale"].shape
            return {"scale": rng.uniform(lo, hi, n).astype(np.float32),
                    "bias": rng.uniform(-0.1, 0.1, n).astype(np.float32)}
        return {k: walk(v, k) for k, v in node.items()}

    return walk(params)


def build_model(
    cfg: ModelConfig,
    params: Optional[Dict] = None,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> RCNN:
    """The detector on ``device`` (default CUDA; raises without a GPU), with
    ``params`` (a numpy pytree in ``proben_tpu``'s layout) or the port's
    random init from ``seed``."""
    if params is None:
        params = init_rcnn(seed, cfg)
    return load_module(RCNN(cfg), params, device)


def load_module(module: nn.Module, params: Dict, device: Union[str, torch.device] = "cuda"):
    """``module`` with the numpy pytree ``params`` (``proben_tpu``'s layout,
    names as the module's), on ``device`` (CUDA raises without a GPU), in
    eval mode."""
    from ..checkpoint.from_jax import state_dict_from_jax

    device = resolve_device(device)
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module.to(device).eval()


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def preprocess(cfg: ModelConfig, images: torch.Tensor) -> torch.Tensor:
    """Normalize raw (N, H, W, C) images (0..255, BGR[+T]) -> f32 (N, H, W, C).
    Config vectors shorter than C are padded with their last entry. BGRTTT
    uses the reference's split normalizers: RGB channels ``pixel_mean[:3]``,
    thermal channels ``pixel_mean[3:6]``, both the shared ``pixel_std[:3]``."""

    def fit(vals):
        vals = list(vals)
        vals = vals + [vals[-1]] * (cfg.num_in_channels - len(vals))
        return torch.tensor(vals[: cfg.num_in_channels], dtype=torch.float32, device=images.device)

    std = list(cfg.pixel_std[:3]) * 2 if cfg.dual else cfg.pixel_std
    return (images.to(torch.float32) - fit(cfg.pixel_mean)) / fit(std)


def _stream(backbone: ResNet, fpn: FPN, cfg: ModelConfig, images: torch.Tensor,
            training: bool) -> Dict[str, torch.Tensor]:
    x = images.contiguous().permute(0, 3, 1, 2)  # NCHW view, channels_last memory
    feats = apply_resnet(backbone, x, dtype=cfg.dtype, stem_impl=cfg.stem_impl,
                         freeze_at=cfg.freeze_at if training else 0,
                         remat=cfg.remat_backbone and training)
    return apply_fpn(fpn, feats, dtype=cfg.dtype)


def extract_features(
    model: RCNN, cfg: ModelConfig, images: torch.Tensor, training: bool = False
) -> Dict[str, torch.Tensor]:
    """Backbone + FPN on normalized (N, H, W, C) images; NCHW channels_last
    maps p2..p6. ``training`` freezes the backbone(s) at ``cfg.freeze_at``
    (and recomputes their blocks in the backward with ``remat_backbone``).

    BGRTTT: channels 0-2 through ``backbone``/``fpn``, 3-5 through
    ``backbone_2``/``fpn_2`` (or ``backbone``/``fpn`` at inference with
    ``middle_fusion_inference_shares_backbone``), each stream with its own
    stem launch; in training the RGB maps may be blurred (p2-p4) and then
    max-pooled (every level); each level is the concat of the two streams
    along C, RGB first, still channels_last."""
    if not cfg.dual:
        return _stream(model.backbone, model.fpn, cfg, images, training)
    shared = not training and cfg.middle_fusion_inference_shares_backbone
    f_rgb = _stream(model.backbone, model.fpn, cfg, images[..., :3], training)
    f_t = _stream(model.backbone if shared else model.backbone_2,
                  model.fpn if shared else model.fpn_2, cfg, images[..., 3:], training)
    if training and cfg.blur_rgb:
        for k in ("p2", "p3", "p4"):
            f_rgb[k] = gaussian_blur(f_rgb[k], (5, 5), (3.0, 3.0))
    if training and cfg.max_pool_rgb:
        f_rgb = {k: max_pool(v, 3, 1, padding=1) for k, v in f_rgb.items()}
    return {k: torch.cat([f_rgb[k], f_t[k]], dim=1) for k in f_rgb}


def anchors_for(features: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    shapes = [tuple(features[f].shape[-2:]) for f in RPN_IN_FEATURES]
    strides = [FPN_STRIDES[f] for f in RPN_IN_FEATURES]
    dev = features[RPN_IN_FEATURES[0]].device
    return [
        torch.from_numpy(a).to(dev)
        for a in multilevel_anchors(shapes, strides, ANCHOR_SIZES, ANCHOR_ASPECT_RATIOS)
    ]


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) contiguous view of an NCHW channels_last map."""
    return x.permute(0, 2, 3, 1).contiguous()


def rpn_outputs(model: RCNN, cfg: ModelConfig, features: Dict[str, torch.Tensor]):
    """Per-level RPN logits and deltas."""
    return apply_rpn_head(model.rpn_head, [features[f] for f in RPN_IN_FEATURES], dtype=cfg.dtype)


def propose(
    model: RCNN, cfg: ModelConfig, features: Dict[str, torch.Tensor], image_sizes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RPN head, then per-level top-k, decode and NMS: (boxes (N, P, 4),
    scores (N, P), valid (N, P))."""
    logits, deltas = rpn_outputs(model, cfg, features)
    return find_top_proposals(
        logits, deltas, anchors_for(features), image_sizes,
        cfg.rpn.pre_nms_topk_test, cfg.rpn.post_nms_topk_test,
        cfg.rpn.nms_thresh, cfg.rpn.min_box_side_len,
    )


def roi_levels(features: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """The pooler's p2..p5 maps as contiguous (N, H, W, C)."""
    return [nhwc(features[f]) for f in ROI_IN_FEATURES]


def pool_proposals(
    cfg: ModelConfig, features: Dict[str, torch.Tensor], boxes: torch.Tensor
) -> torch.Tensor:
    """Multi-level RoIAlign of the proposals: (N, P, R, R, C)."""
    return pool_box_features(roi_levels(features), boxes, cfg.roi, cfg.roi_align_impl)


@torch.inference_mode()
def rcnn_inference(
    model: RCNN,
    cfg: ModelConfig,
    images: torch.Tensor,  # (N, H, W, C) raw 0..255
    image_sizes: torch.Tensor,  # (N, 2) true (h, w) before padding
) -> Detections:
    """Batched inference; Detections with a leading axis N, boxes in the
    model-input frame (``postprocess_boxes`` rescales them)."""
    with tracing.span("rcnn.features"):
        features = extract_features(model, cfg, preprocess(cfg, images))
    with tracing.span("rcnn.rpn"):
        boxes, _, valid = propose(model, cfg, features, image_sizes)
    with tracing.span("rcnn.roi_pool"):
        pooled = pool_proposals(cfg, features, boxes)
    with tracing.span("rcnn.box"):
        return roi_heads_predict_from_pooled(
            model.roi, pooled, boxes, valid, image_sizes, cfg.rcnn, dtype=cfg.dtype
        )


@torch.inference_mode()
def rcnn_inference_given_boxes(
    model: RCNN,
    cfg: ModelConfig,
    images: torch.Tensor,  # (N, H, W, C) raw 0..255
    boxes: torch.Tensor,  # (N, K, 4) XYXY in the model-input frame
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The box head on GIVEN boxes (the reference's
    ``GeneralizedRCNN.inference(..., detected_instances)``), as TTA uses it
    to score merged boxes: (probs (N, K, C+1) softmax with the background
    last, class logits (N, K, C+1), variance (N, K, 1) or None). No NMS, no
    box regression."""
    with tracing.span("rcnn.features"):
        features = extract_features(model, cfg, preprocess(cfg, images))
    with tracing.span("rcnn.roi_pool"):
        pooled = pool_proposals(cfg, features, boxes)
    with tracing.span("rcnn.box"):
        x = apply_box_head(model.roi.box_head, pooled, dtype=cfg.dtype)
        logits, _, variance = apply_output_layers(model.roi.output, x)
        logits = logits.float()
        return torch.softmax(logits, dim=-1), logits, variance


def rcnn_train_losses(
    model: RCNN,
    cfg: ModelConfig,
    images: torch.Tensor,  # (N, H, W, C) raw 0..255
    image_sizes: torch.Tensor,  # (N, 2)
    gt: GroundTruth,  # batched (N, G)
    generator: Draws,
) -> Dict[str, torch.Tensor]:
    """Training losses, each the mean over images of the per-image loss.
    The RPN anchors and then the RoIs are sampled with ``generator``; the
    proposals carry no gradient (the reference detaches them too); all
    images' sampled RoIs are pooled in one batched call, whose backward is
    kernel K3 on the card."""
    with tracing.span("rcnn.features"):
        features = extract_features(model, cfg, preprocess(cfg, images), training=True)
    with tracing.span("rcnn.rpn"):
        logits, deltas = rpn_outputs(model, cfg, features)
        anchors = anchors_for(features)
        losses = rpn_losses(logits, deltas, anchors, gt.boxes, gt.valid, generator, cfg.rpn)
        with torch.no_grad():
            boxes, _, valid = find_top_proposals(
                logits, deltas, anchors, image_sizes, cfg.rpn.pre_nms_topk_train,
                cfg.rpn.post_nms_topk_train, cfg.rpn.nms_thresh, cfg.rpn.min_box_side_len,
            )
        s_boxes, gt_classes, gt_boxes, s_valid, _ = label_and_sample_proposals(
            boxes, valid, gt, generator, cfg.roi
        )
    with tracing.span("rcnn.roi_pool"):
        pooled = pool_proposals(cfg, features, s_boxes)
    with tracing.span("rcnn.box"):
        x = apply_box_head(model.roi.box_head, pooled, dtype=cfg.dtype)
        cls_logits, box_deltas, variance = apply_output_layers(model.roi.output, x)
        losses.update(fast_rcnn_losses(cls_logits, box_deltas, variance, s_boxes, gt_classes, s_valid,
                                       gt_boxes, cfg.rcnn))
    return {k: v.mean() for k, v in losses.items()}


def postprocess_boxes(det: Detections, input_size, output_size) -> Detections:
    """Rescale boxes from the model-input frame to the original image frame
    (reference ``postprocessing.py:8`` detector_postprocess)."""
    in_h, in_w = input_size
    out_h, out_w = output_size
    sx = out_w / in_w
    sy = out_h / in_h
    scale = torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=det.boxes.device)
    return dataclasses.replace(det, boxes=clip_boxes(det.boxes * scale, (out_h, out_w)))
