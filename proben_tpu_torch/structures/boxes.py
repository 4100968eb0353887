"""Box ops on plain ``(..., 4)`` XYXY tensors (counterpart of
``proben_tpu/structures/boxes.py``). Same arithmetic in the same order as
the JAX functions, so thresholds compare identical floats; every function
also takes leading batch dimensions."""

from __future__ import annotations

import enum
from typing import Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor
Size = Union[int, float, Tensor]


class BoxMode(enum.IntEnum):
    """Coordinate conventions (``proben_tpu/structures/boxes.py:21``)."""

    XYXY_ABS = 0
    XYWH_ABS = 1
    XYXY_REL = 2
    XYWH_REL = 3


def convert_box_mode(box, from_mode: BoxMode, to_mode: BoxMode):
    """Convert (..., 4) boxes, numpy arrays or tensors, between XYXY_ABS and
    XYWH_ABS (the modes the pipeline uses)."""
    if from_mode == to_mode:
        return box
    stack = torch.stack if torch.is_tensor(box) else np.stack
    if from_mode == BoxMode.XYWH_ABS and to_mode == BoxMode.XYXY_ABS:
        x, y, w, h = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
        return stack([x, y, x + w, y + h], -1)
    if from_mode == BoxMode.XYXY_ABS and to_mode == BoxMode.XYWH_ABS:
        x1, y1, x2, y2 = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
        return stack([x1, y1, x2 - x1, y2 - y1], -1)
    raise NotImplementedError(f"conversion {from_mode} -> {to_mode}")


def box_area(boxes: Tensor) -> Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def clip(x: Tensor, lo: Size, hi: Size) -> Tensor:
    """``jnp.clip``: minimum(maximum(x, lo), hi), NaN propagating. A number
    bound stays a scalar (``torch.export`` keeps no tensor constant for it)."""
    if isinstance(lo, Tensor):
        x = torch.maximum(x, lo.to(x.device, x.dtype))
    else:
        x = torch.clamp(x, min=lo)
    if isinstance(hi, Tensor):
        return torch.minimum(x, hi.to(x.device, x.dtype))
    return torch.clamp(x, max=hi)


def clip_boxes(boxes: Tensor, image_size: Tuple[Size, Size]) -> Tensor:
    """Clip XYXY boxes to [0, W] x [0, H]. ``image_size`` is (H, W), numbers
    or tensors that broadcast against ``boxes[..., 0]``."""
    h, w = image_size
    return torch.stack(
        [
            clip(boxes[..., 0], 0, w),
            clip(boxes[..., 1], 0, h),
            clip(boxes[..., 2], 0, w),
            clip(boxes[..., 3], 0, h),
        ],
        dim=-1,
    )


def nonempty_boxes(boxes: Tensor, threshold: float = 0.0) -> Tensor:
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    return (widths > threshold) & (heights > threshold)


def pairwise_intersection(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) intersection areas."""
    iw = torch.minimum(boxes1[..., :, None, 2], boxes2[..., None, :, 2]) - torch.maximum(
        boxes1[..., :, None, 0], boxes2[..., None, :, 0]
    )
    ih = torch.minimum(boxes1[..., :, None, 3], boxes2[..., None, :, 3]) - torch.maximum(
        boxes1[..., :, None, 1], boxes2[..., None, :, 1]
    )
    return iw.clamp(min=0) * ih.clamp(min=0)


def pairwise_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU; 0 (never NaN) for a
    degenerate pair."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    inter = pairwise_intersection(boxes1, boxes2)
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(inter > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def pairwise_ioa(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) intersection over the area
    of ``boxes2``; 0 for a pair that does not intersect."""
    area2 = box_area(boxes2)
    inter = pairwise_intersection(boxes1, boxes2)
    return torch.where(inter > 0, inter / torch.where(area2 > 0, area2, 1.0)[..., None, :], 0.0)


def box_centers(boxes: Tensor) -> Tensor:
    """Centres (cx, cy) of XYXY boxes: (..., 4) -> (..., 2)."""
    return torch.stack([(boxes[..., 0] + boxes[..., 2]) * 0.5, (boxes[..., 1] + boxes[..., 3]) * 0.5], -1)
