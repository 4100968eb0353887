"""Box delta codec (counterpart of ``proben_tpu/ops/box_transform.py``).
RoI-head weights are (10, 10, 5, 5), RPN weights (1, 1, 1, 1)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

# log(1000 / 16): clamp for predicted dw/dh so exp() cannot overflow
SCALE_CLAMP = math.log(1000.0 / 16.0)


def get_deltas(
    src_boxes: torch.Tensor,  # (..., 4)
    target_boxes: torch.Tensor,  # (..., 4)
    weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Encode target boxes relative to source boxes; (..., 4). Boxes of
    non-positive width or height divide by 1 instead, so padded slots stay
    finite; callers mask those slots out."""
    sw = src_boxes[..., 2] - src_boxes[..., 0]
    sh = src_boxes[..., 3] - src_boxes[..., 1]
    sx = src_boxes[..., 0] + 0.5 * sw
    sy = src_boxes[..., 1] + 0.5 * sh
    tw = target_boxes[..., 2] - target_boxes[..., 0]
    th = target_boxes[..., 3] - target_boxes[..., 1]
    tx = target_boxes[..., 0] + 0.5 * tw
    ty = target_boxes[..., 1] + 0.5 * th
    sw_safe = torch.where(sw > 0, sw, 1.0)
    sh_safe = torch.where(sh > 0, sh, 1.0)
    tw_safe = torch.where(tw > 0, tw, 1.0)
    th_safe = torch.where(th > 0, th, 1.0)
    wx, wy, ww, wh = weights
    dx = wx * (tx - sx) / sw_safe
    dy = wy * (ty - sy) / sh_safe
    dw = ww * torch.log(tw_safe / sw_safe)
    dh = wh * torch.log(th_safe / sh_safe)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def apply_deltas(
    deltas: torch.Tensor,  # (..., K*4)
    boxes: torch.Tensor,  # (..., 4)
    weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
    scale_clamp: float = SCALE_CLAMP,
) -> torch.Tensor:
    """Decode deltas on top of boxes; returns boxes shaped like ``deltas``."""
    orig_shape = deltas.shape
    k4 = orig_shape[-1]
    if k4 % 4:
        raise ValueError(f"last dim of deltas must be a multiple of 4, got {k4}")
    deltas = deltas.reshape(orig_shape[:-1] + (k4 // 4, 4))
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = (boxes[..., 0] + 0.5 * widths)[..., None]
    ctr_y = (boxes[..., 1] + 0.5 * heights)[..., None]
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=scale_clamp)
    dh = (deltas[..., 3] / wh).clamp(max=scale_clamp)

    pred_ctr_x = dx * widths[..., None] + ctr_x
    pred_ctr_y = dy * heights[..., None] + ctr_y
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]
    out = torch.stack(
        [
            pred_ctr_x - 0.5 * pred_w,
            pred_ctr_y - 0.5 * pred_h,
            pred_ctr_x + 0.5 * pred_w,
            pred_ctr_y + 0.5 * pred_h,
        ],
        dim=-1,
    )
    return out.reshape(orig_shape)
