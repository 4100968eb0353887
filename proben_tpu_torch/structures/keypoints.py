"""Keypoint heatmap codecs (counterpart of
``proben_tpu/structures/keypoints.py``; reference
``detectron2/structures/keypoints.py:82,142``).

Keypoints are (N, K, 3) tensors (x, y, visibility); the codecs convert
between keypoint coordinates and per-RoI heatmaps for a keypoint head."""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def keypoints_to_heatmap(
    keypoints: Tensor,  # (N, K, 3)
    boxes: Tensor,  # (N, 4) XYXY
    heatmap_size: int,
) -> Tuple[Tensor, Tensor]:
    """(heatmap indices (N, K) int32 into S*S, valid (N, K) bool): the
    training-target encoding (reference :82)."""
    x1, y1 = boxes[:, 0:1], boxes[:, 1:2]
    sw = heatmap_size / (boxes[:, 2:3] - x1).clamp(min=1e-6)
    sh = heatmap_size / (boxes[:, 3:4] - y1).clamp(min=1e-6)
    x = (keypoints[..., 0] - x1) * sw
    y = (keypoints[..., 1] - y1) * sh
    xi = x.floor().clamp(0, heatmap_size - 1).to(torch.int32)
    yi = y.floor().clamp(0, heatmap_size - 1).to(torch.int32)
    inside = (x >= 0) & (x < heatmap_size) & (y >= 0) & (y < heatmap_size)
    valid = inside & (keypoints[..., 2] > 0)
    return yi * heatmap_size + xi, valid


def heatmaps_to_keypoints(
    heatmaps: Tensor,  # (N, K, S, S) predicted logits
    boxes: Tensor,  # (N, 4)
) -> Tensor:
    """Heatmap argmax decoded to (N, K, 3) keypoints (x, y, score), the
    score the softmax's maximum (reference :142)."""
    n, k, s, _ = heatmaps.shape
    flat = heatmaps.reshape(n, k, -1)
    idx = flat.argmax(-1)
    score = flat.softmax(-1).amax(-1)
    yi = torch.div(idx, s, rounding_mode="floor").to(torch.float32) + 0.5
    xi = (idx % s).to(torch.float32) + 0.5
    x1, y1 = boxes[:, 0:1], boxes[:, 1:2]
    bw = (boxes[:, 2:3] - x1).clamp(min=1e-6)
    bh = (boxes[:, 3:4] - y1).clamp(min=1e-6)
    return torch.stack([x1 + xi / s * bw, y1 + yi / s * bh, score], -1)
