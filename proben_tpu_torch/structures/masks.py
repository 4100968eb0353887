"""Mask structures (counterpart of ``proben_tpu/structures/masks.py``;
reference ``detectron2/structures/masks.py``: BitMasks / PolygonMasks) and
mask pasting (``layers/mask_ops.py`` paste_masks_in_image).

Polygons are rasterized on the host with cv2, imported inside
``PolygonMasks.rasterize`` as in the JAX package. ``paste_masks_in_image``
is the JAX package's gather formula in torch, on the tensors' own device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


class PolygonMasks:
    """List-of-polygons per instance, host-side (XYXY abs coordinates)."""

    def __init__(self, polygons: Sequence[Sequence[np.ndarray]]):
        self.polygons = [
            [np.asarray(p, np.float64).reshape(-1) for p in per_instance]
            for per_instance in polygons
        ]

    def __len__(self):
        return len(self.polygons)

    def rasterize(self, boxes: np.ndarray, mask_size: int) -> np.ndarray:
        """Crop+rasterize each instance's polygons inside its box to a
        (N, S, S) uint8 array (reference PolygonMasks.crop_and_resize)."""
        import cv2

        out = np.zeros((len(self), mask_size, mask_size), np.uint8)
        for i, (polys, box) in enumerate(zip(self.polygons, boxes)):
            x1, y1, x2, y2 = box
            w = max(x2 - x1, 0.1)
            h = max(y2 - y1, 0.1)
            canvas = np.zeros((mask_size, mask_size), np.uint8)
            for p in polys:
                pts = p.reshape(-1, 2).copy()
                pts[:, 0] = (pts[:, 0] - x1) * mask_size / w
                pts[:, 1] = (pts[:, 1] - y1) * mask_size / h
                cv2.fillPoly(canvas, [np.round(pts).astype(np.int32)], 1)
            out[i] = canvas
        return out

    def area(self) -> np.ndarray:
        """Shoelace area of each instance's polygons, summed."""
        areas = []
        for polys in self.polygons:
            a = 0.0
            for p in polys:
                pts = p.reshape(-1, 2)
                x, y = pts[:, 0], pts[:, 1]
                a += 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))
            areas.append(a)
        return np.asarray(areas)


class BitMasks:
    """(N, H, W) boolean masks: a numpy array or a tensor on any device."""

    def __init__(self, tensor):
        self.tensor = tensor

    def __len__(self):
        return self.tensor.shape[0]

    def area(self):
        return self.tensor.reshape(len(self), -1).sum(1)

    def nonempty(self):
        return self.area() > 0

    def get_bounding_boxes(self) -> np.ndarray:
        """(N, 4) float32 XYXY boxes of the set pixels (zeros for an empty
        mask), on the host."""
        t = self.tensor.cpu().numpy() if torch.is_tensor(self.tensor) else np.asarray(self.tensor)
        boxes = np.zeros((t.shape[0], 4), np.float32)
        for i in range(t.shape[0]):
            ys, xs = np.nonzero(t[i])
            if len(xs):
                boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
        return boxes


def paste_masks_in_image(
    masks: Tensor,  # (N, S, S) float mask logits/probs in box-local coords
    boxes: Tensor,  # (N, 4) XYXY in image coords
    image_shape: Tuple[int, int],
    threshold: Optional[float] = 0.5,
) -> Tensor:
    """Paste per-box masks into full-image masks (N, H, W), as the JAX
    package does: each image pixel centre maps to mask-local coordinates
    ``g = (p + 0.5 - x1) / max(x2 - x1, 1e-3) * S - 0.5``; the integer taps
    are clipped to the mask first (``floor(g)`` and ``+ 1`` into [0, S - 1]),
    then the weights ``clip(g - tap0, 0, 1)``, then pixels whose ``g`` lies
    outside [-0.5, S - 0.5] on either axis are zeroed, then ``>= threshold``
    (None returns the values). ``F.grid_sample`` is not this function: its
    edge weights and corners differ."""
    n, s, _ = masks.shape
    h, w = image_shape
    dev = masks.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    bw = (x2 - x1).clamp(min=1e-3)
    bh = (y2 - y1).clamp(min=1e-3)
    gx = (xs[None, :] - x1[:, None]) / bw[:, None] * s - 0.5  # (N, W)
    gy = (ys[None, :] - y1[:, None]) / bh[:, None] * s - 0.5  # (N, H)
    ty0 = gy.floor().clamp(0, s - 1)
    tx0 = gx.floor().clamp(0, s - 1)
    ty1 = (ty0 + 1).clamp(0, s - 1)
    tx1 = (tx0 + 1).clamp(0, s - 1)
    ly = (gy - ty0).clamp(0.0, 1.0)[:, :, None]
    lx = (gx - tx0).clamp(0.0, 1.0)[:, None, :]
    rows = torch.arange(n, device=dev)[:, None, None]
    ty0, ty1 = ty0.long()[:, :, None], ty1.long()[:, :, None]
    tx0, tx1 = tx0.long()[:, None, :], tx1.long()[:, None, :]
    top = masks[rows, ty0, tx0] * (1 - lx) + masks[rows, ty0, tx1] * lx
    bot = masks[rows, ty1, tx0] * (1 - lx) + masks[rows, ty1, tx1] * lx
    val = top * (1 - ly) + bot * ly
    inside = (((gy >= -0.5) & (gy <= s - 0.5))[:, :, None]
              & ((gx >= -0.5) & (gx <= s - 0.5))[:, None, :])
    pasted = torch.where(inside, val, 0.0)
    return pasted >= threshold if threshold is not None else pasted
