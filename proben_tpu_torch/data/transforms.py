"""Test-time resize (counterpart of the test path of
``proben_tpu/data/transforms.py``): ``ResizeShortestEdge`` at fixed sizes.
The training augmentations (``TrainAugment``, crop, flip and the photometric
jitters) come with the trainer.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def resize_shortest_edge_size(
    h: int, w: int, short: int, max_size: int
) -> Tuple[int, int]:
    """Target (new_h, new_w) (reference ResizeShortestEdge.get_transform)."""
    scale = short * 1.0 / min(h, w)
    if h < w:
        newh, neww = short, scale * w
    else:
        newh, neww = scale * h, short
    if max(newh, neww) > max_size:
        scale = max_size * 1.0 / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    return int(newh + 0.5), int(neww + 0.5)


def resize_image(image: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Bilinear resize of an HWC image (any channel count) with half-pixel
    centres (``cv2.INTER_LINEAR``) to float32, on the CPU with cv2 as in the
    JAX package. On the card the ``image_io`` kernel resizes
    (``native/io.py``)."""
    if image.shape[0] == new_h and image.shape[1] == new_w:
        return image
    import cv2

    out = cv2.resize(
        image.astype(np.float32), (new_w, new_h), interpolation=cv2.INTER_LINEAR
    )
    if out.ndim == 2:
        out = out[:, :, None]
    return out


class TestResize:
    """Deterministic ResizeShortestEdge at test time (min=800, max=1333)."""

    def __init__(self, short_side: int = 800, max_size: int = 1333):
        self.short_side = short_side
        self.max_size = max_size

    def size(self, h: int, w: int) -> Tuple[int, int]:
        return resize_shortest_edge_size(h, w, self.short_side, self.max_size)

    def __call__(self, image: np.ndarray) -> Tuple[np.ndarray, Tuple[int, int]]:
        nh, nw = self.size(*image.shape[:2])
        return resize_image(image, nh, nw), (nh, nw)
