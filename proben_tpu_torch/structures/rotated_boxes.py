"""Rotated boxes (cx, cy, w, h, angle in degrees) (counterpart of
``proben_tpu/structures/rotated_boxes.py``; reference
``detectron2/structures/rotated_boxes.py``).

No model path of either package uses rotated boxes; these are the structure
ops (area, angle normalisation, corners, axis-aligned hull) on tensors, and
an exact pairwise rotated IoU by polygon clipping in numpy on the host, as
the JAX package computes it."""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor


def area(boxes: Tensor) -> Tensor:
    return boxes[..., 2] * boxes[..., 3]


def normalize_angles(boxes: Tensor) -> Tensor:
    """Angles into (-180, 180] (reference normalize_angle)."""
    a = torch.remainder(boxes[..., 4] + 180.0, 360.0) - 180.0
    a = torch.where(a == -180.0, 180.0, a)
    return torch.cat([boxes[..., :4], a[..., None]], -1)


def corners(boxes):
    """(..., 5) -> (..., 4, 2) corner coordinates, tensors or numpy arrays
    (the numpy copy serves ``pairwise_iou_rotated``)."""
    xp = torch if torch.is_tensor(boxes) else np
    cx, cy, w, h, ang = (boxes[..., i] for i in range(5))
    theta = ang * math.pi / 180.0
    c, s = xp.cos(theta), xp.sin(theta)
    dx = xp.stack([-w / 2, w / 2, w / 2, -w / 2], -1)
    dy = xp.stack([-h / 2, -h / 2, h / 2, h / 2], -1)
    # image y grows downward; rotation by +angle is CCW in math coordinates
    x = cx[..., None] + dx * c[..., None] - dy * s[..., None]
    y = cy[..., None] + dx * s[..., None] + dy * c[..., None]
    return xp.stack([x, y], -1)


def to_axis_aligned(boxes: Tensor) -> Tensor:
    """Axis-aligned hull XYXY of rotated boxes."""
    pts = corners(boxes)
    return torch.cat([pts.amin(-2), pts.amax(-2)], -1)


def _polygon_area(pts: np.ndarray) -> float:
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def _signed_area(pts: np.ndarray) -> float:
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_polygon(subject: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman clip of a polygon by the half-plane left of the
    edge a -> b."""
    out = []
    n = len(subject)
    for i in range(n):
        p, q = subject[i], subject[(i + 1) % n]
        side_p = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
        side_q = (b[0] - a[0]) * (q[1] - a[1]) - (b[1] - a[1]) * (q[0] - a[0])
        if side_p >= 0:
            out.append(p)
        if (side_p >= 0) != (side_q >= 0):
            t = side_p / (side_p - side_q)
            out.append(p + t * (q - p))
    return np.asarray(out) if out else np.zeros((0, 2))


def pairwise_iou_rotated(boxes1, boxes2) -> np.ndarray:
    """Exact rotated IoU (N, M) float64 on the host, by polygon clipping
    (reference ``csrc/box_iou_rotated``); takes tensors or arrays."""
    def host(b):
        return (b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)).astype(float)

    b1, b2 = host(boxes1).reshape(-1, 5), host(boxes2).reshape(-1, 5)
    c1, c2 = corners(b1), corners(b2)
    a1, a2 = b1[:, 2] * b1[:, 3], b2[:, 2] * b2[:, 3]
    out = np.zeros((len(b1), len(b2)))
    for i in range(len(b1)):
        for j in range(len(b2)):
            poly, clipper = c1[i], c2[j]
            # the half-plane test keeps points with a positive cross product
            if _signed_area(clipper) < 0:
                clipper = clipper[::-1]
            for k in range(4):
                poly = _clip_polygon(poly, clipper[k], clipper[(k + 1) % 4])
                if len(poly) == 0:
                    break
            inter = _polygon_area(poly) if len(poly) >= 3 else 0.0
            union = a1[i] + a2[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out
