"""Frame-to-frame detection visualization with stable instance colors
(counterpart of ``proben_tpu/utils/video_visualizer.py``; reference
``detectron2/utils/video_visualizer.py``).

The reference tracks instances across frames by box (or mask-RLE) IoU and
transfers each matched instance's color forward with a time-to-live; new
instances get fresh deterministic colors. Same protocol here, numpy-native
(boxes XYXY; masks as (H, W) bool arrays — no compiled RLE dependency).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .visualizer import Visualizer, _color_for, to_host


def _pairwise_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) XYXY -> (N, M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def _pairwise_mask_iou(a: Sequence[np.ndarray], b: Sequence[np.ndarray]) -> np.ndarray:
    out = np.zeros((len(a), len(b)), np.float32)
    for i, ma in enumerate(a):
        ma = ma.astype(bool)
        sa = ma.sum()
        for j, mb in enumerate(b):
            mb = mb.astype(bool)
            inter = np.logical_and(ma, mb).sum()
            union = sa + mb.sum() - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


class _DetectedInstance:
    """Per-frame record used to transfer colors forward (reference
    ``video_visualizer.py:15``)."""

    __slots__ = ["label", "bbox", "mask", "color", "ttl"]

    def __init__(self, label, bbox=None, mask=None, color=None, ttl=8):
        self.label = label
        self.bbox = bbox
        self.mask = mask
        self.color = color
        self.ttl = ttl


class VideoVisualizer:
    def __init__(self, metadata=None):
        self.metadata = metadata
        self._old_instances: List[_DetectedInstance] = []
        self._next_color = 0

    def draw_instance_predictions(self, frame: np.ndarray, predictions: Dict):
        """predictions: dict with boxes (N,4 XYXY) / scores / classes
        (+ optional masks (N,H,W)) — the Predictor output format, numpy
        arrays or tensors on any device (moved to the host first). Returns
        a Visualizer whose image has temporally-stable instance colors; an
        instance keeps its colour only across frames of its own class."""
        predictions = to_host(predictions)
        vis = Visualizer(frame, self.metadata)
        boxes = predictions.get("boxes")
        if boxes is None or len(boxes) == 0:
            return vis
        classes = predictions.get("classes")
        masks = predictions.get("masks")
        n = len(boxes)
        detected = [
            _DetectedInstance(
                int(classes[i]) if classes is not None else 0,
                bbox=np.asarray(boxes[i], float),
                mask=None if masks is None else np.asarray(masks[i]),
                ttl=8,
            )
            for i in range(n)
        ]
        colors = self._assign_colors(detected)
        if masks is not None:
            vis.draw_masks(masks, classes, assigned_colors=colors)
            # reference draws only masks when present ("boxes are a bit
            # distracting"); labels ride on the boxes here instead
        vis.overlay_instances(
            boxes=boxes,
            classes=classes,
            scores=predictions.get("scores"),
            assigned_colors=colors,
        )
        return vis

    def _assign_colors(self, instances: List[_DetectedInstance]):
        """IoU-match new instances to tracked ones; matched instances inherit
        the old color, unmatched old ones age out by TTL (reference
        ``video_visualizer.py:180-229``)."""
        if instances and instances[0].bbox is None:
            ious = _pairwise_mask_iou(
                [x.mask for x in self._old_instances], [x.mask for x in instances]
            )
            threshold = 0.5
        else:
            old_boxes = np.array([x.bbox for x in self._old_instances]).reshape(-1, 4)
            new_boxes = np.array([x.bbox for x in instances]).reshape(-1, 4)
            ious = _pairwise_iou_xyxy(old_boxes, new_boxes)
            threshold = 0.6
        for oi, old in enumerate(self._old_instances):
            for ni, new in enumerate(instances):
                if old.label != new.label:
                    ious[oi, ni] = 0.0

        extra: List[_DetectedInstance] = []
        if ious.size:
            best_new = ious.argmax(axis=1)
            best_iou = ious.max(axis=1)
        else:
            best_new = np.zeros(len(self._old_instances), int)
            best_iou = np.zeros(len(self._old_instances))
        for oi, old in enumerate(self._old_instances):
            if best_iou[oi] > threshold and instances[best_new[oi]].color is None:
                instances[best_new[oi]].color = old.color
                continue
            old.ttl -= 1
            if old.ttl > 0:
                extra.append(old)

        for inst in instances:
            if inst.color is None:
                inst.color = _color_for(self._next_color)
                self._next_color += 1
        self._old_instances = instances[:] + extra
        return [x.color for x in instances]
