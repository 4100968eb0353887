"""Fixed-shape, masked detection and ground-truth containers and the
host-side padding helper (counterparts of
``proben_tpu/structures/detections.py:27,80,113``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch


@dataclasses.dataclass
class Detections:
    """A padded set of detections for one image, or a batch with a leading
    axis on every field. Invalid slots carry zeros and ``valid == False``.

    boxes (K, 4) XYXY; scores (K,); classes (K,) int; valid (K,) bool;
    probs (K, C) foreground softmax; class_logits (K, C+1); variance (K, 1).
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    probs: Optional[torch.Tensor] = None
    class_logits: Optional[torch.Tensor] = None
    variance: Optional[torch.Tensor] = None

    def to_numpy(self) -> "Detections":
        """Copy every field to the host as a numpy array."""
        return Detections(**{
            f.name: None if v is None else v.detach().cpu().numpy()
            for f in dataclasses.fields(self)
            for v in [getattr(self, f.name)]
        })


@dataclasses.dataclass
class GroundTruth:
    """Padded ground-truth instances for one image, or a batch with a
    leading axis on every field.

    boxes (G, 4) XYXY in the model-input frame; classes (G,) int32; valid
    (G,) bool.
    """

    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def from_numpy(boxes: np.ndarray, classes: np.ndarray, capacity: int) -> "GroundTruth":
        """The first ``capacity`` instances, padded to ``capacity`` slots."""
        g = min(len(boxes), capacity)
        out_boxes = np.zeros((capacity, 4), np.float32)
        out_classes = np.zeros((capacity,), np.int32)
        out_valid = np.zeros((capacity,), bool)
        out_boxes[:g] = np.asarray(boxes, np.float32)[:g]
        out_classes[:g] = np.asarray(classes, np.int32)[:g]
        out_valid[:g] = True
        return GroundTruth(boxes=torch.from_numpy(out_boxes), classes=torch.from_numpy(out_classes),
                           valid=torch.from_numpy(out_valid))

    def to(self, device: Union[str, torch.device]) -> "GroundTruth":
        return GroundTruth(self.boxes.to(device), self.classes.to(device), self.valid.to(device))


def pad_detections_numpy(
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    capacity: int,
    probs: Optional[np.ndarray] = None,
    class_logits: Optional[np.ndarray] = None,
    variance: Optional[np.ndarray] = None,
) -> Detections:
    """Host-side helper (``proben_tpu/structures/detections.py:113``): a
    padded ``Detections`` of CPU tensors from ragged numpy arrays, the
    first ``capacity`` rows kept."""
    n = min(len(boxes), capacity)

    def pad(x, shape, dtype):
        out = np.zeros(shape, dtype)
        if n:
            out[:n] = np.asarray(x, dtype)[:n]
        return torch.from_numpy(out)

    num_c = probs.shape[1] if probs is not None and probs.ndim == 2 else 0
    return Detections(
        boxes=pad(boxes, (capacity, 4), np.float32),
        scores=pad(scores, (capacity,), np.float32),
        classes=pad(classes, (capacity,), np.int32),
        valid=torch.from_numpy(np.arange(capacity) < n),
        probs=pad(probs, (capacity, num_c), np.float32) if probs is not None else None,
        class_logits=(
            pad(class_logits, (capacity, class_logits.shape[1]), np.float32)
            if class_logits is not None
            else None
        ),
        variance=(
            pad(np.asarray(variance).reshape(-1, 1), (capacity, 1), np.float32)
            if variance is not None
            else None
        ),
    )
