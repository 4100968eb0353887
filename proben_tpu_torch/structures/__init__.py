from .boxes import (
    BoxMode,
    box_area,
    box_centers,
    clip_boxes,
    convert_box_mode,
    nonempty_boxes,
    pairwise_intersection,
    pairwise_ioa,
    pairwise_iou,
)
from .detections import Detections, GroundTruth, pad_detections_numpy

__all__ = [
    "BoxMode",
    "box_area",
    "box_centers",
    "clip_boxes",
    "convert_box_mode",
    "nonempty_boxes",
    "pairwise_intersection",
    "pairwise_ioa",
    "pairwise_iou",
    "Detections",
    "GroundTruth",
    "pad_detections_numpy",
]
