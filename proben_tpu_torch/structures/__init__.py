from .boxes import BoxMode, box_area, clip_boxes, convert_box_mode, nonempty_boxes, pairwise_iou
from .detections import Detections, GroundTruth, pad_detections_numpy

__all__ = ["BoxMode", "Detections", "GroundTruth", "box_area", "clip_boxes", "convert_box_mode",
           "nonempty_boxes", "pad_detections_numpy", "pairwise_iou"]
