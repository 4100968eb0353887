from .boxes import BoxMode, box_area, clip_boxes, convert_box_mode, nonempty_boxes, pairwise_iou
from .detections import Detections, GroundTruth

__all__ = ["BoxMode", "Detections", "GroundTruth", "box_area", "clip_boxes", "convert_box_mode",
           "nonempty_boxes", "pairwise_iou"]
