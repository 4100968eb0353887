from .boxes import box_area, clip_boxes, nonempty_boxes, pairwise_iou
from .detections import Detections, GroundTruth

__all__ = ["Detections", "GroundTruth", "box_area", "clip_boxes", "nonempty_boxes", "pairwise_iou"]
