from .coco_io import COCODataset
from .cocoeval import COCOEvaluator, EvalParams, bbox_iou_xywh
from .evaluator import inference_on_dataset
from .flir import FLIREvaluator

__all__ = [
    "COCODataset",
    "COCOEvaluator",
    "EvalParams",
    "FLIREvaluator",
    "bbox_iou_xywh",
    "inference_on_dataset",
]
