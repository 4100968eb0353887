from .build import build_evaluator
from .coco_io import COCODataset
from .cocoeval import COCOEvaluator, EvalParams, bbox_iou_xywh
from .evaluator import inference_on_dataset
from .flir import FLIREvaluator
from .kaist import KAISTEvaluator, load_detections_txt, save_detections_txt
from .testing import print_csv_format, verify_results

__all__ = [
    "COCODataset",
    "COCOEvaluator",
    "EvalParams",
    "FLIREvaluator",
    "KAISTEvaluator",
    "bbox_iou_xywh",
    "build_evaluator",
    "inference_on_dataset",
    "load_detections_txt",
    "print_csv_format",
    "save_detections_txt",
    "verify_results",
]
