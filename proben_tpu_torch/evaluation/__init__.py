from .build import build_evaluator
from .cityscapes import CityscapesInstanceEvaluator
from .coco_io import COCODataset
from .cocoeval import COCOEvaluator, EvalParams, bbox_iou_xywh
from .evaluator import inference_on_dataset
from .flir import FLIREvaluator
from .kaist import KAISTEvaluator, load_detections_txt, save_detections_txt
from .lvis import LVISEval, LVISEvaluator
from .panoptic import COCOPanopticEvaluator, PQStat, pq_compute_single
from .pascal_voc import PascalVOCDetectionEvaluator
from .sem_seg import SemSegEvaluator
from .testing import print_csv_format, verify_results

__all__ = [
    "COCODataset",
    "COCOEvaluator",
    "COCOPanopticEvaluator",
    "CityscapesInstanceEvaluator",
    "EvalParams",
    "FLIREvaluator",
    "KAISTEvaluator",
    "LVISEval",
    "LVISEvaluator",
    "PQStat",
    "PascalVOCDetectionEvaluator",
    "SemSegEvaluator",
    "bbox_iou_xywh",
    "build_evaluator",
    "inference_on_dataset",
    "load_detections_txt",
    "pq_compute_single",
    "print_csv_format",
    "save_detections_txt",
    "verify_results",
]
