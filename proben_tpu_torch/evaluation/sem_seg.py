"""Semantic segmentation evaluation (a copy of ``proben_tpu/evaluation/sem_seg.py``; reference
`detectron2/evaluation/sem_seg_evaluation.py`): confusion-matrix mIoU, fwIoU,
mACC, pACC, plus COCO-stuff-format JSON encoding of predictions.

Array-first shape: `process` takes the decoded (H, W) int arrays directly
(numpy arrays copied back from the device; no file-path indirection), with an optional file-backed ground-truth resolver for
datasets stored as label PNGs.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from .rle import encode as rle_encode

logger = logging.getLogger(__name__)


class SemSegEvaluator:
    """Standard semantic-segmentation metrics (COCO stuff protocol;
    reference ``sem_seg_evaluation.py:86-142``):

      * mIoU  — mean IoU over classes present in gt or pred
      * fwIoU — IoU weighted by class pixel frequency
      * mACC  — mean per-class pixel accuracy
      * pACC  — overall pixel accuracy

    ``ignore_label`` pixels in the gt are mapped to an extra (num_classes)
    row/col of the confusion matrix and excluded from every metric.
    """

    def __init__(
        self,
        num_classes: int,
        ignore_label: int = 255,
        output_dir: Optional[str] = None,
        contiguous_id_to_dataset_id: Optional[Dict[int, int]] = None,
        gt_resolver: Optional[Callable[[str], np.ndarray]] = None,
    ):
        self._num_classes = num_classes
        self._ignore_label = ignore_label
        self._N = num_classes + 1
        self._output_dir = output_dir
        self._contiguous_id_to_dataset_id = contiguous_id_to_dataset_id
        self._gt_resolver = gt_resolver
        self.reset()

    def reset(self):
        self._conf_matrix = np.zeros((self._N, self._N), dtype=np.int64)
        self._predictions: List[dict] = []

    def process(self, pred, gt, file_name: str = ""):
        """pred: (H, W) int class map (or (C, H, W)/(H, W, C) logits — argmax
        is taken over the channel axis); gt: (H, W) int label map, or a path
        string resolved via ``gt_resolver``."""
        pred = np.asarray(pred)
        if pred.ndim == 3:
            # accept logits in either channel order
            axis = 0 if pred.shape[0] < min(pred.shape[1:]) else 2
            pred = pred.argmax(axis=axis)
        pred = pred.astype(np.int64)
        if isinstance(gt, str):
            if self._gt_resolver is None:
                raise ValueError("gt given as a path but no gt_resolver set")
            gt = self._gt_resolver(gt)
        gt = np.asarray(gt).astype(np.int64).copy()
        gt[gt == self._ignore_label] = self._num_classes

        self._conf_matrix += np.bincount(
            self._N * pred.reshape(-1) + gt.reshape(-1), minlength=self._N ** 2
        ).reshape(self._N, self._N)
        if file_name:
            self._predictions.extend(self._encode_json_sem_seg(pred, file_name))

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            with open(
                os.path.join(self._output_dir, "sem_seg_predictions.json"), "w"
            ) as f:
                json.dump(self._predictions, f)

        # reference sem_seg_evaluation.py:113-133 (conf_matrix rows = pred,
        # cols = gt; last row/col is the ignore bucket)
        acc = np.zeros(self._num_classes, dtype=np.float64)
        iou = np.zeros(self._num_classes, dtype=np.float64)
        tp = self._conf_matrix.diagonal()[:-1].astype(np.float64)
        pos_gt = self._conf_matrix[:-1, :-1].sum(axis=0).astype(np.float64)
        total_gt = pos_gt.sum()
        class_weights = pos_gt / total_gt if total_gt > 0 else pos_gt
        pos_pred = self._conf_matrix[:-1, :-1].sum(axis=1).astype(np.float64)
        acc_valid = pos_gt > 0
        acc[acc_valid] = tp[acc_valid] / pos_gt[acc_valid]
        iou_valid = (pos_gt + pos_pred) > 0
        union = pos_gt + pos_pred - tp
        iou[acc_valid] = tp[acc_valid] / union[acc_valid]
        macc = acc.sum() / acc_valid.sum() if acc_valid.any() else 0.0
        miou = iou.sum() / iou_valid.sum() if iou_valid.any() else 0.0
        fiou = float((iou * class_weights).sum())
        pacc = tp.sum() / total_gt if total_gt > 0 else 0.0

        res = {
            "mIoU": 100.0 * miou,
            "fwIoU": 100.0 * fiou,
            "mACC": 100.0 * macc,
            "pACC": 100.0 * pacc,
        }
        logger.info("sem_seg: %s", {k: round(v, 3) for k, v in res.items()})
        return {"sem_seg": res}

    def _encode_json_sem_seg(self, sem_seg: np.ndarray, file_name: str) -> List[dict]:
        """COCO stuff results format, one RLE per present label (reference
        ``sem_seg_evaluation.py:144-163``), via the pure-numpy RLE codec."""
        out = []
        for label in np.unique(sem_seg):
            label = int(label)
            if label >= self._num_classes:
                continue  # ignore bucket
            if self._contiguous_id_to_dataset_id is not None:
                if label not in self._contiguous_id_to_dataset_id:
                    raise KeyError(f"label {label} missing from id mapping")
                dataset_id = self._contiguous_id_to_dataset_id[label]
            else:
                dataset_id = label
            rle = rle_encode((sem_seg == label).astype(np.uint8))
            out.append(
                {
                    "file_name": file_name,
                    "category_id": dataset_id,
                    "segmentation": rle,
                }
            )
        return out
