"""Pascal VOC detection AP (a copy of ``proben_tpu/evaluation/pascal_voc.py``; reference
``detectron2/evaluation/pascal_voc_evaluation.py:179`` voc_eval — the pure
python AP with 11-point (VOC07) or continuous (VOC10+) interpolation)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_class(
    gt_by_image: Dict,  # image_id -> {"boxes": (G,4) xyxy, "difficult": (G,)}
    detections: Sequence[dict],  # {"image_id", "bbox" xyxy, "score"}
    iou_thresh: float = 0.5,
    use_07_metric: bool = False,
) -> Dict[str, float]:
    """Single-class VOC evaluation. Difficult gts are ignored."""
    npos = sum(int((~np.asarray(g["difficult"], bool)).sum()) for g in gt_by_image.values())
    matched = {k: np.zeros(len(v["boxes"]), bool) for k, v in gt_by_image.items()}

    dets = sorted(detections, key=lambda d: -d["score"])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, det in enumerate(dets):
        g = gt_by_image.get(det["image_id"])
        best_iou, best = -np.inf, -1
        if g is not None and len(g["boxes"]):
            bb = np.asarray(det["bbox"], float)
            gt = np.asarray(g["boxes"], float)
            ix1 = np.maximum(gt[:, 0], bb[0])
            iy1 = np.maximum(gt[:, 1], bb[1])
            ix2 = np.minimum(gt[:, 2], bb[2])
            iy2 = np.minimum(gt[:, 3], bb[3])
            # VOC convention: +1 pixel areas
            iw = np.maximum(ix2 - ix1 + 1.0, 0.0)
            ih = np.maximum(iy2 - iy1 + 1.0, 0.0)
            inter = iw * ih
            union = (
                (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                + (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0)
                - inter
            )
            ious = inter / union
            best = int(np.argmax(ious))
            best_iou = ious[best]
        if best_iou > iou_thresh:
            if np.asarray(g["difficult"], bool)[best]:
                pass  # ignore
            elif not matched[det["image_id"]][best]:
                matched[det["image_id"]][best] = True
                tp[i] = 1
            else:
                fp[i] = 1
        else:
            fp[i] = 1

    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / max(npos, 1)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(np.float64).eps)
    return {
        "ap": voc_ap(recall, precision, use_07_metric),
        "recall": float(recall[-1]) if len(recall) else 0.0,
        "npos": npos,
    }


class PascalVOCDetectionEvaluator:
    """Multi-class VOC evaluator: process/evaluate over per-class voc_eval.

    ``reset`` clears the detections and keeps the ground truth, as the
    reference's evaluator does (it reads the annotations at evaluate time):
    ``build.py::_voc_evaluator`` registers the split's ground truth once,
    before ``inference_on_dataset`` resets the evaluator. The JAX copy's
    ``reset`` clears both, so a VOC split evaluated through
    ``inference_on_dataset`` there scores AP50 NaN (ROADMAP, section C)."""

    def __init__(self, class_names: Sequence[str], use_07_metric: bool = False):
        self.class_names = list(class_names)
        self.use_07 = use_07_metric
        self._gts = defaultdict(lambda: defaultdict(lambda: {"boxes": [], "difficult": []}))
        self.reset()

    def reset(self):
        self._dets = defaultdict(list)

    def add_ground_truth(self, image_id, boxes, classes, difficult=None):
        boxes = np.asarray(boxes, float).reshape(-1, 4)
        if difficult is None:
            difficult = np.zeros(len(boxes), bool)
        for b, c, d in zip(boxes, np.asarray(classes).reshape(-1), np.asarray(difficult)):
            g = self._gts[int(c)][image_id]
            g["boxes"].append(b)
            g["difficult"].append(bool(d))

    def process(self, image_id, boxes, scores, classes):
        boxes = np.asarray(boxes, float).reshape(-1, 4)
        for b, s, c in zip(boxes, np.asarray(scores).reshape(-1), np.asarray(classes).reshape(-1)):
            self._dets[int(c)].append({"image_id": image_id, "bbox": b, "score": float(s)})

    def evaluate(self) -> Dict[str, float]:
        aps = {}
        for ci, name in enumerate(self.class_names):
            gt_by_img = {
                img: {"boxes": np.asarray(v["boxes"]).reshape(-1, 4),
                      "difficult": np.asarray(v["difficult"], bool)}
                for img, v in self._gts[ci].items()
            }
            if not gt_by_img:
                continue
            res = voc_eval_class(gt_by_img, self._dets[ci], 0.5, self.use_07)
            aps[f"AP-{name}"] = res["ap"] * 100
        mean = float(np.mean(list(aps.values()))) if aps else float("nan")
        return {"bbox": {"AP50": mean, **aps}}
