"""FLIR ADAS COCO-mAP evaluator (counterpart of ``proben_tpu/evaluation/flir.py``).

Rebuild of reference ``detectron2/evaluation/FLIR_evaluation.py`` (class :32):
process/evaluate lifecycle producing COCO bbox mAP with the FLIR class
handling of ``instances_to_coco_json`` (:313-382):

  * only predictions in ``valid_classes`` are kept (default
    (0, 1, 2, 5, 7, 16) — supports COCO-pretrained 80-class models),
  * classes 5 (bus) and 7 (truck) are remapped to 2 (car),
  * contiguous class ids are unmapped to dataset category ids
    (``_eval_predictions`` :160-175).

Results can be saved as ``coco_instances_results.json`` and the evaluation
state pickled (the reference pickles the whole COCOeval object; we save the
precision/recall arrays + summary), with the optional PR-curve PNG
(IoU .5/.6/.7, reference :542-561).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .coco_io import COCODataset
from .cocoeval import COCOEvaluator

DEFAULT_VALID_CLASSES = (0, 1, 2, 5, 7, 16)
DEFAULT_CLASS_REMAP = {5: 2, 7: 2}


class FLIREvaluator:
    def __init__(
        self,
        dataset: Union[str, dict, COCODataset],
        output_dir: Optional[str] = None,
        valid_classes: Sequence[int] = DEFAULT_VALID_CLASSES,
        class_remap: Dict[int, int] = None,
        save_eval: bool = False,
        out_eval_path: Optional[str] = None,
        out_pr_name: Optional[str] = None,
    ):
        self.coco = dataset if isinstance(dataset, COCODataset) else COCODataset(dataset)
        self.output_dir = output_dir
        self.valid_classes = set(valid_classes)
        self.class_remap = DEFAULT_CLASS_REMAP if class_remap is None else class_remap
        self.save_eval = save_eval
        self.out_eval_path = out_eval_path
        self.out_pr_name = out_pr_name
        self._contig = self.coco.contiguous_category_mapping()
        self._reverse = {v: k for k, v in self._contig.items()}
        self.reset()

    def reset(self):
        self._results: List[dict] = []

    def process(
        self,
        image_id,
        boxes_xyxy: np.ndarray,
        scores: np.ndarray,
        classes: np.ndarray,
        valid: Optional[np.ndarray] = None,
    ):
        """Record one image's predictions (boxes in the original image frame)."""
        boxes_xyxy = np.asarray(boxes_xyxy, float).reshape(-1, 4)
        scores = np.asarray(scores, float).reshape(-1)
        classes = np.asarray(classes).reshape(-1).astype(int)
        if valid is None:
            valid = np.ones(len(scores), bool)
        for box, score, cls, ok in zip(boxes_xyxy, scores, classes, np.asarray(valid)):
            if not ok or cls not in self.valid_classes:
                continue
            cls = self.class_remap.get(cls, cls)
            cat_id = self._reverse.get(int(cls))
            if cat_id is None:
                continue
            x1, y1, x2, y2 = box
            self._results.append(
                {
                    "image_id": image_id,
                    "category_id": cat_id,
                    "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                    "score": float(score),
                }
            )

    def evaluate(self, out_eval_path: Optional[str] = None) -> Dict[str, Dict[str, float]]:
        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            with open(os.path.join(self.output_dir, "coco_instances_results.json"), "w") as f:
                json.dump(self._results, f)

        gts = []
        for ann in self.coco.annotations:
            gts.append(ann)
        evaluator = COCOEvaluator(gts, self.coco.image_ids, self.coco.category_ids)
        summary = evaluator.evaluate(self._results)
        per_cat = evaluator.per_category_ap()
        names = self.coco.thing_classes()
        results = dict(summary)
        for cid, name in zip(self.coco.category_ids, names):
            results[f"AP-{name}"] = per_cat[cid] * 100 if np.isfinite(per_cat[cid]) else float("nan")
        # COCO convention: report percentages
        for k in ("AP", "AP50", "AP75", "APs", "APm", "APl",
                  "AR1", "AR10", "AR100", "ARs", "ARm", "ARl"):
            results[k] = summary[k] * 100

        path = out_eval_path or self.out_eval_path
        if (self.save_eval or out_eval_path) and path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump({"eval": evaluator.eval, "summary": results}, f)
        if self.out_pr_name:
            self._save_pr_curves(evaluator, self.out_pr_name)
        return {"bbox": results}

    def _save_pr_curves(self, evaluator: COCOEvaluator, out_name: str):
        """PR curves at IoU .5/.6/.7 for category 0 (reference :542-561)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        pr = evaluator.eval["precision"]
        x = np.arange(0.0, 1.01, 0.01)
        fig = plt.figure()
        plt.xlabel("Recall")
        plt.ylabel("Precision")
        plt.xlim(0, 1.0)
        plt.ylim(0, 1.01)
        plt.grid(True)
        for ti, (style, label) in zip((0, 2, 4), (("b-", "IoU=0.5"), ("c-", "IoU=0.6"), ("y-", "IoU=0.7"))):
            plt.plot(x, pr[ti, :, 0, 0, -1], style, label=label)
        plt.legend(loc="lower left")
        plt.savefig(out_name)
        plt.close(fig)
