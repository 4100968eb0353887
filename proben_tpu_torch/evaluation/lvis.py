"""LVIS detection evaluation (a copy of ``proben_tpu/evaluation/lvis.py``; reference
`detectron2/evaluation/lvis_evaluation.py`, which wraps the ``lvis`` package's
LVISEval — not installed here, so the federated-evaluation protocol is
implemented natively on the pure-numpy COCOeval machinery).

LVIS v1 protocol differences from COCO bbox eval:
  * FEDERATED annotations: for category c, only images where c is positively
    annotated (has gt) or verified negative (``neg_category_ids``) are
    evaluable; detections of c on any other image are ignored entirely
    (neither TP nor FP).
  * 300 detections per image ACROSS categories (score top-k), single
    max_dets=300 operating point (no AR1/AR10).
  * extra buckets APr/APc/APf over category ``frequency`` ∈
    {rare, common, frequent}.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .cocoeval import COCOEvaluator, EvalParams

logger = logging.getLogger(__name__)

LVIS_MAX_DETS = 300


class LVISEval(COCOEvaluator):
    """Federated bbox evaluation core.

    images: list of dicts with id and (LVIS) ``neg_category_ids``.
    categories: list of dicts with id and optional ``frequency``.
    """

    def __init__(self, ground_truth, images: Sequence[dict],
                 categories: Sequence[dict], params: Optional[EvalParams] = None):
        p = params or EvalParams(max_dets=(LVIS_MAX_DETS,))
        img_ids = [im["id"] for im in images]
        cat_ids = [c["id"] for c in categories]
        super().__init__(ground_truth, img_ids, cat_ids, p)
        self.frequency = {c["id"]: c.get("frequency", "f")[0] for c in categories}
        pos = defaultdict(set)
        for g in ground_truth:
            pos[g["category_id"]].add(g["image_id"])
        neg = defaultdict(set)
        for im in images:
            for c in im.get("neg_category_ids", ()):
                neg[c].add(im["id"])
        self._evaluable = {
            c: pos[c] | neg[c] for c in cat_ids
        }

    def _imgs_for_cat(self, cat):
        ev = self._evaluable.get(cat, set())
        return [i for i in self.img_ids if i in ev]

    def evaluate(self, detections: Sequence[dict]) -> Dict[str, float]:
        # LVIS caps detections per image across categories (score top-k)
        cap = self.p.max_dets[-1]
        by_img = defaultdict(list)
        for d in detections:
            by_img[d["image_id"]].append(d)
        capped = []
        for img, ds in by_img.items():
            ds.sort(key=lambda d: -d["score"])
            capped.extend(ds[:cap])
        super().evaluate(capped)
        return self._summarize_lvis()

    def _freq_ap(self, letter: str) -> float:
        """AP over categories with the given frequency bucket."""
        pr = self.eval["precision"]  # (T, R, K, A, M)
        ks = [ki for ki, c in enumerate(self.cat_ids)
              if self.frequency.get(c, "f") == letter]
        if not ks:
            return float("nan")
        sub = pr[:, :, ks, 0, -1]
        sub = sub[sub > -1]
        return float(np.mean(sub)) if sub.size else float("nan")

    def _summarize_lvis(self) -> Dict[str, float]:
        # ×100: _metric returns 0-1 fractions; LVIS results (like the
        # reference's _derive_coco_results) report percentages
        md = self.p.max_dets[-1]

        def pct(v):
            return v * 100.0 if v > -1 else v

        out = {
            "AP": pct(self._metric(True, None, "all", md)),
            "AP50": pct(self._metric(True, 0.5, "all", md)),
            "AP75": pct(self._metric(True, 0.75, "all", md)),
            "APs": pct(self._metric(True, None, "small", md)),
            "APm": pct(self._metric(True, None, "medium", md)),
            "APl": pct(self._metric(True, None, "large", md)),
            "APr": self._freq_ap("r") * 100.0,
            "APc": self._freq_ap("c") * 100.0,
            "APf": self._freq_ap("f") * 100.0,
            f"AR@{md}": pct(self._metric(False, None, "all", md)),
        }
        return out


class LVISEvaluator:
    """Dataset-level evaluator with the reset/process/evaluate lifecycle
    (reference ``lvis_evaluation.py:30`` LVISEvaluator), bbox task.

    annotation_json: LVIS-format dict or path (images carry
    ``neg_category_ids``; categories carry ``frequency``).
    """

    def __init__(self, annotation_json, output_dir: Optional[str] = None):
        import json

        if isinstance(annotation_json, str):
            with open(annotation_json) as f:
                annotation_json = json.load(f)
        self._data = annotation_json
        self._output_dir = output_dir
        self.reset()

    def reset(self):
        self._predictions: List[dict] = []

    def process(self, image_id, boxes, scores, classes):
        """boxes XYXY absolute; classes are CONTIGUOUS 0-based model indices
        (what ``inference_on_dataset``/``predict_batch`` emit). They are
        unmapped here to 1-based LVIS category ids, inverting the ``- 1``
        the loader applies (data/lvis.py) — the reference does the same via
        ``reverse_id_mapping`` (`lvis_evaluation.py:121-128`)."""
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        for b, s, c in zip(boxes, np.asarray(scores), np.asarray(classes)):
            self._predictions.append(
                {
                    "image_id": image_id,
                    "category_id": int(c) + 1,
                    "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]],
                    "score": float(s),
                }
            )

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        ev = LVISEval(
            self._data["annotations"], self._data["images"], self._data["categories"]
        )
        res = ev.evaluate(self._predictions)
        logger.info("LVIS bbox: %s", {k: round(v, 3) for k, v in res.items()})
        if self._output_dir:
            import json
            import os

            os.makedirs(self._output_dir, exist_ok=True)
            with open(os.path.join(self._output_dir, "lvis_predictions.json"), "w") as f:
                json.dump(self._predictions, f)
        return {"bbox": res}
