"""KAIST pedestrian log-average miss rate (LAMR) evaluation (counterpart of
``proben_tpu/evaluation/kaist.py``; numpy, the same arithmetic).

The reference imports ``demo/evalKAIST/evaluation_script.evaluate``, which
is not in its repository; the JAX package implements the standard KAIST
"reasonable" protocol, and this is its copy:

  * annotation JSON is COCO-like (images with ``im_name``, annotations with
    XYWH bbox, ``category_id`` (1 = person), ``height``, ``occlusion``,
    ``ignore``);
  * "reasonable" ground truth: person class, pixel height >= 55, occlusion in
    {none, partial}; everything else becomes an ignore region (crowd-style
    matching: intersection over detection area);
  * greedy score-ordered matching at IoU 0.5 (the COCO matcher's IoU);
  * miss rate vs false-positives-per-image curve; LAMR = exp(mean(log(mr)))
    sampled at 9 FPPI points logspace(-2, 0, 9);
  * conditions: all / day (set06-08) / night (set09-11), parsed from im_name.

Detections: ``{image_id: (N, 5) [x, y, w, h, score]}`` or the reference's
MATLAB-style txt (``frame,x,y,w,h,score`` with 1-based frame index in
file-list order, ``demo_LAMR_KAIST.py:132-143``).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from .cocoeval import bbox_iou_xywh

FPPI_REFS = np.logspace(-2.0, 0.0, 9)
REASONABLE_HEIGHT = (55.0, 1e5)
REASONABLE_OCCLUSION = (0, 1)  # none, partial


def _condition_of(im_name: str) -> str:
    """day: set06-08, night: set09-11 (KAIST test split convention)."""
    name = os.path.basename(im_name)
    for tok in name.replace("/", "_").split("_"):
        if tok.startswith("set") and len(tok) >= 5:
            try:
                num = int(tok[3:5])
                return "day" if num <= 8 else "night"
            except ValueError:
                pass
    return "day"


class KAISTEvaluator:
    def __init__(
        self,
        annotation_json: Union[str, dict],
        person_category_ids: Sequence[int] = (1,),
        height_range: Tuple[float, float] = REASONABLE_HEIGHT,
        occlusion_levels: Sequence[int] = REASONABLE_OCCLUSION,
        iou_threshold: float = 0.5,
    ):
        if isinstance(annotation_json, str):
            with open(annotation_json) as f:
                annotation_json = json.load(f)
        self.images = annotation_json["images"]
        self.image_ids = [img["id"] for img in self.images]
        self.conditions = {
            img["id"]: _condition_of(img.get("im_name", img.get("file_name", "")))
            for img in self.images
        }
        self.person_ids = set(person_category_ids)
        self.h_rng = height_range
        self.occ_levels = set(occlusion_levels)
        self.iou_threshold = iou_threshold

        self._gts = defaultdict(list)
        for ann in annotation_json.get("annotations", []):
            g = dict(ann)
            h = g.get("height", g["bbox"][3])
            ignore = bool(g.get("ignore", 0))
            if g.get("category_id", 1) not in self.person_ids:
                ignore = True
            if not (self.h_rng[0] <= h <= self.h_rng[1]):
                ignore = True
            if g.get("occlusion", 0) not in self.occ_levels:
                ignore = True
            g["_ignore"] = ignore
            self._gts[g["image_id"]].append(g)

    # ------------------------------------------------------------------

    def _match_image(self, dets: np.ndarray, gts: List[dict]):
        """Greedy match one image. dets (N, 5) xywh+score sorted desc.

        Returns (tp (N,), ignored (N,), n_real_gt)."""
        order = np.argsort(-dets[:, 4], kind="stable")
        dets = dets[order]
        gt_ignore = np.array([g["_ignore"] for g in gts], bool)
        # real gts first
        g_order = np.argsort(gt_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        gt_ignore = gt_ignore[g_order]
        gt_boxes = np.array([g["bbox"] for g in gts], float).reshape(-1, 4)
        ious = bbox_iou_xywh(dets[:, :4], gt_boxes, gt_ignore)

        n, g = len(dets), len(gts)
        tp = np.zeros(n, bool)
        ignored = np.zeros(n, bool)
        gt_matched = np.zeros(g, bool)
        t = self.iou_threshold
        for di in range(n):
            best_iou = t - 1e-10
            best = -1
            for gi in range(g):
                if gt_matched[gi] and not gt_ignore[gi]:
                    continue
                if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best = gi
            if best == -1:
                continue
            if gt_ignore[best]:
                ignored[di] = True
            else:
                tp[di] = True
                gt_matched[best] = True
        # undo ordering back to score-sorted dets (they stay sorted)
        n_real = int((~gt_ignore).sum())
        return dets[:, 4], tp, ignored, n_real

    def evaluate(
        self, detections: Dict[int, np.ndarray], condition: str = "all"
    ) -> Dict[str, float]:
        """Returns {"lamr": ..., "mr_curve": ..., "recall": ...} for the
        condition subset."""
        img_ids = [
            i
            for i in self.image_ids
            if condition == "all" or self.conditions[i] == condition
        ]
        all_scores, all_tp, all_ig = [], [], []
        n_pos = 0
        for img_id in img_ids:
            dets = np.asarray(
                detections.get(img_id, np.zeros((0, 5))), float
            ).reshape(-1, 5)
            gts = self._gts.get(img_id, [])
            if len(dets) == 0:
                n_pos += sum(1 for g in gts if not g["_ignore"])
                continue
            scores, tp, ig, n_real = self._match_image(dets, gts)
            all_scores.append(scores)
            all_tp.append(tp)
            all_ig.append(ig)
            n_pos += n_real

        if n_pos == 0:
            return {"lamr": float("nan"), "recall": 0.0, "num_images": len(img_ids), "num_gt": 0}
        if not all_scores:
            # gt exists but nothing was detected: everything is missed
            return {"lamr": 1.0, "recall": 0.0, "num_images": len(img_ids), "num_gt": n_pos}

        scores = np.concatenate(all_scores)
        tp = np.concatenate(all_tp)
        ig = np.concatenate(all_ig)
        order = np.argsort(-scores, kind="stable")
        tp, ig = tp[order], ig[order]
        counted = ~ig
        tp_cum = np.cumsum(tp & counted)
        fp_cum = np.cumsum(~tp & counted)
        miss_rate = 1.0 - tp_cum / n_pos
        fppi = fp_cum / len(img_ids)

        mrs = np.ones(len(FPPI_REFS))
        for i, ref in enumerate(FPPI_REFS):
            idx = np.searchsorted(fppi, ref, side="right") - 1
            if idx >= 0:
                mrs[i] = miss_rate[idx]
        lamr = float(np.exp(np.mean(np.log(np.maximum(mrs, 1e-10)))))
        return {
            "lamr": lamr,
            "recall": float(tp_cum[-1] / n_pos),
            "num_images": len(img_ids),
            "num_gt": n_pos,
        }

    def evaluate_all_conditions(self, detections) -> Dict[str, float]:
        """The reference-style report: LAMR for all/day/night (in %)."""
        out = {}
        for cond in ("all", "day", "night"):
            res = self.evaluate(detections, cond)
            out[f"lamr_{cond}"] = res["lamr"] * 100.0
            out[f"recall_{cond}"] = res["recall"] * 100.0
        return out


def load_detections_txt(path: str, image_ids: Sequence[int]) -> Dict[int, np.ndarray]:
    """Parse the reference's det txt: ``frame,x,y,w,h,score`` with 1-based
    frame index into the file-list order == ``image_ids`` order."""
    per_frame = defaultdict(list)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            frame = int(float(parts[0]))
            per_frame[frame].append([float(v) for v in parts[1:6]])
    out = {}
    for frame, rows in per_frame.items():
        if 1 <= frame <= len(image_ids):
            out[image_ids[frame - 1]] = np.asarray(rows, float)
    return out


def save_detections_txt(path: str, detections: Dict[int, np.ndarray], image_ids: Sequence[int]):
    """Write the reference's det txt format."""
    with open(path, "w") as f:
        for frame, img_id in enumerate(image_ids, start=1):
            dets = detections.get(img_id)
            if dets is None:
                continue
            for row in np.asarray(dets).reshape(-1, 5):
                f.write(f"{frame}," + ",".join(str(float(v)) for v in row) + "\n")
