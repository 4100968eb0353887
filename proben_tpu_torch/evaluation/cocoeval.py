"""Pure-numpy COCO detection evaluation, bbox and segm mAP (a copy of
``proben_tpu/evaluation/cocoeval.py``; the segm task scores RLE masks
through ``evaluation/rle.py``).

From-scratch implementation of the standard COCO evaluation protocol (the
algorithm of the reference's vendored ``detectron2/pycocotools/cocoeval.py``,
which there requires a compiled Cython ``_mask`` module): greedy score-ordered
matching per (image, category) at IoU thresholds 0.5:0.05:0.95, crowd/ignore
region handling, area ranges, maxDets caps, and 101-point interpolated AP.

No Cython/C dependency — the hot path (IoU matrices + matching) is vectorized
numpy, fast enough for detection workloads (the per-image candidate counts are
tiny compared to training compute).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def bbox_iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, 4) x (G, 4) XYWH -> (D, G) IoU; crowd gt uses intersection/det-area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.clip(
        np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :]),
        0,
        None,
    )
    iy = np.clip(
        np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :]),
        0,
        None,
    )
    inter = ix * iy
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :], d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


@dataclasses.dataclass
class EvalParams:
    iou_thrs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0.5, 0.95, 10)
    )
    rec_thrs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0.0, 1.0, 101)
    )
    max_dets: Tuple[int, ...] = (1, 10, 100)
    area_rng: Tuple[Tuple[float, float], ...] = (
        (0.0, 1e10),
        (0.0, 32.0 ** 2),
        (32.0 ** 2, 96.0 ** 2),
        (96.0 ** 2, 1e10),
    )
    area_labels: Tuple[str, ...] = ("all", "small", "medium", "large")


class COCOEvaluator:
    """Detection mAP evaluator (``iou_type`` "bbox" or "segm").

    ground_truth: list of dicts with keys image_id, category_id, bbox (XYWH),
    area (optional; defaults to w*h), iscrowd (optional), ignore (optional).
    For iou_type="segm" both gts and detections carry "segmentation" (an RLE
    dict from evaluation.rle) and areas default to the mask area, matching
    the vendored ``cocoeval.py`` segm task.
    detections: dicts with image_id, category_id, bbox (XYWH), score.
    """

    def __init__(
        self,
        ground_truth: Sequence[dict],
        image_ids: Sequence,
        category_ids: Sequence,
        params: Optional[EvalParams] = None,
        iou_type: str = "bbox",
    ):
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"iou_type {iou_type!r}")
        self.p = params or EvalParams()
        self.iou_type = iou_type
        self.img_ids = list(image_ids)
        self.cat_ids = list(category_ids)
        self._gts = defaultdict(list)
        for g in ground_truth:
            g = dict(g)
            g.setdefault("area", self._area(g))
            g.setdefault("iscrowd", 0)
            g["ignore"] = g.get("ignore", 0) or g["iscrowd"]
            self._gts[(g["image_id"], g["category_id"])].append(g)

    def _area(self, obj: dict) -> float:
        if self.iou_type == "segm":
            from . import rle

            return float(rle.area(obj["segmentation"]))
        return obj["bbox"][2] * obj["bbox"][3]

    # -- per-(image, category) matching ------------------------------------

    def _evaluate_img(self, dets: List[dict], gts: List[dict], area_rng, max_det):
        """Returns dict with dtm/gtm/dt_ignore/gt_ignore/dt_scores arrays."""
        T = len(self.p.iou_thrs)
        if len(dets) == 0 and len(gts) == 0:
            return None

        gt_ignore_base = np.array(
            [
                g["ignore"] or g["area"] < area_rng[0] or g["area"] > area_rng[1]
                for g in gts
            ],
            bool,
        )
        # non-ignored gts first (stable)
        g_order = np.argsort(gt_ignore_base, kind="stable")
        gts = [gts[i] for i in g_order]
        gt_ignore = gt_ignore_base[g_order]
        iscrowd = np.array([g["iscrowd"] for g in gts], bool)

        d_order = np.argsort([-d["score"] for d in dets], kind="stable")[:max_det]
        dets = [dets[i] for i in d_order]
        dt_scores = np.array([d["score"] for d in dets])

        if self.iou_type == "segm":
            from . import rle

            ious = rle.iou(
                [d["segmentation"] for d in dets],
                [g["segmentation"] for g in gts],
                iscrowd,
            ) if dets and gts else np.zeros((len(dets), len(gts)))
        else:
            gt_boxes = np.array([g["bbox"] for g in gts], float).reshape(-1, 4)
            dt_boxes = np.array([d["bbox"] for d in dets], float).reshape(-1, 4)
            ious = bbox_iou_xywh(dt_boxes, gt_boxes, iscrowd)

        D, G = len(dets), len(gts)
        dtm = np.zeros((T, D), dtype=np.int64)  # 1 + matched gt index, 0 = unmatched
        gtm = np.zeros((T, G), dtype=np.int64)
        dt_ignore = np.zeros((T, D), bool)

        for ti, t in enumerate(self.p.iou_thrs):
            for di in range(D):
                best_iou = min(t, 1 - 1e-10)
                best_g = -1
                for gi in range(G):
                    if gtm[ti, gi] > 0 and not iscrowd[gi]:
                        continue
                    if best_g > -1 and not gt_ignore[best_g] and gt_ignore[gi]:
                        break  # later gts are all ignored; keep the real match
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                dt_ignore[ti, di] = gt_ignore[best_g]
                dtm[ti, di] = best_g + 1
                gtm[ti, best_g] = di + 1

        # unmatched dets outside the area range are ignored
        dt_areas = [self._area(d) for d in dets]
        dt_out = np.array(
            [a < area_rng[0] or a > area_rng[1] for a in dt_areas], bool
        )
        dt_ignore = dt_ignore | ((dtm == 0) & dt_out[None, :])
        return {
            "dtm": dtm,
            "dt_ignore": dt_ignore,
            "dt_scores": dt_scores,
            "gt_ignore": gt_ignore,
            "num_gt": int((~gt_ignore).sum()),
        }

    # -- accumulate ---------------------------------------------------------

    def _imgs_for_cat(self, cat):
        """Images on which category ``cat`` is evaluable. COCO: all images;
        LVIS overrides this with the federated pos/neg sets (detections on
        other images are ignored entirely)."""
        return self.img_ids

    def evaluate(self, detections: Sequence[dict]) -> Dict[str, float]:
        p = self.p
        dts = defaultdict(list)
        for d in detections:
            dts[(d["image_id"], d["category_id"])].append(d)

        T, R = len(p.iou_thrs), len(p.rec_thrs)
        K, A, M = len(self.cat_ids), len(p.area_rng), len(p.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        max_det_cap = p.max_dets[-1]
        for ki, cat in enumerate(self.cat_ids):
            cat_imgs = self._imgs_for_cat(cat)
            for ai, arng in enumerate(p.area_rng):
                # evaluate every image once per (cat, area) at the largest cap;
                # smaller maxDets re-slice the per-image results
                per_img = [
                    self._evaluate_img(
                        dts[(img, cat)], self._gts[(img, cat)], arng, max_det_cap
                    )
                    for img in cat_imgs
                ]
                per_img = [e for e in per_img if e is not None]
                if not per_img:
                    continue
                for mi, md in enumerate(p.max_dets):
                    dt_scores = np.concatenate([e["dt_scores"][:md] for e in per_img])
                    order = np.argsort(-dt_scores, kind="stable")
                    dt_scores = dt_scores[order]
                    dtm = np.concatenate([e["dtm"][:, :md] for e in per_img], axis=1)[
                        :, order
                    ]
                    dt_ig = np.concatenate(
                        [e["dt_ignore"][:, :md] for e in per_img], axis=1
                    )[:, order]
                    npig = sum(e["num_gt"] for e in per_img)
                    if npig == 0:
                        continue
                    tps = (dtm > 0) & ~dt_ig
                    fps = (dtm == 0) & ~dt_ig
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        # make precision monotonically decreasing from the right
                        pr_mono = pr.copy()
                        for i in range(nd - 1, 0, -1):
                            if pr_mono[i] > pr_mono[i - 1]:
                                pr_mono[i - 1] = pr_mono[i]
                        inds = np.searchsorted(rc, p.rec_thrs, side="left")
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr_mono[pi]
                                ss[ri] = dt_scores[pi]
                        precision[ti, :, ki, ai, mi] = q
                        scores[ti, :, ki, ai, mi] = ss

        self.eval = {
            "precision": precision,
            "recall": recall,
            "scores": scores,
            "params": p,
        }
        return self._summarize()

    # -- summarize ----------------------------------------------------------

    def _metric(self, ap=True, iou_thr=None, area="all", max_dets=100) -> float:
        p = self.p
        ai = p.area_labels.index(area)
        mi = p.max_dets.index(max_dets)
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                ti = int(np.argmin(np.abs(p.iou_thrs - iou_thr)))
                s = s[ti : ti + 1]
            s = s[:, :, :, ai, mi]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                ti = int(np.argmin(np.abs(p.iou_thrs - iou_thr)))
                s = s[ti : ti + 1]
            s = s[:, :, ai, mi]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def _summarize(self) -> Dict[str, float]:
        md = self.p.max_dets
        out = {
            "AP": self._metric(ap=True, max_dets=md[-1]),
            "AP50": self._metric(ap=True, iou_thr=0.5, max_dets=md[-1]),
            "AP75": self._metric(ap=True, iou_thr=0.75, max_dets=md[-1]),
            "APs": self._metric(ap=True, area="small", max_dets=md[-1]),
            "APm": self._metric(ap=True, area="medium", max_dets=md[-1]),
            "APl": self._metric(ap=True, area="large", max_dets=md[-1]),
            "AR1": self._metric(ap=False, max_dets=md[0]),
            "AR10": self._metric(ap=False, max_dets=md[1]) if len(md) > 1 else -1.0,
            "AR100": self._metric(ap=False, max_dets=md[-1]),
            "ARs": self._metric(ap=False, area="small", max_dets=md[-1]),
            "ARm": self._metric(ap=False, area="medium", max_dets=md[-1]),
            "ARl": self._metric(ap=False, area="large", max_dets=md[-1]),
        }
        return out

    def per_category_ap(self) -> Dict:
        """AP per category id (over the full IoU range, area=all, top maxDets)."""
        mi = len(self.p.max_dets) - 1
        out = {}
        for ki, cat in enumerate(self.cat_ids):
            s = self.eval["precision"][:, :, ki, 0, mi]
            valid = s[s > -1]
            out[cat] = float(valid.mean()) if valid.size else float("nan")
        return out
