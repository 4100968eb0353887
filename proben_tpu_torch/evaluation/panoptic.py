"""Panoptic Quality evaluation (a copy of ``proben_tpu/evaluation/panoptic.py``; reference
`detectron2/evaluation/panoptic_evaluation.py`, which shells out to
panopticapi's ``pq_compute``; the PQ protocol — Kirillov et al., "Panoptic
Segmentation" — is implemented natively here, no PNG round-trip).

Array-first shape: `process` takes (H, W) int32 segment-id maps directly (the
device output) plus their segments_info, and the per-image gt id map +
segments_info; matching is one vectorized bincount over the joint id map.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

VOID = 0  # panopticapi convention: id 0 = unlabeled / void


class PQStat:
    """Per-category TP/FP/FN/IoU accumulator (panopticapi ``PQStat``)."""

    def __init__(self):
        self.iou = defaultdict(float)
        self.tp = defaultdict(int)
        self.fp = defaultdict(int)
        self.fn = defaultdict(int)

    def __iadd__(self, other: "PQStat"):
        for c in other.iou:
            self.iou[c] += other.iou[c]
        for attr in ("tp", "fp", "fn"):
            mine, theirs = getattr(self, attr), getattr(other, attr)
            for c in theirs:
                mine[c] += theirs[c]
        return self

    def categories(self):
        return set(self.iou) | set(self.tp) | set(self.fp) | set(self.fn)

    def pq_average(self, cats: Optional[Sequence[int]] = None) -> Dict[str, float]:
        """{pq, sq, rq, n} averaged over categories with any TP/FP/FN."""
        pq = sq = rq = 0.0
        n = 0
        for c in cats if cats is not None else sorted(self.categories()):
            denom = self.tp[c] + 0.5 * self.fp[c] + 0.5 * self.fn[c]
            if denom == 0:
                continue
            n += 1
            pq += self.iou[c] / denom
            sq += self.iou[c] / self.tp[c] if self.tp[c] else 0.0
            rq += self.tp[c] / denom
        if n == 0:
            return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}
        return {"pq": pq / n, "sq": sq / n, "rq": rq / n, "n": n}


def pq_compute_single(
    pan_gt: np.ndarray,
    gt_segments: Sequence[dict],
    pan_pred: np.ndarray,
    pred_segments: Sequence[dict],
) -> PQStat:
    """One image's PQ statistics (panopticapi ``pq_compute_single_core``).

    id maps: (H, W) ints, VOID=0. segments: dicts with ``id``,
    ``category_id``, and (gt only) optional ``iscrowd``.
    """
    pan_gt = np.asarray(pan_gt, np.int64)
    pan_pred = np.asarray(pan_pred, np.int64)
    if pan_gt.shape != pan_pred.shape:
        raise ValueError(f"shape mismatch {pan_gt.shape} vs {pan_pred.shape}")

    gt_info = {s["id"]: s for s in gt_segments}
    pred_info = {s["id"]: s for s in pred_segments}

    # areas from the maps themselves (panopticapi trusts but verifies areas;
    # deriving them makes the native path self-consistent)
    gt_ids, gt_areas = np.unique(pan_gt, return_counts=True)
    pred_ids, pred_areas = np.unique(pan_pred, return_counts=True)
    gt_area = dict(zip(gt_ids.tolist(), gt_areas.tolist()))
    pred_area = dict(zip(pred_ids.tolist(), pred_areas.tolist()))

    for sid in pred_area:
        if sid != VOID and sid not in pred_info:
            raise ValueError(f"pred segment id {sid} missing from segments_info")

    # joint histogram: one bincount over gt_id * OFFSET + pred_id
    offset = int(pan_pred.max()) + 1
    combo = pan_gt * offset + pan_pred
    combo_ids, combo_cnt = np.unique(combo, return_counts=True)
    inter = {}
    for cid, cnt in zip(combo_ids.tolist(), combo_cnt.tolist()):
        inter[(cid // offset, cid % offset)] = cnt

    stat = PQStat()
    matched_gt, matched_pred = set(), set()
    for (gid, pid), i in inter.items():
        if gid == VOID or pid == VOID:
            continue
        g = gt_info.get(gid)
        p = pred_info[pid]
        if g is None:
            raise ValueError(f"gt segment id {gid} missing from segments_info")
        if g.get("iscrowd", 0):
            continue
        if g["category_id"] != p["category_id"]:
            continue
        union = (
            gt_area[gid] + pred_area[pid] - i - inter.get((VOID, pid), 0)
        )
        iou = i / union if union > 0 else 0.0
        if iou > 0.5:
            c = g["category_id"]
            stat.tp[c] += 1
            stat.iou[c] += iou
            matched_gt.add(gid)
            matched_pred.add(pid)

    crowd_by_cat = {}
    for gid, g in gt_info.items():
        if gid in matched_gt or gid == VOID:
            continue
        if g.get("iscrowd", 0):
            crowd_by_cat[g["category_id"]] = gid
            continue
        stat.fn[g["category_id"]] += 1

    for pid, p in pred_info.items():
        if pid in matched_pred or pid not in pred_area:
            continue
        # preds mostly covered by void + same-category crowd are ignored
        ignore_inter = inter.get((VOID, pid), 0)
        crowd_id = crowd_by_cat.get(p["category_id"])
        if crowd_id is not None:
            ignore_inter += inter.get((crowd_id, pid), 0)
        if ignore_inter / pred_area[pid] > 0.5:
            continue
        stat.fp[p["category_id"]] += 1
    return stat


class COCOPanopticEvaluator:
    """Dataset-level PQ evaluator with the reset/process/evaluate lifecycle
    (reference ``panoptic_evaluation.py:22``).

    thing_ids / stuff_ids: dataset category-id sets for the Things/Stuff
    breakdown. Categories carrying ``isthing`` in segments_info are mapped
    through the optional contiguous→dataset id dicts first (reference
    ``_convert_category_id``).
    """

    def __init__(
        self,
        thing_ids: Sequence[int] = (),
        stuff_ids: Sequence[int] = (),
        thing_contiguous_to_dataset: Optional[Dict[int, int]] = None,
        stuff_contiguous_to_dataset: Optional[Dict[int, int]] = None,
    ):
        self._thing_ids = set(thing_ids)
        self._stuff_ids = set(stuff_ids)
        self._thing_map = thing_contiguous_to_dataset
        self._stuff_map = stuff_contiguous_to_dataset
        self.reset()

    def reset(self):
        self._stat = PQStat()
        self._num_images = 0

    def _convert(self, seg: dict) -> dict:
        seg = dict(seg)
        isthing = seg.pop("isthing", None)
        if isthing is None:
            return seg
        mapping = self._thing_map if isthing else self._stuff_map
        if mapping is not None:
            seg["category_id"] = mapping[seg["category_id"]]
        return seg

    def process(self, pan_gt, gt_segments, pan_pred, pred_segments):
        pred_segments = [self._convert(s) for s in pred_segments]
        self._stat += pq_compute_single(pan_gt, gt_segments, pan_pred, pred_segments)
        self._num_images += 1

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        cats = sorted(self._stat.categories())
        all_res = self._stat.pq_average(cats)
        th = [c for c in cats if c in self._thing_ids] if self._thing_ids else []
        st = [c for c in cats if c in self._stuff_ids] if self._stuff_ids else []
        th_res = self._stat.pq_average(th)
        st_res = self._stat.pq_average(st)
        res = {
            "PQ": 100 * all_res["pq"],
            "SQ": 100 * all_res["sq"],
            "RQ": 100 * all_res["rq"],
            "PQ_th": 100 * th_res["pq"],
            "SQ_th": 100 * th_res["sq"],
            "RQ_th": 100 * th_res["rq"],
            "PQ_st": 100 * st_res["pq"],
            "SQ_st": 100 * st_res["sq"],
            "RQ_st": 100 * st_res["rq"],
        }
        logger.info(
            "panoptic (%d images): %s",
            self._num_images,
            {k: round(v, 3) for k, v in res.items()},
        )
        return {"panoptic_seg": res}
