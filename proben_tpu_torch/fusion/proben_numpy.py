"""ProbEn late fusion — exact host-side (numpy) implementation (the port's
own copy of ``proben_tpu/fusion/proben_numpy.py``; numpy only).

Re-implementation of the algorithm in reference ``demo/FLIR/demo_probEn.py``
(bayesian_fusion_multiclass :32, nms_bayesian :92, weighted_box_fusion :73,
fusion :189, apply_late_fusion dispatch :223-267), written from its observed
semantics:

  * detections from 2-3 models are concatenated and greedily clustered by a
    class-offset NMS loop: coordinates are shifted by (class * W, class * H)
    so different classes never cluster; IoU uses the legacy +1 convention
    (``x2 - x1 + 1``); a member joins the first (highest-scoring) cluster head
    whose IoU exceeds the threshold.
  * score fusion per cluster: ``probEn`` (Bayesian log-odds: per-member
    class-probability rows extended with a background column 1-sum, logs
    summed over members, softmax-renormalized, max/argmax -> score/class),
    ``avg`` (mean of member scores), or ``max`` (max over member class-probs).
  * box fusion per cluster: ``v-avg`` (inverse-variance weights), ``s-avg``
    (score weights), ``avg`` (mean), ``argmax`` (highest-scoring member).
  * singleton clusters pass through unchanged.
  * the (max, argmax) combination short-circuits to a plain class-batched NMS
    over the union (reference ``nms_1`` :44).

The reference hardcodes K=3 classes and FLIR's 640x512 offsets; both are
parameters here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def bayesian_score_fusion(probs: np.ndarray) -> Tuple[float, int]:
    """(n_members, C) foreground probs -> fused (score, class).

    Generalizes reference ``bayesian_fusion_multiclass`` (K=3 hardcoded) to C.
    """
    n, c = probs.shape
    scores = np.zeros((n, c + 1), np.float64)
    scores[:, :c] = probs
    scores[:, -1] = 1.0 - probs.sum(axis=1)
    with np.errstate(divide="ignore"):
        log_scores = np.log(scores)
    sum_logits = log_scores.sum(axis=0)
    # stabilized softmax (equal to reference for non-overflowing inputs)
    sum_logits = sum_logits - sum_logits.max()
    exp_logits = np.exp(sum_logits)
    norm = exp_logits / exp_logits.sum()
    return float(norm.max()), int(norm.argmax())


def cluster_nms(
    boxes: np.ndarray,  # (N, 4)
    scores: np.ndarray,  # (N,)
    classes: np.ndarray,  # (N,)
    thresh: float,
    class_offset: Tuple[float, float] = (640.0, 512.0),
) -> List[np.ndarray]:
    """Greedy class-offset clustering. Returns a list of clusters; each is an
    index array whose FIRST element is the head (highest score)."""
    off_x, off_y = class_offset
    x1 = boxes[:, 0] + classes * off_x
    y1 = boxes[:, 1] + classes * off_y
    x2 = boxes[:, 2] + classes * off_x
    y2 = boxes[:, 3] + classes * off_y
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]

    clusters = []
    while order.size > 0:
        i = order[0]
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[rest] - inter)
        matched = rest[ovr > thresh]
        clusters.append(np.concatenate([[i], matched]))
        order = rest[ovr <= thresh]
    return clusters


def fuse_detections(
    boxes: np.ndarray,  # (N, 4) union over models
    scores: np.ndarray,  # (N,)
    classes: np.ndarray,  # (N,) int
    probs: np.ndarray,  # (N, C)
    variances: Optional[np.ndarray],  # (N,) or (N, 1); needed for v-avg
    score_method: str,  # probEn | avg | max
    box_method: str,  # v-avg | s-avg | avg | argmax
    thresh: float = 0.5,
    class_offset: Tuple[float, float] = (640.0, 512.0),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full fusion of a concatenated detection set.

    Returns (boxes (M, 4), scores (M,), classes (M,)) ordered by cluster-head
    score (the reference's output order).
    """
    if len(boxes) == 0:
        return boxes.reshape(0, 4), scores, classes
    if variances is not None:
        variances = np.asarray(variances).reshape(-1)

    clusters = cluster_nms(boxes, scores, classes, thresh, class_offset)
    out_boxes, out_scores, out_classes = [], [], []
    for members in clusters:
        i = members[0]
        if len(members) == 1:
            out_boxes.append(boxes[i])
            out_scores.append(float(scores[i]))
            out_classes.append(int(classes[i]))
            continue

        m_scores = scores[members]
        m_probs = probs[members]
        m_boxes = boxes[members]

        if score_method == "probEn":
            s, c = bayesian_score_fusion(m_probs)
        elif score_method == "avg":
            s, c = float(m_scores.mean()), int(classes[i])
        elif score_method == "max":
            s, c = float(m_probs.max()), int(classes[i])
        else:
            raise ValueError(score_method)

        if box_method == "v-avg":
            assert variances is not None, "v-avg needs per-box variances"
            w = 1.0 / variances[members]
            b = (m_boxes * (w / w.sum())[:, None]).sum(axis=0)
        elif box_method == "s-avg":
            w = m_scores / m_scores.sum()
            b = (m_boxes * w[:, None]).sum(axis=0)
        elif box_method == "avg":
            b = m_boxes.mean(axis=0)
        elif box_method == "argmax":
            b = m_boxes[m_scores.argmax()]
        else:
            raise ValueError(box_method)

        out_boxes.append(b)
        out_scores.append(s)
        out_classes.append(c)

    return (
        np.asarray(out_boxes, np.float32).reshape(-1, 4),
        np.asarray(out_scores, np.float32),
        np.asarray(out_classes, np.int64),
    )


def _plain_batched_nms(boxes, scores, classes, thresh):
    """Torchvision-convention greedy class-batched NMS (reference nms_1)."""
    keep = []
    offset = (boxes.max() + 1.0) if len(boxes) else 1.0
    ob = boxes + classes[:, None].astype(np.float64) * offset
    order = np.argsort(-scores, kind="stable")
    suppressed = np.zeros(len(boxes), bool)
    areas = (ob[:, 2] - ob[:, 0]) * (ob[:, 3] - ob[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(ob[i, 0], ob[:, 0])
        yy1 = np.maximum(ob[i, 1], ob[:, 1])
        xx2 = np.minimum(ob[i, 2], ob[:, 2])
        yy2 = np.minimum(ob[i, 3], ob[:, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        union = areas[i] + areas - inter
        iou = np.where(inter > 0, inter / np.where(union > 0, union, 1), 0)
        newly = iou > thresh
        newly[i] = False
        suppressed |= newly
    return np.asarray(keep, np.int64)


def fuse_multi_model(
    detections: Sequence[Dict[str, np.ndarray]],
    score_method: str,
    box_method: str,
    thresh: float = 0.5,
    class_offset: Tuple[float, float] = (640.0, 512.0),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference ``apply_late_fusion`` per-image dispatch (:223-267).

    ``detections``: per model, dict with 'boxes' (n,4), 'scores' (n,),
    'classes' (n,), 'probs' (n,C), optional 'vars'. Models with zero
    detections are dropped; 0 models -> empty; 1 model -> passthrough;
    >=2 -> fusion (or plain NMS for (max, argmax)).
    """
    present = [d for d in detections if len(d["boxes"]) > 0]
    if not present:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32), np.zeros((0,), np.int64)
    if len(present) == 1:
        d = present[0]
        return (
            np.asarray(d["boxes"], np.float32).reshape(-1, 4),
            np.asarray(d["scores"], np.float32),
            np.asarray(d["classes"], np.int64),
        )

    boxes = np.concatenate([np.asarray(d["boxes"], np.float64).reshape(-1, 4) for d in present])
    scores = np.concatenate([np.asarray(d["scores"], np.float64).reshape(-1) for d in present])
    classes = np.concatenate([np.asarray(d["classes"]).reshape(-1) for d in present]).astype(np.int64)

    if score_method == "max" and box_method == "argmax":
        keep = _plain_batched_nms(boxes, scores, classes, thresh)
        # sorted by score descending (batched_nms returns score order)
        return (
            boxes[keep].astype(np.float32),
            scores[keep].astype(np.float32),
            classes[keep],
        )

    probs = np.concatenate([np.asarray(d["probs"], np.float64).reshape(len(d["boxes"]), -1) for d in present])
    variances = None
    if all("vars" in d and d["vars"] is not None for d in present):
        variances = np.concatenate(
            [np.asarray(d["vars"], np.float64).reshape(-1) for d in present]
        )
    return fuse_detections(
        boxes, scores, classes, probs, variances, score_method, box_method, thresh, class_offset
    )
