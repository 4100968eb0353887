"""What decides ``correct``: the program's outputs held against the plain
reference's, number by number, each against a limit of its own.

Inference: the detections ``predict_batch`` returned for a sample of the
window's images, drawn from the seed with the image of most detections in
it. Near-tied proposals flip between two correct runs in top-k and NMS, so
single detections are not compared one to one; the numbers are shares of
detections, over the whole sample, that find no partner on the other side
(same class, IoU at least 0.5, score within 0.05).

Training: the parameters' change after step 3, leaf by leaf, as the gap
between the two sides' norms over the larger of the reference leaf's norm
and the median leaf's, read at the 90th-percentile leaf; and the first
three steps' RPN box-regression loss (whose sampled anchors both sides
share). The total loss, the first gradient and the worst leaf are computed
for the record: the RoI sampler's priorities follow the proposals' order,
which bf16 rounding shuffles, so those numbers carry sampling noise (in the
box head's leaves and the p5 output conv, whose few large RoIs are
sampled) as large as the control's error.
"""

from __future__ import annotations

import statistics
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from reference.boxes import iou

MATCH_IOU = 0.5
MATCH_SCORE = 0.05


def _partners(a: Mapping, b: Mapping, score_tol: float, iou_min: float) -> np.ndarray:
    """Per detection of ``a``: whether ``b`` holds one of its class at IoU
    >= ``iou_min`` within ``score_tol`` of its score."""
    na, nb = len(a["scores"]), len(b["scores"])
    if na == 0 or nb == 0:
        return np.zeros(na, bool)
    q = iou(torch.as_tensor(np.asarray(a["boxes"]), dtype=torch.float32),
            torch.as_tensor(np.asarray(b["boxes"]), dtype=torch.float32)).numpy()
    ok = ((np.asarray(a["classes"])[:, None] == np.asarray(b["classes"])[None, :]) & (q >= iou_min)
          & (np.abs(np.asarray(a["scores"])[:, None] - np.asarray(b["scores"])[None, :]) <= score_tol))
    return ok.any(1)


def detection_numbers(served: Sequence[Mapping], ref: Sequence[Mapping]) -> Dict[str, float]:
    """Over the sampled images together (%): ``missed_pooled_pct``, the
    reference's detections with no served partner (same class, IoU >= 0.5,
    score within 0.05); ``unmatched_pooled_pct``, the served detections with
    no reference partner. For the record: the worst image's share of its
    detections (both sides) without a partner, and the counts."""
    missed = unmatched = n_ref = n_served = 0
    worst = 0.0
    for s, r in zip(served, ref):
        m = int((~_partners(r, s, MATCH_SCORE, MATCH_IOU)).sum())
        u = int((~_partners(s, r, MATCH_SCORE, MATCH_IOU)).sum())
        n = len(s["scores"]) + len(r["scores"])
        worst = max(worst, 100.0 * (m + u) / n if n else 0.0)
        missed, unmatched = missed + m, unmatched + u
        n_ref, n_served = n_ref + len(r["scores"]), n_served + len(s["scores"])
    return {"missed_pooled_pct": 100.0 * missed / max(n_ref, 1),
            "unmatched_pooled_pct": 100.0 * unmatched / max(n_served, 1),
            "worst_image_disagree_pct": worst,
            "served_per_image": n_served / max(len(served), 1),
            "reference_per_image": n_ref / max(len(ref), 1),
            "reference_min_per_image": float(min(len(r["scores"]) for r in ref)) if ref else 0.0}


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float], names: Sequence[str]) -> float:
    """The worst leaf's |prog norm - ref norm| over max(ref norm of the
    leaf, the median leaf's ref norm)."""
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def training_numbers(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """``prog``/``ref``: "losses" (per step, the losses by name and
    "total_loss"), "grad" and "update" (leaf -> norm); ``ref`` also
    "grad_raw" (leaf -> norm of the plain gradient). Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the update."""
    def gap(key, steps):
        return max(abs(p[key] - r[key]) / abs(r[key]) for p, r in list(zip(prog["losses"], ref["losses"]))[steps])

    names = sorted(ref["grad"])
    if sorted(prog["grad"]) != names:
        raise RuntimeError("the program's trainable leaves differ from the reference's")
    med = statistics.median(ref["grad_raw"][n] for n in names)
    moving = [n for n in names if ref["grad_raw"][n] >= 1e-3 * med]
    out = {"loss_gap": gap("total_loss", slice(None)),
           "grad_gap": leaf_gaps(prog["grad"], ref["grad"], names),
           "update_gap": leaf_gaps(prog["update"], ref["update"], moving),
           "loss_gap_step1": gap("total_loss", slice(0, 1))}
    for k in ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"):
        out[f"{k}_gap"] = gap(k, slice(None))
    out["rpn_loss_gap"] = max(
        abs(p["loss_rpn_cls"] + p["loss_rpn_loc"] - r["loss_rpn_cls"] - r["loss_rpn_loc"])
        / abs(r["loss_rpn_cls"] + r["loss_rpn_loc"]) for p, r in zip(prog["losses"], ref["losses"]))
    trunk = [n for n in names if not n.startswith("roi.")]
    out["grad_gap_trunk"] = leaf_gaps(prog["grad"], ref["grad"], trunk)
    out["update_gap_trunk"] = leaf_gaps(prog["update"], ref["update"], [n for n in moving if n in trunk])
    for key, leaves in (("grad", names), ("update", moving)):
        m = statistics.median(ref[key][n] for n in leaves)
        gaps = sorted(((abs(prog[key][n] - ref[key][n]) / max(ref[key][n], m, 1e-30), n) for n in leaves),
                      reverse=True)
        out[f"{key}_gap_median_leaf"] = statistics.median(g for g, _ in gaps)
        out[f"{key}_gap_p90_leaf"] = float(np.quantile([g for g, _ in gaps], 0.9))
        out[f"{key}_gap_mean_leaf"] = float(np.mean([g for g, _ in gaps]))
        out[f"{key}_worst_leaves"] = " ".join(f"{n}={g:.3g}" for g, n in gaps[:4])
    out["leaves"], out["moving_leaves"] = float(len(names)), float(len(moving))
    return out


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Dict:
    """{"correct": bool, "checks": {name: {"value", "limit"}}}: each number
    at most its limit (a missing or non-finite number fails)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        if name not in numbers:
            raise KeyError(f"no number {name!r} to compare")
        v = float(numbers.get(name, float("nan")))
        checks[name] = {"value": v, "limit": float(limit)}
        ok = ok and bool(np.isfinite(v) and v <= limit)
    return {"correct": ok, "checks": checks}
