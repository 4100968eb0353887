"""ProbEn late fusion, plainly (Chen et al., "Multimodal Object Detection via
Probabilistic Ensembling", ECCV 2022): member detectors with the variance
head, and the fusion of their detections, one image and one cluster at a
time in float32.

``MemberNet`` is the reference detector (``model.Net``) as a ProbEn member:
BGR, BGRT (one backbone whose stem takes four channels) or BGRTTT (middle
fusion), with the box-uncertainty head ``exp(var_pred(x))`` beside the box
predictor; its detections carry each one's RoI's foreground probabilities
and variance, as the reference's saved predictions do
(``demo_FLIR_save_predictions.py``).

``fuse`` transliterates the greedy loop of ``demo_probEn.py:92-196``
(``nms_bayesian``, ``bayesian_fusion_multiclass``, ``weighted_box_fusion``)
over the union of the members' detections: the highest-scoring box left is
a cluster's head, every box left whose legacy (+1) IoU with it exceeds the
threshold, coordinates shifted by the class times the frame's width and
height, joins it; a cluster of one passes through, a larger one gets its
score from the members' probabilities by Bayesian log-odds fusion (``probEn``:
each row extended by the background 1 - sum, logs summed, renormalised) or
their mean (``avg``) or largest (``max``), and its box as the average of
the members' boxes weighted by 1 / variance (``v-avg``), by score
(``s-avg``), unweighted (``avg``), or the best member's (``argmax``). It
does not call, and is not written like, the program's masked-matrix form.

Departures from the reference code, none of which the benchmark's frames
reach except where said:

- ties in score are taken in the order of the union (members in order, each
  member's detections best first), lower index first; numpy's
  ``argsort()[::-1]`` takes the higher index first;
- the background column 1 - sum is clamped at 1e-30 before the log, where
  ``np.log`` gives -inf (or NaN once rounding makes it negative);
- the apply_late_fusion dispatch (``demo_probEn.py:223-267``) is not taken:
  a member with no detections adds nothing to the union, and one member
  alone is clustered like several, not passed through; and (``max``,
  ``argmax``) is the loop above, not the plain class-wise NMS;
- the log-variance is not clamped; the program clamps it to [-25, 25],
  which no calibrated member reaches (its spread is 1).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from . import boxes as bx
from .model import Config, Net, Tensor, params_from_d2

SCORE_METHODS = ("probEn", "avg", "max")
BOX_METHODS = ("v-avg", "s-avg", "avg", "argmax")
TINY = 1e-30


def member_params(cfg: Config, sd: Mapping[str, Tensor], device) -> Dict[str, Tensor]:
    """``model.params_from_d2`` and the variance head's leaves."""
    p = params_from_d2(cfg, sd, device)
    for leaf in ("weight", "bias"):
        p[f"roi.output.var_pred.{leaf}"] = torch.as_tensor(
            sd[f"roi_heads.box_predictor.var_pred.{leaf}"]).to(device, torch.float32, copy=True)
    return p


class MemberNet(Net):
    """The reference detector as a ProbEn member (see the module's
    docstring); ``params`` from ``member_params``."""

    def features(self, images: Tensor, training: bool = False) -> List[Tensor]:
        m = self.cfg
        if m.dual or images.shape[-1] == 3:
            return super().features(images, training)
        if images.shape[-1] != len(m["pixel_mean"]) or images.shape[-1] != len(m["pixel_std"]):
            raise ValueError(f"{images.shape[-1]} channels against pixel_mean {m['pixel_mean']} "
                             f"and pixel_std {m['pixel_std']}")
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        mean = torch.tensor(m["pixel_mean"], device=x.device)[None, :, None, None]
        std = torch.tensor(m["pixel_std"], device=x.device)[None, :, None, None]
        return self.fpn("fpn", self.resnet("backbone", (x - mean) / std, training))

    def detect(self, images: Tensor, sizes: Sequence[Tuple[int, int]], pre: Optional[int] = None,
               post: Optional[int] = None, max_dets: Optional[int] = None) -> List[Dict[str, Tensor]]:
        """``Net.detect`` with, per detection, its RoI's foreground
        probabilities ``probs`` (D, C) and variance ``variance`` (D,)."""
        m = self.cfg
        rpn, test = m["rpn"], m["test"]
        with torch.no_grad():
            feats = self.features(images)
            logits, deltas = self.rpn_head(feats)
            anchors = self.anchors(feats)
            out = []
            for i, hw in enumerate(sizes):
                rois, valid = self.proposals([x[i] for x in logits], [x[i] for x in deltas], anchors, hw,
                                             pre or rpn["pre_nms_topk_test"], post or rpn["post_nms_topk_test"])
                rois = rois[valid]
                x = self.box_features(feats, i, rois)
                cls = self.linear(x, "roi.output.cls_score")
                det = self.detections(cls, self.linear(x, "roi.output.bbox_pred"), rois, hw,
                                      max_dets or test["detections_per_image"])
                rows = det.pop("rows")
                det["probs"] = torch.softmax(cls, -1)[rows, :-1]
                det["variance"] = torch.exp(self.linear(x, "roi.output.var_pred"))[rows, 0]
                out.append(det)
        return out

    def detections(self, cls: Tensor, deltas: Tensor, rois: Tensor, hw, max_dets: int) -> Dict[str, Tensor]:
        """``Net.fast_rcnn_inference`` with each detection's RoI row."""
        c = self.cfg["num_classes"]
        test = self.cfg["test"]
        scores = torch.softmax(cls, -1)[:, :-1]
        boxes = bx.clip(bx.decode(deltas, rois, self.cfg["roi"]["bbox_reg_weights"]).reshape(-1, c, 4), *hw)
        flat_s, flat_b = scores.reshape(-1), boxes.reshape(-1, 4)
        flat_c = torch.arange(c, device=cls.device).repeat(rois.shape[0])
        cand = torch.nonzero((flat_s > test["score_thresh"]) & torch.isfinite(flat_b).all(-1)).flatten()
        kept = []
        for k in range(c):
            ids = cand[flat_c[cand] == k]
            kept.append(ids[bx.greedy_nms(flat_b[ids], flat_s[ids], test["nms_thresh"])])
        ids = torch.cat(kept).sort().values
        ids = ids[bx.order_by_score(flat_s[ids])][:max_dets]
        return {"boxes": flat_b[ids], "scores": flat_s[ids], "classes": flat_c[ids], "rows": ids // c}


def union(members: Sequence[Mapping[str, Tensor]]) -> Dict[str, Tensor]:
    """One image's detections of every member, concatenated in member
    order, as float32 (classes int64) on the CPU."""
    keys = ("boxes", "scores", "classes", "probs", "variance")
    out = {k: torch.cat([torch.as_tensor(m[k]).detach().cpu() for m in members]) for k in keys}
    for k in ("boxes", "scores", "probs", "variance"):
        out[k] = out[k].to(torch.float32)
    out["classes"] = out["classes"].to(torch.int64)
    return out


def fuse(dets: Mapping[str, Tensor], score_method: str = "probEn", box_method: str = "v-avg",
         thresh: float = 0.5, class_offset: Tuple[float, float] = (640.0, 512.0),
         topk: int = 100) -> Dict[str, Tensor]:
    """The greedy ProbEn loop over one image's union (``union``): boxes
    (K, 4), scores (K,), classes (K,), and each cluster's number of
    detections ``size`` (K,), cluster heads best first, at most ``topk``."""
    if score_method not in SCORE_METHODS or box_method not in BOX_METHODS:
        raise ValueError(f"methods {score_method!r}, {box_method!r}: {SCORE_METHODS} x {BOX_METHODS}")
    boxes, scores, classes, probs = dets["boxes"], dets["scores"], dets["classes"], dets["probs"]
    variance = dets.get("variance")
    if box_method == "v-avg" and variance is None:
        raise ValueError("v-avg needs each detection's variance")
    off = classes.to(torch.float32)
    shifted = boxes + torch.stack([off * class_offset[0], off * class_offset[1]] * 2, -1)
    areas = (shifted[:, 2] - shifted[:, 0] + 1.0) * (shifted[:, 3] - shifted[:, 1] + 1.0)
    order = sorted(range(scores.shape[0]), key=lambda i: -float(scores[i]))  # stable: ties by index
    out_b, out_s, out_c, out_n = [], [], [], []
    while order and len(out_s) < topk:
        head, rest = order[0], order[1:]
        r = torch.tensor(rest, dtype=torch.long)
        w = (torch.minimum(shifted[head, 2], shifted[r, 2]) - torch.maximum(shifted[head, 0], shifted[r, 0])
             + 1.0).clamp(min=0.0)
        h = (torch.minimum(shifted[head, 3], shifted[r, 3]) - torch.maximum(shifted[head, 1], shifted[r, 1])
             + 1.0).clamp(min=0.0)
        inter = w * h
        ovr = (inter / (areas[head] + areas[r] - inter)).tolist()
        cluster = [head] + [j for j, o in zip(rest, ovr) if o > thresh]
        order = [j for j, o in zip(rest, ovr) if o <= thresh]
        out_n.append(len(cluster))
        if len(cluster) == 1:
            out_b.append(boxes[head])
            out_s.append(scores[head])
            out_c.append(classes[head])
            continue
        idx = torch.tensor(cluster, dtype=torch.long)
        if score_method == "probEn":
            p = probs[idx]
            ext = torch.cat([p, 1.0 - p.sum(1, keepdim=True)], 1)
            logit = torch.log(ext.clamp(min=TINY)).sum(0)
            e = torch.exp(logit - logit.max())
            norm = e / e.sum()
            out_s.append(norm.max())
            out_c.append(norm.argmax())
        elif score_method == "avg":
            out_s.append(scores[idx].mean())
            out_c.append(classes[head])
        else:
            out_s.append(probs[idx].max())
            out_c.append(classes[head])
        if box_method == "argmax":
            out_b.append(boxes[idx[scores[idx].argmax()]])
        else:
            weight = {"v-avg": lambda: 1.0 / variance[idx], "s-avg": lambda: scores[idx],
                      "avg": lambda: torch.ones(len(cluster))}[box_method]()
            out_b.append((boxes[idx] * weight[:, None]).sum(0) / weight.sum())
    if not out_s:
        return {"boxes": boxes.new_zeros((0, 4)), "scores": scores.new_zeros((0,)),
                "classes": classes.new_zeros((0,)), "size": classes.new_zeros((0,))}
    return {"boxes": torch.stack(out_b), "scores": torch.stack(out_s).to(torch.float32),
            "classes": torch.stack(out_c).to(torch.int64), "size": torch.tensor(out_n, dtype=torch.int64)}
