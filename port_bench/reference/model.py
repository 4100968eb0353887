"""The detector: weights from a detectron2 state dict, ResNet (caffe-style
bottleneck, frozen BatchNorm folded to an affine), FPN with the max-pool
p6, the RPN with its per-level top-k and NMS, the box head and detectron2's
``fast_rcnn_inference``, the RPN and Fast R-CNN losses, and SGD with
momentum under the warm-up schedule.

Maps are (N, C, H, W) float32; images arrive as (N, H, W, C) frames of
0..255 on a padded canvas, with each image's true (h, w). Leaves are named
as ``<module>.<index>.<leaf>`` after the parameter layout of the detector
being judged, so that both sides' tensors pair by name; their values are
worked out here from the state dict alone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import boxes as bx
from .roi_align import multilevel_roi_align

Tensor = torch.Tensor
STAGES = ("res2", "res3", "res4", "res5")
STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STAGE_OUT = (256, 512, 1024, 2048)
FPN_STRIDES = (4, 8, 16, 32, 64)
FP8_MAX = 448.0  # largest float8 e4m3fn number


@dataclasses.dataclass(frozen=True)
class Config:
    """The numbers of ``config.json``'s "model" and "solver" entries."""

    model: Mapping
    solver: Mapping

    @property
    def dual(self) -> bool:
        return self.model["input_format"] == "BGRTTT"

    def __getitem__(self, key):
        return self.model[key]


FP8_BWD_MAX = 57344.0  # largest float8 e5m2 number


def _round(x: Tensor, dtype, top: float) -> Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _FP8(torch.autograd.Function):
    """Forward: float8 e4m3 under a per-tensor scale; backward: the
    gradient in float8 e5m2 (the usual split of an fp8 training step)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_BWD_MAX)


def fp8(x: Tensor) -> Tensor:
    """``x`` as an fp8 step holds it (see ``_FP8``)."""
    return _FP8.apply(x)


class Net:
    """The reference detector: ``params`` (name -> float32 tensor) and the
    arithmetic; ``precision`` "fp32" or "fp8" (the control: every
    activation the detector being judged holds in bf16, and every weight a
    layer reads, held in fp8 instead; products still accumulate in
    float32)."""

    def __init__(self, cfg: Config, params: Dict[str, Tensor], precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 or fp8")
        self.cfg = cfg
        self.params = params
        self.q = fp8 if precision == "fp8" else (lambda t: t)

    # -- layers -----------------------------------------------------------
    def conv(self, x, name, stride=1, pad=0, bias=True):
        w = self.params[f"{name}.weight"]
        b = self.params.get(f"{name}.bias") if bias else None
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=pad))

    def affine(self, x, name):
        return self.q(x * self.params[f"{name}.scale"][None, :, None, None]
                      + self.params[f"{name}.bias"][None, :, None, None])

    def linear(self, x, name):
        return self.q(F.linear(self.q(x), self.q(self.params[f"{name}.weight"]), self.params[f"{name}.bias"]))

    # -- backbone and FPN --------------------------------------------------
    def resnet(self, bb: str, x: Tensor, training: bool) -> List[Tensor]:
        freeze = self.cfg["freeze_at"] if training else 0
        with torch.set_grad_enabled(torch.is_grad_enabled() and freeze < 1):
            h = torch.relu(self.affine(self.conv(x, f"{bb}.stem.conv1", 2, 3, bias=False), f"{bb}.stem.norm1"))
            h = F.max_pool2d(h, 3, 2, 1)
        outs = []
        grad = torch.is_grad_enabled()
        for i, (stage, n) in enumerate(zip(STAGES, STAGE_BLOCKS[self.cfg["depth"]])):
            with torch.set_grad_enabled(grad and freeze < i + 2):
                for b in range(n):
                    h = self.bottleneck(f"{bb}.{stage}.{b}", h, 2 if b == 0 and i > 0 else 1, b == 0)
            outs.append(h)
        return outs

    def bottleneck(self, name, x, stride, shortcut):
        out = torch.relu(self.affine(self.conv(x, f"{name}.conv1", stride, bias=False), f"{name}.norm1"))
        out = torch.relu(self.affine(self.conv(out, f"{name}.conv2", 1, 1, bias=False), f"{name}.norm2"))
        out = self.affine(self.conv(out, f"{name}.conv3", bias=False), f"{name}.norm3")
        if shortcut:
            x = self.affine(self.conv(x, f"{name}.shortcut", stride, bias=False), f"{name}.shortcut_norm")
        return self.q(torch.relu(out + x))

    def fpn(self, name: str, feats: List[Tensor]) -> List[Tensor]:
        lat = [self.conv(f, f"{name}.lateral.{i}") for i, f in enumerate(feats)]
        merged = [None] * len(lat)
        merged[-1] = lat[-1]
        for i in range(len(lat) - 2, -1, -1):
            up = F.interpolate(merged[i + 1], scale_factor=2, mode="nearest")
            merged[i] = self.q(lat[i] + up[:, :, :lat[i].shape[2], :lat[i].shape[3]])
        outs = [self.conv(m, f"{name}.output.{i}", 1, 1) for i, m in enumerate(merged)]
        return outs + [outs[-1][:, :, ::2, ::2]]

    def features(self, images: Tensor, training: bool = False) -> List[Tensor]:
        """Normalized p2..p6 of raw (N, H, W, C) frames."""
        m = self.cfg
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        mean = torch.tensor(m["pixel_mean"], device=x.device)[None, :, None, None]
        std = torch.tensor(list(m["pixel_std"])[:3] * (2 if m.dual else 1), device=x.device)[None, :, None, None]
        x = (x - mean) / std
        if not m.dual:
            return self.fpn("fpn", self.resnet("backbone", x, training))
        rgb = self.fpn("fpn", self.resnet("backbone", x[:, :3], training))
        thermal = self.fpn("fpn_2", self.resnet("backbone_2", x[:, 3:], training))
        return [torch.cat([a, b], 1) for a, b in zip(rgb, thermal)]

    # -- RPN ----------------------------------------------------------------
    def rpn_head(self, feats: Sequence[Tensor]) -> Tuple[List[Tensor], List[Tensor]]:
        """Per level: objectness (N, H*W*A) and deltas (N, H*W*A, 4), anchors
        fastest."""
        logits, deltas = [], []
        for f in feats:
            t = torch.relu(self.conv(f, "rpn_head.conv", 1, 1))
            o = self.conv(t, "rpn_head.objectness")
            d = self.conv(t, "rpn_head.deltas")
            n, a, h, w = o.shape
            logits.append(o.permute(0, 2, 3, 1).reshape(n, -1))
            deltas.append(d.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(n, -1, 4))
        return logits, deltas

    def anchors(self, feats: Sequence[Tensor]) -> List[Tensor]:
        out = []
        ratios = self.cfg["anchor_aspect_ratios"]
        for f, stride, sizes in zip(feats, FPN_STRIDES, self.cfg["anchor_sizes"]):
            cell = []
            for size in sizes:
                for r in ratios:
                    w = math.sqrt(size * size / r)
                    h = r * w
                    cell.append([-w / 2, -h / 2, w / 2, h / 2])
            cell = torch.tensor(cell, dtype=torch.float32, device=f.device)
            ys = torch.arange(f.shape[2], device=f.device, dtype=torch.float32) * stride
            xs = torch.arange(f.shape[3], device=f.device, dtype=torch.float32) * stride
            sy, sx = torch.meshgrid(ys, xs, indexing="ij")
            shifts = torch.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
            out.append((shifts + cell[None]).reshape(-1, 4))
        return out

    def proposals(self, logits, deltas, anchors, hw, pre: int, post: int):
        """One image's proposals: per level the ``pre`` best anchors,
        decoded, clipped, the empty ones dropped, NMS at the RPN threshold;
        then the ``post`` best over all levels. Returns (boxes (post, 4),
        valid (post,)), best first, empty slots last."""
        h, w = hw
        kept_boxes, kept_scores = [], []
        for lg, dl, an in zip(logits, deltas, anchors):
            k = min(pre, lg.shape[0])
            idx = bx.order_by_score(lg)[:k]
            b = bx.clip(bx.decode(dl[idx], an[idx], (1.0, 1.0, 1.0, 1.0)), h, w)
            s = lg[idx]
            ok = torch.nonzero(((b[:, 2] - b[:, 0]) > self.cfg["rpn"]["min_size"])
                               & ((b[:, 3] - b[:, 1]) > self.cfg["rpn"]["min_size"])).flatten()
            keep = ok[bx.greedy_nms(b[ok], s[ok], self.cfg["rpn"]["nms_thresh"])]
            keep = keep.sort().values  # level order, so ties go as the concatenation orders them
            kept_boxes.append(b[keep])
            kept_scores.append(s[keep])
        b, s = torch.cat(kept_boxes), torch.cat(kept_scores)
        top = bx.order_by_score(s)[:post]
        out = b.new_zeros((post, 4))
        out[: top.numel()] = b[top]
        valid = torch.arange(post, device=b.device) < top.numel()
        return out, valid

    # -- box head ----------------------------------------------------------
    def box_features(self, feats: Sequence[Tensor], img: int, rois: Tensor) -> Tensor:
        """The box head's (K, fc_dim) features of one image's RoIs."""
        roi = self.cfg["roi"]
        pooled = multilevel_roi_align([f[img] for f in feats[:4]], rois, FPN_STRIDES[:4],
                                      roi["pooler_resolution"], roi["pooler_sampling_ratio"])
        x = pooled.reshape(pooled.shape[0], -1)
        x = torch.relu(self.linear(x, "roi.box_head.fcs.0"))
        return torch.relu(self.linear(x, "roi.box_head.fcs.1"))

    def box_head(self, feats: Sequence[Tensor], img: int, rois: Tensor):
        """(class logits (K, C+1), deltas (K, C*4)) of one image's RoIs."""
        x = self.box_features(feats, img, rois)
        return self.linear(x, "roi.output.cls_score"), self.linear(x, "roi.output.bbox_pred")

    # -- inference ---------------------------------------------------------
    def detect(self, images: Tensor, sizes: Sequence[Tuple[int, int]],
               pre: Optional[int] = None, post: Optional[int] = None,
               max_dets: Optional[int] = None) -> List[Dict[str, Tensor]]:
        """detectron2's inference per image in the model-input frame:
        boxes (D, 4), scores (D,), classes (D,), best first."""
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
                cls, dl = self.box_head(feats, i, rois)
                out.append(self.fast_rcnn_inference(cls, dl, rois, hw, max_dets or test["detections_per_image"]))
        return out

    def fast_rcnn_inference(self, cls, deltas, rois, hw, max_dets):
        c = self.cfg["num_classes"]
        test = self.cfg["test"]
        scores = torch.softmax(cls, -1)[:, :-1]
        boxes = bx.clip(bx.decode(deltas, rois, self.cfg["roi"]["bbox_reg_weights"]).reshape(-1, c, 4),
                        *hw)
        flat_s = scores.reshape(-1)
        flat_b = boxes.reshape(-1, 4)
        flat_c = torch.arange(c, device=cls.device).repeat(rois.shape[0])
        cand = torch.nonzero((flat_s > test["score_thresh"]) & torch.isfinite(flat_b).all(-1)).flatten()
        kept = []
        for k in range(c):
            ids = cand[flat_c[cand] == k]
            kept.append(ids[bx.greedy_nms(flat_b[ids], flat_s[ids], test["nms_thresh"])])
        ids = torch.cat(kept).sort().values
        ids = ids[bx.order_by_score(flat_s[ids])][:max_dets]
        return {"boxes": flat_b[ids], "scores": flat_s[ids], "classes": flat_c[ids]}

    # -- training ----------------------------------------------------------
    def losses(self, images: Tensor, sizes, gt_boxes: Tensor, gt_classes: Tensor, gt_valid: Tensor,
               rpn_rand: Tensor, roi_rand: Tensor, batch: int) -> Dict[str, Tensor]:
        """The four losses of images ``images`` (a slice of a batch of
        ``batch``), each summed over these images and divided by ``batch``,
        so that the slices of a batch add up to the batch's mean. The
        samplers' priorities ``rpn_rand`` (n, anchors) and ``roi_rand`` (n,
        post + G) order the positives and the negatives alike."""
        m = self.cfg
        feats = self.features(images, training=True)
        logits, deltas = self.rpn_head(feats)
        level_anchors = self.anchors(feats)
        anchors = torch.cat(level_anchors)
        all_logits, all_deltas = torch.cat(logits, 1), torch.cat(deltas, 1)
        total = {k: images.new_zeros(()) for k in ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg")}
        rpn, roi = m["rpn"], m["roi"]
        for i, hw in enumerate(sizes):
            g = gt_boxes[i][gt_valid[i]]
            gc = gt_classes[i][gt_valid[i]]
            # RPN: label every anchor, sample, BCE and L1 over the sample
            labels, matched = self.match(bx.iou(g, anchors), rpn["iou_thresholds"], (0, -1, 1), True)
            pos, neg = sample(labels, rpn["batch_size_per_image"], rpn["positive_fraction"], rpn_rand[i])
            sel = torch.cat([pos, neg])
            target = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)]).to(torch.float32)
            total["loss_rpn_cls"] = total["loss_rpn_cls"] + F.binary_cross_entropy_with_logits(
                all_logits[i][sel], target, reduction="sum") / rpn["batch_size_per_image"]
            gt_d = bx.encode(anchors[pos], g[matched[pos]], (1.0, 1.0, 1.0, 1.0))
            total["loss_rpn_loc"] = total["loss_rpn_loc"] + (all_deltas[i][pos] - gt_d).abs().sum() \
                / rpn["batch_size_per_image"]
            # RoI heads: proposals (no gradient) + gt, label, sample, CE and L1
            with torch.no_grad():
                props, valid = self.proposals([x[i].detach() for x in logits], [x[i].detach() for x in deltas],
                                              level_anchors, hw, rpn["pre_nms_topk_train"],
                                              rpn["post_nms_topk_train"])
            cand = torch.cat([props, gt_boxes[i]])
            cand_valid = torch.cat([valid, gt_valid[i]])
            q = torch.where(cand_valid[None, :], bx.iou(g, cand), 0.0)
            labels, matched = self.match(q, (roi["iou_threshold"],), (0, 1), False)
            labels = torch.where(cand_valid, labels, -1)
            if g.shape[0] == 0:
                labels = torch.where(labels == 1, -1, labels)
            pos, neg = sample(labels, roi["batch_size_per_image"], roi["positive_fraction"], roi_rand[i])
            sel = torch.cat([pos, neg])
            classes = torch.cat([gc[matched[pos]], torch.full_like(neg, m["num_classes"])])
            cls, dl = self.box_head(feats, i, cand[sel])
            n = max(sel.numel(), 1)
            total["loss_cls"] = total["loss_cls"] + F.cross_entropy(cls, classes, reduction="sum") / n
            c = m["num_classes"]
            pred = dl[: pos.numel()].reshape(-1, c, 4)[torch.arange(pos.numel(), device=dl.device),
                                                       classes[: pos.numel()]]
            gt_d = bx.encode(cand[pos], g[matched[pos]], roi["bbox_reg_weights"])
            total["loss_box_reg"] = total["loss_box_reg"] + (pred - gt_d).abs().sum() / n
        return {k: v / batch for k, v in total.items()}

    @staticmethod
    def match(quality: Tensor, thresholds, labels, low_quality: bool):
        """detectron2's ``Matcher`` over (G, N) quality: (labels (N,), the
        matched gt row (N,)); no gt labels everything with ``labels[0]``."""
        n = quality.shape[1]
        if quality.shape[0] == 0:
            return (torch.full((n,), labels[0], dtype=torch.long, device=quality.device),
                    torch.zeros(n, dtype=torch.long, device=quality.device))
        vals, idx = quality.max(0)
        out = torch.full((n,), labels[0], dtype=torch.long, device=quality.device)
        bounds = [-math.inf] + list(thresholds) + [math.inf]
        for lo, hi, lab in zip(bounds[:-1], bounds[1:], labels):
            out = torch.where((vals >= lo) & (vals < hi), lab, out)
        if low_quality:
            best = quality.max(1, keepdim=True).values
            out = torch.where(((quality >= best) & (best > 0)).any(0), 1, out)
        return out, idx


def sample(labels: Tensor, num: int, fraction: float, rand: Tensor) -> Tuple[Tensor, Tensor]:
    """detectron2's ``subsample_labels`` with given priorities: the
    ``min(#pos, num * fraction)`` positives and then up to ``num`` in all
    negatives of highest priority (ties to the lower index)."""
    pos = torch.nonzero(labels == 1).flatten()
    neg = torch.nonzero(labels == 0).flatten()
    n_pos = min(pos.numel(), int(num * fraction))
    n_neg = min(neg.numel(), num - n_pos)
    pos = pos[bx.order_by_score(rand[pos])[:n_pos]]
    neg = neg[bx.order_by_score(rand[neg])[:n_neg]]
    return pos, neg


def fold(sd: Mapping[str, Tensor], key: str, eps: float = 1e-5) -> Tuple[Tensor, Tensor]:
    """A frozen BatchNorm as (scale, bias), worked out in float64."""
    w, b = sd[f"{key}.weight"].double(), sd[f"{key}.bias"].double()
    mean, var = sd[f"{key}.running_mean"].double(), sd[f"{key}.running_var"].double()
    scale = w / torch.sqrt(var + eps)
    return scale.float(), (b - mean * scale).float()


def params_from_d2(cfg: Config, sd: Mapping[str, Tensor], device) -> Dict[str, Tensor]:
    """The reference's leaves from a detectron2 state dict (OIHW convs,
    (out, in) linears, box head fc1 over NCHW-flattened RoIs)."""
    sd = {k: torch.as_tensor(v).to(device, copy=True) for k, v in sd.items()}
    p: Dict[str, Tensor] = {}

    def norm(dst, src):
        p[f"{dst}.scale"], p[f"{dst}.bias"] = fold(sd, src)

    def copy(dst, src, bias=True):
        p[f"{dst}.weight"] = sd[f"{src}.weight"].float().contiguous()
        if bias:
            p[f"{dst}.bias"] = sd[f"{src}.bias"].float()

    for bb, fpn, src in (("backbone", "fpn", "backbone"), ("backbone_2", "fpn_2", "backbone_2")):
        if bb == "backbone_2" and not cfg.dual:
            continue
        copy(f"{bb}.stem.conv1", f"{src}.bottom_up.stem.conv1", bias=False)
        norm(f"{bb}.stem.norm1", f"{src}.bottom_up.stem.conv1.norm")
        for stage, n in zip(STAGES, STAGE_BLOCKS[cfg["depth"]]):
            for b in range(n):
                d, s = f"{bb}.{stage}.{b}", f"{src}.bottom_up.{stage}.{b}"
                for i in (1, 2, 3):
                    copy(f"{d}.conv{i}", f"{s}.conv{i}", bias=False)
                    norm(f"{d}.norm{i}", f"{s}.conv{i}.norm")
                if b == 0:
                    copy(f"{d}.shortcut", f"{s}.shortcut", bias=False)
                    norm(f"{d}.shortcut_norm", f"{s}.shortcut.norm")
        for i in range(4):
            copy(f"{fpn}.lateral.{i}", f"{src}.fpn_lateral{i + 2}")
            copy(f"{fpn}.output.{i}", f"{src}.fpn_output{i + 2}")
    copy("rpn_head.conv", "proposal_generator.rpn_head.conv")
    copy("rpn_head.objectness", "proposal_generator.rpn_head.objectness_logits")
    copy("rpn_head.deltas", "proposal_generator.rpn_head.anchor_deltas")
    copy("roi.box_head.fcs.0", "roi_heads.box_head.fc1")
    copy("roi.box_head.fcs.1", "roi_heads.box_head.fc2")
    copy("roi.output.cls_score", "roi_heads.box_predictor.cls_score")
    copy("roi.output.bbox_pred", "roi_heads.box_predictor.bbox_pred")
    return p


def trainable(cfg: Config, name: str) -> bool:
    """Whether SGD moves leaf ``name`` under the configuration's freeze."""
    parts = name.split(".")
    if parts[0] not in ("backbone", "backbone_2"):
        return True
    first = 1 if parts[1] == "stem" else STAGES.index(parts[1]) + 2
    return cfg["freeze_at"] < first


def lr_at(solver: Mapping, step: int) -> float:
    """WarmupMultiStepLR with a linear warm-up."""
    if step < solver["warmup_iters"]:
        a = step / solver["warmup_iters"]
        warm = solver["warmup_factor"] * (1 - a) + a
    else:
        warm = 1.0
    return solver["base_lr"] * warm * solver["gamma"] ** sum(step >= s for s in solver["steps"])


def sgd_step(cfg: Config, params: Dict[str, Tensor], grads: Mapping[str, Tensor],
             momentum: Dict[str, Tensor], step: int) -> None:
    """v = mu v + g + wd p; p -= lr v, in place, for the trainable leaves;
    biases and affine scales take the bias decay and learning-rate factor."""
    s = cfg.solver
    lr = lr_at(s, step)
    with torch.no_grad():
        for name, g in grads.items():
            bias = name.rsplit(".", 1)[-1] in ("bias", "scale")
            wd = s["weight_decay_bias"] if bias else s["weight_decay"]
            factor = s["bias_lr_factor"] if bias else 1.0
            v = s["momentum"] * momentum.get(name, torch.zeros_like(g)) + g + wd * params[name]
            momentum[name] = v
            params[name].sub_(lr * factor * v)


def level_sizes(canvas: Sequence[int]) -> List[Tuple[int, int]]:
    """(H, W) of p2..p6 on a padded canvas."""
    h, w = canvas
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1  # stem conv 7x7/2, pad 3
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1  # max-pool 3x3/2, pad 1
    out = [(h, w)]
    for _ in range(3):
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        out.append((h, w))
    return out + [((h - 1) // 2 + 1, (w - 1) // 2 + 1)]


def num_anchors(cfg: Config, canvas: Sequence[int]) -> int:
    per_cell = [len(s) * len(cfg["anchor_aspect_ratios"]) for s in cfg["anchor_sizes"]]
    return sum(h * w * a for (h, w), a in zip(level_sizes(canvas), per_cell))


def step_seed(seed: int, step: int) -> int:
    """The seed of a step's sampling generator, derived from the state's
    seed as the program under test derives it, so that both sides sample
    with the same priorities."""
    return hash((seed, step)) & 0x7FFF_FFFF_FFFF_FFFF
