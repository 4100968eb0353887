"""The architecture ``proben_late``: ProbEn late fusion (ProbEn3 on FLIR),
three R101-FPN members with the variance head on one 6-channel BGRTTT
frame, each on its own channels (thermal-only on TTT, 3:6; BGRT early
fusion, 0:4; BGRTTT middle fusion, 0:6), their detections fused by
``probEn`` scores and ``v-avg`` boxes. The program is
``proben_tpu_torch.engine.ProbEnPredictor``, built by ``from_cfgs`` from
the members' frozen YAMLs as users build it; the reference is
``reference/proben.py``'s members and fusion loop.

The members' parts come from ``faster_rcnn_fpn.py`` (config check, weights,
FLOPs, the custom ops' counts). Their heads are fitted here with the member
reference (which adds the BGRT stem's normalisation and the variance head)
to frames with ground truth, so that the members fire on the same objects
and their detections cluster in the fusion as trained members' do. No training cell runs this architecture: ``trainer`` and
``reference_steps`` raise.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from harness import cells, frames
from harness.cells import free, tf32_off
from harness.frames import resized_hw
from proben_tpu_torch.checkpoint.torch_import import import_detectron2_checkpoint
from proben_tpu_torch.config import model_config_from_cfg
from proben_tpu_torch.engine.ensemble import ProbEnPredictor
from proben_tpu_torch.models.rcnn import init_rcnn
from reference import boxes as bx
from reference import proben as ref_proben
from reference.model import Config

fpn = cells.load_module(Path(__file__).with_name("faster_rcnn_fpn.py"))
OPS = fpn.OPS
CHECK_CHUNK = 4
VAR = "roi_heads.box_predictor.var_pred"
IN_CHANNELS = {"BGR": 3, "BGRT": 4, "BGRTTT": 6}


def channels(conf: Mapping) -> int:
    return 6


def read_config(config_dir: str, conf: Mapping) -> Dict:
    """Each member's CfgNode, read and checked as ``faster_rcnn_fpn`` reads
    one, and the members' settings it does not check (the variance head,
    class logits out, their channels), with the fusion's settings."""
    members = []
    for m in conf["members"]:
        cfg = fpn.read_config(config_dir, m)
        got = {"enable_gaussian_nll": cfg.MODEL.ROI_HEADS.ENABLE_GAUSSIANNLLOSS,
               "output_logits": cfg.MODEL.ROI_BOX_HEAD.OUTPUT_LOGITS}
        want = {"enable_gaussian_nll": m["model"]["enable_gaussian_nll"], "output_logits": True}
        if got != want:
            raise RuntimeError(f"config: member {m['name']} reads {got}, config.json has {want}")
        start, stop = m["channels"]
        if stop - start != IN_CHANNELS[m["model"]["input_format"]] or stop > channels(conf):
            raise RuntimeError(f"config: member {m['name']} ({m['model']['input_format']}) on channels "
                               f"{start}:{stop}")
        if m["input"] != conf["input"]:
            raise RuntimeError(f"config: member {m['name']} has its own input sizes")
        members.append((cfg, (start, stop)))
    fusion = conf["fusion"]
    if list(fusion["class_offset"]) != [float(x) for x in conf["input"]["frame_hw"][::-1]]:
        raise RuntimeError(f"config: class offset {fusion['class_offset']} is not the frame's (w, h)")
    return {"members": members, "fusion": fusion}


def _fusion_kwargs(fusion: Mapping) -> Dict:
    return {"score_method": fusion["score_method"], "box_method": fusion["box_method"],
            "thresh": fusion["iou_thresh"], "class_offset": tuple(fusion["class_offset"]), "topk": fusion["topk"]}


def predictor(pcfg: Mapping, state: List[Mapping[str, np.ndarray]], device) -> ProbEnPredictor:
    members = []
    for (cfg, ch), sd in zip(pcfg["members"], state):
        params = import_detectron2_checkpoint(dict(sd), init_rcnn(0, model_config_from_cfg(cfg)))
        members.append((cfg, params, ch))
    return ProbEnPredictor.from_cfgs(members, device=device, **_fusion_kwargs(pcfg["fusion"]))


def trainer(pcfg, state, seed: int, device):
    raise NotImplementedError("proben_late: no training cell; each member trains as its own configuration")


def reference_steps(conf, state, pool, seed, steps, device, precision="fp32", batch_filter=None):
    raise NotImplementedError("proben_late: no training cell; each member trains as its own configuration")


# ---------------------------------------------------------------------------
# the reference's answers
# ---------------------------------------------------------------------------


def member_detections(m: Mapping, sd: Mapping, images: List[torch.Tensor], device,
                      precision: str = "fp32") -> List[Dict[str, torch.Tensor]]:
    """The member reference's detections of its channels of ``images`` (H,
    W, 6) in the original frame, rescaled and clipped as ``Predictor.infer``
    does, with their probabilities and variances, on the CPU."""
    cfg = Config(m["model"], m["solver"])
    net = ref_proben.MemberNet(cfg, ref_proben.member_params(cfg, sd, device), precision)
    inp = m["input"]
    hw = resized_hw(inp["frame_hw"], inp["min_size_test"], inp["max_size_test"])
    oh, ow = inp["frame_hw"]
    scale = torch.tensor([ow / hw[1], oh / hw[0]] * 2, device=device)
    start, stop = m["channels"]
    out = []
    for s in range(0, len(images), CHECK_CHUNK):
        chunk = torch.stack(images[s:s + CHECK_CHUNK]).to(device)[..., start:stop]
        with tf32_off():
            dets = net.detect(chunk, [hw] * chunk.shape[0])
        for d in dets:
            d["boxes"] = bx.clip(d["boxes"] * scale, float(oh), float(ow))
            out.append({k: v.cpu() for k, v in d.items()})
    del net
    free(device)
    return out


def reference_detections(conf: Mapping, state: List[Mapping], images: List[torch.Tensor], device,
                         precision: str = "fp32") -> List[Dict[str, np.ndarray]]:
    """The member references' detections at ``precision`` ("fp8": the
    control, the members in float8), fused by the reference loop in
    float32."""
    per_member = [member_detections(m, sd, images, device, precision) for m, sd in zip(conf["members"], state)]
    f = conf["fusion"]
    out = []
    for dets in zip(*per_member):
        fused = ref_proben.fuse(ref_proben.union(dets), f["score_method"], f["box_method"], f["iou_thresh"],
                                tuple(f["class_offset"]), f["topk"])
        out.append({k: v.numpy() for k, v in fused.items()})
    return out


# ---------------------------------------------------------------------------
# the model state: each member's detectron2-named weights, drawn and fitted
# ---------------------------------------------------------------------------


def member_seed(seed: int, i: int) -> int:
    return seed * 3 + i


def calibration_batch(conf: Mapping, seed: int, device) -> Dict:
    """``calibration_images`` frames at the test size, each with
    ``calibration_objects_per_frame`` objects, and their ground truth, drawn
    from ``seed`` by the harness's generator (an inference batch carries no
    ground truth)."""
    w, inp = conf["members"][0]["weights"], conf["input"]
    n = w["calibration_objects_per_frame"]
    traffic = {"batch": w["calibration_images"], "pool_batches": 1,
               "boxes_per_image": {"median": n, "sigma": 0.0, "min": n, "max": n}}
    test = dict(inp, min_size_train=[inp["min_size_test"]], max_size_train=inp["max_size_test"])
    return frames.training_pool(seed, traffic, test, channels(conf), device)[0]


def make_state(conf: Mapping, seed: int, batch: Mapping, device) -> List[Dict[str, np.ndarray]]:
    """Per member, random weights as a detectron2 state dict (on the host):
    ``faster_rcnn_fpn``'s draw from the member's seed plus the variance
    head's, then fitted by ``fit`` to the member's channels of the frames of
    ``calibration_batch`` (drawn from ``seed``), its detections counted on
    the first frames of ``batch``, which it was not fitted to."""
    cal = calibration_batch(conf, seed, device)
    sizes = [tuple(hw) for hw in cal["image_size"].tolist()]
    gb, gc, gv = cal["gt"]
    gt = [(gb[i][gv[i]], gc[i][gv[i]].long()) for i in range(len(sizes))]
    k = conf["members"][0]["weights"]["calibration_images"]
    held = batch["image"][:k]
    held_sizes = [tuple(hw) for hw in batch["image_size"][:k].tolist()]
    out = []
    for i, m in enumerate(conf["members"]):
        s = member_seed(seed, i)
        sd = fpn.make_state_dict(m["model"], m["weights"], s, device)
        gen = torch.Generator(device=device).manual_seed(s)
        var = {f"{VAR}.weight": torch.randn((1, m["model"]["roi"]["fc_dim"]), generator=gen, device=device),
               f"{VAR}.bias": torch.zeros((1,), device=device)}
        start, stop = m["channels"]
        fit(m["model"], m["weights"], {**sd, **var}, cal["image"][..., start:stop], sizes, gt,
            held[..., start:stop], held_sizes)
        state = fpn.to_numpy(sd)
        state.update({n: t.cpu().numpy() for n, t in var.items()})
        out.append(state)
        del sd, var
        free(device)
    return out


def _ridge(gram: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(X^T W X + lambda I)^-1 X^T W Y, lambda a tenth of the mean diagonal:
    weaker, the fit's weights grow and cancel, and the rounding of their
    sums in float32 or bf16 grows with them."""
    lam = 0.1 * float(gram.diagonal().mean())
    return torch.linalg.solve(gram + lam * torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device), rhs)


def _ones(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.to(torch.float64), x.new_ones((x.shape[0], 1), dtype=torch.float64)], 1)


def fit(model: Mapping, weights: Mapping, sd: Mapping[str, torch.Tensor], images: torch.Tensor, sizes,
        gt: Sequence, held: torch.Tensor, held_sizes) -> None:
    """Fit, in place, a member's heads to ``images`` and their ground truth
    ``gt`` [(boxes, classes)], with the member reference in float32 (so that
    BGRT is normalised over its four channels), as training would leave
    them, so that every member fires on the frames' objects as trained
    ProbEn members do and their detections cluster: by ridge regression,
    positives and negatives weighted alike, the RPN's objectness on its
    hidden features to the anchors' labels (IoU 0.7 / 0.3, each box's best
    anchor positive), then the box classifier on the box head's features of
    the proposals to their labels (the class of a ground-truth box at IoU
    0.5, else background), and the box regression, shared by the classes,
    to the positives' ground-truth deltas. The objectness, the RPN deltas,
    the class logits and the log-variance are then centred and scaled to
    the configured spreads, and the background logit raised until the
    frames ``held`` (with their sizes ``held_sizes``), which the heads were
    not fitted to, give ``detections_per_image`` detections each on
    average, above the score threshold, after NMS: counted on the fitted
    frames, the count would not hold on others."""
    cfg = Config(model, {})
    dev = images.device
    rpn, box = "proposal_generator.rpn_head", "roi_heads.box_predictor"
    with tf32_off(), torch.no_grad():
        net = ref_proben.MemberNet(cfg, ref_proben.member_params(cfg, sd, dev))
        chunks = [net.features(images[s:s + CHECK_CHUNK]) for s in range(0, len(sizes), CHECK_CHUNK)]
        feats = [torch.cat(level) for level in zip(*chunks)]
        del chunks
        hidden = [torch.relu(net.conv(f, "rpn_head.conv", 1, 1)) for f in feats]
        anchors = torch.cat(net.anchors(feats))
        a = len(model["anchor_aspect_ratios"])
        w_obj = sd[f"{rpn}.objectness_logits.weight"]
        grams = {(k, pos): 0.0 for k in range(a) for pos in (True, False)}
        sums, counts = dict(grams), dict(grams)
        for i, (g, _) in enumerate(gt):
            x = _ones(torch.cat([t[i].permute(1, 2, 0).reshape(-1, t.shape[1]) for t in hidden]))
            labels = net.match(bx.iou(g, anchors), model["rpn"]["iou_thresholds"], (0, -1, 1), True)[0]
            labels = labels.view(x.shape[0], a)
            for k in range(a):
                for pos in (True, False):
                    rows = x[labels[:, k] == int(pos)]
                    grams[k, pos] = grams[k, pos] + rows.t() @ rows
                    sums[k, pos] = sums[k, pos] + rows.sum(0)
                    counts[k, pos] += rows.shape[0]
        for k in range(a):
            npos, nneg = max(counts[k, True], 1), max(counts[k, False], 1)
            sol = _ridge(grams[k, True] / npos + grams[k, False] / nneg, sums[k, True] / npos - sums[k, False] / nneg)
            w_obj[k] = sol[:-1].view(w_obj.shape[1:]).to(w_obj.dtype)
        for key, std in (("objectness_logits", weights["rpn_objectness_logit_std"]),
                         ("anchor_deltas", weights["rpn_delta_std"])):
            w = sd[f"{rpn}.{key}.weight"]
            outs = torch.cat([torch.nn.functional.conv2d(t, w).permute(0, 2, 3, 1).reshape(-1, w.shape[0])
                              for t in hidden])
            fpn._centre(w, sd[f"{rpn}.{key}.bias"], outs, std)
        del hidden
        net = ref_proben.MemberNet(cfg, ref_proben.member_params(cfg, sd, dev))
        logits, deltas = net.rpn_head(feats)
        level_anchors = net.anchors(feats)
        xs, rois_all, labels, targets = [], [], [], []
        k_bg = model["num_classes"]
        for i, (hw, (g, gcls)) in enumerate(zip(sizes, gt)):
            rois, valid = net.proposals([x[i] for x in logits], [x[i] for x in deltas], level_anchors, hw,
                                        model["rpn"]["pre_nms_topk_test"], model["rpn"]["post_nms_topk_test"])
            rois = rois[valid]
            lab, matched = net.match(bx.iou(g, rois), (model["roi"]["iou_threshold"],), (0, 1), False)
            xs.append(net.box_features(feats, i, rois))
            rois_all.append(rois)
            labels.append(torch.where(lab == 1, gcls[matched] if g.shape[0] else k_bg, k_bg))
            targets.append(bx.encode(rois, g[matched], model["roi"]["bbox_reg_weights"]) if g.shape[0]
                           else rois.new_zeros(rois.shape))
        del feats, logits, deltas
        x, label, target = _ones(torch.cat(xs)), torch.cat(labels), torch.cat(targets)
        fg = label != k_bg
        weight = torch.where(fg, 1.0 / max(int(fg.sum()), 1), 1.0 / max(int((~fg).sum()), 1)).to(x.dtype)
        onehot = 2.0 * torch.nn.functional.one_hot(label, k_bg + 1).to(x.dtype) - 1.0
        sol = _ridge(x.t() @ (x * weight[:, None]), x.t() @ (onehot * weight[:, None]))
        w_cls, b_cls = sd[f"{box}.cls_score.weight"], sd[f"{box}.cls_score.bias"]
        w_cls.copy_(sol[:-1].t())
        if bool(fg.any()):
            reg = _ridge(x[fg].t() @ x[fg], x[fg].t() @ target[fg].to(x.dtype))
            sd[f"{box}.bbox_pred.weight"].copy_(reg[:-1].t().repeat(k_bg, 1))
            sd[f"{box}.bbox_pred.bias"].copy_(reg[-1].repeat(k_bg))
        x = x[:, :-1].to(torch.float32)
        for key, std in (("cls_score", weights["class_logit_std"]), ("var_pred", weights["var_logit_std"])):
            w = sd[f"{box}.{key}.weight"]
            fpn._centre(w, sd[f"{box}.{key}.bias"], x @ w.t(), std)
        xs, rois_all = [], []
        for s in range(0, len(held_sizes), CHECK_CHUNK):
            feats = net.features(held[s:s + CHECK_CHUNK])
            logits, deltas = net.rpn_head(feats)
            level_anchors = net.anchors(feats)
            for i, hw in enumerate(held_sizes[s:s + CHECK_CHUNK]):
                rois, valid = net.proposals([x[i] for x in logits], [x[i] for x in deltas], level_anchors, hw,
                                            model["rpn"]["pre_nms_topk_test"], model["rpn"]["post_nms_topk_test"])
                xs.append(net.box_features(feats, i, rois[valid]))
                rois_all.append(rois[valid])
        base = float(b_cls[-1])
        lo, hi = -8.0, 16.0
        w_box, b_box = sd[f"{box}.bbox_pred.weight"], sd[f"{box}.bbox_pred.bias"]
        for _ in range(20):
            mid = 0.5 * (lo + hi)
            b_cls[-1] = base + mid
            n = sum(len(net.detections(x_i @ w_cls.t() + b_cls, x_i @ w_box.t() + b_box, r_i, hw,
                                       model["test"]["detections_per_image"])["scores"])
                    for x_i, r_i, hw in zip(xs, rois_all, held_sizes)) / len(held_sizes)
            if abs(n - weights["detections_per_image"]) <= 1:
                break
            lo, hi = (mid, hi) if n > weights["detections_per_image"] else (lo, mid)


def flops_per_image(conf: Mapping, training: bool) -> float:
    """The members' model FLOPs of one image (``faster_rcnn_fpn``'s count
    each: the variance head's 1024 products a RoI and the fusion count 0)."""
    if training:
        raise NotImplementedError("proben_late: no training cell")
    return math.fsum(fpn.flops_per_image(m, False) for m in conf["members"])
