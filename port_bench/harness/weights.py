"""Random detector weights as a detectron2 state dict, made on the device
from the run's seed in two large draws (one normal, one uniform) and then
scaled leaf by leaf. Every frozen BatchNorm gets a random affine (scale
U(0.5, 1.5), or U(0.1, 0.3) on a block's last norm; bias U(-0.1, 0.1);
mean 0, variance 1 - eps, so folding it gives the affine back), so every
residual branch is live as in a trained checkpoint. The RPN's output convs
and the box predictor are then fitted by ``calibrate`` with the reference,
to the spreads of the configuration's "weights" entry."""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

BN_EPS = 1e-5
STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STAGE_OUT = (256, 512, 1024, 2048)

# (name, shape, kind, a, b): kind "normal" (std a), "uniform" (a..b), "const" (a)
Spec = Tuple[str, Tuple[int, ...], str, float, float]


def _norm(specs: List[Spec], key: str, c: int, last: bool) -> None:
    lo, hi = (0.1, 0.3) if last else (0.5, 1.5)
    specs += [(f"{key}.weight", (c,), "uniform", lo, hi), (f"{key}.bias", (c,), "uniform", -0.1, 0.1),
              (f"{key}.running_mean", (c,), "const", 0.0, 0.0),
              (f"{key}.running_var", (c,), "const", 1.0 - BN_EPS, 0.0)]


def _conv(specs: List[Spec], key: str, cout: int, cin: int, k: int, std: float, bias: bool) -> None:
    specs.append((f"{key}.weight", (cout, cin, k, k), "normal", std, 0.0))
    if bias:
        specs.append((f"{key}.bias", (cout,), "const", 0.0, 0.0))


def _xavier(specs: List[Spec], key: str, cout: int, cin: int, k: int = 0) -> None:
    """caffe2's XavierFill: U(-a, a), a = sqrt(3 / fan_in); zero bias."""
    fan_in = cin * max(k, 1) ** 2
    a = math.sqrt(3.0 / fan_in)
    shape = (cout, cin, k, k) if k else (cout, cin)
    specs += [(f"{key}.weight", shape, "uniform", -a, a), (f"{key}.bias", (cout,), "const", 0.0, 0.0)]


def specs_for(model: Mapping, weights: Mapping) -> List[Spec]:
    """Every leaf of the configuration's detector, in a fixed order."""
    dual = model["input_format"] == "BGRTTT"
    cin = 3 if dual else {"BGR": 3, "BGRT": 4}[model["input_format"]]
    specs: List[Spec] = []
    for bb in ("backbone", "backbone_2") if dual else ("backbone",):
        pre = f"{bb}.bottom_up"
        _conv(specs, f"{pre}.stem.conv1", 64, cin, 7, math.sqrt(2.0 / (49 * 64)), False)
        _norm(specs, f"{pre}.stem.conv1.norm", 64, False)
        c_in, width = 64, 64
        for stage, n, c_out in zip(("res2", "res3", "res4", "res5"), STAGE_BLOCKS[model["depth"]], STAGE_OUT):
            for b in range(n):
                key = f"{pre}.{stage}.{b}"
                _conv(specs, f"{key}.conv1", width, c_in, 1, math.sqrt(2.0 / width), False)
                _norm(specs, f"{key}.conv1.norm", width, False)
                _conv(specs, f"{key}.conv2", width, width, 3, math.sqrt(2.0 / (9 * width)), False)
                _norm(specs, f"{key}.conv2.norm", width, False)
                _conv(specs, f"{key}.conv3", c_out, width, 1, math.sqrt(2.0 / c_out), False)
                _norm(specs, f"{key}.conv3.norm", c_out, True)
                if b == 0:
                    _conv(specs, f"{key}.shortcut", c_out, c_in, 1, math.sqrt(2.0 / c_out), False)
                    _norm(specs, f"{key}.shortcut.norm", c_out, False)
                c_in = c_out
            width *= 2
        f = model["fpn_channels"]
        for i, c in enumerate(STAGE_OUT):
            _xavier(specs, f"{bb}.fpn_lateral{i + 2}", f, c, 1)
            _xavier(specs, f"{bb}.fpn_output{i + 2}", f, f, 3)
    c = model["fpn_channels"] * (2 if dual else 1)
    a = len(model["anchor_aspect_ratios"])
    rpn = "proposal_generator.rpn_head"
    _conv(specs, f"{rpn}.conv", c, c, 3, weights["rpn_conv_std"], True)
    # unit widths: ``calibrate`` centres and scales these four layers
    _conv(specs, f"{rpn}.objectness_logits", a, c, 1, 1.0, True)
    _conv(specs, f"{rpn}.anchor_deltas", 4 * a, c, 1, 1.0, True)
    p, fc, k = model["roi"]["pooler_resolution"], model["roi"]["fc_dim"], model["num_classes"]
    _xavier(specs, "roi_heads.box_head.fc1", fc, c * p * p)
    _xavier(specs, "roi_heads.box_head.fc2", fc, fc)
    specs += [("roi_heads.box_predictor.cls_score.weight", (k + 1, fc), "normal", 1.0, 0.0),
              ("roi_heads.box_predictor.cls_score.bias", (k + 1,), "const", 0.0, 0.0),
              ("roi_heads.box_predictor.bbox_pred.weight", (4 * k, fc), "normal", 1.0, 0.0),
              ("roi_heads.box_predictor.bbox_pred.bias", (4 * k,), "const", 0.0, 0.0)]
    return specs


def make_state_dict(model: Mapping, weights: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """{detectron2 name: float32 tensor on ``device``}: views of one buffer,
    drawn from ``seed`` with a generator on ``device``."""
    specs = specs_for(model, weights)
    sizes = [int(np.prod(s)) for _, s, _, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(n for n, (_, _, kind, _, _) in zip(sizes, specs) if kind == "normal")
    n_uniform = sum(n for n, (_, _, kind, _, _) in zip(sizes, specs) if kind == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    flat = torch.empty(sum(sizes), device=device)
    out, at, i_n, i_u = {}, 0, 0, 0
    for (name, shape, kind, a, b), n in zip(specs, sizes):
        dst = flat[at:at + n]
        if kind == "normal":
            torch.mul(normal[i_n:i_n + n], a, out=dst)
            i_n += n
        elif kind == "uniform":
            torch.add(uniform[i_u:i_u + n] * (b - a), a, out=dst)
            i_u += n
        else:
            dst.fill_(a)
        out[name] = dst.view(shape)
        at += n
    return out


def _centre(weight: torch.Tensor, bias: torch.Tensor, outputs: torch.Tensor, std: float) -> None:
    """Scale ``weight`` and set ``bias`` so that each output channel of
    ``outputs`` (rows of the layer's outputs with zero bias) gets mean 0
    and ``std``."""
    mean = outputs.mean(0)
    s = std / (outputs - mean).std(0).clamp(min=1e-12)
    weight.mul_(s.view((-1,) + (1,) * (weight.dim() - 1)))
    bias.copy_(-mean * s)


def calibrate(model: Mapping, weights: Mapping, sd: Mapping[str, torch.Tensor], images: torch.Tensor,
              sizes) -> None:
    """Fit, in place, the RPN's objectness and delta convs and the box
    predictor to the features of ``images`` (raw frames with their true
    sizes), with the plain reference in float32: each output channel
    centred on these frames and scaled to the configured spread (objectness logits,
    RPN deltas, class logits, box deltas), then the background logit raised
    until these frames give ``detections_per_image`` detections each (above
    the 0.05 score threshold, after NMS). Random ResNets change the scale of their maps
    from seed to seed, and their ReLU features share a large mean, so fixed
    widths would give each seed its own number of proposals and detections;
    centred and scaled, every seed gives compact proposals and about the
    same detections per image, as a trained detector does."""
    from reference import model as ref

    cfg = ref.Config(model, {})
    dev = images.device
    rpn, box = "proposal_generator.rpn_head", "roi_heads.box_predictor"
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            net = ref.Net(cfg, ref.params_from_d2(cfg, sd, dev))
            feats = net.features(images)
            hidden = [torch.relu(net.conv(f, "rpn_head.conv", 1, 1)) for f in feats]
            for key, std in (("objectness_logits", weights["rpn_objectness_logit_std"]),
                             ("anchor_deltas", weights["rpn_delta_std"])):
                w = sd[f"{rpn}.{key}.weight"]
                outs = torch.cat([torch.nn.functional.conv2d(t, w).permute(0, 2, 3, 1).reshape(-1, w.shape[0])
                                  for t in hidden])
                _centre(w, sd[f"{rpn}.{key}.bias"], outs, std)
            net = ref.Net(cfg, ref.params_from_d2(cfg, sd, dev))
            logits, deltas = net.rpn_head(feats)
            anchors = net.anchors(feats)
            xs, rois_all = [], []
            for i, hw in enumerate(sizes):
                rois, valid = net.proposals([x[i] for x in logits], [x[i] for x in deltas], anchors, hw,
                                            model["rpn"]["pre_nms_topk_test"], model["rpn"]["post_nms_topk_test"])
                xs.append(net.box_features(feats, i, rois[valid]))
                rois_all.append(rois[valid])
            x = torch.cat(xs)
            for key, std in (("cls_score", weights["class_logit_std"]), ("bbox_pred", weights["box_delta_std"])):
                w = sd[f"{box}.{key}.weight"]
                _centre(w, sd[f"{box}.{key}.bias"], x @ w.t(), std)
            # the background logit's offset that leaves the configured number
            # of detections per image on these frames (bisected)
            bias = sd[f"{box}.cls_score.bias"]
            base = float(bias[-1])
            lo, hi = -8.0, 16.0
            for _ in range(20):
                mid = 0.5 * (lo + hi)
                bias[-1] = base + mid
                n = sum(len(net.fast_rcnn_inference(
                    x_i @ sd[f"{box}.cls_score.weight"].t() + bias, x_i @ sd[f"{box}.bbox_pred.weight"].t()
                    + sd[f"{box}.bbox_pred.bias"], r_i, hw, model["test"]["detections_per_image"])["scores"])
                    for x_i, r_i, hw in zip(xs, rois_all, sizes)) / len(sizes)
                if abs(n - weights["detections_per_image"]) <= 2:
                    break
                lo, hi = (mid, hi) if n > weights["detections_per_image"] else (lo, mid)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_numpy(sd: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A state dict of ``make_state_dict`` on the host, in one copy of the
    buffer its leaves share."""
    first = next(iter(sd.values()))
    whole = first.new_empty(0).set_(first.untyped_storage()).cpu().numpy()
    return {k: whole[t.storage_offset():t.storage_offset() + t.numel()].reshape(t.shape)
            for k, t in sd.items()}
