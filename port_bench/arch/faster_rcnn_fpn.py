"""The architecture ``faster_rcnn_fpn``: one Faster R-CNN with a ResNet FPN
backbone (detectron2's GeneralizedRCNN with StandardROIHeads), on BGR
frames or, in middle fusion (BGRTTT), through two backbones whose maps are
concatenated. A configuration without an "arch" key names this one.

Every architecture module under ``port_bench/arch/`` provides what this one
does; the harness (``harness/cells.py``, ``calibrate.py``,
``span_probe.py``) reaches the program and the reference only through it:

- ``channels(conf)``: the channels of the frames the harness draws;
- ``read_config(config_dir, conf)``: the program's configuration, read as
  its users read it; raises where it differs from ``config.json``;
- ``make_state(conf, seed, batch, device)``: the run's model state, any
  object (here a detectron2 state dict on the host), drawn from ``seed``
  and fitted to the first frames of ``batch``;
- ``predictor(pcfg, state, device)``: the program built from the state,
  with ``predict_batch(batch)`` returning per-image dicts of numpy
  "boxes", "scores", "classes" in the original frame;
- ``trainer(pcfg, state, seed, device)``: the program's training step,
  with ``batch(pool_batch)`` (a harness batch in the step's form, made in
  set-up), ``step(batch)`` (the losses by name as tensors, "total_loss"
  among them), ``params()`` and ``momentum()`` (leaf name -> tensor, named
  as the reference names its leaves);
- ``reference_detections(conf, state, images, device, precision)`` and
  ``reference_steps(conf, state, pool, seed, steps, device, precision,
  batch_filter)``: the plain reference's answers for ``harness/judge.py``,
  at ``precision`` "fp32" or "fp8" (the control);
- ``flops_per_image(conf, training)``: model FLOPs of one image;
- ``OPS``: {custom op name: counts(args, out) -> (operations, bytes)},
  the program's ops whose calls the traced pass records and holds to
  their roofline.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from harness.cells import free, norms, tf32_off
from harness.frames import resized_hw
from proben_tpu_torch.checkpoint.torch_import import import_detectron2_checkpoint
from proben_tpu_torch.config import get_cfg, model_config_from_cfg, solver_config_from_cfg
from proben_tpu_torch.engine import train as port_train
from proben_tpu_torch.engine.predictor import Predictor
from proben_tpu_torch.models.rcnn import build_model, init_rcnn
from proben_tpu_torch.structures.detections import GroundTruth
from reference import model as ref

CHECK_CHUNK = 4  # images per reference call
BN_EPS = 1e-5
STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STAGE_OUT = (256, 512, 1024, 2048)


def channels(conf: Mapping) -> int:
    return 6 if conf["model"]["input_format"] == "BGRTTT" else 3


# ---------------------------------------------------------------------------
# the program: its config reader, checkpoint import, Predictor, train_step
# ---------------------------------------------------------------------------


def read_config(config_dir: str, conf: Mapping):
    """The port's CfgNode of the frozen YAML; raises where its numbers
    differ from ``config.json``'s, so both sides run one configuration."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(config_dir, conf["yaml"]))
    m = model_config_from_cfg(cfg)
    s = solver_config_from_cfg(cfg)
    want, sol, inp = conf["model"], conf["solver"], conf["input"]
    got = {
        "depth": m.depth, "input_format": m.input_format, "num_classes": m.num_classes,
        "pixel_mean": list(m.pixel_mean), "pixel_std": list(m.pixel_std), "freeze_at": m.freeze_at,
        "fpn_channels": m.fpn_channels, "compute_dtype": m.compute_dtype,
        "rpn.pre_nms_topk_train": m.rpn.pre_nms_topk_train, "rpn.pre_nms_topk_test": m.rpn.pre_nms_topk_test,
        "rpn.post_nms_topk_train": m.rpn.post_nms_topk_train,
        "rpn.post_nms_topk_test": m.rpn.post_nms_topk_test, "rpn.nms_thresh": m.rpn.nms_thresh,
        "rpn.min_size": m.rpn.min_box_side_len, "rpn.batch_size_per_image": m.rpn.batch_size_per_image,
        "rpn.positive_fraction": m.rpn.positive_fraction, "rpn.iou_thresholds": list(m.rpn.iou_thresholds),
        "roi.batch_size_per_image": m.roi.batch_size_per_image,
        "roi.positive_fraction": m.roi.positive_fraction, "roi.iou_threshold": m.roi.iou_threshold,
        "roi.pooler_resolution": m.roi.pooler_resolution,
        "roi.pooler_sampling_ratio": m.roi.pooler_sampling_ratio,
        "roi.bbox_reg_weights": list(m.rcnn.box_reg_weights), "test.score_thresh": m.rcnn.score_thresh,
        "test.nms_thresh": m.rcnn.nms_thresh, "test.detections_per_image": m.rcnn.topk_per_image,
        "anchor_sizes": [list(x) for x in cfg.MODEL.ANCHOR_GENERATOR.SIZES],
        "anchor_aspect_ratios": list(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
        "solver.ims_per_batch": cfg.SOLVER.IMS_PER_BATCH, "solver.base_lr": s.base_lr,
        "solver.momentum": s.momentum, "solver.weight_decay": s.weight_decay,
        "solver.weight_decay_bias": s.weight_decay_bias, "solver.bias_lr_factor": s.bias_lr_factor,
        "solver.warmup_factor": s.warmup_factor, "solver.warmup_iters": s.warmup_iters,
        "solver.steps": list(s.steps), "solver.gamma": s.gamma, "solver.max_iter": s.max_iter,
        "input.pad_shape": list(cfg.INPUT.PAD_SHAPE), "input.max_gt": cfg.INPUT.MAX_GT,
        "input.min_size_train": list(cfg.INPUT.MIN_SIZE_TRAIN), "input.min_size_test": cfg.INPUT.MIN_SIZE_TEST,
        "input.max_size_test": cfg.INPUT.MAX_SIZE_TEST, "input.max_size_train": cfg.INPUT.MAX_SIZE_TRAIN,
    }
    for key, value in got.items():
        group, _, leaf = key.rpartition(".")
        src = {"": want, "rpn": want["rpn"], "roi": want["roi"], "test": want["test"], "solver": sol,
               "input": inp}[group]
        expect = src[leaf]
        if _plain(value) != _plain(expect):
            raise RuntimeError(f"config: the port reads {key} = {value!r}, config.json has {expect!r}")
    if m.stem_impl != "kernel" or m.roi_align_impl != "kernel":
        raise RuntimeError("config: the YAML turns the port's kernels off")
    return cfg


def _plain(v):
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else v


def _build(cfg, state_dict: Mapping[str, np.ndarray], device):
    """The detector on ``device`` from a detectron2 state dict, imported as
    a user's checkpoint is."""
    mcfg = model_config_from_cfg(cfg)
    params = import_detectron2_checkpoint(dict(state_dict), init_rcnn(0, mcfg))
    return build_model(mcfg, params=params, device=device), mcfg


def predictor(cfg, state: Mapping[str, np.ndarray], device) -> Predictor:
    model, mcfg = _build(cfg, state, device)
    return Predictor(model, mcfg, device)


def trainer(cfg, state: Mapping[str, np.ndarray], seed: int, device) -> "Trainer":
    model, mcfg = _build(cfg, state, device)
    return Trainer(cfg, model, mcfg, seed)


class Trainer:
    """``train_step`` over the state ``init_state`` made, with the solver
    and trainable mask of the configuration."""

    def __init__(self, cfg, model, mcfg, seed: int):
        mask = port_train.trainable_mask(model, mcfg.freeze_at)
        init_state, self.step_fn = port_train.make_train_step(mcfg, solver_config_from_cfg(cfg), mask)
        self.state = init_state(model, seed)
        self.trainable = [n for n, ok in mask.items() if ok]

    @staticmethod
    def batch(pool_batch: Mapping) -> Dict:
        """A harness training batch in the form ``train_step`` takes."""
        boxes, classes, valid = pool_batch["gt"]
        return {"image": pool_batch["image"], "image_size": pool_batch["image_size"],
                "gt": GroundTruth(boxes, classes, valid)}

    def step(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics

    def params(self) -> Dict[str, torch.Tensor]:
        named = dict(self.state.model.named_parameters())
        return {n: named[n] for n in self.trainable}

    def momentum(self) -> Dict[str, torch.Tensor]:
        return {n: self.state.momentum[n] for n in self.trainable}


# ---------------------------------------------------------------------------
# the reference's answers, for the judge and calibrate.py
# ---------------------------------------------------------------------------


def reference_detections(conf: Mapping, sd: Mapping, images: List[torch.Tensor], device,
                         precision: str = "fp32") -> List[Dict[str, np.ndarray]]:
    """The reference's detections of ``images`` (H, W, C) in the original
    frame, as ``predict_batch`` rescales and clips them."""
    cfg = ref.Config(conf["model"], conf["solver"])
    net = ref.Net(cfg, ref.params_from_d2(cfg, sd, device), precision)
    inp = conf["input"]
    hw = resized_hw(inp["frame_hw"], inp["min_size_test"], inp["max_size_test"])
    oh, ow = inp["frame_hw"]
    sx, sy = ow / hw[1], oh / hw[0]
    out = []
    for s in range(0, len(images), CHECK_CHUNK):
        chunk = torch.stack(images[s:s + CHECK_CHUNK]).to(device)
        with tf32_off():
            dets = net.detect(chunk, [hw] * chunk.shape[0])
        for d in dets:
            b = d["boxes"] * torch.tensor([sx, sy, sx, sy], device=device)
            b = ref.bx.clip(b, float(oh), float(ow))
            out.append({"boxes": b.cpu().numpy(), "scores": d["scores"].cpu().numpy(),
                        "classes": d["classes"].cpu().numpy()})
    del net
    free(device)
    return out


def reference_steps(conf: Mapping, sd: Mapping, pool: List[Mapping], seed: int, steps: int, device,
                    precision: str = "fp32", batch_filter: Optional[Callable] = None) -> Dict:
    """The reference's first ``steps`` steps from the same weights on the
    same batches, with the same sampling priorities: each step's total
    loss, the momentum after step 1 and the plain gradient of step 1, and
    the parameters' change after the last step, as norms per leaf."""
    cfg = ref.Config(conf["model"], conf["solver"])
    params = ref.params_from_d2(cfg, sd, device)
    train = [n for n in params if ref.trainable(cfg, n)]
    for n in train:
        params[n].requires_grad_(True)
    start = {n: params[n].detach().clone() for n in train}
    net = ref.Net(cfg, params, precision)
    canvas = conf["input"]["pad_shape"]
    n_anchor = ref.num_anchors(cfg, canvas)
    post = cfg["rpn"]["post_nms_topk_train"]
    momentum: Dict[str, torch.Tensor] = {}
    out = {"losses": []}
    keys = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg")
    for step in range(steps):
        b = pool[step]
        images, sizes, (gb, gc, gv) = b["image"], b["image_size"].tolist(), b["gt"]
        n = images.shape[0]
        gen = torch.Generator(device=device).manual_seed(ref.step_seed(seed, step))
        rpn_rand = torch.rand((n, n_anchor), generator=gen, device=device)
        roi_rand = torch.rand((n, post + gb.shape[1]), generator=gen, device=device)
        rows = list(range(n)) if batch_filter is None else batch_filter(n)
        grads = {k: torch.zeros_like(params[k]) for k in train}
        total = dict.fromkeys(keys, 0.0)
        for s in range(0, len(rows), CHECK_CHUNK):
            r = rows[s:s + CHECK_CHUNK]
            with tf32_off():
                losses = net.losses(images[r], [sizes[i] for i in r], gb[r], gc[r], gv[r], rpn_rand[r],
                                    roi_rand[r], len(rows))
                loss = sum(losses.values())
                got = torch.autograd.grad(loss, [params[k] for k in train], allow_unused=True)
            for k, g in zip(train, got):
                if g is not None:
                    grads[k] += g
            for k in keys:
                total[k] += float(losses[k].detach())
        total["total_loss"] = sum(total[k] for k in keys)
        out["losses"].append(total)
        if step == 0:
            out["grad_raw"] = norms(grads)
        ref.sgd_step(cfg, params, grads, momentum, step)
        if step == 0:
            out["grad"] = norms(momentum)
    out["update"] = norms({k: params[k].detach() - start[k] for k in train})
    del net, params, momentum, start
    free(device)
    return out


# ---------------------------------------------------------------------------
# the model state: detectron2-named weights drawn on the device from the seed
# ---------------------------------------------------------------------------


def make_state(conf: Mapping, seed: int, batch: Mapping, device) -> Dict[str, np.ndarray]:
    """Random detector weights as a detectron2 state dict (on the host),
    made on the device from ``seed`` in two large draws (one normal, one
    uniform) and then scaled leaf by leaf. Every frozen BatchNorm gets a
    random affine (scale U(0.5, 1.5), or U(0.1, 0.3) on a block's last
    norm; bias U(-0.1, 0.1); mean 0, variance 1 - eps, so folding it gives
    the affine back), so every residual branch is live as in a trained
    checkpoint. The RPN's output convs and the box predictor are then
    fitted by ``calibrate`` with the reference to the first frames of
    ``batch``, to the spreads of the configuration's "weights" entry."""
    sd = make_state_dict(conf["model"], conf["weights"], seed, device)
    k = conf["weights"]["calibration_images"]
    calibrate(conf["model"], conf["weights"], sd, batch["image"][:k],
              [tuple(hw) for hw in batch["image_size"][:k].tolist()])
    return to_numpy(sd)


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
    cfg = ref.Config(model, {})
    dev = images.device
    rpn, box = "proposal_generator.rpn_head", "roi_heads.box_predictor"
    with tf32_off():
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


def to_numpy(sd: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A state dict of ``make_state_dict`` on the host, in one copy of the
    buffer its leaves share."""
    first = next(iter(sd.values()))
    whole = first.new_empty(0).set_(first.untyped_storage()).cpu().numpy()
    return {k: whole[t.storage_offset():t.storage_offset() + t.numel()].reshape(t.shape)
            for k, t in sd.items()}


# ---------------------------------------------------------------------------
# counts: model FLOPs and the operations and bytes of the custom ops' calls
# ---------------------------------------------------------------------------


# one layer: (name, multiply-adds per image, trains, input carries a gradient)
Layer = Tuple[str, float, bool, bool]


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def layers(model: Mapping, canvas: Sequence[int], rois: int, training: bool) -> List[Layer]:
    """Every conv and linear layer of one image's forward pass."""
    freeze = model["freeze_at"] if training else 0
    dual = model["input_format"] == "BGRTTT"
    cin0 = 3 if dual else {"BGR": 3, "BGRT": 4}[model["input_format"]]
    out: List[Layer] = []
    f = model["fpn_channels"]
    sizes = None
    for bb in ("backbone", "backbone_2") if dual else ("backbone",):
        h, w = _out(canvas[0], 7, 2, 3), _out(canvas[1], 7, 2, 3)
        out.append((f"{bb}.stem", 64 * cin0 * 49 * h * w, freeze < 1, False))
        h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
        c_in, width, grad_in = 64, 64, freeze < 1
        sizes = []
        for i, (n, c_out) in enumerate(zip(STAGE_BLOCKS[model["depth"]], STAGE_OUT)):
            trains = freeze < i + 2
            for b in range(n):
                s = 2 if b == 0 and i > 0 else 1
                ho, wo = _out(h, 1, s, 0), _out(w, 1, s, 0)
                key = f"{bb}.res{i + 2}.{b}"
                out.append((f"{key}.conv1", c_in * width * ho * wo, trains, grad_in))
                out.append((f"{key}.conv2", width * width * 9 * ho * wo, trains, trains))
                out.append((f"{key}.conv3", width * c_out * ho * wo, trains, trains))
                if b == 0:
                    out.append((f"{key}.shortcut", c_in * c_out * ho * wo, trains, grad_in))
                h, w, c_in = ho, wo, c_out
                grad_in = trains
            sizes.append((h, w, grad_in))
            width *= 2
        for i, ((h, w, g), c) in enumerate(zip(sizes, STAGE_OUT)):
            out.append((f"{bb}.fpn_lateral{i + 2}", c * f * h * w, True, g))
            out.append((f"{bb}.fpn_output{i + 2}", f * f * 9 * h * w, True, True))
    levels = [(h, w) for h, w, _ in sizes] + [((sizes[-1][0] - 1) // 2 + 1, (sizes[-1][1] - 1) // 2 + 1)]
    c = f * (2 if dual else 1)
    a = len(model["anchor_aspect_ratios"])
    hw = sum(h * w for h, w in levels)
    out.append(("rpn.conv", c * c * 9 * hw, True, True))
    out.append(("rpn.objectness_deltas", c * 5 * a * hw, True, True))
    p, fc, k = model["roi"]["pooler_resolution"], model["roi"]["fc_dim"], model["num_classes"]
    out.append(("box_head.fc1", rois * c * p * p * fc, True, True))
    out.append(("box_head.fc2", rois * fc * fc, True, True))
    out.append(("box_predictor", rois * fc * (k + 1 + 4 * k), True, True))
    return out


def flops_per_image(conf: Mapping, training: bool) -> float:
    """Model FLOPs of one image at the configuration's canvas: 2 x the
    multiply-adds of every convolution and linear layer (elementwise work,
    pooling, RoIAlign and NMS count 0) over the RoIs the box head takes
    (the test proposals, or the sampled RoIs in training); forward, and in
    training the backward's weight gradient where the layer trains and
    input gradient where its input carries a gradient (above the frozen
    stages)."""
    model = conf["model"]
    rois = model["roi"]["batch_size_per_image"] if training else model["rpn"]["post_nms_topk_test"]
    total = 0.0
    for _, macs, trains, grad_in in layers(model, conf["input"]["pad_shape"], rois, training):
        total += 2.0 * macs
        if training:
            total += 2.0 * macs * (int(trains) + int(grad_in))
    return total


def stem_counts(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                out: torch.Tensor) -> Tuple[float, float]:
    """K1 (``proben::stem_pool``): the 7x7/2 conv's products over (N, H, W,
    C) ``x``; the input, weights and affine read once, the pooled map
    written once."""
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    hs, ws = (h - 1) // 2 + 1, (wd - 1) // 2 + 1
    flops = 2.0 * n * hs * ws * o * kh * kw * c
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, scale, bias, out))
    return flops, float(nbytes)


def roi_align_fwd_counts(features: Sequence[torch.Tensor], lvl_idx, y0, x0, wy, wx, rois_per_image: int,
                         out: torch.Tensor) -> Tuple[float, float]:
    """K2 (``proben::roi_align_fwd``): the distinct feature pixels under a
    nonzero weight of some RoI, the weights and origins read once, the
    pooled rows written once; per channel, the row pass over the nonzero
    ``wy`` taps at every used column and the column pass over the nonzero
    ``wx`` taps per output row."""
    p, c = wy.shape[1], features[0].shape[-1]
    nbytes = (out.numel() * out.element_size() + wy.numel() * wy.element_size()
              + wx.numel() * wx.element_size() + 4 * (lvl_idx.numel() + y0.numel() + x0.numel())
              + needed_feature_bytes(features, lvl_idx, y0, x0, wy, wx, rois_per_image))
    ny = (wy != 0).sum(dim=(1, 2)).double()
    ncol = (wx != 0).any(dim=1).sum(dim=1).double()
    nx = (wx != 0).sum(dim=(1, 2)).double()
    flops = 2.0 * c * float((ncol * ny + p * nx).sum())
    return flops, float(nbytes)


def roi_align_bwd_counts(g: torch.Tensor, shapes: Sequence[int], lvl_idx, y0, x0, wy, wx,
                         rois_per_image: int, out: Sequence[torch.Tensor]) -> Tuple[float, float]:
    """K3 (``proben::roi_align_bwd``): the cotangent, weights and origins
    read once, every gradient map written once; per channel, P products for
    each nonzero ``wy`` tap, then one per nonzero ``wx`` tap for every row
    with a nonzero ``wy`` tap."""
    p, c = wy.shape[1], g.shape[-1]
    nbytes = (g.numel() * g.element_size() + wy.numel() * wy.element_size()
              + wx.numel() * wx.element_size() + 4 * (lvl_idx.numel() + y0.numel() + x0.numel())
              + sum(t.numel() * t.element_size() for t in out))
    nnz_y = (wy != 0).sum(dim=(1, 2)).double()
    rows = (wy != 0).any(dim=1).sum(dim=1).double()
    nnz_x = (wx != 0).sum(dim=(1, 2)).double()
    flops = 2.0 * c * float((p * nnz_y + rows * nnz_x).sum())
    return flops, float(nbytes)


def needed_feature_bytes(features, lvl_idx, y0, x0, wy, wx, rois_per_image: int) -> int:
    """Bytes of the distinct feature pixels under a nonzero weight: what
    this call's RoIs need the kernel to read."""
    rows = (wy != 0).any(dim=1)
    cols = (wx != 0).any(dim=1)
    img = torch.arange(lvl_idx.shape[0], device=lvl_idx.device) // rois_per_image
    total = 0
    for li, f in enumerate(features):
        b, hl, wl, c = f.shape
        sel = (lvl_idx == li).nonzero().flatten()
        if sel.numel() == 0:
            continue
        mask = torch.zeros(b * hl * wl, dtype=torch.bool, device=f.device)
        for s in range(0, sel.numel(), 1024):
            r = sel[s:s + 1024]
            yy = y0[r, None].long() + torch.arange(rows.shape[1], device=f.device)
            xx = x0[r, None].long() + torch.arange(cols.shape[1], device=f.device)
            need = rows[r][:, :, None] & cols[r][:, None, :]
            need &= (yy < hl)[:, :, None] & (xx < wl)[:, None, :]
            flat = (img[r, None, None] * hl + yy[:, :, None]) * wl + xx[:, None, :]
            mask[flat[need]] = True
        total += int(mask.sum()) * c * f.element_size()
    return total


OPS: Dict[str, Callable] = {
    "proben::stem_pool": lambda args, out: stem_counts(*args, out),
    "proben::roi_align_fwd": lambda args, out: roi_align_fwd_counts(*args, out),
    "proben::roi_align_bwd": lambda args, out: roi_align_bwd_counts(*args, out),
}
