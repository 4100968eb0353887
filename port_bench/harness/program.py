"""The system under test, ``proben_tpu_torch``, as its users drive it: the
configuration read from the frozen YAML by the port's own reader, the
weights through its detectron2 import, ``Predictor.predict_batch`` for
inference and ``make_train_step``'s ``train_step`` with the shipped solver
and trainable mask for training. Nothing else of the port is used."""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from proben_tpu_torch.checkpoint.torch_import import import_detectron2_checkpoint
from proben_tpu_torch.config import get_cfg, model_config_from_cfg, solver_config_from_cfg
from proben_tpu_torch.engine import train as port_train
from proben_tpu_torch.engine.predictor import Predictor
from proben_tpu_torch.models.rcnn import build_model, init_rcnn
from proben_tpu_torch.structures.detections import GroundTruth

CUSTOM_OPS = ("proben::stem_pool", "proben::roi_align_fwd", "proben::roi_align_bwd")


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


def build(cfg, state_dict: Mapping[str, np.ndarray], device):
    """The detector on ``device`` from a detectron2 state dict, imported as
    a user's checkpoint is."""
    mcfg = model_config_from_cfg(cfg)
    params = import_detectron2_checkpoint(dict(state_dict), init_rcnn(0, mcfg))
    return build_model(mcfg, params=params, device=device), mcfg


def predictor(model, mcfg, device) -> Predictor:
    return Predictor(model, mcfg, device)


class Trainer:
    """``train_step`` over the state ``init_state`` made, with the solver
    and trainable mask of the configuration."""

    def __init__(self, cfg, model, mcfg, seed: int):
        mask = port_train.trainable_mask(model, mcfg.freeze_at)
        init_state, self.step_fn = port_train.make_train_step(mcfg, solver_config_from_cfg(cfg), mask)
        self.state = init_state(model, seed)
        self.trainable = [n for n, ok in mask.items() if ok]

    def step(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics

    def params(self) -> Dict[str, torch.Tensor]:
        named = dict(self.state.model.named_parameters())
        return {n: named[n] for n in self.trainable}

    def momentum(self) -> Dict[str, torch.Tensor]:
        return {n: self.state.momentum[n] for n in self.trainable}


def train_batch(pool_batch: Mapping) -> Dict:
    """A harness training batch in the form ``train_step`` takes."""
    boxes, classes, valid = pool_batch["gt"]
    return {"image": pool_batch["image"], "image_size": pool_batch["image_size"],
            "gt": GroundTruth(boxes, classes, valid)}

