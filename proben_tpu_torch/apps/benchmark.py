"""Throughput of a config on the card: data loading, training and inference
img/s (counterpart of ``tools/benchmark.py``; reference
``tools/benchmark.py``).

    python -m proben_tpu_torch.apps.benchmark --task train|eval|data \\
        --config-file configs/FLIR-Detection/faster_rcnn_R_101_FLIR.yaml \\
        [--iters 10] [--batch N] [--device cpu] [KEY VALUE ...]

``eval`` and ``train`` run the port's random init on a synthetic batch
(``synthetic_batch``), so they need no data; ``data`` maps batches of
``DATASETS.TRAIN``, which must be registered in the process. Each task
makes one untimed call, then times ``--iters`` calls between two
``torch.cuda.synchronize()`` fences and prints the JAX tool's line. A user
command: nothing reads its output as a metric.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import get_cfg, mapper_config_from_cfg, model_config_from_cfg, solver_config_from_cfg
from ..data import DatasetCatalog, DatasetMapper, TrainLoader
from ..device import resolve_device
from ..engine import make_train_step
from ..models import build_model, rcnn
from ..structures import GroundTruth


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m proben_tpu_torch.apps.benchmark")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--task", default="eval", choices=["train", "eval", "data"])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--batch", type=int, default=0, help="override batch size")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="config overrides as KEY VALUE pairs")
    return parser.parse_args(argv)


def synthetic_batch(cfg, batch: int, rng: np.random.RandomState, device) -> dict:
    """The JAX tool's synthetic batch on ``device``: uniform 0..255 images
    at ``INPUT.PAD_SHAPE`` with true size (h, w - 24), ``INPUT.MAX_GT``
    random boxes and classes per image, all valid."""
    h, w = cfg.INPUT.PAD_SHAPE
    c = {"BGR": 3, "BGRT": 4, "BGRTTT": 6}[cfg.INPUT.FORMAT]
    g = cfg.INPUT.MAX_GT
    xy = rng.rand(batch, g, 2) * (min(h, w) - 100)
    wh = rng.rand(batch, g, 2) * 80 + 20
    image = torch.from_numpy(rng.rand(batch, h, w, c).astype(np.float32) * 255)
    image_size = torch.from_numpy(np.tile([[h, w - 24]], (batch, 1)).astype(np.int32))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))
    classes = torch.from_numpy(rng.randint(0, cfg.MODEL.ROI_HEADS.NUM_CLASSES, (batch, g)).astype(np.int32))
    return {"image": image.to(device), "image_size": image_size.to(device),
            "gt": GroundTruth(boxes.to(device), classes.to(device), torch.ones(batch, g, dtype=torch.bool,
                                                                             device=device))}


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, iters: int, device: torch.device) -> Tuple[float, object]:
    """(seconds of ``iters`` calls of ``fn``, the last call's result), after
    one untimed call; the card is fenced before and after the timed calls."""
    out = fn()
    _fence(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _fence(device)
    return time.perf_counter() - t0, out


def main(argv: Optional[Sequence[str]] = None) -> Tuple[str, object]:
    """Run the task; prints and returns (its line, the last call's result:
    the detections, the step's metrics or the mapped batch)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    model_cfg = model_config_from_cfg(cfg)
    rng = np.random.RandomState(0)

    if args.task == "eval":
        batch = args.batch or 4
        model = build_model(model_cfg, seed=0, device=device)
        data = synthetic_batch(cfg, batch, rng, device)
        dt, out = timed(lambda: rcnn.rcnn_inference(model, model_cfg, data["image"], data["image_size"]),
                        args.iters, device)
        line = (f"inference: {batch * args.iters / dt:.2f} img/s "
                f"({dt / args.iters * 1000:.1f} ms/batch of {batch})")
    elif args.task == "train":
        batch = args.batch or cfg.SOLVER.IMS_PER_BATCH
        model = build_model(model_cfg, seed=0, device=device).train()
        init_state, train_step = make_train_step(model_cfg, solver_config_from_cfg(cfg))
        state = init_state(model, 1)
        data = synthetic_batch(cfg, batch, rng, device)

        def step():
            nonlocal state
            state, metrics = train_step(state, data)
            return metrics

        dt, out = timed(step, args.iters, device)
        line = f"train: {dt / args.iters:.3f} s/iter, {batch * args.iters / dt:.2f} img/s"
    else:  # data
        dicts = []
        for name in cfg.DATASETS.TRAIN:
            dicts.extend(DatasetCatalog.get(name))
        if not dicts:
            raise ValueError("register DATASETS.TRAIN to benchmark data loading")
        batch = args.batch or cfg.SOLVER.IMS_PER_BATCH
        loader = TrainLoader(dicts, DatasetMapper(mapper_config_from_cfg(cfg), True, device=device),
                             batch_size=batch)
        try:
            dt, out = timed(lambda: next(loader), args.iters, device)
        finally:
            loader.close()
        line = f"data: {batch * args.iters / dt:.2f} img/s"
    print(line, flush=True)
    return line, out


if __name__ == "__main__":
    main()
