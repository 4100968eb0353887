"""The explicit training loop, without the trainer abstraction (counterpart
of ``tools/plain_train_net.py``; reference ``tools/plain_train_net.py``):
for users who want the raw loop.

    python -m proben_tpu_torch.apps.plain_train_net \\
        --config-file configs/FLIR-Detection/faster_rcnn_R_101_FLIR.yaml \\
        [--register name,json,image_root] [--device cpu] [KEY VALUE ...]

The arguments are ``train_net``'s. The model starts from the port's init
(``init_rcnn(max(SEED, 0))``), then ``MODEL.WEIGHTS`` (a detectron2
checkpoint, ``strict=False``). Each of ``SOLVER.MAX_ITER`` iterations maps
one batch of ``IMS_PER_BATCH`` (``TrainLoader``) and takes one
``make_train_step`` step; the metrics go to ``OUTPUT_DIR/metrics.json``
every 20 iterations, a checkpoint to ``OUTPUT_DIR/checkpoints`` every
``CHECKPOINT_PERIOD``. As in the JAX tool, the step gets no trainable mask:
the backbone below ``FREEZE_AT`` still gets no gradient (its forward runs
without one), but weight decay and momentum move its parameters.
Runs on ``--device`` (default ``cuda``; ``cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

import torch

from ..checkpoint import CheckpointManager, import_detectron2_checkpoint, train_state_tree
from ..config import mapper_config_from_cfg, model_config_from_cfg, solver_config_from_cfg
from ..data import DatasetCatalog, DatasetMapper, TrainLoader
from ..device import resolve_device
from ..engine.train import TrainState, device_batch, make_train_step
from ..models import build_model, init_rcnn
from ..utils.events import EventStorage, JSONWriter
from ..utils.logger import setup_logger
from .train_net import setup

logger = logging.getLogger(__name__)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m proben_tpu_torch.apps.plain_train_net")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--register", action="append", default=[],
                        help="dataset registration: name,json_path,image_root (repeatable)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="config overrides as KEY VALUE pairs")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    """Train as the arguments say; returns the final ``TrainState``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = setup(args)
    setup_logger(cfg.OUTPUT_DIR)

    model_cfg = model_config_from_cfg(cfg)
    params = init_rcnn(max(cfg.SEED, 0), model_cfg)
    if cfg.MODEL.WEIGHTS:
        params = import_detectron2_checkpoint(cfg.MODEL.WEIGHTS, params, strict=False)
    model = build_model(model_cfg, params=params, device=device).train()
    init_state, step = make_train_step(model_cfg, solver_config_from_cfg(cfg))
    state = init_state(model, 1)

    dicts = []
    for name in cfg.DATASETS.TRAIN:
        dicts.extend(DatasetCatalog.get(name))
    loader = TrainLoader(
        dicts, DatasetMapper(mapper_config_from_cfg(cfg), True, device=device),
        batch_size=cfg.SOLVER.IMS_PER_BATCH,
        num_workers=cfg.DATALOADER.NUM_WORKERS,
    )
    mgr = CheckpointManager(os.path.join(cfg.OUTPUT_DIR, "checkpoints"))
    writer = JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json"))

    try:
        with EventStorage(0) as storage:
            for it in range(cfg.SOLVER.MAX_ITER):
                state, metrics = step(state, device_batch(next(loader), device))
                storage.iter = it
                values = torch.stack([v.float() for v in metrics.values()]).tolist()  # one sync
                for k, v in zip(metrics, values):
                    storage.put_scalar(k, v)
                if (it + 1) % 20 == 0:
                    writer.write(storage)
                    logger.info("iter %d: %.4f", it, storage.median("total_loss"))
                if (it + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
                    mgr.save(it, train_state_tree(state))
    finally:
        loader.close()
        writer.close()
    return state


if __name__ == "__main__":
    main()
