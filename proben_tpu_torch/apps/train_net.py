"""Config-driven training entry point (counterpart of ``tools/train_net.py``;
reference ``tools/train_net.py``).

    python -m proben_tpu_torch.apps.train_net \\
        --config-file configs/FLIR-Detection/faster_rcnn_R_101_FLIR.yaml \\
        [--eval-only] [--resume] [--register name,json,image_root] [--device cpu] [KEY VALUE ...]

Datasets named in DATASETS.TRAIN/TEST must be registered; ``--register``
registers a COCO-format one (repeatable). ``--eval-only`` evaluates
DATASETS.TEST with the (resumed) weights. Runs on ``--device`` (default
``cuda``; ``cpu`` runs the plain versions); data parallel under
``torchrun --nproc_per_node N -m proben_tpu_torch.apps.train_net ...``,
one rank per card (``DefaultTrainer``: the first ranks that divide
IMS_PER_BATCH train, any others sit out).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from ..config import get_cfg
from ..data import DatasetCatalog, register_coco_instances
from ..engine import DefaultTrainer
from ..utils.logger import setup_logger


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m proben_tpu_torch.apps.train_net")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument(
        "--register",
        action="append",
        default=[],
        help="dataset registration: name,json_path,image_root (repeatable)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="config overrides as KEY VALUE pairs")
    return parser.parse_args(argv)


def register_datasets(specs: Sequence[str]) -> None:
    """Register each "name,json_path,image_root" as a COCO-format dataset
    (replacing a dataset of that name)."""
    for spec in specs:
        name, json_path, image_root = spec.split(",")
        DatasetCatalog.remove(name)
        register_coco_instances(name, {}, json_path, image_root)


def setup(args: argparse.Namespace):
    """The config of the parsed arguments (``config_file``, ``opts``), with
    their datasets (``register``) registered."""
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    register_datasets(args.register)
    return cfg


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    cfg = setup(args)
    setup_logger(cfg.OUTPUT_DIR, distributed_rank=int(os.environ.get("RANK", "0")))
    trainer = DefaultTrainer(cfg, device=args.device)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        if trainer.train_loader is not None:  # None on a rank that sits out
            trainer.train_loader.close()
        results = trainer.evaluate()
        print(results)
        return results
    return trainer.train()


if __name__ == "__main__":
    main()
