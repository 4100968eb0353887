"""Model zoo API (counterpart of ``proben_tpu/model_zoo.py``; reference
``detectron2/model_zoo/model_zoo.py``): map config paths to configs and
checkpoints and build ready models.

Checkpoints resolve to local paths only: set PROBEN_ZOO_DIR (or pass
``zoo_dir``) to a directory holding the detectron2 zoo files; the name
mapping mirrors the reference's ``detectron2://`` catalog entries. Nothing
is downloaded."""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch

CONFIGS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")

# config path -> zoo checkpoint file name (detectron2 release artifacts)
CHECKPOINT_NAMES = {
    "COCO-Detection/faster_rcnn_R_50_FPN_3x.yaml": "model_final_280758.pkl",
    "COCO-Detection/faster_rcnn_R_101_FPN_3x.yaml": "model_final_f6e8b1.pkl",
    "FLIR-Detection/faster_rcnn_R_101_FLIR.yaml": "model_final_f6e8b1.pkl",
}


def get_config_file(config_path: str) -> str:
    path = os.path.join(CONFIGS_DIR, config_path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no config at {path}")
    return path


def get_checkpoint_path(config_path: str, zoo_dir: Optional[str] = None) -> Optional[str]:
    zoo_dir = zoo_dir or os.environ.get("PROBEN_ZOO_DIR", "")
    name = CHECKPOINT_NAMES.get(config_path)
    if not zoo_dir or not name:
        return None
    path = os.path.join(zoo_dir, name)
    return path if os.path.exists(path) else None


def get_config(config_path: str, trained: bool = False):
    from .config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(get_config_file(config_path))
    if trained:
        ckpt = get_checkpoint_path(config_path)
        if ckpt:
            cfg.MODEL.WEIGHTS = ckpt
    return cfg


def get(config_path: str, trained: bool = False, device: Union[str, torch.device] = "cuda") -> Tuple:
    """Build (model, model_cfg) for a zoo config (reference
    ``model_zoo.get``): the port's ``RCNN`` on ``device`` from the port's
    init, with the zoo checkpoint imported (``strict=False``) when
    ``trained`` and a file is found."""
    from .checkpoint import import_detectron2_checkpoint
    from .config import model_config_from_cfg
    from .models import build_model, init_rcnn

    cfg = get_config(config_path, trained)
    model_cfg = model_config_from_cfg(cfg)
    params = init_rcnn(0, model_cfg)
    if trained and cfg.MODEL.WEIGHTS:
        params = import_detectron2_checkpoint(cfg.MODEL.WEIGHTS, params, strict=False)
    return build_model(model_cfg, params=params, device=device), model_cfg
