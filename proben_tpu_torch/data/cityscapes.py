"""Cityscapes instance-detection dataset loading (a copy of
``proben_tpu/data/cityscapes.py``; reference
`detectron2/data/datasets/cityscapes.py`, which shells polygon parsing
through cityscapesscripts + a process pool; the ``*_gtFine_polygons.json``
files are parsed directly here).

Only the from_json/to_polygons path is implemented — the detector consumes
boxes (+ optional polygons); png instance-id decoding is not needed.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from typing import List

from ..evaluation.cityscapes import CITYSCAPES_THING_CLASSES
from ..structures.boxes import BoxMode
from .catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger(__name__)

__all__ = ["load_cityscapes_instances", "register_cityscapes_instances"]

_NAME_TO_CONTIGUOUS = {n: i for i, n in enumerate(CITYSCAPES_THING_CLASSES)}


def _polygons_to_record(image_file: str, json_file: str, image_id: str) -> dict:
    with open(json_file) as f:
        data = json.load(f)
    record = {
        "file_name": image_file,
        "image_id": image_id,
        "height": data["imgHeight"],
        "width": data["imgWidth"],
    }
    annos = []
    for obj in data["objects"]:
        if obj.get("deleted"):
            continue
        label = obj["label"]
        # crowd regions are annotated as "<class>group" (cityscapesscripts
        # name2label fallback) — keep them as iscrowd
        iscrowd = 0
        if label not in _NAME_TO_CONTIGUOUS and label.endswith("group"):
            label = label[: -len("group")]
            iscrowd = 1
        if label not in _NAME_TO_CONTIGUOUS:
            continue  # stuff / ignored classes
        poly = obj["polygon"]
        xs = [p[0] for p in poly]
        ys = [p[1] for p in poly]
        annos.append(
            {
                "category_id": _NAME_TO_CONTIGUOUS[label],
                "bbox": [
                    float(min(xs)),
                    float(min(ys)),
                    float(max(xs)),
                    float(max(ys)),
                ],
                "bbox_mode": BoxMode.XYXY_ABS,
                "iscrowd": iscrowd,
                "segmentation": [[float(v) for xy in poly for v in xy]],
            }
        )
    record["annotations"] = annos
    return record


def load_cityscapes_instances(image_dir: str, gt_dir: str) -> List[dict]:
    """image_dir: .../leftImg8bit/<split>; gt_dir: .../gtFine/<split>."""
    suffix = "leftImg8bit.png"
    dicts = []
    for image_file in sorted(
        glob.glob(os.path.join(image_dir, "**", "*" + suffix), recursive=True)
    ):
        rel = image_file[len(image_dir) :].lstrip("/")
        stem = rel[: -len(suffix)]
        json_file = os.path.join(gt_dir, stem + "gtFine_polygons.json")
        if not os.path.isfile(json_file):
            raise FileNotFoundError(json_file)
        dicts.append(
            _polygons_to_record(image_file, json_file, stem.rstrip("_"))
        )
    if not dicts:
        raise FileNotFoundError(f"no {suffix} images under {image_dir}")
    logger.info("loaded %d cityscapes images from %s", len(dicts), image_dir)
    return dicts


def register_cityscapes_instances(name: str, image_dir: str, gt_dir: str):
    DatasetCatalog.register(
        name, lambda: load_cityscapes_instances(image_dir, gt_dir)
    )
    meta = MetadataCatalog.get(name)
    meta.thing_classes = list(CITYSCAPES_THING_CLASSES)
    meta.image_dir = image_dir
    meta.gt_dir = gt_dir
    meta.evaluator_type = "cityscapes_instance"
