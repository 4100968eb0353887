"""LVIS dataset loading (a copy of ``proben_tpu/data/lvis.py``; reference
`detectron2/data/datasets/lvis.py`,
which wraps the ``lvis`` package's LVIS API — the v1/v0.5 JSON is parsed
directly here, no extra dependency).

Dataset dicts carry the federated-evaluation fields
(``neg_category_ids``, ``not_exhaustive_category_ids``) consumed by
``evaluation.lvis.LVISEvaluator``.
"""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from typing import List, Optional

from ..structures.boxes import BoxMode
from .catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger(__name__)

__all__ = ["load_lvis_json", "register_lvis_instances", "get_lvis_instances_meta"]


def _file_name_from_image(img: dict) -> str:
    if "file_name" in img:
        return img["file_name"]
    # LVIS v1 images carry coco_url like .../val2017/000000397133.jpg;
    # the last two path components locate the file under the COCO root
    # (reference lvis.py:119)
    coco_url = img["coco_url"]
    return "/".join(coco_url.split("/")[-2:])


def load_lvis_json(
    json_file: str, image_root: str, dataset_name: Optional[str] = None
) -> List[dict]:
    with open(json_file) as f:
        data = json.load(f)

    if dataset_name is not None:
        meta = get_lvis_instances_meta(data)
        md = MetadataCatalog.get(dataset_name)
        for k, v in meta.items():
            setattr(md, k, v)
        md.json_file = json_file
        md.image_root = image_root
        md.evaluator_type = "lvis"

    anns_by_img = defaultdict(list)
    for ann in data["annotations"]:
        anns_by_img[ann["image_id"]].append(ann)
    ann_ids = [a["id"] for a in data["annotations"]]
    if len(set(ann_ids)) != len(ann_ids):
        raise ValueError(f"annotation ids in {json_file} are not unique")

    dicts = []
    for img in sorted(data["images"], key=lambda im: im["id"]):
        record = {
            "file_name": os.path.join(image_root, _file_name_from_image(img)),
            "image_id": img["id"],
            "height": img.get("height"),
            "width": img.get("width"),
            "neg_category_ids": img.get("neg_category_ids", []),
            "not_exhaustive_category_ids": img.get(
                "not_exhaustive_category_ids", []
            ),
        }
        annos = []
        for ann in anns_by_img.get(img["id"], []):
            annos.append(
                {
                    "bbox": [float(v) for v in ann["bbox"]],
                    "bbox_mode": BoxMode.XYWH_ABS,
                    # LVIS category ids are 1-based and contiguous already
                    "category_id": ann["category_id"] - 1,
                    "segmentation": ann.get("segmentation"),
                }
            )
        record["annotations"] = annos
        dicts.append(record)
    logger.info("loaded %d LVIS images from %s", len(dicts), json_file)
    return dicts


def get_lvis_instances_meta(data: dict) -> dict:
    """thing_classes ordered by (1-based contiguous) category id, plus the
    raw categories (frequency buckets feed the evaluator)."""
    cats = sorted(data["categories"], key=lambda c: c["id"])
    if [c["id"] for c in cats] != list(range(1, len(cats) + 1)):
        raise ValueError("LVIS category ids must be contiguous from 1")

    def name_of(c):
        # v0.5 uses synonyms[0], v1 carries name
        return c.get("name") or c["synonyms"][0]

    return {
        "thing_classes": [name_of(c) for c in cats],
        "lvis_categories": cats,
    }


def register_lvis_instances(name: str, metadata: dict, json_file: str, image_root: str):
    DatasetCatalog.register(name, lambda: load_lvis_json(json_file, image_root, name))
    md = MetadataCatalog.get(name)
    md.json_file = json_file
    md.image_root = image_root
    md.evaluator_type = "lvis"
    for k, v in metadata.items():
        setattr(md, k, v)
