"""COCO-json dataset loading and registration (counterpart of
``proben_tpu/data/coco.py``; ``load_sem_seg`` is not ported)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ..evaluation.coco_io import COCODataset
from ..structures.boxes import BoxMode
from .catalog import DatasetCatalog, MetadataCatalog


def load_coco_json(
    json_file: str, image_root: str, dataset_name: Optional[str] = None
) -> List[dict]:
    """Returns detectron2-style dataset dicts: file_name, image_id, height,
    width, annotations[{bbox (XYWH floats), bbox_mode, category_id
    (contiguous), iscrowd}]."""
    coco = COCODataset(json_file)
    id_map = coco.contiguous_category_mapping()

    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        meta.thing_classes = coco.thing_classes()
        meta.thing_dataset_id_to_contiguous_id = id_map
        meta.json_file = json_file
        meta.image_root = image_root

    dicts = []
    for img_id in coco.image_ids:
        img = coco.imgs[img_id]
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "image_id": img_id,
            "height": img.get("height"),
            "width": img.get("width"),
        }
        annos = []
        for ann in coco.img_to_anns.get(img_id, []):
            if ann.get("ignore", 0):
                continue
            annos.append(
                {
                    "bbox": [float(v) for v in ann["bbox"]],
                    "bbox_mode": BoxMode.XYWH_ABS,
                    "category_id": id_map[ann["category_id"]],
                    "iscrowd": ann.get("iscrowd", 0),
                }
            )
        record["annotations"] = annos
        dicts.append(record)
    return dicts


def register_coco_instances(name: str, metadata: Dict, json_file: str, image_root: str):
    """Reference ``register_coco_instances``: catalog entry + metadata."""
    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root, name))
    meta = MetadataCatalog.get(name)
    meta.json_file = json_file
    meta.image_root = image_root
    meta.evaluator_type = "coco"
    for k, v in metadata.items():
        setattr(meta, k, v)
