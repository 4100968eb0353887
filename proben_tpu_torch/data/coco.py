"""COCO-json dataset loading and registration, and semantic-segmentation
dataset dicts (counterpart of ``proben_tpu/data/coco.py``)."""

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


def load_sem_seg(
    gt_root: str, image_root: str, gt_ext: str = "png", image_ext: str = "jpg"
) -> List[dict]:
    """Semantic-segmentation dataset dicts (reference
    ``data/datasets/coco.py:198`` load_sem_seg): every ``image_ext`` file
    under image_root matched to the ``gt_ext`` label map sharing its
    extension-less relative path. Unpaired files are dropped with a warning
    (reference behavior: intersect on ids)."""
    import logging

    logger = logging.getLogger(__name__)

    def by_id(root, ext):
        out = {}
        for dirpath, _, files in os.walk(root):
            for f in files:
                if f.endswith(ext):
                    p = os.path.join(dirpath, f)
                    rid = os.path.splitext(os.path.relpath(p, root))[0]
                    out[rid] = p
        return out

    inputs = by_id(image_root, image_ext)
    gts = by_id(gt_root, gt_ext)
    ids = sorted(set(inputs) & set(gts))
    if len(ids) != len(inputs) or len(ids) != len(gts):
        logger.warning(
            "load_sem_seg: using %d matched pairs of %d images / %d gts",
            len(ids), len(inputs), len(gts),
        )
    return [
        {"file_name": inputs[i], "sem_seg_file_name": gts[i]} for i in ids
    ]
