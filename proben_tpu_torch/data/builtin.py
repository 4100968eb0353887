"""Built-in dataset registrations (a copy of ``proben_tpu/data/builtin.py``; reference
`detectron2/data/datasets/builtin.py`): standard COCO / LVIS / Pascal VOC /
Cityscapes splits registered lazily under ``$DETECTRON2_DATASETS``
(default ``datasets/``). Registration is cheap — the loader functions only
touch disk when a split is actually fetched from the catalog.

Call ``register_all_builtin()`` explicitly (the reference registers at
import time; an explicit call keeps test catalogs clean).
"""

from __future__ import annotations

import os

from .catalog import DatasetCatalog, MetadataCatalog
from .cityscapes import register_cityscapes_instances
from .coco import register_coco_instances
from .lvis import register_lvis_instances
from .pascal_voc import register_pascal_voc

__all__ = ["register_all_builtin", "COCO_THING_CLASSES"]

# the 80 COCO detection categories in contiguous-id order
# (reference data/datasets/builtin_meta.py COCO_CATEGORIES isthing=1 rows)
COCO_THING_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

_COCO_SPLITS = {
    "coco_2017_train": ("coco/train2017", "coco/annotations/instances_train2017.json"),
    "coco_2017_val": ("coco/val2017", "coco/annotations/instances_val2017.json"),
    "coco_2014_train": ("coco/train2014", "coco/annotations/instances_train2014.json"),
    "coco_2014_val": ("coco/val2014", "coco/annotations/instances_val2014.json"),
}

_LVIS_SPLITS = {
    "lvis_v1_train": ("coco/", "lvis/lvis_v1_train.json"),
    "lvis_v1_val": ("coco/", "lvis/lvis_v1_val.json"),
    "lvis_v0.5_train": ("coco/train2017", "lvis/lvis_v0.5_train.json"),
    "lvis_v0.5_val": ("coco/val2017", "lvis/lvis_v0.5_val.json"),
}

_VOC_SPLITS = [
    ("voc_2007_trainval", "VOC2007", "trainval", 2007),
    ("voc_2007_train", "VOC2007", "train", 2007),
    ("voc_2007_val", "VOC2007", "val", 2007),
    ("voc_2007_test", "VOC2007", "test", 2007),
    ("voc_2012_trainval", "VOC2012", "trainval", 2012),
    ("voc_2012_train", "VOC2012", "train", 2012),
    ("voc_2012_val", "VOC2012", "val", 2012),
]

_CITYSCAPES_SPLITS = {
    "cityscapes_fine_instance_seg_train": ("cityscapes/leftImg8bit/train", "cityscapes/gtFine/train"),
    "cityscapes_fine_instance_seg_val": ("cityscapes/leftImg8bit/val", "cityscapes/gtFine/val"),
    "cityscapes_fine_instance_seg_test": ("cityscapes/leftImg8bit/test", "cityscapes/gtFine/test"),
}


def register_all_builtin(root: str = None):
    root = root or os.environ.get("DETECTRON2_DATASETS", "datasets")
    for name, (image_root, json_file) in _COCO_SPLITS.items():
        if name in DatasetCatalog.list():
            continue
        register_coco_instances(
            name,
            {"thing_classes": COCO_THING_CLASSES},
            os.path.join(root, json_file),
            os.path.join(root, image_root),
        )
    for name, (image_root, json_file) in _LVIS_SPLITS.items():
        if name in DatasetCatalog.list():
            continue
        register_lvis_instances(
            name, {}, os.path.join(root, json_file), os.path.join(root, image_root)
        )
    for name, dirname, split, year in _VOC_SPLITS:
        if name in DatasetCatalog.list():
            continue
        register_pascal_voc(name, os.path.join(root, dirname), split, year)
    for name, (image_dir, gt_dir) in _CITYSCAPES_SPLITS.items():
        if name in DatasetCatalog.list():
            continue
        register_cityscapes_instances(
            name, os.path.join(root, image_dir), os.path.join(root, gt_dir)
        )
    return MetadataCatalog
