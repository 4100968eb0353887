"""Pascal VOC detection dataset loading (a copy of ``proben_tpu/data/pascal_voc.py``; reference
`detectron2/data/datasets/pascal_voc.py`): XML annotations -> standard
dataset dicts, 1-based inclusive pixel boxes converted to 0-based XYXY.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List

from ..structures.boxes import BoxMode
from .catalog import DatasetCatalog, MetadataCatalog

__all__ = ["VOC_CLASS_NAMES", "load_voc_instances", "register_pascal_voc"]

VOC_CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def load_voc_instances(dirname: str, split: str) -> List[dict]:
    """dirname contains Annotations/, ImageSets/, JPEGImages/; split is one
    of train/val/trainval/test. Difficult objects are kept (reference
    pascal_voc.py:54 keeps them for training)."""
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        fileids = [line.strip() for line in f if line.strip()]

    dicts = []
    for fileid in fileids:
        anno_file = os.path.join(dirname, "Annotations", fileid + ".xml")
        jpeg_file = os.path.join(dirname, "JPEGImages", fileid + ".jpg")
        tree = ET.parse(anno_file)
        record = {
            "file_name": jpeg_file,
            "image_id": fileid,
            "height": int(tree.findall("./size/height")[0].text),
            "width": int(tree.findall("./size/width")[0].text),
        }
        instances = []
        for obj in tree.findall("object"):
            cls = obj.find("name").text
            bbox = obj.find("bndbox")
            xyxy = [
                float(bbox.find(x).text) for x in ("xmin", "ymin", "xmax", "ymax")
            ]
            # VOC boxes are 1-based inclusive pixel indices; shift the min
            # corner so (1, W) covers [0, W) in coordinate space
            xyxy[0] -= 1.0
            xyxy[1] -= 1.0
            instances.append(
                {
                    "category_id": VOC_CLASS_NAMES.index(cls),
                    "bbox": xyxy,
                    "bbox_mode": BoxMode.XYXY_ABS,
                    "difficult": int(obj.findtext("difficult", "0")),
                }
            )
        record["annotations"] = instances
        dicts.append(record)
    return dicts


def register_pascal_voc(name: str, dirname: str, split: str, year: int):
    DatasetCatalog.register(name, lambda: load_voc_instances(dirname, split))
    meta = MetadataCatalog.get(name)
    meta.thing_classes = list(VOC_CLASS_NAMES)
    meta.dirname = dirname
    meta.year = year
    meta.split = split
    meta.evaluator_type = "pascal_voc"
