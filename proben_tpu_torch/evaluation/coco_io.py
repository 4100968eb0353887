"""Minimal COCO-format dataset container (counterpart of
``proben_tpu/evaluation/coco_io.py``; replaces pycocotools' ``COCO`` api on the bbox path)."""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Union


class COCODataset:
    """Indexes a COCO-format annotation dict/file: images, categories,
    per-image annotations."""

    def __init__(self, source: Union[str, dict]):
        if isinstance(source, str):
            with open(source) as f:
                source = json.load(f)
        self.dataset = source
        self.imgs: Dict = {img["id"]: img for img in source.get("images", [])}
        self.cats: Dict = {c["id"]: c for c in source.get("categories", [])}
        self.img_to_anns = defaultdict(list)
        for ann in source.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)

    @property
    def image_ids(self) -> List:
        return sorted(self.imgs.keys())

    @property
    def category_ids(self) -> List:
        return sorted(self.cats.keys())

    @property
    def annotations(self) -> List[dict]:
        return list(self.dataset.get("annotations", []))

    def contiguous_category_mapping(self) -> Dict[int, int]:
        """dataset category id -> contiguous [0, C) id (detectron2's
        ``thing_dataset_id_to_contiguous_id`` convention: sorted by id)."""
        return {cid: i for i, cid in enumerate(self.category_ids)}

    def thing_classes(self) -> List[str]:
        return [self.cats[cid].get("name", str(cid)) for cid in self.category_ids]
