"""Evaluator dispatch by dataset metadata (counterpart of
``proben_tpu/evaluation/build.py``; the reference's per-project
``build_evaluator`` pattern, e.g. `tools/train_net.py:62-95`): pick the
dataset's evaluator from ``MetadataCatalog.get(name).evaluator_type``.

The FLIR, COCO, LVIS, Pascal VOC and Cityscapes evaluators speak the
``reset/process(image_id, boxes_xyxy, scores, classes)/evaluate`` protocol
of ``inference_on_dataset`` (Cityscapes through a box-to-mask adapter); the
KAIST evaluator takes the whole split's detections
(``KAISTEvaluator.evaluate_all_conditions``).
"""

from __future__ import annotations

from typing import Optional

from ..structures.boxes import BoxMode

__all__ = ["build_evaluator"]


def _voc_evaluator(name):
    from ..data import DatasetCatalog, MetadataCatalog
    from .pascal_voc import PascalVOCDetectionEvaluator

    meta = MetadataCatalog.get(name)
    ev = PascalVOCDetectionEvaluator(
        meta.thing_classes, use_07_metric=meta.get("year") == 2007
    )
    for d in DatasetCatalog.get(name):
        boxes, classes, difficult = [], [], []
        for ann in d.get("annotations", []):
            b = list(ann["bbox"])
            if ann.get("bbox_mode", BoxMode.XYXY_ABS) == BoxMode.XYWH_ABS:
                b = [b[0], b[1], b[0] + b[2], b[1] + b[3]]
            boxes.append(b)
            classes.append(ann["category_id"])
            difficult.append(ann.get("difficult", 0))
        if boxes:
            ev.add_ground_truth(d["image_id"], boxes, classes, difficult)
    return ev


class _CityscapesBoxProtocolAdapter:
    """Bridges ``inference_on_dataset``'s box protocol to the mask-based
    CityscapesInstanceEvaluator for the box-only detector family: predicted
    boxes are rasterized as rectangular masks (documented approximation —
    the reference's evaluator requires ``pred_masks`` and simply cannot run
    on a box-only model, `cityscapes_evaluation.py:60-77`). gt masks come
    from the dataset dicts' polygons, rasterized full-image."""

    def __init__(self, inner, shapes, gt):
        self._inner = inner
        self._shapes = shapes  # image_id -> (H, W)
        self._gt = gt  # [(image_id, masks, classes)] — replayed on reset
        self._replay_gt()

    def _replay_gt(self):
        for image_id, masks, classes in self._gt:
            self._inner.add_ground_truth(image_id, masks, classes)

    def reset(self):
        # the lifecycle calls reset() before process(); gt registered at
        # build time must survive it
        self._inner.reset()
        self._replay_gt()

    def process(self, image_id, boxes, scores, classes):
        import numpy as np

        h, w = self._shapes[image_id]
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        masks = np.zeros((len(boxes), h, w), np.uint8)
        for i, (x0, y0, x1, y1) in enumerate(boxes):
            masks[i, int(max(y0, 0)) : int(min(y1, h)) + 1,
                  int(max(x0, 0)) : int(min(x1, w)) + 1] = 1
        self._inner.process(image_id, masks, scores, classes)

    def evaluate(self):
        return self._inner.evaluate()


def _rasterize_polygons(polys, h, w):
    """Full-image binary mask from flat [x0,y0,x1,y1,...] polygon lists."""
    import numpy as np
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for p in polys:
        draw.polygon([float(v) for v in p], outline=1, fill=1)
    return np.asarray(img, np.uint8)


def _cityscapes_evaluator(name, output_dir):
    import os

    from ..data import DatasetCatalog, MetadataCatalog
    from .cityscapes import CityscapesInstanceEvaluator

    meta = MetadataCatalog.get(name)
    ev = CityscapesInstanceEvaluator(
        output_dir or os.path.join("./output", "cityscapes_eval"),
        thing_classes=meta.thing_classes,
        gt_dir=meta.get("gt_dir"),
    )
    shapes = {}
    gt = []
    for d in DatasetCatalog.get(name):
        h, w = d["height"], d["width"]
        shapes[d["image_id"]] = (h, w)
        masks, classes = [], []
        for ann in d.get("annotations", []):
            if ann.get("iscrowd"):
                continue
            masks.append(_rasterize_polygons(ann["segmentation"], h, w))
            classes.append(ann["category_id"])
        if masks:
            gt.append((d["image_id"], masks, classes))
    return _CityscapesBoxProtocolAdapter(ev, shapes, gt)


def build_evaluator(dataset_name: str, output_dir: Optional[str] = None):
    from ..data import MetadataCatalog

    meta = MetadataCatalog.get(dataset_name)
    etype = meta.get("evaluator_type", "flir")
    if etype == "flir":
        from .flir import FLIREvaluator

        return FLIREvaluator(meta.json_file, output_dir=output_dir)
    if etype == "coco":
        from .coco_io import COCODataset
        from .flir import FLIREvaluator

        # generic COCO bbox evaluation: the FLIR evaluator core without the
        # FLIR class filter/remap (valid_classes are CONTIGUOUS model class
        # indices — process() unmaps them to dataset ids afterwards)
        coco = COCODataset(meta.json_file)
        return FLIREvaluator(
            coco,
            output_dir=output_dir,
            valid_classes=range(len(coco.cats)),
            class_remap={},
        )
    if etype == "lvis":
        from .lvis import LVISEvaluator

        return LVISEvaluator(meta.json_file, output_dir=output_dir)
    if etype == "pascal_voc":
        return _voc_evaluator(dataset_name)
    if etype == "kaist":
        from .kaist import KAISTEvaluator

        return KAISTEvaluator(meta.json_file)
    if etype == "cityscapes_instance":
        return _cityscapes_evaluator(dataset_name, output_dir)
    raise ValueError(
        f"no evaluator registered for evaluator_type={etype!r} "
        f"(dataset {dataset_name!r}); pass one explicitly"
    )
