"""Draw a COCO/LVIS-format prediction JSON next to the ground truth
(counterpart of ``tools/visualize_json_results.py``; reference
``tools/visualize_json_results.py``): for each image of the dataset, the
predictions above the threshold on the left, the annotations on the right.

    python -m proben_tpu_torch.apps.visualize_json_results --input preds.json \\
        --output out_dir --dataset name [--conf-threshold 0.5] [--device cpu]

The dataset must be registered in the process's ``DatasetCatalog`` (e.g.
by ``register_coco_instances``).
Images are read on ``--device`` (default ``cuda``: nvJPEG, or the host
decode of a file that is not a JPEG; ``cpu``: ``cv2.imread``, as the JAX
tool reads them); an image that cannot be read is skipped. Each drawing is
written with ``cv2.imwrite`` under the image's own file name.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

from ..data import DatasetCatalog, MetadataCatalog, read_image
from ..device import resolve_device
from ..structures.boxes import BoxMode
from ..utils.visualizer import Visualizer


def filtered_predictions(preds, conf_threshold, id_map):
    """XYWH prediction dicts -> (boxes XYXY, scores, classes) above the
    threshold (reference ``create_instances``)."""
    scores = np.asarray([p["score"] for p in preds], np.float32)
    keep = np.nonzero(scores > conf_threshold)[0]
    boxes = np.asarray([preds[i]["bbox"] for i in keep], np.float32).reshape(-1, 4)
    boxes = np.concatenate([boxes[:, :2], boxes[:, :2] + boxes[:, 2:]], axis=1)
    classes = np.asarray([id_map(preds[i]["category_id"]) for i in keep], np.int32)
    return boxes, scores[keep], classes


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m proben_tpu_torch.apps.visualize_json_results",
                                     description=__doc__)
    parser.add_argument("--input", required=True, help="prediction JSON")
    parser.add_argument("--output", required=True, help="output directory")
    parser.add_argument("--dataset", required=True, help="registered dataset name")
    parser.add_argument("--conf-threshold", default=0.5, type=float)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def _read(path, device, cv2):
    """The file as HWC uint8 BGR, or None where it cannot be read."""
    if device.type == "cpu":
        return cv2.imread(path, cv2.IMREAD_COLOR)
    if not os.path.isfile(path):
        return None
    return read_image(path, "BGR", device=device).round().to("cpu").numpy().astype(np.uint8)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Write the drawings; returns the number of dataset images."""
    import cv2

    args = parse_args(argv)
    device = resolve_device(args.device)

    with open(args.input) as f:
        predictions = json.load(f)
    pred_by_image = defaultdict(list)
    for p in predictions:
        pred_by_image[p["image_id"]].append(p)

    dicts = list(DatasetCatalog.get(args.dataset))
    metadata = MetadataCatalog.get(args.dataset)
    mapping = metadata.get("thing_dataset_id_to_contiguous_id")
    if mapping is not None:
        id_map = mapping.__getitem__
    elif "lvis" in args.dataset:
        id_map = lambda ds_id: ds_id - 1  # noqa: E731  (LVIS ids are 1-based)
    else:
        id_map = lambda ds_id: ds_id  # noqa: E731

    os.makedirs(args.output, exist_ok=True)
    for dic in dicts:
        img = _read(dic["file_name"], device, cv2)
        if img is None:
            continue
        boxes, scores, classes = filtered_predictions(
            pred_by_image.get(dic["image_id"], []), args.conf_threshold, id_map)
        vis_pred = Visualizer(img, metadata).overlay_instances(
            boxes=boxes, classes=classes, scores=scores).get_image()
        gt_boxes, gt_classes = [], []
        for ann in dic.get("annotations", []):
            b = list(ann["bbox"])
            # COCO dicts hold XYWH_ABS, VOC and Cityscapes dicts XYXY_ABS
            if ann.get("bbox_mode", BoxMode.XYWH_ABS) == BoxMode.XYWH_ABS:
                b = [b[0], b[1], b[0] + b[2], b[1] + b[3]]
            gt_boxes.append(b)
            gt_classes.append(ann.get("category_id", 0))
        vis_gt = Visualizer(img, metadata).overlay_instances(
            boxes=np.asarray(gt_boxes, np.float32).reshape(-1, 4),
            classes=np.asarray(gt_classes, np.int32)).get_image()
        cv2.imwrite(os.path.join(args.output, os.path.basename(dic["file_name"])),
                    np.concatenate((vis_pred, vis_gt), axis=1))
    print(f"wrote visualizations for {len(dicts)} images to {args.output}")
    return len(dicts)


if __name__ == "__main__":
    main()
