"""Draw the ground truth of a registered dataset (counterpart of
``tools/visualize_data.py``; reference ``tools/visualize_data.py``).

    python -m proben_tpu_torch.apps.visualize_data --register name,json,image_root \\
        --dataset name --output-dir out_vis [--max-images 20] [--format BGR] [--device cpu]

Each image is read by ``data.read_image`` on ``--device`` (default
``cuda``: nvJPEG, or the host decode of a file that is not a JPEG; ``cpu``:
cv2, as the JAX tool reads it), its boxes converted to XYXY by each
annotation's ``bbox_mode`` (XYWH by default) and drawn with their classes
by ``Visualizer``, written as ``<output-dir>/<file name>.png``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import DatasetCatalog, MetadataCatalog, read_image
from ..device import resolve_device
from ..structures.boxes import BoxMode, convert_box_mode
from ..utils.visualizer import Visualizer
from .train_net import register_datasets


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m proben_tpu_torch.apps.visualize_data")
    parser.add_argument("--register", action="append", default=[],
                        help="dataset registration: name,json_path,image_root (repeatable)")
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--output-dir", default="out_vis")
    parser.add_argument("--max-images", type=int, default=20)
    parser.add_argument("--format", default="BGR")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Write the drawings; returns how many."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    register_datasets(args.register)

    dicts = DatasetCatalog.get(args.dataset)[: args.max_images]
    meta = MetadataCatalog.get(args.dataset)
    os.makedirs(args.output_dir, exist_ok=True)
    for d in dicts:
        img = read_image(d["file_name"], args.format, device=device)
        if torch.is_tensor(img):
            img = img.cpu().numpy()
        boxes, classes = [], []
        for a in d.get("annotations", []):
            boxes.append(convert_box_mode(np.asarray(a["bbox"], np.float32),
                                          a.get("bbox_mode", BoxMode.XYWH_ABS), BoxMode.XYXY_ABS))
            classes.append(a["category_id"])
        vis = Visualizer(img[:, :, :3], meta).overlay_instances(
            boxes=np.asarray(boxes).reshape(-1, 4),
            classes=np.asarray(classes, np.int64),
        )
        vis.save(os.path.join(args.output_dir, os.path.basename(d["file_name"]) + ".png"))
    print(f"wrote {len(dicts)} visualizations to {args.output_dir}")
    return len(dicts)


if __name__ == "__main__":
    main()
