"""DatasetMapper: dataset dict -> fixed-shape model inputs (counterpart of
``proben_tpu/data/dataset_mapper.py``; the test branch).

Every mapped sample is padded to one static ``pad_shape`` and its GT to
``max_gt`` with a validity mask, so batches have identical shapes. On the
CPU the image is read and resized with cv2 exactly as the JAX package does;
on the card (``device="cuda"``, the default) it is decoded with nvJPEG and
composed, resized and padded by the ``image_io`` kernel, one launch per
``map_batch`` call, and stays on the card. The GT arrays stay numpy.
The training branch (augmentation) comes with the trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..structures.boxes import BoxMode, convert_box_mode
from .detection_utils import derive_rgb_path, read_image
from .transforms import TestResize


@dataclasses.dataclass
class MapperConfig:
    input_format: str = "BGR"  # BGR | BGRT | BGRTTT
    pad_shape: Tuple[int, int] = (800, 1024)  # static (H, W) after resize
    max_gt: int = 64
    min_size_train: Sequence[int] = (640, 672, 704, 736, 768, 800)
    max_size_train: int = 1333
    min_size_test: int = 800
    max_size_test: int = 1333
    flip: bool = True
    crop: Optional[Tuple[float, float]] = None  # relative_range crop

    @property
    def num_channels(self) -> int:
        return {"BGR": 3, "RGB": 3, "L": 1, "BGRT": 4, "BGRTTT": 6}[self.input_format]


class DatasetMapper:
    """Maps dataset dicts to samples on ``device``. Holds an nvJPEG codec
    on the card; ``close`` releases it."""

    def __init__(self, cfg: MapperConfig, is_train: bool = True, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        if is_train:
            raise NotImplementedError(
                "DatasetMapper(is_train=True): the training augmentation comes with the "
                "trainer slice (ROADMAP 12f); use is_train=False")
        self.cfg = cfg
        self.is_train = is_train
        self.device = resolve_device(device)
        self.test_resize = TestResize(cfg.min_size_test, cfg.max_size_test)
        self.codec = None
        if self.device.type == "cuda":
            from ..native.io import FORMATS, JpegCodec

            if cfg.input_format not in FORMATS:
                raise ValueError(f"input_format {cfg.input_format!r} on the card: expected one "
                                 f"of {sorted(FORMATS)}")
            with torch.cuda.device(self.device):
                self.codec = JpegCodec()

    def close(self) -> None:
        if self.codec is not None:
            self.codec.close()
            self.codec = None

    def __call__(self, dataset_dict: Dict) -> Dict:
        """Returns one sample of a dataset dict ("file_name" the image, for
        BGRT/BGRTTT the thermal one; optional "rgb_file", else derived by
        ``derive_rgb_path``): image (H, W, C) float32 tensor on the mapper's
        device, padded; image_size (2,); gt_boxes (G, 4) XYXY in the resized
        frame, gt_classes (G,), gt_valid (G,) numpy; plus bookkeeping
        (image_id, orig_size, file_name)."""
        return self.map_batch([dataset_dict])[0]

    def map_batch(self, dataset_dicts: Sequence[Dict]) -> List[Dict]:
        """``[self(d) for d in dataset_dicts]``; on the card the images are
        views of one canvas made by one kernel launch."""
        cfg = self.cfg
        if self.device.type == "cpu":
            images, sizes, origs = [], [], []
            for d in dataset_dicts:
                image = read_image(d["file_name"], cfg.input_format, device="cpu",
                                   rgb_file=d.get("rgb_file"))
                origs.append(image.shape[:2])
                image, (new_h, new_w) = self.test_resize(image)
                ph, pw = cfg.pad_shape
                if new_h > ph or new_w > pw:
                    raise ValueError(
                        f"resized image ({new_h}, {new_w}) exceeds pad_shape {cfg.pad_shape}"
                    )
                padded = np.zeros((ph, pw, image.shape[2]), np.float32)
                padded[:new_h, :new_w] = image
                images.append(torch.from_numpy(padded))
                sizes.append((new_h, new_w))
        else:
            from ..native.io import load_batch

            paths = [d["file_name"] for d in dataset_dicts]
            rgb = ([d.get("rgb_file") or derive_rgb_path(d["file_name"]) for d in dataset_dicts]
                   if cfg.input_format != "BGR" else None)
            with torch.cuda.device(self.device):
                canvas, sizes, origs = load_batch(self.codec, paths, rgb, cfg.input_format,
                                                  self.test_resize.size, tuple(cfg.pad_shape))
            images = list(canvas)
        return [self._sample(d, img, tuple(int(v) for v in hw), tuple(int(v) for v in orig))
                for d, img, hw, orig in zip(dataset_dicts, images, sizes, origs)]

    def _sample(self, dataset_dict: Dict, image: torch.Tensor, new_hw, orig_hw) -> Dict:
        (new_h, new_w), (orig_h, orig_w) = new_hw, orig_hw
        annos = [a for a in dataset_dict.get("annotations", []) if not a.get("iscrowd", 0)]
        boxes = np.array(
            [
                convert_box_mode(
                    np.asarray(a["bbox"], np.float32), a.get("bbox_mode", BoxMode.XYWH_ABS), BoxMode.XYXY_ABS
                )
                for a in annos
            ],
            np.float32,
        ).reshape(-1, 4)
        classes = np.array([a["category_id"] for a in annos], np.int64)

        # clip boxes to the resized frame and drop empties
        if len(boxes):
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, new_w)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, new_h)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            boxes, classes = boxes[keep], classes[keep]

        g = self.cfg.max_gt
        gt_boxes = np.zeros((g, 4), np.float32)
        gt_classes = np.zeros((g,), np.int32)
        gt_valid = np.zeros((g,), bool)
        n = min(len(boxes), g)
        gt_boxes[:n] = boxes[:n]
        gt_classes[:n] = classes[:n]
        gt_valid[:n] = True

        return {
            "image": image,
            "image_size": np.array([new_h, new_w], np.int32),
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "image_id": dataset_dict.get("image_id"),
            "orig_size": np.array([orig_h, orig_w], np.int32),
            "file_name": dataset_dict["file_name"],
        }
