"""DatasetMapper: dataset dict -> fixed-shape model inputs (counterpart of
``proben_tpu/data/dataset_mapper.py``).

Every mapped sample is padded to one static ``pad_shape`` and its GT to
``max_gt`` with a validity mask, so batches have identical shapes. On the
CPU the image is read, augmented (training) or resized (test) with cv2
exactly as the JAX package does; on the card (``device="cuda"``, the
default) it is decoded (a JPEG with nvJPEG, any other file with cv2 on the
host, ``native/io.py::load_batch``) and composed, cropped and flipped
(training), resized and padded by the ``image_io`` kernel, one launch per
``map_batch`` call, and stays on the card. The training draws come from one
``np.random.RandomState(seed)`` in the JAX package's order on both devices
(``TrainAugment``: the crop's four, the size, the flip). The GT arrays stay
numpy.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..structures.boxes import BoxMode, convert_box_mode
from .detection_utils import derive_rgb_path, read_image
from .transforms import TestResize, TrainAugment, hflip_boxes, resize_boxes


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


def _annotations(dataset_dict: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """The non-crowd boxes (G, 4) XYXY float32 and classes (G,) int64."""
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
    return boxes, np.array([a["category_id"] for a in annos], np.int64)


class DatasetMapper:
    """Maps dataset dicts to samples on ``device``. On the card it holds one
    nvJPEG codec per thread that maps (a loader's workers each get their
    own); ``close`` releases them. ``INPUT.CROP`` crops the composed frame
    on both devices: ``random_crop`` on the CPU, the ``image_io`` kernel's
    crop window on the card, from the same draws."""

    def __init__(self, cfg: MapperConfig, is_train: bool = True, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.is_train = is_train
        self.device = resolve_device(device)
        self.train_aug = TrainAugment(cfg.min_size_train, cfg.max_size_train, cfg.flip,
                                      np.random.RandomState(seed), crop=cfg.crop)
        self.test_resize = TestResize(cfg.min_size_test, cfg.max_size_test)
        self._local = threading.local()
        self._codecs: list = []
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            from ..native.io import FORMATS

            if cfg.input_format not in FORMATS:
                raise ValueError(f"input_format {cfg.input_format!r} on the card: expected one "
                                 f"of {sorted(FORMATS)}")
            self._codec()  # fails here, not in a loader's worker, without nvJPEG

    def _codec(self):
        codec = getattr(self._local, "codec", None)
        if codec is None:
            from ..native.io import JpegCodec

            with torch.cuda.device(self.device):
                codec = JpegCodec()
            self._local.codec = codec
            with self._lock:
                self._codecs.append(codec)
        return codec

    def close(self) -> None:
        with self._lock:
            codecs, self._codecs = self._codecs, []
        for codec in codecs:
            codec.close()
        self._local = threading.local()

    def __call__(self, dataset_dict: Dict) -> Dict:
        """Returns one sample of a dataset dict ("file_name" the image, for
        BGRT/BGRTTT the thermal one; optional "rgb_file", else derived by
        ``derive_rgb_path``): image (H, W, C) float32 tensor on the mapper's
        device, padded; image_size (2,); gt_boxes (G, 4) XYXY in the resized
        (training: augmented) frame, gt_classes (G,), gt_valid (G,) numpy;
        plus bookkeeping (image_id, orig_size, file_name) and, in training,
        "flip" (whether the image was flipped)."""
        return self.map_batch([dataset_dict])[0]

    def map_batch(self, dataset_dicts: Sequence[Dict],
                  rows: Optional[Tuple[int, int]] = None) -> List[Dict]:
        """``[self(d) for d in dataset_dicts]``, with the training draws
        made image by image in order; on the card the images are views of
        one canvas made by one kernel launch. ``rows`` (lo, hi): map only
        ``dataset_dicts[lo:hi]`` (a data-parallel rank's share of a global
        batch) and make the other images' training draws without mapping
        them, in order, so the mapped images are drawn as in the one-process
        batch."""
        lo, hi = (0, len(dataset_dicts)) if rows is None else rows
        for d in dataset_dicts[:lo]:
            self._skip_draws(d)
        out = self._map_batch(dataset_dicts[lo:hi])
        for d in dataset_dicts[hi:]:
            self._skip_draws(d)
        return out

    def _skip_draws(self, dataset_dict: Dict) -> None:
        """An image's training draws, made and dropped (nothing at test
        time). Without a crop neither the size's nor the flip's draw reads
        the image; a crop's draws read its frame's size."""
        if not self.is_train:
            return
        if self.train_aug.crop is None:
            self.train_aug.draw(1, 1)
            return
        crop = self.train_aug.crop_window(*self._frame_hw(dataset_dict))
        self.train_aug.draw(crop[2], crop[3])

    def _frame_hw(self, dataset_dict: Dict) -> Tuple[int, int]:
        """(H, W) of the frame an image's crop is drawn on, as the mapping
        reads it: the composed image on the CPU, the thermal file's decoded
        size on the card (a JPEG's header, any other file decoded)."""
        path = dataset_dict["file_name"]
        if self.device.type == "cpu":
            return read_image(path, self.cfg.input_format, device="cpu",
                              rgb_file=dataset_dict.get("rgb_file")).shape[:2]
        from ..native.io import JPEG_SOI, decode_host

        with open(path, "rb") as f:
            data = f.read()
        if data[:2] == JPEG_SOI:
            return self._codec().info(data)[:2]
        return tuple(decode_host(path).shape[:2])

    def _map_batch(self, dataset_dicts: Sequence[Dict]) -> List[Dict]:
        cfg = self.cfg
        annotations = [_annotations(d) for d in dataset_dicts]
        geoms = []  # per image: resized h, w, the boxes in its frame, flipped
        if self.device.type == "cpu":
            images, origs = [], []
            for d, (boxes, _) in zip(dataset_dicts, annotations):
                image = read_image(d["file_name"], cfg.input_format, device="cpu",
                                   rgb_file=d.get("rgb_file"))
                origs.append(image.shape[:2])
                if self.is_train:
                    image, boxes, flip = self.train_aug.apply(image, boxes)
                    new_h, new_w = image.shape[:2]
                else:
                    image, (new_h, new_w) = self.test_resize(image)
                    flip = False
                ph, pw = cfg.pad_shape
                if new_h > ph or new_w > pw:
                    raise ValueError(
                        f"resized image ({new_h}, {new_w}) exceeds pad_shape {cfg.pad_shape}"
                    )
                padded = np.zeros((ph, pw, image.shape[2]), np.float32)
                padded[:new_h, :new_w] = image
                images.append(torch.from_numpy(padded))
                geoms.append((new_h, new_w, boxes, flip))
        else:
            from ..native.io import load_batch

            paths = [d["file_name"] for d in dataset_dicts]
            rgb = ([d.get("rgb_file") or derive_rgb_path(d["file_name"]) for d in dataset_dicts]
                   if cfg.input_format != "BGR" else None)
            draws = []

            def size(h, w):
                if self.is_train:
                    crop = self.train_aug.crop_window(h, w)
                    draws.append(self.train_aug.draw(*(crop[2:] if crop else (h, w))) + (crop,))
                else:
                    draws.append(self.test_resize.size(h, w) + (False, None))
                return draws[-1]

            with torch.cuda.device(self.device):
                canvas, _, origs = load_batch(self._codec(), paths, rgb, cfg.input_format, size,
                                              tuple(cfg.pad_shape))
            images = list(canvas)
            for (boxes, _), orig, (new_h, new_w, flip, crop) in zip(annotations, origs, draws):
                if self.is_train:
                    frame = tuple(int(v) for v in orig)
                    if crop is not None:  # shifted unclipped, as random_crop does
                        y0, x0, frame = crop[0], crop[1], crop[2:]
                        boxes = boxes - np.array([x0, y0, x0, y0], boxes.dtype)
                    boxes = resize_boxes(boxes, frame, (new_h, new_w))
                    if flip:
                        boxes = hflip_boxes(boxes, new_w)
                geoms.append((new_h, new_w, boxes, flip))
        return [self._sample(d, img, geom, tuple(int(v) for v in orig), classes)
                for d, img, geom, orig, (_, classes) in zip(dataset_dicts, images, geoms, origs,
                                                             annotations)]

    def _sample(self, dataset_dict: Dict, image: torch.Tensor, geom, orig_hw,
                classes: np.ndarray) -> Dict:
        new_h, new_w, boxes, flip = geom
        orig_h, orig_w = orig_hw

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

        sample = {
            "image": image,
            "image_size": np.array([new_h, new_w], np.int32),
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "image_id": dataset_dict.get("image_id"),
            "orig_size": np.array([orig_h, orig_w], np.int32),
            "file_name": dataset_dict["file_name"],
        }
        if self.is_train:
            sample["flip"] = bool(flip)
        return sample
