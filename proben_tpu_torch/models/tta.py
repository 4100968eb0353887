"""Test-time augmentation for detection (counterpart of
``proben_tpu/models/tta.py``; reference
``detectron2/modeling/test_time_augmentation.py:70`` GeneralizedRCNNWithTTA):
multi-scale + horizontal-flip inference, the detections mapped back to the
original frame and merged with class-batched NMS.

``rescore=True`` then re-runs the box head on the MERGED boxes in every
augmented frame (``Predictor.rescore_boxes``) and averages the class
probabilities (the reference's rerun-heads-on-given-boxes pathway,
``test_time_augmentation.py:180-220``).

All augmentations of an image run as one batch (JAX runs one batch per
augmentation; the per-image results are the same function). On the CPU the
augmented images are made as in JAX (cv2 resize, numpy flip and pad); on
the card the image's uint8 pixels go through one ``image_io`` launch that
resizes, flips and pads every augmentation.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..fusion.proben_numpy import _plain_batched_nms


class DetectionTTA:
    def __init__(
        self,
        predictor,  # engine.Predictor
        mapper_cfg,  # data.MapperConfig: pad_shape must fit the largest scale
        scales: Sequence[int] = (400, 500, 600, 700, 800),
        max_size: int = 1333,
        flip: bool = True,
        nms_thresh: float = 0.5,
        topk: int = 100,
        rescore: bool = False,
    ):
        self.predictor = predictor
        self.mapper_cfg = mapper_cfg
        self.scales = scales
        self.max_size = max_size
        self.flip = flip
        self.nms_thresh = nms_thresh
        self.topk = topk
        self.rescore = rescore

    def _augmentations(self, h: int, w: int) -> List[Tuple[int, int, bool]]:
        """(nh, nw, flipped) per augmentation, in JAX's order."""
        from ..data.transforms import TestResize

        return [(*TestResize(short, self.max_size).size(h, w), flipped)
                for short in self.scales for flipped in ((False, True) if self.flip else (False,))]

    def _batch(self, image, augs) -> torch.Tensor:
        """The augmented images (A, PH, PW, C) float32 on the predictor's
        device."""
        ph, pw = self.mapper_cfg.pad_shape
        dev = self.predictor.device
        if dev.type == "cuda":
            from ..native import io

            img = torch.as_tensor(image).to(dev)
            if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] not in (1, 3):
                raise ValueError("on the card DetectionTTA takes a decoded (H, W, 1 or 3) uint8 "
                                 f"image, got {tuple(img.shape)} {img.dtype}")
            return io.compose_resize_pad([img.contiguous()] * len(augs), None, "BGR",
                                         [(nh, nw) for nh, nw, _ in augs], (ph, pw),
                                         [f for _, _, f in augs])
        from ..data.transforms import hflip_image, resize_image

        image = np.asarray(image)
        out = np.zeros((len(augs), ph, pw, image.shape[2]), np.float32)
        for i, (nh, nw, flipped) in enumerate(augs):
            resized = resize_image(image, nh, nw)
            out[i, :nh, :nw] = hflip_image(resized) if flipped else resized
        return torch.from_numpy(out)

    def _rescore_merged(self, images: torch.Tensor, augs, hw, boxes: np.ndarray,
                        classes: np.ndarray) -> np.ndarray:
        """The box head's probability of each merged box's class, averaged
        over the augmented frames (the boxes mapped into each frame as the
        reference's ``_rescale_detected_boxes`` does)."""
        h, w = hw
        k = len(boxes)
        given = np.zeros((len(augs), self.topk, 4), np.float32)  # a static topk rows
        for i, (nh, nw, flipped) in enumerate(augs):
            b = boxes * np.array([nw / w, nh / h, nw / w, nh / h], np.float32)
            if flipped:
                x1 = b[:, 0].copy()
                b[:, 0] = nw - b[:, 2]
                b[:, 2] = nw - x1
            given[i, :k] = b[:self.topk]
        probs, _, _ = self.predictor.rescore_boxes(images, given)
        mean = probs.cpu().numpy()[:, :k].mean(0)
        return mean[np.arange(k), classes].astype(np.float32)

    def __call__(self, image) -> Dict[str, np.ndarray]:
        """image: HWC raw (0..255; uint8 on the card). Returns the merged
        boxes, scores and classes in the original frame."""
        h, w = image.shape[:2]
        augs = self._augmentations(h, w)
        images = self._batch(image, augs)
        recs = self.predictor.predict_batch({
            "image": images, "image_size": np.array([a[:2] for a in augs], np.int32),
            "orig_size": np.array([[h, w]] * len(augs), np.int32),
            "image_id": [0] * len(augs), "num_real": len(augs),
        })
        all_boxes, all_scores, all_classes = [], [], []
        for rec, (_, _, flipped) in zip(recs, augs):
            boxes = rec["boxes"]
            if flipped and len(boxes):
                boxes = boxes.copy()
                x1 = boxes[:, 0].copy()
                boxes[:, 0] = w - boxes[:, 2]
                boxes[:, 2] = w - x1
            all_boxes.append(boxes)
            all_scores.append(rec["scores"])
            all_classes.append(rec["classes"])
        boxes = np.concatenate(all_boxes).reshape(-1, 4)
        scores = np.concatenate(all_scores)
        classes = np.concatenate(all_classes).astype(np.int64)
        if len(boxes) == 0:
            return {"boxes": boxes, "scores": scores, "classes": classes}
        keep = _plain_batched_nms(boxes.astype(np.float64), scores, classes, self.nms_thresh)
        keep = keep[: self.topk]
        boxes, scores, classes = boxes[keep].astype(np.float32), scores[keep], classes[keep]
        if self.rescore and len(boxes):
            scores = self._rescore_merged(images, augs, (h, w), boxes, classes)
            order = np.argsort(-scores, kind="stable")
            boxes, scores, classes = boxes[order], scores[order], classes[order]
        return {"boxes": boxes, "scores": scores, "classes": classes}
