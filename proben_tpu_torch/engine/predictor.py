"""Batched inference with the rescale to original frames on the device
(counterpart of ``proben_tpu/engine/predictor.py``)."""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.rcnn import ModelConfig, RCNN, rcnn_inference, rcnn_inference_given_boxes
from ..structures.boxes import clip_boxes
from ..structures.detections import Detections
from ..utils import tracing


class Predictor:
    """Runs ``rcnn_inference`` on ``device`` (default CUDA; raises without a
    GPU) and returns per-image numpy results in the original image frame."""

    def __init__(self, model: RCNN, model_cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model_cfg

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(self.device)

    @torch.inference_mode()
    def infer(self, images, image_sizes, orig_sizes) -> Detections:
        """Batched detections on the device, boxes rescaled from the
        (resized) model-input frame to the original frame and clipped."""
        images, image_sizes, orig_sizes = map(self._tensor, (images, image_sizes, orig_sizes))
        det = rcnn_inference(self.model, self.cfg, images, image_sizes)
        in_hw = image_sizes.to(torch.float32)
        out_hw = orig_sizes.to(torch.float32)
        sx = out_hw[:, 1] / in_hw[:, 1]
        sy = out_hw[:, 0] / in_hw[:, 0]
        boxes = det.boxes * torch.stack([sx, sy, sx, sy], -1)[:, None, :]
        det.boxes = clip_boxes(boxes, (out_hw[:, None, 0], out_hw[:, None, 1]))
        return det

    def rescore_boxes(self, images, boxes):
        """Box-head scores of GIVEN boxes (N, K, 4) in the model-input frame
        of raw (N, H, W, C) images (the reference's
        ``GeneralizedRCNN.inference(..., detected_instances)``): (probs
        (N, K, C+1) with the background last, class logits (N, K, C+1),
        variance (N, K, 1) or None), on the device."""
        return rcnn_inference_given_boxes(self.model, self.cfg, self._tensor(images),
                                          self._tensor(boxes))

    def predict_batch(self, batch: Dict) -> List[Dict[str, np.ndarray]]:
        """``batch`` as the data loaders build it: "image" (N, H, W, C) raw,
        "image_size" and "orig_size" (N, 2), "image_id", optional "num_real".
        Returns per-image dicts of numpy arrays trimmed to valid detections."""
        with tracing.span("predictor.predict_batch"):
            det = self.infer(batch["image"], batch["image_size"], batch["orig_size"])
            with tracing.span("predictor.to_host"):
                return _trim(det.to_numpy(), batch)


def _trim(det: Detections, batch: Dict) -> List[Dict[str, np.ndarray]]:
    """Per-image dicts of numpy detections, trimmed to the valid ones."""
    out = []
    for i in range(batch.get("num_real", det.boxes.shape[0])):
        m = det.valid[i]
        rec = {
            "boxes": det.boxes[i][m],
            "scores": det.scores[i][m],
            "classes": det.classes[i][m],
            "image_id": batch["image_id"][i],
        }
        if det.probs is not None:
            rec["probs"] = det.probs[i][m]
        if det.class_logits is not None:
            rec["class_logits"] = det.class_logits[i][m]
        if det.variance is not None:
            rec["vars"] = det.variance[i][m]
        out.append(rec)
    return out
