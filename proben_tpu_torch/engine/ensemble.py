"""ProbEn late fusion as one predictor: several detectors on one batch of
multi-channel frames, each on its own channels, fused on the device (the
reference's ``demo_FLIR_save_predictions.py:53-76`` for every member, then
``demo_probEn.py:92-196``, in one pass with no file between them).

The paper's best FLIR ensemble, ProbEn3, is thermal-only on TTT (channels
3:6 of a BGRTTT frame), BGRT early fusion (0:4) and BGRTTT middle fusion
(0:6), each with the variance head, fused with ``probEn`` scores and
``v-avg`` boxes at IoU 0.5::

    pred = ProbEnPredictor.from_cfgs([(build_flir_cfg("thermal_only"), p_t, (3, 6)),
                                      (build_flir_cfg("early_fusion"), p_e, (0, 4)),
                                      (build_flir_cfg("middle_fusion"), p_m, (0, 6))])
    results = inference_on_dataset(pred, loader_of_bgrttt_frames, FLIREvaluator(json_path))

Each member's ``Predictor.infer`` runs in turn on the same stream (the span
``ensemble.member``); the members' padded detections are concatenated along
the slot axis and fused by one ``fuse_detections_torch`` call for the whole
batch. No host read is added between members beyond those each member
makes itself; ``predict_batch`` copies the fused detections to the host once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import CfgNode, model_config_from_cfg
from ..fusion.proben_torch import fuse_detections_torch
from ..models.rcnn import RCNN, build_model
from ..structures.detections import Detections
from ..utils import tracing
from .predictor import Predictor, _trim

Channels = Tuple[int, int]


class ProbEnPredictor:
    """Members ``(Predictor, (start, stop))`` on channels ``start:stop`` of
    one batch, fused with ``score_method`` and ``box_method`` at IoU
    ``thresh``; ``class_offset`` is the original frame's (width, height)
    (640 x 512 on FLIR), so that boxes of different classes never cluster;
    at most ``topk`` fused detections an image. The contract of
    ``Predictor``: ``infer`` on the device, ``predict_batch`` to numpy."""

    def __init__(self, members: Sequence[Tuple[Predictor, Channels]], score_method: str = "probEn",
                 box_method: str = "v-avg", thresh: float = 0.5,
                 class_offset: Tuple[float, float] = (640.0, 512.0), topk: int = 100):
        if len(members) < 2:
            raise ValueError(f"an ensemble needs at least two members, got {len(members)}")
        for i, (pred, (start, stop)) in enumerate(members):
            if stop - start != pred.cfg.num_in_channels:
                raise ValueError(f"member {i} ({pred.cfg.input_format}) takes {pred.cfg.num_in_channels} "
                                 f"channels, given {start}:{stop}")
            if box_method == "v-avg" and not pred.cfg.enable_gaussian_nll:
                raise ValueError(f"member {i} has no variance head: 'v-avg' needs ENABLE_GAUSSIANNLLOSS")
        devices = {pred.device for pred, _ in members}
        if len(devices) != 1:
            raise ValueError(f"members on more than one device: {sorted(map(str, devices))}")
        self.members = [(pred, (int(start), int(stop))) for pred, (start, stop) in members]
        self.device = devices.pop()
        self.score_method, self.box_method, self.thresh = score_method, box_method, float(thresh)
        self.class_offset = (float(class_offset[0]), float(class_offset[1]))
        self.topk = int(topk)

    @classmethod
    def from_cfgs(cls, members: Sequence[Tuple[CfgNode, object, Channels]],
                  device: Union[str, torch.device] = "cuda", **fusion) -> "ProbEnPredictor":
        """Members from ``(cfg, params, (start, stop))``: ``params`` a numpy
        pytree in ``proben_tpu``'s layout (``apps/flir.py::load_params``) or
        a built ``RCNN``, used as it is; ``fusion`` the keyword arguments of
        the constructor."""
        built = []
        for cfg, params, channels in members:
            mcfg = model_config_from_cfg(cfg)
            model = params if isinstance(params, RCNN) else build_model(mcfg, params=params, device=device)
            built.append((Predictor(model, mcfg, device), channels))
        return cls(built, **fusion)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(self.device)

    @torch.inference_mode()
    def member_detections(self, images, image_sizes, orig_sizes) -> List[Detections]:
        """Each member's padded detections of its channels of ``images``
        (N, H, W, C), in the original frame, on the device."""
        images, image_sizes, orig_sizes = map(self._tensor, (images, image_sizes, orig_sizes))
        out = []
        for pred, (start, stop) in self.members:
            with tracing.span("ensemble.member"):
                out.append(pred.infer(images[..., start:stop], image_sizes, orig_sizes))
        return out

    @torch.inference_mode()
    def fuse(self, dets: Sequence[Detections]) -> Detections:
        """One ``fuse_detections_torch`` call over the members' detections
        concatenated along the slot axis: (N, sum of slots, ...)."""
        def cat(field):
            return torch.cat([getattr(d, field) for d in dets], dim=1)

        variance = cat("variance") if all(d.variance is not None for d in dets) else None
        boxes, scores, classes, valid = fuse_detections_torch(
            cat("boxes"), cat("scores"), cat("classes"), cat("probs"), variance, cat("valid"),
            score_method=self.score_method, box_method=self.box_method, thresh=self.thresh,
            class_offset=self.class_offset, topk=self.topk)
        return Detections(boxes=boxes, scores=scores, classes=classes, valid=valid)

    def infer(self, images, image_sizes, orig_sizes) -> Detections:
        """The fused detections of the batch, in the original frame, on the
        device: (N, topk, ...), best cluster head first."""
        return self.fuse(self.member_detections(images, image_sizes, orig_sizes))

    def predict_batch(self, batch: Dict) -> List[Dict[str, np.ndarray]]:
        """``Predictor.predict_batch`` of the fused detections: per-image
        numpy "boxes", "scores", "classes", "image_id", trimmed to the valid
        ones."""
        with tracing.span("predictor.predict_batch"):
            det = self.infer(batch["image"], batch["image_size"], batch["orig_size"])
            with tracing.span("predictor.to_host"):
                return _trim(det.to_numpy(), batch)
