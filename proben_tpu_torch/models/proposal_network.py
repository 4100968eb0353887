"""ProposalNetwork meta-architecture: backbone + FPN + RPN only (counterpart
of ``proben_tpu/models/proposal_network.py``; reference
``detectron2/modeling/meta_arch/rcnn.py:306``). It runs on an ``RCNN``
model, whose RoI heads it leaves unused; the stem is kernel K1 on the card
in bf16."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.sampling import Draws
from ..structures.detections import GroundTruth
from .rcnn import RCNN, ModelConfig, anchors_for, extract_features, preprocess, propose, rpn_outputs
from .rpn import rpn_losses


@torch.inference_mode()
def proposal_network_inference(
    model: RCNN, cfg: ModelConfig, images: torch.Tensor, image_sizes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(boxes (N, P, 4), objectness (N, P), valid (N, P)), P the test-time
    post-NMS top-k."""
    return propose(model, cfg, extract_features(model, cfg, preprocess(cfg, images)), image_sizes)


def proposal_network_losses(
    model: RCNN, cfg: ModelConfig, images: torch.Tensor, image_sizes: torch.Tensor,
    gt: GroundTruth, generator: Draws,
) -> Dict[str, torch.Tensor]:
    """The RPN's losses (``loss_rpn_cls``, ``loss_rpn_loc``), each the mean
    over images, the anchors sampled with ``generator``."""
    features = extract_features(model, cfg, preprocess(cfg, images), training=True)
    logits, deltas = rpn_outputs(model, cfg, features)
    losses = rpn_losses(logits, deltas, anchors_for(features), gt.boxes, gt.valid, generator,
                        cfg.rpn)
    return {k: v.mean() for k, v in losses.items()}
