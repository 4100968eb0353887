"""Box head (FastRCNNConvFCHead) and output layers (counterpart of
``proben_tpu/models/box_head.py``): pooled (..., P, P, C) features -> FCs ->
class logits (..., C+1), box deltas (..., C*4) and, with the uncertainty
head, per-RoI variance exp(var_pred(x)) (..., 1).

Pooled features keep the JAX (P, P, C) flatten order, so fc1's weight is the
JAX (in, out) matrix transposed, with no permutation.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .layers import Linear, init_linear, linear


class BoxHead(nn.Module):
    def __init__(self, in_channels: int = 256, pooler_resolution: int = 7,
                 fc_dim: int = 1024, num_fc: int = 2):
        super().__init__()
        dims = [in_channels * pooler_resolution ** 2] + [fc_dim] * num_fc
        self.fcs = nn.ModuleList(Linear(dims[i], dims[i + 1]) for i in range(num_fc))


class OutputLayers(nn.Module):
    def __init__(self, in_dim: int = 1024, num_classes: int = 3, enable_variance: bool = False,
                 cls_agnostic_bbox_reg: bool = False):
        super().__init__()
        self.cls_score = Linear(in_dim, num_classes + 1)
        self.bbox_pred = Linear(in_dim, 4 if cls_agnostic_bbox_reg else num_classes * 4)
        self.var_pred = Linear(in_dim, 1) if enable_variance else None


def init_box_head(rng: np.random.Generator, in_channels: int = 256, pooler_resolution: int = 7,
                  fc_dim: int = 1024, num_fc: int = 2) -> Dict:
    in_dim = in_channels * pooler_resolution * pooler_resolution
    fcs = []
    for _ in range(num_fc):
        fcs.append(init_linear(rng, in_dim, fc_dim))  # XavierFill
        in_dim = fc_dim
    return {"fcs": fcs}


def init_output_layers(rng: np.random.Generator, in_dim: int = 1024, num_classes: int = 3,
                       enable_variance: bool = False, cls_agnostic_bbox_reg: bool = False) -> Dict:
    """``bbox_pred`` has 4 outputs with ``cls_agnostic_bbox_reg`` (one box per
    RoI, as Cascade's stages regress), else 4 per class."""
    num_bbox_reg = 1 if cls_agnostic_bbox_reg else num_classes
    p = {
        "cls_score": init_linear(rng, in_dim, num_classes + 1, init_std=0.01),
        "bbox_pred": init_linear(rng, in_dim, num_bbox_reg * 4, init_std=0.001),
    }
    if enable_variance:
        p["var_pred"] = init_linear(rng, in_dim, 1, init_std=0.01)
    return p


def apply_box_head(head: BoxHead, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """(..., P, P, C) -> (..., fc_dim) f32."""
    h = x.reshape(x.shape[:-3] + (-1,))
    if dtype is not None:
        h = h.to(dtype)
    for fc in head.fcs:
        h = torch.relu(linear(h, fc))
    return h.float()


def apply_output_layers(
    out: OutputLayers, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(..., fc_dim) -> (logits (..., C+1), deltas (..., C*4) or (..., 4)
    class-agnostic, variance (..., 1) | None)."""
    scores = linear(x, out.cls_score)
    deltas = linear(x, out.bbox_pred)
    variance = None
    if out.var_pred is not None:
        # clamp the log-variance logit: guards exp overflow at random init
        variance = torch.exp(linear(x, out.var_pred).clamp(-25.0, 25.0))
    return scores, deltas, variance
