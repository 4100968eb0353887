"""Feature Pyramid Network (counterpart of ``proben_tpu/models/fpn.py``):
lateral 1x1 convs, top-down nearest 2x upsample, output 3x3 convs, and the
``LastLevelMaxPool`` p6 (a stride-2 subsample of p5). Maps are NCHW in
channels_last memory."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, conv2d, init_conv

FPN_STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048), out_channels: int = 256):
        super().__init__()
        self.lateral = nn.ModuleList(Conv(c, out_channels, 1) for c in in_channels)
        self.output = nn.ModuleList(Conv(out_channels, out_channels, 3) for _ in in_channels)


def init_fpn(rng: np.random.Generator, in_channels: Sequence[int] = (256, 512, 1024, 2048),
             out_channels: int = 256) -> Dict:
    return {
        "lateral": [init_conv(rng, 1, 1, c, out_channels, bias=True) for c in in_channels],
        "output": [init_conv(rng, 3, 3, out_channels, out_channels, bias=True) for _ in in_channels],
    }


def apply_fpn(
    fpn: FPN,
    bottom_up: Dict[str, torch.Tensor],
    in_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
    top_block_maxpool: bool = True,
    dtype=None,
) -> Dict[str, torch.Tensor]:
    """The ``in_features`` maps -> {"p2": ..., "p{n+1}": ...} (named from p2
    whatever the inputs, as in JAX), plus ``p{n+2}`` = the max-pool top
    block when ``top_block_maxpool``: res2..res5 give p2..p6."""
    feats = [bottom_up[f] for f in in_features]
    n = len(feats)
    laterals = [conv2d(f, fpn.lateral[i].weight, fpn.lateral[i].bias, 1, 0, dtype)
                for i, f in enumerate(feats)]
    merged = [None] * n
    merged[n - 1] = laterals[n - 1]
    for i in range(n - 2, -1, -1):
        up = F.interpolate(merged[i + 1], scale_factor=2, mode="nearest")
        # crop in case the lower level has odd size
        th, tw = laterals[i].shape[-2:]
        merged[i] = laterals[i] + up[:, :, :th, :tw]
    out = {
        f"p{i + 2}": conv2d(merged[i], fpn.output[i].weight, fpn.output[i].bias, 1, 1, dtype)
        for i in range(n)
    }
    if top_block_maxpool:
        # LastLevelMaxPool: a 1x1 max-pool with stride 2 is a subsample
        out[f"p{n + 2}"] = out[f"p{n + 1}"][:, :, ::2, ::2].contiguous(
            memory_format=torch.channels_last)
    return out
