"""ResNet-50/101/152 backbone with folded FrozenBN (counterpart of
``proben_tpu/models/resnet.py``): caffe-style bottleneck with the stride in
the 1x1 conv, stem = 7x7/2 conv + affine + ReLU + 3x3/2 max-pool, the stem's
input channels from the config (4 for BGRT early fusion).

Feature maps are NCHW in channels_last memory. The stem runs kernel K1
(``ops/stem_cuda.py``) when the compute dtype is bf16 and the shape passes
its gate, as ``apply_resnet`` does with the Pallas stem; otherwise the plain
composition. Each bottleneck ends its three convs in the fused epilogue
``ops/epilogue_cuda.py::block_epilogue`` (affine, the residual, ReLU): kernel
K4 for the card's bf16 channels_last maps, the same composition elsewhere.
For training, ``freeze_at`` runs the frozen sections under
``torch.no_grad()`` (JAX: ``stop_gradient``) and ``freeze_mask`` names the
parameters the optimizer leaves alone; ``remat`` recomputes each trainable
residual block in the backward (``torch.utils.checkpoint``, JAX
``jax.checkpoint``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.epilogue_cuda import block_epilogue
from ..ops.stem_cuda import stem_pool, stem_supported
from .layers import Affine, Conv, affine, conv2d, init_affine, init_conv

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
STAGE_NAMES = ("res2", "res3", "res4", "res5")
STAGE_OUT_CHANNELS = (256, 512, 1024, 2048)


class Stem(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.conv1 = Conv(in_channels, 64, 7, bias=False)
        self.norm1 = Affine(64)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, cout: int, shortcut: bool):
        super().__init__()
        self.conv1 = Conv(cin, width, 1, bias=False)
        self.norm1 = Affine(width)
        self.conv2 = Conv(width, width, 3, bias=False)
        self.norm2 = Affine(width)
        self.conv3 = Conv(width, cout, 1, bias=False)
        self.norm3 = Affine(cout)
        if shortcut:
            self.shortcut = Conv(cin, cout, 1, bias=False)
            self.shortcut_norm = Affine(cout)
        else:
            self.shortcut = None


class ResNet(nn.Module):
    """Parameter holder; module names mirror ``init_resnet``'s pytree keys."""

    def __init__(self, depth: int = 50, in_channels: int = 3):
        super().__init__()
        if depth not in STAGE_BLOCKS:
            raise ValueError(f"only bottleneck ResNets supported, got depth={depth}")
        self.stem = Stem(in_channels)
        in_ch, width = 64, 64
        for name, n_blocks, out_ch in zip(STAGE_NAMES, STAGE_BLOCKS[depth], STAGE_OUT_CHANNELS):
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(in_ch, width, out_ch, shortcut=b == 0))
                in_ch = out_ch
            setattr(self, name, nn.ModuleList(blocks))
            width *= 2


def init_resnet(rng: np.random.Generator, depth: int = 50, in_channels: int = 3) -> Dict:
    """Random-init params in ``proben_tpu``'s pytree layout; norm3 starts at
    zero gamma so residual branches start as identity."""
    params: Dict = {
        "stem": {
            "conv1": init_conv(rng, 7, 7, in_channels, 64, bias=False),
            "norm1": init_affine(64),
        }
    }
    in_ch, width = 64, 64
    for name, n_blocks, out_ch in zip(STAGE_NAMES, STAGE_BLOCKS[depth], STAGE_OUT_CHANNELS):
        blocks = []
        for b in range(n_blocks):
            block = {
                "conv1": init_conv(rng, 1, 1, in_ch, width, bias=False),
                "norm1": init_affine(width),
                "conv2": init_conv(rng, 3, 3, width, width, bias=False),
                "norm2": init_affine(width),
                "conv3": init_conv(rng, 1, 1, width, out_ch, bias=False),
                "norm3": {
                    "scale": np.zeros((out_ch,), np.float32),
                    "bias": np.zeros((out_ch,), np.float32),
                },
            }
            if b == 0:
                block["shortcut"] = init_conv(rng, 1, 1, in_ch, out_ch, bias=False)
                block["shortcut_norm"] = init_affine(out_ch)
            blocks.append(block)
            in_ch = out_ch
        params[name] = blocks
        width *= 2
    return params


def _bottleneck(block: Bottleneck, x: torch.Tensor, stride: int, dtype=None) -> torch.Tensor:
    """Caffe-style bottleneck: stride in conv1 (1x1); each conv's affine,
    the residual add and the ReLUs in ``block_epilogue``."""
    n1, n2, n3 = block.norm1, block.norm2, block.norm3
    out = conv2d(x, block.conv1.weight, None, stride, 0, dtype)
    out = block_epilogue(out, n1.scale, n1.bias)
    out = conv2d(out, block.conv2.weight, None, 1, 1, dtype)
    out = block_epilogue(out, n2.scale, n2.bias)
    out = conv2d(out, block.conv3.weight, None, 1, 0, dtype)
    if block.shortcut is None:
        return block_epilogue(out, n3.scale, n3.bias, x)
    sc = conv2d(x, block.shortcut.weight, None, stride, 0, dtype)
    return block_epilogue(out, n3.scale, n3.bias, sc, block.shortcut_norm.scale,
                          block.shortcut_norm.bias)


def apply_stem(stem: Stem, x: torch.Tensor, dtype=None, stem_impl: str = "kernel") -> torch.Tensor:
    """(N, C, H, W) normalized input -> pooled (N, 64, H/4, W/4)."""
    conv1, norm1 = stem.conv1, stem.norm1
    o, c, kh, kw = conv1.weight.shape
    if stem_impl == "kernel" and stem_supported(c, o, kh, kw, dtype):
        h = stem_pool(
            x.permute(0, 2, 3, 1).to(dtype).contiguous(),
            conv1.weight.permute(2, 3, 1, 0).to(dtype).contiguous(),
            norm1.scale.to(dtype),
            norm1.bias.to(dtype),
        )
        return h.permute(0, 3, 1, 2)  # NCHW view of the NHWC result
    if stem_impl not in ("kernel", "plain"):
        raise ValueError(f"unknown stem_impl {stem_impl!r}")
    h = conv2d(x, conv1.weight, None, 2, 3, dtype)
    h = torch.relu(affine(h, norm1))
    return F.max_pool2d(h, 3, 2, 1)


def _frozen(frozen: bool):
    return torch.no_grad() if frozen else contextlib.nullcontext()


def apply_resnet(
    backbone: ResNet,
    x: torch.Tensor,  # (N, C, H, W) channels_last, normalized
    dtype=None,
    stem_impl: str = "kernel",
    freeze_at: int = 0,
    out_features: Sequence[str] = STAGE_NAMES,
    remat: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run the backbone up to the last stage of ``out_features`` and return
    those stages' maps. ``freeze_at`` follows the reference (1 freezes the
    stem, 2 also res2, ...): frozen sections run under ``torch.no_grad()``,
    so the backward never enters them. ``remat`` keeps only each block's
    input for the backward and recomputes the block there (memory for large
    training batches; the values are the same)."""
    out: Dict[str, torch.Tensor] = {}
    last = max(STAGE_NAMES.index(f) for f in out_features)
    with _frozen(freeze_at >= 1):
        h = apply_stem(backbone.stem, x, dtype, stem_impl)
    for i, name in enumerate(STAGE_NAMES[:last + 1]):
        with _frozen(freeze_at >= i + 2):
            for b, block in enumerate(getattr(backbone, name)):
                stride = 2 if b == 0 and i > 0 else 1
                if remat and torch.is_grad_enabled():
                    h = torch.utils.checkpoint.checkpoint(_bottleneck, block, h, stride, dtype,
                                                          use_reentrant=False)
                else:
                    h = _bottleneck(block, h, stride, dtype)
        if name in out_features:
            out[name] = h
    return out


def freeze_mask(backbone: ResNet, freeze_at: int) -> Dict[str, bool]:
    """Trainable flag per backbone parameter name (``freeze_at`` as in
    ``apply_resnet``)."""
    first_trainable = {"stem": 1, **{name: i + 2 for i, name in enumerate(STAGE_NAMES)}}
    return {name: freeze_at < first_trainable[name.split(".")[0]]
            for name, _ in backbone.named_parameters()}
