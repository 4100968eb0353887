"""Primitive layers (counterpart of ``proben_tpu/models/layers.py``).

Feature maps are NCHW tensors in ``torch.channels_last`` memory, so C is the
contiguous axis as in the JAX package's NHWC arrays. Weights are OIHW (convs)
and (out, in) (linears), kept in f32; ``dtype`` selects the compute
precision. Every parameter, the folded-BN affines' included (the JAX package
trains them in every stage that is not frozen), is built with
``requires_grad=False``; training sets it from the trainable mask. The bf16 rounding points follow the JAX functions: a conv
outputs the compute dtype and its bias is added after, ``affine`` runs in
the input's dtype, ``linear`` accumulates in f32 and rounds once.

The ``init_*`` functions are the port's own random initialisation in the
JAX package's parameter layout (HWIO convs, (in, out) linears), with the
same distribution families; ``checkpoint.from_jax`` turns that layout into
module state.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# modules holding parameters
# ---------------------------------------------------------------------------


class Conv(nn.Module):
    """Holds an OIHW conv weight (channels_last memory) and optional bias."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True):
        super().__init__()
        w = torch.empty(cout, cin, k, k).contiguous(memory_format=torch.channels_last)
        self.weight = nn.Parameter(w, requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout), requires_grad=False) if bias else None


class Affine(nn.Module):
    """Folded FrozenBN: per-channel ``scale * x + bias``."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)


class Linear(nn.Module):
    """Holds an (out, in) weight and optional bias."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout), requires_grad=False) if bias else None


# ---------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------


def conv2d(
    x: Tensor,  # (N, Cin, H, W) channels_last
    weight: Tensor,  # (Cout, Cin, kh, kw)
    bias: Optional[Tensor] = None,
    stride: int = 1,
    padding: int = 0,
    dtype: Optional[torch.dtype] = None,
) -> Tensor:
    if dtype is not None:
        x = x.to(dtype)
        weight = weight.to(dtype)
    out = F.conv2d(x, weight, stride=stride, padding=padding)
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1)
    return out


def affine(x: Tensor, norm: Affine) -> Tensor:
    """Per-channel scale + bias in ``x``'s dtype (NCHW)."""
    scale = norm.scale.to(x.dtype).view(1, -1, 1, 1)
    bias = norm.bias.to(x.dtype).view(1, -1, 1, 1)
    return x * scale + bias


def linear(x: Tensor, lin: Linear) -> Tensor:
    """``x @ W^T`` accumulated in f32, rounded to ``x``'s dtype, then the
    bias added in that dtype."""
    out = torch.matmul(x, lin.weight.to(x.dtype).t())
    if lin.bias is not None:
        out = out + lin.bias.to(out.dtype)
    return out


def max_pool(x: Tensor, window: int, stride: int, padding: int = 0) -> Tensor:
    """Max pooling of an NCHW map, torch-style symmetric padding with -inf
    (JAX ``layers.max_pool``, NHWC there)."""
    return F.max_pool2d(x, window, stride, padding)


# ---------------------------------------------------------------------------
# random initialisation (JAX parameter layout, numpy)
# ---------------------------------------------------------------------------


def init_conv(
    rng: np.random.Generator, kh: int, kw: int, cin: int, cout: int,
    bias: bool = True, init_std: Optional[float] = None,
) -> Dict[str, np.ndarray]:
    """HWIO conv: MSRA fan-out normal (caffe2 msra fill) or N(0, init_std)."""
    std = math.sqrt(2.0 / (kh * kw * cout)) if init_std is None else init_std
    p = {"w": (rng.standard_normal((kh, kw, cin, cout)) * std).astype(np.float32)}
    if bias:
        p["b"] = np.zeros((cout,), np.float32)
    return p


def init_affine(cout: int) -> Dict[str, np.ndarray]:
    """Folded FrozenBN: identity until a checkpoint overwrites it."""
    return {"scale": np.ones((cout,), np.float32), "bias": np.zeros((cout,), np.float32)}


def fold_batchnorm(weight, bias, running_mean, running_var, eps=1e-5) -> Dict[str, np.ndarray]:
    """Fold BN statistics into (scale, bias) affine constants: computed in
    float64, then rounded once to float32, as the JAX package does."""
    weight = np.asarray(weight, np.float64)
    bias = np.asarray(bias, np.float64)
    mean = np.asarray(running_mean, np.float64)
    var = np.asarray(running_var, np.float64)
    scale = weight / np.sqrt(var + eps)
    return {"scale": scale.astype(np.float32), "bias": (bias - mean * scale).astype(np.float32)}


def init_linear(
    rng: np.random.Generator, cin: int, cout: int,
    init_std: Optional[float] = None, bias: bool = True,
) -> Dict[str, np.ndarray]:
    """(in, out) linear: caffe2 XavierFill uniform(-a, a), a = sqrt(3/fan_in),
    or N(0, init_std)."""
    if init_std is None:
        a = math.sqrt(3.0 / cin)
        w = rng.uniform(-a, a, (cin, cout))
    else:
        w = rng.standard_normal((cin, cout)) * init_std
    p = {"w": w.astype(np.float32)}
    if bias:
        p["b"] = np.zeros((cout,), np.float32)
    return p
