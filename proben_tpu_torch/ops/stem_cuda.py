"""Fused ResNet stem: kernel K1 (``csrc/stem.cu``) and its plain version.

Counterpart of ``proben_tpu/ops/stem_pallas.py::stem_pool_pallas``: the
BasicStem (7x7/s2/pad-3 conv -> folded-BN affine -> ReLU -> 3x3/s2/pad-1
max-pool) in one pass, writing only the pooled tensor. ``stem_pool`` launches
the kernel on CUDA tensors and runs ``stem_pool_plain`` only on CPU tensors.
``StemPool`` makes it differentiable as ``stem_pool_pallas``'s custom VJP
does: the forward is the kernel, the backward recomputes through the plain
composition (the TPU kernel has no backward kernel either).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

# launches of the CUDA kernel (never of the plain version)
launches = 0

_SIG = {
    "stem_pool_bf16": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}


def stem_supported(c: int, o: int, kh: int, kw: int, dtype) -> bool:
    """Shapes the kernel takes: any H, W; C_in <= 8, 64 outputs, 7x7, bf16.
    (No narrower than ``proben_tpu``'s ``stem_supported``.)"""
    return c <= 8 and o == 64 and (kh, kw) == (7, 7) and dtype == torch.bfloat16


def stem_out_hw(h: int, w: int):
    """Pooled (H, W) after the stride-2 conv and the stride-2 pool."""
    hs, ws = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (hs - 1) // 2 + 1, (ws - 1) // 2 + 1


def stem_pool_plain(
    x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain version of K1 with the same arguments and rounding points:
    conv in ``x``'s dtype (f32 accumulation), affine in that dtype, ReLU,
    max-pool. x (N, H, W, C) NHWC; w (7, 7, C, 64) HWIO; scale, bias (64,) in
    x's dtype. Returns (N, Hp, Wp, 64) NHWC."""
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1)
    h = F.conv2d(xc, wc, stride=2, padding=3)
    h = h * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    h = F.max_pool2d(torch.relu(h), 3, 2, 1)
    return h.permute(0, 2, 3, 1).contiguous()


def stem_pool(
    x: torch.Tensor,  # (N, H, W, C) bf16, contiguous
    w: torch.Tensor,  # (7, 7, C, 64) bf16, contiguous HWIO
    scale: torch.Tensor,  # (64,) bf16
    bias: torch.Tensor,  # (64,) bf16 (with any conv bias folded in)
) -> torch.Tensor:
    """Fused stem; (N, Hp, Wp, 64) bf16 NHWC. Launches K1 for CUDA tensors,
    runs the plain version for CPU tensors, raises on anything else."""
    if x.device.type == "cpu":
        return stem_pool_plain(x, w, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"stem_pool: unsupported device {x.device}")
    n, h, wd, c = x.shape
    if w.shape != (7, 7, c, 64) or scale.shape != (64,) or bias.shape != (64,):
        raise ValueError(f"stem_pool: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"stem_pool: {name} must be a contiguous bf16 tensor on {x.device}")
    if c > 8:
        raise ValueError(f"stem_pool: C_in={c} > 8")
    hs, ws = (h - 1) // 2 + 1, (wd - 1) // 2 + 1
    hp, wp = stem_out_hw(h, wd)
    out = torch.empty((n, hp, wp, 64), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("stem", _SIG)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stem_pool_bf16(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n, h, wd, c, hs, ws, hp, wp, stream,
        )
    _build.check(code, "stem_pool")
    global launches
    launches += 1
    return out


class StemPool(torch.autograd.Function):
    """``stem_pool`` with a gradient: K1 forward; the backward recomputes
    ``stem_pool_plain`` on the saved inputs and differentiates it. Only a
    trainable stem (``freeze_at == 0``) reaches the backward."""

    @staticmethod
    def forward(ctx, x, w, scale, bias):
        ctx.save_for_backward(x, w, scale, bias)
        return stem_pool(x, w, scale, bias)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = stem_pool_plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)
