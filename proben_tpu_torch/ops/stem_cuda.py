"""Fused ResNet stem: kernel K1 (``csrc/stem.cu``) and its plain version.

Counterpart of ``proben_tpu/ops/stem_pallas.py::stem_pool_pallas``: the
BasicStem (7x7/s2/pad-3 conv -> folded-BN affine -> ReLU -> 3x3/s2/pad-1
max-pool) in one pass, writing only the pooled tensor. ``stem_pool`` launches
the kernel on CUDA tensors and runs ``stem_pool_plain`` only on CPU tensors.
The kernel computes the conv as an implicit GEMM on the tensor cores over a
space-to-depth regrouping; ``space_to_depth_input``, ``pack_stem_weights``
and ``stem_conv_s2d`` build its operands and compute the conv from them on
any device, so the index mapping is testable without a card.
``stem_pool`` is the ``torch.library`` custom op ``proben::stem_pool``:
its CPU implementation is the plain version, its CUDA implementation the
kernel, its fake gives the output's shape (so ``torch.export`` traces
through it) and its flop formula ``stem_flops`` (``utils.analysis.
flop_count``). Its registered backward is ``stem_pool_pallas``'s custom
VJP: it recomputes the plain composition and differentiates it (the TPU
kernel has no backward kernel either).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from .. import _build
from ..utils import tracing

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


def stem_cp(c: int) -> int:
    """Channels per 2x2 sub-pixel in the kernel's space-to-depth layout."""
    return 4 if c <= 4 else 8


def pack_stem_weights(w: torch.Tensor) -> torch.Tensor:
    """K1's B operand: (7, 7, C, 64) HWIO -> (64, 16 * 4 * CP) rows,
    ``w'[o, a, b, dy, dx, c] = w[2a+dy-1, 2b+dx-1, c, o]``, zero where an
    index is -1 or c >= C. The 7x7 kernel gets one zero tap in front of each
    axis, and ky' = 2a + dy, kx' = 2b + dx split it into 4x4 taps of 2x2
    sub-pixels."""
    c = w.shape[2]
    cp = stem_cp(c)
    wp = F.pad(w, (0, 0, 0, cp - c, 1, 0, 1, 0))  # (8, 8, CP, 64)
    wp = wp.reshape(4, 2, 4, 2, cp, 64)  # a, dy, b, dx, c, o
    return wp.permute(5, 0, 2, 1, 3, 4).reshape(64, 16 * 4 * cp).contiguous()


def space_to_depth_input(x: torch.Tensor) -> torch.Tensor:
    """K1's A operand: (N, H, W, C) -> X' (N, Hs + 3, Ws + 3, 4 * CP),
    ``X'[u, v, (dy, dx, c)] = x[2u+dy-4, 2v+dx-4, c]`` (zero outside). The
    kernel builds the same layout tile by tile in shared memory."""
    n, h, w, c = x.shape
    cp = stem_cp(c)
    hs, ws = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x, (0, cp - c, 4, 2 * ws + 2 - w, 4, 2 * hs + 2 - h))  # 2(Hs+3) x 2(Ws+3)
    xp = xp.reshape(n, hs + 3, 2, ws + 3, 2, cp)
    return xp.permute(0, 1, 3, 2, 4, 5).reshape(n, hs + 3, ws + 3, 4 * cp)


def stem_conv_s2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 7x7/s2/pad-3 conv computed from K1's operands, as the kernel's
    GEMM does: a 4x4 stride-1 valid conv of ``space_to_depth_input(x)``
    with ``pack_stem_weights(w)``. (N, H, W, C) x (7, 7, C, 64) -> (N, Hs,
    Ws, 64) NHWC, in x's dtype."""
    cp = stem_cp(x.shape[-1])
    xs = space_to_depth_input(x).permute(0, 3, 1, 2)
    wp = pack_stem_weights(w).reshape(64, 4, 4, 4 * cp).permute(0, 3, 1, 2)
    return F.conv2d(xs, wp).permute(0, 2, 3, 1)


def stem_flops(n: int, h: int, w: int, c: int) -> int:
    """The stem's work by ``utils.analysis.flop_count``'s rule, the op's
    flop formula: its 7x7/s2 conv's products, 2 * N * Hs * Ws * 64 * 49 * C
    (what the mode counts for ``stem_pool_plain``'s conv; the affine, ReLU
    and pool count nothing)."""
    hs, ws = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return 2 * n * hs * ws * 64 * 49 * c


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
    """Fused stem, differentiable; (N, Hp, Wp, 64) NHWC. The op
    ``proben::stem_pool``: launches K1 for CUDA tensors, runs the plain
    version for CPU tensors, raises on anything else."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stem_pool: unsupported device {x.device}")
    return torch.ops.proben.stem_pool(x, w, scale, bias)


@torch.library.custom_op("proben::stem_pool", mutates_args=(), device_types="cpu")
def _stem_pool_op(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    return stem_pool_plain(x, w, scale, bias)


@_stem_pool_op.register_kernel("cuda")
def _stem_pool_cuda(x, w, scale, bias):
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
        wpk = pack_stem_weights(w)
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stem_pool_bf16(
            x.data_ptr(), wpk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n, h, wd, c, hs, ws, hp, wp, stream,
        )
    _build.check(code, "stem_pool")
    tracing.count("k1.launches")
    return out


@_stem_pool_op.register_fake
def _stem_pool_fake(x, w, scale, bias):
    hp, wp = stem_out_hw(x.shape[1], x.shape[2])
    return x.new_empty((x.shape[0], hp, wp, 64))


def _stem_pool_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _stem_pool_backward(ctx, g):
    """Recompute ``stem_pool_plain`` on the saved inputs and differentiate
    it. Only a trainable stem (``freeze_at == 0``) reaches the backward."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        out = stem_pool_plain(*inputs)
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


_stem_pool_op.register_autograd(_stem_pool_backward, setup_context=_stem_pool_setup)


@register_flop_formula(torch.ops.proben.stem_pool)
def _stem_pool_flops(x_shape, *args, **kwargs) -> int:
    return stem_flops(*x_shape)
