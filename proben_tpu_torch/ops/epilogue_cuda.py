"""A ResNet bottleneck's conv epilogue: kernel K4 (``csrc/block_epilogue.cu``),
forward and backward, and its plain version.

The epilogue of each conv of a bottleneck, in the compute dtype:

    relu(affine(x, s, b))                               (after conv1, conv2)
    relu(affine(x, s, b) + r)                           (conv3, identity shortcut)
    relu(affine(x, s, b) + affine(xr, sr, br))          (conv3, projection shortcut)

with ``affine`` the folded FrozenBN ``x * s + b`` (``models/layers.py``),
its f32 parameters rounded to ``x``'s dtype. ``block_epilogue`` is the
``torch.library`` custom op ``proben::block_epilogue``: its CPU
implementation is the plain composition, its CUDA implementation K4, its
fake gives the output's shape (so ``torch.export`` traces through it), and
its registered backward is the op ``proben::block_epilogue_bwd`` (plain
version on the CPU, K4's backward on the card). K4 keeps every rounding
point of the composition, so its forward and its map gradients are the
composition's bits and its parameter gradients differ only in the order of
their f32 sums.

``block_epilogue`` routes by what it can observe: the op for CPU tensors
and for CUDA maps K4 takes (``kernel_takes``: bf16, channels_last-contiguous,
C a multiple of 8, f32 parameters), where an eager call records gradients
through ``_K4`` (the op's kernels and backward without its Python autograd
dispatch); the plain composition, counted as ``epilogue.plain``, for any
other CUDA map (f32, NCHW, ...). A trace (``torch.export``, under which
``torch.compiler.is_compiling()`` is true) records the op for every map:
its fake tensors' strides need not be the run's (a fake convolution's
output is NCHW-contiguous where cuDNN's is channels_last), and ``_K4``
launches K4 itself, which fake tensors cannot. The op's CUDA
implementations route the same way on the tensors the program runs with:
K4 where ``kernel_takes``, else the plain versions, counted as
``epilogue.plain``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from .. import _build
from ..utils import tracing

Tensor = torch.Tensor

_FWD = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_longlong]
        + [ctypes.c_void_p])
_BWD = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_longlong]
        + [ctypes.c_void_p])
_SIG = {
    "block_epilogue_fwd_bf16": _FWD,
    "block_epilogue_bwd_bf16": _BWD,
    "block_epilogue_occupancy": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
THREADS = 256  # a CTA: tx channel vectors of 8 x ty rows
PLAIN, IDENTITY, SHORTCUT = 0, 1, 2
_occupancy: Dict[Tuple[int, int], int] = {}
_sms: Dict[int, int] = {}


def block_epilogue_plain(x: Tensor, scale: Tensor, bias: Tensor, residual: Optional[Tensor] = None,
                         residual_scale: Optional[Tensor] = None,
                         residual_bias: Optional[Tensor] = None) -> Tensor:
    """The composition K4 replaces, in ``x``'s dtype: ``relu(affine(x) [+
    residual | + affine(residual)])``, NCHW maps, (C,) parameters."""
    out = x * scale.to(x.dtype).view(1, -1, 1, 1) + bias.to(x.dtype).view(1, -1, 1, 1)
    if residual is not None:
        if residual_scale is not None:
            residual = (residual * residual_scale.to(residual.dtype).view(1, -1, 1, 1)
                        + residual_bias.to(residual.dtype).view(1, -1, 1, 1))
        out = out + residual
    return torch.relu(out)


def block_epilogue_bwd_plain(g: Tensor, y: Tensor, x: Tensor, scale: Tensor,
                             shortcut_x: Optional[Tensor], shortcut_scale: Optional[Tensor],
                             residual: bool) -> List[Tensor]:
    """The VJP of ``block_epilogue_plain`` as autograd computes it, from the
    output ``y`` and the pre-affine maps: ``[gx, gscale, gbias]``, then
    ``gresidual`` (identity) or ``[gshortcut_x, gshortcut_scale,
    gshortcut_bias]`` (projection). Parameter gradients in ``scale``'s
    dtype."""
    gm = torch.ops.aten.threshold_backward(g, y, 0)
    c = x.shape[1]

    def sum_channels(t: Tensor, dtype) -> Tensor:  # autograd's reduction of a broadcast (C,)
        return t.sum_to_size(1, c, 1, 1).reshape(c).to(dtype)

    gx = gm * scale.to(x.dtype).view(1, -1, 1, 1)
    gs, gb = sum_channels(gm * x, scale.dtype), sum_channels(gm, scale.dtype)
    if not residual:
        return [gx, gs, gb]
    if shortcut_x is None:
        return [gx, gs, gb, gm]
    gxr = gm * shortcut_scale.to(shortcut_x.dtype).view(1, -1, 1, 1)
    return [gx, gs, gb, gxr, sum_channels(gm * shortcut_x, shortcut_scale.dtype),
            sum_channels(gm, shortcut_scale.dtype)]


def _aligned(t: Tensor) -> bool:
    """bf16 channels_last-contiguous with 16-byte rows at a 16-byte offset."""
    return (t.dtype == torch.bfloat16 and t.dim() == 4 and t.shape[1] % 8 == 0
            and t.is_contiguous(memory_format=torch.channels_last) and t.storage_offset() % 8 == 0)


def _k4_inputs(maps, params) -> bool:
    """CUDA maps of one shape, each ``_aligned``, and contiguous f32 (C,)
    parameters, all on one device."""
    x = maps[0]
    return (x.device.type == "cuda"
            and all(m.shape == x.shape and m.device == x.device and _aligned(m) for m in maps)
            and all(p.dtype == torch.float32 and p.shape == (x.shape[1],) and p.is_contiguous()
                    and p.device == x.device for p in params))


def kernel_takes(x: Tensor, scale: Tensor, bias: Tensor, residual: Optional[Tensor] = None,
                 residual_scale: Optional[Tensor] = None,
                 residual_bias: Optional[Tensor] = None) -> bool:
    """Whether K4 takes these inputs: CUDA maps of one shape, bf16,
    channels_last-contiguous, C a multiple of 8, and contiguous f32 (C,)
    parameters on the same device."""
    maps = [x] + ([residual] if residual is not None else [])
    params = [scale, bias] + ([residual_scale, residual_bias] if residual_scale is not None else [])
    return _k4_inputs(maps, params)


def block_epilogue(x: Tensor, scale: Tensor, bias: Tensor, residual: Optional[Tensor] = None,
                   residual_scale: Optional[Tensor] = None,
                   residual_bias: Optional[Tensor] = None) -> Tensor:
    """``relu(affine(x) [+ residual | + affine(residual)])``, differentiable:
    the op ``proben::block_epilogue`` for CPU tensors, in a trace and for
    CUDA maps ``kernel_takes`` (K4; ``_K4``, the same kernels, where an
    eager call records gradients), else the plain composition."""
    args = (x, scale, bias, residual, residual_scale, residual_bias)
    if x.device.type == "cpu" or (x.device.type == "cuda" and torch.compiler.is_compiling()):
        return torch.ops.proben.block_epilogue(*args)
    if x.device.type == "cuda" and kernel_takes(*args):
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
            return _K4.apply(*args)
        return torch.ops.proben.block_epilogue(*args)
    if x.device.type == "cuda":
        tracing.count("epilogue.plain")
    return block_epilogue_plain(*args)


@torch.library.custom_op("proben::block_epilogue", mutates_args=(), device_types="cpu")
def _epilogue_op(x: Tensor, scale: Tensor, bias: Tensor, residual: Optional[Tensor],
                 residual_scale: Optional[Tensor], residual_bias: Optional[Tensor]) -> Tensor:
    return block_epilogue_plain(x, scale, bias, residual, residual_scale, residual_bias)


def _layout(device: torch.device, rows: int, channels: int, bwd: int, mode: int, lib):
    """K4's launch: (tx, ty, grid_x, grid_y, rows_per_cta). tx channel
    vectors (up to 32, a power of two) by ty = 256 / tx rows a CTA; grid_y
    slices C, grid_x the rows, so that grid_x * grid_y fills every SM once
    at the kernel's occupancy."""
    vecs = channels // 8
    tx = min(32, 1 << (vecs - 1).bit_length())
    ty = THREADS // tx
    grid_y = -(-vecs // tx)
    key = (bwd, mode)
    if key not in _occupancy:
        n = ctypes.c_int(0)
        _build.check(lib.block_epilogue_occupancy(bwd, mode, ctypes.byref(n)), "block_epilogue")
        _occupancy[key] = max(1, n.value)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    grid_x = max(1, min(-(-rows // ty), _sms[index] * _occupancy[key] // grid_y))
    return tx, ty, grid_x, grid_y, -(-rows // grid_x)


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_aligned(t: Tensor, what: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"block_epilogue: {what} is not 16-byte aligned")


@_epilogue_op.register_kernel("cuda")
def _epilogue_cuda(x, scale, bias, residual, residual_scale, residual_bias):
    args = (x, scale, bias, residual, residual_scale, residual_bias)
    if kernel_takes(*args):
        return _k4_forward(*args)
    tracing.count("epilogue.plain")
    return block_epilogue_plain(*args)


def _k4_forward(x, scale, bias, residual, residual_scale, residual_bias) -> Tensor:
    """Launch K4's forward on inputs ``kernel_takes``."""
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    mode = PLAIN if residual is None else (IDENTITY if residual_scale is None else SHORTCUT)
    n, c, h, w = x.shape
    lib = _build.load("block_epilogue", _SIG)
    tx, ty, gx, gy, per_cta = _layout(x.device, n * h * w, c, 0, mode, lib)
    for t, what in ((x, "x"), (residual, "residual")):
        if t is not None:
            _check_aligned(t, what)
    with torch.cuda.device(x.device):
        code = lib.block_epilogue_fwd_bf16(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), _ptr(residual), _ptr(residual_scale),
            _ptr(residual_bias), y.data_ptr(), n * h * w, c, mode, tx, ty, gx, gy, per_cta,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "block_epilogue")
    tracing.count("k4.launches")
    return y


@_epilogue_op.register_fake
def _epilogue_fake(x, scale, bias, residual, residual_scale, residual_bias):
    return torch.empty_like(x)


def _epilogue_setup(ctx, inputs, output):
    x, scale, bias, residual, residual_scale, residual_bias = inputs
    shortcut_x = residual if residual_scale is not None else None
    ctx.save_for_backward(output, x, scale, shortcut_x, residual_scale)
    ctx.residual = residual is not None


def _epilogue_grads(ctx, g, bwd):
    y, x, scale, shortcut_x, shortcut_scale = ctx.saved_tensors
    grads = list(bwd(g, y, x, scale, shortcut_x, shortcut_scale, ctx.residual))
    grads += [None] * (6 - len(grads))
    return tuple(t if need else None for t, need in zip(grads, ctx.needs_input_grad))


def _epilogue_backward(ctx, g):
    return _epilogue_grads(ctx, g, torch.ops.proben.block_epilogue_bwd)


_epilogue_op.register_autograd(_epilogue_backward, setup_context=_epilogue_setup)


class _K4(torch.autograd.Function):
    """K4 forward and backward for eager calls that record gradients: the
    op's kernels, saved tensors and backward, without its Python autograd
    dispatch. On the H100 machine's host, one identity-residual epilogue
    with grad took 103 us through the op, 50 through this path and 67 as
    the eager ops it replaces; training's backbone forward waits for it."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, residual_scale, residual_bias):
        y = _k4_forward(x, scale, bias, residual, residual_scale, residual_bias)
        _epilogue_setup(ctx, (x, scale, bias, residual, residual_scale, residual_bias), y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _epilogue_grads(ctx, g, _bwd_cuda)


@torch.library.custom_op("proben::block_epilogue_bwd", mutates_args=(), device_types="cpu")
def _bwd_op(g: Tensor, y: Tensor, x: Tensor, scale: Tensor, shortcut_x: Optional[Tensor],
            shortcut_scale: Optional[Tensor], residual: bool) -> List[Tensor]:
    return block_epilogue_bwd_plain(g, y, x, scale, shortcut_x, shortcut_scale, residual)


@_bwd_op.register_kernel("cuda")
def _bwd_cuda(g, y, x, scale, shortcut_x, shortcut_scale, residual):
    """K4's backward where its inputs allow (the forward ran K4: bf16
    channels_last maps), else the plain backward."""
    gc = g.contiguous(memory_format=torch.channels_last)
    shortcut = shortcut_x is not None
    if not (_k4_inputs([x, gc, y] + ([shortcut_x] if shortcut else []),
                       [scale] + ([shortcut_scale] if shortcut else []))
            and shortcut == (shortcut_scale is not None) and (residual or not shortcut)):
        return block_epilogue_bwd_plain(g, y, x, scale, shortcut_x, shortcut_scale, residual)
    g = gc
    mode = SHORTCUT if shortcut else (IDENTITY if residual else PLAIN)
    n, c, h, w = x.shape
    rows = n * h * w
    gx = torch.empty_like(x)
    gr = torch.empty_like(x) if mode != PLAIN else None
    sums = [torch.empty(c, dtype=torch.float32, device=x.device)
            for _ in range(2 if mode != SHORTCUT else 4)]
    outs = [gx, sums[0], sums[1]] + ([gr] if mode == IDENTITY else []) + (
        [gr, sums[2], sums[3]] if mode == SHORTCUT else [])
    if rows == 0:
        for s in sums:
            s.zero_()
        return outs
    lib = _build.load("block_epilogue", _SIG)
    tx, ty, grid_x, grid_y, per_cta = _layout(x.device, rows, c, 1, mode, lib)
    partial = torch.empty((3 if mode == SHORTCUT else 2, grid_x, c), dtype=torch.float32,
                          device=x.device)
    for t, what in ((g, "g"), (y, "y"), (x, "x"), (shortcut_x, "shortcut_x")):
        if t is not None:
            _check_aligned(t, what)
    with torch.cuda.device(x.device):
        code = lib.block_epilogue_bwd_bf16(
            g.data_ptr(), y.data_ptr(), x.data_ptr(), scale.data_ptr(), _ptr(shortcut_x),
            _ptr(shortcut_scale), gx.data_ptr(), _ptr(gr), partial.data_ptr(), sums[0].data_ptr(),
            sums[1].data_ptr(), sums[2].data_ptr() if shortcut else None,
            sums[3].data_ptr() if shortcut else None, rows, c, mode, tx, ty, grid_x, grid_y,
            per_cta, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "block_epilogue_bwd")
    tracing.count("k4.launches")
    return outs


@_bwd_op.register_fake
def _bwd_fake(g, y, x, scale, shortcut_x, shortcut_scale, residual):
    c = x.shape[1]
    out = [torch.empty_like(x), scale.new_empty(c), scale.new_empty(c)]
    if not residual:
        return out
    if shortcut_x is None:
        return out + [torch.empty_like(x)]
    return out + [torch.empty_like(shortcut_x), shortcut_scale.new_empty(c),
                  shortcut_scale.new_empty(c)]
