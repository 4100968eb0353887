"""Multi-level RoIAlignV2: kernels K2 (forward, ``csrc/roi_align_fwd.cu``)
and K3 (backward, ``csrc/roi_align_bwd.cu``), their plain versions, and
``multilevel_roi_align`` around them.

Counterpart of ``proben_tpu/ops/roi_align_pallas.py::multilevel_roi_align_pallas``
and its training wrapper: level assignment and window weights
(``ops/roi_align.py``) -> the windowed pooling (``windowed_roi_align``: K2
forward, K3 backward) -> exact whole-map re-pooling of out-of-window RoIs.
Each RoI's pooled rows land at its own index, so callers need no
permutation. ``roi_align_fwd`` and ``roi_align_bwd`` are the ``torch.library``
custom ops ``proben::roi_align_fwd`` and ``proben::roi_align_bwd``: the CPU
implementation of each is its plain version, the CUDA implementation its
kernel, and each has a fake (output shapes, so ``torch.export`` traces
through them) and a flop formula (``roi_align_flops``, read by
``utils.analysis.flop_count``). The forward op's registered backward is the
backward op. The plain versions ``roi_align_fwd_plain`` and
``roi_align_bwd_plain`` are ops too (``proben::roi_align_fwd_plain``,
``proben::roi_align_bwd_plain``), on every device and with the same flop
formula, so a path through the kernels and one through the plain versions
count the same.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build
from ..utils import tracing
from .roi_align import (
    WIN_X,
    WIN_Y,
    apply_oow_fallback,
    build_window_weights,
    level_shapes,
    pad_level,
    padded_size,
    pool_from_windows,
    roi_align_bwd_plain,
    roi_align_flops,
    roi_level_assignment,
)

Tensor = torch.Tensor

_ARGS = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)
_SIG = {"roi_align_fwd_bf16": _ARGS, "roi_align_fwd_f32": _ARGS}
_BWD_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 14 + [ctypes.c_void_p])
_BWD_SIG = {"roi_align_bwd_bf16": _BWD_ARGS, "roi_align_bwd_f32": _BWD_ARGS}
# the largest output size P both kernels take: the FPN pooler's 7 and the C4
# pooler's 14 (K2 and K3 each build one instance for P <= 8 and one above)
MAX_P = 14


def bwd_scratch_words(r: int, b: int, shapes, p: int) -> int:
    """4-byte words of K3's scratch (``csrc/roi_align_bwd.cu``) at output
    size ``p``: per RoI its transposed weights (8 slots per window row and
    column up to P = 8, 16 above) and spans; per tile its RoI list (room for
    every RoI of its image) and its length, for tiles of at least 8 x 8."""
    tiles = sum(-(-s[1] // 8) * -(-s[2] // 8) for s in shapes)  # per image
    slots = 8 if p <= 8 else 16
    return ((WIN_Y + WIN_X) * slots + 4 + tiles) * r + b * tiles


def roi_align_fwd_plain(
    features: Sequence[Tensor],  # per level (B, H_l, W_l, C)
    lvl_idx: Tensor,  # (R,) int32, R = B * rois_per_image
    y0: Tensor,  # (R,) int32 window origins
    x0: Tensor,
    wy: Tensor,  # (R, P, WIN_Y) f32
    wx: Tensor,  # (R, P, WIN_X) f32
    rois_per_image: int,
) -> Tensor:
    """Plain version of K2 (``_fwd_windows``) on any device, as the op
    ``proben::roi_align_fwd_plain``, whose flop formula is K2's,
    ``roi_align_flops``. Differentiable with respect to the features: the
    registered backward recomputes the plain composition and differentiates
    it (autograd through its gather and contractions, not
    ``roi_align_bwd_plain``). Returns (R, P, P, C)."""
    return torch.ops.proben.roi_align_fwd_plain(list(features), lvl_idx, y0, x0, wy, wx,
                                                rois_per_image)


@torch.library.custom_op("proben::roi_align_fwd_plain", mutates_args=())
def _fwd_plain_op(features: List[Tensor], lvl_idx: Tensor, y0: Tensor, x0: Tensor,
                  wy: Tensor, wx: Tensor, rois_per_image: int) -> Tensor:
    return _fwd_windows(features, lvl_idx, y0, x0, wy, wx, rois_per_image)


@_fwd_plain_op.register_fake
def _fwd_plain_fake(features, lvl_idx, y0, x0, wy, wx, rois_per_image):
    r, p = wy.shape[0], wy.shape[1]
    return features[0].new_empty((r, p, p, features[0].shape[-1]))


def _fwd_plain_setup(ctx, inputs, output):
    features, lvl_idx, y0, x0, wy, wx, rois_per_image = inputs
    ctx.save_for_backward(lvl_idx, y0, x0, wy, wx, *features)
    ctx.rois_per_image = rois_per_image


def _fwd_plain_backward(ctx, g):
    lvl_idx, y0, x0, wy, wx, *features = ctx.saved_tensors
    leaves = [f.detach().requires_grad_() for f in features]
    with torch.enable_grad():
        out = _fwd_windows(leaves, lvl_idx, y0, x0, wy, wx, ctx.rois_per_image)
    return list(torch.autograd.grad(out, leaves, g)), None, None, None, None, None, None


_fwd_plain_op.register_autograd(_fwd_plain_backward, setup_context=_fwd_plain_setup)


@register_flop_formula(torch.ops.proben.roi_align_fwd_plain, get_raw=True)
def _fwd_plain_flops(features, lvl_idx, y0, x0, wy, wx, rois_per_image, **kwargs) -> int:
    return roi_align_flops(wy, wx, features[0].shape[-1])


def _fwd_windows(features, lvl_idx, y0, x0, wy, wx, rois_per_image: int, chunk: int = 256) -> Tensor:
    """The plain composition of K2: gather each RoI's (WIN_Y, WIN_X, C)
    window from the zero-padded level and pool it with
    ``pool_from_windows``, ``chunk`` RoIs at a time to bound the window
    memory."""
    feats = [pad_level(f) for f in features]
    b, c = feats[0].shape[0], feats[0].shape[-1]
    dev = feats[0].device
    r, p = wy.shape[0], wy.shape[1]
    flat = torch.cat([f.reshape(-1, c) for f in feats])
    per_image = torch.tensor([f.shape[1] * f.shape[2] for f in feats], device=dev)
    level_off = torch.cumsum(b * per_image, 0) - b * per_image
    pad_w = torch.tensor([f.shape[2] for f in feats], device=dev)
    li = lvl_idx.long().clamp(0, len(feats) - 1)
    img = torch.arange(r, device=dev) // rois_per_image
    base = level_off[li] + img * per_image[li] + y0.long() * pad_w[li] + x0.long()
    rows = torch.arange(WIN_Y, device=dev)[None, :] * pad_w[li][:, None]
    cols = torch.arange(WIN_X, device=dev)
    out = torch.empty((r, p, p, c), dtype=feats[0].dtype, device=dev)
    for s in range(0, r, chunk):
        e = min(s + chunk, r)
        idx = (base[s:e, None] + rows[s:e])[:, :, None] + cols
        out[s:e] = pool_from_windows(flat[idx], wy[s:e], wx[s:e], out.dtype)
    return out


def roi_align_fwd(
    features: Sequence[Tensor],
    lvl_idx: Tensor,
    y0: Tensor,
    x0: Tensor,
    wy: Tensor,
    wx: Tensor,
    rois_per_image: int,
) -> Tensor:
    """Windowed pooling of every RoI; (R, P, P, C) in the features' dtype,
    differentiable with respect to the features (the backward is
    ``roi_align_bwd``). The op ``proben::roi_align_fwd``: launches K2 for
    CUDA tensors, runs the plain version for CPU tensors, raises on
    anything else."""
    if features[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"roi_align_fwd: unsupported device {features[0].device}")
    return torch.ops.proben.roi_align_fwd(list(features), lvl_idx, y0, x0, wy, wx, rois_per_image)


@torch.library.custom_op("proben::roi_align_fwd", mutates_args=(), device_types="cpu")
def _roi_align_fwd_op(features: List[Tensor], lvl_idx: Tensor, y0: Tensor, x0: Tensor,
                      wy: Tensor, wx: Tensor, rois_per_image: int) -> Tensor:
    return roi_align_fwd_plain(features, lvl_idx, y0, x0, wy, wx, rois_per_image)


@_roi_align_fwd_op.register_kernel("cuda")
def _roi_align_fwd_cuda(features, lvl_idx, y0, x0, wy, wx, rois_per_image):
    f0 = features[0]
    if not 1 <= len(features) <= 4:
        raise ValueError(f"roi_align_fwd: 1..4 levels, got {len(features)}")
    b, c = f0.shape[0], f0.shape[-1]
    if f0.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"roi_align_fwd: features must be bf16 or f32, got {f0.dtype}")
    for f in features:
        if (f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c or f.dtype != f0.dtype
                or f.device != f0.device or not f.is_contiguous()):
            raise ValueError("roi_align_fwd: levels must be contiguous (B, H, W, C) "
                             "tensors of one dtype, batch, width and device")
    r, p = wy.shape[0], wy.shape[1]
    if r != b * rois_per_image or p > MAX_P:
        raise ValueError(f"roi_align_fwd: R={r} != B*K={b * rois_per_image} or P={p} > {MAX_P}")
    _check_windows("roi_align_fwd", f0.device, r, p, lvl_idx, y0, x0, wy, wx)
    out = torch.empty((r, p, p, c), dtype=f0.dtype, device=f0.device)
    if out.numel() == 0:
        return out
    levels: List[Tensor] = list(features) + [f0] * (4 - len(features))
    lib = _build.load("roi_align_fwd", _SIG)
    fn = lib.roi_align_fwd_bf16 if f0.dtype == torch.bfloat16 else lib.roi_align_fwd_f32
    with torch.cuda.device(f0.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            *[f.data_ptr() for f in levels],
            *[f.shape[1] for f in levels], *[f.shape[2] for f in levels],
            len(features), c, rois_per_image,
            lvl_idx.data_ptr(), y0.data_ptr(), x0.data_ptr(), wy.data_ptr(), wx.data_ptr(),
            out.data_ptr(), r, p, stream,
        )
    _build.check(code, "roi_align_fwd")
    tracing.count("k2.launches")
    return out


@_roi_align_fwd_op.register_fake
def _roi_align_fwd_fake(features, lvl_idx, y0, x0, wy, wx, rois_per_image):
    r, p = wy.shape[0], wy.shape[1]
    return features[0].new_empty((r, p, p, features[0].shape[-1]))


def _roi_align_fwd_setup(ctx, inputs, output):
    # the window inputs only, never the output: a caller may overwrite rows
    # of the output in place (``apply_oow_fallback``), and autograd then
    # hands the backward a zero cotangent for exactly those rows
    features, lvl_idx, y0, x0, wy, wx, rois_per_image = inputs
    ctx.save_for_backward(lvl_idx, y0, x0, wy, wx)
    ctx.rois_per_image = rois_per_image
    ctx.shapes = [tuple(f.shape) for f in features]


def _roi_align_fwd_backward(ctx, g):
    """Window inputs get no gradient: the proposals are detached, as the
    JAX package returns zeros for the boxes."""
    lvl_idx, y0, x0, wy, wx = ctx.saved_tensors
    dfs = roi_align_bwd(g.contiguous(), ctx.shapes, lvl_idx, y0, x0, wy, wx, ctx.rois_per_image)
    return list(dfs), None, None, None, None, None, None


_roi_align_fwd_op.register_autograd(_roi_align_fwd_backward, setup_context=_roi_align_fwd_setup)


@register_flop_formula(torch.ops.proben.roi_align_fwd, get_raw=True)
def _roi_align_fwd_flops(features, lvl_idx, y0, x0, wy, wx, rois_per_image, **kwargs) -> int:
    return roi_align_flops(wy, wx, features[0].shape[-1])


def _check_windows(what, dev, r, p, lvl_idx, y0, x0, wy, wx):
    for name, t, dt, shape in (
        ("lvl_idx", lvl_idx, torch.int32, (r,)),
        ("y0", y0, torch.int32, (r,)),
        ("x0", x0, torch.int32, (r,)),
        ("wy", wy, torch.float32, (r, p, WIN_Y)),
        ("wx", wx, torch.float32, (r, p, WIN_X)),
    ):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} {shape} on {dev}")


def roi_align_bwd(
    g: Tensor,  # (R, P, P, C) cotangent, the features' dtype
    shapes: Sequence[Tuple[int, int, int, int]],  # per level (B, H_l, W_l, C)
    lvl_idx: Tensor,
    y0: Tensor,
    x0: Tensor,
    wy: Tensor,
    wx: Tensor,
    rois_per_image: int,
) -> List[Tensor]:
    """The VJP of ``roi_align_fwd`` with respect to the features: one
    (B, H_l, W_l, C) tensor per level in g's dtype. The op
    ``proben::roi_align_bwd`` (whose schema takes the level shapes as one
    flat int list): launches K3 for CUDA tensors, runs
    ``roi_align_bwd_plain`` for CPU tensors, raises on anything else."""
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"roi_align_bwd: unsupported device {g.device}")
    flat = [int(d) for s in shapes for d in s]
    return torch.ops.proben.roi_align_bwd(g, flat, lvl_idx, y0, x0, wy, wx, rois_per_image)


@torch.library.custom_op("proben::roi_align_bwd", mutates_args=(), device_types="cpu")
def _roi_align_bwd_op(g: Tensor, shapes: List[int], lvl_idx: Tensor, y0: Tensor, x0: Tensor,
                      wy: Tensor, wx: Tensor, rois_per_image: int) -> List[Tensor]:
    return torch.ops.proben.roi_align_bwd_plain(g, shapes, lvl_idx, y0, x0, wy, wx, rois_per_image)


@_roi_align_bwd_op.register_kernel("cuda")
def _roi_align_bwd_cuda(g, shapes, lvl_idx, y0, x0, wy, wx, rois_per_image):
    shapes = level_shapes(shapes)
    if not 1 <= len(shapes) <= 4:
        raise ValueError(f"roi_align_bwd: 1..4 levels, got {len(shapes)}")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"roi_align_bwd: g must be bf16 or f32, got {g.dtype}")
    b, c = shapes[0][0], shapes[0][3]
    if any(s[0] != b or s[3] != c for s in shapes):
        raise ValueError(f"roi_align_bwd: level shapes {list(shapes)} differ in batch or width")
    r, p = wy.shape[0], wy.shape[1]
    if (g.dim() != 4 or tuple(g.shape) != (r, p, p, c) or not g.is_contiguous()
            or r != b * rois_per_image or p > MAX_P):
        raise ValueError(f"roi_align_bwd: g must be a contiguous (R, P, P, C) = {(r, p, p, c)} "
                         f"tensor with R = B*K = {b * rois_per_image} and P <= {MAX_P}, "
                         f"got {tuple(g.shape)}")
    _check_windows("roi_align_bwd", g.device, r, p, lvl_idx, y0, x0, wy, wx)
    # every dF element is written once: no accumulator, no zero-fill
    scratch = torch.empty(bwd_scratch_words(r, b, shapes, p), dtype=torch.int32, device=g.device)
    outs = [torch.empty(s, dtype=g.dtype, device=g.device) for s in shapes]
    pad = 4 - len(shapes)
    hs = [s[1] for s in shapes] + [shapes[0][1]] * pad
    ws = [s[2] for s in shapes] + [shapes[0][2]] * pad
    lib = _build.load("roi_align_bwd", _BWD_SIG)
    fn = lib.roi_align_bwd_bf16 if g.dtype == torch.bfloat16 else lib.roi_align_bwd_f32
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            g.data_ptr(), lvl_idx.data_ptr(), y0.data_ptr(), x0.data_ptr(), wy.data_ptr(),
            wx.data_ptr(), scratch.data_ptr(), scratch.numel(),
            *[o.data_ptr() for o in outs + outs[:1] * pad],
            *hs, *ws, len(shapes), b, c, rois_per_image, r, p, stream,
        )
    _build.check(code, "roi_align_bwd")
    tracing.count("k3.launches")
    return outs


@_roi_align_bwd_op.register_fake
def _roi_align_bwd_fake(g, shapes, lvl_idx, y0, x0, wy, wx, rois_per_image):
    return [g.new_empty(s) for s in level_shapes(shapes)]


@register_flop_formula(torch.ops.proben.roi_align_bwd, get_raw=True)
def _roi_align_bwd_flops(g, shapes, lvl_idx, y0, x0, wy, wx, rois_per_image, **kwargs) -> int:
    return roi_align_flops(wy, wx, g.shape[-1])


class _PlainWindowedRoIAlign(torch.autograd.Function):
    """The plain versions' ops of the windowed pooling and of its VJP
    (``impl="plain"``), with ``roi_align_fwd``'s contract: window inputs get
    no gradient, and the backward saves the window inputs only."""

    @staticmethod
    def forward(ctx, lvl_idx, y0, x0, wy, wx, rois_per_image, *features):
        ctx.save_for_backward(lvl_idx, y0, x0, wy, wx)
        ctx.rois_per_image = rois_per_image
        ctx.shapes = [tuple(f.shape) for f in features]
        return roi_align_fwd_plain(features, lvl_idx, y0, x0, wy, wx, rois_per_image)

    @staticmethod
    def backward(ctx, g):
        lvl_idx, y0, x0, wy, wx = ctx.saved_tensors
        dfs = roi_align_bwd_plain(g.contiguous(), ctx.shapes, lvl_idx, y0, x0, wy, wx,
                                  ctx.rois_per_image)
        return (None,) * 6 + tuple(dfs)


def windowed_roi_align(impl: str, lvl_idx, y0, x0, wy, wx, rois_per_image: int,
                       features: Sequence[Tensor]) -> Tensor:
    """The windowed pooling with its VJP: ``impl="kernel"`` the op
    ``roi_align_fwd`` (K2 forward, K3 backward on the card), ``"plain"``
    both plain versions on any device."""
    if impl == "kernel":
        return roi_align_fwd(features, lvl_idx, y0, x0, wy, wx, rois_per_image)
    return _PlainWindowedRoIAlign.apply(lvl_idx, y0, x0, wy, wx, rois_per_image, *features)


def window_inputs(
    features: Sequence[Tensor],  # per level (B, H_l, W_l, C)
    boxes: Tensor,  # (B, K, 4) XYXY image coords
    strides: Sequence[int],
    output_size: int = 7,
    sampling_ratio: int = 0,
    min_level: int = 2,
    canonical_box_size: float = 224.0,
    canonical_level: int = 4,
    s_max: int = 16,
    levels: Optional[Tensor] = None,
):
    """K2's inputs for every RoI, flattened over images: (lvl_idx, y0, x0,
    wy, wx, oow) — level index, window origin, per-axis weights and the
    out-of-window flag. ``levels`` (B, K) gives each box its level (counted
    from ``min_level``) in place of the sqrt(area) assignment."""
    num_levels = len(features)
    dev = boxes.device
    hw = [(f.shape[1], f.shape[2]) for f in features]
    pads = [padded_size(h, w) for h, w in hw]
    heights = torch.tensor([h for h, _ in hw], dtype=torch.int32, device=dev)
    widths = torch.tensor([w for _, w in hw], dtype=torch.int32, device=dev)
    pad_hs = torch.tensor([h for h, _ in pads], dtype=torch.int32, device=dev)
    pad_ws = torch.tensor([w for _, w in pads], dtype=torch.int32, device=dev)

    flat_boxes = boxes.reshape(-1, 4)
    if levels is None:
        levels = roi_level_assignment(
            flat_boxes, min_level, min_level + num_levels - 1, canonical_box_size, canonical_level
        )
    lvl_idx = (levels.reshape(-1).to(torch.int32) - min_level).clamp(0, num_levels - 1)
    y0, x0, wy, wx, oow = build_window_weights(
        flat_boxes, lvl_idx, strides, heights, widths, pad_hs, pad_ws, output_size,
        sampling_ratio, s_max
    )
    return lvl_idx, y0, x0, wy, wx, oow


def multilevel_roi_align(
    features: Sequence[Tensor],  # per level (B, H_l, W_l, C), contiguous NHWC
    boxes: Tensor,  # (B, K, 4) XYXY image coords
    strides: Sequence[int],
    output_size: int = 7,
    sampling_ratio: int = 0,
    min_level: int = 2,
    canonical_box_size: float = 224.0,
    canonical_level: int = 4,
    s_max: int = 16,
    fallback_capacity: int = 32,
    impl: str = "kernel",
    levels: Optional[Tensor] = None,
) -> Tensor:
    """Batched multi-level RoIAlignV2; (B, K, P, P, C) in the features' dtype,
    differentiable with respect to the features. ``impl="kernel"`` pools
    through K2 and differentiates through K3 on the card, ``"plain"``
    through both plain versions on any device. ``levels`` (B, K): each
    box's level, as in ``window_inputs``."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown roi_align impl {impl!r}")
    b, k, _ = boxes.shape
    p = output_size
    with tracing.span("roi.window_inputs"):
        lvl_idx, y0, x0, wy, wx, oow = window_inputs(
            features, boxes, strides, p, sampling_ratio, min_level, canonical_box_size,
            canonical_level, s_max, levels,
        )
    pooled = windowed_roi_align(impl, lvl_idx, y0, x0, wy, wx, k, features)
    pooled = pooled.reshape(b, k, p, p, -1)
    return apply_oow_fallback(
        pooled, oow.reshape(b, k), features, boxes, lvl_idx.reshape(b, k), strides, p,
        sampling_ratio, fallback_capacity,
    )


def single_level_roi_align(
    feature: Tensor,  # (B, H, W, C), contiguous NHWC
    boxes: Tensor,  # (B, K, 4) XYXY image coords
    stride: int,
    output_size: int = 7,
    sampling_ratio: int = 0,
    impl: str = "kernel",
) -> Tensor:
    """RoIAlignV2 on one feature map (JAX ``ops/roi_align.py::
    single_level_roi_align``): ``multilevel_roi_align`` with every box on
    level 0. (B, K, P, P, C); K2 and K3 on the card, P up to ``MAX_P``."""
    return multilevel_roi_align(
        [feature], boxes, [stride], output_size=output_size, sampling_ratio=sampling_ratio,
        min_level=0, impl=impl, levels=torch.zeros(boxes.shape[:2], dtype=torch.int32,
                                                  device=boxes.device),
    )
