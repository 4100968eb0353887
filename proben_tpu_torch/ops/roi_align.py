"""RoIAlignV2 (``aligned=True``) as separable per-RoI weight matrices: the
plain half (counterpart of ``proben_tpu/ops/roi_align.py``).

For every RoI the pooled output is

    out[p, q, c] = sum_{y, x} Wy[p, y] * Wx[q, x] * window[y, x, c]

where ``Wy`` (P, WIN) folds each output row's bilinear weights and the
1/grid sample averaging into one dense row, so adaptive sampling
(``sampling_ratio=0``) is exact at the same cost as any static ratio. These
functions build the weights and origins that kernels K2 and K3
(``ops/roi_align_cuda.py``) consume, hold K2's pooling arithmetic
(``pool_from_windows``) and K3's plain version (``roi_align_bwd_plain``, the
op ``proben::roi_align_bwd_plain``),
and re-pool the rare out-of-window RoIs exactly against the whole level map.
Same arithmetic, in the same order, as the JAX functions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from torch.utils.flop_counter import register_flop_formula

from ..structures.boxes import clip
from ..utils import tracing
from .topk import topk_stable

Tensor = torch.Tensor

# static feature-space window; origins aligned to (Y_ALIGN, X_ALIGN) as in
# the JAX package, so the weights (window-relative) are identical
WIN_Y = 56
WIN_X = 64
X_ALIGN = 16
Y_ALIGN = 8


def roi_level_assignment(
    boxes: Tensor,
    min_level: int,
    max_level: int,
    canonical_box_size: float = 224.0,
    canonical_level: int = 4,
) -> Tensor:
    """FPN level per box by sqrt(area); int32 in [min_level, max_level].
    Total under non-finite boxes: a NaN level becomes ``min_level`` (an
    out-of-range level would be an out-of-bounds read in the kernel)."""
    area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp(min=1e-6)
    lvl = torch.floor(canonical_level + torch.log2(torch.sqrt(area) / canonical_box_size + 1e-8))
    lvl = torch.where(torch.isfinite(lvl), lvl, float(min_level))
    return lvl.clamp(min_level, max_level).to(torch.int32)


def axis_weights(
    start: Tensor,  # (K,) roi start coordinate (feature space, V2-aligned)
    bin_sz: Tensor,  # (K,) bin size = roi_span / P (may be <= 0)
    dim_size: Tensor,  # (K,) level H (or W) per RoI
    win_start: Tensor,  # (K,) int32 window origin (0 for whole-map)
    win: int,
    p: int,
    ratio: int,  # static sampling ratio; 0 = adaptive ceil(bin_sz)
    s_max: int,  # static number of sample slots (== ratio when ratio > 0)
) -> Tuple[Tensor, Tensor]:
    """(K, P, win) composite f32 row weights + (K,) out-of-window flags, with
    exact ROIAlignV2 border semantics."""
    dev = start.device
    if ratio > 0:
        s_max = ratio
        grid = torch.full(start.shape, float(ratio), device=dev)
        over = torch.zeros(start.shape, dtype=torch.bool, device=dev)
    else:
        grid = torch.ceil(bin_sz)
        over = grid > float(s_max)
    gridc = grid.clamp(1.0, float(s_max))
    i = torch.arange(s_max, dtype=torch.float32, device=dev)
    pp = torch.arange(p, dtype=torch.float32, device=dev)
    coords = (
        start[:, None, None]
        + (pp[None, :, None] + (i[None, None, :] + 0.5) / gridc[:, None, None])
        * bin_sz[:, None, None]
    )
    slot_ok = i[None, None, :] < grid.clamp(max=float(s_max))[:, None, None]
    dimf = dim_size.to(torch.float32)[:, None, None]
    # outside [-1, dim] -> contributes 0 (but still counts in the divisor)
    valid = (coords >= -1.0) & (coords <= dimf)
    c = clip(coords, 0.0, dimf - 1.0)
    c0 = torch.floor(c)
    frac = c - c0
    # border clamp: hi index out of range -> all weight moves to lo
    frac = torch.where(c0 + 1.0 > dimf - 1.0, 0.0, frac)
    rel = c0.to(torch.int32) - win_start[:, None, None]

    active = slot_ok & valid
    lost = active & ((rel < 0) | (rel > win - 1) | ((rel > win - 2) & (frac > 0.0)))
    oow = lost.any(dim=2).any(dim=1) | over

    lo = rel.clamp(0, win - 1)
    hi = (rel + 1).clamp(0, win - 1)
    cols = torch.arange(win, dtype=torch.int32, device=dev)
    w_lo = (cols == lo[..., None]) * (1.0 - frac)[..., None]
    w_hi = (cols == hi[..., None]) * frac[..., None]
    w = ((w_lo + w_hi) * active[..., None].to(torch.float32)).sum(dim=2)
    w = w / gridc[:, None, None]
    return w.to(torch.float32), oow


def window_origin(start: Tensor, dim: Tensor, pad_dim: Tensor, win: int, align: int = 1) -> Tensor:
    """Per-RoI window origin: floor of the clamped span start, aligned down,
    clamped so the window fits the padded level."""
    first = clip(start, 0.0, dim.to(torch.float32) - 1.0)
    o = torch.floor(first).to(torch.int32)
    o = torch.div(o, align, rounding_mode="floor") * align
    return torch.minimum(torch.maximum(o, torch.zeros_like(o)), pad_dim - win)


def roi_geometry(boxes: Tensor, lvl_idx: Tensor, strides: Sequence[int], p: int):
    """Per-RoI V2-aligned (y1, x1, bin_h, bin_w) at the assigned level."""
    # 1 / stride of each box's level, built without a tensor constant (the
    # exported fallback branch may hold none)
    scale = torch.zeros(lvl_idx.shape, dtype=torch.float32, device=boxes.device)
    for i, s in enumerate(strides):
        scale = torch.where(lvl_idx == i, 1.0 / s, scale)
    x1 = boxes[:, 0] * scale - 0.5
    y1 = boxes[:, 1] * scale - 0.5
    bin_w = (boxes[:, 2] * scale - 0.5 - x1) / p
    bin_h = (boxes[:, 3] * scale - 0.5 - y1) / p
    return y1, x1, bin_h, bin_w


def padded_size(h: int, w: int) -> Tuple[int, int]:
    """(H, W) of ``pad_level``'s output for an (H, W) level."""
    target_w = max(w, WIN_X)
    return max(h, WIN_Y), ((target_w + X_ALIGN - 1) // X_ALIGN) * X_ALIGN


def pad_level(f: Tensor) -> Tensor:
    """Zero-pad one (..., H, W, C) level so a (WIN_Y, WIN_X) window always
    fits at every aligned origin."""
    h, w = f.shape[-3], f.shape[-2]
    ph, pw = padded_size(h, w)
    if (ph, pw) == (h, w):
        return f
    return torch.nn.functional.pad(f, (0, 0, 0, pw - w, 0, ph - h))


def build_window_weights(
    boxes: Tensor,  # (K, 4)
    lvl_idx: Tensor,  # (K,) 0-based level index
    strides: Sequence[int],
    heights: Tensor,  # (L,) true level heights, int32
    widths: Tensor,
    pad_heights: Tensor,  # (L,) padded level heights
    pad_widths: Tensor,
    output_size: int,
    sampling_ratio: int,
    s_max: int,
):
    """(y0, x0, wy, wx, oow): int32 window origins, (K, P, WIN) f32 weights
    and the per-RoI out-of-window flag; the kernel's and the plain version's
    common input."""
    p = output_size
    li = lvl_idx.long()
    h_l = heights[li]
    w_l = widths[li]
    y1, x1, bin_h, bin_w = roi_geometry(boxes, lvl_idx, strides, p)
    if sampling_ratio > 0:
        gy = gx = torch.full(boxes.shape[:1], float(sampling_ratio), device=boxes.device)
    else:
        gy = torch.ceil(bin_h).clamp(1.0, float(s_max))
        gx = torch.ceil(bin_w).clamp(1.0, float(s_max))
    y0 = window_origin(y1 + 0.5 / gy * bin_h, h_l, pad_heights[li], WIN_Y, align=Y_ALIGN)
    x0 = window_origin(x1 + 0.5 / gx * bin_w, w_l, pad_widths[li], WIN_X, align=X_ALIGN)
    wy, oow_y = axis_weights(y1, bin_h, h_l, y0, WIN_Y, p, sampling_ratio, s_max)
    wx, oow_x = axis_weights(x1, bin_w, w_l, x0, WIN_X, p, sampling_ratio, s_max)
    return y0, x0, wy, wx, oow_y | oow_x


def pool_from_windows(windows: Tensor, wy: Tensor, wx: Tensor, out_dtype) -> Tensor:
    """(K, WY, WX, C) x (K, P, WY) x (K, P, WX) -> (K, P, P, C). ``wy`` is
    rounded to the windows' dtype, every product is exact in f32 and both
    contractions accumulate in f32; ``wx`` stays f32."""
    wdt = windows.dtype
    t1 = torch.einsum("kpy,kyxc->kpxc", wy.to(wdt).float(), windows.float())
    out = torch.einsum("kqx,kpxc->kpqc", wx.float(), t1)
    return out.to(out_dtype)


def roi_align_flops(wy: Tensor, wx: Tensor, c: int) -> int:
    """RoIAlign's own work, the flop formula of the ops ``proben::
    roi_align_fwd`` and ``proben::roi_align_bwd`` (K2, K3) and of their
    plain versions' ops that ``utils.analysis.flop_count`` reads (not the
    plain versions' dense contractions over each RoI's whole window, which
    compute it): each output bin (r, p, q)
    is a weighted sum of the level pixels its bilinear samples touch, the
    nonzero entries of wy[r, p] times those of wx[r, q] (the composite
    weights merge the samples' taps), so a multiply and an add per touched
    pixel and channel: 2 * C * sum_r nnz(wy[r]) * nnz(wx[r]). The VJP does
    the same multiply-adds. It reads the weights (a sync on the card), and
    is called only inside ``flop_count``."""
    ny = (wy != 0).sum(dim=(1, 2)).to(torch.int64)
    nx = (wx != 0).sum(dim=(1, 2)).to(torch.int64)
    return 2 * int(c) * int((ny * nx).sum())


def roi_align_bwd_plain(
    g: Tensor,  # (R, P, P, C) cotangent of the windowed pooling, features' dtype
    shapes: Sequence[Tuple[int, int, int, int]],  # per level (B, H_l, W_l, C)
    lvl_idx: Tensor,  # (R,) int32
    y0: Tensor,  # (R,) int32 window origins
    x0: Tensor,
    wy: Tensor,  # (R, P, WIN_Y) f32
    wx: Tensor,  # (R, P, WIN_X) f32
    rois_per_image: int,
) -> List[Tensor]:
    """Plain version of K3 (``_bwd_windows``) on any device, as the op
    ``proben::roi_align_bwd_plain`` (level shapes as one flat int list),
    whose flop formula is K3's, ``roi_align_flops``."""
    flat = [int(d) for s in shapes for d in s]
    return torch.ops.proben.roi_align_bwd_plain(g, flat, lvl_idx, y0, x0, wy, wx, rois_per_image)


def level_shapes(flat: Sequence[int]) -> List[Tuple[int, ...]]:
    """Per level (B, H_l, W_l, C) from the flat int list of the ops'
    schemas."""
    if len(flat) % 4:
        raise ValueError(f"roi_align: {len(flat)} shape entries, not 4 per level")
    return [tuple(flat[i:i + 4]) for i in range(0, len(flat), 4)]


@torch.library.custom_op("proben::roi_align_bwd_plain", mutates_args=())
def _bwd_plain_op(g: Tensor, shapes: List[int], lvl_idx: Tensor, y0: Tensor, x0: Tensor,
                  wy: Tensor, wx: Tensor, rois_per_image: int) -> List[Tensor]:
    return _bwd_windows(g, level_shapes(shapes), lvl_idx, y0, x0, wy, wx, rois_per_image)


@_bwd_plain_op.register_fake
def _bwd_plain_fake(g, shapes, lvl_idx, y0, x0, wy, wx, rois_per_image):
    return [g.new_empty(s) for s in level_shapes(shapes)]


@register_flop_formula(torch.ops.proben.roi_align_bwd_plain, get_raw=True)
def _bwd_plain_flops(g, shapes, lvl_idx, y0, x0, wy, wx, rois_per_image, **kwargs) -> int:
    return roi_align_flops(wy, wx, g.shape[-1])


def _bwd_windows(
    g: Tensor,
    shapes: Sequence[Tuple[int, int, int, int]],
    lvl_idx: Tensor,
    y0: Tensor,
    x0: Tensor,
    wy: Tensor,
    wx: Tensor,
    rois_per_image: int,
    chunk: int = 256,
) -> List[Tensor]:
    """Plain version of K3, the VJP of the windowed pooling:

        dF_l[y0 + y, x0 + x, c] += sum_q wx[q, x] * u[y, q, c],
        u[y, q, c] = sum_p wy[p, y] * g[p, q, c]

    over every RoI ``chunk`` at a time, with the rounding of the JAX
    backward paths: wy and wx rounded to g's dtype, u computed in f32 and
    rounded to g's dtype, the scatter accumulated in f32 into zero-padded
    level maps (``index_add_``, no autograd through a gather), then cut to
    each level's true size and rounded. Returns per level (B, H_l, W_l, C)
    in g's dtype."""
    dt = g.dtype
    dev = g.device
    b, c = shapes[0][0], shapes[0][3]
    r = g.shape[0]
    pads = [padded_size(h, w) for _, h, w, _ in shapes]
    per_image = torch.tensor([ph * pw for ph, pw in pads], device=dev)
    level_off = torch.cumsum(b * per_image, 0) - b * per_image
    pad_w = torch.tensor([pw for _, pw in pads], device=dev)
    li = lvl_idx.long().clamp(0, len(shapes) - 1)
    img = torch.arange(r, device=dev) // rois_per_image
    base = level_off[li] + img * per_image[li] + y0.long() * pad_w[li] + x0.long()
    rows = torch.arange(WIN_Y, device=dev)[None, :] * pad_w[li][:, None]
    cols = torch.arange(WIN_X, device=dev)
    flat = torch.zeros((b * sum(ph * pw for ph, pw in pads), c), dtype=torch.float32, device=dev)
    for s in range(0, r, chunk):
        e = min(s + chunk, r)
        u = torch.einsum("npy,npqc->nyqc", wy[s:e].to(dt).float(), g[s:e].float()).to(dt)
        contrib = torch.einsum("nqx,nyqc->nyxc", wx[s:e].to(dt).float(), u.float())
        idx = (base[s:e, None] + rows[s:e])[:, :, None] + cols  # (n, WIN_Y, WIN_X)
        flat.index_add_(0, idx.reshape(-1), contrib.reshape(-1, c))
    out, off = [], 0
    for (_, h, w, _), (ph, pw) in zip(shapes, pads):
        level = flat[off:off + b * ph * pw].reshape(b, ph, pw, c)
        out.append(level[:, :h, :w].to(dt).clone(memory_format=torch.contiguous_format))
        off += b * ph * pw
    return out


def wholemap_roi_align(
    features: Sequence[Tensor],  # per level (B, H_l, W_l, C), unpadded
    boxes: Tensor,  # (B, R, 4)
    lvl_idx: Tensor,  # (B, R) 0-based level index
    strides: Sequence[int],
    output_size: int,
    sampling_ratio: int,
    level_hw: Optional[Sequence[Tuple[int, int]]] = None,
) -> Tensor:
    """Exact pooling of each image's RoIs against its full (unwindowed)
    level maps, f32 (B, R, P, P, C). O(R * H_l * W_l * C) per level and
    image: only for the few out-of-window RoIs. ``level_hw``: the levels'
    (H, W) as ints, for a caller whose tensors' shapes are traced
    symbolically (a ``torch.cond`` branch), where the sample-slot counts
    must stay static."""
    p = output_size
    b, r = boxes.shape[:2]
    dev = boxes.device
    y1, x1, bin_h, bin_w = roi_geometry(boxes.reshape(-1, 4), lvl_idx.reshape(-1), strides, p)
    zero = torch.zeros(b * r, dtype=torch.int32, device=dev)
    c = features[0].shape[-1]
    out = torch.zeros((b, r, p, p, c), dtype=torch.float32, device=dev)
    for li, f in enumerate(features):
        h_l, w_l = level_hw[li] if level_hw is not None else (f.shape[1], f.shape[2])
        s_hi_y = max(sampling_ratio, -(-h_l // p) + 2)
        s_hi_x = max(sampling_ratio, -(-w_l // p) + 2)
        wy, _ = axis_weights(y1, bin_h, torch.full_like(zero, h_l), zero, h_l, p, sampling_ratio, s_hi_y)
        wx, _ = axis_weights(x1, bin_w, torch.full_like(zero, w_l), zero, w_l, p, sampling_ratio, s_hi_x)
        wy = wy.reshape(b, r, p, h_l)
        wx = wx.reshape(b, r, p, w_l)
        m = (lvl_idx == li).to(torch.float32)[..., None, None]
        ff = f.float()
        # contract the longer spatial axis first; t1 rounds to the map dtype
        if h_l >= w_l:
            wy = wy * m
            t1 = torch.einsum("brph,bhwc->brpwc", wy.to(f.dtype).float(), ff).to(f.dtype)
            out = out + torch.einsum("brqw,brpwc->brpqc", wx.to(f.dtype).float(), t1.float())
        else:
            wx = wx * m
            t1 = torch.einsum("brqw,bhwc->brqhc", wx.to(f.dtype).float(), ff).to(f.dtype)
            out = out + torch.einsum("brph,brqhc->brpqc", wy.to(f.dtype).float(), t1.float())
    return out


def apply_oow_fallback(
    pooled: Tensor,  # (B, K, P, P, C) windowed result; updated in place
    oow: Tensor,  # (B, K) bool
    features: Sequence[Tensor],  # per level (B, H_l, W_l, C), unpadded
    boxes: Tensor,  # (B, K, 4)
    lvl_idx: Tensor,  # (B, K)
    strides: Sequence[int],
    output_size: int,
    sampling_ratio: int,
    capacity: int,
) -> Tensor:
    """Replace up to ``capacity`` out-of-window rows per image (the first
    ones by index) with exact whole-map pooling, all images in one batched
    pass. Eager: one host read of the per-image out-of-window counts skips
    the pass when they are all 0 and feeds the counters ``roi.oow`` and
    ``roi.oow_over_capacity`` (rows past ``capacity`` in their image, which
    keep their windowed value); the pooled tensor is updated in place,
    which is safe because the caller owns it. While ``torch.export``
    traces, the skip is a ``torch.cond`` on the device and the update is
    out of place, so the exported program computes what the eager one
    does."""
    if capacity <= 0:
        return pooled
    capacity = min(capacity, boxes.shape[1])
    if torch.compiler.is_exporting():
        # the branch sees its operands' shapes as symbols: pass the levels'
        # sizes in as ints
        level_hw = [(int(f.shape[1]), int(f.shape[2])) for f in features]

        def update(pooled, oow, boxes, lvl_idx, *features):
            rows, idx, new = _fallback_rows(pooled, oow, features, boxes, lvl_idx, strides,
                                            output_size, sampling_ratio, capacity, level_hw)
            return pooled.index_put((rows.expand_as(idx), idx), new)

        return torch.cond(oow.any(), update, lambda pooled, *_: pooled.clone(),
                          (pooled, oow, boxes, lvl_idx, *features))
    with tracing.span("roi.fallback"):
        per_image = oow.sum(1).tolist()
        tracing.count("roi.oow", sum(per_image))
        tracing.count("roi.oow_over_capacity", sum(max(n - capacity, 0) for n in per_image))
        if not any(per_image):
            return pooled
        rows, idx, new = _fallback_rows(pooled, oow, features, boxes, lvl_idx, strides, output_size,
                                        sampling_ratio, capacity)
        pooled[rows, idx] = new
        return pooled


def _fallback_rows(pooled, oow, features, boxes, lvl_idx, strides, output_size,
                   sampling_ratio, capacity, level_hw=None):
    """(rows, idx, values): the first ``capacity`` rows of each image by
    out-of-window flag and their new values, whole-map pooled where out of
    window and as they were elsewhere."""
    _, idx = topk_stable(oow.to(torch.int32), capacity)  # (B, cap), ties -> lower index
    rows = torch.arange(boxes.shape[0], device=boxes.device)[:, None]
    fb = wholemap_roi_align(
        features, boxes[rows, idx], lvl_idx[rows, idx], strides, output_size, sampling_ratio,
        level_hw,
    )
    sel = oow[rows, idx][..., None, None, None]
    return rows, idx, torch.where(sel, fb.to(pooled.dtype), pooled[rows, idx])
