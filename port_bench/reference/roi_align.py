"""ROIAlignV2 (detectron2 ``ROIAlign(aligned=True)``, adaptive sampling
when the ratio is 0) over an FPN, per image.

Bilinear interpolation and the average over a bin's sample grid both
factor into a row part and a column part, so a RoI's pooled map is
``Ay @ F @ Ax^T`` with ``Ay`` (P, H) the summed row weights of its samples
and ``Ax`` (P, W) the column weights: the same numbers as sampling each
point, in another order of summation.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .boxes import fpn_level

CHUNK_BYTES = 1 << 28  # of the (rois, P, C, W) intermediate


def axis_weights(start, span, p: int, ratio: int, dim: int) -> torch.Tensor:
    """(K, P, dim) weights of one axis: ``start`` (K,) the RoI's first edge
    in map coordinates (already shifted by -0.5), ``span`` (K,) its extent."""
    bin_sz = span / p
    grid = torch.full_like(span, float(ratio)) if ratio > 0 else torch.ceil(bin_sz)
    gmax = max(int(grid.max().item()) if grid.numel() else 1, 1)
    g = grid.clamp(min=1.0)[:, None, None]
    i = torch.arange(gmax, device=span.device, dtype=span.dtype)[None, None, :]
    pp = torch.arange(p, device=span.device, dtype=span.dtype)[None, :, None]
    coord = start[:, None, None] + (pp + (i + 0.5) / g) * bin_sz[:, None, None]
    keep = (i < grid[:, None, None]) & (coord >= -1.0) & (coord <= dim)
    c = coord.clamp(min=0.0)
    lo = torch.floor(c)
    edge = lo >= dim - 1
    lo = torch.where(edge, float(dim - 1), lo)
    frac = torch.where(edge, 0.0, c - lo)
    hi = torch.where(edge, lo, lo + 1.0)
    share = keep.to(span.dtype) / g
    w = torch.zeros(span.shape[0], p, dim, device=span.device, dtype=span.dtype)
    w.scatter_add_(2, lo.long().clamp(0, dim - 1), (1.0 - frac) * share)
    w.scatter_add_(2, hi.long().clamp(0, dim - 1), frac * share)
    return w


def roi_align_level(f: torch.Tensor, boxes: torch.Tensor, scale: float, p: int, ratio: int):
    """``f`` (C, H, W), ``boxes`` (K, 4) in image coordinates -> (K, C, P, P)."""
    c, h, w = f.shape
    b = boxes * scale
    wy = axis_weights(b[:, 1] - 0.5, b[:, 3] - b[:, 1], p, ratio, h)
    wx = axis_weights(b[:, 0] - 0.5, b[:, 2] - b[:, 0], p, ratio, w)
    rows = f.transpose(0, 1).reshape(h, c * w)
    step = max(1, CHUNK_BYTES // (p * c * w * 4))
    out = []
    for s in range(0, boxes.shape[0], step):
        t = torch.matmul(wy[s:s + step].reshape(-1, h), rows)
        t = t.reshape(-1, p, c, w)
        out.append(torch.einsum("kpcw,kqw->kcpq", t, wx[s:s + step]))
    return torch.cat(out) if out else f.new_zeros((0, c, p, p))


def multilevel_roi_align(levels: Sequence[torch.Tensor], boxes: torch.Tensor, strides: Sequence[int],
                         p: int, ratio: int, min_level: int = 2) -> torch.Tensor:
    """One image: ``levels`` p2..p5 maps (C, H_l, W_l), ``boxes`` (K, 4) ->
    (K, C, P, P), each box pooled on its FPN level."""
    lvl = fpn_level(boxes, min_level, min_level + len(levels) - 1) - min_level
    c = levels[0].shape[0]
    out = levels[0].new_zeros((boxes.shape[0], c, p, p))
    parts: List = []
    for i, (f, s) in enumerate(zip(levels, strides)):
        idx = torch.nonzero(lvl == i).flatten()
        if idx.numel():
            parts.append((idx, roi_align_level(f, boxes[idx], 1.0 / s, p, ratio)))
    return out.index_put((torch.cat([i for i, _ in parts]),), torch.cat([v for _, v in parts])) \
        if parts else out
