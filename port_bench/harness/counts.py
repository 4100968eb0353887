"""The benchmark's own operation and byte counts.

Model FLOPs: 2 x the multiply-adds of every convolution and linear layer at
the cell's shapes (elementwise work, pooling, RoIAlign and NMS count 0).
Training adds each layer's weight gradient where the layer trains, and its
input gradient where the input carries a gradient (above the frozen stages).

Kernel counts, per call, from the inputs that call was given: each input
byte read once and each output byte written once, and the multiply-adds the
data needs. A kernel's least time is the larger of its operations over the
bf16 peak and its bytes over the HBM rate.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple

import torch

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate
PEAK_BF16 = 989e12
HBM_BYTES_S = 3.35e12
STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STAGE_OUT = (256, 512, 1024, 2048)

# one layer: (name, multiply-adds per image, trains, input carries a gradient)
Layer = Tuple[str, float, bool, bool]


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def layers(model: Mapping, canvas: Sequence[int], rois: int, training: bool) -> List[Layer]:
    """Every conv and linear layer of one image's forward pass."""
    freeze = model["freeze_at"] if training else 0
    dual = model["input_format"] == "BGRTTT"
    cin0 = 3 if dual else {"BGR": 3, "BGRT": 4}[model["input_format"]]
    out: List[Layer] = []
    f = model["fpn_channels"]
    sizes = None
    for bb in ("backbone", "backbone_2") if dual else ("backbone",):
        h, w = _out(canvas[0], 7, 2, 3), _out(canvas[1], 7, 2, 3)
        out.append((f"{bb}.stem", 64 * cin0 * 49 * h * w, freeze < 1, False))
        h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
        c_in, width, grad_in = 64, 64, freeze < 1
        sizes = []
        for i, (n, c_out) in enumerate(zip(STAGE_BLOCKS[model["depth"]], STAGE_OUT)):
            trains = freeze < i + 2
            for b in range(n):
                s = 2 if b == 0 and i > 0 else 1
                ho, wo = _out(h, 1, s, 0), _out(w, 1, s, 0)
                key = f"{bb}.res{i + 2}.{b}"
                out.append((f"{key}.conv1", c_in * width * ho * wo, trains, grad_in))
                out.append((f"{key}.conv2", width * width * 9 * ho * wo, trains, trains))
                out.append((f"{key}.conv3", width * c_out * ho * wo, trains, trains))
                if b == 0:
                    out.append((f"{key}.shortcut", c_in * c_out * ho * wo, trains, grad_in))
                h, w, c_in = ho, wo, c_out
                grad_in = trains
            sizes.append((h, w, grad_in))
            width *= 2
        for i, ((h, w, g), c) in enumerate(zip(sizes, STAGE_OUT)):
            out.append((f"{bb}.fpn_lateral{i + 2}", c * f * h * w, True, g))
            out.append((f"{bb}.fpn_output{i + 2}", f * f * 9 * h * w, True, True))
    levels = [(h, w) for h, w, _ in sizes] + [((sizes[-1][0] - 1) // 2 + 1, (sizes[-1][1] - 1) // 2 + 1)]
    c = f * (2 if dual else 1)
    a = len(model["anchor_aspect_ratios"])
    hw = sum(h * w for h, w in levels)
    out.append(("rpn.conv", c * c * 9 * hw, True, True))
    out.append(("rpn.objectness_deltas", c * 5 * a * hw, True, True))
    p, fc, k = model["roi"]["pooler_resolution"], model["roi"]["fc_dim"], model["num_classes"]
    out.append(("box_head.fc1", rois * c * p * p * fc, True, True))
    out.append(("box_head.fc2", rois * fc * fc, True, True))
    out.append(("box_predictor", rois * fc * (k + 1 + 4 * k), True, True))
    return out


def flops_per_image(model: Mapping, canvas: Sequence[int], rois: int, training: bool) -> float:
    """Model FLOPs of one image: forward, and in training the backward's
    weight and input gradients where the freeze needs them."""
    total = 0.0
    for _, macs, trains, grad_in in layers(model, canvas, rois, training):
        total += 2.0 * macs
        if training:
            total += 2.0 * macs * (int(trains) + int(grad_in))
    return total


def least_seconds(flops: float, nbytes: float) -> Tuple[float, str]:
    """The larger of the two bounds, and which it is."""
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def stem_counts(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                out: torch.Tensor) -> Tuple[float, float]:
    """K1 (``proben::stem_pool``): the 7x7/2 conv's products over (N, H, W,
    C) ``x``; the input, weights and affine read once, the pooled map
    written once."""
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    hs, ws = (h - 1) // 2 + 1, (wd - 1) // 2 + 1
    flops = 2.0 * n * hs * ws * o * kh * kw * c
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, scale, bias, out))
    return flops, float(nbytes)


def roi_align_fwd_counts(features: Sequence[torch.Tensor], lvl_idx, y0, x0, wy, wx, rois_per_image: int,
                         out: torch.Tensor) -> Tuple[float, float]:
    """K2 (``proben::roi_align_fwd``): the distinct feature pixels under a
    nonzero weight of some RoI, the weights and origins read once, the
    pooled rows written once; per channel, the row pass over the nonzero
    ``wy`` taps at every used column and the column pass over the nonzero
    ``wx`` taps per output row."""
    p, c = wy.shape[1], features[0].shape[-1]
    nbytes = (out.numel() * out.element_size() + wy.numel() * wy.element_size()
              + wx.numel() * wx.element_size() + 4 * (lvl_idx.numel() + y0.numel() + x0.numel())
              + needed_feature_bytes(features, lvl_idx, y0, x0, wy, wx, rois_per_image))
    ny = (wy != 0).sum(dim=(1, 2)).double()
    ncol = (wx != 0).any(dim=1).sum(dim=1).double()
    nx = (wx != 0).sum(dim=(1, 2)).double()
    flops = 2.0 * c * float((ncol * ny + p * nx).sum())
    return flops, float(nbytes)


def roi_align_bwd_counts(g: torch.Tensor, shapes: Sequence[int], lvl_idx, y0, x0, wy, wx,
                         rois_per_image: int, out: Sequence[torch.Tensor]) -> Tuple[float, float]:
    """K3 (``proben::roi_align_bwd``): the cotangent, weights and origins
    read once, every gradient map written once; per channel, P products for
    each nonzero ``wy`` tap, then one per nonzero ``wx`` tap for every row
    with a nonzero ``wy`` tap."""
    p, c = wy.shape[1], g.shape[-1]
    nbytes = (g.numel() * g.element_size() + wy.numel() * wy.element_size()
              + wx.numel() * wx.element_size() + 4 * (lvl_idx.numel() + y0.numel() + x0.numel())
              + sum(t.numel() * t.element_size() for t in out))
    nnz_y = (wy != 0).sum(dim=(1, 2)).double()
    rows = (wy != 0).any(dim=1).sum(dim=1).double()
    nnz_x = (wx != 0).sum(dim=(1, 2)).double()
    flops = 2.0 * c * float((p * nnz_y + rows * nnz_x).sum())
    return flops, float(nbytes)


def needed_feature_bytes(features, lvl_idx, y0, x0, wy, wx, rois_per_image: int) -> int:
    """Bytes of the distinct feature pixels under a nonzero weight: what
    this call's RoIs need the kernel to read."""
    rows = (wy != 0).any(dim=1)
    cols = (wx != 0).any(dim=1)
    img = torch.arange(lvl_idx.shape[0], device=lvl_idx.device) // rois_per_image
    total = 0
    for li, f in enumerate(features):
        b, hl, wl, c = f.shape
        sel = (lvl_idx == li).nonzero().flatten()
        if sel.numel() == 0:
            continue
        mask = torch.zeros(b * hl * wl, dtype=torch.bool, device=f.device)
        for s in range(0, sel.numel(), 1024):
            r = sel[s:s + 1024]
            yy = y0[r, None].long() + torch.arange(rows.shape[1], device=f.device)
            xx = x0[r, None].long() + torch.arange(cols.shape[1], device=f.device)
            need = rows[r][:, :, None] & cols[r][:, None, :]
            need &= (yy < hl)[:, :, None] & (xx < wl)[:, None, :]
            flat = (img[r, None, None] * hl + yy[:, :, None]) * wl + xx[:, None, :]
            mask[flat[need]] = True
        total += int(mask.sum()) * c * f.element_size()
    return total


KERNEL_COUNTS = {
    "proben::stem_pool": lambda args, out: stem_counts(*args, out),
    "proben::roi_align_fwd": lambda args, out: roi_align_fwd_counts(*args, out),
    "proben::roi_align_bwd": lambda args, out: roi_align_bwd_counts(*args, out),
}


def kernel_least_seconds(name: str, args: tuple, out) -> float:
    flops, nbytes = KERNEL_COUNTS[name](args, out)
    return least_seconds(flops, nbytes)[0]


def mfu_pct(flops_per_image: float, img_s: float) -> float:
    return 100.0 * flops_per_image * img_s / PEAK_BF16

