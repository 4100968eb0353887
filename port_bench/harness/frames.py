"""The one traffic generator: synthetic frames and ground truth on the card,
from the run's seed and a traffic file's parameters.

Every seed gets the same multiset of sizes (image short sides, boxes per
image), in its own order, so that seeds change which pixels and boxes a
step sees and not how much work it is. Frames are FLIR ADAS-like scenes:
a background gradient with sensor noise and box-shaped warm objects,
resized (as the loader would) to the configuration's size and placed on the
padded canvas with zeros beyond the image.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

# FLIR ADAS box shapes in the 640x512 frame, per class: (w range, h range)
CLASS_SHAPES = {0: ((8.0, 48.0), (20.0, 120.0)),   # person: tall
                1: ((16.0, 72.0), (16.0, 64.0)),   # bicycle
                2: ((16.0, 200.0), (12.0, 120.0))}  # car: wide


def resized_hw(frame_hw: Sequence[int], short: int, max_size: int) -> Tuple[int, int]:
    """detectron2's ResizeShortestEdge of a frame to ``short``."""
    h, w = frame_hw
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def counts_multiset(n: int, spec: Mapping) -> List[int]:
    """``n`` boxes-per-image counts: the quantiles of a log-normal with the
    traffic's median and spread, clipped to [min, max] (heavy-tailed: most
    frames hold a few objects, some tens)."""
    q = (np.arange(n) + 0.5) / n
    z = np.sqrt(2.0) * _erfinv(2.0 * q - 1.0)
    c = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
    return [int(v) for v in np.clip(np.round(c), spec["min"], spec["max"])]


def _erfinv(y: np.ndarray) -> np.ndarray:
    return torch.erfinv(torch.as_tensor(y, dtype=torch.float64)).numpy()


def scene(gen, h: int, w: int, canvas: Tuple[int, int], channels: int, boxes: torch.Tensor,
          device) -> torch.Tensor:
    """One (H, W, channels) uint8 canvas: an (h, w) scene at its top-left,
    objects painted in ``boxes`` (K, 4) (image coordinates); middle fusion
    (6 channels) gets a BGR frame and a thermal frame of its own, with the
    objects warm at the same places, replicated to TTT."""
    hh, ww = canvas
    layers = 3 if channels == 3 else 4
    base = torch.linspace(60.0, 120.0, w, device=device)[None, :, None].expand(h, w, layers)
    noise = torch.randn((h, w, layers), generator=gen, device=device) * 8.0
    img = base + noise
    if boxes.numel():
        ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
        xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
        level = 130.0 + 110.0 * torch.rand((boxes.shape[0], layers), generator=gen, device=device)
        for k in range(boxes.shape[0]):
            x0, y0, x1, y1 = boxes[k]
            inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
            img = torch.where(inside[..., None], level[k], img)
    out = torch.zeros((hh, ww, channels), dtype=torch.uint8, device=device)
    img = img.clamp(0, 255).round().to(torch.uint8)
    if channels == 6:
        img = torch.cat([img[..., :3], img[..., 3:].expand(h, w, 3)], -1)
    out[:h, :w] = img[..., :channels]
    return out


def random_boxes(gen, n: int, hw: Tuple[int, int], frame_hw: Sequence[int], device,
                 class_p: Sequence[float] = (0.36, 0.05, 0.59)) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` FLIR-like boxes (XYXY in the (h, w) image) and their classes."""
    h, w = hw
    s = h / frame_hw[0]
    cls = torch.multinomial(torch.tensor(class_p, device=device), n, replacement=True, generator=gen)
    u = torch.rand((n, 4), generator=gen, device=device)
    lo = torch.tensor([[CLASS_SHAPES[int(c)][0][0], CLASS_SHAPES[int(c)][1][0]] for c in range(3)],
                      device=device)[cls]
    hi = torch.tensor([[CLASS_SHAPES[int(c)][0][1], CLASS_SHAPES[int(c)][1][1]] for c in range(3)],
                      device=device)[cls]
    bw_bh = (lo + (hi - lo) * u[:, :2]) * s
    x0 = u[:, 2] * (w - bw_bh[:, 0] - 1.0)
    y0 = u[:, 3] * (h - bw_bh[:, 1] - 1.0)
    boxes = torch.stack([x0, y0, x0 + bw_bh[:, 0], y0 + bw_bh[:, 1]], -1)
    return boxes, cls.to(torch.int32)


def inference_pool(seed: int, traffic: Mapping, inp: Mapping, channels: int, device) -> List[Dict]:
    """``traffic["pool_batches"]`` distinct batches of ``traffic["batch"]``
    frames at the test size, as ``Predictor.predict_batch`` takes them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    canvas = tuple(inp["pad_shape"])
    hw = resized_hw(inp["frame_hw"], inp["min_size_test"], inp["max_size_test"])
    n = traffic["batch"]
    pool = []
    for b in range(traffic["pool_batches"]):
        imgs = []
        for _ in range(n):
            boxes, _ = random_boxes(gen, traffic["objects_per_frame"], hw, inp["frame_hw"], device)
            imgs.append(scene(gen, hw[0], hw[1], canvas, channels, boxes, device))
        pool.append({"image": torch.stack(imgs),
                     "image_size": torch.tensor([hw] * n, dtype=torch.int32, device=device),
                     "orig_size": torch.tensor([tuple(inp["frame_hw"])] * n, dtype=torch.int32, device=device),
                     "image_id": list(range(b * n, (b + 1) * n))})
    return pool


def training_pool(seed: int, traffic: Mapping, inp: Mapping, channels: int, device) -> List[Dict]:
    """``traffic["pool_batches"]`` distinct training batches: short sides
    cycled through ``MIN_SIZE_TRAIN`` and the box counts' multiset, both in
    the seed's order; objects painted at the ground-truth boxes. Each batch
    holds "image" (N, H, W, C) uint8, "image_size" (N, 2) int32 and "gt":
    boxes (N, G, 4), classes (N, G) int32, valid (N, G) bool, valid first."""
    gen = torch.Generator(device=device).manual_seed(seed)
    canvas = tuple(inp["pad_shape"])
    n, nb, g = traffic["batch"], traffic["pool_batches"], inp["max_gt"]
    total = n * nb
    shorts = [inp["min_size_train"][i % len(inp["min_size_train"])] for i in range(total)]
    counts = counts_multiset(total, traffic["boxes_per_image"])
    order = torch.randperm(total, generator=gen, device=device).tolist()
    order2 = torch.randperm(total, generator=gen, device=device).tolist()
    pool = []
    for b in range(nb):
        imgs, sizes = [], []
        gb = torch.zeros((n, g, 4), device=device)
        gc = torch.zeros((n, g), dtype=torch.int32, device=device)
        gv = torch.zeros((n, g), dtype=torch.bool, device=device)
        for i in range(n):
            k = b * n + i
            hw = resized_hw(inp["frame_hw"], shorts[order[k]], inp["max_size_train"])
            m = min(counts[order2[k]], g)
            boxes, cls = random_boxes(gen, m, hw, inp["frame_hw"], device)
            imgs.append(scene(gen, hw[0], hw[1], canvas, channels, boxes, device))
            sizes.append(hw)
            gb[i, :m], gc[i, :m], gv[i, :m] = boxes, cls, True
        pool.append({"image": torch.stack(imgs),
                     "image_size": torch.tensor(sizes, dtype=torch.int32, device=device),
                     "gt": (gb, gc, gv)})
    return pool


def check_sample(seed: int, served: int, k: int) -> List[int]:
    """``k`` distinct indices of ``served`` items drawn from ``seed``."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    return sorted(rng.choice(served, size=min(k, served), replace=False).tolist())

