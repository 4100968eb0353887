"""COCO-style run-length encoding for binary masks — pure numpy (a copy of
``proben_tpu/evaluation/rle.py``: the compressed strings are the same bytes).

Replaces the reference's Cython ``detectron2/pycocotools/_mask.pyx`` (a wrap
of COCO's maskApi.c, present but unbuilt in the reference) for the mask
utilities the evaluation stack may need: encode/decode (compressed LEB128-ish
COCO string format), area, bbox, and IoU (with crowd semantics)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def encode(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> COCO RLE dict (column-major counts, compressed)."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).ravel(order="F")
    # run lengths, starting with a (possibly zero-length) run of 0s
    diffs = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate(([0], diffs, [len(flat)]))
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": _compress(counts)}


def decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _decompress(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T  # column-major


def area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _decompress(counts)
    return int(sum(counts[1::2]))


def to_bbox(rle: Dict) -> np.ndarray:
    """RLE -> XYWH bbox."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return np.zeros(4)
    return np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1], float)


def iou(dt: Sequence[Dict], gt: Sequence[Dict], iscrowd: Sequence[int]) -> np.ndarray:
    """Mask IoU matrix; crowd gt -> intersection / dt area."""
    out = np.zeros((len(dt), len(gt)))
    dms = [decode(r).astype(bool) for r in dt]
    gms = [decode(r).astype(bool) for r in gt]
    for i, dm in enumerate(dms):
        for j, gm in enumerate(gms):
            inter = np.logical_and(dm, gm).sum()
            if iscrowd[j]:
                denom = dm.sum()
            else:
                denom = np.logical_or(dm, gm).sum()
            out[i, j] = inter / denom if denom else 0.0
    return out


# -- COCO compressed counts string (the maskApi LEB128 variant) -------------


def _compress(counts: List[int]) -> str:
    """COCO's modified LEB128 with delta encoding from the 3rd run on."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _decompress(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, bytes):
        s = s.decode()
    counts: List[int] = []
    pos = 0
    while pos < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[pos]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            pos += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts
