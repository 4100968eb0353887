"""NMS problems for the tests of ``ops/nms.py`` on the CPU and on the card:
suppression chains as long as the problem, exact score ties, IoUs planted
at the float32 threshold and one ulp either side of it, NaN, infinite and
degenerate boxes, problems with no valid box, and boxes shaped like the
cells' RPN and box-head candidates. numpy in, numpy out; no JAX, so the
card-only tests can import it.
"""

import itertools

import numpy as np
import torch

from proben_tpu_torch.structures.boxes import pairwise_iou

THRESHOLDS = (0.3, 0.5, 0.7)  # float32 rounds 0.3 up, 0.7 down, 0.5 not at all


def _ulps_around(x, steps):
    """``x`` and the ``steps`` float32 values on either side of it."""
    out, up, dn = [np.float32(x)], np.float32(x), np.float32(x)
    for _ in range(steps):
        up, dn = np.nextafter(up, np.float32(np.inf)), np.nextafter(dn, np.float32(-np.inf))
        out += [up, dn]
    return np.array(out, np.float32)


def planted_pair(target):
    """Two boxes near the origin, the second inside the first and as tall,
    whose float32 IoU (``pairwise_iou``) is exactly ``target``: the second
    box's right edge searched over float32 steps, for a few widths."""
    for w, h in itertools.product((40.0, 37.0, 23.0, 11.0, 7.5), (30.0, 13.0)):
        a = np.array([0.0, 5.0, w, 5.0 + h], np.float32)
        x2 = _ulps_around(w * float(target), 4000)
        b = np.stack([np.zeros_like(x2), np.full_like(x2, 5.0), x2, np.full_like(x2, 5.0 + h)], -1)
        iou = pairwise_iou(torch.from_numpy(a[None]), torch.from_numpy(b))[0].numpy()
        hit = np.nonzero(iou == np.float32(target))[0]
        if len(hit):
            return a, b[hit[0]]
    raise AssertionError(f"no box pair at IoU {target!r}")


def planted_targets(t):
    """float32(t) and the float32 values one ulp below and above it."""
    f = np.float32(t)
    return [np.nextafter(f, np.float32(0)), f, np.nextafter(f, np.float32(1))]


def chain(n, t, x0=0.0, w=10.0):
    """``n`` boxes along x, each overlapping the next above ``t`` and the
    one after it at or below: greedy by descending score keeps every other
    box, a suppression chain of length ``n - 1``."""
    d = 0.75 * w * (1 - t) / (1 + t)
    x = x0 + d * np.arange(n, dtype=np.float64)
    return np.stack([x, np.zeros(n), x + w, np.full(n, w)], -1).astype(np.float32)


HAZARDS = np.array([
    [np.nan, 0, 10, 10], [0, np.nan, 10, 10], [0, 0, np.nan, 10], [0, 0, 10, np.nan],
    [-np.inf, 0, np.inf, 10], [-np.inf, 0, np.inf, 10],  # infinite: their union is NaN
    [0, 0, np.inf, np.inf], [np.inf, 0, np.inf, 10], [3, 3, 3, 9], [3, 3, 9, 3],
    [9, 9, 3, 3], [0, 0, 10, 10], [0, 0, 10, 10], [-5, -5, 4, 4],
], np.float32)


def clustered(rng, n, img=(800.0, 1000.0), objects=30, tie_share=0.1):
    """Boxes jittered around ``objects`` centres on an image, so that many
    pairs overlap near every threshold, with scores in (0, 1) of which a
    share ties exactly."""
    c = rng.rand(objects, 2) * np.array(img[::-1])
    wh = rng.rand(objects, 2) * 150 + 8
    pick = rng.randint(0, objects, n)
    xy = c[pick] + rng.randn(n, 2) * wh[pick] * 0.08
    sz = wh[pick] * (1 + rng.randn(n, 2) * 0.08)
    boxes = np.concatenate([xy, xy + sz], -1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    ties = rng.rand(n) < tie_share
    scores[ties] = scores[ties][0] if ties.any() else 0.5
    return boxes, scores


def hazard_problems(n, t, seed=0):
    """(P, n) problems for one threshold: a chain through the whole
    problem; a chain of half its length beside clustered boxes; clustered
    boxes with ties, the hazard rows and invalid slots (a valid box with a
    NaN score among them); pairs planted at float32(t) and one ulp either
    side (each pair alone in its problem, near the origin, where the
    float32 grid is fine); a problem with no valid box. Returns boxes
    (P, n, 4), scores (P, n), valid (P, n)."""
    rng = np.random.RandomState(seed)
    probs = []
    scores_desc = np.linspace(1.0, 0.01, n, dtype=np.float32)
    probs.append((chain(n, t), scores_desc.copy(), np.ones(n, bool)))
    b, s = clustered(rng, n)
    half = n // 2
    b[:half] = chain(half, t, x0=2000.0)
    s[:half] = np.linspace(1.0, 0.5, half, dtype=np.float32)
    probs.append((b, s, rng.rand(n) > 0.1))
    b, s = clustered(rng, n)
    k = min(n, len(HAZARDS))
    b[:k] = HAZARDS[:k]
    s[rng.rand(n) < 0.3] = 0.25
    v = rng.rand(n) > 0.2
    if n > 3:
        s[n // 2] = np.nan
        v[n // 2] = True
    probs.append((b, s, v))
    for target in planted_targets(t):
        b, s = clustered(rng, n)
        b += 3000.0  # away from the pair
        if n >= 2:
            b[0], b[1] = planted_pair(target)
            s[0], s[1] = 2.0, 1.5
        probs.append((b, s, np.ones(n, bool)))
    b, s = clustered(rng, n)
    probs.append((b, s, np.zeros(n, bool)))
    return tuple(np.stack(x) for x in zip(*probs))


def cell_problems(shape, seed=0, classes=0):
    """Candidates shaped like a cell's NMS call: ``shape`` = (images,
    levels, N) for the RPN (every slot valid but the empty boxes), (images,
    N) for the box head (a share above the score threshold, class ids in
    ``[0, classes)`` for the coordinate-offset trick). Returns boxes,
    scores, valid and the class ids (None for the RPN)."""
    rng = np.random.RandomState(seed)
    *lead, n = shape
    total = int(np.prod(lead))
    bs, ss = zip(*(clustered(rng, n, objects=rng.randint(5, 60)) for _ in range(total)))
    boxes = np.stack(bs).reshape(*lead, n, 4)
    scores = np.stack(ss).reshape(*lead, n)
    boxes = np.clip(boxes, 0, [1000, 800, 1000, 800]).astype(np.float32)
    valid = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    ids = None
    if classes:
        ids = rng.randint(0, classes, (*lead, n)).astype(np.int32)
        valid &= scores > 0.3
    return boxes, scores, valid, ids
