"""Box ops, delta decoding and NMS of ``proben_tpu_torch`` against
``proben_tpu`` on the CPU: the same numpy inputs through both packages.

Box arithmetic follows the JAX functions op for op, so boxes, IoUs and
decoded boxes agree to f32 rounding (rtol 1e-6) and NMS keep masks must
match exactly. The inputs carry the hazards NMS meets on the main path:
clustered boxes, exact score ties, padded (invalid) slots, NaN boxes and
class offsets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.ops.box_transform import SCALE_CLAMP as JAX_SCALE_CLAMP
from proben_tpu.ops.box_transform import apply_deltas as jax_apply_deltas
from proben_tpu.ops.nms import batched_nms_mask as jax_batched_nms_mask
from proben_tpu.ops.nms import nms_mask as jax_nms_mask
from proben_tpu.structures import boxes as jax_boxes
from nms_cases import THRESHOLDS, cell_problems, hazard_problems, planted_pair, planted_targets
from proben_tpu_torch.ops import nms as t_nms
from proben_tpu_torch.ops.box_transform import SCALE_CLAMP, apply_deltas
from proben_tpu_torch.ops.nms import batched_nms_mask, nms_mask
from proben_tpu_torch.ops.topk import topk_stable
from proben_tpu_torch.structures import boxes as t_boxes
from proben_tpu_torch.utils import tracing
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

T = torch.from_numpy


def _clustered(rng, n, centers=6, img=200.0):
    """Boxes jittered around a few centres, so many pairs overlap near the
    thresholds, with a few degenerate and NaN rows."""
    c = rng.rand(centers, 2) * img
    wh = rng.rand(centers, 2) * 60 + 10
    pick = rng.randint(0, centers, n)
    xy = c[pick] + rng.randn(n, 2) * 4
    sz = wh[pick] * (1 + rng.randn(n, 2) * 0.1)
    b = np.concatenate([xy, xy + sz], -1).astype(np.float32)
    b[3] = [50, 50, 50, 80]  # zero width
    b[7] = np.nan
    return b


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    n = 96
    boxes = _clustered(rng, n)
    scores = rng.rand(n).astype(np.float32)
    scores[10:20] = scores[10]  # exact ties
    scores[40:44] = 0.5
    valid = rng.rand(n) > 0.15
    classes = rng.randint(0, 3, n).astype(np.int32)
    return boxes, scores, valid, classes


def test_clip_nonempty_iou(data):
    boxes, _, _, _ = data
    b2 = boxes[::-1].copy()
    np.testing.assert_array_equal(
        t_boxes.clip_boxes(T(boxes), (120, 150)).numpy(),
        np.asarray(jax_boxes.clip_boxes(jnp.asarray(boxes), (120, 150))),
    )
    np.testing.assert_array_equal(
        t_boxes.nonempty_boxes(T(boxes), 2.0).numpy(),
        np.asarray(jax_boxes.nonempty_boxes(jnp.asarray(boxes), 2.0)),
    )
    np.testing.assert_allclose(
        t_boxes.pairwise_iou(T(boxes), T(b2)).numpy(),
        np.asarray(jax_boxes.pairwise_iou(jnp.asarray(boxes), jnp.asarray(b2))),
        rtol=1e-6, atol=0,
    )


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_apply_deltas(data, weights):
    boxes = data[0]
    rng = np.random.RandomState(1)
    deltas = (rng.randn(boxes.shape[0], 12) * 2).astype(np.float32)
    deltas[5, 2] = 40.0  # beyond the scale clamp
    assert SCALE_CLAMP == JAX_SCALE_CLAMP
    got = apply_deltas(T(deltas), T(boxes), weights).numpy()
    want = np.asarray(jax_apply_deltas(jnp.asarray(deltas), jnp.asarray(boxes), weights))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_mask_exact(data, thresh):
    boxes, scores, valid, _ = data
    got = nms_mask(T(boxes), T(scores), T(valid), thresh).numpy()
    want = np.asarray(jax_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thresh))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 5 and not got[~valid].any()


def test_nms_batched_over_leading_dims(data):
    """One batched call over (images, levels) equals per-problem JAX calls."""
    boxes, scores, valid, _ = data
    rng = np.random.RandomState(2)
    bb = np.stack([boxes, boxes + rng.randn(*boxes.shape).astype(np.float32) * 3])
    ss = np.stack([scores, rng.rand(*scores.shape).astype(np.float32)])
    vv = np.stack([valid, valid[::-1].copy()])
    bb, ss, vv = bb[:, None].repeat(2, 1), ss[:, None].repeat(2, 1), vv[:, None].repeat(2, 1)
    got = nms_mask(T(bb), T(ss), T(vv), 0.6).numpy()
    for i in range(2):
        for j in range(2):
            want = np.asarray(jax_nms_mask(jnp.asarray(bb[i, j]), jnp.asarray(ss[i, j]),
                                           jnp.asarray(vv[i, j]), 0.6))
            np.testing.assert_array_equal(got[i, j], want)


def test_batched_nms_class_offsets(data):
    boxes, scores, valid, classes = data
    got = batched_nms_mask(T(boxes), T(scores), T(classes), T(valid), 0.5).numpy()
    want = np.asarray(jax_batched_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                           jnp.asarray(classes), jnp.asarray(valid), 0.5))
    np.testing.assert_array_equal(got, want)


def _composition(sboxes, svalid, t):
    """What ``nms_mask`` ran between its sort and its scatter before
    ``proben::nms_keep``: the IoUs, the suppression mask, the fixpoint."""
    n = sboxes.shape[-2]
    iou = t_boxes.pairwise_iou(sboxes, sboxes)
    tri = torch.ones(n, n, dtype=torch.bool).triu(1)
    suppress = (iou > t) & tri & svalid[..., :, None] & svalid[..., None, :]
    return torch.ops.proben.nms_fixpoint(suppress, svalid)


def _sorted(boxes, scores, valid):
    """``nms_mask``'s sort and gather: (sorted boxes, sorted valid)."""
    captured = {}

    def capture(sboxes, svalid, t):
        captured["args"] = (sboxes, svalid)
        return torch.zeros_like(svalid)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(t_nms, "nms_keep", capture)
        nms_mask(boxes, scores, valid, 0.5)
    return captured["args"]


@pytest.mark.parametrize("t", THRESHOLDS)
def test_nms_keep_cpu_route_is_the_old_composition(t):
    """``proben::nms_keep`` on CPU tensors equals the composition it
    replaced in ``nms_mask`` bit for bit, at the hazards and at a cell's
    box-head shape (cut to 2 images); it launches nothing."""
    before = tracing.counters().get("k5.launches", 0)
    boxes, scores, valid = hazard_problems(65, t)
    cases = [(T(boxes), T(scores), T(valid))]
    boxes, scores, valid, ids = cell_problems((2, 600), seed=1, classes=3)
    cases.append((T(boxes) + T(ids)[..., None] * 8193.0, T(scores), T(valid)))
    for b, s, v in cases:
        sboxes, svalid = _sorted(b, s, v)
        got = torch.ops.proben.nms_keep(sboxes, svalid, t)
        assert torch.equal(got, _composition(sboxes, svalid, t))
        assert torch.equal(t_nms.nms_keep(sboxes, svalid, t), got)
    assert tracing.counters().get("k5.launches", 0) == before


def test_nms_keep_opcheck():
    boxes, scores, valid = hazard_problems(20, 0.5)
    sboxes, svalid = _sorted(T(boxes), T(scores), T(valid))
    torch.library.opcheck(torch.ops.proben.nms_keep.default, (sboxes, svalid, 0.5))


def test_nms_keep_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        t_nms.nms_keep(torch.zeros(3, 4, device="meta"), torch.ones(3, dtype=torch.bool, device="meta"), 0.5)


@pytest.mark.parametrize("t", THRESHOLDS)
def test_nms_suppresses_only_above_the_float32_threshold(t):
    """A pair planted at IoU float32(t) and one ulp either side: only the
    ulp above suppresses, as ``iou > t`` on float32 IoUs reads t (0.3 rounds
    up in float32, so the pair at float32(0.3) > 0.3 survives)."""
    for target, suppressed in zip(planted_targets(t), (False, False, True)):
        a, b = planted_pair(target)
        keep = nms_mask(T(np.stack([a, b])), T(np.array([0.9, 0.8], np.float32)),
                        torch.ones(2, dtype=torch.bool), t)
        assert keep.tolist() == [True, not suppressed], (t, target)


def _k5_words(b, v, thr, rng):
    """K5's mask pass on one problem: (n, nb) u64 words, bit k of word c of
    row i set iff box 64 c + k is later than box i, both are valid and their
    float32 IoU (the kernel's steps: NaN-propagating min / max / clamp,
    ``inter > 0 ? inter / (union > 0 ? union : 1) : 0``) is above ``thr``.
    Words left of the diagonal block, which the kernel never writes, hold
    noise."""
    n = len(b)
    nb = -(-n // 64)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iw = np.minimum(b[:, None, 2], b[None, :, 2]) - np.maximum(b[:, None, 0], b[None, :, 0])
    ih = np.minimum(b[:, None, 3], b[None, :, 3]) - np.maximum(b[:, None, 1], b[None, :, 1])
    inter = np.where(iw < 0, np.float32(0), iw) * np.where(ih < 0, np.float32(0), ih)
    union = (area[:, None] + area[None, :]) - inter
    iou = np.where(inter > 0, inter / np.where(union > 0, union, np.float32(1)), np.float32(0))
    assert iou.dtype == np.float32
    bits = (iou > thr) & np.triu(np.ones((n, n), bool), 1) & v[:, None] & v[None, :]
    bits = np.pad(bits, ((0, 0), (0, nb * 64 - n))).reshape(n, nb, 64)
    words = np.packbits(bits, axis=-1, bitorder="little").view("<u8")[..., 0].copy()
    lower = np.arange(nb)[None, :] < (np.arange(n) // 64)[:, None]
    words[lower] = rng.randint(0, 2 ** 63, lower.sum(), dtype=np.int64).astype(np.uint64)
    return [[int(w) for w in row] for row in words]


def _k5_sweep(words, v):
    """K5's sweep on one problem: for each 64-box block in order, the
    candidates (valid, not removed) resolved greedily against their
    diagonal words, then the kept rows' words for later blocks ORed into
    ``removed``. The keep mask, in the sorted order."""
    n = len(v)
    nb = -(-n // 64)
    removed, kept = [0] * nb, [0] * nb
    for blk in range(nb):
        rows = range(blk * 64, min(n, blk * 64 + 64))
        vw = sum(1 << (i - blk * 64) for i in rows if v[i])
        left, kw = vw & ~removed[blk], 0
        while left:
            k = (left & -left).bit_length() - 1
            kw |= 1 << k
            left &= ~words[blk * 64 + k][blk]
            left &= left - 1
        kept[blk] = kw
        for c in range(blk + 1, nb):
            for r in range(64):
                if kw >> r & 1:
                    removed[c] |= words[blk * 64 + r][c]
    return np.array([kept[i // 64] >> (i % 64) & 1 for i in range(n)], bool)


def _k5_emulated(sboxes, svalid, t):
    rng = np.random.RandomState(0)
    b, v = sboxes.numpy(), svalid.numpy()
    flat_b, flat_v = b.reshape(-1, *b.shape[-2:]), v.reshape(-1, v.shape[-1])
    with np.errstate(invalid="ignore", over="ignore"):
        keep = [_k5_sweep(_k5_words(bb, vv, np.float32(t), rng), vv) for bb, vv in zip(flat_b, flat_v)]
    return torch.from_numpy(np.stack(keep).reshape(v.shape))


@pytest.mark.parametrize("n", [1, 63, 64, 65, 624, 1000])
def test_k5_emulation_equals_nms_mask(n):
    """A numpy emulation of K5's two passes (u64 words, the block-by-block
    sweep) in ``nms_mask`` equals the plain route on suppression chains as
    long as the problem, ties, IoUs planted at float32(t) and one ulp either
    side, NaN / inf / degenerate boxes and problems with no valid box."""
    for t in THRESHOLDS:
        boxes, scores, valid = (T(a) for a in hazard_problems(n, t, seed=n))
        want = nms_mask(boxes, scores, valid, t)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(t_nms, "nms_keep", _k5_emulated)
            got = nms_mask(boxes, scores, valid, t)
        assert torch.equal(got, want), (n, t)
        if n > 64:  # the chain through the whole problem: every other box
            assert want[0].tolist() == [i % 2 == 0 for i in range(n)]


def test_topk_stable_tie_order():
    x = np.array([[0.5, -1.0, 0.5, -1.0, 0.9, -1.0, 0.5]], np.float32)
    vals, idx = topk_stable(T(x), 6)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
