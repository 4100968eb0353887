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
from proben_tpu_torch.ops.box_transform import SCALE_CLAMP, apply_deltas
from proben_tpu_torch.ops.nms import batched_nms_mask, nms_mask
from proben_tpu_torch.ops.topk import topk_stable
from proben_tpu_torch.structures import boxes as t_boxes
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


def test_topk_stable_tie_order():
    x = np.array([[0.5, -1.0, 0.5, -1.0, 0.9, -1.0, 0.5]], np.float32)
    vals, idx = topk_stable(T(x), 6)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
