"""The port's ``structures`` (masks, keypoints, rotated boxes, ``pairwise_ioa``,
``box_centers``) and ``utils`` (env, analysis, memory, serialize, the
visualizers) against ``proben_tpu``'s on the CPU, on the same numpy inputs;
the cases of tests/test_structures_extra.py, tests/test_utils.py and the
visualizer cases of tests/test_compat_video_vis.py and
tests/test_misc_components.py, plus seeded random ones. No JAX model is
compiled here.

Tolerances. Exact where both packages run the same numpy or cv2 code, or
the same float32 operations in the same order: ``pairwise_ioa`` and
``box_centers``, ``rasterize`` and the polygon areas, ``BitMasks``, the
thresholded pasted masks, keypoint indices and flags, rotated areas and
angles, ``pairwise_iou_rotated`` (numpy float64 in both), parameter counts
and tables, and every visualizer image. rtol 1e-6 where a transcendental or
a softmax may round differently in XLA and in PyTorch: the pasted float
values (the same operations, one ulp of slack),
decoded keypoint coordinates and scores, rotated corners (cos/sin, atol
1e-5 at coordinates up to 100). FLOPs: ``flop_count``'s rule (products and
convolutions, every tap of a convolution counted, NMS nothing) is exact against its
formula; XLA's count (JAX's ``flop_count``) skips the taps that fall in a
convolution's zero padding, so the two agree exactly on products and on
convolutions without padding, and differ by the padded taps otherwise
(computed here).
"""

import logging
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import proben_tpu.utils as jax_utils
from proben_tpu.structures import boxes as jax_boxes
from proben_tpu.structures import keypoints as jax_kp
from proben_tpu.structures import masks as jax_masks
from proben_tpu.structures import rotated_boxes as jax_rot
from proben_tpu.utils import analysis as jax_analysis
from proben_tpu.utils import env as jax_env
from proben_tpu.utils.video_visualizer import VideoVisualizer as JaxVideoVisualizer
from proben_tpu.utils.visualizer import PaperVisualizer as JaxPaperVisualizer
from proben_tpu.utils.visualizer import Visualizer as JaxVisualizer
import proben_tpu_torch.structures as structures
import proben_tpu_torch.utils as utils
from proben_tpu_torch.models import build_config, build_model, init_rcnn
from proben_tpu_torch.models import rcnn as t_rcnn
from proben_tpu_torch.ops import roi_align, roi_align_cuda, stem_cuda
from proben_tpu_torch.structures import keypoints as kp
from proben_tpu_torch.structures import masks
from proben_tpu_torch.structures import rotated_boxes as rot
from proben_tpu_torch.utils import analysis, env, memory, serialize
from proben_tpu_torch.utils.video_visualizer import VideoVisualizer
from proben_tpu_torch.utils.visualizer import PaperVisualizer, Visualizer
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)


def _boxes(rng, n, lo=-10.0, span=80.0):
    xy = rng.rand(n, 2) * span + lo
    return np.concatenate([xy, xy + rng.rand(n, 2) * 40], 1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# structures
# ---------------------------------------------------------------------------


def test_exports_match_jax():
    import proben_tpu.structures as jax_structures

    assert sorted(structures.__all__) == sorted(jax_structures.__all__)
    assert sorted(utils.__all__) == sorted(jax_utils.__all__)


def test_pairwise_ioa_and_box_centers_equal_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    b[1, 2:] = b[1, :2]  # a degenerate box: 0, never NaN
    a[2] = [200, 200, 210, 210]  # meets nothing
    got = structures.pairwise_ioa(_t(a), _t(b)).numpy()
    want = np.asarray(jax_boxes.pairwise_ioa(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not got[2].any() and not got[:, 1].any() and got.max() > 0
    assert np.array_equal(structures.box_centers(_t(a)).numpy(),
                          np.asarray(jax_boxes.box_centers(jnp.asarray(a))))
    batched = structures.pairwise_ioa(_t(np.stack([a, a])), _t(np.stack([b, b])))
    assert torch.equal(batched[1], torch.from_numpy(got))


def test_polygon_masks_equal_jax():
    """tests/test_structures_extra.py's square and random polygons (several
    per instance): ``rasterize`` and ``area`` exactly."""
    rng = np.random.RandomState(1)
    polys = [[np.array([10, 10, 30, 10, 30, 30, 10, 30])]]
    polys += [[rng.rand(2 * k) * 60 for k in (3, 5)] for _ in range(4)]
    boxes = np.concatenate([[[10.0, 10.0, 30.0, 30.0]], _boxes(rng, 4, 0.0, 40.0)])
    boxes[2, 2] = boxes[2, 0]  # a zero-width box (clamped to 0.1)
    got, want = masks.PolygonMasks(polys), jax_masks.PolygonMasks(polys)
    for size in (8, 28):
        assert np.array_equal(got.rasterize(boxes, size), want.rasterize(boxes, size))
    assert np.array_equal(got.area(), want.area()) and got.area()[0] == 400.0
    assert masks.PolygonMasks(polys[:1]).rasterize(boxes[:1], 8).mean() > 0.9


def test_bit_masks_equal_jax():
    t = np.zeros((3, 10, 12), bool)
    t[0, 2:5, 3:7] = True
    t[2, 9, 0] = t[2, 0, 11] = True
    got, want = masks.BitMasks(_t(t)), jax_masks.BitMasks(t)
    assert np.array_equal(got.area().numpy(), want.area()) and got.area().tolist() == [12, 0, 2]
    assert np.array_equal(got.nonempty().numpy(), want.nonempty())
    assert np.array_equal(got.get_bounding_boxes(), want.get_bounding_boxes())
    assert np.array_equal(masks.BitMasks(t).get_bounding_boxes()[0], [3, 2, 7, 5])


def test_paste_masks_equal_jax():
    """Random soft masks into a 48x56 image: boxes inside, across each edge,
    thinner than a pixel and degenerate; float values to rtol 1e-6,
    thresholded masks exactly; the JAX case's centre and corners."""
    rng = np.random.RandomState(2)
    boxes = np.concatenate([_boxes(rng, 6, -15.0, 60.0),
                            [[10.0, 12.0, 10.2, 30.0], [5.0, 5.0, 5.0, 5.0], [4.0, 4.0, 12.0, 12.0]]])
    boxes = boxes.astype(np.float32)
    m = rng.rand(len(boxes), 14, 14).astype(np.float32)
    m[-1] = 1.0
    for threshold in (None, 0.5, 0.3):
        got = masks.paste_masks_in_image(_t(m), _t(boxes), (48, 56), threshold).numpy()
        want = np.asarray(jax_masks.paste_masks_in_image(jnp.asarray(m), jnp.asarray(boxes), (48, 56),
                                                         threshold))
        assert got.shape == want.shape == (len(boxes), 48, 56) and got.dtype == want.dtype
        if threshold is None:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            assert np.array_equal(got, want)
    one = masks.paste_masks_in_image(torch.ones(1, 4, 4), torch.tensor([[4.0, 4.0, 12.0, 12.0]]), (16, 16))
    assert one[0, 8, 8] and not one[0, 1, 1] and not one[0, 14, 14]


def test_keypoints_equal_jax():
    rng = np.random.RandomState(3)
    boxes = np.concatenate([[[10.0, 10.0, 50.0, 50.0]], _boxes(rng, 3, 0.0, 50.0)]).astype(np.float32)
    kpts = np.concatenate([rng.rand(4, 6, 2) * 90 - 10, rng.randint(0, 3, (4, 6, 1))], -1)
    kpts[0, :2] = [[20.0, 30.0, 2.0], [5.0, 5.0, 2.0]]
    kpts = kpts.astype(np.float32)
    for size in (14, 56):
        gi, gv = kp.keypoints_to_heatmap(_t(kpts), _t(boxes), size)
        wi, wv = jax_kp.keypoints_to_heatmap(jnp.asarray(kpts), jnp.asarray(boxes), size)
        assert gi.dtype == torch.int32 and np.array_equal(gi.numpy(), np.asarray(wi))
        assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert gv[0, :2].tolist() == [True, False] and gv.any() and not gv.all()
    hm = (rng.randn(4, 6, 14, 14) * 3).astype(np.float32)
    got = kp.heatmaps_to_keypoints(_t(hm), _t(boxes)).numpy()
    want = np.asarray(jax_kp.heatmaps_to_keypoints(jnp.asarray(hm), jnp.asarray(boxes)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_rotated_boxes_equal_jax():
    """tests/test_structures_extra.py's boxes and IoU goldens, and random
    boxes with angles beyond +-180 (both tensors and numpy arrays)."""
    rng = np.random.RandomState(4)
    b = np.array([[10.0, 10.0, 8.0, 4.0, 0.0], [0.0, 0.0, 2.0, 2.0, 450.0], [5, 5, 3, 2, -180.0],
                  [3, 4, 5, 6, 180.0]], np.float32)
    b = np.concatenate([b, np.concatenate([rng.rand(6, 2) * 100, rng.rand(6, 2) * 30 + 1,
                                           rng.rand(6, 1) * 900 - 450], 1).astype(np.float32)])
    assert np.array_equal(rot.area(_t(b)).numpy(), np.asarray(jax_rot.area(jnp.asarray(b))))
    got = rot.normalize_angles(_t(b)).numpy()
    assert np.array_equal(got, np.asarray(jax_rot.normalize_angles(jnp.asarray(b))))
    assert got[1, 4] == 90.0 and got[2, 4] == got[3, 4] == 180.0
    np.testing.assert_allclose(rot.corners(_t(b)).numpy(), np.asarray(jax_rot.corners(jnp.asarray(b))),
                               rtol=1e-6, atol=1e-5)
    assert np.array_equal(rot.corners(b.astype(float)), jax_rot.corners(b.astype(float)))
    np.testing.assert_allclose(rot.to_axis_aligned(_t(b)).numpy(),
                               np.asarray(jax_rot.to_axis_aligned(jnp.asarray(b))), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(rot.to_axis_aligned(_t(b[:1])).numpy()[0], [6, 8, 14, 12])
    iou = rot.pairwise_iou_rotated(_t(b), b[::-1].copy())
    assert np.array_equal(iou, jax_rot.pairwise_iou_rotated(b, b[::-1].copy()))
    a = [[10, 10, 4, 4, 0]]
    inter = 16 * (2 * np.sqrt(2) - 2)
    np.testing.assert_allclose(rot.pairwise_iou_rotated(a, [[10, 10, 4, 4, 45]])[0, 0],
                               inter / (32 - inter), atol=1e-6)
    assert rot.pairwise_iou_rotated(a, [[100, 100, 4, 4, 30]])[0, 0] == 0.0


# ---------------------------------------------------------------------------
# utils: env, serialize, memory
# ---------------------------------------------------------------------------


def test_seed_all_rng_and_env_info():
    import random

    assert env.seed_all_rng(123) == 123
    got = (np.random.rand(3), random.random(), torch.rand(3))
    assert jax_env.seed_all_rng(123) == 123
    want = (np.random.rand(3), random.random())
    torch.manual_seed(123)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] and torch.equal(got[2], torch.rand(3))
    assert env.seed_all_rng() >= 0
    info = env.collect_env_info()
    assert "torch:" in info and "CUDA available" in info and "jax" not in info


def test_picklable_wrapper_equals_jax():
    from proben_tpu.utils.serialize import PicklableWrapper as JaxPicklableWrapper

    for cls in (serialize.PicklableWrapper, JaxPicklableWrapper):
        w = pickle.loads(pickle.dumps(cls(len)))
        assert w([1, 2, 3]) == 3
        lam = pickle.loads(pickle.dumps(cls(lambda x: x * 2)))
        assert lam(21) == 42
    y = 3
    with pytest.raises(Exception):
        serialize.PicklableWrapper(lambda x: x + y)  # a closure cannot be shipped


def test_retry_if_oom(monkeypatch, caplog):
    """Passes a result and other errors through (the JAX case); on one OOM
    empties the cache and retries with the same arguments, with a warning;
    a second OOM is raised (JAX's helper reruns on the CPU instead: the
    port never leaves the card by itself)."""
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))
    assert memory.retry_if_oom(lambda x: x + 1)(1) == 2 and not emptied
    with pytest.raises(ValueError):
        memory.retry_if_oom(lambda: (_ for _ in ()).throw(ValueError("not oom")))()

    calls = []

    def flaky(x, fail, extra=None):
        calls.append((x, extra))
        if len(calls) <= fail:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return x * 2

    with caplog.at_level(logging.WARNING, logger="proben_tpu_torch.utils.memory"):
        x, nested = torch.ones(2), {"a": [torch.zeros(1)], "b": 3}
        assert memory.retry_if_oom(flaky)(x, 1, extra=nested).tolist() == [2.0, 2.0]
        assert len(calls) == 2 and emptied == [1] and len(caplog.records) == 1
        assert calls[1][0] is x and calls[1][1] is nested  # the retry: the same arguments
        calls.clear()
        with pytest.raises(torch.cuda.OutOfMemoryError):
            memory.retry_if_oom(flaky)(x, 2, extra=nested)
    assert len(calls) == 2 and emptied == [1, 1] and len(caplog.records) == 2
    assert all(c[0] is x and c[1] is nested for c in calls)


# ---------------------------------------------------------------------------
# utils: parameter and FLOP counts
# ---------------------------------------------------------------------------


def test_parameter_counts_equal_jax():
    """A tiny R50-FPN: the module, its numpy pytree and JAX's count of that
    pytree agree exactly, and so do the tables; the JAX case's dict."""
    cfg = build_config(depth=50)
    tree = init_rcnn(0, cfg)
    model = build_model(cfg, params=tree, device="cpu")
    n = jax_analysis.parameter_count(tree)
    assert analysis.parameter_count(model) == analysis.parameter_count(tree) == n > 2e7
    assert analysis.parameter_count_table(model) == jax_analysis.parameter_count_table(tree)
    params = {"a": np.zeros((10, 20)), "b": [np.zeros(5), np.zeros((2, 3))]}
    assert analysis.parameter_count(params) == jax_analysis.parameter_count(params) == 211
    assert analysis.parameter_count_table(params) == jax_analysis.parameter_count_table(params)


def test_flop_count_toys_against_jax():
    """The JAX case (a matmul: 2 * M * N * K in both); a convolution
    without padding plus a matmul, equal to XLA's count; with padding, the
    port counts every tap and XLA skips the padded ones."""
    a, b = np.zeros((128, 256), np.float32), np.zeros((256, 64), np.float32)
    want = jax_analysis.flop_count(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    assert analysis.flop_count(lambda x, y: x @ y, _t(a), _t(b)) == want == 2 * 128 * 256 * 64

    import jax

    x, w, v = np.zeros((2, 16, 20, 3), np.float32), np.zeros((7, 7, 3, 8), np.float32), np.zeros((8, 16), np.float32)
    for pad in (0, 3):
        def jax_fn(x, w, v):
            y = jax.lax.conv_general_dilated(x, w, (2, 2), ((pad, pad), (pad, pad)),
                                             dimension_numbers=("NHWC", "HWIO", "NHWC"))
            return y.reshape(-1, 8) @ v

        def port_fn(x, w, v):
            y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=2, padding=pad)
            return y.permute(0, 2, 3, 1).reshape(-1, 8) @ v

        got = analysis.flop_count(port_fn, _t(x), _t(w), _t(v))
        want = jax_analysis.flop_count(jax_fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(v))
        ho, wo = (16 + 2 * pad - 7) // 2 + 1, (20 + 2 * pad - 7) // 2 + 1
        products = 2 * (2 * ho * wo) * 8 * 16
        assert got == 2 * 2 * ho * wo * 8 * 49 * 3 + products
        k = np.arange(7)
        inside_y = ((2 * np.arange(ho)[:, None] - pad + k >= 0) & (2 * np.arange(ho)[:, None] - pad + k < 16)).sum()
        inside_x = ((2 * np.arange(wo)[:, None] - pad + k >= 0) & (2 * np.arange(wo)[:, None] - pad + k < 20)).sum()
        assert want == 2 * 2 * 3 * 8 * inside_y * inside_x + products
        assert (got == want) == (pad == 0)


def test_kernel_wrappers_report_their_plain_versions_flops():
    """K1, K2 and K3 through their ops' CPU implementations (the plain
    versions) and the plain versions themselves count ``stem_flops`` and
    ``roi_align_flops``, the numbers the CUDA implementations count for the
    same inputs. K1's equals the mode's own count of its plain version.
    K2's and K3's is RoIAlign's arithmetic, not the plain versions' dense
    window contractions: 2 * C per (output bin, touched pixel), the touched
    pixels counted independently here as the nonzeros of each bin's row of
    the map's Jacobian (K3 with a one-hot cotangent). The plain versions
    are ops with the same flop formula, so the mode does not count the
    contractions inside them; a forward and backward through the K2 op, or
    through the plain version's op, counts K2's and K3's formulas once
    each."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(2, 24, 30, 3).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(7, 7, 3, 64).astype(np.float32) * 0.05).to(torch.bfloat16)
    s, b = torch.ones(64, dtype=torch.bfloat16), torch.zeros(64, dtype=torch.bfloat16)
    k1 = stem_cuda.stem_flops(*x.shape)
    assert k1 == 2 * 2 * 12 * 15 * 64 * 49 * 3
    assert analysis.flop_count(stem_cuda.stem_pool, x, w, s, b) == k1
    assert analysis.flop_count(stem_cuda.stem_pool_plain, x, w, s, b) == k1

    feats = [torch.from_numpy(rng.randn(2, h, h + 4, 8).astype(np.float32)) for h in (32, 16, 8, 4)]
    boxes = torch.from_numpy(np.stack([_boxes(rng, 5, 0.0, 80.0)] * 2))
    lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(feats, boxes, (4, 8, 16, 32))
    args = (feats, lvl, y0, x0, wy, wx, 5)
    shapes = [tuple(f.shape) for f in feats]
    touched = 0
    for r in range(10):  # one output bin per channel of the cotangent
        for first in range(0, 49, 8):
            g = torch.zeros(10, 7, 7, 8)
            bins = range(first, min(first + 8, 49))
            for ch, pq in enumerate(bins):
                g[r, pq // 7, pq % 7, ch] = 1.0
            grads = roi_align_cuda.roi_align_bwd_plain(g, shapes, lvl, y0, x0, wy, wx, 5)
            touched += sum(int((d[..., ch] != 0).sum()) for d in grads for ch in range(len(bins)))
    k2 = roi_align_cuda.roi_align_flops(wy, wx, 8)
    assert k2 == 2 * 8 * touched
    # the plain versions' two dense contractions over each RoI's window, which their ops' formula replaces
    dense = 2 * 10 * 7 * 8 * roi_align.WIN_X * (roi_align.WIN_Y + 7)
    assert 0 < k2 < dense / 10
    assert analysis.flop_count(roi_align_cuda.roi_align_fwd, *args) == k2
    assert analysis.flop_count(roi_align_cuda.roi_align_fwd_plain, *args) == k2
    g = torch.from_numpy(rng.randn(10, 7, 7, 8).astype(np.float32))
    bargs = (g, shapes, lvl, y0, x0, wy, wx, 5)
    assert analysis.flop_count(roi_align_cuda.roi_align_bwd, *bargs) == k2
    assert analysis.flop_count(roi_align_cuda.roi_align_bwd_plain, *bargs) == k2

    def pooled_and_grads(impl, *features):
        leaves = [f.clone().requires_grad_() for f in features]
        out = roi_align_cuda.windowed_roi_align(impl, lvl, y0, x0, wy, wx, 5, leaves)
        return torch.autograd.grad(out, leaves, g)

    assert analysis.flop_count(pooled_and_grads, "kernel", *feats) == 2 * k2
    assert analysis.flop_count(pooled_and_grads, "plain", *feats) == 2 * k2


def test_nms_counts_no_flops():
    """NMS's fixpoint runs 0/1 matrix products, as many as its suppression
    chains need; ``flop_count`` counts them as nothing (the rule)."""
    from proben_tpu_torch.ops.nms import nms_mask

    rng = np.random.RandomState(8)
    boxes = torch.from_numpy(np.stack([_boxes(rng, 60, 0.0, 30.0) for _ in range(3)]))
    scores = torch.from_numpy(rng.rand(3, 60).astype(np.float32))
    valid = torch.ones(3, 60, dtype=torch.bool)
    keep = nms_mask(boxes, scores, valid, 0.3)
    assert 0 < int(keep.sum()) < 180  # some boxes suppressed: the loop ran
    assert analysis.flop_count(nms_mask, boxes, scores, valid, 0.3) == 0


def test_flop_count_of_the_model_is_the_same_through_kernels_and_plain():
    """A tiny R50-FPN in bf16, batch 1: inference through the kernels' ops
    (their plain implementations here) and through the plain paths
    (``stem_impl``, ``roi_align_impl`` "plain") count the same FLOPs."""
    counts = []
    rng = np.random.RandomState(6)
    images = torch.from_numpy(rng.rand(1, 64, 96, 3).astype(np.float32) * 255)
    sizes = torch.tensor([[64, 90]], dtype=torch.int32)
    for impl in ("kernel", "plain"):
        cfg = build_config(depth=50, compute_dtype="bfloat16", stem_impl=impl, roi_align_impl=impl)
        model = build_model(cfg, params=init_rcnn(0, cfg), device="cpu")
        with torch.inference_mode():
            counts.append(analysis.flop_count(t_rcnn.rcnn_inference, model, cfg, images, sizes))
    assert counts[0] == counts[1] > 1e9


# ---------------------------------------------------------------------------
# utils: visualizers
# ---------------------------------------------------------------------------


def _frame():
    return np.full((64, 64, 3), 128, np.uint8)


class _Meta:
    thing_classes = ("person", "bicycle", "car")
    keypoint_names = ("a", "b", "c", "nose", "left_shoulder", "right_shoulder")
    keypoint_connection_rules = [("a", "b", (255, 0, 0)), ("b", "c", (0, 255, 0))]


def test_visualizer_images_equal_jax(tmp_path):
    """tests/test_utils.py's and test_compat_video_vis.py's drawings (boxes
    with labels and scores, masks, keypoints with a skeleton, rotated boxes,
    a dataset dict, the paper colours, a gray image, a scale) give the same
    image in both packages; the port takes the record as tensors."""
    rng = np.random.RandomState(7)
    rec = {"boxes": np.array([[10, 10, 50, 60], [60, 20, 110, 90]], np.float32),
           "classes": np.array([0, 2]), "scores": np.array([0.9, 0.7], np.float32),
           "masks": rng.rand(2, 100, 120) > 0.7,
           "keypoints": np.array([[[10, 10, 1.0], [30, 30, 1.0], [50, 50, 0.0], [20, 5, 1],
                                   [15, 40, 1], [40, 40, 1]]] * 2, np.float32)}
    base = rng.randint(0, 255, (100, 120, 3)).astype(np.uint8)
    for meta in (None, _Meta()):
        for scale in (1.0, 0.5):
            r = rec if scale == 1.0 else {k: v for k, v in rec.items() if k != "masks"}
            got = Visualizer(base, meta, scale).draw_instance_predictions(
                {k: torch.from_numpy(np.asarray(v)) for k, v in r.items()}).get_image()
            want = JaxVisualizer(base, meta, scale).draw_instance_predictions(r).get_image()
            assert np.array_equal(got, want)
    gray = rng.randint(0, 255, (40, 50)).astype(np.uint8)
    cases = [
        lambda V: V(gray).overlay_instances(boxes=rec["boxes"] / 3, classes=rec["classes"]),
        lambda V: V(_frame()).draw_rotated_box_with_label((30, 32, 20, 20, 30.0), (255, 0, 0), "r"),
        lambda V: V(_frame()).overlay_rotated_instances(np.array([[32, 32, 30, 10, 90.0], [20, 20, 8, 8, 45.0]]),
                                                        labels=["x", "y"], classes=np.array([1, 2])),
        lambda V: V(_frame(), _Meta()).draw_keypoints(rec["keypoints"][:1]),
        lambda V: V(_frame()).draw_polygon(np.array([[5, 5], [40, 10], [20, 50]]), (0, 0, 255)),
        lambda V: V(_frame(), _Meta()).draw_dataset_dict(
            {"annotations": [{"bbox": [10.0, 10.0, 20.0, 20.0], "bbox_mode": 1, "category_id": 0},
                             {"bbox": [5.0, 40.0, 15.0, 55.0], "bbox_mode": 0, "category_id": 1,
                              "iscrowd": 1, "keypoints": [10, 10, 2, 20, 20, 2, 0, 0, 0] * 2}]}),
    ]
    for case in cases:
        assert np.array_equal(case(Visualizer).get_image(), case(JaxVisualizer).get_image())
    paper = PaperVisualizer(_frame()).overlay_instances(boxes=np.array([[10.0, 10.0, 30.0, 30.0]]),
                                                        classes=np.array([0])).get_image()
    assert np.array_equal(paper, JaxPaperVisualizer(_frame()).overlay_instances(
        boxes=np.array([[10.0, 10.0, 30.0, 30.0]]), classes=np.array([0])).get_image())
    assert (paper[10, 10:30] == np.array([0, 255, 0])).all(axis=-1).any()
    vis = Visualizer(base).draw_instance_predictions(rec)
    vis.save(str(tmp_path / "vis.png"))
    import cv2

    assert np.array_equal(cv2.imread(str(tmp_path / "vis.png")), vis.get_image())


def test_video_visualizer_equals_jax():
    """The colour stability and class-gate sequences of
    tests/test_compat_video_vis.py: the same colours frame by frame and the
    same images, the port fed tensors."""
    frames = [
        {"boxes": [[5.0, 5.0, 25.0, 25.0], [40.0, 40.0, 60.0, 60.0]], "classes": [0, 1], "scores": [0.9, 0.8]},
        {"boxes": [[6.0, 6.0, 26.0, 26.0], [41.0, 41.0, 61.0, 61.0]], "classes": [0, 1], "scores": [0.9, 0.8]},
        {"boxes": [[6.0, 6.0, 26.0, 26.0], [5.0, 40.0, 20.0, 60.0]], "classes": [0, 0], "scores": [0.9, 0.8]},
        {"boxes": [[6.0, 6.0, 26.0, 26.0]], "classes": [1], "scores": [0.7]},
        {"boxes": np.zeros((0, 4)), "classes": [], "scores": []},
    ]
    got_vv, want_vv = VideoVisualizer(), JaxVideoVisualizer()
    colours = []
    for f in frames:
        rec = {k: np.asarray(v, np.float32 if k != "classes" else np.int64) for k, v in f.items()}
        g = got_vv.draw_instance_predictions(_frame(), {k: torch.from_numpy(v) for k, v in rec.items()})
        w = want_vv.draw_instance_predictions(_frame(), rec)
        assert np.array_equal(g.get_image(), w.get_image())
        colours.append([x.color for x in got_vv._old_instances])
        assert colours[-1] == [x.color for x in want_vv._old_instances]
        assert [x.ttl for x in got_vv._old_instances] == [x.ttl for x in want_vv._old_instances]
    assert colours[1][:2] == colours[0][:2]  # moved slightly: the colours carry over
    assert colours[2][0] == colours[0][0] and colours[2][1] not in colours[0]
    assert colours[3][0] not in colours[2]  # same box, another class: a new colour
