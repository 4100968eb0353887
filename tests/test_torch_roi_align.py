"""Multi-level RoIAlign of ``proben_tpu_torch`` (kernel K2's plain version
on the CPU, plus the out-of-window fallback) against ``proben_tpu``'s
Pallas path run in interpret mode, in f32. The CUDA kernel itself is held
against the plain version in tests/test_torch_kernels.py.

The boxes mix the hazards of the JAX tests (tests/test_roi_align_pallas.py):
random boxes over all levels, degenerate boxes, NaN/Inf boxes, a level map
smaller than the window (p5 = 8x8) and tall slivers that leave the window
and take the whole-map fallback. Shapes match that file's (B=2, K=32,
base 64, C=32), so the interpreted kernel compiles once per sampling ratio.

Tolerance: both sides form the same weights and sum the same f32 products
in different orders; every output is a weighted average of feature values
in [0, 1), so rtol 1e-5 / atol 1e-5 covers the reordering. NaN boxes give
NaN rows on both sides (compared as equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.ops import roi_align as jax_ra
from proben_tpu.ops.roi_align_pallas import multilevel_roi_align_pallas
from proben_tpu_torch.ops import roi_align as t_ra
from proben_tpu_torch.ops import roi_align_cuda
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

STRIDES = (4, 8, 16, 32)
B, K, BASE, C = 2, 32, 64, 32


def _feats(rng):
    return [rng.rand(B, BASE >> i, BASE >> i, C).astype(np.float32) for i in range(4)]


def _boxes(rng):
    xy = rng.rand(B, K, 2) * (256 * 0.6)
    wh = rng.rand(B, K, 2) * (256 * 0.35) + 8
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 0] = [0.0, 0.0, 0.0, 0.0]          # empty
    boxes[:, 1] = [10.0, 10.0, 10.5, 200.0]     # degenerate sliver
    boxes[:, 2] = np.nan
    boxes[:, 3] = [100.0, np.nan, 200.0, 150.0]
    boxes[:, 4] = np.inf
    boxes[:, 5] = [100.0, 2.0, 104.3, 254.1]    # tall sliver: out of window
    boxes[:, 6] = [30.2, 1.7, 33.9, 250.6]      # another one
    boxes[:, 7] = [0.0, 0.0, 256.0, 256.0]      # whole image, p5 (8x8 < window)
    boxes[:, 8] = [120.3, 130.1, 255.7, 255.2]  # edge of the map
    return boxes


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    return _feats(rng), _boxes(rng)


@pytest.mark.parametrize("ratio", [0, 2])
def test_multilevel_roi_align_matches_pallas(case, ratio):
    feats, boxes = case
    want = np.asarray(multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), STRIDES, 7, ratio, interpret=True))
    got = roi_align_cuda.multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), STRIDES, 7, ratio).numpy()
    assert got.shape == want.shape == (B, K, 7, 7, C)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the hazards really occur: NaN rows, and out-of-window rows re-pooled
    assert np.isnan(got[:, 2]).all() and np.isfinite(got[:, 5:9]).all()


def test_window_weights_match_jax(case):
    """Level assignment, origins, weights and out-of-window flags equal
    ``proben_tpu``'s on the same boxes (origins/levels exactly)."""
    feats, boxes = case
    flat = boxes.reshape(-1, 4)
    heights = np.array([f.shape[1] for f in feats], np.int32)
    widths = np.array([f.shape[2] for f in feats], np.int32)
    pads = np.array([t_ra.padded_size(h, w) for h, w in zip(heights, widths)], np.int32)
    jl = np.asarray(jax_ra.roi_level_assignment(jnp.asarray(flat), 2, 5)) - 2
    tl = t_ra.roi_level_assignment(torch.from_numpy(flat), 2, 5).numpy() - 2
    np.testing.assert_array_equal(tl, jl)
    want = jax_ra.build_window_weights(
        jnp.asarray(flat), jnp.asarray(jl), STRIDES, jnp.asarray(heights), jnp.asarray(widths),
        jnp.asarray(pads[:, 0]), jnp.asarray(pads[:, 1]), 7, 0, 16)
    got = t_ra.build_window_weights(
        torch.from_numpy(flat), torch.from_numpy(tl), STRIDES, torch.from_numpy(heights),
        torch.from_numpy(widths), torch.from_numpy(pads[:, 0]), torch.from_numpy(pads[:, 1]),
        7, 0, 16)
    for name, g, w in zip(("y0", "x0", "wy", "wx", "oow"), got, want):
        w = np.asarray(w)
        if name in ("wy", "wx"):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    y0, x0 = got[0].numpy(), got[1].numpy()
    ph, pw = pads[tl, 0], pads[tl, 1]
    assert ((y0 >= 0) & (y0 <= ph - 56)).all() and ((x0 >= 0) & (x0 <= pw - 64)).all()
    assert got[4].numpy().sum() >= 2 * B  # the slivers are out of window


def test_pad_level_matches_jax(case):
    feats, _ = case
    for f in feats:
        np.testing.assert_array_equal(
            t_ra.pad_level(torch.from_numpy(f)).numpy(), np.asarray(jax_ra.pad_level(jnp.asarray(f))))
