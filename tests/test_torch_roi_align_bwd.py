"""The RoIAlign backward of ``proben_tpu_torch`` (kernel K3's plain version,
reached through ``multilevel_roi_align``'s autograd) against ``proben_tpu``
on the CPU in f32: the fused Pallas backward ``wholemap_grad_pallas`` in
interpret mode, and the einsum whole-map backward ``wholemap_roi_align_grad``.
The CUDA kernel itself is held against the plain version in
tests/test_torch_kernels.py.

Shapes are those of tests/test_roi_align_bwd_pallas.py (B=2, K=16, C=32,
level 0 taller than the 56-row window, bs=4, ty=8), so the interpreted
kernel compiles once per fallback capacity. Three cases: every RoI in
window; one sliver per image out of window and within the fallback
capacity (its exact gradient flows through the whole-map re-pooling, the
windowed backward sees a zero cotangent for its row); capacity 0, where the
sliver keeps its window-clamped weights in both directions, which only the
Pallas backward reproduces.

Tolerance: the same f32 products summed in other orders; gradients are
compared relative to each level's largest entry (atol 1e-5), as the JAX
file does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.ops.roi_align import wholemap_roi_align_grad
from proben_tpu.ops.roi_align_bwd_pallas import wholemap_grad_pallas
from proben_tpu_torch.ops import roi_align as t_ra
from proben_tpu_torch.ops import roi_align_cuda
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

STRIDES = (4, 8, 16, 32)
P = 7
B, K, C = 2, 16, 32
SHAPES = [(80, 64), (40, 32), (20, 16), (10, 8)]


def _inputs(seed, sliver=False):
    """tests/test_roi_align_bwd_pallas.py::_inputs, as numpy."""
    rng = np.random.RandomState(seed)
    feats = [rng.rand(B, h, w, C).astype(np.float32) for h, w in SHAPES]
    xy = rng.rand(B, K, 2) * 120
    wh = rng.rand(B, K, 2) * 90 + 8
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if sliver:
        boxes[:, 0] = [2.0, 2.0, 8.0, 312.0]
    g = rng.rand(B, K, P, P, C).astype(np.float32)
    return feats, boxes, g


def _port_grad(feats, boxes, g, capacity):
    fs = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = roi_align_cuda.multilevel_roi_align(fs, torch.from_numpy(boxes), STRIDES, P, 0,
                                              fallback_capacity=capacity, impl="kernel")
    out.backward(torch.from_numpy(g))
    return [f.grad.numpy() for f in fs]


def _einsum_ref(feats, boxes, g):
    out = jax.vmap(
        lambda f0, f1, f2, f3, bx, gg: wholemap_roi_align_grad(
            [f0, f1, f2, f3], bx, gg, STRIDES, P, 0, 2, 224.0, 4
        )
    )(*map(jnp.asarray, feats), jnp.asarray(boxes), jnp.asarray(g))
    return [np.asarray(o) for o in out]


def _pallas(feats, boxes, g, capacity):
    out = wholemap_grad_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), jnp.asarray(g), STRIDES, P, 0, 2,
        224.0, 4, fallback_capacity=capacity, bs=4, ty=8, interpret=True,
    )
    return [np.asarray(o) for o in out]


def _assert_levels_close(got, want, atol=1e-5):
    for li, (o, r) in enumerate(zip(got, want)):
        assert o.shape == r.shape
        scale = np.abs(r).max() + 1e-9
        np.testing.assert_allclose(o / scale, r / scale, atol=atol, err_msg=f"level {li}")


@pytest.mark.parametrize("case", ["in_window", "sliver_in_capacity", "capacity_zero"])
def test_backward_matches_jax(case):
    feats, boxes, g = _inputs(0, sliver=case != "in_window")
    capacity = 0 if case == "capacity_zero" else 32
    got = _port_grad(feats, boxes, g, capacity)
    _assert_levels_close(got, _pallas(feats, boxes, g, capacity))
    if case != "capacity_zero":
        _assert_levels_close(got, _einsum_ref(feats, boxes, g))
    else:
        # the clamped sliver really differs from the exact whole-map gradient
        diff = max(np.abs(a - b).max() for a, b in zip(got, _einsum_ref(feats, boxes, g)))
        assert diff > 1e-4


def _window_case(seed):
    rng = np.random.RandomState(seed)
    feats, boxes, _ = _inputs(seed)
    fs = [torch.from_numpy(f) for f in feats]
    lvl, y0, x0, wy, wx, oow = roi_align_cuda.window_inputs(fs, torch.from_numpy(boxes), STRIDES)
    assert not oow.any()
    return fs, lvl, y0, x0, wy, wx, rng


def test_plain_pair_is_adjoint():
    """<fwd(F), g> = <F, bwd(g)> for K2's and K3's plain versions; f32 sums
    of ~1e5 positive terms, rtol 1e-5."""
    fs, lvl, y0, x0, wy, wx, rng = _window_case(1)
    g = torch.from_numpy(rng.randn(B * K, P, P, C).astype(np.float32))
    pooled = roi_align_cuda.roi_align_fwd_plain(fs, lvl, y0, x0, wy, wx, K)
    dfs = t_ra.roi_align_bwd_plain(g, [tuple(f.shape) for f in fs], lvl, y0, x0, wy, wx, K)
    lhs = float((pooled.double() * g.double()).sum())
    rhs = sum(float((f.double() * d.double()).sum()) for f, d in zip(fs, dfs))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)
    assert all(d.shape == f.shape and d.dtype == f.dtype for f, d in zip(fs, dfs))


def test_plain_backward_is_the_autograd_of_the_plain_forward():
    """K3's plain version against autograd through K2's plain version (a
    gather and two einsums) on the same inputs, elementwise; f32 sums in
    other orders, rtol 1e-5 of each level's largest entry."""
    fs, lvl, y0, x0, wy, wx, rng = _window_case(4)
    g = torch.from_numpy(rng.randn(B * K, P, P, C).astype(np.float32))
    leaves = [f.clone().requires_grad_() for f in fs]
    pooled = roi_align_cuda.roi_align_fwd_plain(leaves, lvl, y0, x0, wy, wx, K)
    want = torch.autograd.grad(pooled, leaves, g)
    got = t_ra.roi_align_bwd_plain(g, [tuple(f.shape) for f in fs], lvl, y0, x0, wy, wx, K)
    _assert_levels_close([a.numpy() for a in got], [w.numpy() for w in want])
    assert float(want[0].abs().sum()) > 0


def test_plain_backward_rounds_like_jax_in_bf16():
    """In bf16 the plain backward rounds wy, wx and u to bf16 and the
    result once, as ``wholemap_roi_align_grad`` does: on in-window RoIs the
    two agree to one bf16 ulp (rtol 2^-7) of the level's largest entry."""
    fs, lvl, y0, x0, wy, wx, rng = _window_case(2)
    feats, boxes, _ = _inputs(2)
    g = rng.rand(B, K, P, P, C).astype(np.float32)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    dfs = t_ra.roi_align_bwd_plain(gb.reshape(B * K, P, P, C), [tuple(f.shape) for f in fs],
                                   lvl, y0, x0, wy, wx, K)
    want = jax.vmap(
        lambda f0, f1, f2, f3, bx, gg: wholemap_roi_align_grad(
            [f0, f1, f2, f3], bx, gg, STRIDES, P, 0, 2, 224.0, 4
        )
    )(*(jnp.asarray(f, jnp.bfloat16) for f in feats), jnp.asarray(boxes),
      jnp.asarray(gb.float().numpy(), jnp.bfloat16))
    assert all(d.dtype == torch.bfloat16 for d in dfs)
    _assert_levels_close([d.float().numpy() for d in dfs],
                         [np.asarray(w.astype(jnp.float32)) for w in want], atol=2.0 ** -7)


def test_nan_box_gives_nan_only_in_its_window():
    """A NaN box's weights are NaN: its whole window turns NaN in the level
    it is assigned to, and nothing else does."""
    fs, lvl, y0, x0, wy, wx, rng = _window_case(3)
    feats, boxes, _ = _inputs(3)
    boxes[1, 2] = np.nan
    lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(fs, torch.from_numpy(boxes), STRIDES)
    g = torch.from_numpy(rng.rand(B * K, P, P, C).astype(np.float32))
    dfs = t_ra.roi_align_bwd_plain(g, [tuple(f.shape) for f in fs], lvl, y0, x0, wy, wx, K)
    r = K + 2
    li, oy, ox = int(lvl[r]), int(y0[r]), int(x0[r])
    for l, d in enumerate(dfs):
        nan = torch.isnan(d)
        if l == li:
            win = nan[1, oy:oy + t_ra.WIN_Y, ox:ox + t_ra.WIN_X]
            assert win.all() and int(nan.sum()) == win.numel()
        else:
            assert not nan.any()


def _tiled_backward(g, shapes, lvl_idx, y0, x0, wy, wx, k, tile):
    """K3's decomposition (``csrc/roi_align_bwd.cu``) emulated with torch:
    per RoI the spans of its nonzero rounded weights (its whole window when
    a weight is not finite) in level coordinates, clipped to the true map;
    per (image, level, tile) the RoIs whose spans touch the tile, in RoI
    order; per tile an f32 accumulator that adds each listed RoI's
    contribution over the tile and its span, rounded once. The
    contributions are the plain version's own einsums, so a difference can
    only come from the decomposition."""
    dt, num_levels = g.dtype, len(shapes)
    wyr, wxr = wy.to(dt).float(), wx.to(dt).float()
    u = torch.einsum("npy,npqc->nyqc", wyr, g.float()).to(dt)
    contrib = torch.einsum("nqx,nyqc->nyxc", wxr, u.float())
    bad = ~(torch.isfinite(wyr).all(dim=(1, 2)) & torch.isfinite(wxr).all(dim=(1, 2)))
    spans = []
    for r in range(g.shape[0]):
        l = min(max(int(lvl_idx[r]), 0), num_levels - 1)
        h, w = shapes[l][1:3]
        ys = torch.arange(t_ra.WIN_Y) if bad[r] else (wyr[r] != 0).any(0).nonzero().flatten()
        xs = torch.arange(t_ra.WIN_X) if bad[r] else (wxr[r] != 0).any(0).nonzero().flatten()
        if not len(ys) or not len(xs):
            spans.append(None)
            continue
        oy, ox = int(y0[r]), int(x0[r])
        ylo, yhi = max(oy + int(ys.min()), 0), min(oy + int(ys.max()), h - 1)
        xlo, xhi = max(ox + int(xs.min()), 0), min(ox + int(xs.max()), w - 1)
        spans.append((l, ylo, yhi, xlo, xhi) if ylo <= yhi and xlo <= xhi else None)
    ty_, tx_ = tile
    out = []
    for l, (b, h, w, c) in enumerate(shapes):
        level = torch.empty((b, h, w, c), dtype=dt)
        for img in range(b):
            for ty in range(0, h, ty_):
                for tx in range(0, w, tx_):
                    y1, x1 = min(ty + ty_, h) - 1, min(tx + tx_, w) - 1
                    acc = torch.zeros((y1 - ty + 1, x1 - tx + 1, c))
                    for r in range(img * k, (img + 1) * k):
                        s = spans[r]
                        if s is None or s[0] != l or s[1] > y1 or s[2] < ty or s[3] > x1 or s[4] < tx:
                            continue
                        ya, yb, xa, xb = max(s[1], ty), min(s[2], y1), max(s[3], tx), min(s[4], x1)
                        oy, ox = int(y0[r]), int(x0[r])
                        acc[ya - ty:yb - ty + 1, xa - tx:xb - tx + 1] += (
                            contrib[r, ya - oy:yb - oy + 1, xa - ox:xb - ox + 1])
                    level[img, ty:y1 + 1, tx:x1 + 1] = acc.to(dt)
        out.append(level)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [(8, 16), (16, 16), (8, 8)])
def test_tiled_decomposition_is_the_plain_backward(dtype, tile):
    """K3's output-stationary decomposition gives the plain backward
    exactly: RoIs crossing tile edges (and tiles past the map's ragged
    edge), windows reaching past the true map into the padding, a NaN box,
    RoIs on all four levels. In RoI order each entry is the same f32 sum as
    ``index_add_``'s, so the match is exact, NaN for NaN."""
    feats, boxes, _ = _inputs(5)
    boxes[0, :4] = [[0.0, 0.0, 250.0, 300.0], [10.0, 20.0, 200.0, 180.0],
                    [20.0, 5.0, 250.0, 318.0], [-100.0, -90.0, 400.0, 420.0]]  # p3..p5
    boxes[1, :2] = [[200.0, 280.0, 256.0, 320.0], [230.0, 150.0, 256.0, 210.0]]  # at the map's edge
    boxes[1, 2] = np.nan
    boxes[0, 4] = [100.0, np.nan, 200.0, 150.0]  # NaN wy, finite wx: NaN over the whole window
    fs = [torch.from_numpy(f) for f in feats]
    lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(fs, torch.from_numpy(boxes), STRIDES)
    assert set(lvl.tolist()) == {0, 1, 2, 3}
    rng = np.random.RandomState(6)
    g = torch.from_numpy(rng.randn(B * K, P, P, C).astype(np.float32)).to(dtype)
    shapes = [tuple(f.shape) for f in fs]
    want = t_ra.roi_align_bwd_plain(g, shapes, lvl, y0, x0, wy, wx, K)
    got = _tiled_backward(g, shapes, lvl, y0, x0, wy, wx, K, tile)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(want[int(lvl[K + 2])]).any()
    # windows reach past the true map: the padded level would hold more
    assert any(int(y0[r]) + t_ra.WIN_Y > shapes[int(lvl[r])][1] for r in range(B * K))
