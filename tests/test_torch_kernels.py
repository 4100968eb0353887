"""The CUDA kernels of ``proben_tpu_torch`` against their plain PyTorch
versions on the card, and the wrappers' input checks.

This file imports no JAX, so the card-only tests also run where JAX is not
installed (``python -m pytest --noconftest tests/test_torch_kernels.py``);
they skip without a CUDA device.
"""

import numpy as np
import pytest
import torch

from nms_cases import THRESHOLDS, cell_problems, hazard_problems
from proben_tpu_torch.ops import roi_align as t_ra
from proben_tpu_torch.ops import epilogue_cuda, nms, roi_align_cuda, stem_cuda  # noqa: F401  (registers the ops)
from proben_tpu_torch.structures.boxes import pairwise_iou
from proben_tpu_torch.utils import tracing

BF = torch.bfloat16
STRIDES = (4, 8, 16, 32)


def launches(kernel: str) -> int:
    """Launches of one kernel so far: ``k1``, ``k2``, ``k3``, ``k4``, ``k5``
    or ``io``."""
    return tracing.counters().get(f"{kernel}.launches", 0)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _stem_inputs(n, h, w, c, seed=0):
    rng = np.random.RandomState(seed)
    return [
        (rng.randn(n, h, w, c) * 50).astype(np.float32),
        (rng.randn(7, 7, c, 64) * 0.03).astype(np.float32),
        (1 + 0.3 * rng.randn(64)).astype(np.float32),
        (0.3 * rng.randn(64)).astype(np.float32),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 32, 256, 3), (1, 48, 256, 4), (1, 30, 98, 4), (1, 7, 9, 8),
    # the kernel's 7 x 8 pooled tile: exactly one tile, one row and column
    # past it, one short of it, two tiles and one past; C = 1 and 2 (padded
    # to 4), 5 and 8 (to 8)
    (1, 28, 32, 3), (1, 29, 33, 1), (2, 23, 27, 2), (1, 57, 65, 5), (1, 64, 96, 8),
])
def test_stem_kernel_matches_plain(shape):
    """Tolerance: the conv's f32 accumulation order differs from cuDNN's, so
    a bf16 conv output may round one ulp apart; through the bf16 affine that
    stays within 2^-6 relative plus 0.05 absolute at these magnitudes."""
    _cuda()
    args = [torch.from_numpy(a).cuda().to(BF) for a in _stem_inputs(*shape)]
    before = launches("k1")
    got = stem_cuda.stem_pool(*args).float()
    ref = stem_cuda.stem_pool_plain(*args).float()
    torch.cuda.synchronize()
    assert launches("k1") == before + 1
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=2.0 ** -6, atol=0.05)


# boxes that stress the kernels: degenerate, non-finite, at and beyond the
# map's edges, out of window
HAZARDS = [
    [0.0, 0.0, 0.0, 0.0], [10.0, 10.0, 10.5, 200.0], [np.inf] * 4, [-np.inf] * 4,
    [100.0, np.nan, 200.0, 150.0], [250.0, 250.0, 256.0, 256.0], [-50.0, -40.0, 30.0, 20.0],
    [200.0, 100.0, 400.0, 300.0], [5.0, 100.0, 250.0, 110.0],
]


def _roi_case(dtype, c=48, k=32, hazards=False, p=7):
    rng = np.random.RandomState(0)
    b, base = 2, 64
    feats = [torch.from_numpy(rng.rand(b, base >> i, base >> i, c).astype(np.float32)).cuda().to(dtype)
             for i in range(4)]
    xy = rng.rand(b, k, 2) * 150
    wh = rng.rand(b, k, 2) * 90 + 8
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 0] = 0.0
    boxes[:, 1] = np.nan
    boxes[:, 2] = [100.0, 2.0, 104.3, 254.1]  # out of window
    boxes[:, 3] = [0.0, 0.0, 256.0, 256.0]
    if hazards:
        boxes[:, 4:4 + len(HAZARDS)] = HAZARDS
    flat = torch.from_numpy(boxes.reshape(-1, 4)).cuda()
    hw = [(f.shape[1], f.shape[2]) for f in feats]
    pads = [t_ra.padded_size(*s) for s in hw]
    t = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")  # noqa: E731
    lvl = (t_ra.roi_level_assignment(flat, 2, 5) - 2).clamp(0, 3)
    y0, x0, wy, wx, _ = t_ra.build_window_weights(
        flat, lvl, STRIDES, t([s[0] for s in hw]), t([s[1] for s in hw]),
        t([s[0] for s in pads]), t([s[1] for s in pads]), p, 0, 16)
    return feats, lvl, y0, x0, wy, wx, k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_matches_plain(dtype):
    """Tolerance: the same exact f32 products summed in another order (1e-5
    of max|F| = 1); a bf16 output may round to the neighbouring value
    (one bf16 ulp, rtol 2^-7). NaN rows must match."""
    _cuda()
    feats, lvl, y0, x0, wy, wx, k = _roi_case(dtype)
    before = launches("k2")
    got = roi_align_cuda.roi_align_fwd(feats, lvl, y0, x0, wy, wx, k).float()
    ref = roi_align_cuda.roi_align_fwd_plain(feats, lvl, y0, x0, wy, wx, k).float()
    torch.cuda.synchronize()
    assert launches("k2") == before + 1
    rtol = 2.0 ** -7 if dtype == BF else 1e-5
    torch.testing.assert_close(got, ref, rtol=rtol, atol=1e-5, equal_nan=True)
    assert torch.isnan(got[[1, 33]]).all() and torch.isfinite(got[[0, 32]]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c", [
    (torch.bfloat16, 256), (torch.float32, 256),  # the main path's width: 16-byte lanes
    (torch.bfloat16, 512), (torch.float32, 512),  # middle fusion's concatenated streams
    (torch.bfloat16, 20), (torch.float32, 6),  # not a multiple of the vector width
])
def test_roi_align_kernel_wide_and_ragged_channels(dtype, c):
    """80 RoIs (one CTA each) with hazard boxes, at C = 256 and 512 and at
    widths the 16-byte path does not take. Tolerance as in
    ``test_roi_align_kernel_matches_plain``."""
    _cuda()
    feats, lvl, y0, x0, wy, wx, k = _roi_case(dtype, c=c, k=40, hazards=True)
    got = roi_align_cuda.roi_align_fwd(feats, lvl, y0, x0, wy, wx, k).float()
    ref = roi_align_cuda.roi_align_fwd_plain(feats, lvl, y0, x0, wy, wx, k).float()
    torch.cuda.synchronize()
    assert got.shape == (80, 7, 7, c)
    rtol = 2.0 ** -7 if dtype == BF else 1e-5
    torch.testing.assert_close(got, ref, rtol=rtol, atol=1e-5, equal_nan=True)
    assert torch.equal(torch.isnan(got), torch.isnan(ref)) and torch.isnan(got).any()


def _bwd_case(dtype, seed=1, **kw):
    """K3's inputs: the K2 case's windows plus a seeded cotangent."""
    feats, lvl, y0, x0, wy, wx, k = _roi_case(dtype, **kw)
    rng = np.random.RandomState(seed)
    p = wy.shape[1]
    g = torch.from_numpy(rng.randn(wy.shape[0], p, p, feats[0].shape[-1]).astype(np.float32))
    return [tuple(f.shape) for f in feats], lvl, y0, x0, wy, wx, k, g.cuda().to(dtype)


def _abs_backward(shapes, lvl, y0, x0, wy, wx, k, g):
    """The plain backward of |g| with |weights| in f32: the sum of the
    magnitudes of every term, the scale of summation-order differences."""
    return t_ra.roi_align_bwd_plain(g.float().abs(), shapes, lvl, y0, x0, wy.abs(), wx.abs(), k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_bwd_kernel_matches_plain(dtype):
    """Tolerance: both sum the same products in f32, the kernel in a fixed
    order (RoI order per element, q order per RoI), the plain version in
    its einsums' and ``index_add_``'s: 1e-5 of the sum of the terms'
    magnitudes. In bf16 the f32 u may round to the neighbouring bf16 value
    (2^-8 of that sum) and the result to the neighbouring one (one bf16
    ulp, rtol 2^-7). NaN windows (the NaN box) must match."""
    _cuda()
    shapes, lvl, y0, x0, wy, wx, k, g = _bwd_case(dtype)
    before = launches("k3")
    got = roi_align_cuda.roi_align_bwd(g, shapes, lvl, y0, x0, wy, wx, k)
    ref = t_ra.roi_align_bwd_plain(g, shapes, lvl, y0, x0, wy, wx, k)
    mag = _abs_backward(shapes, lvl, y0, x0, wy, wx, k, g)
    torch.cuda.synchronize()
    assert launches("k3") == before + 1
    bf = dtype == BF
    for a, r, m, s in zip(got, ref, mag, shapes):
        assert a.shape == s and a.dtype == dtype
        a, r = a.float(), r.float()
        assert torch.equal(torch.isnan(a), torch.isnan(r))
        fin = ~torch.isnan(r)
        bound = (2.0 ** -7 * r.abs() + 2.0 ** -8 * m) if bf else 1e-5 * m + 1e-6
        assert ((a - r).abs()[fin] <= bound[fin]).all()
    assert any(torch.isnan(a).any() for a in got) and all(torch.isfinite(a).any() for a in got)


def _bwd_windows(shapes, boxes, dtype, seed=2):
    """K3's inputs for (B, K, 4) image-space boxes on levels of the given
    (B, H, W, C) shapes (strides 4, 8, ...), with a seeded cotangent."""
    feats = [torch.empty(s, device="cuda") for s in shapes]
    bx = torch.from_numpy(np.asarray(boxes, np.float32)).cuda()
    lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(feats, bx, STRIDES[:len(shapes)])
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(rng.randn(wy.shape[0], 7, 7, shapes[0][-1]).astype(np.float32))
    return shapes, lvl, y0, x0, wy, wx, bx.shape[1], g.cuda().to(dtype)


def _bwd_scattered(shapes, k, seed=3):
    """k boxes of 8-60 px anywhere on the first level's map."""
    rng = np.random.RandomState(seed)
    b, h, w = shapes[0][:3]
    xy = rng.rand(b, k, 2) * [4 * w - 8, 4 * h - 8]
    wh = rng.rand(b, k, 2) * 52 + 8
    return np.concatenate([xy, xy + wh], -1)


def _bwd_inputs(case):
    if case.startswith("c="):  # channel widths: 1 and 8 below the 16-byte chunk, 512 the concat
        width, _, dtype = case[2:].partition(" ")
        return _bwd_case(torch.float32 if dtype == "f32" else BF, c=int(width), k=40, hazards=True)
    if case.startswith("hazards"):
        return _bwd_case(BF if case.endswith("bf16") else torch.float32, c=64, k=40, hazards=True)
    if case == "dense tile":
        # 512 identical boxes and 512 scattered over one 16x16 tile of p2
        rng = np.random.RandomState(4)
        xy = 64 + rng.rand(2, 512, 2) * 40
        scattered = np.concatenate([xy, xy + 8 + rng.rand(2, 512, 2) * 16], -1)
        same = np.broadcast_to(np.array([70.0, 66.0, 118.0, 121.0]), (2, 512, 4))
        shapes = [(2, 64 >> i, 80 >> i, 32) for i in range(4)]
        return _bwd_windows(shapes, np.concatenate([same, scattered], 1), BF)
    if case == "ragged one level":
        shapes = [(2, 13, 19, 24)]
        return _bwd_windows(shapes, _bwd_scattered(shapes, 24), BF)
    assert case == "ragged four levels"
    shapes = [(2, 37, 45, 24), (2, 19, 23, 24), (2, 10, 12, 24), (2, 5, 6, 24)]
    boxes = _bwd_scattered(shapes, 48)
    boxes[:, :8] = [[0.0, 0.0, 300.0, 260.0], [10.0, 5.0, 620.0, 600.0]] * 4  # p4 / p5
    return _bwd_windows(shapes, boxes, BF)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "dense tile", "c=1", "c=8", "c=256", "c=512", "c=512 f32", "ragged one level", "ragged four levels",
    "hazards bf16", "hazards f32",
])
def test_roi_align_bwd_kernel_cases(case):
    """K3 on the shapes its tiling has to get right: dense tiles (1024 RoIs
    of an image on one 16x16 region of p2, four rounds of candidates),
    widths below, at and above the 64-channel chunk, level maps that are
    not tile multiples, one and four levels, hazard boxes (NaN windows).
    Two calls give bitwise-equal results (fixed summation order), each call
    adds one launch. Tolerance as in
    ``test_roi_align_bwd_kernel_matches_plain``."""
    _cuda()
    shapes, lvl, y0, x0, wy, wx, k, g = _bwd_inputs(case)
    before = launches("k3")
    got = roi_align_cuda.roi_align_bwd(g, shapes, lvl, y0, x0, wy, wx, k)
    assert launches("k3") == before + 1
    again = roi_align_cuda.roi_align_bwd(g, shapes, lvl, y0, x0, wy, wx, k)
    assert launches("k3") == before + 2
    ref = t_ra.roi_align_bwd_plain(g, shapes, lvl, y0, x0, wy, wx, k)
    mag = _abs_backward(shapes, lvl, y0, x0, wy, wx, k, g)
    torch.cuda.synchronize()
    bf = g.dtype == BF
    for a, a2, r, m, s in zip(got, again, ref, mag, shapes):
        assert a.shape == s and a.dtype == g.dtype
        assert torch.equal(_bits(a), _bits(a2))
        a, r = a.float(), r.float()
        assert torch.equal(torch.isnan(a), torch.isnan(r))
        fin = ~torch.isnan(r)
        bound = (2.0 ** -7 * r.abs() + 2.0 ** -8 * m) if bf else 1e-5 * m + 1e-6
        assert ((a - r).abs()[fin] <= bound[fin]).all()
    assert any(float(a.float().abs().nan_to_num().sum()) > 0 for a in got)
    assert any(torch.isnan(a.float()).any() for a in got) == case.startswith(("hazards", "c="))


def _c4_case(dtype, c, k=40, seed=5):
    """The C4 pooler's inputs at P = 14: one stride-16 level (2, 50, 64, C),
    the res4 map of an 800x1024 batch, and (2, k, 4) boxes of 16-616 px,
    every box on that level; the first image's include the hazard boxes,
    whose non-finite windows cover its whole map."""
    rng = np.random.RandomState(seed)
    feat = torch.from_numpy(rng.rand(2, 50, 64, c).astype(np.float32)).cuda().to(dtype)
    xy = rng.rand(2, k, 2) * [1000.0, 780.0]
    boxes = np.concatenate([xy, xy + rng.rand(2, k, 2) * 600 + 16], -1).astype(np.float32)
    boxes[0, :len(HAZARDS)] = HAZARDS
    bx = torch.from_numpy(boxes).cuda()
    zero = torch.zeros(bx.shape[:2], dtype=torch.int32, device="cuda")
    lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs([feat], bx, [16], 14, 0, min_level=0,
                                                          levels=zero)
    return [feat], lvl, y0, x0, wy, wx, k


def _p14_case(case, dtype):
    if case == "c4":  # C = 1024 on the 16-byte path; C = 20 on the scalar path
        return _c4_case(dtype, 1024 if dtype == BF else 256)
    if case == "c4 ragged":
        return _c4_case(dtype, 20)
    assert case == "four levels"
    return _roi_case(dtype, c=64, k=40, hazards=True, p=14)


P14_CASES = [(case, dtype) for case in ("c4", "c4 ragged", "four levels")
             for dtype in (BF, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", P14_CASES)
def test_roi_align_kernel_p14(case, dtype):
    """K2's P = 14 instance (14 warps, q in two blocks of 7) against its
    plain version: the C4 pooler's single level at C = 1024 (bf16; 256 in
    f32) and C = 20, and the FPN's four levels, with hazard boxes.
    Tolerance as in ``test_roi_align_kernel_matches_plain``."""
    _cuda()
    feats, lvl, y0, x0, wy, wx, k = _p14_case(case, dtype)
    before = launches("k2")
    got = roi_align_cuda.roi_align_fwd(feats, lvl, y0, x0, wy, wx, k).float()
    ref = roi_align_cuda.roi_align_fwd_plain(feats, lvl, y0, x0, wy, wx, k).float()
    torch.cuda.synchronize()
    assert launches("k2") == before + 1
    assert got.shape == (2 * k, 14, 14, feats[0].shape[-1])
    rtol = 2.0 ** -7 if dtype == BF else 1e-5
    torch.testing.assert_close(got, ref, rtol=rtol, atol=1e-5, equal_nan=True)
    assert torch.equal(torch.isnan(got), torch.isnan(ref)) and torch.isnan(got).any()
    assert float(got.nan_to_num().abs().sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", P14_CASES)
def test_roi_align_bwd_kernel_p14(case, dtype):
    """K3's P = 16 instance (one RoI per step, 16 weight slots; bf16 on the
    tensor cores with one RoI per MMA) at P = 14 against its plain version
    on the cases of ``test_roi_align_kernel_p14``, and two calls bitwise
    equal. Tolerance as in ``test_roi_align_bwd_kernel_matches_plain``."""
    _cuda()
    feats, lvl, y0, x0, wy, wx, k = _p14_case(case, dtype)
    shapes = [tuple(f.shape) for f in feats]
    rng = np.random.RandomState(6)
    g = torch.from_numpy(rng.randn(wy.shape[0], 14, 14, shapes[0][-1]).astype(np.float32))
    g = g.cuda().to(dtype)
    before = launches("k3")
    got = roi_align_cuda.roi_align_bwd(g, shapes, lvl, y0, x0, wy, wx, k)
    again = roi_align_cuda.roi_align_bwd(g, shapes, lvl, y0, x0, wy, wx, k)
    ref = t_ra.roi_align_bwd_plain(g, shapes, lvl, y0, x0, wy, wx, k)
    mag = _abs_backward(shapes, lvl, y0, x0, wy, wx, k, g)
    torch.cuda.synchronize()
    assert launches("k3") == before + 2
    bf = dtype == BF
    for a, a2, r, m, s in zip(got, again, ref, mag, shapes):
        assert a.shape == s and a.dtype == dtype
        assert torch.equal(_bits(a), _bits(a2))
        a, r = a.float(), r.float()
        assert torch.equal(torch.isnan(a), torch.isnan(r))
        fin = ~torch.isnan(r)
        bound = (2.0 ** -7 * r.abs() + 2.0 ** -8 * m) if bf else 1e-5 * m + 1e-6
        assert ((a - r).abs()[fin] <= bound[fin]).all()
    assert any(torch.isnan(a.float()).any() for a in got)
    assert any(float(a.float().abs().nan_to_num().sum()) > 0 for a in got)


@pytest.mark.cuda
def test_single_level_roi_align_kernel_gradients_p14():
    """``single_level_roi_align`` at P = 14 through K2 and K3 (the C4
    pooler) against both plain versions, forward and gradient, in f32."""
    _cuda()
    rng = np.random.RandomState(7)
    feat = torch.from_numpy(rng.rand(2, 50, 64, 64).astype(np.float32)).cuda().requires_grad_()
    xy = rng.rand(2, 24, 2) * [900.0, 700.0]
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.rand(2, 24, 2) * 300 + 16], -1)
                             .astype(np.float32)).cuda()
    go = torch.randn(2, 24, 14, 14, 64, device="cuda")
    before = (launches("k2"), launches("k3"))
    outs, grads = {}, {}
    for impl in ("kernel", "plain"):
        outs[impl] = roi_align_cuda.single_level_roi_align(feat, boxes, 16, 14, impl=impl)
        grads[impl], = torch.autograd.grad(outs[impl], feat, go)
    assert (launches("k2"), launches("k3")) == (before[0] + 1, before[1] + 1)
    assert outs["kernel"].shape == (2, 24, 14, 14, 64)
    torch.testing.assert_close(outs["kernel"], outs["plain"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads["kernel"], grads["plain"], rtol=1e-5, atol=1e-5)
    assert float(grads["kernel"].abs().sum()) > 0


@pytest.mark.cuda
def test_kernel_functions_pass_gradients():
    """K1 (the op ``proben::stem_pool``: kernel forward, plain recomputed
    backward) and K2/K3 (``proben::roi_align_fwd`` with the backward op)
    hand their inputs the plain composition's gradients."""
    _cuda()
    x, w, scale, bias = [torch.from_numpy(a).cuda().to(BF) for a in _stem_inputs(1, 32, 48, 3)]
    leaves = [t.clone().requires_grad_() for t in (w, scale, bias)]
    out = stem_cuda.stem_pool(x, *leaves)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, g)
    plain = [t.clone().requires_grad_() for t in (w, scale, bias)]
    want = torch.autograd.grad(stem_cuda.stem_pool_plain(x, *plain), plain, g)
    for a, b in zip(got, want):
        assert torch.isfinite(a.float()).all() and a.float().abs().max() > 0
        torch.testing.assert_close(a.float(), b.float(), rtol=0.05, atol=0.05 * float(b.float().abs().max()))

    feats = [torch.rand(2, 64 >> i, 64 >> i, 32, device="cuda").requires_grad_() for i in range(4)]
    boxes = torch.tensor([[[2.0, 3.0, 40.0, 30.0], [0.0, 0.0, 200.0, 180.0]]] * 2, device="cuda")
    go = torch.randn(2, 2, 7, 7, 32, device="cuda")
    grads = {}
    for impl in ("kernel", "plain"):
        out = roi_align_cuda.multilevel_roi_align(feats, boxes, STRIDES, impl=impl)
        grads[impl] = torch.autograd.grad(out, feats, go)
    for a, b in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert sum(float(a.abs().sum()) > 0 for a in grads["kernel"]) >= 2


def test_stem_function_backward_is_the_plain_gradient_cpu():
    """On CPU tensors the op ``proben::stem_pool`` runs the plain version
    forward and recomputes it in its registered backward: its gradients equal autograd through the
    plain composition exactly, for each input that asks for one."""
    x, w, scale, bias = [torch.from_numpy(a).to(BF) for a in _stem_inputs(1, 20, 28, 3)]
    g = torch.from_numpy(np.random.RandomState(2).randn(1, 5, 7, 64).astype(np.float32)).to(BF)
    leaves = [w.clone().requires_grad_(), scale.clone(), bias.clone().requires_grad_()]
    got = torch.autograd.grad(stem_cuda.stem_pool(x, *leaves), [leaves[0], leaves[2]], g)
    plain = [w.clone().requires_grad_(), scale.clone(), bias.clone().requires_grad_()]
    want = torch.autograd.grad(stem_cuda.stem_pool_plain(x, *plain), [plain[0], plain[2]], g)
    for a, b in zip(got, want):
        assert a.float().abs().max() > 0
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_stem_wrapper_rejects_unsupported_input():
    x = torch.zeros(1, 32, 32, 3, dtype=BF)
    w = torch.zeros(7, 7, 3, 64, dtype=BF)
    s = torch.zeros(64, dtype=BF)
    with pytest.raises(ValueError, match="device"):
        stem_cuda.stem_pool(x.to("meta"), w, s, s)


def test_roi_align_wrapper_rejects_unsupported_input():
    f = [torch.zeros(1, 8, 8, 4, device="meta")]
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="device"):
        roi_align_cuda.roi_align_fwd(f, z, z, z, torch.zeros(1, 7, 56), torch.zeros(1, 7, 64), 1)


def test_roi_align_bwd_wrapper_rejects_unsupported_input():
    z = torch.zeros(2, dtype=torch.int32, device="meta")
    wy, wx = torch.zeros(2, 7, 56, device="meta"), torch.zeros(2, 7, 64, device="meta")
    g = torch.zeros(2, 7, 7, 4, device="meta")
    shapes = [(1, 8, 8, 4)]
    with pytest.raises(ValueError, match="device"):
        roi_align_cuda.roi_align_bwd(g, shapes, z, z, z, wy, wx, 2)


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors the wrappers compute the plain versions and launch
    nothing."""
    before = (launches("k1"), launches("k2"), launches("k3"))
    args = [torch.from_numpy(a) for a in _stem_inputs(1, 16, 24, 3)]
    torch.testing.assert_close(stem_cuda.stem_pool(*args), stem_cuda.stem_pool_plain(*args))
    feats = [torch.rand(1, 16 >> i, 16 >> i, 8) for i in range(4)]
    boxes = torch.tensor([[[2.0, 3.0, 40.0, 30.0], [0.0, 0.0, 64.0, 64.0]]])
    a = roi_align_cuda.multilevel_roi_align(feats, boxes, STRIDES, impl="kernel")
    b = roi_align_cuda.multilevel_roi_align(feats, boxes, STRIDES, impl="plain")
    torch.testing.assert_close(a, b)
    lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(feats, boxes, STRIDES)
    g = torch.rand(2, 7, 7, 8)
    shapes = [tuple(f.shape) for f in feats]
    for d, e in zip(roi_align_cuda.roi_align_bwd(g, shapes, lvl, y0, x0, wy, wx, 2),
                    t_ra.roi_align_bwd_plain(g, shapes, lvl, y0, x0, wy, wx, 2)):
        torch.testing.assert_close(d, e)
    assert (launches("k1"), launches("k2"), launches("k3")) == before


@pytest.mark.cuda
def test_custom_ops_on_the_card_match_their_plain_versions():
    """The ``torch.library`` ops called directly on CUDA tensors: K1, K2 and
    K3 (one launch each) against their plain versions on the same inputs,
    with the tolerances of the wrapper tests above; NMS's fixpoint op on
    the card equal to its CPU run."""
    _cuda()
    x, w, scale, bias = [torch.from_numpy(a).cuda().to(BF) for a in _stem_inputs(1, 30, 98, 4)]
    before = (launches("k1"), launches("k2"), launches("k3"))
    got = torch.ops.proben.stem_pool(x, w, scale, bias).float()
    torch.testing.assert_close(got, stem_cuda.stem_pool_plain(x, w, scale, bias).float(),
                               rtol=2.0 ** -6, atol=0.05)
    feats = [torch.rand(2, 64 >> i, 64 >> i, 32, device="cuda") for i in range(4)]
    boxes = torch.tensor([[[2.0, 3.0, 40.0, 30.0], [10.0, 5.0, 120.0, 100.0]]] * 2, device="cuda")
    lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(feats, boxes, STRIDES)
    pooled = torch.ops.proben.roi_align_fwd(feats, lvl, y0, x0, wy, wx, 2)
    torch.testing.assert_close(pooled, roi_align_cuda.roi_align_fwd_plain(feats, lvl, y0, x0, wy, wx, 2),
                               rtol=1e-5, atol=1e-5)
    g = torch.randn_like(pooled)
    shapes = [tuple(f.shape) for f in feats]
    dfs = torch.ops.proben.roi_align_bwd(g, [d for s in shapes for d in s], lvl, y0, x0, wy, wx, 2)
    for a, b in zip(dfs, t_ra.roi_align_bwd_plain(g, shapes, lvl, y0, x0, wy, wx, 2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert (launches("k1"), launches("k2"), launches("k3")) == tuple(
        n + 1 for n in before)
    rng = np.random.RandomState(4)
    xy = rng.rand(3, 60, 2) * 50
    b = torch.from_numpy(np.concatenate([xy, xy + 8 + rng.rand(3, 60, 2) * 20], -1).astype(np.float32))
    suppress = (pairwise_iou(b, b) > 0.3) & torch.ones(60, 60, dtype=torch.bool).triu(1)
    valid = torch.from_numpy(rng.rand(3, 60) > 0.1)
    want = torch.ops.proben.nms_fixpoint(suppress, valid)
    assert torch.equal(torch.ops.proben.nms_fixpoint(suppress.cuda(), valid.cuda()).cpu(), want)


@pytest.mark.cuda
def test_opcheck_on_cuda_tensors():
    """``torch.library.opcheck`` (schema, fake, autograd registration,
    dispatch) on each op's CUDA implementation."""
    _cuda()
    x, w, scale, bias = [torch.from_numpy(a).cuda().to(BF) for a in _stem_inputs(1, 20, 28, 3)]
    torch.library.opcheck(torch.ops.proben.stem_pool.default, (x, w.requires_grad_(), scale, bias))
    feats = [torch.rand(2, 32 >> i, 40 >> i, 8, device="cuda").requires_grad_() for i in range(4)]
    boxes = torch.tensor([[[2.0, 3.0, 40.0, 30.0], [0.0, 0.0, 100.0, 90.0]]] * 2, device="cuda")
    lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(feats, boxes, STRIDES)
    torch.library.opcheck(torch.ops.proben.roi_align_fwd.default, (feats, lvl, y0, x0, wy, wx, 2))
    g = torch.randn(4, 7, 7, 8, device="cuda")
    shapes = [d for f in feats for d in f.shape]
    torch.library.opcheck(torch.ops.proben.roi_align_bwd.default, (g, shapes, lvl, y0, x0, wy, wx, 2))
    bx = boxes.reshape(-1, 4)
    suppress = (pairwise_iou(bx, bx) > 0.3) & torch.ones(4, 4, dtype=torch.bool, device="cuda").triu(1)
    torch.library.opcheck(torch.ops.proben.nms_fixpoint.default,
                          (suppress, torch.ones(4, dtype=torch.bool, device="cuda")))
    torch.library.opcheck(torch.ops.proben.nms_keep.default,
                          (bx, torch.ones(4, dtype=torch.bool, device="cuda"), 0.3))


# ---------------------------------------------------------------------------
# K4: the bottleneck epilogue, forward and backward
# ---------------------------------------------------------------------------

# the cells' stage maps (16 images on the 800x1024 canvas: width maps and
# block outputs of res2..res5), then ragged rows, odd channel counts and the
# C4 head's RoI maps
EPILOGUE_SHAPES = [
    (16, 64, 200, 256), (16, 256, 200, 256), (16, 128, 100, 128), (16, 512, 100, 128),
    (16, 256, 50, 64), (16, 1024, 50, 64), (16, 512, 25, 32), (16, 2048, 25, 32),
    (3, 72, 7, 11), (1, 8, 1, 1), (2, 24, 3, 5), (1, 1536, 9, 13), (40, 2048, 7, 7),
]


def _epilogue_case(shape, mode, seed=0, plant=True):
    """CUDA bf16 channels_last maps and f32 parameters; ``plant``: NaN, +-inf
    and -0.0 among the map values, a -0.0 scale and a NaN bias. ``mode`` 0:
    no residual, 1: identity, 2: projection shortcut."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, c, h, w = shape

    def amap():
        t = (torch.randn(n, h, w, c, generator=gen, device="cuda") * 2).to(BF)
        if plant:
            flat = t.view(-1)
            idx = torch.randint(0, flat.numel(), (4 + flat.numel() // 997,), generator=gen,
                                device="cuda")
            flat[idx] = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0], dtype=BF,
                                     device="cuda").repeat(len(idx) // 4 + 1)[:len(idx)]
        return t.permute(0, 3, 1, 2)  # channels_last

    def params():
        s = torch.randn(c, generator=gen, device="cuda") * 1.5
        b = torch.randn(c, generator=gen, device="cuda")
        if plant:
            s[0], b[min(1, c - 1)] = -0.0, float("nan")
        return s, b

    x = amap()
    s, b = params()
    if mode == 0:
        return x, s, b, None, None, None
    if mode == 1:
        return x, s, b, amap(), None, None
    return (x, s, b, amap()) + params()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
def test_epilogue_kernel_is_the_plain_route_bitwise(shape):
    """K4's forward keeps every rounding point of the composition it
    replaces: its output equals the plain route's bit for bit (int16 views),
    NaN payloads, infinities and signed zeros included, in all three
    modes."""
    _cuda()
    for mode in range(3):
        args = _epilogue_case(shape, mode, seed=mode)
        assert epilogue_cuda.kernel_takes(*args)
        before = launches("k4")
        got = epilogue_cuda.block_epilogue(*args)
        want = epilogue_cuda.block_epilogue_plain(*args)
        torch.cuda.synchronize()
        assert launches("k4") == before + 1
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(_bits(got), _bits(want)), (shape, mode)


def _sums_close(got, want, terms=None):
    """Per-channel sums, each rounded to bf16: NaN where NaN, infinities
    equal, and the rest within one bf16 ulp of the larger magnitude plus, for
    the (N, C, H, W) addends ``terms``, the f32 rounding two summation orders
    of them can differ by: each order a chain of under 512 additions (K4's:
    a thread's rows, the CTA's rows of threads, a group of partials, the
    groups), so at most 2^-14 of the channel's sum of |terms|. That term
    matters only where a channel's sum cancels to far below its addends."""
    nan = torch.isnan(want)
    assert torch.equal(nan, torch.isnan(got))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    keep = ~(nan | inf)
    g, w = got[keep], want[keep]
    tol = torch.ldexp(torch.ones_like(w), torch.frexp(torch.maximum(g.abs(), w.abs())).exponent - 8)
    if terms is not None:
        tol = tol + 2.0 ** -14 * terms.float().abs().sum((0, 2, 3))[keep]
    assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
def test_epilogue_backward_kernel_matches_plain(shape):
    """K4's backward: the map gradients (the conv output's, the identity
    residual's, the shortcut conv output's) equal the plain backward's bit
    for bit; the parameter gradients (f32 sums in another order, rounded to
    bf16) lie within one bf16 ulp of it (``_sums_close``: more only where a
    channel's sum cancels) and are identical from run to run.
    Finite inputs, then the planted non-finite values and signed zeros."""
    _cuda()
    for mode, plant in [(m, p) for p in (False, True) for m in range(3)]:
        x, s, b, r, rs, rb = _epilogue_case(shape, mode, seed=10 + mode, plant=plant)
        y = epilogue_cuda.block_epilogue(x, s, b, r, rs, rb)
        g = _epilogue_case(shape, 0, seed=20 + mode, plant=plant)[0]
        shortcut = r if mode == 2 else None
        before = launches("k4")
        got = torch.ops.proben.block_epilogue_bwd(g, y, x, s, shortcut, rs, mode > 0)
        again = torch.ops.proben.block_epilogue_bwd(g, y, x, s, shortcut, rs, mode > 0)
        want = epilogue_cuda.block_epilogue_bwd_plain(g, y, x, s, shortcut, rs, mode > 0)
        torch.cuda.synchronize()
        assert launches("k4") == before + 2
        assert len(got) == len(want) == (3, 4, 6)[mode]
        gm = torch.ops.aten.threshold_backward(g, y, 0)
        terms = {1: gm * x, 2: gm, 4: gm * r if mode == 2 else None, 5: gm}
        for i, (a, a2, w) in enumerate(zip(got, again, want)):
            assert a.dtype == w.dtype and a.shape == w.shape
            assert torch.equal(_bits(a), _bits(a2)), (shape, mode, i)
            if i in terms:
                _sums_close(a, w, terms[i])
            else:  # the maps' gradients
                assert torch.equal(_bits(a), _bits(w)), (shape, mode, i)


@pytest.mark.cuda
def test_epilogue_gate_on_the_card():
    """NCHW-contiguous and f32 CUDA maps take the plain composition (counted
    as ``epilogue.plain``, no K4 launch) and give its values; autograd
    through ``block_epilogue`` on the card (``_K4``) equals autograd through
    the composition (maps bitwise, parameters within one bf16 ulp) and, bit
    for bit, autograd through the op's own registered backward."""
    _cuda()
    x, s, b, r, rs, rb = _epilogue_case((2, 64, 12, 20), 2)
    for xx, rr in ((x.contiguous(), r.contiguous()), (x.float(), r.float())):
        assert not epilogue_cuda.kernel_takes(xx, s, b, rr, rs, rb)
        before = (launches("k4"), tracing.counters().get("epilogue.plain", 0))
        got = epilogue_cuda.block_epilogue(xx, s, b, rr, rs, rb)
        want = epilogue_cuda.block_epilogue_plain(xx, s, b, rr, rs, rb)
        assert torch.equal(_bits(got), _bits(want))
        assert (launches("k4"), tracing.counters().get("epilogue.plain", 0)) == (
            before[0], before[1] + 1)
    x, s, b, r, rs, rb = _epilogue_case((2, 64, 12, 20), 2, plant=False)
    go = torch.randn(x.shape, device="cuda").to(BF).contiguous(memory_format=torch.channels_last)
    grads = {}
    for name, fn in (("k4", epilogue_cuda.block_epilogue), ("op", torch.ops.proben.block_epilogue),
                     ("plain", epilogue_cuda.block_epilogue_plain)):
        leaves = [t.clone().requires_grad_() for t in (x, s, b, r, rs, rb)]
        grads[name] = torch.autograd.grad(fn(*leaves), leaves, go)
    for i, (a, o, w) in enumerate(zip(grads["k4"], grads["op"], grads["plain"])):
        assert torch.equal(_bits(a), _bits(o)), i
        if i in (0, 3):
            assert torch.equal(_bits(a), _bits(w)), i
        else:
            _sums_close(a, w)


@pytest.mark.cuda
def test_epilogue_export_records_the_op_with_grad_on():
    """``torch.export`` traces fake tensors with grad on, here with
    parameters that require grad: the trace records the op (its fake), not
    ``_K4``, whose launch cannot run on fake tensors; the loaded program
    launches K4 and equals eager bit for bit."""
    _cuda()
    x, s, b, r, rs, rb = _epilogue_case((2, 64, 12, 20), 2, plant=False)

    class Epilogue(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.s, self.b, self.rs, self.rb = (torch.nn.Parameter(t.clone()) for t in (s, b, rs, rb))

        def forward(self, x, r):
            return epilogue_cuda.block_epilogue(x, self.s, self.b, r, self.rs, self.rb)

    module = Epilogue()
    assert torch.is_grad_enabled() and module.s.requires_grad
    program = torch.export.export(module, (x, r))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("proben.block_epilogue.default") == 1, targets
    before = launches("k4")
    with torch.no_grad():
        got = program.module()(x, r)
        want = module(x, r)
    torch.cuda.synchronize()
    assert launches("k4") == before + 2
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_exported_bottleneck_launches_k4():
    """An exported bottleneck, its convolutions included (a trace's fake
    convolution output is NCHW-contiguous where cuDNN's is channels_last),
    holds three ``proben.block_epilogue`` nodes; the loaded program launches
    K4 three times, runs no plain epilogue and equals eager bit for bit."""
    _cuda()
    from proben_tpu_torch.models import resnet

    torch.manual_seed(0)
    block = resnet.Bottleneck(64, 32, 128, True)
    for p in block.parameters():
        p.data = (torch.randn(p.shape) * 0.3 + (1.0 if p.dim() == 1 else 0.0)).cuda().contiguous(
            memory_format=torch.channels_last if p.dim() == 4 else torch.contiguous_format)
    x = torch.randn(2, 64, 12, 20, device="cuda").to(BF).contiguous(memory_format=torch.channels_last)

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block = block

        def forward(self, x):
            return resnet._bottleneck(self.block, x, 2, BF)

    with torch.no_grad():
        program = torch.export.export(Block(), (x,))
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert targets.count("proben.block_epilogue.default") == 3, targets
        before = (launches("k4"), tracing.counters().get("epilogue.plain", 0))
        got = program.module()(x)
        torch.cuda.synchronize()
        assert (launches("k4") - before[0], tracing.counters().get("epilogue.plain", 0) - before[1]) == (3, 0)
        want = resnet._bottleneck(block, x, 2, BF)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_predict_batch_with_k4_equals_the_plain_route(monkeypatch):
    """A seeded bf16 R50-FPN batch through ``Predictor.predict_batch`` gives
    the same detections bit for bit with K4 (3 launches a block, no plain
    epilogue) and with K4 turned off inside this test (every epilogue the
    plain composition), in one process."""
    _cuda()
    from proben_tpu_torch.engine import Predictor
    from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines

    cfg = build_config(depth=50, compute_dtype="bfloat16")
    model = build_model(cfg, params=random_affines(init_rcnn(0, cfg), 0))
    rng = np.random.RandomState(7)
    images = torch.from_numpy((rng.rand(4, 320, 416, 3) * 255).astype(np.float32)).cuda()
    sizes = torch.tensor([[320, 416], [300, 400], [320, 380], [256, 416]], dtype=torch.int32)
    batch = {"image": images, "image_size": sizes, "orig_size": sizes, "image_id": list(range(4))}
    pred = Predictor(model, cfg)
    outs, counts = [], []
    for off in (False, True):
        if off:
            monkeypatch.setattr(epilogue_cuda, "kernel_takes", lambda *a: False)
        before = (launches("k4"), tracing.counters().get("epilogue.plain", 0))
        outs.append(pred.predict_batch(batch))
        torch.cuda.synchronize()
        counts.append((launches("k4") - before[0],
                       tracing.counters().get("epilogue.plain", 0) - before[1]))
    assert counts == [(48, 0), (0, 48)]  # R50: 16 blocks x 3 epilogues
    assert sum(len(o["boxes"]) for o in outs[0]) > 0
    for a, b in zip(*outs):
        for key in ("boxes", "scores", "classes"):
            assert np.array_equal(a[key], b[key]), key


# ---------------------------------------------------------------------------
# K5: greedy NMS as a bitmask and a block sweep
# ---------------------------------------------------------------------------


def _nms_on_card(args, t, classes=None, plain=False):
    """``nms_mask`` (``batched_nms_mask`` with class ids) on CUDA tensors:
    through K5, or with ``plain`` through the dense route on the card. The
    keep mask on the host and the K5 launches and fixpoint iterations it
    counted."""
    fn = nms.nms_mask if classes is None else (
        lambda b, s, v, th: nms.batched_nms_mask(b, s, classes, v, th))
    with pytest.MonkeyPatch.context() as m:
        if plain:
            m.setattr(nms, "nms_keep", nms.nms_keep_plain)
        before = tracing.counters()
        keep = fn(*args, t)
        torch.cuda.synchronize()
        after = tracing.counters()
    counts = {k: after.get(k, 0) - before.get(k, 0) for k in ("k5.launches", "nms.iters")}
    return keep.cpu(), counts


@pytest.mark.cuda
@pytest.mark.parametrize("shape,classes,t", [
    ((16, 5, 1000), 0, 0.7), ((16, 3000), 3, 0.5), ((16, 5, 2000), 0, 0.7),
], ids=["rpn_infer", "box_head", "rpn_train"])
def test_k5_is_the_plain_route_bitwise_at_the_cells_shapes(shape, classes, t):
    """K5 at the cells' three NMS shapes (RPN inference, the box head with
    class offsets, RPN training) equals the dense route on the card and the
    CPU route bit for bit; one K5 launch a call, no fixpoint iteration; two
    calls are bitwise equal."""
    _cuda()
    boxes, scores, valid, ids = cell_problems(shape, seed=sum(shape), classes=classes)
    args = [torch.from_numpy(a).cuda() for a in (boxes, scores, valid)]
    cls = None if ids is None else torch.from_numpy(ids).cuda()
    got, counts = _nms_on_card(args, t, cls)
    assert counts == {"k5.launches": 1, "nms.iters": 0}
    again, _ = _nms_on_card(args, t, cls)
    plain, plain_counts = _nms_on_card(args, t, cls, plain=True)
    assert plain_counts["k5.launches"] == 0 and plain_counts["nms.iters"] > 0
    assert torch.equal(got, again) and torch.equal(got, plain)
    cpu_args = [a.cpu() for a in args]
    want = (nms.nms_mask(*cpu_args, t) if cls is None
            else nms.batched_nms_mask(cpu_args[0], cpu_args[1], cls.cpu(), cpu_args[2], t))
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 624, 1000, 8192])
def test_k5_planted_cases(n):
    """K5 on the planted problems (chains through the whole problem, ties,
    IoUs at float32(t) and one ulp either side, NaN / inf / degenerate
    boxes, no valid box) equals the CPU route bit for bit. At 8192 boxes,
    the most K5 takes, the chain and the problem with no valid box against
    the dense route on the card (the CPU's fixpoint would take 8191
    iterations over 8192 x 8192 matrices) and greedy's every other box."""
    _cuda()
    for t in THRESHOLDS:
        cpu = [torch.from_numpy(a) for a in hazard_problems(n, t, seed=n)]
        if n == 8192:
            cpu = [a[[0, -1]] for a in cpu]
        args = [a.cuda() for a in cpu]
        got, counts = _nms_on_card(args, t)
        assert counts == {"k5.launches": 1, "nms.iters": 0}
        want = _nms_on_card(args, t, plain=True)[0] if n == 8192 else nms.nms_mask(*cpu, t)
        assert torch.equal(got, want), (n, t)
        if n > 64:
            assert got[0].tolist() == [i % 2 == 0 for i in range(n)]
            assert not got[-1].any()


@pytest.mark.cuda
def test_k5_wrapper_raises_on_what_it_does_not_take():
    _cuda()
    b = torch.rand(2, 10, 4, device="cuda")
    v = torch.ones(2, 10, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        nms.nms_keep(b.double(), v, 0.5)
    with pytest.raises(ValueError, match="at most 8192"):
        nms.nms_keep(torch.rand(1, 8193, 4, device="cuda"), torch.ones(1, 8193, dtype=torch.bool,
                                                                        device="cuda"), 0.5)
    with pytest.raises(ValueError, match="bad shapes"):
        nms.nms_keep(b, v[:, :9], 0.5)
    assert nms.nms_keep(b[:, :0], v[:, :0], 0.5).shape == (2, 0)


def _r50_bf16(seed=0):
    from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines

    cfg = build_config(depth=50, num_classes=3, compute_dtype="bfloat16")
    return cfg, build_model(cfg, params=random_affines(init_rcnn(seed, cfg), seed))


@pytest.mark.cuda
def test_predict_batch_with_k5_equals_the_plain_route(monkeypatch):
    """A seeded bf16 R50-FPN batch through ``Predictor.predict_batch``
    gives the same detections bit for bit with K5 (2 launches: the RPN's
    and the box head's NMS, no fixpoint iteration) and with the dense route
    on the card, in one process."""
    _cuda()
    from proben_tpu_torch.engine import Predictor

    cfg, model = _r50_bf16()
    rng = np.random.RandomState(7)
    images = torch.from_numpy((rng.rand(4, 320, 416, 3) * 255).astype(np.float32)).cuda()
    sizes = torch.tensor([[320, 416], [300, 400], [320, 380], [256, 416]], dtype=torch.int32)
    batch = {"image": images, "image_size": sizes, "orig_size": sizes, "image_id": list(range(4))}
    pred = Predictor(model, cfg)
    outs, counts = [], []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(nms, "nms_keep", nms.nms_keep_plain)
        before = tracing.counters()
        outs.append(pred.predict_batch(batch))
        torch.cuda.synchronize()
        after = tracing.counters()
        counts.append(tuple(after.get(k, 0) - before.get(k, 0) for k in ("k5.launches", "nms.calls")))
    assert counts == [(2, 0), (0, 2)]
    assert sum(len(o["boxes"]) for o in outs[0]) > 0
    for a, b in zip(*outs):
        for key in ("boxes", "scores", "classes"):
            assert np.array_equal(a[key], b[key]), key


@pytest.mark.cuda
def test_train_step_losses_with_k5_equal_the_plain_route(monkeypatch):
    """One bf16 R50-FPN ``train_step`` from the same weights and seed:
    its losses with K5 (one launch, the RPN's NMS) and with the dense route
    on the card are equal bit for bit."""
    _cuda()
    from proben_tpu_torch.engine import make_train_step, trainable_mask
    from proben_tpu_torch.solver import SolverConfig
    from proben_tpu_torch.structures import GroundTruth

    rng = np.random.RandomState(3)
    gt = GroundTruth(torch.tensor([[[10.0, 10.0, 160.0, 170.0], [200.0, 40.0, 300.0, 200.0]],
                                   [[30.0, 60.0, 90.0, 120.0], [0.0, 0.0, 0.0, 0.0]]], device="cuda"),
                     torch.tensor([[1, 2], [0, 0]], dtype=torch.int32, device="cuda"),
                     torch.tensor([[True, True], [True, False]], device="cuda"))
    batch = {"image": torch.from_numpy((rng.rand(2, 256, 320, 3) * 255).astype(np.float32)).cuda(),
             "image_size": torch.tensor([[256, 320], [240, 320]], dtype=torch.int32, device="cuda"),
             "gt": gt}
    losses, counts = [], []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(nms, "nms_keep", nms.nms_keep_plain)
        cfg, model = _r50_bf16()
        init_state, train_step = make_train_step(cfg, SolverConfig(), trainable_mask(model, cfg.freeze_at))
        before = tracing.counters()
        _, metrics = train_step(init_state(model, seed=0), batch)
        torch.cuda.synchronize()
        after = tracing.counters()
        counts.append(tuple(after.get(k, 0) - before.get(k, 0) for k in ("k5.launches", "nms.calls")))
        losses.append({k: v.item() for k, v in metrics.items()})
    assert counts == [(1, 0), (0, 1)]
    assert all(np.isfinite(v) for v in losses[0].values())
    assert losses[0] == losses[1]


# ---------------------------------------------------------------------------
# image_io: nvJPEG decode/encode and the compose + resize + pad kernel
# ---------------------------------------------------------------------------


def _u8(rng, h, w, c):
    """uint8 (h, w, c): 16x16 blocks of random brightness, a smooth colour
    tint and a little noise (what 4:2:0 JPEG keeps well)."""
    x = np.kron(rng.rand(h // 16 + 2, w // 16 + 2, 1), np.ones((16, 16, 1)))[:h, :w]
    tint = np.linspace(0, 30, w)[None, :, None] * rng.rand(1, 1, c)
    return np.clip(x * 150 + tint + rng.randn(h, w, c) * 2 + 40, 0, 255).astype(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["BGR", "BGRT", "BGRTTT"])
def test_image_io_kernel_matches_plain(fmt):
    """Batch of 3 with its own sizes (upscale, downscale, equal size), gray
    and colour thermal images, an RGB image smaller than its thermal frame.
    The kernel's float operations are rounded one by one in the plain
    version's order and its uint8 resize is integer arithmetic: bit for
    bit."""
    _cuda()
    from proben_tpu_torch.native import io

    rng = np.random.RandomState(0)
    thermal = [_u8(rng, 48, 64, 1), _u8(rng, 50, 40, 3), _u8(rng, 33, 47, 1)]
    rgb = [_u8(rng, 160, 180, 3), _u8(rng, 20, 24, 3), _u8(rng, 33, 47, 1)]
    sizes = [(80, 100), (30, 24), (33, 47)]
    t = [torch.from_numpy(a).cuda() for a in thermal]
    r = None if fmt == "BGR" else [torch.from_numpy(a).cuda() for a in rgb]
    before = launches("io")
    got = io.compose_resize_pad(t, r, fmt, sizes, (96, 112))
    ref = io.compose_resize_pad_plain(t, r, fmt, sizes, (96, 112))
    torch.cuda.synchronize()
    assert launches("io") == before + 1
    assert got.shape == (3, 96, 112, io.FORMATS[fmt][1])
    assert torch.equal(got, ref)
    assert not got[1, 30:].any() and not got[1, :, 24:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["BGR", "BGRT", "BGRTTT"])
def test_image_io_kernel_flips_match_plain(fmt):
    """The training flip inside the compose launch (C = 3, 4, 6): flipped
    and unflipped images in one launch, odd and even widths, equal to the
    plain version (resize, then ``torch.flip`` of the valid region) bit for
    bit, padding zero; a flipped image's canvas is its unflipped one
    mirrored."""
    _cuda()
    from proben_tpu_torch.native import io

    rng = np.random.RandomState(5)
    thermal = [_u8(rng, 48, 64, 1), _u8(rng, 50, 40, 3), _u8(rng, 33, 47, 1), _u8(rng, 40, 30, 3)]
    rgb = [_u8(rng, 160, 180, 3), _u8(rng, 20, 24, 3), _u8(rng, 33, 47, 1), _u8(rng, 64, 48, 3)]
    sizes = [(80, 101), (30, 24), (33, 47), (64, 48)]
    flips = [True, False, True, True]
    t = [torch.from_numpy(a).cuda() for a in thermal]
    r = None if fmt == "BGR" else [torch.from_numpy(a).cuda() for a in rgb]
    before = launches("io")
    got = io.compose_resize_pad(t, r, fmt, sizes, (96, 112), flips)
    ref = io.compose_resize_pad_plain(t, r, fmt, sizes, (96, 112), flips)
    unflipped = io.compose_resize_pad(t, r, fmt, sizes, (96, 112))
    torch.cuda.synchronize()
    assert launches("io") == before + 2
    assert torch.equal(got, ref)
    for i, ((h, w), f) in enumerate(zip(sizes, flips)):
        want = unflipped[i, :h, :w].flip(1) if f else unflipped[i, :h, :w]
        assert torch.equal(got[i, :h, :w], want), i
        assert not got[i, h:].any() and not got[i, :, w:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["BGR", "BGRT", "BGRTTT"])
def test_image_io_kernel_crops_match_plain(fmt):
    """The training crop inside the compose launch: windows at the frame's
    origin, inside it and at its far corner, the whole frame and none, with
    and without flips, downscaled and upscaled, an RGB file larger and one
    smaller than its thermal frame (the RGB taps read at the cropped
    composed coordinates), equal to the plain version (the composed frame
    cut to the window, then resized) bit for bit, padding zero; a window of
    the whole frame equals no window."""
    _cuda()
    from proben_tpu_torch.native import io

    rng = np.random.RandomState(6)
    thermal = [_u8(rng, 48, 64, 1), _u8(rng, 50, 40, 3), _u8(rng, 33, 47, 1), _u8(rng, 40, 30, 3),
               _u8(rng, 36, 52, 1)]
    rgb = [_u8(rng, 160, 180, 3), _u8(rng, 20, 24, 3), _u8(rng, 33, 47, 1), _u8(rng, 64, 48, 3),
           _u8(rng, 90, 130, 3)]
    crops = [(0, 0, 30, 41), (7, 5, 31, 29), (9, 13, 24, 34), None, (0, 0, 36, 52)]
    sizes = [(60, 82), (62, 58), (20, 28), (64, 48), (72, 104)]
    flips = [False, True, True, False, True]
    t = [torch.from_numpy(a).cuda() for a in thermal]
    r = None if fmt == "BGR" else [torch.from_numpy(a).cuda() for a in rgb]
    before = launches("io")
    got = io.compose_resize_pad(t, r, fmt, sizes, (96, 112), flips, crops)
    ref = io.compose_resize_pad_plain(t, r, fmt, sizes, (96, 112), flips, crops)
    uncropped = io.compose_resize_pad(t, r, fmt, sizes, (96, 112), flips)
    torch.cuda.synchronize()
    assert launches("io") == before + 2
    assert torch.equal(got, ref)
    for i, (h, w) in enumerate(sizes):
        assert not got[i, h:].any() and not got[i, :, w:].any()
    assert torch.equal(got[3:], uncropped[3:]) and not torch.equal(got[1], uncropped[1])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["BGRT", "BGRTTT"])
def test_image_io_kernel_at_equal_frame_sizes(fmt):
    """KAIST: the RGB and thermal frames have one size (3-channel both), so
    the uint8 RGB resize runs at scale 1. At the frame size the canvas is
    the RGB pixels, then thermal channel 0 (BGRT) or all three (BGRTTT),
    bit for bit, edges included; resized, the kernel equals its plain
    version."""
    _cuda()
    from proben_tpu_torch.native import io

    rng = np.random.RandomState(4)
    hw = [(33, 47), (64, 80)]
    t = [torch.from_numpy(_u8(rng, h, w, 3)).cuda() for h, w in hw]
    r = [torch.from_numpy(_u8(rng, h, w, 3)).cuda() for h, w in hw]
    before = launches("io")
    got = io.compose_resize_pad(t, r, fmt, hw, (64, 80))
    torch.cuda.synchronize()
    assert launches("io") == before + 1
    for i, (h, w) in enumerate(hw):
        thermal = t[i][..., :1] if fmt == "BGRT" else t[i]
        assert torch.equal(got[i, :h, :w], torch.cat([r[i], thermal], -1).float())
    sizes = [(50, 70), (80, 100)]
    got = io.compose_resize_pad(t, r, fmt, sizes, (80, 100))
    ref = io.compose_resize_pad_plain(t, r, fmt, sizes, (80, 100))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_image_io_kernel_splits_large_batches():
    """More images than one launch's parameters hold (40): two launches,
    the same canvas as the plain version."""
    _cuda()
    from proben_tpu_torch.native import io

    rng = np.random.RandomState(3)
    t = [torch.from_numpy(_u8(rng, 12, 16, 1)).cuda() for _ in range(41)]
    r = [torch.from_numpy(_u8(rng, 20, 24, 3)).cuda() for _ in range(41)]
    sizes = [(15, 20)] * 40 + [(12, 16)]
    before = launches("io")
    got = io.compose_resize_pad(t, r, "BGRT", sizes, (16, 20))
    ref = io.compose_resize_pad_plain(t, r, "BGRT", sizes, (16, 20))
    torch.cuda.synchronize()
    assert launches("io") == before + 2
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_jpeg_codec_round_trip_and_grayscale():
    """nvJPEG encodes and decodes: grayscale files decode to one channel,
    colour ones to BGR; ``info`` reads the header. Tolerance: at quality 95
    these images come back within a mean of 3 levels (libjpeg: 1.1 gray,
    1.6 colour); a decode in the wrong channel order or layout is off by
    tens."""
    _cuda()
    from proben_tpu_torch.native import io

    rng = np.random.RandomState(1)
    gray = torch.from_numpy(_u8(rng, 64, 80, 1)).cuda()
    color = torch.from_numpy(_u8(rng, 96, 120, 3)).cuda()
    with io.JpegCodec() as codec:
        for src in (gray, color):
            data = codec.encode(src, quality=95)
            assert data[:2] == b"\xff\xd8", data[:4]
            assert codec.info(data) == tuple(src.shape), (codec.info(data), src.shape)
            out = codec.decode(data)
            torch.cuda.synchronize()
            assert out.shape == src.shape and out.dtype == torch.uint8, (out.shape, out.dtype)
            gap = float((out.float() - src.float()).abs().mean())
            assert gap < 3.0, (src.shape, gap)


@pytest.mark.cuda
def test_jpeg_decodes_on_a_busy_stream_equal_lone_decodes():
    """Consecutive decodes on one nvJPEG state while the stream is still
    busy (a large matmul queued before them) give the same pixels, bit for
    bit, as decodes made one at a time on an idle stream: each decode
    returns only once the stream has passed it."""
    _cuda()
    from proben_tpu_torch.native import io

    rng = np.random.RandomState(4)
    x = torch.randn(8192, 8192, device="cuda")
    with io.JpegCodec() as codec:
        files = [codec.encode(torch.from_numpy(_u8(rng, 600, 700, 3)).cuda()) for _ in range(6)]
        ref = []
        for data in files:
            ref.append(codec.decode(data))
            torch.cuda.synchronize()
        for _ in range(3):
            x @ x
            got = [codec.decode(data) for data in files]
            torch.cuda.synchronize()
            assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
def test_load_batch_reads_files(tmp_path):
    """``load_batch`` on files written by the codec: a fused batch of two
    pairs gives the canvas of the decoded pixels, one launch."""
    _cuda()
    from proben_tpu_torch.native import io

    rng = np.random.RandomState(2)
    with io.JpegCodec() as codec:
        tp, rp = [], []
        for i in range(2):
            for kind, shape, paths in (("t", (40, 50, 1), tp), ("r", (90, 100, 3), rp)):
                p = tmp_path / f"{kind}{i}.jpg"
                p.write_bytes(codec.encode(torch.from_numpy(_u8(rng, *shape)).cuda()))
                paths.append(str(p))
        before = launches("io")
        images, sizes, orig = io.load_batch(codec, tp, rp, "BGRTTT", lambda h, w: (2 * h, 2 * w),
                                            (80, 104))
        thermal = [codec.decode(open(p, "rb").read()) for p in tp]
        rgb = [codec.decode(open(p, "rb").read()) for p in rp]
        ref = io.compose_resize_pad_plain(thermal, rgb, "BGRTTT", [(80, 100)] * 2, (80, 104))
        torch.cuda.synchronize()
    assert launches("io") == before + 1
    assert sizes.tolist() == [[80, 100]] * 2 and orig.tolist() == [[40, 50]] * 2
    assert torch.equal(images, ref)


@pytest.mark.cuda
def test_png_batch_canvas_equals_plain(tmp_path):
    """A PNG and a JPEG in one ``load_batch``: the JPEG goes to nvJPEG, the
    PNG (chosen by its bytes, whatever its name) to ``cv2.imread`` on the
    host, and both feed one ``image_io`` launch. The PNG's canvas equals
    ``compose_resize_pad_plain`` of ``cv2.imread``'s pixels bit for bit."""
    _cuda()
    import cv2

    from proben_tpu_torch.native import io

    rng = np.random.RandomState(5)
    png_pixels = _u8(rng, 100, 200, 3)
    png = tmp_path / "frame_leftImg8bit.jpg"  # a PNG under a JPEG's name
    png.write_bytes(cv2.imencode(".png", png_pixels)[1].tobytes())
    with io.JpegCodec() as codec:
        jpeg = tmp_path / "b.jpg"
        jpeg.write_bytes(codec.encode(torch.from_numpy(_u8(rng, 60, 80, 3)).cuda()))
        before = launches("io")
        images, sizes, orig = io.load_batch(codec, [str(png), str(jpeg)], None, "BGR",
                                            lambda h, w: (h // 2 * 3, w // 2 * 3), (160, 304))
        torch.cuda.synchronize()
        assert launches("io") == before + 1
        host = cv2.imread(str(png), cv2.IMREAD_COLOR)
        assert np.array_equal(host, png_pixels)
        ref = io.compose_resize_pad_plain([torch.from_numpy(host).cuda()], None, "BGR", [(150, 300)],
                                          (160, 304))
        jpeg_ref = io.compose_resize_pad_plain([codec.decode(jpeg.read_bytes())], None, "BGR", [(90, 120)],
                                               (160, 304))
    assert orig.tolist() == [[100, 200], [60, 80]] and sizes.tolist() == [[150, 300], [90, 120]]
    assert torch.equal(images[0], ref[0]) and torch.equal(images[1], jpeg_ref[0])


def test_image_io_wrapper_rejects_unsupported_input():
    from proben_tpu_torch.native import io

    t = [torch.zeros(8, 8, 1, dtype=torch.uint8)]
    with pytest.raises(ValueError, match="input_format"):
        io.compose_resize_pad(t, None, "RGB", [(8, 8)], (8, 8))
    with pytest.raises(ValueError, match="rgb"):
        io.compose_resize_pad(t, None, "BGRT", [(8, 8)], (8, 8))
    with pytest.raises(ValueError, match="pad_shape"):
        io.compose_resize_pad(t, None, "BGR", [(9, 8)], (8, 8))
    with pytest.raises(ValueError, match="uint8"):
        io.compose_resize_pad([torch.zeros(8, 8, 1)], None, "BGR", [(8, 8)], (8, 8))
    before = launches("io")
    out = io.compose_resize_pad(t, None, "BGR", [(4, 4)], (8, 8))  # CPU: the plain version
    assert launches("io") == before and out.shape == (1, 8, 8, 3)


def test_image_io_library_key_follows_its_link_libraries(tmp_path, monkeypatch):
    """A source's own link libraries (nvJPEG for ``image_io``) are part of
    its build key; they need no compiler to compute."""
    from proben_tpu_torch import _build

    assert _build.LINK_LIBS["image_io"] == ("nvjpeg",)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// k\n")
    first = _build.library_path("k")
    monkeypatch.setattr(_build, "LINK_LIBS", {"k": ("nvjpeg",)})
    assert _build.library_path("k") != first
    monkeypatch.setattr(_build, "LINK_LIBS", {})
    assert _build.library_path("k") == first
    assert _build.link_flags("k") == []
