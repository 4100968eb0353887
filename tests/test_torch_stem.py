"""Fused stem of ``proben_tpu_torch`` (kernel K1's plain version on the CPU)
against ``proben_tpu``: in bf16 against the Pallas stem run in interpret
mode, in f32 against the XLA composition. The CUDA kernel itself is held
against the plain version in tests/test_torch_kernels.py.

Tolerances. bf16: both sides accumulate the conv in f32 and round it, then
run the affine in bf16; accumulation order may flip a conv output by one
bf16 ulp (measured: identical here), so the bound is one bf16 ulp relative
(rtol 2^-7) plus atol 0.05, tighter than the Pallas stem's own test
(atol 0.07, rtol 0.03). f32: the same conv in f32 on both sides, rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.models.layers import affine, conv2d, max_pool
from proben_tpu.ops.stem_pallas import stem_pool_pallas
from proben_tpu_torch.models.resnet import apply_stem, Stem
from proben_tpu_torch.ops import stem_cuda
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

BF = torch.bfloat16


def _inputs(n, h, w, c, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h, w, c) * 50).astype(np.float32)
    wt = (rng.randn(7, 7, c, 64) * 0.03).astype(np.float32)
    sc = (1 + 0.3 * rng.randn(64)).astype(np.float32)
    bi = (0.3 * rng.randn(64)).astype(np.float32)
    return x, wt, sc, bi


@pytest.mark.parametrize("n,h,w,c", [(2, 32, 256, 3), (1, 48, 256, 4)])
def test_plain_stem_matches_pallas_bf16(n, h, w, c):
    x, wt, sc, bi = _inputs(n, h, w, c)
    want = np.asarray(
        stem_pool_pallas(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(sc), jnp.asarray(bi),
                         interpret=True), np.float32)
    got = stem_cuda.stem_pool(
        torch.from_numpy(x).to(BF), torch.from_numpy(wt).to(BF),
        torch.from_numpy(sc).to(BF), torch.from_numpy(bi).to(BF)).float().numpy()
    assert got.shape == want.shape == (n, h // 4, w // 4, 64)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0.05)


@pytest.mark.parametrize("n,h,w,c", [(2, 32, 256, 3), (1, 30, 98, 4)])
def test_plain_stem_matches_xla_f32(n, h, w, c):
    """Also odd sizes outside the Pallas gate: the port's kernel takes any H, W."""
    x, wt, sc, bi = _inputs(n, h, w, c, seed=1)
    hj = conv2d(jnp.asarray(x), {"w": jnp.asarray(wt)}, stride=2, padding=3)
    hj = jnp.maximum(affine(hj, {"scale": jnp.asarray(sc), "bias": jnp.asarray(bi)}), 0)
    want = np.asarray(max_pool(hj, 3, 2, padding=1))
    got = stem_cuda.stem_pool_plain(*map(torch.from_numpy, (x, wt, sc, bi))).numpy()
    assert got.shape == want.shape == (n, *stem_cuda.stem_out_hw(h, w), 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_apply_stem_kernel_route_equals_plain_route():
    """``apply_stem``'s kernel route (bias folded, NHWC bf16) and its layer
    composition give the same bf16 result on the CPU."""
    x, wt, sc, bi = _inputs(1, 32, 64, 3, seed=2)
    stem = Stem(3)
    stem.conv1.weight.data.copy_(torch.from_numpy(wt).permute(3, 2, 0, 1))
    stem.norm1.scale.copy_(torch.from_numpy(sc))
    stem.norm1.bias.copy_(torch.from_numpy(bi))
    xc = torch.from_numpy(x).permute(0, 3, 1, 2)
    a = apply_stem(stem, xc, BF, "kernel")
    b = apply_stem(stem, xc, BF, "plain")
    np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


@pytest.mark.parametrize("c", [1, 3, 4, 8])
@pytest.mark.parametrize("h,w", [(13, 17), (32, 64), (7, 9)])
def test_kernel_regrouping_is_the_7x7_conv(c, h, w):
    """K1's operands (space-to-depth input, packed 4x4-tap weights) give the
    7x7/s2/pad-3 conv: the kernel's index mapping, checked without a card.
    f32 on both sides; only the summation order differs (rtol 1e-5)."""
    rng = np.random.RandomState(c)
    x = torch.from_numpy(rng.randn(2, h, w, c).astype(np.float32))
    wt = torch.from_numpy(rng.randn(7, 7, c, 64).astype(np.float32))
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), stride=2,
                                      padding=3).permute(0, 2, 3, 1)
    got = stem_cuda.stem_conv_s2d(x, wt)
    cp = stem_cuda.stem_cp(c)
    assert stem_cuda.pack_stem_weights(wt).shape == (64, 16 * 4 * cp)
    assert stem_cuda.space_to_depth_input(x).shape == (2, (h + 1) // 2 + 3, (w + 1) // 2 + 3, 4 * cp)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
