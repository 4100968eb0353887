"""Middle-fusion (BGRTTT) training against ``proben_tpu`` on the CPU in f32:
one step at FREEZE_AT 3 (losses, parameters, momentum, gradients into both
streams) and the blur / max-pool ablations; with the pooling of the
concatenated maps, the Gaussian blur and the dual R101 tree round trip.
Setup, calibration and tolerances: ``tests/torch_fusion_common.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.engine.train import make_train_step as jax_make_train_step
from proben_tpu.models import build_config as jax_build_config
from proben_tpu.models import init_rcnn as jax_init_rcnn
from proben_tpu.models import rcnn as jax_rcnn
from proben_tpu.models.gaussian_blur import gaussian_blur as jax_gaussian_blur
from proben_tpu.models.gaussian_blur import gaussian_kernel_1d as jax_gaussian_kernel_1d
from proben_tpu.models.resnet import freeze_mask as jax_freeze_mask
from proben_tpu.solver.build import SolverConfig as JaxSolverConfig
from proben_tpu.structures.detections import GroundTruth as JaxGroundTruth
from proben_tpu_torch.checkpoint import state_dict_from_jax, state_dict_to_jax
from proben_tpu_torch.engine.train import losses_and_grads, make_train_step, trainable_mask
from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines
from proben_tpu_torch.models import rcnn as t_rcnn
from proben_tpu_torch.models.gaussian_blur import gaussian_blur, gaussian_kernel_1d
from proben_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
from proben_tpu_torch.solver import SolverConfig
from proben_tpu_torch.structures import GroundTruth
from torch_fusion_common import (
    SIZES,
    SOLVER,
    _box_head_off_zero,
    _gt,
    _images,
    _leaves,
    _scale_rpn,
    _train_cfgs,
)
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)


def _boxes(rng, b, k, span):
    xy = rng.rand(b, k, 2) * span
    boxes = np.concatenate([xy, xy + rng.rand(b, k, 2) * 90 + 4], -1).astype(np.float32)
    boxes[:, 0] = [2.0, 30.0, 150.0, 40.0]  # 37:3, out of its window: the whole-map fallback
    return torch.from_numpy(boxes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pooling_the_concat_is_the_concat_of_pooled_streams(dtype):
    """Middle fusion pools the concatenated p2..p5 in one call (K2/K3 at
    C = 512 on the card). Pooling is per-channel linear, so this equals
    pooling each stream and concatenating, bit for bit, forward and
    backward (JAX ``rcnn.py::_pool_dual`` pools per stream)."""
    rng = np.random.RandomState(0)
    strides = (4, 8, 16, 32)
    streams = [[torch.from_numpy(rng.randn(2, 32 >> i, 40 >> i, 24).astype(np.float32)).to(dtype)
                .requires_grad_() for i in range(4)] for _ in range(2)]
    boxes = _boxes(rng, 2, 40, 120)
    cat = [torch.cat(pair, -1) for pair in zip(*streams)]
    whole = multilevel_roi_align(cat, boxes, strides)
    split = torch.cat([multilevel_roi_align(s, boxes, strides) for s in streams], -1)
    assert whole.shape == (2, 40, 7, 7, 48) and torch.equal(whole, split)
    g = torch.from_numpy(rng.randn(*whole.shape).astype(np.float32)).to(dtype)
    leaves = streams[0] + streams[1]
    got, want = torch.autograd.grad(whole, leaves, g), torch.autograd.grad(split, leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].abs().max() > 0 and got[4].abs().max() > 0  # p2 of each stream


def test_gaussian_blur_matches_jax():
    """The 5x5, sigma 3 separable blur with zero padding; the port's maps
    are NCHW (channels_last), JAX's NHWC. Tolerance: f32, the same taps
    summed in another order (1e-6 relative of values in [0, 1))."""
    np.testing.assert_allclose(gaussian_kernel_1d(5, 3.0).numpy(),
                               np.asarray(jax_gaussian_kernel_1d(5, 3.0)), rtol=1e-6)
    x = np.random.RandomState(0).rand(2, 13, 17, 6).astype(np.float32)
    want = np.asarray(jax_gaussian_blur(jnp.asarray(x), (5, 5), (3.0, 3.0)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = gaussian_blur(xt, (5, 5), (3.0, 3.0)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_dual_tree_round_trip_is_exact():
    """JAX's own R101 BGRTTT ``init_rcnn`` tree loads into the port with
    ``strict=True`` (``backbone_2``, ``fpn_2`` and the 512-wide heads
    included) and comes back unchanged. The tree is JAX's init's structure,
    shapes and dtypes (``jax.eval_shape``: its eager threefry draws of two
    R101s cost ~12 s on an 8-core CPU), filled with seeded normal numbers."""
    jcfg = jax_build_config(depth=101, input_format="BGRTTT", num_classes=3,
                            enable_gaussian_nll=True)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape, dtype=np.float32).astype(s.dtype),
                                  jax.eval_shape(lambda: jax_init_rcnn(jax.random.PRNGKey(0), jcfg)))
    cfg = build_config(depth=101, input_format="BGRTTT", num_classes=3, enable_gaussian_nll=True)
    model = build_model(cfg, params=tree, device="cpu")
    assert model.rpn_head.conv.weight.shape[1] == 512
    assert model.roi.box_head.fcs[0].weight.shape[1] == 512 * 49
    assert model.backbone_2.stem.conv1.weight.shape[1] == 3
    back = state_dict_to_jax(model.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(tree))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, v in want.items():
        np.testing.assert_array_equal(got[path], v, err_msg=jax.tree_util.keystr(path))
    assert state_dict_from_jax(back).keys() == model.state_dict().keys()


@pytest.fixture(scope="module")
def train_run():
    cfg, jcfg = _train_cfgs()
    images = _images(6)
    gt = _gt(2)
    params = _box_head_off_zero(cfg, _scale_rpn(cfg, random_affines(init_rcnn(0, cfg), 0), images),
                                images, gt)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    mask = jax.tree_util.tree_map(lambda _: True, jparams)
    for bb in ("backbone", "backbone_2"):
        mask[bb] = jax_freeze_mask(jparams[bb], cfg.freeze_at)
    j_init, j_step = jax_make_train_step(jcfg, JaxSolverConfig(**SOLVER), mask)
    jbatch = {"image": jnp.asarray(images), "image_size": jnp.asarray(SIZES),
              "gt": JaxGroundTruth(*map(jnp.asarray, gt))}
    js1, jm1 = jax.jit(j_step)(j_init(jparams, jax.random.PRNGKey(0)), jbatch)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    model = build_model(cfg, params=params, device="cpu")
    batch = {"image": torch.from_numpy(images), "image_size": torch.from_numpy(SIZES),
             "gt": GroundTruth(*map(torch.from_numpy, gt))}
    init, step = make_train_step(cfg, SolverConfig(**SOLVER), trainable_mask(model, cfg.freeze_at))
    s0 = init(model, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses, total, grads = losses_and_grads(model, cfg, batch, torch.Generator())
    s1, m1 = step(s0, batch)
    return dict(cfg=cfg, model=model, images=images, gt=gt, params=params, losses=losses,
                total=total, grads=grads, before=before, m1=m1, p1=model.state_dict(),
                v1=s1.momentum, jm1=to_np(jm1), jp1=to_np(js1.params),
                jv1=to_np(js1.opt_state["momentum"]))


def test_train_losses_match_jax(train_run):
    jm = train_run["jm1"]
    names = {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}
    assert set(train_run["losses"]) == names
    for k in names | {"total_loss"}:
        got = train_run["total"] if k == "total_loss" else train_run["losses"][k]
        np.testing.assert_allclose(float(got), float(jm[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(train_run["m1"][k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert float(jm["loss_box_reg"]) > 0 and float(jm["loss_rpn_loc"]) > 0


def test_train_step_matches_jax(train_run):
    """Parameters and momentum after one step; the frozen stem, res2 and
    res3 of both backbones untouched in both packages."""
    got_p, got_v = _leaves(state_dict_to_jax(train_run["p1"])), _leaves(state_dict_to_jax(train_run["v1"]))
    want_p, want_v = _leaves(train_run["jp1"]), _leaves(train_run["jv1"])
    before = _leaves(state_dict_to_jax(train_run["before"]))
    errs, num, den, frozen = [], 0.0, 0.0, set()
    for path, v in got_v.items():
        name = jax.tree_util.keystr(path)
        wv = want_v[path]
        if not wv.any():
            assert not v.any(), name
            np.testing.assert_array_equal(got_p[path], before[path], err_msg=name)
            frozen.add(path[0].key + "." + path[1].key)
            continue
        errs.append(np.linalg.norm(v - wv) / np.linalg.norm(wv))
        num += float(np.sum((v - wv) ** 2))
        den += float(np.sum(wv ** 2))
        assert errs[-1] < 2e-2, (name, errs[-1])
        lr = SOLVER["base_lr"] * (SOLVER["bias_lr_factor"] if path[-1].key in ("b", "bias", "scale")
                                  else 1.0)
        bound = lr * np.abs(v - wv) + 2.0 ** -22 * (np.abs(want_p[path]) + np.abs(before[path]))
        assert (np.abs(got_p[path] - want_p[path]) <= bound).all(), name
    assert np.sqrt(num / den) < 5e-4 and np.median(errs) < 2e-5, (np.sqrt(num / den), np.median(errs))
    assert len(errs) == sum(p.requires_grad for p in train_run["model"].parameters())
    assert frozen == {f"{bb}.{s}" for bb in ("backbone", "backbone_2")
                      for s in ("stem", "res2", "res3")}


def test_gradients_reach_both_streams(train_run):
    """The trainable mask freezes both backbones at FREEZE_AT 3; the
    pooling's gradient (and the RPN's) reaches both FPNs and res4/res5 of
    both backbones through the concat, every residual branch included."""
    model, grads = train_run["model"], train_run["grads"]
    mask = trainable_mask(model, 3)
    for name, p in model.named_parameters():
        frozen = name.startswith(tuple(f"{bb}.{s}." for bb in ("backbone", "backbone_2")
                                       for s in ("stem", "res2", "res3")))
        assert mask[name] is not frozen and p.requires_grad is not frozen, name
        assert (name in grads) is not frozen, name
    groups = {}
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        key = ".".join(name.split(".")[:2])
        groups[key] = groups.get(key, 0.0) + float(g.pow(2).sum())
    assert set(groups) == {"backbone.res4", "backbone.res5", "backbone_2.res4", "backbone_2.res5",
                           "fpn.lateral", "fpn.output", "fpn_2.lateral", "fpn_2.output",
                           "rpn_head.conv", "rpn_head.objectness", "rpn_head.deltas",
                           "roi.box_head", "roi.output"}
    assert all(v > 0 for v in groups.values()), groups
    for name, g in grads.items():
        if ".norm3." in name or ".conv3." in name:
            assert g.abs().max() > 0, name


def test_ablation_losses_match_jax(train_run):
    """MODEL.BLUR_RGB and MAX_POOL_RGB (tests/test_ablations.py's
    configuration: both on, BGRTTT): training only, the RGB stream's p2-p4
    blurred and then every RGB level max-pooled 3x3/1 before the concat.
    Losses to rtol 1e-4; inference ignores both flags."""
    cfg, jcfg = _train_cfgs(blur_rgb=True, max_pool_rgb=True)
    params, images, gt = train_run["params"], train_run["images"], train_run["gt"]
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = jax.jit(lambda p, im, sz, g: jax_rcnn.rcnn_train_losses(p, jcfg, im, sz, g, jax.random.PRNGKey(1)))(
        jparams, jnp.asarray(images), jnp.asarray(SIZES), JaxGroundTruth(*map(jnp.asarray, gt)))
    model = build_model(cfg, params=params, device="cpu")
    with torch.no_grad():
        got = t_rcnn.rcnn_train_losses(model, cfg, torch.from_numpy(images), torch.from_numpy(SIZES),
                                       GroundTruth(*map(torch.from_numpy, gt)), torch.Generator())
    plain = train_run["losses"]
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-4, err_msg=k)
    assert any(abs(float(got[k]) - float(plain[k])) > 1e-3 * abs(float(plain[k])) for k in got)
    x = t_rcnn.preprocess(cfg, torch.from_numpy(images))
    with torch.inference_mode():
        a = t_rcnn.extract_features(model, cfg, x)
        b = t_rcnn.extract_features(model, train_run["cfg"], x)
    assert all(torch.equal(a[k], b[k]) for k in a)
