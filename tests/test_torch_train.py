"""The training step of ``proben_tpu_torch`` against ``proben_tpu`` on the
CPU in f32: a tiny R50-FPN at 128x160 (the sizes of
tests/test_torch_slice.py), the same parameters (the port's numpy init with
random affines, loaded into the port through ``from_jax``) and the same
batch through the port's ``make_train_step`` and JAX's jitted one.

Identity sampling, as tests/test_composed_parity.py uses it: the RPN
samples all 5118 anchors and the RoI heads all post-NMS proposals plus the
gt boxes with positive fraction 0.5, so the two packages' different random
numbers only reorder the sampled rows. The RPN's objectness and delta convs
are rescaled (weights only, for both packages) to output std 2 and 0.3 so
that the proposals are not saturated boxes whose NMS ties on rounding.

Tolerances: f32 forward and backward through 50 layers in other summation
orders. Losses to rtol 1e-4. The momentum after one step (gradient plus
weight decay): over all trainable tensors together to a relative L2 error of
5e-4, the median tensor to 2e-5, every tensor to 2e-2. The last bound is
loose because a ReLU pre-activation within f32 rounding of zero can take the
other sign in one package: measured against the port run in f64, the JAX
gradient of res3.0's conv1 is within 9e-6 and the port's within 6.7e-3,
from one such flip in res3.0 (global 8.8e-5, median 1.7e-6). Parameters
to 1e-5 of each tensor's largest entry. Frozen parameters are compared bit
for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.engine.train import make_train_step as jax_make_train_step
from proben_tpu.models import build_config as jax_build_config
from proben_tpu.models.resnet import freeze_mask as jax_freeze_mask
from proben_tpu.solver.build import SolverConfig as JaxSolverConfig
from proben_tpu.structures.detections import GroundTruth as JaxGroundTruth
from proben_tpu_torch.checkpoint import state_dict_to_jax
from proben_tpu_torch.engine.train import losses_and_grads, make_train_step, trainable_mask
from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines
from proben_tpu_torch.models import rcnn as t_rcnn
from proben_tpu_torch.solver import SolverConfig
from proben_tpu_torch.structures import GroundTruth
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

H, W = 128, 160
SIZES = np.array([[128, 160], [120, 150]], np.int32)
PRE, POST, G = 200, 64, 6
N_ANCHORS = sum(-(-H // s) * -(-W // s) * 3 for s in (4, 8, 16, 32, 64))
SOLVER = dict(base_lr=0.01, warmup_iters=0, weight_decay=1e-4, weight_decay_bias=0.0,
              bias_lr_factor=2.0)


def _image(seed):
    """Background gradient + box-shaped blobs (bench.py's recipe)."""
    rng = np.random.RandomState(seed)
    im = np.tile(np.linspace(60.0, 120.0, W, dtype=np.float32)[None, :, None], (H, 1, 3))
    im += rng.randn(H, W, 3).astype(np.float32) * 8
    for _ in range(6):
        x, y = rng.randint(0, W - 40), rng.randint(0, H - 48)
        bw, bh = rng.randint(12, 40), rng.randint(16, 48)
        im[y:y + bh, x:x + bw] = rng.uniform(130, 240)
    return np.clip(im, 0, 255)


def _gt(seed):
    rng = np.random.RandomState(seed)
    xy = rng.rand(2, G, 2) * 90
    boxes = np.concatenate([xy, xy + rng.rand(2, G, 2) * 40 + 12], -1).astype(np.float32)
    valid = np.ones((2, G), bool)
    valid[:, 4:] = False
    return boxes, rng.randint(0, 3, (2, G)).astype(np.int32), valid


def _calibrated(cfg, images):
    params = random_affines(init_rcnn(0, cfg), 0)
    model = build_model(cfg, params=params, device="cpu")
    with torch.inference_mode():
        feats = t_rcnn.extract_features(model, cfg, t_rcnn.preprocess(cfg, torch.from_numpy(images)))
        lg, dl = t_rcnn.rpn_outputs(model, cfg, feats)
    head = params["rpn_head"]
    for name, t, target in (("objectness", lg, 2.0), ("deltas", dl, 0.3)):
        s = target / float(torch.cat([x.flatten() for x in t]).std())
        head[name]["w"] = head[name]["w"] * s
        head[name]["b"] = head[name]["b"] * s
    return params


def _port_batch(images, gt):
    return {"image": torch.from_numpy(images), "image_size": torch.from_numpy(SIZES),
            "gt": GroundTruth(*map(torch.from_numpy, gt))}


def _jax_batch(images, gt):
    return {"image": jnp.asarray(images), "image_size": jnp.asarray(SIZES),
            "gt": JaxGroundTruth(*map(jnp.asarray, gt))}


@pytest.fixture(scope="module")
def run():
    cfg = build_config(depth=50, num_classes=3)
    cfg = cfg.replace(
        rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_train=PRE, post_nms_topk_train=POST,
                                batch_size_per_image=N_ANCHORS),
        roi=dataclasses.replace(cfg.roi, batch_size_per_image=POST + G, positive_fraction=0.5),
    )
    jcfg = jax_build_config(depth=50, num_classes=3)
    jcfg = jcfg.replace(
        rpn=dataclasses.replace(jcfg.rpn, pre_nms_topk_train=PRE, post_nms_topk_train=POST,
                                batch_size_per_image=N_ANCHORS),
        roi=dataclasses.replace(jcfg.roi, batch_size_per_image=POST + G, positive_fraction=0.5),
    )
    images = np.stack([_image(0), _image(1)])
    nan_images = images.copy()
    nan_images[1, 40, 50, 0] = np.nan
    gt = _gt(2)
    params = _calibrated(cfg, images)

    # JAX: jitted step from the same parameters, then the non-finite batch
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    mask = jax.tree_util.tree_map(lambda _: True, jparams)
    mask["backbone"] = jax_freeze_mask(jparams["backbone"], cfg.freeze_at)
    j_init, j_step = jax_make_train_step(jcfg, JaxSolverConfig(**SOLVER), mask)
    j_step = jax.jit(j_step)
    js0 = j_init(jparams, jax.random.PRNGKey(0))
    js1, jm1 = j_step(js0, _jax_batch(images, gt))
    js2, jm2 = j_step(js1, _jax_batch(nan_images, gt))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    # the port
    model = build_model(cfg, params=params, device="cpu")
    init, step = make_train_step(cfg, SolverConfig(**SOLVER), trainable_mask(model, cfg.freeze_at))
    s0 = init(model, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses, total, grads = losses_and_grads(model, cfg, _port_batch(images, gt), torch.Generator())
    s1, m1 = step(s0, _port_batch(images, gt))
    p1 = {k: v.clone() for k, v in model.state_dict().items()}
    s2, m2 = step(s1, _port_batch(nan_images, gt))
    return dict(
        cfg=cfg, model=model, losses=losses, total=total, grads=grads, before=before,
        m1=m1, m2=m2, p1=p1, p2=model.state_dict(), v1=s1.momentum, v2=s2.momentum, steps=(s1.step, s2.step),
        jm1=to_np(jm1), jm2=to_np(jm2), jp1=to_np(js1.params), jp2=to_np(js2.params),
        jv1=to_np(js1.opt_state["momentum"]), jv2=to_np(js2.opt_state["momentum"]),
        jsteps=(int(js1.step), int(js2.step)),
    )


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_train_losses_match_jax(run):
    """``rcnn_train_losses`` (through ``losses_and_grads``) and the step's
    metrics against the JAX step's metrics (its ``rcnn_train_losses``)."""
    jm = run["jm1"]
    names = {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}
    assert set(run["losses"]) == names and set(run["m1"]) == names | {"total_loss", "loss_finite"}
    for k in names | {"total_loss"}:
        got = run["total"] if k == "total_loss" else run["losses"][k]
        np.testing.assert_allclose(float(got), float(jm[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(run["m1"][k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert float(run["m1"]["loss_finite"]) == float(jm["loss_finite"]) == 1.0
    assert float(jm["loss_box_reg"]) > 0 and float(jm["loss_rpn_loc"]) > 0


def test_step_matches_jax(run):
    """Parameters and momentum after one step; frozen ones untouched in both."""
    got_p = state_dict_to_jax(run["p1"])
    got_v = state_dict_to_jax(run["v1"])
    want_v = dict(_leaves(run["jv1"]))
    want_p = dict(_leaves(run["jp1"]))
    before = dict(_leaves(state_dict_to_jax(run["before"])))
    errs, num, den = [], 0.0, 0.0
    for path, v in _leaves(got_v):
        name = jax.tree_util.keystr(path)
        wv = want_v[path]
        if not wv.any():  # frozen: no momentum, bit-identical parameters
            assert not v.any(), name
            np.testing.assert_array_equal(dict(_leaves(got_p))[path], before[path], err_msg=name)
            continue
        errs.append(np.linalg.norm(v - wv) / np.linalg.norm(wv))
        num += float(np.sum((v - wv) ** 2))
        den += float(np.sum(wv ** 2))
        assert errs[-1] < 2e-2, (name, errs[-1])
        lr = SOLVER["base_lr"] * (SOLVER["bias_lr_factor"] if path[-1].key in ("b", "bias", "scale")
                                  else 1.0)
        wp = want_p[path]
        bound = lr * np.abs(v - wv) + 2.0 ** -22 * (np.abs(wp) + np.abs(before[path]))
        assert (np.abs(dict(_leaves(got_p))[path] - wp) <= bound).all(), name
    assert np.sqrt(num / den) < 5e-4 and np.median(errs) < 2e-5, (np.sqrt(num / den), np.median(errs))
    assert len(errs) == sum(p.requires_grad for p in run["model"].parameters())
    assert run["steps"][0] == run["jsteps"][0] == 1


def test_non_finite_batch_rolls_back_in_both(run):
    """A NaN pixel makes every loss non-finite: both packages keep every
    parameter and momentum value and still advance the step."""
    assert float(run["m2"]["loss_finite"]) == float(run["jm2"]["loss_finite"]) == 0.0
    assert not np.isfinite(float(run["m2"]["total_loss"])) and not np.isfinite(float(run["jm2"]["total_loss"]))
    for k, v in run["p2"].items():
        assert torch.equal(v, run["p1"][k]), k
    for k, v in run["v2"].items():
        assert torch.equal(v, run["v1"][k]), k
    for a, b in zip(jax.tree_util.tree_leaves(run["jp2"]), jax.tree_util.tree_leaves(run["jp1"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(run["jv2"]), jax.tree_util.tree_leaves(run["jv1"])):
        np.testing.assert_array_equal(a, b)
    assert run["steps"][1] == run["jsteps"][1] == 2


def test_gradients_reach_every_trainable_module(run):
    """FPN, res3-res5 and every head get nonzero, finite gradients; the
    frozen stem and res2 are not differentiated at all."""
    grads = run["grads"]
    for name, p in run["model"].named_parameters():
        frozen = name.startswith(("backbone.stem.", "backbone.res2."))
        assert p.requires_grad is not frozen, name
        assert (name in grads) is not frozen, name
    groups = {}
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        key = ".".join(name.split(".")[:2])
        groups[key] = groups.get(key, 0.0) + float(g.pow(2).sum())
    assert set(groups) == {"backbone.res3", "backbone.res4", "backbone.res5", "fpn.lateral",
                           "fpn.output", "rpn_head.conv", "rpn_head.objectness", "rpn_head.deltas",
                           "roi.box_head", "roi.output"}
    assert all(v > 0 for v in groups.values()), groups
    # every residual branch carries gradient (random affines)
    for name, g in grads.items():
        if ".norm3." in name or ".conv3." in name:
            assert g.abs().max() > 0, name


def test_inference_path_stays_gradient_free(run):
    """``rcnn_inference`` runs under inference mode even on a model whose
    parameters require grad, so serving builds no graph."""
    model, cfg = run["model"], run["cfg"]
    det = t_rcnn.rcnn_inference(model, cfg, torch.zeros(1, H, W, 3), torch.tensor([[H, W]]))
    assert det.boxes.is_inference() and not det.scores.requires_grad
