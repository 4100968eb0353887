"""Several BGRTTT training steps of the FLIR solver in both packages.

On the card, the middle-fusion losses of ``chip_smoke.py`` rise over 21
steps (random weights, the FLIR solver with its warm-up). One step matches
JAX (``tests/test_torch_fusion_train.py``); a drift that compounds would
show only over several. This file runs ``STEPS`` steps of the solver that
``configs/FLIR-Detection/faster_rcnn_R_101_FLIR_middle_fusion.yaml`` gives
(lr 0.02, momentum 0.9, weight decay 1e-4, linear warm-up from 0.001 over
1000 steps), read by each package's own ``get_cfg``, on the setup of
``test_torch_fusion_train.py`` (tiny dual R50 at 128x160, FREEZE_AT 3,
identity sampling, box-head biases off zero), in JAX's jitted step and the
port's, and compares them after every step.

Tolerances (the same f32 math in other summation orders, as for one step):
every loss to rtol 1e-4 at every step; the trainable parameters' change
since the start to a relative L2 error of 5e-4 over all trainable tensors
at every step, after taking off each element's own rounding (2^-22 of its
magnitude: early in the warm-up the lr is 2e-5, and an update of a large
bias is then below its f32 spacing, kept by one package and rounded away
by the other); frozen parameters (stem, res2, res3 of both backbones) bit
for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.config import get_cfg as jax_get_cfg
from proben_tpu.config import solver_config_from_cfg as jax_solver_config_from_cfg
from proben_tpu.engine.train import make_train_step as jax_make_train_step
from proben_tpu.models.resnet import freeze_mask as jax_freeze_mask
from proben_tpu.structures.detections import GroundTruth as JaxGroundTruth
from proben_tpu_torch.checkpoint import state_dict_to_jax
from proben_tpu_torch.config import get_cfg, solver_config_from_cfg
from proben_tpu_torch.engine.train import make_train_step, trainable_mask
from proben_tpu_torch.models import build_model, init_rcnn, random_affines
from proben_tpu_torch.structures import GroundTruth
from torch_fusion_common import (
    SIZES,
    _box_head_off_zero,
    _gt,
    _images,
    _leaves,
    _scale_rpn,
    _train_cfgs,
)
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

STEPS = 4
YAML = os.path.join(os.path.dirname(__file__), "..", "configs", "FLIR-Detection",
                    "faster_rcnn_R_101_FLIR_middle_fusion.yaml")
LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")


def _solvers():
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_file(YAML)
    tcfg.merge_from_file(YAML)
    return jax_solver_config_from_cfg(jcfg), solver_config_from_cfg(tcfg)


@pytest.fixture(scope="module")
def steps_run():
    cfg, jcfg = _train_cfgs()
    images, gt = _images(6), _gt(2)
    params = _box_head_off_zero(cfg, _scale_rpn(cfg, random_affines(init_rcnn(0, cfg), 0), images),
                                images, gt)
    jsolver, tsolver = _solvers()

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    mask = jax.tree_util.tree_map(lambda _: True, jparams)
    for bb in ("backbone", "backbone_2"):
        mask[bb] = jax_freeze_mask(jparams[bb], cfg.freeze_at)
    j_init, j_step = jax_make_train_step(jcfg, jsolver, mask)
    j_step = jax.jit(j_step)
    jbatch = {"image": jnp.asarray(images), "image_size": jnp.asarray(SIZES),
              "gt": JaxGroundTruth(*map(jnp.asarray, gt))}
    state = j_init(jparams, jax.random.PRNGKey(0))
    jax_losses, jax_params = [], []
    for _ in range(STEPS):
        state, m = j_step(state, jbatch)
        jax_losses.append({k: float(m[k]) for k in LOSSES})
        jax_params.append(_leaves(jax.tree_util.tree_map(np.asarray, state.params)))

    model = build_model(cfg, params=params, device="cpu")
    batch = {"image": torch.from_numpy(images), "image_size": torch.from_numpy(SIZES),
             "gt": GroundTruth(*map(torch.from_numpy, gt))}
    init, step = make_train_step(cfg, tsolver, trainable_mask(model, cfg.freeze_at))
    s = init(model, 0)
    losses, snaps = [], []
    for _ in range(STEPS):
        s, m = step(s, batch)
        losses.append({k: float(m[k]) for k in LOSSES})
        # the model is updated in place: snapshot copies, not views
        snaps.append(_leaves(state_dict_to_jax({k: v.clone() for k, v in model.state_dict().items()})))
    return dict(start=_leaves(params), jax_losses=jax_losses, jax_params=jax_params,
                losses=losses, params=snaps)


def test_flir_solver_is_the_same_in_both_packages():
    import dataclasses

    jsolver, tsolver = _solvers()
    assert dataclasses.asdict(jsolver) == dataclasses.asdict(tsolver)
    assert tsolver.warmup_iters == 1000 and tsolver.base_lr == 0.02


@pytest.mark.parametrize("k", range(STEPS))
def test_losses_match_jax_at_every_step(steps_run, k):
    got, want = steps_run["losses"][k], steps_run["jax_losses"][k]
    for name in LOSSES:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, err_msg=f"step {k + 1} {name}")


@pytest.mark.parametrize("k", range(STEPS))
def test_parameters_match_jax_at_every_step(steps_run, k):
    start, got, want = steps_run["start"], steps_run["params"][k], steps_run["jax_params"][k]
    num = den = 0.0
    for path, w in want.items():
        p0 = start[path]
        if path[0].key in ("backbone", "backbone_2") and path[1].key in ("stem", "res2", "res3"):
            np.testing.assert_array_equal(got[path], p0, err_msg=jax.tree_util.keystr(path))
            np.testing.assert_array_equal(w, p0, err_msg=jax.tree_util.keystr(path))
            continue
        d_got, d_want = got[path] - p0, w - p0
        excess = np.maximum(np.abs(d_got - d_want) - 2.0 ** -22 * (np.abs(p0) + np.abs(w)), 0.0)
        num += float(np.sum(excess ** 2))
        den += float(np.sum(d_want.astype(np.float64) ** 2))
    assert den > 0 and np.sqrt(num / den) < 5e-4, (k + 1, np.sqrt(num / den))


def test_losses_move_together(steps_run):
    """Whatever way the losses go over the steps, both packages go it: each
    step's change of the total loss agrees in sign and to 1e-2 of the
    largest change (a drift of one package alone would show here first)."""
    got = np.array([s["total_loss"] for s in steps_run["losses"]])
    want = np.array([s["total_loss"] for s in steps_run["jax_losses"]])
    dg, dw = np.diff(got), np.diff(want)
    scale = max(np.abs(dw).max(), 1e-12)
    np.testing.assert_allclose(dg, dw, atol=1e-2 * scale)
