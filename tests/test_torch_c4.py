"""The C4 detector of ``proben_tpu_torch`` (``models/c4.py``) and its 14x14
pooler (``ops/roi_align_cuda.py::single_level_roi_align``) against
``proben_tpu`` on the CPU in f32.

The pooler at P = 14 against JAX's ``single_level_roi_align``, forward and
backward (``jax.vjp``), on a res4-sized map and on a map larger than the
window (the out-of-window fallback). The detector: a tiny R50-C4 (96x128
images, 32 proposals), the same parameters (the port's init with random
affines) through both packages' ``rcnn_c4_inference`` and
``rcnn_c4_train_losses``, each JAX function in one module-scoped jit.

Calibration (weights only, for both packages): the RPN's objectness and
delta convs rescaled to output std 2 and 0.3 so that proposals are not
saturated near-ties, and the background bias bisected until each image
holds 3-11 detections below the cap of 12, so no score tie sits at a
top-k cut. Training uses identity sampling (tests/test_torch_train.py):
every anchor and every proposal is sampled, so the packages' different
random numbers only reorder the sampled rows.

Tolerances: RoIAlign rtol 1e-5 / atol 1e-5 (the same f32 products summed in
another order); detections boxes rtol 1e-4 / atol 2e-3 px, scores and
probabilities 1e-4, equal classes; losses rtol 1e-4 (f32 through 50 layers
in other summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.models import build_config as jax_build_config
from proben_tpu.models.c4 import rcnn_c4_inference as jax_c4_inference
from proben_tpu.models.c4 import rcnn_c4_train_losses as jax_c4_losses
from proben_tpu.models.c4 import init_rcnn_c4 as jax_init_rcnn_c4
from proben_tpu.models.fast_rcnn import FastRCNNConfig as JaxFastRCNNConfig
from proben_tpu.models.roi_heads import ROIHeadsConfig as JaxROIHeadsConfig
from proben_tpu.models.rpn import RPNConfig as JaxRPNConfig
from proben_tpu.ops.roi_align import single_level_roi_align as jax_single_level_roi_align
from proben_tpu.structures.detections import GroundTruth as JaxGroundTruth
from proben_tpu_torch.models import build_config, random_affines
from proben_tpu_torch.models import c4 as t_c4
from proben_tpu_torch.models.fast_rcnn import FastRCNNConfig
from proben_tpu_torch.models.roi_heads import ROIHeadsConfig
from proben_tpu_torch.models.rpn import RPNConfig, apply_rpn_head
from proben_tpu_torch.ops.roi_align_cuda import single_level_roi_align
from proben_tpu_torch.structures import GroundTruth
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

H, W = 96, 128
SIZES = np.array([[96, 128], [90, 120]], np.int32)  # second image padded
PRE, POST, G, DETS = 100, 32, 3, 12
N_ANCHORS = -(-H // 16) * -(-W // 16) * 15


def _boxes(rng, k, hi, lo_wh, hi_wh):
    xy = rng.rand(k, 2) * hi
    return np.concatenate([xy, xy + lo_wh + rng.rand(k, 2) * (hi_wh - lo_wh)], -1).astype(np.float32)


@pytest.mark.parametrize("case", ["res4 map", "map beyond the window"])
def test_single_level_roi_align_p14_matches_jax(case):
    """Forward and the VJP with respect to the map, at P = 14 and stride 16
    (the C4 pooler), against JAX's ``single_level_roi_align`` and
    ``jax.vjp`` of it. The larger map (70x90 > the 56x64 window) has boxes
    that leave their window: the whole-map fallback's rows and gradient."""
    rng = np.random.RandomState(0 if case == "res4 map" else 1)
    hw = (20, 24) if case == "res4 map" else (70, 90)
    feat = rng.randn(*hw, 8).astype(np.float32)
    boxes = _boxes(rng, 24, [hw[1] * 16 - 40, hw[0] * 16 - 40], 8, 600)
    boxes[:2] = [[0.0, 0.0, hw[1] * 16.0, hw[0] * 16.0], [3.5, 4.0, 3.5, 200.0]]  # whole map, empty
    g = rng.randn(24, 14, 14, 8).astype(np.float32)

    want, vjp = jax.vjp(lambda f: jax_single_level_roi_align(f, jnp.asarray(boxes), 16, 14), jnp.asarray(feat))
    (want_df,) = vjp(jnp.asarray(g))
    f = torch.from_numpy(feat)[None].requires_grad_()
    got = single_level_roi_align(f, torch.from_numpy(boxes)[None], 16, 14)
    (got_df,) = torch.autograd.grad(got, f, torch.from_numpy(g)[None])
    assert got.shape == (1, 24, 14, 14, 8)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_df[0].numpy(), np.asarray(want_df), rtol=1e-5, atol=1e-5)
    assert np.abs(np.asarray(want_df)).sum() > 0


def _image(seed):
    """Background gradient + box-shaped blobs (bench.py's recipe)."""
    rng = np.random.RandomState(seed)
    im = np.tile(np.linspace(60.0, 120.0, W, dtype=np.float32)[None, :, None], (H, 1, 3))
    im += rng.randn(H, W, 3).astype(np.float32) * 8
    for _ in range(5):
        x, y = rng.randint(0, W - 40), rng.randint(0, H - 40)
        bw, bh = rng.randint(12, 40), rng.randint(16, 40)
        im[y:y + bh, x:x + bw] = rng.uniform(130, 240)
    return np.clip(im, 0, 255)


def _gt():
    rng = np.random.RandomState(2)
    boxes = np.stack([_boxes(rng, G, [70, 50], 16, 40) for _ in range(2)])
    valid = np.ones((2, G), bool)
    valid[1, 2] = False
    return boxes, rng.randint(0, 3, (2, G)).astype(np.int32), valid


def _configs():
    rpn = dict(pre_nms_topk_test=PRE, post_nms_topk_test=POST, pre_nms_topk_train=PRE,
               post_nms_topk_train=POST, batch_size_per_image=N_ANCHORS)
    roi = dict(num_classes=3, batch_size_per_image=POST + G, positive_fraction=0.5)
    rcnn = dict(num_classes=3, topk_per_image=DETS, max_candidates=POST * 3)
    return (build_config(depth=50, num_classes=3, rpn=RPNConfig(**rpn), roi=ROIHeadsConfig(**roi),
                         rcnn=FastRCNNConfig(**rcnn)),
            jax_build_config(depth=50, num_classes=3, rpn=JaxRPNConfig(**rpn),
                             roi=JaxROIHeadsConfig(**roi), rcnn=JaxFastRCNNConfig(**rcnn)))


def _calibrated(cfg, images):
    params = random_affines(t_c4.init_rcnn_c4(0, cfg), 0)
    model = t_c4.build_c4_model(cfg, params, device="cpu")
    with torch.inference_mode():
        res4 = t_c4._res4(model, cfg, torch.from_numpy(images))
        lg, dl = apply_rpn_head(model.rpn_head, [res4])
    head = params["rpn_head"]
    for name, t, target in (("objectness", lg, 2.0), ("deltas", dl, 0.3)):
        s = target / float(torch.cat([x.flatten() for x in t]).std())
        head[name]["w"] = head[name]["w"] * s
        head[name]["b"] = head[name]["b"] * s
    cls = params["roi"]["output"]["cls_score"]
    lo, hi = -8.0, 16.0
    for _ in range(16):
        cls["b"] = cls["b"].copy()
        cls["b"][-1] = 0.5 * (lo + hi)
        model = t_c4.build_c4_model(cfg, params, device="cpu")
        n = t_c4.rcnn_c4_inference(model, cfg, torch.from_numpy(images), torch.from_numpy(SIZES)).valid.sum(-1)
        if int(n.max()) >= DETS:
            lo = 0.5 * (lo + hi)
        elif int(n.min()) < 3:
            hi = 0.5 * (lo + hi)
        else:
            return params
    raise AssertionError(f"calibration did not converge: {n.tolist()}")


@pytest.fixture(scope="module")
def c4_run():
    cfg, jcfg = _configs()
    images = np.stack([_image(0), _image(1)])
    params = _calibrated(cfg, images)
    gt = _gt()

    def jax_run(p, im, sz, g):
        return (jax_c4_inference(p, jcfg, im, sz),
                jax_c4_losses(p, jcfg, im, sz, JaxGroundTruth(*g), jax.random.PRNGKey(1)))

    jdet, jlosses = jax.jit(jax_run)(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(images),
                                     jnp.asarray(SIZES), tuple(map(jnp.asarray, gt)))
    model = t_c4.build_c4_model(cfg, params, device="cpu")
    im, sz = torch.from_numpy(images), torch.from_numpy(SIZES)
    det = t_c4.rcnn_c4_inference(model, cfg, im, sz).to_numpy()
    losses = t_c4.rcnn_c4_train_losses(model, cfg, im, sz, GroundTruth(*map(torch.from_numpy, gt)),
                                       torch.Generator().manual_seed(0))
    return dict(jdet=jax.tree_util.tree_map(np.asarray, jdet), det=det,
                jlosses={k: float(v) for k, v in jlosses.items()},
                losses={k: float(v) for k, v in losses.items()})


def _canonical(det, i):
    v = det.valid[i]
    order = np.argsort(-det.scores[i][v], kind="stable")
    return {k: getattr(det, k)[i][v][order] for k in ("boxes", "scores", "classes", "probs",
                                                       "class_logits")}


@pytest.mark.parametrize("image", [0, 1])
def test_c4_detections_match_jax(c4_run, image):
    want = _canonical(c4_run["jdet"], image)
    got = _canonical(c4_run["det"], image)
    assert 3 <= len(got["scores"]) == len(want["scores"]) < DETS
    np.testing.assert_array_equal(got["classes"], want["classes"])
    for k in ("scores", "probs", "class_logits"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4, atol=2e-3)


def test_c4_train_losses_match_jax(c4_run):
    got, want = c4_run["losses"], c4_run["jlosses"]
    assert set(got) == set(want) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert want["loss_box_reg"] > 0 and want["loss_rpn_loc"] > 0


def test_c4_backbone_stops_at_res4_and_keeps_res5(c4_run):
    """``apply_resnet`` runs to res4 only; the model's res5 holds the pytree's
    res5 blocks, which ``_res5`` runs on the pooled RoIs."""
    cfg, _ = _configs()
    model = t_c4.build_c4_model(cfg, seed=3, device="cpu")
    with torch.inference_mode():
        feats = t_c4.apply_resnet(model.backbone, torch.zeros(1, 3, 64, 64), out_features=("res4",))
        vec = t_c4._res5(model, torch.rand(1, 2, 14, 14, 1024))
    assert set(feats) == {"res4"} and feats["res4"].shape == (1, 1024, 4, 4)
    assert vec.shape == (1, 2, 2048) and len(model.backbone.res5) == 3


def test_jax_c4_pytree_loads_into_the_port():
    """JAX's ``init_rcnn_c4`` tree loads into ``RCNNC4`` with strict names
    and shapes (``checkpoint/from_jax.py``), has the port init's structure,
    and comes back leaf for leaf."""
    from proben_tpu_torch.checkpoint import state_dict_to_jax

    cfg, jcfg = _configs()
    tree = jax.tree_util.tree_map(np.asarray, jax_init_rcnn_c4(jax.random.PRNGKey(0), jcfg))
    model = t_c4.build_c4_model(cfg, tree, device="cpu")
    port = t_c4.init_rcnn_c4(0, cfg)
    assert jax.tree_util.tree_structure(port) == jax.tree_util.tree_structure(tree)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(tree)))
    back = state_dict_to_jax(model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
