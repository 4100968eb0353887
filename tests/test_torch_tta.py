"""Test-time augmentation (``models/tta.py::DetectionTTA``), the box head on
given boxes (``rcnn_inference_given_boxes``, ``Predictor.rescore_boxes``)
and ``remat_backbone`` of ``proben_tpu_torch`` against ``proben_tpu`` on
the CPU in f32.

A tiny R50-FPN (the port's init with random affines, the RPN rescaled to
logit std 2 and delta std 0.3, the class head as bench.py calibrates it:
weights x0.02, background bias bisected to 4-19 detections below the cap
of 20) and one 96x128 image. TTA at scales 64 and 96 with flips: four
augmentations, which JAX's ``DetectionTTA`` runs one batch each through
its jitted ``Predictor`` (one compile for inference, one for the given
boxes) and the port as one batch of four; both make the augmented images
with cv2 on the CPU.

Tolerances: boxes rtol 1e-4 / atol 2e-3 px, scores and probabilities 1e-4,
equal classes (f32 through 50 layers in other summation orders).
``remat_backbone``: losses and gradients equal to the run without it, rtol
1e-6 (the same operations recomputed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.data.dataset_mapper import MapperConfig as JaxMapperConfig
from proben_tpu.engine.predictor import Predictor as JaxPredictor
from proben_tpu.models import build_config as jax_build_config
from proben_tpu.models.fast_rcnn import FastRCNNConfig as JaxFastRCNNConfig
from proben_tpu.models.roi_heads import ROIHeadsConfig as JaxROIHeadsConfig
from proben_tpu.models.rpn import RPNConfig as JaxRPNConfig
from proben_tpu.models.tta import DetectionTTA as JaxDetectionTTA
from proben_tpu_torch.data.dataset_mapper import MapperConfig
from proben_tpu_torch.engine import Predictor
from proben_tpu_torch.engine.train import losses_and_grads
from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines
from proben_tpu_torch.models import rcnn as t_rcnn
from proben_tpu_torch.models.fast_rcnn import FastRCNNConfig
from proben_tpu_torch.models.rpn import RPNConfig
from proben_tpu_torch.models.tta import DetectionTTA
from proben_tpu_torch.structures import GroundTruth
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

H, W = 96, 128
PRE, POST, DETS = 200, 50, 20
SCALES = (64, 96)


def _image(seed, h=H, w=W):
    """Background gradient + box-shaped blobs (bench.py's recipe)."""
    rng = np.random.RandomState(seed)
    im = np.tile(np.linspace(60.0, 120.0, w, dtype=np.float32)[None, :, None], (h, 1, 3))
    im += rng.randn(h, w, 3).astype(np.float32) * 8
    for _ in range(5):
        x, y = rng.randint(0, w - 40), rng.randint(0, h - 40)
        bw, bh = rng.randint(14, 40), rng.randint(16, 40)
        im[y:y + bh, x:x + bw] = rng.uniform(130, 240)
    return np.clip(im, 0, 255)


def _configs():
    rpn = dict(pre_nms_topk_test=PRE, post_nms_topk_test=POST)
    rcnn = dict(num_classes=3, topk_per_image=DETS, max_candidates=POST * 3)
    return (build_config(depth=50, num_classes=3, rpn=RPNConfig(**rpn), rcnn=FastRCNNConfig(**rcnn)),
            jax_build_config(depth=50, num_classes=3, rpn=JaxRPNConfig(**rpn),
                             roi=JaxROIHeadsConfig(num_classes=3), rcnn=JaxFastRCNNConfig(**rcnn)))


def _calibrated(cfg, image):
    params = random_affines(init_rcnn(0, cfg), 0)
    images = torch.from_numpy(image[None])
    model = build_model(cfg, params=params, device="cpu")
    with torch.inference_mode():
        lg, dl = t_rcnn.rpn_outputs(model, cfg, t_rcnn.extract_features(model, cfg, t_rcnn.preprocess(cfg, images)))
    for name, t, target in (("objectness", lg, 2.0), ("deltas", dl, 0.3)):
        s = target / float(torch.cat([x.flatten() for x in t]).std())
        params["rpn_head"][name]["w"] = params["rpn_head"][name]["w"] * s
        params["rpn_head"][name]["b"] = params["rpn_head"][name]["b"] * s
    cls = params["roi"]["output"]["cls_score"]
    cls["w"] = cls["w"] * 0.02
    lo, hi = 0.0, 16.0
    for _ in range(12):
        cls["b"] = cls["b"].copy()
        cls["b"][-1] = 0.5 * (lo + hi)
        model = build_model(cfg, params=params, device="cpu")
        n = int(t_rcnn.rcnn_inference(model, cfg, images, torch.tensor([[H, W]])).valid.sum())
        if n >= DETS:
            lo = 0.5 * (lo + hi)
        elif n < 4:
            hi = 0.5 * (lo + hi)
        else:
            return params
    raise AssertionError(f"calibration did not converge: {n}")


@pytest.fixture(scope="module")
def tta_run():
    cfg, jcfg = _configs()
    image = _image(0)
    params = _calibrated(cfg, image)
    jpred = JaxPredictor(jax.tree_util.tree_map(jnp.asarray, params), jcfg)
    pred = Predictor(build_model(cfg, params=params, device="cpu"), cfg, device="cpu")
    out = {}
    for rescore in (False, True):
        kw = dict(scales=SCALES, flip=True, topk=DETS, rescore=rescore)
        out[rescore] = (JaxDetectionTTA(jpred, JaxMapperConfig(pad_shape=(H, W)), **kw)(image),
                        DetectionTTA(pred, MapperConfig(pad_shape=(H, W)), **kw)(image))
    return dict(cfg=cfg, image=image, params=params, jpred=jpred, pred=pred, out=out)


@pytest.mark.parametrize("rescore", [False, True])
def test_tta_matches_jax(tta_run, rescore):
    want, got = tta_run["out"][rescore]
    assert 4 <= len(got["scores"]) == len(want["scores"]) <= DETS
    for k in ("boxes", "scores", "classes"):
        assert got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4, atol=2e-3)
    assert (np.diff(got["scores"]) <= 0).all()
    assert (got["boxes"][:, 2] <= W + 1e-3).all() and (got["boxes"][:, 3] <= H + 1e-3).all()


def test_tta_rescore_changes_scores(tta_run):
    """Rescoring replaces the merged detection scores with the averaged box-
    head probabilities: same boxes, other scores."""
    plain, rescored = tta_run["out"][False][1], tta_run["out"][True][1]
    assert sorted(map(tuple, plain["boxes"].round(3))) == sorted(map(tuple, rescored["boxes"].round(3)))
    assert not np.allclose(np.sort(plain["scores"]), np.sort(rescored["scores"]))


def test_given_boxes_and_rescore_match_jax(tta_run):
    """``rcnn_inference_given_boxes`` and ``Predictor.rescore_boxes`` against
    JAX's ``Predictor.rescore_boxes`` (its jitted ``rcnn_inference_given_boxes``)
    on 20 given boxes padded to 20 rows (the TTA's shapes); no NMS: every
    row gets its softmax, logits and no variance."""
    rng = np.random.RandomState(3)
    xy = rng.rand(1, DETS, 2) * [W - 30, H - 30]
    boxes = np.concatenate([xy, xy + rng.rand(1, DETS, 2) * 40 + 6], -1).astype(np.float32)
    boxes[0, -3:] = 0.0  # padded rows
    images = tta_run["image"][None]
    jp, jl, jv = tta_run["jpred"].rescore_boxes(jnp.asarray(images), jnp.asarray(boxes))
    gp, gl, gv = tta_run["pred"].rescore_boxes(images, boxes)
    model, cfg = tta_run["pred"].model, tta_run["cfg"]
    dp, dl, _ = t_rcnn.rcnn_inference_given_boxes(model, cfg, torch.from_numpy(images), torch.from_numpy(boxes))
    assert jv is None and gv is None and gp.shape == (1, DETS, 4)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(dp.numpy(), gp.numpy())
    np.testing.assert_array_equal(dl.numpy(), gl.numpy())
    np.testing.assert_allclose(gp.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_remat_backbone_equal_losses_and_gradients(tta_run, monkeypatch):
    """``remat_backbone`` recomputes each trainable backbone block in the
    backward (``torch.utils.checkpoint``; R50 at FREEZE_AT 2: res3-res5, 13
    blocks, once per forward): the losses and every gradient equal the run
    without it."""
    import torch.utils.checkpoint as ckpt

    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = tta_run["cfg"]
    rng = np.random.RandomState(4)
    xy = rng.rand(2, 3, 2) * 60
    gt = GroundTruth(torch.from_numpy(np.concatenate([xy, xy + rng.rand(2, 3, 2) * 30 + 12], -1)
                                      .astype(np.float32)),
                     torch.from_numpy(rng.randint(0, 3, (2, 3)).astype(np.int32)), torch.ones(2, 3, dtype=torch.bool))
    batch = {"image": torch.from_numpy(np.stack([_image(5), _image(6)])),
             "image_size": torch.tensor([[H, W], [90, 120]]), "gt": gt}
    runs = {}
    for remat in (False, True):
        c = cfg.replace(remat_backbone=remat)
        model = build_model(c, params=tta_run["params"], device="cpu")
        for name, p in model.named_parameters():
            p.requires_grad_(not name.startswith(("backbone.stem", "backbone.res2")))
        runs[remat] = losses_and_grads(model, c, batch, torch.Generator().manual_seed(0))
        assert len(calls) == (13 if remat else 0)
    (l0, t0, g0), (l1, t1, g1) = runs[False], runs[True]
    assert set(l0) == set(l1) and float(l0["loss_box_reg"]) > 0
    for k in l0:
        np.testing.assert_allclose(float(l1[k]), float(l0[k]), rtol=1e-6, err_msg=k)
    assert set(g0) == set(g1) and len(g0) > 100
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-6, atol=1e-12, err_msg=k)
    assert float(g0["backbone.res3.0.conv1.weight"].abs().sum()) > 0
