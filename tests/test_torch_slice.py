"""The whole inference slice of ``proben_tpu_torch`` against ``proben_tpu``
on the CPU in f32: a tiny R50-FPN at 128x160 (the sizes of
tests/test_composed_parity.py), the same calibrated parameters and images
through both packages' ``rcnn_inference`` — JAX with its Pallas RoIAlign in
interpret mode — then the port's ``Predictor``. The backbone's affines are
drawn at random (``random_affines``), so every residual branch reaches the
detections.

Calibration (weights only, applied to the numpy parameters handed to both
packages): random heads give saturated RPN deltas and softmax scores, so the
RPN's objectness/delta convs are rescaled to logit std 2 and delta std 0.3,
and the class head follows bench.py's recipe (weights x0.02, background bias
bisected until the images hold a few detections each below the cap).

Tolerance: the same f32 math in different summation orders. Proposals:
same count, boxes to rtol 1e-4 / atol 2e-3 px, scores to 1e-4. Detections
after a canonical (score-descending) sort: same count and classes, boxes to
atol 2e-3 px, scores and probabilities to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.models import build_config as jax_build_config
from proben_tpu.models import rcnn as jax_rcnn
from proben_tpu.models.fast_rcnn import FastRCNNConfig as JaxFastRCNNConfig
from proben_tpu.models.roi_heads import ROIHeadsConfig as JaxROIHeadsConfig
from proben_tpu.models.rpn import RPNConfig as JaxRPNConfig
from proben_tpu.models.rpn import apply_rpn_head as jax_apply_rpn_head
from proben_tpu.models.rpn import find_top_proposals as jax_find_top_proposals
from proben_tpu_torch.engine import Predictor
from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines
from proben_tpu_torch.models import rcnn as t_rcnn
from proben_tpu_torch.models.fast_rcnn import FastRCNNConfig
from proben_tpu_torch.models.rpn import RPNConfig, apply_rpn_head
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

H, W = 128, 160
SIZES = np.array([[128, 160], [120, 150]], np.int32)  # second image padded
PRE, POST, DETS = 400, 100, 20


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


def _calibrate(cfg, params, images):
    """Weights-only edits of ``params`` (in place) measured with the port."""
    model = build_model(cfg, params=params, device="cpu")
    with torch.inference_mode():
        feats = t_rcnn.extract_features(model, cfg, t_rcnn.preprocess(cfg, torch.from_numpy(images)))
        lg, dl = apply_rpn_head(model.rpn_head, [feats[f] for f in t_rcnn.RPN_IN_FEATURES])
    head = params["rpn_head"]
    for name, t, target in (("objectness", lg, 2.0), ("deltas", dl, 0.3)):
        s = target / float(torch.cat([x.flatten() for x in t]).std())
        head[name]["w"] = head[name]["w"] * s
        head[name]["b"] = head[name]["b"] * s
    cls = params["roi"]["output"]["cls_score"]
    cls["w"] = cls["w"] * 0.02
    lo, hi = 0.0, 16.0
    for _ in range(12):
        cls["b"] = cls["b"].copy()
        cls["b"][-1] = 0.5 * (lo + hi)
        model = build_model(cfg, params=params, device="cpu")
        det = t_rcnn.rcnn_inference(model, cfg, torch.from_numpy(images), torch.from_numpy(SIZES))
        n = det.valid.sum(-1)
        if int(n.max()) >= DETS:
            lo = 0.5 * (lo + hi)
        elif int(n.min()) < 4:
            hi = 0.5 * (lo + hi)
        else:
            return params
    raise AssertionError(f"calibration did not converge: {n.tolist()}")


@pytest.fixture(scope="module")
def slice_run():
    cfg = build_config(
        depth=50, num_classes=3,
        rpn=RPNConfig(pre_nms_topk_test=PRE, post_nms_topk_test=POST),
        rcnn=FastRCNNConfig(num_classes=3, topk_per_image=DETS, max_candidates=POST * 4),
    )
    images = np.stack([_image(0), _image(1)])
    params = _calibrate(cfg, random_affines(init_rcnn(0, cfg), 0), images)

    jcfg = jax_build_config(
        depth=50, num_classes=3, roi_align_impl="pallas",
        rpn=JaxRPNConfig(pre_nms_topk_test=PRE, post_nms_topk_test=POST),
        roi=JaxROIHeadsConfig(num_classes=3),
        rcnn=JaxFastRCNNConfig(num_classes=3, topk_per_image=DETS, max_candidates=POST * 4),
    )

    def jax_run(p, im, sz):
        feats = jax_rcnn.extract_features(p, jcfg, jax_rcnn.preprocess(jcfg, im))
        lg, dl = jax_apply_rpn_head(p["rpn_head"], [feats[f] for f in jax_rcnn.RPN_IN_FEATURES])
        anchors = jax_rcnn._anchors_for(feats)
        props = jax.vmap(lambda l, d, s: jax_find_top_proposals(
            l, d, anchors, (s[0], s[1]), PRE, POST, jcfg.rpn.nms_thresh))(lg, dl, sz)
        return props, jax_rcnn.rcnn_inference(p, jcfg, im, sz)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    (jprops, jdet) = jax.jit(jax_run)(jparams, jnp.asarray(images), jnp.asarray(SIZES))
    jdet = jax.tree_util.tree_map(np.asarray, jdet)

    model = build_model(cfg, params=params, device="cpu")
    with torch.inference_mode():
        im_t, sz_t = torch.from_numpy(images), torch.from_numpy(SIZES)
        feats = t_rcnn.extract_features(model, cfg, t_rcnn.preprocess(cfg, im_t))
        tprops = t_rcnn.propose(model, cfg, feats, sz_t)
        tdet = t_rcnn.rcnn_inference(model, cfg, im_t, sz_t).to_numpy()
    return dict(cfg=cfg, model=model, images=images, jprops=jprops, jdet=jdet,
                tprops=tprops, tdet=tdet)


def test_proposals_match_jax(slice_run):
    jb, js, jv = map(np.asarray, slice_run["jprops"])
    tb, ts, tv = (t.numpy() for t in slice_run["tprops"])
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() >= 50
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb, jb, rtol=1e-4, atol=2e-3)


def _canonical(det, i):
    v = det.valid[i]
    order = np.argsort(-det.scores[i][v], kind="stable")
    return {k: getattr(det, k)[i][v][order] for k in ("boxes", "scores", "classes", "probs",
                                                       "class_logits")}


@pytest.mark.parametrize("image", [0, 1])
def test_detections_match_jax(slice_run, image):
    want = _canonical(slice_run["jdet"], image)
    got = _canonical(slice_run["tdet"], image)
    assert 4 <= len(got["scores"]) == len(want["scores"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["class_logits"], want["class_logits"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4, atol=2e-3)
    assert (got["boxes"][:, 2] <= SIZES[image, 1]).all() and (got["boxes"][:, 3] <= SIZES[image, 0]).all()


def test_predictor_predict_batch_cpu(slice_run):
    """``Predictor.predict_batch`` on the CPU: detections rescaled to an
    original frame twice the input size, as JAX's ``postprocess_boxes``."""
    pred = Predictor(slice_run["model"], slice_run["cfg"], device="cpu")
    batch = {"image": slice_run["images"], "image_size": SIZES, "orig_size": 2 * SIZES,
             "image_id": [10, 11]}
    out = pred.predict_batch(batch)
    jdet = slice_run["jdet"]
    for i, rec in enumerate(out):
        want = jax_rcnn.postprocess_boxes(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a[i]), jdet),
            tuple(SIZES[i]), tuple(2 * SIZES[i]))
        v = np.asarray(want.valid)
        assert rec["image_id"] == 10 + i and len(rec["scores"]) == v.sum()
        order_g = np.argsort(-rec["scores"], kind="stable")
        order_w = np.argsort(-np.asarray(want.scores)[v], kind="stable")
        np.testing.assert_allclose(rec["boxes"][order_g], np.asarray(want.boxes)[v][order_w],
                                   rtol=1e-4, atol=4e-3)
        assert rec["probs"].shape == (v.sum(), 3) and rec["class_logits"].shape == (v.sum(), 4)


def test_box_head_decode_with_variance_matches_jax():
    """The variance head (ENABLE_GAUSSIANNLLOSS) through the box head, the
    output layers and the decode, against ``proben_tpu`` per image."""
    from proben_tpu.models.box_head import apply_box_head as jax_box_head
    from proben_tpu.models.box_head import apply_output_layers as jax_output_layers
    from proben_tpu.models.fast_rcnn import fast_rcnn_inference_single_image
    from proben_tpu_torch.models.box_head import apply_box_head, apply_output_layers
    from proben_tpu_torch.models.fast_rcnn import fast_rcnn_inference

    cfg = build_config(depth=50, num_classes=3, enable_gaussian_nll=True)
    params = init_rcnn(1, cfg)
    out = params["roi"]["output"]
    out["var_pred"]["w"] = out["var_pred"]["w"] * 30.0  # variances away from 1
    model = build_model(cfg, params=params, device="cpu")
    rng = np.random.RandomState(3)
    pooled = rng.rand(2, 48, 7, 7, 256).astype(np.float32)
    xy = rng.rand(2, 48, 2) * 100
    boxes = np.concatenate([xy, xy + rng.rand(2, 48, 2) * 50 + 4], -1).astype(np.float32)
    valid = rng.rand(2, 48) > 0.2
    jcfg = JaxFastRCNNConfig(num_classes=3, topk_per_image=DETS, max_candidates=48 * 3)
    tcfg = FastRCNNConfig(num_classes=3, topk_per_image=DETS, max_candidates=48 * 3)

    with torch.inference_mode():
        lg, dl, var = apply_output_layers(model.roi.output,
                                          apply_box_head(model.roi.box_head, torch.from_numpy(pooled)))
        det = fast_rcnn_inference(lg, dl, torch.from_numpy(boxes), torch.from_numpy(valid),
                                  torch.from_numpy(SIZES), tcfg, var).to_numpy()
    jp = jax.tree_util.tree_map(jnp.asarray, params["roi"])
    for i in range(2):
        jl, jd, jv = jax_output_layers(jp["output"], jax_box_head(jp["box_head"], jnp.asarray(pooled[i])))
        np.testing.assert_allclose(var[i].numpy(), np.asarray(jv), rtol=1e-4)
        want = fast_rcnn_inference_single_image(jl, jd, jnp.asarray(boxes[i]), jnp.asarray(valid[i]),
                                                tuple(SIZES[i]), jcfg, jv)
        np.testing.assert_array_equal(det.valid[i], np.asarray(want.valid))
        assert det.valid[i].sum() >= 4
        for name in ("boxes", "scores", "classes", "variance", "probs"):
            np.testing.assert_allclose(getattr(det, name)[i], np.asarray(getattr(want, name)),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
