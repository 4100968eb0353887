"""Shared setup of the fusion tests (``tests/test_torch_fusion_*.py``): middle
(BGRTTT) and early (BGRT) fusion of ``proben_tpu_torch`` against
``proben_tpu`` on the CPU in f32, at the sizes of tests/test_torch_slice.py
and tests/test_torch_train.py: a tiny R50-FPN at 128x160 (two R50-FPNs for
BGRTTT), the port's numpy init with random affines handed to both packages,
JAX's Pallas RoIAlign in interpret mode for inference.

Calibration (weights only, applied to the parameters handed to both
packages) as in those files: the RPN's objectness and delta convs rescaled
to output std 2 and 0.3; for inference the class head damped (x0.02) and
its background bias bisected until each image holds a few detections below
the cap. Training uses identity sampling (every anchor; every proposal and
gt box), so the packages' different random numbers only reorder rows, and
the box head's biases are raised until no sampled RoI's fc1/fc2
pre-activation lies near zero (``_box_head_off_zero``).

Tolerances are those of the single-modality files, for the same reason
(the same f32 math in other summation orders). Inference: proposals to
rtol 1e-4 / atol 2e-3 px, scores to 1e-4; detections after a canonical sort
with the same count and classes, boxes to atol 2e-3 px, scores and
probabilities to 1e-4. Training: losses to rtol 1e-4; the momentum after
one step to a relative L2 error of 5e-4 over all trainable tensors, 2e-5
for the median tensor and 2e-2 for every tensor; frozen parameters bit for
bit.
"""

import dataclasses

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
from proben_tpu_torch.models.roi_heads import label_and_sample_proposals
from proben_tpu_torch.models.rpn import RPNConfig, find_top_proposals
from proben_tpu_torch.structures import GroundTruth

H, W = 128, 160
SIZES = np.array([[128, 160], [120, 150]], np.int32)  # second image padded
PRE, POST, DETS = 400, 100, 20
MF_MEAN = (103.53, 116.28, 123.675, 135.438, 135.438, 135.438)
EF_MEAN = (103.53, 116.28, 123.675, 135.438)
MODES = {
    "BGRTTT": dict(input_format="BGRTTT", pixel_mean=MF_MEAN),
    "BGRTTT shared": dict(input_format="BGRTTT", pixel_mean=MF_MEAN,
                          middle_fusion_inference_shares_backbone=True),
    "BGRT": dict(input_format="BGRT", pixel_mean=EF_MEAN, pixel_std=(1.0,) * 4),
}


def _image(seed, c=3):
    """Background gradient + box-shaped blobs (bench.py's recipe)."""
    rng = np.random.RandomState(seed)
    im = np.tile(np.linspace(60.0, 120.0, W, dtype=np.float32)[None, :, None], (H, 1, c))
    im += rng.randn(H, W, c).astype(np.float32) * 8
    for _ in range(6):
        x, y = rng.randint(0, W - 40), rng.randint(0, H - 48)
        bw, bh = rng.randint(12, 40), rng.randint(16, 48)
        im[y:y + bh, x:x + bw] = rng.uniform(130, 240)
    return np.clip(im, 0, 255)


def _images(channels):
    """Two images: an RGB-like stream, then (BGRT, BGRTTT) thermal-like
    channels from another scene."""
    rgb = np.stack([_image(0), _image(1)])
    if channels == 3:
        return rgb
    thermal = np.stack([_image(10, 1), _image(11, 1)])
    return np.concatenate([rgb, np.repeat(thermal, channels - 3, axis=-1)], axis=-1)


def _scale_rpn(cfg, params, images, logit_std=2.0, delta_std=0.3):
    """Rescale the RPN's objectness and delta convs (in ``params``)."""
    model = build_model(cfg, params=params, device="cpu")
    with torch.inference_mode():
        feats = t_rcnn.extract_features(model, cfg, t_rcnn.preprocess(cfg, torch.from_numpy(images)))
        lg, dl = t_rcnn.rpn_outputs(model, cfg, feats)
    head = params["rpn_head"]
    for name, t, target in (("objectness", lg, logit_std), ("deltas", dl, delta_std)):
        s = target / float(torch.cat([x.flatten() for x in t]).std())
        head[name]["w"] = head[name]["w"] * s
        head[name]["b"] = head[name]["b"] * s
    return params


def _calibrate(cfg, params, images):
    """The RPN rescaled, then the class head damped and its background bias
    bisected (weights only, in place), measured with the port."""
    _scale_rpn(cfg, params, images)
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


def infer_run_for(mode):
    """Everything the inference tests compare, for one mode of ``MODES``."""
    kw = MODES[mode]
    cfg = build_config(
        depth=50, num_classes=3, **kw,
        rpn=RPNConfig(pre_nms_topk_test=PRE, post_nms_topk_test=POST),
        rcnn=FastRCNNConfig(num_classes=3, topk_per_image=DETS, max_candidates=POST * 4),
    )
    images = _images(cfg.num_in_channels)
    params = _calibrate(cfg, random_affines(init_rcnn(0, cfg), 0), images)

    jcfg = jax_build_config(
        depth=50, num_classes=3, roi_align_impl="pallas", **kw,
        rpn=JaxRPNConfig(pre_nms_topk_test=PRE, post_nms_topk_test=POST),
        roi=JaxROIHeadsConfig(num_classes=3),
        rcnn=JaxFastRCNNConfig(num_classes=3, topk_per_image=DETS, max_candidates=POST * 4),
    )

    def jax_run(p, im, sz):
        x = jax_rcnn.preprocess(jcfg, im)
        feats = jax_rcnn.extract_features(p, jcfg, x)
        lg, dl = jax_apply_rpn_head(p["rpn_head"], [feats[f] for f in jax_rcnn.RPN_IN_FEATURES])
        anchors = jax_rcnn._anchors_for(feats)
        props = jax.vmap(lambda l, d, s: jax_find_top_proposals(
            l, d, anchors, (s[0], s[1]), PRE, POST, jcfg.rpn.nms_thresh))(lg, dl, sz)
        return x, props, jax_rcnn.rcnn_inference(p, jcfg, im, sz)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jx, jprops, jdet = jax.jit(jax_run)(jparams, jnp.asarray(images), jnp.asarray(SIZES))

    model = build_model(cfg, params=params, device="cpu")
    with torch.inference_mode():
        im_t, sz_t = torch.from_numpy(images), torch.from_numpy(SIZES)
        x = t_rcnn.preprocess(cfg, im_t)
        feats = t_rcnn.extract_features(model, cfg, x)
        tprops = t_rcnn.propose(model, cfg, feats, sz_t)
        tdet = t_rcnn.rcnn_inference(model, cfg, im_t, sz_t).to_numpy()
    return dict(mode=mode, cfg=cfg, model=model, images=images, feats=feats,
                jx=np.asarray(jx), tx=x.numpy(), jprops=jprops,
                jdet=jax.tree_util.tree_map(np.asarray, jdet), tprops=tprops, tdet=tdet)


def test_preprocess_matches_jax(infer_run):
    """BGRTTT: RGB channels with pixel_mean[:3], thermal with [3:6], the
    shared pixel_std[:3]; BGRT: 4-entry vectors. The same f32 operations."""
    np.testing.assert_array_equal(infer_run["tx"], infer_run["jx"])


def test_features_are_the_streams_concatenated(infer_run):
    """Middle fusion feeds the heads 2 x 256 channels per level, RGB first,
    still in channels_last memory, so ``nhwc`` is a view; the shared mode's
    thermal half is the RGB backbone's on the thermal channels."""
    cfg, model, feats = infer_run["cfg"], infer_run["model"], infer_run["feats"]
    for k, f in feats.items():
        assert f.shape[1] == cfg.head_in_channels, k
        assert f.is_contiguous(memory_format=torch.channels_last), k
    if not cfg.dual:
        return
    x = t_rcnn.preprocess(cfg, torch.from_numpy(infer_run["images"]))
    shared = cfg.middle_fusion_inference_shares_backbone
    with torch.inference_mode():
        rgb = t_rcnn._stream(model.backbone, model.fpn, cfg, x[..., :3], False)
        thermal = t_rcnn._stream(model.backbone if shared else model.backbone_2,
                                 model.fpn if shared else model.fpn_2, cfg, x[..., 3:], False)
    for k, f in feats.items():
        assert torch.equal(f[:, :256], rgb[k]) and torch.equal(f[:, 256:], thermal[k]), k


def test_proposals_match_jax(infer_run):
    jb, js, jv = map(np.asarray, infer_run["jprops"])
    tb, ts, tv = (t.numpy() for t in infer_run["tprops"])
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
def test_detections_match_jax(infer_run, image):
    want = _canonical(infer_run["jdet"], image)
    got = _canonical(infer_run["tdet"], image)
    assert 4 <= len(got["scores"]) == len(want["scores"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["class_logits"], want["class_logits"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4, atol=2e-3)


def test_predictor_takes_fused_batches(infer_run):
    """``Predictor.predict_batch`` on the CPU takes 4- and 6-channel
    batches as they are and gives ``rcnn_inference``'s detections."""
    pred = Predictor(infer_run["model"], infer_run["cfg"], device="cpu")
    out = pred.predict_batch({"image": infer_run["images"], "image_size": SIZES,
                              "orig_size": SIZES, "image_id": [0, 1]})
    for i, rec in enumerate(out):
        want = _canonical(infer_run["tdet"], i)
        order = np.argsort(-rec["scores"], kind="stable")
        np.testing.assert_array_equal(rec["scores"][order], want["scores"])
        np.testing.assert_array_equal(rec["boxes"][order], want["boxes"])


G = 6
TRAIN_PRE, TRAIN_POST = 200, 64
N_ANCHORS = sum(-(-H // s) * -(-W // s) * 3 for s in (4, 8, 16, 32, 64))
SOLVER = dict(base_lr=0.01, warmup_iters=0, weight_decay=1e-4, weight_decay_bias=0.0,
              bias_lr_factor=2.0)


def _gt(seed):
    rng = np.random.RandomState(seed)
    xy = rng.rand(2, G, 2) * 90
    boxes = np.concatenate([xy, xy + rng.rand(2, G, 2) * 40 + 12], -1).astype(np.float32)
    valid = np.ones((2, G), bool)
    valid[:, 4:] = False
    return boxes, rng.randint(0, 3, (2, G)).astype(np.int32), valid


def _identity_sampling(cfg):
    return cfg.replace(
        rpn=dataclasses.replace(cfg.rpn, pre_nms_topk_train=TRAIN_PRE,
                                post_nms_topk_train=TRAIN_POST, batch_size_per_image=N_ANCHORS),
        roi=dataclasses.replace(cfg.roi, batch_size_per_image=TRAIN_POST + G, positive_fraction=0.5),
    )


def _train_cfgs(**kw):
    kw = dict(depth=50, num_classes=3, input_format="BGRTTT", pixel_mean=MF_MEAN, freeze_at=3, **kw)
    return _identity_sampling(build_config(**kw)), _identity_sampling(jax_build_config(**kw))


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _box_head_off_zero(cfg, params, images, gt):
    """Raise the box head's biases (in ``params``) until no sampled RoI's
    fc1 or fc2 pre-activation lies near zero: the packages' sums round
    differently, and one ReLU taking the other side there would change a
    whole RoI's gradient upstream of the head, in both backbones."""
    model = build_model(cfg, params=params, device="cpu")
    with torch.no_grad():
        feats = t_rcnn.extract_features(model, cfg, t_rcnn.preprocess(cfg, torch.from_numpy(images)),
                                        training=True)
        lg, dl = t_rcnn.rpn_outputs(model, cfg, feats)
        boxes, _, valid = find_top_proposals(
            lg, dl, t_rcnn.anchors_for(feats), torch.from_numpy(SIZES), TRAIN_PRE, TRAIN_POST,
            cfg.rpn.nms_thresh, cfg.rpn.min_box_side_len)
        gt_t = GroundTruth(*map(torch.from_numpy, gt))
        s_boxes, _, _, s_valid, _ = label_and_sample_proposals(boxes, valid, gt_t, torch.Generator(),
                                                                cfg.roi)
        h = t_rcnn.pool_proposals(cfg, feats, s_boxes)[s_valid].flatten(1)
        for fc in params["roi"]["box_head"]["fcs"]:
            pre = h @ torch.from_numpy(fc["w"]) + torch.from_numpy(fc["b"])
            fc["b"] = fc["b"] + 2.0 * float(pre.abs().max())
            h = pre + 2.0 * float(pre.abs().max())
    return params
