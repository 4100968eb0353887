"""Middle (BGRTTT) and early (BGRT) fusion of ``proben_tpu_torch`` against
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

from proben_tpu.engine.train import make_train_step as jax_make_train_step
from proben_tpu.models import build_config as jax_build_config
from proben_tpu.models import init_rcnn as jax_init_rcnn
from proben_tpu.models import rcnn as jax_rcnn
from proben_tpu.models.fast_rcnn import FastRCNNConfig as JaxFastRCNNConfig
from proben_tpu.models.gaussian_blur import gaussian_blur as jax_gaussian_blur
from proben_tpu.models.gaussian_blur import gaussian_kernel_1d as jax_gaussian_kernel_1d
from proben_tpu.models.resnet import freeze_mask as jax_freeze_mask
from proben_tpu.models.roi_heads import ROIHeadsConfig as JaxROIHeadsConfig
from proben_tpu.models.rpn import RPNConfig as JaxRPNConfig
from proben_tpu.models.rpn import apply_rpn_head as jax_apply_rpn_head
from proben_tpu.models.rpn import find_top_proposals as jax_find_top_proposals
from proben_tpu.solver.build import SolverConfig as JaxSolverConfig
from proben_tpu.structures.detections import GroundTruth as JaxGroundTruth
from proben_tpu_torch.checkpoint import state_dict_from_jax, state_dict_to_jax
from proben_tpu_torch.engine import Predictor
from proben_tpu_torch.engine.train import losses_and_grads, make_train_step, trainable_mask
from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines
from proben_tpu_torch.models import rcnn as t_rcnn
from proben_tpu_torch.models.fast_rcnn import FastRCNNConfig
from proben_tpu_torch.models.gaussian_blur import gaussian_blur, gaussian_kernel_1d
from proben_tpu_torch.models.roi_heads import label_and_sample_proposals
from proben_tpu_torch.models.rpn import RPNConfig, find_top_proposals
from proben_tpu_torch.ops.roi_align_cuda import multilevel_roi_align
from proben_tpu_torch.solver import SolverConfig
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


@pytest.fixture(scope="module", params=list(MODES))
def infer_run(request):
    kw = MODES[request.param]
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
    return dict(mode=request.param, cfg=cfg, model=model, images=images, feats=feats,
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
    included) and comes back unchanged."""
    jcfg = jax_build_config(depth=101, input_format="BGRTTT", num_classes=3,
                            enable_gaussian_nll=True)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_rcnn(jax.random.PRNGKey(0), jcfg))
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


# ---------------------------------------------------------------------------
# training: one BGRTTT step at FREEZE_AT 3, and the blur / max-pool ablations
# ---------------------------------------------------------------------------

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
