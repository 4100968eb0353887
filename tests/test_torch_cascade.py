"""Cascade R-CNN's heads of ``proben_tpu_torch`` (``models/cascade.py``) and
the class-agnostic Fast R-CNN decode and losses against ``proben_tpu`` on
the CPU in f32.

The heads run on given features and proposals, as
tests/test_c4_cascade.py::test_cascade_heads sets them up: p2..p5 maps of a
128x128 image at C = 64, 40 proposals per image, two images. JAX's
functions take one image, so they are vmapped over the two (one module-
scoped jit). The class score weights are scaled x30 so that the averaged
probabilities spread (no near-tie at the top-k cut). Training uses
identity sampling per stage (every proposal and gt box sampled; each
stage's foreground stays below the positive fraction), so the packages'
random numbers only reorder the rows.

Tolerances: detections boxes rtol 1e-4 / atol 2e-3 px, scores and
probabilities 1e-4, equal classes; losses rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.models.cascade import cascade_inference as jax_cascade_inference
from proben_tpu.models.cascade import cascade_train_losses as jax_cascade_losses
from proben_tpu.models.cascade import init_cascade_roi_heads as jax_init_cascade
from proben_tpu.models.fast_rcnn import FastRCNNConfig as JaxFastRCNNConfig
from proben_tpu.models.fast_rcnn import fast_rcnn_inference_single_image, fast_rcnn_losses as jax_frcnn_losses
from proben_tpu.models.roi_heads import ROIHeadsConfig as JaxROIHeadsConfig
from proben_tpu.structures.detections import GroundTruth as JaxGroundTruth
from proben_tpu_torch.models import cascade as t_cascade
from proben_tpu_torch.models.box_head import OutputLayers, init_output_layers
from proben_tpu_torch.models.fast_rcnn import FastRCNNConfig, fast_rcnn_inference, fast_rcnn_losses
from proben_tpu_torch.models.roi_heads import ROIHeadsConfig
from proben_tpu_torch.structures import GroundTruth
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

H = W = 128
R, G, C = 40, 2, 64
SIZES = np.array([[128, 128], [120, 110]], np.int32)


def _inputs():
    rng = np.random.RandomState(1)
    feats = [rng.rand(2, H // s, W // s, C).astype(np.float32) for s in (4, 8, 16, 32)]
    xy = rng.rand(2, R, 2) * 80
    props = np.concatenate([xy, xy + rng.rand(2, R, 2) * 30 + 8], -1).astype(np.float32)
    valid = np.ones((2, R), bool)
    valid[1, -5:] = False
    gt = (np.array([[[10, 10, 60, 60], [50, 40, 90, 100]]] * 2, np.float32),
          np.array([[1, 2], [0, 1]], np.int32), np.array([[True, True], [True, False]]))
    return feats, props, valid, gt


@pytest.fixture(scope="module")
def cascade_run():
    feats, props, valid, gt = _inputs()
    params = t_cascade.init_cascade_roi_heads(0, in_channels=C, num_classes=3)
    for stage in params["stages"]:
        stage["output"]["cls_score"]["w"] = stage["output"]["cls_score"]["w"] * 30.0
    roi = dict(num_classes=3, batch_size_per_image=R + G, positive_fraction=0.5)
    rcnn = dict(num_classes=3, topk_per_image=8, max_candidates=64, score_thresh=0.0)
    jroi, jrcnn = JaxROIHeadsConfig(**roi), JaxFastRCNNConfig(**rcnn)

    def jax_run(p, f, pr, v, sz, g, keys):
        det = jax.vmap(lambda fi, pi, vi, si: jax_cascade_inference(
            p, fi, pi, vi, (si[0], si[1]), jroi, jrcnn))(f, pr, v, sz)
        losses = jax.vmap(lambda fi, pi, vi, gi, ki: jax_cascade_losses(
            p, fi, pi, vi, gi, ki, jroi, jrcnn))(f, pr, v, g, keys)
        return det, {k: jnp.mean(x) for k, x in losses.items()}

    jdet, jlosses = jax.jit(jax_run)(
        jax.tree_util.tree_map(jnp.asarray, params), [jnp.asarray(f) for f in feats],
        jnp.asarray(props), jnp.asarray(valid), jnp.asarray(SIZES),
        JaxGroundTruth(*map(jnp.asarray, gt)), jax.random.split(jax.random.PRNGKey(2), 2))

    heads = t_cascade.build_cascade_heads(params, in_channels=C, num_classes=3, device="cpu")
    levels = [torch.from_numpy(f) for f in feats]
    args = (torch.from_numpy(props), torch.from_numpy(valid))
    det = t_cascade.cascade_inference(heads, levels, *args, torch.from_numpy(SIZES),
                                      ROIHeadsConfig(**roi), FastRCNNConfig(**rcnn)).to_numpy()
    losses = t_cascade.cascade_train_losses(heads, levels, *args, GroundTruth(*map(torch.from_numpy, gt)),
                                            torch.Generator().manual_seed(0), ROIHeadsConfig(**roi),
                                            FastRCNNConfig(**rcnn))
    return dict(jdet=jax.tree_util.tree_map(np.asarray, jdet), det=det,
                jlosses={k: float(v) for k, v in jlosses.items()},
                losses={k: float(v) for k, v in losses.items()})


def _canonical(det, i):
    v = det.valid[i]
    order = np.argsort(-det.scores[i][v], kind="stable")
    return {k: getattr(det, k)[i][v][order] for k in ("boxes", "scores", "classes", "probs")}


@pytest.mark.parametrize("image", [0, 1])
def test_cascade_inference_matches_jax(cascade_run, image):
    want = _canonical(cascade_run["jdet"], image)
    got = _canonical(cascade_run["det"], image)
    assert len(got["scores"]) == len(want["scores"]) == 8
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4, atol=2e-3)
    assert (got["boxes"][:, 2] <= SIZES[image, 1]).all() and (got["boxes"][:, 3] <= SIZES[image, 0]).all()


def test_cascade_train_losses_match_jax(cascade_run):
    got, want = cascade_run["losses"], cascade_run["jlosses"]
    assert set(got) == set(want) == {f"{k}_stage{i}" for k in ("loss_cls", "loss_box_reg")
                                     for i in range(3)}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert all(want[f"loss_box_reg_stage{i}"] > 0 for i in range(3))


def test_cascade_launches_k2_three_times_per_batch(monkeypatch):
    """Inference pools the proposals once per stage: three windowed-pooling
    calls (K2 on the card) per batch; training pools each stage's samples
    with autograd (three K3 launches on the card) and refines without."""
    from proben_tpu_torch.ops import roi_align_cuda

    calls = []
    real = roi_align_cuda.windowed_roi_align
    monkeypatch.setattr(roi_align_cuda, "windowed_roi_align",
                        lambda *a: calls.append(torch.is_grad_enabled()) or real(*a))
    feats, props, valid, gt = _inputs()
    heads = t_cascade.build_cascade_heads(in_channels=C, num_classes=3, device="cpu")
    levels = [torch.from_numpy(f).requires_grad_() for f in feats]
    args = (torch.from_numpy(props), torch.from_numpy(valid))
    t_cascade.cascade_inference(heads, levels, *args, torch.from_numpy(SIZES), ROIHeadsConfig(),
                                FastRCNNConfig())
    assert calls == [False] * 3
    calls.clear()
    t_cascade.cascade_train_losses(heads, levels, *args, GroundTruth(*map(torch.from_numpy, gt)),
                                   torch.Generator(), ROIHeadsConfig(), FastRCNNConfig())
    assert calls == [True, False] * 3


def test_class_agnostic_decode_and_losses_match_jax():
    """``fast_rcnn_inference`` with (B, R, 4) deltas broadcast to every class
    and ``fast_rcnn_losses`` with ``cls_agnostic_bbox_reg`` and Cascade's
    second-stage ``box_reg_weights``, against JAX per image; the output
    layers' class-agnostic ``bbox_pred`` has 4 outputs."""
    out = OutputLayers(in_dim=16, num_classes=3, cls_agnostic_bbox_reg=True)
    p = init_output_layers(np.random.default_rng(0), in_dim=16, num_classes=3, cls_agnostic_bbox_reg=True)
    assert out.bbox_pred.weight.shape == (4, 16) and p["bbox_pred"]["w"].shape == (16, 4)
    rng = np.random.RandomState(3)
    b, r = 2, 30
    logits = (rng.randn(b, r, 4) * 2).astype(np.float32)
    deltas = (rng.randn(b, r, 4) * 0.5).astype(np.float32)
    xy = rng.rand(b, r, 2) * 90
    boxes = np.concatenate([xy, xy + rng.rand(b, r, 2) * 40 + 4], -1).astype(np.float32)
    valid = rng.rand(b, r) > 0.1
    gt_classes = rng.randint(0, 4, (b, r)).astype(np.int32)
    gt_boxes = boxes + rng.randn(b, r, 4).astype(np.float32) * 3
    kw = dict(num_classes=3, topk_per_image=10, max_candidates=r * 3, cls_agnostic_bbox_reg=True,
              box_reg_weights=(20.0, 20.0, 10.0, 10.0), smooth_l1_beta=0.5)
    t = [torch.from_numpy(a) for a in (logits, deltas, boxes, valid)]
    det = fast_rcnn_inference(*t, torch.from_numpy(SIZES), FastRCNNConfig(**kw)).to_numpy()
    losses = fast_rcnn_losses(t[0], t[1], None, t[2], torch.from_numpy(gt_classes), t[3],
                              torch.from_numpy(gt_boxes), FastRCNNConfig(**kw))
    for i in range(b):
        want = fast_rcnn_inference_single_image(
            jnp.asarray(logits[i]), jnp.asarray(deltas[i]), jnp.asarray(boxes[i]), jnp.asarray(valid[i]),
            tuple(SIZES[i]), JaxFastRCNNConfig(**kw))
        np.testing.assert_array_equal(det.valid[i], np.asarray(want.valid))
        assert det.valid[i].sum() >= 5
        for name in ("boxes", "scores", "classes", "probs"):
            np.testing.assert_allclose(getattr(det, name)[i], np.asarray(getattr(want, name)),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
        jl = jax_frcnn_losses(jnp.asarray(logits[i]), jnp.asarray(deltas[i]), None, jnp.asarray(boxes[i]),
                              jnp.asarray(gt_classes[i]), jnp.asarray(valid[i]), jnp.asarray(gt_boxes[i]),
                              JaxFastRCNNConfig(**kw))
        for k, v in jl.items():
            np.testing.assert_allclose(float(losses[k][i]), float(v), rtol=1e-4, err_msg=k)


def test_jax_cascade_pytree_loads_into_the_port():
    """JAX's ``init_cascade_roi_heads`` tree (class-agnostic ``bbox_pred`` of
    4 outputs per stage) loads into ``CascadeROIHeads`` with strict names and
    shapes, has the port init's structure, and comes back leaf for leaf."""
    from proben_tpu_torch.checkpoint import state_dict_to_jax

    tree = jax.tree_util.tree_map(np.asarray, jax_init_cascade(jax.random.PRNGKey(0), in_channels=C))
    heads = t_cascade.build_cascade_heads(tree, in_channels=C, device="cpu")
    port = t_cascade.init_cascade_roi_heads(0, in_channels=C)
    assert jax.tree_util.tree_structure(port) == jax.tree_util.tree_structure(tree)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(tree)))
    assert all(s.output.bbox_pred.weight.shape == (4, 1024) for s in heads.stages)
    back = state_dict_to_jax(heads.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
