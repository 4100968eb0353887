"""RetinaNet and ProposalNetwork of ``proben_tpu_torch``
(``models/retinanet.py``, ``models/proposal_network.py``) and the FPN's
``in_features`` / ``top_block_maxpool`` arguments against ``proben_tpu`` on
the CPU in f32.

Tiny R50s at 128x128 (two images, the second padded), the port's init
loaded into both packages, each package's functions in one module-scoped
jit (JAX) per model. RetinaNet calibration (weights only, for both
packages): the class and box convs rescaled to logit std 1.5 and delta std
0.3, then the class bias bisected to the lowest value at which every
image keeps at least 3 detections (the first image, of higher contrast,
then fills the cap of 12: its cut falls between random scores ~1e-2
apart). The RPN of the
ProposalNetwork is rescaled to logit std 2 and delta std 0.3 and its
training samples every anchor (identity sampling,
tests/test_torch_train.py).

Tolerances: detections and proposals boxes rtol 1e-4 / atol 2e-3 px, scores
1e-4, equal classes; losses rtol 1e-4; FPN maps rtol 1e-5 / atol 1e-5 of
the map's largest magnitude (f32 convolutions over up to 2048 channels in
another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.models import build_config as jax_build_config
from proben_tpu.models.fpn import apply_fpn as jax_apply_fpn
from proben_tpu.models.proposal_network import proposal_network_inference as jax_pn_inference
from proben_tpu.models.proposal_network import proposal_network_losses as jax_pn_losses
from proben_tpu.models.retinanet import RetinaNetConfig as JaxRetinaNetConfig
from proben_tpu.models.retinanet import retinanet_inference as jax_retina_inference
from proben_tpu.models.retinanet import retinanet_losses as jax_retina_losses
from proben_tpu.models.retinanet import init_retinanet as jax_init_retinanet
from proben_tpu.models.rpn import RPNConfig as JaxRPNConfig
from proben_tpu.structures.detections import GroundTruth as JaxGroundTruth
from proben_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines
from proben_tpu_torch.models import proposal_network as t_pn
from proben_tpu_torch.models import rcnn as t_rcnn
from proben_tpu_torch.models import retinanet as t_retina
from proben_tpu_torch.models.fpn import FPN, apply_fpn, init_fpn
from proben_tpu_torch.models.rpn import RPNConfig
from proben_tpu_torch.structures import GroundTruth
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

H = W = 128
SIZES = np.array([[128, 128], [120, 110]], np.int32)
DETS = 12
RETINA = dict(num_classes=3, topk_candidates=100, topk_per_image=DETS)


def _image(seed):
    """Background gradient + box-shaped blobs (bench.py's recipe)."""
    rng = np.random.RandomState(seed)
    im = np.tile(np.linspace(60.0, 120.0, W, dtype=np.float32)[None, :, None], (H, 1, 3))
    im += rng.randn(H, W, 3).astype(np.float32) * 8
    for _ in range(5):
        x, y = rng.randint(0, W - 48), rng.randint(0, H - 48)
        bw, bh = rng.randint(16, 48), rng.randint(16, 48)
        im[y:y + bh, x:x + bw] = rng.uniform(130, 240)
    return np.clip(im, 0, 255)


def _gt(empty=False):
    rng = np.random.RandomState(4)
    xy = rng.rand(2, 3, 2) * 70
    boxes = np.concatenate([xy, xy + rng.rand(2, 3, 2) * 40 + 16], -1).astype(np.float32)
    valid = np.zeros((2, 3), bool) if empty else np.array([[True] * 3, [True, True, False]])
    return boxes, rng.randint(0, 3, (2, 3)).astype(np.int32), valid


IMAGES = np.stack([_image(0), _image(1)])


def _calibrated_retina(cfg):
    params = random_affines(t_retina.init_retinanet(0, cfg), 0)
    im, sz = torch.from_numpy(IMAGES), torch.from_numpy(SIZES)
    model = t_retina.build_retinanet(cfg, params, device="cpu")
    with torch.inference_mode():
        lg, dl = t_retina._head(model, cfg, t_retina._features(model, cfg, im, False))
    head = params["head"]
    for name, t, target in (("cls_score", lg, 1.5), ("bbox_pred", dl, 0.3)):
        v = torch.cat([x.flatten() for x in t])
        s = target / float(v.std())
        head[name]["w"] = head[name]["w"] * s
        if name == "bbox_pred":
            head[name]["b"] = head[name]["b"] * s

    def count(bias):
        head["cls_score"]["b"] = np.full_like(head["cls_score"]["b"], bias)
        model = t_retina.build_retinanet(cfg, params, device="cpu")
        return int(t_retina.retinanet_inference(model, cfg, im, sz).valid.sum(-1).min())

    lo, hi = -12.0, 4.0  # count(lo) < 3 <= count(hi)
    assert count(lo) < 3 <= count(hi)
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        lo, hi = (lo, mid) if count(mid) >= 3 else (mid, hi)
    count(hi)
    return params


@pytest.fixture(scope="module")
def retina_run():
    cfg, jcfg = t_retina.RetinaNetConfig(**RETINA), JaxRetinaNetConfig(**RETINA)
    params = _calibrated_retina(cfg)
    run = jax.jit(lambda p, im, sz, g: (jax_retina_inference(p, jcfg, im, sz),
                                        jax_retina_losses(p, jcfg, im, sz, JaxGroundTruth(*g))))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jargs = (jnp.asarray(IMAGES), jnp.asarray(SIZES))
    jdet, jlosses = run(jp, *jargs, tuple(map(jnp.asarray, _gt())))
    _, jlosses_empty = run(jp, *jargs, tuple(map(jnp.asarray, _gt(empty=True))))
    model = t_retina.build_retinanet(cfg, params, device="cpu")
    im, sz = torch.from_numpy(IMAGES), torch.from_numpy(SIZES)
    losses, losses_empty = (t_retina.retinanet_losses(model, cfg, im, sz,
                                                      GroundTruth(*map(torch.from_numpy, _gt(e))))
                            for e in (False, True))
    as_float = lambda d: {k: float(v) for k, v in d.items()}  # noqa: E731
    return dict(jdet=jax.tree_util.tree_map(np.asarray, jdet),
                det=t_retina.retinanet_inference(model, cfg, im, sz).to_numpy(),
                jlosses=as_float(jlosses), losses=as_float(losses),
                jlosses_empty=as_float(jlosses_empty), losses_empty=as_float(losses_empty))


@pytest.mark.parametrize("image", [0, 1])
def test_retinanet_detections_match_jax(retina_run, image):
    want, got = retina_run["jdet"], retina_run["det"]
    v = want.valid[image]
    np.testing.assert_array_equal(got.valid[image], v)
    assert 3 <= v.sum() <= DETS
    np.testing.assert_array_equal(got.classes[image][v], want.classes[image][v])
    np.testing.assert_allclose(got.scores[image], want.scores[image], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.boxes[image], want.boxes[image], rtol=1e-4, atol=2e-3)
    assert (np.diff(got.scores[image][v]) <= 0).all()
    assert (got.boxes[image][v, 2] <= SIZES[image, 1]).all() and (got.boxes[image][v, 3] <= SIZES[image, 0]).all()


@pytest.mark.parametrize("gt", ["boxes", "empty"])
def test_retinanet_losses_match_jax(retina_run, gt):
    suffix = "" if gt == "boxes" else "_empty"
    got, want = retina_run["losses" + suffix], retina_run["jlosses" + suffix]
    assert set(got) == set(want) == {"loss_cls", "loss_box_reg"}
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert (want["loss_box_reg"] > 0) == (gt == "boxes")


@pytest.fixture(scope="module")
def pn_run():
    n_anchors = sum(-(-H // s) * -(-W // s) * 3 for s in (4, 8, 16, 32, 64))
    rpn = dict(pre_nms_topk_test=60, post_nms_topk_test=24, pre_nms_topk_train=60,
               post_nms_topk_train=24, batch_size_per_image=n_anchors)
    cfg = build_config(depth=50, rpn=RPNConfig(**rpn))
    jcfg = jax_build_config(depth=50, rpn=JaxRPNConfig(**rpn))
    params = random_affines(init_rcnn(0, cfg), 0)
    im, sz = torch.from_numpy(IMAGES), torch.from_numpy(SIZES)
    model = build_model(cfg, params, device="cpu")
    with torch.inference_mode():
        lg, dl = t_rcnn.rpn_outputs(model, cfg, t_rcnn.extract_features(model, cfg, t_rcnn.preprocess(cfg, im)))
    for name, t, target in (("objectness", lg, 2.0), ("deltas", dl, 0.3)):
        s = target / float(torch.cat([x.flatten() for x in t]).std())
        params["rpn_head"][name]["w"] = params["rpn_head"][name]["w"] * s
        params["rpn_head"][name]["b"] = params["rpn_head"][name]["b"] * s
    gt = _gt()
    jprops, jlosses = jax.jit(lambda p, im, sz, g: (
        jax_pn_inference(p, jcfg, im, sz),
        jax_pn_losses(p, jcfg, im, sz, JaxGroundTruth(*g), jax.random.PRNGKey(1))))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(IMAGES), jnp.asarray(SIZES),
        tuple(map(jnp.asarray, gt)))
    model = build_model(cfg, params, device="cpu")
    props = t_pn.proposal_network_inference(model, cfg, im, sz)
    losses = t_pn.proposal_network_losses(model, cfg, im, sz, GroundTruth(*map(torch.from_numpy, gt)),
                                          torch.Generator().manual_seed(0))
    return dict(jprops=[np.asarray(a) for a in jprops], props=[t.numpy() for t in props],
                jlosses={k: float(v) for k, v in jlosses.items()},
                losses={k: float(v) for k, v in losses.items()})


def test_proposal_network_inference_matches_jax(pn_run):
    (jb, js, jv), (tb, ts, tv) = pn_run["jprops"], pn_run["props"]
    assert tb.shape == (2, 24, 4)
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() >= 30
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb, jb, rtol=1e-4, atol=2e-3)


def test_proposal_network_losses_match_jax(pn_run):
    got, want = pn_run["losses"], pn_run["jlosses"]
    assert set(got) == set(want) == {"loss_rpn_cls", "loss_rpn_loc"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", ["res2-res5 with p6", "res3-res5 without p6"])
def test_fpn_arguments_match_jax(case):
    """``apply_fpn``'s ``in_features`` and ``top_block_maxpool`` against JAX's
    on the same maps: RetinaNet's res3..res5 without the max-pool top block
    (outputs named from p2), and the FPN path's default, p2..p6."""
    names = ("res2", "res3", "res4", "res5") if case.startswith("res2") else ("res3", "res4", "res5")
    chans = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}
    rng = np.random.RandomState(5)
    bottom = {n: rng.randn(1, 32 >> i, 40 >> i, chans[n]).astype(np.float32)
              for i, n in enumerate(("res2", "res3", "res4", "res5"))}
    params = init_fpn(np.random.default_rng(6), [chans[n] for n in names], 64)
    for layer in params["lateral"] + params["output"]:
        layer["b"] = rng.randn(*layer["b"].shape).astype(np.float32)
    maxpool = case.endswith("with p6")
    want = jax_apply_fpn(jax.tree_util.tree_map(jnp.asarray, params),
                         {k: jnp.asarray(v) for k, v in bottom.items()}, in_features=names,
                         top_block_maxpool=maxpool)
    fpn = FPN([chans[n] for n in names], 64)
    fpn.load_state_dict(state_dict_from_jax(params))
    got = apply_fpn(fpn, {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in bottom.items()},
                    in_features=names, top_block_maxpool=maxpool)
    assert sorted(got) == sorted(want) == [f"p{i + 2}" for i in range(len(names) + maxpool)]
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_jax_retinanet_pytree_loads_into_the_port():
    """JAX's ``init_retinanet`` tree (the focal prior bias included) loads
    into ``RetinaNet`` with strict names and shapes, has the port init's
    structure and bias, and comes back leaf for leaf."""
    from proben_tpu_torch.checkpoint import state_dict_to_jax

    cfg, jcfg = t_retina.RetinaNetConfig(**RETINA), JaxRetinaNetConfig(**RETINA)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_retinanet(jax.random.PRNGKey(0), jcfg))
    model = t_retina.build_retinanet(cfg, tree, device="cpu")
    port = t_retina.init_retinanet(0, cfg)
    assert jax.tree_util.tree_structure(port) == jax.tree_util.tree_structure(tree)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(tree)))
    np.testing.assert_allclose(port["head"]["cls_score"]["b"], tree["head"]["cls_score"]["b"], rtol=1e-6)
    back = state_dict_to_jax(model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
