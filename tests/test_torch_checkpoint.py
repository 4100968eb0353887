"""The port's checkpoint modules (``proben_tpu_torch/checkpoint/``) against
``proben_tpu.checkpoint`` on the CPU.

* ``fold_batchnorm`` equals JAX's bit for bit (both fold in float64 and
  round once).
* Synthetic detectron2 checkpoints (``tests/test_checkpoint.py``'s recipe:
  every key of a full R-CNN under its detectron2 name, random values) for
  R50 BGR and BGRTTT with the variance head, written as ``.pth``
  (``torch.save``, ``module.``-prefixed, wrapped in ``{"model": ...}``) and
  as ``.pkl`` (a pickle of numpy arrays), imported by both packages with
  the same template (JAX's ``init_rcnn``, as numpy): the trees are equal
  leaf for leaf, dtype and bits.
* The c2 renaming, the backbone-only prefix, ``strict=False`` keeping the
  template, and a shape mismatch raising under ``strict``, in both.
* The imported box head on pooled features equals ``torch.nn.Linear`` on
  torch's NCHW flatten to 1e-5 (fc1's permutation applied exactly once).
* URL resolution: cache, zoo mirror, the offline miss (with
  ``urllib.request.urlretrieve`` patched to raise: nothing reaches the
  network), local paths.
* ``CheckpointManager``: the same calls give the same ``last.json`` fields,
  kept count and best metric as JAX's orbax manager.
* Resume: two uninterrupted training steps equal, bit for bit, one step,
  save, restore into a fresh model and optimizer, one more step.
"""

import json
import os
import pickle
import urllib.request

import jax
import numpy as np
import pytest
import torch

from chip_smoke import flat_tree
from proben_tpu import checkpoint as jax_ckpt
from proben_tpu.models import build_config as jax_build_config
from proben_tpu.models import init_rcnn as jax_init_rcnn
from proben_tpu.models.layers import fold_batchnorm as jax_fold_batchnorm
from proben_tpu_torch import checkpoint as ckpt
from proben_tpu_torch.checkpoint import state_dict_from_jax
from proben_tpu_torch.engine import make_train_step, trainable_mask
from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines
from proben_tpu_torch.models.box_head import BoxHead, apply_box_head
from proben_tpu_torch.models.layers import fold_batchnorm
from proben_tpu_torch.models.roi_heads import ROIHeadsConfig
from proben_tpu_torch.models.rpn import RPNConfig
from proben_tpu_torch.solver import SolverConfig
from proben_tpu_torch.structures import GroundTruth
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)


def assert_trees_equal(got, want):
    """Same structure, and every leaf the same dtype and bits."""
    g, w = flat_tree(got), flat_tree(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))[:5]
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (k, g[k].dtype, w[k].dtype)
        assert np.array_equal(g[k], w[k]), k


def test_fold_batchnorm_matches_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    for dtype in (np.float32, np.float64):
        w, b, m = (rng.randn(257).astype(dtype) for _ in range(3))
        v = (rng.rand(257) * 3 + 1e-3).astype(dtype)
        got = fold_batchnorm(w, b, m, v)
        want = jax_fold_batchnorm(w, b, m, v)
        assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, want))
        assert got["scale"].dtype == got["bias"].dtype == np.float32


# ---------------------------------------------------------------------------
# detectron2 state dicts
# ---------------------------------------------------------------------------


def _synth_d2_state_dict(template, rng):
    """A random detectron2 state dict of ``template``'s model under the
    documented detectron2 key names (``tests/test_checkpoint.py``'s recipe)."""
    sd = {}

    def conv_entry(key, p):
        h, w, ci, co = p["w"].shape
        sd[f"{key}.weight"] = rng.randn(co, ci, h, w).astype(np.float32)
        if "b" in p:
            sd[f"{key}.bias"] = rng.randn(co).astype(np.float32)

    def norm_entry(key, p):
        c = p["scale"].shape[0]
        sd[f"{key}.weight"] = rng.rand(c).astype(np.float32) + 0.5
        sd[f"{key}.bias"] = rng.randn(c).astype(np.float32)
        sd[f"{key}.running_mean"] = rng.randn(c).astype(np.float32)
        sd[f"{key}.running_var"] = rng.rand(c).astype(np.float32) + 0.5

    def backbone(prefix, bb):
        conv_entry(f"{prefix}.stem.conv1", bb["stem"]["conv1"])
        norm_entry(f"{prefix}.stem.conv1.norm", bb["stem"]["norm1"])
        for stage in ("res2", "res3", "res4", "res5"):
            for b, blk in enumerate(bb[stage]):
                base = f"{prefix}.{stage}.{b}"
                for ci in (1, 2, 3):
                    conv_entry(f"{base}.conv{ci}", blk[f"conv{ci}"])
                    norm_entry(f"{base}.conv{ci}.norm", blk[f"norm{ci}"])
                if "shortcut" in blk:
                    conv_entry(f"{base}.shortcut", blk["shortcut"])
                    norm_entry(f"{base}.shortcut.norm", blk["shortcut_norm"])

    def fpn(prefix, f):
        for i, lat in enumerate(f["lateral"]):
            conv_entry(f"{prefix}.fpn_lateral{i + 2}", lat)
        for i, o in enumerate(f["output"]):
            conv_entry(f"{prefix}.fpn_output{i + 2}", o)

    def lin_entry(key, p):
        ci, co = p["w"].shape
        sd[f"{key}.weight"] = rng.randn(co, ci).astype(np.float32) * 0.02
        sd[f"{key}.bias"] = rng.randn(co).astype(np.float32)

    backbone("backbone.bottom_up", template["backbone"])
    fpn("backbone", template["fpn"])
    if "backbone_2" in template:
        backbone("backbone_2.bottom_up", template["backbone_2"])
        fpn("backbone_2", template["fpn_2"])
    conv_entry("proposal_generator.rpn_head.conv", template["rpn_head"]["conv"])
    conv_entry("proposal_generator.rpn_head.objectness_logits", template["rpn_head"]["objectness"])
    conv_entry("proposal_generator.rpn_head.anchor_deltas", template["rpn_head"]["deltas"])
    for i, fc in enumerate(template["roi"]["box_head"]["fcs"]):
        lin_entry(f"roi_heads.box_head.fc{i + 1}", fc)
    for name in ("cls_score", "bbox_pred", "var_pred"):
        if name in template["roi"]["output"]:
            lin_entry(f"roi_heads.box_predictor.{name}", template["roi"]["output"][name])
    return sd


def _template(fmt, num_classes=3):
    """JAX's parameter tree of the config: the structure, shapes and dtypes
    of its init (``jax.eval_shape``, which draws nothing: the eager threefry
    init of an R50 costs ~15 s on an 8-core CPU), filled with seeded normal numbers."""
    cfg = jax_build_config(depth=50, input_format=fmt, enable_gaussian_nll=True, num_classes=num_classes)
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape, dtype=np.float32).astype(s.dtype),
                                  jax.eval_shape(lambda: jax_init_rcnn(jax.random.PRNGKey(0), cfg)))


@pytest.fixture(scope="module", params=["BGR", "BGRTTT"])
def d2(request, tmp_path_factory):
    """The template, the state dict, and the two files holding it."""
    fmt = request.param
    template = _template(fmt)
    sd = _synth_d2_state_dict(template, np.random.RandomState(1))
    root = tmp_path_factory.mktemp(f"d2_{fmt}")
    pth, pkl = str(root / "model_final.pth"), str(root / "model_final.pkl")
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, "iteration": 7}, pth)
    with open(pkl, "wb") as f:
        pickle.dump({"model": sd, "__author__": "synthetic"}, f)
    return dict(fmt=fmt, template=template, sd=sd, pth=pth, pkl=pkl)


def _both(src, template, **kw):
    got = ckpt.import_detectron2_checkpoint(src, template, **kw)
    want = jax.tree_util.tree_map(np.asarray, jax_ckpt.import_detectron2_checkpoint(src, template, **kw))
    assert_trees_equal(got, want)
    return got


@pytest.mark.parametrize("kind", ["pth", "pkl", "dict"])
def test_import_matches_jax(d2, kind):
    """Both packages, same file and template: equal trees; the file's
    leaves are in it (not the template's) and the .pth and .pkl agree."""
    src = d2["sd"] if kind == "dict" else d2[kind]
    got = _both(src, d2["template"], strict=True)
    np.testing.assert_array_equal(
        got["backbone"]["res3"][0]["conv2"]["w"],
        np.transpose(d2["sd"]["backbone.bottom_up.res3.0.conv2.weight"], (2, 3, 1, 0)))
    np.testing.assert_array_equal(got["roi"]["output"]["var_pred"]["w"],
                                  d2["sd"]["roi_heads.box_predictor.var_pred.weight"].T)
    assert_trees_equal(ckpt.import_detectron2_checkpoint(d2["pkl"], d2["template"]), got)
    if d2["fmt"] == "BGRTTT":
        assert not np.array_equal(got["backbone_2"]["stem"]["conv1"]["w"], got["backbone"]["stem"]["conv1"]["w"])


def test_load_state_dict_matches_jax(d2):
    for path in (d2["pth"], d2["pkl"]):
        got, want = ckpt.load_state_dict(path), jax_ckpt.load_state_dict(path)
        assert got.keys() == want.keys() == d2["sd"].keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_imported_box_head_equals_torch_linear_on_nchw_flatten(d2):
    """fc1 takes the (P, P, C) flatten: the imported head on pooled
    features in that order equals detectron2's head (``nn.Linear`` on the
    NCHW flatten), so the permutation is applied once, not zero or two
    times."""
    params = ckpt.import_detectron2_checkpoint(d2["pth"], d2["template"])
    in_dim = d2["sd"]["roi_heads.box_head.fc1.weight"].shape[1]
    c = in_dim // 49
    head = BoxHead(c, 7)
    head.load_state_dict(state_dict_from_jax(params["roi"]["box_head"]))
    ref = torch.nn.Sequential(torch.nn.Linear(in_dim, 1024), torch.nn.ReLU(), torch.nn.Linear(1024, 1024),
                              torch.nn.ReLU())
    with torch.no_grad():
        for i, name in ((0, "fc1"), (2, "fc2")):
            ref[i].weight.copy_(torch.from_numpy(d2["sd"][f"roi_heads.box_head.{name}.weight"]))
            ref[i].bias.copy_(torch.from_numpy(d2["sd"][f"roi_heads.box_head.{name}.bias"]))
        pooled = torch.from_numpy(np.random.RandomState(3).randn(5, c, 7, 7).astype(np.float32))
        want = ref(pooled.flatten(1))
        got = apply_box_head(head, pooled.permute(0, 2, 3, 1))
    assert float(want.abs().max()) > 0.1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    perm = ckpt.fc1_nchw_to_nhwc_perm(in_dim, 7)
    np.testing.assert_array_equal(perm, jax_ckpt.fc1_nchw_to_nhwc_perm(in_dim, 7))


def _c2_backbone(template, rng):
    """A caffe2 ImageNet backbone pkl's keys (no running statistics)."""
    sd = {"conv1_w": rng.randn(64, 3, 7, 7).astype(np.float32),
          "res_conv1_bn_s": rng.rand(64).astype(np.float32) + 0.5,
          "res_conv1_bn_b": rng.randn(64).astype(np.float32)}
    for stage in ("res2", "res3", "res4", "res5"):
        for b, blk in enumerate(template["backbone"][stage]):
            for conv, branch in (("conv1", "2a"), ("conv2", "2b"), ("conv3", "2c"), ("shortcut", "1")):
                if conv not in blk:
                    continue
                h, w, ci, co = blk[conv]["w"].shape
                key = f"{stage}_{b}_branch{branch}"
                sd[f"{key}_w"] = rng.randn(co, ci, h, w).astype(np.float32)
                sd[f"{key}_bn_s"] = rng.rand(co).astype(np.float32) + 0.5
                sd[f"{key}_bn_b"] = rng.randn(co).astype(np.float32)
    return sd


def test_caffe2_names_and_backbone_only_files_match_jax(tmp_path):
    """A c2 ImageNet pkl and a backbone-only d2 file (bare ``stem.``/
    ``resN.`` keys): the backbone is imported, the rest of the model is the
    template's, in both packages alike."""
    template = _template("BGR")
    c2 = _c2_backbone(template, np.random.RandomState(2))
    got_names, want_names = ckpt.convert_caffe2_names(c2), jax_ckpt.convert_caffe2_names(c2)
    assert got_names.keys() == want_names.keys()
    assert all(np.array_equal(got_names[k], want_names[k]) for k in want_names)
    assert "backbone.bottom_up.res2.0.shortcut.norm.running_var" in got_names
    path = str(tmp_path / "R-50.pkl")
    with open(path, "wb") as f:
        pickle.dump(c2, f)
    got = _both(path, template, strict=False)
    for part in ("fpn", "rpn_head", "roi"):
        assert_trees_equal(got[part], template[part])
    np.testing.assert_array_equal(got["backbone"]["stem"]["conv1"]["w"], np.transpose(c2["conv1_w"], (2, 3, 1, 0)))
    with pytest.raises(KeyError):
        ckpt.import_detectron2_checkpoint(path, template, strict=True)

    full = _synth_d2_state_dict(template, np.random.RandomState(4))
    bare = {k[len("backbone.bottom_up."):]: v for k, v in full.items() if k.startswith("backbone.bottom_up.")}
    got = _both(bare, template, strict=False)
    assert_trees_equal(got["backbone"], ckpt.import_detectron2_checkpoint(full, template)["backbone"])
    assert_trees_equal(got["roi"], template["roi"])


def test_partial_files_keep_the_template_unless_strict():
    template = _template("BGR")
    sd = _synth_d2_state_dict(template, np.random.RandomState(5))
    partial = {k: v for k, v in sd.items() if not k.startswith("proposal_generator.")
               and "var_pred" not in k}
    got = _both(partial, template, strict=False)
    assert_trees_equal(got["rpn_head"], template["rpn_head"])
    assert_trees_equal(got["roi"]["output"]["var_pred"], template["roi"]["output"]["var_pred"])
    assert not np.array_equal(got["roi"]["output"]["cls_score"]["w"], template["roi"]["output"]["cls_score"]["w"])
    for mod in (ckpt, jax_ckpt):
        with pytest.raises(KeyError, match="rpn_head"):
            mod.import_detectron2_checkpoint(partial, template, strict=True)


def test_shape_mismatch_raises_under_strict():
    """A 3-class file into a 1-class (KAIST) model: ``strict`` raises in
    both; without it both keep the file's leaves alike."""
    sd = _synth_d2_state_dict(_template("BGR", 3), np.random.RandomState(6))
    template = _template("BGR", 1)
    for mod in (ckpt, jax_ckpt):
        with pytest.raises(ValueError, match="shape mismatch"):
            mod.import_detectron2_checkpoint(sd, template, strict=True)
    got = _both(sd, template, strict=False)
    assert got["roi"]["output"]["cls_score"]["w"].shape == (1024, 4)


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------


def test_url_resolution_matches_jax(tmp_path, monkeypatch):
    """``tests/test_checkpoint.py``'s cases in both packages, offline."""
    def offline(url, filename=None, *a, **k):
        raise OSError(f"no network in this test: {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", offline)
    for name in ("ImageNetPretrained/MSRA/R-50.pkl", "ImageNetPretrained/MSRA/R-101",
                 "Caffe2Detectron/COCO/35857345/e2e_faster_rcnn_R-50-FPN_1x"):
        assert ckpt.catalog_entry_url(name) == jax_ckpt.catalog_entry_url(name)
    for mod in (ckpt, jax_ckpt):
        with pytest.raises(RuntimeError, match="not present"):
            mod.catalog_entry_url("ImageNetPretrained/MSRA/R-18")

    cache, zoo = tmp_path / "cache", tmp_path / "zoo"
    zoo.mkdir()
    monkeypatch.setenv("PROBEN_CACHE_DIR", str(cache))
    monkeypatch.setenv("PROBEN_ZOO_DIR", str(zoo))
    from proben_tpu.checkpoint.paths import default_cache_dir as jax_default_cache_dir
    from proben_tpu_torch.checkpoint.paths import default_cache_dir

    assert default_cache_dir() == jax_default_cache_dir() == str(cache)
    target = cache / "detectron2" / "COCO-Detection" / "x" / "model_final_1.pkl"
    target.parent.mkdir(parents=True)
    target.write_bytes(b"hi")
    (zoo / "R-50.pkl").write_bytes(b"zoo")
    (zoo / "model_final.pkl").write_bytes(b"ambiguous")
    c2_coco = "catalog://Caffe2Detectron/COCO/35857345/e2e_faster_rcnn_R-50-FPN_1x"

    def resolve(path):
        out = []
        for mod in (ckpt, jax_ckpt):
            try:
                out.append(mod.resolve_checkpoint_path(path))
            except FileNotFoundError as e:
                out.append(("missing", str(e)))
        assert out[0] == out[1], out
        return out[0]

    assert resolve("detectron2://COCO-Detection/x/model_final_1.pkl") == str(target)
    assert resolve("catalog://ImageNetPretrained/MSRA/R-50.pkl") == str(zoo / "R-50.pkl")
    assert resolve(c2_coco)[0] == "missing"  # a generic model_final.pkl never resolves by basename
    (zoo / "generalized_rcnn__model_final.pkl").write_bytes(b"specific")
    assert resolve(c2_coco) == str(zoo / "generalized_rcnn__model_final.pkl")
    flat = "detectron2__COCO-Detection__y__model_final_2.pkl"
    (zoo / flat).write_bytes(b"flat")
    assert resolve("detectron2://COCO-Detection/y/model_final_2.pkl") == str(zoo / flat)
    missing = resolve("https://example.invalid/models/missing.pth")
    assert missing[0] == "missing" and "PROBEN_ZOO_DIR" in missing[1]
    assert resolve("/some/local/file.pth") == "/some/local/file.pth"
    with pytest.raises(FileNotFoundError, match="PROBEN_ZOO_DIR"):
        ckpt.load_state_dict("detectron2://COCO-Detection/missing/model.pkl")


# ---------------------------------------------------------------------------
# CheckpointManager, save/restore, resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("higher", [True, False], ids=["higher_is_better", "lower_is_better"])
def test_checkpoint_manager_matches_jax(tmp_path, higher):
    import jax.numpy as jnp

    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "nested": [np.ones(2, np.float32)]}
    calls = [(100, 0.5), (200, 0.7), (300, 0.6), (400, 0.7), (500, 0.3), (600, float("nan"))]
    seen = {}
    for name, mod, tree in (("port", ckpt, params),
                            ("jax", jax_ckpt, jax.tree_util.tree_map(jnp.asarray, params))):
        root = tmp_path / name
        mgr = mod.CheckpointManager(str(root), max_to_keep=2, higher_is_better=higher)
        better = []
        for step, metric in calls:
            mgr.save(step, {"params": tree, "step": step})
            better.append(mgr.save_best(step, metric, tree))
        with open(root / "last.json") as f:
            meta = json.load(f)
        reopened = mod.CheckpointManager(str(root), max_to_keep=2, higher_is_better=higher)
        seen[name] = dict(
            better=better, best=mgr.best_metric, reopened_best=reopened.best_metric,
            step=meta["step"], best_step=meta["best_step"], best_metric=meta["best_metric"],
            kept=[os.path.relpath(p, root) for p in meta["kept"]], last=os.path.relpath(meta["last"], root),
            latest=mgr.latest_step(), dirs=sorted(os.listdir(root)), keys=sorted(meta))
    assert seen["port"] == seen["jax"], seen
    assert seen["port"]["kept"] == ["iter_0000500", "iter_0000600"]
    mgr = ckpt.CheckpointManager(str(tmp_path / "port"))
    restored = mgr.restore_latest({"params": {"w": np.zeros((2, 3), np.float32), "nested": [np.zeros(2, np.float32)]},
                                   "step": 0})
    assert restored["step"] == 600 and isinstance(restored["step"], int)
    assert_trees_equal(restored["params"], params)
    assert_trees_equal(mgr.restore_best({"w": np.zeros((2, 3), np.float32), "nested": [np.zeros(2, np.float32)]}),
                       params)


def test_save_restore_pytree_kinds_and_errors(tmp_path):
    tree = {"a": np.arange(5, dtype=np.int64), "t": torch.arange(4, dtype=torch.bfloat16),
            "l": [np.float32(2.5), 3, "x", None], "tu": (np.zeros((2, 2), np.float16),)}
    path = str(tmp_path / "c")
    ckpt.save_pytree(path, tree)
    ckpt.save_pytree(path, tree)  # replaces
    got = ckpt.restore_pytree(path, tree)
    assert got["a"].dtype == np.int64 and np.array_equal(got["a"], tree["a"])
    assert got["t"].dtype == torch.bfloat16 and torch.equal(got["t"], tree["t"])
    assert got["l"][1:] == [3, "x", None] and got["l"][0] == 2.5 and isinstance(got["tu"], tuple)
    assert set(ckpt.restore_pytree(path)) == set(tree)
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore_pytree(path, {"a": tree["a"]})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_pytree(path, {**tree, "a": np.zeros(6, np.int64)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore_pytree(str(tmp_path / "none"), tree)
    # a JAX orbax directory: not readable here, and the error says why
    orbax_dir = str(tmp_path / "orbax")
    jax_ckpt.save_pytree(orbax_dir, {"a": np.arange(3.0)})
    with pytest.raises(ValueError, match="orbax"):
        ckpt.restore_pytree(orbax_dir, {"a": np.zeros(3)})


H, W = 96, 128


def _train_setup(seed_params):
    # small proposal and sample counts: what is held (a resumed step equals
    # the uninterrupted one bit for bit) does not depend on them
    cfg = build_config(depth=50, num_classes=3, enable_gaussian_nll=True,
                       rpn=RPNConfig(pre_nms_topk_train=256, post_nms_topk_train=128),
                       roi=ROIHeadsConfig(num_classes=3, batch_size_per_image=128))
    model = build_model(cfg, params=random_affines(init_rcnn(seed_params, cfg), seed_params), device="cpu")
    solver = SolverConfig(base_lr=0.01, warmup_iters=4, warmup_factor=0.1)
    init, step = make_train_step(cfg, solver, trainable_mask(model, cfg.freeze_at))
    return model, init, step


def _batch(seed):
    rng = np.random.RandomState(seed)
    images = (rng.rand(2, H, W, 3) * 255).astype(np.float32)
    xy = rng.rand(2, 4, 2) * 60
    boxes = np.concatenate([xy, xy + rng.rand(2, 4, 2) * 30 + 10], -1).astype(np.float32)
    gt = GroundTruth(torch.from_numpy(boxes), torch.from_numpy(rng.randint(0, 3, (2, 4)).astype(np.int32)),
                     torch.ones(2, 4, dtype=torch.bool))
    return {"image": torch.from_numpy(images), "image_size": torch.tensor([[H, W], [90, 120]], dtype=torch.int32),
            "gt": gt}


def test_resume_equals_uninterrupted_training(tmp_path):
    """Two steps from one state, against one step, a checkpoint of
    (parameters, momentum, step, seed) through ``CheckpointManager``, a
    restore into a fresh model (another init) and optimizer, and the second
    step: parameters and momentum equal bit for bit, and the step count.
    The warm-up makes the learning rate depend on the restored step."""
    batches = [_batch(0), _batch(1)]
    model, init, step = _train_setup(0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state = init(model, 3)
    for b in batches:
        state, metrics = step(state, b)
    assert float(metrics["loss_finite"]) == 1.0

    model_b, init_b, step_b = _train_setup(0)
    state_b, _ = step_b(init_b(model_b, 3), batches[0])
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"), max_to_keep=1)
    mgr.save(state_b.step, ckpt.train_state_tree(state_b))
    del model_b, state_b
    fresh_model, fresh_init, fresh_step = _train_setup(1)
    fresh = fresh_init(fresh_model, 0)
    resumed = ckpt.load_train_state(mgr.restore_latest(ckpt.train_state_tree(fresh)), fresh)
    assert (resumed.step, resumed.seed, mgr.latest_step()) == (1, 3, 1)
    resumed, _ = fresh_step(resumed, batches[1])
    assert resumed.step == state.step == 2

    got, want = fresh_model.state_dict(), model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert sum(not torch.equal(want[k], start[k]) for k in want) > 0
    assert resumed.momentum.keys() == state.momentum.keys()
    for k in state.momentum:
        assert torch.equal(resumed.momentum[k], state.momentum[k]), k
    assert any(bool(v.any()) for v in state.momentum.values())
