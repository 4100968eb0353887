"""``proben_tpu_torch.export`` and ``model_zoo`` against ``proben_tpu``'s,
and the custom ops that make the detector exportable, on the CPU.

- JAX's toy export contract (tests/test_misc_components.py's ``tanh(x @
  w)``) through both packages' ``export_model``/``load_exported``: the same
  outputs to 1e-6 (f32 products in other orders) and the same
  ``example_args.pkl`` tree. This is the file's only JAX compile.
- A tiny R50-FPN detector in bf16 (narrow FPN) exported and saved, then
  loaded in a fresh interpreter that imports only ``proben_tpu_torch.export``:
  its detections equal the eager port's bit for bit (the same aten ops on
  the same inputs), and its graph holds ``proben::stem_pool``,
  ``proben::roi_align_fwd``, ``proben::block_epilogue`` (each bottleneck's
  three conv epilogues) and ``proben::nms_keep``. RoIAlign with
  out-of-window boxes exported alone: both branches of the fallback's
  ``torch.cond`` equal eager bit for bit.
- ``torch.library.opcheck`` on each op's CPU implementation (schema, fake,
  autograd registration, dispatch), the plain RoIAlign ops' included.
- The NMS op against the fixpoint loop it replaced and against JAX's
  ``nms_mask`` on suppression chains, ties and NaN scores.
- ``model_zoo`` as tests/test_misc_components.py's ``test_model_zoo_config``,
  and ``get`` from a small detectron2 ``.pkl`` in a temporary
  ``PROBEN_ZOO_DIR``.
"""

import functools
import json
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.export import export_model as jax_export_model
from proben_tpu.export import load_exported as jax_load_exported
from proben_tpu.ops.nms import nms_mask as jax_nms_mask
from proben_tpu_torch import model_zoo
from proben_tpu_torch.checkpoint import state_dict_to_jax
from proben_tpu_torch.export import export_model, load_exported
from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines
from proben_tpu_torch.models import rcnn as t_rcnn
from proben_tpu_torch.models.rpn import RPNConfig
from proben_tpu_torch.ops import nms, roi_align_cuda
from proben_tpu_torch.structures.boxes import pairwise_iou
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

STRIDES = (4, 8, 16, 32)
FLIR_YAML = "FLIR-Detection/faster_rcnn_R_101_FLIR.yaml"


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _proben_ops(graph):
    return sorted({str(n.target) for n in graph.nodes if str(n.target).startswith("proben.")})


def test_toy_export_roundtrip_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 8).astype(np.float32)
    w = (rng.randn(8, 2) * 0.3).astype(np.float32)
    jax_dir, torch_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_export_model(lambda x, w: jnp.tanh(x @ w), (jnp.asarray(x), jnp.asarray(w)), jax_dir)
    want = np.asarray(jax_load_exported(jax_dir)(jnp.asarray(x), jnp.asarray(w)))
    path = export_model(lambda x, w: torch.tanh(x @ w), (T(x), T(w)), torch_dir)
    assert path == os.path.join(torch_dir, "model.pt2") and os.path.exists(path)
    got = load_exported(torch_dir)(T(x), T(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    trees = []
    for d in (jax_dir, torch_dir):
        with open(os.path.join(d, "example_args.pkl"), "rb") as f:
            trees.append(pickle.load(f))
    assert trees[0] == trees[1] == (((4, 8), "float32"), ((8, 2), "float32"))


_LOAD_ALONE = """
import json, sys
import torch
from proben_tpu_torch.export import load_exported
out_dir = sys.argv[1]
torch.set_num_threads(int(sys.argv[2]))  # eager's, so that both sum in one order
loaded = load_exported(out_dir)
images, sizes = torch.load(out_dir + "/inputs.pt")
with torch.no_grad():
    det = loaded(images, sizes)
torch.save({k: v for k, v in vars(det).items() if v is not None}, out_dir + "/outputs.pt")
print(json.dumps({"ops": sorted({str(n.target) for n in loaded.graph.nodes
                                 if str(n.target).startswith("proben.")}),
                  "modules": sorted(m for m in sys.modules if m.startswith("proben_tpu_torch."))}))
"""


def test_tiny_detector_exports_with_its_ops_and_equals_eager(tmp_path):
    """Exported here, loaded in a fresh interpreter that imports only
    ``proben_tpu_torch.export`` (no model-building code, JAX's contract)."""
    cfg = build_config(depth=50, compute_dtype="bfloat16", fpn_channels=32,
                       rpn=RPNConfig(pre_nms_topk_test=200, post_nms_topk_test=50))
    model = build_model(cfg, params=random_affines(init_rcnn(0, cfg), 0), device="cpu").eval()
    rng = np.random.RandomState(1)
    images = T(rng.rand(2, 64, 96, 3).astype(np.float32) * 255)
    sizes = torch.tensor([[64, 96], [60, 90]], dtype=torch.int32)
    with torch.no_grad():
        path = export_model(functools.partial(t_rcnn.rcnn_inference, model, cfg), (images, sizes),
                            str(tmp_path))
        want = t_rcnn.rcnn_inference(model, cfg, images, sizes)
    torch.save((images, sizes), tmp_path / "inputs.pt")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    out = subprocess.run([sys.executable, "-c", _LOAD_ALONE, str(tmp_path), str(torch.get_num_threads())],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    got = torch.load(tmp_path / "outputs.pt")
    for name in ("boxes", "scores", "classes", "valid", "probs", "class_logits"):
        assert torch.equal(got[name], getattr(want, name)), name
    assert int(want.valid.sum()) > 0
    ops = ["proben.block_epilogue.default", "proben.nms_keep.default", "proben.roi_align_fwd.default",
           "proben.stem_pool.default"]
    assert _proben_ops(torch.export.load(path).graph) == ops
    assert report["ops"] == ops
    assert not [m for m in report["modules"] if m.startswith("proben_tpu_torch.models")], report


def test_exported_roi_align_takes_the_fallback_as_eager(tmp_path):
    """Out-of-window RoIs (a box wider than the 64-column window, one past
    the map's corner) go through the whole-map fallback inside the exported
    program's ``torch.cond``; boxes inside their windows take the other
    branch. Both equal eager bit for bit."""
    rng = np.random.RandomState(2)
    feats = [T(rng.randn(2, 96 >> i, 120 >> i, 8).astype(np.float32)) for i in range(4)]
    inside = np.array([[[10.0, 12.0, 60.0, 50.0], [30.0, 20.0, 90.0, 70.0], [5.0, 5.0, 20.0, 30.0]]] * 2,
                      np.float32)
    outside = inside.copy()
    outside[0, 1] = [0.0, 40.0, 470.0, 52.0]  # 470 px wide on p2: past the window
    outside[1, 2] = [400.0, 300.0, 480.0, 384.0]

    def pool(f0, f1, f2, f3, boxes):
        return roi_align_cuda.multilevel_roi_align([f0, f1, f2, f3], boxes, STRIDES)

    lvl, *_, oow = roi_align_cuda.window_inputs(feats, T(outside), STRIDES)
    assert bool(oow.any())
    assert not bool(roi_align_cuda.window_inputs(feats, T(inside), STRIDES)[-1].any())
    with torch.no_grad():
        export_model(pool, (*feats, T(outside)), str(tmp_path))
        loaded = load_exported(str(tmp_path))
        for boxes in (outside, inside):
            assert torch.equal(loaded(*feats, T(boxes)), pool(*feats, T(boxes)))
    assert any("cond" in str(n.target) for n in loaded.graph.nodes)


def _stem_args(rng):
    x = T(rng.randn(1, 20, 28, 3).astype(np.float32) * 50).to(torch.bfloat16)
    w = T(rng.randn(7, 7, 3, 64).astype(np.float32) * 0.03).to(torch.bfloat16)
    scale = T(1 + 0.3 * rng.randn(64).astype(np.float32)).to(torch.bfloat16)
    bias = T(0.3 * rng.randn(64).astype(np.float32)).to(torch.bfloat16)
    return x, w.requires_grad_(), scale.requires_grad_(), bias


def test_opcheck_on_each_op():
    rng = np.random.RandomState(3)
    torch.library.opcheck(torch.ops.proben.stem_pool.default, _stem_args(rng))

    feats = [T(rng.randn(2, 32 >> i, 40 >> i, 8).astype(np.float32)).requires_grad_() for i in range(4)]
    boxes = T(np.array([[[2.0, 3.0, 40.0, 30.0], [0.0, 0.0, 100.0, 90.0]]] * 2, np.float32))
    lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(feats, boxes, STRIDES)
    torch.library.opcheck(torch.ops.proben.roi_align_fwd.default, (feats, lvl, y0, x0, wy, wx, 2))
    g = T(rng.randn(4, 7, 7, 8).astype(np.float32))
    shapes = [d for f in feats for d in f.shape]
    torch.library.opcheck(torch.ops.proben.roi_align_bwd.default, (g, shapes, lvl, y0, x0, wy, wx, 2))
    torch.library.opcheck(torch.ops.proben.roi_align_fwd_plain.default, (feats, lvl, y0, x0, wy, wx, 2))
    torch.library.opcheck(torch.ops.proben.roi_align_bwd_plain.default, (g, shapes, lvl, y0, x0, wy, wx, 2))

    b = T(_chain(12, 0.4))
    suppress = (pairwise_iou(b, b) > 0.3) & torch.ones(12, 12, dtype=torch.bool).triu(1)
    torch.library.opcheck(torch.ops.proben.nms_fixpoint.default, (suppress, torch.ones(12, dtype=torch.bool)))


def _chain(n, step):
    """Boxes each overlapping the next by IoU > 0.3 (and no other): one
    suppression chain of length ``n``."""
    x = np.arange(n, dtype=np.float32) * 10 * step
    return np.stack([x, np.zeros(n, np.float32), x + 10, np.full(n, 10, np.float32)], -1)


def _fixpoint_loop(boxes, scores, valid, thresh):
    """The NMS fixpoint as ``ops/nms.py`` ran it before the op (the loop
    inline), for one image."""
    masked = torch.where(valid, scores, -1e10)
    masked = torch.where(torch.isnan(masked), float("-inf"), masked)
    _, order = torch.sort(masked, descending=True, stable=True)
    sb, sv = boxes[order], valid[order]
    n = boxes.shape[0]
    suppress = ((pairwise_iou(sb, sb) > thresh) & torch.ones(n, n, dtype=torch.bool).triu(1)
                & sv[:, None] & sv[None, :]).float()
    keep = sv
    for _ in range(n):
        new = sv & ~((keep.float() @ suppress) > 0.5)
        if torch.equal(new, keep):
            break
        keep = new
    return torch.zeros_like(valid).scatter(-1, order, keep)


@pytest.mark.parametrize("case", ["chain", "chain_reversed", "nan_scores", "ties", "random"])
def test_nms_op_matches_the_loop_and_jax(case):
    rng = np.random.RandomState(4)
    n = 40
    boxes = _chain(n, 0.4)
    scores = np.linspace(1.0, 0.1, n).astype(np.float32)
    valid = np.ones(n, bool)
    if case == "chain_reversed":
        scores = scores[::-1].copy()
    elif case == "nan_scores":
        scores[rng.choice(n, 6, replace=False)] = np.nan
        valid[[3, 17]] = False
    elif case == "ties":
        scores = np.round(scores * 4) / 4
    elif case == "random":
        xy = rng.rand(n, 2).astype(np.float32) * 60
        boxes = np.concatenate([xy, xy + 10 + rng.rand(n, 2).astype(np.float32) * 30], -1)
        scores = rng.rand(n).astype(np.float32)
    got = nms.nms_mask(T(boxes), T(scores), T(valid), 0.3)
    loop = _fixpoint_loop(T(boxes), T(scores), T(valid), 0.3)
    want = np.asarray(jax_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.3))
    assert torch.equal(got, loop)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "chain":  # greedy along the chain keeps every other box
        np.testing.assert_array_equal(got.numpy(), np.arange(n) % 2 == 0)


def test_model_zoo_config(monkeypatch):
    monkeypatch.delenv("PROBEN_ZOO_DIR", raising=False)
    cfg = model_zoo.get_config(FLIR_YAML)
    assert cfg.MODEL.RESNETS.DEPTH == 101
    assert model_zoo.get_checkpoint_path(FLIR_YAML) is None
    assert os.path.samefile(model_zoo.get_config_file(FLIR_YAML),
                            os.path.join(os.path.dirname(__file__), "..", "configs", FLIR_YAML))
    with pytest.raises(FileNotFoundError):
        model_zoo.get_config_file("COCO-Detection/no_such.yaml")


def test_model_zoo_get_loads_a_local_pkl(tmp_path, monkeypatch):
    """``get(trained=True)`` imports the zoo file found under
    ``PROBEN_ZOO_DIR`` (``strict=False``: the file holds only the RPN head
    here) into the port's ``RCNN``; the rest is the port's init;
    ``trained=False`` is the init alone."""
    rng = np.random.RandomState(5)
    sd = {}
    for key, shape in (("conv", (256, 256, 3, 3)), ("objectness_logits", (3, 256, 1, 1)),
                       ("anchor_deltas", (12, 256, 1, 1))):
        sd[f"proposal_generator.rpn_head.{key}.weight"] = (rng.randn(*shape) * 0.01).astype(np.float32)
        sd[f"proposal_generator.rpn_head.{key}.bias"] = rng.randn(shape[0]).astype(np.float32)
    name = model_zoo.CHECKPOINT_NAMES[FLIR_YAML]
    with open(tmp_path / name, "wb") as f:
        pickle.dump({"model": sd, "__author__": "test"}, f)
    monkeypatch.setenv("PROBEN_ZOO_DIR", str(tmp_path))
    assert model_zoo.get_checkpoint_path(FLIR_YAML) == str(tmp_path / name)
    assert model_zoo.get_config(FLIR_YAML, trained=True).MODEL.WEIGHTS == str(tmp_path / name)

    model, model_cfg = model_zoo.get(FLIR_YAML, trained=True, device="cpu")
    assert isinstance(model, torch.nn.Module) and model_cfg.depth == 101
    tree = state_dict_to_jax({k: v.detach() for k, v in model.state_dict().items()})
    head = tree["rpn_head"]
    np.testing.assert_array_equal(head["conv"]["w"],
                                  sd["proposal_generator.rpn_head.conv.weight"].transpose(2, 3, 1, 0))
    np.testing.assert_array_equal(head["deltas"]["b"], sd["proposal_generator.rpn_head.anchor_deltas.bias"])
    init = init_rcnn(0, model_cfg)
    np.testing.assert_array_equal(tree["roi"]["output"]["cls_score"]["w"],
                                  init["roi"]["output"]["cls_score"]["w"])
    plain, _ = model_zoo.get(FLIR_YAML, trained=False, device="cpu")
    assert torch.equal(plain.rpn_head.conv.weight,
                       build_model(model_cfg, params=init, device="cpu").rpn_head.conv.weight)
