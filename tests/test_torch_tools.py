"""The port's user commands (``proben_tpu_torch/apps/{plain_train_net,
benchmark,visualize_data,visualize_json_results,convert_torchvision}.py``)
against the JAX package's ``tools/`` on the CPU, each tool loaded from its
file as tests/test_tools_extra.py loads them.

``plain_train_net``: ``configs/FLIR-Detection/faster_rcnn_R_101_FLIR.yaml``
cut to the port's test size (R50, f32, 64x80 images padded to 64x96, batch
2, small top-k) on a tiny synthetic COCO tree, 2 iterations in both
packages, from one detectron2 ``.pkl`` that covers every parameter (the
port's init with random affines, the RPN's convs rescaled as in
tests/test_torch_trainer.py), so neither package's own init shows. Identity
sampling and the loaders' streams as in tests/test_torch_trainer.py, so the
batches and the sampled rows are the same and every loss of both steps
agrees to rtol 1e-4 (f32 through 50 layers in other summation orders).
Warm-up is off and ``WEIGHT_DECAY`` is 0.01, so that weight decay moves the
frozen stem (no gradient: its forward runs without one) by ~1e-5 of
itself per step: neither tool passes a trainable mask. The parameters'
change over the 2 steps, after taking off each element's own f32 rounding
(as tests/test_torch_fusion_steps.py): to a relative L2 error of 2e-3 over
all tensors together (measured 4.6e-4: at lr 1e-3 from the first step the
second step's gradients are taken at parameters that already differ) and
2e-2 per tensor (a ReLU pre-activation within rounding of zero can take
the other sign in one package, tests/test_torch_train.py; measured 4.3e-3
at most, in res4).
"""

import json
import os
import pickle
import re
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from test_tools_extra import _fake_torchvision_r50_sd, _load_tool
from proben_tpu.data import DatasetCatalog as JaxDatasetCatalog
from proben_tpu.data import MetadataCatalog as JaxMetadataCatalog
from proben_tpu.structures.boxes import BoxMode as JaxBoxMode
from proben_tpu_torch.apps import (benchmark, convert_torchvision, plain_train_net, visualize_data,
                                   visualize_json_results)
from proben_tpu_torch.checkpoint import state_dict_to_jax
from proben_tpu_torch.config import get_cfg, mapper_config_from_cfg, model_config_from_cfg
from proben_tpu_torch.data import DatasetCatalog, DatasetMapper, MetadataCatalog, collate
from proben_tpu_torch.data import register_coco_instances
from proben_tpu_torch.models import build_model, init_rcnn, random_affines
from proben_tpu_torch.models import rcnn as t_rcnn
from proben_tpu_torch.structures.boxes import BoxMode
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "FLIR-Detection", "faster_rcnn_R_101_FLIR.yaml")
H, W, PAD = 64, 80, (64, 96)
PRE, POST, G = 64, 32, 8
N_ANCHORS = sum(-(-PAD[0] // s) * -(-PAD[1] // s) * 3 for s in (4, 8, 16, 32, 64))
NAME = "tiny_torch_tools_ds"
LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")


def _image(rng):
    """Background gradient + box-shaped blobs (bench.py's recipe), uint8."""
    im = np.tile(np.linspace(60.0, 120.0, W)[None, :, None], (H, 1, 3))
    im += rng.randn(H, W, 3) * 8
    boxes = []
    for _ in range(rng.randint(1, 4)):
        bw, bh = rng.randint(12, 36), rng.randint(12, 40)
        x, y = rng.randint(0, W - bw), rng.randint(0, H - bh)
        im[y:y + bh, x:x + bw] = rng.uniform(130, 240)
        boxes.append([float(x), float(y), float(bw), float(bh)])
    return np.clip(im, 0, 255).astype(np.uint8), boxes


def _opts(out_dir, weights=""):
    """The YAML's overrides down to the test size, with identity sampling."""
    return ["OUTPUT_DIR", str(out_dir), "SEED", "0", "DATASETS.TRAIN", f"['{NAME}']",
            "MODEL.WEIGHTS", weights, "MODEL.RESNETS.DEPTH", "50", "MODEL.COMPUTE_DTYPE", "float32",
            "MODEL.ROI_ALIGN_IMPL", "gather", "MODEL.STEM_IMPL", "direct",
            "MODEL.RPN.PRE_NMS_TOPK_TRAIN", str(PRE), "MODEL.RPN.POST_NMS_TOPK_TRAIN", str(POST),
            "MODEL.RPN.PRE_NMS_TOPK_TEST", str(PRE), "MODEL.RPN.POST_NMS_TOPK_TEST", str(POST),
            "MODEL.RPN.BATCH_SIZE_PER_IMAGE", str(N_ANCHORS),
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", str(POST + G), "MODEL.ROI_HEADS.POSITIVE_FRACTION", "1.0",
            "INPUT.PAD_SHAPE", str(list(PAD)), "INPUT.MIN_SIZE_TRAIN", "[56, 64]", "INPUT.MAX_SIZE_TRAIN", "96",
            "INPUT.MAX_GT", str(G), "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2",
            "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "0", "SOLVER.WEIGHT_DECAY", "0.01",
            "SOLVER.CHECKPOINT_PERIOD", "2", "DATALOADER.NUM_WORKERS", "1"]


def _cfg(out_dir, weights=""):
    cfg = get_cfg()
    cfg.merge_from_file(YAML)
    cfg.merge_from_list(_opts(out_dir, weights))
    return cfg


def _calibrated(cfg):
    """The port's init with random affines, RPN convs rescaled on the first
    mapped batch to output std 2 and 0.3 (tests/test_torch_trainer.py)."""
    mcfg = model_config_from_cfg(cfg)
    params = random_affines(init_rcnn(0, mcfg), 0)
    model = build_model(mcfg, params=params, device="cpu")
    mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=True, device="cpu")
    batch = collate(mapper.map_batch(DatasetCatalog.get(NAME)[:2]))
    with torch.inference_mode():
        feats = t_rcnn.extract_features(model, mcfg, t_rcnn.preprocess(mcfg, batch["image"]))
        lg, dl = t_rcnn.rpn_outputs(model, mcfg, feats)
    head = params["rpn_head"]
    for name, t, target in (("objectness", lg, 2.0), ("deltas", dl, 0.3)):
        s = target / float(torch.cat([x.flatten() for x in t]).std())
        head[name]["w"] = head[name]["w"] * s
        head[name]["b"] = head[name]["b"] * s
    return params


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 4-image COCO tree (JPEGs by cv2), registered as ``NAME`` in the
    port, and a detectron2 ``.pkl`` of every parameter of the test model."""
    root = tmp_path_factory.mktemp("tiny_tools")
    tdir = root / "thermal_8_bit"
    tdir.mkdir()
    rng = np.random.RandomState(0)
    images, annotations = [], []
    for i in range(4):
        name = f"FLIR_{i:05d}.jpeg"
        im, boxes = _image(rng)
        cv2.imwrite(str(tdir / name), im)
        images.append({"id": i + 1, "file_name": name, "height": H, "width": W})
        for b in boxes:
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1,
                                "category_id": 1 + len(annotations) % 3, "bbox": b,
                                "area": b[2] * b[3], "iscrowd": 0})
    js = {"images": images, "annotations": annotations,
          "categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "bicycle"},
                         {"id": 3, "name": "car"}]}
    (root / "ann.json").write_text(json.dumps(js))
    register = f"{NAME},{root / 'ann.json'},{tdir}"
    DatasetCatalog.remove(NAME)
    register_coco_instances(NAME, {}, str(root / "ann.json"), str(tdir))
    params = _calibrated(_cfg(root / "calib"))
    weights = root / "weights.pkl"
    with open(weights, "wb") as f:
        pickle.dump({"model": chip_smoke.d2_state_dict(params)}, f)
    return {"root": root, "register": register, "weights": str(weights), "params": params}


class _Recording:
    """An ``EventStorage`` class of one package that keeps every step's
    scalars in ``steps``."""

    def __init__(self, base):
        steps = self.steps = []

        class Storage(base):
            def put_scalar(self, name, value):
                if self.iter == len(steps):
                    steps.append({})
                steps[self.iter][name] = float(value)
                super().put_scalar(name, value)

        self.cls = Storage


class _SavedStates:
    """A stand-in for the JAX tool's orbax ``CheckpointManager`` that keeps
    each saved state in memory."""

    saved = {}

    def __init__(self, root):
        self.root = root

    def save(self, step, state):
        _SavedStates.saved[step] = jax.device_get(state)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): np.asarray(tree)}


def test_plain_train_net_matches_the_jax_tool(tree, tmp_path, monkeypatch):
    """Both plain loops, 2 iterations from the same ``.pkl``: every loss
    of both steps to rtol 1e-4; the parameters after step 2 (the JAX
    tool's state at its checkpoint, the port's returned state) to 1e-6 +
    1e-4 of each leaf's size; the frozen stem conv moved by weight decay
    (not by a gradient) by the same amount in both, to 1e-6 of itself;
    the port's checkpoint of step 2 and ``metrics.json`` written."""
    from proben_tpu.data import register_coco_instances as jax_register
    from proben_tpu.utils.events import EventStorage as JaxEventStorage
    from proben_tpu_torch.utils.events import EventStorage

    tool = _load_tool("plain_train_net")
    jrec, rec = _Recording(JaxEventStorage), _Recording(EventStorage)
    # the .pkl replaces every leaf of the tool's init (a leaf it missed would
    # hold 0 and fail the comparison below), so its eager threefry draws
    # (~14 s for an R50 on an 8-core CPU) are left out: zeros of the init's structure
    init = tool.init_rcnn
    monkeypatch.setattr(tool, "init_rcnn", lambda key, mcfg: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(lambda: init(key, mcfg))))
    monkeypatch.setattr(tool, "EventStorage", jrec.cls)
    monkeypatch.setattr(tool, "CheckpointManager", _SavedStates)
    monkeypatch.setattr(plain_train_net, "EventStorage", rec.cls)
    JaxDatasetCatalog.remove(NAME)
    monkeypatch.setattr(sys, "argv", ["plain_train_net.py", "--config-file", YAML, "--register",
                                      tree["register"], *_opts(tmp_path / "jax", tree["weights"])])
    try:
        tool.main()
    finally:
        JaxDatasetCatalog.remove(NAME)
    state = plain_train_net.main(["--config-file", YAML, "--register", tree["register"], "--device", "cpu",
                                  *_opts(tmp_path / "port", tree["weights"])])

    assert len(rec.steps) == len(jrec.steps) == 2
    for i, (got, want) in enumerate(zip(rec.steps, jrec.steps)):
        assert set(got) == set(want), (i, set(got) ^ set(want))
        assert got["loss_finite"] == want["loss_finite"] == 1.0
        for k in LOSSES:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"step {i}: {k}")
    assert rec.steps[1]["total_loss"] != rec.steps[0]["total_loss"]

    assert state.step == 2 and all(p.requires_grad for p in state.model.parameters())  # no mask
    got = _leaves(state_dict_to_jax(state.model.state_dict()))
    want = _leaves(_SavedStates.saved[1].params)
    start = _leaves(tree["params"])
    assert set(got) == set(want) == set(start)
    num = den = 0.0
    for k, w in want.items():
        d_got, d_want = got[k] - start[k], w - start[k]
        excess = np.maximum(np.abs(d_got - d_want) - 2.0 ** -22 * (np.abs(start[k]) + np.abs(w)), 0.0)
        assert np.linalg.norm(excess) <= 2e-2 * np.linalg.norm(d_want), k
        num += float(np.sum(excess ** 2))
        den += float(np.sum(d_want.astype(np.float64) ** 2))
    assert den > 0 and np.sqrt(num / den) < 2e-3, np.sqrt(num / den)
    stem = "backbone/stem/conv1/w"
    np.testing.assert_allclose(got[stem], want[stem], rtol=1e-6, err_msg=stem)
    # weight decay alone: v1 = wd p0, p1 = p0 (1 - a); v2 = 0.9 v1 + wd p1,
    # p2 = p0 ((1 - a)^2 - 0.9 a), a = lr wd = 1e-5
    a = 0.001 * 0.01
    np.testing.assert_allclose(got[stem], start[stem] * ((1 - a) ** 2 - 0.9 * a), rtol=1e-6, err_msg=stem)
    assert np.abs(got[stem] - start[stem]).max() > 1e-5 * np.abs(start[stem]).max()
    assert os.path.isdir(tmp_path / "port" / "checkpoints" / "iter_0000001")
    assert (tmp_path / "port" / "metrics.json").exists()


TINY = ["MODEL.RESNETS.DEPTH", "50", "MODEL.COMPUTE_DTYPE", "float32", "INPUT.PAD_SHAPE", str(list(PAD)),
        "INPUT.MIN_SIZE_TRAIN", "[56, 64]", "INPUT.MAX_SIZE_TRAIN", "96", "INPUT.MAX_GT", "4",
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
        "MODEL.RPN.PRE_NMS_TOPK_TEST", "64", "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32", "TEST.DETECTIONS_PER_IMAGE", "5",
        "SOLVER.IMS_PER_BATCH", "2",
        "DATASETS.TRAIN", f"['{NAME}']"]
LINES = {"eval": r"inference: [0-9.]+ img/s \([0-9.]+ ms/batch of 2\)",
         "train": r"train: [0-9.]+ s/iter, [0-9.]+ img/s",
         "data": r"data: [0-9.]+ img/s"}


@pytest.mark.parametrize("task", ["eval", "train", "data"])
def test_benchmark_prints_the_tools_line(task, tree, capsys):
    """Each task at the test size prints the JAX tool's line. Eval's
    detections are ``rcnn_inference``'s on the same model and synthetic
    batch; a train step's losses are finite; data's batch is the loader's
    global batch at the padded shape."""
    line, out = benchmark.main(["--task", task, "--iters", "2", "--batch", "2", "--device", "cpu",
                                "--config-file", YAML, *TINY])
    assert re.fullmatch(LINES[task], line), line
    assert capsys.readouterr().out.strip().splitlines()[-1] == line
    if task == "eval":
        cfg = _cfg("unused")
        cfg.merge_from_list(TINY)
        mcfg = model_config_from_cfg(cfg)
        data = benchmark.synthetic_batch(cfg, 2, np.random.RandomState(0), torch.device("cpu"))
        assert data["image"].shape == (2, *PAD, 3)
        assert data["image_size"].tolist() == [[PAD[0], PAD[1] - 24]] * 2
        want = t_rcnn.rcnn_inference(build_model(mcfg, seed=0, device="cpu"), mcfg, data["image"],
                                     data["image_size"])
        for k in ("boxes", "scores", "classes", "valid"):
            assert torch.equal(getattr(out, k), getattr(want, k)), k
    elif task == "train":
        assert all(np.isfinite(float(v)) for v in out.values()) and float(out["loss_finite"]) == 1.0
    else:
        assert out["image"].shape == (2, *PAD, 3) and len(out["indices"]) == 2


# the visualizers: a tiny split of 3 images with XYWH and XYXY boxes, and
# a prediction JSON over the dataset's ids 1-3
VIS_CLASSES = ["person", "bicycle", "car"]


def _vis_split(root, box_mode):
    """(dicts of the split for the package of ``box_mode``, predictions).
    Image 0's annotations are XYWH (no ``bbox_mode``, as COCO dicts),
    image 1's XYXY, image 2's mixed."""
    rng = np.random.RandomState(3)
    dicts, preds = [], []
    for i in range(3):
        path = os.path.join(root, f"im{i}.jpg")
        if not os.path.exists(path):
            cv2.imwrite(path, _image(rng)[0])
        anns = []
        for j in range(3):
            x, y, w, h = (float(v) for v in (4 + 20 * j, 6 + 10 * j, 14 + j, 18 - j))
            xyxy = i == 1 or (i == 2 and j % 2)
            ann = {"bbox": [x, y, x + w, y + h] if xyxy else [x, y, w, h], "category_id": j}
            if xyxy:
                ann["bbox_mode"] = box_mode.XYXY_ABS
            elif i == 2:
                ann["bbox_mode"] = box_mode.XYWH_ABS
            anns.append(ann)
            preds.append({"image_id": 10 + i, "category_id": 1 + j, "bbox": [x + 1, y, w, h],
                          "score": [0.9, 0.6, 0.3][j]})
        dicts.append({"file_name": path, "image_id": 10 + i, "height": H, "width": W, "annotations": anns})
    return dicts, preds


def _register_both(name, root, mapping):
    for catalog, meta, box_mode in ((DatasetCatalog, MetadataCatalog, BoxMode),
                                    (JaxDatasetCatalog, JaxMetadataCatalog, JaxBoxMode)):
        dicts, preds = _vis_split(root, box_mode)
        catalog.remove(name)
        catalog.register(name, lambda d=dicts: d)
        m = meta.get(name)
        m.thing_classes = VIS_CLASSES
        if mapping:
            m.thing_dataset_id_to_contiguous_id = {1: 2, 2: 0, 3: 1}
    return preds


def _files(d):
    return {p: open(os.path.join(d, p), "rb").read() for p in sorted(os.listdir(d))}


def test_visualize_data_writes_the_jax_tools_images(tmp_path, monkeypatch):
    """The port's ``visualize_data`` on the CPU writes the JAX tool's PNGs
    byte for byte, boxes converted by each annotation's ``bbox_mode``."""
    name = "tiny_torch_tools_vis"
    _register_both(name, str(tmp_path), mapping=False)
    tool = _load_tool("visualize_data")
    monkeypatch.setattr(sys, "argv", ["visualize_data.py", "--dataset", name, "--output-dir",
                                      str(tmp_path / "jax")])
    tool.main()
    assert visualize_data.main(["--dataset", name, "--output-dir", str(tmp_path / "port"),
                                "--device", "cpu"]) == 3
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert list(got) == ["im0.jpg.png", "im1.jpg.png", "im2.jpg.png"] and got == want


@pytest.mark.parametrize("name,mapping", [("tiny_torch_tools_mapped", True), ("tiny_lvis_torch_tools", False)])
def test_visualize_json_results_writes_the_jax_tools_images(name, mapping, tmp_path, monkeypatch):
    """The port's ``visualize_json_results`` on the CPU writes the JAX
    tool's images byte for byte: predictions above 0.5 on the left, the
    ground truth by each ``bbox_mode`` on the right, class ids through
    ``thing_dataset_id_to_contiguous_id`` or, for an LVIS name without
    one, shifted by -1."""
    preds = _register_both(name, str(tmp_path), mapping)
    pred_json = tmp_path / "preds.json"
    pred_json.write_text(json.dumps(preds))
    args = ["--input", str(pred_json), "--dataset", name, "--conf-threshold", "0.5"]
    tool = _load_tool("visualize_json_results")
    monkeypatch.setattr(sys, "argv", ["visualize_json_results.py", *args, "--output", str(tmp_path / "jax")])
    tool.main()
    assert visualize_json_results.main([*args, "--output", str(tmp_path / "port"), "--device", "cpu"]) == 3
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert list(got) == ["im0.jpg", "im1.jpg", "im2.jpg"] and got == want
    assert cv2.imread(str(tmp_path / "port" / "im0.jpg")).shape == (H, 2 * W, 3)
    boxes, scores, classes = visualize_json_results.filtered_predictions(
        [p for p in preds if p["image_id"] == 10], 0.5,
        {1: 2, 2: 0, 3: 1}.__getitem__ if mapping else (lambda i: i - 1))
    assert scores.tolist() == pytest.approx([0.9, 0.6])
    assert classes.tolist() == ([2, 0] if mapping else [0, 1])
    np.testing.assert_array_equal(boxes[0], [5, 6, 19, 24])


def test_convert_torchvision_writes_the_jax_tools_pkl(tmp_path):
    """The port's converter writes the JAX tool's ``.pkl`` from a fake
    torchvision R50 (tests/test_tools_extra.py's), byte for byte, and the
    port's ``import_detectron2_checkpoint`` of it (its backbone-only
    branch) equals the JAX package's import on one template leaf for leaf:
    the backbone from the file, the rest the template's (``strict=False``)."""
    from proben_tpu.checkpoint.torch_import import import_detectron2_checkpoint as jax_import
    from proben_tpu_torch.checkpoint import import_detectron2_checkpoint
    from proben_tpu_torch.models import build_config

    torch.manual_seed(0)
    src = tmp_path / "r50.pth"
    torch.save(_fake_torchvision_r50_sd(), str(src))
    _load_tool("convert_torchvision").convert(str(src), str(tmp_path / "jax.pkl"))
    convert_torchvision.main([str(src), str(tmp_path / "port.pkl"), "--device", "cpu"])
    assert (tmp_path / "port.pkl").read_bytes() == (tmp_path / "jax.pkl").read_bytes()
    res = pickle.loads((tmp_path / "port.pkl").read_bytes())
    assert res["matching_heuristics"] and "res5.2.conv3.norm.running_var" in res["model"]
    assert not any(k.startswith("fc.") for k in res["model"])

    template = init_rcnn(0, build_config(depth=50, input_format="BGR", num_classes=3))
    got = _leaves(import_detectron2_checkpoint(str(tmp_path / "port.pkl"), template, strict=False))
    want = _leaves(jax_import(str(tmp_path / "jax.pkl"), template, strict=False))
    assert set(got) == set(want) == set(_leaves(template))
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    flat = _leaves(template)
    assert not np.array_equal(got["backbone/stem/conv1/w"], flat["backbone/stem/conv1/w"])
    assert all(np.array_equal(got[k], flat[k]) for k in got if not k.startswith("backbone/"))
