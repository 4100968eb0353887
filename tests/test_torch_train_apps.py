"""The port's training entry points on the CPU at a tiny size (R50, 64x80
frames padded to 64x96, batch 2, a few iterations; the plain versions of
the kernels): ``apps.flir.train_flir`` and ``apps.kaist.train_kaist``
through their keep-best evaluation of the live model and resume, the
``train`` commands, and ``apps.train_net`` end to end.

What is held: the best metric is recorded, ``load_params`` of the best
checkpoint gives the live model's parameters at the iteration that set it
bit for bit, KAIST keeps the lowest LAMR and trains only the FPN and the
RPN, a second run on the same folder resumes at ``latest + 1``, and the
commands pass the demo scripts' arguments through. The models are random,
so the metrics' values are not read.
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest

from proben_tpu_torch.apps import flir, kaist, train_net
from proben_tpu_torch.data import DatasetCatalog, register_coco_instances
from proben_tpu_torch.engine import CallbackHook
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

H, W = 64, 80
CATEGORIES = [{"id": 1, "name": "person"}, {"id": 2, "name": "bicycle"}, {"id": 3, "name": "car"}]

_ABSENT = object()


@pytest.fixture(autouse=True, scope="module")
def _no_tensorboard():
    """TensorBoard's import pulls in TensorFlow (~17 s of CPU, several times
    that under a loaded test run), so the trainers here take
    ``TensorboardWriter``'s no-op path (tests/test_torch_trainer.py tests
    that path on its own)."""
    saved = sys.modules.get("torch.utils.tensorboard", _ABSENT)
    sys.modules["torch.utils.tensorboard"] = None  # its import raises ImportError
    yield
    if saved is _ABSENT:
        del sys.modules["torch.utils.tensorboard"]
    else:
        sys.modules["torch.utils.tensorboard"] = saved


def _coco(names, rng, n_cats=3):
    images, annotations = [], []
    for i, name in enumerate(names):
        images.append({"id": i + 1, "file_name": name, "height": H, "width": W})
        for j in range(1 + i % 2):
            x, y = float(rng.randint(0, 40)), float(rng.randint(0, 24))
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1,
                                "category_id": 1 + (i + j) % n_cats, "bbox": [x, y, 28.0, 36.0],
                                "area": 1008.0, "iscrowd": 0})
    return {"images": images, "annotations": annotations, "categories": CATEGORIES[:n_cats]}


@pytest.fixture(scope="module")
def flir_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("flir_train_app")
    (root / "thermal_8_bit").mkdir()
    (root / "RGB").mkdir()
    rng = np.random.RandomState(0)
    names = []
    for i in range(4):
        name = f"FLIR_{i:05d}"
        cv2.imwrite(str(root / "thermal_8_bit" / f"{name}.jpeg"), rng.randint(0, 255, (H, W), np.uint8))
        cv2.imwrite(str(root / "RGB" / f"{name}.jpg"), rng.randint(0, 255, (96, 120, 3), np.uint8))
        names.append(f"{name}.jpeg")
    (root / flir.TRAIN_JSON_NAME).write_text(json.dumps(_coco(names, rng)))
    (root / flir.VAL_JSON_NAME).write_text(json.dumps(_coco(names[:3], rng)))
    return str(root)


@pytest.fixture(scope="module")
def kaist_root(tmp_path_factory):
    """Three test frames (two day, one night) and a COCO train JSON over
    their lwir files."""
    root = tmp_path_factory.mktemp("kaist_train_app")
    rng = np.random.RandomState(1)
    lines, images, annotations, train = [], [], [], []
    for i, (set_num, v) in enumerate([(6, 0), (6, 0), (9, 0)]):
        rel = f"set{set_num:02d}/V{v:03d}/I{i:05d}"
        lines.append(rel)
        for mod in ("lwir", "visible"):
            d = root / f"set{set_num:02d}" / f"V{v:03d}" / mod
            d.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(d / f"I{i:05d}.jpg"), rng.randint(0, 255, (H, W, 3), np.uint8))
        train.append(f"{rel.replace('/I', '/lwir/I')}.jpg")
        images.append({"id": i + 1, "im_name": f"set{set_num:02d}_V{v:03d}_I{i:05d}_lwir.png",
                       "height": H, "width": W})
        # one pedestrian over most of the frame: a random model's boxes match it
        annotations.append({"image_id": i + 1, "category_id": 1, "bbox": [4.0, 2.0, 72.0, 60.0],
                            "height": 60.0, "occlusion": 0, "ignore": 0})
    (root / "test-all-20.txt").write_text("\n".join(lines) + "\n")
    (root / "KAIST_annotation.json").write_text(json.dumps({"images": images, "annotations": annotations}))
    (root / "train.json").write_text(json.dumps(_coco(train, rng, n_cats=1)))
    return {"root": str(root), "split": str(root / "test-all-20.txt"),
            "ann": str(root / "KAIST_annotation.json"), "train": str(root / "train.json")}


def _shrink(cfg):
    cfg.SEED = 0
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 32
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 32
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 32
    cfg.TEST.DETECTIONS_PER_IMAGE = 5
    cfg.INPUT.PAD_SHAPE = (64, 96)
    cfg.INPUT.MIN_SIZE_TRAIN = (56, 64)
    cfg.INPUT.MAX_SIZE_TRAIN = 96
    cfg.INPUT.MIN_SIZE_TEST = 64
    cfg.INPUT.MAX_SIZE_TEST = 96
    cfg.INPUT.MAX_GT = 4
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.SOLVER.BASE_LR = 0.001
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.MODEL.ROI_ALIGN_IMPL = "gather"
    return cfg


class Watch:
    """Hooks that record what the trainer did: its start iteration, and the
    live parameters whenever the keep-best evaluation just saved a best."""

    def __init__(self):
        self.starts, self.best = [], {}

    def hooks(self):
        def seen(t):
            meta = t.checkpointer._read_meta()
            if meta.get("best_step") == t.iter and t.iter not in self.best:
                self.best[t.iter] = t.params
            self.step, self.higher_is_better = t.state.step, t.checkpointer.higher_is_better
            self.best_metric = t.checkpointer.best_metric
            self.trainable = {n.split(".")[0] for n, p in t.model.named_parameters() if p.requires_grad}

        return [CallbackHook(before_train=lambda t: self.starts.append(t.start_iter),
                             after_step=seen, after_train=seen)]


def _same_tree(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


def _best_step(out):
    with open(os.path.join(out, "checkpoints", "last.json")) as f:
        return json.load(f)["best_step"]


def test_train_flir_keeps_best_and_resumes(flir_root, tmp_path):
    out = str(tmp_path / "flir_out")
    cfg = _shrink(flir.build_flir_cfg("thermal_only"))
    watch = Watch()
    res = flir.train_flir("thermal_only", flir_root, out, max_iter=2, eval_every=1, cfg=cfg,
                          device="cpu", hooks=watch.hooks())
    assert np.isfinite(res["best_AP50"]) and watch.starts == [0]
    step = _best_step(out)
    assert step in watch.best and step in (0, 1)
    best = flir.load_params(cfg, os.path.join(out, "checkpoints", "best"))
    assert _same_tree(best, watch.best[step])
    assert DatasetCatalog.get("FLIR_train_thermal_only")[0]["file_name"].endswith("FLIR_00000.jpeg")

    again = Watch()
    res2 = flir.train_flir("thermal_only", flir_root, out, max_iter=3, eval_every=1,
                           cfg=_shrink(flir.build_flir_cfg("thermal_only")), device="cpu",
                           hooks=again.hooks())
    assert again.starts == [2] and again.step == 3
    assert res2["best_AP50"] >= res["best_AP50"]


def test_train_kaist_keeps_lowest_lamr_and_trains_fpn_and_rpn(kaist_root, tmp_path):
    out = str(tmp_path / "kaist_out")
    DatasetCatalog.remove("kaist_train_tiny")
    register_coco_instances("kaist_train_tiny", {}, kaist_root["train"], kaist_root["root"])
    cfg = _shrink(kaist.build_kaist_cfg("thermal_only"))
    watch = Watch()
    res = kaist.train_kaist("thermal_only", "kaist_train_tiny", kaist_root["ann"], kaist_root["root"],
                            kaist_root["split"], out, max_iter=2, eval_every=1, cfg=cfg,
                            device="cpu", hooks=watch.hooks())
    assert watch.higher_is_better is False
    assert np.isfinite(res["best_lamr"]) and res["best_lamr"] == watch.best_metric
    assert watch.trainable == {"fpn", "rpn_head"}
    step = _best_step(out)
    best = kaist.load_params(cfg, os.path.join(out, "checkpoints", "best"))
    assert _same_tree(best, watch.best[step])


def test_flir_train_command_passes_the_demo_arguments(monkeypatch):
    seen = {}
    monkeypatch.setattr(flir, "train_flir", lambda *a, **k: seen.update(args=a, kw=k) or {"best_AP50": 1.0})
    out = flir.main(["train", "--dataset_path", "D", "--fusion_method", "middle_fusion",
                     "--max_iter", "7", "--device", "cpu"])
    assert out == {"best_AP50": 1.0}
    assert seen["args"] == ("middle_fusion", "D", "out_training", 7, 1000) and seen["kw"] == {"device": "cpu"}
    args = flir.train_parser().parse_args(["--dataset_path", "D"])
    assert (args.fusion_method, args.outfolder, args.max_iter, args.eval_every) == (
        "thermal_only", "out_training", None, 1000)


def test_kaist_train_command_passes_the_demo_arguments(monkeypatch):
    seen = {}
    monkeypatch.setattr(kaist, "train_kaist", lambda *a, **k: seen.update(args=a, kw=k) or {"best_lamr": 9.0})
    monkeypatch.setattr(kaist, "register_coco_instances", lambda *a: seen.update(reg=a))
    out = kaist.main(["train", "--train_json", "J", "--train_image_root", "R", "--data_root", "D",
                      "--split", "S", "--annotation", "A", "--eval_every", "5"])
    assert out == {"best_lamr": 9.0}
    assert seen["reg"] == ("kaist_train", {}, "J", "R")
    assert seen["args"] == ("thermal_only", "kaist_train", "A", "D", "S", "out_kaist", 10000, 5)
    assert seen["kw"] == {"device": "cuda"}


def test_train_net_parses_and_trains(flir_root, tmp_path):
    yaml = os.path.join(os.path.dirname(__file__), "..", "configs", "FLIR-Detection",
                        "faster_rcnn_R_101_FLIR.yaml")
    js = os.path.join(flir_root, flir.TRAIN_JSON_NAME)
    out = str(tmp_path / "net_out")
    opts = ["OUTPUT_DIR", out, "DATASETS.TRAIN", "[tiny_net]", "DATASETS.TEST", "[tiny_net]",
            "SOLVER.MAX_ITER", "2", "MODEL.COMPUTE_DTYPE", "float32"]
    base = ["--config-file", yaml, "--register", f"tiny_net,{js},{flir_root}/thermal_8_bit",
            "--device", "cpu"]
    args = train_net.parse_args(base + opts)
    assert args.register == [f"tiny_net,{js},{flir_root}/thermal_8_bit"] and not args.resume
    cfg = _shrink(train_net.setup(args))
    assert cfg.MODEL.RESNETS.DEPTH == 50 and cfg.DATASETS.TRAIN == ("tiny_net",)
    assert cfg.SOLVER.MAX_ITER == 2 and cfg.OUTPUT_DIR == out

    small = [k for kv in (("MODEL.RESNETS.DEPTH", "50"), ("INPUT.PAD_SHAPE", "[64, 96]"),
                          ("INPUT.MIN_SIZE_TRAIN", "[64]"), ("INPUT.MAX_SIZE_TRAIN", "96"),
                          ("INPUT.MIN_SIZE_TEST", "64"), ("INPUT.MAX_SIZE_TEST", "96"),
                          ("SOLVER.IMS_PER_BATCH", "2"), ("SOLVER.CHECKPOINT_PERIOD", "1"),
                          ("DATALOADER.NUM_WORKERS", "1"), ("MODEL.RPN.POST_NMS_TOPK_TRAIN", "32"),
                          ("MODEL.RPN.PRE_NMS_TOPK_TEST", "64"), ("MODEL.RPN.POST_NMS_TOPK_TEST", "32"),
                          ("TEST.DETECTIONS_PER_IMAGE", "5"), ("MODEL.ROI_ALIGN_IMPL", "gather"))
             for k in kv]
    state = train_net.main(base + opts + small)
    assert state.step == 2 and os.path.exists(os.path.join(out, "metrics.json"))
    results = train_net.main(base + ["--resume", "--eval-only"] + opts + small)
    assert set(results) == {"bbox"} and np.isfinite(results["bbox"]["AP50"])
