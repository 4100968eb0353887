"""The port's FLIR app (``proben_tpu_torch/apps/flir.py``) against
``proben_tpu.apps.flir`` on the CPU: save predictions, evaluate mAP, ProbEn
late fusion of the saved JSONs, on a synthetic FLIR-shaped tree (written
with ``cv2.imwrite``: single-component thermal, colour RGB) with the tiny
configuration of ``tests/test_flir_app.py`` (R50, 192x224 canvas, 3 images)
and the same numpy parameters in both packages (JAX's ``init_rcnn``).

Tolerances: the prediction JSONs hold the same keys, image order, ids,
counts and classes (detections paired by class and box, since tied scores
may list in either order); boxes to 2e-3 px, scores and probabilities to 1e-4,
logits to 1e-3 and variances to rtol 1e-3 (the same f32 model in other
summation orders; the variance is an exp of a head output, whose relative
error is that output's absolute one). The evaluators and the late fusion
are the same numpy code on the same inputs: their results are equal
(NaN where JAX has NaN).
"""

import json
import os
import types

import cv2
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from proben_tpu.apps import flir as jax_flir
from proben_tpu.config import model_config_from_cfg as jax_model_config_from_cfg
from proben_tpu.evaluation import FLIREvaluator as JaxFLIREvaluator
from proben_tpu.models import init_rcnn as jax_init_rcnn
from proben_tpu_torch.apps import flir
from proben_tpu_torch.evaluation import FLIREvaluator
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

METHODS = ("thermal_only", "early_fusion")
SCORE, BOX = ("avg", "max", "probEn"), ("avg", "s-avg", "v-avg", "argmax")


@pytest.fixture(scope="module")
def flir_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("flir_app")
    (root / "thermal_8_bit").mkdir()
    (root / "RGB").mkdir()
    rng = np.random.RandomState(0)
    images, annotations = [], []
    for i in range(3):
        name = f"FLIR_{i:05d}"
        cv2.imwrite(str(root / "thermal_8_bit" / f"{name}.jpeg"),
                    cv2.GaussianBlur(rng.randint(0, 255, (128, 160), np.uint8), (5, 5), 2))
        cv2.imwrite(str(root / "RGB" / f"{name}.jpg"), rng.randint(0, 255, (256, 320, 3), np.uint8))
        images.append({"id": i + 1, "file_name": f"{name}.jpeg", "height": 128, "width": 160})
        for j in range(2):
            annotations.append({"id": 2 * i + j + 1, "image_id": i + 1, "category_id": 1 + (i + j) % 3,
                                "bbox": [20.0 + 40 * j, 20.0, 60.0, 50.0], "area": 3000.0,
                                "iscrowd": 0})
    js = {"images": images, "annotations": annotations,
          "categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "bicycle"},
                         {"id": 3, "name": "car"}]}
    (root / flir.VAL_JSON_NAME).write_text(json.dumps(js))
    return str(root)


def _tiny_cfg(mod, method):
    """``tests/test_flir_app.py::_tiny_cfg`` for either package."""
    cfg = mod.build_flir_cfg(method)
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0  # random weights: keep some dets
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 32
    cfg.TEST.DETECTIONS_PER_IMAGE = 5
    cfg.INPUT.PAD_SHAPE = (192, 224)
    cfg.INPUT.MIN_SIZE_TEST = 160
    cfg.INPUT.MAX_SIZE_TEST = 224
    cfg.MODEL.ROI_ALIGN_IMPL = "gather"  # the JAX path's CPU speed; the port maps it to "plain"
    return cfg


def _params(method):
    cfg = _tiny_cfg(jax_flir, method)
    key = jax.random.PRNGKey(METHODS.index(method) + 7)
    return jax.tree_util.tree_map(np.asarray, jax_init_rcnn(key, jax_model_config_from_cfg(cfg)))


@pytest.fixture(scope="module")
def saved(flir_root, tmp_path_factory):
    out = {"jax": str(tmp_path_factory.mktemp("out_jax")), "torch": str(tmp_path_factory.mktemp("out_t"))}
    files = {"jax": [], "torch": []}
    for method in METHODS:
        params = _params(method)
        files["jax"].append(jax_flir.save_predictions(
            method, flir_root, "", out["jax"], batch_size=2, cfg=_tiny_cfg(jax_flir, method),
            params=params))
        files["torch"].append(flir.save_predictions(
            method, flir_root, "", out["torch"], batch_size=2, cfg=_tiny_cfg(flir, method),
            params=params, device="cpu"))
    return out, files


@pytest.mark.parametrize("m", range(len(METHODS)), ids=METHODS)
def test_save_predictions_matches_jax(saved, m):
    _, files = saved
    assert os.path.basename(files["torch"][m]) == os.path.basename(files["jax"][m])
    with open(files["jax"][m]) as f:
        want = json.load(f)
    with open(files["torch"][m]) as f:
        got = json.load(f)
    assert set(got) == set(want) == {"image", "boxes", "scores", "classes", "class_logits", "probs",
                                     "vars", "image_id"}
    assert got["image"] == want["image"] and got["image_id"] == want["image_id"] == [1, 2, 3]
    assert sum(len(b) for b in got["boxes"]) > 0
    for i in range(3):
        assert sorted(got["classes"][i]) == sorted(want["classes"][i]), i
        for k, j in _pairs(got, want, i):
            for key, tol in (("boxes", dict(atol=2e-3)), ("scores", dict(atol=1e-4)),
                             ("probs", dict(atol=1e-4)), ("class_logits", dict(atol=1e-3)),
                             ("vars", dict(rtol=1e-3))):
                np.testing.assert_allclose(np.asarray(got[key][i][k], float),
                                           np.asarray(want[key][i][j], float),
                                           err_msg=f"{key} image {i}", **tol)


def _pairs(got, want, i):
    """(port index, JAX index) of each detection of image ``i``: the port's
    detection of the same class with the nearest box. Scores that tie (the
    random early-fusion head saturates at 1.0) may list tied detections in
    either order."""
    gb = np.asarray(got["boxes"][i], float).reshape(-1, 4)
    wb = np.asarray(want["boxes"][i], float).reshape(-1, 4)
    assert len(gb) == len(wb), i
    free, pairs = set(range(len(gb))), []
    for j, (box, cls) in enumerate(zip(wb, want["classes"][i])):
        k = min((k for k in free if got["classes"][i][k] == cls), key=lambda k: np.abs(gb[k] - box).max())
        free.remove(k)
        pairs.append((k, j))
    return pairs


def _equal_results(a, b):
    assert a.keys() == b.keys()
    for task in a:
        assert a[task].keys() == b[task].keys()
        for k, v in a[task].items():
            assert (np.isnan(v) and np.isnan(b[task][k])) or v == b[task][k], (task, k, v, b[task][k])


@pytest.mark.parametrize("sm", SCORE)
@pytest.mark.parametrize("bm", BOX)
def test_run_proben_matches_jax(flir_root, saved, sm, bm):
    """Every (score, box) method over the same JSON files: equal results."""
    out, files = saved
    want = jax_flir.run_proben(flir_root, out["jax"], sm, bm, out["jax"], det_files=files["jax"])
    got = flir.run_proben(flir_root, out["jax"], sm, bm, out["torch"], det_files=files["jax"])
    _equal_results(got, want)


def test_flir_evaluator_matches_jax(flir_root, saved):
    """The same detections (the saved JSON, with the classes the evaluator
    remaps and drops mixed in) give equal results and results files."""
    out, files = saved
    with open(files["jax"][0]) as f:
        dets = json.load(f)
    json_path = os.path.join(flir_root, flir.VAL_JSON_NAME)
    evs = [JaxFLIREvaluator(json_path, output_dir=out["jax"]), FLIREvaluator(json_path, output_dir=out["torch"])]
    for ev in evs:
        for i, image_id in enumerate(dets["image_id"]):
            boxes = np.asarray(dets["boxes"][i], float).reshape(-1, 4)
            classes = np.asarray(dets["classes"][i], int)
            ev.process(image_id, boxes, dets["scores"][i], np.where(np.arange(len(classes)) % 4 == 3, 7, classes))
            ev.process(image_id, boxes[:1] + 3.0, [0.9], [16])  # valid class, no category: dropped
    want, got = (ev.evaluate() for ev in evs)
    _equal_results(got, want)
    with open(os.path.join(out["jax"], "coco_instances_results.json")) as f:
        a = json.load(f)
    with open(os.path.join(out["torch"], "coco_instances_results.json")) as f:
        assert json.load(f) == a


def test_evaluate_map_matches_jax_and_ground_truth_scores_100(flir_root, tmp_path):
    """``evaluate_map`` of the tiny thermal model in both packages (the
    detections agree to the tolerances above, so the mAP of 3 images
    agrees to the points a near-tie can move), and the ground truth fed
    back as detections gives AP = 100."""
    params = _params("thermal_only")
    want = jax_flir.evaluate_map("thermal_only", flir_root, "", str(tmp_path / "j"), batch_size=2,
                                 cfg=_tiny_cfg(jax_flir, "thermal_only"), params=params)
    got = flir.evaluate_map("thermal_only", flir_root, "", str(tmp_path / "t"), batch_size=2,
                            cfg=_tiny_cfg(flir, "thermal_only"), params=params, device="cpu")
    assert got["bbox"].keys() == want["bbox"].keys()
    for k, v in want["bbox"].items():
        assert np.isnan(v) == np.isnan(got["bbox"][k]) and (np.isnan(v) or abs(v - got["bbox"][k]) < 1e-3), k
    ev = FLIREvaluator(os.path.join(flir_root, flir.VAL_JSON_NAME))
    for img_id, anns in ev.coco.img_to_anns.items():
        xywh = np.array([a["bbox"] for a in anns])
        ev.process(img_id, np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], 1),
                   np.ones(len(anns)), np.array([a["category_id"] - 1 for a in anns]))
    assert ev.evaluate()["bbox"]["AP"] == 100.0


def test_command_line_proben_and_load_params(flir_root, saved, capsys, monkeypatch, tmp_path):
    out, files = saved
    res = flir.main(["proben", "--dataset_path", flir_root, "--prediction_path", out["torch"],
                     "--score_fusion", "max", "--box_fusion", "argmax", "--outfolder", out["torch"]])
    _equal_results(res, flir.run_proben(flir_root, out["torch"], "max", "argmax", out["torch"]))
    assert "'bbox'" in capsys.readouterr().out
    cfg = _tiny_cfg(flir, "thermal_only")
    assert set(flir.load_params(cfg, "")) == {"backbone", "fpn", "rpn_head", "roi"}
    with pytest.raises(FileNotFoundError):
        flir.load_params(cfg, str(tmp_path / "model_final.pth"))
    params = _params("thermal_only")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in chip_smoke.d2_state_dict(params).items()}},
               str(tmp_path / "model_final.pth"))
    loaded = flir.load_params(cfg, str(tmp_path / "model_final.pth"))
    assert set(loaded) == set(params)
    np.testing.assert_array_equal(loaded["roi"]["box_head"]["fcs"][0]["w"], params["roi"]["box_head"]["fcs"][0]["w"])
    with pytest.raises(FileNotFoundError, match=">=2"):
        flir.run_proben(flir_root, out["torch"], det_files=files["torch"][:1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        flir.save_predictions("thermal_only", flir_root, "", out["torch"], cfg=cfg,
                              params=_params("thermal_only"))


def test_draw_writes_both_overlays_as_jax_draws_them(flir_root, tmp_path, monkeypatch):
    """``draw_predictions`` (``apps/flir.py draw``, the counterpart of
    ``demo/FLIR/demo_draw_FLIR.py``) on the CPU, tiny R50, one image per
    batch: for every image its thermal overlay, and its RGB overlay where
    the RGB file exists, each equal to JAX's ``Visualizer`` drawing the
    same detections on the frames the JAX demo reads (cv2's read, the RGB
    resized to the thermal frame by cv2) and saved alike: the same file
    bytes. The command line
    reaches it with the demo's arguments."""
    import shutil

    from proben_tpu.utils.visualizer import Visualizer as JaxVisualizer
    from proben_tpu_torch.config import mapper_config_from_cfg, model_config_from_cfg
    from proben_tpu_torch.data import DatasetCatalog, DatasetMapper, MetadataCatalog, build_test_loader
    from proben_tpu_torch.engine import Predictor
    from proben_tpu_torch.models import build_model

    root = tmp_path / "tree"
    shutil.copytree(flir_root, root)
    os.remove(root / "RGB" / "FLIR_00001.jpg")  # that image gets its thermal overlay only
    cfg = _tiny_cfg(flir, "thermal_only")
    params = _params("thermal_only")
    out = tmp_path / "draw"
    written = flir.draw_predictions("thermal_only", str(root), "", str(out), max_images=3, cfg=cfg,
                                    params=params, device="cpu")
    names = ["FLIR_00000.jpeg", "FLIR_00001.jpeg", "FLIR_00002.jpeg"]
    assert written == [str(out / f"{p}{n}") for n in names for p in ("thermal_", "rgb_")
                       if not (p == "rgb_" and n == "FLIR_00001.jpeg")]
    mcfg = model_config_from_cfg(cfg)
    predictor = Predictor(build_model(mcfg, params=params, device="cpu"), mcfg, "cpu")
    meta = MetadataCatalog.get("FLIR_draw")
    loader = build_test_loader(DatasetCatalog.get("FLIR_draw"),
                               DatasetMapper(mapper_config_from_cfg(cfg), is_train=False, device="cpu"),
                               batch_size=1)
    drawn = 0
    for batch in loader:
        rec = predictor.predict_batch(batch)[0]
        drawn += len(rec["boxes"])
        thermal_path = batch["file_name"][0]
        thermal = cv2.imread(thermal_path)
        frames = [("thermal_", thermal)]
        rgb = cv2.imread(thermal_path.replace("thermal_8_bit", "RGB").replace(".jpeg", ".jpg"))
        if rgb is not None:
            frames.append(("rgb_", cv2.resize(rgb, (thermal.shape[1], thermal.shape[0]))))
        for prefix, image in frames:
            name = prefix + os.path.basename(thermal_path)
            JaxVisualizer(image, meta).draw_instance_predictions(rec).save(str(tmp_path / name))
            assert (out / name).read_bytes() == (tmp_path / name).read_bytes(), name
    assert drawn > 0

    seen = []
    monkeypatch.setattr(flir, "draw_predictions", lambda *a, **kw: seen.append((a, kw)) or ["x"])
    res = flir.main(["draw", "--dataset_path", str(root), "--fusion_method", "middle_fusion",
                     "--outfolder", str(out), "--max_images", "2", "--device", "cpu"])
    assert res == {"written": ["x"]}
    assert seen == [(("middle_fusion", str(root), "", str(out), 2), {"device": "cpu"})]


ENSEMBLE = ("thermal_only", "early_fusion", "middle_fusion")


def test_ensemble_evaluates_the_members_fused_on_their_channels(flir_root, tmp_path):
    """``evaluate_proben`` (ProbEn3 through ``ProbEnPredictor`` and
    ``inference_on_dataset``, one BGRTTT loader) gives the FLIR results of
    the members run each on its own loader (``save_predictions``, the JSON
    path's frames), padded in the same slots and fused by
    ``fuse_detections_torch``: on the CPU both read the same pixels, so
    the results are equal."""
    from proben_tpu_torch.config import model_config_from_cfg
    from proben_tpu_torch.fusion import fuse_detections_torch
    from proben_tpu_torch.models import init_rcnn
    from proben_tpu_torch.structures.detections import pad_detections_numpy

    cfgs = [_tiny_cfg(flir, m) for m in ENSEMBLE]
    params = [init_rcnn(11 + i, model_config_from_cfg(c)) for i, c in enumerate(cfgs)]
    got = flir.evaluate_proben(flir_root, [(m, "") for m in ENSEMBLE], "probEn", "v-avg", str(tmp_path / "ens"),
                               batch_size=2, cfgs=cfgs, params=params, device="cpu")
    saved = []
    for m, c, p in zip(ENSEMBLE, cfgs, params):
        with open(flir.save_predictions(m, flir_root, "", str(tmp_path / "json"), batch_size=2, cfg=c, params=p,
                                        device="cpu")) as f:
            saved.append(json.load(f))
    slots = cfgs[0].TEST.DETECTIONS_PER_IMAGE
    ev = FLIREvaluator(os.path.join(flir_root, flir.VAL_JSON_NAME), output_dir=str(tmp_path / "direct"))
    ev.reset()
    for i, image_id in enumerate(saved[0]["image_id"]):
        members = [pad_detections_numpy(np.asarray(s["boxes"][i], np.float32).reshape(-1, 4),
                                        np.asarray(s["scores"][i], np.float32), np.asarray(s["classes"][i]), slots,
                                        probs=np.asarray(s["probs"][i], np.float32).reshape(-1, 3),
                                        variance=np.asarray(s["vars"][i], np.float32)) for s in saved]
        assert all(int(d.valid.sum()) == slots for d in members)
        cat = {k: torch.cat([getattr(d, k)[None] for d in members], 1)
               for k in ("boxes", "scores", "classes", "probs", "variance", "valid")}
        boxes, scores, classes, valid = fuse_detections_torch(
            cat["boxes"], cat["scores"], cat["classes"], cat["probs"], cat["variance"], cat["valid"])
        ev.process(image_id, boxes[0][valid[0]].numpy(), scores[0][valid[0]].numpy(), classes[0][valid[0]].numpy())
    _equal_results(got, ev.evaluate())
    assert got["bbox"].keys() >= {"AP", "AP50"}


def test_command_line_ensemble(flir_root, capsys, monkeypatch, tmp_path):
    """``python -m proben_tpu_torch.apps.flir ensemble --models method=path ...``
    runs ``evaluate_proben`` with ``build_flir_cfg`` and ``load_params``
    (here the tiny configuration, random weights from seed 0)."""
    original = types.SimpleNamespace(build_flir_cfg=flir.build_flir_cfg)
    monkeypatch.setattr(flir, "build_flir_cfg", lambda method: _tiny_cfg(original, method))
    res = flir.main(["ensemble", "--dataset_path", flir_root, "--models"] + [f"{m}=" for m in ENSEMBLE]
                    + ["--score_fusion", "avg", "--box_fusion", "s-avg", "--outfolder", str(tmp_path / "cli"),
                       "--device", "cpu"])
    assert "'bbox'" in capsys.readouterr().out
    cfgs = [flir.build_flir_cfg(m) for m in ENSEMBLE]
    want = flir.evaluate_proben(flir_root, [(m, "") for m in ENSEMBLE], "avg", "s-avg", str(tmp_path / "api"),
                                cfgs=cfgs, params=[flir.load_params(c, "") for c in cfgs], device="cpu")
    _equal_results(res, want)
    with pytest.raises(ValueError, match="input sizes"):
        other = flir.build_flir_cfg("thermal_only")
        other.INPUT.MIN_SIZE_TEST = 128
        flir.evaluate_proben(flir_root, [("thermal_only", ""), ("early_fusion", "")], cfgs=[other, cfgs[1]],
                             params=[None, None], device="cpu")
