"""The port's KAIST app (``proben_tpu_torch/apps/kaist.py``) against
``proben_tpu.apps.kaist`` on the CPU, on the synthetic KAIST tree and the
tiny R50 configuration of ``tests/test_kaist_app.py`` (3 frames, two in a
day set and one in a night set, 3-channel lwir and visible JPEGs of one
size, batch 2 so the last batch is padded), with the same numpy parameters
in both packages (JAX's ``init_rcnn``).

Tolerances, as ``tests/test_torch_flir_app.py``'s: the frames, their
detection counts and classes are equal; boxes to 2e-3 px, scores and
probabilities to 1e-4, logits to 1e-3, variances to rtol 1e-3 (the same f32
model in other summation orders). Boxes also get 1e-4 of the coordinate:
an f32 error in a predicted log-size moves a coordinate in proportion to
the box, and the middle-fusion model predicts boxes wider than the frame
(one, clipped to [0, 36.35] x [0, 128], differs by 2.1e-3 px). What follows the detections is the same
numpy code in both packages: given the same detections (JAX's), the LAMR
and ProbEn results are equal floats; from each package's own detections
they agree to 1e-6 points.
"""

import json
import os
import shutil

import cv2
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from proben_tpu.apps import kaist as jax_kaist
from proben_tpu.apps.flir import load_params as jax_load_params
from proben_tpu.config import model_config_from_cfg as jax_model_config_from_cfg
from proben_tpu.models import init_rcnn as jax_init_rcnn
from proben_tpu_torch.apps import kaist
from proben_tpu_torch.apps.flir import load_params
from proben_tpu_torch.data import read_image
from proben_tpu_torch.evaluation import KAISTEvaluator, load_detections_txt
from proben_tpu_torch.native import io
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

METHODS = ("thermal_only", "middle_fusion")


@pytest.fixture(scope="module")
def kaist_root(tmp_path_factory):
    """``tests/test_kaist_app.py``'s tree: 128x160 random JPEGs."""
    root = tmp_path_factory.mktemp("kaist_port")
    rng = np.random.RandomState(0)
    lines, images, annotations = [], [], []
    for i, (set_num, v) in enumerate([(6, 0), (6, 0), (9, 0)]):
        rel = f"set{set_num:02d}/V{v:03d}/I{i:05d}"
        lines.append(rel)
        for mod in ("lwir", "visible"):
            d = root / f"set{set_num:02d}" / f"V{v:03d}" / mod
            d.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(d / f"I{i:05d}.jpg"), rng.randint(0, 255, (128, 160, 3), np.uint8))
        images.append({"id": i + 1, "im_name": f"set{set_num:02d}_V{v:03d}_I{i:05d}_lwir.png",
                       "height": 128, "width": 160})
        annotations.append({"image_id": i + 1, "category_id": 1, "bbox": [30.0, 20.0, 25.0, 60.0],
                            "height": 60.0, "occlusion": 0, "ignore": 0})
    split = root / "test-all-20.txt"
    split.write_text("\n".join(lines) + "\n")
    ann = root / "KAIST_annotation.json"
    ann.write_text(json.dumps({"images": images, "annotations": annotations}))
    return {"root": str(root), "split": str(split), "ann": str(ann), "lines": lines}


def _tiny_cfg(mod, method):
    """``tests/test_kaist_app.py::_tiny_cfg`` for either package."""
    return _shrink(mod.build_kaist_cfg(method))


def _shrink(cfg):
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 32
    cfg.TEST.DETECTIONS_PER_IMAGE = 5
    cfg.INPUT.PAD_SHAPE = (192, 224)
    cfg.INPUT.MIN_SIZE_TEST = 160
    cfg.INPUT.MAX_SIZE_TEST = 224
    cfg.MODEL.ROI_ALIGN_IMPL = "gather"  # the JAX path's CPU speed; the port maps it to "plain"
    return cfg


def _params(method):
    cfg = _tiny_cfg(jax_kaist, method)
    key = jax.random.PRNGKey(METHODS.index(method) + 3)
    return jax.tree_util.tree_map(np.asarray, jax_init_rcnn(key, jax_model_config_from_cfg(cfg)))


@pytest.fixture(scope="module")
def predicted(kaist_root, tmp_path_factory):
    out = tmp_path_factory.mktemp("kaist_out")
    runs = {}
    for method in METHODS:
        params = _params(method)
        for name, mod, kw in (("jax", jax_kaist, {}), ("port", kaist, {"device": "cpu"})):
            txt, npz = str(out / f"{name}_{method}.txt"), str(out / f"{name}_{method}.npz")
            res = mod.predict_split(method, kaist_root["root"], kaist_root["split"], params,
                                    cfg=_tiny_cfg(mod, method), out_txt=txt, var_npz=npz, batch_size=2, **kw)
            runs[name, method] = dict(results=res, txt=txt, npz=npz)
    return runs


def _pairs(got, want):
    """(port index, JAX index) of each detection: the port's detection of
    the same class with the nearest box (tied scores may list in either
    order)."""
    assert len(got["boxes"]) == len(want["boxes"])
    free, pairs = set(range(len(got["boxes"]))), []
    for j, (box, cls) in enumerate(zip(want["boxes"], want["classes"])):
        k = min((k for k in free if got["classes"][k] == cls), key=lambda k: np.abs(got["boxes"][k] - box).max())
        free.remove(k)
        pairs.append((k, j))
    return pairs


@pytest.mark.parametrize("method", METHODS)
def test_predict_split_matches_jax(predicted, method):
    got, want = predicted["port", method]["results"], predicted["jax", method]["results"]
    assert sorted(got) == sorted(want) == [1, 2, 3]
    assert sum(len(r["scores"]) for r in got.values()) > 0
    for frame, w in want.items():
        g = got[frame]
        assert g["image_id"] == w["image_id"] == frame
        assert set(g) == set(w), (set(g), set(w))
        for k, j in _pairs(g, w):
            for key, tol in (("boxes", dict(atol=2e-3, rtol=1e-4)), ("scores", dict(atol=1e-4)),
                             ("probs", dict(atol=1e-4)),
                             ("class_logits", dict(atol=1e-3)), ("vars", dict(rtol=1e-3))):
                np.testing.assert_allclose(g[key][k], w[key][j], err_msg=f"{key} frame {frame}", **tol)
    with np.load(predicted["port", method]["npz"]) as a, np.load(predicted["jax", method]["npz"]) as b:
        assert sorted(a.files) == sorted(b.files) == ["1", "2", "3"]
        for k in b.files:
            assert a[k].shape == b[k].shape


@pytest.mark.parametrize("method", METHODS)
def test_det_txt_and_lamr_match_jax(predicted, kaist_root, method):
    """The port's txt holds its results exactly (float32 xywh), parses like
    JAX's, and LAMR all/day/night agree; the txt from the same detections is
    the same bytes."""
    port, jax_run = predicted["port", method], predicted["jax", method]
    ev = KAISTEvaluator(kaist_root["ann"])
    loaded = load_detections_txt(port["txt"], [1, 2, 3])
    for frame, rec in port["results"].items():
        b = rec["boxes"].copy()
        b[:, 2:] -= b[:, :2]
        np.testing.assert_array_equal(loaded[frame], np.concatenate([b, rec["scores"][:, None]], 1))
    want = jax_kaist.evaluate_lamr(kaist_root["ann"], jax_run["txt"])
    got = kaist.evaluate_lamr(kaist_root["ann"], port["txt"])
    assert got.keys() == want.keys() == {f"{m}_{c}" for m in ("lamr", "recall") for c in ("all", "day", "night")}
    for k in want:
        assert abs(got[k] - want[k]) < 1e-6 or (np.isnan(got[k]) and np.isnan(want[k])), (k, got[k], want[k])
    dets = kaist.results_to_lamr_dets(jax_run["results"], ev.image_ids)
    assert kaist.evaluate_lamr(kaist_root["ann"], dets) == jax_kaist.evaluate_lamr(kaist_root["ann"], dets)
    with open(jax_run["txt"], "rb") as f:
        jax_txt = f.read()
    same = os.path.join(os.path.dirname(port["txt"]), f"same_{method}.txt")
    kaist.save_detections_txt(same, {
        fr: np.concatenate([r["boxes"][:, :2], r["boxes"][:, 2:] - r["boxes"][:, :2], r["scores"][:, None]], 1)
        for fr, r in jax_run["results"].items()}, [1, 2, 3])
    with open(same, "rb") as f:
        assert f.read() == jax_txt


def test_results_to_lamr_dets_skips_frames_beyond_the_annotation(predicted):
    res = predicted["jax", "thermal_only"]["results"]
    got, want = kaist.results_to_lamr_dets(res, [7, 8]), jax_kaist.results_to_lamr_dets(res, [7, 8])
    assert got.keys() == want.keys() == {7, 8}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("score,box", [("probEn", "v-avg"), ("avg", "avg"), ("max", "argmax")])
def test_run_kaist_proben_matches_jax(predicted, kaist_root, score, box):
    same = [predicted["jax", m]["results"] for m in METHODS]
    assert kaist.run_kaist_proben(same, kaist_root["ann"], score, box) == \
        jax_kaist.run_kaist_proben(same, kaist_root["ann"], score, box)
    got = kaist.run_kaist_proben([predicted["port", m]["results"] for m in METHODS], kaist_root["ann"], score, box)
    want = jax_kaist.run_kaist_proben(same, kaist_root["ann"], score, box)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-6 or (np.isnan(got[k]) and np.isnan(want[k])), (k, got[k], want[k])


@pytest.fixture(scope="module")
def d2_file(tmp_path_factory):
    """JAX's tiny thermal parameters as a detectron2 ``.pth``
    (``chip_smoke.d2_state_dict``: names, OIHW, NCHW fc1 rows, BatchNorm
    statistics)."""
    params = _params("thermal_only")
    path = str(tmp_path_factory.mktemp("d2") / "model_final.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in chip_smoke.d2_state_dict(params).items()}}, path)
    return params, path


def test_load_params_from_pth_end_to_end(d2_file, kaist_root):
    """The file loads in both packages to the same tree, within an ulp of
    the source; predictions from it equal predictions from the source
    parameters to the tolerances above."""
    params, path = d2_file
    got = load_params(_tiny_cfg(kaist, "thermal_only"), path)
    want = jax.tree_util.tree_map(np.asarray, jax_load_params(_tiny_cfg(jax_kaist, "thermal_only"), path))
    fg, fw, fs = chip_smoke.flat_tree(got), chip_smoke.flat_tree(want), chip_smoke.flat_tree(params)
    assert fg.keys() == fw.keys() == fs.keys()
    for k in fs:
        assert fg[k].dtype == fw[k].dtype and np.array_equal(fg[k], fw[k]), k
        np.testing.assert_allclose(fg[k], fs[k], rtol=1e-6, atol=0, err_msg=k)
    cfg = _tiny_cfg(kaist, "thermal_only")
    a = kaist.predict_split("thermal_only", kaist_root["root"], kaist_root["split"], got, cfg=cfg, batch_size=2,
                            device="cpu")
    b = kaist.predict_split("thermal_only", kaist_root["root"], kaist_root["split"], params, cfg=cfg, batch_size=2,
                            device="cpu")
    for frame in b:
        for k, j in _pairs(a[frame], b[frame]):
            np.testing.assert_allclose(a[frame]["boxes"][k], b[frame]["boxes"][j], atol=2e-3)
            np.testing.assert_allclose(a[frame]["scores"][k], b[frame]["scores"][j], atol=1e-4)


def test_command_line(d2_file, kaist_root, tmp_path, monkeypatch, capsys):
    """``lamr`` and ``proben`` with the demos' arguments and ``--device
    cpu`` (the tiny configuration in place of the full R101 one) equal the
    functions they call; the default device needs a card."""
    _, path = d2_file
    full = kaist.build_kaist_cfg
    monkeypatch.setattr(kaist, "build_kaist_cfg", lambda method, gnll=True: _shrink(full(method, gnll)))
    common = ["--data_root", kaist_root["root"], "--split", kaist_root["split"], "--annotation", kaist_root["ann"]]
    out = str(tmp_path / "out")
    res = kaist.main(["lamr", *common, "--fusion_method", "thermal_only", "--model_path", path,
                      "--outfolder", out, "--device", "cpu"])
    assert "'lamr_all'" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "KAIST_thermal_only_dets.txt"))
    assert os.path.exists(os.path.join(out, "KAIST_thermal_only_vars.npz"))
    assert res == kaist.evaluate_lamr(kaist_root["ann"], os.path.join(out, "KAIST_thermal_only_dets.txt"))
    fused = kaist.main(["proben", *common, "--models", f"thermal_only={path}", f"rgb_only={path}",
                        "--score_fusion", "avg", "--box_fusion", "avg", "--device", "cpu"])
    assert set(fused) == set(res)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        kaist.main(["lamr", *common, "--model_path", path])
    with pytest.raises(RuntimeError, match="cuda"):  # training, too, defaults to the card
        kaist.train_kaist("thermal_only", "d", kaist_root["ann"], kaist_root["root"], kaist_root["split"], out)


def test_missing_frame_raises_naming_the_file(kaist_root, tmp_path):
    """Any missing input raises ``FileNotFoundError`` naming it, for every
    method (the JAX app's fused methods would fail with an AttributeError)."""
    root = str(tmp_path / "tree")
    shutil.copytree(kaist_root["root"], root)
    rel = kaist_root["lines"][1]
    set_num, v, img = rel.split("/")
    for mod, methods in (("visible", ("rgb_only", "early_fusion", "middle_fusion")), ("lwir", ("thermal_only",))):
        missing = os.path.join(root, set_num, v, mod, img + ".jpg")
        os.rename(missing, missing + ".bak")
        for method in methods:
            with pytest.raises(FileNotFoundError, match=f"{mod}/{img}"):
                kaist.predict_split(method, root, kaist_root["split"], None, cfg=_tiny_cfg(kaist, method),
                                    batch_size=2, device="cpu")
        os.rename(missing + ".bak", missing)


@pytest.mark.parametrize("fmt", ["BGR", "BGRT", "BGRTTT"])
def test_plain_compose_at_equal_frame_sizes_is_the_cv2_frame(kaist_root, fmt):
    """KAIST's visible and lwir frames have one size: the ``image_io`` plain
    version's uint8 RGB resize runs at scale 1 and must be the identity, so
    the composed frame equals the cv2 frame that the port's CPU reader
    makes of the method's files and JAX's ``_kaist_image`` (lwir channel 0
    for BGRT, all three for BGRTTT), bit for bit."""
    method = {"BGR": "thermal_only", "BGRT": "early_fusion", "BGRTTT": "middle_fusion"}[fmt]
    assert kaist.build_kaist_cfg(method).INPUT.FORMAT == fmt
    for rel in kaist_root["lines"]:
        lwir, visible = kaist.kaist_files(kaist_root["root"], rel, "middle_fusion")
        t = torch.from_numpy(cv2.imread(lwir))
        r = None if fmt == "BGR" else [torch.from_numpy(cv2.imread(visible))]
        hw = tuple(t.shape[:2])
        got = io.compose_resize_pad_plain([t], r, fmt, [hw], hw)[0].numpy()
        d = kaist.kaist_dicts(kaist_root["root"], [rel], method)[0]
        want = read_image(d["file_name"], fmt, device="cpu", rgb_file=d.get("rgb_file"))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(want, jax_kaist._kaist_image(kaist_root["root"], rel, method))


def test_uint8_resize_is_the_identity_at_scale_one():
    """``resize_u8_cv2`` at equal sizes returns its input, edge rows and
    columns included, at KAIST's size and at odd sizes."""
    rng = np.random.RandomState(1)
    for h, w in ((512, 640), (33, 47), (1, 5), (7, 1)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        out = io.resize_u8_cv2(torch.from_numpy(img), h, w)
        np.testing.assert_array_equal(out.numpy(), img.astype(np.float32))
        np.testing.assert_array_equal(cv2.resize(img, (w, h)), img)
