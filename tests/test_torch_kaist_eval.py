"""The port's KAIST LAMR evaluator (``proben_tpu_torch/evaluation/kaist.py``)
against ``proben_tpu.evaluation.kaist``: the hand-made cases of
``tests/test_kaist_eval.py`` and seeded random cases like those of
``tests/test_kaist_eval_crosscheck.py``. Both are the same numpy arithmetic
on the same inputs, so every result is an equal float (NaN where JAX has
NaN), and the det txt both write is the same bytes."""

import json
import logging

import numpy as np
import pytest

from proben_tpu.evaluation import kaist as jax_kaist
from proben_tpu_torch.evaluation import kaist
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)


def _img(i, set_num=6):
    return {"id": i, "im_name": f"set{set_num:02d}_V000_I{i:05d}_lwir.png", "height": 512, "width": 640}


def _gt(img, bbox, cat=1, occ=0, ignore=0):
    return {"image_id": img, "category_id": cat, "bbox": list(bbox), "height": bbox[3],
            "occlusion": occ, "ignore": ignore}


CASES = {
    "perfect": ([_img(1), _img(2)], [_gt(1, [10, 10, 30, 80]), _gt(2, [50, 50, 30, 80])],
                {1: [[10, 10, 30, 80, 0.9]], 2: [[50, 50, 30, 80, 0.8]]}),
    "half_missed": ([_img(1)], [_gt(1, [10, 10, 30, 80]), _gt(1, [200, 10, 30, 80])],
                    {1: [[10, 10, 30, 80, 0.9]]}),
    "false_positives": ([_img(1)], [_gt(1, [10, 10, 30, 80])],
                        {1: [[300 + 40 * k, 300, 30, 80, 0.99 - 0.01 * k] for k in range(3)]
                         + [[10, 10, 30, 80, 0.5]]}),
    "small_gt_ignored": ([_img(1)], [_gt(1, [10, 10, 15, 30]), _gt(1, [100, 100, 30, 80])],
                         {1: [[10, 10, 15, 30, 0.95], [100, 100, 30, 80, 0.9]]}),
    "cyclist_ignore_region": ([_img(1)], [_gt(1, [10, 10, 30, 80], cat=2), _gt(1, [100, 100, 30, 80])],
                              {1: [[10, 10, 30, 80, 0.95], [100, 100, 30, 80, 0.9]]}),
    "heavy_occlusion": ([_img(1)], [_gt(1, [10, 10, 30, 80], occ=2)], {1: np.zeros((0, 5))}),
    "day_night": ([_img(1, 6), _img(2, 9)], [_gt(1, [10, 10, 30, 80]), _gt(2, [10, 10, 30, 80])],
                  {1: [[10, 10, 30, 80, 0.9]], 2: np.zeros((0, 5))}),
    "nothing_detected": ([_img(1), _img(2, 10)], [_gt(1, [10, 10, 30, 80])], {}),
    "tied_scores": ([_img(1), _img(2, 11)], [_gt(1, [10, 10, 30, 80]), _gt(2, [60, 10, 30, 80])],
                    {1: [[10, 10, 30, 80, 0.7], [300, 10, 30, 80, 0.7]],
                     2: [[60, 12, 30, 80, 0.7], [61, 12, 30, 80, 0.7]]}),
}


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert (isinstance(a[k], float) and np.isnan(a[k]) and np.isnan(b[k])) or a[k] == b[k], (k, a[k], b[k])


def _both(ann, dets):
    dets = {k: np.asarray(v, float).reshape(-1, 5) for k, v in dets.items()}
    evs = jax_kaist.KAISTEvaluator(ann), kaist.KAISTEvaluator(ann)
    assert evs[0].conditions == evs[1].conditions
    for cond in ("all", "day", "night"):
        _equal(evs[1].evaluate(dets, cond), evs[0].evaluate(dets, cond))
    _equal(evs[1].evaluate_all_conditions(dets), evs[0].evaluate_all_conditions(dets))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cases_match_jax(case):
    images, annotations, dets = CASES[case]
    _both({"images": images, "annotations": annotations}, dets)


def _random_case(rng, n_img=12, sets=(6, 7, 8, 9, 10, 11)):
    """``tests/test_kaist_eval_crosscheck.py::_random_case``'s recipe, over
    all six test sets: heights on both sides of 55, occlusion 0/1/2,
    ignore flags, a non-person category, jittered true positives and pure
    false positives (some with tied scores)."""
    images, annotations, detections = [], [], {}
    for i in range(n_img):
        s = sets[rng.randint(len(sets))]
        images.append({"id": i, "im_name": f"set{s:02d}_V000_I{i:05d}_lwir.png", "height": 512, "width": 640})
        for _ in range(rng.randint(0, 4)):
            h = float(rng.choice([30, 54, 55, 80, 120]))
            x, y = rng.rand(2) * 400
            annotations.append({"image_id": i, "category_id": int(rng.choice([1, 1, 1, 2])),
                                "bbox": [float(x), float(y), h * 0.41, h], "height": h,
                                "occlusion": int(rng.choice([0, 0, 1, 2])), "ignore": int(rng.rand() < 0.15)})
        dets = []
        for a in annotations:
            if a["image_id"] != i or rng.rand() < 0.3:
                continue
            bx, by, bw, bh = a["bbox"]
            jitter = (rng.rand(4) - 0.5) * np.array([8, 8, 6, 10])
            dets.append([bx + jitter[0], by + jitter[1], max(bw + jitter[2], 4), max(bh + jitter[3], 8),
                         rng.rand()])
        for _ in range(rng.randint(0, 3)):
            x, y = rng.rand(2) * 500
            dets.append([x, y, 20 + rng.rand() * 30, 50 + rng.rand() * 60, round(rng.rand(), 1)])
        if dets:
            detections[i] = np.array(dets, np.float64)
    return {"images": images, "annotations": annotations}, detections


@pytest.mark.parametrize("seed", range(4))
def test_random_cases_match_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(10):
        _both(*_random_case(rng))


def test_constants_and_conditions_match_jax():
    np.testing.assert_array_equal(kaist.FPPI_REFS, jax_kaist.FPPI_REFS)
    assert (kaist.REASONABLE_HEIGHT, kaist.REASONABLE_OCCLUSION) == (
        jax_kaist.REASONABLE_HEIGHT, jax_kaist.REASONABLE_OCCLUSION)
    for name in ("set06_V000_I00001_lwir.png", "set08_V001_I00002", "set09_V000_I1.png",
                 "set11/V000/I00003", "images/set10_V002_I00004_visible.png", "no_set_here.png", "setXY_V0"):
        assert kaist._condition_of(name) == jax_kaist._condition_of(name), name


def test_det_txt_same_bytes_and_round_trip(tmp_path):
    rng = np.random.RandomState(5)
    image_ids = [11, 22, 33, 44]
    dets = {11: rng.rand(3, 5).astype(np.float32) * 300, 33: np.zeros((0, 5)),
            44: rng.rand(2, 5) * 300, 99: rng.rand(1, 5)}  # 99: not in the list, not written
    paths = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    jax_kaist.save_detections_txt(paths[0], dets, image_ids)
    kaist.save_detections_txt(paths[1], dets, image_ids)
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        want, got = f.read(), g.read()
    assert got == want and len(got) > 0
    with open(paths[1], "a") as f:
        f.write("\n9,1.0,2.0,3.0,4.0,0.5\n")  # a frame beyond the list: dropped on reading
    a, b = jax_kaist.load_detections_txt(paths[1], image_ids), kaist.load_detections_txt(paths[1], image_ids)
    assert a.keys() == b.keys() == {11, 44}
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])
        np.testing.assert_array_equal(b[k], np.asarray(dets[k], float))


def _logged(name, fn, *args):
    """INFO messages ``fn(*args)`` sends to logger ``name`` (a handler of
    its own, whatever the logger's propagation)."""
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    logger = logging.getLogger(name)
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        fn(*args)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return [r.getMessage() for r in records]


def test_build_evaluator_and_testing_match_jax(tmp_path):
    """``build_evaluator`` picks the same evaluator as JAX's for the kaist,
    flir, coco and lvis types;
    ``verify_results`` gives the same verdicts, ``print_csv_format`` the
    same lines."""
    from proben_tpu.config import get_cfg as jax_get_cfg
    from proben_tpu.data import MetadataCatalog as JaxMetadataCatalog
    from proben_tpu.evaluation import testing as jax_testing
    from proben_tpu.evaluation.build import build_evaluator as jax_build_evaluator
    from proben_tpu_torch.config import get_cfg
    from proben_tpu_torch.data import MetadataCatalog
    from proben_tpu_torch.evaluation import build_evaluator, print_csv_format, verify_results

    images, annotations, dets = CASES["day_night"]
    kaist_json = tmp_path / "kaist.json"
    kaist_json.write_text(json.dumps({"images": images, "annotations": annotations}))
    coco_json = tmp_path / "coco.json"
    coco_json.write_text(json.dumps({
        "images": [{"id": 1, "file_name": "a.jpg", "height": 10, "width": 10}], "annotations": [],
        "categories": [{"id": 3, "name": "a"}, {"id": 9, "name": "b"}]}))
    for catalog in (MetadataCatalog, JaxMetadataCatalog):
        for name, path, etype in (("kaist_t", kaist_json, "kaist"), ("coco_t", coco_json, "coco"),
                                  ("flir_t", coco_json, "flir"), ("lvis_t", coco_json, "lvis"),
                                  ("odd_t", coco_json, "odd")):
            meta = catalog.get(name)
            meta.json_file, meta.evaluator_type = str(path), etype
    got, want = build_evaluator("kaist_t"), jax_build_evaluator("kaist_t")
    assert type(got).__name__ == type(want).__name__ == "KAISTEvaluator"
    d = {k: np.asarray(v, float).reshape(-1, 5) for k, v in dets.items()}
    _equal(got.evaluate_all_conditions(d), want.evaluate_all_conditions(d))
    for name in ("coco_t", "flir_t"):
        got, want = build_evaluator(name, str(tmp_path)), jax_build_evaluator(name, str(tmp_path))
        assert type(got).__name__ == type(want).__name__ == "FLIREvaluator"
        assert (got.valid_classes, got.class_remap, got.output_dir) == (
            want.valid_classes, want.class_remap, want.output_dir)
    got, want = build_evaluator("lvis_t"), jax_build_evaluator("lvis_t")
    assert type(got).__name__ == type(want).__name__ == "LVISEvaluator"
    with pytest.raises(ValueError, match="no evaluator"):
        build_evaluator("odd_t")

    results = {"bbox": {"AP": 41.5, "AP50": 60.0, "AP-person": 3.0}, "note": "x"}
    for expected in ([], [["bbox", "AP", 41.0, 1.0]], [["bbox", "AP", 40.0, 1.0]], [["bbox", "AR", 1.0, 1.0]]):
        cfgs = get_cfg(), jax_get_cfg()
        for c in cfgs:
            c.TEST.EXPECTED_RESULTS = expected
        assert verify_results(cfgs[0], results) == jax_testing.verify_results(cfgs[1], results)
    ours = _logged("proben_tpu_torch.evaluation.testing", print_csv_format, results)
    assert ours == _logged("proben_tpu.evaluation.testing", jax_testing.print_csv_format, results)
    assert ours == ["copypaste: Task: bbox", "copypaste: AP,AP50", "copypaste: 41.5000,60.0000"]
