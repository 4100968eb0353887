"""The port's other evaluators against ``proben_tpu``'s: COCO RLE
(``evaluation/rle.py``), the segm task of ``cocoeval.py``, Pascal VOC, LVIS,
Cityscapes (the official writer and the native mask-AP scorer), semantic
segmentation, panoptic quality, ``build.py::_rasterize_polygons`` and
``structures/detections.py::pad_detections_numpy``.

Each case feeds the same seeded numpy inputs to both packages. The port's
modules are copies of the same numpy arithmetic, so every float is equal
(NaN where JAX has NaN), every RLE string and every written file the same
bytes, and every PNG the same pixels; no tolerance is used."""

import json
import math

import cv2
import numpy as np
import pytest

from proben_tpu.evaluation import build as jax_build
from proben_tpu.evaluation import cityscapes as jax_cityscapes
from proben_tpu.evaluation import cocoeval as jax_cocoeval
from proben_tpu.evaluation import lvis as jax_lvis
from proben_tpu.evaluation import panoptic as jax_panoptic
from proben_tpu.evaluation import pascal_voc as jax_voc
from proben_tpu.evaluation import rle as jax_rle
from proben_tpu.evaluation import sem_seg as jax_sem_seg
from proben_tpu.structures import detections as jax_detections
from proben_tpu_torch.evaluation import build, cityscapes, cocoeval, lvis, panoptic, pascal_voc, rle, sem_seg
from proben_tpu_torch.structures import detections
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)


def _equal(a, b):
    """Recursive equality of results: same keys, same types' names, equal
    floats with NaN equal to NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (a, b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, np.asarray(b))
    else:
        assert a == b and type(a).__name__ == type(b).__name__, (a, b)


def _masks(rng, n, h, w):
    """``n`` binary masks: random rectangles with random holes and specks,
    one all-ones and one all-zeros mask among them when n > 2."""
    out = []
    for i in range(n):
        m = np.zeros((h, w), np.uint8)
        y0, x0 = rng.randint(0, h // 2 + 1), rng.randint(0, w // 2 + 1)
        m[y0:y0 + rng.randint(1, h // 2 + 2), x0:x0 + rng.randint(1, w // 2 + 2)] = 1
        m[rng.rand(h, w) < 0.05] ^= 1
        out.append(m)
    if n > 2:
        out[1][:] = 1
        out[2][:] = 0
    return out


# -- RLE ------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (17, 23), (64, 48)])
def test_rle_strings_and_iou_match_jax(shape):
    rng = np.random.RandomState(sum(shape))
    masks = _masks(rng, 6, *shape)
    masks[0][0, 0] = 1  # a mask that starts with a run of ones
    ours = [rle.encode(m) for m in masks]
    theirs = [jax_rle.encode(m) for m in masks]
    for m, a, b in zip(masks, ours, theirs):
        assert a == b and a["counts"].encode() == b["counts"].encode()
        np.testing.assert_array_equal(rle.decode(a), m)
        assert rle.area(a) == jax_rle.area(b) == int(m.sum())
        np.testing.assert_array_equal(rle.to_bbox(a), jax_rle.to_bbox(b))
        assert rle._decompress(a["counts"].encode()) == jax_rle._decompress(b["counts"])
    crowd = rng.rand(len(masks)) < 0.3
    np.testing.assert_array_equal(rle.iou(ours, ours[::-1], crowd), jax_rle.iou(theirs, theirs[::-1], crowd))


# -- cocoeval, segm -------------------------------------------------------------


def _segm_case(rng, mod_rle, n_img=4, n_cat=3, h=24, w=32):
    gts, dts = [], []
    for img in range(n_img):
        for m in _masks(rng, 4, h, w):
            if not m.any():
                continue
            cat = int(rng.randint(n_cat))
            gts.append({"image_id": img, "category_id": cat, "segmentation": mod_rle.encode(m),
                        "bbox": [0.0] * 4, "iscrowd": int(rng.rand() < 0.15)})
            shifted = np.roll(m, (rng.randint(-2, 3), rng.randint(-2, 3)), (0, 1))
            dts.append({"image_id": img, "category_id": cat if rng.rand() < 0.8 else int(rng.randint(n_cat)),
                        "segmentation": mod_rle.encode(shifted), "bbox": [0.0] * 4,
                        "score": float(rng.rand())})
    return gts, dts


def test_cocoeval_segm_matches_jax():
    results = []
    for cls, mod_rle in ((cocoeval.COCOEvaluator, rle), (jax_cocoeval.COCOEvaluator, jax_rle)):
        gts, dts = _segm_case(np.random.RandomState(3), mod_rle)
        ev = cls(gts, range(4), range(3), iou_type="segm")
        results.append((ev.evaluate(dts), ev.per_category_ap(), ev.eval["precision"]))
    _equal(results[0][:2], results[1][:2])
    np.testing.assert_array_equal(results[0][2], results[1][2])
    with pytest.raises(ValueError, match="iou_type"):
        cocoeval.COCOEvaluator([], [], [], iou_type="keypoints")


# -- Pascal VOC -----------------------------------------------------------------


def test_voc_ap_matches_jax():
    rng = np.random.RandomState(5)
    for n in (1, 7, 40):
        recall = np.sort(rng.rand(n))
        precision = rng.rand(n)
        for use_07 in (True, False):
            assert pascal_voc.voc_ap(recall, precision, use_07) == jax_voc.voc_ap(recall, precision, use_07)


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_evaluator_matches_jax(use_07):
    classes = ["a", "b", "c", "d"]
    evs = [pascal_voc.PascalVOCDetectionEvaluator(classes, use_07),
           jax_voc.PascalVOCDetectionEvaluator(classes, use_07)]
    rng = np.random.RandomState(6)
    for img in range(6):
        n = rng.randint(1, 6)
        xy = rng.rand(n, 2) * 80
        gt = np.concatenate([xy, xy + 10 + rng.rand(n, 2) * 40], 1)
        cls = rng.randint(0, 3, n)  # class "d" has no ground truth
        difficult = rng.rand(n) < 0.25
        det = np.concatenate([gt + rng.randn(n, 4) * 3, rng.rand(3, 4) * 60 + [0, 0, 60, 60]])
        det_cls = np.concatenate([cls, rng.randint(0, 4, 3)])
        scores = rng.rand(len(det))
        for ev in evs:
            ev.add_ground_truth(f"im{img}", gt, cls, difficult)
            ev.process(f"im{img}", det, scores, det_cls)
    _equal(evs[0].evaluate(), evs[1].evaluate())


# -- LVIS -----------------------------------------------------------------------


def _lvis_data(rng, n_img=8, n_cat=12):
    cats = [{"id": c + 1, "name": f"c{c}", "frequency": "rcf"[c % 3]} for c in range(n_cat)]
    images, anns = [], []
    for i in range(n_img):
        present = sorted(rng.choice(n_cat, 3, replace=False) + 1)
        absent = [c for c in range(1, n_cat + 1) if c not in present]
        images.append({"id": i + 1, "height": 120, "width": 160,
                       "neg_category_ids": [int(c) for c in rng.choice(absent, 3, replace=False)],
                       "not_exhaustive_category_ids": [int(present[0])]})
        for c in present:
            for _ in range(rng.randint(1, 3)):
                xy = rng.rand(2) * 100
                anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": int(c),
                             "bbox": [float(xy[0]), float(xy[1]), float(8 + rng.rand() * 50),
                                      float(8 + rng.rand() * 50)]})
    return {"images": images, "annotations": anns, "categories": cats}


def test_lvis_matches_jax(tmp_path):
    rng = np.random.RandomState(7)
    data = _lvis_data(rng)
    dets = []  # jittered gt, wrong classes and spurious boxes, model (0-based) classes
    for a in data["annotations"]:
        x, y, w, h = np.asarray(a["bbox"]) + rng.randn(4) * 2
        c = a["category_id"] - 1 if rng.rand() < 0.8 else int(rng.randint(12))
        dets.append((a["image_id"], [x, y, x + w, y + h], float(rng.rand()), c))
    for i in range(1, 9):
        for _ in range(4):
            xy = rng.rand(2) * 100
            dets.append((i, [xy[0], xy[1], xy[0] + 20, xy[1] + 30], float(rng.rand()), int(rng.randint(12))))
    out = []
    for mod, coco_mod in ((lvis, cocoeval), (jax_lvis, jax_cocoeval)):
        ev = mod.LVISEvaluator(data, output_dir=str(tmp_path / mod.__name__))
        ev.reset()
        for img, box, s, c in dets:
            ev.process(img, [box], [s], [c])
        out.append(ev.evaluate())
        # the federated core at a small per-image cap
        core = mod.LVISEval(data["annotations"], data["images"], data["categories"],
                            params=coco_mod.EvalParams(max_dets=(5,)))
        out.append(core.evaluate([{"image_id": img, "category_id": c + 1, "score": s,
                                   "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]]}
                                  for img, b, s, c in dets]))
    _equal(out[:2], out[2:])
    written = [(tmp_path / m.__name__ / "lvis_predictions.json").read_bytes() for m in (lvis, jax_lvis)]
    assert written[0] == written[1] and len(json.loads(written[0])) == len(dets)


# -- Cityscapes -------------------------------------------------------------------


def test_cityscapes_writer_and_scorer_match_jax(tmp_path):
    """The official files (``{stem}_pred.txt`` the same bytes, each mask PNG
    the same pixels) and the native mask AP, with a ground-truth region
    below ``min_region_size``."""
    rng = np.random.RandomState(8)
    h, w = 40, 64
    out = []
    for mod in (cityscapes, jax_cityscapes):
        rng = np.random.RandomState(8)
        ev = mod.CityscapesInstanceEvaluator(str(tmp_path / mod.__name__), min_region_size=30)
        for stem in ("frankfurt_000000_000294", "munich_000001_000019"):
            gt = [m for m in _masks(rng, 5, h, w) if m.any()]
            tiny = np.zeros((h, w), np.uint8)
            tiny[1:4, 1:5] = 1  # 12 px, ignored
            gt_cls = rng.randint(0, 8, len(gt) + 1)
            ev.add_ground_truth(stem, gt + [tiny], gt_cls)
            pred = [np.roll(m, rng.randint(-2, 3), 1) for m in gt] + [tiny] + _masks(rng, 2, h, w)
            cls = np.concatenate([gt_cls, rng.randint(0, 8, 2)])
            ev.process(stem, pred, rng.rand(len(pred)), cls)
        out.append(ev.evaluate())
    _equal(out[0], out[1])
    assert 0 < out[0]["segm"]["AP"] < 100
    ours, theirs = tmp_path / cityscapes.__name__, tmp_path / jax_cityscapes.__name__
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in theirs.iterdir()) and len(names) > 2
    for name in names:
        if name.endswith(".txt"):
            assert (ours / name).read_bytes() == (theirs / name).read_bytes()
        else:
            a = cv2.imread(str(ours / name), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(a, cv2.imread(str(theirs / name), cv2.IMREAD_UNCHANGED))
    assert cityscapes.CITYSCAPES_THING_CLASSES == jax_cityscapes.CITYSCAPES_THING_CLASSES
    assert cityscapes.CITYSCAPES_NAME2LABELID == jax_cityscapes.CITYSCAPES_NAME2LABELID


def test_rasterize_polygons_matches_jax():
    """Pillow's polygon fill, rectangles and slanted polygons with
    fractional vertices, some past the image's edge."""
    rng = np.random.RandomState(9)
    for _ in range(6):
        polys = [list((rng.rand(rng.randint(3, 7), 2) * [70, 50] - 5).round(1).ravel())
                 for _ in range(rng.randint(1, 3))]
        polys.append([10, 20, 30, 20, 30, 35, 10, 35])
        np.testing.assert_array_equal(build._rasterize_polygons(polys, 48, 64),
                                      jax_build._rasterize_polygons(polys, 48, 64))


# -- semantic segmentation and panoptic quality -------------------------------------


def test_sem_seg_matches_jax(tmp_path):
    out = []
    for mod in (sem_seg, jax_sem_seg):
        rng = np.random.RandomState(10)
        ev = mod.SemSegEvaluator(5, ignore_label=255, output_dir=str(tmp_path / mod.__name__),
                                 contiguous_id_to_dataset_id={i: 10 + 3 * i for i in range(5)})
        for i in range(4):
            gt = rng.randint(0, 5, (12, 16))
            gt[rng.rand(12, 16) < 0.1] = 255
            logits = rng.randn(5, 12, 16) if i % 2 else rng.randn(12, 16, 5)
            pred = logits if i < 2 else np.where(rng.rand(12, 16) < 0.7, gt % 255 % 5, rng.randint(0, 5, (12, 16)))
            ev.process(pred, gt, file_name=f"img{i}.png")
        out.append(ev.evaluate())
    _equal(out[0], out[1])
    files = [(tmp_path / m.__name__ / "sem_seg_predictions.json").read_bytes() for m in (sem_seg, jax_sem_seg)]
    assert files[0] == files[1]


def _panoptic_case(rng, h=20, w=24):
    gt = np.zeros((h, w), np.int64)
    gt_segs = []
    for sid in range(1, 6):
        y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
        gt[y:y + rng.randint(3, 10), x:x + rng.randint(3, 10)] = sid
        gt_segs.append({"id": sid, "category_id": int(rng.randint(1, 4)), "iscrowd": int(sid == 5)})
    pred = np.where(rng.rand(h, w) < 0.85, gt, 0)
    pred = np.where(pred > 0, pred + 10, 0)
    pred[rng.randint(0, h - 3):, :3] = 30  # a spurious segment
    pred_segs = [{"id": s["id"] + 10, "category_id": s["category_id"] - 1, "isthing": s["id"] % 2 == 1}
                 for s in gt_segs] + [{"id": 30, "category_id": 0, "isthing": True}]
    return gt, gt_segs, pred, pred_segs


def test_panoptic_matches_jax():
    thing_map, stuff_map = {0: 1, 1: 2, 2: 3}, {0: 1, 1: 2, 2: 3}
    out = []
    for mod in (panoptic, jax_panoptic):
        rng = np.random.RandomState(11)
        ev = mod.COCOPanopticEvaluator(thing_ids=[1, 3], stuff_ids=[2], thing_contiguous_to_dataset=thing_map,
                                       stuff_contiguous_to_dataset=stuff_map)
        stats = []
        for _ in range(4):
            gt, gt_segs, pred, pred_segs = _panoptic_case(rng)
            ev.process(gt, gt_segs, pred, pred_segs)
            raw = [dict(s, category_id=s["category_id"] + 1) for s in pred_segs]
            for s in raw:
                s.pop("isthing")
            st = mod.pq_compute_single(gt, gt_segs, pred, raw)
            stats.append({k: dict(getattr(st, k)) for k in ("iou", "tp", "fp", "fn")})
        acc = mod.PQStat()
        acc += st
        out.append((ev.evaluate(), stats, acc.pq_average()))
    _equal(out[0], out[1])


# -- padded detections ----------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 3, 12])
def test_pad_detections_numpy_matches_jax(n):
    rng = np.random.RandomState(n)
    args = (rng.rand(n, 4) * 100, rng.rand(n), rng.randint(0, 5, n), 8)
    kw = dict(probs=rng.rand(n, 5), class_logits=rng.randn(n, 6), variance=rng.rand(n))
    for extra in ({}, kw):
        ours = detections.pad_detections_numpy(*args, **extra)
        theirs = jax_detections.pad_detections_numpy(*args, **extra)
        for field in ("boxes", "scores", "classes", "valid", "probs", "class_logits", "variance"):
            a, b = getattr(ours, field), getattr(theirs, field)
            assert (a is None) == (b is None), field
            if a is not None:
                assert a.numpy().dtype == np.asarray(b).dtype, field
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
