"""The port's Pascal VOC, LVIS and Cityscapes loaders, ``load_sem_seg`` and
``register_all_builtin`` against ``proben_tpu``'s, the three splits through
each package's ``build_evaluator`` and ``inference_on_dataset``, the port's
``DefaultTrainer.test`` end to end on a VOC split, and the decode rule of
``native/io.py::load_batch``.

One synthetic tree in the builtin layouts (``VOC2007/``, ``lvis/`` over
``coco/val2017``, ``cityscapes/leftImg8bit`` PNGs with ``gtFine`` polygons),
written with cv2 from a seed, is registered under the builtin names in both
packages' catalogs. Loaders and evaluators are the same numpy code in both
packages: dicts, metadata and results are equal, floats exactly (NaN where
JAX has NaN)."""

import json
import math
import os

import cv2
import numpy as np
import pytest
import torch

from proben_tpu import data as jax_data
from proben_tpu.evaluation import build_evaluator as jax_build_evaluator
from proben_tpu.evaluation import inference_on_dataset as jax_inference_on_dataset
from proben_tpu_torch import data
from proben_tpu_torch.evaluation import build_evaluator, inference_on_dataset
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

VOC_CLASSES = data.pascal_voc.VOC_CLASS_NAMES
N_LVIS_CATS = 30
SPLITS = ("voc_2007_test", "lvis_v1_val", "cityscapes_fine_instance_seg_val")


def _builtin_names():
    return ([n for n in data.builtin._COCO_SPLITS] + [n for n in data.builtin._LVIS_SPLITS]
            + [s[0] for s in data.builtin._VOC_SPLITS] + [n for n in data.builtin._CITYSCAPES_SPLITS])


def _image(rng, h, w, boxes):
    """uint8 BGR (h, w, 3): a gradient, noise, a bright block per XYXY box."""
    img = np.stack([np.linspace(40, 110, w)[None, :].repeat(h, 0), np.full((h, w), 90.0),
                    np.linspace(170, 60, h)[:, None].repeat(w, 1)], -1) + rng.randn(h, w, 3) * 2
    for x0, y0, x1, y1 in boxes:
        img[int(y0):int(y1), int(x0):int(x1)] = 130 + 100 * rng.rand(3)
    return np.clip(img.round(), 0, 255).astype(np.uint8)


def _boxes(rng, h, w, n):
    xy = rng.randint(0, [w - 12, h - 12], (n, 2))
    wh = rng.randint(8, 24, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], 1)


def write_voc(root, rng, n=6, hw=(48, 64)):
    """VOC2007: JPEGs, XML with 1-based inclusive boxes and some
    ``difficult`` objects, the test and trainval lists."""
    base = os.path.join(root, "VOC2007")
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    ids = [f"{i:06d}" for i in range(1, n + 1)]
    for fid in ids:
        h, w = hw
        boxes = _boxes(rng, h, w, rng.randint(1, 4))
        cv2.imwrite(os.path.join(base, "JPEGImages", fid + ".jpg"), _image(rng, h, w, boxes))
        objs = "".join(
            f"<object><name>{VOC_CLASSES[rng.randint(20)]}</name><difficult>{int(rng.rand() < 0.3)}"
            f"</difficult><bndbox><xmin>{x0 + 1}</xmin><ymin>{y0 + 1}</ymin><xmax>{x1}</xmax>"
            f"<ymax>{y1}</ymax></bndbox></object>" for x0, y0, x1, y1 in boxes)
        with open(os.path.join(base, "Annotations", fid + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth></size>"
                    f"{objs}</annotation>")
    for split, sel in (("test", ids), ("trainval", ids[::2])):
        with open(os.path.join(base, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(sel) + "\n")


def write_lvis(root, rng, n=6, hw=(48, 64)):
    """lvis/lvis_v1_val.json over coco/val2017 JPEGs: categories with a
    frequency (one named only by its synonyms, as in v0.5), images located
    by ``coco_url``, ``neg_category_ids`` and ``not_exhaustive_category_ids``."""
    os.makedirs(os.path.join(root, "coco", "val2017"), exist_ok=True)
    os.makedirs(os.path.join(root, "lvis"), exist_ok=True)
    cats = [{"id": c + 1, "name": f"cat{c}", "frequency": "rcf"[c % 3]} for c in range(N_LVIS_CATS)]
    cats[4] = {"id": 5, "synonyms": ["abacus"], "frequency": "r"}
    images, anns = [], []
    for i in range(n):
        h, w = hw
        boxes = _boxes(rng, h, w, rng.randint(1, 4))
        img_id = 100 + 7 * i
        cv2.imwrite(os.path.join(root, "coco", "val2017", f"{img_id:012d}.jpg"), _image(rng, h, w, boxes))
        present = sorted({int(rng.randint(1, N_LVIS_CATS + 1)) for _ in boxes})
        absent = [c for c in range(1, N_LVIS_CATS + 1) if c not in present]
        images.append({"id": img_id, "height": h, "width": w,
                       "coco_url": f"http://images.cocodataset.org/val2017/{img_id:012d}.jpg",
                       "neg_category_ids": [int(c) for c in rng.choice(absent, 4, replace=False)],
                       "not_exhaustive_category_ids": present[:1]})
        for k, (x0, y0, x1, y1) in enumerate(boxes):
            anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": present[k % len(present)],
                         "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]})
    with open(os.path.join(root, "lvis", "lvis_v1_val.json"), "w") as f:
        json.dump({"images": images[::-1], "annotations": anns, "categories": cats}, f)


def write_cityscapes(root, rng, n=4, hw=(32, 64)):
    """cityscapes val: ``leftImg8bit`` PNGs in two cities and ``gtFine``
    polygon JSONs of integer rectangles (thing classes), plus a crowd
    group, a stuff region and a deleted object."""
    classes = data.cityscapes.CITYSCAPES_THING_CLASSES
    for i in range(n):
        city = ("frankfurt", "munich")[i % 2]
        stem = f"{city}_{i:06d}_000019_"
        for sub in ("leftImg8bit", "gtFine"):
            os.makedirs(os.path.join(root, "cityscapes", sub, "val", city), exist_ok=True)
        h, w = hw
        boxes = _boxes(rng, h, w, rng.randint(1, 4))
        cv2.imwrite(os.path.join(root, "cityscapes", "leftImg8bit", "val", city, stem + "leftImg8bit.png"),
                    _image(rng, h, w, boxes))
        objs = [{"label": classes[rng.randint(8)],
                 "polygon": [[int(x0), int(y0)], [int(x1), int(y0)], [int(x1), int(y1)], [int(x0), int(y1)]]}
                for x0, y0, x1, y1 in boxes]
        objs += [{"label": "cargroup", "polygon": [[0, 0], [10, 0], [10, 6]]},
                 {"label": "sky", "polygon": [[0, 0], [w, 0], [w, 4]]},
                 {"label": "person", "deleted": 1, "polygon": [[0, 0], [1, 0], [1, 1]]}]
        with open(os.path.join(root, "cityscapes", "gtFine", "val", city, stem + "gtFine_polygons.json"),
                  "w") as f:
            json.dump({"imgHeight": h, "imgWidth": w, "objects": objs}, f)


def _forget_builtin():
    for catalog in (data.DatasetCatalog, jax_data.DatasetCatalog):
        for name in _builtin_names():
            catalog.remove(name)


@pytest.fixture(scope="module")
def builtin_root(tmp_path_factory):
    """The synthetic tree, registered under the builtin names in both
    packages (names another test registered elsewhere are dropped first,
    since ``register_all_builtin`` keeps a registered name)."""
    root = str(tmp_path_factory.mktemp("datasets"))
    rng = np.random.RandomState(0)
    write_voc(root, rng)
    write_lvis(root, rng)
    write_cityscapes(root, rng)
    _forget_builtin()
    data.register_all_builtin(root)
    jax_data.register_all_builtin(root)
    yield root
    _forget_builtin()


def _equal(a, b):
    """Recursive equality: same keys, equal values (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (a, b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert a == b, (a, b)


def _meta(catalog, name):
    return {k: v for k, v in vars(catalog.get(name)).items()}


def test_register_all_builtin_matches_jax(builtin_root):
    assert data.COCO_THING_CLASSES == jax_data.COCO_THING_CLASSES and len(data.COCO_THING_CLASSES) == 80
    names = _builtin_names()
    assert set(names) <= set(data.DatasetCatalog.list()) and len(names) == 18
    for name in names:
        _equal(_meta(data.MetadataCatalog, name), _meta(jax_data.MetadataCatalog, name))
    with pytest.raises((FileNotFoundError, OSError)):
        data.DatasetCatalog.get("coco_2017_val")  # lazy: only fetching a missing split raises


@pytest.mark.parametrize("name", ["voc_2007_test", "voc_2007_trainval", "lvis_v1_val",
                                  "cityscapes_fine_instance_seg_val"])
def test_builtin_split_dicts_and_metadata_match_jax(builtin_root, name):
    ours, theirs = data.DatasetCatalog.get(name), jax_data.DatasetCatalog.get(name)
    assert ours and any(d["annotations"] for d in ours)
    _equal(ours, theirs)
    _equal(_meta(data.MetadataCatalog, name), _meta(jax_data.MetadataCatalog, name))
    if name.startswith("voc"):
        assert any(a["difficult"] for d in ours for a in d["annotations"])
    if name.startswith("cityscapes"):
        assert all(d["file_name"].endswith(".png") for d in ours)
        assert any(a["iscrowd"] for d in ours for a in d["annotations"])


def test_load_sem_seg_matches_jax(tmp_path):
    for sub in ("imgs/sub", "gts/sub"):
        (tmp_path / sub).mkdir(parents=True)
    for rel, payload in (("imgs/sub/a.jpg", b"x"), ("gts/sub/a.png", b"y"), ("imgs/b.jpg", b"x"),
                         ("gts/b.png", b"y"), ("imgs/orphan.jpg", b"x"), ("gts/lonely.png", b"y")):
        (tmp_path / rel).write_bytes(payload)
    ours = data.load_sem_seg(str(tmp_path / "gts"), str(tmp_path / "imgs"))
    assert len(ours) == 2
    assert ours == jax_data.load_sem_seg(str(tmp_path / "gts"), str(tmp_path / "imgs"))


class SeededPredictor:
    """A fake predictor: per image, the ground truth jittered (mostly the
    right class) plus spurious boxes, from a seed and the image's position
    in the split, so both packages' evaluators see the same detections."""

    def __init__(self, dicts, num_classes, seed=0):
        self.by_id = {d["image_id"]: (i, d) for i, d in enumerate(dicts)}
        self.num_classes = num_classes
        self.seed = seed

    def predict_batch(self, batch):
        out = []
        for image_id in batch["image_id"]:
            i, d = self.by_id[image_id]
            rng = np.random.RandomState(self.seed + i)
            h, w = d["height"], d["width"]
            boxes, classes = [], []
            for a in d["annotations"]:
                b = np.asarray(a["bbox"], float)
                if a["bbox_mode"] == 1:  # XYWH_ABS
                    b = np.concatenate([b[:2], b[:2] + b[2:]])
                boxes.append(b + rng.randn(4) * 1.5)
                classes.append(a["category_id"] if rng.rand() < 0.8 else rng.randint(self.num_classes))
            for _ in range(3):
                xy = rng.rand(2) * [w - 10, h - 10]
                boxes.append(np.concatenate([xy, xy + 5 + rng.rand(2) * 10]))
                classes.append(rng.randint(self.num_classes))
            boxes = np.clip(np.asarray(boxes, np.float32), 0, [w, h, w, h])
            out.append({"image_id": image_id, "boxes": boxes, "scores": rng.rand(len(boxes)).astype(np.float32),
                        "classes": np.asarray(classes, np.int64)})
        return out


def _jax_evaluator(name, out):
    """JAX's evaluator for a split of the builtin tree, with its two faults
    on these splits worked around (ROADMAP, section C; the port repairs
    both, ``test_port_repairs_two_faults_of_the_jax_evaluators``): its VOC
    ``reset`` would drop the ground truth registered at build time, so it
    clears only the detections here, as the port's does; its Cityscapes
    writer names files by the loader's stem, which keeps the city folder,
    so the city folders are made in its output directory beforehand."""
    ev = jax_build_evaluator(name, output_dir=str(out))
    if name.startswith("voc"):
        ev.reset = ev._dets.clear
    if name.startswith("cityscapes"):
        for d in data.DatasetCatalog.get(name):
            os.makedirs(os.path.join(out, os.path.dirname(d["image_id"])), exist_ok=True)
    return ev


@pytest.mark.parametrize("name", SPLITS)
def test_split_through_each_build_evaluator_matches_jax(builtin_root, tmp_path, name):
    """The slice as a whole: a split of the builtin tree through each
    package's ``build_evaluator`` (VOC at the 07 metric, LVIS federated,
    Cityscapes through the box-to-mask adapter) and
    ``inference_on_dataset``, with the same seeded detections: equal
    results; for Cityscapes the same txt lines (the port's PNG names
    without the city folder) and the same mask pixels."""
    dicts = data.DatasetCatalog.get(name)
    num_classes = len(data.MetadataCatalog.get(name).thing_classes)
    loader = [{"image_id": [d["image_id"]]} for d in dicts]
    ours = build_evaluator(name, output_dir=str(tmp_path / "ours"))
    theirs = _jax_evaluator(name, tmp_path / "jax")
    assert type(ours).__name__ == type(theirs).__name__
    got = inference_on_dataset(SeededPredictor(dicts, num_classes), loader, ours)
    want = jax_inference_on_dataset(SeededPredictor(dicts, num_classes), loader, theirs)
    _equal(got, want)
    headline = {"voc": ("bbox", "AP50"), "lvi": ("bbox", "AP"), "cit": ("segm", "AP")}[name[:3]]
    assert 0 < got[headline[0]][headline[1]] < 100
    if name.startswith("cityscapes"):
        for d in dicts:
            city, base = os.path.split(d["image_id"])
            lines = (tmp_path / "ours" / f"{base}_pred.txt").read_text().splitlines()
            jax_lines = (tmp_path / "jax" / city / f"{base}_pred.txt").read_text().splitlines()
            assert lines == [ln[len(city) + 1:] for ln in jax_lines] and lines
            for ln in lines:
                png = ln.split()[0]
                np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ours" / png), cv2.IMREAD_UNCHANGED),
                                              cv2.imread(str(tmp_path / "jax" / city / png), cv2.IMREAD_UNCHANGED))


def test_port_repairs_two_faults_of_the_jax_evaluators(builtin_root, tmp_path):
    """Through ``inference_on_dataset``, JAX's VOC evaluator scores NaN
    (``PascalVOCDetectionEvaluator.reset`` drops the ground truth that
    ``build.py::_voc_evaluator`` registered) and JAX's Cityscapes writer
    raises on the builtin layout (``CityscapesInstanceEvaluator.process``
    writes into the stem's city folder, which it never makes). The port
    keeps the ground truth and names the files by the stem's base name."""
    for name in ("voc_2007_test", "cityscapes_fine_instance_seg_val"):
        dicts = data.DatasetCatalog.get(name)
        loader = [{"image_id": [d["image_id"]]} for d in dicts]
        pred = SeededPredictor(dicts, len(data.MetadataCatalog.get(name).thing_classes))
        got = inference_on_dataset(pred, loader, build_evaluator(name, output_dir=str(tmp_path / "o")))
        assert all(math.isfinite(v) for v in next(iter(got.values())).values())
        jax_ev = jax_build_evaluator(name, output_dir=str(tmp_path / "j"))
        if name.startswith("voc"):
            assert math.isnan(jax_inference_on_dataset(pred, loader, jax_ev)["bbox"]["AP50"])
        else:
            with pytest.raises(FileNotFoundError):
                jax_inference_on_dataset(pred, loader, jax_ev)


def test_build_evaluator_picks_jax_class_for_every_type(builtin_root, tmp_path):
    """flir, coco, lvis, pascal_voc, kaist and cityscapes_instance each give
    the same evaluator class in both packages."""
    coco_json = tmp_path / "coco.json"
    coco_json.write_text(json.dumps({"images": [{"id": 1, "file_name": "a.jpg", "height": 9, "width": 9}],
                                     "annotations": [], "categories": [{"id": 3, "name": "a"}]}))
    kaist_json = tmp_path / "kaist.json"
    kaist_json.write_text(json.dumps({"images": [], "annotations": []}))
    names = {"voc_2007_test": "PascalVOCDetectionEvaluator", "lvis_v1_val": "LVISEvaluator",
             "cityscapes_fine_instance_seg_val": "_CityscapesBoxProtocolAdapter"}
    for etype, path, cls in (("flir", coco_json, "FLIREvaluator"), ("coco", coco_json, "FLIREvaluator"),
                             ("kaist", kaist_json, "KAISTEvaluator")):
        for catalog in (data.MetadataCatalog, jax_data.MetadataCatalog):
            meta = catalog.get(f"every_type_{etype}")
            meta.json_file, meta.evaluator_type = str(path), etype
        names[f"every_type_{etype}"] = cls
    for name, cls in names.items():
        ours = build_evaluator(name, output_dir=str(tmp_path / "o"))
        theirs = jax_build_evaluator(name, output_dir=str(tmp_path / "j"))
        assert type(ours).__name__ == type(theirs).__name__ == cls, name


def test_default_trainer_test_on_voc_matches_jax_evaluator(builtin_root, tmp_path, monkeypatch):
    """The port alone, end to end: ``DefaultTrainer.test`` with a tiny
    random R50 on the CPU over ``voc_2007_test`` (20 classes) returns what
    JAX's VOC evaluator returns for the port's own detections (recorded as
    the port's evaluator receives them)."""
    from test_torch_train_apps import _shrink

    from proben_tpu_torch.config import get_cfg, model_config_from_cfg
    from proben_tpu_torch.engine import DefaultTrainer
    from proben_tpu_torch.evaluation import pascal_voc
    from proben_tpu_torch.models import init_rcnn

    seen = []
    process = pascal_voc.PascalVOCDetectionEvaluator.process

    def record(self, image_id, boxes, scores, classes):
        seen.append((image_id, np.array(boxes), np.array(scores), np.array(classes)))
        return process(self, image_id, boxes, scores, classes)

    monkeypatch.setattr(pascal_voc.PascalVOCDetectionEvaluator, "process", record)
    cfg = _shrink(get_cfg())
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 20
    cfg.DATASETS.TEST = ("voc_2007_test",)
    cfg.OUTPUT_DIR = str(tmp_path)
    results = DefaultTrainer.test(cfg, init_rcnn(0, model_config_from_cfg(cfg)), device="cpu")
    assert [s[0] for s in seen] == [d["image_id"] for d in data.DatasetCatalog.get("voc_2007_test")]
    assert all(len(s[1]) == cfg.TEST.DETECTIONS_PER_IMAGE for s in seen)
    jax_ev = jax_build_evaluator("voc_2007_test")  # not reset: JAX's reset drops the ground truth
    for image_id, boxes, scores, classes in seen:
        jax_ev.process(image_id, boxes, scores, classes)
    _equal(results, jax_ev.evaluate())
    assert math.isfinite(results["bbox"]["AP50"])


# -- the decode rule of native/io.py::load_batch -----------------------------------


class RecordingCodec:
    """Stands in for ``JpegCodec`` on the CPU: decodes with cv2 and records
    which files reached it."""

    def __init__(self):
        self.decoded = []

    def decode(self, blob):
        self.decoded.append(blob[:2])
        return torch.from_numpy(cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR))


def test_load_batch_chooses_the_decoder_by_the_files_bytes(tmp_path, monkeypatch):
    """A JPEG (``FF D8``), whatever its name, goes to the codec; a PNG,
    even named ``.jpg``, to ``decode_host`` (cv2.imread as on the CPU),
    and both feed one canvas: with CPU tensors the plain version of the
    compose, so the PNG's canvas equals the CPU path's read and resize."""
    from proben_tpu_torch.native import io

    rng = np.random.RandomState(3)
    a, b = _image(rng, 30, 40, [(2, 3, 20, 25)]), _image(rng, 24, 36, [(5, 5, 30, 20)])
    jpeg, png = tmp_path / "a.png", tmp_path / "b.jpg"  # names that lie
    jpeg.write_bytes(cv2.imencode(".jpg", a)[1].tobytes())
    png.write_bytes(cv2.imencode(".png", b)[1].tobytes())
    host = []

    def decode_host(path):
        host.append(path)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return torch.from_numpy(img)

    monkeypatch.setattr(io, "decode_host", decode_host)
    codec = RecordingCodec()
    images, sizes, orig = io.load_batch(codec, [str(jpeg), str(png)], None, "BGR", lambda h, w: (2 * h, 2 * w),
                                        (64, 80))
    assert codec.decoded == [b"\xff\xd8"] and host == [str(png)]
    assert orig.tolist() == [[30, 40], [24, 36]] and sizes.tolist() == [[60, 80], [48, 72]]
    want = io.compose_resize_pad_plain([torch.from_numpy(b)], None, "BGR", [(48, 72)], (64, 80))
    assert torch.equal(images[1], want[0])


def test_load_batch_refuses_a_file_cv2_cannot_read(tmp_path):
    """A file that is not a JPEG and that cv2 cannot read raises
    ``FileNotFoundError`` (as the CPU reader does), before any decode or
    launch; nvJPEG is never tried on it."""
    from proben_tpu_torch.native import io
    from proben_tpu_torch.utils import tracing

    bad = tmp_path / "broken.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    codec = RecordingCodec()
    before = tracing.counters().get("io.launches", 0)
    with pytest.raises(FileNotFoundError, match="broken.png"):
        io.load_batch(codec, [str(bad)], None, "BGR", lambda h, w: (h, w))
    with pytest.raises(FileNotFoundError):
        io.decode_host(str(tmp_path / "missing.png"))
    assert codec.decoded == [] and tracing.counters().get("io.launches", 0) == before
