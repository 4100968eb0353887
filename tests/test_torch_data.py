"""The port's data path on the CPU (``proben_tpu_torch/data``, the plain
version of ``native/io.py``) against ``proben_tpu.data``, on a FLIR-shaped
tree written with ``cv2.imwrite``: single-component thermal JPEGs, colour
RGB JPEGs larger than their thermal frame, per-image sizes in one batch.

Tolerances: the CPU mapper reads and resizes with cv2 exactly as the JAX
package does, so its samples are equal. ``compose_resize_pad_plain`` (the
kernel's arithmetic) gets the RGB image at the thermal frame exactly as
cv2's uint8 resize does (the same fixed-point arithmetic), and the float
shortest-edge resize to within 1e-3 of cv2's on 0..255 values: the two
compute the same bilinear weights in other float orders (cv2 in double,
then float; the kernel in float), a few f32 ulps at 255.
"""

import json

import cv2
import numpy as np
import pytest
import torch

from proben_tpu.data import DatasetMapper as JaxDatasetMapper
from proben_tpu.data import MapperConfig as JaxMapperConfig
from proben_tpu.data import build_test_loader as jax_build_test_loader
from proben_tpu.data import load_coco_json as jax_load_coco_json
from proben_tpu.data.detection_utils import read_image as jax_read_image
from proben_tpu.data.transforms import TestResize as JaxTestResize
from proben_tpu.data.transforms import resize_image as jax_resize_image
from proben_tpu.structures.boxes import BoxMode as JaxBoxMode
from proben_tpu.structures.boxes import convert_box_mode as jax_convert_box_mode
from proben_tpu_torch.data import (
    DatasetCatalog,
    DatasetMapper,
    MapperConfig,
    MetadataCatalog,
    build_test_loader,
    derive_rgb_path,
    load_coco_json,
    read_image,
    register_coco_instances,
)
from proben_tpu_torch.data import transforms
from proben_tpu_torch.native.io import compose_resize_pad, compose_resize_pad_plain, resize_u8_cv2
from proben_tpu_torch.structures import BoxMode, GroundTruth, convert_box_mode
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

THERMAL = [(128, 160), (128, 160), (100, 140)]
RGB = [(256, 300), (300, 256), (200, 250)]
PAD = (192, 224)
FORMATS = ("BGR", "BGRT", "BGRTTT")


def _smooth(rng, shape):
    return cv2.GaussianBlur(rng.randint(0, 256, shape, np.uint8), (9, 9), 3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("flir_data")
    (root / "thermal_8_bit").mkdir()
    (root / "RGB").mkdir()
    rng = np.random.RandomState(0)
    images, annotations = [], []
    for i, ((h, w), rgb_hw) in enumerate(zip(THERMAL, RGB)):
        name = f"FLIR_{i:05d}"
        cv2.imwrite(str(root / "thermal_8_bit" / f"{name}.jpeg"), _smooth(rng, (h, w)))
        cv2.imwrite(str(root / "RGB" / f"{name}.jpg"), _smooth(rng, rgb_hw + (3,)))
        images.append({"id": i + 1, "file_name": f"{name}.jpeg", "height": h, "width": w})
        for j in range(i + 1):
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1,
                                "category_id": 1 + (i + j) % 3, "iscrowd": int(j == 2),
                                "bbox": [10.0 + 20 * j, 12.0, 40.0, 30.0 + 5 * j], "area": 1200.0})
    annotations.append({"id": 99, "image_id": 1, "category_id": 3, "bbox": [150.0, 120.0, 30.0, 30.0],
                        "area": 900.0, "iscrowd": 0})  # partly outside the image: clipped
    js = {"images": images, "annotations": annotations,
          "categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "bicycle"},
                         {"id": 3, "name": "car"}]}
    (root / "val.json").write_text(json.dumps(js))
    return str(root)


def _dicts(tree):
    return load_coco_json(f"{tree}/val.json", f"{tree}/thermal_8_bit")


def _mapper_cfgs(fmt):
    kw = dict(input_format=fmt, pad_shape=PAD, min_size_test=160, max_size_test=224, max_gt=4)
    return JaxMapperConfig(**kw), MapperConfig(**kw)


def test_thermal_files_are_single_component(tree):
    img = cv2.imread(f"{tree}/thermal_8_bit/FLIR_00000.jpeg", cv2.IMREAD_UNCHANGED)
    assert img.ndim == 2


def test_load_coco_json_and_catalog(tree):
    want = jax_load_coco_json(f"{tree}/val.json", f"{tree}/thermal_8_bit")
    assert _dicts(tree) == want
    DatasetCatalog.remove("flir_data_test")
    register_coco_instances("flir_data_test", {"extra": 1}, f"{tree}/val.json", f"{tree}/thermal_8_bit")
    assert DatasetCatalog.get("flir_data_test") == want
    meta = MetadataCatalog.get("flir_data_test")
    assert meta.thing_classes == ["person", "bicycle", "car"] and meta.extra == 1
    assert meta.thing_dataset_id_to_contiguous_id == {1: 0, 2: 1, 3: 2}
    with pytest.raises(KeyError):
        register_coco_instances("flir_data_test", {}, f"{tree}/val.json", f"{tree}/thermal_8_bit")
    DatasetCatalog.remove("flir_data_test")


@pytest.mark.parametrize("fmt", ("BGR", "RGB", "L") + FORMATS[1:])
def test_read_image_cpu_equals_jax(tree, fmt):
    path = f"{tree}/thermal_8_bit/FLIR_00001.jpeg"
    got = read_image(path, fmt, device="cpu")
    want = jax_read_image(path, fmt)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_derive_rgb_path():
    assert derive_rgb_path("/d/thermal_8_bit/FLIR_00001.jpeg") == "/d/RGB/FLIR_00001.jpg"
    with pytest.raises(ValueError, match="thermal_8_bit"):
        derive_rgb_path("/d/other/FLIR_00001.jpeg")


@pytest.mark.parametrize("fmt", FORMATS)
def test_cpu_mapper_equals_jax(tree, fmt):
    """Every field of every sample, exactly: the padded image, sizes, the gt
    clipped to the resized frame (crowd dropped, padded to max_gt)."""
    jcfg, tcfg = _mapper_cfgs(fmt)
    jm, tm = JaxDatasetMapper(jcfg, is_train=False), DatasetMapper(tcfg, is_train=False, device="cpu")
    for d in _dicts(tree):
        want, got = jm(d), tm(d)
        assert set(got) == set(want)
        assert torch.is_tensor(got["image"]) and got["image"].device.type == "cpu"
        for k in want:
            g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
            assert np.array_equal(np.asarray(g), np.asarray(want[k])), (fmt, k)
            assert np.asarray(g).dtype == np.asarray(want[k]).dtype, (fmt, k)


@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_compose_equals_jax_read_and_resize(tree, fmt):
    """``compose_resize_pad_plain`` on cv2's decoded arrays against JAX's
    ``read_image`` + ``TestResize``, per image of a batch with its own
    size (tolerance in the module docstring)."""
    dicts = _dicts(tree)
    thermal = [torch.from_numpy(cv2.imread(d["file_name"])) for d in dicts]
    rgb = None if fmt == "BGR" else [
        torch.from_numpy(cv2.imread(derive_rgb_path(d["file_name"]))) for d in dicts]
    sizes = [transforms.TestResize(160, 224).size(*t.shape[:2]) for t in thermal]
    got = compose_resize_pad_plain(thermal, rgb, fmt, sizes, PAD).numpy()
    assert np.array_equal(got, compose_resize_pad(thermal, rgb, fmt, sizes, PAD).numpy())
    for i, d in enumerate(dicts):
        image, (nh, nw) = JaxTestResize(160, 224)(jax_read_image(d["file_name"], fmt))
        assert (nh, nw) == sizes[i]
        np.testing.assert_allclose(got[i, :nh, :nw], image, rtol=0, atol=1e-3)
        assert not got[i, nh:].any() and not got[i, :, nw:].any()


@pytest.mark.parametrize("src,dst", [((256, 300), (128, 160)), ((300, 256), (128, 160)),
                                     ((100, 120), (300, 333)), ((64, 80), (64, 80)),
                                     ((37, 1000), (40, 333))])
def test_uint8_resize_is_cv2s(src, dst):
    """The RGB image at the thermal frame: cv2.INTER_LINEAR on uint8, bit
    for bit (downscale, upscale, equal size, mixed)."""
    img = np.random.RandomState(sum(src)).randint(0, 256, src + (3,), np.uint8)
    got = resize_u8_cv2(torch.from_numpy(img), *dst).numpy()
    assert np.array_equal(got, cv2.resize(img, dst[::-1]).astype(np.float32))


def test_grayscale_counts_as_three_equal_channels():
    rng = np.random.RandomState(3)
    y = torch.from_numpy(rng.randint(0, 256, (20, 30, 1), np.uint8))
    rgb = torch.from_numpy(rng.randint(0, 256, (40, 50, 1), np.uint8))
    out = compose_resize_pad_plain([y], [rgb], "BGRTTT", [(25, 37)], (32, 40))[0]
    assert torch.equal(out[..., 3], out[..., 4]) and torch.equal(out[..., 3], out[..., 5])
    assert torch.equal(out[..., 0], out[..., 1]) and torch.equal(out[..., 0], out[..., 2])
    same = compose_resize_pad_plain([y.expand(-1, -1, 3).contiguous()],
                                    [rgb.expand(-1, -1, 3).contiguous()], "BGRTTT", [(25, 37)], (32, 40))
    assert torch.equal(out, same[0])


@pytest.mark.parametrize("shape,size", [((30, 40, 4), (45, 61)), ((30, 40, 1), (20, 27)),
                                        ((30, 40, 6), (30, 40))])
def test_resize_image_equals_jax(shape, size):
    img = np.random.RandomState(4).rand(*shape).astype(np.float32) * 255
    want = jax_resize_image(img, *size)
    got = transforms.resize_image(img, *size)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert transforms.resize_shortest_edge_size(512, 640, 800, 1333) == (800, 1000)


@pytest.mark.parametrize("batch_size", [2, 3])
def test_build_test_loader_equals_jax(tree, batch_size):
    """Same batches, ``num_real`` and repeat-last padding; the batch's
    tensors on the mapper's device, the gt as a ``GroundTruth``."""
    jcfg, tcfg = _mapper_cfgs("BGRT")
    dicts = _dicts(tree)
    want = list(jax_build_test_loader(dicts, JaxDatasetMapper(jcfg, is_train=False), batch_size))
    got = list(build_test_loader(dicts, DatasetMapper(tcfg, is_train=False, device="cpu"), batch_size))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["num_real"] == w["num_real"] and g["image_id"] == w["image_id"]
        assert g["file_name"] == w["file_name"]
        assert isinstance(g["gt"], GroundTruth) and torch.is_tensor(g["image_size"])
        for k in ("image", "image_size", "orig_size"):
            gv = g[k].numpy() if torch.is_tensor(g[k]) else g[k]
            assert np.array_equal(gv, np.asarray(w[k])), k
        for k in ("boxes", "classes", "valid"):
            assert np.array_equal(getattr(g["gt"], k).numpy(), np.asarray(getattr(w["gt"], k))), k
    if batch_size == 2:
        last = got[-1]
        assert last["num_real"] == 1 and last["image_id"] == [3, 3]
        assert torch.equal(last["image"][0], last["image"][1])


def test_mapper_device_rules(monkeypatch):
    _, tcfg = _mapper_cfgs("BGR")
    assert DatasetMapper(tcfg, device="cpu").is_train  # the training branch, on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    opened = []  # the card crops: a mapper with INPUT.CROP opens its codec
    monkeypatch.setattr(DatasetMapper, "_codec", lambda self: opened.append(self))
    assert opened == [DatasetMapper(MapperConfig(**{**tcfg.__dict__, "crop": (0.9, 0.9)}))]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DatasetMapper(tcfg, is_train=False)
    with pytest.raises(RuntimeError, match="cuda"):
        read_image("/d/thermal_8_bit/x.jpeg", "BGR")


@pytest.mark.parametrize("mode", [(JaxBoxMode.XYWH_ABS, BoxMode.XYWH_ABS, JaxBoxMode.XYXY_ABS,
                                   BoxMode.XYXY_ABS),
                                  (JaxBoxMode.XYXY_ABS, BoxMode.XYXY_ABS, JaxBoxMode.XYWH_ABS,
                                   BoxMode.XYWH_ABS)])
def test_convert_box_mode_equals_jax(mode):
    jf, tf, jt, tt = mode
    boxes = np.random.RandomState(5).rand(2, 7, 4).astype(np.float32) * 100
    want = np.asarray(jax_convert_box_mode(boxes, jf, jt))
    assert np.array_equal(convert_box_mode(boxes, tf, tt), want)
    assert np.array_equal(convert_box_mode(torch.from_numpy(boxes), tf, tt).numpy(), want)
    assert int(tf) == int(jf) and int(tt) == int(jt)
