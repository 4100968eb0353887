"""The port's training data path on the CPU against ``proben_tpu``'s: the
training transforms, the samplers and index streams, the training branch
of ``DatasetMapper`` and ``TrainLoader``, on a FLIR-shaped tree written with
``cv2.imwrite`` (single-component thermal JPEGs, colour RGB JPEGs larger
than their thermal frame, per-image sizes).

Tolerances: the CPU path reads, crops, resizes and flips with the same numpy
and cv2 calls as the JAX package, from the same ``RandomState`` draws in
the same order, so arrays are equal bit for bit. The photometric jitters
(``ColorAugment``, ``random_extent``) are the same float operations too;
they are held to 1e-6 only because they return float arrays computed
through numpy broadcasting that the packages need not order alike.
``image_io``'s plain version with flips equals its own unflipped resize,
flipped, exactly (the flip only moves values).
"""

import contextlib
import json

import cv2
import numpy as np
import pytest
import torch

from proben_tpu.data import DatasetMapper as JaxDatasetMapper
from proben_tpu.data import MapperConfig as JaxMapperConfig
from proben_tpu.data import TrainLoader as JaxTrainLoader
from proben_tpu.data import training_index_stream as jax_training_index_stream
from proben_tpu.data import samplers as jax_samplers
from proben_tpu.data import transforms as jt
from proben_tpu_torch.data import (
    DatasetMapper,
    MapperConfig,
    TrainLoader,
    derive_rgb_path,
    load_coco_json,
    samplers,
    training_index_stream,
)
from proben_tpu_torch.data import transforms as tt
from proben_tpu_torch.native.io import compose_resize_pad, compose_resize_pad_plain
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

THERMAL = [(128, 160), (128, 160), (100, 140), (120, 96)]
RGB = [(256, 300), (300, 256), (200, 250), (240, 200)]
PAD = (224, 224)
FORMATS = ("BGR", "BGRT", "BGRTTT")
SHORT = (96, 112, 128)


def _smooth(rng, shape):
    return cv2.GaussianBlur(rng.randint(0, 256, shape, np.uint8), (9, 9), 3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("flir_train_data")
    (root / "thermal_8_bit").mkdir()
    (root / "RGB").mkdir()
    rng = np.random.RandomState(1)
    images, annotations = [], []
    for i, ((h, w), rgb_hw) in enumerate(zip(THERMAL, RGB)):
        name = f"FLIR_{i:05d}"
        cv2.imwrite(str(root / "thermal_8_bit" / f"{name}.jpeg"), _smooth(rng, (h, w)))
        cv2.imwrite(str(root / "RGB" / f"{name}.jpg"), _smooth(rng, rgb_hw + (3,)))
        images.append({"id": i + 1, "file_name": f"{name}.jpeg", "height": h, "width": w})
        for j in range(i + 2):
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1,
                                "category_id": 1 + (i + j) % 3, "iscrowd": int(j == 3),
                                "bbox": [5.0 + 17 * j, 8.0 + 3 * j, 30.0, 25.0 + 4 * j],
                                "area": 900.0})
    annotations.append({"id": 99, "image_id": 1, "category_id": 3, "bbox": [140.0, 110.0, 40.0, 30.0],
                        "area": 900.0, "iscrowd": 0})  # partly outside the image: clipped
    js = {"images": images, "annotations": annotations,
          "categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "bicycle"},
                         {"id": 3, "name": "car"}]}
    (root / "train.json").write_text(json.dumps(js))
    return str(root)


def _dicts(tree):
    return load_coco_json(f"{tree}/train.json", f"{tree}/thermal_8_bit")


def _cfgs(fmt, crop=None, flip=True):
    kw = dict(input_format=fmt, pad_shape=PAD, min_size_train=SHORT, max_size_train=224, max_gt=6,
              flip=flip, crop=crop)
    return JaxMapperConfig(**kw), MapperConfig(**kw)


def _boxes(rng, n=5):
    xy = rng.rand(n, 2) * 80
    return np.concatenate([xy, xy + rng.rand(n, 2) * 40 + 4], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def test_geometric_transforms_equal_jax():
    rng = np.random.RandomState(0)
    image = rng.rand(50, 70, 4).astype(np.float32) * 255
    boxes = _boxes(rng)
    assert np.array_equal(tt.resize_boxes(boxes, (50, 70), (64, 90)),
                          jt.resize_boxes(boxes, (50, 70), (64, 90)))
    assert np.array_equal(tt.hflip_image(image), jt.hflip_image(image))
    assert np.array_equal(tt.hflip_boxes(boxes, 70.0), jt.hflip_boxes(boxes, 70.0))
    for seed in range(4):
        got = tt.random_crop(image, boxes, (0.6, 0.7), np.random.RandomState(seed))
        want = jt.random_crop(image, boxes, (0.6, 0.7), np.random.RandomState(seed))
        assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))


@pytest.mark.parametrize("shape", [(50, 70, 3), (64, 48, 6)])
def test_train_augment_equals_jax(shape):
    """``TrainAugment`` with crop, two or more short sides and flips: the
    same images and boxes for the same draws, and ``draw`` makes the draws
    that follow the crop's in JAX's order."""
    rng = np.random.RandomState(2)
    for crop in (None, (0.7, 0.8)):
        got_aug = tt.TrainAugment(SHORT, 160, True, np.random.RandomState(5), crop=crop)
        want_aug = jt.TrainAugment(SHORT, 160, True, np.random.RandomState(5), crop=crop)
        flips = set()
        for _ in range(8):
            image = rng.rand(*shape).astype(np.float32) * 255
            boxes = _boxes(rng)
            g_image, g_boxes, flip = got_aug.apply(image, boxes)
            w_image, w_boxes = want_aug(image, boxes)
            flips.add(flip)
            assert g_image.dtype == w_image.dtype and np.array_equal(g_image, w_image)
            assert np.array_equal(g_boxes, w_boxes)
        assert flips == {True, False}
    # the card's draws: size and flip per image, as TrainAugment makes them
    a = tt.TrainAugment(SHORT, 160, True, np.random.RandomState(7))
    b = jt.TrainAugment(SHORT, 160, True, np.random.RandomState(7))
    for h, w in [(50, 70), (70, 50), (64, 64)] * 3:
        nh, nw, flip = a.draw(h, w)
        image = b(np.zeros((h, w, 1), np.float32), np.zeros((0, 4), np.float32))[0]
        assert image.shape[:2] == (nh, nw)
    assert a.rng.rand() == b.rng.rand()  # the streams stayed in step


def test_color_augment_and_random_extent_equal_jax():
    rng = np.random.RandomState(4)
    image = rng.rand(40, 56, 3).astype(np.float32) * 255
    kw = dict(contrast=(0.5, 1.5), brightness=(0.6, 1.4), saturation=(0.7, 1.3), lighting=0.1)
    got = tt.ColorAugment(rng=np.random.RandomState(9), **kw)
    want = jt.ColorAugment(rng=np.random.RandomState(9), **kw)
    for _ in range(3):
        np.testing.assert_allclose(got(image), want(image), rtol=1e-6, atol=1e-6)
    boxes = _boxes(rng)
    for seed in range(3):
        g = tt.random_extent(image, boxes, (0.8, 1.3), (0.2, 0.3), np.random.RandomState(seed))
        w = jt.random_extent(image, boxes, (0.8, 1.3), (0.2, 0.3), np.random.RandomState(seed))
        assert g[0].shape == w[0].shape
        np.testing.assert_allclose(g[0], w[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g[1], w[1], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="3-channel"):
        tt.random_saturation(np.zeros((4, 4, 4), np.float32), 0.5, 1.5, np.random.RandomState(0))


# ---------------------------------------------------------------------------
# samplers and index streams
# ---------------------------------------------------------------------------


def test_index_streams_equal_jax(tree):
    for n, seed, shard, shards in ((4, 0, 0, 1), (7, 3, 1, 2), (5, 1, 0, 1)):
        got = training_index_stream(n, seed, shard, shards)
        want = jax_training_index_stream(n, seed, shard, shards)
        assert [int(next(got)) for _ in range(23)] == [int(next(want)) for _ in range(23)]
    dicts = _dicts(tree) * 3
    factors = samplers.repeat_factors_from_category_frequency(dicts, 0.5)
    assert np.array_equal(factors, jax_samplers.repeat_factors_from_category_frequency(dicts, 0.5))
    got = samplers.repeat_factor_index_stream(factors * 1.7, 2, 1, 2)
    want = jax_samplers.repeat_factor_index_stream(factors * 1.7, 2, 1, 2)
    assert [int(next(got)) for _ in range(40)] == [int(next(want)) for _ in range(40)]


# ---------------------------------------------------------------------------
# the training mapper and loader
# ---------------------------------------------------------------------------


def _assert_sample_equal(got, want, label):
    assert set(got) == set(want) | {"flip"}, label
    for k in want:
        g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        assert np.array_equal(np.asarray(g), np.asarray(want[k])), (label, k)
        assert np.asarray(g).dtype == np.asarray(want[k]).dtype, (label, k)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("crop", [None, (0.7, 0.8)])
def test_cpu_train_mapper_equals_jax(tree, fmt, crop):
    """Every field of every sample, bit for bit, over repeated passes (so
    both flips and every short side occur): the augmented image padded, its
    size, the gt in the augmented frame clipped (crowd dropped, padded)."""
    jcfg, tcfg = _cfgs(fmt, crop)
    jm = JaxDatasetMapper(jcfg, is_train=True, seed=3)
    tm = DatasetMapper(tcfg, is_train=True, seed=3, device="cpu")
    flips, heights = set(), set()
    for d in _dicts(tree) * 3:
        got, want = tm(d), jm(d)
        _assert_sample_equal(got, want, (fmt, crop, d["image_id"]))
        flips.add(got["flip"])
        heights.add(int(got["image_size"][0]))
    assert flips == {True, False} and len(heights) >= 2


def test_flip_off_draws_no_flip(tree):
    jcfg, tcfg = _cfgs("BGR", flip=False)
    jm = JaxDatasetMapper(jcfg, is_train=True, seed=1)
    tm = DatasetMapper(tcfg, is_train=True, seed=1, device="cpu")
    for d in _dicts(tree) * 2:
        got = tm(d)
        _assert_sample_equal(got, jm(d), d["image_id"])
        assert not got["flip"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_compose_flip_is_resize_then_hflip(tree, fmt):
    """``compose_resize_pad_plain`` with flips: per image, the unflipped
    resize of the same frame flipped by JAX's ``hflip_image``, exactly;
    the padding stays zero. The wrapper takes the plain version on CPU
    tensors, flips included."""
    dicts = _dicts(tree)
    thermal = [torch.from_numpy(cv2.imread(d["file_name"])) for d in dicts]
    rgb = None if fmt == "BGR" else [
        torch.from_numpy(cv2.imread(derive_rgb_path(d["file_name"]))) for d in dicts]
    sizes = [(112, 140), (128, 160), (96, 134), (150, 120)]
    flips = [True, False, True, True]
    got = compose_resize_pad_plain(thermal, rgb, fmt, sizes, PAD, flips).numpy()
    plain = compose_resize_pad_plain(thermal, rgb, fmt, sizes, PAD).numpy()
    for i, ((nh, nw), f) in enumerate(zip(sizes, flips)):
        want = jt.hflip_image(plain[i, :nh, :nw]) if f else plain[i, :nh, :nw]
        assert np.array_equal(got[i, :nh, :nw], want), i
        assert not got[i, nh:].any() and not got[i, :, nw:].any()
    assert np.array_equal(got, compose_resize_pad(thermal, rgb, fmt, sizes, PAD, flips).numpy())
    with pytest.raises(ValueError, match="one flip"):
        compose_resize_pad(thermal, rgb, fmt, sizes, PAD, flips[:2])


def test_train_loader_one_worker_equals_jax(tree):
    """``NUM_WORKERS`` 1: JAX's batch sequence (indices from the stream,
    draws in order), batch for batch, with the dataset indices and flips."""
    jcfg, tcfg = _cfgs("BGRT")
    dicts = _dicts(tree)
    jl = JaxTrainLoader(dicts, JaxDatasetMapper(jcfg, is_train=True, seed=2), 3, seed=4,
                        num_workers=1)
    tl = TrainLoader(dicts, DatasetMapper(tcfg, is_train=True, seed=2, device="cpu"), 3, seed=4,
                     num_workers=1)
    try:
        stream = training_index_stream(len(dicts), 4)
        for _ in range(5):
            got, want = next(tl), next(jl)
            assert got["indices"] == [int(next(stream)) for _ in range(3)]
            assert got["image_id"] == want["image_id"] and got["file_name"] == want["file_name"]
            assert got["flip"].dtype == bool and got["flip"].shape == (3,)
            for k in ("image", "image_size", "orig_size"):
                g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
                assert np.array_equal(g, np.asarray(want[k])), k
            for k in ("boxes", "classes", "valid"):
                assert np.array_equal(getattr(got["gt"], k).numpy(),
                                      np.asarray(getattr(want["gt"], k))), k
    finally:
        jl.close()
        tl.close()
    assert not any(t.is_alive() for t in tl._threads)


def test_train_loader_counts_the_batches_it_mapped(tree):
    """``batches_mapped``: every batch handed out, plus at most the queue's
    and the workers' prefetched ones; final once ``close`` has joined."""
    _, tcfg = _cfgs("BGR")
    tl = TrainLoader(_dicts(tree), DatasetMapper(tcfg, is_train=True, device="cpu"), 2,
                     num_workers=2, prefetch=2)
    try:
        for _ in range(3):
            next(tl)
    finally:
        tl.close()
    assert 3 <= tl.batches_mapped <= 3 + 2 + 2


def test_train_loader_raises_a_workers_error(tree):
    _, tcfg = _cfgs("BGR")
    dicts = [dict(d, file_name=d["file_name"] + ".missing") for d in _dicts(tree)]
    tl = TrainLoader(dicts, DatasetMapper(tcfg, is_train=True, device="cpu"), 2, num_workers=2)
    try:
        with pytest.raises(FileNotFoundError):
            next(tl)
    finally:
        tl.close()


def test_train_mapper_crop_on_the_card_raises(monkeypatch):
    """The card path crops (``image_io``'s crop window): with a card the
    training mapper with ``INPUT.CROP`` is built and opens its codec;
    without a card, ``cuda`` raises."""
    _, tcfg = _cfgs("BGR", crop=(0.7, 0.8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    opened = []
    monkeypatch.setattr(DatasetMapper, "_codec", lambda self: opened.append(self))
    mapper = DatasetMapper(tcfg, is_train=True)
    assert opened == [mapper] and mapper.device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DatasetMapper(tcfg, is_train=True)


class _HostCodec:
    """Stands in for nvJPEG on the CPU: cv2's decode of a file's bytes into
    a CPU tensor, so ``load_batch`` hands ``image_io`` CPU tensors and its
    plain version makes the canvas."""

    def decode(self, data):
        return torch.from_numpy(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))

    def close(self):
        pass


@pytest.mark.parametrize("fmt", FORMATS)
def test_card_mapper_crops_as_jax(tree, fmt, monkeypatch):
    """The card branch of the training mapper with ``INPUT.CROP``, with the
    codec replaced by ``_HostCodec`` (the branch's host logic, ``load_batch``
    and ``image_io``'s plain version run; the kernel itself is held to that
    plain version in tests/test_torch_kernels.py): the draws come in JAX's
    order (the crop's four, the size, the flip), so sizes, flips and the
    boxes (shifted by the crop's origin unclipped, resized, flipped, then
    clipped) equal JAX's mapper's bit for bit; the canvas equals
    ``compose_resize_pad_plain`` of the replayed windows bit for bit, and
    JAX's cv2 float resize of the cropped frame within 1e-3 (as
    tests/test_torch_data.py holds the uncropped one). Some windows start
    off the frame's origin, and the boxes differ from the uncropped run's
    draws, so the crop's draws show in them."""
    from proben_tpu_torch.native import io

    crop = (0.6, 0.7)
    jcfg, tcfg = _cfgs(fmt, crop)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(io, "JpegCodec", _HostCodec)
    dicts = _dicts(tree) * 2
    tm = DatasetMapper(tcfg, is_train=True, seed=3)
    jm = JaxDatasetMapper(jcfg, is_train=True, seed=3)
    uncropped = DatasetMapper(_cfgs(fmt)[1], is_train=True, seed=3, device="cpu")
    got = tm.map_batch(dicts)
    replay = tt.TrainAugment(SHORT, 224, True, np.random.RandomState(3), crop=crop)
    windows, flips, sizes = [], [], []
    for d in dicts:
        windows.append(replay.crop_window(d["height"], d["width"]))
        nh, nw, flip = replay.draw(*windows[-1][2:])
        sizes.append((nh, nw))
        flips.append(flip)
    thermal = [torch.from_numpy(cv2.imread(d["file_name"])) for d in dicts]
    rgb = None if fmt == "BGR" else [
        torch.from_numpy(cv2.imread(derive_rgb_path(d["file_name"]))) for d in dicts]
    plain = compose_resize_pad_plain(thermal, rgb, fmt, sizes, PAD, flips, windows).numpy()
    moved = 0
    for i, (g, d) in enumerate(zip(got, dicts)):
        want = jm(d)
        nh, nw = sizes[i]
        assert g["image"].device.type == "cpu"
        assert [int(v) for v in g["image_size"]] == [nh, nw] and g["flip"] == flips[i]
        for k in ("image_size", "gt_boxes", "gt_classes", "gt_valid", "orig_size"):
            assert np.array_equal(g[k], np.asarray(want[k])) and g[k].dtype == want[k].dtype, (i, k)
        assert np.array_equal(g["image"].numpy(), plain[i]), i
        np.testing.assert_allclose(plain[i, :nh, :nw], want["image"][:nh, :nw], rtol=0, atol=1e-3)
        moved += not np.array_equal(g["gt_boxes"], uncropped(d)["gt_boxes"])
    assert any(w[0] > 0 for w in windows) and any(w[1] > 0 for w in windows)
    assert any(w[2:] != (d["height"], d["width"]) for w, d in zip(windows, dicts))
    assert moved and set(flips) == {True, False}


def test_compose_crop_checks_the_window():
    """A crop window must lie inside its frame, one per image."""
    t = [torch.zeros((20, 30, 1), dtype=torch.uint8)]
    for bad in [(-1, 0, 10, 10), (0, 0, 21, 10), (5, 25, 10, 6), (0, 0, 0, 5)]:
        with pytest.raises(ValueError, match="outside the frame"):
            compose_resize_pad(t, None, "BGR", [(10, 10)], (16, 16), None, [bad])
    with pytest.raises(ValueError, match="one crop"):
        compose_resize_pad(t, None, "BGR", [(10, 10)], (16, 16), None, [None, None])
    whole = compose_resize_pad(t, None, "BGR", [(10, 10)], (16, 16), None, [(0, 0, 20, 30)])
    assert torch.equal(whole, compose_resize_pad(t, None, "BGR", [(10, 10)], (16, 16)))
