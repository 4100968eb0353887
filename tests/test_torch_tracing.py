"""The program's stage spans and host counters (``utils/tracing.py``) on the
CPU: spans are a shared no-op unless a profiler records, each loop emits
its stage spans once and nested as documented, the NMS and out-of-window
counters equal direct counts on planted inputs, the launch counters live
in the registry alone and lose no update across threads, an exported
program holds no span node, and the spans add no event but themselves to
the profiler's trace."""

from __future__ import annotations

import functools
import json
import os
import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

from proben_tpu_torch.engine.predictor import Predictor
from proben_tpu_torch.engine.train import make_train_step, trainable_mask
from proben_tpu_torch.export.api import export_model
from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines
from proben_tpu_torch.models import rcnn as t_rcnn
from proben_tpu_torch.models.roi_heads import ROIHeadsConfig
from proben_tpu_torch.models.rpn import RPNConfig
from proben_tpu_torch.native import io
from proben_tpu_torch.ops import nms, roi_align_cuda, stem_cuda
from proben_tpu_torch.solver import SolverConfig
from proben_tpu_torch.structures import GroundTruth
from proben_tpu_torch.utils import tracing

H, W = 64, 96
STAGES = ("rcnn.features", "rcnn.rpn", "rcnn.roi_pool", "rcnn.box")
# each loop's spans that run once per call, in order, and what holds them
ONCE = {
    "predict_batch": {"predictor.predict_batch": None, **dict.fromkeys(STAGES, "predictor.predict_batch"),
                      "predictor.to_host": "predictor.predict_batch"},
    "train_step": {"train.step": None, **dict.fromkeys(STAGES, "train.step"),
                   "train.backward": "train.step", "train.update": "train.step",
                   "train.nan_guard": "train.update"},
}
# spans under a stage, at least once each: (span, the stage that holds it)
INNER = {
    "predict_batch": [("roi.window_inputs", "rcnn.roi_pool"), ("roi.fallback", "rcnn.roi_pool"),
                      ("nms.fixpoint", "rcnn.rpn"), ("nms.fixpoint", "rcnn.box")],
    "train_step": [("roi.window_inputs", "rcnn.roi_pool"), ("roi.fallback", "rcnn.roi_pool"),
                   ("nms.fixpoint", "rcnn.rpn")],
}


def _cfg():
    return build_config(depth=50, fpn_channels=32,
                        rpn=RPNConfig(pre_nms_topk_test=200, post_nms_topk_test=50,
                                      pre_nms_topk_train=200, post_nms_topk_train=50),
                        roi=ROIHeadsConfig(num_classes=3, batch_size_per_image=32))


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.rand(2, H, W, 3) * 255).astype(np.float32))


def _gt(seed=0):
    rng = np.random.RandomState(seed)
    xy = rng.rand(2, 4, 2) * 50
    boxes = np.concatenate([xy, xy + rng.rand(2, 4, 2) * 30 + 10], -1).astype(np.float32)
    return GroundTruth(torch.from_numpy(boxes), torch.from_numpy(rng.randint(0, 3, (2, 4)).astype(np.int32)),
                       torch.ones(2, 4, dtype=torch.bool))


def _loop(name):
    """A fresh tiny float32 model's loop: a function of no arguments that
    runs one call of ``Predictor.predict_batch`` or ``train_step``."""
    cfg = _cfg()
    model = build_model(cfg, params=random_affines(init_rcnn(0, cfg), 0), device="cpu")
    sizes = torch.tensor([[H, W], [60, 90]], dtype=torch.int32)
    if name == "predict_batch":
        pred = Predictor(model, cfg, device="cpu")
        batch = {"image": _images(), "image_size": sizes, "orig_size": sizes, "image_id": [0, 1]}
        return lambda: pred.predict_batch(batch)
    init, step = make_train_step(cfg, SolverConfig(warmup_iters=0), trainable_mask(model, cfg.freeze_at))
    state = init(model, 0)
    batch = {"image": _images(), "image_size": sizes, "gt": _gt()}
    return lambda: step(state, batch)


def _trace(fn, path):
    """The Chrome trace of ``fn()`` under the CPU profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    return json.loads(Path(path).read_text())


def _spans(raw):
    return [e for e in raw["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _within(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_span_is_the_shared_no_op_without_a_profiler(tmp_path):
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("recorded.never"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.span("a") is not tracing.span("b")
        with tracing.span("recorded.once"):
            torch.ones(2).sum()
    assert tracing.span("a") is tracing.span("b")
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    names = [e["name"] for e in _spans(json.loads((tmp_path / "t.json").read_text()))]
    assert names == ["recorded.once"]


@pytest.mark.parametrize("loop", ("predict_batch", "train_step"))
def test_loop_emits_each_stage_span_once_nested(loop, tmp_path):
    fn = _loop(loop)
    fn()  # first call outside the trace
    spans = _spans(_trace(fn, tmp_path / "t.json"))
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    assert {e["tid"] for e in spans} == {spans[0]["tid"]}
    for name, parent in ONCE[loop].items():
        assert len(by_name.get(name, [])) == 1, (name, len(by_name.get(name, [])))
        if parent is not None:
            assert _within(by_name[name][0], by_name[parent][0]), (name, parent)
    root = next(iter(ONCE[loop]))
    stages = [by_name[n][0]["ts"] for n, parent in ONCE[loop].items() if parent == root]
    assert stages == sorted(stages)
    for name, stage in INNER[loop]:
        assert any(_within(e, by_name[stage][0]) for e in by_name[name]), (name, stage)
    allowed = set(ONCE[loop]) | {n for n, _ in INNER[loop]}
    assert set(by_name) <= allowed, set(by_name) - allowed
    assert "train.all_reduce" not in by_name  # one process: no mean over ranks


def _chains(lengths, n=12):
    """Score-sorted boxes with one suppression chain of ``lengths[b]``
    links in problem ``b``: box i overlaps box i + 1 at IoU 0.6 (> 0.5)
    and box i + 2 at 1/3; the rest are far apart."""
    boxes = np.zeros((len(lengths), n, 4), np.float32)
    for b, links in enumerate(lengths):
        for i in range(n):
            x = 10.0 * i if i <= links else 1000.0 + 100.0 * i
            boxes[b, i] = [x, 0.0, x + 40.0, 40.0]
    scores = np.tile(np.linspace(1.0, 0.1, n, dtype=np.float32), (len(lengths), 1))
    return torch.from_numpy(boxes), torch.from_numpy(scores), torch.ones(len(lengths), n, dtype=torch.bool)


@pytest.mark.parametrize("lengths", ([0], [1], [3], [6], [2, 5]), ids=("0", "1", "3", "6", "2_and_5"))
def test_nms_iterations_follow_the_longest_suppression_chain(lengths):
    boxes, scores, valid = _chains(lengths)
    before = tracing.counters()
    keep = nms.nms_mask(boxes, scores, valid, 0.5)
    after = tracing.counters()
    assert after["nms.calls"] - before.get("nms.calls", 0) == 1
    assert after["nms.iters"] - before.get("nms.iters", 0) == max(lengths) + 1
    for b, links in enumerate(lengths):  # greedy keeps every other box of the chain
        want = [i % 2 == 0 if i <= links else True for i in range(boxes.shape[1])]
        assert keep[b].tolist() == want


def _planted(per_image, seed=0):
    """Level maps of a 256x512 batch and, per image, ``per_image[b]`` boxes
    too wide for their p2 window (75 columns against 64) among 6 that fit."""
    rng = np.random.RandomState(seed)
    feats = [torch.from_numpy(rng.rand(len(per_image), 256 // s, 512 // s, 4).astype(np.float32))
             for s in (4, 8, 16, 32)]
    k = max(per_image) + 6
    boxes = np.zeros((len(per_image), k, 4), np.float32)
    for b, n in enumerate(per_image):
        for i in range(k):
            x, y = rng.uniform(0, 180), rng.uniform(0, 200)
            boxes[b, i] = [x, y, x + 300, y + 40] if i < n else [x, y, x + 60, y + 40]
        boxes[b] = boxes[b, rng.permutation(k)]
    return feats, torch.from_numpy(boxes)


@pytest.mark.parametrize("per_image", ([0, 0], [2, 1], [3, 3], [5, 2]),
                         ids=("none", "below", "at", "above"))
def test_out_of_window_counters_equal_a_direct_count(per_image):
    capacity = 3
    feats, boxes = _planted(per_image)
    oow = roi_align_cuda.window_inputs(feats, boxes, (4, 8, 16, 32))[5].reshape(boxes.shape[:2])
    direct = oow.sum(1).tolist()
    assert direct == per_image
    before = tracing.counters()
    roi_align_cuda.multilevel_roi_align(feats, boxes, (4, 8, 16, 32), fallback_capacity=capacity)
    after = tracing.counters()
    assert after["roi.oow"] - before.get("roi.oow", 0) == sum(direct)
    assert (after["roi.oow_over_capacity"] - before.get("roi.oow_over_capacity", 0)
            == sum(max(n - capacity, 0) for n in direct))


def test_launch_counts_live_in_the_registry_alone():
    for module in (stem_cuda, roi_align_cuda, io):
        assert not hasattr(module, "launches") and not hasattr(module, "bwd_launches"), module.__name__
    before = tracing.counters()
    tracing.count("test.launches", 2)
    tracing.count("test.launches")
    snapshot = tracing.counters()
    snapshot["test.launches"] += 100  # a copy
    assert tracing.counters()["test.launches"] - before.get("test.launches", 0) == 3


def test_counts_from_many_threads_lose_no_update():
    """Loader threads and autograd's backward threads launch kernels: every
    add of every thread lands."""
    threads, adds = 4 * (os.cpu_count() or 1), 2000
    before = tracing.counters().get("test.threads", 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [tracing.count("test.threads") for _ in range(adds)])
                   for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in workers)
    assert tracing.counters()["test.threads"] - before == threads * adds


def test_export_under_the_profiler_holds_no_span_or_counter_node(tmp_path):
    cfg = _cfg()
    model = build_model(cfg, params=random_affines(init_rcnn(0, cfg), 0), device="cpu").eval()
    sizes = torch.tensor([[H, W], [60, 90]], dtype=torch.int32)
    before = tracing.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        path = export_model(functools.partial(t_rcnn.rcnn_inference, model, cfg), (_images(), sizes),
                            str(tmp_path))
    assert tracing.counters() == before
    targets = {str(n.target) for n in torch.export.load(path).graph.nodes if n.op == "call_function"}
    assert not [t for t in targets if "profiler" in t or "record_function" in t], targets


@pytest.mark.parametrize("loop", ("predict_batch", "train_step"))
def test_benchmark_readers_read_the_same_with_spans_as_without(loop, tmp_path, monkeypatch):
    """The benchmark reads the profiler's host ops, kernels and runtime
    calls, and of the user annotations only its own iteration ranges. The
    program's spans are user annotations on the loop's thread and add no
    event of any other kind: the same step traced with ``span`` suppressed
    holds every other event the traced one holds, name for name."""
    events = {}
    for spans_on in (True, False):
        if not spans_on:
            monkeypatch.setattr(tracing, "span", lambda name: tracing._OFF)
        fn = _loop(loop)  # fresh state: both traces run the same step
        fn()
        raw = _trace(fn, tmp_path / f"{spans_on}.json")
        spans = _spans(raw)
        assert bool(spans) == spans_on
        assert {e["name"] for e in spans} <= set(ONCE[loop]) | {n for n, _ in INNER[loop]}
        events[spans_on] = Counter((e.get("cat"), e["name"]) for e in raw["traceEvents"]
                                   if e.get("ph") == "X" and e.get("cat") != "user_annotation")
    assert events[True] == events[False]
    assert events[True][("cpu_op", "aten::matmul")] > 0
