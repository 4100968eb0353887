"""The program's stage spans in the harness's traces, on the CPU: the idle
of a synthetic trace split by span comes out exact, the per-layer readers
read the same with the program's spans as without them, and the span
probe runs a tiny cell."""

from __future__ import annotations

import json
import time

import pytest

import span_probe
import tiny
from harness import cells, trace as htrace
from harness.spans import OUTSIDE, Spans
from proben_tpu_torch.utils import tracing

pytestmark = pytest.mark.card_free


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def _synthetic():
    """Two iterations (0-100 and 120-200 us) on thread 1; spans A (0-60)
    holding B (10-30), then C (60-100); a span on another thread; kernels,
    a copy and a set at 5-10, 40-50, 70-80, 130-190 and across the gap
    between the iterations."""
    return {"traceEvents": [
        _ev(htrace.ITER, "user_annotation", 0, 100), _ev(htrace.ITER, "user_annotation", 120, 80),
        _ev("A", "user_annotation", 0, 60), _ev("B", "user_annotation", 10, 20),
        _ev("C", "user_annotation", 60, 40), _ev("loader", "user_annotation", 0, 200, tid=2),
        _ev("aten::mm", "cpu_op", 12, 5),
        _ev("k0", "kernel", 5, 5), _ev("copy", "gpu_memcpy", 40, 10), _ev("k1", "kernel", 70, 10),
        _ev("set", "gpu_memset", 130, 60), _ev("k2", "kernel", 195, 30),
    ]}


def test_idle_of_a_synthetic_trace_splits_by_the_innermost_span():
    sp = Spans(_synthetic())
    assert sp.names == ["A", "B", "C"]
    # idle in the iterations: 0-5, 10-40, 50-70, 80-100, 120-130, 190-195
    assert sp.idle_s == pytest.approx(90e-6, abs=1e-12)
    assert {n: sp.span_idle_seconds(n) for n in sp.names} == pytest.approx(
        {"A": 45e-6, "B": 20e-6, "C": 30e-6}, abs=1e-12)
    assert sp.span_idle_seconds("loader") == 0.0
    by = sp.idle_by_span()
    assert by == pytest.approx({"C": 30e-6, "A": 25e-6, "B": 20e-6, OUTSIDE: 15e-6}, abs=1e-12)
    assert list(by) == ["C", "A", "B", OUTSIDE]
    assert sum(by.values()) == pytest.approx(sp.idle_s, abs=1e-12)
    tr = htrace.Trace(_synthetic())
    assert (tr.launches, tr.busy_s) == (3, pytest.approx(115e-6, abs=1e-12))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("workload", ("tiny.tiny_infer", "tiny.tiny_train"))
def test_readers_read_the_same_with_spans_as_without(tree, workload, monkeypatch):
    """The harness's traced phase twice on the same arguments, the
    program's spans suppressed in the first: every per-layer metric the
    cell reports reads the same."""
    harness_traced, profile, seen, metrics = cells.traced, htrace.profile, [], []

    def recording(*args, **kwargs):
        raw = profile(*args, **kwargs)
        seen.append(sorted({e["name"] for e in raw["traceEvents"]
                            if e.get("cat") == "user_annotation" and e["name"] != htrace.ITER}))
        return raw

    def twice(*args):
        span = tracing.span
        monkeypatch.setattr(tracing, "span", lambda name: tracing._OFF)
        metrics.append(harness_traced(*args)["metrics"])
        monkeypatch.setattr(tracing, "span", span)
        out = harness_traced(*args)
        metrics.append(out["metrics"])
        return out

    monkeypatch.setattr(cells, "profile", recording)
    monkeypatch.setattr(cells, "traced", twice)
    out = cells.run(tree, workload, 5, 0.3, True, "cpu", time.perf_counter())
    assert out["correct"] is True
    assert len(seen) == 4 and seen[0] == seen[1] == [] and seen[2] and seen[2] == seen[3]
    assert metrics[0] and metrics[0] == metrics[1]


def test_span_probe_splits_a_tiny_cells_idle(tree, capsys):
    assert span_probe.main(["--workload", "tiny.tiny_infer", "--seed", "7", "--seconds", "0.3",
                            "--pairs", "1", "--device", "cpu", "--root", str(tree)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["correct"] is True
    assert rec["span_calls"]["predictor.predict_batch"] == rec["span_calls"]["rcnn.box"] == 1.0
    assert rec["counters"]["nms.calls"] == 2.0 and rec["counters"]["nms.iters"] >= 2.0
    # no device on the CPU: the whole of each iteration is idle
    assert sum(rec["idle_by_span_ms"].values()) == pytest.approx(rec["idle_ms"], rel=1e-9)
    assert rec["span_idle_ms"]["predictor.predict_batch"] <= rec["idle_ms"]
    assert [len(rec["passes"][m]) for m in ("on", "off")] == [1, 1]
    assert {"syncs_per_batch.infer", "launches_per_batch.infer"} <= set(rec["harness"])


def test_layers_counters_are_what_span_probe_reads(tree, monkeypatch):
    """The readers' ``layers.counters`` and ``layers.spans`` of a run are
    span_probe's readings of it: the first traced pass's counters per
    iteration (two NMS calls a batch, the RPN's and the classes') and its
    spans."""
    seen = []
    report = cells.report

    def keep(cell, layers):
        seen.append(layers)
        return report(cell, layers)

    monkeypatch.setattr(cells, "report", keep)
    rec = span_probe.probe(tree, "tiny.tiny_infer", 7, 0.3, 0, "cpu")
    assert rec["correct"] is True and len(seen) == 1
    layers = seen[0]
    assert layers.counters == rec["counters"]
    assert layers.counters["nms.calls"] == 2.0 and layers.counters["nms.iters"] >= 2.0
    n = layers.iters
    assert {k: 1e3 * layers.spans.span_idle_seconds(k) / n for k in layers.spans.names} == rec["span_idle_ms"]
    assert layers.spans.calls("predictor.predict_batch") == n
