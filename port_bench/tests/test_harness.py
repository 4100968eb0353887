"""The harness on the CPU: it finds a configuration, traffic mixes, cells and
a per-layer metric added as new files and entries; a run's result line has
the contract's keys; a run without a card prints nothing and fails; and a
run whose timed path is broken underneath comes out not correct."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from harness import cells
import tiny

pytestmark = pytest.mark.card_free

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tiny.make_tree(tmp_path_factory.mktemp("checkout"))
    # a per-layer metric added as a file of its own and an entry
    (root / "port_bench" / "metrics" / "iters_traced.tiny.py").write_text(
        '"""Traced iterations (a test metric)."""\n\n\ndef read(layers):\n    return float(layers.iters)\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "iters_traced.tiny", "unit": "count", "better": "higher",
                               "source": "device_trace", "layer": "harness", "moves": "infer_img_s",
                               "workloads": ["tiny.tiny_infer"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(tree, workload, trace=False, seed=5, seconds=0.3):
    return cells.run(tree, workload, seed, seconds, trace, "cpu", time.perf_counter())


def test_added_files_make_a_cell_with_its_metrics(tree):
    out = _run(tree, "tiny.tiny_infer")
    assert list(out) == KEYS
    assert out["correct"] is True
    assert set(out["metrics"]) == {"setup_s", "infer_img_s", "infer_batch_p95_ms"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    traced = _run(tree, "tiny.tiny_infer", trace=True)
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert traced["metrics"]["iters_traced.tiny"]["value"] == 2.0
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def test_training_cell_reports_train_metrics(tree):
    out = _run(tree, "tiny.tiny_train")
    assert list(out) == KEYS and out["correct"] is True
    assert set(out["metrics"]) == {"setup_s", "train_img_s"}
    assert set(out["checks"]) == {"loss_rpn_loc_gap", "update_gap_p90_leaf"}


def test_a_run_without_a_card_fails_and_prints_nothing():
    proc = subprocess.run([sys.executable, str(tiny.BENCH / "run.py"), "--workload", "flir_r101_fpn.infer_b16",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tiny.REPO, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def _drop_half(predict_batch):
    def broken(self, batch):
        out = predict_batch(self, batch)
        return [o if i < len(out) // 2 else {k: v[:0] if hasattr(v, "shape") else v for k, v in o.items()}
                for i, o in enumerate(out)]
    return broken


def _alter_one(predict_batch):
    def broken(self, batch):
        out = predict_batch(self, batch)
        out[0] = dict(out[1], image_id=out[0]["image_id"])  # one image answered with another's detections
        return out
    return broken


@pytest.mark.parametrize("fault", (_drop_half, _alter_one), ids=("half_batch", "answer_altered"))
def test_broken_inference_is_not_correct(tree, fault, monkeypatch):
    from proben_tpu_torch.engine.predictor import Predictor

    monkeypatch.setattr(Predictor, "predict_batch", fault(Predictor.predict_batch))
    out = _run(tree, "tiny.tiny_infer", seed=9, seconds=1.0)  # two batches or more
    assert out["correct"] is False


def _unchanged_state(make_train_step):
    def broken(*args, **kwargs):
        init_state, step = make_train_step(*args, **kwargs)

        def same(state, batch):
            saved = [q.detach().clone() for q in state.model.parameters()]
            _, metrics = step(state, batch)
            for p, old in zip(state.model.parameters(), saved):
                p.data.copy_(old)
            return state, metrics
        return init_state, same
    return broken


def _half_batch(losses_and_grads):
    def broken(model, cfg, batch, generator):
        n = batch["image"].shape[0] // 2
        gt = batch["gt"]
        half = {"image": batch["image"][:n], "image_size": batch["image_size"][:n],
                "gt": type(gt)(gt.boxes[:n], gt.classes[:n], gt.valid[:n])}
        return losses_and_grads(model, cfg, half, generator)
    return broken


def test_training_with_its_state_unchanged_is_not_correct(tree, monkeypatch):
    from proben_tpu_torch.engine import train

    monkeypatch.setattr(train, "make_train_step", _unchanged_state(train.make_train_step))
    assert _run(tree, "tiny.tiny_train", seed=9)["correct"] is False


def test_training_on_half_the_batch_is_not_correct(tree, monkeypatch):
    from proben_tpu_torch.engine import train

    monkeypatch.setattr(train, "losses_and_grads", _half_batch(train.losses_and_grads))
    assert _run(tree, "tiny.tiny_train", seed=9)["correct"] is False
