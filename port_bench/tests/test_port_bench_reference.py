"""The frozen reference against the program at a tiny size on the CPU (plain
paths, float32): the same weights and frames give the same detections and
the same training losses and gradients, for one backbone and for middle
fusion; and the import rules of the benchmark's files."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import cells, frames
from reference import model as ref
import tiny

pytestmark = pytest.mark.card_free

BENCH = Path(__file__).resolve().parent.parent
FORMATS = ("BGR", "BGRTTT")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("checkout"),
                          configs=(("tiny", "float32", "BGR"), ("tinymf", "float32", "BGRTTT")))


def _cell(tree, fmt, mix):
    return cells.Cell(tree, f"{'tinymf' if fmt == 'BGRTTT' else 'tiny'}.{mix}")


def _build(cell, seed, batch):
    pcfg = cell.arch.read_config(str(cell.config_file.parent), cell.conf)
    return pcfg, cells.make_weights(cell, seed, batch, "cpu")


@pytest.mark.parametrize("fmt", FORMATS)
def test_inference_detections_agree(tree, fmt):
    cell = _cell(tree, fmt, "tiny_infer")
    pool = frames.inference_pool(21, cell.traffic, cell.conf["input"], 6 if fmt == "BGRTTT" else 3, "cpu")
    pcfg, sd = _build(cell, 21, pool[0])
    served = cell.arch.predictor(pcfg, sd, "cpu").predict_batch(pool[0])
    want = cell.arch.reference_detections(cell.conf, sd, list(pool[0]["image"]), "cpu")
    assert sum(len(w["scores"]) for w in want) > 0
    for got, exp in zip(served, want):
        assert np.array_equal(got["classes"], exp["classes"])
        np.testing.assert_allclose(got["scores"], exp["scores"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["boxes"], exp["boxes"], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("fmt", FORMATS)
def test_training_losses_and_gradients_agree(tree, fmt):
    cell = _cell(tree, fmt, "tiny_train")
    pool = frames.training_pool(22, cell.traffic, cell.conf["input"], 6 if fmt == "BGRTTT" else 3, "cpu")
    pcfg, sd = _build(cell, 22, pool[0])
    trainer = cell.arch.trainer(pcfg, sd, 22, "cpu")
    losses = [float(trainer.step(trainer.batch(pool[0]))["total_loss"])]
    grad = cells.norms(trainer.momentum())
    losses.append(float(trainer.step(trainer.batch(pool[1]))["total_loss"]))
    want = cell.arch.reference_steps(cell.conf, sd, pool, 22, 2, "cpu")
    np.testing.assert_allclose(losses, [x["total_loss"] for x in want["losses"]], rtol=1e-4)
    assert sorted(grad) == sorted(want["grad"])
    for name, v in want["grad"].items():
        assert abs(grad[name] - v) <= 1e-3 * max(v, 1e-6), name


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def test_no_jax_and_a_reference_apart_from_the_program():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        names = set(_imports(f))
        assert not names & {"jax", "jaxlib", "flax", "proben_tpu"}, f
        if "reference" in f.relative_to(BENCH).parts:
            assert "proben_tpu_torch" not in names and "harness" not in names, f


def test_fp8_control_rounds_values_to_e4m3_and_gradients_to_e5m2():
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0], requires_grad=True)
    y = ref.fp8(x)
    np.testing.assert_array_equal(y.detach().numpy(), [1.0, 1.0, 1.125, 448.0])
    y.backward(torch.tensor([1.0, 1.1, 1.3, 57344.0]))
    np.testing.assert_array_equal(x.grad.numpy(), [1.0, 1.0, 1.25, 57344.0])
