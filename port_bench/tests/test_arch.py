"""The architecture seam on the CPU: an ensemble of two detectors joins the
benchmark as new files and entries only (an architecture, its
configuration, two cells with their limits, and a per-layer metric that
reads the program's spans and counters), a loop joins as a file, a
configuration naming an architecture with no file fails before any work,
and the benchmark's own configurations resolve to ``faster_rcnn_fpn``."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from harness import cells
import tiny

pytestmark = pytest.mark.card_free

PAIR_ARCH = '''"""Two detectors answering together on one 6-channel frame (a test
architecture): the tiny BGR R50-FPN on its first three channels and the
tiny BGRTTT one on all six. An image's answer, the program's and the
reference's, is the two members' detections concatenated; a training step
steps both members, its losses summed, its leaves named by member."""

from pathlib import Path

import numpy as np

from harness import cells

fpn = cells.load_module(Path(__file__).with_name("faster_rcnn_fpn.py"))
OPS = fpn.OPS
KEYS = ("boxes", "scores", "classes")


def channels(conf):
    return 6


def _view(member, batch):
    return dict(batch, image=batch["image"][..., :fpn.channels(member)].contiguous())


def _concat(answers):
    return [{k: np.concatenate([a[k] for a in per]) for k in KEYS} for per in zip(*answers)]


def _named(parts):
    return {f"{i}.{n}": v for i, part in enumerate(parts) for n, v in part.items()}


def read_config(config_dir, conf):
    return [(m, fpn.read_config(config_dir, m)) for m in conf["members"]]


def make_state(conf, seed, batch, device):
    return [fpn.make_state(m, seed + i, _view(m, batch), device) for i, m in enumerate(conf["members"])]


class Pair:
    def __init__(self, members):
        self.members = members  # (member's config, its predictor)

    def predict_batch(self, batch):
        return _concat([p.predict_batch(_view(m, batch)) for m, p in self.members])


class PairTrainer:
    def __init__(self, members):
        self.members = members  # (member's config, its trainer)

    def batch(self, pool_batch):
        return [t.batch(_view(m, pool_batch)) for m, t in self.members]

    def step(self, batch):
        out = [t.step(b) for (_, t), b in zip(self.members, batch)]
        return {k: sum(o[k] for o in out) for k in out[0]}

    def params(self):
        return _named([t.params() for _, t in self.members])

    def momentum(self):
        return _named([t.momentum() for _, t in self.members])


def predictor(pcfg, state, device):
    return Pair([(m, fpn.predictor(c, s, device)) for (m, c), s in zip(pcfg, state)])


def trainer(pcfg, state, seed, device):
    return PairTrainer([(m, fpn.trainer(c, s, seed, device)) for (m, c), s in zip(pcfg, state)])


def reference_detections(conf, state, images, device, precision="fp32"):
    return _concat([fpn.reference_detections(m, s, [im[..., :fpn.channels(m)] for im in images], device,
                                             precision) for m, s in zip(conf["members"], state)])


def reference_steps(conf, state, pool, seed, steps, device, precision="fp32", batch_filter=None):
    outs = [fpn.reference_steps(m, s, [_view(m, b) for b in pool], seed, steps, device, precision, batch_filter)
            for m, s in zip(conf["members"], state)]
    losses = [{k: sum(o["losses"][i][k] for o in outs) for k in outs[0]["losses"][i]} for i in range(steps)]
    return dict(losses=losses, **{key: _named([o[key] for o in outs]) for key in ("grad", "grad_raw", "update")})


def flops_per_image(conf, training):
    return sum(fpn.flops_per_image(m, training) for m in conf["members"])
'''

RPN_IDLE = '''"""Device idle inside the program's RPN stage per NMS fixpoint iteration,
in ms (a test metric: a stage span and a counter read from the traced pass)."""


def read(layers):
    iters = layers.counters.get("nms.iters")
    if not iters or layers.kind != "{kind}":
        return None
    return 1e3 * layers.spans.span_idle_seconds("rcnn.rpn") / layers.iters / iters
'''

LOOP = '''"""The closed inference loop given as a file of its own (a test loop)."""

from harness import cells


def run(cell, seed, seconds, trace, device, t0):
    cells.log("loop: closed_batches from its file")
    return cells.run_infer(cell, seed, seconds, trace, device, t0)
'''


def _files(root: Path) -> dict:
    """{relative path: sha256} of every file of the tree outside its links
    to the repository's code."""
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if not os.path.islink(os.path.join(d, x))]
        for f in files:
            p = Path(d) / f
            if not p.is_symlink():
                out[str(p.relative_to(root))] = hashlib.sha256(p.read_bytes()).hexdigest()
    return out


def _only_added(old, new) -> bool:
    """``new`` holds ``old`` whole: the same scalars, every key of a dict,
    each list with ``old``'s entries first."""
    if isinstance(old, dict):
        return isinstance(new, dict) and all(k in new and _only_added(v, new[k]) for k, v in old.items())
    if isinstance(old, list):
        return isinstance(new, list) and len(new) >= len(old) and all(map(_only_added, old, new))
    return old == new


def _add_cell(bench: dict, root: Path, config: str, mix: str, limits: dict, e2e) -> str:
    cell = f"{config}.{mix}"
    bench["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"]:
        if m["name"] in e2e:
            m["workloads"].append(cell)
    (root / "port_bench" / "limits" / f"{cell}.json").write_text(json.dumps({"limits": limits}))
    return cell


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny checkout, then an ensemble, a loop and a configuration with
    a missing architecture added to it as new files and entries."""
    root = tiny.make_tree(tmp_path_factory.mktemp("checkout"))
    parent_files = _files(root)
    parent_bench = json.loads((root / "BENCHMARK.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "port_bench"
    infer_e2e, train_e2e = ("infer_img_s", "infer_batch_p95_ms"), ("train_img_s",)

    d = pb / "configs" / "tiny_pair"
    d.mkdir()
    members = []
    for name, fmt in (("bgr", "BGR"), ("mf", "BGRTTT")):
        m = tiny.tiny_config(f"tiny_pair_{name}", "float32", fmt)
        m["yaml"] = f"{name}.yaml"
        (d / m["yaml"]).write_text(tiny.tiny_yaml(m))
        members.append(m)
    (d / "Base-RCNN-FPN.yaml").write_bytes((pb / "configs" / "flir_r101_fpn" / "Base-RCNN-FPN.yaml").read_bytes())
    conf = {"name": "tiny_pair", "arch": "tiny_pair", "input": members[0]["input"], "members": members}
    (d / "config.json").write_text(json.dumps(conf))
    (pb / "arch" / "tiny_pair.py").write_text(PAIR_ARCH)
    bench["configs"].append({"name": "tiny_pair", "source": "https://arxiv.org/abs/2104.02904",
                             "file": "port_bench/configs/tiny_pair/config.json", "reduced": ["depth"],
                             "why": "two tiny R50-FPNs answering together, for the CPU tests"})
    pair = {"infer": _add_cell(bench, root, "tiny_pair", "tiny_infer", tiny.LIMITS["tiny_infer"], infer_e2e),
            "train": _add_cell(bench, root, "tiny_pair", "tiny_train", tiny.LIMITS["tiny_train"], train_e2e)}
    for kind, e2e in (("infer", infer_e2e[0]), ("train", train_e2e[0])):
        name = f"rpn_idle_per_nms_iter.{kind}_test"
        (pb / "metrics" / f"{name}.py").write_text(RPN_IDLE.replace("{kind}", kind))
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower", "source": "program_span",
                                   "layer": "test", "moves": e2e, "workloads": [pair[kind]]})

    (pb / "loops").mkdir(exist_ok=True)
    (pb / "loops" / "closed_batches.py").write_text(LOOP)
    (pb / "traffic" / "tiny_infer_by_file.json").write_text(
        json.dumps(dict(tiny.TRAFFIC["tiny_infer"], loop="closed_batches")))
    _add_cell(bench, root, "tiny", "tiny_infer_by_file", tiny.LIMITS["tiny_infer"], infer_e2e)

    d = pb / "configs" / "tiny_none"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(tiny.tiny_config("tiny_none"), arch="no_such_arch")))
    bench["configs"].append({"name": "tiny_none", "source": "https://arxiv.org/abs/2104.02904",
                             "file": "port_bench/configs/tiny_none/config.json", "reduced": [],
                             "why": "an architecture with no file"})
    _add_cell(bench, root, "tiny_none", "tiny_infer", tiny.LIMITS["tiny_infer"], infer_e2e)

    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return {"root": root, "parent_files": parent_files, "parent_bench": parent_bench, "pair": pair}


def test_only_new_files_and_entries_were_added(tree):
    files = _files(tree["root"])
    assert {p: h for p, h in files.items() if p in tree["parent_files"] and p != "BENCHMARK.json"} == {
        p: h for p, h in tree["parent_files"].items() if p != "BENCHMARK.json"}
    bench = json.loads((tree["root"] / "BENCHMARK.json").read_text())
    assert _only_added(tree["parent_bench"], bench)
    assert {"port_bench/arch/tiny_pair.py", "port_bench/loops/closed_batches.py"} <= set(files) - set(
        tree["parent_files"])


@pytest.mark.parametrize("kind", ("infer", "train"))
def test_an_ensemble_added_as_files_runs_correct_with_its_metric(tree, kind):
    cell = tree["pair"][kind]
    out = cells.run(tree["root"], cell, 5, 0.3, True, "cpu", time.perf_counter())
    assert out["correct"] is True, out["checks"]
    value = out["metrics"][f"rpn_idle_per_nms_iter.{kind}_test"]["value"]
    assert value > 0.0  # no device on the CPU: the RPN stage idles throughout
    c = cells.Cell(tree["root"], cell)
    assert (c.channels, len(c.conf["members"])) == (6, 2)


def test_a_loop_added_as_a_file_runs(tree, capsys):
    out = cells.run(tree["root"], "tiny.tiny_infer_by_file", 5, 0.3, False, "cpu", time.perf_counter())
    assert out["correct"] is True
    assert set(out["metrics"]) == {"setup_s", "infer_img_s", "infer_batch_p95_ms"}
    assert "loop: closed_batches from its file" in capsys.readouterr().err


def test_a_missing_architecture_fails_before_any_work(tree):
    with pytest.raises(FileNotFoundError, match="no_such_arch"):
        cells.Cell(tree["root"], "tiny_none.tiny_infer")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "tiny_none.tiny_infer", "--seed", "1",
                           "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tree["root"], timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no_such_arch" in proc.stderr


def test_the_benchmarks_configurations_resolve_to_faster_rcnn_fpn():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cells.Cell(tiny.REPO, w["name"])
        assert "arch" not in cell.conf
        assert Path(cell.arch.__file__) == tiny.BENCH / "arch" / "faster_rcnn_fpn.py"
        assert cell.channels == (6 if cell.conf["model"]["input_format"] == "BGRTTT" else 3)
