"""The ``proben_late`` architecture on the CPU: a tiny ProbEn3 ensemble
(thermal-only on TTT, BGRT early fusion, BGRTTT middle fusion, R50-FPN
members with the variance head, float32) joins a tiny checkout as new files
and entries only, runs ``correct`` against the member references and the
reference fusion loop, and its two fusion metrics read there and nowhere
else; the benchmark's own ProbEn configuration reads its frozen YAMLs as
its ``config.json`` has them; the four R-CNN configurations still resolve
to ``faster_rcnn_fpn``."""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import pytest

from harness import cells
import tiny

pytestmark = pytest.mark.card_free

CELL = "tiny_proben.tiny_infer"
FUSE_METRICS = ("fuse_idle_ms.infer", "fuse_iters_per_batch.infer")
THERMAL = 135.438
BGRT_MODEL = f"""
  PIXEL_MEAN: [103.530, 116.280, 123.675, {THERMAL}]
  PIXEL_STD: [1.0, 1.0, 1.0, 1.0]"""
BGRT_INPUT = """
  FORMAT: "BGRT"
  NUM_IN_CHANNELS: 4"""
MEMBER_YAML = """_BASE_: "{base}"
MODEL:
  BACKBONE:
    FREEZE_AT: 3
  ROI_HEADS:
    SCORE_THRESH_TEST: 0.5
    ENABLE_GAUSSIANNLLOSS: True
  ROI_BOX_HEAD:
    OUTPUT_LOGITS: True
"""
MEMBERS = (("thermal_only", "BGR", [3, 6]), ("early_fusion", "BGRT", [0, 4]), ("middle_fusion", "BGRTTT", [0, 6]))


def tiny_member(name: str, fmt: str, channels) -> tuple:
    """A member's configuration and its base YAML: ``tiny``'s R50-FPN in
    the member's format, with the members' test settings."""
    m = tiny.tiny_config(f"tiny_proben_{name}", "float32", "BGRTTT" if fmt == "BGRTTT" else "BGR")
    if fmt == "BGRT":
        m["model"].update(input_format="BGRT", pixel_mean=[103.53, 116.28, 123.675, THERMAL],
                          pixel_std=[1.0] * 4)
        base = tiny.YAML.format(dtype="float32", model_extra=BGRT_MODEL, input_extra=BGRT_INPUT)
    else:
        base = tiny.tiny_yaml(m)
    m["model"].update(freeze_at=3, enable_gaussian_nll=True)
    m["model"]["test"]["score_thresh"] = 0.5
    m["weights"].update(var_logit_std=1.0, calibration_objects_per_frame=3)
    m.update(name=name, yaml=f"member_{name}.yaml", channels=list(channels))
    return m, base


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tiny.make_tree(tmp_path_factory.mktemp("checkout"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "port_bench"
    d = pb / "configs" / "tiny_proben"
    d.mkdir()
    (d / "Base-RCNN-FPN.yaml").write_bytes((pb / "configs" / "flir_r101_fpn" / "Base-RCNN-FPN.yaml").read_bytes())
    members = []
    for name, fmt, channels in MEMBERS:
        m, base = tiny_member(name, fmt, channels)
        (d / f"tiny_{name}.yaml").write_text(base)
        (d / m["yaml"]).write_text(MEMBER_YAML.format(base=f"tiny_{name}.yaml"))
        members.append(m)
    inp = members[0]["input"]
    conf = {"name": "tiny_proben", "arch": "proben_late", "input": inp, "members": members,
            "fusion": {"score_method": "probEn", "box_method": "v-avg", "iou_thresh": 0.5,
                       "class_offset": [float(inp["frame_hw"][1]), float(inp["frame_hw"][0])], "topk": 100}}
    (d / "config.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "tiny_proben", "source": "https://arxiv.org/abs/2104.02904",
                             "file": "port_bench/configs/tiny_proben/config.json", "reduced": ["depth"],
                             "why": "a tiny ProbEn3 ensemble for the CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny_proben", "traffic": "tiny_infer", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("infer_img_s", "infer_batch_p95_ms") + FUSE_METRICS:
            m["workloads"].append(CELL)
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps({"limits": tiny.LIMITS["tiny_infer"]}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_the_ensemble_runs_correct_with_its_fusion_metrics(tree):
    out = cells.run(tree, CELL, 5, 0.3, True, "cpu", time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["fuse_idle_ms.infer"]["value"] > 0.0  # no device on the CPU: the fusion idles
    assert out["metrics"]["fuse_iters_per_batch.infer"]["value"] >= 1.0
    cell = cells.Cell(tree, CELL)
    assert (cell.channels, len(cell.conf["members"])) == (6, 3)
    assert Path(cell.arch.__file__).name == "proben_late.py"


def test_the_fusion_metrics_read_nothing_in_another_cell(tree):
    """After the ensemble's run in the same process, a single detector's
    traced run reports neither fusion metric (the tiny checkout lists
    every ``.infer`` metric for its cells)."""
    cells.run(tree, CELL, 6, 0.2, False, "cpu", time.perf_counter())
    out = cells.run(tree, "tiny.tiny_infer", 5, 0.2, True, "cpu", time.perf_counter())
    assert out["correct"] is True
    assert not set(FUSE_METRICS) & set(out["metrics"])
    assert "launches_per_batch.infer" in out["metrics"]


def test_the_ensemble_reports_what_the_other_inference_cells_report(tree):
    out = cells.run(tree, CELL, 7, 0.2, False, "cpu", time.perf_counter())
    assert set(out["metrics"]) == {"setup_s", "infer_img_s", "infer_batch_p95_ms"}
    assert set(out["checks"]) == {"missed_pooled_pct", "unmatched_pooled_pct"}


def test_the_planted_fusion_faults_read_past_the_program(tree, capsys):
    """``proben_faults.py`` on the tiny ensemble: the fitted members'
    detections cluster, and ``avg`` scores in place of ``probEn`` miss
    reference detections the program finds. ``avg`` boxes in place of
    ``v-avg`` move a cluster's box less than the judge's IoU 0.5 match can
    see; ``tests/test_torch_proben_late.py`` holds the boxes to 1e-4."""
    spec = importlib.util.spec_from_file_location("proben_faults", tiny.BENCH / "proben_faults.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.readings(CELL, [11], "cpu", root=tree)
    lines = {d["kind"]: d for d in map(json.loads, capsys.readouterr().out.splitlines())}
    assert lines["clusters"]["multi_per_image"]["max"] >= 1
    program = lines["program"]["missed_pooled_pct"]
    assert program < tiny.LIMITS["tiny_infer"]["missed_pooled_pct"]
    assert lines["fault_probEn_to_avg"]["missed_pooled_pct"] > program, lines["fault_probEn_to_avg"]
    assert "fault_v_avg_to_avg" in lines


def test_the_benchmarks_proben_configuration_reads_its_yamls():
    cell = cells.Cell(tiny.REPO, "flir_proben_late.infer_b16")
    pcfg = cell.arch.read_config(str(cell.config_file.parent), cell.conf)
    formats = [cfg.INPUT.FORMAT for cfg, _ in pcfg["members"]]
    assert formats == ["BGR", "BGRT", "BGRTTT"]
    assert [ch for _, ch in pcfg["members"]] == [(3, 6), (0, 4), (0, 6)]
    assert all(cfg.MODEL.ROI_HEADS.ENABLE_GAUSSIANNLLOSS for cfg, _ in pcfg["members"])
    assert cell.conf["reduced"] == [] and cell.workload["chips"] == 1


def test_the_r_cnn_configurations_still_resolve_to_faster_rcnn_fpn():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    plain = [w["name"] for w in bench["workloads"] if w["config"] != "flir_proben_late"]
    assert len(plain) == 4
    for name in plain:
        cell = cells.Cell(tiny.REPO, name)
        assert "arch" not in cell.conf
        assert Path(cell.arch.__file__) == tiny.BENCH / "arch" / "faster_rcnn_fpn.py"
