"""A checkout in miniature for the CPU tests: the benchmark's code linked
in, and a configuration, traffic mixes, cells and limits of a tiny R50-FPN
added as new files and entries, as a later change would add them."""

from __future__ import annotations

import copy
import json
import os
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent

YAML = """_BASE_: "Base-RCNN-FPN.yaml"
MODEL:
  COMPUTE_DTYPE: "{dtype}"{model_extra}
  RESNETS:
    DEPTH: 50
  ROI_HEADS:
    NUM_CLASSES: 3
    BATCH_SIZE_PER_IMAGE: 64
  RPN:
    PRE_NMS_TOPK_TRAIN: 200
    PRE_NMS_TOPK_TEST: 100
    POST_NMS_TOPK_TRAIN: 100
    POST_NMS_TOPK_TEST: 100
SOLVER:
  IMS_PER_BATCH: 2
  STEPS: [210000, 250000]
  MAX_ITER: 270000
INPUT:
  PAD_SHAPE: [64, 96]
  MIN_SIZE_TEST: 64
  MAX_SIZE_TEST: 96
  MIN_SIZE_TRAIN: [48, 64]
  MAX_SIZE_TRAIN: 96
  MAX_GT: 8{input_extra}
"""
MF_MODEL = """
  PIXEL_MEAN: [103.530, 116.280, 123.675, 135.438, 135.438, 135.438]
  BACKBONE:
    FREEZE_AT: 3"""
MF_INPUT = """
  FORMAT: "BGRTTT"
  NUM_IN_CHANNELS: 6"""


def tiny_config(name: str, dtype: str = "float32", fmt: str = "BGR") -> dict:
    conf = json.loads((BENCH / "configs" / "flir_r101_fpn" / "config.json").read_text())
    conf = copy.deepcopy(conf)
    conf["name"] = name
    conf["yaml"] = "tiny.yaml"
    m = conf["model"]
    m.update(depth=50, compute_dtype=dtype)
    if fmt == "BGRTTT":
        m.update(input_format="BGRTTT", pixel_mean=[103.53, 116.28, 123.675, 135.438, 135.438, 135.438],
                 freeze_at=3)
    m["rpn"].update(pre_nms_topk_train=200, pre_nms_topk_test=100, post_nms_topk_train=100,
                    post_nms_topk_test=100)
    m["roi"]["batch_size_per_image"] = 64
    conf["solver"]["ims_per_batch"] = 2
    conf["input"].update(pad_shape=[64, 96], frame_hw=[32, 40], min_size_test=64, max_size_test=96,
                         min_size_train=[48, 64], max_size_train=96, max_gt=8)
    conf["weights"]["detections_per_image"] = 12
    return conf


def tiny_yaml(conf: dict) -> str:
    mf = conf["model"]["input_format"] == "BGRTTT"
    return YAML.format(dtype=conf["model"]["compute_dtype"], model_extra=MF_MODEL if mf else "",
                       input_extra=MF_INPUT if mf else "")


# float32 on both sides: the program reads ~0 (exact detections, losses to
# ~1e-6), the float8 control tens of percent
LIMITS = {"tiny_infer": {"missed_pooled_pct": 5.0, "unmatched_pooled_pct": 5.0},
          "tiny_train": {"loss_rpn_loc_gap": 1e-3, "update_gap_p90_leaf": 1e-2}}

TRAFFIC = {
    "tiny_infer": {"loop": "predict_batch", "batch": 2, "pool_batches": 3, "objects_per_frame": 3,
                   "warmup_batches": 1, "check_images": 6, "trace": {"iterations": 2, "captured_iterations": 1}},
    "tiny_train": {"loop": "train_step", "batch": 2, "pool_batches": 4,
                   "boxes_per_image": {"median": 3, "sigma": 0.5, "min": 1, "max": 6},
                   "checked_steps": 3, "warmup_steps": 0, "trace": {"iterations": 1, "captured_iterations": 1}},
}


def make_tree(root: Path, configs=(("tiny", "float32", "BGR"),), limits=None) -> Path:
    """``root`` as a checkout: the repository's BENCHMARK.json extended by
    the tiny configurations' cells, and ``port_bench`` holding the
    benchmark's code (linked, or copied where the tree adds files beside
    it) and the tiny configurations', mixes' and limits' new files. Returns
    ``root``."""
    root = Path(root)
    bench_dir = root / "port_bench"
    bench_dir.mkdir(parents=True)
    for sub in ("harness", "reference"):
        os.symlink(BENCH / sub, bench_dir / sub)
    shutil.copy(BENCH / "run.py", bench_dir)  # a copy, so that it finds the tree around it
    for sub in ("configs", "traffic", "limits", "metrics", "arch", "loops"):
        if (BENCH / sub).is_dir():
            shutil.copytree(BENCH / sub, bench_dir / sub)
    os.symlink(REPO / "proben_tpu_torch", root / "proben_tpu_torch")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, dtype, fmt in configs:
        d = bench_dir / "configs" / name
        d.mkdir()
        conf = tiny_config(name, dtype, fmt)
        (d / "config.json").write_text(json.dumps(conf))
        (d / "tiny.yaml").write_text(tiny_yaml(conf))
        shutil.copy(BENCH / "configs" / "flir_r101_fpn" / "Base-RCNN-FPN.yaml", d)
        bench["configs"].append({"name": name, "source": "https://arxiv.org/abs/2104.02904",
                                 "file": f"port_bench/configs/{name}/config.json", "reduced": ["depth"],
                                 "why": "a tiny R50-FPN for the CPU tests"})
        for mix, e2e in (("tiny_infer", ("infer_img_s", "infer_batch_p95_ms")), ("tiny_train", ("train_img_s",))):
            cell = f"{name}.{mix}"
            bench["workloads"].append({"name": cell, "config": name, "traffic": mix, "chips": 1,
                                       "why": "CPU test"})
            for m in bench["end_to_end"] + bench["per_layer"]:
                if m["name"] in e2e or any(m["name"].endswith(s) for s in
                                           ((".infer",) if mix == "tiny_infer" else (".train",))):
                    m.setdefault("workloads", []).append(cell)
            lim = (limits or {}).get(mix) or LIMITS[mix]
            (bench_dir / "limits" / f"{cell}.json").write_text(json.dumps({"limits": lim}))
    for mix, spec in TRAFFIC.items():
        (bench_dir / "traffic" / f"{mix}.json").write_text(json.dumps(spec))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
