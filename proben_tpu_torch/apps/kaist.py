"""KAIST pedestrian-detection workflows (counterpart of
``proben_tpu/apps/kaist.py``; the reference's ``demo/KAIST/``): per-method
inference over a split writing the MATLAB-style det txt and the variance
npz, LAMR evaluation (all/day/night), and the ProbEn multi-model KAIST
ensemble.

    python -m proben_tpu_torch.apps.kaist lamr --data_root D --split S \\
        --annotation A --fusion_method M --model_path P --outfolder O
    python -m proben_tpu_torch.apps.kaist proben --data_root D --split S \\
        --annotation A --models thermal_only=t.pth middle_fusion=m.pth \\
        --score_fusion probEn --box_fusion v-avg

    python -m proben_tpu_torch.apps.kaist train --train_json J --train_image_root R \\
        --data_root D --split S --annotation A --fusion_method M --outfolder O

(the arguments of ``demo/KAIST/demo_LAMR_KAIST.py``, ``demo_probEn_KAIST.py``
and ``demo_train_KAIST.py``, plus ``--device``: ``cpu`` runs the plain
versions and reads the images with cv2, exactly as the JAX package does).
``train`` fine-tunes with the backbone(s) and the RoI heads frozen
(``MODEL.FREEZE_MODULES``), so only the FPN and the RPN train, evaluating
the live model's LAMR every ``--eval_every`` iterations and keeping the
lowest under ``<outfolder>/checkpoints/best``. The split's
files go through the FLIR app's ``DatasetMapper`` and test loader: on the
card the ``lwir`` and ``visible`` JPEGs are decoded with nvJPEG and
composed, resized and padded by the ``image_io`` kernel, one launch per
batch, and the model runs the RoIAlign kernel (and the stem kernel in
bf16; ``build_kaist_cfg`` keeps the float32 of ``get_cfg``, as the JAX
package does). Split lines are
``setXX/VYYY/IZZZZZ``; the thermal input is
``setXX/VYYY/lwir/IZZZZZ.jpg`` and the RGB input ``.../visible/...``.
``--model_path`` takes a detectron2 ``.pth``/``.pkl`` or a checkpoint
directory (``apps.flir.load_params``).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import CfgNode, get_cfg, mapper_config_from_cfg
from ..data import DatasetMapper, build_test_loader, register_coco_instances
from ..engine import DefaultTrainer, EvalHook
from ..evaluation.kaist import KAISTEvaluator, load_detections_txt, save_detections_txt
from ..fusion import fuse_multi_model
from .flir import THERMAL_MEAN, _predictor, load_params

logger = logging.getLogger(__name__)

KAIST_IMAGE_SIZE = (512, 640)  # (H, W)

Device = Union[str, torch.device]


def build_kaist_cfg(method: str, gnll: bool = True) -> CfgNode:
    """Per-method KAIST config (reference ``demo_train_KAIST.py`` mutations):
    R101, 1 class (pedestrian), the variance head on."""
    cfg = get_cfg()
    cfg.MODEL.RESNETS.DEPTH = 101
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 1
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.5
    cfg.MODEL.ROI_HEADS.ENABLE_GAUSSIANNLLOSS = gnll
    cfg.MODEL.ROI_BOX_HEAD.OUTPUT_LOGITS = True
    cfg.INPUT.PAD_SHAPE = (800, 1024)
    if method in ("thermal_only", "rgb_only"):
        pass
    elif method == "early_fusion":
        cfg.INPUT.FORMAT = "BGRT"
        cfg.INPUT.NUM_IN_CHANNELS = 4
        cfg.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675, THERMAL_MEAN]
        cfg.MODEL.PIXEL_STD = [1.0, 1.0, 1.0, 1.0]
    elif method == "middle_fusion":
        cfg.INPUT.FORMAT = "BGRTTT"
        cfg.INPUT.NUM_IN_CHANNELS = 6
        cfg.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675] + [THERMAL_MEAN] * 3
        cfg.MODEL.PIXEL_STD = [1.0] * 6
    else:
        raise ValueError(method)
    return cfg


def read_split(split_file: str) -> List[str]:
    with open(split_file) as f:
        return [ln.strip() for ln in f if ln.strip()]


def kaist_files(data_root: str, rel: str, method: str):
    """(thermal-slot file, RGB file or None) of one split line: what the
    method reads, and in which role. thermal_only reads the ``lwir`` file
    and rgb_only the ``visible`` file, each as the BGR input; the fusion
    methods compose the ``visible`` file with the ``lwir`` one. Raises
    ``FileNotFoundError`` naming the first missing file."""
    set_num, v_num, img_num = rel.split("/")
    lwir = os.path.join(data_root, set_num, v_num, "lwir", img_num + ".jpg")
    visible = os.path.join(data_root, set_num, v_num, "visible", img_num + ".jpg")
    files = {"thermal_only": (lwir, None), "rgb_only": (visible, None)}.get(method, (lwir, visible))
    for path in files:
        if path is not None and not os.path.isfile(path):
            raise FileNotFoundError(path)
    return files


def kaist_dicts(data_root: str, lines: Sequence[str], method: str) -> List[Dict]:
    """Dataset dicts of split lines for ``DatasetMapper``: "file_name" the
    thermal-slot file and, for the fusion methods, "rgb_file" the
    ``visible`` file (``kaist_files``); "image_id" the 1-based frame in
    split order. On the CPU the mapper reads them with cv2 as the JAX
    package's ``_kaist_image`` does (the two files have one size, so the RGB
    resize is a copy): early fusion takes the thermal file's channel 0,
    middle fusion all three."""
    dicts = []
    for frame, rel in enumerate(lines, 1):
        first, visible = kaist_files(data_root, rel, method)
        dicts.append({"file_name": first, "image_id": frame,
                      **({"rgb_file": visible} if visible is not None else {})})
    return dicts


def predict_split(
    method: str,
    data_root: str,
    split_file: str,
    params,
    cfg: Optional[CfgNode] = None,
    out_txt: Optional[str] = None,
    var_npz: Optional[str] = None,
    batch_size: int = 4,
    device: Device = "cuda",
) -> Dict[int, Dict[str, np.ndarray]]:
    """Run inference over a KAIST split with ``params`` (a numpy pytree, or
    a built ``RCNN``: a trainer's live model, used as it is).
    Returns {frame (1-based, split order): {boxes (xyxy), scores, classes,
    probs, class_logits, vars}}; optionally writes the reference det txt
    (xywh) and the per-frame variance npz. The last batch is padded by
    repeating its last line and frame."""
    cfg = cfg or build_kaist_cfg(method)
    predictor = _predictor(cfg, "", params, device)
    lines = read_split(split_file)
    dicts = kaist_dicts(data_root, lines, method)
    mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=False, device=device)
    results: Dict[int, Dict[str, np.ndarray]] = {}
    try:
        for batch in build_test_loader(dicts, mapper, batch_size=batch_size):
            for rec in predictor.predict_batch(batch):
                results[rec["image_id"]] = rec
    finally:
        mapper.close()

    if out_txt:  # xywh in the records' float32, as the JAX package writes it
        dets = {}
        for frame, rec in results.items():
            b = rec["boxes"].copy()
            b[:, 2:] -= b[:, :2]
            dets[frame] = np.concatenate([b, rec["scores"][:, None]], axis=1) if len(b) else np.zeros((0, 5))
        save_detections_txt(out_txt, dets, list(range(1, len(lines) + 1)))
    if var_npz:
        np.savez(var_npz, **{str(frame): rec.get("vars", np.zeros((0, 1))) for frame, rec in results.items()})
    return results


def evaluate_lamr(
    annotation_json: str,
    detections,
    image_ids: Optional[Sequence[int]] = None,
) -> Dict[str, float]:
    """LAMR all/day/night. ``detections``: det-txt path or {image_id: (N,5)}."""
    evaluator = KAISTEvaluator(annotation_json)
    if isinstance(detections, str):
        ids = image_ids if image_ids is not None else evaluator.image_ids
        detections = load_detections_txt(detections, ids)
    return evaluator.evaluate_all_conditions(detections)


def results_to_lamr_dets(results: Dict[int, Dict[str, np.ndarray]], image_ids: Sequence[int]) -> Dict[int, np.ndarray]:
    """Per-frame predictor records -> {annotation image_id: (N, 5) xywh+score};
    frames beyond ``image_ids`` are skipped."""
    out = {}
    for frame, rec in results.items():
        if frame - 1 >= len(image_ids):
            continue
        b = np.asarray(rec["boxes"], float).reshape(-1, 4).copy()
        if len(b):
            b[:, 2] -= b[:, 0]
            b[:, 3] -= b[:, 1]
        out[image_ids[frame - 1]] = np.concatenate(
            [b, np.asarray(rec["scores"], float).reshape(-1, 1)], axis=1
        ) if len(b) else np.zeros((0, 5))
    return out


def _model_dets(rec: Optional[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    if rec is None:
        return {"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "classes": np.zeros(0),
                "probs": np.zeros((0, 1)), "vars": np.zeros(0)}
    n = len(np.asarray(rec["scores"]).reshape(-1))
    probs = rec.get("probs")
    if probs is None:
        probs = np.asarray(rec["scores"], float).reshape(-1, 1)
    return {
        "boxes": np.asarray(rec["boxes"], float).reshape(-1, 4),
        "scores": np.asarray(rec["scores"], float).reshape(-1),
        "classes": np.asarray(rec["classes"]).reshape(-1),
        "probs": np.asarray(probs, float).reshape(n, -1) if n else np.zeros((0, 1)),
        "vars": np.asarray(rec["vars"], float).reshape(-1) if rec.get("vars") is not None else None,
    }


def run_kaist_proben(
    per_model_results: Sequence[Dict[int, Dict[str, np.ndarray]]],
    annotation_json: str,
    score_fusion: str = "probEn",
    box_fusion: str = "v-avg",
) -> Dict[str, float]:
    """ProbEn ensemble on KAIST: fuse per-frame detections from N models
    (numpy, on the host), then LAMR."""
    evaluator = KAISTEvaluator(annotation_json)
    image_ids = evaluator.image_ids
    frames = sorted(set().union(*[set(r) for r in per_model_results]))
    fused: Dict[int, np.ndarray] = {}
    offx, offy = float(KAIST_IMAGE_SIZE[1]), float(KAIST_IMAGE_SIZE[0])
    for frame in frames:
        per_model = [_model_dets(r.get(frame)) for r in per_model_results]
        boxes, scores, _ = fuse_multi_model(
            per_model, score_fusion, box_fusion, thresh=0.5, class_offset=(offx, offy)
        )
        if len(boxes) and frame - 1 < len(image_ids):
            xywh = boxes.copy()
            xywh[:, 2] -= xywh[:, 0]
            xywh[:, 3] -= xywh[:, 1]
            fused[image_ids[frame - 1]] = np.concatenate([xywh, scores[:, None]], axis=1)
    return evaluator.evaluate_all_conditions(fused)


def train_kaist(
    method: str,
    train_dataset: str,
    annotation_json: str,
    data_root: str,
    split_file: str,
    out_folder: str,
    max_iter: int = 10000,
    eval_every: int = 1000,
    cfg: Optional[CfgNode] = None,
    device: Device = "cuda",
    hooks: Sequence = (),
) -> Dict:
    """Keep-best training keyed on LAMR (reference ``demo_train_KAIST.py``:
    backbone(s) and RoI heads frozen, best = lowest all-condition LAMR of
    the live model over the split), resuming from
    ``<out_folder>/checkpoints`` when it holds a checkpoint. ``hooks`` are
    registered after the keep-best evaluation."""
    cfg = cfg or build_kaist_cfg(method)
    cfg.OUTPUT_DIR = out_folder
    cfg.SOLVER.MAX_ITER = max_iter
    cfg.DATASETS.TRAIN = (train_dataset,)
    cfg.MODEL.FREEZE_MODULES = ("backbone", "backbone_2", "roi")

    trainer = DefaultTrainer(cfg, device=device)
    trainer.checkpointer.higher_is_better = False  # LAMR: lower is better

    def eval_lamr(t):
        try:
            results = predict_split(method, data_root, split_file, t.model, cfg=t.cfg,
                                    device=t.device)
        finally:
            t.model.train()
        evaluator = KAISTEvaluator(annotation_json)
        out = evaluator.evaluate_all_conditions(results_to_lamr_dets(results, evaluator.image_ids))
        lamr = out["lamr_all"]
        if lamr == lamr and t.checkpointer.save_best(t.iter, lamr, t.params):
            logger.info("new best LAMR %.2f%% at iter %d", lamr, t.iter)
        return out

    trainer.register_hooks([EvalHook(eval_every, eval_lamr), *hooks])
    trainer.resume_or_load(resume=True)
    trainer.train()
    return {"best_lamr": trainer.checkpointer.best_metric}


def run_lamr(method: str, data_root: str, split: str, annotation: str, model_path: str = "",
             outfolder: str = "out", device: Device = "cuda") -> Dict[str, float]:
    """``demo_LAMR_KAIST.py``: one method's det txt and variance npz under
    ``outfolder``, then LAMR all/day/night."""
    cfg = build_kaist_cfg(method)
    params = load_params(cfg, model_path)
    os.makedirs(outfolder, exist_ok=True)
    results = predict_split(
        method, data_root, split, params, cfg=cfg,
        out_txt=os.path.join(outfolder, f"KAIST_{method}_dets.txt"),
        var_npz=os.path.join(outfolder, f"KAIST_{method}_vars.npz"), device=device,
    )
    evaluator = KAISTEvaluator(annotation)
    return evaluator.evaluate_all_conditions(results_to_lamr_dets(results, evaluator.image_ids))


def run_proben_models(data_root: str, split: str, annotation: str, models: Sequence[str],
                      score_fusion: str = "probEn", box_fusion: str = "v-avg",
                      device: Device = "cuda") -> Dict[str, float]:
    """``demo_probEn_KAIST.py``: ``models`` as ``method=checkpoint`` pairs,
    each run over the split, then fused and scored."""
    per_model = []
    for spec in models:
        method, _, path = spec.partition("=")
        cfg = build_kaist_cfg(method)
        per_model.append(predict_split(method, data_root, split, load_params(cfg, path), cfg=cfg,
                                       device=device))
    return run_kaist_proben(per_model, annotation, score_fusion, box_fusion)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    from ..utils.logger import setup_logger

    methods = ["rgb_only", "thermal_only", "early_fusion", "middle_fusion"]
    parser = argparse.ArgumentParser(
        prog="python -m proben_tpu_torch.apps.kaist",
        description="lamr: one method's detections and LAMR; proben: ProbEn fusion of several "
                    "methods' detections and its LAMR; train: keep-best-LAMR fine-tuning")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("lamr", "proben", "train"):
        p = sub.add_parser(name)
        if name == "train":
            p.add_argument("--train_json", required=True, help="COCO-format train annotations")
            p.add_argument("--train_image_root", required=True)
        p.add_argument("--data_root", required=True)
        p.add_argument("--split", required=True)
        p.add_argument("--annotation", required=True)
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    lamr, proben, train = sub.choices["lamr"], sub.choices["proben"], sub.choices["train"]
    train.add_argument("--fusion_method", default="thermal_only", choices=methods)
    train.add_argument("--outfolder", default="out_kaist")
    train.add_argument("--max_iter", type=int, default=10000)
    train.add_argument("--eval_every", type=int, default=1000)
    lamr.add_argument("--fusion_method", default="thermal_only", choices=methods)
    lamr.add_argument("--model_path", default="")
    lamr.add_argument("--outfolder", default="out")
    proben.add_argument("--models", nargs="+", required=True, help="method=checkpoint pairs")
    proben.add_argument("--score_fusion", default="probEn", choices=["avg", "max", "probEn"])
    proben.add_argument("--box_fusion", default="v-avg", choices=["avg", "s-avg", "v-avg", "argmax"])
    args = parser.parse_args(argv)
    setup_logger()
    if args.command == "train":
        register_coco_instances("kaist_train", {}, args.train_json, args.train_image_root)
        out = train_kaist(args.fusion_method, "kaist_train", args.annotation, args.data_root,
                          args.split, args.outfolder, args.max_iter, args.eval_every,
                          device=args.device)
    elif args.command == "lamr":
        out = run_lamr(args.fusion_method, args.data_root, args.split, args.annotation,
                       args.model_path, args.outfolder, args.device)
    else:
        out = run_proben_models(args.data_root, args.split, args.annotation, args.models,
                                args.score_fusion, args.box_fusion, args.device)
    print(out)
    return out


if __name__ == "__main__":
    main()
