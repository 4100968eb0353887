"""FLIR ADAS workflows (counterpart of ``proben_tpu/apps/flir.py``): the
fusion methods' config wiring, prediction saving, mAP evaluation, and ProbEn
late fusion of saved predictions.

    python -m proben_tpu_torch.apps.flir save   --dataset_path D --fusion_method M --outfolder O
    python -m proben_tpu_torch.apps.flir map    --dataset_path D --fusion_method M
    python -m proben_tpu_torch.apps.flir proben --dataset_path D --prediction_path O \\
        --score_fusion probEn --box_fusion v-avg
    python -m proben_tpu_torch.apps.flir ensemble --dataset_path D \\
        --models thermal_only=T early_fusion=E middle_fusion=M --score_fusion probEn --box_fusion v-avg

    python -m proben_tpu_torch.apps.flir train  --dataset_path D --fusion_method M \\
        --outfolder O [--max_iter N] [--eval_every K]
    python -m proben_tpu_torch.apps.flir draw   --dataset_path D --fusion_method M \\
        [--model_path P] [--outfolder O] [--max_images N]

(the arguments of ``demo/FLIR/demo_FLIR_save_predictions.py``,
``demo_mAP_FLIR.py``, ``demo_probEn.py``, ``demo_train_FLIR.py`` and
``demo_draw_FLIR.py``; ``ensemble`` runs the members of ``proben`` from their
checkpoints and fuses them on the device in the same pass, with no JSON between;
``--device cpu`` runs the plain versions on the CPU, and the images are then
read with cv2). On the card, the images are decoded with nvJPEG and
composed, resized (training: also cropped and flipped) and padded by the ``image_io``
kernel, and the model runs the stem and RoIAlign kernels (training: the
RoIAlign backward too).

``model_path`` "" gives the port's random init from seed 0, a detectron2
``.pth``/``.pkl`` file is imported (``checkpoint.torch_import``) and a
directory is restored (``checkpoint.restore_pytree``); ``params`` takes a
numpy pytree in ``proben_tpu``'s layout. ``train_flir`` trains with
``DefaultTrainer`` and keeps the best AP50 under
``<outfolder>/checkpoints/best``, which ``load_params`` reads.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..checkpoint import import_detectron2_checkpoint, restore_pytree
from ..config import CfgNode, get_cfg, mapper_config_from_cfg, model_config_from_cfg
from ..data import (
    DatasetCatalog,
    DatasetMapper,
    MetadataCatalog,
    build_test_loader,
    register_coco_instances,
)
from ..engine import DefaultTrainer, EvalHook, Predictor, ProbEnPredictor
from ..evaluation import FLIREvaluator, inference_on_dataset
from ..fusion import fuse_multi_model
from ..models import RCNN, build_model, init_rcnn

logger = logging.getLogger(__name__)

VAL_JSON_NAME = "FLIR_thermal_RGBT_pairs_val.json"
TRAIN_JSON_NAME = "FLIR_thermal_RGBT_pairs_train.json"

THERMAL_MEAN = 135.438
# the channels of a BGRTTT frame each method reads as a ProbEn member
MEMBER_CHANNELS = {"rgb_only": (0, 3), "thermal_only": (3, 6), "early_fusion": (0, 4), "middle_fusion": (0, 6)}

Device = Union[str, torch.device]


def build_flir_cfg(method: str, num_classes: int = 3, gnll: bool = True) -> CfgNode:
    """Per-fusion-method config (reference ``demo_FLIR_save_predictions.py:53-76``
    and ``demo_train_FLIR.py:48-91`` cfg mutations)."""
    cfg = get_cfg()
    cfg.MODEL.RESNETS.DEPTH = 101
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = num_classes
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.5
    cfg.MODEL.ROI_HEADS.ENABLE_GAUSSIANNLLOSS = gnll
    cfg.MODEL.ROI_BOX_HEAD.OUTPUT_LOGITS = True
    cfg.MODEL.BACKBONE.FREEZE_AT = 3
    cfg.INPUT.PAD_SHAPE = (800, 1024)  # FLIR 640x512 -> 800x1000 -> pad
    if method in ("thermal_only", "rgb_only"):
        pass  # 3-channel BGR
    elif method == "early_fusion":
        cfg.INPUT.FORMAT = "BGRT"
        cfg.INPUT.NUM_IN_CHANNELS = 4
        cfg.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675, THERMAL_MEAN]
        cfg.MODEL.PIXEL_STD = [1.0, 1.0, 1.0, 1.0]
    elif method == "middle_fusion":
        cfg.INPUT.FORMAT = "BGRTTT"
        cfg.INPUT.NUM_IN_CHANNELS = 6
        cfg.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675] + [THERMAL_MEAN] * 3
        cfg.MODEL.PIXEL_STD = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    else:
        raise ValueError(f"unknown fusion method {method}")
    return cfg


def register_flir(dataset_name: str, dataset_path: str, split_json: str = VAL_JSON_NAME):
    json_path = os.path.join(dataset_path, split_json)
    image_root = os.path.join(dataset_path, "thermal_8_bit")
    if dataset_name in DatasetCatalog.list():
        DatasetCatalog.remove(dataset_name)
    register_coco_instances(dataset_name, {}, json_path, image_root)
    return json_path


def load_params(cfg: CfgNode, model_path: str) -> Dict:
    """The numpy parameter pytree for ``cfg``: ``model_path`` "" gives the
    port's random init from seed 0; a directory is a checkpoint of
    ``checkpoint.save_pytree``; a file (or URL) is a detectron2 ``.pth``/
    ``.pkl``, imported over that init with ``strict=False``."""
    template = init_rcnn(0, model_config_from_cfg(cfg))
    if not model_path:
        return template
    if os.path.isdir(model_path):
        return restore_pytree(model_path, template)
    return import_detectron2_checkpoint(model_path, template, strict=False)


def _predictor(cfg: CfgNode, model_path: str, params, device: Device) -> Predictor:
    """``params``: a numpy pytree, a built ``RCNN`` (a trainer's live model,
    used as it is) or None (``load_params(cfg, model_path)``)."""
    model_cfg = model_config_from_cfg(cfg)
    if not isinstance(params, RCNN):
        params = build_model(model_cfg, params=params if params is not None
                             else load_params(cfg, model_path), device=device)
    return Predictor(params, model_cfg, device)


def save_predictions(
    method: str,
    dataset_path: str,
    model_path: str,
    out_folder: str,
    dataset_name: str = "FLIR_val",
    batch_size: int = 4,
    cfg: Optional[CfgNode] = None,
    params=None,
    device: Device = "cuda",
) -> str:
    """Run the predictor over the val split; dump the reference's JSON schema.
    Returns the output path ``val_<method>_predictions.json``."""
    cfg = cfg or build_flir_cfg(method)
    register_flir(dataset_name, dataset_path)
    dicts = DatasetCatalog.get(dataset_name)
    predictor = _predictor(cfg, model_path, params, device)

    out: Dict[str, list] = {k: [] for k in
                            ("image", "boxes", "scores", "classes", "class_logits",
                             "probs", "vars", "image_id")}
    mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=False, device=device)
    try:
        for batch in build_test_loader(dicts, mapper, batch_size=batch_size):
            for rec, fname in zip(predictor.predict_batch(batch), batch["file_name"]):
                keep = rec["classes"] <= 2  # reference filters classes <= 2
                out["image"].append(os.path.basename(fname))
                out["boxes"].append(rec["boxes"][keep].tolist())
                out["scores"].append(rec["scores"][keep].tolist())
                out["classes"].append(rec["classes"][keep].tolist())
                out["class_logits"].append(rec.get("class_logits", rec["scores"][:, None])[keep].tolist())
                out["probs"].append(rec.get("probs", rec["scores"][:, None])[keep].tolist())
                out["vars"].append(
                    rec["vars"][keep].tolist() if "vars" in rec else [[1.0]] * int(keep.sum())
                )
                out["image_id"].append(int(rec["image_id"]))
    finally:
        mapper.close()

    os.makedirs(out_folder, exist_ok=True)
    out_path = os.path.join(out_folder, f"val_{method}_predictions.json")
    with open(out_path, "w") as f:
        json.dump(out, f)
    logger.info("saved predictions: %s", out_path)
    return out_path


def evaluate_map(
    method: str,
    dataset_path: str,
    model_path: str,
    out_folder: str = "out",
    dataset_name: str = "FLIR_val",
    batch_size: int = 4,
    cfg: Optional[CfgNode] = None,
    params=None,
    device: Device = "cuda",
) -> Dict:
    """``demo_mAP_FLIR.py``: one-shot inference_on_dataset with FLIREvaluator."""
    cfg = cfg or build_flir_cfg(method)
    json_path = register_flir(dataset_name, dataset_path)
    dicts = DatasetCatalog.get(dataset_name)
    predictor = _predictor(cfg, model_path, params, device)
    evaluator = FLIREvaluator(json_path, output_dir=out_folder)
    mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=False, device=device)
    try:
        loader = build_test_loader(dicts, mapper, batch_size=batch_size)
        return inference_on_dataset(predictor, loader, evaluator)
    finally:
        mapper.close()


def _model_dets_for_image(det_json: Dict, i: int) -> Dict[str, np.ndarray]:
    return {
        "boxes": np.asarray(det_json["boxes"][i], float).reshape(-1, 4),
        "scores": np.asarray(det_json["scores"][i], float).reshape(-1),
        "classes": np.asarray(det_json["classes"][i]).reshape(-1),
        "probs": np.asarray(det_json["probs"][i], float).reshape(
            len(det_json["boxes"][i]), -1
        )
        if len(det_json["boxes"][i])
        else np.zeros((0, 3)),
        "vars": np.asarray(det_json["vars"][i], float).reshape(-1)
        if det_json.get("vars") is not None
        else None,
    }


def apply_late_fusion_and_evaluate(
    evaluator: FLIREvaluator,
    detections: Sequence[Dict],
    score_fusion: str,
    box_fusion: str,
    class_offset=(640.0, 512.0),
) -> Dict:
    """``demo_probEn.py:198`` — per-image multi-model fusion (numpy, on the
    host) + mAP.

    ``detections``: 2-3 loaded prediction JSONs (the saver's schema). Image
    order follows the second model's list, like the reference. One INFO
    record on this module's logger gives the fusion's seconds per image.
    """
    evaluator.reset()
    n_images = len(detections[1]["image"]) if len(detections) > 1 else len(detections[0]["image"])
    start = time.time()
    for i in range(n_images):
        per_model = [_model_dets_for_image(d, i) for d in detections]
        boxes, scores, classes = fuse_multi_model(
            per_model, score_fusion, box_fusion, thresh=0.5, class_offset=class_offset
        )
        if len(boxes) == 0:
            continue
        image_id = detections[1]["image_id"][i] if len(detections) > 1 else detections[0]["image_id"][i]
        evaluator.process(image_id, boxes, scores, classes)
    elapsed = (time.time() - start) / max(n_images, 1)
    logger.info("late fusion: %.5f s/img average", elapsed)
    return evaluator.evaluate()


def run_proben(
    dataset_path: str,
    prediction_path: str,
    score_fusion: str = "probEn",
    box_fusion: str = "v-avg",
    out_folder: str = "out",
    dataset_name: str = "FLIR_val",
    det_files: Optional[Sequence[str]] = None,
) -> Dict:
    """``demo_probEn.py`` main: load 2-3 prediction JSONs, fuse, evaluate."""
    if det_files is None:
        det_files = [
            os.path.join(prediction_path, "val_thermal_only_predictions.json"),
            os.path.join(prediction_path, "val_early_fusion_predictions.json"),
            os.path.join(prediction_path, "val_middle_fusion_predictions.json"),
        ]
    det_files = [f for f in det_files if os.path.exists(f)]
    if len(det_files) < 2:
        raise FileNotFoundError(f"need >=2 prediction files, found {det_files}")
    detections = []
    for path in det_files:
        with open(path) as f:
            detections.append(json.load(f))
    json_path = os.path.join(dataset_path, VAL_JSON_NAME)
    evaluator = FLIREvaluator(json_path, output_dir=out_folder)
    return apply_late_fusion_and_evaluate(
        evaluator, detections, score_fusion, box_fusion
    )


def evaluate_proben(
    dataset_path: str,
    models: Sequence[Sequence[str]],
    score_fusion: str = "probEn",
    box_fusion: str = "v-avg",
    out_folder: str = "out",
    dataset_name: str = "FLIR_val",
    batch_size: int = 4,
    cfgs: Optional[Sequence[CfgNode]] = None,
    params: Optional[Sequence] = None,
    device: Device = "cuda",
) -> Dict:
    """ProbEn late fusion in one pass (``demo_FLIR_save_predictions.py`` for
    each member, then ``demo_probEn.py``, with no JSON between): ``models``
    (method, model_path) pairs, the paper's ProbEn3 being thermal_only,
    early_fusion and middle_fusion, run by ``ProbEnPredictor`` on the val
    split's BGRTTT frames (each member on its ``MEMBER_CHANNELS``), fused on
    the device and scored by the FLIR evaluator through
    ``inference_on_dataset``. ``cfgs`` and ``params`` (one per member)
    stand in for ``build_flir_cfg(method)`` and ``load_params``; every
    member's input sizes must agree."""
    cfgs = list(cfgs) if cfgs is not None else [build_flir_cfg(method) for method, _ in models]
    params = list(params) if params is not None else [load_params(c, path) for c, (_, path) in zip(cfgs, models)]
    mappers = [dataclasses.replace(mapper_config_from_cfg(c), input_format="BGRTTT") for c in cfgs]
    if any(m != mappers[0] for m in mappers):
        raise ValueError("the members' input sizes differ: one frame feeds them all")
    json_path = register_flir(dataset_name, dataset_path)
    dicts = DatasetCatalog.get(dataset_name)
    predictor = ProbEnPredictor.from_cfgs(
        [(c, p, MEMBER_CHANNELS[method]) for c, p, (method, _) in zip(cfgs, params, models)],
        device=device, score_method=score_fusion, box_method=box_fusion, thresh=0.5)
    evaluator = FLIREvaluator(json_path, output_dir=out_folder)
    mapper = DatasetMapper(mappers[0], is_train=False, device=device)
    try:
        return inference_on_dataset(predictor, build_test_loader(dicts, mapper, batch_size=batch_size), evaluator)
    finally:
        mapper.close()


def ensemble_parser() -> argparse.ArgumentParser:
    """The arguments of ``ensemble``: ``demo_probEn.py``'s, with the members'
    checkpoints in place of their saved predictions."""
    parser = argparse.ArgumentParser(prog="python -m proben_tpu_torch.apps.flir ensemble")
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--models", nargs="+", required=True,
                        help="method=checkpoint pairs (an empty checkpoint: random weights from seed 0)")
    parser.add_argument("--score_fusion", default="probEn", choices=["avg", "max", "probEn"])
    parser.add_argument("--box_fusion", default="v-avg", choices=["avg", "s-avg", "v-avg", "argmax"])
    parser.add_argument("--outfolder", default="out/")
    parser.add_argument("--dataset_name", default="FLIR_val")
    return parser


def draw_predictions(
    method: str,
    dataset_path: str,
    model_path: str = "",
    out_folder: str = "out_draw",
    max_images: int = 20,
    dataset_name: str = "FLIR_draw",
    cfg: Optional[CfgNode] = None,
    params=None,
    device: Device = "cuda",
) -> List[str]:
    """``demo_draw_FLIR.py``: the first ``max_images`` val images, one per
    batch, through the predictor; each image's detections drawn by
    ``Visualizer`` over its thermal frame (``thermal_<file>``) and over its
    RGB file resized to that frame (``rgb_<file>``, where the RGB file
    exists) in ``out_folder``. The frames are read as the mapper reads them
    (on the card: nvJPEG and one ``image_io`` launch per image, the
    BGRTTT composition at scale 1; on the CPU: cv2, as the JAX demo reads
    them). Returns the paths written."""
    from ..data.detection_utils import derive_rgb_path, read_image
    from ..utils.visualizer import Visualizer

    cfg = cfg or build_flir_cfg(method)
    register_flir(dataset_name, dataset_path)
    dicts = DatasetCatalog.get(dataset_name)[:max_images]
    meta = MetadataCatalog.get(dataset_name)
    predictor = _predictor(cfg, model_path, params, device)
    mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=False, device=device)
    os.makedirs(out_folder, exist_ok=True)
    written = []
    try:
        for batch in build_test_loader(dicts, mapper, batch_size=1):
            rec = predictor.predict_batch(batch)[0]
            thermal_path = batch["file_name"][0]
            try:
                rgb_path = derive_rgb_path(thermal_path)
            except ValueError:
                rgb_path = None
            fused = rgb_path is not None and os.path.exists(rgb_path)
            frame = read_image(thermal_path, "BGRTTT" if fused else "BGR", device, rgb_path)
            frame = (frame.cpu().numpy() if torch.is_tensor(frame) else frame).astype(np.uint8)
            name = os.path.basename(thermal_path)
            overlays = [("thermal_", frame[..., -3:])] + ([("rgb_", frame[..., :3])] if fused else [])
            for prefix, image in overlays:
                path = os.path.join(out_folder, prefix + name)
                Visualizer(image, meta).draw_instance_predictions(rec).save(path)
                written.append(path)
    finally:
        mapper.close()
    logger.info("wrote %d visualizations to %s", len(written), out_folder)
    return written


def draw_parser() -> argparse.ArgumentParser:
    """The arguments of ``demo/FLIR/demo_draw_FLIR.py``."""
    parser = argparse.ArgumentParser(prog="python -m proben_tpu_torch.apps.flir draw")
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--fusion_method", default="thermal_only",
                        choices=["rgb_only", "thermal_only", "early_fusion", "middle_fusion"])
    parser.add_argument("--model_path", default="")
    parser.add_argument("--outfolder", default="out_draw")
    parser.add_argument("--max_images", type=int, default=20)
    return parser


def train_parser() -> argparse.ArgumentParser:
    """The arguments of ``demo/FLIR/demo_train_FLIR.py``."""
    parser = argparse.ArgumentParser(prog="python -m proben_tpu_torch.apps.flir train")
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--fusion_method", default="thermal_only",
                        choices=["rgb_only", "thermal_only", "early_fusion", "middle_fusion"])
    parser.add_argument("--outfolder", default="out_training")
    parser.add_argument("--max_iter", type=int, default=None)
    parser.add_argument("--eval_every", type=int, default=1000)
    return parser


def train_flir(
    method: str,
    dataset_path: str,
    out_folder: str,
    max_iter: Optional[int] = None,
    eval_every: int = 1000,
    cfg: Optional[CfgNode] = None,
    device: Device = "cuda",
    hooks: Sequence = (),
) -> Dict:
    """``demo_train_FLIR.py``: train on the train split, evaluating the
    live model on the val split every ``eval_every`` iterations and at the
    end, keeping the best AP50 (the reference's keep-best outer loop), and
    resuming from ``<out_folder>/checkpoints`` when it holds a checkpoint.
    ``hooks`` are registered after the keep-best evaluation."""
    cfg = cfg or build_flir_cfg(method)
    cfg.OUTPUT_DIR = out_folder
    if max_iter is not None:
        cfg.SOLVER.MAX_ITER = max_iter
    register_flir(f"FLIR_train_{method}", dataset_path, TRAIN_JSON_NAME)
    register_flir(f"FLIR_val_{method}", dataset_path, VAL_JSON_NAME)
    cfg.DATASETS.TRAIN = (f"FLIR_train_{method}",)
    cfg.DATASETS.TEST = (f"FLIR_val_{method}",)
    # keep-best eval is registered below; TEST.EVAL_PERIOD stays 0 so the
    # default EvalHook is not doubled up

    trainer = DefaultTrainer(cfg, device=device)

    def eval_and_keep_best(t):
        results = t.evaluate()
        ap50 = results.get("bbox", {}).get("AP50", float("nan"))
        if ap50 == ap50 and t.checkpointer.save_best(t.iter, ap50, t.params):
            logger.info("new best AP50 %.2f at iter %d", ap50, t.iter)
        return results

    trainer.register_hooks([EvalHook(eval_every, eval_and_keep_best), *hooks])
    trainer.resume_or_load(resume=True)
    trainer.train()
    return {"best_AP50": trainer.checkpointer.best_metric}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from ..utils.logger import setup_logger
    from ..utils.opt import config_parser

    parser = argparse.ArgumentParser(
        prog="python -m proben_tpu_torch.apps.flir",
        description="save: prediction JSON of one method; map: its FLIR mAP; "
                    "proben: ProbEn late fusion of saved JSONs and its mAP; "
                    "ensemble: ProbEn late fusion of the members' checkpoints in one pass, and its mAP; "
                    "train: keep-best-AP50 training of one method; "
                    "draw: detections drawn over the thermal and RGB images")
    parser.add_argument("command", choices=("save", "map", "proben", "ensemble", "train", "draw"))
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    known, rest = parser.parse_known_args(argv)
    setup_logger()
    if known.command == "train":
        args = train_parser().parse_args(rest)
        results = train_flir(args.fusion_method, args.dataset_path, args.outfolder,
                             args.max_iter, args.eval_every, device=known.device)
        print(results)
        return results
    if known.command == "ensemble":
        args = ensemble_parser().parse_args(rest)
        models = [spec.partition("=")[::2] for spec in args.models]
        results = evaluate_proben(args.dataset_path, models, args.score_fusion, args.box_fusion,
                                  args.outfolder, args.dataset_name, device=known.device)
        print(results)
        return results
    if known.command == "draw":
        args = draw_parser().parse_args(rest)
        written = draw_predictions(args.fusion_method, args.dataset_path, args.model_path,
                                   args.outfolder, args.max_images, device=known.device)
        print(f"wrote {len(written)} visualizations to {args.outfolder}")
        return {"written": written}
    args = config_parser(rest)
    if known.command == "proben":
        results = run_proben(args.dataset_path, args.prediction_path, args.score_fusion,
                             args.box_fusion, args.outfolder, args.dataset_name)
    elif known.command == "save":
        results = save_predictions(args.fusion_method, args.dataset_path, args.model_path,
                                   args.outfolder, args.dataset_name, device=known.device)
    else:
        results = evaluate_map(args.fusion_method, args.dataset_path, args.model_path,
                               args.outfolder, args.dataset_name, device=known.device)
    print(results)
    return results


if __name__ == "__main__":
    main()
