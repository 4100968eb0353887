"""Default config tree and converters to the port's typed configs
(counterpart of ``proben_tpu/config/defaults.py``).

The tree is ``proben_tpu``'s, key for key and value for value, except
``MODEL.DEVICE`` ("cuda"), so a YAML file gives the same ``CfgNode`` in both
packages. The converters map the implementation names of the JAX package to
the port's: ``ROI_ALIGN_IMPL`` "pallas" -> "kernel", "gather" -> "plain";
``STEM_IMPL`` "pallas", "wpair", "pack24" -> "kernel", "direct" -> "plain";
any other name raises. ``REMAT_BACKBONE`` sets ``ModelConfig.remat_backbone``
(recompute the backbone's blocks in the backward: memory, not values).
"""

from __future__ import annotations

from .config import CfgNode

_DEFAULTS = {
    "VERSION": 2,
    "OUTPUT_DIR": "./output",
    "SEED": -1,
    "VIS_PERIOD": 0,
    "MODEL": {
        "META_ARCHITECTURE": "GeneralizedRCNN",
        "DEVICE": "cuda",
        "WEIGHTS": "",
        "MASK_ON": False,
        "PIXEL_MEAN": [103.530, 116.280, 123.675],
        "PIXEL_STD": [1.0, 1.0, 1.0],
        "BLUR_RGB": False,
        "MAX_POOL_RGB": False,
        # compute precision of the conv path ("bfloat16": f32 params, bf16 compute)
        "COMPUTE_DTYPE": "float32",
        "ROI_ALIGN_IMPL": "pallas",  # pallas | gather -> the port's "kernel" | "plain"
        "STEM_IMPL": "pallas",  # pallas | wpair | pack24 -> "kernel"; direct -> "plain"
        "REMAT_BACKBONE": False,  # recompute backbone blocks in the backward (memory only)
        "MIDDLE_FUSION_INFERENCE_SHARES_BACKBONE": False,
        "BACKBONE": {"NAME": "build_resnet_fpn_backbone", "FREEZE_AT": 2},
        "RESNETS": {
            "DEPTH": 50,
            "OUT_FEATURES": ["res2", "res3", "res4", "res5"],
            "NUM_GROUPS": 1,
            "WIDTH_PER_GROUP": 64,
            "STEM_OUT_CHANNELS": 64,
            "RES2_OUT_CHANNELS": 256,
            "STRIDE_IN_1X1": True,
            "NORM": "FrozenBN",
        },
        "FPN": {"IN_FEATURES": ["res2", "res3", "res4", "res5"], "OUT_CHANNELS": 256, "NORM": "", "FUSE_TYPE": "sum"},
        "ANCHOR_GENERATOR": {
            "NAME": "DefaultAnchorGenerator",
            "SIZES": [[32], [64], [128], [256], [512]],
            "ASPECT_RATIOS": [[0.5, 1.0, 2.0]],
            "OFFSET": 0.0,
        },
        "RPN": {
            "IN_FEATURES": ["p2", "p3", "p4", "p5", "p6"],
            "IOU_THRESHOLDS": [0.3, 0.7],
            "IOU_LABELS": [0, -1, 1],
            "BATCH_SIZE_PER_IMAGE": 256,
            "POSITIVE_FRACTION": 0.5,
            "SMOOTH_L1_BETA": 0.0,
            "LOSS_WEIGHT": 1.0,
            "PRE_NMS_TOPK_TRAIN": 2000,
            "PRE_NMS_TOPK_TEST": 1000,
            "POST_NMS_TOPK_TRAIN": 1000,
            "POST_NMS_TOPK_TEST": 1000,
            "NMS_THRESH": 0.7,
            "MIN_SIZE": 0,
            "BOUNDARY_THRESH": -1,
        },
        "ROI_HEADS": {
            "NAME": "StandardROIHeads",
            "NUM_CLASSES": 80,
            "IN_FEATURES": ["p2", "p3", "p4", "p5"],
            "IOU_THRESHOLDS": [0.5],
            "IOU_LABELS": [0, 1],
            "BATCH_SIZE_PER_IMAGE": 512,
            "POSITIVE_FRACTION": 0.25,
            "SCORE_THRESH_TEST": 0.05,
            "NMS_THRESH_TEST": 0.5,
            "ENABLE_GAUSSIANNLLOSS": False,
        },
        "ROI_BOX_HEAD": {
            "NAME": "FastRCNNConvFCHead",
            "NUM_FC": 2,
            "FC_DIM": 1024,
            "NUM_CONV": 0,
            "CONV_DIM": 256,
            "POOLER_RESOLUTION": 7,
            "POOLER_SAMPLING_RATIO": 0,  # 0 = adaptive ceil(roi/P), reference default
            # exact whole-map re-pool slots per image for out-of-window RoIs
            # (ops/roi_align.py); beyond them the windowed result is kept
            "FALLBACK_CAPACITY": 32,
            "BBOX_REG_WEIGHTS": [10.0, 10.0, 5.0, 5.0],
            "SMOOTH_L1_BETA": 0.0,
            "CLS_AGNOSTIC_BBOX_REG": False,
            "OUTPUT_LOGITS": True,
            "DROP_OUT": False,  # reference demo sets it; dangling no-op there too
        },
    },
    "INPUT": {
        "FORMAT": "BGR",
        "NUM_IN_CHANNELS": 3,
        "MIN_SIZE_TRAIN": (640, 672, 704, 736, 768, 800),
        "MAX_SIZE_TRAIN": 1333,
        "MIN_SIZE_TEST": 800,
        "MAX_SIZE_TEST": 1333,
        "RANDOM_FLIP": True,
        "CROP": {"ENABLED": False, "TYPE": "relative_range", "SIZE": [0.9, 0.9]},
        # static padded canvas (H, W); every batch pads to it
        "PAD_SHAPE": (800, 1344),
        "MAX_GT": 100,
    },
    "DATASETS": {"TRAIN": (), "TEST": ()},
    "DATALOADER": {"NUM_WORKERS": 4, "ASPECT_RATIO_GROUPING": True, "SAMPLER_TRAIN": "TrainingSampler", "FILTER_EMPTY_ANNOTATIONS": True},
    "SOLVER": {
        "IMS_PER_BATCH": 16,
        "BASE_LR": 0.02,
        "MOMENTUM": 0.9,
        "WEIGHT_DECAY": 0.0001,
        "WEIGHT_DECAY_NORM": 0.0,
        "BIAS_LR_FACTOR": 1.0,
        "WEIGHT_DECAY_BIAS": 0.0001,
        "GAMMA": 0.1,
        "STEPS": (60000, 80000),
        "MAX_ITER": 90000,
        "WARMUP_FACTOR": 0.001,
        "WARMUP_ITERS": 1000,
        "WARMUP_METHOD": "linear",
        "LR_SCHEDULER_NAME": "WarmupMultiStepLR",
        "CHECKPOINT_PERIOD": 5000,
        "CLIP_GRADIENTS": {"ENABLED": False, "CLIP_TYPE": "value", "CLIP_VALUE": 1.0, "NORM_TYPE": 2.0},
    },
    "TEST": {
        "DETECTIONS_PER_IMAGE": 100,
        "EVAL_PERIOD": 0,
        "EXPECTED_RESULTS": [],
        "AUG": {"ENABLED": False},
        "PRECISE_BN": {"ENABLED": False, "NUM_ITER": 200},
    },
}


def get_cfg() -> CfgNode:
    """A fresh config with the defaults above."""
    return CfgNode(_DEFAULTS).clone()


# ---------------------------------------------------------------------------
# CfgNode -> typed static configs
# ---------------------------------------------------------------------------

ROI_ALIGN_IMPLS = {"pallas": "kernel", "gather": "plain"}
STEM_IMPLS = {"pallas": "kernel", "wpair": "kernel", "pack24": "kernel", "direct": "plain"}


def _impl(names: dict, key: str, value: str) -> str:
    if value not in names:
        raise ValueError(f"MODEL.{key} {value!r}: expected one of {sorted(names)}")
    return names[value]


def model_config_from_cfg(cfg: CfgNode):
    from ..models.fast_rcnn import FastRCNNConfig
    from ..models.rcnn import ModelConfig
    from ..models.roi_heads import ROIHeadsConfig
    from ..models.rpn import RPNConfig

    m = cfg.MODEL
    num_classes = m.ROI_HEADS.NUM_CLASSES
    return ModelConfig(
        depth=m.RESNETS.DEPTH,
        input_format=cfg.INPUT.FORMAT,
        num_classes=num_classes,
        pixel_mean=tuple(m.PIXEL_MEAN),
        pixel_std=tuple(m.PIXEL_STD),
        freeze_at=m.BACKBONE.FREEZE_AT,
        fpn_channels=m.FPN.OUT_CHANNELS,
        enable_gaussian_nll=m.ROI_HEADS.ENABLE_GAUSSIANNLLOSS,
        compute_dtype=m.COMPUTE_DTYPE,
        blur_rgb=m.BLUR_RGB,
        max_pool_rgb=m.MAX_POOL_RGB,
        roi_align_impl=_impl(ROI_ALIGN_IMPLS, "ROI_ALIGN_IMPL", m.ROI_ALIGN_IMPL),
        stem_impl=_impl(STEM_IMPLS, "STEM_IMPL", m.get("STEM_IMPL", "pallas")),
        middle_fusion_inference_shares_backbone=m.MIDDLE_FUSION_INFERENCE_SHARES_BACKBONE,
        remat_backbone=m.REMAT_BACKBONE,
        rpn=RPNConfig(
            pre_nms_topk_train=m.RPN.PRE_NMS_TOPK_TRAIN,
            pre_nms_topk_test=m.RPN.PRE_NMS_TOPK_TEST,
            post_nms_topk_train=m.RPN.POST_NMS_TOPK_TRAIN,
            post_nms_topk_test=m.RPN.POST_NMS_TOPK_TEST,
            nms_thresh=m.RPN.NMS_THRESH,
            min_box_side_len=m.RPN.MIN_SIZE,
            batch_size_per_image=m.RPN.BATCH_SIZE_PER_IMAGE,
            positive_fraction=m.RPN.POSITIVE_FRACTION,
            iou_thresholds=tuple(m.RPN.IOU_THRESHOLDS),
            smooth_l1_beta=m.RPN.SMOOTH_L1_BETA,
            loss_weight=m.RPN.LOSS_WEIGHT,
        ),
        roi=ROIHeadsConfig(
            num_classes=num_classes,
            batch_size_per_image=m.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
            positive_fraction=m.ROI_HEADS.POSITIVE_FRACTION,
            iou_threshold=m.ROI_HEADS.IOU_THRESHOLDS[0],
            pooler_resolution=m.ROI_BOX_HEAD.POOLER_RESOLUTION,
            pooler_sampling_ratio=m.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
            fallback_capacity=m.ROI_BOX_HEAD.get("FALLBACK_CAPACITY", 32),
        ),
        rcnn=FastRCNNConfig(
            num_classes=num_classes,
            score_thresh=m.ROI_HEADS.SCORE_THRESH_TEST,
            nms_thresh=m.ROI_HEADS.NMS_THRESH_TEST,
            topk_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
            smooth_l1_beta=m.ROI_BOX_HEAD.SMOOTH_L1_BETA,
            cls_agnostic_bbox_reg=m.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG,
            box_reg_weights=tuple(m.ROI_BOX_HEAD.BBOX_REG_WEIGHTS),
            enable_gaussian_nll=m.ROI_HEADS.ENABLE_GAUSSIANNLLOSS,
        ),
    )


def mapper_config_from_cfg(cfg: CfgNode):
    from ..data.dataset_mapper import MapperConfig

    return MapperConfig(
        input_format=cfg.INPUT.FORMAT,
        pad_shape=tuple(cfg.INPUT.PAD_SHAPE),
        max_gt=cfg.INPUT.MAX_GT,
        min_size_train=tuple(cfg.INPUT.MIN_SIZE_TRAIN)
        if not isinstance(cfg.INPUT.MIN_SIZE_TRAIN, int)
        else (cfg.INPUT.MIN_SIZE_TRAIN,),
        max_size_train=cfg.INPUT.MAX_SIZE_TRAIN,
        min_size_test=cfg.INPUT.MIN_SIZE_TEST,
        max_size_test=cfg.INPUT.MAX_SIZE_TEST,
        flip=cfg.INPUT.RANDOM_FLIP,
        crop=tuple(cfg.INPUT.CROP.SIZE) if cfg.INPUT.CROP.ENABLED else None,
    )


def solver_config_from_cfg(cfg: CfgNode):
    from ..solver.build import SolverConfig

    s = cfg.SOLVER
    return SolverConfig(
        base_lr=s.BASE_LR,
        momentum=s.MOMENTUM,
        weight_decay=s.WEIGHT_DECAY,
        bias_lr_factor=s.BIAS_LR_FACTOR,
        weight_decay_bias=s.WEIGHT_DECAY_BIAS,
        warmup_factor=s.WARMUP_FACTOR,
        warmup_iters=s.WARMUP_ITERS,
        warmup_method=s.WARMUP_METHOD,
        steps=tuple(s.STEPS),
        gamma=s.GAMMA,
        max_iter=s.MAX_ITER,
        lr_scheduler_name=s.LR_SCHEDULER_NAME,
        clip_gradients=s.CLIP_GRADIENTS.ENABLED,
        clip_type=s.CLIP_GRADIENTS.CLIP_TYPE,
        clip_value=s.CLIP_GRADIENTS.CLIP_VALUE,
        norm_type=s.CLIP_GRADIENTS.NORM_TYPE,
    )
