from .fast_rcnn import FastRCNNConfig
from .rcnn import (
    RCNN,
    ModelConfig,
    build_config,
    build_model,
    init_rcnn,
    postprocess_boxes,
    random_affines,
    rcnn_inference,
    rcnn_inference_given_boxes,
    rcnn_train_losses,
)
from .roi_heads import ROIHeadsConfig
from .rpn import RPNConfig

__all__ = [
    "RCNN",
    "FastRCNNConfig",
    "ModelConfig",
    "ROIHeadsConfig",
    "RPNConfig",
    "build_config",
    "build_model",
    "init_rcnn",
    "postprocess_boxes",
    "random_affines",
    "rcnn_inference",
    "rcnn_inference_given_boxes",
    "rcnn_train_losses",
]
