from .proben_numpy import (
    bayesian_score_fusion,
    cluster_nms,
    fuse_detections,
    fuse_multi_model,
)
from .proben_torch import fuse_detections_torch

__all__ = [
    "fuse_detections_torch",
    "bayesian_score_fusion",
    "cluster_nms",
    "fuse_detections",
    "fuse_multi_model",
]
