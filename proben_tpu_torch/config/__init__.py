from .config import CfgNode
from .defaults import (
    get_cfg,
    mapper_config_from_cfg,
    model_config_from_cfg,
    solver_config_from_cfg,
)

__all__ = [
    "CfgNode",
    "get_cfg",
    "mapper_config_from_cfg",
    "model_config_from_cfg",
    "solver_config_from_cfg",
]
