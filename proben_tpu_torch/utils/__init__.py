from .analysis import flop_count, parameter_count, parameter_count_table
from .env import collect_env_info, seed_all_rng
from .events import (
    CommonMetricPrinter,
    EventStorage,
    JSONWriter,
    TensorboardWriter,
    get_event_storage,
)
from .logger import log_every_n_seconds, log_first_n, setup_logger
from .visualizer import Visualizer

__all__ = [
    "flop_count",
    "parameter_count",
    "parameter_count_table",
    "collect_env_info",
    "seed_all_rng",
    "CommonMetricPrinter",
    "EventStorage",
    "JSONWriter",
    "TensorboardWriter",
    "get_event_storage",
    "log_every_n_seconds",
    "log_first_n",
    "setup_logger",
    "Visualizer",
]
