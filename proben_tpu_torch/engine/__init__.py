from .defaults import DefaultTrainer
from .ensemble import ProbEnPredictor
from .hooks import (
    CallbackHook,
    EvalHook,
    HookBase,
    IterationTimer,
    LRLogger,
    PeriodicCheckpointer,
    PeriodicWriter,
    PreciseBNHook,
    ProfilerHook,
)
from .predictor import Predictor
from .train import TrainState, losses_and_grads, make_train_step, trainable_mask

__all__ = [
    "CallbackHook",
    "DefaultTrainer",
    "EvalHook",
    "HookBase",
    "IterationTimer",
    "LRLogger",
    "PeriodicCheckpointer",
    "PeriodicWriter",
    "PreciseBNHook",
    "Predictor",
    "ProbEnPredictor",
    "ProfilerHook",
    "TrainState",
    "losses_and_grads",
    "make_train_step",
    "trainable_mask",
]
