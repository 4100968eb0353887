from .predictor import Predictor
from .train import TrainState, losses_and_grads, make_train_step, trainable_mask

__all__ = ["Predictor", "TrainState", "losses_and_grads", "make_train_step", "trainable_mask"]
