"""Optimizer and LR schedules (counterpart of ``proben_tpu/solver/build.py``).

SGD with momentum in torch semantics: weight decay is added to the gradient
before the momentum update, v = mu * v + g, p -= lr * v. Biases and the
folded-BN scales/biases get ``weight_decay_bias`` and ``bias_lr_factor``.
Frozen parameters (the trainable mask) keep their values and momentum. The
update is written as tensor operations returning new tensors, so the
training step can still see the old parameters and momentum for its guard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """The SOLVER.* keys the ProbEn configs use."""

    base_lr: float = 0.02
    momentum: float = 0.9
    weight_decay: float = 1e-4
    bias_lr_factor: float = 1.0
    weight_decay_bias: float = 1e-4
    warmup_factor: float = 1.0 / 1000
    warmup_iters: int = 1000
    warmup_method: str = "linear"  # linear | constant
    steps: Tuple[int, ...] = (60000, 80000)
    gamma: float = 0.1
    max_iter: int = 90000
    lr_scheduler_name: str = "WarmupMultiStepLR"  # or WarmupCosineLR
    clip_gradients: bool = False
    clip_type: str = "value"  # value | norm
    clip_value: float = 1.0
    norm_type: float = 2.0


def build_lr_schedule(cfg: SolverConfig) -> Callable[[int], float]:
    """step -> learning rate (WarmupMultiStepLR or WarmupCosineLR)."""

    def warmup(step: int) -> float:
        if step >= cfg.warmup_iters:
            return 1.0
        if cfg.warmup_method == "constant":
            return cfg.warmup_factor
        alpha = min(step / max(cfg.warmup_iters, 1), 1.0)
        return cfg.warmup_factor * (1 - alpha) + alpha

    if cfg.lr_scheduler_name == "WarmupCosineLR":
        def schedule(step: int) -> float:
            return cfg.base_lr * warmup(step) * 0.5 * (1.0 + math.cos(math.pi * step / cfg.max_iter))
    else:
        def schedule(step: int) -> float:
            return cfg.base_lr * warmup(step) * cfg.gamma ** sum(step >= m for m in cfg.steps)
    return schedule


def is_bias_name(name: str) -> bool:
    """Biases and folded-BN scale/bias get the bias treatment."""
    return name.rsplit(".", 1)[-1] in ("bias", "scale")


def flat_cat(tensors) -> Tensor:
    """The tensors' entries, one after another, in one 1-D tensor."""
    return torch.cat([t.reshape(-1) for t in tensors])


def split_like(flat: Tensor, like: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """Inverse of ``flat_cat`` over ``like``'s values: views of ``flat``
    with their names and shapes."""
    parts = flat.split([t.numel() for t in like.values()])
    return {n: p.view_as(t) for (n, t), p in zip(like.items(), parts)}


class SGDMomentum:
    """SGD + momentum over named tensors with per-parameter lr factors and
    weight decay; ``trainable_mask`` (name -> bool, default all True) marks
    what it updates. The update runs on one flat vector of all trainable
    entries: a few passes over it instead of a dozen launches per tensor."""

    def __init__(self, cfg: SolverConfig, trainable_mask: Optional[Mapping[str, bool]] = None):
        self.cfg = cfg
        self.mask = trainable_mask
        self.schedule = build_lr_schedule(cfg)
        self._factors: Dict = {}

    def trainable(self, name: str) -> bool:
        return self.mask is None or self.mask[name]

    def _decay_and_lr_factor(self, params: Mapping[str, Tensor]) -> Tuple[Tensor, Tensor]:
        """Per-entry weight decay and lr factor, built once per parameter set."""
        key = tuple((n, t.numel(), t.device) for n, t in params.items())
        if key not in self._factors:
            cfg = self.cfg
            self._factors = {key: tuple(
                flat_cat([torch.full_like(t, a if is_bias_name(n) else b) for n, t in params.items()])
                for a, b in ((cfg.weight_decay_bias, cfg.weight_decay), (cfg.bias_lr_factor, 1.0))
            )}
        return self._factors[key]

    def update(
        self,
        grads: Mapping[str, Tensor],
        momentum: Mapping[str, Tensor],
        params: Mapping[str, Tensor],
        step: int,
    ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """New (params, momentum) for every trainable name in ``params``. A
        name missing from ``grads`` has a zero gradient; clipping sees every
        gradient given, frozen ones included, as the JAX optimizer does."""
        cfg = self.cfg
        lr = self.schedule(step)
        train = {n: t for n, t in params.items() if self.trainable(n)}
        if not train:
            return {}, {}
        g = flat_cat([grads[n] if n in grads else torch.zeros_like(t) for n, t in train.items()])
        if cfg.clip_gradients:
            if cfg.clip_type == "value":
                g = g.clamp(-cfg.clip_value, cfg.clip_value)
            else:
                gnorm = torch.sqrt(sum(x.float().pow(2).sum() for x in grads.values()))
                g = g * torch.clamp(cfg.clip_value / (gnorm + 1e-6), max=1.0)
        p = flat_cat(train.values())
        decay, lr_factor = self._decay_and_lr_factor(train)
        v = cfg.momentum * flat_cat(momentum[n] for n in train) + (g + decay * p)
        return split_like(p - (lr * lr_factor) * v, train), split_like(v, train)


def build_optimizer(cfg: SolverConfig, trainable_mask: Optional[Mapping[str, bool]] = None) -> SGDMomentum:
    return SGDMomentum(cfg, trainable_mask)
