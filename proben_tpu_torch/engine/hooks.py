"""Hook system (counterpart of ``proben_tpu/engine/hooks.py``; reference
``engine/train_loop.py:16`` HookBase + ``engine/hooks.py``): before/after
train/step callbacks around the trainer."""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, List

logger = logging.getLogger(__name__)


class HookBase:
    trainer = None  # set by the trainer

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass


class CallbackHook(HookBase):
    def __init__(self, *, before_train=None, after_train=None, before_step=None, after_step=None):
        self._bt, self._at, self._bs, self._as = before_train, after_train, before_step, after_step

    def before_train(self):
        if self._bt:
            self._bt(self.trainer)

    def after_train(self):
        if self._at:
            self._at(self.trainer)

    def before_step(self):
        if self._bs:
            self._bs(self.trainer)

    def after_step(self):
        if self._as:
            self._as(self.trainer)


class IterationTimer(HookBase):
    """Per-step wall time into the storage (reference ``hooks.py:75``)."""

    def before_step(self):
        self._start = time.perf_counter()

    def after_step(self):
        self.trainer.storage.put_scalar("time", time.perf_counter() - self._start)


class PeriodicWriter(HookBase):
    def __init__(self, writers: List, period: int = 20):
        self._writers = writers
        self._period = period

    def after_step(self):
        it = self.trainer.iter
        if (it + 1) % self._period == 0 or it == self.trainer.max_iter - 1:
            for w in self._writers:
                w.write(self.trainer.storage)

    def after_train(self):
        for w in self._writers:
            w.close()


class PeriodicCheckpointer(HookBase):
    def __init__(self, period: int):
        self._period = period

    def after_step(self):
        it = self.trainer.iter
        if (it + 1) % self._period == 0 or it == self.trainer.max_iter - 1:
            self.trainer.save_checkpoint()


class EvalHook(HookBase):
    """Run eval_fn(trainer) every ``period`` iters + at the end
    (reference ``hooks.py:301``). eval_fn may return a metric dict."""

    def __init__(self, period: int, eval_fn: Callable):
        self._period = period
        self._fn = eval_fn

    def _do(self):
        results = self._fn(self.trainer)
        if isinstance(results, dict):
            flat = {}

            def flatten(d, prefix=""):
                for k, v in d.items():
                    if isinstance(v, dict):
                        flatten(v, prefix + k + "/")
                    else:
                        try:
                            flat[prefix + k] = float(v)
                        except (TypeError, ValueError):
                            pass

            flatten(results)
            for k, v in flat.items():
                if v == v:  # skip NaN
                    self.trainer.storage.put_scalar(k, v)

    def after_step(self):
        it = self.trainer.iter
        if self._period > 0 and (it + 1) % self._period == 0 and it != self.trainer.max_iter - 1:
            self._do()

    def after_train(self):
        self._do()


class ProfilerHook(HookBase):
    """Trace chosen iterations with ``torch.profiler`` (host and, on the
    card, CUDA activity) and write a Chrome trace per iteration,
    ``OUTPUT_DIR/trace_iter<N>.json`` (reference ``hooks.py:235``
    AutogradProfiler -> chrome trace). The program's stage spans
    (``train.step``, ``rcnn.features``, ``train.backward``, ...; see
    ``utils/tracing.py``) appear in these traces as ``user_annotation``
    ranges around the kernels they launch."""

    def __init__(self, enter_predicate, output_dir: str):
        self._pred = enter_predicate
        self._dir = output_dir
        self._prof = None

    def before_step(self):
        if self._pred(self.trainer):
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.trainer.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()

    def after_step(self):
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            os.makedirs(self._dir, exist_ok=True)
            path = os.path.join(self._dir, f"trace_iter{self.trainer.iter}.json")
            prof.export_chrome_trace(path)
            logger.info("profiler trace written to %s", path)


class LRLogger(HookBase):
    """Log the scheduled lr (the reference LRScheduler hook steps the torch
    scheduler; ours is functional, so this only records)."""

    def __init__(self, schedule):
        self._schedule = schedule

    def after_step(self):
        self.trainer.storage.put_scalar("lr", float(self._schedule(self.trainer.iter)))


class PreciseBNHook(HookBase):
    """Recompute BatchNorm running statistics over ``num_iters`` training
    batches before evaluation points (reference ``engine/hooks.py:358``
    PreciseBN; stats math in ``models/batch_norm.precise_bn_stats``).

    ``stats_fn(model, batch) -> {path: (batch_mean, batch_var)}`` and
    ``apply_fn(model, stats)`` (which writes the statistics into the model)
    are model-provided. When the model carries no live BN statistics --
    true for every FrozenBN ProbEn config, exactly as in the reference
    where ``get_bn_modules(model)`` is empty -- the hook logs once and
    disables itself.
    """

    def __init__(self, period: int, data_iter, stats_fn, apply_fn,
                 num_iters: int = 200):
        self._period = period
        self._data_iter = data_iter
        self._stats_fn = stats_fn
        self._apply_fn = apply_fn
        self._num_iters = num_iters
        self.disabled = stats_fn is None or apply_fn is None
        if self.disabled:
            logger.info(
                "PreciseBN disabled: model has no live BN statistics "
                "(FrozenBN backbone), matching reference get_bn_modules()==[]"
            )

    def _update(self):
        from ..models.batch_norm import precise_bn_stats

        model = self.trainer.state.model
        collected = [self._stats_fn(model, next(self._data_iter)) for _ in range(self._num_iters)]
        # per BN site: average the per-batch (mean, var) pairs
        stats = {p: precise_bn_stats([c[p] for c in collected]) for p in collected[0]}
        self._apply_fn(model, stats)

    def after_step(self):
        if self.disabled:
            return
        next_iter = self.trainer.iter + 1
        # period <= 0 (EVAL_PERIOD=0): PreciseBN only at eval points, i.e.
        # here only at the final iteration, never every step
        at_period = self._period > 0 and next_iter % self._period == 0
        if at_period or next_iter >= self.trainer.max_iter:
            self._update()
