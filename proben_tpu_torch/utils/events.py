"""Metric storage and writers (counterpart of ``proben_tpu/utils/events.py``;
reference ``detectron2/utils/events.py``).

``EventStorage``: scalar store with median-smoothing window; writers:
``JSONWriter`` (metrics.json lines), ``TensorboardWriter`` (gated on
tensorboard availability), ``CommonMetricPrinter`` (console line with eta/lr
/losses, reference :144)."""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

logger = logging.getLogger(__name__)

_CURRENT_STORAGE = []


def get_event_storage() -> "EventStorage":
    if not _CURRENT_STORAGE:
        raise RuntimeError("get_event_storage() called outside a storage context")
    return _CURRENT_STORAGE[-1]


class EventStorage:
    def __init__(self, start_iter: int = 0, window_size: int = 20):
        self.iter = start_iter
        self._window = window_size
        self._history: Dict[str, deque] = defaultdict(lambda: deque(maxlen=window_size))
        self._latest: Dict[str, tuple] = {}

    def put_scalar(self, name: str, value):
        value = float(value)
        self._history[name].append(value)
        self._latest[name] = (value, self.iter)

    def put_scalars(self, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def median(self, name: str) -> float:
        vals = sorted(self._history[name])
        return vals[len(vals) // 2] if vals else float("nan")

    def latest(self) -> Dict[str, tuple]:
        return dict(self._latest)

    def latest_with_smoothing(self) -> Dict[str, float]:
        return {k: self.median(k) for k in self._history}

    def step(self):
        self.iter += 1

    def __enter__(self):
        _CURRENT_STORAGE.append(self)
        return self

    def __exit__(self, *args):
        _CURRENT_STORAGE.pop()


class JSONWriter:
    def __init__(self, json_file: str, window_size: int = 20):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file = open(json_file, "a")

    def write(self, storage: EventStorage):
        record = {"iteration": storage.iter}
        record.update(storage.latest_with_smoothing())
        self._file.write(json.dumps(record, sort_keys=True) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()


class TensorboardWriter:
    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:  # tensorboard optional
            logger.warning("tensorboard unavailable (%s); TensorboardWriter is a no-op", e)
            return
        self._writer = SummaryWriter(log_dir)

    def write(self, storage: EventStorage):
        if self._writer is None:
            return
        for k, (v, it) in storage.latest().items():
            self._writer.add_scalar(k, v, it)

    def close(self):
        if self._writer is not None:
            self._writer.close()


class CommonMetricPrinter:
    def __init__(self, max_iter: int):
        self._max_iter = max_iter
        self._last_write: Optional[tuple] = None

    def write(self, storage: EventStorage):
        it = storage.iter
        eta = ""
        if self._last_write is not None:
            iters_done = it - self._last_write[0]
            if iters_done > 0:
                sec_per_iter = (time.perf_counter() - self._last_write[1]) / iters_done
                eta_sec = int(sec_per_iter * (self._max_iter - it))
                eta = f"eta: {datetime.timedelta(seconds=eta_sec)}  "
        self._last_write = (it, time.perf_counter())
        losses = "  ".join(
            f"{k}: {storage.median(k):.4g}"
            for k in sorted(storage._history)
            if "loss" in k
        )
        lr = storage.median("lr") if "lr" in storage._history else float("nan")
        dt = storage.median("time") if "time" in storage._history else float("nan")
        logger.info(
            "%siter: %d  %s  time: %.4f  lr: %.3g", eta, it, losses, dt, lr
        )

    def close(self):
        pass
