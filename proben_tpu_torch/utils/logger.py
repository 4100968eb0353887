"""Logger setup (counterpart of ``proben_tpu/utils/logger.py::setup_logger``,
after the reference ``detectron2/utils/logger.py:34``): colored console
formatter, optional per-process file logs, log_first_n / log_every_n_seconds."""

from __future__ import annotations

import functools
import logging
import os
import sys
import time
from collections import Counter

_LOG_COUNTER = Counter()
_LOG_TIMER = {}


class _ColorFormatter(logging.Formatter):
    def formatMessage(self, record):
        msg = super().formatMessage(record)
        if record.levelno == logging.WARNING:
            return f"\033[31mWARNING\033[0m {msg}"
        if record.levelno >= logging.ERROR:
            return f"\033[31m\033[4m{record.levelname}\033[0m {msg}"
        return msg


@functools.lru_cache()
def setup_logger(
    output: str = None, distributed_rank: int = 0, *, name: str = "proben_tpu_torch", level=logging.INFO
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    fmt = _ColorFormatter("[%(asctime)s %(name)s]: %(message)s", datefmt="%m/%d %H:%M:%S")

    if distributed_rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setFormatter(fmt)
        logger.addHandler(ch)

    if output:
        filename = output if output.endswith(".txt") or output.endswith(".log") else os.path.join(output, "log.txt")
        if distributed_rank > 0:
            filename = filename + f".rank{distributed_rank}"
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setFormatter(logging.Formatter("[%(asctime)s] %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(fh)
    return logger


def log_first_n(level, msg, n=1, *, name="proben_tpu_torch"):
    """Log ``msg`` the first ``n`` times it is passed in this process."""
    _LOG_COUNTER[msg] += 1
    if _LOG_COUNTER[msg] <= n:
        logging.getLogger(name).log(level, msg)


def log_every_n_seconds(level, msg, n=1, *, name="proben_tpu_torch"):
    """Log ``msg`` at most once every ``n`` seconds."""
    now = time.time()
    last = _LOG_TIMER.get(msg)
    if last is None or now - last >= n:
        logging.getLogger(name).log(level, msg)
        _LOG_TIMER[msg] = now
