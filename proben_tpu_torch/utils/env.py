"""Environment helpers (counterpart of ``proben_tpu/utils/env.py``;
reference ``utils/env.py:15`` seed_all_rng and ``utils/collect_env.py:55``)."""

from __future__ import annotations

import datetime
import os
import random
import sys

import numpy as np
import torch


def seed_all_rng(seed: int = None) -> int:
    """Seed Python's, numpy's and torch's default generators (CPU and every
    CUDA device) with ``seed``, or with one made from the pid, the clock and
    ``os.urandom`` when it is None; returns the seed."""
    if seed is None:
        seed = (
            os.getpid()
            + int(datetime.datetime.now().strftime("%S%f"))
            + int.from_bytes(os.urandom(2), "big")
        )
    np.random.seed(seed % (2 ** 31))
    random.seed(seed)
    torch.manual_seed(seed)  # also every CUDA device's default generator
    return seed


def collect_env_info() -> str:
    """Platform, Python, numpy, torch and CUDA versions, the CUDA devices."""
    cuda = torch.cuda.is_available()
    lines = [
        f"sys.platform: {sys.platform}",
        f"python: {sys.version.splitlines()[0]}",
        f"numpy: {np.__version__}",
        f"torch: {torch.__version__}",
        f"torch CUDA: {torch.version.cuda}",
        f"CUDA available: {cuda}",
        f"device count: {torch.cuda.device_count() if cuda else 0}",
    ]
    if cuda:
        lines += [f"device {i}: {torch.cuda.get_device_name(i)}" for i in range(torch.cuda.device_count())]
        lines.append(f"cuDNN: {torch.backends.cudnn.version()}")
    return "\n".join(lines)
