"""OOM-retry helper (counterpart of ``proben_tpu/utils/memory.py``; reference
``detectron2/utils/memory.py:26`` ``retry_if_cuda_oom``).

An explicit opt-in of the caller: nothing in the package wraps itself in
it. Unlike JAX's helper, which reruns the function on the CPU after a
second out-of-memory error, this one raises that error: a wrapper of the
port never moves work off the card by itself. A caller who wants a CPU run
asks for it (``device="cpu"``)."""

from __future__ import annotations

import functools
import logging

import torch

logger = logging.getLogger(__name__)


def retry_if_oom(func):
    """``func`` wrapped: on ``torch.cuda.OutOfMemoryError`` it logs a
    warning, empties PyTorch's CUDA cache and calls ``func`` once more; a
    second out-of-memory error propagates, as do other errors."""

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except torch.cuda.OutOfMemoryError:
            logger.warning("CUDA out of memory in %s; emptying the cache and retrying once", func)
        torch.cuda.empty_cache()
        return func(*args, **kwargs)

    return wrapped
