"""Model analysis: parameter and FLOP counting (counterpart of
``proben_tpu/utils/analysis.py``, which counts FLOPs with XLA's cost
analysis; reference ``detectron2/utils/analysis.py:23-66``).

``flop_count`` counts through ``torch.utils.flop_counter.FlopCounterMode``.
The port's hand-written kernels (K1 ``ops/stem_cuda.py::stem_pool``, K2
``ops/roi_align_cuda.py::roi_align_fwd``, K3 ``roi_align_bwd``) launch
through ctypes, which that mode cannot see, so each wrapper reports its work
through ``reported_work``, in its kernel branch and in its plain branch alike
(the mode's own count of the plain branch is replaced by the report), so a
path through the kernels and one through the plain versions count the same.
K1 reports its 7x7/s2 conv's products (``ops/stem_cuda.py::stem_flops``,
what the mode counts for the plain version's conv). K2 and K3 report
RoIAlign's own arithmetic (``ops/roi_align_cuda.py::roi_align_flops``): a
multiply and an add per channel for every level pixel that an output bin's
bilinear samples touch, as this run's RoIs need it; not the dense
contractions over each RoI's whole window that their plain versions use to
compute it. NMS reports 0
(``ops/nms.py``): its fixpoint's 0/1 matrix products are a way to solve the
greedy recurrence, not model work, and their number follows how the
suppression chains of the run's boxes fall.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Mapping, Union

import numpy as np
import torch

_active = threading.local()  # the flop_count calls in progress on this thread


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _size(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in _leaves(tree))


def parameter_count(params: Union[torch.nn.Module, Mapping]) -> int:
    """Parameters of a module (``named_parameters()``) or of a nested
    dict/list of tensors or arrays."""
    return _size(params)


def _nested(module: torch.nn.Module) -> Dict:
    """A module's parameters as a nested dict by their dotted names
    (numeric parts become integer-keyed levels, listed in order)."""
    tree: Dict = {}
    for name, p in module.named_parameters():
        node, parts = tree, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(int(part) if part.isdigit() else part, {})
        node[parts[-1]] = p
    return tree


def parameter_count_table(params: Union[torch.nn.Module, Mapping], max_depth: int = 2) -> str:
    """Per-module parameter counts to ``max_depth`` levels, as the JAX
    package's table (the same rows for the same model)."""
    rows: Dict[str, int] = {}
    tree = _nested(params) if isinstance(params, torch.nn.Module) else params

    def walk(node, prefix, depth):
        if depth >= max_depth or not isinstance(node, (Mapping, list, tuple)):
            rows[prefix] = _size(node)
            return
        items = node.items() if isinstance(node, Mapping) else enumerate(node)
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k), depth + 1)

    walk(tree, "", 0)
    total = sum(rows.values())
    lines = [f"{'module':40s} #params"]
    for k, v in sorted(rows.items()):
        lines.append(f"{k:40s} {v / 1e6:8.2f}M")
    lines.append(f"{'TOTAL':40s} {total / 1e6:8.2f}M")
    return "\n".join(lines)


class _Tally:
    def __init__(self, mode):
        self.mode, self.hidden, self.reported = mode, 0, 0


@contextlib.contextmanager
def reported_work(flops: Union[int, Callable[[], int]]):
    """Report a block's work to every ``flop_count`` in progress on this
    thread: ``flops`` are counted, and whatever the mode counts inside the
    block (a kernel wrapper's plain branch, NMS's fixpoint) is not.
    ``flops`` may be a function of no arguments, called once at the block's
    end and only inside ``flop_count`` (a count that reads the data). Costs
    nothing outside ``flop_count``."""
    tallies = getattr(_active, "tallies", ())
    if not tallies:
        yield
        return
    before = [t.mode.get_total_flops() for t in tallies]
    yield
    n = int(flops() if callable(flops) else flops)
    for t, b in zip(tallies, before):
        t.hidden += t.mode.get_total_flops() - b
        t.reported += n


def flop_count(fn: Callable, *example_args) -> int:
    """FLOPs of ``fn(*example_args)``, run once. The rule: products and
    convolutions only, 2 * M * N * K per matrix product (``mm``, ``bmm``,
    ``einsum`` and ``linear`` lowered to them) and 2 * the output's
    elements * the kernel's taps * its input channels per convolution, the
    backward's products where ``fn`` runs one; elementwise work, reductions,
    pooling, sorting and NMS count nothing. The kernels report their work
    (``reported_work``; K1 its conv's products, K2 and K3 RoIAlign's
    multiply-adds per touched pixel and channel). What the run's data
    decides (the RoIs' taps, the out-of-window fallback's pooling) is
    counted as this run needed it."""
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    tally = _Tally(mode)
    tallies = getattr(_active, "tallies", ())
    _active.tallies = tallies + (tally,)
    try:
        with mode:
            fn(*example_args)
    finally:
        _active.tallies = tallies
    return int(mode.get_total_flops() - tally.hidden + tally.reported)
