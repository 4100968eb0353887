"""Model analysis: parameter and FLOP counting (counterpart of
``proben_tpu/utils/analysis.py``, which counts FLOPs with XLA's cost
analysis; reference ``detectron2/utils/analysis.py:23-66``).

``flop_count`` counts through ``torch.utils.flop_counter.FlopCounterMode``.
The port's hand-written kernels are ``torch.library`` custom ops, each with
a flop formula that the mode reads in place of whatever its implementation
runs (the kernel on the card, the plain version on the CPU), so both devices
count the same. K1 (``proben::stem_pool``) counts its 7x7/s2 conv's products
(``ops/stem_cuda.py::stem_flops``, what the mode counts for the plain
composition's conv). K2 and K3 (``proben::roi_align_fwd``, ``proben::
roi_align_bwd``) count RoIAlign's own arithmetic (``ops/roi_align.py::
roi_align_flops``): a multiply and an add per channel for every level pixel
that an output bin's bilinear samples touch, as this run's RoIs need it;
not the dense contractions over each RoI's whole window that their plain
versions use to compute it. Those plain versions are ops with the same
formula (``proben::roi_align_fwd_plain``, ``proben::roi_align_bwd_plain``),
so a path through the kernels and one through the plain versions
(``stem_impl``, ``roi_align_impl`` "plain") count the same. NMS (``proben::nms_keep``: K5 on the card, the fixpoint
``proben::nms_fixpoint`` on the CPU) has no formula and counts 0: it solves
the greedy recurrence, no model work, and the fixpoint's 0/1 matrix
products follow how the suppression chains of the run's boxes fall.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Union

import numpy as np
import torch


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


def flop_count(fn: Callable, *example_args) -> int:
    """FLOPs of ``fn(*example_args)``, run once. The rule: products and
    convolutions only, 2 * M * N * K per matrix product (``mm``, ``bmm``,
    ``einsum`` and ``linear`` lowered to them) and 2 * the output's
    elements * the kernel's taps * its input channels per convolution, the
    backward's products where ``fn`` runs one; elementwise work, reductions,
    pooling, sorting and NMS count nothing. The kernels' ops count by their
    flop formulas (K1 its conv's products, K2 and K3 RoIAlign's
    multiply-adds per touched pixel and channel). What the run's data
    decides (the RoIs' taps, the out-of-window fallback's pooling) is
    counted as this run needed it."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import nms, roi_align_cuda, stem_cuda  # noqa: F401  (the ops' formulas)

    mode = FlopCounterMode(display=False)
    with mode:
        fn(*example_args)
    return int(mode.get_total_flops())
