"""Deployment export (counterpart of ``proben_tpu/export/api.py``, which
serializes a StableHLO program with ``jax.export``): the artifact is a
``torch.export`` program, ``torch.export.save``d as ``model.pt2``, loadable
without the model-building Python code.

The detector's hand-written kernels are custom ops (``proben::stem_pool``,
``proben::roi_align_fwd``, ``proben::block_epilogue``, ``proben::nms_keep``),
so the exported graph holds them as nodes: the loaded program launches K1,
K2, K4 and K5 on the card and runs their plain versions on the CPU. Importing this module registers those ops, which
``load_exported`` needs. The exported function is the model on a padded batch
(``rcnn_inference``); the host-side resize of ``Predictor`` and the
``image_io`` decode stay outside it.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Sequence

import torch

from ..ops import epilogue_cuda, nms, roi_align_cuda, stem_cuda  # noqa: F401  (registers the ops)
from ..structures.detections import Detections

ARTIFACT = "model.pt2"

# the detector's output type crosses the exported program's boundary
torch.export.register_dataclass(Detections, serialized_type_name="proben_tpu_torch.Detections")


class _Function(torch.nn.Module):
    """A function as a module for ``torch.export``. The modules among a
    ``functools.partial``'s arguments become submodules, so their
    parameters are the program's parameters, not constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn
        owners = getattr(fn, "args", ()) + tuple(getattr(fn, "keywords", {}).values())
        self.owners = torch.nn.ModuleList(m for m in owners if isinstance(m, torch.nn.Module))

    def forward(self, *args):
        return self.fn(*args)


def _shape_tree(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_shape_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: _shape_tree(v) for k, v in x.items()}
    return (tuple(x.shape), str(x.dtype).replace("torch.", ""))


def export_model(fn: Callable, example_args: Sequence, out_dir: str) -> str:
    """Export ``fn`` (a module, or a function such as
    ``functools.partial(rcnn_inference, model, cfg)``) at the example
    arguments' shapes to ``out_dir``: ``model.pt2`` (the program, its
    parameters included) and ``example_args.pkl`` (the arguments'
    (shape, dtype) tree). Returns the artifact's path."""
    os.makedirs(out_dir, exist_ok=True)
    module = fn if isinstance(fn, torch.nn.Module) else _Function(fn)
    program = torch.export.export(module, tuple(example_args))
    path = os.path.join(out_dir, ARTIFACT)
    torch.export.save(program, path)
    with open(os.path.join(out_dir, "example_args.pkl"), "wb") as f:
        pickle.dump(_shape_tree(tuple(example_args)), f)
    return path


def load_exported(out_dir: str) -> Callable:
    """Load an exported artifact; returns a module running the program."""
    return torch.export.load(os.path.join(out_dir, ARTIFACT)).module()

