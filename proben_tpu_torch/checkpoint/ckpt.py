"""Checkpoints with ``torch.save`` (counterpart of
``proben_tpu/checkpoint/orbax_ckpt.py``, which writes orbax directories; the
reference's fvcore ``DetectionCheckpointer`` + ``PeriodicCheckpointer``,
``checkpoint/detection_checkpoint.py:11``, ``engine/hooks.py:176``).

A checkpoint is a directory holding one file, ``tree.pt``: a pytree (nested
dicts, lists and tuples) of tensors and Python scalars, numpy leaves stored
as tensors. ``restore_pytree`` gives back the leaves in the template's kinds
(numpy, or tensors on the template's device), bit for bit. The JAX
package's orbax directories hold no ``tree.pt``: ``tools/orbax_to_torch.py``
(which needs orbax; this package never imports it) converts them, a
``CheckpointManager`` root with its train states and ``last.json`` included,
and ``restore_pytree`` names it.

``CheckpointManager`` keeps the JAX manager's layout under a root:
``iter_<N:07d>/`` (periodic, ``max_to_keep``), ``best/`` (best metric) and
``last.json`` (``last``, ``step``, ``kept``, ``best_metric``,
``best_step``). ``train_state_tree``/``load_train_state`` turn a
``engine.TrainState`` (parameters, SGD momentum, step, seed) into such a
tree and back, so a restore followed by a step resumes training.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

TREE_FILE = "tree.pt"


def _to_saved(node):
    if isinstance(node, dict):
        return {k: _to_saved(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_saved(v) for v in node)
    if isinstance(node, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(node))
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().clone()
    return node


def save_pytree(path: str, tree: Any) -> None:
    """Save a pytree of tensors, numpy arrays and scalars to the directory
    ``path`` (replaced if it exists)."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(_to_saved(tree), os.path.join(path, TREE_FILE))


def _restored(saved, template, where: str):
    if isinstance(template, dict):
        if not isinstance(saved, dict) or sorted(saved) != sorted(template):
            raise ValueError(f"checkpoint structure differs from the template at {where or 'the root'}")
        return {k: _restored(saved[k], t, f"{where}[{k!r}]") for k, t in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise ValueError(f"checkpoint structure differs from the template at {where or 'the root'}")
        return type(template)(_restored(s, t, f"{where}[{i}]")
                              for i, (s, t) in enumerate(zip(saved, template)))
    if isinstance(template, (np.ndarray, np.generic, torch.Tensor)):
        if not isinstance(saved, torch.Tensor) or tuple(saved.shape) != tuple(np.shape(template)):
            raise ValueError(f"checkpoint leaf at {where} is not a tensor of shape {np.shape(template)}")
        if isinstance(template, torch.Tensor):
            return saved.to(device=template.device, dtype=template.dtype)
        return saved.numpy().astype(template.dtype, copy=False)
    if isinstance(saved, torch.Tensor):
        saved = saved.item()
    return type(template)(saved) if template is not None else saved


def restore_pytree(path: str, template: Any = None) -> Any:
    """Restore a pytree saved by ``save_pytree``. With a ``template`` (the
    same structure), each leaf comes back in the template leaf's kind,
    dtype and device; without one, as saved (tensors on the CPU)."""
    path = os.path.abspath(path)
    file = os.path.join(path, TREE_FILE)
    if not os.path.exists(file):
        if os.path.isdir(path) and os.listdir(path):
            raise ValueError(
                f"{path} holds no {TREE_FILE}: not a checkpoint of this package; convert a "
                "directory written by proben_tpu's orbax checkpointer with "
                "'python tools/orbax_to_torch.py SRC DST' where orbax is installed")
        raise FileNotFoundError(file)
    saved = torch.load(file, map_location="cpu", weights_only=True)
    return saved if template is None else _restored(saved, template, "")


def train_state_tree(state) -> Dict[str, Any]:
    """The checkpoint tree of an ``engine.TrainState``: parameters and SGD
    momentum by parameter name, step and seed (each step's sampling
    generator is reseeded from them)."""
    return {
        "params": {n: p.detach() for n, p in state.model.named_parameters()},
        "momentum": dict(state.momentum),
        "step": int(state.step),
        "seed": int(state.seed),
    }


def load_train_state(tree: Dict[str, Any], state):
    """``state`` (e.g. a fresh ``init_state(model, seed)``) resumed from a
    restored ``train_state_tree``: the parameters copied into its model in
    place; momentum, step and seed replaced."""
    params = dict(state.model.named_parameters())
    if sorted(tree["params"]) != sorted(params):
        raise ValueError("the checkpoint's parameter names differ from the model's")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(tree["params"][name])
    momentum = {n: tree["momentum"][n].to(device=m.device, dtype=m.dtype) for n, m in state.momentum.items()}
    return dataclasses.replace(state, momentum=momentum, step=int(tree["step"]), seed=int(tree["seed"]))


class CheckpointManager:
    """Periodic + best-model checkpoint management under a root directory.

    Layout: root/iter_<N>/ (periodic), root/best/ (best metric),
    root/last.json (pointer + metadata)."""

    def __init__(self, root: str, max_to_keep: int = 2, higher_is_better: bool = True):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.higher_is_better = higher_is_better
        self._kept: list = []
        self.best_metric: Optional[float] = None
        meta = self._read_meta()
        if meta:
            self.best_metric = meta.get("best_metric")
            self._kept = meta.get("kept", [])

    def _meta_path(self) -> str:
        return os.path.join(self.root, "last.json")

    def _read_meta(self) -> Dict:
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                return json.load(f)
        return {}

    def _write_meta(self, **kw) -> None:
        meta = self._read_meta()
        meta.update(kw)
        with open(self._meta_path(), "w") as f:
            json.dump(meta, f)

    def save(self, step: int, state: Any) -> None:
        path = os.path.join(self.root, f"iter_{step:07d}")
        save_pytree(path, state)
        self._kept.append(path)
        while len(self._kept) > self.max_to_keep:
            shutil.rmtree(self._kept.pop(0), ignore_errors=True)
        self._write_meta(last=path, step=step, kept=self._kept)

    def save_best(self, step: int, metric: float, params: Any) -> bool:
        """Save ``params`` as best when ``metric`` beats the best so far
        (higher or lower, by ``higher_is_better``); a tie is not better."""
        better = self.best_metric is None or (
            metric != self.best_metric and (metric > self.best_metric) == self.higher_is_better)
        if better:
            self.best_metric = float(metric)
            save_pytree(os.path.join(self.root, "best"), params)
            self._write_meta(best_metric=self.best_metric, best_step=step)
        return better

    def latest_path(self) -> Optional[str]:
        p = self._read_meta().get("last")
        return p if p and os.path.exists(p) else None

    def latest_step(self) -> Optional[int]:
        return self._read_meta().get("step")

    def restore_latest(self, template: Any = None) -> Optional[Any]:
        p = self.latest_path()
        return restore_pytree(p, template) if p else None

    def restore_best(self, template: Any = None) -> Optional[Any]:
        p = os.path.join(self.root, "best")
        return restore_pytree(p, template) if os.path.exists(p) else None
