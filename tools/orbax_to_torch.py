#!/usr/bin/env python
"""Convert checkpoints written by ``proben_tpu`` (orbax) into the format of
``proben_tpu_torch`` (``torch.save``), so a model trained with the JAX
package resumes or evaluates in the port.

Usage:
  python tools/orbax_to_torch.py SRC DST [--seed N]

SRC is a ``CheckpointManager`` root of the JAX package (``iter_<N>/``,
``best/``, ``last.json``) or one directory of its ``save_pytree``. DST is a
new or empty directory that neither holds SRC nor lies inside it (the
converter refuses anything else and deletes nothing). DST gets
the same layout in the port's format: one ``tree.pt`` per directory (the
port's ``save_pytree``) and, for a root, ``last.json`` with its ``last`` and
``kept`` paths pointed into DST. Then
``proben_tpu_torch.checkpoint.CheckpointManager(DST)`` restores it, the
port's ``DefaultTrainer`` resumes from ``DST`` as its
``<OUTPUT_DIR>/checkpoints``, and ``apps/flir.py::load_params(cfg,
DST/best)`` reads the best model.

Each directory is restored with ``ocp.StandardCheckpointer().restore(path)``
(no template needed) and converted by what it holds:

- a parameter pytree (``best/``, ``save_pytree`` of parameters) keeps the
  JAX package's layout, as the port's ``save_best`` writes it: the numpy
  pytree ``load_params`` and ``restore_pytree`` take;
- a JAX train state (``engine/train.py::TrainState``: ``params``,
  ``opt_state`` with ``momentum`` and ``step``, ``step``, ``key``) becomes
  the port's ``train_state_tree``: parameters and SGD momentum by parameter
  name in the port's layouts (``checkpoint/from_jax.py::state_dict_from_jax``),
  ``step``, and ``seed``.

The random key has no counterpart: the port reseeds each step's sampling
from ``(seed, step)``. ``--seed`` (default 0) is stored as that seed, and
``last.json`` records it with a note that the sampling after a resume is the
port's own, not the JAX run's.

Runs where orbax is installed (it imports ``orbax.checkpoint``, numpy, torch
and ``proben_tpu_torch``; nothing of ``proben_tpu``). The port itself never
reads orbax.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from proben_tpu_torch.checkpoint import save_pytree, state_dict_from_jax  # noqa: E402

TRAIN_STATE_KEYS = {"params", "opt_state", "step", "key"}
SAMPLING_NOTE = ("converted from a proben_tpu orbax checkpoint: the JAX random key is dropped, and "
                 "after a resume each step's sampling is reseeded from (seed, step) by "
                 "proben_tpu_torch, not drawn from the JAX run's key")


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return np.asarray(tree)


def restore_orbax(path: str) -> Any:
    """The pytree of one orbax directory, with numpy leaves."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    try:
        return _numpy(ckptr.restore(os.path.abspath(path)))
    finally:
        ckptr.close()


def is_train_state(tree: Any) -> bool:
    return isinstance(tree, dict) and set(tree) == TRAIN_STATE_KEYS


def convert_tree(tree: Any, seed: int) -> Any:
    """A restored JAX tree as the port saves it (see the module docstring)."""
    if not is_train_state(tree):
        return tree
    momentum = tree["opt_state"]["momentum"]
    return {
        "params": state_dict_from_jax(tree["params"]),
        "momentum": state_dict_from_jax(momentum),
        "step": int(tree["step"]),
        "seed": int(seed),
    }


def convert_dir(src: str, dst: str, seed: int) -> str:
    """Convert one orbax directory into ``dst`` (its ``tree.pt``); returns
    "train_state" or "pytree"."""
    tree = restore_orbax(src)
    save_pytree(dst, convert_tree(tree, seed))
    return "train_state" if is_train_state(tree) else "pytree"


def _checkpoint_dirs(root: str) -> List[str]:
    return sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
                  and (d.startswith("iter_") or d == "best"))


def check_destination(src: str, dst: str) -> None:
    """Raise ValueError, before anything is read or written, where ``dst``
    is ``src``, lies inside it or holds it, or is a directory that is not
    empty: the converter deletes nothing, and the JAX checkpoints may be
    the only copy."""
    src, dst = os.path.realpath(src), os.path.realpath(dst)
    if os.path.commonpath([src, dst]) in (src, dst):
        raise ValueError(f"the destination {dst} overlaps the source {src}; give a new directory")
    if os.path.exists(dst) and (not os.path.isdir(dst) or os.listdir(dst)):
        raise ValueError(f"the destination {dst} exists and is not an empty directory; give a new one")


def convert(src: str, dst: str, seed: int = 0) -> Dict[str, str]:
    """Convert a ``CheckpointManager`` root or one ``save_pytree`` directory
    ``src`` into ``dst``, a new or empty directory that does not overlap
    ``src`` (``check_destination``); returns {directory name: kind}."""
    src, dst = os.path.abspath(src), os.path.abspath(dst)
    check_destination(src, dst)
    meta_path = os.path.join(src, "last.json")
    subdirs = _checkpoint_dirs(src)
    if not os.path.exists(meta_path) and not subdirs:
        return {os.path.basename(src): convert_dir(src, dst, seed)}
    os.makedirs(dst, exist_ok=True)
    kinds = {d: convert_dir(os.path.join(src, d), os.path.join(dst, d), seed) for d in subdirs}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)

        def moved(p):
            return os.path.join(dst, os.path.basename(os.path.normpath(p)))

        if meta.get("last"):
            meta["last"] = moved(meta["last"])
        meta["kept"] = [moved(p) for p in meta.get("kept", [])]
        meta.update(seed=int(seed), converted_from=src, sampling=SAMPLING_NOTE)
        with open(os.path.join(dst, "last.json"), "w") as f:
            json.dump(meta, f)
    return kinds


def main(argv=None) -> Dict[str, str]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src", help="a proben_tpu CheckpointManager root or save_pytree directory")
    parser.add_argument("dst", help="the output directory: new or empty, and apart from SRC")
    parser.add_argument("--seed", type=int, default=0,
                        help="the port's sampling seed stored in a converted train state")
    args = parser.parse_args(argv)
    kinds = convert(args.src, args.dst, args.seed)
    for name, kind in kinds.items():
        print(f"{name}: {kind}")
    return kinds


if __name__ == "__main__":
    main()
