"""Map a ``proben_tpu`` parameter pytree onto the port's module state, and
back.

The caller hands over ``init_rcnn``'s pytree already converted to nested
dicts/lists of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``);
this module never imports JAX. ``state_dict_from_jax`` is the inverse of
``proben_tpu/checkpoint/torch_import.py``:

  * conv ``w`` HWIO (kh, kw, in, out) -> ``weight`` OIHW
  * linear ``w`` (in, out) -> ``weight`` (out, in)
  * conv/linear ``b`` -> ``bias`` as it is
  * folded-BN ``scale``/``bias`` -> the ``Affine`` parameters as they are

``state_dict_to_jax`` maps any name -> tensor dict of that layout (the
parameters, or the optimizer's momentum) back to the pytree.

Pooled RoI features keep the JAX (P, P, C) flatten order in the port, so fc1
needs no ``fc1_nchw_to_nhwc_perm``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _leaf(key: str, value: np.ndarray):
    a = np.asarray(value, np.float32)
    if key == "w":
        if a.ndim == 4:
            return "weight", np.transpose(a, (3, 2, 0, 1))
        if a.ndim == 2:
            return "weight", a.T
        raise ValueError(f"unexpected weight rank {a.ndim}")
    if key == "b":
        return "bias", a
    if key in ("scale", "bias"):
        return key, a
    raise KeyError(f"unknown parameter leaf {key!r}")


def state_dict_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten a numpy pytree into ``RCNN.state_dict()`` names and layouts."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            if isinstance(v, (dict, list, tuple)):
                walk(v, f"{prefix}{k}.")
            else:
                name, arr = _leaf(str(k), v)
                out[f"{prefix}{name}"] = torch.from_numpy(np.array(arr, np.float32))

    walk(tree, "")
    return out


def state_dict_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Nested dicts/lists of numpy arrays in ``proben_tpu``'s pytree layout
    from ``RCNN.state_dict()``-style names (numeric path parts become list
    indices; a ``bias`` beside a ``scale`` belongs to a folded-BN affine)."""
    tree: Dict[str, Any] = {}
    for name, value in state.items():
        prefix, leaf = name.rsplit(".", 1)
        a = value.detach().cpu().numpy()
        if leaf == "weight":
            key, a = "w", (np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a.T)
        elif leaf == "bias" and f"{prefix}.scale" not in state:
            key = "b"
        elif leaf in ("scale", "bias"):
            key = leaf
        else:
            raise KeyError(f"unknown parameter name {name!r}")
        node = tree
        for part in prefix.split("."):
            node = node.setdefault(part, {})
        node[key] = np.ascontiguousarray(a)

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)
