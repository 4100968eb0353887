"""Minimal yacs-compatible config system (counterpart of
``proben_tpu/config/config.py``).

``CfgNode``: attribute-style nested dict with YAML loading, ``_BASE_``
inheritance, dotted-key list overrides, cloning and freezing. YAML goes
through the port's own reader (``yaml_subset``), which takes the subset the
configs and command-line overrides use and raises, naming the line, on
anything else."""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Sequence

from . import yaml_subset

BASE_KEY = "_BASE_"


class CfgNode(dict):
    def __init__(self, init: Dict = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        for k, v in (init or {}).items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    # attribute access -----------------------------------------------------
    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any):
        if getattr(self, "_frozen", False):
            raise AttributeError(f"cannot set {name} on a frozen CfgNode")
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    # lifecycle ------------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def freeze(self):
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self):
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def __deepcopy__(self, memo):
        out = CfgNode()
        for k, v in self.items():
            out[k] = copy.deepcopy(v, memo)
        return out

    # merging --------------------------------------------------------------
    def merge_from_other(self, other: "CfgNode"):
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_other(v)
            else:
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def merge_from_file(self, path: str, allow_unsafe: bool = False):
        with open(path) as f:
            try:
                loaded = yaml_subset.safe_load(f.read()) or {}
            except yaml_subset.YAMLSubsetError as e:
                raise yaml_subset.YAMLSubsetError(f"{path}: {e.args[0]}", e.line) from None
        if BASE_KEY in loaded:
            base = loaded.pop(BASE_KEY)
            if not os.path.isabs(base):
                base = os.path.join(os.path.dirname(path), base)
            self.merge_from_file(base)
        loaded = CfgNode(loaded)

        # VERSION migration: downgrade the defaults to the file's schema,
        # merge, upgrade back (compat.py)
        self_ver = self.get("VERSION")
        if self_ver is not None:
            from .compat import downgrade_config, guess_version, upgrade_config

            loaded_ver = loaded.get("VERSION")
            if loaded_ver is None:
                loaded_ver = guess_version(loaded, path)
            if loaded_ver > self_ver:
                raise ValueError(
                    f"config {path} is v{loaded_ver}, newer than runtime v{self_ver}"
                )
            if loaded_ver < self_ver:
                old_self = downgrade_config(self, to_version=loaded_ver)
                old_self.merge_from_other(loaded)
                upgraded = upgrade_config(old_self, to_version=self_ver)
                self.clear()
                self.merge_from_other(upgraded)
                return
        self.merge_from_other(loaded)

    def merge_from_list(self, opts: Sequence):
        if len(opts) % 2:
            raise ValueError(f"override list must be key value pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            old = node.get(leaf)
            node[leaf] = _coerce(value, old)

    def dump(self) -> str:
        """The tree as YAML (sorted keys, sequences in flow style), in the
        subset the reader takes; tuples are written as sequences."""
        return yaml_subset.dump(self)


def _coerce(value: Any, old: Any) -> Any:
    """Parse a CLI string override to the type of the existing value; a
    string the reader does not take stays a string."""
    if not isinstance(value, str):
        return value
    try:
        parsed = yaml_subset.safe_load(value)
    except yaml_subset.YAMLSubsetError:
        parsed = value
    if isinstance(old, tuple) and isinstance(parsed, list):
        parsed = tuple(parsed)
    return parsed
