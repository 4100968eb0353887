"""Global dataset/metadata catalogs (counterpart of ``proben_tpu/data/catalog.py``).

``DatasetCatalog`` maps a name to a function producing a list of dataset
dicts; ``MetadataCatalog`` holds per-dataset metadata (thing_classes, the
dataset-id -> contiguous-id mapping, json/image paths)."""

from __future__ import annotations

import types
from typing import Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, func: Callable[[], List[dict]]):
        if name in self._registry:
            raise KeyError(f"dataset '{name}' already registered")
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        if name not in self._registry:
            raise KeyError(
                f"dataset '{name}' not registered; available: {list(self._registry)}"
            )
        return self._registry[name]()

    def remove(self, name: str):
        self._registry.pop(name, None)

    def list(self) -> List[str]:
        return list(self._registry)

    def clear(self):
        self._registry.clear()


class Metadata(types.SimpleNamespace):
    def get(self, key, default=None):
        return getattr(self, key, default)


class _MetadataCatalog:
    def __init__(self):
        self._store: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._store:
            self._store[name] = Metadata(name=name)
        return self._store[name]

    def clear(self):
        self._store.clear()


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
