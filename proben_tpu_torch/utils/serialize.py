"""Picklable wrapper for closures and lambdas sent across process
boundaries (counterpart of ``proben_tpu/utils/serialize.py``; reference
``detectron2/utils/serialize.py:5`` PicklableWrapper)."""

from __future__ import annotations

import marshal
import pickle
import types


class PicklableWrapper:
    """Wraps ``obj`` so that it pickles: a picklable object as it is; a
    function without a closure (a lambda, a nested function) by its
    marshalled code, rebuilt with this module's globals when called. Any
    other unpicklable object raises."""

    def __init__(self, obj):
        self._obj = obj
        try:
            pickle.dumps(obj)
            self._blob = None
        except (pickle.PicklingError, AttributeError, TypeError):
            if isinstance(obj, types.FunctionType) and not obj.__closure__:
                self._blob = (marshal.dumps(obj.__code__), obj.__name__)
                self._obj = None
            else:
                raise

    def __call__(self, *args, **kwargs):
        return self._get()(*args, **kwargs)

    def _get(self):
        if self._obj is not None:
            return self._obj
        code, name = self._blob
        return types.FunctionType(marshal.loads(code), globals(), name)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._get(), name)
