"""Stage spans and host counters of the program.

``span(name)`` marks a stage of the inference or training loop. While a
``torch.profiler`` profile records, it is a ``record_function`` range: a
``user_annotation`` event in the same Chrome trace as the CUDA kernels, on
the same clock, so each stretch the device idles can be put down to the
stage the host was in. Otherwise (and while ``torch.export`` traces, so an
exported program holds no span node) it is one shared no-op context,
which costs one attribute read. Nothing turns spans on but the profiler.

``count(name, n)`` adds a host int to a process-wide counter and
``counters()`` returns a copy of them all. Counters always count, and
never read a device value: each counts what the host already knows (a
launch it made, an iteration of a loop whose exit it already read).

| span | covers |
|---|---|
| ``predictor.predict_batch`` | ``Predictor.predict_batch`` |
| ``predictor.to_host`` | the numpy copies and the per-image trim (the rescale before it is ``infer``'s) |
| ``train.step`` | ``train_step`` |
| ``rcnn.features`` | normalisation, the backbone(s) with K1, the FPN, the middle-fusion concat |
| ``rcnn.rpn`` | RPN head, anchors, top proposals; in training the RPN losses and the RoI sampling |
| ``rcnn.roi_pool`` | the multi-level RoIAlign: window inputs, K2, the fallback |
| ``roi.window_inputs`` | K2's level assignment, window origins and weights |
| ``roi.fallback`` | the out-of-window read and the whole-map re-pooling |
| ``nms.fixpoint`` | the NMS fixpoint loop (RPN and class NMS) of the CPU route; the card runs K5, outside any span of its own |
| ``rcnn.box`` | box head, output layers, then the detections or the losses |
| ``train.backward`` | ``torch.autograd.grad`` |
| ``train.all_reduce`` | the mean over ranks (world > 1 only) |
| ``train.update`` | the SGD update, the NaN guard, the copy into the parameters |
| ``train.nan_guard`` | the guard inside ``train.update`` |
| ``ensemble.member`` | one member's ``Predictor.infer`` inside ``ProbEnPredictor`` (its ``rcnn.*`` spans nested) |
| ``proben.fuse`` | ``fusion/proben_torch.py::fuse_detections_torch``, the whole call |
| ``proben.fixpoint`` | its keep-set loop |

| counter | counts |
|---|---|
| ``k1.launches``, ``k2.launches`` | launches of K1 and K2 (never of their plain versions) |
| ``k3.launches``, ``io.launches`` | launches of K3 and of ``image_io``'s compose kernel |
| ``k4.launches`` | calls of K4, forward and backward (the backward's second kernel sums its partials) |
| ``k5.launches`` | calls of K5, NMS on the card (its mask pass and sweep), one per ``nms_mask`` call |
| ``epilogue.plain`` | bottleneck epilogues on CUDA maps K4 does not take, run as the plain composition |
| ``nms.calls``, ``nms.iters`` | NMS fixpoint calls and their iterations (one host read each): the CPU route |
| ``proben.calls``, ``proben.iters`` | late-fusion fixpoint calls and their iterations (one host read each) |
| ``roi.oow`` | RoIs out of their pooling window: the fallback re-pools them |
| ``roi.oow_over_capacity`` | of those, the ones past its per-image capacity: left windowed |
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
_counts: Dict[str, int] = {}
# kernels launch from loader threads and from autograd's backward threads
_lock = threading.Lock()


def span(name: str):
    """A ``record_function`` range named ``name`` while the profiler
    records, else a shared no-op context."""
    if not _profiler._is_profiler_enabled or torch.compiler.is_exporting():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add the host int ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter: the totals since the process started."""
    with _lock:
        return dict(_counts)
