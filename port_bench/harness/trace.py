"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a fixed
number of iterations after the measured window, read back from its Chrome
trace.

Each iteration runs inside a ``port_bench.iter`` range, so that what the
harness does around the iterations is never counted. From the trace come
the device's busy time (the union of its kernels, copies and sets), the
kernels launched, the host calls that block on the device, the costliest
device operations and the longest idle gaps with the host op running in
each. A second pass, under a ``TorchDispatchMode`` that records the
arguments of the program's custom ops, gives each op call its own kernels'
device time beside the inputs that call was given.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ITER = "port_bench.iter"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# runtime calls after which the host waits for the device
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
            "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpyDtoH_v2")


class OpArgs(TorchDispatchMode):
    """Records (op name, args, output) of every call of the ops named."""

    def __init__(self, names: Sequence[str]):
        super().__init__()
        self.names = set(names)
        self.calls: List[Tuple[str, tuple, object]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        if name in self.names:
            self.calls.append((name, args, out))
        return out


def profile(step: Callable[[], None], n: int, path: str, mode: TorchDispatchMode = None) -> Dict:
    """Run ``step`` ``n`` times under the profiler (and ``mode``); the
    parsed Chrome trace. Without CUDA only the host is traced."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            with torch.profiler.record_function(ITER):
                if mode is None:
                    step()
                else:
                    with mode:
                        step()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """The events of one profiled run, in seconds."""

    def __init__(self, raw: Mapping):
        ev = [e for e in raw.get("traceEvents", []) if e.get("ph") == "X"]
        self.iters = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev if e.get("name") == ITER
                            and e.get("cat") in ("user_annotation", "cpu_op"))
        if not self.iters:
            raise RuntimeError("trace: no iteration range recorded")
        self.t0, self.t1 = self.iters[0][0], self.iters[-1][1]
        self.device = [e for e in ev if e.get("cat") in DEVICE_CATS and self.t0 <= e["ts"] <= self.t1 + 1e6]
        self.runtime = [e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver")
                        and self.t0 <= e["ts"] <= self.t1]
        self.cpu_ops = [e for e in ev if e.get("cat") == "cpu_op" and self.t0 <= e["ts"] <= self.t1]
        if self.device:
            self.t1 = max(self.t1, max(e["ts"] + e["dur"] for e in self.device))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy(self) -> List[Tuple[float, float]]:
        return _union([(e["ts"], e["ts"] + e["dur"]) for e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    @property
    def launches(self) -> int:
        return sum(1 for e in self.device if e["cat"] == "kernel")

    @property
    def blocking_calls(self) -> int:
        return sum(1 for e in self.runtime if e["name"] in BLOCKING)

    def top_device_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for e in self.device:
            tot[e["name"]] = tot.get(e["name"], 0.0) + e["dur"] / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest stretches with nothing on the device inside the
        traced span, each named by the innermost host op that covers its
        middle: "python" where the host runs no op inside an iteration,
        "harness" between iterations."""
        busy = self.busy()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        ops = sorted(self.cpu_ops, key=lambda e: e["ts"])
        starts = [e["ts"] for e in ops]
        out = []
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            inside = any(a0 <= mid <= b0 for a0, b0 in self.iters)
            label, best = ("python" if inside else "harness"), None
            for e in ops[:bisect.bisect_right(starts, mid)]:
                if e["ts"] + e["dur"] >= mid and (best is None or e["dur"] < best):
                    label, best = e["name"], e["dur"]
            out.append([label, (b - a) / 1e6])
        return out

    def op_kernel_seconds(self, name: str) -> List[float]:
        """Device seconds of the kernels launched under each call of the
        host op ``name`` (outermost calls only), in call order."""
        calls = sorted((e for e in self.cpu_ops if e["name"] == name), key=lambda e: e["ts"])
        outer: List[Mapping] = []
        for e in calls:
            if not outer or e["ts"] >= outer[-1]["ts"] + outer[-1]["dur"] or e["tid"] != outer[-1]["tid"]:
                outer.append(e)
        by_corr: Dict[int, float] = {}
        for e in self.device:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                by_corr[c] = by_corr.get(c, 0.0) + e["dur"] / 1e6
        out = []
        for call in outer:
            a, b, tid = call["ts"], call["ts"] + call["dur"], call["tid"]
            out.append(sum(by_corr.get(r.get("args", {}).get("correlation"), 0.0) for r in self.runtime
                           if r["tid"] == tid and a <= r["ts"] <= b))
        return out
