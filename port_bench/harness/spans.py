"""The program's own stage spans in a traced run, read from the profiler's
Chrome trace beside the device's work.

The program marks its stages (``proben_tpu_torch/utils/tracing.py``) with
``record_function`` ranges while a profiler records: ``user_annotation``
events on the thread that runs the iterations, on the kernels' clock. Each
stretch inside an iteration with nothing on the device is split at span
edges and each piece is given to the innermost span that covers it, or to
``outside`` where none does. ``Trace`` (``trace.py``) reads no
``user_annotation`` event but the iteration ranges, so its numbers are the
same with spans as without.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Mapping, Tuple

from .trace import DEVICE_CATS, ITER, _union

OUTSIDE = "outside"


def _minus(a: float, b: float, busy: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The parts of (a, b) that no interval of the sorted union ``busy``
    covers."""
    out, cur = [], a
    for x, y in busy[max(bisect.bisect_right(busy, (a, a)) - 1, 0):]:
        if x >= b:
            break
        if y <= cur:
            continue
        if x > cur:
            out.append((cur, x))
        cur = max(cur, y)
    if cur < b:
        out.append((cur, b))
    return out


class Spans:
    """The spans and the in-iteration device idle of one profiled run, in
    seconds."""

    def __init__(self, raw: Mapping):
        ev = [e for e in raw.get("traceEvents", []) if e.get("ph") == "X"]
        its = [e for e in ev if e.get("name") == ITER and e.get("cat") in ("user_annotation", "cpu_op")]
        if not its:
            raise RuntimeError("trace: no iteration range recorded")
        self.iters = sorted((e["ts"], e["ts"] + e["dur"]) for e in its)
        tids = {e["tid"] for e in its}
        self.spans = sorted((e for e in ev if e.get("cat") == "user_annotation" and e["name"] != ITER
                             and e["tid"] in tids), key=lambda e: e["ts"])
        busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in ev if e.get("cat") in DEVICE_CATS])
        self.gaps = [g for a, b in self.iters for g in _minus(a, b, busy)]

    @property
    def names(self) -> List[str]:
        return sorted({e["name"] for e in self.spans})

    def calls(self, name: str) -> int:
        return sum(1 for e in self.spans if e["name"] == name)

    @property
    def idle_s(self) -> float:
        """Device idle inside the iterations."""
        return sum(b - a for a, b in self.gaps) / 1e6

    def span_idle_seconds(self, name: str) -> float:
        """Device idle inside the intervals of span ``name`` (spans nested
        in it included), within the iterations."""
        held = _union([(e["ts"], e["ts"] + e["dur"]) for e in self.spans if e["name"] == name])
        return sum(max(0.0, min(b, y) - max(a, x)) for a, b in held for x, y in self.gaps) / 1e6

    def idle_by_span(self) -> Dict[str, float]:
        """All in-iteration idle, each piece given to the innermost span
        that covers it (``outside`` where none does), largest first."""
        edges = sorted({t for e in self.spans for t in (e["ts"], e["ts"] + e["dur"])})
        starts = [e["ts"] for e in self.spans]
        out: Dict[str, float] = {}
        for a, b in self.gaps:
            cuts = [a] + edges[bisect.bisect_right(edges, a):bisect.bisect_left(edges, b)] + [b]
            for x, y in zip(cuts, cuts[1:]):
                mid, label, best = 0.5 * (x + y), OUTSIDE, None
                for e in self.spans[:bisect.bisect_right(starts, mid)]:
                    if e["ts"] + e["dur"] >= mid and (best is None or e["dur"] < best):
                        label, best = e["name"], e["dur"]
                out[label] = out.get(label, 0.0) + (y - x) / 1e6
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))
