"""The program's stage spans and host counters in one run of one cell, and
what the spans cost while the profiler records.

    python3 port_bench/span_probe.py --workload <name> --seed <n> [--seconds 40] [--pairs 3]

Runs the cell as ``run.py --trace 1`` does, and reads what the per-layer
readers read (``cells.Layers``):

- from the harness's first traced pass, the device idle inside the
  iterations split by the innermost program span (``harness/spans.py``),
  each span's idle, and each program counter's increase per iteration
  (``nms.iters``, ``roi.oow``, the kernels' launches, ...);
- then, after the harness's passes, ``pairs`` pairs of passes over the
  cell's traced iterations, one with the spans and one with ``span`` made
  the program's no-op, alternating which comes first: each pass's seconds
  per iteration, device idle share, blocking calls and kernel launches per
  iteration, as ``Trace`` reads them.

Prints one JSON line: those numbers (ms per iteration), the harness's
per-layer metrics and ``correct``. Reads the program's counters from
``proben_tpu_torch.utils.tracing``, so it runs only on a program that has
them. The benchmark's command does not run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def _pass(trace, n):
    return {"iter_ms": sum(b - a for a, b in trace.iters) / 1e3 / n,
            "idle_pct": 100.0 * (1.0 - trace.busy_s / trace.window_s),
            "syncs": trace.blocking_calls / n, "launches": trace.launches / n}


def probe(root: Path, workload: str, seed: int, seconds: float, pairs: int, device: str) -> dict:
    from harness import cells
    from harness.trace import Trace, profile
    from proben_tpu_torch.utils import tracing

    rec = {"workload": workload, "seed": seed}
    harness_traced = cells.traced

    def traced(cell, kind, step, img_s, flops):
        layers = cells.trace_layers(cell, kind, step, img_s, flops)
        n, sp = layers.iters, layers.spans
        rec["counters"] = layers.counters
        rec["idle_ms"] = 1e3 * sp.idle_s / n
        rec["idle_by_span_ms"] = {k: 1e3 * v / n for k, v in sp.idle_by_span().items()}
        rec["span_idle_ms"] = {k: 1e3 * sp.span_idle_seconds(k) / n for k in sp.names}
        rec["span_calls"] = {k: sp.calls(k) / n for k in sp.names}
        rec["first"] = _pass(layers.trace, n)
        out = cells.report(cell, layers)
        rec["harness"] = {k: v["value"] for k, v in out["metrics"].items()}
        path = str(cell.root / "build" / "port_bench" / "span_probe.json")
        passes = {"on": [], "off": []}
        span = tracing.span
        for i in range(pairs):
            for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
                if mode == "off":
                    tracing.span = lambda name: tracing._OFF
                try:
                    passes[mode].append(_pass(Trace(profile(step, n, path)), n))
                finally:
                    tracing.span = span
        rec["passes"] = passes
        if pairs:
            rec["on_minus_off_ms"] = (statistics.median(p["iter_ms"] for p in passes["on"])
                                      - statistics.median(p["iter_ms"] for p in passes["off"]))
        return out

    cells.traced = traced
    try:
        rec["correct"] = cells.run(root, workload, seed, seconds, True, device, T0)["correct"]
    finally:
        cells.traced = harness_traced
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", type=Path, default=HERE.parent, help="the checkout whose cells are read")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    cache = HERE.parent / "build" / "port_bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    rec = probe(args.root, args.workload, args.seed, args.seconds, args.pairs, args.device)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
