"""One run of one cell: set-up, the measured window, the traced iterations
(``--trace 1``) and the check against the reference. A cell's
configuration names its architecture (``arch/<name>.py``, by default
``faster_rcnn_fpn``), through which alone the loops reach the program and
the reference. A traffic file's loop is one of the two here,
``predict_batch`` (inference, closed loop, one caller) and ``train_step``
(training), or else ``loops/<loop>.py``."""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional

import torch

from proben_tpu_torch.utils import tracing

from . import counts, frames, judge
from .spans import Spans
from .trace import OpArgs, Trace, profile

DEFAULT_ARCH = "faster_rcnn_fpn"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Cell:
    """What a run needs, found by the names in ``BENCHMARK.json``."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config_file = self.root / self.config_entry["file"]
        self.conf = json.loads(self.config_file.read_text())
        self.bench_dir = self.root / self.bench["paths"][0]
        self.traffic = json.loads((self.bench_dir / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.limits = json.loads((self.bench_dir / "limits" / f"{workload}.json").read_text())["limits"]
        self.arch = load_module(self.bench_dir / "arch" / f"{self.conf.get('arch', DEFAULT_ARCH)}.py")
        self.channels = self.arch.channels(self.conf)

    def metrics_of(self, kind: str) -> List[Mapping]:
        """The end-to-end or per-layer entries this cell reports."""
        name = self.workload["name"]
        return [m for m in self.bench[kind] if name in m.get("workloads", [name])]

    def reader(self, metric: str) -> Callable:
        return load_module(self.bench_dir / "metrics" / f"{metric}.py").read

    def loop(self) -> Callable:
        """The traffic's loop: one of ``LOOPS``, or ``run`` of its file."""
        name = self.traffic["loop"]
        return LOOPS[name] if name in LOOPS else load_module(self.bench_dir / "loops" / f"{name}.py").run


def load_module(path: Path):
    """A file of the benchmark's (an architecture, a loop, a metric) as a
    module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"port_bench: no {path}")
    name = f"port_bench_{path.parent.name}_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Layers:
    """What the per-layer readers read: the first traced pass's trace, the
    program's spans in it (``harness/spans.py``) and its counters'
    increase per traced iteration, each custom op call's least time and
    device time, the window's rate and the model FLOPs of one image."""

    def __init__(self, kind: str, trace: Trace, spans: Spans, counters: Dict[str, float], iters: int,
                 op_calls: List, img_s: float, flops_per_image: float):
        self.kind, self.trace, self.spans, self.counters, self.iters = kind, trace, spans, counters, iters
        self.op_calls, self.img_s, self.flops_per_image = op_calls, img_s, flops_per_image

    def roofline_pct(self, op: str) -> Optional[float]:
        least = sum(l for n, l, _ in self.op_calls if n == op)
        spent = sum(d for n, _, d in self.op_calls if n == op)
        return 100.0 * least / spent if spent > 0 and least > 0 else None


def traced(cell: Cell, kind: str, step: Callable, img_s: float, flops: float) -> Dict:
    """The per-layer metrics and the breakdown from the traced iterations."""
    return report(cell, trace_layers(cell, kind, step, img_s, flops))


def trace_layers(cell: Cell, kind: str, step: Callable, img_s: float, flops: float) -> Layers:
    """Two profiled passes of ``step``: the first read whole, with the
    program's counters around it; the second under the recorder of the
    architecture's custom ops, whose calls are timed and counted. The
    spans are parsed after both passes, so the host's work between them
    is what it was before spans were read."""
    tr = cell.traffic["trace"]
    iters = tr["iterations"]
    scratch = cell.root / "build" / "port_bench"
    scratch.mkdir(parents=True, exist_ok=True)
    before = tracing.counters()
    raw = profile(step, iters, str(scratch / "trace.json"))
    after = tracing.counters()
    counters = {k: (v - before.get(k, 0)) / iters for k, v in sorted(after.items())}
    trace = Trace(raw)
    ops = cell.arch.OPS
    rec = OpArgs(ops)
    captured = Trace(profile(step, tr["captured_iterations"], str(scratch / "trace_ops.json"), rec))
    spans = Spans(raw)
    del raw
    op_calls = []
    for name in sorted(set(n for n, _, _ in rec.calls)):
        calls = [(a, o) for n, a, o in rec.calls if n == name]
        spent = captured.op_kernel_seconds(name)
        if len(spent) != len(calls):
            raise RuntimeError(f"trace: {len(calls)} calls of {name} recorded, {len(spent)} traced")
        op_calls += [(name, counts.least_seconds(*ops[name](a, o))[0], d) for (a, o), d in zip(calls, spent)]
    return Layers(kind, trace, spans, counters, iters, op_calls, img_s, flops)


def report(cell: Cell, layers: Layers) -> Dict:
    """The cell's per-layer metrics read from ``layers``, the traced
    window and the breakdown."""
    trace = layers.trace
    metrics = {}
    for m in cell.metrics_of("per_layer"):
        v = cell.reader(m["name"])(layers)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return {"metrics": metrics, "busy_s": trace.busy_s, "window_s": trace.window_s,
            "breakdown": {"device_ops": trace.top_device_ops(), "idle_gaps": trace.idle_gaps()}}


def device_info(device, chips: int) -> Dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        info["power_limit"] = out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        info["power_limit"] = None
    return info


class Marks:
    """Logs the seconds from process start at each step of set-up."""

    def __init__(self, t0: float, device):
        self.t0, self.device = t0, device
        log(f"set-up: {time.perf_counter() - t0:.3f} s imports and devices")

    def __call__(self, what: str) -> float:
        sync(self.device)
        t = time.perf_counter() - self.t0
        log(f"set-up: {t:.3f} s after {what}")
        return t


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def tf32_off():
    """float32 matmuls and convolutions in float32 (not TF32) inside."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def make_weights(cell: Cell, seed: int, batch: Mapping, device):
    """The run's model state, drawn by the architecture from the seed and
    fitted to the first frames of ``batch``. A mix that names a
    ``model_seed`` serves one model on every seed: the state is drawn from
    that seed and fitted to frames drawn from it."""
    tf = cell.traffic
    if "model_seed" in tf:
        seed = tf["model_seed"]
        batch = frames.inference_pool(seed, dict(tf, pool_batches=1), cell.conf["input"], cell.channels,
                                      device)[0]
    return cell.arch.make_state(cell.conf, seed, batch, device)


# ---------------------------------------------------------------------------
# inference: predict_batch, one caller, closed loop
# ---------------------------------------------------------------------------


def pick_images(seed: int, served: List[List[Mapping]], k: int) -> List[tuple]:
    """(batch, row) of ``k`` served images drawn from the seed, the image
    with the most detections among them."""
    flat = [(b, r) for b, out in enumerate(served) for r in range(len(out))]
    most = max(range(len(flat)), key=lambda i: len(served[flat[i][0]][flat[i][1]]["scores"]))
    picks = frames.check_sample(seed, len(flat), k)
    if most not in picks:
        picks[-1] = most
    return [flat[i] for i in sorted(picks)]


def run_infer(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Dict:
    arch, tf, conf = cell.arch, cell.traffic, cell.conf
    mark = Marks(t0, device)
    pcfg = arch.read_config(str(cell.config_file.parent), conf)
    pool = frames.inference_pool(seed, tf, conf["input"], cell.channels, device)
    mark("frames")
    state = make_weights(cell, seed, pool[0], device)
    mark("weights")
    pred = arch.predictor(pcfg, state, device)
    mark("program")
    for i in range(tf["warmup_batches"]):
        pred.predict_batch(pool[i % len(pool)])
    setup_s = mark("warm-up")

    lat, served = [], []
    start = time.perf_counter()
    end = start
    while end - start < seconds:
        t = time.perf_counter()
        served.append(pred.predict_batch(pool[len(served) % len(pool)]))
        end = time.perf_counter()
        lat.append(end - t)
    window_s = end - start
    images = tf["batch"] * len(served)
    img_s = images / window_s
    p95 = statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3 if len(lat) > 1 else lat[0] * 1e3
    log(f"window: {len(served)} batches in {window_s:.3f} s; batch latency median "
        f"{statistics.median(lat) * 1e3:.4g} ms, p95 {p95:.4g} ms")
    result = {"metrics": {"setup_s": setup_s, "infer_img_s": img_s, "infer_batch_p95_ms": p95}}
    if trace:
        it = iter(range(1 << 30))
        result["traced"] = traced(cell, "infer", lambda: pred.predict_batch(pool[next(it) % len(pool)]),
                                  img_s, arch.flops_per_image(conf, False))
    result["device"] = device_info(device, cell.workload["chips"])
    del pred
    free(device)

    picks = pick_images(seed, served, tf["check_images"])
    imgs = [pool[b % len(pool)]["image"][r] for b, r in picks]
    got = [served[b][r] for b, r in picks]
    want = arch.reference_detections(conf, state, imgs, device)
    numbers = judge.detection_numbers(got, want)
    result.update(numbers=numbers, attempted=images, failed=0)
    return result


# ---------------------------------------------------------------------------
# training: the architecture's training step, batches on the card
# ---------------------------------------------------------------------------


def norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([tensors[n].detach().float().norm() for n in names]).tolist()
    return dict(zip(names, vals))


def run_train(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Dict:
    arch, tf, conf = cell.arch, cell.traffic, cell.conf
    mark = Marks(t0, device)
    pcfg = arch.read_config(str(cell.config_file.parent), conf)
    pool = frames.training_pool(seed, tf, conf["input"], cell.channels, device)
    mark("frames")
    state = make_weights(cell, seed, pool[0], device)
    mark("weights")
    trainer = arch.trainer(pcfg, state, seed, device)
    mark("program")
    batches = [trainer.batch(b) for b in pool]
    n_check = tf["checked_steps"]

    def step(i: int) -> Dict[str, float]:
        metrics = trainer.step(batches[i % len(batches)])
        values = torch.stack([v.float() for v in metrics.values()]).tolist()  # the loop's one read
        return dict(zip(metrics, values))

    # the checked steps: the window's own call and feed, on distinct batches
    before = {n: p.detach().clone() for n, p in trainer.params().items()}
    prog = {"losses": []}
    for i in range(n_check):
        prog["losses"].append(step(i))
        if i == 0:
            prog["grad"] = norms(trainer.momentum())
    prog["update"] = norms({n: p.detach() - before[n] for n, p in trainer.params().items()})
    del before
    mark("checked steps")
    for i in range(n_check, n_check + tf["warmup_steps"]):
        step(i)
    setup_s = mark("warm-up")

    done = n_check + tf["warmup_steps"]
    first = done
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        step(done)
        done += 1
    sync(device)
    window_s = time.perf_counter() - start
    images = tf["batch"] * (done - first)
    img_s = images / window_s
    log(f"window: {done - first} steps in {window_s:.3f} s")
    result = {"metrics": {"setup_s": setup_s, "train_img_s": img_s}}
    if trace:
        it = iter(range(done, 1 << 30))
        result["traced"] = traced(cell, "train", lambda: step(next(it)), img_s, arch.flops_per_image(conf, True))
    result["device"] = device_info(device, cell.workload["chips"])
    del trainer, batches
    free(device)

    want = arch.reference_steps(conf, state, pool, seed, n_check, device)
    numbers = judge.training_numbers(prog, want)
    result.update(numbers=numbers, attempted=done - first, failed=0)
    return result


LOOPS = {"predict_batch": run_infer, "train_step": run_train}


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, device, t0: float) -> Dict:
    """The result line of one run."""
    cell = Cell(root, workload)
    res = cell.loop()(cell, seed, seconds, trace, device, t0)
    verdict = judge.verdict(res["numbers"], cell.limits)
    extra = {k: v for k, v in res["numbers"].items() if k not in verdict["checks"]}
    log(f"readings: {json.dumps(extra)}")
    for name, c in verdict["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    if trace:
        t = res["traced"]
        out = {"correct": verdict["correct"], "attempted": res["attempted"], "failed": res["failed"],
               "metrics": t["metrics"],
               "device": dict(res["device"], busy_s=t["busy_s"], window_s=t["window_s"]),
               "breakdown": t["breakdown"]}
    else:
        units = {m["name"]: m["unit"] for m in cell.metrics_of("end_to_end")}
        out = {"correct": verdict["correct"], "attempted": res["attempted"], "failed": res["failed"],
               "metrics": {k: {"value": v, "unit": units[k]} for k, v in res["metrics"].items() if k in units},
               "device": res["device"]}
    out["checks"] = verdict["checks"]
    return out

