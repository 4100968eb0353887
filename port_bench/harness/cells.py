"""One run of one cell: set-up, the measured window, the traced iterations
(``--trace 1``) and the check against the reference, for the two loops a
traffic file can name: ``predict_batch`` (inference, closed loop, one
caller) and ``train_step`` (training)."""

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

import numpy as np
import torch

from . import counts, frames, judge, weights
from .trace import OpArgs, Trace, profile
from reference import model as ref

CHECK_CHUNK = 4  # images per reference call


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
        self.ref_cfg = ref.Config(self.conf["model"], self.conf["solver"])

    def metrics_of(self, kind: str) -> List[Mapping]:
        """The end-to-end or per-layer entries this cell reports."""
        name = self.workload["name"]
        return [m for m in self.bench[kind] if name in m.get("workloads", [name])]

    def reader(self, metric: str) -> Callable:
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"port_bench_metric_{len(sys.modules)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Layers:
    """What the per-layer readers read: the traced iterations' trace, each
    custom op call's least time and device time, the window's rate and the
    model FLOPs of one image."""

    def __init__(self, kind: str, trace: Trace, iters: int, op_calls: List, img_s: float,
                 flops_per_image: float):
        self.kind, self.trace, self.iters = kind, trace, iters
        self.op_calls, self.img_s, self.flops_per_image = op_calls, img_s, flops_per_image

    def roofline_pct(self, op: str) -> Optional[float]:
        least = sum(l for n, l, _ in self.op_calls if n == op)
        spent = sum(d for n, _, d in self.op_calls if n == op)
        return 100.0 * least / spent if spent > 0 and least > 0 else None


def traced(cell: Cell, kind: str, step: Callable, img_s: float, flops: float, ops) -> Dict:
    """The per-layer metrics and the breakdown from the traced iterations;
    ``ops``: the program's custom ops whose calls are timed and counted."""
    tr = cell.traffic["trace"]
    scratch = cell.root / "build" / "port_bench"
    scratch.mkdir(parents=True, exist_ok=True)
    trace = Trace(profile(step, tr["iterations"], str(scratch / "trace.json")))
    rec = OpArgs(ops)
    captured = Trace(profile(step, tr["captured_iterations"], str(scratch / "trace_ops.json"), rec))
    op_calls = []
    for name in sorted(set(n for n, _, _ in rec.calls)):
        calls = [(a, o) for n, a, o in rec.calls if n == name]
        spent = captured.op_kernel_seconds(name)
        if len(spent) != len(calls):
            raise RuntimeError(f"trace: {len(calls)} calls of {name} recorded, {len(spent)} traced")
        op_calls += [(name, counts.kernel_least_seconds(name, a, o), d) for (a, o), d in zip(calls, spent)]
    layers = Layers(kind, trace, tr["iterations"], op_calls, img_s, flops)
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


def make_weights(cell: Cell, seed: int, batch: Mapping, device) -> Dict[str, np.ndarray]:
    """The run's detectron2 state dict (on the host), drawn from the seed
    and fitted by the reference to the first frames of ``batch``. A mix
    that names a ``model_seed`` serves one model on every seed: the weights
    are drawn from that seed and fitted to frames drawn from it."""
    conf, tf = cell.conf, cell.traffic
    if "model_seed" in tf:
        seed = tf["model_seed"]
        batch = frames.inference_pool(seed, dict(tf, pool_batches=1), conf["input"],
                                      6 if cell.ref_cfg.dual else 3, device)[0]
    sd = weights.make_state_dict(conf["model"], conf["weights"], seed, device)
    k = conf["weights"]["calibration_images"]
    weights.calibrate(conf["model"], conf["weights"], sd, batch["image"][:k],
                      [tuple(hw) for hw in batch["image_size"][:k].tolist()])
    return weights.to_numpy(sd)


# ---------------------------------------------------------------------------
# inference: Predictor.predict_batch, one caller, closed loop
# ---------------------------------------------------------------------------


def reference_detections(cell: Cell, sd: Mapping, images: List[torch.Tensor], device,
                         precision: str = "fp32") -> List[Dict[str, np.ndarray]]:
    """The reference's detections of ``images`` (H, W, C) in the original
    frame, as ``predict_batch`` rescales and clips them."""
    net = ref.Net(cell.ref_cfg, ref.params_from_d2(cell.ref_cfg, sd, device), precision)
    inp = cell.conf["input"]
    hw = frames.resized_hw(inp["frame_hw"], inp["min_size_test"], inp["max_size_test"])
    oh, ow = inp["frame_hw"]
    sx, sy = ow / hw[1], oh / hw[0]
    out = []
    for s in range(0, len(images), CHECK_CHUNK):
        chunk = torch.stack(images[s:s + CHECK_CHUNK]).to(device)
        with tf32_off():
            dets = net.detect(chunk, [hw] * chunk.shape[0])
        for d in dets:
            b = d["boxes"] * torch.tensor([sx, sy, sx, sy], device=device)
            b = ref.bx.clip(b, float(oh), float(ow))
            out.append({"boxes": b.cpu().numpy(), "scores": d["scores"].cpu().numpy(),
                        "classes": d["classes"].cpu().numpy()})
    del net
    free(device)
    return out


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
    from . import program

    tf, conf = cell.traffic, cell.conf
    mark = Marks(t0, device)
    cfg = program.read_config(str(cell.config_file.parent), conf)
    pool = frames.inference_pool(seed, tf, conf["input"], 6 if cell.ref_cfg.dual else 3, device)
    mark("frames")
    sd = make_weights(cell, seed, pool[0], device)
    mark("weights")
    model, mcfg = program.build(cfg, sd, device)
    pred = program.predictor(model, mcfg, device)
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
        flops = counts.flops_per_image(conf["model"], conf["input"]["pad_shape"],
                                       conf["model"]["rpn"]["post_nms_topk_test"], False)
        it = iter(range(1 << 30))
        result["traced"] = traced(cell, "infer", lambda: pred.predict_batch(pool[next(it) % len(pool)]),
                                  img_s, flops, program.CUSTOM_OPS)
    result["device"] = device_info(device, cell.workload["chips"])
    del pred, model
    free(device)

    picks = pick_images(seed, served, tf["check_images"])
    imgs = [pool[b % len(pool)]["image"][r] for b, r in picks]
    got = [served[b][r] for b, r in picks]
    want = reference_detections(cell, sd, imgs, device)
    numbers = judge.detection_numbers(got, want)
    result.update(numbers=numbers, attempted=images, failed=0)
    return result


# ---------------------------------------------------------------------------
# training: make_train_step's train_step, batches on the card
# ---------------------------------------------------------------------------


def norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([tensors[n].detach().float().norm() for n in names]).tolist()
    return dict(zip(names, vals))


def reference_steps(cell: Cell, sd: Mapping, pool: List[Mapping], seed: int, steps: int, device,
                    precision: str = "fp32", batch_filter: Optional[Callable] = None) -> Dict:
    """The reference's first ``steps`` steps from the same weights on the
    same batches, with the same sampling priorities: each step's total
    loss, the momentum after step 1 and the plain gradient of step 1, and
    the parameters' change after the last step, as norms per leaf."""
    cfg = cell.ref_cfg
    params = ref.params_from_d2(cfg, sd, device)
    train = [n for n in params if ref.trainable(cfg, n)]
    for n in train:
        params[n].requires_grad_(True)
    start = {n: params[n].detach().clone() for n in train}
    net = ref.Net(cfg, params, precision)
    canvas = cell.conf["input"]["pad_shape"]
    n_anchor = ref.num_anchors(cfg, canvas)
    post = cfg["rpn"]["post_nms_topk_train"]
    momentum: Dict[str, torch.Tensor] = {}
    out = {"losses": []}
    keys = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg")
    for step in range(steps):
        b = pool[step]
        images, sizes, (gb, gc, gv) = b["image"], b["image_size"].tolist(), b["gt"]
        n = images.shape[0]
        gen = torch.Generator(device=device).manual_seed(ref.step_seed(seed, step))
        rpn_rand = torch.rand((n, n_anchor), generator=gen, device=device)
        roi_rand = torch.rand((n, post + gb.shape[1]), generator=gen, device=device)
        rows = list(range(n)) if batch_filter is None else batch_filter(n)
        grads = {k: torch.zeros_like(params[k]) for k in train}
        total = dict.fromkeys(keys, 0.0)
        for s in range(0, len(rows), CHECK_CHUNK):
            r = rows[s:s + CHECK_CHUNK]
            with tf32_off():
                losses = net.losses(images[r], [sizes[i] for i in r], gb[r], gc[r], gv[r], rpn_rand[r],
                                    roi_rand[r], len(rows))
                loss = sum(losses.values())
                got = torch.autograd.grad(loss, [params[k] for k in train], allow_unused=True)
            for k, g in zip(train, got):
                if g is not None:
                    grads[k] += g
            for k in keys:
                total[k] += float(losses[k].detach())
        total["total_loss"] = sum(total[k] for k in keys)
        out["losses"].append(total)
        if step == 0:
            out["grad_raw"] = norms(grads)
        ref.sgd_step(cfg, params, grads, momentum, step)
        if step == 0:
            out["grad"] = norms(momentum)
    out["update"] = norms({k: params[k].detach() - start[k] for k in train})
    del net, params, momentum, start
    free(device)
    return out


def run_train(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Dict:
    from . import program

    tf, conf = cell.traffic, cell.conf
    mark = Marks(t0, device)
    cfg = program.read_config(str(cell.config_file.parent), conf)
    pool = frames.training_pool(seed, tf, conf["input"], 6 if cell.ref_cfg.dual else 3, device)
    mark("frames")
    sd = make_weights(cell, seed, pool[0], device)
    mark("weights")
    model, mcfg = program.build(cfg, sd, device)
    trainer = program.Trainer(cfg, model, mcfg, seed)
    mark("program")
    batches = [program.train_batch(b) for b in pool]
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
        flops = counts.flops_per_image(conf["model"], conf["input"]["pad_shape"],
                                       conf["model"]["roi"]["batch_size_per_image"], True)
        it = iter(range(done, 1 << 30))
        result["traced"] = traced(cell, "train", lambda: step(next(it)), img_s, flops, program.CUSTOM_OPS)
    result["device"] = device_info(device, cell.workload["chips"])
    del trainer, model, batches
    free(device)

    want = reference_steps(cell, sd, pool, seed, n_check, device)
    numbers = judge.training_numbers(prog, want)
    result.update(numbers=numbers, attempted=done - first, failed=0)
    return result


LOOPS = {"predict_batch": run_infer, "train_step": run_train}


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, device, t0: float) -> Dict:
    """The result line of one run (without the checks against JAX)."""
    cell = Cell(root, workload)
    res = LOOPS[cell.traffic["loop"]](cell, seed, seconds, trace, device, t0)
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

