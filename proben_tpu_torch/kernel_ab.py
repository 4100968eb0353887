"""A/B readings of the port's kernels across checkouts on one GPU.

    python -m proben_tpu_torch.kernel_ab image_io TREE [TREE ...]
    python -m proben_tpu_torch.kernel_ab roi_align TREE [TREE ...]
    python -m proben_tpu_torch.kernel_ab slice TREE [TREE ...]
    python -m proben_tpu_torch.kernel_ab epilogue TREE [TREE ...]
    python -m proben_tpu_torch.kernel_ab sass TREE_A TREE_B SOURCE KERNEL_A KERNEL_B

Each TREE is the root of a checkout (``.`` for this one).

``image_io`` times the compose + resize + pad kernel at the FLIR evaluation
shapes: 8 single-channel 512x640 thermal frames resized to 800x1000 in an
800x1024 canvas (BGR), and the same with 8 1600x1800 RGB frames beside them
(BGRTTT); and at the FLIR training shapes (no crop): 16 frames at the six
training sizes 640x800 .. 800x1000, every other one flipped, in the same
canvas (BGR train, BGRTTT train). ``roi_align`` times K2 (RoIAlign forward) and K3 (its backward) at
the FPN pooler's main-path shapes: four bf16 levels of an 800x1024 batch of
8 at C = 256, 8 x 1000 proposals for K2 and 8 x 512 RoIs for K3 (P = 7),
and, where the tree's kernels take P = 14, at the C4 pooler's (one 50 x 64
level at C = 1024, P = 14), all from one seed, so every tree pools the same
boxes; and the host time of one K2 and one K3 call at P = 7 ("host us":
10 calls between syncs, median of 20 groups), through the wrapper and,
where the tree's kernels are ``torch.library`` ops, through the op's CUDA
implementation called directly (the launch without the op's dispatch). ``slice`` times K1 through its wrapper at the BGR slice's shape (8
800x1024 bf16 images, C = 3) and the slice's img/s: ``chip_smoke.py``'s
calibrated R101-FPN (seed 0) through ``Predictor.infer``, 12 batches of 8
between CUDA events, three readings. ``epilogue`` times a bottleneck's
conv epilogue (affine + ReLU on the width maps, affine + identity residual
+ ReLU and affine + shortcut affine + ReLU on the block outputs) at the four
stage shapes of R101 on a batch of 16 800x1024 images, forward (no grad)
and backward (``autograd.grad`` through the call), as the plain composition
and, where the tree has it, through K4 (``ops/epilogue_cuda.py::
block_epilogue``). Each case cycles through copies of its inputs that
exceed the L2 cache three times, and its readings are device time: the
kernels' durations in a profile of 20 calls (host dispatch outlasts the
small cases' kernels, so CUDA events would time the host). With each case's
bytes (forward 4 or 6 an element, backward 8, 10 or 12), its count per
batch, the per-batch sums (the backward over res3-res5, which training at
FREEZE_AT 2 runs) and the host us of one res4 call.

Each tree is timed in a process of its own, which builds that
checkout's kernels, in the order given (for example parent, change, change,
parent). A run is three readings per case, each (``epilogue``'s aside) the
median of 5 groups of 10 back-to-back calls timed with CUDA events. Prints one line per tree and a
JSON object last. Each group's start event is queued behind one untimed
call, so a call's host time (the op's dispatch included) overlaps the
device work before it and the readings are device time while the host
keeps ahead.

``sass`` compiles ``csrc/SOURCE.cu`` of both trees for ``sm_90a`` and
compares, with ``cuobjdump -sass``, the kernel whose mangled name matches
the regular expression KERNEL_A in TREE_A with the one matching KERNEL_B in
TREE_B, instruction by instruction (addresses and symbol names left out).
Prints the counts and one JSON object.

Needs a CUDA device (``sass``: only nvcc and cuobjdump).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

_MS = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from proben_tpu_torch import _build

def ms(fn):
    for _ in range(2):
        fn()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()  # queued ahead of the start event: the first timed call's host time is hidden too
        a.record()
        for _ in range(10):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / 10)
    return float(np.median(times))

g = torch.Generator(device="cuda").manual_seed(0)
"""

_IMAGE_IO = _MS + r"""
from proben_tpu_torch.native import io
_build.build(["image_io"])
th = [torch.randint(0, 256, (512, 640, 1), generator=g, device="cuda", dtype=torch.uint8)
      for _ in range(8)]
rgb = [torch.randint(0, 256, (1600, 1800, 3), generator=g, device="cuda", dtype=torch.uint8)
       for _ in range(8)]
sizes, pad = [(800, 1000)] * 8, (800, 1024)
out = {}
for fmt, r in (("BGR", None), ("BGRTTT", rgb)):
    out[fmt] = [ms(lambda: io.compose_resize_pad(th, r, fmt, sizes, pad)) for _ in range(3)]
train_sizes = [(640 + 32 * (i % 6), 800 + 40 * (i % 6)) for i in range(16)]
flips = [i % 2 == 0 for i in range(16)]
for fmt, r in (("BGR", None), ("BGRTTT", rgb * 2)):
    out[f"{fmt} train"] = [ms(lambda: io.compose_resize_pad(th * 2, r, fmt, train_sizes, pad, flips))
                           for _ in range(3)]
print(json.dumps(out))
"""

_ROI_ALIGN = _MS + r"""
import time
from proben_tpu_torch.ops import roi_align_cuda as rc

def host_us(fn, n=10):
    # host time of one call: n calls between syncs (the queue never fills),
    # median of 20 groups
    for _ in range(2):
        fn()
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t) / n * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))

_build.build(["roi_align_fwd", "roi_align_bwd"])
levels = [torch.randn(8, 200 >> i, 256 >> i, 256, generator=g, device="cuda").bfloat16()
          for i in range(4)]
shapes = [tuple(f.shape) for f in levels]

def boxes(k):
    xy = torch.rand(8, k, 2, generator=g, device="cuda") * torch.tensor([960.0, 760.0], device="cuda")
    wh = 16 + torch.rand(8, k, 2, generator=g, device="cuda") ** 2 * 400
    return torch.cat([xy, (xy + wh).minimum(torch.tensor([1000.0, 800.0], device="cuda"))], -1)

fwd = rc.window_inputs(levels, boxes(1000), (4, 8, 16, 32))[:5]
bwd = rc.window_inputs(levels, boxes(512), (4, 8, 16, 32))[:5]
cot = (0.01 * torch.randn(8 * 512, 7, 7, 256, generator=g, device="cuda")).bfloat16()
out = {"K2": [ms(lambda: rc.roi_align_fwd(levels, *fwd, 1000)) for _ in range(3)],
       "K3": [ms(lambda: rc.roi_align_bwd(cot, shapes, *bwd, 512)) for _ in range(3)],
       "K2 host us": [host_us(lambda: rc.roi_align_fwd(levels, *fwd, 1000)) for _ in range(3)],
       "K3 host us": [host_us(lambda: rc.roi_align_bwd(cot, shapes, *bwd, 512)) for _ in range(3)]}
if hasattr(rc, "_roi_align_fwd_cuda"):  # the ops' CUDA implementations called directly
    flat = [d for s in shapes for d in s]
    out["K2 impl host us"] = [host_us(lambda: rc._roi_align_fwd_cuda(levels, *fwd, 1000)) for _ in range(3)]
    out["K3 impl host us"] = [host_us(lambda: rc._roi_align_bwd_cuda(cot, flat, *bwd, 512)) for _ in range(3)]
if getattr(rc, "MAX_P", 8) >= 14:  # the C4 pooler: one 50 x 64 level at C = 1024, P = 14
    res4 = [torch.randn(8, 50, 64, 1024, generator=g, device="cuda").bfloat16()]
    zero = lambda k: torch.zeros(8, k, dtype=torch.int32, device="cuda")
    pooler = dict(strides=(16,), output_size=14, min_level=0)
    fwd = rc.window_inputs(res4, boxes(1000), levels=zero(1000), **pooler)[:5]
    bwd = rc.window_inputs(res4, boxes(512), levels=zero(512), **pooler)[:5]
    cot = (0.01 * torch.randn(8 * 512, 14, 14, 1024, generator=g, device="cuda")).bfloat16()
    out["K2 P = 14"] = [ms(lambda: rc.roi_align_fwd(res4, *fwd, 1000)) for _ in range(3)]
    out["K3 P = 14"] = [ms(lambda: rc.roi_align_bwd(cot, [tuple(res4[0].shape)], *bwd, 512))
                        for _ in range(3)]
print(json.dumps(out))
"""

_SLICE = _MS + r"""
import chip_smoke as cs
from proben_tpu_torch.engine import Predictor
from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines
from proben_tpu_torch.ops import stem_cuda
_build.build(["stem", "roi_align_fwd"])
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
x = (torch.rand(8, 800, 1024, 3, generator=g, device="cuda") * 255).bfloat16()
w = (0.03 * torch.randn(7, 7, 3, 64, generator=g, device="cuda")).bfloat16()
scale, bias = torch.ones(64, device="cuda").bfloat16(), torch.zeros(64, device="cuda").bfloat16()
out = {"K1": [ms(lambda: stem_cuda.stem_pool(x, w, scale, bias)) for _ in range(3)]}
cfg = build_config(depth=101, input_format="BGR", num_classes=3, compute_dtype="bfloat16")
model = build_model(cfg, params=random_affines(init_rcnn(0, cfg), 0))
rng = np.random.RandomState(0)
images = [torch.from_numpy(a).cuda() for a in cs.structured_images(rng, 2, 8, 800, 1024, 3)]
sizes = torch.tensor([[800, 1000]] * 8, dtype=torch.int32, device="cuda")
cs.calibrate_rpn(model, images[0])
pred = Predictor(model, cfg)
cs.calibrate(model, pred, images[0], sizes)
rates = []
for _ in range(3):
    for i in range(2):
        pred.infer(images[i], sizes, sizes)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for i in range(12):
        pred.infer(images[i % 2], sizes, sizes)
    b.record()
    torch.cuda.synchronize()
    rates.append(8 * 12 / (a.elapsed_time(b) / 1e3))
out["slice img/s"] = rates
print(json.dumps(out))
"""

_EPILOGUE = _MS + r"""
import math, time
from pathlib import Path
BF = torch.bfloat16
k4 = (Path(sys.argv[1]) / "proben_tpu_torch" / "csrc" / "block_epilogue.cu").exists()
if k4:
    from proben_tpu_torch.ops import epilogue_cuda as ep
    _build.build(["block_epilogue"])

def plain(x, s, b, r=None, rs=None, rb=None):
    # the epilogue as models/resnet.py ran it before K4 (layers.affine, +, torch.relu)
    out = x * s.to(x.dtype).view(1, -1, 1, 1) + b.to(x.dtype).view(1, -1, 1, 1)
    if r is not None:
        if rs is not None:
            r = r * rs.to(r.dtype).view(1, -1, 1, 1) + rb.to(r.dtype).view(1, -1, 1, 1)
        out = out + r
    return torch.relu(out)

def device_ms(fn, n=20):
    # the device time of one call: the kernels' durations in a profile of n
    # calls (so host dispatch, which outlasts the small cases' kernels, is
    # left out), ms
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / n / 1e3

def host_us(fn, n=10):
    for _ in range(2):
        fn()
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t) / n * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))

def amap(n, c, h, w):  # channels_last bf16
    return torch.randn(n, h, w, c, generator=g, device="cuda").to(BF).permute(0, 3, 1, 2)

def case(kind, n, c, h, w):
    # copies whose inputs together exceed the 50 MB L2 three times, used in turn
    maps = 1 if kind == "relu" else 2
    copies = max(2, math.ceil(150e6 / (2 * n * c * h * w * maps)))
    out = []
    for _ in range(copies):
        args = [amap(n, c, h, w), 1 + 0.1 * torch.randn(c, generator=g, device="cuda"),
                0.1 * torch.randn(c, generator=g, device="cuda")]
        if kind != "relu":
            args.append(amap(n, c, h, w))
        if kind == "shortcut":
            args += [1 + 0.1 * torch.randn(c, generator=g, device="cuda"),
                     0.1 * torch.randn(c, generator=g, device="cuda")]
        out.append(args)
    return out

def cycle(items, fn):
    state = {"i": 0}
    def call():
        item = items[state["i"] % len(items)]
        state["i"] += 1
        return fn(item)
    return call

# per stage of R101 on a batch of 16 800x1024 images: width, map size, blocks
STAGES = (("res2", 64, 200, 256, 3), ("res3", 128, 100, 128, 4), ("res4", 256, 50, 64, 23),
          ("res5", 512, 25, 32, 3))
FWD_BYTES = {"relu": 4, "identity": 6, "shortcut": 6}
BWD_BYTES = {"relu": 8, "identity": 10, "shortcut": 12}
impls = {"plain": plain, **({"k4": ep.block_epilogue} if k4 else {})}
out = {"fwd": {}, "bwd": {}, "host_us": {}, "per_batch_ms": {}}
for stage, width, h, w, blocks in STAGES:
    for kind, c, count in (("relu", width, 2 * blocks), ("identity", 4 * width, blocks - 1),
                           ("shortcut", 4 * width, 1)):
        name = f"{stage} {kind} C={c}"
        items = case(kind, 16, c, h, w)
        numel = 16 * c * h * w
        rec_f = {"bytes": FWD_BYTES[kind] * numel, "count": count}
        rec_b = {"bytes": BWD_BYTES[kind] * numel, "count": count}
        for impl, fn in impls.items():
            with torch.no_grad():
                rec_f[impl] = [device_ms(cycle(items, lambda a: fn(*a))) for _ in range(3)]
            graphs = []
            for a in items:
                leaves = [t.clone().requires_grad_() for t in a]
                y = fn(*leaves)
                graphs.append((y, leaves, torch.randn_like(y)))
            grad = lambda gr: torch.autograd.grad(gr[0], gr[1], gr[2], retain_graph=True)
            rec_b[impl] = [device_ms(cycle(graphs, grad)) for _ in range(3)]
            del graphs
            if stage == "res4":
                with torch.no_grad():
                    out["host_us"][f"{name} {impl}"] = host_us(cycle(items, lambda a: fn(*a)))
        out["fwd"][name], out["bwd"][name] = rec_f, rec_b
        del items
        torch.cuda.empty_cache()
for d, trained in (("fwd", STAGES), ("bwd", STAGES[1:])):  # training freezes res2 (FREEZE_AT 2)
    stages = {s[0] for s in trained}
    rows = [r for k, r in out[d].items() if k.split()[0] in stages]
    out["per_batch_ms"][d] = {impl: sum(r["count"] * float(np.median(r[impl])) for r in rows)
                              for impl in impls}
    out["per_batch_ms"][d]["bound"] = sum(r["count"] * r["bytes"] for r in rows) / 3.35e12 * 1e3
print(json.dumps(out))
"""

TIMINGS = {"image_io": _IMAGE_IO, "roi_align": _ROI_ALIGN, "slice": _SLICE, "epilogue": _EPILOGUE}


def run_trees(trees, timing: str, key: str) -> int:
    """Run the ``timing`` script once per tree, each in a process of its own
    with the tree's root as its argument and working directory; print each
    tree's last output line (a JSON object) and ``{key: [...]}`` last."""
    runs = []
    for tree in trees:
        root = os.path.abspath(tree)
        res = subprocess.run([sys.executable, "-c", timing, root], cwd=root, capture_output=True,
                             text=True)
        if res.returncode:
            print(res.stderr, file=sys.stderr)
            return res.returncode
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        print(tree, ms, flush=True)
        runs.append({"tree": tree, "ms": ms})
    print(json.dumps({key: runs}), flush=True)
    return 0


def kernel_sass(tree: str, source: str, pattern: str, tmp: str):
    """The SASS instructions of the one kernel of ``tree``'s
    ``csrc/<source>.cu`` whose mangled name matches ``pattern``: (name,
    instructions without addresses, encodings or symbol names)."""
    from ._build import NVCC_FLAGS, nvcc

    cubin = os.path.join(tmp, f"{len(os.listdir(tmp))}.cubin")
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([nvcc(), *flags, "-cubin", "-o", cubin,
                    os.path.join(tree, "proben_tpu_torch", "csrc", f"{source}.cu")], check=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name:
            ins = re.sub(r"_Z\w+", "SYM", re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)).strip()
            if ins and not ins.startswith("/*"):
                funcs[name].append(ins)
    hits = [k for k in funcs if re.search(pattern, k)]
    if len(hits) != 1:
        raise SystemExit(f"{tree}: {len(hits)} kernels of {source} match {pattern!r}: {sorted(funcs)}")
    return hits[0], funcs[hits[0]]


def compare_sass(tree_a: str, tree_b: str, source: str, pattern_a: str, pattern_b: str) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        name_a, a = kernel_sass(tree_a, source, pattern_a, tmp)
        name_b, b = kernel_sass(tree_b, source, pattern_b, tmp)
    differ = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    print(f"{source}: {name_a} ({len(a)} instructions) vs {name_b} ({len(b)}): "
          f"{differ} differing", flush=True)
    print(json.dumps({"sass": {"source": source, "a": [tree_a, name_a, len(a)],
                               "b": [tree_b, name_b, len(b)], "identical": a == b,
                               "differing": differ}}), flush=True)
    return 0


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    if args and args[0] in TIMINGS and len(args) > 1:
        return run_trees(args[1:], TIMINGS[args[0]], f"{args[0]}_ab")
    if args and args[0] == "sass" and len(args) == 6:
        return compare_sass(*args[1:])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
