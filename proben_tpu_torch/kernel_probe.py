"""Where the time of kernels K1 (stem), K2 (RoIAlign forward) and K3
(RoIAlign backward) goes: build variants of ``csrc/stem.cu``,
``csrc/roi_align_fwd.cu`` and ``csrc/roi_align_bwd.cu`` by text substitution
(other tile shapes, or one phase taken out) and time each at the main
path's shapes on one GPU.

    python -m proben_tpu_torch.kernel_probe     # from the repository root

K1 runs on a random (8, 800, 1024, 3) bf16 batch; K2 on the calibrated R101's
main-path proposals, K3 on the 8 x 512 RoIs the training path samples for
bench.py's training batch with a seeded bf16 cotangent, both built with
``chip_smoke.py``'s helpers. K3's probes: other output tiles, RoIs per step
and CTAs per SM, the spans and lists passes alone,
spans + lists + stores with no RoI processed, without cotangent loads, without
the x pass, a per-CTA timeline, and a ``zero_()`` of the whole dF as the
write-rate yardstick; beside them, how often the tiling recomputes u (RoI rows times
the x tiles they cross, over RoI rows) and the longest tile list. Variants
that keep the function are held against the plain versions; the phase
probes are wrong by construction and only timed. Prints one line per
variant and a JSON object last. Needs a CUDA device and nvcc; exits
non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from . import _build
from .ops import roi_align_cuda, stem_cuda

# K1: other tile shapes need the generic assignment of m16-tile pairs to warps
_K1_PAIR = """    {
      const int mts[2] = {2 * warp, 2 * warp + 1};  // this warp's pair of m16 tiles
      conv_mtiles<CP, 2>(mts, patch_s, b_base, stem_s, sc_s, bi_s, s0, t0, Hs, Ws, lane);
    }
"""
_K1_GENERIC = """    for (int pr = warp; pr < M_TILES / 2; pr += WARPS) {
      const int mts[2] = {2 * pr, 2 * pr + 1};
      conv_mtiles<CP, 2>(mts, patch_s, b_base, stem_s, sc_s, bi_s, s0, t0, Hs, Ws, lane);
    }
    if (M_TILES % 2 && warp == 0) {
      const int mts[1] = {M_TILES - 1};
      conv_mtiles<CP, 1>(mts, patch_s, b_base, stem_s, sc_s, bi_s, s0, t0, Hs, Ws, lane);
    }
"""
_K1_ASSERT = 'static_assert(M_TILES == 2 * WARPS, "each warp takes one pair of m16 tiles");\n'
_K1_LOAD = "px[k] = load_pixel<CP>(x, n, in_r0 + ir, in_c0 + ic, H, W, C, it < ITEMS);"
_K1_POOL = "it < TILE_PH * TILE_PW * 8; it += THREADS)"


def _k1_tile(ph: int, pw: int, ctas_per_sm: int = 2):
    return [("constexpr int TILE_PH = 7; ", f"constexpr int TILE_PH = {ph}; "),
            ("constexpr int TILE_PW = 8; ", f"constexpr int TILE_PW = {pw}; "),
            ("__launch_bounds__(THREADS, 2)", f"__launch_bounds__(THREADS, {ctas_per_sm})"),
            (_K1_PAIR, _K1_GENERIC), (_K1_ASSERT, "")]


# (name, substitutions, keeps the function)
K1_VARIANTS = [
    ("7x8 tile, 2 CTAs/SM (shipped)", [], True),
    ("8x16 tile, 1 CTA/SM", _k1_tile(8, 16, 1), True),
    ("4x16 tile, 2 CTAs/SM", _k1_tile(4, 16), True),
    ("8x8 tile, 2 CTAs/SM", _k1_tile(8, 8), True),
    ("6x8 tile, 2 CTAs/SM", _k1_tile(6, 8), True),
    ("shipped without input loads", [(_K1_LOAD, _K1_LOAD.replace("it < ITEMS", "false"))], False),
    ("shipped without pooling", [(_K1_POOL, "it < 0; it += THREADS)")], False),
    ("shipped, MMA + epilogue only", [(_K1_LOAD, _K1_LOAD.replace("it < ITEMS", "false")),
                                      (_K1_POOL, "it < 0; it += THREADS)")], False),
]

_K2_LOAD = "if (row_ok && col_ok[u]) {"
_K2_XLOOP = "      for (int xb = xlo; xb <= xhi; xb += UX) {"
_K2_STORE = "if (q0 + q < P) store_vec<T, V>"
K2_VARIANTS = [
    ("shipped (UX = 2)", [], True),
    ("UX = 1", [("constexpr int UX = 2;", "constexpr int UX = 1;")], True),
    ("UX = 4", [("constexpr int UX = 2;", "constexpr int UX = 4;")], True),
    ("without feature loads", [(_K2_LOAD, "if (false) {")], False),
    ("setup + stores only", [(_K2_XLOOP, _K2_XLOOP.replace("xb <= xhi", "xb < 0"))], False),
    ("setup only", [(_K2_LOAD, "if (false) {"), (_K2_STORE, "if (q0 + q < 0) store_vec<T, V>")], False),
]


def build_variants(src: str, variants, tmp: str, tag: str):
    """Compile every variant of ``csrc/<src>.cu`` into ``tmp`` in parallel;
    returns {name: ctypes.CDLL}."""
    text = (_build.CSRC / f"{src}.cu").read_text()
    sources = []
    for name, subs, _ in variants:  # every pattern is checked before any build starts
        s = text
        for a, b in subs:
            if a not in s:
                raise RuntimeError(f"{src}: variant {name!r}: pattern not found: {a[:60]!r}")
            s = s.replace(a, b)
        sources.append(s)
    procs = []
    for i, ((name, _, _), s) in enumerate(zip(variants, sources)):
        cu, so = os.path.join(tmp, f"{tag}{i}.cu"), os.path.join(tmp, f"lib{tag}{i}.so")
        with open(cu, "w") as fh:
            fh.write(s)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, cu]
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} variant {name!r}:\n{log}")
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", log)})
        print(f"{src} [{name}]: registers per kernel {regs}", file=sys.stderr, flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def launches_ms(fn, n: int = 10, groups: int = 5) -> float:
    """Median over ``groups`` of the mean time of ``n`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def probe_k1(tmp: str):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (50 * torch.randn(8, 800, 1024, 3, generator=g, device="cuda")).bfloat16()
    w = (0.03 * torch.randn(7, 7, 3, 64, generator=g, device="cuda")).bfloat16()
    sc = (1 + 0.3 * torch.randn(64, generator=g, device="cuda")).bfloat16()
    bi = (0.3 * torch.randn(64, generator=g, device="cuda")).bfloat16()
    ref = stem_cuda.stem_pool_plain(x, w, sc, bi).float()
    wpk = stem_cuda.pack_stem_weights(w)
    out = torch.empty(ref.shape, dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    keeps = {name: keep for name, _, keep in K1_VARIANTS}
    for name, lib in build_variants("stem", K1_VARIANTS, tmp, "k1_").items():
        f = lib.stem_pool_bf16
        f.argtypes, f.restype = stem_cuda._SIG["stem_pool_bf16"], ctypes.c_int

        def call():
            _build.check(f(x.data_ptr(), wpk.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                           out.data_ptr(), 8, 800, 1024, 3, 400, 512, 200, 256, stream), name)

        call()
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        res[name] = {"ms": launches_ms(call), "max_abs_err": err, "keeps_function": keeps[name]}
        print(f"K1 {name}: {res[name]['ms']:.4f} ms, max|err| vs plain {err:.4g}", flush=True)
    return res


def calibrated_model():
    """The R101 of ``chip_smoke.py`` with its RPN and class head calibrated,
    and its first batch of structured images."""
    import chip_smoke as cs
    from .engine import Predictor
    from .models import build_config, build_model, init_rcnn, random_affines

    cfg = build_config(depth=101, input_format="BGR", num_classes=3, compute_dtype="bfloat16")
    model = build_model(cfg, params=random_affines(init_rcnn(0, cfg), 0))
    rng = np.random.RandomState(0)
    images = [torch.from_numpy(a).cuda() for a in cs.structured_images(rng, 2, cs.BATCH, cs.H, cs.W, 3)]
    sizes = torch.tensor([cs.TRUE_HW] * cs.BATCH, dtype=torch.int32, device="cuda")
    cs.calibrate_rpn(model, images[0])
    cs.calibrate(model, Predictor(model, cfg), images[0], sizes)
    return model, images[0], sizes


def probe_k2(tmp: str, model, image, sizes):
    import chip_smoke as cs
    from .models import rcnn

    cfg = model.cfg
    with torch.inference_mode():
        feats = rcnn.extract_features(model, cfg, rcnn.preprocess(cfg, image))
        boxes = rcnn.propose(model, cfg, feats, sizes)[0]
        levels = rcnn.roi_levels(feats)
    k = boxes.shape[1]
    lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(levels, boxes, **cfg.roi.pooler_args)
    r, c = wy.shape[0], levels[0].shape[-1]
    ref = roi_align_cuda.roi_align_fwd_plain(levels, lvl, y0, x0, wy, wx, k).float()
    out = torch.empty((r, 7, 7, c), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    # bytes the loads request (each warp reads its row's wy span at every
    # column of the wx union), against the distinct pixels the bound counts
    ny = (wy != 0).sum(dim=2).double()  # (R, P)
    ncol = (wx != 0).any(dim=1).sum(dim=1).double()  # (R,)
    esize = levels[0].element_size()
    res = {"zero_ of the output (write-rate yardstick)": {"ms": launches_ms(out.zero_)},
           "feature bytes": {"requested_mb": float((ncol[:, None] * ny).sum()) * c * esize / 1e6,
                             "distinct_mb": cs.needed_feature_bytes(levels, lvl, y0, x0, wy, wx, k) / 1e6}}
    print(f"K2 feature bytes: requested {res['feature bytes']['requested_mb']:.1f} MB, "
          f"distinct {res['feature bytes']['distinct_mb']:.1f} MB", flush=True)
    keeps = {name: keep for name, _, keep in K2_VARIANTS}
    for name, lib in build_variants("roi_align_fwd", K2_VARIANTS, tmp, "k2_").items():
        f = lib.roi_align_fwd_bf16
        f.argtypes, f.restype = roi_align_cuda._ARGS, ctypes.c_int

        def call():
            _build.check(f(*[t.data_ptr() for t in levels], *[t.shape[1] for t in levels],
                           *[t.shape[2] for t in levels], len(levels), c, k, lvl.data_ptr(),
                           y0.data_ptr(), x0.data_ptr(), wy.data_ptr(), wx.data_ptr(),
                           out.data_ptr(), r, 7, stream), name)

        call()
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        res[name] = {"ms": launches_ms(call), "max_abs_err": err, "keeps_function": keeps[name]}
        print(f"K2 {name}: {res[name]['ms']:.4f} ms, max|err| vs plain {err:.4g}", flush=True)
    print(f"K2 zero_ of the output (write-rate yardstick): "
          f"{res['zero_ of the output (write-rate yardstick)']['ms']:.4f} ms", flush=True)
    return res


_K3_TILE = ("constexpr int TILE_Y = 8;\nconstexpr int TILE_X = 16;\nconstexpr int CHUNK_BYTES = 128;")


def _k3_tile(ty: int, tx: int, chunk_bytes: int):
    return [(_K3_TILE, f"constexpr int TILE_Y = {ty};\nconstexpr int TILE_X = {tx};\n"
                       f"constexpr int CHUNK_BYTES = {chunk_bytes};")]


_K3_END = ("        if (gy < H) store_vec<T, V>(out + (static_cast<size_t>(gy) * W + gx) * C + c0 + cv * V, a);"
           "\n      }\n    }\n  }\n")
# K3 with a per-CTA timeline: start and end (globaltimer, ns), listed RoIs
# and SM of every tile CTA, read back through probe_timeline()
_K3_TIMELINE = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_timeline[4 * 65536];\n"),
    ("  const int tid = threadIdx.x;\n  const int chunk = blockIdx.x % chunks;",
     "  unsigned long long t_in;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_in));\n"
     "  int n_vis = 0;\n  const int tid = threadIdx.x;\n  const int chunk = blockIdx.x % chunks;"),
    ("    const int n = min(THREADS, n_t - base);\n",
     "    const int n = min(THREADS, n_t - base);\n    n_vis += n;\n"),
    (_K3_END, _K3_END +
     "  __syncthreads();\n  if (tid == 0 && blockIdx.x < 65536) {\n    unsigned long long t_out;\n"
     "    unsigned sm;\n    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_out));\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "    g_timeline[4 * blockIdx.x] = t_in;\n    g_timeline[4 * blockIdx.x + 1] = t_out;\n"
     "    g_timeline[4 * blockIdx.x + 2] = n_vis;\n    g_timeline[4 * blockIdx.x + 3] = sm;\n  }\n"),
    ("extern \"C\" int roi_align_bwd_f32(",
     "extern \"C\" int probe_timeline(void* dst, int n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_timeline, 32ull * n));\n}\n\n"
     "extern \"C\" int roi_align_bwd_f32("),
]


_K3_NO_G = ("const bool ok = c0 + v * V < C;", "const bool ok = false;")
_K3_NO_X = ("        } else if (y0 || y1) {", "        } else if (false) {")
_K3_NO_U = ("          if (nt < P * CC / 8) {", "          if (false) {")
_K3_NO_WT = ("      if (in) cp_async16(wt_s", "      if (false) cp_async16(wt_s")


_K3_FMA = [("constexpr bool MMA = sizeof(T) == 2 && V == 8;", "constexpr bool MMA = false;")]


def _k3_ctas(n: int):
    return [("constexpr int CTAS_PER_SM = 3;", f"constexpr int CTAS_PER_SM = {n};")]


def _k3_nb(n: int):
    return [("constexpr int NB = 2;", f"constexpr int NB = {n};")]


K3_VARIANTS = [
    ("8x16 tile, 64 bf16 channels, 2 RoIs per MMA, 3 CTAs/SM (shipped)", [], True),
    ("FMA route (no tensor cores)", _K3_FMA, True),
    ("4 CTAs/SM", _k3_ctas(4), True),
    ("2 CTAs/SM", _k3_ctas(2), True),
    ("FMA route, 3 RoIs per step", _K3_FMA + _k3_nb(3), True),
    ("spans and lists passes only", [("  constexpr int V = 16 / sizeof(T);\n  bool vec",
                          "  return 0;\n  constexpr int V = 16 / sizeof(T);\n  bool vec")], False),
    ("spans + lists + stores, no RoI processed", [("  const int n_t = tile_cnt[t];", "  const int n_t = 0;")],
     False),
    ("without cotangent loads", [_K3_NO_G], False),
    ("without the x pass", [_K3_NO_X], False),
    ("without the u product", [_K3_NO_U], False),
    ("without weight copies", [_K3_NO_WT], False),
    ("lists, steps and barriers only", [_K3_NO_U, _K3_NO_WT, _K3_NO_X, _K3_NO_G], False),
    ("shipped with a per-CTA timeline", _K3_TIMELINE, True),
]


def k3_timeline(lib, grid: int):
    """Read the timeline variant's per-CTA records after one launch:
    where the kernel's span goes (empty and listing CTAs, the cost per
    listed RoI, the last CTAs)."""
    buf = np.zeros((grid, 4), dtype=np.uint64)
    lib.probe_timeline.argtypes, lib.probe_timeline.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    _build.check(lib.probe_timeline(buf.ctypes.data, grid), "probe_timeline")
    t0 = buf[:, 0].min()
    start, end = (buf[:, 0] - t0).astype(np.float64) / 1e3, (buf[:, 1] - t0).astype(np.float64) / 1e3
    dur, vis = end - start, buf[:, 2].astype(np.float64)
    busy = vis > 0
    fit = np.polyfit(vis[busy], dur[busy], 1) if busy.sum() > 1 else [float("nan")] * 2
    last = np.argsort(end)[-5:]
    return {"span_us": float(end.max()), "ctas": grid, "listing_ctas": int(busy.sum()),
            "empty_cta_us_median": float(np.median(dur[~busy])) if (~busy).any() else None,
            "listing_cta_us_median": float(np.median(dur[busy])) if busy.any() else None,
            "us_per_listed_roi": float(fit[0]), "us_fixed": float(fit[1]),
            "last_start_us": float(start.max()), "max_visits": int(vis.max()),
            "last_ctas": [{"start_us": float(start[i]), "us": float(dur[i]), "visits": int(vis[i])}
                          for i in last],
            "sms": int(len(np.unique(buf[:, 3])))}


def k3_tiling_stats(shapes, lvl, y0, x0, wy, wx, k, tile=(8, 16)):
    """How the shipped tiling shares out the main path's RoIs: the u
    recompute multiplier (each RoI row is formed once per x tile its span
    crosses), the (RoI, tile) visits and the longest tile list."""
    rw = wy.bfloat16().float() != 0
    cw = wx.bfloat16().float() != 0
    rows, cols = rw.any(dim=1), cw.any(dim=1)  # (R, WIN)
    idx_y = torch.arange(rows.shape[1], device=wy.device)
    idx_x = torch.arange(cols.shape[1], device=wy.device)
    hs = torch.tensor([s[1] for s in shapes], device=wy.device)[lvl.long()]
    ws = torch.tensor([s[2] for s in shapes], device=wy.device)[lvl.long()]
    ylo = (y0 + torch.where(rows, idx_y, 10 ** 6).min(dim=1).values).clamp(min=0)
    yhi = torch.minimum(y0 + torch.where(rows, idx_y, -1).max(dim=1).values, hs - 1)
    xlo = (x0 + torch.where(cols, idx_x, 10 ** 6).min(dim=1).values).clamp(min=0)
    xhi = torch.minimum(x0 + torch.where(cols, idx_x, -1).max(dim=1).values, ws - 1)
    ok = (ylo <= yhi) & (xlo <= xhi)
    nrows = torch.where(ok, yhi - ylo + 1, 0).double()
    ytiles = torch.where(ok, yhi // tile[0] - ylo // tile[0] + 1, 0)
    xtiles = torch.where(ok, xhi // tile[1] - xlo // tile[1] + 1, 0)
    counts = {}
    spans = torch.stack([ylo, yhi, xlo, xhi, lvl.long()], 1)[ok].tolist()
    for r, (ya, yb, xa, xb, l) in zip(ok.nonzero().flatten().tolist(), spans):
        for ty in range(ya // tile[0], yb // tile[0] + 1):
            for tx in range(xa // tile[1], xb // tile[1] + 1):
                key = (r // k, l, ty, tx)
                counts[key] = counts.get(key, 0) + 1
    return {"u_recompute_multiplier": float((nrows * xtiles).sum() / nrows.sum()),
            "roi_tile_visits": int((ytiles * xtiles).sum()), "tiles_touched": len(counts),
            "longest_tile_list": max(counts.values(), default=0)}


def k3_grid(shapes, tile=(8, 16), chunk=64):
    """CTAs of the shipped tile kernel at bf16 on these level shapes."""
    tiles = sum(-(-s[1] // tile[0]) * -(-s[2] // tile[1]) for s in shapes)
    return shapes[0][0] * tiles * -(-shapes[0][3] // chunk)


def probe_k3(tmp: str, model):
    import chip_smoke as cs

    cfg = model.cfg
    batch = cs.train_batch()
    levels, boxes = cs.sampled_rois(model, batch)
    k = boxes.shape[1]
    lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(levels, boxes, **cfg.roi.pooler_args)
    shapes = [tuple(f.shape) for f in levels]
    r, c = wy.shape[0], shapes[0][-1]
    gen = torch.Generator(device="cuda").manual_seed(3)
    g = (0.01 * torch.randn(r, 7, 7, c, generator=gen, device="cuda")).bfloat16()
    ref = [t.float() for t in roi_align_cuda.roi_align_bwd_plain(g, shapes, lvl, y0, x0, wy, wx, k)]
    outs = [torch.empty(s, dtype=torch.bfloat16, device="cuda") for s in shapes]
    scratch = torch.empty(roi_align_cuda.bwd_scratch_words(r, shapes[0][0], shapes, 7),
                          dtype=torch.int32, device="cuda")
    flat = torch.empty(sum(t.numel() for t in outs), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    stats = k3_tiling_stats(shapes, lvl, y0, x0, wy, wx, k)
    res = {"zero_ of the dF (write-rate yardstick)": {"ms": launches_ms(flat.zero_),
                                                      "mbytes": flat.numel() * 2 / 1e6},
           "tiling": stats}
    print(f"K3 tiling: {stats}", flush=True)
    keeps = {name: keep for name, _, keep in K3_VARIANTS}
    for name, lib in build_variants("roi_align_bwd", K3_VARIANTS, tmp, "k3_").items():
        f = lib.roi_align_bwd_bf16
        f.argtypes, f.restype = roi_align_cuda._BWD_ARGS, ctypes.c_int

        def call():
            _build.check(f(g.data_ptr(), lvl.data_ptr(), y0.data_ptr(), x0.data_ptr(),
                           wy.data_ptr(), wx.data_ptr(), scratch.data_ptr(), scratch.numel(),
                           *[t.data_ptr() for t in outs], *[s[1] for s in shapes],
                           *[s[2] for s in shapes], len(shapes), shapes[0][0], c, k, r, 7,
                           stream), name)

        call()
        torch.cuda.synchronize()
        err = max(float((a.float() - b).abs().max()) for a, b in zip(outs, ref))
        res[name] = {"ms": launches_ms(call), "max_abs_err": err, "keeps_function": keeps[name]}
        print(f"K3 {name}: {res[name]['ms']:.4f} ms, max|err| vs plain {err:.4g}", flush=True)
        if hasattr(lib, "probe_timeline"):
            call()
            torch.cuda.synchronize()
            res[name]["timeline"] = k3_timeline(lib, k3_grid(shapes))
            print(f"K3 timeline: {res[name]['timeline']}", flush=True)
    print(f"K3 zero_ of the dF (write-rate yardstick, {flat.numel() * 2 / 1e6:.1f} MB): "
          f"{res['zero_ of the dF (write-rate yardstick)']['ms']:.4f} ms", flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    tmp = _build.BUILD_DIR / "probe"
    tmp.mkdir(parents=True, exist_ok=True)
    result = {"card": card, "k1": probe_k1(str(tmp))}
    model, image, sizes = calibrated_model()
    result["k2"] = probe_k2(str(tmp), model, image, sizes)
    result["k3"] = probe_k3(str(tmp), model)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
