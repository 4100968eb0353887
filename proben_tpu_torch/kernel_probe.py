"""Where the time of kernels K1 (stem) and K2 (RoIAlign forward) goes: build
variants of ``csrc/stem.cu`` and ``csrc/roi_align_fwd.cu`` by text
substitution (other tile shapes, or one phase taken out) and time each at
the main path's shapes on one GPU.

    python -m proben_tpu_torch.kernel_probe     # from the repository root

K1 runs on a random (8, 800, 1024, 3) bf16 batch; K2 on the calibrated R101's
main-path proposals, built with ``chip_smoke.py``'s helpers. Variants that
keep the function are held against the plain versions; the phase probes are
wrong by construction and only timed. Prints one line per variant and a JSON
object last. Needs a CUDA device and nvcc; exits non-zero without them.
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
_K2_XLOOP = "    for (int xb = xlo; xb <= xhi; xb += UX) {"
_K2_STORE = "if (q < P) store_vec<T, V>"
K2_VARIANTS = [
    ("shipped (UX = 2)", [], True),
    ("UX = 1", [("constexpr int UX = 2;", "constexpr int UX = 1;")], True),
    ("UX = 4", [("constexpr int UX = 2;", "constexpr int UX = 4;")], True),
    ("without feature loads", [(_K2_LOAD, "if (false) {")], False),
    ("setup + stores only", [(_K2_XLOOP, _K2_XLOOP.replace("xb <= xhi", "xb < 0"))], False),
    ("setup only", [(_K2_LOAD, "if (false) {"), (_K2_STORE, "if (q < 0) store_vec<T, V>")], False),
]


def build_variants(src: str, variants, tmp: str, tag: str):
    """Compile every variant of ``csrc/<src>.cu`` into ``tmp`` in parallel;
    returns {name: ctypes.CDLL}."""
    text = (_build.CSRC / f"{src}.cu").read_text()
    procs = []
    for i, (name, subs, _) in enumerate(variants):
        s = text
        for a, b in subs:
            if a not in s:
                raise RuntimeError(f"{src}: variant {name!r}: pattern not found: {a[:60]!r}")
            s = s.replace(a, b)
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


def probe_k2(tmp: str):
    import chip_smoke as cs
    from .engine import Predictor
    from .models import build_config, build_model, init_rcnn, random_affines, rcnn

    cfg = build_config(depth=101, input_format="BGR", num_classes=3, compute_dtype="bfloat16")
    model = build_model(cfg, params=random_affines(init_rcnn(0, cfg), 0))
    rng = np.random.RandomState(0)
    images = [torch.from_numpy(a).cuda() for a in cs.structured_images(rng, 2, cs.BATCH, cs.H, cs.W, 3)]
    sizes = torch.tensor([cs.TRUE_HW] * cs.BATCH, dtype=torch.int32, device="cuda")
    cs.calibrate_rpn(model, images[0])
    cs.calibrate(model, Predictor(model, cfg), images[0], sizes)
    with torch.inference_mode():
        feats = rcnn.extract_features(model, cfg, rcnn.preprocess(cfg, images[0]))
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
    result = {"card": card, "k1": probe_k1(str(tmp)), "k2": probe_k2(str(tmp))}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
