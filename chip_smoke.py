#!/usr/bin/env python3
"""Chip smoke test of ``proben_tpu_torch`` on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # from the repository root; needs one card
    python3 chip_smoke.py --profile  # also per-stage breakdowns and profiler tables
                                     # (single-modality and middle fusion)
    python3 chip_smoke.py --kaist-divergence  # only the KAIST trainer probe
                                              # (``kaist_divergence_probe``, ~3 min)
    python3 chip_smoke.py --ddp-float32  # only the DDP and zoo phases, the DDP
                                         # runs in float32 (the rounding witness)

Phases, each raising on a miss (exit code != 0, no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the main paths (K1 stem, K2 RoIAlign forward, K3
   RoIAlign backward, K4 bottleneck epilogue, K5 NMS, ``image_io``: nvJPEG
   decode and the compose + resize + pad kernel) from ``proben_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, one process per source, in parallel;
3. K1 and K2 against their plain PyTorch versions on the card, at the
   inference path's shapes and on hazard inputs, with the tolerance stated
   at each check; times (CUDA events) and bounds; K4 forward and backward
   against the plain composition and its backward at R101's stage shapes
   on 16 800x1024 images and at C4's res5 on 8 x 1000 RoIs
   (``epilogue_phase``: maps bit for bit, parameter sums within one bf16
   ulp, two backward calls bit for bit), device times and bounds; K5
   (``nms_phase``) at the cells' three NMS shapes (RPN inference (16, 5,
   1000), the box head (16, 3000) with class offsets, RPN training (16, 5,
   2000)) against the dense route on the card and the CPU route, bit for
   bit, device ms of both routes and the bound;
4. inference slice: random-init R101-FPN (random affines, so every residual
   branch is live; RPN and class head calibrated) through
   ``Predictor.predict_batch`` at batch 8, 800x1024 (true size 800x1000),
   bf16 -- every launch counter set to 0 just before and read just after --
   the same batch with K4 off (detections bit for bit), then the same model
   with the plain versions forced (K4 off), and in f32 as the
   bf16-rounding control, detections and FPN maps compared (tolerances in
   ``slice_phase``), and pipelined img/s;
5. K3 against its plain version at the training path's shapes (the FPN maps
   of the model, the 8 x 512 RoIs ``label_and_sample_proposals`` samples
   for bench.py's training batch, a seeded bf16 cotangent), then with
   hazard boxes mixed in, in bf16 and f32 (``check_bwd``), and two K3
   calls bitwise equal on each;
6. training slice: ``make_train_step`` on bench.py's training batch (100 gt
   boxes per image, FREEZE_AT 2, the FLIR solver), the same model updated
   in place: K3 as the only difference (same forward, K3 or its plain
   version in the backward: bit-identical losses, gradients per module
   group within the bound in ``train_phase``), one step with every launch
   counter read around it (K1, K2 and K3 once each), train img/s with K3
   and with the plain backward, finite losses on every step, frozen
   parameters unchanged, every trainable tensor moved;
7. early fusion (BGRT): a calibrated R101 with a 4-channel stem through
   ``Predictor`` (K1 at C = 4, K2 at C = 256), held to the plain path as in
   phase 4;
8. middle fusion (BGRTTT, ``faster_rcnn_R_101_FLIR_middle_fusion.yaml``):
   two R101-FPNs, FREEZE_AT 3. Inference as in phase 4 (K1 twice and K2
   once per batch; each stream's FPN maps compared); K2 and K3 at C = 512
   on the model's own concatenated maps and RoIs (phases 3 and 5's checks,
   times and bounds); training as in phase 6 (K1 twice, K2 and K3 once per
   step; both backbones' frozen parameters unchanged);
9. ProbEn late fusion: two calibrated R101 BGR detectors with the variance
   head, their padded detections fused on the card by every (score, box)
   method against the port's numpy reference, with TF32 off and on;
10. the FLIR evaluation entry point (``flir_phase``): a synthetic FLIR val
   tree of 32 pairs (thermal 640x512 single-component, RGB 1800x1600
   colour 4:2:0) encoded with nvJPEG into a temporary directory; the
   ``image_io`` kernel against its plain version for BGR, BGRT and BGRTTT
   on the same decoded pixels, and nvJPEG's decode against the encoded
   source (and cv2 where installed); ``save_predictions`` and
   ``evaluate_map`` for thermal_only and middle_fusion from
   ``faster_rcnn_R_101_FLIR.yaml`` and the middle-fusion YAML (R101, bf16,
   batch 8), the app's detections against ``Predictor.predict_batch`` on
   the same mapped batch, launches counted over the app's run;
   ``run_proben`` over the two saved JSONs; the ground truth as
   detections scoring AP 100; eval img/s end to end and model-only;
11. KAIST evaluation from detectron2 checkpoints (``kaist_phase``): a
   synthetic KAIST test tree of 32 frames (visible and lwir 640x512 colour
   JPEGs from nvJPEG, half in the day sets 06-08 and half in the night
   sets 09-11, the annotation JSON and the split file) in a temporary
   directory; ``image_io`` at scale 1 (KAIST's equal frame sizes) as the
   identity; for thermal_only, rgb_only and middle_fusion
   (``build_kaist_cfg``: R101, 1 class, the variance head) a calibrated
   model written as a detectron2 ``.pth`` and ``.pkl``, loaded back by
   ``load_params`` (equal to each other bit for bit, to the source to 1e-6
   relative), ``predict_split`` at batch 8 (det txt and variance npz;
   launches counted; the app's detections against
   ``Predictor.predict_batch`` on the same mapped batch; the txt read back
   equal to the results), LAMR all/day/night; the ground truth as
   detections scoring LAMR 0; ``run_kaist_proben`` over the three; a
   ``CheckpointManager`` best-model round trip (equal tensors, identical
   detections); eval img/s end to end (median of 3 warm runs over the 32
   frames), model only, ``load_params`` and checkpoint save/restore ms;
12. the trainer (``trainer_phase``): a synthetic FLIR tree of 64 train
   pairs (the first 32 also the val split); the train mapper on the card
   for BGR and BGRTTT (one batch of 16 at ``MIN_SIZE_TRAIN``'s random
   sizes, flipped and unflipped images; one ``image_io`` launch, bit for
   bit against its plain version, GT equal to the CPU mapper's; the
   kernel with flips timed); ``TrainLoader`` with 4 workers against the
   plain version while the consumer's stream is busy;
   ``train_flir("thermal_only")`` from ``faster_rcnn_R_101_FLIR.yaml``
   (R101, bf16, batch 16, weights from a detectron2 ``.pth`` of random
   affines) for 12 steps with keep-best every 6 (the best checkpoint's
   detections equal the live model's) and a checkpoint every 5, then a
   resume at ``latest + 1`` with the checkpointed state bit for bit;
   ``train_flir("middle_fusion")`` and ``train_kaist("thermal_only")``
   (float32 as shipped, ``FREEZE_MODULES``: only the FPN and the RPN
   move) for 12 steps each. In each run (every launch counter set to 0
   just before it): K1-K3 counted around one step, the run's ``image_io``
   launches equal to the batches the trainer's loader mapped plus the
   evaluations' batches, frozen tensors unchanged and every trainable one
   moved, train img/s end to end (median of the last 10 steps), peak
   memory; after it, on one more batch of 16 from the trainer's loader
   and the trainer's model, K1 (each stream), K2 and K3 against their
   plain versions on that step's inputs, K3 as the only difference in
   its losses and gradients, and a bare ``train_step`` img/s;
13. the other detector heads (``heads_phase``), R101, bf16, batch 8,
   800x1024, random weights from a seed with random affines, calibrated:
   C4 (``models/c4.py``) inference, K1 once and K2 at P = 14 once per batch
   (1000 proposals per image on the res4 map, C = 1024), held to the plain
   path as in phase 4's check (3), K2 at P = 14 against its plain version on
   those proposals (and hazard boxes, bf16 and f32), one training step
   (forward + backward: K1, K2 and K3 at P = 14 once each), K3 at P = 14
   against its plain version on its 8 x 512 sampled RoIs, deterministic;
   Cascade (``models/cascade.py``) on an R101-FPN: inference (K2 three
   times per batch) held to the plain path, one training step (K2 six
   times, K3 three times), K2 and K3 against their plain versions on the
   last stage's boxes and sampled RoIs; ProposalNetwork inference (K1
   once); ``DetectionTTA`` with ``rescore=True`` on one 800x1000 image at
   scales 400-800 with flips (one ``image_io`` launch, K1 and K2 twice),
   its 10 augmentations from ``image_io`` bit for bit against the plain
   version, K1 on that batch of 10 and K2 on its proposals and on the
   rescoring pass's given boxes against their plain versions; RetinaNet
   inference and one training step (K1 once each). Every path's launches
   counted from 0 around it; stage times (the pooler's weights, K2 and
   the out-of-window fallback apart, with the RoIs out of window, per
   C4 and per Cascade stage), img/s and step times (CUDA events over 15
   calls);
14. the other datasets (``datasets_phase``; cv2 and Pillow required): a
   synthetic Pascal VOC 2007 split (500x375 JPEGs, XML, ``difficult``), an
   LVIS v1 split (1203 categories, federated fields) over COCO-sized JPEGs
   and a Cityscapes val split (2048x1024 PNGs, ``gtFine`` rectangle
   polygons), 16 images each, registered by ``register_all_builtin``;
   Cityscapes' PNGs decoded on the host by ``decode_host`` and composed
   by ``image_io`` in one launch per batch, equal to the plain version;
   each split through ``DefaultTrainer.test`` (R101-FPN, bf16, batch 1,
   the dataset's opts from detectron2's public configs: 20 classes; 1203
   classes, score threshold 1e-4, 300 detections; 8 classes at
   1024x2048) with launches counted (``image_io``, K1, K2 once per
   image), K1 and K2 held against their plain versions on the split's
   first canvas and its proposals, the detections held to the plain
   path's under ``slice_phase``'s limits, and the headline AP of the
   kernel run at least the plain run's less ``AP_TOLERANCE``, both scored
   against the plain f32 run's detections; the ground truth as detections
   at AP 100 (VOC under both metrics); four ``DefaultTrainer`` steps on
   ``voc_2007_trainval`` watched as the trainer phase's runs (K1, K2, K3
   once per step, ``image_io`` once per mapped batch, finite losses; K1-K3
   held on one more batch of 16 at 800x1344); eval img/s and load /
   infer / process / evaluate seconds per split;
15. the rest of the library surface (``surface_phase``): a synthetic FLIR
   tree of 32 train pairs; the train mapper with ``INPUT.CROP`` (BGR and
   BGRTTT, a batch of 16: one ``image_io`` launch, the crop windows, sizes
   and flips equal to ``TrainAugment``'s replayed draws, the canvas equal
   to the plain version bit for bit, the GT to the CPU mapper's; the
   kernel with crops timed); ``train_flir("thermal_only")`` with
   ``INPUT.CROP.ENABLED`` for 4 steps (K1-K3 once per step, ``image_io``
   once per mapped batch, the trainer's first batch equal to the plain
   version of its replayed windows); ``paste_masks_in_image`` on the card
   against the CPU; ``flop_count`` of R101-FPN inference on one 800x1024
   image through the kernels' ops and through the plain versions' ops
   (equal but for each path's RoIAlign share on its own proposals);
   ``apps/flir.py draw`` on 4 val
   images (K1 and K2 once per image, both overlays written for each);
16. the user commands of ``apps/`` (``tools_phase``): a synthetic FLIR
   tree of 32 train pairs; ``plain_train_net`` from
   ``faster_rcnn_R_101_FLIR.yaml`` (R101-FPN, bf16, batch 16, detectron2
   weights of random affines) for 20 iterations with a checkpoint every
   10 (launches counted from 0 around the command: K1-K3 once per step,
   ``image_io`` once per mapped batch; ``metrics.json``'s line finite, two
   checkpoints; K1-K3 held against their plain versions on the loop's
   next batch); ``benchmark`` eval at batch 8 (12 iterations), train at 16
   (8) and data at 16 (6), launches counted around each, img/s beside the
   card; ``visualize_data`` and ``visualize_json_results`` on 4 val images
   each (``image_io`` once per image); one ``convert_torchvision`` round
   trip of an R50;
17. export (``export_phase``, run right after phase 4 on its calibrated
   model): ``export_model`` of ``rcnn_inference`` at batch 8, saved and
   loaded with ``load_exported``; the graph's ``proben.stem_pool`` and
   ``proben.roi_align_fwd`` nodes, K1 and K2 once per call of the loaded
   program, its detections equal eager's bit for bit, img/s of both;
18. data-parallel training (``ddp_phase``): ``faster_rcnn_R_101_FLIR.yaml``
   at ``IMS_PER_BATCH`` 16 on a synthetic 16-pair tree, one process, then
   2 gloo ranks sharing the card (8 images each), 3 steps: losses per step,
   the parameters' update against the one process's, the ranks' parameters
   bit for bit, K1-K3 once per step per rank and held against their plain
   versions on rank 0's next batch of 8, ms per step and peak memory per
   rank (NCCL across cards is not exercised);
19. the model zoo (``zoo_phase``): ``model_zoo.get(..., trained=True)``
   from a ``PROBEN_ZOO_DIR`` holding the same ``.pkl`` equals the model
   ``DefaultTrainer`` loaded from it in phase 18, tensor for tensor;
20. one JSON line per kernel, one for each slice and fusion mode, one for
   the FLIR and one for the KAIST evaluation, one for the trainer, one for
   the other heads, one for the other datasets, one for the surface phase,
   one for the user commands, one each for export, DDP and the zoo,
   one listing every kernel (launches per path, the C = 512, C = 4 and
   C = 6 readings, K2 and K3 at P = 14 / C = 1024 and on Cascade's last
   stage, ``image_io`` with flips and with crops at the training shapes
   and on Cityscapes' PNGs); the last line is
   ``{"ok": true, "device": {...}}``.

K4's counts (its launches, 3 a bottleneck block in each backbone forward
and 3 a trainable block in each backward, and ``epilogue.plain``, the
epilogues of float32 paths) and K5's (``k5.launches``, one a ``nms_mask``
call: the RPN's and the box head's in inference, the RPN's in training)
are read on every path whose launches are counted; a path that misses them
does not stop the run, which prints every other line, then a
``count_misses`` line and fails.

Exits non-zero without printing a result when no CUDA device is present or
when run from a directory that holds this file and nothing else of the repo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: dense peaks and HBM rate (700 W)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12

BATCH, H, W = 8, 800, 1024
TRUE_HW = (800, 1000)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Time of one call of ``fn()`` in ms: ``reps`` calls back to back in 5
    groups, CUDA events around each group, the median of the groups' means.
    Back to back, the host time of one call overlaps the device work of the
    one before, so a short kernel is not charged its wrapper's Python; each
    group's start event is queued behind one untimed call, so the first
    timed call's host time overlaps device work too (unless the host takes
    longer per call than the device)."""
    for _ in range(warmup):
        fn()
    n = max(1, reps // 5)
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |v| (8 significant bits), doubled so a
    value at the edge of a binade is covered."""
    a = v.abs().float().clamp(min=2.0 ** -126)
    return 2.0 * torch.exp2(torch.floor(torch.log2(a)) - 7.0)


def structured_images(rng, n, batch, h, w, c):
    """Background gradient + pasted box-like objects (bench.py's recipe)."""
    imgs = []
    for _ in range(n):
        im = np.tile(np.linspace(60, 120, w, dtype=np.float32)[None, None, :, None], (batch, h, 1, c))
        im += rng.randn(batch, h, w, c).astype(np.float32) * 8
        for b in range(batch):
            for _ in range(12):
                x, y = rng.randint(0, w - 80), rng.randint(0, h - 120)
                bw, bh = rng.randint(24, 80), rng.randint(40, 120)
                im[b, y:y + bh, x:x + bw] = rng.uniform(130, 240)
        imgs.append(np.clip(im, 0, 255))
    return imgs


# ---------------------------------------------------------------------------
# K1: fused stem
# ---------------------------------------------------------------------------


def check_stem(x, w, scale, bias):
    """K1 against its plain version on the same inputs. Tolerance: both
    accumulate the conv in f32 in different orders, so the bf16-rounded conv
    output may differ by one bf16 ulp; the bound propagates that ulp through
    the bf16 affine (|scale| * ulp(conv) + ulp(product) + ulp(sum)) and
    through ReLU and the max-pool, which do not enlarge differences."""
    from proben_tpu_torch.ops import stem_cuda

    got = stem_cuda.stem_pool(x, w, scale, bias)
    ref = stem_cuda.stem_pool_plain(x, w, scale, bias)
    torch.cuda.synchronize()
    conv = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=2, padding=3)
    sc = scale.view(1, -1, 1, 1)
    prod = conv * sc
    h = prod + bias.view(1, -1, 1, 1)
    bound = sc.abs().float() * bf16_ulp(conv) + bf16_ulp(prod) + bf16_ulp(h)
    bound = F.max_pool2d(bound, 3, 2, 1).permute(0, 2, 3, 1)
    if got.shape != ref.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"stem: shape {tuple(got.shape)} vs {tuple(ref.shape)} or non-finite")
    diff = (got.float() - ref.float()).abs()
    bad = int((diff > bound).sum())
    frac = float((diff > 0).float().mean())
    log(f"K1 {tuple(x.shape)}: max_abs_err {float(diff.max()):.4g}, "
        f"{100 * frac:.3f}% of outputs differ, {bad} beyond the ulp bound")
    if bad:
        raise AssertionError(f"stem kernel disagrees with its plain version: {bad} outputs")
    return float(diff.max())


def stem_phase(model):
    from proben_tpu_torch.ops import stem_cuda

    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    results = {}
    # main path: the model's stem weights on normalized structured images
    rng = np.random.RandomState(5)
    img = torch.from_numpy(structured_images(rng, 1, BATCH, H, W, 3)[0]).to(dev)
    mean = torch.tensor(model.cfg.pixel_mean, device=dev)
    x = (img - mean).to(torch.bfloat16).contiguous()
    st = model.backbone.stem
    w = st.conv1.weight.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
    # the model's random (non-identity) affine exercises the bf16 product/sum rounding
    scale, bias = st.norm1.scale.to(torch.bfloat16), st.norm1.bias.to(torch.bfloat16)
    err = check_stem(x, w, scale, bias)
    # BGRT early-fusion width at a small shape
    x4 = (50 * torch.randn(1, 32, 256, 4, generator=gen, device=dev)).to(torch.bfloat16)
    w4 = (0.03 * torch.randn(7, 7, 4, 64, generator=gen, device=dev)).to(torch.bfloat16)
    err4 = check_stem(x4, w4, scale, bias)

    ms = cuda_ms(lambda: stem_cuda.stem_pool(x, w, scale, bias), 30)
    plain_ms = cuda_ms(lambda: stem_cuda.stem_pool_plain(x, w, scale, bias), 10)
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    sc, bi = scale.view(1, -1, 1, 1), bias.view(1, -1, 1, 1)
    library_ms = cuda_ms(
        lambda: F.max_pool2d(torch.relu(F.conv2d(xc, wc, stride=2, padding=3) * sc + bi), 3, 2, 1), 10)
    n, hh, ww, c = x.shape
    hs, ws = (hh - 1) // 2 + 1, (ww - 1) // 2 + 1
    flops = 2.0 * n * hs * ws * 64 * 49 * c
    hp, wp = stem_cuda.stem_out_hw(hh, ww)
    nbytes = 2.0 * (x.numel() + w.numel() + 128 + n * hp * wp * 64)
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_S * 1e3
    results.update(
        name="stem_pool", route="cuda", source="proben_tpu_torch/csrc/stem.cu",
        replaces="proben_tpu/ops/stem_pallas.py:312", max_abs_err=max(err, err4), ms=ms,
        plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=library_ms,
        gflop=flops / 1e9, mbytes=nbytes / 1e6,
    )
    log(f"K1 timing: kernel {ms:.4g} ms, plain {plain_ms:.4g} ms, library {library_ms:.4g} ms, "
        f"bound {results['bound_ms']:.4g} ms ({results['bound_by']}), "
        f"{ms / results['bound_ms']:.1f}x bound")
    return results


# ---------------------------------------------------------------------------
# K4: the bottleneck epilogue, forward and backward
# ---------------------------------------------------------------------------

# R101's stages on the cells' batch (16 images on the 800x1024 canvas):
# name, width, map height and width, blocks
K4_STAGES = (("res2", 64, 200, 256, 3), ("res3", 128, 100, 128, 4), ("res4", 256, 50, 64, 23),
             ("res5", 512, 25, 32, 3))
K4_FWD_BYTES = {"relu": 4, "identity": 6, "shortcut": 6}  # per element: maps read and written
K4_BWD_BYTES = {"relu": 8, "identity": 10, "shortcut": 12}


def device_ms(fn, n=10):
    """Device time of one call of ``fn()`` in ms: the durations of the
    device work of ``n`` calls in a profile, after two untimed calls (a
    small map's kernels are shorter than the host's dispatch of a call, so
    CUDA events around back-to-back calls would time the host). A profile
    that comes back without device events is taken again, twice at most."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / n / 1e3
    raise RuntimeError("device_ms: three profiles recorded no device time")


def epilogue_inputs(gen, kind, n, c, h, w):
    """One case's inputs: bf16 channels_last maps (x, the residual or the
    shortcut conv's output) and f32 (C,) parameters around a trained
    FrozenBN's, then a seeded cotangent."""
    def amap():
        return (2 * torch.randn(n, h, w, c, generator=gen, device="cuda")).to(torch.bfloat16).permute(0, 3, 1, 2)

    def params():
        return (1 + 0.5 * torch.randn(c, generator=gen, device="cuda"),
                0.5 * torch.randn(c, generator=gen, device="cuda"))

    args = [amap(), *params()]
    if kind != "relu":
        args.append(amap())
    if kind == "shortcut":
        args += list(params())
    return args + [None] * (6 - len(args)), amap()


def check_epilogue(gen, kind, n, c, h, w, label):
    """K4 against the plain composition on one case: the forward's map and
    the backward's map gradients bit for bit (int16 views), the parameter
    sums within one bf16 ulp of the larger of the two (K4 adds in another
    order), two backward calls bit for bit. Then device ms of K4 and of
    the plain versions, each over copies of the inputs that together pass
    the 50 MB L2 three times, used in turn. A dict of the readings."""
    import math

    from proben_tpu_torch.ops import epilogue_cuda as ep

    args, g = epilogue_inputs(gen, kind, n, c, h, w)
    x, s, b, r, rs, rb = args
    if not ep.kernel_takes(*args):
        raise AssertionError(f"K4 {label}: the kernel does not take the stage's maps")
    bits = lambda t: t.contiguous().view(torch.int16)  # noqa: E731
    y, want = ep.block_epilogue(*args), ep.block_epilogue_plain(*args)
    if not torch.equal(bits(y), bits(want)):
        raise AssertionError(f"K4 {label}: the forward differs from the plain composition's bits")
    shortcut = r if kind == "shortcut" else None
    bwd_args = (g, y, x, s, shortcut, rs, kind != "relu")
    got = torch.ops.proben.block_epilogue_bwd(*bwd_args)
    again = torch.ops.proben.block_epilogue_bwd(*bwd_args)
    plain = ep.block_epilogue_bwd_plain(*bwd_args)
    sums = {1, 2, 4, 5}  # gscale, gbias and the shortcut's two: the rest are maps
    ulps = 0.0
    for i, (a, a2, p) in enumerate(zip(got, again, plain)):
        same = torch.equal(bits(a), bits(a2)) if a.dtype == torch.bfloat16 else torch.equal(a, a2)
        if not same:
            raise AssertionError(f"K4 {label}: two backward calls differ (output {i})")
        if i not in sums:
            if not torch.equal(bits(a), bits(p)):
                raise AssertionError(f"K4 {label}: backward output {i} differs from the plain backward's bits")
            continue
        ulp = torch.ldexp(torch.ones_like(p), torch.frexp(torch.maximum(a.abs(), p.abs())).exponent - 8)
        ulps = max(ulps, float(((a - p).abs() / ulp).max()))
    if ulps > 1.0:
        raise AssertionError(f"K4 {label}: a parameter sum is {ulps:.3g} bf16 ulps off the plain backward's")
    del y, want, got, again, plain

    copies = max(1, math.ceil(150e6 / (x.numel() * 2 * (1 if kind == "relu" else 2))))
    cases = [(args, g)] + [epilogue_inputs(gen, kind, n, c, h, w) for _ in range(copies - 1)]
    ys = [ep.block_epilogue(*a) for a, _ in cases]
    turn = {"i": 0}

    def cycled(fn):
        def call():
            i = turn["i"] = (turn["i"] + 1) % len(cases)
            return fn(i)
        return call

    def bwd(i):
        a, gg = cases[i]
        return torch.ops.proben.block_epilogue_bwd(gg, ys[i], a[0], a[1], a[3] if kind == "shortcut" else None,
                                                   a[4], kind != "relu")

    def bwd_plain(i):
        a, gg = cases[i]
        return ep.block_epilogue_bwd_plain(gg, ys[i], a[0], a[1], a[3] if kind == "shortcut" else None,
                                           a[4], kind != "relu")

    with torch.no_grad():
        out = dict(ms=device_ms(cycled(lambda i: ep.block_epilogue(*cases[i][0]))),
                   plain_ms=device_ms(cycled(lambda i: ep.block_epilogue_plain(*cases[i][0]))),
                   bwd_ms=device_ms(cycled(bwd)), bwd_plain_ms=device_ms(cycled(bwd_plain)))
    numel = x.numel()
    out.update(numel=numel, sum_err_ulp=ulps, bound_ms=K4_FWD_BYTES[kind] * numel / HBM_BYTES_S * 1e3,
               bwd_bound_ms=K4_BWD_BYTES[kind] * numel / HBM_BYTES_S * 1e3)
    del cases, ys
    torch.cuda.empty_cache()
    return out


def epilogue_phase(c4_rois):
    """K4 at R101's stage shapes on the cells' batch (each stage's width
    maps, identity and shortcut block outputs) and at C4's res5 on
    ``c4_rois`` RoIs of 7x7 (``check_epilogue``), then per batch: a
    forward's 99 epilogues and the backward's 90 over res3-res5 (training
    at FREEZE_AT 2), K4's device ms against the plain versions' and the
    bytes bound (3.35 TB/s)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases, fwd, bwd = {}, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0), dict(
        ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0)
    for stage, width, h, w, blocks in K4_STAGES:
        for kind, c, count in (("relu", width, 2 * blocks), ("identity", 4 * width, blocks - 1),
                               ("shortcut", 4 * width, 1)):
            label = f"{stage} {kind} C={c}"
            r = cases[label] = dict(check_epilogue(gen, kind, 16, c, h, w, label), count=count)
            fwd["ms"] += count * r["ms"]
            fwd["plain_ms"] += count * r["plain_ms"]
            fwd["bound_ms"] += count * r["bound_ms"]
            fwd["bytes"] += count * K4_FWD_BYTES[kind] * r["numel"]
            if stage != "res2":  # FREEZE_AT 2 runs res2 without grad
                bwd["ms"] += count * r["bwd_ms"]
                bwd["plain_ms"] += count * r["bwd_plain_ms"]
                bwd["bound_ms"] += count * r["bwd_bound_ms"]
                bwd["bytes"] += count * K4_BWD_BYTES[kind] * r["numel"]
            log(f"K4 {label} (x{count} a batch): {r['ms']:.4g} ms ({r['bound_ms'] / r['ms'] * 100:.1f}% of "
                f"the bytes bound), plain {r['plain_ms']:.4g}; backward {r['bwd_ms']:.4g} "
                f"({r['bwd_bound_ms'] / r['bwd_ms'] * 100:.1f}%), plain {r['bwd_plain_ms']:.4g}; "
                f"sums within {r['sum_err_ulp']:.3g} bf16 ulp")
    c4 = {}
    for kind, c in (("relu", 512), ("identity", 2048), ("shortcut", 2048)):
        label = f"C4 res5 {kind} C={c}"
        c4[label] = check_epilogue(gen, kind, c4_rois, c, 7, 7, label)
        log(f"K4 {label} on {c4_rois} RoIs: {c4[label]['ms']:.4g} ms, plain {c4[label]['plain_ms']:.4g}")
    log(f"K4 per batch of 16 800x1024 images: forward {fwd['ms']:.4g} ms (plain {fwd['plain_ms']:.4g}, "
        f"bound {fwd['bound_ms']:.4g} ms for {fwd['bytes'] / 1e9:.2f} GB); backward over res3-res5 "
        f"{bwd['ms']:.4g} ms (plain {bwd['plain_ms']:.4g}, bound {bwd['bound_ms']:.4g} ms for "
        f"{bwd['bytes'] / 1e9:.2f} GB); maps bit for bit, sums within one bf16 ulp")
    return dict(name="block_epilogue", route="cuda", source="proben_tpu_torch/csrc/block_epilogue.cu",
                replaces="models/resnet.py's affine, residual add and ReLUs (XLA fuses them in JAX)",
                max_abs_err=0.0, ms=fwd["ms"], plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
                bound_by="bytes", library_ms=None, gflop=0.0, mbytes=fwd["bytes"] / 1e6,
                deterministic=True, backward={k: (v / 1e6 if k == "bytes" else v) for k, v in bwd.items()},
                sum_err_ulp=max(r["sum_err_ulp"] for r in list(cases.values()) + list(c4.values())),
                per_case={k: {kk: r[kk] for kk in ("ms", "plain_ms", "bound_ms", "bwd_ms", "bwd_plain_ms",
                                                   "bwd_bound_ms", "count")} for k, r in cases.items()},
                c4_res5={k: {kk: r[kk] for kk in ("ms", "plain_ms", "bound_ms", "bwd_ms", "bwd_plain_ms")}
                         for k, r in c4.items()})


# ---------------------------------------------------------------------------
# K5: greedy NMS as a bitmask and a block sweep
# ---------------------------------------------------------------------------

# the cells' NMS calls: (label, shape, class count for the coordinate offsets, threshold)
NMS_SHAPES = (("rpn_infer", (16, 5, 1000), 0, 0.7), ("box_head", (16, 3000), 3, 0.5),
              ("rpn_train", (16, 5, 2000), 0, 0.7))
NMS_FLOPS_PER_PAIR = 10  # min, max and a difference per axis, the product, union's add and sub, the division


def nms_phase():
    """K5 at the cells' three NMS shapes (RPN inference, the box head with
    class offsets, RPN training) on clustered candidates: its keep mask
    against the dense route on the card (``nms_keep_plain``) and the CPU
    route, bit for bit, two calls bitwise equal, one ``k5.launches`` a call;
    device ms of the op on sorted boxes and of the whole ``nms_mask`` call
    (sort, gather, scatter) for both routes; the bound: the IoUs of the
    valid pairs (``NMS_FLOPS_PER_PAIR`` each at the f32 peak) or the bytes
    of boxes, flags and keep mask, whichever is larger."""
    from unittest import mock

    from proben_tpu_torch.ops import nms
    from proben_tpu_torch.utils import tracing

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from nms_cases import cell_problems

    cases = {}
    for label, shape, classes, t in NMS_SHAPES:
        boxes, scores, valid, ids = cell_problems(shape, seed=sum(shape), classes=classes)
        b, s, v = (torch.from_numpy(a).cuda() for a in (boxes, scores, valid))
        if ids is not None:  # batched_nms_mask's coordinate offsets
            b = b + torch.from_numpy(ids).cuda().to(torch.float32)[..., None] * 8193.0

        def call(plain=False):
            with mock.patch.object(nms, "nms_keep", nms.nms_keep_plain) if plain else contextlib.nullcontext():
                return nms.nms_mask(b, s, v, t)

        before = tracing.counters().get("k5.launches", 0)
        got = call()
        torch.cuda.synchronize()
        if tracing.counters().get("k5.launches", 0) != before + 1:
            raise AssertionError(f"K5 {label}: not one launch a call")
        want = call(plain=True)
        cpu = nms.nms_mask(b.cpu(), s.cpu(), v.cpu(), t)
        if not (torch.equal(got, call()) and torch.equal(got, want) and torch.equal(got.cpu(), cpu)):
            raise AssertionError(f"K5 {label}: the keep mask differs from the dense route's or between calls")
        order = torch.sort(torch.where(v, s, -1e10), dim=-1, descending=True, stable=True)[1]
        sb = torch.gather(b, -2, order[..., None].expand(order.shape + (4,))).contiguous()
        sv = torch.gather(v, -1, order)
        iters = tracing.counters().get("nms.iters", 0)
        nms.nms_keep_plain(sb, sv, t)
        iters = tracing.counters().get("nms.iters", 0) - iters
        nv = v.reshape(-1, shape[-1]).sum(-1).double()
        pairs = float((nv * (nv - 1) / 2).sum())
        mbytes = v.numel() * (16 + 1 + 1) / 1e6
        bound_ms = max(pairs * NMS_FLOPS_PER_PAIR / PEAK_F32, mbytes * 1e6 / HBM_BYTES_S) * 1e3
        r = cases[label] = dict(
            shape=list(shape), threshold=t, kept=int(got.sum()), valid=int(v.sum()), fixpoint_iters=iters,
            ms=cuda_ms(lambda: nms.nms_keep(sb, sv, t), 50), plain_ms=cuda_ms(lambda: nms.nms_keep_plain(sb, sv, t), 5),
            call_ms=cuda_ms(call, 50), plain_call_ms=cuda_ms(lambda: call(plain=True), 5), bound_ms=bound_ms,
            bound_by="operations" if pairs * NMS_FLOPS_PER_PAIR / PEAK_F32 > mbytes * 1e6 / HBM_BYTES_S else "bytes",
            gflop=pairs * NMS_FLOPS_PER_PAIR / 1e9, mbytes=mbytes,
            mask_mb=v.numel() * -(-shape[-1] // 64) * 8 / 1e6)
        log(f"K5 {label} {shape}: {r['ms']:.4g} ms (bound {bound_ms:.4g} ms by {r['bound_by']}), dense route "
            f"{r['plain_ms']:.4g} ms ({iters} fixpoint iterations); nms_mask {r['call_ms']:.4g} ms, dense "
            f"{r['plain_call_ms']:.4g}; kept {r['kept']} of {r['valid']} valid; bit for bit")
        del b, s, v, sb, sv, got, want
        torch.cuda.empty_cache()
    head = cases["box_head"]
    return dict(name="nms", route="cuda", source="proben_tpu_torch/csrc/nms.cu",
                replaces="ops/nms.py's dense IoU matrices and host-checked fixpoint (the JAX package's MXU design)",
                max_abs_err=0.0, ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=None, gflop=head["gflop"], mbytes=head["mbytes"],
                deterministic=True, per_case=cases)


# ---------------------------------------------------------------------------
# K2: windowed multi-level RoIAlign forward
# ---------------------------------------------------------------------------


def hazard_boxes(n: int, gen) -> torch.Tensor:
    """Degenerate, NaN/Inf, edge-of-map and elongated (out-of-window) boxes."""
    fixed = torch.tensor([
        [0.0, 0.0, 0.0, 0.0],            # empty
        [10.0, 10.0, 10.5, 200.0],       # sliver
        [float("nan")] * 4,
        [float("inf")] * 4,
        [-float("inf")] * 4,
        [100.0, float("nan"), 200.0, 150.0],
        [990.0, 790.0, 1000.0, 800.0],   # bottom-right corner
        [0.0, 0.0, 6.0, 9.0],            # top-left corner
        [-50.0, -40.0, 30.0, 20.0],      # partly outside the image
        [950.0, 300.0, 1100.0, 900.0],   # beyond the true and padded size
        [5.0, 300.0, 995.0, 340.0],      # 25:1, out of window
        [480.0, 2.0, 500.0, 798.0],      # 1:40, out of window
        [0.0, 0.0, 1000.0, 800.0],       # whole image
    ], device="cuda")
    reps = -(-n // fixed.shape[0])
    out = fixed.repeat(reps, 1)[:n]
    jitter = torch.rand(out.shape, generator=gen, device="cuda") * 0.3
    return out + jitter


def needed_feature_bytes(features, lvl_idx, y0, x0, wy, wx, k):
    """Bytes of the distinct feature pixels under nonzero weights (what this
    run's data needs the kernel to read)."""
    rows = (wy != 0).any(dim=1)  # (R, WIN_Y)
    cols = (wx != 0).any(dim=1)  # (R, WIN_X)
    total = 0
    img = torch.arange(lvl_idx.shape[0], device=lvl_idx.device) // k
    for li, f in enumerate(features):
        b, hl, wl, c = f.shape
        sel = (lvl_idx == li).nonzero().flatten()
        if sel.numel() == 0:
            continue
        mask = torch.zeros(b * hl * wl, dtype=torch.bool, device=f.device)
        for s in range(0, sel.numel(), 1024):
            r = sel[s:s + 1024]
            yy = y0[r, None].long() + torch.arange(rows.shape[1], device=f.device)
            xx = x0[r, None].long() + torch.arange(cols.shape[1], device=f.device)
            need = rows[r][:, :, None] & cols[r][:, None, :]
            need &= (yy < hl)[:, :, None] & (xx < wl)[:, None, :]
            flat = (img[r, None, None] * hl + yy[:, :, None]) * wl + xx[:, None, :]
            mask[flat[need]] = True
        total += int(mask.sum()) * c * f.element_size()
    return total


def check_roi(features, lvl_idx, y0, x0, wy, wx, k, label):
    """K2 against its plain version on identical inputs. Tolerance: both sum
    the same exact f32 products in different orders; every output is a
    weighted average (each wy/wx row sums to <= 1), so the f32 results differ
    by at most ~(WIN_Y + WIN_X) * 2^-24 * max|F| (allowed: 1e-5 * max|F|),
    and a bf16 result may in addition round to the neighbouring value (one
    bf16 ulp). NaN rows (from NaN boxes) must be NaN in both."""
    from proben_tpu_torch.ops import roi_align_cuda

    got = roi_align_cuda.roi_align_fwd(features, lvl_idx, y0, x0, wy, wx, k)
    ref = roi_align_cuda.roi_align_fwd_plain(features, lvl_idx, y0, x0, wy, wx, k)
    torch.cuda.synchronize()
    g, r = got.float(), ref.float()
    nan_g, nan_r = torch.isnan(g), torch.isnan(r)
    if not torch.equal(nan_g, nan_r):
        raise AssertionError(f"K2 {label}: NaN pattern differs ({int(nan_g.sum())} vs {int(nan_r.sum())})")
    fmax = max(float(f.float().abs().max()) for f in features)
    diff = torch.where(nan_r, 0.0, (g - r).abs())
    bound = 1e-5 * fmax + (bf16_ulp(torch.where(nan_r, 0.0, r)) if got.dtype == torch.bfloat16 else 0.0)
    bad = int((diff > bound).sum())
    log(f"K2 {label}: max_abs_err {float(diff.max()):.4g} (max|F| {fmax:.4g}), "
        f"{int(nan_r.any(dim=(1, 2, 3)).sum())} NaN rows, {bad} beyond tolerance")
    if bad:
        raise AssertionError(f"K2 {label}: {bad} outputs beyond tolerance")
    return float(diff.max())


def k2_reading(levels, boxes, pooler, label, seed=2):
    """K2 on a path's own pooling inputs (``levels`` (B, H, W, C) NHWC, ``boxes``
    (B, K, 4), ``pooler``: ``window_inputs``'s keywords): held against its
    plain version, then with 64 hazard boxes mixed in (bf16 and f32); its
    time, the plain version's and the bound from this run's inputs. Returns
    (the reading, the hazard boxes)."""
    from proben_tpu_torch.ops import roi_align_cuda

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, k, _ = boxes.shape

    def inputs(bx):
        return roi_align_cuda.window_inputs(levels, bx, **pooler)

    lvl, y0, x0, wy, wx, oow = inputs(boxes)
    p, c = wy.shape[1], levels[0].shape[-1]
    err = check_roi(levels, lvl, y0, x0, wy, wx, k, f"{label} bf16")
    log(f"K2 {label}: P = {p}, C = {c}, {int(oow.sum())} out-of-window RoIs of {b * k}; level "
        f"histogram {torch.bincount(lvl.long(), minlength=len(levels)).tolist()}")
    ms = cuda_ms(lambda: roi_align_cuda.roi_align_fwd(levels, lvl, y0, x0, wy, wx, k), 30)
    plain_ms = cuda_ms(lambda: roi_align_cuda.roi_align_fwd_plain(levels, lvl, y0, x0, wy, wx, k), 5)
    nbytes = (b * k * p * p * c * levels[0].element_size()
              + wy.numel() * 4 + wx.numel() * 4 + 3 * 4 * b * k
              + needed_feature_bytes(levels, lvl, y0, x0, wy, wx, k))
    # multiply-adds the data needs per channel: the y pass over nonzero wy
    # taps at every used x column, the x pass over nonzero wx taps per row p
    ny = (wy != 0).sum(dim=(1, 2)).double()
    ncol = (wx != 0).any(dim=1).sum(dim=1).double()
    nx = (wx != 0).sum(dim=(1, 2)).double()
    flops = 2.0 * c * float((ncol * ny + p * nx).sum())
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_S * 1e3

    # hazard boxes mixed into the path's boxes, bf16 and f32 features
    hz = boxes.clone()
    hz[:, -64:] = hazard_boxes(64, gen)
    lvl_h, y0_h, x0_h, wy_h, wx_h, _ = inputs(hz)
    err_h = check_roi(levels, lvl_h, y0_h, x0_h, wy_h, wx_h, k, f"{label} with hazard boxes bf16")
    levels32 = [f.float() for f in levels]
    err32 = check_roi(levels32, lvl_h, y0_h, x0_h, wy_h, wx_h, k, f"{label} with hazard boxes f32")
    log(f"K2 timing ({label}): kernel {ms:.4g} ms, plain {plain_ms:.4g} ms, bound "
        f"{max(t_ops, t_bytes):.4g} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
        f"{ms / max(t_ops, t_bytes):.1f}x bound; errors {err:.3g}/{err_h:.3g}/{err32:.3g}")
    return dict(
        max_abs_err=max(err, err_h), ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes", gflop=flops / 1e9,
        mbytes=nbytes / 1e6, max_abs_err_f32=err32, p=p, c=c, rois=b * k,
        out_of_window=int(oow.sum()),
    ), hz


def roi_phase(model, images, sizes):
    from proben_tpu_torch.models import rcnn

    cfg = model.cfg
    with torch.inference_mode():
        feats = rcnn.extract_features(model, cfg, rcnn.preprocess(cfg, images))
        boxes, _, _ = rcnn.propose(model, cfg, feats, sizes)
        levels = rcnn.roi_levels(feats)
    b, k, _ = boxes.shape
    # main path: the run's calibrated proposals
    reading, hz = k2_reading(levels, boxes, cfg.roi.pooler_args, "main-path proposals")
    # the whole path incl. the out-of-window fallback must stay finite on the hazards
    out = rcnn.pool_proposals(cfg, feats, hz)
    finite_rows = torch.isfinite(out.float()).reshape(b, k, -1).all(-1)
    nan_box = ~torch.isfinite(hz).all(-1)
    if not bool((finite_rows | nan_box).all()):
        raise AssertionError("K2: non-finite pooled rows for finite boxes")
    return dict(
        name="roi_align_fwd", route="cuda", source="proben_tpu_torch/csrc/roi_align_fwd.cu",
        replaces="proben_tpu/ops/roi_align_pallas.py:532", library_ms=None, **reading)


# ---------------------------------------------------------------------------
# K3: windowed multi-level RoIAlign backward
# ---------------------------------------------------------------------------


def fused(image, channels):
    """A 3-channel image batch widened to ``channels``: BGRT adds the mean
    of the three as the thermal channel; BGRTTT adds the reversed channels
    as the thermal stream (bench.py's middle-fusion stage)."""
    if channels == 3:
        return image
    if channels == 4:
        return np.concatenate([image, image.mean(-1, keepdims=True)], -1)
    return np.concatenate([image, image[..., ::-1]], -1)


def train_batch(channels=3):
    """bench.py --train's batch: 100 gt boxes per image drawn first, then
    the structured images, from ``np.random.RandomState(0)`` (widened by
    ``fused``); true size 800x1000 on the 800x1024 canvas."""
    from proben_tpu_torch.structures import GroundTruth

    rng = np.random.RandomState(0)
    g = 100
    xy = rng.rand(BATCH, g, 2) * (min(H, W) - 140)
    wh = rng.rand(BATCH, g, 2) * 100 + 24
    image = structured_images(rng, 1, BATCH, H, W, 3)[0]
    classes = rng.randint(0, 3, (BATCH, g)).astype(np.int32)
    gt = GroundTruth(torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)),
                     torch.from_numpy(classes), torch.ones(BATCH, g, dtype=torch.bool))
    return {"image": torch.from_numpy(np.ascontiguousarray(fused(image, channels))).cuda(),
            "image_size": torch.tensor([TRUE_HW] * BATCH, dtype=torch.int32, device="cuda"),
            "gt": gt.to("cuda")}


def hazard_windows(shapes, boxes, lvl_idx, y0, x0, k):
    """Per level, a (B, H, W) mask of the windows of RoIs with a
    non-finite box: the only places a NaN may reach."""
    from proben_tpu_torch.ops.roi_align import WIN_X, WIN_Y

    masks = [torch.zeros(s[:3], dtype=torch.bool, device="cuda") for s in shapes]
    for r in (~torch.isfinite(boxes).all(-1)).nonzero().flatten().tolist():
        l, oy, ox = int(lvl_idx[r]), int(y0[r]), int(x0[r])
        masks[l][r // k, oy:oy + WIN_Y, ox:ox + WIN_X] = True
    return masks


def check_bwd(g, shapes, lvl_idx, y0, x0, wy, wx, k, label, hazards=None):
    """K3 against its plain version on identical inputs. Tolerance: both add
    the same f32 products, the kernel in a fixed order (RoI order per
    entry), the plain version in its einsums' and ``index_add_``'s; the
    gap is bounded by 1e-5 of the sum of the terms' magnitudes (the plain
    backward of |g| with |weights|). In bf16 the f32 u may round to the
    neighbouring bf16 value (at most 2^-8 of that sum) and the result to
    the neighbouring value (one bf16 ulp). NaN positions must agree, and every entry outside
    the hazard boxes' windows must be finite."""
    from proben_tpu_torch.ops import roi_align_cuda
    from proben_tpu_torch.ops.roi_align import roi_align_bwd_plain

    got = roi_align_cuda.roi_align_bwd(g, shapes, lvl_idx, y0, x0, wy, wx, k)
    ref = roi_align_bwd_plain(g, shapes, lvl_idx, y0, x0, wy, wx, k)
    mag = roi_align_bwd_plain(g.float().abs(), shapes, lvl_idx, y0, x0, wy.abs(), wx.abs(), k)
    torch.cuda.synchronize()
    err = bad = nans = 0
    for li, (a, r, m) in enumerate(zip(got, ref, mag)):
        a, r = a.float(), r.float()
        nan_a, nan_r = torch.isnan(a), torch.isnan(r)
        if not torch.equal(nan_a, nan_r):
            raise AssertionError(f"K3 {label}: level {li} NaN pattern differs "
                                 f"({int(nan_a.sum())} vs {int(nan_r.sum())})")
        if hazards is not None and not bool(torch.isfinite(a)[~hazards[li]].all()):
            raise AssertionError(f"K3 {label}: level {li} non-finite outside the hazard windows")
        diff = torch.where(nan_r, 0.0, (a - r).abs())
        rr = torch.where(nan_r, 0.0, r)
        bound = 1e-5 * torch.where(nan_r, 0.0, m)
        if g.dtype == torch.bfloat16:
            bound = bound + bf16_ulp(rr) + 2.0 ** -8 * torch.where(nan_r, 0.0, m)
        bad += int((diff > bound).sum())
        err = max(err, float(diff.max()))
        nans += int(nan_r.sum())
    log(f"K3 {label}: max_abs_err {err:.4g}, {nans} NaN entries, {bad} beyond tolerance")
    if bad:
        raise AssertionError(f"K3 {label}: {bad} entries beyond tolerance")
    return err


def bitwise_repeatable(g, shapes, lvl_idx, y0, x0, wy, wx, k) -> bool:
    """Whether two K3 calls on the same inputs give the same bits (NaNs
    included): the kernel sums every entry in one fixed order."""
    from proben_tpu_torch.ops import roi_align_cuda

    a = roi_align_cuda.roi_align_bwd(g, shapes, lvl_idx, y0, x0, wy, wx, k)
    b = roi_align_cuda.roi_align_bwd(g, shapes, lvl_idx, y0, x0, wy, wx, k)
    bits = torch.int16 if g.element_size() == 2 else torch.int32
    return all(torch.equal(x.view(bits), y.view(bits)) for x, y in zip(a, b))


def sampled_rois(model, batch, seed=0):
    """The training path's pooling inputs: p2..p5 of the model and the RoIs
    ``label_and_sample_proposals`` samples for ``batch``."""
    from proben_tpu_torch.models import rcnn
    from proben_tpu_torch.models.roi_heads import label_and_sample_proposals
    from proben_tpu_torch.models.rpn import find_top_proposals

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        feats = rcnn.extract_features(model, cfg, rcnn.preprocess(cfg, batch["image"]), training=True)
        logits, deltas = rcnn.rpn_outputs(model, cfg, feats)
        boxes, _, valid = find_top_proposals(
            logits, deltas, rcnn.anchors_for(feats), batch["image_size"],
            cfg.rpn.pre_nms_topk_train, cfg.rpn.post_nms_topk_train, cfg.rpn.nms_thresh,
            cfg.rpn.min_box_side_len)
        s_boxes = label_and_sample_proposals(boxes, valid, batch["gt"], gen, cfg.roi)[0]
    return rcnn.roi_levels(feats), s_boxes


def k3_reading(levels, boxes, pooler, label, seed=3):
    """K3 on a path's own pooling inputs and a seeded bf16 cotangent (0.01
    N(0, 1)): held against its plain version, then with 64 hazard boxes
    mixed in (bf16 and f32), two calls bitwise equal on each; the memory one
    call allocates, its time, the plain version's and the bound from this
    run's inputs."""
    from proben_tpu_torch.ops import roi_align_cuda
    from proben_tpu_torch.ops.roi_align import roi_align_bwd_plain

    b, k, _ = boxes.shape
    shapes = [tuple(f.shape) for f in levels]
    c = shapes[0][-1]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def inputs(bx):
        return roi_align_cuda.window_inputs(levels, bx, **pooler)

    lvl, y0, x0, wy, wx, oow = inputs(boxes)
    p = wy.shape[1]
    g = (0.01 * torch.randn(b * k, p, p, c, generator=gen, device="cuda")).to(torch.bfloat16)
    err = check_bwd(g, shapes, lvl, y0, x0, wy, wx, k, f"{label} bf16")
    log(f"K3 {label}: P = {p}, C = {c}, {b * k} RoIs, {int(oow.sum())} out of window; level "
        f"histogram {torch.bincount(lvl.long(), minlength=len(levels)).tolist()}")
    # device memory one K3 call allocates (outputs and scratch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    roi_align_cuda.roi_align_bwd(g, shapes, lvl, y0, x0, wy, wx, k)
    alloc_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    df_mb = sum(s[0] * s[1] * s[2] * s[3] for s in shapes) * g.element_size() / 1e6
    log(f"K3 ({label}) allocates {alloc_mb:.1f} MB per call (dF {df_mb:.1f} MB)")
    ms = cuda_ms(lambda: roi_align_cuda.roi_align_bwd(g, shapes, lvl, y0, x0, wy, wx, k), 30)
    plain_ms = cuda_ms(lambda: roi_align_bwd_plain(g, shapes, lvl, y0, x0, wy, wx, k), 5)
    # bytes: the cotangent, weights and origins read once, every dF written
    # once; multiply-adds the data needs per channel: P for each nonzero wy
    # tap (u over q), then one per nonzero wx tap for every row y with a
    # nonzero wy tap
    nbytes = (g.numel() * g.element_size() + wy.numel() * 4 + wx.numel() * 4 + 3 * 4 * b * k
              + sum(s[0] * s[1] * s[2] * s[3] for s in shapes) * g.element_size())
    nnz_y = (wy != 0).sum(dim=(1, 2)).double()
    rows = (wy != 0).any(dim=1).sum(dim=1).double()
    nnz_x = (wx != 0).sum(dim=(1, 2)).double()
    flops = 2.0 * c * float((p * nnz_y + rows * nnz_x).sum())
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_S * 1e3

    # hazard boxes mixed into the path's RoIs, bf16 and f32
    hz = boxes.clone()
    hz[:, -64:] = hazard_boxes(64, gen)
    lvl_h, y0_h, x0_h, wy_h, wx_h, _ = inputs(hz)
    windows = hazard_windows(shapes, hz.reshape(-1, 4), lvl_h, y0_h, x0_h, k)
    err_h = check_bwd(g, shapes, lvl_h, y0_h, x0_h, wy_h, wx_h, k, f"{label} with hazard boxes bf16",
                      windows)
    err32 = check_bwd(g.float(), shapes, lvl_h, y0_h, x0_h, wy_h, wx_h, k,
                      f"{label} with hazard boxes f32", windows)
    repeat = {"bf16": bitwise_repeatable(g, shapes, lvl, y0, x0, wy, wx, k),
              "hazards bf16": bitwise_repeatable(g, shapes, lvl_h, y0_h, x0_h, wy_h, wx_h, k),
              "hazards f32": bitwise_repeatable(g.float(), shapes, lvl_h, y0_h, x0_h, wy_h, wx_h, k)}
    log(f"K3 ({label}) two calls bitwise equal: {repeat}")
    if not all(repeat.values()):
        raise AssertionError(f"K3 is not deterministic ({label}): {repeat}")
    log(f"K3 timing ({label}): kernel {ms:.4g} ms, plain {plain_ms:.4g} ms, bound "
        f"{max(t_ops, t_bytes):.4g} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
        f"{ms / max(t_ops, t_bytes):.1f}x bound; errors {err:.3g}/{err_h:.3g}/{err32:.3g}")
    return dict(
        max_abs_err=max(err, err_h), ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes", gflop=flops / 1e9,
        mbytes=nbytes / 1e6, max_abs_err_f32=err32, deterministic=True, alloc_mb=alloc_mb,
        p=p, c=c, rois=b * k, out_of_window=int(oow.sum()),
    )


def bwd_phase(model, batch):
    levels, boxes = sampled_rois(model, batch)
    # main path: the sampled RoIs and a seeded bf16 cotangent
    reading = k3_reading(levels, boxes, model.cfg.roi.pooler_args, "main-path RoIs")
    return dict(
        name="roi_align_bwd", route="cuda", source="proben_tpu_torch/csrc/roi_align_bwd.cu",
        replaces="proben_tpu/ops/roi_align_bwd_pallas.py:350", library_ms=None, **reading)


# ---------------------------------------------------------------------------
# slice: Predictor at batch 8, 800x1024, bf16
# ---------------------------------------------------------------------------


def set_background_bias(model, bg_bias: float, w_scale: float, base_w: torch.Tensor):
    """bench.py's head calibration: damp the class weights, raise the
    background logit's bias (background is the last class)."""
    cls = model.roi.output.cls_score
    cls.weight.copy_(base_w * w_scale)
    cls.bias[-1] = bg_bias


def scale_convs(convs, outs, targets):
    """Rescale each conv (weight and bias) so that its per-level outputs
    ``outs`` (lists of tensors) get the target std."""
    with torch.no_grad():
        for conv, t, target in zip(convs, outs, targets):
            s = target / float(torch.cat([x.flatten() for x in t]).float().std())
            conv.weight.mul_(s)
            conv.bias.mul_(s)


def calibrate_rpn(model, images, logit_std=2.0, delta_std=0.1):
    """Rescale the RPN's objectness and delta convs (weight and bias) to the
    given output std on ``images``. Random delta convs give large deltas,
    hence elongated, heavily overlapping proposals whose NMS picks hinge on
    bf16 rounding; a trained RPN's deltas are small."""
    from proben_tpu_torch.models import rcnn
    from proben_tpu_torch.models.rpn import apply_rpn_head

    cfg = model.cfg
    with torch.inference_mode():
        feats = rcnn.extract_features(model, cfg, rcnn.preprocess(cfg, images))
        outs = apply_rpn_head(model.rpn_head, [feats[f] for f in rcnn.RPN_IN_FEATURES], cfg.dtype)
    scale_convs((model.rpn_head.objectness, model.rpn_head.deltas), outs, (logit_std, delta_std))


def bisect_bias(set_bias, dets_per_img, lo, hi, target=(20, 80), steps=10, fewer_when_higher=True):
    """Bisect a bias in [lo, hi] (``set_bias(value)``) until the mean
    detections per image (``dets_per_img()``) land in ``target``; returns
    (bias, detections per image)."""
    n = float("nan")
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        with torch.no_grad():
            set_bias(mid)
        n = dets_per_img()
        if (n > target[1]) == fewer_when_higher and not target[0] <= n <= target[1]:
            lo = mid
        elif not target[0] <= n <= target[1]:
            hi = mid
        else:
            break
    return mid, n


def calibrate(model, predictor, images, sizes, lo=0.0, hi=16.0, target=(20, 80), steps=10):
    """Bisect the background bias until mean dets/img lands in ``target``."""
    base_w = model.roi.output.cls_score.weight.detach().clone()
    return bisect_bias(lambda b: set_background_bias(model, b, 0.02, base_w),
                       lambda: float(predictor.infer(images, sizes, sizes).valid.sum(-1).float().mean()),
                       lo, hi, target, steps)


def match_fraction(a, b, iou_min=0.95, score_tol=0.02):
    """Fraction of detections in ``a`` (list of per-image dicts) with a
    same-class partner in ``b`` at IoU >= iou_min and |dscore| <= score_tol
    (greedy, one partner each)."""
    from proben_tpu_torch.structures.boxes import pairwise_iou

    hit = total = 0
    for ra, rb in zip(a, b):
        total += len(ra["scores"])
        if not len(ra["scores"]) or not len(rb["scores"]):
            continue
        iou = pairwise_iou(torch.from_numpy(ra["boxes"]), torch.from_numpy(rb["boxes"])).numpy()
        ok = ((ra["classes"][:, None] == rb["classes"][None, :]) & (iou >= iou_min)
              & (np.abs(ra["scores"][:, None] - rb["scores"][None, :]) <= score_tol))
        used = np.zeros(len(rb["scores"]), bool)
        for i in np.argsort(-ra["scores"], kind="stable"):
            js = np.nonzero(ok[i] & ~used)[0]
            if len(js):
                used[js[0]] = True
                hit += 1
    return hit / max(total, 1)


def feature_gap(model, cfg_a, cfg_b, images, plain=(False, True)):
    """Relative L2 difference of the p2..p6 maps of two configurations, per
    stream for middle fusion (the concat's RGB and thermal halves);
    ``plain``: whether each side runs with K4 off."""
    from proben_tpu_torch.models import rcnn

    def maps(c, off):
        with torch.inference_mode(), (k4_off() if off else contextlib.nullcontext()):
            return rcnn.extract_features(model, c, rcnn.preprocess(c, images))

    fa, fb = maps(cfg_a, plain[0]), maps(cfg_b, plain[1])
    c = cfg_a.fpn_channels
    streams = {"rgb ": slice(0, c), "thermal ": slice(c, 2 * c)} if cfg_a.dual else {"": slice(None)}
    return {s + k: float((fa[k][:, sl].float() - fb[k][:, sl].float()).norm() / fb[k][:, sl].float().norm())
            for s, sl in streams.items() for k in fa}


def slice_phase(model, images_list, sizes, expect, hi=16.0):
    """The main path, then its agreement with the plain versions. Tolerance:
    bf16 rounding alone (the plain path in bf16 against the plain path in
    f32) moves the p5/p6 maps of this random R101 by ~1% and changes which
    near-tied proposals survive top-k and NMS, so the whole-path detections
    of two correct bf16 runs do not agree to 95%. Hence three checks: (1)
    with the stem plain and K4 off, K2 is the only difference, and >= 95% of the
    detections must match (class, IoU >= 0.95, |dscore| <= 0.02) both
    ways; (2) with both kernels, every FPN map may differ from the plain
    path's by at most 1.5x what bf16 rounding moves it (a wiring fault
    gives O(1)); (3) the whole-path detections must match at least as well
    as the f32 control, less 5 points. The plain path runs with K4 off;
    before it, the batch with K4 off must give the kernel path's
    detections bit for bit. ``expect``: the launches of each kernel and
    K4's counts in one batch; ``hi``: the top of the background-bias
    bracket."""
    from proben_tpu_torch.engine import Predictor

    cfg = model.cfg
    calibrate_rpn(model, images_list[0])
    pred = Predictor(model, cfg)
    bias, n_dets = calibrate(model, pred, images_list[0], sizes, hi=hi)
    log(f"calibration: background bias {bias:.4g} -> {n_dets:.1f} dets/img")
    batch = {"image": images_list[0], "image_size": sizes, "orig_size": sizes,
             "image_id": list(range(BATCH))}
    zero_launch_counts()
    out_k = pred.predict_batch(batch)
    launches = launch_counts()
    expect_launches(f"{cfg.input_format} inference", launches, expect)
    # K4 keeps every rounding point: the same batch with K4 off gives the same detections, bit for bit
    with k4_off():
        zero_launch_counts()
        out_off = pred.predict_batch(batch)
        check_counts(f"{cfg.input_format} inference, K4 off", launch_counts(*CHECKED),
                 {"block_epilogue": 0, "epilogue_plain": expect["block_epilogue"]})
    if not all(np.array_equal(a[k], b[k]) for a, b in zip(out_k, out_off) for k in ("boxes", "scores", "classes")):
        raise AssertionError(f"{cfg.input_format} inference: detections with K4 differ from those with K4 off")
    log(f"{cfg.input_format} inference: detections with K4 and with K4 off equal bit for bit")
    for r in out_k:
        if not (np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()):
            raise AssertionError("non-finite detections")
        if r["boxes"].ndim != 2 or r["boxes"].shape[1] != 4 or len(r["boxes"]) > cfg.rcnn.topk_per_image:
            raise AssertionError(f"bad detection shape {r['boxes'].shape}")

    plain_cfg = cfg.replace(stem_impl="plain", roi_align_impl="plain")
    f32_cfg = plain_cfg.replace(compute_dtype="float32")
    plain = Predictor(model, plain_cfg)
    with k4_off():
        out_p = plain.predict_batch(batch)
        out_k2 = Predictor(model, cfg.replace(stem_impl="plain")).predict_batch(batch)
    out_32 = Predictor(model, f32_cfg).predict_batch(batch)

    def both(a, b):
        return min(match_fraction(a, b), match_fraction(b, a))

    m_k2, m_all, m_32 = both(out_k2, out_p), both(out_k, out_p), both(out_p, out_32)
    gap_k = feature_gap(model, cfg, plain_cfg, images_list[0])
    gap_32 = feature_gap(model, plain_cfg, f32_cfg, images_list[0], plain=(True, True))
    dets_k = sum(len(r["scores"]) for r in out_k) / BATCH
    dets_p = sum(len(r["scores"]) for r in out_p) / BATCH
    log(f"detections: kernels {dets_k:.1f}/img, plain {dets_p:.1f}/img; matched (worse direction): "
        f"K2 only {100 * m_k2:.2f}%, both kernels {100 * m_all:.2f}%, bf16 vs f32 control {100 * m_32:.2f}%")
    log("FPN maps, relative L2 gap kernels-vs-plain / bf16-vs-f32: " + ", ".join(
        f"{k} {gap_k[k]:.3g}/{gap_32[k]:.3g}" for k in gap_k))
    if m_k2 < 0.95 or dets_k == 0:
        raise AssertionError("K2 and plain detections disagree")
    if any(gap_k[k] > 1.5 * gap_32[k] for k in gap_k):
        raise AssertionError("kernel-path features differ from the plain path's beyond bf16 rounding")
    if m_all < m_32 - 0.05:
        raise AssertionError("kernel-path detections agree worse than the bf16-vs-f32 control")

    def run(p, iters):
        for i in range(iters):
            det = p.infer(images_list[i % len(images_list)], sizes, sizes)
        return det

    rates = {}
    for name, p in (("kernels", pred), ("plain", plain)):
        with k4_off() if name == "plain" else contextlib.nullcontext():
            run(p, 2)
            iters = 12
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            run(p, iters)
            b.record()
            torch.cuda.synchronize()
        rates[name] = BATCH * iters / (a.elapsed_time(b) / 1e3)
        if name == "kernels":  # the kernel path's own peak (model, inputs, one batch in flight)
            peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"throughput: {rates['kernels']:.2f} img/s with kernels, {rates['plain']:.2f} img/s plain; "
        f"peak memory {peak:.2f} GB")
    return launches, dict(dets_per_img=dets_k, dets_per_img_plain=dets_p, matched_k2=m_k2,
                          matched=m_all, matched_bf16_f32=m_32,
                          fpn_gap=gap_k, fpn_gap_bf16_f32=gap_32,
                          img_s=rates["kernels"], img_s_plain=rates["plain"],
                          max_memory_gb=peak)


def stage_medians(pipeline, reps=5):
    """Median ms per named stage of ``pipeline(timed)`` over ``reps`` runs
    after a warm-up, under ``torch.inference_mode``: ``timed(name, fn)``
    runs ``fn`` between CUDA events after a synchronize and returns its
    result."""
    acc = {}

    def timed(name, fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        acc.setdefault(name, []).append(a.elapsed_time(b))
        return out

    with torch.inference_mode():
        for _ in range(reps + 1):
            pipeline(timed)
    return {k: float(np.median(v[1:])) for k, v in acc.items()}


def stage_times(model, images, sizes, reps=5):
    """Median ms per stage of one batch: the functions ``rcnn_inference``
    calls, in its order (``stage_medians``; the proposal NMS syncs with the
    host anyway)."""
    from proben_tpu_torch.models import rcnn
    from proben_tpu_torch.models.roi_heads import roi_heads_predict_from_pooled

    cfg = model.cfg

    def pipeline(timed):
        x = timed("preprocess", lambda: rcnn.preprocess(cfg, images))
        feats = timed("backbone (stem K1 + ResNet) + FPN", lambda: rcnn.extract_features(model, cfg, x))
        boxes, _, valid = timed("RPN head + proposals (top-k, decode, NMS)",
                                lambda: rcnn.propose(model, cfg, feats, sizes))
        pooled = timed("roi align (weights, K2, fallback)", lambda: rcnn.pool_proposals(cfg, feats, boxes))
        timed("box head + detection NMS", lambda: roi_heads_predict_from_pooled(
            model.roi, pooled, boxes, valid, sizes, cfg.rcnn, dtype=cfg.dtype))

    return stage_medians(pipeline, reps)


def profile_phase(pred, images, sizes):
    """Stage breakdown and a torch.profiler table of two batches, both on
    standard error."""
    for name, ms in stage_times(pred.model, images[0], sizes).items():
        log(f"stage {name}: {ms:.4g} ms")
    from torch.profiler import ProfilerActivity, profile

    pred.infer(images[0], sizes, sizes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(2):
            pred.infer(images[i % 2], sizes, sizes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    dev = sum(e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    log(f"profile: {wall_ms:.4g} ms wall for 2 batches, device busy {dev:.4g} ms "
        f"({100 * dev / wall_ms:.1f}%)")
    log(ka.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))


# ---------------------------------------------------------------------------
# training slice: make_train_step at batch 8, 800x1024, bf16
# ---------------------------------------------------------------------------

# configs/FLIR-Detection/faster_rcnn_R_101_FLIR.yaml over Base-RCNN-FPN's solver
FLIR_SOLVER = dict(base_lr=0.02, momentum=0.9, weight_decay=1e-4, weight_decay_bias=1e-4,
                   warmup_factor=1e-3, warmup_iters=1000, steps=(210000, 250000), max_iter=270000)


def group_of(name: str) -> str:
    """Module group of a parameter: a backbone's stage, an FPN, the RPN
    head, the box head or the output layers."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] in ("backbone", "backbone_2", "roi") else parts[0]


def grad_gaps(a, b):
    """Relative L2 difference of two gradient dicts per module group."""
    num, den = {}, {}
    for n, ga in a.items():
        k = group_of(n)
        num[k] = num.get(k, 0.0) + float((ga.float() - b[n].float()).pow(2).sum())
        den[k] = den.get(k, 0.0) + float(b[n].float().pow(2).sum())
    return {k: (num[k] / den[k]) ** 0.5 if den[k] else float("inf") for k in num}


class plain_backward:
    """Within the block, the pooling backward runs K3's plain version
    instead of K3 (the forward stays K2): the only difference between the
    two training runs it is used to compare."""

    def __enter__(self):
        from proben_tpu_torch.ops import roi_align_cuda

        self.module, self.kernel = roi_align_cuda, roi_align_cuda.roi_align_bwd
        roi_align_cuda.roi_align_bwd = roi_align_cuda.roi_align_bwd_plain

    def __exit__(self, *exc):
        self.module.roi_align_bwd = self.kernel


def k3_only_check(model, cfg, batch, label, seed=11):
    """K3 as the only difference in one training step's losses and
    gradients (same seed; K3 or its plain version in the backward, the
    forward the same), with the plain version run twice as the control.
    Tolerance: the losses must be bit-identical; each module group's
    gradient may differ by 1e-2 relative L2 (K3 rounds each dF entry once,
    from an f32 sum taken in another order than the plain version's: at
    most one bf16 ulp, 2^-8 relative, per entry); every trainable group
    gets a finite, nonzero gradient. In f32 only the order of the f32
    sums differs, so the limit is 1e-4."""
    from proben_tpu_torch.engine.train import losses_and_grads

    groups = sorted({group_of(n) for n, p in model.named_parameters() if p.requires_grad})
    gen = torch.Generator(device="cuda")
    runs = {}
    for name in ("kernel", "plain", "plain again"):
        if name == "kernel":
            runs[name] = losses_and_grads(model, cfg, batch, gen.manual_seed(seed))
        else:
            with plain_backward():
                runs[name] = losses_and_grads(model, cfg, batch, gen.manual_seed(seed))
    (lk, tk, gk), (lp, tp, gp), (_, _, gp2) = runs.values()
    same = all(torch.equal(lk[k], lp[k]) for k in lk) and torch.equal(tk, tp)
    gaps, control = grad_gaps(gk, gp), grad_gaps(gp2, gp)
    norms = {}
    for n, gr in gk.items():
        norms[group_of(n)] = norms.get(group_of(n), 0.0) + float(gr.float().pow(2).sum())
    log(f"K3-only {label}: losses bit-identical {same} ({ {k: float(v) for k, v in lk.items()} })")
    log(f"K3-only {label} gradient gap per group (rel L2, K3 vs plain / plain vs plain): " + ", ".join(
        f"{k} {gaps[k]:.3g}/{control[k]:.3g}" for k in groups))
    if not same:
        raise AssertionError(f"K3-only {label}: K3 and plain-backward runs give different losses")
    if any(not norms[k] > 0 or not np.isfinite(norms[k]) for k in groups):
        raise AssertionError(f"K3-only {label}: a trainable module group gets no gradient: {norms}")
    limit = 1e-2 if cfg.dtype == torch.bfloat16 else 1e-4
    if any(not gaps[k] <= limit for k in groups):
        raise AssertionError(f"K3-only {label}: K3 gradients differ from the plain backward's: {gaps}")
    return gaps, control


def train_phase(model, batch, expect, steps=8, warmup=2):
    """The training slice through ``make_train_step``, then K3 as the only
    difference (``k3_only_check``), then train img/s with K3 and with the
    plain backward. ``expect``: the launches of each kernel in one step."""
    from proben_tpu_torch.engine.train import make_train_step, trainable_mask
    from proben_tpu_torch.solver import SolverConfig

    cfg = model.cfg
    init_state, train_step = make_train_step(cfg, SolverConfig(**FLIR_SOLVER),
                                             trainable_mask(model, cfg.freeze_at))
    state = init_state(model, 7)
    params = dict(model.named_parameters())
    frozen = {n: p.detach().clone() for n, p in params.items() if not p.requires_grad}
    start = {n: p.detach().clone() for n, p in params.items() if p.requires_grad}
    torch.cuda.reset_peak_memory_stats()
    gaps, control = k3_only_check(model, cfg, batch, f"{cfg.input_format} batch {BATCH}")

    # the main path: one step, every launch counter read around it
    zero_launch_counts()
    state, m = train_step(state, batch)
    launches = launch_counts()
    expect_launches(f"{cfg.input_format} training step", launches, expect)
    metrics = [m]

    def timed(n):
        nonlocal state
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            state, m = train_step(state, batch)
            metrics.append(m)
        b.record()
        torch.cuda.synchronize()
        return BATCH * n / (a.elapsed_time(b) / 1e3)

    rates = {}
    for name in ("kernel", "plain backward"):
        if name == "kernel":
            timed(warmup)
            before = launch_counts()["roi_align_bwd"]
            rates[name] = timed(steps)
            if launch_counts()["roi_align_bwd"] - before != steps:
                raise AssertionError("K3 did not launch once per timed step")
        else:
            with plain_backward():
                timed(warmup)
                rates[name] = timed(steps)
    peak = torch.cuda.max_memory_allocated() / 1e9

    table = {k: torch.stack([mm[k] for mm in metrics]).float().cpu() for k in metrics[0]}
    if not all(bool(torch.isfinite(v).all()) for v in table.values()) or not bool((table["loss_finite"] == 1).all()):
        raise AssertionError(f"non-finite training metrics: {table}")
    for n, p in params.items():
        if n in frozen and not torch.equal(p, frozen[n]):
            raise AssertionError(f"frozen parameter {n} changed")
    unmoved = [n for n in start if torch.equal(params[n].detach(), start[n])]
    if unmoved:
        raise AssertionError(f"{len(unmoved)} trainable tensors did not move, e.g. {unmoved[:3]}")
    log(f"training: {len(metrics)} steps, total loss {float(table['total_loss'][0]):.4g} -> "
        f"{float(table['total_loss'][-1]):.4g}; {len(frozen)} frozen tensors unchanged, "
        f"{len(start)} trainable moved")
    log(f"train throughput: {rates['kernel']:.2f} img/s with K3, {rates['plain backward']:.2f} img/s "
        f"with the plain backward; peak memory {peak:.1f} GB")
    return launches, dict(
        img_s=rates["kernel"], img_s_plain_bwd=rates["plain backward"], peak_memory_gb=peak,
        steps=len(metrics), losses_first={k: float(v[0]) for k, v in table.items()},
        losses_last={k: float(v[-1]) for k, v in table.items()}, k3_grad_gap=gaps,
        plain_grad_gap_control=control,
    )


def train_profile(model, batch):
    """Where one training step's time goes: forward (losses), backward,
    update medians with CUDA events, and a torch.profiler table of two
    steps, all on standard error."""
    from torch.profiler import ProfilerActivity, profile

    from proben_tpu_torch.engine.train import make_train_step, trainable_mask
    from proben_tpu_torch.models.rcnn import rcnn_train_losses
    from proben_tpu_torch.solver import SolverConfig

    cfg = model.cfg
    init_state, train_step = make_train_step(cfg, SolverConfig(**FLIR_SOLVER),
                                             trainable_mask(model, cfg.freeze_at))
    state = init_state(model, 7)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    acc = {}
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        losses = rcnn_train_losses(model, cfg, batch["image"], batch["image_size"], batch["gt"],
                                   state.generator)
        ev[1].record()
        torch.autograd.grad(sum(losses.values()), [p for _, p in named], allow_unused=True)
        ev[2].record()
        torch.cuda.synchronize()
        acc.setdefault("forward (losses)", []).append(ev[0].elapsed_time(ev[1]))
        acc.setdefault("backward", []).append(ev[1].elapsed_time(ev[2]))
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, _ = train_step(state, batch)
        b.record()
        torch.cuda.synchronize()
        acc.setdefault("whole step", []).append(a.elapsed_time(b))
    for k, v in acc.items():
        log(f"train stage {k}: {float(np.median(v[1:])):.4g} ms")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(2):
            state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev = sum(e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    log(f"train profile: {wall_ms:.4g} ms wall for 2 steps, device busy {dev:.4g} ms "
        f"({100 * dev / wall_ms:.1f}%)")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=30,
                                  max_name_column_width=60))


# ---------------------------------------------------------------------------
# ProbEn late fusion of two single-modality detectors
# ---------------------------------------------------------------------------

def check_fusion(dets, label):
    """``fuse_detections_torch`` on the card, batched over the images,
    against the port's numpy ``fuse_detections`` per image on the same valid
    detections (in f64), for every (score, box) method. Tolerance (that of
    tests/test_proben_fusion.py): same count and classes, scores to rtol
    2e-4 / atol 2e-5, boxes to rtol 2e-4 / atol 2e-3 px."""
    from proben_tpu_torch.fusion import fuse_detections, fuse_detections_torch
    from proben_tpu_torch.fusion.proben_torch import BOX_METHODS, SCORE_METHODS

    args = [torch.cat([getattr(d, f) for d in dets], 1)
            for f in ("boxes", "scores", "classes", "probs", "variance", "valid")]
    host = [a.cpu().numpy() for a in args]
    n = args[0].shape[1]
    out = {}
    for sm, bm in [(sm, bm) for sm in SCORE_METHODS for bm in BOX_METHODS]:
        got = [t.cpu().numpy() for t in fuse_detections_torch(*args, score_method=sm, box_method=bm,
                                                              topk=n)]
        err_s = err_b = 0.0
        fused = 0
        for i in range(args[0].shape[0]):
            b, sc, c, p, var, v = (h[i] for h in host)
            f64 = lambda a: a[v].astype(np.float64)  # noqa: E731
            nb, ns, nc = fuse_detections(f64(b), f64(sc), c[v], f64(p), f64(var), sm, bm)
            m = int(got[3][i].sum())
            if m != len(ns) or not np.array_equal(got[2][i][:m], nc):
                raise AssertionError(f"ProbEn {label} {sm}/{bm} image {i}: {m} fused detections "
                                     f"vs {len(ns)}, or their classes differ")
            np.testing.assert_allclose(got[1][i][:m], ns, rtol=2e-4, atol=2e-5,
                                       err_msg=f"ProbEn {label} {sm}/{bm} scores")
            np.testing.assert_allclose(got[0][i][:m], nb, rtol=2e-4, atol=2e-3,
                                       err_msg=f"ProbEn {label} {sm}/{bm} boxes")
            err_s = max(err_s, float(np.abs(got[1][i][:m] - ns).max(initial=0.0)))
            err_b = max(err_b, float(np.abs(got[0][i][:m] - nb).max(initial=0.0)))
            fused += m
        out[f"{sm}/{bm}"] = {"fused_per_img": fused / args[0].shape[0], "max_abs_err_score": err_s,
                             "max_abs_err_box": err_b}
    log(f"ProbEn {label}: all 12 methods agree with the numpy reference; fused dets/img " + ", ".join(
        f"{k} {v['fused_per_img']:.1f}" for k, v in out.items()))
    return args, out


def proben_phase(images, sizes):
    """Two calibrated R101 BGR detectors with the variance head (the
    ``faster_rcnn_R_101_FLIR_gnll.yaml`` model), the "thermal" one on the
    images with reversed channels and the "RGB" one on the images as they
    are; their padded detections (100 + 100 per image) fused on the card by
    every method, with TF32 off and then on, then ms per batch-of-8 call."""
    from proben_tpu_torch.engine import Predictor
    from proben_tpu_torch.fusion import fuse_detections_torch
    from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines

    cfg = build_config(depth=101, input_format="BGR", num_classes=3, compute_dtype="bfloat16",
                       enable_gaussian_nll=True)
    dets, per_img = [], {}
    for name, seed, ims in (("thermal", 2, [im.flip(-1) for im in images]), ("rgb", 3, images)):
        model = build_model(cfg, params=random_affines(init_rcnn(seed, cfg), seed))
        calibrate_rpn(model, ims[0])
        pred = Predictor(model, cfg)
        bias, n = calibrate(model, pred, ims[0], sizes)
        log(f"ProbEn {name} model: background bias {bias:.4g} -> {n:.1f} dets/img")
        dets.append(pred.infer(ims[0], sizes, sizes))
        per_img[name] = n
        del model, pred
    results = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        args, results["tf32 on" if tf32 else "tf32 off"] = check_fusion(dets, "TF32 " + ("on" if tf32 else "off"))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    n = args[0].shape[1]
    ms = {}
    for method in results["tf32 off"]:
        sm, bm = method.split("/")
        ms[method] = cuda_ms(lambda: fuse_detections_torch(*args, score_method=sm, box_method=bm,
                                                           topk=n), 10)
    log("ProbEn ms per batch-of-8 call: " + ", ".join(f"{k} {v:.3g}" for k, v in ms.items()))
    return dict(dets_per_img=per_img, detections_per_img_padded=n, methods=results, ms=ms)


# ---------------------------------------------------------------------------
# FLIR evaluation: the app's entry points on a synthetic FLIR val tree
# ---------------------------------------------------------------------------

FLIR_T_HW, FLIR_RGB_HW = (512, 640), (1600, 1800)  # FLIR ADAS thermal / RGB (H, W)
FLIR_CLASSES = ("person", "bicycle", "car")


def flir_scene(gen, h, w, boxes, channels, sy, sx):
    """A background gradient with noise and a bright textured block per
    box (boxes in thermal-frame pixels, drawn scaled by ``sy``, ``sx``),
    uint8 (h, w, c) on the card. In colour each channel has its own
    background (B a gradient along x, G flat, R a gradient along y), so a
    decode in the wrong channel order is off by ~30 levels on average."""
    x = torch.linspace(40.0, 110.0, w, device="cuda")[None, :].expand(h, w)
    if channels == 1:
        bg = x[..., None]
    else:
        y = torch.linspace(170.0, 60.0, h, device="cuda")[:, None].expand(h, w)
        bg = torch.stack([x, torch.full_like(x, 90.0), y], -1)
    img = bg + 2.0 * torch.randn(h, w, channels, generator=gen, device="cuda")
    for x0, y0, bw, bh in boxes:
        ys, xs = int(y0 * sy), int(x0 * sx)
        ye, xe = int((y0 + bh) * sy), int((x0 + bw) * sx)
        level = 130.0 + 100.0 * torch.rand(channels, generator=gen, device="cuda")
        stripes = 12.0 * torch.sin(torch.arange(ye - ys, device="cuda") / (3.0 * sy))[:, None, None]
        img[ys:ye, xs:xe] = level + stripes
    return img.round().clamp(0, 255).to(torch.uint8).contiguous()


def write_flir_tree(codec, root, n=32, seed=0):
    """A FLIR-shaped val tree: ``thermal_8_bit/FLIR_%05d.jpeg`` (640x512,
    single-component), ``RGB/FLIR_%05d.jpg`` (1800x1600, colour 4:2:0),
    both encoded with nvJPEG at quality 90, and the COCO json with 3
    categories and 1-6 boxes per image. Returns the json path, the first
    pair's source pixels and the mean file size of each kind in bytes."""
    from proben_tpu_torch.apps.flir import VAL_JSON_NAME

    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    os.makedirs(os.path.join(root, "thermal_8_bit"), exist_ok=True)
    os.makedirs(os.path.join(root, "RGB"), exist_ok=True)
    images, annotations, first, sizes = [], [], None, {"thermal": [], "rgb": []}
    th, tw = FLIR_T_HW
    for i in range(n):
        boxes = []
        for _ in range(rng.randint(1, 7)):
            bw, bh = rng.randint(16, 120), rng.randint(24, 160)
            boxes.append((float(rng.randint(0, tw - bw)), float(rng.randint(0, th - bh)), float(bw),
                          float(bh)))
        thermal = flir_scene(gen, th, tw, boxes, 1, 1.0, 1.0)
        rgb = flir_scene(gen, *FLIR_RGB_HW, boxes, 3, FLIR_RGB_HW[0] / th, FLIR_RGB_HW[1] / tw)
        name = f"FLIR_{i:05d}"
        for kind, path, img in (("thermal", f"thermal_8_bit/{name}.jpeg", thermal),
                                ("rgb", f"RGB/{name}.jpg", rgb)):
            data = codec.encode(img, quality=90)
            sizes[kind].append(len(data))
            with open(os.path.join(root, path), "wb") as f:
                f.write(data)
        if first is None:
            first = (thermal, rgb)
        images.append({"id": i + 1, "file_name": f"{name}.jpeg", "height": th, "width": tw})
        for x0, y0, bw, bh in boxes:
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1,
                                "category_id": int(rng.randint(1, 4)), "bbox": [x0, y0, bw, bh],
                                "area": bw * bh, "iscrowd": 0})
    cats = [{"id": i + 1, "name": c} for i, c in enumerate(FLIR_CLASSES)]
    json_path = os.path.join(root, VAL_JSON_NAME)
    with open(json_path, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": cats}, f)
    return json_path, first, {k: float(np.mean(v)) for k, v in sizes.items()}


def host_ms(fn, reps=5):
    """Median host wall time of ``fn()`` in ms, each call ending in a
    synchronize (for work with a host part, such as nvJPEG's Huffman
    decode)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def rgb_rows_read(rh, th):
    """The RGB rows under a nonzero weight of the uint8 resize from ``rh``
    to ``th`` rows (cv2's fixed-point taps): the only rows the compose
    needs (1024 of 1600 at the FLIR sizes). Along x the taps are < 32 bytes
    apart, so every sector of a needed row is read."""
    from proben_tpu_torch.native import io

    y0, y1, b0, b1 = io._fixed_taps(th, rh, False, "cpu")
    return len(set(y0[b0 != 0].tolist()) | set(y1[b1 != 0].tolist()))


def check_loader(codec, root, dicts):
    """The ``image_io`` kernel against ``compose_resize_pad_plain`` on the
    same decoded pixels of 8 pairs, for BGR, BGRT and BGRTTT, then timed.
    Tolerance: both run the same float operations in the same order, each
    rounded (the kernel's intrinsics admit no FMA contraction), and the same
    integer arithmetic for the RGB image's uint8 resize, so they should
    agree bit for bit; 1e-3 (far below one of the 0..255 levels) is
    allowed. Also: a single-component thermal JPEG must give three equal
    channels."""
    from proben_tpu_torch.data.detection_utils import derive_rgb_path
    from proben_tpu_torch.data.transforms import resize_shortest_edge_size
    from proben_tpu_torch.native import io

    paths = [d["file_name"] for d in dicts[:BATCH]]
    blobs = {p: open(p, "rb").read() for p in paths + [derive_rgb_path(p) for p in paths]}
    thermal = [codec.decode(blobs[p]) for p in paths]
    rgb = [codec.decode(blobs[derive_rgb_path(p)]) for p in paths]
    torch.cuda.synchronize()
    if any(t.shape[2] != 1 for t in thermal) or any(r.shape[2] != 3 for r in rgb):
        raise AssertionError("thermal JPEGs must decode to one channel and RGB ones to three")
    sizes = [resize_shortest_edge_size(*t.shape[:2], 800, 1333) for t in thermal]
    out = {}
    for fmt in ("BGR", "BGRT", "BGRTTT"):
        r = None if fmt == "BGR" else rgb
        got = io.compose_resize_pad(thermal, r, fmt, sizes, (H, W))
        ref = io.compose_resize_pad_plain(thermal, r, fmt, sizes, (H, W))
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        t = got[..., -3:]  # BGR and BGRTTT: the three thermal channels
        if fmt != "BGRT" and not (torch.equal(t[..., 0], t[..., 1]) and torch.equal(t[..., 0], t[..., 2])):
            raise AssertionError(f"image_io {fmt}: grayscale thermal channels differ")
        if err > 1e-3 or not torch.isfinite(got).all():
            raise AssertionError(f"image_io {fmt}: kernel vs plain max |err| {err}")
        ms = cuda_ms(lambda: io.compose_resize_pad(thermal, r, fmt, sizes, (H, W)), 30)
        plain_ms = cuda_ms(lambda: io.compose_resize_pad_plain(thermal, r, fmt, sizes, (H, W)), 5)
        nbytes = got.numel() * 4 + sum(x.numel() for x in thermal) + (
            sum(rgb_rows_read(x.shape[0], t.shape[0]) * x.shape[1] * x.shape[2]
                for x, t in zip(rgb, thermal)) if r is not None else 0)
        bound = nbytes / HBM_BYTES_S * 1e3
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                   mbytes=nbytes / 1e6, library_ms=None)
        if fmt == "BGR":  # the nearest single PyTorch call: a bilinear resize of the stacked batch
            x = torch.stack(thermal).permute(0, 3, 1, 2).float().expand(-1, 3, -1, -1)
            row["library_ms"] = cuda_ms(lambda: F.interpolate(
                x, size=sizes[0], mode="bilinear", align_corners=False), 30)
        out[fmt] = row
        log(f"image_io {fmt}: max_abs_err {err:.3g}, kernel {ms:.4g} ms, plain {plain_ms:.4g} ms, "
            f"bound {bound:.4g} ms ({nbytes / 1e6:.1f} MB), {ms / bound:.1f}x bound")
    return out, blobs, paths


def decoder_gap(codec, first, root):
    """nvJPEG's decode of the first pair against the pixels that were
    encoded (mean and max |diff|, JPEG quality 90), and against cv2's decode
    where cv2 is installed. Limits: against the source a mean of 5 levels
    (the scenes' per-pixel noise does not survive quantisation and the RGB's
    4:2:0 subsampling, ~1-2.5 levels); the RGB decode in B and R swapped
    must be off by more than 20 (the scene's channels differ, so the check
    has the power to see a wrong channel order); against cv2 a mean of 0.1
    (thermal) and 1.0 (RGB: the chroma upsampling differs at colour edges)."""
    import importlib

    src_t, src_rgb = first
    got_t = codec.decode(open(os.path.join(root, "thermal_8_bit/FLIR_00000.jpeg"), "rb").read())
    got_rgb = codec.decode(open(os.path.join(root, "RGB/FLIR_00000.jpg"), "rb").read())
    torch.cuda.synchronize()
    gap = {}
    for name, a, b in (("thermal", got_t, src_t), ("rgb", got_rgb, src_rgb),
                       ("rgb_swapped", got_rgb.flip(-1), src_rgb)):
        d = (a.float() - b.float()).abs()
        gap[f"{name}_vs_source_mean"] = float(d.mean())
        gap[f"{name}_vs_source_max"] = float(d.max())
    limits = {"thermal_vs_source_mean": 5.0, "rgb_vs_source_mean": 5.0}
    try:
        cv2 = importlib.import_module("cv2")
    except ImportError:
        gap["cv2"] = "not installed"
    else:
        for name, a, p in (("thermal", got_t, "thermal_8_bit/FLIR_00000.jpeg"),
                           ("rgb", got_rgb, "RGB/FLIR_00000.jpg")):
            ref = torch.from_numpy(cv2.imread(os.path.join(root, p))).cuda().float()
            d = (a.float().expand_as(ref) - ref).abs()
            gap[f"{name}_vs_cv2_mean"], gap[f"{name}_vs_cv2_max"] = float(d.mean()), float(d.max())
        limits.update(thermal_vs_cv2_mean=0.1, rgb_vs_cv2_mean=1.0)
    log(f"decoder gap: {gap}; limits {limits}")
    if any(gap[k] > v for k, v in limits.items()):
        raise AssertionError(f"nvJPEG decode beyond its limits {limits}: {gap}")
    if gap["rgb_swapped_vs_source_mean"] <= 20.0:
        raise AssertionError(f"the RGB scene cannot tell a channel swap: {gap}")
    gap["limits"] = limits
    return gap


class TimingRecords:
    """Collects the dict that ``inference_on_dataset`` logs with its timing."""

    def __init__(self):
        import logging

        self.records = []
        self.handler = logging.Handler()
        self.handler.emit = lambda r: self.records.append(r.args[-1]) if isinstance(
            r.args, tuple) and r.args and isinstance(r.args[-1], dict) else None
        self.logger = logging.getLogger("proben_tpu_torch.evaluation.evaluator")
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)

    def close(self):
        self.logger.removeHandler(self.handler)


def flir_model(cfg, seed, batch):
    """The config's model with random affines, RPN and head calibrated on a
    mapped batch of the tree (as ``slice_phase`` does); its parameters as
    the numpy pytree the app takes."""
    from proben_tpu_torch.checkpoint import state_dict_to_jax
    from proben_tpu_torch.config import model_config_from_cfg
    from proben_tpu_torch.engine import Predictor
    from proben_tpu_torch.models import build_model, init_rcnn, random_affines

    mcfg = model_config_from_cfg(cfg)
    model = build_model(mcfg, params=random_affines(init_rcnn(seed, mcfg), seed))
    calibrate_rpn(model, batch["image"])
    bias, n = calibrate(model, Predictor(model, mcfg), batch["image"], batch["image_size"], hi=32.0)
    log(f"{cfg.INPUT.FORMAT} model, {mcfg.num_classes} classes: background bias {bias:.4g} -> {n:.1f} dets/img")
    params = state_dict_to_jax({k: v.cpu() for k, v in model.state_dict().items()})
    return model, mcfg, params


def flir_phase(card):
    """The FLIR evaluation entry point end to end on a synthetic val tree
    (32 pairs at the FLIR sizes): loader checks, then ``save_predictions``
    and ``evaluate_map`` for thermal_only and middle_fusion from the YAML
    configs (R101, bf16, batch 8, 800x1024), their end-to-end rate over the
    whole split, ``run_proben`` over the two saved JSONs, and the ground
    truth fed back as detections (AP = 100). The tree's file sizes follow
    from its synthetic scenes, so the decode and end-to-end rates hold for
    this tree, not for the real FLIR files."""
    import tempfile

    from proben_tpu_torch.apps import flir
    from proben_tpu_torch.config import get_cfg, mapper_config_from_cfg
    from proben_tpu_torch.data import (DatasetCatalog, DatasetMapper, build_test_loader, collate,
                                       derive_rgb_path)
    from proben_tpu_torch.engine import Predictor
    from proben_tpu_torch.evaluation import COCODataset, FLIREvaluator, inference_on_dataset
    from proben_tpu_torch.native import io

    stats = {"card": card}
    with tempfile.TemporaryDirectory(prefix="flir_val_") as root, io.JpegCodec() as codec:
        t = time.time()
        json_path, first, stats["jpeg_bytes"] = write_flir_tree(codec, root)
        log(f"FLIR tree: 32 pairs written in {time.time() - t:.1f} s, mean file size "
            f"{stats['jpeg_bytes']}")
        flir.register_flir("FLIR_val", root)
        dicts = DatasetCatalog.get("FLIR_val")
        kernels, blobs, paths = check_loader(codec, root, dicts)
        stats["decoder_gap"] = decoder_gap(codec, first, root)
        stats["decode_ms_per_image"] = {
            "thermal": host_ms(lambda: codec.decode(blobs[paths[0]])),
            "rgb": host_ms(lambda: codec.decode(blobs[derive_rgb_path(paths[0])])),
        }
        log(f"nvJPEG decode ms per image: {stats['decode_ms_per_image']}")

        out_dir = os.path.join(root, "out")
        saved = []
        timing = TimingRecords()
        try:
            for method, yaml_name, seed, expect_k1 in (
                    ("thermal_only", "faster_rcnn_R_101_FLIR.yaml", 11, 1),
                    ("middle_fusion", "faster_rcnn_R_101_FLIR_middle_fusion.yaml", 12, 2)):
                cfg = get_cfg()
                cfg.merge_from_file(os.path.join(HERE, "configs", "FLIR-Detection", yaml_name))
                mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=False)
                batch = collate(mapper.map_batch(dicts[:BATCH]))
                mapper.close()
                model, mcfg, params = flir_model(cfg, seed, batch)
                direct = Predictor(model, mcfg).predict_batch(batch)
                t = time.time()
                path = flir.save_predictions(method, root, "", out_dir, batch_size=BATCH, cfg=cfg,
                                             params=params)
                save_s = time.time() - t
                saved.append(path)
                with open(path) as f:
                    app = json.load(f)
                for i, rec in enumerate(direct):  # the app's first batch vs predict_batch
                    if len(app["boxes"][i]) != len(rec["boxes"]) or not (
                            np.array_equal(np.asarray(app["classes"][i]), rec["classes"])
                            and np.allclose(np.asarray(app["boxes"][i]).reshape(-1, 4), rec["boxes"],
                                            atol=1e-4)
                            and np.allclose(app["scores"][i], rec["scores"], atol=1e-6)):
                        raise AssertionError(f"FLIR {method}: the app's detections of image {i} "
                                             "differ from Predictor.predict_batch's")
                zero_launch_counts()
                timing.records.clear()
                results = flir.evaluate_map(method, root, "", out_dir, batch_size=BATCH, cfg=cfg,
                                            params=params)
                launches = launch_counts("stem_pool", "roi_align_fwd", "image_io", *CHECKED)
                n_batches = -(-len(dicts) // BATCH)
                expect = {"stem_pool": expect_k1 * n_batches, "roi_align_fwd": n_batches,
                          "image_io": n_batches, **k4_expect(expect_k1 * n_batches), **k5_expect(n_batches)}
                log(f"FLIR {method}: launches {launches} over {n_batches} batches; "
                    f"bbox AP {results['bbox']['AP']:.3f}")
                expect_launches(f"FLIR {method} evaluate_map", launches, expect)
                if not np.isfinite(results["bbox"]["AP"]) or len(timing.records) != 1:
                    raise AssertionError(f"FLIR {method}: no mAP or no timing record")
                # end to end over the whole split, warm: evaluate_map's body
                # (loader, predict_batch, evaluator, evaluate()) on one set of
                # images, all 32 with no batch excluded, run three times
                pred = Predictor(model, mcfg)
                timing.records.clear()
                for _ in range(3):
                    mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=False)
                    try:
                        inference_on_dataset(pred, build_test_loader(dicts, mapper, batch_size=BATCH),
                                             FLIREvaluator(json_path, output_dir=out_dir), warmup=0)
                    finally:
                        mapper.close()
                def total_s(r):
                    return r["load_s"] + r["infer_s"] + r["process_s"] + r["evaluate_s"]

                runs = sorted(timing.records, key=total_s, reverse=True)
                if len(runs) != 3 or any(r["images"] != len(dicts) for r in runs):
                    raise AssertionError(f"FLIR {method}: timing records {runs}")
                rates = [r["images"] / total_s(r) for r in runs]
                tm, e2e = runs[1], rates[1]
                # model only: the mapped batch through Predictor.infer, pipelined
                for _ in range(2):
                    pred.infer(batch["image"], batch["image_size"], batch["orig_size"])
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(8):
                    pred.infer(batch["image"], batch["image_size"], batch["orig_size"])
                b.record()
                torch.cuda.synchronize()
                model_img_s = BATCH * 8 / (a.elapsed_time(b) / 1e3)
                stats[method] = dict(
                    eval_img_s=e2e, eval_img_s_min_max=[rates[0], rates[2]], model_img_s=model_img_s,
                    timing=tm, eval_window_s=sum(total_s(r) for r in runs),
                    share_outside_infer=1.0 - tm["infer_s"] / total_s(tm),
                    save_predictions_s=save_s,
                    launches=launches, batches=n_batches,
                    launches_per_batch={k: v // n_batches for k, v in launches.items()},
                    bbox=results["bbox"], dets_per_img=float(np.mean([len(r["scores"]) for r in direct])))
                log(f"FLIR {method}: eval {e2e:.2f} img/s end to end, median of 3 warm runs over "
                    f"the {len(dicts)} images (min {rates[0]:.2f}, max {rates[2]:.2f}; median run: load "
                    f"{tm['load_s']:.3f} s, infer {tm['infer_s']:.3f} s, process "
                    f"{tm['process_s']:.3f} s, evaluate {tm['evaluate_s']:.3f} s), model only "
                    f"{model_img_s:.2f} img/s")
                del model, pred, batch
        finally:
            timing.close()

        t = time.time()
        fused = flir.run_proben(root, out_dir, "probEn", "v-avg", out_dir, det_files=saved)
        stats["proben_ms_per_image"] = (time.time() - t) * 1e3 / len(dicts)
        if not np.isfinite(fused["bbox"]["AP"]):
            raise AssertionError("ProbEn over the saved JSONs gave no mAP")
        stats["proben_bbox_AP"] = fused["bbox"]["AP"]

        # the ground truth as detections: AP must be 100
        coco = COCODataset(json_path)
        ev = FLIREvaluator(coco)
        contig = coco.contiguous_category_mapping()
        for img_id in coco.image_ids:
            anns = coco.img_to_anns[img_id]
            xywh = np.array([a["bbox"] for a in anns], float).reshape(-1, 4)
            ev.process(img_id, np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], 1),
                       np.ones(len(anns)), np.array([contig[a["category_id"]] for a in anns]))
        oracle = ev.evaluate()["bbox"]
        log(f"FLIR ground-truth oracle: AP {oracle['AP']}, AP50 {oracle['AP50']}")
        if abs(oracle["AP"] - 100.0) > 1e-6:
            raise AssertionError(f"ground truth as detections gives AP {oracle['AP']}, not 100")
        stats["oracle_AP"] = oracle["AP"]
    row = kernels["BGR"]
    kernel = dict(name="image_io", route="cuda", source="proben_tpu_torch/csrc/image_io.cu",
                  replaces="native/proben_io.cpp:226", **row,
                  c6={k: kernels["BGRTTT"][k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err",
                                                        "mbytes")},
                  c4={k: kernels["BGRT"][k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err",
                                                      "mbytes")})
    stats["image_io"] = kernels
    return kernel, stats


# ---------------------------------------------------------------------------
# KAIST evaluation: detectron2 checkpoints in, LAMR out
# ---------------------------------------------------------------------------

KAIST_HW = (512, 640)  # KAIST visible and lwir frames (H, W)
BN_EPS = 1e-5


def d2_state_dict(params, pooler_resolution=7):
    """detectron2 names and layouts of a parameter pytree (numpy, the JAX
    package's layout): the inverse of ``checkpoint/torch_import.py``. Convs
    HWIO -> OIHW, linears (in, out) -> (out, in) with fc1's rows put back in
    torch's NCHW flatten order, each folded affine written as a BatchNorm
    with mean 0 and variance 1 - eps (folding it again may move a value by
    one float32 ulp)."""
    sd = {}

    def conv(key, p):
        sd[f"{key}.weight"] = np.array(np.transpose(p["w"], (3, 2, 0, 1)), order="C")
        if "b" in p:
            sd[f"{key}.bias"] = np.array(p["b"])

    def norm(key, p):
        c = p["scale"].shape[0]
        sd[f"{key}.weight"], sd[f"{key}.bias"] = np.array(p["scale"]), np.array(p["bias"])
        sd[f"{key}.running_mean"] = np.zeros(c, np.float32)
        sd[f"{key}.running_var"] = np.full(c, 1.0 - BN_EPS, np.float32)

    def linear(key, p, nchw_rows=False):
        w = np.asarray(p["w"])
        if nchw_rows:  # (P, P, C) rows -> (C, P, P) rows
            c = w.shape[0] // (pooler_resolution * pooler_resolution)
            w = w.reshape(pooler_resolution, pooler_resolution, c, -1).transpose(2, 0, 1, 3).reshape(w.shape)
        sd[f"{key}.weight"] = np.array(w.T, order="C")
        sd[f"{key}.bias"] = np.array(p["b"])

    def resnet(prefix, bb):
        conv(f"{prefix}.stem.conv1", bb["stem"]["conv1"])
        norm(f"{prefix}.stem.conv1.norm", bb["stem"]["norm1"])
        for stage in ("res2", "res3", "res4", "res5"):
            for b, blk in enumerate(bb[stage]):
                base = f"{prefix}.{stage}.{b}"
                for i in (1, 2, 3):
                    conv(f"{base}.conv{i}", blk[f"conv{i}"])
                    norm(f"{base}.conv{i}.norm", blk[f"norm{i}"])
                if "shortcut" in blk:
                    conv(f"{base}.shortcut", blk["shortcut"])
                    norm(f"{base}.shortcut.norm", blk["shortcut_norm"])

    def fpn(prefix, f):
        for i, (lat, out) in enumerate(zip(f["lateral"], f["output"])):
            conv(f"{prefix}.fpn_lateral{i + 2}", lat)
            conv(f"{prefix}.fpn_output{i + 2}", out)

    resnet("backbone.bottom_up", params["backbone"])
    fpn("backbone", params["fpn"])
    if "backbone_2" in params:
        resnet("backbone_2.bottom_up", params["backbone_2"])
        fpn("backbone_2", params["fpn_2"])
    for name, key in (("conv", "conv"), ("objectness", "objectness_logits"), ("deltas", "anchor_deltas")):
        conv(f"proposal_generator.rpn_head.{key}", params["rpn_head"][name])
    for i, fc in enumerate(params["roi"]["box_head"]["fcs"]):
        linear(f"roi_heads.box_head.fc{i + 1}", fc, nchw_rows=i == 0)
    for name, p in params["roi"]["output"].items():
        linear(f"roi_heads.box_predictor.{name}", p)
    return sd


def flat_tree(tree, prefix=""):
    """{path: leaf} of a pytree of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat_tree(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat_tree(sub, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def trees_equal(a, b) -> bool:
    fa, fb = flat_tree(a), flat_tree(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]) for k in fa)


def write_kaist_tree(codec, root, n=32, seed=2):
    """A KAIST-shaped test tree: ``setXX/VYYY/{lwir,visible}/IZZZZZ.jpg``,
    both 640x512 colour JPEGs (nvJPEG, quality 90; the lwir file's three
    channels differ, so a wrong channel choice shows), the first half of
    the frames in sets 06-08 (day) and the second in 09-11 (night); the
    annotation JSON (``im_name``, persons 30-200 px high on both sides of
    55, occlusion 0/1/2, ignore flags, one non-person box) with boxes in
    separate 128-px columns, so no two overlap; and the split file.
    Returns (annotation path, split path, split lines)."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, w = KAIST_HW
    lines, images, annotations = [], [], []
    for i in range(n):
        s = ((6, 7, 8) if i < n // 2 else (9, 10, 11))[i % 3]
        v = i % 2
        boxes = []
        for col in rng.permutation(5)[: rng.randint(1, 5)]:
            bh = float(rng.choice([30, 45, 60, 90, 150, 200]))
            bw = round(bh * 0.41, 1)
            x0, y0 = float(col * 128 + rng.randint(0, 127 - int(bw))), float(rng.randint(0, h - int(bh)))
            boxes.append((x0, y0, bw, bh))
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1,
                                "category_id": 2 if not annotations else 1, "bbox": [x0, y0, bw, bh],
                                "height": bh, "occlusion": int(rng.choice([0, 0, 1, 2])),
                                "ignore": int(rng.rand() < 0.1)})
        for mod in ("lwir", "visible"):
            d = os.path.join(root, f"set{s:02d}", f"V{v:03d}", mod)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"I{i:05d}.jpg"), "wb") as f:
                f.write(codec.encode(flir_scene(gen, h, w, boxes, 3, 1.0, 1.0), quality=90))
        lines.append(f"set{s:02d}/V{v:03d}/I{i:05d}")
        images.append({"id": i + 1, "im_name": f"set{s:02d}_V{v:03d}_I{i:05d}_lwir.png", "height": h, "width": w})
    ann, split = os.path.join(root, "KAIST_annotation.json"), os.path.join(root, "test-all-20.txt")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "cyclist"}]}, f)
    with open(split, "w") as f:
        f.write("\n".join(lines) + "\n")
    return ann, split, lines


def check_kaist_frames(codec, root, rel):
    """KAIST's visible and lwir frames have one size, so the uint8 RGB
    resize in ``image_io`` runs at scale 1: the composed frame must be the
    decoded visible pixels, then lwir channel 0 (BGRT) or all three
    (BGRTTT), bit for bit, edges included, and the kernel must equal its
    plain version there and at the model's size."""
    from proben_tpu_torch.apps.kaist import kaist_files
    from proben_tpu_torch.native import io

    lwir, visible = kaist_files(root, rel, "middle_fusion")
    t = codec.decode(open(lwir, "rb").read())
    r = codec.decode(open(visible, "rb").read())
    torch.cuda.synchronize()
    if t.shape != (*KAIST_HW, 3) or r.shape != (*KAIST_HW, 3):
        raise AssertionError(f"KAIST frames decode to {tuple(t.shape)} and {tuple(r.shape)}")
    for fmt, thermal in (("BGRT", t[..., :1]), ("BGRTTT", t)):
        frame = io.compose_resize_pad([t], [r], fmt, [KAIST_HW], KAIST_HW)[0]
        want = torch.cat([r, thermal], -1).float()
        if not torch.equal(frame, want):
            raise AssertionError(f"image_io {fmt} at scale 1: max |err| {float((frame - want).abs().max())}")
        for size, pad in ((KAIST_HW, KAIST_HW), (TRUE_HW, (H, W))):
            got = io.compose_resize_pad([t], [r], fmt, [size], pad)
            ref = io.compose_resize_pad_plain([t], [r], fmt, [size], pad)
            if not torch.equal(got, ref):
                raise AssertionError(f"image_io {fmt} at {size}: kernel differs from its plain version")
    if torch.equal(t[..., 0], t[..., 1]):
        raise AssertionError("the synthetic lwir channels are equal: the channel check has no power")
    log("KAIST frames: image_io at scale 1 is the identity, thermal channels as the JAX app takes them")


def check_kaist_batch(codec, dicts, fmt, batch):
    """The batch the app maps (nvJPEG, then one ``image_io`` launch for all
    its frames) must equal the plain version of ``image_io`` on the same
    decoded files, at the method's format and the model's size, bit for
    bit: thermal_only and rgb_only read a 3-channel file as BGR, middle
    fusion composes the visible file with the lwir one."""
    from proben_tpu_torch.native import io

    def decoded(path):
        with open(path, "rb") as f:
            return codec.decode(f.read())

    thermal = [decoded(d["file_name"]) for d in dicts]
    rgb = [decoded(d["rgb_file"]) for d in dicts] if fmt != "BGR" else None
    want = io.compose_resize_pad_plain(thermal, rgb, fmt, [TRUE_HW] * len(dicts), (H, W))
    sizes = batch["image_size"].cpu().numpy()
    if not (sizes == np.array(TRUE_HW)).all():
        raise AssertionError(f"KAIST {fmt}: the mapped batch's sizes {sizes.tolist()}, expected {TRUE_HW}")
    if not torch.equal(batch["image"], want):
        err = float((batch["image"] - want).abs().max())
        raise AssertionError(f"KAIST {fmt}: the mapped batch of {len(dicts)} differs from image_io's plain "
                             f"version by {err}")


def kaist_phase(card):
    """KAIST evaluation from detectron2 files on a synthetic test tree (32
    frames at the KAIST size): for thermal_only, rgb_only and middle_fusion
    (``build_kaist_cfg``: R101, 1 class, the variance head, here in bf16,
    batch 8, 640x512 -> 800x1000 padded to 800x1024) the first mapped batch
    held against ``image_io``'s plain version, a calibrated random model
    written as a detectron2 ``.pth`` and ``.pkl`` (``d2_state_dict``),
    loaded back with ``load_params``, run through ``predict_split`` (det txt,
    variance npz) and scored by LAMR; the ground truth as detections;
    ProbEn over the three; a ``CheckpointManager`` round trip; thermal_only
    once more as the app ships it (float32, no K1); readings."""
    import tempfile
    import pickle

    from proben_tpu_torch.apps import kaist
    from proben_tpu_torch.apps.flir import load_params
    from proben_tpu_torch.checkpoint import CheckpointManager, restore_pytree, save_pytree
    from proben_tpu_torch.config import mapper_config_from_cfg, model_config_from_cfg
    from proben_tpu_torch.data import DatasetMapper, collate
    from proben_tpu_torch.engine import Predictor
    from proben_tpu_torch.evaluation import KAISTEvaluator, load_detections_txt
    from proben_tpu_torch.models import build_model, init_rcnn
    from proben_tpu_torch.native import io

    stats = {"card": card}
    with tempfile.TemporaryDirectory(prefix="kaist_") as root, io.JpegCodec() as codec:
        ann, split, lines = write_kaist_tree(codec, root)
        frames = list(range(1, len(lines) + 1))
        check_kaist_frames(codec, root, lines[0])
        n_batches = -(-len(lines) // BATCH)
        runs = {}
        for method, seed, k1 in (("thermal_only", 21, 1), ("rgb_only", 22, 1), ("middle_fusion", 23, 2)):
            cfg = kaist.build_kaist_cfg(method)  # get_cfg's float32 compute, as in the JAX app
            cfg.MODEL.COMPUTE_DTYPE = "bfloat16"  # as configs/Base-RCNN-FPN.yaml (K1 is bf16 only)
            dicts = kaist.kaist_dicts(root, lines[:BATCH], method)
            mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=False)
            try:
                batch = collate(mapper.map_batch(dicts))
                load_ms = host_ms(lambda: mapper.map_batch(dicts), reps=3)
            finally:
                mapper.close()
            check_kaist_batch(codec, dicts, cfg.INPUT.FORMAT, batch)
            model, mcfg, source = flir_model(cfg, seed, batch)
            del model
            sd = d2_state_dict(source)
            pth, pkl = os.path.join(root, f"{method}.pth"), os.path.join(root, f"{method}.pkl")
            torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
            with open(pkl, "wb") as f:
                pickle.dump({"model": sd}, f)
            params = load_params(cfg, pth)
            if not trees_equal(params, load_params(cfg, pkl)):
                raise AssertionError(f"KAIST {method}: the .pth and .pkl imports differ")
            fp, fs = flat_tree(params), flat_tree(source)
            rel = max(float(np.max(np.abs(fp[k] - fs[k]) / np.maximum(np.abs(fs[k]), 1e-30))) for k in fs)
            if fp.keys() != fs.keys() or rel > 1e-6:
                raise AssertionError(f"KAIST {method}: imported parameters off the source by {rel} relative")

            zero_launch_counts()
            out_txt, var_npz = os.path.join(root, f"{method}_dets.txt"), os.path.join(root, f"{method}_vars.npz")
            results = kaist.predict_split(method, root, split, params, cfg=cfg, out_txt=out_txt,
                                          var_npz=var_npz, batch_size=BATCH)
            launches = launch_counts("stem_pool", "roi_align_fwd", "image_io", *CHECKED)
            expect = {"stem_pool": k1 * n_batches, "roi_align_fwd": n_batches, "image_io": n_batches,
                      **k4_expect(k1 * n_batches), **k5_expect(n_batches)}
            expect_launches(f"KAIST {method} predict_split", launches, expect)
            if sorted(results) != frames:
                raise AssertionError(f"KAIST {method}: results for frames {sorted(results)}")

            pred = Predictor(build_model(mcfg, params=params), mcfg)
            direct = pred.predict_batch({**batch, "num_real": BATCH})
            for rec in direct:  # the app's first batch vs predict_batch on the same mapped batch
                app = results[rec["image_id"]]
                if not all(np.array_equal(app[k], rec[k]) for k in ("boxes", "scores", "classes", "vars")):
                    raise AssertionError(f"KAIST {method}: the app's detections of frame {rec['image_id']} "
                                         "differ from Predictor.predict_batch's")
            loaded = load_detections_txt(out_txt, frames)
            for frame, rec in results.items():
                b = rec["boxes"].copy()
                b[:, 2:] -= b[:, :2]
                want = np.concatenate([b, rec["scores"][:, None]], 1).astype(float)
                if not np.array_equal(loaded.get(frame, np.zeros((0, 5))).reshape(-1, 5), want):
                    raise AssertionError(f"KAIST {method}: the det txt of frame {frame} differs from the results")
            with np.load(var_npz) as z:
                if sorted(z.files, key=int) != [str(f) for f in frames]:
                    raise AssertionError(f"KAIST {method}: variance npz keys {z.files}")
            ev = KAISTEvaluator(ann)
            lamr = ev.evaluate_all_conditions(kaist.results_to_lamr_dets(results, ev.image_ids))
            if not all(0.0 <= lamr[f"lamr_{c}"] <= 100.0 for c in ("all", "day", "night")):
                raise AssertionError(f"KAIST {method}: LAMR {lamr}")
            dets = float(np.mean([len(r["scores"]) for r in results.values()]))
            log(f"KAIST {method}: {dets:.1f} dets/frame, launches {launches} over {n_batches} batches, "
                f"LAMR all/day/night {lamr['lamr_all']:.2f}/{lamr['lamr_day']:.2f}/{lamr['lamr_night']:.2f}")
            runs[method] = dict(cfg=cfg, mcfg=mcfg, params=params, results=results, pred=pred, batch=batch, pth=pth)
            stats[method] = dict(launches=launches, batches=n_batches,
                                 launches_per_batch={k: v // n_batches for k, v in launches.items()},
                                 lamr=lamr, dets_per_frame=dets, load_ms_per_batch=load_ms)

        # the ground truth as detections: LAMR 0 wherever there is real ground truth
        ev = KAISTEvaluator(ann)
        with open(ann) as f:
            anns = json.load(f)["annotations"]
        gt = {}
        for a in anns:
            gt.setdefault(a["image_id"], []).append(list(a["bbox"]) + [1.0])
        oracle = ev.evaluate_all_conditions({k: np.asarray(v) for k, v in gt.items()})
        if not all(0.0 <= oracle[f"lamr_{c}"] <= 1e-6 for c in ("all", "day", "night")):
            raise AssertionError(f"KAIST ground truth as detections: LAMR {oracle}, not 0")
        stats["oracle"] = oracle
        fused = kaist.run_kaist_proben([runs[m]["results"] for m in runs], ann, "probEn", "v-avg")
        if not all(np.isfinite(fused[f"lamr_{c}"]) for c in ("all", "day", "night")):
            raise AssertionError(f"KAIST ProbEn: LAMR {fused}")
        stats["proben_lamr"] = fused

        # checkpoint round trip of the imported middle-fusion parameters
        mf = runs["middle_fusion"]
        mgr = CheckpointManager(os.path.join(root, "ckpt"), higher_is_better=False)
        if not mgr.save_best(0, stats["middle_fusion"]["lamr"]["lamr_all"], mf["params"]):
            raise AssertionError("CheckpointManager: the first metric is not the best")
        template = init_rcnn(0, mf["mcfg"])
        restored = mgr.restore_best(template)
        if not (trees_equal(restored, mf["params"])
                and trees_equal(load_params(mf["cfg"], os.path.join(root, "ckpt", "best")), mf["params"])):
            raise AssertionError("CheckpointManager: the restored parameters differ")
        again = kaist.predict_split("middle_fusion", root, split, restored, cfg=mf["cfg"], batch_size=BATCH)
        for frame, rec in mf["results"].items():
            if not all(np.array_equal(again[frame][k], rec[k]) for k in ("boxes", "scores", "classes", "vars")):
                raise AssertionError(f"KAIST middle_fusion: frame {frame} differs after the checkpoint round trip")
        ck = os.path.join(root, "timed")
        stats["checkpoint_ms"] = {"save": host_ms(lambda: save_pytree(ck, mf["params"]), reps=3),
                                  "restore": host_ms(lambda: restore_pytree(ck, template), reps=3),
                                  "mbytes": sum(v.nbytes for v in flat_tree(mf["params"]).values()) / 1e6}
        stats["load_params_ms_r101_pth"] = host_ms(
            lambda: load_params(runs["thermal_only"]["cfg"], runs["thermal_only"]["pth"]), reps=3)
        log(f"KAIST ground truth LAMR {oracle}; ProbEn {fused}; checkpoint {stats['checkpoint_ms']}; "
            f"load_params (R101 .pth) {stats['load_params_ms_r101_pth']:.1f} ms")

        # the app as it ships: build_kaist_cfg keeps get_cfg's float32, so
        # the stem runs its plain composition (K1 is bf16 only)
        t_bf16 = runs["thermal_only"]
        cfg32 = kaist.build_kaist_cfg("thermal_only")
        mcfg32 = model_config_from_cfg(cfg32)
        zero_launch_counts()
        res32 = kaist.predict_split("thermal_only", root, split, t_bf16["params"], cfg=cfg32, batch_size=BATCH)
        launches = launch_counts("stem_pool", "roi_align_fwd", "image_io", *CHECKED)
        expect = {"stem_pool": 0, "roi_align_fwd": n_batches, "image_io": n_batches,
                  **k4_expect(n_batches, float32=True), **k5_expect(n_batches)}
        expect_launches("KAIST thermal_only, float32, predict_split", launches, expect)
        if sorted(res32) != frames or not all(np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()
                                              for r in res32.values()):
            raise AssertionError("KAIST thermal_only, float32: missing frames or values that are not finite")
        lamr32 = ev.evaluate_all_conditions(kaist.results_to_lamr_dets(res32, ev.image_ids))
        agree = match_fraction([res32[f] for f in frames], [t_bf16["results"][f] for f in frames])
        stats["thermal_only_f32"] = dict(
            launches=launches, batches=n_batches, launches_per_batch={k: v // n_batches for k, v in launches.items()},
            lamr=lamr32, dets_per_frame=float(np.mean([len(r["scores"]) for r in res32.values()])),
            match_fraction_vs_bf16=agree, load_ms_per_batch=stats["thermal_only"]["load_ms_per_batch"])
        runs["thermal_only_f32"] = dict(cfg=cfg32, mcfg=mcfg32, params=t_bf16["params"], batch=t_bf16["batch"],
                                        pred=Predictor(build_model(mcfg32, params=t_bf16["params"]), mcfg32))
        log(f"KAIST thermal_only as shipped (float32): launches {launches} over {n_batches} batches, "
            f"{stats['thermal_only_f32']['dets_per_frame']:.1f} dets/frame, {agree:.3f} of them match the "
            f"bf16 run's, LAMR all {lamr32['lamr_all']:.2f}")

        # end to end: predict_split (model build, loading, inference) and
        # LAMR over all 32 frames, warm, three times
        for label in ("thermal_only", "middle_fusion", "thermal_only_f32"):
            r, method = runs[label], label.replace("_f32", "")

            def once():
                t = time.perf_counter()
                res = kaist.predict_split(method, root, split, r["params"], cfg=r["cfg"], batch_size=BATCH)
                e = KAISTEvaluator(ann)
                t_lamr = time.perf_counter()
                e.evaluate_all_conditions(kaist.results_to_lamr_dets(res, e.image_ids))
                end = time.perf_counter()
                return end - t, end - t_lamr

            once()
            times = sorted(once() for _ in range(3))
            rates = [len(lines) / t for t, _ in times]
            build_ms = host_ms(lambda: Predictor(build_model(r["mcfg"], params=r["params"]), r["mcfg"]), reps=3)
            pred, b = r["pred"], r["batch"]
            for _ in range(2):
                pred.infer(b["image"], b["image_size"], b["orig_size"])
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(8):
                pred.infer(b["image"], b["image_size"], b["orig_size"])
            ev1.record()
            torch.cuda.synchronize()
            model_img_s = BATCH * 8 / (ev0.elapsed_time(ev1) / 1e3)
            stats[label].update(eval_img_s=rates[1], eval_img_s_min_max=[rates[2], rates[0]],
                                eval_s=times[1][0], lamr_s=times[1][1], model_build_ms=build_ms,
                                model_img_s=model_img_s)
            log(f"KAIST {label}: eval {rates[1]:.2f} img/s end to end, median of 3 warm runs over the "
                f"{len(lines)} frames (min {rates[2]:.2f}, max {rates[0]:.2f}; run {times[1][0]:.3f} s: model "
                f"build {build_ms:.1f} ms, load {stats[label]['load_ms_per_batch']:.1f} ms per batch, LAMR "
                f"{times[1][1] * 1e3:.1f} ms), model only {model_img_s:.2f} img/s")
        del runs
    return stats


# ---------------------------------------------------------------------------
# The trainer: training augmentation on the card, TrainLoader, DefaultTrainer
# ---------------------------------------------------------------------------

TRAIN_BATCH = 16  # SOLVER.IMS_PER_BATCH of configs/Base-RCNN-FPN.yaml
TRAIN_STEPS = 12  # per training app run; its rates are medians of the last 10 steps
COUNTED = ("stem_pool", "roi_align_fwd", "roi_align_bwd", "image_io")
# counts read on every path and checked by ``check_counts``, which logs a
# miss and lets the run go on: K4's launches (``block_epilogue``), forward
# and backward, the bottleneck epilogues that ran as the plain composition
# on CUDA maps, and K5's launches (``nms``, one a ``nms_mask`` call)
CHECKED = ("block_epilogue", "epilogue_plain", "nms")


# each counted kernel's launch counter in ``proben_tpu_torch.utils.tracing``
LAUNCH_COUNTERS = {"stem_pool": "k1.launches", "roi_align_fwd": "k2.launches",
                   "roi_align_bwd": "k3.launches", "image_io": "io.launches",
                   "block_epilogue": "k4.launches", "epilogue_plain": "epilogue.plain",
                   "nms": "k5.launches"}
_launch_base: dict = {}


def launch_counts(*kernels):
    """Launches of each counted kernel and the ``CHECKED`` counts (or of
    ``kernels`` alone) since the last ``zero_launch_counts``."""
    from proben_tpu_torch.utils import tracing

    now = tracing.counters()
    return {k: now.get(LAUNCH_COUNTERS[k], 0) - _launch_base.get(k, 0)
            for k in kernels or COUNTED + CHECKED}


def zero_launch_counts():
    from proben_tpu_torch.utils import tracing

    now = tracing.counters()
    _launch_base.update({k: now.get(c, 0) for k, c in LAUNCH_COUNTERS.items()})


R101_BLOCKS = (3, 4, 23, 3)  # bottleneck blocks of res2..res5
COUNT_MISSES: list = []  # every path whose K4 or K5 counts differ from those expected


def k4_expect(forwards=1, train_freeze_at=None, float32=False):
    """K4's counts on a path of R101 backbones: three epilogues a
    bottleneck block in each backbone forward (``forwards``, K1's launches
    on a bf16 path; C4 runs res5 on its RoIs, the same 33 blocks), and
    with ``train_freeze_at`` three backward launches more a forward for
    each block of the stages it leaves trainable (2: res3-res5, 90; 3:
    res4-res5, 78). A float32 path runs every forward epilogue as the
    plain composition and launches K4 not at all."""
    fwd = 3 * sum(R101_BLOCKS) * forwards
    if float32:
        return {"block_epilogue": 0, "epilogue_plain": fwd}
    bwd = 0 if train_freeze_at is None else \
        3 * sum(R101_BLOCKS[max(train_freeze_at - 1, 0):]) * forwards
    return {"block_epilogue": fwd + bwd, "epilogue_plain": 0}


def k5_expect(inferences=0, steps=0):
    """K5's launches on a path of ``inferences`` Faster R-CNN forwards in
    evaluation (the RPN's NMS and the box head's) and ``steps`` training
    steps (the RPN's); a middle-fusion forward runs one RPN on the
    concatenated maps."""
    return {"nms": 2 * inferences + steps}


def check_counts(label, got, want):
    """The ``CHECKED`` counts ``want`` names (K4's two from ``k4_expect``,
    K5's launches, one a ``nms_mask`` call) on a path: a difference is
    logged and kept in ``COUNT_MISSES``; ``main`` fails on it once every
    path has run, so one run names every path that missed."""
    got = {k: got.get(k, 0) for k in CHECKED if k in want}
    want = {k: want[k] for k in CHECKED if k in want}
    if got != want:
        log(f"{label}: K4 / K5 counts {got}, expected {want}")
        COUNT_MISSES.append(dict(path=label, got=got, expected=want))


def k4_off():
    """A context in which every bottleneck epilogue takes the plain
    composition (K4 off): the plain side of a comparison."""
    from unittest import mock

    from proben_tpu_torch.ops import epilogue_cuda

    return mock.patch.object(epilogue_cuda, "kernel_takes", lambda *a: False)


def write_flir_train_tree(codec, root, n=64, n_val=32, seed=5):
    """``write_flir_tree`` with ``n`` pairs; the train JSON lists all of
    them, the val JSON the first ``n_val``."""
    from proben_tpu_torch.apps.flir import TRAIN_JSON_NAME

    json_path, _, sizes = write_flir_tree(codec, root, n=n, seed=seed)
    with open(json_path) as f:
        js = json.load(f)
    with open(os.path.join(root, TRAIN_JSON_NAME), "w") as f:
        json.dump(js, f)
    keep = {im["id"] for im in js["images"][:n_val]}
    with open(json_path, "w") as f:
        json.dump(dict(js, images=js["images"][:n_val],
                       annotations=[a for a in js["annotations"] if a["image_id"] in keep]), f)
    return sizes


def decoded_files(codec, dicts, fmt):
    """nvJPEG decodes of the dicts' thermal files and (fused formats) their
    RGB files."""
    from proben_tpu_torch.data import derive_rgb_path

    def dec(path):
        with open(path, "rb") as f:
            return codec.decode(f.read())

    thermal = [dec(d["file_name"]) for d in dicts]
    rgb = None if fmt == "BGR" else [dec(d.get("rgb_file") or derive_rgb_path(d["file_name"]))
                                     for d in dicts]
    return thermal, rgb


def check_train_mapper(codec, cfg, dicts, seed):
    """One training batch of ``TRAIN_BATCH`` FLIR files through
    ``DatasetMapper(is_train=True)`` on the card: exactly one ``image_io``
    launch; sizes and flips equal to ``TrainAugment``'s draws from
    ``RandomState(seed)`` in order, at least one image flipped and one not;
    the canvas equal to ``compose_resize_pad_plain`` on the same decoded
    pixels, sizes and flips, bit for bit (the kernel's float operations are
    rounded one by one in the plain version's order; the flip only moves
    values); the GT arrays equal to the CPU mapper's for the same draws
    (cv2's read, the port's and the JAX package's numpy box arithmetic),
    exactly. Then the kernel timed at these shapes, with its bound."""
    from proben_tpu_torch.config import mapper_config_from_cfg
    from proben_tpu_torch.data import DatasetMapper, collate
    from proben_tpu_torch.data.transforms import TrainAugment
    from proben_tpu_torch.native import io

    mcfg = mapper_config_from_cfg(cfg)
    fmt, pad = mcfg.input_format, tuple(mcfg.pad_shape)
    mapper = DatasetMapper(mcfg, is_train=True, seed=seed)
    try:
        zero_launch_counts()
        batch = collate(mapper.map_batch(dicts))
        torch.cuda.synchronize()
        one_launch = launch_counts()["image_io"]
        map_ms = host_ms(lambda: mapper.map_batch(dicts), reps=3)
    finally:
        mapper.close()
    if one_launch != 1:
        raise AssertionError(f"train mapper {fmt}: {one_launch} image_io launches for one batch")
    aug = TrainAugment(mcfg.min_size_train, mcfg.max_size_train, mcfg.flip, np.random.RandomState(seed))
    draws = [aug.draw(*FLIR_T_HW) for _ in dicts]
    sizes, flips = [d[:2] for d in draws], [d[2] for d in draws]
    if batch["image_size"].cpu().numpy().tolist() != [list(x) for x in sizes] \
            or batch["flip"].tolist() != flips:
        raise AssertionError(f"train mapper {fmt}: sizes or flips are not TrainAugment's draws")
    if all(flips) or not any(flips) or len(set(sizes)) < 2:
        raise AssertionError(f"train mapper {fmt}: the batch needs flipped and unflipped images "
                             f"and two sizes ({flips}, {sizes})")
    thermal, rgb = decoded_files(codec, dicts, fmt)
    want = io.compose_resize_pad_plain(thermal, rgb, fmt, sizes, pad, flips)
    err = float((batch["image"] - want).abs().max())
    if not torch.equal(batch["image"], want):
        raise AssertionError(f"train mapper {fmt}: canvas differs from the plain version by {err}")
    cpu = collate(DatasetMapper(mcfg, is_train=True, seed=seed, device="cpu").map_batch(dicts))
    gt_equal = all(torch.equal(getattr(cpu["gt"], k), getattr(batch["gt"], k).cpu())
                   for k in ("boxes", "classes", "valid"))
    if not gt_equal or not torch.equal(cpu["image_size"], batch["image_size"].cpu()) \
            or cpu["flip"].tolist() != flips:
        raise AssertionError(f"train mapper {fmt}: GT, sizes or flips differ from the CPU mapper's")
    ms = cuda_ms(lambda: io.compose_resize_pad(thermal, rgb, fmt, sizes, pad, flips), 30)
    plain_ms = cuda_ms(lambda: io.compose_resize_pad_plain(thermal, rgb, fmt, sizes, pad, flips), 3)
    nbytes = want.numel() * 4 + sum(x.numel() for x in thermal) + (
        sum(rgb_rows_read(x.shape[0], t.shape[0]) * x.shape[1] * x.shape[2]
            for x, t in zip(rgb, thermal)) if rgb is not None else 0)
    bound = nbytes / HBM_BYTES_S * 1e3
    log(f"train mapper {fmt}: batch of {len(dicts)} equal to the plain version (flipped "
        f"{sum(flips)}, sizes {sorted(set(sizes))}), GT equal to the CPU mapper's; image_io with "
        f"flips {ms:.4g} ms (plain {plain_ms:.4g}, bound {bound:.4g} ms, {ms / bound:.1f}x); "
        f"map_batch {map_ms:.1f} ms host")
    return batch, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                       mbytes=nbytes / 1e6, flipped=int(sum(flips)), map_ms_per_batch=map_ms,
                       launches_per_batch=one_launch)


def check_train_loader(codec, cfg, dicts, seed, n=3, workers=4):
    """``TrainLoader`` on the card with ``workers`` threads (each maps on
    its own stream with its own nvJPEG codec): ``n`` batches taken while
    the consumer's stream is busy; each equal bit for bit to the plain
    version on its own indices, sizes and flips (the draws of several
    workers interleave, as in the JAX package, so they are read from the
    batch, not replayed)."""
    from proben_tpu_torch.config import mapper_config_from_cfg
    from proben_tpu_torch.data import DatasetMapper, TrainLoader
    from proben_tpu_torch.native import io

    mcfg = mapper_config_from_cfg(cfg)
    fmt, pad = mcfg.input_format, tuple(mcfg.pad_shape)
    loader = TrainLoader(dicts, DatasetMapper(mcfg, is_train=True, seed=seed), TRAIN_BATCH,
                         seed=seed, num_workers=workers)
    x = torch.randn(4096, 4096, device="cuda")
    seen = []
    try:
        for _ in range(n):
            for _ in range(30):  # ~0.1 s of queued work on the consumer's stream
                x = torch.tanh(x @ x.T * 1e-3)
            batch = next(loader)
            chosen = [dicts[i] for i in batch["indices"]]
            thermal, rgb = decoded_files(codec, chosen, fmt)
            sizes = [tuple(v) for v in batch["image_size"].cpu().numpy().tolist()]
            want = io.compose_resize_pad_plain(thermal, rgb, fmt, sizes, pad, batch["flip"].tolist())
            if not torch.equal(batch["image"], want):
                raise AssertionError(f"TrainLoader {fmt}, {workers} workers: a batch differs from the "
                                     "plain version of its own indices and draws")
            seen.append(batch["indices"])
    finally:
        loader.close()
    log(f"TrainLoader {fmt}, {workers} workers: {n} batches equal to their plain versions")
    return {"workers": workers, "batches": n, "indices": seen}


def d2_weights(cfg, seed, path, var_scale=0.01):
    """A detectron2 ``.pth`` of the config's model with random affines (so
    every residual branch is live and every trainable tensor gets a
    gradient), for ``MODEL.WEIGHTS``. A variance head's weights are scaled
    by ``var_scale``, so that its log-variances start near 0 as a trained
    head's do: at the random init's scale (``var_scale`` 1) they reach
    several units, the Gaussian NLL's 1 / variance then amplifies the
    FPN's gradient, and KAIST's run (the RoI heads frozen, so the head
    cannot adapt) can diverge to NaN within 12 steps, with its kernels and
    with their plain versions alike (``kaist_divergence_probe``)."""
    from proben_tpu_torch.config import model_config_from_cfg
    from proben_tpu_torch.models import init_rcnn, random_affines

    params = random_affines(init_rcnn(seed, model_config_from_cfg(cfg)), seed)
    var_pred = params["roi"]["output"].get("var_pred")
    if var_pred is not None:
        var_pred["w"] = var_pred["w"] * var_scale
    sd = d2_state_dict(params)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    return path


class TrainWatch:
    """Hooks registered after a training app's keep-best evaluation. They
    count K1-K3 around iteration ``count_iter``, record each step's metrics,
    the live model's detections on ``eval_batch`` whenever the evaluation
    has just saved a best, the peak memory, and at the end check the frozen
    and trainable tensors, snapshot the final state and, with
    ``hold_batch``, take one more batch from the trainer's loader and keep
    it with the model, its state and its step function for
    ``held_batch_checks``, which run after the launch counts are read.
    ``expect_state``: a state the trainer must start from (a resume), bit
    for bit. ``every_step``: count K1-K3 around every step as well
    (``per_step``), ``count_iter``'s among them."""

    def __init__(self, count_iter, eval_batch=None, hold_batch=False, expect_state=None, every_step=False):
        self.count_iter, self.eval_batch, self.hold_batch = count_iter, eval_batch, hold_batch
        self.expect_state, self.every_step = expect_state, every_step
        self.metrics, self.best_dets, self.launches, self.per_step = [], {}, None, []

    def hooks(self):
        from proben_tpu_torch.engine import CallbackHook

        return [CallbackHook(before_train=self.before_train, before_step=self.before_step,
                             after_step=self.after_step, after_train=self.after_train)]

    def before_train(self, t):
        from proben_tpu_torch.checkpoint import train_state_tree

        self.start_iter, self.max_iter, self.loader = t.start_iter, t.max_iter, t.train_loader
        if self.expect_state is not None:
            got = train_state_tree(t.state)
            want = self.expect_state
            same = got["step"] == want["step"] and got["seed"] == want["seed"] and all(
                torch.equal(got[k][n], want[k][n].to(got[k][n].device))
                for k in ("params", "momentum") for n in want[k])
            if not same:
                raise AssertionError("the resumed trainer's state differs from the checkpointed one")
        params = dict(t.model.named_parameters())
        self.frozen = {n: p.detach().clone() for n, p in params.items() if not p.requires_grad}
        self.start = {n: p.detach().clone() for n, p in params.items() if p.requires_grad}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def before_step(self, t):
        if t.iter == self.count_iter or self.every_step:
            torch.cuda.synchronize()
            self._counts = launch_counts()

    def _record_best(self, t):
        from proben_tpu_torch.engine import Predictor

        meta = t.checkpointer._read_meta()
        if self.eval_batch is not None and meta.get("best_step") == t.iter and t.iter not in self.best_dets:
            try:
                self.best_dets[t.iter] = Predictor(t.model, t.model_cfg).predict_batch(self.eval_batch)
            finally:
                t.model.train()

    def after_step(self, t):
        if t.iter == self.count_iter or self.every_step:
            torch.cuda.synchronize()
            now = launch_counts()
            step = {k: now[k] - self._counts[k] for k in ("stem_pool", "roi_align_fwd", "roi_align_bwd")
                    + CHECKED}
            self.per_step.append(step)
            if t.iter == self.count_iter:
                self.launches = step
        self.metrics.append({k: v for k, (v, _) in t.storage.latest().items()})
        self._record_best(t)

    def after_train(self, t):
        from proben_tpu_torch.checkpoint import train_state_tree

        self._record_best(t)
        torch.cuda.synchronize()
        self.peak_gb = torch.cuda.max_memory_allocated() / 1e9
        params = dict(t.model.named_parameters())
        changed = [n for n, v in self.frozen.items() if not torch.equal(params[n], v)]
        self.unmoved = [n for n, v in self.start.items() if torch.equal(params[n].detach(), v)]
        self.trainable_groups = sorted({n.split(".")[0] for n in self.start})
        if changed:
            raise AssertionError(f"{len(changed)} frozen tensors changed, e.g. {changed[:3]}")
        self.n_frozen, self.n_trainable = len(self.frozen), len(self.start)
        del self.frozen, self.start
        self.final = {k: ({n: v.detach().cpu().clone() for n, v in tree.items()}
                          if isinstance(tree, dict) else tree)
                      for k, tree in train_state_tree(t.state).items()}
        self.iter = t.iter
        if self.hold_batch:
            batch = next(t.train_loader)
            self.held = {"image": batch["image"], "image_size": batch["image_size"], "gt": batch["gt"]}
            self.model, self.model_cfg, self.step_fn, self.state = (t.model, t.model_cfg, t._train_step,
                                                                    t.state)


def eval_runs(start, max_iter, period):
    """How often ``EvalHook`` evaluates in a run from ``start`` to
    ``max_iter``: after each iteration ``it`` with (it + 1) % period == 0
    but the last, and once at the end."""
    return sum((it + 1) % period == 0 and it != max_iter - 1 for it in range(start, max_iter)) + 1


def model_stem_check(model, cfg, images):
    """K1 against its plain version (``check_stem``) on the normalized
    ``images`` (N, H, W, C) raw into each stream's stem, with the model's
    stem weights: the largest error."""
    from proben_tpu_torch.models import rcnn

    x = rcnn.preprocess(cfg, images)
    streams = [(model.backbone, x[..., :3]), (model.backbone_2, x[..., 3:])] if cfg.dual \
        else [(model.backbone, x)]
    errs = []
    for bb, xs in streams:
        st = bb.stem
        errs.append(check_stem(xs.to(cfg.dtype).contiguous(),
                               st.conv1.weight.permute(2, 3, 1, 0).to(cfg.dtype).contiguous(),
                               st.norm1.scale.to(cfg.dtype), st.norm1.bias.to(cfg.dtype)))
    return max(errs)


def held_batch_checks(watch, label, stem, bare_steps=6):
    """After a training app's run (its launch counts read): K1 (when the
    path launches it), K2 and K3 against their plain versions on the
    inputs of one step on ``watch``'s batch of ``TRAIN_BATCH`` from the
    trainer's own loader, with the trainer's model at its last iteration:
    the normalized images into each stream's stem (``check_stem``), the
    FPN maps and the RoIs ``label_and_sample_proposals`` samples for the
    batch (``check_roi``, and ``check_bwd`` with a seeded cotangent of
    the maps' type), and K3 as the only difference in the step's losses
    and gradients (``k3_only_check``); then ``bare_steps`` bare
    ``train_step`` calls on that batch, timed (none with 0: a data-parallel
    rank's step all-reduces, so it cannot step alone). The limits are
    those of the checks named."""
    from proben_tpu_torch.ops import roi_align_cuda

    model, cfg, batch = watch.model, watch.model_cfg, watch.held
    out = {}
    if stem:
        out["stem_pool"] = model_stem_check(model, cfg, batch["image"])
    levels, boxes = sampled_rois(model, batch)
    b, k, _ = boxes.shape
    lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(levels, boxes, **cfg.roi.pooler_args)
    what = f"{label}, the step's {b} x {k} RoIs"
    out["roi_align_fwd"] = check_roi(levels, lvl, y0, x0, wy, wx, k, what)
    shapes = [tuple(f.shape) for f in levels]
    gen = torch.Generator(device="cuda").manual_seed(3)
    g = (0.01 * torch.randn(b * k, 7, 7, shapes[0][-1], generator=gen, device="cuda")).to(levels[0].dtype)
    out["roi_align_bwd"] = check_bwd(g, shapes, lvl, y0, x0, wy, wx, k, what)
    del levels, boxes, lvl, y0, x0, wy, wx, g
    shape = [int(v) for v in batch["image"].shape]
    gaps, control = k3_only_check(model, cfg, batch, f"{label} batch {shape[0]}")

    bare_img_s = None
    if bare_steps:
        state = watch.state
        for _ in range(2):
            state, m = watch.step_fn(state, batch)
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(bare_steps):
            state, m = watch.step_fn(state, batch)
            float(m["total_loss"])  # the trainer's one sync per step
        e.record()
        torch.cuda.synchronize()
        bare_img_s = shape[0] * bare_steps / (a.elapsed_time(e) / 1e3)
    del watch.model, watch.state, watch.step_fn, watch.held
    log(f"{label}: K1-K3 held against their plain versions on one step of the trainer's batch "
        f"{shape}: {out}" + (f"; bare train_step {bare_img_s:.2f} img/s on that batch" if bare_steps else ""))
    return dict(max_abs_err=out, k3_grad_gap=gaps, plain_grad_gap_control=control,
                bare_step_img_s=bare_img_s, bare_steps=bare_steps, images_shape=shape)


def train_run_stats(label, watch, launches_run, expect_step, n_steps, eval_launches):
    """Checks of one training app run and its readings: every metric of
    every step finite and ``loss_finite`` 1; K1-K3 around one step as
    ``expect_step``, and K4's counts (``check_counts``); every kernel of the path launched in the run; the
    run's ``image_io`` launches equal to the batches the trainer's loader
    mapped (prefetched ones included) plus ``eval_launches``, the
    evaluations' batches, so one launch per training batch."""
    losses = [{k: v for k, v in m.items() if k.startswith("loss") or k == "total_loss"}
              for m in watch.metrics]
    if len(watch.metrics) != n_steps or not all(
            np.isfinite(v) for m in losses for v in m.values()) \
            or not all(m["loss_finite"] == 1.0 for m in losses):
        raise AssertionError(f"{label}: {len(watch.metrics)} steps, metrics not all finite: {losses}")
    k1_k3 = ("stem_pool", "roi_align_fwd", "roi_align_bwd")
    if any({k: p[k] for k in k1_k3} != {k: expect_step[k] for k in k1_k3}
           for p in [watch.launches] + watch.per_step):
        raise AssertionError(f"{label}: launches around one step {watch.launches} (per counted step "
                             f"{watch.per_step}), expected {expect_step}")
    for i, p in enumerate([watch.launches] + watch.per_step):
        check_counts(f"{label}, {'the counted step' if i == 0 else f'counted step {i}'}", p, expect_step)
    missing = [k for k, v in expect_step.items() if v and not launches_run[k]]
    if missing:
        raise AssertionError(f"{label}: kernels not launched in the run: {missing}, {launches_run}")
    mapped = watch.loader.batches_mapped
    io_train = launches_run["image_io"] - eval_launches
    if not mapped or io_train != mapped:
        raise AssertionError(f"{label}: {launches_run['image_io']} image_io launches in the run, "
                             f"{eval_launches} of them the evaluations', for {mapped} training batches")
    image_io = dict(launches_run=launches_run["image_io"], eval_launches=eval_launches,
                    train_batches_mapped=mapped, per_train_batch=io_train / mapped)
    del watch.loader
    times = [m["time"] for m in watch.metrics]
    steady = times[2:] or times
    out = dict(steps=len(watch.metrics), launches_per_step=watch.launches, launches_run=launches_run,
               image_io=image_io, step_s=times, step_s_median=float(np.median(steady)),
               steps_in_median=len(steady), train_img_s=TRAIN_BATCH / float(np.median(steady)),
               peak_memory_gb=watch.peak_gb, losses_first=losses[0], losses_last=losses[-1],
               frozen_tensors=watch.n_frozen, trainable_tensors=watch.n_trainable,
               trainable_groups=watch.trainable_groups, unmoved=len(watch.unmoved))
    log(f"{label}: {out['steps']} steps, total loss {losses[0]['total_loss']:.4g} -> "
        f"{losses[-1]['total_loss']:.4g}; launches per step {watch.launches}; image_io "
        f"{launches_run['image_io']} in the run = {mapped} training batches mapped + {eval_launches} "
        f"evaluation batches; {out['train_img_s']:.2f} img/s end to end (median of {len(steady)} "
        f"steps, {out['step_s_median'] * 1e3:.1f} ms), peak {watch.peak_gb:.2f} GB; {watch.n_frozen} "
        f"frozen tensors unchanged, {watch.n_trainable} trainable in {watch.trainable_groups}")
    return out


def kaist_train_tree(codec, root):
    """A synthetic KAIST tree of 32 frames in ``root`` and its persons as a
    COCO training set registered as ``smoke_kaist_train``: (annotation
    file, split file, the split's lines)."""
    from proben_tpu_torch.data import DatasetCatalog, register_coco_instances

    ann, split, lines = write_kaist_tree(codec, root, n=32, seed=7)
    with open(ann) as f:
        kjs = json.load(f)
    images = [{"id": im["id"], "file_name": f"{rel.replace('/I', '/lwir/I')}.jpg",
               "height": KAIST_HW[0], "width": KAIST_HW[1]}
              for im, rel in zip(kjs["images"], lines)]
    persons = [dict(a, iscrowd=0, area=a["bbox"][2] * a["bbox"][3]) for a in kjs["annotations"]
               if a["category_id"] == 1]
    train_json = os.path.join(root, "kaist_train.json")
    with open(train_json, "w") as f:
        json.dump({"images": images, "annotations": persons,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    DatasetCatalog.remove("smoke_kaist_train")
    register_coco_instances("smoke_kaist_train", {}, train_json, root)
    return ann, split, lines


def kaist_train_run(root, tree, out, hooks, var_scale=0.01, roi_align_impl="pallas", workers=4):
    """``train_kaist("thermal_only")`` as shipped (float32, FREEZE_MODULES,
    ``workers`` loader threads) for ``TRAIN_STEPS`` on
    ``kaist_train_tree``'s set into ``root/out``, from ``d2_weights`` of
    seed 33."""
    from proben_tpu_torch.apps import kaist

    ann, split, _ = tree
    cfg = kaist.build_kaist_cfg("thermal_only")
    cfg.MODEL.ROI_ALIGN_IMPL = roi_align_impl
    cfg.DATALOADER.NUM_WORKERS = workers
    cfg.MODEL.WEIGHTS = d2_weights(cfg, 33, os.path.join(root, f"{out}.pth"), var_scale)
    return kaist.train_kaist("thermal_only", "smoke_kaist_train", ann, root, split,
                             os.path.join(root, out), max_iter=TRAIN_STEPS, eval_every=1000,
                             cfg=cfg, hooks=hooks)


def kaist_divergence_probe(card):
    """``--kaist-divergence``: ``trainer_phase``'s KAIST run
    (``kaist_train_run``: 12 steps of ``train_kaist("thermal_only")``,
    float32, only the FPN and the RPN trainable) with the variance head's
    random weights unscaled (``var_scale`` 1), each setting twice in one
    process: as the trainer runs, with 4 loader threads, whose batches may
    arrive out of order and interleave the mapper's random draws; with one
    loader thread (the stream's order and draws); with one loader thread
    under ``torch.use_deterministic_algorithms(True, warn_only=True)`` and
    ``cudnn.deterministic`` (a warning names every nondeterministic op the
    run reaches); the same with K2 and K3 replaced by their plain versions
    (``ROI_ALIGN_IMPL: gather``); and the same with the kernels at the
    shipped ``var_scale`` 0.01. ``CUBLAS_WORKSPACE_CONFIG`` is ``:4096:8``
    throughout (``main`` sets it before the first cuBLAS call). Logs each
    run's total loss per step and prints one ``kaist_divergence`` JSON
    line; checks nothing."""
    import tempfile
    import warnings

    from proben_tpu_torch.native import io

    one = "one loader thread"
    settings = [("as shipped", False, "pallas", 1.0, 4), (one, False, "pallas", 1.0, 1),
                (f"{one}, deterministic", True, "pallas", 1.0, 1),
                (f"{one}, deterministic, plain K2/K3", True, "gather", 1.0, 1),
                (f"{one}, deterministic, var_scale 0.01", True, "pallas", 0.01, 1)]
    runs = []
    with tempfile.TemporaryDirectory(prefix="kaist_probe_") as root, io.JpegCodec() as codec:
        tree = kaist_train_tree(codec, root)
        for i, (label, det, impl, scale, workers) in enumerate(s for s in settings for _ in range(2)):
            torch.use_deterministic_algorithms(det, warn_only=True)
            torch.backends.cudnn.deterministic = det
            watch = TrainWatch(count_iter=0)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                kaist_train_run(root, tree, f"run{i}", watch.hooks(), scale, impl, workers)
            named = sorted({str(w.message).splitlines()[0][:200] for w in caught
                            if "determinis" in str(w.message)})
            total = [m["total_loss"] for m in watch.metrics]
            finite = all(m["loss_finite"] == 1.0 and np.isfinite(m["total_loss"]) for m in watch.metrics)
            log(f"KAIST probe run {i} ({label}): total loss per step {total}; all finite {finite}; "
                f"nondeterministic ops named: {named}")
            runs.append(dict(setting=label, total_loss=total, all_finite=finite, nondeterministic_ops=named))
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    repeatable = {a["setting"]: bool(np.array_equal(a["total_loss"], b["total_loss"], equal_nan=True))
                  for a, b in zip(runs[::2], runs[1::2])}
    kern, plain = runs[4]["total_loss"], runs[6]["total_loss"]
    gap = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(kern, plain)]
    log(f"KAIST probe: the two runs of each setting equal step for step: {repeatable}; kernels against "
        f"plain K2/K3 (one loader thread, deterministic), relative gap per step: {gap}")
    print(json.dumps({"kaist_divergence": {"runs": runs, "repeatable": repeatable,
                                           "kernels_vs_plain_rel_gap": gap, "card": card}}), flush=True)


def trainer_phase(card):
    """The training entry points end to end on synthetic trees at the
    FLIR and KAIST sizes, from the shipped configs at ``IMS_PER_BATCH`` 16:
    the train mapper on the card (BGR and BGRTTT) against its plain version
    and the CPU mapper; ``TrainLoader`` with 4 workers against the plain
    version; ``train_flir("thermal_only")`` from
    ``faster_rcnn_R_101_FLIR.yaml`` (R101, bf16, the FLIR solver) for 12
    steps with keep-best every 6 and a checkpoint every 5, its best
    checkpoint's detections against the live model's, and a resume;
    ``train_flir("middle_fusion")`` and ``train_kaist("thermal_only")``
    (float32 as shipped; FREEZE_MODULES) for 12 steps each; after each
    run, ``held_batch_checks`` on one more of its loader's batches. The
    weights are random (a detectron2 ``.pth`` of random affines through
    ``MODEL.WEIGHTS``), so AP and LAMR mean nothing."""
    import tempfile

    from proben_tpu_torch.apps import flir
    from proben_tpu_torch.apps.flir import TRAIN_JSON_NAME
    from proben_tpu_torch.config import get_cfg, mapper_config_from_cfg, model_config_from_cfg
    from proben_tpu_torch.data import DatasetCatalog, DatasetMapper, build_test_loader
    from proben_tpu_torch.engine import Predictor
    from proben_tpu_torch.models import build_model
    from proben_tpu_torch.native import io

    def yaml_cfg(name):
        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(HERE, "configs", "FLIR-Detection", name))
        return cfg

    stats = {"card": card, "batch": TRAIN_BATCH}
    with tempfile.TemporaryDirectory(prefix="flir_train_") as root, io.JpegCodec() as codec:
        t0 = time.time()
        write_flir_train_tree(codec, root)
        flir.register_flir("smoke_train", root, TRAIN_JSON_NAME)
        train_dicts = DatasetCatalog.get("smoke_train")
        log(f"FLIR train tree: {len(train_dicts)} pairs in {time.time() - t0:.1f} s")

        # 1. the train mapper and the loader on the card
        mapped = {}
        for fmt, yaml_name, seed in (("BGR", "faster_rcnn_R_101_FLIR.yaml", 3),
                                     ("BGRTTT", "faster_rcnn_R_101_FLIR_middle_fusion.yaml", 4)):
            _, mapped[fmt] = check_train_mapper(codec, yaml_cfg(yaml_name), train_dicts[:TRAIN_BATCH],
                                                seed)
        stats["train_mapper"] = mapped
        stats["train_loader"] = check_train_loader(codec, yaml_cfg("faster_rcnn_R_101_FLIR.yaml"),
                                                   train_dicts, 6)

        # 2. train_flir thermal_only as shipped, 12 steps, keep-best, resume
        out = os.path.join(root, "out_thermal")
        cfg = yaml_cfg("faster_rcnn_R_101_FLIR.yaml")
        cfg.MODEL.WEIGHTS = d2_weights(cfg, 31, os.path.join(root, "thermal.pth"))
        cfg.SOLVER.CHECKPOINT_PERIOD = 5
        flir.register_flir("smoke_val", root)
        val = DatasetCatalog.get("smoke_val")
        mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=False)
        try:
            eval_batch = next(iter(build_test_loader(val[:BATCH], mapper, batch_size=BATCH)))
        finally:
            mapper.close()
        watch = TrainWatch(count_iter=3, eval_batch=eval_batch, hold_batch=True)
        zero_launch_counts()
        t = time.time()
        res = flir.train_flir("thermal_only", root, out, max_iter=TRAIN_STEPS, eval_every=6, cfg=cfg,
                              hooks=watch.hooks())
        wall = time.time() - t
        run = launch_counts()
        one = {"stem_pool": 1, "roi_align_fwd": 1, "roi_align_bwd": 1, **k4_expect(1, cfg.MODEL.BACKBONE.FREEZE_AT),
               **k5_expect(steps=1)}
        # FLIR's evaluation maps the 32 val images at batch 1: one image_io launch each
        thermal = train_run_stats("train_flir thermal_only", watch, run, one, TRAIN_STEPS,
                                  eval_runs(0, TRAIN_STEPS, 6) * len(val))
        if watch.unmoved:
            raise AssertionError(f"train_flir: {len(watch.unmoved)} trainable tensors did not move, "
                                 f"e.g. {watch.unmoved[:3]}")
        with open(os.path.join(out, "metrics.json")) as f:
            records = [json.loads(ln) for ln in f]
        if [r["iteration"] for r in records] != [TRAIN_STEPS - 1] or "total_loss" not in records[0]:
            raise AssertionError(f"train_flir: metrics.json holds {records}")
        with open(os.path.join(out, "checkpoints", "last.json")) as f:
            meta = json.load(f)
        if res["best_AP50"] is None or meta.get("best_step") not in watch.best_dets:
            raise AssertionError(f"train_flir: no keep-best checkpoint ({res}, {meta})")
        best = flir.load_params(cfg, os.path.join(out, "checkpoints", "best"))
        mcfg = model_config_from_cfg(cfg)
        again = Predictor(build_model(mcfg, params=best), mcfg).predict_batch(eval_batch)
        live = watch.best_dets[meta["best_step"]]
        if not all(np.array_equal(a[k], b[k]) for a, b in zip(again, live)
                   for k in ("boxes", "scores", "classes")):
            raise AssertionError("train_flir: the best checkpoint's detections differ from the live model's")
        del again, best
        held = held_batch_checks(watch, "train_flir thermal_only", stem=True)
        thermal.update(held_batch=held, best_AP50=res["best_AP50"], best_step=meta["best_step"],
                       wall_s=wall, bare_step_img_s=held["bare_step_img_s"],
                       loader_share=1.0 - thermal["train_img_s"] / held["bare_step_img_s"],
                       dets_per_img_best=float(np.mean([len(r["scores"]) for r in live])))
        log(f"train_flir thermal_only: best AP50 {res['best_AP50']} at iter {meta['best_step']}, its "
            f"checkpoint's detections equal the live model's; the loader and the host take "
            f"{thermal['loader_share'] * 100:.1f}% of the end-to-end step")

        resumed = TrainWatch(count_iter=TRAIN_STEPS, expect_state=watch.final)
        zero_launch_counts()
        res2 = flir.train_flir("thermal_only", root, out, max_iter=TRAIN_STEPS + 1, eval_every=6,
                               cfg=yaml_cfg("faster_rcnn_R_101_FLIR.yaml"), hooks=resumed.hooks())
        if resumed.start_iter != watch.iter + 1 or len(resumed.metrics) != 1:
            raise AssertionError(f"train_flir resume: started at {resumed.start_iter}, "
                                 f"expected {watch.iter + 1}")
        again = train_run_stats("train_flir thermal_only, resumed", resumed, launch_counts(), one, 1,
                                eval_runs(TRAIN_STEPS, TRAIN_STEPS + 1, 6) * len(val))
        thermal["resume"] = dict(start_iter=resumed.start_iter, state_equal=True,
                                 launches_per_step=resumed.launches, image_io=again["image_io"],
                                 best_AP50=res2["best_AP50"])
        log(f"train_flir resume: started at iter {resumed.start_iter} with the checkpointed state, "
            "bit for bit")
        stats["flir_thermal_only"] = thermal
        del watch, resumed

        # 3. train_flir middle_fusion
        cfg = yaml_cfg("faster_rcnn_R_101_FLIR_middle_fusion.yaml")
        cfg.MODEL.WEIGHTS = d2_weights(cfg, 32, os.path.join(root, "middle.pth"))
        watch = TrainWatch(count_iter=1, hold_batch=True)
        zero_launch_counts()
        flir.train_flir("middle_fusion", root, os.path.join(root, "out_middle"), max_iter=TRAIN_STEPS,
                        eval_every=1000, cfg=cfg, hooks=watch.hooks())
        middle = train_run_stats("train_flir middle_fusion", watch, launch_counts(),
                                 {"stem_pool": 2, "roi_align_fwd": 1, "roi_align_bwd": 1,
                                  **k4_expect(2, cfg.MODEL.BACKBONE.FREEZE_AT), **k5_expect(steps=1)}, TRAIN_STEPS,
                                 eval_runs(0, TRAIN_STEPS, 1000) * len(val))
        if watch.unmoved:
            raise AssertionError(f"train_flir middle_fusion: {len(watch.unmoved)} trainable tensors "
                                 "did not move")
        held = held_batch_checks(watch, "train_flir middle_fusion", stem=True)
        middle.update(held_batch=held, bare_step_img_s=held["bare_step_img_s"],
                      loader_share=1.0 - middle["train_img_s"] / held["bare_step_img_s"])
        log(f"train_flir middle_fusion: the loader and the host take "
            f"{middle['loader_share'] * 100:.1f}% of the end-to-end step")
        stats["flir_middle_fusion"] = middle
        del watch

    # 4. train_kaist thermal_only as shipped (float32, FREEZE_MODULES)
    with tempfile.TemporaryDirectory(prefix="kaist_train_") as root, io.JpegCodec() as codec:
        tree = kaist_train_tree(codec, root)
        watch = TrainWatch(count_iter=1, hold_batch=True)
        zero_launch_counts()
        res = kaist_train_run(root, tree, "out", watch.hooks())
        # predict_split maps the 32 frames in batches of 4: one image_io launch each
        kst = train_run_stats("train_kaist thermal_only (float32)", watch, launch_counts(),
                              {"stem_pool": 0, "roi_align_fwd": 1, "roi_align_bwd": 1,
                               **k4_expect(1, float32=True), **k5_expect(steps=1)}, TRAIN_STEPS,
                              eval_runs(0, TRAIN_STEPS, 1000) * -(-len(tree[2]) // 4))
        if watch.trainable_groups != ["fpn", "rpn_head"] or watch.unmoved:
            raise AssertionError(f"train_kaist: trainable {watch.trainable_groups}, "
                                 f"{len(watch.unmoved)} did not move")
        held = held_batch_checks(watch, "train_kaist thermal_only (float32)", stem=False)
        kst.update(held_batch=held, bare_step_img_s=held["bare_step_img_s"],
                   loader_share=1.0 - kst["train_img_s"] / held["bare_step_img_s"],
                   best_lamr=res["best_lamr"])
        stats["kaist_thermal_only_f32"] = kst
        del watch
    stats["seconds"] = time.time() - t0
    return stats


# ---------------------------------------------------------------------------
# the other detector heads: C4, Cascade, RetinaNet, ProposalNetwork, TTA
# ---------------------------------------------------------------------------


TIMED_CALLS = 15  # per img/s or step time of the heads: 5 groups of 3 (``cuda_ms``)


def counted(fn):
    """``fn()`` with every launch counter set to 0 just before it and read
    just after (synchronized): (result, launches)."""
    zero_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def expect_launches(label, got, expect):
    """K1-K3's and ``image_io``'s launches as ``expect`` names them (0 where
    it names none), else an AssertionError; K4's and K5's counts, where
    ``expect`` names them, through ``check_counts``."""
    log(f"{label} launches: {got}")
    want = {k: expect.get(k, 0) for k in COUNTED}
    if {k: got.get(k, 0) for k in COUNTED} != want:
        raise AssertionError(f"{label}: kernel launches {got}, expected {want}")
    if any(k in expect for k in CHECKED):
        check_counts(label, got, expect)


def timed_pooling(timed, prefix, levels, boxes, pooler, capacity):
    """``multilevel_roi_align``'s steps on the card, each a stage of
    ``timed``: the window weights, K2 and the out-of-window fallback.
    (pooled (B, K, P, P, C), the number of RoIs out of their window)."""
    from proben_tpu_torch.ops import roi_align_cuda
    from proben_tpu_torch.ops.roi_align import apply_oow_fallback

    b, k, _ = boxes.shape
    lvl, y0, x0, wy, wx, oow = timed(f"{prefix}pooler weights", lambda: roi_align_cuda.window_inputs(
        levels, boxes, **pooler))
    p = wy.shape[1]
    pooled = timed(f"{prefix}K2 (P = {p})", lambda: roi_align_cuda.roi_align_fwd(
        levels, lvl, y0, x0, wy, wx, k).reshape(b, k, p, p, -1))
    pooled = timed(f"{prefix}out-of-window fallback", lambda: apply_oow_fallback(
        pooled, oow.reshape(b, k), levels, boxes, lvl.reshape(b, k), pooler["strides"], p,
        pooler["sampling_ratio"], capacity))
    return pooled, int(oow.sum())


def log_stages(label, stage_ms, oow=None):
    for k, v in stage_ms.items():
        log(f"{label}: {k}: {v:.4g} ms")
    if oow is not None:
        log(f"{label}: RoIs out of their window per pooling: {oow}")


def det_records(det):
    """Per-image dicts of a batched ``Detections``' valid rows (numpy)."""
    d = det.to_numpy()
    return [{"boxes": d.boxes[i][d.valid[i]], "scores": d.scores[i][d.valid[i]],
             "classes": d.classes[i][d.valid[i]]} for i in range(d.boxes.shape[0])]


def check_detections(label, det, topk):
    """Finite detections of the expected shape, some in every image."""
    if tuple(det.boxes.shape) != (BATCH, topk, 4) or det.scores.shape != det.valid.shape:
        raise AssertionError(f"{label}: detections of shape {tuple(det.boxes.shape)}")
    v = det.valid
    if not (bool(torch.isfinite(det.boxes[v]).all()) and bool(torch.isfinite(det.scores[v]).all())):
        raise AssertionError(f"{label}: non-finite detections")
    n = v.sum(-1)
    if int(n.min()) == 0:
        raise AssertionError(f"{label}: an image without detections: {n.tolist()}")
    return float(n.float().mean())


def plain_agreement(label, infer, cfg):
    """The path with its kernels against the same path with their plain
    versions (bf16, K4 off), with the bf16-vs-f32 control of slice_phase's check
    (3): both ways, the share of detections matched (class, IoU >= 0.95,
    |dscore| <= 0.02) must be at least the control's less 5 points."""
    plain_cfg = cfg.replace(stem_impl="plain", roi_align_impl="plain")
    out_k = det_records(infer(cfg))
    with k4_off():
        out_p = det_records(infer(plain_cfg))
    out_32 = det_records(infer(plain_cfg.replace(compute_dtype="float32")))
    m = min(match_fraction(out_k, out_p), match_fraction(out_p, out_k))
    m_32 = min(match_fraction(out_p, out_32), match_fraction(out_32, out_p))
    log(f"{label}: kernels vs plain {100 * m:.2f}% matched, bf16 vs f32 control {100 * m_32:.2f}%")
    if m < m_32 - 0.05:
        raise AssertionError(f"{label}: kernel-path detections agree worse than the bf16-vs-f32 control")
    return m, m_32


def grads_step(model, params, losses_fn):
    """One training step's forward and backward: (losses, gradients), every
    gradient finite and some nonzero."""
    with torch.enable_grad():
        losses = losses_fn()
        total = sum(v.mean() for v in losses.values())
        grads = torch.autograd.grad(total, params)
    return {k: float(v.detach().mean()) for k, v in losses.items()}, grads


def check_step(label, losses, grads):
    bad = [k for k, v in losses.items() if not np.isfinite(v)]
    if bad or not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError(f"{label}: non-finite losses {bad} or gradients")
    nonzero = sum(bool(g.abs().sum() > 0) for g in grads)
    log(f"{label}: losses {losses}; {nonzero} of {len(grads)} trainable tensors get a nonzero gradient")
    if nonzero < len(grads) // 2:
        raise AssertionError(f"{label}: only {nonzero} of {len(grads)} gradients are nonzero")


def trainable(model, freeze_at, freeze_modules=()):
    """Mark and return the trainable parameters (``trainable_mask``)."""
    from proben_tpu_torch.engine.train import trainable_mask

    mask = trainable_mask(model, freeze_at, freeze_modules)
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])
    return [p for p in model.parameters() if p.requires_grad]


def c4_phase(images, sizes, batch):
    """R101-C4 (``models/c4.py``), bf16, batch 8: inference with K1 once
    and K2 at P = 14 once per batch (1000 proposals per image on the stride-16
    res4 map, C = 1024), held to the plain path; K2 at P = 14 against its
    plain version on those proposals; one training step (forward +
    backward: K1, K2 and K3 at P = 14 once each, 512 sampled RoIs per
    image); K3 at P = 14 against its plain version on those RoIs."""
    from proben_tpu_torch.models import build_config, c4, random_affines
    from proben_tpu_torch.models.box_head import apply_output_layers
    from proben_tpu_torch.models.fast_rcnn import fast_rcnn_inference
    from proben_tpu_torch.models.rcnn import nhwc
    from proben_tpu_torch.models.roi_heads import label_and_sample_proposals
    from proben_tpu_torch.models.rpn import apply_rpn_head, find_top_proposals

    cfg = build_config(depth=101, num_classes=3, compute_dtype="bfloat16")
    model = c4.build_c4_model(cfg, random_affines(c4.init_rcnn_c4(10, cfg), 10))
    with torch.inference_mode():
        res4 = c4._res4(model, cfg, images)
        outs = apply_rpn_head(model.rpn_head, [res4], cfg.dtype)
    scale_convs((model.rpn_head.objectness, model.rpn_head.deltas), outs, (2.0, 0.1))
    cls = model.roi["output"].cls_score
    base_w = cls.weight.detach().clone()

    def set_bias(b):
        cls.weight.copy_(base_w * 0.02)
        cls.bias[-1] = b

    def infer(c=cfg):
        return c4.rcnn_c4_inference(model, c, images, sizes)

    bias, n = bisect_bias(set_bias, lambda: float(infer().valid.sum(-1).float().mean()), 0.0, 16.0)
    log(f"C4 calibration: background bias {bias:.4g} -> {n:.1f} dets/img")
    det, launches = counted(infer)
    expect_launches("C4 inference", launches, {"stem_pool": 1, "roi_align_fwd": 1, **k4_expect(), **k5_expect(1)})
    dets = check_detections("C4 inference", det, cfg.rcnn.topk_per_image)
    matched, matched_32 = plain_agreement("C4 inference", infer, cfg)
    ms = cuda_ms(infer, TIMED_CALLS)
    log(f"C4 inference: {BATCH * 1e3 / ms:.2f} img/s ({ms:.4g} ms per batch of {BATCH})")

    k = cfg.rpn.post_nms_topk_test
    zero = torch.zeros(BATCH, k, dtype=torch.int32, device="cuda")
    pooler = dict(strides=(c4.C4_STRIDE,), output_size=c4.C4_POOLER_RESOLUTION,
                  sampling_ratio=cfg.roi.pooler_sampling_ratio, min_level=0, levels=zero)

    def stages(timed):
        r4 = timed("backbone to res4 (stem K1)", lambda: c4._res4(model, cfg, images))
        lg, dl = timed("RPN head", lambda: apply_rpn_head(model.rpn_head, [r4], cfg.dtype))
        boxes, _, valid = timed("proposals (top-k, decode, NMS)", lambda: find_top_proposals(
            lg, dl, c4.c4_anchors(r4), sizes, cfg.rpn.pre_nms_topk_test, k, cfg.rpn.nms_thresh,
            cfg.rpn.min_box_side_len))
        pooled, oow["res4"] = timed_pooling(timed, "", [nhwc(r4)], boxes, pooler,
                                            cfg.roi.fallback_capacity)
        vec = timed("res5 on every RoI", lambda: c4._res5(model, pooled, cfg.dtype))
        timed("box predictor + decode + NMS", lambda: fast_rcnn_inference(
            *apply_output_layers(model.roi["output"], vec)[:2], boxes, valid, sizes, cfg.rcnn))

    oow = {}
    stage_ms = stage_medians(stages)
    log_stages("C4", stage_ms, oow)
    with torch.inference_mode():
        res4 = c4._res4(model, cfg, images)
        lg, dl = apply_rpn_head(model.rpn_head, [res4], cfg.dtype)
        boxes = find_top_proposals(lg, dl, c4.c4_anchors(res4), sizes, cfg.rpn.pre_nms_topk_test, k,
                                   cfg.rpn.nms_thresh, cfg.rpn.min_box_side_len)[0]
    k2, _ = k2_reading([nhwc(res4)], boxes, pooler, "C4 proposals")

    params = trainable(model, cfg.freeze_at)
    gen = torch.Generator(device="cuda")

    def losses_fn():
        return c4.rcnn_c4_train_losses(model, cfg, batch["image"], batch["image_size"], batch["gt"],
                                       gen.manual_seed(0))

    (losses, grads), train_launches = counted(lambda: grads_step(model, params, losses_fn))
    expect_launches("C4 training step", train_launches,
                    {"stem_pool": 1, "roi_align_fwd": 1, "roi_align_bwd": 1, **k4_expect(1, cfg.freeze_at),
                     **k5_expect(steps=1)})
    check_step("C4 training step", losses, grads)
    step_ms = cuda_ms(lambda: grads_step(model, params, losses_fn), TIMED_CALLS)
    log(f"C4 training step (forward + backward): {step_ms:.4g} ms, {BATCH * 1e3 / step_ms:.2f} img/s")
    with torch.no_grad():
        res4 = c4._res4(model, cfg, batch["image"], cfg.freeze_at)
        lg, dl = apply_rpn_head(model.rpn_head, [res4], cfg.dtype)
        props, _, valid = find_top_proposals(
            lg, dl, c4.c4_anchors(res4), batch["image_size"], cfg.rpn.pre_nms_topk_train,
            cfg.rpn.post_nms_topk_train, cfg.rpn.nms_thresh, cfg.rpn.min_box_side_len)
        s_boxes = label_and_sample_proposals(props, valid, batch["gt"], gen.manual_seed(0), cfg.roi)[0]
    k3 = k3_reading([nhwc(res4)], s_boxes, dict(pooler, levels=torch.zeros(
        s_boxes.shape[:2], dtype=torch.int32, device="cuda")), "C4 sampled RoIs")
    return k2, k3, dict(inference=launches, train=train_launches), dict(
        dets_per_img=dets, matched_plain=matched, matched_bf16_f32=matched_32,
        img_s=BATCH * 1e3 / ms, batch_ms=ms, stage_ms=stage_ms, out_of_window=oow, train_losses=losses,
        train_step_ms=step_ms, train_img_s=BATCH * 1e3 / step_ms)


def cascade_phase(images, sizes, batch):
    """Cascade R-CNN (``models/cascade.py``) on an R101-FPN backbone and RPN,
    bf16, batch 8: inference (K1 once, K2 three times per batch: one pooling
    per stage), held to the plain path; K2 against its plain version on
    the last stage's boxes (refined twice); one training step (the RPN's
    and the three stages' losses: K1 once, K2 six times (each stage's
    sampled RoIs with autograd, then all proposals to refine them
    without), K3 three times); K3 against its plain version on the last
    stage's sampled RoIs. Returns the RCNN model too (ProposalNetwork and
    TTA run on it)."""
    from proben_tpu_torch.models import build_config, build_model, cascade, init_rcnn, random_affines
    from proben_tpu_torch.models import rcnn
    from proben_tpu_torch.models.fast_rcnn import fast_rcnn_inference
    from proben_tpu_torch.models.roi_heads import label_and_sample_proposals
    from proben_tpu_torch.models.rpn import find_top_proposals, rpn_losses

    cfg = build_config(depth=101, num_classes=3, compute_dtype="bfloat16")
    model = build_model(cfg, random_affines(init_rcnn(11, cfg), 11))
    heads = cascade.build_cascade_heads(seed=11, in_channels=cfg.head_in_channels, num_classes=3)
    calibrate_rpn(model, images)
    base_w = [s.output.cls_score.weight.detach().clone() for s in heads.stages]

    def set_bias(b):
        for s, w in zip(heads.stages, base_w):
            s.output.cls_score.weight.copy_(w * 0.02)
            s.output.cls_score.bias[-1] = b

    def proposals(c):
        feats = rcnn.extract_features(model, c, rcnn.preprocess(c, images))
        return feats, *rcnn.propose(model, c, feats, sizes)

    def infer(c=cfg):
        with torch.inference_mode():
            feats, boxes, _, valid = proposals(c)
            return cascade.cascade_inference(heads, rcnn.roi_levels(feats), boxes, valid, sizes, c.roi,
                                             c.rcnn, c.dtype, c.roi_align_impl)

    bias, n = bisect_bias(set_bias, lambda: float(infer().valid.sum(-1).float().mean()), 0.0, 16.0)
    log(f"Cascade calibration: background bias {bias:.4g} (all stages) -> {n:.1f} dets/img")
    det, launches = counted(infer)
    expect_launches("Cascade inference", launches, {"stem_pool": 1, "roi_align_fwd": 3, **k4_expect(),
                                                    **k5_expect(1)})
    dets = check_detections("Cascade inference", det, cfg.rcnn.topk_per_image)
    matched, matched_32 = plain_agreement("Cascade inference", infer, cfg)
    ms = cuda_ms(infer, TIMED_CALLS)
    log(f"Cascade inference: {BATCH * 1e3 / ms:.2f} img/s ({ms:.4g} ms per batch of {BATCH})")

    def stages(timed):
        x = rcnn.preprocess(cfg, images)
        feats = timed("backbone (stem K1) + FPN", lambda: rcnn.extract_features(model, cfg, x))
        boxes, _, valid = timed("RPN head + proposals", lambda: rcnn.propose(model, cfg, feats, sizes))
        levels = rcnn.roi_levels(feats)
        probs, hw = [], (sizes[:, 0:1].float(), sizes[:, 1:2].float())
        for i, (stage, wts) in enumerate(zip(heads.stages, cascade.CASCADE_WEIGHTS)):
            pooled, oow[f"stage {i}"] = timed_pooling(timed, f"stage {i} ", levels, boxes,
                                                      cfg.roi.pooler_args, cfg.roi.fallback_capacity)
            logits, boxes = timed(f"stage {i} box head + refine", lambda: cascade._refine(
                stage, pooled, boxes, wts, hw, cfg.dtype))
            probs.append(torch.softmax(logits, -1))
        agnostic = dataclasses.replace(cfg.rcnn, cls_agnostic_bbox_reg=True)
        timed("mean probabilities + decode + NMS", lambda: fast_rcnn_inference(
            torch.log(torch.stack(probs).mean(0).clamp(min=1e-30)), torch.zeros_like(boxes), boxes,
            valid, sizes, agnostic))

    oow = {}
    stage_ms = stage_medians(stages)
    log_stages("Cascade", stage_ms, oow)
    with torch.inference_mode():
        feats, boxes, _, valid = proposals(cfg)
        levels = rcnn.roi_levels(feats)
        hw = (sizes[:, 0:1].float(), sizes[:, 1:2].float())
        for stage, wts in list(zip(heads.stages, cascade.CASCADE_WEIGHTS))[:2]:
            boxes = cascade._run_stage(stage, levels, boxes, cfg.roi, wts, hw, cfg.dtype, "kernel")[1]
    k2, _ = k2_reading(levels, boxes, cfg.roi.pooler_args, "Cascade stage-2 boxes")

    # the RCNN's own box head is not on this path: the cascade's stages are
    params = trainable(model, cfg.freeze_at, ("roi",)) + [p.requires_grad_() for p in heads.parameters()]
    gen = torch.Generator(device="cuda")

    def losses_fn():
        gen.manual_seed(0)
        feats = rcnn.extract_features(model, cfg, rcnn.preprocess(cfg, batch["image"]), training=True)
        logits, deltas = rcnn.rpn_outputs(model, cfg, feats)
        anchors = rcnn.anchors_for(feats)
        losses = rpn_losses(logits, deltas, anchors, batch["gt"].boxes, batch["gt"].valid, gen, cfg.rpn)
        with torch.no_grad():
            boxes, _, valid = find_top_proposals(
                logits, deltas, anchors, batch["image_size"], cfg.rpn.pre_nms_topk_train,
                cfg.rpn.post_nms_topk_train, cfg.rpn.nms_thresh, cfg.rpn.min_box_side_len)
        losses.update(cascade.cascade_train_losses(heads, rcnn.roi_levels(feats), boxes, valid,
                                                   batch["gt"], gen, cfg.roi, cfg.rcnn, cfg.dtype))
        return losses

    (losses, grads), train_launches = counted(lambda: grads_step(model, params, losses_fn))
    expect_launches("Cascade training step", train_launches,
                    {"stem_pool": 1, "roi_align_fwd": 6, "roi_align_bwd": 3, **k4_expect(1, cfg.freeze_at),
                     **k5_expect(steps=1)})
    check_step("Cascade training step", losses, grads)
    step_ms = cuda_ms(lambda: grads_step(model, params, losses_fn), TIMED_CALLS)
    log(f"Cascade training step (forward + backward): {step_ms:.4g} ms, {BATCH * 1e3 / step_ms:.2f} img/s")
    with torch.no_grad():
        feats = rcnn.extract_features(model, cfg, rcnn.preprocess(cfg, batch["image"]), training=True)
        logits, deltas = rcnn.rpn_outputs(model, cfg, feats)
        boxes, _, valid = find_top_proposals(
            logits, deltas, rcnn.anchors_for(feats), batch["image_size"], cfg.rpn.pre_nms_topk_train,
            cfg.rpn.post_nms_topk_train, cfg.rpn.nms_thresh, cfg.rpn.min_box_side_len)
        levels = rcnn.roi_levels(feats)
        inf = (float("inf"), float("inf"))
        for stage, wts in list(zip(heads.stages, cascade.CASCADE_WEIGHTS))[:2]:
            boxes = cascade._run_stage(stage, levels, boxes, cfg.roi, wts, inf, cfg.dtype, "kernel")[1]
        roi2 = dataclasses.replace(cfg.roi, iou_threshold=cascade.CASCADE_IOUS[2])
        s_boxes = label_and_sample_proposals(boxes, valid, batch["gt"], gen.manual_seed(0), roi2)[0]
    k3 = k3_reading(levels, s_boxes, cfg.roi.pooler_args, "Cascade stage-2 sampled RoIs")
    for p in heads.parameters():
        p.requires_grad_(False)
    return model, k2, k3, dict(inference=launches, train=train_launches), dict(
        dets_per_img=dets, matched_plain=matched, matched_bf16_f32=matched_32,
        img_s=BATCH * 1e3 / ms, batch_ms=ms, stage_ms=stage_ms, out_of_window=oow, train_losses=losses,
        train_step_ms=step_ms, train_img_s=BATCH * 1e3 / step_ms)


def retinanet_phase(images, sizes, batch):
    """RetinaNet (``models/retinanet.py``) R101, bf16, batch 8: inference
    (K1 once per batch; no RoI pooling) and one training step (forward +
    backward, K1 once)."""
    from proben_tpu_torch.models import random_affines, retinanet

    cfg = retinanet.RetinaNetConfig(depth=101, num_classes=3, compute_dtype="bfloat16")
    model = retinanet.build_retinanet(cfg, random_affines(retinanet.init_retinanet(12, cfg), 12))
    with torch.inference_mode():
        outs = retinanet._head(model, cfg, retinanet._features(model, cfg, images, False))
    # calibration: class logits to std 1.5 and deltas to std 0.1 around the
    # prior bias, then the class bias bisected to 20-80 dets/img
    scale_convs((model.head.cls_score, model.head.bbox_pred), outs, (1.5, 0.1))
    cls = model.head.cls_score

    def infer():
        return retinanet.retinanet_inference(model, cfg, images, sizes)

    bias, n = bisect_bias(lambda b: cls.bias.fill_(b), lambda: float(infer().valid.sum(-1).float().mean()),
                          -16.0, 0.0, fewer_when_higher=False)
    log(f"RetinaNet calibration: class bias {bias:.4g} -> {n:.1f} dets/img")
    det, launches = counted(infer)
    expect_launches("RetinaNet inference", launches, {"stem_pool": 1, **k4_expect(), "nms": 1})
    dets = check_detections("RetinaNet inference", det, cfg.topk_per_image)
    ms = cuda_ms(infer, TIMED_CALLS)
    log(f"RetinaNet inference: {BATCH * 1e3 / ms:.2f} img/s ({ms:.4g} ms per batch of {BATCH})")

    def stages(timed):
        feats = timed("backbone (stem K1) + FPN + P6/P7",
                      lambda: retinanet._features(model, cfg, images, False))
        timed("class and box towers", lambda: retinanet._head(model, cfg, feats))
    stage_ms = stage_medians(stages)
    stage_ms["per-level top-k + decode + NMS (the rest of a batch)"] = ms - sum(stage_ms.values())
    log_stages("RetinaNet", stage_ms)

    params = trainable(model, cfg.freeze_at)

    def losses_fn():
        return retinanet.retinanet_losses(model, cfg, batch["image"], batch["image_size"], batch["gt"])

    (losses, grads), train_launches = counted(lambda: grads_step(model, params, losses_fn))
    expect_launches("RetinaNet training step", train_launches, {"stem_pool": 1, **k4_expect(1, cfg.freeze_at),
                                                                "nms": 0})
    check_step("RetinaNet training step", losses, grads)
    step_ms = cuda_ms(lambda: grads_step(model, params, losses_fn), TIMED_CALLS)
    log(f"RetinaNet training step (forward + backward): {step_ms:.4g} ms, "
        f"{BATCH * 1e3 / step_ms:.2f} img/s")
    return dict(inference=launches, train=train_launches), dict(
        dets_per_img=dets, img_s=BATCH * 1e3 / ms, batch_ms=ms, stage_ms=stage_ms,
        train_losses=losses, train_step_ms=step_ms, train_img_s=BATCH * 1e3 / step_ms)


def proposal_tta_phase(model, images, sizes):
    """ProposalNetwork inference (``models/proposal_network.py``, K1 once
    per batch) on the Cascade phase's R101-FPN, and ``DetectionTTA`` with
    ``rescore=True`` through that model's ``Predictor`` (its box head
    calibrated as slice_phase does) on one 800x1000 uint8 image at JAX's
    defaults (scales 400-800, flips: 10 augmentations, one batch): one
    ``image_io`` launch makes them, then K1 and K2 once for the
    detections and once for the rescoring."""
    from proben_tpu_torch.data.dataset_mapper import MapperConfig
    from proben_tpu_torch.engine import Predictor
    from proben_tpu_torch.models import proposal_network
    from proben_tpu_torch.models.tta import DetectionTTA

    cfg = model.cfg

    def propose():
        return proposal_network.proposal_network_inference(model, cfg, images, sizes)

    (boxes, scores, valid), launches = counted(propose)
    expect_launches("ProposalNetwork inference", launches, {"stem_pool": 1, **k4_expect(), "nms": 1})
    if not (bool(torch.isfinite(boxes[valid]).all()) and int(valid.sum(-1).min()) > 0):
        raise AssertionError("ProposalNetwork: non-finite proposals or an image without any")
    ms = cuda_ms(propose, TIMED_CALLS)
    log(f"ProposalNetwork inference: {float(valid.sum(-1).float().mean()):.1f} proposals/img, "
        f"{BATCH * 1e3 / ms:.2f} img/s")

    pred = Predictor(model, cfg)
    bias, n = calibrate(model, pred, images, sizes)
    log(f"TTA model calibration: background bias {bias:.4g} -> {n:.1f} dets/img")
    image = images[0, :TRUE_HW[0], :TRUE_HW[1]].round().clamp(0, 255).to(torch.uint8).contiguous()
    tta = DetectionTTA(pred, MapperConfig(pad_shape=(H, W)), rescore=True)
    seen, rescore = {}, pred.rescore_boxes

    def recording(imgs, given):  # keeps what the rescoring pass pools; launches nothing
        seen["images"], seen["given"] = imgs, given
        return rescore(imgs, given)

    pred.rescore_boxes = recording
    out, tta_launches = counted(lambda: tta(image))
    pred.rescore_boxes = rescore
    expect_launches("TTA with rescore (10 augmentations)", tta_launches,
                    {"stem_pool": 2, "roi_align_fwd": 2, "image_io": 1, **k4_expect(2), **k5_expect(1)})
    errs = tta_kernel_checks(model, tta, image, seen)
    plain = DetectionTTA(pred, MapperConfig(pad_shape=(H, W)))(image)
    b, s = out["boxes"], out["scores"]
    if not (len(s) and np.isfinite(b).all() and (b[:, [0, 2]] <= TRUE_HW[1] + 1e-3).all()
            and (b[:, [1, 3]] <= TRUE_HW[0] + 1e-3).all() and (b >= 0).all()
            and ((s > 0) & (s <= 1)).all() and (np.diff(s) <= 0).all()):
        raise AssertionError("TTA: merged detections out of the frame, unsorted or empty")
    if len(plain["scores"]) != len(s) or np.allclose(np.sort(plain["scores"]), np.sort(s)):
        raise AssertionError("TTA: rescoring kept the merged scores")
    tta_ms = host_ms(lambda: tta(image), 3)
    log(f"TTA with rescore: {len(s)} merged detections, {tta_ms:.4g} ms per image "
        f"(median of 3, host clock)")
    return dict(proposal_network=launches, tta=tta_launches), dict(
        proposal_network_img_s=BATCH * 1e3 / ms, proposals_per_img=float(valid.sum(-1).float().mean()),
        tta_dets=len(s), tta_ms=tta_ms, tta_max_abs_err=errs)


def tta_kernel_checks(model, tta, image, seen):
    """``image_io``, K1 and K2 against their plain versions on the TTA
    path's own inputs: ``tta``'s augmentations of ``image`` (``image_io``
    bit for bit, and the batch the path ran on, ``seen["images"]``, equal
    to the plain version's), K1 on that batch (``model_stem_check``), K2
    on its proposals and on the rescoring pass's given boxes
    (``seen["given"]``, mostly zero padding rows) (``check_roi``). The
    largest error per kernel."""
    from proben_tpu_torch.models import rcnn
    from proben_tpu_torch.native import io
    from proben_tpu_torch.ops import roi_align_cuda

    cfg = model.cfg
    augs = tta._augmentations(*image.shape[:2])
    args = ([image] * len(augs), None, "BGR", [(nh, nw) for nh, nw, _ in augs], (H, W),
            [f for _, _, f in augs])
    got, ref = io.compose_resize_pad(*args), io.compose_resize_pad_plain(*args)
    if not (torch.equal(got, ref) and torch.equal(seen["images"], ref)):
        raise AssertionError("TTA: image_io's augmentations differ from the plain version's, or the "
                             "batch the path ran on differs from them")
    log(f"TTA: image_io's {len(augs)} augmentations (h, w, flip) {augs} equal the plain version's "
        "bit for bit, and the path's batch equals them")
    out = {"image_io": 0.0}
    with torch.inference_mode():
        out["stem_pool"] = model_stem_check(model, cfg, ref)
        feats = rcnn.extract_features(model, cfg, rcnn.preprocess(cfg, ref))
        aug_sizes = torch.tensor([a[:2] for a in augs], dtype=torch.int32, device="cuda")
        levels = rcnn.roi_levels(feats)
        errs = []
        for what, bx in (("proposals", rcnn.propose(model, cfg, feats, aug_sizes)[0]),
                         ("given boxes", torch.as_tensor(seen["given"], device="cuda"))):
            lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(levels, bx, **cfg.roi.pooler_args)
            errs.append(check_roi(levels, lvl, y0, x0, wy, wx, bx.shape[1],
                                  f"TTA {what} ({bx.shape[0]} x {bx.shape[1]})"))
    out["roi_align_fwd"] = max(errs)
    return out


def heads_phase(card):
    """The other detector heads at the main path's width: R101, 3 classes,
    bf16, batch 8, 800x1024 (true 800x1000), random weights from seeds 10-12
    with random affines, calibrated (``c4_phase``, ``cascade_phase``,
    ``retinanet_phase``, ``proposal_tta_phase``). One ``heads`` JSON line."""
    rng = np.random.RandomState(7)
    images = torch.from_numpy(structured_images(rng, 1, BATCH, H, W, 3)[0]).cuda()
    sizes = torch.tensor([TRUE_HW] * BATCH, dtype=torch.int32, device="cuda")
    batch = train_batch()
    t0 = time.time()
    k2_c4, k3_c4, c4_launches, c4_stats = c4_phase(images, sizes, batch)
    torch.cuda.empty_cache()
    model, k2_cas, k3_cas, cas_launches, cas_stats = cascade_phase(images, sizes, batch)
    pt_launches, pt_stats = proposal_tta_phase(model, images, sizes)
    del model
    torch.cuda.empty_cache()
    rn_launches, rn_stats = retinanet_phase(images, sizes, batch)
    torch.cuda.empty_cache()
    launches = {"c4_inference": c4_launches["inference"], "c4_train": c4_launches["train"],
                "cascade_inference": cas_launches["inference"], "cascade_train": cas_launches["train"],
                "retinanet_inference": rn_launches["inference"], "retinanet_train": rn_launches["train"],
                "proposal_network_inference": pt_launches["proposal_network"],
                "tta_rescore (10 augmentations)": pt_launches["tta"]}
    stats = {"c4": c4_stats, "cascade": cas_stats, "retinanet": rn_stats, **pt_stats,
             "launches": launches, "seconds": time.time() - t0, "card": card}
    return dict(k2_c4=k2_c4, k3_c4=k3_c4, k2_cascade=k2_cas, k3_cascade=k3_cas), stats


# ---------------------------------------------------------------------------
# The other datasets: Pascal VOC, LVIS and Cityscapes through DefaultTrainer.test
# ---------------------------------------------------------------------------

SPLIT_IMAGES = 16  # images per synthetic split
VOC_HW = (375, 500)  # (H, W) of a typical Pascal VOC 2007 image
COCO_HW = (480, 640)  # of a typical COCO val2017 image (LVIS's images)
CITYSCAPES_HW = (1024, 2048)  # of every Cityscapes frame
LVIS_FREQUENCIES = (("r", 337), ("c", 461), ("f", 405))  # LVIS v1's 1203 categories
CITIES = ("frankfurt", "lindau", "munster")  # Cityscapes' val cities
# each split's dataset settings from detectron2's public config for the
# dataset, as opts over configs/Base-RCNN-FPN.yaml at MODEL.RESNETS.DEPTH 101;
# INPUT.PAD_SHAPE is the port's static canvas
DATASET_OPTS = {
    # PascalVOC-Detection/faster_rcnn_R_50_FPN.yaml
    "voc_2007_test": ["MODEL.ROI_HEADS.NUM_CLASSES", "20"],
    # LVISv1-InstanceSegmentation/mask_rcnn_R_101_FPN_1x.yaml
    "lvis_v1_val": ["MODEL.ROI_HEADS.NUM_CLASSES", "1203", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0001",
                    "TEST.DETECTIONS_PER_IMAGE", "300"],
    # Cityscapes/mask_rcnn_R_50_FPN.yaml
    "cityscapes_fine_instance_seg_val": ["MODEL.ROI_HEADS.NUM_CLASSES", "8", "INPUT.MIN_SIZE_TEST", "1024",
                                         "INPUT.MAX_SIZE_TEST", "2048", "INPUT.PAD_SHAPE", "[1024, 2048]"],
}
HEADLINE = {"voc_2007_test": ("bbox", "AP50"), "lvis_v1_val": ("bbox", "AP"),
            "cityscapes_fine_instance_seg_val": ("segm", "AP")}
# headline AP points the kernel run may fall below the plain bf16 run, both
# scored against the plain f32 run's detections (see ``split_phase``): on
# these 16-image splits of a random model, whose near-tied detections
# bf16 rounding reorders, correct kernels measured +10.7 to -8.9 points
AP_TOLERANCE = 15.0
# the plain f32 run's detections per image that ``split_phase`` takes as
# the ground truth its AP check scores against: Cityscapes' native scorer
# takes a full-frame mask IoU per pair of ground truth and detection of a
# class, so with ~32 per image the split's scoring outlasted the script's
# time limit
REFERENCE_TOPK = 10
# detections per image the calibration aims at: Cityscapes' evaluator
# rasterizes, encodes and writes a 2048x1024 mask per detection on the host
# (as the JAX package does), so its split aims lower, near a street scene's
# 10-30 instances
CALIBRATION_TARGET = {"cityscapes_fine_instance_seg_val": (10, 30)}


def scene_boxes(rng, h, w, scale=1.0):
    """1-6 integer boxes (x0, y0, w, h) inside an h x w image, of
    ``write_flir_tree``'s sizes times ``scale``."""
    out = []
    for _ in range(rng.randint(1, 7)):
        bw, bh = int(rng.randint(16, 120) * scale), int(rng.randint(24, 160) * scale)
        out.append((int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh)), bw, bh))
    return out


def write_builtin_tree(codec, cv2, root, n=SPLIT_IMAGES, seed=30):
    """Three splits in detectron2's builtin layouts under ``root``, so that
    ``register_all_builtin(root)`` finds them under their builtin names, each
    image a ``flir_scene`` of its boxes (colour):

    - ``VOC2007/``: ``n`` JPEGs at 500x375 (nvJPEG, quality 90), XML with
      1-based inclusive boxes of the 20 classes, about a fifth
      ``difficult``, each class present with an object that is not (as in
      VOC 2007: a class of difficult objects only has no positives, and
      the evaluator scores it AP 0); the test and trainval lists name all
      of them;
    - ``lvis/lvis_v1_val.json`` over ``coco/val2017/`` JPEGs at 640x480:
      LVIS v1's 1203 categories with their frequency split (337 rare, 461
      common, 405 frequent), images located by ``coco_url``, 20
      ``neg_category_ids`` and one ``not_exhaustive_category_ids`` each;
    - ``cityscapes/leftImg8bit/val/<city>/*_leftImg8bit.png`` at 2048x1024
      (cv2, lossless) with ``gtFine`` polygon JSONs: integer axis-aligned
      rectangles of the 8 thing classes (so a box rasterized by the
      evaluator's adapter equals its ground-truth mask), a crowd group, a
      stuff region and a deleted object each.

    Returns the source pixels of the first Cityscapes frame (uint8 BGR,
    host)."""
    from proben_tpu_torch.data.cityscapes import CITYSCAPES_THING_CLASSES
    from proben_tpu_torch.data.pascal_voc import VOC_CLASS_NAMES

    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def jpeg(path, hw, boxes):
        with open(path, "wb") as f:
            f.write(codec.encode(flir_scene(gen, *hw, boxes, 3, 1.0, 1.0), quality=90))

    voc = os.path.join(root, "VOC2007")
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    ids = [f"{2 * i + 5:06d}" for i in range(n)]
    positive = set()  # classes with an object that is not difficult so far
    for fid in ids:
        boxes = scene_boxes(rng, *VOC_HW)
        jpeg(os.path.join(voc, "JPEGImages", fid + ".jpg"), VOC_HW, boxes)
        objs = ""
        for x0, y0, bw, bh in boxes:
            cls = VOC_CLASS_NAMES[rng.randint(20)]
            difficult = int(rng.rand() < 0.2 and cls in positive)
            positive |= {cls} if not difficult else set()
            objs += (f"<object><name>{cls}</name><pose>Unspecified</pose><difficult>{difficult}</difficult>"
                     f"<bndbox><xmin>{x0 + 1}</xmin><ymin>{y0 + 1}</ymin><xmax>{x0 + bw}</xmax>"
                     f"<ymax>{y0 + bh}</ymax></bndbox></object>")
        with open(os.path.join(voc, "Annotations", fid + ".xml"), "w") as f:
            f.write(f"<annotation><folder>VOC2007</folder><filename>{fid}.jpg</filename><size>"
                    f"<width>{VOC_HW[1]}</width><height>{VOC_HW[0]}</height><depth>3</depth></size>"
                    f"{objs}</annotation>")
    for split in ("test", "trainval"):
        with open(os.path.join(voc, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n")

    os.makedirs(os.path.join(root, "coco", "val2017"), exist_ok=True)
    os.makedirs(os.path.join(root, "lvis"), exist_ok=True)
    freq = [f for f, k in LVIS_FREQUENCIES for _ in range(k)]
    cats = [{"id": c + 1, "name": f"lvis_category_{c + 1}", "frequency": f} for c, f in enumerate(freq)]
    images, anns = [], []
    for i in range(n):
        img_id = 139 + 1000 * i
        boxes = scene_boxes(rng, *COCO_HW)
        jpeg(os.path.join(root, "coco", "val2017", f"{img_id:012d}.jpg"), COCO_HW, boxes)
        present = [int(c) for c in rng.randint(1, len(cats) + 1, len(boxes))]
        absent = np.setdiff1d(np.arange(1, len(cats) + 1), present)
        images.append({"id": img_id, "height": COCO_HW[0], "width": COCO_HW[1],
                       "coco_url": f"http://images.cocodataset.org/val2017/{img_id:012d}.jpg",
                       "neg_category_ids": [int(c) for c in rng.choice(absent, 20, replace=False)],
                       "not_exhaustive_category_ids": present[:1]})
        for c, (x0, y0, bw, bh) in zip(present, boxes):
            anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": c,
                         "bbox": [float(x0), float(y0), float(bw), float(bh)], "area": float(bw * bh)})
    with open(os.path.join(root, "lvis", "lvis_v1_val.json"), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)

    first = None
    h, w = CITYSCAPES_HW
    for i in range(n):
        city = CITIES[i % len(CITIES)]
        stem = f"{city}_{i:06d}_000019_"
        for sub in ("leftImg8bit", "gtFine"):
            os.makedirs(os.path.join(root, "cityscapes", sub, "val", city), exist_ok=True)
        boxes = scene_boxes(rng, h, w, scale=3.2)
        pixels = flir_scene(gen, h, w, boxes, 3, 1.0, 1.0).cpu().numpy()
        path = os.path.join(root, "cityscapes", "leftImg8bit", "val", city, stem + "leftImg8bit.png")
        if not cv2.imwrite(path, pixels):
            raise AssertionError(f"cv2 could not write {path}")
        first = pixels if first is None else first
        objects = [{"label": CITYSCAPES_THING_CLASSES[rng.randint(8)],
                    "polygon": [[x0, y0], [x0 + bw - 1, y0], [x0 + bw - 1, y0 + bh - 1], [x0, y0 + bh - 1]]}
                   for x0, y0, bw, bh in boxes]
        objects += [{"label": "cargroup", "polygon": [[0, 900], [300, 900], [300, 1023], [0, 1023]]},
                    {"label": "road", "polygon": [[0, 1000], [w - 1, 1000], [w - 1, h - 1], [0, h - 1]]},
                    {"label": "person", "deleted": 1, "polygon": [[5, 5], [50, 5], [50, 90]]}]
        with open(os.path.join(root, "cityscapes", "gtFine", "val", city, stem + "gtFine_polygons.json"),
                  "w") as f:
            json.dump({"imgHeight": h, "imgWidth": w, "objects": objects}, f)
    return first


def check_png_batch(codec, cv2, dicts, source):
    """Cityscapes' PNGs on the card: ``decode_host`` gives the written
    pixels (lossless) and cv2's, and ``image_io``'s canvas of a batch of
    two, at scale 1 through the test mapper and downscaled through
    ``load_batch`` (one launch each), equals ``compose_resize_pad_plain``
    of the same host-decoded pixels within the JPEG check's 1e-3 (both run
    the same float operations; 0 expected). Times: ``decode_host`` per
    PNG, the compose kernel at the Cityscapes path's own sizes (scale 1
    into the 1024x2048 canvas, as the mapper ran it) against its bound."""
    from proben_tpu_torch.data import DatasetMapper, MapperConfig
    from proben_tpu_torch.data.transforms import resize_shortest_edge_size
    from proben_tpu_torch.native import io

    paths = [d["file_name"] for d in dicts[:2]]
    host = [io.decode_host(p) for p in paths]
    if not (np.array_equal(host[0].cpu().numpy(), source)
            and np.array_equal(host[0].cpu().numpy(), cv2.imread(paths[0], cv2.IMREAD_COLOR))):
        raise AssertionError("decode_host's pixels differ from the written PNG's or from cv2.imread's")
    mapper = DatasetMapper(MapperConfig(pad_shape=CITYSCAPES_HW, min_size_test=CITYSCAPES_HW[0],
                                        max_size_test=CITYSCAPES_HW[1]), is_train=False)
    try:
        samples, launches = counted(lambda: mapper.map_batch(dicts[:2]))
    finally:
        mapper.close()
    canvas = torch.stack([s["image"] for s in samples])
    sizes = [tuple(int(v) for v in s["image_size"]) for s in samples]
    err = float((canvas - io.compose_resize_pad_plain(host, None, "BGR", sizes, CITYSCAPES_HW)).abs().max())
    down = [resize_shortest_edge_size(*CITYSCAPES_HW, 800, 1333)] * 2
    (images, _, _), launches2 = counted(lambda: io.load_batch(codec, paths, None, "BGR",
                                                              lambda h, w: down[0], (800, 1344)))
    err = max(err, float((images - io.compose_resize_pad_plain(host, None, "BGR", down, (800, 1344))).abs().max()))
    if launches["image_io"] != 1 or launches2["image_io"] != 1 or err > 1e-3:
        raise AssertionError(f"PNG batch: image_io launches {launches['image_io']} and "
                             f"{launches2['image_io']}, max |err| {err} against the plain version")
    ms = cuda_ms(lambda: io.compose_resize_pad(host, None, "BGR", sizes, CITYSCAPES_HW), 30)
    plain_ms = cuda_ms(lambda: io.compose_resize_pad_plain(host, None, "BGR", sizes, CITYSCAPES_HW), 5)
    nbytes = canvas.numel() * 4 + sum(x.numel() for x in host)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=nbytes / HBM_BYTES_S * 1e3,
               mbytes=nbytes / 1e6, sizes=sizes, checked_sizes=[sizes, down],
               decode_host_ms=host_ms(lambda: io.decode_host(paths[0])))
    log(f"PNG batch (2 Cityscapes frames): image_io launches 1 and 1, max |err| {err} against the plain "
        f"version on cv2's pixels at {sizes[0]} and {down[0]}; decode_host {row['decode_host_ms']:.4g} ms per "
        f"2048x1024 PNG; kernel {ms:.4g} ms at {sizes[0]} into {CITYSCAPES_HW}, plain {plain_ms:.4g} ms, "
        f"bound {row['bound_ms']:.4g} ms")
    return row


class recorded_predictions:
    """While active, records what ``Predictor.predict_batch`` returns: the
    detections ``DefaultTrainer.test`` hands its evaluator, image by image."""

    def __enter__(self):
        from proben_tpu_torch.engine.predictor import Predictor

        self.records, self._orig = [], Predictor.predict_batch

        def predict_batch(predictor, batch):
            out = self._orig(predictor, batch)
            self.records.extend(out)
            return out

        Predictor.predict_batch = predict_batch
        return self.records

    def __exit__(self, *exc):
        from proben_tpu_torch.engine.predictor import Predictor

        Predictor.predict_batch = self._orig


def gt_records(dicts):
    """Each image's non-crowd ground truth as detections of score 1 (XYXY,
    contiguous classes), as ``Predictor.predict_batch`` gives them."""
    from proben_tpu_torch.structures.boxes import BoxMode, convert_box_mode

    out = []
    for d in dicts:
        anns = [a for a in d["annotations"] if not a.get("iscrowd", 0)]
        boxes = np.array([convert_box_mode(np.asarray(a["bbox"], np.float32), a["bbox_mode"],
                                           BoxMode.XYXY_ABS) for a in anns], np.float32).reshape(-1, 4)
        out.append({"image_id": d["image_id"], "boxes": boxes, "scores": np.ones(len(anns), np.float32),
                    "classes": np.array([a["category_id"] for a in anns], np.int64)})
    return out


class ReplayPredictor:
    """``predict_batch`` giving recorded detections by image id."""

    def __init__(self, records):
        self.by_id = {r["image_id"]: r for r in records}

    def predict_batch(self, batch):
        return [self.by_id[i] for i in batch["image_id"]]


def reference_split(name, dicts, records, topk=REFERENCE_TOPK):
    """Registers ``name + "_reference"``: the split's images and metadata
    with ``records`` (a run's detections, the ``topk`` highest-scoring of
    each image) as its ground truth, so that the split's evaluator scores
    another run against that one. Each detection becomes a non-crowd,
    non-difficult object of its class: XYXY_ABS for VOC; for LVIS an
    annotation of its 1-based category in an annotation dict, each
    image's other categories verified absent (``neg_category_ids``), none
    not exhaustive; for Cityscapes a rectangle polygon on the integer
    pixels the evaluator's adapter fills for the box, scored by the native
    scorer (no ``gt_dir``). Returns the new name."""
    from proben_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from proben_tpu_torch.structures.boxes import BoxMode

    ref = name + "_reference"
    meta = {k: v for k, v in vars(MetadataCatalog.get(name)).items() if k not in ("name", "gt_dir")}
    by_id = {}
    for r in records:
        keep = np.argsort(-r["scores"], kind="stable")[:topk]
        by_id[r["image_id"]] = {k: r[k][keep] for k in ("boxes", "scores", "classes")}
    out, anns = [], []
    for d in dicts:
        r, h, w = by_id[d["image_id"]], d["height"], d["width"]
        objs = []
        for (x0, y0, x1, y1), c in zip(r["boxes"].tolist(), r["classes"].tolist()):
            px0, py0, px1, py1 = int(max(x0, 0)), int(max(y0, 0)), int(min(x1, w)), int(min(y1, h))
            objs.append({"bbox": [x0, y0, x1, y1], "bbox_mode": BoxMode.XYXY_ABS, "category_id": int(c),
                         "iscrowd": 0, "difficult": 0,
                         "segmentation": [[px0, py0, px1, py0, px1, py1, px0, py1]]})
            anns.append({"id": len(anns) + 1, "image_id": d["image_id"], "category_id": int(c) + 1,
                         "bbox": [x0, y0, x1 - x0, y1 - y0], "area": (x1 - x0) * (y1 - y0)})
        out.append(dict(d, annotations=objs))
    if meta.get("evaluator_type") == "lvis":
        with open(meta["json_file"]) as f:
            cats = json.load(f)["categories"]
        images = [{"id": d["image_id"], "height": d["height"], "width": d["width"],
                   "neg_category_ids": sorted({c["id"] for c in cats} - {int(k) + 1 for k in
                                                                         by_id[d["image_id"]]["classes"]}),
                   "not_exhaustive_category_ids": []} for d in dicts]
        meta["json_file"] = {"images": images, "annotations": anns, "categories": cats}
    DatasetCatalog.remove(ref)
    DatasetCatalog.register(ref, lambda: out)
    MetadataCatalog.get(ref).__dict__.update(meta)
    return ref


def replay_ap(name, records, out_dir, headline):
    """The ``headline`` (task, metric) of ``records`` through a
    ``build_evaluator`` object of split ``name`` and
    ``inference_on_dataset`` (which resets it first)."""
    from proben_tpu_torch.evaluation import build_evaluator, inference_on_dataset

    task, metric = headline
    loader = [{"image_id": [r["image_id"]]} for r in records]
    return float(inference_on_dataset(ReplayPredictor(records), loader,
                                      build_evaluator(name, output_dir=out_dir))[task][metric])


def dataset_cfg(opts, out_dir):
    """``configs/Base-RCNN-FPN.yaml`` at R101 (bf16, as the YAML sets it)
    with a split's opts."""
    from proben_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(HERE, "configs", "Base-RCNN-FPN.yaml"))
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "101", "OUTPUT_DIR", out_dir] + list(opts))
    return cfg


def oracle_phase(name, dicts, out_dir):
    """The split's ground truth as detections of score 1 through
    ``build_evaluator``'s object and ``inference_on_dataset`` (which resets
    it first): the headline AP must be 100; for VOC under the 07 11-point
    metric (the split's year) and the continuous one."""
    from proben_tpu_torch.evaluation import build_evaluator, inference_on_dataset

    loader = [{"image_id": [d["image_id"]]} for d in dicts]
    task, metric = HEADLINE[name]
    evaluators = {"": build_evaluator(name, output_dir=out_dir)}
    if name.startswith("voc"):
        evaluators[" (continuous)"] = build_evaluator(name, output_dir=out_dir)
        evaluators[" (continuous)"].use_07 = False
    got = {}
    for label, ev in evaluators.items():
        got[metric + label] = inference_on_dataset(ReplayPredictor(gt_records(dicts)), loader,
                                                   ev)[task][metric]
    log(f"{name}: ground truth as detections gives {got}")
    if any(abs(v - 100.0) > 1e-6 for v in got.values()):
        raise AssertionError(f"{name}: the ground truth as detections gives {got}, not 100")
    return got


def split_predictions(model, mcfg, cfg, dicts):
    """The split through ``Predictor.predict_batch`` at batch 1, as
    ``DefaultTrainer.test`` maps it, with no evaluator."""
    from proben_tpu_torch.config import mapper_config_from_cfg
    from proben_tpu_torch.data import DatasetMapper, build_test_loader
    from proben_tpu_torch.engine import Predictor

    pred, out = Predictor(model, mcfg), []
    mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=False)
    try:
        for batch in build_test_loader(dicts, mapper, batch_size=1):
            out.extend(pred.predict_batch(batch))
    finally:
        mapper.close()
    return out


def split_kernel_checks(name, model, cfg, batch):
    """K1 and K2 against their plain versions on a split's mapped batch:
    its canvas into the stem (``model_stem_check``), the FPN maps and the
    calibrated model's proposals (``check_roi``). The largest error per
    kernel."""
    from proben_tpu_torch.models import rcnn
    from proben_tpu_torch.ops import roi_align_cuda

    with torch.inference_mode():
        out = {"stem_pool": model_stem_check(model, cfg, batch["image"])}
        feats = rcnn.extract_features(model, cfg, rcnn.preprocess(cfg, batch["image"]))
        levels = rcnn.roi_levels(feats)
        boxes = rcnn.propose(model, cfg, feats, batch["image_size"])[0]
        lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(levels, boxes, **cfg.roi.pooler_args)
        out["roi_align_fwd"] = check_roi(levels, lvl, y0, x0, wy, wx, boxes.shape[1],
                                         f"{name} canvas {tuple(batch['image'].shape)}, its "
                                         f"{boxes.shape[0]} x {boxes.shape[1]} proposals")
    return out


def split_phase(name, seed, root, card):
    """One split through ``DefaultTrainer.test`` on the card, R101-FPN in
    bf16 with the dataset's opts, random affines, RPN and head calibrated on
    the split's first 8 images (as ``flir_model``; ``CALIBRATION_TARGET``).
    Checks:

    - launches counted around the whole call: ``image_io``, K1 and K2 once
      per image (batch 1);
    - K1 and K2 against their plain versions on the split's own inputs at
      batch 1 (``split_kernel_checks``: the first image's canvas as the
      path maps it, 1024x2048 for Cityscapes, and its proposals);
    - the kernels against their plain versions on the split, under
      ``slice_phase``'s limits: with only the stem plain (K2 the only
      difference) >= 95% of the detections match the plain run's both ways;
      with both kernels, at least as well as the plain bf16 run matches the
      plain f32 run, less 5 points; each FPN map within 1.5x the bf16-vs-f32
      gap;
    - the headline AP of the kernel run at least the plain bf16 run's
      less ``AP_TOLERANCE`` points (one-sided, as the detection check;
      the kernel run may land on either side), each scored by the split's
      evaluator against the plain f32 run's ``REFERENCE_TOPK`` detections
      per image as ground truth (``reference_split``, ``replay_ap``): the
      random model's classes are random, so against the split's own
      ground truth both score 0 whatever the kernels do; and the score
      must see the detections: the plain run's above that of the kernel
      run's detections moved to the next image by more than
      ``AP_TOLERANCE``;
    - the ground truth as detections at AP 100 (``oracle_phase``).

    Readings: eval img/s end to end (the whole call, evaluator build and
    ``evaluate()`` included; with the kernels the median of three runs,
    each counted) and ``inference_on_dataset``'s load / infer / process /
    evaluate seconds (first image excluded) of that run; the plain run's
    once."""
    from proben_tpu_torch.config import mapper_config_from_cfg, model_config_from_cfg
    from proben_tpu_torch.data import DatasetCatalog, DatasetMapper, collate
    from proben_tpu_torch.engine import DefaultTrainer, Predictor
    from proben_tpu_torch.models import build_model, init_rcnn, random_affines

    cfg = dataset_cfg(DATASET_OPTS[name], os.path.join(root, "out", name))
    cfg.DATASETS.TEST = (name,)
    dicts = DatasetCatalog.get(name)
    mcfg = model_config_from_cfg(cfg)
    model = build_model(mcfg, params=random_affines(init_rcnn(seed, mcfg), seed))
    mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=False)
    try:
        batch = collate(mapper.map_batch(dicts[:BATCH]))
        first = collate(mapper.map_batch(dicts[:1]))
    finally:
        mapper.close()
    calibrate_rpn(model, batch["image"])
    bias, n_cal = calibrate(model, Predictor(model, mcfg), batch["image"], batch["image_size"], hi=32.0,
                            target=CALIBRATION_TARGET.get(name, (20, 80)))
    log(f"{name}: {mcfg.num_classes} classes, background bias {bias:.4g} -> {n_cal:.1f} dets/img")

    plain = cfg.clone()
    plain.merge_from_list(["MODEL.STEM_IMPL", "direct", "MODEL.ROI_ALIGN_IMPL", "gather",
                           "OUTPUT_DIR", cfg.OUTPUT_DIR + "_plain"])
    timing = TimingRecords()

    def run(run_cfg):
        timing.records.clear()
        with recorded_predictions() as recs:
            t = time.time()
            results, launches = counted(lambda: DefaultTrainer.test(run_cfg, model))
            wall = time.time() - t
        if len(timing.records) != 1 or len(recs) != len(dicts):
            raise AssertionError(f"{name}: {len(recs)} images predicted, timing {timing.records}")
        return dict(results=results, launches=launches, wall_s=wall, dets=list(recs), timing=timing.records[0])

    try:
        runs = {"kernels": run(cfg)}
        with k4_off():
            runs["plain"] = run(plain)
        # two more kernel runs: the rate is the median of three
        repeats = sorted([runs["kernels"], run(cfg), run(cfg)], key=lambda r: r["wall_s"])
    finally:
        timing.close()
    n = len(dicts)
    if any(r["launches"] != runs["kernels"]["launches"] for r in repeats):
        raise AssertionError(f"{name}: launches differ between runs: {[r['launches'] for r in repeats]}")
    expect_launches(f"{name}: DefaultTrainer.test over {n} images", runs["kernels"]["launches"],
                    {"stem_pool": n, "roi_align_fwd": n, "image_io": n, **k4_expect(n), **k5_expect(n)})
    expect_launches(f"{name}: the plain run (K4 off)", runs["plain"]["launches"],
                    {"image_io": n, "block_epilogue": 0, "epilogue_plain": k4_expect(n)["block_epilogue"],
                     **k5_expect(n)})
    out_k, out_p = runs["kernels"]["dets"], runs["plain"]["dets"]
    for r in out_k:
        if not (np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()) or \
                r["boxes"].shape[1:] != (4,) or len(r["boxes"]) > cfg.TEST.DETECTIONS_PER_IMAGE:
            raise AssertionError(f"{name}: bad detections of shape {r['boxes'].shape}")
    plain_mcfg = mcfg.replace(stem_impl="plain", roi_align_impl="plain")
    with k4_off():
        out_k2 = split_predictions(model, mcfg.replace(stem_impl="plain"), cfg, dicts)
    out_32 = split_predictions(model, plain_mcfg.replace(compute_dtype="float32"), cfg, dicts)

    def both(a, b):
        return min(match_fraction(a, b), match_fraction(b, a))

    m_k2, m_all, m_32 = both(out_k2, out_p), both(out_k, out_p), both(out_p, out_32)
    gap_k = feature_gap(model, mcfg, plain_mcfg, batch["image"])
    gap_32 = feature_gap(model, plain_mcfg, plain_mcfg.replace(compute_dtype="float32"), batch["image"],
                         plain=(True, True))
    task, metric = HEADLINE[name]
    ap_k, ap_p = runs["kernels"]["results"][task][metric], runs["plain"]["results"][task][metric]
    dets_k = float(np.mean([len(r["scores"]) for r in out_k]))
    log(f"{name}: {dets_k:.1f} dets/img; matched (worse direction): K2 only {100 * m_k2:.2f}%, both kernels "
        f"{100 * m_all:.2f}%, bf16 vs f32 control {100 * m_32:.2f}%; {task} {metric} kernels {ap_k:.4f}, "
        f"plain {ap_p:.4f}; FPN gap kernels-vs-plain / bf16-vs-f32: "
        + ", ".join(f"{k} {gap_k[k]:.3g}/{gap_32[k]:.3g}" for k in gap_k))
    if m_k2 < 0.95 or dets_k == 0:
        raise AssertionError(f"{name}: K2 and plain detections disagree")
    if any(gap_k[k] > 1.5 * gap_32[k] for k in gap_k):
        raise AssertionError(f"{name}: kernel-path features differ from the plain path's beyond bf16 rounding")
    if m_all < m_32 - 0.05:
        raise AssertionError(f"{name}: kernel-path detections agree worse than the bf16-vs-f32 control")
    if not (np.isfinite(ap_k) and np.isfinite(ap_p)):
        raise AssertionError(f"{name}: {metric} {ap_k} with the kernels, {ap_p} plain")
    # the plain f32 run's detections as the split's ground truth: the
    # random model's own classes and boxes, which the kernel run must find
    # again at least as well as the plain bf16 run
    ref = reference_split(name, dicts, out_32)
    moved = [dict(r, image_id=out_k[(i + 1) % n]["image_id"]) for i, r in enumerate(out_k)]
    ap_ref = {key: replay_ap(ref, recs, os.path.join(root, "out", f"{ref}_{key}"), HEADLINE[name])
              for key, recs in (("kernels", out_k), ("plain", out_p), ("kernels_next_image", moved))}
    log(f"{name}: {task} {metric} against the plain f32 run's detections as ground truth: {ap_ref}; "
        f"kernels - plain {ap_ref['kernels'] - ap_ref['plain']:.4g} points, tolerance -{AP_TOLERANCE}")
    if not all(np.isfinite(v) for v in ap_ref.values()) or ap_ref["kernels"] < ap_ref["plain"] - AP_TOLERANCE:
        raise AssertionError(f"{name}: {metric} against the f32 run's detections {ap_ref}: the kernel run's "
                             f"is below the plain run's by more than {AP_TOLERANCE} points")
    if ap_ref["plain"] - ap_ref["kernels_next_image"] <= AP_TOLERANCE:
        raise AssertionError(f"{name}: {metric} against the f32 run's detections {ap_ref}: the score does not "
                             f"tell the detections from another image's by more than {AP_TOLERANCE} points")
    kernel_errs = split_kernel_checks(name, model, mcfg, first)
    oracle = oracle_phase(name, dicts, os.path.join(root, "out", name + "_oracle"))

    def reading(run):
        tm = run["timing"]
        return dict(eval_img_s=n / run["wall_s"], wall_s=run["wall_s"], **tm,
                    model_img_s=tm["images"] / tm["infer_s"])

    stats = dict(images=n, classes=mcfg.num_classes, canvas=list(cfg.INPUT.PAD_SHAPE), dets_per_img=dets_k,
                 kernels=dict(reading(repeats[1]), eval_img_s_min_max=[n / repeats[2]["wall_s"],
                                                                       n / repeats[0]["wall_s"]]),
                 plain=reading(runs["plain"]),
                 launches=runs["kernels"]["launches"], results=runs["kernels"]["results"],
                 results_plain=runs["plain"]["results"], ap_against_f32_run=ap_ref, max_abs_err=kernel_errs,
                 matched_k2=m_k2, matched=m_all,
                 matched_bf16_f32=m_32, fpn_gap=gap_k, fpn_gap_bf16_f32=gap_32, oracle=oracle, card=card)
    k = stats["kernels"]
    log(f"{name} ({card}): eval {k['eval_img_s']:.4g} img/s end to end over {n} images at batch 1, median "
        f"of 3 runs (min {k['eval_img_s_min_max'][0]:.4g}, max {k['eval_img_s_min_max'][1]:.4g}; plain, one "
        f"run: {stats['plain']['eval_img_s']:.4g}); median run: load {k['load_s']:.4g} s, infer "
        f"{k['infer_s']:.4g} s, process {k['process_s']:.4g} s, evaluate {k['evaluate_s']:.4g} s over the "
        f"last {k['images']} images")
    del model
    torch.cuda.empty_cache()
    return stats


def voc_train_phase(root, card, steps=4, seed=45):
    """Four ``DefaultTrainer`` steps on ``voc_2007_trainval`` (boxes
    XYXY_ABS from the XML, ``difficult`` kept), R101-FPN bf16 from
    ``Base-RCNN-FPN.yaml`` as shipped (batch 16, 640-800 with flips at
    its 800x1344 canvas, FREEZE_AT 2) with 20 classes and detectron2
    weights of random affines, watched as the trainer phase's runs
    (``TrainWatch``, every step counted): each step launches K1, K2 and
    K3 once, the run's ``image_io`` launches equal the batches the loader
    mapped (no evaluation), every loss finite (``train_run_stats``); then
    K1-K3 held against their plain versions on one more batch of 16 from
    the trainer's loader (``held_batch_checks``)."""
    from proben_tpu_torch.engine import DefaultTrainer

    out = os.path.join(root, "out", "voc_train")
    os.makedirs(out, exist_ok=True)
    cfg = dataset_cfg(DATASET_OPTS["voc_2007_test"], out)
    cfg.merge_from_list(["DATASETS.TRAIN", "['voc_2007_trainval']", "DATASETS.TEST", "[]",
                         "SOLVER.MAX_ITER", str(steps), "TEST.EVAL_PERIOD", "0", "SEED", str(seed)])
    cfg.MODEL.WEIGHTS = d2_weights(cfg, seed, os.path.join(out, "init.pth"))
    if cfg.SOLVER.IMS_PER_BATCH != TRAIN_BATCH:
        raise AssertionError(f"VOC training: batch {cfg.SOLVER.IMS_PER_BATCH}, the checks take {TRAIN_BATCH}")
    label = "voc_2007_trainval training"
    watch = TrainWatch(count_iter=1, hold_batch=True, every_step=True)
    zero_launch_counts()
    t = time.time()
    trainer = DefaultTrainer(cfg)
    trainer.register_hooks(watch.hooks())
    trainer.train()
    wall = time.time() - t
    one = {"stem_pool": 1, "roi_align_fwd": 1, "roi_align_bwd": 1,
           **k4_expect(1, cfg.MODEL.BACKBONE.FREEZE_AT), **k5_expect(steps=1)}
    stats = train_run_stats(label, watch, launch_counts(), one, steps, 0)
    held = held_batch_checks(watch, label, stem=True)
    stats.update(held_batch=held, wall_s=wall, per_step=watch.per_step, card=card)
    log(f"{label} ({card}): {steps} steps of {TRAIN_BATCH} in {wall:.1f} s, step s {stats['step_s']}")
    return stats


def datasets_phase(card):
    """The other datasets on the card: three synthetic splits in the
    builtin layouts (``write_builtin_tree``) registered by
    ``register_all_builtin``, Cityscapes' PNG batch through ``image_io``
    (``check_png_batch``), each split through ``DefaultTrainer.test``
    (``split_phase``), four VOC training steps (``voc_train_phase``). cv2
    (the PNG decode) and Pillow (the Cityscapes evaluator) must be
    installed: without them the phase fails. One ``datasets`` JSON line."""
    import importlib
    import tempfile

    try:
        cv2 = importlib.import_module("cv2")
        pil = importlib.import_module("PIL")
    except ImportError as e:
        raise AssertionError(f"the datasets phase needs cv2 (PNG decode on the host) and Pillow (the "
                             f"Cityscapes evaluator's masks), as the JAX package does: {e}")
    from proben_tpu_torch.data import DatasetCatalog, register_all_builtin
    from proben_tpu_torch.native import io

    stats = {"card": card, "cv2": cv2.__version__, "Pillow": pil.__version__}
    log(f"datasets phase ({card}): cv2 {cv2.__version__}, Pillow {pil.__version__}")
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="builtin_") as root, io.JpegCodec() as codec:
        t = time.time()
        first = write_builtin_tree(codec, cv2, root)
        stats["tree_s"] = time.time() - t
        log(f"builtin tree: {SPLIT_IMAGES} images per split written in {stats['tree_s']:.1f} s")
        register_all_builtin(root)
        stats["png"] = check_png_batch(codec, cv2, DatasetCatalog.get("cityscapes_fine_instance_seg_val"), first)
        for i, name in enumerate(DATASET_OPTS):
            stats[name] = split_phase(name, 40 + i, root, card)
        stats["voc_2007_trainval_train"] = voc_train_phase(root, card)
    stats["seconds"] = time.time() - t0
    return stats


# ---------------------------------------------------------------------------
# the rest of the library surface: crop on the card, structures, analysis, draw
# ---------------------------------------------------------------------------


CROP_STEPS = 4  # train_flir steps with INPUT.CROP on
# A crop of relative size 0.9 widens a 640x512 frame's aspect ratio to up to
# 640/461, so at the 800 short side an image is up to 1111 wide: the FLIR
# YAMLs' 800x1024 canvas does not hold it (the mapper raises, as JAX's does)
CROP_PAD = (800, 1120)
DRAW_IMAGES = 4  # images through ``apps/flir.py draw``


def rgb_rows_read_window(rh, th, y0, ch):
    """``rgb_rows_read`` for the thermal-frame rows y0 .. y0 + ch - 1 of a
    crop window and the row below it (a tap's second row)."""
    from proben_tpu_torch.native import io

    t0, t1, b0, b1 = io._fixed_taps(th, rh, False, "cpu")
    rows = set()
    for y in range(y0, min(y0 + ch + 1, th)):
        if b0[y]:
            rows.add(int(t0[y]))
        if b1[y]:
            rows.add(int(t1[y]))
    return len(rows)


def check_crop_mapper(codec, cfg, dicts, seed):
    """One training batch of ``TRAIN_BATCH`` FLIR files through
    ``DatasetMapper(is_train=True)`` with ``INPUT.CROP`` on the card: one
    ``image_io`` launch; crop windows, sizes and flips equal to
    ``TrainAugment``'s replayed draws from ``RandomState(seed)`` (the
    crop's four, the size, the flip, image by image), some windows off the
    frame's origin and flipped and unflipped images; the canvas equal to
    ``compose_resize_pad_plain`` with those windows bit for bit; the GT
    equal to the CPU mapper's (``random_crop`` on cv2's read), exactly.
    Then the kernel with crops timed, with its bound."""
    from proben_tpu_torch.config import mapper_config_from_cfg
    from proben_tpu_torch.data import DatasetMapper, collate
    from proben_tpu_torch.data.transforms import TrainAugment
    from proben_tpu_torch.native import io

    mcfg = mapper_config_from_cfg(cfg)
    fmt, pad = mcfg.input_format, tuple(mcfg.pad_shape)
    mapper = DatasetMapper(mcfg, is_train=True, seed=seed)
    try:
        zero_launch_counts()
        batch = collate(mapper.map_batch(dicts))
        torch.cuda.synchronize()
        one_launch = launch_counts()["image_io"]
    finally:
        mapper.close()
    if one_launch != 1:
        raise AssertionError(f"crop mapper {fmt}: {one_launch} image_io launches for one batch")
    aug = TrainAugment(mcfg.min_size_train, mcfg.max_size_train, mcfg.flip, np.random.RandomState(seed),
                       crop=mcfg.crop)
    windows, sizes, flips = [], [], []
    for _ in dicts:
        windows.append(aug.crop_window(*FLIR_T_HW))
        nh, nw, flip = aug.draw(*windows[-1][2:])
        sizes.append((nh, nw))
        flips.append(flip)
    if batch["image_size"].cpu().numpy().tolist() != [list(x) for x in sizes] \
            or batch["flip"].tolist() != flips:
        raise AssertionError(f"crop mapper {fmt}: sizes or flips are not TrainAugment's draws")
    if not any(w[0] or w[1] for w in windows) or all(flips) or not any(flips):
        raise AssertionError(f"crop mapper {fmt}: the batch needs windows off the origin and flipped "
                             f"and unflipped images ({windows}, {flips})")
    thermal, rgb = decoded_files(codec, dicts, fmt)
    want = io.compose_resize_pad_plain(thermal, rgb, fmt, sizes, pad, flips, windows)
    err = float((batch["image"] - want).abs().max())
    if not torch.equal(batch["image"], want):
        raise AssertionError(f"crop mapper {fmt}: canvas differs from the plain version by {err}")
    cpu = collate(DatasetMapper(mcfg, is_train=True, seed=seed, device="cpu").map_batch(dicts))
    if not all(torch.equal(getattr(cpu["gt"], k), getattr(batch["gt"], k).cpu())
               for k in ("boxes", "classes", "valid")) \
            or not torch.equal(cpu["image_size"], batch["image_size"].cpu()) or cpu["flip"].tolist() != flips:
        raise AssertionError(f"crop mapper {fmt}: GT, sizes or flips differ from the CPU mapper's")
    ms = cuda_ms(lambda: io.compose_resize_pad(thermal, rgb, fmt, sizes, pad, flips, windows), 30)
    # the same launch without the crops (each whole frame to the same size): what a crop changes
    uncropped_ms = cuda_ms(lambda: io.compose_resize_pad(thermal, rgb, fmt, sizes, pad, flips), 30)
    plain_ms = cuda_ms(lambda: io.compose_resize_pad_plain(thermal, rgb, fmt, sizes, pad, flips, windows), 3)
    nbytes = want.numel() * 4 + sum(w[2] * w[3] * t.shape[2] for w, t in zip(windows, thermal)) + (
        sum(rgb_rows_read_window(x.shape[0], t.shape[0], w[0], w[2]) * x.shape[1] * x.shape[2]
            for x, t, w in zip(rgb, thermal, windows)) if rgb is not None else 0)
    bound = nbytes / HBM_BYTES_S * 1e3
    log(f"crop mapper {fmt}: batch of {len(dicts)} equal to the plain version (windows "
        f"{sorted(set(w[2:] for w in windows))[:3]}..., flipped {sum(flips)}), GT equal to the CPU "
        f"mapper's; image_io with crops {ms:.4g} ms (without them {uncropped_ms:.4g}, plain {plain_ms:.4g}, "
        f"bound {bound:.4g} ms, {ms / bound:.1f}x)")
    return dict(max_abs_err=err, ms=ms, uncropped_ms=uncropped_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", mbytes=nbytes / 1e6, flipped=int(sum(flips)),
                launches_per_batch=one_launch, pad_shape=list(pad), windows=[list(w) for w in windows])


class FirstBatch:
    """A trainer's loader that keeps a copy of the first batch it hands out
    (``before_train`` puts it in place); everything else is the loader's."""

    def __init__(self, loader):
        self.loader, self.first = loader, None

    def __next__(self):
        batch = next(self.loader)
        if self.first is None:
            self.first = {k: v.clone() if torch.is_tensor(v) else v for k, v in batch.items()}
        return batch

    def __getattr__(self, name):
        return getattr(self.loader, name)


def crop_train_run(codec, root, dicts, val):
    """``train_flir("thermal_only")`` from ``faster_rcnn_R_101_FLIR.yaml``
    with ``INPUT.CROP.ENABLED`` (detectron2's relative_range 0.9) for
    ``CROP_STEPS`` steps, one loader thread (so the mapper's draws come in
    the stream's order and the first batch's windows replay): K1-K3
    counted around every step, ``image_io`` once per mapped batch; the
    trainer's first batch equal bit for bit to the plain version on its
    own indices and the replayed windows, sizes and flips, its GT equal to
    the CPU mapper's; then K1-K3 held against their plain versions on one
    more cropped batch of 16 from the trainer's loader, at the crop's
    800x1120 canvas (``held_batch_checks``)."""
    from proben_tpu_torch.apps import flir
    from proben_tpu_torch.config import get_cfg, mapper_config_from_cfg
    from proben_tpu_torch.data import DatasetMapper, collate
    from proben_tpu_torch.data.transforms import TrainAugment
    from proben_tpu_torch.engine import CallbackHook
    from proben_tpu_torch.native import io

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(HERE, "configs", "FLIR-Detection", "faster_rcnn_R_101_FLIR.yaml"))
    cfg.INPUT.CROP.ENABLED = True
    cfg.INPUT.PAD_SHAPE = CROP_PAD
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.MODEL.WEIGHTS = d2_weights(cfg, 34, os.path.join(root, "crop.pth"))
    recorder = {}

    def wrap(t):
        recorder["loader"] = t.train_loader = FirstBatch(t.train_loader)

    label = "train_flir thermal_only, INPUT.CROP"
    watch = TrainWatch(count_iter=1, every_step=True, hold_batch=True)
    zero_launch_counts()
    flir.train_flir("thermal_only", root, os.path.join(root, "out_crop"), max_iter=CROP_STEPS,
                    eval_every=1000, cfg=cfg, hooks=[CallbackHook(before_train=wrap)] + watch.hooks())
    one = {"stem_pool": 1, "roi_align_fwd": 1, "roi_align_bwd": 1,
           **k4_expect(1, cfg.MODEL.BACKBONE.FREEZE_AT), **k5_expect(steps=1)}
    stats = train_run_stats(label, watch, launch_counts(), one, CROP_STEPS,
                            eval_runs(0, CROP_STEPS, 1000) * len(val))
    if tuple(watch.held["image"].shape[1:3]) != CROP_PAD:
        raise AssertionError(f"{label}: held batch {tuple(watch.held['image'].shape)}, canvas {CROP_PAD} expected")
    stats["held_batch"] = held_batch_checks(watch, label, stem=True)
    first = recorder["loader"].first
    mcfg = mapper_config_from_cfg(cfg)
    aug = TrainAugment(mcfg.min_size_train, mcfg.max_size_train, mcfg.flip,
                       np.random.RandomState(max(cfg.SEED, 0)), crop=mcfg.crop)
    chosen = [dicts[i] for i in first["indices"]]
    windows, sizes, flips = [], [], []
    for d in chosen:
        windows.append(aug.crop_window(d["height"], d["width"]))
        nh, nw, flip = aug.draw(*windows[-1][2:])
        sizes.append((nh, nw))
        flips.append(flip)
    thermal, rgb = decoded_files(codec, chosen, "BGR")
    want = io.compose_resize_pad_plain(thermal, rgb, "BGR", sizes, tuple(mcfg.pad_shape), flips, windows)
    cpu = collate(DatasetMapper(mcfg, is_train=True, seed=max(cfg.SEED, 0), device="cpu").map_batch(chosen))
    if first["image_size"].cpu().numpy().tolist() != [list(s) for s in sizes] \
            or first["flip"].tolist() != flips or not torch.equal(first["image"], want) \
            or not all(torch.equal(getattr(cpu["gt"], k), getattr(first["gt"], k).cpu())
                       for k in ("boxes", "classes", "valid")):
        raise AssertionError("train_flir with INPUT.CROP: the trainer's first batch differs from the plain "
                             "version of its replayed windows, or its GT from the CPU mapper's")
    log(f"train_flir with INPUT.CROP: the trainer's first batch of {len(chosen)} equal to the plain version "
        f"of its replayed windows bit for bit, its GT to the CPU mapper's")
    stats.update(first_batch_equal=True, crop_size=list(mcfg.crop), loader_threads=1)
    return stats, cfg.MODEL.WEIGHTS


def paste_masks_check():
    """``paste_masks_in_image`` on the card against the CPU on the same
    inputs (100 soft 28x28 masks, boxes across an 800x1000 image and its
    edges): the float values within 1e-6, the masks at 0.5 equal wherever
    a value is not within 1e-6 of the threshold; the card's time."""
    from proben_tpu_torch.structures.masks import paste_masks_in_image

    gen = torch.Generator(device="cuda").manual_seed(40)
    m = torch.rand(100, 28, 28, generator=gen, device="cuda")
    xy = torch.rand(100, 2, generator=gen, device="cuda") * torch.tensor([1100.0, 900.0], device="cuda") - 50
    boxes = torch.cat([xy, xy + torch.rand(100, 2, generator=gen, device="cuda") * 300 + 0.5], 1)
    got = paste_masks_in_image(m, boxes, TRUE_HW, None)
    want = paste_masks_in_image(m.cpu(), boxes.cpu(), TRUE_HW, None)
    err = float((got.cpu() - want).abs().max())
    hard = paste_masks_in_image(m, boxes, TRUE_HW).cpu() != (want >= 0.5)
    near = (want - 0.5).abs() <= 1e-6
    if err > 1e-6 or bool((hard & ~near).any()):
        raise AssertionError(f"paste_masks_in_image on the card: values {err} from the CPU's, "
                             f"{int(hard.sum())} masked pixels differ")
    ms = cuda_ms(lambda: paste_masks_in_image(m, boxes, TRUE_HW), 10)
    log(f"paste_masks_in_image: card against CPU max abs err {err}, masks equal; {ms:.4g} ms for 100 "
        f"masks into {TRUE_HW}")
    return dict(max_abs_err=err, mask_pixels_differing=int(hard.sum()), ms=ms, masks=100, image_hw=list(TRUE_HW))


def flops_check():
    """``utils.analysis.flop_count`` of one 800x1024 image (true 800x1000)
    through R101-FPN bf16 inference, the kernel path (K1 and K2 launched
    once each, their ops counted by their flop formulas) and the plain path
    (``stem_impl``, ``roi_align_impl`` "plain": the mode counts the plain
    stem's convolution, which equals K1's formula, and the plain RoIAlign's
    op counts ``roi_align_flops`` as K2's does). RoIAlign's count reads the
    RoIs, and each path pools its own proposals (K1's bf16 rounding moves a
    few), so the checks are: the two counts without each path's RoIAlign
    share (``roi_align_flops`` on that path's proposals) equal; the K2 op
    and the plain version's op count the same on the kernel path's window
    inputs. K1's share against ``stem_flops`` (30.8 GFLOP per batch of 8 is
    its bound's numerator)."""
    from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines, rcnn
    from proben_tpu_torch.ops import roi_align_cuda, stem_cuda
    from proben_tpu_torch.utils.analysis import flop_count

    cfg = build_config(depth=101, input_format="BGR", num_classes=3, compute_dtype="bfloat16")
    model = build_model(cfg, params=random_affines(init_rcnn(0, cfg), 0))
    image = torch.from_numpy(structured_images(np.random.RandomState(41), 1, 1, H, W, 3)[0]).cuda()
    sizes = torch.tensor([TRUE_HW], dtype=torch.int32, device="cuda")
    counts, launches, k2, pool_args = {}, {}, {}, {}
    for impl in ("kernel", "plain"):
        c = dataclasses.replace(cfg, stem_impl=impl, roi_align_impl=impl)
        with torch.inference_mode():
            counts[impl], launches[impl] = counted(lambda: flop_count(rcnn.rcnn_inference, model, c, image, sizes))
            feats = rcnn.extract_features(model, c, rcnn.preprocess(c, image))
            levels = rcnn.roi_levels(feats)
            boxes = rcnn.propose(model, c, feats, sizes)[0]
            lvl, y0, x0, wy, wx, _ = roi_align_cuda.window_inputs(levels, boxes, **cfg.roi.pooler_args)
            k2[impl] = roi_align_cuda.roi_align_flops(wy, wx, levels[0].shape[-1])
            pool_args[impl] = (levels, lvl, y0, x0, wy, wx, boxes.shape[1])
            del feats
    if launches["kernel"]["stem_pool"] != 1 or launches["kernel"]["roi_align_fwd"] != 1 \
            or launches["plain"]["stem_pool"] or launches["plain"]["roi_align_fwd"]:
        raise AssertionError(f"flop_count: launches {launches}")
    rest = {impl: counts[impl] - k2[impl] for impl in counts}
    with torch.inference_mode():
        k2_wrapper = (flop_count(roi_align_cuda.roi_align_fwd, *pool_args["kernel"]),
                      flop_count(roi_align_cuda.roi_align_fwd_plain, *pool_args["kernel"]))
    del pool_args
    if rest["kernel"] != rest["plain"] or k2_wrapper != (k2["kernel"], k2["kernel"]):
        raise AssertionError(f"flop_count: kernel path {counts['kernel']}, plain path {counts['plain']}, "
                             f"their RoIAlign shares {k2}; K2 and its plain version on the same inputs "
                             f"{k2_wrapper}")
    k1 = stem_cuda.stem_flops(1, H, W, 3)
    log(f"flop_count R101-FPN, one {H}x{W} image: {counts['kernel'] / 1e9:.7g} GFLOP on the kernel path, "
        f"{counts['plain'] / 1e9:.7g} on the plain path, equal but for RoIAlign's share on each path's own "
        f"proposals ({k2['kernel']} / {k2['plain']}; K2 and its plain version count {k2_wrapper[0]} on the "
        f"same inputs); K1 {k1 / 1e9:.4g} (x8 = {8 * k1 / 1e9:.4g}), K2 {k2['kernel'] / 1e9:.4g}")
    del model
    return dict(gflop_per_image=counts["kernel"] / 1e9, flops_kernel_path=counts["kernel"],
                flops_plain_path=counts["plain"], flops_without_roi_align=rest["kernel"],
                roi_align_flops=k2, k1_gflop=k1 / 1e9, k2_gflop=k2["kernel"] / 1e9,
                launches=launches, image_hw=[H, W])


def draw_check(root, weights, n_val):
    """``python -m proben_tpu_torch.apps.flir draw`` on the synthetic val
    tree (``faster_rcnn_R_101_FLIR`` as ``build_flir_cfg`` makes it, in
    bf16 as the YAMLs run it (the command's own config is float32, as the
    JAX demo's, and runs K1 0 times), the crop run's detectron2 weights,
    score threshold 0.05 so boxes are drawn), ``DRAW_IMAGES`` images at
    batch 1, launches counted from 0:
    K1 and K2 once per image, ``image_io`` twice (the mapper's canvas and
    the drawn frames); a thermal and an RGB overlay written for every
    image, each a 640x512 colour image. Then K1 and K2 against their plain
    versions on the first image's canvas as the command maps it and its
    proposals, with the command's model (``split_kernel_checks``)."""
    from proben_tpu_torch.apps import flir
    from proben_tpu_torch.config import mapper_config_from_cfg
    from proben_tpu_torch.data import DatasetCatalog, DatasetMapper, build_test_loader

    out = os.path.join(root, "draw")
    cfg = flir.build_flir_cfg("thermal_only")
    cfg.MODEL.COMPUTE_DTYPE = "bfloat16"  # as configs/Base-RCNN-FPN.yaml (K1 is bf16 only)
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    t = time.time()
    written, launches = counted(lambda: flir.draw_predictions(
        "thermal_only", root, weights, out, max_images=DRAW_IMAGES, cfg=cfg))
    wall = time.time() - t
    n = min(DRAW_IMAGES, n_val)
    expect = {"stem_pool": n, "roi_align_fwd": n, "roi_align_bwd": 0, "image_io": 2 * n, **k4_expect(n),
              **k5_expect(n)}
    expect_launches("apps/flir.py draw", launches, expect)
    import importlib

    cv2 = importlib.import_module("cv2")  # the card's machine has it (as the datasets phase needs it)

    names = sorted(os.listdir(out))
    if len(written) != 2 * n or sorted(os.path.basename(p) for p in written) != names:
        raise AssertionError(f"draw: wrote {names}, expected a thermal and an RGB overlay for {n} images")
    for p in written:
        img = cv2.imread(p)
        if img is None or img.shape != FLIR_T_HW + (3,):
            raise AssertionError(f"draw: {p} is not a {FLIR_T_HW} colour image")
    log(f"apps/flir.py draw: {len(written)} overlays for {n} images in {wall:.2f} s; launches {launches}")
    pred = flir._predictor(cfg, weights, None, "cuda")
    mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=False)
    try:
        first = next(iter(build_test_loader(DatasetCatalog.get("FLIR_draw")[:1], mapper, batch_size=1)))
    finally:
        mapper.close()
    errs = split_kernel_checks("apps/flir.py draw", pred.model, pred.cfg, first)
    del pred
    return dict(images=n, files=len(written), launches=launches, wall_s=wall, max_abs_err=errs,
                canvas=[int(v) for v in first["image"].shape])


def surface_phase(card):
    """Crop on the card (the train mapper for BGR and BGRTTT with
    ``INPUT.CROP`` against its plain version and the CPU mapper, the
    kernel with crops timed; ``crop_train_run``), ``paste_masks_in_image``
    on the card, ``flop_count`` of R101-FPN through both paths, and the
    ``draw`` command; on a synthetic FLIR tree of 32 train pairs, the first
    8 also the val split."""
    import tempfile

    from proben_tpu_torch.apps import flir
    from proben_tpu_torch.apps.flir import TRAIN_JSON_NAME
    from proben_tpu_torch.config import get_cfg
    from proben_tpu_torch.data import DatasetCatalog
    from proben_tpu_torch.native import io

    t0 = time.time()
    stats = {"card": card}
    with tempfile.TemporaryDirectory(prefix="flir_surface_") as root, io.JpegCodec() as codec:
        write_flir_train_tree(codec, root, n=32, n_val=8)
        flir.register_flir("smoke_crop_train", root, TRAIN_JSON_NAME)
        flir.register_flir("smoke_crop_val", root)
        dicts, val = DatasetCatalog.get("smoke_crop_train"), DatasetCatalog.get("smoke_crop_val")
        crop = {}
        for fmt, yaml_name, seed in (("BGR", "faster_rcnn_R_101_FLIR.yaml", 42),
                                     ("BGRTTT", "faster_rcnn_R_101_FLIR_middle_fusion.yaml", 43)):
            cfg = get_cfg()
            cfg.merge_from_file(os.path.join(HERE, "configs", "FLIR-Detection", yaml_name))
            cfg.INPUT.CROP.ENABLED = True
            cfg.INPUT.PAD_SHAPE = CROP_PAD
            crop[fmt] = check_crop_mapper(codec, cfg, dicts[:TRAIN_BATCH], seed)
        stats["crop_mapper"] = crop
        stats["crop_train"], weights = crop_train_run(codec, root, dicts, val)
        stats["paste_masks"] = paste_masks_check()
        stats["flop_count"] = flops_check()
        stats["draw"] = draw_check(root, weights, len(val))
    stats["seconds"] = time.time() - t0
    log(f"surface phase: {stats['seconds']:.1f} s")
    return stats


# ---------------------------------------------------------------------------
# the user commands of apps/: the plain loop, benchmark, visualizers, converter
# ---------------------------------------------------------------------------


PLAIN_STEPS = 20  # plain_train_net iterations (metrics.json every 20, a checkpoint every 10)
BENCH_RUNS = (("eval", 8, 12), ("train", TRAIN_BATCH, 8), ("data", TRAIN_BATCH, 6))  # (task, batch, iters)
VIS_IMAGES = 4  # images through each visualizer


def kept_loader():
    """A ``TrainLoader`` subclass to put in an app module's namespace: it
    records the time of every ``next`` call and, on ``close``, takes one
    more batch (the loop's next) before it closes; its instances are in
    its ``made``."""
    from proben_tpu_torch.data import TrainLoader

    class KeptLoader(TrainLoader):
        made = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.times, self.next_batch = [], None
            KeptLoader.made.append(self)

        def __next__(self):
            self.times.append(time.perf_counter())
            return super().__next__()

        def close(self, timeout: float = 60.0):
            if self.next_batch is None:
                self.next_batch = TrainLoader.__next__(self)
            super().close(timeout)

    return KeptLoader


def plain_train_run(root, register, card):
    """``apps/plain_train_net.py`` as a user runs it: the shipped
    ``faster_rcnn_R_101_FLIR.yaml`` (R101-FPN, bf16, batch 16, flips,
    warm-up) on the tree's train split, detectron2 weights of random
    affines, ``PLAIN_STEPS`` iterations, a checkpoint every 10. Every
    launch counter is set to 0 just before the command and read just after:
    K1, K2 and K3 once per iteration, ``image_io`` once per batch the loop's
    loader mapped. Then the loss line in ``metrics.json`` finite, two
    checkpoints kept, and K1-K3 held against their plain versions on the
    loop's next batch with the loop's model (``held_batch_checks``)."""
    import types
    from unittest import mock

    from proben_tpu_torch.apps import plain_train_net
    from proben_tpu_torch.config import get_cfg, model_config_from_cfg
    from proben_tpu_torch.engine import trainable_mask

    yaml_path = os.path.join(HERE, "configs", "FLIR-Detection", "faster_rcnn_R_101_FLIR.yaml")
    out = os.path.join(root, "out", "plain")
    os.makedirs(out, exist_ok=True)
    cfg = get_cfg()
    cfg.merge_from_file(yaml_path)
    weights = d2_weights(cfg, 50, os.path.join(out, "init.pth"))
    opts = ["OUTPUT_DIR", out, "MODEL.WEIGHTS", weights, "DATASETS.TRAIN", "['smoke_tools_train']",
            "SOLVER.MAX_ITER", str(PLAIN_STEPS), "SOLVER.CHECKPOINT_PERIOD", "10", "SEED", "50"]
    cfg.merge_from_list(opts)
    label = "plain_train_net"
    kept = kept_loader()
    torch.cuda.synchronize()
    zero_launch_counts()
    t = time.perf_counter()
    with mock.patch.object(plain_train_net, "TrainLoader", kept):
        state = plain_train_net.main(["--config-file", yaml_path, "--register", register, *opts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts()
    (loader,) = kept.made
    per_step = {k: launches[k] / PLAIN_STEPS for k in ("stem_pool", "roi_align_fwd", "roi_align_bwd")}
    if per_step != {"stem_pool": 1, "roi_align_fwd": 1, "roi_align_bwd": 1} or \
            launches["image_io"] != loader.batches_mapped or loader.batches_mapped < PLAIN_STEPS:
        raise AssertionError(f"{label}: launches {launches} over {PLAIN_STEPS} steps, "
                             f"{loader.batches_mapped} batches mapped")
    check_counts(f"{label}, {PLAIN_STEPS} steps", launches,
                 {**k4_expect(PLAIN_STEPS, cfg.MODEL.BACKBONE.FREEZE_AT), **k5_expect(steps=PLAIN_STEPS)})
    per_step.update({k: launches[k] / PLAIN_STEPS for k in CHECKED})
    with open(os.path.join(out, "metrics.json")) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    losses = {k: v for k, v in lines[-1].items() if k.startswith("loss") or k == "total_loss"} if lines else {}
    ckpts = sorted(d for d in os.listdir(os.path.join(out, "checkpoints")) if d.startswith("iter_"))
    if len(lines) != 1 or lines[0]["iteration"] != PLAIN_STEPS - 1 or not losses \
            or not all(np.isfinite(v) for v in losses.values()) or lines[0]["loss_finite"] != 1.0:
        raise AssertionError(f"{label}: metrics.json {lines}")
    if ckpts != ["iter_0000009", "iter_0000019"] or state.step != PLAIN_STEPS:
        raise AssertionError(f"{label}: checkpoints {ckpts}, step {state.step}")
    moved = all(p.requires_grad for p in state.model.parameters())  # no trainable mask, as in JAX
    # the held checks ask every group that asks for a gradient to get one:
    # the sections the forward runs without one leave that set
    mask = trainable_mask(state.model, cfg.MODEL.BACKBONE.FREEZE_AT)
    for n, p in state.model.named_parameters():
        p.requires_grad_(mask[n])
    # the loop's rate over its window: from the first batch taken to the
    # last, every step but the last whole (hooks, loader and the checkpoint
    # at iteration 9 included); the median step (the first and the
    # checkpoint steps fall out of it) and the whole command beside it
    steps_s = np.diff(loader.times)
    img_s = TRAIN_BATCH * len(steps_s) / float(loader.times[-1] - loader.times[0])
    median_img_s = TRAIN_BATCH / float(np.median(steps_s[1:]))
    b = loader.next_batch
    watch = types.SimpleNamespace(model=state.model, model_cfg=model_config_from_cfg(cfg), state=None,
                                  step_fn=None, held={"image": b["image"], "image_size": b["image_size"],
                                                      "gt": b["gt"]})
    held = held_batch_checks(watch, label, stem=True, bare_steps=0)
    log(f"{label} ({card}): {PLAIN_STEPS} steps of {TRAIN_BATCH} in {wall:.1f} s (the command: "
        f"{TRAIN_BATCH * PLAIN_STEPS / wall:.2f} img/s), {img_s:.2f} img/s over steps 1-{len(steps_s)} "
        f"(first to last batch taken, one checkpoint), median step {np.median(steps_s[1:]) * 1e3:.1f} ms "
        f"({median_img_s:.2f} img/s), launches {launches}, metrics.json {losses}")
    return dict(steps=PLAIN_STEPS, launches_run=launches, launches_per_step=per_step,
                batches_mapped=loader.batches_mapped, image_io_per_batch=launches["image_io"] / loader.batches_mapped,
                metrics_line=lines[0], checkpoints=ckpts, all_parameters_trainable=moved,
                step_ms=[float(v) * 1e3 for v in steps_s], window_img_s=img_s, median_step_img_s=median_img_s,
                command_img_s=TRAIN_BATCH * PLAIN_STEPS / wall, wall_s=wall, held_batch=held)


def benchmark_runs(yaml_path, card):
    """``apps/benchmark.py`` for each of ``BENCH_RUNS`` from the shipped
    FLIR YAML, every launch counter set to 0 just before each and read just
    after: eval launches K1 and K2 once per call, train K1-K3 once per step
    (a synthetic batch: no ``image_io``), K4 as ``k4_expect`` (FREEZE_AT 2), data ``image_io`` once per batch
    its loader mapped, from ``smoke_tools_train`` as registered in this
    process; each prints the JAX tool's line, whose img/s is kept beside
    the card."""
    import re
    from unittest import mock

    from proben_tpu_torch.apps import benchmark

    out = {}
    expect = {"eval": {"stem_pool": 1, "roi_align_fwd": 1, "roi_align_bwd": 0, "image_io": 0},
              "train": {"stem_pool": 1, "roi_align_fwd": 1, "roi_align_bwd": 1, "image_io": 0}}
    for task, batch, iters in BENCH_RUNS:
        kept = kept_loader()
        torch.cuda.synchronize()
        zero_launch_counts()
        t = time.perf_counter()
        with mock.patch.object(benchmark, "TrainLoader", kept):
            line, result = benchmark.main(["--task", task, "--batch", str(batch), "--iters", str(iters),
                                           "--config-file", yaml_path, "DATASETS.TRAIN", "['smoke_tools_train']"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = launch_counts()
        calls = iters + 1  # one untimed call first
        if task == "data":
            (loader,) = kept.made
            ok = launches["image_io"] == loader.batches_mapped >= calls and not any(
                launches[k] for k in ("stem_pool", "roi_align_fwd", "roi_align_bwd"))
            per_call = {"image_io": launches["image_io"] / loader.batches_mapped}
            if tuple(result["image"].shape) != (batch, 800, 1024, 3):
                raise AssertionError(f"benchmark data: batch {tuple(result['image'].shape)}")
        else:
            per_call = {k: v / calls for k, v in launches.items()}
            ok = {k: per_call[k] for k in COUNTED} == expect[task]
            check_counts(f"benchmark {task}, {calls} calls", launches,
                         {**k4_expect(calls, 2 if task == "train" else None),
                          **(k5_expect(steps=calls) if task == "train" else k5_expect(calls))})
            finite = torch.isfinite(result.scores).all() if task == "eval" else all(
                np.isfinite(float(v)) for v in result.values())
            if not finite:
                raise AssertionError(f"benchmark {task}: non-finite output")
        if not ok:
            raise AssertionError(f"benchmark {task}: launches {launches} over {calls} calls")
        img_s = float(re.search(r"([0-9.]+) img/s", line).group(1))
        out[task] = dict(line=line, img_s=img_s, batch=batch, iters=iters, launches_run=launches,
                         launches_per_call=per_call, wall_s=wall, card=card)
        log(f"benchmark {task} ({card}): {line}; launches {launches}; {wall:.1f} s")
    return out


def visualizer_runs(root, card):
    """``apps/visualize_data.py`` and ``apps/visualize_json_results.py`` on
    the first ``VIS_IMAGES`` images of the tree's val split, read on the
    card (``image_io`` once per image, counted from 0 around each), the
    predictions a JSON of the ground truth moved by 2 pixels (score 0.9)
    and one box under the threshold per image: each image written, of its
    source's size (twice its width for the side-by-side one), and drawn
    on."""
    import importlib

    from proben_tpu_torch.apps import visualize_data, visualize_json_results
    from proben_tpu_torch.data import DatasetCatalog, MetadataCatalog

    cv2 = importlib.import_module("cv2")
    dicts = DatasetCatalog.get("smoke_tools_val")[:VIS_IMAGES]
    # the JSON holds the dataset's category ids, the dicts contiguous ones
    dataset_id = {v: k for k, v in MetadataCatalog.get("smoke_tools_val").thing_dataset_id_to_contiguous_id.items()}
    preds = [{"image_id": d["image_id"], "category_id": dataset_id[a["category_id"]], "score": score,
              "bbox": [a["bbox"][0] + 2, a["bbox"][1] + 2, a["bbox"][2], a["bbox"][3]]}
             for d in dicts for a, score in zip(d["annotations"] * 2, [0.9] * len(d["annotations"]) + [0.1])]
    pred_json = os.path.join(root, "preds.json")
    with open(pred_json, "w") as f:
        json.dump(preds, f)
    out, stats = os.path.join(root, "out"), {}
    runs = (("visualize_data", lambda d: visualize_data.main(
                ["--dataset", "smoke_tools_val", "--max-images", str(VIS_IMAGES), "--output-dir", d]),
             lambda name: name + ".png", 1),
            ("visualize_json_results", lambda d: visualize_json_results.main(
                ["--input", pred_json, "--dataset", "smoke_tools_val", "--output", d]),
             lambda name: name, 2))
    for label, run, written, widen in runs:
        torch.cuda.synchronize()
        zero_launch_counts()
        t = time.perf_counter()
        dest = os.path.join(out, label)
        n = run(dest)
        wall = time.perf_counter() - t
        launches = launch_counts()
        images = []
        for d in dicts[:n]:
            src = cv2.imread(d["file_name"], cv2.IMREAD_COLOR)
            got = cv2.imread(os.path.join(dest, written(os.path.basename(d["file_name"]))), cv2.IMREAD_COLOR)
            if got is None or got.shape != (src.shape[0], widen * src.shape[1], 3) or np.array_equal(
                    got[:, :src.shape[1]], src):
                raise AssertionError(f"{label}: {d['file_name']} not drawn as expected")
            images.append(got.shape)
        if launches["image_io"] != VIS_IMAGES or len(images) != VIS_IMAGES:
            raise AssertionError(f"{label}: {len(images)} images, launches {launches}")
        stats[label] = dict(images=len(images), launches=launches, wall_s=wall, card=card)
        log(f"{label} ({card}): {len(images)} images in {wall:.2f} s, launches {launches}")
    return stats


def converter_round_trip(root):
    """``apps/convert_torchvision.py`` on a torchvision-named R50 state
    dict made from a parameter pytree of random affines (every detectron2
    backbone name mapped back to torchvision's, plus ``fc.*``): the
    ``.pkl``'s keys are the detectron2 names, ``fc.*`` left out, and
    ``import_detectron2_checkpoint`` of it gives the pytree's backbone back
    to 1e-6 (each affine folded twice)."""
    import contextlib
    import io
    import pickle

    from proben_tpu_torch.apps import convert_torchvision
    from proben_tpu_torch.checkpoint import import_detectron2_checkpoint
    from proben_tpu_torch.models import build_config, init_rcnn, random_affines

    cfg = build_config(depth=50, input_format="BGR", num_classes=3)
    params = random_affines(init_rcnn(51, cfg), 51)
    d2 = {k[len("backbone.bottom_up."):]: v for k, v in d2_state_dict(params).items()
          if k.startswith("backbone.bottom_up.")}

    def to_torchvision(k):
        if k.startswith("stem."):
            k = k[len("stem."):]
        for t in (1, 2, 3, 4):
            k = k.replace(f"res{t + 1}.", f"layer{t}.")
        k = k.replace("shortcut.norm", "downsample.1").replace("shortcut", "downsample.0")
        for t in (1, 2, 3):
            k = k.replace(f"conv{t}.norm", f"bn{t}")
        return k

    tv = {to_torchvision(k): torch.from_numpy(v) for k, v in d2.items()}
    tv["fc.weight"], tv["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    src, dst = os.path.join(root, "r50_torchvision.pth"), os.path.join(root, "r50_d2.pkl")
    torch.save(tv, src)
    printed = io.StringIO()  # the command prints one line per key
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        convert_torchvision.main([src, dst])
    wall = time.perf_counter() - t
    if "Unconverted keys: ['fc.weight', 'fc.bias']" not in printed.getvalue():
        raise AssertionError(f"convert_torchvision printed {printed.getvalue()[-300:]}")
    with open(dst, "rb") as f:
        res = pickle.load(f)
    if sorted(res["model"]) != sorted(d2) or not res["matching_heuristics"]:
        raise AssertionError(f"convert_torchvision: keys {sorted(set(res['model']) ^ set(d2))[:5]}")
    template = init_rcnn(52, cfg)
    got = flat_tree(import_detectron2_checkpoint(dst, template, strict=False)["backbone"])
    want = flat_tree(params["backbone"])
    err = max(float(np.max(np.abs(got[k] - w) / (np.abs(w) + 1e-12))) for k, w in want.items())
    if got.keys() != want.keys() or err > 1e-6:
        raise AssertionError(f"convert_torchvision: round trip off by {err:.3g} relative")
    log(f"convert_torchvision: {len(res['model'])} tensors, backbone back within {err:.3g} relative, "
        f"{wall:.2f} s")
    return dict(tensors=len(res["model"]), max_rel_err=err, wall_s=wall)


def tools_phase(card):
    """The user commands of ``apps/`` on a synthetic FLIR tree of 32 train
    pairs (the first ``VIS_IMAGES`` also the val split): ``plain_train_run``,
    ``benchmark_runs``, ``visualizer_runs`` and ``converter_round_trip``.
    One ``tools`` JSON line."""
    import tempfile

    from proben_tpu_torch.apps import flir, train_net
    from proben_tpu_torch.apps.flir import TRAIN_JSON_NAME
    from proben_tpu_torch.native import io

    t0 = time.time()
    stats = {"card": card}
    with tempfile.TemporaryDirectory(prefix="flir_tools_") as root:
        with io.JpegCodec() as codec:
            write_flir_train_tree(codec, root, n=32, n_val=VIS_IMAGES)
        register = f"smoke_tools_train,{os.path.join(root, TRAIN_JSON_NAME)},{os.path.join(root, 'thermal_8_bit')}"
        flir.register_flir("smoke_tools_val", root)
        yaml_path = os.path.join(HERE, "configs", "FLIR-Detection", "faster_rcnn_R_101_FLIR.yaml")
        stats["plain_train_net"] = plain_train_run(root, register, card)
        torch.cuda.empty_cache()
        train_net.register_datasets([register])
        stats["benchmark"] = benchmark_runs(yaml_path, card)
        torch.cuda.empty_cache()
        stats.update(visualizer_runs(root, card))
        stats["convert_torchvision"] = converter_round_trip(root)
    stats["seconds"] = time.time() - t0
    log(f"tools phase: {stats['seconds']:.1f} s")
    return stats


# ---------------------------------------------------------------------------
# export, data-parallel training and the model zoo
# ---------------------------------------------------------------------------


EXPORTED_PATH = "bgr_exported_inference (loaded program, per batch)"
DDP_PATH = "flir_thermal_only_ddp_train (per step and rank, 2 gloo ranks on one card)"
DDP3_PATH = "flir_thermal_only_ddp_train (per step and training rank, 3 gloo ranks on one card, rank 2 sits out)"
DDP_STEPS = 3
DDP_WORLD = 2  # the ranks that train: the most, up to the ranks started, that divide IMS_PER_BATCH 16
DDP_SPAWNS = (2, 3)  # ranks started: all train, then rank 2 sits out in a group of ranks 0-1
DDP_FIRST_LOSS_RTOL = 2e-3  # bf16 forward at batch 8 against 16 (6.2e-5 on an H100)
DDP_LOSS_RTOL = 5e-2  # of the total loss, after updates from gradients rounded per half batch
DDP_UPDATE_RTOL = 5e-2  # of the one process's update, L2 (2.4e-3 on an H100)


def export_phase(model, images, sizes):
    """``export_model`` of ``rcnn_inference`` on the calibrated R101 of
    ``slice_phase`` (BGR, bf16, batch 8, 800x1024), ``torch.export.save``d,
    then ``load_exported`` and the loaded program run on the card: its graph
    holds the ``proben.stem_pool`` and ``proben.roi_align_fwd`` nodes, one
    call launches K1 and K2 once each (counters set to 0 just before it),
    its detections equal eager ``rcnn_inference``'s bit for bit (the same
    aten ops and kernels on the same inputs), and its img/s beside eager's
    (in turns: eager, exported, exported, eager; 12 batches each)."""
    import tempfile

    import functools

    from proben_tpu_torch.export import export_model, load_exported
    from proben_tpu_torch.models import rcnn

    cfg = model.cfg
    stats = {}
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="export_") as root, torch.no_grad():
        t = time.time()
        path = export_model(functools.partial(rcnn.rcnn_inference, model, cfg), (images[0], sizes), root)
        stats["export_s"] = time.time() - t
        stats["artifact_mb"] = os.path.getsize(path) / 1e6
        nodes = {}
        for n in torch.export.load(path).graph.nodes:
            target = str(n.target)
            if target.startswith("proben."):
                nodes[target] = nodes.get(target, 0) + 1
        t = time.time()
        loaded = load_exported(root)
        stats["load_s"] = time.time() - t
    for op, want in (("proben.stem_pool.default", 1), ("proben.roi_align_fwd.default", 1),
                     ("proben.block_epilogue.default", 3 * sum(R101_BLOCKS))):
        if nodes.get(op) != want:
            raise AssertionError(f"exported graph: {op} appears {nodes.get(op, 0)} times ({nodes})")
    with torch.no_grad():
        got, launches = counted(lambda: loaded(images[0], sizes))
        want = rcnn.rcnn_inference(model, cfg, images[0], sizes)
    expect_launches("exported inference", launches, {"stem_pool": 1, "roi_align_fwd": 1, **k4_expect(),
                                                     **k5_expect(1)})
    diffs = {}
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            continue
        diffs[f.name] = 0.0 if torch.equal(a, b) else float((a.double() - b.double()).abs().max())
    if any(diffs.values()):
        raise AssertionError(f"the loaded program's detections differ from eager rcnn_inference's: "
                             f"largest differences {diffs}")
    n_dets = int(want.valid.sum())
    if n_dets == 0 or not bool(torch.isfinite(want.boxes).all()):
        raise AssertionError(f"exported inference: {n_dets} detections")

    def rate(fn):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(12):
            fn(images[i % len(images)], sizes)
        b.record()
        torch.cuda.synchronize()
        return BATCH * 12 / (a.elapsed_time(b) / 1e3)

    def eager(x, s):
        return rcnn.rcnn_inference(model, cfg, x, s)

    with torch.no_grad():
        for fn in (eager, loaded):
            fn(images[1], sizes)
        turns = [("eager", rate(eager)), ("exported", rate(loaded)), ("exported", rate(loaded)),
                 ("eager", rate(eager))]
    img_s = {k: float(np.mean([v for name, v in turns if name == k])) for k in ("eager", "exported")}
    log(f"export: {stats['export_s']:.1f} s to export, {stats['load_s']:.1f} s to load a "
        f"{stats['artifact_mb']:.0f} MB artifact; graph nodes {nodes}; one call launches {launches}; "
        f"detections equal eager's bit for bit ({n_dets} valid); img/s exported "
        f"{img_s['exported']:.2f} / eager {img_s['eager']:.2f} (turns {[round(v, 2) for _, v in turns]})")
    del loaded
    return dict(stats, graph_nodes=nodes,
                launches={k: launches[k] for k in ("stem_pool", "roi_align_fwd") + CHECKED},
                equal=True, detections=n_dets, img_s_exported=img_s["exported"], img_s_eager=img_s["eager"],
                turns=turns, seconds=time.time() - t0)


def ddp_cfg(weights, out_dir, dataset, dtype="bfloat16"):
    """``faster_rcnn_R_101_FLIR.yaml`` (thermal_only, bf16 unless ``dtype``
    says otherwise, the FLIR solver, ``IMS_PER_BATCH`` 16) for
    ``DDP_STEPS`` steps on ``dataset``, weights from ``weights``; one loader
    worker, so the batches follow the index stream in order on every rank
    and in one process alike."""
    from proben_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(HERE, "configs", "FLIR-Detection", "faster_rcnn_R_101_FLIR.yaml"))
    cfg.MODEL.WEIGHTS = weights
    cfg.MODEL.COMPUTE_DTYPE = dtype
    cfg.OUTPUT_DIR = out_dir
    cfg.DATASETS.TRAIN = (dataset,)
    cfg.DATASETS.TEST = ()
    cfg.SOLVER.MAX_ITER = DDP_STEPS
    cfg.SOLVER.CHECKPOINT_PERIOD = 1000
    cfg.DATALOADER.NUM_WORKERS = 1
    return cfg


def ddp_train(cfg, hooks=()):
    """A ``DefaultTrainer`` run of ``cfg`` with ``hooks`` registered after
    its own, every launch counter set to 0 just before it: (per-step
    losses, K1-K3 launches counted around every step, per-step ms, peak GB,
    the run's ``image_io`` launches and the batches its loader mapped (the
    loader maps ahead of the step, so ``image_io`` is held to the run, not
    to a step), the parameters before the first step (on the host; None
    on a rank that sits out), the trainer)."""
    from proben_tpu_torch.engine import CallbackHook, DefaultTrainer

    zero_launch_counts()  # before the trainer: its loader starts mapping when it is built
    trainer = DefaultTrainer(cfg)
    steps, launches, ms = [], [], []
    clock = {}

    def start(t):
        clock["initial"] = {k: v.detach().cpu().clone() for k, v in t.model.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def before(t):
        torch.cuda.synchronize()
        clock["counts"], clock["t"] = launch_counts(), time.perf_counter()

    def after(t):
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - clock["t"]) * 1e3)
        now = launch_counts()
        launches.append({k: now[k] - clock["counts"][k] for k in ("stem_pool", "roi_align_fwd",
                                                                   "roi_align_bwd") + CHECKED})
        steps.append({k: float(v) for k, v in t._last_metrics.items()})

    trainer.register_hooks([CallbackHook(before_train=start, before_step=before, after_step=after),
                            *hooks])
    trainer.train()
    torch.cuda.synchronize()
    loader = trainer.train_loader  # None on a rank that sits out
    io = {"image_io": launch_counts()["image_io"], "batches_mapped": loader.batches_mapped if loader else 0}
    return steps, launches, ms, torch.cuda.max_memory_allocated() / 1e9, io, clock.get("initial"), trainer


def params_digest(model):
    """sha256 of the parameters' bytes, in ``state_dict`` order."""
    import hashlib

    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def ddp_rank(rank, init_file, root, weights, reference, result, dtype, nprocs):
    """One of ``nprocs`` ranks of ``ddp_phase``: gloo on the shared card,
    the trainer at its rows of each global batch; writes its losses,
    launches, step times, peak memory, how far its parameters are from the
    one-process run's (``reference``: its parameters before and after; the
    largest difference, and the L2 norm of the difference of the two runs'
    updates over the one process's update) and a digest of its parameters
    to ``result``. A rank that sits out writes its mesh, its steps and
    launches (none) and whether its log says it sits out. In the run where
    every rank trains, rank 0 then holds K1-K3 against their plain versions
    on its own next batch of 8 from its loader, with its model after the
    last step (``held_batch_checks``, no timed steps), after its launches
    were counted."""
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=nprocs)
    try:
        from proben_tpu_torch.apps import flir
        from proben_tpu_torch.apps.flir import TRAIN_JSON_NAME

        flir.register_flir("smoke_ddp", root, TRAIN_JSON_NAME)
        out_dir = os.path.join(root, f"out_ddp{nprocs}")
        watch = TrainWatch(count_iter=0, hold_batch=True) if rank == 0 and nprocs == DDP_WORLD else None
        steps, launches, ms, peak, io, _, trainer = ddp_train(
            ddp_cfg(weights, out_dir, "smoke_ddp", dtype), watch.hooks() if watch else ())
        mesh = trainer.mesh
        got = dict(rank=rank, world=mesh.world, sits_out=mesh.sits_out, subgroup=mesh.group is not None,
                   device=str(trainer.device), steps=steps, launches=launches, io=io)
        if mesh.sits_out:
            with open(os.path.join(out_dir, f"log.txt.rank{rank}")) as f:
                got.update(logged=f"rank {rank} sits out" in f.read(), launched=launch_counts())
            torch.save(got, os.path.join(result, f"rank{rank}.pt"))
            return
        held = None
        if watch is not None:
            if tuple(watch.held["image"].shape[:1]) != (TRAIN_BATCH // DDP_WORLD,):
                raise AssertionError(f"ddp rank 0: held batch {tuple(watch.held['image'].shape)}")
            held = held_batch_checks(watch, "ddp rank 0", stem=dtype == "bfloat16", bare_steps=0)
        ref = torch.load(reference, map_location=trainer.device)
        now, want, start = trainer.model.state_dict(), ref["final"], ref["initial"]
        gaps = {k: float((now[k].float() - v.float()).abs().max()) for k, v in want.items()}
        worst = max(gaps, key=gaps.get)
        diff = sum(float(((now[k].double() - v.double()) ** 2).sum()) for k, v in want.items())
        update = sum(float(((v.double() - start[k].double()) ** 2).sum()) for k, v in want.items())
        got.update(ms=ms, peak_gb=peak, param_gap=gaps[worst], worst=worst, update_gap=(diff / update) ** 0.5,
                   held=held, rows=trainer.train_loader.rows, digest=params_digest(trainer.model))
        torch.save(got, os.path.join(result, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ddp_spawn(nprocs, root, weights, reference, dtype):
    """``ddp_rank`` on ``nprocs`` spawned ranks; their results in rank
    order."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ddp_", dir=root) as tmp:
        ctx = mp.spawn(ddp_rank, args=(os.path.join(tmp, "init"), root, weights, reference, tmp, dtype, nprocs),
                       nprocs=nprocs, join=False)
        deadline = time.time() + 600
        while not ctx.join(1.0):
            if time.time() > deadline:
                for proc in ctx.processes:
                    proc.terminate()
                raise AssertionError(f"ddp: the {nprocs} ranks did not finish within 600 s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(nprocs)]


def ddp_compare(ranks, one, dtype, label):
    """Checks of the training ranks ``ranks`` against the one process's run
    ``one`` (see ``ddp_phase``); returns the gaps."""
    if any(r["world"] != DDP_WORLD or r["device"] != "cuda:0" for r in ranks):
        raise AssertionError(f"{label}: ranks {[(r['rank'], r['world'], r['device']) for r in ranks]}")
    if [tuple(r["rows"]) for r in ranks] != [(0, 8), (8, 16)]:
        raise AssertionError(f"{label}: the ranks' rows {[r['rows'] for r in ranks]}")
    # K1 takes bf16 only: the float32 witness runs the plain stem
    per_step = {"stem_pool": int(dtype == "bfloat16"), "roi_align_fwd": 1, "roi_align_bwd": 1}
    k4 = {**k4_expect(1, 2, float32=dtype == "float32"), **k5_expect(steps=1)}  # FREEZE_AT 2
    for r in ranks + [one]:
        if len(r["launches"]) != DDP_STEPS or any({k: c[k] for k in per_step} != per_step
                                                  for c in r["launches"]):
            raise AssertionError(f"{label}: launches per step {r['launches']}, expected {per_step}")
        for i, c in enumerate(r["launches"]):
            who = "one process" if r is one else f"rank {r['rank']}"
            check_counts(f"{label}, {who}, step {i + 1}", c, k4)
        if r["io"]["image_io"] != r["io"]["batches_mapped"] or r["io"]["batches_mapped"] < DDP_STEPS:
            raise AssertionError(f"{label}: image_io launches {r['io']} (one per batch mapped)")
    if ranks[0]["steps"] != ranks[1]["steps"] or ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError(f"{label}: the two ranks' losses or parameters differ")
    loss_gaps = []  # per step, the largest gap over the losses (see ddp_phase)
    own_gaps = []  # per step and loss, the gap over that loss's own size (recorded, checked at step 1)
    for i, (got, want) in enumerate(zip(ranks[0]["steps"], one["steps"])):
        if set(got) != set(want) or got["loss_finite"] != 1.0 or want["loss_finite"] != 1.0:
            raise AssertionError(f"{label}: step metrics {got} against {want}")
        own_gaps.append({k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items()})
        scale = {k: abs(v) if i == 0 else abs(want["total_loss"]) for k, v in want.items()}
        loss_gaps.append(max(abs(got[k] - v) / max(scale[k], 1e-12) for k, v in want.items()))
    param_gap = max(r["param_gap"] for r in ranks)
    update_gap = max(r["update_gap"] for r in ranks)
    log(f"{label} ({dtype}): against one process at batch {TRAIN_BATCH}, {DDP_STEPS} steps: "
        f"largest loss gap per step {[float(f'{g:.3g}') for g in loss_gaps]} (step 1 of each loss, "
        f"later of the total loss), the ranks' update "
        f"{update_gap:.3g} of the one process's away (L2), largest parameter gap {param_gap:.3g} "
        f"({ranks[0]['worst']}); total losses {[s['total_loss'] for s in ranks[0]['steps']]} against "
        f"{[s['total_loss'] for s in one['steps']]}; launches per step per rank {per_step}, image_io once per "
        f"mapped batch; ms per step {[round(float(np.median(r['ms'][1:])), 1) for r in ranks]} per rank, "
        f"{float(np.median(one['ms'][1:])):.1f} in one process; peak "
        f"{[round(r['peak_gb'], 2) for r in ranks]} GB per rank, {one['peak_gb']:.2f} in one process")
    log(f"{label}: per step, each loss of the ranks / of the one process (gap over the loss's own size): " + "; ".join(
        f"step {i + 1}: " + ", ".join(f"{k} {got[k]:.6g} / {want[k]:.6g} ({own_gaps[i][k]:.3g})"
                                      for k in sorted(want) if k != "loss_finite")
        for i, (got, want) in enumerate(zip(ranks[0]["steps"], one["steps"]))))
    if loss_gaps[0] > DDP_FIRST_LOSS_RTOL or max(loss_gaps) > DDP_LOSS_RTOL or update_gap > DDP_UPDATE_RTOL:
        raise AssertionError(f"{label}: the ranks' run differs from the one process's beyond the tolerance: "
                             f"losses {loss_gaps}, update {update_gap}")
    return dict(loss_gap_rel=loss_gaps, loss_gap_own=own_gaps, update_gap=update_gap, param_gap=param_gap,
                worst_param=ranks[0]["worst"], launches_per_step={**per_step, "image_io": 1, **k4},
                losses=[s["total_loss"] for s in ranks[0]["steps"]], step_metrics=ranks[0]["steps"],
                image_io=[r["io"] for r in ranks], ms_per_step=[float(np.median(r["ms"][1:])) for r in ranks],
                peak_gb=[r["peak_gb"] for r in ranks])


def ddp_phase(card, root, weights, dtype="bfloat16"):
    """Data-parallel training on the one card: ``faster_rcnn_R_101_FLIR.yaml``
    at ``IMS_PER_BATCH`` 16 from ``weights``, first in one process (world
    1), then on 2 ranks (``torch.multiprocessing`` spawn, gloo with a
    ``file://`` init; NCCL refuses two ranks on one device), 8 images each,
    for ``DDP_STEPS`` steps, then on 3 ranks, of which, as in the JAX
    trainer, the first 2 (the most that divide the batch) train in a process
    group of their own and rank 2 sits out: it takes no step, launches
    nothing, logs that it sits out, and the others do not wait on it.
    Checks, in each run, of ranks 0-1 (``ddp_compare``): every step's
    losses of the ranks (the same on both, averaged over them) against the
    one process's; the
    parameters after the last step against its, and bit for bit between the
    ranks; K1, K2 and K3 launched once per step on every rank, and
    ``image_io`` once per batch the rank's loader mapped (its 8 rows in one
    launch); on rank 0, K1-K3 against their plain versions on its own next
    batch of 8 (``ddp_rank``). Tolerance: the same bf16 math, in other rounding. The first
    step starts from the same parameters, and only the forward's rounding
    differs (the ranks' convolutions run at batch 8 where the one process
    runs 16, and cuDNN may take other algorithms): each of its losses to
    ``DDP_FIRST_LOSS_RTOL`` of itself. The gradients are rounded to bf16
    per half batch and then averaged by the all-reduce, where the one
    process rounds the whole batch's once, about 2^-9 of each; the randomly
    initialised model amplifies that over the next steps, and a small loss
    (the box regression over a few foreground RoIs) moves by a larger share
    of itself when one sampled RoI changes: each of their losses to
    ``DDP_LOSS_RTOL`` of the step's total loss, and the L2 distance between
    the two runs' parameters after the last step to ``DDP_UPDATE_RTOL`` of the one
    process's update (a gradient summed instead of averaged, or the wrong
    rows drawn, moves it by the order of 1). Every loss's gap over its own
    size is printed for every step (on an H100 in bf16, step 3's box
    regression loss, 0.0078 against 0.0066, moves by 0.185 of itself and
    5.4e-4 of the total); ``--ddp-float32`` runs the same comparison in
    float32, where only the order of the f32 sums differs, as the witness
    that those gaps are bf16 rounding. The ms per step and the peak memory
    of each rank are measured with the two ranks sharing the card; the
    readings are printed."""
    from proben_tpu_torch.apps import flir
    from proben_tpu_torch.apps.flir import TRAIN_JSON_NAME

    t0 = time.time()
    flir.register_flir("smoke_ddp", root, TRAIN_JSON_NAME)
    steps, launches, ms, peak, io, initial, trainer = ddp_train(
        ddp_cfg(weights, os.path.join(root, "out_one"), "smoke_ddp", dtype))
    one = dict(steps=steps, launches=launches, ms=ms, peak_gb=peak, io=io)
    reference = os.path.join(root, "reference.pt")
    torch.save({"initial": initial,
                "final": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}}, reference)
    del initial
    del trainer
    torch.cuda.empty_cache()
    runs, seconds = {}, {}
    for nprocs in DDP_SPAWNS:
        t = time.time()
        runs[nprocs] = ddp_spawn(nprocs, root, weights, reference, dtype)
        seconds[nprocs] = time.time() - t
    ranks = runs[DDP_WORLD]
    stats = ddp_compare(ranks, one, dtype, f"ddp, {DDP_WORLD} gloo ranks on one card")
    if any(r["sits_out"] or r["subgroup"] for r in ranks):
        raise AssertionError("ddp: a rank of the run where all train sits out or has a group of its own")
    three = runs[3]
    idle = three[2]
    if not idle["sits_out"] or idle["world"] != DDP_WORLD or idle["steps"] or idle["launches"] or \
            not idle["logged"] or any(idle["launched"].values()) or idle["io"]["batches_mapped"]:
        raise AssertionError(f"ddp, 3 ranks: rank 2 {idle}")
    if any(r["sits_out"] or not r["subgroup"] for r in three[:2]):
        raise AssertionError("ddp, 3 ranks: ranks 0-1 not in a group of their own")
    three_stats = ddp_compare(three[:2], one, dtype, "ddp, 3 gloo ranks on one card, rank 2 sits out")
    same = three[0]["digest"] == ranks[0]["digest"]
    log(f"ddp, 3 ranks: rank 2 sat out (no step, no launch, logged); ranks 0-1's parameters "
        f"{'equal' if same else 'differ from'} the 2-rank run's bit for bit; "
        f"{seconds[2]:.1f} s for the 2-rank run, {seconds[3]:.1f} s for the 3-rank run")
    return dict(card=card, dtype=dtype, world=DDP_WORLD, backend="gloo", batch=TRAIN_BATCH, steps=DDP_STEPS,
                **stats, held_batch_rank0=ranks[0]["held"],
                losses_one_process=[s["total_loss"] for s in one["steps"]],
                step_metrics_one_process=one["steps"],
                ms_per_step_one_process=float(np.median(one["ms"][1:])), peak_gb_one_process=one["peak_gb"],
                three_ranks=dict(three_stats, sat_out={k: idle[k] for k in ("rank", "world", "steps", "logged")},
                                 bitwise_equal_to_two_ranks=same, seconds=seconds[3]),
                two_ranks_seconds=seconds[2], seconds=time.time() - t0)


def zoo_phase(root, weights, trainer_state):
    """``model_zoo.get("FLIR-Detection/faster_rcnn_R_101_FLIR.yaml",
    trained=True)`` with ``PROBEN_ZOO_DIR`` a directory that holds
    ``weights`` under ``CHECKPOINT_NAMES``' file name: its model equals,
    tensor for tensor, ``trainer_state``, the state that ``DefaultTrainer``
    loaded from the same file through ``MODEL.WEIGHTS`` (``ddp_phase``'s
    one-process run, before its first step), and ``get_config`` points
    ``MODEL.WEIGHTS`` at the zoo's file."""
    import shutil

    from proben_tpu_torch import model_zoo

    t0 = time.time()
    name = "FLIR-Detection/faster_rcnn_R_101_FLIR.yaml"
    zoo = os.path.join(root, "zoo")
    os.makedirs(zoo)
    shutil.copy(weights, os.path.join(zoo, model_zoo.CHECKPOINT_NAMES[name]))
    saved = os.environ.get("PROBEN_ZOO_DIR")
    os.environ["PROBEN_ZOO_DIR"] = zoo
    try:
        model, mcfg = model_zoo.get(name, trained=True)
        cfg = model_zoo.get_config(name, trained=True)
    finally:
        if saved is None:
            del os.environ["PROBEN_ZOO_DIR"]
        else:
            os.environ["PROBEN_ZOO_DIR"] = saved
    got = model.state_dict()
    same = sorted(got) == sorted(trainer_state) and all(
        torch.equal(got[k].cpu(), v) for k, v in trainer_state.items())
    if not same or cfg.MODEL.WEIGHTS != os.path.join(zoo, model_zoo.CHECKPOINT_NAMES[name]):
        raise AssertionError("model_zoo.get: the model differs from the trainer's on the same file")
    log(f"model_zoo.get({name!r}, trained=True): {len(got)} tensors equal the trainer's from "
        f"the same file ({os.path.basename(cfg.MODEL.WEIGHTS)})")
    del model
    return dict(config=name, file=model_zoo.CHECKPOINT_NAMES[name], tensors=len(got), equal=True,
                depth=mcfg.depth, seconds=time.time() - t0)


def ddp_zoo_phases(card, dtype="bfloat16"):
    """``ddp_phase``, then ``zoo_phase`` against its one-process trainer's
    loaded state, on a synthetic FLIR tree of 16 train
    pairs with one detectron2 zoo ``.pkl`` of random affines. The box
    predictor's weights are scaled by 0.01, so its logits start near 0 as a
    trained head's do (at the random init's scale the class loss starts
    saturated, near 33, and one bf16 rounding of its gradient moves the
    next step's losses by percents)."""
    import pickle
    import tempfile

    from proben_tpu_torch.config import get_cfg, model_config_from_cfg
    from proben_tpu_torch.models import init_rcnn, random_affines
    from proben_tpu_torch.native import io

    with tempfile.TemporaryDirectory(prefix="flir_ddp_") as root:
        with io.JpegCodec() as codec:
            write_flir_train_tree(codec, root, n=TRAIN_BATCH, n_val=8)
        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(HERE, "configs", "FLIR-Detection", "faster_rcnn_R_101_FLIR.yaml"))
        params = random_affines(init_rcnn(33, model_config_from_cfg(cfg)), 33)
        for head in params["roi"]["output"].values():
            head["w"] = head["w"] * 0.01
        weights = os.path.join(root, "weights.pkl")
        with open(weights, "wb") as f:
            pickle.dump({"model": d2_state_dict(params)}, f)
        ddp = ddp_phase(card, root, weights, dtype)
        zoo = zoo_phase(root, weights, torch.load(os.path.join(root, "reference.pt"))["initial"])
    return ddp, zoo


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "proben_tpu_torch")):
        print(f"chip_smoke: proben_tpu_torch not found beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    if "--kaist-divergence" in sys.argv[1:]:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # before the first cuBLAS call
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0] if smi else ""
    print(card, flush=True)

    from proben_tpu_torch import _build
    from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines

    tb = time.time()
    _build.build(["stem", "roi_align_fwd", "roi_align_bwd", "block_epilogue", "image_io", "nms"])
    log(f"build: {time.time() - tb:.1f} s")
    if "--kaist-divergence" in sys.argv[1:]:
        kaist_divergence_probe(card)
        return 0
    if "--ddp-float32" in sys.argv[1:]:
        ddp_stats, zoo_stats = ddp_zoo_phases(card, "float32")
        print(json.dumps({"ddp_float32": ddp_stats, "zoo": zoo_stats}), flush=True)
        if COUNT_MISSES:
            print(json.dumps({"count_misses": COUNT_MISSES}), flush=True)
            raise AssertionError(f"K4's or K5's counts missed on {[m['path'] for m in COUNT_MISSES]}")
        return 0

    cfg = build_config(depth=101, input_format="BGR", num_classes=3, compute_dtype="bfloat16")
    # random weights from seed 0, with trained-like affines so that every
    # residual branch of the R101 carries signal
    model = build_model(cfg, params=random_affines(init_rcnn(0, cfg), 0))
    rng = np.random.RandomState(0)
    base = structured_images(rng, 2, BATCH, H, W, 3)
    images = [torch.from_numpy(a).cuda() for a in base]
    sizes = torch.tensor([TRUE_HW] * BATCH, dtype=torch.int32, device="cuda")

    from proben_tpu_torch.engine import Predictor

    profiling = "--profile" in sys.argv[1:]
    once = {"stem_pool": 1, "roi_align_fwd": 1}
    k1 = stem_phase(model)
    k4 = epilogue_phase(BATCH * cfg.rpn.post_nms_topk_test)  # C4's res5 on every proposal
    k5 = nms_phase()
    launches, slice_stats = slice_phase(model, images, sizes, {**once, **k4_expect(), **k5_expect(1)})
    k2 = roi_phase(model, images[0], sizes)  # the calibrated model's proposals
    export_stats = export_phase(model, images, sizes)
    if profiling:
        profile_phase(Predictor(model, cfg), images, sizes)
    # training reuses the calibrated model and updates it in place
    batch = train_batch()
    k3 = bwd_phase(model, batch)
    train_launches, train_stats = train_phase(model, batch, {**once, "roi_align_bwd": 1,
                                                             **k4_expect(1, cfg.freeze_at),
                                                             **k5_expect(steps=1)})
    if profiling:
        train_profile(model, batch)
    del model, batch

    # early fusion: BGRT, one R101 with a 4-channel stem (K1 at C = 4)
    ef_cfg = build_config(depth=101, input_format="BGRT", num_classes=3, compute_dtype="bfloat16",
                          pixel_mean=(103.530, 116.280, 123.675, 135.438), pixel_std=(1.0,) * 4,
                          freeze_at=3)
    model = build_model(ef_cfg, params=random_affines(init_rcnn(4, ef_cfg), 4))
    ef_images = [torch.from_numpy(fused(a, 4)).cuda() for a in base]
    ef_launches, ef_stats = slice_phase(model, ef_images, sizes, {**once, **k4_expect(), **k5_expect(1)},
                                        hi=32.0)
    del model, ef_images

    # middle fusion: BGRTTT, two R101-FPNs (configs/FLIR-Detection/
    # faster_rcnn_R_101_FLIR_middle_fusion.yaml); K1 once per stream, K2 and
    # K3 at C = 512 on the concatenated maps
    mf_cfg = build_config(depth=101, input_format="BGRTTT", num_classes=3, compute_dtype="bfloat16",
                          pixel_mean=(103.530, 116.280, 123.675) + (135.438,) * 3, freeze_at=3)
    model = build_model(mf_cfg, params=random_affines(init_rcnn(1, mf_cfg), 1))
    mf_images = [torch.from_numpy(np.ascontiguousarray(fused(a, 6))).cuda() for a in base]
    twice = {"stem_pool": 2, "roi_align_fwd": 1}
    mf_launches, mf_stats = slice_phase(model, mf_images, sizes, {**twice, **k4_expect(2), **k5_expect(1)},
                                        hi=32.0)
    k2_512 = roi_phase(model, mf_images[0], sizes)
    if profiling:
        profile_phase(Predictor(model, mf_cfg), mf_images, sizes)
    batch = train_batch(6)
    k3_512 = bwd_phase(model, batch)
    mf_train_launches, mf_train_stats = train_phase(model, batch, {**twice, "roi_align_bwd": 1,
                                                                   **k4_expect(2, mf_cfg.freeze_at),
                                                                   **k5_expect(steps=1)})
    if profiling:
        train_profile(model, batch)
    del model, batch, mf_images

    proben_stats = proben_phase(images, sizes)
    del images
    k_io, flir_stats = flir_phase(card)
    kaist_stats = kaist_phase(card)
    trainer_stats = trainer_phase(card)
    heads_k, heads_stats = heads_phase(card)
    datasets_stats = datasets_phase(card)
    surface_stats = surface_phase(card)
    torch.cuda.empty_cache()
    tools_stats = tools_phase(card)
    torch.cuda.empty_cache()
    ddp_stats, zoo_stats = ddp_zoo_phases(card)

    paths = {"bgr_inference": launches, "bgr_train": train_launches, "bgrt_inference": ef_launches,
             "bgrttt_inference": mf_launches, "bgrttt_train": mf_train_launches,
             "flir_thermal_only_eval (4 batches)": flir_stats["thermal_only"]["launches"],
             "flir_middle_fusion_eval (4 batches)": flir_stats["middle_fusion"]["launches"],
             **{f"kaist_{m}_eval (4 batches)": kaist_stats[m]["launches"]
                for m in ("thermal_only", "rgb_only", "middle_fusion")},
             "kaist_thermal_only_eval_float32_as_shipped (4 batches)": kaist_stats["thermal_only_f32"]["launches"],
             **{f"{key}_train (K1-K3 per step, image_io per training batch)": {
                 **trainer_stats[key]["launches_per_step"],
                 "image_io": trainer_stats[key]["image_io"]["per_train_batch"]}
                for key in ("flir_thermal_only", "flir_middle_fusion", "kaist_thermal_only_f32")},
             **heads_stats["launches"],
             **{f"{name}_eval ({datasets_stats[name]['images']} batches of 1)": datasets_stats[name]["launches"]
                for name in DATASET_OPTS},
             "voc_2007_trainval_train (K1-K3 per step, image_io per training batch)": {
                 **datasets_stats["voc_2007_trainval_train"]["launches_per_step"],
                 "image_io": datasets_stats["voc_2007_trainval_train"]["image_io"]["per_train_batch"]},
             "flir_thermal_only_crop_train (K1-K3 per step, image_io per training batch)": {
                 **surface_stats["crop_train"]["launches_per_step"],
                 "image_io": surface_stats["crop_train"]["image_io"]["per_train_batch"]},
             f"flir_draw ({surface_stats['draw']['images']} images)": surface_stats["draw"]["launches"],
             EXPORTED_PATH: export_stats["launches"],
             DDP_PATH: ddp_stats["launches_per_step"],
             DDP3_PATH: ddp_stats["three_ranks"]["launches_per_step"],
             "plain_train_net (K1-K3 per step, image_io per training batch)": {
                 **tools_stats["plain_train_net"]["launches_per_step"],
                 "image_io": tools_stats["plain_train_net"]["image_io_per_batch"]},
             **{f"benchmark_{task} (per {'batch' if task == 'data' else 'call'})": {
                 k: v for k, v in run["launches_per_call"].items() if v}
                for task, run in tools_stats["benchmark"].items()},
             **{f"{name} ({tools_stats[name]['images']} images)": {
                 k: v for k, v in tools_stats[name]["launches"].items() if v}
                for name in ("visualize_data", "visualize_json_results")}}
    for d in (k1, k2, k3, k4, k5):
        d["launches"] = train_launches[d["name"]] if d is k3 else launches[d["name"]]
        d["launches_per_path"] = {p: n[d["name"]] for p, n in paths.items() if d["name"] in n}
    k4["plain_epilogues_per_path"] = {p: n["epilogue_plain"] for p, n in paths.items() if "epilogue_plain" in n}
    reading_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "max_abs_err_f32", "gflop",
                    "mbytes", "alloc_mb", "rois", "out_of_window")
    for d, wide, c4, cas in ((k2, k2_512, heads_k["k2_c4"], heads_k["k2_cascade"]),
                             (k3, k3_512, heads_k["k3_c4"], heads_k["k3_cascade"])):
        d["c512"] = {k: wide[k] for k in reading_keys if k in wide}
        # the C4 pooler (P = 14 on res4, C = 1024) and Cascade's last stage (P = 7, C = 256)
        d["p14_c1024"] = {k: c4[k] for k in reading_keys if k in c4}
        d["cascade_stage2"] = {k: cas[k] for k in reading_keys if k in cas}

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for d in (k1, k2, k3):
        print(json.dumps({"kernel": d["name"], "kernel_ms": d["ms"], "plain_ms": d["plain_ms"],
                          "library_ms": d["library_ms"], "bound_ms": d["bound_ms"],
                          "bound_by": d["bound_by"], "gflop": d["gflop"], "mbytes": d["mbytes"],
                          "launches": d["launches"], "max_abs_err": d["max_abs_err"],
                          **{k: d[k] for k in ("deterministic", "alloc_mb", "c512") if k in d}}))
    print(json.dumps({"kernel": k4["name"], "kernel_ms": k4["ms"], "plain_ms": k4["plain_ms"],
                      "library_ms": None, "bound_ms": k4["bound_ms"], "bound_by": "bytes", "gflop": 0.0,
                      "mbytes": k4["mbytes"], "launches": k4["launches"], "max_abs_err": k4["max_abs_err"],
                      **{k: k4[k] for k in ("deterministic", "backward", "sum_err_ulp", "c4_res5")}}))
    print(json.dumps({"kernel": k5["name"], "kernel_ms": k5["ms"], "plain_ms": k5["plain_ms"], "library_ms": None,
                      "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"], "gflop": k5["gflop"],
                      "mbytes": k5["mbytes"], "launches": k5["launches"], "max_abs_err": 0.0,
                      "deterministic": True, "per_case": k5["per_case"]}))
    print(json.dumps({"slice": {**slice_stats, "card": card}}))
    print(json.dumps({"train": {**train_stats, "launches_per_step": train_launches, "card": card}}))
    print(json.dumps({"early_fusion": {**ef_stats, "launches_per_batch": ef_launches, "card": card}}))
    print(json.dumps({"middle_fusion": {**mf_stats, "launches_per_batch": mf_launches, "card": card}}))
    print(json.dumps({"middle_fusion_train": {**mf_train_stats, "launches_per_step": mf_train_launches,
                                              "card": card}}))
    print(json.dumps({"late_fusion": {**proben_stats, "card": card}}))
    print(json.dumps({"flir_eval": {**flir_stats, "seconds": time.time() - t0}}))
    print(json.dumps({"kaist_eval": {**kaist_stats, "seconds": time.time() - t0}}))
    print(json.dumps({"trainer": {**trainer_stats, "total_seconds": time.time() - t0}}))
    print(json.dumps({"heads": {**heads_stats, "total_seconds": time.time() - t0}}))
    print(json.dumps({"datasets": {**datasets_stats, "total_seconds": time.time() - t0}}))
    print(json.dumps({"surface": {**surface_stats, "total_seconds": time.time() - t0}}))
    print(json.dumps({"export": {**export_stats, "card": card}}))
    print(json.dumps({"tools": {**tools_stats, "total_seconds": time.time() - t0}}))
    print(json.dumps({"ddp": ddp_stats}))
    print(json.dumps({"zoo": zoo_stats}))
    k_io["launches"] = flir_stats["thermal_only"]["launches_per_batch"]["image_io"]
    k_io["launches_per_path"] = {p: n["image_io"] for p, n in paths.items() if "image_io" in n}
    k_io["train_flips"] = {fmt: {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err", "mbytes",
                                                     "flipped")}
                           for fmt, row in trainer_stats["train_mapper"].items()}
    k_io["png_cityscapes"] = {k: datasets_stats["png"][k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err",
                                                                      "mbytes", "decode_host_ms", "sizes")}
    k_io["train_crop"] = {fmt: {k: row[k] for k in ("ms", "uncropped_ms", "plain_ms", "bound_ms", "max_abs_err",
                                                    "mbytes", "flipped", "pad_shape")}
                          for fmt, row in surface_stats["crop_mapper"].items()}
    print(json.dumps({"kernels": [{k: d[k] for k in keys + ("deterministic", "launches_per_path", "c512",
                                                             "p14_c1024", "cascade_stage2",
                                                             "c4", "c6", "train_flips", "png_cityscapes",
                                                             "train_crop", "backward", "sum_err_ulp",
                                                             "per_case", "c4_res5", "plain_epilogues_per_path")
                                   if k in d} for d in (k1, k2, k3, k4, k5, k_io)]}), flush=True)
    if COUNT_MISSES:
        print(json.dumps({"count_misses": COUNT_MISSES}), flush=True)
        raise AssertionError(f"K4's or K5's counts missed on {len(COUNT_MISSES)} paths: "
                             f"{[m['path'] for m in COUNT_MISSES]}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
