"""ProbEn late fusion in one predictor (``engine/ensemble.py::ProbEnPredictor``)
against the benchmark's plain reference (``port_bench/reference/proben.py``)
on the CPU.

A tiny ProbEn3 ensemble, R50-FPN members in float32 (thermal-only on TTT,
BGRT early fusion, BGRTTT middle fusion, each with the variance head), on
weights drawn and fitted from a seed by the benchmark's ``proben_late``
architecture and on its synthetic 6-channel frames: each member's
detections (boxes, scores, classes, probabilities, variances) and the fused
ones against the member references and the reference's greedy loop; the
fusion alone (``fuse_detections_torch``) against the loop on clustered
random ensembles for every score and box method. Planted faults each fail a
comparison or raise: v-avg replaced by the plain average, probEn by the
average, a member given another's channels, a member's variance dropped.
The counters rise by one call and the fixpoint's iterations a batch, the
spans nest as documented under a profiler and are no-ops without one.

Tolerances: both sides compute in float32 from the same weights and
frames, in other orders of summation: boxes to 1e-3 px, scores and
probabilities to 1e-5, variances (exps of a head output) to rtol 1e-4; the
counts, classes and order exactly.
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

from proben_tpu_torch.apps import flir
from proben_tpu_torch.checkpoint.torch_import import import_detectron2_checkpoint
from proben_tpu_torch.config import model_config_from_cfg
from proben_tpu_torch.engine import Predictor, ProbEnPredictor
from proben_tpu_torch.fusion import fuse_detections_torch
from proben_tpu_torch.fusion.proben_torch import BOX_METHODS, SCORE_METHODS
from proben_tpu_torch.models import build_model, init_rcnn
from proben_tpu_torch.structures.detections import Detections
from proben_tpu_torch.utils import tracing

BENCH = Path(__file__).resolve().parent.parent / "port_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import cells, frames  # noqa: E402
from reference import proben as ref_proben  # noqa: E402

ARCH = cells.load_module(BENCH / "arch" / "proben_late.py")
SEED = 20260419
METHODS = [(s, b) for s in SCORE_METHODS for b in BOX_METHODS]
TRAFFIC = {"batch": 2, "pool_batches": 1, "objects_per_frame": 3}
INPUT = {"pad_shape": [64, 96], "frame_hw": [32, 40], "min_size_test": 64, "max_size_test": 96}
CLASS_OFFSET = (40.0, 32.0)  # the frame's (w, h)


def _conf() -> dict:
    """The benchmark's ProbEn3 configuration at a tiny size: R50 members in
    float32, 100 proposals, 32x40 frames on a 64x96 canvas."""
    conf = json.loads((BENCH / "configs" / "flir_proben_late" / "config.json").read_text())
    conf = copy.deepcopy(conf)
    conf["input"].update(INPUT)
    conf["fusion"]["class_offset"] = list(CLASS_OFFSET)
    for m in conf["members"]:
        m["model"].update(depth=50, compute_dtype="float32")
        m["model"]["rpn"].update(pre_nms_topk_test=100, post_nms_topk_test=100)
        m["input"] = conf["input"]
        m["weights"]["detections_per_image"] = 12
    return conf


def _cfg(member: dict):
    """The program's configuration of a member, as users build it
    (``build_flir_cfg``), at the tiny size of ``_conf``."""
    cfg = flir.build_flir_cfg(member["name"])
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.COMPUTE_DTYPE = "float32"
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 100
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 100
    cfg.INPUT.PAD_SHAPE = tuple(INPUT["pad_shape"])
    cfg.INPUT.MIN_SIZE_TEST = INPUT["min_size_test"]
    cfg.INPUT.MAX_SIZE_TEST = INPUT["max_size_test"]
    mcfg = model_config_from_cfg(cfg)
    want = member["model"]
    assert (mcfg.depth, mcfg.input_format, list(mcfg.pixel_mean), mcfg.rcnn.score_thresh, mcfg.enable_gaussian_nll,
            mcfg.rpn.post_nms_topk_test, mcfg.rcnn.topk_per_image) == (
        want["depth"], want["input_format"], want["pixel_mean"], want["test"]["score_thresh"],
        want["enable_gaussian_nll"], want["rpn"]["post_nms_topk_test"], want["test"]["detections_per_image"])
    return cfg


def _params(cfg, sd):
    return import_detectron2_checkpoint(dict(sd), init_rcnn(0, model_config_from_cfg(cfg)))


@pytest.fixture(scope="module")
def ensemble():
    conf = _conf()
    batch = frames.inference_pool(SEED, TRAFFIC, conf["input"], 6, "cpu")[0]
    state = ARCH.make_state(conf, SEED, batch, "cpu")
    cfgs = [_cfg(m) for m in conf["members"]]
    members = [(cfg, _params(cfg, sd), tuple(m["channels"])) for cfg, sd, m in zip(cfgs, state, conf["members"])]
    pred = ProbEnPredictor.from_cfgs(members, device="cpu", class_offset=CLASS_OFFSET)
    images = list(batch["image"])
    ref_members = [ARCH.member_detections(m, sd, images, "cpu") for m, sd in zip(conf["members"], state)]
    return {"conf": conf, "state": state, "cfgs": cfgs, "batch": batch, "pred": pred, "ref_members": ref_members}


def _run(pred, batch):
    return pred.infer(batch["image"], batch["image_size"], batch["orig_size"])


def _valid(det: Detections, i: int) -> dict:
    m = det.valid[i]
    out = {"boxes": det.boxes[i][m], "scores": det.scores[i][m], "classes": det.classes[i][m]}
    if det.probs is not None:
        out["probs"] = det.probs[i][m]
    if det.variance is not None:
        out["variance"] = det.variance[i][m].reshape(-1)
    return out


def _assert_same(got: dict, want: dict, keys=("boxes", "scores", "classes")) -> None:
    """One image's detections equal in count, class and order, values to
    the module's tolerances."""
    assert got["scores"].shape[0] == want["scores"].shape[0], (got["scores"].shape, want["scores"].shape)
    for k in keys:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if k == "classes":
            np.testing.assert_array_equal(g, w)
        elif k == "boxes":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
        elif k == "variance":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=0)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def _reference_fused(ens, ref_members=None):
    f = ens["conf"]["fusion"]
    return [ref_proben.fuse(ref_proben.union(dets), f["score_method"], f["box_method"], f["iou_thresh"],
                            CLASS_OFFSET, f["topk"]) for dets in zip(*(ref_members or ens["ref_members"]))]


# ---------------------------------------------------------------------------
# the predictor against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("member", range(3), ids=("thermal_only", "early_fusion", "middle_fusion"))
def test_each_member_matches_its_reference(ensemble, member):
    b = ensemble["batch"]
    det = ensemble["pred"].member_detections(b["image"], b["image_size"], b["orig_size"])[member]
    for i, want in enumerate(ensemble["ref_members"][member]):
        got = _valid(det, i)
        assert got["scores"].shape[0] >= 5  # the fitted head leaves detections to compare
        _assert_same(got, want, ("boxes", "scores", "classes", "probs", "variance"))


def test_the_fused_detections_match_the_reference_loop(ensemble):
    det = _run(ensemble["pred"], ensemble["batch"])
    want = _reference_fused(ensemble)
    for i, w in enumerate(want):
        _assert_same(_valid(det, i), w)
    n_in = sum(len(d[0]["scores"]) for d in ensemble["ref_members"])
    assert len(want[0]["scores"]) < n_in  # clusters of more than one box were fused


def test_the_fitted_members_fire_on_the_same_objects(ensemble):
    """The members' heads are fitted to ground truth, and their count of
    detections to frames they were not fitted to (the batch's): each
    member gives the configured number an image on average there, and
    every image's fused answer holds clusters of several members."""
    want = ensemble["conf"]["members"][0]["weights"]["detections_per_image"]
    for dets in ensemble["ref_members"]:
        assert abs(np.mean([len(d["scores"]) for d in dets]) - want) <= 1.0
    for fused in _reference_fused(ensemble):
        assert int((fused["size"] > 1).sum()) >= 2


def test_predict_batch_is_infer_on_the_host(ensemble):
    b = ensemble["batch"]
    out = ensemble["pred"].predict_batch(b)
    det = _run(ensemble["pred"], b)
    assert [r["image_id"] for r in out] == b["image_id"]
    for i, rec in enumerate(out):
        assert isinstance(rec["boxes"], np.ndarray) and rec["classes"].dtype == np.int32
        _assert_same(rec, {k: v.numpy() for k, v in _valid(det, i).items()})


# ---------------------------------------------------------------------------
# the fusion alone, on clustered random ensembles
# ---------------------------------------------------------------------------

PAD = 24  # slots a member


def _member_output(rng, centres, sizes, obj_classes, extra):
    """One member's detections of the objects (each seen with probability
    0.8, jittered) and ``extra`` false positives, best first."""
    rows = []
    for c, s, k in zip(centres, sizes, obj_classes):
        if rng.rand() < 0.8:
            rows.append((np.concatenate([c - s / 2, c + s / 2]) + rng.normal(0, 3.0, 4), k))
    for _ in range(extra):
        c, s = rng.rand(2) * [560, 440] + 40, rng.rand(2) * 60 + 20
        rows.append((np.concatenate([c - s / 2, c + s / 2]), rng.randint(3)))
    probs = []
    for _, k in rows:
        p = rng.rand(3) * 0.2
        p[k] += rng.uniform(0.3, 0.8)
        probs.append(p / p.sum() * rng.uniform(0.55, 0.97))
    probs = np.asarray(probs, np.float32).reshape(-1, 3)
    boxes = np.asarray([b for b, _ in rows], np.float32).reshape(-1, 4)
    order = np.argsort(-probs.max(1), kind="stable")
    return {"boxes": boxes[order], "scores": probs.max(1)[order], "classes": probs.argmax(1)[order].astype(np.int32),
            "probs": probs[order], "variance": rng.uniform(0.2, 5.0, len(rows)).astype(np.float32)[order]}


def _clustered(seed, images=3, members=3, objects=7):
    """Per image, ``members`` detectors' outputs over shared objects: the
    padded (B, members x PAD, ...) tensors the predictor concatenates, and
    each image's members for the reference."""
    rng = np.random.RandomState(seed)
    per_image = []
    for _ in range(images):
        centres, sizes = rng.rand(objects, 2) * [560, 440] + 40, rng.rand(objects, 2) * 80 + 20
        obj_classes = rng.randint(0, 3, objects)
        per_image.append([_member_output(rng, centres, sizes, obj_classes, rng.randint(0, 3))
                          for _ in range(members)])
    shapes = {"boxes": (4,), "scores": (), "classes": (), "probs": (3,), "variance": ()}
    padded = {k: np.zeros((images, members * PAD) + s, np.int32 if k == "classes" else np.float32)
              for k, s in shapes.items()}
    padded["valid"] = np.zeros((images, members * PAD), bool)
    for i, dets in enumerate(per_image):
        for j, d in enumerate(dets):
            n = len(d["scores"])
            for k in shapes:
                padded[k][i, j * PAD:j * PAD + n] = d[k]
            padded["valid"][i, j * PAD:j * PAD + n] = True
    return {k: torch.from_numpy(v) for k, v in padded.items()}, per_image


def _fuse(padded, score_method, box_method, variance=True):
    p = padded
    return fuse_detections_torch(p["boxes"], p["scores"], p["classes"], p["probs"],
                                 p["variance"] if variance else None, p["valid"], score_method=score_method,
                                 box_method=box_method, thresh=0.5, class_offset=(640.0, 512.0), topk=100)


def _per_image(out, i):
    boxes, scores, classes, valid = out
    return {"boxes": boxes[i][valid[i]], "scores": scores[i][valid[i]], "classes": classes[i][valid[i]]}


def _reference(per_image, score_method, box_method):
    return [ref_proben.fuse(ref_proben.union([{k: torch.from_numpy(v) for k, v in d.items()} for d in dets]),
                            score_method, box_method, 0.5, (640.0, 512.0), 100) for dets in per_image]


@pytest.mark.parametrize("score_method,box_method", METHODS)
def test_the_fusion_matches_the_reference_loop(score_method, box_method):
    padded, per_image = _clustered(METHODS.index((score_method, box_method)))
    got = _fuse(padded, score_method, box_method)
    fused = 0
    for i, want in enumerate(_reference(per_image, score_method, box_method)):
        _assert_same(_per_image(got, i), want)
        fused += int(padded["valid"][i].sum()) - len(want["scores"])
    assert fused > 0  # clusters of several members were fused


@pytest.mark.parametrize("fault", ("v-avg_as_avg", "probEn_as_avg"))
def test_a_planted_fusion_fault_fails_the_comparison(fault):
    padded, per_image = _clustered(101)
    score_method, box_method = ("probEn", "avg") if fault == "v-avg_as_avg" else ("avg", "v-avg")
    got = _fuse(padded, score_method, box_method)
    want = _reference(per_image, "probEn", "v-avg")
    with pytest.raises(AssertionError):
        for i, w in enumerate(want):
            _assert_same(_per_image(got, i), w)


def test_a_member_on_another_members_channels_fails_the_comparison(ensemble):
    pred = ensemble["pred"]
    (thermal, _), *rest = pred.members
    wrong = ProbEnPredictor([(thermal, (0, 3))] + rest, class_offset=CLASS_OFFSET)  # BGR in place of TTT
    det = _run(wrong, ensemble["batch"])
    with pytest.raises(AssertionError):
        for i, w in enumerate(_reference_fused(ensemble)):
            _assert_same(_valid(det, i), w)


def test_a_member_without_its_variance_raises(ensemble):
    b = ensemble["batch"]
    cfg = ensemble["cfgs"][0].clone()
    cfg.MODEL.ROI_HEADS.ENABLE_GAUSSIANNLLOSS = False
    mcfg = model_config_from_cfg(cfg)
    no_var = Predictor(build_model(mcfg, params=init_rcnn(0, mcfg), device="cpu"), mcfg, "cpu")
    rest = ensemble["pred"].members[1:]
    with pytest.raises(ValueError, match="variance"):
        ProbEnPredictor([(no_var, (3, 6))] + rest, class_offset=CLASS_OFFSET)
    dets = ensemble["pred"].member_detections(b["image"], b["image_size"], b["orig_size"])
    dets[1].variance = None
    with pytest.raises(ValueError, match="variance"):
        ensemble["pred"].fuse(dets)
    with pytest.raises(ValueError, match="takes 3 channels"):
        ProbEnPredictor([(ensemble["pred"].members[0][0], (0, 4))] + rest)


# ---------------------------------------------------------------------------
# counters and spans
# ---------------------------------------------------------------------------


def _chains(lengths, n=10):
    """Per image a chain of ``links + 1`` boxes of one class, each
    overlapping the next (+1 IoU 0.61) and not the one after (0.34), then
    boxes apart; scores falling along the chain."""
    boxes = np.zeros((len(lengths), n, 4), np.float32)
    for b, links in enumerate(lengths):
        for i in range(n):
            x = 10.0 * i if i <= links else 1000.0 + 100.0 * i
            boxes[b, i] = [x, 0.0, x + 40.0, 40.0]
    scores = np.tile(np.linspace(0.9, 0.1, n, dtype=np.float32), (len(lengths), 1))
    probs = np.stack([scores, (1 - scores) / 4, (1 - scores) / 4], -1)
    return {"boxes": torch.from_numpy(boxes), "scores": torch.from_numpy(scores),
            "classes": torch.zeros(len(lengths), n, dtype=torch.int32), "probs": torch.from_numpy(probs),
            "variance": torch.ones(len(lengths), n), "valid": torch.ones(len(lengths), n, dtype=torch.bool)}


@pytest.mark.parametrize("lengths", ([0], [1], [4], [2, 6]), ids=("0", "1", "4", "2_and_6"))
def test_fixpoint_iterations_follow_the_longest_suppression_chain(lengths):
    before = tracing.counters()
    _fuse(_chains(lengths), "probEn", "v-avg")
    after = tracing.counters()
    assert after["proben.calls"] - before.get("proben.calls", 0) == 1
    assert after["proben.iters"] - before.get("proben.iters", 0) == max(lengths) + 1


def test_a_batch_counts_one_fusion_and_its_iterations(ensemble):
    b = ensemble["batch"]
    pred = ensemble["pred"]
    dets = pred.member_detections(b["image"], b["image_size"], b["orig_size"])
    before = tracing.counters()
    pred.fuse(dets)
    direct = tracing.counters()
    pred.predict_batch(b)
    after = tracing.counters()
    iters = direct["proben.iters"] - before.get("proben.iters", 0)
    assert iters >= 1
    assert after["proben.calls"] - direct["proben.calls"] == 1
    assert after["proben.iters"] - direct["proben.iters"] == iters


def _spans(fn, path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(Path(path).read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _within(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_spans_nest_under_a_profiler_and_are_no_ops_without(ensemble, tmp_path, monkeypatch):
    b = ensemble["batch"]
    spans = _spans(lambda: ensemble["pred"].predict_batch(b), tmp_path / "t.json")
    named = {}
    for e in spans:
        named.setdefault(e["name"], []).append(e)
    (outer,) = named["predictor.predict_batch"]
    members, (fuse,), (fixpoint,) = named["ensemble.member"], named["proben.fuse"], named["proben.fixpoint"]
    assert len(members) == 3 and all(_within(m, outer) for m in members)
    assert [sum(_within(f, m) for f in named["rcnn.features"]) for m in members] == [1, 1, 1]
    assert _within(fuse, outer) and _within(fixpoint, fuse)
    assert fuse["ts"] >= max(m["ts"] + m["dur"] for m in members)
    assert named["predictor.to_host"][0]["ts"] >= fuse["ts"] + fuse["dur"]

    def no_range(name):
        raise AssertionError(f"a profiler range {name!r} without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert len(ensemble["pred"].predict_batch(b)) == len(b["image_id"])
