"""``proben_tpu_torch.engine.DefaultTrainer`` against ``proben_tpu``'s on the
CPU, on a tiny synthetic COCO tree (tests/test_trainer.py's ``_tiny_cfg``:
R50, 64x80 images padded to 64x96, batch 2, 3 iterations, one loader
worker), from the same numpy parameters (the port's init with random
affines, the RPN's convs rescaled to output std 2 and 0.3 so the proposals
are not saturated boxes whose NMS ties on rounding).

Identity sampling, as tests/test_torch_train.py uses it: the RPN samples
every anchor and the RoI heads every proposal and gt box (positive
fraction 1), so the two packages' different random numbers only reorder
the sampled rows. Both loaders draw from ``training_index_stream(4, 0)``
and ``RandomState(0)``, so the batches are the same and every loss of every
step agrees to rtol 1e-4 (f32 through 50 layers in other summation orders,
as in tests/test_torch_train.py). Also: metrics.json, checkpoint and resume,
the hook order, ``MODEL.FREEZE_MODULES``, PreciseBN and the event writers.
"""

import json
import os
import sys
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.config import get_cfg as jax_get_cfg
from proben_tpu.config import model_config_from_cfg as jax_model_config_from_cfg
from proben_tpu.data import DatasetCatalog as JaxDatasetCatalog
from proben_tpu.data import register_coco_instances as jax_register_coco_instances
from proben_tpu.engine import CallbackHook as JaxCallbackHook
from proben_tpu.engine import DefaultTrainer as JaxDefaultTrainer
from proben_tpu.models import init_rcnn as jax_init_rcnn
from proben_tpu.utils.events import EventStorage as JaxEventStorage
from proben_tpu.utils.events import JSONWriter as JaxJSONWriter
from proben_tpu_torch.checkpoint import state_dict_to_jax
from proben_tpu_torch.config import get_cfg, mapper_config_from_cfg, model_config_from_cfg
from proben_tpu_torch.data import DatasetCatalog, DatasetMapper, collate, register_coco_instances
from proben_tpu_torch.engine import CallbackHook, DefaultTrainer, PreciseBNHook
from proben_tpu_torch.models import build_model, init_rcnn, random_affines
from proben_tpu_torch.models import rcnn as t_rcnn
from proben_tpu_torch.utils.events import EventStorage, JSONWriter, get_event_storage
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

H, W, PAD = 64, 80, (64, 96)
PRE, POST, G = 64, 32, 8
N_ANCHORS = sum(-(-PAD[0] // s) * -(-PAD[1] // s) * 3 for s in (4, 8, 16, 32, 64))
NAME = "tiny_torch_trainer_ds"

_ABSENT = object()


@pytest.fixture(autouse=True, scope="module")
def _no_tensorboard():
    """TensorBoard's import pulls in TensorFlow (~17 s of CPU, several times
    that under a loaded test run), so the trainers here take
    ``TensorboardWriter``'s no-op path (tests/test_torch_trainer.py tests
    that path on its own)."""
    saved = sys.modules.get("torch.utils.tensorboard", _ABSENT)
    sys.modules["torch.utils.tensorboard"] = None  # its import raises ImportError
    yield
    if saved is _ABSENT:
        del sys.modules["torch.utils.tensorboard"]
    else:
        sys.modules["torch.utils.tensorboard"] = saved


def _image(rng):
    """Background gradient + box-shaped blobs (bench.py's recipe), uint8."""
    im = np.tile(np.linspace(60.0, 120.0, W)[None, :, None], (H, 1, 3))
    im += rng.randn(H, W, 3) * 8
    boxes = []
    for _ in range(rng.randint(1, 4)):
        bw, bh = rng.randint(12, 36), rng.randint(12, 40)
        x, y = rng.randint(0, W - bw), rng.randint(0, H - bh)
        im[y:y + bh, x:x + bw] = rng.uniform(130, 240)
        boxes.append([float(x), float(y), float(bw), float(bh)])
    return np.clip(im, 0, 255).astype(np.uint8), boxes


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_trainer")
    tdir = root / "thermal_8_bit"
    tdir.mkdir()
    rng = np.random.RandomState(0)
    images, annotations = [], []
    for i in range(4):
        name = f"FLIR_{i:05d}.jpeg"
        im, boxes = _image(rng)
        cv2.imwrite(str(tdir / name), im)
        images.append({"id": i + 1, "file_name": name, "height": H, "width": W})
        for b in boxes:
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1,
                                "category_id": 1 + len(annotations) % 3, "bbox": b,
                                "area": b[2] * b[3], "iscrowd": 0})
    js = {"images": images, "annotations": annotations,
          "categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "bicycle"},
                         {"id": 3, "name": "car"}]}
    p = root / "ann.json"
    p.write_text(json.dumps(js))
    for catalog, register in ((DatasetCatalog, register_coco_instances),
                              (JaxDatasetCatalog, jax_register_coco_instances)):
        catalog.remove(NAME)
        register(NAME, {}, str(p), str(tdir))
    return root


def _tiny_cfg(get, out_dir):
    cfg = get()
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.SEED = 0
    cfg.DATASETS.TRAIN = (NAME,)
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.SOLVER.MAX_ITER = 3
    cfg.SOLVER.BASE_LR = 0.001
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.SOLVER.WARMUP_ITERS = 10
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = PRE
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = POST
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = N_ANCHORS
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = POST + G
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    cfg.INPUT.PAD_SHAPE = PAD
    cfg.INPUT.MIN_SIZE_TRAIN = (56, 64)
    cfg.INPUT.MAX_SIZE_TRAIN = 96
    cfg.INPUT.MAX_GT = G
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.TEST.PRECISE_BN.ENABLED = True  # in the hook list; disables itself
    # the plain compositions in both packages (JAX: no interpreted Pallas)
    cfg.MODEL.ROI_ALIGN_IMPL = "gather"
    cfg.MODEL.STEM_IMPL = "direct"
    return cfg


def _calibrated(cfg):
    """The port's init with random affines, RPN convs rescaled on the first
    mapped batch (weights only; the same parameters go to both packages)."""
    mcfg = model_config_from_cfg(cfg)
    params = random_affines(init_rcnn(0, mcfg), 0)
    model = build_model(mcfg, params=params, device="cpu")
    mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=True, device="cpu")
    batch = collate(mapper.map_batch(DatasetCatalog.get(NAME)[:2]))
    with torch.inference_mode():
        feats = t_rcnn.extract_features(model, mcfg, t_rcnn.preprocess(mcfg, batch["image"]))
        lg, dl = t_rcnn.rpn_outputs(model, mcfg, feats)
    head = params["rpn_head"]
    for name, t, target in (("objectness", lg, 2.0), ("deltas", dl, 0.3)):
        s = target / float(torch.cat([x.flatten() for x in t]).std())
        head[name]["w"] = head[name]["w"] * s
        head[name]["b"] = head[name]["b"] * s
    return params


def _recorder(hook_cls, steps):
    return hook_cls(after_step=lambda t: steps.append(
        {k: v for k, (v, _) in t.storage.latest().items() if k not in ("time",)}))


@pytest.fixture(scope="module")
def runs(tree):
    params = _calibrated(_tiny_cfg(get_cfg, tree / "port"))

    jcfg = _tiny_cfg(jax_get_cfg, tree / "jax")
    jsteps = []
    jt = JaxDefaultTrainer(jcfg, params=jax.tree_util.tree_map(jnp.asarray, params))
    jt.register_hooks([_recorder(JaxCallbackHook, jsteps)])
    jt.train()

    cfg = _tiny_cfg(get_cfg, tree / "port")
    steps = []
    t = DefaultTrainer(cfg, params=params, device="cpu")
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    t.register_hooks([_recorder(CallbackHook, steps)])
    t.train()
    resumed = DefaultTrainer(cfg, params=params, device="cpu")
    resumed.resume_or_load(resume=True)
    resumed.train_loader.close()
    return dict(cfg=cfg, jcfg=jcfg, steps=steps, jsteps=jsteps, trainer=t, jtrainer=jt,
                resumed=resumed, before=before)


def test_losses_match_jax_at_every_step(runs):
    steps, jsteps = runs["steps"], runs["jsteps"]
    assert len(steps) == len(jsteps) == 3
    names = {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss"}
    for i, (got, want) in enumerate(zip(steps, jsteps)):
        assert set(got) == set(want), (i, set(got) ^ set(want))
        assert got["loss_finite"] == want["loss_finite"] == 1.0
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)  # JAX's in f32
        for k in names:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"step {i}: {k}")
    assert steps[0]["loss_box_reg"] > 0 and steps[0]["loss_rpn_loc"] > 0
    # the parameters moved between steps in both packages
    assert steps[2]["total_loss"] != steps[0]["total_loss"]


def test_metrics_json_matches_jax(runs):
    def lines(cfg):
        with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json")) as f:
            return [json.loads(ln) for ln in f]

    got, want = lines(runs["cfg"]), lines(runs["jcfg"])
    assert [r["iteration"] for r in got] == [r["iteration"] for r in want] == [2]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    np.testing.assert_allclose(got[0]["total_loss"], want[0]["total_loss"], rtol=1e-4)


def test_checkpoint_and_resume(runs):
    """The last periodic checkpoint is at iteration 2 in both packages; the
    resumed trainer starts at 3 with parameters, momentum, step and seed
    equal to the trained one's."""
    t, r = runs["trainer"], runs["resumed"]
    assert t.iter == runs["jtrainer"].iter == 2
    assert t.checkpointer.latest_step() == runs["jtrainer"].checkpointer.latest_step() == 2
    assert r.start_iter == 3 and r.state.step == t.state.step == 3 and r.state.seed == t.state.seed
    for (n, a), (_, b) in zip(t.model.state_dict().items(), r.model.state_dict().items()):
        assert torch.equal(a, b), n
    for n, v in t.state.momentum.items():
        assert torch.equal(v, r.state.momentum[n]), n
    moved = [n for n, p in t.model.named_parameters() if not torch.equal(p, runs["before"][n])]
    assert moved and all(p.requires_grad for n, p in t.model.named_parameters() if n in moved)


@pytest.fixture(scope="module")
def converted(runs, tree):
    """JAX's checkpoint root after its run (its own ``iter_0000001`` and
    ``iter_0000002`` train states, and a ``best/`` that JAX's
    ``CheckpointManager.save_best`` writes here) through
    ``tools/orbax_to_torch.py`` with seed 7."""
    pytest.importorskip("orbax.checkpoint")
    from tools import orbax_to_torch

    jt = runs["jtrainer"]
    assert jt.checkpointer.save_best(2, 12.5, jt.params)
    src = os.path.join(runs["jcfg"].OUTPUT_DIR, "checkpoints")
    dst = str(tree / "from_jax" / "checkpoints")
    kinds = orbax_to_torch.main([src, dst, "--seed", "7"])
    return dict(src=src, dst=dst, kinds=kinds)


def test_orbax_converter_refuses_overlapping_or_full_destinations(tmp_path):
    """``tools/orbax_to_torch.py`` checks DST before it reads SRC: DST equal
    to SRC, holding it, inside it or not empty raises ValueError, and every
    file of SRC and DST is still there (needs no orbax)."""
    from tools import orbax_to_torch

    root = tmp_path / "out"
    src = root / "checkpoints"
    (src / "iter_0000001").mkdir(parents=True)
    (src / "iter_0000001" / "data").write_bytes(b"jax")
    (src / "last.json").write_text("{}")
    full = tmp_path / "full"
    full.mkdir()
    (full / "keep.txt").write_text("keep")
    files = sorted(p for p in tmp_path.rglob("*"))
    for s, d in ((src, src), (src, root), (src, src / "converted"), (src / "iter_0000001", src),
                 (src / "iter_0000001", src / "iter_0000001"), (src, full)):
        with pytest.raises(ValueError):
            orbax_to_torch.main([str(s), str(d)])
    assert sorted(p for p in tmp_path.rglob("*")) == files
    assert (src / "iter_0000001" / "data").read_bytes() == b"jax" and (full / "keep.txt").read_text() == "keep"


def _jax_state_named(state):
    """A JAX ``TrainState``'s parameters and momentum by the port's
    parameter names, in the port's layouts."""
    from proben_tpu_torch.checkpoint import state_dict_from_jax

    host = jax.tree_util.tree_map(np.asarray, state)
    return state_dict_from_jax(host.params), state_dict_from_jax(host.opt_state["momentum"])


def test_orbax_checkpoints_convert_bit_for_bit(runs, converted):
    """The converted root: every train state's parameters and momentum
    equal JAX's by name, bit for bit, with its step and the given seed;
    ``best/`` through ``restore_pytree``, ``CheckpointManager.restore_best``
    and ``apps/flir.py::load_params`` gives JAX's parameter leaves bit for
    bit; ``last.json`` points into the new root and records the seed and
    that the sampling after a resume is the port's own."""
    from proben_tpu_torch.apps import flir
    from proben_tpu_torch.checkpoint import CheckpointManager, restore_pytree

    dst, jt = converted["dst"], runs["jtrainer"]
    assert converted["kinds"] == {"best": "pytree", "iter_0000001": "train_state",
                                  "iter_0000002": "train_state"}
    final = restore_pytree(os.path.join(dst, "iter_0000002"))
    params, momentum = _jax_state_named(jt.state)
    assert final["step"] == int(jt.state.step) == 3 and final["seed"] == 7
    for name in params:
        assert torch.equal(final["params"][name], params[name]), name
        assert torch.equal(final["momentum"][name], momentum[name]), name
    assert sorted(final["params"]) == sorted(n for n, _ in runs["trainer"].model.named_parameters())
    assert restore_pytree(os.path.join(dst, "iter_0000001"))["step"] == 2

    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jt.params))
    template = init_rcnn(0, model_config_from_cfg(runs["cfg"]))
    manager = CheckpointManager(dst)
    for got in (restore_pytree(os.path.join(dst, "best"), template), manager.restore_best(template),
                flir.load_params(runs["cfg"], os.path.join(dst, "best"))):
        leaves = jax.tree_util.tree_leaves(got)
        assert len(leaves) == len(want)
        assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(leaves, want))
    meta = json.load(open(os.path.join(dst, "last.json")))
    assert meta["last"] == os.path.join(dst, "iter_0000002") and meta["step"] == 2
    assert meta["kept"] == [os.path.join(dst, f"iter_000000{i}") for i in (1, 2)]
    assert meta["seed"] == 7 and "sampling" in meta and meta["best_metric"] == 12.5
    assert manager.latest_step() == 2 and manager.best_metric == 12.5


def test_port_trainer_resumes_jax_checkpoints(runs, converted, tree):
    """``resume_or_load`` on the converted root starts at iteration 3 with
    JAX's final state bit for bit. From the converted ``iter_0000001``
    (JAX's state after two steps, restored as ``resume_or_load`` restores),
    with the loader advanced past the two batches JAX had taken, the
    port's step gives JAX's third-step losses to rtol 1e-4 (identity
    sampling; the tolerance of ``test_losses_match_jax_at_every_step``)."""
    from proben_tpu_torch.checkpoint import load_train_state, restore_pytree, train_state_tree

    params = _calibrated(_tiny_cfg(get_cfg, tree / "port"))
    cfg = _tiny_cfg(get_cfg, tree / "from_jax")
    resumed = DefaultTrainer(cfg, params=params, device="cpu")
    resumed.resume_or_load(resume=True)
    resumed.train_loader.close()
    want, want_m = _jax_state_named(runs["jtrainer"].state)
    assert resumed.start_iter == 3 and resumed.state.step == 3 and resumed.state.seed == 7
    for name, p in resumed.model.named_parameters():
        assert torch.equal(p.detach(), want[name]) and torch.equal(resumed.state.momentum[name],
                                                                   want_m[name]), name

    cfg = _tiny_cfg(get_cfg, tree / "from_jax_step")
    t = DefaultTrainer(cfg, params=params, device="cpu")
    tree1 = restore_pytree(os.path.join(converted["dst"], "iter_0000001"), train_state_tree(t.state))
    t.state = load_train_state(tree1, t.state)
    t.start_iter = 2
    for _ in range(2):
        next(t.train_loader)
    steps = []
    t.register_hooks([_recorder(CallbackHook, steps)])
    t.train()
    (got,), jwant = steps, runs["jsteps"][2]
    for k in ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss"):
        np.testing.assert_allclose(got[k], jwant[k], rtol=1e-4, err_msg=k)
    assert got["lr"] == pytest.approx(jwant["lr"], rel=1e-6)


def test_trainer_params_are_the_jax_layout(runs):
    """``trainer.params``: the numpy pytree ``load_params`` reads, equal to
    the live model."""
    t = runs["trainer"]
    got = t.params
    want = state_dict_to_jax(t.model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(leaves) == len(jax.tree_util.tree_leaves(want))
    assert all(isinstance(leaf, np.ndarray) for _, leaf in leaves)
    ref = jax.eval_shape(lambda k: jax_init_rcnn(k, jax_model_config_from_cfg(runs["jcfg"])),
                         jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for (path, leaf), want_leaf in zip(leaves, jax.tree_util.tree_leaves(ref)):
        assert leaf.shape == want_leaf.shape and leaf.dtype == want_leaf.dtype, path


def test_hook_order_matches_jax(tree):
    """The hook list of a config with PreciseBN and periodic evaluation on."""
    kinds = []
    for get, cls, kw, out in ((get_cfg, DefaultTrainer, {"device": "cpu"}, "port_hooks"),
                              (jax_get_cfg, JaxDefaultTrainer, {}, "jax_hooks")):
        cfg = _tiny_cfg(get, tree / out)
        cfg.DATASETS.TEST = (NAME,)
        cfg.TEST.EVAL_PERIOD = 5
        params = init_rcnn(0, model_config_from_cfg(cfg))
        if cls is JaxDefaultTrainer:
            params = jax.tree_util.tree_map(jnp.asarray, params)
        t = cls(cfg, params=params, **kw)
        kinds.append([type(h).__name__ for h in t._hooks])
        t.train_loader.close()
    assert kinds[0] == kinds[1] == ["IterationTimer", "LRLogger", "PeriodicWriter",
                                    "PeriodicCheckpointer", "PreciseBNHook", "EvalHook"]


@pytest.mark.parametrize("fmt", ["BGR", "BGRTTT"])
def test_freeze_modules_freezes_jax_set(fmt):
    """``MODEL.FREEZE_MODULES`` (KAIST's) and ``FREEZE_AT`` give the same
    trainable set as JAX's ``build_trainable_mask``, leaf for leaf."""
    cfgs = []
    for get in (get_cfg, jax_get_cfg):
        cfg = get()
        cfg.MODEL.BACKBONE.FREEZE_AT = 3
        cfg.MODEL.FREEZE_MODULES = ("backbone", "backbone_2", "roi")
        if fmt == "BGRTTT":
            cfg.INPUT.FORMAT = "BGRTTT"
            cfg.MODEL.PIXEL_MEAN = [103.53, 116.28, 123.675] + [135.438] * 3
        cfgs.append(cfg)
    mcfg = model_config_from_cfg(cfgs[0])
    model = build_model(mcfg, device="cpu")
    mask = DefaultTrainer.build_trainable_mask(types.SimpleNamespace(cfg=cfgs[0]), model)
    got = state_dict_to_jax({n: torch.tensor(v) for n, v in mask.items()})
    params = jax.tree_util.tree_map(np.asarray, init_rcnn(0, mcfg))
    want = JaxDefaultTrainer.build_trainable_mask(types.SimpleNamespace(cfg=cfgs[1]), params)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(got_leaves) == set(want_leaves)
    assert all(bool(got_leaves[p]) == bool(want_leaves[p]) for p in want_leaves)
    trainable = {jax.tree_util.keystr(p)[2:].split("'")[0] for p, v in want_leaves.items() if v}
    assert trainable == ({"fpn", "rpn_head", "fpn_2"} if fmt == "BGRTTT" else {"fpn", "rpn_head"})


def test_precise_bn_hook_updates_stats_and_self_disables():
    """PreciseBNHook (reference engine/hooks.py:358): with a stats function
    it recomputes running stats by the law of total variance (as
    tests/test_trainer.py checks JAX's); without one (FrozenBN models, every
    shipped config) it disables itself."""
    model = {"bn": {"running_mean": torch.zeros(2), "running_var": torch.ones(2)}}
    trainer = types.SimpleNamespace(state=types.SimpleNamespace(model=model), iter=9, max_iter=100)
    batches = iter([{"x": torch.full((4, 2), float(i))} for i in range(100)])

    def stats_fn(m, batch):
        return {"bn": (batch["x"].mean(0), batch["x"].var(0, unbiased=False))}

    def apply_fn(m, stats):
        m["bn"]["running_mean"], m["bn"]["running_var"] = stats["bn"]

    hook = PreciseBNHook(period=10, data_iter=batches, stats_fn=stats_fn, apply_fn=apply_fn,
                         num_iters=3)
    hook.trainer = trainer
    assert not hook.disabled
    hook.after_step()
    np.testing.assert_allclose(model["bn"]["running_mean"].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(model["bn"]["running_var"].numpy(), 2.0 / 3.0, atol=1e-6)

    off = PreciseBNHook(period=10, data_iter=batches, stats_fn=None, apply_fn=None, num_iters=3)
    off.trainer = trainer
    off.after_step()
    assert off.disabled and next(batches)["x"][0, 0] == 3.0  # nothing consumed


def test_event_storage_and_json_lines_match_jax(tmp_path):
    """The same scalars through both packages' storage and JSONWriter give
    the same metrics.json lines (median smoothing over the window)."""
    rng = np.random.RandomState(3)
    values = rng.rand(25, 3)
    out = []
    for storage_cls, writer_cls, name in ((EventStorage, JSONWriter, "port.json"),
                                          (JaxEventStorage, JaxJSONWriter, "jax.json")):
        writer = writer_cls(str(tmp_path / name))
        with storage_cls(start_iter=4) as s:
            for v in values:
                s.put_scalars(loss_a=v[0], loss_b=v[1])
                s.put_scalar("lr", v[2])
                if s.iter % 10 == 0:
                    writer.write(s)
                s.step()
            writer.write(s)
            if storage_cls is EventStorage:
                assert get_event_storage() is s
        writer.close()
        out.append((tmp_path / name).read_text())
    assert out[0] == out[1] and out[0].count("\n") == 3
    with pytest.raises(RuntimeError, match="outside"):
        get_event_storage()


def test_batch_norm_matches_jax():
    """``sync_batch_norm`` on one process (training and eval) and
    ``precise_bn_stats`` against JAX's, f32 to 1e-5; a group raises where
    no process group is initialised."""
    from proben_tpu.models import batch_norm as jax_bn
    from proben_tpu_torch.models import batch_norm as bn

    rng = np.random.RandomState(6)
    x = (rng.randn(2, 5, 6, 4) * 3 + 1).astype(np.float32)
    params = {"weight": rng.rand(4).astype(np.float32) + 0.5, "bias": rng.randn(4).astype(np.float32),
              "running_mean": rng.randn(4).astype(np.float32),
              "running_var": rng.rand(4).astype(np.float32) + 0.5}
    for training in (True, False):
        got, got_p = bn.sync_batch_norm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()},
                                        training=training)
        want, want_p = jax_bn.sync_batch_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
                                              training=training)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        for k in params:
            np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]), rtol=1e-5, atol=1e-6)
    pairs = [(rng.randn(3).astype(np.float32), rng.rand(3).astype(np.float32)) for _ in range(4)]
    got = bn.precise_bn_stats([tuple(map(torch.from_numpy, p)) for p in pairs])
    want = jax_bn.precise_bn_stats([tuple(map(jnp.asarray, p)) for p in pairs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # across ranks it needs a process group (tests/test_torch_ddp.py runs one)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        bn.sync_batch_norm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()},
                           group=object())


def test_profiler_hook_writes_a_chrome_trace(tmp_path):
    """``ProfilerHook`` traces the chosen iterations with ``torch.profiler``
    and writes one Chrome trace each to the output directory."""
    from proben_tpu_torch.engine import ProfilerHook

    hook = ProfilerHook(lambda t: t.iter == 1, str(tmp_path))
    hook.trainer = types.SimpleNamespace(iter=0, device=torch.device("cpu"))
    for it in range(3):
        hook.trainer.iter = it
        hook.before_step()
        torch.randn(64, 64) @ torch.randn(64, 64)
        hook.after_step()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["trace_iter1.json"]
    trace = json.loads((tmp_path / "trace_iter1.json").read_text())
    assert trace["traceEvents"]


def test_tensorboard_writer_is_a_no_op_without_tensorboard(monkeypatch, tmp_path):
    import logging

    from proben_tpu_torch.utils.events import CommonMetricPrinter, TensorboardWriter

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("proben_tpu_torch.utils.events")
    log.addHandler(handler)  # the package's logger may not propagate (setup_logger)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import raises ImportError
    try:
        writer = TensorboardWriter(str(tmp_path))
    finally:
        log.removeHandler(handler)
    assert any("no-op" in r.getMessage() and r.levelno == logging.WARNING for r in records)
    assert not list(tmp_path.iterdir())
    with EventStorage() as s:
        s.put_scalars(loss_x=1.5, lr=0.1, time=0.2)
        writer.write(s)
        CommonMetricPrinter(10).write(s)
    writer.close()
