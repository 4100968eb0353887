"""Data-parallel training of ``proben_tpu_torch`` (``parallel/``, the
rank-aware ``DefaultTrainer``, ``TrainLoader``, ``DatasetMapper`` and
``sync_batch_norm``) on the CPU: gloo over 2 spawned processes with a
``file://`` init in ``tmp_path``, held to one process on the same global
batch.

The trainer's spawn starts 3 ranks at ``IMS_PER_BATCH`` 2: as in the JAX
trainer, the first 2 (the most ranks that divide the batch) train in a
process group of their own and the third sits out. The two ranks run the
tiny R50 trainer of tests/test_torch_trainer.py (one image per rank) for 2
steps with real random
sampling (not the identity sampling of the JAX comparisons): the mapper's
flips and sizes and the sampled anchors and RoIs are drawn for the global
batch and each rank keeps its rows, so every rank computes what the
one-process step computes for its image. Tolerance: the same f32 math in
other summation orders. The CPU's convolutions take another order for a
batch of 1 than for 2, so the first step's losses (same parameters) already
differ, by up to 2.04e-5 relative (``loss_box_reg``; measured), and the
gradient is summed over the two images by the all-reduce instead of inside
the convolutions' backward: losses to rtol 1e-4 (as tests/
test_torch_train.py's f32 through 50 layers), parameters to atol 1e-6
(measured 6e-8). No JAX here.
"""

import json
import os
import sys
import time

import cv2
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from proben_tpu_torch.config import get_cfg, mapper_config_from_cfg
from proben_tpu_torch.data import DatasetCatalog, DatasetMapper, TrainLoader, register_coco_instances
from proben_tpu_torch.engine import CallbackHook, DefaultTrainer
from proben_tpu_torch.models import batch_norm as bn
from proben_tpu_torch.parallel import DataMesh, all_mean, data_parallel_group, dividing_group, shard_batch

H, W, PAD = 64, 80, (64, 96)
NAME = "tiny_torch_ddp_ds"
TIMEOUT = 240  # seconds for a spawned set of ranks


def _no_tensorboard():
    """TensorBoard's import pulls in TensorFlow (~17 s of CPU), so the
    trainers here take ``TensorboardWriter``'s no-op path, as in
    tests/test_torch_trainer.py."""
    sys.modules["torch.utils.tensorboard"] = None  # its import raises ImportError


@pytest.fixture(autouse=True)
def _tensorboard_off(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _image(rng):
    im = np.tile(np.linspace(60.0, 120.0, W)[None, :, None], (H, 1, 3))
    im += rng.randn(H, W, 3) * 8
    boxes = []
    for _ in range(rng.randint(1, 4)):
        bw, bh = rng.randint(12, 36), rng.randint(12, 40)
        x, y = rng.randint(0, W - bw), rng.randint(0, H - bh)
        im[y:y + bh, x:x + bw] = rng.uniform(130, 240)
        boxes.append([float(x), float(y), float(bw), float(bh)])
    return np.clip(im, 0, 255).astype(np.uint8), boxes


def _write_tree(root):
    tdir = os.path.join(root, "thermal_8_bit")
    os.makedirs(tdir)
    rng = np.random.RandomState(0)
    images, annotations = [], []
    for i in range(4):
        name = f"FLIR_{i:05d}.jpeg"
        im, boxes = _image(rng)
        cv2.imwrite(os.path.join(tdir, name), im)
        images.append({"id": i + 1, "file_name": name, "height": H, "width": W})
        for b in boxes:
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1,
                                "category_id": 1 + len(annotations) % 3, "bbox": b,
                                "area": b[2] * b[3], "iscrowd": 0})
    js = {"images": images, "annotations": annotations,
          "categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "bicycle"},
                         {"id": 3, "name": "car"}]}
    with open(os.path.join(root, "ann.json"), "w") as f:
        json.dump(js, f)


def _register(root):
    DatasetCatalog.remove(NAME)
    register_coco_instances(NAME, {}, os.path.join(root, "ann.json"),
                            os.path.join(root, "thermal_8_bit"))


def _cfg(out_dir, batch=2):
    cfg = get_cfg()
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.SEED = 0
    cfg.DATASETS.TRAIN = (NAME,)
    cfg.SOLVER.IMS_PER_BATCH = batch
    cfg.SOLVER.MAX_ITER = 2
    cfg.SOLVER.BASE_LR = 0.001
    cfg.SOLVER.CHECKPOINT_PERIOD = 100
    cfg.SOLVER.WARMUP_ITERS = 10
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 32
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.INPUT.PAD_SHAPE = PAD
    cfg.INPUT.MIN_SIZE_TRAIN = (56, 64)
    cfg.INPUT.MAX_SIZE_TRAIN = 96
    cfg.INPUT.MAX_GT = 8
    cfg.DATALOADER.NUM_WORKERS = 1
    return cfg


def _train(cfg):
    """(losses per step, final parameters, the trainer) of a
    ``DefaultTrainer`` run on the CPU after ``resume_or_load`` (nothing to
    resume: data parallel, rank 0's parameters, momentum and step go to
    the training ranks); no step on a rank that sits out."""
    trainer = DefaultTrainer(cfg, device="cpu")
    trainer.resume_or_load(resume=True)
    steps = []
    trainer.register_hooks([CallbackHook(after_step=lambda t: steps.append(
        {k: float(v) for k, v in t._last_metrics.items()}))])
    trainer.train()
    params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    return steps, params, trainer


def _spawn(fn, tmp_path, *args, nprocs=2):
    """Run ``fn(rank, init_file, *args)`` on ``nprocs`` spawned ranks (the
    world size is ``args[-1]``'s where ``fn`` takes one); fail on a rank's
    error or after ``TIMEOUT`` s."""
    ctx = mp.spawn(fn, args=(str(tmp_path / "init"),) + args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + TIMEOUT
    while not ctx.join(1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"the ranks did not finish within {TIMEOUT} s")


def _init(rank, init_file, world=2):
    torch.set_num_threads(2)
    _no_tensorboard()
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)


def _bn_inputs():
    rng = np.random.RandomState(6)
    x = (rng.randn(4, 5, 6, 3) * 3 + 1).astype(np.float32)
    g = rng.randn(4, 5, 6, 3).astype(np.float32)
    params = {"weight": rng.rand(3).astype(np.float32) + 0.5, "bias": rng.randn(3).astype(np.float32),
              "running_mean": rng.randn(3).astype(np.float32),
              "running_var": rng.rand(3).astype(np.float32) + 0.5}
    return x, g, params


def _sync_bn_half(rank, x, g, params, group):
    """``sync_batch_norm`` of rank ``rank``'s half of ``x`` over ``group``:
    (output, the input's gradient against cotangent ``g``, new running
    statistics)."""
    half = x.shape[0] // 2
    xr = torch.from_numpy(x[rank * half:(rank + 1) * half]).requires_grad_()
    out, new = bn.sync_batch_norm(xr, {k: torch.from_numpy(v) for k, v in params.items()}, group=group)
    (grad,) = torch.autograd.grad((out * torch.from_numpy(g[rank * half:(rank + 1) * half])).sum(), xr)
    return {"out": out.detach(), "grad": grad, "running": {k: v.detach() for k, v in new.items()}}


def _trainer_rank(rank, init_file, root, out_dir, result_dir, world):
    _init(rank, init_file, world)
    try:
        _register(root)
        steps, params, trainer = _train(_cfg(out_dir))
        mesh = trainer.mesh
        assert (mesh.rank, mesh.world) == (rank, 2)
        got = {"steps": steps, "sits_out": mesh.sits_out}
        if not mesh.sits_out:  # its parameters, and SyncBN over the training ranks' own group
            got.update(params=params, bn=_sync_bn_half(rank, *_bn_inputs(), mesh.group))
        torch.save(got, os.path.join(result_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _sync_bn_whole():
    x, g, params = _bn_inputs()
    xt = torch.from_numpy(x).requires_grad_()
    out, new = bn.sync_batch_norm(xt, {k: torch.from_numpy(v) for k, v in params.items()})
    (grad,) = torch.autograd.grad((out * torch.from_numpy(g)).sum(), xt)
    return out.detach(), grad, new


def _assert_bn_halves_equal_whole(halves):
    out, grad, new = _sync_bn_whole()
    torch.testing.assert_close(torch.cat([r["out"] for r in halves]), out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([r["grad"] for r in halves]), grad, rtol=1e-5, atol=1e-5)
    for r in halves:
        for k, v in new.items():
            torch.testing.assert_close(r["running"][k], v.detach(), rtol=1e-5, atol=1e-6)


def test_two_ranks_equal_one_process_and_rank0_writes_the_metrics(tmp_path):
    """3 gloo ranks of ``DefaultTrainer`` at a global batch of 2: as in the
    JAX trainer, ranks 0 and 1 (one image each, a process group of their
    own) train and rank 2 sits out, takes no step and raises nothing.
    Against one process at the global batch of 2, over 2 steps: every loss
    of every step and the parameters after the last; both training ranks
    hold the same parameters; one ``metrics.json``, written by rank 0, with
    one line per step. ``sync_batch_norm`` over the training ranks' group
    equals one process on the whole batch (as in the test below)."""
    root = str(tmp_path / "tree")
    _write_tree(root)
    _register(root)
    out = tmp_path / "ddp"
    _spawn(_trainer_rank, tmp_path, root, str(out), str(tmp_path), 3, nprocs=3)
    idle = torch.load(tmp_path / "rank2.pt")
    assert idle["sits_out"] and idle["steps"] == [] and "params" not in idle
    assert "rank 2 sits out" in (out / "log.txt.rank2").read_text()
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert not any(r["sits_out"] for r in ranks)
    _assert_bn_halves_equal_whole([r["bn"] for r in ranks])
    want_steps, want_params, trainer = _train(_cfg(tmp_path / "one"))
    assert (trainer.mesh.rank, trainer.mesh.world) == (0, 1)

    assert len(want_steps) == 2 and all(r["steps"] == ranks[0]["steps"] for r in ranks)
    for got, want in zip(ranks[0]["steps"], want_steps):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert all(s["loss_finite"] == 1.0 for s in want_steps)
    for k, want in want_params.items():
        for r in ranks:
            assert torch.equal(r["params"][k], ranks[0]["params"][k]), k
        np.testing.assert_allclose(ranks[0]["params"][k].numpy(), want.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    written = sorted(p.name for p in out.iterdir() if p.name.startswith("metrics"))
    assert written == ["metrics.json"]
    lines = (out / "metrics.json").read_text().strip().splitlines()
    record = json.loads(lines[0])
    assert len(lines) == 1 and record["iteration"] == 1  # PeriodicWriter at the last step
    assert np.isfinite(record["total_loss"])
    assert (out / "log.txt.rank1").exists()


def _sync_bn_rank(rank, init_file, result_dir):
    _init(rank, init_file)
    try:
        torch.save(_sync_bn_half(rank, *_bn_inputs(), dist.group.WORLD),
                   os.path.join(result_dir, f"bn{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_sync_batch_norm_over_two_ranks_equals_the_global_batch(tmp_path):
    """``sync_batch_norm`` with the world group, each rank on half of a
    batch: its output, its running statistics and the input's gradient
    (through the autograd-aware all-reduce) equal one process's on the
    whole batch, f32 to 1e-5."""
    _spawn(_sync_bn_rank, tmp_path, str(tmp_path))
    _assert_bn_halves_equal_whole([torch.load(tmp_path / f"bn{r}.pt") for r in range(2)])


def _env_rank(rank, init_file, port, result_dir):
    """A rank started as ``torchrun`` starts one: its environment only."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from proben_tpu_torch.parallel import data_parallel_group

    mesh = data_parallel_group("cpu")
    try:
        got = all_mean(torch.tensor([float(rank), 10.0 * rank]), mesh)
        torch.save({"mesh": (mesh.rank, mesh.world, str(mesh.device)), "backend": dist.get_backend(),
                    "mean": got}, os.path.join(result_dir, f"env{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_data_parallel_group_from_torchruns_environment(tmp_path):
    """``data_parallel_group`` initialises the group from ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``:
    gloo on the CPU, each rank's place, and ``all_mean`` over the ranks;
    one process with no such environment is world 1."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    _spawn(_env_rank, tmp_path, port, str(tmp_path))
    for rank in range(2):
        got = torch.load(tmp_path / f"env{rank}.pt")
        assert got["mesh"] == (rank, 2, "cpu") and got["backend"] == "gloo"
        assert torch.equal(got["mean"], torch.tensor([0.5, 5.0]))
    assert data_parallel_group("cpu") == DataMesh(0, 1, torch.device("cpu"))


def _alone_rank(rank, init_file, root, out_dir, result_dir):
    """One of 2 gloo ranks of ``DefaultTrainer`` at ``IMS_PER_BATCH`` 3:
    its mesh, its loader's share, its steps and parameters, and, where it
    sits out, what ``evaluate`` returns."""
    _init(rank, init_file)
    try:
        _register(root)
        steps, params, trainer = _train(_cfg(out_dir, batch=3))
        mesh, loader = trainer.mesh, trainer.train_loader
        got = {"mesh": (mesh.rank, mesh.world, mesh.group is None), "sits_out": mesh.sits_out,
               "loader": None if loader is None else (loader.world, loader.rows),
               "steps": steps, "params": params}
        if mesh.sits_out:
            got["evaluate"] = trainer.evaluate()
        torch.save(got, os.path.join(result_dir, f"alone{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_a_world_that_does_not_divide_the_batch_raises(tmp_path):
    """Where the ranks do not divide ``IMS_PER_BATCH``, ``DefaultTrainer``
    trains on the most first ranks that do, as the JAX trainer shards over
    the largest number of devices that divides it, and raises nothing: 2
    gloo ranks at a batch of 3. Rank 0 trains alone (world 1, the default
    group, a loader of the whole batch) and does not wait on rank 1, which
    sits out (no loader, no step, ``evaluate`` returns {}). Rank 0's losses
    and parameters equal one process's (tolerances as above: other thread
    counts, other summation orders). ``dividing_group`` makes no process
    group for n = 1. A ``TrainLoader`` or ``shard_batch`` given a world
    that does not divide its batch still raises."""
    root = str(tmp_path / "tree")
    _write_tree(root)
    _register(root)
    cpu = torch.device("cpu")
    assert dividing_group(DataMesh(1, 4, cpu), 5) == DataMesh(1, 1, cpu)
    assert dividing_group(DataMesh(3, 4, cpu), 8) == DataMesh(3, 4, cpu)
    out = tmp_path / "alone"
    _spawn(_alone_rank, tmp_path, root, str(out), str(tmp_path))
    alone, idle = (torch.load(tmp_path / f"alone{r}.pt") for r in range(2))
    assert alone["mesh"] == (0, 1, True) and not alone["sits_out"] and alone["loader"] == (1, (0, 3))
    assert idle["mesh"] == (1, 1, True) and idle["sits_out"] and idle["loader"] is None
    assert idle["steps"] == [] and idle["evaluate"] == {}
    assert "rank 1 sits out" in (out / "log.txt.rank1").read_text()
    want_steps, want_params, _ = _train(_cfg(tmp_path / "one", batch=3))
    assert len(want_steps) == len(alone["steps"]) == 2
    for got, want in zip(alone["steps"], want_steps):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for k, want in want_params.items():
        np.testing.assert_allclose(alone["params"][k].numpy(), want.numpy(), rtol=0, atol=1e-6, err_msg=k)
    mapper = DatasetMapper(mapper_config_from_cfg(_cfg(tmp_path)), is_train=True, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        TrainLoader([{}] * 4, mapper, 3, num_workers=1, rank=0, world=2)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"image": torch.zeros(3, 2)}, 0, 2)


def test_a_rank_maps_its_rows_with_the_one_process_draws(tmp_path):
    """``DatasetMapper.map_batch(rows=...)`` maps only a rank's rows and
    advances its draws over the others' (crop on, so the skipped draws read
    each frame's size): the rows equal the one-process batch's, and the
    next batch is drawn alike. ``shard_batch`` takes the same rows of a
    collated batch."""
    from proben_tpu_torch.data import collate

    root = str(tmp_path / "tree")
    _write_tree(root)
    _register(root)
    dicts = DatasetCatalog.get(NAME)
    cfg = _cfg(tmp_path)
    cfg.INPUT.CROP.ENABLED = True
    mcfg = mapper_config_from_cfg(cfg)
    assert mcfg.crop is not None
    whole = DatasetMapper(mcfg, is_train=True, seed=3, device="cpu")
    want = [whole.map_batch(dicts), whole.map_batch(dicts)]
    for rank in range(2):
        mapper = DatasetMapper(mcfg, is_train=True, seed=3, device="cpu")
        rows = (2 * rank, 2 * rank + 2)
        for batch in want:
            got = mapper.map_batch(dicts, rows)
            assert len(got) == 2
            for a, b in zip(got, batch[rows[0]:rows[1]]):
                assert torch.equal(a["image"], b["image"])
                for k in ("image_size", "gt_boxes", "gt_classes", "gt_valid"):
                    np.testing.assert_array_equal(a[k], b[k])
                assert a["flip"] == b["flip"]
        sharded = shard_batch(collate(want[0]), rank, 2)
        assert torch.equal(sharded["image"], collate(want[0][rows[0]:rows[1]])["image"])
        assert sharded["file_name"] == [d["file_name"] for d in dicts[rows[0]:rows[1]]]
