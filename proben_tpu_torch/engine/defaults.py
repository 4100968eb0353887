"""DefaultTrainer: config-driven training orchestration (counterpart of
``proben_tpu/engine/defaults.py``; reference ``engine/defaults.py:201`` +
``train_loop.py:16-246``).

One process is one device: the model is built on ``device`` (default
CUDA; raises without a GPU) and the whole ``SOLVER.IMS_PER_BATCH`` batch
runs there in every step (a batch that does not fit raises). Data parallel
(``parallel.data_parallel_group``: ``torchrun``, or a default process group
the caller initialised) every rank runs on its own device
(``cuda:LOCAL_RANK``) with its equal share of each global batch, and the
step averages the gradients over the ranks, so the update is the one-device
step of the global batch (JAX: one SPMD program over the mesh). As in JAX,
the ranks that train are the first n, n the largest number of ranks that
divides ``IMS_PER_BATCH`` (``parallel.dividing_group``; a process group of
their own when n is not all of them); a rank past them maps no rows, takes
no step and returns from ``train`` at once. Only rank 0 writes checkpoints,
``metrics.json`` and the evaluation; the training ranks meet at a barrier
after each. Hooks around the loop (timer, lr, writers, periodic checkpoint,
PreciseBN, eval) in the JAX package's order; ``torch.save`` checkpoints
under ``OUTPUT_DIR/checkpoints`` with resume; detectron2 checkpoint loading
from ``MODEL.WEIGHTS``.

The parameters start from the port's own init (``init_rcnn(SEED)``, numpy
draws, not JAX's threefry) unless ``params`` (a numpy pytree in
``proben_tpu``'s layout) is given. On resume the index stream and the
mapper's draws restart from ``SEED``, as in the JAX package: parameters,
momentum, step and seed are restored, consumed batches are not skipped.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import weakref
from typing import Dict, List, Optional, Union

import torch
import torch.distributed as dist

from ..checkpoint import (
    CheckpointManager,
    import_detectron2_checkpoint,
    load_train_state,
    state_dict_to_jax,
    train_state_tree,
)
from ..config import mapper_config_from_cfg, model_config_from_cfg, solver_config_from_cfg
from ..data import DatasetCatalog, DatasetMapper, TrainLoader, build_test_loader
from ..models import RCNN, build_model, init_rcnn
from ..parallel import broadcast_from_first, data_parallel_group, dividing_group, replicate
from ..solver.build import build_lr_schedule
from ..utils.events import CommonMetricPrinter, EventStorage, JSONWriter, TensorboardWriter
from ..utils.logger import setup_logger
from .hooks import (
    EvalHook,
    HookBase,
    IterationTimer,
    LRLogger,
    PeriodicCheckpointer,
    PeriodicWriter,
    PreciseBNHook,
)
from .predictor import Predictor
from .train import TrainState, device_batch, make_train_step, trainable_mask

logger = logging.getLogger(__name__)

Device = Union[str, torch.device]


class DefaultTrainer:
    def __init__(self, cfg, train_loader=None, params=None, device: Device = "cuda"):
        # every rank takes part in the group's creation, the ranks that sit out too
        self.mesh = dividing_group(data_parallel_group(device), cfg.SOLVER.IMS_PER_BATCH)
        setup_logger(cfg.OUTPUT_DIR, distributed_rank=self.mesh.rank)
        self.cfg = cfg
        self.device = self.mesh.device
        self.model_cfg = model_config_from_cfg(cfg)
        self.solver_cfg = solver_config_from_cfg(cfg)
        self.mapper_cfg = mapper_config_from_cfg(cfg)

        seed = cfg.SEED if cfg.SEED >= 0 else 0
        if params is None:
            params = init_rcnn(seed, self.model_cfg)
            if cfg.MODEL.WEIGHTS:
                logger.info("loading weights from %s", cfg.MODEL.WEIGHTS)
                params = import_detectron2_checkpoint(cfg.MODEL.WEIGHTS, params, strict=False)
        self.model: RCNN = replicate(
            build_model(self.model_cfg, params=params, device=self.device).train(), self.mesh)
        init_state, self._train_step = make_train_step(
            self.model_cfg, self.solver_cfg, self.build_trainable_mask(self.model), self.mesh)
        self.state: TrainState = init_state(self.model, seed)

        self.train_loader = train_loader
        if train_loader is None and not self.mesh.sits_out:
            self.train_loader = self.build_train_loader(cfg, self.device, self.mesh.rank, self.mesh.world)
        self.checkpointer = CheckpointManager(
            os.path.join(cfg.OUTPUT_DIR, "checkpoints"),
            higher_is_better=True,
        )
        self.start_iter = 0
        self.max_iter = cfg.SOLVER.MAX_ITER
        self.iter = 0
        self.storage: Optional[EventStorage] = None
        self._hooks: List[HookBase] = []
        self.register_hooks(self.build_hooks())

    # -- construction helpers ------------------------------------------------

    def build_trainable_mask(self, model: RCNN) -> Dict[str, bool]:
        """``MODEL.BACKBONE.FREEZE_AT`` on the backbone(s), then every
        parameter of ``MODEL.FREEZE_MODULES`` (KAIST-style freezes)."""
        return trainable_mask(model, self.cfg.MODEL.BACKBONE.FREEZE_AT,
                              tuple(self.cfg.MODEL.get("FREEZE_MODULES", ())))

    @classmethod
    def build_train_loader(cls, cfg, device: Device = "cuda", rank: int = 0,
                           world: int = 1) -> TrainLoader:
        """The ``IMS_PER_BATCH`` stream, of which this loader maps rank
        ``rank``'s share of ``world``."""
        dicts = []
        for name in cfg.DATASETS.TRAIN:
            dicts.extend(DatasetCatalog.get(name))
        mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=True, seed=max(cfg.SEED, 0),
                               device=device)
        return TrainLoader(
            dicts,
            mapper,
            batch_size=cfg.SOLVER.IMS_PER_BATCH,
            seed=max(cfg.SEED, 0),
            num_workers=cfg.DATALOADER.NUM_WORKERS,
            rank=rank,
            world=world,
        )

    def build_hooks(self) -> List[HookBase]:
        out_dir = self.cfg.OUTPUT_DIR
        hooks = [IterationTimer(), LRLogger(build_lr_schedule(self.solver_cfg))]
        if self.mesh.rank == 0:
            writers = [
                CommonMetricPrinter(self.max_iter),
                JSONWriter(os.path.join(out_dir, "metrics.json")),
                TensorboardWriter(out_dir),
            ]
            hooks.append(PeriodicWriter(writers, period=20))
        hooks.append(PeriodicCheckpointer(self.cfg.SOLVER.CHECKPOINT_PERIOD))
        if self.cfg.TEST.PRECISE_BN.ENABLED:
            # reference hook list order: PreciseBN runs before EvalHook
            # (engine/defaults.py:300-342). No shipped model has live BN
            # statistics (FrozenBN), so the hook disables itself.
            hooks.append(
                PreciseBNHook(
                    # EVAL_PERIOD=0 -> hook fires only at the final iteration
                    self.cfg.TEST.EVAL_PERIOD,
                    self.train_loader,
                    getattr(self, "bn_stats_fn", None),
                    getattr(self, "bn_apply_fn", None),
                    num_iters=self.cfg.TEST.PRECISE_BN.NUM_ITER,
                )
            )
        if self.cfg.TEST.EVAL_PERIOD > 0 and self.cfg.DATASETS.TEST:
            hooks.append(EvalHook(self.cfg.TEST.EVAL_PERIOD, lambda t: t.evaluate()))
        return hooks

    def register_hooks(self, hooks: List[HookBase]):
        for h in hooks:
            h.trainer = weakref.proxy(self)
        self._hooks.extend(hooks)

    # -- state access ---------------------------------------------------------

    @property
    def params(self) -> Dict:
        """The current parameters as a numpy pytree in ``proben_tpu``'s
        layout: what ``CheckpointManager.save_best`` writes and
        ``apps.flir.load_params`` reads back. A copy on the host, also on
        the CPU, so later steps do not change it."""
        return state_dict_to_jax({k: v.detach().to("cpu", copy=True)
                                  for k, v in self.model.state_dict().items()})

    # -- checkpointing ---------------------------------------------------------

    def _barrier(self):
        if self.mesh.world > 1 and not self.mesh.sits_out:
            dist.barrier(group=self.mesh.group)

    def save_checkpoint(self):
        if self.mesh.rank == 0:
            self.checkpointer.save(self.iter, train_state_tree(self.state))
        self._barrier()

    def resume_or_load(self, resume: bool = True):
        """Resume from the latest checkpoint under ``OUTPUT_DIR``; then,
        data parallel, every training rank takes rank 0's parameters,
        momentum and step. Nothing on a rank that sits out."""
        if self.mesh.sits_out:
            return
        if resume:
            restored = self.checkpointer.restore_latest(train_state_tree(self.state))
            if restored is not None:
                self.state = load_train_state(restored, self.state)
                self.start_iter = int(self.checkpointer.latest_step()) + 1
                logger.info("resumed from iter %d", self.start_iter)
        if self.mesh.world > 1:
            steps = torch.tensor([self.start_iter, self.state.step], device=self.device)
            broadcast_from_first([*self.model.parameters(), *self.state.momentum.values(), steps],
                                 self.mesh)
            self.start_iter, step = (int(v) for v in steps.tolist())
            self.state = dataclasses.replace(self.state, step=step)

    # -- the loop ---------------------------------------------------------------

    def run_step(self):
        batch = device_batch(next(self.train_loader), self.device)
        self.state, metrics = self._train_step(self.state, batch)
        self._last_metrics = metrics

    def _write_metrics(self):
        # the step's one host sync: every metric in one copy
        names = list(self._last_metrics)
        values = torch.stack([self._last_metrics[k].float() for k in names]).tolist()
        for k, v in zip(names, values):
            self.storage.put_scalar(k, v)

    def train(self) -> TrainState:
        if self.mesh.sits_out:
            logger.info("rank %d sits out: the first %d ranks divide IMS_PER_BATCH %d and train",
                        self.mesh.rank, self.mesh.world, self.cfg.SOLVER.IMS_PER_BATCH)
            return self.state
        logger.info("starting training from iter %d to %d", self.start_iter, self.max_iter)
        self.model.train()
        with EventStorage(self.start_iter) as self.storage:
            try:
                for h in self._hooks:
                    h.before_train()
                for self.iter in range(self.start_iter, self.max_iter):
                    self.storage.iter = self.iter
                    for h in self._hooks:
                        h.before_step()
                    self.run_step()
                    self._write_metrics()
                    for h in self._hooks:
                        h.after_step()
            finally:
                for h in self._hooks:
                    h.after_train()
                if hasattr(self.train_loader, "close"):
                    self.train_loader.close()
        self._barrier()
        return self.state

    # -- evaluation ---------------------------------------------------------------

    def evaluate(self) -> Dict:
        """``test`` of the live model (no second copy of the weights); the
        model is back in training mode afterwards, its ``requires_grad``
        flags untouched. Data parallel: rank 0 evaluates, the others return
        {}, and the training ranks meet at a barrier."""
        if self.mesh.sits_out:
            return {}
        try:
            if self.mesh.rank == 0:
                return self.test(self.cfg, self.model, device=self.device)
            return {}
        finally:
            self.model.train()
            self._barrier()

    @classmethod
    def test(cls, cfg, params, evaluators: Optional[Dict] = None, device: Device = "cuda") -> Dict:
        """Evaluate ``DATASETS.TEST`` through ``build_evaluator`` (or
        ``evaluators[name]``) and ``inference_on_dataset``, batch 1 as in the
        JAX package. ``params``: a built ``RCNN`` (used as it is, put in eval
        mode) or a numpy pytree (a model is built on ``device``)."""
        from ..evaluation import build_evaluator, inference_on_dataset

        model_cfg = model_config_from_cfg(cfg)
        model = params if isinstance(params, RCNN) else build_model(model_cfg, params=params,
                                                                     device=device)
        predictor = Predictor(model, model_cfg, device)
        results = {}
        for name in cfg.DATASETS.TEST:
            dicts = DatasetCatalog.get(name)
            if evaluators and name in evaluators:
                evaluator = evaluators[name]
            else:
                # dispatch on the dataset's evaluator_type (reference
                # build_evaluator pattern); defaults to the FLIR evaluator
                evaluator = build_evaluator(name, output_dir=cfg.OUTPUT_DIR)
            mapper = DatasetMapper(mapper_config_from_cfg(cfg), is_train=False, device=device)
            try:
                loader = build_test_loader(dicts, mapper, batch_size=1)
                results[name] = inference_on_dataset(predictor, loader, evaluator)
            finally:
                mapper.close()
        return results if len(results) > 1 else next(iter(results.values()), {})
