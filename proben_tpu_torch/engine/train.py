"""Training step (counterpart of ``proben_tpu/engine/train.py``): the
loss-dict forward, the gradients, the SGD update and the two-layer NaN
guard of the JAX step.

``train_step`` updates the model's parameters in place and returns a new
``TrainState`` with the new momentum; the guard keeps, for every trainable
tensor, its old value wherever the update is not finite, and everywhere when
the total loss is not finite. The step counter advances either way, as in
JAX (whose ``TrainState.step`` and optimizer step always agree, so the port
keeps one counter).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..models.rcnn import RCNN, ModelConfig, rcnn_train_losses
from ..models.resnet import freeze_mask
from ..ops.sampling import Draws, GlobalBatchDraws
from ..parallel.mesh import DataMesh, all_mean
from ..solver.build import SolverConfig, build_optimizer, flat_cat, split_like
from ..utils import tracing

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    model: RCNN
    momentum: Dict[str, Tensor]  # per parameter name, frozen ones included
    step: int
    seed: int
    generator: torch.Generator  # reseeded from (seed, step) every step


def trainable_mask(model: RCNN, freeze_at: int, freeze_modules: Sequence[str] = ()) -> Dict[str, bool]:
    """Trainable flag per parameter name: the backbone (and the BGRTTT
    thermal ``backbone_2``) frozen at ``freeze_at``, every parameter of the
    top-level modules named in ``freeze_modules`` (``MODEL.FREEZE_MODULES``,
    e.g. KAIST's ``("backbone", "backbone_2", "roi")``) frozen, everything
    else trainable (JAX ``engine/defaults.py::build_trainable_mask``)."""
    mask = {name: True for name, _ in model.named_parameters()}
    for bb in ("backbone", "backbone_2"):
        if hasattr(model, bb):
            mask.update({f"{bb}.{k}": v for k, v in freeze_mask(getattr(model, bb), freeze_at).items()})
    for name in mask:
        if name.split(".", 1)[0] in freeze_modules:
            mask[name] = False
    return mask


def step_seed(seed: int, step: int) -> int:
    """The generator seed of one step (JAX folds the step into its key)."""
    return hash((seed, step)) & 0x7FFF_FFFF_FFFF_FFFF


def device_batch(batch: Mapping, device) -> Dict:
    """The step's inputs of a loader batch ("image", "image_size", "gt"),
    on ``device``."""
    gt = batch["gt"]
    return {"image": batch["image"].to(device), "image_size": batch["image_size"].to(device),
            "gt": type(gt)(gt.boxes.to(device), gt.classes.to(device), gt.valid.to(device))}


def losses_and_grads(
    model: RCNN, cfg: ModelConfig, batch: Mapping, generator: Draws
) -> Tuple[Dict[str, Tensor], Tensor, Dict[str, Tensor]]:
    """(losses, total loss, gradient per trainable parameter name) of one
    batch; ``batch`` holds "image" (N, H, W, C), "image_size" (N, 2) and
    "gt" (a batched ``GroundTruth``), all on the model's device. A trainable
    parameter the losses do not reach gets a zero gradient."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    with torch.enable_grad():
        losses = rcnn_train_losses(model, cfg, batch["image"], batch["image_size"], batch["gt"],
                                   generator)
        total = sum(losses.values())
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(total, [p for _, p in named], allow_unused=True)
    return (
        {k: v.detach() for k, v in losses.items()},
        total.detach(),
        {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, grads)},
    )


def _keep_finite(new: Mapping[str, Tensor], old: Mapping[str, Tensor], finite: Tensor):
    """``new`` where the total loss and the entry are finite, else ``old``,
    over all tensors at once."""
    n, o = flat_cat(new.values()), flat_cat(old.values())
    return split_like(torch.where(finite & torch.isfinite(n), n, o), old)


def _mean_over_ranks(losses, total, grads, mesh: Optional[DataMesh]):
    """(losses, total, grads), each averaged over the ranks of ``mesh`` in
    one all-reduce of their flat concatenation; unchanged at world 1."""
    if mesh is None or mesh.world == 1:
        return losses, total, grads
    with tracing.span("train.all_reduce"):
        parts = {**{f"loss/{k}": v.float() for k, v in losses.items()}, "total": total.float(),
                 **{f"grad/{k}": v for k, v in grads.items()}}
        mean = split_like(all_mean(flat_cat(parts.values()), mesh), parts)
        return ({k: mean[f"loss/{k}"].to(v.dtype) for k, v in losses.items()},
                mean["total"].to(total.dtype), {k: mean[f"grad/{k}"] for k in grads})


def make_train_step(
    model_cfg: ModelConfig,
    solver_cfg: SolverConfig,
    trainable_mask: Optional[Mapping[str, bool]] = None,
    mesh: Optional[DataMesh] = None,
) -> Tuple[Callable, Callable]:
    """Returns (init_state, train_step).

    ``init_state(model, seed)`` marks the trainable parameters
    (``requires_grad`` from ``trainable_mask``; default: all) and zeroes the
    momentum. ``train_step(state, batch) -> (state, metrics)``: ``batch`` as
    in ``losses_and_grads``; ``metrics`` holds every loss, ``total_loss``
    and ``loss_finite`` (1.0 or 0.0), as device tensors.

    Data parallel (``mesh``, a ``parallel.DataMesh`` of world > 1; None:
    one process): ``batch`` is this rank's equal share of the global batch
    (``parallel.shard_batch``), the random draws are the global batch's
    (``ops.sampling.GlobalBatchDraws``), and the gradients, the losses and
    the total loss are averaged over the mesh's ranks before the update, so
    every rank keeps or skips it together and applies the one-device step
    of the global batch (the losses are means over images: the mean of
    equal shards' means is the global mean).
    """
    optimizer = build_optimizer(solver_cfg, trainable_mask)

    def init_state(model: RCNN, seed: int) -> TrainState:
        for name, p in model.named_parameters():
            p.requires_grad_(optimizer.trainable(name))
        momentum = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        device = next(model.parameters()).device
        return TrainState(model, momentum, 0, seed, torch.Generator(device=device))

    def train_step(state: TrainState, batch: Mapping) -> Tuple[TrainState, Dict[str, Tensor]]:
        with tracing.span("train.step"):
            state.generator.manual_seed(step_seed(state.seed, state.step))
            draws = (state.generator if mesh is None or mesh.world == 1
                     else GlobalBatchDraws(state.generator, mesh.rank, mesh.world))
            losses, total, grads = losses_and_grads(state.model, model_cfg, batch, draws)
            losses, total, grads = _mean_over_ranks(losses, total, grads, mesh)
            with tracing.span("train.update"), torch.no_grad():
                params = dict(state.model.named_parameters())
                finite = torch.isfinite(total)
                new_params, new_momentum = optimizer.update(
                    grads, state.momentum, {n: p.detach() for n, p in params.items()}, state.step
                )
                names = list(new_params)
                with tracing.span("train.nan_guard"):
                    momentum = dict(state.momentum)
                    momentum.update(_keep_finite(new_momentum, {n: state.momentum[n] for n in names}, finite))
                    kept = _keep_finite(new_params, {n: params[n].detach() for n in names}, finite)
                torch._foreach_copy_([params[n] for n in names], [kept[n] for n in names])
            metrics = dict(losses)
            metrics["total_loss"] = total
            metrics["loss_finite"] = finite.to(torch.float32)
            return dataclasses.replace(state, momentum=momentum, step=state.step + 1), metrics

    return init_state, train_step
