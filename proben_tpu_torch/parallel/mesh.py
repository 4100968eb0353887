"""Data parallelism over ``torch.distributed`` (counterpart of
``proben_tpu/parallel/mesh.py``; reference ``engine/launch.py`` and
``utils/comm.py``).

The JAX package runs one SPMD program over a device mesh: the batch axis is
sharded, the parameters are replicated and XLA inserts the gradient
all-reduce. The port runs one process per rank (``torchrun``, or any caller
that initialises the default process group) and makes the same step by hand:
every rank takes its equal share of the global batch (``shard_batch``),
starts from rank 0's parameters (``replicate``), and the training step
averages the flat gradient, the loss and the metrics over the ranks in one
all-reduce (``all_mean``), so every rank applies the one-device update of
the global batch. The backend is NCCL when each rank has a card of its own
and gloo when ranks share a card or run on the CPU (NCCL refuses two ranks
on one device). One process with no group is world 1, and nothing here
communicates. A trainer whose global batch the ranks do not divide trains on
the first ranks that do (``dividing_group``, JAX: the mesh spans the largest
number of devices that divides the batch); the other ranks sit out.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in the data-parallel group: its rank, the
    number of ranks and its device, and the process group of those ranks
    (None: the default group). ``all_mean``, ``broadcast_from_first`` and
    ``replicate`` take the mesh, so the group and its size travel together;
    ``models.batch_norm.sync_batch_norm`` takes its ``group``. A rank at or
    past ``world`` is not in the group (``sits_out``)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None

    @property
    def sits_out(self) -> bool:
        return self.rank >= self.world


def _rank_device(device: torch.device, local_rank: int) -> torch.device:
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def data_parallel_group(device: Union[str, torch.device] = "cuda") -> DataMesh:
    """The data-parallel group of this process (JAX ``data_parallel_mesh``).
    An initialised default group is used as it is; otherwise one is
    initialised from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) when ``WORLD_SIZE`` > 1:
    NCCL when every local rank has its own card, else gloo. Each rank's
    device is ``cuda:LOCAL_RANK`` (modulo the cards; the rank where
    ``LOCAL_RANK`` is unset), or the CPU. Without either: world 1 on
    ``device``."""
    device = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized():
        if world <= 1:
            return DataMesh(0, 1, device)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        own_cards = device.type == "cuda" and local_world <= torch.cuda.device_count()
        dist.init_process_group("nccl" if own_cards else "gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    return DataMesh(rank, world, _rank_device(device, local_rank))


def dividing_group(mesh: DataMesh, batch_size: int) -> DataMesh:
    """The ranks that share a global batch of ``batch_size``: ranks 0 to
    n - 1 of ``mesh``, n the largest number up to ``mesh.world`` that
    divides ``batch_size`` (JAX ``engine/defaults.py``: the mesh spans
    ``devices[:n_dp]``). Returns this rank's mesh of world n: with a new
    process group of those ranks when 1 < n < ``mesh.world``, which every
    rank of ``mesh`` must therefore call, in the same order
    (``torch.distributed.new_group``); a rank at or past n ``sits_out``."""
    n = max(d for d in range(1, mesh.world + 1) if batch_size % d == 0)
    group = dist.new_group(list(range(n))) if 1 < n < mesh.world else mesh.group
    return DataMesh(mesh.rank, n, mesh.device, group)


def shard_batch(batch, rank: int, world: int):
    """This rank's rows of a global batch: the ``rank``-th of ``world``
    equal slices of the leading axis of every tensor and array, and of every
    list, in dicts, tuples and dataclasses (``GroundTruth``). The batch must
    divide evenly."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world) for k, v in batch.items()}
    if dataclasses.is_dataclass(batch) and not isinstance(batch, type):
        return type(batch)(*(shard_batch(getattr(batch, f.name), rank, world)
                             for f in dataclasses.fields(batch)))
    if isinstance(batch, tuple):
        return tuple(shard_batch(v, rank, world) for v in batch)
    if isinstance(batch, (torch.Tensor, np.ndarray, list)):
        n = len(batch)
        if n % world:
            raise ValueError(f"shard_batch: a batch of {n} does not split over {world} ranks")
        per = n // world
        return batch[rank * per:(rank + 1) * per]
    return batch


def broadcast_from_first(tensors: Iterable[torch.Tensor], mesh: DataMesh) -> None:
    """Overwrite ``tensors`` on every rank of ``mesh`` with its rank 0's, in
    place, over ``mesh.group``; nothing at world 1 or on a rank that sits
    out."""
    if mesh.world == 1 or mesh.sits_out:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0, group=mesh.group)


def replicate(model: torch.nn.Module, mesh: DataMesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank of ``mesh`` (JAX
    ``replicate``: the parameters' sharding is replicated); returns
    ``model``."""
    broadcast_from_first(list(model.parameters()) + list(model.buffers()), mesh)
    return model


def all_mean(flat: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The mean over the ranks of ``mesh`` of a 1-D tensor: one all-reduce
    of the sum over ``mesh.group``, then a division by ``mesh.world``;
    ``flat`` itself at world 1."""
    if mesh.world == 1:
        return flat
    flat = flat.contiguous()
    dist.all_reduce(flat, group=mesh.group)
    return flat / mesh.world
