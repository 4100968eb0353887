"""Batch normalization variants (counterpart of
``proben_tpu/models/batch_norm.py``; reference
``detectron2/layers/batch_norm.py``).

* FrozenBN (:14) is a folded affine -- see ``layers.Affine``/``fold_batchnorm``.
* ``sync_batch_norm``: NaiveSyncBatchNorm (:163). With a process group the
  mean and the mean of squares are averaged over its ranks by an
  autograd-aware all-reduce (JAX: ``lax.pmean`` over the data-mesh axis),
  so the statistics are the global batch's.
* ``precise_bn_stats`` recomputes running statistics over N batches
  (the PreciseBN hook, reference ``engine/hooks.py:358``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor


def init_batch_norm(channels: int, device=None) -> Dict[str, Tensor]:
    return {
        "weight": torch.ones(channels, device=device),
        "bias": torch.zeros(channels, device=device),
        "running_mean": torch.zeros(channels, device=device),
        "running_var": torch.ones(channels, device=device),
    }


def sync_batch_norm(
    x: Tensor,  # (N, H, W, C)
    params: Dict[str, Tensor],
    training: bool = True,
    group: Optional[object] = None,
    momentum: float = 0.1,
    eps: float = 1e-5,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Returns (normalized x, updated params). ``group`` (a process group,
    e.g. ``torch.distributed.group.WORLD``; the JAX ``axis_name``): the
    statistics are averaged over its ranks (SyncBN; equal shards give the
    global batch's); without it, per-device statistics (plain BN)."""
    if training:
        mean = torch.mean(x, dim=(0, 1, 2))
        meansqr = torch.mean(x * x, dim=(0, 1, 2))
        if group is not None:
            from torch.distributed.nn.functional import all_reduce

            if not torch.distributed.is_initialized():
                raise RuntimeError("sync_batch_norm: a group needs an initialised process group "
                                   "(torch.distributed.init_process_group)")
            world = torch.distributed.get_world_size(group)
            stats = all_reduce(torch.stack([mean, meansqr]), group=group) / world
            mean, meansqr = stats[0], stats[1]
        var = meansqr - mean * mean
        new_params = dict(params)
        new_params["running_mean"] = (1 - momentum) * params["running_mean"] + momentum * mean
        new_params["running_var"] = (1 - momentum) * params["running_var"] + momentum * var
    else:
        mean, var = params["running_mean"], params["running_var"]
        new_params = params
    inv = torch.rsqrt(var + eps) * params["weight"]
    out = x * inv.to(x.dtype) + (params["bias"] - mean * inv).to(x.dtype)
    return out, new_params


def precise_bn_stats(stats_list: Sequence[Tuple[Tensor, Tensor]]) -> Tuple[Tensor, Tensor]:
    """Average per-batch (mean, var) pairs into precise running statistics
    (the PreciseBN recomputation)."""
    means = torch.stack([torch.as_tensor(m) for m, _ in stats_list])
    vars_ = torch.stack([torch.as_tensor(v) for _, v in stats_list])
    mean = torch.mean(means, dim=0)
    # law of total variance across batches
    var = torch.mean(vars_, dim=0) + torch.mean(means * means, dim=0) - mean * mean
    return mean, var
