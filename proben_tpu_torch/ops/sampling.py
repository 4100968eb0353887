"""Balanced positive/negative sampling with static shapes (counterpart of
``proben_tpu/ops/sampling.py``), batched over leading dimensions.

Up to ``num_samples * positive_fraction`` positives are drawn uniformly at
random and the rest filled with negatives. The random priorities come from
an explicit ``torch.Generator`` (JAX draws other numbers from its keys, so
only the distribution is shared); the bounded top-k over
``where(mask, rand, -1.0)`` breaks ties toward the lower index
(``ops/topk.py``), as ``lax.top_k`` does.

A data-parallel training step passes a ``GlobalBatchDraws`` in place of the
generator: each draw is made for the global batch of ``world`` equal shards
and the rank keeps its own rows, so every rank samples what the one-device
step samples for those images.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from .topk import topk_stable


@dataclasses.dataclass(frozen=True)
class GlobalBatchDraws:
    """The draws of a data-parallel rank: ``generator`` draws the
    priorities of the whole global batch, of which the leading axis of
    every ``labels`` here is the ``rank``-th of ``world`` equal shards, and
    the rank keeps its own rows."""

    generator: torch.Generator
    rank: int
    world: int


Draws = Union[torch.Generator, GlobalBatchDraws]


def _counts(labels: torch.Tensor, num_samples: int, positive_fraction: float):
    pos_mask = labels == 1
    neg_mask = labels == 0
    num_pos = torch.clamp(pos_mask.sum(-1, keepdim=True), max=int(num_samples * positive_fraction))
    num_neg = torch.minimum(neg_mask.sum(-1, keepdim=True), num_samples - num_pos)
    return pos_mask, neg_mask, num_pos, num_neg


def _priorities(labels: torch.Tensor, draws: Draws) -> torch.Tensor:
    if isinstance(draws, torch.Generator):
        return torch.rand(labels.shape, generator=draws, device=labels.device)
    b = labels.shape[0]
    rand = torch.rand((draws.world * b,) + tuple(labels.shape[1:]), generator=draws.generator,
                      device=labels.device)
    return rand[draws.rank * b:(draws.rank + 1) * b]


def _pick_random_subset(mask, rand, k: int, limit) -> torch.Tensor:
    """Keep-mask of ``limit`` (per row, <= k) uniformly random True entries."""
    vals, idx = topk_stable(torch.where(mask, rand, -1.0), k)
    sel = (torch.arange(k, device=mask.device) < limit) & (vals >= 0.0)
    return torch.zeros_like(mask).scatter(-1, idx, sel)


def subsample_labels(
    labels: torch.Tensor,  # (..., N) int; 1 = positive, 0 = negative, -1 = ignore
    num_samples: int,
    positive_fraction: float,
    generator: Draws,
) -> torch.Tensor:
    """``labels`` with every entry not sampled set to -1 (int32)."""
    pos_mask, neg_mask, num_pos, num_neg = _counts(labels, num_samples, positive_fraction)
    k = min(num_samples, labels.shape[-1])
    keep_pos = _pick_random_subset(pos_mask, _priorities(labels, generator), k, num_pos)
    keep_neg = _pick_random_subset(neg_mask, _priorities(labels, generator), k, num_neg)
    out = torch.where(keep_pos, 1, torch.where(keep_neg, 0, -1))
    return out.to(torch.int32)


def sample_topk_indices(
    labels: torch.Tensor,  # (..., N) int; 1 = positive, 0 = negative, -1 = ignore
    num_samples: int,
    positive_fraction: float,
    generator: Draws,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A fixed-size sampled index set, positives first: (idx (..., S) int64
    with unused slots 0, sampled_is_pos (..., S), sampled_valid (..., S)),
    S = ``num_samples``. One priority vector orders both classes: their
    supports are disjoint, so the two orders are independent."""
    n = labels.shape[-1]
    pos_mask, neg_mask, num_pos, num_neg = _counts(labels, num_samples, positive_fraction)
    rand = _priorities(labels, generator)
    k = min(num_samples, n)
    # the positives never need more than the positive-fraction cap
    kp = max(1, min(int(num_samples * positive_fraction), k))
    _, pidx = topk_stable(torch.where(pos_mask, rand, -1.0), kp)
    _, nidx = topk_stable(torch.where(neg_mask, rand, -1.0), k)

    j = torch.arange(num_samples, device=labels.device)
    take_pos = j < num_pos
    from_pos = torch.gather(pidx, -1, torch.clamp(j, max=kp - 1).expand(pidx.shape[:-1] + (-1,)))
    from_neg = torch.gather(nidx, -1, torch.clamp(j - num_pos, 0, k - 1))
    idx = torch.where(take_pos, from_pos, from_neg)
    sampled_valid = j < num_pos + num_neg
    idx = torch.where(sampled_valid, idx, 0)
    return idx, take_pos & sampled_valid, sampled_valid
