"""Samplers (counterpart of ``proben_tpu/data/samplers.py``; reference
``detectron2/data/samplers/distributed_sampler.py``).

``training_index_stream`` (in loader.py) is the TrainingSampler equivalent;
here: RepeatFactorTrainingSampler (:57, LVIS class rebalancing)."""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterator, Sequence

import numpy as np


def repeat_factors_from_category_frequency(
    dataset_dicts: Sequence[dict], repeat_thresh: float
) -> np.ndarray:
    """Per-image repeat factor r(I) = max over categories in I of
    max(1, sqrt(t / f(c))) where f(c) is the fraction of images containing c."""
    counts: Dict[int, int] = defaultdict(int)
    for d in dataset_dicts:
        cats = {a["category_id"] for a in d.get("annotations", [])}
        for c in cats:
            counts[c] += 1
    n = len(dataset_dicts)
    freq = {c: v / n for c, v in counts.items()}
    rep = {c: max(1.0, math.sqrt(repeat_thresh / f)) for c, f in freq.items()}
    out = np.ones(n)
    for i, d in enumerate(dataset_dicts):
        cats = {a["category_id"] for a in d.get("annotations", [])}
        if cats:
            out[i] = max(rep[c] for c in cats)
    return out


def repeat_factor_index_stream(
    repeat_factors: np.ndarray,
    seed: int = 0,
    shard: int = 0,
    num_shards: int = 1,
) -> Iterator[int]:
    """Infinite stream with stochastic fractional repeats
    (reference RepeatFactorTrainingSampler._get_epoch_indices)."""
    rng = np.random.RandomState(seed)
    base = np.floor(repeat_factors).astype(np.int64)
    frac = repeat_factors - base
    while True:
        rounded = base + (rng.rand(len(repeat_factors)) < frac).astype(np.int64)
        indices = np.repeat(np.arange(len(repeat_factors)), rounded)
        rng.shuffle(indices)
        yield from indices[shard::num_shards]
