"""Test loader and batch collation (counterpart of the test path of
``proben_tpu/data/loader.py``). The training loader comes with the trainer."""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from ..structures.detections import GroundTruth
from .dataset_mapper import DatasetMapper


def collate(samples: Sequence[Dict]) -> Dict:
    """Stack mapped samples into one batch dict: image, image_size and the
    GT as tensors on the samples' device; orig_size numpy; image_id and
    file_name lists."""
    dev = samples[0]["image"].device

    def stacked(key):
        return torch.from_numpy(np.stack([s[key] for s in samples])).to(dev)

    return {
        "image": torch.stack([s["image"] for s in samples]),
        "image_size": stacked("image_size"),
        "gt": GroundTruth(boxes=stacked("gt_boxes"), classes=stacked("gt_classes"),
                          valid=stacked("gt_valid")),
        "image_id": [s["image_id"] for s in samples],
        "orig_size": np.stack([s["orig_size"] for s in samples]),
        "file_name": [s["file_name"] for s in samples],
    }


def build_test_loader(
    dataset_dicts: List[dict],
    mapper: DatasetMapper,
    batch_size: int = 1,
    shard: int = 0,
    num_shards: int = 1,
) -> Iterator[Dict]:
    """Sequential eval loader (reference ``InferenceSampler``: exact split,
    each sample exactly once). The final short batch is padded by repeating
    the last sample; consumers use the first ``batch['num_real']`` entries."""
    shard_dicts = dataset_dicts[shard::num_shards]
    for i in range(0, len(shard_dicts), batch_size):
        chunk = shard_dicts[i : i + batch_size]
        real = len(chunk)
        while len(chunk) < batch_size:
            chunk = chunk + [chunk[-1]]
        batch = collate(mapper.map_batch(chunk))
        batch["num_real"] = real
        yield batch
