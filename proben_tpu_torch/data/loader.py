"""Data loaders (counterpart of ``proben_tpu/data/loader.py``; reference
``detectron2/data/build.py:255,342`` and ``samplers/distributed_sampler.py``):
the infinite training stream with threaded prefetch, and the sequential
test loader.

Batches hold tensors on the mapper's device with static shapes. On the card
each training worker thread maps on its own CUDA stream with its own nvJPEG
codec (``DatasetMapper`` keeps one per thread), so decoding never waits for
the training step's kernels on the consumer's stream; a batch is handed over
with an event that the consumer's stream waits on, and its tensors are
marked as used on that stream (``record_stream``) so the caching allocator
does not hand their memory back to the worker before the step has read it.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from ..parallel.mesh import shard_batch
from ..structures.detections import GroundTruth
from .dataset_mapper import DatasetMapper


def collate(samples: Sequence[Dict]) -> Dict:
    """Stack mapped samples into one batch dict: image, image_size and the
    GT as tensors on the samples' device; orig_size numpy; image_id and
    file_name lists; for training samples "flip", numpy."""
    dev = samples[0]["image"].device

    def stacked(key):
        return torch.from_numpy(np.stack([s[key] for s in samples])).to(dev)

    batch = {
        "image": torch.stack([s["image"] for s in samples]),
        "image_size": stacked("image_size"),
        "gt": GroundTruth(boxes=stacked("gt_boxes"), classes=stacked("gt_classes"),
                          valid=stacked("gt_valid")),
        "image_id": [s["image_id"] for s in samples],
        "orig_size": np.stack([s["orig_size"] for s in samples]),
        "file_name": [s["file_name"] for s in samples],
    }
    if "flip" in samples[0]:  # training samples
        batch["flip"] = np.array([s["flip"] for s in samples])
    return batch


def training_index_stream(
    n: int, seed: int = 0, shard: int = 0, num_shards: int = 1, shuffle: bool = True
) -> Iterator[int]:
    """Infinite epoch-less index stream, strided per shard
    (reference ``TrainingSampler``)."""
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        yield from order[shard::num_shards]


class TrainLoader:
    """Infinite training loader with threaded prefetch: ``num_workers``
    threads take the next ``batch_size`` indices of ``training_index_stream``
    under a lock, map them with ``mapper.map_batch`` (one ``image_io``
    launch per batch on the card) and queue the collated batch, at most
    ``prefetch`` ahead. With one worker the batches and the mapper's random
    draws follow the stream's order exactly, as in the JAX package; with
    more, batches may arrive out of order and their draws interleave (as in
    JAX). Each batch carries its dataset ``indices``. ``batches_mapped``
    counts the batches the workers have mapped, prefetched ones included. A
    worker's exception is raised by the ``next`` call that would have
    returned its batch. The loader owns the mapper: ``close`` stops the
    workers and closes it.

    Data parallel (``world`` > 1): every rank walks the same index stream
    in global batches of ``batch_size`` and maps only its equal share, rows
    ``rank * batch_size / world`` on, with the mapper's draws advanced over
    the other ranks' rows (``DatasetMapper.map_batch``'s ``rows``); a batch
    holds the rank's rows and their ``indices``."""

    def __init__(
        self,
        dataset_dicts: List[dict],
        mapper: DatasetMapper,
        batch_size: int,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 4,
        rank: int = 0,
        world: int = 1,
    ):
        if batch_size % world:
            raise ValueError(f"TrainLoader: a global batch of {batch_size} does not split over "
                             f"{world} ranks")
        self.dataset_dicts = dataset_dicts
        self.mapper = mapper
        self.batch_size = batch_size
        per = batch_size // world
        self.rank, self.world = rank, world
        self.rows = (rank * per, (rank + 1) * per)  # this rank's rows of each global batch
        self.device = mapper.device
        self._indices = training_index_stream(len(dataset_dicts), seed)
        self._lock = threading.Lock()
        self.batches_mapped = 0
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(1, num_workers))]
        for t in self._threads:
            t.start()

    def _next_batch_indices(self) -> List[int]:
        with self._lock:
            return [int(next(self._indices)) for _ in range(self.batch_size)]

    def _map(self, idxs: List[int], stream) -> Dict:
        batch = collate(self.mapper.map_batch([self.dataset_dicts[i] for i in idxs], self.rows))
        with self._lock:
            self.batches_mapped += 1
        batch["indices"] = shard_batch(idxs, self.rank, self.world)
        if stream is not None:
            batch["_ready"] = stream.record_event()
        return batch

    def _worker(self):
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        while not self._stop.is_set():
            try:
                idxs = self._next_batch_indices()
                if stream is None:
                    item = self._map(idxs, None)
                else:
                    with torch.cuda.device(self.device), torch.cuda.stream(stream):
                        item = self._map(idxs, stream)
            except Exception as e:  # handed to the consumer, which raises it
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        ready = item.pop("_ready", None)
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            gt = item["gt"]
            for t in (item["image"], item["image_size"], gt.boxes, gt.classes, gt.valid):
                t.record_stream(consumer)
        return item

    def close(self, timeout: float = 60.0):
        """Stop and join the workers, then close the mapper (its nvJPEG
        codecs); raises if a worker is still mapping after ``timeout`` s."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        if any(t.is_alive() for t in self._threads):
            raise RuntimeError(f"TrainLoader.close: a worker still runs after {timeout} s")
        self.mapper.close()


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
