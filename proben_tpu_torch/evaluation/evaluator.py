"""Dataset-level inference loop (counterpart of
``proben_tpu/evaluation/evaluator.py``): run a predictor over a loader, feed
an evaluator, report timing with the warm-up batches excluded."""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterable

logger = logging.getLogger(__name__)


def inference_on_dataset(
    predictor,
    loader: Iterable[Dict],
    evaluator,
    warmup: int = 1,
) -> Dict:
    """predictor: object with predict_batch(batch) -> list of per-image dicts
    with boxes/scores/classes/image_id. evaluator: FLIREvaluator-style
    (reset/process/evaluate). Returns ``evaluator.evaluate()``.

    After the first ``warmup`` batches, the host time of taking each batch
    from the loader (read, decode, resize), of ``predict_batch`` (which ends
    in a copy to the host, so the device work is done) and of ``process``
    are summed, and ``evaluate`` is timed; one INFO record on this module's
    logger carries them as a dict, its last argument (``record.args[-1]``):
    ``images``, ``load_s``, ``infer_s``, ``process_s``, ``evaluate_s``."""
    evaluator.reset()
    timing = {"images": 0, "load_s": 0.0, "infer_s": 0.0, "process_s": 0.0}
    n_batches = 0
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        t1 = time.perf_counter()
        results = predictor.predict_batch(batch)
        t2 = time.perf_counter()
        for rec in results:
            evaluator.process(rec["image_id"], rec["boxes"], rec["scores"], rec["classes"])
        t3 = time.perf_counter()
        n_batches += 1
        if n_batches > warmup:
            timing["images"] += len(results)
            timing["load_s"] += t1 - t0
            timing["infer_s"] += t2 - t1
            timing["process_s"] += t3 - t2
    t0 = time.perf_counter()
    results = evaluator.evaluate()
    timing["evaluate_s"] = time.perf_counter() - t0
    if timing["images"]:
        logger.info("inference timing (%d warm-up batches excluded): %s", warmup, timing)
    return results
