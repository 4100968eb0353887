"""Result assertions and reporting (counterpart of
``proben_tpu/evaluation/testing.py``; reference
``detectron2/evaluation/testing.py:9,27``)."""

from __future__ import annotations

import logging
import pprint
from typing import Dict

logger = logging.getLogger(__name__)


def print_csv_format(results: Dict):
    """Print metrics in the reference's copy-paste-friendly format."""
    for task, metrics in results.items():
        if not isinstance(metrics, dict):
            continue
        important = [k for k in metrics if "-" not in k]
        logger.info("copypaste: Task: %s", task)
        logger.info("copypaste: %s", ",".join(important))
        logger.info(
            "copypaste: %s",
            ",".join(f"{metrics[k]:.4f}" for k in important),
        )


def verify_results(cfg, results: Dict) -> bool:
    """Check results against cfg.TEST.EXPECTED_RESULTS entries
    [task, metric, value, tolerance]. Returns ok; logs failures."""
    expected = cfg.TEST.EXPECTED_RESULTS
    if not expected:
        return True
    ok = True
    for task, metric, expected_value, tolerance in expected:
        actual = results.get(task, {}).get(metric)
        if actual is None or actual != actual:
            ok = False
            logger.error("verify_results: %s/%s missing or NaN", task, metric)
            continue
        if abs(actual - expected_value) > tolerance:
            ok = False
            logger.error(
                "verify_results FAIL: %s/%s = %.4f, expected %.4f +/- %.4f",
                task, metric, actual, expected_value, tolerance,
            )
        else:
            logger.info(
                "verify_results ok: %s/%s = %.4f (expected %.4f +/- %.4f)",
                task, metric, actual, expected_value, tolerance,
            )
    if not ok:
        logger.error("result verification failed!\n%s", pprint.pformat(results))
    return ok
