"""Inference of middle fusion (BGRTTT, two R50-FPNs) against ``proben_tpu`` on the CPU in f32:
preprocess, features, proposals, detections and ``Predictor``. Setup,
calibration and tolerances: ``tests/torch_fusion_common.py``. One file per
mode, so that each mode's JAX compile runs on its own worker."""

import pytest

from torch_fusion_common import (  # noqa: F401  (the tests, collected here)
    infer_run_for,
    test_preprocess_matches_jax,
    test_features_are_the_streams_concatenated,
    test_proposals_match_jax,
    test_detections_match_jax,
    test_predictor_takes_fused_batches,
)
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)


@pytest.fixture(scope="module", params=["BGRTTT"])
def infer_run(request):
    return infer_run_for(request.param)
