"""ResNet + FPN of ``proben_tpu_torch`` against ``proben_tpu`` on the CPU in
f32: the same parameters (the port's numpy init, in the JAX pytree layout,
with random non-identity affines so that every residual branch reaches the
maps) through ``extract_features`` of both packages, p2..p6 compared.

Tolerance: the same f32 convolutions through 50 layers, accumulated in
different orders by XLA and by PyTorch's CPU kernels; relative differences
stay at the 1e-6 level per layer, so maps agree to rtol 1e-4 with atol
1e-4 of the map's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.models import build_config as jax_build_config
from proben_tpu.models import init_rcnn as jax_init_rcnn
from proben_tpu.models import rcnn as jax_rcnn
from proben_tpu.models.anchors import multilevel_anchors as jax_multilevel_anchors
from proben_tpu_torch.models import build_config, build_model, init_rcnn, random_affines
from proben_tpu_torch.models import rcnn as t_rcnn
from proben_tpu_torch.models.anchors import multilevel_anchors
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

H, W = 128, 160


@pytest.fixture(scope="module")
def feats():
    cfg = build_config(depth=50, num_classes=3)
    params = random_affines(init_rcnn(0, cfg), 0)
    rng = np.random.RandomState(0)
    images = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)

    jcfg = jax_build_config(depth=50, num_classes=3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = jax.jit(
        lambda p, im: jax_rcnn.extract_features(p, jcfg, jax_rcnn.preprocess(jcfg, im))
    )(jparams, jnp.asarray(images))

    model = build_model(cfg, params=params, device="cpu")
    with torch.inference_mode():
        got = t_rcnn.extract_features(model, cfg, t_rcnn.preprocess(cfg, torch.from_numpy(images)))
    return params, jcfg, want, got


@pytest.mark.parametrize("level", ["p2", "p3", "p4", "p5", "p6"])
def test_fpn_level_matches_jax(feats, level):
    _, _, want, got = feats
    w = np.asarray(want[level])
    g = t_rcnn.nhwc(got[level]).numpy()
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_init_tree_matches_jax_layout(feats):
    """The port's random init has exactly the JAX pytree's structure and
    leaf shapes, so a JAX checkpoint and the port's init load the same way."""
    params, jcfg, _, _ = feats
    shapes = jax.eval_shape(lambda k: jax_init_rcnn(k, jcfg), jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda s: s.shape, shapes)
    got = jax.tree_util.tree_map(lambda a: a.shape, params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert jax.tree_util.tree_leaves(got) == jax.tree_util.tree_leaves(want)


def test_anchors_match_jax():
    shapes = [(32, 40), (16, 20), (8, 10), (4, 5), (2, 3)]
    args = (shapes, (4, 8, 16, 32, 64), t_rcnn.ANCHOR_SIZES, t_rcnn.ANCHOR_ASPECT_RATIOS)
    for g, w in zip(multilevel_anchors(*args), jax_multilevel_anchors(*args)):
        np.testing.assert_array_equal(g, np.asarray(w))
