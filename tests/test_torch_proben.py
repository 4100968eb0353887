"""ProbEn late fusion of ``proben_tpu_torch.fusion`` against
``proben_tpu.fusion`` on the CPU.

``fuse_detections_torch`` (batched over images) is held against JAX's
``fuse_detections_jax`` (one image per call) on the random ensembles of
tests/test_proben_fusion.py, padded, in one batch of images whose valid
counts differ, for every (score, box) method. Tolerance: both compute in
f32 from the same inputs, the cluster sums in other orders; the keep set,
the clusters, the classes and the output order are exact (same count,
classes and valid mask), fused scores to rtol 1e-5 / atol 1e-6 and boxes
to rtol 1e-5 / atol 1e-4 px. The port's numpy copy must equal
``proben_tpu``'s bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu import fusion as jax_fusion
from proben_tpu_torch import fusion
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

SCORE_METHODS = ("probEn", "avg", "max")
BOX_METHODS = ("v-avg", "s-avg", "avg", "argmax")
METHODS = [(s, b) for s in SCORE_METHODS for b in BOX_METHODS]
PAD = 40
MODEL_SIZES = ((12, 9, 7), (5, 8, 3), (0, 4, 2), (0, 0, 0))  # per image, per model


def _random_model(rng, n, c=3, img=(640, 512)):
    """tests/test_proben_fusion.py's random detector output."""
    xy = rng.rand(n, 2) * np.array([img[0] - 100, img[1] - 100])
    wh = rng.rand(n, 2) * 80 + 20
    raw = rng.rand(n, c) + 0.1
    probs = raw / raw.sum(1, keepdims=True) * rng.uniform(0.7, 0.99, (n, 1))
    return {"boxes": np.concatenate([xy, xy + wh], 1), "scores": probs.max(1),
            "classes": probs.argmax(1), "probs": probs, "vars": rng.uniform(0.5, 2.0, n)}


def _ensembles(seed):
    """Per image, the models' detections."""
    rng = np.random.RandomState(seed)
    return [[_random_model(rng, n) for n in sizes] for sizes in MODEL_SIZES]


def _padded(models):
    """One image's detections concatenated over models, padded to PAD."""
    cat = {k: np.concatenate([m[k] for m in models]) for k in models[0]}
    n = len(cat["scores"])
    out = {"boxes": np.zeros((PAD, 4), np.float32), "scores": np.zeros(PAD, np.float32),
           "classes": np.zeros(PAD, np.int32), "probs": np.zeros((PAD, 3), np.float32),
           "vars": np.ones(PAD, np.float32), "valid": np.arange(PAD) < n}
    for k in cat:
        out[k][:n] = cat[k]
    return out


FIELDS = ("boxes", "scores", "classes", "probs", "vars", "valid")


@pytest.mark.parametrize("score_method,box_method", METHODS)
def test_torch_fusion_matches_jax(score_method, box_method):
    images = [_padded(models) for models in _ensembles(METHODS.index((score_method, box_method)))]
    batch = [torch.from_numpy(np.stack([im[k] for im in images])) for k in FIELDS]
    got = fusion.fuse_detections_torch(*batch, score_method=score_method, box_method=box_method,
                                       topk=PAD)
    assert [tuple(t.shape) for t in got] == [(4, PAD, 4), (4, PAD), (4, PAD), (4, PAD)]
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.bool
    counts = []
    for i, im in enumerate(images):
        want = [np.asarray(t) for t in jax_fusion.fuse_detections_jax(
            *[jnp.asarray(im[k]) for k in FIELDS], score_method=score_method,
            box_method=box_method, topk=PAD)]
        gb, gs, gc, gv = (t[i].numpy() for t in got)
        np.testing.assert_array_equal(gv, want[3])
        np.testing.assert_array_equal(gc, want[2])
        np.testing.assert_allclose(gs, want[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gb, want[0], rtol=1e-5, atol=1e-4)
        counts.append(int(gv.sum()))
    assert counts[0] > counts[1] > counts[2] > 0 == counts[3]


@pytest.mark.parametrize("score_method,box_method", METHODS)
def test_numpy_copy_equals_jax_package(score_method, box_method):
    """``fuse_multi_model`` (the (max, argmax) plain NMS included) and
    ``fuse_detections`` of the port's copy against ``proben_tpu.fusion``,
    bit for bit, and the copy's ``fuse_detections`` against the batched
    torch function on the same valid detections (numpy tolerance of
    tests/test_proben_fusion.py: scores rtol 2e-4 / atol 2e-5, boxes rtol
    2e-4 / atol 2e-3 px)."""
    ensembles = _ensembles(100 + METHODS.index((score_method, box_method)))
    for models in ensembles:
        for a, b in zip(fusion.fuse_multi_model(models, score_method, box_method),
                        jax_fusion.fuse_multi_model(models, score_method, box_method)):
            np.testing.assert_array_equal(a, b)
    im = _padded(ensembles[0])
    v = im["valid"]
    args = [im[k][v] for k in ("boxes", "scores", "classes", "probs", "vars")]
    want = jax_fusion.fuse_detections(*args, score_method, box_method)
    got = fusion.fuse_detections(*args, score_method, box_method)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    tb, ts, tc, tv = (t[0].numpy() for t in fusion.fuse_detections_torch(
        *[torch.from_numpy(im[k][None]) for k in FIELDS], score_method=score_method,
        box_method=box_method, topk=PAD))
    m = int(tv.sum())
    assert m == len(got[1])
    np.testing.assert_array_equal(tc[:m], got[2])
    np.testing.assert_allclose(ts[:m], got[1], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tb[:m], got[0], rtol=2e-4, atol=2e-3)


def test_bayesian_score_fusion_equals_jax_package():
    p = np.array([[0.05, 0.05, 0.8], [0.05, 0.05, 0.8], [0.7, 0.1, 0.1]])
    for rows in (p[:1], p[:2], p[1:]):
        assert fusion.bayesian_score_fusion(rows) == jax_fusion.bayesian_score_fusion(rows)


def test_dispatch_zero_and_one_model():
    """No detections anywhere -> empty; one model with detections -> its
    detections unchanged, no re-clustering."""
    empty = {"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "classes": np.zeros(0),
             "probs": np.zeros((0, 3)), "vars": np.zeros(0)}
    m = _random_model(np.random.RandomState(0), 5)
    b, s, c = fusion.fuse_multi_model([empty, empty], "probEn", "v-avg")
    assert b.shape == (0, 4) and len(s) == len(c) == 0
    b, s, c = fusion.fuse_multi_model([empty, m], "probEn", "v-avg")
    np.testing.assert_array_equal(b, m["boxes"].astype(np.float32))
    np.testing.assert_array_equal(s, m["scores"].astype(np.float32))
    np.testing.assert_array_equal(c, m["classes"])


def test_identical_boxes_fuse_to_one():
    """Two models agreeing on one object: one fused box, a boosted score,
    the inverse-variance average (weights 1 and 1/4), in both the numpy
    copy and the torch function."""
    box = np.array([[100.0, 100.0, 200.0, 200.0]])
    m1 = {"boxes": box, "scores": np.array([0.9]), "classes": np.array([1]),
          "probs": np.array([[0.05, 0.9, 0.05]]), "vars": np.array([1.0])}
    m2 = {"boxes": box + 2.0, "scores": np.array([0.8]), "classes": np.array([1]),
          "probs": np.array([[0.1, 0.8, 0.1]]), "vars": np.array([4.0])}
    b, s, c = fusion.fuse_multi_model([m1, m2], "probEn", "v-avg")
    assert len(b) == 1 and c[0] == 1 and s[0] > 0.9
    np.testing.assert_allclose(b[0], box[0] + 2.0 * 0.2, rtol=1e-5)
    t = lambda k, dt: torch.tensor(np.concatenate([m1[k], m2[k]])[None], dtype=dt)  # noqa: E731
    tb, ts, tc, tv = fusion.fuse_detections_torch(
        t("boxes", torch.float32), t("scores", torch.float32), t("classes", torch.int32),
        t("probs", torch.float32), t("vars", torch.float32), torch.ones(1, 2, dtype=torch.bool))
    assert tv.tolist() == [[True, False]] and int(tc[0, 0]) == 1
    np.testing.assert_allclose(float(ts[0, 0]), s[0], rtol=1e-6)
    np.testing.assert_allclose(tb[0, 0].numpy(), b[0], rtol=1e-6)


def test_torch_fusion_rejects_unknown_methods():
    z = torch.zeros(1, 2)
    args = (torch.zeros(1, 2, 4), z, z.int(), torch.zeros(1, 2, 3), None, z.bool())
    for kw in ({"score_method": "mean"}, {"box_method": "median"}, {"box_method": "v-avg"}):
        with pytest.raises(ValueError):
            fusion.fuse_detections_torch(*args, **kw)
