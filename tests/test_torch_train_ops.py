"""The training ops of ``proben_tpu_torch`` against ``proben_tpu`` on the
CPU: the matcher, the samplers (invariants: the two packages draw different
random numbers), the box delta encoding, the RPN and Fast R-CNN losses, the
RoI proposal sampling, the LR schedules and one SGD update.

Inputs come from numpy seeds and go to both packages. The losses and the
proposal sampling are compared under identity sampling (a sample size that
takes every eligible row), where the random draws only reorder the sampled
rows. Tolerances are stated per test; most results are bit-for-bit (integer
labels and indices) or f32 sums in another order (rtol 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proben_tpu.ops import box_transform as jax_bt
from proben_tpu.ops.matcher import match as jax_match
from proben_tpu.models import fast_rcnn as jax_frcnn
from proben_tpu.models import roi_heads as jax_roi
from proben_tpu.models import rpn as jax_rpn
from proben_tpu.solver import build as jax_solver
from proben_tpu.structures.detections import GroundTruth as JaxGroundTruth
from proben_tpu_torch.models import fast_rcnn, roi_heads, rpn
from proben_tpu_torch.ops import box_transform
from proben_tpu_torch.ops.matcher import match
from proben_tpu_torch.ops.sampling import sample_topk_indices, subsample_labels
from proben_tpu_torch.solver import build as solver
from proben_tpu_torch.structures import GroundTruth
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)


def _boxes(rng, shape, lo=0.0, span=100.0, size=(4.0, 40.0)):
    xy = rng.rand(*shape, 2) * span + lo
    wh = rng.rand(*shape, 2) * (size[1] - size[0]) + size[0]
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# matcher, deltas, ground truth
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("low_quality", [True, False])
def test_match_matches_jax(low_quality):
    """Exact: indices and int8 labels. Qualities are multiples of 0.1, so
    many ties (first-occurrence argmax) and ties at a gt's best quality
    (forced matches) occur; invalid gt rows carry the highest qualities and
    must never win; one image has no valid gt."""
    rng = np.random.RandomState(0)
    q = (rng.randint(0, 10, (3, 6, 50)) / 10.0).astype(np.float32)
    valid = rng.rand(3, 6) > 0.3
    valid[2] = False
    q[0, ~valid[0]] = 0.95
    thresholds, labels = ([0.3, 0.7], [0, -1, 1]) if low_quality else ([0.5], [0, 1])
    idx, lab = match(torch.from_numpy(q), torch.from_numpy(valid), thresholds, labels, low_quality)
    for i in range(3):
        jidx, jlab = jax_match(jnp.asarray(q[i]), jnp.asarray(valid[i]), thresholds, labels,
                               low_quality)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(lab[i].numpy(), np.asarray(jlab))
    assert (lab[2] == labels[0]).all()
    assert valid[0][idx[0].numpy()].all()


def test_match_without_gt_rows():
    idx, lab = match(torch.zeros(2, 0, 7), torch.zeros(2, 0, dtype=torch.bool), [0.5], [0, 1])
    jidx, jlab = jax_match(jnp.zeros((0, 7)), jnp.zeros((0,), bool), [0.5], [0, 1])
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(lab[1].numpy(), np.asarray(jlab))


def test_get_deltas_matches_jax():
    """Same f32 arithmetic in the same order (rtol 1e-6), including the
    guards for zero-width and negative-height boxes."""
    rng = np.random.RandomState(1)
    src, tgt = _boxes(rng, (64,)), _boxes(rng, (64,))
    src[0, 2] = src[0, 0]  # zero width
    src[1, 3] = src[1, 1] - 3.0  # negative height
    tgt[2, 2] = tgt[2, 0]
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        got = box_transform.get_deltas(torch.from_numpy(src), torch.from_numpy(tgt), w).numpy()
        want = np.asarray(jax_bt.get_deltas(jnp.asarray(src), jnp.asarray(tgt), w))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ground_truth_from_numpy_matches_jax():
    rng = np.random.RandomState(2)
    boxes, classes = _boxes(rng, (5,)), rng.randint(0, 3, 5)
    for cap in (3, 8):
        got = GroundTruth.from_numpy(boxes, classes, cap)
        want = JaxGroundTruth.from_numpy(boxes, classes, cap)
        for f in ("boxes", "classes", "valid"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


# ---------------------------------------------------------------------------
# samplers: invariants
# ---------------------------------------------------------------------------


def _labels(seed, n=300):
    rng = np.random.RandomState(seed)
    lab = rng.choice([-1, 0, 1], size=(4, n), p=[0.2, 0.6, 0.2])
    lab[1, :] = np.where(lab[1] == 1, 0, lab[1])  # no positives
    lab[2, :] = np.where(lab[2] == 0, -1, lab[2])  # no negatives
    lab[3, 5:] = -1  # fewer eligible rows than samples
    return torch.from_numpy(lab)


@pytest.mark.parametrize("num_samples,fraction", [(64, 0.25), (256, 0.5)])
def test_sample_topk_indices_invariants(num_samples, fraction):
    labels = _labels(3)
    idx, is_pos, valid = sample_topk_indices(labels, num_samples, fraction, _gen(0))
    assert idx.shape == is_pos.shape == valid.shape == (4, num_samples)
    for i in range(4):
        lab = labels[i]
        n_pos = min(int((lab == 1).sum()), int(num_samples * fraction))
        n_neg = min(int((lab == 0).sum()), num_samples - n_pos)
        v = valid[i]
        assert int(is_pos[i].sum()) == n_pos and int(v.sum()) == n_pos + n_neg
        # positives first, then negatives, then padding pointing at row 0
        assert is_pos[i][:n_pos].all() and not is_pos[i][n_pos:].any()
        assert v[:n_pos + n_neg].all() and not v[n_pos + n_neg:].any()
        assert (idx[i][~v] == 0).all()
        chosen = idx[i][v]
        assert len(set(chosen.tolist())) == len(chosen)
        assert (lab[chosen[:n_pos]] == 1).all() and (lab[chosen[n_pos:]] == 0).all()
    again = sample_topk_indices(labels, num_samples, fraction, _gen(0))
    other = sample_topk_indices(labels, num_samples, fraction, _gen(1))
    assert torch.equal(again[0], idx) and not torch.equal(other[0], idx)


@pytest.mark.parametrize("num_samples,fraction", [(64, 0.25), (256, 0.5)])
def test_subsample_labels_invariants(num_samples, fraction):
    labels = _labels(4)
    out = subsample_labels(labels, num_samples, fraction, _gen(0))
    assert out.dtype == torch.int32 and out.shape == labels.shape
    for i in range(4):
        lab = labels[i]
        n_pos = min(int((lab == 1).sum()), int(num_samples * fraction))
        n_neg = min(int((lab == 0).sum()), num_samples - n_pos)
        assert int((out[i] == 1).sum()) == n_pos and int((out[i] == 0).sum()) == n_neg
        kept = out[i] >= 0
        assert torch.equal(out[i][kept].long(), lab[kept])


def test_sampling_is_uniform_over_eligible_rows():
    """Each of 40 positives is drawn with probability 8/40 = 0.2; over 400
    draws every count lies within 6 standard deviations (~0.12) of 0.2."""
    lab = torch.full((400, 100), -1)
    lab[:, 10:50] = 1
    idx, is_pos, _ = sample_topk_indices(lab, 16, 0.5, _gen(5))
    counts = torch.zeros(100)
    counts.index_add_(0, idx[is_pos], torch.ones(int(is_pos.sum())))
    freq = counts[10:50] / 400
    assert int(is_pos.sum()) == 400 * 8 and (counts[:10] == 0).all()
    assert ((freq - 0.2).abs() < 0.12).all()


# ---------------------------------------------------------------------------
# losses and proposal sampling under identity sampling
# ---------------------------------------------------------------------------


LEVELS = [(8, 10), (4, 5)]  # (H, W) of two small RPN levels, A = 3


def _rpn_inputs(seed):
    rng = np.random.RandomState(seed)
    b, g = 2, 5
    logits = [rng.randn(b, h * w * 3).astype(np.float32) for h, w in LEVELS]
    deltas = [(0.3 * rng.randn(b, h * w, 12)).astype(np.float32) for h, w in LEVELS]
    anchors = [_boxes(rng, (h * w * 3,), span=60.0, size=(6.0, 30.0)) for h, w in LEVELS]
    gt = _boxes(rng, (b, g), span=60.0, size=(6.0, 30.0))
    gt[0, 1] = anchors[0][7] + 0.5  # a near-exact anchor match
    valid = np.ones((b, g), bool)
    valid[0, 3:] = False
    valid[1, :] = [True, False, True, True, False]
    return logits, deltas, anchors, gt, valid


@pytest.mark.parametrize("beta", [0.0, 0.1])
def test_rpn_losses_match_jax(beta):
    """Identity sampling (batch size = all anchors): both packages sum the
    same per-anchor terms; f32 sums in another order (rtol 1e-5)."""
    logits, deltas, anchors, gt, valid = _rpn_inputs(5)
    n = sum(a.shape[0] for a in anchors)
    jcfg = jax_rpn.RPNConfig(batch_size_per_image=n, smooth_l1_beta=beta, loss_weight=0.7)
    cfg = rpn.RPNConfig(batch_size_per_image=n, smooth_l1_beta=beta, loss_weight=0.7)
    got = rpn.rpn_losses([torch.from_numpy(x) for x in logits], [torch.from_numpy(x) for x in deltas],
                         [torch.from_numpy(x) for x in anchors], torch.from_numpy(gt),
                         torch.from_numpy(valid), _gen(0), cfg)
    for i in range(2):
        want = jax_rpn.rpn_losses([jnp.asarray(x[i]) for x in logits], [jnp.asarray(x[i]) for x in deltas],
                                  [jnp.asarray(a) for a in anchors], jnp.asarray(gt[i]),
                                  jnp.asarray(valid[i]), jax.random.PRNGKey(0), jcfg)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k][i]), float(v), rtol=1e-5, err_msg=k)
    assert float(got["loss_rpn_loc"].min()) > 0


def test_rpn_losses_sampled_counts():
    """With the default 256 samples the BCE sums exactly the sampled rows:
    recomputed from the labels, the sum over all anchors with the sampled
    mask equals the loss times the normalizer."""
    logits, deltas, anchors, gt, valid = _rpn_inputs(6)
    cfg = rpn.RPNConfig(batch_size_per_image=64)
    args = ([torch.from_numpy(x) for x in logits], [torch.from_numpy(x) for x in deltas],
            [torch.from_numpy(x) for x in anchors], torch.from_numpy(gt), torch.from_numpy(valid))
    a = rpn.rpn_losses(*args, _gen(3), cfg)
    b = rpn.rpn_losses(*args, _gen(3), cfg)
    c = rpn.rpn_losses(*args, _gen(4), cfg)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["loss_rpn_cls"], c["loss_rpn_cls"])
    assert torch.isfinite(a["loss_rpn_cls"]).all() and (a["loss_rpn_cls"] > 0).all()


def _canonical_rows(*cols):
    """Rows of the concatenated columns, sorted lexicographically."""
    m = np.concatenate([np.asarray(c, np.float64).reshape(len(c), -1) for c in cols], 1)
    return m[np.lexsort(m.T[::-1])]


def test_label_and_sample_proposals_matches_jax():
    """Identity sampling (batch size = proposals + gt, positive fraction
    0.5): the same rows are sampled in another order, so the valid rows are
    compared as sets; exact (they are copies of the inputs)."""
    rng = np.random.RandomState(7)
    b, p, g = 2, 40, 4
    props = _boxes(rng, (b, p), span=60.0, size=(6.0, 30.0))
    gt = _boxes(rng, (b, g), span=60.0, size=(6.0, 30.0))
    props[:, :g] = gt + rng.randn(b, g, 4).astype(np.float32)  # foreground proposals
    pvalid = rng.rand(b, p) > 0.2
    gvalid = np.array([[True, True, True, False], [False, False, False, False]])
    classes = rng.randint(0, 3, (b, g)).astype(np.int32)
    cfg = roi_heads.ROIHeadsConfig(num_classes=3, batch_size_per_image=p + g, positive_fraction=0.5)
    jcfg = jax_roi.ROIHeadsConfig(num_classes=3, batch_size_per_image=p + g, positive_fraction=0.5)
    got = roi_heads.label_and_sample_proposals(
        torch.from_numpy(props), torch.from_numpy(pvalid),
        GroundTruth(torch.from_numpy(gt), torch.from_numpy(classes), torch.from_numpy(gvalid)),
        _gen(0), cfg)
    got = [t.numpy() for t in got]
    for i in range(b):
        want = jax_roi.label_and_sample_proposals(
            jnp.asarray(props[i]), jnp.asarray(pvalid[i]),
            JaxGroundTruth(jnp.asarray(gt[i]), jnp.asarray(classes[i]), jnp.asarray(gvalid[i])),
            jax.random.PRNGKey(0), jcfg)
        want = [np.asarray(t) for t in want]
        vg, vw = got[3][i], want[3]
        assert vg.sum() == vw.sum() == pvalid[i].sum() + gvalid[i].sum()
        # gt boxes of background rows are irrelevant (masked in the losses)
        fg_g, fg_w = got[4][i][vg], want[4][vw]
        np.testing.assert_array_equal(
            _canonical_rows(got[0][i][vg], got[1][i][vg], got[2][i][vg] * fg_g[:, None], fg_g),
            _canonical_rows(want[0][vw], want[1][vw], want[2][vw] * fg_w[:, None], fg_w))
        assert (got[1][i][~vg] == 3).all()
    assert got[4][0].sum() >= 3 and got[4][1].sum() == 0


@pytest.mark.parametrize("gnll,agnostic", [(False, False), (True, False), (False, True)])
def test_fast_rcnn_losses_match_jax(gnll, agnostic):
    """Softmax CE, smooth-L1 and the Gaussian NLL of the variance head, per
    image; f32 sums in another order (rtol 1e-5)."""
    rng = np.random.RandomState(8)
    b, s, c = 2, 48, 3
    logits = (2 * rng.randn(b, s, c + 1)).astype(np.float32)
    deltas = rng.randn(b, s, 4 if agnostic else 4 * c).astype(np.float32)
    variance = np.exp(rng.randn(b, s, 1)).astype(np.float32)
    variance[0, 0] = 1e-9  # below the eps clamp
    props = _boxes(rng, (b, s))
    gtb = props + rng.randn(b, s, 4).astype(np.float32)
    cls = rng.randint(0, c + 1, (b, s)).astype(np.int32)
    sv = rng.rand(b, s) > 0.2
    cls[0, 0] = 1
    sv[0, 0] = True
    kw = dict(num_classes=c, enable_gaussian_nll=gnll, cls_agnostic_bbox_reg=agnostic,
              smooth_l1_beta=0.5)
    got = fast_rcnn.fast_rcnn_losses(*map(torch.from_numpy, (logits, deltas, variance, props, cls, sv, gtb)),
                                     fast_rcnn.FastRCNNConfig(**kw))
    assert set(got) == {"loss_cls", "loss_box_reg"} | ({"gaussian_loss"} if gnll else set())
    for i in range(b):
        want = jax_frcnn.fast_rcnn_losses(*(jnp.asarray(a[i]) for a in (logits, deltas, variance, props, cls, sv, gtb)),
                                          jax_frcnn.FastRCNNConfig(**kw))
        assert set(want) == set(got)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k][i]), float(v), rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["WarmupMultiStepLR", "WarmupCosineLR"])
@pytest.mark.parametrize("method", ["linear", "constant"])
def test_lr_schedule_matches_jax(name, method):
    """At the warmup edge and around both milestones; JAX computes in f32,
    the port in f64: rtol 1e-6, and atol 5e-9 (two f32 ulps of the base lr)
    where the cosine's 1 + cos(pi t / T) cancels near the end."""
    kw = dict(lr_scheduler_name=name, warmup_method=method, warmup_iters=100, steps=(300, 600),
              max_iter=900, base_lr=0.02, gamma=0.1)
    got = solver.build_lr_schedule(solver.SolverConfig(**kw))
    want = jax_solver.build_lr_schedule(jax_solver.SolverConfig(**kw))
    for step in (0, 1, 50, 99, 100, 101, 299, 300, 301, 599, 600, 899):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))), rtol=1e-6,
                                   atol=5e-9, err_msg=f"step {step}")


_TREE = {"conv": (3, 3, 4, 8), "norm": (8,), "lin": (16, 5), "frozen": (6, 4)}


def _named_tree(rng, scale=1.0):
    """The same tensors as a JAX pytree and as port names."""
    jt, named = {}, {}
    for mod, shape in _TREE.items():
        leaves = ({"scale": shape, "bias": shape} if mod == "norm"
                  else {"w": shape, "b": (shape[-1],)})
        jt[mod] = {}
        for k, sh in leaves.items():
            a = (scale * rng.randn(*sh)).astype(np.float32)
            jt[mod][k] = a
            named[f"{mod}.{ {'w': 'weight', 'b': 'bias'}.get(k, k) }"] = torch.from_numpy(a)
    return jt, named


def _jax_name(name):
    mod, leaf = name.split(".")
    return mod, {"weight": "w"}.get(leaf, "b" if (leaf == "bias" and mod != "norm") else leaf)


@pytest.mark.parametrize("clip", [None, "value", "norm"])
def test_optimizer_update_matches_jax(clip):
    """Two SGD updates (steps 0 and 37, warmup still on) with a frozen
    module, the bias lr factor and bias weight decay, and each clip type;
    parameters and momentum to rtol 1e-6 (f32 elementwise; the lr is f32
    in JAX and f64 in the port)."""
    rng = np.random.RandomState(9)
    kw = dict(base_lr=0.05, momentum=0.9, weight_decay=1e-3, weight_decay_bias=0.0,
              bias_lr_factor=2.0, warmup_iters=100, clip_gradients=clip is not None,
              clip_type=clip or "value", clip_value=0.5)
    jparams, params = _named_tree(rng)
    mask_j = {k: jax.tree_util.tree_map(lambda _: k != "frozen", v) for k, v in jparams.items()}
    mask = {n: not n.startswith("frozen") for n in params}
    tx = jax_solver.build_optimizer(jax_solver.SolverConfig(**kw), jparams, mask_j)
    opt = solver.build_optimizer(solver.SolverConfig(**kw), mask)
    jstate = tx.init(jparams)
    momentum = {n: torch.zeros_like(p) for n, p in params.items()}
    for step in (0, 37):
        jgrads, grads = _named_tree(rng, scale=0.7)
        jstate = dict(jstate, step=jnp.int32(step))
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, jgrads), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), jparams, upd)
        new_p, new_v = opt.update(grads, momentum, params, step)
        assert set(new_p) == {n for n in params if mask[n]}
        params = {**params, **new_p}
        momentum = {**momentum, **new_v}
        for n in params:
            mod, leaf = _jax_name(n)
            np.testing.assert_allclose(params[n].numpy(), jparams[mod][leaf], rtol=1e-6, atol=1e-7,
                                       err_msg=n)
            np.testing.assert_allclose(momentum[n].numpy(), np.asarray(jstate["momentum"][mod][leaf]),
                                       rtol=1e-6, atol=1e-7, err_msg=n)
    assert (momentum["frozen.weight"] == 0).all()


def test_is_bias_name_matches_jax_paths():
    for name, want in (("a.bias", True), ("a.norm1.scale", True), ("a.weight", False)):
        assert solver.is_bias_name(name) is want
    assert dataclasses.asdict(solver.SolverConfig()) == dataclasses.asdict(jax_solver.SolverConfig())
