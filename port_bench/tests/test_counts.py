"""The benchmark's FLOP and byte counts: the conv and linear rule against
``torch.utils.flop_counter.FlopCounterMode`` over the reference at a small
size (forward, and forward plus the backward the freeze leaves), and each
kernel's bytes and operations against a hand count of one small call."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import cells, counts
from reference import model as ref
import tiny

fpn = cells.load_module(tiny.BENCH / "arch" / "faster_rcnn_fpn.py")

pytestmark = pytest.mark.card_free

CANVAS = (64, 96)  # the tiny configuration's pad_shape


def _net(fmt):
    conf = tiny.tiny_config("t", "float32", fmt)
    cfg = ref.Config(conf["model"], conf["solver"])
    sd = fpn.make_state_dict(conf["model"], conf["weights"], 3, "cpu")
    return conf, cfg, ref.Net(cfg, ref.params_from_d2(cfg, sd, "cpu"))


def _conv_linear_flops(mode: FlopCounterMode) -> int:
    ops = mode.get_flop_counts()["Global"]
    return sum(v for op, v in ops.items() if "convolution" in str(op) or "addmm" in str(op)
               or str(op).startswith("aten.mm"))


def _pool_stub(rois):
    """RoIAlign without matmuls: the pooled rows depend on the maps through
    elementwise work only, so the counter sees the conv and linear layers
    alone and the box head's input still carries a gradient."""
    def pool(levels, boxes, strides, p, ratio, min_level=2):
        c = levels[0].shape[0]
        return levels[0][:, :p, :p].unsqueeze(0).expand(boxes.shape[0], c, p, p) * 1.0
    return pool


@pytest.mark.parametrize("fmt", ("BGR", "BGRTTT"))
def test_forward_flops_match_the_flop_counter(fmt, monkeypatch):
    conf, cfg, net = _net(fmt)
    monkeypatch.setattr(ref, "multilevel_roi_align", _pool_stub(None))
    images = torch.randint(0, 255, (1,) + CANVAS + (6 if fmt == "BGRTTT" else 3,), dtype=torch.uint8)
    rois = torch.tensor([[4.0, 4.0, 40.0, 30.0]] * conf["model"]["rpn"]["post_nms_topk_test"])
    with FlopCounterMode(display=False) as mode, torch.no_grad():
        feats = net.features(images)
        net.rpn_head(feats)
        net.box_head(feats, 0, rois)
    assert _conv_linear_flops(mode) == fpn.flops_per_image(conf, False)


@pytest.mark.parametrize("fmt", ("BGR", "BGRTTT"))
def test_training_flops_match_the_flop_counter(fmt, monkeypatch):
    conf, cfg, net = _net(fmt)
    monkeypatch.setattr(ref, "multilevel_roi_align", _pool_stub(None))
    for name, p in net.params.items():
        p.requires_grad_(ref.trainable(cfg, name))
    images = torch.randint(0, 255, (1,) + CANVAS + (6 if fmt == "BGRTTT" else 3,), dtype=torch.uint8)
    rois = torch.tensor([[4.0, 4.0, 40.0, 30.0]] * conf["model"]["roi"]["batch_size_per_image"])
    with FlopCounterMode(display=False) as mode:
        feats = net.features(images, training=True)
        logits, deltas = net.rpn_head(feats)
        cls, dl = net.box_head(feats, 0, rois)
        loss = sum(x.sum() for x in logits + deltas) + cls.sum() + dl.sum()
        loss.backward()
    assert _conv_linear_flops(mode) == fpn.flops_per_image(conf, True)


def test_stem_counts_by_hand():
    x = torch.zeros(2, 16, 20, 3, dtype=torch.bfloat16)
    w = torch.zeros(7, 7, 3, 64, dtype=torch.bfloat16)
    s = b = torch.zeros(64, dtype=torch.bfloat16)
    out = torch.zeros(2, 4, 5, 64, dtype=torch.bfloat16)
    flops, nbytes = fpn.stem_counts(x, w, s, b, out)
    assert flops == 2 * 2 * 8 * 10 * 64 * 49 * 3
    assert nbytes == 2 * (2 * 16 * 20 * 3 + 7 * 7 * 3 * 64 + 64 + 64 + 2 * 4 * 5 * 64)


def _windows(r, p, wy_rows, wx_cols):
    """One level's window inputs with the given nonzero rows/columns."""
    wy = torch.zeros(r, p, 56)
    wx = torch.zeros(r, p, 64)
    for i in range(r):
        for k, y in enumerate(wy_rows[i]):
            wy[i, k % p, y] = 0.5
        for k, x in enumerate(wx_cols[i]):
            wx[i, k % p, x] = 0.5
    z = torch.zeros(r, dtype=torch.int32)
    return z, z.clone(), z.clone(), wy, wx


def test_roi_align_counts_by_hand():
    c, p = 8, 2
    feat = torch.zeros(1, 10, 12, c, dtype=torch.bfloat16)
    # two RoIs of one image: rows {0, 1} x cols {0, 1, 2}, rows {1, 2} x cols {2}
    lvl, y0, x0, wy, wx = _windows(2, p, [[0, 1], [1, 2]], [[0, 1, 2], [2]])
    out = torch.zeros(2, p, p, c, dtype=torch.bfloat16)
    flops, nbytes = fpn.roi_align_fwd_counts([feat], lvl, y0, x0, wy, wx, 2, out)
    # distinct pixels: (0,0) (0,1) (0,2) (1,0) (1,1) (1,2) (2,2) = 7
    pixels = 7
    assert nbytes == (2 * p * p * c * 2 + wy.numel() * 4 + wx.numel() * 4 + 4 * 6 + pixels * c * 2)
    # per channel: ncol * nnz(wy) + P * nnz(wx), summed over RoIs
    assert flops == 2 * c * ((3 * 2 + p * 3) + (1 * 2 + p * 1))
    g = torch.zeros(2, p, p, c, dtype=torch.bfloat16)
    grads = [torch.zeros(1, 10, 12, c, dtype=torch.bfloat16)]
    flops, nbytes = fpn.roi_align_bwd_counts(g, [1, 10, 12, c], lvl, y0, x0, wy, wx, 2, grads)
    assert nbytes == g.numel() * 2 + wy.numel() * 4 + wx.numel() * 4 + 4 * 6 + 10 * 12 * c * 2
    # per channel: P * nnz(wy) + (rows with a wy tap) * nnz(wx)
    assert flops == 2 * c * ((p * 2 + 2 * 3) + (p * 2 + 2 * 1))


def test_least_time_takes_the_larger_bound():
    t, by = counts.least_seconds(counts.PEAK_BF16, 1.0)
    assert (t, by) == (1.0, "operations")
    t, by = counts.least_seconds(1.0, counts.HBM_BYTES_S * 2)
    assert (t, by) == (2.0, "bytes")
