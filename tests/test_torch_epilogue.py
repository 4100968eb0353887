"""The bottleneck epilogue (``proben_tpu_torch/ops/epilogue_cuda.py``) on the
CPU: the op ``proben::block_epilogue`` and its backward op against the eager
composition they replace, their ``torch.library`` registration, the route
K4 takes, and ``_bottleneck`` before and after.

The op's CPU implementation is the composition itself, so its values and
its gradients must equal the composition's bit for bit: the backward op
reduces a broadcast parameter's gradient with autograd's own
``sum_to_size``. The kernel K4 runs only on the card
(``tests/test_torch_kernels.py``).
"""

import types

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from proben_tpu_torch.models import layers, resnet
from proben_tpu_torch.ops import epilogue_cuda as ep
from proben_tpu_torch.utils import tracing
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

BF = torch.bfloat16
MODES = ("relu", "identity", "shortcut")


def _norm(scale, bias):
    return types.SimpleNamespace(scale=scale, bias=bias)  # what ``layers.affine`` reads


def _eager(x, scale, bias, residual=None, residual_scale=None, residual_bias=None):
    """The bottleneck's epilogue as ``models/resnet.py`` composed it before
    the op: ``layers.affine``, the add, ``torch.relu``."""
    out = layers.affine(x, _norm(scale, bias))
    if residual is not None:
        if residual_scale is not None:
            residual = layers.affine(residual, _norm(residual_scale, residual_bias))
        out = out + residual
    return torch.relu(out)


def _case(mode, dtype, shape=(2, 16, 5, 7), seed=0, plant=False):
    """Channels_last maps in ``dtype`` and f32 (C,) parameters; ``plant``:
    NaN, +-inf and -0.0 among the map values."""
    rng = np.random.RandomState(seed)
    n, c, h, w = shape

    def amap():
        a = (rng.randn(n, c, h, w) * 2).astype(np.float32)
        if plant:
            a.reshape(-1)[rng.randint(0, a.size, 8)] = [np.nan, np.inf, -np.inf, -0.0] * 2
        return torch.from_numpy(a).to(dtype).contiguous(memory_format=torch.channels_last)

    def param():
        return torch.from_numpy((rng.randn(c) * 1.5).astype(np.float32))

    args = [amap(), param(), param()]
    if mode != "relu":
        args.append(amap())
    if mode == "shortcut":
        args += [param(), param()]
    return args + [None] * (6 - len(args))


def _same(a, b):
    """Bit for bit (NaN payloads and signed zeros included)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    view = torch.int16 if a.element_size() == 2 else torch.int32
    assert torch.equal(a.contiguous().view(view), b.contiguous().view(view))


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("mode", MODES)
def test_op_equals_the_eager_composition(mode, dtype):
    """The op's CPU implementation against the composition it replaces:
    the same bits, non-finite values and signed zeros included, and the
    same channels_last layout; no kernel launch, no plain-route count."""
    args = _case(mode, dtype, plant=True)
    before = tracing.counters()
    got = ep.block_epilogue(*args)
    _same(got, _eager(*args))
    assert got.is_contiguous(memory_format=torch.channels_last)
    after = tracing.counters()
    for key in ("k4.launches", "epilogue.plain"):
        assert after.get(key, 0) == before.get(key, 0)


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("mode", MODES)
def test_op_gradients_equal_autograd_through_the_composition(mode, dtype):
    """Gradients of the map, the residual (identity or the shortcut conv's
    output), each scale and each bias through the op's registered backward
    (``proben::block_epilogue_bwd``) equal autograd's through the
    composition bit for bit, in bf16 (parameters kept f32, as the model
    holds them) and in f32."""
    args = [t for t in _case(mode, dtype, seed=1) if t is not None]
    g = _case("relu", dtype, seed=2)[0]
    grads = []
    for fn in (ep.block_epilogue, _eager):
        leaves = [t.clone().requires_grad_() for t in args]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
    assert len(grads[0]) == len(args)
    for a, b in zip(*grads):
        assert float(a.abs().sum()) > 0
        _same(a, b)


def test_op_backward_only_where_asked():
    """Parameters frozen (no grad): the map's and the identity residual's
    gradients alone, the residual's being the masked cotangent itself."""
    x, s, b, r, _, _ = _case("identity", BF, seed=3)
    g = _case("relu", BF, seed=4)[0]
    grads = []
    for fn in (ep.block_epilogue, _eager):
        xl, rl = x.clone().requires_grad_(), r.clone().requires_grad_()
        y = fn(xl, s, b, rl)
        grads.append(torch.autograd.grad(y, [xl, rl], g))
    for a, w in zip(*grads):
        _same(a, w)
    _same(grads[0][1], torch.where(y > 0, g, torch.zeros_like(g)))


@pytest.mark.parametrize("mode", MODES)
def test_bwd_op_is_the_plain_backward(mode):
    """The backward op on CPU tensors is ``block_epilogue_bwd_plain``: one
    map gradient per map, f32 (C,) parameter gradients, the shortcut's bias
    gradient equal to the block's."""
    x, s, b, r, rs, rb = _case(mode, BF, seed=5)
    y = ep.block_epilogue(x, s, b, r, rs, rb)
    g = _case("relu", BF, seed=6)[0]
    shortcut = r if mode == "shortcut" else None
    got = torch.ops.proben.block_epilogue_bwd(g, y, x, s, shortcut, rs, mode != "relu")
    want = ep.block_epilogue_bwd_plain(g, y, x, s, shortcut, rs, mode != "relu")
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert len(got) == {"relu": 3, "identity": 4, "shortcut": 6}[mode]
    for a, w in zip(got, want):
        _same(a, w)
    assert got[1].dtype == got[2].dtype == torch.float32
    if mode == "shortcut":
        _same(got[5], got[2])


def test_opcheck_on_both_ops():
    """``torch.library.opcheck`` (schema, fake, autograd registration,
    dispatch) on the forward op in each mode and on the backward op."""
    for mode in MODES:
        args = [t for t in _case(mode, BF, seed=7)]
        args = [t.requires_grad_() if t is not None else None for t in args]
        torch.library.opcheck(torch.ops.proben.block_epilogue.default, tuple(args))
    x, s, b, r, rs, rb = _case("shortcut", BF, seed=8)
    y = ep.block_epilogue(x, s, b, r, rs, rb)
    g = _case("relu", BF, seed=9)[0]
    for shortcut, scale, residual in ((None, None, False), (None, None, True), (r, rs, True)):
        torch.library.opcheck(torch.ops.proben.block_epilogue_bwd.default,
                              (g, y, x, s, shortcut, scale, residual))


def test_gate_takes_only_what_k4_takes():
    """``kernel_takes`` reads only what the inputs show: CPU tensors never
    take K4, and of the map conditions it checks, NCHW-contiguous maps, f32
    maps, C not a multiple of 8 and a map offset off 16 bytes each fail. On
    the CPU every such input runs the op's plain composition, with the
    composition's values, and counts nothing."""
    x, s, b, r, rs, rb = _case("shortcut", BF, shape=(2, 16, 4, 6))
    assert not ep.kernel_takes(x, s, b, r, rs, rb)  # a CPU tensor
    assert ep._aligned(x) and ep._aligned(r)
    assert not ep._aligned(x.contiguous())  # NCHW-contiguous
    assert not ep._aligned(x.float())  # f32
    assert not ep._aligned(_case("relu", BF, shape=(2, 12, 4, 6))[0])  # C % 8 != 0
    flat = torch.zeros(1 + x.numel(), dtype=BF)
    shifted = flat[1:].view(2, 4, 6, 16).permute(0, 3, 1, 2)
    assert shifted.is_contiguous(memory_format=torch.channels_last) and not ep._aligned(shifted)
    before = tracing.counters()
    for xx, rr in ((x.contiguous(), r.contiguous()), (x.float(), r.float()), (shifted, shifted)):
        _same(ep.block_epilogue(xx, s, b, rr, rs, rb), _eager(xx, s, b, rr, rs, rb))
    assert tracing.counters().get("epilogue.plain", 0) == before.get("epilogue.plain", 0)
    assert tracing.counters().get("k4.launches", 0) == before.get("k4.launches", 0)


def _old_bottleneck(block, x, stride, dtype=None):
    """``resnet._bottleneck`` as it was before the epilogue op."""
    out = layers.conv2d(x, block.conv1.weight, None, stride, 0, dtype)
    out = torch.relu(layers.affine(out, block.norm1))
    out = layers.conv2d(out, block.conv2.weight, None, 1, 1, dtype)
    out = torch.relu(layers.affine(out, block.norm2))
    out = layers.conv2d(out, block.conv3.weight, None, 1, 0, dtype)
    out = layers.affine(out, block.norm3)
    if block.shortcut is not None:
        sc = layers.conv2d(x, block.shortcut.weight, None, stride, 0, dtype)
        sc = layers.affine(sc, block.shortcut_norm)
    else:
        sc = x
    return torch.relu(out + sc)


def _block(shortcut, seed):
    torch.manual_seed(seed)
    cin, width, cout = (16, 8, 32) if shortcut else (32, 8, 32)
    block = resnet.Bottleneck(cin, width, cout, shortcut)
    for p in block.parameters():
        p.data = (torch.randn(p.shape) * 0.3 + (1.0 if p.dim() == 1 else 0.0)).contiguous(
            memory_format=torch.channels_last if p.dim() == 4 else torch.contiguous_format)
    x = torch.randn(2, cin, 9, 10).to(BF).contiguous(memory_format=torch.channels_last)
    return block, x


@pytest.mark.parametrize("shortcut,stride", [(True, 2), (True, 1), (False, 1)])
@pytest.mark.parametrize("how", ["no_grad", "grad", "checkpoint"])
def test_bottleneck_is_unchanged(shortcut, stride, how):
    """``_bottleneck`` through the op against the composition it ran before,
    in bf16: the same output bits without grad, with grad and under
    ``torch.utils.checkpoint``, and with grad the same gradients of the
    block input and of every parameter."""
    block, x = _block(shortcut, seed=11)
    if how == "no_grad":
        with torch.no_grad():
            _same(resnet._bottleneck(block, x, stride, BF), _old_bottleneck(block, x, stride, BF))
        return
    params = list(block.parameters())
    outs, grads = [], []
    for fn in (resnet._bottleneck, _old_bottleneck):
        for p in params:
            p.requires_grad_(True)
        xl = x.clone().requires_grad_()
        if how == "checkpoint":
            y = torch.utils.checkpoint.checkpoint(fn, block, xl, stride, BF, use_reentrant=False)
        else:
            y = fn(block, xl, stride, BF)
        g = torch.from_numpy(np.random.RandomState(12).randn(*y.shape).astype(np.float32)).to(BF)
        outs.append(y)
        grads.append(torch.autograd.grad(y, [xl] + params, g))
        for p in params:
            p.requires_grad_(False)
    _same(*outs)
    for a, b in zip(*grads):
        _same(a, b)


def test_a_trace_records_the_op_for_cuda_maps_whatever_their_strides(monkeypatch):
    """Under a trace (``torch.compiler.is_compiling()``, as ``torch.export``
    sets it) CUDA maps take the op whatever their fake strides: a fake
    convolution's output is NCHW-contiguous where the card's cuDNN gives
    channels_last, so the strides a trace sees do not decide K4. Neither
    the plain composition nor ``_K4`` is traced. (With grad, a trace of
    the op needs a CUDA build: ``tests/test_torch_kernels.py`` exports a
    bottleneck on the card.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refused(*args):
        raise AssertionError("a trace took the eager route")

    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    monkeypatch.setattr(ep, "block_epilogue_plain", refused)
    monkeypatch.setattr(ep._K4, "apply", refused)
    with FakeTensorMode():
        x = torch.empty(2, 16, 4, 6, device="cuda", dtype=BF)  # NCHW-contiguous, as a fake conv gives
        r = torch.empty(2, 16, 4, 6, device="cuda", dtype=BF)
        s, b = (torch.empty(16, device="cuda") for _ in range(2))
        assert not ep.kernel_takes(x, s, b, r)
        y = ep.block_epilogue(x, s, b, r)
    assert y.shape == x.shape and y.device.type == "cuda" and y.dtype == BF
