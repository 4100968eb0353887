"""Exact greedy NMS (counterpart of ``proben_tpu/ops/nms.py``): kernel K5
(``csrc/nms.cu``) on the card, the dense Jacobi fixpoint on the CPU.

The greedy recurrence

    keep[j] = valid[j] and not any(keep[i] and iou[i, j] > t for i < j)

over score-sorted boxes is the ``torch.library`` custom op
``proben::nms_keep``. Every function takes leading batch dimensions
(images, FPN levels), flattened to one batch of problems.

- CPU tensors run the plain route, the JAX package's design for the TPU's
  matrix unit: the whole pairwise IoU matrix, the suppression mask, and
  the op ``proben::nms_fixpoint``, which iterates ``keep <- valid & ~(keep
  @ suppress)`` until nothing changes (suppression only flows from earlier
  to later boxes, so it converges to the exact greedy answer in at most the
  length of the longest suppression chain). Each iteration is one batched
  matvec for all problems and one host read. The loop runs in the span
  ``nms.fixpoint`` and counts ``nms.calls`` and ``nms.iters``
  (``utils/tracing.py``).
- CUDA tensors launch K5: a bitmask of the upper triangle's suppressions,
  then a sweep over 64-box blocks, on the device with no host read. It
  reproduces ``pairwise_iou``'s float32 rounding, so its keep mask is the
  plain route's bit for bit. It counts ``k5.launches``, one per call. A
  CUDA input K5 does not take (not float32, more than ``MAX_BOXES`` boxes
  a problem) raises; nothing falls back.

``torch.export`` keeps ``proben::nms_keep`` as one opaque node (its fake
gives the mask's shape), and ``utils.analysis.flop_count`` counts it as
nothing (no flop formula: NMS is no model work).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..structures.boxes import pairwise_iou
from ..utils import tracing

Tensor = torch.Tensor

_NEG_INF = -1e10
MAX_BOXES = 8192  # csrc/nms.cu's kMaxBoxes: the sweep's shared bitmask words
_SIG = {"nms_keep_f32": [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                                  ctypes.c_void_p]}


def nms_mask(
    boxes: torch.Tensor,  # (..., N, 4)
    scores: torch.Tensor,  # (..., N)
    valid: torch.Tensor,  # (..., N) bool; padded slots never suppress, never kept
    iou_threshold: float,
) -> torch.Tensor:
    """Exact greedy NMS; bool keep mask in the ORIGINAL box order. Ties in
    score go to the lower index; suppression needs IoU > threshold."""
    masked = torch.where(valid, scores, _NEG_INF)
    # jnp.argsort(-x) sorts NaN last; torch's descending sort puts it first
    masked = torch.where(torch.isnan(masked), float("-inf"), masked)
    _, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    svalid = torch.gather(valid, -1, order)

    keep = nms_keep(sboxes, svalid, iou_threshold)
    return torch.zeros_like(valid).scatter(-1, order, keep)


def nms_keep(sorted_boxes: Tensor, sorted_valid: Tensor, iou_threshold: float) -> Tensor:
    """The greedy keep mask over score-sorted boxes, in the sorted order:
    the op ``proben::nms_keep`` (K5 for CUDA tensors, ``nms_keep_plain``
    for CPU tensors); raises on any other device."""
    if sorted_boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms_keep: unsupported device {sorted_boxes.device}")
    return torch.ops.proben.nms_keep(sorted_boxes, sorted_valid, iou_threshold)


def nms_keep_plain(sorted_boxes: Tensor, sorted_valid: Tensor, iou_threshold: float) -> Tensor:
    """The plain route K5 replaces: ``(..., N, N)`` IoUs, the suppression
    mask (IoU > threshold, strict upper triangle, both valid) and the
    fixpoint op."""
    n = sorted_boxes.shape[-2]
    iou = pairwise_iou(sorted_boxes, sorted_boxes)
    tri = torch.ones(n, n, dtype=torch.bool, device=sorted_boxes.device).triu(1)
    suppress = (iou > iou_threshold) & tri & sorted_valid[..., :, None] & sorted_valid[..., None, :]
    return torch.ops.proben.nms_fixpoint(suppress, sorted_valid)


@torch.library.custom_op("proben::nms_keep", mutates_args=(), device_types="cpu")
def _nms_keep_op(sorted_boxes: Tensor, sorted_valid: Tensor, iou_threshold: float) -> Tensor:
    return nms_keep_plain(sorted_boxes, sorted_valid, iou_threshold)


@_nms_keep_op.register_kernel("cuda")
def _nms_keep_cuda(sorted_boxes, sorted_valid, iou_threshold):
    """K5: the mask pass and the sweep on the current stream, no sync."""
    if (sorted_boxes.dim() < 2 or sorted_boxes.shape[-1] != 4
            or sorted_valid.shape != sorted_boxes.shape[:-1]):
        raise ValueError(f"nms_keep: bad shapes boxes{tuple(sorted_boxes.shape)} "
                         f"valid{tuple(sorted_valid.shape)}")
    n = sorted_boxes.shape[-2]
    if sorted_boxes.dtype != torch.float32 or sorted_valid.dtype != torch.bool:
        raise ValueError(f"nms_keep: K5 takes float32 boxes and bool valid, got "
                         f"{sorted_boxes.dtype} and {sorted_valid.dtype}")
    if sorted_valid.device != sorted_boxes.device:
        raise ValueError("nms_keep: boxes and valid on different devices")
    if n > MAX_BOXES:
        raise ValueError(f"nms_keep: K5 takes at most {MAX_BOXES} boxes a problem, got {n}")
    keep = torch.empty_like(sorted_valid, memory_format=torch.contiguous_format)
    if keep.numel() == 0:
        return keep
    boxes = sorted_boxes.contiguous()
    valid = sorted_valid.contiguous()
    problems = keep.numel() // n
    mask = torch.empty(problems * n * -(-n // 64), dtype=torch.int64, device=boxes.device)
    lib = _build.load("nms", _SIG)
    with torch.cuda.device(boxes.device):
        code = lib.nms_keep_f32(boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(), keep.data_ptr(),
                                problems, n, iou_threshold, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "nms_keep")
    tracing.count("k5.launches")
    return keep


@_nms_keep_op.register_fake
def _nms_keep_fake(sorted_boxes, sorted_valid, iou_threshold):
    return torch.empty_like(sorted_valid)


@torch.library.custom_op("proben::nms_fixpoint", mutates_args=())
def nms_fixpoint(suppress: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The greedy keep mask over score-sorted boxes: ``keep <- valid &
    ~(keep @ suppress)`` from ``keep = valid`` until nothing changes.
    ``suppress`` (..., N, N) bool, [i, j] where box i suppresses box j;
    ``valid`` (..., N) bool."""
    # 0/1 products summed in f32 are exact for any n the detector uses
    with tracing.span("nms.fixpoint"):
        suppress_f = suppress.to(torch.float32)
        keep = valid
        iters = 0
        for _ in range(valid.shape[-1]):
            iters += 1
            hit = torch.matmul(keep.to(torch.float32)[..., None, :], suppress_f)[..., 0, :]
            new_keep = valid & ~(hit > 0.5)
            if torch.equal(new_keep, keep):
                break
            keep = new_keep
        tracing.count("nms.calls")
        tracing.count("nms.iters", iters)
        return keep.clone()


@nms_fixpoint.register_fake
def _nms_fixpoint_fake(suppress, valid):
    return torch.empty_like(valid)


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,  # (..., N) group ids (class); groups never interact
    valid: torch.Tensor,
    iou_threshold: float,
    coordinate_bound: float = 8192.0,
) -> torch.Tensor:
    """Per-group NMS by the coordinate-offset trick; ``coordinate_bound``
    must exceed every box coordinate."""
    offsets = idxs.to(boxes.dtype)[..., None] * (coordinate_bound + 1.0)
    return nms_mask(boxes + offsets, scores, valid, iou_threshold)
