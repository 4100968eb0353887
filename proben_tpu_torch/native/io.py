"""Image loading on the card (counterpart of ``proben_tpu/native/io.py`` and
``native/proben_io.cpp``): JPEG decode with nvJPEG, then one kernel that
composes the channels, crops and flips the images the training augmentation
crops and flips, resizes to the shortest-edge size and pads a batch into the
static float32 canvas (``csrc/image_io.cu``).

``compose_resize_pad`` launches the kernel for CUDA tensors and runs
``compose_resize_pad_plain``, the same arithmetic in PyTorch, only for CPU
tensors. ``JpegCodec`` owns an nvJPEG handle; ``load_batch`` reads files,
decodes them and makes the canvas on the card. The decoder is chosen by the
file's first bytes: a JPEG (SOI marker ``FF D8``) goes to nvJPEG, any other
file (Cityscapes' PNGs) is decoded on the host by ``cv2.imread`` exactly as
the CPU path reads it (``decode_host``) and copied to the card; both feed
the same launch. Nothing falls back: without a card, or if nvJPEG, cv2 or
the kernel fail, they raise.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..utils import tracing

FORMATS = {"BGR": (0, 3), "BGRT": (1, 4), "BGRTTT": (2, 6)}  # code, channels
Crop = Tuple[int, int, int, int]  # y0, x0, ch, cw: a window of the thermal frame

_P, _I, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_SIG = {
    "image_io_codec_create": [ctypes.POINTER(_P)],
    "image_io_codec_destroy": [_P],
    "image_io_info": [_P, ctypes.c_char_p, _Z, ctypes.POINTER(_I), ctypes.POINTER(_I),
                      ctypes.POINTER(_I)],
    "image_io_decode": [_P, ctypes.c_char_p, _Z, _P, _I, _I, _I, _P],
    "image_io_encode": [_P, _P, _I, _I, _I, _I, ctypes.c_char_p, _Z, ctypes.POINTER(_Z), _P],
    "image_io_compose": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "image_io_max_batch": [],
}


def _lib() -> ctypes.CDLL:
    return _build.load("image_io", _SIG)


def _check(code: int, what: str) -> None:
    if code >= 1000:
        raise RuntimeError(f"{what}: nvJPEG status {code - 1000}")
    _build.check(code, what)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class JpegCodec:
    """An nvJPEG decoder and encoder on the current CUDA device. Close it
    (or use it in a ``with`` block) to release the handle."""

    def __init__(self):
        if not torch.cuda.is_available():
            raise RuntimeError("JpegCodec needs a CUDA device (nvJPEG)")
        self._lib = _lib()
        self._ptr = _P()
        _check(self._lib.image_io_codec_create(ctypes.byref(self._ptr)), "nvjpeg create")

    def close(self) -> None:
        if self._ptr:
            ptr, self._ptr = self._ptr, _P()
            _check(self._lib.image_io_codec_destroy(ptr), "nvjpeg destroy")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def info(self, data: bytes) -> Tuple[int, int, int]:
        """(height, width, channels) of a JPEG file's bytes; channels is 1
        for a single-component file, else 3."""
        h, w, c = _I(), _I(), _I()
        _check(self._lib.image_io_info(self._ptr, data, len(data), ctypes.byref(h), ctypes.byref(w),
                                       ctypes.byref(c)), "nvjpeg image info")
        return h.value, w.value, c.value

    def decode(self, data: bytes) -> torch.Tensor:
        """(H, W, C) uint8 on the card: BGR (C = 3), or Y (C = 1) for a
        single-component file. Returns once the current stream has passed
        the decode (consecutive decodes on one nvJPEG state corrupt each
        other otherwise)."""
        h, w, c = self.info(data)
        out = torch.empty((h, w, c), dtype=torch.uint8, device="cuda")
        _check(self._lib.image_io_decode(self._ptr, data, len(data), out.data_ptr(), h, w, c,
                                         _stream()), "nvjpeg decode")
        return out

    def encode(self, image: torch.Tensor, quality: int = 90) -> bytes:
        """JPEG bytes of an (H, W, C) uint8 CUDA image: BGR 4:2:0 for C = 3,
        grayscale for C = 1."""
        if image.device.type != "cuda" or image.dtype != torch.uint8 or image.dim() != 3 \
                or image.shape[2] not in (1, 3) or not image.is_contiguous():
            raise ValueError("encode takes a contiguous (H, W, 1 or 3) uint8 CUDA tensor")
        h, w, c = image.shape
        cap = h * w * c + (1 << 16)
        for _ in range(2):
            buf = ctypes.create_string_buffer(cap)
            n = _Z()
            code = self._lib.image_io_encode(self._ptr, image.data_ptr(), h, w, c, quality, buf, cap,
                                             ctypes.byref(n), _stream())
            if code != -1:
                _check(code, "nvjpeg encode")
                return buf.raw[:n.value]
            cap = n.value
        raise RuntimeError("nvjpeg encode: output size changed between calls")


# ---------------------------------------------------------------------------
# compose + resize + pad
# ---------------------------------------------------------------------------


def _scale(src: int, dst: int) -> np.float32:
    """The source-over-destination scale both versions use, in float32."""
    return np.float32(src) / np.float32(dst)


def _taps(n_out: int, n_src: int, scale: np.float32, device):
    """Half-pixel bilinear taps (i0, i1, w0, w1) of ``n_out`` outputs over
    ``n_src`` samples, in the kernel's float32 operations and order."""
    s = torch.tensor(scale, dtype=torch.float32, device=device)
    f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * s - 0.5
    f = f.clamp(0.0, float(n_src - 1))
    i0 = f.to(torch.int64)
    i1 = (i0 + 1).clamp(max=n_src - 1)
    w1 = f - i0.to(torch.float32)
    return i0, i1, 1.0 - w1, w1


def _bilinear(img: torch.Tensor, nh: int, nw: int, sy, sx) -> torch.Tensor:
    """(H, W, C) float32 -> (nh, nw, C): rows first (two taps along x per
    source row), then the two rows blended, as the kernel does."""
    y0, y1, wy0, wy1 = _taps(nh, img.shape[0], sy, img.device)
    x0, x1, wx0, wx1 = _taps(nw, img.shape[1], sx, img.device)
    wx0, wx1 = wx0[None, :, None], wx1[None, :, None]
    a = img[y0][:, x0] * wx0 + img[y0][:, x1] * wx1
    b = img[y1][:, x0] * wx0 + img[y1][:, x1] * wx1
    return a * wy0[:, None, None] + b * wy1[:, None, None]


def _cv2_scale(src: int, dst: int) -> float:
    """cv2.resize's source-over-destination scale: 1 / (dst / src) in double."""
    return 1.0 / (dst / src)


def _fixed_taps(n_out: int, n_src: int, clamp_weights: bool, device):
    """cv2.INTER_LINEAR's taps on uint8 along one axis (the kernel's
    ``fixed_taps``): (i0, i1, a0, a1) with 11-bit fixed-point weights."""
    f = ((np.arange(n_out) + 0.5) * _cv2_scale(n_src, n_out) - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = f - i.astype(np.float32)
    if clamp_weights:
        out = (i < 0) | (i >= n_src - 1)
        f[out] = 0.0
        i = np.clip(i, 0, n_src - 1)
    a0 = np.rint((np.float32(1.0) - f) * np.float32(2048.0)).astype(np.int32)
    a1 = np.rint(f * np.float32(2048.0)).astype(np.int32)
    taps = (np.clip(i, 0, n_src - 1), np.clip(i + 1, 0, n_src - 1), a0, a1)
    return [torch.from_numpy(t).to(device) for t in taps]


def resize_u8_cv2(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """``cv2.resize(img, (nw, nh))`` (INTER_LINEAR) of an (H, W, C) uint8
    image, in cv2's fixed-point arithmetic: horizontal sums with 11-bit
    weights, then ``((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2 >> 2``.
    Along y the rows are clamped and the weights kept, so the edge rows round
    as cv2 rounds them. float32 (nh, nw, C) holding the uint8 values."""
    y0, y1, b0, b1 = _fixed_taps(nh, img.shape[0], False, img.device)
    x0, x1, a0, a1 = _fixed_taps(nw, img.shape[1], True, img.device)
    im = img.to(torch.int32)
    h = im[:, x0] * a0[None, :, None] + im[:, x1] * a1[None, :, None]
    v = ((b0[:, None, None] * (h[y0] >> 4)) >> 16) + ((b1[:, None, None] * (h[y1] >> 4)) >> 16)
    return ((v + 2) >> 2).clamp(0, 255).to(torch.float32)


def _composed_frame(thermal: torch.Tensor, rgb: Optional[torch.Tensor], input_format: str):
    """The composed image at the thermal frame, float32 (th, tw, C): BGR the
    thermal file's channels; BGRT/BGRTTT the RGB file resized to the frame as
    uint8 (``resize_u8_cv2``), then one or three thermal channels.
    Single-channel (Y) images count as three equal ones."""
    t = thermal.expand(-1, -1, 3).to(torch.float32)
    if input_format == "BGR":
        return t
    rs = resize_u8_cv2(rgb.expand(-1, -1, 3), *thermal.shape[:2])
    return torch.cat([rs, t[..., :1] if input_format == "BGRT" else t], -1)


def compose_resize_pad_plain(
    thermal: Sequence[torch.Tensor],
    rgb: Optional[Sequence[torch.Tensor]],
    input_format: str,
    sizes: Sequence[Tuple[int, int]],
    pad_shape: Tuple[int, int],
    flips: Optional[Sequence[bool]] = None,
    crops: Optional[Sequence[Optional[Crop]]] = None,
) -> torch.Tensor:
    """Plain version of the compose kernel: for each image, the composed
    thermal-frame image (``_composed_frame``), cut to ``crops[i]`` = (y0,
    x0, ch, cw) where given (the training augmentation's random crop of the
    composed frame; None the whole frame), resized bilinearly with
    half-pixel centres to ``sizes[i]`` (the shortest-edge size of the
    crop), flipped horizontally where ``flips[i]`` (the training
    augmentation's flip of the resized image) and zero-padded to
    ``pad_shape``; (N, PH, PW, C) float32 on the inputs' device.
    ``thermal[i]``, ``rgb[i]``: decoded (H, W, 1 or 3) uint8."""
    ph, pw = pad_shape
    c = FORMATS[input_format][1]
    out = torch.zeros((len(thermal), ph, pw, c), dtype=torch.float32, device=thermal[0].device)
    for i, (nh, nw) in enumerate(sizes):
        frame = _composed_frame(thermal[i], None if rgb is None else rgb[i], input_format)
        if crops is not None and crops[i] is not None:
            y0, x0, ch, cw = crops[i]
            frame = frame[y0:y0 + ch, x0:x0 + cw]
        th, tw = frame.shape[:2]
        resized = _bilinear(frame, nh, nw, _scale(th, nh), _scale(tw, nw))
        out[i, :nh, :nw] = resized.flip(1) if flips is not None and flips[i] else resized
    return out


def _check_inputs(thermal, rgb, input_format, sizes, pad_shape, flips, crops):
    if input_format not in FORMATS:
        raise ValueError(f"input_format {input_format!r}: expected one of {sorted(FORMATS)}")
    if (rgb is None) != (input_format == "BGR"):
        raise ValueError(f"{input_format}: rgb images {'missing' if rgb is None else 'given'}")
    if len(sizes) != len(thermal) or (rgb is not None and len(rgb) != len(thermal)) or not thermal \
            or (flips is not None and len(flips) != len(thermal)) \
            or (crops is not None and len(crops) != len(thermal)):
        raise ValueError("one size (one flip, one crop, one rgb image for fused formats) per "
                         "thermal image")
    for img in list(thermal) + list(rgb or []):
        if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] not in (1, 3) \
                or img.device != thermal[0].device or not img.is_contiguous():
            raise ValueError("images must be contiguous (H, W, 1 or 3) uint8 on one device")
    for (nh, nw) in sizes:
        if not (0 < nh <= pad_shape[0] and 0 < nw <= pad_shape[1]):
            raise ValueError(f"resized size ({nh}, {nw}) outside pad_shape {tuple(pad_shape)}")
    for t, crop in zip(thermal, crops or ()):
        if crop is not None:
            y0, x0, ch, cw = crop
            if not (0 <= y0 and 0 <= x0 and 0 < ch and 0 < cw and y0 + ch <= t.shape[0]
                    and x0 + cw <= t.shape[1]):
                raise ValueError(f"crop {tuple(crop)} outside the frame {tuple(t.shape[:2])}")


def compose_resize_pad(
    thermal: Sequence[torch.Tensor],
    rgb: Optional[Sequence[torch.Tensor]],
    input_format: str,
    sizes: Sequence[Tuple[int, int]],
    pad_shape: Tuple[int, int],
    flips: Optional[Sequence[bool]] = None,
    crops: Optional[Sequence[Optional[Crop]]] = None,
) -> torch.Tensor:
    """The (N, PH, PW, C) float32 canvas of a batch (see
    ``compose_resize_pad_plain``). One kernel launch (per 40 images) for
    CUDA tensors, which also crops and flips: the thread of output column
    x < nw computes resized column nw - 1 - x, and its taps index the
    frame at the crop window's origin plus their position in the window;
    the plain version for CPU tensors; raises on anything else."""
    _check_inputs(thermal, rgb, input_format, sizes, pad_shape, flips, crops)
    dev = thermal[0].device
    if dev.type == "cpu":
        return compose_resize_pad_plain(thermal, rgb, input_format, sizes, pad_shape, flips, crops)
    if dev.type != "cuda":
        raise ValueError(f"compose_resize_pad: unsupported device {dev}")
    fmt, c = FORMATS[input_format]
    ptrs, ints, scales = [], [], []
    for i, t in enumerate(thermal):
        r = t if rgb is None else rgb[i]  # BGR reads no RGB image
        (th, tw, tc), (rh, rw, rc), (nh, nw) = t.shape, r.shape, sizes[i]
        crop = crops[i] if crops is not None and crops[i] is not None else (0, 0, th, tw)
        ch, cw = crop[2], crop[3]
        ptrs += [t.data_ptr(), 0 if rgb is None else r.data_ptr()]
        ints += [th, tw, tc, rh, rw, rc, nh, nw, int(bool(flips[i])) if flips is not None else 0,
                 *crop]
        scales += [_scale(ch, nh), _scale(cw, nw), _cv2_scale(rh, th), _cv2_scale(rw, tw)]
    n = len(thermal)
    # host tables; the library passes them to the kernel as parameters
    desc_ptr = np.array(ptrs, np.int64)
    desc_int = np.array(ints, np.int32)
    desc_scale = np.array(scales, np.float64)
    out = torch.empty((n,) + tuple(pad_shape) + (c,), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.image_io_compose(desc_ptr.ctypes.data, desc_int.ctypes.data, desc_scale.ctypes.data,
                                    out.data_ptr(), n, pad_shape[0], pad_shape[1], fmt, c, _stream())
    _check(code, "compose_resize_pad")
    tracing.count("io.launches", -(-n // lib.image_io_max_batch()))
    return out


JPEG_SOI = b"\xff\xd8"  # the first two bytes of every JPEG file


def decode_host(path: str) -> torch.Tensor:
    """A file that is not a JPEG, decoded on the host as the CPU path reads
    it (``data/detection_utils.py::_read_image_cpu``: ``cv2.imread`` with
    ``IMREAD_COLOR``, BGR, a grayscale file as three equal channels) and
    copied to the current CUDA device: (H, W, 3) uint8. Raises
    ``FileNotFoundError`` where cv2 cannot read the file, as on the CPU."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return torch.from_numpy(np.ascontiguousarray(img)).cuda()


def load_batch(
    codec: JpegCodec,
    thermal_paths: Sequence[str],
    rgb_paths: Optional[Sequence[str]],
    input_format: str,
    sizes_fn,
    pad_shape: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Read and decode a batch (JPEGs with nvJPEG, other files with
    ``decode_host``) and make its canvas on the card in one launch.
    ``sizes_fn(h, w)`` gives an image's resized (h, w) from its
    thermal-frame size, or (h, w, flip) to flip the resized image
    horizontally, or (h, w, flip, crop) to resize the crop window (y0, x0,
    ch, cw) of the frame (None: the whole frame); it is called image by
    image, in order. ``pad_shape``
    None pads to the largest. Returns (images (N, PH, PW, C) float32 CUDA,
    sizes (N, 2) int32 resized hw, orig (N, 2) int32 thermal-frame hw)."""
    decoded: List[torch.Tensor] = []
    for p in list(thermal_paths) + list(rgb_paths or []):
        with open(p, "rb") as f:
            data = f.read()
        decoded.append(codec.decode(data) if data[:2] == JPEG_SOI else decode_host(p))
    n = len(thermal_paths)
    thermal, rgb = decoded[:n], (decoded[n:] if rgb_paths is not None else None)
    orig = np.array([t.shape[:2] for t in thermal], np.int32).reshape(-1, 2)
    draws = [tuple(sizes_fn(int(h), int(w))) for h, w in orig]
    sizes = np.array([d[:2] for d in draws], np.int32).reshape(-1, 2)
    flips = [len(d) > 2 and bool(d[2]) for d in draws]
    crops = [d[3] if len(d) > 3 else None for d in draws]
    pad = tuple(pad_shape) if pad_shape is not None else tuple(int(v) for v in sizes.max(0))
    images = compose_resize_pad(thermal, rgb, input_format, [tuple(s) for s in sizes], pad, flips,
                                crops)
    return images, sizes, orig
