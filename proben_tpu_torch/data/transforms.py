"""Host-side image transforms (counterpart of ``proben_tpu/data/transforms.py``;
reference ``detectron2/data/transforms/transform_gen.py``).

Numpy implementations of ``ResizeShortestEdge`` (:167) and ``RandomFlip``
(:115), ``RandomCrop`` (:218), the photometric jitters
``RandomContrast``/``RandomBrightness``/``RandomSaturation``/
``RandomLighting`` (:308-413, as :class:`ColorAugment`) and ``RandomExtent``
(:263). Geometric transforms return the transformed image plus boxes mapped
to the new frame; color transforms touch only pixels. Images are resized
with cv2 on the CPU, as the JAX package does; on the card the ``image_io``
kernel crops, resizes and flips (``native/io.py``), and
``TrainAugment.crop_window`` and ``TrainAugment.draw`` give it the same
random draws.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def resize_shortest_edge_size(
    h: int, w: int, short: int, max_size: int
) -> Tuple[int, int]:
    """Target (new_h, new_w) (reference ResizeShortestEdge.get_transform)."""
    scale = short * 1.0 / min(h, w)
    if h < w:
        newh, neww = short, scale * w
    else:
        newh, neww = scale * h, short
    if max(newh, neww) > max_size:
        scale = max_size * 1.0 / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    return int(newh + 0.5), int(neww + 0.5)


def resize_image(image: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Bilinear resize of an HWC image (any channel count) with half-pixel
    centres (``cv2.INTER_LINEAR``) to float32, on the CPU with cv2 as in the
    JAX package. On the card the ``image_io`` kernel resizes
    (``native/io.py``)."""
    if image.shape[0] == new_h and image.shape[1] == new_w:
        return image
    import cv2

    out = cv2.resize(
        image.astype(np.float32), (new_w, new_h), interpolation=cv2.INTER_LINEAR
    )
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def resize_boxes(boxes: np.ndarray, old_hw, new_hw) -> np.ndarray:
    sy = new_hw[0] / old_hw[0]
    sx = new_hw[1] / old_hw[1]
    return boxes * np.array([sx, sy, sx, sy], boxes.dtype)


def hflip_image(image: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(image[:, ::-1])


def hflip_boxes(boxes: np.ndarray, width: float) -> np.ndarray:
    out = boxes.copy()
    out[:, 0] = width - boxes[:, 2]
    out[:, 2] = width - boxes[:, 0]
    return out


def crop_window(
    h: int, w: int, crop_size: Tuple[float, float], rng: np.random.RandomState
) -> Tuple[int, int, int, int]:
    """The relative-range crop window (y0, x0, ch, cw) of an (h, w) image:
    ``random_crop``'s four draws from ``rng``, in its order."""
    ch = int(h * (crop_size[0] + (1 - crop_size[0]) * rng.rand()) + 0.5)
    cw = int(w * (crop_size[1] + (1 - crop_size[1]) * rng.rand()) + 0.5)
    y0 = rng.randint(0, h - ch + 1)
    x0 = rng.randint(0, w - cw + 1)
    return y0, x0, ch, cw


def random_crop(
    image: np.ndarray,
    boxes: np.ndarray,
    crop_size: Tuple[float, float],
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray]:
    """Relative-range random crop (reference RandomCrop "relative_range"):
    crop h, w sampled in [crop_size, 1] fractions of the image."""
    y0, x0, ch, cw = crop_window(*image.shape[:2], crop_size, rng)
    image = image[y0 : y0 + ch, x0 : x0 + cw]
    boxes = boxes - np.array([x0, y0, x0, y0], boxes.dtype)
    return np.ascontiguousarray(image), boxes


# ---------------------------------------------------------------------------
# Color jitter (reference transform_gen.py RandomContrast :308-331,
# RandomBrightness :334-357, RandomSaturation :360-385, RandomLighting
# :388-413 -- each lowers to a BlendTransform: out = src_w*src + dst_w*img).
# Color-only: boxes are unchanged. Not on any ProbEn config path; provided
# for custom mappers, as in the JAX package.
# ---------------------------------------------------------------------------


def blend(img: np.ndarray, src_image, src_weight: float, dst_weight: float) -> np.ndarray:
    """fvcore BlendTransform.apply_image semantics (float path, no clip)."""
    return src_weight * np.asarray(src_image, np.float32) + dst_weight * img.astype(np.float32)


def random_contrast(img, lo: float, hi: float, rng: np.random.RandomState):
    w = rng.uniform(lo, hi)
    return blend(img, img.mean(), 1 - w, w)


def random_brightness(img, lo: float, hi: float, rng: np.random.RandomState):
    w = rng.uniform(lo, hi)
    return blend(img, 0, 1 - w, w)


def random_saturation(img, lo: float, hi: float, rng: np.random.RandomState):
    if img.shape[-1] != 3:
        raise ValueError("saturation jitter takes 3-channel images")
    w = rng.uniform(lo, hi)
    grayscale = img[..., :3].astype(np.float32).dot([0.299, 0.587, 0.114])[:, :, None]
    return blend(img, grayscale, 1 - w, w)


_LIGHTING_EIGEN_VECS = np.array(
    [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140], [-0.5836, -0.6948, 0.4203]]
)
_LIGHTING_EIGEN_VALS = np.array([0.2175, 0.0188, 0.0045])


def random_lighting(img, scale: float, rng: np.random.RandomState):
    """ImageNet-PCA color jitter (reference RandomLighting :388-413)."""
    if img.shape[-1] != 3:
        raise ValueError("lighting jitter takes 3-channel images")
    weights = rng.normal(scale=scale, size=3)
    return blend(img, _LIGHTING_EIGEN_VECS.dot(weights * _LIGHTING_EIGEN_VALS), 1.0, 1.0)


class ColorAugment:
    """Optional photometric jitter stack: contrast + brightness + saturation
    (each an (lo, hi) intensity range or None) and lighting (PCA stddev or
    None). Composable before :class:`TrainAugment` in a custom mapper."""

    def __init__(self, contrast=None, brightness=None, saturation=None,
                 lighting=None, rng: Optional[np.random.RandomState] = None):
        self.contrast = contrast
        self.brightness = brightness
        self.saturation = saturation
        self.lighting = lighting
        self.rng = rng or np.random.RandomState()

    def __call__(self, image: np.ndarray) -> np.ndarray:
        if self.contrast is not None:
            image = random_contrast(image, *self.contrast, rng=self.rng)
        if self.brightness is not None:
            image = random_brightness(image, *self.brightness, rng=self.rng)
        if self.saturation is not None:
            image = random_saturation(image, *self.saturation, rng=self.rng)
        if self.lighting is not None:
            image = random_lighting(image, self.lighting, rng=self.rng)
        return image


def random_extent(
    image: np.ndarray,
    boxes: np.ndarray,
    scale_range: Tuple[float, float],
    shift_range: Tuple[float, float],
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random scaled/shifted subrect crop (reference RandomExtent :263-305);
    out-of-source pixels are zero. Boxes shift into the subrect frame."""
    h, w = image.shape[:2]
    rect = np.array([-0.5 * w, -0.5 * h, 0.5 * w, 0.5 * h])
    rect *= rng.uniform(scale_range[0], scale_range[1])
    rect[0::2] += shift_range[0] * w * (rng.rand() - 0.5) + 0.5 * w
    rect[1::2] += shift_range[1] * h * (rng.rand() - 0.5) + 0.5 * h
    x0, y0, x1, y1 = (int(v) for v in rect)
    oh, ow = y1 - y0, x1 - x0
    out = np.zeros((oh, ow) + image.shape[2:], np.float32)
    sy0, sy1 = max(0, y0), min(h, y1)
    sx0, sx1 = max(0, x0), min(w, x1)
    if sy1 > sy0 and sx1 > sx0:
        out[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = image[sy0:sy1, sx0:sx1]
    return out, boxes - np.array([x0, y0, x0, y0], boxes.dtype)


class TrainAugment:
    """[RandomCrop] + ResizeShortestEdge(choice) + RandomFlip(horizontal 0.5),
    with the JAX package's draws from ``rng`` in its order, per image: the
    crop's four (if cropping), then ``randint(len(short_sides))``, then
    ``rand()`` for the flip (if flipping)."""

    def __init__(
        self,
        short_sides: Sequence[int] = (640, 672, 704, 736, 768, 800),
        max_size: int = 1333,
        flip: bool = True,
        rng: Optional[np.random.RandomState] = None,
        crop: Optional[Tuple[float, float]] = None,  # relative_range crop size
        color: Optional[ColorAugment] = None,  # photometric jitter stack
    ):
        self.short_sides = list(short_sides)
        self.max_size = max_size
        self.flip = flip
        self.crop = crop
        self.color = color
        self.rng = rng or np.random.RandomState()

    def crop_window(self, h: int, w: int) -> Optional[Tuple[int, int, int, int]]:
        """The crop window (y0, x0, ch, cw) of an (h, w) image, the first
        draws of an image (``crop_window``); None without a crop. The card
        path makes these draws, then ``draw`` on (ch, cw)."""
        return None if self.crop is None else crop_window(h, w, self.crop, self.rng)

    def draw(self, h: int, w: int) -> Tuple[int, int, bool]:
        """The resized (h, w) of an (h, w) image (the crop window, if
        cropping) and whether it is flipped: the draws after the crop's."""
        short = self.short_sides[self.rng.randint(len(self.short_sides))]
        nh, nw = resize_shortest_edge_size(h, w, short, self.max_size)
        return nh, nw, bool(self.flip and self.rng.rand() < 0.5)

    def apply(
        self, image: np.ndarray, boxes: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """(image, boxes, whether the image was flipped)."""
        if self.color is not None:
            image = self.color(image)
        if self.crop is not None:
            image, boxes = random_crop(image, boxes, self.crop, self.rng)
        h, w = image.shape[:2]
        nh, nw, flip = self.draw(h, w)
        image = resize_image(image, nh, nw)
        boxes = resize_boxes(boxes, (h, w), (nh, nw))
        if flip:
            image = hflip_image(image)
            boxes = hflip_boxes(boxes, nw)
        return image, boxes, flip

    def __call__(
        self, image: np.ndarray, boxes: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        return self.apply(image, boxes)[:2]


class TestResize:
    """Deterministic ResizeShortestEdge at test time (min=800, max=1333)."""

    def __init__(self, short_side: int = 800, max_size: int = 1333):
        self.short_side = short_side
        self.max_size = max_size

    def size(self, h: int, w: int) -> Tuple[int, int]:
        return resize_shortest_edge_size(h, w, self.short_side, self.max_size)

    def __call__(self, image: np.ndarray) -> Tuple[np.ndarray, Tuple[int, int]]:
        nh, nw = self.size(*image.shape[:2])
        return resize_image(image, nh, nw), (nh, nw)
