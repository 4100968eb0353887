"""Image IO including the multichannel BGRT/BGRTTT formats (counterpart of
``proben_tpu/data/detection_utils.py``).

For the multimodal formats, the RGB path is given or else derived from the
thermal path (``thermal_8_bit/`` <-> ``RGB/``, ``.jpeg``/``.jpg`` extension
swap), the RGB image is resized to the thermal resolution as uint8, and
channels are stacked: BGRT = BGR + thermal channel 0 (4), BGRTTT = BGR + the three
thermal channels (6). Grayscale files read as three equal channels.

On the CPU ``read_image`` does exactly what the JAX package does, with cv2.
On the card it decodes JPEGs with nvJPEG (other files, such as PNGs, with
cv2 on the host) and composes with the ``image_io`` kernel
(``native/io.py``); a JPEG's pixels then differ from cv2's by the two
decoders' IDCT and chroma upsampling, a PNG's equal them.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device


def derive_rgb_path(
    thermal_path: str,
    thermal_dir: str = "thermal_8_bit",
    rgb_dir: str = "RGB",
    rgb_ext: str = ".jpg",
) -> str:
    marker = thermal_dir + "/"
    if marker not in thermal_path:
        raise ValueError(f"'{marker}' not in thermal path {thermal_path}")
    folder, name = thermal_path.split(marker, 1)
    return folder + rgb_dir + "/" + os.path.splitext(name)[0] + rgb_ext


def _read_image_cpu(file_name: str, format: str, rgb_file: Optional[str] = None) -> np.ndarray:
    import cv2

    if format in ("BGRT", "BGRTTT"):
        thermal = cv2.imread(file_name)
        if thermal is None:
            raise FileNotFoundError(file_name)
        rgb_path = rgb_file or derive_rgb_path(file_name)
        rgb = cv2.imread(rgb_path)
        if rgb is None:
            raise FileNotFoundError(rgb_path)
        rgb = cv2.resize(rgb, (thermal.shape[1], thermal.shape[0]))
        if format == "BGRT":
            out = np.zeros(thermal.shape[:2] + (4,), np.float32)
            out[:, :, :3] = rgb
            out[:, :, 3] = thermal[:, :, 0]
        else:
            out = np.zeros(thermal.shape[:2] + (6,), np.float32)
            out[:, :, :3] = rgb
            out[:, :, 3:] = thermal
        return out

    img = cv2.imread(file_name, cv2.IMREAD_COLOR if format != "L" else cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(file_name)
    if format == "L":
        return img[:, :, None].astype(np.float32)
    if format == "RGB":
        img = img[:, :, ::-1]
    return np.ascontiguousarray(img).astype(np.float32)


def read_image(file_name: str, format: str = "BGR",
               device: Union[str, torch.device] = "cuda",
               rgb_file: Optional[str] = None) -> Union[np.ndarray, torch.Tensor]:
    """HWC float32 image in the requested channel format, at the file's
    (for BGRT/BGRTTT: the thermal file's) resolution.

    format: BGR (3), RGB (3), L (1), BGRT (4: BGR+thermal), BGRTTT (6); on
    the card BGR, BGRT and BGRTTT. For BGRT/BGRTTT, ``file_name`` is the
    thermal image path and ``rgb_file`` the RGB one (default: derived from
    ``file_name`` by ``derive_rgb_path``). ``device="cpu"``: a numpy array,
    as the JAX package reads it; on the card: a CUDA tensor.
    """
    device = resolve_device(device)
    if device.type == "cpu":
        return _read_image_cpu(file_name, format, rgb_file)
    from ..native import io

    rgb = [rgb_file or derive_rgb_path(file_name)] if format in ("BGRT", "BGRTTT") else None
    with torch.cuda.device(device), io.JpegCodec() as codec:
        images, _, _ = io.load_batch(codec, [file_name], rgb, format, lambda h, w: (h, w))
    return images[0]
