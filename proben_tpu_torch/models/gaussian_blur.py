"""Separable Gaussian blur (counterpart of ``proben_tpu/models/gaussian_blur.py``;
reference ``modeling/meta_arch/gaussian_blur.py:86,152``): the MODEL.BLUR_RGB
middle-fusion ablation that smooths the RGB stream's feature maps before
fusion."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def gaussian_kernel_1d(size: int, sigma: float) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    k = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return k / torch.sum(k)


def gaussian_blur(
    x: torch.Tensor,  # (N, C, H, W), channels_last memory as every feature map
    kernel_size: Tuple[int, int] = (5, 5),
    sigma: Tuple[float, float] = (3.0, 3.0),
) -> torch.Tensor:
    """Depthwise separable Gaussian blur (same-padding, zeros outside), in
    ``x``'s dtype: the vertical pass, then the horizontal one."""
    c = x.shape[1]
    kh, kw = kernel_size
    ky = gaussian_kernel_1d(kh, sigma[0]).to(x.device, x.dtype).view(1, 1, kh, 1).expand(c, 1, kh, 1)
    kx = gaussian_kernel_1d(kw, sigma[1]).to(x.device, x.dtype).view(1, 1, 1, kw).expand(c, 1, 1, kw)
    out = F.conv2d(x, ky, padding=(kh // 2, 0), groups=c)
    return F.conv2d(out, kx, padding=(0, kw // 2), groups=c)
