"""Separable Gaussian blur (counterpart of ``keystone_tpu/ops/filters.py``).

The 1-D SAME-zero-padded convolution along an axis is a linear map, so
each pass is one dense product with an (extent, extent) banded operator,
which cuBLAS runs in true f32.  Above ``_MATMUL_BLUR_MAX_EXTENT`` the
dense operator's O(extent³) per axis stops paying, and the blur is two
depthwise convolutions (``conv2d`` with ``groups=c``) with the same taps,
as the reference's conv path, run in true f32 on the card whatever
cuDNN's global TF32 flag says.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import device_cache


def gaussian_kernel1d(sigma: float, truncate: float = 3.0) -> np.ndarray:
    """Normalized 1-D Gaussian, radius ⌈truncate·σ⌉ (≥1)."""
    r = max(1, int(np.ceil(truncate * sigma)))
    xs = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return k / k.sum()


@functools.lru_cache(maxsize=64)
def _blur_matrix(extent: int, sigma: float, truncate: float = 3.0) -> np.ndarray:
    """(extent, extent) banded operator ≡ the SAME-zero-padded 1-D
    Gaussian conv along one axis: row i holds the kernel centered at i,
    truncated at the image edge without renormalization."""
    k1 = gaussian_kernel1d(sigma, truncate)
    r = (k1.size - 1) // 2
    b = np.zeros((extent, extent), np.float32)
    for i in range(extent):
        lo, hi = i - r, i + r + 1
        klo = max(0, -lo)
        khi = k1.size - max(0, hi - extent)
        b[i, max(lo, 0) : min(hi, extent)] = k1[klo:khi]
    return b


@device_cache(maxsize=64)
def _blur_operator(extent: int, sigma: float, device: torch.device) -> torch.Tensor:
    """``_blur_matrix`` on ``device``, copied there once."""
    return torch.from_numpy(_blur_matrix(extent, sigma)).to(device)


#: the reference's limit for the banded form (above it the dense operator
#: costs O(extent³) per axis and the reference uses a convolution)
_MATMUL_BLUR_MAX_EXTENT = 512


def separable_apply(bh: torch.Tensor, bw: torch.Tensor, x: torch.Tensor):
    """out = bh · x · bwᵀ per channel, for (n, h, w, c) maps."""
    out = torch.einsum("ph,nhwc->npwc", bh, x)
    return torch.einsum("qw,npwc->npqc", bw, out)


def separable_gaussian_blur(x: torch.Tensor, sigma: float, strategy: str = "matmul") -> torch.Tensor:
    """Separable Gaussian blur of (n, h, w, c) maps, SAME zero padding:
    ``strategy="matmul"`` (the default) as banded products up to
    ``_MATMUL_BLUR_MAX_EXTENT`` and depthwise convolutions above it;
    ``"conv"`` as depthwise convolutions at any extent (SIFT's conv
    windowing, as in the reference)."""
    h, w = x.shape[1], x.shape[2]
    if strategy not in ("matmul", "conv"):
        raise ValueError(f"unknown blur strategy {strategy!r}")
    if strategy == "matmul" and max(h, w) <= _MATMUL_BLUR_MAX_EXTENT:
        bh = _blur_operator(h, float(sigma), x.device).to(x.dtype)
        bw = _blur_operator(w, float(sigma), x.device).to(x.dtype)
        return separable_apply(bh, bw, x)
    c = x.shape[-1]
    k1 = torch.from_numpy(gaussian_kernel1d(sigma)).to(device=x.device, dtype=x.dtype)
    r = (k1.numel() - 1) // 2
    out = x.permute(0, 3, 1, 2)  # NCHW, one group a channel
    with precision.f32_convolutions():  # cuDNN's default TF32 keeps ~3 digits
        out = F.conv2d(out, k1.view(1, 1, -1, 1).repeat(c, 1, 1, 1), padding=(r, 0), groups=c)
        out = F.conv2d(out, k1.view(1, 1, 1, -1).repeat(c, 1, 1, 1), padding=(0, r), groups=c)
    return out.permute(0, 2, 3, 1)
