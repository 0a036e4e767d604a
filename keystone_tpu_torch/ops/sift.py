"""Dense SIFT (counterpart of ``keystone_tpu/ops/sift.py``, matmul windowing).

Gradient → 8-orientation soft binning → per-axis triangular windowing and
4×4 bin extraction as two dense products with precomputed window
operators → the SIFT normalize (L2, clamp 0.2, re-L2) unless
``normalize=False``.  Descriptors are (n, Ky·Kx, 128) with an all-ones
mask; the feature order is (y_bin, x_bin, orientation), VLFeat's.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.ops.filters import separable_gaussian_blur
from keystone_tpu_torch.workflow.transformer import Transformer

_NUM_ORIENTATIONS = 8
_GRID = 4  # 4x4 spatial bins -> 128-d descriptors; feature f = gy·(4·8) + gx·8 + o


class SIFTExtractor(Transformer):
    """Dense SIFT descriptors on a keypoint grid.

    Input: grayscale images (n, H, W).  Output: ((n, K, 128), mask),
    K = Σ_scales Ky·Kx.  ``normalize=False`` emits the raw windowed
    descriptors for a consumer that normalizes them itself (the fused
    PCA/Fisher-vector kernel)."""

    fusable = False

    def __init__(
        self,
        step: int = 4,
        bin_sizes: Sequence[int] = (4,),
        smoothing_magnif: float = 6.0,
        normalize: bool = True,
    ):
        super().__init__()
        self.step = int(step)
        self.bin_sizes = tuple(int(b) for b in bin_sizes)
        #: VLFeat smoothing: each scale's image is blurred with
        #: σ = √((bin/magnif)² − 0.25) before the gradients; 0 disables
        self.smoothing_magnif = float(smoothing_magnif)
        self.normalize = bool(normalize)

    def params(self):
        return (self.step, self.bin_sizes, self.smoothing_magnif, self.normalize)

    def _sigma(self, bin_size: int) -> float:
        if self.smoothing_magnif <= 0:
            return 0.0
        s2 = (bin_size / self.smoothing_magnif) ** 2 - 0.25
        return float(np.sqrt(s2)) if s2 > 0.04 else 0.0

    def apply_batch(self, xs, mask=None):
        xs = xs.to(torch.float32)
        if xs.ndim == 4 and xs.shape[-1] == 1:
            xs = xs[..., 0]
        descs = [
            _dsift(xs, self.step, b, sigma=self._sigma(b), normalize=self.normalize)
            for b in self.bin_sizes
        ]
        out = torch.cat(descs, dim=1)
        return out, torch.ones(out.shape[:2], dtype=torch.float32, device=out.device)


def _triangular_kernel(bin_size: int) -> np.ndarray:
    """VLFeat's bilinear spatial window: support 2·bin_size−1."""
    r = np.arange(1 - bin_size, bin_size, dtype=np.float32)
    return np.maximum(0.0, 1.0 - np.abs(r) / bin_size)


def _bin_offsets(bin_size: int) -> np.ndarray:
    """The 4 bin-center offsets (truncation toward zero for odd bin
    sizes is part of the descriptor definition)."""
    return ((np.arange(_GRID) - (_GRID - 1) / 2.0) * bin_size).astype(np.int64)


def _keypoint_grid(extent: int, step: int, bin_size: int) -> np.ndarray:
    """Descriptor-center coordinates along one axis: centers whose
    support (c ± (2·bin_size − 0.5)) fits in the image."""
    margin = 2 * bin_size
    lo, hi = margin, extent - margin
    if hi <= lo:
        return np.zeros((0,), np.int32)
    return np.arange(lo, hi, step, dtype=np.int32)


def _window_matrix(extent: int, step: int, bin_size: int) -> Tuple[np.ndarray, int]:
    """Dense windowing operator A (num_centers·4, extent): row (c, b)
    holds the triangular window centered at keypoint-center c plus bin
    offset b, zero outside the image (≡ the SAME-padded conv followed by
    the strided bin slices)."""
    centers = _keypoint_grid(extent, step, bin_size)
    if centers.size == 0:
        return np.zeros((0, extent), np.float32), 0
    offs = _bin_offsets(bin_size)
    k1 = _triangular_kernel(bin_size)
    a = np.zeros((centers.size * _GRID, extent), np.float32)
    half = bin_size - 1
    for ci, c in enumerate(centers):
        for bi, off in enumerate(offs):
            mid = int(c + off)
            lo, hi = mid - half, mid + half + 1
            klo = max(0, -lo)
            khi = k1.size - max(0, hi - extent)
            a[ci * _GRID + bi, max(lo, 0) : min(hi, extent)] = k1[klo:khi]
    return a, centers.size


@functools.lru_cache(maxsize=64)
def _window_operator(extent: int, step: int, bin_size: int, device: torch.device):
    """``_window_matrix`` on ``device``, copied there once."""
    a, count = _window_matrix(extent, step, bin_size)
    return torch.from_numpy(a).to(device), count


def _gradient_orientation_map(imgs: torch.Tensor) -> torch.Tensor:
    """Gradient → 8-orientation soft binning: (n, h, w) → (n, h, w, 8).

    Central-difference gradients (vl_dsift's convention), then the
    magnitude linearly interpolated between the two adjacent bins."""
    dy = F.pad(imgs[:, 2:, :] - imgs[:, :-2, :], (0, 0, 1, 1)) * 0.5
    dx = F.pad(imgs[:, :, 2:] - imgs[:, :, :-2], (1, 1)) * 0.5
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)  # [-pi, pi]

    o = _NUM_ORIENTATIONS
    theta = torch.remainder(ang, 2 * math.pi) * (o / (2 * math.pi))  # [0, 8)
    lo_bin = torch.floor(theta)
    frac = theta - lo_bin
    lo_bin = torch.remainder(lo_bin.to(torch.int64), o)
    hi_bin = torch.remainder(lo_bin + 1, o)
    bins = torch.arange(o, device=imgs.device)
    return mag[..., None] * (
        (bins == lo_bin[..., None]) * (1.0 - frac[..., None])
        + (bins == hi_bin[..., None]) * frac[..., None]
    )


def _dsift(
    imgs: torch.Tensor,
    step: int,
    bin_size: int,
    sigma: float = 0.0,
    normalize: bool = True,
) -> torch.Tensor:
    n, h, w = imgs.shape
    if sigma > 0.0:
        imgs = separable_gaussian_blur(imgs[..., None], sigma)[..., 0]
    o = _NUM_ORIENTATIONS
    omap = _gradient_orientation_map(imgs)  # (n, h, w, 8)
    ay, ky = _window_operator(h, step, bin_size, imgs.device)
    ax, kx = _window_operator(w, step, bin_size, imgs.device)
    if ky == 0 or kx == 0:
        return torch.zeros((n, 0, _GRID * _GRID * o), device=imgs.device)
    r1 = torch.einsum("ph,nhwo->npwo", ay, omap)
    g = torch.einsum("qw,npwo->npqo", ax, r1)
    g = g.reshape(n, ky, _GRID, kx, _GRID, o)
    desc = g.permute(0, 1, 3, 2, 4, 5).reshape(n, ky * kx, _GRID * _GRID * o)
    return _sift_normalize(desc) if normalize else desc


def _sift_normalize(desc: torch.Tensor) -> torch.Tensor:
    """SIFT normalization: L2 → clamp 0.2 → L2 (eps 1e-8)."""

    def l2(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-8)

    desc = l2(desc)
    desc = torch.clamp(desc, max=0.2)
    return l2(desc)


def sift_output_count(h: int, w: int, step: int, bin_sizes: Sequence[int]) -> int:
    return sum(
        len(_keypoint_grid(h, step, b)) * len(_keypoint_grid(w, step, b))
        for b in bin_sizes
    )
