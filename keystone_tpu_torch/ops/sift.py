"""Dense SIFT (counterpart of ``keystone_tpu/ops/sift.py``).

Gradient → 8-orientation soft binning → per-axis triangular windowing and
4×4 bin extraction → the SIFT normalize (L2, clamp 0.2, re-L2) unless
``normalize=False``.  The windowing is ``"matmul"`` by default: two dense
products with precomputed window operators; ``"conv"`` is the reference's
other form, a depthwise convolution a axis (cuDNN, TF32 off) then strided
bin slices, with the pre-smoothing as convolutions too.  The two are one
linear map and agree to f32 rounding.  Descriptors are (n, Ky·Kx, 128)
with an all-ones mask; the feature order is (y_bin, x_bin, orientation),
VLFeat's.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.ops.filters import separable_gaussian_blur
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import device_cache
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
    #: pickles made before the conv windowing existed ran the matmul form
    windowing = "matmul"

    def __init__(
        self,
        step: int = 4,
        bin_sizes: Sequence[int] = (4,),
        smoothing_magnif: float = 6.0,
        windowing: str = "matmul",
        normalize: bool = True,
    ):
        super().__init__()
        if windowing not in ("conv", "matmul"):
            raise ValueError(f"unknown SIFT windowing {windowing!r}")
        self.step = int(step)
        self.bin_sizes = tuple(int(b) for b in bin_sizes)
        #: VLFeat smoothing: each scale's image is blurred with
        #: σ = √((bin/magnif)² − 0.25) before the gradients; 0 disables
        self.smoothing_magnif = float(smoothing_magnif)
        self.windowing = windowing
        self.normalize = bool(normalize)

    def params(self):
        return (self.step, self.bin_sizes, self.smoothing_magnif, self.windowing, self.normalize)

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
            _dsift(xs, self.step, b, sigma=self._sigma(b), windowing=self.windowing, normalize=self.normalize)
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


@device_cache(maxsize=64)
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
    windowing: str = "matmul",
    normalize: bool = True,
) -> torch.Tensor:
    n, h, w = imgs.shape
    if sigma > 0.0:
        # the blur takes the windowing's form, as in the reference
        imgs = separable_gaussian_blur(imgs[..., None], sigma, strategy=windowing)[..., 0]
    o = _NUM_ORIENTATIONS
    omap = _gradient_orientation_map(imgs)  # (n, h, w, 8)
    if windowing == "conv":
        desc = _conv_windowing(omap, step, bin_size)
        return _sift_normalize(desc) if normalize else desc
    ay, ky = _window_operator(h, step, bin_size, imgs.device)
    ax, kx = _window_operator(w, step, bin_size, imgs.device)
    if ky == 0 or kx == 0:
        return torch.zeros((n, 0, _GRID * _GRID * o), device=imgs.device)
    r1 = torch.einsum("ph,nhwo->npwo", ay.to(omap.dtype), omap)
    g = torch.einsum("qw,npwo->npqo", ax.to(omap.dtype), r1)
    g = g.reshape(n, ky, _GRID, kx, _GRID, o)
    desc = g.permute(0, 1, 3, 2, 4, 5).reshape(n, ky * kx, _GRID * _GRID * o)
    return _sift_normalize(desc) if normalize else desc


def _conv_windowing(omap: torch.Tensor, step: int, bin_size: int) -> torch.Tensor:
    """The reference's conv windowing: the triangular window as a
    depthwise convolution along each axis (SAME zero padding), then the
    4×4 bins around each keypoint as 16 strided slices (centres and bin
    offsets are both uniform grids).  (n, h, w, 8) → (n, Ky·Kx, 128)."""
    n, h, w, o = omap.shape
    ys = _keypoint_grid(h, step, bin_size)
    xs = _keypoint_grid(w, step, bin_size)
    if ys.size == 0 or xs.size == 0:  # the scale is too large for the image
        return torch.zeros((n, 0, _GRID * _GRID * o), device=omap.device)
    k1 = torch.from_numpy(_triangular_kernel(bin_size)).to(device=omap.device, dtype=omap.dtype)
    r = bin_size - 1
    x = omap.permute(0, 3, 1, 2)  # NCHW, one group an orientation
    with precision.f32_convolutions():  # cuDNN's default TF32 keeps ~3 digits
        x = F.conv2d(x, k1.view(1, 1, -1, 1).repeat(o, 1, 1, 1), padding=(r, 0), groups=o)
        x = F.conv2d(x, k1.view(1, 1, 1, -1).repeat(o, 1, 1, 1), padding=(0, r), groups=o)
    smoothed = x.permute(0, 2, 3, 1)  # (n, h, w, 8)
    offs = _bin_offsets(bin_size)

    def bin_slices(arr, centers, axis):
        """(…, len(centers), _GRID, …): one strided slice a bin offset."""
        lead = (slice(None),) * axis
        parts = [arr[lead + (slice(int(centers[0] + off), int(centers[-1] + off) + 1, step),)] for off in offs]
        return torch.stack(parts, dim=axis + 1)

    g = bin_slices(smoothed, ys, 1)  # (n, ky, 4, w, 8)
    g = bin_slices(g, xs, 3)  # (n, ky, 4, kx, 4, 8)
    return g.permute(0, 1, 3, 2, 4, 5).reshape(n, ys.size * xs.size, _GRID * _GRID * o)


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
