"""DAISY dense descriptors (counterpart of ``keystone_tpu/ops/daisy.py``).

Oriented-gradient maps (rectified directional gradients), Gaussian
pooling at growing scales (one separable blur a scale,
``ops/filters.py``), sampled at a centre and on concentric rings by fixed
index gathers; each orientation histogram L2-normalized (Tola et al.
2010).  Descriptor dim = (1 + rings·ring_points)·orientations (default
(1 + 3·8)·8 = 200).  Plain torch: the reference computes it in XLA,
outside any Pallas kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.ops.filters import separable_gaussian_blur
from keystone_tpu_torch.workflow.transformer import Transformer


class DaisyExtractor(Transformer):
    """Input: grayscale (n, H, W).  Output: ((n, K, D), mask), K the grid
    of centres ``step`` apart that the outer ring leaves inside the image."""

    fusable = False

    def __init__(self, step: int = 4, radius: int = 15, rings: int = 3, ring_points: int = 8, orientations: int = 8):
        super().__init__()
        self.step = int(step)
        self.radius = int(radius)
        self.rings = int(rings)
        self.ring_points = int(ring_points)
        self.orientations = int(orientations)

    def params(self):
        return (self.step, self.radius, self.rings, self.ring_points, self.orientations)

    @property
    def descriptor_dim(self) -> int:
        return (1 + self.rings * self.ring_points) * self.orientations

    def apply_batch(self, xs, mask=None):
        xs = xs.to(torch.float32)
        if xs.ndim == 4 and xs.shape[-1] == 1:
            xs = xs[..., 0]
        out = _daisy(xs, self.step, self.radius, self.rings, self.ring_points, self.orientations)
        return out, torch.ones(out.shape[:2], dtype=torch.float32, device=out.device)

    def apply_one(self, x):
        return self.apply_batch(torch.as_tensor(x)[None])[0][0]


def _sep_gauss(omap: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (n, h, w, o) maps."""
    return separable_gaussian_blur(omap, sigma)


def _daisy(imgs: torch.Tensor, step: int, radius: int, rings: int, ring_points: int, orients: int) -> torch.Tensor:
    n, h, w = imgs.shape
    dy = F.pad(imgs[:, 2:, :] - imgs[:, :-2, :], (0, 0, 1, 1)) * 0.5
    dx = F.pad(imgs[:, :, 2:] - imgs[:, :, :-2], (1, 1)) * 0.5
    # oriented gradient maps: max(0, cos(θ − o_k))·|g| == max(0, g·u_k)
    angles = np.arange(orients) * 2.0 * np.pi / orients
    ux = torch.from_numpy(np.cos(angles).astype(np.float32)).to(device=imgs.device, dtype=imgs.dtype)
    uy = torch.from_numpy(np.sin(angles).astype(np.float32)).to(device=imgs.device, dtype=imgs.dtype)
    omap = torch.clamp(dx[..., None] * ux + dy[..., None] * uy, min=0.0)

    # Gaussian pooling a ring (σ grows with the radius, as in DAISY)
    ring_radii = [radius * (i + 1) / rings for i in range(rings)]
    sigmas = [max(0.5, rr / 2.0) for rr in [radius / rings] + ring_radii[:-1]]
    center_sigma = max(0.5, radius / (2.0 * rings))
    blurred = [_sep_gauss(omap, center_sigma)]
    for s in sigmas[1:] + [max(0.5, ring_radii[-1] / 2.0)]:
        blurred.append(_sep_gauss(omap, s))

    margin = int(radius + 3 * max(0.5, ring_radii[-1] / 2.0)) + 1
    ys = np.arange(margin, h - margin, step, dtype=np.int64)
    xs_ = np.arange(margin, w - margin, step, dtype=np.int64)
    if len(ys) == 0 or len(xs_) == 0:
        return torch.zeros((n, 0, (1 + rings * ring_points) * orients), dtype=torch.float32, device=imgs.device)

    def sample(bmap, oy: int, ox: int):
        iy = torch.from_numpy(ys + oy).to(imgs.device)
        ix = torch.from_numpy(xs_ + ox).to(imgs.device)
        return bmap[:, iy][:, :, ix]

    pieces = [sample(blurred[0], 0, 0)]
    for ri, rr in enumerate(ring_radii):
        bmap = blurred[min(ri + 1, len(blurred) - 1)]
        for p in range(ring_points):
            a = 2.0 * np.pi * p / ring_points
            pieces.append(sample(bmap, int(round(rr * math.sin(a))), int(round(rr * math.cos(a)))))
    stacked = torch.stack(pieces, dim=3)  # (n, Ky, Kx, P, o)
    kk = len(ys) * len(xs_)
    # per-histogram L2 normalization (DAISY normalizes each histogram)
    dd = stacked.reshape(n, kk, -1, orients)
    dd = dd / torch.clamp(torch.linalg.vector_norm(dd, dim=-1, keepdim=True), min=1e-8)
    return dd.reshape(n, kk, -1)
