"""Local Color Statistics descriptors (counterpart of
``keystone_tpu/ops/lcs.py``).

Per keypoint on a dense grid, the patch around it is divided into 4×4
subpatches and the descriptor concatenates each subpatch's per-channel
mean and standard deviation (dim = 2·C·16; 96 for RGB).  The subpatch
box sums are ``avg_pool2d`` with a divisor of 1, the same VALID stride-1
sums as the reference's ``reduce_window``.
"""

from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.utils.device import device_cache
from keystone_tpu_torch.workflow.transformer import Transformer

_GRID = 4


class LCSExtractor(Transformer):
    """Input: (n, H, W, C) images.  Output: ((n, K, 2·C·16), mask)."""

    fusable = False

    def __init__(self, step: int = 4, subpatch_size: int = 6):
        super().__init__()
        self.step = int(step)
        self.subpatch_size = int(subpatch_size)

    def params(self):
        return (self.step, self.subpatch_size)

    def apply_batch(self, xs, mask=None):
        xs = xs.to(torch.float32)
        if xs.ndim == 3:
            xs = xs[..., None]
        out = _lcs(xs, self.step, self.subpatch_size)
        return out, torch.ones(out.shape[:2], dtype=torch.float32, device=out.device)


def _lcs_grid(extent: int, step: int, sub: int) -> np.ndarray:
    margin = 2 * sub  # patch = 4x4 subpatches of size sub
    lo, hi = margin, extent - margin
    if hi <= lo:
        return np.zeros((0,), np.int32)
    return np.arange(lo, hi, step, dtype=np.int32)


@device_cache(maxsize=64)
def _gather_index(extent: int, step: int, sub: int, device: torch.device):
    """Subpatch top-left corners of every keypoint along one axis:
    (grid, 4) flattened; offsets (-2, -1, 0, 1)·sub."""
    grid = _lcs_grid(extent, step, sub).astype(np.int64)
    offs = (np.arange(_GRID) - _GRID // 2) * sub
    idx = (grid[:, None] + offs[None, :]).reshape(-1)
    return torch.from_numpy(idx).to(device), grid.size


def _lcs(xs: torch.Tensor, step: int, sub: int) -> torch.Tensor:
    n, h, w, c = xs.shape
    yy, ky = _gather_index(h, step, sub, xs.device)
    xx, kx = _gather_index(w, step, sub, xs.device)
    if ky == 0 or kx == 0:  # no keypoint fits, as in an image smaller than a subpatch
        return torch.zeros((n, 0, _GRID * _GRID * 2 * c), device=xs.device)
    area = float(sub * sub)
    x = xs.permute(0, 3, 1, 2)  # NCHW for the pooling
    # VALID stride-1 box sums: index (y, x) = sum of the sub×sub box
    # whose top-left corner is (y, x)
    s1 = F.avg_pool2d(x, sub, stride=1, divisor_override=1)
    s2 = F.avg_pool2d(x * x, sub, stride=1, divisor_override=1)
    mean = s1 / area
    var = torch.clamp(s2 / area - mean * mean, min=0.0)
    std = torch.sqrt(var)
    feat = torch.cat([mean, std], dim=1).permute(0, 2, 3, 1)  # (n, h', w', 2C)
    g = feat[:, yy][:, :, xx]  # (n, Ky*4, Kx*4, 2C)
    g = g.reshape(n, ky, _GRID, kx, _GRID, 2 * c)
    return g.permute(0, 1, 3, 2, 4, 5).reshape(n, ky * kx, _GRID * _GRID * 2 * c)
