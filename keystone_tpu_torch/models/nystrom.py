"""Nyström kernel features (counterpart of ``keystone_tpu/models/nystrom.py``).

m landmark rows L sampled from the training set map

    φ(x) = K(x, L) · (K_LL + reg·m·I)^{−1/2}

so that φ(x)·φ(z)ᵀ ≈ K(x, z).  Both grams, K_LL at fit time and K(x, L)
at apply time, go through the gram kernel on the card; the reference
left the first to XLA's fusion of the generator chain.  Landmarks are
drawn from an in-memory array only: sampling from a stream
(``_sample_stream``) waits for the rest of the kernel tier (ROADMAP A6).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch.models.kernel_ridge import GaussianKernelGenerator
from keystone_tpu_torch.ops.gram_kernels import gram_block
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.transformer import Transformer


def _nystrom_whiten(lmk, gamma, reg, use_kernel=None):
    """(K_LL + reg·m·I)^{−1/2} by a symmetric eigendecomposition, with the
    eigenvalues clamped at 1e-12: K_LL is PSD up to rounding, and a tiny
    negative eigenvalue must not turn the whitening into NaNs."""
    m = lmk.shape[0]
    kmm = gram_block(lmk, lmk, gamma, use_kernel=use_kernel)
    kmm = 0.5 * (kmm + kmm.T) + reg * m * torch.eye(m, dtype=torch.float32, device=lmk.device)
    evals, evecs = torch.linalg.eigh(kmm)
    inv_sqrt = evecs * torch.rsqrt(torch.clamp(evals, min=1e-12))[None, :]
    return inv_sqrt @ evecs.T


class NystromFeatureMap(Transformer):
    """φ(x) = K(x, L)·W for fitted landmarks L and whitening W."""

    def __init__(self, kernel_gen, landmarks, whiten, use_kernel: Optional[bool] = None):
        super().__init__()
        self.kernel_gen = kernel_gen
        self.register_buffer("landmarks", landmarks)  # (m, d) f32
        self.register_buffer("whiten", whiten)  # (m, m) f32
        self.use_kernel = use_kernel

    def apply_batch(self, xs, mask=None):
        mode = precision.apply_mode()
        knm = gram_block(xs.to(torch.float32), self.landmarks, float(self.kernel_gen.gamma),
                         mxu=mode, use_kernel=self.use_kernel)
        return precision.apply_dot(knm, self.whiten, mode=mode)


class NystromFeatures:
    """Landmark sampling and the whitening solve; the fitted transformer
    is a ``NystromFeatureMap``.  ``num_landmarks`` rows are drawn
    uniformly without replacement by ``np.random.default_rng(seed)``,
    exactly as the reference draws them, so both pick the same rows."""

    def __init__(self, kernel_gen: GaussianKernelGenerator, num_landmarks: int = 1024,
                 reg: float = 1e-6, seed: int = 0, use_kernel: Optional[bool] = None):
        self.kernel_gen = kernel_gen
        self.num_landmarks = int(num_landmarks)
        self.reg = float(reg)
        self.seed = int(seed)
        self.use_kernel = use_kernel

    def fit_arrays(self, x, device="cuda") -> NystromFeatureMap:
        """x: (n, d), numpy or a tensor; fitted on ``device``."""
        x = torch.as_tensor(x, dtype=torch.float32).to(resolve_device(device))
        n = x.shape[0]
        m = min(self.num_landmarks, n)
        idx = np.sort(np.random.default_rng(self.seed).choice(n, size=m, replace=False))
        return self._fit_landmarks(x[torch.from_numpy(idx).to(x.device)])

    def _fit_landmarks(self, lmk: torch.Tensor) -> NystromFeatureMap:
        lmk = lmk.to(torch.float32).contiguous()
        whiten = _nystrom_whiten(lmk, float(self.kernel_gen.gamma), self.reg, self.use_kernel)
        return NystromFeatureMap(self.kernel_gen, lmk, whiten, self.use_kernel)
