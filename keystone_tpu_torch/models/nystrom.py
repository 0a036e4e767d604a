"""Nyström kernel features (counterpart of ``keystone_tpu/models/nystrom.py``).

m landmark rows L sampled from the training set map

    φ(x) = K(x, L) · (K_LL + reg·m·I)^{−1/2}

so that φ(x)·φ(z)ᵀ ≈ K(x, z).  Both grams, K_LL at fit time and K(x, L)
at apply time, go through the gram kernel on the card; the reference
left the first to XLA's fusion of the generator chain.  Fitted from a
``StreamDataset``, the landmarks are collected in one pass over its
batches (``_sample_stream``), the same rows the in-memory draw picks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch.models.kernel_ridge import GaussianKernelGenerator
from keystone_tpu_torch.ops.gram_kernels import gram_block
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.estimator import Estimator
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


class NystromFeatures(Estimator):
    """Landmark sampling and the whitening solve; the fitted transformer
    is a ``NystromFeatureMap``.  ``num_landmarks`` rows are drawn
    uniformly without replacement by ``np.random.default_rng(seed)``,
    exactly as the reference draws them, so both pick the same rows;
    from a stream, the draw is made against its known row count and the
    rows collected in one pass, so the stream never materializes."""

    def __init__(self, kernel_gen: GaussianKernelGenerator, num_landmarks: int = 1024,
                 reg: float = 1e-6, seed: int = 0, use_kernel: Optional[bool] = None):
        self.kernel_gen = kernel_gen
        self.num_landmarks = int(num_landmarks)
        self.reg = float(reg)
        self.seed = int(seed)
        self.use_kernel = use_kernel

    def params(self):
        return (self.kernel_gen.gamma, self.num_landmarks, self.reg, self.seed)

    def _draw(self, n: int) -> np.ndarray:
        m = min(self.num_landmarks, n)
        return np.sort(np.random.default_rng(self.seed).choice(n, size=m, replace=False))

    def fit_dataset(self, data: Dataset) -> NystromFeatureMap:
        """The fit on the data's device; a stream is sampled in one pass."""
        if data.is_host:
            raise TypeError("host-payload data reached NystromFeatures; featurize to arrays before the fit")
        if isinstance(data, StreamDataset):
            return self._fit_landmarks(self._sample_stream(data))
        x = data.array[:data.n]
        return self._fit_landmarks(x[torch.from_numpy(self._draw(data.n)).to(x.device)])

    def fit_arrays(self, x, device="cuda") -> NystromFeatureMap:
        """x: (n, d), numpy or a tensor; fitted on ``device``."""
        x = torch.as_tensor(x, dtype=torch.float32).to(resolve_device(device))
        return self._fit_landmarks(x[torch.from_numpy(self._draw(x.shape[0])).to(x.device)])

    def _sample_stream(self, data: StreamDataset) -> torch.Tensor:
        """The rows the in-memory draw picks, gathered batch by batch on
        the stream's device; the sweep stops after the last of them.
        Raises when the stream delivers too few rows."""
        idx = self._draw(data.n)
        m = idx.shape[0]
        rows, lo, take = [], 0, 0
        for arr, _ in data.device_batches():
            hi = lo + arr.shape[0]
            stop = int(np.searchsorted(idx, hi))
            if stop > take:
                rows.append(arr[torch.from_numpy(idx[take:stop] - lo).to(arr.device)])
                take = stop
            lo = hi
            if take >= m:
                break
        if take < m:
            raise ValueError(f"stream delivered {lo} rows; cannot sample {m} landmarks from a declared n={data.n}")
        return torch.cat(rows)

    def _fit_landmarks(self, lmk: torch.Tensor) -> NystromFeatureMap:
        lmk = lmk.to(torch.float32).contiguous()
        whiten = _nystrom_whiten(lmk, float(self.kernel_gen.gamma), self.reg, self.use_kernel)
        return NystromFeatureMap(self.kernel_gen, lmk, whiten, self.use_kernel)
