"""ZCA whitening (counterpart of ``keystone_tpu/models/zca.py`` § ZCAWhitener,
ZCAWhitenerEstimator, _zca_fit; reference nodes/images/ZCAWhitener.scala).

The whitening map W = V·(Λ + εI)^(−1/2)·Vᵀ from the eigendecomposition
of the centred covariance, so whitened patches stay in the input's
coordinates (RandomPatchCifar whitens its random patches before they
become filters).
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.models.common import gram, row_blocks
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.estimator import Estimator
from keystone_tpu_torch.workflow.transformer import Transformer, tensor_identity


class ZCAWhitener(Transformer):
    """(x − mean)·W."""

    def __init__(self, whitener: torch.Tensor, mean: torch.Tensor):
        super().__init__()
        self.register_buffer("whitener", whitener)  # (d, d)
        self.register_buffer("mean", mean)  # (d,)

    def params(self):
        return tensor_identity(self.whitener, self.mean)

    def apply_batch(self, xs, mask=None):
        return (xs - self.mean) @ self.whitener


class ZCAWhitenerEstimator(Estimator):
    def __init__(self, eps: float = 1e-1):
        self.eps = float(eps)

    def params(self):
        return (self.eps,)

    def fit_dataset(self, data: Dataset) -> ZCAWhitener:
        """The fit on the rows' device."""
        return ZCAWhitener(*_zca_fit(data.array[:data.n], self.eps))

    def fit_arrays(self, x, device="cuda") -> ZCAWhitener:
        """x: (n, d), numpy or a tensor; fitted on ``device``."""
        return ZCAWhitener(*_zca_fit(torch.as_tensor(x).to(resolve_device(device)), self.eps))


def _zca_fit(x, eps: float):
    """(whitener, mean) of x (n, d) in f32: the covariance of the explicitly
    centred rows (``gram``'s blocked true-f32 products), then ``eigh``."""
    x = x.to(torch.float32)
    n = x.shape[0]
    mean = x.sum(dim=0) / n
    cov = gram(row_blocks(x), center=(mean, None))[0] / n
    evals, evecs = torch.linalg.eigh(cov)
    inv_sqrt = 1.0 / torch.sqrt(torch.clamp(evals, min=0.0) + eps)
    return (evecs * inv_sqrt) @ evecs.T, mean
