"""PCA (counterpart of ``keystone_tpu/models/pca.py`` § PCATransformer,
PCAEstimator, _pca_fit, _pca_masked).

The fit is the SVD of the centred rows, as the reference's; ragged
descriptor sets take the masked branch, the eigendecomposition of the
masked covariance.  The SVD's column signs are arbitrary, here and in
the reference alike, so two fits agree in the projector C·Cᵀ, and in C
only up to each column's sign.  ``DistributedPCAEstimator`` waits for
the port's parallel layer (ROADMAP A8).
"""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.estimator import Estimator
from keystone_tpu_torch.workflow.transformer import Transformer, tensor_identity

def svd_driver(x) -> Optional[str]:
    """cuSOLVER's SVD for the fit of x (``torch.linalg.svd``'s ``driver``,
    CUDA only; None on the CPU): ``gesvda`` for a tall matrix, the shape
    of every sample the fits take, and the QR-based ``gesvd`` otherwise
    (``gesvda`` takes tall matrices only).  On an H100, on the
    ImageNetSiftLcsFV fit's two samples (131 072 × 128 and × 96) and on
    made samples of that shape with singular values falling from 1 to
    1e-6, with and without a 1% gap at the 64th, ``gesvda``'s rank-64
    projector was 1.5e-8 to 2.7e-8 from a float64 SVD's and ``gesvd``'s
    1.2e-6 to 5.7e-6, in a fifth of the time; the default (``gesvdj``)
    was 1.7e-5 to 3.3e-5 (``keystone_tpu_torch/tools/svd_drivers.py``,
    PERF.md)."""
    if not x.is_cuda:
        return None
    return "gesvda" if x.shape[-2] >= x.shape[-1] else "gesvd"


class PCATransformer(Transformer):
    """Projects onto the fitted principal directions: x ↦ (x − μ)·C."""

    def __init__(self, components: torch.Tensor, mean: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("components", components)  # (d_in, d)
        self.register_buffer("mean", mean)  # (d_in,) or None

    def params(self):
        return tensor_identity(self.components, self.mean)

    def apply_batch(self, xs, mask=None):
        if self.mean is not None:
            xs = xs - self.mean
        out = torch.matmul(xs.to(torch.float32), self.components)
        return (out, mask) if mask is not None else out


class PCAEstimator(Estimator):
    """SVD-based PCA of the given rows (PCA.scala § PCAEstimator)."""

    def __init__(self, dims: int, center: bool = True):
        self.dims = int(dims)
        self.center = center

    def params(self):
        return (self.dims, self.center)

    def fit_dataset(self, data: Dataset) -> PCATransformer:
        """Rows (n, d), or ragged (n, T, d) sets with a mask (the masked
        branch), fitted in f32 on the data's device."""
        x = data.array.to(torch.float32)
        if data.mask is not None:
            comp, mean = _pca_masked(x, data.mask.to(torch.float32), self.dims, self.center)
        else:
            comp, mean = _pca_fit(x, data.n, self.dims, self.center)
        return PCATransformer(comp, mean if self.center else None)

    def fit_arrays(self, x, mask=None, device="cuda") -> PCATransformer:
        """x: (n, d) rows, or ragged (n, T, d) sets with an (n, T) ``mask``
        (the reference's ``fit_dataset`` on a masked Dataset); numpy or
        tensors, fitted in f32 on ``device``."""
        dev = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        if mask is not None:
            comp, mean = _pca_masked(x, torch.as_tensor(mask, dtype=torch.float32).to(dev),
                                     self.dims, self.center)
        else:
            comp, mean = _pca_fit(x, x.shape[0], self.dims, self.center)
        return PCATransformer(comp, mean if self.center else None)


def _svd_vh(xc):
    driver = svd_driver(xc)
    try:
        return torch.linalg.svd(xc, full_matrices=False, driver=driver).Vh
    except torch.linalg.LinAlgError:
        if driver != "gesvda":
            raise
        # gesvda reports no convergence on a rank-deficient sample (the
        # descriptors of flat-coloured images: repeated zero singular
        # values); the QR-based gesvd takes it
        return torch.linalg.svd(xc, full_matrices=False, driver="gesvd").Vh


def _pca_fit(x, n, dims: int, center: bool):
    """(components (d, dims), mean) of the first ``n`` rows of x (rows
    past n are padding and masked out of the centred matrix)."""
    mean = torch.sum(x, dim=0) / n
    row_ok = (torch.arange(x.shape[0], device=x.device) < n).to(x.dtype)[:, None]
    xc = (x - mean) * row_ok if center else x
    return _svd_vh(xc)[:dims].T.contiguous(), mean


def _pca_masked(x, mask, dims: int, center: bool):
    """The reference's masked branch: eigh of the covariance of the rows
    the mask keeps, components in descending eigenvalue order."""
    if x.ndim == 3:  # ragged (n, T, d) + (n, T) mask
        x = x.reshape(-1, x.shape[-1])
        mask = mask.reshape(-1)
    w = (mask > 0).to(x.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = (w @ x) / n
    xc = (x - mean) * w[:, None] if center else x * w[:, None]
    cov = (xc.T @ xc) / n
    _, evecs = torch.linalg.eigh(cov)
    return torch.flip(evecs, dims=(1,))[:, :dims].contiguous(), mean
