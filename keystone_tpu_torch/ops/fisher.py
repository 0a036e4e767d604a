"""Fisher-vector encoding (counterpart of ``keystone_tpu/ops/fisher.py``).

FV of a descriptor set {x_t} against a diagonal GMM (w, μ, σ²)
(Perronnin–Sánchez improved Fisher vector):

    γ_tk   = posterior responsibility of component k for x_t
    Φ¹_k   = 1/(T·√w_k)    · Σ_t γ_tk (x_t − μ_k)/σ_k
    Φ²_k   = 1/(T·√(2w_k)) · Σ_t γ_tk ((x_t − μ_k)²/σ²_k − 1)

concatenated to a 2·K·D vector per image.  Power and L2 normalization
are the separate SignedHellingerMapper / NormalizeRows stages.

The reference picks its Pallas kernel by a T·K crossover measured on a
TPU, and otherwise the XLA chain; the crossover is dropped here.  With
``use_kernel=None`` (the default) both transformers launch their kernel
for a CUDA tensor, whatever the GMM's shape (``fisher_kernels`` takes
every shape), and run the plain per-stage chain on the CPU.
``use_kernel=True`` asks for the kernel (on a CPU tensor the wrapper
takes its plain version); ``use_kernel=False`` runs the plain chain.
"""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.models.gmm import GaussianMixtureModel, GaussianMixtureModelEstimator
from keystone_tpu_torch.models.pca import PCATransformer
from keystone_tpu_torch.ops import fisher_kernels
from keystone_tpu_torch.ops.fisher_kernels import fisher_encode_ref as _fisher_encode
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.estimator import Estimator
from keystone_tpu_torch.workflow.transformer import Transformer, tensor_identity

__all__ = ["FisherVector", "FusedPcaFisherVector", "GMMFisherVectorEstimator", "_fisher_encode"]


def _batch(xs, mask):
    """(n, T, d) descriptors and an f32 (n, T) mask; a single (T, d)
    set becomes a batch of one."""
    squeeze = xs.ndim == 2
    if squeeze:
        xs = xs[None]
    if mask is None:
        mask = torch.ones(xs.shape[:2], dtype=torch.float32, device=xs.device)
    elif squeeze and mask.ndim == 1:
        mask = mask[None]
    return xs, mask.to(torch.float32).contiguous(), squeeze


def _use_kernel(flag: Optional[bool], xs) -> bool:
    return xs.is_cuda if flag is None else flag


class FisherVector(Transformer):
    """Input: ragged ((n, T, d), mask) descriptor sets.
    Output: dense (n, 2·K·D) Fisher vectors."""

    fusable = False

    def __init__(self, gmm: GaussianMixtureModel, use_kernel: Optional[bool] = None):
        super().__init__()
        self.gmm = gmm
        self.use_kernel = use_kernel

    def params(self):
        g = self.gmm
        return (tensor_identity(g.weights, g.means, g.variances), self.use_kernel)

    def apply_batch(self, xs, mask=None):
        xs, mask, squeeze = _batch(xs, mask)
        g = self.gmm
        if _use_kernel(self.use_kernel, xs):
            out = fisher_kernels.fisher_encode(
                xs.to(precision.fdtype()).contiguous(), mask, g.weights, g.means, g.variances
            )
        else:
            out = _fisher_encode(xs, mask, g.weights, g.means, g.variances)
        return out[0] if squeeze else out


class FusedPcaFisherVector(Transformer):
    """[SIFT normalize →] PCA projection → Fisher-vector encode as one
    kernel launch — the node the reference optimizer's
    ``PallasFvFusionRule`` builds from a ``PCATransformer → FisherVector``
    pair.  ``sift_normalize=True`` absorbs SIFT's L2→clamp→re-L2 tail,
    so it takes RAW windowed SIFT descriptors.  Not fusable: like
    FisherVector it reduces ragged (descriptors, mask) sets."""

    fusable = False

    def __init__(
        self,
        pca: PCATransformer,
        gmm: GaussianMixtureModel,
        sift_normalize: bool = False,
        use_kernel: Optional[bool] = None,
    ):
        super().__init__()
        self.register_buffer("components", pca.components)  # (d_in, d)
        self.register_buffer("mean", pca.mean)  # (d_in,) or None
        self.gmm = gmm
        self.sift_normalize = bool(sift_normalize)
        self.use_kernel = use_kernel

    @property
    def label(self) -> str:
        tail = "SiftNorm > PCA > FV" if self.sift_normalize else "PCA > FV"
        return f"FusedFV[{tail}]"

    def params(self):
        g = self.gmm
        ids = tensor_identity(self.components, self.mean, g.weights, g.means, g.variances)
        return (ids, self.sift_normalize, self.use_kernel)

    def apply_batch(self, xs, mask=None):
        xs, mask, squeeze = _batch(xs, mask)
        g = self.gmm
        if _use_kernel(self.use_kernel, xs):
            out = fisher_kernels.fused_forward(
                xs.to(precision.fdtype()).contiguous(), mask, self.components, self.mean,
                g.weights, g.means, g.variances, normalize=self.sift_normalize,
            )
        else:
            out = fisher_kernels.fused_forward_ref(
                xs, mask, self.components, self.mean,
                g.weights, g.means, g.variances, normalize=self.sift_normalize,
            )
        return out[0] if squeeze else out


class GMMFisherVectorEstimator(Estimator):
    """Fits the GMM vocabulary on (sampled) descriptors and returns the
    FisherVector transformer (GMMFisherVectorEstimator.scala)."""

    def __init__(self, k: int, max_iterations: int = 25, seed: int = 0):
        self.k = int(k)
        self.max_iterations = int(max_iterations)
        self.seed = int(seed)

    def params(self):
        return (self.k, self.max_iterations, self.seed)

    def _gmm(self) -> GaussianMixtureModelEstimator:
        return GaussianMixtureModelEstimator(self.k, max_iterations=self.max_iterations, seed=self.seed)

    def fit_dataset(self, data: Dataset) -> FisherVector:
        """Rows (n, d), or ragged (n, T, d) sets with a mask, on their device."""
        return FisherVector(self._gmm().fit_dataset(data))

    def fit_arrays(self, x, mask=None, device="cuda") -> FisherVector:
        """x: (n, d) descriptors, or ragged (n, T, d) sets with a mask."""
        return FisherVector(self._gmm().fit_arrays(x, mask, device=device))
