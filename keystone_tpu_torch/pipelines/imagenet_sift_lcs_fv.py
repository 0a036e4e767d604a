"""ImageNetSiftLcsFV scoring forward (counterpart of
``keystone_tpu/pipelines/imagenet_sift_lcs_fv.py`` and of
``bench.py::build_forward``; the fit stays in the JAX package).

Two branches over the input images:

  SIFT: GrayScaler → dense SIFT → PCA → FisherVector → SignedHellinger → NormalizeRows
  LCS:  LCSExtractor → the same PCA/FV tail

gathered → BlockLinearMapper → TopKClassifier.  ``build_scorer_from_params``
builds the fitted scorer as the reference runs it after its optimizer's
``PallasFvFusionRule``: each PCA → FV pair is one fused kernel, and the
SIFT branch's normalize moves into that kernel.  ``build_forward`` is the
unfused single-branch program ``bench.py`` measures, with the plain FV
kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from keystone_tpu_torch.models.block_ls import BlockLinearMapper
from keystone_tpu_torch.models.gmm import GaussianMixtureModel
from keystone_tpu_torch.models.pca import PCATransformer
from keystone_tpu_torch.ops.fisher import FisherVector, FusedPcaFisherVector
from keystone_tpu_torch.ops.images import GrayScaler, PixelScaler
from keystone_tpu_torch.ops.lcs import LCSExtractor
from keystone_tpu_torch.ops.sift import SIFTExtractor
from keystone_tpu_torch.ops.stats import NormalizeRows, SignedHellingerMapper
from keystone_tpu_torch.ops.util import TopKClassifier
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.pipeline import Pipeline

#: descriptor widths: SIFT 4·4·8, LCS 2·C·16 for RGB images
SIFT_DIM = 128
LCS_DIM = 96


@dataclasses.dataclass
class Config:
    """The reference Config's fields that shape the scoring forward
    (the widths come from the fitted arrays)."""

    sift_step: int = 6
    sift_bin_size: int = 4
    lcs_step: int = 6
    lcs_subpatch: int = 6
    top_k: int = 5


def _gmm(p, b) -> GaussianMixtureModel:
    return GaussianMixtureModel(
        p[f"{b}.gmm.weights"], p[f"{b}.gmm.means"], p[f"{b}.gmm.variances"]
    )


def _pca(p, b) -> PCATransformer:
    return PCATransformer(p[f"{b}.pca.components"], p.get(f"{b}.pca.mean"))


def _blm(p) -> BlockLinearMapper:
    w = p["blm.weights"]
    return BlockLinearMapper(w, w.shape[1], p.get("blm.intercept"), p.get("blm.feature_mean"))


def _fv_tail(base: Pipeline, p, b, sift_normalize: bool, use_kernel: Optional[bool]) -> Pipeline:
    """descriptor extractor pipeline → fused PCA/FV → normalization."""
    fused = FusedPcaFisherVector(_pca(p, b), _gmm(p, b), sift_normalize, use_kernel)
    return base.and_then(fused).and_then(SignedHellingerMapper()).and_then(NormalizeRows())


def build_scorer_from_params(
    params: Dict[str, torch.Tensor],
    config: Config = Config(),
    device="cuda",
    use_kernel: Optional[bool] = None,
) -> Pipeline:
    """The fitted two-branch scorer, ending in TopK(config.top_k) class ids.

    ``params`` as ``convert.params_from_numpy`` returns them, with both
    branches.  ``use_kernel=False`` runs the plain per-stage chain in
    place of the fused kernels (the comparison on the card)."""
    dev = resolve_device(device)
    precision.disable_tf32()
    for b in ("sift", "lcs"):
        if f"{b}.pca.components" not in params:
            raise ValueError(f"the scorer needs the {b} branch's parameters")
    # SIFT emits raw descriptors: the fused kernel normalizes them
    sift_base = Pipeline.of(GrayScaler()).and_then(
        SIFTExtractor(config.sift_step, (config.sift_bin_size,), normalize=False)
    )
    lcs_base = Pipeline.of(LCSExtractor(config.lcs_step, config.lcs_subpatch))
    branches = Pipeline.gather([
        _fv_tail(sift_base, params, "sift", True, use_kernel),
        _fv_tail(lcs_base, params, "lcs", False, use_kernel),
    ])
    # both reference branches start with the same PixelScaler (merged by
    # its optimizer's CSE): here it runs once, before the branches
    scorer = (
        Pipeline.of(PixelScaler(only_if_integer=True))
        .and_then(branches)
        .and_then(_blm(params))
        .and_then(TopKClassifier(config.top_k))
    )
    return scorer.to(dev).eval()


def build_forward(
    params: Dict[str, torch.Tensor],
    config: Config = Config(),
    device="cuda",
    use_kernel: Optional[bool] = None,
) -> Pipeline:
    """The unfused bench forward: GrayScaler → SIFT → PCA → FisherVector
    → SignedHellinger → NormalizeRows → BlockLinearMapper, raw scores.
    ``params`` needs the ``sift`` branch and a BLM of its FV width."""
    dev = resolve_device(device)
    precision.disable_tf32()
    fwd = (
        Pipeline.of(GrayScaler())
        .and_then(SIFTExtractor(config.sift_step, (config.sift_bin_size,)))
        .and_then(_pca(params, "sift"))
        .and_then(FisherVector(_gmm(params, "sift"), use_kernel))
        .and_then(SignedHellingerMapper())
        .and_then(NormalizeRows())
        .and_then(_blm(params))
    )
    return fwd.to(dev).eval()


def scores_of(scorer: Pipeline) -> Pipeline:
    """The scorer without its TopK head: raw class scores."""
    return Pipeline(list(scorer.stages)[:-1])


def random_params(
    branches: Sequence[str] = ("sift", "lcs"),
    pca_dims: int = 64,
    gmm_k: int = 256,
    num_classes: int = 1000,
    block_size: int = 4096,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Seeded weights made the way ``bench.py::build_forward`` makes them:
    QR PCA basis with a zero mean, uniform mixture weights, normal means,
    unit variances, 0.01·normal BLM weights (block_size columns a block).
    Numpy arrays under ``convert.params_from_numpy``'s keys."""
    rng = np.random.default_rng(seed)
    dims = {"sift": SIFT_DIM, "lcs": LCS_DIM}
    out = {}
    for b in branches:
        d_in = dims[b]
        out[f"{b}.pca.components"] = np.linalg.qr(rng.normal(size=(d_in, pca_dims)))[0]
        out[f"{b}.pca.mean"] = np.zeros((d_in,), np.float32)
        out[f"{b}.gmm.weights"] = np.full((gmm_k,), 1.0 / gmm_k, np.float32)
        out[f"{b}.gmm.means"] = rng.normal(size=(gmm_k, pca_dims))
        out[f"{b}.gmm.variances"] = np.ones((gmm_k, pca_dims), np.float32)
    fv_dim = 2 * gmm_k * pca_dims * len(branches)
    nb = -(-fv_dim // block_size)
    out["blm.weights"] = 0.01 * rng.normal(size=(nb, block_size, num_classes))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}
