"""Carry a fitted JAX model's arrays into the port.

``params_from_numpy`` takes the fitted arrays of an ImageNetSiftLcsFV
scorer as numpy arrays (pulled from the JAX model by the caller; this
module imports neither JAX nor the JAX package) under these keys:

====================== ================ =========================================
key                    shape            reference object
====================== ================ =========================================
``<b>.pca.components`` (d_in, d)        PCATransformer.components
``<b>.pca.mean``       (d_in,)          PCATransformer.mean (optional)
``<b>.gmm.weights``    (K,)             GaussianMixtureModel.weights
``<b>.gmm.means``      (K, d)           GaussianMixtureModel.means
``<b>.gmm.variances``  (K, d)           GaussianMixtureModel.variances
``blm.weights``        (nb, bs, k)      BlockLinearMapper.weights
``blm.intercept``      (k,)             BlockLinearMapper.intercept (optional)
``blm.feature_mean``   (D,)             BlockLinearMapper.feature_mean (optional)
====================== ================ =========================================

``<b>`` is a branch, ``sift`` or ``lcs``; a scorer needs both, the
unfused single-branch forward only ``sift``.

``kernel_timit_params_from_numpy`` does the same for a fitted
KernelTimitPipeline scorer, and ``kernel_cifar_params_from_numpy`` for a
KernelCifarPipeline scorer, whose arrays have the same layout over the
3072 vectorized pixels:

====================== ================ =========================================
key                    shape            reference object
====================== ================ =========================================
``scaler.mean``        (D,)             StandardScalerModel.mean
``scaler.std``         (D,)             StandardScalerModel.std (optional)
``nystrom.landmarks``  (m, D)           NystromFeatureMap.landmarks
``nystrom.whiten``     (m, m)           NystromFeatureMap.whiten
``blm.*``              as above         BlockLinearMapper, over the m features
====================== ================ =========================================

and ``krr_params_from_numpy`` for a fitted kernel ridge regression model:

====================== ================ =========================================
key                    shape            reference object
====================== ================ =========================================
``krr.train_x``        (n_rows, D)      KernelBlockLinearMapper.train_x (padded)
``krr.alpha``          (n_rows, k)      KernelBlockLinearMapper.alpha
====================== ================ =========================================

Scalars (γ, the block size, the train row count) are passed to the
builders as arguments.  The keys suit ``np.savez``.

``oc_krr_mapper_from_numpy`` carries an out-of-core kernel model across:
its α (``_oc_krr_fit``'s (nb·bs, k) output) and the directory of the
``RowBlockStore`` it was fitted on, which the port reads as it is.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from keystone_tpu_torch.utils.device import resolve_device

BRANCHES = ("sift", "lcs")
_BRANCH_KEYS = ("pca.components", "pca.mean", "gmm.weights", "gmm.means", "gmm.variances")
_OPTIONAL = {"pca.mean"}
_BLM_KEYS = {"blm.weights", "blm.intercept", "blm.feature_mean"}


def _shape_error(key, got, want):
    return ValueError(f"{key} has shape {tuple(got)}, expected {want}")


def _arrays(d: Mapping[str, np.ndarray], known) -> Dict[str, np.ndarray]:
    """The given arrays as f32 numpy, refusing keys outside ``known``."""
    unknown = sorted(set(d) - set(known))
    if unknown:
        raise ValueError(f"unknown parameter keys {unknown}")
    return {k: np.array(v, np.float32) for k, v in d.items() if v is not None}


def _require(arrs, keys):
    for k in keys:
        if k not in arrs:
            raise ValueError(f"missing parameter {k}")


def _check_shapes(arrs, want):
    for k, shape in want.items():
        if k in arrs and arrs[k].shape != shape:
            raise _shape_error(k, arrs[k].shape, shape)


def _check_blm(arrs, width: int) -> None:
    """blm.weights (nb, bs, k) covering ``width`` features, and its optional
    intercept (k,) and feature mean (width,)."""
    _require(arrs, ["blm.weights"])
    wts = arrs["blm.weights"]
    if wts.ndim != 3 or wts.shape[0] * wts.shape[1] < width:
        raise _shape_error("blm.weights", wts.shape, f"(nb, bs, k) with nb·bs ≥ {width}")
    _check_shapes(arrs, {"blm.intercept": (wts.shape[2],), "blm.feature_mean": (width,)})


def _to(arrs, device) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrs.items()}


def params_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """Validate the keyed arrays of an ImageNetSiftLcsFV scorer and return
    them as f32 tensors on ``device`` (the card unless the caller asks for
    the CPU)."""
    resolve_device(device)
    arrs = _arrays(d, {f"{b}.{k}" for b in BRANCHES for k in _BRANCH_KEYS} | _BLM_KEYS)
    width = 0
    for b in BRANCHES:
        if not any(k.startswith(b + ".") for k in arrs):
            continue
        _require(arrs, [f"{b}.{k}" for k in _BRANCH_KEYS if k not in _OPTIONAL])
        comp = arrs[f"{b}.pca.components"]
        if comp.ndim != 2:
            raise _shape_error(f"{b}.pca.components", comp.shape, "(d_in, d)")
        d_in, dd = comp.shape
        kk = arrs[f"{b}.gmm.weights"].shape[0]
        _check_shapes(arrs, {
            f"{b}.pca.mean": (d_in,),
            f"{b}.gmm.weights": (kk,),
            f"{b}.gmm.means": (kk, dd),
            f"{b}.gmm.variances": (kk, dd),
        })
        width += 2 * kk * dd
    _check_blm(arrs, width)
    return _to(arrs, device)


def _nystrom_scorer_params(d: Mapping[str, np.ndarray], device, dim=None) -> Dict[str, torch.Tensor]:
    """The keyed arrays of a Nyström scorer (scaler, Nyström map, BLM),
    validated, as f32 tensors on ``device``; ``dim`` the input width
    when the pipeline fixes it."""
    resolve_device(device)
    arrs = _arrays(d, {"scaler.mean", "scaler.std", "nystrom.landmarks", "nystrom.whiten"} | _BLM_KEYS)
    _require(arrs, ["scaler.mean", "nystrom.landmarks", "nystrom.whiten"])
    lmk = arrs["nystrom.landmarks"]
    if lmk.ndim != 2 or (dim is not None and lmk.shape[1] != dim):
        raise _shape_error("nystrom.landmarks", lmk.shape, f"(m, {dim or 'D'})")
    m, width = lmk.shape
    _check_shapes(arrs, {"scaler.mean": (width,), "scaler.std": (width,), "nystrom.whiten": (m, m)})
    _check_blm(arrs, m)
    return _to(arrs, device)


def kernel_timit_params_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """Validate the keyed arrays of a KernelTimitPipeline scorer (scaler,
    Nyström map, BLM) and return them as f32 tensors on ``device``."""
    return _nystrom_scorer_params(d, device)


def kernel_cifar_params_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """The same for a KernelCifarPipeline scorer, over 32·32·3 = 3072
    vectorized pixels."""
    return _nystrom_scorer_params(d, device, dim=3072)


def krr_params_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """Validate a fitted kernel ridge regression model's train rows and
    dual coefficients and return them as f32 tensors on ``device``."""
    resolve_device(device)
    arrs = _arrays(d, {"krr.train_x", "krr.alpha"})
    _require(arrs, ["krr.train_x", "krr.alpha"])
    tx, alpha = arrs["krr.train_x"], arrs["krr.alpha"]
    if tx.ndim != 2:
        raise _shape_error("krr.train_x", tx.shape, "(n_rows, D)")
    if alpha.ndim != 2 or alpha.shape[0] != tx.shape[0]:
        raise _shape_error("krr.alpha", alpha.shape, f"({tx.shape[0]}, k)")
    return _to(arrs, device)


def oc_krr_mapper_from_numpy(alpha: np.ndarray, store_directory: str, gamma: float, device="cuda"):
    """An ``OutOfCoreKernelBlockLinearMapper`` from a fitted out-of-core
    model's α, (nb·bs, k), and the ``RowBlockStore`` directory it was
    fitted on (the reference's layout), α as f32 on ``device``."""
    from keystone_tpu_torch.models.kernel_ridge import GaussianKernelGenerator, OutOfCoreKernelBlockLinearMapper
    from keystone_tpu_torch.workflow.blockstore import RowBlockStore

    dev = resolve_device(device)
    store = RowBlockStore(store_directory)
    a = np.array(alpha, np.float32)
    rows = store.num_blocks * store.block_size
    if a.ndim != 2 or a.shape[0] != rows:
        raise _shape_error("alpha", a.shape, f"({rows}, k)")
    return OutOfCoreKernelBlockLinearMapper(GaussianKernelGenerator(float(gamma)), store_directory,
                                            torch.from_numpy(a).to(dev), store.n)
