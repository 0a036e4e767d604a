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

The dense apps' fitted or drawn transformers come across one at a time,
each from its reference object's arrays, as the port's transformer on
``device``: ``cosine_random_features_from_numpy`` (``w`` (D_out, D_in),
``b`` (D_out,)), ``random_sign_node_from_numpy`` (``signs`` (D,)),
``zca_whitener_from_numpy`` (``whitener`` (d, d), ``mean`` (d,)),
``convolver_from_numpy`` (``filters`` (K, fh, fw, c), ``offset`` (K,) or
None) and ``linear_mapper_from_numpy`` (``weights`` (d, k),
``intercept`` (k,) or None).

The text apps' fitted state: ``common_sparse_features_model_from_vocab``
(the vocabulary, a host object, copied), ``hashing_tf_from_reference``
(its width; the hash is the reference's), ``naive_bayes_model_from_numpy``
(``log_prior`` (K,), ``log_cond`` (K, d)),
``logistic_regression_model_from_numpy`` (``weights`` (d, K)) and, for
the sparse least-squares head, ``linear_mapper_from_numpy``.

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


def _f32(name: str, a, ndim: int, device) -> torch.Tensor:
    """``a`` as an f32 tensor on ``device``, refusing another rank."""
    arr = np.array(a, np.float32)
    if arr.ndim != ndim:
        raise _shape_error(name, arr.shape, f"{ndim} axes")
    return torch.from_numpy(arr).to(resolve_device(device))


def _check_len(name: str, t, n: int) -> None:
    if t is not None and tuple(t.shape) != (n,):
        raise _shape_error(name, t.shape, f"({n},)")


def cosine_random_features_from_numpy(w, b, device="cuda"):
    """A ``CosineRandomFeatures`` from the reference's drawn ``w`` and ``b``."""
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures

    wt, bt = _f32("w", w, 2, device), _f32("b", b, 1, device)
    _check_len("b", bt, wt.shape[0])
    return CosineRandomFeatures(wt, bt)


def random_sign_node_from_numpy(signs, device="cuda"):
    """A ``RandomSignNode`` from the reference's drawn ±1 ``signs``."""
    from keystone_tpu_torch.ops.stats import RandomSignNode

    st = _f32("signs", signs, 1, device)
    if not bool(((st == 1.0) | (st == -1.0)).all()):
        raise ValueError("signs must be ±1")
    return RandomSignNode(st)


def zca_whitener_from_numpy(whitener, mean, device="cuda"):
    """A ``ZCAWhitener`` from the reference's fitted map and mean."""
    from keystone_tpu_torch.models.zca import ZCAWhitener

    wt, mt = _f32("whitener", whitener, 2, device), _f32("mean", mean, 1, device)
    if wt.shape[0] != wt.shape[1]:
        raise _shape_error("whitener", wt.shape, "(d, d)")
    _check_len("mean", mt, wt.shape[0])
    return ZCAWhitener(wt, mt)


def convolver_from_numpy(filters, offset=None, stride: int = 1, strategy: str = "auto", device="cuda"):
    """A ``Convolver`` from the reference's (K, fh, fw, c) filters and
    optional (K,) offset."""
    from keystone_tpu_torch.ops.images import Convolver

    ft = _f32("filters", filters, 4, device)
    ot = None if offset is None else _f32("offset", offset, 1, device)
    _check_len("offset", ot, ft.shape[0])
    return Convolver(ft, stride=stride, offset=ot, strategy=strategy)


def linear_mapper_from_numpy(weights, intercept=None, device="cuda"):
    """A ``LinearMapper`` from the reference's (d, k) weights and optional
    (k,) intercept."""
    from keystone_tpu_torch.models.linear import LinearMapper

    wt = _f32("weights", weights, 2, device)
    bt = None if intercept is None else _f32("intercept", intercept, 1, device)
    _check_len("intercept", bt, wt.shape[1])
    return LinearMapper(wt, bt)


def common_sparse_features_model_from_vocab(vocab: Mapping, num_features: int, sparse_output: bool = False):
    """A ``CommonSparseFeaturesModel`` over the reference's fitted
    vocabulary ({token tuple: column}, a host object, copied)."""
    from keystone_tpu_torch.ops.nlp import CommonSparseFeaturesModel

    vocab = {tuple(t): int(i) for t, i in vocab.items()}
    if vocab and (max(vocab.values()) >= num_features or min(vocab.values()) < 0):
        raise ValueError(f"vocabulary columns outside [0, {num_features})")
    return CommonSparseFeaturesModel(vocab, num_features, sparse_output)


def hashing_tf_from_reference(num_features: int, sparse_output: bool = False):
    """A ``HashingTF`` of the reference's width (it holds no fitted state:
    the hash is the reference's)."""
    from keystone_tpu_torch.ops.nlp import HashingTF

    return HashingTF(num_features, sparse_output)


def naive_bayes_model_from_numpy(log_prior, log_cond, device="cuda"):
    """A ``NaiveBayesModel`` from the reference's (K,) log prior and (K, d)
    log conditionals."""
    from keystone_tpu_torch.models.naive_bayes import NaiveBayesModel

    lp, lc = _f32("log_prior", log_prior, 1, device), _f32("log_cond", log_cond, 2, device)
    _check_len("log_prior", lp, lc.shape[0])
    return NaiveBayesModel(lp, lc)


def logistic_regression_model_from_numpy(weights, device="cuda"):
    """A ``LogisticRegressionModel`` from the reference's (d, K) weights."""
    from keystone_tpu_torch.models.logistic import LogisticRegressionModel

    return LogisticRegressionModel(_f32("weights", weights, 2, device))
