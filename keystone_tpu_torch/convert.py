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
unfused single-branch forward only ``sift``.  The keys suit ``np.savez``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from keystone_tpu_torch.utils.device import resolve_device

BRANCHES = ("sift", "lcs")
_BRANCH_KEYS = ("pca.components", "pca.mean", "gmm.weights", "gmm.means", "gmm.variances")
_OPTIONAL = {"pca.mean", "blm.intercept", "blm.feature_mean"}


def _shape_error(key, got, want):
    return ValueError(f"{key} has shape {tuple(got)}, expected {want}")


def params_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """Validate the keyed arrays above and return them as f32 tensors on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    known = {f"{b}.{k}" for b in BRANCHES for k in _BRANCH_KEYS}
    known |= {"blm.weights", "blm.intercept", "blm.feature_mean"}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown parameter keys {unknown}")
    arrs = {k: np.array(v, np.float32) for k, v in d.items() if v is not None}

    width = 0
    for b in BRANCHES:
        if not any(k.startswith(b + ".") for k in arrs):
            continue
        for k in _BRANCH_KEYS:
            if f"{b}.{k}" not in arrs and k not in _OPTIONAL:
                raise ValueError(f"missing parameter {b}.{k}")
        comp = arrs[f"{b}.pca.components"]
        if comp.ndim != 2:
            raise _shape_error(f"{b}.pca.components", comp.shape, "(d_in, d)")
        d_in, dd = comp.shape
        kk = arrs[f"{b}.gmm.weights"].shape[0]
        want = {
            "pca.mean": (d_in,),
            "gmm.weights": (kk,),
            "gmm.means": (kk, dd),
            "gmm.variances": (kk, dd),
        }
        for k, shape in want.items():
            a = arrs.get(f"{b}.{k}")
            if a is not None and a.shape != shape:
                raise _shape_error(f"{b}.{k}", a.shape, shape)
        width += 2 * kk * dd

    if "blm.weights" not in arrs:
        raise ValueError("missing parameter blm.weights")
    wts = arrs["blm.weights"]
    if wts.ndim != 3 or wts.shape[0] * wts.shape[1] < width:
        raise _shape_error("blm.weights", wts.shape, f"(nb, bs, k) with nb·bs ≥ {width}")
    for k, shape in (("blm.intercept", (wts.shape[2],)), ("blm.feature_mean", (width,))):
        if k in arrs and arrs[k].shape != shape:
            raise _shape_error(k, arrs[k].shape, shape)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrs.items()}
