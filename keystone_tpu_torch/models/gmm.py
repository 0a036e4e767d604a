"""Diagonal Gaussian mixture (counterpart of ``keystone_tpu/models/gmm.py``
§ GaussianMixtureModel, _log_gaussians, GaussianMixtureModelEstimator,
_em_steps, _gmm_fit).

The fit starts from k-means++ centres, the global variance floored at
``min_variance`` and uniform weights, then runs EM: responsibilities
from one log-density gemm pair and a logsumexp, then the weighted
moments.  The k-means++ draws come from a ``torch.Generator`` seeded
with ``seed`` (the reference's draws cannot be repeated here); EM itself is
deterministic from its starting mixture.  With a run ledger each EM
iteration reports its mean log-likelihood (``solver.epoch``, a host
read); without one it reads nothing back.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from keystone_tpu_torch.models.kmeans import _kmeans_fit, generator
from keystone_tpu_torch.obs import ledger
from keystone_tpu_torch.utils import timing
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.estimator import Estimator
from keystone_tpu_torch.workflow.transformer import Transformer, tensor_identity

_LOG2PI = 1.8378770664093453


def _log_gaussians(x, means, variances, log_weights):
    """(n, K) log w_k + log N(x; μ_k, diag σ²_k) via the gemm expansion
    ‖(x−μ)/σ‖² = Σ x²/σ² − 2 Σ xμ/σ² + Σ μ²/σ²."""
    inv = 1.0 / variances  # (K, d)
    quad = (
        (x * x) @ inv.T
        - 2.0 * (x @ (means * inv).T)
        + torch.sum(means * means * inv, dim=1)
    )
    log_norm = -0.5 * (torch.sum(torch.log(variances), dim=1) + x.shape[1] * _LOG2PI)
    return log_weights + log_norm - 0.5 * quad


class GaussianMixtureModel(Transformer):
    """Posterior responsibilities; carries (weights, means, variances)
    for the Fisher-vector encode."""

    def __init__(self, weights, means, variances):
        super().__init__()
        self.register_buffer("weights", weights)  # (K,)
        self.register_buffer("means", means)  # (K, d)
        self.register_buffer("variances", variances)  # (K, d)

    def params(self):
        return tensor_identity(self.weights, self.means, self.variances)

    @property
    def k(self) -> int:
        return self.means.shape[0]

    def log_responsibilities(self, x):
        lg = _log_gaussians(x, self.means, self.variances, torch.log(self.weights))
        return lg - torch.logsumexp(lg, dim=1, keepdim=True)

    def apply_batch(self, xs, mask=None):
        r = torch.exp(self.log_responsibilities(xs))
        return (r, mask) if mask is not None else r


class GaussianMixtureModelEstimator(Estimator):
    def __init__(
        self,
        k: int,
        max_iterations: int = 50,
        min_variance: float = 1e-6,
        seed: int = 0,
        kmeans_iters: int = 10,
    ):
        self.k = int(k)
        self.max_iterations = int(max_iterations)
        self.min_variance = float(min_variance)
        self.seed = int(seed)
        self.kmeans_iters = int(kmeans_iters)

    def params(self):
        return (self.k, self.max_iterations, self.min_variance, self.seed, self.kmeans_iters)

    def fit_dataset(self, data: Dataset) -> GaussianMixtureModel:
        """Rows (n, d), or ragged (n, T, d) sets with a mask, fitted in
        f32 on the data's device."""
        x = data.array.to(torch.float32)
        if data.mask is not None:
            fit = _gmm_fit(x, None, data.mask.to(torch.float32), self.k, self.max_iterations,
                           self.min_variance, self.seed, self.kmeans_iters)
        else:
            fit = _gmm_fit(x, data.n, None, self.k, self.max_iterations, self.min_variance, self.seed,
                           self.kmeans_iters)
        return GaussianMixtureModel(*fit)

    def fit_arrays(self, x, mask=None, device="cuda", stage_seconds=None) -> GaussianMixtureModel:
        """x: (n, d) rows, or ragged (n, T, d) sets with an (n, T) ``mask``
        (the reference's ``fit_dataset`` on a masked Dataset); numpy or
        tensors, fitted in f32 on ``device``.  ``stage_seconds``: as
        ``_gmm_fit``'s."""
        dev = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        n = None if mask is not None else x.shape[0]
        row_ok = None if mask is None else torch.as_tensor(mask, dtype=torch.float32).to(dev)
        w, m, v = _gmm_fit(x, n, row_ok, self.k, self.max_iterations, self.min_variance,
                           self.seed, self.kmeans_iters, stage_seconds=stage_seconds)
        return GaussianMixtureModel(w, m, v)


def _em_steps(x, n, row_ok, w0, mu0, var0, iters: int, min_var: float):
    """``iters`` EM steps from a given mixture (the deterministic part of
    the fit).  x: (n_rows, d); row_ok: (n_rows,) 1.0 for the rows that
    count; n: their number.  Computes in x's dtype."""
    w, mu, var = w0, mu0, var0
    observe = ledger.solver_obs()
    for it in range(iters):
        lg = _log_gaussians(x, mu, var, torch.log(w))
        lse = torch.logsumexp(lg, dim=1, keepdim=True)
        r = torch.exp(lg - lse) * row_ok[:, None]
        if observe:
            ledger.solver_epoch("gmm", epoch=it, mean_log_likelihood=float(torch.sum(lse[:, 0] * row_ok) / n))
        nk = torch.clamp(torch.sum(r, dim=0), min=1e-10)
        mu = (r.T @ x) / nk[:, None]
        ex2 = (r.T @ (x * x)) / nk[:, None]
        var = torch.clamp(ex2 - mu * mu, min=min_var)
        w = nk / n
    return w, mu, var


def _gmm_fit(x, n, row_ok, k: int, iters: int, min_var: float, seed: int, kmeans_iters: int,
             init_means: Optional[torch.Tensor] = None, stage_seconds: Optional[Dict[str, float]] = None):
    """The fit from rows x: (n_rows, d) with ``row_ok`` None (the first n
    rows count) or a 1-D (n_rows,) mask, or ragged (n, T, d) sets with a
    2-D (n, T) mask; masked rows are zeroed.  ``init_means`` replaces
    the k-means++ start (the reference has no such argument: it lets a
    test start from the reference's own centres).  ``stage_seconds``,
    when given, gains the seconds of its "kmeans" and "em" stages."""
    if row_ok is not None and row_ok.ndim == 2:  # ragged (n, T) mask
        x = x.reshape(-1, x.shape[-1])
        row_ok = (row_ok.reshape(-1) > 0).to(x.dtype)
        x = x * row_ok[:, None]
        n = torch.sum(row_ok)
    elif row_ok is not None:  # 1-D row mask
        row_ok = (row_ok.reshape(-1) > 0).to(x.dtype)
        x = x * row_ok[:, None]
        if n is None:
            n = torch.sum(row_ok)
    else:
        row_ok = (torch.arange(x.shape[0], device=x.device) < n).to(x.dtype)
    with timing.stage(stage_seconds, "kmeans", x.device):
        if init_means is None:
            init_means = _kmeans_fit(x, row_ok, k, kmeans_iters, generator(seed, x.device))
    with timing.stage(stage_seconds, "em", x.device):
        gmean = torch.sum(x * row_ok[:, None], dim=0) / n
        gvar = torch.sum((x - gmean) ** 2 * row_ok[:, None], dim=0) / n
        var0 = torch.clamp(gvar, min=min_var)[None, :].repeat(k, 1)
        w0 = torch.full((k,), 1.0 / k, dtype=x.dtype, device=x.device)
        return _em_steps(x, n, row_ok, w0, init_means.to(x.dtype), var0, iters, min_var)
