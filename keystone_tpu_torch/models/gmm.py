"""Diagonal Gaussian mixture, apply only (counterpart of
``keystone_tpu/models/gmm.py`` § GaussianMixtureModel, _log_gaussians)."""

from __future__ import annotations

import torch

from keystone_tpu_torch.workflow.transformer import Transformer

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

    @property
    def k(self) -> int:
        return self.means.shape[0]

    def log_responsibilities(self, x):
        lg = _log_gaussians(x, self.means, self.variances, torch.log(self.weights))
        return lg - torch.logsumexp(lg, dim=1, keepdim=True)

    def apply_batch(self, xs, mask=None):
        r = torch.exp(self.log_responsibilities(xs))
        return (r, mask) if mask is not None else r
