"""Row normalizers and column standardization (counterpart of
``keystone_tpu/ops/stats.py`` § SignedHellingerMapper, NormalizeRows,
StandardScaler, StandardScalerModel)."""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.transformer import Transformer


class SignedHellingerMapper(Transformer):
    """sign(x)·√|x| — the power normalization after FV encoding."""

    def apply_batch(self, xs, mask=None):
        out = torch.sign(xs) * torch.sqrt(torch.abs(xs))
        return (out, mask) if mask is not None else out


class NormalizeRows(Transformer):
    """L2 row normalization."""

    def __init__(self, eps: float = 1e-12):
        super().__init__()
        self.eps = float(eps)

    def apply_batch(self, xs, mask=None):
        norm = torch.sqrt(torch.sum(xs * xs, dim=-1, keepdim=True))
        out = xs / torch.clamp(norm, min=self.eps)
        return (out, mask) if mask is not None else out


class StandardScalerModel(Transformer):
    """(x − mean) / std, std optional."""

    def __init__(self, mean: torch.Tensor, std: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("mean", mean)
        self.register_buffer("std", std)

    def apply_batch(self, xs, mask=None):
        out = xs - self.mean
        if self.std is not None:
            out = out / self.std
        return out


class StandardScaler:
    """Column mean and unbiased std (n − 1 denominator), the std clamped
    below at ``eps``."""

    def __init__(self, normalize_std: bool = True, eps: float = 1e-8):
        self.normalize_std = normalize_std
        self.eps = float(eps)

    def fit_arrays(self, x, device="cuda") -> StandardScalerModel:
        """x: (n, d), numpy or a tensor; fitted on ``device``."""
        x = torch.as_tensor(x, dtype=torch.float32).to(resolve_device(device))
        n = x.shape[0]
        mean = torch.sum(x, dim=0) / n
        # explicit centering before the square, as the reference: the
        # Σx² − n·mean² shortcut cancels in f32
        xc = x - mean
        std = torch.sqrt(torch.sum(xc * xc, dim=0) / max(n - 1.0, 1.0))
        if not self.normalize_std:
            return StandardScalerModel(mean, None)
        return StandardScalerModel(mean, torch.clamp(std, min=self.eps))
