"""Row normalizers after the Fisher-vector encode (counterpart of
``keystone_tpu/ops/stats.py`` § SignedHellingerMapper, NormalizeRows)."""

from __future__ import annotations

import torch

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
