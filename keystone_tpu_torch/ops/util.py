"""Prediction head (counterpart of ``keystone_tpu/ops/util.py`` § TopKClassifier)."""

from __future__ import annotations

import torch

from keystone_tpu_torch.workflow.transformer import Transformer


class TopKClassifier(Transformer):
    """Top-k class indices, best first."""

    def __init__(self, k: int):
        super().__init__()
        self.k = int(k)

    def apply_batch(self, xs, mask=None):
        k = min(self.k, xs.shape[-1])
        return torch.topk(xs, k, dim=-1, largest=True, sorted=True).indices
