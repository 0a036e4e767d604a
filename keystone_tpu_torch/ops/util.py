"""Prediction heads and label indicators (counterpart of
``keystone_tpu/ops/util.py`` § TopKClassifier, MaxClassifier,
ClassLabelIndicators)."""

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


class MaxClassifier(Transformer):
    """argmax class index."""

    def apply_batch(self, xs, mask=None):
        return torch.argmax(xs, dim=-1)


class ClassLabelIndicators(Transformer):
    """int labels → ±1 indicator rows, the least-squares targets."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes = int(num_classes)

    def apply_batch(self, xs, mask=None):
        onehot = torch.nn.functional.one_hot(xs.to(torch.int64), self.num_classes)
        return onehot.to(torch.float32) * 2.0 - 1.0
