"""Prediction heads and label indicators (counterpart of
``keystone_tpu/ops/util.py`` § TopKClassifier, MaxClassifier,
ClassLabelIndicators).  Applied to a label ``Dataset``,
ClassLabelIndicators gives the ±1 target Dataset a LabelEstimator fits."""

from __future__ import annotations

import torch

from keystone_tpu_torch.workflow.transformer import Transformer


class TopKClassifier(Transformer):
    """Top-k class indices, best first; among equal scores the lower
    index first, as the reference's top-k orders them (``torch.topk``
    gives ties no order)."""

    def __init__(self, k: int):
        super().__init__()
        self.k = int(k)

    def params(self):
        return (self.k,)

    def apply_batch(self, xs, mask=None):
        k = min(self.k, xs.shape[-1])
        return torch.sort(xs, dim=-1, descending=True, stable=True).indices[..., :k]


class MaxClassifier(Transformer):
    """argmax class index."""

    def params(self):
        return ()

    def apply_batch(self, xs, mask=None):
        return torch.argmax(xs, dim=-1)


class ClassLabelIndicators(Transformer):
    """int labels → ±1 indicator rows, the least-squares targets.  A label
    outside [0, num_classes) gives an all −1 row, as in the reference,
    whose one-hot of such a label has no 1."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes = int(num_classes)

    def params(self):
        return (self.num_classes,)

    def apply_batch(self, xs, mask=None):
        classes = torch.arange(self.num_classes, device=xs.device)
        onehot = xs.to(torch.int64)[..., None] == classes
        return onehot.to(torch.float32) * 2.0 - 1.0
