"""Prediction heads, label indicators and representation casts
(counterpart of ``keystone_tpu/ops/util.py`` § TopKClassifier,
MaxClassifier, ClassLabelIndicators, Densify, Sparsify, FloatToDouble).
Applied to a label ``Dataset``, ClassLabelIndicators gives the ±1 target
Dataset a LabelEstimator fits."""

from __future__ import annotations

import numpy as np
import torch

from keystone_tpu_torch.workflow.dataset import Dataset
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


class Densify(Transformer):
    """scipy sparse rows → dense f32 rows on the data's device
    (nodes/util/Densify.scala), the physical cast between the sparse text
    features and the dense solvers."""

    is_host = True
    fusable = False

    def params(self):
        return ()

    def apply_one(self, x):
        if hasattr(x, "toarray"):
            return np.asarray(x.toarray()).ravel().astype(np.float32)
        return np.asarray(x, np.float32)

    def apply_dataset(self, ds: Dataset) -> Dataset:
        items = ds.items
        if len(items) and hasattr(items[0], "toarray"):
            import scipy.sparse as sp

            return Dataset(sp.vstack(items).toarray().astype(np.float32), device=ds.device)
        return Dataset(np.stack([self.apply_one(x) for x in items]).astype(np.float32), device=ds.device)


class Sparsify(Transformer):
    """Dense rows → scipy CSR rows on the host (nodes/util/Sparsify.scala);
    the rows' tensors go back to the dataset's device when featurized."""

    is_host = True
    fusable = False

    def params(self):
        return ()

    def apply_dataset(self, ds: Dataset) -> Dataset:
        import scipy.sparse as sp

        mat = sp.csr_matrix(np.asarray(ds.numpy()))
        return ds.with_items([mat[i] for i in range(mat.shape[0])])

    def apply_one(self, x):
        import scipy.sparse as sp

        return sp.csr_matrix(np.asarray(x))


class FloatToDouble(Transformer):
    """The dtype cast of nodes/util/FloatToDouble.scala, to f32 as in the
    reference (the device computes in f32)."""

    def params(self):
        return ()

    def apply_batch(self, xs, mask=None):
        return xs.to(torch.float32)

    def apply_one(self, x):
        return torch.as_tensor(x, dtype=torch.float32)
