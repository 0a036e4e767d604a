"""Logistic regression by L-BFGS (counterpart of ``keystone_tpu/models/logistic.py``
§ LogisticRegressionModel, LogisticRegressionEstimator, _logreg_fit,
_logreg_fit_sparse; reference nodes/learning/LogisticRegressionEstimator.scala,
MLlib's LogisticRegressionWithLBFGS, the Amazon reviews pipeline's head):
the softmax cross-entropy with an L2 penalty on ``models/lbfgs.py``'s
loop, dense or on nnz-bucketed sparse rows (a gather forward, a
scatter-add gradient)."""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.models.lbfgs import lbfgs_minimize
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.estimator import LabelEstimator
from keystone_tpu_torch.workflow.transformer import Transformer, tensor_identity


class LogisticRegressionModel(Transformer):
    def __init__(self, weights: torch.Tensor):
        super().__init__()
        self.register_buffer("weights", weights)  # (d, K)

    def params(self):
        return tensor_identity(self.weights)

    def apply_batch(self, xs, mask=None):
        return xs.to(torch.float32) @ self.weights  # logits; MaxClassifier takes the argmax

    def apply_dataset(self, ds: Dataset) -> Dataset:
        from keystone_tpu_torch.ops.sparse import is_scipy_sparse_rows, score_sparse_dataset

        if ds.is_host and is_scipy_sparse_rows(ds.items):
            return score_sparse_dataset(ds, self.weights)
        return super().apply_dataset(ds)

    def predict_proba(self, xs):
        return torch.softmax(xs.to(torch.float32) @ self.weights, dim=-1)


class LogisticRegressionEstimator(LabelEstimator):
    """labels: int class ids (n,) or an indicator matrix (n, K)."""

    def __init__(self, num_classes: int, lam: float = 0.0, num_iters: int = 100, history: int = 10):
        self.num_classes = int(num_classes)
        self.lam = float(lam)
        self.num_iters = int(num_iters)
        self.history = int(history)

    def params(self):
        return (self.num_classes, self.lam, self.num_iters, self.history)

    def fit_dataset(self, data: Dataset, labels: Optional[Dataset] = None) -> LogisticRegressionModel:
        if labels is None:
            raise ValueError("LogisticRegressionEstimator requires labels")
        from keystone_tpu_torch.ops.sparse import BucketedSparseRows, is_scipy_sparse_rows

        if data.is_host and is_scipy_sparse_rows(data.items):
            sp = BucketedSparseRows.from_scipy_rows(data.items, device=data.device)
            return self.fit_sparse(sp, labels.array, n=data.n)
        x = data.array[:data.n]
        return self._fit(x, labels.array[:labels.n].to(x.device))

    def fit_sparse(self, sp, y, n: Optional[int] = None) -> LogisticRegressionModel:
        """Fit from a PaddedSparseRows or BucketedSparseRows."""
        from keystone_tpu_torch.ops.sparse import bucketize_with_labels, host_onehot

        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
        onehot = host_onehot(y, self.num_classes)
        bidx, bvals, boh, n, d, brow_ok = bucketize_with_labels(sp, onehot, n=n)
        return LogisticRegressionModel(_logreg_fit_sparse(bidx, bvals, boh, brow_ok, n, d, self.lam,
                                                          self.num_iters, self.history))

    def _onehot(self, y: torch.Tensor) -> torch.Tensor:
        if y.ndim == 1:
            return torch.nn.functional.one_hot(y.to(torch.int64), self.num_classes).to(torch.float32)
        return (y > 0).to(torch.float32)

    def fit_arrays(self, x, y=None, device="cuda") -> LogisticRegressionModel:
        dev = resolve_device(device)
        return self._fit(torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev))

    def _fit(self, x, y) -> LogisticRegressionModel:
        return LogisticRegressionModel(_logreg_fit(x.to(torch.float32), self._onehot(y), x.shape[0], self.lam,
                                                   self.num_iters, self.history))


def _logreg_fit(x, onehot, n, lam, num_iters, history):
    def fun(w, grad):
        logits = x @ w
        ll = torch.sum(logits * onehot, dim=1) - torch.logsumexp(logits, dim=1)
        f = -torch.sum(ll) / n + 0.5 * lam * torch.sum(w * w)
        if not grad:
            return f, None
        return f, x.T @ (torch.softmax(logits, dim=1) - onehot) / n + lam * w

    w0 = torch.zeros((x.shape[1], onehot.shape[1]), dtype=torch.float32, device=x.device)
    return lbfgs_minimize(fun, w0, max_iter=num_iters, history=history)


def _logreg_fit_sparse(bidx, bvals, bonehot, brow_ok, n, d, lam, num_iters, history):
    """Softmax cross-entropy on bucketed COO rows, summed over the
    buckets (the row order does not change the loss).  Padding entries
    have value 0 and padding rows zero one-hots, so neither adds to the
    loss or the gradient, except through the softmax's normalizer: the
    valid-row masks ``brow_ok`` take them out of that."""
    from keystone_tpu_torch.ops.sparse import sparse_grad, sparse_matmul

    n = float(n)

    def fun(w, grad):
        f = 0.5 * lam * torch.sum(w * w)
        g = lam * w if grad else None
        for idx, vals, onehot, row_ok in zip(bidx, bvals, bonehot, brow_ok):
            logits = sparse_matmul(idx, vals, w)
            ll = torch.sum(logits * onehot, dim=1) - torch.logsumexp(logits, dim=1) * row_ok
            f = f - torch.sum(ll) / n
            if grad:
                p = torch.softmax(logits, dim=1) * row_ok[:, None]
                g = g + sparse_grad(idx, vals, p - onehot, d) / n
        return f, g

    w0 = torch.zeros((d, bonehot[0].shape[1]), dtype=torch.float32, device=bonehot[0].device)
    return lbfgs_minimize(fun, w0, max_iter=num_iters, history=history)
