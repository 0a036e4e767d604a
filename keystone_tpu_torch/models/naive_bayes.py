"""Multinomial naive Bayes (counterpart of ``keystone_tpu/models/naive_bayes.py``
§ NaiveBayesModel, NaiveBayesEstimator, _nb_fit_sparse, _nb_fit,
_nb_finish; reference nodes/learning/NaiveBayes.scala, MLlib's
multinomial NB, the Newsgroups pipeline's head).  The model scores
per-class log posteriors (argmax-compatible with MaxClassifier).

In a job of several ranks each rank holds a row slice (dense rows, or its
own scipy rows in its own nnz buckets): the class and feature counts
all-reduce over the data axis in one call, as the reference's ``psum``
of ``_nb_fit``/``_nb_fit_sparse``, and every rank finishes alike."""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.parallel import collectives, require_rank_slice
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.estimator import LabelEstimator
from keystone_tpu_torch.workflow.transformer import Transformer, tensor_identity


class NaiveBayesModel(Transformer):
    def __init__(self, log_prior: torch.Tensor, log_cond: torch.Tensor):
        super().__init__()
        self.register_buffer("log_prior", log_prior)  # (K,)
        self.register_buffer("log_cond", log_cond)  # (K, d)

    def params(self):
        return tensor_identity(self.log_prior, self.log_cond)

    def apply_batch(self, xs, mask=None):
        return xs.to(torch.float32) @ self.log_cond.T + self.log_prior

    def apply_dataset(self, ds: Dataset) -> Dataset:
        from keystone_tpu_torch.ops.sparse import is_scipy_sparse_rows, score_sparse_dataset

        if ds.is_host and is_scipy_sparse_rows(ds.items):
            return score_sparse_dataset(ds, self.log_cond.T.contiguous(), self.log_prior)
        return super().apply_dataset(ds)


class NaiveBayesEstimator(LabelEstimator):
    """labels: int class ids (n,) or a one-hot/±1 indicator matrix (n, K);
    ``lam`` is the additive smoothing."""

    def __init__(self, num_classes: int, lam: float = 1.0):
        self.num_classes = int(num_classes)
        self.lam = float(lam)

    def params(self):
        return (self.num_classes, self.lam)

    def fit_dataset(self, data: Dataset, labels: Optional[Dataset] = None) -> NaiveBayesModel:
        if labels is None:
            raise ValueError("NaiveBayesEstimator requires labels")
        require_rank_slice(data, "NaiveBayesEstimator")
        from keystone_tpu_torch.ops.sparse import (BucketedSparseRows, bucketize_with_labels, host_onehot,
                                                   is_scipy_sparse_rows)

        if data.is_host and is_scipy_sparse_rows(data.items):
            # the counts onehotᵀX by scatter-add over the nnz-bucketed COO
            # entries: n×d never densifies
            sp = BucketedSparseRows.from_scipy_rows(data.items, device=data.device)
            onehot = host_onehot(labels.numpy(), self.num_classes)
            bidx, bvals, boh, n, d, _ = bucketize_with_labels(sp, onehot, n=data.local_n, global_n=data.n)
            return NaiveBayesModel(*_nb_fit_sparse(bidx, bvals, boh, n, d, self.lam))
        x = data.array[:data.local_n]
        return self._fit(x, labels.array[:labels.local_n].to(x.device), data.n)

    def fit_arrays(self, x, y=None, device="cuda") -> NaiveBayesModel:
        require_rank_slice(None, "NaiveBayesEstimator.fit_arrays")
        dev = resolve_device(device)
        return self._fit(torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev))

    def _fit(self, x, y, n=None) -> NaiveBayesModel:
        """x, y: this rank's valid rows; ``n`` the count over every rank
        (default: x's rows)."""
        n = x.shape[0] if n is None else n
        return NaiveBayesModel(*_nb_fit(x.to(torch.float32), _to_onehot(y, self.num_classes), n, self.lam))


def _to_onehot(y: torch.Tensor, k: int) -> torch.Tensor:
    if y.ndim == 1:
        return torch.nn.functional.one_hot(y.to(torch.int64), k).to(torch.float32)
    return (y > 0).to(torch.float32)


def _nb_fit_sparse(bidx, bvals, bonehot, n, d, lam):
    """Sparse multinomial NB: the feature counts (Xᵀ·onehot)ᵀ by
    scatter-add, bucket by bucket (padding rows carry zero values and
    labels), all-reduced across ranks; the same tail as ``_nb_fit``."""
    from keystone_tpu_torch.ops.sparse import sparse_grad

    k = bonehot[0].shape[1]
    dev = bonehot[0].device
    class_counts = torch.zeros((k,), dtype=torch.float32, device=dev)
    feat_counts = torch.zeros((k, d), dtype=torch.float32, device=dev)
    for idx, vals, onehot in zip(bidx, bvals, bonehot):
        class_counts = class_counts + torch.sum(onehot, dim=0)
        feat_counts = feat_counts + sparse_grad(idx, vals, onehot, d).T
    return _nb_finish(*collectives.psum_many(class_counts, feat_counts), n, lam)


def _nb_fit(x, onehot, n, lam):
    """Dense multinomial NB from this rank's rows; ``n`` over every rank."""
    return _nb_finish(*collectives.psum_many(torch.sum(onehot, dim=0), onehot.T @ x), n, lam)


def _nb_finish(class_counts, feat_counts, n, lam):
    """The prior, the smoothing and the log conditionals, in f32."""
    log_n = torch.log(torch.tensor(float(n), dtype=torch.float32, device=class_counts.device))
    log_prior = torch.log(torch.clamp(class_counts, min=1e-10)) - log_n
    smoothed = feat_counts + lam
    log_cond = torch.log(smoothed) - torch.log(torch.sum(smoothed, dim=1, keepdim=True))
    return log_prior, log_cond


