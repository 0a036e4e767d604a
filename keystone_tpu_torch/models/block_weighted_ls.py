"""Class-weighted block coordinate descent least squares (counterpart of
``keystone_tpu/models/block_weighted_ls.py``; in-core only).

Each example gets a weight blending a balanced per-class term with a
uniform one (BlockWeightedLeastSquares.scala):

    α_i = mixture_weight · n/(K·n_c(i)) + (1 − mixture_weight)

and the fit solves the weighted ridge normal equations blockwise,
Gauss–Seidel over feature blocks, with weighted mean-centring giving
the intercept.  The sweep computes in the dtype it is given.  A
StreamDataset reaching the estimator is fitted out of core: its features
spill to a ``FeatureBlockStore`` and ``block_ls._oc_bcd_fit`` sweeps the
blocks from disk with the same arithmetic, with its per-epoch checkpoint,
fault points and timing.  The reference has no in-core checkpointed fit
for this estimator, and neither has the port: ``checkpoint_dir`` reaches
the streamed fit only.

In a job of several ranks (``parallel/``) both fits run across the mesh
as ``block_ls``'s do: the class counts, the weights' sum, the weighted
means and every block's products all-reduce over the data axis, the
class columns are cut over the model axis, and ``fit_store`` sweeps a
store of each rank's own rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.models.block_ls import (
    BlockLinearMapper,
    _check_store_rows,
    _gather_columns,
    _model_columns,
    _oc_bcd_fit,
    blockify,
    finish_block_model,
    fit_streamed,
)
from keystone_tpu_torch.models.common import solve_spd
from keystone_tpu_torch.obs import ledger
from keystone_tpu_torch.parallel import collectives, require_rank_slice
from keystone_tpu_torch.parallel import mesh as _mesh
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset, as_dataset
from keystone_tpu_torch.workflow.estimator import LabelEstimator


def class_weights(y: torch.Tensor, n, mixture_weight: float, valid=None, mesh=None) -> torch.Tensor:
    """Per-example weights from a ±1 one-hot label matrix (n_rows, K):
    row i's class is its argmax; rows past ``valid`` (default ``n``; a
    rank slice's own rows) are padding and weigh 0.  ``n`` is the global
    row count, and the class counts all-reduce over the data axis."""
    n_rows, k = y.shape
    cls = torch.argmax(y, dim=1)
    onehot = torch.nn.functional.one_hot(cls, k).to(y.dtype)
    counts = collectives.psum(torch.sum(onehot * (y.max(dim=1, keepdim=True).values > 0), dim=0), mesh=mesh)
    counts = torch.clamp(counts, min=1.0)
    balanced = n / (k * counts[cls])
    alpha = mixture_weight * balanced + (1.0 - mixture_weight)
    return alpha * (torch.arange(n_rows, device=y.device) < (n if valid is None else valid)).to(y.dtype)


class BlockWeightedLeastSquaresEstimator(LabelEstimator):
    #: the default of an estimator saved before ``spill_dtype`` existed
    spill_dtype = "float32"

    def __init__(self, block_size: int = 4096, num_iter: int = 1, lam: float = 0.0,
                 mixture_weight: float = 0.5, fit_intercept: bool = True, spill_dtype: str = "float32",
                 checkpoint_dir: Optional[str] = None):
        self.block_size = int(block_size)
        self.num_iter = int(num_iter)
        self.lam = float(lam)
        self.mixture_weight = float(mixture_weight)
        self.fit_intercept = fit_intercept
        #: the out-of-core spill's precision: "bfloat16" halves the bytes
        #: on disk and on the wire of every sweep; the solve stays f32
        self.spill_dtype = str(spill_dtype)
        #: where a streamed fit the graph runs checkpoints each epoch
        #: (None: no checkpoint); where, not what, so not a parameter
        self.checkpoint_dir = checkpoint_dir

    def params(self):
        return (self.block_size, self.num_iter, self.lam, self.mixture_weight, self.fit_intercept, self.spill_dtype)

    def fit_dataset(self, data: Dataset, labels: Optional[Dataset] = None) -> BlockLinearMapper:
        """Features (n, d) and ±1 indicators (n, K), fitted in f32 on the
        data's device; a stream is fitted out of core."""
        if labels is None:
            raise ValueError("BlockWeightedLeastSquaresEstimator requires labels")
        if isinstance(data, StreamDataset):
            if self.checkpoint_dir is None:
                return self.fit_stream_dataset(data, labels)
            return self.fit_stream_dataset(data, labels, checkpoint_dir=self.checkpoint_dir)
        require_rank_slice(data, "BlockWeightedLeastSquaresEstimator")
        return self._fit(data.array.to(torch.float32), labels.array.to(torch.float32), data.n, data.local_n)

    def fit_stream_dataset(self, data: StreamDataset, labels, spill_dir=None, checkpoint_dir=None,
                           prefetch=None) -> BlockLinearMapper:
        """Out-of-core weighted fit: spill the streamed features to a block
        store once, at ``spill_dtype``, then sweep its blocks from disk
        (``block_ls._oc_bcd_fit``).  The spill directory is deleted after
        a fit that succeeds.  ``prefetch``: the block read-ahead (None:
        ``KEYSTONE_OC_PREFETCH``, else 2)."""
        return fit_streamed(self, data, labels, spill_dir, checkpoint_dir, prefetch)

    def fit_store(self, store, labels, checkpoint_dir=None, prefetch=None) -> BlockLinearMapper:
        """The weighted fit from a FeatureBlockStore on the labels' device;
        ``prefetch`` as in ``fit_stream_dataset``."""
        labels = as_dataset(labels)
        require_rank_slice(labels, "BlockWeightedLeastSquaresEstimator.fit_store")
        _check_store_rows(store, labels)
        y = labels.array.to(torch.float32)
        alpha = class_weights(y, labels.n, self.mixture_weight, labels.local_n)
        weights, xm, ym = _oc_bcd_fit(store, y, alpha, float(labels.n), self.lam, self.num_iter,
                                      self.fit_intercept, checkpoint_dir=checkpoint_dir, prefetch=prefetch)
        return finish_block_model(weights, xm, ym, store.d, self.block_size, self.fit_intercept)

    @_mesh.on_local_mesh
    def fit_arrays(self, x, y, device="cuda") -> BlockLinearMapper:
        """x: (n, d) features, y: (n, K) ±1 indicators, numpy or tensors,
        fitted in f32 on ``device``."""
        dev = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        return self._fit(x, torch.as_tensor(y, dtype=torch.float32).to(dev), x.shape[0])

    def _fit(self, x, y, n, valid=None) -> BlockLinearMapper:
        alpha = class_weights(y, n, self.mixture_weight, valid)
        weights, xm, ym = _weighted_bcd_fit(x, y, alpha, n, self.lam, self.num_iter,
                                            self.block_size, self.fit_intercept)
        return finish_block_model(weights, xm, ym, x.shape[1], self.block_size, self.fit_intercept)


def _weighted_bcd_fit(x, y, alpha, n, lam, num_iter: int, block_size: int, fit_intercept: bool):
    """Weights (nb, bs, K) and the weighted means (x̄, ȳ) the intercept
    needs.  Each block solves with its √α-scaled rows, AᵀA = XᵀDX.  With
    a run ledger, each epoch reports its objective (a host read).  Across
    ranks the sums and products all-reduce over the data axis and each
    rank solves its model index's class columns."""
    mesh = _mesh.current_mesh()
    k = y.shape[1]
    wsum = torch.sum(alpha)
    if fit_intercept:
        sx, sy, wsum = collectives.psum_many(alpha @ x, alpha @ y, wsum, mesh=mesh)
        xm, ym = sx / wsum, sy / wsum
        row_ok = (alpha > 0).to(x.dtype)[:, None]
        xc, yc = (x - xm) * row_ok, (y - ym) * row_ok
    else:
        xm = torch.zeros((x.shape[1],), dtype=x.dtype, device=x.device)
        ym = torch.zeros((y.shape[1],), dtype=y.dtype, device=y.device)
        xc, yc = x, y
    xb = blockify(xc, block_size)  # (nb, n_rows, bs)
    nb, _, bs = xb.shape
    yc = _model_columns(yc, mesh)
    sa = torch.sqrt(alpha)[:, None]
    w = torch.zeros((nb, bs, yc.shape[1]), dtype=yc.dtype, device=yc.device)
    p = torch.zeros_like(yc)
    observe = ledger.solver_obs()
    for e in range(num_iter):
        for b in range(nb):
            a = xb[b] * sa
            target = (yc - p) * sa + a @ w[b]
            wb_new = solve_spd(collectives.sharded_gram(a, mesh), collectives.sharded_matmul(a, target, mesh=mesh),
                               reg=lam * n)
            p += xb[b] @ (wb_new - w[b])
            w[b] = wb_new
        if observe:
            r = (yc - p) * sa
            ledger.solver_epoch("bcd.weighted", epoch=e,
                                objective=float(collectives.mesh_sum(0.5 * torch.sum(r * r) / n, mesh)))
    return _gather_columns(ledger.device_wait(w), k, mesh), xm, ym
