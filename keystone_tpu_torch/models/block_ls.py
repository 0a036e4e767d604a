"""Block coordinate descent ridge regression and block linear scoring
(counterpart of ``keystone_tpu/models/block_ls.py`` § blockify,
BlockLinearMapper, _block_predict, _offset, BlockLeastSquaresEstimator,
finish_block_model, _bcd_epoch_body, _bcd_fit; in-core only).

Features split into column blocks; each epoch sweeps the blocks Gauss–
Seidel style:

    W_b ← (X_bᵀX_b + nλI)⁻¹ X_bᵀ(Y − P + X_bW_b),   P = Σ_b X_b W_b

The sweep is a Python loop over epochs × blocks of f32 products and
Cholesky solves (``models/common.py::solve_spd``); it computes in the
dtype it is given.  The out-of-core, checkpointed and streamed fits
need the row-block store and are not ported (ROADMAP A5).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from keystone_tpu_torch.models.common import needs_row_block_store, solve_spd
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.estimator import LabelEstimator
from keystone_tpu_torch.workflow.transformer import Transformer, tensor_identity


def blockify(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """(n, d) → (num_blocks, n, block_size), zero-padding d if needed
    (the VectorSplitter analogue)."""
    n, d = x.shape
    nb = -(-d // block_size)
    if nb * block_size != d:
        x = F.pad(x, (0, nb * block_size - d))
    return x.reshape(n, nb, block_size).permute(1, 0, 2)


class BlockLinearMapper(Transformer):
    """Per-block weights summed into one prediction.  ``weights`` is
    (num_blocks, block_size, k); blocks are contiguous column ranges, so
    the sum of per-block partials is one flat product."""

    def __init__(
        self,
        weights: torch.Tensor,
        block_size: int,
        intercept: Optional[torch.Tensor] = None,
        feature_mean: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        self.block_size = int(block_size)
        self.register_buffer("weights", weights)
        self.register_buffer("intercept", intercept)
        self.register_buffer("feature_mean", feature_mean)

    def params(self):
        return (self.block_size, tensor_identity(self.weights, self.intercept, self.feature_mean))

    @property
    def flat_weights(self) -> torch.Tensor:
        nb, bs, k = self.weights.shape
        return self.weights.reshape(nb * bs, k)

    def apply_batch(self, xs, mask=None):
        return _block_predict(xs, self.weights, self.intercept, self.feature_mean)


def _offset(weights, feature_mean, intercept):
    off = 0.0
    if feature_mean is not None:
        nb, bs, k = weights.shape
        pad = nb * bs - feature_mean.shape[0]
        if pad > 0:  # mean given at true d; weights are block-padded
            feature_mean = F.pad(feature_mean, (0, pad))
        off = off - feature_mean @ weights.reshape(nb * bs, k)
    if intercept is not None:
        off = off + intercept
    return off


def _block_predict(xs, weights, intercept, feature_mean):
    xs = xs.to(torch.float32)
    nb, bs, k = weights.shape
    d = xs.shape[-1]
    if nb * bs != d:
        xs = F.pad(xs, (0, nb * bs - d))
    out = torch.matmul(xs, weights.reshape(nb * bs, k))
    return out + _offset(weights, feature_mean, intercept)


class BlockLeastSquaresEstimator(LabelEstimator):
    """Gauss–Seidel block coordinate descent ridge
    (BlockLeastSquares.scala § BlockLeastSquaresEstimator)."""

    def __init__(self, block_size: int = 4096, num_iter: int = 1, lam: float = 0.0,
                 fit_intercept: bool = True):
        self.block_size = int(block_size)
        self.num_iter = int(num_iter)
        self.lam = float(lam)
        self.fit_intercept = fit_intercept

    def params(self):
        return (self.block_size, self.num_iter, self.lam, self.fit_intercept)

    def fit_dataset(self, data: Dataset, labels: Optional[Dataset] = None) -> BlockLinearMapper:
        """Features (n, d) and targets (n, k), fitted in f32 on the data's device."""
        if labels is None:
            raise ValueError("BlockLeastSquaresEstimator requires labels")
        return self._fit(data.array.to(torch.float32), labels.array.to(torch.float32), data.n)

    def fit_stream_dataset(self, *args, **kwargs):
        raise needs_row_block_store("fit_stream_dataset")

    def fit_store(self, *args, **kwargs):
        raise needs_row_block_store("fit_store")

    def fit_checkpointed(self, *args, **kwargs):
        raise needs_row_block_store("fit_checkpointed")

    def fit_arrays(self, x, y, device="cuda") -> BlockLinearMapper:
        """x: (n, d), y: (n, k), numpy or tensors, fitted in f32 on ``device``."""
        dev = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        return self._fit(x, torch.as_tensor(y, dtype=torch.float32).to(dev), x.shape[0])

    def _fit(self, x, y, n) -> BlockLinearMapper:
        xm = torch.sum(x, dim=0) / n if self.fit_intercept else None
        ym = torch.sum(y, dim=0) / n if self.fit_intercept else None
        if self.fit_intercept:
            # padding rows past n would become −x̄: masked back to zero
            row_ok = (torch.arange(x.shape[0], device=x.device) < n).to(x.dtype)[:, None]
            xc, yc = (x - xm) * row_ok, (y - ym) * row_ok
        else:
            xc, yc = x, y
        weights = _bcd_fit(blockify(xc, self.block_size), yc, n, self.lam, self.num_iter)
        return finish_block_model(weights, xm, ym, x.shape[1], self.block_size, self.fit_intercept)


def finish_block_model(weights, xm, ym, d, block_size, fit_intercept):
    """Fitted block weights as a BlockLinearMapper, with the intercept
    from the (weighted) means when the fit centred its data."""
    nb, bs, k = weights.shape
    if not fit_intercept:
        return BlockLinearMapper(weights, block_size)
    wflat = weights.reshape(nb * bs, k)[:d]
    intercept = ym - xm[:d] @ wflat
    return BlockLinearMapper(
        F.pad(wflat, (0, 0, 0, nb * bs - d)).reshape(nb, bs, k), block_size, intercept=intercept
    )


def _bcd_epoch_body(xb, y, n, lam, w, p):
    """One Gauss–Seidel sweep over all blocks; updates the weights w
    (nb, bs, k) and the running prediction p (n_rows, k) in place."""
    for b in range(xb.shape[0]):
        a, wb = xb[b], w[b]
        target = y - p + a @ wb  # the residual with this block's part restored
        wb_new = solve_spd(a.T @ a, a.T @ target, reg=lam * n)
        p += a @ (wb_new - wb)
        w[b] = wb_new
    return w, p


def _bcd_fit(xb, y, n, lam, num_iter: int):
    """xb: (nb, n_rows, bs); y: (n_rows, k) → weights (nb, bs, k)."""
    nb, _, bs = xb.shape
    w = torch.zeros((nb, bs, y.shape[1]), dtype=y.dtype, device=y.device)
    p = torch.zeros_like(y)
    for _ in range(num_iter):
        _bcd_epoch_body(xb, y, n, lam, w, p)
    return w
