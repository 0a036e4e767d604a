"""Batch L-BFGS with L2 regularization (counterpart of
``keystone_tpu/models/lbfgs.py`` § _lbfgs_machinery, lbfgs_minimize,
DenseLBFGSwithL2, SparseLBFGSwithL2, _sparse_vag,
_lbfgs_sparse_least_squares, _lbfgs_center, _dense_vag,
_lbfgs_least_squares; reference nodes/learning/LBFGS.scala).

The reference compiles the whole loop, the two-loop recursion, the
backtracking Armijo line search and the rolling (s, y) history, into one
XLA program, whose line search and stopping test are while loops on
device values.  Here the loop is eager: the reference's trial count and
skip rules are kept exactly, so each line-search test and each
iteration's (curvature, stopping) test is one read of a device value on
the host.  ``STATS`` counts the iterations, the line-search trials and
those reads.

The mid-fit checkpointed loops (``lbfgs_minimize_resumable``,
``fit_checkpointed``) are not ported (ROADMAP A5).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import torch

from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.estimator import LabelEstimator

#: summed over fits until ``reset_stats``: L-BFGS iterations, line-search
#: trials (objective evaluations in the line search) and host reads of
#: device values (one a line-search test, one an iteration)
STATS = {"iterations": 0, "trials": 0, "host_reads": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def lbfgs_minimize(fun: Callable, x0: torch.Tensor, max_iter: int = 50, history: int = 10, tol: float = 1e-7,
                   max_line_search: int = 20) -> torch.Tensor:
    """Minimize a smooth function of one tensor with L-BFGS; returns the
    final iterate.

    ``fun(x, grad) -> (f, g)``: the objective (a 0-d tensor) at ``x`` and,
    when ``grad`` is True, its gradient (None otherwise: the line search
    reads values only, as XLA drops the reference's unused gradients).
    Each step: the two-loop direction over the last ``history`` accepted
    (s, y) pairs, scaled by sᵀy/yᵀy of the newest; steepest descent where
    that is no descent direction; backtracking from t = 1, halving while
    f(x + t·p) > f + 1e-4·t·gᵀp, at most ``max_line_search`` times; the
    pair kept only where sᵀy > 1e-10; done once ‖g‖ < ``tol``.  Iterates
    and history are flat, as in the reference."""
    shape = x0.shape
    m = int(history)
    x = x0.reshape(-1).clone()

    def vag(v):
        f, g = fun(v.view(shape), True)
        return f, g.reshape(-1)

    f, g = vag(x)
    s_hist = torch.zeros((m, x.numel()), dtype=x.dtype, device=x.device)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros((m,), dtype=x.dtype, device=x.device)
    count = 0
    for _ in range(max_iter):
        # the two-loop recursion, newest pair first, then oldest first
        q = g
        k = min(count, m)
        alphas = {}
        for i in range(k):
            idx = (count - 1 - i) % m
            a = rho[idx] * torch.dot(s_hist[idx], q)
            q = q - a * y_hist[idx]
            alphas[idx] = a
        if count > 0:
            newest = (count - 1) % m
            gamma = torch.dot(s_hist[newest], y_hist[newest]) / torch.clamp(
                torch.dot(y_hist[newest], y_hist[newest]), min=1e-20)
            r = gamma * q
        else:
            r = q
        for i in range(k):
            idx = (count - k + i) % m
            beta = rho[idx] * torch.dot(y_hist[idx], r)
            r = r + (alphas[idx] - beta) * s_hist[idx]
        p = -r
        p = torch.where(torch.dot(p, g) < 0, p, -g)
        # backtracking Armijo, c1 = 1e-4, halving from t = 1
        gp = torch.dot(g, p)
        t = 1.0
        f_new = fun((x + p).view(shape), False)[0]
        STATS["trials"] += 1
        for _ls in range(max_line_search):
            STATS["host_reads"] += 1
            if not bool(f_new > f + 1e-4 * t * gp):
                break
            t *= 0.5
            f_new = fun((x + t * p).view(shape), False)[0]
            STATS["trials"] += 1
        x_new = x + t * p
        f_new, g_new = vag(x_new)
        s = x_new - x
        yv = g_new - g
        sy = torch.dot(s, yv)
        gnorm = torch.sqrt(torch.dot(g_new, g_new))
        ok, done = torch.stack([sy > 1e-10, gnorm < tol]).tolist()
        STATS["host_reads"] += 1
        STATS["iterations"] += 1
        if ok:  # the curvature condition; the pair is skipped otherwise
            idx = count % m
            s_hist[idx] = s
            y_hist[idx] = yv
            rho[idx] = 1.0 / torch.clamp(sy, min=1e-20)
            count += 1
        x, f, g = x_new, f_new, g_new
        if done:
            break
    return x.view(shape)


class DenseLBFGSwithL2(LabelEstimator):
    """Least squares + L2 by L-BFGS (LBFGS.scala § DenseLBFGSwithL2):
    loss(W) = 1/(2n)·‖XW − Y‖² + (λ/2)·‖W‖²; with ``fit_intercept`` on
    centred data, the intercept ȳ − x̄·W."""

    def __init__(self, lam: float = 0.0, num_iterations: int = 50, history: int = 10, fit_intercept: bool = False):
        self.lam = float(lam)
        self.num_iterations = int(num_iterations)
        self.history = int(history)
        self.fit_intercept = fit_intercept

    def params(self):
        return (self.lam, self.num_iterations, self.history, self.fit_intercept)

    def choose_physical(self, sample):
        """The dense-vs-sparse choice (the reference's NodeOptimizationRule
        picking LeastSquaresDenseGradient or LeastSquaresSparseGradient):
        host rows of scipy sparse matrices go to the sparse solver."""
        from keystone_tpu_torch.ops.sparse import is_scipy_sparse_rows

        if (type(self) is DenseLBFGSwithL2 and sample is not None and sample.is_host
                and is_scipy_sparse_rows(sample.items)):
            return SparseLBFGSwithL2(lam=self.lam, num_iterations=self.num_iterations, history=self.history,
                                     fit_intercept=self.fit_intercept)
        return self

    def fit_dataset(self, data: Dataset, labels: Optional[Dataset] = None) -> LinearMapper:
        if labels is None:
            raise ValueError("DenseLBFGSwithL2 requires labels")
        x = data.array[:data.n]
        return self._fit(x, labels.array[:labels.n].to(x.device))

    def fit_arrays(self, x, y=None, device="cuda") -> LinearMapper:
        dev = resolve_device(device)
        return self._fit(torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev))

    def _fit(self, x, y) -> LinearMapper:
        w, b = _lbfgs_least_squares(x.to(torch.float32), y.to(torch.float32), self.lam, self.num_iterations,
                                    self.history, self.fit_intercept)
        return LinearMapper(w, b if self.fit_intercept else None)


class SparseLBFGSwithL2(DenseLBFGSwithL2):
    """The sparse-gradient variant (LBFGS.scala § SparseLBFGSwithL2 /
    LeastSquaresSparseGradient): rows stay nnz-bucketed COO on the device
    (``ops/sparse.py``), the forward a gather, the gradient a
    scatter-add into (d, k).  ``fit_intercept`` adds a constant feature
    (index d, value 1) whose weight is left out of the L2 penalty.
    Takes a host Dataset of scipy sparse rows, a Padded/BucketedSparseRows
    through ``fit_sparse``, or dense rows (the dense solver)."""

    # already the sparse form: the base hook, so that NodeChoiceRule skips it
    choose_physical = LabelEstimator.choose_physical

    def fit_dataset(self, data: Dataset, labels: Optional[Dataset] = None) -> LinearMapper:
        from keystone_tpu_torch.ops.sparse import BucketedSparseRows, is_scipy_sparse_rows

        if labels is None:
            raise ValueError("SparseLBFGSwithL2 requires labels")
        if data.is_host and is_scipy_sparse_rows(data.items):
            sp = BucketedSparseRows.from_scipy_rows(data.items, device=data.device)
            return self.fit_sparse(sp, labels.array, n=data.n)
        return super().fit_dataset(data, labels)

    def _capped_history(self, d_aug: int, k: int, device) -> int:
        """The history length m, capped so that its 2·m weight-sized
        buffers stay within a fifth of the device's memory (the line
        search holds about six more)."""
        from keystone_tpu_torch.workflow.profiling import device_hbm_budget

        per_pair = 2 * d_aug * k * 4
        history = min(self.history, max(2, int(device_hbm_budget(0.2, device) // per_pair)))
        if history < self.history:
            logging.getLogger(__name__).info(
                "sparse L-BFGS: history %d -> %d (weight-sized pairs are %.2f GB each; keeping them under 20%% of "
                "device memory)", self.history, history, per_pair / 2**30)
        return history

    def fit_sparse(self, sp, y, n: Optional[int] = None) -> LinearMapper:
        """Fit from a PaddedSparseRows or BucketedSparseRows."""
        from keystone_tpu_torch.ops.sparse import bucketize_with_labels

        d = sp.num_features
        intercept = bool(self.fit_intercept)
        bidx, bvals, by, n, d_aug, _ = bucketize_with_labels(sp, y, n=n, intercept=intercept)
        k = by[0].shape[1]
        history = self._capped_history(d_aug, k, by[0].device)
        w = _lbfgs_sparse_least_squares(bidx, bvals, by, n, d_aug, self.lam, self.num_iterations, history,
                                        intercept)
        if intercept:
            return LinearMapper(w[:d], w[d])
        return LinearMapper(w, None)


def _sparse_vag(data, w, grad: bool, *, d: int, intercept: bool):
    """The sparse least-squares objective, bucket by bucket: ``data =
    (bidx, bvals, by, n, lam)``; padding rows carry value-0 entries and
    zero labels.  With ``intercept`` the last weight row is the bias,
    out of the penalty."""
    from keystone_tpu_torch.ops.sparse import sparse_grad, sparse_matmul

    bidx, bvals, by, n, lam = data
    wp = w
    if intercept:
        reg = torch.ones((d, 1), dtype=torch.float32, device=w.device)
        reg[d - 1] = 0.0
        wp = w * reg
    f = 0.5 * lam * torch.sum(wp * wp)
    g = lam * wp if grad else None
    for idx, vals, y in zip(bidx, bvals, by):
        r = sparse_matmul(idx, vals, w) - y
        f = f + 0.5 * torch.sum(r * r) / n
        if grad:
            g = g + sparse_grad(idx, vals, r, d) / n
    return f, g


def _lbfgs_sparse_least_squares(bidx, bvals, by, n, d, lam, num_iterations, history, intercept=False):
    """Sparse L-BFGS from zero weights (objective: ``_sparse_vag``)."""
    data = (bidx, bvals, by, float(n), lam)
    w0 = torch.zeros((d, by[0].shape[1]), dtype=torch.float32, device=by[0].device)
    return lbfgs_minimize(lambda w, grad: _sparse_vag(data, w, grad, d=d, intercept=intercept), w0,
                          max_iter=num_iterations, history=history)


def _lbfgs_center(x, y, fit_intercept: bool):
    """The intercept's centring: (xc, yc, x̄, ȳ)."""
    n = x.shape[0]
    if fit_intercept:
        xm = torch.sum(x, dim=0) / n
        ym = torch.sum(y, dim=0) / n
        return x - xm, y - ym, xm, ym
    return (x, y, torch.zeros((x.shape[1],), dtype=torch.float32, device=x.device),
            torch.zeros((y.shape[1],), dtype=torch.float32, device=y.device))


def _dense_vag(data, w, grad: bool):
    """The dense least-squares objective, ``data = (xc, yc, n, lam)``."""
    xc, yc, n, lam = data
    r = xc @ w - yc
    f = 0.5 * torch.sum(r * r) / n + 0.5 * lam * torch.sum(w * w)
    return f, (xc.T @ r / n + lam * w) if grad else None


def _lbfgs_least_squares(x, y, lam, num_iterations, history, fit_intercept):
    xc, yc, xm, ym = _lbfgs_center(x, y, fit_intercept)
    data = (xc, yc, float(x.shape[0]), lam)
    w0 = torch.zeros((x.shape[1], y.shape[1]), dtype=torch.float32, device=x.device)
    w = lbfgs_minimize(lambda w_, grad: _dense_vag(data, w_, grad), w0, max_iter=num_iterations, history=history)
    b = ym - xm @ w if fit_intercept else torch.zeros((y.shape[1],), dtype=torch.float32, device=x.device)
    return w, b


