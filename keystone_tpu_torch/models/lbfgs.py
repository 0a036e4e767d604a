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

``lbfgs_minimize_resumable`` runs the same steps in chunks of
``checkpoint_every`` and persists the full optimizer carry (iterate,
objective, gradient, s/y/ρ history, count, done) between chunks through
``utils/durable``, under a content fingerprint of the problem (the
reference's, so either package resumes the other's checkpoint file).
An interrupted fit (``fit_checkpointed``) resumes from the last saved
carry on the same trajectory.  With a run ledger each effective step
reports its objective and gradient norm, and each chunk its seconds and
its save's (``solver.epoch``); without one the loop reads nothing more
than the reads counted in ``STATS``.

In a job of several ranks (``parallel/``) each rank holds its row slice:
the objective's and gradient's row sums all-reduce over the mesh's data
axis (one all-reduce an evaluation) before the penalty is added, so every
rank takes the same steps on the same carry.  A checkpointed fit saves
on rank 0 only and resumes from rank 0's read, broadcast to every rank;
its fingerprint covers every rank's first rows.  Each rank's own sums
stay in a fixed order (the sparse gradient's ``scatter_plan``), so a
resumed job repeats the uninterrupted one bit for bit.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.parallel import collectives, multihost, require_rank_slice
from keystone_tpu_torch.parallel import mesh as _mesh
from keystone_tpu_torch.utils import durable, precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, as_dataset
from keystone_tpu_torch.workflow.estimator import LabelEstimator

#: summed over fits until ``reset_stats``: L-BFGS iterations, line-search
#: trials (objective evaluations in the line search) and host reads of
#: device values (one a line-search test, one an iteration)
STATS = {"iterations": 0, "trials": 0, "host_reads": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def _lbfgs_machinery(fun: Callable, shape, m: int, tol: float, max_line_search: int,
                     obs_label: Optional[str] = None):
    """``(init, step)`` over flat iterates.  ``init(x0_flat)`` builds the
    carry ``[x, f, g, s_hist, y_hist, rho_hist, count, done]``, exactly the
    state a mid-fit checkpoint persists; ``step(carry)`` makes one L-BFGS
    step and returns the new carry (the same one, untouched, once done).
    ``obs_label``: each effective step reports its objective and gradient
    norm to an active run ledger."""

    def vag(v):
        f, g = fun(v.view(shape), True)
        return f, g.reshape(-1)

    def init(x0_flat):
        x = x0_flat.clone()
        f, g = vag(x)
        s_hist = torch.zeros((m, x.numel()), dtype=x.dtype, device=x.device)
        return [x, f, g, s_hist, torch.zeros_like(s_hist), torch.zeros((m,), dtype=x.dtype, device=x.device), 0,
                False]

    def step(carry):
        x, f, g, s_hist, y_hist, rho, count, done = carry
        if done:
            return carry
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
        if obs_label is not None and ledger.active() is not None:
            ledger.solver_epoch(obs_label, objective=float(f_new), grad_norm=float(gnorm))
        if ok:  # the curvature condition; the pair is skipped otherwise
            idx = count % m
            s_hist[idx] = s
            y_hist[idx] = yv
            rho[idx] = 1.0 / torch.clamp(sy, min=1e-20)
            count += 1
        return [x_new, f_new, g_new, s_hist, y_hist, rho, count, bool(done)]

    return init, step


def lbfgs_minimize(fun: Callable, x0: torch.Tensor, max_iter: int = 50, history: int = 10, tol: float = 1e-7,
                   max_line_search: int = 20, obs_label: Optional[str] = None) -> torch.Tensor:
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
    init, step = _lbfgs_machinery(fun, shape, int(history), tol, max_line_search, obs_label)
    carry = init(x0.reshape(-1))
    for _ in range(max_iter):
        carry = step(carry)
        if carry[7]:
            break
    return carry[0].view(shape)


#: the names of a carry's entries in a checkpoint file (the reference's)
_CARRY_KEYS = ("x", "f", "g", "s_hist", "y_hist", "rho_hist", "count", "done")


def lbfgs_minimize_resumable(fun: Callable, x0: torch.Tensor, max_iter: int, history: int, tol: float = 1e-7,
                             max_line_search: int = 20, checkpoint_every: int = 10, save_cb=None, load_cb=None
                             ) -> torch.Tensor:
    """L-BFGS in chunks of ``checkpoint_every`` steps, with the full carry
    handed to ``save_cb(it_done, carry)`` after each chunk; ``load_cb() ->
    (it_done, host_carry) | None`` gives the carry to resume from.  The
    steps are ``lbfgs_minimize``'s, so a resumed fit follows the
    uninterrupted trajectory.  A checkpoint of a longer completed fit
    (its ``it`` past ``max_iter``) is not resumed: the fit starts over."""
    shape = x0.shape
    init, step = _lbfgs_machinery(fun, shape, int(history), tol, max_line_search)
    start, carry = 0, None
    if load_cb is not None:
        loaded = load_cb()
        if loaded is not None and loaded[0] <= max_iter:
            start, host = loaded
            carry = _carry_from_host(host, x0.device)
    if carry is None:
        start = 0
        carry = init(x0.reshape(-1))
    observe = ledger.active() is not None
    it = start
    while it < max_iter:
        t_chunk = time.perf_counter()
        n_steps = min(checkpoint_every, max_iter - it)
        for _ in range(n_steps):
            carry = step(carry)
        it += n_steps
        save_seconds = None
        if save_cb is not None:
            ledger.device_wait(carry[:6], force=True)  # the host copies read them
            t_save = time.perf_counter()
            save_cb(it, carry)
            save_seconds = time.perf_counter() - t_save
            metrics.observe("solver.checkpoint_save_seconds", save_seconds)
        if observe:
            f, gnorm = _carry_stats(carry[1], carry[2])
            ledger.solver_epoch("lbfgs.chunk", it=int(it), objective=f, grad_norm=gnorm,
                                chunk_seconds=time.perf_counter() - t_chunk, checkpoint_save_seconds=save_seconds)
    return carry[0].view(shape)


def _carry_stats(f, g):
    """(objective, ‖g‖) of a carry, in one host read."""
    vals = torch.stack([f.reshape(()).to(torch.float32), torch.sqrt(torch.dot(g, g))]).tolist()
    return vals[0], vals[1]


def _carry_to_host(carry) -> dict:
    """A carry as the checkpoint's arrays (count int32, done bool)."""
    x, f, g, s_hist, y_hist, rho, count, done = carry
    arrays = [t.detach().cpu().numpy() for t in (x, f, g, s_hist, y_hist, rho)]
    arrays[1] = np.float32(arrays[1])
    return dict(zip(_CARRY_KEYS, arrays + [np.int32(count), np.bool_(done)]))


def _carry_from_host(host, device) -> list:
    x, f, g, s_hist, y_hist, rho, count, done = host
    tensors = [torch.from_numpy(np.array(a, np.float32)).to(device) for a in (x, f, g, s_hist, y_hist, rho)]
    return tensors + [int(count), bool(done)]


def _lbfgs_checkpoint_callbacks(checkpoint_dir: str, problem: str, tag: str, flat_size: int, m: int):
    """``(load_cb, save_cb)`` keeping the L-BFGS carry in
    ``<dir>/lbfgs_<tag>.npz`` through ``utils/durable`` (atomic, BLAKE2b
    sidecar, the previous chunk's carry kept as the fallback), held to
    the problem's fingerprint and the carry's shapes: a different fit's
    checkpoint is stale, not corrupt, and is not resumed."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, f"lbfgs_{tag}.npz")
    shapes = ((flat_size,), (), (flat_size,), (m, flat_size), (m, flat_size), (m,), (), ())

    def valid(z) -> bool:
        if str(z.get("problem")) != problem:
            return False
        return all(np.asarray(z[k]).shape == sh for k, sh in zip(_CARRY_KEYS, shapes))

    template = (np.zeros((flat_size,), np.float32), np.float32(0), np.zeros((flat_size,), np.float32),
                np.zeros((m, flat_size), np.float32), np.zeros((m, flat_size), np.float32),
                np.zeros((m,), np.float32), np.int32(0), np.bool_(False))

    def read():
        loaded = durable.load_npz(path, validate=valid)
        if loaded is None:
            return None
        z, _ = loaded
        return int(z["it"]), tuple(np.asarray(z[k]) for k in _CARRY_KEYS)

    def load_cb():
        if _mesh.world_size() <= 1:
            return read()
        # rank 0 decides and broadcasts: every rank resumes at one iteration
        got = read() if multihost.process_index() == 0 else None
        it = int(multihost.broadcast_host([np.asarray([-1 if got is None else got[0]], np.int64)])[0][0])
        if it < 0:
            return None
        carry = got[1] if got is not None else template
        carry = multihost.broadcast_host([np.asarray(a, t.dtype).reshape(-1) for a, t in zip(carry, template)])
        return it, tuple(a.reshape(t.shape) for a, t in zip(carry, template))

    def save_cb(it, carry):
        # the carry is the same on every rank: one writer, and only it pays the copy
        if multihost.process_index() != 0:
            return
        durable.save_npz(path, dict(_carry_to_host(carry), it=np.int32(it), problem=problem), keep=2)

    return load_cb, save_cb


def _row_sums(f, g, mesh=None):
    """The data terms of an objective and its gradient (None: not asked
    for), summed over the mesh's data axis in one all-reduce."""
    if g is None:
        return collectives.psum_many(f, mesh=mesh)[0], None
    return collectives.psum_many(f, g, mesh=mesh)


def _gathered_rows(*tensors) -> bytes:
    """The first row of each tensor, every rank's concatenated in rank
    order above a world of one: the fingerprints' content probe."""
    return b"".join(multihost.gather_to_host(t[:1].cpu().numpy()).tobytes() for t in tensors)


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
        require_rank_slice(data, "DenseLBFGSwithL2")
        x = data.array[:data.local_n]
        return self._fit(x, labels.array[:labels.local_n].to(x.device), data.n)

    @_mesh.on_local_mesh
    def fit_arrays(self, x, y=None, device="cuda") -> LinearMapper:
        dev = resolve_device(device)
        return self._fit(torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev))

    def _fit(self, x, y, n=None) -> LinearMapper:
        """x, y: this rank's valid rows; ``n`` the count over every rank
        (default: x's rows)."""
        w, b = _lbfgs_least_squares(x.to(torch.float32), y.to(torch.float32), self.lam, self.num_iterations,
                                    self.history, self.fit_intercept, n)
        return LinearMapper(ledger.device_wait(w), b if self.fit_intercept else None)

    def fit_checkpointed(self, data, labels=None, checkpoint_dir: Optional[str] = None,
                         checkpoint_every: int = 10) -> LinearMapper:
        """The fit with a mid-fit checkpoint and resume: the optimizer
        carry is saved every ``checkpoint_every`` iterations to
        ``checkpoint_dir/lbfgs_dense.npz``, and an interrupted fit resumes
        from the last saved carry on the same trajectory.  Data that is
        not a Dataset goes to the card (``as_dataset``)."""
        if labels is None:
            raise ValueError("fit_checkpointed requires labels")
        if checkpoint_dir is None:
            return self.fit_dataset(as_dataset(data), as_dataset(labels))
        data = as_dataset(data)
        labels = as_dataset(labels, device=data.device)
        require_rank_slice(data, "DenseLBFGSwithL2.fit_checkpointed")
        x = data.array[:data.local_n].to(torch.float32)
        w, b = _lbfgs_dense_checkpointed(x, labels.array[:labels.local_n].to(x.device, torch.float32), self.lam,
                                         self.num_iterations, self.history, self.fit_intercept, checkpoint_dir,
                                         checkpoint_every, data.n)
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
            require_rank_slice(data, "SparseLBFGSwithL2")
            sp = BucketedSparseRows.from_scipy_rows(data.items, device=data.device)
            return self.fit_sparse(sp, labels.array, n=data.local_n)
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

    def fit_sparse(self, sp, y, n: Optional[int] = None, checkpoint_dir: Optional[str] = None,
                   checkpoint_every: int = 10) -> LinearMapper:
        """Fit from a PaddedSparseRows or BucketedSparseRows (in a job of
        several ranks, this rank's rows: ``n`` its valid rows, the count
        over every rank summed over the data axis).  With
        ``checkpoint_dir`` the carry is saved every ``checkpoint_every``
        iterations to ``lbfgs_sparse.npz`` there, and an interrupted fit
        resumes from it."""
        from keystone_tpu_torch.ops.sparse import bucketize_with_labels

        d = sp.num_features
        intercept = bool(self.fit_intercept)
        bidx, bvals, by, n, d_aug, _ = bucketize_with_labels(sp, y, n=n, intercept=intercept)
        if _mesh.current_mesh().data > 1:
            n = multihost.data_axis_sum(n)
        k = by[0].shape[1]
        history = self._capped_history(d_aug, k, by[0].device)
        if checkpoint_dir is None:
            w = _lbfgs_sparse_least_squares(bidx, bvals, by, n, d_aug, self.lam, self.num_iterations, history,
                                            intercept)
        else:
            w = _lbfgs_sparse_checkpointed(bidx, bvals, by, n, d_aug, self.lam, self.num_iterations, history,
                                           intercept, checkpoint_dir, checkpoint_every)
        w = ledger.device_wait(w)
        if intercept:
            return LinearMapper(w[:d], w[d])
        return LinearMapper(w, None)

    def fit_checkpointed(self, data, labels=None, checkpoint_dir: Optional[str] = None,
                         checkpoint_every: int = 10, n: Optional[int] = None) -> LinearMapper:
        """The sparse fit with a mid-fit checkpoint and resume.  ``data``: a
        host Dataset of scipy sparse rows, a Padded/BucketedSparseRows, or
        dense rows (the dense checkpointed fit)."""
        from keystone_tpu_torch.ops.sparse import BucketedSparseRows, is_scipy_sparse_rows

        if labels is None:
            raise ValueError("fit_checkpointed requires labels")
        y = labels.array if isinstance(labels, Dataset) else labels
        if not isinstance(data, Dataset) and not hasattr(data, "num_features"):
            data = as_dataset(data)  # dense rows: the card unless they are on the CPU
        if isinstance(data, Dataset):
            if data.is_host and is_scipy_sparse_rows(data.items):
                require_rank_slice(data, "SparseLBFGSwithL2.fit_checkpointed")
                sp = BucketedSparseRows.from_scipy_rows(data.items, device=data.device)
                n = data.local_n
            else:
                return super().fit_checkpointed(data, labels, checkpoint_dir, checkpoint_every)
        else:
            sp = data
        return self.fit_sparse(sp, y, n=n, checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)


def _sparse_vag(data, w, grad: bool, *, d: int, intercept: bool, plans=None):
    """The sparse least-squares objective, bucket by bucket: ``data =
    (bidx, bvals, by, n, lam)``; padding rows carry value-0 entries and
    zero labels.  With ``intercept`` the last weight row is the bias,
    out of the penalty.  ``plans``: each bucket's ``scatter_plan``, for
    the gradient's sums in a fixed order."""
    from keystone_tpu_torch.ops.sparse import sparse_grad, sparse_matmul

    bidx, bvals, by, n, lam = data
    wp = w
    if intercept:
        reg = torch.ones((d, 1), dtype=torch.float32, device=w.device)
        reg[d - 1] = 0.0
        wp = w * reg
    # the row terms from zero, summed over the data axis, then the penalty
    # once: the same order at every world size
    f = torch.zeros((), dtype=torch.float32, device=w.device)
    g = torch.zeros_like(w) if grad else None
    for b, (idx, vals, y) in enumerate(zip(bidx, bvals, by)):
        r = sparse_matmul(idx, vals, w) - y
        f = f + 0.5 * torch.sum(r * r) / n
        if grad:
            g = g + sparse_grad(idx, vals, r, d, None if plans is None else plans[b]) / n
    f, g = _row_sums(f, g)
    f = f + 0.5 * lam * torch.sum(wp * wp)
    g = None if g is None else g + lam * wp
    return f, g


def _lbfgs_sparse_least_squares(bidx, bvals, by, n, d, lam, num_iterations, history, intercept=False):
    """Sparse L-BFGS from zero weights (objective: ``_sparse_vag``)."""
    data = (bidx, bvals, by, float(n), lam)
    w0 = torch.zeros((d, by[0].shape[1]), dtype=torch.float32, device=by[0].device)
    return lbfgs_minimize(lambda w, grad: _sparse_vag(data, w, grad, d=d, intercept=intercept), w0,
                          max_iter=num_iterations, history=history, obs_label="lbfgs.sparse")


def _lbfgs_sparse_checkpointed(bidx, bvals, by, n, d, lam, num_iterations, history, intercept, checkpoint_dir,
                               checkpoint_every):
    """Sparse L-BFGS by the resumable loop: ``_lbfgs_sparse_least_squares``'s
    steps, cut into checkpointed chunks, with the gradient's sums in a
    fixed order (``scatter_plan``, made once), so that a resumed fit
    repeats the uninterrupted one bit for bit on the card as on the CPU.  The fingerprint is the
    reference's: the bucket shapes, d, λ, n, the intercept and history,
    and the first row of the first bucket (indices as int32)."""
    from keystone_tpu_torch.ops.sparse import scatter_plan

    k = by[0].shape[1]
    fp = hashlib.sha256()
    fp.update(repr((tuple(tuple(i.shape) for i in bidx), tuple(tuple(yy.shape) for yy in by), int(d), float(lam),
                    float(n), bool(intercept), int(history), "sparse-v1")).encode())
    fp.update(_gathered_rows(bidx[0].to(torch.int32), bvals[0], by[0]))
    load_cb, save_cb = _lbfgs_checkpoint_callbacks(checkpoint_dir, fp.hexdigest(), "sparse", d * k, history)
    data = (bidx, bvals, by, float(n), lam)
    plans = [scatter_plan(idx, k) for idx in bidx]
    w0 = torch.zeros((d, k), dtype=torch.float32, device=by[0].device)
    return lbfgs_minimize_resumable(lambda w, grad: _sparse_vag(data, w, grad, d=d, intercept=intercept,
                                                                plans=plans), w0,
                                    max_iter=num_iterations, history=history, checkpoint_every=checkpoint_every,
                                    save_cb=save_cb, load_cb=load_cb)


def _lbfgs_center(x, y, fit_intercept: bool, n=None):
    """The intercept's centring: (xc, yc, x̄, ȳ), the means over the ``n``
    rows of every rank (default: x's rows)."""
    n = x.shape[0] if n is None else n
    if fit_intercept:
        sx, sy = collectives.psum_many(torch.sum(x, dim=0), torch.sum(y, dim=0))
        xm = sx / n
        ym = sy / n
        return x - xm, y - ym, xm, ym
    return (x, y, torch.zeros((x.shape[1],), dtype=torch.float32, device=x.device),
            torch.zeros((y.shape[1],), dtype=torch.float32, device=y.device))


def _dense_vag(data, w, grad: bool):
    """The dense least-squares objective, ``data = (xc, yc, n, lam)``: the
    row terms (all-reduced across ranks), then the penalty."""
    xc, yc, n, lam = data
    r = xc @ w - yc
    f, g = _row_sums(0.5 * torch.sum(r * r) / n, precision.sdot_t(xc, r) / n if grad else None)
    return f + 0.5 * lam * torch.sum(w * w), (g + lam * w) if grad else None


def _lbfgs_least_squares(x, y, lam, num_iterations, history, fit_intercept, n=None):
    n = x.shape[0] if n is None else n
    xc, yc, xm, ym = _lbfgs_center(x, y, fit_intercept, n)
    data = (xc, yc, float(n), lam)
    w0 = torch.zeros((x.shape[1], y.shape[1]), dtype=torch.float32, device=x.device)
    w = lbfgs_minimize(lambda w_, grad: _dense_vag(data, w_, grad), w0, max_iter=num_iterations, history=history,
                       obs_label="lbfgs.dense")
    b = ym - xm @ w if fit_intercept else torch.zeros((y.shape[1],), dtype=torch.float32, device=x.device)
    return w, b


def _lbfgs_dense_checkpointed(x, y, lam, num_iterations, history, fit_intercept, checkpoint_dir,
                              checkpoint_every, n=None):
    """Dense L-BFGS by the resumable loop: ``_lbfgs_least_squares``'s
    steps, cut into checkpointed chunks.  The fingerprint is the
    reference's: the shapes (of all ``n`` rows), λ, n, the intercept and
    history, and the first rows of x and y (every rank's)."""
    n = x.shape[0] if n is None else n
    d, k = x.shape[1], y.shape[1]
    fp = hashlib.sha256()
    fp.update(repr(((n, d), (n, k), float(lam), int(n), bool(fit_intercept), int(history),
                    "dense-v1")).encode())
    fp.update(_gathered_rows(x, y))
    load_cb, save_cb = _lbfgs_checkpoint_callbacks(checkpoint_dir, fp.hexdigest(), "dense", d * k, history)
    xc, yc, xm, ym = _lbfgs_center(x, y, fit_intercept, n)
    data = (xc, yc, float(n), lam)
    w0 = torch.zeros((d, k), dtype=torch.float32, device=x.device)
    w = lbfgs_minimize_resumable(lambda w_, grad: _dense_vag(data, w_, grad), w0, max_iter=num_iterations,
                                 history=history, checkpoint_every=checkpoint_every, save_cb=save_cb,
                                 load_cb=load_cb)
    b = ym - xm @ w if fit_intercept else torch.zeros((k,), dtype=torch.float32, device=x.device)
    return w, b
