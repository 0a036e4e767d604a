"""Exact least-squares solvers (counterpart of ``keystone_tpu/models/linear.py``
§ LinearMapper, LinearMapEstimator, LocalLeastSquaresEstimator,
_fit_normal_equations; reference nodes/learning/LinearMapper.scala and
LocalLeastSquaresEstimator.scala).

The normal equations (XᵀX + λn·I) W = XᵀY, centred explicitly before the
Gramian when there is an intercept, solved by Cholesky
(``models/common.py::solve_spd``); scipy sparse rows go to the sparse
L-BFGS solver (``models/lbfgs.py``).  In memory and streamed the fit is one
path, ``LinearMapEstimator.fit_stream``: an in-memory fit streams
4096-row views of its tensors.  The Gramians are f32 products of row
blocks, Kahan-summed (``models/common.py::gram``); the pipelines turn
TF32 off, so they are true f32 on the card.

In a job of several ranks (``parallel/``) each rank streams its own row
slice and the sums (the means' row sums and counts, the Gramians)
all-reduce over the mesh's data axis: every rank then solves the same
normal equations, as the reference's driver-side solve after its
treeReduce.  On the local mesh the all-reduces are the identity.
"""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.models.common import gram, kahan_add, row_blocks, solve_spd
from keystone_tpu_torch.parallel import collectives, require_one_rank, require_rank_slice
from keystone_tpu_torch.parallel import mesh as _mesh
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.estimator import LabelEstimator
from keystone_tpu_torch.workflow.transformer import Transformer, tensor_identity

#: n·d at or below which ``LinearMapEstimator.choose_physical`` picks the
#: local solve: the reference's choice rule (its crossover was measured on
#: its own devices, not on this card), kept so that both packages pick the
#: same solver for the same data.
_LOCAL_SOLVE_MAX_ELEMENTS = 1 << 21


class LinearMapper(Transformer):
    """x·W + b (LinearMapper.scala § LinearMapper)."""

    def __init__(self, weights: torch.Tensor, intercept: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weights", weights)  # (d, k)
        self.register_buffer("intercept", intercept)  # (k,) or None

    def params(self):
        return tensor_identity(self.weights, self.intercept)

    def apply_batch(self, xs, mask=None):
        out = torch.matmul(xs.to(torch.float32), self.weights)
        return out if self.intercept is None else out + self.intercept

    def apply_dataset(self, ds: Dataset) -> Dataset:
        # scipy sparse rows score by gathering weight rows (the sparse
        # solvers' features): n×d never densifies
        from keystone_tpu_torch.ops.sparse import is_scipy_sparse_rows, score_sparse_dataset

        if ds.is_host and is_scipy_sparse_rows(ds.items):
            return score_sparse_dataset(ds, self.weights, self.intercept)
        return super().apply_dataset(ds)


class LinearMapEstimator(LabelEstimator):
    """Exact ridge least squares through the normal equations
    (LinearMapper.scala § LinearMapEstimator).  With ``fit_intercept`` the
    solve runs on centred data and the intercept is ȳ − x̄·W.  A
    ``StreamDataset`` is fitted out of core by ``fit_stream``."""

    def __init__(self, lam: float = 0.0, fit_intercept: bool = True):
        self.lam = float(lam)
        self.fit_intercept = fit_intercept

    def params(self):
        return (self.lam, self.fit_intercept)

    def choose_physical(self, sample, full_n=None):
        """The reference's physical choice: scipy sparse host rows go to the
        sparse L-BFGS solver, which minimizes the same objective
        (1/(2n)‖XW−Y‖² + λ/2‖W‖², whose minimum solves (XᵀX+λnI)W = XᵀY)
        without densifying n×d or forming d×d, an intercept kept as an
        unpenalized constant column; and a dense problem of at most
        ``_LOCAL_SOLVE_MAX_ELEMENTS`` entries (the full row count times the
        sample's width) to the local solve."""
        from keystone_tpu_torch.ops.sparse import is_scipy_sparse_rows

        if sample is not None and sample.is_host and is_scipy_sparse_rows(sample.items):
            from keystone_tpu_torch.models.lbfgs import SparseLBFGSwithL2

            return SparseLBFGSwithL2(lam=self.lam, num_iterations=100, fit_intercept=self.fit_intercept)
        if (sample is not None and not sample.is_host and full_n is not None and sample.array.ndim == 2
                and full_n * sample.array.shape[1] <= _LOCAL_SOLVE_MAX_ELEMENTS
                and _mesh.data_size() == 1):  # the local solve sees one rank's rows
            return LocalLeastSquaresEstimator(lam=self.lam, fit_intercept=self.fit_intercept)
        return self

    def fit_dataset(self, data: Dataset, labels: Optional[Dataset] = None) -> LinearMapper:
        if labels is None:
            raise ValueError("LinearMapEstimator requires labels")
        if data.is_host:
            from keystone_tpu_torch.ops.sparse import is_scipy_sparse_rows

            # sparse rows fit here too where no optimizer chose for them
            if is_scipy_sparse_rows(data.items):
                return self.choose_physical(data).fit_dataset(data, labels)
            raise TypeError("LinearMapEstimator fits dense or scipy sparse rows; featurize the host payload first")
        if isinstance(data, StreamDataset):
            # out of core: the labels (n, k) stay in memory, the features
            # stream past the accumulators, batch by batch
            y = labels.array[:labels.n].to(data.device)

            def pairs():
                lo = 0
                for b, _ in data.device_batches():
                    yield b, y[lo:lo + b.shape[0]]
                    lo += b.shape[0]

            return self.fit_stream(pairs)
        require_rank_slice(data, "LinearMapEstimator")
        return self._fit(data.array[:data.local_n], labels.array[:labels.local_n].to(data.device))

    @_mesh.on_local_mesh
    def fit_arrays(self, x, y=None, device="cuda") -> LinearMapper:
        """x (n, d), y (n, k), numpy or tensors; fitted on ``device``."""
        dev = resolve_device(device)
        return self._fit(torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev))

    def _fit(self, x, y) -> LinearMapper:
        return self.fit_stream(lambda: row_blocks(x, y))

    def fit_stream(self, batches) -> LinearMapper:
        """Exact least squares from a stream of ``(x, y)`` batches, numpy or
        tensors (a callable returning a fresh iterator, or a re-iterable),
        on the first batch's device (numpy batches: the card).  The device
        holds one batch and the (d, d), (d, k) accumulators.

        With ``fit_intercept`` two passes, as the reference: the means,
        then the Gramians of explicitly centred batches; every sum is
        Kahan-compensated across batches.  Each rank of a job streams its
        own rows: the sums and counts all-reduce over the data axis."""
        get = batches if callable(batches) else lambda: iter(batches)
        dev = None

        def staged():
            nonlocal dev
            for bx, by in get():
                if dev is None:
                    dev = bx.device if isinstance(bx, torch.Tensor) else resolve_device()
                yield (torch.as_tensor(bx).to(dev, torch.float32), torch.as_tensor(by).to(dev, torch.float32))

        spread = _mesh.current_mesh().group(_mesh.DATA_AXIS) is not None
        xm = ym = None
        n = 0
        if self.fit_intercept:
            sx = cx = sy = cy = None
            for x, y in staged():
                n += x.shape[0]
                sx, cx = kahan_add(sx, cx, x.sum(dim=0))
                sy, cy = kahan_add(sy, cy, y.sum(dim=0))
            if sx is None:
                raise ValueError("empty batch stream")
            n_all = n
            if spread:  # one all-reduce of the row sums and the count, in f64 (counts past 2^24 stay exact)
                sx, sy, count = collectives.psum_many(sx.double(), sy.double(), sx.new_tensor(n, dtype=torch.float64))
                sx, sy, n_all = sx.float(), sy.float(), int(count.item())
            xm, ym = sx / n_all, sy / n_all
        sxx, sxy, n2 = gram(staged(), center=None if xm is None else (xm, ym))
        if self.fit_intercept and n2 != n:
            raise ValueError(f"batch stream is not re-iterable: first pass saw {n} rows, second pass {n2}. Pass a "
                             "callable returning a fresh iterator (or a re-iterable like a list).")
        if sxx is None:
            raise ValueError("empty batch stream")
        if spread:
            sxx, sxy = collectives.psum_many(sxx, sxy)
            n2 = int(collectives.psum(sxx.new_tensor([n2], dtype=torch.float64))[0].item())
        w = solve_spd(sxx, sxy, reg=self.lam * n2)
        return LinearMapper(w, None if xm is None else ym - xm @ w)


#: the reference's alias
LeastSquaresEstimator = LinearMapEstimator


class LocalLeastSquaresEstimator(LabelEstimator):
    """The exact solve on one device, the physical alternative the
    optimizer picks for small problems (LocalLeastSquaresEstimator.scala):
    with λ > 0 the regularized normal equations, with λ = 0 a QR
    least-squares solve (``torch.linalg.lstsq``)."""

    def __init__(self, lam: float = 0.0, fit_intercept: bool = True):
        self.lam = float(lam)
        self.fit_intercept = bool(fit_intercept)

    def params(self):
        return (self.lam, self.fit_intercept)

    def fit_dataset(self, data: Dataset, labels: Optional[Dataset] = None) -> LinearMapper:
        if labels is None:
            raise ValueError("LocalLeastSquaresEstimator requires labels")
        if data.is_rank_slice and self.lam > 0.0:  # the normal equations sum over the ranks
            return LinearMapEstimator(self.lam, self.fit_intercept).fit_dataset(data, labels)
        if data.is_rank_slice:
            require_one_rank("LocalLeastSquaresEstimator's QR solve (lam=0)")
        return self._fit(data.array[:data.n], labels.array[:labels.n].to(data.device))

    @_mesh.on_local_mesh
    def fit_arrays(self, x, y=None, device="cuda") -> LinearMapper:
        dev = resolve_device(device)
        return self._fit(torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev))

    def _fit(self, x, y) -> LinearMapper:
        x, y = x.to(torch.float32), y.to(torch.float32)
        if self.lam > 0.0:
            return LinearMapEstimator(self.lam, self.fit_intercept)._fit(x, y)
        if not self.fit_intercept:
            return LinearMapper(torch.linalg.lstsq(x, y).solution, None)
        xm, ym = x.mean(dim=0), y.mean(dim=0)
        w = torch.linalg.lstsq(x - xm, y - ym).solution
        return LinearMapper(w, ym - xm @ w)
