"""Sparse feature rows on the device: padded COO rows (counterpart of
``keystone_tpu/ops/sparse.py`` § is_scipy_sparse_rows, PaddedSparseRows,
sparse_matmul, BucketedSparseRows, host_onehot, bucketize_with_labels,
score_sparse_dataset, sparse_grad; reference nodes/learning/LBFGS.scala §
LeastSquaresSparseGradient).

Each row carries up to ``nnz_max`` (index, value) pairs; padding entries
have value 0.0 (index 0), so they add nothing to the forward gather or
the gradient's scatter-add and need no mask.  Memory is n·nnz·8 bytes in
place of n·d·4, which is what lets the text pipelines keep 10⁵-wide
vocabularies sparse.

The gathers and scatter-adds are torch's own indexing and
``index_add_``: the reference computes them with plain XLA ops outside
any Pallas kernel.  ``index_add_`` on a CUDA tensor adds in no fixed
order, so two computations of one gradient on the card may differ in the
last bits of f32; on the CPU they repeat bit for bit.  Given a
``scatter_plan`` (the checkpointed L-BFGS's), ``sparse_grad`` sums each
index's entries in a fixed order instead (``torch.segment_reduce``).  The reference
shards rows over its mesh (``mesh.shard_batch``); the port copies them
to its one device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from keystone_tpu_torch.utils.device import resolve_device


def is_scipy_sparse_rows(items) -> bool:
    """True for a non-empty sequence of scipy sparse row vectors."""
    return len(items) > 0 and all(hasattr(r, "tocoo") and hasattr(r, "shape") for r in items[:2])


class _Rows:
    """scipy sparse rows as flat arrays: each row's entries in its COO
    order (a CSR row's stored order), concatenated, with their counts."""

    def __init__(self, rows: Sequence, num_features: Optional[int]):
        n = len(rows)
        cols, vals = [], []
        self.nnz = np.empty(n, np.int64)
        widths = set()
        for i, r in enumerate(rows):
            if r.format == "csr" and r.shape[0] == 1:
                cols.append(r.indices)
            else:
                r = r.tocoo()
                cols.append(r.col)
            vals.append(r.data)
            self.nnz[i] = r.nnz
            widths.add(int(r.shape[-1]))
        self.d = int(num_features if num_features is not None else rows[0].shape[-1])
        if widths - {self.d}:
            # a gather past the weights would mis-score: fail as a dense
            # product's shape error does
            raise ValueError(f"sparse rows have width(s) {sorted(widths)} but num_features={self.d}")
        self.cols = np.concatenate(cols) if n else np.zeros(0, np.int32)
        self.vals = np.concatenate(vals) if n else np.zeros(0, np.float32)
        self.start = np.zeros(n + 1, np.int64)
        np.cumsum(self.nnz, out=self.start[1:])

    def padded(self, sel: np.ndarray, cap: int):
        """(len(sel), cap) int32 indices and f32 values of rows ``sel``,
        value-0 padding past each row's entries."""
        lens = self.nnz[sel]
        row = np.repeat(np.arange(len(sel)), lens)
        pos = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
        src = np.repeat(self.start[:-1][sel], lens) + pos
        idx = np.zeros((len(sel), cap), np.int32)
        val = np.zeros((len(sel), cap), np.float32)
        idx[row, pos] = self.cols[src]
        val[row, pos] = self.vals[src]
        return idx, val


class PaddedSparseRows:
    """(n, nnz_max) int64 indices and float32 values on ``device`` (the
    card unless the caller asks for the CPU), and the feature count;
    entries past a row's true nnz are value-0 padding."""

    def __init__(self, indices, values, num_features: int, n: Optional[int] = None, device="cuda"):
        dev = resolve_device(device)
        self.n = int(np.shape(indices)[0] if n is None else n)
        self.num_features = int(num_features)
        self.indices = torch.as_tensor(np.asarray(indices), dtype=torch.int64).to(dev)
        self.values = torch.as_tensor(np.asarray(values), dtype=torch.float32).to(dev)

    @property
    def nnz_max(self) -> int:
        return int(self.indices.shape[1])

    @property
    def shape(self):
        return (self.n, self.num_features)

    @property
    def nbytes(self) -> int:
        return int(self.indices.numel() * self.indices.element_size() + self.values.numel() * 4)

    @staticmethod
    def from_scipy_rows(rows: Sequence, num_features: Optional[int] = None, device="cuda") -> "PaddedSparseRows":
        """From scipy sparse row vectors (what ``Sparsify`` emits)."""
        flat = _Rows(rows, num_features)
        idx, val = flat.padded(np.arange(len(rows)), max(1, int(flat.nnz.max(initial=1))))
        return PaddedSparseRows(idx, val, flat.d, n=len(rows), device=device)

    @staticmethod
    def from_dense(x, threshold: float = 0.0, device="cuda") -> "PaddedSparseRows":
        x = np.asarray(x)
        mask = np.abs(x) > threshold
        nnz_max = max(1, int(mask.sum(axis=1).max()))
        n, d = x.shape
        idx = np.zeros((n, nnz_max), np.int32)
        val = np.zeros((n, nnz_max), np.float32)
        for i in range(n):
            cols = np.nonzero(mask[i])[0]
            idx[i, :cols.size] = cols
            val[i, :cols.size] = x[i, cols]
        return PaddedSparseRows(idx, val, d, n=n, device=device)

    def toarray(self) -> np.ndarray:
        """Dense (n, d) host copy (tests, small data)."""
        idx = self.indices[:self.n].cpu().numpy()
        val = self.values[:self.n].cpu().numpy()
        out = np.zeros((self.n, self.num_features), np.float32)
        for i in range(self.n):
            np.add.at(out[i], idx[i], val[i])
        return out

    def matmul(self, w, intercept=None) -> torch.Tensor:
        """``X @ w`` by gathering rows of ``w``, never densified: (n, k)."""
        out = sparse_matmul(self.indices, self.values, torch.as_tensor(w).to(self.values.device))
        return out if intercept is None else out + intercept


#: bytes of the (rows, nnz, k) contribution tensor that the gather and the
#: scatter-add go through, a chunk of rows at a time (the reference's budget)
_CHUNK_BUDGET = 64 << 20


def _auto_chunk(rows: int, nnz: int, k: int) -> int:
    per_row = max(1, nnz * max(k, 1)) * 4
    c = max(128, _CHUNK_BUDGET // per_row)
    return 1 << int(np.floor(np.log2(c)))


def sparse_matmul(indices: torch.Tensor, values: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(rows, nnz) COO × (d, k) → (rows, k): gather rows of ``w``, weight,
    sum; in row chunks that keep the (chunk, nnz, k) gather within
    ``_CHUNK_BUDGET``, the reference's chunks."""
    rows, nnz = indices.shape
    k = w.shape[-1]
    chunk = _auto_chunk(rows, nnz, k)
    if rows <= chunk:
        return torch.einsum("rn,rnk->rk", values, w[indices])
    return torch.cat([torch.einsum("rn,rnk->rk", values[i:i + chunk], w[indices[i:i + chunk]])
                      for i in range(0, rows, chunk)])


def scatter_plan(indices: torch.Tensor, k: int) -> list:
    """A fixed summation order for ``sparse_grad`` over these indices: per
    row chunk (``sparse_grad``'s chunks for k label columns), the stable
    sort of its entries by index, the distinct indices and their run
    lengths.  A fit's rows keep their indices, so it is made once."""
    rows, nnz = indices.shape
    chunk = _auto_chunk(rows, nnz, k)
    plan = []
    for i in range(0, rows, chunk):
        flat = indices[i:i + chunk].reshape(-1)
        order = torch.argsort(flat, stable=True)
        keys, counts = torch.unique_consecutive(flat[order], return_counts=True)
        plan.append((order, keys, counts))
    return plan


def sparse_grad(indices: torch.Tensor, values: torch.Tensor, r: torch.Tensor, d: int,
                plan: Optional[list] = None) -> torch.Tensor:
    """``Xᵀ r`` by scatter-add: (d, k) from (rows, nnz) COO and (rows, k);
    duplicate indices accumulate, padding entries add zero; in the same
    row chunks as ``sparse_matmul``.  With ``plan`` (``scatter_plan``'s)
    each index's entries are summed in the plan's order
    (``torch.segment_reduce``), so that two computations of one gradient
    agree bit for bit on the card too, where ``index_add_``'s atomics add
    in no fixed order (and cuSPARSE's CSR product of Xᵀ, tried, did not
    repeat bit for bit either)."""
    rows, nnz = indices.shape
    k = r.shape[1]
    chunk = _auto_chunk(rows, nnz, k)
    out = torch.zeros((d, k), dtype=torch.float32, device=r.device)
    for j, i in enumerate(range(0, rows, chunk)):
        contrib = values[i:i + chunk, :, None] * r[i:i + chunk, None, :]  # (chunk, nnz, k)
        if plan is None:
            out.index_add_(0, indices[i:i + chunk].reshape(-1), contrib.reshape(-1, k))
        else:
            order, keys, counts = plan[j]
            out[keys] += torch.segment_reduce(contrib.reshape(-1, k)[order], "sum", lengths=counts, axis=0)
    return out


class BucketedSparseRows:
    """Rows grouped into nnz buckets, each padded only to its own
    power-of-two cap, so that one dense-ish row does not pad every row to
    the global maximum; at most ``max_buckets`` buckets, adjacent caps
    merged where the merge adds the least padding.  ``perm[i]`` is the
    original index of the i-th row in bucket order: labels are permuted
    the same way for a fit, and scores scatter back through it."""

    def __init__(self, buckets, perm, num_features: int, n: int):
        self.buckets = list(buckets)  # PaddedSparseRows each
        self.perm = np.asarray(perm, np.int64)
        self.num_features = int(num_features)
        self.n = int(n)

    @property
    def shape(self):
        return (self.n, self.num_features)

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.buckets)

    @property
    def device(self) -> torch.device:
        return self.buckets[0].values.device

    @staticmethod
    def from_scipy_rows(rows: Sequence, num_features: Optional[int] = None, max_buckets: int = 6,
                        device="cuda") -> "BucketedSparseRows":
        dev = resolve_device(device)
        flat = _Rows(rows, num_features)
        d, n = flat.d, len(rows)
        nnz = np.maximum(flat.nnz, 1)
        caps = 1 << np.ceil(np.log2(nnz)).astype(np.int64)
        uniq = sorted(set(caps.tolist()))
        while len(uniq) > max_buckets:
            costs = [int((caps == uniq[i]).sum()) * (uniq[i + 1] - uniq[i]) for i in range(len(uniq) - 1)]
            i = int(np.argmin(costs))
            caps[caps == uniq[i]] = uniq[i + 1]
            uniq.pop(i)
        perm = np.argsort(caps, kind="stable")
        buckets = []
        for cap in sorted(set(caps.tolist())):
            sel = perm[caps[perm] == cap]
            idx, val = flat.padded(sel, cap)
            buckets.append(PaddedSparseRows(idx, val, d, n=len(sel), device=dev))
        return BucketedSparseRows(buckets, perm, d, n)

    def matmul(self, w, intercept=None) -> torch.Tensor:
        """``X @ w`` (+ intercept) bucket by bucket, in the original row
        order, on the rows' device."""
        w = torch.as_tensor(w).to(self.device)
        out = torch.empty((self.n, int(w.shape[-1])), dtype=torch.float32, device=self.device)
        perm = torch.from_numpy(self.perm).to(self.device)
        start = 0
        for b in self.buckets:
            out[perm[start:start + b.n]] = b.matmul(w)
            start += b.n
        return out if intercept is None else out + intercept


def host_onehot(y, k: int) -> np.ndarray:
    """(n,) int class ids or an (n, K) indicator matrix → f32 one-hot, on
    the host (the sparse fits permute labels there)."""
    y = np.asarray(y)
    if y.ndim == 1:
        out = np.zeros((y.shape[0], k), np.float32)
        out[np.arange(y.shape[0]), y.astype(np.int64)] = 1.0
        return out
    return (y > 0).astype(np.float32)


def bucketize_with_labels(sp, y, n: Optional[int] = None, intercept: bool = False):
    """Per-bucket tensors for the bucketed solvers: ``(bidx, bvals, by, n,
    d_aug, brow_ok)``.  ``y`` is an (≥ n, k) label matrix in the original
    row order (host or tensor); it is permuted into bucket order.  Rows
    whose original index is ≥ ``n`` are padding: their values and labels
    are zeroed and ``brow_ok``, each bucket's (rows,) mask of valid rows,
    leaves them out.  With ``intercept`` each row gains a constant feature
    at index ``num_features`` (1 on valid rows)."""
    if isinstance(sp, PaddedSparseRows):
        sp = BucketedSparseRows([sp], np.arange(sp.n), sp.num_features, sp.n)
    n = sp.n if n is None else int(n)
    y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    y = y.astype(np.float32)
    if y.shape[0] < n:
        raise ValueError(f"labels have {y.shape[0]} rows but the sparse matrix has {n} true rows")
    y_ext = np.zeros((sp.n, y.shape[1]), np.float32)
    y_ext[:n] = y[:n]
    d = sp.num_features
    dev = sp.device
    bidx, bvals, by, brow_ok = [], [], [], []
    start = 0
    for b in sp.buckets:
        sel = sp.perm[start:start + b.n]
        start += b.n
        rows_b = int(b.indices.shape[0])
        row_ok = np.zeros((rows_b,), np.float32)
        row_ok[:b.n] = (sel < n).astype(np.float32)
        yb = np.zeros((rows_b, y.shape[1]), np.float32)
        yb[:b.n] = y_ext[sel]
        ok = torch.from_numpy(row_ok).to(dev)
        idx, vals = b.indices, b.values * ok[:, None]
        if intercept:
            idx = torch.cat([idx, torch.full((rows_b, 1), d, dtype=idx.dtype, device=dev)], dim=1)
            vals = torch.cat([vals, ok[:, None]], dim=1)
        bidx.append(idx)
        bvals.append(vals)
        by.append(torch.from_numpy(yb).to(dev))
        brow_ok.append(ok)
    return tuple(bidx), tuple(bvals), tuple(by), n, d + 1 if intercept else d, tuple(brow_ok)


def score_sparse_dataset(ds, weights: torch.Tensor, intercept=None):
    """Score a host Dataset of scipy sparse rows against dense weights by
    gathering weight rows, nnz-bucketed (LinearMapper's, the logistic
    model's and naive Bayes's sparse scoring): n×d never densifies."""
    sp = BucketedSparseRows.from_scipy_rows(ds.items, num_features=weights.shape[0], device=weights.device)
    return ds.with_array(sp.matmul(weights, intercept))
