"""Shared solver numerics (counterpart of ``keystone_tpu/models/common.py``
§ solve_spd, constrain, xtx_xty, kahan_add, stage_stream_batch; ``gram``
is ``xtx_xty`` summed over row blocks)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch.parallel import mesh as _mesh
from keystone_tpu_torch.utils import precision


def solve_spd(A: torch.Tensor, B: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """Solve (A + reg·I) X = B for symmetric positive-definite A by
    Cholesky.  As the reference's ``cho_factor``, a factorization that
    fails yields NaNs rather than an exception: ``cholesky_ex`` without
    its error check also keeps the card's solver loop free of host syncs."""
    d = A.shape[0]
    A = A + reg * torch.eye(d, dtype=A.dtype, device=A.device)
    L, _ = torch.linalg.cholesky_ex(A, check_errors=False)
    return torch.cholesky_solve(B, L)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's sharding constraint on ``x``.  A torch tensor has
    no sharding: a rank's part is what it holds, and where it lies is the
    caller's bookkeeping (``parallel/mesh.py``), so this copies nothing
    and returns ``x``."""
    return x


def xtx_xty(x: torch.Tensor, y: torch.Tensor, mesh: Optional[_mesh.Mesh] = None):
    """Replicated (XᵀX, XᵀY) from row-sharded X, Y: the reference's
    per-partition gemm + treeReduce pair (SURVEY.md §3.2), two products
    and their all-reduces over 'data'.  Zero padding rows contribute
    nothing, so padded slices are safe."""
    from keystone_tpu_torch.parallel.collectives import sharded_gram, sharded_matmul

    return sharded_gram(x, mesh), sharded_matmul(x, y, mesh=mesh)


def row_mask(rows: int, data, device=None) -> torch.Tensor:
    """(rows,) f32: ones on the valid rows of ``data``'s tensor (its first
    ``local_n``: ``n``, or a rank slice's own), zeros on the padding."""
    return _mesh.local_rows_mask(rows, data.local_n, device=device)


def kahan_add(s, c, inc):
    """One compensated-summation step: (sum, compensation) after adding
    ``inc``; the first step starts them from ``inc`` and zero.  The
    streamed fits sum across batches with it, so that rounding stays
    O(ε) however many batches there are."""
    if s is None:
        return inc, torch.zeros_like(inc)
    y = inc - c
    t = s + y
    return t, (t - s) - y


#: rows of a block of ``row_blocks``.  One f32 product over all n rows
#: accumulates its rounding over n terms: on an H100 (700 W) MNIST's
#: in-memory normal equations (one cuBLAS product over 60 000 rows) and
#: its streamed ones (batches of 4096 with Kahan steps) gave weights
#: 3.1e-4 of the largest apart; from blocks of 4096 rows with Kahan steps
#: 4.3e-5, and 6.3e-5 from float64 (``chip_smoke.py``, PERF.md).
GRAM_BLOCK_ROWS = 4096


def row_blocks(x: torch.Tensor, y: torch.Tensor = None, rows: int = GRAM_BLOCK_ROWS):
    """Views of x (n, d) and y (n, k) (or None) in blocks of ``rows`` rows:
    (x block, y block or None) pairs, the batches ``gram`` takes."""
    for i in range(0, x.shape[0], rows):
        yield x[i:i + rows], None if y is None else y[i:i + rows]


def gram(blocks, center=None):
    """(ΣXᵀX, ΣXᵀY, rows) over ``(x, y)`` row blocks (y None: ΣXᵀY None),
    each block first centred by ``center`` = (x̄, ȳ or None) when given:
    one solver product a block (``utils/precision.sdot_t``: true f32, or
    one-pass TF32 on the card under ``KEYSTONE_SOLVER_PRECISION=default``),
    Kahan-summed across blocks.  The in-memory and streamed normal
    equations and the ZCA covariance all sum here."""
    sxx = cxx = sxy = cxy = None
    n = 0
    for x, y in blocks:
        if center is not None:
            x = x - center[0]
            y = None if y is None or center[1] is None else y - center[1]
        n += x.shape[0]
        sxx, cxx = kahan_add(sxx, cxx, precision.sdot_t(x, x))
        if y is not None:
            sxy, cxy = kahan_add(sxy, cxy, precision.sdot_t(x, y))
    return sxx, sxy, n


def stage_stream_batch(*host_arrays, mesh: Optional[_mesh.Mesh] = None, device=None):
    """A host batch that every rank holds whole → this rank's row slice of
    each array as f32 tensors, the batch's true row count, and the slice's
    (rows, 1) pad-row mask.  The row capacity is bucketed to the next
    power of two first, as the reference's is (there it bounds recompiles;
    here it keeps the slices' shapes few), and zero pad rows are masked
    by ``row_ok`` wherever sums would see them.  ``device``: None is the
    card, as for numpy everywhere."""
    mesh = mesh or _mesh.current_mesh()
    bn = int(np.shape(host_arrays[0])[0])
    cap = 1 << max(0, bn - 1).bit_length()  # next pow2 >= bn
    staged = []
    for a in host_arrays:
        a = np.asarray(a, np.float32)
        if cap != a.shape[0]:
            a = np.pad(a, [(0, cap - a.shape[0])] + [(0, 0)] * (a.ndim - 1))
        staged.append(_mesh.shard_batch(a, mesh, device=device))
    per = staged[0].shape[0]
    valid = len(range(bn)[_mesh.slice_rows(cap, mesh.data, mesh.data_index)])
    row_ok = _mesh.local_rows_mask(per, valid, device=staged[0].device)[:, None]
    return (*staged, bn, row_ok)
