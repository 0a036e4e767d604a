"""Shared solver numerics (counterpart of ``keystone_tpu/models/common.py``
§ solve_spd, kahan_add; ``gram`` is the
reference's ``xtx_xty``, summed over row blocks)."""

from __future__ import annotations

import torch


def solve_spd(A: torch.Tensor, B: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """Solve (A + reg·I) X = B for symmetric positive-definite A by
    Cholesky.  As the reference's ``cho_factor``, a factorization that
    fails yields NaNs rather than an exception: ``cholesky_ex`` without
    its error check also keeps the card's solver loop free of host syncs."""
    d = A.shape[0]
    A = A + reg * torch.eye(d, dtype=A.dtype, device=A.device)
    L, _ = torch.linalg.cholesky_ex(A, check_errors=False)
    return torch.cholesky_solve(B, L)


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
    one f32 product a block, Kahan-summed across blocks.  The in-memory
    and streamed normal equations and the ZCA covariance all sum here."""
    sxx = cxx = sxy = cxy = None
    n = 0
    for x, y in blocks:
        if center is not None:
            x = x - center[0]
            y = None if y is None or center[1] is None else y - center[1]
        n += x.shape[0]
        sxx, cxx = kahan_add(sxx, cxx, x.T @ x)
        if y is not None:
            sxy, cxy = kahan_add(sxy, cxy, x.T @ y)
    return sxx, sxy, n
