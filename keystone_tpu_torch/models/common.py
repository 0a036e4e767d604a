"""Shared solver numerics (counterpart of ``keystone_tpu/models/common.py``
§ solve_spd)."""

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

