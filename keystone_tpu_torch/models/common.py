"""Shared solver numerics (counterpart of ``keystone_tpu/models/common.py``
§ solve_spd), and the refusal of the kernel tier's out-of-core paths,
which need the row-block store."""

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


def needs_row_block_store(what: str) -> NotImplementedError:
    """The refusal of a kernel-tier path that streams training rows from
    disk: the port's block store holds feature columns (the BCD solvers'
    out-of-core fits), and its row-blocked ``RowBlockStore`` is not ported."""
    return NotImplementedError(
        f"{what} needs the kernel tier's out-of-core row-block store (workflow/blockstore.py § RowBlockStore), "
        "which the port does not have yet (ROADMAP A6)"
    )
