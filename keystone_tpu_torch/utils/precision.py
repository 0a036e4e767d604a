"""Matmul precision for the port: the descriptor stream mode and TF32.

Counterpart of ``keystone_tpu/utils/precision.py``, cut to what the
scoring forward needs.  On the card the default is true f32 everywhere:
the reference's ``auto → bf16`` resolution is a TPU measurement and does
not apply.  ``bf16`` is the reference's ``mxu='bf16'`` stream: the
Fisher-vector and gram kernels read their operands as bf16 (half the
bytes) and compute in f32.

``KEYSTONE_MATMUL``, read once at import as in the reference, sets the
starting mode: ``auto`` and ``f32`` give ``f32`` (the card resolves
``auto`` to f32), ``bf16`` gives ``bf16``, and ``bf16_apply`` gives
``bf16`` for the descriptor stream while ``apply_mode`` stays ``f32``.
Any other value raises ``ValueError`` at import.  The planner's
``matmul`` gate reads no variable: a plan never changes numerics.

``KEYSTONE_SOLVER_PRECISION``, read once at import as in the reference,
sets the precision of the solvers' contractions (Gramians, ``Aᵀ·B``
right-hand sides, covariances, EM sufficient statistics, L-BFGS
gradients): ``float32`` (the default) and ``highest`` keep them true f32,
``default`` gives them the card's default tensor-core precision, one-pass
TF32.  Any other value raises ``ValueError`` at import.  ``sdot`` and
``sdot_t`` carry it by call, never by a process-global flag: under
``default`` an f32 product on the card goes to the hand-written TF32
kernel (``ops/solver_kernels.py``), which leaves every other product of
the process, a serving thread's forward among them, as it is.  f64
operands stay f64 and CPU operands plain f32 under either setting, as
the reference's default precision is full f32 on the CPU.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch

_MODES = ("f32", "bf16")
#: ``KEYSTONE_MATMUL``'s values (the reference's modes) → the port's mode
_ENV_MODES = {"auto": "f32", "bf16": "bf16", "f32": "f32", "bf16_apply": "bf16"}


def _env_mode() -> str:
    raw = os.environ.get("KEYSTONE_MATMUL", "auto")
    if raw not in _ENV_MODES:
        raise ValueError(f"KEYSTONE_MATMUL must be one of {tuple(_ENV_MODES)}, got {raw!r}")
    return _ENV_MODES[raw]


_MODE = _env_mode()


_SOLVER_PRECISIONS = ("default", "float32", "highest")
_SOLVER_PRECISION = os.environ.get("KEYSTONE_SOLVER_PRECISION", "float32")
if _SOLVER_PRECISION not in _SOLVER_PRECISIONS:
    raise ValueError(
        f"KEYSTONE_SOLVER_PRECISION must be one of {_SOLVER_PRECISIONS}, got {_SOLVER_PRECISION!r}"
    )


def solver_precision() -> str:
    """The solver contractions' precision on the card: ``'tf32'`` under
    ``default``, ``'f32'`` under ``float32`` and ``highest``."""
    return "tf32" if _SOLVER_PRECISION == "default" else "f32"


def _tf32_product(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether this product takes the TF32 kernel: under ``default``, on
    f32 CUDA operands.  Decided by dtype and device before the call."""
    return (solver_precision() == "tf32" and a.is_cuda and b.is_cuda
            and a.dtype == torch.float32 and b.dtype == torch.float32)


def sdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solver-grade ``a @ b``: ``sdot_t`` of the view ``a.T``."""
    return sdot_t(a.T, b)


def sdot_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solver-grade ``aᵀ @ b`` (the solvers' form: a reduction over the
    rows of both): under ``default`` on f32 CUDA tensors the TF32 kernel,
    which reads ``a`` by its strides (no transpose is made) and raises
    rather than fall back; otherwise ``torch.matmul`` (true f32, f64 for
    f64 operands)."""
    if _tf32_product(a, b):
        from keystone_tpu_torch.ops import solver_kernels

        return solver_kernels.tf32_matmul(a, b)
    return a.T @ b


def disable_tf32() -> None:
    """Make f32 matmuls and convolutions true f32 on the card.  cuBLAS
    already defaults to it; cuDNN convolutions default to TF32, which
    keeps about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextmanager
def f32_convolutions():
    """cuDNN convolutions in true f32 inside the block, whatever the
    global flag says (its default is TF32)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def set_matmul(mode: str) -> None:
    global _MODE
    if mode not in _MODES:
        raise ValueError(f"matmul mode must be one of {_MODES}, got {mode!r}")
    _MODE = mode


def matmul_mode() -> str:
    return _MODE


@contextmanager
def matmul(mode: str):
    prev = _MODE
    set_matmul(mode)
    try:
        yield
    finally:
        set_matmul(prev)


def fdtype(mode: str | None = None) -> torch.dtype:
    """Descriptor stream dtype for ``mode`` (default: the current mode)."""
    m = matmul_mode() if mode is None else mode
    if m not in _MODES:
        raise ValueError(f"matmul mode must be one of {_MODES}, got {m!r}")
    return torch.bfloat16 if m == "bf16" else torch.float32


def apply_mode(mode: str | None = None) -> str:
    """The apply path's mode: always ``'f32'`` in the port.  The
    reference's ``bf16_apply`` policy (bf16 apply-side contractions) is
    gated to the TPU there and has no counterpart here: apply-side
    contractions stay true f32 on the card."""
    return "f32"


def apply_dot(a, b, mode: str | None = None):
    """Apply-side matmul: a plain f32 ``torch.matmul`` (see ``apply_mode``)."""
    return torch.matmul(a, b)
