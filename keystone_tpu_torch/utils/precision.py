"""Matmul precision for the port: the descriptor stream mode and TF32.

Counterpart of ``keystone_tpu/utils/precision.py``, cut to what the
scoring forward needs.  On the card the default is true f32 everywhere:
the reference's ``auto → bf16`` resolution is a TPU measurement and does
not apply.  ``bf16`` is the reference's ``mxu='bf16'`` stream: the
Fisher-vector and gram kernels read their operands as bf16 (half the
bytes) and compute in f32.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

_MODES = ("f32", "bf16")
_MODE = "f32"


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
