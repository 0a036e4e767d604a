"""Gram-block kernels (counterpart of ``keystone_tpu/ops/gram_pallas.py``).

Two kernels, hand-written in CUDA C++ for Hopper (``csrc/gram.cu``), one
shared tile body with two epilogues:

* ``gram_block_kernel`` — K(x, z) = exp(−γ·max(‖x‖² − 2·x·zᵀ + ‖z‖², 0));
  replaces ``gram_block_pallas``.
* ``poly_block_kernel`` — K(x, z) = (α·x·zᵀ + c)^degree; replaces
  ``poly_block_pallas`` (the linear kernel is (1, 0, 1)).

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
its plain version, ``gram_block_ref`` / ``poly_block_ref``, only for a
tensor on the CPU.  ``LAUNCHES`` counts the kernel launches and
``LAUNCH_SHAPES`` the same launches by (name, n, m, d); a launch
recorded into a CUDA graph is counted by the graph instead
(``utils/graphs.py``).  Operands
may be f32 or bf16 (the reference's ``mxu='bf16'`` stream); the kernels
compute in f32 either way.

The dispatchers ``gram_block``, ``poly_gram_block``, ``linear_gram_block``
and ``gram_block_for`` mirror the reference's.  Two of its gates are
dropped: ``GRAM_MAX_D`` is the TPU's VMEM bound on an untiled feature
dim, and the CUDA kernel loops over d in chunks, so no d is too wide;
the ``KEYSTONE_GRAM_PALLAS`` / planner gate chose between Pallas and the
XLA chain by a TPU measurement, and here a CUDA tensor always launches
the kernel (``use_kernel=False`` asks for the plain chain, the comparison
on the card).
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch
from torch._subclasses.fake_tensor import FakeTensor

from keystone_tpu_torch.utils import graphs, precision

#: kernel launches by wrapper name; reset with ``reset_launches``
LAUNCHES = {"gram_block": 0, "poly_block": 0}
#: the same launches by (wrapper name, n, m, d)
LAUNCH_SHAPES: Counter = Counter()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


# ---------------------------------------------------------------- plain versions


def gram_block_ref(x, z, gamma):
    """The ``GaussianKernelGenerator`` chain: row norms, the cross gemm,
    the clamped squared distance, the exp.  x: (n, d), z: (m, d) → (n, m)
    f32; bf16 operands are widened first, as the kernel reads them."""
    x = x.to(torch.float32)
    z = z.to(torch.float32)
    xn = torch.sum(x * x, dim=1, keepdim=True)
    zn = torch.sum(z * z, dim=1)
    cross = torch.matmul(x, z.T)
    sq = torch.clamp(xn - 2.0 * cross + zn, min=0.0)
    return torch.exp(-gamma * sq)


def poly_block_ref(x, z, alpha, c, degree):
    """The ``PolynomialKernelGenerator`` chain: (α·x·zᵀ + c)^degree."""
    cross = torch.matmul(x.to(torch.float32), z.to(torch.float32).T)
    return (alpha * cross + c) ** int(degree)


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/gram.cu, built on first use, with its C signatures declared."""
    from keystone_tpu_torch.kernels.build import LOCK, load

    with LOCK:
        return _declare(load("gram"))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ks_gram_block.argtypes = [p, p, i, p, i, i, i, f, p]
    lib.ks_gram_block.restype = i
    lib.ks_poly_block.argtypes = [p, p, i, p, i, i, i, f, f, i, p]
    lib.ks_poly_block.restype = i
    lib.ks_gram_error_string.argtypes = [i]
    lib.ks_gram_error_string.restype = ctypes.c_char_p
    return lib


_OPERAND = (torch.float32, torch.bfloat16)


def _operands(name, x, z):
    """Check the two operands for a launch; returns (n, m, d)."""
    dev = x.device
    for label, t in (("x", x), ("z", z)):
        if isinstance(t, FakeTensor):
            # a stage priced by its shapes (workflow/profiling.stage_cost):
            # a fake tensor's data pointer is null
            raise TypeError(f"{name}: {label} is a fake tensor; a kernel launches on data only")
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, expected {dev}")
        if t.dtype not in _OPERAND:
            raise TypeError(f"{name}: {label} has dtype {t.dtype}, expected one of {_OPERAND}")
        if t.dim() != 2:
            raise ValueError(f"{name}: {label} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if x.dtype != z.dtype:
        raise TypeError(f"{name}: x is {x.dtype} and z is {z.dtype}; both must share a dtype")
    if x.shape[1] != z.shape[1]:
        raise ValueError(f"{name}: x has d={x.shape[1]}, z has d={z.shape[1]}")
    return x.shape[0], z.shape[0], x.shape[1]


def _launch(name, fn, x, z, *scalars):
    n, m, d = _operands(name, x, z)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    rc = fn(x.data_ptr(), z.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(), n, m, d,
            *scalars, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = _lib().ks_gram_error_string(rc).decode()
        from keystone_tpu_torch.kernels.build import KernelError

        raise KernelError(f"{name} kernel launch failed ({rc}): {msg}")
    if not graphs.note_launch(name):  # a launch recorded into a graph runs nothing now
        LAUNCHES[name] += 1
        LAUNCH_SHAPES[(name, n, m, d)] += 1
    return out


def gram_block_kernel(x, z, gamma):
    """x: (n, d), z: (m, d), f32 or bf16 (the same for both) → (n, m) f32
    Gaussian gram.  CUDA tensors launch the kernel; CPU tensors take
    ``gram_block_ref``."""
    if x.device.type == "cpu":
        return gram_block_ref(x, z, gamma)
    if x.device.type != "cuda":
        raise ValueError(f"gram_block runs on cuda or cpu, not {x.device}")
    return _launch("gram_block", _lib().ks_gram_block, x, z, float(gamma))


def poly_block_kernel(x, z, alpha, c, degree):
    """x: (n, d), z: (m, d) as ``gram_block_kernel`` → (n, m) f32
    (α·x·zᵀ + c)^degree for an integer degree ≥ 0.  CUDA tensors launch
    the kernel; CPU tensors take ``poly_block_ref``."""
    if int(degree) != degree or degree < 0:
        raise ValueError(f"poly_block needs an integer degree >= 0, got {degree}")
    if x.device.type == "cpu":
        return poly_block_ref(x, z, alpha, c, degree)
    if x.device.type != "cuda":
        raise ValueError(f"poly_block runs on cuda or cpu, not {x.device}")
    return _launch("poly_block", _lib().ks_poly_block, x, z, float(alpha), float(c), int(degree))


# ---------------------------------------------------------------- dispatchers


def _stream(mxu, *ts):
    """Operands as the ``mxu`` stream reads them (bf16 halves the bytes;
    the kernels compute in f32), contiguous for the launch."""
    dt = precision.fdtype(mxu)
    return [t.to(dt).contiguous() for t in ts]


def gram_block(x, z, gamma, mxu: str = "f32", use_kernel=None):
    """One Gaussian gram block.  ``use_kernel=False`` runs the plain chain
    on any device; otherwise the wrapper decides by the tensors' device
    (kernel on the card, plain version on the CPU)."""
    if use_kernel is False:
        return gram_block_ref(x, z, gamma)
    return gram_block_kernel(*_stream(mxu, x, z), gamma)


def poly_gram_block(x, z, alpha: float = 1.0, c: float = 1.0, degree: int = 2,
                    mxu: str = "f32", use_kernel=None):
    """Polynomial gram block, routed as ``gram_block``."""
    if use_kernel is False:
        return poly_block_ref(x, z, alpha, c, degree)
    return poly_block_kernel(*_stream(mxu, x, z), alpha, c, degree)


def linear_gram_block(x, z, mxu: str = "f32", use_kernel=None):
    """Linear gram block: the polynomial kernel at (α=1, c=0, degree=1)."""
    return poly_gram_block(x, z, 1.0, 0.0, 1, mxu=mxu, use_kernel=use_kernel)


def gram_block_for(kernel_gen, x, z, mxu: str = "f32", use_kernel=None):
    """Route a kernel generator through its dispatcher; None for a
    generator with no route (duck-typed: the caller calls it as-is)."""
    from keystone_tpu_torch.models.kernel_ridge import (
        GaussianKernelGenerator,
        LinearKernelGenerator,
        PolynomialKernelGenerator,
    )

    if isinstance(kernel_gen, GaussianKernelGenerator):
        return gram_block(x, z, float(kernel_gen.gamma), mxu=mxu, use_kernel=use_kernel)
    if isinstance(kernel_gen, PolynomialKernelGenerator):
        return poly_gram_block(x, z, float(kernel_gen.alpha), float(kernel_gen.c),
                               int(kernel_gen.degree), mxu=mxu, use_kernel=use_kernel)
    if isinstance(kernel_gen, LinearKernelGenerator):
        return linear_gram_block(x, z, mxu=mxu, use_kernel=use_kernel)
    return None
