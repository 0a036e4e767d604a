"""The solver product: one-pass TF32 on the tensor cores, for one call.

``KEYSTONE_SOLVER_PRECISION=default`` (``utils/precision.py``) sends the
solvers' f32 products on the card here: ``csrc/solver_gemm.cu``, a
hand-written ``mma.sync`` TF32 kernel with f32 accumulation.  It has no
Pallas counterpart: it carries the reference's ``sdot`` at
``lax.Precision.DEFAULT`` (``keystone_tpu/utils/precision.py:213``),
whose counterpart on the card is TF32.  PyTorch's own TF32 switch is
process-global; this product is TF32 for its own call and leaves every
other product of the process as it is.

``tf32_matmul(a, b)`` is ``aᵀ·b``, the solvers' form (``a·b`` is
``tf32_matmul(a.T, b)``: views are read in place by their strides).  A
CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, ``tf32_matmul_ref``: both operands rounded to TF32 as the
kernel rounds them (``tf32_round``: to nearest, ties away from zero, as
``cvt.rna.tf32.f32``), the product in float64, cast to f32.
``err_limit`` is how far the kernel may be from it, entry by entry.

Small outputs over long reductions split k (``split_plan``): each chunk's
partial sum goes to a workspace and a second kernel adds them in a fixed
order, so two calls give the same bits.  ``LAUNCHES`` counts the
launches of each kernel (``solver_gemm``, and ``solver_reduce`` for a
split call) and ``LAUNCH_SHAPES`` the ``solver_gemm`` launches by
(m, n, k); a launch recorded into a CUDA graph is counted by the graph
instead (``utils/graphs.py``).
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch
from torch._subclasses.fake_tensor import FakeTensor

from keystone_tpu_torch.utils import graphs

#: kernel launches by kernel (the product, the split's sum); reset with ``reset_launches``
LAUNCHES = {"solver_gemm": 0, "solver_reduce": 0}
#: the product's launches by (m, n, k)
LAUNCH_SHAPES: Counter = Counter()

#: the kernel's output tile and its k stage (csrc/solver_gemm.cu)
TILE, STAGE_ROWS = 64, 32
#: blocks a launch aims for: two for each of the H100's 132 SMs
TARGET_BLOCKS = 264
#: the fewest rows of k a split chunk takes
MIN_CHUNK = 512
_MAX_SPLITS = 65535
#: partials each thread of the split's sum adds in turn before their sums
#: are added (csrc/solver_gemm.cu, reduce_splits_kernel)
REDUCE_ROWS = 8
#: additions a product may go through in the tensor core's sum of one
#: k-stage (4 chained m16n8k8 of 8 terms), each counted twice: they may
#: truncate, an error of up to 2⁻²³ of the sum where rounding makes 2⁻²⁴
MMA_DEPTH = 2 * STAGE_ROWS


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()


# ---------------------------------------------------------------- plain version


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    rounds: to nearest, ties away from zero.  Adding half of the 13
    dropped bits to the magnitude before clearing them carries into the
    exponent where it must (the largest finite values become ±inf);
    subnormals round the same way, and ±inf stay.  NaN stays NaN."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes f32, got {x.dtype}")
    bits = x.view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def tf32_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the operands rounded to
    TF32 as the kernel rounds them, ``aᵀ·b`` in float64, cast to f32."""
    return (tf32_round(a).double().T @ tf32_round(b).double()).to(torch.float32)


def sum_depth(m: int, n: int, k: int) -> int:
    """The f32 additions a product of an (m, n) output over k rows goes
    through, at most: ``MMA_DEPTH`` (one k-stage in the tensor core), the
    k-stages of a chunk (each added to the accumulators, rounded to
    nearest), for a split the partials one thread of the split's sum adds
    and the ``REDUCE_ROWS`` - 1 additions of those sums, and one for the
    plain version's own cast to f32."""
    splits, chunk = split_plan(m, n, k)
    depth = 1 + MMA_DEPTH + -(-chunk // STAGE_ROWS)
    if splits > 1:
        depth += -(-splits // REDUCE_ROWS) + REDUCE_ROWS - 1
    return depth


def err_limit(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The most the kernel's ``aᵀ·b`` may differ from ``tf32_matmul_ref``,
    entry by entry (float64, (m, n)): h·2⁻²⁴·(|ã|ᵀ|b̃|) of the rounded
    operands with h = ``sum_depth``.  TF32 products are exact in f32, so
    the sums make all of the distance, and a sum of depth h is within
    h·2⁻²⁴ of the sum of its terms' magnitudes.  The depth, not k: a long
    reduction split in chunks is held about as tightly as a short one, so
    a dropped chunk or stage, or operands truncated instead of rounded,
    shows."""
    mag = tf32_round(a).double().abs().T @ tf32_round(b).double().abs()
    return sum_depth(a.shape[1], b.shape[1], a.shape[0]) * 2.0 ** -24 * mag


# ---------------------------------------------------------------- kernel


def split_plan(m: int, n: int, k: int) -> tuple:
    """(splits, chunk) for an (m, n) output over k rows: one split where
    the output's tiles fill the card, else k cut into chunks of at least
    ``MIN_CHUNK`` rows (a multiple of the kernel's stage), enough for
    about ``TARGET_BLOCKS`` blocks.  A function of the shape alone."""
    tiles = -(-m // TILE) * -(-n // TILE)
    want = min(-(-TARGET_BLOCKS // tiles), k // MIN_CHUNK, _MAX_SPLITS) if tiles else 1
    if want <= 1:
        return 1, k
    per = -(-k // want)
    chunk = -(-per // STAGE_ROWS) * STAGE_ROWS
    splits = -(-k // chunk)
    return (1, k) if splits == 1 else (splits, chunk)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/solver_gemm.cu, built on first use, with its C signatures declared."""
    from keystone_tpu_torch.kernels.build import LOCK, load

    with LOCK:
        lib = load("solver_gemm")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ks_solver_gemm.argtypes = [p, ll, ll, p, ll, ll, p, i, i, i, i, i, p, p]
        lib.ks_solver_gemm.restype = i
        lib.ks_solver_error_string.argtypes = [i]
        lib.ks_solver_error_string.restype = ctypes.c_char_p
        return lib


def _check(a, b):
    """The operands' (m, n, k), or raise on what the kernel does not take."""
    for label, t in (("a", a), ("b", b)):
        if isinstance(t, FakeTensor):
            # a stage priced by its shapes (workflow/profiling.stage_cost):
            # a fake tensor's data pointer is null
            raise TypeError(f"solver_gemm: {label} is a fake tensor; a kernel launches on data only")
        if t.dtype != torch.float32:
            raise TypeError(f"solver_gemm: {label} has dtype {t.dtype}, expected torch.float32")
        if t.dim() != 2:
            raise ValueError(f"solver_gemm: {label} must be 2-D, got shape {tuple(t.shape)}")
    if a.device != b.device:
        raise ValueError(f"solver_gemm: a is on {a.device}, b on {b.device}")
    k, m = a.shape
    if b.shape[0] != k:
        raise ValueError(f"solver_gemm: aᵀ is ({m}, {k}) and b is {tuple(b.shape)}")
    return m, b.shape[1], k


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``aᵀ·b`` of f32 (k, m) and (k, n) matrices in one-pass TF32 with
    f32 accumulation → (m, n) f32.  A CUDA tensor launches the kernel on
    the current stream; a CPU tensor takes ``tf32_matmul_ref``."""
    m, n, k = _check(a, b)
    if a.device.type == "cpu":
        return tf32_matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"solver_gemm runs on cuda or cpu, not {a.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    splits, chunk = split_plan(m, n, k)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=a.device) if splits > 1 else None
    rc = _lib().ks_solver_gemm(a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0), b.stride(1),
                               out.data_ptr(), m, n, k, splits, chunk, None if ws is None else ws.data_ptr(),
                               torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        from keystone_tpu_torch.kernels.build import KernelError

        raise KernelError(f"solver_gemm kernel launch failed ({rc}): {_lib().ks_solver_error_string(rc).decode()}")
    if not graphs.note_launch("solver_gemm"):  # a launch recorded into a graph runs nothing now
        LAUNCHES["solver_gemm"] += 1
        LAUNCH_SHAPES[(m, n, k)] += 1
    if splits > 1 and not graphs.note_launch("solver_reduce"):
        LAUNCHES["solver_reduce"] += 1
    return out
