"""Pass (b): the precision lint over the solvers' contractions
(counterpart of ``keystone_tpu/analysis/precision.py``).

Solver math stays f32 under every precision mode of the port.  The
reference checks this on each solver entry's traced program; the port
traces nothing, so this pass runs each registered solver entry
(:data:`SOLVER_ENTRIES`: ``lbfgs`` dense and sparse, ``block_ls``,
``block_weighted_ls``, ``kernel_ridge`` in core and out of core,
``nystrom``) on small real CPU tensors, under each of the port's modes
(:data:`MODES`), inside a ``TorchDispatchMode`` that records every
contraction the entry dispatches (``aten.mm``/``bmm``/``addmm``/
``baddbmm``/``dot``/``mv``, ``convolution``, the ``linalg_*`` solves and
factorizations, the ``_scaled_*`` ops), and errors on:

- ``bf16-solver-input``: a contraction's operand is bfloat16 (or
  float16): the descriptor stream's precision leaked into solver math;
- ``non-f32-accumulation``: a contraction's result is not f32 (or f64),
  or it was dispatched while ``torch.backends.cuda.matmul.allow_tf32`` is
  on: TF32 keeps ten mantissa bits of each product, the card's form of a
  degraded accumulation (``utils/precision.disable_tf32``).

The registry of entries is data, so a new solver family is one tuple away
from coverage; :func:`check_fn` is the reusable core (the seeded-defect
tests point it at deliberately narrowed functions).  The entries run on
the CPU, where the gram wrappers take their plain versions: the CUDA
kernels compute in f32 by construction and dispatch no aten contraction.

``KEYSTONE_SOLVER_PRECISION=default`` is no leak: its TF32 products on
the card are the hand-written solver kernel's (``ops/solver_kernels.py``),
the user's explicit choice for the call, never the process-global flag,
and on the CPU the solvers' products stay plain f32 under it.  As the
reference's lint (which checks operand and accumulation dtypes only),
this pass stays clean under either setting.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from keystone_tpu_torch.analysis.findings import PASS_PRECISION, Finding

logger = logging.getLogger(__name__)

#: the contraction ops whose operands and accumulation the lint audits
#: (aten overload packets' names, as dispatched: a ``matmul`` or an
#: ``einsum`` reaches the mode as one of these)
_CONTRACTIONS = {
    "mm", "bmm", "addmm", "addbmm", "baddbmm", "addmv", "mv", "dot", "vdot", "addr",
    "convolution", "_convolution", "cudnn_convolution",
    "cholesky", "cholesky_solve", "cholesky_inverse", "triangular_solve", "lu_solve",
}
_CONTRACTION_PREFIXES = ("linalg_", "_linalg_", "_scaled_")

#: the modes every solver must stay f32 under (the port's
#: ``utils/precision`` modes; ``auto`` is f32)
MODES = ("f32", "bf16")

_NARROW = (torch.bfloat16, torch.float16)
_ACCUMULATE_OK = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def _is_contraction(func) -> bool:
    name = func.overloadpacket.__name__ if hasattr(func, "overloadpacket") else getattr(func, "__name__", "")
    return name in _CONTRACTIONS or name.startswith(_CONTRACTION_PREFIXES)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class _ContractionRecorder(TorchDispatchMode):
    """Records ``(op name, operand dtypes, result dtypes, tf32 on)`` for
    every contraction dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.records: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _is_contraction(func):
            name = func.overloadpacket.__name__ if hasattr(func, "overloadpacket") else str(func)
            ins = [t.dtype for t in _tensors((args, kwargs)) if t.is_floating_point() or t.is_complex()]
            outs = [t.dtype for t in _tensors(out) if t.is_floating_point() or t.is_complex()]
            self.records.append((name, ins, outs, bool(torch.backends.cuda.matmul.allow_tf32)))
        return out


def check_fn(fn: Callable, *args, name: str = "solver", mode: Optional[str] = None) -> List[Finding]:
    """Run ``fn(*args)`` (small real tensors) and audit every contraction it
    dispatches.  ``mode`` labels the findings; the caller sets the
    precision mode before calling."""
    rec = _ContractionRecorder()
    with rec:
        fn(*args)
    findings: List[Finding] = []
    tag = f"{name}" + (f" under mode={mode}" if mode else "")
    for op, ins, outs, tf32 in rec.records:
        narrow = [d for d in ins if d in _NARROW]
        if narrow:
            findings.append(Finding(
                "error", PASS_PRECISION, "bf16-solver-input",
                f"{tag}: {op} consumes a {str(narrow[0]).replace('torch.', '')} operand — the descriptor "
                "stream's precision leaked into solver math (solvers contract in f32)", label=name))
        bad_out = next((d for d in outs if d not in _ACCUMULATE_OK), None)
        if bad_out is not None or (tf32 and any(d == torch.float32 for d in ins)):
            why = (f"accumulates in {str(bad_out).replace('torch.', '')}" if bad_out is not None
                   else "runs with torch.backends.cuda.matmul.allow_tf32 on (TF32 products)")
            findings.append(Finding(
                "error", PASS_PRECISION, "non-f32-accumulation",
                f"{tag}: {op} {why} — solver contractions must accumulate (and emit) f32", label=name))
    return findings


# --------------------------------------------------------------- registry


def _rng(seed: int = 0):
    return torch.Generator().manual_seed(seed)


def _randn(*shape, seed: int = 0):
    return torch.randn(*shape, generator=_rng(seed), dtype=torch.float32)


def _entry_lbfgs_dense():
    from keystone_tpu_torch.models.lbfgs import _lbfgs_least_squares

    x, y = _randn(8, 4, seed=1), _randn(8, 2, seed=2)
    return (lambda: _lbfgs_least_squares(x, y, 1e-2, 2, 3, True)), ()


def _entry_lbfgs_sparse():
    from keystone_tpu_torch.models.lbfgs import _lbfgs_sparse_least_squares

    g = _rng(3)
    idx = torch.randint(0, 5, (8, 3), generator=g)
    vals = _randn(8, 3, seed=4)
    y = _randn(8, 2, seed=5)
    return (lambda: _lbfgs_sparse_least_squares([idx], [vals], [y], 8, 5, 1e-2, 2, 3)), ()


def _entry_block_ls():
    from keystone_tpu_torch.models.block_ls import _oc_block_step

    a_raw, xm_b = _randn(8, 4, seed=6), _randn(4, seed=7)
    yc, p = _randn(8, 2, seed=8), torch.zeros(8, 2)
    sa, row_ok = torch.ones(8), torch.ones(8)
    wb = torch.zeros(4, 2)
    return (lambda: _oc_block_step(a_raw, xm_b, yc, sa, row_ok, p.clone(), wb, 1e-2)), ()


def _entry_block_weighted_ls():
    from keystone_tpu_torch.models.block_weighted_ls import _weighted_bcd_fit

    x, y = _randn(8, 4, seed=9), _randn(8, 2, seed=10)
    alpha = torch.full((8,), 0.5)
    return (lambda: _weighted_bcd_fit(x, y, alpha, 8, 1e-2, 1, 4, True)), ()


def _entry_kernel_ridge():
    from keystone_tpu_torch.models.kernel_ridge import _krr_fit

    x, y = _randn(8, 4, seed=11), _randn(8, 2, seed=12)
    return (lambda: _krr_fit(x, y, 8, 0.5, 1e-3, 4, 2)), ()


def _entry_kernel_ridge_oc():
    """The out-of-core sweep: one diagonal (solve) step chained into one
    off-diagonal F update, the two steps the streamed fit runs."""
    from keystone_tpu_torch.models.kernel_ridge import _oc_krr_diag_step, _oc_krr_offdiag_step

    xb, xi = _randn(8, 4, seed=13), _randn(8, 4, seed=14)
    yb = _randn(8, 2, seed=15)
    ok = torch.ones(8)

    def fn():
        fb, ab, fi = torch.zeros(8, 2), torch.zeros(8, 2), torch.zeros(8, 2)
        dab = _oc_krr_diag_step(xb, fb, ab, yb, ok, 8e-3, 0.5)
        _oc_krr_offdiag_step(fi, xi, xb, dab, ok, ok, 0.5)
        return ab, fb, fi

    return fn, ()


def _entry_nystrom():
    from keystone_tpu_torch.models.nystrom import _nystrom_whiten

    lmk = _randn(8, 4, seed=16)
    return (lambda: _nystrom_whiten(lmk, 0.5, 1e-3)), ()


#: (name, builder): a builder returns (a callable, its arguments).  Every
#: solver family the port ships appears here; the seeded-defect tests
#: check that the checker catches a planted bf16 leak through check_fn.
SOLVER_ENTRIES: Sequence[Tuple[str, Callable]] = (
    ("lbfgs.dense", _entry_lbfgs_dense),
    ("lbfgs.sparse", _entry_lbfgs_sparse),
    ("block_ls", _entry_block_ls),
    ("block_weighted_ls", _entry_block_weighted_ls),
    ("kernel_ridge", _entry_kernel_ridge),
    ("kernel_ridge.oc", _entry_kernel_ridge_oc),
    ("nystrom", _entry_nystrom),
)


def run(modes: Sequence[str] = MODES) -> List[Finding]:
    """Audit every registered solver entry under every mode."""
    from keystone_tpu_torch.utils import precision

    findings: List[Finding] = []
    for name, build in SOLVER_ENTRIES:
        try:
            fn, args = build()
        except Exception as e:
            findings.append(Finding("warning", PASS_PRECISION, "solver-entry-unavailable",
                                    f"solver entry {name} could not be built: {type(e).__name__}: {e}", label=name))
            continue
        for mode in modes:
            try:
                with precision.matmul(mode):
                    findings.extend(check_fn(fn, *args, name=name, mode=mode))
            except Exception as e:
                findings.append(Finding("warning", PASS_PRECISION, "solver-entry-untraceable",
                                        f"solver entry {name} failed to run under mode={mode}: "
                                        f"{type(e).__name__}: {e}", label=name))
    return findings
