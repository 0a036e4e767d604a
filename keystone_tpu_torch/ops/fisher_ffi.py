"""The host float64 Fisher-vector encode and GMM EM (counterpart of
``keystone_tpu/ops/fisher_ffi.py``, the module name kept).

The reference's production encode is EncEval, a C++ library working in
double precision on the host.  ``csrc/keystone_ffi.cpp`` is the port's
copy of that arithmetic (the reference's ``native/keystone_ffi.cpp``
without its XLA custom-call glue), built with ``g++`` at first use
(``kernels/build.py``) and called through ``ctypes``: every sum a
double, whatever the I/O dtype.  It is the precision reference for the
card's f32 paths (the plain chain of ``ops/fisher_kernels.py``, the FV
kernels of ``csrc/fisher.cu``, the EM of ``models/gmm.py``) and runs on
the host by design, as the reference's custom call is registered for the
CPU alone.  No module of the main path imports it.

Inputs are numpy arrays or tensors on any device; outputs are CPU
tensors of the I/O dtype: float64 in, float64 out, any other dtype
through the float32 entry.  Unlike the reference there is no 64-bit
switch (torch computes in float64 whenever it is given float64), so
float64 inputs always take the float64 entry; the reference's fall-back
to float32 when its 64-bit mode is off has no counterpart.  Nor is there a fall-back when the library cannot be built
or loaded: :func:`ffi_available` says False and both functions raise.
"""

from __future__ import annotations

import ctypes
import functools
import logging
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: the library's entries by group and I/O dtype
_ENTRIES = {
    "fisher": {np.dtype(np.float32): "ks_fisher_encode_f32", np.dtype(np.float64): "ks_fisher_encode_f64"},
    "em": {np.dtype(np.float32): "ks_gmm_em_f32", np.dtype(np.float64): "ks_gmm_em_f64"},
}


@functools.lru_cache(maxsize=None)
def _library() -> Optional[ctypes.CDLL]:
    """``csrc/keystone_ffi.cpp``, built on first use, its signatures
    declared; None when it cannot be built or loaded."""
    from keystone_tpu_torch.kernels import build

    try:
        with build.LOCK:
            lib = build.load("keystone_ffi")
    except (build.KernelError, OSError) as e:
        logger.warning("the host FV library is unavailable: %s", e)
        return None
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for dt in (np.float32, np.float64):
        enc = getattr(lib, _ENTRIES["fisher"][np.dtype(dt)])
        enc.argtypes = [p] * 5 + [i64] * 4 + [p]
        enc.restype = ctypes.c_int
        em = getattr(lib, _ENTRIES["em"][np.dtype(dt)])
        em.argtypes = [p] * 5 + [i64] * 4 + [ctypes.c_double] + [p] * 3
        em.restype = ctypes.c_int
    return lib


def ffi_available(group: str = "fisher") -> bool:
    """Whether the library builds (or is built), loads and holds the
    entries of ``group`` ("fisher" or "em")."""
    if group not in _ENTRIES:
        raise ValueError(f"unknown FFI group {group!r}; valid: {sorted(_ENTRIES)}")
    lib = _library()
    return lib is not None and all(hasattr(lib, name) for name in _ENTRIES[group].values())


def _require(group: str) -> ctypes.CDLL:
    if not ffi_available(group):
        raise RuntimeError("the host FV library (csrc/keystone_ffi.cpp) is unavailable: g++ missing or the build "
                           "failed; there is no other path")
    return _library()


def _io_dtype(a) -> np.dtype:
    if isinstance(a, torch.Tensor):
        f64 = a.dtype == torch.float64
    else:
        f64 = np.asarray(a).dtype == np.float64
    return np.dtype(np.float64 if f64 else np.float32)


def _host(a, dt: np.dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype=dt)


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def fisher_encode_ffi(xs, mask, w, mu, var) -> torch.Tensor:
    """xs: (n, T, d); mask: (n, T); GMM (w (K,), mu/var (K, d)) →
    (n, 2·K·d), the contract of ``ops/fisher_kernels.fisher_encode_ref``
    computed with float64 sums on the host.  A CPU tensor of xs's
    dtype (float64, else float32)."""
    lib = _require("fisher")
    dt = _io_dtype(xs)
    x = _host(xs, dt)
    n, t, d = x.shape
    mu_ = _host(mu, dt)
    k = mu_.shape[0]
    m_, w_, v_ = _host(mask, dt), _host(w, dt), _host(var, dt)
    if m_.shape != (n, t) or w_.shape != (k,) or mu_.shape != (k, d) or v_.shape != (k, d):
        raise ValueError(f"shapes xs {x.shape}, mask {m_.shape}, w {w_.shape}, mu {mu_.shape}, var {v_.shape}")
    out = np.empty((n, 2 * k * d), dt)
    rc = getattr(lib, _ENTRIES["fisher"][dt])(_ptr(x), _ptr(m_), _ptr(w_), _ptr(mu_), _ptr(v_), n, t, k, d,
                                             _ptr(out))
    if rc != 0:
        raise ValueError(f"the host FV encode refused the shapes (n={n}, T={t}, K={k}, d={d})")
    return torch.from_numpy(out)


def gmm_em_ffi(x, mask, w0, mu0, var0, iters: int = 25, min_var: float = 1e-6):
    """``iters`` EM steps from the given mixture with float64 sums on the
    host (the EM of ``models/gmm.py::_em_steps``: ``nk`` floored at
    1e-10, variances at ``min_var``, weights ``nk / Σmask``).  The seeded
    start stays in Python, so parity checks feed both the same one.
    x: (n, d); mask: (n,).  Returns (weights (K,), means (K, d),
    variances (K, d)), CPU tensors of x's dtype (float64, else float32)."""
    lib = _require("em")
    dt = _io_dtype(x)
    x_ = _host(x, dt)
    n, d = x_.shape
    mu_ = _host(mu0, dt)
    k = mu_.shape[0]
    m_, w_, v_ = _host(mask, dt).reshape(-1), _host(w0, dt), _host(var0, dt)
    if m_.shape != (n,) or w_.shape != (k,) or mu_.shape != (k, d) or v_.shape != (k, d):
        raise ValueError(f"shapes x {x_.shape}, mask {m_.shape}, w0 {w_.shape}, mu0 {mu_.shape}, var0 {v_.shape}")
    w_out, mu_out, var_out = np.empty((k,), dt), np.empty((k, d), dt), np.empty((k, d), dt)
    rc = getattr(lib, _ENTRIES["em"][dt])(_ptr(x_), _ptr(m_), _ptr(w_), _ptr(mu_), _ptr(v_), n, k, d, int(iters),
                                          float(min_var), _ptr(w_out), _ptr(mu_out), _ptr(var_out))
    if rc != 0:
        raise ValueError(f"the host EM refused the shapes (n={n}, K={k}, d={d}, iters={iters})")
    return torch.from_numpy(w_out), torch.from_numpy(mu_out), torch.from_numpy(var_out)
