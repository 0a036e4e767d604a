"""Fisher-vector kernels (counterpart of ``keystone_tpu/ops/fisher_pallas.py``).

Two kernels, hand-written in CUDA C++ for Hopper (``csrc/fisher.cu``):

* ``fisher_encode`` — the FV encode of (n, T, d) descriptors against a
  diagonal GMM; replaces ``fisher_encode_pallas``.
* ``fused_forward`` — [SIFT normalize →] PCA project → FV encode in one
  pass over the raw descriptors; replaces ``fused_forward_pallas``.

Each takes every GMM shape, as the Pallas kernels do: the tiled
tensor-core kernel where its tile fits (``tiled``; the scorer's and the
fit's shapes), and otherwise the general path, plain CUDA-core kernels
through a device workspace.  ``csrc/fisher.cu`` picks the path from the
shape.  Each wrapper launches for a CUDA tensor (or raises) and takes
its plain version, ``fisher_encode_ref`` / ``fused_forward_ref``, only
for a tensor on the CPU.  ``LAUNCHES`` counts the launches by wrapper
and path; a launch recorded into a CUDA graph (the frozen applier's
bucket graphs) is counted by the graph and its replays instead
(``utils/graphs.py``).  Descriptors may be f32 or bf16 (the reference's
``mxu='bf16'`` stream); the kernels compute in f32 either way.
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict

import torch
from torch._subclasses.fake_tensor import FakeTensor

from keystone_tpu_torch.models.gmm import _LOG2PI, _log_gaussians
from keystone_tpu_torch.ops.sift import _sift_normalize
from keystone_tpu_torch.utils import graphs

#: kernel launches by wrapper name, the general path's under
#: ``<name>_general``; reset with ``reset_launches``
LAUNCHES = {"fisher_encode": 0, "fused_forward": 0, "fisher_encode_general": 0, "fused_forward_general": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------- plain versions


def fisher_encode_ref(xs, mask, w, mu, var):
    """xs: (n, T, d); mask: (n, T); w: (K,); mu, var: (K, d) → (n, 2·K·d).

    The same math as ``keystone_tpu/ops/fisher.py § _fisher_encode``:
    posteriors by the gemm expansion and logsumexp, masked sufficient
    statistics, Φ¹ then Φ², each (K, d) row-major.  In f32, or in
    float64 when every operand is float64 (the chain a float64 check
    holds the kernels and the host reference, ``ops/fisher_ffi.py``, to)."""
    xs = xs.to(torch.float64 if xs.dtype == torch.float64 else torch.float32)
    n, t, d = xs.shape
    lg = _log_gaussians(xs.reshape(n * t, d), mu, var, torch.log(w))
    lr = lg - torch.logsumexp(lg, dim=1, keepdim=True)
    gamma = torch.exp(lr).reshape(n, t, -1) * mask[..., None]
    counts = torch.clamp(torch.sum(mask, dim=1), min=1.0)
    s0 = gamma.sum(dim=1)
    s1 = torch.einsum("ntk,ntd->nkd", gamma, xs)
    s2 = torch.einsum("ntk,ntd->nkd", gamma, xs * xs)
    sigma = torch.sqrt(var)
    phi1 = (s1 - s0[..., None] * mu) / sigma
    phi2 = (s2 - 2.0 * mu * s1 + s0[..., None] * (mu * mu)) / var - s0[..., None]
    tnorm = counts[:, None, None]
    phi1 = phi1 / (tnorm * torch.sqrt(w)[None, :, None])
    phi2 = phi2 / (tnorm * torch.sqrt(2.0 * w)[None, :, None])
    k = mu.shape[0]
    return torch.cat([phi1.reshape(n, k * d), phi2.reshape(n, k * d)], dim=1)


def fused_forward_ref(desc, mask, components, mean, w, mu, var, normalize: bool = True):
    """The per-stage chain the fused kernel replaces:
    ``_sift_normalize`` (if ``normalize``) → PCA → ``fisher_encode_ref``."""
    z = desc.to(torch.float32)
    if normalize:
        z = _sift_normalize(z)
    if mean is not None:
        z = z - mean
    z = torch.matmul(z, components)
    return fisher_encode_ref(z, mask, w, mu, var)


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/fisher.cu, built on first use, with its C signatures declared."""
    from keystone_tpu_torch.kernels.build import LOCK, load

    with LOCK:
        return _declare(load("fisher"))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ks_fisher_encode.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i, i, p, p]
    lib.ks_fisher_encode.restype = i
    lib.ks_fused_forward.argtypes = [p, i, p, p, p, i, p, p, p, p, p, p, i, i, i, i, i, p, p]
    lib.ks_fused_forward.restype = i
    lib.ks_fisher_workspace.argtypes = [i, i, i, i, i]
    lib.ks_fisher_workspace.restype = ctypes.c_size_t
    lib.ks_fisher_tiled.argtypes = [i, i, i]
    lib.ks_fisher_tiled.restype = i
    lib.ks_error_string.argtypes = [i]
    lib.ks_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def tiled(d: int, k: int, d_in: int = 0) -> bool:
    """Whether the tiled kernel takes a GMM of K components in d dims
    (the encode for ``d_in = 0``, the fused kernel over d_in-wide
    descriptors otherwise); other shapes take the general path.  Asks
    ``csrc/fisher.cu``, so it builds the library on first use."""
    return bool(_lib().ks_fisher_tiled(int(d), int(k), int(d_in)))


def _workspace(n, t, d, k, d_in, dev):
    """The general path's device workspace for a call; None where it
    needs none (no descriptor)."""
    floats = _lib().ks_fisher_workspace(n, t, d, k, d_in)
    return None if floats == 0 else torch.empty(floats, dtype=torch.float32, device=dev)


def _check(name: str, t: torch.Tensor, shape, dtypes, device) -> None:
    if isinstance(t, FakeTensor):
        # a stage priced by its shapes (workflow/profiling.stage_cost): a
        # fake tensor's data pointer is null, so the kernel must not launch
        raise TypeError(f"{name} is a fake tensor; a kernel launches on data only")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_F32 = (torch.float32,)
_DESC = (torch.float32, torch.bfloat16)


def _posterior_weights(w, mu, var):
    """(2d, K) f32 weights and (2, K) f32 constants with
    log w_k + log N(x; μ_k, σ²_k) = cst[0, k] + cst[1, k] + Σ_j [x_j, x_j²] · wt[(2j, 2j+1), k].

    Computed in float64 and rounded once.  cst[1] holds what rounding
    cst[0] to f32 drops: the constant is ~|log N| (a hundred at d = 64),
    and an error of half its ulp, the same on every descriptor, would shift
    each component's posterior mass by as much, which the sums over T then
    carry.  The kernel adds cst[1] to the descriptor's sum before cst[0]."""
    w, mu, var = (t.to(torch.float64) for t in (w, mu, var))
    k, d = mu.shape
    inv = 1.0 / var
    muinv = mu * inv
    wt = torch.empty((2 * d, k), dtype=torch.float32, device=mu.device)
    wt[0::2] = muinv.T
    wt[1::2] = -0.5 * inv.T
    cst = (
        torch.log(w)
        - 0.5 * (torch.sum(torch.log(var), dim=1) + d * _LOG2PI)
        - 0.5 * torch.sum(mu * muinv, dim=1)
    )
    hi = cst.to(torch.float32)
    return wt, torch.stack([hi, (cst - hi.to(torch.float64)).to(torch.float32)])


#: _posterior_weights by the GMM tensors it was computed from (kept alive
#: here, so that their identity and version name their values), newest last
_WEIGHTS: "OrderedDict[tuple, tuple]" = OrderedDict()
_WEIGHTS_KEPT = 8


def _weights_for(w, mu, var):
    """``_posterior_weights(w, mu, var)``, computed once while those tensors
    live unchanged.  A model's GMM is fixed, and computing the weights is a
    dozen small launches a call, enough host time to pace a kernel call of
    a few hundred microseconds."""
    key = tuple((id(t), t._version) for t in (w, mu, var))
    hit = _WEIGHTS.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], (w, mu, var))):
        _WEIGHTS.move_to_end(key)
    else:
        hit = _WEIGHTS[key] = ((w, mu, var), _posterior_weights(w, mu, var))
        if len(_WEIGHTS) > _WEIGHTS_KEPT:
            _WEIGHTS.popitem(last=False)
    # a graph captured now reads them by address: it keeps them alive
    # past this cache's eviction
    graphs.keep(*hit[1])
    return hit[1]


def _aligned(t):
    """``t``, or a copy where its data does not start 16-byte aligned: the
    kernels read descriptor rows and the projection 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().ks_error_string(rc).decode()
        from keystone_tpu_torch.kernels.build import KernelError

        raise KernelError(f"{name} kernel launch failed ({rc}): {msg}")


def _check_gmm(w, mu, var, device):
    k, d = mu.shape
    _check("w", w, (k,), _F32, device)
    _check("mu", mu, (k, d), _F32, device)
    _check("var", var, (k, d), _F32, device)
    return k, d


def fisher_encode(xs, mask, w, mu, var):
    """xs: (n, T, d) f32 or bf16; mask: (n, T) f32; w: (K,); mu, var:
    (K, d) → (n, 2·K·d) f32, any K, d ≥ 1.  CUDA tensors launch the
    kernel (the tiled one or the general path); CPU tensors take
    ``fisher_encode_ref``."""
    if xs.device.type == "cpu":
        return fisher_encode_ref(xs, mask, w, mu, var)
    if xs.device.type != "cuda":
        raise ValueError(f"fisher_encode runs on cuda or cpu, not {xs.device}")
    dev = xs.device
    k, d = _check_gmm(w, mu, var, dev)
    n, t = xs.shape[0], xs.shape[1]
    _check("xs", xs, (n, t, d), _DESC, dev)
    _check("mask", mask, (n, t), _F32, dev)
    out = torch.empty((n, 2 * k * d), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    wt, cst = _weights_for(w, mu, var)
    xs = _aligned(xs)
    general = not tiled(d, k)
    ws = _workspace(n, t, d, k, 0, dev) if general else None
    rc = _lib().ks_fisher_encode(
        xs.data_ptr(), int(xs.dtype == torch.bfloat16), mask.data_ptr(),
        wt.data_ptr(), cst.data_ptr(), mu.data_ptr(), var.data_ptr(), w.data_ptr(),
        out.data_ptr(), n, t, d, k, None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "fisher_encode")
    key = "fisher_encode_general" if general else "fisher_encode"
    if not graphs.note_launch(key):  # a launch recorded into a graph runs nothing now
        LAUNCHES[key] += 1
    return out


def fused_forward(desc, mask, components, mean, w, mu, var, normalize: bool = True):
    """desc: (n, T, d_in) f32 or bf16 — raw SIFT output with
    ``normalize=True``, already normalized descriptors with False;
    mask: (n, T) f32; components: (d_in, d); mean: (d_in,) or None;
    GMM (w (K,), mu/var (K, d)) → (n, 2·K·d) f32, any K, d, d_in ≥ 1.
    CUDA tensors launch the kernel (the tiled one or the general path);
    CPU tensors take ``fused_forward_ref``."""
    if desc.device.type == "cpu":
        return fused_forward_ref(desc, mask, components, mean, w, mu, var, normalize)
    if desc.device.type != "cuda":
        raise ValueError(f"fused_forward runs on cuda or cpu, not {desc.device}")
    dev = desc.device
    k, d = _check_gmm(w, mu, var, dev)
    n, t, d_in = desc.shape
    _check("desc", desc, (n, t, d_in), _DESC, dev)
    _check("mask", mask, (n, t), _F32, dev)
    _check("components", components, (d_in, d), _F32, dev)
    if mean is not None:
        _check("mean", mean, (d_in,), _F32, dev)
    out = torch.empty((n, 2 * k * d), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    wt, cst = _weights_for(w, mu, var)
    desc, components = _aligned(desc), _aligned(components)
    general = not tiled(d, k, d_in)
    ws = _workspace(n, t, d, k, d_in, dev) if general else None
    rc = _lib().ks_fused_forward(
        desc.data_ptr(), int(desc.dtype == torch.bfloat16), mask.data_ptr(),
        components.data_ptr(), None if mean is None else mean.data_ptr(), int(bool(normalize)),
        wt.data_ptr(), cst.data_ptr(), mu.data_ptr(), var.data_ptr(), w.data_ptr(),
        out.data_ptr(), n, t, d_in, d, k, None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "fused_forward")
    key = "fused_forward_general" if general else "fused_forward"
    if not graphs.note_launch(key):  # a launch recorded into a graph runs nothing now
        LAUNCHES[key] += 1
    return out

