"""The host float64 Fisher-vector encode and GMM EM (``ops/fisher_ffi.py``
→ ``csrc/keystone_ffi.cpp``, g++ at first use) against the JAX package's
XLA custom calls (``keystone_tpu/ops/fisher_ffi.py`` over
``native/keystone_ffi.cpp``) on the same numpy inputs, and against the port's
plain chains (``fisher_encode_ref``, ``_em_steps``) in float64.  A
missing library raises: there is no fall-back."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.ops import fisher_ffi as jffi
from keystone_tpu_torch.kernels import build
from keystone_tpu_torch.models.gmm import _em_steps
from keystone_tpu_torch.ops import fisher_ffi
from keystone_tpu_torch.ops.fisher_kernels import fisher_encode_ref

REPO = Path(__file__).resolve().parent.parent
# the same C++ arithmetic on both sides: float64 I/O to the last bits,
# float32 I/O to one rounding of the output
RTOL_F64, ATOL_F64 = 1e-10, 1e-12
TOL_F32 = 1e-6
TOL_EM_F64 = 1e-9
# against the plain chains: the reference's own tolerances
# (tests/test_native.py:145, 183, 235-237)
TOL_ENC_PLAIN = 1e-4
ATOL_W, ATOL_MU, ATOL_VAR = 2e-5, 2e-4, 2e-4


def _encode_problem(seed, n=3, t=17, d=8, k=5, masked=True):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, t, d))
    mask = (rng.uniform(size=(n, t)) > 0.3).astype(np.float64) if masked else np.ones((n, t))
    mask[0, :3] = 0.0
    w = rng.dirichlet(np.ones(k))
    mu = rng.normal(size=(k, d))
    var = rng.uniform(0.5, 2.0, size=(k, d))
    return xs, mask, w, mu, var


def _em_problem(seed=0, n=200, d=6, k=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(k, d))
    x = centers[rng.integers(0, k, n)] + rng.normal(size=(n, d))
    mask = np.ones((n,))
    mask[-7:] = 0.0
    return x, mask, np.full((k,), 1.0 / k), x[:k].copy(), np.ones((k, d))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both libraries loaded.  The reference's source is compiled here into
    a temporary directory with its Makefile's flags (not by ``make`` into
    the package, where another test process may be building it too) and
    handed to the reference's own loader and registration."""
    import ctypes
    import subprocess

    import keystone_tpu.native as jnative

    if not jffi._lib_loaded:
        so = tmp_path_factory.mktemp("reference_ffi") / "libkeystone_ffi.so"
        subprocess.run(["g++", "-O3", "-fPIC", "-std=c++20", f"-I{jax.ffi.include_dir()}", "-shared", "-o", str(so),
                        str(REPO / "native" / "keystone_ffi.cpp")], check=True, capture_output=True, timeout=300)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnative, "build_and_load", lambda so_path, make_target=None: ctypes.CDLL(str(so)))
            assert jffi.ffi_available() and jffi.ffi_available("em")
    assert jffi.ffi_available() and jffi.ffi_available("em")
    assert fisher_ffi.ffi_available() and fisher_ffi.ffi_available("em")


@pytest.mark.parametrize("seed,masked", [(0, True), (1, False), (2, True)])
def test_encode_float64_matches_the_reference_custom_call(both, seed, masked):
    args = _encode_problem(seed, masked=masked)
    with jax.enable_x64(True):
        want = np.asarray(jffi.fisher_encode_ffi(*args))
    assert want.dtype == np.float64
    got = fisher_ffi.fisher_encode_ffi(*args)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_F64, atol=ATOL_F64)


def test_encode_float32_io_matches_the_reference_custom_call(both):
    args = [a.astype(np.float32) for a in _encode_problem(3)]
    want = np.asarray(jffi.fisher_encode_ffi(*args))
    assert want.dtype == np.float32
    got = fisher_ffi.fisher_encode_ffi(*[torch.from_numpy(a) for a in args])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32, atol=TOL_F32)


def test_encode_against_the_plain_chain_in_float64(both):
    args = _encode_problem(4, n=4, t=31, d=12, k=6)
    ref = fisher_encode_ref(*[torch.from_numpy(a) for a in args])
    assert ref.dtype == torch.float64
    np.testing.assert_allclose(fisher_ffi.fisher_encode_ffi(*args).numpy(), ref.numpy(), atol=TOL_ENC_PLAIN,
                               rtol=TOL_ENC_PLAIN)
    # and the plain f32 chain within f32 rounding of the float64 encode
    ref32 = fisher_encode_ref(*[torch.from_numpy(a.astype(np.float32)) for a in args])
    np.testing.assert_allclose(ref32.numpy(), fisher_ffi.fisher_encode_ffi(*args).numpy(), atol=5e-5, rtol=5e-4)


def test_em_float64_matches_the_reference_custom_call(both):
    x, mask, w0, mu0, var0 = _em_problem()
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jffi.gmm_em_ffi(x, mask, w0, mu0, var0, iters=10)]
    got = fisher_ffi.gmm_em_ffi(x, mask, w0, mu0, var0, iters=10)
    for g, r in zip(got, want):
        assert g.dtype == torch.float64 and r.dtype == np.float64
        np.testing.assert_allclose(g.numpy(), r, rtol=TOL_EM_F64, atol=TOL_EM_F64)
    assert abs(float(got[0].sum()) - 1.0) < 1e-12


def test_em_float32_io_matches_the_reference_custom_call(both):
    x, mask, w0, mu0, var0 = (a.astype(np.float32) for a in _em_problem(1))
    want = [np.asarray(a) for a in jffi.gmm_em_ffi(x, mask, w0, mu0, var0, iters=10)]
    got = fisher_ffi.gmm_em_ffi(x, mask, w0, mu0, var0, iters=10)
    for g, r in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, rtol=TOL_F32, atol=TOL_F32)


def test_em_against_the_plain_em_in_float64(both):
    x, mask, w0, mu0, var0 = _em_problem(2)
    t = [torch.from_numpy(a) for a in (x, mask, w0, mu0, var0)]
    w_p, mu_p, var_p = _em_steps(t[0], t[1].sum(), t[1], t[2], t[3], t[4], 10, 1e-6)
    w_c, mu_c, var_c = fisher_ffi.gmm_em_ffi(x, mask, w0, mu0, var0, iters=10)
    np.testing.assert_allclose(w_c.numpy(), w_p.numpy(), atol=ATOL_W)
    np.testing.assert_allclose(mu_c.numpy(), mu_p.numpy(), atol=ATOL_MU)
    np.testing.assert_allclose(var_c.numpy(), var_p.numpy(), atol=ATOL_VAR)


def test_missing_library_raises_and_does_not_fall_back(monkeypatch):
    def refuse(name):
        raise build.KernelError(f"g++ not found: cannot build {name}")

    monkeypatch.setattr(build, "load", refuse)
    fisher_ffi._library.cache_clear()
    try:
        assert not fisher_ffi.ffi_available() and not fisher_ffi.ffi_available("em")
        args = _encode_problem(5)
        with pytest.raises(RuntimeError, match="unavailable"):
            fisher_ffi.fisher_encode_ffi(*args)
        with pytest.raises(RuntimeError, match="unavailable"):
            fisher_ffi.gmm_em_ffi(*_em_problem(), iters=2)
        with pytest.raises(ValueError, match="unknown FFI group"):
            fisher_ffi.ffi_available("gram")
    finally:
        monkeypatch.undo()
        fisher_ffi._library.cache_clear()
    assert fisher_ffi.ffi_available()
