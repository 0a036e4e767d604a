"""Parity of the port's gram kernels' plain versions and dispatchers with
the JAX package: its Pallas gram kernels in interpret mode and its kernel
generators.  The CUDA kernels themselves are tested on the card by
test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models import kernel_ridge as jkr
from keystone_tpu.ops import gram_pallas
from keystone_tpu.ops.gram_pallas import gram_block_pallas, poly_block_pallas
from keystone_tpu_torch.models import kernel_ridge as kr
from keystone_tpu_torch.ops import gram_kernels as gk

# the JAX package's own tolerances (tests/test_gram_pallas.py): Gaussian
# f32 1e-5 absolute; polynomial 1e-5 absolute plus 1e-5 relative (its
# values reach tens); the bf16 operand stream 0.06 against f32
ATOL = 1e-5
RTOL_POLY = 1e-5
ATOL_BF16 = 0.06


def _xz(n=37, m=21, d=12, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.normal(size=(n, d))).astype(np.float32)
    z = (scale * rng.normal(size=(m, d))).astype(np.float32)
    return x, z


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("n,m,d,gamma", [
    (37, 21, 12, 0.3),
    (37, 21, 12, 0.05),
    (8, 5, 3, 1.0),
    (300, 260, 16, 0.2),  # several tiles on both grid axes (see the fixture below)
])
def test_gram_ref_matches_pallas_interpret(monkeypatch, n, m, d, gamma):
    # a small VMEM budget makes the reference tile 300 x 260 in 128-row
    # tiles, so its padding and slicing are exercised too
    monkeypatch.setattr(gram_pallas, "_VMEM_BUDGET", 1 << 17)
    x, z = _xz(n, m, d, seed=n)
    want = np.asarray(gram_block_pallas(jnp.asarray(x), jnp.asarray(z), gamma, interpret=True))
    got = gk.gram_block_ref(*_t(x, z), gamma).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("gamma", [0.4, 0.05])
def test_gaussian_generator_matches_jax(gamma):
    x, z = _xz()
    want = np.asarray(jkr.GaussianKernelGenerator(gamma)(jnp.asarray(x), jnp.asarray(z)))
    got = kr.GaussianKernelGenerator(gamma)(*_t(x, z)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("alpha,c", [(0.5, 1.25), (0.7, -0.5)])
def test_poly_ref_matches_pallas_interpret(degree, alpha, c):
    x, z = _xz(d=10)
    want = np.asarray(poly_block_pallas(jnp.asarray(x), jnp.asarray(z), alpha, c, degree, interpret=True))
    got = gk.poly_block_ref(*_t(x, z), alpha, c, degree).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_POLY, atol=ATOL)
    gen = jkr.PolynomialKernelGenerator(degree=degree, alpha=alpha, c=c)
    np.testing.assert_allclose(
        kr.PolynomialKernelGenerator(degree, alpha, c)(*_t(x, z)).numpy(),
        np.asarray(gen(jnp.asarray(x), jnp.asarray(z))), rtol=RTOL_POLY, atol=ATOL,
    )


def test_linear_is_the_polynomial_at_1_0_1():
    x, z = _xz()
    xt, zt = _t(x, z)
    want = np.asarray(jkr.LinearKernelGenerator()(jnp.asarray(x), jnp.asarray(z)))
    np.testing.assert_allclose(gk.linear_gram_block(xt, zt).numpy(), want, rtol=RTOL_POLY, atol=ATOL)
    np.testing.assert_array_equal(kr.LinearKernelGenerator()(xt, zt).numpy(), (xt @ zt.T).numpy())
    np.testing.assert_array_equal(gk.poly_block_ref(xt, zt, 1.0, 0.0, 1).numpy(), (xt @ zt.T).numpy())


def test_degree_zero_is_one_and_negative_degree_raises():
    xt, zt = _t(*_xz())
    assert (gk.poly_block_kernel(xt, zt, 0.5, -2.0, 0) == 1.0).all()
    with pytest.raises(ValueError, match="degree"):
        gk.poly_block_kernel(xt, zt, 1.0, 0.0, -1)
    with pytest.raises(ValueError, match="degree"):
        gk.poly_block_kernel(xt, zt, 1.0, 0.0, 1.5)


def test_bf16_stream_gram():
    """mxu='bf16' rounds the operands to bf16 and computes in f32, as the
    Pallas kernel's bf16 stream does."""
    x, z = _xz(d=16)
    xt, zt = _t(x, z)
    got = gk.gram_block(xt, zt, 0.3, mxu="bf16").numpy()
    want = np.asarray(gram_block_pallas(jnp.asarray(x), jnp.asarray(z), 0.3, interpret=True, mxu="bf16"))
    np.testing.assert_allclose(got, want, atol=ATOL)
    f32 = np.asarray(jkr.GaussianKernelGenerator(0.3)(jnp.asarray(x), jnp.asarray(z)))
    np.testing.assert_allclose(got, f32, atol=ATOL_BF16)
    assert not np.array_equal(got, f32)  # the stream really narrowed


def test_bf16_stream_poly():
    x, z = _xz(d=16, scale=0.5)
    xt, zt = _t(x, z)
    got = gk.poly_gram_block(xt, zt, 0.25, 1.0, 2, mxu="bf16").numpy()
    want = np.asarray(poly_block_pallas(jnp.asarray(x), jnp.asarray(z), 0.25, 1.0, 2,
                                        interpret=True, mxu="bf16"))
    np.testing.assert_allclose(got, want, rtol=RTOL_POLY, atol=ATOL)
    f32 = gk.poly_block_ref(xt, zt, 0.25, 1.0, 2).numpy()
    np.testing.assert_allclose(got, f32, atol=ATOL_BF16)


@pytest.mark.parametrize("which", ["gaussian", "polynomial", "linear"])
def test_gram_block_for_matches_each_generator(which):
    x, z = _xz()
    jgen, pgen = {
        "gaussian": (jkr.GaussianKernelGenerator(0.2), kr.GaussianKernelGenerator(0.2)),
        "polynomial": (jkr.PolynomialKernelGenerator(3, 0.4, -0.3), kr.PolynomialKernelGenerator(3, 0.4, -0.3)),
        "linear": (jkr.LinearKernelGenerator(), kr.LinearKernelGenerator()),
    }[which]
    want = np.asarray(gram_pallas.gram_block_for(jgen, jnp.asarray(x), jnp.asarray(z), use_pallas=False))
    gk.reset_launches()
    got = gk.gram_block_for(pgen, *_t(x, z)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_POLY, atol=ATOL)
    assert gk.LAUNCHES == {"gram_block": 0, "poly_block": 0}


def test_gram_block_for_duck_typed_generator_is_none():
    class Other:
        gamma = 0.2

        def __call__(self, a, b):
            return torch.ones((a.shape[0], b.shape[0]))

    xt, zt = _t(*_xz())
    assert gk.gram_block_for(Other(), xt, zt) is None
    assert gram_pallas.gram_block_for(Other(), jnp.asarray(xt.numpy()), jnp.asarray(zt.numpy())) is None


def test_plain_chain_on_request_equals_the_wrappers_cpu_path():
    xt, zt = _t(*_xz(n=19, m=7, d=5))
    np.testing.assert_array_equal(gk.gram_block(xt, zt, 0.3, use_kernel=False).numpy(),
                                  gk.gram_block(xt, zt, 0.3).numpy())
    np.testing.assert_array_equal(gk.poly_gram_block(xt, zt, 0.5, 1.0, 2, use_kernel=False).numpy(),
                                  gk.poly_gram_block(xt, zt, 0.5, 1.0, 2).numpy())


def test_empty_operands():
    x = torch.zeros((0, 4))
    z = torch.ones((3, 4))
    assert gk.gram_block(x, z, 0.1).shape == (0, 3)
    assert gk.poly_gram_block(z, x, 1.0, 0.0, 1).shape == (3, 0)
