"""Parity of the port's Fisher-vector kernels' plain versions and
transformers with the JAX package (Pallas kernels in interpret mode).
The CUDA kernels themselves are tested on the card by test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models.gmm import GaussianMixtureModel as JGmm
from keystone_tpu.models.pca import PCATransformer as JPca
from keystone_tpu.ops.fisher import FisherVector as JFisherVector
from keystone_tpu.ops.fisher import FusedPcaFisherVector as JFused
from keystone_tpu.ops.fisher import _fisher_encode as j_fisher_encode
from keystone_tpu.ops.fisher_pallas import fisher_encode_pallas, fused_forward_pallas
from keystone_tpu_torch.models.gmm import GaussianMixtureModel
from keystone_tpu_torch.models.pca import PCATransformer
from keystone_tpu_torch.ops import fisher as port_fisher
from keystone_tpu_torch.ops import fisher_kernels as fk
from keystone_tpu_torch.ops.fisher import FisherVector, FusedPcaFisherVector
from keystone_tpu_torch.utils import precision

# the JAX package's own tolerances (tests/test_pallas.py)
ATOL_FV = 2e-5
ATOL_FUSED = 3e-5


def _gmm(rng, k, d):
    w = rng.random(k).astype(np.float32)
    w /= w.sum()
    mu = rng.normal(size=(k, d)).astype(np.float32)
    var = (0.5 + rng.random((k, d))).astype(np.float32)
    return w, mu, var


def _encode_setup(n=3, t=200, d=16, k=8, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, t, d)).astype(np.float32)
    mask = (rng.random((n, t)) < 0.8).astype(np.float32)
    return (xs, mask, *_gmm(rng, k, d))


def _fused_setup(n=2, t=64, d_in=32, d=16, k=8, seed=0):
    rng = np.random.default_rng(seed)
    raw = np.abs(rng.normal(size=(n, t, d_in))).astype(np.float32)
    mask = (rng.random((n, t)) < 0.85).astype(np.float32)
    comp = np.linalg.qr(rng.normal(size=(d_in, d)))[0].astype(np.float32)
    mean = (0.05 * rng.random(d_in)).astype(np.float32)
    w, mu, var = _gmm(rng, k, d)
    return raw, mask, comp, mean, w, 0.3 * mu, var


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("t", [200, 137])  # 137: a ragged T
def test_fisher_encode_ref_matches_pallas_and_xla(t):
    args = _encode_setup(t=t)
    got = fk.fisher_encode_ref(*_t(*args)).numpy()
    pallas = np.asarray(fisher_encode_pallas(*_j(*args), interpret=True))
    xla = np.asarray(j_fisher_encode(*_j(*args)))
    np.testing.assert_allclose(got, pallas, atol=ATOL_FV)
    np.testing.assert_allclose(got, xla, atol=ATOL_FV)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("with_mean", [True, False])
@pytest.mark.parametrize("t", [64, 45])  # 45: a ragged T
def test_fused_forward_ref_matches_pallas(normalize, with_mean, t):
    raw, mask, comp, mean, w, mu, var = _fused_setup(t=t)
    mean = mean if with_mean else None
    got = fk.fused_forward_ref(*_t(raw, mask, comp, mean, w, mu, var), normalize).numpy()
    want = np.asarray(
        fused_forward_pallas(
            *_j(raw, mask, comp, mean, w, mu, var), interpret=True, normalize=normalize
        )
    )
    np.testing.assert_allclose(got, want, atol=ATOL_FUSED)


def test_wrappers_take_plain_version_on_cpu():
    fk.reset_launches()
    args = _t(*_encode_setup(t=50))
    np.testing.assert_array_equal(fk.fisher_encode(*args).numpy(), fk.fisher_encode_ref(*args).numpy())
    raw, mask, comp, mean, w, mu, var = _t(*_fused_setup())
    np.testing.assert_array_equal(
        fk.fused_forward(raw, mask, comp, mean, w, mu, var, True).numpy(),
        fk.fused_forward_ref(raw, mask, comp, mean, w, mu, var, True).numpy(),
    )
    assert not any(fk.LAUNCHES.values()), fk.LAUNCHES


def test_fisher_vector_transformer_matches_jax():
    xs, mask, w, mu, var = _encode_setup(t=90)
    port = FisherVector(GaussianMixtureModel(*_t(w, mu, var)))
    ref = JFisherVector(JGmm(*_j(w, mu, var)))
    got = port.apply_batch(*_t(xs, mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.apply_batch(*_j(xs, mask))), atol=ATOL_FV)
    # a single (T, d) set and a missing mask
    one = port.apply_batch(torch.from_numpy(xs[0])).numpy()
    np.testing.assert_allclose(one, np.asarray(ref.apply_batch(jnp.asarray(xs[:1]))[0]), atol=ATOL_FV)


@pytest.mark.parametrize("sift_normalize", [True, False])
def test_fused_transformer_matches_jax(sift_normalize):
    raw, mask, comp, mean, w, mu, var = _fused_setup(t=40)
    port = FusedPcaFisherVector(
        PCATransformer(*_t(comp, mean)), GaussianMixtureModel(*_t(w, mu, var)), sift_normalize
    )
    ref = JFused(JPca(*_j(comp, mean)), JGmm(*_j(w, mu, var)), sift_normalize)
    got = port.apply_batch(*_t(raw, mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.apply_batch(*_j(raw, mask))), atol=ATOL_FUSED)
    assert port.label == ref.label


def test_bf16_stream_matches_pallas_bf16():
    """On the kernel path the bf16 descriptor stream rounds the
    descriptors and computes in f32, in both packages (on a CPU tensor
    the wrapper's plain version sees the rounded descriptors); against
    the f32 encode it stays within the JAX package's bf16 tolerance."""
    xs, mask, w, mu, var = _encode_setup(t=64)
    port = FisherVector(GaussianMixtureModel(*_t(w, mu, var)), use_kernel=True)
    with precision.matmul("bf16"):
        got = port.apply_batch(*_t(xs, mask)).numpy()
    want = np.asarray(fisher_encode_pallas(*_j(xs, mask, w, mu, var), interpret=True, mxu="bf16"))
    np.testing.assert_allclose(got, want, atol=ATOL_FV)
    f32 = port.apply_batch(*_t(xs, mask)).numpy()
    np.testing.assert_allclose(got, f32, atol=5e-2)
    assert np.abs(got - f32).max() > 0


# GMM shapes (d, K, d_in; d_in = 0 for the encode) that the Pallas kernels
# take: those of the port's tiled kernel (the scorer's K = 256, the fit's
# K = 64, K·d = 16384 at d = 8) and those it leaves to its general path
# (K·d over its statistics fragments, d or K off the 8-tiling, d_in off the
# 4-tiling, no tile within shared memory)
GMM_SHAPES = [
    (64, 256, 0), (64, 256, 128), (64, 256, 96), (64, 64, 128), (8, 2048, 0),
    (64, 512, 0), (64, 512, 128), (60, 64, 0), (64, 60, 0), (64, 64, 130),
    (64, 256, 256), (32, 512, 256), (64, 256, 512),
]


@pytest.mark.parametrize("d,k,d_in", GMM_SHAPES)
def test_transformers_take_every_gmm_shape(d, k, d_in):
    """use_kernel=True at any GMM shape: on a CPU tensor the wrapper's
    plain version, against the Pallas kernel in interpret mode (on the
    card the same shapes launch the kernel, test_torch_cuda.py)."""
    if d_in == 0:
        xs, mask, w, mu, var = _encode_setup(n=2, t=24, d=d, k=k, seed=d + k)
        got = FisherVector(GaussianMixtureModel(*_t(w, mu, var)), use_kernel=True).apply_batch(*_t(xs, mask))
        want = fisher_encode_pallas(*_j(xs, mask, w, mu, var), interpret=True)
        atol = ATOL_FV
    else:
        raw, mask, comp, mean, w, mu, var = _fused_setup(n=2, t=24, d_in=d_in, d=d, k=k, seed=d + k)
        got = FusedPcaFisherVector(PCATransformer(*_t(comp, mean)), GaussianMixtureModel(*_t(w, mu, var)),
                                   sift_normalize=True, use_kernel=True).apply_batch(*_t(raw, mask))
        want = fused_forward_pallas(*_j(raw, mask, comp, mean, w, mu, var), interpret=True, normalize=True)
        atol = ATOL_FUSED
    assert tuple(got.shape) == (2, 2 * k * d)
    # plus test_torch_cuda.py's relative term: at d = 64 and T = 24 FV
    # entries reach ~5, where two f32 chains summing in other orders differ
    # by ~1e-6 relative
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=1e-5)


class _OnTheCard:
    """Stands in for a CUDA tensor in the dispatch decision."""

    is_cuda = True


@pytest.mark.parametrize("flag,on_card,launch", [
    (None, True, True), (None, False, False), (True, False, True), (True, True, True), (False, True, False),
])
def test_transformers_hand_the_kernel_every_cuda_tensor(flag, on_card, launch):
    """use_kernel=None gives the kernel wrapper every CUDA tensor, whatever
    the GMM's shape, and the CPU tensors to the plain chain; True always
    asks the wrapper (its plain version on the CPU); False never does."""
    xs = _OnTheCard() if on_card else torch.zeros(1)
    assert port_fisher._use_kernel(flag, xs) is launch
