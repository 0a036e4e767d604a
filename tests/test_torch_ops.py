"""Parity of each ported op on the scoring path with its JAX counterpart,
on the same numpy-seeded inputs, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models.block_ls import _block_predict as j_block_predict
from keystone_tpu.models.gmm import GaussianMixtureModel as JGmm
from keystone_tpu.models.pca import PCATransformer as JPca
from keystone_tpu.ops import filters as jfilters
from keystone_tpu.ops import sift as jsift
from keystone_tpu.ops.images import GrayScaler as JGray
from keystone_tpu.ops.images import PixelScaler as JPixel
from keystone_tpu.ops.lcs import LCSExtractor as JLcs
from keystone_tpu.ops.lcs import _lcs as j_lcs
from keystone_tpu.ops.stats import NormalizeRows as JNorm
from keystone_tpu.ops.stats import SignedHellingerMapper as JHell
from keystone_tpu.ops.util import ClassLabelIndicators as JLabels
from keystone_tpu.ops.util import TopKClassifier as JTopK
from keystone_tpu_torch.models.block_ls import _block_predict
from keystone_tpu_torch.models.gmm import GaussianMixtureModel
from keystone_tpu_torch.models.pca import PCATransformer
from keystone_tpu_torch.ops import filters, sift
from keystone_tpu_torch.ops.images import GrayScaler, PixelScaler
from keystone_tpu_torch.ops.lcs import LCSExtractor, _lcs
from keystone_tpu_torch.ops.stats import NormalizeRows, SignedHellingerMapper
from keystone_tpu_torch.ops.util import ClassLabelIndicators, TopKClassifier

RNG = np.random.default_rng(0)
IMGS = RNG.random((3, 40, 36)).astype(np.float32)  # grayscale, non-square
RGB = RNG.integers(0, 256, (3, 44, 40, 3), dtype=np.uint8)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_blur_matrices_and_blur_match():
    for extent, sigma in ((40, 0.44), (36, 1.3)):
        np.testing.assert_array_equal(
            filters._blur_matrix(extent, sigma), jfilters._blur_matrix(extent, sigma)
        )
    x = RNG.random((2, 40, 36, 3)).astype(np.float32)
    got = filters.separable_gaussian_blur(torch.from_numpy(x), 0.7)
    want = jfilters.separable_gaussian_blur(jnp.asarray(x), 0.7)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)


def test_blur_above_matmul_limit_raises():
    """Above the banded form's 512 px the blur used to raise; it now takes
    the reference's conv path (the name is kept: the test's history)."""
    x = RNG.random((1, 513, 8, 1)).astype(np.float32)
    got = filters.separable_gaussian_blur(torch.from_numpy(x), 1.0)
    want = jfilters.separable_gaussian_blur(jnp.asarray(x), 1.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_window_matrix_and_counts_match():
    for extent, step, b in ((40, 4, 4), (36, 6, 3), (10, 4, 4)):
        a, k = sift._window_matrix(extent, step, b)
        ja, jk = jsift._window_matrix(extent, step, b)
        assert k == jk
        np.testing.assert_array_equal(a, ja)
    assert sift.sift_output_count(40, 36, 4, (4, 6)) == jsift.sift_output_count(40, 36, 4, (4, 6))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("sigma", [0.0, 0.4410])
def test_dsift_matches(normalize, sigma):
    got = sift._dsift(torch.from_numpy(IMGS), 4, 4, sigma=sigma, normalize=normalize)
    want = jsift._dsift(jnp.asarray(IMGS), 4, 4, sigma=sigma, normalize=normalize)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


def test_sift_extractor_matches():
    ext = sift.SIFTExtractor(step=6, bin_sizes=(4,))
    ref = jsift.SIFTExtractor(step=6, bin_sizes=(4,))
    (d, m), (jd, jm) = ext.apply_batch(torch.from_numpy(IMGS)), ref.apply_batch(jnp.asarray(IMGS))
    np.testing.assert_allclose(_np(d), _np(jd), atol=2e-5)
    np.testing.assert_array_equal(_np(m), _np(jm))


def test_lcs_matches():
    x = RGB.astype(np.float32) / 255.0
    got = _lcs(torch.from_numpy(x), 6, 6)
    want = j_lcs(jnp.asarray(x), 6, 6)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    d, m = LCSExtractor(8, 6).apply_batch(torch.from_numpy(x))
    assert d.shape[-1] == 96 and m.shape == d.shape[:2]


def test_lcs_of_an_image_smaller_than_a_subpatch_matches():
    """No keypoint fits: (n, 0, 2·C·16) descriptors, as in the reference."""
    x = RGB[:2, :5, :5].astype(np.float32) / 255.0
    d, m = LCSExtractor(6, 6).apply_batch(torch.from_numpy(x))
    want, want_mask = JLcs(6, 6).apply_batch(jnp.asarray(x))
    assert d.shape == want.shape == (2, 0, 96) and m.shape == want_mask.shape == (2, 0)


def test_image_scalers_match():
    for scaler, ref in ((PixelScaler(), JPixel()), (PixelScaler(only_if_integer=True), JPixel(only_if_integer=True))):
        for x in (RGB, RGB.astype(np.float32) / 255.0):
            got = scaler.apply_batch(torch.from_numpy(x))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_np(got), _np(ref.apply_batch(jnp.asarray(x))), rtol=1e-6)
    x = RGB.astype(np.float32)
    np.testing.assert_allclose(
        _np(GrayScaler().apply_batch(torch.from_numpy(x))), _np(JGray().apply_batch(jnp.asarray(x))), rtol=1e-6
    )


def test_pca_and_gmm_match():
    x = RNG.normal(size=(2, 30, 24)).astype(np.float32)
    comp = np.linalg.qr(RNG.normal(size=(24, 8)))[0].astype(np.float32)
    mean = RNG.normal(size=(24,)).astype(np.float32)
    for m in (mean, None):
        port = PCATransformer(torch.from_numpy(comp), None if m is None else torch.from_numpy(m))
        ref = JPca(jnp.asarray(comp), None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(
            _np(port.apply_batch(torch.from_numpy(x))), _np(ref.apply_batch(jnp.asarray(x))), atol=1e-5
        )
    w = RNG.random(5).astype(np.float32)
    w /= w.sum()
    mu = RNG.normal(size=(5, 8)).astype(np.float32)
    var = (0.5 + RNG.random((5, 8))).astype(np.float32)
    z = RNG.normal(size=(40, 8)).astype(np.float32)
    got = GaussianMixtureModel(*map(torch.from_numpy, (w, mu, var))).apply_batch(torch.from_numpy(z))
    want = JGmm(*map(jnp.asarray, (w, mu, var))).apply_batch(jnp.asarray(z))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_row_normalizers_match():
    x = RNG.normal(size=(4, 50)).astype(np.float32)
    x[1] = 0.0  # the eps floor
    for port, ref in ((SignedHellingerMapper(), JHell()), (NormalizeRows(), JNorm())):
        np.testing.assert_allclose(
            _np(port.apply_batch(torch.from_numpy(x))), _np(ref.apply_batch(jnp.asarray(x))), atol=1e-6
        )


@pytest.mark.parametrize("with_offsets", [False, True])
def test_block_predict_matches(with_offsets):
    x = RNG.normal(size=(5, 100)).astype(np.float32)  # 100 < 2·64: block padding
    wts = RNG.normal(size=(2, 64, 7)).astype(np.float32)
    icpt = RNG.normal(size=(7,)).astype(np.float32) if with_offsets else None
    fmean = RNG.normal(size=(100,)).astype(np.float32) if with_offsets else None

    def t(a):
        return None if a is None else torch.from_numpy(a)

    def j(a):
        return None if a is None else jnp.asarray(a)

    got = _block_predict(t(x), t(wts), t(icpt), t(fmean))
    want = j_block_predict(j(x), j(wts), j(icpt), j(fmean))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)


def test_top_k_matches():
    x = RNG.normal(size=(6, 12)).astype(np.float32)
    for k in (5, 20):
        np.testing.assert_array_equal(
            _np(TopKClassifier(k).apply_batch(torch.from_numpy(x))), _np(JTopK(k).apply_batch(jnp.asarray(x)))
        )


def test_top_k_breaks_ties_as_the_reference():
    """Integer scores tie often: the lower index first among equals."""
    x = np.random.default_rng(5).integers(0, 3, (2000, 12)).astype(np.float32)
    x[0] = 0.0  # all equal
    got = _np(TopKClassifier(5).apply_batch(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, _np(JTopK(5).apply_batch(jnp.asarray(x))))
    np.testing.assert_array_equal(got[0], [0, 1, 2, 3, 4])


def test_class_label_indicators_match_outside_the_classes():
    labels = np.array([0, 3, -1, 4, 7, 2], np.int32)  # -1, 4, 7: no class of 4
    got = _np(ClassLabelIndicators(4).apply_batch(torch.from_numpy(labels)))
    np.testing.assert_array_equal(got, _np(JLabels(4).apply_batch(jnp.asarray(labels))))
    np.testing.assert_array_equal(got[[2, 3, 4]], -np.ones((3, 4)))
