"""The port's fit modules against the JAX package, one module at a time,
on the CPU: PCA, k-means++, GMM EM, the samplers, the block least-squares
solvers, the evaluators and the synthetic images.  The reference's draws
(k-means++ seeding) cannot be repeated by the port, so its seeded
centres are passed in and the deterministic steps are held against it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.evaluation import evaluators as jev
from keystone_tpu.loaders.imagenet import ImageNetLoader as JLoader
from keystone_tpu.models.block_ls import BlockLeastSquaresEstimator as JBls
from keystone_tpu.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator as JBwls
from keystone_tpu.models.block_weighted_ls import class_weights as j_class_weights
from keystone_tpu.models.gmm import _em_steps as j_em_steps
from keystone_tpu.models.gmm import _gmm_fit as j_gmm_fit
from keystone_tpu.models.kmeans import KMeansModel as JKMeansModel
from keystone_tpu.models.kmeans import _kmeans_fit as j_kmeans_fit
from keystone_tpu.models.pca import PCAEstimator as JPCAEstimator
from keystone_tpu.models.pca import _pca_fit as j_pca_fit
from keystone_tpu.models.pca import _pca_masked as j_pca_masked
from keystone_tpu.ops.stats import Sampler as JSampler
from keystone_tpu.workflow import Dataset
from keystone_tpu_torch import evaluation as ev
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.models import block_ls, block_weighted_ls, gmm, kmeans, pca
from keystone_tpu_torch.ops.fisher import FisherVector, GMMFisherVectorEstimator
from keystone_tpu_torch.ops.stats import ColumnSampler, Sampler

# PCA components of well-separated spectra: f32 SVDs in two libraries
# agree to ~1e-6 relative; 1e-5 absolute on unit-norm columns
ATOL_PCA = 1e-5
# Lloyd steps: means of ≤ 10² rows of size ~5, summed in another order
ATOL_LLOYD = 1e-5
# EM: the reference's own EM parity tolerances (tests/test_native.py:235-237)
ATOL_W, ATOL_MU, ATOL_VAR = 2e-5, 2e-4, 2e-4
# BCD against a float64 direct solve: the reference's (tests/test_solvers.py)
ATOL_BCD_EXACT = 5e-3
# BCD against the reference's f32 sweep, the same blocks and epochs:
# f32 products summed in another order, over 30-40 epochs
ATOL_BCD_REF = 2e-5


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _anisotropic(rng, n, d, lead=3.0):
    """Rows with a geometric spectrum falling from ``lead`` by 0.75 a
    direction, and a non-zero mean.  Singular values this far apart
    define each component to f32's precision; near-equal ones would
    leave the components (not the projector) free to rotate by rounding
    in either package."""
    base = rng.normal(size=(n, d)) * lead * 0.75 ** np.arange(d)
    rot = np.linalg.qr(rng.normal(size=(d, d)))[0]
    return (base @ rot.T + rng.normal(size=d)).astype(np.float32)


def _sign_aligned(got, ref):
    """``got``'s columns flipped to the signs of ``ref``'s."""
    return got * np.sign(np.sum(got * ref, axis=0, keepdims=True))


def _check_components(got, want):
    np.testing.assert_allclose(got @ got.T, want @ want.T, atol=ATOL_PCA)
    np.testing.assert_allclose(_sign_aligned(got, want), want, atol=ATOL_PCA)


# ---------------------------------------------------------------- PCA


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n", [256, 200])  # 200: the rows past n are padding
def test_pca_fit_matches_reference(center, n):
    x = _anisotropic(np.random.default_rng(0), 256, 24)
    comp, mean = pca._pca_fit(torch.from_numpy(x), n, 8, center)
    j_comp, j_mean = j_pca_fit(jnp.asarray(x), float(n), 8, center)
    _check_components(comp.numpy(), np.asarray(j_comp))
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), atol=1e-5)


@pytest.mark.parametrize("center", [True, False])
def test_pca_masked_matches_reference(center):
    rng = np.random.default_rng(1)
    x = _anisotropic(rng, 8 * 40, 16).reshape(8, 40, 16)
    mask = (rng.random((8, 40)) < 0.7).astype(np.float32)
    comp, mean = pca._pca_masked(*_t(x, mask), 6, center)
    j_comp, j_mean = j_pca_masked(jnp.asarray(x), jnp.asarray(mask), 6, center)
    _check_components(comp.numpy(), np.asarray(j_comp))
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), atol=1e-5)


def test_pca_estimator_matches_reference_and_float64():
    x = _anisotropic(np.random.default_rng(2), 512, 32)
    model = pca.PCAEstimator(10).fit_arrays(x, device="cpu")
    ref = JPCAEstimator(10).fit_arrays(x)
    _check_components(model.components.numpy(), np.asarray(ref.components))
    xm = x.astype(np.float64) - x.astype(np.float64).mean(0)
    vt = np.linalg.svd(xm, full_matrices=False)[2][:10]
    np.testing.assert_allclose(model.components.numpy() @ model.components.numpy().T, vt.T @ vt,
                               atol=ATOL_PCA)
    got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.apply_batch(jnp.asarray(x))) * np.sign(
        np.sum(model.components.numpy() * np.asarray(ref.components), axis=0)), atol=1e-4)


# ---------------------------------------------------------------- k-means


def _clustered(rng, n, d, k, spread=0.3):
    centers = 5.0 * rng.normal(size=(k, d))
    return (centers[rng.integers(0, k, n)] + spread * rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_lloyd_from_reference_seeds_matches_reference(masked):
    rng = np.random.default_rng(3)
    x = _clustered(rng, 320, 6, 5, spread=1.5)
    row_ok = (rng.random(320) < 0.8).astype(np.float32) if masked else np.ones(320, np.float32)
    x = x * row_ok[:, None]  # as the reference's fit_dataset zeroes masked rows
    key = jax.random.PRNGKey(7)
    seeds = np.asarray(j_kmeans_fit(jnp.asarray(x), jnp.asarray(row_ok), 8, 0, key))
    want = np.asarray(j_kmeans_fit(jnp.asarray(x), jnp.asarray(row_ok), 8, 6, key))
    got = kmeans._lloyd(*_t(x, row_ok, seeds), 6).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_LLOYD)


def test_kmeans_seeding_draws_valid_rows_only():
    rng = np.random.default_rng(4)
    x = _clustered(rng, 200, 3, 4)
    row_ok = np.ones(200, np.float32)
    row_ok[::3] = 0.0
    c = kmeans._kmeans_seed(*_t(x, row_ok), 12, kmeans.generator(0, "cpu")).numpy()
    rows = {tuple(r) for r in x[row_ok > 0]}
    assert all(tuple(r) in rows for r in c)
    again = kmeans._kmeans_seed(*_t(x, row_ok), 12, kmeans.generator(0, "cpu")).numpy()
    np.testing.assert_array_equal(c, again)  # one seed, one draw


def test_kmeans_seeding_spreads_and_survives_duplicates():
    rng = np.random.default_rng(5)
    x = _clustered(rng, 300, 2, 3, spread=0.05)
    c = kmeans._kmeans_seed(torch.from_numpy(x), torch.ones(300), 3, kmeans.generator(1, "cpu")).numpy()
    # ∝ distance²: three well-separated clusters get one seed each
    assert np.min(np.linalg.norm(c[:, None] - c[None], axis=-1) + 1e3 * np.eye(3)) > 1.0
    dup = np.ones((16, 2), np.float32)  # every distance 0: the +1e-30 still draws
    c = kmeans._kmeans_seed(torch.from_numpy(dup), torch.ones(16), 4, kmeans.generator(0, "cpu"))
    np.testing.assert_array_equal(c.numpy(), dup[:4])


def test_kmeans_estimator_recovers_clusters_and_model_matches_reference():
    rng = np.random.default_rng(5)
    centers = np.array([[5, 5], [-5, 5], [0, -5]], np.float32)
    x = np.concatenate([c + 0.2 * rng.normal(size=(50, 2)).astype(np.float32) for c in centers])
    model = kmeans.KMeansPlusPlusEstimator(3, max_iterations=20, seed=1).fit_arrays(x, device="cpu")
    np.testing.assert_allclose(np.sort(model.centers.numpy(), axis=0), np.sort(centers, axis=0), atol=0.3)
    ref = JKMeansModel(jnp.asarray(model.centers.numpy()))
    mask = (rng.random((3, 50)) < 0.7).astype(np.float32)
    xs = x.reshape(3, 50, 2)
    got, got_mask = model.apply_batch(*_t(xs, mask))
    want, _ = ref.apply_batch(jnp.asarray(xs), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    np.testing.assert_array_equal(model.assign(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref.assign(jnp.asarray(x))))


def test_kmeans_assign_takes_the_lowest_index_on_ties():
    centers = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [1.0, 0.0]])
    x = torch.tensor([[0.0, 0.0], [2.0, 0.0]])  # equidistant from 0 and 1; on 0 and 2
    assert kmeans.KMeansModel(centers).assign(x).tolist() == [0, 0]


# ---------------------------------------------------------------- GMM


def _em_setup(n=200, d=6, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = _clustered(rng, n, d, k, spread=1.0)
    w0 = np.full((k,), 1.0 / k, np.float32)
    return x, w0, x[:k].copy(), np.ones((k, d), np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_em_steps_match_reference(masked):
    x, w0, mu0, var0 = _em_setup()
    row_ok = np.ones(x.shape[0], np.float32)
    if masked:
        row_ok[150:] = 0.0
    n = float(row_ok.sum())
    got = gmm._em_steps(*_t(x), n, *_t(row_ok, w0, mu0, var0), 10, 1e-6)
    want = j_em_steps(jnp.asarray(x), jnp.float32(n), *(jnp.asarray(a) for a in (row_ok, w0, mu0, var0)),
                      10, 1e-6)
    for g, w, atol in zip(got, want, (ATOL_W, ATOL_MU, ATOL_VAR)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)
    assert abs(float(got[0].sum()) - 1.0) < 1e-5


def _ref_kmeans_start(x_flat, row_ok, k, kmeans_iters, seed):
    """The reference's k-means++ centres for _gmm_fit's start, as it
    computes them: on the rows with masked ones zeroed."""
    x_flat = x_flat * row_ok[:, None]
    return np.asarray(j_kmeans_fit(jnp.asarray(x_flat), jnp.asarray(row_ok), k, kmeans_iters,
                                   jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("mask_kind", ["dense", "rows", "ragged"])
def test_gmm_fit_from_reference_centres_matches_reference(mask_kind):
    rng = np.random.default_rng(8)
    k, iters, min_var, seed, km_iters = 4, 8, 1e-6, 3, 5
    x = _clustered(rng, 240, 5, k, spread=1.0)
    if mask_kind == "dense":
        n, mask, row_ok, xin = 240.0, None, np.ones(240, np.float32), x
    elif mask_kind == "rows":
        row_ok = (rng.random(240) < 0.75).astype(np.float32)
        n, mask, xin = None, row_ok, x
    else:
        row_ok = (rng.random(240) < 0.75).astype(np.float32)
        n, mask, xin = None, row_ok.reshape(8, 30), x.reshape(8, 30, 5)
    start = _ref_kmeans_start(x, row_ok, k, km_iters, seed)
    got = gmm._gmm_fit(torch.from_numpy(xin), n, None if mask is None else torch.from_numpy(mask), k, iters,
                       min_var, seed, km_iters, init_means=torch.from_numpy(start))
    want = j_gmm_fit(jnp.asarray(xin), None if n is None else jnp.float32(n),
                     None if mask is None else jnp.asarray(mask), k, iters, min_var, seed, km_iters)
    for g, w, atol in zip(got, want, (ATOL_W, ATOL_MU, ATOL_VAR)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def test_gmm_estimator_recovers_components():
    rng = np.random.default_rng(6)
    x = np.concatenate([np.array([4.0, 0.0]) + 0.5 * rng.normal(size=(150, 2)),
                        np.array([-4.0, 0.0]) + 0.5 * rng.normal(size=(150, 2))]).astype(np.float32)
    est = gmm.GaussianMixtureModelEstimator(k=2, max_iterations=30, seed=2)
    model = est.fit_arrays(x, device="cpu")
    np.testing.assert_allclose(np.sort(model.means.numpy()[:, 0]), [-4.0, 4.0], atol=0.3)
    np.testing.assert_allclose(model.weights.numpy(), [0.5, 0.5], atol=0.1)
    r = model.apply_batch(torch.from_numpy(x)).numpy()
    assert np.allclose(r.sum(axis=1), 1.0, atol=1e-4)
    fv = GMMFisherVectorEstimator(2, max_iterations=30, seed=2).fit_arrays(x, device="cpu")
    assert isinstance(fv, FisherVector)
    np.testing.assert_array_equal(fv.gmm.means.numpy(), model.means.numpy())


# ---------------------------------------------------------------- samplers


def _indexed_sets(rng, n, t):
    """(n, t, 2) sets whose rows carry (item, position), and a ragged mask."""
    xs = np.stack(np.meshgrid(np.arange(n), np.arange(t), indexing="ij"), axis=-1).astype(np.float32)
    mask = (rng.random((n, t)) < 0.4).astype(np.float32)
    mask[:, 0] = 1.0  # every item has a valid descriptor
    return xs, mask


def test_column_sampler_draws_valid_descriptors_of_each_item():
    xs, mask = _indexed_sets(np.random.default_rng(9), 12, 30)
    out = ColumnSampler(16, seed=4).apply_arrays(*_t(xs, mask)).numpy()
    assert out.shape == (12 * 16, 2)
    item, pos = out[:, 0].astype(int), out[:, 1].astype(int)
    np.testing.assert_array_equal(item, np.repeat(np.arange(12), 16))
    assert mask[item, pos].all()  # masked-out descriptors are never drawn
    # with replacement, uniform over each item's valid descriptors: every
    # valid position of a 3-descriptor item shows up in 2000 draws
    few = np.zeros((1, 30), np.float32)
    few[0, [2, 11, 29]] = 1.0
    many = ColumnSampler(2000, seed=0).apply_arrays(*_t(xs[:1], few)).numpy()
    counts = np.bincount(many[:, 1].astype(int), minlength=30)
    assert set(np.flatnonzero(counts)) == {2, 11, 29} and counts.min(where=counts > 0, initial=2000) > 500


def test_column_sampler_is_batching_invariant():
    xs, mask = _indexed_sets(np.random.default_rng(10), 20, 25)
    sampler = ColumnSampler(8, seed=11)
    whole = sampler.apply_arrays(*_t(xs, mask)).numpy()
    u = sampler.draws(20)
    parts = [sampler.sample(*_t(xs[lo:hi], mask[lo:hi]), u[lo:hi]).numpy() for lo, hi in ((0, 7), (7, 8), (8, 20))]
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    # item i's draws do not depend on how many items follow it
    np.testing.assert_array_equal(sampler.draws(5).numpy(), u[:5].numpy())
    np.testing.assert_array_equal(sampler.apply_arrays(*_t(xs[:5], mask[:5])).numpy(), whole[:5 * 8])
    assert not np.array_equal(ColumnSampler(8, seed=12).apply_arrays(*_t(xs, mask)).numpy(), whole)


def test_sampler_keeps_the_reference_rows():
    x = np.random.default_rng(12).normal(size=(50, 3)).astype(np.float32)
    want = JSampler(17, seed=5).apply_dataset(Dataset(x)).numpy()  # the true rows, not the mesh padding
    np.testing.assert_array_equal(Sampler(17, seed=5).apply_arrays(x), want)
    np.testing.assert_array_equal(Sampler(17, seed=5).apply_arrays(torch.from_numpy(x)).numpy(), want)


# ---------------------------------------------------------------- block solvers


def _ridge_exact(x, y, lam_n):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    xm, ym = x.mean(0), y.mean(0)
    w = np.linalg.solve((x - xm).T @ (x - xm) + lam_n * np.eye(x.shape[1]), (x - xm).T @ (y - ym))
    return w, ym - xm @ w


def _regression_data():
    """tests/test_solvers.py's fixture."""
    rng = np.random.default_rng(42)
    x = rng.normal(size=(96, 12)).astype(np.float32)
    w_true = rng.normal(size=(12, 3)).astype(np.float32)
    return x, x @ w_true + 0.01 * rng.normal(size=(96, 3)).astype(np.float32)


def test_block_ls_matches_exact_and_reference():
    x, y = _regression_data()
    lam = 0.1
    model = block_ls.BlockLeastSquaresEstimator(block_size=5, num_iter=40, lam=lam).fit_arrays(x, y, device="cpu")
    w_ref, b_ref = _ridge_exact(x, y, lam * x.shape[0])
    np.testing.assert_allclose(model.flat_weights.numpy()[:12], w_ref, atol=ATOL_BCD_EXACT)
    np.testing.assert_allclose(model.intercept.numpy(), b_ref, atol=ATOL_BCD_EXACT)
    np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), x @ w_ref + b_ref, atol=1e-2)
    ref = JBls(block_size=5, num_iter=40, lam=lam).fit_arrays(x, y)
    assert model.weights.shape == ref.weights.shape == (3, 5, 3)
    np.testing.assert_allclose(model.weights.numpy(), np.asarray(ref.weights), atol=ATOL_BCD_REF)
    np.testing.assert_allclose(model.intercept.numpy(), np.asarray(ref.intercept), atol=ATOL_BCD_REF)


def test_block_ls_without_intercept_matches_reference():
    x, y = _regression_data()
    model = block_ls.BlockLeastSquaresEstimator(block_size=8, num_iter=10, lam=0.05,
                                                fit_intercept=False).fit_arrays(x, y, device="cpu")
    ref = JBls(block_size=8, num_iter=10, lam=0.05, fit_intercept=False).fit_arrays(x, y)
    assert model.intercept is None and ref.intercept is None
    np.testing.assert_allclose(model.weights.numpy(), np.asarray(ref.weights), atol=ATOL_BCD_REF)


def _skewed_labels(rng, n, k):
    labels = rng.integers(0, k, size=n)
    labels[: n // 2] = 0  # skew classes
    y = -np.ones((n, k), np.float32)
    y[np.arange(n), labels] = 1.0
    return labels, y


def test_class_weights_match_reference():
    labels, y = _skewed_labels(np.random.default_rng(13), 40, 4)
    y[-3:] = -1.0  # rows with no class (an out-of-range label) count in no class
    for n in (40, 33):  # 33: rows past n are padding and weigh 0
        got = block_weighted_ls.class_weights(torch.from_numpy(y), n, 0.5).numpy()
        np.testing.assert_allclose(got, np.asarray(j_class_weights(jnp.asarray(y), jnp.float32(n), 0.5)),
                                   rtol=1e-6)


def test_block_weighted_ls_matches_direct_weighted_solve_and_reference():
    """tests/test_solvers.py's weighted case, against a float64 direct
    weighted solve and against the reference's sweep."""
    rng = np.random.default_rng(7)
    n, d, k = 64, 8, 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    labels, y = _skewed_labels(rng, n, k)
    lam, mw = 0.05, 0.5
    model = block_weighted_ls.BlockWeightedLeastSquaresEstimator(
        block_size=8, num_iter=30, lam=lam, mixture_weight=mw).fit_arrays(x, y, device="cpu")
    counts = np.bincount(labels, minlength=k)
    alpha = mw * n / (k * counts[labels]) + (1 - mw)
    xm, ym = (alpha @ x) / alpha.sum(), (alpha @ y) / alpha.sum()
    xc, yc = x - xm, y - ym
    w_ref = np.linalg.solve(xc.T @ np.diag(alpha) @ xc + lam * n * np.eye(d), xc.T @ np.diag(alpha) @ yc)
    np.testing.assert_allclose(model.flat_weights.numpy()[:d], w_ref, atol=ATOL_BCD_EXACT)
    np.testing.assert_allclose(model.intercept.numpy(), ym - xm @ w_ref, atol=ATOL_BCD_EXACT)
    ref = JBwls(block_size=8, num_iter=30, lam=lam, mixture_weight=mw).fit_arrays(x, y)
    np.testing.assert_allclose(model.weights.numpy(), np.asarray(ref.weights), atol=ATOL_BCD_REF)
    np.testing.assert_allclose(model.intercept.numpy(), np.asarray(ref.intercept), atol=ATOL_BCD_REF)


def test_block_weighted_ls_padded_blocks_match_reference():
    """d = 12 in blocks of 5: the last block zero-padded, as blockify pads it."""
    x, _ = _regression_data()
    _, y = _skewed_labels(np.random.default_rng(14), 96, 3)
    kw = dict(block_size=5, num_iter=6, lam=0.1, mixture_weight=0.25)
    model = block_weighted_ls.BlockWeightedLeastSquaresEstimator(**kw).fit_arrays(x, y, device="cpu")
    ref = JBwls(**kw).fit_arrays(x, y)
    np.testing.assert_allclose(model.weights.numpy(), np.asarray(ref.weights), atol=ATOL_BCD_REF)
    np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), np.asarray(ref.apply_batch(jnp.asarray(x))),
                               atol=1e-4)


def test_block_weighted_mixture_zero_equals_unweighted():
    x, y = _regression_data()
    yy = (y == y.max(axis=1, keepdims=True)).astype(np.float32) * 2 - 1
    a = block_weighted_ls.BlockWeightedLeastSquaresEstimator(block_size=6, num_iter=25, lam=0.1,
                                                             mixture_weight=0.0).fit_arrays(x, yy, device="cpu")
    b = block_ls.BlockLeastSquaresEstimator(block_size=6, num_iter=25, lam=0.1).fit_arrays(x, yy, device="cpu")
    np.testing.assert_allclose(a.flat_weights.numpy(), b.flat_weights.numpy(), atol=2e-3)


# ---------------------------------------------------------------- evaluators, images


def test_multiclass_evaluator_matches_reference():
    rng = np.random.default_rng(15)
    pred, lab = rng.integers(0, 6, 300), rng.integers(0, 6, 300)
    pred[:40] = lab[:40]
    got = ev.MulticlassClassifierEvaluator(6).evaluate(torch.from_numpy(pred), lab)
    want = jev.MulticlassClassifierEvaluator(6).evaluate(pred, lab)
    np.testing.assert_array_equal(got.confusion_matrix, want.confusion_matrix)
    for f in ("total_error", "macro_precision", "macro_recall", "macro_f1", "micro_f1", "accuracy"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), abs=1e-12), f
    np.testing.assert_allclose(got.per_class_error, want.per_class_error)
    # scores (n, K) are argmaxed, as in the reference
    scores = rng.normal(size=(300, 6))
    assert ev.MulticlassClassifierEvaluator(6).evaluate(scores, lab).total_error == pytest.approx(
        jev.MulticlassClassifierEvaluator(6).evaluate(scores, lab).total_error)


def test_other_evaluators_match_reference():
    rng = np.random.default_rng(16)
    pred, lab = rng.integers(0, 2, 100), rng.integers(0, 2, 100)
    got, want = ev.BinaryClassifierEvaluator().evaluate(pred, lab), jev.BinaryClassifierEvaluator().evaluate(pred, lab)
    assert (got.tp, got.fp, got.tn, got.fn) == (want.tp, want.fp, want.tn, want.fn)
    scores, multi = rng.normal(size=(60, 5)), (rng.random((60, 5)) < 0.3).astype(np.float32)
    assert ev.MeanAveragePrecisionEvaluator(5).evaluate(torch.from_numpy(scores), multi) == pytest.approx(
        jev.MeanAveragePrecisionEvaluator(5).evaluate(scores, multi))
    views, ids, labs = rng.normal(size=(40, 4)), np.repeat(rng.permutation(10), 4), rng.integers(0, 4, 10)
    got = ev.AugmentedExamplesEvaluator(4).evaluate(views, ids, labs)
    want = jev.AugmentedExamplesEvaluator(4).evaluate(views, ids, labs)
    np.testing.assert_array_equal(got.confusion_matrix, want.confusion_matrix)


def test_synthetic_images_match_reference():
    pixels, labels = ImageNetLoader.synthetic_arrays(6, 5, (20, 24), seed=3)
    ref = JLoader.synthetic(6, 5, (20, 24), seed=3)
    np.testing.assert_array_equal(pixels, ref.data.numpy())
    np.testing.assert_array_equal(labels, ref.labels.numpy())
    assert pixels.dtype == np.uint8 and labels.dtype == np.int32


def test_fitted_arrays_are_contiguous():
    """The fused kernel's wrapper takes contiguous arrays only, as the fit hands them over."""
    rng = np.random.default_rng(17)
    x = _anisotropic(rng, 64, 12)
    assert pca.PCAEstimator(4).fit_arrays(x, device="cpu").components.is_contiguous()
    assert pca._pca_masked(torch.from_numpy(x), torch.ones(64), 4, True)[0].is_contiguous()
    model = gmm.GaussianMixtureModelEstimator(3, max_iterations=2).fit_arrays(x, device="cpu")
    assert all(t.is_contiguous() for t in (model.weights, model.means, model.variances))


def test_gmm_stage_seconds_time_the_fit_without_changing_it():
    """``stage_seconds`` gains the k-means and EM seconds, summed over
    calls, and the fit is the one without it."""
    x = _anisotropic(np.random.default_rng(19), 200, 6)
    est = gmm.GaussianMixtureModelEstimator(3, max_iterations=4, seed=1)
    seconds = {}
    timed = est.fit_arrays(x, device="cpu", stage_seconds=seconds)
    assert list(seconds) == ["kmeans", "em"] and min(seconds.values()) > 0
    first = dict(seconds)
    est.fit_arrays(x, device="cpu", stage_seconds=seconds)
    assert all(seconds[k] > first[k] for k in first)
    plain = est.fit_arrays(x, device="cpu")
    for a, b in ((timed.weights, plain.weights), (timed.means, plain.means), (timed.variances, plain.variances)):
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)
