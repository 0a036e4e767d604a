"""The port's kernel tier against the JAX package on the CPU: the block
solve, kernel ridge regression (in-core and cached sweeps, every
generator), BlockKernelMatrix, Nyström features, the scaler and heads,
and JAX-fitted KernelTimit and KRR models carried across.  Where the JAX
side can reach its Pallas gram kernels, they run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models import kernel_ridge as jkr
from keystone_tpu.models.common import solve_spd as j_solve_spd
from keystone_tpu.models.kernel_matrix import BlockKernelMatrix as JBlockKernelMatrix
from keystone_tpu.models.nystrom import NystromFeatures as JNystromFeatures
from keystone_tpu.ops import gram_pallas
from keystone_tpu.ops.stats import StandardScaler as JStandardScaler
from keystone_tpu.ops.util import ClassLabelIndicators as JIndicators
from keystone_tpu.ops.util import MaxClassifier as JMax
from keystone_tpu_torch.convert import kernel_timit_params_from_numpy, krr_params_from_numpy
from keystone_tpu_torch.models import kernel_ridge as kr
from keystone_tpu_torch.models.common import solve_spd
from keystone_tpu_torch.models.kernel_matrix import BlockKernelMatrix
from keystone_tpu_torch.models.nystrom import NystromFeatures
from keystone_tpu_torch.ops import gram_kernels
from keystone_tpu_torch.ops.stats import StandardScaler
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.pipelines import kernel_timit as port
from keystone_tpu_torch.workflow import profiling

# dual coefficients: the JAX package's own 2e-5 (tests/test_gram_pallas.py);
# predictions are sums of ~10² kernel-weighted α of order 1
ATOL_ALPHA = 2e-5
ATOL_PRED = 1e-4

GENERATORS = {
    "gaussian": (jkr.GaussianKernelGenerator(0.1), kr.GaussianKernelGenerator(0.1)),
    "polynomial": (jkr.PolynomialKernelGenerator(2, 1 / 8, 1.0), kr.PolynomialKernelGenerator(2, 1 / 8, 1.0)),
    "linear": (jkr.LinearKernelGenerator(), kr.LinearKernelGenerator()),
}


def _problem(n=96, d=8, k=2, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    y = np.tanh(x @ w / np.sqrt(d)).astype(np.float32)
    xt = rng.normal(size=(20, d)).astype(np.float32)
    return x, y, xt


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's gram dispatchers routed to its Pallas kernels in
    interpret mode, as its own tests do; records each call's stream."""
    calls = []
    orig_g, orig_p = gram_pallas.gram_block_pallas, gram_pallas.poly_block_pallas

    def gram(x, z, gamma, interpret=False, mxu="f32"):
        calls.append(("gram", mxu))
        return orig_g(x, z, gamma, interpret=True, mxu=mxu)

    def poly(x, z, alpha, c, degree, interpret=False, mxu="f32"):
        calls.append(("poly", mxu))
        return orig_p(x, z, alpha, c, degree, interpret=True, mxu=mxu)

    monkeypatch.setattr(gram_pallas, "gram_block_pallas", gram)
    monkeypatch.setattr(gram_pallas, "poly_block_pallas", poly)
    monkeypatch.setattr(gram_pallas, "pallas_supported", lambda x=None: True)
    return calls


def test_solve_spd_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(12, 12)).astype(np.float32)
    a = a @ a.T
    b = rng.normal(size=(12, 3)).astype(np.float32)
    want = np.asarray(j_solve_spd(jnp.asarray(a), jnp.asarray(b), reg=0.5))
    got = solve_spd(torch.from_numpy(a), torch.from_numpy(b), reg=0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [96, 90])  # 90: the last block is padded
@pytest.mark.parametrize("cached", [False, True])
def test_krr_gaussian_fit_and_predict_match_jax(n, cached):
    x, y, xt = _problem(n=n)
    kw = dict(lam=1e-3, block_size=32, num_epochs=2, cache_kernel_blocks=cached)
    want = jkr.KernelRidgeRegressionEstimator(jkr.GaussianKernelGenerator(0.1), **kw).fit_arrays(x, y)
    gram_kernels.reset_launches()
    got = kr.KernelRidgeRegressionEstimator(kr.GaussianKernelGenerator(0.1), **kw).fit_arrays(x, y, device="cpu")
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), atol=ATOL_ALPHA)
    np.testing.assert_allclose(got(torch.from_numpy(xt)).numpy(),
                               np.asarray(want.apply_batch(jnp.asarray(xt))), atol=ATOL_PRED)
    assert gram_kernels.LAUNCHES == {"gram_block": 0, "poly_block": 0}


def test_krr_objective_matches_jax():
    rng = np.random.default_rng(6)
    y, f = rng.normal(size=(2, 40, 3)).astype(np.float32)
    want = float(jkr._krr_objective(jnp.asarray(y), jnp.asarray(f), jnp.float32(37)))
    assert float(kr._krr_objective(torch.from_numpy(y), torch.from_numpy(f), 37)) == pytest.approx(want, rel=1e-6)


def test_krr_in_core_and_cached_agree():
    x, y, _ = _problem()
    fits = [
        kr.KernelRidgeRegressionEstimator(kr.GaussianKernelGenerator(0.1), lam=1e-3, block_size=32,
                                          num_epochs=2, cache_kernel_blocks=c).fit_arrays(x, y, device="cpu")
        for c in (False, True)
    ]
    np.testing.assert_allclose(fits[0].alpha.numpy(), fits[1].alpha.numpy(), atol=1e-6)


@pytest.mark.parametrize("which", ["gaussian", "polynomial", "linear"])
def test_krr_cached_fit_matches_jax_through_pallas(pallas_interpret, which):
    """The reference's cached sweep through its Pallas kernels (interpret
    mode, f32 stream) against the port's plain versions."""
    jgen, pgen = GENERATORS[which]
    x, y, _ = _problem()
    # the linear kernel's 32 x 32 blocks have rank d = 8: at λ = 1e-3 the
    # block solve's condition number (~600) lifts the f32 rounding of the
    # two grams to ~1e-4 in α, so that case solves at λ = 1e-2
    lam = 1e-2 if which == "linear" else 1e-3
    kw = dict(lam=lam, block_size=32, num_epochs=2, cache_kernel_blocks=True)
    want = jkr.KernelRidgeRegressionEstimator(jgen, **kw).fit_arrays(x, y)
    assert pallas_interpret and {mxu for _, mxu in pallas_interpret} == {"f32"}
    got = kr.KernelRidgeRegressionEstimator(pgen, **kw).fit_arrays(x, y, device="cpu")
    a = np.asarray(want.alpha)
    # polynomial and linear grams reach |K| ~ 10, so the α solve carries a
    # relative term on top of the reference's absolute 2e-5
    np.testing.assert_allclose(got.alpha.numpy(), a, atol=ATOL_ALPHA, rtol=1e-4)


def test_block_kernel_matrix_matches_jax(pallas_interpret):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    for jgen, pgen in GENERATORS.values():
        for cache_blocks in (16, 2):  # 16 = nb²: whole columns cached; 2: tile LRU
            jm = JBlockKernelMatrix(jgen, jnp.asarray(x), block_size=16, cache_blocks=cache_blocks)
            pm = BlockKernelMatrix(pgen, torch.from_numpy(x), block_size=16, cache_blocks=cache_blocks)
            for j in (1, 1, 3):
                np.testing.assert_allclose(pm.column_block(j).numpy(), np.asarray(jm.column_block(j)),
                                           rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(pm.diag_block(2).numpy(), np.asarray(jm.diag_block(2)),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(pm.block(0, 2).numpy(), np.asarray(jm.block(0, 2)),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(pm.matvec(torch.from_numpy(v)).numpy(),
                                       np.asarray(jm.matvec(jnp.asarray(v))), rtol=1e-5, atol=1e-4)
            assert (pm.cache_hits, pm.cache_misses) == (jm.cache_hits, jm.cache_misses)


def test_nystrom_matches_jax():
    """Same landmark rows; whitening and features at reg 1e-3, large
    enough that K_LL + reg·m·I has a stable eigenbasis at m = 16 (its
    smallest eigenvalue ≥ 0.016, so f32 rounding in the two eigh
    routines moves W by ~1e-5 relative)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(80, 6)).astype(np.float32)
    xt = rng.normal(size=(10, 6)).astype(np.float32)
    want = JNystromFeatures(jkr.GaussianKernelGenerator(0.2), num_landmarks=16, reg=1e-3, seed=3).fit_arrays(x)
    got = NystromFeatures(kr.GaussianKernelGenerator(0.2), num_landmarks=16, reg=1e-3, seed=3).fit_arrays(
        x, device="cpu")
    np.testing.assert_array_equal(got.landmarks.numpy(), np.asarray(want.landmarks))
    np.testing.assert_allclose(got.whiten.numpy(), np.asarray(want.whiten), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got(torch.from_numpy(xt)).numpy(),
                               np.asarray(want.apply_batch(jnp.asarray(xt))), rtol=1e-4, atol=1e-4)


def test_scaler_and_heads_match_jax():
    rng = np.random.default_rng(5)
    x = (30.0 + 0.1 * rng.normal(size=(50, 7))).astype(np.float32)
    x[:, 3] = 2.0  # a constant column: std clamps at eps
    want = JStandardScaler().fit_arrays(x)
    got = StandardScaler().fit_arrays(x, device="cpu")
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-6)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std), rtol=1e-4)
    np.testing.assert_allclose(got(torch.from_numpy(x)).numpy(), np.asarray(want.apply_batch(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)
    scores = rng.normal(size=(9, 5)).astype(np.float32)
    np.testing.assert_array_equal(MaxClassifier()(torch.from_numpy(scores)).numpy(),
                                  np.asarray(JMax().apply_batch(jnp.asarray(scores))))
    labels = rng.integers(0, 5, size=9)
    np.testing.assert_array_equal(ClassLabelIndicators(5)(torch.from_numpy(labels)).numpy(),
                                  np.asarray(JIndicators(5).apply_batch(jnp.asarray(labels))))


def test_jax_fitted_krr_model_carried_across():
    x, y, xt = _problem(n=90)
    want = jkr.KernelRidgeRegressionEstimator(jkr.GaussianKernelGenerator(0.1), lam=1e-3, block_size=32,
                                              num_epochs=2).fit_arrays(x, y)
    p = krr_params_from_numpy({"krr.train_x": np.asarray(want.train_x), "krr.alpha": np.asarray(want.alpha)},
                              device="cpu")
    model = kr.KernelBlockLinearMapper(kr.GaussianKernelGenerator(0.1), p["krr.train_x"], p["krr.alpha"],
                                       block_size=32, train_n=90)
    np.testing.assert_allclose(model(torch.from_numpy(xt)).numpy(),
                               np.asarray(want.apply_batch(jnp.asarray(xt))), atol=ATOL_PRED)


def _kernel_timit_stages(fitted):
    """The fitted JAX KernelTimit scorer's scaler, Nyström map and BLM,
    in order, and their arrays keyed for ``kernel_timit_params_from_numpy``."""
    from keystone_tpu.models.block_ls import BlockLinearMapper
    from keystone_tpu.models.nystrom import NystromFeatureMap
    from keystone_tpu.ops.stats import StandardScalerModel

    stages, out = [], {}
    g = fitted.graph
    ts = [getattr(g.operators.get(n), "transformer", None) for n in g.topological_nodes()]
    # the reference's optimizer fuses the chain into one FusedTransformer
    for t in [s for t in ts for s in getattr(t, "stages", [t])]:
        if isinstance(t, StandardScalerModel):
            out["scaler.mean"] = np.asarray(t.mean)
            if t.std is not None:
                out["scaler.std"] = np.asarray(t.std)
        elif isinstance(t, NystromFeatureMap):
            out["nystrom.landmarks"] = np.asarray(t.landmarks)
            out["nystrom.whiten"] = np.asarray(t.whiten)
        elif isinstance(t, BlockLinearMapper):
            out["blm.weights"] = np.asarray(t.weights)
            if t.intercept is not None:
                out["blm.intercept"] = np.asarray(t.intercept)
            if t.feature_mean is not None:
                out["blm.feature_mean"] = np.asarray(t.feature_mean)
        else:
            continue
        stages.append(t)
    return stages, out


def test_jax_fitted_kernel_timit_carried_across():
    from keystone_tpu.loaders.timit import TimitFeaturesDataLoader
    from keystone_tpu.pipelines.kernel_timit import Config, KernelTimitPipeline

    cfg = Config(num_landmarks=64, synthetic_n=512, num_epochs=2)
    train = TimitFeaturesDataLoader.synthetic(cfg.synthetic_n, cfg.num_classes, seed=1)
    fitted = KernelTimitPipeline.build(cfg, train.data, train.labels).fit()
    test = TimitFeaturesDataLoader.synthetic(64, cfg.num_classes, seed=2)
    frames = np.array(test.data.array)[: test.data.n]
    want = fitted(test.data).get().numpy()[: test.data.n]

    stages, arrays = _kernel_timit_stages(fitted)
    assert len(stages) == 3 and "scaler.std" in arrays
    want_scores = jnp.asarray(frames)
    for t in stages:
        want_scores = t.apply_batch(want_scores)
    scorer = port.build_scorer_from_params(kernel_timit_params_from_numpy(arrays, device="cpu"),
                                           port.Config(gamma=cfg.gamma), device="cpu")
    x = torch.from_numpy(frames)
    # fitted ridge weights over 64 whitened features: scores of order 1,
    # f32 sums in another order
    np.testing.assert_allclose(port.scores_of(scorer)(x).numpy(), np.asarray(want_scores),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(scorer(x).numpy(), want)


def test_device_hbm_budget_cpu_fallback():
    assert profiling.device_hbm_budget() == 8 << 30
    assert profiling.device_hbm_budget(0.25, "cpu") == 4 << 30


def test_kernel_mapper_predicts_with_gaussian_generators_only():
    x, y, xt = _problem()
    model = kr.KernelRidgeRegressionEstimator(kr.PolynomialKernelGenerator(2, 0.1, 1.0), block_size=32,
                                              cache_kernel_blocks=True).fit_arrays(x, y, device="cpu")
    assert model.alpha.shape == (96, 2)
    with pytest.raises(TypeError, match="Gaussian"):
        model(torch.from_numpy(xt))
