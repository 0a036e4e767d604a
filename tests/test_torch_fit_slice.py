"""The port's ImageNetSiftLcsFV fit against the JAX package's, as a
chain, on the CPU.

Each stage of ``fit_params`` takes the reference's output of the stage
before (its sampled descriptor rows, its PCA, its k-means++ centres, its
features), so that the errors of one stage do not compound into the
next; the reference's draws cannot be repeated by the port.  Then the
held-out scores of the two fitted scorers, and the port's
``run_synthetic`` against the reference's ``run`` at the reference
test's config (tests/test_pipelines.py::test_imagenet_sift_lcs_fv_e2e).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models.block_ls import BlockLinearMapper as JBlm
from keystone_tpu.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator as JBwls
from keystone_tpu.models.kmeans import _kmeans_fit as j_kmeans_fit
from keystone_tpu.models.pca import PCAEstimator as JPCAEstimator
from keystone_tpu.ops.fisher import FisherVector as JFisherVector
from keystone_tpu.ops.fisher import GMMFisherVectorEstimator as JGmmFv
from keystone_tpu.ops.images import GrayScaler as JGray
from keystone_tpu.ops.images import PixelScaler as JPixel
from keystone_tpu.ops.lcs import LCSExtractor as JLcs
from keystone_tpu.ops.sift import SIFTExtractor as JSift
from keystone_tpu.ops.stats import ColumnSampler as JColumnSampler
from keystone_tpu.ops.stats import NormalizeRows as JNorm
from keystone_tpu.ops.stats import SignedHellingerMapper as JHell
from keystone_tpu.ops.util import ClassLabelIndicators as JLabels
from keystone_tpu.ops.util import TopKClassifier as JTopK
from keystone_tpu.pipelines.imagenet_sift_lcs_fv import ImageNetSiftLcsFV
from keystone_tpu.workflow import Dataset
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.models.gmm import GaussianMixtureModelEstimator, _gmm_fit
from keystone_tpu_torch.models.pca import PCAEstimator
from keystone_tpu_torch.ops.util import ClassLabelIndicators
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as port
from keystone_tpu_torch.workflow.optimizer import FusedTransformer

# tests/test_pipelines.py::test_imagenet_sift_lcs_fv_e2e's config
FIELDS = dict(num_classes=4, gmm_k=4, gmm_iters=4, pca_dims=16, descriptor_samples_per_image=32,
              solver_block_size=512, synthetic_n=48, image_size=48, sift_step=8, lcs_step=8)
CFG = port.Config(**FIELDS)
SIZE = (CFG.image_size, CFG.image_size)

# the PCA projector C·Cᵀ of f32 SVDs in two libraries (the components
# themselves may turn by rounding where singular values lie close)
ATOL_PROJECTOR = 1e-5
# EM from the same start: the reference's own EM tolerances (tests/test_native.py)
ATOL_W, ATOL_MU, ATOL_VAR = 2e-5, 2e-4, 2e-4
# Fisher vectors before the power normalization, held against the FV of
# the same vocabulary in float64: the port's largest error at most twice
# the reference's (f32-grade, chip_smoke.py's criterion) or within the
# reference's own fused tolerance (tests/test_pallas.py).  Here entries
# reach ~6 (few descriptors an image), so two f32 chains differ by more
# than that tolerance from each other; the features after
# SignedHellinger are not held elementwise (√ turns an error δ at an
# entry near 0 into √δ), the held-out scores carry them.
F64_RATIO, ATOL_FV = 2.0, 3e-5
# the solve: 48 rows in a 256-wide block at λn = 0.0048 amplifies f32
# rounding of the Gramian; held on its predictions, whose scale is ±1
ATOL_SCORES = 1e-3
# run_synthetic against the reference's run: the draws differ, so the
# fitted models do; 12 test images, a margin of 3 of them
TOP1_MARGIN = 0.25


@pytest.fixture(scope="module")
def data():
    return ImageNetLoader.synthetic_arrays(CFG.synthetic_n, CFG.num_classes, SIZE, seed=1), \
        ImageNetLoader.synthetic_arrays(max(8, CFG.synthetic_n // 4), CFG.num_classes, SIZE, seed=2)


def _j_descriptors(imgs):
    """The reference's normalized descriptors of both branches: {b: (desc, mask)}."""
    x = JPixel(only_if_integer=True).apply_batch(jnp.asarray(imgs))
    sift = JSift(step=CFG.sift_step, bin_sizes=(CFG.sift_bin_size,)).apply_batch(JGray().apply_batch(x))
    return {"sift": sift, "lcs": JLcs(CFG.lcs_step, CFG.lcs_subpatch).apply_batch(x)}


def _j_sample(desc, mask, seed):
    out = JColumnSampler(CFG.descriptor_samples_per_image, seed=seed).apply_dataset(Dataset(desc, mask=mask))
    return np.array(out.numpy())


def _j_fisher_vectors(imgs, vocab):
    """The reference's Fisher vectors of each branch: {b: PCA → FV}."""
    out = {}
    for b, (desc, mask) in _j_descriptors(imgs).items():
        pca, fv = vocab[b]
        out[b] = np.asarray(fv.apply_batch(*pca.apply_batch(desc, mask)))
    return out


def _fv64(imgs, vocab):
    """Each branch's FV in float64 from the reference's descriptors, by
    the definition: Φ¹ = Σ_t γ (x−μ)/σ / (T√w), Φ² = Σ_t γ ((x−μ)²/σ² − 1) / (T√(2w))."""
    out = {}
    for b, (desc, mask) in _j_descriptors(imgs).items():
        pca, fv = vocab[b]
        g = fv.gmm
        w, mu, var = (np.asarray(a, np.float64) for a in (g.weights, g.means, g.variances))
        x = (np.asarray(desc, np.float64) - np.asarray(pca.mean, np.float64)) @ np.asarray(pca.components, np.float64)
        m = np.asarray(mask, np.float64)
        u = (x[:, :, None, :] - mu) / np.sqrt(var)  # (n, T, K, d)
        lg = np.log(w) - 0.5 * (np.log(var).sum(1) + x.shape[-1] * np.log(2 * np.pi)) - 0.5 * (u * u).sum(-1)
        gam = np.exp(lg - lg.max(-1, keepdims=True))
        gam = gam / gam.sum(-1, keepdims=True) * m[..., None]
        tn = np.maximum(m.sum(1), 1.0)[:, None, None]
        phi1 = np.einsum("ntk,ntkd->nkd", gam, u) / (tn * np.sqrt(w)[:, None])
        phi2 = np.einsum("ntk,ntkd->nkd", gam, u * u - 1.0) / (tn * np.sqrt(2 * w)[:, None])
        out[b] = np.concatenate([phi1.reshape(len(x), -1), phi2.reshape(len(x), -1)], axis=1)
    return out


def _j_features(imgs, vocab):
    """The reference's features: each branch's FV → SignedHellinger →
    NormalizeRows, gathered."""
    parts = [JNorm().apply_batch(JHell().apply_batch(jnp.asarray(f)))
             for f in _j_fisher_vectors(imgs, vocab).values()]
    return np.concatenate([np.asarray(p) for p in parts], axis=1)


def _fisher_vectors(params, imgs):
    """The port featurizer's Fisher vectors of each branch: its branch
    pipelines without their last two stages (SignedHellinger, NormalizeRows)."""
    scaler, gather = port.build_featurizer(params, CFG, "cpu").stages
    x = scaler(torch.from_numpy(imgs))
    return {b: FusedTransformer(list(branch.stages)[:-2])(x).numpy() for b, branch in zip(("sift", "lcs"), gather.branches)}


@pytest.fixture(scope="module")
def chain(data):
    """The reference's fit, stage by stage, and the port's stages, each
    fed the reference's output of the stage before."""
    (train_x, train_y), _ = data
    seeds = port._branch_seeds(CFG)
    desc = _j_descriptors(train_x)
    ref_vocab, out = {}, {"pca": {}, "gmm": {}}
    params = {}
    for b, (d, m) in desc.items():
        s = seeds[b]
        rows = _j_sample(d, m, s)
        jpca = JPCAEstimator(CFG.pca_dims, center=True).fit_arrays(rows)
        pca = PCAEstimator(CFG.pca_dims, center=True).fit_arrays(rows, device="cpu")
        out["pca"][b] = (pca, jpca)
        z = _j_sample(*jpca.apply_batch(d, m), s + 1)
        jfv = JGmmFv(CFG.gmm_k, max_iterations=CFG.gmm_iters, seed=s).fit_arrays(z)
        g = GaussianMixtureModelEstimator(CFG.gmm_k, max_iterations=CFG.gmm_iters, seed=s)
        start = j_kmeans_fit(jnp.asarray(z), jnp.ones(z.shape[0]), g.k, g.kmeans_iters, jax.random.PRNGKey(s))
        gmm = _gmm_fit(torch.from_numpy(z), z.shape[0], None, g.k, g.max_iterations, g.min_variance, g.seed,
                       g.kmeans_iters, init_means=torch.from_numpy(np.array(start)))
        out["gmm"][b] = (gmm, jfv.gmm)
        ref_vocab[b] = (jpca, jfv)
        params.update({f"{b}.pca.components": torch.from_numpy(np.array(jpca.components)),
                       f"{b}.pca.mean": torch.from_numpy(np.array(jpca.mean)),
                       f"{b}.gmm.weights": torch.from_numpy(np.array(jfv.gmm.weights)),
                       f"{b}.gmm.means": torch.from_numpy(np.array(jfv.gmm.means)),
                       f"{b}.gmm.variances": torch.from_numpy(np.array(jfv.gmm.variances))})
    ref_feats = _j_features(train_x, ref_vocab)
    out["fv"] = (_fisher_vectors(params, train_x), _j_fisher_vectors(train_x, ref_vocab), _fv64(train_x, ref_vocab))
    out["features"] = (port.featurize(params, CFG, train_x, "cpu", batch_size=20).numpy(), ref_feats)
    y = ClassLabelIndicators(CFG.num_classes)(torch.from_numpy(train_y))
    blm = BlockWeightedLeastSquaresEstimator(
        block_size=CFG.solver_block_size, num_iter=CFG.num_epochs, lam=CFG.lam,
        mixture_weight=CFG.mixture_weight).fit_arrays(ref_feats, y, device="cpu")
    jblm = JBwls(block_size=CFG.solver_block_size, num_iter=CFG.num_epochs, lam=CFG.lam,
                 mixture_weight=CFG.mixture_weight).fit_arrays(
        ref_feats, JLabels(CFG.num_classes).apply_batch(jnp.asarray(train_y)))
    out["blm"] = (blm, jblm)
    params.update({"blm.weights": blm.weights, "blm.intercept": blm.intercept})
    out["params"], out["ref_vocab"] = params, ref_vocab
    return out


@pytest.mark.parametrize("branch", ["sift", "lcs"])
def test_pca_stage_matches_reference(chain, branch):
    pca, jpca = chain["pca"][branch]
    c, jc = pca.components.numpy(), np.asarray(jpca.components)
    assert c.shape == jc.shape == ({"sift": 128, "lcs": 96}[branch], CFG.pca_dims)
    np.testing.assert_allclose(c @ c.T, jc @ jc.T, atol=ATOL_PROJECTOR)
    np.testing.assert_allclose(pca.mean.numpy(), np.asarray(jpca.mean), atol=1e-6)


@pytest.mark.parametrize("branch", ["sift", "lcs"])
def test_gmm_stage_from_reference_centres_matches_reference(chain, branch):
    got, want = chain["gmm"][branch]
    for g, w, atol in zip(got, (want.weights, want.means, want.variances), (ATOL_W, ATOL_MU, ATOL_VAR)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


@pytest.mark.parametrize("branch", ["sift", "lcs"])
def test_featurize_stage_matches_reference(chain, branch):
    got, ref, exact = (fv[branch] for fv in chain["fv"])
    assert got.shape == ref.shape == exact.shape == (CFG.synthetic_n, 2 * CFG.gmm_k * CFG.pca_dims)
    err, ref_err = np.abs(got - exact).max(), np.abs(ref - exact).max()
    assert err <= max(F64_RATIO * ref_err, ATOL_FV), (err, ref_err)
    feats, _ = chain["features"]
    assert feats.shape == (CFG.synthetic_n, 2 * got.shape[1])


def test_solve_stage_matches_reference(chain):
    blm, jblm = chain["blm"]
    assert blm.weights.shape == jblm.weights.shape == (1, CFG.solver_block_size, CFG.num_classes)
    feats = chain["features"][1]
    np.testing.assert_allclose(blm(torch.from_numpy(feats)).numpy(), np.asarray(jblm.apply_batch(jnp.asarray(feats))),
                               atol=ATOL_SCORES)


def test_held_out_scores_match_reference(chain, data):
    """The port's scorer on the fitted params (reference vocabulary, the
    port's solve) against the reference's fitted chain, on the test set."""
    _, (test_x, test_y) = data
    scorer = port.build_scorer_from_params(chain["params"], CFG, "cpu")
    got = port.scores_of(scorer)(torch.from_numpy(test_x)).numpy()
    _, jblm = chain["blm"]
    want = np.asarray(jblm.apply_batch(jnp.asarray(_j_features(test_x, chain["ref_vocab"]))))
    np.testing.assert_allclose(got, want, atol=ATOL_SCORES)
    np.testing.assert_array_equal(scorer(torch.from_numpy(test_x)).numpy()[:, 0],
                                  np.asarray(JTopK(CFG.top_k).apply_batch(jnp.asarray(want)))[:, 0])


def test_fit_params_stages_and_keys(data):
    (train_x, train_y), _ = data
    seconds = {}
    params = port.fit_params(CFG, train_x, train_y, device="cpu", batch_size=20, stage_seconds=seconds)
    assert list(seconds) == ["sample", "pca", "kmeans", "em", "featurize", "solve"]
    d, k = CFG.pca_dims, CFG.gmm_k
    for b, d_in in (("sift", 128), ("lcs", 96)):
        assert params[f"{b}.pca.components"].shape == (d_in, d)
        assert params[f"{b}.gmm.means"].shape == params[f"{b}.gmm.variances"].shape == (k, d)
        assert float(params[f"{b}.gmm.weights"].sum()) == pytest.approx(1.0, abs=1e-5)
    assert params["blm.weights"].shape == (1, CFG.solver_block_size, CFG.num_classes)
    # the same seed and batches of another size: the same fit
    again = port.fit_params(CFG, train_x, train_y, device="cpu", batch_size=48)
    for key, v in params.items():
        torch.testing.assert_close(again[key], v, atol=1e-6, rtol=1e-5)


def test_sampled_rows_are_normalized_sift_descriptors(data):
    """The PCA is fitted on normalized SIFT rows, normalized once: each
    sampled row is a descriptor the reference's normalizing extractor gives."""
    (train_x, _), _ = data
    rows = port.sample_descriptors(CFG, train_x[:4], "cpu")
    desc, mask = _j_descriptors(train_x[:4])["sift"]
    valid = np.asarray(desc)[np.asarray(mask) > 0]
    for r in rows["sift"][0].numpy()[:: 7]:
        assert np.min(np.abs(valid - r).max(axis=1)) < 1e-5
    norms = np.linalg.norm(rows["sift"][0].numpy(), axis=1)
    np.testing.assert_allclose(norms[norms > 0], 1.0, atol=1e-5)


def test_run_synthetic_matches_reference_run():
    got = port.run_synthetic(CFG, device="cpu")
    want = ImageNetSiftLcsFV.run(ImageNetSiftLcsFV.Config(**FIELDS))
    assert got["accuracy"] > 0.5, got
    assert got["top5_error"] <= got["top1_error"] + 1e-9, got
    assert abs(got["top1_error"] - want["top1_error"]) <= TOP1_MARGIN, (got, want)
