"""The port's ImageNetSiftLcsFV scoring forward against the JAX package,
end to end on the CPU: the fused two-branch scorer against the JAX
transformers chained as the reference's rewritten graph runs them, the
unfused bench forward, and a model fitted by JAX carried across with
``params_from_numpy``."""

import jax.numpy as jnp
import numpy as np
import torch

from keystone_tpu.models.block_ls import BlockLinearMapper as JBlm
from keystone_tpu.models.gmm import GaussianMixtureModel as JGmm
from keystone_tpu.models.pca import PCATransformer as JPca
from keystone_tpu.ops.fisher import FisherVector as JFisherVector
from keystone_tpu.ops.fisher import FusedPcaFisherVector as JFused
from keystone_tpu.ops.images import GrayScaler as JGray
from keystone_tpu.ops.images import PixelScaler as JPixel
from keystone_tpu.ops.lcs import LCSExtractor as JLcs
from keystone_tpu.ops.sift import SIFTExtractor as JSift
from keystone_tpu.ops.stats import NormalizeRows as JNorm
from keystone_tpu.ops.stats import SignedHellingerMapper as JHell
from keystone_tpu.ops.util import TopKClassifier as JTopK
from keystone_tpu_torch.convert import params_from_numpy
from keystone_tpu_torch.ops import fisher_kernels
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as port

CFG = port.Config(sift_step=8, lcs_step=8)
SMALL = dict(pca_dims=16, gmm_k=8, num_classes=10, block_size=64)
# scores are sums over ~10³ FV features of products with 0.01·normal
# weights; f32 summation order differs between the two packages
ATOL_SCORES = 2e-5


def _images(n=4, size=48, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _jax_scorer_chain(p, imgs):
    """The reference scorer as its optimizer rewrites it: SIFT emits raw
    descriptors into FusedPcaFisherVector(sift_normalize=True); the LCS
    branch's PCA → FV pair fuses without the normalize."""

    def a(k):
        return jnp.asarray(p[k])

    def fused(b, sift_normalize):
        return JFused(
            JPca(a(f"{b}.pca.components"), a(f"{b}.pca.mean")),
            JGmm(a(f"{b}.gmm.weights"), a(f"{b}.gmm.means"), a(f"{b}.gmm.variances")),
            sift_normalize=sift_normalize,
        )

    x = JPixel(only_if_integer=True).apply_batch(jnp.asarray(imgs))
    raw, mask = JSift(step=CFG.sift_step, bin_sizes=(CFG.sift_bin_size,), normalize=False).apply_batch(
        JGray().apply_batch(x)
    )
    f_sift = JNorm().apply_batch(JHell().apply_batch(fused("sift", True).apply_batch(raw, mask)))
    desc, mask = JLcs(CFG.lcs_step, CFG.lcs_subpatch).apply_batch(x)
    f_lcs = JNorm().apply_batch(JHell().apply_batch(fused("lcs", False).apply_batch(desc, mask)))
    w = a("blm.weights")
    scores = JBlm(w, w.shape[1]).apply_batch(jnp.concatenate([f_sift, f_lcs], axis=1))
    return np.asarray(scores), np.asarray(JTopK(CFG.top_k).apply_batch(scores))


def test_fused_scorer_matches_jax_rewritten_chain():
    raw = port.random_params(**SMALL)
    imgs = _images()
    want_scores, want_top = _jax_scorer_chain(raw, imgs)
    fisher_kernels.reset_launches()
    scorer = port.build_scorer_from_params(params_from_numpy(raw, device="cpu"), CFG, device="cpu")
    x = torch.from_numpy(imgs)
    scores = port.scores_of(scorer)(x).numpy()
    np.testing.assert_allclose(scores, want_scores, atol=ATOL_SCORES)
    np.testing.assert_array_equal(scorer(x).numpy(), want_top)
    assert not any(fisher_kernels.LAUNCHES.values()), fisher_kernels.LAUNCHES


def test_unfused_forward_matches_jax_bench_chain():
    raw = port.random_params(branches=("sift",), **SMALL)
    imgs = _images().astype(np.float32) / 255.0
    a = {k: jnp.asarray(v) for k, v in raw.items()}
    x = JGray().apply_batch(jnp.asarray(imgs))
    desc, mask = JSift(step=CFG.sift_step, bin_sizes=(CFG.sift_bin_size,)).apply_batch(x)
    desc, mask = JPca(a["sift.pca.components"], a["sift.pca.mean"]).apply_batch(desc, mask=mask)
    gmm = JGmm(a["sift.gmm.weights"], a["sift.gmm.means"], a["sift.gmm.variances"])
    feats = JNorm().apply_batch(JHell().apply_batch(JFisherVector(gmm).apply_batch(desc, mask=mask)))
    want = np.asarray(JBlm(a["blm.weights"], a["blm.weights"].shape[1]).apply_batch(feats))
    fwd = port.build_forward(params_from_numpy(raw, device="cpu"), CFG, device="cpu")
    np.testing.assert_allclose(fwd(torch.from_numpy(imgs)).numpy(), want, atol=ATOL_SCORES)


def _fitted_arrays(fitted):
    """The PCA/GMM/BLM arrays of a fitted JAX scorer, keyed for
    ``params_from_numpy``; the branch is told by the descriptor width."""
    from keystone_tpu.models.block_ls import BlockLinearMapper
    from keystone_tpu.models.pca import PCATransformer
    from keystone_tpu.ops.fisher import FisherVector

    out, pending = {}, None
    g = fitted.graph
    for n in g.topological_nodes():
        t = getattr(g.operators.get(n), "transformer", None)
        if isinstance(t, PCATransformer):
            pending = {128: "sift", 96: "lcs"}[t.components.shape[0]]
            out[f"{pending}.pca.components"] = np.asarray(t.components)
            out[f"{pending}.pca.mean"] = np.asarray(t.mean)
        elif isinstance(t, FisherVector):
            for k in ("weights", "means", "variances"):
                out[f"{pending}.gmm.{k}"] = np.asarray(getattr(t.gmm, k))
        elif isinstance(t, BlockLinearMapper):
            out["blm.weights"] = np.asarray(t.weights)
            if t.intercept is not None:
                out["blm.intercept"] = np.asarray(t.intercept)
            if t.feature_mean is not None:
                out["blm.feature_mean"] = np.asarray(t.feature_mean)
    return out


def test_jax_fitted_model_carried_across():
    from keystone_tpu.loaders.imagenet import ImageNetLoader
    from keystone_tpu.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV

    cfg = Config(
        num_classes=4, synthetic_n=16, image_size=32, gmm_k=8, pca_dims=8,
        gmm_iters=2, num_epochs=1,
    )
    train = ImageNetLoader.synthetic(16, 4, size=(32, 32), seed=1)
    fitted = ImageNetSiftLcsFV.build_scorer(cfg, train.data, train.labels).fit()
    test = ImageNetLoader.synthetic(8, 4, size=(32, 32), seed=2)
    want = fitted(test.data).get().numpy()

    arrays = _fitted_arrays(fitted)
    assert {"sift.gmm.means", "lcs.gmm.means", "blm.intercept"} <= set(arrays)
    pcfg = port.Config(
        sift_step=cfg.sift_step, sift_bin_size=cfg.sift_bin_size,
        lcs_step=cfg.lcs_step, lcs_subpatch=cfg.lcs_subpatch, top_k=cfg.top_k,
    )
    scorer = port.build_scorer_from_params(params_from_numpy(arrays, device="cpu"), pcfg, device="cpu")
    imgs = torch.from_numpy(np.array(test.data.array)[: test.data.n])
    got = port.scores_of(scorer)(imgs).numpy()
    # fitted ridge weights reach ~3 (not 0.01), so f32 sums over the FV
    # width, taken in another order, differ by ~5e-5 on scores of ~1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(
        np.argmax(got, axis=1), np.argmax(want, axis=1)
    )
