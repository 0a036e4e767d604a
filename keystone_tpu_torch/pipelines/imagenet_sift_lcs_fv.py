"""ImageNetSiftLcsFV — the north-star workload (counterpart of
``keystone_tpu/pipelines/imagenet_sift_lcs_fv.py`` and of
``bench.py::build_forward``; reference
pipelines/images/imagenet/ImageNetSiftLcsFV.scala).

Two branches over the input images:

  SIFT: GrayScaler → dense SIFT → [PCA fit on sampled descriptors] →
        [GMM fit on sampled projected descriptors] → FisherVector →
        SignedHellinger → NormalizeRows
  LCS:  LCSExtractor → the same PCA/GMM/FV tail

gathered → BlockWeightedLeastSquares → TopKClassifier; top-k error by
MulticlassClassifierEvaluator, or over ten views an image by
AugmentedExamplesEvaluator.

``ImageNetSiftLcsFV`` builds it as the reference does, as a workflow
graph: the PCA and GMM vocabulary fits happen inside the graph on
ColumnSampler-reduced descriptor sets rooted at the training Dataset, CSE
merges the shared SIFT/LCS prefixes so the training set is featurized
once, ``Pipeline.fit`` substitutes the fitted transformers, and the
scoring pass's optimizer rewrites each PCA → FV pair into the fused
kernel's node (``FvFusionRule``).  On the card the fit's featurization of
the training set launches B2 (each branch's FisherVector) and scoring B1.

Beside it, the same model from arrays, without the graph:
``build_scorer_from_params`` builds the fitted scorer as the reference
runs it after its optimizer's fusion rule (each PCA → FV pair one fused
kernel, the SIFT normalize in it); ``build_forward`` is the unfused
single-branch program ``bench.py`` measures, with the plain FV kernel;
``fit_params`` fits the scorer's arrays, doing in order what the graph
does (per branch a ColumnSampler of the descriptors → PCA, a
ColumnSampler of the projected descriptors → GMM; the training set's
Fisher vectors through the scorer's featurizer, B1 on the card; then
ClassLabelIndicators → the class-weighted block least-squares solve),
and ``run_synthetic`` scores with it.  These are eager chains
(``FusedTransformer``, ``GatherTransformer``) with no graph to optimize
a batch at a time.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from keystone_tpu_torch.evaluation import AugmentedExamplesEvaluator, MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.models.block_ls import BlockLinearMapper
from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.models.gmm import GaussianMixtureModel, GaussianMixtureModelEstimator
from keystone_tpu_torch.models.pca import PCAEstimator, PCATransformer
from keystone_tpu_torch.ops.fisher import FisherVector, FusedPcaFisherVector, GMMFisherVectorEstimator
from keystone_tpu_torch.ops.images import CenterCornerPatcher, GrayScaler, PixelScaler
from keystone_tpu_torch.ops.lcs import LCSExtractor
from keystone_tpu_torch.ops.sift import SIFTExtractor, _sift_normalize
from keystone_tpu_torch.ops.stats import ColumnSampler, NormalizeRows, SignedHellingerMapper
from keystone_tpu_torch.ops.util import ClassLabelIndicators, TopKClassifier
from keystone_tpu_torch.parallel import require_one_rank
from keystone_tpu_torch.utils import precision, timing
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.optimizer import FusedTransformer
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline, fit_relevant_config
from keystone_tpu_torch.workflow.transformer import GatherTransformer

#: descriptor widths: SIFT 4·4·8, LCS 2·C·16 for RGB images
SIFT_DIM = 128
LCS_DIM = 96

#: each branch's sampler and k-means++ seed, from ``Config.seed``
BRANCH_SEED_OFFSET = {"sift": 0, "lcs": 100}


@dataclasses.dataclass
class Config:
    """The reference Config's fields, with its defaults.  A fitted
    scorer's widths come from its arrays; the fit reads the rest."""

    train_path: Optional[str] = None
    test_path: Optional[str] = None
    num_classes: int = 16
    sift_step: int = 6
    sift_bin_size: int = 4
    lcs_step: int = 6
    lcs_subpatch: int = 6
    pca_dims: int = 64
    gmm_k: int = 16
    gmm_iters: int = 10
    descriptor_samples_per_image: int = 64
    lam: float = 1e-4
    mixture_weight: float = 0.25
    solver_block_size: int = 4096
    num_epochs: int = 2
    top_k: int = 5
    seed: int = 0
    synthetic_n: int = 64
    image_size: int = 64
    # the reference's 10-view test-time augmentation (center + corners ×
    # flips, AugmentedExamplesEvaluator); view_patch=0 → ⅞ of image_size
    augmented_eval: bool = False
    view_patch: int = 0
    # persist/reuse the fitted pipeline (the config is saved alongside
    # and checked on load)
    model_path: Optional[str] = None
    # out-of-core: the training images as a StreamDataset (tar shards, or
    # the synthetic set, re-made on a producer thread each sweep), so that
    # the features spill to a FeatureBlockStore instead of device memory
    stream: bool = False
    stream_batch_size: int = 64
    # the port's operations layer: the solver's per-epoch checkpoint (a
    # killed fit resumes from it) and the streamed training set's
    # per-batch retries; where and how, not what, so no refit follows
    checkpoint_dir: Optional[str] = None
    stream_retries: int = 0


def _gmm(p, b) -> GaussianMixtureModel:
    return GaussianMixtureModel(
        p[f"{b}.gmm.weights"], p[f"{b}.gmm.means"], p[f"{b}.gmm.variances"]
    )


def _pca(p, b) -> PCATransformer:
    return PCATransformer(p[f"{b}.pca.components"], p.get(f"{b}.pca.mean"))


def _blm(p) -> BlockLinearMapper:
    w = p["blm.weights"]
    return BlockLinearMapper(w, w.shape[1], p.get("blm.intercept"), p.get("blm.feature_mean"))


def _fv_tail(base: FusedTransformer, p, b, sift_normalize: bool, use_kernel: Optional[bool]) -> FusedTransformer:
    """descriptor extractor chain → fused PCA/FV → normalization."""
    fused = FusedPcaFisherVector(_pca(p, b), _gmm(p, b), sift_normalize, use_kernel)
    return FusedTransformer([*base.stages, fused, SignedHellingerMapper(), NormalizeRows()])


def _bases(config: Config) -> Dict[str, FusedTransformer]:
    """Each branch's descriptor extractor over [0, 1] images.  SIFT emits
    raw descriptors: the fused kernel normalizes them (and the fit's
    sampler normalizes its rows), so they are normalized once."""
    return {
        "sift": FusedTransformer([
            GrayScaler(), SIFTExtractor(config.sift_step, (config.sift_bin_size,), normalize=False)]),
        "lcs": FusedTransformer([LCSExtractor(config.lcs_step, config.lcs_subpatch)]),
    }


def _featurizer_stages(params, config: Config, use_kernel: Optional[bool]):
    for b in ("sift", "lcs"):
        if f"{b}.pca.components" not in params:
            raise ValueError(f"the featurizer needs the {b} branch's parameters")
    bases = _bases(config)
    branches = GatherTransformer([
        _fv_tail(bases["sift"], params, "sift", True, use_kernel),
        _fv_tail(bases["lcs"], params, "lcs", False, use_kernel),
    ])
    # both reference branches start with the same PixelScaler (merged by
    # its optimizer's CSE): here it runs once, before the branches
    return [PixelScaler(only_if_integer=True), branches]


def build_featurizer(
    params: Dict[str, torch.Tensor],
    config: Config = Config(),
    device="cuda",
    use_kernel: Optional[bool] = None,
) -> FusedTransformer:
    """Images → the (n, 2·2·K·d) Fisher-vector features the linear
    scorer reads: the scorer without its BLM and TopK, and the fit's
    featurizer of the training set.  ``params`` needs both branches."""
    dev = resolve_device(device)
    precision.disable_tf32()
    return FusedTransformer(_featurizer_stages(params, config, use_kernel)).to(dev).eval()


def build_scorer_from_params(
    params: Dict[str, torch.Tensor],
    config: Config = Config(),
    device="cuda",
    use_kernel: Optional[bool] = None,
) -> FusedTransformer:
    """The fitted two-branch scorer, ending in TopK(config.top_k) class ids.

    ``params`` as ``convert.params_from_numpy`` or ``fit_params`` return
    them, with both branches.  ``use_kernel=False`` runs the plain
    per-stage chain in place of the fused kernels (the comparison on the
    card)."""
    dev = resolve_device(device)
    precision.disable_tf32()
    stages = _featurizer_stages(params, config, use_kernel)
    scorer = FusedTransformer([*stages, _blm(params), TopKClassifier(config.top_k)])
    return scorer.to(dev).eval()


def build_forward(
    params: Dict[str, torch.Tensor],
    config: Config = Config(),
    device="cuda",
    use_kernel: Optional[bool] = None,
) -> FusedTransformer:
    """The unfused bench forward: GrayScaler → SIFT → PCA → FisherVector
    → SignedHellinger → NormalizeRows → BlockLinearMapper, raw scores.
    ``params`` needs the ``sift`` branch and a BLM of its FV width."""
    dev = resolve_device(device)
    precision.disable_tf32()
    fwd = FusedTransformer([
        GrayScaler(),
        SIFTExtractor(config.sift_step, (config.sift_bin_size,)),
        _pca(params, "sift"),
        FisherVector(_gmm(params, "sift"), use_kernel),
        SignedHellingerMapper(),
        NormalizeRows(),
        _blm(params),
    ])
    return fwd.to(dev).eval()


def scorer_pipeline(params: Dict[str, torch.Tensor], config: Config = Config()) -> FittedPipeline:
    """The fitted two-branch scorer as a workflow graph ending at raw class
    scores, each stage a node: PixelScaler → gather(GrayScaler → SIFT →
    PCA → FisherVector → SignedHellinger → NormalizeRows, LCS → PCA → …)
    → BlockLinearMapper, the graph ``ImageNetSiftLcsFV.build_scorer``'s fit
    gives.  Freezing it for the card fuses each PCA → FV pair into the
    fused kernel's node (``FvFusionRule``); the gather is the featurizer's
    one output, the prefix co-served tenants share (``serve/tenants.py``).
    ``params`` as for :func:`build_scorer_from_params`; the stages hold
    them where they are."""
    precision.disable_tf32()

    def branch(base: Pipeline, b: str) -> Pipeline:
        return (base.and_then(_pca(params, b)).and_then(FisherVector(_gmm(params, b)))
                .and_then(SignedHellingerMapper()).and_then(NormalizeRows()))

    sift = Pipeline.of(PixelScaler(only_if_integer=True)).and_then(GrayScaler()).and_then(
        SIFTExtractor(step=config.sift_step, bin_sizes=(config.sift_bin_size,)))
    lcs = Pipeline.of(PixelScaler(only_if_integer=True)).and_then(
        LCSExtractor(step=config.lcs_step, subpatch_size=config.lcs_subpatch))
    return Pipeline.gather([branch(sift, "sift"), branch(lcs, "lcs")]).and_then(_blm(params)).fit()


def scores_of(scorer: FusedTransformer) -> FusedTransformer:
    """The scorer without its TopK head: raw class scores."""
    return FusedTransformer(list(scorer.stages)[:-1])


def random_params(
    branches: Sequence[str] = ("sift", "lcs"),
    pca_dims: int = 64,
    gmm_k: int = 256,
    num_classes: int = 1000,
    block_size: int = 4096,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Seeded weights made the way ``bench.py::build_forward`` makes them:
    QR PCA basis with a zero mean, uniform mixture weights, normal means,
    unit variances, 0.01·normal BLM weights (block_size columns a block).
    Numpy arrays under ``convert.params_from_numpy``'s keys."""
    rng = np.random.default_rng(seed)
    dims = {"sift": SIFT_DIM, "lcs": LCS_DIM}
    out = {}
    for b in branches:
        d_in = dims[b]
        out[f"{b}.pca.components"] = np.linalg.qr(rng.normal(size=(d_in, pca_dims)))[0]
        out[f"{b}.pca.mean"] = np.zeros((d_in,), np.float32)
        out[f"{b}.gmm.weights"] = np.full((gmm_k,), 1.0 / gmm_k, np.float32)
        out[f"{b}.gmm.means"] = rng.normal(size=(gmm_k, pca_dims))
        out[f"{b}.gmm.variances"] = np.ones((gmm_k, pca_dims), np.float32)
    fv_dim = 2 * gmm_k * pca_dims * len(branches)
    nb = -(-fv_dim // block_size)
    out["blm.weights"] = 0.01 * rng.normal(size=(nb, block_size, num_classes))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


# ---------------------------------------------------------------- the fit


def _branch_seeds(config: Config) -> Dict[str, int]:
    return {b: config.seed + off for b, off in BRANCH_SEED_OFFSET.items()}


def _batches(images, size: int):
    for lo in range(0, images.shape[0], size):
        yield lo, images[lo:lo + size]


def sample_descriptors(config: Config, images, device="cuda", batch_size: int = 128):
    """Per branch, the descriptor rows the PCA fit (sampler seed s) and
    the GMM fit (seed s + 1) take: ``{branch: (pca_rows, gmm_rows)}``,
    each (n·descriptor_samples_per_image, d_in), SIFT rows normalized.
    A descriptor's projection is its own, so the GMM's sample of the
    projected descriptors is the projection of these rows.  Images go to
    the device ``batch_size`` at a time, and only the sampled rows stay."""
    dev = resolve_device(device)
    images = torch.as_tensor(images)
    n = images.shape[0]
    k = config.descriptor_samples_per_image
    samplers = {b: (ColumnSampler(k, seed=s), ColumnSampler(k, seed=s + 1))
                for b, s in _branch_seeds(config).items()}
    draws = {b: [sm.draws(n).to(dev) for sm in pair] for b, pair in samplers.items()}
    bases = {b: base.to(dev) for b, base in _bases(config).items()}
    scaler = PixelScaler(only_if_integer=True)
    parts = {b: ([], []) for b in bases}
    for lo, batch in _batches(images, batch_size):
        xf = scaler(batch.to(dev))
        for b, base in bases.items():
            desc, mask = base(xf)
            for i, sampler in enumerate(samplers[b]):
                parts[b][i].append(sampler.sample(desc, mask, draws[b][i][lo:lo + batch.shape[0]]))
    rows = {b: tuple(torch.cat(p) for p in pair) for b, pair in parts.items()}
    rows["sift"] = tuple(_sift_normalize(r) for r in rows["sift"])
    return rows


def featurize(params, config: Config, images, device="cuda", use_kernel: Optional[bool] = None,
              batch_size: int = 128) -> torch.Tensor:
    """(n, D) features of ``images`` by ``build_featurizer``, ``batch_size``
    images a call (a call launches B1 once a branch on the card)."""
    dev = resolve_device(device)
    feat = build_featurizer(params, config, dev, use_kernel)
    images = torch.as_tensor(images)
    return torch.cat([feat(batch.to(dev)) for _, batch in _batches(images, batch_size)])


def fit_params(
    config: Config,
    images,
    labels,
    device="cuda",
    use_kernel: Optional[bool] = None,
    batch_size: int = 128,
    stage_seconds: Optional[Dict[str, float]] = None,
) -> Dict[str, torch.Tensor]:
    """Fit the scorer's arrays from ``images`` (n, H, W, 3), uint8 or
    [0, 1] floats, and int ``labels`` (n,): the ``params`` dict, under
    ``convert.params_from_numpy``'s keys, that ``build_scorer_from_params``
    scores with.  Computes in f32 on ``device`` (TF32 off); the draws come
    from generators seeded by ``config.seed``, so a fit repeats on one
    device.  ``use_kernel`` is the featurizer's (``False``: the plain
    chain).  ``stage_seconds``, when given, receives each stage's seconds,
    each ended by a device synchronize: sample, pca, kmeans, em (both
    branches' GMM fits), featurize, solve."""
    dev = resolve_device(device)
    precision.disable_tf32()

    def stage(name):
        return timing.stage(stage_seconds, name, dev)

    with stage("sample"):
        rows = sample_descriptors(config, images, dev, batch_size)
    with stage("pca"):
        pcas = {b: PCAEstimator(config.pca_dims, center=True).fit_arrays(pca_rows, device=dev)
                for b, (pca_rows, _) in rows.items()}
    params = {}
    for b, s in _branch_seeds(config).items():
        gmm = GaussianMixtureModelEstimator(config.gmm_k, max_iterations=config.gmm_iters, seed=s).fit_arrays(
            pcas[b](rows[b][1]), device=dev, stage_seconds=stage_seconds)
        params.update({f"{b}.pca.components": pcas[b].components, f"{b}.pca.mean": pcas[b].mean,
                       f"{b}.gmm.weights": gmm.weights, f"{b}.gmm.means": gmm.means,
                       f"{b}.gmm.variances": gmm.variances})
    with stage("featurize"):
        feats = featurize(params, config, images, dev, use_kernel, batch_size)
    with stage("solve"):
        y = ClassLabelIndicators(config.num_classes)(torch.as_tensor(labels).to(dev))
        blm = BlockWeightedLeastSquaresEstimator(
            block_size=config.solver_block_size, num_iter=config.num_epochs, lam=config.lam,
            mixture_weight=config.mixture_weight,
        ).fit_arrays(feats, y, device=dev)
    params["blm.weights"] = blm.weights
    params["blm.intercept"] = blm.intercept
    return params


#: what ``run_synthetic`` refuses: the array fit has no graph to save or
#: to score views with; ``ImageNetSiftLcsFV.run`` takes both
_NOT_PORTED = {
    "augmented_eval": "the 10-view evaluation runs through the workflow graph: ImageNetSiftLcsFV.run (ROADMAP A3)",
    "model_path": "saving and loading a fitted pipeline runs through the workflow graph: ImageNetSiftLcsFV.run "
                  "(ROADMAP A3)",
    "stream": "the streamed fit runs through the workflow graph: ImageNetSiftLcsFV.run (ROADMAP A3)",
}


def predict_top_k(scorer: FusedTransformer, images, device="cuda", batch_size: int = 128) -> np.ndarray:
    """(n, top_k) class ids of ``images`` by ``scorer``, batch by batch."""
    dev = resolve_device(device)
    images = torch.as_tensor(images)
    return torch.cat([scorer(batch.to(dev)) for _, batch in _batches(images, batch_size)]).cpu().numpy()


def run_synthetic(config: Config, device="cuda", use_kernel: Optional[bool] = None,
                  batch_size: int = 128) -> dict:
    """The reference's ``run`` on synthetic images: fit on
    ``config.synthetic_n`` training images (seed 1), then the top-1 and
    top-k error on max(8, n // 4) test images (seed 2)."""
    for field, why in _NOT_PORTED.items():
        if getattr(config, field):
            raise NotImplementedError(f"Config.{field}: {why}")
    dev = resolve_device(device)
    size = (config.image_size, config.image_size)
    train_x, train_y = ImageNetLoader.synthetic_arrays(config.synthetic_n, config.num_classes, size, seed=1)
    test_x, test_y = ImageNetLoader.synthetic_arrays(max(8, config.synthetic_n // 4), config.num_classes, size,
                                                     seed=2)
    t0 = time.perf_counter()
    params = fit_params(config, train_x, train_y, dev, use_kernel, batch_size)
    fit_time = time.perf_counter() - t0
    topk = predict_top_k(build_scorer_from_params(params, config, dev, use_kernel), test_x, dev, batch_size)
    m = MulticlassClassifierEvaluator(config.num_classes).evaluate(topk[:, 0], test_y)
    return {
        "pipeline": "ImageNetSiftLcsFV",
        "fit_seconds": fit_time,
        "top1_error": m.total_error,
        "top5_error": float(1.0 - (topk == test_y[:, None]).any(axis=1).mean()),
        "accuracy": m.accuracy,
    }


# ---------------------------------------------------------------- the graph


def _fv_branch(base: Pipeline, config: Config, train_x: Dataset, seed: int) -> Pipeline:
    """descriptor extractor pipeline → PCA → GMM/FV → normalization."""
    sampled = ColumnSampler(config.descriptor_samples_per_image, seed=seed)(base(train_x))
    pca_pipe = Pipeline.from_estimator(PCAEstimator(config.pca_dims, center=True), sampled)
    with_pca = base.then_pipeline(pca_pipe)
    gmm_sampled = ColumnSampler(config.descriptor_samples_per_image, seed=seed + 1)(with_pca(train_x))
    fv_pipe = Pipeline.from_estimator(
        GMMFisherVectorEstimator(config.gmm_k, max_iterations=config.gmm_iters, seed=seed), gmm_sampled
    )
    return with_pca.then_pipeline(fv_pipe).and_then(SignedHellingerMapper()).and_then(NormalizeRows())


class ImageNetSiftLcsFV:
    name = "ImageNetSiftLcsFV"
    Config = Config

    @staticmethod
    def build_scorer(config: Config, train_x: Dataset, train_labels: Dataset) -> Pipeline:
        """Pipeline ending at raw class scores (no prediction head) —
        what augmented-view evaluation averages before argmax.  Images may
        arrive as uint8; both branches start with an identical
        PixelScaler, which CSE merges into one node."""
        sift_base = (
            Pipeline.of(PixelScaler(only_if_integer=True))
            .and_then(GrayScaler())
            .and_then(SIFTExtractor(step=config.sift_step, bin_sizes=(config.sift_bin_size,)))
        )
        lcs_base = Pipeline.of(PixelScaler(only_if_integer=True)).and_then(
            LCSExtractor(step=config.lcs_step, subpatch_size=config.lcs_subpatch)
        )
        sift_branch = _fv_branch(sift_base, config, train_x, seed=config.seed + BRANCH_SEED_OFFSET["sift"])
        lcs_branch = _fv_branch(lcs_base, config, train_x, seed=config.seed + BRANCH_SEED_OFFSET["lcs"])
        featurizer = Pipeline.gather([sift_branch, lcs_branch])
        labels_pm1 = ClassLabelIndicators(config.num_classes)(train_labels)
        return featurizer.and_then(
            BlockWeightedLeastSquaresEstimator(
                block_size=config.solver_block_size,
                num_iter=config.num_epochs,
                lam=config.lam,
                mixture_weight=config.mixture_weight,
                checkpoint_dir=config.checkpoint_dir,
            ),
            train_x,
            labels_pm1,
        )

    @staticmethod
    def build(config: Config, train_x: Dataset, train_labels: Dataset) -> Pipeline:
        return ImageNetSiftLcsFV.build_scorer(config, train_x, train_labels).and_then(TopKClassifier(config.top_k))

    @staticmethod
    def run(config: Config, device="cuda", out: Optional[dict] = None) -> dict:
        """Fit (or load, with ``config.model_path``) and evaluate, on
        ``device`` in f32 with TF32 off.  With ``train_path`` the images
        come from tar archives at ``image_size`` (the test set from
        ``test_path``, else the training tars); otherwise synthetic:
        ``config.synthetic_n`` training images (seed 1) and max(8, n // 4)
        test images (seed 2).  With ``stream`` the training images are a
        StreamDataset of ``stream_batch_size`` batches and the fit runs
        out of core.  ``out``, when given, receives the fitted pipeline
        (``"fitted"``) and what it predicted on the test set
        (``"predictions"``: top-k ids, or each view's scores with
        ``augmented_eval``)."""
        require_one_rank("ImageNetSiftLcsFV.run as a job of several ranks")
        dev = resolve_device(device)
        precision.disable_tf32()
        sz = (config.image_size, config.image_size)
        if config.train_path:
            # image_size sets the resize of real images too, so that the
            # training and test sets agree on it
            test = ImageNetLoader.load(config.test_path or config.train_path, size=sz, device=dev)
        else:
            test = ImageNetLoader.synthetic(max(8, config.synthetic_n // 4), config.num_classes, sz, seed=2,
                                            device=dev)

        def _train():
            # loaded ONLY when a fit is needed (saved-model runs skip it)
            if config.stream:
                if config.train_path:
                    return ImageNetLoader.stream(config.train_path, size=sz, batch_size=config.stream_batch_size,
                                                 device=dev, retries=config.stream_retries)
                return ImageNetLoader.synthetic_stream(config.synthetic_n, config.num_classes, sz, seed=1,
                                                       batch_size=config.stream_batch_size, device=dev,
                                                       retries=config.stream_retries)
            if config.train_path:
                return ImageNetLoader.load(config.train_path, size=sz, device=dev)
            return ImageNetLoader.synthetic(config.synthetic_n, config.num_classes, sz, seed=1, device=dev)

        labs = test.labels.numpy()
        if config.augmented_eval:

            def build_scorer():
                train = _train()
                return ImageNetSiftLcsFV.build_scorer(config, train.data, train.labels)

            t0 = time.perf_counter()
            fitted, loaded = FittedPipeline.fit_or_load(config.model_path, build_scorer,
                                                        config=fit_relevant_config(config), map_location=dev)
            fit_time = time.perf_counter() - t0
            imgs = test.data.array
            p = config.view_patch or (imgs.shape[1] * 7 // 8)
            views = CenterCornerPatcher(p, p, horizontal_flips=True).apply_batch(imgs)
            n, nv = views.shape[0], views.shape[1]
            predictions = fitted(Dataset(views.reshape(n * nv, p, p, views.shape[-1]))).get().numpy()
            ids = np.repeat(np.arange(n), nv)
            evaluator = AugmentedExamplesEvaluator(config.num_classes)
            m = evaluator.evaluate(predictions, ids, labs)
            # top-k from the SAME per-image aggregation evaluate uses
            agg, _ = evaluator.averaged_scores(predictions, ids)
            topk_hit = (np.argsort(-agg, axis=1)[:, : config.top_k] == labs[:, None]).any(axis=1)
        else:

            def build():
                train = _train()
                return ImageNetSiftLcsFV.build(config, train.data, train.labels)

            t0 = time.perf_counter()
            fitted, loaded = FittedPipeline.fit_or_load(config.model_path, build,
                                                        config=fit_relevant_config(config), map_location=dev)
            fit_time = time.perf_counter() - t0
            predictions = fitted(test.data).get().numpy()  # (n, top_k) class ids
            topk_hit = (predictions == labs[:, None]).any(axis=1)
            m = MulticlassClassifierEvaluator(config.num_classes).evaluate(predictions[:, 0], labs)
        if out is not None:
            out.update(fitted=fitted, predictions=predictions)
        return {
            "pipeline": ImageNetSiftLcsFV.name,
            "fit_seconds": fit_time,
            "model_loaded": loaded,
            "top1_error": m.total_error,
            "top5_error": float(1.0 - topk_hit.mean()),
            "accuracy": m.accuracy,
        }


def main(argv=None):
    p = argparse.ArgumentParser(description=ImageNetSiftLcsFV.name)
    p.add_argument("--train-path")
    p.add_argument("--test-path")
    p.add_argument("--num-classes", type=int, default=16)
    p.add_argument("--gmm-k", type=int, default=16)
    p.add_argument("--pca-dims", type=int, default=64)
    p.add_argument("--lam", type=float, default=1e-4)
    p.add_argument("--synthetic-n", type=int, default=64)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--augmented-eval", action="store_true")
    p.add_argument("--model-path")
    p.add_argument("--stream", "--out-of-core", action="store_true", dest="stream",
                   help="stream training images from tar shards; features spill to a disk block store instead "
                        "of device memory")
    p.add_argument("--stream-batch-size", type=int, default=64)
    p.add_argument("--stream-retries", type=int, default=0, help="per-batch retries of the training stream")
    p.add_argument("--checkpoint-dir", help="the solver's per-epoch checkpoint; a killed fit resumes from it")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    cfg = Config(
        train_path=a.train_path,
        test_path=a.test_path,
        num_classes=a.num_classes,
        gmm_k=a.gmm_k,
        pca_dims=a.pca_dims,
        lam=a.lam,
        synthetic_n=a.synthetic_n,
        image_size=a.image_size,
        augmented_eval=a.augmented_eval,
        model_path=a.model_path,
        stream=a.stream,
        stream_batch_size=a.stream_batch_size,
        stream_retries=a.stream_retries,
        checkpoint_dir=a.checkpoint_dir,
    )
    print(ImageNetSiftLcsFV.run(cfg, device=a.device))


if __name__ == "__main__":
    main()
