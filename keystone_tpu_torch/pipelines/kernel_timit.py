"""KernelTimitPipeline (counterpart of
``keystone_tpu/pipelines/kernel_timit.py``): the kernel-methods variant of
the TIMIT scenario (arXiv:1602.05310 evaluates kernel systems on TIMIT).
MFCC frames → StandardScaler → NystromFeatures (seeded landmark sampling
and the whitening solve; K(x, L) is computed at apply time) →
BlockLeastSquares (147 classes) → MaxClassifier, fitted through the
workflow graph.  ``stream`` keeps the frames out of core end to end: the
scaler's moments and the landmarks are taken in passes over the stream,
and the solver spills the Nyström features to a FeatureBlockStore.

``build_scorer_from_params`` builds the fitted scorer from arrays (a
reference-fitted model carried across by ``convert``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from keystone_tpu_torch.evaluation.evaluators import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.stream import add_stream_args, stream_labeled
from keystone_tpu_torch.loaders.timit import NUM_CLASSES, TimitFeaturesDataLoader
from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator, BlockLinearMapper
from keystone_tpu_torch.models.kernel_ridge import GaussianKernelGenerator
from keystone_tpu_torch.models.nystrom import NystromFeatureMap, NystromFeatures
from keystone_tpu_torch.ops.stats import StandardScaler, StandardScalerModel
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.optimizer import FusedTransformer
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline, fit_relevant_config


@dataclasses.dataclass
class Config:
    features_path: Optional[str] = None
    labels_path: Optional[str] = None
    test_features_path: Optional[str] = None
    test_labels_path: Optional[str] = None
    num_landmarks: int = 2048
    gamma: float = 0.015
    nystrom_reg: float = 1e-7
    num_epochs: int = 3
    lam: float = 1e-5
    solver_block_size: int = 1024
    num_classes: int = NUM_CLASSES
    seed: int = 0
    synthetic_n: int = 4096
    model_path: Optional[str] = None
    # out of core: stream the frames from disk; the landmarks are sampled
    # in one pass and the Nyström features spill to a disk block store
    stream: bool = False
    stream_batch_size: int = 8192


class KernelTimitPipeline:
    name = "KernelTimitPipeline"
    Config = Config

    @staticmethod
    def build(config: Config, train_x: Dataset, train_labels: Dataset) -> Pipeline:
        kern = GaussianKernelGenerator(config.gamma)
        labels_pm1 = ClassLabelIndicators(config.num_classes)(train_labels)
        return (
            Pipeline.of(StandardScaler().with_data(train_x))
            .and_then(NystromFeatures(kern, num_landmarks=config.num_landmarks, reg=config.nystrom_reg,
                                      seed=config.seed), train_x)
            .and_then(BlockLeastSquaresEstimator(block_size=config.solver_block_size, num_iter=config.num_epochs,
                                                 lam=config.lam), train_x, labels_pm1)
            .and_then(MaxClassifier())
        )

    @staticmethod
    def run(config: Config, device="cuda", out: Optional[dict] = None) -> dict:
        """Fit (or load, with ``config.model_path``) and evaluate on
        ``device``, in f32 with TF32 off.  With ``features_path`` the
        frames come from files (the test set from ``test_features_path``,
        else the training files); otherwise ``synthetic_n`` synthetic
        training frames (seed 1) and ``synthetic_n // 4`` test frames
        (seed 2).  With ``stream`` the training frames are a StreamDataset
        of ``stream_batch_size`` frames and the fit runs out of core.
        ``out``, when given, receives the fitted pipeline (``"fitted"``)
        and its predicted classes on the test set (``"predictions"``)."""
        dev = resolve_device(device)
        precision.disable_tf32()
        _train_cache = []

        def _train():
            # loaded only when a fit is needed (a saved model skips it)
            if not _train_cache:
                if config.features_path and config.stream:
                    train = TimitFeaturesDataLoader.stream(config.features_path, config.labels_path,
                                                           batch_size=config.stream_batch_size, device=dev)
                elif config.features_path:
                    train = TimitFeaturesDataLoader.load(config.features_path, config.labels_path, device=dev)
                else:
                    train = TimitFeaturesDataLoader.synthetic(config.synthetic_n, config.num_classes, seed=1,
                                                              device=dev)
                    if config.stream:
                        train = stream_labeled(train, config.stream_batch_size)
                _train_cache.append(train)
            return _train_cache[0]

        if config.features_path:
            test = (TimitFeaturesDataLoader.load(config.test_features_path, config.test_labels_path, device=dev)
                    if config.test_features_path else _train())
        else:
            test = TimitFeaturesDataLoader.synthetic(config.synthetic_n // 4, config.num_classes, seed=2,
                                                     device=dev)

        def build():
            train = _train()
            return KernelTimitPipeline.build(config, train.data, train.labels)

        t0 = time.perf_counter()
        fitted, loaded = FittedPipeline.fit_or_load(config.model_path, build, config=fit_relevant_config(config),
                                                    map_location=dev)
        fit_time = time.perf_counter() - t0
        preds = fitted(test.data).get()
        m = MulticlassClassifierEvaluator(config.num_classes).evaluate(preds.numpy(), test.labels.numpy())
        if out is not None:
            out.update(fitted=fitted, predictions=preds.numpy())
        return {
            "pipeline": KernelTimitPipeline.name,
            "fit_seconds": fit_time,
            "model_loaded": loaded,
            "test_error": m.total_error,
            "accuracy": m.accuracy,
            "macro_f1": m.macro_f1,
        }


def main(argv=None):
    p = argparse.ArgumentParser(description=KernelTimitPipeline.name)
    p.add_argument("--features-path")
    p.add_argument("--labels-path")
    p.add_argument("--test-features-path")
    p.add_argument("--test-labels-path")
    p.add_argument("--num-landmarks", type=int, default=2048)
    p.add_argument("--gamma", type=float, default=0.015)
    p.add_argument("--num-epochs", type=int, default=3)
    p.add_argument("--lam", type=float, default=1e-5)
    p.add_argument("--num-classes", type=int, default=NUM_CLASSES)
    p.add_argument("--synthetic-n", type=int, default=4096)
    p.add_argument("--model-path")
    add_stream_args(p, default_batch_size=8192, noun="MFCC frames")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    cfg = Config(
        features_path=a.features_path,
        labels_path=a.labels_path,
        test_features_path=a.test_features_path,
        test_labels_path=a.test_labels_path,
        num_landmarks=a.num_landmarks,
        gamma=a.gamma,
        num_epochs=a.num_epochs,
        lam=a.lam,
        num_classes=a.num_classes,
        synthetic_n=a.synthetic_n,
        model_path=a.model_path,
        stream=a.stream,
        stream_batch_size=a.stream_batch_size,
    )
    print(KernelTimitPipeline.run(cfg, device=a.device))


# ---------------------------------------------------------------- fitted arrays


def nystrom_scorer_stages(params: Dict[str, torch.Tensor], gamma: float, use_kernel: Optional[bool] = None) -> list:
    """The fitted Nyström scorer's stages from ``convert``'s arrays:
    scaler, Nyström map, block linear map, MaxClassifier."""
    w = params["blm.weights"]
    return [
        StandardScalerModel(params["scaler.mean"], params.get("scaler.std")),
        NystromFeatureMap(GaussianKernelGenerator(gamma), params["nystrom.landmarks"], params["nystrom.whiten"],
                          use_kernel),
        BlockLinearMapper(w, w.shape[1], params.get("blm.intercept"), params.get("blm.feature_mean")),
        MaxClassifier(),
    ]


def build_scorer_from_params(
    params: Dict[str, torch.Tensor],
    config: Config = Config(),
    device="cuda",
    use_kernel: Optional[bool] = None,
) -> FusedTransformer:
    """The fitted scorer, ending in MaxClassifier class ids.  ``params`` as
    ``convert.kernel_timit_params_from_numpy`` returns them.
    ``use_kernel=False`` computes the Nyström gram by the plain chain in
    place of the kernel (the comparison on the card)."""
    dev = resolve_device(device)
    precision.disable_tf32()
    return FusedTransformer(nystrom_scorer_stages(params, config.gamma, use_kernel)).to(dev).eval()


def scores_of(scorer: FusedTransformer) -> FusedTransformer:
    """The scorer without its MaxClassifier head: raw class scores."""
    return FusedTransformer(list(scorer.stages)[:-1])


def random_params(
    config: Config = Config(),
    block_size: int = 1024,
    scaler_frames: int = 8192,
    seed: int = 0,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Seeded full-width parameters as numpy arrays under
    ``convert.kernel_timit_params_from_numpy``'s keys: the scaler's mean
    and std from ``scaler_frames`` synthetic TIMIT frames, the config's
    ``num_landmarks`` further frames (scaled) as landmarks, their whitening
    fitted by ``NystromFeatures._fit_landmarks`` on ``device`` with the
    config's reg, and 0.01·normal BLM weights (block_size columns a block),
    as ``bench.py`` makes BLM weights."""
    dev = resolve_device(device)
    frames, _ = TimitFeaturesDataLoader.synthetic_arrays(scaler_frames + config.num_landmarks, config.num_classes,
                                                         seed)
    scaler = StandardScaler().fit_arrays(frames[:scaler_frames], device=dev)
    lmk = scaler(torch.from_numpy(frames[scaler_frames:]).to(dev))
    nys = NystromFeatures(GaussianKernelGenerator(config.gamma), config.num_landmarks,
                          config.nystrom_reg)._fit_landmarks(lmk)
    nb = -(-config.num_landmarks // block_size)
    rng = np.random.default_rng(seed)
    out = {
        "scaler.mean": scaler.mean, "scaler.std": scaler.std,
        "nystrom.landmarks": lmk, "nystrom.whiten": nys.whiten,
    }
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["blm.weights"] = (0.01 * rng.normal(size=(nb, block_size, config.num_classes))).astype(np.float32)
    return out


if __name__ == "__main__":
    main()
