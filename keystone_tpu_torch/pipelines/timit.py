"""TimitPipeline (counterpart of ``keystone_tpu/pipelines/timit.py``;
reference pipelines/speech/timit/TimitPipeline.scala): MFCC frames →
StandardScaler → ``num_cosine_features / cosine_block_size`` branches of
CosineRandomFeatures gathered → BlockWeightedLeastSquares (147 classes)
→ MaxClassifier, fitted through the workflow graph.  ``stream`` keeps
the frames out of core: the scaler's moments are taken in passes over
the stream and the solver spills the cosine features to a
FeatureBlockStore."""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from keystone_tpu_torch.evaluation.evaluators import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.stream import add_stream_args, stream_labeled
from keystone_tpu_torch.loaders.timit import NUM_CLASSES, TimitFeaturesDataLoader
from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.ops.stats import CosineRandomFeatures, StandardScaler
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline, fit_relevant_config


@dataclasses.dataclass
class Config:
    features_path: Optional[str] = None
    labels_path: Optional[str] = None
    test_features_path: Optional[str] = None
    test_labels_path: Optional[str] = None
    num_cosine_features: int = 4096
    cosine_block_size: int = 1024
    gamma: float = 0.05
    num_epochs: int = 3
    lam: float = 1e-3
    mixture_weight: float = 0.5
    solver_block_size: int = 1024
    num_classes: int = NUM_CLASSES
    seed: int = 0
    synthetic_n: int = 4096
    model_path: Optional[str] = None
    # out of core: stream the frames from disk; the cosine features spill
    # to a disk block store
    stream: bool = False
    stream_batch_size: int = 8192


class TimitPipeline:
    name = "TimitPipeline"
    Config = Config

    @staticmethod
    def build(config: Config, train_x: Dataset, train_labels: Dataset) -> Pipeline:
        (dim,) = train_x.item_shape
        num_blocks = max(1, config.num_cosine_features // config.cosine_block_size)
        branches = [
            Pipeline.of(CosineRandomFeatures.init(dim, config.cosine_block_size, gamma=config.gamma,
                                                  seed=config.seed + i, device=train_x.device))
            for i in range(num_blocks)
        ]
        featurizer = Pipeline.of(StandardScaler().with_data(train_x)).then_pipeline(Pipeline.gather(branches))
        labels_pm1 = ClassLabelIndicators(config.num_classes)(train_labels)
        return featurizer.and_then(
            BlockWeightedLeastSquaresEstimator(block_size=config.solver_block_size, num_iter=config.num_epochs,
                                               lam=config.lam, mixture_weight=config.mixture_weight),
            train_x, labels_pm1,
        ).and_then(MaxClassifier())

    @staticmethod
    def run(config: Config, device="cuda", out: Optional[dict] = None) -> dict:
        """Fit (or load) and evaluate on ``device``, as
        ``KernelTimitPipeline.run`` does: frames from files (CSV or
        ``.npy``; the test set from ``test_features_path``, else the
        training files) or ``synthetic_n`` synthetic frames (seed 1) and
        ``synthetic_n // 4`` test frames (seed 2); with ``stream`` the
        training frames are a StreamDataset of ``stream_batch_size``
        frames.  ``out`` as in ``MnistRandomFFT.run``."""
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
            return TimitPipeline.build(config, train.data, train.labels)

        t0 = time.perf_counter()
        fitted, loaded = FittedPipeline.fit_or_load(config.model_path, build, config=fit_relevant_config(config),
                                                    map_location=dev)
        fit_time = time.perf_counter() - t0
        preds = fitted(test.data).get().numpy()
        m = MulticlassClassifierEvaluator(config.num_classes).evaluate(preds, test.labels.numpy())
        if out is not None:
            out.update(fitted=fitted, predictions=preds)
        return {
            "pipeline": TimitPipeline.name,
            "fit_seconds": fit_time,
            "model_loaded": loaded,
            "test_error": m.total_error,
            "accuracy": m.accuracy,
            # class balance shows in the macro metrics: on skewed data
            # they are what mixture_weight exists to move
            "macro_f1": m.macro_f1,
            "macro_recall": m.macro_recall,
        }


def main(argv=None):
    p = argparse.ArgumentParser(description=TimitPipeline.name)
    p.add_argument("--features-path")
    p.add_argument("--labels-path")
    p.add_argument("--test-features-path")
    p.add_argument("--test-labels-path")
    p.add_argument("--num-cosine-features", type=int, default=4096)
    p.add_argument("--num-epochs", type=int, default=3)
    p.add_argument("--lam", type=float, default=1e-3)
    p.add_argument("--num-classes", type=int, default=NUM_CLASSES)
    p.add_argument("--synthetic-n", type=int, default=4096)
    p.add_argument("--model-path")
    add_stream_args(p, default_batch_size=8192, noun="MFCC frames")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    cfg = Config(features_path=a.features_path, labels_path=a.labels_path,
                 test_features_path=a.test_features_path, test_labels_path=a.test_labels_path,
                 num_cosine_features=a.num_cosine_features, num_epochs=a.num_epochs, lam=a.lam,
                 num_classes=a.num_classes, synthetic_n=a.synthetic_n, model_path=a.model_path, stream=a.stream,
                 stream_batch_size=a.stream_batch_size)
    print(TimitPipeline.run(cfg, device=a.device))


if __name__ == "__main__":
    main()
