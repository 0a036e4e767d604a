"""RandomPatchCifar (counterpart of ``keystone_tpu/pipelines/random_patch_cifar.py``;
reference pipelines/images/cifar/RandomPatchCifar.scala): Convolver →
SymmetricRectifier → sum Pooler → ImageVectorizer → StandardScaler →
BlockLeastSquares → MaxClassifier, fitted through the workflow graph.

As in the reference, the filters are learned imperatively at build time:
random patches of the training images, a ZCA whitening fitted on them,
and the first ``num_filters`` whitened patches as filters, the whitening
folded into the Convolver (``Convolver.from_whitened_patches``)."""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from keystone_tpu_torch.evaluation.evaluators import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.cifar import C, NUM_CLASSES, CifarLoader
from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.models.zca import ZCAWhitenerEstimator
from keystone_tpu_torch.ops.images import Convolver, ImageVectorizer, Pooler, RandomPatcher, SymmetricRectifier
from keystone_tpu_torch.ops.stats import StandardScaler
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline, fit_relevant_config


@dataclasses.dataclass
class Config:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    num_filters: int = 256
    patch_size: int = 6
    patches_per_image: int = 10
    pool_size: int = 13
    pool_stride: int = 13
    alpha: float = 0.25
    lam: float = 1e-2
    block_size: int = 1024
    num_iter: int = 2
    zca_eps: float = 0.1
    seed: int = 0
    synthetic_n: int = 512
    model_path: Optional[str] = None


def learn_filters(config: Config, train_x: Dataset) -> Convolver:
    """The Convolver the build learns: ``patches_per_image`` random patches
    an image, a ZCA whitening fitted on all of them, and the first
    ``num_filters`` of them, whitened, as filters."""
    patcher = RandomPatcher(config.patches_per_image, config.patch_size, config.patch_size, seed=config.seed)
    patches = patcher.apply_dataset(train_x)  # (n·ppi, ps·ps·3)
    whitener = ZCAWhitenerEstimator(eps=config.zca_eps).fit_dataset(patches)
    flat = patches.array[:min(config.num_filters, patches.n)]
    return Convolver.from_whitened_patches(whitener(flat), whitener, (config.patch_size, config.patch_size, C))


class RandomPatchCifar:
    name = "RandomPatchCifar"
    Config = Config

    @staticmethod
    def build(config: Config, train_x: Dataset, train_labels: Dataset) -> Pipeline:
        featurizer = (Pipeline.of(learn_filters(config, train_x))
                      .and_then(SymmetricRectifier(alpha=config.alpha))
                      .and_then(Pooler(config.pool_stride, config.pool_size))
                      .and_then(ImageVectorizer()))
        labels_pm1 = ClassLabelIndicators(NUM_CLASSES)(train_labels)
        scaled = featurizer.and_then(StandardScaler(), train_x)
        return scaled.and_then(
            BlockLeastSquaresEstimator(block_size=config.block_size, num_iter=config.num_iter, lam=config.lam),
            train_x, labels_pm1,
        ).and_then(MaxClassifier())

    @staticmethod
    def run(config: Config, device="cuda", out: Optional[dict] = None) -> dict:
        """Fit (or load) and evaluate on ``device``: CIFAR-10 binary files
        or ``synthetic_n`` synthetic images (seed 1) and ``synthetic_n //
        4`` test images (seed 2); ``out`` as in ``MnistRandomFFT.run``."""
        dev = resolve_device(device)
        precision.disable_tf32()
        if config.train_path:
            test = CifarLoader.load(config.test_path or config.train_path, device=dev)
        else:
            test = CifarLoader.synthetic(config.synthetic_n // 4, seed=2, device=dev)

        def build():
            train = (CifarLoader.load(config.train_path, device=dev) if config.train_path
                     else CifarLoader.synthetic(config.synthetic_n, seed=1, device=dev))
            return RandomPatchCifar.build(config, train.data, train.labels)

        t0 = time.perf_counter()
        fitted, loaded = FittedPipeline.fit_or_load(config.model_path, build, config=fit_relevant_config(config),
                                                    map_location=dev)
        fit_time = time.perf_counter() - t0
        preds = fitted(test.data).get().numpy()
        m = MulticlassClassifierEvaluator(NUM_CLASSES).evaluate(preds, test.labels.numpy())
        if out is not None:
            out.update(fitted=fitted, predictions=preds)
        return {
            "pipeline": RandomPatchCifar.name,
            "fit_seconds": fit_time,
            "model_loaded": loaded,
            "test_error": m.total_error,
            "accuracy": m.accuracy,
        }


def main(argv=None):
    p = argparse.ArgumentParser(description=RandomPatchCifar.name)
    p.add_argument("--train-path")
    p.add_argument("--test-path")
    p.add_argument("--num-filters", type=int, default=256)
    p.add_argument("--lam", type=float, default=1e-2)
    p.add_argument("--synthetic-n", type=int, default=512)
    p.add_argument("--model-path")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    cfg = Config(train_path=a.train_path, test_path=a.test_path, num_filters=a.num_filters, lam=a.lam,
                 synthetic_n=a.synthetic_n, model_path=a.model_path)
    print(RandomPatchCifar.run(cfg, device=a.device))


if __name__ == "__main__":
    main()
