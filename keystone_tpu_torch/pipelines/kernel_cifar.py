"""KernelCifarPipeline (counterpart of
``keystone_tpu/pipelines/kernel_cifar.py``): kernel CIFAR through Nyström.
Raw pixels → ImageVectorizer → StandardScaler → NystromFeatures →
BlockLeastSquares → MaxClassifier, fitted through the workflow graph: the
linear solve runs in the m-dimensional Nyström feature space of a
Gaussian kernel over the scaled pixels (d = 3072).  ``stream`` keeps the
CIFAR records out of core.

``build_scorer_from_params`` builds the fitted scorer from arrays (a
reference-fitted model carried across by ``convert``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import torch

from keystone_tpu_torch.evaluation.evaluators import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.cifar import NUM_CLASSES, CifarLoader
from keystone_tpu_torch.loaders.stream import add_stream_args, require_stream_test_path, resolve_train_source
from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.models.kernel_ridge import GaussianKernelGenerator
from keystone_tpu_torch.models.nystrom import NystromFeatures
from keystone_tpu_torch.ops.images import ImageVectorizer
from keystone_tpu_torch.ops.stats import StandardScaler
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.pipelines.kernel_timit import nystrom_scorer_stages
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.optimizer import FusedTransformer
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline, fit_relevant_config


@dataclasses.dataclass
class Config:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    num_landmarks: int = 2048
    gamma: float = 2e-4
    nystrom_reg: float = 1e-7
    num_epochs: int = 3
    lam: float = 1e-5
    solver_block_size: int = 1024
    seed: int = 0
    synthetic_n: int = 1024
    model_path: Optional[str] = None
    # out of core: reread the CIFAR records from disk every pass
    stream: bool = False
    stream_batch_size: int = 1024


class KernelCifarPipeline:
    name = "KernelCifarPipeline"
    Config = Config

    @staticmethod
    def build(config: Config, train_x: Dataset, train_labels: Dataset) -> Pipeline:
        kern = GaussianKernelGenerator(config.gamma)
        labels_pm1 = ClassLabelIndicators(NUM_CLASSES)(train_labels)
        vec = Pipeline.of(ImageVectorizer())
        scaled = vec.and_then(StandardScaler().with_data(vec(train_x)))
        return (
            scaled.and_then(NystromFeatures(kern, num_landmarks=config.num_landmarks, reg=config.nystrom_reg,
                                            seed=config.seed), train_x)
            .and_then(BlockLeastSquaresEstimator(block_size=config.solver_block_size, num_iter=config.num_epochs,
                                                 lam=config.lam), train_x, labels_pm1)
            .and_then(MaxClassifier())
        )

    @staticmethod
    def run(config: Config, device="cuda", out: Optional[dict] = None) -> dict:
        """Fit (or load, with ``config.model_path``) and evaluate on
        ``device``, in f32 with TF32 off.  With ``train_path`` the records
        come from CIFAR-10 binary files (the test set from ``test_path``,
        which ``stream`` requires, else the training file); otherwise
        ``synthetic_n`` synthetic training images (seed 1) and
        ``synthetic_n // 4`` test images (seed 2).  ``out`` as in
        ``KernelTimitPipeline.run``."""
        dev = resolve_device(device)
        precision.disable_tf32()
        require_stream_test_path(config)
        if config.train_path:
            test = CifarLoader.load(config.test_path or config.train_path, device=dev)
        else:
            test = CifarLoader.synthetic(config.synthetic_n // 4, seed=2, device=dev)

        def build():
            train = resolve_train_source(
                config,
                load=lambda path: CifarLoader.load(path, device=dev),
                stream=lambda path, batch_size: CifarLoader.stream(path, batch_size=batch_size, device=dev),
                synthetic=lambda: CifarLoader.synthetic(config.synthetic_n, seed=1, device=dev),
            )
            return KernelCifarPipeline.build(config, train.data, train.labels)

        t0 = time.perf_counter()
        fitted, loaded = FittedPipeline.fit_or_load(config.model_path, build, config=fit_relevant_config(config),
                                                    map_location=dev)
        fit_time = time.perf_counter() - t0
        preds = fitted(test.data).get().numpy()
        m = MulticlassClassifierEvaluator(NUM_CLASSES).evaluate(preds, test.labels.numpy())
        if out is not None:
            out.update(fitted=fitted, predictions=preds)
        return {
            "pipeline": KernelCifarPipeline.name,
            "fit_seconds": fit_time,
            "model_loaded": loaded,
            "test_error": m.total_error,
            "accuracy": m.accuracy,
        }


def build_scorer_from_params(params: Dict[str, torch.Tensor], config: Config = Config(),
                             device="cuda") -> FusedTransformer:
    """The fitted scorer on (n, 32, 32, 3) images, ending in MaxClassifier
    class ids; ``params`` as ``convert.kernel_cifar_params_from_numpy``
    returns them."""
    dev = resolve_device(device)
    precision.disable_tf32()
    stages = [ImageVectorizer()] + nystrom_scorer_stages(params, config.gamma)
    return FusedTransformer(stages).to(dev).eval()


def main(argv=None):
    p = argparse.ArgumentParser(description=KernelCifarPipeline.name)
    p.add_argument("--train-path")
    p.add_argument("--test-path")
    p.add_argument("--num-landmarks", type=int, default=2048)
    p.add_argument("--gamma", type=float, default=2e-4)
    p.add_argument("--num-epochs", type=int, default=3)
    p.add_argument("--lam", type=float, default=1e-5)
    p.add_argument("--synthetic-n", type=int, default=1024)
    p.add_argument("--model-path")
    add_stream_args(p, default_batch_size=1024, noun="CIFAR records")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    print(KernelCifarPipeline.run(Config(
        train_path=a.train_path,
        test_path=a.test_path,
        num_landmarks=a.num_landmarks,
        gamma=a.gamma,
        num_epochs=a.num_epochs,
        lam=a.lam,
        synthetic_n=a.synthetic_n,
        model_path=a.model_path,
        stream=a.stream,
        stream_batch_size=a.stream_batch_size,
    ), device=a.device))


if __name__ == "__main__":
    main()
