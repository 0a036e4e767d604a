"""LinearPixels (counterpart of ``keystone_tpu/pipelines/linear_pixels.py``;
reference pipelines/images/cifar/LinearPixels.scala): the CIFAR baseline,
raw pixels → exact least squares → MaxClassifier, fitted through the
workflow graph.  ``stream`` rereads the CIFAR records every sweep."""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from keystone_tpu_torch.evaluation.evaluators import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.cifar import NUM_CLASSES, CifarLoader
from keystone_tpu_torch.loaders.stream import add_stream_args, require_stream_test_path, resolve_train_source
from keystone_tpu_torch.models.linear import LinearMapEstimator
from keystone_tpu_torch.ops.images import ImageVectorizer
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline, fit_relevant_config


@dataclasses.dataclass
class Config:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    lam: float = 1e-3
    synthetic_n: int = 1024
    model_path: Optional[str] = None
    # out of core: reread the CIFAR records from disk every sweep
    stream: bool = False
    stream_batch_size: int = 1024


class LinearPixels:
    name = "LinearPixels"
    Config = Config

    @staticmethod
    def build(config: Config, train_x: Dataset, train_labels: Dataset) -> Pipeline:
        labels_pm1 = ClassLabelIndicators(NUM_CLASSES)(train_labels)
        return (Pipeline.of(ImageVectorizer())
                .and_then(LinearMapEstimator(lam=config.lam), train_x, labels_pm1)
                .and_then(MaxClassifier()))

    @staticmethod
    def run(config: Config, device="cuda", out: Optional[dict] = None) -> dict:
        """Fit (or load) and evaluate on ``device``, as
        ``KernelCifarPipeline.run`` does: CIFAR-10 binary files or
        ``synthetic_n`` synthetic images (seed 1) and ``synthetic_n // 4``
        test images (seed 2); ``out`` as in ``MnistRandomFFT.run``."""
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
            return LinearPixels.build(config, train.data, train.labels)

        t0 = time.perf_counter()
        fitted, loaded = FittedPipeline.fit_or_load(config.model_path, build, config=fit_relevant_config(config),
                                                    map_location=dev)
        fit_time = time.perf_counter() - t0
        preds = fitted(test.data).get().numpy()
        m = MulticlassClassifierEvaluator(NUM_CLASSES).evaluate(preds, test.labels.numpy())
        if out is not None:
            out.update(fitted=fitted, predictions=preds)
        return {
            "pipeline": LinearPixels.name,
            "fit_seconds": fit_time,
            "model_loaded": loaded,
            "test_error": m.total_error,
            "accuracy": m.accuracy,
        }


def main(argv=None):
    p = argparse.ArgumentParser(description=LinearPixels.name)
    p.add_argument("--train-path")
    p.add_argument("--test-path")
    p.add_argument("--lam", type=float, default=1e-3)
    p.add_argument("--synthetic-n", type=int, default=1024)
    p.add_argument("--model-path")
    add_stream_args(p, default_batch_size=1024, noun="CIFAR records")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    print(LinearPixels.run(Config(a.train_path, a.test_path, a.lam, a.synthetic_n, model_path=a.model_path,
                                  stream=a.stream, stream_batch_size=a.stream_batch_size), device=a.device))


if __name__ == "__main__":
    main()
