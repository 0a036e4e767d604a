"""MnistRandomFFT (counterpart of ``keystone_tpu/pipelines/mnist_random_fft.py``;
reference pipelines/images/mnist/MnistRandomFFT.scala): pixels scaled to
[0, 1], then ``num_ffts`` branches of RandomSignNode → PaddedFFT →
LinearRectifier gathered, exact least squares, MaxClassifier; fitted
through the workflow graph.  ``stream`` re-parses the training CSV every
sweep, and the exact solver accumulates its statistics batch by batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from keystone_tpu_torch.evaluation.evaluators import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.mnist import NUM_CLASSES, MnistLoader
from keystone_tpu_torch.loaders.stream import add_stream_args, require_stream_test_path, resolve_train_source
from keystone_tpu_torch.models.linear import LinearMapEstimator
from keystone_tpu_torch.ops.images import PixelScaler
from keystone_tpu_torch.ops.stats import LinearRectifier, PaddedFFT, RandomSignNode
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline, fit_relevant_config


@dataclasses.dataclass
class Config:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    num_ffts: int = 4
    lam: float = 1e-2
    seed: int = 0
    synthetic_n: int = 2048
    model_path: Optional[str] = None
    # out of core: re-parse the training CSV every sweep
    stream: bool = False
    stream_batch_size: int = 4096


class MnistRandomFFT:
    name = "MnistRandomFFT"
    Config = Config

    @staticmethod
    def featurizer(config: Config, dim: int, device) -> Pipeline:
        """The random-FFT featurizer of ``dim``-pixel rows on ``device``."""
        branches = [
            Pipeline.of(RandomSignNode.init(dim, seed=config.seed + i, device=device))
            .and_then(PaddedFFT())
            .and_then(LinearRectifier(0.0))
            for i in range(config.num_ffts)
        ]
        # pixels in [0, 1] keep the f32 normal equations well conditioned
        return Pipeline.of(PixelScaler()).then_pipeline(Pipeline.gather(branches))

    @staticmethod
    def build(config: Config, train_x: Dataset, train_labels: Dataset) -> Pipeline:
        (dim,) = train_x.item_shape
        featurizer = MnistRandomFFT.featurizer(config, dim, train_x.device)
        labels_pm1 = ClassLabelIndicators(NUM_CLASSES)(train_labels)
        return featurizer.and_then(LinearMapEstimator(lam=config.lam), train_x, labels_pm1).and_then(MaxClassifier())

    @staticmethod
    def run(config: Config, device="cuda", out: Optional[dict] = None) -> dict:
        """Fit (or load, with ``config.model_path``) and evaluate on
        ``device``, in f32 with TF32 off.  With ``train_path`` the rows come
        from MNIST CSV files (the test set from ``test_path``, which
        ``stream`` requires, else the training file); otherwise
        ``synthetic_n`` synthetic training rows (seed 1) and
        ``synthetic_n // 4`` test rows (seed 2).  ``out``, when given,
        receives the fitted pipeline (``"fitted"``) and its predicted
        classes on the test set (``"predictions"``)."""
        dev = resolve_device(device)
        precision.disable_tf32()
        require_stream_test_path(config)
        if config.train_path:
            test = MnistLoader.load(config.test_path or config.train_path, device=dev)
        else:
            test = MnistLoader.synthetic(config.synthetic_n // 4, seed=2, device=dev)

        def build():
            train = resolve_train_source(
                config,
                load=lambda path: MnistLoader.load(path, device=dev),
                stream=lambda path, batch_size: MnistLoader.stream(path, batch_size=batch_size, device=dev),
                synthetic=lambda: MnistLoader.synthetic(config.synthetic_n, seed=1, device=dev),
            )
            return MnistRandomFFT.build(config, train.data, train.labels)

        t0 = time.perf_counter()
        fitted, loaded = FittedPipeline.fit_or_load(config.model_path, build, config=fit_relevant_config(config),
                                                    map_location=dev)
        fit_time = time.perf_counter() - t0
        preds = fitted(test.data).get().numpy()
        m = MulticlassClassifierEvaluator(NUM_CLASSES).evaluate(preds, test.labels.numpy())
        if out is not None:
            out.update(fitted=fitted, predictions=preds)
        return {
            "pipeline": MnistRandomFFT.name,
            "fit_seconds": fit_time,
            "model_loaded": loaded,
            "test_error": m.total_error,
            "accuracy": m.accuracy,
        }


def main(argv=None):
    p = argparse.ArgumentParser(description=MnistRandomFFT.name)
    p.add_argument("--train-path")
    p.add_argument("--test-path")
    p.add_argument("--num-ffts", type=int, default=4)
    p.add_argument("--lam", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic-n", type=int, default=2048)
    p.add_argument("--model-path")
    add_stream_args(p, default_batch_size=4096, noun="the training CSV")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    cfg = Config(a.train_path, a.test_path, a.num_ffts, a.lam, a.seed, a.synthetic_n, model_path=a.model_path,
                 stream=a.stream, stream_batch_size=a.stream_batch_size)
    print(MnistRandomFFT.run(cfg, device=a.device))


if __name__ == "__main__":
    main()
