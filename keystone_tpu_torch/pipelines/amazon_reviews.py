"""AmazonReviewsPipeline (counterpart of ``keystone_tpu/pipelines/amazon_reviews.py``;
reference pipelines/text/AmazonReviewsPipeline.scala): the host text
chain → HashingTF → logistic regression (binary sentiment) →
MaxClassifier, fitted through the workflow graph.  At ``num_features`` ≥
16384 the hashed features are CSR rows, which the logistic solver fits by
gather and scatter-add.  ``stream`` re-parses the training reviews every
sweep (a host StreamDataset)."""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from keystone_tpu_torch.evaluation.evaluators import BinaryClassifierEvaluator
from keystone_tpu_torch.loaders.amazon import AmazonReviewsDataLoader
from keystone_tpu_torch.models.logistic import LogisticRegressionEstimator
from keystone_tpu_torch.ops.nlp import HashingTF
from keystone_tpu_torch.ops.util import MaxClassifier
from keystone_tpu_torch.pipelines.newsgroups import SPARSE_MIN_FEATURES, host_stream, text_featurizer
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline, fit_relevant_config


@dataclasses.dataclass
class Config:
    data_path: Optional[str] = None
    num_features: int = 16384
    ngrams: int = 2
    lam: float = 1e-4
    num_iters: int = 40
    synthetic_n: int = 600
    model_path: Optional[str] = None
    # out of core: the training reviews re-parsed every sweep; with a
    # data_path it needs test_path
    test_path: Optional[str] = None
    stream: bool = False
    stream_batch_size: int = 1024


class AmazonReviewsPipeline:
    name = "AmazonReviewsPipeline"
    Config = Config

    @staticmethod
    def build(config: Config, train_x: Dataset, train_labels: Dataset) -> Pipeline:
        featurizer = text_featurizer(config.ngrams).and_then(
            HashingTF(config.num_features, sparse_output=config.num_features >= SPARSE_MIN_FEATURES))
        return featurizer.and_then(
            LogisticRegressionEstimator(num_classes=2, lam=config.lam, num_iters=config.num_iters), train_x,
            train_labels).and_then(MaxClassifier())

    @staticmethod
    def run(config: Config, device="cuda", out: Optional[dict] = None) -> dict:
        """Fit (or load) and evaluate on ``device``: the ``data_path`` file
        (streamed with ``stream``) and ``test_path``'s, ``data_path`` split
        0.8/0.2 (seed 0), or ``synthetic_n`` synthetic reviews (seed 1)
        and ``synthetic_n // 4`` test reviews (seed 2).  ``out`` as in
        ``NewsgroupsPipeline.run``."""
        dev = resolve_device(device)
        precision.disable_tf32()
        if config.stream and config.data_path:
            if not config.test_path:
                raise ValueError("--stream needs --test-path: a streamed JSON-lines file cannot be split in place")
            train = AmazonReviewsDataLoader.stream(config.data_path, batch_size=config.stream_batch_size,
                                                   device=dev)
            test = AmazonReviewsDataLoader.load(config.test_path, device=dev)
        elif config.data_path and config.test_path:
            train = AmazonReviewsDataLoader.load(config.data_path, device=dev)
            test = AmazonReviewsDataLoader.load(config.test_path, device=dev)
        elif config.data_path:
            train, test = AmazonReviewsDataLoader.load(config.data_path, device=dev).split(0.8, seed=0)
        else:
            train = AmazonReviewsDataLoader.synthetic(config.synthetic_n, seed=1, device=dev)
            test = AmazonReviewsDataLoader.synthetic(config.synthetic_n // 4, seed=2, device=dev)
            if config.stream:
                train = host_stream(train, config.stream_batch_size)
        t0 = time.perf_counter()
        fitted, loaded = FittedPipeline.fit_or_load(
            config.model_path, lambda: AmazonReviewsPipeline.build(config, train.data, train.labels),
            config=fit_relevant_config(config), map_location=dev)
        fit_time = time.perf_counter() - t0
        preds = fitted(test.data).get().numpy()
        m = BinaryClassifierEvaluator().evaluate(preds, test.labels.numpy())
        if out is not None:
            out.update(fitted=fitted, predictions=preds)
        return {
            "pipeline": AmazonReviewsPipeline.name,
            "fit_seconds": fit_time,
            "model_loaded": loaded,
            "accuracy": m.accuracy,
            "f1": m.f1,
        }


def main(argv=None):
    p = argparse.ArgumentParser(description=AmazonReviewsPipeline.name)
    p.add_argument("--data-path")
    p.add_argument("--test-path")
    p.add_argument("--num-features", type=int, default=16384)
    p.add_argument("--synthetic-n", type=int, default=600)
    p.add_argument("--model-path")
    p.add_argument("--stream", "--out-of-core", action="store_true", dest="stream",
                   help="re-parse the training reviews every sweep (with --data-path, needs --test-path)")
    p.add_argument("--stream-batch-size", type=int, default=1024)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    cfg = Config(data_path=a.data_path, test_path=a.test_path, stream=a.stream,
                 stream_batch_size=a.stream_batch_size, num_features=a.num_features, synthetic_n=a.synthetic_n,
                 model_path=a.model_path)
    print(AmazonReviewsPipeline.run(cfg, device=a.device))


if __name__ == "__main__":
    main()
