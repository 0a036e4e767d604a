"""NewsgroupsPipeline (counterpart of ``keystone_tpu/pipelines/newsgroups.py``;
reference pipelines/text/NewsgroupsPipeline.scala): Trim → LowerCase →
Tokenizer → NGrams(1..n) → log TermFrequency → CommonSparseFeatures →
naive Bayes (``nb``) or least squares (``ls``) → MaxClassifier, fitted
through the workflow graph.  At ``num_features`` ≥ 16384 the features are
CSR rows end to end: naive Bayes counts by scatter-add and least squares
is swapped by the optimizer's node choice for the sparse L-BFGS solver
(no intercept: centring would densify).  ``stream`` re-reads the training
documents from the tree every sweep (a host StreamDataset)."""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

from keystone_tpu_torch.evaluation.evaluators import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.loaders.newsgroups import NewsgroupsDataLoader
from keystone_tpu_torch.models.linear import LinearMapEstimator
from keystone_tpu_torch.models.naive_bayes import NaiveBayesEstimator
from keystone_tpu_torch.ops.nlp import CommonSparseFeatures, LowerCase, NGramsFeaturizer, TermFrequency, Tokenizer
from keystone_tpu_torch.ops.nlp import Trimmer, log_tf
from keystone_tpu_torch.ops.util import ClassLabelIndicators, MaxClassifier
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline, fit_relevant_config

#: the width from which features stay CSR and the heads fit sparse
SPARSE_MIN_FEATURES = 16384


@dataclasses.dataclass
class Config:
    data_path: Optional[str] = None
    test_path: Optional[str] = None
    num_features: int = 100000
    ngrams: int = 2
    head: str = "nb"  # "nb" | "ls"
    nb_lam: float = 1.0
    ls_lam: float = 1e-2
    num_classes: int = 4
    synthetic_n: int = 400
    model_path: Optional[str] = None
    # out of core: the training documents re-read every sweep; with a
    # data_path it needs test_path (a stream cannot be split in place)
    stream: bool = False
    stream_batch_size: int = 512


def text_featurizer(ngrams: int) -> Pipeline:
    """Trim → LowerCase → Tokenizer → NGrams(1..ngrams) → log TermFrequency,
    the host chain the native path takes whole."""
    return (Pipeline.of(Trimmer()).and_then(LowerCase()).and_then(Tokenizer())
            .and_then(NGramsFeaturizer(tuple(range(1, ngrams + 1)))).and_then(TermFrequency(log_tf)))


def host_stream(labeled: LabeledData, batch_size: int) -> LabeledData:
    """An in-memory corpus as a host stream of ``batch_size`` documents
    (the streamed path without files)."""
    docs = labeled.data.items

    def batches():
        for i in range(0, len(docs), batch_size):
            yield docs[i:i + batch_size]

    return LabeledData(StreamDataset(batches, len(docs), host=True, device=labeled.data.device), labeled.labels)


class NewsgroupsPipeline:
    name = "NewsgroupsPipeline"
    Config = Config

    @staticmethod
    def build(config: Config, train_x: Dataset, train_labels: Dataset) -> Pipeline:
        # one decision for the representation and the solver: CSR rows
        # imply the sparse heads
        sparse = config.num_features >= SPARSE_MIN_FEATURES
        featurizer = text_featurizer(config.ngrams).and_then(
            CommonSparseFeatures(config.num_features, sparse_output=sparse), train_x)
        if config.head == "nb":
            head = featurizer.and_then(NaiveBayesEstimator(config.num_classes, lam=config.nb_lam), train_x,
                                       train_labels)
        else:
            labels_pm1 = ClassLabelIndicators(config.num_classes)(train_labels)
            head = featurizer.and_then(LinearMapEstimator(lam=config.ls_lam, fit_intercept=not sparse), train_x,
                                       labels_pm1)
        return head.and_then(MaxClassifier())

    @staticmethod
    def run(config: Config, device="cuda", out: Optional[dict] = None) -> dict:
        """Fit (or load) and evaluate on ``device``.  The data: the
        ``data_path`` tree with ``test_path``'s (one group → label map, the
        training tree's group directories), ``data_path`` split 0.8/0.2
        (seed 0), or ``synthetic_n`` synthetic documents (seed 1) and
        ``synthetic_n // 4`` test documents (seed 2).  ``stream`` streams
        the training documents in ``stream_batch_size`` batches.  ``out``
        receives the fitted pipeline and the test predictions."""
        dev = resolve_device(device)
        precision.disable_tf32()
        if config.stream and config.data_path and not config.test_path:
            raise ValueError("--stream needs --test-path: a streamed train tree cannot be split in place")
        if config.data_path and config.test_path:
            groups = sorted(g for g in os.listdir(config.data_path)
                            if os.path.isdir(os.path.join(config.data_path, g)))
            if config.stream:
                train = NewsgroupsDataLoader.stream(config.data_path, groups=groups,
                                                    batch_size=config.stream_batch_size, device=dev)
            else:
                train = NewsgroupsDataLoader.load(config.data_path, groups=groups, device=dev)
            test = NewsgroupsDataLoader.load(config.test_path, groups=groups, device=dev)
            config = dataclasses.replace(config, num_classes=len(groups))
        elif config.data_path:
            data = NewsgroupsDataLoader.load(config.data_path, device=dev)
            config = dataclasses.replace(config, num_classes=int(data.labels.numpy().max()) + 1)
            train, test = data.split(0.8, seed=0)
        else:
            train = NewsgroupsDataLoader.synthetic(config.synthetic_n, config.num_classes, seed=1, device=dev)
            test = NewsgroupsDataLoader.synthetic(config.synthetic_n // 4, config.num_classes, seed=2, device=dev)
            if config.stream:
                train = host_stream(train, config.stream_batch_size)
        t0 = time.perf_counter()
        fitted, loaded = FittedPipeline.fit_or_load(
            config.model_path, lambda: NewsgroupsPipeline.build(config, train.data, train.labels),
            config=fit_relevant_config(config), map_location=dev)
        fit_time = time.perf_counter() - t0
        preds = fitted(test.data).get().numpy()
        m = MulticlassClassifierEvaluator(config.num_classes).evaluate(preds, test.labels.numpy())
        if out is not None:
            out.update(fitted=fitted, predictions=preds)
        return {
            "pipeline": NewsgroupsPipeline.name,
            "fit_seconds": fit_time,
            "model_loaded": loaded,
            "test_error": m.total_error,
            "accuracy": m.accuracy,
            "macro_f1": m.macro_f1,
        }


def main(argv=None):
    p = argparse.ArgumentParser(description=NewsgroupsPipeline.name)
    p.add_argument("--data-path")
    p.add_argument("--test-path")
    p.add_argument("--num-features", type=int, default=100000)
    p.add_argument("--head", choices=["nb", "ls"], default="nb")
    p.add_argument("--synthetic-n", type=int, default=400)
    p.add_argument("--model-path")
    p.add_argument("--stream", "--out-of-core", action="store_true", dest="stream",
                   help="re-read the training documents every sweep (with --data-path, needs --test-path)")
    p.add_argument("--stream-batch-size", type=int, default=512)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    cfg = Config(data_path=a.data_path, test_path=a.test_path, num_features=a.num_features, head=a.head,
                 synthetic_n=a.synthetic_n, model_path=a.model_path, stream=a.stream,
                 stream_batch_size=a.stream_batch_size)
    print(NewsgroupsPipeline.run(cfg, device=a.device))


if __name__ == "__main__":
    main()
