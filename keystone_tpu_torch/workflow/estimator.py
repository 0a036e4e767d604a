"""Estimator / LabelEstimator (counterpart of
``keystone_tpu/workflow/estimator.py``).

Reference: workflow/Estimator.scala § Estimator[A,B] (``fit(RDD[A]):
Transformer[A,B]``; ``withData`` splices it into a pipeline DAG) and
workflow/LabelEstimator.scala § LabelEstimator[A,B,L] (supervised
``fit(data, labels)``).

Concrete estimators implement ``fit_dataset`` (or the array-level
``fit_arrays``), returning a fitted Transformer on the data's device.
"""

from __future__ import annotations

from typing import Optional

from keystone_tpu_torch.workflow.dataset import Dataset, as_dataset
from keystone_tpu_torch.workflow.transformer import Chainable, Transformer


class Estimator(Chainable):
    @property
    def label(self) -> str:
        return type(self).__name__

    def params(self):
        return None

    def signature(self):
        p = self.params()
        return None if p is None else (type(self).__name__, p)

    # -------------------------------------------------------------- fit
    def fit_arrays(self, x) -> Transformer:
        raise NotImplementedError(type(self).__name__)

    def fit_dataset(self, data: Dataset) -> Transformer:
        return self.fit_arrays(data.array if not data.is_host else data.items)

    def fit(self, data) -> Transformer:
        return self.fit_dataset(as_dataset(data))

    # -------------------------------------------------------------- DSL
    def with_data(self, data, labels=None):
        """Splice this estimator into a pipeline: a Pipeline whose
        transform is 'the transformer obtained by fitting me on ``data``'
        (workflow/Estimator.scala § withData)."""
        from keystone_tpu_torch.workflow.pipeline import Pipeline

        return Pipeline.from_estimator(self, data, labels)

    # Optimizer hook: physical-operator choice (workflow/NodeOptimizationRule).
    def choose_physical(self, sample: Optional[Dataset]) -> "Estimator":
        """The best physical implementation of this logical estimator
        given a data sample (dims/sparsity).  Default: self."""
        return self

    def __repr__(self):
        return self.label


class LabelEstimator(Estimator):
    def fit_arrays(self, x, y=None) -> Transformer:
        raise NotImplementedError(type(self).__name__)

    def fit_dataset(self, data: Dataset, labels: Optional[Dataset] = None) -> Transformer:
        if labels is None:
            raise ValueError(f"{self.label}.fit requires labels")
        return self.fit_arrays(
            data.array if not data.is_host else data.items,
            labels.array if not labels.is_host else labels.items,
        )

    def fit(self, data, labels=None) -> Transformer:
        if labels is None:
            raise ValueError(f"{self.label}.fit requires labels")
        return self.fit_dataset(as_dataset(data), as_dataset(labels))
