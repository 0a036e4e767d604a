"""LabeledData — a (data, labels) pair of Datasets (counterpart of
``keystone_tpu/loaders/labeled.py``; reference loaders/LabeledData.scala)."""

from __future__ import annotations

import dataclasses

from keystone_tpu_torch.workflow.dataset import Dataset, as_dataset


@dataclasses.dataclass
class LabeledData:
    data: Dataset
    labels: Dataset

    @classmethod
    def of(cls, data, labels, device=None) -> "LabeledData":
        return cls(as_dataset(data, device), as_dataset(labels, device))

    @property
    def n(self) -> int:
        return self.data.n
