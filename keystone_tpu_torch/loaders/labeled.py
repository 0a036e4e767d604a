"""LabeledData — a (data, labels) pair of Datasets (counterpart of
``keystone_tpu/loaders/labeled.py``; reference loaders/LabeledData.scala)."""

from __future__ import annotations

import dataclasses

import numpy as np

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

    def split(self, fraction: float, seed: int = 0):
        """A deterministic train/test split by a numpy permutation drawn
        from ``seed`` (the reference's), on the data's device."""
        idx = np.random.default_rng(seed).permutation(self.n)
        cut = int(self.n * fraction)
        host = self.data.is_host
        rows = self.data.items if host else self.data.numpy()
        labs = self.labels.numpy()
        return tuple(LabeledData(Dataset([rows[i] for i in sel] if host else rows[sel], device=self.data.device),
                                 Dataset(labs[sel], device=self.labels.device))
                     for sel in (idx[:cut], idx[cut:]))
