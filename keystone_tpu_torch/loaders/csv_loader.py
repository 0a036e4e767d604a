"""CSV row loader (counterpart of ``keystone_tpu/loaders/csv_loader.py``;
reference loaders/CsvDataLoader.scala).  Rows of numbers; optionally one
column is the label (the MNIST format: label, 784 pixels).  Parsed by
numpy, where the reference takes its native reader when it is built (the
same values)."""

from __future__ import annotations

import os

import numpy as np

from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.loaders.stream import PREFETCH
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset


def _read_csv_matrix(path: str, delimiter: str) -> np.ndarray:
    return np.loadtxt(path, delimiter=delimiter, dtype=np.float32, ndmin=2)


def _parse_lines(lines, label_col: int, delimiter: str) -> np.ndarray:
    mat = np.loadtxt(lines, delimiter=delimiter, dtype=np.float32, ndmin=2)
    return np.delete(mat, label_col, axis=1)


class CsvDataLoader:
    @staticmethod
    def load(path: str, label_col: int = 0, delimiter: str = ",", device="cuda") -> LabeledData:
        """Every row: the features and the int labels, Datasets on ``device``."""
        dev = resolve_device(device)
        mat = _read_csv_matrix(path, delimiter)
        labels = mat[:, label_col].astype(np.int32)
        feats = np.delete(mat, label_col, axis=1)
        name = f"csv:{os.path.abspath(path)}:l{label_col}:d{delimiter!r}"
        return LabeledData(Dataset(feats, name=name, device=dev), Dataset(labels, name=name + "-labels", device=dev))

    @staticmethod
    def load_unlabeled(path: str, delimiter: str = ",", device="cuda") -> Dataset:
        return Dataset(_read_csv_matrix(path, delimiter), name=f"csv:{os.path.abspath(path)}:d{delimiter!r}",
                       device=resolve_device(device))

    @staticmethod
    def stream(path: str, label_col: int = 0, delimiter: str = ",", batch_size: int = 4096,
               prefetch: int = PREFETCH, device="cuda") -> LabeledData:
        """Out of core: one pass reads the label column and fixes ``n``;
        the features are re-parsed from disk in ``batch_size``-row chunks
        every sweep, on a producer thread ``prefetch`` chunks ahead."""
        dev = resolve_device(device)
        labels = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    labels.append(float(line.split(delimiter)[label_col]))
        labels = np.asarray(labels, np.float32).astype(np.int32)
        n = len(labels)

        def batches():
            buf = []
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    buf.append(line)
                    if len(buf) == batch_size:
                        yield _parse_lines(buf, label_col, delimiter)
                        buf = []
            if buf:
                yield _parse_lines(buf, label_col, delimiter)

        name = f"csv-stream:{os.path.abspath(path)}:l{label_col}:d{delimiter!r}:b{batch_size}"
        return LabeledData(StreamDataset(batches, n, name=name, prefetch=prefetch, device=dev),
                           Dataset(labels, name=name + "-labels", device=dev))
