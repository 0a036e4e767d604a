"""TIMIT frame loader (counterpart of ``keystone_tpu/loaders/timit.py``;
reference loaders/TimitFeaturesDataLoader.scala): pre-extracted MFCC
frames (440-d: a 40-d filterbank × an 11-frame context window) with
per-frame labels over 147 phone states."""

from __future__ import annotations

import os

import numpy as np

from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.loaders.stream import PREFETCH
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset

NUM_CLASSES = 147
DIM = 440


def _labels(path: str) -> np.ndarray:
    return (np.load(path) if path.endswith(".npy") else np.loadtxt(path, dtype=np.int64)).astype(np.int32)


class TimitFeaturesDataLoader:
    @staticmethod
    def load(features_path: str, labels_path: str, device="cuda") -> LabeledData:
        """features: CSV or ``.npy`` (n, 440); labels: one int a line or
        an ``.npy``; Datasets on ``device``."""
        dev = resolve_device(device)
        feats = (np.load(features_path) if features_path.endswith(".npy")
                 else np.loadtxt(features_path, delimiter=",", dtype=np.float32))
        name = f"timit:{os.path.abspath(features_path)}:{os.path.abspath(labels_path)}"
        return LabeledData(Dataset(feats.astype(np.float32), name=name, device=dev),
                           Dataset(_labels(labels_path), name=name + "-labels", device=dev))

    @staticmethod
    def stream(features_path: str, labels_path: str, batch_size: int = 8192, device="cuda") -> LabeledData:
        """Out of core: ``.npy`` features are memory-mapped and reread in
        ``batch_size``-frame chunks each sweep, CSV features re-parsed in
        chunks of as many lines; the labels (4 bytes a frame) stay in
        memory."""
        dev = resolve_device(device)
        labels = _labels(labels_path)
        n = len(labels)
        name = f"timit-stream:{os.path.abspath(features_path)}:{os.path.abspath(labels_path)}:b{batch_size}"

        if features_path.endswith(".npy"):

            def batches():
                mm = np.load(features_path, mmap_mode="r")
                for i in range(0, n, batch_size):
                    yield np.array(mm[i:i + batch_size], np.float32)

        else:

            def batches():
                buf = []
                with open(features_path) as f:
                    for line in f:
                        if not line.strip():
                            continue
                        buf.append(line)
                        if len(buf) == batch_size:
                            yield np.loadtxt(buf, delimiter=",", dtype=np.float32, ndmin=2)
                            buf = []
                if buf:
                    yield np.loadtxt(buf, delimiter=",", dtype=np.float32, ndmin=2)

        return LabeledData(StreamDataset(batches, n, name=name, prefetch=PREFETCH, device=dev),
                           Dataset(labels, name=name + "-labels", device=dev))

    @staticmethod
    def synthetic(n: int = 4096, num_classes: int = NUM_CLASSES, seed: int = 0, device="cuda") -> LabeledData:
        """``synthetic_arrays`` as a LabeledData on ``device``."""
        dev = resolve_device(device)
        x, labels = TimitFeaturesDataLoader.synthetic_arrays(n, num_classes, seed)
        name = f"timit-synth-n{n}-c{num_classes}-s{seed}"
        return LabeledData(Dataset(x, name=name, device=dev), Dataset(labels, name=name + "-labels", device=dev))

    @staticmethod
    def synthetic_arrays(n: int = 4096, num_classes: int = NUM_CLASSES, seed: int = 0):
        """(x (n, 440) f32, labels (n,) int32) by the reference's formula:
        fixed seeded class prototypes plus 0.8·normal noise, so train and
        test share the class structure and match the reference row for row."""
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, num_classes, size=n)
        prototypes = np.random.default_rng(1234).normal(size=(num_classes, DIM)).astype(np.float32)
        x = prototypes[labels] + 0.8 * rng.normal(size=(n, DIM)).astype(np.float32)
        return x, labels.astype(np.int32)
