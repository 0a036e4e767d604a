"""MNIST loader (counterpart of ``keystone_tpu/loaders/mnist.py``): the CSV
format the reference's MnistRandomFFT reads through
loaders/CsvDataLoader.scala, rows of `label, 784 pixel values`."""

from __future__ import annotations

import numpy as np

from keystone_tpu_torch.loaders.csv_loader import CsvDataLoader
from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.loaders.stream import PREFETCH
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset

NUM_CLASSES = 10
DIM = 784


class MnistLoader:
    @staticmethod
    def load(path: str, device="cuda") -> LabeledData:
        return CsvDataLoader.load(path, label_col=0, device=device)

    @staticmethod
    def stream(path: str, batch_size: int = 4096, prefetch: int = PREFETCH, device="cuda") -> LabeledData:
        """Out of core: the CSV rows re-parsed every sweep."""
        return CsvDataLoader.stream(path, label_col=0, batch_size=batch_size, prefetch=prefetch, device=device)

    @staticmethod
    def synthetic(n: int = 2048, seed: int = 0, device="cuda") -> LabeledData:
        """``synthetic_arrays`` as a LabeledData on ``device``."""
        dev = resolve_device(device)
        x, labels = MnistLoader.synthetic_arrays(n, seed)
        name = f"mnist-synth-n{n}-s{seed}"
        return LabeledData(Dataset(x, name=name, device=dev), Dataset(labels, name=name + "-labels", device=dev))

    @staticmethod
    def synthetic_arrays(n: int = 2048, seed: int = 0):
        """(x (n, 784) f32 in [0, 255], labels (n,) int32): class prototypes
        from a fixed generator (so every seed draws from one distribution)
        scaled by 0.3, plus N(0, 25²) noise, clipped; by the reference's
        formula, row for row."""
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, NUM_CLASSES, size=n)
        prototypes = np.random.default_rng(1234).uniform(0, 255, size=(NUM_CLASSES, DIM)).astype(np.float32)
        x = prototypes[labels] * 0.3 + rng.normal(0, 25.0, size=(n, DIM)).astype(np.float32)
        return np.clip(x, 0, 255), labels.astype(np.int32)


def write_csv(path: str, images: np.ndarray, labels: np.ndarray) -> None:
    """Write rows of `label, pixels` as the MNIST CSV that ``load`` and
    ``stream`` read; pixels are written as integers (MNIST's bytes),
    rounded."""
    rows = np.concatenate([np.asarray(labels, np.int64)[:, None], np.rint(images).astype(np.int64)], axis=1)
    np.savetxt(path, rows, fmt="%d", delimiter=",")
