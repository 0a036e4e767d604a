"""CIFAR-10 binary loader (counterpart of ``keystone_tpu/loaders/cifar.py``;
reference loaders/CifarLoader.scala).

Format: records of 3073 bytes, one label byte and 3×32×32 pixel bytes in
channel-major order (the R plane, the G plane, the B plane); emitted as
NHWC floats in [0, 1].  The reference reads the file natively when its
library is built, with the same bytes as its numpy path, which is the
one taken here.
"""

from __future__ import annotations

import os

import numpy as np

from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.loaders.stream import PREFETCH
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset

NUM_CLASSES = 10
H = W = 32
C = 3
RECORD = 1 + H * W * C


class CifarLoader:
    @staticmethod
    def load(path: str, device="cuda") -> LabeledData:
        """Every record of the file, as Datasets on ``device``."""
        dev = resolve_device(device)
        raw = np.fromfile(path, dtype=np.uint8)
        if raw.size % RECORD != 0:
            raise ValueError(f"{path}: size {raw.size} not a multiple of {RECORD}")
        recs = raw.reshape(-1, RECORD)
        name = f"cifar:{os.path.abspath(path)}"
        return LabeledData(Dataset(_decode_records(recs), name=name, device=dev),
                           Dataset(recs[:, 0].astype(np.int32), name=name + "-labels", device=dev))

    @staticmethod
    def stream(path: str, batch_size: int = 1024, device="cuda") -> LabeledData:
        """Out of core: the file's size fixes ``n``, the labels come from
        one strided read of the records' first bytes, and the pixels are
        reread in ``batch_size``-record chunks each sweep."""
        dev = resolve_device(device)
        size = os.path.getsize(path)
        if size % RECORD != 0:
            raise ValueError(f"{path}: size {size} not a multiple of {RECORD}")
        n = size // RECORD
        if n == 0:  # np.memmap refuses an empty file; load gives the same empty sets
            return CifarLoader.load(path, device=dev)
        labels = np.array(np.memmap(path, dtype=np.uint8, mode="r").reshape(-1, RECORD)[:, 0], np.int32)

        def batches():
            m = np.memmap(path, dtype=np.uint8, mode="r").reshape(-1, RECORD)
            for i in range(0, n, batch_size):
                yield _decode_records(np.asarray(m[i:i + batch_size]))

        name = f"cifar-stream:{os.path.abspath(path)}:b{batch_size}"
        return LabeledData(StreamDataset(batches, n, name=name, prefetch=PREFETCH, device=dev),
                           Dataset(labels, name=name + "-labels", device=dev))

    @staticmethod
    def synthetic(n: int = 1024, seed: int = 0, device="cuda") -> LabeledData:
        """``synthetic_arrays`` as a LabeledData on ``device``."""
        dev = resolve_device(device)
        x, labels = CifarLoader.synthetic_arrays(n, seed)
        name = f"cifar-synth-n{n}-s{seed}"
        return LabeledData(Dataset(x, name=name, device=dev), Dataset(labels, name=name + "-labels", device=dev))

    @staticmethod
    def synthetic_arrays(n: int = 1024, seed: int = 0):
        """(x (n, 32, 32, 3) f32 in [0, 1], labels (n,) int32): class-coloured
        noise with a bright patch a class, by the reference's formula, so
        train and test share the class structure."""
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, NUM_CLASSES, size=n)
        base = np.random.default_rng(1234).uniform(0.2, 0.8, size=(NUM_CLASSES, 1, 1, C)).astype(np.float32)
        x = base[labels] + rng.normal(0, 0.15, size=(n, H, W, C)).astype(np.float32)
        for k in range(NUM_CLASSES):
            idx = labels == k
            y0, x0 = 3 * (k % 3) + 4, 3 * (k // 3) + 4
            x[idx, y0:y0 + 6, x0:x0 + 6, :] += 0.5
        return np.clip(x, 0, 1), labels.astype(np.int32)


def _decode_records(recs: np.ndarray) -> np.ndarray:
    """(m, RECORD) uint8 records → (m, H, W, C) float32 in [0, 1], shared by
    ``load`` and ``stream`` so that the two cannot drift."""
    return recs[:, 1:].reshape(-1, C, H, W).transpose(0, 2, 3, 1).astype(np.float32) / 255.0


def write_records(path: str, images: np.ndarray, labels: np.ndarray) -> None:
    """Write (n, 32, 32, 3) images in [0, 1] (rounded to bytes) and their
    labels as a CIFAR-10 binary file: what ``load`` and ``stream`` read."""
    pix = np.rint(np.clip(images, 0.0, 1.0) * 255.0).astype(np.uint8).transpose(0, 3, 1, 2)
    recs = np.concatenate([np.asarray(labels, np.uint8)[:, None], pix.reshape(len(pix), -1)], axis=1)
    recs.tofile(path)
