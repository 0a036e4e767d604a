"""TIMIT frames (counterpart of ``keystone_tpu/loaders/timit.py``; the
synthetic generator only): 440-d MFCC frames (40-d filterbank × 11-frame
context window) with per-frame labels over 147 phone states."""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 147
DIM = 440


def synthetic(n: int = 4096, num_classes: int = NUM_CLASSES, seed: int = 0):
    """(x (n, 440) f32, labels (n,) int32) by the reference's formula:
    fixed seeded class prototypes plus 0.8·normal noise, so train and
    test share the class structure and match the reference row for row."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n)
    prototypes = np.random.default_rng(1234).normal(size=(num_classes, DIM)).astype(np.float32)
    x = prototypes[labels] + 0.8 * rng.normal(size=(n, DIM)).astype(np.float32)
    return x, labels.astype(np.int32)
