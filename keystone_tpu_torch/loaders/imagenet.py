"""ImageNet-style images (counterpart of ``keystone_tpu/loaders/imagenet.py``;
the synthetic generator only).  Loading tar archives of JPEGs waits for
a decoder (ROADMAP A13): the reference decodes with PIL or its native
library, neither of which the port has."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.utils.device import resolve_device


class ImageNetLoader:
    @staticmethod
    def synthetic(
        n: int = 64,
        num_classes: int = 16,
        size: Tuple[int, int] = (64, 64),
        seed: int = 0,
        device="cuda",
    ) -> LabeledData:
        """``synthetic_arrays`` as a LabeledData: (n, H, W, 3) uint8 images
        and (n,) int32 labels, Datasets on ``device``."""
        pixels, labels = ImageNetLoader.synthetic_arrays(n, num_classes, size, seed)
        return LabeledData.of(pixels, labels, resolve_device(device))

    @staticmethod
    def synthetic_arrays(
        n: int = 64,
        num_classes: int = 16,
        size: Tuple[int, int] = (64, 64),
        seed: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(pixels (n, H, W, 3) uint8, labels (n,) int32): class-structured
        textures (oriented gratings and a colour per class), so that SIFT
        and LCS features carry the label; pixel for pixel the reference's."""
        labels, pixels = _synth_all(n, num_classes, size, seed)
        return pixels, labels.astype(np.int32)


def _synth_image(
    c: int, num_classes: int, size: Tuple[int, int], rng: np.random.Generator
) -> np.ndarray:
    """One class-structured texture image (uint8).  Draws exactly one
    uniform (phase) then one normal block (noise) from ``rng``."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    angle = np.pi * c / num_classes
    freq = 0.2 + 0.05 * (c % 4)
    phase = rng.uniform(0, 2 * np.pi)
    grating = 0.5 + 0.5 * np.sin(
        freq * (np.cos(angle) * xx + np.sin(angle) * yy) + phase
    )
    color = 0.3 + 0.6 * np.array([((c >> b) & 1) for b in range(3)], np.float32)
    img = grating[..., None] * color[None, None, :]
    img += 0.05 * rng.normal(size=(h, w, 3))
    return np.rint(np.clip(img, 0, 1) * 255.0).astype(np.uint8)


def _synth_all(
    n: int, num_classes: int, size: Tuple[int, int], seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n)
    pixels = np.stack(
        [_synth_image(labels[i], num_classes, size, rng) for i in range(n)]
    )
    return labels, pixels
