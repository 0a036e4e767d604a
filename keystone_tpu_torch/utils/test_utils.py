"""Test fixture generators (counterpart of ``keystone_tpu/utils/test_utils.py``;
reference src/test/scala/utils/TestUtils.scala): random images
(``genChannelMajorArrayVectorizedImage``) and known-content images
(``loadTestImage``).  The repo carries no binary fixtures, so
``load_test_image`` draws deterministic procedural images (gradient,
checkerboard, blobs), small and stable across runs.  The images are the
reference's values exactly: drawn with numpy, then placed on ``device``,
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np

from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.utils.image import Image, image_from_array


def _on(arr: np.ndarray, device) -> Image:
    return Image(image_from_array(arr).data.to(resolve_device(device)))


def gen_image(height: int = 16, width: int = 16, channels: int = 3, seed: int = 0, device="cuda") -> Image:
    """A random (H, W, C) image with values in [0, 1)."""
    rng = np.random.default_rng(seed)
    return _on(rng.uniform(size=(height, width, channels)).astype(np.float32), device)


def gen_image_batch(n: int = 4, height: int = 16, width: int = 16, channels: int = 3, seed: int = 0) -> np.ndarray:
    """An (N, H, W, C) float32 batch of random images, as numpy (host data
    a test hands to either package)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, height, width, channels)).astype(np.float32)


def load_test_image(name: str = "gradient", size: int = 32, device="cuda") -> Image:
    """A deterministic known-content test image.

    ``gradient``     — channel 0 ramps along x, channel 1 along y,
                       channel 2 radial.
    ``checkerboard`` — 4-pixel checker tiles, all channels equal.
    ``blobs``        — two Gaussian bumps of distinct scales and places.
    """
    x = np.linspace(0.0, 1.0, size, dtype=np.float32)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    if name == "gradient":
        r = np.sqrt((xx - 0.5) ** 2 + (yy - 0.5) ** 2) / np.sqrt(0.5)
        img = np.stack([xx, yy, r.astype(np.float32)], axis=-1)
    elif name == "checkerboard":
        tile = ((xx * size // 4).astype(int) + (yy * size // 4).astype(int)) % 2
        img = np.repeat(tile[:, :, None].astype(np.float32), 3, axis=-1)
    elif name == "blobs":
        b1 = np.exp(-(((xx - 0.3) ** 2 + (yy - 0.3) ** 2) / 0.02))
        b2 = np.exp(-(((xx - 0.7) ** 2 + (yy - 0.65) ** 2) / 0.08))
        g = (b1 + 0.6 * b2).astype(np.float32)
        img = np.stack([g, g, g], axis=-1)
    else:
        raise ValueError(f"unknown test image {name!r}: gradient | checkerboard | blobs")
    return _on(img, device)
