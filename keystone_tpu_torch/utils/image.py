"""Image representation and batched image helpers (counterpart of
``keystone_tpu/utils/image.py``; reference utils/Image.scala and
ImageUtils.scala).  An image is a dense (H, W, C) tensor, NHWC when
batched; ``Image`` is a thin wrapper that carries its metadata at
pipeline boundaries, and every op takes and returns bare tensors."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ImageMetadata:
    """Dimensions record (utils/Image.scala § ImageMetadata)."""

    x_dim: int  # height
    y_dim: int  # width
    num_channels: int

    @property
    def shape(self):
        return (self.x_dim, self.y_dim, self.num_channels)


@dataclasses.dataclass(frozen=True)
class Image:
    """An (H, W, C) image."""

    data: torch.Tensor

    @property
    def metadata(self) -> ImageMetadata:
        h, w, c = self.data.shape
        return ImageMetadata(h, w, c)

    def get(self, x: int, y: int, c: int):
        return self.data[x, y, c]

    def to_vector(self) -> torch.Tensor:
        return self.data.reshape(-1)


def image_from_array(arr) -> Image:
    arr = torch.as_tensor(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"expected (H,W[,C]) array, got shape {tuple(arr.shape)}")
    return Image(arr)


def grayscale(images: torch.Tensor) -> torch.Tensor:
    """The channel mean of batched NHWC images, as the reference's
    GrayScaler takes it (not Rec.601 weights)."""
    if images.shape[-1] == 1:
        return images[..., 0]
    return images.mean(dim=-1)


def to_numpy(img) -> np.ndarray:
    data = img.data if isinstance(img, Image) else img
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def crop(images: torch.Tensor, y0: int, x0: int, h: int, w: int) -> torch.Tensor:
    """Crop batched NHWC (or HWC) images."""
    if images.ndim == 3:
        return images[y0:y0 + h, x0:x0 + w, :]
    return images[:, y0:y0 + h, x0:x0 + w, :]


def flip_horizontal(images: torch.Tensor) -> torch.Tensor:
    return torch.flip(images, dims=(-2,) if images.ndim >= 3 else (1,))


def flip_vertical(images: torch.Tensor) -> torch.Tensor:
    return torch.flip(images, dims=(-3,) if images.ndim >= 3 else (0,))


def map_pixels(images: torch.Tensor, fn) -> torch.Tensor:
    """Elementwise pixel transform (ImageUtils.mapPixels)."""
    return fn(images)


def pixel_stats(images: torch.Tensor):
    """(mean, std) per channel over every other axis; the std is the
    population one (n denominator), as the reference's."""
    dims = tuple(range(images.ndim - 1))
    return images.mean(dim=dims), images.std(dim=dims, correction=0)
