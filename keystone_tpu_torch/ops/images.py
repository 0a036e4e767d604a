"""Image ops (counterpart of ``keystone_tpu/ops/images.py``
§ PixelScaler, GrayScaler, ImageVectorizer, CenterCornerPatcher).  Images are NHWC, as in
the reference."""

from __future__ import annotations

import torch

from keystone_tpu_torch.workflow.transformer import Transformer


class PixelScaler(Transformer):
    """uint8 pixels → [0,1] floats (nodes/images/PixelScaler.scala).

    ``only_if_integer=True`` divides only integer inputs and passes
    floating inputs through as f32, so a pipeline that is fed uint8 also
    accepts images already in [0, 1]."""

    def __init__(self, scale: float = 255.0, only_if_integer: bool = False):
        super().__init__()
        self.scale = float(scale)
        self.only_if_integer = bool(only_if_integer)

    def params(self):
        return (self.scale, self.only_if_integer)

    def apply_batch(self, xs, mask=None):
        if self.only_if_integer and xs.is_floating_point():
            return xs.to(torch.float32)
        return xs.to(torch.float32) / self.scale


class GrayScaler(Transformer):
    """NHWC → NHW luminance via the channel mean (nodes/images/GrayScaler.scala)."""

    def params(self):
        return ()

    def apply_batch(self, xs, mask=None):
        if xs.ndim == 3 or xs.shape[-1] == 1:
            return xs.reshape(xs.shape[:3])
        return xs.mean(dim=-1)


class ImageVectorizer(Transformer):
    """Image → flat vector (nodes/images/ImageVectorizer.scala)."""

    def params(self):
        return ()

    def apply_batch(self, xs, mask=None):
        return xs.reshape(xs.shape[0], -1)


class CenterCornerPatcher(Transformer):
    """Center + 4 corner crops, optionally horizontally flipped
    (nodes/images/CenterCornerPatcher.scala) — the 10-view test-time
    augmentation for ImageNet.  Output: (n, num_views, ph, pw, C)."""

    def __init__(self, patch_h: int, patch_w: int, horizontal_flips: bool = False):
        super().__init__()
        self.patch_h = int(patch_h)
        self.patch_w = int(patch_w)
        self.horizontal_flips = bool(horizontal_flips)

    def params(self):
        return (self.patch_h, self.patch_w, self.horizontal_flips)

    def apply_batch(self, xs, mask=None):
        if xs.ndim == 3:
            xs = xs[..., None]
        _, h, w, _ = xs.shape
        ph, pw = self.patch_h, self.patch_w
        starts = [(0, 0), (0, w - pw), (h - ph, 0), (h - ph, w - pw), ((h - ph) // 2, (w - pw) // 2)]
        views = [xs[:, y:y + ph, x:x + pw, :] for (y, x) in starts]
        if self.horizontal_flips:
            views += [torch.flip(v, dims=(2,)) for v in views]
        return torch.stack(views, dim=1)
