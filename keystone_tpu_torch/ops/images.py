"""Image scalers (counterpart of ``keystone_tpu/ops/images.py``
§ PixelScaler, GrayScaler).  Images are NHWC, as in the reference."""

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

    def apply_batch(self, xs, mask=None):
        if self.only_if_integer and xs.is_floating_point():
            return xs.to(torch.float32)
        return xs.to(torch.float32) / self.scale


class GrayScaler(Transformer):
    """NHWC → NHW luminance via the channel mean (nodes/images/GrayScaler.scala)."""

    def apply_batch(self, xs, mask=None):
        if xs.ndim == 3 or xs.shape[-1] == 1:
            return xs.reshape(xs.shape[:3])
        return xs.mean(dim=-1)
