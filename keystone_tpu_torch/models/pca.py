"""PCA projection (counterpart of ``keystone_tpu/models/pca.py`` § PCATransformer)."""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.workflow.transformer import Transformer


class PCATransformer(Transformer):
    """Projects onto the fitted principal directions: x ↦ (x − μ)·C."""

    def __init__(self, components: torch.Tensor, mean: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("components", components)  # (d_in, d)
        self.register_buffer("mean", mean)  # (d_in,) or None

    def apply_batch(self, xs, mask=None):
        if self.mean is not None:
            xs = xs - self.mean
        out = torch.matmul(xs.to(torch.float32), self.components)
        return (out, mask) if mask is not None else out
