"""Block linear scoring (counterpart of ``keystone_tpu/models/block_ls.py``
§ BlockLinearMapper, _block_predict, _offset; apply only)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from keystone_tpu_torch.workflow.transformer import Transformer


class BlockLinearMapper(Transformer):
    """Per-block weights summed into one prediction.  ``weights`` is
    (num_blocks, block_size, k); blocks are contiguous column ranges, so
    the sum of per-block partials is one flat product."""

    def __init__(
        self,
        weights: torch.Tensor,
        block_size: int,
        intercept: Optional[torch.Tensor] = None,
        feature_mean: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        self.block_size = int(block_size)
        self.register_buffer("weights", weights)
        self.register_buffer("intercept", intercept)
        self.register_buffer("feature_mean", feature_mean)

    def apply_batch(self, xs, mask=None):
        return _block_predict(xs, self.weights, self.intercept, self.feature_mean)


def _offset(weights, feature_mean, intercept):
    off = 0.0
    if feature_mean is not None:
        nb, bs, k = weights.shape
        pad = nb * bs - feature_mean.shape[0]
        if pad > 0:  # mean given at true d; weights are block-padded
            feature_mean = F.pad(feature_mean, (0, pad))
        off = off - feature_mean @ weights.reshape(nb * bs, k)
    if intercept is not None:
        off = off + intercept
    return off


def _block_predict(xs, weights, intercept, feature_mean):
    xs = xs.to(torch.float32)
    nb, bs, k = weights.shape
    d = xs.shape[-1]
    if nb * bs != d:
        xs = F.pad(xs, (0, nb * bs - d))
    out = torch.matmul(xs, weights.reshape(nb * bs, k))
    return out + _offset(weights, feature_mean, intercept)
