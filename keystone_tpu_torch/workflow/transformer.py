"""Minimal transformer base (counterpart of
``keystone_tpu/workflow/transformer.py``: apply only, no jit, no graph).

A stage maps a batch ``xs`` (and, for ragged descriptor sets, a mask of
shape ``(n, T)``) to a batch.  A stage that keeps the mask returns
``(out, mask)``; one that reduces the sets to dense rows returns ``out``.
Fitted arrays are registered buffers (``register_buffer`` also takes
None for an optional array), so ``.to(device)`` moves them.
"""

from __future__ import annotations

from torch import nn


class Transformer(nn.Module):
    def apply_batch(self, xs, mask=None):
        raise NotImplementedError

    def forward(self, xs, mask=None):
        return self.apply_batch(xs, mask=mask)

    @property
    def label(self) -> str:
        return type(self).__name__
