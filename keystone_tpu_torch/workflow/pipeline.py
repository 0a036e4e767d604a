"""Apply-only pipelines (counterpart of ``keystone_tpu/workflow/pipeline.py``
for a fitted scorer: no fit, no optimizer).

``Pipeline.of(a).and_then(b)`` chains stages; ``Pipeline.gather([p, q])``
runs branches on the same input and concatenates their dense outputs
along the last axis, as the reference scorer's ``gather`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from keystone_tpu_torch.workflow.transformer import Transformer


def _apply(stage: Transformer, xs, mask):
    out = stage.apply_batch(xs, mask=mask)
    if isinstance(out, tuple):
        return out
    return out, None


class Pipeline(Transformer):
    def __init__(self, stages: Sequence[Transformer]):
        super().__init__()
        self.stages = nn.ModuleList(stages)

    @staticmethod
    def of(stage: Transformer) -> "Pipeline":
        return Pipeline([stage])

    @staticmethod
    def gather(branches: Sequence["Pipeline"]) -> "Gather":
        return Gather(branches)

    def and_then(self, nxt: Transformer) -> "Pipeline":
        return Pipeline([*self.stages, nxt])

    def apply_batch(self, xs, mask=None):
        for stage in self.stages:
            xs, mask = _apply(stage, xs, mask)
        return xs if mask is None else (xs, mask)

    @property
    def label(self) -> str:
        return " > ".join(s.label for s in self.stages)


class Gather(Transformer):
    """Branches over one input; dense outputs concatenated on the last axis."""

    def __init__(self, branches: Sequence[Pipeline]):
        super().__init__()
        self.branches = nn.ModuleList(branches)

    def apply_batch(self, xs, mask=None):
        outs = []
        for b in self.branches:
            out, out_mask = _apply(b, xs, mask)
            if out_mask is not None:
                raise ValueError(
                    f"gather needs dense branch outputs; {b.label} kept a mask"
                )
            outs.append(out)
        return torch.cat(outs, dim=-1)

    @property
    def label(self) -> str:
        return "Gather[" + ", ".join(b.label for b in self.branches) + "]"
