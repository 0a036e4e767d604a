"""The compute-bound (GIL-held) featurizer of serve_bench's
threads-against-processes A/B (counterpart of ``tools/gilburn.py``).

``GilBurnFeature`` lives in a module of its own, at module level, so
that a process fleet's spawned workers unpickle it from the staged
payload by importing this module alone.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from keystone_tpu_torch.workflow.transformer import Transformer


class GilBurnFeature(Transformer):
    """A deterministic per-row featurizer that holds the GIL: each row is
    scaled by ``0.5 + crc_mix(row) / 2``, where ``crc_mix`` chains
    ``rounds`` CRC32 passes over the row's float32 bytes (interpreter
    work, no BLAS, no GIL release, as tokenizing and n-gram stages are).
    Integer CRC arithmetic on exact bytes, then one float32 product: the
    reference's bytes, whichever fleet runs it.  It runs on the host and
    returns the rows on the device they came from."""

    #: host Python work: the stage fuser must not fold it into a chain
    fusable = False

    def __init__(self, rounds: int = 300):
        super().__init__()
        self.rounds = int(rounds)

    def params(self):
        return (self.rounds,)

    def _burn(self, row_bytes: bytes) -> float:
        h = zlib.crc32(row_bytes)
        for _ in range(self.rounds):
            h = zlib.crc32(row_bytes, h)
        return (h % 1000003) / 1000003.0

    def _scale_rows(self, xs: np.ndarray) -> np.ndarray:
        xs = np.ascontiguousarray(xs, dtype=np.float32)
        out = np.empty_like(xs)
        for i in range(xs.shape[0]):
            out[i] = xs[i] * np.float32(0.5 + 0.5 * self._burn(xs[i].tobytes()))
        return out

    def apply_batch(self, xs, mask=None):
        t = torch.as_tensor(xs)
        return torch.from_numpy(self._scale_rows(t.detach().cpu().numpy())).to(t.device)

    def apply_one(self, x):
        return self.apply_batch(torch.as_tensor(x)[None])[0]
