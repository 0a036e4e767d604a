"""Random matrices and numeric test helpers (counterpart of
``keystone_tpu/utils/stats.py``; reference utils/Stats.scala).  The
random matrices take a seeded ``torch.Generator`` where the reference
takes a key; they are other draws than the reference's."""

from __future__ import annotations

import numpy as np
import torch


def about_eq(a, b, thresh: float = 1e-8) -> bool:
    """|a − b| ≤ thresh everywhere, shapes equal (Stats.aboutEq)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return False
    return bool(np.all(np.abs(a - b) <= thresh))


def rand_matrix_gaussian(generator: torch.Generator, rows: int, cols: int, dtype=torch.float32) -> torch.Tensor:
    return torch.randn((rows, cols), generator=generator, dtype=dtype)


def rand_matrix_uniform(generator: torch.Generator, rows: int, cols: int, dtype=torch.float32) -> torch.Tensor:
    return torch.rand((rows, cols), generator=generator, dtype=dtype)


def rand_matrix_cauchy(generator: torch.Generator, rows: int, cols: int, dtype=torch.float32) -> torch.Tensor:
    """Standard Cauchy draws (CosineRandomFeatures' Laplacian variant)."""
    return torch.empty((rows, cols), dtype=dtype).cauchy_(generator=generator)
