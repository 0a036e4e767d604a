"""Matrix helpers (counterpart of ``keystone_tpu/utils/matrix.py``;
reference utils/MatrixUtils.scala).  A Dataset is already an (n, d)
tensor, so these serve host and ingest boundaries."""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch


def rows_to_matrix(rows: Iterable) -> torch.Tensor:
    """Stack row vectors into an (n, d) matrix."""
    rows = list(rows)
    if not rows:
        return torch.zeros((0, 0), dtype=torch.float32)
    return torch.stack([torch.as_tensor(r) for r in rows])


def matrix_to_rows(mat) -> list:
    """The rows of ``mat`` (MatrixUtils § matrixToRowArray)."""
    return [mat[i] for i in range(mat.shape[0])]


matrix_to_row_array = matrix_to_rows  # the reference's name


def shuffle_rows(mat, seed: int = 0) -> torch.Tensor:
    """The rows permuted by ``np.random.default_rng(seed)``, the
    reference's permutation."""
    mat = torch.as_tensor(mat)
    perm = np.random.default_rng(seed).permutation(mat.shape[0])
    return mat[torch.from_numpy(perm).to(mat.device)]


def block_ranges(dim: int, block_size: int) -> Sequence[tuple]:
    """[(start, end), ...] covering ``dim`` in blocks of ``block_size``: the
    block solvers' feature blocks (nodes/util/VectorSplitter.scala)."""
    return [(s, min(s + block_size, dim)) for s in range(0, dim, block_size)]
