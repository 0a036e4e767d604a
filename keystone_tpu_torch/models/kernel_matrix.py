"""Kernel matrix as cached blocks (counterpart of
``keystone_tpu/models/kernel_matrix.py`` § BlockKernelMatrix).

K(X, X) is exposed as (row-block, col-block) tiles and whole column
blocks, computed on demand by the gram kernels and kept in device-memory
LRUs; the full n×n matrix is never formed unless the cache holds it.  The
disk tier (``spill_dir``) needs ``utils/durable`` and is not ported
(ROADMAP A9).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import torch

from keystone_tpu_torch.ops.gram_kernels import gram_block_for


class BlockKernelMatrix:
    """K(X, X) as (row-block, col-block) tiles with LRU caching."""

    def __init__(
        self,
        kernel_gen,
        x: torch.Tensor,
        block_size: int = 1024,
        cache_blocks: int = 8,
        spill_dir: Optional[str] = None,
        use_kernel: Optional[bool] = None,
    ):
        if spill_dir is not None:
            raise NotImplementedError(
                "the BlockKernelMatrix disk tier needs utils/durable, which the port "
                "does not have yet (ROADMAP A9)"
            )
        self.kernel_gen = kernel_gen
        self.x = x.to(torch.float32).contiguous()
        self.block_size = int(block_size)
        self.n = self.x.shape[0]
        self.num_blocks = -(-self.n // self.block_size)
        self.use_kernel = use_kernel
        self._cache: "OrderedDict[Tuple[int, int], torch.Tensor]" = OrderedDict()
        self._cache_blocks = int(cache_blocks)
        # assembled (n, bs) column blocks, cached whole: the BCD sweep
        # rereads columns across epochs
        self._col_cache: "OrderedDict[int, torch.Tensor]" = OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0

    def _compute(self, a, b_rows):
        """One gram block.  First-class generators (Gaussian, polynomial,
        linear) go through ``gram_block_for`` on every device: the kernel
        on the card, the plain version on the CPU.  Operands stream f32:
        the reference streams scoring generators in its apply mode, which
        is f32 in the port.  Duck-typed generators are called as they are."""
        kg = self.kernel_gen
        out = gram_block_for(kg, a, b_rows, use_kernel=self.use_kernel)
        return kg(a, b_rows) if out is None else out

    def _rows(self, b: int) -> torch.Tensor:
        lo = b * self.block_size
        return self.x[lo:lo + self.block_size]

    def _cached_columns(self) -> bool:
        """Whole columns are cached when a full sweep's columns fit the budget."""
        return self.num_blocks * self.num_blocks <= self._cache_blocks

    def block(self, i: int, j: int) -> torch.Tensor:
        """K[X_i, X_j] — (<=bs, <=bs)."""
        key = (i, j)
        if key in self._cache:
            self._cache.move_to_end(key)
            self.cache_hits += 1
            return self._cache[key]
        self.cache_misses += 1
        blk = self._compute(self._rows(i), self._rows(j))
        self._cache[key] = blk
        if len(self._cache) > self._cache_blocks:
            self._cache.popitem(last=False)
        return blk

    def column_block(self, j: int) -> torch.Tensor:
        """K[:, X_j] — (n, <=bs); the unit the BCD sweep consumes.  Cached
        whole when a full sweep's columns fit the budget (num_blocks² tiles
        ≤ cache_blocks); otherwise computed without caching, since a sweep
        would insert and then evict every entry."""
        if self.num_blocks == 0:
            return torch.zeros((0, 0), dtype=torch.float32, device=self.x.device)
        if not self._cached_columns():
            return self._compute(self.x, self._rows(j))
        blk = self._col_cache.get(j)
        if blk is None:
            self.cache_misses += 1
            blk = self._compute(self.x, self._rows(j))
            self._col_cache[j] = blk
            if len(self._col_cache) > self.num_blocks:
                self._col_cache.popitem(last=False)
        else:
            self.cache_hits += 1
            self._col_cache.move_to_end(j)
        return blk

    def diag_block(self, j: int) -> torch.Tensor:
        """K[X_j, X_j]; reads through the column cache when columns are
        cached, so one budget serves every access path."""
        if self._cached_columns():
            lo = j * self.block_size
            return self.column_block(j)[lo:lo + self.block_size]
        return self.block(j, j)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """K @ v computed blockwise; reads through the column cache when a
        full sweep fits the budget, otherwise streams column gemms."""
        out = torch.zeros((self.n,) + tuple(v.shape[1:]), dtype=torch.float32, device=self.x.device)
        for j in range(self.num_blocks):
            lo = j * self.block_size
            out += self.column_block(j) @ v[lo:lo + self.block_size]
        return out
