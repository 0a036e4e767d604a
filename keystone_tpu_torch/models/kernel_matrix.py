"""Kernel matrix as cached blocks (counterpart of
``keystone_tpu/models/kernel_matrix.py`` § BlockKernelMatrix).

K(X, X) is exposed as (row-block, col-block) tiles and whole column
blocks, computed on demand by the gram kernels and kept in device-memory
LRUs; the full n×n matrix is never formed unless the cache holds it.
With ``spill_dir`` the column blocks go tiered: each computed column is
published to disk through ``utils/durable`` and at most ``hbm_cols`` of
them stay on the device, so K may exceed the card's memory and later
sweeps reread it from disk instead of recomputing its gemms.  The spill
is counted twice: on the matrix (``spill_reads``, ``spill_writes``,
``spill_corruption``) and, as the reference counts it, in the metrics
registry (``kernel.spill_reads``, ``kernel.spill_read_bytes``,
``kernel.spill_writes``, ``kernel.spill_write_bytes``,
``kernel.spill_corruption``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import numbers
import os
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.ops.gram_kernels import gram_block_for
from keystone_tpu_torch.utils import durable


class BlockKernelMatrix:
    """K(X, X) as (row-block, col-block) tiles with LRU caching."""

    def __init__(
        self,
        kernel_gen,
        x: torch.Tensor,
        block_size: int = 1024,
        cache_blocks: int = 8,
        spill_dir: Optional[str] = None,
        hbm_cols: int = 1,
        use_kernel: Optional[bool] = None,
    ):
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
        #: the disk tier: computed columns persist as npy files, the
        #: device holds an LRU of up to ``hbm_cols`` of them, and an
        #: evicted column reloads from disk instead of recomputing
        self.spill_dir = spill_dir
        self.hbm_cols = max(1, int(hbm_cols))
        self.cache_hits = 0  # device LRU hits
        self.cache_misses = 0
        self.spill_reads = 0  # columns reread from disk
        self.spill_writes = 0
        self.spill_corruption = 0  # damaged spill files found, removed and recomputed
        if spill_dir is not None:
            self._init_spill_dir(spill_dir)

    def _compute(self, a, b_rows):
        """One gram block.  First-class generators (Gaussian, polynomial,
        linear) go through ``gram_block_for`` on every device: the kernel
        on the card, the plain version on the CPU.  Operands stream f32:
        the reference streams scoring generators in its apply mode, which
        is f32 in the port.  Duck-typed generators are called as they are."""
        kg = self.kernel_gen
        out = gram_block_for(kg, a, b_rows, use_kernel=self.use_kernel)
        return kg(a, b_rows) if out is None else out

    def _fingerprint(self) -> str:
        """The spilled columns' problem: n, the blocking, the generator's
        type and every scalar parameter (through f32, as the kernel
        computes), the data's shape and its first and last rows, as the
        reference fingerprints them."""
        kg = self.kernel_gen
        if dataclasses.is_dataclass(kg):
            raw, strict = dataclasses.asdict(kg), True
        else:  # duck-typed: public non-callable attributes, properties included
            raw = {}
            for pk in dir(type(kg)):
                if pk.startswith("_"):
                    continue
                try:
                    pv = getattr(kg, pk)
                except Exception:
                    continue
                if not callable(pv):
                    raw[pk] = pv
            for pk, pv in getattr(kg, "__dict__", {}).items():
                if not pk.startswith("_") and not callable(pv):
                    raw[pk] = pv
            strict = False
        kp = {}
        for pk, pv in raw.items():
            if isinstance(pv, (str, tuple)):
                kp[pk] = pv
            elif isinstance(pv, numbers.Number):
                kp[pk] = float(np.float32(pv))
            elif strict:
                raise TypeError(f"kernel generator field {pk!r} ({type(pv).__name__}) cannot be fingerprinted "
                                "for the spill dir; use scalar/str/tuple fields or manage the cache dir per problem")
        h = hashlib.sha256()
        h.update(repr((self.n, self.block_size, type(kg).__name__, tuple(sorted(kp.items())),
                       tuple(self.x.shape))).encode())
        h.update(self.x[:1].cpu().numpy().tobytes())
        h.update(self.x[-1:].cpu().numpy().tobytes())
        return h.hexdigest()

    def _init_spill_dir(self, spill_dir: str) -> None:
        """Create or reuse the disk tier.  A directory fingerprinted for
        this problem is reused as it is; one of another problem is
        cleared of the files this cache owns (``kcol_*.npy``, their
        sidecars and abandoned temporaries, ``kcache_meta.json``), and one
        holding anything else (dotfiles aside) is refused, not clobbered.
        Processes may share a directory only for the same problem."""
        fingerprint = self._fingerprint()
        meta_path = os.path.join(spill_dir, "kcache_meta.json")
        if os.path.isdir(spill_dir):
            try:
                with open(meta_path) as f:
                    if json.load(f).get("fingerprint") == fingerprint:
                        return
            except (OSError, ValueError):
                pass
            entries = os.listdir(spill_dir)
            owned = [e for e in entries if e == "kcache_meta.json" or (e.startswith("kcol_") and ".npy" in e)]
            foreign = [e for e in entries if e not in owned and not e.startswith(".")]
            if foreign:
                raise ValueError(
                    f"kernel spill dir {spill_dir!r} (kernel_cache_dir at the estimator level) holds files this "
                    f"cache does not own ({foreign[:5]}{'...' if len(foreign) > 5 else ''}); refusing to clear "
                    "it — pass an empty or dedicated directory")
            for e in owned:
                os.remove(os.path.join(spill_dir, e))
        os.makedirs(spill_dir, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump({"fingerprint": fingerprint}, f)

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
        ≤ cache_blocks); else through the disk tier when there is one;
        otherwise computed without caching, since a sweep would insert and
        then evict every entry."""
        if self.num_blocks == 0:
            return torch.zeros((0, 0), dtype=torch.float32, device=self.x.device)
        if not self._cached_columns():
            if self.spill_dir is not None:
                return self._column_via_disk(j)
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

    def _column_via_disk(self, j: int) -> torch.Tensor:
        """Device LRU, then disk, then compute and persist.  A spill file
        is published atomically with a checksum sidecar and reread with
        retries; a torn or damaged one (checksum or shape) is counted,
        removed and recomputed, not trusted."""
        blk = self._col_cache.get(j)
        if blk is not None:
            self.cache_hits += 1
            self._col_cache.move_to_end(j)
            return blk
        self.cache_misses += 1
        path = os.path.join(self.spill_dir, f"kcol_{j:05d}.npy")
        expected = (self.n, self._rows(j).shape[0])
        if os.path.exists(path):

            def read():
                durable.verify_checksum(path)
                raw = np.load(path)
                if raw.shape != expected:
                    raise durable.CorruptStateError(f"kernel spill column {path} has shape {raw.shape}, "
                                                    f"expected {expected}")
                return raw

            try:
                raw = durable.with_retries(read, description=f"kernel spill read {path}")
                self.spill_reads += 1
                metrics.inc("kernel.spill_reads")
                metrics.inc("kernel.spill_read_bytes", int(raw.nbytes))
                blk = torch.from_numpy(raw).to(self.x.device)
            except durable.CorruptStateError:
                self.spill_corruption += 1
                metrics.inc("kernel.spill_corruption")
                for p in (path, durable.checksum_path(path)):
                    try:
                        os.remove(p)
                    except OSError:
                        pass  # the rewrite below replaces both
        if blk is None:
            blk = self._compute(self.x, self._rows(j))
            host = blk.cpu().numpy()

            def write(tmp):
                with open(tmp, "wb") as f:
                    np.save(f, host)

            durable.atomic_write(path, write)
            self.spill_writes += 1
            metrics.inc("kernel.spill_writes")
            metrics.inc("kernel.spill_write_bytes", int(host.nbytes))
        self._col_cache[j] = blk
        if len(self._col_cache) > self.hbm_cols:
            self._col_cache.popitem(last=False)  # the evicted column stays on disk
        return blk

    def diag_block(self, j: int) -> torch.Tensor:
        """K[X_j, X_j]; reads through the column cache when columns are
        cached or spilled, so one budget serves every access path."""
        if self._cached_columns() or self.spill_dir is not None:
            lo = j * self.block_size
            return self.column_block(j)[lo:lo + self.block_size]
        return self.block(j, j)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """K @ v computed blockwise; reads through the column cache when a
        full sweep fits the budget (or the disk tier), otherwise streams
        column gemms."""
        out = torch.zeros((self.n,) + tuple(v.shape[1:]), dtype=torch.float32, device=self.x.device)
        for j in range(self.num_blocks):
            lo = j * self.block_size
            out += self.column_block(j) @ v[lo:lo + self.block_size]
        return out
