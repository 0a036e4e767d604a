"""Disk-backed block stores for the out-of-core solvers (counterpart of
``keystone_tpu/workflow/blockstore.py`` § _BlockStreamBase,
FeatureBlockStore, RowBlockStore).

The reference fits wide Fisher-vector models by caching feature blocks
and re-reading them per (epoch, block) of block coordinate descent
(nodes/learning/BlockLeastSquares.scala).  Here the features are written
once, one ``.npy`` file per column block, and re-read per sweep, so the
card holds one (n × block_size) block at a time beside the (n × k)
residual: the feature matrix may exceed device memory by any factor.

Layout of a store directory::

    meta.json         {"n": ..., "d": ..., "block_size": ..., "nb": ..., "dtype": ...}
    block_0000.npy    float32 (n, block_size), or uint16 bf16 bit patterns
    block_0000.npy.b2 the block's BLAKE2b sidecar, once sealed

The last block is zero-padded on columns to ``block_size``, so every
block has one shape.  ``dtype="bfloat16"`` halves the bytes on disk and
on the host-to-device wire; a block is widened to f32 on the card,
after its copy.

``iter_device_blocks`` is the card's feed: pinned host buffers and a side
copy stream carry the copies, an event per block makes the compute
stream wait for its copy, and ``_WINDOW`` bounds the blocks in flight.
``RowBlockStore`` is the kernel tier's: the same matrix split by example
rows, one ``(block_size, d)`` file a row block, which the out-of-core
kernel sweep streams through the same feed.  Both layouts are the
reference's own, so a store written by either package reads in the
other.

Fault sites (``keystone_tpu_torch.faults``): ``blockstore.write`` after
each block file's rows are written, ``blockstore.read`` inside each
read's retry scope.  Counters: ``blockstore.writes``, ``write_bytes``,
``reads``, ``read_bytes``, ``read_retries``, and the histogram
``blockstore.stage_wait_seconds`` of the device feed.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from collections import deque
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch.faults import fault_point
from keystone_tpu_torch.loaders.stream import prefetched
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.utils import durable
from keystone_tpu_torch.utils.device import resolve_device

_META = "meta.json"
_DTYPES = ("float32", "bfloat16")
#: blocks read ahead of the consumer (one read while one computes)
_PREFETCH = 2
#: device blocks whose copies are queued ahead of the consumer
_WINDOW = 2


class _BlockStreamBase:
    """Disk → host → device streaming shared by block stores; subclasses
    provide ``read_block``."""

    def read_block(self, b: int) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError(type(self).__name__)

    def iter_blocks(self, order: Sequence[int]) -> Iterator[Tuple[int, torch.Tensor]]:
        """Yield ``(b, host block)`` for each index in ``order``, read
        ahead on ``prefetched``'s thread (``_PREFETCH`` blocks deep) so
        that disk reads overlap the consumer's device work.  The thread
        only reads; a read error re-raises in the consumer, tagged with
        its block."""

        def reads():
            for b in order:
                try:
                    blk = self.read_block(b)
                except Exception as e:
                    if e.args and isinstance(e.args[0], str):
                        e.args = (f"block {b}: {e.args[0]}",) + e.args[1:]
                    raise
                yield b, blk

        return prefetched(reads, prefetch=_PREFETCH)()

    def iter_device_blocks(self, order: Sequence[int], device="cuda") -> Iterator[Tuple[int, torch.Tensor]]:
        """Yield ``(b, f32 block on device)`` for each index in ``order``,
        the copies of the next ``_WINDOW`` blocks already queued while the
        consumer computes on the current one.

        On a CUDA device: a block is read on ``iter_blocks``'s thread,
        copied into one of ``_WINDOW + 1`` pinned host buffers, and sent
        on a side stream; an event recorded after its copy makes the
        consumer's (current) stream wait for it, and a bf16 block is
        widened there, after the copy.  A pinned buffer is refilled only
        after the consumer's work on the block it last carried has
        completed (an event recorded on the consumer's stream when the
        generator resumes): that event also implies the buffer's copy
        is done, and it bounds the consumer's lead over the copies to
        ``_WINDOW`` blocks, so yielded blocks cannot pile up on the card.
        A device block allocated on the side stream is marked used on
        the consumer's stream (``record_stream``), so the caching
        allocator does not hand its memory out while work on it is
        queued.  On the CPU, the host blocks widened to f32."""
        dev = resolve_device(device)
        it = self.iter_blocks(order)
        if dev.type != "cuda":
            try:
                for b, blk in it:
                    yield b, blk.to(torch.float32)
            finally:
                it.close()
            return
        window = _WINDOW
        slots = window + 1
        compute = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        pinned: list = [None] * slots
        done: list = [None] * slots  # consumer-done event of each slot's last block
        staged: deque = deque()  # (j, b, device block, copy event), copies queued, not yet handed over

        def stage(j, b, blk):
            s = j % slots
            if done[s] is not None:
                done[s].synchronize()
            if pinned[s] is None or pinned[s].shape != blk.shape or pinned[s].dtype != blk.dtype:
                pinned[s] = torch.empty(blk.shape, dtype=blk.dtype, pin_memory=True)
            pinned[s].copy_(blk)
            with torch.cuda.stream(side):
                d = torch.empty(blk.shape, dtype=blk.dtype, device=dev)
                d.copy_(pinned[s], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            d.record_stream(compute)
            staged.append((j, b, d, ev))

        try:
            j = 0
            for b, blk in it:
                t0 = time.perf_counter()
                stage(j, b, blk)
                # the staging's host time (a pinned buffer's wait, its
                # copy, the dispatch): the feed's transfer account
                metrics.observe("blockstore.stage_wait_seconds", time.perf_counter() - t0)
                j += 1
                if len(staged) <= window:
                    continue
                yield from self._hand_over(staged, compute, done, slots)
            while staged:
                yield from self._hand_over(staged, compute, done, slots)
        finally:
            it.close()
            staged.clear()

    @staticmethod
    def _hand_over(staged, compute, done, slots):
        """Yield the oldest staged block on the consumer's stream, then
        record the consumer's progress for the slot it came through."""
        j, b, d, ev = staged.popleft()
        compute.wait_event(ev)
        a = d if d.dtype == torch.float32 else d.to(torch.float32)
        del d
        yield b, a
        del a
        ev_done = torch.cuda.Event()
        ev_done.record(compute)
        done[j % slots] = ev_done


class FeatureBlockStore(_BlockStreamBase):
    """A blockified (n, d) feature matrix on disk.  Create it with
    ``create`` + ``append_rows`` + ``finalize`` (streaming writes), or
    ``from_array`` / ``from_batches``."""

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, _META)) as f:
            meta = json.load(f)
        self.n = int(meta["n"])
        self.d = int(meta["d"])
        self.block_size = int(meta["block_size"])
        self.num_blocks = int(meta["nb"])
        self.dtype = str(meta.get("dtype", "float32"))
        self._cursor: Optional[int] = None
        self._hashers: Optional[list] = None

    @property
    def _disk_dtype(self):
        return np.uint16 if self.dtype == "bfloat16" else np.float32

    # ------------------------------------------------------------ create
    @classmethod
    def create(cls, directory: str, n: int, d: int, block_size: int, dtype: str = "float32"):
        """An empty store of (n, d) in blocks of ``block_size`` columns;
        fill it with ``append_rows``, then ``finalize``."""
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype!r}")
        os.makedirs(directory, exist_ok=True)
        nb = -(-d // block_size)
        meta = {"n": int(n), "d": int(d), "block_size": int(block_size), "nb": nb, "dtype": dtype}
        with open(os.path.join(directory, _META), "w") as f:
            json.dump(meta, f)
        disk_dtype = np.uint16 if dtype == "bfloat16" else np.float32
        for b in range(nb):
            mm = np.lib.format.open_memmap(cls._block_path(directory, b), mode="w+", dtype=disk_dtype,
                                           shape=(n, block_size))
            del mm  # a flushed, zero-filled file
        store = cls(directory)
        store._cursor = 0
        # digests of the bytes as written, held against the files at
        # seal time, so that the write path's own damage is caught
        store._hashers = [hashlib.blake2b(digest_size=16) for _ in range(nb)]
        return store

    @staticmethod
    def _block_path(directory: str, b: int) -> str:
        return os.path.join(directory, f"block_{b:04d}.npy")

    def append_rows(self, x) -> None:
        """Write the next ``x.shape[0]`` rows of the (n, d) matrix; ``x``
        is a numpy array or a tensor (a device tensor is copied to the
        host first).  bf16 stores round to nearest even."""
        x = torch.as_tensor(x).detach().to("cpu", torch.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (m, {self.d}) rows, got {tuple(x.shape)}")
        start = self._cursor or 0
        stop = start + x.shape[0]
        if stop > self.n:
            raise ValueError(f"store holds {self.n} rows; write would reach {stop}")
        bs = self.block_size
        for b in range(self.num_blocks):
            chunk = x[:, b * bs:(b + 1) * bs]
            if chunk.shape[1] < bs:  # the last, ragged block: zero columns
                chunk = torch.nn.functional.pad(chunk, (0, bs - chunk.shape[1]))
            raw = _to_disk(chunk, self.dtype)
            mm = np.lib.format.open_memmap(self._block_path(self.directory, b), mode="r+")
            mm[start:stop] = raw
            del mm
            if self._hashers is not None:
                self._hashers[b].update(np.ascontiguousarray(raw).tobytes())
            fault_point("blockstore.write", path=self._block_path(self.directory, b))
            metrics.inc("blockstore.write_bytes", int(raw.nbytes))
        metrics.inc("blockstore.writes")
        self._cursor = stop

    def finalize(self) -> None:
        """Seal a fully written store: hold each block file against the
        digest of the bytes ``append_rows`` wrote (a torn write raises
        ``CorruptStateError`` here), then write its checksum sidecar, which
        every later ``read_block`` verifies."""
        complete = self._cursor == self.n
        for b in range(self.num_blocks):
            path = self._block_path(self.directory, b)
            if self._hashers is not None and complete:
                _verify_written(path, self._hashers[b], self.n)
            durable.write_checksum(path)

    @classmethod
    def from_array(cls, directory: str, x, block_size: int, dtype: str = "float32"):
        x = torch.as_tensor(x)
        store = cls.create(directory, x.shape[0], x.shape[1], block_size, dtype=dtype)
        store.append_rows(x)
        store.finalize()
        return store

    @classmethod
    def from_batches(cls, directory: str, batches: Iterable, n: int, block_size: int, dtype: str = "float32"):
        """A store of the (m_i, d) batches, numpy or tensors, in order
        (Σ m_i must be n)."""
        store = None
        for batch in batches:
            if store is None:
                store = cls.create(directory, n, batch.shape[1], block_size, dtype=dtype)
            store.append_rows(batch)
        if store is None:
            raise ValueError("empty batch stream")
        if store._cursor != n:
            raise ValueError(f"batch stream produced {store._cursor} rows, expected {n}")
        store.finalize()
        return store

    # -------------------------------------------------------------- read
    def read_block(self, b: int) -> torch.Tensor:
        """Block ``b`` as an (n, block_size) CPU tensor of the store's
        dtype (bf16 stays bf16: it is widened on the device).  A transient
        read error is retried; a truncated or damaged file raises
        ``CorruptStateError``, a sealed store's checksum is verified."""
        return _read_block_file(self._block_path(self.directory, b), (self.n, self.block_size), self.dtype)

    def nbytes(self) -> int:
        """Bytes of the blocks' payload on disk."""
        return self.n * self.num_blocks * self.block_size * np.dtype(self._disk_dtype).itemsize


def _to_disk(x: torch.Tensor, dtype: str) -> np.ndarray:
    """f32 rows as the store's disk dtype: bf16 rounds to nearest even and
    is kept as its uint16 bit patterns (npy has no bfloat16)."""
    if dtype == "bfloat16":
        return x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return x.contiguous().numpy()


def _verify_written(path: str, hasher, rows: int) -> None:
    """Hold the first ``rows`` rows of a block file against the digest of
    the bytes written to them, in chunks of ~4 MiB (O(chunk) memory)."""
    raw = np.load(path, mmap_mode="r")
    h = hashlib.blake2b(digest_size=16)
    step = max(1, (4 << 20) // max(1, raw.shape[1] * raw.itemsize))
    for s in range(0, rows, step):
        h.update(np.ascontiguousarray(raw[s:min(s + step, rows)]).tobytes())
    del raw
    if h.hexdigest() != hasher.hexdigest():
        raise durable.CorruptStateError(
            f"write verification failed for block {path}: the file does not hold the bytes written")


def _read_block_file(path: str, shape: Tuple[int, int], dtype: str) -> torch.Tensor:
    """One block file as a CPU tensor of ``dtype``: truncation and the
    sealed checksum checked, a transient read error retried."""
    expected = shape[0] * shape[1] * (2 if dtype == "bfloat16" else 4)
    attempts = [0]

    def read():
        attempts[0] += 1
        fault_point("blockstore.read", path=path)
        if os.path.getsize(path) < expected:
            raise durable.CorruptStateError(
                f"truncated block {path}: {os.path.getsize(path)} bytes < {expected} of payload for shape {shape}")
        durable.verify_checksum(path)
        try:
            raw = np.array(np.load(path, mmap_mode="r"))
        except ValueError as e:  # header inconsistent with the size
            raise durable.CorruptStateError(f"corrupt block {path}: {e}")
        if raw.shape != shape:
            raise durable.CorruptStateError(f"block {path} has shape {raw.shape}, expected {shape}")
        return raw

    raw = durable.with_retries(read, description=f"block read {path}")
    metrics.inc("blockstore.reads")
    metrics.inc("blockstore.read_bytes", int(raw.nbytes))
    if attempts[0] > 1:
        metrics.inc("blockstore.read_retries", attempts[0] - 1)
    t = torch.from_numpy(raw)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


_ROW_META = "row_meta.json"


class RowBlockStore(_BlockStreamBase):
    """A row-blocked (n, d) matrix on disk: the kernel tier's out-of-core
    feed.  Block ``b`` is ``X[b·bs : (b+1)·bs]``, one ``(block_size, d)``
    file, the last block zero-padded on rows, so that every block the
    kernel sweep streams has one shape.  Create it with ``create`` +
    ``append_rows`` + ``finalize``, or ``from_array`` / ``from_batches``.

    Layout (the reference's)::

        row_meta.json        {"n": ..., "d": ..., "block_size": ..., "nb": ..., "dtype": ...}
        rblock_0000.npy      (block_size, d) rows [0, bs)
        rblock_0000.npy.b2   its BLAKE2b sidecar, once sealed
    """

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, _ROW_META)) as f:
            meta = json.load(f)
        self.n = int(meta["n"])
        self.d = int(meta["d"])
        self.block_size = int(meta["block_size"])
        self.num_blocks = int(meta["nb"])
        self.dtype = str(meta.get("dtype", "float32"))
        self._cursor: Optional[int] = None
        self._hashers: Optional[list] = None

    @classmethod
    def create(cls, directory: str, n: int, d: int, block_size: int, dtype: str = "float32"):
        """An empty store of (n, d) in blocks of ``block_size`` rows; fill
        it with ``append_rows``, then ``finalize``."""
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype!r}")
        os.makedirs(directory, exist_ok=True)
        nb = -(-n // block_size)
        meta = {"n": int(n), "d": int(d), "block_size": int(block_size), "nb": nb, "dtype": dtype}
        with open(os.path.join(directory, _ROW_META), "w") as f:
            json.dump(meta, f)
        disk_dtype = np.uint16 if dtype == "bfloat16" else np.float32
        for b in range(nb):
            mm = np.lib.format.open_memmap(cls._block_path(directory, b), mode="w+", dtype=disk_dtype,
                                           shape=(block_size, d))
            del mm  # a flushed, zero-filled file
        store = cls(directory)
        store._cursor = 0
        store._hashers = [hashlib.blake2b(digest_size=16) for _ in range(nb)]
        return store

    @staticmethod
    def _block_path(directory: str, b: int) -> str:
        return os.path.join(directory, f"rblock_{b:04d}.npy")

    def append_rows(self, x) -> None:
        """Write the next ``x.shape[0]`` rows, numpy or a tensor (a device
        tensor is copied to the host first).  Sequential: a batch touches
        only the block files its rows fall in."""
        x = torch.as_tensor(x).detach().to("cpu", torch.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (m, {self.d}) rows, got {tuple(x.shape)}")
        start = self._cursor or 0
        stop = start + x.shape[0]
        if stop > self.n:
            raise ValueError(f"store holds {self.n} rows; write would reach {stop}")
        bs = self.block_size
        for b in range(start // bs, -(-stop // bs)):
            lo, hi = max(start, b * bs), min(stop, (b + 1) * bs)
            raw = _to_disk(x[lo - start:hi - start], self.dtype)
            mm = np.lib.format.open_memmap(self._block_path(self.directory, b), mode="r+")
            mm[lo - b * bs:hi - b * bs] = raw
            del mm
            if self._hashers is not None:
                self._hashers[b].update(np.ascontiguousarray(raw).tobytes())
            fault_point("blockstore.write", path=self._block_path(self.directory, b))
            metrics.inc("blockstore.write_bytes", int(raw.nbytes))
        metrics.inc("blockstore.writes")
        self._cursor = stop

    def finalize(self) -> None:
        """Seal a fully written store: each block's written rows held
        against the digest of the bytes ``append_rows`` wrote (the final
        block's padding rows were zero-filled and never written), then the
        sidecar over the whole file, which every ``read_block`` verifies."""
        complete = self._cursor == self.n
        bs = self.block_size
        for b in range(self.num_blocks):
            path = self._block_path(self.directory, b)
            if self._hashers is not None and complete:
                _verify_written(path, self._hashers[b], min(bs, self.n - b * bs))
            durable.write_checksum(path)

    @classmethod
    def from_array(cls, directory: str, x, block_size: int, dtype: str = "float32"):
        x = torch.as_tensor(x)
        store = cls.create(directory, x.shape[0], x.shape[1], block_size, dtype=dtype)
        store.append_rows(x)
        store.finalize()
        return store

    @classmethod
    def from_batches(cls, directory: str, batches: Iterable, n: int, block_size: int, dtype: str = "float32"):
        """A store of the (m_i, d) batches, numpy or tensors, in order
        (Σ m_i must be n)."""
        store = None
        for batch in batches:
            if store is None:
                store = cls.create(directory, n, batch.shape[1], block_size, dtype=dtype)
            store.append_rows(batch)
        if store is None:
            raise ValueError("empty batch stream")
        if store._cursor != n:
            raise ValueError(f"batch stream produced {store._cursor} rows, expected {n}")
        store.finalize()
        return store

    def read_block(self, b: int) -> torch.Tensor:
        """Row block ``b`` as a (block_size, d) CPU tensor of the store's
        dtype, read as ``FeatureBlockStore.read_block`` reads."""
        return _read_block_file(self._block_path(self.directory, b), (self.block_size, self.d), self.dtype)

    def nbytes(self) -> int:
        """Bytes of the blocks' payload on disk."""
        return self.num_blocks * self.block_size * self.d * (2 if self.dtype == "bfloat16" else 4)
