"""The core data abstraction (counterpart of
``keystone_tpu/workflow/dataset.py`` § Dataset, as_dataset).

A Dataset is a batch of items living as one torch tensor on one device,
its leading axis the items.  The reference shards that axis over a mesh
and pads it to the mesh's width; the port runs on one device, so there
is no padding and ``n`` equals the tensor's rows.

Three payload kinds flow through pipelines:
  - tensors: (n, ...) on the Dataset's device, the normal case;
  - ragged tensors: (n, max_k, d) with an (n, max_k) mask — e.g.
    per-image SIFT descriptor sets;
  - host lists: arbitrary Python objects, which stay on the host until a
    featurizer produces tensors.

``StreamDataset`` is the out-of-core path: a re-iterable stream of host
batches, each copied to the device as the pipeline sweeps it.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from keystone_tpu_torch.utils.device import resolve_device

class Dataset:
    """A batch with true length ``n``.

    ``data``: a tensor, a numpy array, a list of same-shaped arrays
    (stacked), or a list of other objects (a host payload).  ``device``:
    where the tensor lives; None keeps a tensor where it is and puts
    other data (numpy) on the card, as the entry points do: pass
    ``device="cpu"`` to keep it on the CPU.  ``name``: an optional stable
    identity for CSE (unnamed datasets use their object id)."""

    def __init__(
        self,
        data: Any,
        n: Optional[int] = None,
        mask: Optional[torch.Tensor] = None,
        name: Optional[str] = None,
        device=None,
    ):
        self.name = name
        if isinstance(data, (list, tuple)) and not _all_arrays(data):
            self._host: Optional[list] = list(data)
            self._array = None
            self.n = len(self._host) if n is None else int(n)
            self.mask = None
            self._device = None if device is None else torch.device(device)
            return
        if isinstance(data, (list, tuple)):
            is_tensor = isinstance(data[0], torch.Tensor)
            data = torch.stack([torch.as_tensor(a) for a in data])
        else:
            is_tensor = isinstance(data, torch.Tensor)
        arr = torch.as_tensor(data)
        if device is None and not is_tensor:
            device = resolve_device()
        if device is not None:
            arr = arr.to(device)
        self._host = None
        self._array = arr
        self.n = arr.shape[0] if n is None else int(n)
        self.mask = None if mask is None else torch.as_tensor(mask).to(arr.device)

    # ------------------------------------------------------------ access
    @property
    def is_host(self) -> bool:
        return self._host is not None

    @property
    def array(self) -> torch.Tensor:
        if self._array is None:
            raise TypeError("host-payload Dataset has no array; featurize it first")
        return self._array

    @property
    def device(self) -> torch.device:
        """Where the tensor lives; for a host payload, where the tensors
        featurized from it go (its ``device`` argument, else the card)."""
        if self._array is not None:
            return self._array.device
        return self._device if self._device is not None else resolve_device()

    @property
    def item_shape(self) -> tuple:
        """The shape of one item (a stream peeks at its first batch)."""
        return tuple(self.array.shape[1:])

    @property
    def items(self) -> list:
        if self._host is not None:
            return self._host
        return list(self.numpy())

    def numpy(self) -> np.ndarray:
        """Host copy of the first ``n`` rows."""
        return self.array[: self.n].cpu().numpy()

    def __len__(self) -> int:
        return self.n

    # --------------------------------------------------------- derivation
    def with_array(self, arr, mask=None) -> "Dataset":
        """New Dataset of this one's length over ``arr``."""
        d = Dataset.__new__(Dataset)
        d._host = None
        d._array = arr
        d.n = self.n
        d.mask = mask
        d.name = None
        return d

    def with_items(self, items: Sequence) -> "Dataset":
        """New host Dataset of this one's length and device over ``items``."""
        d = Dataset.__new__(Dataset)
        d._host = list(items)
        d._array = None
        d.n = self.n
        d.mask = None
        d.name = None
        d._device = self._device if self._array is None else self._array.device
        return d

    def cache(self) -> "Dataset":
        """The Cacher analogue (nodes/util/Cacher.scala).  A tensor is
        resident once computed and the executor memoizes it, so there is
        nothing to force; no device wait either (the stream orders the
        work)."""
        return self

    def __repr__(self):
        if self.is_host:
            return f"Dataset(host, n={self.n})"
        return f"Dataset(shape={tuple(self.array.shape)}, n={self.n}, device={self.device})"


class StreamDataset(Dataset):
    """A lazily evaluated, re-iterable stream of host batches: the
    out-of-core path through the pipeline graph (counterpart of the
    reference's ``StreamDataset``).

    The reference streams data through RDD partition iterators, so no
    executor holds the whole set; here transformers map over the stream
    batch by batch on the device, and the block solvers spill the
    features to a ``FeatureBlockStore`` and fit out of core, so neither
    the images nor the feature matrix need fit in device memory.

    ``source``: a callable returning a fresh iterator of host batches, or
    a re-iterable (a list).  A batch is an (m_i, ...) array or an
    ``(array, mask)`` pair for ragged payloads; ``n`` is the total rows.
    ``prefetch`` > 0 makes the batches (decode, synthesis) on a producer
    thread that stays ``prefetch`` batches ahead; it makes host arrays
    only.  ``device``: where the batches go (None: the card).  Each host
    batch crosses to it on the consumer's thread, through pinned memory
    with ``non_blocking`` copies on a CUDA device; ``stage``, when given,
    replaces that copy (a loader that decodes on the card).

    Each sweep re-runs the source and every map over it: a consumer
    without a streaming path that reads ``array`` materializes the
    whole stream, with a warning.

    ``host=True`` makes a stream of host-object batches (lists of
    documents, term dicts, CSR rows: the text pipelines' payloads before
    featurization): host transformers map over it item by item, batch by
    batch, and nothing reaches the device until a featurizer makes
    tensors; ``device`` is where they go.  Its ``items`` collect the
    stream (the CSR rows after featurization are small).

    ``retries``, ``max_bad_batches`` and ``timeout`` harden a flaky
    source (``loaders/stream.resilient``): bounded per-batch retry with
    backoff, then a drop quota, and a watchdog on each fetch.  The
    wrapper sits under the producer thread, so retries run there."""

    def __init__(
        self,
        source,
        n: int,
        name: Optional[str] = None,
        prefetch: int = 0,
        host: bool = False,
        device=None,
        stage: Optional[Callable] = None,
        retries: int = 0,
        max_bad_batches: int = 0,
        timeout: Optional[float] = None,
    ):
        if not callable(source) and iter(source) is source:
            # a one-shot iterator would be shared, and interleaved, by
            # the consumers that fan out of one stream (a Gather's branches)
            raise ValueError(
                "StreamDataset source must be re-iterable: pass a callable returning a fresh iterator "
                "(or a list of batches), not a one-shot generator/iterator")
        if retries > 0 or max_bad_batches > 0 or timeout is not None:
            from keystone_tpu_torch.loaders.stream import resilient

            source = resilient(source, retries=retries, max_bad_batches=max_bad_batches, timeout=timeout)
        if prefetch > 0:
            from keystone_tpu_torch.loaders.stream import prefetched

            source = prefetched(source, prefetch=prefetch)
        dev = resolve_device() if device is None else torch.device(device)
        put = stage if stage is not None else (lambda a: _to_device(a, dev))

        if host:
            def gen():
                for batch in source() if callable(source) else iter(source):
                    yield list(batch), None
        else:
            def gen():
                for batch in source() if callable(source) else iter(source):
                    arr, mask = batch if isinstance(batch, tuple) else (batch, None)
                    yield put(arr), None if mask is None else _to_device(mask, dev)

        self._init(gen, n, dev, name, host)

    def _init(self, gen, n, device, name=None, host=False):
        self.name = name
        self.n = int(n)
        self._host = None
        self._array = None
        self.mask = None
        self._device = device
        self._gen = gen
        self._host_stream = bool(host)

    @classmethod
    def _wrap(cls, gen, n: int, device, name: Optional[str] = None, host: bool = False) -> "StreamDataset":
        d = cls.__new__(cls)
        d._init(gen, n, device, name, host)
        return d

    @property
    def is_host(self) -> bool:
        return self._host_stream

    @property
    def device(self) -> torch.device:
        return self._device

    # --------------------------------------------------------- streaming
    def device_batches(self):
        """Iterate ``(tensor, mask or None)`` batches on the device."""
        return self._gen()

    def peek_shape(self) -> tuple:
        """The per-item shape, from the first batch (one batch's work on
        the first call, cached)."""
        if not hasattr(self, "_peek_shape"):
            for arr, _ in self._gen():
                self._peek_shape = tuple(arr.shape[1:])
                break
            else:
                raise ValueError("empty stream")
        return self._peek_shape

    @property
    def item_shape(self) -> tuple:
        return self.peek_shape()

    def batches(self):
        """Iterate the batches as host numpy arrays (lists, on a host stream)."""
        for arr, _ in self._gen():
            yield arr if self._host_stream else arr.cpu().numpy()

    def map_batches(self, fn, host: Optional[bool] = None) -> "StreamDataset":
        """Lazily compose ``fn(batch, mask)`` (returning a tensor or a
        ``(tensor, mask)`` pair, or a list on a host stream) over the
        stream.  ``host`` is the child stream's payload kind (default:
        this one's); a host stream's device child puts each batch that
        ``fn`` makes on the stream's device."""
        parent = self._gen
        host = self._host_stream if host is None else bool(host)
        to_device = self._host_stream and not host
        dev = self._device

        def gen():
            for arr, mask in parent():
                out = fn(arr, mask)
                out, m = out if isinstance(out, tuple) else (out, None)
                if to_device:
                    out = _to_device(out, dev)
                yield out, m

        return StreamDataset._wrap(gen, self.n, self._device, host=host)

    @staticmethod
    def zip_concat(streams: Sequence["StreamDataset"]) -> "StreamDataset":
        """The Gather of streams: zip their batches and concatenate them
        on the last axis.  The streams must share their batches' rows (in
        a pipeline they are branches mapped over one source)."""
        ns = {s.n for s in streams}
        if len(ns) != 1:
            raise ValueError(f"gathered streams disagree on n: {sorted(ns)}")
        gens = [s._gen for s in streams]

        def gen():
            for parts in zip(*(g() for g in gens), strict=True):
                yield torch.cat([a for a, _ in parts], dim=-1), None

        return StreamDataset._wrap(gen, streams[0].n, streams[0].device)

    # -------------------------------------------------- Dataset protocol
    @property
    def array(self) -> torch.Tensor:
        """The whole stream as one tensor on the device: the escape hatch
        of a consumer without a streaming path, which defeats out-of-core."""
        if self._host_stream:
            raise TypeError("host-payload StreamDataset has no array; featurize it first")
        if self._array is None:
            logging.getLogger(__name__).warning(
                "materializing StreamDataset (n=%d) into device memory; this consumer has no out-of-core path",
                self.n)
            parts, masks = [], []
            for arr, mask in self._gen():
                parts.append(arr)
                if mask is not None:
                    masks.append(mask)
            self._array = torch.cat(parts)
            if masks:
                self.mask = torch.cat(masks)
        return self._array

    @property
    def items(self) -> list:
        """A host stream's items, collected once (after featurization they
        are CSR rows, small); a device stream's rows, materialized."""
        if not self._host_stream:
            return list(self.array[:self.n].cpu().numpy())
        if self._host is None:
            logging.getLogger(__name__).debug("collecting host StreamDataset (n=%d) items", self.n)
            out: list = []
            for batch, _ in self._gen():
                out.extend(batch)
            self._host = out
        return self._host

    def cache(self) -> "StreamDataset":
        """A Cacher must not collapse the stream into memory: a no-op."""
        return self

    def __repr__(self):
        kind = "host, " if self._host_stream else ""
        return f"StreamDataset({kind}n={self.n}, device={self._device})"


def _to_device(arr, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: through pinned memory and a
    ``non_blocking`` copy on a CUDA device.  The caching host allocator
    keeps a pinned buffer from reuse until its copy is done."""
    t = torch.as_tensor(arr)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _all_arrays(seq) -> bool:
    return (
        len(seq) > 0
        and all(isinstance(x, (np.ndarray, torch.Tensor)) for x in seq)
        and len({tuple(x.shape) for x in seq}) == 1
    )


def as_dataset(x, device=None) -> Dataset:
    """``x`` as a Dataset: a Dataset, or a StreamDataset, as it is (a
    stream stays a lazy recipe); other data into a Dataset on ``device``."""
    if isinstance(x, Dataset):
        return x
    return Dataset(x, device=device)
