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

``StreamDataset`` (the out-of-core path) waits for the row-block store
(ROADMAP A5).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

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
        return torch.device("cpu") if self._array is None else self._array.device

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
        d = Dataset.__new__(Dataset)
        d._host = list(items)
        d._array = None
        d.n = self.n
        d.mask = None
        d.name = None
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


def _all_arrays(seq) -> bool:
    return (
        len(seq) > 0
        and all(isinstance(x, (np.ndarray, torch.Tensor)) for x in seq)
        and len({tuple(x.shape) for x in seq}) == 1
    )


def as_dataset(x, device=None) -> Dataset:
    if isinstance(x, Dataset):
        return x
    return Dataset(x, device=device)
