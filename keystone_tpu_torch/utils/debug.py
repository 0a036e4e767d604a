"""Numeric debugging helpers (counterpart of ``keystone_tpu/utils/debug.py``).

The reference wraps JAX's checkify; PyTorch runs eagerly, so here a check
is a reduction on the tensor's own device and one host read of its
result: ``checked`` runs the function, then checks each floating tensor
it returns with one reduction an output, and names the output that holds
a NaN or an infinity.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterator, Tuple

import numpy as np
import torch


def _non_finite(x) -> int:
    """How many entries of ``x`` (a tensor or anything numpy reads) are
    NaN or infinite: one reduction on the tensor's device, one read."""
    if isinstance(x, torch.Tensor):
        if not (x.is_floating_point() or x.is_complex()):
            return 0
        return int((~torch.isfinite(x)).sum().item())
    arr = np.asarray(x)
    if not (np.issubdtype(arr.dtype, np.floating) or np.issubdtype(arr.dtype, np.complexfloating)):
        return 0
    return int((~np.isfinite(arr)).sum())


def assert_all_finite(x, name: str = "array"):
    """Raise ``FloatingPointError`` when ``x`` holds a NaN or an infinity;
    returns ``x``."""
    bad = _non_finite(x)
    if bad:
        raise FloatingPointError(f"{name}: {bad} non-finite values")
    return x


def _outputs(out, name: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every floating tensor in ``out`` (nested tuples, lists, dicts), with
    its place in it."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() or out.is_complex():
            yield name, out
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            yield from _outputs(v, f"{name}[{i}]")
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from _outputs(v, f"{name}[{k!r}]")


def checked(fn: Callable) -> Callable:
    """``fn`` followed by a finiteness check of every floating tensor it
    returns: a ``FloatingPointError`` names the first output that holds a
    NaN or an infinity (``output``, ``output[1]``, ``output['w']``)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for where, t in _outputs(out, "output"):
            assert_all_finite(t, f"{getattr(fn, '__name__', 'fn')}: {where}")
        return out

    return wrapper


def nan_guard_dataset(ds, name: str = "dataset"):
    """Validate a Dataset's array (host payloads are skipped); returns it."""
    if not ds.is_host:
        assert_all_finite(ds.array, name)
    return ds
