"""Device resolution for the port's entry points, and the cache of small
device-resident operators the featurizers build once per shape."""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict

import torch


def resolve_device(device="cuda") -> torch.device:
    """The entry points' device: the card unless the caller asks for the
    CPU.  A CUDA device that is not there raises; nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch sees none; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _holds_fake(value) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    if isinstance(value, (tuple, list)):
        return any(_holds_fake(v) for v in value)
    return isinstance(value, FakeTensor)


def device_cache(maxsize: int = 64):
    """``functools.lru_cache`` for a function that builds a small operator
    on a device (``ops/sift.py::_window_operator``, ``ops/lcs.py::
    _gather_index``, ``ops/filters.py::_blur_operator``), except that a
    result made under ``FakeTensorMode`` is returned and never kept: a
    tensor copied "to the device" there is a placeholder of its shape (the
    pre-flight analyzer's shape walk and ``profiling.stage_cost`` run the
    stages that way), and a cached placeholder would stand in for the
    operator in every later real call.  A real cached tensor serves a fake
    walk as it serves a real call."""

    def deco(fn):
        cache: OrderedDict = OrderedDict()
        lock = threading.Lock()

        @functools.wraps(fn)
        def wrapper(*args):
            with lock:
                if args in cache:
                    cache.move_to_end(args)
                    return cache[args]
            out = fn(*args)
            if not _holds_fake(out):
                with lock:
                    cache[args] = out
                    while len(cache) > maxsize:
                        cache.popitem(last=False)
            return out

        wrapper.cache_clear = cache.clear
        return wrapper

    return deco
