"""Wall-clock stage timing for the fits."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def stage(seconds: Optional[Dict[str, float]], name: str, device: torch.device):
    """Add the block's seconds to ``seconds[name]``, the device's queued
    work included (a CUDA synchronize ends the block).  With ``seconds``
    None the block runs untimed and unsynchronized."""
    if seconds is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
