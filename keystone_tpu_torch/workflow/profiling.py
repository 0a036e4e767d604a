"""Device memory budget (counterpart of ``keystone_tpu/workflow/profiling.py``
§ device_hbm_budget; the stage profiler is not ported)."""

from __future__ import annotations

import torch


def device_hbm_budget(fraction: float = 0.5, device=None) -> int:
    """Cache budget in bytes: ``fraction`` of the card's memory
    (``torch.cuda.mem_get_info``), leaving headroom for solver state.  A
    CPU device falls back to the reference's 16 GiB device, so 8 GiB at
    the default fraction."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1] * fraction)
    return int((16 << 30) * fraction)
