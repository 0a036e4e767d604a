"""Coarse-grained failure recovery for pipeline fits (counterpart of
``keystone_tpu/workflow/recovery.py`` § scan_state_dir,
purge_invalid_state, fit_with_recovery).

The reference delegated recovery to Spark: lineage recompute of lost
partitions, task retry, speculative execution.  The port's layers:

- **stage retry** (``GraphExecutor(node_retries=...)``): stages are pure
  functions of memoized inputs, so a transiently failed stage is re-run;
- **process-level restart and resume** (this module): when a fit dies,
  what survives is what was durably saved, the pipeline prefixes
  (``workflow/state.py``, reloaded by ``SavedStateLoadRule``) and the
  solvers' epoch checkpoints (``fit_checkpointed``, a ``checkpoint_dir``).
  ``fit_with_recovery`` wraps the build-and-fit cycle so that a restarted
  attempt resumes from both instead of recomputing them.  A process that
  was killed is restarted by whoever launched it, with the same state
  directory: the relaunch resumes the same way.

A job of several ranks (``parallel/``) restarts as a whole: collectives
are SPMD, so one rank retrying alone would rerun collectives its peers
never see.  Under a world above one ``fit_with_recovery`` makes no
in-process retry; each attempt starts at ``maybe_health_barrier`` (a
dead or sick peer fails it in bounded time instead of deadlocking the
first all-reduce), and the job's launcher relaunches every rank, which
resume from rank 0's checkpoints and the saved prefixes.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from keystone_tpu_torch import faults
from keystone_tpu_torch.obs import ledger
from keystone_tpu_torch.parallel import multihost
from keystone_tpu_torch.utils import durable

logger = logging.getLogger(__name__)


def scan_state_dir(state_dir: str) -> Dict[str, List[str]]:
    """Classify the ``.npz`` durable-state files under ``state_dir``
    (recursively: solver checkpoint directories nest) as valid or
    corrupt: the checksum sidecar matches where there is one, and the
    npz parses.  Returns ``{"valid": [...], "corrupt": [...]}``."""
    out: Dict[str, List[str]] = {"valid": [], "corrupt": []}
    for root, _dirs, files in os.walk(state_dir):
        for name in sorted(files):
            if not (name.endswith(".npz") or ".npz." in name):
                continue
            if ".tmp." in name or name.endswith(durable.CHECKSUM_SUFFIX) or name.endswith(".corrupt"):
                continue
            path = os.path.join(root, name)
            try:
                durable.verify_checksum(path)
                with np.load(path, allow_pickle=False) as z:
                    z.files  # force the header parse
                out["valid"].append(path)
            except Exception:
                out["corrupt"].append(path)
    return out


def purge_invalid_state(state_dir: str) -> List[str]:
    """Quarantine the corrupt durable-state files (renamed ``*.corrupt``)
    so resume scans stop tripping over them; rotated last-good copies
    (``<file>.1`` …) stay for the solvers' fallback loads.  Returns the
    quarantined paths.  Called between ``fit_with_recovery`` attempts."""
    quarantined = []
    for path in scan_state_dir(state_dir)["corrupt"]:
        dest = durable.quarantine(path)
        if dest is not None:
            quarantined.append(dest)
    return quarantined


def _world_size() -> int:
    """The job's ranks (``parallel.mesh``): the initialized group's world
    size, else 1."""
    from keystone_tpu_torch.parallel import mesh

    return mesh.device_count()


def fit_with_recovery(build_fn: Callable, state_dir: Optional[str] = None,
                      max_restarts: int = 2) -> Tuple[object, int]:
    """Fit with in-process restart and saved-state resume.

    ``build_fn() -> Pipeline`` builds the unfitted pipeline (training data
    loading belongs inside it).  Each attempt fits; on a failure the
    pipeline is rebuilt and refitted.  With ``state_dir`` set, saved
    prefixes reload through ``SavedStateLoadRule`` (the ``PipelineEnv``
    wiring), and solvers given a ``checkpoint_dir`` resume from their last
    completed epoch, so a retry resumes rather than recomputes.  Between
    attempts the corrupt files under ``state_dir`` are quarantined, and
    each failed attempt's fault statistics go to the run ledger.

    Returns ``(fitted, attempts_used)``; raises the last error once
    ``max_restarts`` is spent."""
    from keystone_tpu_torch.workflow.pipeline import PipelineEnv

    if max_restarts > 0 and _world_size() > 1:
        logger.warning("fit_with_recovery: in-process retry disabled under multi-process execution (%d "
                       "processes); restart the job to recover", _world_size())
        max_restarts = 0
    prev_state_dir = PipelineEnv.state_dir
    if state_dir is not None:
        PipelineEnv.state_dir = state_dir
    try:
        delays = iter(durable.backoff_delays(max_restarts, base_delay=0.1, max_delay=2.0))
        for attempt in range(max_restarts + 1):
            try:
                # every peer alive and healthy before a collective fit
                # (inert at a world of one, and without KEYSTONE_HEALTH_TIMEOUT)
                multihost.maybe_health_barrier("fit_with_recovery.attempt")
                fitted = build_fn().fit()
                # failures surface here, inside the retry scope, not at
                # the fitted model's first use
                fitted.block_until_ready()
                return fitted, attempt
            except Exception as e:
                ledger.event("faults.stats", attempt=attempt, error=f"{type(e).__name__}: {e}"[:200],
                             stats=faults.stats())
                if attempt >= max_restarts:
                    raise
                logger.warning("fit attempt %d failed (%s); restarting (%d left)", attempt, e,
                               max_restarts - attempt)
                if state_dir is not None:
                    # the restart must load last-good checkpoints, not
                    # re-crash on the same torn file
                    purge_invalid_state(state_dir)
                time.sleep(next(delays, 2.0))
        raise AssertionError("unreachable")
    finally:
        PipelineEnv.state_dir = prev_state_dir
