"""Profiler tracing and per-stage timing (counterpart of
``keystone_tpu/utils/tracing.py``).

- ``trace(logdir)`` / ``start_trace`` / ``stop_trace``: a
  ``torch.profiler`` capture of the host and, with a card, its kernels,
  written into ``logdir`` as a Chrome trace (open it in Perfetto or
  ``chrome://tracing``).
- ``annotate(name)``: a named region (``record_function``), so pipeline
  stages show by name inside the trace; ``step_annotation`` marks one
  solver or pipeline iteration.
- ``stage_timings(result)``: each node's seconds for a lazy pipeline
  result, from the executor's profile mode (each node ended by a device
  synchronize).

The cost model of the materialization pass lives in
``workflow/profiling.py``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

#: the running capture of ``start_trace``: (profiler, logdir)
_ACTIVE: Optional[tuple] = None


def start_trace(logdir: str) -> None:
    """Begin capturing a trace into ``logdir``: the CPU's operators and,
    where torch sees a card, its kernels."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a trace is already running; stop_trace() first")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _ACTIVE = (prof, logdir)


def stop_trace() -> str:
    """End the capture; returns the path of the Chrome trace written."""
    global _ACTIVE
    if _ACTIVE is None:
        raise RuntimeError("no trace is running")
    prof, logdir = _ACTIVE
    _ACTIVE = None
    prof.stop()
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str, annotation: Optional[str] = None):
    """Capture a trace around a block::

        with tracing.trace("traces/fit"):
            pipeline.fit()
    """
    start_trace(logdir)
    try:
        if annotation is None:
            yield
        else:
            with annotate(annotation):
                yield
    finally:
        stop_trace()


def annotate(name: str):
    """A named region inside an active trace."""
    return torch.profiler.record_function(name)


def step_annotation(step: int, name: str = "step"):
    """Mark one solver or pipeline iteration."""
    return torch.profiler.record_function(f"{name}#{step}")


def stage_timings(result) -> Dict[str, float]:
    """Each node's seconds for a lazy pipeline result.

    Runs the pipeline optimizer first (as ``result.get()`` does), then the
    optimized graph in the executor's profile mode: each node's output is
    synchronized before its clock stops, so the times are its device work,
    not its launches, and the nodes reported are the ones that ran,
    fused and inserted stages included.  Keys are ``"{node_id}:{label}"``;
    the id tells repeated operators apart."""
    from keystone_tpu_torch.workflow.executor import GraphExecutor
    from keystone_tpu_torch.workflow.pipeline import PipelineEnv

    g = PipelineEnv.get_optimizer().execute(result.graph)
    ex = GraphExecutor(g, profile=True)
    ex.execute(result.sink)
    return {f"{node.id}:{g.operators[node].label()}": seconds for node, seconds in ex.timings.items()}
