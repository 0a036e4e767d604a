"""Profiling-driven materialization (counterpart of
``keystone_tpu/workflow/profiling.py`` § NodeProfile, profile_graph,
_static_node_seconds, device_hbm_budget, last_footprint,
ProfilingAutoCacheRule, _comparable_seconds, _insert_cacher).

Reference: workflow/AutoCacheRule.scala — estimates each node's output
size and compute time by running the nodes on sampled partitions, then
greedily places caches under a cluster-memory budget.

Here the budget is the card's memory (``torch.cuda.mem_get_info``), and
the decision is materialize or recompute: a shared node output that fits
keeps an explicit materialization barrier (Cacher); one that does not is
flagged ``no_memoize``, and the executor recomputes it for each consumer
instead of pinning it on the card.

The reference prices a stage at full batch from XLA's compiled cost
analysis (``hlo_stage_cost``).  Its counterpart, :func:`stage_cost`, runs
the stage on fake tensors (``FakeTensorMode``: shapes, no storage) and
sums each aten op's flops (the formulas of ``torch.utils.flop_counter``)
and the bytes of its inputs and outputs.  A stage that cannot run on fake
tensors (a hand-written kernel through ctypes, a host stage, shapes that
depend on the data) gets no static price and falls back to its sampled
wall time, calibrated by :func:`_comparable_seconds`.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.optimizer import Rule, _truncate_datasets
from keystone_tpu_torch.workflow.transformer import Cacher

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class NodeProfile:
    """Measured on a sample, extrapolated to the full dataset."""

    seconds: float
    output_bytes: int
    scale: float  # full_n / sample_n extrapolation factor
    #: full-scale roofline estimate (the reference's ``hlo_seconds``)
    static_seconds: Optional[float] = None

    @property
    def full_bytes(self) -> int:
        return int(self.output_bytes * self.scale)

    @property
    def full_seconds(self) -> float:
        # the static estimate, when there is one, is already at full scale
        # and immune to wall-clock noise and a sample's fixed overheads
        if self.static_seconds is not None:
            return self.static_seconds
        return self.seconds * self.scale


#: peak rates (f32 flop/s, memory bytes/s) that turn a stage's counted
#: work into a time.  Only the ranking across nodes matters for cache
#: placement.  cuda: an H100 SXM's f32 outside the tensor cores and its
#: HBM3 rate (NVIDIA's data sheet); cpu: a nominal host pair
_PEAKS = {"cuda": (67e12, 3.35e12), "cpu": (5e10, 3e10)}


class TensorSpec(NamedTuple):
    """The shape, dtype and device of a stage input, without its data."""

    shape: tuple
    dtype: torch.dtype = torch.float32
    device: str = "cpu"


def stage_cost(fn, *specs: TensorSpec) -> Optional[dict]:
    """Price ``fn`` on inputs of the given specs without running it on data:
    ``{'flops', 'bytes', 'seconds_est'}``, or None where ``fn`` cannot run
    on fake tensors (a ctypes kernel refuses them, a host stage or a
    data-dependent shape raises).  ``seconds_est`` is the roofline time
    ``max(flops / peak flop/s, bytes / peak bytes/s)`` at the first
    input's device's peaks.  Nothing is allocated: this prices a stage at
    full batch without paying for a full-size run."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = [torch.empty(tuple(s.shape), dtype=s.dtype, device=s.device) for s in specs]
            counter, moved = FlopCounterMode(display=False), _BytesMode()
            with counter, moved:
                fn(*args)
        flops, nbytes = float(counter.get_total_flops()), float(moved.bytes)
    except Exception as e:  # static pricing is best-effort, like the reference's
        logger.debug("stage cost failed: %s", e)
        return None
    if flops <= 0.0 and nbytes <= 0.0:
        return None
    dev = torch.device(specs[0].device).type if specs else "cpu"
    peak_f, peak_b = _PEAKS.get(dev, _PEAKS["cpu"])
    return {"flops": flops, "bytes": nbytes, "seconds_est": max(flops / peak_f, nbytes / peak_b)}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    if isinstance(x, dict):
        return _tensor_bytes(list(x.values()))
    return 0


class _BytesMode(TorchDispatchMode):
    """Sums each aten op's input and output bytes (an eager op reads its
    inputs once and writes its outputs once); a view moves nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.bytes += _tensor_bytes(args) + _tensor_bytes(kwargs) + _tensor_bytes(out)
        return out


def profile_graph(graph: G.Graph, sample_size: int = 64, static_cost: bool = False,
                  targets=None) -> Dict[G.NodeId, NodeProfile]:
    """Run every reachable transformer and gather node on truncated dataset
    literals, recording each one's seconds (the executor's profile mode:
    each node ended by a device synchronize) and output bytes (the
    reference's sampling pass).

    ``static_cost=True`` also prices each device transformer at FULL
    batch (:func:`stage_cost`): the sampled run still gives shapes and
    output sizes, the seconds come from the counted work.

    ``targets`` restricts profiling to a node subset (their sampled
    ancestors still execute, memoized, to make their inputs): the cache
    rule passes the shared nodes, the only ones whose profiles its
    placement reads."""
    from keystone_tpu_torch.workflow.executor import DatasetExpr, GraphExecutor

    full_n = max((op.dataset.n if isinstance(op.dataset, Dataset) else len(op.dataset)
                  for op in graph.operators.values() if isinstance(op, G.DatasetOperator)), default=1)
    truncated = _truncate_datasets(graph, sample_size)
    ex = GraphExecutor(truncated, profile=True)
    profiles: Dict[G.NodeId, NodeProfile] = {}
    for n in truncated.topological_nodes():
        op = truncated.operators[n]
        if not isinstance(op, (G.TransformerOperator, G.GatherOperator)):
            continue
        if targets is not None and n not in targets:
            continue
        try:
            expr = ex.execute(n)
        except Exception as e:  # profiling is best-effort, like upstream
            logger.debug("profiling failed at %s: %s", op.label(), e)
            continue
        nbytes, sample_n = 0, 1
        if isinstance(expr, DatasetExpr) and not expr.dataset.is_host:
            arr = expr.dataset.array
            nbytes = arr.numel() * arr.element_size()
            sample_n = max(expr.dataset.n, 1)
        profiles[n] = NodeProfile(
            seconds=ex.timings.get(n, 0.0),
            output_bytes=nbytes,
            scale=max(full_n / sample_n, 1.0),
            static_seconds=_static_node_seconds(truncated, ex, n, op, full_n) if static_cost else None,
        )
    return profiles


def _static_node_seconds(graph: G.Graph, ex, n: G.NodeId, op, full_n: int):
    """Full-scale roofline estimate for one transformer node, from the
    sampled input's shape with the batch axis widened to full_n.

    Called only after the sampled run of the same node (``profile_graph``
    executes ``n`` first): stages that cache device tensors by image
    extent (``ops/sift.py::_window_operator``, ``ops/lcs.py::_gather_index``,
    ``ops/filters.py::_blur_operator``) have filled those caches with real
    tensors by then, since widening the batch axis keeps the extent.  Run
    first under fake tensors, they would cache a fake tensor."""
    if not isinstance(op, G.TransformerOperator):
        return None
    from keystone_tpu_torch.workflow.executor import DatasetExpr

    deps = graph.dependencies.get(n, ())
    if len(deps) != 1:
        return None
    d = ex.results.get(deps[0])
    if not isinstance(d, DatasetExpr) or d.dataset.is_host:
        return None
    ds, t = d.dataset, op.transformer
    arr = TensorSpec((full_n,) + tuple(ds.array.shape[1:]), ds.array.dtype, str(ds.array.device))
    if ds.mask is not None:
        mask = TensorSpec((full_n,) + tuple(ds.mask.shape[1:]), ds.mask.dtype, str(ds.mask.device))
        cost = stage_cost(lambda a, m: t.apply_batch(a, mask=m), arr, mask)
    else:
        cost = stage_cost(lambda a: t.apply_batch(a), arr)
    return cost["seconds_est"] if cost else None


def device_hbm_budget(fraction: float = 0.5, device=None) -> int:
    """Cache budget in bytes: ``fraction`` of the card's memory
    (``torch.cuda.mem_get_info``'s total), leaving headroom for solver
    state and temporaries.  ``KEYSTONE_HBM_BUDGET_BYTES`` overrides the
    device's memory (before ``fraction``): the auto-out-of-core tests use
    it to provoke the over-budget path on small data.  A CPU device falls
    back to the reference's 16 GiB device, so 8 GiB at the default
    fraction."""
    env = os.environ.get("KEYSTONE_HBM_BUDGET_BYTES", "").strip()
    if env:
        try:
            return int(int(env) * fraction)
        except ValueError:
            logger.warning("KEYSTONE_HBM_BUDGET_BYTES=%r is not an int", env)
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1] * fraction)
    return int((16 << 30) * fraction)


#: Footprint estimate of the LAST ProfilingAutoCacheRule pass, read by
#: Pipeline.fit's auto-out-of-core decision (workflow/pipeline.py §
#: _auto_out_of_core).  A module global rather than a graph annotation:
#: rule batches rebuild Graph instances, so an annotation would not
#: survive the fusion pass that runs after materialization.
last_footprint: dict = {}


class ProfilingAutoCacheRule(Rule):
    """Greedy cache placement under a device-memory byte budget.

    ``static_cost=True`` prices nodes from their counted work at full
    batch (:func:`stage_cost`, free of timer noise) instead of
    extrapolated sampled wall time."""

    name = "ProfilingAutoCache"

    def __init__(self, budget_bytes: int = 8 << 30, sample_size: int = 64, static_cost: bool = False):
        self.budget_bytes = int(budget_bytes)
        self.sample_size = int(sample_size)
        self.static_cost = bool(static_cost)

    def apply(self, graph: G.Graph, device=None) -> G.Graph:
        # a previous fit's estimate must never leak into this fit's
        # auto-out-of-core decision
        last_footprint.clear()
        shared = [
            n for n in graph.topological_nodes()
            if isinstance(graph.operators.get(n), (G.TransformerOperator, G.GatherOperator))
            and len([d for d in graph.dependents(n) if not isinstance(d, G.SinkId)]) > 1
        ]
        if not shared:  # nothing to place: skip the sampling pass entirely
            return graph
        # debug/A-B knob: profile every node, not only the shared ones
        profile_all = os.environ.get("KEYSTONE_CACHE_PROFILE_ALL", "") == "1"
        profiles = profile_graph(graph, self.sample_size, static_cost=self.static_cost,
                                 targets=None if profile_all else frozenset(shared))
        seconds = _comparable_seconds(profiles)
        # most compute saved per byte pinned, first
        shared.sort(key=lambda n: -(seconds[n] / max(profiles[n].full_bytes, 1)) if n in profiles else 0.0)
        remaining = self.budget_bytes
        shared_bytes = pinned_bytes = demotions = 0
        for n in shared:
            prof = profiles.get(n)
            cost = prof.full_bytes if prof else 0
            shared_bytes += cost
            if cost <= remaining:
                remaining -= cost
                pinned_bytes += cost
                graph = _insert_cacher(graph, n)
            else:
                op = graph.operators[n]
                if isinstance(op, G.TransformerOperator):
                    demotions += 1
                    logger.info("over the device budget: %s (%.1f MB) will recompute per consumer", op.label(),
                                cost / 1e6)
                    # graphs share Operator instances: flag a fresh copy
                    flagged = G.TransformerOperator(op.transformer)
                    flagged.no_memoize = True
                    graph = graph.set_operator(n, flagged)
        last_footprint.update({"shared_bytes": int(shared_bytes), "budget_bytes": int(self.budget_bytes)})
        metrics.set_gauge("optimizer.pinned_bytes", float(pinned_bytes))
        if demotions:
            metrics.inc("optimizer.no_memoize_demotions", demotions)
        ledger.event("optimizer.cache_placement", shared_nodes=len(shared), pinned_bytes=int(pinned_bytes),
                     no_memoize_demotions=int(demotions), shared_bytes=int(shared_bytes),
                     budget_bytes=int(self.budget_bytes))
        return graph


def _comparable_seconds(profiles: Dict[G.NodeId, NodeProfile]) -> Dict[G.NodeId, float]:
    """Per-node cost in ONE unit.

    Roofline estimates are idealized lower bounds, often far below wall
    time; ranking them directly against extrapolated wall times of the
    nodes static pricing could not take (gathers, kernels, host nodes)
    would favor the wall-priced nodes.  Calibrate: the median
    roofline/wall ratio over nodes that have both, applied to the
    wall-only nodes, so every entry is in pseudo-roofline seconds."""
    ratios = [p.static_seconds / (p.seconds * p.scale) for p in profiles.values()
              if p.static_seconds is not None and p.seconds > 0]
    calib = float(np.median(ratios)) if ratios else 1.0
    return {n: p.static_seconds if p.static_seconds is not None else p.seconds * p.scale * calib
            for n, p in profiles.items()}


def _insert_cacher(graph: G.Graph, n: G.NodeId) -> G.Graph:
    deps_on_n = [d for d in graph.dependents(n) if isinstance(d, G.NodeId)]
    if any(isinstance(graph.operators.get(d), G.TransformerOperator)
           and isinstance(graph.operators[d].transformer, Cacher) for d in deps_on_n):
        return graph
    graph, cache_node = graph.add_node(G.TransformerOperator(Cacher()), (n,))
    for d in deps_on_n:
        if d != cache_node:
            graph = graph.set_dependencies(d, tuple(cache_node if x == n else x for x in graph.dependencies[d]))
    return graph
