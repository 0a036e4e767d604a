"""Demand-driven, memoizing DAG executor (counterpart of
``keystone_tpu/workflow/executor.py`` § GraphExecutor, _apply_transformer,
_gather, _fit_estimator).

Reference: workflow/GraphExecutor.scala § GraphExecutor — a topological
demand-driven walk that memoizes per-node results ("Expressions"); fit
nodes execute once and their fitted transformers are reused by all
dependents.

Results here are:
  - DatasetExpr: a Dataset of tensors on one device (or a host list), or
    a StreamDataset, which stays a lazy recipe: memoizing one keeps the
    recipe, and each consumer re-sweeps its source
  - DatumExpr: a single value
  - TransformerExpr: a fitted Transformer (output of estimator nodes)

The walk queues device work and never waits on it, unless ``profile``
asks for per-node timings: then each node ends in a device synchronize,
so its seconds are its own.  An operator flagged ``no_memoize`` (by the
cache rule, ``workflow/profiling.py``, when its output is over the
device budget) is not memoized: each consumer recomputes it.

Each stage runs inside the operations layer, as in the reference:

- ``node_retries`` re-runs a failed stage with jittered backoff
  (``PipelineEnv.stage_retries()``, ``KEYSTONE_STAGE_RETRIES``);
- a ``deadline`` for the whole walk is apportioned over the stages not
  yet run, capped by ``KEYSTONE_STAGE_DEADLINE``; each attempt runs under
  ``utils/guard.run_with_deadline``'s watchdog, whose overrun raises
  ``DeadlineExceeded`` (an ``OSError``) inside the retry scope;
- ``KEYSTONE_BREAKER_THRESHOLD`` gives each node a circuit breaker; an
  open breaker, or a spent budget, degrades a node that declares
  ``optional`` or ``with_fallback`` to its substitute;
- the ``executor.stage`` fault site fires inside the watchdog, each stage
  runs in an ``executor.stage`` ledger span, and the counters
  ``executor.stage_retries``, ``executor.failed_attempt_seconds`` and
  ``executor.degraded`` record what the retries cost.

With no deadline, no breaker threshold, no plan and no ledger, a stage
costs a few ``None`` checks and a counter bump: no thread, no
synchronize.  The serving path (``FrozenApplier``, ``keystone_tpu_torch/
serve``) runs each flush as one such walk.  The reference's shared-stage
pool for co-served pipelines (``workflow/stage_pool.py``) comes with the
multi-tenant service (ROADMAP A11d).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Any, Dict, Optional

import torch

from keystone_tpu_torch.faults import fault_point
from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.utils import guard
from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset, as_dataset
from keystone_tpu_torch.workflow.estimator import Estimator, LabelEstimator
from keystone_tpu_torch.workflow.transformer import Identity, Transformer

logger = logging.getLogger(__name__)

#: per-process monotonic discriminators for signatureless nodes' breaker
#: keys (see GraphExecutor._stage_breaker), stamped on the object so the
#: key is stable for its lifetime and never recycled as id()s are
_BREAKER_TOKENS = itertools.count()


@dataclasses.dataclass
class DatumExpr:
    value: Any


@dataclasses.dataclass
class DatasetExpr:
    dataset: Dataset


@dataclasses.dataclass
class TransformerExpr:
    transformer: Transformer


class GraphExecutor:
    def __init__(self, graph: G.Graph, profile: bool = False, node_retries: Optional[int] = None, deadline=None):
        """``node_retries``: re-run a failed stage up to this many times
        before it propagates (stages are pure functions of memoized
        inputs, so a re-run is safe); None reads
        ``PipelineEnv.stage_retries()``.  ``deadline``: a wall-clock
        budget (seconds or a ``utils.guard.Deadline``) for this
        executor's whole walk."""
        self.graph = graph
        self.results: Dict[G.GraphId, Any] = {}
        self.profile = profile
        if node_retries is None:
            from keystone_tpu_torch.workflow.pipeline import PipelineEnv

            node_retries = PipelineEnv.stage_retries()
        self.node_retries = max(0, int(node_retries))
        #: seconds by node, each ended by a device synchronize (profile only)
        self.timings: Dict[G.NodeId, float] = {}
        self.deadline = guard.as_deadline(deadline)
        self._stage_seconds = guard.stage_deadline_seconds()
        self._breaker_threshold = guard.stage_breaker_threshold()

    def execute(self, target: G.GraphId):
        if isinstance(target, G.SinkId):
            target = self.graph.sink_dependencies[target]
        return self._eval(target)

    def _eval(self, target: G.GraphId):
        if target in self.results:
            return self.results[target]
        if isinstance(target, G.SourceId):
            raise RuntimeError(f"unbound source {target}: apply the pipeline to data before executing")
        op = self.graph.operators[target]
        deps = [self._eval(d) for d in self.graph.dependencies[target]]
        brk = self._stage_breaker(op)
        delays = None
        failed_seconds = 0.0
        degraded = False
        attempts_made = 0
        with ledger.span("executor.stage", node=op.label(), node_id=target.id) as sp:
            if brk is not None and not brk.allow():
                # an open breaker: spend no attempt on a stage presumed
                # broken; degrade at once, or refuse with CircuitOpenError
                t0 = time.perf_counter()
                result = self._degrade(op, deps, reason="breaker_open")
                degraded = True
            else:
                for attempt in range(self.node_retries + 1):
                    attempts_made = attempt + 1
                    # per attempt: a profile charges the node its successful
                    # attempt only, not failed ones or the backoff
                    t0 = time.perf_counter()
                    try:
                        result = guard.run_with_deadline(
                            lambda: self._attempt(op, deps), self._attempt_deadline(),
                            site="executor.stage", node=op.label())
                        if brk is not None:
                            brk.record_success()
                        break
                    except Exception as e:
                        failed_seconds += time.perf_counter() - t0
                        # a blown walk budget ends the retries: every further
                        # attempt would be born expired.  Such attempts are
                        # no evidence against the node, so its breaker is not
                        # charged; a breaker this failure opened ends them too
                        budget_blown = self.deadline is not None and self.deadline.expired()
                        if brk is not None and not budget_blown:
                            brk.record_failure()
                        breaker_opened = brk is not None and brk.state() == guard.OPEN
                        if attempt >= self.node_retries or budget_blown or breaker_opened:
                            if _degradable(op) is not None:
                                t0 = time.perf_counter()
                                result = self._degrade(op, deps, reason="budget_exhausted", error=e)
                                degraded = True
                                break
                            if failed_seconds:
                                metrics.inc("executor.failed_attempt_seconds", failed_seconds)
                            raise
                        metrics.inc("executor.stage_retries")
                        ledger.event("executor.retry", node=op.label(), attempt=attempt + 1,
                                     error=f"{type(e).__name__}: {e}"[:200])
                        logger.warning("stage %s failed (%s); retry %d/%d", op.label(), e, attempt + 1,
                                       self.node_retries)
                        if delays is None:
                            from keystone_tpu_torch.utils.durable import backoff_delays

                            delays = iter(backoff_delays(self.node_retries, base_delay=0.05, max_delay=1.0))
                        time.sleep(next(delays, 1.0))
            if failed_seconds:
                # retry-budget cost, not the node's compute profile
                metrics.inc("executor.failed_attempt_seconds", failed_seconds)
            if sp is not None:
                sp.set(attempts=attempts_made, retries=max(0, attempts_made - 1))
                if degraded:
                    sp.set(degraded=True)
                if failed_seconds:
                    sp.set(failed_attempt_seconds=failed_seconds)
            if self.profile:
                synchronize()
                self.timings[target] = time.perf_counter() - t0
        if not getattr(op, "no_memoize", False):
            # a node over the device budget (workflow/profiling.py) is
            # recomputed for each consumer instead of pinned
            self.results[target] = result
        return result

    def _attempt(self, op, deps):
        """One attempt of a stage: its fault site, then its body.  Inside
        the watchdog, so an injected hang becomes ``DeadlineExceeded``.  An
        attempt whose watchdog gave up during the stall does not start the
        body: its result could only be dropped."""
        fault_point("executor.stage", node=op.label())
        cancel = guard.current_cancel()
        if cancel is not None and cancel.is_set():
            raise guard.DeadlineExceeded("executor.stage", 0.0)
        return self._execute_op(op, deps)

    def _attempt_deadline(self):
        """The watchdog budget of one attempt, or None (the inert path: no
        thread).  With a walk deadline, the remaining time split evenly
        over the nodes not yet run (recomputed each stage, so early
        finishers donate their slack), capped by KEYSTONE_STAGE_DEADLINE."""
        if self.deadline is None:
            if self._stage_seconds is None:
                return None
            return guard.Deadline.after(self._stage_seconds)
        remaining_nodes = max(1, len(self.graph.operators) - len(self.results))
        share = self.deadline.remaining() / remaining_nodes
        if self._stage_seconds is not None:
            share = min(share, self._stage_seconds)
        return self.deadline.child(share)

    def _stage_breaker(self, op):
        """The node's circuit breaker, or None when breakers are off (no
        KEYSTONE_BREAKER_THRESHOLD).  The key adds the transformer's
        signature to its label when it has one (parameter-identical nodes
        share breaker state across fits in this process), else a token
        stamped on the transformer or operator object: a label alone
        collides, and one flaky node must not open a healthy twin's."""
        if self._breaker_threshold is None:
            return None
        t = getattr(op, "transformer", None)
        sig = None
        if t is not None:
            try:
                sig = t.signature()
            except Exception:
                sig = None
        if sig is not None:
            disc = f"{hash(sig) & 0xFFFFFFFF:08x}"
        else:
            obj = t if t is not None else op
            disc = getattr(obj, "_breaker_token", None)
            if disc is None:
                disc = f"t{next(_BREAKER_TOKENS)}"
                try:
                    object.__setattr__(obj, "_breaker_token", disc)
                except AttributeError:
                    pass  # an unwritable object: a token per executor
        return guard.breaker(f"executor.stage:{op.label()}:{disc}", threshold=self._breaker_threshold)

    def _degrade(self, op, deps, reason: str, error=None):
        """Apply the node's substitute (its declared fallback, or Identity
        for an ``optional`` node) in place of the node, with a
        ``degraded`` ledger event and counter.  A node that declares
        neither, refused by its breaker, raises ``CircuitOpenError``: a
        mandatory stage is never skipped silently."""
        sub = _degradable(op)
        if sub is None:
            raise guard.CircuitOpenError(
                f"stage {op.label()!r}: circuit breaker is open and the node declares no fallback/optional "
                "degradation")
        metrics.inc("executor.degraded", node=op.label())
        ledger.event("degraded", node=op.label(), substitute=sub.label, reason=reason,
                     error=None if error is None else f"{type(error).__name__}: {error}"[:200])
        logger.warning("stage %s degraded to %s (%s)", op.label(), sub.label, reason)
        return _apply_transformer(sub, deps)

    def _execute_op(self, op: G.Operator, deps):
        if isinstance(op, G.DatasetOperator):
            return DatasetExpr(as_dataset(op.dataset))
        if isinstance(op, G.DatumOperator):
            return DatumExpr(op.datum)
        if isinstance(op, G.TransformerOperator):
            return _apply_transformer(op.transformer, deps)
        if isinstance(op, G.EstimatorOperator):
            return _fit_estimator(op.estimator, deps)
        if isinstance(op, G.DelegatingOperator):
            t = deps[0]
            if not isinstance(t, TransformerExpr):
                raise TypeError("DelegatingOperator expects a fitted transformer dep 0")
            return _apply_transformer(t.transformer, deps[1:])
        if isinstance(op, G.GatherOperator):
            return _gather(deps)
        raise TypeError(f"unknown operator {op!r}")


def _degradable(op):
    """The substitute a failed node degrades to: its declared
    ``fallback``, Identity for an ``optional`` node, else None (the node
    is mandatory: its failure propagates)."""
    t = getattr(op, "transformer", None)
    if t is None:
        return None
    fb = getattr(t, "fallback", None)
    if fb is not None:
        return fb
    if getattr(t, "optional", False):
        return Identity()
    return None


def synchronize() -> None:
    """Wait for the current CUDA device's queued work (nothing without a card)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _apply_transformer(t: Transformer, deps):
    if len(deps) != 1:
        raise ValueError(f"{t.label}: transformers are unary, got {len(deps)} deps")
    d = deps[0]
    if isinstance(d, DatasetExpr):
        return DatasetExpr(t.apply_dataset(d.dataset))
    if isinstance(d, DatumExpr):
        return DatumExpr(t.apply_one(d.value))
    raise TypeError(f"{t.label}: cannot apply to {d!r}")


def _gather(deps):
    if all(isinstance(d, DatasetExpr) for d in deps):
        if any(isinstance(d.dataset, StreamDataset) for d in deps):
            if not all(isinstance(d.dataset, StreamDataset) for d in deps):
                raise TypeError("Gather mixes streaming and materialized branches; "
                                "the branches of one source are either all streams or none")
            return DatasetExpr(StreamDataset.zip_concat([d.dataset for d in deps]))
        base = deps[0].dataset
        return DatasetExpr(base.with_array(torch.cat([d.dataset.array for d in deps], dim=-1)))
    if all(isinstance(d, DatumExpr) for d in deps):
        return DatumExpr(torch.cat([torch.as_tensor(d.value) for d in deps], dim=-1))
    raise TypeError("Gather expects homogeneous dataset or datum deps")


def _fit_estimator(est: Estimator, deps):
    data = deps[0]
    if not isinstance(data, DatasetExpr):
        raise TypeError(f"{est.label}.fit expects a dataset dependency")
    if isinstance(est, LabelEstimator):
        if len(deps) < 2 or not isinstance(deps[1], DatasetExpr):
            raise TypeError(f"{est.label}.fit expects (data, labels) dataset deps")
        fitted = est.fit_dataset(data.dataset, deps[1].dataset)
    else:
        fitted = est.fit_dataset(data.dataset)
    return TransformerExpr(fitted)
