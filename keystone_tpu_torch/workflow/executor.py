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
so its seconds are its own.  The reference's deadline watchdog, stage
retries, circuit breakers, degradation and shared-stage pool wait for
the port's operations layer (ROADMAP A9, A11).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import torch

from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset, as_dataset
from keystone_tpu_torch.workflow.estimator import Estimator, LabelEstimator
from keystone_tpu_torch.workflow.transformer import Transformer


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
    def __init__(self, graph: G.Graph, profile: bool = False):
        self.graph = graph
        self.results: Dict[G.GraphId, Any] = {}
        self.profile = profile
        #: seconds by node, each ended by a device synchronize (profile only)
        self.timings: Dict[G.NodeId, float] = {}

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
        t0 = time.perf_counter()
        result = self._execute_op(op, deps)
        if self.profile:
            synchronize()
            self.timings[target] = time.perf_counter() - t0
        self.results[target] = result
        return result

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
