"""Pipeline DAG representation (counterpart of
``keystone_tpu/workflow/graph.py``).

The reference's immutable dataflow graph (workflow/Graph.scala § Graph,
NodeId/SourceId/SinkId and workflow/Operator.scala § Operator kinds):
node outputs are Datasets of torch tensors on one device (or fitted
transformers), and the optimizer later fuses linear chains of
transformers into single sequential stages.

A graph has:
  - sources:       open inputs (bound to data when a pipeline is applied)
  - operators:     NodeId -> Operator
  - dependencies:  NodeId -> tuple of (NodeId | SourceId)
  - sink_dependencies: SinkId -> (NodeId | SourceId)

All editing methods return a new Graph (persistent-structure style), which
is what makes optimizer rules safe to compose.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple, Union


@dataclasses.dataclass(frozen=True, order=True)
class NodeId:
    id: int

    def __repr__(self):
        return f"n{self.id}"


@dataclasses.dataclass(frozen=True, order=True)
class SourceId:
    id: int

    def __repr__(self):
        return f"src{self.id}"


@dataclasses.dataclass(frozen=True, order=True)
class SinkId:
    id: int

    def __repr__(self):
        return f"sink{self.id}"


GraphId = Union[NodeId, SourceId]


class Operator:
    """A physical node kind (workflow/Operator.scala)."""

    def label(self) -> str:
        return type(self).__name__

    def signature(self):
        """Hashable identity for CSE merging; ``None`` disables merging."""
        return None


class DatasetOperator(Operator):
    """A literal dataset (workflow/DatasetOperator.scala)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def label(self):
        return "Dataset"

    def signature(self):
        name = getattr(self.dataset, "name", None)
        return ("dataset", name if name is not None else id(self.dataset))


class DatumOperator(Operator):
    """A literal single datum (workflow/DatumOperator.scala)."""

    def __init__(self, datum):
        self.datum = datum

    def label(self):
        return "Datum"

    def signature(self):
        return ("datum", id(self.datum))


class TransformerOperator(Operator):
    """Apply a Transformer (workflow/TransformerOperator.scala)."""

    def __init__(self, transformer):
        self.transformer = transformer

    def label(self):
        return self.transformer.label

    def signature(self):
        sig = self.transformer.signature()
        return None if sig is None else ("transform", sig)


class EstimatorOperator(Operator):
    """Fit an Estimator on its dependencies; yields a Transformer
    (workflow/EstimatorOperator.scala)."""

    def __init__(self, estimator):
        self.estimator = estimator

    def label(self):
        return f"fit[{self.estimator.label}]"

    def signature(self):
        sig = self.estimator.signature()
        return None if sig is None else ("fit", sig)


class DelegatingOperator(Operator):
    """Apply the transformer produced by dependency 0 to dependencies 1..n
    (workflow/DelegatingOperator.scala)."""

    def label(self):
        return "apply"

    def signature(self):
        return ("delegate",)


class GatherOperator(Operator):
    """Concatenate the feature outputs of N branch dependencies
    (workflow/Pipeline.scala § Pipeline.gather / GatherTransformer).

    The reference gathers branch outputs into a Seq per datum which
    pipelines immediately concatenate; here gather concatenates along the
    trailing (feature) axis directly (``torch.cat``)."""

    def label(self):
        return "Gather"

    def signature(self):
        return ("gather",)


class Graph:
    def __init__(
        self,
        sources: Tuple[SourceId, ...] = (),
        operators: Optional[Dict[NodeId, Operator]] = None,
        dependencies: Optional[Dict[NodeId, Tuple[GraphId, ...]]] = None,
        sink_dependencies: Optional[Dict[SinkId, GraphId]] = None,
    ):
        self.sources = tuple(sources)
        self.operators = dict(operators or {})
        self.dependencies = dict(dependencies or {})
        self.sink_dependencies = dict(sink_dependencies or {})

    # ---------------------------------------------------------------- ids
    def _next_id(self) -> int:
        used = [i.id for i in self.operators]
        used += [s.id for s in self.sources]
        used += [s.id for s in self.sink_dependencies]
        return max(used, default=-1) + 1

    @property
    def nodes(self) -> Tuple[NodeId, ...]:
        return tuple(self.operators.keys())

    @property
    def sinks(self) -> Tuple[SinkId, ...]:
        return tuple(self.sink_dependencies.keys())

    # ------------------------------------------------------------ editing
    def add_source(self) -> Tuple["Graph", SourceId]:
        sid = SourceId(self._next_id())
        g = Graph(
            self.sources + (sid,), self.operators, self.dependencies, self.sink_dependencies
        )
        return g, sid

    def add_node(self, op: Operator, deps: Tuple[GraphId, ...]) -> Tuple["Graph", NodeId]:
        nid = NodeId(self._next_id())
        ops = dict(self.operators)
        ops[nid] = op
        dep = dict(self.dependencies)
        dep[nid] = tuple(deps)
        return Graph(self.sources, ops, dep, self.sink_dependencies), nid

    def add_sink(self, dep: GraphId) -> Tuple["Graph", SinkId]:
        kid = SinkId(self._next_id())
        sinks = dict(self.sink_dependencies)
        sinks[kid] = dep
        return Graph(self.sources, self.operators, self.dependencies, sinks), kid

    def set_operator(self, node: NodeId, op: Operator) -> "Graph":
        ops = dict(self.operators)
        ops[node] = op
        return Graph(self.sources, ops, self.dependencies, self.sink_dependencies)

    def set_dependencies(self, node: NodeId, deps: Tuple[GraphId, ...]) -> "Graph":
        dep = dict(self.dependencies)
        dep[node] = tuple(deps)
        return Graph(self.sources, self.operators, dep, self.sink_dependencies)

    def replace_dependency(self, old: GraphId, new: GraphId) -> "Graph":
        """Point every edge into ``old`` at ``new`` instead."""
        dep = {
            n: tuple(new if d == old else d for d in ds)
            for n, ds in self.dependencies.items()
        }
        sinks = {k: (new if d == old else d) for k, d in self.sink_dependencies.items()}
        return Graph(self.sources, self.operators, dep, sinks)

    def remove_node(self, node: NodeId) -> "Graph":
        ops = {n: o for n, o in self.operators.items() if n != node}
        dep = {n: d for n, d in self.dependencies.items() if n != node}
        return Graph(self.sources, ops, dep, self.sink_dependencies)

    def remove_source(self, source: SourceId) -> "Graph":
        return Graph(
            tuple(s for s in self.sources if s != source),
            self.operators,
            self.dependencies,
            self.sink_dependencies,
        )

    def remove_sink(self, sink: SinkId) -> "Graph":
        sinks = {k: d for k, d in self.sink_dependencies.items() if k != sink}
        return Graph(self.sources, self.operators, self.dependencies, sinks)

    def replace_source_with_node(self, source: SourceId, op: Operator) -> Tuple["Graph", NodeId]:
        """Bind a source to a literal operator (how pipeline.apply(data) works)."""
        g, nid = self.add_node(op, ())
        g = g.replace_dependency(source, nid)
        return g.remove_source(source), nid

    # ---------------------------------------------------------- combining
    def union(self, other: "Graph") -> Tuple["Graph", Dict]:
        """Disjoint union; returns (combined, mapping from other's ids to new ids)."""
        counter = itertools.count(self._next_id())
        mapping: Dict = {}

        def remap(i):
            if i not in mapping:
                newid = next(counter)
                mapping[i] = type(i)(newid)
            return mapping[i]

        sources = self.sources + tuple(remap(s) for s in other.sources)
        ops = dict(self.operators)
        deps = dict(self.dependencies)
        for n, op in other.operators.items():
            ops[remap(n)] = op
        for n, ds in other.dependencies.items():
            deps[remap(n)] = tuple(remap(d) for d in ds)
        sinks = dict(self.sink_dependencies)
        for k, d in other.sink_dependencies.items():
            sinks[remap(k)] = remap(d)
        return Graph(sources, ops, deps, sinks), mapping

    def connect(self, sink: SinkId, source: SourceId) -> "Graph":
        """Splice: feed this graph's ``sink`` value into ``source``'s consumers."""
        dep = self.sink_dependencies[sink]
        g = self.remove_sink(sink)
        g = g.replace_dependency(source, dep)
        return g.remove_source(source)

    # ---------------------------------------------------------- analysis
    def dependents(self, target: GraphId) -> Tuple[GraphId, ...]:
        out = [n for n, ds in self.dependencies.items() if target in ds]
        out += [k for k, d in self.sink_dependencies.items() if d == target]
        return tuple(out)

    def ancestors(self, target: GraphId) -> Tuple[GraphId, ...]:
        seen = []

        def walk(i):
            if isinstance(i, NodeId):
                for d in self.dependencies[i]:
                    if d not in seen:
                        seen.append(d)
                        walk(d)

        walk(target)
        return tuple(seen)

    def topological_nodes(self) -> Tuple[NodeId, ...]:
        order, seen = [], set()

        def visit(i):
            if i in seen or not isinstance(i, NodeId):
                return
            seen.add(i)
            for d in self.dependencies[i]:
                visit(d)
            order.append(i)

        for k in sorted(self.sink_dependencies, key=lambda s: s.id):
            visit(self.sink_dependencies[k])
        for n in sorted(self.operators, key=lambda n: n.id):
            visit(n)
        return tuple(order)

    def prefix_signature(self, target: GraphId, _memo=None) -> Optional[tuple]:
        """Structural hash of the subgraph rooted at ``target``.

        Two nodes with equal prefix signatures compute the same value —
        the merge criterion of the CSE rule
        (workflow/EquivalentNodeMergeRule.scala).
        """
        if _memo is None:
            _memo = {}
        if target in _memo:
            return _memo[target]
        if isinstance(target, SourceId):
            result = ("source", target.id)
        else:
            sig = self.operators[target].signature()
            if sig is None:
                result = ("unique", target.id)
            else:
                deps = tuple(
                    self.prefix_signature(d, _memo) for d in self.dependencies[target]
                )
                if any(d is None for d in deps):
                    result = ("unique", target.id)
                else:
                    result = ("node", sig, deps)
        _memo[target] = result
        return result

    def __repr__(self):
        lines = [f"Graph(sources={list(self.sources)})"]
        for n in self.topological_nodes():
            deps = ", ".join(map(repr, self.dependencies[n]))
            lines.append(f"  {n!r} = {self.operators[n].label()}({deps})")
        for k, d in self.sink_dependencies.items():
            lines.append(f"  {k!r} <- {d!r}")
        return "\n".join(lines)
