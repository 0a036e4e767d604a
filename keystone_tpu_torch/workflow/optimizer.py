"""Whole-pipeline optimizer (counterpart of
``keystone_tpu/workflow/optimizer.py``).

Reference: workflow/Optimizer.scala — a Catalyst-style rule executor
(batches with Once/FixedPoint strategies) over the pipeline Graph, with
three rule families:

  - EquivalentNodeMergeRule: CSE — merge structurally identical subgraphs
    so e.g. two branches sharing SIFT compute it once.
  - AutoCacheRule: decide which shared outputs to materialize (the
    profiled, budgeted pass of ``workflow/profiling.py``).
  - NodeOptimizationRule: per-node physical operator choice from sampled
    data statistics.

On top of those, StageFusionRule turns maximal linear chains of
transformers into one sequential stage (``FusedTransformer``), and
FvFusionRule rewrites each PCA → Fisher-vector pair into the fused
Fisher-vector kernel's node where the data lives on a CUDA device.
"""

from __future__ import annotations

import copy
import inspect
import logging
import os
import time
from typing import Optional, Sequence

import torch
from torch import nn

from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset, as_dataset
from keystone_tpu_torch.workflow.estimator import Estimator
from keystone_tpu_torch.workflow.transformer import Cacher, Transformer

logger = logging.getLogger(__name__)


class Rule:
    name: str = "rule"

    def apply(self, graph: G.Graph, device=None) -> G.Graph:
        """``device``: where the graph will run, for a graph optimized
        before any data is bound to it (``FrozenApplier``); a rule that
        decides by the bound data's device decides by it instead, the
        others ignore it."""
        raise NotImplementedError


class Once:
    def __init__(self):
        self.max_iterations = 1


class FixedPoint:
    def __init__(self, max_iterations: int = 20):
        self.max_iterations = max_iterations


class RuleBatch:
    def __init__(self, name: str, strategy, rules: Sequence[Rule]):
        self.name = name
        self.strategy = strategy
        self.rules = list(rules)


class Optimizer:
    """Executes rule batches until their strategy is exhausted or the graph
    stops changing (workflow/Optimizer.scala § RuleExecutor.execute)."""

    def __init__(self, batches: Sequence[RuleBatch]):
        self.batches = list(batches)

    def execute(self, graph: G.Graph, device=None) -> G.Graph:
        """Each rule's seconds land in ``optimizer.rule_seconds{rule=...}``
        and, with a run ledger, an ``optimizer.rule`` event inside the
        ``optimizer.execute`` span.  ``device`` goes to every rule's
        ``apply`` (see :meth:`Rule.apply`)."""
        with ledger.span("optimizer.execute"):
            for batch in self.batches:
                for _ in range(batch.strategy.max_iterations):
                    before = _graph_fingerprint(graph)
                    for rule in batch.rules:
                        t0 = time.perf_counter()
                        graph = rule.apply(graph, device=device)
                        dt = time.perf_counter() - t0
                        metrics.observe("optimizer.rule_seconds", dt, rule=rule.name)
                        ledger.event("optimizer.rule", rule=rule.name, batch=batch.name, seconds=dt)
                    if _graph_fingerprint(graph) == before:
                        break
        return graph


def _graph_fingerprint(g: G.Graph):
    return (
        tuple(sorted((n.id, id(op)) for n, op in g.operators.items())),
        tuple(sorted((n.id, tuple(d.id for d in ds)) for n, ds in g.dependencies.items())),
    )


# --------------------------------------------------------------------- CSE
class EquivalentNodeMergeRule(Rule):
    """Merge nodes whose operator + entire input prefix are structurally
    equal (workflow/EquivalentNodeMergeRule.scala).  This is what makes
    ``Pipeline.gather`` branches sharing a SIFT prefix compute it once."""

    name = "EquivalentNodeMerge"

    def apply(self, graph: G.Graph, device=None) -> G.Graph:
        memo: dict = {}
        groups: dict = {}
        for n in graph.topological_nodes():
            sig = graph.prefix_signature(n, memo)
            if sig is not None and sig[0] != "unique":
                groups.setdefault(sig, []).append(n)
        for nodes in groups.values():
            if len(nodes) < 2:
                continue
            keep = min(nodes)
            for other in nodes:
                if other == keep:
                    continue
                graph = graph.replace_dependency(other, keep)
                graph = graph.remove_node(other)
        return graph


# ----------------------------------------------------------- materialization
class AutoMaterializeRule(Rule):
    """Insert Cacher nodes after outputs consumed by >1 dependent.

    The reference's AutoCacheRule profiles nodes on sampled partitions and
    greedily places ``.cache()`` calls under a cluster-memory budget
    (workflow/AutoCacheRule.scala); that is ``ProfiledMaterializeRule``
    below.  This is its structural fallback: every shared output gets an
    explicit materialization barrier, which also pins it as a stage
    boundary for the fusion rule.
    """

    name = "AutoMaterialize"

    def apply(self, graph: G.Graph, device=None) -> G.Graph:
        for n in list(graph.topological_nodes()):
            op = graph.operators.get(n)
            if not isinstance(op, G.TransformerOperator) or isinstance(op.transformer, Cacher):
                continue
            deps_on_n = [d for d in graph.dependents(n) if not isinstance(d, G.SinkId)]
            already = any(
                isinstance(graph.operators.get(d), G.TransformerOperator)
                and isinstance(graph.operators[d].transformer, Cacher)
                for d in deps_on_n
                if isinstance(d, G.NodeId)
            )
            if len(deps_on_n) > 1 and not already:
                graph, cache_node = graph.add_node(G.TransformerOperator(Cacher()), (n,))
                for d in deps_on_n:
                    if isinstance(d, G.NodeId):
                        graph = graph.set_dependencies(
                            d, tuple(cache_node if x == n else x for x in graph.dependencies[d])
                        )
        return graph


class ProfiledMaterializeRule(Rule):
    """The default materialization pass, the reference's: the budgeted
    ``ProfilingAutoCacheRule`` (``workflow/profiling.py``) with the budget
    read from the device the graph runs on (``torch.cuda.mem_get_info``),
    falling back to the structural AutoMaterializeRule when profiling
    fails.  The fallback logs a warning and counts
    ``optimizer.materialize_fallbacks``."""

    name = "ProfiledMaterialize"
    #: rows of each dataset literal the profiled pass reads (fewer than
    #: node choice's: it executes the shared nodes' whole prefix)
    sample_size = 64

    def __init__(self, sample_size: Optional[int] = None):
        if sample_size is not None:
            self.sample_size = int(sample_size)

    def apply(self, graph: G.Graph, device=None) -> G.Graph:
        from keystone_tpu_torch.workflow.profiling import ProfilingAutoCacheRule, device_hbm_budget

        try:
            return ProfilingAutoCacheRule(budget_bytes=device_hbm_budget(device=data_device(graph, device)),
                                          sample_size=self.sample_size, static_cost=True).apply(graph)
        except Exception as e:
            logger.warning("profiled materialization failed (%s); using the structural rule", e)
            metrics.inc("optimizer.materialize_fallbacks")
            return AutoMaterializeRule().apply(graph)


# ------------------------------------------------------------- node choice
class NodeChoiceRule(Rule):
    """Physical operator selection (workflow/NodeOptimizationRule).

    For estimators and transformers that override ``choose_physical``,
    executes the node's input subgraph on a small sample (the analogue of
    the reference's optimizer-time sampling Spark jobs) and lets the node
    pick its best physical implementation.  Nodes that do not override it
    cost nothing here.
    """

    name = "NodeChoice"
    #: rows of each dataset literal the sampled run reads
    sample_size = 256

    def __init__(self, sample_size: Optional[int] = None):
        if sample_size is not None:
            self.sample_size = int(sample_size)

    def apply(self, graph: G.Graph, device=None) -> G.Graph:
        from keystone_tpu_torch.workflow.executor import DatasetExpr, GraphExecutor

        # the full row count: a size-based choice (the local solve) looks
        # past the truncated sample
        full_n = max((op.dataset.n if isinstance(op.dataset, Dataset) else len(op.dataset)
                      for op in graph.operators.values() if isinstance(op, G.DatasetOperator)), default=None)
        for n in list(graph.topological_nodes()):
            op = graph.operators.get(n)
            if isinstance(op, G.EstimatorOperator):
                node, base, rewrap = op.estimator, Estimator, G.EstimatorOperator
            elif isinstance(op, G.TransformerOperator):
                node, base, rewrap = op.transformer, Transformer, G.TransformerOperator
            else:
                continue
            if type(node).choose_physical is base.choose_physical:
                continue
            sample = None
            try:
                expr = GraphExecutor(_truncate_datasets(graph, self.sample_size)).execute(graph.dependencies[n][0])
                if isinstance(expr, DatasetExpr):
                    sample = expr.dataset
            except Exception as e:  # sampling is best-effort, like upstream
                logger.debug("node-choice sampling failed for %s: %s", node.label, e)
            # as the reference's rule: the base hook and the overrides that
            # choose from the sample alone take the sample only
            if "full_n" in inspect.signature(node.choose_physical).parameters:
                chosen = node.choose_physical(sample, full_n=full_n)
            else:
                chosen = node.choose_physical(sample)
            if chosen is not node:
                logger.info("node choice: %s -> %s", node.label, chosen.label)
                graph = graph.set_operator(n, rewrap(chosen))
        return graph


def _truncate_datasets(graph: G.Graph, k: int) -> G.Graph:
    """The graph with its dataset literals cut to their first k rows.  A
    stream gives the rows of its first batches: materializing it to cut
    it would defeat out-of-core (the reference's AutoCacheRule samples
    partitions the same way)."""
    for n, op in list(graph.operators.items()):
        if not isinstance(op, G.DatasetOperator):
            continue
        ds = as_dataset(op.dataset)
        if isinstance(ds, StreamDataset):
            graph = graph.set_operator(n, G.DatasetOperator(_stream_head(ds, k)))
            continue
        if ds.n <= k:
            continue
        if ds.is_host:
            sliced = Dataset(ds.items[:k], device=ds.device)
        else:
            sliced = Dataset(ds.array[:k], mask=None if ds.mask is None else ds.mask[:k])
        graph = graph.set_operator(n, G.DatasetOperator(sliced))
    return graph


def _stream_head(ds: StreamDataset, k: int) -> Dataset:
    """The first k rows of a stream, masks kept (or sampled nodes would
    take padded descriptor rows for data); a host stream's first k items."""
    if ds.is_host:
        items: list = []
        for batch in ds.batches():
            items.extend(batch)
            if len(items) >= k:
                break
        if not items:
            raise ValueError("empty stream")
        return Dataset(items[:k], device=ds.device)
    parts, masks, got = [], [], 0
    for arr, mask in ds.device_batches():
        parts.append(arr)
        if mask is not None:
            masks.append(mask)
        got += arr.shape[0]
        if got >= k:
            break
    if not parts:
        raise ValueError("empty stream")
    return Dataset(torch.cat(parts)[:k], mask=torch.cat(masks)[:k] if masks else None)


# ------------------------------------------------------------- stage fusion
class FusedTransformer(Transformer):
    """A linear chain of transformers applied as one stage, each stage's
    batch path in turn, the ragged mask threaded through.  The reference
    compiles such a chain into one jit program; here it is one node of
    the graph, so a chain costs one executor step and one pass over its
    dataset's row chunks.  It is also the port's eager chain: the scorer
    built from arrays is one."""

    def __init__(self, stages: Sequence[Transformer]):
        super().__init__()
        self.stages = nn.ModuleList(stages)

    @property
    def label(self):
        return "Fused[" + " > ".join(s.label for s in self.stages) + "]"

    @property
    def fusable(self) -> bool:
        return all(s.fusable for s in self.stages)

    def params(self):
        ps = tuple(s.params() for s in self.stages)
        return None if any(p is None for p in ps) else ps

    def apply_batch(self, xs, mask=None):
        for s in self.stages:
            out = s.apply_batch(xs, mask=mask)
            xs, mask = out if isinstance(out, tuple) else (out, None)
        return xs if mask is None else (xs, mask)

    def apply_dataset(self, ds: Dataset) -> Dataset:
        """A host payload (the text apps' CSR rows) goes through the first
        stage's own ``apply_dataset`` (the sparse scorers'), the rest of
        the chain on the tensor it makes.  The reference maps such a
        payload item by item through the chain, with the same result."""
        if ds.is_host:
            out = self.stages[0].apply_dataset(ds)
            rest = list(self.stages)[1:]
            return FusedTransformer(rest).apply_dataset(out) if rest else out
        return super().apply_dataset(ds)


class StageFusionRule(Rule):
    """Fuse consecutive single-consumer device TransformerOperators."""

    name = "StageFusion"

    def apply(self, graph: G.Graph, device=None) -> G.Graph:
        changed = True
        while changed:
            changed = False
            for n in graph.topological_nodes():
                op = graph.operators.get(n)
                if not _fusable(op):
                    continue
                deps_on_n = graph.dependents(n)
                if len(deps_on_n) != 1 or isinstance(deps_on_n[0], G.SinkId):
                    continue
                m = deps_on_n[0]
                mop = graph.operators.get(m)
                if not _fusable(mop) or graph.dependencies[m] != (n,):
                    continue
                graph = graph.set_operator(m, _carry_no_memoize(mop, FusedTransformer(_stages(op) + _stages(mop))))
                graph = graph.set_dependencies(m, graph.dependencies[n])
                graph = graph.remove_node(n)
                changed = True
                break
        return graph


def _carry_no_memoize(op, fused: Transformer) -> G.TransformerOperator:
    """The fused node's operator: its output is ``op``'s, so it carries the
    cache rule's over-budget flag, or the executor would pin the very
    output the device cannot afford.  (The node fused into it had one
    consumer: its output is gone.)"""
    out = G.TransformerOperator(fused)
    if getattr(op, "no_memoize", False):
        out.no_memoize = True
    return out


def _fusable(op) -> bool:
    return (
        isinstance(op, G.TransformerOperator)
        and not op.transformer.is_host
        and getattr(op.transformer, "fusable", True)
        and not isinstance(op.transformer, Cacher)
        and _plain(op)
    )


def _plain(op) -> bool:
    """False for a stage that declares degradation (``optional``,
    ``with_fallback``): it stays a node of its own, or the executor would
    degrade a whole fused chain where one stage was meant to."""
    t = op.transformer
    return not getattr(t, "optional", False) and getattr(t, "fallback", None) is None


def _stages(op) -> list:
    t = op.transformer
    return list(t.stages) if isinstance(t, FusedTransformer) else [t]


# ------------------------------------------------------------ FV fusion
def data_device(graph: G.Graph, device=None) -> torch.device:
    """Where ``graph`` runs: ``device`` when given (a graph optimized before
    data is bound to it), else the CUDA device of its bound data, else the
    CPU."""
    if device is not None:
        return torch.device(device)
    for op in graph.operators.values():
        if isinstance(op, G.DatasetOperator):
            ds = op.dataset
            if isinstance(ds, Dataset):
                # the device, not the array: a stream's array would
                # materialize it
                if not ds.is_host and ds.device.type == "cuda":
                    return ds.device
            elif isinstance(ds, torch.Tensor) and ds.is_cuda:
                return ds.device
        elif isinstance(op, G.DatumOperator) and isinstance(op.datum, torch.Tensor) and op.datum.is_cuda:
            return op.datum.device
    return torch.device("cpu")


def device_is_cuda(device) -> bool:
    """Whether ``device`` is a CUDA device."""
    return torch.device(device).type == "cuda"


def fused_fv_choice() -> str:
    """The ``fused_fv`` gate (``planner/registry.py``), resolved as the
    reference's rule resolves it: ``KEYSTONE_FUSED_FV=0`` is ``chain``
    and any other set value ``kernel``; unset, an installed plan's choice
    (or the cost model's forced candidate); neither, ``kernel``, the
    static default."""
    env = os.environ.get("KEYSTONE_FUSED_FV")
    if env is not None:
        return "chain" if env == "0" else "kernel"
    from keystone_tpu_torch.planner.registry import planned_gate

    return planned_gate("fused_fv") or "kernel"


class FvFusionRule(Rule):
    """Rewrite each single-consumer ``PCATransformer → FisherVector`` pair
    into one ``FusedPcaFisherVector`` node, the fused Fisher-vector kernel
    (``csrc/fisher.cu::fv_fused_kernel``): the counterpart of the
    reference's ``PallasFvFusionRule`` (keystone_tpu/workflow/optimizer.py).

    Descriptors are read once instead of round-tripping between the
    stages.  When the ``SIFTExtractor`` feeds that PCA alone, its
    L2 → clamp → re-L2 normalize moves into the kernel too (the extractor
    is swapped for a copy emitting raw descriptors); a SIFT output other
    nodes also read (the fit's samplers) stays normalized.

    Fires where the graph's data lives on a CUDA device (in place of the
    reference's ``pallas_supported()``): a CPU graph keeps the plain
    chain.  The ``fused_fv`` gate comes first (:func:`fused_fv_choice`):
    ``chain``, from ``KEYSTONE_FUSED_FV=0`` or an installed plan that
    sampled the chain as cheaper, leaves the graph as it is.  A graph frozen for serving has no data yet: there the
    applier's device decides (``Optimizer.execute(graph, device=...)``),
    as the reference's backend does at freeze.  A FisherVector with
    ``use_kernel=False`` is left as it is, as the reference honours
    ``use_pallas=False``."""

    name = "FvFusion"

    def apply(self, graph: G.Graph, device=None) -> G.Graph:
        if fused_fv_choice() == "chain" or not device_is_cuda(data_device(graph, device)):
            return graph
        from keystone_tpu_torch.models.pca import PCATransformer
        from keystone_tpu_torch.ops.fisher import FisherVector, FusedPcaFisherVector
        from keystone_tpu_torch.ops.sift import SIFTExtractor

        def transformer_of(node, cls):
            op = graph.operators.get(node)
            if isinstance(op, G.TransformerOperator) and isinstance(op.transformer, cls) and _plain(op):
                return op.transformer
            return None

        changed = True
        while changed:
            changed = False
            for n in graph.topological_nodes():
                pca = transformer_of(n, PCATransformer)
                deps_on_n = graph.dependents(n)
                if pca is None or len(deps_on_n) != 1 or isinstance(deps_on_n[0], G.SinkId):
                    continue
                m = deps_on_n[0]
                fv = transformer_of(m, FisherVector)
                if fv is None or graph.dependencies[m] != (n,) or fv.use_kernel is False:
                    continue
                feed = graph.dependencies[n]
                sift = transformer_of(feed[0], SIFTExtractor) if len(feed) == 1 else None
                sift_normalize = sift is not None and sift.normalize and tuple(graph.dependents(feed[0])) == (n,)
                if sift_normalize:
                    raw = copy.copy(sift)
                    raw.normalize = False
                    graph = graph.set_operator(feed[0], G.TransformerOperator(raw))
                fused = FusedPcaFisherVector(pca, fv.gmm, sift_normalize=sift_normalize, use_kernel=fv.use_kernel)
                graph = graph.set_operator(m, _carry_no_memoize(graph.operators[m], fused))
                graph = graph.set_dependencies(m, feed)
                graph = graph.remove_node(n)
                changed = True
                break
        return graph


# ------------------------------------------------------------------ default
def default_optimizer(sample_size: int = NodeChoiceRule.sample_size,
                      materialize_sample_size: int = ProfiledMaterializeRule.sample_size) -> Optimizer:
    """``sample_size``: the rows node choice samples;
    ``materialize_sample_size``: the profiled materialization pass's
    (smaller by default: it executes the whole prefix of each node)."""
    return Optimizer(
        [
            RuleBatch("cse", FixedPoint(5), [EquivalentNodeMergeRule()]),
            RuleBatch("node-choice", Once(), [NodeChoiceRule(sample_size)]),
            RuleBatch("materialize", Once(), [ProfiledMaterializeRule(materialize_sample_size)]),
            # FV fusion first: it targets the (non-fusable) PCA → FV pair
            # specifically, before the generic chain fuser sweeps the rest
            RuleBatch("fusion", Once(), [FvFusionRule(), StageFusionRule()]),
        ]
    )
