"""Pipeline-level checkpoint and resume: saved materialized prefixes
(counterpart of ``keystone_tpu/workflow/state.py`` § SavedStateLoadRule,
save_dataset, load_dataset, save_pipeline_state, ExtractSaveablePrefixes).

Reference: workflow/SavedStateLoadRule.scala + ExtractSaveablePrefixes --
materialized node outputs are saved under a state directory and reloaded
by an optimizer rule on later runs, so a re-run skips the featurization
prefix it already computed.

Keys are the node's structural prefix signature, hashed.  A signature
that embeds a Python ``id()`` (an unnamed dataset, a fitted transformer's
tensors) is not stable across processes, so cross-run reuse needs *named*
datasets (``Dataset(..., name="train-images")``, as the loaders name
theirs); unnamed roots never match and recompute, which is safe.

The reference stores a prefix as an ``.npz`` or, at multi-host scale,
with orbax over its mesh.  Here every prefix is an ``.npz`` written
through ``utils/durable.save_npz`` (atomic, BLAKE2b-checksummed), from
one device, and reloads onto the device of the data it was computed
from.  A streamed prefix (a ``StreamDataset``) is never saved: saving it
would materialize what streaming exists to keep out of memory.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch.utils import durable
from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.optimizer import Rule

logger = logging.getLogger(__name__)


def _contains_object_id(sig) -> bool:
    """True if any leaf looks like a CPython id() (a memory address):
    unstable across processes, so unusable as a persistent key.  Real
    parameters (dims, seeds, floats) are far below the 2^40 range."""
    if isinstance(sig, (tuple, list)):
        return any(_contains_object_id(s) for s in sig)
    return isinstance(sig, int) and sig >= (1 << 40)


def _signature_key(sig) -> Optional[str]:
    """Stable hash of a prefix signature; None when it holds id()s."""
    if sig is None or _contains_object_id(sig):
        return None
    try:
        text = repr(sig)
    except Exception:
        return None
    if "unique" in text:
        return None
    return hashlib.sha256(text.encode()).hexdigest()[:24]


def _data_device(graph: G.Graph, node) -> torch.device:
    """The device of the first dataset the prefix at ``node`` reads, where
    a reloaded prefix goes (the CPU when it reads none)."""
    for a in [node, *graph.ancestors(node)]:
        op = graph.operators.get(a)
        if isinstance(op, G.DatasetOperator) and isinstance(op.dataset, Dataset) and not op.dataset.is_host:
            return op.dataset.device
    return torch.device("cpu")


class SavedStateLoadRule(Rule):
    """Replace the subgraphs whose prefix signature has a saved
    materialization with a dataset literal loaded from the state dir."""

    name = "SavedStateLoad"

    def __init__(self, state_dir: str):
        self.state_dir = state_dir
        #: prefixes this rule reloaded, by key (read by tests and reports)
        self.reloaded: list = []

    def apply(self, graph: G.Graph, device=None) -> G.Graph:
        if not os.path.isdir(self.state_dir):
            return graph
        # deepest first: replacing a shallow prefix would rewrite deeper
        # prefixes' signatures and orphan their saved results
        for n in reversed(list(graph.topological_nodes())):
            if n not in graph.operators:
                continue  # removed by an earlier replacement
            op = graph.operators[n]
            if not isinstance(op, (G.TransformerOperator, G.GatherOperator)):
                continue
            key = _signature_key(graph.prefix_signature(n, {}))
            if key is None:
                continue
            path = os.path.join(self.state_dir, key + ".npz")
            if not os.path.exists(path):
                continue
            try:
                loaded = load_dataset(path, _data_device(graph, n))
            except Exception as e:
                logger.warning("state reload failed for %s: %s", key, e)
                continue
            logger.info("reloaded saved prefix %s for %s", key, op.label())
            self.reloaded.append(key)
            graph, new_node = graph.add_node(G.DatasetOperator(loaded), ())
            graph = graph.replace_dependency(n, new_node)
            graph = graph.remove_node(n)  # drop the orphaned prefix
        return _prune_orphans(graph)


def save_dataset(ds: Dataset, path: str) -> None:
    """A dataset's rows (and mask) as a checksummed ``.npz``: atomic, so a
    crash mid-save never leaves a half-written prefix behind."""
    payload = {"array": ds.array.detach().cpu().numpy(), "n": np.asarray(ds.n)}
    if ds.mask is not None:
        payload["mask"] = ds.mask.detach().cpu().numpy()
    durable.save_npz(path, payload, keep=1)


def load_dataset(path: str, device="cpu") -> Dataset:
    loaded = durable.load_npz(path)
    if loaded is None:
        raise durable.CorruptStateError(f"no valid saved dataset at {path}")
    z, _ = loaded
    return Dataset(torch.from_numpy(z["array"]), n=int(z["n"]),
                   mask=torch.from_numpy(z["mask"]) if "mask" in z else None, device=device)


def save_pipeline_state(pipeline_dataset, state_dir: str) -> int:
    """Materialize and save every saveable node output of a lazy result
    (stable signature, a device dataset that is not a stream): the
    reference's ExtractSaveablePrefixes.  Returns the prefixes saved."""
    from keystone_tpu_torch.parallel import require_one_rank
    from keystone_tpu_torch.workflow.executor import DatasetExpr, GraphExecutor

    require_one_rank("save_pipeline_state (the sharded saved state)")

    os.makedirs(state_dir, exist_ok=True)
    g = pipeline_dataset.graph
    ex = GraphExecutor(g)
    memo: dict = {}
    saved = 0
    for n in g.topological_nodes():
        op = g.operators[n]
        if not isinstance(op, (G.TransformerOperator, G.GatherOperator)):
            continue
        key = _signature_key(g.prefix_signature(n, memo))
        if key is None:
            continue
        expr = ex.execute(n)
        if isinstance(expr, DatasetExpr) and not expr.dataset.is_host and not isinstance(expr.dataset,
                                                                                           StreamDataset):
            save_dataset(expr.dataset, os.path.join(state_dir, key + ".npz"))
            saved += 1
    return saved


def _prune_orphans(graph: G.Graph) -> G.Graph:
    """Remove the nodes no sink reaches (after prefix replacement)."""
    keep = set()
    for k in graph.sink_dependencies.values():
        keep.add(k)
        keep.update(graph.ancestors(k))
    for n in list(graph.operators):
        if n not in keep:
            graph = graph.remove_node(n)
    return graph


#: the reference's name: workflow/ExtractSaveablePrefixes.scala, the pass
#: that walks a pipeline result and persists every stable-signature prefix
ExtractSaveablePrefixes = save_pipeline_state
