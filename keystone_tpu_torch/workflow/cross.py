"""Cross-pipeline CSE: plan stage sharing between co-served pipelines
(counterpart of ``keystone_tpu/workflow/cross.py``).

The optimizer's ``EquivalentNodeMergeRule`` merges equal prefixes within
one graph; this pass is its twin across the frozen graphs of N co-served
tenants.  It

1. computes a **normalized prefix signature** a node: the stage and its
   whole input subgraph with every open source mapped to one
   placeholder, so "SIFT over the request batch" is one value in every
   tenant's graph;
2. finds the signatures present in two or more tenants' graphs;
3. runs the signature-collision gate (``analysis/signatures.py``) over
   the disjoint union of the graphs: a stage whose signature collides
   there (equal signature, observably different state) is refused
   sharing, counted as ``serve.pool_refusals``, and runs per tenant;
4. keeps the sharing **frontier** only: a shared node is marked when in
   some graph a consumer of it is not shared.  The executor reads the
   pool before it walks a node's inputs, so a frontier hit prunes the
   prefix.

The materialization barriers the optimizer places (``Cacher``) are keyed
by their input's signature, so a prefix shares through them.

**Content, not object ids.**  In one graph the port's transformers name
their fitted tensors by object id (``workflow/transformer.py::
tensor_identity``: while two nodes of a graph live, their tensors' ids
name their values, and in-graph CSE keeps that).  Across tenants loaded
from separate files equal weights are distinct tensors, so the plan's
signatures put each tensor's content fingerprint
(``utils/hashing.py::array_fingerprint``) where ``params()`` names its
id: :class:`ContentKeys`.  Each tensor is read back once, when the plan
is made, never once a flush; the plan then holds only
``{node: signature}`` per tenant, which a replica clone reuses as it is.
A tensor ``params()`` does not name is not identity here, as in the
reference: the collision gate compares it.
"""

from __future__ import annotations

import dataclasses
from functools import reduce
from typing import Dict, Optional

from keystone_tpu_torch.workflow import graph as G

#: every open source normalizes to this placeholder: co-served serve
#: graphs all hang off "the request batch"
_SOURCE = ("source", 0)


class ContentKeys:
    """Content signatures of fitted transformers: ``obj.signature()`` with
    every integer that is the id of one of ``obj``'s fitted tensors
    (``utils/hashing.py::fitted_tensors``) replaced by
    ``("tensor", fingerprint)``.  Each tensor is fingerprinted once for
    the life of this object (the tensor is held, so its id is not
    reused meanwhile)."""

    def __init__(self):
        self._fps: Dict[int, tuple] = {}
        self._sigs: Dict[int, tuple] = {}

    def _fingerprint(self, t) -> str:
        hit = self._fps.get(id(t))
        if hit is None:
            from keystone_tpu_torch.utils.hashing import array_fingerprint

            hit = self._fps[id(t)] = (t, array_fingerprint(t))
        return hit[1]

    def signature(self, obj) -> Optional[tuple]:
        hit = self._sigs.get(id(obj))
        if hit is not None and hit[0] is obj:
            return hit[1]
        sig = obj.signature()
        if sig is not None:
            from keystone_tpu_torch.utils.hashing import fitted_tensors

            tensors: dict = {}
            fitted_tensors(obj, lambda t: tensors.setdefault(id(t), t))
            sig = self._swap(sig, tensors)
        self._sigs[id(obj)] = (obj, sig)
        return sig

    def _swap(self, p, tensors: dict):
        if isinstance(p, tuple):
            return tuple(self._swap(x, tensors) for x in p)
        if isinstance(p, int) and not isinstance(p, bool) and p in tensors:
            return ("tensor", self._fingerprint(tensors[p]))
        return p

    def operator_signature(self, op) -> Optional[tuple]:
        """``op.signature()`` with a transformer's content signature.  A
        ``Cacher`` (an identity behind a materialization barrier, which
        declares no signature only so that in-graph CSE keeps each one) is
        named by what it is: the value of its input."""
        from keystone_tpu_torch.workflow.transformer import Cacher

        if isinstance(op, G.TransformerOperator):
            if isinstance(op.transformer, Cacher):
                return ("cache",)
            sig = self.signature(op.transformer)
            return None if sig is None else ("transform", sig)
        return op.signature()


def normalized_prefix_signature(g: G.Graph, target, memo: Optional[dict] = None,
                                keys: Optional[ContentKeys] = None) -> Optional[tuple]:
    """The prefix signature of ``target`` with sources normalized and
    tensors named by content; None when the node, or anything in its
    prefix, declares no stable signature (it can never key a pool
    entry)."""
    if memo is None:
        memo = {}
    if keys is None:
        keys = ContentKeys()
    if target in memo:
        return memo[target]
    if isinstance(target, G.SourceId):
        memo[target] = _SOURCE
        return _SOURCE
    op = g.operators[target]
    try:
        sig = keys.operator_signature(op)
    except Exception:
        sig = None  # a raising identity can never key a shared entry
    # a node over the device budget (no_memoize) is not pooled either
    if sig is None or getattr(op, "no_memoize", False):
        memo[target] = None
        return None
    deps = tuple(normalized_prefix_signature(g, d, memo, keys) for d in g.dependencies[target])
    out = None if any(d is None for d in deps) else ("node", sig, deps)
    memo[target] = out
    return out


@dataclasses.dataclass
class SharingPlan:
    """The pass's output: plain data, carried by every replica clone of
    the multi-tenant applier."""

    #: tenant -> {NodeId: normalized prefix signature} of the pooled nodes
    node_sigs: Dict[str, Dict[G.NodeId, tuple]]
    #: every pooled signature
    shared: frozenset
    #: signature -> how many tenant graphs hold it
    consumers: Dict[tuple, int]
    #: how many shared candidates the collision gate refused
    refused: int

    def sigs_for(self, tenants) -> Dict[tuple, int]:
        """Per-signature reader counts restricted to one flush's tenants:
        the ``begin_flush`` declaration."""
        out: Dict[tuple, int] = {}
        for t in set(tenants):
            for sig in set(self.node_sigs.get(t, {}).values()):
                out[sig] = out.get(sig, 0) + 1
        return {s: n for s, n in out.items() if n >= 2}

    def shared_stage_count(self) -> int:
        return len(self.shared)


def plan_sharing(graphs: Dict[str, G.Graph]) -> SharingPlan:
    """Plan cross-pipeline stage sharing over co-served tenant graphs.  One
    tenant, or no overlap, gives the empty plan: the executor's walk is
    then exactly the walk without a pool."""
    from keystone_tpu_torch.analysis.signatures import collision_signatures
    from keystone_tpu_torch.obs import metrics

    if len(graphs) < 2:
        # nothing to share with: no tensor is read back
        return SharingPlan({t: {} for t in graphs}, frozenset(), {}, 0)
    keys = ContentKeys()
    per_node: Dict[str, Dict[G.NodeId, tuple]] = {}
    sig_tenants: Dict[tuple, set] = {}
    for tenant, g in graphs.items():
        memo: dict = {}
        sigs: Dict[G.NodeId, tuple] = {}
        for n in g.topological_nodes():
            # pooled values are stage outputs a later stage reads:
            # transformer applications and gathers (a frozen graph holds
            # no estimator; datasets and datums are literals)
            if not isinstance(g.operators[n], (G.TransformerOperator, G.GatherOperator)):
                continue
            s = normalized_prefix_signature(g, n, memo, keys)
            if s is None or s == _SOURCE:
                continue
            sigs[n] = s
            sig_tenants.setdefault(s, set()).add(tenant)
        per_node[tenant] = sigs
    shared = {s for s, ts in sig_tenants.items() if len(ts) >= 2}
    if not shared:
        return SharingPlan({t: {} for t in graphs}, frozenset(), {}, 0)

    # ---- the admission gate: the collision pass over the union graph
    union = reduce(lambda a, b: a.union(b)[0], graphs.values(), G.Graph())
    colliding = collision_signatures(union, signature=keys.signature)
    refused = 0
    if colliding:
        admitted = set()
        for s in shared:
            # s = ("node", ("transform", content sig), deps)
            obj_sig = s[1][1] if len(s[1]) == 2 else None
            if obj_sig in colliding or _prefix_tainted(s, colliding):
                refused += 1
            else:
                admitted.add(s)
        shared = admitted
    if refused:
        metrics.inc("serve.pool_refusals", refused)

    # ---- the sharing frontier only
    frontier: set = set()
    for tenant, g in graphs.items():
        sigs = per_node[tenant]
        for n, s in sigs.items():
            if s not in shared:
                continue
            deps_on_n = g.dependents(n)
            if not deps_on_n or any(isinstance(d, G.SinkId) or sigs.get(d) not in shared for d in deps_on_n):
                frontier.add(s)
    node_sigs = {tenant: {n: s for n, s in sigs.items() if s in frontier} for tenant, sigs in per_node.items()}
    consumers = {s: len(sig_tenants[s]) for s in frontier}
    return SharingPlan(node_sigs, frozenset(frontier), consumers, refused)


def _prefix_tainted(psig: tuple, colliding: set) -> bool:
    """Does a stage in the prefix signature carry a colliding signature?  A
    safe frontier over a poisoned interior stage would still share the
    poisoned computation."""
    if not isinstance(psig, tuple) or not psig or psig[0] != "node":
        return False
    op_sig = psig[1]
    if isinstance(op_sig, tuple) and len(op_sig) == 2 and op_sig[1] in colliding:
        return True
    return any(_prefix_tainted(d, colliding) for d in psig[2])
