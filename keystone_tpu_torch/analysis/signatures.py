"""Pass (d): the CSE and cache-signature audit, and the sharing plan's
collision gate (counterpart of ``keystone_tpu/analysis/signatures.py``).

``signature()`` is load-bearing identity: the CSE rule merges
equal-prefix nodes, the executor's breaker registry keys on it, and the
cross-pipeline sharing plan (``workflow/cross.py``) lets one tenant's
pooled stage result answer for another tenant's stage with an equal
signature.  A transformer whose ``params()`` under-specifies it (two
observably different instances, equal signatures) therefore does not
just miss an optimization: CSE silently replaces one node with the
other.

Findings of :func:`run`:

- ``signature-collision`` (error): two distinct transformer or estimator
  instances in the graph report equal signatures but differ in
  observable state;
- ``unstable-signature`` (error): ``signature()`` raises, is unhashable,
  or returns different values on consecutive calls;
- ``dataset-name-collision`` (error): two distinct bound datasets share a
  ``name`` (the CSE and saved-state identity) but disagree on payload
  length or kind.

:func:`collision_signatures` is the sharing plan's admission gate: the
planner refuses every signature it finds colliding.

A port transformer is an ``nn.Module``: its fitted tensors are its
registered buffers and parameters and its stages its submodules, none of
them in ``vars()`` directly.  :func:`_state_conflict` compares the
registered tensors by shape and dtype, and by value up to
:data:`_VALUE_COMPARE_MAX` elements; submodules recursively; the plain
attributes as the reference does.  Tensors are compared with
``torch.equal``, never ``==`` (whose result is a tensor).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from keystone_tpu_torch.analysis.findings import PASS_SIGNATURES, Finding
from keystone_tpu_torch.workflow import graph as G

#: instance attributes that are caches or plumbing, never identity
_SKIP_ATTRS = {"_fp", "_breaker_token", "fallback", "optional", "_keystone_fp", "training"}

#: a module's registries, compared entry by entry below
_REGISTRIES = ("_parameters", "_buffers", "_modules")

_SIMPLE = (int, float, str, bool, bytes, type(None))

#: tensors up to this many elements compare by value (one bounded read
#: back from the device); larger ones by shape and dtype only
_VALUE_COMPARE_MAX = 4096


class _Missing:
    pass


_MISSING = _Missing()


def _tensor_conflict(x, y) -> bool:
    if not isinstance(y, torch.Tensor):
        return True
    if tuple(x.shape) != tuple(y.shape) or x.dtype != y.dtype:
        return True
    if x.numel() <= _VALUE_COMPARE_MAX:
        return not torch.equal(x.detach().cpu(), y.detach().cpu())
    return False


def _value_conflict(x, y) -> bool:
    """Does one attribute value differ observably from another?"""
    if isinstance(x, _SIMPLE) or isinstance(y, _SIMPLE):
        return type(x) is not type(y) or x != y
    if isinstance(x, torch.Tensor):
        return _tensor_conflict(x, y)
    if isinstance(x, tuple) and isinstance(y, tuple):
        return len(x) != len(y) or any(_value_conflict(a, b) for a, b in zip(x, y))
    if hasattr(x, "shape") and hasattr(x, "dtype"):  # a numpy array
        import numpy as np

        if not (hasattr(y, "shape") and hasattr(y, "dtype")):
            return True
        if tuple(x.shape) != tuple(y.shape) or str(x.dtype) != str(y.dtype):
            return True
        try:
            return int(np.prod(x.shape)) <= _VALUE_COMPARE_MAX and not np.array_equal(
                np.asarray(x, np.float64), np.asarray(y, np.float64))
        except (TypeError, ValueError):
            return False
    if isinstance(x, nn.Module):
        return not isinstance(y, nn.Module) or bool(_state_conflict(x, y))
    # opaque objects: a type change is observable, the content is not
    return type(x) is not type(y)


def _state_conflict(a, b) -> str:
    """Name of the first observable state difference between two
    equal-signature instances, or '' when none is detectable."""
    if type(a) is not type(b):
        return "__class__"

    def attrs(o) -> dict:
        out = {k: v for k, v in vars(o).items()
               if k not in _SKIP_ATTRS and k not in _REGISTRIES and not (k.startswith("_") and k.endswith("hooks"))}
        if isinstance(o, nn.Module):
            for reg in _REGISTRIES:
                for k, v in getattr(o, reg).items():
                    out[f"{reg[1:]}.{k}"] = v
        return out

    va, vb = attrs(a), attrs(b)
    for k in sorted(set(va) | set(vb)):
        if k.startswith("__"):
            continue
        x, y = va.get(k, _MISSING), vb.get(k, _MISSING)
        if x is _MISSING or y is _MISSING:
            return k
        if x is y:
            continue
        if x is None or y is None:
            if x is not y:
                return k
            continue
        if _value_conflict(x, y):
            return k
    return ""


def _stable_signature(obj, n, label, findings: List[Finding]):
    """signature() if stable+hashable, else None (with a finding)."""
    try:
        s1 = obj.signature()
        s2 = obj.signature()
        if s1 is not None:
            hash(s1)
    except Exception as e:
        findings.append(
            Finding(
                "error",
                PASS_SIGNATURES,
                "unstable-signature",
                f"{label}.signature() raised or is unhashable "
                f"({type(e).__name__}: {e}); every CSE/cache/breaker "
                "consumer assumes stable hashable identity",
                node=n.id,
                label=label,
            )
        )
        return None
    if s1 != s2:
        findings.append(
            Finding(
                "error",
                PASS_SIGNATURES,
                "unstable-signature",
                f"{label}.signature() returns different values on "
                "consecutive calls; identity must be deterministic",
                node=n.id,
                label=label,
            )
        )
        return None
    return s1


def collision_signatures(graph: G.Graph, signature) -> set:
    """The transformer and estimator signatures that COLLIDE in ``graph``:
    two or more distinct instances report the signature while their
    observable state differs.  ``signature(obj)`` names an instance (the
    sharing plan passes its content signature, where the reference calls
    ``obj.signature()``).  A signature that raises or is unhashable is
    skipped (the planner's own guarded call yields None for it, so it is
    never pooled); one that is unstable (two calls disagree) collides."""
    colliding: set = set()
    by_sig: dict = {}
    for n in graph.topological_nodes():
        op = graph.operators[n]
        if isinstance(op, G.TransformerOperator):
            obj = op.transformer
        elif isinstance(op, G.EstimatorOperator):
            obj = op.estimator
        else:
            continue
        try:
            s1, s2 = signature(obj), signature(obj)
            if s1 is not None:
                hash(s1)
        except Exception:
            continue
        if s1 is None:
            continue
        if s1 != s2:
            colliding.add(s1)
            try:
                colliding.add(s2)
            except TypeError:
                pass
            continue
        by_sig.setdefault(s1, []).append(obj)
    for sig, group in by_sig.items():
        first = group[0]
        for other in group[1:]:
            if other is not first and _state_conflict(first, other):
                colliding.add(sig)
                break
    return colliding


def run(graph: G.Graph) -> List[Finding]:
    findings: List[Finding] = []
    by_sig: dict = {}
    datasets_by_name: dict = {}
    for n in graph.topological_nodes():
        op = graph.operators[n]
        if isinstance(op, G.TransformerOperator):
            obj = op.transformer
        elif isinstance(op, G.EstimatorOperator):
            obj = op.estimator
        elif isinstance(op, G.DatasetOperator):
            ds = op.dataset
            name = getattr(ds, "name", None)
            if name is not None:
                prev = datasets_by_name.get(name)
                if prev is not None and prev[1] is not ds:
                    pn, pds = prev
                    if (
                        getattr(pds, "n", None) != getattr(ds, "n", None)
                        or getattr(pds, "is_host", None)
                        != getattr(ds, "is_host", None)
                    ):
                        findings.append(
                            Finding(
                                "error",
                                PASS_SIGNATURES,
                                "dataset-name-collision",
                                f"datasets at n{pn.id} and n{n.id} share "
                                f"name {name!r} but differ in payload "
                                "(names are cross-process CSE/saved-state "
                                "identity)",
                                node=n.id,
                                label=op.label(),
                            )
                        )
                else:
                    datasets_by_name[name] = (n, ds)
            continue
        else:
            continue
        sig = _stable_signature(obj, n, op.label(), findings)
        if sig is None:
            continue
        by_sig.setdefault(sig, []).append((n, obj, op.label()))

    for sig, group in by_sig.items():
        if len(group) < 2:
            continue
        n0, obj0, label0 = group[0]
        for n1, obj1, label1 in group[1:]:
            if obj1 is obj0:
                continue  # literally the same instance: the intended case
            attr = _state_conflict(obj0, obj1)
            if attr:
                findings.append(
                    Finding(
                        "error",
                        PASS_SIGNATURES,
                        "signature-collision",
                        f"{label0} at n{n0.id} and n{n1.id} report equal "
                        f"signatures but differ in attribute {attr!r}: "
                        "CSE would merge them and shared program/breaker "
                        "caches would leak between them — include the "
                        "attribute in params()",
                        node=n1.id,
                        label=label1,
                    )
                )
    return findings
