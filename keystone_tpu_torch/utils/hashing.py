"""Content fingerprints of arrays and fitted pipelines (counterpart of
``keystone_tpu/utils/hashing.py``).

A fitted pipeline's identity must be stable across processes: the frozen
applier's CUDA-graph bundles (``FrozenApplier.export_artifacts``) are
keyed by it, and a bundle published by one process is installed by
another.  Object ids and pickle bytes are not stable; the structure and
the fitted tensors' bytes are.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

#: a leaf at or above this is taken for a CPython ``id()`` (a memory
#: address): the port's transformers name their fitted tensors by id in
#: ``params()`` (``workflow/transformer.py::tensor_identity``), which is
#: unstable across processes; the tensors' bytes are hashed instead
_OBJECT_ID_FLOOR = 1 << 40


def _host_bytes(a) -> np.ndarray:
    """``a`` as a host numpy array: a tensor with one device-to-host copy
    (bf16 as its bit patterns), anything else through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    return np.asarray(a)


def array_fingerprint(*arrays) -> str:
    """A short digest of each array's shape, dtype and bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        dtype = str(a.dtype).replace("torch.", "") if isinstance(a, torch.Tensor) else None
        arr = _host_bytes(a)
        h.update(str(tuple(arr.shape)).encode())
        h.update((dtype or str(arr.dtype)).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


def _stable_repr(p) -> str:
    """A process-stable repr of a ``params()`` value: containers recurse
    per element, and ONLY an element whose default repr carries a
    process-local address (or that is an object id) collapses to its type
    name, so two pipelines differing in a well-behaved sibling never hash
    alike."""
    if isinstance(p, (tuple, list)):
        inner = ",".join(_stable_repr(x) for x in p)
        return f"{type(p).__name__}({inner})"
    if isinstance(p, dict):
        items = sorted((_stable_repr(k), _stable_repr(v)) for k, v in p.items())
        return "dict(" + ",".join(f"{k}:{v}" for k, v in items) + ")"
    if isinstance(p, int) and not isinstance(p, bool) and p >= _OBJECT_ID_FLOOR:
        return "id"
    r = repr(p)
    return type(p).__name__ if " at 0x" in r else r


def fitted_tensors(obj, visit, _seen=None, _depth=0) -> None:
    """Call ``visit`` on every tensor reachable from ``obj`` (attributes,
    a module's parameters and buffers, containers), each once, in a
    deterministic order: what a fitted transformer holds."""
    if _depth > 8 or obj is None or isinstance(obj, (str, bytes, int, float, bool, torch.device, torch.dtype)):
        return
    if _seen is None:
        _seen = set()
    if id(obj) in _seen:
        return
    _seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        visit(obj)
        return
    if isinstance(obj, dict):
        children = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        children = list(obj)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        children = [v for k, v in vars(obj).items() if not (k.startswith("_") and k.endswith("hooks"))]
    else:
        return
    for c in children:
        fitted_tensors(c, visit, _seen, _depth + 1)


def pipeline_fingerprint(pipeline) -> str:
    """Stable content hash of a fitted pipeline: graph structure (the
    topological order of operator and transformer types and their
    ``params()``, object ids left out) plus every fitted tensor's shape,
    dtype and bytes, each read with one device-to-host copy.

    Cached on the pipeline (``_keystone_fp``) and valid while the same
    tensor objects, unmodified (their ``_version``), are reached: a
    replaced or updated weight invalidates it."""
    g = pipeline.graph
    struct = hashlib.sha256()
    tensors: list = []
    for n in g.topological_nodes():
        op = g.operators[n]
        struct.update(type(op).__name__.encode())
        t = getattr(op, "transformer", None)
        if t is None:
            continue
        struct.update(type(t).__name__.encode())
        try:
            p = t.params()
        except Exception:
            p = None
        struct.update(_stable_repr(p).encode())
        fitted_tensors(t, tensors.append)
    struct_hex = struct.hexdigest()[:16]
    versions = tuple(t._version for t in tensors)
    cached = getattr(pipeline, "_keystone_fp", None)
    if (
        cached is not None
        and cached[0] == struct_hex
        and len(cached[1]) == len(tensors)
        and all(a is b for a, b in zip(cached[1], tensors))
        and cached[2] == versions
    ):
        return cached[3]
    fp = struct_hex + array_fingerprint(*tensors)
    try:
        pipeline._keystone_fp = (struct_hex, tuple(tensors), versions, fp)
    except AttributeError:
        pass
    return fp


def cached_fingerprint(obj, attr: str, *arrays) -> str:
    """``array_fingerprint(*arrays)`` computed once per object and cached
    on it under ``attr``; valid only while the same array objects are
    passed, so reassigning a weight invalidates it."""
    cached = getattr(obj, attr, None)
    if cached is not None and len(cached[0]) == len(arrays) and all(a is b for a, b in zip(cached[0], arrays)):
        return cached[1]
    fp = array_fingerprint(*arrays)
    setattr(obj, attr, (tuple(arrays), fp))
    return fp
