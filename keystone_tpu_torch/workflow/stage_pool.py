"""Process-wide shared stage pool: a cross-pipeline stage-result cache
(counterpart of ``keystone_tpu/workflow/stage_pool.py``).

A multi-tenant serving fleet runs many pipelines over one featurization
prefix (one SIFT/LCS → PCA → FV front end feeding N heads); each
pipeline's own CSE would recompute that prefix once a tenant a flush.
The per-walk memo of :class:`~keystone_tpu_torch.workflow.executor.GraphExecutor`
stays, but the results of the stages the cross-pipeline pass
(``workflow/cross.py``) marks are read through and published into ONE
pool, so co-served tenants compute each shared prefix once a combined
flush.

An entry's key is ``(normalized prefix signature, flush token)``:

- the **prefix signature** says *what* is computed: the stage and its
  whole input subgraph, sources normalized, every fitted tensor named
  by its content (``workflow/cross.py``), so two tenants loaded from two
  files share a prefix whose weights are equal;
- the **flush token** says *which data* it ran over: the multi-tenant
  applier mints one a combined flush, so an entry never leaks into
  another request batch.

Lifecycle: :meth:`SharedStagePool.begin_flush` declares how many of the
flush's tenants read each signature; each hit decrements the entry's
remaining readers and frees it at zero, and
:meth:`SharedStagePool.end_flush` drops what is left, so after a flush
the pool holds none of its bytes.  Entries are device tensors, counted
as ``numel × element_size``, and live on the stream of the replica whose
flush made them (a flush runs on one replica's stream, and its token
keeps them off every other).  A put past the byte budget evicts:
entries of signatures no registered tenant holds first, then unpinned
least-recently-used, then pinned; an evicted entry is a miss, and the
reader recomputes it.  An entry larger than the whole budget is never
resident.

One lock guards the entry map; the stages themselves run outside it.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from typing import Dict, Optional, Tuple

from keystone_tpu_torch.obs import metrics

#: live pools by token: a replica clone (a deep copy of the applier, in
#: this process) finds its service's pool again by the token, as the pool
#: itself holds a lock and is not copied.  Weak values: a retired pool
#: dies with its service
_POOL_REGISTRY: "weakref.WeakValueDictionary[int, SharedStagePool]" = weakref.WeakValueDictionary()
_POOL_TOKENS = itertools.count(1)

#: the pool key: (normalized prefix signature, flush token)
PoolKey = Tuple[tuple, object]


def pool_by_token(token) -> Optional["SharedStagePool"]:
    """The live pool registered under ``token`` (None: unknown or dead; the
    caller falls back to :func:`default_pool`)."""
    if token is None:
        return None
    return _POOL_REGISTRY.get(token)


def expr_nbytes(expr) -> int:
    """Bytes of one pooled stage result (the eviction unit): its tensor's
    ``numel × element_size`` for a dataset on a device, 0 for a host or
    stream result."""
    ds = getattr(expr, "dataset", None)
    if ds is None:
        return 0
    try:
        if ds.is_host:
            return 0
        arr = ds.array
        return int(arr.numel()) * int(arr.element_size())
    except Exception:
        return 0


class _Entry:
    __slots__ = ("value", "nbytes", "remaining", "last_use", "sig")

    def __init__(self, value, nbytes: int, remaining: int, sig):
        self.value = value
        self.nbytes = int(nbytes)
        self.remaining = int(remaining)
        self.last_use = time.monotonic()
        self.sig = sig


class SharedStagePool:
    """Bounded, refcounted stage-result cache shared by co-served tenants.

    ``budget_bytes``: one device-memory budget for every resident entry
    (default :func:`~keystone_tpu_torch.workflow.profiling.pool_budget_bytes`,
    a quarter of the card's memory).  ``name`` labels the pool."""

    def __init__(self, budget_bytes: Optional[int] = None, name: str = "serve"):
        if budget_bytes is None:
            from keystone_tpu_torch.workflow.profiling import pool_budget_bytes

            budget_bytes = pool_budget_bytes()
        self.budget_bytes = int(budget_bytes)
        self.name = name
        self.token = next(_POOL_TOKENS)
        _POOL_REGISTRY[self.token] = self
        self._lock = threading.Lock()
        self._entries: Dict[PoolKey, _Entry] = {}
        self._bytes = 0
        #: the most bytes resident at once since construction
        self.peak_bytes = 0
        #: signatures pinned by the placement decision: evicted last
        self._pinned: set = set()
        #: token -> {sig: consumer count} declared by begin_flush
        self._flushes: Dict[object, Dict[tuple, int]] = {}
        #: observed output bytes a signature (auto_pin reads them)
        self.sig_bytes: Dict[tuple, int] = {}
        #: signature -> the registered tenants whose graph holds it
        self._sig_tenants: Dict[tuple, set] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ------------------------------------------------------- registration
    def register_tenant(self, tenant: str, sigs) -> None:
        """Declare a live tenant's shared signatures.  An entry whose
        signature no registered tenant holds is evicted first."""
        with self._lock:
            for s in sigs:
                self._sig_tenants.setdefault(s, set()).add(tenant)

    def unregister_tenant(self, tenant: str) -> None:
        with self._lock:
            for s, owners in list(self._sig_tenants.items()):
                owners.discard(tenant)
                if not owners:
                    del self._sig_tenants[s]

    def sig_refcount(self, sig) -> int:
        """How many registered tenants hold ``sig``."""
        with self._lock:
            return len(self._sig_tenants.get(sig, ()))

    # ------------------------------------------------------------ pinning
    def pin(self, sig) -> None:
        """Pin ``sig`` by hand: its entries are evicted last."""
        with self._lock:
            self._pinned.add(sig)

    def auto_pin(self, budget_fraction: float = 0.5) -> int:
        """Pin signatures greedily under a fraction of the budget, ranked
        by compute saved a byte pinned, (tenants − 1) / observed bytes:
        the cache rule's discipline at pool granularity.  Needs observed
        bytes (a primed or live flush).  Returns how many were pinned."""
        with self._lock:
            budget = self.budget_bytes * max(0.0, min(1.0, budget_fraction))
            ranked = sorted(
                ((s, b) for s, b in self.sig_bytes.items() if len(self._sig_tenants.get(s, ())) >= 2),
                key=lambda sb: -((len(self._sig_tenants.get(sb[0], ())) - 1) / max(sb[1], 1)),
            )
            self._pinned.clear()
            spent = 0
            for s, b in ranked:
                if spent + b > budget:
                    continue
                spent += b
                self._pinned.add(s)
            return len(self._pinned)

    # ------------------------------------------------------ flush lifecycle
    def begin_flush(self, token, sig_consumers: Dict[tuple, int]) -> None:
        """Declare one combined flush: ``sig_consumers`` maps each shared
        signature to how many of the flush's tenants read it."""
        with self._lock:
            self._flushes[token] = dict(sig_consumers)

    def end_flush(self, token) -> None:
        """Drop the flush's declaration and its leftover entries (a reader
        that pruned its walk earlier never read them)."""
        with self._lock:
            self._flushes.pop(token, None)
            for key in [k for k in self._entries if k[1] == token]:
                self._drop(key)
            metrics.set_gauge("serve.pool_bytes", float(self._bytes))

    # ----------------------------------------------------------- get / put
    def get(self, key: PoolKey):
        """``(hit, value)``; a hit decrements the entry's remaining readers
        and frees it at zero."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                metrics.inc("serve.pool_misses")
                metrics.set_gauge("serve.pool_hit_rate", self._hit_rate())
                return False, None
            self.hits += 1
            e.last_use = time.monotonic()
            e.remaining -= 1
            value = e.value
            if e.remaining <= 0:
                self._drop(key)
            metrics.inc("serve.pool_hits")
            metrics.set_gauge("serve.pool_bytes", float(self._bytes))
            metrics.set_gauge("serve.pool_hit_rate", self._hit_rate())
            return True, value

    def _hit_rate(self) -> float:
        """Lifetime hit fraction (holds the lock): the
        ``serve.pool_hit_rate`` gauge the autoscaler reads."""
        n = self.hits + self.misses
        return (self.hits / n) if n else 0.0

    def hit_rate(self) -> float:
        with self._lock:
            return self._hit_rate()

    def put(self, key: PoolKey, value, nbytes: Optional[int] = None) -> bool:
        """Publish one computed stage result.  False (nothing stored) when
        the flush declared no further reader of the signature, or when the
        entry alone exceeds the whole budget."""
        sig, token = key
        if nbytes is None:
            nbytes = expr_nbytes(value)
        with self._lock:
            self.sig_bytes[sig] = int(nbytes)
            consumers = self._flushes.get(token, {}).get(sig, 1)
            remaining = consumers - 1  # the producer is a reader too
            if remaining <= 0:
                return False
            if nbytes > self.budget_bytes:
                self.evictions += 1
                metrics.inc("serve.pool_evictions")
                return False
            self._evict_until(self.budget_bytes - int(nbytes))
            self._entries[key] = _Entry(value, nbytes, remaining, sig)
            self._bytes += int(nbytes)
            self.peak_bytes = max(self.peak_bytes, self._bytes)
            metrics.set_gauge("serve.pool_bytes", float(self._bytes))
            return True

    # ----------------------------------------------------------- internals
    def _drop(self, key: PoolKey) -> None:
        e = self._entries.pop(key, None)
        if e is not None:
            self._bytes -= e.nbytes

    def _evict_until(self, budget: int) -> None:
        """Holds the lock.  Evict until the resident bytes fit ``budget``:
        entries no registered tenant holds first, then unpinned LRU, then
        pinned LRU (a priority, not an exemption)."""
        if self._bytes <= budget:
            return
        order = sorted(
            self._entries.items(),
            key=lambda kv: (len(self._sig_tenants.get(kv[1].sig, ())) > 0, kv[1].sig in self._pinned,
                            kv[1].last_use),
        )
        for key, _e in order:
            if self._bytes <= budget:
                return
            self._drop(key)
            self.evictions += 1
            metrics.inc("serve.pool_evictions")

    # -------------------------------------------------------------- status
    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "resident_bytes": self._bytes,
                "peak_bytes": self.peak_bytes,
                "budget_bytes": self.budget_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self._hit_rate(), 4),
                "evictions": self.evictions,
                "pinned_sigs": len(self._pinned),
                "registered_sigs": len(self._sig_tenants),
            }


#: the process-wide default pool; services may construct private ones
_DEFAULT: Optional[SharedStagePool] = None
_DEFAULT_LOCK = threading.Lock()


def default_pool() -> SharedStagePool:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = SharedStagePool()
        return _DEFAULT
