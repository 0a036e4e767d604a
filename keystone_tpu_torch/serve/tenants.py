"""Multi-tenant serving: N pipelines, one fleet, shared prefixes once
(counterpart of ``keystone_tpu/serve/tenants.py``).

A deployment serves many heads over one featurization (a SIFT/LCS → PCA
→ FV front end feeding per-customer classifiers).  Served as N
independent :class:`~keystone_tpu_torch.serve.service.PipelineService`
instances, each tenant's flush recomputes the shared prefix; this module
serves them behind ONE batcher and replica fleet and computes each
shared prefix once a combined flush:

- :class:`MultiTenantApplier` — what the
  :class:`~keystone_tpu_torch.serve.fleet.ReplicaPool` replicates: one
  :class:`~keystone_tpu_torch.workflow.pipeline.FrozenApplier` a tenant,
  each frozen for the serving device (the card's freeze puts the fused
  FV kernel in the prefix), plus the cross-pipeline
  :class:`~keystone_tpu_torch.workflow.cross.SharingPlan`.  A flush
  walks each tenant's graph over the same bound batch under one flush
  token through :class:`~keystone_tpu_torch.workflow.executor.GraphExecutor`,
  reading the marked stages through the
  :class:`~keystone_tpu_torch.workflow.stage_pool.SharedStagePool`: the
  first tenant computes the prefix, the others' walks prune at the pool
  hit.  The walk serves: a CUDA graph's replay cannot read the pool, so
  the multi applier installs no bucket graphs.
- :class:`MultiTenantService` — per-tenant queues with quotas and
  default deadlines, deficit-round-robin flushes (each tenant's rows one
  contiguous run of the combined padded batch), per-tenant breakers (a
  tenant whose requests keep failing is refused at its own admission),
  per-tenant counters, latency windows and SLO burn in ``/statusz``,
  opt-in in-flight dedup, and contained failures: a ``serve.batch``
  fault aimed at one tenant (``ctx.tenant=``) fails that tenant's riders
  only, bisected inside its segment when the error is content-shaped.

Each tenant's head runs over the whole padded batch (heads are cheap,
the shared prefix is the cost) and its rows are sliced out at delivery.
With one tenant the plan is empty and the walk is the plain service's,
so the answers are bit for bit those of ``serve()`` over the same
pipeline.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from concurrent.futures import InvalidStateError
from typing import Dict, Optional

import numpy as np
import torch

from keystone_tpu_torch.faults import fault_point
from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.serve.service import Overloaded, PipelineService, _content_key, _Flush, _poison_suspect
from keystone_tpu_torch.utils import guard
from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow.cross import SharingPlan, plan_sharing
from keystone_tpu_torch.workflow.stage_pool import SharedStagePool, default_pool, pool_by_token

logger = logging.getLogger(__name__)

metrics.register_buckets("serve.tenant_latency_seconds", metrics.LATENCY_MS_BUCKETS)
metrics.register_buckets("serve.tenant_failed_wait_seconds", metrics.LATENCY_MS_BUCKETS)

#: flush tokens: never repeated while a pool entry lives, never shared by
#: two services of one process
_TOKENS = itertools.count(1)

#: per-service registration namespaces: two services in one process (a
#: benchmark's A/B arms) may name their tenants alike
_OWNERS = itertools.count(1)


class UnknownTenant(TypeError):
    """The request names a tenant this service does not serve: the
    client's fault (a ``TypeError``, as a shape mismatch is: HTTP 400, no
    SLO burn)."""


class MultiTenantApplier:
    """N frozen appliers and the sharing plan, applied as one unit a
    combined flush.  ``models``: ``{tenant: fitted pipeline or
    FrozenApplier}``; pipelines are frozen for ``device`` (the card unless
    the caller asks for the CPU).  ``pool``: a private
    :class:`SharedStagePool` (default: the process-wide one).
    ``share=False``: no plan, every tenant walks its whole graph.

    A replica clone is one deep copy of the whole applier, so a stage two
    tenants share stays one instance in the clone; the plan is plain data
    and carries over; the pool is not copied (it holds a lock) and the
    clone finds it again by its token."""

    #: duck-typed frozen-applier marker (serve/fleet.py::_as_applier)
    serve_applier = True

    def __init__(self, models: Dict[str, object], pool: Optional[SharedStagePool] = None, share: bool = True,
                 device="cuda"):
        from keystone_tpu_torch.workflow.pipeline import FrozenApplier

        if not models:
            raise ValueError("serve_multi needs at least one tenant model")
        self.appliers = {str(k): p if isinstance(p, FrozenApplier) else FrozenApplier(p, device=device)
                         for k, p in models.items()}
        kinds = {a.device.type for a in self.appliers.values()}
        if len(kinds) > 1:
            raise ValueError(f"tenant appliers frozen for different devices {sorted(kinds)}")
        self.share = bool(share)
        if share:
            self.plan = plan_sharing({t: a.graph for t, a in self.appliers.items()})
        else:
            self.plan = SharingPlan({t: {} for t in self.appliers}, frozenset(), {}, 0)
        self._pool = pool
        self._pool_ref = None if pool is None else pool.token
        if self.plan.shared:
            ledger.event("serve.pool_plan", tenants=len(self.appliers), shared_stages=len(self.plan.shared),
                         refused=self.plan.refused)

    @property
    def device(self) -> torch.device:
        return next(iter(self.appliers.values())).device

    @device.setter
    def device(self, dev) -> None:
        for a in self.appliers.values():
            a.device = dev

    def pool(self) -> SharedStagePool:
        if self._pool is not None:
            return self._pool
        if self._pool_ref is not None:
            resolved = pool_by_token(self._pool_ref)
            if resolved is not None:
                self._pool = resolved
                return resolved
        return default_pool()

    def graphs(self):
        """The tenants' graphs (replica placement walks them)."""
        return [a.graph for a in self.appliers.values()]

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_pool"] = None  # holds a lock; a clone finds it by its token
        return state

    # ------------------------------------- the frozen-applier surface
    # (serve/fleet.py and serve/service.py read these): no bucket graphs
    installed_bundle = None

    def installed_buckets(self) -> int:
        return 0

    def has_bucket_program(self, shape, dtype) -> bool:
        return False

    def install_artifacts(self, bundle, device=None, signature=None, strict: bool = False) -> int:
        raise NotImplementedError("the multi-tenant applier installs no bucket graphs: a graph's replay cannot "
                                  "read the shared stage pool, so the executor walk serves")

    # -------------------------------------------------------------- apply
    def __call__(self, data, deadline=None, tenants=None, errors_out=None):
        """Walk every requested tenant's graph over ``data`` (a Dataset, or a
        tensor or array, which goes to the applier's device) under ONE
        flush token; returns ``{tenant: result Dataset}``, each over the
        whole batch.

        ``errors_out``: a dict marks a live flush: each tenant's walk
        passes the ``serve.batch`` fault site with ``ctx.tenant``, and a
        tenant's failure is stored there instead of raised.  ``None``
        (priming, offline use) raises the first failure after the flush's
        pool entries are released."""
        from keystone_tpu_torch.workflow.dataset import as_dataset

        ds = as_dataset(data, device=self.device)
        pool = self.pool()
        names = list(self.appliers) if tenants is None else list(tenants)
        unknown = [t for t in names if t not in self.appliers]
        if unknown:
            raise UnknownTenant(f"unknown tenant(s) {unknown!r}")
        token = next(_TOKENS)
        pool.begin_flush(token, self.plan.sigs_for(names))
        outs: Dict[str, object] = {}
        try:
            for t in names:
                try:
                    if tenants is not None:
                        # live flushes only: what lets a fault plan aim at
                        # one tenant's share of a flush
                        fault_point("serve.batch", tenant=t)
                    outs[t] = self._walk(t, ds, deadline, pool, token)
                except BaseException as e:
                    if errors_out is None:
                        raise
                    errors_out[t] = e
                    metrics.inc("serve.tenant_batch_errors", tenant=t)
        finally:
            pool.end_flush(token)
        return outs

    def _walk(self, tenant: str, ds, deadline, pool, token):
        from keystone_tpu_torch.workflow.executor import DatasetExpr, GraphExecutor

        a = self.appliers[tenant]
        g, _ = a.graph.replace_source_with_node(a.source, G.DatasetOperator(ds))
        ex = GraphExecutor(g, deadline=deadline, stage_pool=pool, pool_token=token,
                           pool_sigs=self.plan.node_sigs.get(tenant))
        expr = ex.execute(g.sink_dependencies[a.sink])
        if not isinstance(expr, DatasetExpr):
            raise TypeError(f"tenant {tenant!r} apply produced {type(expr).__name__}, expected dataset")
        return expr.dataset


class MultiTenantService(PipelineService):
    """A :class:`PipelineService` serving N tenants through one batcher and
    one replica fleet, the shared stage pool computing their common
    prefixes once a combined flush.  Construct with :func:`serve_multi`."""

    def __init__(
        self,
        models: Dict[str, object],
        *,
        share: bool = True,
        pool: Optional[SharedStagePool] = None,
        tenant_queue_bound: Optional[Dict[str, int]] = None,
        tenant_deadline_ms: Optional[Dict[str, float]] = None,
        tenant_breaker_threshold: Optional[int] = None,
        dedup: bool = False,
        **kw,
    ):
        if kw.get("workers") or kw.get("hosts") is not None:
            raise NotImplementedError(
                "multi-tenant serving runs in-process (the shared stage pool and per-tenant containment need the "
                "executor walk); workers= (process fleet) and hosts= (network fleet) apply to single-tenant "
                "services")
        devices = kw.get("devices")
        device = devices[0] if devices else "cuda"
        applier = MultiTenantApplier(models, pool=pool, share=share, device=device)
        self.tenants = tuple(applier.appliers)
        self._mt_applier = applier
        # the per-tenant state exists before the base constructor, which
        # primes and starts the batcher (it calls _next_batch at once)
        self._tq: Dict[str, deque] = {t: deque() for t in self.tenants}
        self._deficit: Dict[str, float] = {t: 0.0 for t in self.tenants}
        self._rr = 0
        self._tlat = {t: metrics.WindowedHistogram("serve.tenant_latency_seconds", tenant=t) for t in self.tenants}
        self._tfail = {t: metrics.WindowedHistogram("serve.tenant_failed_wait_seconds", tenant=t)
                       for t in self.tenants}
        #: in-flight dedup (opt-in): identical concurrent payloads of ONE
        #: tenant are computed once, the followers resolved from the
        #: leader's row; two tenants' equal payloads never share
        self._dedup = bool(dedup)
        self._dedup_lock = threading.Lock()
        self._dedup_inflight: Dict[tuple, object] = {}
        self._tenant_bounds = dict(tenant_queue_bound or {})
        self._tenant_deadline_s = {t: float(ms) / 1000.0 for t, ms in (tenant_deadline_ms or {}).items()}
        #: per-tenant admission breakers (None threshold: off)
        self._tenant_breakers = (
            {t: guard.CircuitBreaker(f"serve.tenant.{t}", threshold=int(tenant_breaker_threshold))
             for t in self.tenants}
            if tenant_breaker_threshold else {}
        )
        super().__init__(applier, **kw)
        stage_pool = applier.pool()
        self._pool_owner = f"{self.name}#{next(_OWNERS)}"
        for t in self.tenants:
            stage_pool.register_tenant(f"{self._pool_owner}:{t}", set(applier.plan.node_sigs.get(t, {}).values()))
        # priming observed every shared stage's bytes: place the pins now
        if applier.plan.shared and self._item_shape is not None:
            stage_pool.auto_pin()

    # --------------------------------------------------------- tenant hooks
    def _resolve_tenant(self, tenant):
        if tenant is None:
            if len(self.tenants) == 1:
                return self.tenants[0]
            raise UnknownTenant(f"service {self.name!r} serves tenants {list(self.tenants)}; "
                                "submit(tenant=...) is required")
        tenant = str(tenant)
        if tenant not in self._tq:
            raise UnknownTenant(f"unknown tenant {tenant!r}; serving {list(self.tenants)}")
        brk = self._tenant_breakers.get(tenant)
        if brk is not None and not brk.allow():
            raise guard.CircuitOpenError(f"tenant {tenant!r} breaker is open (repeated failures); admission "
                                         "refused for this tenant only")
        return tenant

    def _default_deadline_for(self, tenant):
        return self._tenant_deadline_s.get(tenant, self.default_deadline_s)

    def _tenant_bound(self, tenant: str) -> int:
        """The tenant's quota: explicit, else an equal share of the bound,
        so one tenant's burst never takes another's slots."""
        explicit = self._tenant_bounds.get(tenant)
        if explicit is not None:
            return int(explicit)
        return max(1, self.queue_bound // max(1, len(self.tenants)))

    def _check_bound_locked(self, n_new, tenant):
        bound = self._tenant_bound(tenant)
        if len(self._tq[tenant]) + n_new > bound:
            metrics.inc("serve.rejected", n_new)
            raise Overloaded(f"tenant {tenant!r} queue at its quota ({bound}); retry later")
        if self._queue_depth_locked() + n_new > self.queue_bound:
            metrics.inc("serve.rejected", n_new)
            raise Overloaded(f"service {self.name!r} queue at bound ({self.queue_bound}); retry later")

    def _push_locked(self, reqs, tenant):
        q = self._tq[tenant]
        q.extend(reqs)
        depth = self._queue_depth_locked()
        metrics.set_gauge("serve.queue_depth", depth)
        metrics.set_gauge("serve.tenant_queue_depth", len(q), tenant=tenant)
        return depth

    def _queue_depth_locked(self) -> int:
        return sum(len(q) for q in self._tq.values())

    @property
    def queue_depth(self) -> int:
        return self._queue_depth_locked()

    def _fail_queued_locked(self, make_exc) -> None:
        for t, q in self._tq.items():
            while q:
                self._fail(q.popleft(), make_exc())
            metrics.set_gauge("serve.tenant_queue_depth", 0, tenant=t)
        metrics.set_gauge("serve.queue_depth", 0)

    def _account_admission(self, tenant, outcome, n):
        if tenant is None or tenant not in self._tq:
            return
        if outcome == "submitted":
            metrics.inc("serve.tenant_submitted", n, tenant=tenant)
        elif outcome == "rejected":
            metrics.inc("serve.tenant_rejected", n, tenant=tenant)
            for _ in range(n):
                self._tfail[tenant].observe(0.0)
        elif outcome in ("poison", "error"):
            metrics.inc("serve.tenant_errors", n, tenant=tenant)

    def _account_tenant(self, req, outcome, seconds):
        t = req.tenant
        if t is None or t not in self._tq:
            return
        brk = self._tenant_breakers.get(t)
        if outcome in ("completed", "degraded"):
            metrics.inc("serve.tenant_completed", tenant=t)
            self._tlat[t].observe(seconds)
            if brk is not None:
                brk.record_success()
            return
        if outcome == "shed":
            # the service's capacity decision: breaker-neutral
            metrics.inc("serve.tenant_shed", tenant=t)
            self._tfail[t].observe(seconds)
            return
        metrics.inc("serve.tenant_errors", tenant=t)
        self._tfail[t].observe(seconds)
        if brk is not None:
            brk.record_failure()

    # --------------------------------------------------------------- dedup
    def _dedup_keys(self, arrs):
        """Per-datum content digests, outside the admission lock."""
        if not self._dedup:
            return None
        return [_content_key(a) for a in arrs]

    def _dedup_match(self, tenant, keys) -> dict:
        """Datum index → its in-flight leader (an unresolved earlier request
        of equal content), or, for a duplicate within this call, the
        leading datum's index.  Holds the admission lock."""
        followers: dict = {}
        local: dict = {}
        with self._dedup_lock:
            for i, k in enumerate(keys):
                mk = (tenant, k)
                if mk in local:
                    followers[i] = local[mk]
                    continue
                cand = self._dedup_inflight.get(mk)
                if cand is not None and not cand.future.done():
                    followers[i] = cand
                else:
                    local[mk] = i
        return followers

    def _dedup_register(self, tenant, keys, reqs, followers) -> None:
        for i, leader in list(followers.items()):
            if isinstance(leader, int):
                followers[i] = reqs[leader]
        with self._dedup_lock:
            for i, req in enumerate(reqs):
                if i in followers:
                    continue
                mk = (tenant, keys[i])
                self._dedup_inflight[mk] = req
                req.future.add_done_callback(self._dedup_cleanup(mk, req))

    def _dedup_cleanup(self, mk, req):
        def cb(_fut):
            with self._dedup_lock:
                if self._dedup_inflight.get(mk) is req:
                    del self._dedup_inflight[mk]

        return cb

    def _dedup_attach(self, followers: dict, reqs: list) -> None:
        """Fan each leader's outcome out to its followers, outside the
        admission lock: a copy of the leader's row (bit for bit, and a
        caller mutating its answer cannot reach a co-rider's), or the
        leader's typed error."""
        metrics.inc("serve.dedup_hits", len(followers))
        rec = self.recorder
        for i, leader in followers.items():
            req = reqs[i]
            if rec is not None and req.request_id is not None:
                rec.annotate(req.request_id, "serve.dedup", leader=leader.request_id)

            def deliver(lf, req=req, leader=leader):
                try:
                    exc = lf.exception()
                except BaseException as e:  # a cancelled leader
                    exc = e
                if exc is not None:
                    self._fail(req, exc, leader=leader.request_id)
                    return
                waited = time.monotonic() - req.t_submit
                metrics.inc("serve.completed")
                self._lat_win.observe(waited)
                self._account_tenant(req, "completed", waited)
                if req.request_id is not None:
                    if rec is not None:
                        rec.finish(req.request_id, "completed", only_live=True, leader=leader.request_id)
                    if ledger.active() is not None:
                        ledger.event("serve.request", request_id=req.request_id, outcome="completed",
                                     leader=leader.request_id, seconds=round(waited, 6))
                try:
                    req.future.set_result(np.copy(lf.result()))
                except InvalidStateError:
                    pass  # the follower was cancelled meanwhile

            leader.future.add_done_callback(deliver)

    # ------------------------------------------------------------ batching
    def _next_batch(self):
        """Deficit-round-robin flushes: every active tenant earns
        ``max_batch / active`` rows of credit a round and spends it FIFO
        from its own queue, so a combined flush carries a fair share of
        each backlog however unequal the offered loads."""
        with self._cond:
            while self._queue_depth_locked() == 0:
                if self._closing:
                    return None
                self._cond.wait()
            oldest = min(q[0].t_submit for q in self._tq.values() if q)
            flush_at = oldest + self.max_wait_s
            while self._queue_depth_locked() < self.max_batch and not self._closing:
                timeout = flush_at - time.monotonic()
                if timeout <= 0:
                    break
                self._cond.wait(timeout)
            batch = self._drr_pop_locked()
            metrics.set_gauge("serve.queue_depth", self._queue_depth_locked())
            for t in self.tenants:
                metrics.set_gauge("serve.tenant_queue_depth", len(self._tq[t]), tenant=t)
            return _Flush(batch, f"b{next(self._batch_seq)}")

    def _drr_pop_locked(self) -> list:
        active = [t for t in self.tenants if self._tq[t]]
        for t in self.tenants:
            if not self._tq[t]:
                self._deficit[t] = 0.0
        if not active:
            return []
        quantum = max(1.0, self.max_batch / len(active))
        # the starting tenant rotates, so sub-quantum rounding favours
        # no tenant order
        self._rr += 1
        start = self._rr % len(active)
        order = active[start:] + active[:start]
        batch: list = []
        while len(batch) < self.max_batch and any(self._tq[t] for t in order):
            for t in order:
                if len(batch) >= self.max_batch:
                    # a full flush earns nobody further credit: banked
                    # quantum would let one tenant take the next flush
                    break
                q = self._tq[t]
                if not q:
                    self._deficit[t] = 0.0
                    continue
                self._deficit[t] += quantum
                while q and self._deficit[t] >= 1.0 and len(batch) < self.max_batch:
                    batch.append(q.popleft())
                    self._deficit[t] -= 1.0
        for t in order:
            # at most one quantum of unspent credit carries over
            self._deficit[t] = min(self._deficit[t], quantum)
        idx = {t: i for i, t in enumerate(order)}
        batch.sort(key=lambda r: idx.get(r.tenant, len(idx)))
        return batch

    # --------------------------------------------------------------- apply
    def _apply_reqs(self, reqs, replica, deadline):
        """One padded batch, one flush token, each tenant's walk reading the
        shared prefix through the pool.  A tenant's failure stays its own:
        its riders fail (bisected inside its segment when the error is
        content-shaped), the other tenants deliver.  Only when every
        tenant failed does the flush take the base error path."""
        segs = []
        for i, r in enumerate(reqs):
            if not segs or segs[-1][0] != r.tenant:
                segs.append([r.tenant, i, i + 1])
            else:
                segs[-1][2] = i + 1
        names = list(dict.fromkeys(s[0] for s in segs))
        stacked = np.stack([r.x for r in reqs])
        if len(names) == 1:
            # one tenant (bisection's re-runs land here): failures
            # propagate to the caller's bisection and containment
            return self._apply_rows(stacked, deadline=deadline, replica=replica, tenants=names)[names[0]]
        errors: dict = {}
        outs = self._apply_rows(stacked, deadline=deadline, replica=replica, tenants=names, errors_out=errors)
        if errors and len(errors) == len(names):
            raise next(iter(errors.values()))
        out_rows: list = [None] * len(reqs)
        for t, s, e in segs:
            if t in errors:
                exc, group = errors[t], reqs[s:e]
                if self._bisect and _poison_suspect(exc):
                    self._bisect_flush(group, replica, "tenant-bisect", deadline, exc)
                else:
                    for r in group:
                        self._fail(r, exc, replica=replica.index)
                continue
            rows = outs[t]
            for i in range(s, e):
                out_rows[i] = rows[i]
        return out_rows

    # -------------------------------------------------------------- status
    def status(self) -> dict:
        out = super().status()
        reg = metrics.REGISTRY
        tenants = {}
        for t in self.tenants:
            lat = self._tlat[t].summary()
            n_ok, n_fail = lat["count"], self._tfail[t].summary()["count"]
            entry = {
                "queue_depth": len(self._tq[t]),
                "quota": self._tenant_bound(t),
                "latency_ms": self._ms(lat),
                "counters": {
                    key: reg.counter_value(f"serve.tenant_{key}", tenant=t)
                    for key in ("submitted", "completed", "shed", "rejected", "errors")
                },
            }
            brk = self._tenant_breakers.get(t)
            if brk is not None:
                entry["breaker"] = brk.state()
            if self._slo_s is not None:
                n = n_ok + n_fail
                bad = 0.0 if n == 0 else (self._tlat[t].fraction_above(self._slo_s) * n_ok + n_fail) / n
                budget = 1.0 - self._slo_target
                entry["slo"] = {"bad_fraction": round(bad, 6),
                                "burn_rate": None if budget <= 0.0 else round(bad / budget, 3)}
            tenants[t] = entry
        out["tenants"] = tenants
        plan = self._mt_applier.plan
        out["stage_pool"] = {
            **self._mt_applier.pool().stats(),
            "shared_stages": len(plan.shared),
            "collision_refusals": plan.refused,
            "sharing": self._mt_applier.share,
        }
        return out

    # ------------------------------------------------------------ shutdown
    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        super().close(drain=drain, timeout=timeout)
        pool = self._mt_applier.pool()
        for t in self.tenants:
            pool.unregister_tenant(f"{self._pool_owner}:{t}")


def serve_multi(
    models: Dict[str, object],
    *,
    share: bool = True,
    pool: Optional[SharedStagePool] = None,
    tenant_queue_bound: Optional[Dict[str, int]] = None,
    tenant_deadline_ms: Optional[Dict[str, float]] = None,
    tenant_breaker_threshold: Optional[int] = None,
    dedup: bool = False,
    **kw,
) -> MultiTenantService:
    """Stand up a :class:`MultiTenantService` (the reference's
    ``serve_multi``).

    ``models``: ``{tenant name: fitted pipeline or FrozenApplier}``;
    pipelines are frozen for the card, or for ``devices[0]`` when
    ``devices=`` is given (``devices=["cpu"]`` serves on the CPU, as the
    tests do).  ``share=False`` turns the shared stage pool off (the A/B
    arm of ``tools/serve_bench.py --tenants``).  ``pool``: a private
    :class:`SharedStagePool` (default: the process-wide one).
    ``tenant_queue_bound`` / ``tenant_deadline_ms``: per-tenant quota and
    default deadline (the quota defaults to an equal share of
    ``queue_bound``).  ``tenant_breaker_threshold``: consecutive failures
    before a tenant's own admission breaker opens (None: off).
    ``dedup=True``: identical concurrent payloads of one tenant are
    computed once (``serve.dedup_hits``; a shed leader sheds its
    followers, so it is opt-in).  Other keywords are
    :func:`~keystone_tpu_torch.serve.service.serve`'s (``max_batch``,
    ``deadline_ms``, ``replicas``, ``example``, ...); ``workers=`` and
    ``hosts=`` raise ``NotImplementedError``.

    Requests name their tenant: ``svc.submit(x, tenant="name")``, or HTTP
    ``POST /predict`` with ``"tenant"`` in the body."""
    return MultiTenantService(models, share=share, pool=pool, tenant_queue_bound=tenant_queue_bound,
                              tenant_deadline_ms=tenant_deadline_ms,
                              tenant_breaker_threshold=tenant_breaker_threshold, dedup=dedup, **kw)
