"""Open-loop load generator for the serving path (counterpart of
``tools/serve_bench.py``'s ``build_pipeline``, ``build_service``,
``run_bench``, ``run_ingress_ab``, ``build_tenant_models``,
``build_tenant_service``, ``run_tenants_bench``, ``run_tenants_ab`` and
``run_plan_ab``).

Drives a :class:`keystone_tpu_torch.serve.PipelineService` with a fixed
arrival schedule: requests are submitted at the target rate whether or
not earlier ones completed (open loop: a closed-loop generator throttles
itself and hides queueing collapse), and the report gives latency
percentiles, achieved throughput, mean batch occupancy and the
shed/rejected counts.

    python -m keystone_tpu_torch.tools.serve_bench --device cpu --qps 500 --duration 2

The default workload is the reference's synthetic two-stage pipeline
(NormalizeRows → LinearMapper), which measures the serving layer
itself; ``--model`` serves a saved fitted pipeline whose input is a
``--dim``-vector.  ``--tenants N`` runs the multi-tenant A/B instead:
N tenants over one featurization prefix behind ``serve_multi``, the
shared stage pool on against off, per tenant, at ``--dim``.  ``--workers N`` serves it with a process fleet of N
workers (each with the model on ``--device``) in place of the threaded
fleet.  ``--ingress-ab`` runs the front-end A/B instead: one service
behind one binary ingress port, saturated in turns by per-datum HTTP
JSON clients and by whole-batch binary clients, with the two paths'
answers compared bit for bit.  ``--plan-ab`` runs the physical planner's
A/B instead: the pipeline frozen with a sampled ``PhysicalPlan`` against
the static defaults, on the forward and on the open loop, then a live
``PlanTuner`` under the workload zoo's ``drift`` scenario.  The report is
one JSON object on stdout.

    python -m keystone_tpu_torch.tools.serve_bench --device cpu --workers 2 --ingress-ab --duration 1
    python -m keystone_tpu_torch.tools.serve_bench --device cpu --plan-ab --duration 1 --rounds 2
"""

from __future__ import annotations

import argparse
import contextlib
import json
import threading
import time
from concurrent.futures import wait as futures_wait

import numpy as np
import torch

from keystone_tpu_torch.workflow.transformer import Transformer

#: the rollout drill's poison marker: a row whose first element is this
MARK = 123.0


def build_pipeline(dim: int = 64, classes: int = 16, seed: int = 0, device="cuda"):
    """The synthetic two-stage workload (NormalizeRows → LinearMapper),
    its weights the reference's seeded draw."""
    from keystone_tpu_torch.models.linear import LinearMapper
    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(dim, classes)).astype(np.float32)).to(resolve_device(device))
    return Pipeline.of(NormalizeRows()) | LinearMapper(w)


class MarkerGate(Transformer):
    """The rollout drill's bad model version's first stage (the
    reference's ``tools/workloads.py`` MarkerGate): raises ``ValueError``,
    a content fault, on a batch holding a marker row (its first element
    is :data:`MARK`) and passes any other batch through, so the version
    primes on zero rows and fails the marked traffic a good version
    serves.  Module-level, so a registry-published pipeline carrying it
    loads in another process.  It reads the batch's first column back to
    the host: no bucket graph can hold it."""

    def params(self):
        return ("marker-gate", MARK)

    def apply_batch(self, xs, mask=None):
        if bool((xs.reshape(xs.shape[0], -1)[:, 0] == MARK).any()):
            raise ValueError("poison marker row")
        return xs


def build_service(
    dim: int = 64,
    classes: int = 16,
    max_batch: int = 32,
    max_wait_ms: float = 2.0,
    queue_bound: int = 128,
    deadline_ms: float | None = 250.0,
    model: str | None = None,
    seed: int = 0,
    replicas: int = 1,
    recorder: bool = True,
    device="cuda",
    workers: int = 0,
    **serve_kw,
):
    """A primed service over the synthetic pipeline (or a saved fitted
    model) on ``device``; returns ``(service, item_shape)``.  ``workers``:
    a process fleet of that many workers, each with the model on
    ``device`` (the router keeps it on the host).  Extra keywords
    (``hedge_ms``, ``supervise``, ``heartbeat_s``, ...) pass through to
    :func:`keystone_tpu_torch.serve.serve`."""
    from keystone_tpu_torch.serve import serve
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    dev = resolve_device(device)
    home = torch.device("cpu") if workers else dev
    if model:
        pipe = FittedPipeline.load(model, map_location=home)
    else:
        pipe = build_pipeline(dim=dim, classes=classes, seed=seed, device=home)
    item_shape = (int(dim),)
    if workers:
        fleet = dict(workers=int(workers), worker_opts={"device": str(dev), **serve_kw.pop("worker_opts", {})})
    else:
        fleet = dict(replicas=replicas, devices=[dev] * replicas)
    svc = serve(
        pipe,
        max_batch=max_batch,
        max_wait_ms=max_wait_ms,
        queue_bound=queue_bound,
        deadline_ms=deadline_ms,
        example=np.zeros(item_shape, np.float32),
        name="serve_bench",
        recorder=recorder,
        **fleet,
        **serve_kw,
    )
    return svc, item_shape


def _hist_delta(before: dict, after: dict, name: str) -> tuple:
    b = before.get(name) or {"count": 0, "sum": 0.0}
    a = after.get(name) or {"count": 0, "sum": 0.0}
    return a["count"] - b["count"], a["sum"] - b["sum"]


def _counter_delta(c0: dict, c1: dict, name: str) -> float:
    return c1.get(name, 0.0) - c0.get(name, 0.0)


def run_bench(
    svc,
    item_shape,
    qps: float,
    duration: float,
    burst: int = 1,
    deadline_ms: float | None = None,
    batch_delay_ms: float = 0.0,
    swap_pipeline=None,
    straggler_ms: float = 0.0,
    straggler_replica: int = 0,
    payload=None,
) -> dict:
    """Offer ``qps`` requests/s for ``duration`` seconds (groups of
    ``burst`` arrivals at the same mean rate, each group one atomic
    ``submit_many``), wait for the tail to drain, and report.
    ``batch_delay_ms`` stalls every flush through a ``serve.batch:delay``
    plan (a heavier model); ``swap_pipeline`` is hot-swapped in at the
    midpoint (the report gains its pause and prime seconds);
    ``straggler_ms`` stalls one replica's worker (``serve.worker``,
    context-matched), the straggler hedging rescues.  ``payload``: the
    request rows to cycle through (default: seeded normal rows of
    ``item_shape``)."""
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.serve import Overloaded
    from keystone_tpu_torch.utils import guard

    burst = max(1, int(burst))
    deadline_s = None if not deadline_ms else float(deadline_ms) / 1000.0
    snap0 = metrics.snapshot()
    c0 = dict(snap0.get("counters") or {})
    lock = threading.Lock()
    latencies: list = []
    outcomes = {"completed": 0, "shed": 0, "rejected": 0, "errors": 0}

    def record(fut, t_submit):
        t_done = time.monotonic()
        exc = fut.exception()
        with lock:
            if exc is None:
                outcomes["completed"] += 1
                latencies.append(t_done - t_submit)
            elif isinstance(exc, guard.DeadlineExceeded):
                outcomes["shed"] += 1
            else:
                outcomes["errors"] += 1

    if payload is None:
        payload = np.random.default_rng(1).normal(size=(burst,) + tuple(item_shape)).astype(np.float32)
    n_arrivals = max(1, int(round(qps * duration)))
    interval = burst / qps
    futs = []
    clauses = []
    if batch_delay_ms > 0:
        clauses.append(f"serve.batch:delay={batch_delay_ms / 1000.0}")
    if straggler_ms > 0:
        # serve.worker, not serve.replica: the stall lands before the flush
        # is claimed, so it stays unflushed for the whole stall
        clauses.append(f"serve.worker:ctx.replica={int(straggler_replica)}:delay={straggler_ms / 1000.0}")
    plan = faults.inject(";".join(clauses)) if clauses else contextlib.nullcontext()
    swap_info: dict = {}
    swap_thread = None
    if swap_pipeline is not None:

        def _swap_midway():
            time.sleep(duration / 2.0)
            try:
                swap_info.update(svc.swap(swap_pipeline, version="bench-swap"))
            except Exception as e:  # report it; don't kill the offer loop
                swap_info["error"] = f"{type(e).__name__}: {e}"

        swap_thread = threading.Thread(target=_swap_midway, daemon=True)
    t_start = time.monotonic()
    if swap_thread is not None:
        swap_thread.start()
    with plan:
        next_t = t_start
        sent = 0
        while sent < n_arrivals:
            now = time.monotonic()
            if now < next_t:
                time.sleep(min(next_t - now, 0.002))
                continue
            n = min(burst, n_arrivals - sent)
            group = [payload[(sent + i) % len(payload)] for i in range(n)]
            t_submit = time.monotonic()
            try:
                batch_futs = svc.submit_many(group, deadline=deadline_s)
            except Overloaded:
                with lock:
                    outcomes["rejected"] += n
            else:
                for fut in batch_futs:
                    fut.add_done_callback(lambda f, t0=t_submit: record(f, t0))
                futs.extend(batch_futs)
            sent += n
            next_t += interval
        # throughput over the OFFER window; the drain below is reported apart
        offer_elapsed = time.monotonic() - t_start
        futures_wait(futs, timeout=duration + 60.0)
    wall_elapsed = time.monotonic() - t_start
    if swap_thread is not None:
        swap_thread.join(timeout=duration + 60.0)
    replica_stats = svc.replica_statuses()
    snap1 = metrics.snapshot()
    c1 = dict(snap1.get("counters") or {})
    rows_n, rows_sum = _hist_delta(snap0.get("histograms") or {}, snap1.get("histograms") or {},
                                   "serve.batch_rows")
    lat_ms = sorted(x * 1000.0 for x in latencies)

    def pct(p):
        return None if not lat_ms else float(np.percentile(lat_ms, p))

    completed = outcomes["completed"]
    report = {
        "offered_qps": qps,
        "duration_s": duration,
        "burst": burst,
        "submit_mode": "batched",
        "deadline_ms": deadline_ms,
        "batch_delay_ms": batch_delay_ms,
        "straggler_ms": straggler_ms,
        "hedges": int(_counter_delta(c0, c1, "serve.hedges")),
        "hedge_wins": int(_counter_delta(c0, c1, "serve.hedge_wins")),
        "n_requests": n_arrivals,
        "completed": completed,
        "shed": outcomes["shed"],
        "rejected": outcomes["rejected"],
        "errors": outcomes["errors"],
        "achieved_qps": completed / offer_elapsed if offer_elapsed > 0 else None,
        "achieved_qps_wall": completed / wall_elapsed if wall_elapsed > 0 else None,
        "drain_s": wall_elapsed - offer_elapsed,
        "p50_ms": pct(50),
        "p95_ms": pct(95),
        "p99_ms": pct(99),
        "p999_ms": pct(99.9),
        "max_ms": lat_ms[-1] if lat_ms else None,
        "batches": rows_n,
        "mean_batch_occupancy": rows_sum / rows_n if rows_n else None,
        "shed_rate": (outcomes["shed"] + outcomes["rejected"]) / n_arrivals,
        "deadline_miss": int(_counter_delta(c0, c1, "serve.deadline_miss")),
        "replicas": len(replica_stats),
        "recorder": svc.recorder is not None,
        # flush share per replica (counter deltas span a swap)
        "replica_occupancy": _occupancy(replica_stats, c0, c1),
    }
    if swap_pipeline is not None:
        report["swap"] = dict(swap_info)
    return report


def _occupancy(replica_stats: list, c0: dict, c1: dict) -> list:
    """Each replica's share of the run's flushes."""
    deltas = []
    for st in replica_stats:
        key = f"serve.replica_flushes{{replica={st['replica']}}}"
        deltas.append(_counter_delta(c0, c1, key))
    total = sum(deltas) or 1.0
    return [d / total for d in deltas]


def _fft_gather_feat(dim: int, branches: int, seed: int = 0, device="cuda"):
    """A ``branches``-way gather of RandomSignNode → PaddedFFT →
    LinearRectifier chains (the MnistRandomFFT shape), each rectifier with
    its own constant; returns ``(featurizer pipeline, feature dim)``."""
    from keystone_tpu_torch.ops.stats import LinearRectifier, PaddedFFT, RandomSignNode
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    feat = Pipeline.gather([
        RandomSignNode.init(dim, seed * 1000 + i, device=device) | PaddedFFT() | LinearRectifier(0.0, alpha=0.001 * (i + 1))
        for i in range(int(branches))
    ])
    padded = 1 << (dim - 1).bit_length()
    return feat, branches * (padded // 2 + 1) * 2


def build_tenant_models(tenants: int = 3, dim: int = 64, classes: int = 16, branches: int = 6, seed: int = 0,
                        device="cuda") -> dict:
    """N tenant pipelines over ONE featurization prefix (every tenant's
    gather made from the same seeds, so the plan shares it) with a head of
    its own (seeded weights a tenant): ``{"t0": ..., "t1": ...}``."""
    from keystone_tpu_torch.models.linear import LinearMapper
    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    models = {}
    for t in range(int(tenants)):
        feat, feat_dim = _fft_gather_feat(dim, branches, seed, device=dev)
        rng = np.random.default_rng(seed + 100 + t)
        w = torch.from_numpy(rng.normal(size=(feat_dim, classes)).astype(np.float32)).to(dev)
        models[f"t{t}"] = feat | NormalizeRows() | LinearMapper(w)
    return models


def build_tenant_service(models: dict, item_shape, share: bool = True, max_batch: int = 32,
                         max_wait_ms: float = 2.0, queue_bound: int = 256, deadline_ms: float | None = 1000.0,
                         device="cuda", dtype=np.float32, **serve_kw):
    """A primed multi-tenant service over ``models`` on ``device``.
    ``share=False`` is the A/B's control arm: the same DRR batching and
    combined flushes, the shared stage pool off."""
    from keystone_tpu_torch.serve import serve_multi
    from keystone_tpu_torch.utils.device import resolve_device

    return serve_multi(models, share=share, max_batch=max_batch, max_wait_ms=max_wait_ms, queue_bound=queue_bound,
                       deadline_ms=deadline_ms, example=np.zeros(tuple(item_shape), dtype),
                       devices=[resolve_device(device)], name="serve_bench_mt", **serve_kw)


def run_tenants_bench(svc, names, qps: float, duration: float, payload, deadline_ms: float | None = None,
                      burst: int = 8) -> dict:
    """Open-loop offered load split equally over the tenants: each tick
    submits one ``burst``-row ``submit_many`` for the next tenant in turn,
    at the aggregate mean rate, cycling through ``payload``'s rows.  Waits
    for the tail and reports the aggregate and per-tenant achieved rate,
    p50/p99 and outcomes, the fairness ratio (largest per-tenant p99 over
    the smallest) and the pool's counters over the run."""
    from keystone_tpu_torch.serve import Overloaded
    from keystone_tpu_torch.utils import guard

    deadline_s = None if not deadline_ms else float(deadline_ms) / 1000.0
    burst = max(1, int(burst))
    lock = threading.Lock()
    lat: dict = {t: [] for t in names}
    outcomes = {t: {"completed": 0, "shed": 0, "rejected": 0, "errors": 0} for t in names}

    def record(fut, t_submit, tenant):
        t_done = time.monotonic()
        exc = fut.exception()
        with lock:
            o = outcomes[tenant]
            if exc is None:
                o["completed"] += 1
                lat[tenant].append(t_done - t_submit)
            elif isinstance(exc, guard.DeadlineExceeded):
                o["shed"] += 1
            else:
                o["errors"] += 1

    pool0 = dict(svc.status().get("stage_pool") or {})
    n_arrivals = max(len(names) * burst, int(round(qps * duration)))
    interval = burst / qps
    futs = []
    t_start = time.monotonic()
    next_t = t_start
    sent = tick = 0
    while sent < n_arrivals:
        now = time.monotonic()
        if now < next_t:
            time.sleep(min(next_t - now, 0.002))
            continue
        tenant = names[tick % len(names)]
        tick += 1
        k = min(burst, n_arrivals - sent)
        rows = [payload[(sent + i) % len(payload)] for i in range(k)]
        t_submit = time.monotonic()
        try:
            group = svc.submit_many(rows, deadline=deadline_s, tenant=tenant)
        except Overloaded:
            with lock:
                outcomes[tenant]["rejected"] += k
        else:
            for fut in group:
                fut.add_done_callback(lambda f, t0=t_submit, tn=tenant: record(f, t0, tn))
            futs.extend(group)
        sent += k
        next_t += interval
    offer_elapsed = time.monotonic() - t_start
    futures_wait(futs, timeout=duration + 60.0)
    wall_elapsed = time.monotonic() - t_start

    def pct(vals, p):
        return None if not vals else float(np.percentile([v * 1000.0 for v in vals], p))

    per_tenant = {t: {**outcomes[t], "achieved_qps": outcomes[t]["completed"] / offer_elapsed,
                      "p50_ms": pct(lat[t], 50), "p99_ms": pct(lat[t], 99)} for t in names}
    completed = sum(o["completed"] for o in outcomes.values())
    p99s = [v["p99_ms"] for v in per_tenant.values() if v["p99_ms"]]
    pool1 = dict(svc.status().get("stage_pool") or {})
    hits = pool1.get("hits", 0) - pool0.get("hits", 0)
    misses = pool1.get("misses", 0) - pool0.get("misses", 0)
    return {
        "offered_qps": qps,
        "duration_s": duration,
        "tenants": len(names),
        "n_requests": n_arrivals,
        "aggregate_completed": completed,
        "aggregate_qps": completed / offer_elapsed if offer_elapsed > 0 else None,
        "aggregate_qps_wall": completed / wall_elapsed if wall_elapsed > 0 else None,
        "drain_s": wall_elapsed - offer_elapsed,
        "fairness_p99_ratio": max(p99s) / min(p99s) if p99s and min(p99s) > 0 else None,
        "per_tenant": per_tenant,
        "pool": {"hits": hits, "misses": misses, "hit_rate": hits / (hits + misses) if hits + misses else None,
                 **{k: pool1.get(k) for k in ("evictions", "shared_stages", "collision_refusals", "sharing",
                                                "peak_bytes", "resident_bytes")}},
    }


def run_tenants_ab(models_fn=None, payload=None, item_shape=None, qps: float = 12000.0, duration: float = 2.0,
                   rounds: int = 3, tenants: int = 3, branches: int = 12, max_batch: int = 64,
                   deadline_ms: float = 8000.0, dim: int = 512, device="cuda", dtype=np.float32) -> dict:
    """The sharing A/B: the same workload against a shared-pool service and
    its share-off twin in one process, rounds alternating the order after
    a discarded warm-up round, the flight recorder off in both arms.
    First one probe row a tenant must answer bit for bit in both arms.
    ``models_fn()`` makes ``{tenant: pipeline}`` (called once an arm;
    default :func:`build_tenant_models` at ``dim``, ``branches``), and
    ``payload`` / ``item_shape`` the rows offered (default seeded normal
    rows of ``(dim,)``)."""
    import statistics

    if models_fn is None:
        def models_fn():
            return build_tenant_models(tenants=tenants, dim=dim, branches=branches, device=device)
    if item_shape is None:
        item_shape = (int(dim),)
    if payload is None:
        payload = np.random.default_rng(1).normal(size=(64,) + tuple(item_shape)).astype(dtype)
    services = {}
    for mode, share in (("shared", True), ("unshared", False)):
        models = models_fn()
        services[mode] = (build_tenant_service(models, item_shape, share=share, max_batch=max_batch,
                                               queue_bound=max(256, max_batch * 8), deadline_ms=deadline_ms,
                                               recorder=False, device=device, dtype=dtype), list(models))
    identical = True
    samples: dict = {"shared": [], "unshared": []}
    try:
        for t in services["shared"][1]:
            a = services["shared"][0].submit(payload[0], tenant=t).result(60.0)
            b = services["unshared"][0].submit(payload[0], tenant=t).result(60.0)
            identical = identical and np.array_equal(a, b)
        for rnd in range(max(2, int(rounds)) + 1):
            order = ("shared", "unshared") if rnd % 2 == 0 else ("unshared", "shared")
            for mode in order:
                svc, names = services[mode]
                rep = run_tenants_bench(svc, names, qps=qps, duration=duration if rnd > 0 else 0.5, payload=payload,
                                        deadline_ms=deadline_ms)
                if rnd > 0:
                    samples[mode].append(rep)
    finally:
        for svc, _ in services.values():
            svc.close()

    def med(mode, key):
        vals = [r[key] for r in samples[mode] if r.get(key) is not None]
        return float(statistics.median(vals)) if vals else None

    shared_qps, unshared_qps = med("shared", "aggregate_qps"), med("unshared", "aggregate_qps")
    return {
        "offered_qps": qps,
        "duration_s": duration,
        "rounds": len(samples["shared"]),
        "tenants": len(services["shared"][1]),
        "aggregate_qps_shared": shared_qps,
        "aggregate_qps_unshared": unshared_qps,
        "runs_qps_shared": [r["aggregate_qps"] for r in samples["shared"]],
        "runs_qps_unshared": [r["aggregate_qps"] for r in samples["unshared"]],
        "speedup": shared_qps / unshared_qps if shared_qps and unshared_qps else None,
        "fairness_p99_ratio": med("shared", "fairness_p99_ratio"),
        "predictions_identical": bool(identical),
        "pool": samples["shared"][-1]["pool"] if samples["shared"] else {},
        "per_tenant_shared": samples["shared"][-1]["per_tenant"] if samples["shared"] else {},
    }


def _http_datum_client(host, port, rows, stop_evt, lock, lats, counts):
    """One keep-alive HTTP/1.1 client POSTing one datum a request (the
    JSON front end's submit shape) until ``stop_evt``."""
    import http.client

    def connect():
        return http.client.HTTPConnection(host, port, timeout=30.0)

    conn = connect()
    i = 0
    try:
        while not stop_evt.is_set():
            body = json.dumps({"instance": rows[i % len(rows)]}).encode()
            i += 1
            t0 = time.monotonic()
            try:
                conn.request("POST", "/predict", body, {"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                ok = resp.status == 200
            except (OSError, http.client.HTTPException):
                ok = False
                conn.close()
                conn = connect()
            dt = time.monotonic() - t0
            with lock:
                if ok:
                    counts["completed"] += 1
                    lats.append(dt)
                else:
                    counts["errors"] += 1
    finally:
        conn.close()


def _binary_batch_client(host, port, batch, stop_evt, lock, lats, counts):
    """One binary client sending whole ``(b, dim)`` batches on one
    connection until ``stop_evt``."""
    from keystone_tpu_torch.serve.ingress import BinaryClient, IngressError
    from keystone_tpu_torch.serve.wire import WireError

    b = int(batch.shape[0])
    try:
        with BinaryClient(host, port) as c:
            while not stop_evt.is_set():
                t0 = time.monotonic()
                try:
                    c.predict(batch)
                    ok = True
                except IngressError:
                    ok = False
                dt = time.monotonic() - t0
                with lock:
                    if ok:
                        counts["completed"] += b
                        lats.append(dt)
                    else:
                        counts["errors"] += b
    except (OSError, WireError, EOFError):
        with lock:
            counts["errors"] += b


def _saturate(client, n_clients, args_common, duration) -> dict:
    """A closed-loop saturation leg: ``n_clients`` persistent client
    threads for ``duration`` seconds; the per-datum rate over the window
    is the front end's ceiling (a closed loop throttles itself at
    capacity)."""
    lock = threading.Lock()
    lats: list = []
    counts = {"completed": 0, "errors": 0}
    stop_evt = threading.Event()
    threads = [threading.Thread(target=client, args=args_common + (stop_evt, lock, lats, counts), daemon=True)
               for _ in range(int(n_clients))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(max(0.2, float(duration)))
    stop_evt.set()
    for t in threads:
        t.join(30.0)
    elapsed = time.monotonic() - t0
    lat_ms = np.asarray(lats) * 1000.0
    return {
        "clients": int(n_clients),
        "completed": counts["completed"],
        "errors": counts["errors"],
        "per_datum_qps": counts["completed"] / elapsed if elapsed > 0 else None,
        "p50_ms": float(np.percentile(lat_ms, 50)) if lat_ms.size else None,
        "p99_ms": float(np.percentile(lat_ms, 99)) if lat_ms.size else None,
    }


def run_ingress_ab(duration: float = 2.0, rounds: int = 2, dim: int = 64, max_batch: int = 64, shards: int = 2,
                   http_clients: int = 8, bin_clients: int = 4, bin_batch: int | None = None, device="cuda",
                   workers: int = 0) -> dict:
    """:func:`ingress_ab` on serve_bench's synthetic pipeline of width
    ``dim`` (a process fleet with ``workers``), fed ``bin_batch``-row
    batches of seeded normal rows."""
    bin_batch = int(bin_batch or max_batch)
    svc, item_shape = build_service(dim=dim, max_batch=max_batch, max_wait_ms=2.0, queue_bound=4096,
                                    deadline_ms=None, recorder=False, device=device, workers=workers)
    probe = np.random.default_rng(3).normal(size=(bin_batch,) + tuple(item_shape)).astype(np.float32)
    try:
        rep = ingress_ab(svc, probe, duration=duration, rounds=rounds, shards=shards, http_clients=http_clients,
                         bin_clients=bin_clients)
    finally:
        svc.close()
    return dict(rep, device=str(device), workers=int(workers), dim=dim, max_batch=max_batch)


def ingress_ab(svc, probe: np.ndarray, duration: float = 2.0, rounds: int = 2, shards: int = 2,
               http_clients: int = 8, bin_clients: int = 4) -> dict:
    """The front-end A/B: ``svc`` behind one
    :class:`~keystone_tpu_torch.serve.ingress.AsyncIngress` port,
    saturated in turns by per-datum HTTP JSON clients (the sniffed slow
    path, cycling over ``probe``'s rows) and by binary clients sending
    all of ``probe`` as one batch, order alternating after a discarded
    warm-up round; the median per-datum rate and latency of each,
    ``serve.preformed_flushes`` (binary batches that skipped the stack
    and pad copies) and each arm's ``ingress.bytes_copied`` (the JSON
    arm charges every parsed byte, the binary arm none), with ``probe``'s
    answers through both paths compared bit for bit on the quiet service
    first.  The caller owns ``svc``."""
    import statistics
    import urllib.request

    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.serve.ingress import BinaryClient, serve_ingress

    front = serve_ingress(svc, port=0, shards=shards)
    samples: dict = {"http": [], "binary": []}
    try:
        with BinaryClient("127.0.0.1", front.port) as c:
            bin_out = c.predict(probe)
        req = urllib.request.Request(f"http://127.0.0.1:{front.port}/predict",
                                     data=json.dumps({"instances": probe.tolist()}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            http_out = np.asarray(json.loads(resp.read())["predictions"], dtype=np.float32)
        identical = bin_out.tobytes() == http_out.tobytes()
        rows_json = [r.tolist() for r in probe]
        bytes_copied: dict = {}
        reg = metrics.REGISTRY
        pre0 = reg.counter_value("serve.preformed_flushes")
        for rnd in range(max(1, int(rounds)) + 1):
            for mode in (("http", "binary") if rnd % 2 == 0 else ("binary", "http")):
                b0 = reg.counter_value("ingress.bytes_copied")
                leg = duration if rnd > 0 else 0.5
                if mode == "http":
                    rep = _saturate(_http_datum_client, http_clients, ("127.0.0.1", front.port, rows_json), leg)
                else:
                    rep = _saturate(_binary_batch_client, bin_clients, ("127.0.0.1", front.port, probe), leg)
                rep["bytes_copied"] = int(reg.counter_value("ingress.bytes_copied") - b0)
                if rnd > 0:  # round 0 warms up
                    samples[mode].append(rep)
                    bytes_copied[mode] = bytes_copied.get(mode, 0) + rep["bytes_copied"]
        preformed = int(reg.counter_value("serve.preformed_flushes") - pre0)
    finally:
        front.stop()

    def med(mode: str, key: str):
        vals = [r[key] for r in samples[mode] if r.get(key) is not None]
        return float(statistics.median(vals)) if vals else None

    http_qps, bin_qps = med("http", "per_datum_qps"), med("binary", "per_datum_qps")
    return {
        "mode": "closed-loop saturation", "duration_s": duration, "rounds": len(samples["http"]), "shards": shards,
        "bin_batch": int(probe.shape[0]),
        "http": {"clients": http_clients, "per_datum_qps": http_qps, "p50_ms": med("http", "p50_ms"),
                 "p99_ms": med("http", "p99_ms"), "errors": sum(r["errors"] for r in samples["http"]),
                 "runs_qps": [r["per_datum_qps"] for r in samples["http"]]},
        "binary": {"clients": bin_clients, "per_datum_qps": bin_qps, "frame_p50_ms": med("binary", "p50_ms"),
                   "frame_p99_ms": med("binary", "p99_ms"), "errors": sum(r["errors"] for r in samples["binary"]),
                   "runs_qps": [r["per_datum_qps"] for r in samples["binary"]]},
        "speedup": bin_qps / http_qps if http_qps and bin_qps else None,
        "predictions_identical": identical,
        "preformed_flushes": preformed,
        "bytes_copied": bytes_copied,
    }


def _drifted(bank: np.ndarray, event: dict, n: int, cursor: int) -> np.ndarray:
    """``n`` rows of a payload bank for one zoo event, from ``cursor`` on,
    shifted by the event's drift (in the bank's own scale: a uint8 image
    brightens by 40 levels a unit of shift, clipped)."""
    rows = bank[(cursor + np.arange(n)) % len(bank)]
    shift = float(event.get("shift") or 0.0)
    if not shift:
        return rows
    if np.issubdtype(rows.dtype, np.integer):
        return np.clip(rows.astype(np.float32) + 40.0 * shift, 0, 255).astype(rows.dtype)
    return (rows + np.asarray(shift, rows.dtype)).astype(rows.dtype)


def run_plan_ab(fitted=None, payload=None, item_shape=None, dim: int = 64, classes: int = 16, max_batch: int = 32,
                qps: float = 300.0, duration: float = 3.0, rounds: int = 2, deadline_ms: float = 500.0,
                queue_bound: int = 256, seed: int = 0, drift_duration: float = 3.0, drift_qps: float = 250.0,
                device="cuda") -> dict:
    """The planner's A/B (the reference's ``run_plan_ab``): one fitted
    pipeline served with the cost-based ``PhysicalPlan`` installed (the
    sampled winners and the serving knobs derived from the forward's
    curve) against the static defaults, on the forward and on the open
    loop, then a live ``PlanTuner`` retune under the zoo's ``drift``
    scenario.  The forward arms alternate over ``rounds`` interleaved
    rounds (the best round each), the serve arms over ``rounds`` rounds of
    ``duration`` seconds in alternating order.  The drift check: windowed
    p99 improved, or the retune reverted through its bake, with
    ``lost_futures == 0`` either way.

    ``fitted``: the pipeline (default :func:`build_pipeline` at ``dim``);
    ``payload``: the rows offered, item-shaped (default seeded normal
    rows); the plan samples its batches from them."""
    from keystone_tpu_torch import planner
    from keystone_tpu_torch.serve import serve
    from keystone_tpu_torch.tools import workloads as zoo
    from keystone_tpu_torch.utils import guard
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.workflow.dataset import Dataset

    dev = resolve_device(device)
    if fitted is None:
        fitted = build_pipeline(dim=dim, classes=classes, seed=seed, device=dev).fit()
    if item_shape is None:
        item_shape = (int(dim),)
    item_shape = tuple(item_shape)
    if payload is None:
        payload = np.random.default_rng(seed).normal(size=(max(256, 4 * max_batch),) + item_shape).astype(np.float32)
    payload = np.asarray(payload)
    example = np.zeros(item_shape, payload.dtype)

    # ---- forward: the static freeze against the planned one, interleaved
    planner.clear_plan()
    frozen_static = fitted.freeze(device=dev)
    t0 = time.perf_counter()
    plan = planner.build_plan(fitted, example=payload[: 2 * max_batch], max_batch=max_batch, seed=seed, device=dev)
    plan_seconds = time.perf_counter() - t0
    frozen_planned = fitted.freeze(device=dev, plan=plan)  # installs the plan
    rows = min(len(payload), 4 * max_batch)
    batch = torch.as_tensor(payload[:rows]).to(dev)
    best = {"static": None, "planned": None}

    def enter(arm):
        # the static arm runs with the plan cleared, the planned arm with
        # it installed
        if arm == "planned":
            planner.install_plan(plan, source="serve")
        else:
            planner.clear_plan()

    arms = (("static", frozen_static), ("planned", frozen_planned))
    for arm, frozen in arms:  # warm-up: first-use costs
        enter(arm)
        frozen(Dataset(batch))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for _ in range(max(1, int(rounds)) * 4):
        for arm, frozen in arms:
            enter(arm)
            t0 = time.perf_counter()
            out = frozen(Dataset(batch))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            del out
            best[arm] = dt if best[arm] is None else min(best[arm], dt)
    static_ips, planned_ips = rows / best["static"], rows / best["planned"]
    forward = {"static_ips": static_ips, "planned_ips": planned_ips, "speedup": planned_ips / static_ips}

    # ---- serve: the same open loop; the planned arm leaves every knob
    # unset so that the plan's values resolve, the static arm clears it
    def serve_arm(planned: bool) -> dict:
        enter("planned" if planned else "static")
        svc = serve(fitted, max_batch=max_batch, queue_bound=queue_bound, deadline_ms=deadline_ms,
                    example=example, name="plan_ab", devices=[dev], recorder=False)
        try:
            return run_bench(svc, item_shape, qps=qps, duration=duration, deadline_ms=deadline_ms,
                             payload=payload)
        finally:
            svc.close()

    samples: dict = {"static": [], "planned": []}
    for rnd in range(max(1, int(rounds))):
        for arm in (("static", "planned") if rnd % 2 == 0 else ("planned", "static")):
            samples[arm].append(serve_arm(arm == "planned"))
    keys = ("achieved_qps", "p50_ms", "p99_ms", "completed", "mean_batch_occupancy")
    serve_ab = {arm: [{k: r.get(k) for k in keys} for r in runs] for arm, runs in samples.items()}

    def med(arm):
        vals = sorted(r["achieved_qps"] for r in samples[arm] if r.get("achieved_qps"))
        return vals[len(vals) // 2] if vals else None

    serve_ab["speedup"] = med("planned") / med("static") if med("planned") and med("static") else None

    # ---- drift: a live PlanTuner under the zoo's drift scenario; every
    # retune bakes, so the check is "p99 improved or the retune
    # reverted", with no future lost
    planner.install_plan(plan, source="serve")
    svc = serve(fitted, max_batch=max_batch, queue_bound=queue_bound, deadline_ms=deadline_ms, example=example,
                name="plan_drift", devices=[dev], recorder=False)
    tuner = planner.PlanTuner(svc, plan=plan, interval_s=0.2, bake_s=0.6, cooldown_s=0.5)
    # the scenario's own rows are not offered (the payload bank's are, with
    # each event's drift): a small dim keeps its generator cheap
    scenario = zoo.make_scenario("drift", seed=seed, duration_s=drift_duration, qps=drift_qps, dim=1)
    lock = threading.Lock()
    lat: list = []
    counts = {"completed": 0, "lost": 0, "shed": 0, "rejected": 0}
    deadline_s = float(deadline_ms) / 1000.0
    cursor = [0]

    def record(fut, t0):
        t1 = time.monotonic()
        exc = fut.exception()
        with lock:
            if exc is None:
                counts["completed"] += 1
                lat.append((t0, t1 - t0))
            elif isinstance(exc, guard.DeadlineExceeded):
                counts["shed"] += 1
            else:
                counts["lost"] += 1

    def submit(event, _rows):
        n = int(event["rows"])
        rows_ = _drifted(payload, event, n, cursor[0])
        cursor[0] += n
        t0 = time.monotonic()
        try:
            fs = svc.submit_many(list(rows_), deadline=deadline_s)
        except Exception:
            with lock:
                counts["rejected"] += n
            return 0
        for f in fs:
            f.add_done_callback(lambda fut, t0=t0: record(fut, t0))
        return len(fs)

    from keystone_tpu_torch.obs import metrics

    walks0 = metrics.REGISTRY.counter_total("serve.retuned_bucket_walks")
    tuner.start()
    t_start = time.monotonic()
    try:
        zoo.play(scenario, submit, time_scale=1.0)
        time.sleep(max(0.5, 2 * tuner.bake_s))  # let a pending bake land
    finally:
        tuner.stop()
        svc.close()
    walks = metrics.REGISTRY.counter_total("serve.retuned_bucket_walks") - walks0

    def p99(samples_):
        if not samples_:
            return None
        vals = sorted(v for _, v in samples_)
        return vals[min(len(vals) - 1, int(0.99 * len(vals)))] * 1000.0

    mid = t_start + drift_duration / 2.0
    status = tuner.status()
    drift = {
        "outcomes": counts,
        "lost_futures": counts["lost"],
        "p99_ms_first_half": p99([v for v in lat if v[0] < mid]),
        "p99_ms_second_half": p99([v for v in lat if v[0] >= mid]),
        "retunes": status.get("retunes"),
        "commits": status.get("commits"),
        "reverts": status.get("reverts"),
        "last_action": status.get("last_action"),
        "retuned_bucket_walks": walks,
    }
    planner.clear_plan()
    return {
        "plan": {"fingerprint": plan.fingerprint(), "backend": plan.backend, "seconds": plan_seconds,
                 "stages": {st.gate: st.winner for st in plan.stages}, "knobs": plan.knobs},
        "forward": forward,
        "serve": serve_ab,
        "drift_retune": drift,
        "speedup": forward["speedup"],
        "serve_speedup": serve_ab["speedup"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--qps", type=float, default=500.0)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--burst", type=int, default=1)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--queue-bound", type=int, default=128)
    ap.add_argument("--deadline-ms", type=float, default=250.0)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--batch-delay-ms", type=float, default=0.0)
    ap.add_argument("--model", default=None)
    ap.add_argument("--workers", type=int, default=0,
                    help="a process fleet of this many workers in place of the threaded fleet")
    ap.add_argument("--ingress-ab", action="store_true",
                    help="the front-end A/B (HTTP JSON against binary batches) in place of the open loop")
    ap.add_argument("--rounds", type=int, default=2, help="--ingress-ab's and --tenants' measured rounds")
    ap.add_argument("--shards", type=int, default=2, help="--ingress-ab's ingress loops")
    ap.add_argument("--tenants", type=int, default=0,
                    help="the multi-tenant A/B in place of the open loop: this many tenants over one shared "
                         "featurization prefix, the shared stage pool on against off, per tenant, at --dim")
    ap.add_argument("--tenant-branches", type=int, default=6, help="--tenants' featurization branches")
    ap.add_argument("--plan-ab", action="store_true",
                    help="the physical planner's A/B in place of the open loop: planned against static, forward and "
                         "open loop, then a live PlanTuner under the zoo's drift scenario")
    args = ap.parse_args(argv)
    if args.plan_ab:
        print(json.dumps(run_plan_ab(dim=args.dim, classes=args.classes, max_batch=args.max_batch, qps=args.qps,
                                     duration=args.duration, rounds=args.rounds, deadline_ms=args.deadline_ms,
                                     queue_bound=args.queue_bound, drift_duration=max(1.0, args.duration),
                                     device=args.device), default=str))
        return 0
    if args.tenants:
        print(json.dumps(run_tenants_ab(qps=args.qps, duration=args.duration, rounds=args.rounds,
                                        tenants=args.tenants, branches=args.tenant_branches,
                                        max_batch=args.max_batch, deadline_ms=args.deadline_ms, dim=args.dim,
                                        device=args.device)))
        return 0
    if args.ingress_ab:
        print(json.dumps(run_ingress_ab(duration=args.duration, rounds=args.rounds, dim=args.dim,
                                        max_batch=args.max_batch, shards=args.shards, device=args.device,
                                        workers=args.workers)))
        return 0
    svc, item_shape = build_service(dim=args.dim, classes=args.classes, max_batch=args.max_batch,
                                    max_wait_ms=args.max_wait_ms, queue_bound=args.queue_bound,
                                    deadline_ms=args.deadline_ms, model=args.model, replicas=args.replicas,
                                    device=args.device, workers=args.workers)
    try:
        rep = run_bench(svc, item_shape, qps=args.qps, duration=args.duration, burst=args.burst,
                        deadline_ms=args.deadline_ms, batch_delay_ms=args.batch_delay_ms)
    finally:
        svc.close()
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
