"""Open-loop load generator for the serving path (counterpart of
``tools/serve_bench.py``: every mode of its ``main``, with its report
keys and pass conditions).

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
``--dim``-vector.  ``--swap-mid-run`` hot-swaps a second model in at the
offer window's midpoint, ``--no-recorder`` turns the flight recorder
off, ``--straggler-ms``/``--straggler-replica`` stall one replica and
``--hedge-ms`` hedges around it.  ``--workers N`` serves with a process
fleet of N workers (each with the model on ``--device``) in place of the
threaded fleet.  The other modes, each in place of the open loop:

- ``--tenants N``: N tenants over one featurization prefix behind
  ``serve_multi``, the shared stage pool on against off, per tenant;
- ``--ingress-ab``: one service behind one binary ingress port,
  saturated in turns by per-datum HTTP JSON clients and by whole-batch
  binary clients; ``ok`` (exit 0) when the answers agree bit for bit and
  binary takes at least 3x HTTP's per-datum rate;
- ``--procs-ab``: threads against worker processes on a GIL-held
  featurizer (``tools/gilburn.py``); ``ok`` when the answers agree and
  processes reach 1.8x threads (0.7x on one core);
- ``--autoscale-scenario``: a one-worker process fleet scales up under
  open-loop load and back to one when idle; ``ok`` when nothing failed or
  hung and it went both ways;
- ``--cold-start``: first prediction and restart-to-rejoin, each arm
  (the registry's bucket-graph bundle installed, or none) in a fresh
  subprocess (``--cold-start-arm``/``--restart-arm``);
- ``--scenario NAME``: a replay of the workload zoo
  (``tools/workloads.py``) with its digest;
- ``--plan-ab``: the physical planner's A/B (planned against static, on
  the forward and the open loop, then a live ``PlanTuner`` under the
  zoo's ``drift`` scenario).

The report is one JSON object on stdout.

    python -m keystone_tpu_torch.tools.serve_bench --device cpu --workers 2 --ingress-ab --duration 1
    python -m keystone_tpu_torch.tools.serve_bench --device cpu --procs-ab --duration 1 --ab-rounds 1
    python -m keystone_tpu_torch.tools.serve_bench --device cpu --cold-start --ab-rounds 1
    python -m keystone_tpu_torch.tools.serve_bench --device cpu --scenario bursty --duration 1
    python -m keystone_tpu_torch.tools.serve_bench --device cpu --plan-ab --duration 1 --ab-rounds 2
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import wait as futures_wait

import numpy as np
import torch

from keystone_tpu_torch.workflow.transformer import Transformer

#: the rollout drill's poison marker: a row whose first element is this
MARK = 123.0
#: the reference's pass conditions: binary ingress over HTTP JSON, and
#: processes over threads on the GIL-held featurizer (on one core, the
#: process fleet's floor against the threads)
INGRESS_MIN_SPEEDUP = 3.0
PROCS_MIN_SPEEDUP = 1.8
PROCS_ONE_CORE_FLOOR = 0.7


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


def build_aot_pipeline(dim: int = 64, classes: int = 16, seed: int = 0, branches: int = 8, device="cuda"):
    """The cold-start and restart A/Bs' workload: a ``branches``-way
    gather of FFT chains (:func:`_fft_gather_feat`) feeding a normalized
    linear head, its weights the reference's seeded draw.  A gather, not
    the two-stage chain: each branch is a walk of its own at prime, which
    is what a bucket graph replaces."""
    from keystone_tpu_torch.models.linear import LinearMapper
    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    feat, feat_dim = _fft_gather_feat(dim, branches, seed, device=dev)
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(feat_dim, classes)).astype(np.float32)).to(dev)
    return feat | NormalizeRows() | LinearMapper(w)


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


def _alternating(arms: dict, rounds: int, leg) -> dict:
    """The reference's A/B discipline: ``max(2, rounds)`` measured rounds
    after a discarded warm-up round of 0.5 s legs, the arms' order
    alternating a round; ``leg(arm_value, warm)`` runs one leg and
    returns its report.  Returns each arm's measured reports."""
    samples: dict = {a: [] for a in arms}
    names = list(arms)
    for rnd in range(max(2, int(rounds)) + 1):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            rep = leg(arms[name], rnd == 0)
            if rnd > 0:  # round 0 warms up
                samples[name].append(rep)
    return samples


def _median(reports: list, key: str):
    vals = [r[key] for r in reports if r.get(key) is not None]
    return float(statistics.median(vals)) if vals else None


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
    try:
        for t in services["shared"][1]:
            a = services["shared"][0].submit(payload[0], tenant=t).result(60.0)
            b = services["unshared"][0].submit(payload[0], tenant=t).result(60.0)
            identical = identical and np.array_equal(a, b)
        samples = _alternating(services, rounds, lambda arm, warm: run_tenants_bench(
            arm[0], arm[1], qps=qps, duration=0.5 if warm else duration, payload=payload, deadline_ms=deadline_ms))
    finally:
        for svc, _ in services.values():
            svc.close()
    shared_qps, unshared_qps = _median(samples["shared"], "aggregate_qps"), _median(samples["unshared"], "aggregate_qps")
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
        "fairness_p99_ratio": _median(samples["shared"], "fairness_p99_ratio"),
        "predictions_identical": bool(identical),
        "pool": samples["shared"][-1]["pool"] if samples["shared"] else {},
        "per_tenant_shared": samples["shared"][-1]["per_tenant"] if samples["shared"] else {},
    }


def run_overhead_pair(qps: float = 300.0, duration: float = 2.0, rounds: int = 4, max_batch: int = 16,
                      deadline_ms: float = 500.0, batch_delay_ms: float = 2.0, dim: int = 64,
                      device="cuda") -> dict:
    """The flight recorder's cost: the same open loop against two
    services in one process, the recorder on and off, in alternating
    rounds after a warm-up, at an operating point below saturation
    (``batch_delay_ms`` stalls each flush).  The per-arm medians and the
    on/off ratios of achieved QPS and p99 (the reference's budget: within
    5% of 1)."""
    services = {}
    try:
        for mode, rec in (("on", True), ("off", False)):
            services[mode] = build_service(dim=dim, max_batch=max_batch, queue_bound=128, deadline_ms=deadline_ms,
                                           recorder=rec, device=device)
        samples = _alternating(services, rounds, lambda arm, warm: run_bench(
            arm[0], arm[1], qps=qps, duration=0.5 if warm else duration, deadline_ms=deadline_ms,
            batch_delay_ms=batch_delay_ms))
    finally:
        for svc, _ in services.values():
            svc.close()
    out = {"offered_qps": qps, "duration_s": duration, "rounds": len(samples["on"]), "batch_delay_ms": batch_delay_ms,
           "device": str(device)}
    for mode in ("on", "off"):
        out[f"recorder_{mode}"] = {k: _median(samples[mode], k) for k in ("achieved_qps", "p50_ms", "p95_ms", "p99_ms")}
    ratios = {}
    for key, name in (("achieved_qps", "achieved_qps_ratio"), ("p99_ms", "p99_ratio")):
        on, off = out["recorder_on"][key], out["recorder_off"][key]
        if on and off:
            ratios[name] = on / off
    out["overhead"] = ratios
    return out


def run_straggler_ab(qps: float = 300.0, duration: float = 2.0, rounds: int = 4, replicas: int = 2,
                     max_batch: int = 16, deadline_ms: float = 2000.0, straggler_ms: float = 40.0,
                     hedge_ms: float = 10.0, dim: int = 64, device="cuda") -> dict:
    """Hedged dispatch against one stalled replica: every flush replica 0
    takes stalls ``straggler_ms`` before it is claimed (the
    ``serve.worker`` plan of :func:`run_bench`), on two fleets of
    ``replicas`` threads in one process, hedging on and off, in
    alternating rounds after a warm-up.  The supervisor is off: the stall
    is injected, not a wedge to heal.  Reports the per-arm medians, the
    hedges and their wins, ``p99_ratio`` (hedged over unhedged, the
    reference wants it below 1) and ``qps_cost`` (1 − hedged/unhedged
    QPS, the reference's budget 0.05)."""
    services = {}
    try:
        for mode, hedge in (("hedged", hedge_ms), ("unhedged", None)):
            services[mode] = build_service(dim=dim, max_batch=max_batch, queue_bound=256, deadline_ms=deadline_ms,
                                           replicas=replicas, hedge_ms=hedge, supervise=False, device=device)
        samples = _alternating(services, rounds, lambda arm, warm: run_bench(
            arm[0], arm[1], qps=qps, duration=0.5 if warm else duration, deadline_ms=deadline_ms,
            straggler_ms=straggler_ms))
    finally:
        for svc, _ in services.values():
            svc.close()
    out = {"offered_qps": qps, "duration_s": duration, "rounds": len(samples["hedged"]), "replicas": replicas,
           "straggler_ms": straggler_ms, "hedge_ms": hedge_ms, "device": str(device)}
    for mode in ("hedged", "unhedged"):
        out[mode] = {k: _median(samples[mode], k) for k in ("achieved_qps", "p50_ms", "p95_ms", "p99_ms", "max_ms")}
    out["hedged"]["hedges"] = sum(r["hedges"] for r in samples["hedged"])
    out["hedged"]["hedge_wins"] = sum(r["hedge_wins"] for r in samples["hedged"])
    hedging = {}
    on_p99, off_p99 = out["hedged"]["p99_ms"], out["unhedged"]["p99_ms"]
    if on_p99 and off_p99:
        hedging["p99_ratio"] = on_p99 / off_p99
    on_q, off_q = out["hedged"]["achieved_qps"], out["unhedged"]["achieved_qps"]
    if on_q and off_q:
        hedging["qps_cost"] = 1.0 - on_q / off_q
    out["hedging"] = hedging
    return out


def build_gil_pipeline(dim: int = 64, classes: int = 16, burn_rounds: int = 300, seed: int = 0, device="cuda"):
    """The compute-bound workload of the threads-against-processes A/B:
    :class:`~keystone_tpu_torch.tools.gilburn.GilBurnFeature` (CRC32
    chains in the interpreter, the GIL held) feeding the two-stage head,
    its weights the reference's seeded draw.  Bit-deterministic, so both
    fleets must answer the same bytes."""
    from keystone_tpu_torch.models.linear import LinearMapper
    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.tools.gilburn import GilBurnFeature
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(dim, classes)).astype(np.float32)).to(resolve_device(device))
    return Pipeline.of(GilBurnFeature(rounds=burn_rounds)) | NormalizeRows() | LinearMapper(w)


def build_gil_service(mode: str, workers: int = 2, dim: int = 64, burn_rounds: int = 300, max_batch: int = 16,
                      queue_bound: int = 512, max_wait_ms: float = 2.0, seed: int = 0, device="cuda", **serve_kw):
    """A primed service over the GIL-bound pipeline: ``mode="thread"``
    is ``replicas=workers`` worker threads on ``device``,
    ``mode="process"`` ``workers=workers`` worker processes, each with
    the model on ``device`` (the router keeps it on the host).  The
    recorder is off in both arms.  Returns ``(service, item_shape)``."""
    from keystone_tpu_torch.serve import serve
    from keystone_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if mode == "process":
        pipe = build_gil_pipeline(dim=dim, burn_rounds=burn_rounds, seed=seed, device="cpu")
        fleet = dict(workers=int(workers), worker_opts={"device": str(dev), **serve_kw.pop("worker_opts", {})})
    else:
        pipe = build_gil_pipeline(dim=dim, burn_rounds=burn_rounds, seed=seed, device=dev)
        fleet = dict(replicas=int(workers), devices=[dev] * int(workers))
    svc = serve(pipe, max_batch=max_batch, max_wait_ms=max_wait_ms, queue_bound=queue_bound, deadline_ms=None,
                example=np.zeros((dim,), np.float32), name=f"procs_{mode}", recorder=False, **fleet, **serve_kw)
    return svc, (int(dim),)


def _prediction_sha(y) -> str:
    """The full-array digest (shape, dtype, bytes) every parity claim here
    compares."""
    from keystone_tpu_torch.utils.hashing import array_fingerprint

    return array_fingerprint(np.asarray(y))


def run_procs_ab(qps: float = 2500.0, duration: float = 2.5, rounds: int = 3, workers: int = 2, dim: int = 64,
                 burn_rounds: int = 2000, max_batch: int = 16, device="cuda") -> dict:
    """Threads against processes on the compute-bound workload: the same
    open loop (offered above capacity, so achieved QPS is capacity)
    against ``replicas=workers`` threads and ``workers=workers``
    processes, in alternating rounds after a warm-up, and a bit-identity
    probe first (24 rows, one at a time, through both fleets).

    Processes beat threads only where there are cores: the report carries
    ``cores`` (this process's affinity mask) and ``achievable_speedup =
    min(workers, cores)``.  ``ok`` (the reference's): the probe agreed and
    the speedup is at least 1.8 on two or more cores, at least 0.7 (the
    wire's overhead bound) on one."""
    cores = len(os.sched_getaffinity(0))
    services = {}
    try:
        # built and probed inside the try: a failed spawn still closes (and
        # reaps the workers of) what was built
        for mode in ("thread", "process"):
            services[mode] = build_gil_service(mode, workers=workers, dim=dim, burn_rounds=burn_rounds,
                                               max_batch=max_batch, queue_bound=512, device=device)
        probe = np.random.default_rng(11).normal(size=(24, dim)).astype(np.float32)
        digests = {mode: _prediction_sha(np.stack([np.asarray(svc.submit(row).result(timeout=60.0)) for row in probe]))
                   for mode, (svc, _) in services.items()}
        identical = digests["thread"] == digests["process"]
        samples = _alternating(services, rounds, lambda arm, warm: run_bench(
            arm[0], arm[1], qps=qps, duration=0.5 if warm else duration, deadline_ms=None))
    finally:
        for svc, _ in services.values():
            svc.close()
    t_qps, p_qps = _median(samples["thread"], "achieved_qps"), _median(samples["process"], "achieved_qps")
    speedup = p_qps / t_qps if t_qps and p_qps else None
    floor = PROCS_MIN_SPEEDUP if cores >= 2 else PROCS_ONE_CORE_FLOOR
    return {
        "offered_qps": qps,
        "duration_s": duration,
        "rounds": len(samples["thread"]),
        "workers": workers,
        "cores": cores,
        "burn_rounds": burn_rounds,
        "device": str(device),
        "thread_qps": t_qps,
        "process_qps": p_qps,
        "thread_p99_ms": _median(samples["thread"], "p99_ms"),
        "process_p99_ms": _median(samples["process"], "p99_ms"),
        "speedup": speedup,
        "achievable_speedup": min(int(workers), cores),
        "cores_limited": cores < int(workers),
        "predictions_identical": bool(identical),
        "prediction_sha": digests,
        "ok": bool(identical) and speedup is not None and speedup >= floor,
        "note": ("compute-bound (GIL-held featurizer) A/B: threads measure the GIL, processes measure cores; "
                 "the featurizer runs on the host in both arms, the head on the device"),
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
        # a closed loop has no tail past the stop: its offer window is its
        # wall window, reported under both names as the open loops do
        "per_datum_qps_wall": counts["completed"] / elapsed if elapsed > 0 else None,
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
    speedup = bin_qps / http_qps if http_qps and bin_qps else None
    return {
        "mode": "closed-loop saturation", "duration_s": duration, "rounds": len(samples["http"]), "shards": shards,
        "bin_batch": int(probe.shape[0]),
        "http": {"clients": http_clients, "per_datum_qps": http_qps,
                 "per_datum_qps_wall": med("http", "per_datum_qps_wall"), "p50_ms": med("http", "p50_ms"),
                 "p99_ms": med("http", "p99_ms"), "errors": sum(r["errors"] for r in samples["http"]),
                 "runs_qps": [r["per_datum_qps"] for r in samples["http"]]},
        "binary": {"clients": bin_clients, "per_datum_qps": bin_qps,
                   "per_datum_qps_wall": med("binary", "per_datum_qps_wall"), "frame_p50_ms": med("binary", "p50_ms"),
                   "frame_p99_ms": med("binary", "p99_ms"), "errors": sum(r["errors"] for r in samples["binary"]),
                   "runs_qps": [r["per_datum_qps"] for r in samples["binary"]]},
        "speedup": speedup,
        "predictions_identical": identical,
        "preformed_flushes": preformed,
        "bytes_copied": bytes_copied,
        # the reference's pass condition: binary batches take at least 3x
        # HTTP JSON's per-datum rate, the answers bit for bit
        "ok": bool(identical) and speedup is not None and speedup >= INGRESS_MIN_SPEEDUP,
    }


def run_autoscale_scenario(qps: float = 2000.0, duration: float = 4.0, idle_timeout: float = 60.0,
                           max_workers: int = 3, dim: int = 64, burn_rounds: int = 2000, device="cuda") -> dict:
    """The autoscaler's scenario: a one-worker process fleet on the
    GIL-bound pipeline under ``duration`` seconds of open-loop load must
    scale up, then, the load gone, back down to one within
    ``idle_timeout`` seconds, every request answered (the queue bound is
    far above the offered load, so nothing is shed).  ``ok`` (the
    reference's): no error, nothing hung, a peak above one and a final
    fleet of one."""
    from concurrent.futures import TimeoutError as FutureTimeout

    from keystone_tpu_torch.serve import serve
    from keystone_tpu_torch.utils.device import resolve_device

    pipe = build_gil_pipeline(dim=dim, burn_rounds=burn_rounds, device="cpu")
    svc = serve(
        pipe, max_batch=16, max_wait_ms=2.0, queue_bound=100_000, deadline_ms=None,
        example=np.zeros((dim,), np.float32), name="procs_autoscale", recorder=False, workers=1,
        worker_opts={"device": str(resolve_device(device))},
        autoscale=dict(
            min_workers=1, max_workers=int(max_workers), interval_s=0.4,
            up_queue_frac=0.002,  # the queue bound is huge: react to depth
            up_cooldown_s=1.0, down_ticks=4, down_cooldown_s=3.0,
            # down on an empty queue and a calm burn: the occupancy window
            # decays too slowly for a scenario of seconds to gate on it
            down_occupancy=0.95,
        ),
    )
    peak, track, futs = 1, [], []
    payload = np.random.default_rng(5).normal(size=(64, dim)).astype(np.float32)
    try:
        t0 = time.monotonic()
        next_t, i = t0, 0
        while time.monotonic() - t0 < duration:
            now = time.monotonic()
            if now < next_t:
                time.sleep(min(next_t - now, 0.002))
                continue
            futs.append(svc.submit(payload[i % len(payload)]))
            i += 1
            next_t += 1.0 / qps
            if i % 50 == 0:
                track.append(svc.replicas)
                peak = max(peak, svc.replicas)
        completed = errors = hung = 0
        for f in futs:  # every admitted request must complete
            try:
                f.result(timeout=180.0)
                completed += 1
            except FutureTimeout:
                hung += 1
            except Exception:
                errors += 1
        peak = max(peak, svc.replicas)
        deadline = time.monotonic() + idle_timeout
        final = svc.replicas
        while final > 1 and time.monotonic() < deadline:  # idle: back to the floor
            time.sleep(0.5)
            final = svc.replicas
        scaler = svc.autoscaler.status() if svc.autoscaler else {}
    finally:
        svc.close()
    return {
        "offered_qps": qps,
        "duration_s": duration,
        "device": str(device),
        "submitted": len(futs),
        "completed": completed,
        "errors": errors,
        "hung": hung,
        "peak_workers": peak,
        "final_workers": final,
        "workers_track": track[-20:],
        "scaled_up": peak > 1,
        "scaled_down": final == 1,
        "autoscaler": scaler,
        "ok": errors == 0 and hung == 0 and peak > 1 and final == 1,
    }


def publish_bench_registry(root: str, dim: int = 64, classes: int = 16, max_batch: int = 32, seed: int = 0,
                           builder=None, device="cuda") -> str:
    """Publish an A/B's workload (``builder``, default
    :func:`build_pipeline`) into a fresh registry at ``root`` and return
    its version.  On a CUDA device the version carries its artifact
    bundle (one bucket graph a padding bucket); a bundle needs the card,
    so on the CPU the version has none and both arms walk."""
    from keystone_tpu_torch.serve import ModelRegistry
    from keystone_tpu_torch.serve.service import default_buckets
    from keystone_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    fitted = (builder or build_pipeline)(dim=dim, classes=classes, seed=seed, device=dev).fit()
    bundle = None
    if dev.type == "cuda":
        bundle = fitted.freeze(device=dev).export_artifacts(example=np.zeros((dim,), np.float32),
                                                            buckets=default_buckets(max_batch))
    return ModelRegistry(root).publish(fitted, artifacts=bundle)


def _prime_counts() -> dict:
    from keystone_tpu_torch.obs import metrics

    return {src: int((metrics.REGISTRY.histogram_value("serve.prime_seconds", source=src) or {}).get("count") or 0)
            for src in ("artifact", "compile")}


def _counters(*names) -> dict:
    from keystone_tpu_torch.obs import metrics

    return {n: metrics.REGISTRY.counter_total(n) for n in names}


def _request_row(seed: int, item_shape, dtype) -> np.ndarray:
    """One seeded request of ``item_shape``: normal draws, or for an
    integer dtype (images) pixels spread over 0..255."""
    x = np.random.default_rng(seed).normal(size=tuple(item_shape))
    if np.issubdtype(np.dtype(dtype), np.integer):
        return np.clip(x * 64.0 + 128.0, 0, 255).astype(dtype)
    return x.astype(dtype)


def run_cold_start(arm: str, registry_root: str, dim: int = 64, max_batch: int = 32, device="cuda",
                   item_shape=None, dtype=np.float32) -> dict:
    """One sample of registry load → service ready (every bucket primed)
    → first prediction, in this process (the A/B runs each sample in a
    fresh subprocess).  ``arm="artifact"`` installs the version's bucket
    graphs (captured at prime), ``"compile"`` ignores them (every bucket
    walked at prime).  ``item_shape``/``dtype``: the request's (default
    a ``dim``-vector of f32)."""
    from keystone_tpu_torch.serve import ModelRegistry, serve
    from keystone_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    item_shape = tuple(item_shape or (int(dim),))
    reg = ModelRegistry(registry_root)
    c0, p0 = _counters("serve.artifact_hits", "serve.artifact_fallbacks"), _prime_counts()
    t0 = time.perf_counter()
    fitted, version = reg.load(map_location=dev)
    t_load = time.perf_counter() - t0
    arts = reg.load_artifacts(version) if arm == "artifact" else None
    svc = serve(fitted, max_batch=max_batch, deadline_ms=None, example=np.zeros(item_shape, dtype),
                name="coldstart", supervise=False, artifacts=arts, devices=[dev])
    try:
        t_ready = time.perf_counter() - t0
        y = np.asarray(svc.submit(_request_row(7, item_shape, dtype)).result(timeout=120.0))
        t_first = time.perf_counter() - t0
    finally:
        svc.close()
    c1, p1 = _counters("serve.artifact_hits", "serve.artifact_fallbacks"), _prime_counts()
    return {
        "arm": arm,
        "version": version,
        "bundle": arts is not None,
        "model_load_s": t_load,
        "ready_s": t_ready,
        "first_prediction_s": t_first,
        "prime_sources": {src: p1[src] - p0[src] for src in p0},
        "artifact_hits": int(c1["serve.artifact_hits"] - c0["serve.artifact_hits"]),
        "artifact_fallbacks": int(c1["serve.artifact_fallbacks"] - c0["serve.artifact_fallbacks"]),
        "prediction_sha": _prediction_sha(y),
        "prediction_head": [float(v) for v in y.ravel()[:4]],
    }


def run_restart(arm: str, registry_root: str, dim: int = 64, max_batch: int = 32, replicas: int = 2,
                timeout_s: float = 60.0, device="cuda", item_shape=None, dtype=np.float32) -> dict:
    """One restart-to-rejoin sample: the registry's model on a fleet of
    ``replicas`` threads, replica 0's worker crashed once by an injected
    ``serve.worker`` fault under light load, and the seconds the
    supervisor's heal (copy, prime, adopt) took.  ``arm="artifact"``: the
    replacement captures its bucket graphs from the bundle; ``"compile"``:
    it walks every bucket."""
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.serve import ModelRegistry, serve
    from keystone_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    item_shape = tuple(item_shape or (int(dim),))
    reg = ModelRegistry(registry_root)
    fitted, version = reg.load(map_location=dev)
    arts = reg.load_artifacts(version) if arm == "artifact" else None
    svc = serve(fitted, max_batch=max_batch, deadline_ms=None, example=np.zeros(item_shape, dtype),
                name="restart_bench", replicas=replicas, devices=[dev] * replicas, supervise=True,
                supervise_interval_s=0.05, heartbeat_s=30.0, artifacts=arts)
    payload = _request_row(11, item_shape, dtype)
    try:
        for _ in range(4):  # both replicas warm with real traffic first
            svc.submit(payload).result(timeout=60.0)
        with faults.inject("serve.worker:ctx.replica=0:raise:times=1"):
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                try:
                    svc.submit(payload).result(timeout=10.0)
                except Exception:
                    pass  # the crashed flush's riders fail typed
                if svc.supervisor.restarts_total >= 1:
                    break
                time.sleep(0.01)
        last = svc.supervisor.last_restart
        y = np.asarray(svc.submit(payload).result(timeout=30.0))  # the healed fleet answers
    finally:
        svc.close()
    if not last:
        raise RuntimeError("the supervisor never restarted the crashed replica")
    return {
        "arm": arm,
        "bundle": arts is not None,
        "restart_to_rejoin_s": last["seconds"],
        "reason": last["reason"],
        "restarts": svc.supervisor.restarts_total,
        "prediction_sha": _prediction_sha(y),
        "prediction_head": [float(v) for v in y.ravel()[:4]],
    }


def _artifact_arm_subprocess(flag: str, arm: str, root: str, dim: int, max_batch: int, device="cuda",
                             item_shape=None, dtype=np.float32) -> dict:
    """One arm's sample in a fresh process (no kernel library loaded, no
    allocator warm), which serves exactly what the driver published: the
    geometry is passed on.  Both arms load the kernels the driver's
    process already built (one ``_build`` directory), so neither pays the
    compiler."""
    cmd = [sys.executable, "-m", "keystone_tpu_torch.tools.serve_bench", flag, arm, "--registry", root,
           "--dim", str(int(dim)), "--max-batch", str(int(max_batch)), "--device", str(device)]
    if item_shape is not None:
        cmd += ["--example-shape", ",".join(str(int(d)) for d in item_shape), "--dtype", np.dtype(dtype).name]
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (pkg_root, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"{flag} {arm} arm failed: {proc.stderr[-800:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _ab_summary(samples: dict, key: str) -> dict:
    out = {arm: _median(samples[arm], key) for arm in ("artifact", "compile")}
    if out["artifact"] and out["compile"]:
        out["speedup"] = out["compile"] / out["artifact"]
    return out


def _run_artifact_ab(flag: str, summary_keys, dim: int, max_batch: int, rounds: int, registry_root, device="cuda",
                     publish: bool = True, item_shape=None, dtype=np.float32) -> dict:
    """The shared A/B harness: publish one registry version of
    :func:`build_aot_pipeline` (unless ``publish=False``: serve the
    registry's current version), run each arm ``rounds`` times in
    order-alternated fresh subprocesses, and report per-arm medians, the
    speed-ups and the parity claim (every sample's full prediction digest
    equal across arms).  Removes a registry it made."""
    import shutil
    import tempfile

    created = registry_root is None
    root = registry_root or tempfile.mkdtemp(prefix="keystone-artifact-ab-")
    try:
        if publish:
            publish_bench_registry(root, dim=dim, max_batch=max_batch, builder=build_aot_pipeline, device=device)
        samples: dict = {"artifact": [], "compile": []}
        for rnd in range(max(1, int(rounds))):
            for arm in (("artifact", "compile") if rnd % 2 == 0 else ("compile", "artifact")):
                samples[arm].append(_artifact_arm_subprocess(flag, arm, root, dim, max_batch, device=device,
                                                             item_shape=item_shape, dtype=dtype))
        out = {"rounds": rounds, "dim": dim, "max_batch": max_batch, "device": str(device),
               "item_shape": list(item_shape or (int(dim),))}
        for key in summary_keys:
            out[key] = _ab_summary(samples, key)
        out["predictions_match"] = len({s.get("prediction_sha") for arm in samples.values() for s in arm}) == 1
        out["artifact_fallbacks"] = sum(s.get("artifact_fallbacks", 0) for arm in samples.values() for s in arm)
        out["samples"] = samples
        out["note"] = ("artifact: the version's bucket graphs installed and captured at prime; compile: no bundle, "
                       "every bucket walked at prime; both arms load the kernels already built in _build "
                       "(no compiler in either sample); a bundle needs a CUDA device, so on the CPU both arms walk")
        return out
    finally:
        if created:
            shutil.rmtree(root, ignore_errors=True)


def run_cold_start_ab(dim: int = 64, max_batch: int = 32, rounds: int = 2, registry_root=None, device="cuda",
                      publish: bool = True, item_shape=None, dtype=np.float32) -> dict:
    """The cold-start A/B: the median load → ready → first-prediction
    timeline of each arm, the bucket graphs' speed-up and the full-digest
    parity claim."""
    out = _run_artifact_ab("--cold-start-arm", ("first_prediction_s", "ready_s"), dim, max_batch, rounds,
                           registry_root, device=device, publish=publish, item_shape=item_shape, dtype=dtype)
    out["prime_sources"] = {arm: out["samples"][arm][0]["prime_sources"] for arm in out["samples"]}
    return out


def run_restart_ab(dim: int = 64, max_batch: int = 32, rounds: int = 2, registry_root=None, device="cuda") -> dict:
    """The supervisor's heal A/B: the same registry and injected crash,
    restart-to-rejoin with a replacement that captures its bucket graphs
    against one that walks."""
    return _run_artifact_ab("--restart-arm", ("restart_to_rejoin_s",), dim, max_batch, rounds, registry_root,
                            device=device)


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


def run_scenario(name: str, seed: int = 0, duration: float = 3.0, qps: float = 200.0, dim: int = 64,
                 max_batch: int = 32, max_wait_ms: float = 2.0, queue_bound: int = 128,
                 deadline_ms: float | None = 250.0, replicas: int = 1, time_scale: float = 1.0,
                 device="cuda") -> dict:
    """Replay one seeded zoo scenario (``tools/workloads.py``) against a
    live service of the synthetic pipeline and report outcomes and
    latency percentiles.  The report carries the scenario's
    ``trace_digest``: the same name and seed replay the same traffic (the
    reference's zoo gives the same digest)."""
    from keystone_tpu_torch.serve import Overloaded
    from keystone_tpu_torch.tools import workloads as zoo
    from keystone_tpu_torch.utils import guard

    scenario = zoo.make_scenario(name, seed=seed, duration_s=duration, qps=qps, dim=dim)
    svc, _ = build_service(dim=dim, max_batch=max_batch, max_wait_ms=max_wait_ms, queue_bound=queue_bound,
                           deadline_ms=deadline_ms, replicas=replicas, device=device)
    deadline_s = None if not deadline_ms else float(deadline_ms) / 1000.0
    lock = threading.Lock()
    latencies: list = []
    outcomes = {"completed": 0, "shed": 0, "rejected": 0, "errors": 0}
    futs: list = []

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

    def submit(event, rows):
        t_submit = time.monotonic()
        try:
            fs = svc.submit_many(list(rows), deadline=deadline_s)
        except Overloaded:
            with lock:
                outcomes["rejected"] += int(rows.shape[0])
            return 0
        for f in fs:
            f.add_done_callback(lambda fut, t0=t_submit: record(fut, t0))
        with lock:
            futs.extend(fs)
        return len(fs)

    t0 = time.monotonic()
    try:
        zoo.play(scenario, submit, time_scale=time_scale)
        futures_wait(list(futs), timeout=30.0)
    finally:
        svc.close()
    wall = time.monotonic() - t0
    lat = sorted(latencies)

    def pct(p):
        return None if not lat else lat[min(len(lat) - 1, int(p * len(lat)))] * 1000.0

    return {
        "scenario": scenario.summary(),
        "device": str(device),
        "wall_seconds": wall,
        "outcomes": outcomes,
        "submitted_rows": scenario.total_rows(),
        "qps_achieved": outcomes["completed"] / wall if wall > 0 else None,
        "p50_ms": pct(0.50),
        "p99_ms": pct(0.99),
    }


def _arm_main(argv) -> int:
    """The single-arm entries the cold-start A/B spawns (one fresh process
    a sample); also usable by hand for one arm."""
    sub = argparse.ArgumentParser(prog=f"serve_bench {argv[0]}")
    sub.add_argument("arm", choices=("artifact", "compile"))
    sub.add_argument("--registry", required=True)
    sub.add_argument("--dim", type=int, default=64)
    sub.add_argument("--max-batch", type=int, default=32)
    sub.add_argument("--device", default="cuda")
    sub.add_argument("--example-shape", default=None,
                     help="the request's shape, comma-separated (default: a --dim vector)")
    sub.add_argument("--dtype", default="float32", help="the request's dtype")
    a = sub.parse_args(argv[1:])
    shape = tuple(int(d) for d in a.example_shape.split(",")) if a.example_shape else None
    fn = run_cold_start if argv[0] == "--cold-start-arm" else run_restart
    print(json.dumps(fn(a.arm, a.registry, dim=a.dim, max_batch=a.max_batch, device=a.device, item_shape=shape,
                        dtype=np.dtype(a.dtype))))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("--cold-start-arm", "--restart-arm"):
        return _arm_main(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--qps", type=float, default=500.0, help="offered load")
    ap.add_argument("--duration", type=float, default=2.0, help="seconds")
    ap.add_argument("--burst", type=int, default=1, help="arrivals a group (the same mean rate)")
    ap.add_argument("--dim", type=int, default=64, help="the request vector's length")
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--queue-bound", type=int, default=128)
    ap.add_argument("--deadline-ms", type=float, default=250.0)
    ap.add_argument("--replicas", type=int, default=1, help="the threaded fleet's size")
    ap.add_argument("--batch-delay-ms", type=float, default=0.0,
                    help="stall every flush this long through the serve.batch fault site (a heavier model)")
    ap.add_argument("--model", default=None, help="serve this saved FittedPipeline instead")
    ap.add_argument("--swap-mid-run", action="store_true",
                    help="hot-swap a second model in at the offer window's midpoint; the report gains the swap")
    ap.add_argument("--no-recorder", action="store_true", help="the flight recorder off")
    ap.add_argument("--straggler-ms", type=float, default=0.0,
                    help="stall one replica's worker this long a flush, before it is claimed (serve.worker)")
    ap.add_argument("--straggler-replica", type=int, default=0, help="the replica the straggler plan stalls")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="hedged dispatch with this floor delay (needs --replicas >= 2)")
    ap.add_argument("--workers", type=int, default=0,
                    help="a process fleet of this many workers in place of the threaded fleet; with --procs-ab "
                         "the size of both arms")
    ap.add_argument("--ab-rounds", "--rounds", dest="ab_rounds", type=int, default=2,
                    help="measured rounds (samples an arm for --cold-start)")
    ap.add_argument("--cold-start", action="store_true",
                    help="the cold-start and restart A/Bs (bucket graphs against none), each sample in a fresh "
                         "subprocess")
    ap.add_argument("--tenants", type=int, default=0,
                    help="the multi-tenant A/B: this many tenants over one shared featurization prefix, the shared "
                         "stage pool on against off, per tenant, at --dim")
    ap.add_argument("--tenant-branches", type=int, default=6, help="--tenants' featurization branches")
    ap.add_argument("--procs-ab", action="store_true",
                    help="threads against processes on the GIL-held featurizer; exit 1 unless ok")
    ap.add_argument("--autoscale-scenario", action="store_true",
                    help="a one-worker process fleet scales up under load and back down; exit 1 unless ok")
    ap.add_argument("--burn-rounds", type=int, default=2000,
                    help="CRC32 passes a row of the GIL-held featurizer (--procs-ab, --autoscale-scenario)")
    ap.add_argument("--ingress-ab", action="store_true",
                    help="HTTP JSON against binary batches on one ingress port; exit 1 unless ok")
    ap.add_argument("--ingress-shards", "--shards", dest="ingress_shards", type=int, default=2,
                    help="--ingress-ab's ingress loops")
    ap.add_argument("--http-clients", type=int, default=8, help="--ingress-ab's keep-alive HTTP clients")
    ap.add_argument("--bin-clients", type=int, default=4, help="--ingress-ab's binary batch clients")
    ap.add_argument("--scenario", default=None, metavar="NAME",
                    help="replay a seeded zoo scenario (tools/workloads.py); the report carries its digest")
    ap.add_argument("--scenario-seed", type=int, default=0, help="the zoo scenario's seed")
    ap.add_argument("--plan-ab", action="store_true",
                    help="the physical planner's A/B: planned against static, forward and open loop, then a "
                         "live PlanTuner under the zoo's drift scenario")
    args = ap.parse_args(argv)

    def report(rep, gated=False) -> int:
        print(json.dumps(rep, default=str))
        return 0 if not gated or rep.get("ok") else 1

    if args.scenario:
        return report(run_scenario(args.scenario, seed=args.scenario_seed, duration=args.duration, qps=args.qps,
                                   dim=args.dim, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                                   queue_bound=args.queue_bound, deadline_ms=args.deadline_ms,
                                   replicas=args.replicas, device=args.device))
    if args.ingress_ab:
        return report(run_ingress_ab(duration=args.duration, rounds=args.ab_rounds, dim=args.dim,
                                     max_batch=args.max_batch, shards=args.ingress_shards,
                                     http_clients=args.http_clients, bin_clients=args.bin_clients,
                                     device=args.device, workers=args.workers), gated=True)
    if args.procs_ab:
        return report(run_procs_ab(qps=args.qps, duration=args.duration, rounds=args.ab_rounds,
                                   workers=args.workers or 2, dim=args.dim, burn_rounds=args.burn_rounds,
                                   device=args.device), gated=True)
    if args.autoscale_scenario:
        return report(run_autoscale_scenario(qps=args.qps, duration=args.duration, burn_rounds=args.burn_rounds,
                                             dim=args.dim, device=args.device), gated=True)
    if args.cold_start:
        return report({
            "cold_start": run_cold_start_ab(dim=args.dim, max_batch=args.max_batch, rounds=args.ab_rounds,
                                            device=args.device),
            "restart": run_restart_ab(dim=args.dim, max_batch=args.max_batch, rounds=args.ab_rounds,
                                      device=args.device),
        })
    if args.plan_ab:
        return report(run_plan_ab(dim=args.dim, classes=args.classes, max_batch=args.max_batch, qps=args.qps,
                                  duration=args.duration, rounds=args.ab_rounds, deadline_ms=args.deadline_ms,
                                  queue_bound=args.queue_bound, drift_duration=max(1.0, args.duration),
                                  device=args.device))
    if args.tenants:
        return report(run_tenants_ab(qps=args.qps, duration=args.duration, rounds=args.ab_rounds,
                                     tenants=args.tenants, branches=args.tenant_branches, max_batch=args.max_batch,
                                     deadline_ms=args.deadline_ms, dim=args.dim, device=args.device))
    svc, item_shape = build_service(dim=args.dim, classes=args.classes, max_batch=args.max_batch,
                                    max_wait_ms=args.max_wait_ms, queue_bound=args.queue_bound,
                                    deadline_ms=args.deadline_ms, model=args.model, replicas=args.replicas,
                                    recorder=not args.no_recorder, hedge_ms=args.hedge_ms, device=args.device,
                                    workers=args.workers)
    swap_pipeline = None
    if args.swap_mid_run:
        from keystone_tpu_torch.utils.device import resolve_device
        from keystone_tpu_torch.workflow.pipeline import FittedPipeline

        home = "cpu" if args.workers else resolve_device(args.device)
        swap_pipeline = (FittedPipeline.load(args.model, map_location=home) if args.model
                         else build_pipeline(dim=args.dim, classes=args.classes, seed=1, device=home))
    try:
        rep = run_bench(svc, item_shape, qps=args.qps, duration=args.duration, burst=args.burst,
                        deadline_ms=args.deadline_ms, batch_delay_ms=args.batch_delay_ms,
                        swap_pipeline=swap_pipeline, straggler_ms=args.straggler_ms,
                        straggler_replica=args.straggler_replica)
    finally:
        svc.close()
    return report(rep)


if __name__ == "__main__":
    raise SystemExit(main())
