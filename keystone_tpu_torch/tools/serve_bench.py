"""Open-loop load generator for the serving path (counterpart of
``tools/serve_bench.py``'s ``build_pipeline``, ``build_service`` and
``run_bench``).

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
``--dim``-vector.  The report is one JSON object on stdout.
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
    **serve_kw,
):
    """A primed service over the synthetic pipeline (or a saved fitted
    model) on ``device``; returns ``(service, item_shape)``.  Extra
    keywords (``hedge_ms``, ``supervise``, ``heartbeat_s``, ...) pass
    through to :func:`keystone_tpu_torch.serve.serve`."""
    from keystone_tpu_torch.serve import serve
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    dev = resolve_device(device)
    if model:
        pipe = FittedPipeline.load(model, map_location=dev)
    else:
        pipe = build_pipeline(dim=dim, classes=classes, seed=seed, device=dev)
    item_shape = (int(dim),)
    svc = serve(
        pipe,
        max_batch=max_batch,
        max_wait_ms=max_wait_ms,
        queue_bound=queue_bound,
        deadline_ms=deadline_ms,
        example=np.zeros(item_shape, np.float32),
        name="serve_bench",
        replicas=replicas,
        devices=[dev] * replicas,
        recorder=recorder,
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
    args = ap.parse_args(argv)
    svc, item_shape = build_service(dim=args.dim, classes=args.classes, max_batch=args.max_batch,
                                    max_wait_ms=args.max_wait_ms, queue_bound=args.queue_bound,
                                    deadline_ms=args.deadline_ms, model=args.model, replicas=args.replicas,
                                    device=args.device)
    try:
        rep = run_bench(svc, item_shape, qps=args.qps, duration=args.duration, burst=args.burst,
                        deadline_ms=args.deadline_ms, batch_delay_ms=args.batch_delay_ms)
    finally:
        svc.close()
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
