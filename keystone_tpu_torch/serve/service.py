"""Online inference service: dynamic micro-batching over a frozen
pipeline, with admission control and deadline-aware shedding
(counterpart of ``keystone_tpu/serve/service.py``, its single-process
path).

KeystoneML pipelines are trained once and then applied to a stream of
requests; Clipper-style systems (Crankshaw et al., NSDI 2017) showed the
serving win is a thin layer over the frozen model: micro-batch requests
to keep the device busy, bound the queue so tail latency stays bounded,
and shed work that cannot meet its deadline.

- **Frozen apply** — :class:`~keystone_tpu_torch.workflow.pipeline.FrozenApplier`
  runs the whole-pipeline optimizer once, for its replica's device; each
  flush binds one padded batch to the optimized graph.
- **Padding buckets** — every flush is padded up to a fixed bucket size
  with zero rows (:func:`pad_rows`), so the kernels see a finite set of
  batch shapes and a single-datum request rides the smallest bucket.
- **Dynamic micro-batching** — a batcher thread drains the bounded FIFO
  queue, flushing when ``max_batch`` requests wait or the oldest has
  waited ``max_wait_ms``, and routes each flush to a
  :class:`~keystone_tpu_torch.serve.fleet.ReplicaPool` replica.
- **Where a flush runs** — the padded batch is copied to the replica's
  device through pinned memory on the replica's CUDA stream, applied
  there, and read back to the host in one copy per flush; each request
  gets its numpy row.
- **Admission control** — ``submit`` past ``queue_bound`` raises
  :class:`Overloaded`; requests whose deadline would expire before their
  flush completes (EWMA-predicted) are shed with
  :class:`~keystone_tpu_torch.utils.guard.DeadlineExceeded`.
- **Degradation** — when every rider carries a deadline, the loosest
  one plumbs into the executor, so ``optional`` / ``with_fallback``
  stages degrade on the serve path as they do in fits.
- **Self-healing** — the :class:`~keystone_tpu_torch.serve.fleet.ReplicaSupervisor`
  restarts dead or wedged replica workers; a flush failing with a
  request-attributable error is bisected until the poison request alone
  fails (:class:`PoisonRequest`, HTTP 422) and its content is refused at
  admission afterwards; hedged dispatch (``hedge_ms``) re-enqueues a
  flush stuck behind a straggling replica onto a second one.
- **Bucket graphs** — ``artifacts=`` (a bundle of
  ``FrozenApplier.export_artifacts``, or a registry version's) makes
  every replica capture one CUDA graph of the frozen apply per padding
  bucket when it primes; a flush then replays its bucket's graph instead
  of walking.  The bundle moves with its generation through swaps,
  heals and scale-ups.
- **Lifecycle** — ``swap(artifacts=)`` stages a new version with its
  bundle; a guarded rollout (``serve/rollout.py``) serves a canary
  fraction of flushes on the staged generation before it commits or
  rolls back, and ``autoscale=`` starts the SLO-driven
  :class:`~keystone_tpu_torch.serve.autoscale.Autoscaler`.
- **Tracing** — every request carries a ``request_id`` into the
  :class:`~keystone_tpu_torch.obs.recorder.FlightRecorder` (on by
  default), ``serve.batch`` ledger spans list their riders, and each
  terminal outcome emits a ``serve.request`` ledger event.
- **Process and network fleets** — ``workers=N`` moves replica compute
  into N worker processes (``serve/procfleet.py`` over the
  shared-memory wire of ``serve/wire.py``) behind this same control
  plane; each worker holds the model on its own device (``worker_opts=
  {"device": ...}``, the card by default) and captures its own bucket
  graphs.  ``hosts=`` carries the same fleet over TCP with heartbeat
  leases (``serve/net.py``).  A worker's death mid-flush raises
  :class:`~keystone_tpu_torch.serve.procfleet.WorkerCrashed`: the flush
  is un-claimed, requeued and served by the supervisor's replacement.
  Worker spans, metrics and kernel counts reach the router's
  :class:`~keystone_tpu_torch.serve.telemetry.FleetTelemetry` (the
  ``fleet`` block of ``/statusz``).
- **Slab-direct admission** — ``submit_batch`` takes an admission block
  (``serve/wire.py::SlabBlock``, a padded batch in one shared-memory
  slab, as the binary ingress fills it): a flush made of exactly one
  block's rows skips the stack and pad copies, and a process worker
  attaches the block's slab by reference.

Observability: ``serve.queue_depth`` gauge, ``serve.batch_rows`` /
``serve.batch_seconds`` / ``serve.latency_seconds`` histograms, the
``serve.submitted`` / ``completed`` / ``shed`` / ``rejected`` /
``batch_errors`` / ``deadline_miss`` counters.  Fault sites
``serve.enqueue`` (admission), ``serve.batch`` (a flush's apply) and
``serve.swap`` (a hot-swap's stage).

The reference's tenant and dedup override points are kept, inert.  The
physical planner's knobs (A10) resolve to the reference's static
defaults: a 5 ms wait, power-of-two buckets, hedging off, a dispatch
window of 2.

Usage::

    svc = serve(fitted, max_batch=32, max_wait_ms=5, queue_bound=256,
                deadline_ms=100, example=x0)
    fut = svc.submit(x)            # concurrent.futures.Future
    y = fut.result()
    svc.close()                    # drains in-flight requests
"""

from __future__ import annotations

import hashlib
import heapq
import itertools
import logging
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch.faults import fault_point
from keystone_tpu_torch.kernels.build import KernelError
from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.obs.recorder import FlightRecorder, new_request_id
from keystone_tpu_torch.serve.fleet import FleetUnavailable, ReplicaPool, ReplicaSupervisor
from keystone_tpu_torch.serve.procfleet import WorkerCrashed
from keystone_tpu_torch.utils import guard
from keystone_tpu_torch.workflow.dataset import Dataset, _to_device

logger = logging.getLogger(__name__)

# millisecond-resolution histogram bounds for the serve-path latencies
metrics.register_buckets("serve.latency_seconds", metrics.LATENCY_MS_BUCKETS)
metrics.register_buckets("serve.batch_seconds", metrics.LATENCY_MS_BUCKETS)
metrics.register_buckets("serve.failed_wait_seconds", metrics.LATENCY_MS_BUCKETS)

#: EWMA smoothing for the per-batch latency predictor the shed decision
#: uses: new = (1-ALPHA)*old + ALPHA*sample
_EWMA_ALPHA = 0.3

#: bound on the content-keyed poison quarantine cache (LRU eviction)
_POISON_CACHE_CAP = 512

#: quarantine entries expire after this long: the poison test is a
#: type-level heuristic, so a misclassified payload is refused for
#: minutes, not forever
_POISON_TTL_S = 600.0

#: hedge delay = max(configured floor, this multiple of the EWMA batch
#: time): near p95 for exponential-ish flush times
_HEDGE_EWMA_MULT = 3.0


class Overloaded(RuntimeError):
    """Admission control refused the request: the queue is at its bound.
    Not an ``OSError``, so transient-I/O retry loops do not hammer an
    overloaded service."""


class ServiceClosed(RuntimeError):
    """The service is shut down (or shutting down)."""


class PoisonRequest(ValueError):
    """THIS request's content makes the model fail: isolated by batch
    bisection, or matched against the quarantine cache.  A client fault
    (HTTP 422; it burns no SLO budget), and a retry fails again."""


def _content_key(arr: np.ndarray) -> bytes:
    """The quarantine-cache key: a BLAKE2b digest of dtype, shape and bytes."""
    h = hashlib.blake2b(digest_size=16)
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.digest()


def _poison_suspect(exc: BaseException) -> bool:
    """Is this apply failure plausibly caused by a request's CONTENT?
    Infrastructure rides ``OSError`` (injected faults, deadlines, I/O),
    breaker refusals ``CircuitOpenError``, exhaustion ``MemoryError``;
    the port adds a kernel that failed to build or launch
    (``KernelError``) and ``torch.cuda.OutOfMemoryError``, both
    ``RuntimeError``s.  Everything else is content-shaped."""
    return not isinstance(exc, (OSError, MemoryError, guard.CircuitOpenError, KernelError,
                                torch.cuda.OutOfMemoryError))


def default_buckets(max_batch: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Power-of-two padding buckets up to (and including) ``max_batch``."""
    max_batch = max(1, int(max_batch))
    b = min(int(min_bucket), max_batch)
    out = []
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(sorted(set(out)))


def pad_rows(rows: np.ndarray, bucket: int) -> np.ndarray:
    """``rows`` (k, ...) padded with zero rows up to ``bucket`` rows (the
    reference pads a flush with ``iter_row_chunks(rows, None, bucket)``)."""
    k = rows.shape[0]
    if k == bucket:
        return rows
    out = np.zeros((bucket,) + rows.shape[1:], rows.dtype)
    out[:k] = rows
    return out


class _Request:
    __slots__ = ("x", "deadline", "future", "t_submit", "request_id", "tenant", "block", "row", "gen")

    def __init__(self, x, deadline: Optional[guard.Deadline], request_id: Optional[str] = None,
                 tenant: Optional[str] = None):
        self.x = x
        self.deadline = deadline
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        #: trace identity; None when tracing is off (every hook is inert)
        self.request_id = request_id
        #: multi-tenant routing label: None on this single-tenant service
        self.tenant = tenant
        #: slab-direct admission: ``x`` is row ``row`` of admission block
        #: ``block`` (a view of its shared-memory slab); None otherwise
        self.block = None
        self.row = 0
        #: rollout generation tag (serve/rollout.py): "canary" when a
        #: guarded rollout routed the rider to the staged generation,
        #: "live" while a judge window is open, None otherwise
        self.gen: Optional[str] = None


def _block_of(reqs) -> Optional[object]:
    """The admission block a flush is a complete in-order image of, or
    None: exactly the block's rows 0..count-1 in order (a shed or
    cancelled rider, a flush mixing two submits, or a block spanning
    flushes take the stack and pad copies, which are right for views)."""
    blk = getattr(reqs[0], "block", None)
    if blk is None or not getattr(blk, "admission_block", False) or len(reqs) != blk.count:
        return None
    for i, r in enumerate(reqs):
        if r.block is not blk or r.row != i:
            return None
    return blk


class _Flush:
    """One formed micro-batch in flight through the router.  ``claim()``
    admits exactly ONE runner (a hedged flush sits in two queues; the
    loser skips without device work); ``abort()`` stops a never-claimed
    flush from running at all (a wedged worker's abandoned flush)."""

    QUEUED, RUNNING, DONE, ABORTED = "queued", "running", "done", "aborted"

    __slots__ = ("riders", "bid", "primary", "hedged", "_state", "_lock")

    def __init__(self, riders: list, bid: str):
        self.riders = riders
        self.bid = bid
        #: index of the replica the router first dispatched to
        self.primary: Optional[int] = None
        self.hedged = False
        self._state = _Flush.QUEUED
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        return self._state

    def unflushed(self) -> bool:
        return self._state == _Flush.QUEUED

    def claim(self) -> bool:
        with self._lock:
            if self._state != _Flush.QUEUED:
                return False
            self._state = _Flush.RUNNING
            return True

    def done(self) -> None:
        with self._lock:
            if self._state == _Flush.RUNNING:
                self._state = _Flush.DONE

    def abort(self) -> bool:
        """Spend the claim without running; True when it was never claimed."""
        with self._lock:
            if self._state == _Flush.QUEUED:
                self._state = _Flush.ABORTED
                return True
            return False

    def unclaim(self) -> bool:
        """Return a RUNNING flush to QUEUED: the worker-process death path
        only (its runner produced and delivered nothing, so the
        replacement re-runs it; resolved riders are skipped)."""
        with self._lock:
            if self._state == _Flush.RUNNING:
                self._state = _Flush.QUEUED
                return True
            return False


class _HedgeMonitor:
    """One timer thread: a dispatched flush still queued after its hedge
    delay is re-enqueued on a second replica (``hedge_dispatch``)."""

    def __init__(self, service: "PipelineService"):
        self._svc = service
        self._heap: list = []
        self._seq = itertools.count()
        self._cond = threading.Condition()
        self._stopping = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name=f"{service.name}-hedge")
        self._thread.start()

    def schedule(self, flush: _Flush, delay_s: float) -> None:
        with self._cond:
            heapq.heappush(self._heap, (time.monotonic() + max(0.0, delay_s), next(self._seq), flush))
            self._cond.notify()

    def stop(self, timeout: float = 5.0) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify()
        self._thread.join(timeout)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._stopping:
                    if not self._heap:
                        self._cond.wait()
                    else:
                        wait = self._heap[0][0] - time.monotonic()
                        if wait <= 0.0:
                            break
                        self._cond.wait(wait)
                if self._stopping:
                    return
                _, _, flush = heapq.heappop(self._heap)
            try:
                self._svc._hedge_fire(flush)
            except Exception:  # a failed hedge must never kill the timer
                logger.exception("hedge dispatch failed")


class PipelineService:
    """A frozen fitted pipeline behind a micro-batching request queue.

    Construct via :func:`serve`.  ``submit`` / ``submit_many`` /
    ``submit_batch`` return ``concurrent.futures.Future`` objects resolved
    by the replica workers; ``close`` drains in-flight work.  Thread-safe:
    any number of client threads may submit concurrently."""

    def __init__(
        self,
        pipeline,
        max_batch: int = 32,
        max_wait_ms: Optional[float] = None,
        queue_bound: int = 128,
        buckets: Optional[Sequence[int]] = None,
        deadline_ms: Optional[float] = None,
        example=None,
        degrade: bool = True,
        name: str = "serve",
        replicas: int = 1,
        devices: Optional[Sequence] = None,
        version: str = "v0",
        recorder=True,
        slo_ms: Optional[float] = None,
        slo_target: float = 0.99,
        slo_window_s: Optional[float] = None,
        supervise: bool = True,
        heartbeat_s: float = 30.0,
        supervise_interval_s: float = 0.5,
        restart_limit: int = 3,
        restart_window_s: float = 60.0,
        hedge_ms: Optional[float] = None,
        bisect: bool = True,
        artifacts: Optional[dict] = None,
        workers: int = 0,
        worker_opts: Optional[dict] = None,
        autoscale: Optional[dict] = None,
        hosts=None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_bound < 1:
            raise ValueError(f"queue_bound must be >= 1, got {queue_bound}")
        workers = int(workers or 0)
        if workers < 0:
            raise ValueError(f"workers must be >= 0, got {workers}")
        if workers > 0 and replicas != 1:
            raise ValueError("workers= (process fleet) and replicas= (thread fleet) are exclusive; pass exactly one")
        if workers > 0 and devices is not None:
            raise ValueError("workers= places the model in the worker processes (worker_opts={'device': ...}); "
                             "devices= applies to the thread fleet only")
        if hosts is not None and workers < 1:
            raise ValueError("hosts= selects the TCP fleet and needs workers>=1 to size it; workers=N without "
                             "hosts stays on the shared-memory transport")
        if worker_opts and workers < 1:
            raise ValueError("worker_opts= configures the workers of workers>=1")
        self.max_batch = int(max_batch)
        self.buckets = tuple(sorted({int(b) for b in buckets})) if buckets else default_buckets(self.max_batch)
        if self.buckets[-1] < self.max_batch:
            # a flush larger than every bucket would have nowhere to pad
            self.buckets = self.buckets + (self.max_batch,)
        #: admission-time shape/dtype contract, learned from ``example``
        #: (or the first request): a mismatched request fails ITS submit,
        #: never the batch it would have ridden in
        self._item_shape: Optional[tuple] = None
        self._dtype = None
        if example is not None:
            ex = np.asarray(example)
            self._item_shape = tuple(ex.shape)
            self._dtype = ex.dtype
        #: the process fleet's size (0: the threaded fleet)
        self.workers = workers
        backend, pool_opts = "thread", None
        #: fleet telemetry (workers > 0): the one sink every worker handle
        #: ships its spans, metric deltas and kernel reports into; its
        #: recorder is set once the recorder exists (below)
        self._telemetry = None
        self._trace_ctx_cap = 0
        if workers > 0:
            from keystone_tpu_torch.serve.telemetry import MAX_TRACE_REQUEST_IDS, FleetTelemetry

            backend = "net" if hosts is not None else "process"
            replicas = workers
            pool_opts = dict(worker_opts or {})
            if hosts is not None:
                pool_opts.setdefault("hosts", hosts)
            # workers prime their buckets at spawn: the final bucket set
            # and item contract travel with them
            pool_opts.setdefault("buckets", list(self.buckets))
            pool_opts.setdefault("item_shape", self._item_shape)
            pool_opts.setdefault("dtype", None if self._dtype is None else np.dtype(self._dtype).str)
            self._telemetry = FleetTelemetry()
            self._trace_ctx_cap = MAX_TRACE_REQUEST_IDS
        self._pool = ReplicaPool(pipeline, replicas=replicas, devices=devices, version=version, name=name,
                                 heartbeat_s=heartbeat_s, artifacts=artifacts, backend=backend,
                                 worker_opts=pool_opts, telemetry=self._telemetry)
        #: the flight recorder: True (default) = a fresh bounded recorder,
        #: False/None = tracing off (no ids minted, no hook runs), or a
        #: caller-provided FlightRecorder
        if recorder is True:
            self.recorder: Optional[FlightRecorder] = FlightRecorder()
        elif recorder:
            self.recorder = recorder
        else:
            self.recorder = None
        if self._telemetry is not None:
            # worker spans stitch into /requestz through the recorder; with
            # it off the sink still folds the workers' metrics
            self._telemetry.recorder = self.recorder
        #: the trace context of the flush a remote replica is applying (set
        #: by _run_batch with the recorder on, read by _apply_rows): out of
        #: band, as _apply_reqs is an override point
        self._trace_tls = threading.local()
        #: rolling-window instruments behind /statusz; every observe also
        #: feeds the cumulative registry series of the same name (/metrics)
        slo_window = max(1.0, float(slo_window_s)) if slo_window_s else 60.0
        self._lat_win = metrics.WindowedHistogram("serve.latency_seconds", window_seconds=slo_window)
        self._batch_win = metrics.WindowedHistogram("serve.batch_seconds")
        #: failed requests' waits, and the SLO burn's windowed failure count
        self._fail_win = metrics.WindowedHistogram("serve.failed_wait_seconds", window_seconds=slo_window)
        #: SLO latency objective (seconds): slo_ms, else the deadline
        self._slo_s = float(slo_ms) / 1000.0 if slo_ms else (float(deadline_ms) / 1000.0 if deadline_ms else None)
        self._slo_target = min(1.0, max(0.0, float(slo_target)))
        self._batch_seq = itertools.count(1)
        self._trace_dump_seq = itertools.count(1)
        #: span-parenting context captured where the service was built,
        #: restored in the batcher and every replica worker
        self._obs_ctx = ledger.capture_context()
        self.max_wait_s = max(0.0, 5.0 if max_wait_ms is None else float(max_wait_ms)) / 1000.0
        self.queue_bound = int(queue_bound)
        self.default_deadline_s = None if not deadline_ms else float(deadline_ms) / 1000.0
        self._degrade = bool(degrade)
        self.name = name
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closing = False
        self._closed = False
        self._ewma_batch_s = 0.0
        #: EWMA writes race across replica workers
        self._ewma_lock = threading.Lock()
        #: serializes concurrent swap() / scale_to() calls
        self._swap_lock = threading.Lock()
        self._swap_seq = 0
        self._bisect = bool(bisect)
        self._poison_cache: "OrderedDict[bytes, float]" = OrderedDict()
        self._poison_lock = threading.Lock()
        #: prior version ids, newest last (what POST /rollback walks)
        self._version_history: list = []
        #: guarded-rollout hooks (serve/rollout.py): ``_rollout`` the
        #: CanaryController whose judge window is open (the batcher's
        #: routing hook and the terminals' observe hook; None: one
        #: attribute read a flush), ``_rollout_guard`` the post-commit
        #: bake watch, ``_rollout_state`` the active phase for /rolloutz,
        #: ``_rollout_history`` the recent episodes' verdicts
        self._rollout = None
        self._rollout_guard = None
        self._rollout_state: Optional[dict] = None
        self._rollout_history: deque = deque(maxlen=16)
        if example is not None:
            self.prime()
        self._pool.start(self._run_flush, obs_context=self._obs_ctx, on_stranded=self._handle_stranded_flush)
        self._worker = threading.Thread(target=self._loop, daemon=True, name=f"{name}-batcher")
        self._worker.start()
        #: hedged dispatch: off unless ``hedge_ms`` is given (0 is a
        #: meaningful floor), and it needs a second replica to hedge onto
        self._hedge_floor_s = None if hedge_ms is None else max(0.0, float(hedge_ms)) / 1000.0
        self._hedge = _HedgeMonitor(self) if self._hedge_floor_s is not None and self._pool.size > 1 else None
        self.supervisor = (
            ReplicaSupervisor(self, interval=supervise_interval_s, restart_limit=restart_limit,
                              restart_window=restart_window_s).start()
            if supervise else None
        )
        #: SLO-driven autoscaling (off unless ``autoscale=``, a config dict
        #: for :class:`~keystone_tpu_torch.serve.autoscale.Autoscaler`)
        self.autoscaler = None
        if autoscale:
            from keystone_tpu_torch.serve.autoscale import Autoscaler

            try:
                self.autoscaler = Autoscaler(self, **dict(autoscale)).start()
            except BaseException:
                # a bad config must not leak the fleet already built
                self.close(drain=False, timeout=10.0)
                raise
        metrics.set_gauge("serve.workers", float(self._pool.size))

    # ------------------------------------------------------------ priming
    def prime(self, replicas=None, have_artifacts: Optional[bool] = None) -> None:
        """Run every bucket's shape through every replica NOW (the
        first-use kernel builds, the allocator's first blocks, and, with
        an artifact bundle, the capture of each bucket's CUDA graph), so
        no request pays them against its deadline.  Needs the item shape
        (an ``example``, or a request already served).  ``replicas``:
        prime just these (a staged generation, a supervisor replacement).

        Each bucket is metered as ``serve.prime_seconds{source=}``:
        ``artifact`` when the replica's bucket graph served it (captured
        then), ``compile`` when the walk did; a bucket with no graph while
        a bundle was configured counts a ``serve.artifact_misses``.
        ``have_artifacts``: whether the generation being primed was given
        a bundle (the swap path passes the staged bundle's presence; the
        default reads the pool's)."""
        if self._item_shape is None:
            raise ValueError("prime() needs the request item shape; construct the service with "
                             "example=<one datum> (or serve a request first)")
        have_bundle = self._pool.has_artifacts if have_artifacts is None else bool(have_artifacts)
        t_all = time.monotonic()
        sources: dict = {}
        n_replicas = 0
        for replica in self._pool.replicas if replicas is None else replicas:
            n_replicas += 1
            for bucket in self.buckets:
                zeros = np.zeros((bucket,) + self._item_shape, self._dtype)
                t0 = time.monotonic()
                self._apply_rows(zeros, deadline=None, replica=replica, prime=True)
                dt = time.monotonic() - t0
                applier = replica.applier
                if applier.has_bucket_program(zeros.shape, zeros.dtype):
                    source = "artifact"
                else:
                    if have_bundle:
                        metrics.inc("serve.artifact_misses")
                    source = "compile"
                metrics.observe("serve.prime_seconds", dt, source=source)
                sources[source] = sources.get(source, 0) + 1
                if source == "artifact" and getattr(applier, "_degradable", False):
                    # a degradable pipeline's deadline-carrying flushes
                    # walk: warm the walk too (a far deadline never fires)
                    t1 = time.monotonic()
                    self._apply_rows(zeros, deadline=guard.Deadline.after(86400.0), replica=replica, prime=True)
                    metrics.observe("serve.prime_seconds", time.monotonic() - t1, source="compile")
                    sources["compile"] = sources.get("compile", 0) + 1
        took = time.monotonic() - t_all
        source = max(sources, key=sources.get) if sources else "compile"
        n = sum(sources.values())
        ledger.event("serve.prime", seconds=round(took, 6), replicas=n_replicas, source=source, n=n, sources=sources)
        if self.recorder is not None:
            self.recorder.ops("serve.prime", seconds=round(took, 6), replicas=n_replicas, source=source, n=n,
                              sources=sources)

    def prime_replacement(self, replica) -> None:
        """Prime one not-yet-routed replica (the supervisor's restart and
        the scale-up path)."""
        if self._item_shape is not None:
            self.prime(replicas=[replica])

    def fail_flush(self, flush, exc: BaseException) -> None:
        """Fail every unresolved rider of a flush."""
        for req in flush.riders:
            self._fail(req, exc, batch=flush.bid)

    def _handle_stranded_flush(self, flush, why: str = "replica died") -> None:
        """The one stranded-work policy (supervisor heal/quarantine,
        scale-down leftovers): a copy no longer QUEUED belongs to its
        claimed winner; otherwise re-dispatch onto a survivor, window
        ignored; only with no routable survivor do the riders fail typed,
        aborted first so a pending hedge cannot resurrect the flush."""
        if not flush.unflushed():
            return
        if self._pool.hedge_dispatch(flush, exclude_index=None, respect_window=False) is None:
            flush.abort()
            self.fail_flush(flush, FleetUnavailable(f"{why} and no routable survivor could absorb its queue"))

    # ------------------------------------------------------------ hedging
    def _hedge_delay_s(self) -> float:
        return max(self._hedge_floor_s or 0.0, _HEDGE_EWMA_MULT * self._ewma_batch_s)

    def _hedge_fire(self, flush: _Flush) -> None:
        """Timer callback: the flush still sits in its primary replica's
        queue past the hedge delay; enqueue it on a second replica."""
        if not flush.unflushed() or flush.hedged:
            return
        flush.hedged = True  # at most one hedge per flush
        rep = self._pool.hedge_dispatch(flush, exclude_index=flush.primary)
        if rep is None:
            return
        metrics.inc("serve.hedges")
        if self.recorder is not None:
            self.recorder.ops("serve.hedge", batch=flush.bid, from_replica=flush.primary, to_replica=rep.index)

    # ------------------------------------------------------------- submit
    def submit(self, x, deadline=None, request_id: Optional[str] = None, tenant: Optional[str] = None) -> Future:
        """Enqueue one datum; returns a Future resolving to its result row
        (numpy).  ``deadline``: seconds or a ``guard.Deadline`` (default:
        the service's ``deadline_ms``).  ``request_id``: the trace
        identity (default: generated while the recorder is on).  Raises
        :class:`Overloaded` at the queue bound and :class:`ServiceClosed`
        after shutdown began."""
        return self._submit_all([x], deadline, None if request_id is None else [request_id], tenant=tenant)[0]

    def submit_many(self, xs, deadline=None, request_ids=None, tenant=None) -> list:
        """Enqueue a sequence of datums; returns their Futures in order.
        One shared deadline and ATOMIC admission: every datum is enqueued
        or none is."""
        return self._submit_all(list(xs), deadline, request_ids, tenant=tenant)

    def submit_batch(self, block, deadline=None, request_ids=None, tenant: Optional[str] = None) -> list:
        """Admit a whole admission block (``serve/wire.py::SlabBlock``, or
        any carrier with ``admission_block``, ``count`` and ``rows()``)
        under one queue-lock round; one Future per row, in order, each
        request a view of its row.  When the block forms a flush by itself
        the router skips the stack and pad copies, and a process worker
        attaches the block's slab by name.  The caller keeps the block
        alive until every returned future resolves (``block.retain(n)``
        and ``release_one`` callbacks): the router may read it until then
        (hedges, crash requeues, bisection).  Atomic, and raises what
        :meth:`submit_many` raises."""
        if not getattr(block, "admission_block", False):
            raise TypeError(f"submit_batch wants an admission block (wire.SlabBlock); got {type(block).__name__} "
                            "— use submit_many for plain sequences")
        return self._submit_all(list(block.rows()), deadline, request_ids, tenant=tenant, block=block)

    def bucket_for(self, k: int) -> int:
        """The padding bucket a ``k``-row flush pads to (the ingress pads
        its admission blocks to it)."""
        return self._bucket_for(int(k))

    # ------------------------------------------------------ tenant hooks
    # The reference's multi-tenant service (ROADMAP A11d) overrides these;
    # here each is inert, or refuses.
    def _resolve_tenant(self, tenant: Optional[str]) -> Optional[str]:
        if tenant is not None:
            raise TypeError(f"service {self.name!r} is single-tenant; tenant={tenant!r} refused "
                            "(the multi-tenant service is ROADMAP A11d)")
        return None

    def _default_deadline_for(self, tenant: Optional[str]):
        return self.default_deadline_s

    def _check_bound_locked(self, n_new: int, tenant: Optional[str]) -> None:
        """Admission bound check; must hold ``self._cond``."""
        if len(self._q) + n_new > self.queue_bound:
            metrics.inc("serve.rejected", n_new)
            raise Overloaded(f"service {self.name!r} queue at bound ({self.queue_bound}); retry later")

    def _push_locked(self, reqs: list, tenant: Optional[str]) -> int:
        """Enqueue admitted requests; must hold ``self._cond``.  Returns
        the depth after the push."""
        self._q.extend(reqs)
        depth = len(self._q)
        metrics.set_gauge("serve.queue_depth", depth)
        return depth

    def _account_admission(self, tenant: Optional[str], outcome: str, n: int) -> None:
        """Per-tenant admission accounting hook (inert here)."""

    def _account_tenant(self, req, outcome: str, seconds: float) -> None:
        """Per-tenant request-terminal accounting hook (inert here)."""

    def _fail_queued_locked(self, make_exc) -> None:
        """Fail every queued request; must hold ``self._cond``."""
        while self._q:
            self._fail(self._q.popleft(), make_exc())
        metrics.set_gauge("serve.queue_depth", 0)

    def _queue_depth_locked(self) -> int:
        return len(self._q)

    # ------------------------------------------------------- dedup hooks
    # In-flight dedup of identical payloads (the reference's multi-tenant
    # service enables it): inert here.
    def _dedup_keys(self, arrs) -> Optional[list]:
        return None

    def _dedup_match(self, tenant, keys) -> dict:
        return {}

    def _dedup_register(self, tenant, keys, reqs, followers) -> None:
        """Register the call's leaders (inert here)."""

    def _dedup_attach(self, followers: dict, reqs: list) -> None:
        """Wire follower futures to their leaders (inert here)."""

    def _resolve_request_ids(self, n: int, request_ids) -> List[Optional[str]]:
        if request_ids is not None:
            rids = [None if r is None else str(r) for r in request_ids]
            if len(rids) != n:
                raise ValueError(f"got {len(rids)} request_ids for {n} datums")
            return rids
        if self.recorder is not None:
            return [new_request_id() for _ in range(n)]
        return [None] * n

    def _submit_all(self, xs, deadline, request_ids=None, tenant=None, block=None) -> list:
        if not xs:
            return []
        rids = self._resolve_request_ids(len(xs), request_ids)
        rec = self.recorder
        try:
            if self._closing:
                raise ServiceClosed(f"service {self.name!r} is closed")
            tenant = self._resolve_tenant(tenant)
            dl = guard.as_deadline(deadline if deadline is not None else self._default_deadline_for(tenant))
            tctx = {} if tenant is None else {"tenant": tenant}
            for _ in xs:
                fault_point("serve.enqueue", **tctx)
            arrs = [np.asarray(x) for x in xs]
            dd_keys = self._dedup_keys(arrs)
            # the poison quarantine cache: content isolated by bisection is
            # refused before it reaches a device (zero cost while empty)
            if self._poison_cache:
                keys = dd_keys if dd_keys is not None else [_content_key(a) for a in arrs]
                now = time.monotonic()
                hit = False
                with self._poison_lock:
                    for k in keys:
                        t = self._poison_cache.get(k)
                        if t is None:
                            continue
                        if now - t > _POISON_TTL_S:
                            del self._poison_cache[k]  # expired: amnesty
                        else:
                            hit = True
                            break
                if hit:
                    metrics.inc("serve.poison_blocked", len(arrs))
                    raise PoisonRequest("request content matches a previously-isolated poison payload; refused "
                                        "at admission")
            # a fleet that cannot serve answers 503 at once (one attribute
            # read while it is healthy)
            if not self._pool.available():
                metrics.inc("serve.unavailable", len(arrs))
                raise FleetUnavailable(f"service {self.name!r}: no replica can serve",
                                       retry_after_seconds=self._pool.retry_after_unavailable())
            followers: dict = {}
            with self._cond:
                if self._closing:
                    raise ServiceClosed(f"service {self.name!r} is closed")
                # the shape/dtype contract is learned and checked under the
                # lock, and committed only after admission: a rejected call
                # must not fix it for requests never served
                item_shape, dtype = self._item_shape, self._dtype
                for arr in arrs:
                    if item_shape is None:
                        item_shape, dtype = tuple(arr.shape), arr.dtype
                    elif tuple(arr.shape) != item_shape:
                        raise TypeError(f"request shape {tuple(arr.shape)} != service item shape {item_shape}")
                if dd_keys is not None:
                    followers = self._dedup_match(tenant, dd_keys)
                self._check_bound_locked(len(arrs) - len(followers), tenant)
                self._item_shape, self._dtype = item_shape, dtype
                reqs = []
                for i, (a, rid) in enumerate(zip(arrs, rids)):
                    xa = a if a.dtype == dtype else a.astype(dtype)
                    r = _Request(xa, dl, rid, tenant=tenant)
                    # slab-direct: tag the block's row only when no
                    # conversion copied the view
                    if block is not None and xa is a:
                        r.block, r.row = block, i
                    reqs.append(r)
                if dd_keys is not None:
                    self._dedup_register(tenant, dd_keys, reqs, followers)
                # push, then annotate, both under the queue lock: the
                # batcher pops under it, so no finish can precede the
                # enqueue event
                push_reqs = reqs if not followers else [r for i, r in enumerate(reqs) if i not in followers]
                depth = self._push_locked(push_reqs, tenant)
                if rec is not None:
                    for r in push_reqs:
                        rec.annotate(r.request_id, "serve.enqueue", queue_depth=depth, **tctx)
                self._cond.notify_all()
            if followers:
                self._dedup_attach(followers, reqs)
        except BaseException as e:
            # a terminal outcome at admission: the trace must not dangle
            if isinstance(e, PoisonRequest):
                outcome = "poison"
            elif isinstance(e, (Overloaded, ServiceClosed, FleetUnavailable, guard.CircuitOpenError)):
                outcome = "rejected"
            else:
                outcome = "error"
            # refused admissions burn the SLO budget, client faults (the
            # 400 family) do not
            if not isinstance(e, (TypeError, ValueError)):
                for _ in xs:
                    self._fail_win.observe(0.0)
            self._account_admission(tenant, outcome, len(xs))
            err = f"{type(e).__name__}: {e}"
            for rid in rids:
                if rid is not None:
                    if rec is not None:
                        rec.finish(rid, outcome, error=err)
                    ledger.event("serve.request", request_id=rid, outcome=outcome, error=err)
            raise
        metrics.inc("serve.submitted", len(reqs))
        self._account_admission(tenant, "submitted", len(reqs))
        return [r.future for r in reqs]

    @property
    def queue_depth(self) -> int:
        return len(self._q)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def version(self) -> str:
        """The model version the live replica generation serves."""
        return self._pool.version

    @property
    def replicas(self) -> int:
        return self._pool.size

    @property
    def host_capacity(self) -> Optional[int]:
        """The TCP fleet's host-map slot total (None otherwise, or when a
        host is unbounded): the autoscaler's ceiling."""
        return self._pool.host_capacity

    @property
    def listen_address(self) -> Optional[str]:
        """``host:port`` the TCP fleet's workers dial (None otherwise)."""
        return self._pool.listen_address

    @property
    def telemetry(self):
        """The fleet-telemetry sink of a process or TCP fleet (None for
        threads): the workers' spans, metrics and kernel reports."""
        return self._telemetry

    @property
    def device(self) -> torch.device:
        """The device the live generation serves on (its first replica's):
        where a version loaded from a registry goes.  A process or TCP
        fleet's router keeps models on the host (its workers place them),
        so its device is the CPU."""
        if self.workers:
            return torch.device("cpu")
        return self._pool.replicas[0].device

    def replica_statuses(self) -> list:
        """Per-replica status dicts (the fleet view of /healthz, /replicas)."""
        return self._pool.statuses()

    @property
    def available(self) -> bool:
        """False when NO replica can serve: submits raise
        :class:`FleetUnavailable` and /healthz answers 503 until a restart
        or a half-open probe re-admits traffic.  The full scan."""
        return not self._closed and self._pool.available_now()

    def unavailable_retry_after(self) -> float:
        return self._pool.retry_after_unavailable()

    def retry_after_hint(self) -> float:
        """Seconds until the queue drains, from the EWMA flush time: a
        429's ``Retry-After``.  1 s before the first sample."""
        ewma = self._ewma_batch_s
        if ewma <= 0.0:
            return 1.0
        with self._cond:
            depth = self._queue_depth_locked()
        flushes = -(-max(1, depth) // self.max_batch)  # ceil division
        return ewma * flushes / max(1, self._pool.size)

    # ------------------------------------------------------------- scaling
    def occupancy(self) -> float:
        """Windowed fleet busy fraction: batch-apply seconds over the last
        window divided by (window × replicas)."""
        s = self._batch_win.summary()
        denom = s["window_seconds"] * max(1, self._pool.size)
        occ = min(1.0, (s["sum"] or 0.0) / denom) if denom > 0 else 0.0
        metrics.set_gauge("serve.occupancy", occ)
        return occ

    def slo_burn_rate(self) -> Optional[float]:
        """The windowed SLO burn rate (None without an objective, or with
        no error budget), the number /statusz embeds, for the autoscaler;
        :meth:`slo_burn` carries the sample counts."""
        detail = self.slo_burn()
        return None if detail is None else detail["burn_rate"]

    def set_dispatch_window(self, n: int) -> int:
        """Retune the router's dispatch window live (the autoscaler's
        lever)."""
        return self._pool.set_window(n)

    def slo_burn(self) -> Optional[dict]:
        """The windowed SLO burn detail (None without an objective): the
        bad fraction counts completed-but-over-objective requests plus
        every failed terminal in the window; ``burn_rate`` is it over the
        error budget ``1 - slo_target``."""
        if self._slo_s is None:
            return None
        n_ok = self._lat_win.summary()["count"]
        n_fail = self._fail_win.summary()["count"]
        n = n_ok + n_fail
        bad = 0.0 if n == 0 else (self._lat_win.fraction_above(self._slo_s) * n_ok + n_fail) / n
        budget = 1.0 - self._slo_target
        return {
            "objective_ms": round(1000.0 * self._slo_s, 3),
            "target": self._slo_target,
            "window_seconds": self._lat_win.window_seconds,
            "window_requests": n,
            "window_failed": n_fail,
            "bad_fraction": bad,
            "burn_rate": None if budget <= 0.0 else bad / budget,
        }

    def scale_to(self, n: int, timeout: float = 60.0) -> int:
        """Resize the fleet to ``n`` replicas (grow: build → prime →
        admit; shrink: retire and drain, leftovers re-dispatched),
        serialized with swaps.  Returns the resulting size."""
        n = max(1, int(n))
        with self._swap_lock:
            if self._closing:
                raise ServiceClosed(f"service {self.name!r} is closed")
            while self._pool.size < n:
                t0 = time.monotonic()
                fresh = self._pool.add_replica(primer=self.prime_replacement)
                metrics.inc("serve.scale_ups")
                self._scale_event("up", fresh.index, time.monotonic() - t0)
            while self._pool.size > n:
                t0 = time.monotonic()
                left = self._pool.remove_replica(timeout=timeout)
                if left is None:
                    break  # at the floor
                metrics.inc("serve.scale_downs")
                for flush in left:
                    if flush.unflushed():
                        self._handle_stranded_flush(flush, why="replica retired during scale-down")
                    else:
                        # a claimed flush a wedged victim never delivered
                        flush.abort()
                        self.fail_flush(flush, FleetUnavailable(
                            "replica retired during scale-down with a flush still in hand"))
                self._scale_event("down", None, time.monotonic() - t0)
        metrics.set_gauge("serve.workers", float(self._pool.size))
        return self._pool.size

    def _scale_event(self, action: str, replica, seconds: float) -> None:
        ledger.event("serve.scale", action=action, replica=replica, workers=self._pool.size,
                     seconds=round(seconds, 6))
        if self.recorder is not None:
            self.recorder.ops("serve.scale", action=action, replica=replica, workers=self._pool.size,
                              seconds=round(seconds, 6))
        logger.info("scaled %s %r to %d replica(s) in %.2fs", action, self.name, self._pool.size, seconds)

    # ------------------------------------------------------------- statusz
    @staticmethod
    def _ms(window_summary: dict) -> dict:
        """A windowed summary in milliseconds (rounded for the wire)."""
        out = {"count": window_summary["count"]}
        for key in ("p50", "p95", "p99", "min", "max"):
            v = window_summary.get(key)
            out[key] = None if v is None else round(1000.0 * v, 3)
        return out

    def status(self) -> dict:
        """The live ops view GET /statusz serves: rolling-window latency
        and batch percentiles, per-replica statuses, the outcome counters,
        the recorder's stats and, with an objective, the SLO burn.  The
        reference's keys, those of unported parts at their idle values."""
        reg = metrics.REGISTRY
        rec = self.recorder
        replica_stats = self.replica_statuses()
        out = {
            "name": self.name,
            "status": "closed" if self._closed else "ok",
            "version": self.version,
            "backend": self._pool.backend,
            "workers": self._pool.size,
            "dispatch_window": self._pool.window,
            "occupancy": round(self.occupancy(), 4),
            "queue_depth": self.queue_depth,
            "queue_bound": self.queue_bound,
            "max_batch": self.max_batch,
            "window_seconds": self._lat_win.window_seconds,
            "latency_ms": self._ms(self._lat_win.summary()),
            "batch_ms": self._ms(self._batch_win.summary()),
            "available": self.available,
            "counters": {
                name.split(".", 1)[1]: reg.counter_total(name)
                for name in (
                    "serve.submitted", "serve.completed", "serve.shed", "serve.rejected", "serve.deadline_miss",
                    "serve.batch_errors", "serve.replica_restarts", "serve.bisections", "serve.poison",
                    "serve.poison_blocked", "serve.hedges", "serve.hedge_wins", "serve.unavailable",
                    "serve.artifact_hits", "serve.artifact_misses", "serve.artifact_fallbacks",
                    "serve.worker_crashes", "serve.scale_ups", "serve.scale_downs", "serve.dedup_hits",
                )
            },
            # the bucket graphs at a glance: was a bundle configured, how
            # many bucket programs the live replicas hold, the primes' time
            # by source (the reference's "cache" tier has no counterpart)
            "artifacts": {
                "configured": self._pool.has_artifacts,
                "installed_buckets": sum(r.get("artifact_buckets", 0) for r in replica_stats),
                "prime_seconds": {src: reg.histogram_value("serve.prime_seconds", source=src)
                                  for src in ("artifact", "cache", "compile")},
            },
            "replicas": replica_stats,
            "supervisor": None if self.supervisor is None else self.supervisor.status(),
            "autoscaler": None if self.autoscaler is None else self.autoscaler.status(),
            "plan": None,
            "recorder": None if rec is None else rec.stats(),
        }
        # the front end's health, once any front end has counted a
        # connection
        conns = reg.counter_total("ingress.bin_conns") + reg.counter_total("ingress.http_conns")
        if conns or reg.counter_total("ingress.accepts"):
            out["ingress"] = {
                key: reg.counter_total(f"ingress.{key}")
                for key in ("accepts", "bin_conns", "http_conns", "frames", "batch_rows", "bytes_copied")
            }
            out["ingress"]["frame_errors"] = {
                labels.get("kind", "?"): value for labels, value in reg.counter_series("ingress.frame_errors")}
            for key in ("parse", "admit"):
                summary = reg.histogram_summary(f"ingress.{key}_seconds")
                out["ingress"][f"{key}_ms"] = None if summary is None else self._ms(summary)
        if self._telemetry is not None:
            # per worker: apply and wire percentiles, clock sync, device
            # and peak reserved memory, from what the workers shipped
            out["fleet"] = self._telemetry.fleet_status()
        if self._slo_s is not None:
            detail = self.slo_burn()
            bad = detail["bad_fraction"]
            out["slo"] = {
                "objective_ms": detail["objective_ms"],
                "target": detail["target"],
                "window_seconds": detail["window_seconds"],
                "window_requests": detail["window_requests"],
                "window_failed": detail["window_failed"],
                "bad_fraction": round(bad, 6),
                "compliance": round(1.0 - bad, 6),
                "burn_rate": None if detail["burn_rate"] is None else round(detail["burn_rate"], 3),
            }
        return out

    def rollout_status(self) -> dict:
        """The ``GET /rolloutz`` block: the live rollout phase (canary
        window or bake watch) when one is active, the recent episodes'
        verdicts, and the swap history ``POST /rollback`` walks."""
        active = self._rollout_state
        guard_ = self._rollout_guard
        if guard_ is not None:
            active = guard_.status()
        rollout = self._rollout
        if rollout is not None and isinstance(active, dict):
            active = dict(active)
            active["canary"] = rollout.snapshot()
        return {
            "version": self.version,
            "active": active,
            "history": list(self._rollout_history),
            "prior_versions": list(self._version_history),
            "slo": self.slo_burn(),
        }

    def dump_trace(self, dir_path: str) -> Optional[str]:
        """Write the flight recorder's full state (the /tracez?full=1
        payload) durably into ``dir_path``; returns the file's path, or
        None when tracing is off."""
        import json
        import os

        from keystone_tpu_torch.utils import durable

        rec = self.recorder
        if rec is None:
            return None
        os.makedirs(dir_path, exist_ok=True)
        path = os.path.join(dir_path, f"trace-{self.name}-{int(time.time())}-{next(self._trace_dump_seq)}.json")
        payload = rec.dump()

        def _write(tmp: str) -> None:
            with open(tmp, "w") as f:
                json.dump(payload, f)

        durable.atomic_write(path, _write)
        return path

    # --------------------------------------------------------------- swap
    def swap(self, pipeline, version: Optional[str] = None, prime: bool = True, artifacts: Optional[dict] = None
             ) -> dict:
        """Blue/green hot-swap: stage a full replica generation for
        ``pipeline``, prime it while the OLD generation keeps serving,
        then commit at the flush boundary.  Queued requests never drop:
        flushes routed to an old replica resolve from the version that
        admitted them.  ``artifacts``: the new version's bundle (a
        registry's ``load_artifacts``): each staged replica captures its
        bucket graphs as it primes, and the commit makes it the pool's
        bundle.  Returns ``{"version", "pause_seconds", "prime_seconds",
        "replicas"}``.  A failed stage or prime (the ``serve.swap`` fault
        site) leaves the old generation serving."""
        if self._closing:
            raise ServiceClosed(f"service {self.name!r} is closed")
        with self._swap_lock:
            # re-check under the lock: close() sets _closing, then waits on
            # this lock
            if self._closing:
                raise ServiceClosed(f"service {self.name!r} is closed")
            self._swap_seq += 1
            version = version or f"swap{self._swap_seq}"
            prev_version = self.version
            with ledger.span("serve.swap", version=version):
                fault_point("serve.swap", version=version)
                t0 = time.monotonic()
                staged = self._pool.stage(pipeline, version, artifacts=artifacts)
                try:
                    if prime and self._item_shape is not None:
                        self.prime(replicas=staged, have_artifacts=artifacts is not None)
                except BaseException:
                    for r in staged:
                        r.retire()
                    raise
                prime_s = time.monotonic() - t0
                pause_s = self._pool.commit(staged, version)
            self._version_history.append(prev_version)
            metrics.inc("serve.swaps")
            metrics.observe("serve.swap_pause_seconds", pause_s)
            metrics.observe("serve.swap_prime_seconds", prime_s)
            if self.recorder is not None:
                self.recorder.ops("serve.swap", version=version, pause_seconds=round(pause_s, 6),
                                  prime_seconds=round(prime_s, 6), replicas=len(staged))
            logger.info("hot-swapped %r to version %s (%d replicas, prime %.2fs, pause %.2fms)", self.name,
                        version, len(staged), prime_s, 1000.0 * pause_s)
            return {"version": version, "pause_seconds": pause_s, "prime_seconds": prime_s,
                    "replicas": len(staged)}

    # ----------------------------------------------------------- shutdown
    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting requests and shut down.  ``drain=True`` resolves
        every queued request first; ``drain=False`` fails them with
        :class:`ServiceClosed`."""
        with self._cond:
            self._closing = True
            if not drain:
                self._fail_queued_locked(lambda: ServiceClosed("service closed before execution"))
            self._cond.notify_all()
        # stop the healers first: a resize, a restart or a hedge into a
        # pool being torn down would race the retirement below
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.supervisor is not None:
            self.supervisor.stop()
        if self._hedge is not None:
            self._hedge.stop()
        # the bake guard too: its revert swap would stage into a closing pool
        guard_ = self._rollout_guard
        if guard_ is not None:
            guard_.stop()
        # wait out an in-flight swap (bounded: the pool's draining flag
        # makes a late commit refuse)
        if self._swap_lock.acquire(timeout=timeout):
            self._swap_lock.release()
        else:
            logger.warning("service %r closing with a swap still in flight after %.1fs", self.name, timeout)
        # release a batcher blocked at the dispatch window before joining
        # it, so its in-hand batch lands where the pool's close finds it
        self._pool.begin_drain()
        self._worker.join(timeout)
        if self._worker.is_alive():
            logger.warning("service %r batcher did not exit within %.1fs", self.name, timeout)
            with self._cond:
                self._fail_queued_locked(
                    lambda: ServiceClosed("service closed with the batcher wedged; request never executed"))
        # retire the replica workers: each drains its routed flushes first;
        # a wedged one hands back its abandoned flushes
        for flush in self._pool.close(timeout=timeout):
            flush.abort()
            for req in flush.riders:
                self._fail(req, ServiceClosed("service closed with its replica wedged; request never executed"))
        self._closed = True

    def __enter__(self) -> "PipelineService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- worker
    def _loop(self) -> None:
        """The batcher: form flushes and route each onto a replica."""
        ledger.restore_context(self._obs_ctx)
        while True:
            flush = self._next_batch()
            if flush is None:
                return
            # the canary split: while a guarded rollout's judge window is
            # open, the controller claims a seeded-hash fraction of the
            # flushes for the staged generation (not hedged: a live hedge
            # would mask a slow canary)
            rollout = self._rollout
            if rollout is not None and rollout.take(flush):
                continue
            try:
                self._pool.dispatch(flush)
            except FleetUnavailable as e:
                # fail fast: no replica can take this flush
                flush.abort()
                self.fail_flush(flush, e)
                continue
            if self._hedge is not None:
                self._hedge.schedule(flush, self._hedge_delay_s())

    def _next_batch(self):
        """Block until a flush is due; pop and return it (None: shut down
        with an empty queue).  Due: ``max_batch`` waiting, the oldest has
        waited ``max_wait_s``, or the service is closing."""
        with self._cond:
            while not self._q:
                if self._closing:
                    return None
                self._cond.wait()
            flush_at = self._q[0].t_submit + self.max_wait_s
            while len(self._q) < self.max_batch and not self._closing:
                timeout = flush_at - time.monotonic()
                if timeout <= 0:
                    break
                self._cond.wait(timeout)
            k = min(len(self._q), self.max_batch)
            batch = [self._q.popleft() for _ in range(k)]
            metrics.set_gauge("serve.queue_depth", len(self._q))
            return _Flush(batch, f"b{next(self._batch_seq)}")

    def _fail(self, req, exc, **attrs) -> None:
        """Deliver an exception to a request, tolerating a cancelled or
        already-resolved future (an InvalidStateError here would kill the
        worker).  The trace terminal (``shed`` for a deadline shed,
        ``poison`` for an isolated poison request, else ``error``) is
        written before the future resolves."""
        if req.future.done():
            return
        waited = time.monotonic() - req.t_submit
        if not isinstance(exc, (TypeError, ValueError)):
            self._fail_win.observe(waited)
        if isinstance(exc, guard.DeadlineExceeded):
            outcome = "shed"
        elif isinstance(exc, PoisonRequest):
            outcome = "poison"
        else:
            outcome = "error"
        self._account_tenant(req, outcome, waited)
        rollout = self._rollout
        if rollout is not None:
            rollout.observe(req, outcome, waited)
        rid = req.request_id
        if rid is not None:
            if self.recorder is not None:
                self.recorder.finish(rid, outcome, only_live=True, error=f"{type(exc).__name__}: {exc}", **attrs)
            if ledger.active() is not None:
                ledger.event("serve.request", request_id=rid, outcome=outcome, **attrs)
        try:
            req.future.set_exception(exc)
        except InvalidStateError:
            pass

    def _run_flush(self, replica, flush) -> None:
        """One routed flush, on ``replica``'s worker thread: claim it
        (exactly one runner per flush), then shed, pad, apply, resolve,
        and charge the router and the replica's breaker.  An unclaimed pop
        is a hedge loser or an aborted flush: skipped, breaker-neutral."""
        if not flush.claim():
            if flush.state != _Flush.ABORTED:
                metrics.inc("serve.hedge_cancelled")
                if self.recorder is not None:
                    self.recorder.ops("serve.hedge", batch=flush.bid, replica=replica.index, outcome="cancelled")
            self._pool.complete(replica, ok=None)
            return
        if flush.hedged and replica.index != flush.primary:
            metrics.inc("serve.hedge_wins")
        ok: Optional[bool] = False
        try:
            ok = self._run_batch(flush, replica)
        except WorkerCrashed:
            # the replica's worker PROCESS died under this flush and
            # delivered nothing: return the claim and re-raise, so the
            # replica loop requeues it at the front and marks the slot
            # dead, and the supervisor's replacement serves it
            flush.unclaim()
            metrics.inc("serve.worker_crashes", replica=replica.index)
            raise
        except BaseException as e:
            # an escape past _run_batch's containment: the claim is spent,
            # so fail the unresolved riders while we still own them
            logger.exception("flush %s delivery escaped containment on replica %d", flush.bid, replica.index)
            self.fail_flush(flush, e)
        finally:
            flush.done()
            self._pool.complete(replica, ok=ok)

    def _run_batch(self, flush, replica) -> Optional[bool]:
        """False exactly when the replica's APPLY failed (a breaker
        failure); True when it succeeded; None when nothing ran (every
        rider shed or cancelled: breaker-neutral)."""
        batch, bid, rec = flush.riders, flush.bid, self.recorder
        now = time.monotonic()
        if rec is not None:
            riders = [r.request_id for r in batch if r.request_id is not None]
            if riders:
                rec.batch(bid, riders, replica=replica.index, rows=len(batch))
            for req in batch:
                rec.annotate(req.request_id, "serve.batch", batch=bid, replica=replica.index,
                             queue_wait_seconds=round(now - req.t_submit, 6))
        # shed what cannot make it: a request whose deadline expires before
        # the batch's predicted completion
        predicted = self._ewma_batch_s
        live = []
        for req in batch:
            fut = req.future
            if fut.done():
                continue  # resolved on an earlier attempt (a crashed worker's re-run)
            if not (fut.running() or fut.set_running_or_notify_cancel()):
                # the caller cancelled while the request was queued
                metrics.inc("serve.cancelled")
                if rec is not None:
                    rec.finish(req.request_id, "cancelled", only_live=True, batch=bid, replica=replica.index)
                continue
            if req.deadline is not None and req.deadline.remaining() <= predicted:
                metrics.inc("serve.shed")
                waited = time.monotonic() - req.t_submit
                self._fail(req, guard.DeadlineExceeded("serve.shed", waited), batch=bid, replica=replica.index,
                           predicted_seconds=round(predicted, 6), waited_seconds=round(waited, 6))
            else:
                live.append(req)
        if not live:
            # nothing ran: DECAY the predictor, or one outlier sample would
            # shed every later request forever
            with self._ewma_lock:
                self._ewma_batch_s *= 1.0 - _EWMA_ALPHA
            return None
        k = len(live)
        bucket = self._bucket_for(k)
        trace_ids = [r.request_id for r in live if r.request_id is not None]
        deg0 = metrics.REGISTRY.counter_total("executor.degraded") if rec is not None else 0.0
        t0 = time.monotonic()
        batch_deadline = None
        try:
            with ledger.span("serve.batch", rows=k, bucket=bucket, replica=replica.index, batch=bid,
                             request_ids=trace_ids):
                fault_point("serve.batch")
                if self._degrade:
                    # the LOOSEST rider's deadline, only when every rider
                    # has one: one near-expiry straggler must not fail
                    # co-riders with comfortable budgets
                    dls = [r.deadline for r in live if r.deadline is not None]
                    if dls and len(dls) == len(live):
                        batch_deadline = max(dls, key=lambda d: d.at)
                # the wire's trace context: only with the recorder on and a
                # remote fleet (a recorder-off apply frame has no trace key)
                if rec is not None and self._telemetry is not None:
                    self._trace_tls.ctx = {"batch": bid, "request_ids": trace_ids[: self._trace_ctx_cap]}
                try:
                    out = self._apply_reqs(live, replica, batch_deadline)
                finally:
                    self._trace_tls.ctx = None
        except WorkerCrashed:
            raise  # not a batch error: the flush re-runs whole on the replacement
        except BaseException as e:  # one bad batch must not kill the worker
            metrics.inc("serve.batch_errors")
            logger.warning("serve batch of %d failed on replica %d: %s: %s", k, replica.index, type(e).__name__, e)
            if rec is not None:
                rec.batch_update(bid, error=f"{type(e).__name__}: {e}")
            if self._bisect and _poison_suspect(e):
                return self._bisect_flush(live, replica, bid, batch_deadline, e)
            for req in live:
                self._fail(req, e, batch=bid, replica=replica.index)
            if batch_deadline is not None and isinstance(e, guard.DeadlineExceeded):
                # the walk ran out of its riders' own budget (the stage
                # watchdogs split what was left of it): a late shed, not a
                # sick replica.  Charging the breaker would let a queue under
                # deadline pressure open a lone replica's breaker and refuse
                # every later submit with FleetUnavailable
                metrics.inc("serve.shed", k)
                return None
            return False
        dt = time.monotonic() - t0
        with self._ewma_lock:
            self._ewma_batch_s = dt if not self._ewma_batch_s else (
                (1.0 - _EWMA_ALPHA) * self._ewma_batch_s + _EWMA_ALPHA * dt)
        metrics.inc("serve.batches")
        self._batch_win.observe(dt)
        metrics.observe("serve.batch_rows", k)
        degraded = False
        if rec is not None:
            # best effort: the executor counts degradations process-wide
            degraded = metrics.REGISTRY.counter_total("executor.degraded") > deg0
            rec.batch_update(bid, rows=k, bucket=bucket, seconds=round(dt, 6), degraded=degraded)
        self._deliver_completed(live, out, replica, bid, dt, t0, degraded=degraded)
        return True

    def _deliver_completed(self, reqs, out, replica, bid, dt, t0, degraded=False) -> None:
        """Resolve completed riders: latency accounting, trace terminals,
        then the results.  An already-resolved rider is skipped."""
        rec = self.recorder
        outcome = "degraded" if degraded else "completed"
        done_t = time.monotonic()
        led_on = ledger.active() is not None
        rollout = self._rollout
        for i, req in enumerate(reqs):
            if req.future.done():
                continue
            self._lat_win.observe(done_t - req.t_submit)
            late = req.deadline is not None and req.deadline.expired()
            if late:
                # completed, but late: the shed predictor under-estimated
                metrics.inc("serve.deadline_miss")
            metrics.inc("serve.completed")
            self._account_tenant(req, outcome, done_t - req.t_submit)
            if rollout is not None:
                rollout.observe(req, outcome, done_t - req.t_submit)
            if req.request_id is not None:
                if rec is not None:
                    rec.finish(req.request_id, outcome, batch=bid, replica=replica.index,
                               apply_seconds=round(dt, 6), late=late)
                if led_on:
                    ledger.event("serve.request", request_id=req.request_id, outcome=outcome, batch=bid,
                                 replica=replica.index, seconds=round(done_t - req.t_submit, 6),
                                 queue_wait_seconds=round(t0 - req.t_submit, 6))
            try:
                req.future.set_result(out[i])
            except InvalidStateError:
                pass  # a racing cancel/abandonment got there first

    # ---------------------------------------------------------- bisection
    def _bisect_flush(self, live, replica, bid, batch_deadline, first_error) -> Optional[bool]:
        """Isolate poison rider(s) of a failed flush by recursive halving
        over the same buckets: a failing singleton is the poison (typed
        :class:`PoisonRequest`, content quarantined), every innocent rider
        completes.  Depth is at most ⌈log2(rows)⌉.  Returns the breaker
        charge: True when only poison failed, False when infrastructure
        failed a re-run too."""
        metrics.inc("serve.bisections")
        deepest = applies = poisons = 0
        infra_failed = False
        t_bisect0 = time.monotonic()

        def fail_poison(req, cause):
            nonlocal poisons
            poisons += 1
            metrics.inc("serve.poison")
            key = _content_key(req.x)
            with self._poison_lock:
                self._poison_cache[key] = time.monotonic()
                self._poison_cache.move_to_end(key)
                while len(self._poison_cache) > _POISON_CACHE_CAP:
                    self._poison_cache.popitem(last=False)
            self._fail(req, PoisonRequest(f"request content fails the model ({type(cause).__name__}: {cause}); "
                                          "isolated by batch bisection and quarantined"),
                       batch=bid, replica=replica.index)

        def run_group(reqs, depth):
            nonlocal deepest, applies, infra_failed
            deepest = max(deepest, depth)
            try:
                applies += 1
                t0 = time.monotonic()
                out = self._apply_reqs(reqs, replica, batch_deadline)
            except BaseException as ge:
                if isinstance(ge, WorkerCrashed):
                    raise  # the worker died mid-bisect: the flush re-runs whole
                if not _poison_suspect(ge):
                    # infrastructure failed the re-run: the group gets the
                    # real error and the replica is charged
                    infra_failed = True
                    for req in reqs:
                        self._fail(req, ge, batch=bid, replica=replica.index)
                    return
                if len(reqs) == 1:
                    fail_poison(reqs[0], ge)
                    return
                mid = (len(reqs) + 1) // 2
                run_group(reqs[:mid], depth + 1)
                run_group(reqs[mid:], depth + 1)
                return
            self._deliver_completed(reqs, out, replica, bid, time.monotonic() - t0, t0)

        if len(live) == 1:
            fail_poison(live[0], first_error)
        else:
            mid = (len(live) + 1) // 2
            run_group(live[:mid], 1)
            run_group(live[mid:], 1)
        took = time.monotonic() - t_bisect0
        if ledger.active() is not None:
            ledger.event("serve.bisect", batch=bid, replica=replica.index, rows=len(live), depth=deepest, n=applies,
                         seconds=round(took, 6))
        if self.recorder is not None:
            self.recorder.batch_update(bid, depth=deepest, poisons=poisons)
            self.recorder.ops("serve.bisect", batch=bid, replica=replica.index, rows=len(live), depth=deepest,
                              poisons=poisons, seconds=round(took, 6))
        logger.warning("bisected a poisoned flush of %d on replica %d: %d poison request(s) isolated in %d "
                       "applies (depth %d, %.3fs)", len(live), replica.index, poisons, applies, deepest, took)
        return False if infra_failed else True

    # -------------------------------------------------------------- apply
    def _apply_reqs(self, reqs, replica, deadline):
        """One flush's apply body: stack the riders' rows and run the
        frozen graph; returns one numpy row per rider.  Both the flush and
        bisection's re-runs go through it (an override point of the
        reference's multi-tenant service).  A flush that is a complete
        in-order image of ONE admission block is already padded to its
        bucket in the block's slab: no stack, no pad, and a process worker
        attaches the slab by reference."""
        blk = _block_of(reqs)
        if blk is not None and blk.padded_rows == self._bucket_for(len(reqs)):
            metrics.inc("serve.preformed_flushes")
            return self._apply_rows(blk.array, deadline=deadline, replica=replica, pre_padded_n=len(reqs),
                                    slab_ref=blk.ref)
        stacked = np.stack([req.x for req in reqs])
        metrics.inc("serve.bytes_copied", stacked.nbytes)
        return self._apply_rows(stacked, deadline=deadline, replica=replica)

    def _bucket_for(self, k: int) -> int:
        for b in self.buckets:
            if b >= k:
                return b
        return self.buckets[-1]

    def _apply_rows(self, stacked: np.ndarray, deadline=None, replica=None, prime: bool = False,
                    pre_padded_n: Optional[int] = None, slab_ref: Optional[dict] = None) -> np.ndarray:
        """Pad ``(k, ...)`` rows with zero rows up to the smallest bucket
        that holds them (``pre_padded_n``: ``stacked`` is an admission
        block's array, padded already), and apply the frozen graph on the
        replica.  A thread replica copies the batch to its device (pinned,
        on its stream), applies there and reads the first k output rows
        back in one copy; a remote replica ships the padded host batch
        over the wire (``slab_ref``: the block's slab, by reference, where
        the worker can attach it) and its worker does all of that."""
        if pre_padded_n is not None:
            k, padded = int(pre_padded_n), stacked
        else:
            k = stacked.shape[0]
            padded = pad_rows(stacked, self._bucket_for(k))
        rep = replica if replica is not None else self._pool.replicas[0]
        if getattr(rep.applier, "remote_worker", False):
            kw = {"n": k}
            if slab_ref is not None and rep.applier.accepts_slab_ref:
                kw["slab_ref"] = slab_ref
            trace_ctx = getattr(self._trace_tls, "ctx", None)
            if trace_ctx is not None:
                kw["trace"] = trace_ctx
            out = rep.apply(padded, deadline=deadline, prime=prime, **kw)
            return np.asarray(out.array)[:k]
        with rep.on_stream():
            out = rep.apply(Dataset(_to_device(padded, rep.device), n=k), deadline=deadline, prime=prime)
            # on the replica's stream: the read waits for its work alone
            return out.array[:k].cpu().numpy()


def serve(
    pipeline,
    *,
    max_batch: int = 32,
    max_wait_ms: Optional[float] = None,
    queue_bound: int = 128,
    buckets: Optional[Sequence[int]] = None,
    deadline_ms: Optional[float] = None,
    example=None,
    degrade: bool = True,
    name: str = "serve",
    replicas: int = 1,
    devices: Optional[Sequence] = None,
    version: str = "v0",
    recorder=True,
    slo_ms: Optional[float] = None,
    slo_target: float = 0.99,
    slo_window_s: Optional[float] = None,
    supervise: bool = True,
    heartbeat_s: float = 30.0,
    supervise_interval_s: float = 0.5,
    restart_limit: int = 3,
    restart_window_s: float = 60.0,
    hedge_ms: Optional[float] = None,
    bisect: bool = True,
    artifacts: Optional[dict] = None,
    workers: int = 0,
    worker_opts: Optional[dict] = None,
    autoscale: Optional[dict] = None,
    hosts=None,
) -> PipelineService:
    """Freeze a fitted pipeline and stand up a :class:`PipelineService`
    (the reference's ``serve``).

    - ``max_batch`` / ``max_wait_ms`` — flush when either bound is hit
      (count, or the oldest request's age; default 5 ms).
    - ``queue_bound`` — ``submit`` past this depth raises :class:`Overloaded`.
    - ``buckets`` — padding-bucket batch sizes (default: powers of two
      from 8 up to ``max_batch``).
    - ``deadline_ms`` — default per-request deadline; requests predicted
      to miss it are shed.
    - ``example`` — one datum: every bucket is primed on every replica at
      construction (the kernels' first-use builds included).
    - ``degrade`` — plumb the batch's loosest deadline into the executor
      so ``optional`` / ``with_fallback`` stages degrade.
    - ``replicas`` / ``devices`` — the fleet: ``replicas=1`` with no
      devices wraps the pipeline's applier (a pipeline is frozen for the
      card); otherwise each replica is a placed copy on its device
      (``devices=None`` cycles the CUDA devices; ``devices=["cpu"]`` runs
      on the CPU, as the tests do).
    - ``version`` — the initial generation's label; ``swap`` moves it.
    - ``recorder`` — the flight recorder (on by default), ``False`` for
      none, or a configured :class:`FlightRecorder`.
    - ``slo_ms`` / ``slo_target`` / ``slo_window_s`` — the latency
      objective behind /statusz's burn rate (default: ``deadline_ms``).
    - ``supervise``, ``heartbeat_s``, ``supervise_interval_s``,
      ``restart_limit``, ``restart_window_s`` — the self-healing
      supervisor (on by default; ``heartbeat_s`` is the wedge budget).
    - ``hedge_ms`` — hedged dispatch (off by default).
    - ``bisect`` — batch-failure bisection (on by default).
    - ``artifacts`` — an artifact bundle (``FrozenApplier.export_artifacts``
      or a registry's ``load_artifacts``): every replica installs it and
      captures one CUDA graph a bucket as it primes; a bundle that does
      not match (versions, device, kernels, weights) is counted and the
      walk serves.
    - ``autoscale`` — a config dict for
      :class:`~keystone_tpu_torch.serve.autoscale.Autoscaler`
      (``min_workers``, ``max_workers``, ``interval_s``, thresholds):
      grows the fleet under queue or SLO pressure, a replica primed from
      the artifacts, and drains idle ones.
    - ``workers`` — a process fleet of that many worker processes
      (exclusive with ``replicas``/``devices``); ``worker_opts``: their
      knobs (``device``, the card unless ``"cpu"``; ``ready_timeout``,
      ``max_slab_bytes``; for ``hosts``: ``lease_s``, ``listen_host``,
      ``listen_port``); ``hosts`` — the TCP fleet over a host map
      (``"local:2"``, ``host[:slots],...``), workers dialing the
      service's ``listen_address``.
    """
    return PipelineService(
        pipeline, max_batch=max_batch, max_wait_ms=max_wait_ms, queue_bound=queue_bound, buckets=buckets,
        deadline_ms=deadline_ms, example=example, degrade=degrade, name=name, replicas=replicas, devices=devices,
        version=version, recorder=recorder, slo_ms=slo_ms, slo_target=slo_target, slo_window_s=slo_window_s,
        supervise=supervise, heartbeat_s=heartbeat_s, supervise_interval_s=supervise_interval_s,
        restart_limit=restart_limit, restart_window_s=restart_window_s, hedge_ms=hedge_ms, bisect=bisect,
        artifacts=artifacts, workers=workers, worker_opts=worker_opts, autoscale=autoscale, hosts=hosts,
    )
