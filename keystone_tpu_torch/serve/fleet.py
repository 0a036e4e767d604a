"""Replica fleet: N frozen appliers behind a least-outstanding router
(counterpart of ``keystone_tpu/serve/fleet.py``, its thread backend).

- **Replica** — one :class:`~keystone_tpu_torch.workflow.pipeline.FrozenApplier`
  on one device.  A pool of more than one replica (or one with explicit
  devices) deep-copies the fitted pipeline per replica and moves every
  fitted tensor and module onto the replica's device, one placed copy per
  alias.  Each replica owns a worker thread with a private flush queue
  (while replica 0 computes, the batcher is already dispatching the next
  flush to replica 1), a :class:`~keystone_tpu_torch.utils.guard.CircuitBreaker`
  (key ``<service>.replica.<i>``) charged by flush outcomes, and, on a
  CUDA device, a ``torch.cuda.Stream`` of its own: its flushes run and
  read back on that stream, so replicas that share one card overlap
  instead of serializing on the default stream.
- **ReplicaPool** — the router.  ``dispatch`` picks the replica with the
  fewest outstanding flushes whose breaker admits work; when no replica
  can serve (every slot quarantined or dead, every routable breaker
  open) it fails fast with :class:`FleetUnavailable` (503 with a derived
  ``Retry-After`` at HTTP).  A dispatch window bounds each replica's
  queue, so overload backs up into the service's admission queue, where
  ``Overloaded`` refuses it.
- **ReplicaSupervisor** — the self-healing loop: a dead worker (its
  thread exited: an injected ``serve.worker`` crash) or a wedged one (a
  flush held past the heartbeat budget) is restarted in place (re-cloned
  from the pool's source, re-primed, rejoined with its queued work), and a
  slot that keeps dying is quarantined.
- **Blue/green swap** — ``stage()`` builds a full generation for a new
  model on the same devices while the old one serves; ``commit()`` swaps
  the routing list under the router lock and retires the old generation,
  whose workers drain their queued flushes first.  A guarded rollout
  (``serve/rollout.py``) routes a fraction of flushes onto the staged
  generation (``dispatch_staged``) before it commits, or abandons it
  (``abandon_staged``).
- **Artifacts** — the pool's artifact bundle (``artifacts=``) moves with
  its generation: every replica it builds (the first generation, a
  staged one, a supervisor's replacement, a scale-up) installs it, and
  captures its bucket graphs on its own stream when the service primes
  it.  A bundle that fails to install (skew, a damaged blob, the
  ``serve.artifact_load`` fault site) is counted and the replica walks.

Per-replica series share the label key ``replica``
(``serve.replica_flushes{replica=i}``, ``serve.replica_outstanding``,
``serve.replica_queue_share``); the fault sites ``serve.replica`` (a
live flush's apply) and ``serve.worker`` (the worker loop) are the
reference's.

``replicas=1`` with no devices wraps the given pipeline's applier
directly: no copy, no placement.  ``devices=None`` with more replicas
cycles over the CUDA devices torch sees (on one card every replica
shares ``cuda:0``).

**Backends.**  ``backend="thread"`` (the default) is everything above.
``backend="process"`` keeps this module's control plane (the router,
the dispatch window, swaps, supervision) and moves each slot's compute
into a worker process (``serve/procfleet.py``): ``_build_one`` spawns a
:class:`~keystone_tpu_torch.serve.procfleet.ProcessReplica` from a
staged payload file (one a generation; each worker loads it onto its
own device, ``worker_opts["device"]``, the card by default, and captures
its own bucket graphs), generations move the payload at ``commit()``,
and ``add_replica``/``remove_replica`` spawn and reap workers.
``backend="net"`` does the same over TCP (``serve/net.py``): workers
dial the pool's listener, are deployed the payload's bytes, and hold a
heartbeat lease.  A replica's queue and claim semantics are the same in
every backend.  ``telemetry=`` (a
:class:`~keystone_tpu_torch.serve.telemetry.FleetTelemetry`) is attached
to every worker handle the pool builds.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from keystone_tpu_torch.faults import fault_point
from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.utils import graphs, guard
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.pipeline import FrozenApplier

logger = logging.getLogger(__name__)

#: replica breakers default to a short reset so a swapped-in healthy
#: model is probed within seconds, not the 30 s stage-retry default
DEFAULT_REPLICA_BREAKER_RESET = 5.0

#: how long a replica worker may hold one flush between heartbeats before
#: the supervisor declares it wedged: size it above the slowest honest
#: flush
DEFAULT_HEARTBEAT_SECONDS = 30.0

#: the module registries ``nn.Module.to`` already moves
_MODULE_REGISTRIES = ("_parameters", "_buffers", "_modules")


class FleetUnavailable(RuntimeError):
    """Every replica is quarantined, dead, or breaker-open: the fleet
    cannot serve right now.  Not an ``OSError``: retrying into a dead pool
    is futile; recovery is the supervisor's restart or a breaker's
    half-open probe.  HTTP answers 503 with ``Retry-After`` from
    :meth:`ReplicaPool.retry_after_unavailable`."""

    def __init__(self, message: str, retry_after_seconds: float = 1.0):
        super().__init__(message)
        self.retry_after_seconds = float(retry_after_seconds)


def _place_on_device(obj, device, _seen=None, _depth=0):
    """Move every tensor and module reachable from ``obj`` onto
    ``device``; containers and attributes are updated in place where
    possible.  Returns the (possibly replaced) object.  ``_seen`` maps
    ``id(original)`` to its placed result, so a tensor or module reached
    from two sites gets ONE placed copy at both: a set-based guard would
    move the first reference and leave the alias where it was.  A module
    moves with ``nn.Module.to`` (its parameters, buffers and submodules);
    its other attributes (a ``with_fallback`` substitute, a plain tensor
    attribute) are walked."""
    if _depth > 8 or obj is None or isinstance(obj, (str, bytes, int, float, bool, torch.device, torch.dtype)):
        return obj
    if _seen is None:
        _seen = {}
    if id(obj) in _seen:
        return _seen[id(obj)]
    if isinstance(obj, torch.Tensor):
        placed = obj.to(device)
        _seen[id(obj)] = placed
        return placed
    _seen[id(obj)] = obj  # containers: in-place update, cycle-safe
    if isinstance(obj, nn.Module):
        obj.to(device)
        for mod in obj.modules():
            _seen[id(mod)] = mod
            for k, v in list(vars(mod).items()):
                if k in _MODULE_REGISTRIES or k.startswith("_") and k.endswith("hooks"):
                    continue
                nv = _place_on_device(v, device, _seen, _depth + 1)
                if nv is not v:
                    object.__setattr__(mod, k, nv)
        return obj
    if isinstance(obj, dict):
        for k in list(obj):
            obj[k] = _place_on_device(obj[k], device, _seen, _depth + 1)
        return obj
    if isinstance(obj, list):
        for i in range(len(obj)):
            obj[i] = _place_on_device(obj[i], device, _seen, _depth + 1)
        return obj
    if isinstance(obj, tuple):
        new = tuple(_place_on_device(v, device, _seen, _depth + 1) for v in obj)
        new = obj._make(new) if hasattr(obj, "_make") else type(obj)(new)
        _seen[id(obj)] = new  # aliases of the tuple get the rebuilt one
        return new
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        for k, v in list(vars(obj).items()):
            nv = _place_on_device(v, device, _seen, _depth + 1)
            if nv is not v:
                setattr(obj, k, nv)
    return obj


def _clone_and_place(pipeline, device):
    """An independent copy of a fitted pipeline (or applier) with its
    fitted state on ``device`` (None: where it is).  A deep copy, so
    replicas share no transformer instances, and none of the fitted
    tensors a replica's kernels read.  An applier frozen for one kind of
    device is not re-targeted to another: freezing decided its fusion."""
    if device is not None and isinstance(pipeline, FrozenApplier) and pipeline.device.type != device.type:
        raise ValueError(f"an applier frozen for {pipeline.device} cannot serve on {device}: "
                         "serve the fitted pipeline, and each replica freezes it for its own device")
    clone = copy.deepcopy(pipeline)
    if device is not None:
        seen: dict = {}
        for op in clone.graph.operators.values():
            t = getattr(op, "transformer", None)
            if t is not None:
                _place_on_device(t, device, _seen=seen)
        if isinstance(clone, FrozenApplier):
            clone.device = device
    return clone


def _as_applier(pipeline, device=None):
    """``pipeline`` as a frozen applier for ``device`` (None: an applier
    as it is, a pipeline frozen for the card)."""
    if isinstance(pipeline, FrozenApplier):
        return pipeline
    return FrozenApplier(pipeline, device="cuda" if device is None else device)


_SENTINEL = object()
#: ``_build_one``'s default: install the pool's own bundle
_POOL_BUNDLE = object()


class Replica:
    """One frozen applier on one device, plus its flush worker, queue,
    breaker, CUDA stream and counters.  Constructed by
    :class:`ReplicaPool`."""

    def __init__(
        self,
        index: int,
        applier,
        device=None,
        version: str = "v0",
        breaker: Optional[guard.CircuitBreaker] = None,
        pool_name: str = "serve",
        heartbeat_timeout: float = DEFAULT_HEARTBEAT_SECONDS,
    ):
        self.index = int(index)
        self.applier = applier
        #: the device the replica's flushes run on: the placement, or the
        #: directly wrapped applier's own (None: a worker process's)
        self.device = device if device is not None else getattr(applier, "device", None)
        #: the replica's CUDA stream: its batch copy, apply and read-back
        #: all run on it, and the read waits on it alone
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device is not None and self.device.type == "cuda" else None)
        self.version = version
        self.pool_name = pool_name
        self.breaker = breaker or guard.CircuitBreaker(
            f"{pool_name}.replica.{index}", reset_timeout=DEFAULT_REPLICA_BREAKER_RESET
        )
        #: dispatched-but-unfinished flushes (queued + in flight); guarded
        #: by the owning pool's lock — the router reads it
        self.outstanding = 0
        self.flushes = 0
        self.errors = 0
        #: supervision state: the worker beats once per loop iteration (and
        #: on enqueue, so a just-woken idle worker is never stale);
        #: ``inflight`` is the flush the worker holds — inflight + an
        #: expired heartbeat = wedged.  ``dead`` marks a crashed worker;
        #: ``quarantined`` takes the replica out of routing until a swap
        #: installs a fresh generation.
        self.heartbeat = guard.Heartbeat(heartbeat_timeout)
        self.inflight = None
        self.dead = False
        self.dead_error: Optional[str] = None
        self.quarantined = False
        #: restarts of this SLOT (carried onto replacements)
        self.restarts = 0
        #: the pool's re-dispatch for a crashed runner's flush that can no
        #: longer be requeued here (the slot was drained or retired in the
        #: race window: a process death the supervisor saw first); None
        #: requeues in place
        self.on_stranded: Optional[Callable] = None
        self._q: list = []
        self._cond = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._retired = False

    def is_dead(self) -> bool:
        """A worker that exited without being retired: the crash handler
        flagged it, or the thread is gone."""
        if self.dead:
            return True
        w = self._worker
        return w is not None and w.ident is not None and not w.is_alive() and not self._retired

    def routable(self) -> bool:
        """May the router consider this replica at all (breaker aside)?"""
        return not (self.quarantined or self.dead or self._retired)

    def on_stream(self):
        """The context a flush's device work runs in: the replica's CUDA
        stream, or nothing on the CPU."""
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    # ------------------------------------------------------------ apply
    def apply(self, ds, deadline=None, prime: bool = False, **kw):
        """Run the frozen graph over one padded batch on THIS replica.
        Live flushes pass the ``serve.replica`` fault site; priming
        warm-ups (``prime=True``) do not: chaos plans target traffic.
        Other keywords go to the applier (a remote applier's ``n``,
        ``slab_ref`` and ``trace``)."""
        if not prime:
            fault_point("serve.replica", replica=self.index)
        return self.applier(ds, deadline=deadline, **kw)

    # ----------------------------------------------------------- worker
    def start(self, runner: Callable, obs_context=None) -> None:
        """Spawn the flush worker: pops queued items and hands them to
        ``runner(replica, flush)`` until the retire sentinel.
        ``obs_context`` (``ledger.capture_context``) is restored in the
        worker, so the runner's spans parent where the service was
        built."""

        def loop():
            ledger.restore_context(obs_context)
            try:
                while True:
                    with self._cond:
                        while not self._q:
                            self._cond.wait()
                        item = self._q.pop(0)
                    if item is _SENTINEL:
                        return
                    self.inflight = item
                    self.heartbeat.beat()
                    try:
                        # the worker-level fault site: a ``raise`` here is a
                        # WORKER CRASH (the thread dies; the in-hand flush
                        # was never claimed, so it is requeued at the front
                        # for the supervisor's replacement: no future lost),
                        # and a ``hang`` wedges the worker for the
                        # supervisor to find
                        fault_point("serve.worker", replica=self.index)
                        runner(self, item)
                    except BaseException as e:
                        # what reaches here is safe to re-run: never
                        # claimed, or un-claimed by the runner (a worker
                        # process that died under it).  Requeue it at the
                        # front, unless the slot was already drained or
                        # retired (the supervisor saw the process death
                        # first): then the pool re-dispatches it
                        with self._cond:
                            if not self._retired or self.on_stranded is None:
                                self._q.insert(0, item)
                                item = None
                        self.inflight = None
                        self.dead_error = f"{type(e).__name__}: {e}"
                        self.dead = True
                        logger.error("replica %d worker crashed: %s", self.index, self.dead_error)
                        if item is not None:
                            self.on_stranded(item)
                        return
                    finally:
                        self.inflight = None
                        self.heartbeat.beat()
            finally:
                self._on_worker_exit()

        self._worker = threading.Thread(target=loop, daemon=True, name=f"{self.pool_name}-replica{self.index}")
        self._worker.start()

    def _on_worker_exit(self) -> None:
        """The worker thread's exit hook (sentinel or crash): nothing for a
        thread replica; a process or network replica reaps its worker."""

    def enqueue(self, batch) -> None:
        with self._cond:
            self._q.append(batch)
            # beat on enqueue: an idle worker's last beat may be long ago,
            # which would read as a wedge for the instant before it wakes
            self.heartbeat.beat()
            self._cond.notify()

    def drain_queue(self) -> List:
        """Atomically take every queued flush, retire the worker (the
        sentinel makes a merely-wedged worker exit when it unsticks), and
        return the flushes for the caller to transfer or fail."""
        with self._cond:
            left = [b for b in self._q if b is not _SENTINEL]
            self._q.clear()
            self._retired = True
            self._q.append(_SENTINEL)
            self._cond.notify()
        return left

    def retire(self) -> None:
        """Queue the stop sentinel BEHIND any dispatched flushes: the
        worker drains them first, so a swap never drops work."""
        with self._cond:
            if not self._retired:
                self._retired = True
                self._q.append(_SENTINEL)
                self._cond.notify()

    def join(self, timeout: float) -> List:
        """Wait for the worker to exit; returns the flushes left in its
        queue (a wedged worker's abandoned ones) for the caller to fail."""
        if self._worker is not None:
            self._worker.join(timeout)
        with self._cond:
            left = [b for b in self._q if b is not _SENTINEL]
            self._q.clear()
        return left

    def status(self) -> dict:
        return {
            "replica": self.index,
            "device": None if self.device is None else str(self.device),
            "version": self.version,
            "breaker": self.breaker.state(),
            "outstanding": self.outstanding,
            "flushes": self.flushes,
            "errors": self.errors,
            "dead": self.is_dead(),
            "quarantined": self.quarantined,
            "restarts": self.restarts,
            "artifact_buckets": self.applier.installed_buckets(),
        }


class ReplicaPool:
    """N replicas + the least-outstanding router + blue/green swap.

    ``pipeline``: a fitted pipeline or a ``FrozenApplier``.  With
    ``replicas=1`` and no devices the pool wraps its applier directly
    (a pipeline is frozen for the card); otherwise each replica gets an
    independent copy placed on its device (``devices=None`` cycles the
    CUDA devices), which a pipeline source then freezes for that device.
    ``backend="process"``/``"net"``: each replica's compute is a worker
    process (see the module docstring); ``worker_opts`` carries the
    workers' knobs (``device``, ``buckets``, ``item_shape``, ``dtype``,
    ``ready_timeout``, ``max_slab_bytes``; for the network fleet
    ``hosts``, ``lease_s``, ``listen_host``, ``listen_port``,
    ``spawn_grace_s``, ``max_frame_bytes``)."""

    def __init__(
        self,
        pipeline,
        replicas: int = 1,
        devices: Optional[Sequence] = None,
        version: str = "v0",
        name: str = "serve",
        dispatch_window: int = 2,
        heartbeat_s: float = DEFAULT_HEARTBEAT_SECONDS,
        artifacts: Optional[dict] = None,
        backend: str = "thread",
        worker_opts: Optional[dict] = None,
        telemetry=None,
    ):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if dispatch_window < 1:
            raise ValueError(f"dispatch_window must be >= 1, got {dispatch_window}")
        if backend not in ("thread", "process", "net"):
            raise ValueError(f"backend must be 'thread', 'process' or 'net', got {backend!r}")
        if backend != "thread" and devices is not None:
            raise ValueError(f"backend={backend!r} places the model in its workers; devices= applies to the "
                             "thread backend only")
        self.name = name
        self.backend = backend
        #: the fleet-telemetry sink every worker handle this pool builds is
        #: attached to (first build, staged generations, heals, scale-ups)
        self.telemetry = telemetry
        self._worker_opts = dict(worker_opts or {})
        if backend == "process":
            # the workers' device, checked here: a process fleet on a box
            # without the card refuses before it spawns anything
            resolve_device(self._worker_opts.get("device") or "cuda")
        self._lock = threading.Lock()
        #: the fitted pipeline (or applier) the CURRENT generation was
        #: built from: the supervisor re-clones replacements from it;
        #: stage()/commit() move it with the generation
        self._source = pipeline
        self._staged_source = None
        #: the artifact bundle of the current generation: every replica
        #: built for it installs it; stage()/commit() move it with the
        #: generation (None is meaningful: a version without artifacts)
        self._artifacts = artifacts
        self._staged_artifacts = None
        self._staged_artifacts_set = False
        self._heartbeat_s = float(heartbeat_s)
        #: sticky hint set when dispatch finds the whole fleet unavailable,
        #: cleared by the next availability recheck or a restart/commit:
        #: lets admission refuse in one attribute read
        self._known_unavailable = False
        #: flow control: ``dispatch`` blocks while EVERY replica holds
        #: ``dispatch_window`` outstanding flushes, so overload backs up
        #: into the admission queue (``Overloaded``) instead of queueing
        #: invisibly in the replicas
        self._window = int(dispatch_window)
        self._cond = threading.Condition(self._lock)
        self._draining = False
        self._runner: Optional[Callable] = None
        self._obs_ctx = None
        self._on_stranded: Optional[Callable] = None
        self.version = version
        #: process and network backends: the staged payload files the
        #: workers load (one a generation; removed with the pool)
        self._payload_dir: Optional[str] = None
        self._payload_seq = 0
        self._payload_path: Optional[str] = None
        self._staged_payload_path: Optional[str] = None
        #: network backend: the listener workers dial, and the host map
        #: scale-ups and heals spawn workers from
        self._listener = None
        self._hostmap = None
        if backend != "thread":
            import tempfile

            self._payload_dir = tempfile.mkdtemp(prefix=f"ksw-{name}-")
        try:
            if backend != "thread":
                self._payload_path = self._stage_payload(pipeline, artifacts)
            if backend == "net":
                from keystone_tpu_torch.serve import net as netmod
                from keystone_tpu_torch.utils import hostmap as hostmap_mod

                opts = self._worker_opts
                self._listener = netmod.WorkerListener(host=opts.get("listen_host", "127.0.0.1"),
                                                       port=int(opts.get("listen_port", 0)))
                hosts = opts.get("hosts") or ["local"]
                self._hostmap = hosts if isinstance(hosts, hostmap_mod.HostMap) else hostmap_mod.HostMap(hosts)
            self._devices = self._devices_for(int(replicas), devices)
            if backend == "thread":
                self.replicas: List[Replica] = [
                    self._build_one(pipeline, i, dev, version, int(replicas)) for i, dev in enumerate(self._devices)
                ]
            else:
                self.replicas = self._build_process_many(int(replicas), version, self._payload_path)
        except BaseException:
            # a failed build leaves no pool to close(): sweep what it made
            # (spawned workers were reaped by _build_process_many)
            self._release_backend()
            raise

    def _release_backend(self) -> None:
        """Remove the staged payloads, close the listener, reap the host
        map's spawned workers."""
        if self._payload_dir is not None:
            import shutil

            shutil.rmtree(self._payload_dir, ignore_errors=True)
            self._payload_dir = None
        if self._listener is not None:
            self._listener.close()
        if self._hostmap is not None:
            # spawned workers are reaped here; workers started by hand see
            # the listener close and exit when their reconnects run out
            self._hostmap.close()

    # ------------------------------------------------- worker processes
    def _stage_payload(self, source, artifacts) -> str:
        """Write one generation's deploy payload: every worker of it (the
        first build, a staged generation, heals, scale-ups) loads it."""
        from keystone_tpu_torch.serve.procfleet import stage_payload

        self._payload_seq += 1
        return stage_payload(self._payload_dir, self._payload_seq, source, artifacts)

    def _count_worker_install(self, handle) -> None:
        installed = int(handle.ready_info.get("artifact_buckets", 0))
        if installed:
            metrics.inc("serve.artifact_hits", installed)
        elif self._artifacts or self._staged_artifacts:
            metrics.inc("serve.artifact_fallbacks")

    def _build_process_one(self, index: int, version: str, payload_path: Optional[str] = None) -> Replica:
        """Spawn one worker process and wrap it in a routing slot; the
        ready handshake bounds the wait."""
        from keystone_tpu_torch.serve import procfleet

        opts = self._worker_opts
        t0 = time.monotonic()
        handle = procfleet.WorkerHandle(
            self.name, index, payload_path or self._payload_path, buckets=opts.get("buckets"),
            item_shape=opts.get("item_shape"), dtype=opts.get("dtype"),
            ready_timeout=opts.get("ready_timeout", procfleet.DEFAULT_READY_TIMEOUT_S),
            max_slab_bytes=opts.get("max_slab_bytes", procfleet.wire.DEFAULT_MAX_SLAB_BYTES),
            device=opts.get("device") or "cuda",
        )
        metrics.observe("serve.worker_spawn_seconds", time.monotonic() - t0)
        handle.attach_telemetry(self.telemetry)
        self._count_worker_install(handle)
        return procfleet.ProcessReplica(index, handle, version=version, pool_name=self.name,
                                        heartbeat_timeout=self._heartbeat_s)

    def _build_net_one(self, index: int, version: str, payload_path: Optional[str] = None,
                       spawn_grace_s: Optional[float] = None, allow_overflow: bool = False) -> Replica:
        """Claim (or spawn) one remote worker and deploy the staged
        generation onto it.  A pending registration (a fenced worker
        rejoining after a healed partition, or one started by hand) is
        adopted within ``spawn_grace_s`` before the host map spawns fresh
        capacity, so a heal prefers the worker that already holds this
        generation's built applier.  ``allow_overflow``: exempt the spawn
        from the host map's slot budget (a swap's workers coexist with the
        old generation's until commit)."""
        from keystone_tpu_torch.serve import net as netmod
        from keystone_tpu_torch.serve import procfleet

        opts = self._worker_opts
        with open(payload_path or self._payload_path, "rb") as f:
            payload_bytes = f.read()
        grace = float(opts.get("spawn_grace_s", 2.0)) if spawn_grace_s is None else float(spawn_grace_s)
        ready_timeout = float(opts.get("ready_timeout", procfleet.DEFAULT_READY_TIMEOUT_S))
        t0 = time.monotonic()
        pending = self._listener.next_pending(timeout=grace)
        if pending is None:
            self._hostmap.spawn(self._listener.address, allow_overflow=allow_overflow)
            pending = self._listener.next_pending(timeout=ready_timeout)
            if pending is None:
                raise procfleet.WorkerSpawnError(
                    f"{self.name}: spawned worker for slot {index} never registered within {ready_timeout:.0f}s")
        handle = netmod.deploy_worker(
            self.name, index, pending, payload_bytes, buckets=opts.get("buckets"), item_shape=opts.get("item_shape"),
            dtype=opts.get("dtype"), lease_s=float(opts.get("lease_s", netmod.DEFAULT_LEASE_S)),
            ready_timeout=ready_timeout,
            max_frame_bytes=int(opts.get("max_frame_bytes", procfleet.wire.DEFAULT_MAX_FRAME_BYTES)),
            device=opts.get("device") or "cuda",
        )
        metrics.observe("serve.worker_spawn_seconds", time.monotonic() - t0)
        handle.attach_telemetry(self.telemetry)
        self._count_worker_install(handle)
        return netmod.NetReplica(index, handle, version=version, pool_name=self.name,
                                 heartbeat_timeout=self._heartbeat_s)

    def _build_process_many(self, n: int, version: str, payload_path: Optional[str],
                            swap: bool = False) -> List[Replica]:
        """Spawn a whole generation's workers concurrently (each pays an
        interpreter, torch's import, the payload's load and its primes;
        serially a generation would take n cold starts).  On any failure
        the workers already ready are reaped before the error propagates.
        The network backend adopts already-registered workers first (no
        grace), then spawns the shortfall; ``swap``: the generation
        replaces one that holds its host-map slots until commit."""
        if self.backend == "net":
            def build(i: int) -> Replica:
                return self._build_net_one(i, version, payload_path, spawn_grace_s=0.0, allow_overflow=swap)
        else:
            def build(i: int) -> Replica:
                return self._build_process_one(i, version, payload_path)

        if n == 1:
            return [build(0)]
        from concurrent.futures import ThreadPoolExecutor

        results: List[Optional[Replica]] = [None] * n
        errors: List[BaseException] = []

        def one(i: int) -> None:
            try:
                results[i] = build(i)
            except BaseException as e:
                errors.append(e)

        with ThreadPoolExecutor(max_workers=n) as ex:
            list(ex.map(one, range(n)))
        if errors:
            for r in results:
                if r is not None:
                    r.handle.shutdown()
            raise errors[0]
        return [r for r in results if r is not None]

    # ------------------------------------------------------------ build
    def _devices_for(self, n: int, devices) -> list:
        if self.backend != "thread":
            return [None] * n  # the workers place the model
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
            if not devices:
                raise ValueError("devices must be non-empty when given")
            return [devices[i % len(devices)] for i in range(n)]
        if n == 1:
            return [None]  # single replica: no placement, no copy
        resolve_device("cuda")  # no card: the port's refusal
        count = torch.cuda.device_count()
        return [torch.device("cuda", i % count) for i in range(n)]

    def _build_one(self, source, index: int, device, version, n: int, force_clone: bool = False,
                   artifacts=_POOL_BUNDLE, payload_path: Optional[str] = None) -> Replica:
        """One replica for slot ``index``: the direct wrap for a
        one-replica deviceless pool, the copy+place path otherwise.  The
        supervisor's restarts pass ``force_clone``: the replaced worker
        may still be running inside the old applier.  ``artifacts``
        (default: the pool's bundle) is installed into the new applier;
        without one, a cloned applier that carried a verified bundle
        re-installs it (its graphs stayed with the original).  Process
        and network backends: a worker from ``payload_path`` (default:
        the live generation's), which does all of that itself."""
        if self.backend == "process":
            return self._build_process_one(index, version, payload_path=payload_path)
        if self.backend == "net":
            return self._build_net_one(index, version, payload_path=payload_path)
        if device is None and n == 1 and not force_clone:
            applier = _as_applier(source)
        else:
            applier = _as_applier(_clone_and_place(source, device), device)
        if applier.device.type == "cuda":
            # the copy and placement ran on this thread's stream: finish
            # them before the replica's own stream reads the weights (not
            # while another thread captures a bucket graph)
            with graphs.CAPTURE_LOCK:
                torch.cuda.synchronize(applier.device)
        if artifacts is _POOL_BUNDLE:
            artifacts = self._artifacts
        if not artifacts and not applier.installed_buckets():
            artifacts = applier.installed_bundle
        if artifacts:
            self._install_artifacts(applier, device, artifacts, source)
        return Replica(index, applier, device=device, version=version, pool_name=self.name,
                       heartbeat_timeout=self._heartbeat_s)

    @staticmethod
    def _source_signature(source) -> str:
        """The pipeline hash an install is verified against, from the
        pool's unplaced source (cached on it: every replica and heal
        shares one read of the weights)."""
        if isinstance(source, FrozenApplier):
            return source.fingerprint()
        from keystone_tpu_torch.utils.hashing import pipeline_fingerprint

        return pipeline_fingerprint(source)

    def _install_artifacts(self, applier, device, artifacts, source) -> int:
        """Install a bundle into one fresh applier.  Any failure (skew, a
        damaged bundle, the ``serve.artifact_load`` fault site) is counted
        as ``serve.artifact_fallbacks`` and logged, never raised: the
        replica walks.  Returns the bucket programs installed, counted as
        ``serve.artifact_hits``."""
        try:
            fault_point("serve.artifact_load")
            n = applier.install_artifacts(artifacts, device=device, signature=self._source_signature(source))
        except Exception as e:
            metrics.inc("serve.artifact_fallbacks")
            logger.warning("pool %r: artifact install failed (%s: %s); the replica walks", self.name,
                           type(e).__name__, e)
            return 0
        if n:
            metrics.inc("serve.artifact_hits", n)
        return n

    @property
    def size(self) -> int:
        return len(self.replicas)

    @property
    def has_artifacts(self) -> bool:
        """Was an artifact bundle configured for the live generation?
        (An install may still have been refused per replica: the replicas'
        ``artifact_buckets`` and the ``serve.artifact_*`` counters say.)"""
        return self._artifacts is not None

    @property
    def max_slab_bytes(self) -> int:
        """The dispatch slab cap of this fleet's workers: the ingress sizes
        its admission pool to it, so a payload it accepts is never refused
        downstream (a thread fleet reports the wire's default)."""
        cap = self._worker_opts.get("max_slab_bytes")
        if cap is not None:
            return int(cap)
        from keystone_tpu_torch.serve import wire

        return int(wire.DEFAULT_MAX_SLAB_BYTES)

    # ----------------------------------------------------------- router
    def start(self, runner: Callable, obs_context=None, on_stranded=None) -> None:
        """Start every replica worker; ``runner(replica, flush)`` is the
        service's flush body.  ``obs_context`` is restored in every worker,
        staged generations included.  ``on_stranded``: the service's
        re-dispatch of a crashed runner's flush whose slot was drained in
        the race window (a worker process's death)."""
        self._runner = runner
        self._obs_ctx = obs_context
        self._on_stranded = on_stranded
        for r in self.replicas:
            self._start_replica(r)

    def _start_replica(self, r: Replica) -> None:
        r.on_stranded = self._on_stranded
        r.start(self._runner, self._obs_ctx)

    def dispatch(self, batch) -> Replica:
        """Route one batch: least outstanding work first among routable
        replicas, skipping those whose breaker refuses (``allow()`` on the
        chosen one doubles as the half-open probe admission).  Raises
        :class:`FleetUnavailable` when no replica can serve; blocks while
        every routable replica is at the dispatch window."""
        with self._cond:
            while True:
                if self._draining:
                    # shutdown: park the batch in SOME queue so close()
                    # collects it as abandoned and fails its futures
                    order = sorted(self.replicas, key=lambda r: (r.outstanding, r.index))
                    if not order:
                        raise FleetUnavailable("replica pool is empty")
                    chosen = order[0]
                    break
                routable = [r for r in self.replicas if r.routable()]
                if not routable:
                    self._known_unavailable = True
                    raise FleetUnavailable(
                        f"fleet {self.name!r}: every replica is quarantined or dead; awaiting supervisor restart",
                        retry_after_seconds=self._retry_after_for(routable),
                    )
                if min(r.outstanding for r in routable) >= self._window:
                    # timed: a commit/complete notify can land between the
                    # predicate and the wait on another generation
                    self._cond.wait(0.05)
                    continue
                chosen = None
                for r in sorted(routable, key=lambda r: (r.outstanding, r.index)):
                    if r.breaker.allow():
                        chosen = r
                        break
                if chosen is None:
                    self._known_unavailable = True
                    eta = self._retry_after_for(routable)
                    raise FleetUnavailable(
                        f"fleet {self.name!r}: every replica breaker is open; next half-open probe in {eta:.1f}s",
                        retry_after_seconds=eta,
                    )
                break
            self._known_unavailable = False
            try:
                batch.primary = chosen.index
            except AttributeError:
                pass  # raw batches (tests) need no hedge bookkeeping
            chosen.outstanding += 1
            metrics.set_gauge("serve.replica_outstanding", chosen.outstanding, replica=chosen.index)
            # enqueue UNDER the router lock: commit() retires the old
            # generation only after taking this lock, so a batch routed to
            # an old replica is queued ahead of its retire sentinel
            chosen.enqueue(batch)
        return chosen

    def hedge_dispatch(self, batch, exclude_index: Optional[int] = None, respect_window: bool = True):
        """Best-effort second dispatch of an already-routed batch onto a
        DIFFERENT replica (hedging), or the supervisor's redistribution of
        stranded work (``respect_window=False``).  Never blocks or raises:
        returns the chosen replica, or None."""
        with self._cond:
            if self._draining:
                return None
            cands = sorted(
                (r for r in self.replicas
                 if r.index != exclude_index and r.routable()
                 and (not respect_window or r.outstanding < self._window)),
                key=lambda r: (r.outstanding, r.index),
            )
            chosen = None
            for r in cands:
                if r.breaker.allow():
                    chosen = r
                    break
            if chosen is None:
                return None
            chosen.outstanding += 1
            metrics.set_gauge("serve.replica_outstanding", chosen.outstanding, replica=chosen.index)
            chosen.enqueue(batch)
        return chosen

    def dispatch_staged(self, batch, staged) -> Optional[Replica]:
        """Best-effort dispatch onto a STAGED generation (the canary split
        of ``serve/rollout.py``): the least-outstanding routable replica
        of ``staged`` with window headroom and an admitting breaker.
        Never blocks or raises: None when no staged replica can take the
        batch (the caller serves it on the live generation).  No
        ``serve.replica_outstanding`` write: staged indices shadow live
        ones."""
        with self._cond:
            if self._draining:
                return None
            cands = sorted((r for r in staged if r.routable() and r.outstanding < self._window),
                           key=lambda r: (r.outstanding, r.index))
            chosen = None
            for r in cands:
                if r.breaker.allow():
                    chosen = r
                    break
            if chosen is None:
                return None
            try:
                batch.primary = chosen.index
            except AttributeError:
                pass
            chosen.outstanding += 1
            # enqueue under the router lock, as dispatch() does: a canary
            # flush lands ahead of abandon_staged's retire sentinel
            chosen.enqueue(batch)
        return chosen

    def abandon_staged(self, staged, timeout: float = 30.0) -> list:
        """Retire a staged generation WITHOUT committing it (a canary
        rollback): clear what :meth:`stage` captured, retire each staged
        replica (the sentinel queues behind routed canary flushes, which
        are served first), join each worker and return what it could not
        serve, for the caller to re-dispatch onto the live generation."""
        with self._cond:
            self._staged_source = None
            self._staged_artifacts = None
            self._staged_artifacts_set = False
            for r in staged:
                # under the router lock: a concurrent dispatch_staged
                # cannot slot a flush behind the sentinel
                r.retire()
        leftovers: list = []
        for r in staged:
            leftovers.extend(r.join(timeout))
        return leftovers

    # ------------------------------------------------------ availability
    def _compute_available(self) -> bool:
        with self._lock:
            replicas = list(self.replicas)
        # breaker.state(), not allow(): a poll must not consume a probe
        return any(r.routable() and r.breaker.state() != guard.OPEN for r in replicas)

    def available(self) -> bool:
        """Can the fleet accept traffic?  One attribute read while healthy;
        the full scan only while the router has flagged the fleet down."""
        if not self._known_unavailable:
            return True
        if self._compute_available():
            self._known_unavailable = False
            return True
        return False

    def available_now(self) -> bool:
        """The full availability scan, flag refreshed (health surfaces)."""
        ok = self._compute_available()
        self._known_unavailable = not ok
        return ok

    @staticmethod
    def _retry_after_for(replicas: List[Replica]) -> float:
        """The soonest half-open probe among these replicas' breakers,
        else 1 s (a supervisor restart has no fixed ETA)."""
        etas = [e for e in (r.breaker.seconds_until_probe() for r in replicas) if e > 0.0]
        return min(etas) if etas else 1.0

    def retry_after_unavailable(self) -> float:
        with self._lock:
            replicas = [r for r in self.replicas if r.routable()]
        return self._retry_after_for(replicas)

    def complete(self, replica: Replica, ok: Optional[bool]) -> None:
        """Account one finished flush and charge the breaker: ``True`` a
        success, ``False`` a failure, ``None`` neutral (nothing ran on the
        device: a shed or cancelled flush, a hedge loser)."""
        with self._cond:
            replica.outstanding = max(0, replica.outstanding - 1)
            self._cond.notify_all()
            replica.flushes += 1
            if ok is False:
                replica.errors += 1
            # gauges only for replicas still routed: a swapped-out slot's
            # late worker must not clobber its replacement's series
            live = replica in self.replicas
            if live:
                metrics.set_gauge("serve.replica_outstanding", replica.outstanding, replica=replica.index)
            metrics.inc("serve.replica_flushes", replica=replica.index)
            if ok is False:
                metrics.inc("serve.replica_errors", replica=replica.index)
            if live:
                total = sum(r.flushes for r in self.replicas) or 1
                for r in self.replicas:
                    metrics.set_gauge("serve.replica_queue_share", r.flushes / total, replica=r.index)
        if ok is True:
            replica.breaker.record_success()
        elif ok is False:
            replica.breaker.record_failure()

    # ------------------------------------------------------------- swap
    def stage(self, pipeline, version: str, artifacts: Optional[dict] = None) -> List[Replica]:
        """Build (and start) a full staged generation for ``version`` on
        the current generation's devices.  Staged replicas take priming
        applies (each captures its bucket graphs from ``artifacts``, the
        new version's bundle) but no routed traffic until :meth:`commit`,
        which makes ``artifacts`` the pool's bundle.  A single deviceless
        replica still copies: the old generation keeps serving the
        caller's applier meanwhile."""
        devices = [r.device for r in self.replicas]
        if self.backend != "thread":
            # a fresh generation of workers off a fresh payload, spawned
            # together; the old workers serve their own meanwhile
            path = self._stage_payload(pipeline, artifacts)
            staged = self._build_process_many(len(devices), version, path, swap=True)
            self._staged_payload_path = path
        else:
            staged = [self._build_one(pipeline, i, dev, version, len(devices), force_clone=True, artifacts=artifacts)
                      for i, dev in enumerate(devices)]
        self._staged_source = pipeline
        self._staged_artifacts = artifacts
        self._staged_artifacts_set = True
        if self._runner is not None:
            for r in staged:
                self._start_replica(r)
        return staged

    def commit(self, staged: List[Replica], version: str) -> float:
        """Install a staged generation; returns the swap pause in seconds
        (the router-lock-held window).  Old workers retire after the lock
        is released: they drain their queued flushes, then exit."""
        t0 = time.perf_counter()
        with self._cond:
            refused = self._draining
            if not refused:
                old, self.replicas = self.replicas, staged
                self.version = version
                if self._staged_source is not None:
                    self._source = self._staged_source
                    self._staged_source = None
                if self._staged_artifacts_set:
                    # the bundle moves with the generation: heals and
                    # scale-ups must not install the old version's
                    self._artifacts = self._staged_artifacts
                    self._staged_artifacts = None
                    self._staged_artifacts_set = False
                if self._staged_payload_path is not None:
                    # the payload moves with the generation: later heals
                    # and scale-ups spawn from the new file; the old one's
                    # workers loaded it long ago
                    old_payload, self._payload_path = self._payload_path, self._staged_payload_path
                    self._staged_payload_path = None
                    if old_payload and old_payload != self._payload_path:
                        with contextlib.suppress(OSError):
                            os.unlink(old_payload)
                self._known_unavailable = False
                pause = time.perf_counter() - t0
                self._cond.notify_all()
        if refused:
            for r in staged:
                r.retire()
            raise RuntimeError(f"replica pool {self.name!r} is closing; swap commit refused")
        for r in staged:
            # a swap is the operator's quarantine reset
            metrics.set_gauge("serve.quarantined", 0.0, replica=r.index)
        for r in old:
            r.retire()
        return pause

    # ---------------------------------------------------------- healing
    def build_replacement(self, old: Replica) -> Replica:
        """A fresh replica for ``old``'s slot, re-cloned from the pool's
        current source, worker started, NOT yet routed.  It carries the
        slot's restart count and a fresh CLOSED breaker."""
        with self._lock:
            n = len(self.replicas)
            source, version, payload = self._source, self.version, self._payload_path
        fresh = self._build_one(source, old.index, old.device, version, n, force_clone=True, payload_path=payload)
        fresh.restarts = old.restarts + 1
        if self._runner is not None:
            self._start_replica(fresh)
        return fresh

    def adopt_replacement(self, old: Replica, fresh: Replica):
        """Swap ``fresh`` into ``old``'s routing slot under the router
        lock, transferring old's queued flushes (its crash requeue
        included).  Returns None, or, when the slot is gone (a swap or
        close() raced the restart), the drained flushes for the caller."""
        with self._cond:
            # drain UNDER the router lock: dispatch selects-and-enqueues
            # holding it, so no batch can land in old behind the sentinel
            moved = old.drain_queue()
            adopted = False
            if not self._draining and old in self.replicas:
                i = self.replicas.index(old)
                self.replicas[i] = fresh
                for item in moved:
                    fresh.enqueue(item)
                fresh.outstanding = len(moved)
                metrics.set_gauge("serve.replica_outstanding", fresh.outstanding, replica=fresh.index)
                metrics.set_gauge("serve.quarantined", 0.0, replica=fresh.index)
                self._known_unavailable = False
                self._cond.notify_all()
                adopted = True
        if not adopted:
            fresh.retire()
            return moved
        old.retire()
        return None

    def quarantine_replica(self, replica: Replica) -> List:
        """Take a replica out of routing until a swap, drain its queue, and
        return the stranded flushes for the caller to re-dispatch."""
        with self._cond:
            replica.quarantined = True
            if not any(r.routable() for r in self.replicas):
                self._known_unavailable = True
            self._cond.notify_all()
        metrics.set_gauge("serve.quarantined", 1.0, replica=replica.index)
        return replica.drain_queue()

    # ---------------------------------------------------------- scaling
    @property
    def window(self) -> int:
        return self._window

    def set_window(self, n: int) -> int:
        """Retune the dispatch window live (the autoscaler's second
        lever); returns the clamped value.  A batcher blocked at the old
        window re-evaluates at once."""
        n = max(1, int(n))
        with self._cond:
            self._window = n
            self._cond.notify_all()
        metrics.set_gauge("serve.dispatch_window", float(n))
        return n

    def next_index(self) -> int:
        with self._lock:
            taken = {r.index for r in self.replicas}
        i = 0
        while i in taken:
            i += 1
        return i

    def add_replica(self, primer: Optional[Callable] = None) -> Replica:
        """Grow the fleet by one: build → ``primer(replica)`` → admit under
        the router lock, at the lowest free index and on the next device
        of the pool's cycle.  Build and prime run outside the lock."""
        with self._lock:
            if self._draining:
                raise RuntimeError(f"pool {self.name!r} is closing; scale-up refused")
            n = len(self.replicas)
            source, version, payload = self._source, self.version, self._payload_path
        index = self.next_index()
        device = self.replicas[0].device if self._devices[0] is None else self._devices[index % len(self._devices)]
        fresh = self._build_one(source, index, device, version, n + 1, force_clone=True, payload_path=payload)
        if self._runner is not None:
            self._start_replica(fresh)
        if primer is not None:
            try:
                primer(fresh)
            except BaseException:
                fresh.retire()
                raise
        with self._cond:
            admitted = not self._draining
            if admitted:
                self.replicas.append(fresh)
                self._known_unavailable = False
                self._cond.notify_all()
        if not admitted:
            fresh.retire()
            raise RuntimeError(f"pool {self.name!r} closed during scale-up")
        metrics.set_gauge("serve.workers", float(self.size))
        return fresh

    def remove_replica(self, timeout: float = 30.0) -> Optional[List]:
        """Shrink the fleet by one, gracefully: the highest-index routable
        replica leaves the routing list, drains its queue and exits.
        Returns what a worker that would not drain left behind (its
        in-hand flush included), or None at the one-replica floor."""
        with self._cond:
            cands = [r for r in self.replicas if r.routable()]
            if len(cands) <= 1 or len(self.replicas) <= 1:
                return None
            victim = max(cands, key=lambda r: r.index)
            self.replicas.remove(victim)
            self._cond.notify_all()
        victim.retire()
        left = victim.join(max(0.1, float(timeout)))
        # a thread that would not drain keeps its in-hand flush (a worker
        # process's join killed the child instead)
        if victim._worker is not None and victim._worker.is_alive() and victim.inflight is not None:
            left.append(victim.inflight)
        for gauge in ("serve.replica_outstanding", "serve.replica_queue_share"):
            metrics.REGISTRY.remove_gauge(gauge, replica=victim.index)
        metrics.set_gauge("serve.workers", float(self.size))
        return left

    # ------------------------------------------------------------ close
    def begin_drain(self) -> None:
        """Release a ``dispatch`` blocked at the window: draining, it
        parks the batch in a queue where :meth:`close` collects it."""
        with self._lock:
            self._draining = True
            self._cond.notify_all()

    def close(self, timeout: float = 30.0) -> List:
        """Retire and join every replica; returns the flushes abandoned by
        wedged workers (the service fails their futures)."""
        self.begin_drain()
        with self._lock:
            replicas = list(self.replicas)
        abandoned: List = []
        for r in replicas:
            r.retire()
        deadline = time.monotonic() + timeout
        for r in replicas:
            abandoned.extend(r.join(max(0.1, deadline - time.monotonic())))
        self._release_backend()
        return abandoned

    @property
    def host_capacity(self) -> Optional[int]:
        """The host map's total worker slots (network backend), or None
        when unbounded or another backend: the autoscaler's ceiling."""
        return None if self._hostmap is None else self._hostmap.capacity()

    @property
    def listen_address(self) -> Optional[str]:
        """``host:port`` of the worker listener (network backend): what a
        worker started by hand dials (``cli worker --connect``)."""
        return None if self._listener is None else self._listener.address

    def statuses(self) -> List[dict]:
        with self._lock:
            replicas = list(self.replicas)
        return [r.status() for r in replicas]


class ReplicaSupervisor:
    """The self-healing loop: once per ``interval`` seconds, find dead
    replica workers (the thread exited unretired: its in-hand flush was
    requeued, so a restart loses nothing) and wedged ones (alive, but
    holding one flush past the heartbeat budget: the thread cannot be
    killed, so it is swapped out of routing, its queued flushes move to
    the replacement and its in-hand flush's riders fail typed with
    :class:`FleetUnavailable`), and restart them in place: re-clone from
    the pool's source, re-prime through the service, adopt into the slot.
    ``restart_limit`` restarts within ``restart_window`` seconds
    quarantine the slot instead; a blue/green swap resets quarantine.
    Each restart is visible: ``serve.replica_restarts`` and
    ``serve.quarantined{replica=i}``, a ``replica.restart`` ledger span,
    and a flight-recorder ops span."""

    def __init__(self, service, interval: float = 0.5, restart_limit: int = 3, restart_window: float = 60.0):
        self.service = service
        self.interval = max(0.05, float(interval))
        self.restart_limit = max(1, int(restart_limit))
        self.restart_window = float(restart_window)
        self.restarts_total = 0
        self.quarantined_total = 0
        self.last_restart: Optional[dict] = None
        self._history: Dict[int, deque] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name=f"{service.name}-supervisor")

    def start(self) -> "ReplicaSupervisor":
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def status(self) -> dict:
        return {
            "interval_seconds": self.interval,
            "restart_limit": self.restart_limit,
            "restart_window_seconds": self.restart_window,
            "restarts": self.restarts_total,
            "quarantined": self.quarantined_total,
            "last_restart": self.last_restart,
        }

    def _loop(self) -> None:
        ledger.restore_context(self.service._obs_ctx)
        while not self._stop.wait(self.interval):
            try:
                self.check_now()
            except Exception:  # the healer must never die of a heal
                logger.exception("replica supervisor sweep failed")

    def check_now(self) -> int:
        """One detection sweep; returns how many replicas were healed or
        quarantined."""
        pool = self.service._pool
        with pool._lock:
            replicas = list(pool.replicas)
        healed = 0
        for r in replicas:
            if r.quarantined or r._retired:
                continue
            dead = r.is_dead()
            wedged = not dead and r.inflight is not None and r.heartbeat.expired()
            if dead or wedged:
                self._heal(r, "dead" if dead else "wedged")
                healed += 1
        return healed

    def _budget_exhausted(self, index: int) -> bool:
        hist = self._history.setdefault(index, deque())
        now = time.monotonic()
        while hist and now - hist[0] > self.restart_window:
            hist.popleft()
        return len(hist) >= self.restart_limit

    def _heal(self, replica: Replica, reason: str) -> None:
        svc = self.service
        pool = svc._pool
        if self._budget_exhausted(replica.index):
            self._quarantine(replica, reason)
            return
        self._history[replica.index].append(time.monotonic())
        # a wedged worker's in-hand flush: taken BEFORE the swap so its
        # riders can be failed (their callers are blocked on it)
        stuck = replica.inflight if reason == "wedged" else None
        t0 = time.monotonic()
        with ledger.span("replica.restart", replica=replica.index, reason=reason):
            fresh = pool.build_replacement(replica)
            try:
                svc.prime_replacement(fresh)
            except BaseException as e:
                # a replacement that cannot prime must not join the router;
                # repeated failures converge onto quarantine via the budget
                fresh.retire()
                metrics.inc("serve.replica_restart_failures", replica=replica.index)
                logger.error("replica %d restart failed to prime: %s: %s", replica.index, type(e).__name__, e)
                return
            leftover = pool.adopt_replacement(replica, fresh)
        if leftover is not None:
            # a swap/close raced the restart: redistribute the drained
            # flushes, and abandon the wedged in-hand one here (no later
            # sweep revisits the vanished slot)
            self._redistribute(leftover, replica, reason)
            if stuck is not None:
                self._abandon(stuck, replica, reason)
            return
        took = time.monotonic() - t0
        self.restarts_total += 1
        metrics.inc("serve.replica_restarts", replica=replica.index)
        self.last_restart = {
            "replica": replica.index,
            "reason": reason,
            "seconds": round(took, 3),
            "restarts_in_window": len(self._history[replica.index]),
            "error": replica.dead_error,
        }
        rec = getattr(svc, "recorder", None)
        if rec is not None:
            rec.ops("replica.restart", replica=replica.index, reason=reason, seconds=round(took, 3),
                    restarts=len(self._history[replica.index]), error=replica.dead_error)
        logger.warning("restarted %s replica %d in %.2fs (%d restart(s) in window)", reason, replica.index, took,
                       len(self._history[replica.index]))
        if stuck is not None:
            self._abandon(stuck, replica, reason)

    def _quarantine(self, replica: Replica, reason: str) -> None:
        svc = self.service
        stranded = svc._pool.quarantine_replica(replica)
        self.quarantined_total += 1
        restarts = len(self._history.get(replica.index, ()))
        ledger.event("replica.quarantine", replica=replica.index, reason=reason, restarts=restarts)
        rec = getattr(svc, "recorder", None)
        if rec is not None:
            rec.ops("replica.quarantine", replica=replica.index, reason=reason, restarts=restarts)
        logger.error("quarantined replica %d after %d restarts within %.0fs (%s)", replica.index, restarts,
                     self.restart_window, reason)
        self._redistribute(stranded, replica, "quarantined")
        stuck = replica.inflight
        if stuck is not None:
            self._abandon(stuck, replica, reason)

    def _redistribute(self, flushes: List, replica: Replica, why: str) -> None:
        """Re-dispatch flushes stranded on a healed/quarantined slot onto
        the survivors (the service's one stranded-work policy)."""
        for flush in flushes:
            self.service._handle_stranded_flush(flush, why=f"replica {replica.index} {why}")

    def _abandon(self, flush, replica: Replica, reason: str) -> None:
        """Fail a wedged worker's in-hand flush so its callers unblock;
        a claimed one may still finish, and its late delivery is dropped."""
        aborted = flush.abort()
        self.service.fail_flush(flush, FleetUnavailable(
            f"replica {replica.index} {reason}; flush abandoned ({'never ran' if aborted else 'outcome unknown'})"))
