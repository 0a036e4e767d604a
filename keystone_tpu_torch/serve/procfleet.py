"""Process-backed replicas: spawn, speak the wire protocol, supervise
(counterpart of ``keystone_tpu/serve/procfleet.py``).

The threaded fleet's replicas (``serve/fleet.py``) are threads of the
router process, so a flush's host work (the rows' copy, the walk or the
graph replay, the read-back) serializes on its GIL.  This module moves a
replica's compute into a worker process while every control-plane
invariant stays in the router as the threaded fleet has it: the batcher,
the least-outstanding router, the dispatch window, flush claims (hedges,
crash requeues), poison bisection, breakers, blue/green stage and
commit, and the supervisor all work on the same
:class:`~keystone_tpu_torch.serve.fleet.Replica` objects.  A
:class:`ProcessReplica` routes ``replica.apply`` through a
:class:`RemoteApplier`, which copies the padded host batch into a
shared-memory slab (``serve/wire.py``) and waits on the worker's
control pipe; the router's thread waits in ``recv`` with the GIL
released.

Lifecycle (thread → process):

- **spawn** — always the ``spawn`` start method: a forked child must
  never touch the parent's CUDA context.  The worker loads the staged
  payload (:func:`stage_payload`: the fitted pipeline and its artifact
  bundle) onto its device, captures its own bucket graphs as it primes,
  and answers ``ready``.
- **dead** — the child exited (crash, the kernel's OOM killer, a
  ``SIGKILL``).  A request in flight fails with :class:`WorkerCrashed`;
  the service un-claims the flush and requeues it at the front of the
  slot's queue, the slot is marked dead, and the supervisor's heal
  (build a replacement, prime it, adopt it with the queued work) serves
  it: no future is lost, as on the threaded crash path.
- **wedged** — the child hangs mid-apply: the router's thread blocks in
  ``recv`` with the flush in hand, its heartbeat goes stale and the
  supervisor's wedge detection fires unchanged; unlike a thread, the
  process is killable, and :meth:`ProcessReplica.drain_queue` kills it.
- **retire** — the router's thread drains its queue, then ``bye`` →
  join → terminate → kill reaps the child.

The worker also beats a shared-memory heartbeat (a
``multiprocessing.Value``) that ``/statusz`` reads: a child computing
slowly is told apart from a child gone.
"""

from __future__ import annotations

import logging
import os
import socket  # lint: allow-socket (gethostname only; no network use)
import threading
import time
from typing import Optional

import numpy as np

from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.serve import wire
from keystone_tpu_torch.serve.worker import process_settings, worker_main

logger = logging.getLogger(__name__)

#: default ceiling on spawn→ready (payload load + artifact install +
#: bucket priming).  Generous: a cold compile of every bucket on a
#: loaded CI box is minutes, and a spawn that outlives it is killed
#: and reported rather than silently wedging construction.
DEFAULT_READY_TIMEOUT_S = 300.0


class WorkerSpawnError(RuntimeError):
    """The worker process failed to reach ready (payload unreadable,
    import failure, ready timeout).  The spawner kills the child before
    raising — no half-born workers."""


class WorkerCrashed(OSError):
    """The worker process died with a request in flight (or refused the
    control channel).  An ``OSError`` on purpose — infrastructure, not
    content: it must never be bisected as poison.  The service layer
    treats it as the process twin of a worker-thread crash: un-claim,
    front-requeue, mark the slot dead, let the supervisor heal."""


class RemoteApplyError(RuntimeError):
    """A content-shaped failure relayed from the worker (the child's
    apply raised something outside the OSError/MemoryError families).
    A ``RuntimeError`` so ``_poison_suspect`` sees it exactly as it
    would the in-process original — bisection and poison quarantine
    work identically across the process boundary."""


class RemoteInfraError(OSError):
    """An infrastructure failure relayed from the worker (the child's
    apply raised an ``OSError``: injected faults, real I/O).  Rides
    ``OSError`` so breaker charging and bisection's infra short-circuit
    behave as in-process."""


class _HostOut:
    """Duck-typed apply result (`.array`) for the remote path — the
    service's ``_apply_rows`` tail reads ``np.asarray(out.array)``."""

    __slots__ = ("array",)

    def __init__(self, array: np.ndarray):
        self.array = array


def stage_payload(dir_path: str, seq: int, source, artifacts) -> str:
    """Write one generation's deploy payload (the fitted pipeline, its
    optional artifact bundle and the router's installed physical plan, one
    ``torch.save`` file) for its workers to
    load onto their own devices (``serve/worker.py::load_payload``):
    written once a generation, read by every worker of it (the first
    build, scale-ups, heals).  Renamed into place, so a half-written
    payload is never loaded."""
    import torch

    from keystone_tpu_torch.planner.registry import current_plan

    plan = current_plan()
    path = os.path.join(dir_path, f"payload-{int(seq)}.pt")
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save({"pipeline": source, "artifacts": artifacts, "plan": None if plan is None else plan.to_dict()}, tmp)
    os.replace(tmp, path)
    return path


class WorkerHandle:
    """Owns one worker process: the control pipe, the request slab
    pool (parent-owned), the response-slab attacher, the shared
    heartbeat, and the strict one-in-flight request lock."""

    #: same-host shared memory: a caller holding a payload that ALREADY
    #: lives in a slab (serve/ingress.py admission blocks) may ship the
    #: reference instead of the bytes — the worker attaches the segment
    #: by name.  Cross-host handles (net.NetWorkerHandle) lack this.
    accepts_slab_ref = True

    def __init__(
        self,
        name: str,
        index: int,
        payload_path: str,
        buckets=None,
        item_shape=None,
        dtype: Optional[str] = None,
        ready_timeout: float = DEFAULT_READY_TIMEOUT_S,
        max_slab_bytes: int = wire.DEFAULT_MAX_SLAB_BYTES,
        device: str = "cuda",
    ):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.name = f"{name}-worker{index}"
        self.index = int(index)
        #: fleet-telemetry sink (``serve/telemetry.py``), attached by
        #: the pool via :meth:`attach_telemetry`; None = telemetry off
        #: (shipped blobs are simply dropped — old-router behavior)
        self.telemetry = None
        #: host label for fleet metrics — the process fleet is same-box
        #: by construction
        self.peer_host = socket.gethostname()
        self._hb = ctx.Value("d", 0.0)
        parent_conn, child_conn = ctx.Pipe(duplex=True)
        self._conn = parent_conn
        self._lock = threading.Lock()
        self._pool = wire.SlabPool(
            prefix=f"{name}{index}", max_slab_bytes=max_slab_bytes
        )
        self._attacher = wire.SlabAttacher()
        self._closed = False
        spec = {
            "name": str(name),
            "index": self.index,
            "max_slab_bytes": int(max_slab_bytes),
            "payload_path": str(payload_path),
            "buckets": None if buckets is None else [int(b) for b in buckets],
            "item_shape": (
                None if item_shape is None else tuple(int(d) for d in item_shape)
            ),
            "dtype": dtype,
            "device": str(device),
            # the router's numerics: the worker's results round as its own
            **process_settings(),
            "heartbeat": self._hb,
        }
        self.proc = ctx.Process(
            target=worker_main,
            args=(child_conn, spec),
            daemon=True,
            name=self.name,
        )
        t0 = time.monotonic()
        self.proc.start()
        child_conn.close()
        try:
            ready = wire.recv_frame(self._conn, timeout=ready_timeout)
        except (TimeoutError, EOFError, OSError, wire.WireError) as e:
            self.kill()
            self._release_resources()
            raise WorkerSpawnError(
                f"{self.name}: no ready frame within {ready_timeout:.0f}s "
                f"({type(e).__name__}: {e})"
            ) from e
        if ready.get("op") == "fatal":
            self.kill()
            self._release_resources()
            raise WorkerSpawnError(
                f"{self.name}: worker failed to start "
                f"({ready.get('etype')}: {ready.get('emsg')})"
            )
        if ready.get("op") != "ready":
            self.kill()
            self._release_resources()
            raise WorkerSpawnError(
                f"{self.name}: unexpected first frame {ready.get('op')!r}"
            )
        self.ready_info = ready
        #: the worker's last kernel report (``serve/worker.py::kernel_report``):
        #: its wrappers' launches, graph replays and peak reserved memory
        self.kernels = (ready.get("telemetry") or {}).get("kernels")
        self.spawn_seconds = time.monotonic() - t0
        #: the ready exchange's telemetry (load/build/prime spans), held
        #: until a sink is attached — the pool attaches one right after
        #: construction, so cold-start spans are not lost to ordering
        self._pending_ready = (t0, time.monotonic(), ready.get("telemetry"))
        #: installed AOT program keys, for honest prime-source labels
        self.artifact_keys = {
            (tuple(shape), str(dt))
            for shape, dt in ready.get("artifact_keys", ())
        }

    # --------------------------------------------------------- telemetry
    def attach_telemetry(self, sink) -> None:
        """Wire this handle to the pool's fleet-telemetry sink and
        flush the ready exchange's shipment (spawn-time spans).  Safe
        with ``sink=None`` (telemetry stays off)."""
        self.telemetry = sink
        pending, self._pending_ready = getattr(
            self, "_pending_ready", None
        ), None
        if sink is None or pending is None:
            return
        t_send, t_recv, shipped = pending
        sink.on_exchange(self.name, self.peer_host, t_send, t_recv, shipped)

    def _ship_reply_telemetry(self, reply, t_send, t_recv, trace) -> None:
        """Hand one reply's shipped telemetry to the sink (never raises
        into the request path — the sink swallows malformed blobs)."""
        if not isinstance(reply, dict):
            return
        shipped = reply.get("telemetry")
        if isinstance(shipped, dict) and shipped.get("kernels") is not None:
            self.kernels = shipped["kernels"]
        sink = self.telemetry
        if sink is not None and shipped is not None:
            sink.on_exchange(
                self.name, self.peer_host, t_send, t_recv, shipped, trace=trace
            )

    # ---------------------------------------------------------- liveness
    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.is_alive()

    def heartbeat_age(self) -> Optional[float]:
        """Seconds since the child's last beat (None before the first).
        CLOCK_MONOTONIC is system-wide on Linux, so the comparison is
        sound across the process boundary."""
        v = self._hb.value
        if v <= 0.0:
            return None
        return max(0.0, time.monotonic() - v)

    # ----------------------------------------------------------- request
    def apply(
        self,
        arr: np.ndarray,
        n: int,
        deadline_s: Optional[float] = None,
        slab_ref: Optional[dict] = None,
        trace: Optional[dict] = None,
    ) -> np.ndarray:
        """One remote apply: copy into a slab, frame, wait, read the
        result slab.  Raises the relayed typed error, or
        :class:`WorkerCrashed` when the child died mid-request.
        (Prime/live distinction stays router-side: ``Replica.apply``
        consumes ``prime`` to skip the fault site; the worker's apply
        is identical either way.)

        ``slab_ref``: the batch already lives in a shared-memory slab
        the CALLER owns (an ingress admission block) — ship the
        reference and skip the dispatch memcpy entirely.  The caller
        must keep the slab alive until this returns (it does: the
        request is strictly one-in-flight and blocks for the reply).

        ``trace``: optional trace context (``{"batch": ..,
        "request_ids": [..]}``) carried as a frame body key — absent
        when the recorder is off (the frame is byte-identical to the
        pre-trace wire), ignored by an old worker when present."""
        msg = {"op": "apply", "n": int(n), "deadline_s": deadline_s}
        if trace is not None:
            msg["trace"] = trace
        if slab_ref is not None:
            reply, out = self._request(msg, ref=slab_ref, trace=trace)
        else:
            reply, out = self._request(msg, arr=arr, trace=trace)
        return out

    def ping(self) -> dict:
        reply, _ = self._request({"op": "ping"})
        return reply

    def _request(
        self,
        msg: dict,
        arr: Optional[np.ndarray] = None,
        ref: Optional[dict] = None,
        trace: Optional[dict] = None,
    ):
        with self._lock:
            if self._closed:
                raise WorkerCrashed(f"{self.name}: handle is closed")
            slab = None
            try:
                if ref is not None:
                    # pre-slabbed payload: the reference rides the
                    # control frame, zero dispatch bytes copied
                    msg = dict(msg, ref=ref)
                elif arr is not None:
                    slab, ref_ = wire.write_array(self._pool, arr)
                    metrics.inc("dispatch.bytes_copied", int(arr.nbytes))
                    msg = dict(msg, ref=ref_)
                t_send = time.monotonic()
                try:
                    wire.send_frame(self._conn, msg)
                    reply = wire.recv_frame(self._conn)
                except (EOFError, OSError, wire.WireError) as e:
                    raise WorkerCrashed(
                        f"{self.name} (pid {self.pid}) died mid-request "
                        f"({type(e).__name__}: {e})"
                    ) from e
                # error replies ship telemetry too: a failing apply is
                # exactly the span an operator wants on /requestz
                self._ship_reply_telemetry(
                    reply, t_send, time.monotonic(), trace
                )
            finally:
                if slab is not None:
                    # the child copies at use and has answered: the
                    # request slab is reusable now
                    self._pool.release(slab)
            if reply.get("op") == "error":
                raise self._map_error(reply)
            if reply.get("op") == "result":
                out = self._attacher.read(reply["ref"])
                return reply, out
            return reply, None

    @staticmethod
    def _map_error(reply: dict) -> BaseException:
        """Rehydrate the worker's typed failure on the router side,
        preserving the error taxonomy bisection and breakers key on."""
        from keystone_tpu_torch.utils import guard

        kind = reply.get("kind", "content")
        detail = f"{reply.get('etype')}: {reply.get('emsg')}"
        if kind == "too_large":
            # the worker's RESULT overflowed the slab cap: the same
            # typed refusal a request-side overflow raises (ValueError
            # family — the client's payload shape is the cause; a
            # bisected sub-batch whose output fits will simply succeed)
            return wire.PayloadTooLarge(f"remote apply result: {detail}")
        if kind == "deadline":
            return guard.DeadlineExceeded(
                f"remote apply: {detail}", float(reply.get("seconds") or 0.0)
            )
        if kind == "circuit":
            return guard.CircuitOpenError(f"remote apply: {detail}")
        if kind == "memory":
            return MemoryError(f"remote apply: {detail}")
        if kind == "oserror":
            return RemoteInfraError(f"remote apply: {detail}")
        return RemoteApplyError(f"remote apply: {detail}")

    # ---------------------------------------------------------- shutdown
    def kill(self) -> None:
        """SIGKILL the child (the wedge/quarantine path, and chaos's
        process-kill action).  A parent thread blocked in ``recv``
        unblocks with EOF → :class:`WorkerCrashed`."""
        p = self.proc
        try:
            if p.is_alive():
                p.kill()
            p.join(5.0)
        except (OSError, ValueError, AssertionError):
            pass

    def shutdown(self, timeout: float = 3.0) -> None:
        """Graceful-then-forceful reap: ``bye`` (if the channel is
        idle), join, terminate, kill — then release pipe + slabs.
        Idempotent; called from the parent worker thread's exit hook
        and from pool close."""
        if self._closed:
            return
        got = self._lock.acquire(timeout=max(0.0, timeout) / 3.0)
        try:
            if got and self.proc.is_alive():
                try:
                    wire.send_frame(self._conn, {"op": "bye"})
                    wire.recv_frame(self._conn, timeout=max(0.2, timeout / 3.0))
                except (
                    TimeoutError,
                    EOFError,
                    OSError,
                    wire.WireError,
                ):
                    pass
        finally:
            if got:
                self._lock.release()
        try:
            self.proc.join(max(0.2, timeout / 3.0))
            if self.proc.is_alive():
                self.proc.terminate()
                self.proc.join(max(0.2, timeout / 3.0))
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join(2.0)
        except (OSError, ValueError, AssertionError):
            pass
        self._release_resources()

    def _release_resources(self) -> None:
        self._closed = True
        try:
            self._conn.close()
        except OSError:
            pass
        exitcode = self.proc.exitcode
        if exitcode not in (0, None):
            # the child died without its own cleanup (SIGKILL, crash):
            # reap its orphaned response slabs from this side
            self._attacher.unlink_all()
        else:
            self._attacher.close()
        self._pool.close()

    def stats(self) -> dict:
        return {
            "pid": self.pid,
            "alive": self.alive(),
            "heartbeat_age_s": self.heartbeat_age(),
            "spawn_seconds": round(self.spawn_seconds, 3),
            "slabs": self._pool.stats(),
            "kernels": self.kernels,
        }


class RemoteApplier:
    """The applier-contract shim a :class:`ProcessReplica` carries: the
    padded host batch goes to the worker over shared memory; the result
    comes back the same way.  Accepts a raw padded ndarray (the fast
    path — the service skips the parent-side device transfer entirely
    for remote replicas) or anything with ``.array``/``.n``."""

    #: duck-typed markers: never re-wrap (fleet._as_applier), and the
    #: service's _apply_rows takes the host fast path
    serve_applier = True
    remote_worker = True

    def __init__(self, handle: WorkerHandle):
        self.handle = handle

    @property
    def accepts_slab_ref(self) -> bool:
        """Capability marker the service's dispatch gate reads: True
        exactly when the HANDLE can attach a caller-owned slab by name
        (same-host process workers; cross-host net handles cannot)."""
        return bool(getattr(self.handle, "accepts_slab_ref", False))

    def __call__(self, x, deadline=None, n=None, slab_ref=None, trace=None, **kw):
        if kw:
            # multi-tenant segment kwargs need in-process walks; the
            # service refuses workers>0 for multi-tenant deploys
            raise TypeError(
                f"remote apply does not support kwargs {sorted(kw)}"
            )
        if hasattr(x, "array"):
            arr = np.asarray(x.array)
            if n is None:
                n = getattr(x, "n", arr.shape[0])
        else:
            arr = np.ascontiguousarray(x)
            if n is None:
                n = arr.shape[0]
        deadline_s = None
        if deadline is not None:
            deadline_s = max(0.0, deadline.remaining())
        if slab_ref is not None and self.accepts_slab_ref:
            out = self.handle.apply(
                arr, int(n), deadline_s, slab_ref=slab_ref, trace=trace
            )
        else:
            out = self.handle.apply(arr, int(n), deadline_s, trace=trace)
        return _HostOut(out)

    # ------------------------------------------------- status/prime hooks
    def installed_buckets(self) -> int:
        return int(self.handle.ready_info.get("artifact_buckets", 0))

    def has_bucket_program(self, shape, dtype) -> bool:
        return (tuple(shape), np.dtype(dtype).str) in self.handle.artifact_keys


from keystone_tpu_torch.serve.fleet import Replica  # noqa: E402


class ProcessReplica(Replica):
    """A routing slot whose compute lives in a worker process.  All
    queue/claim/breaker/heartbeat semantics are inherited — only the
    lifecycle edges differ (see module docstring)."""

    def __init__(
        self,
        index: int,
        handle: WorkerHandle,
        version: str = "v0",
        pool_name: str = "serve",
        heartbeat_timeout: float = 30.0,
    ):
        super().__init__(
            index,
            RemoteApplier(handle),
            device=None,
            version=version,
            pool_name=pool_name,
            heartbeat_timeout=heartbeat_timeout,
        )
        self.handle = handle
        self._shutdown_once = threading.Lock()
        self._shut = False

    # ------------------------------------------------------------ health
    def is_dead(self) -> bool:
        """Dead = the parent worker thread crashed (base), OR the child
        process exited while the slot is still live — an idle child
        SIGKILLed between flushes must be healed without waiting for
        the next dispatch to discover the corpse."""
        if super().is_dead():
            return True
        return not (self._retired or self.quarantined) and not self.handle.alive()

    # --------------------------------------------------------- lifecycle
    def _on_worker_exit(self) -> None:
        """Parent worker thread exit hook (sentinel drain or crash):
        reap the child.  Graceful first — a swap-retired worker has
        just finished draining its queue and the child is idle."""
        self._shutdown_handle()

    def _shutdown_handle(self) -> None:
        with self._shutdown_once:
            if self._shut:
                return
            self._shut = True
        self.handle.shutdown()

    def drain_queue(self):
        """The supervisor's decommission drain (heal/quarantine): after
        taking the queue, a child still holding a flush is KILLED so
        the blocked parent thread unblocks (EOF → WorkerCrashed) and
        the hung compute stops occupying a core.  Never called on the
        graceful swap/scale-down path (that's ``retire``)."""
        left = super().drain_queue()
        if self.inflight is not None and self.handle.alive():
            logger.warning(
                "killing wedged worker process %s (pid %s)",
                self.handle.name,
                self.handle.pid,
            )
            self.handle.kill()
        return left

    def join(self, timeout: float):
        left = super().join(timeout)
        w = self._worker
        if w is not None and w.is_alive():
            # the parent thread is stuck in a remote call: kill the
            # child to EOF it loose, then give it a moment
            self.handle.kill()
            w.join(2.0)
        self._shutdown_handle()
        return left

    def status(self) -> dict:
        out = super().status()
        out["backend"] = "process"
        out.update(
            {
                "pid": self.handle.pid,
                "worker_alive": self.handle.alive(),
                "worker_heartbeat_age_s": (
                    None
                    if (age := self.handle.heartbeat_age()) is None
                    else round(age, 3)
                ),
            }
        )
        out["artifact_buckets"] = self.applier.installed_buckets()
        kern = self.handle.kernels or {}
        out["worker_device"] = kern.get("device")
        out["worker_peak_reserved_bytes"] = kern.get("peak_reserved_bytes")
        return out
