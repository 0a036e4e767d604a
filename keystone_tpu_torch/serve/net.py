"""The network fleet: the worker wire contract over TCP, lease-fenced
(counterpart of ``keystone_tpu/serve/net.py``).

The process fleet's transport (shared-memory slabs and a
``multiprocessing`` pipe, ``serve/procfleet.py``) ends at the host.
This module carries the same
:class:`~keystone_tpu_torch.serve.procfleet.WorkerHandle` contract over a
socket (stream frames: length-prefixed, CRC-checked, payload bytes
inline; ``serve/wire.py``), into a failure domain with partitions,
half-open connections, retransmits and split brain after a heal:

- **Heartbeat lease.**  Both sides beat every ``lease_s / 4``; each
  reads ``lease_s`` of inbound silence as the other's death.  The
  ROUTER marks the worker dead (an apply in flight raises
  :class:`~keystone_tpu_torch.serve.procfleet.WorkerCrashed`, the service
  un-claims and requeues the flush, and the supervisor heals onto a new
  worker, as for a killed process).  The WORKER **self-fences**: when
  its lease lapses mid-compute it discards the finished result, closes
  the socket and dials back for a fresh lease, so a healed partition
  cannot serve a flush twice.
- **Idempotent dispatch.**  Every apply carries a flush id.  While a
  reply is pending the router resends the apply every ``lease_s / 2``
  (``serve.net.retransmits``): a partition can eat one frame and heal
  inside the lease.  The worker answers a repeated id from its
  last-reply cache, and the router discards a result whose id is not
  the one in flight (``serve.net.late_discards``): at-least-once
  dispatch, exactly-once effect.
- **Typed infrastructure errors.**  Connection failures ride the
  ``OSError`` family (:class:`WorkerCrashed`, ``FaultInjected``,
  ``ConnectionError``), so breakers, bisection and hedging behave as
  on one host.
- **Fault sites.**  ``serve.net.connect`` / ``serve.net.send`` /
  ``serve.net.recv`` fire per dial and per frame, with ctx
  ``link=<worker name>`` and ``role=router|worker``.  ``drop`` (alias
  ``partition``) discards the frame silently, detected only by lease
  expiry; ``corrupt`` flips a byte so the peer's CRC check condemns the
  connection.

Topology: the router owns a :class:`WorkerListener`; workers dial in
(``python -m keystone_tpu_torch.cli worker --connect HOST:PORT``) and say
``hello``.  The router deploys a generation by streaming the staged
payload's bytes (the worker loads them onto the device the deploy spec
names, the card by default, and caches the built applier by the
payload's digest, so a fenced worker's rejoin skips the rebuild and its
bucket graphs stay captured), then serves the one-in-flight apply
protocol.  Local and remote capacity are spawned through
:class:`~keystone_tpu_torch.utils.hostmap.HostMap`.

``workers=N`` without ``hosts=`` never touches this module.
"""

from __future__ import annotations

import hashlib
import logging
import os
import socket
import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from keystone_tpu_torch import faults
from keystone_tpu_torch.serve import wire
from keystone_tpu_torch.serve.procfleet import (
    RemoteApplier,
    WorkerCrashed,
    WorkerSpawnError,
    WorkerHandle,
)

logger = logging.getLogger(__name__)

#: default lease: either side reads this much inbound silence as the
#: other's death.  Beats go out at lease/4, so a healthy link delivers
#: ~4 proofs of life per lease window — one lost beat never fences.
DEFAULT_LEASE_S = 5.0

#: floor on the beat interval (a tiny test lease must not busy-spin)
MIN_BEAT_INTERVAL_S = 0.05

#: ceiling on connect→hello for an accepted connection; a client that
#: dials and says nothing is not a worker
HELLO_TIMEOUT_S = 10.0

#: worker-side dial attempts before giving up on the router
DEFAULT_CONNECT_ATTEMPTS = 30

#: the cap on a deploy frame, which carries a whole staged payload (the
#: full-width scorer's weights alone are 262 MB); the u32 lengths bound
#: any frame below 4 GiB
DEPLOY_MAX_FRAME_BYTES = (1 << 32) - 1


def parse_address(address: str) -> Tuple[str, int]:
    """``HOST:PORT`` → ``(host, port)``; the one place the CLI grammar
    is interpreted."""
    host, _, port = str(address).rpartition(":")
    if not host or not port:
        raise ValueError(f"address must be HOST:PORT, got {address!r}")
    return host, int(port)


def payload_digest(payload_bytes: bytes) -> str:
    """Content address of a staged generation's payload — the worker's
    applier-reuse key (a fenced worker rejoining the SAME generation
    skips the rebuild + re-prime entirely)."""
    return hashlib.blake2b(payload_bytes, digest_size=16).hexdigest()


def _beat_interval(lease_s: float) -> float:
    return max(MIN_BEAT_INTERVAL_S, float(lease_s) / 4.0)


def _corrupt_frame(data: bytes) -> bytes:
    """The ``corrupt`` wire action: flip a byte inside the CRC-covered
    region so the receiver rejects the frame as damaged in flight."""
    buf = bytearray(data)
    buf[-1] ^= 0xFF
    return bytes(buf)


# ---------------------------------------------------------------- listener


class WorkerListener:
    """The router's accept side: workers dial in, say ``hello``, and
    wait in a pending queue until a deploy claims them.  Handshakes run
    off-thread so one slow or foreign client never stalls accepts."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        backlog: int = 16,
        hello_timeout: float = HELLO_TIMEOUT_S,
    ):
        self._hello_timeout = float(hello_timeout)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(int(backlog))
        self.host, self.port = self._sock.getsockname()[:2]
        self._cond = threading.Condition()
        self._pending: Deque[Tuple[socket.socket, dict]] = deque()
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="net-accept"
        )
        self._accept_thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return  # listener closed
            threading.Thread(
                target=self._handshake,
                args=(conn, addr),
                daemon=True,
                name="net-hello",
            ).start()

    def _handshake(self, conn: socket.socket, addr) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # the socket timeout is the SEND budget only — reads wait
            # via select and never touch it (wire.SEND_TIMEOUT_S)
            conn.settimeout(wire.SEND_TIMEOUT_S)
            hello, _ = wire.recv_stream_frame(conn, timeout=self._hello_timeout)
            if hello.get("op") != "hello" or hello.get("protocol") != wire.SOCKET_VERSION:
                raise wire.WireError(
                    f"bad hello from {addr}: {hello.get('op')!r}"
                )
            # a partition severs the rejoin path too: a dropped hello
            # means this connection never registers
            act = faults.fault_point(
                "serve.net.recv",
                role="router",
                link=hello.get("name"),
                op="hello",
            )
            if act is not None:
                raise wire.WireError(f"hello {act}ped by fault plan")
        except (TimeoutError, EOFError, OSError, wire.WireError, ValueError) as e:
            logger.warning("worker handshake from %s failed: %s", addr, e)
            try:
                conn.close()
            except OSError:
                pass
            return
        from keystone_tpu_torch.obs import metrics

        metrics.inc("serve.net.registrations")
        with self._cond:
            if self._closed:
                try:
                    conn.close()
                except OSError:
                    pass
                return
            self._pending.append((conn, hello))
            self._cond.notify_all()
        logger.info(
            "worker %s (pid %s) registered from %s",
            hello.get("name"),
            hello.get("pid"),
            addr,
        )

    def next_pending(
        self, timeout: Optional[float] = None
    ) -> Optional[Tuple[socket.socket, dict]]:
        """Pop one handshaked connection, waiting up to ``timeout``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._pending:
                if self._closed:
                    return None
                remain = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remain is not None and remain <= 0:
                    return None
                self._cond.wait(remain if remain is not None else 1.0)
            return self._pending.popleft()

    def pending_count(self) -> int:
        with self._cond:
            return len(self._pending)

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            pending, self._pending = list(self._pending), deque()
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass
        for conn, _ in pending:
            try:
                conn.close()
            except OSError:
                pass
        self._accept_thread.join(2.0)


# ------------------------------------------------------------ router side


class NetWorkerHandle:
    """Owns one REMOTE worker's connection: deploy handshake, the
    strict one-in-flight request slot, the reader thread (beats,
    results, late-result discards), the outbound beat thread, and the
    lease clock.  Duck-type-compatible with
    :class:`~keystone_tpu_torch.serve.procfleet.WorkerHandle` everywhere the
    fleet touches it (``apply`` / ``alive`` / ``heartbeat_age`` /
    ``kill`` / ``shutdown`` / ``ready_info`` / ``artifact_keys``), so
    :class:`~keystone_tpu_torch.serve.procfleet.RemoteApplier` and the
    service's remote fast path work unchanged."""

    def __init__(
        self,
        name: str,
        index: int,
        sock: socket.socket,
        hello: dict,
        payload_bytes: bytes,
        buckets=None,
        item_shape=None,
        dtype: Optional[str] = None,
        lease_s: float = DEFAULT_LEASE_S,
        ready_timeout: float = 300.0,
        max_frame_bytes: int = wire.DEFAULT_MAX_FRAME_BYTES,
        device: str = "cuda",
    ):
        from keystone_tpu_torch.serve.worker import process_settings

        self.name = f"{name}-net{index}"
        self.index = int(index)
        self.lease_s = float(lease_s)
        self.max_frame_bytes = int(max_frame_bytes)
        self.hello = dict(hello)
        #: fleet-telemetry sink (``serve/telemetry.py``), attached by
        #: the pool via :meth:`attach_telemetry`; None = telemetry off
        self.telemetry = None
        self._sock = sock
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()  # strict one-in-flight
        self._resp_cond = threading.Condition()
        self._pending_fid: Optional[str] = None
        self._reply: Optional[Tuple[dict, bytes]] = None
        self._bye_ack = threading.Event()
        self._seq = 0
        self._closed = False
        self._dead: Optional[str] = None
        self._last_rx = time.monotonic()
        spec = {
            "name": self.name,
            "index": self.index,
            "buckets": None if buckets is None else [int(b) for b in buckets],
            "item_shape": (
                None
                if item_shape is None
                else list(int(d) for d in item_shape)
            ),
            "dtype": dtype,
            "device": str(device),
            **process_settings(),
            "lease_s": self.lease_s,
            "max_frame_bytes": self.max_frame_bytes,
            "digest": payload_digest(payload_bytes),
        }
        t0 = time.monotonic()
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(wire.SEND_TIMEOUT_S)
            self._raw_send({"op": "deploy", "spec": spec}, payload_bytes)
            ready, _ = wire.recv_stream_frame(
                sock, timeout=ready_timeout, max_frame_bytes=self.max_frame_bytes
            )
        except (TimeoutError, EOFError, OSError, wire.WireError) as e:
            self.kill()
            raise WorkerSpawnError(
                f"{self.name}: no ready frame within {ready_timeout:.0f}s "
                f"({type(e).__name__}: {e})"
            ) from e
        if ready.get("op") == "fatal":
            self.kill()
            raise WorkerSpawnError(
                f"{self.name}: worker failed to start "
                f"({ready.get('etype')}: {ready.get('emsg')})"
            )
        if ready.get("op") != "ready":
            self.kill()
            raise WorkerSpawnError(
                f"{self.name}: unexpected first frame {ready.get('op')!r}"
            )
        self.ready_info = ready
        #: the worker's last kernel report (``serve/worker.py::kernel_report``)
        self.kernels = (ready.get("telemetry") or {}).get("kernels")
        self.spawn_seconds = time.monotonic() - t0
        #: the deploy→ready exchange's telemetry (remote build/prime
        #: spans + first clock sample), flushed when the pool attaches
        #: its sink
        self._pending_ready = (t0, time.monotonic(), ready.get("telemetry"))
        self.artifact_keys = {
            (tuple(shape), str(dt))
            for shape, dt in ready.get("artifact_keys", ())
        }
        self._last_rx = time.monotonic()
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name=f"{self.name}-rx"
        )
        self._reader.start()
        self._beater = threading.Thread(
            target=self._beat_loop, daemon=True, name=f"{self.name}-beat"
        )
        self._beater.start()

    # --------------------------------------------------------- telemetry
    def attach_telemetry(self, sink) -> None:
        """Wire this handle to the pool's fleet-telemetry sink and
        flush the deploy→ready exchange's shipment.  Safe with
        ``sink=None``."""
        self.telemetry = sink
        pending, self._pending_ready = getattr(
            self, "_pending_ready", None
        ), None
        if sink is None or pending is None:
            return
        t_send, t_recv, shipped = pending
        sink.on_exchange(self.name, self.peer_host, t_send, t_recv, shipped)

    def _ship_reply_telemetry(self, reply, t_send, t_recv, trace) -> None:
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
        return self.hello.get("pid")

    @property
    def peer_host(self) -> Optional[str]:
        return self.hello.get("host")

    def alive(self) -> bool:
        """Alive = channel open AND the lease is fresh.  An expired
        lease IS death: the supervisor heals on it exactly as it would
        a SIGKILLed local worker, whether or not TCP still pretends the
        connection is up (half-open connections lie; leases don't)."""
        if self._closed or self._dead is not None:
            return False
        return (time.monotonic() - self._last_rx) <= self.lease_s

    def heartbeat_age(self) -> Optional[float]:
        return max(0.0, time.monotonic() - self._last_rx)

    def lease_expired(self) -> bool:
        return (time.monotonic() - self._last_rx) > self.lease_s

    # ------------------------------------------------------------- frames
    def _raw_send(self, msg: dict, payload: bytes = b"") -> None:
        data = wire.pack_stream_frame(msg, payload)
        with self._send_lock:
            self._sock.sendall(data)

    def _send(self, msg: dict, payload: bytes = b"") -> None:
        """One outbound frame through the ``serve.net.send`` site: a
        ``drop`` verdict silently discards it (partition semantics), a
        ``corrupt`` verdict damages it so the worker's CRC check
        condemns the link."""
        act = faults.fault_point(
            "serve.net.send", role="router", link=self.name, op=msg.get("op")
        )
        if act == "drop":
            return
        data = wire.pack_stream_frame(msg, payload)
        if act == "corrupt":
            data = _corrupt_frame(data)
        with self._send_lock:
            self._sock.sendall(data)

    def _mark_dead(self, reason: str) -> None:
        with self._resp_cond:
            if self._dead is None:
                self._dead = reason
            self._resp_cond.notify_all()

    def _read_loop(self) -> None:
        """The ONLY socket reader: beats refresh the lease, results
        fill the one pending slot, anything else is discarded loudly.
        The thread outlives a lease-expiry ``WorkerCrashed`` on purpose
        — that is the window where a fenced worker's late result must
        be OBSERVED and discarded, not left unread."""
        from keystone_tpu_torch.obs import metrics

        while not self._closed:
            try:
                msg, payload = wire.recv_stream_frame(
                    self._sock,
                    timeout=0.25,
                    max_frame_bytes=self.max_frame_bytes,
                )
            except TimeoutError:
                continue
            except (EOFError, OSError, wire.WireError) as e:
                if not self._closed:
                    self._mark_dead(f"{type(e).__name__}: {e}")
                return
            act = faults.fault_point(
                "serve.net.recv",
                role="router",
                link=self.name,
                op=msg.get("op"),
            )
            if act == "drop":
                continue  # the frame never arrived
            if act == "corrupt":
                # damaged arrival: the channel is condemned, exactly as
                # if the CRC check had caught it
                self._mark_dead("injected frame corruption on recv")
                return
            self._last_rx = time.monotonic()
            op = msg.get("op")
            if op == "beat":
                shipped = msg.get("telemetry")
                sink = self.telemetry
                if shipped is not None and sink is not None:
                    # worker metrics deltas piggyback on the beats the
                    # worker already sends — no extra frames, and an
                    # old worker (no telemetry key) is simply silent
                    sink.on_beat(self.name, self.peer_host, shipped)
                continue
            if op == "bye_ack":
                self._bye_ack.set()
                continue
            if op in ("result", "error"):
                with self._resp_cond:
                    if (
                        self._pending_fid is not None
                        and msg.get("fid") == self._pending_fid
                    ):
                        self._reply = (msg, payload)
                        self._resp_cond.notify_all()
                        continue
                # a result nobody is waiting for: the flush was already
                # re-dispatched after this worker's lease expired — the
                # fenced loser's work is a discarded no-op
                metrics.inc("serve.net.late_discards", worker=self.name)
                logger.warning(
                    "%s: discarding late %s for flush %s (lease was "
                    "forfeited; the flush re-served elsewhere)",
                    self.name,
                    op,
                    msg.get("fid"),
                )
                continue
            logger.warning("%s: ignoring unexpected frame %r", self.name, op)

    def _beat_loop(self) -> None:
        interval = _beat_interval(self.lease_s)
        while not self._closed and self._dead is None:
            try:
                self._send({"op": "beat"})
            except OSError as e:
                if not self._closed:
                    self._mark_dead(f"beat send failed: {e}")
                return
            time.sleep(interval)

    # ----------------------------------------------------------- request
    def apply(
        self,
        arr: np.ndarray,
        n: int,
        deadline_s: Optional[float] = None,
        trace: Optional[dict] = None,
    ) -> np.ndarray:
        """One remote apply: frame the padded batch inline, wait for the
        matching flush id.  Raises the relayed typed error, or
        :class:`WorkerCrashed` when the channel died or the lease
        expired mid-request — the un-claim/front-requeue/heal path.

        ``trace``: optional trace context carried as a frame body key —
        absent when the recorder is off, ignored by an old worker."""
        meta, payload = wire.array_payload(arr)
        if len(payload) > self.max_frame_bytes:
            raise wire.PayloadTooLarge(
                f"payload of {len(payload)} bytes exceeds the frame cap "
                f"({self.max_frame_bytes}); refused at dispatch"
            )
        with self._lock:
            if self._closed or self._dead is not None:
                raise WorkerCrashed(
                    f"{self.name}: channel is down ({self._dead or 'closed'})"
                )
            self._seq += 1
            fid = f"{self.name}-f{self._seq}"
            with self._resp_cond:
                self._pending_fid = fid
                self._reply = None
            try:
                frame = {
                    "op": "apply",
                    "fid": fid,
                    "n": int(n),
                    "deadline_s": deadline_s,
                    "meta": meta,
                }
                if trace is not None:
                    frame["trace"] = trace
                t_send = time.monotonic()
                try:
                    self._send(frame, payload)
                except OSError as e:
                    self._mark_dead(f"send failed: {e}")
                    raise WorkerCrashed(
                        f"{self.name}: apply send failed ({e})"
                    ) from e
                reply, rpayload = self._wait_reply(fid, frame, payload)
                # the clock-sync sample pairs this side's FIRST send
                # with the reply arrival; a reply to a retransmit only
                # inflates the measured delay, and an inflated sample
                # loses the min-delay race instead of skewing the offset
                self._ship_reply_telemetry(
                    reply, t_send, time.monotonic(), trace
                )
            finally:
                with self._resp_cond:
                    self._pending_fid = None
                    self._reply = None
        if reply.get("op") == "error":
            raise WorkerHandle._map_error(reply)
        try:
            return wire.payload_array(reply["meta"], rpayload)
        except (KeyError, wire.WireError) as e:
            self._mark_dead(f"malformed result: {e}")
            raise WorkerCrashed(
                f"{self.name}: malformed result frame ({e})"
            ) from e

    def _wait_reply(
        self,
        fid: str,
        frame: Optional[dict] = None,
        payload: bytes = b"",
    ) -> Tuple[dict, bytes]:
        """Block until the matching reply, the channel's death, or
        lease expiry.  No wall-clock cap beyond the lease: a worker
        that is computing keeps beating, and a beating worker holds its
        lease — the deadline belongs to the worker's own guard.

        While waiting, the request frame is RETRANSMITTED every
        ``lease_s / 2``: beats prove the peer is alive, not that this
        frame arrived, and a partition can eat exactly one frame and
        heal inside the lease window — without retransmission that
        lost apply would wait forever behind a healthy heartbeat.  The
        worker's last-reply cache makes a duplicate arrival a cached
        resend, never a recompute."""
        from keystone_tpu_torch.obs import metrics

        interval = max(MIN_BEAT_INTERVAL_S, self.lease_s / 2.0)
        next_tx = time.monotonic() + interval
        while True:
            with self._resp_cond:
                if self._reply is not None:
                    return self._reply
                if self._closed or self._dead is not None:
                    raise WorkerCrashed(
                        f"{self.name} died mid-request "
                        f"({self._dead or 'closed'})"
                    )
                if self.lease_expired():
                    # the pending slot clears in apply's finally, so a
                    # result that limps in later is a LATE result and
                    # the reader discards it
                    raise WorkerCrashed(
                        f"{self.name}: lease expired mid-request "
                        f"({self.lease_s:.2f}s of silence) — flush {fid} "
                        f"forfeited for re-dispatch"
                    )
                self._resp_cond.wait(0.05)
                if self._reply is not None:
                    return self._reply
            if frame is not None and time.monotonic() >= next_tx:
                next_tx = time.monotonic() + interval
                metrics.inc("serve.net.retransmits", worker=self.name)
                try:
                    self._send(frame, payload)
                except OSError as e:
                    self._mark_dead(f"retransmit failed: {e}")

    # ---------------------------------------------------------- shutdown
    def kill(self) -> None:
        """Sever the channel (wedge/quarantine path).  A waiter
        unblocks with :class:`WorkerCrashed`; the worker side sees EOF
        (or fences on silence) and dials back for a fresh lease."""
        self._closed = True
        self._mark_dead(self._dead or "killed")
        try:
            self._sock.close()
        except OSError:
            pass

    def shutdown(self, timeout: float = 3.0) -> None:
        """Graceful-then-forceful: ``bye`` (worker exits its serve
        loop cleanly), short ack wait, then sever."""
        if not self._closed and self._dead is None:
            try:
                self._send({"op": "bye"})
                self._bye_ack.wait(max(0.2, timeout / 2.0))
            except OSError:
                pass
        self.kill()

    def stats(self) -> dict:
        return {
            "pid": self.pid,
            "host": self.peer_host,
            "alive": self.alive(),
            "heartbeat_age_s": round(self.heartbeat_age(), 3),
            "lease_s": self.lease_s,
            "spawn_seconds": round(self.spawn_seconds, 3),
            "kernels": self.kernels,
        }


def deploy_worker(
    pool_name: str,
    index: int,
    pending: Tuple[socket.socket, dict],
    payload_bytes: bytes,
    buckets=None,
    item_shape=None,
    dtype: Optional[str] = None,
    lease_s: float = DEFAULT_LEASE_S,
    ready_timeout: float = 300.0,
    max_frame_bytes: int = wire.DEFAULT_MAX_FRAME_BYTES,
    device: str = "cuda",
) -> NetWorkerHandle:
    """Claim one handshaked connection and deploy a generation onto it.
    On failure the connection is closed and :class:`WorkerSpawnError`
    raised — no half-born workers."""
    sock, hello = pending
    return NetWorkerHandle(
        pool_name,
        index,
        sock,
        hello,
        payload_bytes,
        buckets=buckets,
        item_shape=item_shape,
        dtype=dtype,
        lease_s=lease_s,
        ready_timeout=ready_timeout,
        max_frame_bytes=max_frame_bytes,
        device=device,
    )


# ------------------------------------------------------------ worker side


class ConnectRetriesExhausted(ConnectionError):
    """The worker's bounded backoff+jitter dial ladder ran out without
    reaching the router.  ``ConnectionError`` (OSError family) — the
    process exits nonzero and whatever spawned it decides."""


def _connect(
    host: str,
    port: int,
    name: str,
    attempts: int = DEFAULT_CONNECT_ATTEMPTS,
    base_delay: float = 0.2,
    max_delay: float = 5.0,
    seed: Optional[int] = None,
) -> socket.socket:
    """Dial the router with bounded exponential backoff + jitter
    (``durable.backoff_delays`` — the repo's one retry cadence) and
    send ``hello``.  Each attempt passes the ``serve.net.connect``
    fault site; an injected failure is retried like any refused dial."""
    from keystone_tpu_torch.utils import durable

    delays = list(
        durable.backoff_delays(
            max(0, int(attempts) - 1),
            base_delay=base_delay,
            max_delay=max_delay,
            seed=seed,
        )
    )
    last: Optional[BaseException] = None
    for i in range(max(1, int(attempts))):
        sock = None
        try:
            act = faults.fault_point(
                "serve.net.connect", role="worker", link=name, host=host
            )
            if act is not None:
                # a drop/partition verdict at the connect site IS a
                # failed dial — silence, retried by the ladder like any
                # refused connection (a plan never silently does nothing)
                raise ConnectionRefusedError(
                    f"fault plan injected {act!r} at serve.net.connect"
                )
            sock = socket.create_connection((host, port), timeout=10.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # swap the dial timeout for the steady-state SEND budget;
            # reads wait via select and never touch the socket timeout
            sock.settimeout(wire.SEND_TIMEOUT_S)
            wire.send_stream_frame(
                sock,
                {
                    "op": "hello",
                    "name": name,
                    "pid": os.getpid(),
                    "host": socket.gethostname(),
                    "protocol": wire.SOCKET_VERSION,
                },
            )
            return sock
        except OSError as e:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            last = e
            if i < len(delays):
                logger.info(
                    "connect to %s:%s failed (%s); retry in %.2fs",
                    host,
                    port,
                    e,
                    delays[i],
                )
                time.sleep(delays[i])
    raise ConnectRetriesExhausted(
        f"could not reach router at {host}:{port} after {attempts} "
        f"attempts ({type(last).__name__}: {last})"
    )


def _drain_ready(
    sock, max_frame_bytes: int, wname: str
) -> Tuple[List[Tuple[dict, bytes]], bool, bool]:
    """Drain frames already queued in the kernel buffer (beats that
    landed during a long compute).  Returns ``((msg, payload) tuples in
    order, any frame arrived, channel dead)``.  Payload bytes are kept
    with their frame — a stashed apply is USUALLY a retransmit answered
    from the last-reply cache, but nothing guarantees that, and
    replaying it with an empty payload would turn a recomputable apply
    into a confusing meta/byte-count error.  This runs BEFORE the
    self-fence check so a healthy worker whose compute outlasted one
    lease window is refreshed by the beats that were waiting for it —
    only true silence fences."""
    stashed: List[Tuple[dict, bytes]] = []
    got_any = False
    while True:
        try:
            msg, payload = wire.recv_stream_frame(
                sock, timeout=0.01, max_frame_bytes=max_frame_bytes
            )
        except TimeoutError:
            return stashed, got_any, False
        except (EOFError, OSError, wire.WireError):
            return stashed, got_any, True
        act = faults.fault_point(
            "serve.net.recv", role="worker", link=wname, op=msg.get("op")
        )
        if act == "drop":
            continue  # never arrived; does not refresh the lease
        got_any = True
        if msg.get("op") != "beat":
            stashed.append((msg, payload))


def _worker_session(sock: socket.socket, name: str, cache: dict) -> str:
    """One lease's worth of service: wait for deploy, build (or reuse)
    the applier, answer applies until ``bye`` / EOF / self-fence.
    Returns the exit reason; anything but ``"bye"`` means the caller
    should dial back for a fresh lease."""
    from keystone_tpu_torch.serve.telemetry import WorkerTelemetry
    from keystone_tpu_torch.serve.worker import (
        build_from_payload,
        classify_error,
        kernel_report,
        load_payload,
        setup_worker,
    )
    from keystone_tpu_torch.utils import durable, guard

    # ---- wait for the router to claim this connection with a deploy
    while True:
        try:
            msg, payload = wire.recv_stream_frame(sock, timeout=1.0, max_frame_bytes=DEPLOY_MAX_FRAME_BYTES)
            break
        except TimeoutError:
            continue
        except (EOFError, OSError, wire.WireError):
            return "eof"
    if msg.get("op") != "deploy":
        logger.warning("%s: expected deploy, got %r", name, msg.get("op"))
        return "torn"
    spec = msg.get("spec") or {}
    lease_s = float(spec.get("lease_s") or DEFAULT_LEASE_S)
    max_frame_bytes = int(
        spec.get("max_frame_bytes") or wire.DEFAULT_MAX_FRAME_BYTES
    )
    wname = spec.get("name") or name

    send_lock = threading.Lock()
    stop = threading.Event()

    def wsend(reply: dict, rpayload: bytes = b"") -> None:
        act = faults.fault_point(
            "serve.net.send", role="worker", link=wname, op=reply.get("op")
        )
        if act == "drop":
            return
        data = wire.pack_stream_frame(reply, rpayload)
        if act == "corrupt":
            data = _corrupt_frame(data)
        with send_lock:
            sock.sendall(data)

    # ---- build the applier (or reuse a cached one: same digest ⇒ the
    # exact generation this process already built and primed)
    digest = spec.get("digest")
    t0 = time.monotonic()
    #: span capture + metrics-delta shipping, piggybacked on the frames
    #: this session already answers (ready, beat, result, error); an
    #: old router ignores the optional ``telemetry`` body key
    device = None
    tel = None
    cached = cache.get(digest) if digest else None
    try:
        device = setup_worker(spec)
        tel = WorkerTelemetry(report=lambda: kernel_report(device))
        if cached is not None:
            applier, installed, primed = cached[0], cached[1], 0
            logger.info("%s: reusing built applier for %s", name, digest)
        else:
            with tel.span("worker.load"):
                deploy_payload = load_payload(payload, device)
            del payload
            applier, installed, primed = durable.with_retries(
                lambda: build_from_payload(deploy_payload, spec, device, tel=tel),
                description=f"{wname} build",
            )
            del deploy_payload
            if digest:
                cache.clear()  # one generation per worker process
                cache[digest] = (applier, installed)
    except BaseException as e:
        try:
            wsend(
                {
                    "op": "fatal",
                    "etype": type(e).__name__,
                    "emsg": str(e)[:800],
                }
            )
        except OSError:
            pass
        return "fatal"
    try:
        wsend(
            {
                "op": "ready",
                "pid": os.getpid(),
                "primed": primed,
                "reused": cached is not None,
                "device": str(device),
                "artifact_buckets": installed,
                "artifact_keys": _ready_artifact_keys(applier),
                "startup_seconds": round(time.monotonic() - t0, 3),
                "telemetry": tel.ship(t_rx=t0),
            }
        )
    except OSError:
        return "eof"

    def beat_loop() -> None:
        interval = _beat_interval(lease_s)
        while not stop.wait(interval):
            beat: dict = {"op": "beat"}
            # metrics deltas ride the beats the lease already requires
            # — no extra frames, bounded entries, and a quiet registry
            # ships nothing at all
            entries = tel.metrics_entries(min_interval_s=1.0)
            if entries:
                beat["telemetry"] = {"metrics": entries}
            try:
                wsend(beat)
            except OSError:
                return

    threading.Thread(target=beat_loop, daemon=True, name="net-beat").start()

    last_rx = time.monotonic()
    last_reply: Optional[Tuple[str, dict, bytes]] = None
    stashed: Deque[Tuple[dict, bytes]] = deque()
    try:
        while True:
            if stashed:
                msg, payload = stashed.popleft()
            else:
                try:
                    msg, payload = wire.recv_stream_frame(
                        sock,
                        timeout=min(0.25, _beat_interval(lease_s)),
                        max_frame_bytes=max_frame_bytes,
                    )
                except TimeoutError:
                    if time.monotonic() - last_rx > lease_s:
                        logger.warning(
                            "%s: lease lapsed (%.2fs silent); self-fencing",
                            wname,
                            lease_s,
                        )
                        return "fenced"
                    continue
                except EOFError:
                    return "eof"
                except (OSError, wire.WireError):
                    return "torn"
                act = faults.fault_point(
                    "serve.net.recv",
                    role="worker",
                    link=wname,
                    op=msg.get("op"),
                )
                if act == "drop":
                    continue  # never arrived; last_rx stays stale
                if act == "corrupt":
                    return "torn"
                last_rx = time.monotonic()
            op = msg.get("op")
            if op == "beat":
                continue
            if op == "bye":
                try:
                    wsend({"op": "bye_ack"})
                except OSError:
                    pass
                return "bye"
            if op != "apply":
                logger.warning("%s: ignoring frame %r", wname, op)
                continue
            fid = msg.get("fid")
            if last_reply is not None and last_reply[0] == fid:
                # idempotent retransmit: same flush id ⇒ the SAME
                # answer, no recompute (dispatch is at-least-once; the
                # reply cache makes it exactly-once in effect)
                try:
                    wsend(last_reply[1], last_reply[2])
                except OSError:
                    return "eof"
                continue
            t_apply = time.monotonic()
            try:
                with tel.span("worker.attach"):
                    arr = wire.payload_array(msg["meta"], payload)
                n = int(msg.get("n", arr.shape[0]))
                deadline_s = msg.get("deadline_s")
                deadline = (
                    None
                    if deadline_s is None
                    else guard.Deadline.after(float(deadline_s))
                )
                with tel.span("worker.apply", n=n):
                    result = applier(arr, n, deadline=deadline)
                rmeta, rpayload = wire.array_payload(result)
                reply = {
                    "op": "result",
                    "fid": fid,
                    "meta": rmeta,
                    "seconds": round(time.monotonic() - t_apply, 6),
                    "telemetry": tel.ship(t_rx=t_apply),
                }
            except BaseException as e:
                reply, rpayload = {
                    "op": "error",
                    "fid": fid,
                    "kind": classify_error(e),
                    "etype": type(e).__name__,
                    "emsg": str(e)[:800],
                    "seconds": round(time.monotonic() - t_apply, 6),
                    "telemetry": tel.ship(t_rx=t_apply),
                }, b""
            # beats queued behind a long compute refresh the lease
            # BEFORE the fence verdict — only true silence fences
            more, got_any, dead = _drain_ready(sock, max_frame_bytes, wname)
            if got_any:
                last_rx = time.monotonic()
            stashed.extend(more)
            if dead:
                return "eof"
            if time.monotonic() - last_rx > lease_s:
                # SELF-FENCE: the router stopped vouching for us while
                # we computed — it has (or will have) re-dispatched
                # this flush.  Our finished result is DISCARDED, not
                # sent: a healed partition must not double-serve.
                logger.warning(
                    "%s: lease lapsed during flush %s; discarding result "
                    "and fencing",
                    wname,
                    fid,
                )
                return "fenced"
            last_reply = (fid, reply, rpayload)
            try:
                wsend(reply, rpayload)
            except OSError:
                return "eof"
    finally:
        stop.set()
        try:
            sock.close()
        except OSError:
            pass


def _ready_artifact_keys(applier) -> list:
    from keystone_tpu_torch.serve.worker import _artifact_keys

    return _artifact_keys(applier)


def run_worker(
    address: str,
    name: Optional[str] = None,
    connect_attempts: int = DEFAULT_CONNECT_ATTEMPTS,
    max_sessions: Optional[int] = None,
    backoff_seed: Optional[int] = None,
) -> int:
    """The ``cli worker --connect HOST:PORT`` loop: dial, hello,
    serve one lease, and — unless the router said ``bye`` — dial back
    for a fresh one.  A fenced or partitioned worker REJOINS through
    the same front door as a brand-new one: there is no special resume
    handshake to get wrong, and the applier cache makes the rejoin
    cheap (same payload digest ⇒ no rebuild, no re-prime)."""
    host, port = parse_address(address)
    wname = name or f"{socket.gethostname()}-{os.getpid()}"
    cache: dict = {}
    sessions = 0
    while True:
        try:
            sock = _connect(
                host,
                port,
                wname,
                attempts=connect_attempts,
                seed=backoff_seed,
            )
        except ConnectRetriesExhausted as e:
            if sessions:
                # the router served us once and is now unreachable:
                # it is gone, not late — exit clean so spawned workers
                # don't linger as orphans
                logger.info("router gone (%s); worker %s exiting", e, wname)
                return 0
            logger.error("%s", e)
            return 1
        reason = _worker_session(sock, wname, cache)
        sessions += 1
        logger.info(
            "worker %s session %d ended: %s", wname, sessions, reason
        )
        if reason in ("bye", "fatal"):
            return 0 if reason == "bye" else 1
        if max_sessions is not None and sessions >= max_sessions:
            return 0


from keystone_tpu_torch.serve.fleet import Replica  # noqa: E402


class NetReplica(Replica):
    """A routing slot whose compute lives across a socket.  All
    queue/claim/breaker semantics are inherited; the lifecycle edges
    mirror :class:`~keystone_tpu_torch.serve.procfleet.ProcessReplica` with
    "child process" replaced by "leased channel"."""

    def __init__(
        self,
        index: int,
        handle: NetWorkerHandle,
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
        """Dead = the parent worker thread crashed (base), OR the lease
        expired / channel severed while the slot is live — an idle
        worker lost to a partition must be healed without waiting for
        the next dispatch to find the silence."""
        if super().is_dead():
            return True
        return (
            not (self._retired or self.quarantined)
            and not self.handle.alive()
        )

    # --------------------------------------------------------- lifecycle
    def _on_worker_exit(self) -> None:
        self._shutdown_handle()

    def _shutdown_handle(self) -> None:
        with self._shutdown_once:
            if self._shut:
                return
            self._shut = True
        self.handle.shutdown()

    def drain_queue(self):
        """Supervisor decommission: a channel still holding a flush is
        severed so the blocked parent thread unblocks
        (:class:`WorkerCrashed`) and the far side fences/rejoins."""
        left = super().drain_queue()
        if self.inflight is not None and self.handle.alive():
            logger.warning(
                "severing wedged net worker %s (pid %s)",
                self.handle.name,
                self.handle.pid,
            )
            self.handle.kill()
        return left

    def join(self, timeout: float):
        left = super().join(timeout)
        w = self._worker
        if w is not None and w.is_alive():
            self.handle.kill()
            w.join(2.0)
        self._shutdown_handle()
        return left

    def status(self) -> dict:
        out = super().status()
        out["backend"] = "net"
        out.update(
            {
                "link": self.handle.name,
                "pid": self.handle.pid,
                "peer_host": self.handle.peer_host,
                "worker_alive": self.handle.alive(),
                "worker_heartbeat_age_s": round(
                    self.handle.heartbeat_age(), 3
                ),
                "lease_s": self.handle.lease_s,
            }
        )
        out["artifact_buckets"] = self.applier.installed_buckets()
        kern = self.handle.kernels or {}
        out["worker_device"] = kern.get("device")
        out["worker_peak_reserved_bytes"] = kern.get("peak_reserved_bytes")
        return out
