"""The binary ingress: a selector-driven front end for a
:class:`~keystone_tpu_torch.serve.service.PipelineService` (counterpart of
``keystone_tpu/serve/ingress.py``; the same batch frames, so either
package's client speaks to either package's ingress).

The HTTP front end (``serve/http.py``) spends a thread and a JSON body a
request, and JSON charges every payload byte a parse and a copy.  This
front end takes a whole batch in one frame:

- **Selector loop, not threads.**  Each :class:`AsyncIngress` shard is
  one thread running a ``selectors`` poll over its listener and its
  connections: non-blocking reads into reusable buffers, write backlogs
  drained on writability, a self-pipe that wakes the loop when a
  batch's futures resolve on service threads.  ``shards=N`` (with
  ``SO_REUSEPORT``) runs N loops on one port.
- **Binary batch frames**::

      MAGIC(4)=KSBB | version(1)=1 | body_len(4) | payload_len(4)
      | crc32(4) | JSON body | payload bytes

  The JSON body carries ``op`` (``predict`` | ``ping``), ``count``,
  ``dtype``, ``shape`` (the item shape) and optionally ``tenant``,
  ``deadline_ms``, ``seq``, ``request_id``; the payload is the batch's
  row bytes.  Lengths and the CRC are big-endian and the CRC covers body
  and payload, so a damaged frame fails loudly (an error frame, then the
  connection closes); a stall mid-frame past ``stall_timeout_s``
  condemns the connection.
- **Slab-direct admission.**  A predict frame's payload is
  ``recv_into``'d off the socket straight into a
  :class:`~keystone_tpu_torch.serve.wire.SlabBlock`, a shared-memory slab
  padded to the service's bucket, and admitted whole under one service
  lock round (``PipelineService.submit_batch``), each row a view of the
  block.  When the block forms a flush by itself the router skips the
  stack and pad copies, and a process worker attaches the same slab by
  name: the payload crosses admission, router and worker with no copy in
  between.
- **HTTP on the same port.**  The first bytes of a connection are
  peeked: the batch magic keeps it on the loop, anything else (an HTTP
  verb) goes to the stdlib handler on its own thread
  (:func:`~keystone_tpu_torch.serve.http.handle_http_connection`).

Usage::

    front = serve_ingress(svc, port=8000, shards=2)   # started
    ...
    front.stop(); svc.close()

    with BinaryClient("127.0.0.1", front.port) as c:
        preds = c.predict(batch)          # (n, ...) in, (n, ...) out

Observability: ``ingress.accepts`` / ``http_conns`` / ``bin_conns`` /
``frames`` / ``batch_rows`` / ``frame_errors{kind=}`` counters, the
``ingress.parse_seconds`` and ``ingress.admit_seconds`` histograms, and
``ingress.bytes_copied``: the JSON path charges it every parsed payload
byte, the binary path nothing.
"""

from __future__ import annotations

import json
import logging
import selectors
import socket
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.obs.recorder import new_request_id
from keystone_tpu_torch.serve import wire
from keystone_tpu_torch.serve.fleet import FleetUnavailable
from keystone_tpu_torch.serve.http import handle_http_connection
from keystone_tpu_torch.serve.service import (
    Overloaded,
    PipelineService,
    PoisonRequest,
    ServiceClosed,
)
from keystone_tpu_torch.utils import guard

logger = logging.getLogger(__name__)

#: batch-protocol magic: distinct from the worker wire magic (``KSWP``)
#: so a batch client dialing a worker port (or vice versa) fails the
#: magic check instead of the length parse, and distinct from every
#: HTTP method so protocol sniffing is a 4-byte compare.
BATCH_MAGIC = b"KSBB"
BATCH_VERSION = 1

#: fixed header past magic+version: body_len, payload_len,
#: crc32(body + payload) — all big-endian u32 (the wire-v2 layout)
_HEADER = struct.Struct(">III")
_PREFIX_LEN = len(BATCH_MAGIC) + 1 + _HEADER.size

#: refuse frames past this before allocating anything
DEFAULT_MAX_FRAME_BYTES = wire.DEFAULT_MAX_FRAME_BYTES

#: result-wait bound per batch (mirrors http.py's _RESULT_TIMEOUT_S):
#: the service's own deadline machinery is the real latency bound; this
#: only unsticks a connection if the service is killed under it
_RESULT_TIMEOUT_S = 120.0


def pack_batch_frame(msg: dict, payload: bytes = b"") -> bytes:
    """Serialize one batch-protocol frame (client side, and the
    server's responses): prefix + JSON body + payload."""
    if not isinstance(msg, dict):
        raise wire.WireError(
            f"frame body must be a dict, got {type(msg).__name__}"
        )
    try:
        body = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    except (TypeError, ValueError) as e:
        raise wire.WireError(f"unserializable frame body: {e}") from e
    payload = bytes(payload) if not isinstance(payload, memoryview) else payload
    crc = zlib.crc32(payload, zlib.crc32(body)) & 0xFFFFFFFF
    return (
        BATCH_MAGIC
        + bytes([BATCH_VERSION])
        + _HEADER.pack(len(body), len(payload), crc)
        + body
        + bytes(payload)
    )


def recv_batch_frame(
    sock_,
    timeout: Optional[float] = None,
    max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
) -> Tuple[dict, bytes]:
    """Blocking receive of one batch frame (the CLIENT side — the
    server parses incrementally on its event loop).  Same error
    taxonomy as ``wire.recv_stream_frame``: ``TimeoutError`` when idle,
    ``EOFError`` on a clean close between frames, ``WireError`` on
    anything torn."""
    prefix = wire._recv_exact(sock_, _PREFIX_LEN, timeout)
    if prefix[: len(BATCH_MAGIC)] != BATCH_MAGIC:
        raise wire.WireError("bad batch-frame magic (foreign or torn stream)")
    ver = prefix[len(BATCH_MAGIC)]
    if ver != BATCH_VERSION:
        raise wire.WireError(
            f"batch-frame version {ver} != {BATCH_VERSION} (peer skew)"
        )
    body_len, payload_len, crc = _HEADER.unpack(prefix[len(BATCH_MAGIC) + 1 :])
    if body_len + payload_len > max_frame_bytes:
        raise wire.WireError(
            f"batch frame claims {body_len + payload_len} bytes "
            f"(cap {max_frame_bytes}); refusing before allocation"
        )
    try:
        body = (
            wire._recv_exact(sock_, body_len, wire.MID_FRAME_TIMEOUT_S)
            if body_len
            else b""
        )
        payload = (
            wire._recv_exact(sock_, payload_len, wire.MID_FRAME_TIMEOUT_S)
            if payload_len
            else b""
        )
    except (TimeoutError, EOFError) as e:
        raise wire.WireError(f"truncated batch frame: {e}") from None
    got = zlib.crc32(payload, zlib.crc32(body)) & 0xFFFFFFFF
    if got != crc:
        raise wire.WireError(
            f"batch-frame CRC mismatch (got {got:#010x}, header "
            f"{crc:#010x}) — bytes damaged in flight"
        )
    try:
        msg = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise wire.WireError(f"unparseable batch-frame body: {e}") from e
    if not isinstance(msg, dict):
        raise wire.WireError(
            f"batch-frame body must be a dict, got {type(msg).__name__}"
        )
    return msg, payload


class IngressError(RuntimeError):
    """A server-side refusal relayed through an error frame.  ``kind``
    carries the admission taxonomy (``overloaded`` / ``deadline`` /
    ``poison`` / ``unavailable`` / ``closed`` / ``bad_request`` /
    ``error``) so a client can map it without string-matching."""

    def __init__(
        self,
        message: str,
        kind: str = "error",
        retry_after=None,
        request_ids=None,
    ):
        super().__init__(message)
        self.kind = kind
        self.retry_after = retry_after
        #: the per-row trace ids the refused frame would have served
        #: under (echoed by the server on every typed refusal) — quote
        #: one at ``GET /requestz/<id>`` to see how far it got
        self.request_ids = list(request_ids or [])


# ---------------------------------------------------------------- server


class _Conn:
    """Per-connection state on a shard loop: sniff → binary frame state
    machine (prefix → body → payload-into-slab) → in-flight batches →
    write backlog."""

    SNIFF, PREFIX, BODY, PAYLOAD = "sniff", "prefix", "body", "payload"

    __slots__ = (
        "sock",
        "addr",
        "shard",
        "state",
        "buf",
        "want",
        "msg",
        "body_len",
        "payload_len",
        "crc_expect",
        "crc_run",
        "block",
        "payload_view",
        "payload_got",
        "t_frame_start",
        "t_progress",
        "outq",
        "closing",
    )

    def __init__(self, sock_, addr, shard: int = 0):
        self.sock = sock_
        self.addr = addr
        self.shard = shard
        self.state = _Conn.SNIFF
        self.buf = bytearray()
        self.want = _PREFIX_LEN
        self.msg: Optional[dict] = None
        self.body_len = 0
        self.payload_len = 0
        self.crc_expect = 0
        self.crc_run = 0
        self.block: Optional[wire.SlabBlock] = None
        self.payload_view: Optional[memoryview] = None
        self.payload_got = 0
        self.t_frame_start: Optional[float] = None
        self.t_progress = time.monotonic()
        self.outq: List[memoryview] = []
        self.closing = False  # close once the write backlog drains

    def mid_frame(self) -> bool:
        return self.state in (_Conn.BODY, _Conn.PAYLOAD) or (
            self.state == _Conn.PREFIX and len(self.buf) > 0
        )


class AsyncIngress:
    """The selector-driven front end.  ``shards`` > 1 runs that many
    accept+event loops on one port via ``SO_REUSEPORT`` (one loop per
    core is the intended shape); falls back to a single shard where the
    platform lacks it.  ``stall_timeout_s`` bounds mid-frame silence
    (tests shrink it); ``max_frame_bytes`` bounds any single frame.

    The ingress owns one :class:`~keystone_tpu_torch.serve.wire.SlabPool` for
    admission blocks; its cap follows the service fleet's dispatch slab
    cap so a payload the ingress admits is never refused downstream."""

    def __init__(
        self,
        service: PipelineService,
        host: str = "127.0.0.1",
        port: int = 0,
        shards: int = 1,
        registry=None,
        stall_timeout_s: float = wire.MID_FRAME_TIMEOUT_S,
        max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
        trace_dump_dir: Optional[str] = None,
    ):
        self.service = service
        self.registry = registry
        #: default directory for POST /tracez/dump on the sniffed HTTP
        #: path (None: the endpoint needs an explicit "dir" in its body)
        self.trace_dump_dir = trace_dump_dir
        self.host = host
        self.stall_timeout_s = float(stall_timeout_s)
        self.max_frame_bytes = int(max_frame_bytes)
        shards = max(1, int(shards))
        if shards > 1 and not hasattr(socket, "SO_REUSEPORT"):
            logger.warning(
                "ingress: SO_REUSEPORT unavailable; running 1 shard"
            )
            shards = 1
        cap = getattr(
            getattr(service, "_pool", None),
            "max_slab_bytes",
            wire.DEFAULT_MAX_SLAB_BYTES,
        )
        self._pool = wire.SlabPool(prefix="ing", max_slab_bytes=cap)
        self._listeners: List[socket.socket] = []
        bound_port = int(port)
        for i in range(shards):
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if shards > 1:
                ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            try:
                ls.bind((host, bound_port))
            except OSError:
                for other in self._listeners:
                    other.close()
                raise
            if bound_port == 0:
                bound_port = ls.getsockname()[1]
            ls.listen(512)
            ls.setblocking(False)
            self._listeners.append(ls)
        self.port = bound_port
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._wakes: List[socket.socket] = []
        #: completed batches pending response assembly, per shard:
        #: (conn, frame_bytes) pushed by future callbacks, drained by
        #: the shard loop after a self-pipe wake
        self._done_q: List[List] = [[] for _ in range(shards)]
        self._done_lock = threading.Lock()
        self._started = False
        metrics.register_buckets(
            "ingress.parse_seconds", metrics.INGRESS_TIME_BUCKETS
        )
        metrics.register_buckets(
            "ingress.admit_seconds", metrics.INGRESS_TIME_BUCKETS
        )

    @property
    def shards(self) -> int:
        return len(self._listeners)

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "AsyncIngress":
        if self._started:
            return self
        self._started = True
        for i, ls in enumerate(self._listeners):
            r, w = socket.socketpair()
            r.setblocking(False)
            self._wakes.append(w)
            t = threading.Thread(
                target=self._loop,
                args=(i, ls, r),
                daemon=True,
                name=f"ingress-{i}",
            )
            self._threads.append(t)
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for w in self._wakes:
            try:
                w.send(b"x")
            except OSError:
                pass
        for t in self._threads:
            t.join(5.0)
        for ls in self._listeners:
            try:
                ls.close()
            except OSError:
                pass
        for w in self._wakes:
            try:
                w.close()
            except OSError:
                pass
        self._pool.close()

    def __enter__(self) -> "AsyncIngress":
        if not self._started:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def stats(self) -> dict:
        return {"shards": self.shards, "pool": self._pool.stats()}

    # --------------------------------------------------------- shard loop
    def _loop(self, shard: int, listener: socket.socket, wake_r) -> None:
        sel = selectors.DefaultSelector()
        sel.register(listener, selectors.EVENT_READ, ("accept", None))
        sel.register(wake_r, selectors.EVENT_READ, ("wake", None))
        conns: Dict[int, _Conn] = {}
        try:
            while not self._stop.is_set():
                timeout = min(0.25, self.stall_timeout_s / 4.0)
                for key, events in sel.select(timeout):
                    kind, conn = key.data
                    try:
                        if kind == "accept":
                            self._accept(sel, listener, conns, shard)
                            continue
                        if kind == "wake":
                            try:
                                wake_r.recv(4096)
                            except (BlockingIOError, OSError):
                                pass
                            continue
                        if events & selectors.EVENT_READ:
                            self._readable(sel, conn, conns)
                        alive = conns.get(conn.sock.fileno()) is conn
                        if alive and (
                            conn.outq or events & selectors.EVENT_WRITE
                        ):
                            self._writable(sel, conn, conns)
                    except (OSError, ValueError) as e:
                        if conn is not None:
                            logger.debug("ingress: conn died: %s", e)
                            self._drop(sel, conn, conns)
                    except Exception:
                        # one bad connection must never take the shard
                        # loop (and with it the listener plus every
                        # other conn) down: drop the offender, count
                        # it, keep serving
                        metrics.inc(
                            "ingress.frame_errors", kind="internal"
                        )
                        logger.exception(
                            "ingress: internal error on conn %s",
                            getattr(conn, "addr", None),
                        )
                        if conn is not None:
                            self._drop(sel, conn, conns)
                # response frames assembled by future callbacks
                self._flush_done(sel, shard, conns)
                # condemn mid-frame stalls: a peer that started a frame
                # and went silent holds a slab and a connection slot —
                # typed failure at the peer (RST/EOF), never a hang here
                now = time.monotonic()
                for conn in list(conns.values()):
                    if (
                        conn.mid_frame()
                        and now - conn.t_progress > self.stall_timeout_s
                    ):
                        metrics.inc(
                            "ingress.frame_errors", kind="mid_frame_stall"
                        )
                        logger.debug(
                            "ingress: condemning stalled conn %s", conn.addr
                        )
                        self._drop(sel, conn, conns)
        finally:
            for conn in list(conns.values()):
                self._drop(sel, conn, conns)
            sel.close()

    def _accept(self, sel, listener, conns, shard: int) -> None:
        for _ in range(64):  # bounded accept burst per readiness
            try:
                sock_, addr = listener.accept()
            except (BlockingIOError, InterruptedError, OSError):
                return
            metrics.inc("ingress.accepts")
            sock_.setblocking(False)
            try:
                sock_.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock_, addr, shard)
            conns[sock_.fileno()] = conn
            sel.register(sock_, selectors.EVENT_READ, (None, conn))

    def _drop(self, sel, conn: _Conn, conns) -> None:
        try:
            sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        for fd, c in list(conns.items()):
            if c is conn:
                conns.pop(fd, None)
        self._abandon_frame(conn)
        conn.closing = True
        try:
            conn.sock.close()
        except OSError:
            pass

    def _abandon_frame(self, conn: _Conn) -> None:
        """Free a partially-read frame's slab (the conn is dying)."""
        conn.payload_view = None
        if conn.block is not None:
            conn.block.close()
            conn.block = None

    # ----------------------------------------------------------- reading
    def _readable(self, sel, conn: _Conn, conns) -> None:
        if conn.closing:
            return  # condemned: drain the write backlog, read no more
        if conn.state == _Conn.SNIFF:
            self._sniff(sel, conn, conns)
            return
        # drain what's available, frame by frame
        for _ in range(32):
            if conn.state == _Conn.PAYLOAD:
                if not self._read_payload(sel, conn, conns):
                    return
            else:
                try:
                    chunk = conn.sock.recv(
                        min(conn.want - len(conn.buf), 1 << 20)
                    )
                except (BlockingIOError, InterruptedError):
                    return
                except (ConnectionResetError, OSError):
                    self._drop(sel, conn, conns)
                    return
                if not chunk:
                    if conn.mid_frame():
                        metrics.inc(
                            "ingress.frame_errors", kind="truncated"
                        )
                    self._drop(sel, conn, conns)
                    return
                conn.t_progress = time.monotonic()
                if conn.t_frame_start is None:
                    conn.t_frame_start = conn.t_progress
                conn.buf.extend(chunk)
                if len(conn.buf) < conn.want:
                    return
                if conn.state == _Conn.PREFIX:
                    if not self._parse_prefix(sel, conn, conns):
                        return
                elif conn.state == _Conn.BODY:
                    if not self._parse_body(sel, conn, conns):
                        return

    def _sniff(self, sel, conn: _Conn, conns) -> None:
        """Peek the first bytes without consuming: binary magic stays
        on the loop, anything else becomes a delegated HTTP thread.

        A strict PREFIX of the magic is consumed into the frame buffer
        and the conn committed to the binary parser right away: peeked-
        but-unread bytes would make the level-triggered selector report
        the socket readable every iteration (a peer sending ``b"KS"``
        and stalling would spin this loop at full CPU), and no HTTP
        method shares a first byte with the magic, so committing early
        loses nothing — a stream that diverges after the prefix fails
        the magic check with a typed error, and a staller is now
        mid-frame (``PREFIX`` with buffered bytes) so the stall sweep
        condemns it."""
        try:
            peek = conn.sock.recv(len(BATCH_MAGIC), socket.MSG_PEEK)
        except (BlockingIOError, InterruptedError):
            return
        except (ConnectionResetError, OSError):
            self._drop(sel, conn, conns)
            return
        if not peek:
            self._drop(sel, conn, conns)
            return
        if BATCH_MAGIC.startswith(peek):
            metrics.inc("ingress.bin_conns")
            try:
                got = conn.sock.recv(len(peek))
            except (BlockingIOError, InterruptedError):
                return
            except (ConnectionResetError, OSError):
                self._drop(sel, conn, conns)
                return
            if not got:
                self._drop(sel, conn, conns)
                return
            conn.buf.extend(got)
            conn.t_progress = time.monotonic()
            conn.t_frame_start = conn.t_progress
            conn.state = _Conn.PREFIX
            conn.want = _PREFIX_LEN
            self._readable(sel, conn, conns)
            return
        # HTTP (or anything else): hand the UNCONSUMED socket to the
        # stdlib handler on its own thread — the threaded slow path
        metrics.inc("ingress.http_conns")
        try:
            sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        conns.pop(conn.sock.fileno(), None)
        sock_, addr = conn.sock, conn.addr
        sock_.setblocking(True)
        threading.Thread(
            target=handle_http_connection,
            args=(
                sock_,
                addr,
                self.service,
                self.registry,
                self.trace_dump_dir,
            ),
            daemon=True,
            name="ingress-http",
        ).start()

    def _parse_prefix(self, sel, conn: _Conn, conns) -> bool:
        buf = bytes(conn.buf)
        conn.buf.clear()
        if buf[: len(BATCH_MAGIC)] != BATCH_MAGIC:
            self._frame_error(sel, conn, conns, "bad_magic", "bad frame magic")
            return False
        ver = buf[len(BATCH_MAGIC)]
        if ver != BATCH_VERSION:
            self._frame_error(
                sel,
                conn,
                conns,
                "version_skew",
                f"batch-frame version {ver} != {BATCH_VERSION}",
            )
            return False
        body_len, payload_len, crc = _HEADER.unpack(buf[len(BATCH_MAGIC) + 1 :])
        if body_len + payload_len > self.max_frame_bytes:
            self._frame_error(
                sel,
                conn,
                conns,
                "oversize",
                f"frame claims {body_len + payload_len} bytes "
                f"(cap {self.max_frame_bytes})",
            )
            return False
        conn.body_len, conn.payload_len, conn.crc_expect = (
            body_len,
            payload_len,
            crc,
        )
        conn.crc_run = 0
        conn.state = _Conn.BODY
        conn.want = body_len
        if body_len == 0:
            return self._parse_body(sel, conn, conns)
        return True

    def _parse_body(self, sel, conn: _Conn, conns) -> bool:
        body = bytes(conn.buf)
        conn.buf.clear()
        conn.crc_run = zlib.crc32(body)
        try:
            msg = json.loads(body.decode("utf-8"))
            if not isinstance(msg, dict):
                raise ValueError("frame body must be a JSON object")
        except (UnicodeDecodeError, json.JSONDecodeError, ValueError) as e:
            self._frame_error(
                sel, conn, conns, "bad_body", f"unparseable frame body: {e}"
            )
            return False
        conn.msg = msg
        op = msg.get("op")
        if op == "ping":
            if conn.payload_len:
                self._frame_error(
                    sel, conn, conns, "bad_body", "ping carries no payload"
                )
                return False
            if conn.crc_run != conn.crc_expect:
                self._crc_mismatch(sel, conn, conns)
                return False
            self._frame_done(conn)
            self._respond(
                conn,
                {
                    "op": "pong",
                    "seq": msg.get("seq"),
                    "shards": self.shards,
                    "version": self.service.version,
                },
            )
            return True
        if op != "predict":
            self._frame_error(
                sel, conn, conns, "bad_op", f"unknown op {op!r}"
            )
            return False
        try:
            count = int(msg["count"])
            dtype = np.dtype(str(msg["dtype"]))
            item_shape = tuple(int(d) for d in msg.get("shape") or ())
            if count < 1:
                raise ValueError(f"count must be >= 1, got {count}")
            # wire dtypes are numeric scalars only: an object dtype
            # over the slab would turn raw socket bytes into PyObject
            # pointers the moment anything dereferences the array
            if dtype.hasobject or dtype.kind not in "biufc":
                raise ValueError(
                    f"dtype {dtype.str!r} not admissible on the wire "
                    "(numeric kinds biufc only)"
                )
            # overflow-safe Python-int math: a crafted dim must fail
            # typed here, not wrap through a fixed-width product into
            # passing the payload-length consistency check below
            row_elems = 1
            for d in item_shape:
                if d < 1:
                    raise ValueError(
                        f"item shape {item_shape} has a dim < 1"
                    )
                row_elems *= d
                if row_elems * dtype.itemsize > self.max_frame_bytes:
                    raise ValueError(
                        f"item shape {item_shape} exceeds the "
                        f"{self.max_frame_bytes}-byte frame cap"
                    )
        except (KeyError, TypeError, ValueError) as e:
            self._frame_error(
                sel, conn, conns, "bad_body", f"bad predict header: {e}"
            )
            return False
        expect = count * row_elems * dtype.itemsize
        if expect != conn.payload_len:
            self._frame_error(
                sel,
                conn,
                conns,
                "bad_body",
                f"payload carries {conn.payload_len} bytes but header "
                f"claims {count}x{item_shape}:{dtype.str} = {expect}",
            )
            return False
        svc = self.service
        # pre-pad to the service's padding bucket so a flush of this
        # block needs no re-pad copy; a batch wider than max_batch
        # spans flushes anyway, so it rides unpadded
        padded = (
            svc.bucket_for(count) if count <= svc.max_batch else count
        )
        try:
            conn.block = wire.alloc_block(
                self._pool, count, item_shape, dtype, padded_rows=padded
            )
        except wire.PayloadTooLarge as e:
            # typed refusal, connection stays healthy: the frame's
            # payload still has to be drained... but draining an
            # oversize payload is exactly the DoS the cap refuses, so
            # condemn the connection instead
            self._frame_error(sel, conn, conns, "too_large", str(e))
            return False
        conn.payload_view = memoryview(conn.block.array).cast("B")[
            : conn.payload_len
        ]
        conn.payload_got = 0
        conn.state = _Conn.PAYLOAD
        return self._read_payload(sel, conn, conns)

    def _read_payload(self, sel, conn: _Conn, conns) -> bool:
        """Non-blocking recv straight into the slab-backed block (the
        zero-copy read); returns False when the caller's read loop must
        stop (would-block, dropped, or frame finished via dispatch)."""
        while conn.payload_got < conn.payload_len:
            try:
                n = conn.sock.recv_into(
                    conn.payload_view[conn.payload_got :]
                )
            except (BlockingIOError, InterruptedError):
                return False
            except (ConnectionResetError, OSError):
                self._drop(sel, conn, conns)
                return False
            if n == 0:
                metrics.inc("ingress.frame_errors", kind="truncated")
                self._drop(sel, conn, conns)
                return False
            conn.crc_run = zlib.crc32(
                conn.payload_view[conn.payload_got : conn.payload_got + n],
                conn.crc_run,
            )
            conn.payload_got += n
            conn.t_progress = time.monotonic()
        conn.payload_view = None
        if (conn.crc_run & 0xFFFFFFFF) != conn.crc_expect:
            self._crc_mismatch(sel, conn, conns)
            return False
        t0 = conn.t_frame_start
        if t0 is not None:
            metrics.observe("ingress.parse_seconds", time.monotonic() - t0)
        metrics.inc("ingress.frames")
        self._dispatch(conn)
        self._frame_done(conn)
        return True

    def _frame_done(self, conn: _Conn) -> None:
        """Reset the state machine for the next frame on this conn."""
        conn.state = _Conn.PREFIX
        conn.want = _PREFIX_LEN
        conn.buf.clear()
        conn.msg = None
        conn.block = None  # ownership moved to the batch (or closed)
        conn.payload_view = None
        conn.t_frame_start = None

    def _crc_mismatch(self, sel, conn, conns) -> None:
        self._frame_error(
            sel,
            conn,
            conns,
            "crc_mismatch",
            "batch-frame CRC mismatch — bytes damaged in flight",
        )

    def _frame_error(self, sel, conn: _Conn, conns, kind: str, msg: str) -> None:
        """A FRAMING violation: the byte stream itself can no longer be
        trusted, so answer with a typed error frame and condemn the
        connection (the wire-v2 discipline).  Admission refusals — the
        stream is fine, the REQUEST was refused — go through
        :meth:`_error_frame` and keep the connection."""
        metrics.inc("ingress.frame_errors", kind=kind)
        self._abandon_frame(conn)
        self._respond(
            conn, {"op": "error", "ok": False, "kind": kind, "error": msg}
        )
        conn.closing = True  # close once the error frame drains

    # -------------------------------------------------------- dispatching
    @staticmethod
    def _request_ids_for(msg: dict, count: int) -> List[str]:
        """Request-id parity with the HTTP front end: honor the
        client's ``request_id`` body key, else mint one; a multi-row
        frame fans out ``<rid>/<i>`` sub-ids so each row's causal chain
        resolves individually at ``/requestz/<id>``."""
        rid = msg.get("request_id")
        rid = (str(rid).strip() if rid is not None else "") or new_request_id()
        if count == 1:
            return [rid]
        return [f"{rid}/{i}" for i in range(count)]

    def _dispatch(self, conn: _Conn) -> None:
        """Admit one complete predict frame: the whole block under one
        service lock round; futures resolve on service threads and the
        LAST one assembles the response and wakes this shard's loop."""
        msg, block = conn.msg, conn.block
        seq = msg.get("seq")
        deadline_ms = msg.get("deadline_ms")
        deadline = (
            None if deadline_ms is None else float(deadline_ms) / 1000.0
        )
        tenant = msg.get("tenant")
        tenant = None if tenant is None else str(tenant)
        svc = self.service
        rids = self._request_ids_for(msg, block.count)
        rec = svc.recorder
        if rec is not None:
            for r in rids:
                rec.annotate(r, "bin.ingress", rows=block.count)
        t0 = time.monotonic()
        try:
            futs = svc.submit_batch(
                block, deadline=deadline, request_ids=rids, tenant=tenant
            )
        except BaseException as e:
            block.close()
            self._enqueue_response(conn, self._error_frame(seq, e, rids))
            return
        metrics.observe("ingress.admit_seconds", time.monotonic() - t0)
        metrics.inc("ingress.batch_rows", len(futs))
        # hold the slab until every future resolves (dispatch may read
        # it up to that point: hedges, crash requeues, bisection)
        block.retain(len(futs))
        for f in futs:
            f.add_done_callback(block.release_one)
        state = {"left": len(futs), "lock": threading.Lock()}

        def on_done(_f):
            with state["lock"]:
                state["left"] -= 1
                if state["left"]:
                    return
            self._finish_batch(conn, seq, futs, rids)

        for f in futs:
            f.add_done_callback(on_done)

    def _finish_batch(self, conn: _Conn, seq, futs, rids=None) -> None:
        """All futures of one batch resolved (runs on a service
        thread): assemble the response frame, enqueue, wake the loop."""
        try:
            rows = [f.result(timeout=0) for f in futs]
        except BaseException as e:
            self._enqueue_response(conn, self._error_frame(seq, e, rids))
            return
        try:
            out = np.ascontiguousarray(np.stack(rows))
            frame = pack_batch_frame(
                {
                    "op": "result",
                    "ok": True,
                    "seq": seq,
                    "count": int(out.shape[0]),
                    "dtype": out.dtype.str,
                    "shape": list(out.shape[1:]),
                    "request_ids": list(rids or []),
                },
                out.tobytes(),
            )
        except BaseException as e:  # heterogeneous rows, pack failure
            self._enqueue_response(conn, self._error_frame(seq, e, rids))
            return
        self._enqueue_response(conn, frame)

    @staticmethod
    def _error_frame(seq, e: BaseException, rids=None) -> bytes:
        if isinstance(e, Overloaded):
            kind = "overloaded"
        elif isinstance(e, guard.DeadlineExceeded):
            kind = "deadline"
        elif isinstance(e, PoisonRequest):
            kind = "poison"
        elif isinstance(e, FleetUnavailable):
            kind = "unavailable"
        elif isinstance(e, (ServiceClosed,)):
            kind = "closed"
        elif isinstance(e, guard.CircuitOpenError):
            kind = "overloaded"
        elif isinstance(e, (TypeError, ValueError)):
            kind = "bad_request"
        else:
            kind = "error"
        body = {
            "op": "error",
            "ok": False,
            "seq": seq,
            "kind": kind,
            "error": f"{type(e).__name__}: {e}",
        }
        if rids:
            # every typed refusal echoes the ids the frame would have
            # served under — the id a client quotes at /requestz/<id>
            # must exist whether the request succeeded or was refused
            body["request_ids"] = list(rids)
        retry = getattr(e, "retry_after_seconds", None)
        if retry is not None:
            body["retry_after_seconds"] = float(retry)
        return pack_batch_frame(body)

    # ----------------------------------------------------------- writing
    def _respond(self, conn: _Conn, msg: dict, payload: bytes = b"") -> None:
        """Queue a response frame assembled ON the loop thread."""
        self._enqueue_write(conn, pack_batch_frame(msg, payload))

    def _enqueue_response(self, conn: _Conn, frame: bytes) -> None:
        """Queue a response assembled OFF the loop thread (future
        callbacks): park it on the conn's shard done queue and wake that
        shard's selector via the self-pipe.  Connections are pinned to
        the shard that accepted them, so the owning loop is the only
        thread that ever touches the conn's write state."""
        with self._done_lock:
            self._done_q[conn.shard].append((conn, frame))
        try:
            self._wakes[conn.shard].send(b"x")
        except (OSError, IndexError):
            pass

    def _flush_done(self, sel, shard: int, conns) -> None:
        with self._done_lock:
            batch, self._done_q[shard] = self._done_q[shard], []
        for conn, frame in batch:
            # identity check: the frame's conn may have died (and its fd
            # been reused) while the batch was in flight — drop silently
            if conns.get(conn.sock.fileno()) is not conn:
                continue
            self._enqueue_write(conn, frame)
            self._writable(sel, conn, conns)

    def _enqueue_write(self, conn: _Conn, frame: bytes) -> None:
        conn.outq.append(memoryview(frame))

    def _writable(self, sel, conn: _Conn, conns) -> None:
        while conn.outq:
            mv = conn.outq[0]
            try:
                n = conn.sock.send(mv)
            except (BlockingIOError, InterruptedError):
                break
            except (BrokenPipeError, ConnectionResetError, OSError):
                self._drop(sel, conn, conns)
                return
            if n < len(mv):
                conn.outq[0] = mv[n:]
                break
            conn.outq.pop(0)
        events = selectors.EVENT_READ
        if conn.outq:
            events |= selectors.EVENT_WRITE
        try:
            sel.modify(conn.sock, events, (None, conn))
        except (KeyError, ValueError):
            return
        if conn.closing and not conn.outq:
            self._drop(sel, conn, conns)


# ---------------------------------------------------------------- client


class BinaryClient:
    """Blocking batch-protocol client (benches, tests, high-volume
    feeders).  One connection, strict request/response; thread-safe via
    an internal lock — run several clients for pipelined load.

    ``predict`` submits a whole ``(n, ...)`` batch in one frame and
    returns the ``(n, ...)`` predictions; server refusals raise
    :class:`IngressError` with the admission taxonomy in ``.kind``."""

    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = _RESULT_TIMEOUT_S,
        connect_timeout: float = 10.0,
    ):
        self.timeout = float(timeout)
        self._lock = threading.Lock()
        self._seq = 0
        #: per-row trace ids of the most recent successful predict
        self.last_request_ids: List[str] = []
        self.sock = socket.create_connection(
            (host, port), timeout=connect_timeout
        )
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # readers wait via select (wire._recv_exact); the socket's own
        # timeout budgets sendall, the wire.py discipline
        self.sock.settimeout(wire.SEND_TIMEOUT_S)

    def _roundtrip(self, msg: dict, payload: bytes = b"") -> Tuple[dict, bytes]:
        with self._lock:
            self._seq += 1
            msg = dict(msg, seq=self._seq)
            self.sock.sendall(pack_batch_frame(msg, payload))
            reply, rpayload = recv_batch_frame(self.sock, timeout=self.timeout)
        if reply.get("op") == "error" or reply.get("ok") is False:
            raise IngressError(
                str(reply.get("error") or "server error"),
                kind=str(reply.get("kind") or "error"),
                retry_after=reply.get("retry_after_seconds"),
                request_ids=reply.get("request_ids"),
            )
        return reply, rpayload

    def ping(self) -> dict:
        reply, _ = self._roundtrip({"op": "ping"})
        return reply

    def predict(
        self,
        batch: np.ndarray,
        tenant: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        request_id: Optional[str] = None,
    ) -> np.ndarray:
        """``request_id``: the trace identity for this frame (else the
        server mints one) — per-row ids come back on the reply and are
        kept on :attr:`last_request_ids`; a refusal carries them on
        ``IngressError.request_ids``."""
        batch = np.ascontiguousarray(batch)
        if batch.ndim < 1:
            raise ValueError("batch must be (n, ...) — at least 1-D")
        msg = {
            "op": "predict",
            "count": int(batch.shape[0]),
            "dtype": batch.dtype.str,
            "shape": list(batch.shape[1:]),
        }
        if request_id is not None:
            msg["request_id"] = str(request_id)
        if tenant is not None:
            msg["tenant"] = str(tenant)
        if deadline_ms is not None:
            msg["deadline_ms"] = float(deadline_ms)
        reply, payload = self._roundtrip(msg, batch.tobytes())
        self.last_request_ids = list(reply.get("request_ids") or [])
        dtype = np.dtype(reply["dtype"])
        shape = (int(reply["count"]),) + tuple(
            int(d) for d in reply.get("shape") or ()
        )
        return np.frombuffer(payload, dtype=dtype).reshape(shape).copy()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self) -> "BinaryClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_ingress(
    service: PipelineService,
    host: str = "127.0.0.1",
    port: int = 8000,
    shards: int = 1,
    registry=None,
    **kw,
) -> AsyncIngress:
    """Stand up (and start) the async ingress for ``service``; returns
    the started :class:`AsyncIngress` (``.port`` for ephemeral binds,
    ``.stop()`` to shut down).  HTTP/JSON clients keep working on the
    same port (sniffed, delegated to ``serve/http.py``); binary batch
    clients get the zero-copy path."""
    return AsyncIngress(
        service, host=host, port=port, shards=shards, registry=registry, **kw
    ).start()
