"""Worker wire protocol: control frames and shared-memory payload slabs
(counterpart of ``keystone_tpu/serve/wire.py``, the same magic, versions
and layouts: a frame packed by either package unpacks in the other).

The process fleet (``serve/procfleet.py``) moves batch payloads between
the router process and its worker processes, so the protocol splits
control from data:

- **Control frames** — small JSON dicts (an op, a slab reference, an
  error classification), length-delimited by the
  ``multiprocessing.connection`` transport and framed here with a magic
  and version prefix, so a torn or foreign message fails loudly
  (:func:`pack_frame` / :func:`unpack_frame`).  Arrays never ride a
  frame: a frame carries at most a :func:`slab reference <write_array>`.
- **Payload slabs** — ``multiprocessing.shared_memory`` segments in
  power-of-two size classes (every flush is padded to a bucket, so slab
  sizes are as finite as the bucket shapes).  Dispatch is one copy into
  a slab; the receiving side attaches by name (cached) and reads a numpy
  view.  :class:`SlabPool` owns creation, reuse and unlink;
  :class:`SlabAttacher` is the read side.

Reuse discipline: strict request/response with one request in flight
per worker (the parent serializes on a per-worker lock), so a request
slab is reusable once the response frame arrives, and a response slab
once the next request is sent.  :meth:`SlabPool.acquire` refuses
payloads past ``max_slab_bytes`` with :class:`PayloadTooLarge`.

**Stream frames (socket version 2).**  Peers on other hosts
(``serve/net.py``) cannot share memory, so the same control frames ride
a TCP socket with the payload bytes inline::

    MAGIC(4) | version(1)=2 | body_len(4) | payload_len(4) | crc32(4)
    | JSON body | payload bytes

Lengths and the CRC are big-endian; the CRC covers body and payload, so
a damaged or torn frame fails with :class:`WireError` at the receiver,
the connection is condemned and the worker replaced.  A stream frame
carries at most one array payload (:func:`array_payload` /
:func:`payload_array`).

Transport only: numpy and the standard library, no torch, so the router
and a freshly spawned worker import it before the CUDA runtime.
"""

from __future__ import annotations

import itertools
import json
import select
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

#: frame prefix: magic + protocol version.  A frame from a different
#: keystone version (rolling restart skew) or a stray writer fails the
#: unpack instead of silently misparsing.
MAGIC = b"KSWP"
VERSION = 1

#: the socket (cross-host) framing version.  Distinct from the slab
#: protocol's VERSION: the two transports can rev independently, and a
#: v1 slab frame accidentally written to a socket fails the version
#: check instead of the length parse.
SOCKET_VERSION = 2

#: stream-frame fixed header past magic+version: body length, payload
#: length, crc32(body + payload) — all big-endian u32
_STREAM_HEADER = struct.Struct(">III")
_STREAM_PREFIX_LEN = len(MAGIC) + 1 + _STREAM_HEADER.size

#: refuse stream frames past this before allocating (a garbage length
#: field must not turn into a multi-GiB recv buffer)
DEFAULT_MAX_FRAME_BYTES = 1 << 28  # 256 MiB

#: once the first byte of a frame arrives, the rest must follow within
#: this window — a peer that stalls mid-frame holds the channel torn,
#: and a torn channel means replace-the-worker, not wait-forever
MID_FRAME_TIMEOUT_S = 30.0

#: the SEND direction's budget on a shared stream socket.  The socket
#: object's timeout caps the TOTAL duration of ``sendall`` (Python
#: 3.5+ semantics), so it must be generous enough for a full-size frame
#: over a congested cross-host link — and it is set ONCE at connection
#: setup, never by the read side: reader threads wait with ``select``
#: (:func:`_wait_readable`) precisely so their short idle poll cannot
#: shrink a concurrent ``sendall``'s budget out from under the sender.
SEND_TIMEOUT_S = 60.0

#: slab size classes are powers of two from this floor — small enough
#: that a probe request wastes little, large enough that the common
#: bucket sizes land in few classes
MIN_SLAB_BYTES = 1 << 16  # 64 KiB

#: refuse single payloads past this (acquire raises PayloadTooLarge)
DEFAULT_MAX_SLAB_BYTES = 1 << 28  # 256 MiB


class WireError(RuntimeError):
    """A malformed control frame: wrong magic, wrong version, truncated
    or non-JSON body.  Deliberately loud — a torn frame means the
    control channel itself is unreliable and the worker must be
    replaced, not retried."""


class PayloadTooLarge(ValueError):
    """The payload exceeds the slab cap.  A ``ValueError`` on purpose:
    it is the REQUEST's fault (the 400 family at HTTP) and resubmitting
    it unchanged will fail again — it must not charge replica breakers
    or trip the supervisor."""


def pack_frame(msg: dict) -> bytes:
    """Serialize one control frame: ``MAGIC + version byte + JSON``.
    Frames carry only JSON-native scalars/lists/dicts (slab references,
    never arrays)."""
    if not isinstance(msg, dict):
        raise WireError(f"frame body must be a dict, got {type(msg).__name__}")
    try:
        body = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    except (TypeError, ValueError) as e:
        raise WireError(f"unserializable frame body: {e}") from e
    return MAGIC + bytes([VERSION]) + body


def unpack_frame(data: bytes) -> dict:
    """Parse one control frame; raises :class:`WireError` on anything
    that is not a well-formed frame of THIS protocol version."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise WireError(f"frame must be bytes, got {type(data).__name__}")
    data = bytes(data)
    if len(data) < len(MAGIC) + 1:
        raise WireError(f"truncated frame ({len(data)} bytes)")
    if data[: len(MAGIC)] != MAGIC:
        raise WireError("bad frame magic (foreign or torn message)")
    ver = data[len(MAGIC)]
    if ver != VERSION:
        raise WireError(f"frame version {ver} != {VERSION} (worker skew)")
    try:
        msg = json.loads(data[len(MAGIC) + 1 :].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"unparseable frame body: {e}") from e
    if not isinstance(msg, dict):
        raise WireError(f"frame body must be a dict, got {type(msg).__name__}")
    return msg


def slab_class(nbytes: int) -> int:
    """The size class a payload of ``nbytes`` rides: the smallest power
    of two >= max(nbytes, MIN_SLAB_BYTES) — mirroring the padding-bucket
    discipline so slab shapes are as finite as program shapes."""
    n = max(int(nbytes), MIN_SLAB_BYTES)
    return 1 << (n - 1).bit_length()


class Slab:
    """One owned shared-memory segment (created by a :class:`SlabPool`;
    the remote side attaches by :attr:`name`)."""

    __slots__ = ("shm", "capacity")

    def __init__(self, shm, capacity: int):
        self.shm = shm
        self.capacity = int(capacity)

    @property
    def name(self) -> str:
        return self.shm.name

    @property
    def buf(self):
        return self.shm.buf


#: the sequence in this process's segment names (shared by every pool)
_SEGMENT_SEQ = itertools.count(1)


class SlabPool:
    """Creator-side slab manager: acquire/release with reuse across
    size classes (a released 1 MiB slab serves a later 256 KiB payload
    — ``acquire`` hands out the smallest free slab that fits before
    creating a new one).  Owned slabs are unlinked at :meth:`close`.
    Thread-safe; creation is rare after warm-up (the working set is one
    request slab + one response slab per worker).

    A segment's name is never used twice in one process, whichever pool
    makes it: a reader's :class:`SlabAttacher` keeps a segment mapped by
    name, so a later pool (an ingress restarted in front of the same
    workers) that reused the name would be read through the old,
    unlinked mapping."""

    def __init__(
        self,
        prefix: str = "ksw",
        max_slab_bytes: int = DEFAULT_MAX_SLAB_BYTES,
    ):
        import re

        # the prefix lands in the POSIX shm name (debuggability: ls
        # /dev/shm attributes every segment to its pool/worker); keep
        # it name-safe and short
        self.prefix = re.sub(r"[^A-Za-z0-9_]", "_", str(prefix))[:48]
        self.max_slab_bytes = int(max_slab_bytes)
        self._lock = threading.Lock()
        self._free: List[Slab] = []
        self._all: List[Slab] = []
        self._closed = False
        self.created = 0
        self.reused = 0

    def acquire(self, nbytes: int) -> Slab:
        nbytes = int(nbytes)
        if nbytes > self.max_slab_bytes:
            raise PayloadTooLarge(
                f"payload of {nbytes} bytes exceeds the slab cap "
                f"({self.max_slab_bytes}); refused at dispatch"
            )
        cls = slab_class(nbytes)
        with self._lock:
            if self._closed:
                raise WireError("slab pool is closed")
            fits = [s for s in self._free if s.capacity >= cls]
            if fits:
                slab = min(fits, key=lambda s: s.capacity)
                self._free.remove(slab)
                self.reused += 1
                return slab
        import os

        from multiprocessing import shared_memory

        shm = None
        while shm is None:
            name = f"{self.prefix}_{os.getpid()}_{next(_SEGMENT_SEQ)}"
            try:
                shm = shared_memory.SharedMemory(
                    name=name, create=True, size=cls
                )
            except FileExistsError:
                continue  # a stale segment from a crashed prior run
        slab = Slab(shm, cls)
        with self._lock:
            self._all.append(slab)
            self.created += 1
        return slab

    def release(self, slab: Slab) -> None:
        with self._lock:
            if self._closed:
                self._destroy(slab)
                return
            if slab not in self._free:
                self._free.append(slab)

    @staticmethod
    def _destroy(slab: Slab) -> None:
        try:
            slab.shm.close()
            slab.shm.unlink()
        except (FileNotFoundError, OSError):
            pass
        except BufferError:
            # a NumPy view over the segment is still alive (a late
            # rider reference, a recorder-held row): unlink the NAME so
            # the segment dies with the last mapping instead of leaking
            # past process exit, and leave the mapping to the GC
            try:
                slab.shm.unlink()
            except (FileNotFoundError, OSError):
                pass

    def stats(self) -> dict:
        with self._lock:
            return {
                "created": self.created,
                "reused": self.reused,
                "free": len(self._free),
                "total": len(self._all),
                "bytes": sum(s.capacity for s in self._all),
            }

    def close(self) -> None:
        """Unlink every owned slab (idempotent).  The owner outlives
        every reader by protocol (a worker's response slabs die with
        the worker AFTER the parent read its last response)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            slabs, self._all, self._free = self._all, [], []
        for s in slabs:
            self._destroy(s)


class SlabAttacher:
    """Reader-side cache of attached segments (attach = a syscall +
    mmap; the steady state re-reads the same one or two slab names
    per worker)."""

    def __init__(self):
        self._attached: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _segment(self, name: str):
        with self._lock:
            seg = self._attached.get(name)
            if seg is None:
                from multiprocessing import shared_memory

                seg = shared_memory.SharedMemory(name=name)
                self._attached[name] = seg
            return seg

    def view(self, ref: dict) -> np.ndarray:
        """A zero-copy NumPy view over the referenced payload.  The
        view is valid only until the protocol allows the writer to
        reuse the slab — copy before crossing that boundary.  An
        optional ``offset`` field (bytes, default 0) lets one slab
        carry a payload past its head — the admission-block hand-off."""
        seg = self._segment(ref["slab"])
        dtype = np.dtype(ref["dtype"])
        shape = tuple(ref["shape"])
        nbytes = int(ref["nbytes"])
        offset = int(ref.get("offset", 0))
        if offset < 0 or offset + nbytes > seg.size:
            raise WireError(
                f"slab reference claims bytes [{offset}, {offset + nbytes}) "
                f"but segment {ref['slab']!r} holds {seg.size}"
            )
        return np.ndarray(
            shape, dtype=dtype, buffer=seg.buf[offset : offset + nbytes]
        )

    def read(self, ref: dict) -> np.ndarray:
        """An owning copy of the referenced payload (safe past slab
        reuse)."""
        return np.array(self.view(ref))

    def close(self) -> None:
        with self._lock:
            segs, self._attached = list(self._attached.values()), {}
        for seg in segs:
            try:
                seg.close()
            except OSError:
                pass

    def unlink_all(self) -> None:
        """Reap segments whose OWNER died without unlinking (a
        SIGKILLed worker's response slabs): close, unlink, and clear
        the dead owner's resource-tracker registration.  A segment the
        owner already unlinked is skipped silently."""
        with self._lock:
            segs, self._attached = list(self._attached.values()), {}
        for seg in segs:
            try:
                seg.close()
            except OSError:
                pass
            try:
                seg.unlink()
            except (FileNotFoundError, OSError):
                pass


def write_array(pool: SlabPool, arr: np.ndarray) -> Tuple[Slab, dict]:
    """Copy ``arr`` into a pool slab; returns ``(slab, reference)`` —
    the reference is what rides the control frame.  Non-contiguous
    inputs are made contiguous first (one copy either way)."""
    arr = np.ascontiguousarray(arr)
    slab = pool.acquire(arr.nbytes)
    dst = np.ndarray(arr.shape, dtype=arr.dtype, buffer=slab.buf[: arr.nbytes])
    np.copyto(dst, arr)
    del dst  # release the exported buffer view before any slab close
    ref = {
        "slab": slab.name,
        "shape": list(arr.shape),
        "dtype": arr.dtype.str,
        "nbytes": int(arr.nbytes),
    }
    return slab, ref


class SlabBlock:
    """An admission-owned padded batch living in ONE pool slab — the
    zero-copy hand-off between the ingress front end and the dispatch
    path.

    Rows ``[0, count)`` are request rows (the ingress reads client
    payload bytes straight off the socket into them); rows
    ``[count, padded_rows)`` are zero pad, pre-sized to the service's
    padding bucket so a flush of the whole block needs NO re-pad copy.
    :attr:`ref` is the slab reference a process worker can attach by
    name — the router ships it on the control frame instead of
    memcpy'ing the batch into a dispatch slab.

    Lifetime is refcounted in request rows: the admitting caller
    :meth:`retain`\\ s once per submitted future and each future's done
    callback :meth:`release_one`\\ s; the slab rejoins its pool only
    after the LAST future resolves, which by the strict
    request/response dispatch protocol is after any worker has read
    the payload (and after bisection's re-runs, which slice the same
    rows).  ``admission_block`` is the duck-typed marker
    ``PipelineService.submit_batch`` keys on — no wire import needed
    at the admission layer."""

    admission_block = True

    __slots__ = ("pool", "slab", "array", "count", "_refs", "_lock")

    def __init__(self, pool: SlabPool, slab: Slab, array: np.ndarray, count: int):
        self.pool = pool
        self.slab = slab
        self.array = array
        self.count = int(count)
        self._refs = 0
        self._lock = threading.Lock()

    @property
    def padded_rows(self) -> int:
        return int(self.array.shape[0])

    @property
    def ref(self) -> dict:
        """The dispatch slab reference for the WHOLE padded block."""
        return {
            "slab": self.slab.name,
            "shape": list(self.array.shape),
            "dtype": self.array.dtype.str,
            "nbytes": int(self.array.nbytes),
            "offset": 0,
        }

    def rows(self) -> list:
        """Per-request row views (zero-copy slices of the block)."""
        return [self.array[i] for i in range(self.count)]

    def retain(self, n: int = 1) -> None:
        with self._lock:
            self._refs += int(n)

    def release_one(self, _fut=None) -> None:
        """Drop one reference (signature-compatible with
        ``Future.add_done_callback``); the last one frees the slab."""
        with self._lock:
            self._refs -= 1
            if self._refs > 0:
                return
        self.close()

    def close(self) -> None:
        """Return the slab to the pool (idempotent).  The ndarray view
        is dropped first so a later ``pool.close()`` can unmap the
        segment."""
        with self._lock:
            slab, self.slab, self.array = self.slab, None, None
        if slab is not None:
            self.pool.release(slab)


def alloc_block(
    pool: SlabPool,
    count: int,
    item_shape: Tuple[int, ...],
    dtype,
    padded_rows: Optional[int] = None,
) -> SlabBlock:
    """Acquire a slab sized for ``padded_rows`` (default ``count``)
    items of ``item_shape``/``dtype`` and return the
    :class:`SlabBlock` over it, pad rows zeroed.  The caller fills
    rows ``[0, count)`` — typically by ``recv_into`` straight off a
    socket.  Raises :class:`PayloadTooLarge` past the pool cap."""
    count = int(count)
    padded = count if padded_rows is None else max(int(padded_rows), count)
    dtype = np.dtype(dtype)
    shape = (padded,) + tuple(int(d) for d in item_shape)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    slab = pool.acquire(nbytes)
    arr = np.ndarray(shape, dtype=dtype, buffer=slab.buf[:nbytes])
    if padded > count:
        arr[count:] = 0
    return SlabBlock(pool, slab, arr, count)


def send_frame(conn, msg: dict) -> None:
    conn.send_bytes(pack_frame(msg))


def recv_frame(conn, timeout: Optional[float] = None) -> dict:
    """Receive one frame; ``timeout`` (seconds) raises ``TimeoutError``
    instead of blocking forever — the ready-handshake path."""
    if timeout is not None and not conn.poll(timeout):
        raise TimeoutError(f"no frame within {timeout:.1f}s")
    return unpack_frame(conn.recv_bytes())


# ------------------------------------------------- cross-host framing (v2)


def pack_stream_frame(msg: dict, payload: bytes = b"") -> bytes:
    """Serialize one socket frame: prefix + JSON body + inline payload.
    The body carries the control message (op, flush id, array meta);
    ``payload`` is the raw array bytes for remote peers that cannot
    attach a slab."""
    if not isinstance(msg, dict):
        raise WireError(f"frame body must be a dict, got {type(msg).__name__}")
    try:
        body = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    except (TypeError, ValueError) as e:
        raise WireError(f"unserializable frame body: {e}") from e
    payload = bytes(payload)
    crc = zlib.crc32(payload, zlib.crc32(body)) & 0xFFFFFFFF
    return (
        MAGIC
        + bytes([SOCKET_VERSION])
        + _STREAM_HEADER.pack(len(body), len(payload), crc)
        + body
        + payload
    )


def _wait_readable(sock, timeout: Optional[float]) -> bool:
    """``select``-based wait for readability; ``None`` blocks forever.

    Readers MUST wait this way rather than via ``settimeout``: the
    socket-object timeout is shared with the send direction (it caps the
    total duration of ``sendall``), and reader threads share the socket
    with sender threads — a reader that narrowed the timeout to its
    0.25s idle poll would abort any concurrent ``sendall`` that cannot
    flush within one poll interval, condemning a healthy channel the
    moment a sizeable payload meets a full kernel send buffer.  A socket
    closed out from under the wait surfaces as ``OSError``."""
    try:
        ready, _, _ = select.select([sock], [], [], timeout)
    except ValueError:
        # a concurrent close() already set fileno() to -1
        raise OSError("socket closed while waiting for a frame") from None
    return bool(ready)


def _recv_exact(sock, n: int, idle_timeout: Optional[float]) -> bytes:
    """Read exactly ``n`` bytes from ``sock``.

    ``idle_timeout`` bounds the wait for the FIRST byte only (an idle
    channel raises ``TimeoutError`` — the caller's poll loop); once any
    byte of a frame has arrived the rest must land within
    :data:`MID_FRAME_TIMEOUT_S` or the frame is declared torn
    (:class:`WireError`).  A peer that closes cleanly between frames
    raises ``EOFError``; a close MID-read is a truncated frame and
    raises :class:`WireError`.  All waiting rides
    :func:`_wait_readable`, so the socket's own timeout — the
    concurrent-send budget — is never disturbed.
    """
    chunks: List[bytes] = []
    got = 0
    while got < n:
        budget = idle_timeout if got == 0 else MID_FRAME_TIMEOUT_S
        if not _wait_readable(sock, budget):
            if got == 0:
                raise TimeoutError(f"no frame within {idle_timeout}s")
            raise WireError(
                f"stream frame stalled mid-read ({got}/{n} bytes)"
            )
        try:
            chunk = sock.recv(n - got)
        except (BlockingIOError, InterruptedError):
            continue  # spurious readability; re-arm the wait
        if not chunk:
            if got == 0:
                raise EOFError("peer closed the connection")
            raise WireError(
                f"truncated stream frame (peer closed at {got}/{n} bytes)"
            )
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_stream_frame(sock, msg: dict, payload: bytes = b"") -> None:
    """Write one socket frame (blocking ``sendall``)."""
    sock.sendall(pack_stream_frame(msg, payload))


def recv_stream_frame(
    sock,
    timeout: Optional[float] = None,
    max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
) -> Tuple[dict, bytes]:
    """Receive one socket frame; returns ``(msg, payload_bytes)``.

    ``timeout`` is the IDLE timeout (seconds until the first byte);
    raises ``TimeoutError`` when no frame starts in time, ``EOFError``
    on a clean close between frames, and :class:`WireError` on
    anything torn: truncation mid-frame, foreign magic, version skew,
    oversized length fields, or a CRC mismatch.
    """
    prefix = _recv_exact(sock, _STREAM_PREFIX_LEN, timeout)
    if prefix[: len(MAGIC)] != MAGIC:
        raise WireError("bad stream-frame magic (foreign or torn stream)")
    ver = prefix[len(MAGIC)]
    if ver != SOCKET_VERSION:
        raise WireError(
            f"stream-frame version {ver} != {SOCKET_VERSION} (peer skew)"
        )
    body_len, payload_len, crc = _STREAM_HEADER.unpack(
        prefix[len(MAGIC) + 1 :]
    )
    if body_len + payload_len > max_frame_bytes:
        raise WireError(
            f"stream frame claims {body_len + payload_len} bytes "
            f"(cap {max_frame_bytes}); refusing before allocation"
        )
    try:
        body = (
            _recv_exact(sock, body_len, MID_FRAME_TIMEOUT_S)
            if body_len
            else b""
        )
        payload = (
            _recv_exact(sock, payload_len, MID_FRAME_TIMEOUT_S)
            if payload_len
            else b""
        )
    except (TimeoutError, EOFError) as e:
        # the header already landed: any stall or close past it is a
        # torn frame, never an idle channel
        raise WireError(f"truncated stream frame: {e}") from None
    got_crc = zlib.crc32(payload, zlib.crc32(body)) & 0xFFFFFFFF
    if got_crc != crc:
        raise WireError(
            f"stream-frame CRC mismatch (got {got_crc:#010x}, "
            f"header {crc:#010x}) — bytes damaged in flight"
        )
    try:
        parsed = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"unparseable stream-frame body: {e}") from e
    if not isinstance(parsed, dict):
        raise WireError(
            f"stream-frame body must be a dict, got {type(parsed).__name__}"
        )
    return parsed, payload


def array_payload(arr: np.ndarray) -> Tuple[dict, bytes]:
    """``(meta, bytes)`` for shipping an array inline in a stream
    frame — the cross-host analogue of :func:`write_array`'s slab
    reference."""
    arr = np.ascontiguousarray(arr)
    meta = {
        "shape": list(arr.shape),
        "dtype": arr.dtype.str,
        "nbytes": int(arr.nbytes),
    }
    return meta, arr.tobytes()


def payload_array(meta: dict, payload: bytes) -> np.ndarray:
    """Rehydrate an inline array payload; raises :class:`WireError`
    when the meta and the byte count disagree (a mismatch that survived
    the CRC means the SENDER was confused — fail loudly)."""
    dtype = np.dtype(meta["dtype"])
    shape = tuple(int(d) for d in meta["shape"])
    expect = int(meta["nbytes"])
    if len(payload) != expect:
        raise WireError(
            f"array payload carries {len(payload)} bytes but meta "
            f"claims {expect}"
        )
    return np.frombuffer(payload, dtype=dtype).reshape(shape).copy()
