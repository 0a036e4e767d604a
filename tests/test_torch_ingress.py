"""The binary ingress (keystone_tpu_torch/serve/ingress.py) against the
reference's tests/test_ingress.py, one counterpart each, on the CPU:
batch-frame hardening (garbage magic, version skew, truncation, CRC
damage, oversize refusal, mid-frame stall: each a typed verdict, never a
hang), HTTP sniffed on the same port, slab-direct admission, typed
admission refusals that keep the connection, and the binary predictions
bit for bit the HTTP JSON path's.  Then what the port adds: frames
packed by either package unpacked by the other (batch, wire and stream
frames), the reference's BinaryClient against the port's ingress, the
ingress in front of a process fleet (bit for bit the JSON path's, no
byte copied on the slab-direct path), and the served scores against
the reference's threaded serve().

Every wait is bounded."""

import json
import socket
import struct
import threading
import time
import urllib.request
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models.linear import LinearMapper as JLinearMapper
from keystone_tpu.ops.stats import NormalizeRows as JNormalizeRows
from keystone_tpu.serve import ingress as jing
from keystone_tpu.serve import serve as jserve
from keystone_tpu.serve import wire as jwire
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.ops.stats import NormalizeRows
from keystone_tpu_torch.serve import ingress as ing
from keystone_tpu_torch.serve import serve, wire
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import Pipeline

pytestmark = pytest.mark.serve

DIM = 6


WAIT = 60  # seconds: the bound of every future wait


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    """The reference's serve() turns on JAX's persistent compilation cache
    for the process unless KEYSTONE_COMPILE_CACHE says no."""
    monkeypatch.setenv("KEYSTONE_COMPILE_CACHE", "0")


def _pipeline(scale: float = 2.0) -> Pipeline:
    return Pipeline.of(NormalizeRows()) | LinearMapper(torch.eye(DIM) * scale)


def _offline(x) -> np.ndarray:
    return _pipeline()(Dataset(x, device="cpu")).get().numpy()


def _service(**kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("queue_bound", 64)
    kw.setdefault("example", np.zeros(DIM, np.float32))
    if not kw.get("workers"):
        kw.setdefault("devices", ["cpu"])
    return serve(_pipeline(), **kw)


def _counter(name: str, **labels) -> float:
    return metrics.REGISTRY.counter_value(name, **labels)


@pytest.fixture(scope="module")
def served():
    """One module-scoped service + single-shard ingress: frame fuzzing
    and protocol tests don't need fresh state per test."""
    with _service() as svc:
        srv = ing.serve_ingress(svc, port=0, shards=1, stall_timeout_s=0.5)
        try:
            yield svc, srv
        finally:
            srv.stop()


def _dial(srv) -> socket.socket:
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=10.0)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def _recv(s, timeout=10.0):
    return ing.recv_batch_frame(s, timeout=timeout)


def _assert_hangup(s):
    """A condemned connection ends in FIN or RST (the server may close
    with unread bytes still queued, which the kernel turns into RST) —
    either way the peer sees a hard hangup, never a hang."""
    try:
        assert s.recv(1) == b""
    except ConnectionResetError:
        pass


# -------------------------------------------------------- frame packing


def test_batch_frame_roundtrip_through_pack_and_recv():
    a, b = socket.socketpair()
    try:
        payload = np.arange(12, dtype=np.float32).tobytes()
        msg = {"op": "predict", "count": 2, "dtype": "<f4", "shape": [DIM]}
        a.sendall(ing.pack_batch_frame(msg, payload))
        got, gpayload = ing.recv_batch_frame(b, timeout=5.0)
        assert got == msg and gpayload == payload
    finally:
        a.close()
        b.close()


def test_batch_magic_is_distinct_from_worker_wire_magic():
    # a batch client dialing a worker port (or vice versa) must fail
    # the MAGIC check, not a confusing length parse
    assert ing.BATCH_MAGIC != wire.MAGIC
    assert len(ing.BATCH_MAGIC) == len(wire.MAGIC) == 4


def test_client_recv_rejects_garbage_magic():
    a, b = socket.socketpair()
    try:
        frame = ing.pack_batch_frame({"op": "ping"})
        a.sendall(b"XXXX" + frame[4:])
        with pytest.raises(wire.WireError, match="magic"):
            ing.recv_batch_frame(b, timeout=5.0)
    finally:
        a.close()
        b.close()


def test_client_recv_rejects_version_skew():
    a, b = socket.socketpair()
    try:
        frame = bytearray(ing.pack_batch_frame({"op": "ping"}))
        frame[len(ing.BATCH_MAGIC)] = ing.BATCH_VERSION + 1
        a.sendall(bytes(frame))
        with pytest.raises(wire.WireError, match="version"):
            ing.recv_batch_frame(b, timeout=5.0)
    finally:
        a.close()
        b.close()


def test_client_recv_rejects_truncation_and_crc_damage():
    # close mid-body: torn, not a clean goodbye
    a, b = socket.socketpair()
    try:
        frame = ing.pack_batch_frame({"op": "predict"}, b"payload-bytes")
        a.sendall(frame[:-3])
        a.close()
        with pytest.raises(wire.WireError, match="truncated"):
            ing.recv_batch_frame(b, timeout=5.0)
    finally:
        b.close()

    # flip a payload bit: CRC verdict
    a, b = socket.socketpair()
    try:
        frame = bytearray(ing.pack_batch_frame({"op": "predict"}, b"abcdef"))
        frame[-1] ^= 0x40
        a.sendall(bytes(frame))
        with pytest.raises(wire.WireError, match="CRC"):
            ing.recv_batch_frame(b, timeout=5.0)
    finally:
        a.close()
        b.close()


def test_client_recv_refuses_oversize_before_allocating():
    a, b = socket.socketpair()
    try:
        a.sendall(ing.pack_batch_frame({"op": "predict"}, b"x" * 256))
        with pytest.raises(wire.WireError, match="cap"):
            ing.recv_batch_frame(b, timeout=5.0, max_frame_bytes=64)
    finally:
        a.close()
        b.close()


# ------------------------------------------------- server frame hardening


def test_server_rejects_garbage_magic_with_typed_error(served):
    # garbage on a FRESH connection sniffs as HTTP; bad_magic is a
    # mid-stream verdict — frame one must be valid binary first
    _, srv = served
    s = _dial(srv)
    try:
        before = _counter("ingress.frame_errors", kind="bad_magic")
        s.sendall(ing.pack_batch_frame({"op": "ping"}))
        reply, _ = _recv(s)
        assert reply["op"] == "pong"
        s.sendall(b"XXXX" + b"\x00" * 32)
        reply, _ = _recv(s)
        assert reply["op"] == "error" and reply["kind"] == "bad_magic"
        # framing violation condemns the connection
        _assert_hangup(s)
        assert _counter("ingress.frame_errors", kind="bad_magic") == before + 1
    finally:
        s.close()


def test_server_rejects_version_skew_with_typed_error(served):
    _, srv = served
    s = _dial(srv)
    try:
        frame = bytearray(ing.pack_batch_frame({"op": "ping"}))
        frame[len(ing.BATCH_MAGIC)] = ing.BATCH_VERSION + 7
        s.sendall(bytes(frame))
        reply, _ = _recv(s)
        assert reply["kind"] == "version_skew"
        _assert_hangup(s)
    finally:
        s.close()


def test_server_rejects_crc_damage_with_typed_error(served):
    _, srv = served
    x = np.ones((2, DIM), np.float32)
    msg = {"op": "predict", "count": 2, "dtype": x.dtype.str, "shape": [DIM]}
    s = _dial(srv)
    try:
        frame = bytearray(ing.pack_batch_frame(msg, x.tobytes()))
        frame[-1] ^= 0x40
        s.sendall(bytes(frame))
        reply, _ = _recv(s)
        assert reply["kind"] == "crc_mismatch"
        _assert_hangup(s)
    finally:
        s.close()


def test_server_refuses_oversize_frame_before_reading_it(served):
    _, srv = served
    s = _dial(srv)
    try:
        # a prefix CLAIMING a huge frame — no bytes behind it; the
        # refusal must come from the header alone
        huge = srv.max_frame_bytes + 1
        prefix = (
            ing.BATCH_MAGIC
            + bytes([ing.BATCH_VERSION])
            + ing._HEADER.pack(64, huge, 0)
        )
        s.sendall(prefix)
        reply, _ = _recv(s)
        assert reply["kind"] == "oversize"
        _assert_hangup(s)
    finally:
        s.close()


def test_server_rejects_unparseable_body_and_unknown_op(served):
    _, srv = served
    s = _dial(srv)
    try:
        body = b"not json at all"
        crc = zlib.crc32(body) & 0xFFFFFFFF
        s.sendall(
            ing.BATCH_MAGIC
            + bytes([ing.BATCH_VERSION])
            + ing._HEADER.pack(len(body), 0, crc)
            + body
        )
        reply, _ = _recv(s)
        assert reply["kind"] == "bad_body"
    finally:
        s.close()

    s = _dial(srv)
    try:
        s.sendall(ing.pack_batch_frame({"op": "launder"}))
        reply, _ = _recv(s)
        assert reply["kind"] == "bad_op"
    finally:
        s.close()


def test_server_rejects_header_payload_length_mismatch(served):
    _, srv = served
    s = _dial(srv)
    try:
        x = np.ones((2, DIM), np.float32)
        msg = {
            "op": "predict",
            "count": 3,  # claims 3 rows, payload carries 2
            "dtype": x.dtype.str,
            "shape": [DIM],
        }
        s.sendall(ing.pack_batch_frame(msg, x.tobytes()))
        reply, _ = _recv(s)
        assert reply["kind"] == "bad_body" and "claims" in reply["error"]
    finally:
        s.close()


def test_server_refuses_non_numeric_dtypes_with_typed_error(served):
    """The wire dtype is attacker-controlled and must be allowlisted:
    dtype "O" over the shared-memory slab would reinterpret raw socket
    bytes as PyObject pointers (a remote segfault on first deref);
    strings/datetimes/void are refused with the same typed verdict."""
    _, srv = served
    for spec in ["O", "U4", "M8[ns]", "S8", "V16"]:
        itemsize = np.dtype(spec).itemsize
        s = _dial(srv)
        try:
            msg = {"op": "predict", "count": 1, "dtype": spec, "shape": [2]}
            s.sendall(ing.pack_batch_frame(msg, b"\x00" * (2 * itemsize)))
            reply, _ = _recv(s)
            assert reply["kind"] == "bad_body", spec
            assert "not admissible" in reply["error"], spec
        finally:
            s.close()


def test_server_refuses_overflow_and_nonpositive_dims_typed(served):
    """Header dims are validated with overflow-safe Python-int math: a
    product that wraps a fixed-width accumulator into matching
    payload_len, negative dims that cancel, and zero dims must all get
    a typed bad_body refusal — never an untyped alloc failure."""
    _, srv = served
    cases = [
        ([1 << 31, 1 << 33], b""),  # int64 product wraps to exactly 0
        ([-1, -1], b"\x00" * 4),  # negatives cancel to a +1 product
        ([0], b""),  # zero-size rows
    ]
    for shape, payload in cases:
        s = _dial(srv)
        try:
            msg = {
                "op": "predict",
                "count": 1,
                "dtype": "<f4",
                "shape": shape,
            }
            s.sendall(ing.pack_batch_frame(msg, payload))
            reply, _ = _recv(s)
            assert reply["kind"] == "bad_body", shape
        finally:
            s.close()


def test_partial_magic_stall_is_condemned_and_does_not_spin(served):
    """A peer sending a strict prefix of the magic then stalling used
    to sit unconsumed under MSG_PEEK — invisible to the stall sweep,
    and spinning the level-triggered selector at full CPU.  The bytes
    are now consumed into the frame buffer, so the conn is mid-frame:
    the sweep condemns it bounded, and the drained socket stops waking
    the selector (the wait must cost ~no process CPU)."""
    _, srv = served
    before = _counter("ingress.frame_errors", kind="mid_frame_stall")
    s = _dial(srv)
    try:
        s.sendall(ing.BATCH_MAGIC[:2])
        t0, c0 = time.monotonic(), time.process_time()
        assert s.recv(1, socket.MSG_WAITALL) == b""  # server hangs up
        wall, cpu = time.monotonic() - t0, time.process_time() - c0
        assert wall < 10.0  # bounded, never a hang
        assert cpu < 0.4  # a spinning shard loop would burn ~wall CPU
        assert (
            _counter("ingress.frame_errors", kind="mid_frame_stall")
            == before + 1
        )
    finally:
        s.close()


def test_magic_split_across_sniff_still_parses(served):
    """Bytes consumed during the sniff must flow into the prefix
    parser: a client trickling the magic a byte at a time still gets
    its frame served."""
    _, srv = served
    s = _dial(srv)
    try:
        frame = ing.pack_batch_frame({"op": "ping"})
        for i in range(len(ing.BATCH_MAGIC)):
            s.sendall(frame[i : i + 1])
            time.sleep(0.02)
        s.sendall(frame[len(ing.BATCH_MAGIC) :])
        reply, _ = _recv(s)
        assert reply["op"] == "pong"
    finally:
        s.close()


def test_shard_loop_survives_internal_handler_error(served, monkeypatch):
    """An unanticipated exception escaping the per-connection path
    drops that conn (counted as kind=internal) but must never kill the
    shard loop — the listener keeps serving everyone else."""
    _, srv = served
    before = _counter("ingress.frame_errors", kind="internal")

    def boom(*a, **kw):
        raise RuntimeError("synthetic handler bug")

    monkeypatch.setattr(srv, "_parse_prefix", boom)
    s = _dial(srv)
    try:
        s.sendall(ing.pack_batch_frame({"op": "ping"}))
        _assert_hangup(s)
    finally:
        s.close()
    monkeypatch.undo()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if _counter("ingress.frame_errors", kind="internal") == before + 1:
            break
        time.sleep(0.01)
    assert _counter("ingress.frame_errors", kind="internal") == before + 1
    with ing.BinaryClient("127.0.0.1", srv.port) as cli:
        assert cli.ping()["op"] == "pong"  # the shard loop is alive


def test_server_mid_frame_stall_is_condemned_never_a_hang(served):
    """A peer that starts a frame and goes silent holds a TORN channel:
    the stall sweep (stall_timeout_s=0.5 here) condemns it bounded."""
    _, srv = served
    s = _dial(srv)
    try:
        before = _counter("ingress.frame_errors", kind="mid_frame_stall")
        frame = ing.pack_batch_frame(
            {"op": "predict", "count": 1, "dtype": "<f4", "shape": [DIM]},
            np.ones(DIM, np.float32).tobytes(),
        )
        s.sendall(frame[:20])  # past the prefix, then silence
        t0 = time.monotonic()
        assert s.recv(1, socket.MSG_WAITALL) == b""  # server hangs up
        assert time.monotonic() - t0 < 10.0  # bounded, never a hang
        assert (
            _counter("ingress.frame_errors", kind="mid_frame_stall")
            == before + 1
        )
    finally:
        s.close()


def test_server_half_frame_then_eof_counts_truncated(served):
    _, srv = served
    before = _counter("ingress.frame_errors", kind="truncated")
    s = _dial(srv)
    frame = ing.pack_batch_frame(
        {"op": "predict", "count": 1, "dtype": "<f4", "shape": [DIM]},
        np.ones(DIM, np.float32).tobytes(),
    )
    s.sendall(frame[:-5])
    s.close()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if _counter("ingress.frame_errors", kind="truncated") == before + 1:
            return
        time.sleep(0.01)
    raise AssertionError("truncated EOF never counted")


# ------------------------------------------------------ predict semantics


def test_binary_predict_matches_offline_apply(served):
    svc, srv = served
    x = np.random.default_rng(0).normal(size=(5, DIM)).astype(np.float32)
    ref = _offline(x)[:5]
    with ing.BinaryClient("127.0.0.1", srv.port) as cli:
        got = cli.predict(x)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_binary_predict_is_bit_identical_to_http_json(served):
    """THE bit-identity pin: the zero-copy binary path and the JSON
    slow path — same port — return byte-for-byte equal predictions.
    float32 survives the JSON text round-trip exactly, so any
    difference would be a real numeric divergence."""
    _, srv = served
    x = np.random.default_rng(7).normal(size=(4, DIM)).astype(np.float32)
    with ing.BinaryClient("127.0.0.1", srv.port) as cli:
        got_bin = cli.predict(x)
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/predict",
        data=json.dumps({"instances": x.tolist()}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30.0) as resp:
        got_http = np.asarray(
            json.loads(resp.read())["predictions"], np.float32
        )
    assert got_bin.tobytes() == got_http.tobytes()


def test_keep_alive_many_frames_one_connection(served):
    _, srv = served
    x = np.random.default_rng(3).normal(size=(3, DIM)).astype(np.float32)
    with ing.BinaryClient("127.0.0.1", srv.port) as cli:
        assert cli.ping()["op"] == "pong"
        first = cli.predict(x)
        for _ in range(4):
            np.testing.assert_array_equal(cli.predict(x), first)
        assert cli.ping()["shards"] == 1


def test_admission_refusal_is_typed_and_keeps_the_connection(served):
    _, srv = served
    with ing.BinaryClient("127.0.0.1", srv.port) as cli:
        with pytest.raises(ing.IngressError) as ei:
            cli.predict(np.ones((2, DIM + 1), np.float32))  # wrong width
        assert ei.value.kind == "bad_request"
        # the stream is fine — the REQUEST was refused; next frame works
        out = cli.predict(np.ones((2, DIM), np.float32))
        assert out.shape == (2, DIM)


def test_expired_deadline_is_a_typed_deadline_refusal(served):
    _, srv = served
    with ing.BinaryClient("127.0.0.1", srv.port) as cli:
        with pytest.raises(ing.IngressError) as ei:
            cli.predict(np.ones((2, DIM), np.float32), deadline_ms=0.0001)
        assert ei.value.kind == "deadline"
        assert cli.ping()["op"] == "pong"


def test_preformed_flush_counts_and_admission_is_zero_copy(served):
    """An exact-bucket binary batch flushes PREFORMED (no stack, no
    re-pad) and admission itself copies nothing — the copy counters
    charge only the response assembly, never the request path."""
    svc, srv = served
    flushes0 = _counter("serve.preformed_flushes")
    copied0 = _counter("ingress.bytes_copied")
    x = np.random.default_rng(5).normal(
        size=(svc.max_batch, DIM)
    ).astype(np.float32)
    with ing.BinaryClient("127.0.0.1", srv.port) as cli:
        cli.predict(x)
    assert _counter("serve.preformed_flushes") >= flushes0 + 1
    assert _counter("ingress.bytes_copied") == copied0  # HTTP-only counter


def test_batch_wider_than_max_batch_spans_flushes(served):
    svc, srv = served
    n = svc.max_batch * 2 + 3
    x = np.random.default_rng(9).normal(size=(n, DIM)).astype(np.float32)
    ref = _offline(x)[:n]
    with ing.BinaryClient("127.0.0.1", srv.port) as cli:
        got = cli.predict(x)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_http_sniff_delegates_same_port(served):
    _, srv = served
    with urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/healthz", timeout=10.0
    ) as resp:
        assert resp.status == 200


def test_concurrent_binary_clients_all_complete(served):
    _, srv = served
    x = np.random.default_rng(11).normal(size=(4, DIM)).astype(np.float32)
    ref = _offline(x)[:4]
    errs = []

    def run():
        try:
            with ing.BinaryClient("127.0.0.1", srv.port) as cli:
                for _ in range(5):
                    np.testing.assert_allclose(
                        cli.predict(x), ref, rtol=1e-6, atol=1e-7
                    )
        except Exception as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=run) for _ in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60.0)
    assert not errs, errs


# ----------------------------------------------------------------- shards


def test_two_shards_serve_one_port():
    if not hasattr(socket, "SO_REUSEPORT"):
        pytest.skip("platform lacks SO_REUSEPORT")
    x = np.random.default_rng(2).normal(size=(3, DIM)).astype(np.float32)
    ref = _offline(x)[:3]
    with _service() as svc:
        srv = ing.serve_ingress(svc, port=0, shards=2)
        try:
            assert srv.shards == 2
            clis = [ing.BinaryClient("127.0.0.1", srv.port) for _ in range(4)]
            try:
                for cli in clis:
                    assert cli.ping()["shards"] == 2
                    np.testing.assert_allclose(
                        cli.predict(x), ref, rtol=1e-6, atol=1e-7
                    )
            finally:
                for cli in clis:
                    cli.close()
        finally:
            srv.stop()


def test_stop_is_idempotent_and_unbinds():
    with _service() as svc:
        srv = ing.serve_ingress(svc, port=0, shards=1)
        port = srv.port
        srv.stop()
        srv.stop()
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", port), timeout=0.5)


# ------------------------------------------------------- request-id parity


def test_binary_request_id_parity_with_http(served):
    """KSBB has the HTTP front end's request-id contract: a supplied
    ``request_id`` is honored (fanned out per row, exactly the HTTP
    multi-instance rule), an absent one is minted server-side, and the
    ids come back in success bodies AND typed refusals alike."""
    svc, srv = served
    with ing.BinaryClient("127.0.0.1", srv.port) as cli:
        cli.predict(np.ones((2, DIM), np.float32), request_id="order-9")
        assert cli.last_request_ids == ["order-9/0", "order-9/1"]
        cli.predict(np.ones((1, DIM), np.float32), request_id="solo-1")
        assert cli.last_request_ids == ["solo-1"]
        cli.predict(np.ones((2, DIM), np.float32))
        minted = cli.last_request_ids
        assert len(minted) == 2 and all(minted)
        # a typed refusal names the rows it refused
        with pytest.raises(ing.IngressError) as ei:
            cli.predict(
                np.ones((2, DIM), np.float32),
                deadline_ms=0.0001,
                request_id="doomed-bin",
            )
        assert ei.value.kind == "deadline"
        assert ei.value.request_ids == ["doomed-bin/0", "doomed-bin/1"]
        # the ids enter the same /requestz loop as HTTP ids
        if svc.recorder is not None:
            assert svc.recorder.request("order-9/0") is not None


def test_statusz_ingress_block_covers_binary_front_end(served):
    svc, srv = served
    with ing.BinaryClient("127.0.0.1", srv.port) as cli:
        cli.predict(np.ones((2, DIM), np.float32))
    blk = svc.status().get("ingress")
    assert blk is not None
    assert blk["accepts"] >= 1 and blk["bin_conns"] >= 1
    assert blk["frames"] >= 1 and blk["batch_rows"] >= 2
    assert isinstance(blk["frame_errors"], dict)
    assert blk["parse_ms"] is None or blk["parse_ms"]["count"] >= 1
    assert blk["admit_ms"] is None or blk["admit_ms"]["count"] >= 1
    assert "bytes_copied" in blk


# ----------------------------------------------- across the two packages


def test_batch_frames_unpack_in_the_other_package():
    payload = np.arange(12, dtype=np.float32).tobytes()
    msg = {"op": "predict", "count": 2, "dtype": "<f4", "shape": [DIM], "seq": 3}
    assert ing.pack_batch_frame(msg, payload) == jing.pack_batch_frame(msg, payload)
    for pack, recv in ((ing.pack_batch_frame, jing.recv_batch_frame), (jing.pack_batch_frame, ing.recv_batch_frame)):
        a, b = socket.socketpair()
        try:
            a.sendall(pack(msg, payload))
            got, gpayload = recv(b, timeout=5.0)
            assert got == msg and gpayload == payload
        finally:
            a.close()
            b.close()


def test_wire_and_stream_frames_unpack_in_the_other_package():
    msg = {"op": "apply", "n": 3, "deadline_s": None, "ref": {"slab": "s", "shape": [8, DIM]}}
    assert (wire.MAGIC, wire.VERSION, wire.SOCKET_VERSION) == (jwire.MAGIC, jwire.VERSION, jwire.SOCKET_VERSION)
    assert jwire.unpack_frame(wire.pack_frame(msg)) == msg
    assert wire.unpack_frame(jwire.pack_frame(msg)) == msg
    arr = np.random.default_rng(0).normal(size=(4, DIM)).astype(np.float32)
    for pack_payload, pack, recv, read in (
        (wire.array_payload, wire.pack_stream_frame, jwire.recv_stream_frame, jwire.payload_array),
        (jwire.array_payload, jwire.pack_stream_frame, wire.recv_stream_frame, wire.payload_array),
    ):
        meta, data = pack_payload(arr)
        a, b = socket.socketpair()
        try:
            a.sendall(pack({"op": "result", "fid": "f1", "meta": meta}, data))
            got, gdata = recv(b, timeout=5.0)
        finally:
            a.close()
            b.close()
        assert got["fid"] == "f1" and read(got["meta"], gdata).tobytes() == arr.tobytes()


def test_slab_blocks_attach_across_the_packages():
    """A block the port allocates is read by the reference's attacher from
    its reference, and the other way round."""
    ours, theirs = wire.SlabPool(prefix="t_x_ours"), jwire.SlabPool(prefix="t_x_ref")
    a_ours, a_ref = wire.SlabAttacher(), jwire.SlabAttacher()
    try:
        x = np.random.default_rng(1).normal(size=(3, DIM)).astype(np.float32)
        b1 = wire.alloc_block(ours, 3, (DIM,), np.float32, padded_rows=8)
        b1.array[:3] = x
        b2 = jwire.alloc_block(theirs, 3, (DIM,), np.float32, padded_rows=8)
        b2.array[:3] = x
        for got in (a_ref.read(b1.ref), a_ours.read(b2.ref)):
            assert got.shape == (8, DIM) and got[:3].tobytes() == x.tobytes() and not got[3:].any()
        b1.close()
        b2.close()
    finally:
        a_ours.close()
        a_ref.close()
        ours.close()
        theirs.close()


def test_reference_binary_client_against_the_port_ingress(served):
    """The reference's BinaryClient speaks to the port's AsyncIngress and
    gets the port's in-process scores."""
    svc, srv = served
    x = np.random.default_rng(13).normal(size=(5, DIM)).astype(np.float32)
    want = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(x)])
    with jing.BinaryClient("127.0.0.1", srv.port) as cli:
        assert cli.ping()["op"] == "pong"
        got = cli.predict(x)
    assert got.tobytes() == want.tobytes()


def test_ingress_serves_the_reference_scores():
    """The same seeded rows and weights through the reference's threaded
    serve() and through the port's ingress: the same rows at 1e-5."""
    rng = np.random.default_rng(17)
    w = rng.normal(size=(DIM, 4)).astype(np.float32)
    x = rng.normal(size=(11, DIM)).astype(np.float32)
    kw = dict(max_batch=8, max_wait_ms=5.0, queue_bound=64, example=np.zeros(DIM, np.float32))
    with jserve(JPipeline.of(JNormalizeRows()) | JLinearMapper(jnp.asarray(w)), **kw) as ref:
        want = np.stack([np.asarray(f.result(timeout=WAIT)) for f in ref.submit_many(x)])
    with serve(Pipeline.of(NormalizeRows()) | LinearMapper(torch.from_numpy(w)), devices=["cpu"], **kw) as svc:
        srv = ing.serve_ingress(svc, port=0)
        try:
            with ing.BinaryClient("127.0.0.1", srv.port) as cli:
                got = cli.predict(x)
        finally:
            srv.stop()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_ingress_before_a_process_fleet_is_slab_direct():
    """The binary ingress in front of a process fleet: an exact-bucket
    batch is a preformed flush whose slab the worker attaches by
    reference (no admission copy, no dispatch copy), and the answers are
    bit for bit the HTTP JSON path's and the threaded fleet's."""
    x = np.random.default_rng(19).normal(size=(8, DIM)).astype(np.float32)
    with _service(max_batch=8, devices=["cpu"]) as ref:
        want = np.stack([f.result(timeout=WAIT) for f in ref.submit_many(x)])
    with _service(max_batch=8, workers=1, worker_opts={"device": "cpu"}, name="ing_proc") as svc:
        srv = ing.serve_ingress(svc, port=0)
        try:
            pre0, ing0 = _counter("serve.preformed_flushes"), _counter("ingress.bytes_copied")
            disp0 = _counter("dispatch.bytes_copied")
            with ing.BinaryClient("127.0.0.1", srv.port) as cli:
                got_bin = cli.predict(x)
            assert _counter("serve.preformed_flushes") == pre0 + 1
            assert _counter("ingress.bytes_copied") == ing0
            assert _counter("dispatch.bytes_copied") == disp0
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/predict",
                                         data=json.dumps({"instances": x.tolist()}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30.0) as resp:
                got_http = np.asarray(json.loads(resp.read())["predictions"], np.float32)
        finally:
            srv.stop()
    assert got_bin.tobytes() == got_http.tobytes() == want.tobytes()


def test_a_restarted_ingress_before_a_process_fleet_reads_fresh_rows():
    """An ingress stopped and served again in front of the same workers
    makes new admission slabs: the worker attaches the new rows, never
    the first ingress's unlinked segment of the same size."""
    rng = np.random.default_rng(23)
    x1, x2 = (rng.normal(size=(8, DIM)).astype(np.float32) for _ in range(2))
    with _service(max_batch=8, workers=1, worker_opts={"device": "cpu"}, name="ing_again") as svc:
        got = []
        for x in (x1, x2):
            srv = ing.serve_ingress(svc, port=0)
            try:
                with ing.BinaryClient("127.0.0.1", srv.port) as cli:
                    got.append(cli.predict(x))
            finally:
                srv.stop()
    np.testing.assert_allclose(got[0], _offline(x1), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1], _offline(x2), atol=1e-6, rtol=0)


def test_serve_bench_ingress_ab_on_the_cpu():
    """serve_bench's front-end A/B in front of a one-worker process fleet
    on the CPU: both arms answer, bit for bit on the probe, and the
    binary arm copies no byte at admission."""
    from keystone_tpu_torch.tools import serve_bench

    rep = serve_bench.run_ingress_ab(duration=0.3, rounds=1, dim=DIM, max_batch=8, shards=1, http_clients=2,
                                     bin_clients=2, device="cpu", workers=1)
    assert rep["predictions_identical"] and rep["workers"] == 1 and rep["bin_batch"] == 8
    assert rep["http"]["errors"] == 0 and rep["binary"]["errors"] == 0
    assert rep["http"]["per_datum_qps"] > 0 and rep["binary"]["per_datum_qps"] > 0
    assert rep["bytes_copied"]["binary"] == 0 and rep["bytes_copied"]["http"] > 0
    assert rep["preformed_flushes"] > 0
