"""The network fleet (keystone_tpu_torch/serve/net.py, the stream frames
of serve/wire.py, utils/hostmap.py) against the reference's
tests/test_netfleet.py, one counterpart each, on the CPU: stream-frame
hardening, the heartbeat lease and its two fencing edges (the router
forfeits the flush, the worker discards the finished result), the host
map's grammar, partition fault injection, and a live two-worker TCP
fleet: a partition mid-flight loses nothing and heals, and the
predictions are bit for bit the port's threaded fleet's.  Then what the
port adds: the served scores against the reference's threaded serve(),
the workers' kernel reports over the wire, and a deploy frame larger
than the stream cap.

Ordering: the local-path pins run before the module-scoped fleet exists
(a live fleet's beats call the ``serve.net.*`` sites all the time).
Every wait is bounded; every child is torn down in ``finally``."""

import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models.linear import LinearMapper as JLinearMapper
from keystone_tpu.ops.stats import NormalizeRows as JNormalizeRows
from keystone_tpu.serve import serve as jserve
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu_torch import faults
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.serve import net, wire
from keystone_tpu_torch.serve.procfleet import WorkerCrashed, WorkerSpawnError
from keystone_tpu_torch.utils import hostmap

pytestmark = pytest.mark.serve

DIM = 6


def _spair():
    """An in-process byte pipe for pure framing tests (no TCP stack)."""
    return socket.socketpair()


def _tcp_pair():
    """A real loopback TCP pair — NetWorkerHandle sets TCP options, so
    its tests need an AF_INET socket, not a socketpair."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = socket.create_connection(srv.getsockname())
    peer, _ = srv.accept()
    srv.close()
    cli.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    peer.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return cli, peer


def _close_all(*socks):
    for s in socks:
        try:
            s.close()
        except OSError:
            pass


# ------------------------------------------------- wire v2 stream frames
def test_stream_frame_roundtrip_with_array_payload():
    a, b = _spair()
    try:
        arr = np.arange(24, dtype=np.float32).reshape(4, 6) * 0.25
        meta, payload = wire.array_payload(arr)
        msg = {"op": "apply", "fid": "f1", "n": 4, "meta": meta}
        wire.send_stream_frame(a, msg, payload)
        got, gpayload = wire.recv_stream_frame(b, timeout=5.0)
        assert got == msg
        out = wire.payload_array(got["meta"], gpayload)
        assert out.tobytes() == arr.tobytes()
        assert out.dtype == arr.dtype
    finally:
        _close_all(a, b)


def test_stream_frame_roundtrip_empty_payload():
    a, b = _spair()
    try:
        wire.send_stream_frame(a, {"op": "beat"})
        got, payload = wire.recv_stream_frame(b, timeout=5.0)
        assert got == {"op": "beat"} and payload == b""
    finally:
        _close_all(a, b)


def test_stream_frame_rejects_truncation():
    # close mid-body: a torn frame, not a clean goodbye
    a, b = _spair()
    try:
        frame = wire.pack_stream_frame({"op": "apply"}, b"payload-bytes")
        a.sendall(frame[:-3])
        a.close()
        with pytest.raises(wire.WireError, match="truncated"):
            wire.recv_stream_frame(b, timeout=5.0)
    finally:
        _close_all(a, b)

    # close mid-PREFIX: same verdict
    a, b = _spair()
    try:
        a.sendall(frame[:5])
        a.close()
        with pytest.raises(wire.WireError, match="truncated"):
            wire.recv_stream_frame(b, timeout=5.0)
    finally:
        _close_all(a, b)


def test_stream_frame_rejects_garbage_magic():
    a, b = _spair()
    try:
        frame = wire.pack_stream_frame({"op": "beat"})
        a.sendall(b"XXXX" + frame[4:])
        with pytest.raises(wire.WireError, match="magic"):
            wire.recv_stream_frame(b, timeout=5.0)
    finally:
        _close_all(a, b)


def test_stream_frame_rejects_version_skew():
    a, b = _spair()
    try:
        frame = bytearray(wire.pack_stream_frame({"op": "beat"}))
        frame[len(wire.MAGIC)] = wire.VERSION  # the SLAB protocol version
        a.sendall(bytes(frame))
        with pytest.raises(wire.WireError, match="version"):
            wire.recv_stream_frame(b, timeout=5.0)
    finally:
        _close_all(a, b)


def test_stream_frame_rejects_crc_mismatch():
    a, b = _spair()
    try:
        frame = wire.pack_stream_frame({"op": "result"}, b"damaged-in-flight")
        a.sendall(net._corrupt_frame(frame))
        with pytest.raises(wire.WireError, match="CRC"):
            wire.recv_stream_frame(b, timeout=5.0)
    finally:
        _close_all(a, b)


def test_stream_frame_clean_close_is_eof_not_error():
    a, b = _spair()
    try:
        a.close()
        with pytest.raises(EOFError):
            wire.recv_stream_frame(b, timeout=5.0)
    finally:
        _close_all(b)


def test_stream_frame_refuses_oversize_before_allocating():
    a, b = _spair()
    try:
        wire.send_stream_frame(a, {"op": "apply"}, b"x" * 256)
        with pytest.raises(wire.WireError, match="cap"):
            wire.recv_stream_frame(b, timeout=5.0, max_frame_bytes=64)
    finally:
        _close_all(a, b)


def test_stream_frame_idle_timeout_raises_timeout():
    a, b = _spair()
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            wire.recv_stream_frame(b, timeout=0.2)
        assert time.monotonic() - t0 < 5.0  # bounded, never a hang
    finally:
        _close_all(a, b)


def test_stream_frame_mid_frame_stall_is_torn(monkeypatch):
    # a peer that starts a frame and stalls holds a TORN channel, not an
    # idle one — the receiver gives up on the frame, bounded
    monkeypatch.setattr(wire, "MID_FRAME_TIMEOUT_S", 0.3)
    a, b = _spair()
    try:
        frame = wire.pack_stream_frame({"op": "apply"}, b"abcdef")
        a.sendall(frame[:10])
        with pytest.raises(wire.WireError, match="stalled"):
            wire.recv_stream_frame(b, timeout=5.0)
    finally:
        _close_all(a, b)


def test_reader_idle_poll_never_caps_concurrent_sendall():
    """THE shared-socket timeout pin: a reader thread polling
    ``recv_stream_frame(timeout=0.25)`` — exactly the router/worker
    read loops — shares the socket with ``sendall`` callers, and the
    socket-object timeout caps sendall's TOTAL duration.  A send too
    large to flush before the peer starts reading must still complete:
    the reader waits via select and never narrows the send budget."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    cli = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        # tiny buffers: the frame cannot flush until the peer reads,
        # so sendall provably outlives many reader poll intervals
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16384)
        cli.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 16384)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        cli.connect(srv.getsockname())
        peer, _ = srv.accept()
    except OSError:
        srv.close()
        cli.close()
        raise
    srv.close()
    cli.settimeout(wire.SEND_TIMEOUT_S)  # the net.py setup discipline
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            try:
                wire.recv_stream_frame(cli, timeout=0.25)
            except TimeoutError:
                continue
            except (EOFError, OSError, wire.WireError):
                return

    payload = b"x" * (4 << 20)
    errs = []

    def send():
        try:
            wire.send_stream_frame(cli, {"op": "apply", "fid": "big"}, payload)
        except Exception as e:  # noqa: BLE001 — the pin IS "no exception"
            errs.append(e)

    reader = threading.Thread(target=poll, daemon=True)
    sender = threading.Thread(target=send, daemon=True)
    reader.start()
    sender.start()
    try:
        # hold the peer silent across several poll intervals: the send
        # is wedged on full buffers the whole time
        time.sleep(0.8)
        msg, got = wire.recv_stream_frame(peer, timeout=30.0)
        sender.join(10.0)
        assert not sender.is_alive()
        assert errs == []
        assert msg == {"op": "apply", "fid": "big"} and got == payload
    finally:
        stop.set()
        _close_all(cli, peer)
        reader.join(2.0)


def test_payload_array_rejects_meta_length_mismatch():
    meta, payload = wire.array_payload(np.zeros(8, np.float32))
    with pytest.raises(wire.WireError):
        wire.payload_array(meta, payload[:-4])


def test_parse_address_grammar():
    assert net.parse_address("10.0.0.5:9000") == ("10.0.0.5", 9000)
    with pytest.raises(ValueError):
        net.parse_address("no-port")
    with pytest.raises(ValueError):
        net.parse_address(":9000")


def test_payload_digest_is_content_addressed():
    assert net.payload_digest(b"gen-1") == net.payload_digest(b"gen-1")
    assert net.payload_digest(b"gen-1") != net.payload_digest(b"gen-2")


# --------------------------------------------------- network fault sites
def test_partition_alias_parses_to_drop():
    plan = faults.parse_plan("serve.net.send:partition:ctx.link=w0")
    assert plan.specs[0].action == "drop"
    assert plan.specs[0].match == {"link": "w0"}


def test_drop_rejected_outside_wire_sites():
    with pytest.raises(faults.FaultPlanError):
        faults.parse_plan("serve.enqueue:drop")
    with pytest.raises(faults.FaultPlanError):
        faults.parse_plan("ckpt.save:partition")


def test_fault_point_returns_wire_advisories():
    with faults.inject("serve.net.send:drop:ctx.link=w0"):
        assert faults.fault_point("serve.net.send", link="w0") == "drop"
        # context match: another link sails through
        assert faults.fault_point("serve.net.send", link="w1") is None
    with faults.inject("serve.net.recv:corrupt"):
        assert faults.fault_point("serve.net.recv", link="w0") == "corrupt"
    # no active plan: the site is inert
    assert faults.fault_point("serve.net.send", link="w0") is None


def test_raise_wins_over_drop_at_the_same_site():
    with faults.inject("serve.net.send:drop;serve.net.send:raise"):
        with pytest.raises(faults.FaultInjected):
            faults.fault_point("serve.net.send", link="w0")


def test_net_sites_registered():
    assert {
        "serve.net.connect",
        "serve.net.send",
        "serve.net.recv",
    } <= faults.SITES


def test_connect_drop_verdict_is_a_failed_dial():
    """A drop/partition plan at ``serve.net.connect`` must not parse
    and then silently do nothing: the verdict is a refused dial,
    absorbed (and retried) by the backoff ladder like any dead router."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)
    try:
        host, port = srv.getsockname()[:2]
        with faults.inject("serve.net.connect:drop:times=1"):
            sock = net._connect(
                host, port, "dial-w", attempts=3, base_delay=0.01
            )
            sock.close()
        # a persistent partition at the dial exhausts the ladder
        with faults.inject("serve.net.connect:partition"):
            with pytest.raises(net.ConnectRetriesExhausted):
                net._connect(
                    host, port, "dial-w", attempts=2, base_delay=0.01
                )
    finally:
        srv.close()


# ------------------------------------------------------------- host map
def test_parse_hosts_grammar():
    entries = hostmap.parse_hosts("local:2, 10.0.0.5:4")
    assert [(e.host, e.slots) for e in entries] == [
        ("local", 2),
        ("10.0.0.5", 4),
    ]
    assert entries[0].local and not entries[1].local
    # a bare host is unbounded; list and pair forms are accepted
    assert hostmap.parse_hosts(["bighost"])[0].slots is None
    assert hostmap.parse_hosts([("h", 3)])[0].slots == 3
    with pytest.raises(ValueError):
        hostmap.parse_hosts("")
    with pytest.raises(ValueError):
        hostmap.parse_hosts("h:xx")


def test_hostmap_capacity_and_exhaustion():
    hm = hostmap.HostMap("local:1,local:1")
    assert hm.capacity() == 2

    class _LiveProc:
        def poll(self):
            return None

    for e in hm.entries:
        e.spawned.append(_LiveProc())
    assert hm.in_flight() == 2
    with pytest.raises(hostmap.HostCapacityError):
        hm._pick()
    # any unbounded host makes total capacity unbounded
    assert hostmap.HostMap("local").capacity() is None


def test_hostmap_swap_overflow_exempts_slot_budget():
    """A staged swap generation coexists with the one it replaces
    until commit, so with a budget sized to the steady-state fleet the
    swap's spawns carry a transient overflow allowance — the hard
    budget stays hard for everyone else (autoscaler, heals)."""
    hm = hostmap.HostMap("local:1")

    class _LiveProc:
        def poll(self):
            return None

    hm.entries[0].spawned.append(_LiveProc())
    with pytest.raises(hostmap.HostCapacityError):
        hm._pick()
    assert hm._pick(allow_overflow=True) is hm.entries[0]


def test_hostmap_command_shapes():
    hm = hostmap.HostMap("local,gpu-02:4")
    local_cmd = hm._command(hm.entries[0], ["--connect", "127.0.0.1:1"])
    assert local_cmd[1:4] == ["-m", "keystone_tpu_torch.cli", "worker"]
    remote_cmd = hm._command(hm.entries[1], ["--connect", "127.0.0.1:1"])
    assert remote_cmd[0] == "ssh" and "gpu-02" in remote_cmd


# ------------------------------------------------ local paths stay local
WAIT = 60  # seconds: the bound of every future wait


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    """The reference's serve() turns on JAX's persistent compilation cache
    for the process unless KEYSTONE_COMPILE_CACHE says no."""
    monkeypatch.setenv("KEYSTONE_COMPILE_CACHE", "0")


def _pipeline(scale: float = 2.0):
    from keystone_tpu_torch.models.linear import LinearMapper
    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    return Pipeline.of(NormalizeRows()) | LinearMapper(torch.eye(DIM) * scale)


def _rows(k: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(k, DIM)).astype(np.float32)


def test_local_service_never_touches_net_sites():
    """With no remote peer configured the ``serve.net.*`` sites are
    structurally inert: a threaded service serves a request without a
    single call into them (this runs before the module fleet exists —
    a live fleet's heartbeats call these sites continuously)."""
    from keystone_tpu_torch.serve import serve

    faults.reset_stats()
    svc = serve(
        _pipeline(),
        devices=["cpu"],
        max_batch=8,
        max_wait_ms=1.0,
        example=np.zeros(DIM, np.float32),
        name="netfleet_local",
        supervise=False,
    )
    try:
        assert svc._pool.backend == "thread"
        assert svc._pool._listener is None and svc._pool._hostmap is None
        svc.submit(np.ones(DIM, np.float32)).result(timeout=WAIT)
    finally:
        svc.close(timeout=WAIT)
    st = faults.stats()
    for site in ("serve.net.connect", "serve.net.send", "serve.net.recv"):
        assert st.get(site, {}).get("calls", 0) == 0


def test_hosts_requires_worker_processes():
    from keystone_tpu_torch.serve import serve

    with pytest.raises(ValueError, match="workers"):
        serve(
            _pipeline(),
            hosts=["local"],
            example=np.zeros(DIM, np.float32),
            name="netfleet_bad",
        )


# ------------------------------------- router side vs a scripted worker
class _FakeWorker:
    """The far side of a NetWorkerHandle, scripted: answers the deploy
    with ``ready`` (or whatever ``ready`` says), then drains frames and
    consults ``on_apply`` — return ``(reply, payload)`` to answer or
    ``None`` to withhold.  ``beat_interval`` keeps the router's lease
    fresh; omit it to simulate a silent (partitioned/dead) worker."""

    def __init__(self, sock, on_apply=None, ready=None, beat_interval=None):
        self.sock = sock
        self.on_apply = on_apply
        self.ready = ready or {
            "op": "ready",
            "pid": 4242,
            "primed": 0,
            "reused": False,
            "artifact_buckets": 0,
            "artifact_keys": [],
            "startup_seconds": 0.0,
        }
        self.deploy = None
        self.frames = []
        self._send_lock = threading.Lock()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        if beat_interval is not None:
            threading.Thread(
                target=self._beat, args=(beat_interval,), daemon=True
            ).start()

    def send(self, msg, payload=b""):
        with self._send_lock:
            wire.send_stream_frame(self.sock, msg, payload)

    def _beat(self, interval):
        while not self._stop.wait(interval):
            try:
                self.send({"op": "beat"})
            except OSError:
                return

    def _run(self):
        try:
            msg, payload = wire.recv_stream_frame(self.sock, timeout=10.0)
            self.deploy = (msg, payload)
            self.send(self.ready)
            if self.ready.get("op") != "ready":
                return
            while True:
                msg, payload = wire.recv_stream_frame(self.sock, timeout=10.0)
                self.frames.append(msg)
                if msg.get("op") == "apply" and self.on_apply is not None:
                    out = self.on_apply(msg, payload)
                    if out is not None:
                        self.send(out[0], out[1])
                if msg.get("op") == "bye":
                    self.send({"op": "bye_ack"})
                    return
        except (TimeoutError, EOFError, OSError, wire.WireError):
            return
        finally:
            self._stop.set()

    def close(self):
        self._stop.set()
        _close_all(self.sock)


def test_handle_deploy_ships_digest_and_payload_inline():
    router, worker = _tcp_pair()
    fw = _FakeWorker(worker, beat_interval=0.1)
    try:
        h = net.NetWorkerHandle(
            "t", 0, router, {"name": "fw", "pid": 4242, "host": "fakehost"},
            b"generation-payload", lease_s=2.0, ready_timeout=5.0,
        )
        try:
            msg, payload = fw.deploy
            assert msg["op"] == "deploy"
            assert payload == b"generation-payload"
            assert msg["spec"]["digest"] == net.payload_digest(payload)
            assert msg["spec"]["lease_s"] == 2.0
            assert h.alive() and h.pid == 4242 and h.peer_host == "fakehost"
            assert h.stats()["lease_s"] == 2.0
        finally:
            h.kill()
    finally:
        fw.close()
        _close_all(router)


def test_handle_apply_roundtrip_survives_compute_longer_than_lease():
    """A computing worker KEEPS BEATING, and a beating worker holds its
    lease — only silence fences, never slowness."""
    router, worker = _tcp_pair()

    def on_apply(msg, payload):
        arr = wire.payload_array(msg["meta"], payload)
        time.sleep(1.2)  # > lease_s: beats must carry the lease
        rmeta, rp = wire.array_payload(arr * 2.0)
        return {"op": "result", "fid": msg["fid"], "meta": rmeta}, rp

    fw = _FakeWorker(worker, on_apply=on_apply, beat_interval=0.1)
    try:
        h = net.NetWorkerHandle(
            "t", 0, router, {"name": "fw", "pid": 1},
            b"gen", lease_s=0.5, ready_timeout=5.0,
        )
        try:
            arr = _rows(3, seed=1)
            out = h.apply(arr, 3)
            assert out.tobytes() == (arr * 2.0).tobytes()
        finally:
            h.shutdown(timeout=1.0)
    finally:
        fw.close()
        _close_all(router)


def test_handle_retransmits_lost_apply_on_a_beating_link():
    """The lost-frame hole: a partition can eat exactly one apply frame
    and heal within the lease window — the worker beats on, so the
    lease never expires, and without retransmission the router would
    wait forever.  The handle must resend every ``lease_s / 2``; the
    duplicate is answered normally (or from the reply cache), and the
    flush completes instead of wedging."""
    router, worker = _tcp_pair()
    applies = {"n": 0}

    def on_apply(msg, payload):
        applies["n"] += 1
        if applies["n"] == 1:
            return None  # the first copy "never arrived"
        arr = wire.payload_array(msg["meta"], payload)
        rmeta, rp = wire.array_payload(arr + 1.0)
        return {"op": "result", "fid": msg["fid"], "meta": rmeta}, rp

    fw = _FakeWorker(worker, on_apply=on_apply, beat_interval=0.1)
    try:
        h = net.NetWorkerHandle(
            "t", 0, router, {"name": "fw", "pid": 1},
            b"gen", lease_s=0.8, ready_timeout=5.0,
        )
        try:
            before = metrics.REGISTRY.counter_total("serve.net.retransmits")
            arr = _rows(2, seed=9)
            out = h.apply(arr, 2)
            assert out.tobytes() == (arr + 1.0).tobytes()
            assert applies["n"] >= 2
            assert (
                metrics.REGISTRY.counter_total("serve.net.retransmits")
                > before
            )
        finally:
            h.shutdown(timeout=1.0)
    finally:
        fw.close()
        _close_all(router)


def test_handle_fatal_ready_raises_spawn_error():
    router, worker = _tcp_pair()
    fw = _FakeWorker(
        worker,
        ready={"op": "fatal", "etype": "RuntimeError", "emsg": "boom"},
    )
    try:
        with pytest.raises(WorkerSpawnError, match="failed to start"):
            net.NetWorkerHandle(
                "t", 0, router, {"name": "fw"}, b"gen",
                lease_s=1.0, ready_timeout=5.0,
            )
    finally:
        fw.close()
        _close_all(router)


def test_lease_expiry_forfeits_flush_and_discards_late_result():
    """THE fencing pin: a worker that goes silent mid-request costs the
    router exactly one WorkerCrashed (un-claim → front-requeue → heal),
    and when its result limps in after the lease was forfeited, the
    reader observes it and DISCARDS it — a no-op, never a double
    delivery (``serve.net.late_discards``)."""
    router, worker = _tcp_pair()
    held = {}

    def on_apply(msg, payload):
        held["msg"] = msg
        return None  # withhold: the worker "partitioned" mid-compute

    # no beat_interval: the fake goes silent after ready
    fw = _FakeWorker(worker, on_apply=on_apply)
    try:
        h = net.NetWorkerHandle(
            "t", 0, router, {"name": "fw", "pid": 1},
            b"gen", lease_s=0.6, ready_timeout=5.0,
        )
        try:
            before = metrics.REGISTRY.counter_total("serve.net.late_discards")
            t0 = time.monotonic()
            with pytest.raises(WorkerCrashed, match="lease expired"):
                h.apply(_rows(2, seed=2), 2)
            # forfeited at the lease bound, not some unrelated timeout
            assert 0.4 < time.monotonic() - t0 < 10.0
            assert not h.alive()
            # the fenced loser's result arrives late: discarded, counted
            assert "msg" in held
            rmeta, rp = wire.array_payload(np.zeros((2, DIM), np.float32))
            fw.send(
                {"op": "result", "fid": held["msg"]["fid"], "meta": rmeta},
                rp,
            )
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if (
                    metrics.REGISTRY.counter_total("serve.net.late_discards")
                    > before
                ):
                    break
                time.sleep(0.02)
            else:
                pytest.fail("late result was not observed and discarded")
        finally:
            h.kill()
    finally:
        fw.close()
        _close_all(router)


def test_handle_injected_partition_is_silence_then_crash():
    """A ``drop`` plan on this link suppresses outbound frames and
    discards inbound ones — the handle sees a partition (silence), and
    an apply forfeits at the lease bound."""
    router, worker = _tcp_pair()

    def on_apply(msg, payload):
        arr = wire.payload_array(msg["meta"], payload)
        rmeta, rp = wire.array_payload(arr)
        return {"op": "result", "fid": msg["fid"], "meta": rmeta}, rp

    fw = _FakeWorker(worker, on_apply=on_apply, beat_interval=0.05)
    try:
        h = net.NetWorkerHandle(
            "t", 7, router, {"name": "fw", "pid": 1},
            b"gen", lease_s=0.5, ready_timeout=5.0,
        )
        try:
            assert h.name == "t-net7"
            plan = (
                f"serve.net.send:ctx.link={h.name}:drop;"
                f"serve.net.recv:ctx.link={h.name}:partition"
            )
            with faults.inject(plan):
                with pytest.raises(WorkerCrashed):
                    h.apply(_rows(2, seed=4), 2)
        finally:
            h.kill()
    finally:
        fw.close()
        _close_all(router)


# ------------------------------------- worker side: session state machine
def _recv_skipping_beats(sock, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            msg, payload = wire.recv_stream_frame(sock, timeout=0.5)
        except TimeoutError:
            continue
        if msg.get("op") != "beat":
            return msg, payload
    raise TimeoutError("no non-beat frame")


def test_worker_session_reuses_cached_applier_and_dedups_retransmits():
    """Rejoin economics + idempotency: a cached digest skips the
    rebuild (``reused: true``), and a retransmitted flush id answers
    from the reply cache without recomputing — at-least-once dispatch,
    exactly-once effect."""
    router, worker = _tcp_pair()
    calls = {"n": 0}

    def applier(arr, n, deadline=None):
        calls["n"] += 1
        return np.full((2, DIM), float(calls["n"]), np.float32)

    payload = b"generation-A"
    digest = net.payload_digest(payload)
    cache = {digest: (applier, 0)}
    out = {}
    t = threading.Thread(
        target=lambda: out.setdefault(
            "reason", net._worker_session(worker, "sess-w", cache)
        ),
        daemon=True,
    )
    t.start()
    try:
        spec = {"name": "sess-w", "digest": digest, "lease_s": 5.0, "device": "cpu"}
        wire.send_stream_frame(router, {"op": "deploy", "spec": spec}, payload)
        ready, _ = wire.recv_stream_frame(router, timeout=10.0)
        assert ready["op"] == "ready" and ready["reused"] is True

        meta, p = wire.array_payload(_rows(2, seed=5))
        req = {"op": "apply", "fid": "fX", "n": 2, "meta": meta}
        wire.send_stream_frame(router, req, p)
        r1, p1 = _recv_skipping_beats(router)
        assert r1["op"] == "result" and r1["fid"] == "fX"
        # the same fid again: same bytes back, applier NOT re-invoked
        wire.send_stream_frame(router, req, p)
        r2, p2 = _recv_skipping_beats(router)
        assert r2["fid"] == "fX" and p2 == p1
        assert calls["n"] == 1

        wire.send_stream_frame(router, {"op": "bye"})
        msg, _ = _recv_skipping_beats(router)
        assert msg["op"] == "bye_ack"
        t.join(5.0)
        assert out.get("reason") == "bye"
    finally:
        _close_all(router, worker)


def test_worker_session_self_fences_and_never_sends_the_result():
    """The split-brain pin from the worker's seat: silence outlasting
    the lease while a flush computes means the router has re-dispatched
    it — the finished result is DISCARDED (never sent) and the session
    exits ``fenced`` to rejoin for a fresh lease."""
    router, worker = _tcp_pair()

    def applier(arr, n, deadline=None):
        time.sleep(1.2)  # compute outlasts the lease, with NO beats
        return np.zeros((2, DIM), np.float32)

    payload = b"generation-B"
    digest = net.payload_digest(payload)
    cache = {digest: (applier, 0)}
    out = {}
    t = threading.Thread(
        target=lambda: out.setdefault(
            "reason", net._worker_session(worker, "fence-w", cache)
        ),
        daemon=True,
    )
    t.start()
    try:
        spec = {"name": "fence-w", "digest": digest, "lease_s": 0.4, "device": "cpu"}
        wire.send_stream_frame(router, {"op": "deploy", "spec": spec}, payload)
        ready, _ = wire.recv_stream_frame(router, timeout=10.0)
        assert ready["op"] == "ready"
        meta, p = wire.array_payload(_rows(2, seed=6))
        wire.send_stream_frame(
            router, {"op": "apply", "fid": "f1", "n": 2, "meta": meta}, p
        )
        # go SILENT and collect everything the worker sends until it
        # closes: beats only — the computed result must never appear
        seen = []
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            try:
                msg, _ = wire.recv_stream_frame(router, timeout=0.5)
            except TimeoutError:
                continue
            except (EOFError, OSError, wire.WireError):
                break
            seen.append(msg.get("op"))
        t.join(5.0)
        assert out.get("reason") == "fenced"
        assert "result" not in seen and "error" not in seen
    finally:
        _close_all(router, worker)


def test_drain_ready_preserves_stashed_payload_bytes():
    """Frames stashed by the mid-compute drain keep their payload:
    replaying an apply with ``b""`` would turn a recomputable request
    into a meta/byte-count ``WireError`` the moment the stashed fid
    misses the last-reply cache."""
    a, b = _spair()
    try:
        meta, p = wire.array_payload(_rows(2, seed=7))
        wire.send_stream_frame(a, {"op": "beat"})
        wire.send_stream_frame(
            a, {"op": "apply", "fid": "fZ", "n": 2, "meta": meta}, p
        )
        time.sleep(0.1)  # let both frames land in b's kernel buffer
        stashed, got_any, dead = net._drain_ready(
            b, wire.DEFAULT_MAX_FRAME_BYTES, "drain-w"
        )
        assert got_any and not dead
        assert len(stashed) == 1
        msg, payload = stashed[0]
        assert msg["fid"] == "fZ" and payload == p
        arr = wire.payload_array(msg["meta"], payload)
        assert arr.shape == (2, DIM)
    finally:
        _close_all(a, b)


# ------------------------------------------- fleet telemetry over the wire


def _doubling_worker(sock, telemetry=None):
    """A _FakeWorker that doubles its input; ``telemetry`` (a callable
    returning the reply's telemetry body) makes it a NEW-protocol
    worker, None keeps it an OLD one (no telemetry keys anywhere)."""

    def on_apply(msg, payload):
        t_rx = time.monotonic()
        arr = wire.payload_array(msg["meta"], payload)
        rmeta, rp = wire.array_payload(arr * 2.0)
        reply = {"op": "result", "fid": msg["fid"], "meta": rmeta}
        if telemetry is not None:
            reply["telemetry"] = telemetry(t_rx)
        return reply, rp

    return _FakeWorker(sock, on_apply=on_apply, beat_interval=0.1)


def test_apply_frame_carries_trace_only_when_given():
    """The recorder-off wire pin at frame granularity: without trace
    context the apply frame has EXACTLY the pre-tracing keys (an old
    worker sees the old protocol, byte-for-byte); with context the
    ``trace`` body rides along verbatim."""
    router, worker = _tcp_pair()
    fw = _doubling_worker(worker)
    try:
        h = net.NetWorkerHandle(
            "t", 0, router, {"name": "fw", "pid": 1},
            b"gen", lease_s=2.0, ready_timeout=5.0,
        )
        try:
            h.apply(_rows(2, seed=0), 2)
            ctx = {"batch": "b1", "request_ids": ["r1", "r2"]}
            h.apply(_rows(2, seed=1), 2, trace=ctx)
            applies = [f for f in fw.frames if f.get("op") == "apply"]
            assert len(applies) == 2
            assert "trace" not in applies[0]
            assert set(applies[0]) == {"op", "fid", "n", "meta", "deadline_s"}
            assert applies[1]["trace"] == ctx
        finally:
            h.shutdown(timeout=1.0)
    finally:
        fw.close()
        _close_all(router)


def test_old_worker_without_telemetry_is_tolerated():
    """Version skew, worker-side: a worker that never ships telemetry
    (no keys in ready/replies/beats) serves normally and the attached
    sink simply records nothing — absent field means old peer."""
    from keystone_tpu_torch.serve.telemetry import FleetTelemetry

    router, worker = _tcp_pair()
    fw = _doubling_worker(worker)
    try:
        h = net.NetWorkerHandle(
            "t", 0, router, {"name": "fw", "pid": 1},
            b"gen", lease_s=2.0, ready_timeout=5.0,
        )
        try:
            sink = FleetTelemetry(registry=metrics.MetricsRegistry())
            h.attach_telemetry(sink)
            arr = _rows(3, seed=2)
            out = h.apply(arr, 3, trace={"batch": "bX"})
            assert out.tobytes() == (arr * 2.0).tobytes()
            assert sink.known_workers() == []
        finally:
            h.shutdown(timeout=1.0)
    finally:
        fw.close()
        _close_all(router)


def test_worker_shipped_telemetry_stitches_and_aggregates():
    """The full return path over a real socket: ready-frame metrics
    flush on attach, reply spans stitch into the traced flush's batch
    record, and a beat-piggybacked delta lands in the registry under
    worker=/host= labels."""
    from keystone_tpu_torch.obs.recorder import FlightRecorder
    from keystone_tpu_torch.serve.telemetry import FleetTelemetry

    router, worker = _tcp_pair()

    def reply_telemetry(t_rx):
        now = time.monotonic()
        return {
            "t_rx": t_rx,
            "t_tx": now,
            "spans": [{"name": "worker.apply", "t0": t_rx, "t1": now}],
        }

    fw = _doubling_worker(worker, telemetry=reply_telemetry)
    try:
        h = net.NetWorkerHandle(
            "t", 0, router, {"name": "fw", "pid": 1, "host": "fakehost"},
            b"gen", lease_s=2.0, ready_timeout=5.0,
        )
        try:
            reg = metrics.MetricsRegistry()
            rec = FlightRecorder()
            sink = FleetTelemetry(registry=reg, recorder=rec)
            h.attach_telemetry(sink)
            rec.annotate("r1", "serve.replica", batch="b1", replica=0)
            rec.batch("b1", ["r1"], replica=0, rows=2)
            arr = _rows(2, seed=4)
            out = h.apply(arr, 2, trace={"batch": "b1", "request_ids": ["r1"]})
            assert out.tobytes() == (arr * 2.0).tobytes()
            # the reply's spans were aligned + stitched into the record
            assert sink.known_workers() == ["t-net0"]
            rec.finish("r1", "completed", batch="b1")
            (b,) = rec.request("r1")["batch_records"]
            assert b["worker"] == "t-net0" and b["host"] == "fakehost"
            assert b["wire"]["rtt_s"] is not None and b["wire"]["rtt_s"] >= 0.0
            names = [s["name"] for s in b["worker_spans"]]
            assert "worker.apply" in names
            for s in b["worker_spans"]:
                assert s["seconds"] >= 0.0 and s["t_off"] >= 0.0
            assert (
                reg.histogram_summary(
                    "serve.fleet.apply_seconds", worker="t-net0", host="fakehost"
                )["count"]
                == 1
            )
            # a beat-piggybacked metrics delta merges under the labels
            fw.send(
                {
                    "op": "beat",
                    "telemetry": {
                        "metrics": [["c", "serve.fake_beat_total", [], 3.0]]
                    },
                }
            )
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if reg.counter_value(
                    "serve.fake_beat_total", worker="t-net0", host="fakehost"
                ):
                    break
                time.sleep(0.02)
            assert (
                reg.counter_value(
                    "serve.fake_beat_total", worker="t-net0", host="fakehost"
                )
                == 3.0
            )
        finally:
            h.shutdown(timeout=1.0)
    finally:
        fw.close()
        _close_all(router)


# --------------------------------------------------- live TCP fleet e2e
@pytest.fixture(scope="module")
def net_service():
    """One workers=2 TCP fleet on loopback on the CPU, shared by the
    end-to-end tests (each worker is a ``cli worker`` child paying an
    interpreter and torch's import; lease healing keeps the fixture
    whole across tests)."""
    from keystone_tpu_torch.serve import serve

    svc = serve(
        _pipeline(),
        workers=2,
        hosts=["local", "local"],
        max_batch=8,
        max_wait_ms=2.0,
        queue_bound=512,
        example=np.zeros(DIM, np.float32),
        name="netfleet_t",
        supervise_interval_s=0.1,
        heartbeat_s=10.0,
        restart_limit=1000,
        worker_opts={"lease_s": 1.0, "spawn_grace_s": 3.0, "device": "cpu"},
    )
    try:
        yield svc
    finally:
        svc.close(timeout=WAIT)


def _threaded_ref(x: np.ndarray) -> np.ndarray:
    from keystone_tpu_torch.serve import serve

    ref = serve(
        _pipeline(),
        devices=["cpu"],
        max_batch=8,
        max_wait_ms=2.0,
        example=np.zeros(DIM, np.float32),
        name="netfleet_ref",
        supervise=False,
    )
    try:
        return np.stack(
            [f.result(timeout=WAIT) for f in [ref.submit(r) for r in x]]
        )
    finally:
        ref.close(timeout=WAIT)


def test_net_fleet_serves_and_matches_threaded(net_service):
    """Predictions over TCP are BIT-identical to the port's threaded
    single-replica service: the transport is a transport, never a
    numerics change."""
    x = _rows(12, seed=3)
    got = np.stack(
        [f.result(timeout=WAIT) for f in [net_service.submit(r) for r in x]]
    )
    assert got.tobytes() == _threaded_ref(x).tobytes()


def test_net_fleet_status_exposes_leased_links(net_service):
    st = net_service.status()
    assert st["backend"] == "net"
    reps = st["replicas"]
    assert reps and all(r["backend"] == "net" for r in reps)
    assert all(r["lease_s"] == 1.0 for r in reps)
    alive = [r for r in reps if r["worker_alive"]]
    assert alive, "no live leased worker in status"
    assert all(isinstance(r["link"], str) and r["link"] for r in reps)
    ages = [
        r["worker_heartbeat_age_s"]
        for r in alive
        if r["worker_heartbeat_age_s"] is not None
    ]
    assert ages and min(ages) < 1.0  # beats at lease/4 = 0.25s


def test_partition_mid_flight_loses_nothing_and_heals(net_service):
    """THE acceptance pin: sever one worker's link both directions
    while requests stream — zero lost futures (the forfeited flush
    re-serves on the survivor), results bit-identical to the
    unpartitioned reference, and after the partition lifts the fleet
    heals back to two live leased workers (the fenced worker rejoins
    through the front door)."""
    x = _rows(48, seed=7)
    want = _threaded_ref(x)
    links = [r["link"] for r in net_service.replica_statuses() if "link" in r]
    assert links, "no leased links to partition"
    victim = links[0]
    plan = (
        f"serve.net.send:ctx.link={victim}:partition;"
        f"serve.net.recv:ctx.link={victim}:partition"
    )
    futs = []
    with faults.inject(plan):
        for r in x[:24]:
            futs.append(net_service.submit(r))
        # hold the partition past the lease (1.0s): the victim's
        # in-flight flush forfeits and re-dispatches on the survivor,
        # the victim self-fences
        time.sleep(2.5)
    for r in x[24:]:
        futs.append(net_service.submit(r))
    got = np.stack([f.result(timeout=120) for f in futs])
    assert got.tobytes() == want.tobytes()

    # heal gate: both slots hold live leases again
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        alive = [
            r
            for r in net_service.replica_statuses()
            if r.get("worker_alive")
        ]
        if len(alive) >= 2:
            break
        time.sleep(0.25)
    else:
        pytest.fail("fleet did not heal back to 2 live workers within 60s")


def test_net_fleet_aggregates_metrics_and_stitches_trace(net_service):
    """E2E acceptance, TCP edition: with two leased workers, the
    router's ops surface covers the whole fleet — worker-shipped
    series land in the registry under worker=/host= labels, /statusz
    grows a fleet block with clock-sync state for BOTH workers, and a
    traced request's /requestz chain crosses the wire (stitched
    worker@host, wire accounting, aligned worker.apply span)."""
    rid = "net-trace-e2e"
    x = _rows(16, seed=13)
    futs = [net_service.submit(x[0], request_id=rid)]
    futs += [net_service.submit(r) for r in x[1:]]
    for f in futs:
        f.result(timeout=120)
    # the deploy→ready exchange gave every worker a clock sample, so
    # the fleet block lists both slots even before both serve a flush
    fleet = net_service.status().get("fleet")
    assert fleet is not None
    assert set(fleet["workers"]) == {"netfleet_t-net0", "netfleet_t-net1"}
    for entry in fleet["workers"].values():
        assert entry["host"]
        assert entry["clock_samples"] >= 1
    series = metrics.REGISTRY.histogram_series("serve.fleet.apply_seconds")
    assert series, "no worker-shipped apply series reached the registry"
    assert all(lb.get("worker") and lb.get("host") for lb, _ in series)
    net_workers = [
        lb["worker"] for lb, _ in series if lb["worker"].startswith("netfleet_t-")
    ]
    assert net_workers, f"no net-fleet series in {series}"
    tr = net_service.recorder.request(rid)
    assert tr is not None
    stitched = [b for b in tr["batch_records"] if b.get("worker")]
    assert stitched, f"unstitched batch records: {tr['batch_records']}"
    b = stitched[0]
    assert b["worker"].startswith("netfleet_t-net") and b.get("host")
    assert "wire" in b
    assert "worker.apply" in [s["name"] for s in b.get("worker_spans", [])]


# ----------------------------------------------------- the port's additions


def test_deploy_frames_may_exceed_the_stream_cap():
    """A deploy frame carries a whole staged payload (the full-width
    scorer's weights are 262 MB, near the 256 MiB stream cap): the worker
    reads it under the deploy cap, applies under the stream cap."""
    assert net.DEPLOY_MAX_FRAME_BYTES > wire.DEFAULT_MAX_FRAME_BYTES
    a, b = _spair()
    try:
        wire.send_stream_frame(a, {"op": "deploy"}, b"x" * 4096)
        with pytest.raises(wire.WireError, match="refusing"):
            wire.recv_stream_frame(b, timeout=5.0, max_frame_bytes=1024)
    finally:
        _close_all(a, b)


def test_net_fleet_ships_kernel_reports(net_service):
    """Each leased worker's kernel report reaches its handle and the
    fleet's telemetry (device, pid, the wrappers' counts)."""
    x = _rows(4, seed=17)
    for f in [net_service.submit(r) for r in x]:
        f.result(timeout=WAIT)
    for r in net_service._pool.replicas:
        assert r.handle.kernels["device"] == "cpu" and r.status()["worker_device"] == "cpu"
    totals = net_service.telemetry.kernel_totals()
    assert set(totals["launches"]) >= {"fused_forward", "fisher_encode"}


def test_net_fleet_serves_the_reference_scores(net_service):
    """The reference's threaded serve() on the same seeded rows: the
    net fleet's rows at 1e-5."""
    x = _rows(10, seed=19)
    kw = dict(max_batch=8, max_wait_ms=5.0, queue_bound=64, example=np.zeros(DIM, np.float32))
    w = jnp.asarray(np.eye(DIM, dtype=np.float32) * 2.0)
    with jserve(JPipeline.of(JNormalizeRows()) | JLinearMapper(w), **kw) as ref:
        want = np.stack([np.asarray(f.result(timeout=WAIT)) for f in ref.submit_many(x)])
    got = np.stack([f.result(timeout=WAIT) for f in net_service.submit_many(x)])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
