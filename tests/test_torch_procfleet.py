"""The process fleet (keystone_tpu_torch/serve/wire.py, worker.py,
procfleet.py) against the reference's tests/test_procfleet.py, one
counterpart each, on the CPU: the wire's framing and slab discipline,
and worker-process replicas behind the router: spawn and ready, remote
applies bit for bit the port's threaded fleet's, a SIGKILL mid-flush
healed with no future lost, live scale up and down, the cross-process
trace.  Then what the port adds: a full-bucket admission block through
the process fleet and the threaded fleet, bit for bit; the worker's
ready frame (its device, its kernel report); the staged payload loaded
onto the worker's device; the served scores against the reference's
threaded serve().

The spawning tests share one module-scoped service; every wait is
bounded and every child is torn down in ``finally``."""

import os
import signal
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
from keystone_tpu_torch.serve import wire

pytestmark = pytest.mark.serve

DIM = 6


# ------------------------------------------------------------- framing
def test_frame_roundtrip():
    msg = {"op": "apply", "n": 3, "deadline_s": 0.25, "ref": {"slab": "x"}}
    assert wire.unpack_frame(wire.pack_frame(msg)) == msg


def test_frame_rejects_bad_magic_version_truncation():
    good = wire.pack_frame({"op": "ping"})
    with pytest.raises(wire.WireError):
        wire.unpack_frame(b"XXXX" + good[4:])
    with pytest.raises(wire.WireError):
        wire.unpack_frame(good[: len(wire.MAGIC)])  # truncated
    tampered = bytearray(good)
    tampered[len(wire.MAGIC)] = 99  # foreign protocol version
    with pytest.raises(wire.WireError):
        wire.unpack_frame(bytes(tampered))
    with pytest.raises(wire.WireError):
        wire.unpack_frame(wire.MAGIC + bytes([wire.VERSION]) + b"not json")
    with pytest.raises(wire.WireError):
        wire.pack_frame(["not", "a", "dict"])


def test_frame_rejects_unserializable_body():
    with pytest.raises(wire.WireError):
        wire.pack_frame({"arr": np.zeros(3)})  # arrays never ride frames


# ---------------------------------------------------------------- slabs
def test_slab_pool_reuses_across_buckets():
    pool = wire.SlabPool(prefix="t0")
    try:
        big = pool.acquire(1 << 20)  # 1 MiB class
        name = big.name
        pool.release(big)
        # a smaller payload REUSES the free larger slab instead of
        # creating a new one (slab classes mirror padding buckets)
        small = pool.acquire(1 << 12)
        assert small.name == name
        assert pool.stats()["created"] == 1
        assert pool.stats()["reused"] == 1
        pool.release(small)
    finally:
        pool.close()


def test_slab_pool_rejects_oversized_payload():
    pool = wire.SlabPool(prefix="t1", max_slab_bytes=1 << 16)
    try:
        with pytest.raises(wire.PayloadTooLarge):
            pool.acquire((1 << 16) + 1)
        # the refusal is a client-shaped ValueError: never bisected as
        # poison, never charged to infrastructure
        assert issubclass(wire.PayloadTooLarge, ValueError)
    finally:
        pool.close()


def test_write_array_attach_roundtrip():
    pool = wire.SlabPool(prefix="t2")
    attacher = wire.SlabAttacher()
    try:
        arr = np.arange(24, dtype=np.float32).reshape(4, 6) * 0.5
        slab, ref = wire.write_array(pool, arr)
        out = attacher.read(ref)
        np.testing.assert_array_equal(out, arr)
        assert out.dtype == arr.dtype
        # the copy owns its memory: slab reuse cannot corrupt it
        slab2, ref2 = wire.write_array(pool, np.zeros_like(arr))
        np.testing.assert_array_equal(out, arr)
        pool.release(slab)
        pool.release(slab2)
    finally:
        attacher.close()
        pool.close()


def test_attacher_rejects_overclaiming_ref():
    pool = wire.SlabPool(prefix="t3")
    attacher = wire.SlabAttacher()
    try:
        slab, ref = wire.write_array(pool, np.zeros(8, np.float32))
        bad = dict(ref, nbytes=slab.capacity + 1, shape=[slab.capacity + 1])
        with pytest.raises(wire.WireError):
            attacher.view(bad)
    finally:
        attacher.close()
        pool.close()


def test_a_later_pool_never_reuses_a_segment_name():
    """A reader keeps a segment mapped by name: a pool made after another
    one closed (an ingress restarted in front of the same workers) must
    not hand out that name again, or the reader sees the old rows."""
    attacher = wire.SlabAttacher()
    first = wire.SlabPool(prefix="t4")
    try:
        _, ref1 = wire.write_array(first, np.zeros(8, np.float32))
        np.testing.assert_array_equal(attacher.read(ref1), np.zeros(8, np.float32))
    finally:
        first.close()
    second = wire.SlabPool(prefix="t4")
    try:
        arr = np.arange(8, dtype=np.float32)
        _, ref2 = wire.write_array(second, arr)
        assert ref2["slab"] != ref1["slab"]
        np.testing.assert_array_equal(attacher.read(ref2), arr)
    finally:
        attacher.close()
        second.close()


# ----------------------------------------------------- process fleet e2e
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


@pytest.fixture(scope="module")
def proc_service():
    """One workers=2 process fleet on the CPU shared by the end-to-end
    tests (each spawn pays an interpreter and torch's import; the
    supervisor's respawns keep the fixture whole across tests)."""
    from keystone_tpu_torch.serve import serve

    svc = serve(
        _pipeline(),
        workers=2,
        worker_opts={"device": "cpu"},
        max_batch=8,
        max_wait_ms=2.0,
        queue_bound=512,
        example=np.zeros(DIM, np.float32),
        name="procfleet_t",
        supervise_interval_s=0.1,
        heartbeat_s=10.0,
        restart_limit=1000,
    )
    try:
        yield svc
    finally:
        svc.close(timeout=WAIT)


def _threaded(**kw):
    from keystone_tpu_torch.serve import serve

    return serve(_pipeline(), devices=["cpu"], max_batch=8, max_wait_ms=2.0, example=np.zeros(DIM, np.float32),
                 supervise=False, **kw)


def _rows(k: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(k, DIM)).astype(np.float32)


def test_process_fleet_serves_and_matches_threaded(proc_service):
    """Predictions from the process fleet are BIT-identical to the
    port's threaded single-replica service over the same pipeline: the
    worker process is a transport change, never a numerics change."""
    x = _rows(12, seed=3)
    got = np.stack(
        [f.result(timeout=WAIT) for f in [proc_service.submit(r) for r in x]]
    )
    ref_svc = _threaded(name="procfleet_ref")
    try:
        want = np.stack(
            [f.result(timeout=WAIT) for f in [ref_svc.submit(r) for r in x]]
        )
    finally:
        ref_svc.close(timeout=WAIT)
    assert got.tobytes() == want.tobytes()


def test_process_fleet_status_exposes_workers(proc_service):
    st = proc_service.status()
    assert st["backend"] == "process"
    assert st["workers"] == proc_service.replicas
    reps = st["replicas"]
    assert all(r["backend"] == "process" for r in reps)
    assert all(isinstance(r["pid"], int) for r in reps)
    alive = [r for r in reps if r["worker_alive"]]
    assert alive, "no live worker process in status"
    # the child-side heartbeat is beating
    ages = [
        r["worker_heartbeat_age_s"]
        for r in alive
        if r["worker_heartbeat_age_s"] is not None
    ]
    assert ages and min(ages) < 5.0


def test_worker_sigkill_mid_flight_loses_nothing(proc_service):
    """SIGKILL a live worker while requests are in flight: the claim
    machinery un-claims and requeues the killed worker's flush, the
    supervisor spawns a replacement, and EVERY submitted future
    resolves with a correct result — zero lost, zero hung."""
    from keystone_tpu_torch.obs import metrics

    svc = proc_service
    restarts0 = metrics.REGISTRY.counter_total("serve.replica_restarts")
    x = _rows(200, seed=4)
    killed = []

    def killer():
        time.sleep(0.05)
        pids = [
            r["pid"] for r in svc.replica_statuses() if r.get("worker_alive")
        ]
        if pids:
            os.kill(pids[0], signal.SIGKILL)
            killed.append(pids[0])

    t = threading.Thread(target=killer)
    t.start()
    futs = []
    for i in range(x.shape[0]):
        try:
            futs.append(svc.submit(x[i]))
        except Exception:
            pass  # a fully-down instant refuses typed; acceptable
        time.sleep(0.001)
    t.join()
    done = 0
    for f in futs:
        r = f.result(timeout=120)  # TimeoutError here = a LOST future
        assert abs(float(np.linalg.norm(r)) - 2.0) < 1e-4
        done += 1
    assert killed, "the killer thread found no live worker to SIGKILL"
    assert done == len(futs)
    # wait out the heal so the fixture is whole for later tests
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if (
            metrics.REGISTRY.counter_total("serve.replica_restarts")
            > restarts0
            and sum(
                1
                for r in svc.replica_statuses()
                if r.get("worker_alive")
            )
            >= 2
        ):
            break
        time.sleep(0.1)
    assert (
        metrics.REGISTRY.counter_total("serve.replica_restarts") > restarts0
    ), "supervisor never restarted the killed worker"


def test_scale_up_and_down_live(proc_service):
    """scale_to grows the fleet (spawn → prime → admit) and shrinks it
    gracefully (drain → join) while traffic keeps completing."""
    svc = proc_service
    n0 = svc.replicas
    x = _rows(8, seed=5)
    svc.scale_to(n0 + 1)
    assert svc.replicas == n0 + 1
    outs = [
        f.result(timeout=WAIT) for f in [svc.submit(r) for r in x]
    ]
    assert all(abs(float(np.linalg.norm(o)) - 2.0) < 1e-4 for o in outs)
    svc.scale_to(n0)
    assert svc.replicas == n0
    outs = [
        f.result(timeout=WAIT) for f in [svc.submit(r) for r in x]
    ]
    assert all(abs(float(np.linalg.norm(o)) - 2.0) < 1e-4 for o in outs)


def test_multi_tenant_refuses_process_backend(proc_service):
    """As the reference's: serve_multi refuses workers= (the shared stage
    pool needs the in-process walk), a process-backed single-tenant
    service refuses a tenant, and a remote applier refuses the per-flush
    segment keywords a multi-tenant apply would pass."""
    from keystone_tpu_torch.serve import RemoteApplier, serve_multi

    with pytest.raises(NotImplementedError, match="workers="):
        serve_multi({"a": _pipeline()}, workers=2, worker_opts={"device": "cpu"}, example=np.zeros(DIM, np.float32))
    with pytest.raises(TypeError, match="single-tenant"):
        proc_service.submit(np.ones(DIM, np.float32), tenant="a")
    remote = proc_service._pool.replicas[0].applier
    assert isinstance(remote, RemoteApplier)
    with pytest.raises(TypeError, match="segments"):
        remote(np.zeros((8, DIM), np.float32), segments=[(0, 8)])


def test_workers_and_replicas_are_exclusive():
    from keystone_tpu_torch.serve import serve

    with pytest.raises(ValueError):
        serve(_pipeline(), workers=2, replicas=2, worker_opts={"device": "cpu"})


# ------------------------------------------------------- fleet telemetry


def test_apply_frame_trace_key_and_slab_ref_pins(monkeypatch):
    """Frame-level byte pins: without trace context the apply control
    frame has EXACTLY the pre-tracing keys (recorder-off wire is
    unchanged), and the slab-ref fast path still ships the CALLER's
    reference — telemetry added zero copies to zero-copy dispatch."""
    from keystone_tpu_torch.serve import procfleet as pf

    h = object.__new__(pf.WorkerHandle)
    h.name = "pin"
    h._lock = threading.Lock()
    h._closed = False
    h._conn = object()
    h._pool = None
    h.telemetry = None
    sent = []
    monkeypatch.setattr(pf.wire, "send_frame", lambda conn, m: sent.append(m))
    monkeypatch.setattr(pf.wire, "recv_frame", lambda conn: {"op": "pong"})
    ref = {"slab": "s0", "count": 2}
    h.apply(None, 2, slab_ref=ref)
    assert set(sent[0]) == {"op", "n", "deadline_s", "ref"}
    assert sent[0]["ref"] is ref
    ctx = {"batch": "b1", "request_ids": ["r1"]}
    h.apply(None, 2, slab_ref=ref, trace=ctx)
    assert sent[1]["trace"] == ctx
    assert set(sent[1]) == {"op", "n", "deadline_s", "ref", "trace"}


def test_process_fleet_stitches_cross_process_trace(proc_service):
    """E2E acceptance: a traced request served by a spawned worker
    process shows the TRUE cross-process chain on /requestz — the
    stitched batch record names the worker and host and carries the
    worker-side apply span aligned to the router clock (non-negative,
    inside the exchange window)."""
    rid = "proc-trace-e2e"
    x = _rows(4, seed=21)
    futs = [proc_service.submit(x[0], request_id=rid)]
    futs += [proc_service.submit(r) for r in x[1:]]
    for f in futs:
        f.result(timeout=WAIT)
    rec = proc_service.recorder
    assert rec is not None
    tr = rec.request(rid)
    assert tr is not None and tr["batch_records"]
    stitched = [b for b in tr["batch_records"] if b.get("worker")]
    assert stitched, f"unstitched batch records: {tr['batch_records']}"
    b = stitched[0]
    assert b.get("host")
    assert "wire" in b
    names = [s["name"] for s in b.get("worker_spans", [])]
    assert "worker.apply" in names
    for s in b["worker_spans"]:
        assert s["seconds"] >= 0.0 and s["t_off"] >= 0.0
    # the ops surface sees the fleet: /statusz fleet block + labeled
    # series in the router registry
    st = proc_service.status()
    assert st.get("fleet", {}).get("workers")
    from keystone_tpu_torch.obs import metrics

    series = metrics.REGISTRY.histogram_series("serve.fleet.apply_seconds")
    assert series
    assert all(lb.get("worker") and lb.get("host") for lb, _ in series)


# ----------------------------------------------------- the port's additions


def test_full_bucket_block_bit_for_bit_with_the_threaded_fleet(proc_service):
    """One full-bucket admission block (the same rows in the same padded
    bucket) through the process fleet, its slab shipped by reference,
    and through the threaded fleet: bit for bit."""
    from keystone_tpu_torch.obs import metrics

    x = _rows(8, seed=31)
    pool = wire.SlabPool(prefix="t_full_block")
    try:
        blk = wire.alloc_block(pool, 8, (DIM,), np.float32)
        blk.array[:] = x
        disp0 = metrics.REGISTRY.counter_total("dispatch.bytes_copied")
        pre0 = metrics.REGISTRY.counter_total("serve.preformed_flushes")
        got = np.stack([f.result(timeout=WAIT) for f in proc_service.submit_batch(blk)])
        assert metrics.REGISTRY.counter_total("serve.preformed_flushes") == pre0 + 1
        assert metrics.REGISTRY.counter_total("dispatch.bytes_copied") == disp0
        blk.close()
        ref_svc = _threaded(name="procfleet_block_ref")
        try:
            blk2 = wire.alloc_block(pool, 8, (DIM,), np.float32)
            blk2.array[:] = x
            want = np.stack([f.result(timeout=WAIT) for f in ref_svc.submit_batch(blk2)])
            blk2.close()
        finally:
            ref_svc.close(timeout=WAIT)
    finally:
        pool.close()
    assert got.tobytes() == want.tobytes()


def test_worker_ready_frame_reports_device_and_kernels(proc_service):
    for r in proc_service._pool.replicas:
        h = r.handle
        assert h.ready_info["device"] == "cpu" and h.ready_info["primed"] >= len(proc_service.buckets)
        assert h.kernels["pid"] == h.pid and h.kernels["peak_reserved_bytes"] == 0
        assert set(h.kernels["launches"]) >= {"fused_forward", "fisher_encode"}
        assert r.status()["worker_device"] == "cpu"


def test_staged_payload_loads_onto_the_worker_device(tmp_path):
    """stage_payload writes one torch.save file; the worker loads it with
    every tensor on its device, freezes it there, and refuses an applier
    frozen for another kind of device."""
    from keystone_tpu_torch.serve import procfleet, worker
    from keystone_tpu_torch.workflow.pipeline import FrozenApplier

    path = procfleet.stage_payload(str(tmp_path), 1, _pipeline(), None)
    payload = worker.load_payload(path, torch.device("cpu"))
    wa, installed, primed = worker.build_from_payload(
        payload, {"buckets": [8], "item_shape": (DIM,), "dtype": "<f4"}, torch.device("cpu"))
    assert installed == 0 and primed == 1 and isinstance(wa.applier, FrozenApplier)
    x = _rows(8, seed=2)
    want = _pipeline().freeze(device="cpu")(torch.from_numpy(x)).array.numpy()
    assert wa(x, 5).tobytes() == want[:5].tobytes()
    with open(path, "rb") as f:
        again = worker.load_payload(f.read(), torch.device("cpu"))
    assert isinstance(again["pipeline"], type(payload["pipeline"]))

    class Frozen(FrozenApplier):
        def __init__(self):
            self.device = torch.device("cuda")

    with pytest.raises(ValueError, match="cannot serve on cpu"):
        worker._build_applier({"pipeline": Frozen()}, torch.device("cpu"))


def test_a_worker_bundle_that_fails_to_install_counts_once():
    """A spawned worker whose bundle does not install (a CPU worker: a
    CUDA graph needs the card) comes up serving the walk, and the fleet
    counts one ``serve.artifact_fallbacks`` for it, the router's, with
    the worker's telemetry merged in."""
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.serve import serve

    before = metrics.REGISTRY.counter_total("serve.artifact_fallbacks")
    bundle = {"manifest": {"format": "skewed"}, "blobs": {}}
    svc = serve(_pipeline(), workers=1, worker_opts={"device": "cpu"}, artifacts=bundle, max_batch=8,
                max_wait_ms=2.0, example=np.zeros(DIM, np.float32), name="procfleet_skew", supervise=False)
    try:
        x = _rows(8, seed=4)
        for _ in range(2):  # two exchanges past the telemetry's delta throttle
            got = np.stack([f.result(timeout=WAIT) for f in [svc.submit(r) for r in x]])
            time.sleep(0.6)
        assert svc._pool.replicas[0].handle.ready_info["artifact_buckets"] == 0
    finally:
        svc.close(timeout=WAIT)
    want = _pipeline().freeze(device="cpu")(torch.from_numpy(x)).array.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert metrics.REGISTRY.counter_total("serve.artifact_fallbacks") - before == 1


def test_worker_classifies_the_ports_failures():
    from keystone_tpu_torch.kernels.build import KernelError
    from keystone_tpu_torch.serve import worker
    from keystone_tpu_torch.utils import guard

    assert worker.classify_error(KernelError("nvcc")) == "oserror"
    assert worker.classify_error(torch.cuda.OutOfMemoryError("oom")) == "memory"
    assert worker.classify_error(guard.DeadlineExceeded("x", 1.0)) == "deadline"
    assert worker.classify_error(wire.PayloadTooLarge("big")) == "too_large"
    assert worker.classify_error(ValueError("poison")) == "content"


def test_process_fleet_serves_the_reference_scores():
    """A one-worker process fleet against the reference's threaded
    serve() on the same seeded rows and weights: the same rows at 1e-5."""
    from keystone_tpu_torch.models.linear import LinearMapper
    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.serve import serve
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    rng = np.random.default_rng(23)
    w = rng.normal(size=(DIM, 4)).astype(np.float32)
    x = rng.normal(size=(13, DIM)).astype(np.float32)
    kw = dict(max_batch=8, max_wait_ms=5.0, queue_bound=64, example=np.zeros(DIM, np.float32))
    with jserve(JPipeline.of(JNormalizeRows()) | JLinearMapper(jnp.asarray(w)), **kw) as ref:
        want = np.stack([np.asarray(f.result(timeout=WAIT)) for f in ref.submit_many(x)])
    with serve(Pipeline.of(NormalizeRows()) | LinearMapper(torch.from_numpy(w)), workers=1,
               worker_opts={"device": "cpu"}, name="procfleet_jref", **kw) as svc:
        got = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(x)])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
