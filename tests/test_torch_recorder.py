"""The port's flight recorder (keystone_tpu_torch/obs/recorder.py, a copy
of keystone_tpu/obs/recorder.py) and the service's request tracing: the
recorder's own behaviours run on both packages' recorders, then the
reference's service-level scenarios (tests/test_flight_recorder.py, not
its cross-process or trace_report ones) on the port's service, with the
run ledger off.  Every wait is bounded."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from keystone_tpu.obs import recorder as ref_recorder
from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.obs import ledger, recorder
from keystone_tpu_torch.ops.stats import NormalizeRows
from keystone_tpu_torch.serve import Overloaded, serve, serve_http
from keystone_tpu_torch.utils import guard
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import Pipeline

pytestmark = [pytest.mark.serve, pytest.mark.obs]

DIM = 6
WAIT = 30
PACKAGES = pytest.mark.parametrize("mod", [recorder, ref_recorder], ids=["port", "reference"])


@pytest.fixture(autouse=True)
def _ledger_off(monkeypatch):
    """The recorder works with the run ledger inert; no run leaks out."""
    monkeypatch.delenv(ledger.ENV_DIR, raising=False)
    ledger.attach(None)
    assert ledger.active() is None
    yield
    ledger.stop_run()
    ledger.attach(None)


def _pipeline(scale: float = 2.0) -> Pipeline:
    return Pipeline.of(NormalizeRows()) | LinearMapper(torch.eye(DIM) * scale)


def _service(**kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 20.0)
    kw.setdefault("queue_bound", 64)
    kw.setdefault("example", np.zeros(DIM, np.float32))
    kw.setdefault("devices", ["cpu"])
    return serve(_pipeline(kw.pop("scale", 2.0)), **kw)


def _get_json(url):
    with urllib.request.urlopen(url, timeout=WAIT) as resp:
        return resp.status, json.loads(resp.read())


def _post_json(url, payload, headers=None):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers=dict(headers or {}))
    with urllib.request.urlopen(req, timeout=WAIT) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


# ----------------------------------------------------- recorder unit tests
@PACKAGES
def test_recorder_roundtrip_and_event_order(mod):
    rec = mod.FlightRecorder()
    rec.annotate("r1", "http.ingress", path="/predict")
    rec.annotate("r1", "serve.enqueue", queue_depth=3)
    rec.finish("r1", "completed", replica=0)
    tr = rec.request("r1")
    assert tr["outcome"] == "completed" and not tr["open"]
    assert [e["name"] for e in tr["events"]] == ["http.ingress", "serve.enqueue", "serve.completed"]
    ts = [e["t"] for e in tr["events"]]
    assert ts == sorted(ts) and tr["seconds"] >= 0.0


@PACKAGES
def test_recorder_ids_unique(mod):
    assert len({mod.new_request_id() for _ in range(2000)}) == 2000


@PACKAGES
def test_tail_based_retention_pins_interesting_traces(mod):
    rec = mod.FlightRecorder(capacity=16, pinned_capacity=8)
    rec.annotate("bad-1", "serve.enqueue", queue_depth=1)
    rec.finish("bad-1", "shed", replica=0)
    rec.finish("err-1", "error", error="boom")
    for i in range(200):
        rec.finish(f"ok-{i}", "completed")
    stats = rec.stats()
    assert stats["recent"] <= 16 and stats["pinned"] <= 8
    assert rec.request("ok-0") is None
    assert rec.request("bad-1")["outcome"] == "shed"
    assert rec.request("err-1")["outcome"] == "error"
    shed_ids = [t["request_id"] for t in rec.tracez(filter="shed")]
    assert "bad-1" in shed_ids and "err-1" not in shed_ids


@PACKAGES
def test_slow_traces_pinned_by_explicit_threshold(mod):
    rec = mod.FlightRecorder(capacity=4, slow_ms=0.0001)
    rec.annotate("s1", "serve.enqueue", queue_depth=0)
    time.sleep(0.002)
    rec.finish("s1", "completed")
    assert rec.request("s1")["slow"] is True
    assert [t["request_id"] for t in rec.tracez(filter="slow")] == ["s1"]
    assert rec.tracez(filter="completed")[0]["request_id"] == "s1"


@PACKAGES
def test_batch_records_join_requests(mod):
    rec = mod.FlightRecorder()
    for rid in ("a", "b"):
        rec.annotate(rid, "serve.replica", batch="b7", replica=2)
    rec.batch("b7", ["a", "b"], replica=2, rows=2)
    rec.batch_update("b7", seconds=0.004, bucket=8, degraded=False)
    rec.finish("a", "completed", batch="b7", replica=2)
    tr = rec.request("a")
    assert tr["batches"] == ["b7"]
    (b,) = tr["batch_records"]
    assert b["request_ids"] == ["a", "b"] and b["seconds"] == 0.004 and b["bucket"] == 8


@PACKAGES
def test_none_request_id_is_inert(mod):
    rec = mod.FlightRecorder()
    rec.annotate(None, "serve.enqueue", queue_depth=1)
    rec.finish(None, "completed")
    assert rec.stats()["finished"] == 0 and rec.stats()["live"] == 0


def test_same_dump_as_the_reference_recorder():
    """The same calls give the same dump (timestamps aside)."""
    def drive(mod):
        rec = mod.FlightRecorder(capacity=8, pinned_capacity=4)
        rec.annotate("x", "serve.enqueue", queue_depth=2)
        rec.batch("b1", ["x", "y"], replica=0, rows=2)
        rec.finish("x", "completed", batch="b1", replica=0)
        rec.finish("y", "shed", batch="b1")
        rec.ops("serve.swap", version="v1")
        d = rec.dump()
        for tr in d["traces"]:
            tr.pop("ts"), tr.pop("seconds")
            for e in tr["events"]:
                e.pop("t")
        for b in d["batches"]:
            b.pop("ts")
        for o in d["ops"]:
            o.pop("ts")
        return d

    assert drive(recorder) == drive(ref_recorder)


# ------------------------------------------------- service + HTTP surface
def test_shed_request_chain_from_requestz_with_ledger_off():
    """Ledger off, a shed request's causal chain (ingress → queue → batch
    → replica → shed) resolves from GET /requestz/<id> alone."""
    with _service(max_batch=4, max_wait_ms=5.0) as svc:
        with serve_http(svc, port=0) as front:
            base = f"http://127.0.0.1:{front.port}"
            with pytest.raises(urllib.error.HTTPError) as err:
                _post_json(base + "/predict", {"instance": [1.0] * DIM, "deadline_ms": 0.0001},
                           headers={"X-Request-Id": "doomed-http"})
            assert err.value.code == 504
            assert json.loads(err.value.read())["request_id"] == "doomed-http"
            status, tr = _get_json(base + "/requestz/doomed-http")
            assert status == 200
    assert tr["outcome"] == "shed"
    assert [e["name"] for e in tr["events"]] == ["http.ingress", "serve.enqueue", "serve.batch", "serve.shed"]
    batch_ev = tr["events"][2]["attrs"]
    assert batch_ev["replica"] == 0 and batch_ev["batch"] in tr["batches"]
    assert batch_ev["queue_wait_seconds"] >= 0.0
    (b,) = tr["batch_records"]
    assert "doomed-http" in b["request_ids"] and b["replica"] == 0


def test_completed_chain_and_tracez_filtering():
    with _service(max_batch=4, max_wait_ms=5.0) as svc:
        svc.submit(np.ones(DIM, np.float32), request_id="ok-1").result(timeout=WAIT)
        doomed = svc.submit(np.ones(DIM, np.float32), deadline=-0.01, request_id="doomed-1")
        with pytest.raises(guard.DeadlineExceeded):
            doomed.result(timeout=WAIT)
        rec = svc.recorder
        tr = rec.request("ok-1")
        names = [e["name"] for e in tr["events"]]
        assert tr["outcome"] == "completed"
        assert names[0] == "serve.enqueue" and names[-1] == "serve.completed"
        rep = next(e for e in tr["events"] if e["name"] == "serve.batch")
        assert rep["attrs"]["queue_wait_seconds"] >= 0.0
        assert tr["events"][-1]["attrs"]["apply_seconds"] > 0.0
        assert [t["request_id"] for t in rec.tracez(filter="shed")] == ["doomed-1"]
        all_ids = [t["request_id"] for t in rec.tracez()]
        assert "ok-1" in all_ids and "doomed-1" in all_ids


def test_rejected_request_is_traced():
    svc = _service(max_batch=64, max_wait_ms=10_000.0, queue_bound=2)
    try:
        svc.submit(np.ones(DIM, np.float32))
        svc.submit(np.ones(DIM, np.float32))
        with pytest.raises(Overloaded):
            svc.submit(np.ones(DIM, np.float32), request_id="rej-1")
        tr = svc.recorder.request("rej-1")
        assert tr["outcome"] == "rejected" and tr["events"][-1]["name"] == "serve.rejected"
    finally:
        svc.close(timeout=WAIT)


def test_recorder_off_mints_no_ids_and_serves_the_same_rows():
    x = np.random.default_rng(0).normal(size=(5, DIM)).astype(np.float32)
    ref = _pipeline()(Dataset(x, device="cpu")).get().numpy()
    before = recorder.new_request_id()
    with _service(recorder=False) as svc:
        assert svc.recorder is None
        got = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(x)])
        with serve_http(svc, port=0) as front:
            base = f"http://127.0.0.1:{front.port}"
            for path in ("/tracez", "/requestz/whatever"):
                with pytest.raises(urllib.error.HTTPError) as err:
                    urllib.request.urlopen(base + path, timeout=WAIT)
                assert err.value.code == 409
    after = recorder.new_request_id()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert int(after.rsplit("-", 1)[1], 16) - int(before.rsplit("-", 1)[1], 16) == 1


def test_statusz_surface():
    with _service(max_batch=4, max_wait_ms=5.0, deadline_ms=5000.0, slo_ms=100.0) as svc:
        [f.result(timeout=WAIT) for f in svc.submit_many(np.ones((6, DIM), np.float32))]
        doomed = svc.submit(np.ones(DIM, np.float32), deadline=-0.01)
        with pytest.raises(guard.DeadlineExceeded):
            doomed.result(timeout=WAIT)
        with pytest.raises(TypeError):  # a client fault burns no budget
            svc.submit(np.ones(DIM + 1, np.float32))
        with serve_http(svc, port=0) as front:
            status, st = _get_json(f"http://127.0.0.1:{front.port}/statusz")
    assert status == 200
    assert st["latency_ms"]["count"] >= 6 and st["latency_ms"]["p50"] is not None
    assert st["latency_ms"]["p99"] >= st["latency_ms"]["p50"]
    assert st["batch_ms"]["count"] >= 1 and st["counters"]["completed"] >= 6
    assert st["replicas"][0]["replica"] == 0 and st["recorder"]["finished"] >= 7
    slo = st["slo"]
    assert slo["objective_ms"] == 100.0 and slo["target"] == 0.99
    assert slo["window_failed"] == 1
    assert slo["bad_fraction"] >= 1.0 / slo["window_requests"] - 1e-6
    assert slo["burn_rate"] > 0.0


def test_trace_continuity_across_swap_under_load():
    stop = threading.Event()
    failures, outs = [], []
    with _service(max_batch=4, max_wait_ms=2.0) as svc:

        def pound():
            i = 0
            while not stop.is_set():
                i += 1
                try:
                    fut = svc.submit(np.ones(DIM, np.float32), request_id=f"load-{i}")
                    outs.append((f"load-{i}", np.asarray(fut.result(timeout=WAIT))))
                except Exception as e:  # fails the test below
                    failures.append(e)
                    return

        t = threading.Thread(target=pound, daemon=True)
        t.start()
        time.sleep(0.15)
        info = svc.swap(_pipeline(scale=5.0), version="green")
        time.sleep(0.15)
        stop.set()
        t.join(WAIT)
        assert not t.is_alive() and not failures
        assert len(outs) > 4
        rec = svc.recorder
        ops = [o for o in rec.ops_spans() if o["name"] == "serve.swap"]
        assert ops and ops[0]["version"] == "green" and info["version"] == "green"
        blue = green = 0
        for rid, out in outs:
            tr = rec.request(rid)
            if tr is None:
                continue  # evicted happy-path trace: retention, not loss
            names = [e["name"] for e in tr["events"]]
            assert tr["outcome"] == "completed" and names[0] == "serve.enqueue"
            assert names[-1] == "serve.completed" and "serve.batch" in names
            if abs(out[0] - 2.0 / np.sqrt(DIM)) < 1e-4:
                blue += 1
            else:
                green += 1
        assert blue > 0 and green > 0


def test_tracez_dump_writes_a_durable_snapshot(tmp_path):
    from keystone_tpu_torch.utils import durable

    with _service(max_batch=4, max_wait_ms=2.0) as svc:
        with serve_http(svc, port=0, trace_dump_dir=str(tmp_path)) as front:
            base = f"http://127.0.0.1:{front.port}"
            _post_json(base + "/predict", {"instance": [1.0] * DIM}, headers={"X-Request-Id": "dump-me"})
            status, body, _ = _post_json(base + "/tracez/dump", {})
            assert status == 200
            path = body["path"]
            assert os.path.dirname(path) == str(tmp_path) and path.endswith(".json")
            assert body["stats"]["finished"] >= 1
            override = str(tmp_path / "override")
            status, body, _ = _post_json(base + "/tracez/dump", {"dir": override})
            assert status == 200 and os.path.dirname(body["path"]) == override
    assert durable.verify_checksum(path, required=True)
    with open(path) as f:
        dump = json.load(f)
    assert "dump-me" in [t["request_id"] for t in dump["traces"]]


def test_tracez_dump_without_dir_or_recorder_is_409():
    for kw in (dict(recorder=False), {}):
        with _service(**kw) as svc:
            with serve_http(svc, port=0) as front:
                with pytest.raises(urllib.error.HTTPError) as err:
                    _post_json(f"http://127.0.0.1:{front.port}/tracez/dump", {})
                assert err.value.code == 409
