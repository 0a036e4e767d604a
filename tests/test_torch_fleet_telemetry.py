"""Fleet telemetry (keystone_tpu_torch/serve/telemetry.py) against the
reference's tests/test_fleet_telemetry.py, one counterpart each, on the
CPU: the clock sync's four-timestamp math, the span clamp, the worker's
bounded span ring and metric deltas, the router's sink (stitching into
the flight recorder, old peers, no recorder, the /statusz block).  Then
what the port adds: the kernel reports the workers ship (summed over
every worker process, a dead one's last report kept), the reference's
worker shipments read by the port's sink, and served scores through a
spawned worker process against the reference's threaded serve().

Every wait is bounded."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models.linear import LinearMapper as JLinearMapper
from keystone_tpu.ops.stats import NormalizeRows as JNormalizeRows
from keystone_tpu.serve import serve as jserve
from keystone_tpu.serve import telemetry as jtelemetry
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.obs.recorder import FlightRecorder
from keystone_tpu_torch.ops.stats import NormalizeRows
from keystone_tpu_torch.serve import serve
from keystone_tpu_torch.serve.telemetry import (
    ClockSync,
    FleetTelemetry,
    WorkerTelemetry,
    clamp_span,
)
from keystone_tpu_torch.workflow.pipeline import Pipeline

pytestmark = [pytest.mark.serve, pytest.mark.obs]


# --------------------------------------------------------------- ClockSync


SKEW = 5.0  # worker_clock - router_clock in every synthetic exchange


def _exchange(sync, t_send, wire_s, compute_s, skew=SKEW):
    """One synthetic four-timestamp exchange with symmetric wire time."""
    t_rx = t_send + wire_s / 2.0 + skew
    t_tx = t_rx + compute_s
    t_recv = t_send + wire_s + compute_s
    return sync.observe(t_send, t_recv, t_rx, t_tx)


def test_clock_sync_recovers_known_skew():
    sync = ClockSync()
    delay = _exchange(sync, 10.0, wire_s=0.004, compute_s=0.002)
    assert delay == pytest.approx(0.004)
    assert sync.offset == pytest.approx(SKEW)
    assert sync.to_router(100.0 + SKEW) == pytest.approx(100.0)


def test_clock_sync_min_delay_sample_wins():
    """A slower exchange carries a worse offset bound — it must not
    displace the best sample even when its (asymmetric) offset
    estimate differs."""
    sync = ClockSync()
    _exchange(sync, 10.0, wire_s=0.002, compute_s=0.001)
    best = sync.offset
    # asymmetric slow sample: all the wire time on the send leg, so
    # its naive offset estimate is off by ~wire/2
    sync.observe(20.0, 20.102, 20.1 + SKEW, 20.101 + SKEW)
    assert sync.offset == best  # kept the tight sample
    assert sync.samples == 2


def test_clock_sync_rejects_negative_delay():
    """The reply to an EARLIER retransmitted send can pair with a later
    t_send, making measured delay negative — unusable, rejected."""
    sync = ClockSync()
    assert sync.observe(10.0, 10.001, 15.0, 15.005) is None
    assert sync.offset is None and sync.samples == 0


def test_clock_sync_decay_readmits_samples_after_drift():
    """The kept delay bound grows per rejected sample, so a drifted
    clock re-syncs instead of trusting one ancient lucky sample."""
    sync = ClockSync()
    _exchange(sync, 0.0, wire_s=0.001, compute_s=0.0)
    first_best = sync.best_delay
    for i in range(200):
        _exchange(sync, float(i + 1), wire_s=0.0015, compute_s=0.0)
    assert sync.best_delay > first_best  # decayed upward...
    # ...far enough that a typical sample finally won and refreshed
    # the offset (the 0.0015 samples carry the same SKEW, so the
    # offset stays correct either way)
    assert sync.offset == pytest.approx(SKEW, abs=1e-3)


# --------------------------------------------------------------- clamp_span


def test_clamp_span_bounds_order_and_duration():
    sync = ClockSync()
    _exchange(sync, 10.0, wire_s=0.004, compute_s=0.010)
    t_send, t_recv = 10.0, 10.014
    # a worker span genuinely inside the window aligns inside it
    r0, r1 = clamp_span(sync, 10.003 + SKEW, 10.011 + SKEW, t_send, t_recv)
    assert t_send <= r0 <= r1 <= t_recv
    assert (r1 - r0) == pytest.approx(0.008, abs=1e-6)


def test_clamp_span_tolerates_wildly_wrong_offset():
    """Force a badly wrong offset: the aligned span must still land
    inside [t_send, t_recv], ordered, with non-negative duration."""
    sync = ClockSync()
    sync.observe(0.0, 0.001, 1000.0, 1000.001)  # offset ~ +1000, "valid"
    t_send, t_recv = 50.0, 50.01
    r0, r1 = clamp_span(sync, 50.001, 50.009, t_send, t_recv)  # true skew 0
    assert t_send <= r0 <= r1 <= t_recv


def test_clamp_span_without_sync_preserves_duration():
    sync = ClockSync()
    t_send, t_recv = 5.0, 5.5
    r0, r1 = clamp_span(sync, 99.0, 99.2, t_send, t_recv)
    assert r0 == t_send and (r1 - r0) == pytest.approx(0.2)
    # duration longer than the window clamps to the window
    r0, r1 = clamp_span(sync, 99.0, 100.0, t_send, t_recv)
    assert (r0, r1) == (t_send, t_recv)


# --------------------------------------------------------- WorkerTelemetry


def test_worker_spans_drop_oldest_never_queue():
    tel = WorkerTelemetry(registry=metrics.MetricsRegistry(), max_spans=4)
    for i in range(10):
        tel.add_span(f"s{i}", float(i), float(i) + 0.5)
    blob = tel.ship(t_rx=1.0)
    assert [s["name"] for s in blob["spans"]] == ["s6", "s7", "s8", "s9"]
    assert blob["t_rx"] == 1.0 and "t_tx" in blob
    # drained: the next ship carries no spans key at all
    assert "spans" not in tel.ship()


def test_worker_span_recorded_even_when_block_raises():
    tel = WorkerTelemetry(registry=metrics.MetricsRegistry())
    with pytest.raises(RuntimeError):
        with tel.span("worker.apply", n=3):
            raise RuntimeError("boom")
    (sp,) = tel.ship()["spans"]
    assert sp["name"] == "worker.apply" and sp["attrs"] == {"n": 3}
    assert sp["t1"] >= sp["t0"]


def test_metrics_delta_roundtrip_under_fleet_labels():
    wreg = metrics.MetricsRegistry()
    rreg = metrics.MetricsRegistry()
    tel = WorkerTelemetry(registry=wreg)
    wreg.inc("serve.applies", 3.0)
    wreg.set_gauge("serve.occupancy", 0.5, replica=0)
    wreg.observe("serve.apply_seconds", 0.004)
    entries = tel.metrics_entries(min_interval_s=0.0)
    assert entries
    merged = rreg.merge_entries(entries, worker="w0", host="hA")
    assert merged == len(entries)
    assert rreg.counter_value("serve.applies", worker="w0", host="hA") == 3.0
    assert (
        rreg.gauge_value("serve.occupancy", replica=0, worker="w0", host="hA")
        == 0.5
    )
    h = rreg.histogram_summary("serve.apply_seconds", worker="w0", host="hA")
    assert h is not None and h["count"] == 1
    # second delta ships only the change
    wreg.inc("serve.applies", 2.0)
    wreg.observe("serve.apply_seconds", 0.006)
    entries2 = tel.metrics_entries(min_interval_s=0.0)
    rreg.merge_entries(entries2, worker="w0", host="hA")
    assert rreg.counter_value("serve.applies", worker="w0", host="hA") == 5.0
    h2 = rreg.histogram_summary("serve.apply_seconds", worker="w0", host="hA")
    assert h2["count"] == 2


def test_metrics_delta_throttle_window():
    wreg = metrics.MetricsRegistry()
    tel = WorkerTelemetry(registry=wreg, min_metrics_interval_s=3600.0)
    wreg.inc("serve.applies")
    assert tel.metrics_entries() is not None  # first ship goes out
    wreg.inc("serve.applies")
    assert tel.metrics_entries() is None  # inside the window: held
    assert tel.metrics_entries(min_interval_s=0.0) is not None  # override


def test_capped_delta_export_ships_remainder_next_round():
    """Baselines advance only for entries that made the cut — a capped
    export loses nothing, it just ships the rest next time."""
    wreg = metrics.MetricsRegistry()
    tel = WorkerTelemetry(registry=wreg, max_entries=1)
    wreg.inc("serve.a", 1.0)
    wreg.inc("serve.b", 2.0)
    first = tel.metrics_entries(min_interval_s=0.0)
    second = tel.metrics_entries(min_interval_s=0.0)
    assert len(first) == 1 and len(second) == 1
    names = {e[1] for e in first} | {e[1] for e in second}
    assert names == {"serve.a", "serve.b"}


def test_merge_entries_skips_malformed_and_kind_conflicts():
    rreg = metrics.MetricsRegistry()
    rreg.inc("serve.x")  # counter; a gauge shipment for it must not raise
    merged = rreg.merge_entries(
        [
            "not-a-list",
            ["c", "serve.ok", [], 2.0],
            ["g", "serve.x", [], 1.0],  # kind conflict: dropped
            ["h", "serve.bad", [], {"bounds": "garbage"}],
            ["?", "serve.unknown", [], 1.0],
        ],
        worker="w0",
    )
    assert merged == 1
    assert rreg.counter_value("serve.ok", worker="w0") == 2.0


# ---------------------------------------------------------- FleetTelemetry


def _shipped(spans=None, t_rx=10.0 + SKEW + 0.001, t_tx=10.0 + SKEW + 0.003):
    blob = {"t_rx": t_rx, "t_tx": t_tx}
    if spans is not None:
        blob["spans"] = spans
    return blob


def test_fleet_telemetry_stitches_batch_record_for_requestz():
    rec = FlightRecorder()
    reg = metrics.MetricsRegistry()
    fleet = FleetTelemetry(registry=reg, recorder=rec)
    rec.annotate("r1", "serve.replica", batch="b1", replica=0)
    rec.batch("b1", ["r1"], replica=0, rows=1)
    spans = [
        {"name": "worker.attach", "t0": 10.0 + SKEW + 0.0012, "t1": 10.0 + SKEW + 0.0015},
        {"name": "worker.apply", "t0": 10.0 + SKEW + 0.0015, "t1": 10.0 + SKEW + 0.0028, "attrs": {"n": 1}},
    ]
    fleet.on_exchange(
        "net0", "hostA", 10.0, 10.004, _shipped(spans), trace={"batch": "b1"}
    )
    rec.finish("r1", "completed", batch="b1")
    (b,) = rec.request("r1")["batch_records"]
    assert b["worker"] == "net0" and b["host"] == "hostA"
    assert b["wire"]["rtt_s"] == pytest.approx(0.002, abs=1e-6)
    names = [s["name"] for s in b["worker_spans"]]
    assert names == ["worker.attach", "worker.apply"]
    for s in b["worker_spans"]:
        assert s["seconds"] >= 0.0
        assert 0.0 <= s["t_off"] <= 0.004
    # the apply span also fed the labeled fleet series
    h = reg.histogram_summary(
        "serve.fleet.apply_seconds", worker="net0", host="hostA"
    )
    assert h is not None and h["count"] == 1
    rtt = reg.histogram_summary(
        "serve.fleet.wire_rtt_seconds", worker="net0", host="hostA"
    )
    assert rtt is not None and rtt["count"] == 1


def test_fleet_telemetry_old_peer_is_a_silent_noop():
    rec = FlightRecorder()
    reg = metrics.MetricsRegistry()
    fleet = FleetTelemetry(registry=reg, recorder=rec)
    fleet.on_exchange("w0", None, 1.0, 2.0, None)  # old worker: no body
    fleet.on_exchange("w0", None, 1.0, 2.0, "garbage")
    fleet.on_exchange("w0", None, 1.0, 2.0, {"spans": "garbage", "t_rx": "x"})
    fleet.on_beat("w0", None, None)
    fleet.on_beat("w0", None, {"metrics": "garbage"})
    assert fleet.known_workers() in ([], ["w0"])  # never raised
    assert rec.stats()["live"] == 0


def test_fleet_telemetry_without_recorder_still_aggregates():
    reg = metrics.MetricsRegistry()
    fleet = FleetTelemetry(registry=reg, recorder=None)
    fleet.on_exchange(
        "p0",
        None,
        10.0,
        10.004,
        {
            **_shipped([{"name": "worker.apply", "t0": 10.0 + SKEW + 0.0015, "t1": 10.0 + SKEW + 0.0028}]),
            "metrics": [["c", "serve.applies", [], 4.0]],
        },
        trace={"batch": "b9"},  # recorder off: stitching skipped, no error
    )
    assert reg.counter_value("serve.applies", worker="p0", host="local") == 4.0
    h = reg.histogram_summary(
        "serve.fleet.apply_seconds", worker="p0", host="local"
    )
    assert h is not None and h["count"] == 1


def test_fleet_status_block_shape():
    reg = metrics.MetricsRegistry()
    fleet = FleetTelemetry(registry=reg, recorder=None)
    fleet.on_exchange("net0", "hostA", 10.0, 10.004, _shipped(
        [{"name": "worker.apply", "t0": 10.0 + SKEW + 0.001, "t1": 10.0 + SKEW + 0.003}]
    ))
    st = fleet.fleet_status()
    entry = st["workers"]["net0"]
    assert entry["host"] == "hostA"
    assert entry["clock_samples"] == 1
    assert entry["clock_offset_s"] == pytest.approx(SKEW, abs=1e-3)
    assert entry["apply_ms"]["count"] == 1 and entry["apply_ms"]["p50"] is not None
    assert entry["wire_rtt_ms"]["count"] == 1


# ------------------------------------------------- the port's additions
DIM = 6
WAIT = 60


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    """The reference's serve() turns on JAX's persistent compilation cache
    for the process unless KEYSTONE_COMPILE_CACHE says no."""
    monkeypatch.setenv("KEYSTONE_COMPILE_CACHE", "0")


def _report(pid, fused, replayed, peak=0):
    return {"pid": pid, "device": "cuda:0", "launches": {"fused_forward": fused, "fisher_encode": 0},
            "replayed": {"fused_forward": replayed}, "peak_reserved_bytes": peak}


def test_kernel_reports_sum_over_worker_processes():
    """Each worker process's last kernel report is kept by (worker, pid):
    a replacement under the same slot name adds to, and does not erase,
    the report of the process it replaced."""
    fleet = FleetTelemetry(registry=metrics.MetricsRegistry())
    fleet.on_exchange("w0", None, 1.0, 2.0, {"kernels": _report(100, 10, 4)})
    fleet.on_exchange("w0", None, 2.0, 3.0, {"kernels": _report(100, 12, 8, peak=1 << 20)})
    fleet.on_exchange("w1", None, 2.0, 3.0, {"kernels": _report(101, 10, 2)})
    fleet.on_exchange("w0", None, 4.0, 5.0, {"kernels": _report(102, 10, 0)})  # w0's replacement
    fleet.on_exchange("w1", None, 4.0, 5.0, {"kernels": "garbage"})  # ignored, never raised
    totals = fleet.kernel_totals()
    assert totals["launches"]["fused_forward"] == 12 + 10 + 10
    assert totals["replayed"]["fused_forward"] == 8 + 2
    st = fleet.fleet_status()["workers"]
    assert st["w0"]["pid"] == 102 and st["w1"]["peak_reserved_bytes"] == 0


def test_worker_telemetry_ships_its_kernel_report():
    calls = []
    tel = WorkerTelemetry(report=lambda: calls.append(1) or _report(7, 1, 2))
    blob = tel.ship(t_rx=1.0)
    assert blob["kernels"]["pid"] == 7 and calls == [1]
    assert "kernels" not in WorkerTelemetry().ship()


def test_reference_worker_shipments_reach_the_port_sink():
    """The reference's WorkerTelemetry blobs (spans, metric deltas) are
    read by the port's FleetTelemetry: the body keys are the same, and
    the absent kernel report is an older peer, not an error."""
    reg_w = jtelemetry.metrics.MetricsRegistry()
    wt = jtelemetry.WorkerTelemetry(registry=reg_w, min_metrics_interval_s=0.0)
    reg_w.inc("serve.applies", 3.0)
    with wt.span("worker.apply", n=2):
        pass
    shipped = wt.ship(t_rx=0.5)
    reg = metrics.MetricsRegistry()
    fleet = FleetTelemetry(registry=reg)
    fleet.on_exchange("ref0", "hostR", 0.0, shipped["t_tx"] + 1.0, shipped)
    assert reg.counter_value("serve.applies", worker="ref0", host="hostR") == 3.0
    assert reg.histogram_summary("serve.fleet.apply_seconds", worker="ref0", host="hostR")["count"] == 1
    assert fleet.kernel_totals() == {"launches": {}, "replayed": {}}


def test_clock_sync_and_clamp_agree_with_the_reference():
    ours, ref = ClockSync(), jtelemetry.ClockSync()
    for t_send, wire_s, compute_s in ((10.0, 0.004, 0.002), (11.0, 0.001, 0.003), (12.0, 0.009, 0.001)):
        assert _exchange(ours, t_send, wire_s, compute_s) == _exchange(ref, t_send, wire_s, compute_s)
    assert (ours.offset, ours.best_delay, ours.samples) == (ref.offset, ref.best_delay, ref.samples)
    for t0, t1 in ((15.0, 15.001), (14.0, 16.5), (30.0, 29.0)):
        assert clamp_span(ours, t0, t1, 10.0, 10.01) == jtelemetry.clamp_span(ref, t0, t1, 10.0, 10.01)


def test_process_fleet_serves_the_reference_scores_and_ships_telemetry():
    """A one-worker process fleet on the CPU against the reference's
    threaded serve() on the same seeded rows and weights (1e-5), with the
    worker's spans stitched into the recorder and its kernel report and
    fleet status in /statusz."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(DIM, 4)).astype(np.float32)
    x = rng.normal(size=(9, DIM)).astype(np.float32)
    kw = dict(max_batch=8, max_wait_ms=5.0, queue_bound=64, example=np.zeros(DIM, np.float32))
    with jserve(JPipeline.of(JNormalizeRows()) | JLinearMapper(jnp.asarray(w)), **kw) as ref:
        want = np.stack([np.asarray(f.result(timeout=WAIT)) for f in ref.submit_many(x)])
    svc = serve(Pipeline.of(NormalizeRows()) | LinearMapper(torch.from_numpy(w)), workers=1,
                worker_opts={"device": "cpu"}, name="tel_ref", **kw)
    try:
        futs = [svc.submit(x[0], request_id="tel-ref-0")] + svc.submit_many(x[1:])
        got = np.stack([f.result(timeout=WAIT) for f in futs])
        st = svc.status()
        tr = svc.recorder.request("tel-ref-0")
    finally:
        svc.close(timeout=WAIT)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    (entry,) = st["fleet"]["workers"].values()
    assert entry["device"] == "cpu" and entry["peak_reserved_bytes"] == 0 and isinstance(entry["pid"], int)
    assert any(b.get("worker") for b in tr["batch_records"])
    totals = svc.telemetry.kernel_totals()
    assert set(totals["launches"]) >= {"fused_forward", "fisher_encode", "gram_block", "poly_block"}
