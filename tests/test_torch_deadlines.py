"""The port's deadlines, watchdogs, circuit breakers and degradation
(keystone_tpu_torch/utils/guard.py, the executor's wiring, the stream's
fetch timeouts and the latency fault actions), scenario by scenario as
the JAX package's tests/test_guard.py holds its own; its multihost cases
go with the multi-process slice.  The acceptance scenario runs in both
packages and must leave the same ledger events."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch import faults
from keystone_tpu_torch.loaders.stream import batched, resilient
from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.utils import guard
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.executor import GraphExecutor
from keystone_tpu_torch.workflow.pipeline import Pipeline
from keystone_tpu_torch.workflow.transformer import Transformer


@pytest.fixture(autouse=True)
def _fresh_guard_state():
    guard.reset_breakers()
    yield
    guard.reset_breakers()
    ledger.stop_run(snapshot=False)


def _events(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _cpu(a):
    return Dataset(np.asarray(a, np.float32), device="cpu")


class _AddOne(Transformer):
    def params(self):
        return ()

    def apply_dataset(self, ds):
        return ds.with_array(ds.array + 1.0)


class _Broken(Transformer):
    """A stage that always fails; counts its attempts."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def apply_dataset(self, ds):
        self.calls += 1
        raise OSError("broken stage")


class _Const(Transformer):
    def apply_dataset(self, ds):
        return ds.with_array(torch.full_like(ds.array, 9.0))


def _run(t, value=1.0, **kw):
    lazy = Pipeline.of(t)(_cpu(np.full((4, 2), value)))
    return GraphExecutor(lazy.graph, **kw).execute(lazy.graph.sinks[0])


# ------------------------------------------------------------- Deadline


def test_deadline_remaining_expiry_and_children():
    dl = guard.Deadline.after(10.0)
    assert 9.0 < dl.remaining() <= 10.0 and not dl.expired()
    assert guard.Deadline.after(-1.0).expired()
    parent = guard.Deadline.after(0.5)
    assert parent.child(100.0).at == parent.at  # never past the parent, read without a second clock
    assert parent.child(0.1).remaining() <= 0.1 + 1e-6
    assert abs(parent.child(None).at - parent.at) < 1e-9
    assert guard.as_deadline(None) is None
    assert guard.as_deadline(dl) is dl
    assert isinstance(guard.as_deadline(2.5), guard.Deadline)


def test_heartbeat_expires_without_beats():
    hb = guard.Heartbeat(0.05)
    assert not hb.expired()
    time.sleep(0.08)
    assert hb.expired()
    hb.beat()
    assert not hb.expired()


@pytest.mark.parametrize("name,value,want", [
    (guard.ENV_STAGE_DEADLINE, "2.5", 2.5), (guard.ENV_STAGE_DEADLINE, "0", None),
    (guard.ENV_STAGE_DEADLINE, "x", None), (guard.ENV_BREAKER_THRESHOLD, "3.7", 3),
    (guard.ENV_BREAKER_RESET, "7", 7.0), (guard.ENV_HANG_SECONDS, "", 3600.0),
])
def test_environment_knobs(monkeypatch, name, value, want):
    monkeypatch.setenv(name, value)
    read = {guard.ENV_STAGE_DEADLINE: guard.stage_deadline_seconds,
            guard.ENV_BREAKER_THRESHOLD: guard.stage_breaker_threshold,
            guard.ENV_BREAKER_RESET: guard.breaker_reset_seconds,
            guard.ENV_HANG_SECONDS: guard.hang_seconds}[name]
    assert read() == want


# ----------------------------------------------------- run_with_deadline


def test_run_with_deadline_none_is_same_thread_passthrough():
    seen = []
    assert guard.run_with_deadline(lambda: seen.append(threading.current_thread()) or "v", None) == "v"
    assert seen == [threading.current_thread()]


def test_run_with_deadline_returns_result_and_propagates_errors():
    assert guard.run_with_deadline(lambda: 41 + 1, guard.Deadline.after(5)) == 42
    with pytest.raises(ValueError, match="boom"):
        guard.run_with_deadline(lambda: (_ for _ in ()).throw(ValueError("boom")), guard.Deadline.after(5))


def test_watchdog_fires_on_sleeping_fn():
    released = threading.Event()

    def sleepy():
        guard.interruptible_sleep(30.0)
        released.set()

    metrics.reset()
    t0 = time.perf_counter()
    with pytest.raises(guard.DeadlineExceeded) as ei:
        guard.run_with_deadline(sleepy, guard.Deadline.after(0.2), site="t")
    assert time.perf_counter() - t0 < 5.0
    assert isinstance(ei.value, OSError)
    assert released.wait(timeout=5.0)
    assert metrics.REGISTRY.counter_value("guard.deadline_exceeded", site="t") == 1


def test_abandoned_result_is_dropped():
    """An abandoned attempt's result never reaches anyone: the worker
    drops it as soon as it returns, so its memory is free again."""
    import gc
    import weakref

    class Result:
        pass

    refs = []

    def slow():
        time.sleep(0.3)
        r = Result()
        refs.append(weakref.ref(r))
        return r

    with pytest.raises(guard.DeadlineExceeded) as ei:
        guard.run_with_deadline(slow, guard.Deadline.after(0.05))
    ei.value.worker.join(5.0)
    assert not ei.value.worker.is_alive()
    gc.collect()
    assert refs and refs[0]() is None


def test_expired_deadline_fails_fast_without_running():
    ran = []
    with pytest.raises(guard.DeadlineExceeded):
        guard.run_with_deadline(lambda: ran.append(1), guard.Deadline.after(-1.0), site="t2")
    assert not ran


def test_deadline_exceeded_event_lands_in_ledger(tmp_path):
    led = ledger.start_run(str(tmp_path))
    with pytest.raises(guard.DeadlineExceeded):
        guard.run_with_deadline(lambda: time.sleep(2), guard.Deadline.after(0.1), site="ev")
    ledger.stop_run()
    hits = [e for e in _events(led.path) if e.get("name") == "deadline_exceeded"]
    assert hits and hits[0]["attrs"]["site"] == "ev"


# ------------------------------------------------------- CircuitBreaker


def test_breaker_open_halfopen_close_cycle():
    clk = [0.0]
    b = guard.CircuitBreaker("cyc", threshold=2, reset_timeout=10.0, clock=lambda: clk[0])
    assert b.allow() and b.state() == guard.CLOSED
    b.record_failure()
    assert b.state() == guard.CLOSED
    b.record_failure()
    assert b.state() == guard.OPEN and not b.allow()
    assert b.seconds_until_probe() == 10.0
    clk[0] = 10.0
    assert b.allow() and b.state() == guard.HALF_OPEN
    assert not b.allow()
    b.record_success()
    assert b.state() == guard.CLOSED and b.allow()


def test_breaker_halfopen_failure_reopens():
    clk = [0.0]
    b = guard.CircuitBreaker("re", threshold=1, reset_timeout=5.0, clock=lambda: clk[0])
    b.record_failure()
    clk[0] = 5.0
    assert b.allow()
    b.record_failure()
    assert b.state() == guard.OPEN and not b.allow()
    clk[0] = 9.0
    assert not b.allow()
    clk[0] = 10.0
    assert b.allow()


def test_breaker_unrecorded_probe_does_not_wedge_halfopen():
    clk = [0.0]
    b = guard.CircuitBreaker("wedge", threshold=1, reset_timeout=5.0, clock=lambda: clk[0])
    b.record_failure()
    clk[0] = 5.0
    assert b.allow() and not b.allow()
    clk[0] = 9.9
    assert not b.allow()
    clk[0] = 10.0
    assert b.allow()
    b.record_success()
    assert b.state() == guard.CLOSED


def test_breaker_success_resets_consecutive_count():
    b = guard.CircuitBreaker("cnt", threshold=2, reset_timeout=5.0)
    b.record_failure()
    b.record_success()
    b.record_failure()
    assert b.state() == guard.CLOSED


def test_breaker_transitions_mirror_into_metrics_and_ledger(tmp_path):
    led = ledger.start_run(str(tmp_path))
    b = guard.CircuitBreaker("obs-key", threshold=1, reset_timeout=60.0)
    b.record_failure()
    ledger.stop_run()
    assert metrics.REGISTRY.gauge_value("breaker.state", key="obs-key") == 2.0
    assert metrics.REGISTRY.counter_value("breaker.opens", key="obs-key") >= 1.0
    tr = [e for e in _events(led.path) if e.get("name") == "breaker.transition"]
    assert tr and tr[-1]["attrs"] == {"key": "obs-key", "from_state": "closed", "to_state": "open"}


def test_breaker_registry_is_per_key_and_stable():
    a = guard.breaker("a", threshold=5)
    assert guard.breaker("a", threshold=9) is a and a.threshold == 5
    assert guard.breaker("b") is not a
    guard.reset_breakers()
    assert guard.breaker("a") is not a


# ------------------------------------------- executor wiring: degradation


def test_optional_node_degrades_to_identity(tmp_path):
    led = ledger.start_run(str(tmp_path))
    t = _Broken()
    t.optional = True
    out = _run(t, 7.0, node_retries=1)
    ledger.stop_run()
    np.testing.assert_allclose(out.dataset.array.numpy(), 7.0)
    assert t.calls == 2
    deg = [e for e in _events(led.path) if e.get("name") == "degraded"]
    assert deg and deg[0]["attrs"]["substitute"] == "Identity"
    assert deg[0]["attrs"]["reason"] == "budget_exhausted"


def test_with_fallback_substitutes_and_original_untouched():
    t = _Broken()
    fb = t.with_fallback(_Const())
    assert t.fallback is None and "fallback" not in t._modules
    assert fb.fallback is not None
    metrics.reset()
    out = _run(fb, node_retries=0)
    np.testing.assert_allclose(out.dataset.array.numpy(), 9.0)
    assert metrics.REGISTRY.counter_value("executor.degraded", node="_Broken") == 1


def test_mandatory_node_failure_still_propagates():
    t = _Broken()
    with pytest.raises(OSError, match="broken stage"):
        _run(t, node_retries=1)
    assert t.calls == 2


def test_degradation_declarations_block_fusion_and_split_cse():
    from keystone_tpu_torch.workflow.graph import TransformerOperator
    from keystone_tpu_torch.workflow.optimizer import _fusable

    assert _fusable(TransformerOperator(_AddOne()))
    opt = _AddOne()
    opt.optional = True
    assert not _fusable(TransformerOperator(opt))
    assert not _fusable(TransformerOperator(_AddOne().with_fallback(_Const())))
    assert _AddOne().signature() != opt.signature()
    assert _AddOne().signature() != _AddOne().with_fallback(_Const()).signature()


# --------------------------------------------- executor wiring: breakers


def test_breaker_open_short_circuits_next_run(monkeypatch):
    monkeypatch.setenv(guard.ENV_BREAKER_THRESHOLD, "1")
    t = _Broken()
    lazy = Pipeline.of(t)(_cpu(np.ones((4, 2))))
    with pytest.raises(OSError):
        GraphExecutor(lazy.graph, node_retries=0).execute(lazy.graph.sinks[0])
    with pytest.raises(guard.CircuitOpenError):
        GraphExecutor(lazy.graph, node_retries=0).execute(lazy.graph.sinks[0])
    assert t.calls == 1


def test_breaker_open_degrades_optional_node(monkeypatch):
    monkeypatch.setenv(guard.ENV_BREAKER_THRESHOLD, "1")
    t = _Broken()
    t.optional = True
    lazy = Pipeline.of(t)(_cpu(np.full((4, 2), 3.0)))
    for _ in range(2):
        out = GraphExecutor(lazy.graph, node_retries=0).execute(lazy.graph.sinks[0])
        np.testing.assert_allclose(out.dataset.array.numpy(), 3.0)
    assert t.calls == 1
    assert metrics.REGISTRY.counter_total("breaker.opens") >= 1


def test_breaker_keys_are_per_node_not_per_label(monkeypatch):
    monkeypatch.setenv(guard.ENV_BREAKER_THRESHOLD, "1")
    bad, good = _Broken(), _Broken()
    with pytest.raises(OSError):
        _run(bad, node_retries=0)
    with pytest.raises(OSError):  # a real attempt, not a refusal
        _run(good, node_retries=0)
    assert good.calls == 1


def test_breaker_opening_mid_retry_loop_stops_remaining_retries(monkeypatch):
    monkeypatch.setenv(guard.ENV_BREAKER_THRESHOLD, "1")
    t = _Broken()
    with pytest.raises(OSError, match="broken stage"):
        _run(t, node_retries=5)
    assert t.calls == 1


def test_breakers_disabled_by_default_no_registry_entries():
    _run(_AddOne())
    assert not guard._BREAKERS


# ------------------------------------------------- fit/apply deadline API


def test_fit_deadline_bitmatches_undeadlined_fit(monkeypatch):
    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator

    rng = np.random.default_rng(7)
    x, y = _cpu(rng.normal(size=(64, 16))), _cpu(rng.normal(size=(64, 2)))
    est = BlockLeastSquaresEstimator(block_size=8, num_iter=2, lam=1e-3)
    ref = est.with_data(x, y).fit()(x).get().numpy()
    got = est.with_data(x, y).fit(deadline=300.0)(x).get(deadline=300.0).numpy()
    np.testing.assert_array_equal(ref, got)
    monkeypatch.setenv(guard.ENV_STAGE_DEADLINE, "300")
    np.testing.assert_array_equal(ref, est.with_data(x, y).fit()(x).get().numpy())


def test_fit_deadline_below_the_fit_time_raises_in_bounded_time():
    class Slow(Transformer):
        def apply_dataset(self, ds):
            time.sleep(1.0)
            return ds

    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator

    x = _cpu(np.ones((8, 4)))
    pipe = Pipeline.of(Slow()).and_then(BlockLeastSquaresEstimator(block_size=2), x, _cpu(np.ones((8, 1))))
    t0 = time.perf_counter()
    with pytest.raises(guard.DeadlineExceeded):
        pipe.fit(deadline=0.2)
    assert time.perf_counter() - t0 < 0.6


def test_blown_pipeline_budget_fails_in_bounded_time():
    lazy = Pipeline.of(_AddOne())(_cpu(np.ones((4, 2))))
    ex = GraphExecutor(lazy.graph, node_retries=3, deadline=guard.Deadline.after(-1.0))
    before = metrics.REGISTRY.counter_value("executor.stage_retries")
    t0 = time.perf_counter()
    with pytest.raises(guard.DeadlineExceeded):
        ex.execute(lazy.graph.sinks[0])
    assert time.perf_counter() - t0 < 1.0
    assert metrics.REGISTRY.counter_value("executor.stage_retries") == before


def test_cancelled_attempt_never_starts_its_body(monkeypatch):
    """A stage whose watchdog gave up while its fault point stalled does
    not run its body afterwards: its result could only be dropped."""
    monkeypatch.setenv(guard.ENV_STAGE_DEADLINE, "0.2")
    monkeypatch.setenv(guard.ENV_HANG_SECONDS, "0.5")
    ran = []

    class Body(Transformer):
        def apply_dataset(self, ds):
            ran.append(threading.current_thread().name)
            return ds

    with faults.inject("executor.stage:after=1:times=1:hang"):
        out = _run(Body(), node_retries=1)
    time.sleep(0.4)  # the stalled attempt's cancel has long been set
    assert out.dataset.n == 4 and len(ran) == 1


def test_stage_span_parenting_survives_watchdog_thread(monkeypatch, tmp_path):
    monkeypatch.setenv(guard.ENV_STAGE_DEADLINE, "60")

    class Emitting(Transformer):
        def apply_dataset(self, ds):
            ledger.event("inner.probe")
            return ds

    led = ledger.start_run(str(tmp_path))
    _run(Emitting(), node_retries=0)
    ledger.stop_run()
    evs = _events(led.path)
    probe = [e for e in evs if e.get("name") == "inner.probe"]
    stages = {e["span"]: e["attrs"]["node"] for e in evs
              if e.get("kind") == "span_start" and e.get("name") == "executor.stage"}
    assert probe and stages[probe[0]["parent"]] == "Emitting"


# ------------------------------------------------ stream fetch timeouts


class _HangSource:
    """Batch-resumable source whose ``bad`` batch hangs (cancel-aware)."""

    def __init__(self, n, bad, hang_for=30.0):
        self.n, self.bad, self.hang_for = n, bad, hang_for
        self.hangs = 0

    def __call__(self):
        outer = self

        class It:
            def __init__(self):
                self.i = 0

            def __iter__(self):
                return self

            def __next__(self):
                if self.i >= outer.n:
                    raise StopIteration
                i = self.i
                self.i += 1
                if i == outer.bad:
                    outer.hangs += 1
                    guard.interruptible_sleep(outer.hang_for)
                return np.full((4, 2), i, np.float32)

        return It()


def test_resilient_timeout_retries_then_drops_hung_batch():
    src = _HangSource(5, bad=2)
    out = list(resilient(src, retries=1, max_bad_batches=1, base_delay=0.0, timeout=0.2)())
    assert [int(b[0, 0]) for b in out] == [0, 1, 3, 4]
    assert src.hangs == 2


def test_resilient_timeout_zero_quota_propagates():
    with pytest.raises(guard.DeadlineExceeded):
        list(resilient(_HangSource(5, bad=1), retries=1, base_delay=0.0, timeout=0.2)())


def test_stream_dataset_timeout_plumbs_through():
    ds = StreamDataset(_HangSource(4, bad=1), n=16, retries=1, max_bad_batches=1, timeout=0.2, device="cpu")
    assert sum(b.shape[0] for b, _m in ds.device_batches()) == 12


def test_resilient_timeout_generator_source_transient_hang():
    hangs = {"n": 0}

    def source():
        def it():
            for i in range(5):
                if i == 2 and hangs["n"] < 1:
                    hangs["n"] += 1
                    guard.interruptible_sleep(30.0)
                yield np.full((4, 2), i, np.float32)

        return it()

    out = list(resilient(source, retries=2, base_delay=0.0, timeout=0.2)())
    assert [int(b[0, 0]) for b in out] == [0, 1, 2, 3, 4] and hangs["n"] == 1


def test_resilient_timeout_permanent_hang_fails_bounded():
    def source():
        def it():
            for i in range(5):
                if i == 2:
                    time.sleep(3.0)
                yield np.full((4, 2), i, np.float32)

        return it()

    t0 = time.perf_counter()
    with pytest.raises(guard.DeadlineExceeded):
        list(resilient(source, retries=1, max_bad_batches=1, base_delay=0.0, timeout=0.2)())
    assert time.perf_counter() - t0 < 10.0


def test_resilient_no_timeout_stays_same_thread():
    threads = []

    def source():
        def it():
            threads.append(threading.current_thread())
            yield np.zeros((1, 1), np.float32)

        return it()

    list(resilient(source, retries=0)())
    assert threads == [threading.current_thread()]


# --------------------------------------------------- latency fault plans


def test_delay_action_stalls_then_proceeds():
    t0 = time.perf_counter()
    with faults.inject("stream.batch:times=1:delay=0.15"):
        faults.fault_point("stream.batch")
        faults.fault_point("stream.batch")
    assert 0.15 <= time.perf_counter() - t0 < 2.0


def test_latency_actions_valid_at_every_site():
    for site in sorted(faults.SITES):
        assert {s.action for s in faults.parse_plan(f"{site}:delay=0.01;{site}:hang").specs} == {"delay", "hang"}
    with pytest.raises(faults.FaultPlanError, match="delay needs seconds"):
        faults.parse_plan("stream.batch:delay")


def test_chaos_hang_at_executor_stage_survives_deadline_plus_retry(monkeypatch, tmp_path):
    monkeypatch.setenv(guard.ENV_STAGE_DEADLINE, "0.3")
    led = ledger.start_run(str(tmp_path))
    with faults.inject("executor.stage:times=1:hang"):
        out = _run(_AddOne(), node_retries=1)
    ledger.stop_run()
    np.testing.assert_allclose(out.dataset.array.numpy(), 2.0)
    names = {e.get("name") for e in _events(led.path)}
    assert {"deadline_exceeded", "executor.retry"} <= names


def test_chaos_delay_at_stream_batch_survives_timeout(monkeypatch):
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    monkeypatch.setenv(faults.ENV_VAR, "stream.batch:after=1:times=1:delay=5")
    ds = StreamDataset(batched(x, 8), n=16, retries=2, timeout=0.3, device="cpu")
    np.testing.assert_array_equal(np.concatenate([b.numpy() for b, _m in ds.device_batches()]), x)


def _acceptance(pkg, tmp_path, monkeypatch):
    """The reference's acceptance scenario in either package: a hang at
    executor.stage (twice: the optional stage's breaker opens and it
    degrades) and a delay at stream.batch, under a stage deadline."""
    if pkg == "port":
        F, L, G, S, SD, Ex, P, T = (faults, ledger, guard, batched, StreamDataset, GraphExecutor, Pipeline,
                                    _AddOne)

        def ds(a):
            return _cpu(a)

        def sd(x):
            return SD(S(x, 8), n=16, retries=2, timeout=2.0, device="cpu")
    else:
        from keystone_tpu import faults as F
        from keystone_tpu.loaders.stream import batched as S
        from keystone_tpu.obs import ledger as L
        from keystone_tpu.utils import guard as G
        from keystone_tpu.workflow import Dataset as RD
        from keystone_tpu.workflow import GraphExecutor as Ex
        from keystone_tpu.workflow import Pipeline as P
        from keystone_tpu.workflow import Transformer as RT
        from keystone_tpu.workflow.dataset import StreamDataset as SD

        class T(RT):
            def params(self):
                return ()

            def apply_dataset(self, d):
                return d.with_array(d.array + 1.0)

        def ds(a):
            return RD(np.asarray(a, np.float32))

        def sd(x):
            return SD(S(x, 8), n=16, retries=2, timeout=2.0)
    G.reset_breakers()
    monkeypatch.setenv(G.ENV_STAGE_DEADLINE, "0.3")
    monkeypatch.setenv(G.ENV_BREAKER_THRESHOLD, "2")
    x = np.ones((16, 4), np.float32)
    led = L.start_run(str(tmp_path / pkg))
    try:
        with F.inject("executor.stage:after=1:times=2:hang;stream.batch:times=1:delay=0.05"):
            rows = np.concatenate([np.asarray(b) for b, _m in sd(x).device_batches()])
            t = T()
            t.optional = True
            lazy = P.of(t)(ds(np.full((4, 2), 5.0)))
            out = Ex(lazy.graph, node_retries=1).execute(lazy.graph.sinks[0])
    finally:
        L.stop_run()
        G.reset_breakers()
    np.testing.assert_array_equal(rows, x)
    np.testing.assert_allclose(np.asarray(out.dataset.array), 5.0)
    evs = _events(led.path)
    return (sorted({e["name"] for e in evs if e["kind"] == "event"}),
            [(e["attrs"]["from_state"], e["attrs"]["to_state"]) for e in evs if e["name"] == "breaker.transition"],
            [e["attrs"]["reason"] for e in evs if e["name"] == "degraded"])


def test_acceptance_hang_and_delay_match_the_reference(monkeypatch, tmp_path):
    got = _acceptance("port", tmp_path, monkeypatch)
    assert {"deadline_exceeded", "breaker.transition", "degraded"} <= set(got[0])
    assert got == _acceptance("reference", tmp_path, monkeypatch)
