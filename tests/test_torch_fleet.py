"""The port's threaded replica fleet (keystone_tpu_torch/serve/fleet.py)
and its self-healing, the counterparts of the reference's
tests/test_fleet.py and tests/test_selfheal.py (their registry and
watcher tests are ROADMAP A11b's): routing, breaker failover and
fail-fast, the serve.replica/serve.worker/serve.swap sites, blue/green
swap under load, poison bisection, wedged and dead workers restarted,
quarantine, hedging, scaling, and the seeded soak with the reference's
own plan generator.  On the CPU every replica is a copy on ``cpu``.

Every wait is bounded: a hang fails in seconds."""

import math
import random
import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch import faults
from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.ops.stats import NormalizeRows
from keystone_tpu_torch.serve import FleetUnavailable, Overloaded, PoisonRequest, serve, serve_http
from keystone_tpu_torch.serve.fleet import ReplicaPool, _clone_and_place, _place_on_device
from keystone_tpu_torch.utils import guard
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import FrozenApplier, Pipeline
from keystone_tpu_torch.workflow.transformer import Transformer

pytestmark = pytest.mark.serve

DIM = 6
MARK = 123.0
WAIT = 30


class PoisonGate(Transformer):
    """Raises when a row's first element is the marker: a deterministic,
    content-attributable failure for bisection to isolate."""

    def params(self):
        return ()

    def apply_batch(self, xs, mask=None):
        if bool((xs[:, 0] == MARK).any()):
            raise ValueError("poison marker row")
        return xs


def _pipeline(scale: float = 2.0, poison_gate: bool = False) -> Pipeline:
    head = Pipeline.of(PoisonGate()) | NormalizeRows() if poison_gate else Pipeline.of(NormalizeRows())
    return head | LinearMapper(torch.eye(DIM) * scale)


def _service(replicas: int, name: str, pipe=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("queue_bound", 256)
    kw.setdefault("example", np.zeros(DIM, np.float32))
    return serve(_pipeline() if pipe is None else pipe, replicas=replicas, devices=["cpu"], name=name, **kw)


def _rows(k: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(k, DIM)).astype(np.float32)


def _poison_row() -> np.ndarray:
    row = np.ones(DIM, np.float32)
    row[0] = MARK
    return row


def _row_scales(rows) -> np.ndarray:
    """The model-version fingerprint: per-row output norms."""
    return np.linalg.norm(np.asarray(rows), axis=-1)


def _ref(x, scale=2.0):
    return _pipeline(scale)(Dataset(x, device="cpu")).get().numpy()


def _counter(name: str) -> float:
    return metrics.REGISTRY.counter_total(name)


# ------------------------------------------------------------- placement
def test_clone_places_one_copy_per_alias():
    """Replicas share no fitted tensor, and a tensor reached from two
    sites gets one placed copy at both."""
    w = torch.eye(DIM)
    shared = LinearMapper(w)
    pipe = Pipeline.of(shared) | NormalizeRows()
    clone = _clone_and_place(pipe, torch.device("cpu"))
    mapper = next(op.transformer for op in clone.graph.operators.values()
                  if isinstance(getattr(op, "transformer", None), LinearMapper))
    assert mapper is not shared and mapper.weights.data_ptr() != w.data_ptr()

    class Holder:
        pass

    h = Holder()
    h.a = h.b = torch.ones(3)
    h.pair = (h.a, [h.a])
    _place_on_device(h, torch.device("cpu"))
    assert h.a is h.b and h.pair[0] is h.a and h.pair[1][0] is h.a
    with pytest.raises(ValueError, match="frozen for cpu"):
        _clone_and_place(FrozenApplier(pipe, device="cpu"), torch.device("cuda"))


# ------------------------------------------------------------- routing
def test_pool_routes_across_all_replicas():
    x = _rows(64, seed=1)
    ref = _ref(x)
    with _service(4, "fleet_route", max_wait_ms=1.0, queue_bound=1024) as svc:
        assert svc.replicas == 4
        futs = []
        for _ in range(8):
            futs.extend(svc.submit_many(x))
        got = np.stack([f.result(timeout=60) for f in futs])
        np.testing.assert_allclose(got, np.tile(ref, (8, 1)), rtol=1e-5, atol=1e-6)
        statuses = svc.replica_statuses()
        appliers = {id(r.applier) for r in svc._pool.replicas}
    assert len(appliers) == 4
    assert all(s["device"] == "cpu" for s in statuses)
    assert all(s["flushes"] > 0 for s in statuses), statuses


def test_single_replica_is_direct_wrap():
    applier = FrozenApplier(_pipeline(), device="cpu")
    svc = serve(applier, max_batch=8, example=np.zeros(DIM, np.float32), name="fleet_single")
    try:
        rep = svc._pool.replicas[0]
        assert rep.applier is applier  # the very object, not a copy
        assert rep.device == torch.device("cpu") and rep.stream is None
    finally:
        svc.close(timeout=WAIT)


def test_router_failover_when_breaker_opens():
    x = _rows(8, seed=2)
    ref = _ref(x)
    with _service(3, "fleet_failover", max_wait_ms=1.0) as svc:
        sick = svc._pool.replicas[0]
        while sick.breaker.state() != "open":
            sick.breaker.record_failure()
        for _ in range(6):
            got = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(x)])
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        statuses = svc.replica_statuses()
    assert statuses[0]["flushes"] == 0, statuses
    assert sum(s["flushes"] for s in statuses[1:]) >= 6


def test_all_breakers_open_fails_fast_then_probe_readmits():
    x = _rows(4, seed=3)
    ref = _ref(x)
    with _service(2, "fleet_failfast", max_wait_ms=1.0) as svc:
        for rep in svc._pool.replicas:
            rep.breaker = guard.CircuitBreaker(f"fleet_failfast.replica.{rep.index}", reset_timeout=0.3)
            while rep.breaker.state() != "open":
                rep.breaker.record_failure()
        errs = [f.exception(timeout=WAIT) for f in svc.submit_many(x)]
        assert all(isinstance(e, FleetUnavailable) for e in errs), errs
        assert svc.available is False
        assert svc.status()["available"] is False
        with pytest.raises(FleetUnavailable):
            svc.submit_many(x)
        time.sleep(0.4)
        deadline = time.monotonic() + WAIT
        got = None
        while got is None and time.monotonic() < deadline:
            try:
                got = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(x)])
            except FleetUnavailable:
                time.sleep(0.1)
        assert got is not None, "probe never re-admitted traffic"
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        assert svc.available is True


def test_replica_chaos_one_flush_fails_service_survives():
    x = _rows(4, seed=4)
    ref = _ref(x)
    with _service(2, "fleet_chaos", max_wait_ms=1.0) as svc:
        with faults.inject("serve.replica:raise:times=1"):
            errs = [f.exception(timeout=WAIT) for f in svc.submit_many(x)]
        assert all(isinstance(e, faults.FaultInjected) for e in errs)
        got = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(x)])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        statuses = svc.replica_statuses()
    assert sum(s["errors"] for s in statuses) == 1, statuses


def test_unported_backends_name_their_roadmap_item():
    """The process and network backends are ported (tests/test_torch_procfleet.py,
    tests/test_torch_netfleet*.py): they place the model in their workers,
    so ``devices=`` is refused with them, and an unknown backend is refused."""
    for backend in ("process", "net"):
        with pytest.raises(ValueError, match="devices= applies to the thread backend only"):
            ReplicaPool(_pipeline(), devices=["cpu"], backend=backend)
    with pytest.raises(ValueError, match="backend must be"):
        ReplicaPool(_pipeline(), devices=["cpu"], backend="fork")


def test_pool_artifacts_move_with_the_generation():
    """The pool's bundle (``artifacts=``): each replica built for a
    generation tries it (refused on the CPU, counted), a staged generation
    carries its own into the commit, and an abandoned one leaves the live
    bundle in place; the dispatch window retunes live."""
    bundle = {"manifest": {"format": 1}, "blobs": {}}
    f0 = metrics.REGISTRY.counter_total("serve.artifact_fallbacks")
    pool = ReplicaPool(_pipeline(), replicas=2, devices=["cpu", "cpu"], artifacts=bundle)
    assert pool.has_artifacts and metrics.REGISTRY.counter_total("serve.artifact_fallbacks") == f0 + 2
    staged = pool.stage(_pipeline(), "v2", artifacts=None)
    assert pool.abandon_staged(staged) == [] and pool.has_artifacts
    staged = pool.stage(_pipeline(), "v3", artifacts=None)
    pool.commit(staged, "v3")
    assert not pool.has_artifacts and pool.version == "v3"
    assert pool.set_window(5) == 5 and pool.window == 5 and pool.set_window(0) == 1
    pool.close(timeout=WAIT)


# ------------------------------------------------------------ hot-swap
class _LoadGen:
    """Background generator: submits rows continuously, keeps every future."""

    def __init__(self, svc, item):
        self.svc, self.item, self.futs = svc, item, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                self.futs.append(self.svc.submit(self.item))
            except Overloaded:
                time.sleep(0.002)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def stop(self):
        self._stop.set()
        self._thread.join(10.0)
        assert not self._thread.is_alive()

    def outcomes(self, timeout=60.0):
        scales, excs = [], []
        for f in self.futs:
            e = f.exception(timeout=timeout)
            if e is not None:
                excs.append(e)
            else:
                scales.append(float(_row_scales(f.result())))
        return np.asarray(scales), excs


def test_swap_under_load_drops_nothing():
    item = _rows(1, seed=5)[0]
    with _service(3, "fleet_swap", max_wait_ms=2.0) as svc:
        with _LoadGen(svc, item) as gen:
            time.sleep(0.25)
            info = svc.swap(_pipeline(3.0), version="green")
            time.sleep(0.25)
            gen.stop()
            scales, excs = gen.outcomes()
        assert not excs, excs[:3]
        assert len(scales) > 50
        blue, green = np.isclose(scales, 2.0, rtol=1e-4), np.isclose(scales, 3.0, rtol=1e-4)
        assert np.all(blue | green)
        assert green.any(), "no request ever saw the new version"
        np.testing.assert_allclose(_row_scales(svc.submit(item).result(timeout=WAIT)), 3.0, rtol=1e-5)
        assert svc.version == "green" and info["replicas"] == 3
        assert info["pause_seconds"] < svc.max_wait_s + 0.05
        assert all(s["version"] == "green" for s in svc.replica_statuses())
        assert svc.rollout_status()["prior_versions"] == ["v0"]


def test_swap_fault_leaves_old_generation_serving():
    item = _rows(1, seed=6)[0]
    with _service(2, "fleet_swapfault", max_wait_ms=1.0) as svc:
        with faults.inject("serve.swap:raise"):
            with pytest.raises(faults.FaultInjected):
                svc.swap(_pipeline(3.0), version="doomed")
        assert svc.version == "v0"
        np.testing.assert_allclose(_row_scales(svc.submit(item).result(timeout=WAIT)), 2.0, rtol=1e-5)


def test_retry_after_hint_tracks_ewma_and_fleet_size():
    with _service(2, "fleet_hint") as svc:
        svc._ewma_batch_s = 0.0
        assert svc.retry_after_hint() == 1.0
        svc._ewma_batch_s = 2.0
        assert svc.retry_after_hint() == pytest.approx(1.0)


def test_scale_to_grows_and_shrinks_without_loss():
    x = _rows(16, seed=11)
    ref = _ref(x)
    with _service(1, "fleet_scale", max_wait_ms=1.0) as svc:
        assert svc.scale_to(3) == 3
        got = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(x)])
        assert svc.scale_to(1) == 1
        again = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(x)])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(again, ref, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ bisection
def test_bisection_isolates_poison_innocents_complete():
    svc = _service(1, "selfheal_bisect", _pipeline(poison_gate=True), max_wait_ms=40.0, supervise=False)
    try:
        x = _rows(7, seed=1)
        b0 = _counter("serve.bisections")
        futs = svc.submit_many(list(x) + [_poison_row()])
        excs = [f.exception(timeout=60) for f in futs]
        assert excs[:7] == [None] * 7, excs
        assert isinstance(excs[7], PoisonRequest), excs[7]
        for f in futs[:7]:
            assert np.linalg.norm(np.asarray(f.result())) == pytest.approx(2.0, rel=1e-4)
        assert _counter("serve.bisections") == b0 + 1
        pb0 = _counter("serve.poison_blocked")
        with pytest.raises(PoisonRequest):
            svc.submit(_poison_row())
        assert _counter("serve.poison_blocked") == pb0 + 1
    finally:
        svc.close(timeout=WAIT)


def test_bisection_infra_errors_are_not_bisected():
    """An infrastructure failure (an injected fault; a kernel that failed
    to build or launch) fails the whole flush, and nothing is bisected."""
    from keystone_tpu_torch.kernels.build import KernelError

    class Broken(Transformer):
        def apply_batch(self, xs, mask=None):
            raise KernelError("fused_forward kernel launch failed (1): an injected launch failure")

    svc = _service(1, "selfheal_infra", _pipeline(poison_gate=True), max_batch=4, max_wait_ms=20.0,
                   supervise=False)
    try:
        b0 = _counter("serve.bisections")
        with faults.inject("serve.batch:raise:times=1"):
            errs = [f.exception(timeout=WAIT) for f in svc.submit_many(_rows(4, seed=2))]
        assert all(isinstance(e, faults.FaultInjected) for e in errs), errs
        assert _counter("serve.bisections") == b0
    finally:
        svc.close(timeout=WAIT)
    with _service(1, "selfheal_kernel", Pipeline.of(Broken()), max_batch=4, max_wait_ms=5.0, example=None,
                  supervise=False) as svc:
        err0 = _counter("serve.batch_errors")
        errs = [f.exception(timeout=WAIT) for f in svc.submit_many(_rows(4, seed=3))]
        assert all(isinstance(e, KernelError) for e in errs), errs
        assert _counter("serve.bisections") == b0
        assert _counter("serve.batch_errors") == err0 + 1


# ----------------------------------------------------------- supervisor
def test_acceptance_crash_plus_poison_chaos():
    """A seeded plan crashes one replica worker mid-load while a poison
    request rides a full batch: the supervisor restarts the crashed
    replica, bisection isolates the poison within ⌈log2(max_batch)⌉
    levels, every innocent completes, and no future is lost."""
    max_batch = 8
    svc = _service(2, "selfheal_accept", _pipeline(poison_gate=True), max_batch=max_batch, max_wait_ms=30.0,
                   queue_bound=512, supervise_interval_s=0.1)
    try:
        r0 = _counter("serve.replica_restarts")
        futs = []
        with faults.inject("serve.worker:raise:after=2:times=1"):
            for wave in range(3):
                batch = list(_rows(max_batch - 1, seed=wave))
                if wave == 1:
                    batch.append(_poison_row())
                futs.extend(svc.submit_many(batch))
                time.sleep(0.05)
            excs = [f.exception(timeout=120) for f in futs]
        assert all(f.done() for f in futs)
        poisons = [e for e in excs if isinstance(e, PoisonRequest)]
        others = [e for e in excs if e is not None and not isinstance(e, PoisonRequest)]
        assert len(poisons) == 1, excs
        assert others == [], others
        assert _counter("serve.replica_restarts") >= r0 + 1
        status = svc.status()
        assert status["supervisor"]["restarts"] >= 1
        assert status["supervisor"]["last_restart"]["reason"] == "dead"
        assert any(s["restarts"] > 0 for s in status["replicas"])
        deadline = time.monotonic() + 10.0
        restarts = bisects = []
        while (not restarts or not bisects) and time.monotonic() < deadline:
            ops = svc.recorder.ops_spans(limit=50)
            restarts = [o for o in ops if o["name"] == "replica.restart"]
            bisects = [o for o in ops if o["name"] == "serve.bisect"]
            if not restarts or not bisects:
                time.sleep(0.05)
        assert restarts and restarts[0]["reason"] == "dead"
        assert bisects and bisects[0]["depth"] <= math.ceil(math.log2(max_batch))
    finally:
        svc.close(timeout=WAIT)


def test_wedged_worker_restarted_queued_work_survives():
    svc = _service(1, "selfheal_wedge", max_batch=2, max_wait_ms=2.0, queue_bound=64, heartbeat_s=0.3,
                   supervise_interval_s=0.1)
    try:
        x = _rows(2, seed=5)
        # the wedge outlasts the heartbeat budget and the heal (a re-clone
        # and prime, which a loaded box can stretch past half a second)
        with faults.inject("serve.worker:delay=3.0:times=1"):
            stuck = svc.submit_many(x)
            time.sleep(0.1)
            queued = svc.submit_many(x)
            errs = [f.exception(timeout=WAIT) for f in stuck]
            assert all(isinstance(e, FleetUnavailable) for e in errs), errs
            got = [f.result(timeout=WAIT) for f in queued]
        assert len(got) == 2
        st = svc.status()
        assert st["supervisor"]["restarts"] >= 1
        assert st["supervisor"]["last_restart"]["reason"] == "wedged"
    finally:
        svc.close(timeout=WAIT)


def test_quarantine_after_restart_budget_and_swap_readmits():
    import json
    from urllib.error import HTTPError
    from urllib.request import urlopen

    svc = _service(1, "selfheal_quar", max_batch=4, max_wait_ms=2.0, queue_bound=64, restart_limit=1,
                   restart_window_s=60.0, supervise_interval_s=0.1)
    front = serve_http(svc, port=0)
    try:
        url = f"http://127.0.0.1:{front.port}"
        x = _rows(2, seed=6)
        q0 = _counter("serve.replica_restarts")
        with faults.inject("serve.worker:raise:times=2"):
            deadline = time.monotonic() + WAIT
            while time.monotonic() < deadline:
                try:
                    for f in svc.submit_many(x):
                        f.exception(timeout=15)
                except (FleetUnavailable, Overloaded):
                    pass  # refusals while crashing/healing are expected
                if svc._pool.replicas[0].quarantined:
                    break
                time.sleep(0.05)
        assert svc._pool.replicas[0].quarantined, svc.replica_statuses()
        assert _counter("serve.replica_restarts") >= q0 + 1
        assert metrics.REGISTRY.gauge_value("serve.quarantined", replica=0) == 1.0
        assert any(o["name"] == "replica.quarantine" for o in svc.recorder.ops_spans(limit=50))
        assert svc.available is False
        with pytest.raises(FleetUnavailable):
            svc.submit_many(x)
        with pytest.raises(HTTPError) as ei:
            urlopen(url + "/healthz", timeout=WAIT)
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") is not None
        assert json.loads(ei.value.read())["status"] == "unavailable"
        svc.swap(_pipeline(3.0), version="healed")
        assert svc.available is True
        got = [f.result(timeout=WAIT) for f in svc.submit_many(x)]
        assert np.linalg.norm(np.asarray(got[0])) == pytest.approx(3.0, rel=1e-4)
        assert json.loads(urlopen(url + "/healthz", timeout=WAIT).read())["status"] == "ok"
    finally:
        front.stop()
        svc.close(timeout=WAIT)


# -------------------------------------------------------------- hedging
def test_hedge_rescues_straggler_single_resolution():
    svc = _service(2, "selfheal_hedge", max_batch=4, max_wait_ms=2.0, queue_bound=256, hedge_ms=20.0,
                   supervise=False)
    try:
        h0, c0 = _counter("serve.hedges"), _counter("serve.hedge_cancelled")
        x = _rows(4, seed=7)
        with faults.inject("serve.worker:ctx.replica=0:delay=0.3"):
            futs = []
            t0 = time.monotonic()
            while time.monotonic() - t0 < 0.6:
                futs.extend(svc.submit_many(x))
                time.sleep(0.01)
            got = [f.result(timeout=60) for f in futs]
        assert len(got) == len(futs)
        assert _counter("serve.hedges") > h0
        deadline = time.monotonic() + 15.0
        while _counter("serve.hedge_cancelled") <= c0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _counter("serve.hedge_cancelled") > c0
        losers = [o for o in svc.recorder.ops_spans(limit=100)
                  if o["name"] == "serve.hedge" and o.get("outcome") == "cancelled"]
        assert losers, svc.recorder.ops_spans(limit=20)
        statuses = svc.replica_statuses()
        assert sum(s["errors"] for s in statuses) == 0, statuses
        assert all(s["breaker"] == "closed" for s in statuses), statuses
    finally:
        svc.close(timeout=WAIT)


def test_hedging_disabled_by_default():
    before = {t.name for t in threading.enumerate()}
    svc = _service(2, "selfheal_nohedge", max_batch=4, max_wait_ms=2.0, supervise=False)
    try:
        assert svc._hedge is None
        assert not any("selfheal_nohedge-hedge" in t.name for t in threading.enumerate())
        h0 = _counter("serve.hedges")
        x = _rows(4, seed=8)
        ref = None
        for _ in range(4):
            got = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(x)])
            ref = got if ref is None else ref
            np.testing.assert_array_equal(got, ref)
        assert _counter("serve.hedges") == h0
    finally:
        svc.close(timeout=WAIT)
    leaked = {t.name for t in threading.enumerate() if "hedge" in t.name and t.name not in before}
    assert not leaked, leaked


# ----------------------------------------------------------------- soak
@pytest.mark.soak
@pytest.mark.chaos
def test_soak_short_deterministic():
    """The reference's seeded plan generator (tools/chaos.py) driven at
    the port's fleet: randomized multi-site serve.* plans against a live
    2-replica fleet, no hung or lost future, and a clean wave served
    after the soak."""
    from tools.chaos import _soak_plan

    rng = random.Random(0)
    wave = 16
    svc = serve(_pipeline(), replicas=2, devices=["cpu"], name="soak", max_batch=8, max_wait_ms=2.0,
                queue_bound=256, example=np.zeros(DIM, np.float32), supervise_interval_s=0.1, heartbeat_s=5.0,
                restart_limit=10_000, hedge_ms=25.0)
    payload = _rows(wave, seed=0)
    hung = iterations = 0
    try:
        end = time.monotonic() + 1.2
        while time.monotonic() < end:
            iterations += 1
            futs = []
            with faults.inject(_soak_plan(rng)):
                for i in range(wave):
                    try:
                        futs.append(svc.submit(payload[i]))
                    except Exception:
                        pass  # a typed refusal is an outcome
                for f in futs:
                    try:
                        f.result(timeout=WAIT)
                    except TimeoutError:
                        hung += 1
                    except Exception:
                        pass  # a typed failure is an outcome
        clean = 0
        deadline = time.monotonic() + WAIT
        while clean < wave and time.monotonic() < deadline:
            try:
                clean = sum(1 for f in [svc.submit(p) for p in payload] if f.exception(timeout=WAIT) is None)
            except Exception:
                clean = 0
            if clean < wave:
                time.sleep(0.2)
    finally:
        svc.close(timeout=WAIT)
    assert iterations >= 1
    assert hung == 0
    assert clean == wave
