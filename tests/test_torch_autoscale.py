"""The port's autoscaler (keystone_tpu_torch/serve/autoscale.py) against
the JAX package's (keystone_tpu/serve/autoscale.py): the pure policy's
decisions and dispatch-window retunes over the reference's scenarios
(tests/test_autoscale.py) and over a seeded random sequence of 1000
signal samples, the controller's actions under an injected clock and
signal source, its status, and what it refuses; then the port's
autoscaler driving a live service on the CPU (grow under a deep queue,
each new replica primed, shrink when idle, no future lost).

Tolerances: none; every comparison is of decisions, exactly."""

import time

import numpy as np
import pytest
import torch

from keystone_tpu.serve import autoscale as ref_autoscale
from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.ops.stats import NormalizeRows
from keystone_tpu_torch.serve import autoscale, serve
from keystone_tpu_torch.serve.autoscale import AutoscalePolicy, Autoscaler
from keystone_tpu_torch.workflow.pipeline import Pipeline
from keystone_tpu_torch.workflow.transformer import Transformer

pytestmark = pytest.mark.serve

DIM = 6
WAIT = 30.0


def sig(mod=autoscale, workers=1, queue_depth=0, queue_bound=100, occupancy=0.0, burn_rate=None, pool_hit_rate=None):
    return mod.Signals(workers=workers, queue_depth=queue_depth, queue_bound=queue_bound, occupancy=occupancy,
                       burn_rate=burn_rate, pool_hit_rate=pool_hit_rate)


# (policy kwargs, signals kwargs, idle_ticks, since_up, since_any): the
# reference's scenarios
_DECISIONS = [
    ({}, dict(queue_depth=60), 0, 1e9, 1e9),
    ({}, dict(burn_rate=2.0), 0, 1e9, 1e9),
    ({}, dict(occupancy=0.95), 0, 1e9, 1e9),
    (dict(max_workers=2, up_cooldown_s=5.0), dict(workers=2, queue_depth=90), 0, 1e9, 1e9),
    (dict(max_workers=2, up_cooldown_s=5.0), dict(workers=1, queue_depth=90), 0, 1.0, 1e9),
    (dict(max_workers=2, up_cooldown_s=5.0), dict(workers=1, queue_depth=90), 0, 6.0, 1e9),
    (dict(up_occupancy=0.85, pool_occupancy_credit=0.10), dict(occupancy=0.90), 0, 1e9, 1e9),
    (dict(up_occupancy=0.85, pool_occupancy_credit=0.10), dict(occupancy=0.90, pool_hit_rate=0.9), 0, 1e9, 1e9),
    (dict(down_ticks=3, down_cooldown_s=10.0), dict(workers=3, occupancy=0.05, burn_rate=0.0), 0, 1e9, 1e9),
    (dict(down_ticks=3, down_cooldown_s=10.0), dict(workers=3, occupancy=0.05, burn_rate=0.0), 2, 1e9, 5.0),
    (dict(down_ticks=3, down_cooldown_s=10.0), dict(workers=3, occupancy=0.05, burn_rate=0.0), 2, 1e9, 20.0),
    (dict(down_ticks=3, down_cooldown_s=10.0), dict(workers=1, occupancy=0.05, burn_rate=0.0), 10, 1e9, 1e9),
]
_WANT = ["up", "up", "up", None, None, "up", "up", None, None, None, "down", None]


@pytest.mark.parametrize("case", range(len(_DECISIONS)))
def test_policy_decisions_equal_the_reference(case):
    pkw, skw, idle, since_up, since_any = _DECISIONS[case]
    got = AutoscalePolicy(**{"min_workers": 1, "max_workers": 4, **pkw}).decide(sig(**skw), idle, since_up, since_any)
    ref = ref_autoscale.AutoscalePolicy(**{"min_workers": 1, "max_workers": 4, **pkw}).decide(
        sig(ref_autoscale, **skw), idle, since_up, since_any)
    assert got == ref == _WANT[case]


@pytest.mark.parametrize("skw,current,want", [
    (dict(workers=2, queue_depth=90), 2, 3), (dict(workers=2, queue_depth=90), 4, None),
    (dict(workers=2, occupancy=0.05), 4, 3), (dict(workers=2, occupancy=0.05), 2, None),
    (dict(workers=1, queue_depth=90), 2, None),
])
def test_window_retune_equals_the_reference(skw, current, want):
    kw = dict(min_workers=1, max_workers=2, window_min=2, window_max=4)
    assert AutoscalePolicy(**kw).window_for(sig(**skw), current) == want
    assert ref_autoscale.AutoscalePolicy(**kw).window_for(sig(ref_autoscale, **skw), current) == want
    assert AutoscalePolicy(window_min=None).window_for(sig(**skw), current) is None


def _random_signals(rng, n):
    for _ in range(n):
        yield dict(
            workers=int(rng.integers(1, 6)),
            queue_depth=int(rng.choice([0, 0, 0, int(rng.integers(0, 120))])),
            queue_bound=int(rng.choice([64, 100, 128])),
            occupancy=float(rng.choice([0.0, 0.05, 0.3, 0.85, float(rng.random())])),
            burn_rate=None if rng.random() < 0.3 else float(rng.choice([0.0, 0.5, 1.0, 3.0 * rng.random()])),
            pool_hit_rate=None if rng.random() < 0.5 else float(rng.random()),
        )


def test_policy_over_a_seeded_random_sequence_equals_the_reference():
    """1000 seeded signal samples with random controller state: the same
    action, the same idle verdict and the same window retune, each tick."""
    rng = np.random.default_rng(20)
    kw = dict(min_workers=1, max_workers=4, down_ticks=3, up_cooldown_s=2.0, down_cooldown_s=5.0)
    port, ref = AutoscalePolicy(**kw), ref_autoscale.AutoscalePolicy(**kw)
    actions = set()
    for skw in _random_signals(rng, 1000):
        idle, since_up, since_any = int(rng.integers(0, 6)), float(rng.random() * 10), float(rng.random() * 10)
        current = int(rng.integers(1, 6))
        a = port.decide(sig(**skw), idle, since_up, since_any)
        assert a == ref.decide(sig(ref_autoscale, **skw), idle, since_up, since_any)
        assert port.is_idle(sig(**skw)) == ref.is_idle(sig(ref_autoscale, **skw))
        assert port.window_for(sig(**skw), current) == ref.window_for(sig(ref_autoscale, **skw), current)
        actions.add(a)
    assert actions == {"up", "down", None}


# ------------------------------------------------------------ controller
class FakeService:
    """The surface the Autoscaler touches (the reference's test double)."""

    name = "fake"
    _closing = False
    _obs_ctx = None
    recorder = None

    def __init__(self, workers=1):
        self.workers = workers
        self.scaled_to, self.windows = [], []
        self._pool = self
        self.queue_bound, self.queue_depth = 100, 0

    @property
    def size(self):
        return self.workers

    @property
    def window(self):
        return 2

    def scale_to(self, n):
        self.scaled_to.append(n)
        self.workers = n
        return n

    def set_dispatch_window(self, n):
        self.windows.append(n)
        return n

    def occupancy(self):
        return 0.0

    def slo_burn_rate(self):
        return None


def _drive(mod, seq, **kw):
    """Tick a controller of ``mod`` over ``(clock, signals)`` steps; its
    actions, the fleet sizes it asked for and the windows it set."""
    svc = FakeService(workers=seq[0][1]["workers"])
    box = {"t": 0.0, "s": None}
    scaler = mod.Autoscaler(svc, interval_s=1.0, clock=lambda: box["t"],
                            signal_source=lambda: mod.Signals(**box["s"]), **kw)
    acts = []
    for t, skw in seq:
        box["t"], box["s"] = t, skw
        acts.append(scaler.tick())
    st = scaler.status()
    return acts, svc.scaled_to, svc.windows, {k: st[k] for k in ("ups", "downs", "window_retunes", "idle_ticks")}


def test_controller_over_a_seeded_sequence_equals_the_reference():
    rng = np.random.default_rng(7)
    seq, t = [], 100.0
    for skw in _random_signals(rng, 300):
        t += float(rng.choice([0.1, 1.0, 3.0]))
        seq.append((t, skw))
    kw = dict(min_workers=1, max_workers=4, up_cooldown_s=2.0, down_cooldown_s=3.0, down_ticks=2)
    got = _drive(autoscale, seq, **kw)
    assert got == _drive(ref_autoscale, seq, **kw)
    assert got[3]["ups"] > 0 and got[3]["downs"] > 0


def test_tick_scales_up_then_respects_cooldown():
    svc = FakeService(workers=1)
    state = {"s": sig(workers=1, queue_depth=80)}
    clock = [100.0]
    scaler = Autoscaler(svc, interval_s=1.0, clock=lambda: clock[0], signal_source=lambda: state["s"],
                        min_workers=1, max_workers=3, up_cooldown_s=5.0)
    assert scaler.tick() == "up" and svc.scaled_to == [2]
    state["s"] = sig(workers=2, queue_depth=80)
    clock[0] = 102.0
    assert scaler.tick() != "up"
    clock[0] = 106.0
    assert scaler.tick() == "up" and svc.scaled_to == [2, 3]


def test_dry_run_records_but_does_not_touch_the_fleet():
    svc = FakeService(workers=1)
    scaler = Autoscaler(svc, interval_s=1.0, clock=lambda: 50.0, signal_source=lambda: sig(queue_depth=80),
                        min_workers=1, max_workers=3, apply=False)
    assert scaler.tick() == "up"
    assert svc.scaled_to == [] and scaler.status()["last_action"]["action"] == "up"


def test_status_shape_equals_the_reference():
    st = []
    for mod in (autoscale, ref_autoscale):
        scaler = mod.Autoscaler(FakeService(), interval_s=1.0, clock=lambda: 0.0,
                                signal_source=lambda mod=mod: sig(mod), min_workers=1, max_workers=2)
        scaler.tick()
        st.append(scaler.status())
    assert st[0] == st[1]
    assert st[0]["last_signals"]["workers"] == 1


@pytest.mark.parametrize("kw", [dict(min_workers=0), dict(min_workers=3, max_workers=2),
                                dict(policy=AutoscalePolicy(), max_workers=3)])
def test_bad_bounds_refused_like_the_reference(kw):
    ref_kw = dict(kw)
    if "policy" in ref_kw:
        ref_kw["policy"] = ref_autoscale.AutoscalePolicy()
    with pytest.raises(ValueError):
        ref_autoscale.Autoscaler(FakeService(), **ref_kw)
    with pytest.raises(ValueError):
        Autoscaler(FakeService(), **kw)


def test_sample_reads_the_service_without_a_pool():
    svc = FakeService(workers=2)
    svc.queue_depth = 7
    s = Autoscaler(svc).sample()
    assert (s.workers, s.queue_depth, s.queue_bound, s.burn_rate, s.pool_hit_rate) == (2, 7, 100, None, None)


# ------------------------------------------------------- on a live service
class _Slow(Transformer):
    """A stage that takes 20 ms a batch: a backlog builds under a burst."""

    def params(self):
        return ("slow",)

    def apply_batch(self, xs, mask=None):
        time.sleep(0.02)
        return xs


def _pipeline(slow: bool = False):
    head = Pipeline.of(_Slow()) | NormalizeRows() if slow else Pipeline.of(NormalizeRows())
    return (head | LinearMapper(torch.eye(DIM) * 2.0)).fit()


def test_autoscaler_grows_and_shrinks_a_live_fleet():
    """A deep queue grows the fleet (each new replica primed before it is
    routed), the idle fleet shrinks back to the floor, every future
    resolves, and the ups and downs land in the metrics and /statusz."""
    ev0 = {a: metrics.REGISTRY.counter_value("serve.autoscale_events", action=a) for a in ("up", "down")}
    svc = serve(_pipeline(slow=True), devices=["cpu"], max_batch=4, max_wait_ms=1.0, queue_bound=64,
                example=np.zeros(DIM, np.float32), name="autoscale_live",
                autoscale=dict(min_workers=1, max_workers=3, interval_s=0.05, up_cooldown_s=0.0,
                               down_cooldown_s=0.1, down_ticks=2))
    try:
        rows = np.random.default_rng(0).normal(size=(48, DIM)).astype(np.float32)
        peak, futs = 1, []
        deadline = time.monotonic() + WAIT
        while peak < 2 and time.monotonic() < deadline:
            if svc.queue_depth < 40:
                futs += svc.submit_many(rows[:8])
            peak = max(peak, svc.replicas)
            time.sleep(0.005)
        assert peak >= 2
        got = np.stack([f.result(timeout=WAIT) for f in futs])
        assert got.shape == (len(futs), DIM) and np.all(np.isfinite(got))
        deadline = time.monotonic() + WAIT
        while svc.replicas > 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert svc.replicas == 1
        st = svc.status()["autoscaler"]
        assert st["ups"] >= 1 and st["downs"] >= 1 and st["min_workers"] == 1 and st["max_workers"] == 3
        for a in ("up", "down"):
            assert metrics.REGISTRY.counter_value("serve.autoscale_events", action=a) > ev0[a]
    finally:
        svc.close(timeout=WAIT)


def test_bad_autoscale_config_does_not_leak_the_fleet():
    with pytest.raises(ValueError):
        serve(_pipeline(), devices=["cpu"], example=np.zeros(DIM, np.float32), autoscale=dict(min_workers=0))
