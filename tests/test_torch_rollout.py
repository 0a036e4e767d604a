"""Guarded rollouts of the port (keystone_tpu_torch/serve/rollout.py)
against the JAX package's (keystone_tpu/serve/rollout.py): the canary
split, the rollout config and what it refuses, and the judge's and the
bake guard's verdicts on the same scripted outcome, latency and burn
streams; then the port's own episodes on the CPU (the reference's
tests/test_rollout.py scenarios): a poison flood rolled back and
quarantined, a clean canary committed, too few samples, a bake that
reverts, the staged-capacity fallback, the plain swap pinned, the SLO
window, the watcher's quarantine skip and guarded path, and the HTTP
admin surface.

Tolerances: none; every comparison is exact (the split is a hash, the
verdicts are decisions).  Every wait is bounded."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from keystone_tpu.serve import rollout as ref_rollout
from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.ops.stats import NormalizeRows
from keystone_tpu_torch.serve import ModelRegistry, RegistryWatcher, RolloutConfig, serve, serve_http
from keystone_tpu_torch.serve import rollout
from keystone_tpu_torch.serve.rollout import CanaryController, canary_hash, guarded_swap
from keystone_tpu_torch.tools import serve_bench
from keystone_tpu_torch.utils import durable
from keystone_tpu_torch.workflow.pipeline import Pipeline

pytestmark = pytest.mark.serve

DIM = 6
WAIT = 30.0
MARK = np.float32(serve_bench.MARK)


def _pipeline(scale: float = 2.0, gate: bool = False):
    """NormalizeRows → LinearMapper(eye·scale): an answer's norm is the
    scale of the version that served it."""
    head = Pipeline.of(serve_bench.MarkerGate()) | NormalizeRows() if gate else Pipeline.of(NormalizeRows())
    return (head | LinearMapper(torch.eye(DIM) * scale)).fit()


def _service(replicas: int, name: str, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("queue_bound", 512)
    kw.setdefault("example", np.zeros(DIM, np.float32))
    kw.setdefault("version", "v0001")
    kw.setdefault("devices", ["cpu"] * replicas)
    return serve(_pipeline(), replicas=replicas, name=name, **kw)


def _rows(k: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(k, DIM)).astype(np.float32)


def _norm(out) -> float:
    return float(np.linalg.norm(np.asarray(out)))


def _counter(name: str) -> float:
    return metrics.REGISTRY.counter_total(name)


class _Pump:
    """Background traffic: submit rows until stopped, keep every future."""

    def __init__(self, svc, make_rows):
        self.svc, self.make_rows, self.futs = svc, make_rows, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        i = 0
        while not self._stop.is_set():
            for row in self.make_rows(i):
                try:
                    self.futs.append(self.svc.submit(row))
                except Exception:
                    continue
            i += 1
            time.sleep(0.005)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10.0)

    def hung(self) -> int:
        """Resolve every future: a typed failure is a terminal, a hang is not."""
        from concurrent.futures import TimeoutError as FutTimeout

        n = 0
        for f in list(self.futs):
            try:
                f.result(timeout=WAIT)
            except FutTimeout:
                n += 1
            except Exception:
                pass
        return n


# ------------------------------------------------------- parity: the split
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_canary_hash_equals_the_reference(seed):
    ids = [f"req-{i:05d}" for i in range(10_000)]
    got = [canary_hash(seed, r) for r in ids]
    assert got == [ref_rollout.canary_hash(seed, r) for r in ids]
    assert all(0.0 <= h < 1.0 for h in got)


def test_canary_hash_replay_pin():
    """The reference's pinned values (tests/test_rollout.py)."""
    assert canary_hash(0, "req-000") == 0.22911944990885413
    assert canary_hash(7, "req-000") == 0.9493967629409243
    split = [i for i in range(200) if canary_hash(3, f"r{i}") < 0.25]
    assert len(split) == 48 and split[:12] == [2, 3, 4, 5, 7, 13, 20, 29, 31, 32, 35, 36]


# ------------------------------------------------------ parity: the config
_BODIES = [
    {"canary": 0.25, "min_samples": 5, "version": "v0002", "junk": 1},
    {"canary": 1.0, "seed": 4, "decide_s": 0.2, "insufficient": "commit", "bake_s": 3.0},
    {"canary": 0.5, "max_error_rate": 0.3, "max_burn": 1.5, "p99_ratio": None, "divergence_rtol": 1e-3},
    {"canary": 0.1, "bake_max_burn": 4.0, "bake_sustain_s": 0.5, "min_samples": 0},
    {"canary": None},
    {},
]
_BAD_BODIES = [{"canary": "a lot"}, {"canary": 0.0}, {"canary": 1.5}, {"canary": 0.5, "insufficient": "explode"},
               {"canary": 0.5, "min_samples": "many"}]


@pytest.mark.parametrize("body", _BODIES)
def test_rollout_config_from_request_equals_the_reference(body):
    got = RolloutConfig.from_request(body).to_dict()
    assert got == ref_rollout.RolloutConfig.from_request(body).to_dict()
    assert RolloutConfig.REQUEST_KEYS == ref_rollout.RolloutConfig.REQUEST_KEYS


@pytest.mark.parametrize("body", _BAD_BODIES)
def test_rollout_config_refuses_what_the_reference_refuses(body):
    with pytest.raises(ValueError):
        ref_rollout.RolloutConfig.from_request(body)
    with pytest.raises(ValueError, match="bad rollout config"):
        RolloutConfig.from_request(body)


def test_rollout_config_validation():
    for kw in (dict(canary=0.0), dict(canary=1.5), dict(insufficient="explode")):
        with pytest.raises(ValueError):
            RolloutConfig(**kw)
    assert RolloutConfig(canary=None).canary is None
    assert RolloutConfig().to_dict() == ref_rollout.RolloutConfig().to_dict()


# ---------------------------------------------- parity: the judge's verdicts
class _ScriptedService:
    """What the judge and the bake guard read of a service: a scripted
    SLO burn, a closing flag, and a swap that records its calls."""

    name = "scripted"
    recorder = None

    def __init__(self, burns=(None,)):
        self._closing = False
        self._burns = list(burns)
        self._i = 0
        self.swaps = []
        self._rollout_guard = None
        self._rollout_state = None
        self._rollout_history = []

    def slo_burn(self):
        b = self._burns[min(self._i, len(self._burns) - 1)]
        self._i += 1
        return b

    def swap(self, pipeline, version=None, artifacts=None):
        self.swaps.append(version)
        return {"version": version}


def _burn(rate, n=64):
    return None if rate is None else {"burn_rate": rate, "window_requests": n}


class _Rider:
    def __init__(self, gen):
        self.gen = gen


# (config, canary outcomes, live outcomes, canary latencies, live latencies, burn)
_STREAMS = [
    ("clean", dict(min_samples=8, p99_ratio=None), ["completed"] * 12, ["completed"] * 12, [], [], None),
    ("poison flood", dict(min_samples=8, max_error_rate=0.2, p99_ratio=None),
     ["completed", "poison", "completed", "poison"] * 3, ["completed"] * 12, [], [], None),
    ("shed at the limit", dict(min_samples=10, max_error_rate=0.1), ["completed"] * 9 + ["shed"], ["completed"] * 10,
     [], [], None),
    ("errors past the limit", dict(min_samples=10, max_error_rate=0.1), ["completed"] * 8 + ["error", "shed"],
     ["completed"] * 10, [], [], None),
    ("burning", dict(min_samples=8, max_burn=2.0, p99_ratio=None), ["completed"] * 8, [], [], [], 2.5),
    ("burning on a thin window", dict(min_samples=8, max_burn=2.0, p99_ratio=None), ["completed"] * 8, [], [], [],
     ("thin", 2.5)),
    ("slow canary", dict(min_samples=8, p99_ratio=3.0), ["completed"] * 10, ["completed"] * 10,
     [0.2] * 10, [0.01] * 10, None),
    ("slow canary, few live samples", dict(min_samples=8, p99_ratio=3.0), ["completed"] * 10, ["completed"] * 5,
     [0.2] * 10, [0.01] * 5, None),
    ("degraded counts for", dict(min_samples=6, max_error_rate=0.0), ["degraded"] * 6, [], [], [], None),
]


def _feed(ctl, canary, live, lat_c, lat_l):
    for gen, outs, lats in (("canary", canary, lat_c), ("live", live, lat_l)):
        for i, o in enumerate(outs):
            ctl.observe(_Rider(gen), o, lats[i] if i < len(lats) else 0.001)


@pytest.mark.parametrize("label,kw,canary,live,lat_c,lat_l,burn", _STREAMS, ids=[s[0] for s in _STREAMS])
def test_judge_verdicts_equal_the_reference(label, kw, canary, live, lat_c, lat_l, burn):
    """The same outcome and latency streams and the same burn give the same
    guardrail and the same verdict in both packages."""
    if isinstance(burn, tuple):
        burns = [{"burn_rate": burn[1], "window_requests": 2}]
    else:
        burns = [_burn(burn)]
    verdicts = []
    for mod in (rollout, ref_rollout):
        svc = _ScriptedService(burns)
        ctl = mod.CanaryController(svc, mod.RolloutConfig(canary=0.5, decide_s=0.0, **kw))
        _feed(ctl, canary, live, lat_c, lat_l)
        verdicts.append((ctl._guardrails(), ctl._judge({}), ctl.snapshot()))
    assert verdicts[0] == verdicts[1]


@pytest.mark.parametrize("insufficient", ["rollback", "commit"])
def test_judge_insufficient_samples_equals_the_reference(insufficient):
    got = []
    for mod in (rollout, ref_rollout):
        ctl = mod.CanaryController(_ScriptedService(), mod.RolloutConfig(canary=0.5, min_samples=100, decide_s=0.05,
                                                                         insufficient=insufficient))
        _feed(ctl, ["completed"] * 3, [], [], [])
        got.append(ctl._judge({}))
    assert got[0] == got[1] == (("committed" if insufficient == "commit" else "rolled_back"), "insufficient_samples")


def test_judge_closing_service_rolls_back_like_the_reference():
    got = []
    for mod in (rollout, ref_rollout):
        svc = _ScriptedService()
        svc._closing = True
        got.append(mod.CanaryController(svc, mod.RolloutConfig(canary=0.5))._judge({}))
    assert got[0] == got[1] == ("rolled_back", "service_closing")


# (bake config, burn stream, expected outcome)
_BAKES = [
    ("calm bake passes", dict(bake_s=0.3, bake_max_burn=1.0, bake_sustain_s=0.05), [0.2], "bake_passed"),
    ("sustained burn reverts", dict(bake_s=5.0, bake_max_burn=1.0, bake_sustain_s=0.05), [3.0], "rolled_back"),
    ("thin window never reverts", dict(bake_s=0.3, bake_max_burn=1.0, bake_sustain_s=0.05, min_samples=1000), [3.0],
     "bake_passed"),
    ("no objective", dict(bake_s=0.3, bake_max_burn=1.0, bake_sustain_s=0.05), [None], "bake_passed"),
]


@pytest.mark.parametrize("label,kw,burns,want", _BAKES, ids=[b[0] for b in _BAKES])
def test_rollback_guard_outcomes_equal_the_reference(label, kw, burns, want):
    """The bake guard on the same scripted burn stream: the same outcome,
    and a revert swaps back to the prior version in both packages."""
    outcomes = []
    for mod in (rollout, ref_rollout):
        svc = _ScriptedService([_burn(b) for b in burns])
        guard = mod.RollbackGuard(svc, mod.RolloutConfig(canary=0.5, **kw), from_version="v0001",
                                  to_version="v0002", prior_source=object())
        svc._rollout_guard = guard
        guard.start()
        guard._thread.join(WAIT)
        assert not guard._thread.is_alive()
        outcomes.append((guard._outcome, svc.swaps, svc._rollout_guard is None))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == want
    assert outcomes[0][1] == (["v0001"] if want == "rolled_back" else [])


# ------------------------------------------------------- the port's episodes
def test_canary_catches_poison_flood(tmp_path):
    """A bad version (it fails marker rows) canaried under a poison flood
    is rolled back on the error-rate guardrail: the live generation serves
    on, the version is quarantined, and no future hangs."""
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))
    v2 = reg.publish(_pipeline(3.0, gate=True), set_current=False)
    svc = _service(2, "rollout_poison", version=v1)

    def poison_wave(i):
        rows = _rows(3, seed=1000 + i)
        rows[0, 0] = MARK
        return rows

    rollbacks0 = _counter("serve.rollout.rollbacks")
    try:
        with _Pump(svc, poison_wave) as pump:
            cfg = RolloutConfig(canary=1.0, min_samples=8, decide_s=20.0, max_error_rate=0.2, p99_ratio=None)
            info = CanaryController(svc, cfg, registry=reg).run(reg.load(v2)[0], version=v2)
            assert info["verdict"] == "rolled_back" and info["reason"] == "error_rate", info
            assert info["canary"]["canary"]["bad"] > 0
        assert pump.hung() == 0
        assert svc.version == v1
        assert abs(_norm(svc.submit(_rows(1, seed=5)[0]).result(timeout=WAIT)) - 2.0) < 1e-3
        assert reg.quarantined(v2) is not None
        assert reg.load()[1] == v1
        assert _counter("serve.rollout.rollbacks") > rollbacks0
        assert svc.rollout_status()["history"][-1]["verdict"] == "rolled_back"
        assert svc.rollout_status()["active"] is None
    finally:
        svc.close(timeout=WAIT)


def test_canary_passes_clean_commits(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))
    v2 = reg.publish(_pipeline(3.0), set_current=False)
    svc = _service(2, "rollout_clean", version=v1)
    commits0 = _counter("serve.rollout.commits")
    try:
        with _Pump(svc, lambda i: _rows(3, seed=2000 + i)) as pump:
            cfg = RolloutConfig(canary=0.5, seed=3, min_samples=8, decide_s=20.0, p99_ratio=None)
            info = CanaryController(svc, cfg, registry=reg).run(reg.load(v2)[0], version=v2)
            assert info["verdict"] == "committed" and info["reason"] == "guardrails_clean", info
            assert {"pause_seconds", "prime_seconds", "replicas"} <= set(info)
        assert pump.hung() == 0
        assert svc.version == v2
        assert abs(_norm(svc.submit(_rows(1, seed=6)[0]).result(timeout=WAIT)) - 3.0) < 1e-3
        assert reg.current() == v2 and reg.quarantined(v2) is None
        assert _counter("serve.rollout.commits") > commits0
        assert v1 in svc.rollout_status()["prior_versions"]
    finally:
        svc.close(timeout=WAIT)


def test_canary_insufficient_samples_decides_conservatively(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))
    v2 = reg.publish(_pipeline(3.0), set_current=False)
    svc = _service(1, "rollout_quiet", version=v1)
    try:
        ctl = CanaryController(svc, RolloutConfig(canary=0.5, min_samples=10_000, decide_s=0.3), registry=reg)
        info = ctl.run(reg.load(v2)[0], version=v2)
        assert (info["verdict"], info["reason"]) == ("rolled_back", "insufficient_samples")
        assert svc.version == v1
        with pytest.raises(RuntimeError):
            ctl.run(reg.load(v2)[0], version=v2)  # single-use
        assert reg.quarantined(v2) is not None
        reg.clear_quarantine(v2)
        cfg2 = RolloutConfig(canary=0.5, min_samples=10_000, decide_s=0.3, insufficient="commit")
        info2 = CanaryController(svc, cfg2, registry=reg).run(reg.load(v2)[0], version=v2)
        assert (info2["verdict"], info2["reason"]) == ("committed", "insufficient_samples")
        assert svc.version == v2
    finally:
        svc.close(timeout=WAIT)


def test_bake_rollback_on_sustained_burn(tmp_path):
    """The committed version burns a microscopic objective during its
    bake: the guard reverts to the prior generation and quarantines it."""
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))
    v2 = reg.publish(_pipeline(3.0), set_current=False)
    svc = _service(2, "rollout_bake", version=v1, slo_ms=1e-4, slo_target=0.99)
    bake0 = _counter("serve.rollout.bake_rollbacks")
    try:
        cfg = RolloutConfig(canary=1.0, min_samples=4, decide_s=0.2, insufficient="commit", max_burn=float("inf"),
                            max_error_rate=1.1, p99_ratio=None, bake_s=30.0, bake_max_burn=1.0, bake_sustain_s=0.1)
        info = CanaryController(svc, cfg, registry=reg).run(reg.load(v2)[0], version=v2)
        assert info["verdict"] == "committed" and svc.version == v2
        assert svc.rollout_status()["active"]["phase"] == "bake"
        deadline, i = time.monotonic() + WAIT, 0
        while svc.version != v1 and time.monotonic() < deadline:
            for f in svc.submit_many(_rows(4, seed=3000 + i)):
                try:
                    f.result(timeout=WAIT)
                except Exception:
                    pass
            i += 1
        assert svc.version == v1, "the bake guard never reverted"
        assert abs(_norm(svc.submit(_rows(1, seed=8)[0]).result(timeout=WAIT)) - 2.0) < 1e-3
        assert _counter("serve.rollout.bake_rollbacks") > bake0
        # the guard records the episode after its registry bookkeeping
        deadline = time.monotonic() + 5.0
        while svc.rollout_status()["history"][-1]["reason"] != "bake_burn" and time.monotonic() < deadline:
            time.sleep(0.02)
        assert svc.rollout_status()["history"][-1]["reason"] == "bake_burn"
        assert reg.quarantined(v2) is not None and reg.current() == v1
        assert svc._rollout_guard is None
    finally:
        svc.close(timeout=WAIT)


def test_canary_fallback_when_no_staged_capacity():
    class _Flush:
        riders = ()
        bid = "b-fallback"

    svc = _service(1, "rollout_fallback")
    try:
        ctl = CanaryController(svc, RolloutConfig(canary=1.0))
        ctl._open = True  # a window open with no staged replica
        before = _counter("serve.rollout.canary_fallbacks")
        assert ctl.take(_Flush()) is False
        assert ctl.snapshot()["canary_fallbacks"] == 1
        assert _counter("serve.rollout.canary_fallbacks") > before
    finally:
        svc.close(timeout=WAIT)


def test_plain_swap_surface_pinned():
    """With canary=None nothing of the rollout machinery runs."""
    svc = _service(2, "rollout_pinned")
    try:
        info = svc.swap(_pipeline(3.0), version="v0002")
        assert set(info) == {"version", "pause_seconds", "prime_seconds", "replicas"}
        assert set(guarded_swap(svc, _pipeline(4.0), version="v0003", config=None)) == set(info)
        assert set(guarded_swap(svc, _pipeline(5.0), version="v0004", config=RolloutConfig(canary=None))) == set(info)
        assert svc.version == "v0004"
        assert svc.rollout_status()["prior_versions"] == ["v0001", "v0002", "v0003"]
    finally:
        svc.close(timeout=WAIT)


def test_slo_burn_windowing_knob():
    svc = _service(1, "rollout_slo", slo_ms=250.0, slo_window_s=5.0)
    try:
        detail = svc.slo_burn()
        assert detail["window_seconds"] == 5.0 and detail["window_requests"] == 0 and detail["burn_rate"] == 0.0
        for f in svc.submit_many(_rows(4, seed=3)):
            f.result(timeout=WAIT)
        detail = svc.slo_burn()
        assert detail["window_requests"] >= 4
        assert svc.slo_burn_rate() == detail["burn_rate"]
    finally:
        svc.close(timeout=WAIT)
    svc2 = _service(1, "rollout_noslo")
    try:
        assert svc2.slo_burn() is None and svc2.slo_burn_rate() is None
    finally:
        svc2.close(timeout=WAIT)


def test_watcher_skips_quarantined_version(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))
    svc = _service(1, "rollout_watch", version=v1)
    try:
        v2 = reg.publish(_pipeline(3.0))
        reg.quarantine(v2, reason="rollout rollback: slo_burn")
        w = RegistryWatcher(svc, reg, poll_seconds=3600.0)
        skips0 = _counter("serve.watch_quarantine_skips")
        w._poll_once()
        assert svc.version == v1 and _counter("serve.watch_quarantine_skips") > skips0
        w._poll_once()
        assert svc.version == v1
        reg.clear_quarantine(v2)
        w._poll_once()
        assert svc.version == v2
    finally:
        svc.close(timeout=WAIT)


def test_watcher_guarded_rollout_path(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))
    svc = _service(1, "rollout_watch_canary", version=v1)
    try:
        cfg = RolloutConfig(canary=1.0, min_samples=10_000, decide_s=0.2)
        w = RegistryWatcher(svc, reg, poll_seconds=3600.0, rollout=cfg)
        v2 = reg.publish(_pipeline(3.0))
        rb0 = _counter("serve.watch_rollbacks")
        w._poll_once()
        assert svc.version == v1 and _counter("serve.watch_rollbacks") > rb0
        assert reg.quarantined(v2) is not None and reg.current() == v1
        reg.set_current(v2)
        skips0 = _counter("serve.watch_quarantine_skips")
        w._poll_once()
        assert svc.version == v1 and _counter("serve.watch_quarantine_skips") > skips0
    finally:
        svc.close(timeout=WAIT)


def test_rollback_answers_while_the_watcher_loads_a_publish(tmp_path, monkeypatch):
    """An operator's POST /rollback made while the registry watcher loads a
    publish for its canary answers before that load ends, and the watcher,
    finding CURRENT moved when its load ends, drops the publish: the
    rollback stands and nothing is quarantined."""
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))
    v2 = reg.publish(_pipeline(3.0), set_current=False)
    with _service(1, "rollout_watch_admin", version=v1) as svc, serve_http(svc, port=0, registry=reg) as front:
        base = f"http://127.0.0.1:{front.port}"

        def post(path, body):
            req = urllib.request.Request(base + path, data=json.dumps(body).encode())
            return json.load(urllib.request.urlopen(req, timeout=WAIT / 3))

        post("/swap", {"version": v2})
        v3 = reg.publish(_pipeline(4.0))
        loading, release = threading.Event(), threading.Event()
        load = reg.load

        def held_load(version=None, **kw):
            if version == v3:
                loading.set()
                release.wait(WAIT)
            return load(version, **kw)

        monkeypatch.setattr(reg, "load", held_load)
        w = RegistryWatcher(svc, reg, poll_seconds=3600.0,
                            rollout=RolloutConfig(canary=1.0, min_samples=10_000, decide_s=0.2))
        poll = threading.Thread(target=w._poll_once, daemon=True)
        poll.start()
        try:
            assert loading.wait(WAIT)
            info = post("/rollback", {})
            assert not release.is_set() and poll.is_alive()
            assert (info["rolled_back_to"], info["rolled_back_from"]) == (v1, v2)
        finally:
            release.set()
            poll.join(WAIT)
        assert not poll.is_alive()
        assert svc.version == v1 and reg.current() == v1 and reg.quarantined(v3) is None


def test_http_rollout_endpoints(tmp_path):
    """GET /rolloutz, POST /rollback over the swap history (409 with
    nothing to revert to), POST /swap with a version and with rollout
    knobs (400 on a bad one, a verdict either way a 200), clear_bad."""
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))
    v2 = reg.publish(_pipeline(3.0), set_current=False)
    with _service(2, "rollout_http", version=v1) as svc, serve_http(svc, port=0, registry=reg) as front:
        base = f"http://127.0.0.1:{front.port}"

        def post(path, body):
            req = urllib.request.Request(base + path, data=json.dumps(body).encode())
            return json.load(urllib.request.urlopen(req, timeout=60))

        rz = json.load(urllib.request.urlopen(base + "/rolloutz", timeout=10))
        assert rz["version"] == v1 and rz["history"] == [] and rz["prior_versions"] == []
        with pytest.raises(urllib.error.HTTPError) as err:
            post("/rollback", {})
        assert err.value.code == 409
        info = post("/swap", {"version": v2})
        assert svc.version == v2 and info["version"] == v2 and reg.current() == v2
        info = post("/rollback", {})
        assert (info["rolled_back_to"], info["rolled_back_from"]) == (v1, v2)
        assert svc.version == v1 and reg.current() == v1
        with pytest.raises(urllib.error.HTTPError) as err:
            post("/rollback", {})
        assert err.value.code == 409
        with pytest.raises(urllib.error.HTTPError) as err:
            post("/swap", {"version": v2, "canary": 2.0})
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            post("/swap", {"version": "v0099"})
        assert err.value.code == 404
        info = post("/swap", {"version": v2, "canary": 1.0, "min_samples": 10_000, "decide_s": 0.2,
                              "insufficient": "rollback"})
        assert info["verdict"] == "rolled_back" and svc.version == v1 and reg.quarantined(v2) is not None
        rz = json.load(urllib.request.urlopen(base + "/rolloutz", timeout=10))
        assert rz["history"][-1]["verdict"] == "rolled_back"
        post("/swap", {"version": v2, "clear_bad": True})
        assert svc.version == v2 and reg.quarantined(v2) is None


def test_quarantine_mark_is_checksummed(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))
    reg.quarantine(v1, reason="rollout rollback: error_rate")
    assert durable.verify_checksum(reg.bad_path(v1), required=True)
    assert "error_rate" in reg.quarantined(v1)
