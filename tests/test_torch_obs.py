"""The port's metrics registry and run ledger (keystone_tpu_torch/obs/)
against the JAX package's (keystone_tpu/obs/): the reference's scenarios
(tests/test_obs.py), the same JSONL schema, span names and event kinds
for the same small fits in both packages, and the inert-hook guarantee:
with no ledger, no plan and no deadline, the hooks add no synchronize
and no host read to a fit."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from keystone_tpu_torch import faults
from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.ops.stats import LinearRectifier
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.pipeline import Pipeline


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    monkeypatch.delenv(ledger.ENV_DIR, raising=False)
    monkeypatch.delenv(metrics.ENV_DISABLE, raising=False)
    ledger.attach(None)
    metrics.reset()
    yield
    ledger.stop_run()
    ledger.attach(None)
    metrics.reset()


def _events(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _run_events(directory):
    paths = glob.glob(os.path.join(directory, "run_*.jsonl"))
    assert len(paths) == 1, paths
    return paths[0], _events(paths[0])


def _cpu(a):
    return Dataset(np.asarray(a, np.float32), device="cpu")


def _problem(seed, n=96, d=24, k=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(n, k)).astype(np.float32)


# ------------------------------------------------------------- registry


def _registry_ops(m):
    m.inc("a.count")
    m.inc("a.count", 2, site="s")
    m.observe("a.lat", 0.02)
    m.observe("a.lat", 7.5)
    m.gauge_max("a.peak", 10)
    m.gauge_max("a.peak", 4)
    m.set_gauge("a.level", 3, key="k")


def test_registry_exports_match_the_references():
    from keystone_tpu.obs.metrics import MetricsRegistry as RefRegistry

    ours, ref = metrics.MetricsRegistry(), RefRegistry()
    _registry_ops(ours)
    _registry_ops(ref)
    assert ours.snapshot() == ref.snapshot()
    assert ours.to_prometheus_text() == ref.to_prometheus_text()


def test_metrics_counters_gauges_histograms():
    _registry_ops(metrics.REGISTRY)
    snap = metrics.snapshot()
    assert snap["counters"]["a.count"] == 1.0 and snap["counters"]["a.count{site=s}"] == 2.0
    assert snap["gauges"]["a.peak"] == 10.0
    assert snap["histograms"]["a.lat"]["count"] == 2
    assert metrics.REGISTRY.counter_total("a.count") == 3.0
    text = metrics.REGISTRY.to_prometheus_text()
    assert 'a_count_total{site="s"} 2' in text and "a_lat_bucket" in text
    with pytest.raises(metrics.MetricKindError):
        metrics.inc("a.lat")


def test_metrics_disabled_records_nothing(monkeypatch):
    monkeypatch.setenv(metrics.ENV_DISABLE, "0")
    metrics.inc("x")
    metrics.observe("y", 1.0)
    metrics.gauge_max("z", 1.0)
    snap = metrics.snapshot()
    assert not snap["counters"] and not snap["gauges"] and not snap["histograms"]


def test_register_buckets_and_windowed_histograms():
    metrics.register_buckets("bucketed.latency_seconds", metrics.LATENCY_MS_BUCKETS)
    metrics.observe("bucketed.latency_seconds", 0.003)
    text = metrics.REGISTRY.to_prometheus_text()
    assert 'bucketed_latency_seconds_bucket{le="0.0025"} 0' in text
    assert 'bucketed_latency_seconds_bucket{le="0.005"} 1' in text
    t = [0.0]
    wh = metrics.WindowedHistogram("windowed.latency_seconds", window_seconds=10.0, intervals=5,
                                   bounds=metrics.LATENCY_MS_BUCKETS, clock=lambda: t[0])
    for _ in range(50):
        wh.observe(4.0)
    t[0] = 1.0
    for _ in range(50):
        wh.observe(0.002)
    assert wh.merged().count == 100 and wh.percentile(99) > 1.0
    t[0] = 12.0
    for _ in range(50):
        wh.observe(0.002)
    assert wh.merged().count == 50 and wh.percentile(99) < 0.01
    assert metrics.snapshot()["histograms"]["windowed.latency_seconds"]["count"] == 150


def test_blockstore_counters_match_the_references(tmp_path):
    from keystone_tpu.obs import metrics as ref_metrics
    from keystone_tpu.workflow.blockstore import FeatureBlockStore as RefStore
    from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore, RowBlockStore

    x = np.random.default_rng(0).normal(size=(32, 12)).astype(np.float32)
    names = ("blockstore.writes", "blockstore.write_bytes", "blockstore.reads", "blockstore.read_bytes")

    ref_metrics.reset()
    RefStore.from_array(str(tmp_path / "ref"), x, 8).read_block(0)
    want = [ref_metrics.REGISTRY.counter_value(n) for n in names]
    store = FeatureBlockStore.from_array(str(tmp_path / "port"), x, 8)
    store.read_block(0)
    assert [metrics.REGISTRY.counter_value(n) for n in names] == want == [1.0, 2 * 32 * 8 * 4, 1.0, 32 * 8 * 4]
    metrics.reset()
    rows = RowBlockStore.from_array(str(tmp_path / "rows"), x, 16)
    rows.read_block(1)
    assert [metrics.REGISTRY.counter_value(n) for n in names] == [1.0, 32 * 12 * 4, 1.0, 16 * 12 * 4]
    with faults.inject("blockstore.read:times=2:raise"):
        rows.read_block(0)
    assert metrics.REGISTRY.counter_value("blockstore.read_retries") == 2.0


# --------------------------------------------------------------- ledger


def test_span_nesting_and_jsonl_schema_roundtrip(tmp_path):
    led = ledger.start_run(str(tmp_path))
    with ledger.span("outer", node="A") as sp:
        sp.set(attempts=2)
        with ledger.span("inner"):
            ledger.event("tick", k=1)
    ledger.stop_run()
    _, events = _run_events(str(tmp_path))
    assert [e["kind"] for e in events] == ["run_start", "span_start", "span_start", "event", "span_end",
                                           "span_end", "metrics", "run_end"]
    for e in events:
        assert {"ts", "run_id", "seq", "kind", "name"} <= set(e) and e["run_id"] == led.run_id
    assert [e["seq"] for e in events] == sorted(e["seq"] for e in events)
    outer, inner, tick, inner_end, outer_end = events[1:6]
    assert inner["parent"] == outer["span"] and tick["parent"] == inner["span"]
    assert inner_end["span"] == inner["span"]
    assert outer_end["seconds"] >= 0 and outer_end["attrs"]["attempts"] == 2 and outer_end["attrs"]["node"] == "A"
    assert "host_max_rss_bytes" in outer_end["attrs"]


def test_disabled_mode_emits_nothing(tmp_path, monkeypatch):
    assert ledger.active() is None
    with ledger.span("s") as sp:
        assert sp is None
        ledger.event("e")
    ledger.solver_epoch("bcd", epoch=0)
    assert glob.glob(str(tmp_path / "*.jsonl")) == []
    monkeypatch.setenv(ledger.ENV_DIR, str(tmp_path))
    with ledger.span("s2") as sp:
        assert sp is not None
    assert len(glob.glob(str(tmp_path / "run_*.jsonl"))) == 1
    ledger.active().close()


def _fit_events(pkg, directory):
    """A small Pipeline.fit (a rectifier, then a 3-epoch BCD) and a
    streamed out-of-core fit under a ledger in ``pkg``: its span names,
    event names and solver series."""
    x, y = _problem(0)
    if pkg == "port":
        L, Est, P, Rect, SD = ledger, BlockLeastSquaresEstimator, Pipeline, LinearRectifier, StreamDataset
        from keystone_tpu_torch.loaders.stream import batched

        def ds(a):
            return _cpu(a)

        def sd(a):
            return SD(batched(a, 32), n=a.shape[0], device="cpu")
    else:
        from keystone_tpu.loaders.stream import batched
        from keystone_tpu.models import BlockLeastSquaresEstimator as Est
        from keystone_tpu.obs import ledger as L
        from keystone_tpu.ops import LinearRectifier as Rect
        from keystone_tpu.workflow import Dataset as RD
        from keystone_tpu.workflow import Pipeline as P
        from keystone_tpu.workflow.dataset import StreamDataset as SD

        def ds(a):
            return RD(a)

        def sd(a):
            return SD(batched(a, 32), n=a.shape[0])
    led = L.start_run(directory)
    try:
        P.of(Rect(0.0)).and_then(Est(block_size=8, num_iter=3, lam=1e-3), ds(x), ds(y)).fit()
        Est(block_size=8, num_iter=2, lam=1e-3).fit_dataset(sd(x), ds(y))
        if pkg == "reference":
            import jax

            jax.effects_barrier()
    finally:
        L.stop_run()
    evs = _events(led.path)
    spans = sorted({e["name"] for e in evs if e["kind"] == "span_start"})
    kinds = sorted({e["kind"] for e in evs})
    named = sorted({e["name"] for e in evs if e["kind"] == "event"})
    series = {}
    for e in evs:
        if e["name"] == "solver.epoch":
            a = e["attrs"]
            series.setdefault(a["solver"], []).append((a["epoch"], sorted(k for k in a if k != "solver")))
    stage_attrs = sorted({k for e in evs if e["kind"] == "span_end" and e["name"] == "executor.stage"
                          for k in e["attrs"] if not k.startswith(("hbm_", "host_"))})
    return spans, kinds, named, series, stage_attrs


def test_fit_ledger_names_match_the_references(tmp_path):
    got = _fit_events("port", str(tmp_path / "port"))
    want = _fit_events("reference", str(tmp_path / "ref"))
    assert got == want
    spans, _, _, series, _ = got
    assert {"pipeline.fit", "executor.stage", "solver.spill"} <= set(spans)
    assert [e for e, _ in series["bcd"]] == [0, 1, 2]
    assert [e for e, _ in series["bcd.out_of_core"]] == [0, 1]


def test_env_dir_activates_pipeline_fit_ledger(tmp_path, monkeypatch):
    monkeypatch.setenv(ledger.ENV_DIR, str(tmp_path))
    x, y = _problem(0)
    Pipeline.of(LinearRectifier(0.0)).and_then(BlockLeastSquaresEstimator(block_size=8, num_iter=3, lam=1e-3),
                                               _cpu(x), _cpu(y)).fit()
    ledger.active().close()
    _, events = _run_events(str(tmp_path))
    assert "pipeline.fit" in {e["name"] for e in events}
    stage_spans = [e for e in events if e["kind"] == "span_end" and e["name"] == "executor.stage"]
    assert stage_spans and all("retries" in e["attrs"] for e in stage_spans)
    assert [e["attrs"]["epoch"] for e in events if e["name"] == "solver.epoch"] == [0, 1, 2]
    snaps = [e for e in events if e["kind"] == "metrics"]
    assert snaps and "counters" in snaps[0]["attrs"]
    folded = ledger.fold_stage_spans(_run_events(str(tmp_path))[0])
    assert any(v["label"] == "LinearRectifier" for v in folded.values())


def test_out_of_core_fit_ledger_has_io_and_convergence(tmp_path):
    from keystone_tpu_torch.loaders.stream import batched

    x, y = _problem(1, n=128)
    led = ledger.start_run(str(tmp_path))
    BlockLeastSquaresEstimator(block_size=8, num_iter=2, lam=1e-3).fit_dataset(
        StreamDataset(batched(x, 32), n=128, device="cpu"), _cpu(y))
    ledger.stop_run()
    events = _events(led.path)
    snap = [e for e in events if e["kind"] == "metrics"][-1]["attrs"]
    assert snap["counters"]["blockstore.read_bytes"] > 0 and snap["counters"]["blockstore.write_bytes"] > 0
    series = [e["attrs"] for e in events if e["name"] == "solver.epoch"]
    assert [s["epoch"] for s in series] == [0, 1] and all(s["epoch_seconds"] > 0 for s in series)
    assert "solver.spill" in {e["name"] for e in events}


def test_chaos_run_ledger_contains_fault_stats(tmp_path):
    from keystone_tpu_torch.workflow.recovery import fit_with_recovery

    x, y = _problem(2, n=64, d=16, k=2)
    est = BlockLeastSquaresEstimator(block_size=8, num_iter=2, lam=1e-3)
    led = ledger.start_run(str(tmp_path))
    faults.reset_stats()
    with faults.inject("executor.stage:times=1:raise"):
        fit_with_recovery(lambda: est.with_data(_cpu(x), _cpu(y)), max_restarts=1)
    path = led.path
    ledger.stop_run()
    assert metrics.REGISTRY.counter_value("faults.injected", site="executor.stage") == 1.0
    stats = [e for e in _events(path) if e["name"] == "faults.stats"]
    assert stats and stats[0]["attrs"]["stats"]["executor.stage"]["injected"] == 1


def test_profile_timings_exclude_backoff_and_failed_attempts():
    from keystone_tpu_torch.workflow.executor import GraphExecutor
    from keystone_tpu_torch.workflow.pipeline import PipelineEnv

    lazy = Pipeline.of(LinearRectifier(0.0))(_cpu(np.random.default_rng(3).normal(size=(32, 8))))
    PipelineEnv.node_retries = 2
    try:
        with faults.inject("executor.stage:after=1:times=1:raise"):
            ex = GraphExecutor(lazy.graph, profile=True)
            ex.execute(lazy.graph.sinks[0])
    finally:
        PipelineEnv.node_retries = None
    label = {n: op.label() for n, op in lazy.graph.operators.items()}
    hit = [t for n, t in ex.timings.items() if label[n] == "LinearRectifier"]
    assert hit and hit[0] < 0.04
    assert metrics.REGISTRY.counter_value("executor.stage_retries") == 1.0
    assert metrics.REGISTRY.counter_total("executor.failed_attempt_seconds") > 0


def test_stream_retry_and_bad_batch_metrics():
    from keystone_tpu_torch.loaders.stream import resilient

    def source():
        def gen():
            yield np.zeros((4, 2))
            raise OSError("flaky batch")

        return gen()

    assert len(list(resilient(source, retries=1, max_bad_batches=1, sleep=lambda _: None)())) == 1
    assert metrics.REGISTRY.counter_value("stream.retries") == 1.0
    assert metrics.REGISTRY.counter_value("stream.bad_batches") == 1.0
    assert any(k.startswith("stream.batch_seconds") for k in metrics.snapshot()["histograms"])


def test_solver_obs_numerics_bit_identical(tmp_path):
    from keystone_tpu_torch.models.gmm import GaussianMixtureModelEstimator
    from keystone_tpu_torch.models.lbfgs import DenseLBFGSwithL2

    x, y = _problem(4, n=64, d=16, k=2)
    bcd = BlockLeastSquaresEstimator(block_size=8, num_iter=2, lam=1e-3)
    gmm = GaussianMixtureModelEstimator(3, max_iterations=3)
    lb = DenseLBFGSwithL2(lam=1e-3, num_iterations=8, history=4)
    fits = [lambda: bcd.fit_dataset(_cpu(x), _cpu(y)).weights, lambda: gmm.fit_dataset(_cpu(x)).means,
            lambda: lb.fit_dataset(_cpu(x), _cpu(y)).weights]
    inert = [f() for f in fits]
    led = ledger.start_run(str(tmp_path))
    observed = [f() for f in fits]
    ledger.stop_run()
    for a, b in zip(inert, observed):
        assert torch.equal(a, b)
    solvers = {e["attrs"]["solver"] for e in _events(led.path) if e["name"] == "solver.epoch"}
    assert {"bcd", "kmeans", "gmm", "lbfgs.dense"} <= solvers


def test_ledger_rotation_bounds_disk(tmp_path):
    led = ledger.RunLedger(str(tmp_path), max_bytes=2000, keep_segments=2)
    for i in range(400):
        led.event("rotation.filler", seconds=float(i))
    led.close()
    segments = sorted(p for p in os.listdir(tmp_path) if ".jsonl." in p)
    assert len(segments) == 2
    assert metrics.REGISTRY.counter_value("obs.ledger_rotations") > 2
    for name in segments + [os.path.basename(led.path)]:
        for line in open(os.path.join(tmp_path, name)):
            json.loads(line)


def test_ledger_reopen_resumes_rotation_state(tmp_path):
    led = ledger.RunLedger(str(tmp_path), run_id="stable", max_bytes=1500, keep_segments=4)
    for i in range(120):
        led.event("rotation.filler", seconds=float(i))
    led.close()
    before = sorted(p for p in os.listdir(tmp_path) if ".jsonl." in p)
    sizes = {p: os.path.getsize(os.path.join(tmp_path, p)) for p in before}
    led2 = ledger.RunLedger(str(tmp_path), run_id="stable", max_bytes=1500, keep_segments=4)
    assert led2._segment == max(int(p.rsplit(".", 1)[1]) for p in before) and led2._bytes > 0
    for i in range(120):
        led2.event("rotation.filler", seconds=float(i))
    led2.close()
    after = sorted(p for p in os.listdir(tmp_path) if ".jsonl." in p)
    for p in before:
        if p in after:
            assert os.path.getsize(os.path.join(tmp_path, p)) == sizes[p]


def test_ledger_rotation_env_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv(ledger.ENV_MAX_BYTES, "1500")
    monkeypatch.setenv(ledger.ENV_KEEP_SEGMENTS, "1")
    led = ledger.RunLedger(str(tmp_path))
    assert led.max_bytes == 1500 and led.keep_segments == 1
    for i in range(200):
        led.event("rotation.filler", seconds=float(i))
    led.close()
    assert len([p for p in os.listdir(tmp_path) if ".jsonl." in p]) == 1
    monkeypatch.delenv(ledger.ENV_MAX_BYTES)
    led2 = ledger.RunLedger(str(tmp_path))
    assert led2.max_bytes is None
    led2.close()


def test_the_reference_reads_the_ports_ledger(tmp_path):
    """One schema: the reference's stage fold reads a port ledger."""
    from keystone_tpu.obs.ledger import fold_stage_spans as ref_fold

    x, y = _problem(5)
    led = ledger.start_run(str(tmp_path))
    Pipeline.of(LinearRectifier(0.0)).and_then(BlockLeastSquaresEstimator(block_size=8, num_iter=1),
                                               _cpu(x), _cpu(y)).fit()
    ledger.stop_run()
    assert ref_fold(led.path) == ledger.fold_stage_spans(led.path) != {}


# ------------------------------------------------------- inert hooks


class _Reads:
    """Counts device synchronizes and host reads of tensors.  CUDA is
    reported present so that a synchronize the hooks would make shows
    up even on a CPU box."""

    METHODS = ("item", "cpu", "tolist", "numpy", "__float__", "__bool__")

    def __init__(self, monkeypatch):
        self.n = {"synchronize": 0, **{m: 0 for m in self.METHODS}}
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "synchronize", self._count("synchronize", None))
        for m in self.METHODS:
            monkeypatch.setattr(torch.Tensor, m, self._count(m, getattr(torch.Tensor, m)))

    def _count(self, key, fn):
        def wrapped(*a, **kw):
            self.n[key] += 1
            return None if fn is None else fn(*a, **kw)

        return wrapped

    def reset(self):
        self.n = {k: 0 for k in self.n}


def _fits():
    from keystone_tpu_torch.loaders.stream import batched
    from keystone_tpu_torch.models import kernel_ridge as kr
    from keystone_tpu_torch.models.gmm import GaussianMixtureModelEstimator
    from keystone_tpu_torch.models.lbfgs import DenseLBFGSwithL2

    x, y = _problem(6, n=64, d=16, k=2)
    est = BlockLeastSquaresEstimator(block_size=8, num_iter=2, lam=1e-3)
    return [
        lambda: Pipeline.of(LinearRectifier(0.0)).and_then(est, _cpu(x), _cpu(y)).fit(),
        lambda: est.fit_dataset(StreamDataset(batched(x, 16), n=64, device="cpu"), _cpu(y)),
        lambda: GaussianMixtureModelEstimator(3, max_iterations=3).fit_dataset(_cpu(x)),
        lambda: DenseLBFGSwithL2(lam=1e-3, num_iterations=6, history=3).fit_dataset(_cpu(x), _cpu(y)),
        lambda: kr.KernelRidgeRegressionEstimator(kr.GaussianKernelGenerator(0.1), block_size=16, num_epochs=2
                                                  ).fit_arrays(x, y, device="cpu"),
    ]


def _stub_hooks(monkeypatch):
    """Every hook of the operations layer replaced by nothing, in every
    module that holds one: the fits as they would run without the layer."""
    import contextlib
    import sys

    from keystone_tpu_torch.utils import guard

    @contextlib.contextmanager
    def no_span(name, **attrs):
        yield None

    monkeypatch.setattr(ledger, "span", no_span)
    monkeypatch.setattr(ledger, "event", lambda *a, **k: None)
    monkeypatch.setattr(ledger, "solver_epoch", lambda *a, **k: None)
    monkeypatch.setattr(ledger, "solver_obs", lambda: False)
    monkeypatch.setattr(ledger, "device_wait", lambda x, *a, **k: x)
    monkeypatch.setattr(guard, "run_with_deadline", lambda fn, deadline, *a, **k: fn())
    for name in ("inc", "observe", "set_gauge", "gauge_max"):
        monkeypatch.setattr(metrics, name, lambda *a, **k: None)
    real = faults.fault_point
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("keystone_tpu_torch") and getattr(mod, "fault_point", None) is real:
            monkeypatch.setattr(mod, "fault_point", lambda *a, **k: None)


def test_inert_hooks_add_no_synchronize_or_host_read(monkeypatch, tmp_path):
    """A fit with nothing attached makes exactly the synchronizes and host
    reads it makes with the operations layer stubbed out; with a ledger
    attached it makes more (the count can see the hooks)."""
    fits = _fits()
    reads = _Reads(monkeypatch)
    inert = []
    for f in fits:
        reads.reset()
        f()
        inert.append(dict(reads.n))
    led = ledger.start_run(str(tmp_path))
    observed = []
    for f in fits:
        reads.reset()
        f()
        observed.append(dict(reads.n))
    ledger.stop_run()
    assert led.path
    with monkeypatch.context() as m:
        _stub_hooks(m)
        bare = []
        for f in fits:
            reads.reset()
            f()
            bare.append(dict(reads.n))
    assert inert == bare
    assert all(sum(o.values()) > sum(i.values()) for o, i in zip(observed, inert)), (observed, inert)
    assert all(i["synchronize"] == 0 for i in inert)
