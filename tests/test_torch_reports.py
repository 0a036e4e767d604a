"""The port's read side (keystone_tpu_torch/tools/obs_report.py and
trace_report.py) against the reference's tools (tools/obs_report.py,
tools/trace_report.py): both fold the same ledger and the same recorder
dump into equal summaries, and a ledger written by the port's fit and one
written by the reference's fit on the same numpy data give the same
sections, stage names and convergence series.  Last, the port's own
service writes a ledger and a recorder dump that both tools read alike.

Tolerances: none; the summaries are compared exactly (the wall-clock
fields of two different runs aside)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))

import obs_report as ref_obs_report  # noqa: E402
import trace_report as ref_trace_report  # noqa: E402

from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator  # noqa: E402
from keystone_tpu_torch.models.linear import LinearMapper  # noqa: E402
from keystone_tpu_torch.obs import ledger, metrics  # noqa: E402
from keystone_tpu_torch.obs import recorder  # noqa: E402
from keystone_tpu_torch.ops.stats import LinearRectifier, NormalizeRows  # noqa: E402
from keystone_tpu_torch.serve import serve  # noqa: E402
from keystone_tpu_torch.tools import obs_report, trace_report  # noqa: E402
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset  # noqa: E402
from keystone_tpu_torch.workflow.pipeline import Pipeline  # noqa: E402

pytestmark = pytest.mark.obs

DIM = 6
WAIT = 30


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    monkeypatch.delenv(ledger.ENV_DIR, raising=False)
    ledger.attach(None)
    metrics.reset()
    yield
    ledger.stop_run()
    ledger.attach(None)
    metrics.reset()


def _problem(seed=0, n=128, d=24, k=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(n, k)).astype(np.float32)


def _fit_ledger(pkg: str, directory: str) -> str:
    """A ledger of one graph fit and one streamed (out-of-core) fit, from
    the port or the reference, on the same numpy data."""
    x, y = _problem()
    if pkg == "port":
        from keystone_tpu_torch.loaders.stream import batched

        L, M, P, Est, Rect = ledger, metrics, Pipeline, BlockLeastSquaresEstimator, LinearRectifier

        def ds(a):
            return Dataset(a, device="cpu")

        def sd(a):
            return StreamDataset(batched(a, 32), n=a.shape[0], device="cpu")
    else:
        from keystone_tpu.loaders.stream import batched
        from keystone_tpu.models import BlockLeastSquaresEstimator as Est
        from keystone_tpu.obs import ledger as L
        from keystone_tpu.obs import metrics as M
        from keystone_tpu.ops import LinearRectifier as Rect
        from keystone_tpu.workflow import Dataset as RD
        from keystone_tpu.workflow import Pipeline as P
        from keystone_tpu.workflow.dataset import StreamDataset as SD

        def ds(a):
            return RD(a)

        def sd(a):
            return SD(batched(a, 32), n=a.shape[0])
    M.reset()  # the process-wide registry: the snapshot holds this fit's counts alone
    led = L.start_run(directory)
    try:
        P.of(Rect(0.0)).and_then(Est(block_size=8, num_iter=3, lam=1e-3), ds(x), ds(y)).fit()
        Est(block_size=8, num_iter=2, lam=1e-3).fit_dataset(sd(x), ds(y))
        if pkg == "reference":
            import jax

            jax.effects_barrier()
    finally:
        L.stop_run()
    return led.path


@pytest.fixture(scope="module")
def fit_ledgers(tmp_path_factory):
    root = tmp_path_factory.mktemp("ledgers")
    ledger.attach(None)
    try:
        return {pkg: _fit_ledger(pkg, str(root / pkg)) for pkg in ("port", "reference")}
    finally:
        ledger.attach(None)
        metrics.reset()


# ------------------------------------------------------------ obs_report
@pytest.mark.parametrize("which", ["port", "reference"])
def test_obs_report_folds_a_ledger_like_the_reference(which, fit_ledgers, capsys):
    """The same file, either package's, gives the same summary, the same
    text and the same --json from both tools."""
    path = fit_ledgers[which]
    got, want = obs_report.summarize(path), ref_obs_report.summarize(path)
    assert got == want
    assert got["stage_top"] and got["convergence"]
    assert obs_report.render(got) == ref_obs_report.render(want)
    for args in ([path], [path, "--json"], [os.path.dirname(path), "--top", "2"]):
        assert obs_report.main(args) == 0
        ours = capsys.readouterr().out
        assert ref_obs_report.main(args) == 0
        assert ours == capsys.readouterr().out


def _shape(summary: dict) -> dict:
    """What two runs of the same fit share: the sections present, the
    stage names and counts, the convergence series' solvers, epochs and
    keys, and the I/O counters that count rows and blocks."""
    conv = {s: [(pt.get("epoch"), sorted(pt)) for pt in pts] for s, pts in summary["convergence"].items()}
    return {
        "sections": sorted(k for k, v in summary.items() if v not in (None, {}, [])),
        "stages": sorted((st["node"], st["count"], st["retries"]) for st in summary["stage_top"]),
        "convergence": conv,
        "io": {k: v for k, v in summary["io"].items() if k in ("blockstore_reads", "blockstore_writes")},
        "faults": summary["faults"],
    }


def test_port_and_reference_fits_give_the_same_report(fit_ledgers):
    got = obs_report.summarize(fit_ledgers["port"])
    want = ref_obs_report.summarize(fit_ledgers["reference"])
    assert _shape(got) == _shape(want)
    assert {"bcd", "bcd.out_of_core"} <= set(got["convergence"])
    assert any(st["node"] == "LinearRectifier" for st in got["stage_top"])


def test_obs_report_exit_codes(tmp_path, capsys):
    with pytest.raises(SystemExit) as err:
        obs_report.main([])
    assert err.value.code == 2
    with pytest.raises(FileNotFoundError):
        obs_report.main([str(tmp_path)])
    torn = tmp_path / "run_torn.jsonl"
    torn.write_text('{"kind": "event", "name": "x", "ts": 1.0}\n{"kind": "ev')
    assert obs_report.main([str(torn)]) == 0
    assert obs_report.summarize(str(torn)) == ref_obs_report.summarize(str(torn))
    assert "events: 1" in capsys.readouterr().out


# ---------------------------------------------------------- trace_report
def _drive_recorder(mod):
    rec = mod.FlightRecorder(capacity=16, pinned_capacity=8)
    for i, rid in enumerate(("a", "b", "c")):
        rec.annotate(rid, "serve.enqueue", queue_depth=i)
    rec.batch("b1", ["a", "b"], replica=0, rows=2)
    rec.annotate("a", "serve.batch", batch="b1", replica=0, queue_wait_seconds=0.002)
    rec.annotate("b", "serve.batch", batch="b1", replica=0, queue_wait_seconds=0.003)
    rec.batch_update("b1", rows=2, bucket=8, seconds=0.004, degraded=False)
    rec.batch("b2", ["c"], replica=1, rows=1)
    rec.annotate("c", "serve.batch", batch="b2", replica=1, queue_wait_seconds=0.001)
    rec.batch_update("b2", rows=1, bucket=8, seconds=0.005, worker=1, host="h",
                     wire={"rtt_s": 0.001, "send_s": 0.0002, "recv_s": 0.0003},
                     worker_spans=[{"name": "worker.apply", "t_off": 0.0, "seconds": 0.0042}])
    rec.finish("a", "completed", batch="b1", replica=0)
    rec.finish("b", "shed", batch="b1")
    rec.finish("c", "completed", batch="b2", replica=1)
    rec.ops("serve.swap", version="v1")
    return rec.dump()


@pytest.mark.parametrize("which", ["port", "reference"])
def test_trace_report_folds_a_dump_like_the_reference(which, tmp_path, capsys):
    from keystone_tpu.obs import recorder as ref_recorder

    dump = _drive_recorder(recorder if which == "port" else ref_recorder)
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(dump))
    got = trace_report.summarize(trace_report.load(str(path)), top=2, timeline=4)
    want = ref_trace_report.summarize(ref_trace_report.load(str(path)), top=2, timeline=4)
    assert got == want
    assert got["requests"] == 3 and got["outcomes"] == {"completed": 2, "shed": 1}
    assert got["fleet"]["1"]["flushes"] == 1 and set(got["replica_timelines"]) == {"0", "1"}
    assert trace_report.render(got) == ref_trace_report.render(want)
    for args in ([str(path)], [str(path), "--json", "--top", "1"]):
        assert trace_report.main(args) == 0
        ours = capsys.readouterr().out
        assert ref_trace_report.main(args) == 0
        assert ours == capsys.readouterr().out


def test_the_ports_service_writes_what_both_tools_read(tmp_path):
    """A live CPU service of the port with the ledger on: its ledger and
    its recorder dump read the same through both tools, and the counts
    agree with what the service resolved."""
    pipe = (Pipeline.of(NormalizeRows()) | LinearMapper(torch.eye(DIM) * 2.0)).fit()
    led = ledger.start_run(str(tmp_path / "obs"))
    svc = serve(pipe, devices=["cpu"], max_batch=8, max_wait_ms=5.0, queue_bound=64,
                example=np.zeros(DIM, np.float32))
    try:
        rows = np.random.default_rng(1).normal(size=(24, DIM)).astype(np.float32)
        futs = svc.submit_many(rows)
        got = np.stack([f.result(timeout=WAIT) for f in futs])
        dump_path = svc.dump_trace(str(tmp_path / "traces"))
    finally:
        svc.close(timeout=WAIT)
        ledger.stop_run()
    assert got.shape == (24, DIM)
    for path in (led.path, dump_path):
        ours = trace_report.summarize(trace_report.load(path))
        assert ours == ref_trace_report.summarize(ref_trace_report.load(path))
        assert ours["outcomes"].get("completed") == 24
        riders = sum(b["riders"] for tl in ours["replica_timelines"].values() for b in tl)
        assert riders == 24
    summary = obs_report.summarize(led.path)
    assert summary == ref_obs_report.summarize(led.path)
