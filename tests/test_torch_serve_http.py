"""The port's HTTP front end (keystone_tpu_torch/serve/http.py) and
``cli serve``, against the reference's (keystone_tpu/serve/http.py):
the same requests to both front ends give the same status codes, JSON
keys and ``Retry-After`` presence; the same traffic leaves the same
``serve.*`` metric names in both registries and the same ledger span
and event names for a flush; ``python -m keystone_tpu_torch.cli serve
--device cpu`` serves a saved port model and exits 0 on SIGINT.  Every
wait is bounded (HTTP client timeouts, ``close(timeout=...)``)."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models.linear import LinearMapper as JLinearMapper
from keystone_tpu.obs import ledger as ref_ledger
from keystone_tpu.obs import metrics as ref_metrics
from keystone_tpu.ops.stats import NormalizeRows as JNormalizeRows
from keystone_tpu.serve import serve as jserve
from keystone_tpu.serve import serve_http as jserve_http
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu_torch import faults
from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.ops.stats import NormalizeRows
from keystone_tpu_torch.serve import HttpFrontend, ModelRegistry, Overloaded, serve, serve_http
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import Pipeline

pytestmark = pytest.mark.serve


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    """The reference's serve() turns on JAX's persistent compilation cache
    for the whole process unless KEYSTONE_COMPILE_CACHE says no; kept off
    here, so that these tests leave no state behind for the next test file
    a worker runs.  Both metric registries start empty: the reference's
    /statusz adds an ``ingress`` block once any earlier test in the
    process counted an ingress connection."""
    monkeypatch.setenv("KEYSTONE_COMPILE_CACHE", "0")
    ref_metrics.REGISTRY.reset()
    metrics.REGISTRY.reset()


DIM = 6
WAIT = 30
REPO = Path(__file__).resolve().parent.parent


def _pipeline(scale: float = 2.0) -> Pipeline:
    return Pipeline.of(NormalizeRows()) | LinearMapper(torch.eye(DIM) * scale)


def _jpipeline(scale: float = 2.0):
    return JPipeline.of(JNormalizeRows()) | JLinearMapper(jnp.asarray(np.eye(DIM, dtype=np.float32) * scale))


def _service(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("queue_bound", 64)
    kw.setdefault("example", np.zeros(DIM, np.float32))
    return serve(_pipeline(), devices=["cpu"], **kw)


def _call(url, payload=None, headers=None, method=None):
    """(status, body: JSON or text, headers) of one request, errors included."""
    data = None if payload is None else (payload if isinstance(payload, bytes) else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, headers=dict(headers or {}), method=method)
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            status, raw, hdrs = resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        status, raw, hdrs = e.code, e.read(), dict(e.headers)
    try:
        return status, json.loads(raw), hdrs
    except ValueError:
        return status, raw.decode(), hdrs


# ------------------------------------------------------------- endpoints
def test_http_predict_healthz_metrics():
    x = np.random.default_rng(1).normal(size=(3, DIM)).astype(np.float32)
    ref = _pipeline()(Dataset(x, device="cpu")).get().numpy()
    with _service() as svc, serve_http(svc, port=0) as front:
        base = f"http://127.0.0.1:{front.port}"
        status, body, _ = _call(base + "/predict", {"instances": x.tolist()})
        assert status == 200
        np.testing.assert_allclose(np.asarray(body["predictions"], np.float32), ref, rtol=1e-5, atol=1e-6)
        status, health, _ = _call(base + "/healthz")
        assert status == 200 and health["status"] == "ok" and health["max_batch"] == 4
        status, text, _ = _call(base + "/metrics")
        assert "serve_completed_total" in text and "serve_batch_rows_count" in text
        assert _call(base + "/nope")[0] == 404


def test_http_bad_request_and_single_instance():
    with _service() as svc, serve_http(svc, port=0) as front:
        base = f"http://127.0.0.1:{front.port}"
        assert _call(base + "/predict", b"not json at all")[0] == 400
        status, body, _ = _call(base + "/predict", {"instance": [1.0] * DIM, "deadline_ms": 5000})
        assert status == 200 and len(body["predictions"]) == 1 and len(body["predictions"][0]) == DIM


def test_http_frontend_stop_without_start_does_not_hang(tmp_path):
    with _service() as svc:
        HttpFrontend(svc, port=0).stop()
        with HttpFrontend(svc, port=0) as started:
            assert _call(f"http://127.0.0.1:{started.port}/healthz")[0] == 200
            assert _call(f"http://127.0.0.1:{started.port}/swap", {})[0] == 409  # no registry attached
        HttpFrontend(svc, port=0, registry=ModelRegistry(str(tmp_path))).stop()
        with HttpFrontend(svc, port=0, registry=ModelRegistry(str(tmp_path))) as front:
            base = f"http://127.0.0.1:{front.port}"
            assert _call(base + "/swap", {})[0] == 404  # an empty registry
            assert _call(base + "/swap", b"[1]")[0] == 400
            assert _call(base + "/rollback", {})[0] == 409  # nothing swapped yet


def test_http_429_retry_after_is_derived():
    svc = _service(max_batch=1, queue_bound=2)
    try:
        svc._ewma_batch_s = 5.0  # as if flushes were observed slow
        with serve_http(svc, port=0) as front:
            item = np.ones(DIM, np.float32)
            with faults.inject("serve.batch:delay=0.5"):
                filled = False
                for _ in range(50):
                    try:
                        svc.submit(item)
                    except Overloaded:
                        filled = True
                        break
                    time.sleep(0.01)
                assert filled
                status, body, hdrs = _call(f"http://127.0.0.1:{front.port}/predict", {"instance": item.tolist()})
        assert status == 429
        assert int(hdrs["Retry-After"]) >= 2 and body["retry_after_seconds"] > 1.0
    finally:
        svc.close(timeout=WAIT)


# ------------------------------------------------ the reference's answers
def _exchange(base):
    """One script of requests; each answer as (status, keys, Retry-After?)."""
    out = {}

    def rec(name, status, body, hdrs, nested=None):
        keys = sorted(body) if isinstance(body, dict) else type(body).__name__
        out[name] = (status, keys, "Retry-After" in hdrs)
        if nested is not None and isinstance(body, dict):
            out[name + " " + nested] = sorted(body[nested][0]) if body.get(nested) else None

    rec("predict", *_call(base + "/predict", {"instances": [[1.0] * DIM, [2.0] * DIM]},
                          headers={"X-Request-Id": "p-1"}))
    rec("predict one", *_call(base + "/predict", {"instance": [1.0] * DIM}))
    rec("not json", *_call(base + "/predict", b"{nope"))
    rec("no instances", *_call(base + "/predict", {"nope": 1}))
    rec("mis-shaped", *_call(base + "/predict", {"instance": [1.0] * (DIM + 1)}))
    rec("tenant", *_call(base + "/predict", {"instance": [1.0] * DIM, "tenant": "t1"}))
    rec("shed", *_call(base + "/predict", {"instance": [1.0] * DIM, "deadline_ms": 0.0001}))
    rec("healthz", *_call(base + "/healthz"), nested="replicas")
    rec("replicas", *_call(base + "/replicas"), nested="replicas")
    rec("statusz", *_call(base + "/statusz"))
    rec("tracez", *_call(base + "/tracez?limit=5"))
    rec("tracez full", *_call(base + "/tracez?full=1&filter=shed"))
    rec("requestz", *_call(base + "/requestz/p-1/0"))
    rec("requestz unknown", *_call(base + "/requestz/never-seen"))
    rec("metrics", *_call(base + "/metrics"))
    rec("swap", *_call(base + "/swap", {"version": "v2"}))
    rec("rollback", *_call(base + "/rollback", {}))
    rec("rolloutz", *_call(base + "/rolloutz"))
    rec("dump without dir", *_call(base + "/tracez/dump", {}))
    rec("bad path", *_call(base + "/nope"))
    rec("bad post", *_call(base + "/nope", {}))
    return out


def _full_queue(submit):
    for _ in range(200):
        try:
            submit(np.ones(DIM, np.float32))
        except Exception:
            return
        time.sleep(0.005)
    raise AssertionError("the queue never filled")


def test_same_http_answers_as_the_reference():
    """The same requests to the reference's front end and the port's:
    status codes, JSON keys (the replica statuses' too) and Retry-After
    presence agree, for 200/400/404/409/429/503/504 alike."""
    kw = dict(max_batch=4, max_wait_ms=5.0, queue_bound=64, example=np.zeros(DIM, np.float32))
    answers = {}
    for pkg in ("reference", "port"):
        svc = jserve(_jpipeline(), **kw) if pkg == "reference" else serve(_pipeline(), devices=["cpu"], **kw)
        front = (jserve_http if pkg == "reference" else serve_http)(svc, port=0)
        try:
            answers[pkg] = _exchange(f"http://127.0.0.1:{front.port}")
        finally:
            front.stop()
            svc.close(timeout=WAIT)
        # 429 and 503: a full queue, then a closed service
        tight = dict(kw, max_batch=64, max_wait_ms=10_000.0, queue_bound=1)
        svc = jserve(_jpipeline(), **tight) if pkg == "reference" else serve(_pipeline(), devices=["cpu"], **tight)
        front = (jserve_http if pkg == "reference" else serve_http)(svc, port=0)
        base = f"http://127.0.0.1:{front.port}"
        try:
            _full_queue(svc.submit)
            status, body, hdrs = _call(base + "/predict", {"instance": [1.0] * DIM})
            answers[pkg]["overloaded"] = (status, sorted(body), "Retry-After" in hdrs)
            svc.close(timeout=WAIT)
            status, body, hdrs = _call(base + "/predict", {"instance": [1.0] * DIM})
            answers[pkg]["closed"] = (status, sorted(body), "Retry-After" in hdrs)
        finally:
            front.stop()
            svc.close(timeout=WAIT)
    ref, got = answers["reference"], answers["port"]
    assert got == ref, {k: (ref[k], got.get(k)) for k in ref if got.get(k) != ref[k]}
    assert got["overloaded"][0] == 429 and got["overloaded"][2]
    assert got["shed"][0] == 504 and got["swap"][0] == 409 and got["closed"][0] == 503


def test_same_serve_metric_names_as_the_reference():
    """After the same traffic (priming, a flush, a shed, a rejection, a
    swap, HTTP) both registries hold the same ``serve.*`` names, the
    reference's AOT-artifact and process-fleet ones excepted."""

    def names(reg):
        snap = reg.snapshot()
        return {k.split("{", 1)[0] for part in snap.values() for k in part if k.startswith("serve.")}

    def traffic(svc, front):
        [f.result(timeout=WAIT) for f in svc.submit_many(np.ones((3, DIM), np.float32))]
        with pytest.raises(Exception):
            svc.submit(np.ones(DIM, np.float32), deadline=-0.01).result(timeout=WAIT)
        _call(f"http://127.0.0.1:{front.port}/predict", {"instance": [1.0] * DIM})
        svc.swap(_jpipeline(3.0) if svc.__module__.startswith("keystone_tpu.") else _pipeline(3.0))
        svc._q.extend([None] * svc.queue_bound)  # a full queue: the next submit is refused
        with pytest.raises(Exception):
            svc.submit(np.ones(DIM, np.float32))
        svc._q.clear()
        svc.status()

    kw = dict(max_batch=4, max_wait_ms=5.0, queue_bound=8, example=np.zeros(DIM, np.float32), replicas=2)
    seen = {}
    for pkg, reg in (("reference", ref_metrics.REGISTRY), ("port", metrics.REGISTRY)):
        reg.reset()
        svc = jserve(_jpipeline(), **kw) if pkg == "reference" else serve(_pipeline(), devices=["cpu"] * 2, **kw)
        front = (jserve_http if pkg == "reference" else serve_http)(svc, port=0)
        try:
            traffic(svc, front)
        finally:
            front.stop()
            svc.close(timeout=WAIT)
        seen[pkg] = names(reg)
    unported = {n for n in seen["reference"] if "artifact" in n or n.startswith(("serve.worker_", "serve.process"))}
    assert seen["port"] == seen["reference"] - unported, (seen["reference"] ^ seen["port"])


def _ledger_names(ledger_mod, run_dir):
    (path,) = [os.path.join(run_dir, p) for p in os.listdir(run_dir) if p.endswith(".jsonl")]
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    return ({e["name"] for e in lines if e["kind"] == "span_start"},
            {e["name"] for e in lines if e["kind"] == "event"})


def test_flush_ledger_names_match_the_reference(tmp_path):
    """One flush under a run ledger: the same span and event names in both
    packages' ledgers (as test_torch_obs.py holds them for fits)."""
    got = {}
    for pkg in ("reference", "port"):
        led = ref_ledger if pkg == "reference" else ledger
        run_dir = tmp_path / pkg
        led.start_run(str(run_dir))
        try:
            kw = dict(max_batch=4, max_wait_ms=5.0, example=np.zeros(DIM, np.float32))
            svc = jserve(_jpipeline(), **kw) if pkg == "reference" else serve(_pipeline(), devices=["cpu"], **kw)
            with svc:
                [f.result(timeout=WAIT) for f in svc.submit_many(np.ones((2, DIM), np.float32))]
        finally:
            led.stop_run()
        got[pkg] = _ledger_names(led, run_dir)
    assert got["port"] == got["reference"]
    spans, events = got["port"]
    assert "serve.batch" in spans and {"serve.request", "serve.prime"} <= events


# ------------------------------------------------------------------ cli
def test_cli_serve_on_the_cpu_answers_and_exits_on_sigint(tmp_path):
    model = tmp_path / "model.pt"
    fitted = _pipeline().fit()
    fitted.save(str(model))
    x = np.random.default_rng(3).normal(size=(3, DIM)).astype(np.float32)
    want = fitted(Dataset(x, device="cpu")).get().numpy()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "keystone_tpu_torch.cli", "serve", "--model", str(model), "--device", "cpu",
         "--port", "0", "--max-batch", "4", "--example-shape", str(DIM)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(tmp_path), env=env)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "serving" not in line and time.monotonic() < deadline and proc.poll() is None:
            line = proc.stdout.readline()
        assert "serving" in line, line
        base = line.split(" on ", 1)[1].split(" ", 1)[0]
        status, body, hdrs = _call(base + "/predict", {"instances": x.tolist()}, headers={"X-Request-Id": "cli-1"})
        assert status == 200 and hdrs["X-Request-Id"] == "cli-1"
        np.testing.assert_allclose(np.asarray(body["predictions"], np.float32), want, rtol=1e-5, atol=1e-6)
        assert _call(base + "/healthz")[0] == 200
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode == 0, out
    assert "shutting down" in out


@pytest.mark.parametrize("argv,item", [
    (["check"], "A10"), (["plan"], "A10"), (["serve", "--model", "a=m", "--model", "b=n"], "A11d"),
    (["serve", "--model", "m", "--tenants", "2"], "A11d"),
    (["export", "--model", "m", "--example-shape", "4", "--out", "o", "--plan"], "A10"),
])
def test_cli_refuses_what_is_not_ported(argv, item, capsys):
    from keystone_tpu_torch import cli

    assert cli.main(argv) != 0
    assert f"ROADMAP {item}" in capsys.readouterr().err


@pytest.mark.parametrize("argv,why", [
    (["worker"], "--connect"),
    (["serve", "--model", "m", "--workers", "2", "--replicas", "2"], "exclusive"),
    (["serve", "--model", "m", "--hosts", "local:2"], "--hosts needs --workers"),
    (["serve", "--model", "m", "--workers", "1", "--lease-s", "2"], "configure the --hosts fleet"),
])
def test_cli_fleet_flags_are_checked(argv, why, capsys):
    """``worker``, ``--workers``, ``--hosts`` and ``--lease-s`` are ported
    (the process and network fleets): a malformed use is an argument
    error naming what is wrong, before any model is read."""
    from keystone_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    assert why in capsys.readouterr().err


def test_cli_lists_the_ten_pipelines(capsys):
    from keystone_tpu_torch import cli

    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in ("MnistRandomFFT", "LinearPixels", "RandomPatchCifar", "NewsgroupsPipeline", "TimitPipeline",
                 "ImageNetSiftLcsFV", "VOCSIFTFisher", "AmazonReviewsPipeline", "KernelTimitPipeline",
                 "KernelCifarPipeline"):
        assert f"  {name}" in out
    assert cli.main(["NoSuchPipeline"]) == 2


def test_cli_dispatches_a_pipeline_on_the_cpu(tmp_path, monkeypatch, capsys):
    """A pipeline name runs that pipeline's main with the rest of the
    flags; KEYSTONE_STATE_DIR sets the saved-state directory first."""
    from keystone_tpu_torch import cli
    from keystone_tpu_torch.workflow.pipeline import PipelineEnv

    monkeypatch.setenv("KEYSTONE_STATE_DIR", str(tmp_path / "state"))
    monkeypatch.setattr(PipelineEnv, "state_dir", None)
    assert cli.main(["MnistRandomFFT", "--synthetic-n", "128", "--num-ffts", "1", "--device", "cpu"]) == 0
    assert "'pipeline': 'MnistRandomFFT'" in capsys.readouterr().out
    assert PipelineEnv.state_dir == str(tmp_path / "state")


@pytest.mark.parametrize("argv", [
    ["serve", "--model", "m", "--watch", "5"],
    ["serve", "--model-dir", "d", "--canary", "0.5"],
    ["serve", "--model-dir", "d", "--watch", "1", "--bake-s", "2"],
    ["serve", "--model", "m", "--autoscale", "two"],
    ["serve"],
])
def test_cli_serve_checks_its_lifecycle_flags(argv, capsys):
    """The reference's argument checks: --watch needs --model-dir, --canary
    needs --watch, --bake-s needs --canary, --autoscale takes MIN:MAX."""
    from keystone_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2 and "error:" in capsys.readouterr().err


def test_cli_serve_from_a_registry_watches_a_guarded_publish(tmp_path):
    """``cli serve --model-dir --watch --canary --autoscale`` on the CPU:
    serves the registry's current version (its bundle refused as backend
    skew, the walk serving), a new publish is canaried and committed under
    traffic, CURRENT follows, POST /rollback returns to the first version,
    and SIGINT exits 0."""
    from keystone_tpu_torch.serve import ModelRegistry

    reg = ModelRegistry(str(tmp_path / "reg"))
    first = _pipeline().fit()
    v1 = reg.publish(first, artifacts=first.freeze(device="cpu").export_artifacts(example=np.zeros(DIM, np.float32),
                                                                                  buckets=(4,)))
    second = (Pipeline.of(NormalizeRows()) | LinearMapper(torch.eye(DIM) * 3.0)).fit()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "keystone_tpu_torch.cli", "serve", "--model-dir", reg.root, "--device", "cpu",
         "--port", "0", "--max-batch", "4", "--max-wait-ms", "1", "--example-shape", str(DIM), "--watch", "0.05",
         "--canary", "1.0", "--bake-s", "0.2", "--autoscale", "1:2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(tmp_path), env=env)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "serving" not in line and time.monotonic() < deadline and proc.poll() is None:
            line = proc.stdout.readline()
        assert "serving" in line and "artifacts on" in line and "canary 1" in line, line
        base = line.split(" on ", 1)[1].split(" ", 1)[0]
        x = np.ones((1, DIM), np.float32)

        def norm():
            status, body, _ = _call(base + "/predict", {"instances": x.tolist()})
            assert status == 200, body
            return float(np.linalg.norm(body["predictions"][0]))

        assert abs(norm() - 2.0) < 1e-5
        reg.publish(second)
        deadline = time.monotonic() + 60
        while reg.current() != "v0002" or _call(base + "/statusz")[1]["version"] != "v0002":
            assert time.monotonic() < deadline, _call(base + "/rolloutz")[1]
            norm()  # the canary's samples
        assert abs(norm() - 3.0) < 1e-5
        hist = _call(base + "/rolloutz")[1]["history"]
        assert hist[-1]["version"] == "v0002" and hist[-1]["verdict"] == "committed"
        status, info, _ = _call(base + "/rollback", {})
        assert status == 200 and info["rolled_back_to"] == v1 and reg.current() == v1
        assert abs(norm() - 2.0) < 1e-5
        st = _call(base + "/statusz")[1]
        assert st["autoscaler"]["max_workers"] == 2 and st["artifacts"]["installed_buckets"] == 0
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode == 0, out
    assert "graph replay launches {}" in out
