"""The frozen applier's artifact tier on the CPU (the port's counterparts
of the reference's tests/test_artifacts.py): the bundle's manifest and
what an install refuses (format, torch or CUDA version, a CPU applier
("backend skew": a CUDA graph needs the card), compute capability,
kernel sources, signature drift, a blob that does not match its entry),
each counted as ``serve.artifact_fallbacks`` while the walk serves bit
for bit; the registry's corrupt-tolerant read of a bundle and the
``serve.artifact_load`` fault site; a bucket program's contract with an
injected program (a failing one dropped and counted, the deadline
contract, streams, host and masked batches and other shapes never
reaching it); pickled and deep-copied appliers; the fingerprint;
``serve(artifacts=)``, ``swap(artifacts=)``, the watcher and the
supervisor's heal carrying the bundle; ``cli export``.

The reference's four compile-cache cases have no counterpart: the port
has no compile cache (ROADMAP's "Not to port").  Capture and replay run
on the card only (tests/test_torch_artifacts_cuda.py).  Tolerances:
none; the walk's rows are compared byte for byte."""

import copy
import json
import os
import pickle
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch import cli, faults
from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.ops.stats import NormalizeRows
from keystone_tpu_torch.serve import ModelRegistry, RegistryWatcher, serve
from keystone_tpu_torch.utils import guard
from keystone_tpu_torch.utils.hashing import _stable_repr, array_fingerprint, fitted_tensors, pipeline_fingerprint
from keystone_tpu_torch.workflow import pipeline as pipeline_mod
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.pipeline import ArtifactMismatch, FittedPipeline, FrozenApplier, Pipeline

pytestmark = pytest.mark.serve

DIM = 8
CLASSES = 3
BUCKETS = (2, 4)
WAIT = 30.0
_H100 = {"type": "cuda", "name": "NVIDIA H100 80GB HBM3", "capability": [9, 0]}


def _pipeline(seed: int = 0):
    w = torch.from_numpy(np.random.default_rng(seed).normal(size=(DIM, CLASSES)).astype(np.float32))
    return (Pipeline.of(NormalizeRows()) | LinearMapper(w)).fit()


def _example():
    return np.zeros((DIM,), np.float32)


def _ds(x):
    return Dataset(np.asarray(x, np.float32), device="cpu")


def _counter(name):
    return metrics.REGISTRY.counter_total(name)


def _prime_count(source):
    h = metrics.REGISTRY.histogram_value("serve.prime_seconds", source=source) or {}
    return int(h.get("count") or 0)


@pytest.fixture(scope="module")
def exported():
    pipe = _pipeline()
    frozen = pipe.freeze(device="cpu")
    return pipe, frozen, frozen.export_artifacts(example=_example(), buckets=BUCKETS)


@pytest.fixture()
def registry(tmp_path, exported):
    pipe, _frozen, bundle = exported
    reg = ModelRegistry(str(tmp_path / "registry"))
    return reg, reg.publish(pipe, artifacts=bundle)


@pytest.fixture()
def on_a_card(monkeypatch):
    """An applier that believes it serves on an H100: the install's checks
    past the backend reach the capability, the kernels and the signature."""
    monkeypatch.setattr(pipeline_mod, "_device_info", lambda dev: dict(_H100) if dev.type == "cuda" else
                        {"type": dev.type, "name": dev.type, "capability": None})


def _card_bundle(bundle, **manifest):
    return {"manifest": {**bundle["manifest"], "cuda_version": torch.version.cuda, "device": dict(_H100),
                         **manifest}, "blobs": dict(bundle["blobs"])}


# ------------------------------------------------------------ the manifest
def test_manifest_keys_the_bucket_graphs(exported):
    from keystone_tpu_torch.kernels.build import source_hashes

    _pipe, frozen, bundle = exported
    man = bundle["manifest"]
    assert man["format"] == FrozenApplier.ARTIFACT_FORMAT and man["torch_version"] == torch.__version__
    assert man["cuda_version"] == torch.version.cuda and man["device"] == {"type": "cpu", "name": "cpu",
                                                                          "capability": None}
    assert man["kernels"] == source_hashes() and set(man["kernels"]) >= {"fisher", "gram"}
    assert man["signature"] == frozen.fingerprint()
    assert man["buckets"] == list(BUCKETS) and man["item_shape"] == [DIM] and man["dtype"] == "float32"
    assert set(man["entries"]) == set(bundle["blobs"]) == {"b00002", "b00004"}
    assert json.loads(bundle["blobs"]["b00004"]) == {"rows": 4, "item_shape": [DIM], "dtype": "float32"}
    with pytest.raises(ValueError):
        frozen.export_artifacts()
    with pytest.raises(ValueError):
        frozen.export_artifacts(example=_example(), buckets=(0,))


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("field,value,why", [
    ("format", 99, "unknown artifact format"),
    ("torch_version", "0.0.1", "torch version skew"),
    ("cuda_version", "1.0", "CUDA version skew"),
])
def test_version_skew_is_refused_and_counted(exported, field, value, why):
    pipe, _frozen, bundle = exported
    skewed = {"manifest": {**bundle["manifest"], field: value}, "blobs": bundle["blobs"]}
    ap = pipe.freeze(device="cpu")
    f0 = _counter("serve.artifact_fallbacks")
    assert ap.install_artifacts(skewed) == 0 and ap.installed_buckets() == 0
    assert _counter("serve.artifact_fallbacks") == f0 + 1
    with pytest.raises(ArtifactMismatch, match=why):
        ap.install_artifacts(skewed, strict=True)


def test_backend_skew_on_the_cpu_walks_bit_for_bit(exported):
    """A CPU applier refuses every bundle (a CUDA graph needs the card),
    counts it, and serves the walk's bytes."""
    pipe, _frozen, bundle = exported
    ap, fresh = pipe.freeze(device="cpu"), pipe.freeze(device="cpu")
    f0 = _counter("serve.artifact_fallbacks")
    assert ap.install_artifacts(bundle) == 0
    assert _counter("serve.artifact_fallbacks") == f0 + 1
    with pytest.raises(ArtifactMismatch, match="backend skew"):
        ap.install_artifacts(bundle, strict=True)
    rng = np.random.default_rng(1)
    for b in BUCKETS:
        x = rng.normal(size=(b, DIM)).astype(np.float32)
        assert ap(_ds(x)).array.numpy().tobytes() == fresh(_ds(x)).array.numpy().tobytes()


@pytest.mark.parametrize("manifest,why", [
    ({"device": {**_H100, "capability": [8, 0]}}, "compute capability skew"),
    ({"kernels": {"fisher": "0" * 16}}, "kernel source skew"),
    ({"signature": "f" * 32}, "pipeline signature drift"),
])
def test_card_skew_is_refused(exported, on_a_card, manifest, why):
    pipe, _frozen, bundle = exported
    ap = pipe.freeze(device="cpu")
    f0 = _counter("serve.artifact_fallbacks")
    assert ap.install_artifacts(_card_bundle(bundle, **manifest), device="cuda") == 0
    assert _counter("serve.artifact_fallbacks") == f0 + 1
    with pytest.raises(ArtifactMismatch, match=why):
        ap.install_artifacts(_card_bundle(bundle, **manifest), device="cuda", strict=True)


def test_signature_drift_of_other_weights(exported, on_a_card):
    """Another pipeline's bundle (other weights) is never installed."""
    _pipe, _frozen, bundle = exported
    other = _pipeline(seed=9).freeze(device="cpu")
    with pytest.raises(ArtifactMismatch, match="signature drift"):
        other.install_artifacts(_card_bundle(bundle), device="cuda", strict=True)


def test_a_matching_bundle_registers_one_program_a_bucket(exported, on_a_card):
    pipe, _frozen, bundle = exported
    ap = pipe.freeze(device="cpu")
    assert ap.install_artifacts(_card_bundle(bundle), device="cuda") == len(BUCKETS)
    assert ap.installed_buckets() == len(BUCKETS) and ap.installed_bundle is not None
    assert ap.has_bucket_program((2, DIM), np.float32) and not ap.has_bucket_program((3, DIM), np.float32)
    assert ap.graph_stats() == {b: {"captured": False, "replays": 0, "launches": {}, "pool_bytes": 0}
                                for b in BUCKETS}
    # a blob that does not match its entry drops its bucket, counted
    bad = _card_bundle(bundle)
    bad["blobs"]["b00002"] = json.dumps({"rows": 3, "item_shape": [DIM], "dtype": "float32"}).encode()
    f0 = _counter("serve.artifact_fallbacks")
    ap2 = pipe.freeze(device="cpu")
    assert ap2.install_artifacts(bad, device="cuda") == 1
    assert _counter("serve.artifact_fallbacks") == f0 + 1
    with pytest.raises(ArtifactMismatch, match="does not match"):
        pipe.freeze(device="cpu").install_artifacts(bad, device="cuda", strict=True)


# ----------------------------------------------------- the registry's read
def test_registry_artifacts_roundtrip(registry, exported):
    _pipe, _frozen, bundle = exported
    reg, version = registry
    loaded = reg.load_artifacts(version)
    assert loaded["manifest"] == bundle["manifest"]
    assert {k: bytes(v) for k, v in loaded["blobs"].items()} == bundle["blobs"]


def test_corrupt_blob_drops_its_bucket(registry):
    reg, version = registry
    with open(os.path.join(reg.artifacts_dir(version), "b00002.json"), "r+b") as f:
        f.seek(3)
        f.write(b"\xff" * 4)
    f0 = _counter("serve.artifact_fallbacks")
    loaded = reg.load_artifacts(version)
    assert _counter("serve.artifact_fallbacks") == f0 + 1
    assert "b00002" not in loaded["blobs"] and "b00004" in loaded["blobs"]


def test_corrupt_manifest_drops_the_whole_tier(registry):
    reg, version = registry
    with open(os.path.join(reg.artifacts_dir(version), "MANIFEST.json"), "r+b") as f:
        f.seek(2)
        f.write(b"\x00\x00")
    f0 = _counter("serve.artifact_fallbacks")
    assert reg.load_artifacts(version) is None
    assert _counter("serve.artifact_fallbacks") == f0 + 1


def test_artifact_load_fault_site_degrades(registry):
    reg, version = registry
    with faults.inject("serve.artifact_load:raise"):
        assert reg.load_artifacts(version) is None
    assert reg.load_artifacts(version) is not None


def test_a_version_without_artifacts_has_none(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    assert reg.load_artifacts(reg.publish(_pipeline())) is None


# ------------------------------------------------- the bucket program's call
def _with_program(exported, fn, key=((BUCKETS[0], DIM), "float32")):
    pipe, _frozen, _bundle = exported
    ap = pipe.freeze(device="cpu")
    ap._bucket_programs[key] = fn
    return ap, key


def test_a_program_serves_its_exact_shape_only(exported):
    calls = []

    def program(x):
        calls.append(tuple(x.shape))
        return torch.full((x.shape[0], CLASSES), 7.0)

    ap, _ = _with_program(exported, program)
    x = np.ones((BUCKETS[0], DIM), np.float32)
    out = ap(_ds(x))
    assert calls == [(BUCKETS[0], DIM)] and out.n == BUCKETS[0] and float(out.array[0, 0]) == 7.0
    # another shape, another dtype, a mask, a host list: the walk
    assert ap(_ds(np.ones((3, DIM)))).array.shape == (3, CLASSES)
    assert ap(Dataset(torch.ones(BUCKETS[0], DIM, dtype=torch.float64), device="cpu")).array.shape == (2, CLASSES)
    masked = Dataset(np.ones((BUCKETS[0], DIM), np.float32), mask=np.ones(BUCKETS[0], np.float32), device="cpu")
    ap(masked)
    assert calls == [(BUCKETS[0], DIM)]


def test_a_failing_program_is_dropped_and_counted(exported):
    def boom(x):
        raise RuntimeError("poisoned program")

    ap, key = _with_program(exported, boom)
    f0 = _counter("serve.artifact_fallbacks")
    x = np.random.default_rng(3).normal(size=(BUCKETS[0], DIM)).astype(np.float32)
    out = ap(_ds(x))
    assert out.array.shape == (BUCKETS[0], CLASSES)
    assert out.array.numpy().tobytes() == exported[0].freeze(device="cpu")(_ds(x)).array.numpy().tobytes()
    assert key not in ap._bucket_programs and _counter("serve.artifact_fallbacks") == f0 + 1
    ap(_ds(x))  # dropped for good: not retried, not counted again
    assert _counter("serve.artifact_fallbacks") == f0 + 1


def test_deadline_contract_keeps_the_program(exported):
    def program(x):
        time.sleep(0.05)
        return torch.zeros(x.shape[0], CLASSES)

    ap, key = _with_program(exported, program)
    x = np.ones((BUCKETS[0], DIM), np.float32)
    plain = ap(_ds(x)).array.numpy()
    assert ap(_ds(x), deadline=30.0).array.numpy().tobytes() == plain.tobytes()
    with pytest.raises(guard.DeadlineExceeded):
        ap(_ds(x), deadline=guard.Deadline.after(0.001))
    assert key in ap._bucket_programs


def test_an_uncaptured_graph_never_runs_under_a_deadline(exported):
    class Uncaptured:
        captured = False

        def __call__(self, x):
            raise AssertionError("a capture under the watchdog")

    ap, key = _with_program(exported, Uncaptured())
    x = np.ones((BUCKETS[0], DIM), np.float32)
    assert ap(_ds(x), deadline=30.0).array.shape == (BUCKETS[0], CLASSES)
    assert key in ap._bucket_programs


def test_a_degradable_pipeline_walks_deadline_carrying_calls(exported):
    head = NormalizeRows()
    head.optional = True
    w = torch.from_numpy(np.random.default_rng(13).normal(size=(DIM, CLASSES)).astype(np.float32))
    ap = (Pipeline.of(head) | LinearMapper(w)).fit().freeze(device="cpu")
    assert ap._degradable
    calls = []
    ap._bucket_programs[((BUCKETS[0], DIM), "float32")] = lambda x: calls.append(1) or torch.zeros(2, CLASSES)
    x = np.ones((BUCKETS[0], DIM), np.float32)
    ap(_ds(x), deadline=30.0)
    assert calls == []
    ap(_ds(x))
    assert calls == [1]


def test_stream_dataset_never_reaches_a_program(exported):
    def boom(x):
        raise RuntimeError("a program ran on a stream")

    ap, _ = _with_program(exported, boom)
    xs = np.random.default_rng(12).normal(size=(BUCKETS[0], DIM)).astype(np.float32)
    f0 = _counter("serve.artifact_fallbacks")
    out = ap(StreamDataset(lambda: iter([xs]), n=BUCKETS[0], device="cpu"))
    vals = np.concatenate([np.asarray(b) for b in out.batches()])
    assert vals.shape == (BUCKETS[0], CLASSES) and _counter("serve.artifact_fallbacks") == f0
    assert ap.installed_buckets() == 1


def test_no_artifacts_is_inert(exported):
    ap = exported[0].freeze(device="cpu")
    assert ap.installed_buckets() == 0 and ap.installed_bundle is None and ap.graph_stats() == {}
    assert ap(_ds(np.ones((BUCKETS[0], DIM)))).array.shape == (BUCKETS[0], CLASSES)


@pytest.mark.parametrize("clone", ["pickle", "deepcopy"])
def test_clones_drop_the_programs_and_keep_the_bundle(exported, on_a_card, clone):
    pipe, _frozen, bundle = exported
    ap = pipe.freeze(device="cpu")
    assert ap.install_artifacts(_card_bundle(bundle), device="cuda") == len(BUCKETS)
    twin = pickle.loads(pickle.dumps(ap)) if clone == "pickle" else copy.deepcopy(ap)
    assert twin.installed_buckets() == 0 and ap.installed_buckets() == len(BUCKETS)
    assert twin.installed_bundle["manifest"]["signature"] == ap.fingerprint()
    assert twin.install_artifacts(twin.installed_bundle, device="cuda") == len(BUCKETS)
    x = np.ones((3, DIM), np.float32)
    assert twin(_ds(x)).array.numpy().tobytes() == ap(_ds(x)).array.numpy().tobytes()


# -------------------------------------------------------------- fingerprint
def test_fingerprint_changes_with_any_weight_byte_and_survives_save_and_load(tmp_path):
    pipe = _pipeline()
    fp = pipeline_fingerprint(pipe)
    assert fp == pipe.freeze(device="cpu").fingerprint() == pipeline_fingerprint(_pipeline())
    path = str(tmp_path / "m.pt")
    pipe.save(path)
    assert pipeline_fingerprint(FittedPipeline.load(path)) == fp
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(DIM, CLASSES)).astype(np.float32))
    w.view(torch.int32)[1, 2] ^= 1  # one bit of one weight
    assert pipeline_fingerprint((Pipeline.of(NormalizeRows()) | LinearMapper(w)).fit()) != fp
    # an in-place update of a fitted tensor invalidates the cached digest
    weights = []
    for op in pipe.graph.operators.values():
        fitted_tensors(getattr(op, "transformer", None), weights.append)
    assert weights
    weights[0].add_(1.0)
    assert pipeline_fingerprint(pipe) != fp


def test_stable_repr_collapses_only_the_offending_element():
    class Opaque:
        pass

    a, b = _stable_repr((0.5, Opaque())), _stable_repr((0.7, Opaque()))
    assert a != b and "0x" not in a
    assert _stable_repr((1, 1 << 41)) == _stable_repr((1, 1 << 42)) != _stable_repr((2, 1 << 41))
    assert array_fingerprint(torch.ones(3)) == array_fingerprint(torch.ones(3))
    assert array_fingerprint(torch.ones(3)) != array_fingerprint(torch.ones(3, dtype=torch.float64))


# ------------------------------------------------------------------ serving
def _served(x, **kw):
    kw.setdefault("max_batch", BUCKETS[-1])
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("example", _example())
    kw.setdefault("devices", ["cpu"])
    kw.setdefault("supervise", False)
    svc = serve(_pipeline(), **kw)
    try:
        return np.asarray(svc.submit(x).result(timeout=WAIT)), svc.status()
    finally:
        svc.close(timeout=WAIT)


def test_serve_with_artifacts_on_the_cpu_walks_bit_for_bit(registry):
    reg, version = registry
    arts = reg.load_artifacts(version)
    x = np.random.default_rng(4).normal(size=(DIM,)).astype(np.float32)
    f0, m0 = _counter("serve.artifact_fallbacks"), _counter("serve.artifact_misses")
    y_art, st = _served(x, artifacts=arts, name="art_serve")
    assert _counter("serve.artifact_fallbacks") == f0 + 1  # the one replica's install
    assert _counter("serve.artifact_misses") == m0 + len(BUCKETS)
    assert st["artifacts"]["configured"] is True and st["artifacts"]["installed_buckets"] == 0
    y_cmp, st2 = _served(x, name="cmp_serve")
    assert st2["artifacts"]["configured"] is False
    assert y_art.tobytes() == y_cmp.tobytes()


def test_swap_carries_the_new_bundle_and_survives_a_damaged_one(registry):
    reg, version = registry
    fitted, v = reg.load()
    svc = serve(fitted, max_batch=BUCKETS[-1], buckets=BUCKETS, example=_example(), name="swap_art",
                supervise=False, devices=["cpu", "cpu"], replicas=2, artifacts=reg.load_artifacts(v))
    try:
        new_pipe = _pipeline(seed=5)
        v2 = reg.publish(new_pipe, artifacts=new_pipe.freeze(device="cpu").export_artifacts(example=_example(),
                                                                                              buckets=BUCKETS))
        f0 = _counter("serve.artifact_fallbacks")
        info = svc.swap(new_pipe, version=v2, artifacts=reg.load_artifacts(v2))
        assert info["version"] == v2 and svc._pool.has_artifacts
        assert _counter("serve.artifact_fallbacks") == f0 + 2  # each staged replica tried it
        for name in os.listdir(reg.artifacts_dir(v2)):
            if name.endswith(".json") and name != "MANIFEST.json":
                with open(os.path.join(reg.artifacts_dir(v2), name), "r+b") as f:
                    f.write(b"\xff" * 4)
        assert reg.load_artifacts(v2) is None  # every blob skipped
        m0 = _counter("serve.artifact_misses")
        assert svc.swap(new_pipe, version="v9", artifacts=None)["version"] == "v9"
        assert not svc._pool.has_artifacts
        assert _counter("serve.artifact_misses") == m0  # a bundle-less generation misses nothing
        x = np.random.default_rng(6).normal(size=(DIM,)).astype(np.float32)
        assert np.all(np.isfinite(np.asarray(svc.submit(x).result(timeout=WAIT))))
    finally:
        svc.close(timeout=WAIT)


def test_watcher_swap_ships_artifacts(registry):
    reg, version = registry
    fitted, _v = reg.load()
    svc = serve(fitted, max_batch=BUCKETS[-1], buckets=BUCKETS, example=_example(), name="watch_art",
                supervise=False, devices=["cpu"], version=version)
    try:
        new_pipe = _pipeline(seed=7)
        v2 = reg.publish(new_pipe, artifacts=new_pipe.freeze(device="cpu").export_artifacts(example=_example(),
                                                                                              buckets=BUCKETS))
        f0 = _counter("serve.artifact_fallbacks")
        RegistryWatcher(svc, reg, poll_seconds=60.0)._poll_once()
        assert svc.version == v2 and svc._pool.has_artifacts
        assert _counter("serve.artifact_fallbacks") == f0 + 1  # the staged replica's install
    finally:
        svc.close(timeout=WAIT)


def test_supervisor_heal_carries_the_bundle(registry):
    reg, version = registry
    fitted, v = reg.load()
    svc = serve(fitted, max_batch=BUCKETS[-1], buckets=BUCKETS, example=_example(), name="heal_art", replicas=2,
                devices=["cpu", "cpu"], supervise=True, supervise_interval_s=0.05, artifacts=reg.load_artifacts(v))
    x = np.random.default_rng(8).normal(size=(DIM,)).astype(np.float32)
    try:
        svc.submit(x).result(timeout=WAIT)
        f0 = _counter("serve.artifact_fallbacks")
        with faults.inject("serve.worker:ctx.replica=0:raise:times=1"):
            deadline = time.monotonic() + WAIT
            while svc.supervisor.restarts_total < 1 and time.monotonic() < deadline:
                try:
                    svc.submit(x).result(timeout=10)
                except Exception:
                    pass
                time.sleep(0.01)
        assert svc.supervisor.restarts_total >= 1
        assert _counter("serve.artifact_fallbacks") >= f0 + 1  # the replacement installed the pool's bundle
        assert np.all(np.isfinite(np.asarray(svc.submit(x).result(timeout=WAIT))))
    finally:
        svc.close(timeout=WAIT)


def test_fleet_install_fault_site_degrades(registry):
    reg, version = registry
    fitted, v = reg.load()
    f0 = _counter("serve.artifact_fallbacks")
    with faults.inject("serve.artifact_load:raise"):
        y, st = _served(np.ones(DIM, np.float32), artifacts=reg.load_artifacts(v), name="fault_art")
    assert _counter("serve.artifact_fallbacks") >= f0 + 1 and np.all(np.isfinite(y))


# ---------------------------------------------------------------------- cli
def test_cli_export_writes_a_bundle_dir(tmp_path, exported, capsys):
    pipe, _frozen, _bundle = exported
    model = str(tmp_path / "model.pt")
    pipe.save(model)
    out_dir = str(tmp_path / "bundle")
    rc = cli.main(["export", "--model", model, "--example-shape", str(DIM), "--buckets",
                   ",".join(str(b) for b in BUCKETS), "--out", out_dir, "--device", "cpu"])
    assert rc == 0 and "wrote bundle" in capsys.readouterr().out
    man = json.loads(open(os.path.join(out_dir, "MANIFEST.json")).read())
    assert man["buckets"] == list(BUCKETS) and man["signature"] == pipeline_fingerprint(pipe)
    for ent in man["entries"].values():
        blob = os.path.join(out_dir, ent["file"])
        assert os.path.exists(blob) and os.path.exists(blob + ".b2")


def test_cli_export_publishes_a_registry_version(tmp_path, exported):
    pipe, _frozen, _bundle = exported
    model = str(tmp_path / "model.pt")
    pipe.save(model)
    root = str(tmp_path / "reg")
    assert cli.main(["export", "--model", model, "--model-dir", root, "--example-shape", str(DIM), "--dtype",
                     "float32", "--buckets", ",".join(str(b) for b in BUCKETS), "--device", "cpu"]) == 0
    reg = ModelRegistry(root)
    fitted, version = reg.load()
    arts = reg.load_artifacts(version)
    assert arts is not None and len(arts["blobs"]) == len(BUCKETS)
    assert arts["manifest"]["signature"] == fitted.freeze(device="cpu").fingerprint()
    # without --model: the bundle is attached to the current version
    assert cli.main(["export", "--model-dir", root, "--example-shape", str(DIM), "--max-batch", "8",
                     "--device", "cpu"]) == 0
    assert reg.versions() == [version] and reg.load_artifacts(version)["manifest"]["buckets"] == [8]


@pytest.mark.parametrize("argv", [["--plan"], ["--plan-seed", "3"]])
def test_cli_export_refuses_the_planner(tmp_path, argv, capsys):
    assert cli.main(["export", "--model", "m", "--example-shape", "8", "--out", str(tmp_path)] + argv) == 2
    assert "ROADMAP A10" in capsys.readouterr().err
