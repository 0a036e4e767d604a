"""The port's model registry (keystone_tpu_torch/serve/registry.py)
against the JAX package's (keystone_tpu/serve/registry.py): the layout is
the reference's, so a ``CURRENT`` pointer, a ``BAD`` quarantine mark and
an artifact bundle that either package writes are read alike by the
other, and both list the same versions and pick the same next id; each
package keeps its own model payload, and the deploy walk (``load(None)``)
skips the same corrupt and quarantined versions in both.  Then the
port's own contract: strict and corrupt reads, the publish order, the
watcher's swaps, backoff and error counting.

Tolerances: none; ids, marks and bytes are compared exactly."""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models.linear import LinearMapper as JLinearMapper
from keystone_tpu.ops.stats import NormalizeRows as JNormalizeRows
from keystone_tpu.serve import registry as ref_registry
from keystone_tpu.utils import durable as ref_durable
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.ops.stats import NormalizeRows
from keystone_tpu_torch.serve import ModelRegistry, RegistryError, RegistryWatcher, serve, write_artifact_bundle
from keystone_tpu_torch.utils import durable
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline

pytestmark = pytest.mark.serve

DIM = 6
WAIT = 30.0


def _pipeline(scale: float = 2.0):
    return (Pipeline.of(NormalizeRows()) | LinearMapper(torch.eye(DIM) * scale)).fit()


def _jpipeline(scale: float = 2.0):
    return JPipeline.of(JNormalizeRows()) | JLinearMapper(jnp.asarray(np.eye(DIM, dtype=np.float32) * scale))


def _counter(name):
    return metrics.REGISTRY.counter_total(name)


def _norm(x) -> float:
    return float(np.linalg.norm(np.asarray(x)))


def _corrupt(path):
    with open(path, "r+b") as f:
        f.seek(8)
        f.write(b"\xff" * 8)


# ----------------------------------------------------------- interop
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_pointer_and_marks_read_alike(tmp_path, writer):
    """Versions published by one package, the pointer moved and a version
    quarantined by either: both read the same versions, next id, pointer
    and marks."""
    port, ref = ModelRegistry(str(tmp_path)), ref_registry.ModelRegistry(str(tmp_path))
    if writer == "port":
        for s in (2.0, 3.0, 4.0):
            port.publish(_pipeline(s))
        port.set_current("v0002")
        port.quarantine("v0003", reason="rollout rollback: error_rate")
    else:
        for s in (2.0, 3.0, 4.0):
            ref.publish(_jpipeline(s))
        ref.set_current("v0002")
        ref.quarantine("v0003", reason="rollout rollback: error_rate")
    for reg in (port, ref):
        assert reg.versions() == ["v0001", "v0002", "v0003"]
        assert reg.next_version() == "v0004"
        assert reg.current() == reg.current(strict=True) == "v0002"
        assert reg.quarantined("v0003") == "rollout rollback: error_rate"
        assert reg.quarantined("v0002") is None
    # a mark either one clears is gone for both
    (ref if writer == "port" else port).clear_quarantine("v0003")
    assert port.quarantined("v0003") is None and ref.quarantined("v0003") is None


def test_files_are_the_references_byte_for_byte(tmp_path):
    port, ref = ModelRegistry(str(tmp_path / "p")), ref_registry.ModelRegistry(str(tmp_path / "r"))
    for reg, pipe in ((port, _pipeline()), (ref, _jpipeline())):
        reg.publish(pipe)
        reg.quarantine("v0001", reason="bake rollback: burn 3.00")
    for name in ("CURRENT", "CURRENT.b2", os.path.join("v0001", "BAD"), os.path.join("v0001", "BAD.b2")):
        with open(tmp_path / "p" / name, "rb") as a, open(tmp_path / "r" / name, "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("damage", ["bytes", "sidecar"])
def test_damaged_marks_and_pointers_read_alike(tmp_path, damage):
    """A torn BAD mark still condemns its version in both packages (fail
    safe); a corrupt CURRENT is "no news", or an error under strict."""
    port, ref = ModelRegistry(str(tmp_path)), ref_registry.ModelRegistry(str(tmp_path))
    port.publish(_pipeline())
    port.quarantine("v0001", reason="x")
    target = port.bad_path("v0001") + (".b2" if damage == "sidecar" else "")
    with open(target, "w") as f:
        f.write("torn garbage")
    assert port.quarantined("v0001") == ref.quarantined("v0001") == "quarantined (mark unreadable)"
    cur = os.path.join(str(tmp_path), "CURRENT") + (".b2" if damage == "sidecar" else "")
    with open(cur, "w") as f:
        f.write("v9999")
    assert port.current() is None and ref.current() is None
    with pytest.raises(durable.CorruptStateError):
        port.current(strict=True)
    with pytest.raises(ref_durable.CorruptStateError):
        ref.current(strict=True)


# (per step: op, argument) applied to both packages' registries, each with
# its own payloads; then load(None)'s pick must agree
_SCENARIOS = {
    "current": [("publish", 2.0), ("publish", 3.0)],
    "quarantined current": [("publish", 2.0), ("publish", 3.0), ("quarantine", "v0002")],
    "corrupt current": [("publish", 2.0), ("publish", 3.0), ("corrupt", "v0002")],
    "corrupt and quarantined": [("publish", 2.0), ("publish", 3.0), ("publish", 4.0), ("corrupt", "v0003"),
                                ("quarantine", "v0002")],
    "pointer to an older version": [("publish", 2.0), ("publish", 3.0), ("publish", 4.0), ("point", "v0001"),
                                    ("corrupt", "v0001")],
    "republish clears the mark": [("publish", 2.0), ("publish", 3.0), ("quarantine", "v0002"),
                                  ("republish", "v0002")],
}


def _apply(reg, steps, make):
    for op, arg in steps:
        if op == "publish":
            reg.publish(make(arg))
        elif op == "republish":
            reg.publish(make(5.0), version=arg)
        elif op == "quarantine":
            reg.quarantine(arg, reason="drill")
        elif op == "point":
            reg.set_current(arg)
        elif op == "corrupt":
            _corrupt(reg.model_path(arg))


@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_deploy_walk_skips_alike(tmp_path, name):
    port, ref = ModelRegistry(str(tmp_path / "p")), ref_registry.ModelRegistry(str(tmp_path / "r"))
    _apply(port, _SCENARIOS[name], _pipeline)
    _apply(ref, _SCENARIOS[name], _jpipeline)
    fitted, got = port.load()
    assert got == ref.load()[1]
    assert isinstance(fitted, FittedPipeline)
    assert port.versions() == ref.versions() and port.current() == ref.current()


def test_nothing_loadable_raises_alike(tmp_path):
    port, ref = ModelRegistry(str(tmp_path / "p")), ref_registry.ModelRegistry(str(tmp_path / "r"))
    with pytest.raises(RegistryError):
        port.load()
    with pytest.raises(ref_registry.RegistryError):
        ref.load()
    _apply(port, [("publish", 2.0), ("quarantine", "v0001")], _pipeline)
    _apply(ref, [("publish", 2.0), ("quarantine", "v0001")], _jpipeline)
    with pytest.raises(RegistryError, match="no loadable version"):
        port.load()
    with pytest.raises(ref_registry.RegistryError, match="no loadable version"):
        ref.load()


def test_artifact_bundles_read_alike(tmp_path):
    """A bundle the port publishes is the reference's layout: the
    reference's reader returns the same manifest and blobs."""
    pipe = _pipeline()
    bundle = pipe.freeze(device="cpu").export_artifacts(example=np.zeros(DIM, np.float32), buckets=(2, 4))
    port = ModelRegistry(str(tmp_path))
    v = port.publish(pipe, artifacts=bundle)
    ref_loaded = ref_registry.ModelRegistry(str(tmp_path)).load_artifacts(v)
    assert ref_loaded["manifest"] == bundle["manifest"]
    assert {k: bytes(b) for k, b in ref_loaded["blobs"].items()} == bundle["blobs"]
    out = str(tmp_path / "bundle")
    write_artifact_bundle(out, bundle)
    assert sorted(os.listdir(out)) == sorted(["MANIFEST.json", "MANIFEST.json.b2", "b00002.json", "b00002.json.b2",
                                              "b00004.json", "b00004.json.b2"])


# ------------------------------------------------------- the port's registry
def test_strict_load_and_errors(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))
    v2 = reg.publish(_pipeline(3.0))
    _corrupt(reg.model_path(v2))
    with pytest.raises(durable.CorruptStateError):
        reg.load(v2)
    f0 = _counter("serve.registry_fallback")
    fitted, got = reg.load()
    assert got == v1 and _counter("serve.registry_fallback") == f0 + 1
    x = np.ones((1, DIM), np.float32)
    assert abs(_norm(fitted.freeze(device="cpu")(x).array.numpy()) - 2.0) < 1e-5
    with pytest.raises(RegistryError):
        reg.load("v0042")
    with pytest.raises(RegistryError):
        reg.publish(_pipeline(), version="latest")
    for fn in (reg.set_current, reg.quarantine):
        with pytest.raises(RegistryError):
            fn("v0042")
    with pytest.raises(RegistryError):
        reg.publish_artifacts("v0042", {"manifest": {}, "blobs": {}})
    with pytest.raises(RegistryError, match="no blob"):
        write_artifact_bundle(str(tmp_path / "b"), {"manifest": {"entries": {"b00001": {"file": "x"}}}, "blobs": {}})


def test_load_maps_the_tensors(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    reg.publish(_pipeline())
    fitted, _v = reg.load(map_location="cpu")
    tensors = [t for op in fitted.graph.operators.values() if getattr(op, "transformer", None) is not None
               for t in op.transformer.buffers()]
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_publish_lands_the_model_before_the_pointer(tmp_path, monkeypatch):
    """A crash between the model file and the pointer leaves the old
    version current and the new one published, whole."""
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))

    def crash(version):
        raise OSError("crash before the pointer moved")

    monkeypatch.setattr(reg, "set_current", crash)
    with pytest.raises(OSError):
        reg.publish(_pipeline(3.0))
    assert reg.current() == v1 and reg.versions() == [v1, "v0002"]
    assert durable.verify_checksum(reg.model_path("v0002"), required=True)


def test_watcher_swaps_when_current_moves(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))
    svc = serve(reg.load()[0], devices=["cpu"], max_batch=4, example=np.zeros(DIM, np.float32), version=v1,
                name="watch_swap")
    swaps = []
    w = RegistryWatcher(svc, reg, poll_seconds=0.05, on_swap=swaps.append).start()
    try:
        s0 = _counter("serve.watch_swaps")
        v2 = reg.publish(_pipeline(3.0))
        deadline = time.monotonic() + WAIT
        while svc.version != v2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert svc.version == v2 and swaps and swaps[-1]["version"] == v2
        assert _counter("serve.watch_swaps") == s0 + 1
        y = svc.submit(np.ones(DIM, np.float32)).result(timeout=WAIT)
        assert abs(_norm(y) - 3.0) < 1e-5
    finally:
        w.stop()
        svc.close(timeout=WAIT)


def test_watcher_counts_errors_and_backs_off(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(_pipeline(2.0))
    svc = serve(reg.load()[0], devices=["cpu"], max_batch=4, example=np.zeros(DIM, np.float32), version=v1,
                name="watch_err")
    w = RegistryWatcher(svc, reg, poll_seconds=0.05, max_backoff_seconds=1.0).start()
    try:
        e0 = _counter("serve.watch_errors")
        with open(os.path.join(reg.root, "CURRENT"), "w") as f:
            f.write("v0002")  # the sidecar no longer matches: a corrupt pointer
        deadline = time.monotonic() + WAIT
        while _counter("serve.watch_errors") < e0 + 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert _counter("serve.watch_errors") >= e0 + 2 and svc.version == v1
        assert 0.05 <= w.next_wait() <= 1.0
        reg.set_current(v1)  # repaired: the next poll succeeds
        deadline = time.monotonic() + WAIT
        while w._consecutive_errors and time.monotonic() < deadline:
            time.sleep(0.02)
        assert w._consecutive_errors == 0 and w.next_wait() == 0.05
    finally:
        w.stop()
        svc.close(timeout=WAIT)
