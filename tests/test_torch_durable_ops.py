"""The port's durable-state layer (keystone_tpu_torch/utils/durable.py)
against the JAX package's (keystone_tpu/utils/durable.py): the reference's
scenarios (tests/test_durable.py), the same backoff delays and checksums,
and either package loading the other's checkpoint files, sidecars,
rotated copies and quarantined files included."""

import os

import numpy as np
import pytest

from keystone_tpu.utils import durable as ref_durable
from keystone_tpu_torch import faults
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.utils import durable
from keystone_tpu_torch.utils.durable import CorruptStateError


def _flip_middle_byte(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("writer,reader", [(durable, ref_durable), (ref_durable, durable)])
def test_either_package_reads_the_others_checkpoints(tmp_path, writer, reader):
    path = str(tmp_path / "ckpt.npz")
    rng = np.random.default_rng(0)
    epochs = [{"epoch": np.asarray(e), "w": rng.normal(size=(3, 4)).astype(np.float32), "problem": "p"}
              for e in range(3)]
    for a in epochs:
        writer.save_npz(path, a, keep=2)
    assert writer.compute_checksum(path) == reader.compute_checksum(path)
    assert reader.verify_checksum(path) and reader.verify_checksum(path + ".1")
    z, used = reader.load_npz(path, validate=lambda z: str(z["problem"]) == "p")
    assert used == path and int(z["epoch"]) == 2
    np.testing.assert_array_equal(z["w"], epochs[2]["w"])
    _flip_middle_byte(path)
    z, used = reader.load_npz(path)
    assert used == path + ".1" and int(z["epoch"]) == 1
    assert reader.quarantine(path) == path + ".corrupt"
    assert os.path.exists(path + ".corrupt" + durable.CHECKSUM_SUFFIX)


def test_backoff_delays_are_the_references():
    for seed in (0, 3, 11):
        assert list(durable.backoff_delays(6, seed=seed)) == list(ref_durable.backoff_delays(6, seed=seed))
        assert (list(durable.backoff_delays(4, 0.1, 2.0, seed=seed))
                == list(ref_durable.backoff_delays(4, 0.1, 2.0, seed=seed)))


def test_save_load_round_trip_with_checksum(tmp_path):
    path = str(tmp_path / "state.npz")
    arrays = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "it": np.int32(7)}
    durable.save_npz(path, arrays)
    assert os.path.exists(durable.checksum_path(path))
    z, used = durable.load_npz(path)
    assert used == path
    np.testing.assert_array_equal(z["w"], arrays["w"])
    assert int(z["it"]) == 7


def test_checksum_verification_catches_corruption(tmp_path):
    path = str(tmp_path / "state.npz")
    durable.save_npz(path, {"w": np.ones(64, np.float32)})
    _flip_middle_byte(path)
    metrics.reset()
    with pytest.raises(CorruptStateError, match="checksum mismatch"):
        durable.verify_checksum(path)
    assert metrics.REGISTRY.counter_value("durable.corruption") == 1


def test_missing_sidecar_is_legacy_pass(tmp_path):
    path = str(tmp_path / "old.npz")
    with open(path, "wb") as f:
        np.savez(f, w=np.zeros(3))
    assert durable.verify_checksum(path) is False
    with pytest.raises(CorruptStateError, match="missing checksum"):
        durable.verify_checksum(path, required=True)
    assert durable.load_npz(path) is not None


def test_corrupt_newest_falls_back_to_last_good(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    durable.save_npz(path, {"epoch": np.asarray(0)}, keep=2)
    durable.save_npz(path, {"epoch": np.asarray(1)}, keep=2)
    assert os.path.exists(path + ".1")
    _flip_middle_byte(path)
    metrics.reset()
    z, used = durable.load_npz(path)
    assert used == path + ".1" and int(z["epoch"]) == 0
    assert metrics.REGISTRY.counter_value("durable.skipped_corrupt") == 1
    assert metrics.REGISTRY.counter_value("durable.fallback") == 1


def test_all_candidates_corrupt_returns_none(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    durable.save_npz(path, {"epoch": np.asarray(0)}, keep=2)
    durable.save_npz(path, {"epoch": np.asarray(1)}, keep=2)
    _flip_middle_byte(path)
    _flip_middle_byte(path + ".1")
    assert durable.load_npz(path) is None


def test_validator_rejection_scans_deeper(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    durable.save_npz(path, {"tag": np.asarray("good")}, keep=2)
    durable.save_npz(path, {"tag": np.asarray("stale")}, keep=2)
    _, used = durable.load_npz(path, validate=lambda z: str(z["tag"]) == "good")
    assert used == path + ".1"
    # a validator that raises rejects its candidate, it does not crash the scan
    _, used = durable.load_npz(path, validate=lambda z: 1 / 0 if str(z["tag"]) == "stale" else True)
    assert used == path + ".1"


def test_retention_keeps_exactly_n_and_prunes_on_shrink(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    for e in range(6):
        durable.save_npz(path, {"epoch": np.asarray(e)}, keep=3)
    names = sorted(f for f in os.listdir(tmp_path) if not f.endswith(durable.CHECKSUM_SUFFIX))
    assert names == ["ckpt.npz", "ckpt.npz.1", "ckpt.npz.2"]
    assert int(durable.load_npz(path)[0]["epoch"]) == 5
    assert int(durable.load_npz(path + ".2")[0]["epoch"]) == 3
    durable.save_npz(path, {"epoch": np.asarray(6)}, keep=2)  # retention shrinks
    names = sorted(f for f in os.listdir(tmp_path) if not f.endswith(durable.CHECKSUM_SUFFIX))
    assert names == ["ckpt.npz", "ckpt.npz.1"]


def test_atomic_write_never_publishes_partial(tmp_path):
    path = str(tmp_path / "state.npz")
    durable.save_npz(path, {"w": np.zeros(8)})
    before = durable.compute_checksum(path)

    def exploding(tmp):
        with open(tmp, "wb") as f:
            f.write(b"partial garbage")
        raise RuntimeError("crash mid-write")

    with pytest.raises(RuntimeError, match="crash mid-write"):
        durable.atomic_write(path, exploding)
    assert durable.compute_checksum(path) == before
    durable.verify_checksum(path)


def test_with_retries_backoff_and_budget():
    calls = {"n": 0}
    naps = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    metrics.reset()
    assert durable.with_retries(flaky, retries=3, sleep=naps.append) == "ok"
    assert calls["n"] == 3 and len(naps) == 2 and naps[1] > naps[0] * 1.2
    assert metrics.REGISTRY.counter_value("durable.retries") == 2
    calls["n"] = -10
    with pytest.raises(OSError):
        durable.with_retries(flaky, retries=2, sleep=lambda _: None)


def test_io_retries_knob(monkeypatch):
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise OSError("down")

    monkeypatch.setenv("KEYSTONE_IO_RETRIES", "4")
    with pytest.raises(OSError):
        durable.with_retries(always, sleep=lambda _: None)
    assert calls["n"] == 5


def test_with_retries_never_retries_corruption():
    calls = {"n": 0}

    def corrupt():
        calls["n"] += 1
        raise CorruptStateError("deterministic damage")

    with pytest.raises(CorruptStateError):
        durable.with_retries(corrupt, retries=5, sleep=lambda _: None)
    assert calls["n"] == 1


def test_backoff_delays_deterministic_with_seed():
    a = list(durable.backoff_delays(5, seed=3))
    assert a == list(durable.backoff_delays(5, seed=3))
    assert a != list(durable.backoff_delays(5, seed=4))
    assert all(x <= 2.0 * 1.5 for x in a)


def test_quarantine_moves_file_and_sidecar(tmp_path):
    path = str(tmp_path / "bad.npz")
    durable.save_npz(path, {"w": np.zeros(4)})
    dest = durable.quarantine(path)
    assert dest == path + ".corrupt"
    assert not os.path.exists(path) and os.path.exists(dest)
    assert os.path.exists(durable.checksum_path(dest))


def test_ckpt_sites_write_publish_and_load(tmp_path):
    """ckpt.save's write phase sits inside the retry scope (a transient
    fault is absorbed), its publish phase damages what a load must then
    detect; ckpt.load fires once per candidate read."""
    path = str(tmp_path / "ckpt.npz")
    faults.reset_stats()
    with faults.inject("ckpt.save:times=2:raise"):
        durable.save_npz(path, {"epoch": np.asarray(0)})  # two retries absorb both
    assert int(durable.load_npz(path)[0]["epoch"]) == 0
    with faults.inject("ckpt.save:times=3:raise"):
        with pytest.raises(faults.FaultInjected):
            durable.save_npz(path, {"epoch": np.asarray(1)})
    with faults.inject("ckpt.save:corrupt"):
        durable.save_npz(path, {"epoch": np.asarray(2)})
    with pytest.raises(CorruptStateError):
        durable.verify_checksum(path)
    with faults.inject("ckpt.load:raise:times=1"):
        z, used = durable.load_npz(path)
    assert used == path + ".1" and int(z["epoch"]) == 0
    st = faults.stats()
    assert st["ckpt.save"]["injected"] == 6 and st["ckpt.load"]["injected"] == 1
