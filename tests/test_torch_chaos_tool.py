"""The port's chaos tool (keystone_tpu_torch/tools/chaos.py) and workload
zoo (keystone_tpu_torch/tools/workloads.py) against the repo's
tools/chaos.py and tools/workloads.py: the exit codes 0 (survived), 1 (a
fault escaped) and 2 (a planned site never exercised) on the CPU
workloads ``bcd``, ``stream`` and ``tenants``, each with the same
per-site report as the reference tool on the same plan; the soak's plan
generator draw for draw and a short soak on the CPU; the zoo's
schedules digest for digest.  Counts are compared exactly where they do
not depend on timing (a fit's and a stream's sites); a serving
workload's flush count does, so there the verdicts are compared."""

import json
import random

import numpy as np
import pytest

from keystone_tpu_torch.tools import chaos, workloads

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    """The reference's services turn on JAX's persistent compile cache for
    the process unless KEYSTONE_COMPILE_CACHE says no (tests/test_torch_serve.py)."""
    monkeypatch.setenv("KEYSTONE_COMPILE_CACHE", "0")


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


def _reference(argv, capsys, monkeypatch):
    from tools import chaos as jchaos

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    return _run(jchaos.main, argv, capsys)


@pytest.mark.parametrize("workload,plan,rc,exact", [
    ("bcd", "ckpt.save:after=1:times=1:corrupt", 0, True),
    ("stream", "stream.batch:every=3:times=2:raise", 0, True),
    ("tenants", "serve.batch:ctx.tenant=a:raise", 0, False),
    ("tenants", "serve.enqueue:ctx.tenant=a:raise", 0, False),
    ("stream", "stream.batch:raise", 1, True),
    ("stream", "ckpt.save:raise", 2, True),
    ("bcd", "blockstore.read:raise", 2, True),
])
def test_exit_codes_and_site_report_match_the_reference(workload, plan, rc, exact, tmp_path, capsys, monkeypatch):
    argv = ["--workload", workload, "--plan", plan]
    got_rc, got = _run(chaos.main, argv + ["--device", "cpu", "--tmp", str(tmp_path / "port")], capsys)
    ref_rc, ref = _reference(argv + ["--tmp", str(tmp_path / "ref")], capsys, monkeypatch)
    assert got_rc == ref_rc == rc, (got, ref)
    assert got["completed"] == ref["completed"] == (rc != 1)
    assert got["not_exercised"] == ref["not_exercised"]
    planned = {clause.split(":", 1)[0] for clause in plan.split(";")}
    for site in planned:
        assert got["sites"][site]["verdict"] == ref["sites"][site]["verdict"]
    if exact:
        assert got["sites"] == ref["sites"]
    if rc == 1:
        assert "injected fault at" in got["error"]


def test_plan_is_required_unless_soak_or_self_injecting(capsys):
    with pytest.raises(SystemExit) as e:
        chaos.main(["--workload", "bcd", "--device", "cpu"])
    assert e.value.code == 2 and "--plan is required" in capsys.readouterr().err
    assert chaos.SELF_INJECTING == {"nethost", "rollout"}
    assert set(chaos.WORKLOADS) == {"bcd", "ooc", "kernel", "lbfgs", "stream", "serve_artifacts", "tenants",
                                    "procfleet", "nethost", "rollout"}


def test_soak_plans_match_the_reference_generator():
    from tools.chaos import _soak_plan as jsoak_plan

    for seed in range(5):
        a, b = random.Random(seed), random.Random(seed)
        assert [chaos._soak_plan(a) for _ in range(8)] == [jsoak_plan(b) for _ in range(8)]


@pytest.mark.soak
def test_short_soak_on_the_cpu_loses_nothing():
    report = chaos.run_soak(1.0, seed=3, replicas=2, wave=16, device="cpu")
    assert report["ok"] and report["hung"] == 0 and report["healthy_after_soak"]
    assert report["iterations"] >= 1 and report["submitted"] == report["iterations"] * 16
    assert report["completed"] + report["failed_typed"] + report["rejected"] == report["submitted"]


@pytest.mark.parametrize("name", workloads.SCENARIOS)
def test_zoo_schedules_match_the_reference(name):
    from tools import workloads as jzoo

    got = workloads.make_scenario(name, seed=7, duration_s=1.0, qps=120.0, dim=8)
    want = jzoo.make_scenario(name, seed=7, duration_s=1.0, qps=120.0, dim=8)
    assert got.summary() == want.summary()
    for event in got.events[:5]:
        np.testing.assert_array_equal(workloads.payload(event, 8), jzoo.payload(event, 8))


def test_zoo_pipeline_fingerprints_its_version():
    """The drill's versions on the CPU: the good one's answers have norm
    ``scale``, the gated one fails exactly the marked rows."""
    import torch

    x = np.random.default_rng(0).normal(size=(3, 8)).astype(np.float32)
    good = workloads.build_zoo_pipeline(dim=8, scale=2.0, device="cpu")
    out = good.freeze(device="cpu")(torch.from_numpy(x)).array.numpy()
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 2.0, rtol=1e-6)
    bad = workloads.build_zoo_pipeline(dim=8, scale=3.0, gate=True, device="cpu").freeze(device="cpu")
    x[1, 0] = workloads.MARK
    with pytest.raises(ValueError, match="poison marker"):
        bad(torch.from_numpy(x))
