"""The port's fault injection (keystone_tpu_torch/faults.py) against the
JAX package's (keystone_tpu/faults.py): the same plan text parses to the
same specs, a seeded plan fires at the same call counts in both, and the
reference's own scenarios (tests/test_faults.py) hold in the port."""

import numpy as np
import pytest
import torch

from keystone_tpu import faults as ref_faults
from keystone_tpu_torch import faults
from keystone_tpu_torch.faults import FaultInjected, FaultPlanError, fault_point, inject, parse_plan

PLANS = [
    "ckpt.save:after=3:raise;blockstore.read:p=0.2:seed=7;stream.batch:every=2:times=3:truncate;executor.stage:exit=9",
    "executor.stage:after=2:every=2:times=2",
    "stream.batch:p=0.3:seed=11",
    "kernel.sweep:ctx.block=3:raise",
    "blockstore.write:delay=0.25;ckpt.load:hang:times=1",
    "ckpt.save:after=1:times=1:corrupt",
]

SPEC_FIELDS = ("site", "action", "after", "every", "p", "seed", "times", "exit_code", "delay_seconds", "match")


@pytest.mark.parametrize("text", PLANS)
def test_plan_text_parses_to_the_reference_specs(text):
    got = [tuple(getattr(s, f) for f in SPEC_FIELDS) for s in parse_plan(text).specs]
    want = [tuple(getattr(s, f) for f in SPEC_FIELDS) for s in ref_faults.parse_plan(text).specs]
    assert got == want


def _pattern(mod, plan, site, calls, **ctx):
    fired = []
    with mod.inject(plan):
        for _ in range(calls):
            try:
                mod.fault_point(site, **ctx)
                fired.append(0)
            except mod.FaultInjected:
                fired.append(1)
    return fired


@pytest.mark.parametrize("plan,site", [
    ("stream.batch:p=0.3:seed=11", "stream.batch"),
    ("blockstore.read:p=0.5:seed=3:times=7", "blockstore.read"),
    ("executor.stage:after=2:every=3:times=4", "executor.stage"),
    ("ckpt.load:every=4", "ckpt.load"),
])
def test_seeded_plan_fires_at_the_reference_call_counts(plan, site):
    got = _pattern(faults, plan, site, 60)
    assert got == _pattern(ref_faults, plan, site, 60)
    assert 0 < sum(got) < 60


@pytest.mark.parametrize("site", ["multihost.init"])
def test_sites_of_unported_slices_are_refused(site):
    """The reference's last site joined with the parallel slice that wires
    it: the port registers every site the reference has, parses a plan
    naming it as the reference does, and still refuses a site that no
    slice fires (a plan naming one is refused, not silently inert)."""
    assert site in ref_faults.SITES and site in faults.SITES
    assert ref_faults.SITES <= faults.SITES
    assert parse_plan(f"{site}:after=0:times=1:raise").specs[0].site == site
    ref_faults.parse_plan(f"{site}:raise")
    with pytest.raises(faults.UnknownFaultSiteError, match="unknown fault site"):
        parse_plan(f"{site}.unwired:raise")
    with pytest.raises(faults.UnknownFaultSiteError):
        with inject(faults.FaultPlan([faults.SiteSpec(f"{site}.unwired")])):
            pass


@pytest.mark.parametrize("plan", ["plan.sample:ctx.candidate=auto:raise", "plan.sample:after=1:times=1:raise"])
def test_plan_sample_site_fires_in_the_cost_model(plan):
    """``plan.sample`` is wired: the cost model's timed samples pass it
    with ``gate=/candidate=/n=`` context, parsed as the reference parses
    the plan, and firing where the reference's site fires."""
    import jax.numpy as jnp

    from keystone_tpu import planner as jplanner
    from keystone_tpu.models.linear import LinearMapper as JLinearMapper
    from keystone_tpu.workflow import Pipeline as JPipeline
    from keystone_tpu_torch import planner
    from keystone_tpu_torch.models.linear import LinearMapper
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    assert parse_plan(plan).specs[0].site == ref_faults.parse_plan(plan).specs[0].site == "plan.sample"
    w = np.random.default_rng(0).normal(size=(4, 2)).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(16, 4)).astype(np.float32)
    port = Pipeline.of(LinearMapper(torch.from_numpy(w))).fit()
    ref = JPipeline.of(JLinearMapper(jnp.asarray(w))).fit()
    faults.reset_stats()
    ref_faults.reset_stats()
    # the port fails the build loudly; the reference's forward sampling is
    # best-effort and drops the stage instead
    with inject(plan):
        with pytest.raises(faults.FaultInjected):
            planner.build_plan(port, example=x, batch_sizes=(4, 8), device="cpu")
    with ref_faults.inject(plan):
        assert jplanner.build_plan(ref, example=x, batch_sizes=(4, 8)).choice_for("matmul") is None
    assert faults.stats()["plan.sample"] == ref_faults.stats()["plan.sample"]
    assert faults.stats()["plan.sample"]["injected"] == 1
    # a plan for another candidate never fires
    with inject("plan.sample:ctx.candidate=f32:raise"):
        assert planner.build_plan(port, example=x, batch_sizes=(4, 8), device="cpu").choice_for("matmul") == "auto"


def test_wired_sites_are_the_slice_sites():
    assert faults.SITES == {"blockstore.read", "blockstore.write", "ckpt.save", "ckpt.load", "stream.batch",
                            "executor.stage", "kernel.sweep", "serve.enqueue", "serve.batch", "serve.replica",
                            "serve.worker", "serve.swap", "serve.artifact_load", "serve.rollout",
                            "serve.net.connect", "serve.net.send", "serve.net.recv", "plan.sample",
                            "multihost.init"}
    assert faults.SITES == ref_faults.SITES


@pytest.mark.parametrize("site,ctx", [
    ("serve.enqueue", {}), ("serve.batch", {}), ("serve.replica", {"replica": 1}), ("serve.worker", {"replica": 0}),
    ("serve.swap", {"version": "v2"}), ("serve.rollout", {"version": "v0003"}),
    ("serve.artifact_load", {"path": "MANIFEST.json"}),
    ("serve.net.connect", {"link": "w0"}), ("serve.net.send", {"link": "w1"}), ("serve.net.recv", {"link": "w0"}),
])
def test_serve_sites_fire_at_the_reference_calls(site, ctx):
    """Each serving site, wired in this slice, fires at the same calls as
    the reference's under the same seeded plan (with the context the
    service passes there)."""
    plan = f"{site}:p=0.4:seed=5:after=1"
    got = _pattern(faults, plan, site, 40, **ctx)
    assert got == _pattern(ref_faults, plan, site, 40, **ctx)
    assert 0 < sum(got) < 40
    key, value = next(iter(ctx.items()), (None, None))
    if key is not None:
        matched = f"{site}:ctx.{key}={value}:every=3"
        assert _pattern(faults, matched, site, 12, **ctx) == _pattern(ref_faults, matched, site, 12, **ctx)


def test_plan_grammar_round_trip():
    p = parse_plan(PLANS[0])
    by_site = {s.site: s for s in p.specs}
    assert by_site["ckpt.save"].after == 3 and by_site["ckpt.save"].action == "raise"
    assert by_site["blockstore.read"].p == 0.2 and by_site["blockstore.read"].seed == 7
    assert by_site["stream.batch"].every == 2 and by_site["stream.batch"].times == 3
    assert by_site["stream.batch"].action == "truncate"
    assert by_site["executor.stage"].action == "exit" and by_site["executor.stage"].exit_code == 9


def test_plan_rejects_unknown_site_and_token():
    with pytest.raises(FaultPlanError, match="unknown fault site"):
        parse_plan("ckpt.svae:raise")
    with pytest.raises(FaultPlanError, match="bad fault token"):
        parse_plan("ckpt.save:bogus=1")
    with pytest.raises(FaultPlanError, match="wire action"):
        parse_plan("ckpt.save:drop")


def test_after_every_times_triggers():
    with inject("executor.stage:after=2:every=2:times=2") as plan:
        fired = []
        for _ in range(10):
            try:
                fault_point("executor.stage")
                fired.append(False)
            except FaultInjected:
                fired.append(True)
        assert fired == [False, False, True, False, True] + [False] * 5
        assert plan.specs[0].fired == 2


def test_context_match_advances_only_matching_calls():
    fired = []
    with inject("kernel.sweep:ctx.block=2:after=1:raise"):
        for b in (0, 2, 1, 2, 2):
            try:
                fault_point("kernel.sweep", block=str(b))
                fired.append(0)
            except FaultInjected:
                fired.append(1)
    assert fired == [0, 0, 0, 1, 1]


def test_env_plan_activates_and_replays(monkeypatch):
    faults.reset_stats()
    monkeypatch.setenv(faults.ENV_VAR, "ckpt.load:after=1:raise")
    for _round in range(2):
        fault_point("ckpt.load")
        with pytest.raises(FaultInjected):
            fault_point("ckpt.load")
        monkeypatch.delenv(faults.ENV_VAR)
        fault_point("ckpt.load")  # no plan: never fires
        monkeypatch.setenv(faults.ENV_VAR, "ckpt.load:after=1:raise")
    stats = faults.stats()
    assert stats["ckpt.load"] == {"calls": 6, "injected": 2}


def test_fault_injected_is_transient_oserror():
    assert issubclass(FaultInjected, OSError)
    assert FaultInjected("blockstore.read").site == "blockstore.read"


def test_publish_phase_actions_wait_for_publish(tmp_path):
    victim = tmp_path / "state.bin"

    def one_save():
        victim.write_bytes(b"x" * 64)
        fault_point("ckpt.save", path=str(victim), phase="write")
        fault_point("ckpt.save", path=str(victim), phase="publish")

    with inject("ckpt.save:after=1:times=1:truncate"):
        one_save()
        assert victim.stat().st_size == 64
        one_save()
        assert victim.stat().st_size == 32
        one_save()
        assert victim.stat().st_size == 64


def test_raise_actions_fire_on_write_phase(tmp_path):
    victim = tmp_path / "state.bin"
    victim.write_bytes(b"y" * 10)
    with inject("ckpt.save:raise"):
        with pytest.raises(FaultInjected):
            fault_point("ckpt.save", path=str(victim), phase="write")
        fault_point("ckpt.save", path=str(victim), phase="publish")


def test_corrupt_action_flips_bytes(tmp_path):
    victim = tmp_path / "blob.bin"
    victim.write_bytes(bytes(range(100)))
    with inject("blockstore.read:corrupt"):
        fault_point("blockstore.read", path=str(victim))
    data = victim.read_bytes()
    assert len(data) == 100 and data != bytes(range(100))


def test_nested_inject_innermost_wins_and_pops():
    with inject("stream.batch:after=100:raise"):
        with inject("stream.batch:raise"):
            with pytest.raises(FaultInjected):
                fault_point("stream.batch")
        fault_point("stream.batch")


def test_exit_action_ends_the_process(tmp_path):
    """``exit`` is the kill-worker action: ``os._exit`` with the plan's
    code, nothing after it runs (in a child process here)."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("from keystone_tpu_torch import faults\n"
            "faults.fault_point('ckpt.save', phase='write')\n"
            "print('survived')\n")
    env = {"KEYSTONE_FAULTS": "ckpt.save:exit=7", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 7, out.stderr
    assert "survived" not in out.stdout


def test_injections_mirror_into_the_metrics_registry():
    from keystone_tpu_torch.obs import metrics

    metrics.reset()
    with inject("blockstore.read:every=2"):
        for _ in range(4):
            try:
                fault_point("blockstore.read")
            except FaultInjected:
                pass
    assert metrics.REGISTRY.counter_value("faults.calls", site="blockstore.read") == 4
    assert metrics.REGISTRY.counter_value("faults.injected", site="blockstore.read") == 2
