"""keystone_tpu_torch/tools/lint.py, the port's repo-invariant linter, in
tier 1.

Two halves, as tests/test_lint.py has them for the reference: (1) the whole
``keystone_tpu_torch/`` tree, ``tools/`` included, lints clean; (2) a
seeded-violation corpus shows every rule firing, each source run through
the reference's linter (tools/lint.py) and the port's, which must report
the same rules.  The port's ``host-sync`` rule also knows the tensor host
reads ``.item()``, ``.cpu()`` and ``.numpy()``, which the reference's does
not: those cases run against the port alone."""

import os
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))

import lint as ref_lint  # noqa: E402

from keystone_tpu_torch.tools import lint  # noqa: E402


@pytest.fixture(scope="module")
def sites():
    return lint.load_registered_sites()


@pytest.fixture(scope="module")
def attr_vocab():
    return lint.load_attr_vocabulary()


@pytest.fixture(scope="module")
def gate_env():
    return lint.load_gate_env()


def _run(src, sites, metric_kinds=None, mod=lint, **kw):
    return mod.lint_source("seeded.py", src, sites, metric_kinds if metric_kinds is not None else {}, **kw)


def _rules(src, sites, **kw):
    """The rules the port's linter reports on ``src``, after checking
    that the reference's reports the same ones."""
    kw.setdefault("supervised", False)
    kw.setdefault("solver_scoped", False)
    got = [v.rule for v in _run(src, sites, **kw)]
    ref_kw = dict(kw)
    if ref_kw.get("attr_vocab") is not None:
        ref_kw["attr_vocab"] = ref_lint.load_attr_vocabulary()
    if ref_kw.get("gate_env") is not None:
        ref_kw["gate_env"] = ref_lint.load_gate_env()
    ref = [v.rule for v in _run(src, ref_lint.load_registered_sites(), mod=ref_lint, **ref_kw)]
    assert got == ref, (src, got, ref)
    return got


# ------------------------------------------------------------- the gate
def test_port_lints_clean():
    """The tier-1 invariant: the whole port, tools/ included, passes."""
    violations = lint.lint_paths([os.path.join(REPO_ROOT, "keystone_tpu_torch")])
    assert not violations, "\n".join(str(v) for v in violations)
    assert lint.main([]) == 0


def test_registries_parsed_without_import(sites, attr_vocab, gate_env):
    """The three registries come from the port's own sources, parsed and
    never imported, and equal what the modules hold."""
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.obs import ledger
    from keystone_tpu_torch.planner import registry

    assert lint.FAULTS_PATH.endswith(os.path.join("keystone_tpu_torch", "faults.py"))
    assert sites == frozenset(faults.SITES) and "executor.stage" in sites
    assert attr_vocab == frozenset(ledger.ATTR_VOCABULARY)
    assert "request_id" in attr_vocab and "seconds" in attr_vocab
    expected = set(registry.OPERATIONAL_ENV)
    expected.update(s["env"] for s in registry.GATES.values() if s.get("env"))
    expected.update(s["env"] for s in registry.KNOBS.values() if s.get("env"))
    assert gate_env == frozenset(expected)
    assert "KEYSTONE_HOST_WORKERS" in gate_env and "KEYSTONE_POOL_BUDGET_BYTES" in gate_env


# ------------------------------------------------- seeded: fault-site
@pytest.mark.parametrize("src, want", [
    ('fault_point("bogus.site")', ["fault-site"]),
    ('faults.fault_point("executor.stage")', []),
    ('SiteSpec("another.bogus", action="raise")', ["fault-site"]),
    ('fault_point("bogus.site")  # lint: allow-fault-site', []),
])
def test_fault_site_rule(src, want, sites):
    assert _rules(src, sites) == want


# ------------------------------------------------- seeded: metric rules
@pytest.mark.parametrize("src, want", [
    ('metrics.inc("BadName")', ["metric-name"]),
    ('metrics.observe("nodots", 1.0)', ["metric-name"]),
    ('metrics.inc("executor.stage_retries")', []),
    ('metrics.set_gauge("serve.queue_depth", 3)', []),
    # an entity index baked into the name
    ('metrics.inc("serve.replica_0_flushes")', ["metric-name"]),
    ('metrics.set_gauge("serve.replica_12", 1.0)', ["metric-name"]),
    ('metrics.inc("serve.replica_flushes", replica=3)', []),
    ('metrics.observe("serve.p99_seconds", 0.1)', []),
    ('metrics.inc("solver.bf16_casts")', []),
    # interpolated names: the dynamic form of the same fault
    ('metrics.inc(f"serve.replica{i}.flushes")', ["metric-name"]),
    ('metrics.observe("serve." + kind, 1.0)', ["metric-name"]),
    ('metrics.inc("serve.replica_{}_flushes".format(i))', ["metric-name"]),
    ('metrics.inc(f"parallel.{kind}", axis=axis)', ["metric-name"]),
    ('metrics.inc("parallel.collectives", kind=kind, axis=axis)', []),
    ('metrics.inc(f"serve.{x}")  # lint: allow-metric-name', []),
    ("metrics.inc(name)", []),
    # tenant- and fleet-scoped names carry their label
    ('metrics.inc("serve.tenant_submitted")', ["metric-name"]),
    ('metrics.inc("serve.tenant_submitted", tenant=t)', []),
    ('metrics.observe("serve.fleet.apply_seconds", 0.1)', ["metric-name"]),
    ('metrics.inc("serve.fleet_exchanges")', ["metric-name"]),
    ('metrics.observe("serve.fleet.apply_seconds", 0.1, worker=w)', []),
    ('metrics.inc("serve.fleet_exchanges", host=h)', []),
    ('metrics.inc("serve.fleetingly")', []),
    ('metrics.set_gauge("serve.workers", 2)', []),
    ('metrics.observe("serve.fleet.x", 1.0)  # lint: allow-metric-name', []),
])
def test_metric_name_rule(src, want, sites):
    assert _rules(src, sites) == want


def test_metric_kind_rule_fires_across_files(sites):
    mk = {}
    assert not _run('metrics.inc("x.y")', sites, metric_kinds=mk)
    v = _run('metrics.set_gauge("x.y", 1.0)', sites, metric_kinds=mk)
    assert [x.rule for x in v] == ["metric-kind"]
    assert not _run('metrics.inc("x.y", 2.0)', sites, metric_kinds=mk)


# ------------------------------------------------- seeded: wall-clock
@pytest.mark.parametrize("src, supervised, want", [
    ("import time\nt0 = time.time()\n", True, ["wall-clock"]),
    ("import time\nt0 = time.time()\n", False, []),
    ("import time\nt0 = time.monotonic()", True, []),
    ("import time\nts = time.time()  # lint: allow-wall-clock", True, []),
])
def test_wall_clock_rule(src, supervised, want, sites):
    assert _rules(src, sites, supervised=supervised) == want


def test_supervised_prefixes_name_the_port():
    assert lint._is_supervised("keystone_tpu_torch/utils/guard.py")
    assert lint._is_supervised("keystone_tpu_torch/serve/service.py")
    assert lint._is_supervised("keystone_tpu_torch/parallel/multihost.py")
    assert not lint._is_supervised("keystone_tpu_torch/pipelines/timit.py")
    assert not lint._is_supervised("keystone_tpu/serve/service.py")


# ------------------------------------------------- seeded: host-sync
@pytest.mark.parametrize("src, solver_scoped, want", [
    ("for b in order:\n    bound = np.asarray(w[:1, :1])\n", True, ["host-sync"]),
    ("for b in order:\n    bound = np.asarray(w[:1, :1])\n", False, []),
    ("while not done:\n    vals = p.tolist()\n", True, ["host-sync"]),
    ("w = np.asarray(z['w'])\n", True, []),
    ("for e in range(n):\n    obj = np.asarray(objective)  # lint: allow-host-sync\n", True, []),
    ("for e in range(n):\n    for b in range(nb):\n        x = np.asarray(w)\n", True, ["host-sync"]),
])
def test_host_sync_rule(src, solver_scoped, want, sites):
    assert _rules(src, sites, solver_scoped=solver_scoped) == want


@pytest.mark.parametrize("src, want", [
    ("for e in range(n):\n    obj = float(loss.item())\n", ["host-sync"]),
    ("while it < n:\n    host = w.cpu()\n", ["host-sync"]),
    ("for b in blocks:\n    a = b.numpy()\n", ["host-sync"]),
    # a chain is one read, and nested loops report it once
    ("for e in range(n):\n    for b in range(nb):\n        a = w.cpu().numpy()\n", ["host-sync"]),
    ("a = w.cpu().numpy()\n", []),
    ("for e in range(n):\n    a = w.cpu().numpy()  # lint: allow-host-sync\n", []),
])
def test_host_sync_rule_knows_the_tensor_reads(src, want, sites):
    assert [v.rule for v in _run(src, sites, solver_scoped=True)] == want
    assert not _run(src, sites, solver_scoped=False)


def test_solver_sync_prefixes_name_the_port():
    for m in ("block_ls", "block_weighted_ls", "lbfgs", "kernel_ridge"):
        assert lint._is_solver_sweep(f"keystone_tpu_torch/models/{m}.py")
    assert not lint._is_solver_sweep("keystone_tpu_torch/workflow/executor.py")


# ------------------------------------------------- seeded: attr keys
@pytest.mark.parametrize("src, want", [
    ('ledger.event("serve.request", request_idd=rid)', ["attr"]),
    ('rec.annotate(rid, "serve.enqueue", queue_dep=3)', ["attr"]),
    ('ledger.event("serve.request", request_id=rid, outcome="shed")', []),
    ('rec.finish(rid, "shed", replica=0, waited_seconds=w)', []),
    ('rec.finish(rid, "shed", only_live=True, replica=0)', []),
    ('ledger.event("x.y", only_live=True)', ["attr"]),
    ('with ledger.span("serve.batch", Rows=k): pass', ["attr"]),
    ('ledger.event("multihost.init", seconds=dt, backend=b, world=w, rank=r)', ["attr", "attr", "attr"]),
    ('ledger.event("solver.epoch", **series)', []),
    ("m.span(1, 2)\nq.event(name, weird_key=1)", []),
    ('ledger.event("x.y", oneoff_key=1)  # lint: allow-attr', []),
])
def test_attr_rule(src, want, sites, attr_vocab):
    assert "only_live" not in attr_vocab
    assert _rules(src, sites, attr_vocab=attr_vocab) == want


def test_attr_rule_off_without_a_vocabulary(sites):
    assert not _run('ledger.event("x.y", bogus_key=1)', sites)


# ------------------------------------------------- seeded: obs-gating
@pytest.mark.parametrize("src, want", [
    ('def f():\n    led = ledger.active()\n    led.event("x")\n', ["obs-gating"]),
    ('def f():\n    led = ledger.active()\n    if led is not None:\n        led.event("x")\n', []),
    ('def f():\n    led = ledger.active()\n    if led is None:\n        return\n    led.event("x")\n', []),
    ("def f():\n    obs = ledger.active() is not None\n    return obs\n", []),
    ("def f():\n    led = ledger.active()\n    return led.path if led is not None else None\n", []),
])
def test_obs_gating_rule(src, want, sites):
    assert _rules(src, sites) == want


# ------------------------------------------------------- CLI behavior
def test_main_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert lint.main([str(clean)]) == 0
    dirty = tmp_path / "dirty.py"
    dirty.write_text('fault_point("typo.site")\n')
    assert lint.main([str(dirty)]) == 1
    assert "fault-site" in capsys.readouterr().out
    assert lint.main(["--help"]) == 2


# ------------------------------------------------------------ proc-spawn
@pytest.mark.parametrize("src, want", [
    ("import multiprocessing\n", ["proc-spawn"]),
    ("from multiprocessing import shared_memory\n", ["proc-spawn"]),
    ("import os\npid = os.fork()\n", ["proc-spawn"]),
    ("import os as _os\npid = _os.fork()\n", ["proc-spawn"]),
    ("from os import fork\npid = fork()\n", ["proc-spawn"]),
    ("from os import forkpty\n", ["proc-spawn"]),
    ("import multiprocessing as mp  # lint: allow-proc-spawn\n", []),
])
def test_proc_spawn_rule(src, want, sites):
    assert _rules(src, sites) == want


def test_proc_spawn_rule_scoped_to_the_worker_fence(sites):
    src = "import multiprocessing\n"
    for fenced in ("keystone_tpu_torch/serve/procfleet.py", "keystone_tpu_torch/serve/worker.py",
                   "keystone_tpu_torch/serve/wire.py"):
        vs = lint.lint_source(fenced, src, sites, {}, attr_vocab=None)
        assert not [v for v in vs if v.rule == "proc-spawn"], fenced
    vs = lint.lint_source("keystone_tpu_torch/utils/hostmap.py", src, sites, {})
    assert [v.rule for v in vs] == ["proc-spawn"]
    assert "CUDA context" in vs[0].message
    vs = lint.lint_source("elsewhere.py", src, sites, {}, attr_vocab=None, proc_fenced=False)
    assert not [v for v in vs if v.rule == "proc-spawn"]


# --------------------------------------------------------------- socket
@pytest.mark.parametrize("src, want", [
    ("import socket\n", ["socket"]),
    ("import socket as sk\n", ["socket"]),
    ("from socket import create_connection\n", ["socket"]),
    ("import socket  # lint: allow-socket\n", []),
    ("import socketserver\n", []),
    ("from websockets import connect\n", []),
])
def test_socket_rule(src, want, sites):
    assert _rules(src, sites) == want


def test_socket_rule_scoped_to_the_transport_fence(sites):
    src = "import socket\n"
    for fenced in ("keystone_tpu_torch/serve/net.py", "keystone_tpu_torch/serve/wire.py",
                   "keystone_tpu_torch/serve/ingress.py"):
        vs = lint.lint_source(fenced, src, sites, {}, attr_vocab=None)
        assert not [v for v in vs if v.rule == "socket"], fenced
    vs = lint.lint_source("keystone_tpu_torch/serve/procfleet.py", src, sites, {})
    assert [v.rule for v in vs] == ["socket"]
    vs = lint.lint_source("elsewhere.py", src, sites, {}, attr_vocab=None, socket_fenced=False)
    assert not [v for v in vs if v.rule == "socket"]


# --------------------------------------------------------- seeded: gate
@pytest.mark.parametrize("src, want", [
    ('os.environ.get("KEYSTONE_SECRET_GATE", "1")', ["gate"]),
    ('os.getenv("KEYSTONE_SECRET_GATE")', ["gate"]),
    ('os.environ["KEYSTONE_SECRET_GATE"]', ["gate"]),
    ('"KEYSTONE_SECRET_GATE" in os.environ', ["gate"]),
    ('"KEYSTONE_SECRET_GATE" not in os.environ', ["gate"]),
    ('os.environ.pop("KEYSTONE_SECRET_GATE", None)', ["gate"]),
    ('os.environ.setdefault("KEYSTONE_SECRET_GATE", "1")', ["gate"]),
    ('os.environ.get("KEYSTONE_FUSED_FV", "1")', []),
    ('os.environ.get("KEYSTONE_POOL_BUDGET_BYTES")', []),
    ('os.environ.get("KEYSTONE_HOST_WORKERS")', []),
    ('os.environ.get("JAX_PLATFORMS", "")', []),
    ('os.environ["HOME"]', []),
    ('os.environ.get("KEYSTONE_SECRET_GATE")  # lint: allow-gate', []),
])
def test_gate_rule(src, want, sites, gate_env):
    assert _rules(src, sites, gate_env=gate_env) == want


def test_gate_rule_off_without_a_registry(sites):
    assert not _run('os.environ.get("KEYSTONE_SECRET_GATE")', sites)
