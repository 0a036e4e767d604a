"""Run a workload under a fault plan and report per-site outcomes
(counterpart of the repo's ``tools/chaos.py``).

The half of the chaos contract that runs workloads (``faults.py`` injects,
``utils/durable.py`` and the serving layer survive): run a workload with
a KEYSTONE_FAULTS-grammar plan active and report, per site, how many
calls passed, how many faults were injected, and whether the workload
survived.

    python -m keystone_tpu_torch.tools.chaos --workload bcd \\
        --plan "blockstore.read:every=3:raise;ckpt.save:after=1:times=1:corrupt" --restarts 1
    python -m keystone_tpu_torch.tools.chaos --workload tenants --plan "serve.batch:ctx.tenant=a:raise"
    python -m keystone_tpu_torch.tools.chaos --soak 20 --soak-workers 2
    python -m keystone_tpu_torch.tools.chaos --workload my_pkg.my_module:main --plan "..."

Every workload runs on ``--device`` (the card unless ``--device cpu``).
Built-in workloads (synthetic, seconds-scale): ``bcd`` (checkpointed
block coordinate descent), ``ooc`` (the out-of-core streamed BCD over a
FeatureBlockStore: blockstore.*), ``kernel`` (the checkpointed
out-of-core kernel ridge sweep over a RowBlockStore: blockstore.*,
kernel.sweep, ckpt.*), ``lbfgs`` (chunk-checkpointed dense L-BFGS),
``stream`` (a resilient StreamDataset sweep), ``serve_artifacts``
(publish → deploy → hot-swap → heal a crashed replica while the plan
batters ``serve.artifact_load``; the port's bundle is the frozen
apply's bucket-graph artifacts, each replica capturing its own CUDA
graphs, as it has no compile cache to seed: a damaged or refused bundle
makes that replica walk, never fail), ``tenants`` (two tenants sharing a
featurization prefix behind ``serve_multi``: a plan aimed at tenant
``a`` may fail ``a``'s requests, typed, and tenant ``b``'s wave must
complete clean), ``procfleet`` (a two-worker process fleet with seeded
SIGKILLs mid-wave: nothing lost, a clean wave after), ``nethost`` (a
two-worker TCP fleet with one link partitioned past its lease: nothing
lost, the fenced worker rejoins) and ``rollout`` (a guarded canary
rollout of a bad version under the zoo's seeded ``poison_flood``,
``tools/workloads.py``: rolled back, quarantined, never redeployed,
nothing hung).

Network plans: ``serve.net.connect`` / ``send`` / ``recv`` take ``drop``
(alias ``partition``), ``delay``, ``hang`` and ``corrupt``; match
``ctx.link=<worker>`` to sever one worker's link.  Latency plans pair
with ``--stage-deadline`` / ``--stream-timeout`` / ``--stage-retries``,
and the report's ``guard`` section shows the deadline hits, breaker
opens and degraded nodes beside the per-site counts.

Exit code 0: the workload completed under the plan; 1: it failed (the
report's ``error`` names what escaped); 2: it completed but a site the
plan names never injected (``not-exercised``: a typo'd trigger must not
read as a green run).

**Soak mode** (``--soak SECONDS [--seed N] [--soak-replicas R |
--soak-workers W]``) loops seeded randomized multi-site plans over the
``serve.*`` sites against a live fleet (supervisor and hedging on;
``--soak-workers`` makes it a process fleet and adds seeded mid-wave
worker SIGKILLs), submitting a wave under each plan and requiring every
future to resolve (a result or a typed error); exit 1 on any hung
request, or on a fleet that cannot serve a clean wave once the soak
ends.  The plan sequence is deterministic in the seed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import signal
import tempfile
import threading
import time
from concurrent.futures import TimeoutError as _FutTimeout

import numpy as np


def _bcd(tmp, restarts, device):
    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
    from keystone_tpu_torch.workflow.dataset import Dataset
    from keystone_tpu_torch.workflow.recovery import fit_with_recovery

    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 48)).astype(np.float32)
    y = rng.normal(size=(256, 4)).astype(np.float32)
    ckpt = os.path.join(tmp, "bcd-ckpt")

    class CheckpointedBLS(BlockLeastSquaresEstimator):
        def fit_dataset(self, data, labels=None):
            return self.fit_checkpointed(data, labels, checkpoint_dir=ckpt)

    est = CheckpointedBLS(block_size=16, num_iter=4, lam=1e-3)
    fit_with_recovery(lambda: est.with_data(Dataset(x, device=device), Dataset(y, device=device)),
                      state_dir=tmp, max_restarts=restarts)


def _ooc(tmp, restarts, device):
    from keystone_tpu_torch.loaders.stream import batched
    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
    from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
    from keystone_tpu_torch.workflow.recovery import fit_with_recovery

    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 48)).astype(np.float32)
    y = rng.normal(size=(256, 4)).astype(np.float32)
    est = BlockLeastSquaresEstimator(block_size=16, num_iter=2, lam=1e-3)
    fit_with_recovery(lambda: est.with_data(StreamDataset(batched(x, 64), n=x.shape[0], device=device),
                                            Dataset(y, device=device)),
                      max_restarts=restarts)


def _kernel(tmp, restarts, device):
    """The out-of-core kernel ridge sweep under fault: the row-block spill
    rides blockstore.read/write, each diagonal step kernel.sweep, the
    per-epoch checkpoint ckpt.save/load, so a plan over any of them
    proves the sweep resumes from its last completed epoch."""
    from keystone_tpu_torch.loaders.stream import batched
    from keystone_tpu_torch.models.kernel_ridge import GaussianKernelGenerator, KernelRidgeRegressionEstimator
    from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
    from keystone_tpu_torch.workflow.recovery import fit_with_recovery

    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 16)).astype(np.float32)
    y = rng.normal(size=(128, 2)).astype(np.float32)
    ckpt = os.path.join(tmp, "krr-ckpt")

    class CheckpointedKRR(KernelRidgeRegressionEstimator):
        def fit_dataset(self, data, labels=None):
            return self.fit_stream_dataset(data, labels, spill_dir=os.path.join(tmp, "krr-store"),
                                           checkpoint_dir=ckpt)

    est = CheckpointedKRR(GaussianKernelGenerator(0.05), lam=1e-3, block_size=32, num_epochs=3)
    fit_with_recovery(lambda: est.with_data(StreamDataset(batched(x, 64), n=x.shape[0], device=device),
                                            Dataset(y, device=device)),
                      state_dir=tmp, max_restarts=restarts)


def _lbfgs(tmp, restarts, device):
    from keystone_tpu_torch.models.lbfgs import DenseLBFGSwithL2
    from keystone_tpu_torch.workflow.dataset import Dataset
    from keystone_tpu_torch.workflow.recovery import fit_with_recovery

    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 16)).astype(np.float32)
    y = rng.normal(size=(128, 2)).astype(np.float32)
    ckpt = os.path.join(tmp, "lbfgs-ckpt")

    class CheckpointedLBFGS(DenseLBFGSwithL2):
        def fit_dataset(self, data, labels=None):
            return self.fit_checkpointed(data, labels, checkpoint_dir=ckpt, checkpoint_every=3)

    est = CheckpointedLBFGS(lam=1e-3, num_iterations=9, history=4)
    fit_with_recovery(lambda: est.with_data(Dataset(x, device=device), Dataset(y, device=device)),
                      max_restarts=restarts)


def _stream(tmp, restarts, device):
    from keystone_tpu_torch.loaders.stream import batched
    from keystone_tpu_torch.utils.guard import env_float
    from keystone_tpu_torch.workflow.dataset import StreamDataset

    x = np.random.default_rng(0).normal(size=(512, 8)).astype(np.float32)
    # env_float: "0" disables, as every other guard knob
    ds = StreamDataset(batched(x, 32), n=512, retries=3, timeout=env_float("KEYSTONE_STREAM_TIMEOUT"), device=device)
    total = sum(int(b.shape[0]) for b in ds.batches())
    if total != 512:
        raise RuntimeError(f"stream delivered {total}/512 rows")


def _serve_artifacts(tmp, restarts, device):
    """The bundle ladder under fault: publish two versions with their
    bucket-graph bundles, then deploy → predict → hot-swap → heal a
    crashed replica while the plan batters ``serve.artifact_load``.  A
    damaged, missing or refused bundle makes that deploy, swap or heal
    walk the frozen graph; it never fails it, and answers keep coming."""
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.serve import ModelRegistry, serve
    from keystone_tpu_torch.tools.serve_bench import build_pipeline
    from keystone_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    dim = 16
    reg = ModelRegistry(os.path.join(tmp, "registry"))
    example = np.zeros((dim,), np.float32)
    for seed in (0, 1):
        pipe = build_pipeline(dim=dim, seed=seed, device=dev)
        reg.publish(pipe, artifacts=pipe.freeze(device=dev).export_artifacts(example=example, buckets=(4, 8)))
    fitted, version = reg.load("v0001", map_location=dev)
    svc = serve(fitted, max_batch=8, buckets=(4, 8), example=example, name="chaos_artifacts", replicas=2,
                devices=[dev] * 2, supervise=True, supervise_interval_s=0.05, artifacts=reg.load_artifacts(version))
    x = np.random.default_rng(3).normal(size=(dim,)).astype(np.float32)
    try:
        svc.submit(x).result(timeout=30.0)
        fitted2, v2 = reg.load("v0002", map_location=dev)
        svc.swap(fitted2, version=v2, artifacts=reg.load_artifacts(v2))
        svc.submit(x).result(timeout=30.0)
        # heal: crash one worker, the supervisor must rejoin it
        with faults.inject("serve.worker:ctx.replica=0:raise:times=1"):
            deadline = time.time() + 30.0
            while time.time() < deadline:
                try:
                    svc.submit(x).result(timeout=10.0)
                except Exception:
                    pass
                if svc.supervisor.restarts_total >= 1:
                    break
                time.sleep(0.01)
        if svc.supervisor.restarts_total < 1:
            raise RuntimeError("supervisor never healed the crashed worker")
        if not np.all(np.isfinite(np.asarray(svc.submit(x).result(timeout=30.0)))):
            raise RuntimeError("post-heal prediction is non-finite")
    finally:
        svc.close()


def _tenants(tmp, restarts, device):
    """Multi-tenant containment: two tenants sharing a featurization
    prefix behind one fleet, a wave a tenant under the active plan.  A
    plan aimed at tenant ``a`` (``serve.enqueue:ctx.tenant=a:raise``,
    ``serve.batch:ctx.tenant=a:raise``) may fail ``a``'s requests, typed;
    tenant ``b``'s wave must complete clean.  Raises on any cross-tenant
    failure or unresolved future."""
    from keystone_tpu_torch.serve import serve_multi
    from keystone_tpu_torch.tools.serve_bench import build_tenant_models
    from keystone_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    dim = 16
    models = build_tenant_models(tenants=2, dim=dim, branches=3, device=dev)
    # plans say ctx.tenant=a / ctx.tenant=b
    models = {"a": models.pop("t0"), "b": models.pop("t1")}
    svc = serve_multi(models, max_batch=8, max_wait_ms=2.0, queue_bound=64, example=np.zeros((dim,), np.float32),
                      name="chaos_tenants", devices=[dev])
    xs = np.random.default_rng(5).normal(size=(24, dim)).astype(np.float32)
    try:
        futs = {"a": [], "b": []}
        for i in range(xs.shape[0]):
            for t in ("a", "b"):
                try:
                    futs[t].append(svc.submit(xs[i], tenant=t))
                except Exception:
                    futs[t].append(None)  # a typed admission refusal
        b_failures = 0
        for t, fs in futs.items():
            for f in fs:
                if f is None:
                    b_failures += t == "b"
                    continue
                try:
                    y = np.asarray(f.result(timeout=30.0))
                except _FutTimeout:
                    raise _ChaosCheckFailed(f"a tenant {t} future hung") from None
                except Exception:
                    b_failures += t == "b"
                    continue
                if not np.all(np.isfinite(y)):
                    raise _ChaosCheckFailed(f"tenant {t} non-finite result")
        if b_failures:
            raise _ChaosCheckFailed(f"cross-tenant blast radius: {b_failures} tenant-b request(s) failed under a "
                                    "tenant-a-targeted plan")
    finally:
        svc.close()


def _kill_live_worker(svc, pick) -> bool:
    """SIGKILL one live worker process of a process-backed service, the
    seeded kill of the ``procfleet`` workload and the soak loop.
    ``pick(n) -> index``.  Returns whether a kill landed."""
    pids = [r.get("pid") for r in svc.replica_statuses() if r.get("worker_alive") and r.get("pid")]
    if not pids:
        return False
    try:
        os.kill(pids[int(pick(len(pids)))], signal.SIGKILL)
        return True
    except OSError:
        return False


class _ChaosCheckFailed(RuntimeError):
    """A workload's own acceptance check failed (a non-finite result, a
    hung future, an unhealthy exit wave), as opposed to the typed
    failures the serving layer may answer with (FleetUnavailable, a
    remote error), which are acceptable outcomes."""


def _clean_wave(svc, xs, what: str) -> None:
    """The exit gate: with the faults over, a clean wave must serve 100%
    (retried for up to 30 s while the fleet heals)."""
    deadline = time.monotonic() + 30.0
    clean = 0
    while clean < xs.shape[0] and time.monotonic() < deadline:
        clean = 0
        waiters = []
        for i in range(xs.shape[0]):
            try:
                waiters.append(svc.submit(xs[i]))
            except Exception:
                pass
        for f in waiters:
            try:
                f.result(timeout=30.0)
                clean += 1
            except Exception:
                pass
        if clean < xs.shape[0]:
            time.sleep(0.2)
    if clean < xs.shape[0]:
        raise _ChaosCheckFailed(f"fleet unhealthy after {what}: clean wave served {clean}/{xs.shape[0]}")


def _waves(svc, xs, rng, waves: int, act, what: str, timeout: float) -> None:
    """``waves`` waves of ``xs``, ``act(wave, i)`` called after each
    submit; every future must resolve (a result or a typed failure)."""
    hung = 0
    for wave in range(waves):
        futs = []
        for i in range(xs.shape[0]):
            try:
                futs.append(svc.submit(xs[i]))
            except Exception:
                futs.append(None)  # a typed admission refusal
            act(wave, i)
        for f in futs:
            if f is None:
                continue
            try:
                y = np.asarray(f.result(timeout=timeout))
            except _FutTimeout:
                hung += 1
                continue
            except Exception:
                continue  # a typed failure: an acceptable terminal
            if not np.all(np.isfinite(y)):
                raise _ChaosCheckFailed(f"non-finite result across {what}")
    if hung:
        raise _ChaosCheckFailed(f"{hung} future(s) hung across {what}: the fleet lost admitted work")


def _procfleet(tmp, restarts, device):
    """The process fleet under seeded kills: a workers=2 service takes
    waves of traffic while the workload SIGKILLs live workers mid-wave and
    the plan batters the router-side serve sites.  A worker's death loses
    nothing: its flush requeues onto the supervisor's replacement, every
    future resolves, and after the last kill a clean wave serves 100%."""
    from keystone_tpu_torch.tools.serve_bench import build_service

    svc, item_shape = build_service(dim=8, max_batch=8, max_wait_ms=2.0, queue_bound=256, deadline_ms=None,
                                    workers=2, supervise_interval_s=0.1, heartbeat_s=5.0, restart_limit=10_000,
                                    device=device)
    rng = np.random.default_rng(7 + int(restarts))
    xs = rng.normal(size=(32,) + tuple(item_shape)).astype(np.float32)
    try:
        _waves(svc, xs, rng, 4, lambda wave, i: i == 10 and _kill_live_worker(svc, lambda n: int(rng.integers(n))),
               "worker SIGKILLs", 30.0)
        _clean_wave(svc, xs, "the kills")
    finally:
        svc.close()


def _nethost(tmp, restarts, device):
    """The TCP fleet under a seeded partition: a workers=2 ``hosts=``
    service takes waves while one worker's link is severed mid-wave (both
    directions dropped for ~3 lease windows).  The router declares the
    silent worker dead at lease expiry and re-serves its flush on the
    survivor (nothing lost), the fenced worker rejoins with a fresh lease
    after the heal, and a clean wave serves 100% from two live workers."""
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.tools.serve_bench import build_service

    svc, item_shape = build_service(dim=8, max_batch=8, max_wait_ms=2.0, queue_bound=256, deadline_ms=None,
                                    workers=2, hosts="local:2", supervise_interval_s=0.1, heartbeat_s=10.0,
                                    restart_limit=10_000, worker_opts={"lease_s": 1.0, "spawn_grace_s": 3.0},
                                    device=device)
    rng = np.random.default_rng(11 + int(restarts))
    xs = rng.normal(size=(32,) + tuple(item_shape)).astype(np.float32)
    severs: list = []
    try:
        links = sorted(r.get("link") for r in svc.replica_statuses() if r.get("link"))
        if len(links) < 2:
            raise _ChaosCheckFailed(f"net fleet came up with links {links!r}; expected 2")

        def sever(victim: str) -> None:
            with faults.inject(f"serve.net.send:ctx.link={victim}:drop;serve.net.recv:ctx.link={victim}:drop"):
                time.sleep(3.0)

        def act(wave, i):
            if wave == 1 and i == 10:
                th = threading.Thread(target=sever, args=(links[int(rng.integers(len(links)))],), daemon=True)
                th.start()
                severs.append(th)

        _waves(svc, xs, rng, 4, act, "the partition", 60.0)
        for th in severs:
            th.join(timeout=30.0)
        deadline = time.monotonic() + 60.0
        while len([r for r in svc.replica_statuses() if r.get("worker_alive")]) < 2:
            if time.monotonic() > deadline:
                raise _ChaosCheckFailed("fleet never healed to 2 live workers after the partition lifted")
            time.sleep(0.2)
        _clean_wave(svc, xs, "the partition")
    finally:
        svc.close()


def _rollout(tmp, restarts, device):
    """The guarded-rollout drill: a good version serves while a bad one
    (``MarkerGate``: fails exactly the rows the seeded ``poison_flood``
    marks) is canaried at 50%.  The canary concentrates the failures on
    the staged generation, the judge rolls back on the error rate and
    quarantines the version, the watcher refuses to redeploy it even with
    ``CURRENT`` pointing at it, every future resolves, and a clean wave
    serves from the good version (its answers' norm is its scale)."""
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.serve import ModelRegistry, RegistryWatcher, RolloutConfig, serve
    from keystone_tpu_torch.serve.rollout import CanaryController
    from keystone_tpu_torch.tools import workloads as zoo
    from keystone_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    dim = 8
    reg = ModelRegistry(os.path.join(tmp, "registry"))
    v1 = reg.publish(zoo.build_zoo_pipeline(dim=dim, scale=2.0, gate=False, device=dev))
    v2 = reg.publish(zoo.build_zoo_pipeline(dim=dim, scale=3.0, gate=True, device=dev), set_current=False)
    fitted, ver = reg.load(v1, map_location=dev)
    svc = serve(fitted, version=ver, max_batch=8, max_wait_ms=2.0, queue_bound=512,
                example=np.zeros((dim,), np.float32), name="chaos_rollout", replicas=2, devices=[dev] * 2,
                slo_ms=250.0)
    scenario = zoo.make_scenario("poison_flood", seed=int(restarts), duration_s=2.0, qps=300.0, dim=dim)
    futs: list = []
    futs_lock = threading.Lock()

    def submit(event, rows):
        try:
            fs = svc.submit_many(rows)
        except Exception:
            return None  # a typed admission refusal: a scheduled outcome
        with futs_lock:
            futs.extend(fs)
        return len(fs)

    pump = threading.Thread(target=lambda: zoo.play(scenario, submit, time_scale=1.0), daemon=True)
    try:
        pump.start()
        # judge inside the flood: the clean first third would otherwise
        # commit the bad version before its first marker row
        time.sleep(scenario.duration_s / 3.0)
        cfg = RolloutConfig(canary=0.5, seed=int(restarts), min_samples=16, decide_s=20.0, max_error_rate=0.1,
                            insufficient="rollback")
        info = CanaryController(svc, cfg, registry=reg).run(reg.load(v2, map_location=dev)[0], version=v2)
        if info["verdict"] != "rolled_back":
            raise _ChaosCheckFailed(f"canary let the bad version through: {info!r}")
        if svc.version != v1:
            raise _ChaosCheckFailed(f"service serves {svc.version!r} after rollback, not {v1!r}")
        if reg.quarantined(v2) is None:
            raise _ChaosCheckFailed(f"rollback did not quarantine {v2} in the registry")
        # the watcher must refuse the quarantined version even with
        # CURRENT pointing straight at it
        reg.set_current(v2)
        RegistryWatcher(svc, reg, poll_seconds=3600.0)._poll_once()
        if svc.version != v1:
            raise _ChaosCheckFailed("watcher redeployed a quarantined version")
        reg.set_current(v1)
        pump.join(timeout=30.0)
        if pump.is_alive():
            raise _ChaosCheckFailed("workload pump never finished")
        hung = 0
        with futs_lock:
            pending = list(futs)
        for f in pending:
            try:
                f.result(timeout=30.0)
            except _FutTimeout:
                hung += 1
            except Exception:
                pass  # a typed failure (poison, shed): acceptable
        if hung:
            raise _ChaosCheckFailed(f"{hung} future(s) hung across the abandoned canary generation")
        if metrics.REGISTRY.counter_total("serve.rollout.rollbacks") < 1:
            raise _ChaosCheckFailed("serve.rollout.rollbacks never counted")
        hist = svc.rollout_status()["history"]
        if not hist or hist[-1]["verdict"] != "rolled_back":
            raise _ChaosCheckFailed(f"rollout history missing the rollback: {hist!r}")
        xs = np.random.default_rng(13).normal(size=(16, dim)).astype(np.float32)
        for i in range(xs.shape[0]):
            norm = float(np.linalg.norm(np.asarray(svc.submit(xs[i]).result(timeout=30.0))))
            if abs(norm - 2.0) > 1e-3:
                raise _ChaosCheckFailed(f"post-rollback result norm {norm:.4f} fingerprints the wrong version "
                                        "(want 2.0, the good scale)")
    finally:
        svc.close()


WORKLOADS = {
    "bcd": _bcd,
    "ooc": _ooc,
    "kernel": _kernel,
    "lbfgs": _lbfgs,
    "stream": _stream,
    "serve_artifacts": _serve_artifacts,
    "tenants": _tenants,
    "procfleet": _procfleet,
    "nethost": _nethost,
    "rollout": _rollout,
}

#: workloads that inject their own faults mid-run: runnable without --plan
SELF_INJECTING = frozenset({"nethost", "rollout"})


# --------------------------------------------------------------- soak
#: the serve-path sites a soak plan draws from, with the actions each may
#: carry (crashes exercise the supervisor, delays hedging and shedding,
#: raises containment and bisection).  No ``hang``: an undeadlined hang
#: tests the clock, not the fleet
_SOAK_MENU = (
    ("serve.enqueue", ("raise",)),
    ("serve.batch", ("raise", "delay")),
    ("serve.replica", ("raise", "delay")),
    ("serve.worker", ("raise", "delay")),
)


def _soak_plan(rng) -> str:
    """One randomized, seed-deterministic multi-site plan in the
    KEYSTONE_FAULTS grammar (the reference's generator, draw for draw)."""
    n_sites = rng.randint(1, 3)
    picks = rng.sample(range(len(_SOAK_MENU)), n_sites)
    clauses = []
    for i in picks:
        site, actions = _SOAK_MENU[i]
        action = actions[rng.randrange(len(actions))]
        times = rng.randint(1, 3)
        after = rng.randint(0, 4)
        if action == "delay":
            delay = round(rng.uniform(0.005, 0.05), 4)
            clauses.append(f"{site}:delay={delay}:after={after}:times={times}")
        else:
            clauses.append(f"{site}:raise:after={after}:times={times}")
    return ";".join(clauses)


def run_soak(seconds: float, seed: int = 0, replicas: int = 2, wave: int = 48, result_timeout: float = 30.0,
             workers: int = 0, device="cuda") -> dict:
    """Loop seeded randomized multi-site plans against a live fleet; every
    submitted future must resolve (a result or a typed failure).  Returns
    the report; ``ok`` is False on any hung request or a fleet that cannot
    serve a clean wave at the end."""
    import random

    from keystone_tpu_torch import faults
    from keystone_tpu_torch.tools import serve_bench
    from keystone_tpu_torch.utils import guard

    rng = random.Random(seed)
    fleet_kw = dict(workers=workers) if workers else dict(replicas=replicas)
    # soak services heal aggressively: a short heartbeat, a fast sweep, a
    # restart budget the soak cannot spend
    svc, item_shape = serve_bench.build_service(dim=8, max_batch=8, max_wait_ms=2.0, queue_bound=256,
                                                deadline_ms=None, supervise_interval_s=0.1, heartbeat_s=5.0,
                                                restart_limit=10_000, hedge_ms=25.0, device=device, **fleet_kw)
    payload = np.random.default_rng(seed).normal(size=(wave,) + tuple(item_shape)).astype(np.float32)
    report = {"seconds": seconds, "seed": seed, "replicas": replicas, "workers": workers, "iterations": 0,
              "submitted": 0, "completed": 0, "failed_typed": 0, "rejected": 0, "hung": 0, "process_kills": 0,
              "plans": []}
    try:
        end = time.monotonic() + float(seconds)
        while time.monotonic() < end:
            plan = _soak_plan(rng)
            report["iterations"] += 1
            report["plans"].append(plan)
            # a process fleet loses a worker in about every other iteration
            kill_at = rng.randrange(wave) if workers and rng.random() < 0.5 else None
            futs = []
            with faults.inject(plan):
                for i in range(wave):
                    if i == kill_at and _kill_live_worker(svc, rng.randrange):
                        report["process_kills"] += 1
                    try:
                        futs.append(svc.submit(payload[i]))
                    except Exception:
                        report["rejected"] += 1
                    report["submitted"] += 1
                # resolved inside the plan: mid-flight faults are the point
                for f in futs:
                    try:
                        f.result(timeout=result_timeout)
                        report["completed"] += 1
                    except _FutTimeout:
                        report["hung"] += 1
                    except Exception:
                        report["failed_typed"] += 1
        # the exit gate: after the last plan a clean wave must serve
        clean_ok = 0
        deadline = time.monotonic() + result_timeout
        while clean_ok < wave and time.monotonic() < deadline:
            clean_ok = 0
            futs = []
            for i in range(wave):
                try:
                    futs.append(svc.submit(payload[i]))
                except Exception:
                    pass  # still healing: the wave is retried
            for f in futs:
                try:
                    f.result(timeout=result_timeout)
                    clean_ok += 1
                except Exception:
                    pass
            if clean_ok < wave:
                guard.interruptible_sleep(0.2)
        report["clean_wave_completed"] = clean_ok
        report["clean_wave_size"] = wave
        report["healthy_after_soak"] = clean_ok == wave
    finally:
        svc.close()
    report["ok"] = report["hung"] == 0 and report["healthy_after_soak"]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run a workload under a KEYSTONE_FAULTS plan and report per-site "
                                             "injected/survived counts")
    ap.add_argument("--plan", default=None,
                    help="fault plan, KEYSTONE_FAULTS grammar (e.g. 'ckpt.save:after=1:corrupt;"
                         "blockstore.read:p=0.1:seed=7'); required unless --soak or a self-injecting workload")
    ap.add_argument("--soak", type=float, default=None, metavar="SECONDS",
                    help="soak mode: loop seeded randomized serve.* plans against a live fleet for SECONDS; exits "
                         "non-zero on any lost or hung future or a fleet that cannot serve a clean wave afterwards "
                         "(ignores --plan/--workload)")
    ap.add_argument("--seed", type=int, default=0, help="the soak's plan-generator seed")
    ap.add_argument("--soak-replicas", type=int, default=2, help="the soak service's threaded fleet size")
    ap.add_argument("--soak-workers", type=int, default=0,
                    help="soak a PROCESS fleet of this many workers (0: the threaded fleet), SIGKILLing live "
                         "workers mid-wave")
    ap.add_argument("--workload", default="bcd", help=f"one of {sorted(WORKLOADS)} or module.path:function")
    ap.add_argument("--restarts", type=int, default=1, help="fit_with_recovery's restart budget for the fits")
    ap.add_argument("--device", default="cuda", help="where the workload runs: cuda (default) or cpu")
    ap.add_argument("--tmp", default=None, help="scratch directory (default: a fresh temporary one)")
    ap.add_argument("--ledger", default=None, metavar="DIR",
                    help="write a run ledger under DIR (each restart's fault stats land there)")
    ap.add_argument("--stage-deadline", type=float, default=None, metavar="SECONDS",
                    help="per-stage watchdog budget (KEYSTONE_STAGE_DEADLINE)")
    ap.add_argument("--stage-retries", type=int, default=None, metavar="N",
                    help="stage retry budget (KEYSTONE_STAGE_RETRIES)")
    ap.add_argument("--stream-timeout", type=float, default=None, metavar="SECONDS",
                    help="per-batch fetch watchdog of the 'stream' workload (KEYSTONE_STREAM_TIMEOUT)")
    args = ap.parse_args(argv)

    from keystone_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.soak is not None:
        report = run_soak(args.soak, seed=args.seed, replicas=args.soak_replicas, workers=args.soak_workers,
                          device=device)
        print(json.dumps(report, indent=2))
        return 0 if report["ok"] else 1
    if args.plan is None and args.workload not in SELF_INJECTING:
        ap.error(f"--plan is required (unless --soak, or a self-injecting workload: {sorted(SELF_INJECTING)})")
    for flag, env in ((args.stage_deadline, "KEYSTONE_STAGE_DEADLINE"), (args.stage_retries, "KEYSTONE_STAGE_RETRIES"),
                      (args.stream_timeout, "KEYSTONE_STREAM_TIMEOUT")):
        if flag is not None:
            os.environ[env] = str(flag)

    from keystone_tpu_torch import faults
    from keystone_tpu_torch.obs import ledger as obs_ledger
    from keystone_tpu_torch.obs import metrics

    plan = faults.parse_plan(args.plan) if args.plan is not None else faults.FaultPlan(
        [], source="(workload self-injected)")
    tmp = args.tmp or tempfile.mkdtemp(prefix="kst_chaos_")
    if args.workload in WORKLOADS:
        def run():
            return WORKLOADS[args.workload](tmp, args.restarts, device)
    else:
        modname, _, fnname = args.workload.partition(":")
        run = getattr(importlib.import_module(modname), fnname or "main")

    led = None
    if args.ledger:
        led = obs_ledger.start_run(args.ledger)
        led.event("chaos.start")  # the report names the plan, the workload and this ledger

    faults.reset_stats()
    metrics.reset()  # the report's window starts here
    error = None
    with faults.inject(plan):
        try:
            run()
        except BaseException as e:  # report it; the reporter does not crash
            error = f"{type(e).__name__}: {e}"

    stats = faults.stats()
    # the registry sums across restarts (reset_stats clears only the
    # faults module's window): its per-site counts are the report's
    snap = metrics.snapshot()
    counters = snap.get("counters") or {}
    reg_sites: dict = {}
    for key, v in counters.items():
        for name in ("faults.calls", "faults.injected"):
            if key.startswith(name + "{site="):
                site = key[len(name) + 6:-1]
                reg_sites.setdefault(site, {"calls": 0, "injected": 0})
                reg_sites[site]["calls" if name.endswith("calls") else "injected"] += int(v)
    if reg_sites:
        stats = reg_sites
    escaped_site = None
    if error is not None and "injected fault at" in error:
        for site in faults.SITES:
            if repr(site) in error:
                escaped_site = site
    # every site the plan names is reported, zero calls included: a typo'd
    # trigger must not vanish from the report
    planned = {s.site for s in plan.specs}
    for site in planned:
        stats.setdefault(site, {"calls": 0, "injected": 0})

    def survived(site, counts):
        # claimed only where attributable: a clean run survived what it
        # was given, an escaped fault pins one site, else unknown
        if counts["injected"] == 0:
            return None
        if error is None:
            return counts["injected"]
        if site == escaped_site:
            return counts["injected"] - 1
        return None

    def verdict(site, counts):
        if counts["injected"] == 0:
            return "not-exercised" if site in planned else "no-injections"
        if error is None:
            return "survived"
        return "escaped" if site == escaped_site else "unknown"

    not_exercised = sorted(site for site in planned if stats.get(site, {}).get("injected", 0) == 0)

    def labeled(family: str, name: str, label: str) -> dict:
        out = {}
        prefix = name + "{" + label + "="
        for key, v in (snap.get(family) or {}).items():
            if family == "counters" and key == name:
                out[""] = out.get("", 0) + int(v)
            elif key.startswith(prefix) and key.endswith("}"):
                out[key[len(prefix):-1]] = int(v) if family == "counters" else v
        return out

    report = {
        "plan": args.plan,
        "workload": args.workload,
        "device": str(device),
        "completed": error is None,
        "error": error,
        "not_exercised": not_exercised,
        "sites": {site: {"calls": c["calls"], "injected": c["injected"], "survived": survived(site, c),
                         "verdict": verdict(site, c)} for site, c in sorted(stats.items())},
        # how the guard layer absorbed the plan, and the fleet's healing
        "guard": {
            "deadline_exceeded": labeled("counters", "guard.deadline_exceeded", "site"),
            "breaker_opens": labeled("counters", "breaker.opens", "key"),
            "degraded": labeled("counters", "executor.degraded", "node"),
            "replica_restarts": labeled("counters", "serve.replica_restarts", "replica"),
            "quarantined": labeled("gauges", "serve.quarantined", "replica"),
            "bisections": int(counters.get("serve.bisections", 0)),
            "poison": int(counters.get("serve.poison", 0)),
            "hedges": int(counters.get("serve.hedges", 0)),
        },
    }
    if led is not None:
        led.event("faults.stats", error=error, stats=report["sites"])
        report["ledger"] = led.path
        obs_ledger.stop_run()
    print(json.dumps(report, indent=2))
    if error is not None:
        return 1
    # completed, but a named site never fired: the plan did not test what
    # it claims to
    return 2 if not_exercised else 0


if __name__ == "__main__":
    raise SystemExit(main())
