"""The port's cost-based physical planner (keystone_tpu_torch/planner)
against the JAX package's (keystone_tpu/planner), on the CPU.

Inputs are made from numpy seeds and go through both packages:

- the cost model's curve, pricing and winner rule, and ``build_plan``
  with the same injected runner give the same winners (under the gate
  name mapping ``pallas``→``kernel``, ``xla``→``chain``/``plain``) and
  the same knobs (``max_wait_ms`` and ``hedge_ms`` from the same curve);
- ``PlanTuner`` driven by the same synthetic telemetry emits the same
  retunes, commits and reverts;
- a ``PhysicalPlan`` JSON-round-trips, ``stage_signature`` survives a
  save and load and a re-fit, the plan ships through freeze → manifest →
  registry → install and the pickled applier;
- with no plan and no env every dispatch site resolves as before the
  planner existed, bit for bit.
"""

import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu import planner as jplanner
from keystone_tpu.models.kernel_ridge import GaussianKernelGenerator as JGaussian
from keystone_tpu.models.kernel_ridge import KernelBlockLinearMapper as JKernelMapper
from keystone_tpu.models.linear import LinearMapper as JLinearMapper
from keystone_tpu.models.pca import PCATransformer as JPCA
from keystone_tpu.ops.fisher import FisherVector as JFisherVector
from keystone_tpu.models.gmm import GaussianMixtureModel as JGMM
from keystone_tpu.ops.stats import NormalizeRows as JNormalizeRows
from keystone_tpu.planner import cost as jcost
from keystone_tpu.planner.plan import PhysicalPlan as JPhysicalPlan
from keystone_tpu.serve.autoscale import Signals as JSignals
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu_torch import faults, planner
from keystone_tpu_torch.models.gmm import GaussianMixtureModel
from keystone_tpu_torch.models.kernel_ridge import GaussianKernelGenerator, KernelBlockLinearMapper
from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.models.pca import PCATransformer
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.ops.fisher import FisherVector, FusedPcaFisherVector
from keystone_tpu_torch.ops.stats import NormalizeRows
from keystone_tpu_torch.planner import cost
from keystone_tpu_torch.planner import registry as plans
from keystone_tpu_torch.planner.plan import PhysicalPlan, StageChoice, stage_signature
from keystone_tpu_torch.serve import ModelRegistry, serve
from keystone_tpu_torch.serve.autoscale import Signals
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.workflow import optimizer as O
from keystone_tpu_torch.workflow import profiling
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline

pytestmark = pytest.mark.serve

DIM = 8
CLASSES = 3
#: the reference's gate candidates under the port's names
NAME_MAP = {"fused_fv": {"pallas": "kernel", "xla": "chain"}, "gram_pallas": {"pallas": "kernel", "xla": "plain"},
            "matmul": {}}


@pytest.fixture(autouse=True)
def _no_installed_plan(monkeypatch):
    """Every test starts and ends on the no-plan path, in both packages."""
    monkeypatch.setenv("KEYSTONE_COMPILE_CACHE", "0")
    monkeypatch.delenv("KEYSTONE_FUSED_FV", raising=False)
    monkeypatch.delenv("KEYSTONE_POOL_BUDGET_BYTES", raising=False)
    planner.clear_plan()
    jplanner.clear_plan()
    yield
    planner.clear_plan()
    jplanner.clear_plan()


# ------------------------------------------------------------- fixtures
def _weights(seed=0, classes=CLASSES):
    return np.random.default_rng(seed).normal(size=(DIM, classes)).astype(np.float32)


def _linear(seed=0, classes=CLASSES):
    w = _weights(seed, classes)
    return ((Pipeline.of(NormalizeRows()) | LinearMapper(torch.from_numpy(w))).fit(),
            (JPipeline.of(JNormalizeRows()) | JLinearMapper(jnp.asarray(w))).fit())


def _fisher(seed=0):
    """PCA (16 → 4) then a Fisher vector of K = 3, over (n, 6, 16)
    descriptor sets."""
    rng = np.random.default_rng(seed)
    comp = np.linalg.qr(rng.normal(size=(16, 16)))[0][:, :4].astype(np.float32)
    mean = (0.1 * rng.normal(size=16)).astype(np.float32)
    w = np.full(3, 1 / 3, np.float32)
    mu = rng.normal(size=(3, 4)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, size=(3, 4)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in dict(comp=comp, mean=mean, w=w, mu=mu, var=var).items()}
    port = (Pipeline.of(PCATransformer(t["comp"], t["mean"]))
            | FisherVector(GaussianMixtureModel(t["w"], t["mu"], t["var"]))).fit()
    ref = (JPipeline.of(JPCA(jnp.asarray(comp), jnp.asarray(mean)))
           | JFisherVector(JGMM(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var)))).fit()
    return port, ref


def _kernel(seed=0):
    rng = np.random.default_rng(seed)
    tx = rng.normal(size=(16, DIM)).astype(np.float32)
    alpha = rng.normal(size=(16, CLASSES)).astype(np.float32)
    port = Pipeline.of(KernelBlockLinearMapper(GaussianKernelGenerator(0.1), torch.from_numpy(tx),
                                               torch.from_numpy(alpha), 8, 16)).fit()
    ref = JPipeline.of(JKernelMapper(JGaussian(0.1), jnp.asarray(tx), jnp.asarray(alpha), 8, 16)).fit()
    return port, ref


def _example(kind, n=32, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n, 6, 16) if kind == "fisher" else (n, DIM)
    return rng.normal(size=shape).astype(np.float32)


def _flat_runner(costs):
    """An injected deterministic timer: ``costs[(gate, candidate)]`` is the
    (a, b) of a seconds = a + b·n line (either package's candidate name)."""

    def run(fn, *, gate, candidate, n, **_kw):
        a, b = costs.get((gate, candidate), (1e-3, 1e-6))
        return a + b * float(n)

    return run


def _mapped(gate, name):
    return NAME_MAP[gate].get(name, name)


# ------------------------------------------------------------ cost model
@pytest.mark.parametrize("samples", [
    [(8, 1.8), (32, 4.2), (128, 13.8)],
    [(8, 2e-3), (32, 2.5e-3), (128, 3.9e-3)],
    [(32, 2.0)],
    [(8, 5.0), (16, 1.0)],  # a falling curve clamps b at 0
    [],
])
def test_fit_curve_and_price_match_the_reference(samples):
    got, want = cost.fit_curve(samples), jcost.fit_curve(samples)
    assert got == pytest.approx(want, abs=1e-12)
    for n in (1, 32, 128):
        assert cost.price(got, n) == pytest.approx(jcost.price(want, n), abs=1e-12)


@pytest.mark.parametrize("d_cost,b_cost", [(1.0, 0.5), (1.0, 0.99), (1.0, 1.5), (0.0, 0.0)])
def test_pick_winner_matches_the_reference(d_cost, b_cost):
    """The tie margin keeps the static default against a candidate within
    2 %; the cheaper one wins otherwise (the matmul gate: same names)."""
    from keystone_tpu.planner.plan import CandidateCost as JCost
    from keystone_tpu_torch.planner.plan import CandidateCost

    port = {"auto": CandidateCost("auto", full_seconds=d_cost), "f32": CandidateCost("f32", full_seconds=b_cost)}
    ref = {"auto": JCost("auto", full_seconds=d_cost), "f32": JCost("f32", full_seconds=b_cost)}
    assert cost._pick_winner("matmul", port) == jcost._pick_winner("matmul", ref)


@pytest.mark.parametrize("coeffs", [(0.002, 0.0001), (0.0001, 1e-6), (0.05, 0.002), None])
def test_select_knobs_match_the_reference(coeffs):
    got, want = cost.select_knobs(coeffs, max_batch=32), jcost.select_knobs(coeffs, max_batch=32)
    for k in ("buckets", "dispatch_window", "max_wait_ms", "hedge_ms"):
        assert got.get(k) == want.get(k), k
    assert got["pool_budget_bytes"] >= 1 << 20


@pytest.mark.parametrize("kind,costs", [
    ("linear", {}),
    ("linear", {("matmul", "auto"): (0.02, 0.001)}),
    ("fisher", {("fused_fv", "xla"): (3e-3, 1e-5), ("fused_fv", "chain"): (3e-3, 1e-5),
                ("matmul", "auto"): (4e-3, 2e-4)}),
    ("kernel", {("gram_pallas", "xla"): (1e-3, 1e-4), ("gram_pallas", "plain"): (1e-3, 1e-4),
                ("matmul", "auto"): (2e-3, 1e-4)}),
])
def test_build_plan_matches_the_reference_under_the_same_runner(kind, costs):
    """The same pipeline, the same example rows and the same injected
    timer: the same stages, winners (mapped) and knobs in both packages."""
    port, ref = {"linear": _linear, "fisher": _fisher, "kernel": _kernel}[kind]()
    x = _example(kind)
    run = _flat_runner(costs)
    got = planner.build_plan(port, example=x, seed=7, runner=run, device="cpu")
    want = jplanner.build_plan(ref, example=x, seed=7, runner=run)
    assert [s.gate for s in got.stages] == [s.gate for s in want.stages]
    assert [s.winner for s in got.stages] == [_mapped(s.gate, s.winner) for s in want.stages]
    for gs, ws in zip(got.stages, want.stages):
        assert [c.name for c in gs.candidates] == [_mapped(ws.gate, c.name) for c in ws.candidates]
        if gs.gate == "gram_pallas":
            # pinned in the port (one candidate a backend), never sampled
            assert [c.samples for c in gs.candidates] == [[]] and gs.why.startswith("pinned")
            continue
        assert [c.samples for c in gs.candidates] == [c.samples for c in ws.candidates]
        assert [c.coeffs for c in gs.candidates] == pytest.approx([c.coeffs for c in ws.candidates])
    for k in ("buckets", "dispatch_window", "max_wait_ms", "hedge_ms"):
        assert got.knobs.get(k) == want.knobs.get(k), k
    assert got.backend == want.backend == "cpu"
    assert got.batch_sizes == want.batch_sizes


def test_cost_model_is_deterministic_under_a_fixed_seed():
    fitted, _ = _fisher()
    x = _example("fisher")
    run = _flat_runner({("matmul", "auto"): (1e-3, 1e-6)})
    p1 = planner.build_plan(fitted, example=x, seed=7, runner=run, device="cpu")
    p2 = planner.build_plan(fitted, example=x, seed=7, runner=run, device="cpu")
    assert p1.to_json() == p2.to_json() and p1.fingerprint() == p2.fingerprint()
    assert planner.build_plan(fitted, example=x, seed=8, runner=run, device="cpu").seed == 8
    assert p1.choice_for("fused_fv") == "chain"  # the CPU runs the chain alone
    assert p1.choice_for("matmul") == "auto"
    for s in p1.stages:
        for c in s.candidates:
            assert c.samples, f"candidate {c.name} shipped no samples"


def _two_branch_fisher():
    """Two PCA → FV branches over one input (the scorer's SIFT and LCS
    pair, small)."""
    a, _ = _fisher(0)
    b, _ = _fisher(1)
    return Pipeline.gather([a, b]).fit()


@pytest.mark.parametrize("costs,want", [
    # the first branch prefers the kernel, the second the chain by more
    ({"kernel": [(1.0e-3, 0.0), (2.0e-3, 0.0)], "chain": [(1.1e-3, 0.0), (1.5e-3, 0.0)]}, "chain"),
    ({"kernel": [(1.0e-3, 0.0), (2.0e-3, 0.0)], "chain": [(1.5e-3, 0.0), (1.9e-3, 0.0)]}, "kernel"),
    # within the tie margin over both: the default stays
    ({"kernel": [(1.0e-3, 0.0), (1.0e-3, 0.0)], "chain": [(0.99e-3, 0.0), (0.995e-3, 0.0)]}, "kernel"),
])
def test_a_gate_sampled_at_two_stages_gets_one_choice(costs, want):
    """The gate is one switch for the graph: its stages share the winner
    cheapest over their sum, so the plan status and the dispatch agree."""
    fitted = _two_branch_fisher()
    seen = []

    def run(fn, *, gate, candidate, n, **_kw):
        if gate != "fused_fv":
            return 1e-3
        key = (candidate, n)
        seen.append(key)
        branch = seen.count(key) - 1  # the stages are sampled in turn, one call a size and candidate
        a, b = costs[candidate][branch]
        return a + b * n

    plan = planner.build_plan(fitted, example=_example("fisher"), runner=run, device="cpu",
                              candidates={"fused_fv": ("kernel", "chain")}, batch_sizes=(8, 16, 32))
    fv = [s for s in plan.stages if s.gate == "fused_fv"]
    assert len(fv) == 2 and {s.winner for s in fv} == {want} and plan.choice_for("fused_fv") == want
    planner.install_plan(plan)
    assert plans.plan_status()["choices"]["fused_fv"] == want


def test_fault_site_delay_flips_the_winner_both_ways():
    """Stalling one candidate's timed region through the ``plan.sample``
    fault site makes the other win, in the port as in the reference."""
    fitted, ref = _linear()
    x = _example("linear")
    kw = dict(example=x, batch_sizes=(4, 8), full_batch=8, seed=0, candidates={"matmul": ("auto", "f32")})
    for slow, other in (("auto", "f32"), ("f32", "auto")):
        with faults.inject(f"plan.sample:ctx.candidate={slow}:delay=0.05"):
            got = planner.build_plan(fitted, device="cpu", **kw)
        assert got.choice_for("matmul") == other
        (stage,) = [s for s in got.stages if s.gate == "matmul"]
        assert {c.name: c for c in stage.candidates}[slow].full_seconds >= 0.05
        from keystone_tpu import faults as jfaults

        with jfaults.inject(f"plan.sample:ctx.candidate={slow}:delay=0.05"):
            want = jplanner.build_plan(ref, **kw)
        assert want.choice_for("matmul") == other


def test_a_candidate_that_fails_fails_the_build():
    """No fallback hides a candidate: one that raises fails the plan."""
    fitted, _ = _fisher()

    def run(fn, *, gate, candidate, n, **_kw):
        if gate == "fused_fv":
            raise RuntimeError("kernel launch failed")
        return 1e-3

    with pytest.raises(cost.PlanSamplingError, match="fused_fv/chain"):
        planner.build_plan(fitted, example=_example("fisher"), runner=run, device="cpu")


# ------------------------------------------------------- plan + registry
def test_plan_json_roundtrip_and_validation():
    fitted, _ = _linear()
    plan = planner.build_plan(fitted, example=_example("linear"), seed=3, runner=_flat_runner({}), device="cpu")
    back = PhysicalPlan.from_json(plan.to_json())
    assert back.fingerprint() == plan.fingerprint() and back.to_dict() == plan.to_dict()
    assert plan.validate(backend="cpu") == []
    # the reference reads the port's plan JSON (the same schema and format)
    assert JPhysicalPlan.from_json(plan.to_json()).to_json() == plan.to_json()
    d = plan.to_dict()
    d["format"] = 99
    with pytest.raises(ValueError):
        PhysicalPlan.from_dict(d)
    bad = PhysicalPlan(backend="cpu", stages=[
        StageChoice(gate="nope", signature="s", label="l", winner="x", why=""),
        StageChoice(gate="matmul", signature="s", label="l", winner="fp4", why=""),
        StageChoice(gate="fused_fv", signature="s", label="l", winner="kernel", why=""),
        StageChoice(gate="gram_pallas", signature="s", label="l", winner="plain", why=""),
        StageChoice(gate="matmul", signature="s", label="l", winner="bf16", why=""),
    ], knobs={"max_wait_ms": 1e9})
    # unknown gate, non-candidate, the card's kernel on the CPU, bf16 (no
    # backend of the port), a bad knob; the CPU's plain gram chain is
    # runnable there
    assert [c for c, _ in bad.validate(backend="cpu")].count("bad-plan-candidate") == 5
    assert [c for c, _ in bad.validate(backend="cuda")].count("bad-plan-candidate") == 5  # plain is not, kernel is


@pytest.mark.parametrize("gate,backend,want", [
    ("fused_fv", "cuda", ("kernel", "chain")), ("fused_fv", "cpu", ("chain",)),
    ("gram_pallas", "cuda", ("kernel",)), ("gram_pallas", "cpu", ("plain",)),
    ("matmul", "cuda", ("auto", "f32")), ("matmul", "cpu", ("auto", "f32")),
])
def test_supported_candidates_on_the_card_and_the_cpu(gate, backend, want):
    assert plans.supported_candidates(gate, backend=backend) == want
    # the reference's CPU sets, under the name mapping
    if backend == "cpu" and gate != "matmul":
        from keystone_tpu.planner import registry as jplans

        assert tuple(_mapped(gate, c) for c in jplans.supported_candidates(gate, backend="cpu")) == want


def test_registry_precedence_forced_over_plan_over_nothing():
    assert plans.planned_gate("fused_fv") is None and plans.planned_knob("max_wait_ms") is None
    assert plans.plan_status() is None
    plan = PhysicalPlan(backend="cpu", stages=[StageChoice(gate="fused_fv", signature="s", label="l", winner="chain",
                                                           why="test")],
                        knobs={"max_wait_ms": 2.5, "buckets": [4, 2]}, source="test")
    planner.install_plan(plan)
    assert plans.planned_gate("fused_fv") == "chain"
    assert plans.planned_knob("max_wait_ms") == 2.5 and plans.planned_knob("buckets") == (2, 4)
    assert plans.planned_knob("hedge_ms") is None
    status = plans.plan_status()
    assert status["source"] == "install" and status["choices"] == {"fused_fv": "chain"}
    with plans.forced("fused_fv", "kernel"):
        assert plans.planned_gate("fused_fv") == "kernel"
    assert plans.planned_gate("fused_fv") == "chain"
    plan.stages[0].winner = "not-a-candidate"
    assert plans.planned_gate("fused_fv") is None
    plan.knobs["max_wait_ms"] = -4.0
    assert plans.planned_knob("max_wait_ms") is None
    with pytest.raises(ValueError):
        with plans.forced("fused_fv", "pallas"):
            pass


def test_a_plan_never_changes_the_precision_mode():
    """The matmul stage records the forward's curve and no dispatch site
    reads it: a plan that picked bf16 (hand-edited or foreign) leaves the
    mode f32, and the analysis plan pass flags the pick."""
    from keystone_tpu_torch.analysis import plan as plan_pass

    bad = PhysicalPlan(backend="cpu", stages=[
        StageChoice(gate="matmul", signature="pipeline:s", label="<forward>", winner="bf16", why="test")])
    planner.install_plan(bad)
    assert precision.matmul_mode() == "f32" and precision.fdtype() == torch.float32
    with precision.matmul("bf16"):  # the explicit mode alone moves it
        assert precision.matmul_mode() == "bf16"
    assert precision.matmul_mode() == "f32"
    found = plan_pass.run(None)
    assert [(f.code, f.severity) for f in found] == [("bad-plan-candidate", "warning")]
    assert "'bf16'" in found[0].message


@pytest.mark.parametrize("gate_env,planned,want", [
    (None, None, "kernel"), (None, "chain", "chain"), (None, "kernel", "kernel"),
    ("0", None, "chain"), ("1", "chain", "kernel"), ("0", "kernel", "chain"),
])
def test_fused_fv_gate_precedence(monkeypatch, gate_env, planned, want):
    """``KEYSTONE_FUSED_FV`` > the installed plan > the static default
    (the fused kernel), and the frozen graph follows the resolution where
    the rule may fire (``device_is_cuda`` patched, as on the card)."""
    if gate_env is not None:
        monkeypatch.setenv("KEYSTONE_FUSED_FV", gate_env)
    if planned is not None:
        planner.install_plan(PhysicalPlan(backend="cuda", stages=[
            StageChoice(gate="fused_fv", signature="s", label="l", winner=planned, why="test")]))
    assert O.fused_fv_choice() == want
    fitted, _ = _fisher()
    monkeypatch.setattr(O, "device_is_cuda", lambda device: True)
    app = fitted.freeze(device="cpu")
    fused = any(isinstance(getattr(op, "transformer", None), FusedPcaFisherVector)
                for op in app.graph.operators.values())
    assert fused == (want == "kernel") and app.physical_choices == {"fused_fv": want}


def _sift_fisher(seed=0):
    """SIFT (normalizing) → PCA (128 → 4) → FV of K = 3 over small gray
    images: the scorer's SIFT branch, narrow."""
    from keystone_tpu_torch.ops.sift import SIFTExtractor

    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    comp = np.linalg.qr(rng.normal(size=(128, 128)))[0][:, :4].astype(np.float32)
    gmm = GaussianMixtureModel(t(np.full(3, 1 / 3, np.float32)), t(rng.normal(size=(3, 4)).astype(np.float32)),
                               t(rng.uniform(0.5, 1.5, size=(3, 4)).astype(np.float32)))
    pipe = (Pipeline.of(SIFTExtractor(step=8)) | PCATransformer(t(comp), t(np.zeros(128, np.float32)))
            | FisherVector(gmm)).fit()
    return pipe, rng.random((5, 40, 40)).astype(np.float32)


@pytest.mark.parametrize("feed", ["sift", "descriptors"])
def test_fused_fv_samples_what_the_rule_installs(monkeypatch, feed):
    """Each sampled candidate is what the plan would install: the kernel
    candidate reads the rows the rule's fused node reads (raw descriptors
    where a normalizing SIFT feeds the PCA alone, the rule folding the
    normalize into B1) and answers as that node does, and the chain
    answers as the unfused graph, bit for bit."""
    from keystone_tpu_torch.workflow import graph as G
    from keystone_tpu_torch.workflow.executor import GraphExecutor

    if feed == "sift":
        fitted, x = _sift_fisher()
    else:
        fitted, _ = _fisher()
        x = _example("fisher", n=5)
    bound, _ = fitted.graph.replace_source_with_node(fitted.source, G.DatasetOperator(Dataset(torch.from_numpy(x))))

    def rows(g, node):
        ds = GraphExecutor(g).execute(node).dataset
        return ds.array if ds.mask is None else (ds.array, ds.mask)

    def deps(g, node):
        return g.dependencies[node]

    (fv_node,) = [n for n, op in bound.operators.items() if isinstance(getattr(op, "transformer", None), FisherVector)]
    label, fns, arr = cost.fused_fv_candidates(bound, fv_node, bound.operators[fv_node].transformer,
                                               lambda n: rows(bound, deps(bound, n)[0]), ("kernel", "chain"))
    monkeypatch.setattr(O, "device_is_cuda", lambda device: True)
    fused_graph = O.FvFusionRule().apply(bound)
    (fused_node,) = [n for n, op in fused_graph.operators.items()
                     if isinstance(getattr(op, "transformer", None), FusedPcaFisherVector)]
    fused = fused_graph.operators[fused_node].transformer
    assert fused.sift_normalize == (feed == "sift") and label.startswith("SIFTExtractor->") == (feed == "sift")
    want_in = rows(fused_graph, deps(fused_graph, fused_node)[0])
    got_in = arr if isinstance(arr, tuple) else (arr,)
    want_in = want_in if isinstance(want_in, tuple) else (want_in,)
    assert len(got_in) == len(want_in) and all(torch.equal(a, b) for a, b in zip(got_in, want_in))
    assert torch.equal(fns["kernel"](arr), rows(fused_graph, fused_node))
    assert torch.equal(fns["chain"](arr), rows(bound, fv_node))


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_signature_survives_save_load_and_refit(tmp_path, seed):
    """The signature hashes params() without the tensors' object ids, and
    the fitted tensors' shapes and dtypes: stable across a save and load
    (new ids) and a re-fit (new values), changed by a new width."""
    from keystone_tpu_torch.models.linear import LinearMapEstimator

    rng = np.random.default_rng(seed)

    def fit(s):
        x = torch.from_numpy(np.random.default_rng(s).normal(size=(32, DIM)).astype(np.float32))
        y = torch.from_numpy(np.random.default_rng(s + 1).normal(size=(32, CLASSES)).astype(np.float32))
        return (Pipeline.of(NormalizeRows()).and_then(LinearMapEstimator(lam=0.1), Dataset(x), Dataset(y))).fit()

    def sigs(p):
        return [stage_signature(op.transformer) for op in p.graph.operators.values()
                if getattr(op, "transformer", None) is not None]

    a = fit(int(rng.integers(100)))
    path = str(tmp_path / "m.pt")
    a.save(path)
    assert sigs(FittedPipeline.load(path)) == sigs(a)
    assert sigs(fit(1000 + seed)) == sigs(a)  # a re-fit, other weights
    other, _ = _linear(classes=CLASSES + 1)
    assert sigs(other)[-1] != sigs(a)[-1]  # another width


# ------------------------------------------------- shipping (the tentpole)
def test_plan_ships_freeze_manifest_registry_spawn(tmp_path):
    fitted, _ = _linear()
    x = _example("linear")
    frozen = fitted.freeze(plan=True, example=x, device="cpu")
    plan = frozen.plan
    fp = plan.fingerprint()
    assert plans.plan_status()["source"] == "freeze"
    bundle = frozen.export_artifacts(example=x[0], buckets=(2, 4))
    assert bundle["manifest"]["plan"] == plan.to_dict()
    reg = ModelRegistry(str(tmp_path / "registry"))
    version = reg.publish(fitted, artifacts=bundle)
    arts = reg.load_artifacts(version)
    assert arts["manifest"]["plan"] == plan.to_dict()
    # a fresh host installs the bundle: on the CPU its graphs are refused
    # (backend skew) but the shipped plan is this pipeline's, reinstalled
    planner.clear_plan()
    loaded, got_version = reg.load()
    assert got_version == version
    ap2 = loaded.freeze(device="cpu")
    assert ap2.install_artifacts(arts) == 0
    assert ap2.plan.fingerprint() == fp and planner.current_plan().fingerprint() == fp
    assert plans.plan_status()["source"] == "artifacts"
    # another pipeline's bundle does not install its plan
    planner.clear_plan()
    other, _ = _linear(seed=5)
    assert other.freeze(device="cpu").install_artifacts(arts) == 0 and planner.current_plan() is None
    # the pickled applier (replica clone, worker payload) carries the plan
    ap3 = pickle.loads(pickle.dumps(frozen))
    assert ap3.plan.fingerprint() == fp and ap3.physical_choices == frozen.physical_choices
    # the planned freeze serves the static path's bytes
    planner.clear_plan()
    y_static = fitted.freeze(device="cpu")(Dataset(torch.from_numpy(x))).array
    planner.install_plan(plan)
    assert torch.equal(frozen(Dataset(torch.from_numpy(x))).array, y_static)


def test_worker_payload_carries_the_plan(tmp_path):
    """The process fleet's payload carries the router's installed plan, and
    the worker installs it (``source="spawn"``) before it freezes."""
    from keystone_tpu_torch.serve import worker
    from keystone_tpu_torch.serve.procfleet import stage_payload

    fitted, _ = _linear()
    plan = PhysicalPlan(backend="cpu", knobs={"max_wait_ms": 3.0})
    planner.install_plan(plan, source="serve")
    path = stage_payload(str(tmp_path), 1, fitted, None)
    planner.clear_plan()
    applier, installed = worker._build_applier(worker.load_payload(path, torch.device("cpu")), torch.device("cpu"))
    assert installed == 0 and planner.current_plan().fingerprint() == plan.fingerprint()
    assert plans.plan_status()["source"] == "spawn"


def test_a_shipped_plan_that_flips_the_gate_reoptimizes(monkeypatch):
    """An applier frozen under the static default (fused) installs a bundle
    whose plan picked the chain: its graph is re-optimized under the plan,
    and the bucket programs registered before are dropped for fresh ones
    (a graph captured under the other choice never replays)."""
    fitted, _ = _fisher()
    monkeypatch.setattr(O, "device_is_cuda", lambda device: True)
    app = fitted.freeze(device="cpu")
    assert app.physical_choices == {"fused_fv": "kernel"}
    sentinel = object()
    key = ((4, 6, 16), "float32")
    from keystone_tpu_torch.workflow.pipeline import _BucketGraph

    app._bucket_programs[key] = _BucketGraph(app, key[0], key[1])
    app._bucket_programs[key].graph = sentinel  # "captured"
    plan = PhysicalPlan(backend="cuda", stages=[StageChoice(gate="fused_fv", signature="s", label="l",
                                                            winner="chain", why="test")])
    bundle = {"manifest": {"format": app.ARTIFACT_FORMAT, "signature": app.fingerprint(), "plan": plan.to_dict()},
              "blobs": {}}
    app.install_artifacts(bundle)  # the graphs are refused on the CPU, the plan is not
    assert app.physical_choices == {"fused_fv": "chain"}
    assert not any(isinstance(getattr(op, "transformer", None), FusedPcaFisherVector)
                   for op in app.graph.operators.values())
    assert app._bucket_programs[key].graph is None


def test_service_knobs_resolve_explicit_over_plan_over_default():
    fitted, _ = _linear()
    example = np.zeros((DIM,), np.float32)
    plan = PhysicalPlan(backend="cpu", knobs={"buckets": [2, 4], "max_wait_ms": 2.5, "dispatch_window": 3,
                                              "hedge_ms": 75.0}, source="test")
    planner.install_plan(plan)
    with serve(fitted, max_batch=8, example=example, name="plan_knobs", supervise=False, devices=["cpu"]) as svc:
        assert svc.buckets == (2, 4, 8)
        assert svc.max_wait_s == pytest.approx(0.0025)
        assert svc._pool.window == 3 and svc._hedge_floor_s == pytest.approx(0.075)
        assert svc.status()["plan"]["fingerprint"] == plan.fingerprint()
    with serve(fitted, max_batch=8, example=example, name="plan_knobs2", supervise=False, devices=["cpu"],
               max_wait_ms=7.0, buckets=(8,), hedge_ms=None) as svc:
        assert svc.buckets == (8,) and svc.max_wait_s == pytest.approx(0.007) and svc._hedge_floor_s is None
    planner.clear_plan()
    with serve(fitted, max_batch=8, example=example, name="plan_knobs3", supervise=False, devices=["cpu"]) as svc:
        assert svc.max_wait_s == pytest.approx(0.005) and svc.buckets == (8,) and svc._pool.window == 2
        assert svc._hedge_floor_s is None and svc.status()["plan"] is None


def test_the_service_installs_the_plan_a_frozen_applier_ships():
    fitted, _ = _linear()
    plan = PhysicalPlan(backend="cpu", knobs={"max_wait_ms": 1.5}, source="test")
    frozen = fitted.freeze(device="cpu", plan=plan)
    planner.clear_plan()
    with serve(frozen, max_batch=8, example=np.zeros(DIM, np.float32), supervise=False, devices=["cpu"]) as svc:
        assert svc.max_wait_s == pytest.approx(0.0015) and plans.plan_status()["source"] == "serve"


def test_no_plan_no_env_resolves_every_site_as_before(monkeypatch):
    """The inert path: with no plan and no env every dispatch site takes
    its static default, and a frozen apply is the lazy apply bit for bit."""
    assert planner.current_plan() is None
    assert O.fused_fv_choice() == "kernel" and precision.matmul_mode() == "f32"
    assert profiling.pool_budget_bytes() == profiling.device_hbm_budget(fraction=0.25, device=None)
    fitted, _ = _fisher()
    x = torch.from_numpy(_example("fisher", n=5))
    assert torch.equal(fitted.freeze(device="cpu")(Dataset(x)).array, fitted(Dataset(x)).get().array)
    monkeypatch.setattr(O, "device_is_cuda", lambda device: True)
    app = fitted.freeze(device="cpu")
    assert any(isinstance(getattr(op, "transformer", None), FusedPcaFisherVector)
               for op in app.graph.operators.values())
    assert app.plan is None and app.export_artifacts(example=np.zeros((6, 16), np.float32),
                                                     buckets=(4,))["manifest"].get("plan") is None


def test_pool_budget_knob_precedence(monkeypatch):
    planner.install_plan(PhysicalPlan(backend="cpu", knobs={"pool_budget_bytes": 1 << 24}))
    assert profiling.pool_budget_bytes() == 1 << 24
    monkeypatch.setenv("KEYSTONE_POOL_BUDGET_BYTES", str(1 << 22))
    assert profiling.pool_budget_bytes() == 1 << 22


def test_retune_buckets_guardrails(monkeypatch):
    fitted, _ = _linear()
    with serve(fitted, max_batch=8, example=np.zeros((DIM,), np.float32), name="plan_retune", supervise=False,
               devices=["cpu"]) as svc:
        assert svc.retune_buckets((2, 4)) == (2, 4, 8)
        out = np.asarray(svc.submit(np.ones((DIM,), np.float32)).result(timeout=30))
        assert np.all(np.isfinite(out))
        for bad in ((), (0,)):
            with pytest.raises(ValueError):
                svc.retune_buckets(bad)
        assert svc.buckets == (2, 4, 8)
        # a retuned bucket with no graph walks, counted apart from the
        # artifact fallbacks, until the next prime
        monkeypatch.setattr(type(svc._pool.replicas[0].applier), "installed_buckets", lambda self: 1)
        w0 = metrics.REGISTRY.counter_total("serve.retuned_bucket_walks")
        f0 = metrics.REGISTRY.counter_total("serve.artifact_fallbacks")
        svc.submit(np.ones((DIM,), np.float32)).result(timeout=30)
        assert metrics.REGISTRY.counter_total("serve.retuned_bucket_walks") == w0 + 1
        assert metrics.REGISTRY.counter_total("serve.artifact_fallbacks") == f0
        svc.prime()
        svc.submit(np.ones((DIM,), np.float32)).result(timeout=30)
        assert metrics.REGISTRY.counter_total("serve.retuned_bucket_walks") == w0 + 1


# --------------------------------------------------------------- PlanTuner
class _StubService:
    """The tuner's service surface without threads: buckets and
    retune_buckets, no process workers, an autoscaler owning the window."""

    name = "stub"
    workers = 0
    _closing = False
    recorder = None

    def __init__(self):
        self.buckets = (8, 32)
        self.max_batch = 32
        self.autoscaler = object()

    def retune_buckets(self, buckets):
        self.buckets = tuple(buckets)
        return self.buckets


def _tuner(mod, svc, plan, clock, rows, burn, signals_cls):
    return mod.PlanTuner(svc, plan=plan, clock=clock,
                         signal_source=lambda: signals_cls(workers=1, queue_depth=0, queue_bound=64, occupancy=0.2,
                                                           burn_rate=0.0, pool_hit_rate=None),
                         rows_source=rows, burn_source=burn, bake_s=1.0, bake_max_burn=2.0, min_samples=2,
                         cooldown_s=0.0)


def _drift_telemetry():
    """The workload zoo's drift scenario folded into tick-by-tick
    telemetry: flush occupancy from the event sizes, burn from the
    drifted share of each slice."""
    from keystone_tpu_torch.tools.workloads import make_scenario

    scenario = make_scenario("drift", seed=3, duration_s=2.0, qps=100, dim=DIM)
    ticks = 8
    per = max(1, len(scenario.events) // ticks)
    slices = [scenario.events[i * per:(i + 1) * per] for i in range(ticks)]
    times = [i * 0.45 for i in range(ticks)]

    def rows_at(i, state):
        sl = slices[min(i, ticks - 1)]
        state["count"] += len(sl)
        state["sum"] += float(sum(e["rows"] for e in sl))
        return {"count": state["count"], "sum": state["sum"]}

    def burn_at(i):
        sl = slices[min(i, ticks - 1)]
        drifted = sum(1 for e in sl if (e.get("shift") or 0.0) > 2.0)
        return {"burn_rate": 6.0 if drifted > len(sl) / 2 else 0.0, "window_requests": len(sl)}

    return times, rows_at, burn_at


def _scripted(case):
    """(times, rows_at(i, state), burn_at(i)) of one telemetry script."""
    if case == "drift":
        return _drift_telemetry()

    def rows_at(i, state):  # every tick: 10 flushes averaging 1.4 rows
        state["count"] += 10
        state["sum"] += 14.0
        return {"count": state["count"], "sum": state["sum"]}

    if case == "commit":
        return [0.0, 0.1, 0.5, 1.2, 1.3], rows_at, lambda i: {"burn_rate": 0.0, "window_requests": 50}
    if case == "revert":
        return [0.0, 0.1, 0.2, 0.3], rows_at, lambda i: {"burn_rate": 5.0 if i >= 2 else 0.0,
                                                          "window_requests": 50}
    assert case == "few-samples"
    return [0.0, 0.1, 0.2, 0.3], rows_at, lambda i: {"burn_rate": 5.0, "window_requests": 1}


@pytest.mark.parametrize("case", ["commit", "revert", "few-samples", "drift"])
def test_tuner_decisions_match_the_reference(case):
    """The same synthetic signal source drives both packages' tuners: the
    same sequence of retunes, commits and reverts, the same ladders and
    the same refined plan knobs."""
    from keystone_tpu.planner import tuner as jtuner
    from keystone_tpu_torch.planner import tuner

    runs = {}
    for name, mod, plan_cls, sig_cls in (("port", tuner, PhysicalPlan, Signals),
                                         ("ref", jtuner, JPhysicalPlan, JSignals)):
        times, rows_at, burn_at = _scripted(case)
        svc = _StubService()
        plan = plan_cls(backend="cpu", knobs={"buckets": [8, 32]})
        now, i_tick, state = [0.0], [0], {"count": 0.0, "sum": 0.0}
        t = _tuner(mod, svc, plan, lambda: now[0], lambda: rows_at(i_tick[0], state), lambda: burn_at(i_tick[0]),
                   sig_cls)
        trace = []
        for i, when in enumerate(times):
            i_tick[0], now[0] = i, when
            trace.append((t.tick(), tuple(svc.buckets)))
        runs[name] = (trace, dict(plan.knobs), t.retunes, t.commits, t.reverts,
                      None if t.last_action is None else t.last_action["outcome"])
    assert runs["port"] == runs["ref"]
    outcomes = [o for o, _ in runs["port"][0]]
    assert "retune" in outcomes
    if case in ("revert", "drift"):
        assert "revert" in outcomes
    if case == "commit":
        assert runs["port"][1]["buckets"] == [4, 8, 32]


def test_tuner_counts_retunes_and_reports_status():
    from keystone_tpu_torch.planner import tuner

    svc = _StubService()
    plan = PhysicalPlan(backend="cpu", knobs={"buckets": [8, 32]})
    times, rows_at, burn_at = _scripted("commit")
    now, i_tick, state = [0.0], [0], {"count": 0.0, "sum": 0.0}
    t = _tuner(tuner, svc, plan, lambda: now[0], lambda: rows_at(i_tick[0], state), lambda: burn_at(i_tick[0]),
               Signals)
    c0 = metrics.REGISTRY.counter_total("plan.retunes")
    for i, when in enumerate(times[:4]):  # up to the commit
        i_tick[0], now[0] = i, when
        t.tick()
    assert metrics.REGISTRY.counter_total("plan.retunes") == c0 + 2  # retune, kept
    st = t.status()
    assert st["retunes"] == 1 and st["commits"] == 1 and st["baking"] is None
    assert st["plan"] == plan.fingerprint() and st["last_action"]["outcome"] == "kept"


# --------------------------------------------------------- analysis pass
def test_analysis_plan_pass_inert_clean_and_stale():
    from keystone_tpu_torch.analysis import plan as plan_pass

    fitted, _ = _linear()
    assert plan_pass.run(fitted.graph, pipeline=fitted) == []
    fresh = planner.build_plan(fitted, example=_example("linear"), runner=_flat_runner({}), device="cpu")
    assert plan_pass.run(fitted.graph, pipeline=fitted, plan=fresh) == []
    other, _ = _linear(seed=9, classes=CLASSES + 1)
    findings = plan_pass.run(other.graph, pipeline=other, plan=fresh)
    assert findings and {f.code for f in findings} == {"stale-plan"}
    assert all(f.severity == "warning" for f in findings)
    bad = PhysicalPlan(backend="cpu", stages=[StageChoice(gate="fused_fv", signature=stage_signature(NormalizeRows()),
                                                          label="NormalizeRows", winner="kernel", why="")])
    assert "bad-plan-candidate" in {f.code for f in plan_pass.run(fitted.graph, pipeline=fitted, plan=bad)}


def test_validate_freeze_runs_the_plan_pass():
    from keystone_tpu_torch.analysis import validate_freeze

    fitted, _ = _linear()
    planner.install_plan(PhysicalPlan(backend="cpu", stages=[
        StageChoice(gate="matmul", signature="Gone:000000000000", label="Gone", winner="f32", why="")]))
    report = validate_freeze(fitted, example=np.zeros((DIM,), np.float32))
    assert any(f.code == "stale-plan" for f in report.findings)
    y = fitted.freeze(device="cpu", validate=True, example=(DIM,))(Dataset(torch.from_numpy(_example("linear", 4))))
    assert tuple(y.array.shape) == (4, CLASSES)


# ----------------------------------------------------------------- CLI
def test_cli_plan_renders_and_explains(tmp_path, capsys):
    from keystone_tpu_torch import cli

    fitted, _ = _linear()
    plan = planner.build_plan(fitted, example=_example("linear"), seed=1,
                              runner=_flat_runner({("matmul", "auto"): (1e-3, 1e-6)}), device="cpu")
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan.to_dict(), sort_keys=True))
    assert cli.main(["plan", "--file", str(path)]) == 0
    out = capsys.readouterr().out
    assert plan.fingerprint() in out and "matmul" in out
    assert cli.main(["plan", "--file", str(path), "--explain"]) == 0
    out = capsys.readouterr().out
    assert "winner=" in out and "serving knobs" in out
    assert cli.main(["plan", "--file", str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == plan.to_dict()


def test_cli_plan_builds_from_a_saved_model(tmp_path, capsys):
    from keystone_tpu_torch import cli

    fitted, _ = _linear()
    model, out = str(tmp_path / "m.pt"), str(tmp_path / "plan.json")
    fitted.save(model)
    assert cli.main(["plan", "--model", model, "--example-shape", str(DIM), "--device", "cpu", "--out", out]) == 0
    plan = PhysicalPlan.from_dict(json.loads(open(out).read()))
    assert plan.backend == "cpu" and plan.choice_for("matmul") == "auto" and "max_wait_ms" in plan.knobs
