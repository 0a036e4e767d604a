"""The port's planning layer against the JAX package's, on the CPU: the
stage profiler, the cache placement under a byte budget and its
``no_memoize`` demotions, the footprint the fit's pre-flight reads, the
static stage cost against XLA's, and the default optimizer's profiled
materialization pass (tests/test_aux.py:60-156, :382-411, :438-480).

The toy transformers come in pairs with equal class names and params, so
both frameworks' graphs and signatures agree.  Sizes are multiples of the
reference's 4-wide data mesh: it pads a Dataset's rows to the mesh, and
its sampled bytes would count the padding the port does not have.
"""

import glob
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keystone_tpu.ops.fisher_pallas as jfp
import keystone_tpu.workflow.profiling as jprof
from keystone_tpu.models.gmm import GaussianMixtureModel as JGmm
from keystone_tpu.models.pca import PCATransformer as JPca
from keystone_tpu.obs import ledger as jledger
from keystone_tpu.ops.fisher import FisherVector as JFisherVector
from keystone_tpu.workflow import Dataset as JDataset
from keystone_tpu.workflow import GraphExecutor as JExecutor
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu.workflow import Transformer as JTransformer
from keystone_tpu.workflow import graph as JG
from keystone_tpu.workflow import optimizer as JO
from keystone_tpu.workflow.transformer import Cacher as JCacher
from keystone_tpu.workflow.transformer import transformer as jtransformer
from keystone_tpu_torch.models.gmm import GaussianMixtureModel
from keystone_tpu_torch.models.pca import PCATransformer
from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.ops.fisher import FisherVector, FusedPcaFisherVector
from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow import optimizer as O
from keystone_tpu_torch.workflow import profiling
from keystone_tpu_torch.workflow import transformer as T
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.executor import GraphExecutor
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline, PipelineEnv


# ---------------------------------------------------------------- toy nodes, one set for each framework
class Expensive(T.Transformer):
    calls = 0

    def __init__(self, tag):
        super().__init__()
        self.tag = tag

    def params(self):
        return (self.tag,)

    def apply_batch(self, xs, mask=None):
        Expensive.calls += 1
        return xs * 2.0


class AddC(T.Transformer):
    def __init__(self, c):
        super().__init__()
        self.c = float(c)

    def params(self):
        return (self.c,)

    def apply_batch(self, xs, mask=None):
        return xs + self.c


class JExpensive(JTransformer):
    """Counts executions of its compiled program (jax.debug.callback), as
    the reference's own test node does."""

    calls = 0

    def __init__(self, tag):
        self.tag = tag

    def params(self):
        return (self.tag,)

    @staticmethod
    def _bump():
        JExpensive.calls += 1

    def apply_batch(self, xs, mask=None):
        jax.debug.callback(JExpensive._bump)
        return xs * 2.0


class JAddC(JTransformer):
    def __init__(self, c):
        self.c = float(c)

    def params(self):
        return (self.c,)

    def apply_batch(self, xs, mask=None):
        return xs + self.c


class Project(T.Transformer):
    """Much work for few bytes: 64 columns through 512 down to 8."""

    def params(self):
        return ()

    def apply_batch(self, xs, mask=None):
        return (xs @ torch.full((64, 512), 0.01)) @ torch.full((512, 8), 0.01)


class JProject(JTransformer):
    def params(self):
        return ()

    def apply_batch(self, xs, mask=None):
        return (xs @ jnp.full((64, 512), 0.01)) @ jnp.full((512, 8), 0.01)


JExpensive.__name__ = "Expensive"
JAddC.__name__ = "AddC"
JProject.__name__ = "Project"

X = np.ones((64, 8), np.float32)


def _shared_lazy():
    """Two branches with an identical Expensive prefix, bound to X, in both frameworks."""
    p = Pipeline.gather([Expensive("x") | AddC(1.0), Expensive("x") | AddC(2.0)])
    jp = JPipeline.gather([JExpensive("x") | JAddC(1.0), JExpensive("x") | JAddC(2.0)])
    return p(Dataset(X, device="cpu")), jp(JDataset(X))


def _merged():
    lazy, jlazy = _shared_lazy()
    return O.EquivalentNodeMergeRule().apply(lazy.graph), JO.EquivalentNodeMergeRule().apply(jlazy.graph)


def _jcalls() -> int:
    jax.effects_barrier()
    return JExpensive.calls


def _cacher_parents(g, Gm, cacher):
    return sorted(g.operators[g.dependencies[n][0]].label() for n, op in g.operators.items()
                  if isinstance(op, Gm.TransformerOperator) and isinstance(op.transformer, cacher))


def _flagged(g):
    return sorted(op.label() for op in g.operators.values() if getattr(op, "no_memoize", False))


# ---------------------------------------------------------------- the profiler
def test_profiled_nodes_match_reference():
    lazy, jlazy = _shared_lazy()
    got = profiling.profile_graph(lazy.graph, sample_size=16)
    want = jprof.profile_graph(jlazy.graph, sample_size=16)
    summary = {n.id: (lazy.graph.operators[n].label(), p.output_bytes, p.scale) for n, p in got.items()}
    jsummary = {n.id: (jlazy.graph.operators[n].label(), p.output_bytes, p.scale) for n, p in want.items()}
    assert summary == jsummary
    assert len(got) >= 2 and all(p.output_bytes > 0 and p.scale == 4.0 for p in got.values())
    assert all(p.full_bytes == 64 * 8 * 4 for n, p in got.items() if lazy.graph.operators[n].label() != "Gather")


def test_targets_restrict_the_profiled_nodes():
    lazy, jlazy = _shared_lazy()
    everything = profiling.profile_graph(lazy.graph, sample_size=16)
    target = next(iter(everything))
    only = profiling.profile_graph(lazy.graph, sample_size=16, targets=frozenset([target]))
    jonly = jprof.profile_graph(jlazy.graph, sample_size=16, targets=frozenset([JG.NodeId(target.id)]))
    assert set(only) == {target} and {n.id for n in jonly} == {target.id}
    assert only[target].output_bytes == everything[target].output_bytes == jonly[JG.NodeId(target.id)].output_bytes


@pytest.mark.parametrize("budget", [1 << 30, 1], ids=["within_budget", "over_budget"])
def test_cache_placement_matches_reference(budget):
    """Within the budget the shared Expensive output gets one Cacher;
    over it (1 byte) the node is flagged no_memoize instead, in both."""
    g, jg = _merged()
    g2 = profiling.ProfilingAutoCacheRule(budget_bytes=budget, sample_size=16).apply(g)
    jg2 = jprof.ProfilingAutoCacheRule(budget_bytes=budget, sample_size=16).apply(jg)
    assert _cacher_parents(g2, G, T.Cacher) == _cacher_parents(jg2, JG, JCacher)
    assert _flagged(g2) == _flagged(jg2)
    if budget == 1:
        assert _flagged(g2) == ["Expensive"] and _cacher_parents(g2, G, T.Cacher) == []
    else:
        assert _flagged(g2) == [] and _cacher_parents(g2, G, T.Cacher) == ["Expensive"]
    assert profiling.last_footprint == jprof.last_footprint
    assert profiling.last_footprint == {"shared_bytes": 64 * 8 * 4, "budget_bytes": budget}


def test_partial_placement_matches_reference():
    """A budget that holds either of two shared outputs but not both: the
    ranking by statically priced seconds per byte decides.  Both packages
    price both nodes at full batch, pin the projection (much work for few
    bytes) and demote the doubling (little work for many)."""
    x = np.ones((2048, 64), np.float32)
    p = Pipeline.gather([Project() | AddC(1.0), Project() | AddC(2.0),
                         Expensive("c") | AddC(3.0), Expensive("c") | AddC(4.0)])
    jp = JPipeline.gather([JProject() | JAddC(1.0), JProject() | JAddC(2.0),
                           JExpensive("c") | JAddC(3.0), JExpensive("c") | JAddC(4.0)])
    g = O.EquivalentNodeMergeRule().apply(p(Dataset(x, device="cpu")).graph)
    jg = JO.EquivalentNodeMergeRule().apply(jp(JDataset(x)).graph)
    priced = profiling.profile_graph(g, sample_size=16, static_cost=True)
    jpriced = jprof.profile_graph(jg, sample_size=16, static_cost=True)
    for label in ("Project", "Expensive"):
        (n,) = [n for n in priced if g.operators[n].label() == label]
        assert priced[n].static_seconds is not None and jpriced[JG.NodeId(n.id)].hlo_seconds is not None
    budget = 2048 * 64 * 4  # the doubling's output; the projection's is 2048 * 8 * 4
    g2 = profiling.ProfilingAutoCacheRule(budget_bytes=budget, sample_size=16, static_cost=True).apply(g)
    jg2 = jprof.ProfilingAutoCacheRule(budget_bytes=budget, sample_size=16, static_cost=True).apply(jg)
    assert _cacher_parents(g2, G, T.Cacher) == _cacher_parents(jg2, JG, JCacher) == ["Project"]
    assert _flagged(g2) == _flagged(jg2) == ["Expensive"]
    assert profiling.last_footprint == jprof.last_footprint == {"shared_bytes": 2048 * 8 * 4 + budget,
                                                                "budget_bytes": budget}


def test_profile_all_knob_profiles_every_node_as_the_reference(monkeypatch):
    """``KEYSTONE_CACHE_PROFILE_ALL=1`` profiles every transformer and
    gather node, not only the shared ones, in both packages; the
    placement is the same either way."""
    seen = {}
    for name, module in (("port", profiling), ("reference", jprof)):
        def spy(graph, *a, _orig=module.profile_graph, _name=name, **k):
            out = _orig(graph, *a, **k)
            seen[_name] = sorted(graph.operators[n].label() for n in out)
            return out

        monkeypatch.setattr(module, "profile_graph", spy)
    profiled = {}
    for env in ("", "1"):
        monkeypatch.setenv("KEYSTONE_CACHE_PROFILE_ALL", env)
        g, jg = _merged()
        g2 = profiling.ProfilingAutoCacheRule(budget_bytes=1 << 30, sample_size=16).apply(g)
        jg2 = jprof.ProfilingAutoCacheRule(budget_bytes=1 << 30, sample_size=16).apply(jg)
        assert seen["port"] == seen["reference"]
        assert _cacher_parents(g2, G, T.Cacher) == _cacher_parents(jg2, JG, JCacher) == ["Expensive"]
        profiled[env] = seen["port"]
    assert profiled == {"": ["Expensive"], "1": ["AddC", "AddC", "Expensive", "Gather"]}


def test_no_memoize_node_runs_once_per_consumer():
    """A demoted shared node is recomputed for each of its two consumers
    (counted executions), in both executors; an unflagged one runs once."""
    g, jg = _merged()
    g2 = profiling.ProfilingAutoCacheRule(budget_bytes=1, sample_size=16).apply(g)
    jg2 = jprof.ProfilingAutoCacheRule(budget_bytes=1, sample_size=16).apply(jg)
    Expensive.calls = 0
    out = GraphExecutor(g2).execute(g2.sinks[0]).dataset.numpy()
    assert Expensive.calls == 2
    _jcalls()
    JExpensive.calls = 0
    jout = JExecutor(jg2).execute(jg2.sinks[0]).dataset.array
    assert _jcalls() == 2
    np.testing.assert_array_equal(out, np.asarray(jout)[:64])
    Expensive.calls = 0
    GraphExecutor(g).execute(g.sinks[0])
    assert Expensive.calls == 1


def test_no_sampling_pass_without_shared_nodes(monkeypatch):
    """A linear pipeline has nothing to place: the rule returns the graph
    untouched without the sampling pass, in both packages."""
    calls = []
    monkeypatch.setattr(profiling, "profile_graph", lambda *a, **k: calls.append("port"))
    monkeypatch.setattr(jprof, "profile_graph", lambda *a, **k: calls.append("reference"))
    lazy = (Expensive("lin") | AddC(1.0) | AddC(2.0))(Dataset(np.ones((32, 4), np.float32), device="cpu"))
    jlazy = (JExpensive("lin") | JAddC(1.0) | JAddC(2.0))(JDataset(np.ones((32, 4), np.float32)))
    g2 = profiling.ProfilingAutoCacheRule(budget_bytes=1 << 30, sample_size=16).apply(lazy.graph)
    jg2 = jprof.ProfilingAutoCacheRule(budget_bytes=1 << 30, sample_size=16).apply(jlazy.graph)
    assert calls == []
    assert g2.operators.keys() == lazy.graph.operators.keys()
    assert {n.id for n in jg2.operators} == {n.id for n in g2.operators}


# ---------------------------------------------------------------- static cost
def test_stage_cost_counts_matmul_as_hlo_stage_cost():
    """2·m·n·k flops, and each operand read once and the product written
    once, as XLA's cost analysis counts them."""
    got = profiling.stage_cost(lambda x, y: x @ y, profiling.TensorSpec((256, 128)), profiling.TensorSpec((128, 64)))
    want = jprof.hlo_stage_cost(lambda x, y: x @ y, jax.ShapeDtypeStruct((256, 128), jnp.float32),
                                jax.ShapeDtypeStruct((128, 64), jnp.float32))
    assert got["flops"] == want["flops"] == 2 * 256 * 128 * 64
    assert got["bytes"] == want["bytes"] == (256 * 128 + 128 * 64 + 256 * 64) * 4
    assert got["seconds_est"] > 0


def test_stage_cost_refuses_what_cannot_run_on_fake_tensors():
    """A data-dependent shape, and a kernel wrapper's launch on a fake
    tensor, leave the stage unpriced (None), as a failed cost analysis
    does in the reference."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from keystone_tpu_torch.ops import fisher_kernels, gram_kernels

    assert profiling.stage_cost(lambda x: x[x > 0], profiling.TensorSpec((8, 4))) is None
    with FakeTensorMode():
        fake = torch.empty(4, 3)
        with pytest.raises(TypeError, match="fake tensor"):
            gram_kernels._operands("gram_block", fake, fake)
        with pytest.raises(TypeError, match="fake tensor"):
            fisher_kernels._check("xs", fake, (4, 3), (torch.float32,), fake.device)


def test_static_cost_ranks_heavier_node_higher():
    big = T.transformer(lambda x: (x @ torch.ones(64, 512)) @ torch.ones(512, 8))
    small = T.transformer(lambda x: x[:8] * 2.0)
    lazy = Pipeline.gather([Pipeline.of(big), Pipeline.of(small)])(Dataset(np.ones((2048, 64), np.float32),
                                                                            device="cpu"))
    jbig = jtransformer(lambda x: (x @ jnp.ones((64, 512))) @ jnp.ones((512, 8)))
    jsmall = jtransformer(lambda x: x[:8] * 2.0)
    jlazy = JPipeline.gather([JPipeline.of(jbig), JPipeline.of(jsmall)])(JDataset(np.ones((2048, 64), np.float32)))
    got = profiling.profile_graph(lazy.graph, sample_size=16, static_cost=True)
    want = jprof.profile_graph(jlazy.graph, sample_size=16, static_cost=True)
    static = {n.id: p.static_seconds for n, p in got.items() if p.static_seconds is not None}
    jstatic = {n.id: p.hlo_seconds for n, p in want.items() if p.hlo_seconds is not None}
    assert len(static) >= 2 and set(static) == set(jstatic)
    assert max(static, key=static.get) == max(jstatic, key=jstatic.get)
    assert min(static, key=static.get) == min(jstatic, key=jstatic.get)


def test_comparable_seconds_calibrates_wall_only_nodes():
    """The median static/wall ratio puts wall-priced nodes in static units."""
    ps = {G.NodeId(1): profiling.NodeProfile(1.0, 4, 2.0, static_seconds=0.5),
          G.NodeId(2): profiling.NodeProfile(3.0, 4, 1.0)}
    jps = {JG.NodeId(1): jprof.NodeProfile(1.0, 4, 2.0, hlo_seconds=0.5), JG.NodeId(2): jprof.NodeProfile(3.0, 4, 1.0)}
    got = profiling._comparable_seconds(ps)
    assert {n.id: v for n, v in got.items()} == {n.id: v for n, v in jprof._comparable_seconds(jps).items()}
    assert got == {G.NodeId(1): 0.5, G.NodeId(2): 0.75}


# ---------------------------------------------------------------- the budget
@pytest.mark.parametrize("env", ["", "123456789", "junk"])
def test_device_hbm_budget_matches_reference(env, monkeypatch, caplog):
    monkeypatch.setenv("KEYSTONE_HBM_BUDGET_BYTES", env)
    for fraction in (0.5, 0.45, 0.2):
        assert profiling.device_hbm_budget(fraction) == jprof.device_hbm_budget(fraction)
    if env == "123456789":
        assert profiling.device_hbm_budget(0.5, "cpu") == 61728394
    if env == "junk":
        assert "is not an int" in caplog.text


# ---------------------------------------------------------------- the default optimizer
def _count_rule_applies(monkeypatch, module):
    ran = []
    orig = module.ProfilingAutoCacheRule.apply
    monkeypatch.setattr(module.ProfilingAutoCacheRule, "apply",
                        lambda self, graph, *a, **k: ran.append(1) or orig(self, graph, *a, **k))
    return ran


def test_default_optimizer_runs_the_profiled_rule(monkeypatch):
    """The default materialization is the profiled rule (not its
    structural fallback), once a fit, with the reference's sample sizes."""
    opt = O.default_optimizer()
    rules = [r for b in opt.batches for r in b.rules]
    assert any(isinstance(r, O.ProfiledMaterializeRule) for r in rules)
    assert [r.sample_size for r in rules if isinstance(r, (O.NodeChoiceRule, O.ProfiledMaterializeRule))] == [256, 64]
    ran, jran = _count_rule_applies(monkeypatch, profiling), _count_rule_applies(monkeypatch, jprof)
    before = metrics.REGISTRY.counter_value("optimizer.materialize_fallbacks")
    p = Pipeline.gather([Pipeline.of(AddC(1.0)) | AddC(2.0), Pipeline.of(AddC(1.0)) | AddC(3.0)])
    g = opt.execute(p(Dataset(np.ones((16, 4), np.float32), device="cpu")).graph)
    assert ran == [1]
    assert metrics.REGISTRY.counter_value("optimizer.materialize_fallbacks") == before
    assert any(isinstance(getattr(op, "transformer", None), T.Cacher) for op in g.operators.values())
    ran.clear()
    try:
        PipelineEnv.set_optimizer(None)
        AddC(1.0).and_then(_MeanShift(), Dataset(np.ones((8, 4), np.float32), device="cpu")).fit()
        JAddC(1.0).and_then(_JMeanShift(), JDataset(np.ones((8, 4), np.float32))).fit()
    finally:
        PipelineEnv.set_optimizer(None)
    assert ran == [1] and jran == [1]


def test_fit_predicts_from_its_own_materialize_pass():
    """A fit whose optimizer runs no profiled pass predicts its sources
    alone: the shared bytes a lazy apply's pass left behind are not its
    own."""
    lazy, _ = _shared_lazy()
    lazy.get()
    assert profiling.last_footprint["shared_bytes"] == 64 * 8 * 4
    structural = O.Optimizer([b if b.name != "materialize" else O.RuleBatch("materialize", O.Once(),
                                                                            [O.AutoMaterializeRule()])
                              for b in O.default_optimizer().batches])
    try:
        PipelineEnv.set_optimizer(structural)
        AddC(1.0).and_then(_MeanShift(), Dataset(X, device="cpu")).fit()
    finally:
        PipelineEnv.set_optimizer(None)
    assert metrics.REGISTRY.gauge_value("pipeline.preflight_predicted_bytes") == X.nbytes


class _Shift(T.Transformer):
    def __init__(self, mean):
        super().__init__()
        self.register_buffer("mean", mean)

    def apply_batch(self, xs, mask=None):
        return xs - self.mean


class _MeanShift(O.Estimator):
    def params(self):
        return ()

    def fit_dataset(self, data):
        return _Shift(data.array.mean(dim=0))


class _JShift(JTransformer):
    def __init__(self, mean):
        self.mean = mean

    def apply_batch(self, xs, mask=None):
        return xs - self.mean


class _JMeanShift(JO.Estimator):
    def params(self):
        return ()

    def fit_dataset(self, data):
        return _JShift(jnp.mean(data.array[: data.n], axis=0))


def test_profiled_rule_failure_falls_back_loudly(monkeypatch, caplog):
    """An exception inside the profiled pass takes the structural rule, as
    the reference's does, with a warning and a counter."""
    def boom(self, graph, device=None):
        raise RuntimeError("no profile")

    monkeypatch.setattr(profiling.ProfilingAutoCacheRule, "apply", boom)
    lazy, _ = _shared_lazy()
    g = O.EquivalentNodeMergeRule().apply(lazy.graph)
    before = metrics.REGISTRY.counter_value("optimizer.materialize_fallbacks")
    with caplog.at_level(logging.WARNING, "keystone_tpu_torch.workflow.optimizer"):
        got = O.ProfiledMaterializeRule().apply(g)
    assert "profiled materialization failed (no profile)" in caplog.text
    assert metrics.REGISTRY.counter_value("optimizer.materialize_fallbacks") == before + 1
    assert _shape(got) == _shape(O.AutoMaterializeRule().apply(g))


def _shape(g):
    return ({n.id: tuple(d.id for d in ds) for n, ds in g.dependencies.items()},
            sorted(op.label() for op in g.operators.values()))


def _placement_events(directory):
    (path,) = glob.glob(f"{directory}/run_*.jsonl")
    with open(path) as f:
        events = [json.loads(line) for line in f]
    return [e["attrs"] for e in events if e["kind"] == "event" and e["name"] == "optimizer.cache_placement"]


def test_cache_placement_event_matches_reference(tmp_path):
    g, jg = _merged()
    ledger.start_run(str(tmp_path / "port"))
    try:
        profiling.ProfilingAutoCacheRule(budget_bytes=1, sample_size=16).apply(g)
    finally:
        ledger.stop_run()
    jledger.start_run(str(tmp_path / "reference"))
    try:
        jprof.ProfilingAutoCacheRule(budget_bytes=1, sample_size=16).apply(jg)
    finally:
        jledger.stop_run()
    got, want = _placement_events(tmp_path / "port"), _placement_events(tmp_path / "reference")
    assert got == want == [{"shared_nodes": 1, "pinned_bytes": 0, "no_memoize_demotions": 1,
                            "shared_bytes": 64 * 8 * 4, "budget_bytes": 1}]
    assert metrics.REGISTRY.gauge_value("optimizer.pinned_bytes") == 0.0


# ---------------------------------------------------------------- no_memoize through the fusion rules
def test_stage_fusion_carries_no_memoize():
    """A flagged node fused with its single-consumer parent keeps the flag
    on the fused node, as the reference's StageFusionRule does."""
    def chain(Gm, add):
        g = Gm.Graph()
        g, src = g.add_source()
        g, a = g.add_node(Gm.TransformerOperator(add(1.0)), (src,))
        g, b = g.add_node(Gm.TransformerOperator(add(2.0)), (a,))
        flagged = Gm.TransformerOperator(g.operators[b].transformer)
        flagged.no_memoize = True
        g = g.set_operator(b, flagged)
        g, _ = g.add_sink(b)
        return g

    got, want = O.StageFusionRule().apply(chain(G, AddC)), JO.StageFusionRule().apply(chain(JG, JAddC))
    assert [(op.label(), getattr(op, "no_memoize", False)) for op in got.operators.values()] == [
        (op.label(), getattr(op, "no_memoize", False)) for op in want.operators.values()] == [
        ("Fused[AddC > AddC]", True)]


def test_fv_fusion_carries_no_memoize(monkeypatch):
    """The fused FV node replaces a flagged FisherVector node: it keeps the
    flag, as the reference's PallasFvFusionRule does (the device checks
    patched to fire on the CPU)."""
    rng = np.random.default_rng(3)
    comp = np.linalg.qr(rng.normal(size=(24, 8)))[0].astype(np.float32)
    w, mu = np.full(4, 0.25, np.float32), rng.normal(size=(4, 8)).astype(np.float32)
    var = (0.5 + rng.random((4, 8))).astype(np.float32)

    def graph(Gm, pca, fv):
        g = Gm.Graph()
        g, src = g.add_source()
        g, a = g.add_node(Gm.TransformerOperator(pca), (src,))
        flagged = Gm.TransformerOperator(fv)
        flagged.no_memoize = True
        g, b = g.add_node(flagged, (a,))
        g, _ = g.add_sink(b)
        return g

    t = torch.from_numpy
    g = graph(G, PCATransformer(t(comp)), FisherVector(GaussianMixtureModel(t(w), t(mu), t(var))))
    jg = graph(JG, JPca(jnp.asarray(comp)), JFisherVector(JGmm(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var))))
    monkeypatch.setattr(O, "device_is_cuda", lambda device: True)
    monkeypatch.setattr(jfp, "pallas_supported", lambda x=None: True)
    got, want = O.FvFusionRule().apply(g, device="cuda"), JO.PallasFvFusionRule().apply(jg)
    (op,), (jop,) = got.operators.values(), want.operators.values()
    assert isinstance(op.transformer, FusedPcaFisherVector) and op.label() == jop.label()
    assert op.no_memoize is True and jop.no_memoize is True


# ---------------------------------------------------------------- freeze
def test_freeze_gives_the_rows_of_the_structural_pass():
    """A frozen applier's graph, optimized before data is bound, now runs
    the profiled pass: it finds nothing to run and pins every shared node
    (gathers too, which the structural rule did not).  Its rows are the
    structural pass's, bit for bit."""
    fitted = (Pipeline.of(AddC(1.0)).then_pipeline(Pipeline.gather([AddC(2.0), Expensive("f")]))
              .and_then(_MeanShift(), Dataset(X, device="cpu")).fit())
    assert isinstance(fitted, FittedPipeline)
    structural = O.Optimizer([b if b.name != "materialize" else O.RuleBatch("materialize", O.Once(),
                                                                            [O.AutoMaterializeRule()])
                              for b in O.default_optimizer().batches])
    x = np.random.default_rng(5).normal(size=(12, 8)).astype(np.float32)
    before = metrics.REGISTRY.counter_value("optimizer.materialize_fallbacks")
    try:
        PipelineEnv.set_optimizer(structural)
        want = fitted.freeze(device="cpu")(x).numpy()
    finally:
        PipelineEnv.set_optimizer(None)
    frozen = fitted.freeze(device="cpu")
    assert metrics.REGISTRY.counter_value("optimizer.materialize_fallbacks") == before
    np.testing.assert_array_equal(frozen(x).numpy(), want)
    np.testing.assert_array_equal(frozen(x).numpy(), fitted(Dataset(x, device="cpu")).get().numpy())
