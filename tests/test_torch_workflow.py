"""The port's workflow core against the JAX package's, on the CPU.

Graph construction, CSE merging identical branches, the executor's
memoization, the materialization and stage-fusion rules on the graphs of
tests/test_workflow.py, the FV fusion rule's rewrite (the device check
patched, as tests/test_pallas.py patches ``pallas_supported``) and its
output against the unfused graph, and fit/save/load/fit_or_load round
trips.  Toy transformers come in pairs, one for each framework, with equal class
names and params, so both frameworks' signatures agree.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keystone_tpu.ops.fisher_pallas as jfp
from keystone_tpu.loaders.imagenet import ImageNetLoader as JLoader
from keystone_tpu.models.gmm import GaussianMixtureModel as JGmm
from keystone_tpu.models.pca import PCATransformer as JPca
from keystone_tpu.ops.fisher import FusedPcaFisherVector as JFused
from keystone_tpu.pipelines.imagenet_sift_lcs_fv import ImageNetSiftLcsFV as JApp
from keystone_tpu.workflow import Dataset as JDataset
from keystone_tpu.workflow import Estimator as JEstimator
from keystone_tpu.workflow import GraphExecutor as JExecutor
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu.workflow import Transformer as JTransformer
from keystone_tpu.workflow import graph as JG
from keystone_tpu.workflow import optimizer as JO
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.models.gmm import GaussianMixtureModel
from keystone_tpu_torch.models.pca import PCATransformer
from keystone_tpu_torch.ops.fisher import FisherVector, FusedPcaFisherVector
from keystone_tpu_torch.ops.sift import SIFTExtractor
from keystone_tpu_torch.ops.stats import ColumnSampler
from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV
from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow import optimizer as O
from keystone_tpu_torch.workflow import transformer as T
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.estimator import Estimator
from keystone_tpu_torch.workflow.executor import GraphExecutor
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline, PipelineEnv

# the fused FV node against the reference's on the same arrays: the
# reference's own fused tolerance (tests/test_pallas.py) plus the f32
# relative term for entries of tens summed in another order
ATOL_FUSED, RTOL_FUSED = 3e-5, 1e-5


# ---------------------------------------------------------------- toy nodes, one set for each framework
class CountingDouble(T.Transformer):
    calls = 0

    def params(self):
        return ("double",)

    def apply_batch(self, xs, mask=None):
        CountingDouble.calls += 1
        return xs * 2.0


class AddConst(T.Transformer):
    def __init__(self, c):
        super().__init__()
        self.c = float(c)

    def params(self):
        return (self.c,)

    def apply_batch(self, xs, mask=None):
        return xs + self.c


class Shift(T.Transformer):
    def __init__(self, mean):
        super().__init__()
        self.register_buffer("mean", mean)

    def apply_batch(self, xs, mask=None):
        return xs - self.mean


class MeanShift(Estimator):
    """Fits the column mean; the fitted transformer subtracts it."""

    def params(self):
        return ()

    def fit_dataset(self, data):
        return Shift(data.array.mean(dim=0))


class JCountingDouble(JTransformer):
    calls = 0

    def params(self):
        return ("double",)

    def apply_batch(self, xs, mask=None):
        JCountingDouble.calls += 1
        return xs * 2.0


class JAddConst(JTransformer):
    def __init__(self, c):
        self.c = float(c)

    def params(self):
        return (self.c,)

    def apply_batch(self, xs, mask=None):
        return xs + self.c


class JShift(JTransformer):
    def __init__(self, mean):
        self.mean = mean

    def apply_batch(self, xs, mask=None):
        return xs - self.mean


class JMeanShift(JEstimator):
    def params(self):
        return ()

    def fit_dataset(self, data):
        return JShift(jnp.mean(data.array[: data.n], axis=0))


# JCountingDouble/JAddConst share the port classes' names for the signatures
JCountingDouble.__name__ = "CountingDouble"
JAddConst.__name__ = "AddConst"

X = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)


# ---------------------------------------------------------------- graph
def _graph(Gm, add, double):
    """src → double → {add 1, add 2} → gather → sink, spliced onto a
    second graph's source → add 3."""
    g = Gm.Graph()
    g, src = g.add_source()
    g, a = g.add_node(Gm.TransformerOperator(double()), (src,))
    g, b = g.add_node(Gm.TransformerOperator(add(1.0)), (a,))
    g, c = g.add_node(Gm.TransformerOperator(add(2.0)), (a,))
    g, d = g.add_node(Gm.GatherOperator(), (b, c))
    g, sink = g.add_sink(d)
    h = Gm.Graph()
    h, s2 = h.add_source()
    h, e = h.add_node(Gm.TransformerOperator(add(3.0)), (s2,))
    h, _ = h.add_sink(e)
    u, mapping = g.union(h)
    u = u.connect(sink, mapping[s2])
    return u, (a, b, c)


def _shape(g):
    return (
        [n.id for n in g.topological_nodes()],
        {n.id: tuple(d.id for d in ds) for n, ds in g.dependencies.items()},
        {k.id: d.id for k, d in g.sink_dependencies.items()},
        [s.id for s in g.sources],
        [g.operators[n].label() for n in g.topological_nodes()],
    )


def test_graph_construction_matches_reference():
    got, (a, b, c) = _graph(G, AddConst, CountingDouble)
    want, _ = _graph(JG, JAddConst, JCountingDouble)
    assert _shape(got) == _shape(want)
    for n in got.topological_nodes():
        assert got.prefix_signature(n) == want.prefix_signature(JG.NodeId(n.id))
    assert got.dependents(a) == (b, c)
    assert set(got.ancestors(got.sink_dependencies[got.sinks[0]])) >= {a, b, c}
    edited = got.replace_dependency(b, c).remove_node(b)
    jb, jc = JG.NodeId(b.id), JG.NodeId(c.id)
    assert _shape(edited) == _shape(want.replace_dependency(jb, jc).remove_node(jb))


# ---------------------------------------------------------------- CSE and memoization
def test_cse_merges_identical_branches():
    """Two gather branches share an identical CountingDouble prefix; after
    CSE it executes once (tests/test_workflow.py:159)."""
    CountingDouble.calls = 0
    p = Pipeline.gather([CountingDouble() | AddConst(1.0), CountingDouble() | AddConst(2.0)])
    g = O.EquivalentNodeMergeRule().apply(p(Dataset(np.ones((4, 2), np.float32), device="cpu")).graph)
    out = GraphExecutor(g).execute(g.sinks[0]).dataset.numpy()
    assert CountingDouble.calls == 1
    jp = JPipeline.gather([JCountingDouble() | JAddConst(1.0), JCountingDouble() | JAddConst(2.0)])
    jg = JO.EquivalentNodeMergeRule().apply(jp(JDataset(np.ones((4, 2), np.float32))).graph)
    assert _shape(g) == _shape(jg)
    want = np.asarray(JExecutor(jg).execute(jg.sinks[0]).dataset.array)[:4]
    np.testing.assert_array_equal(out, want)
    # the default optimizer's path gives the same
    np.testing.assert_array_equal(p(Dataset(np.ones((4, 2), np.float32), device="cpu")).get().numpy(), want)


def test_executor_memoizes_each_node_once():
    """One executor walks a shared prefix once, however many nodes (and
    later executions) read it."""
    CountingDouble.calls = 0
    shared = Pipeline.of(CountingDouble())
    p = shared.then_pipeline(Pipeline.gather([AddConst(1.0), AddConst(2.0), AddConst(3.0)]))
    g = p(Dataset(X, device="cpu")).graph
    ex = GraphExecutor(g, profile=True)
    first = ex.execute(g.sinks[0]).dataset.numpy()
    again = ex.execute(g.sinks[0]).dataset.numpy()
    assert CountingDouble.calls == 1
    assert set(ex.timings) == set(g.operators)
    np.testing.assert_array_equal(first, again)
    want = np.concatenate([X * 2 + c for c in (1.0, 2.0, 3.0)], axis=1)
    np.testing.assert_allclose(first, want, rtol=1e-6)


# ---------------------------------------------------------------- materialization and fusion
def _chain(Gm, add):
    """src → add 1 → add 2 → add 3 → sink (tests/test_workflow.py:188)."""
    g = Gm.Graph()
    g, src = g.add_source()
    g, n = g.add_node(Gm.TransformerOperator(add(1.0)), (src,))
    for c in (2.0, 3.0):
        g, n = g.add_node(Gm.TransformerOperator(add(c)), (n,))
    g, _ = g.add_sink(n)
    return g


def _shared(Gm, add):
    """src → add 1 → {add 2, add 3} → gather → sink: a shared output."""
    g = Gm.Graph()
    g, src = g.add_source()
    g, a = g.add_node(Gm.TransformerOperator(add(1.0)), (src,))
    g, b = g.add_node(Gm.TransformerOperator(add(2.0)), (a,))
    g, c = g.add_node(Gm.TransformerOperator(add(3.0)), (a,))
    g, d = g.add_node(Gm.GatherOperator(), (b, c))
    g, _ = g.add_sink(d)
    return g


@pytest.mark.parametrize("case", ["fuse_chain", "fuse_stops_at_a_shared_output", "materialize_shared"])
def test_materialize_and_fusion_rules_match_reference(case):
    if case == "materialize_shared":
        got, want = O.AutoMaterializeRule().apply(_shared(G, AddConst)), JO.AutoMaterializeRule().apply(
            _shared(JG, JAddConst))
    elif case == "fuse_stops_at_a_shared_output":
        # add 1 feeds two nodes and each feeds the gather: nothing fuses
        got, want = O.StageFusionRule().apply(_shared(G, AddConst)), JO.StageFusionRule().apply(
            _shared(JG, JAddConst))
        assert not any(isinstance(getattr(op, "transformer", None), O.FusedTransformer)
                       for op in got.operators.values())
    else:
        got = O.StageFusionRule().apply(_chain(G, AddConst))
        want = JO.StageFusionRule().apply(_chain(JG, JAddConst))
        (op,) = got.operators.values()
        assert isinstance(op.transformer, O.FusedTransformer)
        assert len(op.transformer.stages) == 3
    assert _shape(got) == _shape(want)
    bound = G.DatasetOperator(Dataset(X, device="cpu"))
    out = GraphExecutor(got.replace_source_with_node(got.sources[0], bound)[0])
    jout = JExecutor(want.replace_source_with_node(want.sources[0], JG.DatasetOperator(JDataset(X)))[0])
    np.testing.assert_allclose(out.execute(got.sinks[0]).dataset.numpy(),
                               np.asarray(jout.execute(want.sinks[0]).dataset.array)[: len(X)], rtol=1e-6)


class WidthChoice(T.Transformer):
    """Chooses, from the sample it is shown, a constant that depends on
    the sampled rows' count and width."""

    seen = []

    def params(self):
        return ("width-choice",)

    def choose_physical(self, sample):
        WidthChoice.seen.append(None if sample is None else (sample.n, tuple(sample.array.shape[1:])))
        return AddConst(float(sample.array.shape[1]))

    def apply_batch(self, xs, mask=None):
        raise AssertionError("the logical node must be replaced before it runs")


def test_node_choice_rule_swaps_the_node_from_a_sample(monkeypatch):
    """NodeChoiceRule runs the node's input on the first ``sample_size``
    rows and puts in what ``choose_physical`` returns; nodes that do not
    override it stay as they are."""
    monkeypatch.setattr(O.NodeChoiceRule, "sample_size", 4)
    WidthChoice.seen = []
    x = np.random.default_rng(1).normal(size=(10, 3)).astype(np.float32)
    p = AddConst(1.0) | WidthChoice()
    g = O.NodeChoiceRule().apply(p(Dataset(x, device="cpu")).graph)
    assert WidthChoice.seen == [(4, (3,))]
    assert sorted(op.transformer.c for op in g.operators.values() if isinstance(op, G.TransformerOperator)) == [
        1.0, 3.0]
    np.testing.assert_allclose(GraphExecutor(g).execute(g.sinks[0]).dataset.numpy(), x + 4.0, rtol=1e-6)


def test_fused_transformer_threads_the_mask():
    fused = O.FusedTransformer([SIFTExtractor(step=8), PCATransformer(torch.eye(128)[:, :4].contiguous())])
    imgs = torch.rand((2, 40, 40))
    z, mask = fused(imgs)
    desc, want_mask = SIFTExtractor(step=8)(imgs)
    torch.testing.assert_close(z, desc[..., :4])
    torch.testing.assert_close(mask, want_mask)


@pytest.mark.parametrize("rows", [1, 5, 11])
def test_row_chunks_change_no_row(monkeypatch, rows):
    """A dataset applied in chunks of any size gives the whole batch's
    rows (11: one chunk), the ragged mask and the samplers' draws too."""
    imgs = torch.rand((11, 40, 40))
    whole_desc, whole_mask = SIFTExtractor(step=8).apply_batch(imgs)
    whole_rows = ColumnSampler(3, seed=4).apply_arrays(whole_desc, whole_mask)
    monkeypatch.setattr(T, "APPLY_CHUNK_ROWS", rows)
    ds = SIFTExtractor(step=8)(Dataset(imgs, device="cpu"))
    torch.testing.assert_close(ds.array, whole_desc)
    torch.testing.assert_close(ds.mask, whole_mask)
    torch.testing.assert_close(ColumnSampler(3, seed=4)(ds).array, whole_rows)


# ---------------------------------------------------------------- the FV fusion rule
SMALL = dict(num_classes=4, synthetic_n=16, image_size=32, gmm_k=4, pca_dims=8, gmm_iters=2, num_epochs=1)


def _labels(g):
    return sorted(op.transformer.label for op in g.operators.values() if hasattr(op, "transformer"))


@pytest.fixture(scope="module")
def fitted_small():
    """The port's and the reference's graph fits of the small config
    (tests/test_pallas.py:261's), each with its held-out set."""
    train = ImageNetLoader.synthetic(16, 4, (32, 32), seed=1, device="cpu")
    test = ImageNetLoader.synthetic(8, 4, (32, 32), seed=2, device="cpu")
    fitted = ImageNetSiftLcsFV.build(Config(**SMALL), train.data, train.labels).fit()
    jtrain = JLoader.synthetic(16, 4, size=(32, 32), seed=1)
    jfitted = JApp.build(JApp.Config(**SMALL), jtrain.data, jtrain.labels).fit()
    jtest = JLoader.synthetic(8, 4, size=(32, 32), seed=2)
    return fitted, test, jfitted, jtest


def test_fv_fusion_rule_rewrites_as_the_reference(fitted_small, monkeypatch):
    fitted, test, jfitted, jtest = fitted_small
    bound = fitted(test.data).graph
    base = fitted(test.data).get().numpy()
    # inert where the data is on the CPU: the graph is untouched
    assert O.FvFusionRule().apply(bound) is bound
    monkeypatch.setattr(O, "device_is_cuda", lambda device: True)
    g2 = O.FvFusionRule().apply(bound)
    monkeypatch.setattr(jfp, "pallas_supported", lambda x=None: True)
    jg2 = JO.PallasFvFusionRule().apply(jfitted(jtest.data).graph)
    assert _labels(g2) == _labels(jg2)
    assert "FusedFV[SiftNorm > PCA > FV]" in _labels(g2) and "FusedFV[PCA > FV]" in _labels(g2)
    assert "PCATransformer" not in _labels(g2)
    sift = next(op.transformer for op in g2.operators.values()
                if isinstance(getattr(op, "transformer", None), SIFTExtractor))
    assert sift.normalize is False
    # the fitted graph's own SIFT keeps normalizing
    assert all(op.transformer.normalize for op in fitted.graph.operators.values()
               if isinstance(getattr(op, "transformer", None), SIFTExtractor))
    # the rewritten graph scores as the unfused one (on the CPU the fused
    # node runs the plain chain of the same stages): the same top-k ids
    np.testing.assert_array_equal(GraphExecutor(g2).execute(g2.sinks[0]).dataset.numpy(), base)
    # and the default optimizer takes the rule
    np.testing.assert_array_equal(fitted(test.data).get().numpy(), base)


def test_fv_fusion_rule_honours_use_kernel_false(fitted_small, monkeypatch):
    fitted, test, _, _ = fitted_small
    monkeypatch.setattr(O, "device_is_cuda", lambda device: True)
    g = fitted(test.data).graph
    for n, op in list(g.operators.items()):
        if isinstance(getattr(op, "transformer", None), FisherVector):
            g = g.set_operator(n, G.TransformerOperator(FisherVector(op.transformer.gmm, use_kernel=False)))
    assert O.FvFusionRule().apply(g) is g


@pytest.mark.parametrize("sift_normalize", [True, False])
def test_fused_fv_node_matches_reference(sift_normalize):
    """The node the rule builds against the reference's, on the same
    arrays (its XLA chain on the CPU)."""
    rng = np.random.default_rng(3)
    desc = rng.random((3, 50, 24)).astype(np.float32)
    mask = (rng.random((3, 50)) > 0.2).astype(np.float32)
    comp = np.linalg.qr(rng.normal(size=(24, 8)))[0].astype(np.float32)
    mean = (0.1 * rng.normal(size=24)).astype(np.float32)
    w = np.full(4, 0.25, np.float32)
    mu = rng.normal(size=(4, 8)).astype(np.float32)
    var = (0.5 + rng.random((4, 8))).astype(np.float32)
    t = torch.from_numpy
    got = FusedPcaFisherVector(PCATransformer(t(comp), t(mean)), GaussianMixtureModel(t(w), t(mu), t(var)),
                               sift_normalize=sift_normalize)(t(desc), t(mask))
    want = JFused(JPca(jnp.asarray(comp), jnp.asarray(mean)), JGmm(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var)),
                  sift_normalize=sift_normalize, use_pallas=False).apply_batch(jnp.asarray(desc), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_FUSED, rtol=RTOL_FUSED)


# ---------------------------------------------------------------- fit, save, load
def _shift_pipeline():
    return AddConst(1.0).and_then(MeanShift(), Dataset(X, device="cpu"))


def test_fit_save_load_round_trip(tmp_path):
    fitted = _shift_pipeline().fit()
    assert isinstance(fitted, FittedPipeline) and fitted.fit() is fitted
    # the fitted graph keeps no training data and no estimator
    assert not any(isinstance(op, (G.DatasetOperator, G.EstimatorOperator)) for op in fitted.graph.operators.values())
    out = fitted(Dataset(X + 1.0, device="cpu")).get().numpy()
    jfitted = JAddConst(1.0).and_then(JMeanShift(), JDataset(X)).fit()
    np.testing.assert_allclose(out, np.asarray(jfitted(JDataset(X + 1.0)).get().array)[: len(X)], atol=1e-6)
    path = tmp_path / "shift.pt"
    fitted.save(str(path))
    loaded = FittedPipeline.load(str(path), map_location="cpu")
    np.testing.assert_array_equal(loaded(Dataset(X + 1.0, device="cpu")).get().numpy(), out)


def test_fit_or_load_round_trip(tmp_path, caplog):
    path = str(tmp_path / "shift.pt")
    builds = []

    def build():
        builds.append(1)
        return _shift_pipeline()

    fitted, loaded = FittedPipeline.fit_or_load(path, build, config={"c": 1.0})
    assert not loaded and len(builds) == 1
    again, loaded = FittedPipeline.fit_or_load(path, build, config={"c": 1.0})
    assert loaded and len(builds) == 1
    np.testing.assert_array_equal(again(Dataset(X, device="cpu")).get().numpy(),
                                  fitted(Dataset(X, device="cpu")).get().numpy())
    with pytest.raises(ValueError, match="different config"):
        FittedPipeline.fit_or_load(path, build, config={"c": 2.0})
    bare = str(tmp_path / "bare.pt")
    fitted.save(bare)  # no config
    with caplog.at_level(logging.WARNING):
        _, loaded = FittedPipeline.fit_or_load(bare, build, config={"c": 1.0})
    assert loaded and "no persisted config" in caplog.text


def test_lazy_results_and_errors():
    p = AddConst(1.0) | AddConst(2.0)
    lazy = p(Dataset(X, device="cpu"))
    assert lazy.get() is lazy.get()
    np.testing.assert_allclose(lazy.numpy(), X + 3.0, rtol=1e-6)
    np.testing.assert_allclose(p.apply_datum(torch.from_numpy(X[0])).get().numpy(), X[0] + 3.0, rtol=1e-6)
    with pytest.raises(RuntimeError, match="unbound source"):
        GraphExecutor(p.graph).execute(p.graph.sinks[0])
    with pytest.raises(ValueError, match="requires training data"):
        p.and_then(MeanShift())
    assert PipelineEnv.get_optimizer() is PipelineEnv.get_optimizer()


# ---------------------------------------------------------------- estimators on Datasets
def _ragged(rng):
    """(12, 7, 5) sets and their mask (12 items: the reference's data mesh
    is 4 wide, and it pads a Dataset's array but not its mask)."""
    x = rng.normal(size=(12, 7, 5)).astype(np.float32) * np.array([3.0, 2.0, 1.0, 0.5, 0.2], np.float32)
    mask = (rng.random((12, 7)) > 0.3).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("kind", ["pca", "pca_masked", "bls", "bwls"])
def test_estimators_fit_datasets_as_the_reference(kind):
    """fit_dataset on dense and masked Datasets against the reference's
    fit_dataset: the PCA projector (signs are arbitrary) at 1e-5, the
    block solvers' predictions at 1e-4 (f32 solves summed in other orders)."""
    from keystone_tpu.models.block_ls import BlockLeastSquaresEstimator as JBls
    from keystone_tpu.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator as JBwls
    from keystone_tpu.models.pca import PCAEstimator as JPCAEstimator
    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
    from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.models.pca import PCAEstimator

    rng = np.random.default_rng(8)
    if kind.startswith("pca"):
        x, mask = _ragged(rng)
        if kind == "pca":
            x, mask = x.reshape(84, 5), None
        got = PCAEstimator(3).fit_dataset(Dataset(x, mask=mask, device="cpu"))
        want = JPCAEstimator(3).fit_dataset(JDataset(x, mask=mask))
        c, jc = got.components.numpy(), np.asarray(want.components)
        np.testing.assert_allclose(c @ c.T, jc @ jc.T, atol=1e-5)
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=1e-6)
        return
    x = rng.normal(size=(40, 12)).astype(np.float32)
    y = -np.ones((40, 3), np.float32)
    y[np.arange(40), rng.integers(0, 3, 40)] = 1.0
    est, jest = {"bls": (BlockLeastSquaresEstimator(block_size=5, num_iter=3, lam=1e-2),
                         JBls(block_size=5, num_iter=3, lam=1e-2)),
                 "bwls": (BlockWeightedLeastSquaresEstimator(block_size=5, num_iter=3, lam=1e-2, mixture_weight=0.3),
                          JBwls(block_size=5, num_iter=3, lam=1e-2, mixture_weight=0.3))}[kind]
    assert est.signature() == jest.signature()[:1] + (jest.params()[:len(est.params())],)
    got = est.fit_dataset(Dataset(x, device="cpu"), Dataset(y, device="cpu"))(torch.from_numpy(x)).numpy()
    want = np.asarray(jest.fit_dataset(JDataset(x), JDataset(y)).apply_batch(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    with pytest.raises(ValueError, match="requires labels"):
        est.fit_dataset(Dataset(x, device="cpu"))


@pytest.mark.parametrize("masked", [False, True])
def test_gmm_fits_datasets_as_their_arrays(masked):
    """The GMM estimators' fit_dataset is fit_arrays on the Dataset's
    tensor and mask (the draws are the port's own: the reference's cannot
    be repeated, and tests/test_torch_fit.py holds EM from its centres)."""
    from keystone_tpu_torch.models.gmm import GaussianMixtureModelEstimator
    from keystone_tpu_torch.ops.fisher import GMMFisherVectorEstimator

    x, mask = _ragged(np.random.default_rng(9))
    if not masked:
        x, mask = x.reshape(84, 5), None
    est = GaussianMixtureModelEstimator(3, max_iterations=4, seed=2)
    got, want = est.fit_dataset(Dataset(x, mask=mask, device="cpu")), est.fit_arrays(x, mask, device="cpu")
    fv = GMMFisherVectorEstimator(3, max_iterations=4, seed=2).fit_dataset(Dataset(x, mask=mask, device="cpu"))
    for a in ("weights", "means", "variances"):
        torch.testing.assert_close(getattr(got, a), getattr(want, a), atol=0, rtol=0)
        torch.testing.assert_close(getattr(fv.gmm, a), getattr(want, a), atol=0, rtol=0)


def test_lambda_identity_and_estimator_sugar_match_reference():
    from keystone_tpu.workflow import Identity as JIdentity
    from keystone_tpu.workflow import transformer as jtransformer
    from keystone_tpu_torch.workflow.transformer import Identity, transformer

    got = (transformer(lambda v: v * 2.0 + 1.0, name="affine") | Identity())(Dataset(X, device="cpu")).get().numpy()
    want = (jtransformer(lambda v: v * 2.0 + 1.0, name="affine") | JIdentity())(JDataset(X)).get().array
    np.testing.assert_allclose(got, np.asarray(want)[: len(X)], rtol=1e-6)
    fitted = MeanShift().with_data(Dataset(X, device="cpu")).fit()
    np.testing.assert_allclose(fitted(Dataset(X, device="cpu")).get().numpy(), X - X.mean(axis=0), atol=1e-6)
    xt = torch.from_numpy(X)
    np.testing.assert_allclose(MeanShift().fit(xt)(xt).numpy(), X - X.mean(axis=0), atol=1e-6)
