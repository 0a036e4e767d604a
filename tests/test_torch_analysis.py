"""The port's pre-flight analyzer (keystone_tpu_torch/analysis) against
the JAX package's (keystone_tpu/analysis), on the CPU.

- **parity on seeded defects**: each planted bug of the reference's
  tests/test_analysis.py, built in both packages from the same numpy
  inputs, gives the same finding codes, severities and node labels (the
  dtype cases use a port stage that casts, as torch narrows only where a
  stage casts);
- **false-positive gate**: every bundled pipeline (``cli._PIPELINE_MODULES``)
  analyzes to zero findings at small sizes, and the solvers' precision
  lint is clean under every mode;
- **wiring**: ``fit(validate=)`` and ``KEYSTONE_VALIDATE``, freeze
  validation, ``cli check``, the DOT overlay and the ledger overlay, and
  the inert default path (the analysis package never imported).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.analysis import analyze as janalyze
from keystone_tpu.analysis import check_fn as jcheck_fn
from keystone_tpu.workflow import Dataset as JDataset
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu.workflow import graph as JG
from keystone_tpu.workflow.transformer import Transformer as JTransformer
from keystone_tpu_torch.analysis import (
    ALL_PASSES,
    AnalysisReport,
    Finding,
    PipelineValidationError,
    analyze,
    check_fn,
)
from keystone_tpu_torch.analysis import precision as precision_pass
from keystone_tpu_torch.analysis.bundled import BUNDLED, build_bundled
from keystone_tpu_torch.analysis.shapes import Aval
from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import Pipeline
from keystone_tpu_torch.workflow.transformer import Transformer


# ------------------------------------------------------------- fixtures
class JScale(JTransformer):
    def __init__(self, k):
        self.k = float(k)

    @property
    def label(self):
        return "Scale"

    def params(self):
        return (self.k,)

    def apply_batch(self, xs, mask=None):
        return xs * self.k


class Scale(Transformer):
    """``cast``: the dtype the stage computes in (None keeps the input's):
    where the port narrows, a stage casts."""

    def __init__(self, k, cast=None):
        super().__init__()
        self.k = float(k)
        self.cast = cast

    def params(self):
        return (self.k, str(self.cast))

    def apply_batch(self, xs, mask=None):
        return (xs if self.cast is None else xs.to(self.cast)) * self.k


class JFixedDot(JTransformer):
    def __init__(self, d):
        self.d = d
        self.w = jnp.eye(d, dtype=jnp.float32)

    @property
    def label(self):
        return "FixedDot"

    def params(self):
        return (self.d,)

    def apply_batch(self, xs, mask=None):
        return xs @ self.w


class FixedDot(Transformer):
    def __init__(self, d):
        super().__init__()
        self.d = d
        self.w = torch.eye(d)

    def params(self):
        return (self.d,)

    def apply_batch(self, xs, mask=None):
        return xs @ self.w


class JUnderSpecified(JScale):
    @property
    def label(self):
        return "UnderSpecified"

    def params(self):
        return ("underspecified",)


class UnderSpecified(Scale):
    def params(self):
        return ("underspecified",)


class JArrayParam(JTransformer):
    def __init__(self, seed):
        self.w = jnp.asarray(np.random.RandomState(seed).randn(4).astype(np.float32))

    @property
    def label(self):
        return "ArrayParam"

    def params(self):
        return ("arrayparam",)

    def apply_batch(self, xs, mask=None):
        return xs * self.w


class ArrayParam(Transformer):
    def __init__(self, seed):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(np.random.RandomState(seed).randn(4).astype(np.float32)))

    def params(self):
        return ("arrayparam",)

    def apply_batch(self, xs, mask=None):
        return xs * self.w


class JWiden(JTransformer):
    def __init__(self, extra):
        self.extra = extra

    @property
    def label(self):
        return "Widen"

    def params(self):
        return (self.extra,)

    def apply_batch(self, xs, mask=None):
        return jnp.repeat(xs, self.extra, axis=0)


class Widen(Transformer):
    def __init__(self, extra):
        super().__init__()
        self.extra = extra

    def params(self):
        return (self.extra,)

    def apply_batch(self, xs, mask=None):
        return torch.repeat_interleave(xs, self.extra, dim=0)


def _jds(a, **kw):
    return JDataset(np.asarray(a), shard=False, **kw)


def _ds(a, **kw):
    return Dataset(torch.from_numpy(np.asarray(a)), **kw)


def _triples(report):
    return sorted((f.code, f.severity, f.label) for f in report.findings)


# ------------------------------------------------------------ the cases
def _shape_mismatch():
    x = np.zeros((4, 12), np.float32)
    return (janalyze(JPipeline.of(JScale(2.0)).and_then(JFixedDot(8)), example=x),
            analyze(Pipeline.of(Scale(2.0)).and_then(FixedDot(8)), example=x))


def _clean():
    x = np.zeros((4, 8), np.float32)
    return (janalyze(JPipeline.of(JScale(2.0)).and_then(JFixedDot(8)), example=x),
            analyze(Pipeline.of(Scale(2.0)).and_then(FixedDot(8)), example=x))


def _untraceable():
    """A data-dependent stage and a host-numpy stage: unanalyzable, never
    a finding."""

    class JDataDependent(JTransformer):
        def params(self):
            return ()

        def apply_batch(self, xs, mask=None):
            return xs if float(np.asarray(jnp.sum(xs))) > 0 else -xs

    class DataDependent(Transformer):
        def params(self):
            return ()

        def apply_batch(self, xs, mask=None):
            return xs if float(xs.sum()) > 0 else -xs

    class HostNumpy(Transformer):
        def params(self):
            return ()

        def apply_batch(self, xs, mask=None):
            return torch.from_numpy(xs.numpy() * 2.0)

    x = np.zeros((4, 8), np.float32)
    ref = janalyze(JPipeline.of(JDataDependent()).and_then(JScale(1.0)), example=x)
    port = AnalysisReport()
    for t in (DataDependent(), HostNumpy()):
        port.extend(analyze(Pipeline.of(t).and_then(Scale(1.0)), example=x).findings)
    # ...and the stages do run on data
    assert tuple(DataDependent()(torch.ones(4, 8)).shape) == (4, 8)
    return ref, port


def _f64_input():
    x = np.zeros((4, 8), np.float64)
    return (janalyze(JPipeline.of(JScale(2.0)), example=x),
            analyze(Pipeline.of(Scale(2.0, cast=torch.float32)), example=x))


def _f64_datum():
    return (janalyze(JPipeline.of(JScale(1.0)).apply_datum(np.zeros(4, np.float64))),
            analyze(Pipeline.of(Scale(1.0, cast=torch.float32)).apply_datum(np.zeros(4, np.float64))))


def _host_stream():
    from keystone_tpu.workflow.dataset import StreamDataset as JStream
    from keystone_tpu_torch.workflow.dataset import StreamDataset

    def build(GG, Pipe, stream, t):
        g = GG.Graph()
        g, src = g.add_source()
        g, dsn = g.add_node(GG.DatasetOperator(stream), ())
        g, node = g.add_node(GG.TransformerOperator(t), (dsn,))
        g, sink = g.add_sink(node)
        return Pipe(g, src, sink)

    return (janalyze(build(JG, JPipeline, JStream(lambda: iter([["a", "b"]]), n=2, host=True), JScale(1.0))),
            analyze(build(G, Pipeline, StreamDataset(lambda: iter([["a", "b"]]), n=2, host=True, device="cpu"),
                          Scale(1.0))))


def _bad_delegate():
    def build(GG, Pipe, data):
        g = GG.Graph()
        g, src = g.add_source()
        g, dsn = g.add_node(GG.DatasetOperator(data), ())
        g, dlg = g.add_node(GG.DelegatingOperator(), (dsn, src))
        g, sink = g.add_sink(dlg)
        return Pipe(g, src, sink)

    x = np.zeros((4, 3), np.float32)
    return analyze_pair(build(JG, JPipeline, _jds(x)), build(G, Pipeline, _ds(x)))


def analyze_pair(jpipe, ppipe, jkw=None, pkw=None):
    return janalyze(jpipe, **(jkw or {})), analyze(ppipe, **(pkw or {}))


def _gather_mismatch():
    x = np.zeros((4, 8), np.float32)
    return (janalyze(JPipeline.gather([JScale(1.0), JWiden(2)]), example=x),
            analyze(Pipeline.gather([Scale(1.0), Widen(2)]), example=x))


def _unfitted_apply():
    from keystone_tpu.models import LinearMapEstimator as JLinearMapEstimator
    from keystone_tpu_torch.models.linear import LinearMapEstimator

    x, y = np.zeros((8, 4), np.float32), np.ones((8, 2), np.float32)
    jp = JPipeline.of(JScale(1.0)).and_then(JLinearMapEstimator(lam=0.1), _jds(x), _jds(y))
    pp = Pipeline.of(Scale(1.0)).and_then(LinearMapEstimator(lam=0.1), _ds(x), _ds(y))
    assert janalyze(jp, mode="fit").ok and analyze(pp, mode="fit").ok
    return janalyze(jp, mode="apply"), analyze(pp, mode="apply")


def _kernel_mappers(d_in, alpha_rows):
    from keystone_tpu.models.kernel_ridge import GaussianKernelGenerator as JGK
    from keystone_tpu.models.kernel_ridge import KernelBlockLinearMapper as JKM
    from keystone_tpu_torch.models.kernel_ridge import GaussianKernelGenerator, KernelBlockLinearMapper

    tx, alpha = np.zeros((64, 8), np.float32), np.zeros((alpha_rows, 3), np.float32)
    jm = JKM(JGK(0.1), jnp.asarray(tx), jnp.asarray(alpha), 16, 64)
    pm = KernelBlockLinearMapper(GaussianKernelGenerator(0.1), torch.from_numpy(tx), torch.from_numpy(alpha), 16, 64)
    x = np.zeros((4, d_in), np.float32)
    return janalyze(JPipeline.of(jm), example=x), analyze(Pipeline.of(pm), example=x)


def _nystrom_mismatch():
    from keystone_tpu.models.kernel_ridge import GaussianKernelGenerator as JGK
    from keystone_tpu.models.nystrom import NystromFeatureMap as JNys
    from keystone_tpu_torch.models.kernel_ridge import GaussianKernelGenerator
    from keystone_tpu_torch.models.nystrom import NystromFeatureMap

    lmk, wh = np.zeros((6, 8), np.float32), np.eye(6, dtype=np.float32)
    x = np.zeros((4, 9), np.float32)
    return (janalyze(JPipeline.of(JNys(JGK(0.1), jnp.asarray(lmk), jnp.asarray(wh))), example=x),
            analyze(Pipeline.of(NystromFeatureMap(GaussianKernelGenerator(0.1), torch.from_numpy(lmk),
                                                  torch.from_numpy(wh))), example=x))


def _degenerate_generator(gamma):
    from keystone_tpu.models.kernel_ridge import GaussianKernelGenerator as JGK
    from keystone_tpu.models.kernel_ridge import KernelRidgeRegressionEstimator as JKRR
    from keystone_tpu_torch.models.kernel_ridge import GaussianKernelGenerator, KernelRidgeRegressionEstimator

    x, y = np.zeros((8, 4), np.float32), np.zeros((8, 2), np.float32)
    ex = np.zeros((4, 4), np.float32)
    return (janalyze(JPipeline.from_estimator(JKRR(JGK(gamma)), _jds(x), _jds(y)), example=ex),
            analyze(Pipeline.from_estimator(KernelRidgeRegressionEstimator(GaussianKernelGenerator(gamma)), _ds(x),
                                            _ds(y)), example=ex))


def _fault_plan(monkeypatch, plan):
    monkeypatch.setenv("KEYSTONE_FAULTS", plan)
    return janalyze(JPipeline.of(JScale(1.0))), analyze(Pipeline.of(Scale(1.0)))


def _breakers(monkeypatch, degrade):
    monkeypatch.setenv("KEYSTONE_BREAKER_THRESHOLD", "2")
    if degrade:
        return (janalyze(JPipeline.of(JScale(1.0).with_fallback(JScale(0.0)))),
                analyze(Pipeline.of(Scale(1.0).with_fallback(Scale(0.0)))))
    return janalyze(JPipeline.of(JScale(1.0))), analyze(Pipeline.of(Scale(1.0)))


def _collision(cls_pair, args):
    jcls, pcls = cls_pair
    x = np.zeros((4, 8 if jcls is not JArrayParam else 4), np.float32)
    return (janalyze(JPipeline.gather([jcls(a) for a in args]), example=x),
            analyze(Pipeline.gather([pcls(a) for a in args]), example=x))


def _dataset_names():
    from keystone_tpu.models import LinearMapEstimator as JLME
    from keystone_tpu_torch.models.linear import LinearMapEstimator as LME

    def build(Pipe, S, E, ds):
        d1, d2 = ds(np.zeros((8, 4), np.float32), name="train"), ds(np.zeros((6, 4), np.float32), name="train")
        return Pipe.gather([Pipe.of(S(1.0)).and_then(E(lam=0.1), d1, ds(np.ones((8, 2), np.float32))),
                            Pipe.of(S(2.0)).and_then(E(lam=0.2), d2, ds(np.ones((6, 2), np.float32)))])

    return janalyze(build(JPipeline, JScale, JLME, _jds)), analyze(build(Pipeline, Scale, LME, _ds))


def _unstable():
    import itertools

    jc, pc = itertools.count(), itertools.count()

    class JUnstable(JTransformer):
        label = "Unstable"

        def params(self):
            return (next(jc),)

        def apply_batch(self, xs, mask=None):
            return xs

    class Unstable(Transformer):
        def params(self):
            return (next(pc),)

        def apply_batch(self, xs, mask=None):
            return xs

    return janalyze(JPipeline.of(JUnstable())), analyze(Pipeline.of(Unstable()))


CASES = {
    "shape-mismatch": (_shape_mismatch, {"shape-mismatch"}),
    "clean": (_clean, set()),
    "untraceable": (_untraceable, set()),
    "f64-input": (_f64_input, {"dtype-downcast", "stage-downcast"}),
    "f64-datum": (_f64_datum, {"dtype-downcast", "stage-downcast"}),
    "host-stream": (_host_stream, {"host-stream-device-stage"}),
    "bad-delegate": (_bad_delegate, {"bad-delegate"}),
    "gather-mismatch": (_gather_mismatch, {"gather-mismatch"}),
    "unfitted-apply": (_unfitted_apply, {"unfitted-estimator"}),
    "kernel-clean": (lambda: _kernel_mappers(8, 64), set()),
    "kernel-shape": (lambda: _kernel_mappers(9, 64), {"kernel-shape-mismatch"}),
    "kernel-state": (lambda: _kernel_mappers(8, 48), {"kernel-bad-state"}),
    "nystrom-shape": (_nystrom_mismatch, {"kernel-shape-mismatch"}),
    "gamma-zero": (lambda: _degenerate_generator(0.0), {"bad-kernel-generator"}),
    "gamma-nan": (lambda: _degenerate_generator(float("nan")), {"bad-kernel-generator"}),
    "collision": (lambda: _collision((JUnderSpecified, UnderSpecified), (1.0, 2.0)), {"signature-collision"}),
    "no-collision": (lambda: _collision((JUnderSpecified, UnderSpecified), (1.0, 1.0)), set()),
    "array-collision": (lambda: _collision((JArrayParam, ArrayParam), (0, 1)), {"signature-collision"}),
    "dataset-names": (_dataset_names, {"dataset-name-collision"}),
    "unstable": (_unstable, {"unstable-signature"}),
}
ENV_CASES = {
    "bad-fault-plan": (lambda mp: _fault_plan(mp, "bogus.site:raise"), {"bad-fault-plan"}),
    "good-fault-plan": (lambda mp: _fault_plan(mp, "executor.stage:times=0"), set()),
    "breaker": (lambda mp: _breakers(mp, False), {"mandatory-under-breaker"}),
    "breaker-degrades": (lambda mp: _breakers(mp, True), set()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_seeded_defects_match_the_reference(case):
    build, codes = CASES[case]
    ref, port = build()
    assert {f.code for f in port.findings} == codes, port.render()
    assert _triples(port) == _triples(ref), (port.render(), ref.render())


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_robustness_defects_match_the_reference(monkeypatch, case):
    build, codes = ENV_CASES[case]
    ref, port = build(monkeypatch)
    assert {f.code for f in port.findings} == codes, port.render()
    assert _triples(port) == _triples(ref)
    if case == "bad-fault-plan":
        assert "bogus.site" in port.errors[0].message


def test_infeasible_deadline_warns():
    pipe, example = build_bundled("MnistRandomFFT", device="cpu")
    report = analyze(pipe, example=example, deadline=1e-6)
    assert "deadline-infeasible" in {f.code for f in report.warnings} and not report.errors


def test_f64_that_no_stage_narrows_is_not_a_finding():
    """Torch keeps float64: a pipeline that never casts narrows nothing
    (the reference's jax narrows at the device boundary)."""
    assert not analyze(Pipeline.of(Scale(2.0)), example=np.zeros((4, 8), np.float64)).findings


def test_fisher_vector_stages_are_walked_without_a_launch():
    """The FV stages' explicit case: the output width from the GMM, a
    descriptor width that disagrees with the PCA a shape mismatch."""
    from keystone_tpu_torch.models.gmm import GaussianMixtureModel
    from keystone_tpu_torch.models.pca import PCATransformer
    from keystone_tpu_torch.ops.fisher import FisherVector, FusedPcaFisherVector

    gmm = GaussianMixtureModel(torch.full((3,), 1 / 3), torch.zeros(3, 4), torch.ones(3, 4))
    pca = PCATransformer(torch.zeros(16, 4), torch.zeros(16))
    chain = Pipeline.of(pca).and_then(FisherVector(gmm)).and_then(FixedDot(24))
    assert not analyze(chain, example=np.zeros((2, 5, 16), np.float32)).findings
    fused = Pipeline.of(FusedPcaFisherVector(pca, gmm)).and_then(FixedDot(24))
    assert not analyze(fused, example=np.zeros((2, 5, 16), np.float32)).findings
    rep = analyze(fused, example=np.zeros((2, 5, 15), np.float32))
    assert [(f.code, f.label) for f in rep.errors] == [("shape-mismatch", "FusedFV[PCA > FV]")]
    # the head's width is checked against the FV's output (2·K·d = 24)
    rep = analyze(Pipeline.of(pca).and_then(FisherVector(gmm)).and_then(FixedDot(20)),
                  example=np.zeros((2, 5, 16), np.float32))
    assert [f.code for f in rep.errors] == ["shape-mismatch"]


def test_oc_kernel_mapper_checked_without_reading_blocks(tmp_path):
    from keystone_tpu_torch.models.kernel_ridge import GaussianKernelGenerator, OutOfCoreKernelBlockLinearMapper
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.workflow.blockstore import RowBlockStore

    store = RowBlockStore.from_array(str(tmp_path / "s"), np.zeros((64, 8), np.float32), 16)
    m = OutOfCoreKernelBlockLinearMapper(GaussianKernelGenerator(0.1), store.directory, torch.zeros(64, 3), 64)
    reads0 = metrics.REGISTRY.counter_total("blockstore.reads")
    assert not analyze(Pipeline.of(m), example=np.zeros((4, 8), np.float32)).findings
    assert metrics.REGISTRY.counter_total("blockstore.reads") == reads0
    rep = analyze(Pipeline.of(m), example=np.zeros((4, 9), np.float32))
    assert [f.code for f in rep.errors] == ["kernel-shape-mismatch"]
    gone = OutOfCoreKernelBlockLinearMapper(GaussianKernelGenerator(0.1), str(tmp_path / "missing"),
                                            torch.zeros(64, 3), 64)
    assert [f.code for f in analyze(Pipeline.of(gone), example=np.zeros((4, 8), np.float32)).errors] == [
        "kernel-bad-state"]


# ------------------------------------------------------ false positives
@pytest.mark.parametrize("name", BUNDLED)
def test_bundled_pipeline_zero_findings(name):
    pipe, example = build_bundled(name, device="cpu")
    report = analyze(pipe, example=example, passes=ALL_PASSES[:3] + ("plan",))
    assert not report.findings, report.render()


def test_bundled_pipelines_are_the_cli_pipelines():
    from keystone_tpu_torch import cli

    assert set(BUNDLED) == set(cli._PIPELINE_MODULES)


def test_solver_precision_lint_clean_all_modes():
    findings = precision_pass.run()
    assert not findings, "\n".join(f.render() for f in findings)


@pytest.mark.parametrize("entry", [n for n, _ in precision_pass.SOLVER_ENTRIES])
def test_each_solver_entry_dispatches_audited_contractions(entry):
    """The lint is not vacuous: every entry runs and dispatches at least
    one contraction the recorder sees, all of them f32 in and out."""
    build = dict(precision_pass.SOLVER_ENTRIES)[entry]
    fn, args = build()
    rec = precision_pass._ContractionRecorder()
    with rec:
        fn(*args)
    assert rec.records, f"{entry} dispatched no contraction"
    assert all(set(ins) | set(outs) <= {torch.float32} for _, ins, outs, _ in rec.records), rec.records


def test_solver_registry_covers_every_family():
    from keystone_tpu.analysis import precision as jprecision

    assert {n for n, _ in precision_pass.SOLVER_ENTRIES} == {n for n, _ in jprecision.SOLVER_ENTRIES}


# ------------------------------------------------------------ precision
def test_planted_bf16_solver_is_flagged_in_both_packages():
    def jbad(a, b):
        return jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16))

    def bad(a, b):
        return a.to(torch.bfloat16) @ b.to(torch.bfloat16)

    want = sorted({f.code for f in jcheck_fn(jbad, *(jax.ShapeDtypeStruct((4, 4), np.float32),) * 2,
                                             name="planted")})
    got = check_fn(bad, torch.ones(4, 4), torch.ones(4, 4), name="planted")
    assert sorted({f.code for f in got}) == want == ["bf16-solver-input", "non-f32-accumulation"]
    assert all(f.severity == "error" and f.label == "planted" for f in got)


def test_descriptor_stream_leak_into_a_solver_is_flagged_under_bf16():
    """The defect class the mode sweep exists for: a solver that reads the
    descriptor stream's dtype leaks bf16 under mode bf16, and is clean
    under f32 (so the sweep must run every mode)."""
    from keystone_tpu_torch.utils import precision

    def leaky_solver(a, b):
        dt = precision.fdtype()
        return (a.to(dt) @ b.to(dt)).float()

    a, b = torch.ones(4, 4), torch.ones(4, 4)
    with precision.matmul("bf16"):
        assert {f.code for f in check_fn(leaky_solver, a, b, name="leaky")} == {"bf16-solver-input",
                                                                                "non-f32-accumulation"}
    with precision.matmul("f32"):
        assert not check_fn(leaky_solver, a, b, name="leaky")


def test_tf32_counts_as_degraded_accumulation(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    got = check_fn(lambda a, b: a @ b, torch.ones(4, 4), torch.ones(4, 4), name="tf32")
    assert [f.code for f in got] == ["non-f32-accumulation"] and "allow_tf32" in got[0].message


# ---------------------------------------------------------------- report
def test_report_render_and_dict():
    rep = AnalysisReport([Finding("warning", "shapes", "dtype-downcast", "w", node=3, label="X"),
                          Finding("error", "shapes", "shape-mismatch", "boom", node=5, label="Y")])
    text = rep.render()
    assert text.splitlines()[0].startswith("ERROR") and "n5[Y]" in text and "n3[X]" in text
    d = rep.to_dict()
    assert d["errors"] == 1 and d["warnings"] == 1
    with pytest.raises(PipelineValidationError) as ei:
        rep.raise_for_errors()
    assert ei.value.report is rep


# ---------------------------------------------------------------- wiring
def _broken_fit_pipeline():
    from keystone_tpu_torch.models.linear import LinearMapEstimator

    return Pipeline.of(FixedDot(8)).and_then(LinearMapEstimator(lam=0.1), _ds(np.zeros((8, 12), np.float32)),
                                             _ds(np.ones((8, 2), np.float32)))


def test_fit_validate_refuses_broken_pipeline_before_any_work():
    from keystone_tpu_torch.workflow import executor

    calls = []
    orig = executor.GraphExecutor.execute
    executor.GraphExecutor.execute = lambda self, *a, **k: calls.append(1) or orig(self, *a, **k)
    try:
        with pytest.raises(PipelineValidationError) as ei:
            _broken_fit_pipeline().fit(validate=True)
    finally:
        executor.GraphExecutor.execute = orig
    assert "shape-mismatch" in str(ei.value) and not calls


def test_fit_validate_env_gate(monkeypatch):
    monkeypatch.setenv("KEYSTONE_VALIDATE", "1")
    with pytest.raises(PipelineValidationError):
        _broken_fit_pipeline().fit()
    monkeypatch.setenv("KEYSTONE_VALIDATE", "0")
    with pytest.raises(PipelineValidationError):
        _broken_fit_pipeline().fit(validate=True)


def test_bad_fault_plan_refuses_the_fit(monkeypatch):
    from keystone_tpu_torch.models.linear import LinearMapEstimator

    monkeypatch.setenv("KEYSTONE_FAULTS", "executor.stag:raise")
    pipe = Pipeline.of(Scale(1.0)).and_then(LinearMapEstimator(lam=0.1), _ds(np.zeros((8, 4), np.float32)),
                                            _ds(np.ones((8, 2), np.float32)))
    with pytest.raises(PipelineValidationError, match="bad-fault-plan"):
        pipe.fit(validate=True)


def test_fit_validate_passes_clean_pipeline():
    from keystone_tpu_torch.models.linear import LinearMapEstimator

    data = _ds(np.random.RandomState(0).randn(16, 4).astype(np.float32))
    pipe = Pipeline.of(Scale(1.0)).and_then(LinearMapEstimator(lam=0.1), data, _ds(np.ones((16, 2), np.float32)))
    fitted = pipe.fit(validate=True)
    assert tuple(fitted(torch.zeros(4, 4)).get().array.shape) == (4, 2)
    applier = fitted.freeze(validate=True, example=(4,), device="cpu")
    assert tuple(applier(torch.zeros(4, 4)).array.shape) == (4, 2)


def test_freeze_validate_flags_mis_shaped_example():
    fitted = Pipeline.of(FixedDot(8)).fit(validate=True)
    with pytest.raises(PipelineValidationError):
        fitted.freeze(validate=True, example=(12,), device="cpu")
    assert fitted.freeze(validate=True, example=(8,), device="cpu") is not None
    assert fitted.freeze(validate=True, example=Aval((3, 8), torch.float32), device="cpu") is not None


def test_cli_check_bundled(tmp_path, capsys):
    from keystone_tpu_torch import cli

    dot = tmp_path / "graph.dot"
    assert cli.main(["check", "MnistRandomFFT", "--device", "cpu", "--dot", str(dot)]) == 0
    assert "no findings" in capsys.readouterr().out
    assert dot.exists() and "digraph" in dot.read_text()


def test_cli_check_saved_model_roundtrip(tmp_path, capsys):
    from keystone_tpu_torch import cli

    path = tmp_path / "model.pt"
    Pipeline.of(FixedDot(8)).fit().save(str(path))
    assert cli.main(["check", "--model", str(path), "--no-solver-lint", "--example-shape", "8",
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    assert cli.main(["check", "--model", str(path), "--no-solver-lint", "--example-shape", "12",
                     "--device", "cpu", "--json"]) == 1
    assert '"shape-mismatch"' in capsys.readouterr().out


def test_cli_check_unknown_name():
    from keystone_tpu_torch import cli

    assert cli.main(["check", "NoSuchPipeline", "--no-solver-lint", "--device", "cpu"]) == 2


def test_to_dot_findings_overlay():
    pipe = Pipeline.of(Scale(2.0)).and_then(FixedDot(8))
    report = analyze(pipe, example=np.zeros((4, 12), np.float32))
    dot = pipe.to_dot(findings=report.findings)
    assert "#ff9999" in dot and "shape-mismatch" in dot
    dot2 = pipe.to_dot(findings=[Finding("warning", "robustness", "bad-fault-plan", "m")])
    assert "analysis_findings" in dot2 and "#ffe680" in dot2


def test_ledger_overlay_matches_the_reference(tmp_path):
    """The port's ledger has the reference's schema: both overlays fold a
    fit's ledger into the same timings and retries, and the DOT renders
    them."""
    from keystone_tpu.workflow.viz import ledger_overlay as jledger_overlay
    from keystone_tpu_torch.models.linear import LinearMapEstimator
    from keystone_tpu_torch.obs import ledger
    from keystone_tpu_torch.workflow.viz import ledger_overlay

    pipe = Pipeline.of(Scale(1.0)).and_then(LinearMapEstimator(lam=0.1), _ds(np.ones((8, 4), np.float32)),
                                            _ds(np.ones((8, 2), np.float32)))
    led = ledger.start_run(str(tmp_path))
    try:
        pipe.fit()
    finally:
        ledger.stop_run()
    path = led.path
    timings, retries = ledger_overlay(path)
    assert (timings, retries) == jledger_overlay(path) and timings
    assert any(f"{v:.3f}s" in pipe.to_dot(timings=timings) for v in timings.values())


def test_default_fit_path_stays_inert(monkeypatch):
    """Validation off (the default): fit and freeze never import the
    analysis package."""
    from keystone_tpu_torch.models.linear import LinearMapEstimator

    for mod in [m for m in sys.modules if m.startswith("keystone_tpu_torch.analysis")]:
        monkeypatch.delitem(sys.modules, mod, raising=False)
    monkeypatch.delenv("KEYSTONE_VALIDATE", raising=False)
    data = _ds(np.random.RandomState(0).randn(16, 4).astype(np.float32))
    Pipeline.of(Scale(1.0)).and_then(LinearMapEstimator(lam=0.1), data, _ds(np.ones((16, 2), np.float32))) \
        .fit().freeze(device="cpu")
    assert not any(m.startswith("keystone_tpu_torch.analysis") for m in sys.modules)


def test_analysis_allocates_nothing_and_launches_nothing():
    """The walk runs on fake tensors: no kernel wrapper launches, and the
    inputs' storages are never read."""
    from keystone_tpu_torch.ops import fisher_kernels as fk
    from keystone_tpu_torch.ops import gram_kernels as gk

    fk.reset_launches()
    gk.reset_launches()
    for name in ("ImageNetSiftLcsFV", "KernelTimitPipeline"):
        pipe, example = build_bundled(name, device="cpu")
        assert analyze(pipe, example=example).ok
    assert not any(fk.LAUNCHES.values()) and not any(gk.LAUNCHES.values())
