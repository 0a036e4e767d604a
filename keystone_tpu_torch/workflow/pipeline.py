"""Pipeline DSL: chain/gather composition, lazy results, fit, save/load
(counterpart of ``keystone_tpu/workflow/pipeline.py`` § PipelineEnv,
Pipeline, FittedPipeline, fit_relevant_config, PipelineDataset,
PipelineDatum, _splice_input, _prune_unreachable).

Reference: workflow/Pipeline.scala § Pipeline[A,B], PipelineDataset,
PipelineDatum — pipelines are DAGs with one open source and one sink;
``andThen`` chains, ``Pipeline.gather`` merges branches, applying a
pipeline to data yields a *lazy* result wrapper, and ``fit()`` resolves
every estimator into its fitted transformer (the reference's
PipelineModel), triggering optimization + execution.

Typical usage:

    featurizer = Pipeline.gather([PixelScaler() | GrayScaler() | SIFTExtractor(), ...])
    predictor = (featurizer
                 .and_then(BlockLeastSquaresEstimator(4096, 1, 1e-4), train_x, train_labels)
                 .and_then(TopKClassifier(5)))
    top5 = predictor.fit()(test_x).get().numpy()

``PipelineEnv.state_dir`` puts a ``SavedStateLoadRule`` batch first in
the default optimizer (saved prefixes reload, ``workflow/state.py``);
``PipelineEnv.node_retries`` / ``KEYSTONE_STAGE_RETRIES`` set every
executor's stage retries; ``fit(deadline=...)`` and ``get(deadline=...)``
bound a walk's wall clock (``workflow/executor.py``).  A fit runs in a
``pipeline.fit`` ledger span and ends with a metrics snapshot when a run
ledger is active (``obs/ledger.py``).

``Pipeline.freeze`` returns a ``FrozenApplier``: the graph optimized
once for the device it will serve on, then applied batch by batch, the
serving path's entry (``keystone_tpu_torch/serve``).

A fit's pre-flight (``_auto_out_of_core``) runs right after the
optimizer: where the profiled materialization pass predicts a resident
footprint over ``KEYSTONE_OOC_FRACTION`` of the device, the large tensor
sources become streams and the fit spills out of core, or, with
``KEYSTONE_AUTO_SPILL=0``, refuses with :class:`PreflightOOMError`.

Not ported yet: the frozen applier's AOT artifacts (ROADMAP A11b), and
the static validator and the cost-based planner behind
``validate=``/``plan=`` (A10).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Sequence, Union

import torch

from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow.dataset import Dataset, as_dataset
from keystone_tpu_torch.workflow.estimator import Estimator, LabelEstimator
from keystone_tpu_torch.workflow.executor import DatasetExpr, DatumExpr, GraphExecutor, TransformerExpr, synchronize
from keystone_tpu_torch.workflow.transformer import Chainable, Transformer
from keystone_tpu_torch.utils.device import resolve_device


class NotPortedError(NotImplementedError):
    """An option of the reference that the port does not have yet; the
    message names the ROADMAP item that ports it."""


class PipelineEnv:
    """Process-global pipeline environment (workflow/PipelineEnv.scala):
    the optimizer every fit and lazy result runs, the state directory of
    saved prefixes, and the stage-retry budget.

    Setting ``state_dir`` puts a ``SavedStateLoadRule`` batch first in the
    default optimizer, so previously saved prefixes reload (the
    reference's saved-state flow)."""

    optimizer = None  # lazily constructed default
    state_dir: Optional[str] = None
    #: stage retries of every executor the framework creates; None reads
    #: KEYSTONE_STAGE_RETRIES at use time (a malformed value must not
    #: break the import, and later changes of the variable take effect)
    node_retries: Optional[int] = None
    _built_for_state_dir: Optional[str] = None
    _auto_built = None  # the instance get_optimizer constructed itself
    _auto_built_sig = ()  # identity of its rule batches at build time

    @classmethod
    def stage_retries(cls) -> int:
        if cls.node_retries is not None:
            return max(0, int(cls.node_retries))
        raw = os.environ.get("KEYSTONE_STAGE_RETRIES", "0")
        try:
            return max(0, int(raw))
        except ValueError:
            logging.getLogger(__name__).warning("KEYSTONE_STAGE_RETRIES=%r is not an integer; using 0", raw)
            return 0

    @classmethod
    def set_optimizer(cls, optimizer) -> None:
        """Install a custom optimizer; the state_dir wiring never replaces
        it (add a SavedStateLoadRule to it yourself if needed)."""
        cls.optimizer = optimizer
        cls._auto_built = None
        cls._auto_built_sig = ()

    @classmethod
    def get_optimizer(cls):
        # anything this method did not build (set_optimizer, assignment to
        # the attribute, or rule batches added to the built default) is
        # the user's: honour it
        if cls.optimizer is not None and (
            cls.optimizer is not cls._auto_built
            or len(cls.optimizer.batches) != len(cls._auto_built_sig)
            or any(b is not s for b, s in zip(cls.optimizer.batches, cls._auto_built_sig))
        ):
            return cls.optimizer
        if cls.optimizer is None or cls._built_for_state_dir != cls.state_dir:
            from keystone_tpu_torch.workflow.optimizer import Once, RuleBatch, default_optimizer

            opt = default_optimizer()
            if cls.state_dir:
                from keystone_tpu_torch.workflow.state import SavedStateLoadRule

                opt.batches.insert(0, RuleBatch("saved-state", Once(), [SavedStateLoadRule(cls.state_dir)]))
            cls.optimizer = opt
            cls._auto_built = opt
            cls._auto_built_sig = tuple(opt.batches)
            cls._built_for_state_dir = cls.state_dir
        return cls.optimizer


class Pipeline(Chainable):
    """A DAG with one open source and one sink."""

    def __init__(self, graph: G.Graph, source: G.SourceId, sink: G.SinkId):
        self.graph = graph
        self.source = source
        self.sink = sink

    # ------------------------------------------------------- constructors
    @staticmethod
    def of(x) -> "Pipeline":
        if isinstance(x, Pipeline):
            return x
        if isinstance(x, Transformer):
            return Pipeline.from_transformer(x)
        raise TypeError(f"cannot lift {x!r} into a Pipeline")

    @staticmethod
    def from_transformer(t: Transformer) -> "Pipeline":
        g = G.Graph()
        g, src = g.add_source()
        g, node = g.add_node(G.TransformerOperator(t), (src,))
        g, sink = g.add_sink(node)
        return Pipeline(g, src, sink)

    @staticmethod
    def from_estimator(est: Estimator, data, labels=None) -> "Pipeline":
        """``est.withData(data[, labels])``: a pipeline whose transform is
        the transformer obtained by fitting ``est`` on ``data``."""
        g = G.Graph()
        g, data_dep = _splice_input(g, data)
        deps = [data_dep]
        if labels is not None:
            g, labels_dep = _splice_input(g, labels)
            deps.append(labels_dep)
        elif isinstance(est, LabelEstimator):
            raise ValueError(f"{est.label} requires labels")
        g, est_node = g.add_node(G.EstimatorOperator(est), tuple(deps))
        g, src = g.add_source()
        g, apply_node = g.add_node(G.DelegatingOperator(), (est_node, src))
        g, sink = g.add_sink(apply_node)
        return Pipeline(g, src, sink)

    @staticmethod
    def gather(branches: Sequence[Union["Pipeline", Transformer]]) -> "Pipeline":
        """Merge N branches over a shared input; output = concatenated
        features (workflow/Pipeline.scala § gather).  The CSE rule merges
        any common branch prefixes so shared featurization runs once."""
        branches = [Pipeline.of(b) for b in branches]
        if not branches:
            raise ValueError("gather of zero branches")
        g = G.Graph()
        g, src = g.add_source()
        outs = []
        for b in branches:
            g, mapping = g.union(b.graph)
            b_src = mapping[b.source]
            g = g.replace_dependency(b_src, src)
            g = g.remove_source(b_src)
            outs.append(g.sink_dependencies[mapping[b.sink]])
            g = g.remove_sink(mapping[b.sink])
        g, gather_node = g.add_node(G.GatherOperator(), tuple(outs))
        g, sink = g.add_sink(gather_node)
        return Pipeline(g, src, sink)

    # ------------------------------------------------------- composition
    def then_pipeline(self, other: "Pipeline") -> "Pipeline":
        g, mapping = self.graph.union(other.graph)
        g = g.connect(self.sink, mapping[other.source])
        return Pipeline(g, self.source, mapping[other.sink])

    def and_then(self, nxt, data=None, labels=None) -> "Pipeline":
        """Chain a transformer/pipeline, or an estimator fit on this
        pipeline's output over ``data`` (workflow/Pipeline.scala § andThen)."""
        if isinstance(nxt, Estimator):
            if data is None:
                raise ValueError(f"and_then({nxt.label}) requires training data")
            featurized = self(data)  # lazy: shares this pipeline's prefix
            return self.then_pipeline(Pipeline.from_estimator(nxt, featurized, labels))
        return self.then_pipeline(Pipeline.of(nxt))

    # -------------------------------------------------------- application
    def __call__(self, data):
        if isinstance(data, PipelineDataset):
            g, mapping = data.graph.union(self.graph)
            out_dep = g.sink_dependencies[data.sink]
            g = g.remove_sink(data.sink)
            new_src = mapping[self.source]
            g = g.replace_dependency(new_src, out_dep)
            g = g.remove_source(new_src)
            return PipelineDataset(g, mapping[self.sink])
        if isinstance(data, Dataset) or _is_batchlike(data):
            g, _ = self.graph.replace_source_with_node(self.source, G.DatasetOperator(as_dataset(data)))
            return PipelineDataset(g, self.sink)
        return self.apply_datum(data)

    def apply_datum(self, x) -> "PipelineDatum":
        """Apply to one datum (arrays are otherwise treated as batches)."""
        g, _ = self.graph.replace_source_with_node(self.source, G.DatumOperator(x))
        return PipelineDatum(g, self.sink)

    # --------------------------------------------------------------- fit
    def fit(self, deadline=None) -> "FittedPipeline":
        """Optimize, execute every estimator fit, and return a pure
        transformer pipeline (the reference's ``Pipeline.fit():
        PipelineModel``).  One executor serves every estimator, so shared
        prefixes run once; its memoized results are dropped with it when
        the fit returns, and the fitted pipeline keeps none of them.

        ``deadline``: a wall-clock budget for the whole fit, seconds or a
        ``utils.guard.Deadline``, counted from this call (the optimizer's
        profiled pass spends from it) and apportioned over the stages by
        the executor: a stage that overruns its share raises
        ``DeadlineExceeded`` inside the stage-retry scope, so a hung
        stage is retried, degraded or fails the fit in bounded time.
        None (the default): no watchdog, no thread.

        With a run ledger (``KEYSTONE_OBS_DIR`` or ``obs.ledger.start_run``)
        the fit runs in a ``pipeline.fit`` span and a metrics snapshot is
        written at its end."""
        from keystone_tpu_torch.obs import ledger
        from keystone_tpu_torch.utils import guard

        deadline = guard.as_deadline(deadline)
        with ledger.span("pipeline.fit"):
            fitted = self._fit_inner(deadline)
        led = ledger.active()
        if led is not None:
            led.metrics_snapshot()
        return fitted

    def _fit_inner(self, deadline) -> "FittedPipeline":
        from keystone_tpu_torch.workflow import profiling

        # the pre-flight reads this fit's own materialize pass: a lazy
        # apply's pass since the last fit must not stand in for it
        profiling.last_footprint.clear()
        g = _auto_out_of_core(PipelineEnv.get_optimizer().execute(self.graph))
        fitted = fit_estimators(g, GraphExecutor(g, deadline=deadline))
        for n, t in fitted.items():
            for dep in g.dependents(n):
                if isinstance(dep, G.NodeId) and isinstance(g.operators[dep], G.DelegatingOperator):
                    rest = tuple(d for d in g.dependencies[dep] if d != n)
                    g = g.set_operator(dep, G.TransformerOperator(t))
                    g = g.set_dependencies(dep, rest)
            g = g.remove_node(n)
        g = _prune_unreachable(g, self.sink, keep_sources=(self.source,))
        # re-fuse: estimator substitution just turned DelegatingOperators
        # (unfusable while the transformer was unknown) into transformers
        from keystone_tpu_torch.workflow.optimizer import StageFusionRule

        return FittedPipeline(StageFusionRule().apply(g), self.source, self.sink)

    def freeze(self, validate=None, example=None, plan=None, device="cuda") -> "FrozenApplier":
        """Freeze this fitted pipeline for repeated online application:
        optimize it once now, for ``device``, and return a
        :class:`FrozenApplier` that binds each incoming batch to the
        optimized graph (the serving entry point).  ``validate``,
        ``example`` and ``plan`` are the reference's pre-flight analyzer
        and cost-based planner (ROADMAP A10): asked for, they raise
        :class:`NotPortedError`; left at their defaults they are inert."""
        return FrozenApplier(self, validate=validate, example=example, plan=plan, device=device)

    def __repr__(self):
        return f"Pipeline({self.graph!r})"


class FittedPipeline(Pipeline):
    """An estimator-free pipeline; saved and loaded with ``torch.save`` /
    ``torch.load`` (the analogue of the reference's serialized
    PipelineModel).  Its fitted transformers' tensors travel with it, on
    the device ``load``'s ``map_location`` names."""

    def fit(self, deadline=None) -> "FittedPipeline":
        return self

    def block_until_ready(self) -> "FittedPipeline":
        """Wait for the device work queued by the fit (a CUDA synchronize)."""
        synchronize()
        return self

    def save(self, path: str, config=None) -> None:
        """Write ``{"config": config, "pipeline": self}`` to ``path``, the
        one format ``load`` and ``fit_or_load`` read."""
        torch.save({"config": config, "pipeline": self}, path)

    @staticmethod
    def _load_raw(path: str, map_location=None):
        """``path`` → (fitted, saved config or None)."""
        obj = torch.load(path, map_location=map_location, weights_only=False)
        if not (isinstance(obj, dict) and isinstance(obj.get("pipeline"), FittedPipeline)):
            raise TypeError(f"{path} does not contain a saved FittedPipeline")
        return obj["pipeline"], obj.get("config")

    @staticmethod
    def load(path: str, map_location=None) -> "FittedPipeline":
        return FittedPipeline._load_raw(path, map_location)[0]

    @staticmethod
    def fit_or_load(path, build_fn, config=None, map_location=None):
        """Load the fitted pipeline saved at ``path``, or build+fit+save.

        ``build_fn`` is called ONLY when fitting is needed — training-data
        loading belongs inside it, so scoring runs with a saved model skip
        it entirely.  ``config`` (any ==-comparable value, e.g. the app's
        Config as ``fit_relevant_config`` gives it) is persisted alongside
        the pipeline; loading with a config that doesn't match what the
        model was fitted with raises instead of silently reporting stale
        results.

        Returns ``(fitted, loaded)`` — ``loaded`` is True when the model
        came from disk.
        """
        if path and os.path.exists(path):
            obj, saved_cfg = FittedPipeline._load_raw(path, map_location)
            if config is not None and saved_cfg is None:
                logging.getLogger(__name__).warning(
                    "saved model at %s has no persisted config (saved without one); cannot verify it "
                    "matches the current config — re-fit (delete the file) to enable the staleness check",
                    path,
                )
            if config is not None and saved_cfg is not None and saved_cfg != config:
                raise ValueError(
                    f"saved model at {path} was fitted with a different config ({saved_cfg!r}); refusing "
                    "to score with mismatched parameters — delete the file or pass a matching config"
                )
            return obj, True
        fitted = build_fn().fit().block_until_ready()
        if path:
            fitted.save(path, config)
        return fitted, False


class FrozenApplier:
    """A fitted pipeline optimized once and applied many times: the
    online-serving apply path (``keystone_tpu_torch.serve``).

    ``Pipeline(...)`` / ``PipelineDataset.get()`` run the whole-pipeline
    optimizer on every application, the right trade for one big offline
    batch and the wrong one for a stream of small requests.  Freezing
    runs the optimizer once over the unbound graph, for ``device`` (the
    card unless the caller asks for the CPU): ``FvFusionRule`` fuses each
    PCA → Fisher-vector pair into the fused kernel's node when that device
    is CUDA, as ``fitted(x)`` does on CUDA data.  Each call binds its
    batch to the optimized graph and runs a fresh ``GraphExecutor`` walk
    over it, so a per-call ``deadline`` is apportioned over the stages and
    ``optional`` / ``with_fallback`` stages degrade on the serve path as
    they do in fits.

    The reference's AOT bucket programs (``export_artifacts``,
    ``install_artifacts``, ``fingerprint``) are ROADMAP A11b: they raise
    :class:`NotPortedError`; with nothing installed the reference's call
    is this walk.  An applier pickles and deep-copies (replica clones)."""

    def __init__(self, pipeline: "Pipeline", validate=None, example=None, plan=None, device="cuda"):
        for op in pipeline.graph.operators.values():
            if isinstance(op, G.EstimatorOperator):
                raise TypeError(f"cannot freeze a pipeline with unfitted estimator {op.label()!r}; call fit() first")
        if validate if validate is not None else os.environ.get("KEYSTONE_VALIDATE", "0") == "1":
            raise NotPortedError("freeze(validate=...): the pre-flight analyzer is not ported yet (ROADMAP A10)")
        if plan is not None and plan is not False:
            raise NotPortedError("freeze(plan=...): the cost-based physical planner is not ported yet (ROADMAP A10)")
        self.device = resolve_device(device)
        self.graph = PipelineEnv.get_optimizer().execute(pipeline.graph, device=self.device)
        self.source = pipeline.source
        self.sink = pipeline.sink
        #: True when a stage declares optional/with_fallback degradation
        from keystone_tpu_torch.workflow.executor import _degradable

        self._degradable = any(_degradable(op) is not None for op in self.graph.operators.values())

    def __call__(self, data, deadline=None) -> Dataset:
        """Apply the frozen graph to one batch (a Dataset, or a tensor or
        array, which goes to the applier's device); returns the result
        Dataset.  ``deadline``: a wall-clock budget for this batch,
        apportioned per stage by the executor."""
        ds = as_dataset(data, device=self.device)
        g, _ = self.graph.replace_source_with_node(self.source, G.DatasetOperator(ds))
        expr = GraphExecutor(g, deadline=deadline).execute(g.sink_dependencies[self.sink])
        if not isinstance(expr, DatasetExpr):
            raise TypeError(f"frozen apply produced {type(expr).__name__}, expected dataset")
        return expr.dataset

    def export_artifacts(self, *args, **kwargs):
        raise NotPortedError("the frozen applier's AOT artifacts (export_artifacts, install_artifacts, "
                             "fingerprint: a torch export or a CUDA-graph form) are not ported yet (ROADMAP A11b)")

    install_artifacts = fingerprint = export_artifacts


def fit_estimators(g: G.Graph, ex: GraphExecutor) -> dict:
    """Execute every estimator node of the optimized graph ``g`` on ``ex``,
    in topological order: ``{node: fitted transformer}``."""
    fitted: dict = {}
    for n in g.topological_nodes():
        if isinstance(g.operators[n], G.EstimatorOperator):
            expr = ex.execute(n)
            assert isinstance(expr, TransformerExpr)
            fitted[n] = expr.transformer
    return fitted


class PreflightOOMError(RuntimeError):
    """``fit()`` refused to start: the predicted resident footprint is over
    the device's budget and auto-spill is off (``KEYSTONE_AUTO_SPILL=0``).
    The message carries the predicted bytes and the ``--stream`` pointer."""


def _auto_out_of_core(g: G.Graph) -> G.Graph:
    """No ``fit()`` may run the card out of memory: the fit's pre-flight.

    The profiled materialization pass priced every shared output
    (``profiling.last_footprint``); this adds the bytes of the tensor
    sources and compares the sum with ``KEYSTONE_OOC_FRACTION`` (0.45) of
    the device's memory.  The estimate counts less than the fit holds
    (unshared memoized outputs, the solver's features and state, and each
    stage's temporaries ride on top), hence a fraction under one half.
    Over it, each large tensor source (at least 1 MiB and an eighth of
    the largest; labels and constants stay) becomes a ``StreamDataset``
    over the same rows, in batches of ``KEYSTONE_SPILL_BATCH`` (512) made
    by one device-to-host read and sent back to the source's device: the
    featurization then streams and the solvers spill their features to a
    ``FeatureBlockStore``, the ``--stream`` path.  ``KEYSTONE_AUTO_SPILL=0``
    refuses instead with the predicted footprint.  The prediction is the
    gauge ``pipeline.preflight_predicted_bytes``."""
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.workflow import profiling
    from keystone_tpu_torch.workflow.dataset import StreamDataset

    sources = []
    for n, op in g.operators.items():
        if isinstance(op, G.DatasetOperator):
            ds = as_dataset(op.dataset)
            if not isinstance(ds, StreamDataset) and not ds.is_host and ds.mask is None:
                sources.append((n, ds, ds.array.numel() * ds.array.element_size()))
    source_bytes = sum(b for _, _, b in sources)
    shared_bytes = int(profiling.last_footprint.get("shared_bytes", 0))
    # consume once: the estimate is this fit's materialize pass's
    profiling.last_footprint.clear()
    predicted = source_bytes + shared_bytes
    metrics.set_gauge("pipeline.preflight_predicted_bytes", float(predicted))
    frac = float(os.environ.get("KEYSTONE_OOC_FRACTION", "0.45"))
    if not sources:
        return g
    _, largest, biggest = max(sources, key=lambda s: s[2])
    limit = profiling.device_hbm_budget(fraction=frac, device=largest.device)
    if predicted <= limit:
        return g
    if os.environ.get("KEYSTONE_AUTO_SPILL", "1") == "0":
        raise PreflightOOMError(
            f"fit() pre-flight: predicted resident footprint ~{predicted / 1e9:.2f} GB (sources "
            f"{source_bytes / 1e9:.2f} GB + shared featurized outputs {shared_bytes / 1e9:.2f} GB) exceeds "
            f"{frac:.0%} of device memory ({limit / 1e9:.2f} GB). Load the training data as a stream (app flag "
            "--stream / --out-of-core, or build with a StreamDataset) so features spill to the disk block store, "
            "or re-enable auto-spill (unset KEYSTONE_AUTO_SPILL).")
    batch = int(os.environ.get("KEYSTONE_SPILL_BATCH", "512"))
    for n, ds, b in sources:
        # parameter-sized datasets (labels, constants) stay resident:
        # streaming them saves nothing, and estimators read labels whole
        if b < max(1 << 20, biggest // 8):
            continue
        rows = ds.array[: ds.n].cpu()  # one device-to-host read

        def batches(_rows=rows):
            for i in range(0, _rows.shape[0], batch):
                yield _rows[i:i + batch]

        g = g.set_operator(n, G.DatasetOperator(StreamDataset(batches, n=ds.n, name=ds.name, device=ds.device)))
        logging.getLogger(__name__).warning(
            "fit() pre-flight: predicted footprint %.2f GB exceeds the %.2f GB device budget; source %s (%.2f GB) "
            "converted to a stream, its features will spill to the disk block store (KEYSTONE_AUTO_SPILL=0 to "
            "refuse instead)", predicted / 1e9, limit / 1e9, ds.name or "dataset", b / 1e9)
    return g


def fit_relevant_config(config, exclude=()):
    """App Config dataclass → dict of FIT-relevant fields for
    ``fit_or_load``'s staleness check.

    Eval-only knobs must not invalidate a saved model — fitting once and
    scoring new test sets later is the feature's purpose — so fields that
    only affect evaluation inputs are dropped: the model path itself,
    test-set paths, view-patch size, and the execution strategy of
    streaming.  ``exclude`` adds app-specific eval-only fields."""
    d = dataclasses.asdict(config)
    eval_only = {
        "model_path",
        "test_path",
        "test_features_path",
        "test_labels_path",
        "view_patch",
        "stream",
        "stream_batch_size",
        "stream_retries",
        "checkpoint_dir",
    } | set(exclude)
    for k in eval_only:
        d.pop(k, None)
    return d


class PipelineDataset:
    """Lazy result of applying a pipeline to a dataset
    (workflow/Pipeline.scala § PipelineDataset).  ``get()`` triggers
    optimize + execute; the result is cached."""

    def __init__(self, graph: G.Graph, sink: G.SinkId):
        self.graph = graph
        self.sink = sink
        self._result: Optional[Dataset] = None

    def get(self, deadline=None) -> Dataset:
        """``deadline``: a wall-clock budget for the apply, apportioned
        over its stages by the executor (the scoring twin of
        ``Pipeline.fit(deadline=...)``)."""
        if self._result is None:
            g = PipelineEnv.get_optimizer().execute(self.graph)
            expr = GraphExecutor(g, deadline=deadline).execute(g.sink_dependencies.get(self.sink, self.sink))
            if not isinstance(expr, DatasetExpr):
                raise TypeError(f"sink produced {type(expr).__name__}, expected dataset")
            self._result = expr.dataset
        return self._result

    def numpy(self):
        return self.get().numpy()


class PipelineDatum:
    """Lazy single-datum result (workflow/Pipeline.scala § PipelineDatum)."""

    def __init__(self, graph: G.Graph, sink: G.SinkId):
        self.graph = graph
        self.sink = sink
        self._result = None
        self._done = False

    def get(self, deadline=None):
        if not self._done:
            g = PipelineEnv.get_optimizer().execute(self.graph)
            expr = GraphExecutor(g, deadline=deadline).execute(g.sink_dependencies.get(self.sink, self.sink))
            if not isinstance(expr, DatumExpr):
                raise TypeError(f"sink produced {type(expr).__name__}, expected datum")
            self._result = expr.value
            self._done = True
        return self._result


# ----------------------------------------------------------------- helpers
def _splice_input(g: G.Graph, data):
    """Attach ``data`` (literal dataset or lazy PipelineDataset graph) to
    ``g``; returns (graph, dependency id of the data's value)."""
    if isinstance(data, PipelineDataset):
        g2, mapping = g.union(data.graph)
        dep = g2.sink_dependencies[mapping[data.sink]]
        return g2.remove_sink(mapping[data.sink]), dep
    return g.add_node(G.DatasetOperator(as_dataset(data)), ())


def _prune_unreachable(g: G.Graph, sink: G.SinkId, keep_sources: Sequence[G.SourceId]) -> G.Graph:
    keep = set(keep_sources)
    keep.add(g.sink_dependencies[sink])
    keep.update(g.ancestors(g.sink_dependencies[sink]))
    for n in list(g.operators):
        if n not in keep:
            g = g.remove_node(n)
    for s in list(g.sources):
        if s not in keep:
            g = g.remove_source(s)
    for k in list(g.sink_dependencies):
        if k != sink:
            g = g.remove_sink(k)
    return g


def _is_batchlike(x) -> bool:
    return isinstance(x, (list, tuple)) or (hasattr(x, "ndim") and x.ndim >= 1)
