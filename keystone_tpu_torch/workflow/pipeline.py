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
serving path's entry (``keystone_tpu_torch/serve``); with an artifact
bundle installed, a batch at a padding bucket's shape replays that
bucket's CUDA graph instead of walking.

A fit's pre-flight (``_auto_out_of_core``) runs right after the
optimizer: where the profiled materialization pass predicts a resident
footprint over ``KEYSTONE_OOC_FRACTION`` of the device, the large tensor
sources become streams and the fit spills out of core, or, with
``KEYSTONE_AUTO_SPILL=0``, refuses with :class:`PreflightOOMError`.

``fit(validate=)`` and ``freeze(validate=)`` run the pre-flight analyzer
(``keystone_tpu_torch/analysis``) before any device work: error findings
raise ``PipelineValidationError``.  ``None`` reads ``KEYSTONE_VALIDATE``
("1" is on); off, the cost is one env lookup and the analysis package is
never imported.  ``freeze(plan=True|PhysicalPlan, example=)`` builds or
installs the cost-based physical plan (``keystone_tpu_torch/planner``)
before the optimizer runs, so the plan's gates decide the frozen graph;
the plan travels with the applier's pickle and in its artifact manifest.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import weakref
from collections import Counter
from typing import Optional, Sequence, Union

import torch

from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow.dataset import Dataset, as_dataset
from keystone_tpu_torch.workflow.estimator import Estimator, LabelEstimator
from keystone_tpu_torch.workflow.executor import DatasetExpr, DatumExpr, GraphExecutor, TransformerExpr, synchronize
from keystone_tpu_torch.workflow.transformer import Chainable, Transformer
from keystone_tpu_torch.utils import graphs
from keystone_tpu_torch.utils.device import resolve_device


def _validate_requested(validate) -> bool:
    """The one pre-flight gate of ``fit`` and ``freeze``: an explicit flag
    wins, None reads ``KEYSTONE_VALIDATE``.  Kept here (not
    ``analysis.validation_enabled``) so that the off path costs one env
    lookup and never imports the analysis package."""
    if validate is not None:
        return bool(validate)
    return os.environ.get("KEYSTONE_VALIDATE", "0") == "1"


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

    def apply(self, data):
        """``self(data)``: the reference's name for application."""
        return self(data)

    def apply_datum(self, x) -> "PipelineDatum":
        """Apply to one datum (arrays are otherwise treated as batches)."""
        g, _ = self.graph.replace_source_with_node(self.source, G.DatumOperator(x))
        return PipelineDatum(g, self.sink)

    # --------------------------------------------------------------- fit
    def fit(self, deadline=None, validate=None) -> "FittedPipeline":
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

        ``validate``: run the pre-flight analyzer first (abstract shape and
        dtype propagation on fake tensors, the fault-plan, breaker and
        deadline lint, the signature audit): error findings raise
        ``PipelineValidationError`` before any launch, warnings log.  None
        reads ``KEYSTONE_VALIDATE``.

        With a run ledger (``KEYSTONE_OBS_DIR`` or ``obs.ledger.start_run``)
        the fit runs in a ``pipeline.fit`` span and a metrics snapshot is
        written at its end."""
        from keystone_tpu_torch.obs import ledger
        from keystone_tpu_torch.utils import guard

        if _validate_requested(validate):
            from keystone_tpu_torch.analysis import validate_fit

            validate_fit(self, deadline=deadline)
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
        optimized graph (the serving entry point).

        ``validate``: the apply-mode pre-flight (an unfitted estimator is
        an error) before anything runs; None reads ``KEYSTONE_VALIDATE``.
        ``example``: one datum's shape (a tuple) or a batch, seeding its
        shape walk; a batch also feeds ``plan=True``'s samples.  ``plan``:
        ``True`` samples the physical candidates on ``example``'s rows and
        installs the resulting ``PhysicalPlan``, a ``PhysicalPlan`` is
        installed as it is; either before the optimizer runs.  None: no
        plan, the static path."""
        return FrozenApplier(self, validate=validate, example=example, plan=plan, device=device)

    def to_dot(self, name: str = "pipeline", timings=None, retries=None, findings=None) -> str:
        """Graphviz DOT of this pipeline's DAG (``Pipeline.toDOT``).
        ``timings`` / ``retries`` overlay measured per-node seconds and
        retry counts (``workflow/viz.ledger_overlay`` folds them out of a
        run ledger); ``findings`` overlays analyzer findings (red: error,
        yellow: warning; ``cli check --dot``)."""
        from keystone_tpu_torch.workflow.viz import to_dot

        return to_dot(self.graph, name, timings=timings, retries=retries, findings=findings)

    def __repr__(self):
        return f"Pipeline({self.graph!r})"


class FittedPipeline(Pipeline):
    """An estimator-free pipeline; saved and loaded with ``torch.save`` /
    ``torch.load`` (the analogue of the reference's serialized
    PipelineModel).  Its fitted transformers' tensors travel with it, on
    the device ``load``'s ``map_location`` names."""

    def fit(self, deadline=None, validate=None) -> "FittedPipeline":
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
    def fit_or_load(path, build_fn, config=None, map_location=None, save: bool = True):
        """Load the fitted pipeline saved at ``path``, or build+fit+save.

        ``build_fn`` is called ONLY when fitting is needed — training-data
        loading belongs inside it, so scoring runs with a saved model skip
        it entirely.  ``config`` (any ==-comparable value, e.g. the app's
        Config as ``fit_relevant_config`` gives it) is persisted alongside
        the pipeline; loading with a config that doesn't match what the
        model was fitted with raises instead of silently reporting stale
        results.

        Returns ``(fitted, loaded)`` — ``loaded`` is True when the model
        came from disk.  ``save=False`` fits without writing ``path`` (the
        ranks but one of a job whose ranks fit the same model).
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
        if path and save:
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

    **Bucket graphs** (the reference's AOT bucket programs): an artifact
    bundle (:meth:`export_artifacts`) names the padding buckets and keys
    them by the format, torch and CUDA versions, the device's compute
    capability, the kernel sources' hashes and the pipeline's
    :meth:`fingerprint`.  :meth:`install_artifacts` verifies the key
    (any skew rejects the bundle, counted, and the walk serves) and
    registers one bucket program per bucket: the first call at that
    bucket's exact shape and dtype runs the walk once (the kernels' first
    launches) and captures a second walk as one CUDA graph on the
    caller's stream; later calls copy into the graph's static input,
    replay, and clone its output.  The graphs of one applier share one
    memory pool and replay one at a time.  The bundle ships no code: each
    process and each replica captures its own graphs, and a pickled or
    deep-copied applier keeps the bundle and drops the graphs.  An
    applier pickles and deep-copies (replica clones).

    **Physical plan**: ``plan=`` installs a ``PhysicalPlan`` before the
    optimizer runs, so its ``fused_fv`` choice decides the frozen graph
    (:attr:`physical_choices` records what it decided).  The plan pickles
    with the applier and rides :meth:`export_artifacts`' manifest;
    :meth:`install_artifacts` reinstalls a shipped plan (``source=
    "artifacts"``) and, where its choice differs from the one this graph
    was optimized under, re-optimizes and drops every bucket graph
    captured under the other choice."""

    ARTIFACT_FORMAT = 1

    def __init__(self, pipeline: "Pipeline", validate=None, example=None, plan=None, device="cuda"):
        for op in pipeline.graph.operators.values():
            if isinstance(op, G.EstimatorOperator):
                raise TypeError(f"cannot freeze a pipeline with unfitted estimator {op.label()!r}; call fit() first")
        if _validate_requested(validate):
            from keystone_tpu_torch.analysis import validate_freeze

            validate_freeze(pipeline, example=example, device=device)
        self.device = resolve_device(device)
        #: the cost-based PhysicalPlan, or None: built or installed before
        #: the optimizer runs, so the planning rules (the fused-FV gate)
        #: read it; plain data, so it pickles with the applier
        self.plan = None
        if plan is not None and plan is not False:
            from keystone_tpu_torch import planner

            self.plan = planner.build_plan(pipeline, example=example, device=self.device) if plan is True else plan
            planner.install_plan(self.plan, source="freeze")
        self.source = pipeline.source
        self.sink = pipeline.sink
        #: the pre-optimizer pipeline: :meth:`fingerprint` hashes it (the
        #: optimized graph depends on the device it was frozen for)
        self._frozen_from = pipeline
        #: the verified bundle installed last (kept through pickling, so a
        #: replica clone captures its own graphs from it)
        self._bundle: Optional[dict] = None
        self._reset_graphs()
        self._optimize(pipeline)

    def _optimize(self, pipeline: "Pipeline") -> None:
        """Optimize ``pipeline``'s graph for the applier's device under the
        gates as they resolve now, recording the choices
        (:attr:`physical_choices`), and drop any bucket graph captured
        under an earlier optimization."""
        from keystone_tpu_torch.workflow.executor import _degradable
        from keystone_tpu_torch.workflow.optimizer import fused_fv_choice

        self.physical_choices = {"fused_fv": fused_fv_choice()}
        self.graph = PipelineEnv.get_optimizer().execute(pipeline.graph, device=self.device)
        #: True when a stage declares optional/with_fallback degradation
        self._degradable = any(_degradable(op) is not None for op in self.graph.operators.values())
        for key, fn in list(self._bucket_programs.items()):
            if isinstance(fn, _BucketGraph):
                self._bucket_programs[key] = _BucketGraph(self, fn.shape, fn.dtype)

    def _reset_graphs(self) -> None:
        """The per-process, per-replica graph state: bucket programs by
        (shape, dtype), their memory pool, the replay lock, and the event
        the last replay's output clone recorded."""
        #: (shape, dtype str) -> a callable of the padded batch
        self._bucket_programs: dict = {}
        self._graph_pool = None
        self._graph_lock = threading.Lock()
        self._graph_done = None

    def __getstate__(self):
        state = dict(self.__dict__)
        for k in ("_bucket_programs", "_graph_pool", "_graph_lock", "_graph_done"):
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("_frozen_from", None)
        self.__dict__.setdefault("_bundle", None)
        self.__dict__.setdefault("plan", None)
        self.__dict__.setdefault("physical_choices", {})
        self._reset_graphs()

    def __call__(self, data, deadline=None) -> Dataset:
        """Apply the frozen graph to one batch (a Dataset, or a tensor or
        array, which goes to the applier's device); returns the result
        Dataset.  ``deadline``: a wall-clock budget for this batch,
        apportioned per stage by the executor.

        A batch at an installed bucket's exact shape and dtype, on the
        applier's device, runs the bucket's program instead of the walk.
        Streams, host datasets and masked batches never do, nor does a
        deadline-carrying call on a pipeline that declares degradation
        (degrading needs stage boundaries), nor a deadline-carrying call
        whose bucket is not captured yet (a capture runs on the caller's
        thread, never under the watchdog).  Otherwise a deadline runs the
        replay under one whole-batch ``guard.run_with_deadline``
        (``site="serve.artifact"``): an overrun raises the walk's typed
        ``DeadlineExceeded`` and keeps the graph.  Any other failure of a
        bucket program drops it for good, counts
        ``serve.artifact_fallbacks``, and walks."""
        from keystone_tpu_torch.workflow.dataset import StreamDataset

        ds = as_dataset(data, device=self.device)
        if (self._bucket_programs and not isinstance(ds, StreamDataset) and not ds.is_host and ds.mask is None
                and (deadline is None or not self._degradable) and _on_device(ds.array, self.device)):
            key = (tuple(ds.array.shape), _dtype_name(ds.array.dtype))
            fn = self._bucket_programs.get(key)
            if fn is not None and (deadline is None or getattr(fn, "captured", True)):
                from keystone_tpu_torch.utils import guard

                try:
                    if deadline is None:
                        out = fn(ds.array)
                    else:
                        out = guard.run_with_deadline(lambda: fn(ds.array), guard.as_deadline(deadline),
                                                      site="serve.artifact")
                    return Dataset(out, n=ds.n)
                except guard.DeadlineExceeded:
                    # a timeout, not a broken program: the caller's
                    # deadline contract fires and the graph stays
                    raise
                except Exception as e:
                    # one failed program must not fail serving, nor be
                    # retried on every flush: drop it and walk
                    self._bucket_programs.pop(key, None)
                    from keystone_tpu_torch.obs import metrics

                    metrics.inc("serve.artifact_fallbacks")
                    logging.getLogger(__name__).warning(
                        "bucket graph %s failed (%s: %s); falling back to the executor walk", key,
                        type(e).__name__, e)
        return self._walk(ds, deadline)

    def _walk(self, ds: Dataset, deadline=None) -> Dataset:
        """The executor walk of the frozen graph over ``ds``."""
        g, _ = self.graph.replace_source_with_node(self.source, G.DatasetOperator(ds))
        expr = GraphExecutor(g, deadline=deadline).execute(g.sink_dependencies[self.sink])
        if not isinstance(expr, DatasetExpr):
            raise TypeError(f"frozen apply produced {type(expr).__name__}, expected dataset")
        return expr.dataset

    # ------------------------------------------------------ bucket graphs
    def fingerprint(self) -> str:
        """The pipeline signature a bundle is keyed by: structure and
        every fitted tensor's bytes of the pre-optimizer pipeline
        (``utils.hashing.pipeline_fingerprint``)."""
        if self._frozen_from is None:
            raise RuntimeError("this FrozenApplier lost its source pipeline; re-freeze it to use artifacts")
        from keystone_tpu_torch.utils.hashing import pipeline_fingerprint

        return pipeline_fingerprint(self._frozen_from)

    @staticmethod
    def _bucket_entry_key(rows: int) -> str:
        return f"b{int(rows):05d}"

    def export_artifacts(self, example=None, buckets=(8, 16, 32), item_shape=None, dtype=None) -> dict:
        """The artifact bundle ``{"manifest": {...}, "blobs": {entry:
        bytes}}`` for the padding ``buckets``, which the registry stores
        beside the model file (``serve/registry.py``).  The manifest
        keys the bucket graphs: format, torch and CUDA versions, the
        device's name and compute capability, each kernel source's hash
        (``kernels/build.py::source_hashes``), the signature
        (:meth:`fingerprint`), the item shape and dtype, and one entry per
        bucket; each entry's blob is its bucket's JSON spec.  Nothing is
        captured here: a graph holds device addresses, so each replica
        captures its own at install.  ``example``: one datum the item
        shape and dtype are read from; or pass ``item_shape``/``dtype``."""
        import json

        import numpy as np

        from keystone_tpu_torch.kernels.build import source_hashes

        if example is not None:
            ex = np.asarray(example)
            item_shape, dtype = tuple(ex.shape), ex.dtype
        if item_shape is None:
            raise ValueError("export_artifacts needs the per-item shape: pass example=<one datum> or item_shape=")
        dtype = np.dtype(dtype if dtype is not None else np.float32)
        buckets = sorted({int(b) for b in buckets})
        if not buckets or min(buckets) < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        blobs: dict = {}
        entries: dict = {}
        for b in buckets:
            key = self._bucket_entry_key(b)
            spec = {"rows": b, "item_shape": [int(d) for d in item_shape], "dtype": str(dtype)}
            blobs[key] = json.dumps(spec, sort_keys=True).encode()
            entries[key] = {"rows": b, "file": f"{key}.json"}
        manifest = {
            "format": FrozenApplier.ARTIFACT_FORMAT,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device": _device_info(self.device),
            "kernels": source_hashes(),
            "signature": self.fingerprint(),
            "item_shape": [int(d) for d in item_shape],
            "dtype": str(dtype),
            "buckets": buckets,
            "entries": entries,
        }
        if self.plan is not None:
            # the plan ships with the bundle: every install of it serves
            # the planned physical configuration
            manifest["plan"] = self.plan.to_dict()
        return {"manifest": manifest, "blobs": blobs}

    def install_artifacts(self, bundle, device=None, signature=None, strict: bool = False) -> int:
        """Verify an artifact bundle against this process and applier and
        register its bucket programs; returns how many were registered.

        Any mismatch rejects the whole bundle: format drift, torch or CUDA
        version skew, an applier not on a CUDA device ("backend skew": a
        CUDA graph needs the card), another compute capability, a changed
        kernel source, or signature drift.  A rejection is logged and
        counted as ``serve.artifact_fallbacks`` and the walk serves;
        ``strict=True`` raises :class:`ArtifactMismatch` instead.  A bucket
        whose blob is missing or does not match its entry is skipped and
        counted.  ``device``: the device the replica serves on (default:
        the applier's).  ``signature``: the expected fingerprint,
        precomputed by the caller (default: :meth:`fingerprint`, which
        reads every fitted tensor once)."""
        import json

        from keystone_tpu_torch.kernels.build import source_hashes
        from keystone_tpu_torch.obs import metrics

        log = logging.getLogger(__name__)

        def reject(why: str) -> int:
            if strict:
                raise ArtifactMismatch(why)
            metrics.inc("serve.artifact_fallbacks")
            log.warning("artifact bundle rejected (%s); the executor walk serves", why)
            return 0

        manifest = (bundle or {}).get("manifest") or {}
        blobs = (bundle or {}).get("blobs") or {}
        if manifest.get("format") != FrozenApplier.ARTIFACT_FORMAT:
            return reject(f"unknown artifact format {manifest.get('format')!r}")
        if manifest.get("plan") is not None:
            # a bundle of this pipeline carries its plan: reinstalled even
            # where the graphs are refused below (a CPU replica), since the
            # plan's knobs and gates hold on every backend
            self._install_shipped_plan(manifest, signature, strict)
        if manifest.get("torch_version") != torch.__version__:
            return reject(f"torch version skew (artifact {manifest.get('torch_version')}, running {torch.__version__})")
        if manifest.get("cuda_version") != torch.version.cuda:
            return reject(f"CUDA version skew (artifact {manifest.get('cuda_version')}, running {torch.version.cuda})")
        dev = self.device if device is None else torch.device(device)
        if dev.type != "cuda":
            return reject(f"backend skew (artifact for {(manifest.get('device') or {}).get('type')!r}, applier on "
                          f"{dev}: a CUDA graph needs a CUDA device)")
        want_dev = manifest.get("device") or {}
        here = _device_info(dev)
        if want_dev.get("capability") != here["capability"]:
            return reject(f"compute capability skew (artifact {want_dev.get('capability')} {want_dev.get('name')!r}, "
                          f"running {here['capability']} {here['name']!r})")
        if manifest.get("kernels") != source_hashes():
            return reject(f"kernel source skew (artifact {manifest.get('kernels')}, running {source_hashes()})")
        want = signature if signature is not None else self.fingerprint()
        if manifest.get("signature") != want:
            return reject(f"pipeline signature drift (artifact {manifest.get('signature')!r}, pipeline {want!r})")
        item_shape = tuple(int(d) for d in manifest.get("item_shape") or ())
        dtype = str(manifest.get("dtype") or "float32")
        installed = 0
        for key, ent in (manifest.get("entries") or {}).items():
            blob = blobs.get(key)
            if blob is None:
                continue  # the reader counted the unreadable file
            spec = {"rows": int(ent.get("rows", -1)), "item_shape": list(item_shape), "dtype": dtype}
            try:
                ok = json.loads(bytes(blob).decode()) == spec
            except (ValueError, UnicodeDecodeError):
                ok = False
            if not ok:
                if strict:
                    raise ArtifactMismatch(f"artifact {key} does not match its manifest entry")
                metrics.inc("serve.artifact_fallbacks")
                log.warning("artifact %s does not match its manifest entry; that bucket walks", key)
                continue
            shape = (spec["rows"],) + item_shape
            self._bucket_programs[(shape, dtype)] = _BucketGraph(self, shape, dtype)
            installed += 1
        self._bundle = bundle
        return installed

    def _install_shipped_plan(self, manifest: dict, signature, strict: bool) -> None:
        """Install the plan a bundle's manifest ships, if the bundle is this
        pipeline's (its signature matches), with ``source="artifacts"``;
        where the plan flips a gate this graph was optimized under,
        re-optimize (dropping the graphs captured under the old choice)."""
        from keystone_tpu_torch import planner
        from keystone_tpu_torch.workflow.optimizer import fused_fv_choice

        try:
            want = signature if signature is not None else self.fingerprint()
        except RuntimeError:
            return
        if manifest.get("signature") != want:
            return  # the ladder below rejects the bundle for it
        try:
            plan = planner.PhysicalPlan.from_dict(manifest["plan"])
        except Exception as e:
            if strict:
                raise ArtifactMismatch(f"shipped plan does not load: {e}") from e
            logging.getLogger(__name__).warning("shipped plan does not load (%s); the installed plan stays", e)
            return
        self.plan = plan
        planner.install_plan(plan, source="artifacts")
        if self._frozen_from is not None and fused_fv_choice() != self.physical_choices.get("fused_fv"):
            self._optimize(self._frozen_from)

    def add_bucket_program(self, shape, dtype) -> bool:
        """Register a bucket program for one more padding bucket (a bucket
        a live retune added) when the installed bundle covers its item
        shape and dtype; its graph is captured at its first call, which the
        service makes from ``prime``.  Returns whether one is registered."""
        man = (self._bundle or {}).get("manifest") or {}
        key = (tuple(int(d) for d in shape), _dtype_name(dtype))
        if key in self._bucket_programs:
            return True
        if (self.device.type != "cuda" or tuple(key[0][1:]) != tuple(int(d) for d in man.get("item_shape") or ())
                or key[1] != str(man.get("dtype") or "float32")):
            return False
        self._bucket_programs[key] = _BucketGraph(self, key[0], key[1])
        return True

    @property
    def installed_bundle(self) -> Optional[dict]:
        """The bundle :meth:`install_artifacts` accepted last (kept
        through pickling and deep copies), or None."""
        return self._bundle

    def has_bucket_program(self, shape, dtype) -> bool:
        return (tuple(shape), _dtype_name(dtype)) in self._bucket_programs

    def installed_buckets(self) -> int:
        """How many bucket programs this applier currently holds."""
        return len(self._bucket_programs)

    def graph_stats(self) -> dict:
        """Per bucket (rows): whether its graph is captured, its replays,
        the kernel launches recorded into it, and the bytes its capture
        reserved in the applier's memory pool."""
        out = {}
        for (shape, _dtype), fn in sorted(self._bucket_programs.items(), key=lambda kv: kv[0][0]):
            if isinstance(fn, _BucketGraph):
                out[shape[0]] = fn.stats()
        return out


def _on_device(t: torch.Tensor, dev: torch.device) -> bool:
    """Is ``t`` on ``dev`` (``cuda`` without an index: the current card)?"""
    if t.device.type != dev.type:
        return False
    if dev.type != "cuda":
        return True
    return t.device.index == (dev.index if dev.index is not None else torch.cuda.current_device())


def _dtype_name(dtype) -> str:
    """A torch or numpy dtype as numpy names it (``float32``, ``uint8``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    import numpy as np

    return np.dtype(dtype).name


def _device_info(dev: torch.device) -> dict:
    """The device keys of an artifact manifest."""
    if dev.type != "cuda":
        return {"type": dev.type, "name": dev.type, "capability": None}
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "capability": list(torch.cuda.get_device_capability(dev))}


class _BucketGraph:
    """One padding bucket's CUDA graph of a frozen applier's walk.

    The first call at the bucket's shape captures: the batch is copied
    into a static input, the walk runs once on the caller's stream (its
    kernels' first launches set their shared-memory attributes, and
    their caches fill), then a second walk over the static input is
    captured on the caller's stream (``capture_error_mode=
    "thread_local"``: another replica's allocations during the capture
    are its own business) into the applier's memory pool, after the
    caching allocator released its free blocks to the device (a capture
    cannot reclaim them); the first walk's output answers the call.  Later calls copy into the static
    input, replay, and clone the static output, all on the caller's
    stream, under the applier's replay lock and after the previous
    replay's clone (the applier's graphs share one pool).  The launches
    the capture recorded are added to ``utils.graphs.REPLAYED`` per
    replay; tensors the kernels read from their own caches are kept with
    the graph.  A walk with a host synchronization cannot be captured:
    the capture raises and the applier drops the program."""

    def __init__(self, applier: "FrozenApplier", shape, dtype: str):
        # weak: the applier holds its programs, and a retired replica's
        # graphs must free their pool with it, not at the next collection
        self._applier = weakref.ref(applier)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.graph = None
        self.static_in = None
        self.static_out = None
        self.launches = Counter()
        self.kept: list = []
        self.replays = 0
        self.pool_bytes = 0

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def stats(self) -> dict:
        return {"captured": self.captured, "replays": self.replays, "launches": dict(self.launches),
                "pool_bytes": self.pool_bytes}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            raise RuntimeError(f"a bucket graph replays on a CUDA device, not {x.device}")
        ap = self._applier()
        with ap._graph_lock:
            if self.graph is None:
                return self._capture(x)
            stream = torch.cuda.current_stream(x.device)
            if ap._graph_done is not None:
                stream.wait_event(ap._graph_done)
            self.static_in.copy_(x)
            self.graph.replay()
            out = self.static_out.clone()
            done = torch.cuda.Event()
            done.record(stream)
            ap._graph_done = done
            self.replays += 1
        graphs.add_replayed(self.launches)
        return out

    def _capture(self, x: torch.Tensor) -> torch.Tensor:
        ap = self._applier()
        dev = x.device
        stream = torch.cuda.current_stream(dev)
        rows = self.shape[0]
        with graphs.CAPTURE_LOCK:
            if ap._graph_done is not None:
                stream.wait_event(ap._graph_done)
            static_in = x.clone()
            warm = ap._walk(Dataset(static_in, n=rows))
            if warm.mask is not None or warm.is_host:
                raise TypeError("the frozen apply's output is not one plain tensor; a bucket graph cannot hold it")
            # capture on a side stream: the caller's, unless it is the
            # default stream (which cannot capture)
            cap = stream if stream != torch.cuda.default_stream(dev) else torch.cuda.Stream(dev)
            if cap is not stream:
                cap.wait_stream(stream)
            if ap._graph_pool is None:
                ap._graph_pool = torch.cuda.graph_pool_handle()
            # a capture allocates from its own pool and cannot take back
            # the caching allocator's free blocks mid-capture: release
            # them to the device first, as torch.cuda.graph does
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved(dev)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.stream(cap), graphs.recording() as rec:
                g.capture_begin(pool=ap._graph_pool, capture_error_mode="thread_local")
                try:
                    out = ap._walk(Dataset(static_in, n=rows))
                except BaseException:
                    try:
                        g.capture_end()
                    except RuntimeError:
                        pass  # the capture was invalidated by what raised
                    raise
                g.capture_end()
            if cap is not stream:
                stream.wait_stream(cap)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved0
        self.graph, self.static_in, self.static_out = g, static_in, out.array
        self.launches, self.kept = rec.launches, rec.kept
        return warm.array


class ArtifactMismatch(RuntimeError):
    """An artifact bundle does not match this process or pipeline (format,
    torch or CUDA version, device, kernel sources, or signature): raised
    only under ``install_artifacts(strict=True)``; the serving path counts
    the mismatch and walks instead."""


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
