"""The pre-flight pipeline analyzer: orchestration and wiring helpers
(counterpart of ``keystone_tpu/analysis/analyzer.py``).

:func:`analyze` walks a pipeline's graph with the requested passes and
returns an :class:`~keystone_tpu_torch.analysis.findings.AnalysisReport`:

- ``shapes``: abstract shape and dtype interpretation on fake tensors
  (pass a);
- ``robustness``: the fault-plan, breaker and deadline configuration (c);
- ``signatures``: the CSE and cache-signature collision audit (d);
- ``precision``: the solvers' contractions under each precision mode (b;
  graph-independent, and the only pass that runs solver code, on small
  CPU tensors, so it is not in the default set: ``cli check`` adds it);
- ``plan``: the installed physical plan's audit (``stale-plan``,
  ``bad-plan-candidate``; inert with no plan installed, so it rides
  ``validate_freeze`` and ``cli check`` but not the fit's default set).

Entry points of the framework's wiring:

- ``Pipeline.fit(validate=)`` / ``KEYSTONE_VALIDATE=1`` →
  :func:`validate_fit` (the cheap default passes; raises
  :class:`PipelineValidationError` on errors, logs warnings);
- ``Pipeline.freeze(validate=)`` → :func:`validate_freeze`
  (``mode="apply"``: unfitted estimators are errors);
- ``python -m keystone_tpu_torch.cli check`` → :func:`analyze` with every
  pass and the DOT overlay.

With validation off (the default) the fit and freeze paths never import
this package.  No pass launches a kernel or allocates device memory.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import torch

from keystone_tpu_torch.analysis import robustness as _robustness
from keystone_tpu_torch.analysis import shapes as _shapes
from keystone_tpu_torch.analysis import signatures as _signatures
from keystone_tpu_torch.analysis.findings import AnalysisReport
from keystone_tpu_torch.workflow import graph as G

logger = logging.getLogger(__name__)

ENV_VALIDATE = "KEYSTONE_VALIDATE"

#: the cheap pre-flight set (no solver runs, no device work beyond a CPU
#: stream's peek or a deadline's cost estimate)
DEFAULT_PASSES = ("shapes", "robustness", "signatures")
ALL_PASSES = DEFAULT_PASSES + ("precision", "plan")


def validation_enabled(explicit: Optional[bool] = None) -> bool:
    """Resolve a ``validate=`` parameter: explicit wins; None reads
    ``KEYSTONE_VALIDATE`` ("1" is on)."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get(ENV_VALIDATE, "0") == "1"


def _graph_device(graph: G.Graph) -> torch.device:
    """Where the graph's fitted tensors live (the device a shape-only
    example is assumed on): the first one found, else the CPU."""
    from keystone_tpu_torch.utils.hashing import fitted_tensors

    found: list = []
    for n in graph.topological_nodes():
        t = getattr(graph.operators[n], "transformer", None)
        if t is not None:
            fitted_tensors(t, found.append)
            if found:
                return found[0].device
    return torch.device("cpu")


def _as_graph_and_sources(pipeline, example, device):
    """(graph, {SourceId: abstract}) from a Pipeline or a raw Graph."""
    graph = pipeline if isinstance(pipeline, G.Graph) else pipeline.graph
    srcs: Dict = {}
    if example is not None:
        src = graph.sources[0] if isinstance(pipeline, G.Graph) and graph.sources else getattr(pipeline, "source",
                                                                                                None)
        if src is not None:
            srcs[src] = _shapes.source_abstract(example, device if device is not None else _graph_device(graph))
    return graph, srcs


def analyze(pipeline, example=None, deadline=None, passes: Sequence[str] = DEFAULT_PASSES, mode: str = "fit",
            plan_text=_robustness._UNSET, breaker_threshold=_robustness._UNSET, device=None) -> AnalysisReport:
    """Run the requested passes over ``pipeline`` (a Pipeline or a raw
    Graph).

    ``example`` seeds the open source for the shape walk: a Dataset, a
    batch tensor or array, a ``shapes.Aval``, or a per-item shape tuple
    (on ``device``, default: where the graph's fitted tensors live).
    ``deadline`` (seconds or a ``guard.Deadline``) enables the deadline
    feasibility estimate.  ``mode="apply"`` makes remaining estimators
    errors (the freeze and serve contract)."""
    graph, sources = _as_graph_and_sources(pipeline, example, device)
    report = AnalysisReport()
    for p in passes:
        if p == "shapes":
            report.extend(_shapes.run(graph, sources, mode=mode))
        elif p == "robustness":
            report.extend(_robustness.run(graph, deadline=deadline, plan_text=plan_text,
                                          breaker_threshold=breaker_threshold))
        elif p == "signatures":
            report.extend(_signatures.run(graph))
        elif p == "precision":
            from keystone_tpu_torch.analysis import precision as _precision

            report.extend(_precision.run())
        elif p == "plan":
            from keystone_tpu_torch.analysis import plan as _plan

            report.extend(_plan.run(graph, pipeline=None if isinstance(pipeline, G.Graph) else pipeline))
        else:
            raise ValueError(f"unknown analyzer pass {p!r}; known: {ALL_PASSES}")
    return report


def _log_warnings(report: AnalysisReport, what: str) -> None:
    for f in report.warnings:
        logger.warning("pre-flight %s: %s", what, f.render())


def validate_fit(pipeline, deadline=None, example=None) -> AnalysisReport:
    """The ``Pipeline.fit(validate=)`` pre-flight: the default passes;
    errors raise :class:`PipelineValidationError`, warnings log."""
    report = analyze(pipeline, example=example, deadline=deadline, passes=DEFAULT_PASSES)
    _log_warnings(report, "fit")
    report.raise_for_errors()
    return report


def validate_freeze(pipeline, example=None, device=None) -> AnalysisReport:
    """The ``Pipeline.freeze(validate=)`` pre-flight: apply-mode analysis
    (unfitted estimators are errors) before anything is primed, with the
    ``plan`` pass (a frozen pipeline is about to serve, so a stale or
    backend-mismatched installed plan is worth a warning here)."""
    report = analyze(pipeline, example=example, passes=DEFAULT_PASSES + ("plan",), mode="apply",
                     device=None if device is None else torch.device(device))
    _log_warnings(report, "freeze")
    report.raise_for_errors()
    return report
