"""Pipeline visualization: Graph → Graphviz DOT (counterpart of
``keystone_tpu/workflow/viz.py``).

The reference exposes ``Pipeline.toDOT`` for debugging its DAGs; the same
here, and an optimizer's before and after are two calls.

Observability overlay: pass per-node ``timings`` (seconds) and/or
``retries`` keyed by node label (hand-built, or keys
``"{node_id}:{label}"``, or folded out of a run ledger with
:func:`ledger_overlay`), and nodes render with their measured time (and
retry count) under the label, shaded by their share of the total::

    timings, retries = ledger_overlay("/tmp/obs/run_abc.jsonl")
    dot = to_dot(pipe.graph, timings=timings, retries=retries)

Analyzer overlay: pass ``findings`` (``keystone_tpu_torch.analysis``
Finding records) and offending nodes fill red (error) or yellow (warning)
with their finding codes: ``python -m keystone_tpu_torch.cli check --dot
OUT`` writes exactly this.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from keystone_tpu_torch.workflow import graph as G


def ledger_overlay(ledger_path: str) -> Tuple[Dict[str, float], Dict[str, int]]:
    """(timings, retries) per node from a run-ledger JSONL file (the
    port's ledger has the reference's schema), by the shared
    ``obs.ledger.fold_stage_spans`` fold.  Unique labels key by bare
    label (matches any graph the caller overlays onto); duplicate
    labels key by ``"{node_id}:{label}"`` so two branches holding the
    same transformer type stay distinct instead of each displaying the
    merged total."""
    from collections import Counter

    from keystone_tpu_torch.obs.ledger import fold_stage_spans

    folded = fold_stage_spans(ledger_path)
    label_count = Counter(st["label"] for st in folded.values())
    timings: Dict[str, float] = {}
    retries: Dict[str, int] = {}
    for key, st in folded.items():
        k = st["label"] if label_count[st["label"]] == 1 else key
        timings[k] = st["seconds"]
        if st["retries"]:
            retries[k] = st["retries"]
    return timings, retries


def _lookup(overlay: Optional[dict], n, label: str):
    """Overlay value for a node: exact label, or a stage_timings-style
    ``"{node_id}:{label}"`` key."""
    if not overlay:
        return None
    if label in overlay:
        return overlay[label]
    return overlay.get(f"{n.id}:{label}")


#: analyzer-overlay fills: worst severity per node wins, and a finding
#: fill beats the timing shade (a broken node matters more than a slow
#: one)
_SEVERITY_FILL = {"error": "#ff9999", "warning": "#ffe680"}


def _findings_by_node(findings) -> Dict[int, list]:
    by_node: Dict[int, list] = {}
    for f in findings or ():
        if getattr(f, "node", None) is not None:
            by_node.setdefault(f.node, []).append(f)
    return by_node


def to_dot(
    graph: G.Graph,
    name: str = "pipeline",
    timings: Optional[Dict[str, float]] = None,
    retries: Optional[Dict[str, int]] = None,
    findings=None,
) -> str:
    """``findings``: analyzer Finding records (or an AnalysisReport):
    offending nodes fill red (error) / yellow (warning) with their
    finding codes under the label, and graph-level findings render as a
    standalone note node.  ``cli check --dot`` writes this overlay."""
    findings = list(findings) if findings is not None else []
    by_node = _findings_by_node(findings)
    lines = [f"digraph {name} {{", "  rankdir=LR;", "  node [shape=box, fontsize=10];"]
    total = sum(timings.values()) if timings else 0.0
    for s in graph.sources:
        lines.append(f'  "{s!r}" [shape=ellipse, label="source {s.id}"];')
    for n in graph.topological_nodes():
        op = graph.operators[n]
        shape = {
            G.DatasetOperator: "cylinder",
            G.DatumOperator: "cylinder",
            G.EstimatorOperator: "house",
        }.get(type(op), "box")
        label = op.label().replace('"', "'")
        extra = ""
        seconds = _lookup(timings, n, op.label())
        nretries = _lookup(retries, n, op.label())
        annot = []
        if seconds is not None:
            annot.append(f"{seconds:.3f}s")
        if nretries:
            annot.append(f"x{int(nretries)} retries")
        if annot:
            label = label + "\\n" + " ".join(annot)
        if seconds is not None and total > 0:
            # share-of-total shading: the hot path jumps out of the graph
            share = min(1.0, seconds / total)
            extra = (
                ', style=filled, fillcolor="0.08 %0.2f 1.0"' % (0.1 + 0.8 * share)
            )
        node_findings = by_node.get(n.id)
        if node_findings:
            worst = (
                "error"
                if any(f.severity == "error" for f in node_findings)
                else "warning"
            )
            codes = sorted({f.code for f in node_findings})
            label = label + "\\n" + " ".join(codes[:3])
            extra = f', style=filled, fillcolor="{_SEVERITY_FILL[worst]}"'
        lines.append(f'  "{n!r}" [shape={shape}, label="{label}"{extra}];')
        for d in graph.dependencies[n]:
            lines.append(f'  "{d!r}" -> "{n!r}";')
    for k, d in graph.sink_dependencies.items():
        lines.append(f'  "{k!r}" [shape=ellipse, label="sink {k.id}"];')
        lines.append(f'  "{d!r}" -> "{k!r}";')
    graph_level = [f for f in findings if getattr(f, "node", None) is None]
    if graph_level:
        worst = (
            "error"
            if any(f.severity == "error" for f in graph_level)
            else "warning"
        )
        codes = sorted({f.code for f in graph_level})
        note = "analysis: " + " ".join(codes[:4])
        lines.append(
            f'  "analysis_findings" [shape=note, label="{note}", '
            f'style=filled, fillcolor="{_SEVERITY_FILL[worst]}"];'
        )
    lines.append("}")
    return "\n".join(lines)
