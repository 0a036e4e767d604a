"""Analyzer pass ``plan``: audit the installed physical plan against the
graph it is about to serve (counterpart of
``keystone_tpu/analysis/plan.py``).

The cost-based planner (``keystone_tpu_torch.planner``) pins operator
variants and serving knobs at ``freeze()``; this pass catches the two ways
a shipped plan goes wrong later:

- ``stale-plan``: the plan's stage signatures no longer match the graph
  (a stage was swapped, the widths changed, or another pipeline's plan
  was installed).  The stage signature leaves the weights out
  (``planner/plan.py::stage_signature``), so a re-fit or a save and load
  of the same architecture is not stale.  Dispatch sites fall back to the
  static defaults for unmatched stages, so this is a *warning*;
- ``bad-plan-candidate``: the plan names a gate, winner or knob the
  registry rejects on this backend (a card's ``kernel`` winner on a CPU
  host, a hand-edited ``plan.json``).  Also a warning: ``planned_gate``
  re-validates at dispatch.

With no plan installed (and none passed) the pass is inert.
"""

from __future__ import annotations

from typing import List, Optional

from keystone_tpu_torch.analysis.findings import PASS_PLAN, Finding


def run(graph, pipeline=None, plan=None) -> List[Finding]:
    """Audit ``plan`` (default: the process-installed plan) against
    ``graph``.  ``pipeline`` (optional) enables the whole-pipeline
    signature check for the matmul stage."""
    from keystone_tpu_torch.planner import registry

    if plan is None:
        plan = registry.current_plan()
    if plan is None:
        return []

    findings: List[Finding] = []

    # graph-independent: gates, winners, knobs vs the registry tables
    for code, msg in plan.validate(backend=registry.current_backend()):
        findings.append(
            Finding(
                severity="warning",
                pass_id=PASS_PLAN,
                code=code,
                message=msg,
            )
        )

    # graph-dependent: every per-stage choice must anchor to a stage
    # that is actually in this graph
    sigs, labels = _graph_signatures(graph)
    psig = _pipeline_signature(pipeline)
    for s in plan.stages:
        if s.signature.startswith("pipeline"):
            # the whole-pipeline matmul stage: compare fingerprints
            if (
                psig
                and plan.pipeline_signature
                and plan.pipeline_signature != psig
            ):
                findings.append(
                    Finding(
                        severity="warning",
                        pass_id=PASS_PLAN,
                        code="stale-plan",
                        message=(
                            f"plan was sampled on pipeline "
                            f"{plan.pipeline_signature[:12]} but this "
                            f"pipeline fingerprints as {psig[:12]}; "
                            f"re-plan at freeze()"
                        ),
                    )
                )
            continue
        if s.signature not in sigs:
            hint = ""
            if s.label in labels:
                hint = (
                    f" (a {s.label!r} stage exists but its parameters "
                    f"changed since sampling)"
                )
            findings.append(
                Finding(
                    severity="warning",
                    pass_id=PASS_PLAN,
                    code="stale-plan",
                    message=(
                        f"plan stage {s.label!r} [{s.signature}] for gate "
                        f"{s.gate!r} is not in this graph{hint}; the "
                        f"static default serves it"
                    ),
                )
            )
    return findings


def _graph_signatures(graph):
    """(signatures, labels) of every transformer-backed node — the
    anchor set plan stages must land in."""
    from keystone_tpu_torch.planner.plan import stage_signature

    sigs, labels = set(), set()
    for node in getattr(graph, "operators", {}):
        op = graph.operators.get(node)
        t = getattr(op, "transformer", None)
        if t is None:
            continue
        try:
            sigs.add(stage_signature(t))
            labels.add(type(t).__name__)
        except Exception:
            continue
    return sigs, labels


def _pipeline_signature(pipeline) -> Optional[str]:
    if pipeline is None:
        return None
    try:
        from keystone_tpu_torch.utils.hashing import pipeline_fingerprint

        return pipeline_fingerprint(pipeline)
    except Exception:
        return None
