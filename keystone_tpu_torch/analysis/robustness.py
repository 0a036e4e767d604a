"""Pass (c): the robustness lint: fault plans, breakers, deadline budgets
(counterpart of ``keystone_tpu/analysis/robustness.py``).

The operations layer gives the port named fault sites, per-node circuit
breakers and deadline apportionment; this pass checks their
*configuration* before a fit spends minutes discovering it:

- ``bad-fault-plan`` (error): the active ``KEYSTONE_FAULTS`` plan (or a
  plan the caller passes) names a site that matches no registered site
  (``faults.SITES``), or fails to parse: a typo'd site never fires;
- ``mandatory-under-breaker`` (warning): breaker supervision is on
  (``KEYSTONE_BREAKER_THRESHOLD``) but mandatory stages (no
  ``optional=True``, no ``with_fallback``) are in the graph: one open
  breaker fails the whole run.  Emitted once, listing the labels;
- ``deadline-infeasible`` / ``stage-deadline-infeasible`` (warnings): the
  requested deadline (or the ``KEYSTONE_STAGE_DEADLINE`` per-stage cap)
  is below the cache rule's cost estimates for the graph
  (``workflow/profiling.profile_graph`` with ``static_cost=True``: on
  fake tensors where a stage runs on them, sampled otherwise).  The
  estimate samples stages (real work on 16 rows), so it runs only when
  the caller supplies a deadline.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

from keystone_tpu_torch.analysis.findings import PASS_ROBUSTNESS, Finding
from keystone_tpu_torch.workflow import graph as G

logger = logging.getLogger(__name__)

_UNSET = object()


def run(
    graph: G.Graph,
    deadline=None,
    plan_text=_UNSET,
    breaker_threshold=_UNSET,
    estimate_costs: Optional[bool] = None,
) -> List[Finding]:
    findings: List[Finding] = []
    findings.extend(_check_fault_plan(plan_text))
    findings.extend(_check_breakers(graph, breaker_threshold))
    if estimate_costs is None:
        estimate_costs = deadline is not None
    if estimate_costs and deadline is not None:
        findings.extend(_check_deadline(graph, deadline))
    return findings


def _check_fault_plan(plan_text) -> List[Finding]:
    from keystone_tpu_torch import faults

    if plan_text is _UNSET:
        plan_text = os.environ.get(faults.ENV_VAR)
    if not plan_text:
        return []
    try:
        plan = (
            plan_text
            if isinstance(plan_text, faults.FaultPlan)
            else faults.parse_plan(plan_text)
        )
        faults.validate_plan(plan)
    except faults.FaultPlanError as e:
        return [
            Finding(
                "error",
                PASS_ROBUSTNESS,
                "bad-fault-plan",
                f"active fault plan is invalid: {e}",
            )
        ]
    return []


def _check_breakers(graph: G.Graph, breaker_threshold) -> List[Finding]:
    from keystone_tpu_torch.utils import guard
    from keystone_tpu_torch.workflow.executor import _degradable

    if breaker_threshold is _UNSET:
        breaker_threshold = guard.stage_breaker_threshold()
    if breaker_threshold is None:
        return []
    mandatory = []
    for n in graph.topological_nodes():
        op = graph.operators[n]
        if not isinstance(op, G.TransformerOperator):
            continue
        from keystone_tpu_torch.workflow.transformer import Cacher

        if isinstance(op.transformer, Cacher):
            continue
        if _degradable(op) is None:
            mandatory.append(op.label())
    if not mandatory:
        return []
    shown = ", ".join(mandatory[:8]) + ("…" if len(mandatory) > 8 else "")
    return [
        Finding(
            "warning",
            PASS_ROBUSTNESS,
            "mandatory-under-breaker",
            f"breaker supervision is on (threshold="
            f"{breaker_threshold}) but {len(mandatory)} stage(s) declare "
            f"no optional=True/with_fallback degradation ({shown}); an "
            "open breaker fails the whole run (CircuitOpenError)",
        )
    ]


def _check_deadline(graph: G.Graph, deadline) -> List[Finding]:
    from keystone_tpu_torch.utils import guard
    from keystone_tpu_torch.workflow import profiling

    dl = guard.as_deadline(deadline)
    findings: List[Finding] = []
    try:
        profiles = profiling.profile_graph(graph, sample_size=16, static_cost=True)
    except Exception as e:  # cost estimation is best-effort, like the rule
        logger.debug("deadline feasibility profiling failed: %s", e)
        return findings
    if not profiles:
        return findings
    total = sum(p.full_seconds for p in profiles.values())
    remaining = dl.remaining()
    if total > remaining:
        findings.append(
            Finding(
                "warning",
                PASS_ROBUSTNESS,
                "deadline-infeasible",
                f"deadline budget {remaining:.2f}s is below the "
                f"estimated stage cost {total:.2f}s "
                "(ProfilingAutoCacheRule estimates; transformer stages "
                "only — estimator fits ride on top): the run is "
                "configured to be killed by its own watchdog",
            )
        )
    stage_cap = guard.stage_deadline_seconds()
    if stage_cap is not None:
        worst_n, worst = max(
            profiles.items(), key=lambda kv: kv[1].full_seconds
        )
        if worst.full_seconds > stage_cap:
            op = graph.operators.get(worst_n)
            findings.append(
                Finding(
                    "warning",
                    PASS_ROBUSTNESS,
                    "stage-deadline-infeasible",
                    f"KEYSTONE_STAGE_DEADLINE={stage_cap:g}s is below "
                    f"the estimated {worst.full_seconds:.2f}s of the "
                    "most expensive stage",
                    node=worst_n.id,
                    label=None if op is None else op.label(),
                )
            )
    return findings
