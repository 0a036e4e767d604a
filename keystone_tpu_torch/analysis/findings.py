"""Typed findings: the one output schema every analyzer pass shares
(counterpart of ``keystone_tpu/analysis/findings.py``).

The reference's static guarantee is Scala's type system: a mis-wired
``Transformer`` chain does not compile.  The port replaces the compiler
with this schema: each pass (``analysis.shapes`` / ``precision`` /
``robustness`` / ``signatures`` / ``plan``) emits :class:`Finding`
records with a severity, a stable machine code and a graph location, and
:class:`AnalysisReport` aggregates them: renderable for the CLI,
raisable for ``Pipeline.fit(validate=)``, and overlaid on the DOT graph
(``workflow/viz.to_dot(findings=)``).

Severities:

- ``error``: the pipeline WILL misbehave (a mis-shaped stage, an unfitted
  estimator reference, a signature collision, bf16 reaching solver
  math).  ``AnalysisReport.raise_for_errors`` turns these into
  :class:`PipelineValidationError`; ``cli check`` exits non-zero.
- ``warning``: probably not what the author meant (a stage that narrows
  its dtype, an infeasible deadline budget, a mandatory stage under
  breaker supervision with no fallback).  Logged, never raised.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

SEVERITIES = ("error", "warning")

#: pass identifiers
PASS_SHAPES = "shapes"
PASS_PRECISION = "precision"
PASS_ROBUSTNESS = "robustness"
PASS_SIGNATURES = "signatures"
PASS_PLAN = "plan"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer observation, anchored to a graph location."""

    severity: str  # "error" | "warning"
    pass_id: str  # "shapes" | "precision" | "robustness" | "signatures"
    code: str  # stable kebab-case code, e.g. "shape-mismatch"
    message: str
    #: NodeId.id of the offending node (None = whole-graph finding)
    node: Optional[int] = None
    #: operator label at that node (for humans; labels can repeat)
    label: Optional[str] = None

    def location(self) -> str:
        if self.node is None:
            return "<graph>"
        if self.label:
            return f"n{self.node}[{self.label}]"
        return f"n{self.node}"

    def render(self) -> str:
        return (
            f"{self.severity.upper():7s} {self.pass_id}/{self.code} "
            f"at {self.location()}: {self.message}"
        )


class AnalysisReport:
    """Ordered findings from one :func:`~keystone_tpu_torch.analysis.analyze`
    run.  Errors first in :meth:`render`; insertion order otherwise."""

    def __init__(self, findings: Sequence[Finding] = ()):
        self.findings: List[Finding] = list(findings)

    # ------------------------------------------------------------ views
    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        """No errors (warnings do not fail a pre-flight)."""
        return not self.errors

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)

    def extend(self, findings: Sequence[Finding]) -> None:
        self.findings.extend(findings)

    # ----------------------------------------------------------- output
    def render(self) -> str:
        """Human-readable listing, errors first."""
        if not self.findings:
            return "analysis: no findings"
        lines = [
            f.render()
            for f in sorted(
                self.findings, key=lambda f: SEVERITIES.index(f.severity)
            )
        ]
        lines.append(
            f"analysis: {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s)"
        )
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "errors": len(self.errors),
            "warnings": len(self.warnings),
        }

    def raise_for_errors(self) -> None:
        """Raise :class:`PipelineValidationError` when any error-severity
        finding is present; warnings never raise."""
        if self.errors:
            raise PipelineValidationError(self)

    def __repr__(self):
        return (
            f"AnalysisReport(errors={len(self.errors)}, "
            f"warnings={len(self.warnings)})"
        )


class PipelineValidationError(ValueError):
    """The pre-flight analyzer found error-severity findings; the
    pipeline was refused before any device work.  Carries the full
    :class:`AnalysisReport` as ``.report``."""

    def __init__(self, report: AnalysisReport):
        self.report = report
        super().__init__(
            "pipeline failed static validation:\n" + report.render()
        )
