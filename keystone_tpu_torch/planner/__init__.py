"""Cost-based physical planning (counterpart of ``keystone_tpu/planner``;
KeystoneML ICDE 2017 §4).

``registry``  every physical gate and serving knob, one precedence:
              explicit arg > env override > installed plan > default.
``plan``      the plain-data :class:`PhysicalPlan` that ships with the
              model (artifact manifest, registry, pickled applier).
``cost``      the freeze-time sampling cost model (:func:`build_plan`).
``tuner``     the live :class:`PlanTuner` (telemetry-driven knob retunes
              under the bake-and-rollback discipline); imported on first
              use, as it reads the serving package.
"""

from keystone_tpu_torch.planner.cost import build_plan
from keystone_tpu_torch.planner.plan import CandidateCost, PhysicalPlan, StageChoice, stage_signature
from keystone_tpu_torch.planner.registry import (
    GATES,
    KNOBS,
    clear_plan,
    current_plan,
    install_plan,
    plan_status,
    planned_gate,
    planned_knob,
)

__all__ = [
    "GATES",
    "KNOBS",
    "CandidateCost",
    "PhysicalPlan",
    "PlanTuner",
    "StageChoice",
    "build_plan",
    "clear_plan",
    "current_plan",
    "install_plan",
    "plan_status",
    "planned_gate",
    "planned_knob",
    "stage_signature",
]


def __getattr__(name):
    if name == "PlanTuner":
        from keystone_tpu_torch.planner.tuner import PlanTuner

        return PlanTuner
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
