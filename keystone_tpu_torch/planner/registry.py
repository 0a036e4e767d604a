"""The physical-choice registry: every gate and knob, one precedence
(counterpart of ``keystone_tpu/planner/registry.py``).

KeystoneML's optimizer (ICDE 2017 §4) chooses a physical implementation
for each logical stage from sampled cost models.  This module is the one
literal registry of every gate (a named physical choice with enumerated
candidates) and every knob (a named numeric serving parameter with
validated bounds), plus the process-global installed
:class:`~keystone_tpu_torch.planner.plan.PhysicalPlan` that dispatch
sites consult.

Resolution precedence at every dispatch site:

    explicit argument  >  env override  >  installed plan  >  static default

With no plan installed and no env set, every site resolves to its static
default through the same code path it took before the planner existed.

**The gates on the card.**  The reference's candidates name its TPU
implementations; the port's name what runs on an H100.  The mapping:

- ``fused_fv``: the reference's ``pallas`` (the fused Pallas forward) is
  the port's ``kernel`` (``FvFusionRule`` fires: the fused CUDA kernel
  B1, ``csrc/fisher.cu::fv_fused_kernel``); its ``xla`` (the per-stage
  chain) is the port's ``chain`` (``PCATransformer`` then
  ``FisherVector``, which launches B2 on a CUDA tensor).  Both are
  hand-written kernels on the card, so the cost model samples both
  there; on the CPU only ``chain`` runs.
- ``gram_pallas``: the reference's ``pallas`` is the port's ``kernel``
  (B3/B4, ``csrc/gram.cu``), its ``xla`` the port's ``plain``
  (``gram_block_ref``).  The port runs no plain version on a card path:
  its wrappers launch the kernel for every CUDA tensor and the plain
  version for every CPU tensor (``ops/gram_kernels.py``), so each backend
  has one candidate and the gate is pinned there, not sampled, as the
  reference pins ``matmul`` off the TPU.  No env var overrides it.
- ``matmul``: the same names, less the reference's ``bf16_apply``
  (the port's apply side is always f32, ``utils/precision.apply_mode``).
  The stage is the record of the whole forward's cost curve, from which
  the serving knobs are derived.  No dispatch site reads it: the port's
  precision mode (``utils/precision.matmul_mode``) is never planned, so a
  plan never changes numerics; ``KEYSTONE_MATMUL`` sets that mode at
  import and is operational configuration here, not the gate's override.  ``bf16`` stays a candidate for the
  schema's sake and is ``unsupported`` on every backend: the analysis
  ``plan`` pass flags a shipped plan that picked it.

``cuda_only`` lists the candidates only a CUDA device runs,
``cpu_only`` those only the CPU runs (where the reference has
``tpu_only``) and ``unsupported`` those no backend of the port runs: the
cost model never samples a candidate the backend cannot run, and the
analysis ``plan`` pass flags a shipped plan that picked one.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

#: Physical-choice gates.  ``kind`` decides how the env override is
#: decoded: ``switch`` gates read "0" as the fallback candidate and any
#: other set value as the preferred one; ``mode`` gates read the env value
#: as a candidate name.  The first candidate is the static default.
GATES = {
    "fused_fv": {
        "env": "KEYSTONE_FUSED_FV",
        "kind": "switch",
        "candidates": ("kernel", "chain"),
        "cuda_only": ("kernel",),
        "doc": "PCA->FisherVector forward: the fused CUDA kernel (B1) vs the per-stage chain, PCA then the "
               "FV encode kernel (B2) (workflow/optimizer.FvFusionRule)",
    },
    "gram_pallas": {
        "env": None,
        "kind": "switch",
        "candidates": ("kernel", "plain"),
        "cuda_only": ("kernel",),
        "cpu_only": ("plain",),
        "doc": "kernel gram blocks: the CUDA tile kernels (B3/B4) on the card, the plain chain on the CPU "
               "(ops/gram_kernels.gram_block): pinned on either backend",
    },
    "matmul": {
        "env": None,
        "kind": "mode",
        "candidates": ("auto", "f32", "bf16"),
        "unsupported": ("bf16",),
        "doc": "the whole forward's cost curve, the serving knobs' source; no dispatch site reads it (the port's "
               "precision mode, utils/precision.matmul_mode, is never planned)",
    },
}

#: Serving knobs a plan may carry, with the bounds the analysis ``plan``
#: pass and the PlanTuner enforce.
KNOBS = {
    "buckets": {
        "env": None,
        "kind": "int_tuple",
        "min": 1,
        "max": 65536,
        "doc": "padding-bucket sizes (serve/service.default_buckets)",
    },
    "max_wait_ms": {
        "env": None,
        "kind": "float",
        "min": 0.0,
        "max": 1000.0,
        "doc": "micro-batch flush wait (PipelineService)",
    },
    "dispatch_window": {
        "env": None,
        "kind": "int",
        "min": 1,
        "max": 64,
        "doc": "per-replica outstanding-flush window (fleet.set_window)",
    },
    "hedge_ms": {
        "env": None,
        "kind": "float",
        "min": 0.0,
        "max": 60000.0,
        "doc": "straggler hedge delay (PipelineService hedge_ms)",
    },
    "pool_budget_bytes": {
        "env": "KEYSTONE_POOL_BUDGET_BYTES",
        "kind": "int",
        "min": 1 << 20,
        "max": 1 << 40,
        "doc": "shared stage pool budget (workflow/profiling.pool_budget_bytes)",
    },
}

#: ``KEYSTONE_*`` env vars that select no physical implementation or
#: plan-managed knob: operational, debug or test configuration.
OPERATIONAL_ENV = {
    "KEYSTONE_APPLY_CHUNK",
    "KEYSTONE_AUTO_SPILL",
    "KEYSTONE_BREAKER_RESET",
    "KEYSTONE_BREAKER_THRESHOLD",
    "KEYSTONE_CACHE_PROFILE_ALL",
    "KEYSTONE_FAULTS",
    "KEYSTONE_HANG_SECONDS",
    "KEYSTONE_HBM_BUDGET_BYTES",
    "KEYSTONE_HOST_WORKERS",
    "KEYSTONE_IO_RETRIES",
    "KEYSTONE_MATMUL",
    "KEYSTONE_METRICS",
    "KEYSTONE_OBS_DIR",
    "KEYSTONE_OBS_KEEP_SEGMENTS",
    "KEYSTONE_OBS_MAX_BYTES",
    "KEYSTONE_OC_PREFETCH",
    "KEYSTONE_OOC_FRACTION",
    "KEYSTONE_SOLVER_PRECISION",  # correctness-critical: never planned
    "KEYSTONE_SPILL_BATCH",
    "KEYSTONE_STAGE_DEADLINE",
    "KEYSTONE_STAGE_RETRIES",
    "KEYSTONE_STATE_DIR",
    "KEYSTONE_STREAM_TIMEOUT",
    "KEYSTONE_VALIDATE",
    "KEYSTONE_VERIFY_BLOCKS",
}


# ------------------------------------------------------------- installed plan

_LOCK = threading.Lock()
_PLAN = None  # the installed PhysicalPlan (None: no plan, the static path)
_PLAN_SOURCE: Optional[str] = None
#: the cost model's forcing stack: sampling forces a candidate ABOVE env
#: and plan (it must measure the candidate it asked for)
_FORCED: list = []


def install_plan(plan, source: str = "install") -> None:
    """Install ``plan`` as the process plan (every dispatch site's third
    precedence tier); emits a ``plan.install`` ledger event, so a swapped
    or healed replica's plan provenance is auditable."""
    global _PLAN, _PLAN_SOURCE
    with _LOCK:
        _PLAN = plan
        _PLAN_SOURCE = source
    try:
        from keystone_tpu_torch.obs import ledger

        ledger.event("plan.install", source=source, version=None if plan is None else plan.fingerprint(),
                     stages=0 if plan is None else len(plan.stages))
    except Exception:
        pass


def clear_plan() -> None:
    """Remove the installed plan (the static path)."""
    global _PLAN, _PLAN_SOURCE
    with _LOCK:
        _PLAN = None
        _PLAN_SOURCE = None


def current_plan():
    return _PLAN


def plan_status() -> Optional[dict]:
    """Compact ``/statusz`` section: None when no plan is installed."""
    plan = _PLAN
    if plan is None:
        return None
    return {
        "fingerprint": plan.fingerprint(),
        "source": _PLAN_SOURCE,
        "backend": plan.backend,
        "stages": len(plan.stages),
        "choices": {s.gate: s.winner for s in plan.stages},
        "knobs": dict(plan.knobs),
    }


@contextmanager
def forced(gate: str, candidate: str):
    """Force ``gate`` to ``candidate`` for the block: the cost model's
    sampling lever, resolving above every other tier."""
    if gate not in GATES:
        raise KeyError(f"unknown gate {gate!r}; registered: {sorted(GATES)}")
    if candidate not in GATES[gate]["candidates"]:
        raise ValueError(f"{candidate!r} is not a candidate of gate {gate!r}: {GATES[gate]['candidates']}")
    entry = (gate, candidate)
    with _LOCK:
        _FORCED.append(entry)
    try:
        yield
    finally:
        with _LOCK:
            _FORCED.remove(entry)


def forced_gate(name: str) -> Optional[str]:
    """Innermost forced candidate for ``name``, or None (lock-free: a
    ``tuple()`` snapshot of the list is atomic under the GIL)."""
    for gate, cand in reversed(tuple(_FORCED)):
        if gate == name:
            return cand
    return None


def planned_gate(name: str) -> Optional[str]:
    """The candidate forced or picked by the installed plan for ``name``:
    the *forced > plan* slice of the ladder (the dispatch sites keep their
    explicit-argument and env tiers in their own code).  None when nothing
    applies."""
    cand = forced_gate(name)
    if cand is not None:
        return cand
    plan = _PLAN
    if plan is None:
        return None
    cand = plan.choice_for(name)
    if cand is not None and cand not in GATES[name]["candidates"]:
        return None  # a corrupt or foreign plan never forces a bad dispatch
    return cand


def planned_knob(name: str):
    """The installed plan's value for knob ``name``, validated against the
    registry bounds; None when no plan carries it."""
    plan = _PLAN
    if plan is None:
        return None
    if name not in KNOBS:
        raise KeyError(f"unknown knob {name!r}; registered: {sorted(KNOBS)}")
    value = plan.knobs.get(name)
    if value is None:
        return None
    ok, coerced, _why = validate_knob(name, value)
    return coerced if ok else None


def validate_knob(name: str, value):
    """``(ok, coerced, why)``: the one bounds check the plan builder, the
    analysis ``plan`` pass and the PlanTuner all use."""
    spec = KNOBS.get(name)
    if spec is None:
        return False, None, f"unknown knob {name!r}"
    lo, hi = spec["min"], spec["max"]
    kind = spec["kind"]
    try:
        if kind == "int_tuple":
            vals = tuple(int(v) for v in value)
            if not vals:
                return False, None, "empty bucket set"
            if any(v < lo or v > hi for v in vals):
                return False, None, f"bucket outside [{lo}, {hi}]: {vals}"
            return True, tuple(sorted(set(vals))), ""
        v = int(value) if kind == "int" else float(value)
    except (TypeError, ValueError):
        return False, None, f"{name}={value!r} is not {kind}"
    if v < lo or v > hi:
        return False, None, f"{name}={v} outside [{lo}, {hi}]"
    return True, v, ""


def supported_candidates(gate: str, backend: Optional[str] = None):
    """The candidates of ``gate`` that the current (or named) backend can
    run: what the cost model samples and what the analysis pass accepts
    in a shipped plan."""
    spec = GATES[gate]
    if backend is None:
        backend = current_backend()
    drop = set(spec.get("cpu_only", ())) if backend == "cuda" else set(spec.get("cuda_only", ()))
    drop |= set(spec.get("unsupported", ()))
    return tuple(c for c in spec["candidates"] if c not in drop)


def current_backend() -> str:
    """``"cuda"`` when torch sees a CUDA device, else ``"cpu"``."""
    try:
        import torch

        return "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:
        return "cpu"


def gate_env_names():
    """Every variable registered as a gate's or a knob's override (the
    lint rule's allowed set, beside ``OPERATIONAL_ENV``)."""
    names = {g["env"] for g in GATES.values() if g.get("env")}
    names |= {k["env"] for k in KNOBS.values() if k.get("env")}
    return names
