"""The ``PhysicalPlan``: plain data, shipped with the model (counterpart
of ``keystone_tpu/planner/plan.py``, the same JSON schema and
``PLAN_FORMAT``).

The plan is the durable output of the cost model: per-stage physical
candidates with their sampled costs and fitted curves, the chosen winner
(with why), and the serving knobs.  It is plain data (dicts, lists,
strings, numbers), so it JSON-round-trips into the artifact manifest
(``FrozenApplier.export_artifacts``, ``ModelRegistry.publish``), survives
applier pickling (replica clones, process-worker spawns) and renders for
humans (``cli plan``).

Stage identity is a **stage signature** (:func:`stage_signature`).  The
analysis ``plan`` pass recomputes signatures over a live graph and flags a
plan whose signatures no longer match (``stale-plan``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Optional, Tuple

PLAN_FORMAT = 1


def stage_signature(transformer) -> str:
    """Stable short identity of one pipeline stage: its type name, the
    process-stable repr of its ``params()`` and the shape and dtype of
    each fitted tensor it holds (``utils.hashing.fitted_tensors``), never
    their contents: a re-fit with the same architecture, and the same
    model saved and loaded in another process, keep their plan.

    The port's ``params()`` name a fitted transformer's tensors by object
    id (``workflow/transformer.py::tensor_identity``), which changes on
    every load: ``_stable_repr`` drops those ids and the tensors' shapes
    and dtypes stand in for them, so two stages that differ only in
    their weights' widths still sign apart."""
    from keystone_tpu_torch.utils.hashing import _stable_repr, fitted_tensors

    try:
        params = transformer.params()
    except Exception:
        params = None
    shapes: list = []
    fitted_tensors(transformer, lambda t: shapes.append((tuple(t.shape), str(t.dtype).replace("torch.", ""))))
    h = hashlib.blake2b(digest_size=6)
    h.update(type(transformer).__name__.encode())
    h.update(_stable_repr(params).encode())
    h.update(repr(shapes).encode())
    return f"{type(transformer).__name__}:{h.hexdigest()}"


@dataclasses.dataclass
class CandidateCost:
    """One sampled physical candidate: ``seconds ~= a + b*n`` fitted
    over ``samples`` = [[batch_rows, seconds], ...]."""

    name: str
    samples: List[List[float]] = dataclasses.field(default_factory=list)
    coeffs: Tuple[float, float] = (0.0, 0.0)  # (a, b)
    full_seconds: float = 0.0  # priced at the plan's full_batch
    supported: bool = True
    note: str = ""

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "samples": [[int(n), float(s)] for n, s in self.samples],
            "coeffs": [float(self.coeffs[0]), float(self.coeffs[1])],
            "full_seconds": float(self.full_seconds),
            "supported": bool(self.supported),
            "note": self.note,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CandidateCost":
        return cls(
            name=str(d["name"]),
            samples=[[int(n), float(s)] for n, s in d.get("samples", [])],
            coeffs=tuple(d.get("coeffs", (0.0, 0.0))),
            full_seconds=float(d.get("full_seconds", 0.0)),
            supported=bool(d.get("supported", True)),
            note=str(d.get("note", "")),
        )


@dataclasses.dataclass
class StageChoice:
    """One gate's decision at one stage: the candidates sampled, the
    winner, and the reason."""

    gate: str
    signature: str
    label: str
    winner: str
    why: str
    candidates: List[CandidateCost] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "gate": self.gate,
            "signature": self.signature,
            "label": self.label,
            "winner": self.winner,
            "why": self.why,
            "candidates": [c.to_dict() for c in self.candidates],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StageChoice":
        return cls(
            gate=str(d["gate"]),
            signature=str(d["signature"]),
            label=str(d.get("label", "")),
            winner=str(d["winner"]),
            why=str(d.get("why", "")),
            candidates=[
                CandidateCost.from_dict(c) for c in d.get("candidates", [])
            ],
        )


@dataclasses.dataclass
class PhysicalPlan:
    """The whole physical plan: stage choices + serving knobs.

    ``knobs`` holds only registry-validated names
    (:data:`keystone_tpu_torch.planner.registry.KNOBS`); values outside their
    bounds are rejected at resolve time, never silently applied."""

    backend: str
    seed: int = 0
    batch_sizes: Tuple[int, ...] = ()
    full_batch: int = 32
    stages: List[StageChoice] = dataclasses.field(default_factory=list)
    knobs: dict = dataclasses.field(default_factory=dict)
    source: str = "freeze"
    pipeline_signature: str = ""
    format: int = PLAN_FORMAT

    # ------------------------------------------------------------- identity
    def to_dict(self) -> dict:
        return {
            "format": int(self.format),
            "backend": self.backend,
            "seed": int(self.seed),
            "batch_sizes": [int(b) for b in self.batch_sizes],
            "full_batch": int(self.full_batch),
            "stages": [s.to_dict() for s in self.stages],
            "knobs": dict(self.knobs),
            "source": self.source,
            "pipeline_signature": self.pipeline_signature,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PhysicalPlan":
        if int(d.get("format", -1)) != PLAN_FORMAT:
            raise ValueError(
                f"unknown plan format {d.get('format')!r} "
                f"(this build reads {PLAN_FORMAT})"
            )
        return cls(
            backend=str(d.get("backend", "cpu")),
            seed=int(d.get("seed", 0)),
            batch_sizes=tuple(int(b) for b in d.get("batch_sizes", ())),
            full_batch=int(d.get("full_batch", 32)),
            stages=[StageChoice.from_dict(s) for s in d.get("stages", [])],
            knobs=dict(d.get("knobs", {})),
            source=str(d.get("source", "freeze")),
            pipeline_signature=str(d.get("pipeline_signature", "")),
            format=PLAN_FORMAT,
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "PhysicalPlan":
        return cls.from_dict(json.loads(text))

    def fingerprint(self) -> str:
        """Short content hash of the canonical JSON — the identity the
        roundtrip tests pin across manifest → registry → worker spawn."""
        return hashlib.blake2b(
            self.to_json().encode(), digest_size=8
        ).hexdigest()

    # ------------------------------------------------------------- queries
    def choice_for(self, gate: str) -> Optional[str]:
        """The winner for ``gate`` (first matching stage; the builder
        emits one consistent choice per gate)."""
        for s in self.stages:
            if s.gate == gate:
                return s.winner
        return None

    def stage_signatures(self) -> List[str]:
        return [s.signature for s in self.stages]

    # ------------------------------------------------------------ validation
    def validate(self, backend: Optional[str] = None) -> List[Tuple[str, str]]:
        """Graph-independent checks: ``(code, message)`` per problem.
        The analysis ``plan`` pass adds the graph-signature check on
        top (it has the graph; this object does not)."""
        from keystone_tpu_torch.planner import registry

        problems: List[Tuple[str, str]] = []
        for s in self.stages:
            spec = registry.GATES.get(s.gate)
            if spec is None:
                problems.append(
                    ("bad-plan-candidate", f"unknown gate {s.gate!r}")
                )
                continue
            if s.winner not in spec["candidates"]:
                problems.append(
                    (
                        "bad-plan-candidate",
                        f"gate {s.gate!r} winner {s.winner!r} is not a "
                        f"candidate: {spec['candidates']}",
                    )
                )
                continue
            ok = registry.supported_candidates(s.gate, backend=backend)
            if s.winner not in ok:
                problems.append(
                    (
                        "bad-plan-candidate",
                        f"gate {s.gate!r} winner {s.winner!r} is not "
                        f"runnable on backend "
                        f"{backend or registry.current_backend()!r}",
                    )
                )
        for name, value in self.knobs.items():
            ok, _v, why = registry.validate_knob(name, value)
            if not ok:
                problems.append(("bad-plan-candidate", f"knob {why}"))
        return problems

    # -------------------------------------------------------------- explain
    def explain(self) -> str:
        """Human rendering for ``cli plan --explain``: per stage,
        every candidate with sampled costs and the winner's why."""
        lines = [
            f"PhysicalPlan {self.fingerprint()}  "
            f"(backend={self.backend}, seed={self.seed}, "
            f"source={self.source})",
            f"  sampled batch sizes: {list(self.batch_sizes)}  "
            f"(priced at full_batch={self.full_batch})",
        ]
        for s in self.stages:
            lines.append(f"  stage {s.label or s.signature} [{s.signature}]")
            lines.append(f"    gate {s.gate}: winner={s.winner} ({s.why})")
            for c in s.candidates:
                samples = ", ".join(
                    f"n={int(n)}: {sec * 1e3:.3f}ms" for n, sec in c.samples
                )
                mark = "*" if c.name == s.winner else " "
                sup = "" if c.supported else "  [unsupported]"
                lines.append(
                    f"    {mark} {c.name}: full={c.full_seconds * 1e3:.3f}ms"
                    f"  fit a={c.coeffs[0] * 1e3:.4f}ms "
                    f"b={c.coeffs[1] * 1e6:.4f}us/row{sup}"
                    + (f"  [{samples}]" if samples else "")
                    + (f"  ({c.note})" if c.note else "")
                )
        if self.knobs:
            lines.append("  serving knobs:")
            for k in sorted(self.knobs):
                lines.append(f"    {k} = {self.knobs[k]}")
        return "\n".join(lines)
