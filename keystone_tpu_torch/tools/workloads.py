"""Seeded adversarial workload zoo for the serving fleet (counterpart of
the repo's ``tools/workloads.py``).

Every scenario is a deterministic function of ``(name, seed)``: the
arrival schedule, batch sizes, tenant choices, poison placement and
payload row seeds all derive from one BLAKE2b-seeded PRNG, so a workload
that trips a canary (or slips past one) replays exactly, and
``trace_digest()`` pins the whole schedule to a hash (the same hash the
reference's zoo gives for the same scenario).  The zoo is the guarded
rollout drill's traffic (``python -m keystone_tpu_torch.tools.chaos
--workload rollout``).

Scenarios::

    bursty        quiet baseline with seeded 10x arrival bursts
    diurnal       sinusoidal offered rate over the window
    heavy_tailed  Pareto-ish batch sizes: most tiny, a few huge
    poison_flood  clean warmup, then a window where a fraction of
                  rows carry the poison marker (``MARK`` in x[0])
    tenant_skewed zipf-ish tenant pick: one hot tenant dominates
    drift         payload distribution shifts steadily mid-window

Usage::

    python -m keystone_tpu_torch.tools.workloads --scenario poison_flood --seed 7

:func:`build_zoo_pipeline` makes the drill's model versions on the card
(``device=``): NormalizeRows → LinearMapper(eye·scale), so an answer's
norm says which version served it, and ``gate=True`` puts
``tools/serve_bench.py``'s ``MarkerGate`` in front, the bad version that
fails exactly the rows ``poison_flood`` marks.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import random
import time

import numpy as np
import torch

from keystone_tpu_torch.tools.serve_bench import MARK, MarkerGate

SCENARIOS = (
    "bursty",
    "diurnal",
    "heavy_tailed",
    "poison_flood",
    "tenant_skewed",
    "drift",
)

__all__ = ["MARK", "MarkerGate", "SCENARIOS", "Scenario", "build_zoo_pipeline", "make_scenario", "payload", "play"]


def build_zoo_pipeline(dim: int = 8, scale: float = 2.0, gate: bool = False, device="cuda"):
    """The drill pipeline: NormalizeRows → LinearMapper(eye·scale), its
    weights on ``device``, so a served row's norm is ``scale``.
    ``gate=True`` prepends :class:`MarkerGate`."""
    from keystone_tpu_torch.models.linear import LinearMapper
    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    w = torch.eye(dim, dtype=torch.float32, device=resolve_device(device)) * float(scale)
    if gate:
        return Pipeline.of(MarkerGate()) | NormalizeRows() | LinearMapper(w)
    return Pipeline.of(NormalizeRows()) | LinearMapper(w)


class Scenario:
    """A fully materialized, replayable workload: an ordered list of
    arrival events, each ``{"t", "kind", "tenant", "rows", "row_seed",
    "shift"}`` — everything :func:`payload` needs to rebuild the exact
    bytes.  Construct via :func:`make_scenario`."""

    __slots__ = ("name", "seed", "duration_s", "dim", "tenants", "events")

    def __init__(self, name, seed, duration_s, dim, tenants, events):
        self.name = name
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.dim = int(dim)
        self.tenants = int(tenants)
        self.events = events

    def trace(self) -> list:
        """The schedule as plain dicts (JSON-ready, digest input)."""
        return [dict(e) for e in self.events]

    def trace_digest(self) -> str:
        """BLAKE2b over the canonical-JSON schedule: two scenarios with
        the same digest submit byte-identical traffic."""
        blob = json.dumps(
            {
                "name": self.name,
                "seed": self.seed,
                "dim": self.dim,
                "events": self.trace(),
            },
            sort_keys=True,
            separators=(",", ":"),
        ).encode("utf-8")
        return hashlib.blake2b(blob, digest_size=16).hexdigest()

    def total_rows(self) -> int:
        return sum(e["rows"] for e in self.events)

    def poison_rows(self) -> int:
        return sum(e["rows"] for e in self.events if e["kind"] == "poison")

    def summary(self) -> dict:
        kinds: dict = {}
        for e in self.events:
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
        return {
            "name": self.name,
            "seed": self.seed,
            "duration_s": self.duration_s,
            "dim": self.dim,
            "events": len(self.events),
            "rows": self.total_rows(),
            "poison_rows": self.poison_rows(),
            "kinds": kinds,
            "digest": self.trace_digest(),
        }


def _zoo_rng(name: str, seed: int) -> random.Random:
    """One PRNG per (scenario, seed), derived through BLAKE2b so
    adjacent integer seeds don't produce correlated streams."""
    digest = hashlib.blake2b(
        f"{name}:{int(seed)}".encode("utf-8"), digest_size=8
    ).digest()
    return random.Random(int.from_bytes(digest, "big"))


def make_scenario(
    name: str,
    seed: int = 0,
    duration_s: float = 2.0,
    qps: float = 200.0,
    dim: int = 8,
    tenants: int = 4,
) -> Scenario:
    """Materialize one zoo scenario.  ``qps`` is the MEAN event rate;
    each scenario shapes arrivals/sizes/content its own way around it.
    Deterministic in ``(name, seed)`` for fixed knobs."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; one of {SCENARIOS}")
    rng = _zoo_rng(name, seed)
    duration_s = float(duration_s)
    n_events = max(1, int(round(qps * duration_s)))
    events = []

    def _event(t, kind="ok", tenant=0, rows=1, shift=0.0):
        events.append(
            {
                "t": round(float(t), 6),
                "kind": kind,
                "tenant": f"t{int(tenant)}",
                "rows": int(rows),
                "row_seed": rng.getrandbits(32),
                "shift": round(float(shift), 6),
            }
        )

    if name == "bursty":
        # quiet baseline + seeded bursts: ~1/8 of events arrive in
        # 10-event clumps at the same instant (queue-depth spikes the
        # admission/shedding layer must absorb)
        t = 0.0
        budget = n_events
        while budget > 0:
            t += rng.expovariate(qps)
            if t >= duration_s:
                t = duration_s * rng.random()
            if rng.random() < 0.125:
                clump = min(budget, 10)
                for _ in range(clump):
                    _event(t, rows=rng.choice((1, 1, 2)))
                budget -= clump
            else:
                _event(t, rows=rng.choice((1, 1, 2)))
                budget -= 1
        events.sort(key=lambda e: e["t"])
    elif name == "diurnal":
        # sinusoidal rate: thin-out by the instantaneous rate so the
        # peak-to-trough swing survives into the schedule
        for i in range(n_events * 2):
            t = duration_s * i / (n_events * 2)
            rate = 0.5 * (1.0 + math.sin(2.0 * math.pi * t / duration_s))
            if rng.random() < rate:
                _event(t, rows=1)
        if not events:
            _event(0.0, rows=1)
    elif name == "heavy_tailed":
        # Pareto-ish batch sizes: most events one row, the tail huge
        # (the oversized submit_many groups that stress max_batch
        # packing and padding buckets)
        t = 0.0
        for _ in range(n_events):
            t += rng.expovariate(qps)
            rows = min(64, max(1, int(rng.paretovariate(1.2))))
            _event(min(t, duration_s), rows=rows)
    elif name == "poison_flood":
        # clean warmup third, then a flood window where 40% of events
        # carry marker rows — against a gated version the canary
        # generation concentrates the failures
        t = 0.0
        for i in range(n_events):
            t += rng.expovariate(qps)
            t = min(t, duration_s)
            in_flood = i >= n_events // 3
            if in_flood and rng.random() < 0.4:
                _event(t, kind="poison", rows=rng.choice((1, 2)))
            else:
                _event(t, rows=rng.choice((1, 1, 2)))
    elif name == "tenant_skewed":
        # zipf-ish tenant pick: tenant 0 takes ~ half the traffic (the
        # fairness/starvation drill for the multi-tenant accountant)
        weights = [1.0 / (k + 1) for k in range(max(1, int(tenants)))]
        total = sum(weights)
        t = 0.0
        for _ in range(n_events):
            t += rng.expovariate(qps)
            r = rng.random() * total
            acc = 0.0
            pick = 0
            for k, w in enumerate(weights):
                acc += w
                if r <= acc:
                    pick = k
                    break
            _event(min(t, duration_s), tenant=pick, rows=1)
    elif name == "drift":
        # distribution drift: payload mean shifts linearly from 0 to 3
        # sigma across the window — the slow-burn regression a canary
        # window can miss and a post-commit bake must catch
        t = 0.0
        for _ in range(n_events):
            t += rng.expovariate(qps)
            t = min(t, duration_s)
            shift = 3.0 * (t / duration_s)
            _event(t, kind="drift" if shift > 0.5 else "ok", shift=shift)
    events.sort(key=lambda e: e["t"])
    return Scenario(name, seed, duration_s, dim, tenants, events)


def payload(event: dict, dim: int) -> np.ndarray:
    """Rebuild one event's exact rows from its recorded ``row_seed``:
    normal rows, plus the marker in x[0] for poison events and the
    recorded mean shift for drift events."""
    rows = int(event["rows"])
    x = (
        np.random.default_rng(int(event["row_seed"]))
        .normal(size=(rows, int(dim)))
        .astype(np.float32)
    )
    if event["kind"] == "poison":
        x[:, 0] = MARK
    shift = float(event.get("shift") or 0.0)
    if shift:
        x = (x + np.float32(shift)).astype(np.float32)
    return x


def play(scenario: Scenario, submit, time_scale: float = 1.0) -> list:
    """Drive ``submit(event, rows_array)`` along the scenario's
    schedule (``time_scale`` compresses it; 0 = as fast as possible)
    and return the per-event results.  ``submit`` exceptions are
    captured as results, not raised — an admission refusal is a
    scheduled outcome, not a replay failure."""
    out = []
    t0 = time.monotonic()
    for event in scenario.events:
        if time_scale > 0.0:
            due = t0 + event["t"] * time_scale
            now = time.monotonic()
            if due > now:
                time.sleep(due - now)
        try:
            out.append(submit(event, payload(event, scenario.dim)))
        except Exception as e:
            out.append(e)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="materialize a seeded zoo scenario and print its "
        "schedule summary + replay digest"
    )
    ap.add_argument("--scenario", default=None, choices=SCENARIOS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--qps", type=float, default=200.0)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument(
        "--trace",
        action="store_true",
        help="dump the full event schedule, not just the summary",
    )
    args = ap.parse_args(argv)
    names = [args.scenario] if args.scenario else list(SCENARIOS)
    for name in names:
        sc = make_scenario(
            name,
            seed=args.seed,
            duration_s=args.duration,
            qps=args.qps,
            dim=args.dim,
            tenants=args.tenants,
        )
        print(json.dumps(sc.trace() if args.trace else sc.summary(), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
