"""PlanTuner: refine the plan from live telemetry, retune safe knobs
(counterpart of ``keystone_tpu/planner/tuner.py``).

The cost model freezes its decisions from a few sampled batches; serving
is the better teacher.  The tuner is a control thread in the
Autoscaler's mold (an injectable clock and signal source, a ``tick`` the
tests drive directly) that reads the serving telemetry the obs layer
already collects (windowed flush occupancy from ``serve.batch_rows``,
the SLO burn) and retunes the **safe** serving knobs live:

- **padding buckets**, through :meth:`PipelineService.retune_buckets`,
  an atomic swap of the bucket ladder that changes padding, never
  results, so no future is lost (thread fleets only: process workers
  capture their buckets' graphs at spawn).  A bucket the retune adds has
  no CUDA graph: its flushes walk the executor, counted as
  ``serve.retuned_bucket_walks``, until the next ``prime`` captures it;
- the **dispatch window**, through ``set_dispatch_window``, by the
  autoscaler's own :meth:`AutoscalePolicy.window_for` rule, and only when
  the service has no live autoscaler (two controllers on one knob
  oscillate).

Every retune is a ``plan.retune`` ledger event and recorder ops entry,
and **bakes**: the old value is kept, the SLO burn is watched for
``bake_s`` seconds, and a retune that burns the error budget (``burn >
bake_max_burn`` over at least ``min_samples`` windowed requests) is
reverted (outcome ``reverted``).  A retune that survives its bake is
committed into the plan's ``knobs`` (the refined cost model ships with
the next publish).

Gate winners are never retuned live: flipping a physical implementation
under traffic would change the captured graphs mid-flight; that stays a
freeze-time decision.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.planner import registry
from keystone_tpu_torch.serve.autoscale import AutoscalePolicy, Signals

logger = logging.getLogger(__name__)


class PlanTuner:
    """Live knob retuner for one :class:`PipelineService`.

    ``clock`` / ``signal_source`` / ``rows_source`` / ``burn_source``
    are injectable (tests drive :meth:`tick` with a fake clock and
    synthetic telemetry); ``apply=False`` records decisions without
    touching the service.
    """

    def __init__(
        self,
        service,
        plan=None,
        policy: Optional[AutoscalePolicy] = None,
        interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        signal_source: Optional[Callable[[], Signals]] = None,
        rows_source: Optional[Callable[[], Optional[dict]]] = None,
        burn_source: Optional[Callable[[], Optional[dict]]] = None,
        apply: bool = True,
        bake_s: float = 5.0,
        bake_max_burn: float = 2.0,
        min_samples: int = 10,
        cooldown_s: float = 10.0,
        min_bucket: int = 1,
        occupancy_frac: float = 0.5,
    ):
        self.service = service
        self._plan = plan
        self.policy = policy or AutoscalePolicy()
        self.interval_s = max(0.05, float(interval_s))
        self._clock = clock
        self._signals = signal_source or self._sample
        self._rows = rows_source or self._sample_rows
        self._burn = burn_source or self._sample_burn
        self._apply = bool(apply)
        self.bake_s = float(bake_s)
        self.bake_max_burn = float(bake_max_burn)
        self.min_samples = int(min_samples)
        self.cooldown_s = float(cooldown_s)
        self.min_bucket = max(1, int(min_bucket))
        #: flushes averaging below ``occupancy_frac × min(buckets)`` rows
        #: trigger a smaller bucket (padding waste)
        self.occupancy_frac = float(occupancy_frac)
        self._pending: Optional[dict] = None  # the retune currently baking
        self._last_retune = -1e9
        self._rows_base: Optional[dict] = None
        self.retunes = 0
        self.reverts = 0
        self.commits = 0
        self.last_action: Optional[dict] = None
        self.observations: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop,
            daemon=True,
            name=f"{getattr(service, 'name', 'serve')}-plantuner",
        )

    # ------------------------------------------------------------- telemetry
    @property
    def plan(self):
        """The plan being refined: explicit > the process-installed one."""
        return self._plan if self._plan is not None else registry.current_plan()

    def _sample(self) -> Signals:
        svc = self.service
        applier = getattr(svc, "_mt_applier", None)
        pool_rate = None
        if applier is not None:
            try:
                pool_rate = applier.pool().hit_rate()
            except Exception:
                pool_rate = None
        return Signals(
            workers=svc._pool.size,
            queue_depth=svc.queue_depth,
            queue_bound=svc.queue_bound,
            occupancy=svc.occupancy(),
            burn_rate=svc.slo_burn_rate(),
            pool_hit_rate=pool_rate,
        )

    def _sample_rows(self) -> Optional[dict]:
        """Cumulative ``serve.batch_rows`` histogram (count/sum) — the
        tick diffs consecutive reads into observed flush occupancy."""
        try:
            return metrics.REGISTRY.histogram_value("serve.batch_rows")
        except Exception:
            return None

    def _sample_burn(self) -> Optional[dict]:
        try:
            return self.service.slo_burn()
        except Exception:
            return None

    def _avg_rows(self) -> Optional[float]:
        """Mean rows per flush since the previous tick (None until two
        reads with traffic in between)."""
        cur = self._rows()
        prev, self._rows_base = self._rows_base, cur
        if not cur or not prev:
            return None
        dn = float(cur.get("count", 0)) - float(prev.get("count", 0))
        ds = float(cur.get("sum", 0.0)) - float(prev.get("sum", 0.0))
        if dn <= 0:
            return None
        return ds / dn

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "PlanTuner":
        self._thread.start()
        return self

    def stop(self, timeout: float = 60.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def _loop(self) -> None:
        ledger.restore_context(getattr(self.service, "_obs_ctx", None))
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # a retune must never kill the controller
                logger.exception("plan tuner tick failed")

    # ---------------------------------------------------------------- tick
    def tick(self) -> Optional[str]:
        """One control decision; returns ``"retune"``, ``"commit"``,
        ``"revert"``, or None."""
        svc = self.service
        if getattr(svc, "_closing", False):
            return None
        now = self._clock()
        s = self._signals()
        avg_rows = self._avg_rows()
        if avg_rows is not None:
            self.observations["avg_batch_rows"] = round(avg_rows, 2)
        if self._pending is not None:
            return self._judge_bake(now)
        if now - self._last_retune < self.cooldown_s:
            return None
        # dispatch window — the autoscaler's own rule; only when no live
        # autoscaler holds this knob
        if getattr(svc, "autoscaler", None) is None:
            new = self.policy.window_for(s, svc._pool.window)
            if new is not None:
                return self._begin(
                    "dispatch_window",
                    old=svc._pool.window,
                    new=int(new),
                    reason=f"queue_frac={s.queue_frac:.2f} "
                    f"occupancy={s.occupancy:.2f}",
                    now=now,
                    setter=svc.set_dispatch_window,
                )
        # padding buckets — thread fleets only: process workers bake
        # their bucket ladder into spawned programs at startup
        if getattr(svc, "workers", 0) == 0 and avg_rows is not None:
            buckets = tuple(svc.buckets)
            smallest = min(buckets)
            if (
                smallest > self.min_bucket
                and avg_rows < self.occupancy_frac * smallest
            ):
                proposal = tuple(
                    sorted({max(self.min_bucket, smallest // 2)} | set(buckets))
                )
                ok, coerced, _ = registry.validate_knob("buckets", proposal)
                if ok:
                    return self._begin(
                        "buckets",
                        old=buckets,
                        new=coerced,
                        reason=f"avg flush {avg_rows:.1f} rows < "
                        f"{self.occupancy_frac:.0%} of bucket {smallest}",
                        now=now,
                        setter=svc.retune_buckets,
                    )
        return None

    # ------------------------------------------------------------- retuning
    def _begin(self, knob, old, new, reason, now, setter) -> str:
        if self._apply:
            setter(new)
        self._pending = {
            "knob": knob,
            "old": old,
            "new": new,
            "reason": reason,
            "started": now,
            "setter": setter,
        }
        self._last_retune = now
        self.retunes += 1
        self._emit("retune", knob, old, new, reason)
        return "retune"

    def _judge_bake(self, now: float) -> Optional[str]:
        p = self._pending
        burn = self._burn() or {}
        rate = burn.get("burn_rate")
        n = int(burn.get("window_requests") or 0)
        if (
            rate is not None
            and n >= self.min_samples
            and float(rate) > self.bake_max_burn
        ):
            if self._apply:
                p["setter"](p["old"])
            self._pending = None
            self.reverts += 1
            self._emit(
                "reverted",
                p["knob"],
                p["new"],
                p["old"],
                f"burn {float(rate):.2f} > {self.bake_max_burn} "
                f"over {n} requests",
            )
            return "revert"
        if now - p["started"] >= self.bake_s:
            self._pending = None
            self.commits += 1
            plan = self.plan
            if plan is not None:
                value = (
                    list(p["new"])
                    if isinstance(p["new"], (tuple, list))
                    else p["new"]
                )
                plan.knobs[p["knob"]] = value  # the refined model
            self._emit("kept", p["knob"], p["old"], p["new"], p["reason"])
            return "commit"
        return None

    def _emit(self, outcome, knob, old, new, reason) -> None:
        self.last_action = {
            "outcome": outcome,
            "knob": knob,
            "old": old,
            "new": new,
            "reason": reason,
        }
        metrics.inc("plan.retunes", outcome=outcome)
        ledger.event(
            "plan.retune",
            outcome=outcome,
            knob=knob,
            reason=reason,
        )
        rec = getattr(self.service, "recorder", None)
        if rec is not None:
            rec.ops(
                "plan.retune",
                outcome=outcome,
                knob=knob,
                reason=f"{old} -> {new}: {reason}",
            )
        logger.info(
            "plan.retune %s %s: %s -> %s (%s)", outcome, knob, old, new, reason
        )

    # --------------------------------------------------------------- status
    def status(self) -> dict:
        plan = self.plan
        p = self._pending
        return {
            "interval_seconds": self.interval_s,
            "apply": self._apply,
            "retunes": self.retunes,
            "commits": self.commits,
            "reverts": self.reverts,
            "baking": None
            if p is None
            else {
                "knob": p["knob"],
                "old": p["old"],
                "new": p["new"],
                "reason": p["reason"],
            },
            "last_action": self.last_action,
            "observations": dict(self.observations),
            "plan": None if plan is None else plan.fingerprint(),
        }
