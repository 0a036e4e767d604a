"""SLO-driven autoscaling of the replica fleet (counterpart of
``keystone_tpu/serve/autoscale.py``): threads, or, for a process or
network fleet (``workers=``), worker processes, each spawned, primed
(capturing its own bucket graphs) and admitted by ``scale_to``, and
reaped when it drains.

One control thread samples the service's signals every ``interval_s``
and

- **scales up** (``scale_to(n+1)``: build → prime, capturing the bucket
  graphs from the pool's artifact bundle → admit) when the queue is
  persistently deep, the SLO budget is burning, or windowed occupancy
  says every replica is computing wall to wall;
- **scales down** (a graceful drain; queued work moves to the
  survivors) after ``down_ticks`` consecutive idle samples, so one quiet
  window never thrashes the fleet;
- **retunes the dispatch window** between size changes: deeper
  per-replica queues while a backlog is transient, tighter backpressure
  while the fleet is idle.

The **pool hit rate** (``serve.pool_hit_rate``, the shared stage pool of
a multi-tenant service, ``serve/tenants.py``) lifts the occupancy
threshold: co-tenant flushes that amortize their shared prefix make
occupancy overstate the marginal cost of a request.  A service without
a pool reads None, which lifts nothing.

Decisions are pure (:meth:`AutoscalePolicy.decide` maps a
:class:`Signals` snapshot and the controller's state to an action), the
clock and the signal source are injectable, and every action lands in
metrics (``serve.autoscale_events{action=}``), the flight recorder's ops
ring, the ledger and ``/statusz``.  Cooldowns: ``up_cooldown_s`` after a
scale-up, ``down_cooldown_s`` after any action before a scale-down; never
below ``min_workers`` nor above ``max_workers``.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from keystone_tpu_torch.obs import ledger, metrics

logger = logging.getLogger(__name__)


@dataclass
class Signals:
    """One sample of everything the policy reads — constructed by
    :meth:`Autoscaler.sample` from the live service, or handed in by
    tests (the injectable signal source)."""

    workers: int
    queue_depth: int
    queue_bound: int
    occupancy: float  # windowed busy fraction, 0..1
    burn_rate: Optional[float]  # SLO error-budget burn; None = no SLO
    pool_hit_rate: Optional[float]  # shared stage pool; None = no pool

    @property
    def queue_frac(self) -> float:
        return self.queue_depth / max(1, self.queue_bound)


@dataclass
class AutoscalePolicy:
    """Thresholds + hysteresis.  All time quantities in seconds."""

    min_workers: int = 1
    max_workers: int = 4
    #: scale up when the queue holds more than this fraction of bound
    up_queue_frac: float = 0.5
    #: ... or the SLO budget burns faster than this
    up_burn: float = 1.0
    #: ... or windowed occupancy exceeds this (lifted by pool hit rate)
    up_occupancy: float = 0.85
    #: how much a fully-hitting shared pool lifts the occupancy bar
    #: (hit_rate × this is added to up_occupancy): shared-prefix
    #: amortization means high occupancy overstates marginal cost
    pool_occupancy_credit: float = 0.10
    #: scale down when occupancy is below this AND the queue is empty
    #: AND the burn rate is calm ...
    down_occupancy: float = 0.30
    down_burn: float = 0.5
    #: ... for this many consecutive samples (hysteresis)
    down_ticks: int = 5
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 30.0
    #: dispatch-window retune band (None disables retuning)
    window_min: Optional[int] = 2
    window_max: Optional[int] = 4

    def is_idle(self, s: Signals) -> bool:
        """The scale-down idle predicate — ONE definition, used both by
        :meth:`decide` and by the controller's hysteresis counter (two
        copies would let the counter gate on a different notion of
        'idle' than the decision itself)."""
        return (
            s.queue_depth == 0
            and s.occupancy <= self.down_occupancy
            and (s.burn_rate is None or s.burn_rate <= self.down_burn)
        )

    def decide(
        self, s: Signals, idle_ticks: int, since_up: float, since_any: float
    ) -> Optional[str]:
        """``"up"``, ``"down"``, or None — pure, clock-free (elapsed
        times come in as arguments)."""
        occ_bar = self.up_occupancy + self.pool_occupancy_credit * (
            s.pool_hit_rate or 0.0
        )
        pressed = (
            s.queue_frac >= self.up_queue_frac
            or (s.burn_rate is not None and s.burn_rate >= self.up_burn)
            or s.occupancy >= occ_bar
        )
        if pressed and s.workers < self.max_workers and since_up >= self.up_cooldown_s:
            return "up"
        if (
            self.is_idle(s)
            and idle_ticks + 1 >= self.down_ticks
            and s.workers > self.min_workers
            and since_any >= self.down_cooldown_s
        ):
            return "down"
        return None

    def window_for(self, s: Signals, current: int) -> Optional[int]:
        """The dispatch-window retune: deepen while a backlog exists
        with the fleet already hot (absorb a transient without a spawn),
        tighten back when calm.  None = leave it alone."""
        if self.window_min is None or self.window_max is None:
            return None
        if s.queue_frac >= self.up_queue_frac and s.workers >= self.max_workers:
            return min(self.window_max, current + 1) if current < self.window_max else None
        if s.queue_depth == 0 and s.occupancy <= self.down_occupancy:
            return max(self.window_min, current - 1) if current > self.window_min else None
        return None


class Autoscaler:
    """The control thread.  ``clock`` and ``signal_source`` are
    injectable (tests drive :meth:`tick` directly with a fake clock and
    synthetic :class:`Signals`); ``apply=False`` makes it a dry-run
    advisor (decisions recorded, fleet untouched)."""

    def __init__(
        self,
        service,
        min_workers: Optional[int] = None,
        max_workers: Optional[int] = None,
        interval_s: float = 1.0,
        policy: Optional[AutoscalePolicy] = None,
        clock: Callable[[], float] = time.monotonic,
        signal_source: Optional[Callable[[], Signals]] = None,
        apply: bool = True,
        **policy_overrides,
    ):
        if policy is None:
            policy = AutoscalePolicy(
                min_workers=int(1 if min_workers is None else min_workers),
                max_workers=int(4 if max_workers is None else max_workers),
                **policy_overrides,
            )
        elif (
            min_workers is not None
            or max_workers is not None
            or policy_overrides
        ):
            # silently dropping bounds an operator passed alongside an
            # explicit policy is how a fleet "mysteriously" caps at the
            # policy default — misconfiguration must be loud
            raise ValueError(
                "pass EITHER policy= OR min_workers/max_workers/"
                "threshold overrides, not both"
            )
        if policy.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if policy.max_workers < policy.min_workers:
            raise ValueError("max_workers must be >= min_workers")
        self.service = service
        self.policy = policy
        self.interval_s = max(0.05, float(interval_s))
        self._clock = clock
        self._signals = signal_source or self.sample
        self._apply = bool(apply)
        self._idle_ticks = 0
        self._last_up = -1e9
        self._last_any = -1e9
        self.ups = 0
        self.downs = 0
        self.window_retunes = 0
        self.last_action: Optional[dict] = None
        self.last_signals: Optional[Signals] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop,
            daemon=True,
            name=f"{service.name}-autoscaler",
        )

    # ------------------------------------------------------------ signals
    def sample(self) -> Signals:
        """Read the live service's signal set (the default source).  The
        pool hit rate is that of the service's own shared stage pool (a
        multi-tenant service's); a service without one reads None."""
        svc = self.service
        applier = getattr(svc, "_mt_applier", None)
        pool_rate = None if applier is None else applier.pool().hit_rate()
        return Signals(
            workers=svc._pool.size,
            queue_depth=svc.queue_depth,
            queue_bound=svc.queue_bound,
            occupancy=svc.occupancy(),
            burn_rate=svc.slo_burn_rate(),
            pool_hit_rate=pool_rate,
        )

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "Autoscaler":
        self._thread.start()
        return self

    def stop(self, timeout: float = 60.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def _loop(self) -> None:
        ledger.restore_context(self.service._obs_ctx)
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # the controller must never die of a resize
                logger.exception("autoscaler tick failed")

    # ---------------------------------------------------------------- tick
    def tick(self) -> Optional[str]:
        """One control decision (the loop body; tests call it
        directly).  Returns the action taken ("up"/"down"/"window"/
        None)."""
        svc = self.service
        if getattr(svc, "_closing", False):
            return None
        s = self._signals()
        self.last_signals = s
        now = self._clock()
        action = self.policy.decide(
            s,
            self._idle_ticks,
            now - self._last_up,
            now - self._last_any,
        )
        self._idle_ticks = (
            self._idle_ticks + 1 if self.policy.is_idle(s) else 0
        )
        if action == "up":
            target = min(self.policy.max_workers, s.workers + 1)
            # a network fleet's host map bounds growth by its slots
            cap = getattr(svc, "host_capacity", None)
            if cap is not None:
                target = min(target, int(cap))
            if target <= s.workers:
                return None
            # counted before the resize, as the metric is: a reader that
            # sees the new fleet size also sees the action that made it
            self._last_up = now
            self._last_any = now
            self.ups += 1
            self._idle_ticks = 0
            self._act("up", s, target)
            return "up"
        if action == "down":
            target = max(self.policy.min_workers, s.workers - 1)
            self._last_any = now
            self.downs += 1
            self._idle_ticks = 0
            self._act("down", s, target)
            return "down"
        # between size changes: the cheap lever
        new_window = self.policy.window_for(s, svc._pool.window)
        if new_window is not None:
            if self._apply:
                svc.set_dispatch_window(new_window)
            self.window_retunes += 1
            metrics.inc("serve.autoscale_events", action="window")
            self._record("window", s, new_window)
            return "window"
        return None

    def _act(self, action: str, s: Signals, target: int) -> None:
        metrics.inc("serve.autoscale_events", action=action)
        if self._apply:
            self.service.scale_to(target)
        self._record(action, s, target)

    def _record(self, action: str, s: Signals, target) -> None:
        self.last_action = {
            "action": action,
            "target": target,
            "workers": s.workers,
            "queue_depth": s.queue_depth,
            "occupancy": round(s.occupancy, 4),
            "burn_rate": None if s.burn_rate is None else round(s.burn_rate, 3),
            "pool_hit_rate": (
                None if s.pool_hit_rate is None else round(s.pool_hit_rate, 4)
            ),
        }
        ledger.event(
            "serve.autoscale",
            action=action,
            workers=s.workers,
            queue_depth=s.queue_depth,
            occupancy=round(s.occupancy, 4),
        )
        rec = getattr(self.service, "recorder", None)
        if rec is not None:
            rec.ops(
                "serve.autoscale",
                action=action,
                workers=s.workers,
                queue_depth=s.queue_depth,
                occupancy=round(s.occupancy, 4),
            )
        logger.info(
            "autoscale %s -> %s (occupancy %.2f, queue %d, burn %s)",
            action,
            target,
            s.occupancy,
            s.queue_depth,
            "n/a" if s.burn_rate is None else f"{s.burn_rate:.2f}",
        )

    # --------------------------------------------------------------- status
    def status(self) -> dict:
        p = self.policy
        s = self.last_signals
        return {
            "min_workers": p.min_workers,
            "max_workers": p.max_workers,
            "interval_seconds": self.interval_s,
            "apply": self._apply,
            "ups": self.ups,
            "downs": self.downs,
            "window_retunes": self.window_retunes,
            "idle_ticks": self._idle_ticks,
            "last_action": self.last_action,
            "last_signals": (
                None
                if s is None
                else {
                    "workers": s.workers,
                    "queue_depth": s.queue_depth,
                    "occupancy": round(s.occupancy, 4),
                    "burn_rate": (
                        None if s.burn_rate is None else round(s.burn_rate, 3)
                    ),
                    "pool_hit_rate": (
                        None
                        if s.pool_hit_rate is None
                        else round(s.pool_hit_rate, 4)
                    ),
                }
            ),
        }
