"""Guarded rollouts: canary-fraction swaps with automatic rollback
(counterpart of ``keystone_tpu/serve/rollout.py``).

The blue/green swap (``service.swap`` → ``fleet.stage``/``commit``) moves
a version from 0% to 100% of traffic in one commit.  This module closes
the loop:

- :class:`CanaryController` stages a generation exactly as ``swap``
  does, then, before committing, serves a **traffic fraction** on the
  staged replicas: the batcher hands each formed flush to
  :meth:`CanaryController.take`, which splits by a seeded BLAKE2b hash of
  the flush's first request id (:func:`canary_hash`, the reference's
  split, so a replay of the same ids routes alike in both packages).
- While the canary serves, per-generation outcome and latency tallies
  accumulate (:meth:`CanaryController.observe`, called from the
  service's request terminals).  Past a **minimum sample window** the
  judge reads the guardrails (canary error/poison/shed rate, the
  service's windowed SLO burn rate, canary p99 against the live
  generation's, an optional prediction-divergence probe on dual-applied
  rows) and either **commits** or **rolls back** (the staged generation
  retired and drained, no future lost, the bad version durably
  quarantined in the registry so the watcher cannot redeploy it).
- After a commit a :class:`RollbackGuard` watches the burn rate for a
  **bake** period and reverts to the prior generation on a sustained
  violation.

Every decision is a ``serve.rollout`` flight-recorder ops span and ledger
event, counted under ``serve.rollout.*``, and visible in ``GET
/rolloutz`` (``service.rollout_status()``).  The ``serve.rollout`` fault
site fires at the start of each episode.  With ``canary=None`` nothing
here runs: ``guarded_swap`` is the plain ``service.swap``.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from collections import Counter
from typing import List, Optional

import numpy as np

from keystone_tpu_torch.faults import fault_point
from keystone_tpu_torch.obs import ledger, metrics

logger = logging.getLogger(__name__)

#: hash-split granularity: 53 bits of BLAKE2b mapped into [0, 1) — every
#: float in the unit interval is exactly representable, so the split
#: threshold compare is deterministic across platforms
_HASH_BITS = 53
_HASH_DENOM = float(1 << _HASH_BITS)

#: request-terminal outcomes that count AGAINST the canary (the 4xx/5xx
#: family plus deadline sheds); "completed"/"degraded" count for it
_BAD_OUTCOMES = ("error", "poison", "shed")


def canary_hash(seed: int, request_id: str) -> float:
    """Deterministic [0, 1) split coordinate for one request id: the
    router serves a flush on the canary generation iff this is below
    the configured fraction.  Seeded — replaying the same ids under the
    same seed reproduces the exact routing split (the determinism pin
    tests/test_rollout.py holds, and the port's parity tests hold
    against it)."""
    h = hashlib.blake2b(
        f"{int(seed)}:{request_id}".encode(), digest_size=8
    ).digest()
    return (int.from_bytes(h, "big") >> (64 - _HASH_BITS)) / _HASH_DENOM


class RolloutConfig:
    """Knobs for one guarded rollout episode.

    - ``canary`` — traffic fraction (0, 1] served by the staged
      generation during the judge window.  None disables the guard
      entirely (the caller should use plain ``service.swap``).
    - ``seed`` — the routing-hash seed (replayable split).
    - ``min_samples`` — request terminals the canary must accumulate
      before the judge may decide; below it the judge refuses to read
      noise as a verdict.
    - ``decide_s`` — judge window bound: if ``min_samples`` has not
      arrived by then, ``insufficient`` ("rollback" default, or
      "commit") decides.
    - ``max_error_rate`` — canary error+poison+shed fraction above
      which the judge rolls back.
    - ``max_burn`` — service-wide windowed SLO burn rate above which
      the judge rolls back (needs an ``slo_ms`` objective and at least
      ``min_samples`` requests in the burn window).
    - ``p99_ratio`` — roll back when canary p99 latency exceeds this
      multiple of the live generation's p99 (both need >= 8 completed
      samples; None disables).
    - ``divergence_rtol`` — optional prediction-divergence probe: up to
      ``divergence_samples`` canary rows are re-applied on BOTH
      generations and the max relative difference above this rolls
      back (None disables — models with intentional output drift).
    - ``bake_s`` — post-commit bake: a :class:`RollbackGuard` watches
      the burn rate this long and reverts on sustained violation
      (``bake_max_burn`` for at least ``bake_sustain_s``).  0 disables.
    """

    __slots__ = (
        "canary",
        "seed",
        "min_samples",
        "decide_s",
        "max_error_rate",
        "max_burn",
        "p99_ratio",
        "divergence_rtol",
        "divergence_samples",
        "bake_s",
        "bake_max_burn",
        "bake_sustain_s",
        "insufficient",
        "poll_s",
    )

    def __init__(
        self,
        canary: Optional[float] = 0.1,
        seed: int = 0,
        min_samples: int = 32,
        decide_s: float = 30.0,
        max_error_rate: float = 0.1,
        max_burn: float = 2.0,
        p99_ratio: Optional[float] = 3.0,
        divergence_rtol: Optional[float] = None,
        divergence_samples: int = 4,
        bake_s: float = 0.0,
        bake_max_burn: float = 2.0,
        bake_sustain_s: float = 1.0,
        insufficient: str = "rollback",
        poll_s: float = 0.02,
    ):
        if canary is not None:
            canary = float(canary)
            if not (0.0 < canary <= 1.0):
                raise ValueError(
                    f"canary fraction must be in (0, 1], got {canary}"
                )
        if insufficient not in ("rollback", "commit"):
            raise ValueError(
                f"insufficient must be 'rollback' or 'commit', "
                f"got {insufficient!r}"
            )
        self.canary = canary
        self.seed = int(seed)
        self.min_samples = max(1, int(min_samples))
        self.decide_s = max(0.0, float(decide_s))
        self.max_error_rate = float(max_error_rate)
        self.max_burn = float(max_burn)
        self.p99_ratio = None if p99_ratio is None else float(p99_ratio)
        self.divergence_rtol = (
            None if divergence_rtol is None else float(divergence_rtol)
        )
        self.divergence_samples = max(1, int(divergence_samples))
        self.bake_s = max(0.0, float(bake_s))
        self.bake_max_burn = float(bake_max_burn)
        self.bake_sustain_s = max(0.0, float(bake_sustain_s))
        self.insufficient = insufficient
        self.poll_s = max(0.001, float(poll_s))

    #: body keys POST /swap (and the watcher config) may carry; anything
    #: else in the body is NOT a rollout knob and is left alone
    REQUEST_KEYS = (
        "canary",
        "seed",
        "min_samples",
        "decide_s",
        "max_error_rate",
        "max_burn",
        "p99_ratio",
        "divergence_rtol",
        "bake_s",
        "bake_max_burn",
        "bake_sustain_s",
        "insufficient",
    )

    @classmethod
    def from_request(cls, body: dict) -> "RolloutConfig":
        """Build from an admin request body (``POST /swap``); unknown
        keys are ignored, bad values raise ValueError (a 400)."""
        kw = {k: body[k] for k in cls.REQUEST_KEYS if body.get(k) is not None}
        try:
            return cls(**kw)
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad rollout config: {e}")

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class _GenStats:
    """Outcome/latency tally for one generation during the canary
    window.  Mutated under the controller's lock."""

    __slots__ = ("outcomes", "latencies")

    def __init__(self):
        self.outcomes: Counter = Counter()
        self.latencies: List[float] = []

    def total(self) -> int:
        return sum(self.outcomes.values())

    def bad(self) -> int:
        return sum(self.outcomes.get(o, 0) for o in _BAD_OUTCOMES)

    def p99(self) -> Optional[float]:
        if len(self.latencies) < 8:
            return None
        lats = sorted(self.latencies)
        return lats[min(len(lats) - 1, int(0.99 * len(lats)))]

    def summary(self) -> dict:
        total = self.total()
        p99 = self.p99()
        return {
            "requests": total,
            "bad": self.bad(),
            "bad_rate": (self.bad() / total) if total else None,
            "outcomes": dict(self.outcomes),
            "p99_ms": None if p99 is None else round(1000.0 * p99, 3),
        }


class CanaryController:
    """One guarded rollout episode: stage → canary-serve a fraction →
    judge → commit or roll back.  Build one per episode (single-use);
    :func:`guarded_swap` is the convenience wrapper.

    ``registry``: when given, a rollback durably quarantines the bad
    version (``ModelRegistry.quarantine``) and restores the ``CURRENT``
    pointer to the prior version, so the watcher cannot re-deploy the
    publish the guard just condemned; a commit moves ``CURRENT`` to the
    new version (the admin-swap discipline).
    """

    def __init__(self, service, config: RolloutConfig, registry=None):
        if config.canary is None:
            raise ValueError(
                "CanaryController needs a canary fraction; use "
                "service.swap() directly for unguarded swaps"
            )
        self.service = service
        self.config = config
        self.registry = registry
        self._lock = threading.Lock()
        self._stats = {"live": _GenStats(), "canary": _GenStats()}
        self._staged: List = []
        #: accepting-flushes flag: True only while the judge window is
        #: open (routing also requires service._rollout is self)
        self._open = False
        self._canary_flushes = 0
        self._live_flushes = 0
        self._fallbacks = 0
        #: sampled canary rows for the optional divergence probe
        self._probe_rows: List[np.ndarray] = []
        self._used = False

    # ------------------------------------------------------ routing hook
    def take(self, flush) -> bool:
        """Batcher hook: claim ``flush`` for the canary generation.
        Returns True iff the flush was dispatched onto a staged replica
        (the batcher then skips its normal dispatch).  Deterministic:
        the seeded hash of the flush's first request id (falling back
        to the flush id for untraced services) against the configured
        fraction.  Never blocks and never raises — when no staged
        replica can take the flush (window full, breaker open) it falls
        back to the live generation and is counted
        (``serve.rollout.canary_fallbacks``)."""
        if not self._open:
            return False
        riders = flush.riders
        rid = None
        for r in riders:
            if getattr(r, "request_id", None) is not None:
                rid = r.request_id
                break
        if rid is None:
            rid = flush.bid
        if canary_hash(self.config.seed, rid) >= self.config.canary:
            self._mark(riders, "live")
            with self._lock:
                self._live_flushes += 1
            return False
        # tag riders BEFORE enqueueing: the staged worker may pop and
        # terminate them before take() returns
        self._mark(riders, "canary")
        try:
            chosen = self.service._pool.dispatch_staged(flush, self._staged)
        except Exception:
            logger.exception("canary dispatch failed; serving on live")
            chosen = None
        if chosen is None:
            self._mark(riders, "live")
            with self._lock:
                self._fallbacks += 1
            metrics.inc("serve.rollout.canary_fallbacks")
            return False
        with self._lock:
            self._canary_flushes += 1
            if (
                self.config.divergence_rtol is not None
                and len(self._probe_rows) < self.config.divergence_samples
            ):
                x = getattr(riders[0], "x", None)
                if x is not None:
                    self._probe_rows.append(np.array(x, copy=True))
        metrics.inc("serve.rollout.canary_flushes")
        return True

    @staticmethod
    def _mark(riders, gen: str) -> None:
        for r in riders:
            try:
                r.gen = gen
            except AttributeError:
                pass  # raw riders (tests) need no generation tag

    # -------------------------------------------------- terminal hook
    def observe(self, req, outcome: str, seconds: float) -> None:
        """Request-terminal hook (called from the service's ``_fail``
        and ``_deliver_completed`` next to the tenant accounting):
        attribute the outcome and latency to the rider's generation."""
        gen = getattr(req, "gen", None) or "live"
        with self._lock:
            st = self._stats.get(gen)
            if st is None:
                return
            st.outcomes[outcome] += 1
            if outcome in ("completed", "degraded"):
                st.latencies.append(seconds)

    def snapshot(self) -> dict:
        """Live per-generation stats (the /rolloutz canary block)."""
        with self._lock:
            return {
                "live": self._stats["live"].summary(),
                "canary": self._stats["canary"].summary(),
                "canary_flushes": self._canary_flushes,
                "live_flushes": self._live_flushes,
                "canary_fallbacks": self._fallbacks,
            }

    # ------------------------------------------------------------ episode
    def run(
        self,
        pipeline,
        version: Optional[str] = None,
        artifacts: Optional[dict] = None,
    ) -> dict:
        """The guarded swap: stage + prime ``pipeline`` (exactly the
        ``service.swap`` discipline), canary-serve the configured
        fraction until the judge decides, then commit or roll back.
        Returns an info dict — ``verdict`` is ``"committed"`` or
        ``"rolled_back"``, ``reason`` names the deciding guardrail; a
        commit's dict is a superset of ``swap``'s (version /
        pause_seconds / prime_seconds / replicas).  A rollback does NOT
        raise — the prior generation never stopped serving and the
        caller reads the verdict.

        Serialized under the service's swap lock for the WHOLE episode:
        a concurrent swap/scale waits out the canary window (bounded by
        ``decide_s``), and ``close()``'s bounded lock wait maps an
        in-flight canary to a rollback (the judge sees ``_closing``)."""
        if self._used:
            raise RuntimeError("CanaryController is single-use; build a new one")
        self._used = True
        svc = self.service
        cfg = self.config
        from keystone_tpu_torch.serve.service import ServiceClosed

        if svc._closing:
            raise ServiceClosed(f"service {svc.name!r} is closed")
        # a previous episode's bake guard is superseded by this rollout
        # — stop it BEFORE taking the swap lock (its revert path takes
        # the same lock; joining it while holding the lock would wedge)
        prev = svc._rollout_guard
        if prev is not None:
            prev.stop()
            svc._rollout_guard = None
        with svc._swap_lock:
            if svc._closing:
                raise ServiceClosed(f"service {svc.name!r} is closed")
            svc._swap_seq += 1
            version = version or f"swap{svc._swap_seq}"
            from_version = svc.version
            pool = svc._pool
            t0 = time.monotonic()
            state = {
                "phase": "staging",
                "version": version,
                "from_version": from_version,
                "canary_fraction": cfg.canary,
                "seed": cfg.seed,
            }
            svc._rollout_state = state
            verdict, reason = "rolled_back", "stage_failed"
            committed = False
            pause_s = prime_s = 0.0
            try:
                with ledger.span(
                    "serve.rollout",
                    version=version,
                    canary_fraction=cfg.canary,
                ):
                    fault_point("serve.rollout", version=version)
                    staged = pool.stage(pipeline, version, artifacts=artifacts)
                    self._staged = staged
                    try:
                        if svc._item_shape is not None:
                            svc.prime(
                                replicas=staged,
                                have_artifacts=artifacts is not None,
                            )
                        prime_s = time.monotonic() - t0
                        # the canary window: install the routing hook,
                        # judge, uninstall — the hook MUST come off
                        # before commit/abandon either way
                        state["phase"] = "canary"
                        self._open = True
                        svc._rollout = self
                        try:
                            verdict, reason = self._judge(state)
                        finally:
                            svc._rollout = None
                            self._open = False
                        if verdict == "committed":
                            # capture what a bake-period revert needs
                            # BEFORE commit moves the staged source in
                            prior_source = pool._source
                            prior_artifacts = pool._artifacts
                            pause_s = pool.commit(staged, version)
                            committed = True
                    finally:
                        if not committed:
                            self._abandon(staged)
            except BaseException:
                svc._rollout_state = None
                self._finish(state, verdict, "episode_error", from_version)
                raise
            seconds = time.monotonic() - t0
            info = {
                "version": version,
                "from_version": from_version,
                "verdict": verdict,
                "reason": reason,
                "canary_fraction": cfg.canary,
                "seconds": seconds,
                "canary": self.snapshot(),
            }
            if committed:
                info.update(
                    pause_seconds=pause_s,
                    prime_seconds=prime_s,
                    replicas=len(self._staged),
                )
                svc._version_history.append(from_version)
                metrics.inc("serve.swaps")
                metrics.inc("serve.rollout.commits")
                metrics.observe("serve.swap_pause_seconds", pause_s)
                metrics.observe("serve.swap_prime_seconds", prime_s)
                self._registry_commit(version)
                if cfg.bake_s > 0.0:
                    svc._rollout_guard = RollbackGuard(
                        svc,
                        cfg,
                        from_version=from_version,
                        to_version=version,
                        prior_source=prior_source,
                        prior_artifacts=prior_artifacts,
                        registry=self.registry,
                    ).start()
            else:
                metrics.inc("serve.rollout.rollbacks")
                self._registry_rollback(version, from_version, reason)
            svc._rollout_state = (
                None if svc._rollout_guard is None else svc._rollout_guard.status()
            )
            self._finish(state, verdict, reason, from_version)
            logger.info(
                "guarded rollout of %r to %s: %s (%s) — canary %.0f%% "
                "served %d flushes in %.2fs",
                svc.name,
                version,
                verdict,
                reason,
                100.0 * cfg.canary,
                self._canary_flushes,
                seconds,
            )
            return info

    # ------------------------------------------------------------- judge
    def _judge(self, state: dict):
        """Poll until a verdict: a guardrail violation rolls back
        immediately; a clean read at >= min_samples commits; the
        decide_s bound expiring maps to the configured insufficient-
        sample action.  ``service._closing`` aborts to rollback so
        ``close()`` never waits out a full canary window."""
        cfg = self.config
        svc = self.service
        deadline = time.monotonic() + cfg.decide_s
        while True:
            if svc._closing:
                return "rolled_back", "service_closing"
            with self._lock:
                canary_total = self._stats["canary"].total()
            state["canary_samples"] = canary_total
            if canary_total >= cfg.min_samples:
                violation = self._guardrails()
                if violation is not None:
                    return "rolled_back", violation
                divergence = self._divergence()
                if divergence is not None:
                    return "rolled_back", divergence
                return "committed", "guardrails_clean"
            if time.monotonic() >= deadline:
                if cfg.insufficient == "commit":
                    return "committed", "insufficient_samples"
                return "rolled_back", "insufficient_samples"
            time.sleep(cfg.poll_s)

    def _guardrails(self) -> Optional[str]:
        """First violated guardrail's name, or None when all clean."""
        cfg = self.config
        with self._lock:
            canary = self._stats["canary"]
            bad_rate = canary.bad() / max(1, canary.total())
            canary_p99 = canary.p99()
            live_p99 = self._stats["live"].p99()
        if bad_rate > cfg.max_error_rate:
            return "error_rate"
        burn = self.service.slo_burn()
        if (
            burn is not None
            and burn["burn_rate"] is not None
            and burn["window_requests"] >= cfg.min_samples
            and burn["burn_rate"] > cfg.max_burn
        ):
            return "slo_burn"
        if (
            cfg.p99_ratio is not None
            and canary_p99 is not None
            and live_p99 is not None
            and live_p99 > 0.0
            and canary_p99 > cfg.p99_ratio * live_p99
        ):
            return "p99_ratio"
        return None

    def _divergence(self) -> Optional[str]:
        """The optional dual-apply probe: sampled canary rows applied
        on one live AND one staged replica must agree within rtol.  A
        probe failure ON THE STAGED side is a rollback reason; a LIVE-
        side failure (or no live replica to probe) skips the probe —
        the canary must not be condemned for the old generation's
        faults."""
        cfg = self.config
        if cfg.divergence_rtol is None:
            return None
        with self._lock:
            rows = list(self._probe_rows)
        if not rows:
            return None
        svc = self.service
        live_rep = next(
            (r for r in svc._pool.replicas if r.routable()), None
        )
        staged_rep = next((r for r in self._staged if r.routable()), None)
        if live_rep is None or staged_rep is None:
            return None
        x = np.stack(rows)
        try:
            ref = np.asarray(svc._apply_rows(x, replica=live_rep, prime=True))
        except Exception as e:
            logger.warning("divergence probe skipped (live apply failed): %s", e)
            return None
        try:
            got = np.asarray(
                svc._apply_rows(x, replica=staged_rep, prime=True)
            )
        except Exception as e:
            logger.warning("divergence probe failed on canary: %s", e)
            return "divergence"
        if ref.shape != got.shape or not np.all(np.isfinite(got)):
            return "divergence"
        denom = np.maximum(np.abs(ref), 1e-6)
        if float(np.max(np.abs(got - ref) / denom)) > cfg.divergence_rtol:
            return "divergence"
        return None

    # ------------------------------------------------------------ outcome
    def _abandon(self, staged) -> None:
        """Retire + drain the staged generation without committing.
        Queued canary flushes the staged workers already drained served
        normally; leftovers (post-sentinel stragglers, a wedged staged
        worker's in-hand flush) re-dispatch onto the live generation —
        the scale-down discipline, zero lost futures."""
        svc = self.service
        from keystone_tpu_torch.serve.fleet import FleetUnavailable

        for flush in svc._pool.abandon_staged(staged):
            if getattr(flush, "unflushed", lambda: False)():
                svc._handle_stranded_flush(
                    flush, why="canary generation rolled back"
                )
            else:
                getattr(flush, "abort", lambda: False)()
                svc.fail_flush(
                    flush,
                    FleetUnavailable(
                        "canary generation rolled back with a flush "
                        "still in hand"
                    ),
                )

    def _registry_commit(self, version: str) -> None:
        """Move CURRENT to the committed version (admin-swap parity);
        best-effort — a pointer failure never un-commits the fleet."""
        reg = self.registry
        if reg is None:
            return
        try:
            if version in reg.versions() and reg.current() != version:
                reg.set_current(version)
        except Exception as e:
            logger.warning(
                "rollout committed %s but CURRENT update failed: %s",
                version,
                e,
            )

    def _registry_rollback(
        self, version: str, from_version: str, reason: str
    ) -> None:
        """Durably quarantine the condemned version and point CURRENT
        back at what the fleet still serves; best-effort."""
        reg = self.registry
        if reg is None:
            return
        try:
            if version in reg.versions():
                reg.quarantine(version, reason=f"rollout rollback: {reason}")
        except Exception as e:
            logger.warning("failed to quarantine %s: %s", version, e)
        try:
            if (
                reg.current() == version
                and from_version in reg.versions()
            ):
                reg.set_current(from_version)
        except Exception as e:
            logger.warning(
                "failed to restore CURRENT to %s: %s", from_version, e
            )

    def _finish(
        self, state: dict, verdict: str, reason: str, from_version: str
    ) -> None:
        """Record the episode terminal: history entry + recorder ops
        span + ledger event.  Never raises."""
        svc = self.service
        cfg = self.config
        entry = {
            "version": state.get("version"),
            "from_version": from_version,
            "verdict": verdict,
            "reason": reason,
            "canary_fraction": cfg.canary,
            "canary": self.snapshot(),
            "at": time.time(),
        }
        try:
            svc._rollout_history.append(entry)
            ledger.event(
                "serve.rollout",
                version=state.get("version"),
                from_version=from_version,
                to_version=state.get("version"),
                verdict=verdict,
                reason=reason,
                canary_fraction=cfg.canary,
            )
            rec = svc.recorder
            if rec is not None:
                rec.ops(
                    "serve.rollout",
                    version=state.get("version"),
                    from_version=from_version,
                    to_version=state.get("version"),
                    verdict=verdict,
                    reason=reason,
                    canary_fraction=cfg.canary,
                )
        except Exception:
            logger.exception("failed to record rollout terminal")


class RollbackGuard:
    """Post-commit bake watch: after a guarded rollout commits, keep
    reading the service's windowed SLO burn rate for ``bake_s`` seconds
    and revert to the prior generation (an ordinary ``service.swap``
    back to the captured source/artifacts) on sustained violation —
    burn above ``bake_max_burn`` for at least ``bake_sustain_s``, with
    at least ``min_samples`` requests in the burn window.  The revert
    quarantines the bad version in the registry and restores CURRENT,
    exactly like a pre-commit rollback.  Stopped by ``close()``, or
    superseded by the next guarded rollout."""

    def __init__(
        self,
        service,
        config: RolloutConfig,
        *,
        from_version: str,
        to_version: str,
        prior_source,
        prior_artifacts: Optional[dict] = None,
        registry=None,
    ):
        self.service = service
        self.config = config
        self.from_version = from_version
        self.to_version = to_version
        self.prior_source = prior_source
        self.prior_artifacts = prior_artifacts
        self.registry = registry
        self._stop = threading.Event()
        self._started = time.monotonic()
        self._outcome: Optional[str] = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serve-rollout-bake"
        )

    def start(self) -> "RollbackGuard":
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def status(self) -> dict:
        elapsed = time.monotonic() - self._started
        return {
            "phase": "bake",
            "version": self.to_version,
            "from_version": self.from_version,
            "bake_s": self.config.bake_s,
            "elapsed_s": round(elapsed, 3),
            "remaining_s": round(max(0.0, self.config.bake_s - elapsed), 3),
            "outcome": self._outcome,
        }

    def _loop(self) -> None:
        cfg = self.config
        svc = self.service
        end = self._started + cfg.bake_s
        bad_since: Optional[float] = None
        poll = max(cfg.poll_s, min(0.05, cfg.bake_sustain_s / 4.0 or 0.05))
        while not self._stop.wait(poll):
            now = time.monotonic()
            if svc._closing:
                self._outcome = "service_closing"
                return
            if now >= end:
                self._outcome = "bake_passed"
                metrics.inc("serve.rollout.bakes_passed")
                self._clear_guard()
                return
            burn = svc.slo_burn()
            violating = (
                burn is not None
                and burn["burn_rate"] is not None
                and burn["window_requests"] >= cfg.min_samples
                and burn["burn_rate"] > cfg.bake_max_burn
            )
            if violating:
                if bad_since is None:
                    bad_since = now
                elif now - bad_since >= cfg.bake_sustain_s:
                    self._revert(burn)
                    return
            else:
                bad_since = None
        self._outcome = "stopped"

    def _revert(self, burn: dict) -> None:
        """Sustained burn during the bake: swap back to the prior
        generation and quarantine the baked version."""
        svc = self.service
        self._outcome = "rolled_back"
        metrics.inc("serve.rollout.rollbacks")
        metrics.inc("serve.rollout.bake_rollbacks")
        logger.warning(
            "bake guard reverting %r from %s to %s: burn %.2f over %d "
            "requests",
            svc.name,
            self.to_version,
            self.from_version,
            burn["burn_rate"],
            burn["window_requests"],
        )
        try:
            svc.swap(
                self.prior_source,
                version=self.from_version,
                artifacts=self.prior_artifacts,
            )
        except Exception as e:
            self._outcome = "revert_failed"
            logger.exception("bake-guard revert failed: %s", e)
            return
        finally:
            self._clear_guard()
        reg = self.registry
        if reg is not None:
            try:
                if self.to_version in reg.versions():
                    reg.quarantine(
                        self.to_version,
                        reason=(
                            f"bake rollback: burn {burn['burn_rate']:.2f}"
                        ),
                    )
                if (
                    reg.current() == self.to_version
                    and self.from_version in reg.versions()
                ):
                    reg.set_current(self.from_version)
            except Exception as e:
                logger.warning(
                    "bake revert registry bookkeeping failed: %s", e
                )
        entry = {
            "version": self.from_version,
            "from_version": self.to_version,
            "verdict": "rolled_back",
            "reason": "bake_burn",
            "canary_fraction": self.config.canary,
            "at": time.time(),
        }
        svc._rollout_history.append(entry)
        ledger.event(
            "serve.rollout",
            from_version=self.to_version,
            to_version=self.from_version,
            verdict="rolled_back",
            reason="bake_burn",
        )
        rec = svc.recorder
        if rec is not None:
            rec.ops(
                "serve.rollout",
                from_version=self.to_version,
                to_version=self.from_version,
                verdict="rolled_back",
                reason="bake_burn",
            )

    def _clear_guard(self) -> None:
        svc = self.service
        if svc._rollout_guard is self:
            svc._rollout_guard = None
            svc._rollout_state = None


def guarded_swap(
    service,
    pipeline,
    version: Optional[str] = None,
    artifacts: Optional[dict] = None,
    config: Optional[RolloutConfig] = None,
    registry=None,
) -> dict:
    """Swap with the rollout guard when ``config`` carries a canary
    fraction, or the plain blue/green
    ``service.swap`` when it does not — the single entry point the
    HTTP admin endpoint and the registry watcher share."""
    if config is None or config.canary is None:
        return service.swap(pipeline, version=version, artifacts=artifacts)
    return CanaryController(service, config, registry=registry).run(
        pipeline, version=version, artifacts=artifacts
    )
