"""Process-wide deterministic fault injection (counterpart of
``keystone_tpu/faults.py``: the same plan grammar, environment variable,
sites, actions and seeded replay).

The reference inherited its failure modes *and* their remedies from
Spark: partial writes, flaky storage and worker death were absorbed by
lineage recompute and task retry.  The port's remedies are stage retry
and durable checkpoints, so the failure modes must be injectable on
demand or the recovery paths rot untested.  This module is the injection
side; ``keystone_tpu_torch.utils.durable`` is the survival side.

Named **sites** wired through the port::

    blockstore.read     FeatureBlockStore / RowBlockStore.read_block
    blockstore.write    append_rows (per block file)
    ckpt.save           durable.save_npz (write + publish phases)
    ckpt.load           durable.load_npz (per candidate file)
    stream.batch        loaders.stream.batched (each batch fetched)
    executor.stage      GraphExecutor stage execution (inside the retry
                        scope and the watchdog)
    kernel.sweep        the out-of-core kernel ridge sweep, once per
                        diagonal step
    serve.enqueue       PipelineService admission (each datum submitted)
    serve.batch         a flush's apply on its replica worker
    serve.replica       a replica's apply of one live flush (not primes)
    serve.worker        the replica worker loop, before it runs a flush
                        (a raise is a worker crash, a hang a wedge)
    serve.swap          PipelineService.swap, before it stages the new
                        generation
    serve.artifact_load ModelRegistry.load_artifacts (per file read) and
                        the fleet's install of a bundle into a replica
    serve.rollout       a guarded rollout episode, before it stages the
                        canary generation
    serve.net.connect   a network-fleet worker dialing the router
                        (serve/net.py)
    serve.net.send      one outbound stream frame, either side; ctx
                        ``link=NAME`` names the worker the frame is
                        to/from, ``role=router|worker`` names the side
    serve.net.recv      one inbound stream frame, either side (same ctx)
    plan.sample         one timed sample of a physical candidate in the
                        cost model (``planner/cost.py::wall_runner``);
                        ctx ``gate=``, ``candidate=``, ``n=``

The reference's other site, ``multihost.init`` (A8), joins with the slice
that wires it.  Until then a plan that names it raises
:class:`UnknownFaultSiteError`, as any unregistered site does: a site
nothing fires would report nothing.

A **plan** activates faults at sites, through the ``inject`` context
manager (tests) or the ``KEYSTONE_FAULTS`` environment variable (which
reaches a child process without plumbing)::

    KEYSTONE_FAULTS="ckpt.save:after=3:raise;blockstore.read:p=0.2:seed=7"

Plan grammar: ``site:token:token;site:token...`` where tokens are

- triggers: ``after=N`` (skip the first N matching calls), ``every=N``
  (then fire every Nth), ``p=F`` + ``seed=S`` (fire with probability F
  from a dedicated deterministic RNG), ``times=N`` (stop after N fires);
- actions: ``raise`` (default: :class:`FaultInjected`, an ``OSError``, so
  every transient-I/O retry path treats it as retryable), ``corrupt``
  (flip bytes in the site's file), ``truncate`` (halve the site's file),
  ``exit`` / ``exit=CODE`` (``os._exit``, the kill-worker action), and
  the latency actions ``delay=SECONDS`` (stall, then proceed) and
  ``hang`` (stall far past any deadline: ``KEYSTONE_HANG_SECONDS``,
  default 3600 s).  The stalls ride ``utils.guard.interruptible_sleep``,
  so a watchdog that gives up on the operation also unparks the stall.
  The wire action ``drop`` (alias ``partition``) is valid only at the
  ``serve.net.*`` sites, where the transport discards the frame silently
  (the peer sees silence, as in a partition); there ``corrupt`` flips a
  byte of the frame so the peer's CRC check condemns the connection;
- context matches: ``ctx.<key>=<value>`` restricts the spec to calls
  whose site context carries that value (string-compared), e.g.
  ``executor.stage:ctx.node=SIFTExtractor:raise``.  Non-matching calls do
  not advance the spec's triggers.

Everything is deterministic given the plan string and the call
sequence: probabilistic specs draw from a private ``random.Random(seed)``,
so the same plan over the same calls injects at the same call indices,
in this package and in the reference alike.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from collections import Counter
from contextlib import contextmanager
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

ENV_VAR = "KEYSTONE_FAULTS"

#: the sites wired through the codebase; plans naming anything else are
#: rejected at parse time (a typo'd site would otherwise never fire).
SITES = {
    "blockstore.read",
    "blockstore.write",
    "ckpt.save",
    "ckpt.load",
    "stream.batch",
    "executor.stage",
    "kernel.sweep",
    "serve.enqueue",
    "serve.batch",
    "serve.replica",
    "serve.worker",
    "serve.swap",
    "serve.artifact_load",
    "serve.rollout",
    "serve.net.connect",
    "serve.net.send",
    "serve.net.recv",
    "plan.sample",
}

_ACTIONS = ("raise", "corrupt", "truncate", "exit", "delay", "hang", "drop")

#: sites where file actions (corrupt) and the drop action are ADVISORY:
#: fault_point returns the action name and the transport applies it to
#: the in-flight frame (there is no file to damage and nothing local to
#: raise — a partition is silence, not an exception)
_WIRE_SITE_PREFIX = "serve.net."

# file-damaging actions only make sense once the file is durably
# published; failure actions fire while the operation is in flight.
# Two-phase sites (ckpt.save) pass phase="write" / phase="publish";
# single-phase sites pass no phase and accept every action.
_ACTION_PHASE = {"corrupt": "publish", "truncate": "publish"}


class FaultInjected(OSError):
    """An injected transient fault.  Subclasses ``OSError`` on purpose:
    every retry path that absorbs flaky storage/transport I/O absorbs
    injected faults identically — a plan with ``times=1`` at a retried
    site must be *survived*, and that is the behavior chaos tests pin."""

    def __init__(self, site: str, message: Optional[str] = None):
        super().__init__(message or f"injected fault at {site!r}")
        self.site = site


class FaultPlanError(ValueError):
    """A malformed ``KEYSTONE_FAULTS`` / ``inject`` plan string."""


class UnknownFaultSiteError(FaultPlanError):
    """A plan names a site that matches no registered site: a typo'd
    site (or one whose slice is not ported yet) would never fire, so it
    is rejected up front (parse time for plan strings, :func:`inject`
    time for hand-built :class:`FaultPlan` objects).  Carries the
    offending names and the registered set."""

    def __init__(self, unknown, known=None):
        self.unknown = sorted(unknown)
        self.known = sorted(known if known is not None else SITES)
        names = ", ".join(repr(s) for s in self.unknown)
        super().__init__(
            f"unknown fault site(s) {names}; registered sites: {self.known}"
        )


def validate_plan(plan: "FaultPlan") -> "FaultPlan":
    """Check every spec's site against the registered-site set; raises
    :class:`UnknownFaultSiteError` listing the offenders.  Plan strings
    are validated at parse time already: this covers plans built
    directly from :class:`SiteSpec` objects."""
    unknown = {s.site for s in plan.specs if s.site not in SITES}
    if unknown:
        raise UnknownFaultSiteError(unknown)
    return plan


class SiteSpec:
    """One parsed ``site:tokens`` clause plus its firing state."""

    def __init__(
        self,
        site: str,
        action: str = "raise",
        after: int = 0,
        every: int = 1,
        p: float = 1.0,
        seed: int = 0,
        times: Optional[int] = None,
        exit_code: int = 42,
        delay_seconds: float = 0.0,
        match: Optional[Dict[str, str]] = None,
    ):
        self.site = site
        self.action = action
        self.after = int(after)
        self.every = max(1, int(every))
        self.p = float(p)
        self.seed = int(seed)
        self.times = None if times is None else int(times)
        self.exit_code = int(exit_code)
        self.delay_seconds = float(delay_seconds)
        #: ctx.<key>=<value> clauses: the spec applies only to calls
        #: whose fault_point context matches every entry (str-compared)
        self.match = dict(match) if match else None
        self.reset()

    def matches(self, ctx: Dict) -> bool:
        if not self.match:
            return True
        return all(str(ctx.get(k)) == v for k, v in self.match.items())

    def reset(self) -> None:
        self.calls = 0
        self.fired = 0
        self._pending = False
        self._rng = random.Random(self.seed)

    def _advance(self) -> bool:
        """Consume one *operation* against the triggers."""
        self.calls += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.calls <= self.after:
            return False
        if (self.calls - self.after - 1) % self.every != 0:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self.fired += 1
        return True

    def should_fire(self, phase: Optional[str]) -> bool:
        """Decide whether this call fires the fault.  Triggers advance
        once per *operation*: two-phase sites evaluate them on the
        ``write`` call, and a publish-phase action (corrupt/truncate)
        carries that decision over to the matching ``publish`` call, so
        ``after=N`` counts saves, not phases."""
        want = _ACTION_PHASE.get(self.action)  # None or "publish"
        if phase is None:
            return self._advance()
        if phase == "write":
            fire = self._advance()
            if want == "publish":
                self._pending = fire
                return False
            return fire
        if phase == "publish" and want == "publish":
            fire, self._pending = self._pending, False
            return fire
        return False


class FaultPlan:
    """An ordered set of :class:`SiteSpec`, activated as a unit."""

    def __init__(self, specs: List[SiteSpec], source: str = ""):
        self.specs = specs
        self.source = source

    def for_site(self, site: str) -> List[SiteSpec]:
        return [s for s in self.specs if s.site == site]

    def reset(self) -> None:
        for s in self.specs:
            s.reset()


def parse_plan(text: str) -> FaultPlan:
    """Parse the ``KEYSTONE_FAULTS`` grammar into a :class:`FaultPlan`."""
    specs: List[SiteSpec] = []
    for clause in text.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        tokens = [t.strip() for t in clause.split(":")]
        site = tokens[0]
        if site not in SITES:
            raise UnknownFaultSiteError({site})
        kwargs: Dict = {}
        for tok in tokens[1:]:
            if not tok:
                continue
            key, _, val = tok.partition("=")
            if key in _ACTIONS and not val and key != "delay":
                kwargs["action"] = key
            elif key == "partition" and not val:
                # chaos-drill vocabulary: a partition IS dropped frames
                kwargs["action"] = "drop"
            elif key == "exit":
                kwargs["action"] = "exit"
                kwargs["exit_code"] = int(val)
            elif key == "delay":
                try:
                    kwargs["delay_seconds"] = float(val)
                except ValueError:
                    raise FaultPlanError(
                        f"delay needs seconds (delay=0.5), got {tok!r} in "
                        f"clause {clause!r}"
                    )
                kwargs["action"] = "delay"
            elif key == "after":
                kwargs["after"] = int(val)
            elif key == "every":
                kwargs["every"] = int(val)
            elif key == "times":
                kwargs["times"] = int(val)
            elif key == "p":
                kwargs["p"] = float(val)
            elif key == "seed":
                kwargs["seed"] = int(val)
            elif key.startswith("ctx."):
                if not val:
                    raise FaultPlanError(
                        f"context match needs a value (ctx.replica=0), "
                        f"got {tok!r} in clause {clause!r}"
                    )
                kwargs.setdefault("match", {})[key[4:]] = val
            else:
                raise FaultPlanError(
                    f"bad fault token {tok!r} in clause {clause!r}"
                )
        if kwargs.get("action") == "drop" and not site.startswith(
            _WIRE_SITE_PREFIX
        ):
            raise FaultPlanError(
                f"drop/partition is a wire action; it is honored only "
                f"at {_WIRE_SITE_PREFIX}* sites, not {site!r} (the site "
                f"would silently ignore it)"
            )
        specs.append(SiteSpec(site, **kwargs))
    return FaultPlan(specs, source=text)


# --------------------------------------------------------------- runtime

_LOCK = threading.Lock()
_STACK: List[FaultPlan] = []  # inject() plans, innermost last
_ENV_PLAN: Optional[FaultPlan] = None
_ENV_TEXT: Optional[str] = None  # the string _ENV_PLAN was parsed from

CALLS: Counter = Counter()  # site -> fault_point calls (operations)
INJECTED: Counter = Counter()  # site -> faults actually applied


def _env_plan() -> Optional[FaultPlan]:
    """The plan from ``KEYSTONE_FAULTS``, reparsed whenever the env value
    changes, so tests that set it and freshly spawned child processes
    both pick it up without an install call."""
    global _ENV_PLAN, _ENV_TEXT
    text = os.environ.get(ENV_VAR)
    if text != _ENV_TEXT:
        _ENV_TEXT = text
        _ENV_PLAN = parse_plan(text) if text else None
        if _ENV_PLAN is not None:
            logger.info("fault plan active from %s: %s", ENV_VAR, text)
    return _ENV_PLAN


def active_plans() -> List[FaultPlan]:
    plans = list(_STACK)
    env = _env_plan()
    if env is not None:
        plans.append(env)
    return plans


@contextmanager
def inject(plan):
    """Activate a fault plan for a ``with`` block (tests).  ``plan`` is a
    plan string or a :class:`FaultPlan`; trigger counters start fresh on
    entry so the block is a deterministic replay unit."""
    p = parse_plan(plan) if isinstance(plan, str) else plan
    # hand-built FaultPlan objects bypass parse_plan's site check;
    # validate here so a typo'd site fails loudly instead of never firing
    validate_plan(p)
    p.reset()
    with _LOCK:
        _STACK.append(p)
    try:
        yield p
    finally:
        with _LOCK:
            _STACK.remove(p)


def reset_stats() -> None:
    with _LOCK:
        CALLS.clear()
        INJECTED.clear()


def stats() -> Dict[str, Dict[str, int]]:
    """Per-site ``{"calls": n, "injected": m}`` since the last reset."""
    with _LOCK:
        sites = set(CALLS) | set(INJECTED)
        return {
            s: {"calls": CALLS[s], "injected": INJECTED[s]} for s in sites
        }


def _corrupt_file(path: str) -> None:
    """Flip a byte run in the middle of ``path`` (content damage the
    length/np.load checks cannot see — only a checksum catches it)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(16) or b"\0"
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))


def _truncate_file(path: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


def fault_point(site: str, path: Optional[str] = None, phase: Optional[str] = None, **ctx) -> Optional[str]:
    """The injection hook threaded through the codebase.

    No active plan ⇒ a counter bump and an immediate return (the hot
    paths pay one dict lookup).  With a matching spec it raises
    :class:`FaultInjected`, damages the file at ``path``, or exits the
    process, per the spec's action.  File actions with no ``path`` fall
    back to raising, so a plan never silently does nothing — EXCEPT at
    the ``serve.net.*`` sites, where ``drop`` and ``corrupt`` are
    advisory: the fired action name is RETURNED and the transport
    applies it to the in-flight frame (discard it / flip its bytes).
    Every other path returns ``None``; existing call sites ignore the
    return value unchanged.
    """
    from keystone_tpu_torch.obs import metrics

    with _LOCK:
        if phase != "publish":  # two-phase sites count once per operation
            CALLS[site] += 1
        plans = list(_STACK)
    if phase != "publish":
        # outside _LOCK: the registry has its own lock, and the mirror
        # needs nothing from this module's critical section
        metrics.inc("faults.calls", site=site)
    env = _env_plan()
    if env is not None:
        plans.append(env)
    if not plans:
        return None
    advisory: Optional[str] = None
    for plan in reversed(plans):  # innermost inject() wins
        for spec in plan.for_site(site):
            if not spec.matches(ctx):
                continue  # triggers advance on MATCHING calls only
            with _LOCK:
                fire = spec.should_fire(phase)
                if fire:
                    INJECTED[site] += 1
            if not fire:
                continue
            # mirrored into the unified metrics registry so chaos
            # reports and run ledgers read fault outcomes from the same
            # place as every other subsystem (and survive reset_stats)
            metrics.inc("faults.injected", site=site)
            logger.warning(
                "fault injected at %s (action=%s%s)",
                site,
                spec.action,
                f", path={path}" if path else "",
            )
            if spec.action == "exit":
                os._exit(spec.exit_code)
            if spec.action == "drop":
                # a partition is silence: hand the verdict back to the
                # transport (which skips the send / discards the recv)
                # and keep scanning — a co-active raise still wins
                advisory = "drop"
                continue
            if spec.action == "corrupt" and site.startswith(
                _WIRE_SITE_PREFIX
            ):
                advisory = advisory or "corrupt"
                continue
            if spec.action in ("delay", "hang"):
                # latency, not failure: stall the operation in flight,
                # then let it proceed.  The sleep is cancel-aware
                # (guard.interruptible_sleep) so a watchdog that gave up
                # on this operation also unparks the injected stall.
                from keystone_tpu_torch.utils import guard

                seconds = (
                    spec.delay_seconds
                    if spec.action == "delay"
                    else guard.hang_seconds()
                )
                guard.interruptible_sleep(seconds)
                continue
            if spec.action == "corrupt" and path and os.path.exists(path):
                _corrupt_file(path)
                continue  # damage is silent: the *load* must detect it
            if spec.action == "truncate" and path and os.path.exists(path):
                _truncate_file(path)
                continue
            raise FaultInjected(site)
    return advisory
