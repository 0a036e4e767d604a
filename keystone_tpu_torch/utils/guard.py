"""Deadlines, watchdogs and circuit breakers: the time half of the fault
contract (counterpart of ``keystone_tpu/utils/guard.py``).

The retry machinery (``utils/durable.with_retries``, the executor's stage
retry, ``loaders/stream.resilient``) only fires when a site *raises*; a
stage or stream source that silently hangs stalls the whole pipeline.
This module supplies that failure mode's remedies, as Spark's task
timeouts gave the reference:

- :class:`Deadline`: an absolute wall-clock budget (``remaining()``,
  ``expired()``, ``child()`` sub-budgets that never outlive the parent);
- :func:`run_with_deadline`: a watchdog.  The work runs on a worker
  thread, the caller waits at most the budget, and an overrun raises
  :class:`DeadlineExceeded`, deliberately an ``OSError``, so every
  transient-I/O retry path treats a hang exactly like a flaky read.  The
  abandoned worker is signalled through a cooperative cancel flag
  (:func:`current_cancel` / :func:`interruptible_sleep`), so an injected
  ``hang`` unblocks promptly.  On a CUDA device the worker runs on the
  caller's current device and stream (both belong to a thread in torch);
- :class:`CircuitBreaker`: per key, closed → open (after N consecutive
  failures) → half-open (one probe after ``reset_timeout``) → closed,
  every transition mirrored into ``obs.metrics`` (``breaker.state{key=…}``
  gauge, ``breaker.opens`` counter) and the run ledger
  (``breaker.transition`` events).  :func:`breaker` is the process-wide
  per-key registry the executor consults;
- :class:`Heartbeat`: a renewable deadline, the liveness half of
  supervision.

Default-off and inert: with no deadline ``run_with_deadline(fn, None)``
is one ``None`` check around ``fn()`` (no thread), and without
``KEYSTONE_BREAKER_THRESHOLD`` the executor never touches the registry.

Environment knobs (all unset by default):

- ``KEYSTONE_STAGE_DEADLINE``: seconds per executor stage attempt;
- ``KEYSTONE_BREAKER_THRESHOLD``: consecutive stage failures before a
  node's breaker opens (unset: breakers off);
- ``KEYSTONE_BREAKER_RESET``: seconds an open breaker waits before a
  half-open probe (default 30);
- ``KEYSTONE_HANG_SECONDS``: how long the injected ``hang`` action sleeps
  (default 3600, far past any sane deadline; cancel-aware).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional

from keystone_tpu_torch.obs import ledger, metrics

logger = logging.getLogger(__name__)

ENV_STAGE_DEADLINE = "KEYSTONE_STAGE_DEADLINE"
ENV_BREAKER_THRESHOLD = "KEYSTONE_BREAKER_THRESHOLD"
ENV_BREAKER_RESET = "KEYSTONE_BREAKER_RESET"
ENV_HANG_SECONDS = "KEYSTONE_HANG_SECONDS"


class DeadlineExceeded(OSError):
    """A guarded operation overran its budget.  Subclasses ``OSError``
    on purpose (the :class:`~keystone_tpu_torch.faults.FaultInjected`
    precedent): every retry path that absorbs transient I/O absorbs
    overruns identically, so a hang under a deadline becomes a retried —
    or gracefully degraded — operation instead of a stalled pipeline."""

    def __init__(self, site: str, budget_seconds: float):
        super().__init__(
            f"deadline exceeded at {site!r} after {budget_seconds:.3f}s"
        )
        self.site = site
        self.budget_seconds = budget_seconds
        #: the abandoned watchdog worker (None for a born-expired
        #: deadline).  Callers that want to RESUME the timed-out
        #: resource — the stream layer continuing a batch-resumable
        #: iterator — can briefly ``worker.join()`` to learn whether the
        #: resource has been vacated (cancel-aware work exits promptly)
        #: or is still occupied (use a fresh resource instead).
        self.worker: Optional[threading.Thread] = None


class CircuitOpenError(RuntimeError):
    """An operation was refused because its circuit breaker is open.
    Deliberately NOT an ``OSError``: immediately retrying a tripped
    breaker is futile by definition — recovery is time-based (the
    half-open probe) or structural (a fallback node)."""


def env_float(name: str) -> Optional[float]:
    """Positive float from the environment, or None: unset, empty, zero,
    negative and non-numeric (warned) all mean "disabled", uniformly for
    every time-like knob."""
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        logger.warning("%s=%r is not a number; ignoring", name, raw)
        return None
    return v if v > 0 else None


class Deadline:
    """An absolute wall-clock budget (monotonic-clock based).

    ``Deadline.after(5.0)`` expires five seconds from now; ``child()``
    derives a sub-budget that can only tighten — a stage budget
    apportioned from a pipeline budget never outlives the pipeline."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = float(at)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + float(seconds))

    def remaining(self) -> float:
        """Seconds left (negative when expired)."""
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def child(self, seconds: Optional[float] = None) -> "Deadline":
        """A sub-budget: at most ``seconds`` from now, never past this
        deadline.  ``seconds=None`` = inherit the parent's expiry."""
        if seconds is None:
            return Deadline(self.at)
        return Deadline(min(self.at, time.monotonic() + float(seconds)))

    def __repr__(self):
        return f"Deadline(remaining={self.remaining():.3f}s)"


class Heartbeat:
    """A renewable :class:`Deadline`: ``beat()`` pushes the expiry
    ``timeout`` seconds into the future, ``expired()`` reports whether
    the holder has gone silent past it.  The liveness half of the
    supervision contract — a worker thread beats once per loop
    iteration, and a supervisor that finds the heartbeat expired while
    work is outstanding knows the worker is wedged (stuck inside one
    operation), as opposed to dead (thread exited), which plain thread
    liveness already shows.  Thread-safe: one writer (the worker), any
    number of readers (the supervisor)."""

    __slots__ = ("timeout", "_deadline")

    def __init__(self, timeout: float):
        self.timeout = float(timeout)
        self._deadline = Deadline.after(self.timeout)

    def beat(self) -> None:
        # a fresh Deadline object per beat: assignment is atomic, so
        # readers never observe a half-updated expiry (no lock needed)
        self._deadline = Deadline.after(self.timeout)

    def expired(self) -> bool:
        return self._deadline.expired()

    def remaining(self) -> float:
        return self._deadline.remaining()

    def __repr__(self):
        return f"Heartbeat(timeout={self.timeout}, remaining={self.remaining():.3f}s)"


def as_deadline(value) -> Optional[Deadline]:
    """Coerce a user-facing budget (None, seconds, or a Deadline) into
    an Optional[Deadline] — the one conversion every ``deadline=`` API
    parameter shares."""
    if value is None or isinstance(value, Deadline):
        return value
    return Deadline.after(float(value))


# ------------------------------------------------- cooperative cancellation

_TLS = threading.local()


def current_cancel() -> Optional[threading.Event]:
    """The cancel flag of the enclosing :func:`run_with_deadline` scope
    (None outside one).  Long-running cooperative code — notably the
    injected ``hang``/``delay`` fault actions — polls this so abandoned
    watchdog workers unblock promptly after their caller gave up."""
    return getattr(_TLS, "cancel", None)


def interruptible_sleep(seconds: float) -> None:
    """``time.sleep`` that wakes early when the enclosing watchdog
    cancels.  Outside a deadline scope it is a plain sleep — which is
    exactly what a ``hang`` injection without a configured deadline
    should be: a real hang."""
    cancel = current_cancel()
    if cancel is None:
        time.sleep(seconds)
        return
    cancel.wait(timeout=seconds)


def run_with_deadline(
    fn: Callable,
    deadline: Optional[Deadline],
    site: str = "guard",
    **attrs,
):
    """Run ``fn()`` under a watchdog.

    ``deadline=None`` (the default everywhere) is the inert path: one
    ``None`` check, then ``fn()`` on the calling thread — no thread, no
    queue, no overhead.  With a deadline, ``fn`` runs on a daemon worker
    thread while the caller waits at most ``deadline.remaining()``; an
    overrun sets the worker's cooperative cancel flag, emits a
    ``deadline_exceeded`` ledger event plus a
    ``guard.deadline_exceeded{site=…}`` counter, and raises
    :class:`DeadlineExceeded` (an ``OSError`` — the caller's retry
    machinery owns what happens next).  The abandoned worker's eventual
    result is discarded.

    ``fn`` must not depend on running on the calling thread (the
    executor's stage bodies and stream fetches — the wired sites — do
    not).  A worker exception re-raises in the caller unchanged.

    Caveat — the watchdog ABANDONS, it cannot kill: a slow-but-alive
    ``fn`` keeps running (and keeps its side effects) concurrently with
    whatever the caller does next, until it finishes or polls the
    cancel flag.  The wired sites are safe by construction: stages are
    pure functions of memoized inputs and the durable layer's tmp names
    are per-thread with atomic last-writer-wins publication
    (``durable.atomic_write``), so a retried attempt racing its
    abandoned twin converges on the same bytes.  Two real limits
    remain: (1) budget deadlines well below a stage's honest runtime
    cause duplicated work, not faster runs; (2) on MULTI-HOST jobs a
    deadline must not be set below collective completion time — an
    abandoned attempt parked inside a collective desynchronizes peers.

    On a CUDA device the worker enters the caller's current device and
    stream (torch keeps both per thread), so the stage's kernels queue
    where the caller's would have.  An abandoned attempt keeps the
    kernels it queued, but its result is dropped as soon as it returns:
    it never reaches the caller, and the caching allocator gets its
    memory back."""
    if deadline is None:
        return fn()
    budget = deadline.remaining()
    if budget <= 0.0:
        _deadline_exceeded(site, 0.0, **attrs)
    cancel = threading.Event()
    out: list = []
    err: list = []
    # the ledger's open-span stack is thread-local: carry the caller's
    # into the worker so spans/events emitted by fn (solver epochs,
    # blockstore spans) keep nesting under the caller's open span
    # exactly as they would without a watchdog
    obs_ctx = ledger.capture_context()
    stream = _caller_stream()

    def work():
        _TLS.cancel = cancel
        ledger.restore_context(obs_ctx)
        try:
            if stream is None:
                r = fn()
            else:
                import torch

                with torch.cuda.device(stream.device), torch.cuda.stream(stream):
                    r = fn()
            if not cancel.is_set():
                out.append(r)
            del r
        except BaseException as e:  # surfaced to the caller below
            if not cancel.is_set():
                err.append(e)
        finally:
            _TLS.cancel = None

    t = threading.Thread(
        target=work, daemon=True, name=f"guard-watchdog:{site}"
    )
    t.start()
    t.join(budget)
    if t.is_alive():
        cancel.set()
        _deadline_exceeded(site, budget, worker=t, **attrs)
    if err:
        raise err[0]
    return out[0] if out else None


def _caller_stream():
    """The calling thread's current CUDA stream, or None where torch has
    not initialized CUDA (nothing to carry over; CUDA is never
    initialized here)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_stream()


def _deadline_exceeded(
    site: str, budget: float, worker: Optional[threading.Thread] = None, **attrs
):
    metrics.inc("guard.deadline_exceeded", site=site)
    ledger.event(
        "deadline_exceeded", site=site, budget_seconds=budget, **attrs
    )
    logger.warning(
        "deadline exceeded at %s (budget %.3fs)%s",
        site,
        budget,
        f" {attrs}" if attrs else "",
    )
    exc = DeadlineExceeded(site, budget)
    exc.worker = worker
    raise exc


# ---------------------------------------------------------- circuit breaker

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"

#: numeric encoding for the ``breaker.state`` gauge (dashboards sort it)
_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}

DEFAULT_THRESHOLD = 3
DEFAULT_RESET_SECONDS = 30.0


class CircuitBreaker:
    """Closed → open after ``threshold`` CONSECUTIVE failures; open →
    half-open (exactly one probe admitted) once ``reset_timeout``
    elapses; the probe's success closes the breaker, its failure
    re-opens it and restarts the clock.

    Thread-safe.  Transitions mirror into the metrics registry
    (``breaker.state{key=…}`` gauge, ``breaker.opens{key=…}`` counter)
    and the run ledger (``breaker.transition`` events) — the chaos
    report and obs stack read breaker history from the same place as
    every other subsystem.  ``clock`` is injectable for tests."""

    def __init__(
        self,
        key: str,
        threshold: int = DEFAULT_THRESHOLD,
        reset_timeout: float = DEFAULT_RESET_SECONDS,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.key = key
        self.threshold = max(1, int(threshold))
        self.reset_timeout = float(reset_timeout)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        self._probe_started: Optional[float] = None
        metrics.set_gauge("breaker.state", _STATE_GAUGE[CLOSED], key=key)

    # internal: must hold self._lock; returns the transition to report
    def _to(self, new_state: str) -> tuple:
        old, self._state = self._state, new_state
        if new_state == OPEN:
            self._opened_at = self._clock()
        self._probing = False
        self._probe_started = None
        return (old, new_state)

    def _resolve_locked(self) -> Optional[tuple]:
        """Time-based open→half-open promotion; returns a transition to
        report or None."""
        if (
            self._state == OPEN
            and self._opened_at is not None
            and self._clock() - self._opened_at >= self.reset_timeout
        ):
            return self._to(HALF_OPEN)
        if (
            self._state == HALF_OPEN
            and self._probing
            and self._probe_started is not None
            and self._clock() - self._probe_started >= self.reset_timeout
        ):
            # the admitted probe's outcome was never recorded (its
            # caller died, or its failure was deliberately not charged
            # — e.g. an executor attempt born after the run budget
            # blew): presume the probe lost and admit a fresh one, or
            # the breaker would wedge in half-open refusing everything
            # forever
            self._probing = False
            self._probe_started = None
        return None

    def _report(self, transition: Optional[tuple]) -> None:
        """Emit a transition OUTSIDE the breaker lock (the ledger and
        registry have their own locks; no nesting, no ordering hazard)."""
        if transition is None:
            return
        old, new = transition
        metrics.set_gauge("breaker.state", _STATE_GAUGE[new], key=self.key)
        if new == OPEN:
            metrics.inc("breaker.opens", key=self.key)
        ledger.event(
            "breaker.transition", key=self.key, from_state=old, to_state=new
        )
        logger.warning("breaker %r: %s -> %s", self.key, old, new)

    def state(self) -> str:
        with self._lock:
            tr = self._resolve_locked()
        self._report(tr)
        return self._state

    def allow(self) -> bool:
        """May the caller attempt the operation?  Closed: yes.  Open:
        no — until ``reset_timeout`` elapses, when exactly ONE caller is
        admitted as the half-open probe."""
        with self._lock:
            tr = self._resolve_locked()
            if self._state == CLOSED:
                allowed = True
            elif self._state == HALF_OPEN and not self._probing:
                self._probing = True
                self._probe_started = self._clock()
                allowed = True
            else:
                allowed = False
        self._report(tr)
        return allowed

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            tr = self._to(CLOSED) if self._state != CLOSED else None
        self._report(tr)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            tr = None
            if self._state == HALF_OPEN or (
                self._state == CLOSED and self._failures >= self.threshold
            ):
                tr = self._to(OPEN)
        self._report(tr)

    def seconds_until_probe(self) -> float:
        """Seconds until this breaker would admit traffic again: 0 for
        closed/half-open, else the remaining open window before the
        half-open probe.  Read-only — unlike :meth:`allow` it neither
        consumes the probe slot nor transitions state, so availability
        checks (a 503's derived ``Retry-After``) can poll it freely."""
        with self._lock:
            if self._state != OPEN or self._opened_at is None:
                return 0.0
            return max(
                0.0, self.reset_timeout - (self._clock() - self._opened_at)
            )


# process-wide per-key registry (the executor's per-node breakers;
# mirrors the faults/metrics module-global convention)
_BREAKERS: Dict[str, CircuitBreaker] = {}
_REG_LOCK = threading.Lock()

#: soft cap on registered breakers: object-identity-keyed breakers
#: (signatureless nodes in processes that build a fresh graph per
#: request) would otherwise accumulate forever.  At the cap, CLOSED
#: failure-free breakers are evicted oldest-first — open/half-open
#: state is load-bearing and is never dropped — along with their
#: ``breaker.state`` gauge series, so metrics cardinality stays
#: bounded too.
REGISTRY_CAP = 1024


def _evict_closed_locked() -> None:
    """Must hold _REG_LOCK.  Reading b._state without b's own lock is a
    benign heuristic here: a breaker mid-transition is simply kept."""
    for k in list(_BREAKERS):
        if len(_BREAKERS) <= REGISTRY_CAP // 2:
            break
        b = _BREAKERS[k]
        if b._state == CLOSED and b._failures == 0:
            del _BREAKERS[k]
            metrics.REGISTRY.remove_gauge("breaker.state", key=k)


def breaker(
    key: str,
    threshold: Optional[int] = None,
    reset_timeout: Optional[float] = None,
) -> CircuitBreaker:
    """The process-wide breaker for ``key``, created on first use.
    ``threshold``/``reset_timeout`` configure creation only — an
    existing breaker keeps its settings (per-key state must be stable
    across executors, which is the point of the registry)."""
    with _REG_LOCK:
        b = _BREAKERS.get(key)
        if b is None:
            if len(_BREAKERS) >= REGISTRY_CAP:
                _evict_closed_locked()
            b = _BREAKERS[key] = CircuitBreaker(
                key,
                threshold=threshold
                if threshold is not None
                else DEFAULT_THRESHOLD,
                reset_timeout=reset_timeout
                if reset_timeout is not None
                else breaker_reset_seconds(),
            )
        return b


def reset_breakers() -> None:
    """Drop every registered breaker (tests; a fresh chaos window),
    including their ``breaker.state`` gauge series."""
    with _REG_LOCK:
        for k in _BREAKERS:
            metrics.REGISTRY.remove_gauge("breaker.state", key=k)
        _BREAKERS.clear()


# ------------------------------------------------------------- env resolution


def stage_deadline_seconds() -> Optional[float]:
    """Per-stage attempt budget from ``KEYSTONE_STAGE_DEADLINE``
    (seconds); None = no per-stage deadline.  Resolved at executor
    construction, not import, so post-import env changes take effect."""
    return env_float(ENV_STAGE_DEADLINE)


def stage_breaker_threshold() -> Optional[int]:
    """Per-node breaker threshold from ``KEYSTONE_BREAKER_THRESHOLD``;
    None = breakers disabled (the executor never touches the registry)."""
    v = env_float(ENV_BREAKER_THRESHOLD)
    return None if v is None else max(1, int(v))


def breaker_reset_seconds() -> float:
    return env_float(ENV_BREAKER_RESET) or DEFAULT_RESET_SECONDS


def hang_seconds() -> float:
    """How long the injected ``hang`` fault action sleeps — far past any
    sane deadline by default, and cancel-aware either way."""
    return env_float(ENV_HANG_SECONDS) or 3600.0
