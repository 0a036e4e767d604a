"""Run ledger: a per-run JSONL span/event stream (counterpart of
``keystone_tpu/obs/ledger.py``; the Dapper-style trace the reference got
from Spark's event log).

One **run** = one JSONL file ``run_<run_id>.jsonl`` under the ledger
directory.  Every line is one event::

    {"ts": <unix seconds>, "run_id": "...", "seq": <monotonic int>,
     "kind": "run_start"|"span_start"|"span_end"|"event"|"metrics",
     "name": "...", "span": <id>, "parent": <id|null>, "attrs": {...}}

``span_end`` lines also carry ``"seconds"`` (wall duration) and the final
attrs (spans accumulate attrs while open: the executor records attempt
counts this way).  The schema and the file names are the reference's, so
a ledger reader works on either package's runs.

Activation, default OFF and inert:

- ``KEYSTONE_OBS_DIR=<dir>`` activates a process-wide ledger lazily (the
  first ``span``/``event`` call creates it, ``atexit`` closes it);
- ``start_run(dir)`` / ``stop_run()`` scope a ledger explicitly (an
  explicit run wins over the env one).

With neither, every hook reduces to one ``None`` check (plus one
``os.environ`` lookup): no synchronize, no host copy.

Where the reference touches its JAX backend, this module touches torch:

- spans open a ``torch.profiler.record_function`` of their name, so
  ledger stages show up by name in ``chip_smoke.py --profile``'s traces;
- span boundaries sample the CUDA caching allocator's in-use and peak
  bytes (``torch.cuda.memory_stats`` of the current device, only once
  CUDA is initialized) into the gauges ``hbm.bytes_in_use`` /
  ``hbm.peak_bytes_in_use``, and the host's peak RSS into
  ``host.max_rss_bytes``;
- :func:`device_wait` synchronizes the device of the tensors it is given,
  and only while a ledger is active (or when forced);
- solver telemetry is a plain host call (:func:`solver_epoch`): the
  port's solver loops are eager, so no traced-callback emitter is needed.

Long-lived runs rotate past ``KEYSTONE_OBS_MAX_BYTES`` into keep-N
numbered segments (``KEYSTONE_OBS_KEEP_SEGMENTS``).
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Optional

from keystone_tpu_torch.obs import metrics

ENV_DIR = "KEYSTONE_OBS_DIR"
#: size cap (bytes) per ledger segment before rotation; unset = no cap.
#: A long-lived ``serve --watch`` process with KEYSTONE_OBS_DIR set
#: appends forever — without a cap it eventually fills the disk.
ENV_MAX_BYTES = "KEYSTONE_OBS_MAX_BYTES"
#: rotated segments kept per run (oldest pruned); default 8
ENV_KEEP_SEGMENTS = "KEYSTONE_OBS_KEEP_SEGMENTS"

DEFAULT_KEEP_SEGMENTS = 8

#: Registered span/event attribute-key vocabulary (the reference's set, so
#: a ledger reader's keys are the same in both packages).  Add a key here
#: when introducing a genuinely new attribute.
ATTR_VOCABULARY = {
    "action",
    "apply_seconds",
    "attempt",
    "attempts",
    "batch",
    "bucket",
    "budget_bytes",
    "budget_seconds",
    "cache_hits",
    "canary_fraction",
    "checkpoint_save_seconds",
    "chunk_seconds",
    "degraded",
    "depth",
    "epoch",
    "epoch_seconds",
    "error",
    "failed_attempt_seconds",
    "from_state",
    "from_replica",
    "from_version",
    "grad_norm",
    "host",
    "instances",
    "it",
    "key",
    "knob",
    "late",
    "leader",
    "n",
    "no_memoize_demotions",
    "node",
    "node_id",
    "objective",
    "occupancy",
    "outcome",
    "path",
    "pause_seconds",
    "pid",
    "pinned_bytes",
    "poisons",
    "predicted_seconds",
    "prime_seconds",
    "queue_depth",
    "queue_wait_seconds",
    "reason",
    "replica",
    "replicas",
    "request_id",
    "request_ids",
    "restarts",
    "retries",
    "refused",
    "rows",
    "rule",
    "seconds",
    "shared_bytes",
    "shared_nodes",
    "shared_stages",
    "sick",
    "site",
    "solver",
    "source",
    "stages",
    "stats",
    "substitute",
    "tag",
    "tenant",
    "tenants",
    "to_state",
    "to_replica",
    "to_version",
    "verdict",
    "version",
    "waited_seconds",
    "wire",
    "worker",
    "worker_spans",
    "workers",
}

#: per-process run discriminator: time.time() alone has 1-second
#: resolution, and two runs started within the same second would
#: silently append into the same JSONL file
_RUN_COUNTER = itertools.count()


def _env_int(name: str) -> Optional[int]:
    """Non-negative int from the environment, or None (unset, empty,
    or non-numeric — warned-free: the ledger must never fail to open
    over a malformed knob)."""
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        v = int(raw)
    except ValueError:
        return None
    return v if v >= 0 else None


def _json_safe(v):
    """Best-effort JSON coercion: numpy scalars/arrays and exotic
    objects must never kill the instrumented path."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_json_safe(x) for x in v]
    item = getattr(v, "item", None)  # numpy scalar / 0-d array
    if callable(item):
        try:
            return _json_safe(item())
        except Exception:
            pass
    tolist = getattr(v, "tolist", None)
    if callable(tolist):
        try:
            return _json_safe(tolist())
        except Exception:
            pass
    return str(v)


def _sample_memory() -> Dict[str, float]:
    """The CUDA caching allocator's in-use bytes on the current device
    (once CUDA is initialized) plus host peak RSS.  Best-effort: a CPU
    run has no device stats, and sampling never initializes CUDA."""
    out: Dict[str, float] = {}
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stats = torch.cuda.memory_stats()
            used = stats.get("allocated_bytes.all.current")
            if used is not None:
                out["hbm_bytes_in_use"] = float(used)
                metrics.gauge_max("hbm.bytes_in_use", float(used))
                peak = stats.get("allocated_bytes.all.peak")
                if peak is not None:
                    metrics.gauge_max("hbm.peak_bytes_in_use", float(peak))
    except Exception:
        pass
    try:
        import resource

        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        out["host_max_rss_bytes"] = float(rss_kb) * 1024.0
        metrics.gauge_max("host.max_rss_bytes", float(rss_kb) * 1024.0)
    except Exception:
        pass
    return out


class _Span:
    """An open span: ``set(**attrs)`` merges attrs reported at close."""

    __slots__ = ("span_id", "name", "attrs", "t0")

    def __init__(self, span_id: int, name: str, attrs: Dict[str, Any]):
        self.span_id = span_id
        self.name = name
        self.attrs = attrs
        self.t0 = time.perf_counter()

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class RunLedger:
    """Append-only JSONL event stream for one run.

    **Rotation** — a long-lived process (``serve --watch`` under
    ``KEYSTONE_OBS_DIR``) appends to one run forever, so the active file
    carries a size cap: past ``max_bytes`` it is renamed to a numbered
    segment (``run_<id>.jsonl.000001``, monotonically increasing) and a
    fresh active file continues the run; only the newest
    ``keep_segments`` segments are kept, oldest pruned.  ``self.path``
    always names the ACTIVE file — readers of a live run see the newest
    tail, and each rotation bumps the ``obs.ledger_rotations`` counter.
    Defaults come from ``KEYSTONE_OBS_MAX_BYTES`` (unset = unbounded,
    the historical behavior) and ``KEYSTONE_OBS_KEEP_SEGMENTS``."""

    def __init__(
        self,
        directory: str,
        run_id: Optional[str] = None,
        max_bytes: Optional[int] = None,
        keep_segments: Optional[int] = None,
    ):
        os.makedirs(directory, exist_ok=True)
        if run_id is None:
            run_id = (
                f"{int(time.time()):x}-{os.getpid()}-{next(_RUN_COUNTER)}"
            )
        self.run_id = run_id
        self.directory = directory
        self.path = os.path.join(directory, f"run_{run_id}.jsonl")
        if max_bytes is None:
            max_bytes = _env_int(ENV_MAX_BYTES)
        self.max_bytes = max_bytes if max_bytes and max_bytes > 0 else None
        if keep_segments is None:
            keep_segments = _env_int(ENV_KEEP_SEGMENTS) or DEFAULT_KEEP_SEGMENTS
        self.keep_segments = max(1, int(keep_segments))
        # resume rotation state from disk: reopening an EXISTING run id
        # (a restarted serve --watch process) must count the bytes
        # already in the active file and continue segment numbering
        # past the highest kept suffix — starting both at zero would
        # let the active file grow to existing+max_bytes and the first
        # rotation os.replace() over (destroy) a retained segment
        try:
            self._bytes = os.path.getsize(self.path)
        except OSError:
            self._bytes = 0
        self._segment = 0
        prefix = f"run_{run_id}.jsonl."
        try:
            for name in os.listdir(directory):
                if name.startswith(prefix) and name[len(prefix):].isdigit():
                    self._segment = max(self._segment, int(name[len(prefix):]))
        except OSError:
            pass
        self._lock = threading.RLock()
        self._seq = 0
        self._f = open(self.path, "a", encoding="utf-8")
        self._tls = threading.local()  # per-thread open-span stack
        self._closed = False
        self._emit("run_start", "run", attrs={"pid": os.getpid()})

    # ------------------------------------------------------------ emit
    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _emit(
        self,
        kind: str,
        name: str,
        span: Optional[int] = None,
        parent: Optional[int] = None,
        attrs: Optional[Dict[str, Any]] = None,
        **extra,
    ) -> None:
        rec = {
            "ts": time.time(),
            "run_id": self.run_id,
            "kind": kind,
            "name": name,
        }
        if span is not None:
            rec["span"] = span
        if parent is not None:
            rec["parent"] = parent
        if attrs:
            rec["attrs"] = _json_safe(attrs)
        rec.update(extra)
        with self._lock:
            if self._closed:
                return
            self._seq += 1
            rec["seq"] = self._seq
            line = json.dumps(rec) + "\n"
            self._f.write(line)
            self._f.flush()
            self._bytes += len(line)
            if self.max_bytes is not None and self._bytes >= self.max_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Must hold self._lock.  Seal the active file as the next
        numbered segment, reopen a fresh active file, prune segments
        past ``keep_segments`` (oldest first)."""
        self._f.close()
        self._segment += 1
        try:
            os.replace(self.path, f"{self.path}.{self._segment:06d}")
        except OSError:
            # the active file vanished under us (operator cleanup): a
            # rotation failure must not kill the instrumented path
            pass
        self._f = open(self.path, "a", encoding="utf-8")
        self._bytes = 0
        prefix = os.path.basename(self.path) + "."
        segments = []
        try:
            for name in os.listdir(self.directory):
                if name.startswith(prefix) and name[len(prefix):].isdigit():
                    segments.append((int(name[len(prefix):]), name))
        except OSError:
            segments = []
        for _, name in sorted(segments)[: -self.keep_segments]:
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:
                pass
        metrics.inc("obs.ledger_rotations")

    def event(self, name: str, **attrs) -> None:
        st = self._stack()
        self._emit(
            "event",
            name,
            parent=st[-1].span_id if st else None,
            attrs=attrs,
        )

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Timed nested region.  Emits span_start/span_end, opens a
        ``torch.profiler.record_function`` of the same name, and samples
        memory watermarks at both boundaries."""
        with self._lock:
            self._seq += 1
            span_id = self._seq
        st = self._stack()
        parent = st[-1].span_id if st else None
        sp = _Span(span_id, name, dict(attrs))
        self._emit("span_start", name, span=span_id, parent=parent, attrs=attrs)
        _sample_memory()
        st.append(sp)
        try:
            import torch

            ann = torch.profiler.record_function(name)
        except Exception:
            ann = contextlib.nullcontext()
        try:
            with ann:
                yield sp
        finally:
            st.pop()
            mem = _sample_memory()
            end_attrs = dict(sp.attrs)
            end_attrs.update(mem)
            self._emit(
                "span_end",
                name,
                span=span_id,
                parent=parent,
                attrs=end_attrs,
                seconds=time.perf_counter() - sp.t0,
            )

    def metrics_snapshot(self) -> None:
        """Embed the current registry snapshot as one ``metrics`` line
        (the report's source for I/O totals and watermarks)."""
        self._emit("metrics", "metrics.snapshot", attrs=metrics.snapshot())

    def close(self, snapshot: bool = True) -> None:
        if self._closed:
            return
        if snapshot:
            self.metrics_snapshot()
        self._emit("run_end", "run")
        with self._lock:
            self._closed = True
            self._f.close()


# ----------------------------------------------------------- activation

_LOCK = threading.Lock()
_ACTIVE: Optional[RunLedger] = None  # start_run / attach
_ENV_LEDGER: Optional[RunLedger] = None  # lazily created from KEYSTONE_OBS_DIR


def active() -> Optional[RunLedger]:
    """The current ledger, or None (the inert default).  An explicit
    ``start_run``/``attach`` ledger wins; otherwise ``KEYSTONE_OBS_DIR``
    lazily creates one process-wide run."""
    if _ACTIVE is not None:
        return _ACTIVE
    directory = os.environ.get(ENV_DIR)
    if not directory:
        return None
    global _ENV_LEDGER
    with _LOCK:
        if _ENV_LEDGER is None or (
            _ENV_LEDGER._closed or _ENV_LEDGER.directory != directory
        ):
            _ENV_LEDGER = RunLedger(directory)
            atexit.register(_ENV_LEDGER.close)
    return _ENV_LEDGER


def start_run(directory: str, run_id: Optional[str] = None) -> RunLedger:
    """Explicitly open (and activate) a run ledger; pair with
    :func:`stop_run`."""
    global _ACTIVE
    led = RunLedger(directory, run_id=run_id)
    with _LOCK:
        _ACTIVE = led
    return led


def attach(ledger: Optional[RunLedger]) -> None:
    """Install an existing ledger as the active one (None detaches)."""
    global _ACTIVE
    with _LOCK:
        _ACTIVE = ledger


def stop_run(snapshot: bool = True) -> None:
    """Close and detach the explicitly-activated ledger."""
    global _ACTIVE
    with _LOCK:
        led, _ACTIVE = _ACTIVE, None
    if led is not None:
        led.close(snapshot=snapshot)


# ------------------------------------------------------------- frontends


def event(name: str, **attrs) -> None:
    """Record one event on the active ledger; no-op when inert."""
    led = active()
    if led is not None:
        led.event(name, **attrs)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Timed span on the active ledger; yields the span handle (or None
    when inert) so callers can ``sp.set(...)`` extra attrs."""
    led = active()
    if led is None:
        yield None
        return
    with led.span(name, **attrs) as sp:
        yield sp


def capture_context():
    """Snapshot the calling thread's open-span stack (opaque token).
    The span stack is thread-local, so work handed to a worker thread —
    ``utils/guard.run_with_deadline`` watchdogs are the in-repo case —
    would otherwise emit spans/events with no parent.  Capture on the
    calling thread, :func:`restore_context` inside the worker, and the
    worker's spans nest where the caller's would have."""
    led = active()
    if led is None:
        return None
    return (led, list(led._stack()))


def restore_context(token) -> None:
    """Install a :func:`capture_context` snapshot on the CURRENT thread
    (a copy — the originating thread's stack is never shared or
    mutated).  No-op for a None token."""
    if token is None:
        return
    led, stack = token
    led._tls.stack = list(stack)


def device_wait(x, account: str = "device.busy_seconds", force: bool = False):
    """Wait until the device work behind ``x`` (a tensor, or any nest of
    tensors in lists, tuples and dicts) is done and charge the wait to
    the device-busy account -- ONLY when a ledger is active.  Inert
    otherwise: no synchronize, no timing, the queue is untouched.
    Returns ``x``.

    ``force=True`` waits (and meters) unconditionally, for call sites
    where the wait is required whatever observability says (a checkpoint
    copy to the host).  The wait is a ``torch.cuda.synchronize`` of each
    CUDA device the tensors live on (of the current device where they
    name none); without a card there is nothing to wait for.

    The account is a host-side measure: seconds the host spent blocked
    on device results at natural drain points (solver finishes, epoch
    boundaries)."""
    if not force and active() is None:
        return x
    import torch

    if not torch.cuda.is_available():
        return x
    devices = set()
    _cuda_devices(x, devices, 0)
    t0 = time.perf_counter()
    for d in devices or (None,):  # no CUDA tensor named: the current device
        torch.cuda.synchronize(d)
    metrics.observe(account, time.perf_counter() - t0)
    return x


def _cuda_devices(x, out: set, depth: int) -> None:
    if depth > 4:
        return
    dev = getattr(x, "device", None)
    if dev is not None and getattr(dev, "type", None) == "cuda":
        out.add(dev)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out, depth + 1)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out, depth + 1)


def solver_obs() -> bool:
    """Should solvers report per-epoch telemetry (which costs a host read
    of the objective)?  True only while a ledger is active."""
    return active() is not None


def solver_epoch(solver: str, **series) -> None:
    """One solver convergence point (epoch/objective/grad-norm/...), a
    plain host call from the solvers' eager loops."""
    led = active()
    if led is not None:
        led.event("solver.epoch", solver=solver, **series)


def fold_stage_spans(ledger_path: str) -> Dict[str, dict]:
    """Aggregate a ledger's ``executor.stage`` span_end lines into
    ``{key: {seconds, count, retries, failed_attempt_seconds}}``.

    The one reader of this part of the schema.  Keys are
    ``"{node_id}:{label}"`` when the span recorded a node id (distinct
    nodes sharing a label stay distinct), else the bare label."""
    out: Dict[str, dict] = {}
    with open(ledger_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                continue  # a torn final line must not hide the run
            if e.get("kind") != "span_end" or e.get("name") != "executor.stage":
                continue
            attrs = e.get("attrs") or {}
            label = str(attrs.get("node", "?"))
            nid = attrs.get("node_id")
            key = f"{nid}:{label}" if nid is not None else label
            st = out.setdefault(
                key,
                {
                    "label": label,
                    "seconds": 0.0,
                    "count": 0,
                    "retries": 0,
                    "failed_attempt_seconds": 0.0,
                },
            )
            st["seconds"] += float(e.get("seconds") or 0.0)
            st["count"] += 1
            st["retries"] += int(attrs.get("retries") or 0)
            st["failed_attempt_seconds"] += float(
                attrs.get("failed_attempt_seconds") or 0.0
            )
    return out
