"""Flight recorder: an always-on, bounded, in-memory trace store for
the serving path (a copy of ``keystone_tpu/obs/recorder.py``, which is
framework-neutral: the port keeps its own so that it imports nothing of
the JAX package).

The run ledger (``obs/ledger.py``) is a per-run JSONL stream — perfect
for offline fits, wrong for production serving: it is default-OFF (a
shed request leaves zero causal trace unless an operator pre-set
``KEYSTONE_OBS_DIR``), unbounded (a long-lived server would stream to
disk forever), and file-shaped (answering "why was request X slow?"
means grepping JSONL).  The flight recorder is the serving-side
complement, modeled on aircraft FDRs and the tracez/statusz "z-pages"
tradition: a bounded ring of the most recent request traces, ON by
default in :func:`keystone_tpu_torch.serve.serve`, independent of (and
additive to) the ledger, readable live over HTTP (``GET /tracez``,
``GET /requestz/<id>`` — ``serve/http.py``).

Model:

- one **trace** per request id — an ordered list of events
  (``{"t": <seconds since trace start>, "name": ..., "attrs": {...}}``)
  from ingress to a terminal outcome (``completed`` / ``shed`` /
  ``rejected`` / ``degraded`` / ``error`` / ``cancelled``);
- one **batch record** per flush, carrying its rider request ids as
  span links (the batch is shared by its riders — recording it once and
  joining on read keeps per-request cost flat in batch size);
- **ops spans** for non-request control-plane moments (blue/green
  swaps, watcher actions), so a swap is visible BETWEEN the request
  traces it interleaves with.

Retention is **tail-based**: every finished trace enters the ``recent``
ring (FIFO, bounded), and *interesting* traces — terminal outcome in
``shed``/``rejected``/``error``/``degraded``, or latency at or above
the slow threshold — are ALSO pinned in a separate bounded ring, so the
traces an operator actually debugs survive long after the happy-path
flood evicted their contemporaries.  The slow threshold is either the
explicit ``slow_ms`` or a rolling p99 of recent completed latencies
(recomputed every few dozen finishes, so the sort is amortized).

Overhead budget: every hook is one lock acquisition plus O(1) dict/list
work — no JSON, no I/O, no syscalls on the hot path (JSON-safety is
applied on READ).  Per-trace event count is capped (``max_events``);
live traces that never finish are bounded by eviction into ``recent``
with outcome ``abandoned``.

This module is stdlib-only at import (the ``obs`` package contract).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from keystone_tpu_torch.obs.ledger import _json_safe

#: terminal outcomes that pin a trace into the long-retention ring
#: ("poison": a request isolated by batch bisection — exactly the trace
#: an operator wants long after the happy-path flood evicted its peers)
PINNED_OUTCOMES = frozenset({"shed", "rejected", "error", "degraded", "poison"})

#: recompute the rolling-p99 slow threshold every this many finishes
#: (amortizes the sort; a per-finish sort would blow the overhead budget)
_SLOW_REFRESH = 32

#: minimum latency samples before the auto slow threshold activates
_SLOW_MIN_SAMPLES = 20

#: import-time process prefix: random nonce + pid tail.  The pid is
#: captured ONCE — os.getpid() is a syscall (tens of µs under hardened
#: kernels) and must not be paid per request; a fork would stale the
#: tail, but the random nonce alone already separates processes.
_PROC = f"{uuid.uuid4().hex[:6]}{os.getpid() & 0xFFFF:04x}"
_REQ_COUNTER = itertools.count(1)


def new_request_id() -> str:
    """A process-unique request id: 10-hex process prefix (random nonce
    + pid tail, both captured at import) + monotonic counter.  One
    counter bump and one f-string per id — no uuid, no syscall."""
    return f"{_PROC}-{next(_REQ_COUNTER):06x}"


class FlightRecorder:
    """Bounded in-memory store of recent request traces, batch records,
    and ops spans.  Thread-safe; every write is one lock + O(1) work.

    ``capacity``/``pinned_capacity``/``batch_capacity``/``ops_capacity``
    bound the recent, pinned, batch, and ops rings; ``slow_ms`` fixes
    the slow-trace threshold (default: rolling p99 of completed
    latencies); ``max_events`` caps events per trace (overflow counted,
    not stored)."""

    def __init__(
        self,
        capacity: int = 256,
        pinned_capacity: int = 128,
        batch_capacity: int = 512,
        ops_capacity: int = 128,
        slow_ms: Optional[float] = None,
        max_events: int = 64,
    ):
        self.capacity = max(1, int(capacity))
        self.pinned_capacity = max(1, int(pinned_capacity))
        self.batch_capacity = max(1, int(batch_capacity))
        self.max_events = max(4, int(max_events))
        self._slow_s = None if not slow_ms else float(slow_ms) / 1000.0
        self._auto_slow_s: Optional[float] = None
        self._lock = threading.Lock()
        self._live: "OrderedDict[str, dict]" = OrderedDict()
        self._recent: "OrderedDict[str, dict]" = OrderedDict()
        self._pinned: "OrderedDict[str, dict]" = OrderedDict()
        self._batches: "OrderedDict[str, dict]" = OrderedDict()
        self._ops: deque = deque(maxlen=max(1, int(ops_capacity)))
        self._latencies: deque = deque(maxlen=512)
        self._finishes = 0
        self._dropped_events = 0

    # ----------------------------------------------------------- record
    @staticmethod
    def _new_trace(request_id: str) -> dict:
        """The one trace-dict constructor: _trace_locked and the
        finish-an-unknown-id path must mint the SAME shape, or readers
        (_summary/_full) crash on the one that drifted."""
        return {
            "request_id": request_id,
            "ts": time.time(),
            "t0": time.perf_counter(),
            "events": [],
            "batches": [],
            "outcome": None,
            "seconds": None,
            "slow": False,
        }

    def _trace_locked(self, request_id: str) -> dict:
        tr = self._live.get(request_id)
        if tr is None:
            tr = self._live[request_id] = self._new_trace(request_id)
            # a live trace that never finishes (caller vanished between
            # annotate and submit) must not accumulate forever
            while len(self._live) > 4 * self.capacity:
                _, stale = self._live.popitem(last=False)
                self._finalize_locked(stale, "abandoned")
        return tr

    def annotate(self, request_id: Optional[str], name: str, **attrs) -> None:
        """Append one event to ``request_id``'s trace (created lazily on
        first touch).  ``request_id=None`` is the inert no-op — callers
        pass their possibly-absent id straight through."""
        if request_id is None:
            return
        with self._lock:
            tr = self._live.get(request_id)
            if tr is None:
                if request_id in self._pinned or request_id in self._recent:
                    return  # already finalized: a late event is dropped
                tr = self._trace_locked(request_id)
            if len(tr["events"]) >= self.max_events:
                self._dropped_events += 1
                return
            tr["events"].append(
                {
                    "t": time.perf_counter() - tr["t0"],
                    "name": name,
                    "attrs": attrs,
                }
            )
            b = attrs.get("batch")
            if b is not None and b not in tr["batches"]:
                tr["batches"].append(b)

    def finish(
        self,
        request_id: Optional[str],
        outcome: str,
        only_live: bool = False,
        **attrs,
    ) -> None:
        """Terminal event + finalize: the trace moves from the live set
        into the recent ring, and additionally into the pinned ring when
        the outcome is interesting or the trace is slow.  Idempotent for
        already-finalized ids; ``only_live=True`` additionally refuses
        to CREATE a trace (the generic failure path uses it so it can't
        resurrect an evicted id as a one-event stub)."""
        if request_id is None:
            return
        with self._lock:
            tr = self._live.pop(request_id, None)
            if tr is None:
                if only_live or request_id in self._pinned or (
                    request_id in self._recent
                ):
                    return
                tr = self._new_trace(request_id)
            tr["events"].append(
                {
                    "t": time.perf_counter() - tr["t0"],
                    "name": f"serve.{outcome}",
                    "attrs": attrs,
                }
            )
            b = attrs.get("batch")
            if b is not None and b not in tr["batches"]:
                tr["batches"].append(b)
            self._finalize_locked(tr, outcome)

    def _finalize_locked(self, tr: dict, outcome: str) -> None:
        tr["outcome"] = outcome
        tr["seconds"] = time.perf_counter() - tr["t0"]
        threshold = self._slow_s or self._auto_slow_s
        tr["slow"] = threshold is not None and tr["seconds"] >= threshold
        rid = tr["request_id"]
        self._recent[rid] = tr
        self._recent.move_to_end(rid)
        while len(self._recent) > self.capacity:
            self._recent.popitem(last=False)
        if outcome in PINNED_OUTCOMES or tr["slow"]:
            self._pinned[rid] = tr
            self._pinned.move_to_end(rid)
            while len(self._pinned) > self.pinned_capacity:
                self._pinned.popitem(last=False)
        if outcome in ("completed", "degraded"):
            self._latencies.append(tr["seconds"])
        self._finishes += 1
        if (
            self._slow_s is None
            and self._finishes % _SLOW_REFRESH == 0
            and len(self._latencies) >= _SLOW_MIN_SAMPLES
        ):
            lat = sorted(self._latencies)
            self._auto_slow_s = lat[min(len(lat) - 1, int(0.99 * len(lat)))]

    def batch(self, batch_id: str, riders: List[str], **attrs) -> None:
        """Record one flush's batch span, linking its rider request ids
        (the multi-parent join: riders reference the batch, the batch
        lists its riders)."""
        with self._lock:
            self._batches[batch_id] = {
                "batch": batch_id,
                "ts": time.time(),
                "request_ids": list(riders),
                **attrs,
            }
            while len(self._batches) > self.batch_capacity:
                self._batches.popitem(last=False)

    def batch_update(self, batch_id: str, **attrs) -> None:
        """Merge post-apply facts (seconds, bucket, degraded) into an
        existing batch record; no-op for an evicted id."""
        with self._lock:
            rec = self._batches.get(batch_id)
            if rec is not None:
                rec.update(attrs)

    def ops(self, name: str, **attrs) -> None:
        """One control-plane span (swap, watcher action): bounded ring,
        surfaced by ``/tracez`` alongside request traces."""
        with self._lock:
            self._ops.append({"ts": time.time(), "name": name, **attrs})

    # ------------------------------------------------------------- read
    @staticmethod
    def _summary(tr: dict) -> dict:
        last = tr["events"][-1]["name"] if tr["events"] else None
        return _json_safe(
            {
                "request_id": tr["request_id"],
                "ts": tr["ts"],
                "outcome": tr["outcome"],
                "seconds": tr["seconds"],
                "slow": tr["slow"],
                "n_events": len(tr["events"]),
                "last": last,
                "batches": list(tr["batches"]),
            }
        )

    def _matches(self, tr: dict, flt: Optional[str]) -> bool:
        if not flt:
            return True
        if flt == "slow":
            return bool(tr["slow"])
        return tr["outcome"] == flt

    def _full(self, tr: dict) -> dict:
        out = {k: v for k, v in tr.items() if k != "t0"}
        return _json_safe(out)

    def tracez(
        self, filter: Optional[str] = None, limit: int = 50, full: bool = False
    ) -> List[dict]:
        """Recent traces, newest first: pinned + recent + live (open
        traces report ``outcome: null``).  ``filter``: ``"slow"`` or a
        terminal outcome (``"shed"``/``"error"``/...)."""
        with self._lock:
            seen = set()
            rows = []
            for store in (self._live, self._recent, self._pinned):
                for rid, tr in store.items():
                    if rid in seen:
                        continue
                    seen.add(rid)
                    rows.append(tr)
        rows.sort(key=lambda t: t["ts"], reverse=True)
        render = self._full if full else self._summary
        out = []
        for tr in rows:  # filter+limit BEFORE the JSON-safe render:
            if not self._matches(tr, filter):  # rendering ~1400 traces
                continue  # to keep 50 would tax every dashboard poll
            out.append(render(tr))
            if len(out) >= max(1, int(limit)):
                break
        return out

    def request(self, request_id: str) -> Optional[dict]:
        """One request's full causal chain: its trace joined with every
        linked batch record.  None for an unknown (or evicted) id."""
        with self._lock:
            tr = (
                self._live.get(request_id)
                or self._pinned.get(request_id)
                or self._recent.get(request_id)
            )
            if tr is None:
                return None
            batches = [
                dict(self._batches[b])
                for b in tr["batches"]
                if b in self._batches
            ]
            out = {k: v for k, v in tr.items() if k != "t0"}
            out["open"] = request_id in self._live
        out["batch_records"] = batches
        return _json_safe(out)

    def ops_spans(self, limit: int = 50) -> List[dict]:
        with self._lock:
            rows = list(self._ops)
        return _json_safe(rows[-max(1, int(limit)):][::-1])

    def dump(self) -> dict:
        """Everything, JSON-safe — the ``/tracez?full=1`` payload and
        ``tools/trace_report.py``'s recorder-mode input."""
        with self._lock:
            seen = set()
            traces = []
            for store in (self._pinned, self._recent, self._live):
                for rid, tr in store.items():
                    if rid not in seen:
                        seen.add(rid)
                        traces.append(tr)
            batches = [dict(b) for b in self._batches.values()]
            ops = list(self._ops)
        traces.sort(key=lambda t: t["ts"])
        stats = self.stats()  # outside the lock: stats() takes it too
        return _json_safe(
            {
                "traces": [
                    {k: v for k, v in tr.items() if k != "t0"} for tr in traces
                ],
                "batches": batches,
                "ops": ops,
                "stats": stats,
            }
        )

    def stats(self) -> dict:
        with self._lock:
            threshold = self._slow_s or self._auto_slow_s
            return {
                "live": len(self._live),
                "recent": len(self._recent),
                "pinned": len(self._pinned),
                "batches": len(self._batches),
                "ops": len(self._ops),
                "finished": self._finishes,
                "dropped_events": self._dropped_events,
                "slow_threshold_ms": (
                    None if threshold is None else round(1000.0 * threshold, 3)
                ),
            }
