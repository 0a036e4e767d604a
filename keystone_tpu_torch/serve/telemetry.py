"""Fleet telemetry: worker-side span capture and metrics-delta
shipping, and the router-side sink that stitches both into the ops
surface (the flight recorder, the metrics registry, ``/statusz``)
(counterpart of ``keystone_tpu/serve/telemetry.py``).

The process fleet (``serve/procfleet.py``), the network fleet
(``serve/net.py``) and the binary ingress move a request's compute out
of the router process; this module keeps its critical path visible
without a new connection or a shared clock:

- **Worker side** (:class:`WorkerTelemetry`): a bounded ring of
  completed spans (``worker.load`` / ``worker.build`` / ``worker.prime``
  / ``worker.attach`` / ``worker.apply``), deltas of the worker's
  metrics registry, and (the port's addition) the worker's kernel
  report: its wrappers' launches, its bucket-graph replays and its peak
  reserved device memory.  All of it rides frames the transport already
  sends (replies, the ready frame, beats), and all of it is dropped,
  never queued: the span ring overwrites its oldest entry.
- **Clock alignment** (:class:`ClockSync`): the NTP four-timestamp
  sample of each exchange; the minimum-delay sample wins, with a slow
  decay; stitched spans are clamped into the router's ``[t_send,
  t_recv]`` window (:func:`clamp_span`), so they stay ordered and never
  run negative whatever the skew estimate.
- **Router side** (:class:`FleetTelemetry`): one sink for every worker
  handle of a pool.  Each exchange updates the worker's clock sync,
  folds shipped metric deltas into the router's registry under
  ``worker=``/``host=`` labels, feeds the ``serve.fleet.*`` series,
  keeps each worker process's last kernel report, and, for a traced
  flush, merges the wire accounting and the worker's spans into the
  flight recorder's batch record, which ``GET /requestz/<id>`` joins.

Every field is an optional body key: an absent one means an older peer,
never an error.  Imports only ``obs.metrics``.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from keystone_tpu_torch.obs import metrics

logger = logging.getLogger(__name__)

# fine-grained bounds for the fleet series: worker applies are
# milliseconds-scale (the serve latency grid), wire round trips are
# often sub-millisecond on a LAN (the ingress grid)
metrics.register_buckets(
    "serve.fleet.apply_seconds", metrics.LATENCY_MS_BUCKETS
)
metrics.register_buckets(
    "serve.fleet.wire_rtt_seconds", metrics.INGRESS_TIME_BUCKETS
)

#: ceiling on completed spans held worker-side between ships.  Overflow
#: drops the OLDEST span (dropped-not-queued): a worker the router never
#: drains again loses telemetry, not memory.
MAX_PENDING_SPANS = 64

#: ceiling on metric-delta entries per ship; series beyond the cap stay
#: pending (their baseline does not advance) and ride the next ship.
MAX_DELTA_ENTRIES = 128

#: floor between metric-delta exports on one channel — replies arriving
#: faster than this carry spans + clock stamps only, keeping the
#: telemetry tax on a hot flush path to a dict copy, not a registry walk
DELTA_MIN_INTERVAL_S = 0.5

#: trace context ships at most this many rider request ids (a 1024-row
#: ingress batch must not quadruple its control frame)
MAX_TRACE_REQUEST_IDS = 16


# ------------------------------------------------------------- worker side


class WorkerTelemetry:
    """Worker-process half: bounded span capture + registry deltas.

    One instance per worker serve loop (or per net session).  All
    methods are thread-safe (the net worker's beat thread ships metric
    deltas while the serve loop records spans)."""

    def __init__(
        self,
        registry: Optional[metrics.MetricsRegistry] = None,
        max_spans: int = MAX_PENDING_SPANS,
        max_entries: int = MAX_DELTA_ENTRIES,
        min_metrics_interval_s: float = DELTA_MIN_INTERVAL_S,
        report=None,
    ):
        self._reg = registry if registry is not None else metrics.REGISTRY
        #: ``report()``: the worker's kernel report (a JSON dict of
        #: cumulative counts), shipped whole on every :meth:`ship`
        self._report = report
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max(1, int(max_spans)))
        self._max_entries = max(1, int(max_entries))
        self._min_interval = max(0.0, float(min_metrics_interval_s))
        #: absolute values already shipped, per series key — counters
        #: and histograms export the difference against this
        self._shipped_counters: Dict = {}
        self._shipped_hists: Dict = {}
        self._shipped_gauges: Dict = {}
        self._last_metrics_ship = -float("inf")

    # ------------------------------------------------------------- spans
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Record one completed span (worker monotonic clock) around a
        block.  The span lands in the ring even when the block raises —
        a failing apply is exactly the span worth shipping."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add_span(name, t0, time.monotonic(), **attrs)

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        sp = {"name": str(name), "t0": float(t0), "t1": float(t1)}
        if attrs:
            sp["attrs"] = attrs
        with self._lock:
            self._spans.append(sp)

    # ----------------------------------------------------------- shipping
    def ship(self, t_rx: Optional[float] = None) -> dict:
        """The ``telemetry`` body of one reply frame: worker clock
        stamps, every pending span (drained), and — when the throttle
        window elapsed — registry deltas."""
        blob: dict = {"t_tx": time.monotonic()}
        if t_rx is not None:
            blob["t_rx"] = float(t_rx)
        with self._lock:
            if self._spans:
                blob["spans"] = list(self._spans)
                self._spans.clear()
        entries = self.metrics_entries()
        if entries:
            blob["metrics"] = entries
        if self._report is not None:
            blob["kernels"] = self._report()
        return blob

    def metrics_entries(
        self, min_interval_s: Optional[float] = None
    ) -> Optional[list]:
        """Registry deltas since the last ship, or None inside the
        throttle window / when nothing changed.  Baselines advance only
        for entries actually returned, so a capped export ships the
        remainder next round instead of losing it."""
        interval = (
            self._min_interval if min_interval_s is None else float(min_interval_s)
        )
        now = time.monotonic()
        with self._lock:
            if now - self._last_metrics_ship < interval:
                return None
            counters, gauges, hists = self._reg.export_raw()
            entries: List[list] = []
            for k, v in counters.items():
                if len(entries) >= self._max_entries:
                    break
                delta = v - self._shipped_counters.get(k, 0.0)
                if delta <= 0.0:
                    continue
                name, labels = k
                entries.append(["c", name, [list(p) for p in labels], delta])
                self._shipped_counters[k] = v
            for k, v in gauges.items():
                if len(entries) >= self._max_entries:
                    break
                if self._shipped_gauges.get(k) == v:
                    continue
                name, labels = k
                entries.append(["g", name, [list(p) for p in labels], v])
                self._shipped_gauges[k] = v
            for k, h in hists.items():
                if len(entries) >= self._max_entries:
                    break
                bounds, buckets, count, total, mn, mx = h
                prev = self._shipped_hists.get(k)
                if prev is not None and prev[2] == count:
                    continue
                if prev is not None and tuple(prev[0]) == tuple(bounds):
                    d_buckets = [b - p for b, p in zip(buckets, prev[1])]
                    d_count = count - prev[2]
                    d_sum = total - prev[3]
                else:
                    d_buckets, d_count, d_sum = list(buckets), count, total
                name, labels = k
                entries.append(
                    [
                        "h",
                        name,
                        [list(p) for p in labels],
                        {
                            "bounds": list(bounds),
                            "buckets": d_buckets,
                            "count": d_count,
                            "sum": d_sum,
                            "min": None if mn is None else mn,
                            "max": None if mx is None else mx,
                        },
                    ]
                )
                self._shipped_hists[k] = (bounds, list(buckets), count, total)
            if entries:
                self._last_metrics_ship = now
            return entries or None


# ---------------------------------------------------------- clock alignment


class ClockSync:
    """NTP-style monotonic-clock alignment for one worker, from the
    four timestamps of a request/reply exchange:

    - router sends at ``t_send``, receives at ``t_recv`` (router clock)
    - worker receives at ``t_rx``, replies at ``t_tx`` (worker clock)

    ``delay = (t_recv - t_send) - (t_tx - t_rx)`` is the wire round
    trip with the worker's compute subtracted; ``offset = ((t_rx -
    t_send) + (t_tx - t_recv)) / 2`` estimates ``worker_clock -
    router_clock`` with error bounded by ``delay / 2``.  The
    minimum-delay sample is kept (its bound is tightest); the kept
    delay decays slightly per rejected sample so a drifting clock
    re-converges instead of trusting one ancient lucky sample forever.
    A negative measured delay (a retransmit answered by the reply to an
    earlier send) is rejected outright."""

    __slots__ = ("offset", "best_delay", "last_delay", "samples")

    #: per-rejected-sample growth of the kept delay bound: ~70 rejected
    #: exchanges double the bound, after which a typical sample wins
    _DECAY = 1.01

    def __init__(self):
        self.offset: Optional[float] = None
        self.best_delay: Optional[float] = None
        self.last_delay: Optional[float] = None
        self.samples = 0

    def observe(
        self, t_send: float, t_recv: float, t_rx: float, t_tx: float
    ) -> Optional[float]:
        """Fold one exchange in; returns the measured wire delay (for
        the RTT series), or None for an unusable sample."""
        delay = (t_recv - t_send) - (t_tx - t_rx)
        if delay < 0.0 or t_recv < t_send:
            return None
        self.samples += 1
        self.last_delay = delay
        if self.best_delay is None or delay <= self.best_delay:
            self.best_delay = delay
            self.offset = ((t_rx - t_send) + (t_tx - t_recv)) / 2.0
        else:
            self.best_delay *= self._DECAY
        return delay

    def to_router(self, t_worker: float) -> Optional[float]:
        """A worker-clock instant on the router's clock (None before
        the first accepted sample)."""
        if self.offset is None:
            return None
        return t_worker - self.offset


def clamp_span(
    sync: ClockSync,
    t0_worker: float,
    t1_worker: float,
    t_send: float,
    t_recv: float,
):
    """Align one worker span into the router clock, clamped into the
    router's ``[t_send, t_recv]`` observation window.  The clamp is the
    skew-tolerance guarantee: whatever the offset estimate got wrong,
    the span stays inside the interval the router *observed* containing
    it, stays ordered, and never has negative duration."""
    lo, hi = float(t_send), max(float(t_send), float(t_recv))
    r0 = sync.to_router(t0_worker)
    r1 = sync.to_router(t1_worker)
    if r0 is None or r1 is None:
        # no sync yet: preserve the span's own duration, anchored at
        # the window start (duration itself needs no clock alignment)
        dur = max(0.0, float(t1_worker) - float(t0_worker))
        return lo, min(hi, lo + dur)
    r0 = min(max(r0, lo), hi)
    r1 = min(max(r1, lo), hi)
    if r1 < r0:
        r1 = r0
    return r0, r1


# ------------------------------------------------------------- router side


class FleetTelemetry:
    """The router-side sink one :class:`~keystone_tpu_torch.serve.fleet.
    ReplicaPool` shares across all its worker handles (initial build,
    scale-ups, supervisor heals — every handle built by the pool is
    attached to the same sink, so telemetry survives replacement).

    Never raises into the serving path: a malformed shipment is logged
    at debug and dropped — telemetry must not be able to fail a flush
    that the data path served fine."""

    def __init__(self, registry=None, recorder=None):
        self._reg = registry if registry is not None else metrics.REGISTRY
        #: the service's FlightRecorder; assigned after construction
        #: (the pool is built before the recorder exists) and None when
        #: tracing is off — metric aggregation works either way
        self.recorder = recorder
        self._lock = threading.Lock()
        self._clocks: Dict[str, ClockSync] = {}
        self._hosts: Dict[str, str] = {}
        #: the last kernel report of each worker PROCESS, by (worker, pid):
        #: a replacement reuses its slot's name, and the report of the
        #: process it replaced must still count
        self._kernels: Dict[tuple, dict] = {}

    # ------------------------------------------------------------ intake
    def _sync_for(self, worker: str, host: str) -> ClockSync:
        with self._lock:
            sync = self._clocks.get(worker)
            if sync is None:
                sync = self._clocks[worker] = ClockSync()
            self._hosts[worker] = host
            return sync

    def on_exchange(
        self,
        worker: str,
        host: Optional[str],
        t_send: float,
        t_recv: float,
        shipped,
        trace: Optional[dict] = None,
    ) -> None:
        """One request/reply exchange's worth of shipped telemetry.
        ``shipped`` is the reply's ``telemetry`` body (None from an old
        worker — tolerated, nothing to aggregate); ``trace`` is the
        context the apply frame carried, when the flush was traced."""
        if not isinstance(shipped, dict):
            return
        try:
            self._ingest(worker, host, t_send, t_recv, shipped, trace)
        except Exception:  # telemetry must never fail the data path
            logger.debug(
                "dropping malformed telemetry from %s", worker, exc_info=True
            )

    def on_beat(self, worker: str, host: Optional[str], shipped) -> None:
        """Heartbeat-piggybacked shipment: metric deltas only (a beat
        is one-way — no RTT sample, no trace to stitch)."""
        if not isinstance(shipped, dict):
            return
        try:
            worker, host = str(worker), str(host or "local")
            self._sync_for(worker, host)
            entries = shipped.get("metrics")
            if entries:
                self._reg.merge_entries(entries, worker=worker, host=host)
        except Exception:
            logger.debug(
                "dropping malformed beat telemetry from %s",
                worker,
                exc_info=True,
            )

    def _note_kernels(self, worker: str, report) -> None:
        if isinstance(report, dict) and "pid" in report:
            with self._lock:
                self._kernels[(worker, int(report["pid"]))] = report

    def _ingest(self, worker, host, t_send, t_recv, shipped, trace) -> None:
        worker, host = str(worker), str(host or "local")
        sync = self._sync_for(worker, host)
        self._note_kernels(worker, shipped.get("kernels"))
        delay = None
        t_rx, t_tx = shipped.get("t_rx"), shipped.get("t_tx")
        if isinstance(t_rx, (int, float)) and isinstance(t_tx, (int, float)):
            delay = sync.observe(
                float(t_send), float(t_recv), float(t_rx), float(t_tx)
            )
            if delay is not None:
                self._reg.observe(
                    "serve.fleet.wire_rtt_seconds",
                    delay,
                    worker=worker,
                    host=host,
                )
        spans = shipped.get("spans")
        good_spans: List[dict] = []
        if isinstance(spans, list):
            for sp in spans[: MAX_PENDING_SPANS]:
                if not isinstance(sp, dict):
                    continue
                try:
                    t0, t1 = float(sp["t0"]), float(sp["t1"])
                except (KeyError, TypeError, ValueError):
                    continue
                name = str(sp.get("name") or "worker.span")
                good_spans.append(
                    {"name": name, "t0": t0, "t1": t1, "attrs": sp.get("attrs")}
                )
                if name == "worker.apply":
                    self._reg.observe(
                        "serve.fleet.apply_seconds",
                        max(0.0, t1 - t0),
                        worker=worker,
                        host=host,
                    )
        entries = shipped.get("metrics")
        if entries:
            self._reg.merge_entries(entries, worker=worker, host=host)
        rec = self.recorder
        bid = trace.get("batch") if isinstance(trace, dict) else None
        if rec is None or bid is None:
            return
        # stitch into the flush's batch record: /requestz joins batch
        # records onto every rider's trace, so one update per exchange
        # keeps the per-request cost flat in batch size
        aligned = []
        for sp in good_spans:
            r0, r1 = clamp_span(sync, sp["t0"], sp["t1"], t_send, t_recv)
            entry = {
                "name": sp["name"],
                "t_off": round(r0 - t_send, 6),
                "seconds": round(r1 - r0, 6),
            }
            if sp.get("attrs"):
                entry["attrs"] = sp["attrs"]
            aligned.append(entry)
        wire_acct = {"rtt_s": None if delay is None else round(delay, 6)}
        rx_r = None if not isinstance(t_rx, (int, float)) else sync.to_router(float(t_rx))
        tx_r = None if not isinstance(t_tx, (int, float)) else sync.to_router(float(t_tx))
        if rx_r is not None:
            rx_r = min(max(rx_r, t_send), t_recv)
            wire_acct["send_s"] = round(max(0.0, rx_r - t_send), 6)
        if tx_r is not None:
            tx_r = min(max(tx_r, t_send), t_recv)
            wire_acct["recv_s"] = round(max(0.0, t_recv - tx_r), 6)
        update = {"worker": worker, "host": host, "wire": wire_acct}
        if aligned:
            update["worker_spans"] = aligned
        rec.batch_update(str(bid), **update)

    # -------------------------------------------------------------- read
    def kernel_reports(self) -> Dict[tuple, dict]:
        """The last kernel report of every worker process this sink has
        heard from, by (worker name, pid)."""
        with self._lock:
            return dict(self._kernels)

    def kernel_totals(self) -> dict:
        """The workers' kernel counts summed over every process this sink
        has heard from (the dead ones' last reports included):
        ``{"launches": {wrapper: n}, "replayed": {wrapper: n}}``."""
        totals: dict = {"launches": {}, "replayed": {}}
        for rep in self.kernel_reports().values():
            for part in ("launches", "replayed"):
                for k, v in (rep.get(part) or {}).items():
                    totals[part][k] = totals[part].get(k, 0) + int(v)
        return totals

    def known_workers(self) -> List[str]:
        with self._lock:
            return sorted(self._clocks)

    def fleet_status(self) -> dict:
        """The ``/statusz`` ``fleet`` block: per-worker apply/wire
        percentiles (from the merged registry series), clock sync
        state, and the transport's retransmit/late-discard counters."""

        def _ms(v):
            return None if v is None else round(1000.0 * v, 3)

        workers = {}
        with self._lock:
            clocks = dict(self._clocks)
            hosts = dict(self._hosts)
        for worker, sync in sorted(clocks.items()):
            host = hosts.get(worker, "local")
            entry: dict = {
                "host": host,
                "clock_offset_s": (
                    None if sync.offset is None else round(sync.offset, 6)
                ),
                "clock_samples": sync.samples,
            }
            apply_h = self._reg.histogram_summary(
                "serve.fleet.apply_seconds", worker=worker, host=host
            )
            if apply_h is not None:
                entry["apply_ms"] = {
                    "count": apply_h["count"],
                    "p50": _ms(apply_h.get("p50")),
                    "p99": _ms(apply_h.get("p99")),
                }
            rtt_h = self._reg.histogram_summary(
                "serve.fleet.wire_rtt_seconds", worker=worker, host=host
            )
            if rtt_h is not None:
                entry["wire_rtt_ms"] = {
                    "count": rtt_h["count"],
                    "p50": _ms(rtt_h.get("p50")),
                    "p99": _ms(rtt_h.get("p99")),
                }
            retrans = self._reg.counter_value(
                "serve.net.retransmits", worker=worker
            )
            late = self._reg.counter_value(
                "serve.net.late_discards", worker=worker
            )
            if retrans:
                entry["retransmits"] = retrans
            if late:
                entry["late_discards"] = late
            kern = [r for (w, _pid), r in self.kernel_reports().items() if w == worker]
            if kern:
                newest = kern[-1]
                entry["pid"] = newest.get("pid")
                entry["device"] = newest.get("device")
                entry["peak_reserved_bytes"] = newest.get("peak_reserved_bytes")
            workers[worker] = entry
        return {"workers": workers}
