"""Process-wide metrics registry: counters, gauges, histograms
(counterpart of ``keystone_tpu/obs/metrics.py``, the same module with its
import paths changed).

The registry is the sink every subsystem reports to: blockstore bytes and
retries, durable-layer corruption and fallback counts, executor retry
time, solver telemetry, fault-injection outcomes, device-memory
watermarks.  One process is one registry (module-level :data:`REGISTRY`),
as ``keystone_tpu_torch.faults`` keeps its process-global counters.

- **hot-path cheap**: a counter bump is one lock and one dict update.
  ``KEYSTONE_METRICS=0`` short-circuits every recording call to one
  environment lookup.
- **no torch and no numpy at import**: ``keystone_tpu_torch.faults``
  imports this module, and faults must import before any backend exists.
- **label-aware**: metrics key on ``(name, sorted(labels))``, so
  per-site breakdowns (``faults.injected{site=...}``) live next to their
  totals.

Exports: :meth:`MetricsRegistry.snapshot` (a plain dict, embedded in the
run ledger) and :meth:`MetricsRegistry.to_prometheus_text` (the text
exposition format).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

ENV_DISABLE = "KEYSTONE_METRICS"

#: histogram bucket upper bounds (seconds-oriented; byte-scale values
#: simply land in +Inf, where count/sum/min/max still describe them)
DEFAULT_BUCKETS = (
    0.001,
    0.005,
    0.01,
    0.05,
    0.1,
    0.5,
    1.0,
    5.0,
    10.0,
    60.0,
)

#: millisecond-resolution bounds for serve-path latencies.  The default
#: bounds alias everything under 1 ms into one bucket and everything
#: between 1 and 5 ms into another — useless for a micro-batching
#: service whose whole latency budget is tens of milliseconds.  Register
#: these per name via :meth:`MetricsRegistry.register_buckets` (the
#: serve subsystem does for ``serve.latency_seconds`` /
#: ``serve.batch_seconds``), and windowed percentile estimates inherit
#: the resolution.
LATENCY_MS_BUCKETS = (
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
)

#: sub-millisecond bounds for the ingress hot path: frame parse and
#: batch admission each cost tens of microseconds when the zero-copy
#: path holds, so even :data:`LATENCY_MS_BUCKETS` (floor 0.5 ms) would
#: flatten every sample into its first bucket.  ``serve/ingress.py``
#: registers these for ``ingress.parse_seconds`` /
#: ``ingress.admit_seconds``.
INGRESS_TIME_BUCKETS = (
    0.00001,
    0.000025,
    0.00005,
    0.0001,
    0.00025,
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.05,
    0.25,
    1.0,
)


def enabled() -> bool:
    """Recording on?  ``KEYSTONE_METRICS=0`` disables every write path
    (reads — snapshot/export — always work)."""
    return os.environ.get(ENV_DISABLE, "1") != "0"


class MetricKindError(TypeError):
    """One metric name registered as two different instrument kinds
    (counter vs gauge vs histogram).  Before this check the second
    registration silently shadowed the first in :meth:`snapshot` —
    dashboards read whichever family exported last.  Raised at record
    time, naming both kinds."""

    def __init__(self, name: str, existing: str, requested: str):
        self.name = name
        super().__init__(
            f"metric {name!r} is already registered as a {existing}; "
            f"cannot also record it as a {requested} — instrument kinds "
            "are exclusive per name"
        )


_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, object]) -> _Key:
    if not labels:
        return (name, ())
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class _Histogram:
    __slots__ = ("count", "sum", "min", "max", "buckets", "bounds")

    def __init__(self, bounds=DEFAULT_BUCKETS):
        self.bounds = tuple(bounds)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets = [0] * (len(self.bounds) + 1)  # last = +Inf

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        for i, b in enumerate(self.bounds):
            if value <= b:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1

    def merge_into(self, other: "_Histogram") -> None:
        """Accumulate this histogram into ``other`` (same bounds — the
        windowed wrapper's read-side merge)."""
        other.count += self.count
        other.sum += self.sum
        other.min = min(other.min, self.min)
        other.max = max(other.max, self.max)
        for i, n in enumerate(self.buckets):
            other.buckets[i] += n

    def quantile(self, q: float) -> Optional[float]:
        """Estimated ``q``-quantile (0..1) by linear interpolation
        within the containing bucket, clamped to the observed min/max.
        Resolution is the bucket grid's — register fine bounds
        (:data:`LATENCY_MS_BUCKETS`) for names whose percentiles matter."""
        if self.count == 0:
            return None
        target = max(0.0, min(1.0, float(q))) * self.count
        cum = 0.0
        lo = 0.0
        for b, n in zip(self.bounds, self.buckets[:-1]):
            if n and cum + n >= target:
                val = lo + (b - lo) * (target - cum) / n
                return min(max(val, self.min), self.max)
            cum += n
            lo = b
        return self.max

    def fraction_above(self, threshold: float) -> float:
        """Estimated fraction of samples strictly above ``threshold``
        (same interpolation as :meth:`quantile`) — the SLO burn-rate
        numerator."""
        if self.count == 0:
            return 0.0
        t = float(threshold)
        below = 0.0
        lo = 0.0
        for b, n in zip(self.bounds, self.buckets[:-1]):
            if b <= t:
                below += n
            elif lo < t:
                below += n * (t - lo) / (b - lo)
            lo = b
        n_inf = self.buckets[-1]
        if n_inf:
            top = self.max if self.max > lo else lo
            if t >= top:
                below += n_inf
            elif t > lo:
                below += n_inf * (t - lo) / (top - lo)
        return max(0.0, min(1.0, 1.0 - below / self.count))

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }


class MetricsRegistry:
    """Thread-safe named counters/gauges/histograms with labels."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        self._hists: Dict[_Key, _Histogram] = {}
        #: name -> instrument kind; one name is one kind forever (until
        #: reset) — a second registration under a different kind used to
        #: silently shadow the first in the snapshot
        self._kinds: Dict[str, str] = {}
        #: name -> histogram bucket bounds.  Configuration, not data:
        #: survives :meth:`reset` so module-import-time registrations
        #: (the serve subsystem's ms-resolution latency bounds) hold for
        #: the whole process, including across test resets.
        self._bounds_by_name: Dict[str, Tuple[float, ...]] = {}

    def _check_kind(self, name: str, kind: str) -> None:
        """Must hold self._lock.  Raises :class:`MetricKindError` when
        ``name`` is already a different instrument kind — one dict
        lookup on the hot path."""
        prev = self._kinds.get(name)
        if prev is None:
            self._kinds[name] = kind
        elif prev != kind:
            raise MetricKindError(name, prev, kind)

    # ----------------------------------------------------------- record
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        """Add ``value`` to a monotonic counter."""
        if not enabled():
            return
        k = _key(name, labels)
        with self._lock:
            self._check_kind(name, "counter")
            self._counters[k] = self._counters.get(k, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        """Set a point-in-time gauge."""
        if not enabled():
            return
        with self._lock:
            self._check_kind(name, "gauge")
            self._gauges[_key(name, labels)] = float(value)

    def gauge_max(self, name: str, value: float, **labels) -> None:
        """Raise a gauge to ``value`` if higher (watermark semantics —
        HBM/RSS peaks survive later lower samples)."""
        if not enabled():
            return
        k = _key(name, labels)
        with self._lock:
            self._check_kind(name, "gauge")
            prev = self._gauges.get(k)
            if prev is None or value > prev:
                self._gauges[k] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one sample into a histogram (bucket bounds: the ones
        :meth:`register_buckets` registered for ``name``, else
        :data:`DEFAULT_BUCKETS`)."""
        if not enabled():
            return
        k = _key(name, labels)
        with self._lock:
            self._check_kind(name, "histogram")
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Histogram(
                    self._bounds_by_name.get(name, DEFAULT_BUCKETS)
                )
            h.observe(float(value))

    def register_buckets(self, name: str, bounds) -> None:
        """Register per-metric histogram bucket bounds for ``name``.
        Applies to histograms created AFTER registration (register at
        module import, before the first sample); an already-live series
        keeps the bounds it was born with.  Registration claims the name
        as a histogram — recording it as a counter/gauge afterwards
        raises :class:`MetricKindError`, same as any kind conflict."""
        bounds = tuple(sorted(float(b) for b in bounds))
        if not bounds:
            raise ValueError(f"register_buckets({name!r}): empty bounds")
        with self._lock:
            self._check_kind(name, "histogram")
            self._bounds_by_name[name] = bounds

    def bucket_bounds(self, name: str) -> Tuple[float, ...]:
        """The bucket bounds a new ``name`` histogram would use."""
        with self._lock:
            return self._bounds_by_name.get(name, DEFAULT_BUCKETS)

    # ------------------------------------------------------------- read
    @staticmethod
    def _fmt(k: _Key) -> str:
        name, labels = k
        if not labels:
            return name
        inner = ",".join(f"{lk}={lv}" for lk, lv in labels)
        return f"{name}{{{inner}}}"

    def snapshot(self) -> dict:
        """Plain-dict view: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}`` with ``name{label=value}`` keys."""
        with self._lock:
            return {
                "counters": {self._fmt(k): v for k, v in self._counters.items()},
                "gauges": {self._fmt(k): v for k, v in self._gauges.items()},
                "histograms": {
                    self._fmt(k): h.as_dict() for k, h in self._hists.items()
                },
            }

    def counter_value(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get(_key(name, labels), 0.0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter over every label combination."""
        with self._lock:
            return sum(v for (n, _), v in self._counters.items() if n == name)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_key(name, labels))

    def histogram_value(self, name: str, **labels) -> Optional[dict]:
        """One histogram series as its ``as_dict()`` summary, or None —
        the point read for surfaces that need a couple of series
        (``/statusz``'s prime-ladder block) without paying a full
        ``snapshot()`` copy of every histogram per poll."""
        with self._lock:
            h = self._hists.get(_key(name, labels))
            return None if h is None else h.as_dict()

    def histogram_summary(
        self, name: str, quantiles=(0.5, 0.95, 0.99), **labels
    ) -> Optional[dict]:
        """One histogram series as ``as_dict()`` plus interpolated
        quantiles (``p50``/``p95``/... keys), or None.  The read behind
        ``/statusz`` blocks that need percentiles of a cumulative
        series (fleet apply/wire, ingress parse/admit) without a
        windowed wrapper per label combination."""
        with self._lock:
            h = self._hists.get(_key(name, labels))
            if h is None:
                return None
            out = h.as_dict()
            for q in quantiles:
                out[f"p{int(round(float(q) * 100))}"] = h.quantile(float(q))
            return out

    def counter_series(self, name: str) -> List[Tuple[dict, float]]:
        """Every label combination of one counter, as
        ``(labels_dict, value)`` pairs — the per-kind / per-worker
        breakdown read (``ingress.frame_errors{kind=}``,
        ``serve.net.retransmits{worker=}``)."""
        with self._lock:
            return [
                (dict(labels), v)
                for (n, labels), v in sorted(self._counters.items())
                if n == name
            ]

    def histogram_series(
        self, name: str, quantiles=(0.5, 0.95, 0.99)
    ) -> List[Tuple[dict, dict]]:
        """Every label combination of one histogram, as
        ``(labels_dict, summary)`` pairs (summary per
        :meth:`histogram_summary`)."""
        with self._lock:
            out = []
            for (n, labels), h in sorted(self._hists.items()):
                if n != name:
                    continue
                d = h.as_dict()
                for q in quantiles:
                    d[f"p{int(round(float(q) * 100))}"] = h.quantile(float(q))
                out.append((dict(labels), d))
            return out

    def remove_gauge(self, name: str, **labels) -> None:
        """Drop one gauge series (registry owners evicting dead keys —
        e.g. guard's breaker registry — keep export cardinality bounded
        by removing the series along with the owner's entry)."""
        with self._lock:
            self._gauges.pop(_key(name, labels), None)

    # --------------------------------------------- cross-process shipping
    def export_raw(self):
        """Raw copies of every series, keyed by ``(name, labels)``:
        ``(counters, gauges, hists)`` where a histogram entry is
        ``(bounds, buckets, count, sum, min, max)``.  The worker-side
        delta exporter (``serve/telemetry.py``) diffs two of these;
        unlike :meth:`snapshot` nothing is string-formatted, so the
        shipped keys round-trip exactly."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {
                k: (
                    h.bounds,
                    list(h.buckets),
                    h.count,
                    h.sum,
                    (h.min if h.count else None),
                    (h.max if h.count else None),
                )
                for k, h in self._hists.items()
            }
        return counters, gauges, hists

    def merge_histogram(
        self,
        name: str,
        labels: Dict[str, object],
        bounds,
        buckets,
        count,
        total,
        mn=None,
        mx=None,
    ) -> None:
        """Fold a shipped histogram delta into one series.  The series
        is created with the SHIPPED bounds (a worker's registration,
        not this registry's) so bucket counts merge exactly; a
        bounds/shape mismatch against an existing series drops the
        shipment rather than corrupting the buckets."""
        if not enabled():
            return
        bounds = tuple(float(b) for b in bounds)
        buckets = [int(b) for b in buckets]
        if len(buckets) != len(bounds) + 1:
            return
        k = _key(name, labels)
        with self._lock:
            self._check_kind(name, "histogram")
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Histogram(bounds)
            if h.bounds != bounds:
                return
            h.count += int(count)
            h.sum += float(total)
            for i, n in enumerate(buckets):
                h.buckets[i] += n
            if mn is not None:
                h.min = min(h.min, float(mn))
            if mx is not None:
                h.max = max(h.max, float(mx))

    def merge_entries(self, entries, **extra_labels) -> int:
        """Fold worker-shipped delta entries (the wire format
        ``serve/telemetry.py`` emits: ``["c"|"g"|"h", name, labels,
        data]``) into this registry, with ``extra_labels`` (the
        ``worker=``/``host=`` fan-out) appended to every series.
        Tolerant by contract — a malformed or kind-conflicting entry is
        skipped, never raised (an old/new peer mix must degrade to
        missing telemetry, not a dead fleet).  Returns entries merged."""
        merged = 0
        if not entries:
            return merged
        for entry in entries:
            try:
                kind, name, labels, data = entry
                name = str(name)
                lbl = {str(k): str(v) for k, v in labels}
                for k, v in extra_labels.items():
                    lbl[str(k)] = str(v)
                if kind == "c":
                    self.inc(name, float(data), **lbl)
                elif kind == "g":
                    self.set_gauge(name, float(data), **lbl)
                elif kind == "h":
                    self.merge_histogram(
                        name,
                        lbl,
                        data["bounds"],
                        data["buckets"],
                        data["count"],
                        data["sum"],
                        mn=data.get("min"),
                        mx=data.get("max"),
                    )
                else:
                    continue
                merged += 1
            except (MetricKindError, TypeError, ValueError, KeyError):
                continue
        return merged

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format.  Metric names sanitize
        ``.``/``-`` to ``_``; histograms export ``_count``/``_sum`` plus
        cumulative ``_bucket{le=...}`` series."""

        def san(name: str) -> str:
            return "".join(c if c.isalnum() or c == "_" else "_" for c in name)

        def lbl(labels: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
            parts = [f'{lk}="{lv}"' for lk, lv in labels]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        lines: List[str] = []
        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                lines.append(f"{san(name)}_total{lbl(labels)} {v:g}")
            for (name, labels), v in sorted(self._gauges.items()):
                lines.append(f"{san(name)}{lbl(labels)} {v:g}")
            for (name, labels), h in sorted(self._hists.items()):
                base = san(name)
                lines.append(f"{base}_count{lbl(labels)} {h.count}")
                lines.append(f"{base}_sum{lbl(labels)} {h.sum:g}")
                cum = 0
                for bound, n in zip(h.bounds, h.buckets):
                    cum += n
                    le = 'le="%g"' % bound
                    lines.append(f"{base}_bucket{lbl(labels, le)} {cum}")
                cum += h.buckets[-1]
                inf = 'le="+Inf"'
                lines.append(f"{base}_bucket{lbl(labels, inf)} {cum}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._kinds.clear()
            # bucket registrations are configuration, not data: they
            # survive, and so does the histogram-kind claim they made
            for name in self._bounds_by_name:
                self._kinds[name] = "histogram"


#: the process-wide registry every subsystem reports to
REGISTRY = MetricsRegistry()


class WindowedHistogram:
    """A rolling-window histogram: a ring of per-interval
    :class:`_Histogram` slices merged on read.

    The registry's histograms are cumulative — correct for counters and
    whole-run totals, useless for "p99 over the last minute" (one slow
    hour ago poisons the percentile forever).  This wrapper keeps
    ``intervals`` fixed-width time slices covering ``window_seconds``;
    :meth:`observe` lands the sample in the current slice AND forwards
    it to the process-wide registry under the same ``name`` — so
    ``/metrics`` keeps its cumulative series while ``/statusz`` reads
    the window.  Reads merge the non-expired slices into one histogram
    and answer :meth:`percentile` / :meth:`fraction_above` from it
    (bucket-interpolated: register fine bounds for the name —
    :data:`LATENCY_MS_BUCKETS` — or the estimates are as coarse as
    :data:`DEFAULT_BUCKETS`).

    Lock-cheap: one observe is the registry's lock plus one slot lock;
    an expired slot is recycled in place, so memory is
    ``intervals × len(bounds)`` forever.  ``clock`` is injectable for
    tests (monotonic seconds)."""

    def __init__(
        self,
        name: str,
        window_seconds: float = 60.0,
        intervals: int = 12,
        bounds=None,
        clock=time.monotonic,
        **labels,
    ):
        self.name = name
        self.window_seconds = float(window_seconds)
        self._n = max(1, int(intervals))
        self._interval = self.window_seconds / self._n
        self._labels = labels
        self._bounds = (
            tuple(bounds) if bounds is not None else REGISTRY.bucket_bounds(name)
        )
        self._clock = clock
        self._lock = threading.Lock()
        #: slot -> (interval epoch index, histogram); epoch -1 = empty
        self._ring: List[Tuple[int, _Histogram]] = [
            (-1, _Histogram(self._bounds)) for _ in range(self._n)
        ]

    def observe(self, value: float) -> None:
        REGISTRY.observe(self.name, value, **self._labels)
        if not enabled():
            return
        v = float(value)
        idx = int(self._clock() // self._interval)
        slot = idx % self._n
        with self._lock:
            epoch, h = self._ring[slot]
            if epoch != idx:  # slot holds an expired interval: recycle
                h = _Histogram(self._bounds)
                self._ring[slot] = (idx, h)
            h.observe(v)

    def merged(self) -> _Histogram:
        """One histogram over every non-expired interval (the window)."""
        idx = int(self._clock() // self._interval)
        m = _Histogram(self._bounds)
        with self._lock:
            for epoch, h in self._ring:
                if epoch >= 0 and idx - epoch < self._n:
                    h.merge_into(m)
        return m

    def percentile(self, p: float) -> Optional[float]:
        """Windowed percentile (``p`` in 0..100), or None when empty."""
        return self.merged().quantile(p / 100.0)

    def fraction_above(self, threshold: float) -> float:
        return self.merged().fraction_above(threshold)

    def summary(self) -> dict:
        """Windowed ``{count, sum, min, max, p50, p95, p99,
        window_seconds}`` — the shape ``/statusz`` embeds."""
        m = self.merged()
        return {
            "count": m.count,
            "sum": m.sum,
            "min": m.min if m.count else None,
            "max": m.max if m.count else None,
            "p50": m.quantile(0.50),
            "p95": m.quantile(0.95),
            "p99": m.quantile(0.99),
            "window_seconds": self.window_seconds,
        }


# module-level conveniences (the instrumented call sites use these)
inc = REGISTRY.inc
observe = REGISTRY.observe
set_gauge = REGISTRY.set_gauge
gauge_max = REGISTRY.gauge_max
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset
register_buckets = REGISTRY.register_buckets
