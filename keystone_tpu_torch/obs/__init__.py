"""Structured observability: the metrics registry and the run ledger
(counterpart of ``keystone_tpu/obs/__init__.py``).

- :mod:`keystone_tpu_torch.obs.metrics` — thread-safe counters, gauges and
  histograms (``REGISTRY``), exported as JSON or Prometheus text.  Always
  on (a bump is one lock and a dict update); ``KEYSTONE_METRICS=0``
  disables recording.
- :mod:`keystone_tpu_torch.obs.ledger` — a per-run JSONL span/event
  stream, activated by ``KEYSTONE_OBS_DIR`` or ``ledger.start_run``;
  default OFF and inert.  Spans open a ``torch.profiler.record_function``
  of their name and sample device-memory and RSS watermarks.  Long-lived
  runs rotate past ``KEYSTONE_OBS_MAX_BYTES`` into
  ``KEYSTONE_OBS_KEEP_SEGMENTS`` numbered segments.
- :mod:`keystone_tpu_torch.obs.recorder` — the serving path's flight
  recorder: a bounded in-memory store of request traces, batch records
  and ops spans with tail-based retention (``FlightRecorder``,
  ``new_request_id``), ON by default in ``serve()``.

The fleet's telemetry (the spans, metric deltas and kernel reports its
worker processes ship, and the router's sink) is
``keystone_tpu_torch/serve/telemetry.py``.
"""

from keystone_tpu_torch.obs import ledger, metrics, recorder  # noqa: F401
from keystone_tpu_torch.obs.ledger import RunLedger, event, span, start_run, stop_run  # noqa: F401
from keystone_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry, WindowedHistogram  # noqa: F401
from keystone_tpu_torch.obs.recorder import FlightRecorder, new_request_id  # noqa: F401
