"""Stdlib-only HTTP front end for a :class:`PipelineService` (counterpart
of ``keystone_tpu/serve/http.py``: the same endpoints, bodies, status
codes and headers).

Endpoints (JSON unless noted):

- ``POST /predict`` — body ``{"instances": [<datum>, ...]}`` (or
  ``{"instance": <datum>}``), optional ``"deadline_ms"`` (and
  ``"tenant"``, which this single-tenant service answers with 400).
  Replies ``{"predictions": [...]}``.  **429** when admission control
  rejects (``Overloaded``, with a ``Retry-After`` from the EWMA flush
  time), **504** when the request was shed past its deadline, **400** on
  a malformed body or a mis-shaped datum, **422** when the request's
  content breaks the model (``PoisonRequest``), **503** on shutdown and
  on a fleet with no serving replica (``FleetUnavailable``, with a
  derived ``Retry-After``).
- ``GET /healthz`` — liveness, queue depth, the live model version and
  per-replica status; **503** (with ``Retry-After``) while the fleet is
  unavailable.
- ``GET /replicas`` — the per-replica status list alone.
- ``GET /metrics`` — the process metrics registry in Prometheus text.
- ``GET /statusz`` — the rolling-window ops view (``PipelineService.status``).
- ``GET /tracez`` — recent request traces from the flight recorder
  (``?filter=``, ``?limit=N``, ``?full=1``); 409 with the recorder off.
- ``GET /requestz/<id>`` — one request's causal chain; 404 for an
  unknown or evicted id.
- ``POST /tracez/dump`` — write the recorder's state to a directory (the
  body's ``dir``, else the front end's ``trace_dump_dir``).
- ``POST /swap`` — admin hot-swap from the attached model registry
  (``registry=``): body ``{"version": "v0002"}`` (default: the
  registry's deploy pick), the version's artifacts shipped with it;
  ``"clear_bad": true`` lifts a quarantine first, and the rollout knobs
  of ``RolloutConfig.REQUEST_KEYS`` (``"canary"`` et al.) make it a
  guarded rollout (a bad knob is a 400; a verdict either way is a 200).
  ``CURRENT`` follows the swap.  409 with no registry, 404 unknown
  version, 503 closed, 502 the load or swap failed.
- ``POST /rollback`` — swap back to the newest prior version of the
  swap history that is published and not quarantined, ``CURRENT`` with
  it, recorded as a ``manual`` episode of ``/rolloutz``'s history; 409
  when there is none.
- ``GET /rolloutz`` — the guarded-rollout status block
  (``PipelineService.rollout_status``).

``POST /predict`` honors an ``X-Request-Id`` header (else mints an id)
and echoes it in every response, body and header; a multi-instance body
fans sub-ids ``<id>/0``, ``<id>/1``, ...

``ThreadingHTTPServer`` (HTTP/1.1 keep-alive, one thread per
connection): handler threads block on their futures while the replica
workers do the device work.  Bind ``port=0`` for an ephemeral port.

Usage::

    front = serve_http(svc, port=8000)   # started, background thread
    ...
    front.stop(); svc.close()
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlsplit

import numpy as np

from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.obs.recorder import new_request_id
from keystone_tpu_torch.serve.fleet import FleetUnavailable
from keystone_tpu_torch.serve.service import (
    Overloaded,
    PipelineService,
    PoisonRequest,
    ServiceClosed,
)
from keystone_tpu_torch.utils import guard

logger = logging.getLogger(__name__)

#: per-request result wait: generous — the service's own deadline/shed
#: machinery is the real latency bound; this only stops a handler thread
#: leaking forever if the service is killed under it
_RESULT_TIMEOUT_S = 120.0


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 with Content-Length on every response => persistent
    # connections: a client's request stream reuses its thread and its
    # TCP handshake
    protocol_version = "HTTP/1.1"

    #: idle keep-alive bound: a silent persistent connection releases
    #: its thread after this (socketserver applies it via settimeout;
    #: handle_one_request maps the timeout to close_connection)
    timeout = 65.0

    # route access logs to logging (debug), not stderr
    def log_message(self, fmt, *args):
        logger.debug("http: " + fmt, *args)

    @property
    def service(self) -> PipelineService:
        return self.server.service  # type: ignore[attr-defined]

    def _send(self, code: int, payload, content_type="application/json", headers=()):
        body = (
            payload
            if isinstance(payload, bytes)
            else json.dumps(payload).encode("utf-8")
        )
        # a client that hung up mid-exchange (impatient curl, a load
        # balancer health probe, a bencher's ^C) must not crash the
        # handler thread with an uncaught BrokenPipeError — the
        # response has no one to go to; drop it and close our side
        try:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError, TimeoutError) as e:
            self.close_connection = True
            logger.debug("http: client disconnected mid-response: %s", e)

    def do_GET(self):
        parts = urlsplit(self.path)
        path, query = parts.path, parse_qs(parts.query)
        if path == "/healthz":
            svc = self.service
            # an unavailable fleet (every replica quarantined/dead/
            # breaker-open) answers non-200 so a load balancer takes the
            # process out of rotation; the supervisor's first successful
            # restart flips it back
            available = svc.available
            code = 200 if available or svc.closed else 503
            self._send(
                code,
                {
                    "status": (
                        "closed"
                        if svc.closed
                        else ("ok" if available else "unavailable")
                    ),
                    "queue_depth": svc.queue_depth,
                    "queue_bound": svc.queue_bound,
                    "max_batch": svc.max_batch,
                    "buckets": list(svc.buckets),
                    "version": svc.version,
                    # process-fleet visibility: backend + worker count,
                    # so a balancer (or operator curl) sees the fleet
                    # shape without parsing the per-replica list
                    "backend": svc._pool.backend,
                    "workers": svc.replicas,
                    "replicas": svc.replica_statuses(),
                },
                headers=(
                    ()
                    if code == 200
                    else (
                        (
                            "Retry-After",
                            str(
                                max(
                                    1,
                                    math.ceil(svc.unavailable_retry_after()),
                                )
                            ),
                        ),
                    )
                ),
            )
        elif path == "/replicas":
            self._send(200, {"replicas": self.service.replica_statuses()})
        elif path == "/statusz":
            self._send(200, self.service.status())
        elif path == "/rolloutz":
            self._send(200, self.service.rollout_status())
        elif path == "/tracez":
            self._do_tracez(query)
        elif path.startswith("/requestz/"):
            # unquote: a client-supplied X-Request-Id may need
            # percent-encoding in the URL; the trace is stored under
            # the raw id
            self._do_requestz(unquote(path[len("/requestz/"):]))
        elif path == "/metrics":
            self._send(
                200,
                metrics.REGISTRY.to_prometheus_text().encode("utf-8"),
                content_type="text/plain; version=0.0.4",
            )
        else:
            self._send(404, {"error": f"no such path {self.path!r}"})

    def _recorder_or_409(self):
        rec = self.service.recorder
        if rec is None:
            self._send(
                409,
                {
                    "error": "flight recorder disabled; start the service "
                    "with recorder=True (the default) to trace requests"
                },
            )
        return rec

    def _do_tracez(self, query):
        rec = self._recorder_or_409()
        if rec is None:
            return
        flt = (query.get("filter") or [None])[0]
        try:
            limit = int((query.get("limit") or ["50"])[0])
        except ValueError:
            self._send(400, {"error": "limit must be an integer"})
            return
        full = (query.get("full") or ["0"])[0] not in ("", "0", "false")
        if full:
            out = rec.dump()
            if flt:
                out["traces"] = [
                    t
                    for t in out["traces"]
                    if (t["slow"] if flt == "slow" else t["outcome"] == flt)
                ]
            self._send(200, out)
            return
        self._send(
            200,
            {
                "traces": rec.tracez(filter=flt, limit=limit),
                "ops": rec.ops_spans(limit=limit),
                "stats": rec.stats(),
            },
        )

    def _do_requestz(self, request_id: str):
        rec = self._recorder_or_409()
        if rec is None:
            return
        trace = rec.request(request_id)
        if trace is None:
            self._send(
                404,
                {
                    "error": f"no trace for request id {request_id!r} "
                    "(unknown, or evicted from the ring — shed/error/slow "
                    "traces are retained longest)"
                },
            )
            return
        self._send(200, trace)

    def do_POST(self):
        if self.path == "/swap":
            self._do_swap()
            return
        if self.path == "/rollback":
            self._do_rollback()
            return
        if self.path == "/tracez/dump":
            self._do_trace_dump()
            return
        if self.path != "/predict":
            self._send(404, {"error": f"no such path {self.path!r}"})
            return
        # the trace identity: honor the client's X-Request-Id, else mint
        # one — resolved BEFORE parsing so even a 400 echoes an id, and
        # echoed in every response body + X-Request-Id header so the
        # client can always quote the id /requestz/<id> resolves
        rid = (self.headers.get("X-Request-Id") or "").strip() or new_request_id()
        hdrs = (("X-Request-Id", rid),)
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"{}")
            if "instances" in body:
                instances = body["instances"]
            elif "instance" in body:
                instances = [body["instance"]]
            else:
                raise ValueError('body needs "instances" or "instance"')
            arr = np.asarray(instances, dtype=np.float32)
            # the JSON path materializes every payload byte at least once
            # (text → floats → array)
            metrics.inc("ingress.bytes_copied", int(arr.nbytes))
            deadline_ms = body.get("deadline_ms")
            deadline = None if deadline_ms is None else float(deadline_ms) / 1000.0
            # multi-tenant routing: the body names its tenant; a
            # single-tenant service refuses a tenant (TypeError → 400)
            tenant = body.get("tenant")
            tenant = None if tenant is None else str(tenant)
        except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
            self._send(
                400, {"error": f"bad request: {e}", "request_id": rid}, headers=hdrs
            )
            return
        # one HTTP request = one trace id; a multi-instance body fans
        # out sub-ids so each datum's causal chain resolves individually
        ids = [rid] if len(arr) == 1 else [f"{rid}/{i}" for i in range(len(arr))]
        rec = self.service.recorder
        if rec is not None:
            for i in ids:
                rec.annotate(i, "http.ingress", path="/predict", instances=len(arr))
        id_body = {"request_id": rid}
        if len(ids) > 1:
            id_body["request_ids"] = ids
        try:
            futs = self.service.submit_many(
                arr, deadline=deadline, request_ids=ids, tenant=tenant
            )
        except Overloaded as e:
            # Retry-After from the EWMA flush-completion estimate the
            # shedding path maintains: the header is delta-seconds (an
            # integer, so ceiled, >= 1); the body carries the exact hint
            hint = self.service.retry_after_hint()
            self._send(
                429,
                {"error": str(e), "retry_after_seconds": hint, **id_body},
                headers=hdrs + (("Retry-After", str(max(1, math.ceil(hint)))),),
            )
            return
        except PoisonRequest as e:
            # the request's CONTENT breaks the model (bisection-isolated
            # or quarantine-cache matched): the client's fault — 422,
            # not 500, and retrying it unchanged will fail again
            self._send_poison(e, id_body, hdrs)
            return
        except FleetUnavailable as e:
            # no replica can serve: fail fast with the derived retry
            # hint (breaker probe ETA / supervisor restart)
            self._send_unavailable(e, id_body, hdrs)
            return
        except ServiceClosed as e:
            self._send(503, {"error": str(e), **id_body}, headers=hdrs)
            return
        except guard.CircuitOpenError as e:
            # THIS tenant's admission breaker is open (repeated
            # failures): back off — co-served tenants are unaffected
            self._send(
                429,
                {"error": str(e), "retry_after_seconds": 1.0, **id_body},
                headers=hdrs + (("Retry-After", "1"),),
            )
            return
        except TypeError as e:  # shape mismatch / bad tenant: CLIENT fault
            self._send(
                400, {"error": f"bad request: {e}", **id_body}, headers=hdrs
            )
            return
        except Exception as e:  # e.g. injected fault
            self._send(
                500,
                {"error": f"{type(e).__name__}: {e}", **id_body},
                headers=hdrs,
            )
            return
        try:
            preds = [
                np.asarray(f.result(timeout=_RESULT_TIMEOUT_S)).tolist()
                for f in futs
            ]
        except guard.DeadlineExceeded as e:
            self._send(504, {"error": str(e), **id_body}, headers=hdrs)
            return
        except PoisonRequest as e:  # isolated mid-flight by bisection
            self._send_poison(e, id_body, hdrs)
            return
        except FleetUnavailable as e:  # batch failed fast after admission
            self._send_unavailable(e, id_body, hdrs)
            return
        except Exception as e:
            self._send(
                500,
                {"error": f"{type(e).__name__}: {e}", **id_body},
                headers=hdrs,
            )
            return
        self._send(200, {"predictions": preds, **id_body}, headers=hdrs)

    def _send_poison(self, e, id_body, hdrs):
        """422: the request's content breaks the model (PoisonRequest,
        at admission via the quarantine cache or mid-flight via
        bisection) — one response shape for both paths."""
        self._send(422, {"error": str(e), **id_body}, headers=hdrs)

    def _send_unavailable(self, e, id_body, hdrs):
        """503 + derived Retry-After for FleetUnavailable, whether it
        was raised at admission or delivered through the future."""
        self._send(
            503,
            {
                "error": str(e),
                "retry_after_seconds": e.retry_after_seconds,
                **id_body,
            },
            headers=hdrs
            + (
                (
                    "Retry-After",
                    str(max(1, math.ceil(e.retry_after_seconds))),
                ),
            ),
        )

    def _do_trace_dump(self):
        """Write the flight recorder's state durably to disk (the
        incident-time snapshot ``tools/trace_report.py`` reads offline).
        Directory: the request body's ``dir`` key, else the configured
        ``--trace-dump`` directory.  Codes: 200 with the written path,
        409 when tracing is off or no directory is known, 400 bad body,
        500 the write itself failed."""
        rec = self._recorder_or_409()
        if rec is None:
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"{}") or {}
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": f"bad request: {e}"})
            return
        dir_path = body.get("dir") or getattr(
            self.server, "trace_dump_dir", None
        )
        if not dir_path:
            self._send(
                409,
                {
                    "error": "no trace-dump directory configured; start "
                    'with `python -m keystone_tpu_torch.cli serve --trace-dump DIR` or POST '
                    '{"dir": "..."}'
                },
            )
            return
        try:
            path = self.service.dump_trace(str(dir_path))
        except OSError as e:
            self._send(500, {"error": f"trace dump failed: {e}"})
            return
        self._send(200, {"path": path, "stats": rec.stats()})

    def _registry_or_409(self):
        registry = getattr(self.server, "registry", None)
        if registry is None:
            self._send(409, {"error": "no model registry attached; start the frontend with serve_http(svc, "
                                      "registry=...) or `cli serve --model-dir`"})
        return registry

    def _do_swap(self):
        """Admin blue/green swap from the attached registry.  Codes: 200
        swapped (or a guarded rollout's verdict), 400 a bad body or
        rollout knob, 409 no registry, 404 unknown version, 503 service
        closed, 502 the load or swap failed (the old version serves on)."""
        registry = self._registry_or_409()
        if registry is None:
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"{}") or {}
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            version = body.get("version")
            # a malformed rollout knob is a 400 here, not a 502 from deep
            # inside the episode
            rollout_cfg = None
            if body.get("canary") is not None:
                from keystone_tpu_torch.serve.rollout import RolloutConfig

                rollout_cfg = RolloutConfig.from_request(body)
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": f"bad request: {e}"})
            return
        from keystone_tpu_torch.serve.registry import RegistryError

        try:
            if body.get("clear_bad") and version:
                # the operator's explicit override of a quarantine
                registry.clear_quarantine(version)
            fitted, ver = registry.load(version, map_location=self.service.device)
            # the version's artifacts ship with it, as the watcher's do
            arts = registry.load_artifacts(ver)
            if rollout_cfg is not None:
                # the controller owns CURRENT here: moved on a commit,
                # restored (with the quarantine) on a rollback
                from keystone_tpu_torch.serve.rollout import guarded_swap

                info = guarded_swap(self.service, fitted, version=ver, artifacts=arts, config=rollout_cfg,
                                    registry=registry)
                self._send(200, info)
                return
            info = self.service.swap(fitted, version=ver, artifacts=arts)
        except RegistryError as e:
            self._send(404, {"error": str(e)})
            return
        except ServiceClosed as e:
            self._send(503, {"error": str(e)})
            return
        except Exception as e:
            logger.warning("admin swap failed: %s: %s", type(e).__name__, e)
            self._send(502, {"error": f"swap failed: {type(e).__name__}: {e}"})
            return
        # the registry is the source of truth: CURRENT follows what the
        # fleet serves, or a watcher would revert the admin swap
        info = self._move_current(registry, ver, info)
        self._send(200, info)

    @staticmethod
    def _move_current(registry, ver: str, info: dict) -> dict:
        try:
            if registry.current() != ver:
                registry.set_current(ver)
        except Exception as e:
            logger.warning("swap to %s succeeded but CURRENT update failed: %s", ver, e)
            info = dict(info)
            info["current_pointer_error"] = f"{type(e).__name__}: {e}"
        return info

    def _do_rollback(self):
        """Admin revert: swap back to the newest version of the service's
        swap history that is published and not quarantined, and move
        ``CURRENT`` with it.  Codes: 200 reverted (the swap info plus
        ``rolled_back_to`` / ``rolled_back_from``), 409 no registry or no
        viable prior version, 503 closed, 502 the load or swap failed."""
        registry = self._registry_or_409()
        if registry is None:
            return
        svc = self.service
        from keystone_tpu_torch.serve.registry import RegistryError

        history = svc._version_history
        published = set(registry.versions())
        target = target_idx = None
        for idx in range(len(history) - 1, -1, -1):
            cand = history[idx]
            if cand == svc.version or cand not in published or registry.quarantined(cand) is not None:
                continue
            target, target_idx = cand, idx
            break
        if target is None:
            self._send(409, {"error": "no viable prior version in swap history (nothing swapped yet, or every "
                                      "prior version is unpublished or quarantined)", "history": list(history)})
            return
        from_version = svc.version
        try:
            fitted, ver = registry.load(target, map_location=svc.device)
            info = svc.swap(fitted, version=ver, artifacts=registry.load_artifacts(ver))
        except RegistryError as e:
            self._send(404, {"error": str(e)})
            return
        except ServiceClosed as e:
            self._send(503, {"error": str(e)})
            return
        except Exception as e:
            logger.warning("admin rollback failed: %s: %s", type(e).__name__, e)
            self._send(502, {"error": f"rollback failed: {type(e).__name__}: {e}"})
            return
        # drop the walked-past suffix (the entry swap() just appended for
        # the version reverted from included): a repeated /rollback walks
        # further back, never ping-pongs
        del history[target_idx:]
        metrics.inc("serve.rollout.manual_rollbacks")
        # an episode of /rolloutz's history like the guarded ones (the
        # reference records it in the flight recorder only)
        svc._rollout_history.append({"version": ver, "from_version": from_version, "verdict": "rolled_back",
                                     "reason": "manual", "canary_fraction": None, "at": time.time()})
        ledger.event("serve.rollout", from_version=from_version, to_version=ver, verdict="rolled_back",
                     reason="manual")
        if svc.recorder is not None:
            svc.recorder.ops("serve.rollout", from_version=from_version, to_version=ver, verdict="rolled_back",
                             reason="manual")
        info = dict(self._move_current(registry, ver, info))
        info["rolled_back_to"] = ver
        info["rolled_back_from"] = from_version
        self._send(200, info)


class HttpFrontend:
    """A :class:`ThreadingHTTPServer` bound to a service.  ``start()``
    runs it on a background thread (tests, embedding); ``serve_forever``
    runs it on the caller's thread (the CLI).  ``port=0`` binds an
    ephemeral port, readable from :attr:`port` after construction."""

    def __init__(
        self,
        service: PipelineService,
        host: str = "127.0.0.1",
        port: int = 8000,
        registry=None,
        trace_dump_dir: Optional[str] = None,
    ):
        self.server = ThreadingHTTPServer((host, port), _Handler)
        self.server.service = service  # type: ignore[attr-defined]
        #: the ModelRegistry behind POST /swap and /rollback (None: 409)
        self.server.registry = registry  # type: ignore[attr-defined]
        #: default directory for POST /tracez/dump (None: the endpoint
        #: needs an explicit "dir" in its body)
        self.server.trace_dump_dir = trace_dump_dir  # type: ignore[attr-defined]
        self.server.daemon_threads = True
        self.host = host
        self._thread: Optional[threading.Thread] = None
        self._started = False

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    def start(self) -> "HttpFrontend":
        self._started = True
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True, name="serve-http"
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._started = True
        self.server.serve_forever()

    def stop(self) -> None:
        # shutdown() blocks on an event only serve_forever sets — on a
        # never-started frontend it would wait forever; just close the
        # socket in that case
        if self._started:
            self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(5.0)

    def __enter__(self) -> "HttpFrontend":
        if not self._started:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class _DelegateServer:
    """The ``server`` object :class:`_Handler` reads when a connection
    comes from outside a ``ThreadingHTTPServer``: the binary ingress
    (``serve/ingress.py``) sniffs an HTTP client on its port and hands
    the accepted socket here, so every endpoint keeps one
    implementation."""

    def __init__(self, service: PipelineService, registry=None, trace_dump_dir=None):
        self.service = service
        self.registry = registry
        self.trace_dump_dir = trace_dump_dir


def handle_http_connection(sock, client_address, service: PipelineService, registry=None,
                           trace_dump_dir=None) -> None:
    """Serve one accepted connection with the stdlib handler (blocking:
    run it on its own thread).  The handler's keep-alive loop serves the
    connection's whole request stream; the socket is closed on return."""
    try:
        _Handler(sock, client_address, _DelegateServer(service, registry, trace_dump_dir))
    except OSError as e:
        logger.debug("http: delegated connection died: %s", e)
    finally:
        try:
            sock.close()
        except OSError:
            pass


def serve_http(
    service: PipelineService,
    host: str = "127.0.0.1",
    port: int = 8000,
    registry=None,
    trace_dump_dir: Optional[str] = None,
) -> HttpFrontend:
    """Stand up (and start) the HTTP front end for ``service`` on a
    background thread; returns the :class:`HttpFrontend` (``.port`` for
    ephemeral binds, ``.stop()`` to shut down).  ``registry``: the
    :class:`~keystone_tpu_torch.serve.registry.ModelRegistry` enabling
    ``POST /swap`` and ``POST /rollback``.
    ``trace_dump_dir``: default
    directory for ``POST /tracez/dump`` snapshots."""
    return HttpFrontend(
        service,
        host=host,
        port=port,
        registry=registry,
        trace_dump_dir=trace_dump_dir,
    ).start()
