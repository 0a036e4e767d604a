#!/usr/bin/env python
"""Render request-trace reports from a flight-recorder dump or a run
ledger: per-request critical-path breakdown, top-k slow requests, and
per-replica flush timelines (counterpart of the repo's
``tools/trace_report.py``: the same inputs, report, CLI and ``--json``).
The port's recorder (``obs/recorder.py``) and its ``serve.request`` and
``serve.batch`` ledger lines keep the reference's schema, so either
package's dump or ledger reads the same here.

Inputs (auto-detected):

- a **recorder dump** — the JSON ``GET /tracez?full=1`` returns
  (``{"traces": [...], "batches": [...], "ops": [...]}``; save it with
  ``curl .../tracez?full=1 > dump.json``).  Richest mode: every trace
  carries its event offsets, so the report decomposes each request's
  latency into **queue wait** (enqueue → flush start) vs **apply**
  (the flush's apply, host clock around the card's work, from the
  batch record) vs **fan-out** (apply end →
  terminal), plus the padding waste (``bucket - rows``).  When the
  fleet telemetry stitched worker-shipped spans into a batch record,
  the report also shows the cross-process chain: which
  ``worker@host`` applied the flush, the exchange's wire RTT, and the
  worker-clock ``worker.apply`` span aligned to the router timeline.
- a **ledger file** — a ``run_<id>.jsonl`` written with the JSONL
  ledger active (``KEYSTONE_OBS_DIR``): ``serve.request`` events carry
  each request's outcome/latency/queue-wait and ``serve.batch``
  span_end lines carry per-flush rows/bucket/replica/seconds with the
  rider request ids as span links.

Usage::

    python -m keystone_tpu_torch.tools.trace_report dump.json [--top 10] [--json]
    python -m keystone_tpu_torch.tools.trace_report obs/run_abc.jsonl [--top 10] [--json]

It reads files only (stdlib), and touches no device.

The incident-debugging loop this closes: a client
quotes the ``request_id`` echoed in its response → ``GET
/requestz/<id>`` shows the causal chain → this tool says where the
fleet as a whole spends its tail latency.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional


# ---------------------------------------------------------------- loading


def load_dump(path: str) -> dict:
    """Normalize a recorder dump into ``{"requests": [...],
    "batches": {id: rec}, "ops": [...]}`` with per-request critical-path
    components."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    batches = {b["batch"]: b for b in data.get("batches", []) if "batch" in b}
    requests = [
        _breakdown_from_trace(tr, batches) for tr in data.get("traces", [])
    ]
    return {
        "source": "recorder",
        "requests": [r for r in requests if r is not None],
        "batches": batches,
        "ops": data.get("ops", []),
    }


def _first_event(trace: dict, name: str) -> Optional[dict]:
    for e in trace.get("events", []):
        if e.get("name") == name:
            return e
    return None


def _fleet_from_batch(b: Optional[dict]) -> dict:
    """Pull the worker-shipped stitching (``FleetTelemetry._ingest``'s
    ``batch_update``) out of a batch record: who applied it, the wire
    accounting around the exchange, and the router-aligned worker
    spans.  Absent for local-replica flushes and pre-fleet dumps — every
    field degrades to ``None`` so old dumps render unchanged."""
    wire = (b or {}).get("wire") or {}
    spans = (b or {}).get("worker_spans") or []
    worker_apply = None
    for sp in spans:
        if isinstance(sp, dict) and sp.get("name") == "worker.apply":
            worker_apply = sp.get("seconds")
            break
    return {
        "worker": (b or {}).get("worker"),
        "host": (b or {}).get("host"),
        "wire_rtt_s": wire.get("rtt_s"),
        "wire_send_s": wire.get("send_s"),
        "wire_recv_s": wire.get("recv_s"),
        "worker_apply_s": worker_apply,
        "worker_spans": [
            {
                "name": sp.get("name"),
                "t_off": sp.get("t_off"),
                "seconds": sp.get("seconds"),
            }
            for sp in spans
            if isinstance(sp, dict)
        ],
    }


def _breakdown_from_trace(trace: dict, batches: Dict[str, dict]) -> Optional[dict]:
    rid = trace.get("request_id")
    if rid is None:
        return None
    total = trace.get("seconds")
    rep = _first_event(trace, "serve.batch")
    attrs = (rep or {}).get("attrs") or {}
    queue_wait = attrs.get("queue_wait_seconds")
    bid = attrs.get("batch")
    b = batches.get(bid) if bid is not None else None
    apply_s = (b or {}).get("seconds")
    fanout = None
    if total is not None and rep is not None and apply_s is not None:
        fanout = max(0.0, total - rep["t"] - apply_s)
    pad_rows = None
    if b and b.get("bucket") is not None and b.get("rows") is not None:
        pad_rows = int(b["bucket"]) - int(b["rows"])
    return {
        "request_id": rid,
        "ts": trace.get("ts"),
        "outcome": trace.get("outcome"),
        "slow": trace.get("slow", False),
        "seconds": total,
        "queue_wait_s": queue_wait,
        "apply_s": apply_s,
        "fanout_s": fanout,
        "replica": attrs.get("replica"),
        "batch": bid,
        "pad_rows": pad_rows,
        **_fleet_from_batch(b),
        "events": [e.get("name") for e in trace.get("events", [])],
    }


def load_ledger(path: str) -> dict:
    """Reconstruct the same report shape from a run ledger:
    ``serve.request`` events + ``serve.batch`` span_end lines."""
    requests: List[dict] = []
    batches: Dict[str, dict] = {}
    ops: List[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                continue  # a torn final line must not hide the run
            attrs = e.get("attrs") or {}
            kind, name = e.get("kind"), e.get("name")
            if kind == "event" and name == "serve.request":
                requests.append(
                    {
                        "request_id": attrs.get("request_id"),
                        "ts": e.get("ts"),
                        "outcome": attrs.get("outcome"),
                        "slow": False,
                        "seconds": attrs.get("seconds"),
                        "queue_wait_s": attrs.get("queue_wait_seconds"),
                        "apply_s": None,  # joined below via the batch
                        "fanout_s": None,
                        "replica": attrs.get("replica"),
                        "batch": attrs.get("batch"),
                        "pad_rows": None,
                        **_fleet_from_batch(None),
                        "events": [],
                        "error": attrs.get("error"),
                    }
                )
            elif kind == "span_end" and name == "serve.batch":
                bid = attrs.get("batch")
                if bid is not None:
                    batches[bid] = {
                        "batch": bid,
                        "ts": e.get("ts"),
                        "seconds": e.get("seconds"),
                        "rows": attrs.get("rows"),
                        "bucket": attrs.get("bucket"),
                        "replica": attrs.get("replica"),
                        "request_ids": attrs.get("request_ids") or [],
                    }
            elif kind == "span_end" and name == "serve.swap":
                ops.append(
                    {"ts": e.get("ts"), "name": name, **attrs}
                )
    for r in requests:
        b = batches.get(r["batch"]) if r["batch"] is not None else None
        if b is not None:
            r["apply_s"] = b.get("seconds")
            if b.get("bucket") is not None and b.get("rows") is not None:
                r["pad_rows"] = int(b["bucket"]) - int(b["rows"])
            if (
                r["seconds"] is not None
                and r["queue_wait_s"] is not None
                and r["apply_s"] is not None
            ):
                r["fanout_s"] = max(
                    0.0, r["seconds"] - r["queue_wait_s"] - r["apply_s"]
                )
    return {
        "source": "ledger",
        "requests": requests,
        "batches": batches,
        "ops": ops,
    }


def load(path: str) -> dict:
    """Auto-detect the input: ledger mode for anything named ``.jsonl``
    INCLUDING rotated segments (``run_<id>.jsonl.000001`` — the
    size-cap rotation this tool ships alongside), recorder-dump mode
    otherwise."""
    if ".jsonl" in os.path.basename(path):
        return load_ledger(path)
    return load_dump(path)


# -------------------------------------------------------------- summarize


def _mean(vals: List[float]) -> Optional[float]:
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None


def summarize(data: dict, top: int = 10, timeline: int = 25) -> dict:
    """The report dict: outcome counts, critical-path aggregates, top-k
    slow requests, and per-replica flush timelines."""
    reqs = data["requests"]
    outcomes: Dict[str, int] = {}
    for r in reqs:
        outcomes[r["outcome"] or "open"] = outcomes.get(r["outcome"] or "open", 0) + 1
    finished = [r for r in reqs if r["seconds"] is not None]
    top_slow = sorted(finished, key=lambda r: -r["seconds"])[: max(1, top)]
    critical = {
        "queue_wait_s": _mean([r["queue_wait_s"] for r in finished]),
        "apply_s": _mean([r["apply_s"] for r in finished]),
        "worker_apply_s": _mean([r.get("worker_apply_s") for r in finished]),
        "wire_rtt_s": _mean([r.get("wire_rtt_s") for r in finished]),
        "fanout_s": _mean([r["fanout_s"] for r in finished]),
        "pad_rows": _mean(
            [r["pad_rows"] for r in finished if r["pad_rows"] is not None]
        ),
        "seconds": _mean([r["seconds"] for r in finished]),
    }
    # per-worker rollup of the stitched exchanges: batch records carry
    # the shipping, so aggregate over batches (one entry per flush) to
    # avoid multiply-counting a flush once per rider
    workers: Dict[str, dict] = {}
    for b in data["batches"].values():
        w = b.get("worker")
        if w is None:
            continue
        f = _fleet_from_batch(b)
        agg = workers.setdefault(
            str(w),
            {"host": f["host"], "flushes": 0, "apply_s": [], "rtt_s": []},
        )
        agg["flushes"] += 1
        if f["worker_apply_s"] is not None:
            agg["apply_s"].append(f["worker_apply_s"])
        if f["wire_rtt_s"] is not None:
            agg["rtt_s"].append(f["wire_rtt_s"])
    fleet = {
        w: {
            "host": agg["host"],
            "flushes": agg["flushes"],
            "apply_s_mean": _mean(agg["apply_s"]),
            "wire_rtt_s_mean": _mean(agg["rtt_s"]),
        }
        for w, agg in sorted(workers.items())
    }
    timelines: Dict[str, List[dict]] = {}
    for b in sorted(data["batches"].values(), key=lambda b: b.get("ts") or 0):
        rep = str(b.get("replica"))
        timelines.setdefault(rep, []).append(
            {
                "batch": b["batch"],
                "ts": b.get("ts"),
                "rows": b.get("rows"),
                "bucket": b.get("bucket"),
                "seconds": b.get("seconds"),
                "riders": len(b.get("request_ids") or []),
            }
        )
    for rep in timelines:
        timelines[rep] = timelines[rep][-max(1, timeline):]
    return {
        "source": data["source"],
        "requests": len(reqs),
        "outcomes": outcomes,
        "critical_path_mean": critical,
        "top_slow": [
            {k: v for k, v in r.items() if k != "events"} for r in top_slow
        ],
        "fleet": fleet,
        "replica_timelines": timelines,
        "ops": data["ops"][-max(1, top):],
    }


def render(summary: dict) -> str:
    ms = lambda v: "-" if v is None else f"{1000.0 * v:8.2f}ms"  # noqa: E731
    lines = [
        f"trace report ({summary['source']}): "
        f"{summary['requests']} requests",
        "outcomes: "
        + ", ".join(f"{k}={v}" for k, v in sorted(summary["outcomes"].items())),
        "critical path (mean): "
        + " | ".join(
            f"{k.replace('_s', '')} {ms(v) if k != 'pad_rows' else v}"
            for k, v in summary["critical_path_mean"].items()
        ),
        "",
        f"top {len(summary['top_slow'])} slow requests:",
    ]
    for r in summary["top_slow"]:
        line = (
            f"  {r['request_id']}: {ms(r['seconds'])} "
            f"[{r['outcome']}] queue {ms(r['queue_wait_s'])} "
            f"apply {ms(r['apply_s'])} fanout {ms(r['fanout_s'])} "
            f"replica {r['replica']} batch {r['batch']}"
        )
        if r.get("worker") is not None:
            line += (
                f" | worker {r['worker']}@{r.get('host')}"
                f" wire {ms(r.get('wire_rtt_s'))}"
                f" worker-apply {ms(r.get('worker_apply_s'))}"
            )
        lines.append(line)
    lines.append("")
    if summary.get("fleet"):
        lines.append("fleet (worker-shipped spans, stitched per flush):")
        for w, agg in summary["fleet"].items():
            lines.append(
                f"  {w}@{agg['host']}: flushes {agg['flushes']} "
                f"apply {ms(agg['apply_s_mean'])} "
                f"wire rtt {ms(agg['wire_rtt_s_mean'])}"
            )
        lines.append("")
    for rep, tl in sorted(summary["replica_timelines"].items()):
        lines.append(f"replica {rep} timeline (last {len(tl)} flushes):")
        for b in tl:
            lines.append(
                f"  {b['batch']}: rows {b['rows']} / bucket {b['bucket']} "
                f"apply {ms(b['seconds'])} riders {b['riders']}"
            )
    if summary["ops"]:
        lines.append("")
        lines.append("control-plane spans:")
        for o in summary["ops"]:
            extra = {
                k: v for k, v in o.items() if k not in ("ts", "name")
            }
            lines.append(f"  {o.get('name')}: {extra}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-request critical-path report from a flight-"
        "recorder dump (/tracez?full=1) or a run ledger (run_*.jsonl)"
    )
    ap.add_argument("path", help="dump.json or run_<id>.jsonl")
    ap.add_argument("--top", type=int, default=10, help="top-k slow requests")
    ap.add_argument(
        "--timeline", type=int, default=25, help="flushes per replica timeline"
    )
    ap.add_argument("--json", action="store_true", help="emit the report as JSON")
    args = ap.parse_args(argv)
    summary = summarize(load(args.path), top=args.top, timeline=args.timeline)
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        print(render(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
