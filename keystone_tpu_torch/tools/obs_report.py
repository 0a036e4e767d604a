"""Render a run-ledger JSONL file into a human (or JSON) summary
(counterpart of the repo's ``tools/obs_report.py``: the same sections, CLI,
``--json`` and exit codes, over the port's ledger, which keeps the
reference's schema).

The read side of ``keystone_tpu_torch.obs``: ``Pipeline.fit`` (with
``KEYSTONE_OBS_DIR`` set), ``tools/chaos.py --ledger`` and the serving
layer write JSONL ledgers; this tool folds one back into the questions an
operator asks::

    python -m keystone_tpu_torch.tools.obs_report /tmp/obs/run_abc.jsonl
    python -m keystone_tpu_torch.tools.obs_report /tmp/obs          # newest run in a dir
    python -m keystone_tpu_torch.tools.obs_report run.jsonl --json  # machine-readable

It reads files only, imports no torch and touches no device.

Sections (each only when the run recorded it):

- **stages**: top executor stages by total span seconds, with attempt /
  retry counts and failed-attempt time;
- **retries**: retry totals across executor, durable I/O, blockstore,
  and streams;
- **convergence**: per-solver epoch series (objective / grad norm /
  distortion / log-likelihood — whatever the solver emitted);
- **io**: blockstore bytes read/written, durable corruption/fallback,
  stream batch latency, from the run's last metrics snapshot;
- **memory**: the card's memory (``hbm.*`` gauges, from
  ``torch.cuda``) and host-RSS watermarks;
- **ingress**: front-end health — accepts, binary/HTTP connection
  split, frames, per-kind frame errors, parse/admit time, and the
  bytes-copied counter that IS the zero-copy claim;
- **fleet**: worker-shipped telemetry aggregated at the router —
  per-worker/per-host apply and wire-RTT series plus
  retransmit/late-discard counts;
- **faults**: per-site injected counts (chaos runs).

``summarize()`` / ``render()`` are importable.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

def resolve_ledger_path(path: str) -> str:
    """A .jsonl file, or a directory → its most recently modified run."""
    if os.path.isdir(path):
        runs = glob.glob(os.path.join(path, "run_*.jsonl"))
        if not runs:
            raise FileNotFoundError(f"no run_*.jsonl ledgers under {path}")
        return max(runs, key=os.path.getmtime)
    return path


def load_events(path: str) -> List[dict]:
    events = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                # a torn final line (killed process) must not hide the
                # rest of the run
                continue
    return events


def _counter_total(snapshot: dict, name: str) -> float:
    return sum(
        v
        for k, v in (snapshot.get("counters") or {}).items()
        if k == name or k.startswith(name + "{")
    )


def _label_totals(snapshot: dict, name: str, label: str) -> Dict[str, float]:
    """``name{...label=x...}`` counters → {x: total} (summed across the
    other labels)."""
    out: Dict[str, float] = {}
    for k, v in (snapshot.get("counters") or {}).items():
        if not k.startswith(name + "{"):
            continue
        labels = k[len(name) + 1 : -1]
        for part in labels.split(","):
            lk, _, lv = part.partition("=")
            if lk == label:
                out[lv] = out.get(lv, 0.0) + v
    return out


def _fault_sites(snapshot: dict, name: str) -> Dict[str, float]:
    """``faults.injected{site=x}`` counters → {site: count}."""
    return _label_totals(snapshot, name, "site")


def summarize(path: str, top_k: int = 10) -> dict:
    """Fold one ledger into a summary dict (see module docstring)."""
    path = resolve_ledger_path(path)
    events = load_events(path)

    # ------------------------------------------------------------ stages
    # the span fold is shared with workflow/viz.ledger_overlay (ONE
    # reader of the executor.stage span schema)
    from keystone_tpu_torch.obs.ledger import fold_stage_spans

    stages = fold_stage_spans(path)
    retry_events = sum(
        1
        for e in events
        if e.get("kind") == "event" and e.get("name") == "executor.retry"
    )
    top = sorted(stages.values(), key=lambda st: -st["seconds"])[:top_k]
    stage_top = [
        {
            "node": st["label"],
            "seconds": st["seconds"],
            "count": st["count"],
            "retries": st["retries"],
            "failed_attempt_seconds": st["failed_attempt_seconds"],
        }
        for st in top
    ]

    # ------------------------------------------------------- convergence
    convergence: Dict[str, List[dict]] = {}
    for e in events:
        if e.get("kind") == "event" and e.get("name") == "solver.epoch":
            attrs = dict(e.get("attrs") or {})
            solver = str(attrs.pop("solver", "?"))
            convergence.setdefault(solver, []).append(attrs)

    # ----------------------------------------------- metrics (last snap)
    snapshot: dict = {}
    for e in events:
        if e.get("kind") == "metrics":
            snapshot = e.get("attrs") or snapshot
    gauges = snapshot.get("gauges") or {}
    hists = snapshot.get("histograms") or {}

    io = {
        "blockstore_read_bytes": _counter_total(snapshot, "blockstore.read_bytes"),
        "blockstore_write_bytes": _counter_total(snapshot, "blockstore.write_bytes"),
        "blockstore_reads": _counter_total(snapshot, "blockstore.reads"),
        "blockstore_writes": _counter_total(snapshot, "blockstore.writes"),
        "blockstore_read_retries": _counter_total(
            snapshot, "blockstore.read_retries"
        ),
        "durable_retries": _counter_total(snapshot, "durable.retries"),
        "durable_corruption": _counter_total(snapshot, "durable.corruption"),
        "durable_fallback": _counter_total(snapshot, "durable.fallback"),
        "durable_quarantined": _counter_total(snapshot, "durable.quarantined"),
        "stream_bad_batches": _counter_total(snapshot, "stream.bad_batches"),
        "stream_retries": _counter_total(snapshot, "stream.retries"),
        "stream_batch_seconds": {
            k: v for k, v in hists.items() if k.startswith("stream.batch_seconds")
        },
    }

    retries = {
        "executor_retry_events": retry_events,
        "executor_stage_retries": _counter_total(
            snapshot, "executor.stage_retries"
        ),
        "executor_failed_attempt_seconds": _counter_total(
            snapshot, "executor.failed_attempt_seconds"
        ),
        "durable_retries": io["durable_retries"],
        "blockstore_read_retries": io["blockstore_read_retries"],
        "stream_retries": io["stream_retries"],
    }

    # -------------------------------------------------------- dataflow
    # the fit-path dataflow accounts (host-side measures): seconds the
    # host spent BLOCKED on device results (obs-gated solver syncs,
    # ledger.device_wait) vs blocked on host→device staging
    # (blockstore.iter_device_blocks).  The busy fraction is the
    # tentpole metric of the async-feed work: a starved device shows a
    # fraction near zero; a fed one approaches the solver's share of
    # wall time.
    def _hist_sum(name: str) -> float:
        return sum(
            float(h.get("sum") or 0.0)
            for k, h in hists.items()
            if k == name or k.startswith(name + "{")
        )

    device_busy = _hist_sum("device.busy_seconds")
    transfer = _hist_sum("blockstore.stage_wait_seconds")

    memory = {
        "hbm_bytes_in_use": gauges.get("hbm.bytes_in_use"),
        "hbm_peak_bytes_in_use": gauges.get("hbm.peak_bytes_in_use"),
        "host_max_rss_bytes": gauges.get("host.max_rss_bytes"),
    }
    # span-boundary samples are watermarks too (a run killed before its
    # snapshot still has per-span samples)
    for e in events:
        if e.get("kind") == "span_end":
            attrs = e.get("attrs") or {}
            for src, dst in (
                ("hbm_bytes_in_use", "hbm_bytes_in_use"),
                ("host_max_rss_bytes", "host_max_rss_bytes"),
            ):
                v = attrs.get(src)
                if v is not None and (
                    memory.get(dst) is None or float(v) > float(memory[dst])
                ):
                    memory[dst] = float(v)

    # ----------------------------------------------------- AOT artifacts
    # the prime fallback ladder's story: how many bucket primes each
    # tier served (serve.prime_seconds{source=...}) and the install
    # counters — a deploy that silently fell through artifact→compile
    # shows up here as fallbacks>0 with compile-sourced primes
    def _hist(name: str) -> dict:
        h = hists.get(name) or {}
        return {
            "count": int(h.get("count") or 0),
            "seconds": float(h.get("sum") or 0.0),
        }

    artifacts = {
        "hits": int(_counter_total(snapshot, "serve.artifact_hits")),
        "misses": int(_counter_total(snapshot, "serve.artifact_misses")),
        "fallbacks": int(
            _counter_total(snapshot, "serve.artifact_fallbacks")
        ),
        "prime": {
            src: _hist(f"serve.prime_seconds{{source={src}}}")
            for src in ("artifact", "cache", "compile")
        },
    }
    if not any(
        (artifacts["hits"], artifacts["misses"], artifacts["fallbacks"])
    ) and not any(p["count"] for p in artifacts["prime"].values()):
        artifacts = None

    # ------------------------------------------------------------ ingress
    # the front-end block (serve/ingress.py + serve/http.py): only when
    # the run actually served connections
    ingress = {
        "accepts": int(_counter_total(snapshot, "ingress.accepts")),
        "bin_conns": int(_counter_total(snapshot, "ingress.bin_conns")),
        "http_conns": int(_counter_total(snapshot, "ingress.http_conns")),
        "frames": int(_counter_total(snapshot, "ingress.frames")),
        "batch_rows": int(_counter_total(snapshot, "ingress.batch_rows")),
        "bytes_copied": _counter_total(snapshot, "ingress.bytes_copied"),
        "frame_errors": {
            k: int(v)
            for k, v in sorted(
                _label_totals(snapshot, "ingress.frame_errors", "kind").items()
            )
        },
        "parse_seconds": _hist("ingress.parse_seconds"),
        "admit_seconds": _hist("ingress.admit_seconds"),
    }
    if not (
        ingress["accepts"]
        or ingress["bin_conns"]
        or ingress["http_conns"]
        or ingress["frames"]
    ):
        ingress = None

    # -------------------------------------------------------------- fleet
    # worker-shipped telemetry aggregated into the router registry
    # (serve/telemetry.py): per-worker/per-host series keyed by their
    # label string, plus the wire-health counters from serve/net.py
    def _hist_series(name: str) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for k, h in hists.items():
            if k != name and not k.startswith(name + "{"):
                continue
            labels = k[len(name) + 1 : -1] if k != name else ""
            out[labels] = {
                "count": int(h.get("count") or 0),
                "seconds": float(h.get("sum") or 0.0),
                "max": h.get("max"),
            }
        return out

    fleet = {
        "apply_seconds": _hist_series("serve.fleet.apply_seconds"),
        "wire_rtt_seconds": _hist_series("serve.fleet.wire_rtt_seconds"),
        "retransmits": {
            k: int(v)
            for k, v in sorted(
                _label_totals(snapshot, "serve.net.retransmits", "worker").items()
            )
        },
        "late_discards": {
            k: int(v)
            for k, v in sorted(
                _label_totals(
                    snapshot, "serve.net.late_discards", "worker"
                ).items()
            )
        },
    }
    if not (fleet["apply_seconds"] or fleet["wire_rtt_seconds"]):
        fleet = None

    # ------------------------------------------------------------ faults
    faults: Dict[str, dict] = {}
    injected = _fault_sites(snapshot, "faults.injected")
    calls = _fault_sites(snapshot, "faults.calls")
    for site in sorted(set(injected) | set(calls)):
        faults[site] = {
            "calls": int(calls.get(site, 0)),
            "injected": int(injected.get(site, 0)),
        }
    # per-restart stats events (fit_with_recovery / chaos.py)
    fault_events = [
        e["attrs"]
        for e in events
        if e.get("kind") == "event" and e.get("name") == "faults.stats"
    ]

    run_ids = {e.get("run_id") for e in events if e.get("run_id")}
    t0 = min((e["ts"] for e in events if "ts" in e), default=None)
    t1 = max((e["ts"] for e in events if "ts" in e), default=None)
    wall = (t1 - t0) if (t0 is not None and t1 is not None) else None
    dataflow = {
        "device_busy_seconds": device_busy,
        "transfer_seconds": transfer,
        "device_busy_fraction": (
            device_busy / wall if wall else None
        ),
    }
    return {
        "path": path,
        "run_id": sorted(run_ids)[0] if run_ids else None,
        "events": len(events),
        "wall_seconds": wall,
        "stage_top": stage_top,
        "retries": retries,
        "convergence": convergence,
        "io": io,
        "memory": memory,
        "dataflow": dataflow,
        "artifacts": artifacts,
        "ingress": ingress,
        "fleet": fleet,
        "faults": faults,
        "fault_restarts": fault_events,
    }


def _fmt_bytes(b: Optional[float]) -> str:
    if b is None:
        return "-"
    b = float(b)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024 or unit == "TB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{int(b)} B"
        b /= 1024
    return f"{b:.1f} TB"


def render(summary: dict) -> str:
    """Human-readable text for one :func:`summarize` dict."""
    out: List[str] = []
    out.append(f"run {summary.get('run_id')}  ({summary.get('path')})")
    ws = summary.get("wall_seconds")
    out.append(
        f"  events: {summary.get('events')}"
        + (f"   wall: {ws:.2f}s" if ws is not None else "")
    )

    if summary.get("stage_top"):
        out.append("\n== top stages by time ==")
        out.append(
            f"  {'seconds':>9}  {'runs':>4}  {'retries':>7}  "
            f"{'failed_s':>8}  stage"
        )
        for st in summary["stage_top"]:
            out.append(
                f"  {st['seconds']:>9.3f}  {st['count']:>4}  "
                f"{st['retries']:>7}  {st['failed_attempt_seconds']:>8.3f}  "
                f"{st['node']}"
            )

    r = summary.get("retries") or {}
    if any(v for v in r.values()):
        out.append("\n== retries ==")
        for k, v in r.items():
            if v:
                out.append(f"  {k}: {v:g}")

    conv = summary.get("convergence") or {}
    if conv:
        out.append("\n== solver convergence ==")
        for solver, series in conv.items():
            out.append(f"  {solver}: {len(series)} points")
            head = series[: 3]
            tail = series[-2:] if len(series) > 5 else []
            for pt in head:
                out.append("    " + json.dumps(pt, sort_keys=True))
            if tail:
                out.append("    ...")
                for pt in tail:
                    out.append("    " + json.dumps(pt, sort_keys=True))

    io = summary.get("io") or {}
    if any(v for k, v in io.items() if isinstance(v, (int, float))):
        out.append("\n== I/O ==")
        out.append(
            "  blockstore: "
            f"read {_fmt_bytes(io.get('blockstore_read_bytes'))} "
            f"({io.get('blockstore_reads', 0):g} reads, "
            f"{io.get('blockstore_read_retries', 0):g} retries), "
            f"wrote {_fmt_bytes(io.get('blockstore_write_bytes'))} "
            f"({io.get('blockstore_writes', 0):g} appends)"
        )
        out.append(
            "  durable: "
            f"retries {io.get('durable_retries', 0):g}, "
            f"corruption {io.get('durable_corruption', 0):g}, "
            f"fallbacks {io.get('durable_fallback', 0):g}, "
            f"quarantined {io.get('durable_quarantined', 0):g}"
        )
        out.append(
            "  stream: "
            f"retries {io.get('stream_retries', 0):g}, "
            f"bad batches {io.get('stream_bad_batches', 0):g}"
        )
        for k, h in (io.get("stream_batch_seconds") or {}).items():
            mean = h["sum"] / h["count"] if h.get("count") else 0.0
            out.append(
                f"  {k}: n={h.get('count')} mean={mean * 1e3:.2f}ms "
                f"max={(h.get('max') or 0) * 1e3:.2f}ms"
            )

    df = summary.get("dataflow") or {}
    if df.get("device_busy_seconds") or df.get("transfer_seconds"):
        out.append("\n== fit dataflow ==")
        out.append(
            f"  device busy (host-blocked): "
            f"{df.get('device_busy_seconds', 0.0):.3f}s"
        )
        out.append(
            f"  transfer (h2d staging):     "
            f"{df.get('transfer_seconds', 0.0):.3f}s"
        )
        frac = df.get("device_busy_fraction")
        if frac is not None:
            out.append(f"  device-busy fraction of wall: {frac:.1%}")

    mem = summary.get("memory") or {}
    if any(v is not None for v in mem.values()):
        out.append("\n== memory watermarks ==")
        if mem.get("hbm_bytes_in_use") is not None:
            out.append(f"  HBM in use: {_fmt_bytes(mem['hbm_bytes_in_use'])}")
        if mem.get("hbm_peak_bytes_in_use") is not None:
            out.append(
                f"  HBM peak:   {_fmt_bytes(mem['hbm_peak_bytes_in_use'])}"
            )
        if mem.get("host_max_rss_bytes") is not None:
            out.append(
                f"  host peak RSS: {_fmt_bytes(mem['host_max_rss_bytes'])}"
            )

    arts = summary.get("artifacts")
    if arts:
        out.append("\n== AOT artifacts ==")
        out.append(
            f"  installed: {arts['hits']}  misses: {arts['misses']}  "
            f"fallbacks: {arts['fallbacks']}"
        )
        for src, p in (arts.get("prime") or {}).items():
            if p["count"]:
                out.append(
                    f"  prime[{src}]: n={p['count']} "
                    f"total={p['seconds']:.3f}s"
                )

    ing = summary.get("ingress")
    if ing:
        out.append("\n== ingress ==")
        out.append(
            f"  accepts: {ing['accepts']}  "
            f"(binary {ing['bin_conns']}, http {ing['http_conns']})"
        )
        out.append(
            f"  frames: {ing['frames']}  rows: {ing['batch_rows']}  "
            f"bytes copied: {_fmt_bytes(ing.get('bytes_copied'))}"
        )
        for name in ("parse_seconds", "admit_seconds"):
            h = ing.get(name) or {}
            if h.get("count"):
                mean = h["seconds"] / h["count"]
                out.append(
                    f"  {name}: n={h['count']} mean={mean * 1e3:.3f}ms"
                )
        if ing.get("frame_errors"):
            errs = ", ".join(
                f"{k}={v}" for k, v in ing["frame_errors"].items()
            )
            out.append(f"  frame errors: {errs}")

    fl = summary.get("fleet")
    if fl:
        out.append("\n== fleet (worker-shipped) ==")
        for name in ("apply_seconds", "wire_rtt_seconds"):
            for labels, h in sorted((fl.get(name) or {}).items()):
                if not h.get("count"):
                    continue
                mean = h["seconds"] / h["count"]
                mx = h.get("max")
                out.append(
                    f"  {name}{{{labels}}}: n={h['count']} "
                    f"mean={mean * 1e3:.2f}ms"
                    + (f" max={mx * 1e3:.2f}ms" if mx is not None else "")
                )
        for name in ("retransmits", "late_discards"):
            series = fl.get(name) or {}
            if any(series.values()):
                out.append(
                    f"  {name}: "
                    + ", ".join(f"{k}={v}" for k, v in series.items())
                )

    faults = summary.get("faults") or {}
    if faults:
        out.append("\n== faults ==")
        out.append(f"  {'site':<20} {'calls':>7} {'injected':>9}")
        for site, c in faults.items():
            out.append(f"  {site:<20} {c['calls']:>7} {c['injected']:>9}")
    if summary.get("fault_restarts"):
        out.append(
            f"  restart stats events: {len(summary['fault_restarts'])}"
        )

    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="summarize a keystone_tpu_torch run-ledger JSONL file"
    )
    ap.add_argument(
        "ledger",
        help="path to a run_*.jsonl file, or a KEYSTONE_OBS_DIR directory "
        "(newest run is picked)",
    )
    ap.add_argument(
        "--json", action="store_true", help="emit the summary dict as JSON"
    )
    ap.add_argument(
        "--top", type=int, default=10, help="stages to list (default 10)"
    )
    args = ap.parse_args(argv)
    summary = summarize(args.ledger, top_k=args.top)
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(render(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
