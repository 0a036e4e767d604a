"""Command-line entry (counterpart of ``keystone_tpu/cli.py``).

    python -m keystone_tpu_torch.cli serve --model model.pt [serve flags...]

``serve`` loads a ``FittedPipeline`` saved by the port
(``FittedPipeline.save``, a ``torch.save`` file) onto ``--device`` (the
card unless ``--device cpu``) and serves it over HTTP through the
micro-batching service and its threaded replica fleet
(``keystone_tpu_torch/serve``).  SIGINT drains the in-flight requests
and exits 0.

The reference's other subcommands, and its serve flags for the parts not
ported yet, exit non-zero naming the ROADMAP item that ports them: the
pipeline mains, ``check`` and ``plan`` (A10: run a pipeline with
``python -m keystone_tpu_torch.pipelines.<module>``), ``export`` and
``--model-dir`` (A11b), ``worker``, ``--workers`` and ``--hosts`` (A11c),
``--tenants`` and several ``--model`` entries, ``--autoscale``,
``--watch`` and ``--canary`` (A11d).
"""

from __future__ import annotations

import argparse
import sys

#: the reference's commands and serve flags that are not ported yet, with
#: the ROADMAP item that ports each
_NOT_PORTED = {
    "check": "A10",
    "plan": "A10",
    "export": "A11b",
    "worker": "A11c",
    "--model-dir": "A11b",
    "--no-artifacts": "A11b",
    "--workers": "A11c",
    "--hosts": "A11c",
    "--lease-s": "A11c",
    "--listen-host": "A11c",
    "--listen-port": "A11c",
    "--tenants": "A11d",
    "--autoscale": "A11d",
    "--watch": "A11d",
    "--canary": "A11d",
    "--bake-s": "A11d",
}


def _refuse(what: str, item: str) -> int:
    print(f"keystone_tpu_torch.cli: {what} is not ported yet (ROADMAP {item})", file=sys.stderr)
    return 2


def _serve_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.cli serve",
        description="serve a saved fitted pipeline over HTTP with dynamic micro-batching, admission control and "
                    "a threaded replica fleet",
    )
    ap.add_argument("--model", required=True, metavar="PATH", help="a FittedPipeline saved with save()")
    ap.add_argument("--device", default="cuda", help="where the model serves: cuda (default) or cpu")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving fleet size: one copy of the model a replica, each with its own CUDA stream "
                         "(replicas share the card)")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=None,
                    help="flush when the oldest request has waited this long (default 5)")
    ap.add_argument("--queue-bound", type=int, default=128,
                    help="admission control: reject (HTTP 429) past this queue depth")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default per-request deadline; doomed requests are shed (HTTP 504)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="latency objective for GET /statusz's SLO burn rate (default: --deadline-ms)")
    ap.add_argument("--slo-target", type=float, default=0.99)
    ap.add_argument("--slo-window-s", type=float, default=None)
    ap.add_argument("--no-recorder", action="store_true", help="disable the flight recorder (request tracing)")
    ap.add_argument("--trace-dump", default=None, metavar="DIR",
                    help="POST /tracez/dump writes the recorder's state here, and a last snapshot at shutdown")
    ap.add_argument("--no-supervise", action="store_true", help="disable the replica supervisor")
    ap.add_argument("--heartbeat-s", type=float, default=30.0, help="wedge budget of a replica worker")
    ap.add_argument("--restart-limit", type=int, default=3)
    ap.add_argument("--restart-window-s", type=float, default=60.0)
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="hedged dispatch (off by default; needs --replicas >= 2)")
    ap.add_argument("--no-bisect", action="store_true", help="disable batch-failure bisection")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--example-shape", default=None, metavar="D0[,D1,...]",
                    help="per-datum input shape (float32): primes every padding bucket before serving")
    return ap


def _serve_main(argv) -> int:
    """``serve``: load a saved fitted pipeline onto ``--device`` and
    expose it over HTTP until SIGINT (which drains, then exits 0)."""
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in _NOT_PORTED:
            return _refuse(f"serve {flag}", _NOT_PORTED[flag])
    if argv.count("--model") > 1:
        return _refuse("serving several models (the multi-tenant service)", "A11d")
    args = _serve_parser().parse_args(argv)
    if args.trace_dump and args.no_recorder:
        print("--trace-dump needs the flight recorder; drop --no-recorder", file=sys.stderr)
        return 2

    import numpy as np

    from keystone_tpu_torch.serve import HttpFrontend, serve
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    device = resolve_device(args.device)
    fitted = FittedPipeline.load(args.model, map_location=device)
    example = None
    if args.example_shape:
        example = np.zeros(tuple(int(d) for d in args.example_shape.split(",")), np.float32)
    # one replica serves the applier frozen here; more are copies of it
    svc = serve(
        fitted.freeze(device=device),
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_bound=args.queue_bound,
        deadline_ms=args.deadline_ms,
        example=example,
        replicas=args.replicas,
        devices=None if args.replicas == 1 else [device] * args.replicas,
        recorder=not args.no_recorder,
        slo_ms=args.slo_ms,
        slo_target=args.slo_target,
        slo_window_s=args.slo_window_s,
        supervise=not args.no_supervise,
        heartbeat_s=args.heartbeat_s,
        restart_limit=args.restart_limit,
        restart_window_s=args.restart_window_s,
        hedge_ms=args.hedge_ms,
        bisect=not args.no_bisect,
    )
    front = HttpFrontend(svc, host=args.host, port=args.port, trace_dump_dir=args.trace_dump)
    print(f"serving {args.model} on http://{args.host}:{front.port} (device={device}, replicas={svc.replicas}, "
          f"max_batch={args.max_batch}, max_wait_ms={svc.max_wait_s * 1000.0:g}, queue_bound={args.queue_bound}, "
          f"tracing {'off' if args.no_recorder else 'on'})", flush=True)
    try:
        front.serve_forever()
    except KeyboardInterrupt:
        print("shutting down (draining in-flight requests)", flush=True)
    finally:
        front.server.server_close()
        if args.trace_dump:
            try:
                path = svc.dump_trace(args.trace_dump)
                if path:
                    print(f"trace dump written to {path}", flush=True)
            except OSError as e:
                print(f"trace dump failed: {e}", flush=True)
        svc.close()
        # the kernels this process launched, by wrapper (what a caller on
        # the card reads to see which path the frozen graph took)
        for name in ("fisher_kernels", "gram_kernels"):
            mod = sys.modules.get(f"keystone_tpu_torch.ops.{name}")
            if mod is not None:
                print(f"{name} launches {dict(mod.LAUNCHES)}", flush=True)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("--list", "-l", "--help", "-h"):
        print("usage: python -m keystone_tpu_torch.cli serve --model model.pt [flags]")
        return 0
    name, rest = argv[0], argv[1:]
    if name == "serve":
        return _serve_main(rest)
    if name in _NOT_PORTED:
        return _refuse(f"the {name!r} subcommand", _NOT_PORTED[name])
    return _refuse(f"the pipeline dispatcher ({name!r}; run python -m keystone_tpu_torch.pipelines.<module>)",
                   "A10")


if __name__ == "__main__":
    sys.exit(main())
