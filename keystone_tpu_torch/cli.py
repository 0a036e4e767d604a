"""Command-line entry (counterpart of ``keystone_tpu/cli.py``).

    python -m keystone_tpu_torch.cli <PipelineName> [pipeline flags...]
    python -m keystone_tpu_torch.cli serve --model model.pt [serve flags...]
    python -m keystone_tpu_torch.cli serve --model-dir REG [--watch S [--canary F [--bake-s S]]] [--autoscale MIN:MAX]
    python -m keystone_tpu_torch.cli export --model model.pt --example-shape D0[,D1,...] (--out DIR | --model-dir REG)
    python -m keystone_tpu_torch.cli --list

A pipeline name runs that pipeline's ``main`` (``pipelines/*.py``) with
the remaining flags; ``KEYSTONE_STATE_DIR`` sets ``PipelineEnv.state_dir``
first, so saved featurized prefixes reload.

``serve`` loads a ``FittedPipeline`` saved by the port
(``FittedPipeline.save``), or the deploy pick of a model registry
(``--model-dir``, with the version's artifact bundle unless
``--no-artifacts``), onto ``--device`` (the card unless ``--device
cpu``) and serves it over HTTP through the micro-batching service and
its threaded replica fleet.  ``--watch`` polls the registry and swaps in
each new ``CURRENT`` (guarded by a canary with ``--canary``, baked with
``--bake-s``); ``--autoscale`` resizes the fleet under load.  SIGINT
drains the in-flight requests and exits 0.

``export`` freezes a saved model for ``--device`` and writes its artifact
bundle (the padding buckets each replica captures a CUDA graph for)
into a bundle directory (``--out``) or a registry version
(``--model-dir``: a new version with ``--model``, else attached to the
registry's current one).

The reference's other subcommands and flags exit non-zero naming the
ROADMAP item that ports them: ``check``, ``plan`` and export's
``--plan`` (A10), ``worker``, ``--workers`` and ``--hosts`` (A11c),
``--tenants`` and several models (A11d).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import os
import sys

_PIPELINE_MODULES = {
    "MnistRandomFFT": "keystone_tpu_torch.pipelines.mnist_random_fft",
    "LinearPixels": "keystone_tpu_torch.pipelines.linear_pixels",
    "RandomPatchCifar": "keystone_tpu_torch.pipelines.random_patch_cifar",
    "NewsgroupsPipeline": "keystone_tpu_torch.pipelines.newsgroups",
    "TimitPipeline": "keystone_tpu_torch.pipelines.timit",
    "ImageNetSiftLcsFV": "keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv",
    "VOCSIFTFisher": "keystone_tpu_torch.pipelines.voc_sift_fisher",
    "AmazonReviewsPipeline": "keystone_tpu_torch.pipelines.amazon_reviews",
    "KernelTimitPipeline": "keystone_tpu_torch.pipelines.kernel_timit",
    "KernelCifarPipeline": "keystone_tpu_torch.pipelines.kernel_cifar",
}

#: the reference's commands and flags that are not ported yet, with the
#: ROADMAP item that ports each
_NOT_PORTED = {
    "check": "A10",
    "plan": "A10",
    "worker": "A11c",
    "--workers": "A11c",
    "--hosts": "A11c",
    "--lease-s": "A11c",
    "--listen-host": "A11c",
    "--listen-port": "A11c",
    "--tenants": "A11d",
}

#: export's flags that are not ported yet
_EXPORT_NOT_PORTED = {"--plan": "A10", "--plan-seed": "A10"}


def _refuse(what: str, item: str) -> int:
    print(f"keystone_tpu_torch.cli: {what} is not ported yet (ROADMAP {item})", file=sys.stderr)
    return 2


def _serve_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.cli serve",
        description="serve a saved fitted pipeline (or a model registry's current version) over HTTP with dynamic "
                    "micro-batching, admission control, a threaded replica fleet and registry-driven hot swaps",
    )
    ap.add_argument("--model", action="append", default=None, metavar="PATH",
                    help="a FittedPipeline saved with save()")
    ap.add_argument("--model-dir", action="append", default=None, metavar="DIR",
                    help="a model registry: serve its deploy pick (CURRENT, skipping corrupt and quarantined "
                         "versions) with the version's artifact bundle")
    ap.add_argument("--no-artifacts", action="store_true",
                    help="ignore the version's artifact bundle: every flush walks the frozen graph")
    ap.add_argument("--device", default="cuda", help="where the model serves: cuda (default) or cpu")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving fleet size: one copy of the model a replica, each with its own CUDA stream "
                         "(replicas share the card)")
    ap.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="SLO-driven autoscaling between MIN and MAX replicas")
    ap.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                    help="poll the --model-dir registry this often and hot-swap each new CURRENT")
    ap.add_argument("--canary", type=float, default=None, metavar="FRACTION",
                    help="guard each --watch swap: serve this fraction of flushes on the new version, judge, then "
                         "commit or roll back (and quarantine it)")
    ap.add_argument("--bake-s", type=float, default=0.0,
                    help="after a --canary commit, watch the SLO burn this long and revert on a sustained burn")
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
                    help="per-datum input shape: primes every padding bucket (capturing its CUDA graph with "
                         "artifacts) before serving; float32, or the artifact bundle's dtype when it has one")
    return ap


def _named(spec: str) -> bool:
    """``NAME=PATH`` (a multi-tenant entry) only when the prefix is a plain
    name and the whole spec is not itself an existing path."""
    name, sep, _ = spec.partition("=")
    return bool(sep) and bool(name) and os.sep not in name and not os.path.exists(spec)


def _serve_main(argv) -> int:
    """``serve``: load a saved fitted pipeline or a registry version onto
    ``--device`` and expose it over HTTP until SIGINT (which drains, then
    exits 0)."""
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in _NOT_PORTED:
            return _refuse(f"serve {flag}", _NOT_PORTED[flag])
    ap = _serve_parser()
    args = ap.parse_args(argv)
    models, model_dirs = list(args.model or []), list(args.model_dir or [])
    if not models and not model_dirs:
        ap.error("at least one of --model / --model-dir is required")
    if len(models) + len(model_dirs) > 1 or any(_named(m) for m in models + model_dirs):
        return _refuse("serving several models (the multi-tenant service)", "A11d")
    if args.watch is not None and not model_dirs:
        ap.error("--watch requires a --model-dir deploy")
    autoscale = None
    if args.autoscale:
        try:
            lo, _, hi = args.autoscale.partition(":")
            autoscale = dict(min_workers=int(lo), max_workers=int(hi))
        except ValueError:
            ap.error("--autoscale takes MIN:MAX (e.g. 1:4)")
    if args.trace_dump and args.no_recorder:
        ap.error("--trace-dump needs the flight recorder; drop --no-recorder")
    if args.canary is not None and args.watch is None:
        ap.error("--canary guards --watch swaps; add --watch SECONDS")
    if args.bake_s and args.canary is None:
        ap.error("--bake-s needs --canary")

    import numpy as np

    from keystone_tpu_torch.serve import HttpFrontend, ModelRegistry, serve
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    device = resolve_device(args.device)
    registry = artifacts = None
    if model_dirs:
        registry = ModelRegistry(model_dirs[0])
        fitted, version = registry.load(map_location=device)
        if not args.no_artifacts:
            # best effort: absent or damaged artifacts mean this deploy
            # walks, never that it fails
            artifacts = registry.load_artifacts(version)
        source = f"{model_dirs[0]} ({version})"
    else:
        fitted = FittedPipeline.load(models[0], map_location=device)
        version, source = "v0", models[0]
    example = None
    if args.example_shape:
        shape = tuple(int(d) for d in args.example_shape.split(","))
        dtype = np.float32
        manifest = (artifacts or {}).get("manifest") or {}
        if tuple(manifest.get("item_shape") or ()) == shape:
            # the bundle's buckets are keyed by its dtype: requests are
            # cast to it at admission
            dtype = np.dtype(manifest["dtype"])
        example = np.zeros(shape, dtype)
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
        version=version,
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
        artifacts=artifacts,
        autoscale=autoscale,
    )
    watcher = None
    if args.watch is not None:
        from keystone_tpu_torch.serve import RegistryWatcher, RolloutConfig

        rollout_cfg = None if args.canary is None else RolloutConfig(canary=args.canary, bake_s=args.bake_s)
        watcher = RegistryWatcher(svc, registry, poll_seconds=args.watch, rollout=rollout_cfg).start()
    front = HttpFrontend(svc, host=args.host, port=args.port, registry=registry, trace_dump_dir=args.trace_dump)
    print(f"serving {source} on http://{args.host}:{front.port} (device={device}, replicas={svc.replicas}, "
          f"max_batch={args.max_batch}, max_wait_ms={svc.max_wait_s * 1000.0:g}, queue_bound={args.queue_bound}"
          + (f", watching every {args.watch:g}s" if watcher else "")
          + (f", canary {args.canary:g}" if args.canary is not None else "")
          + (f", autoscale {args.autoscale}" if autoscale else "")
          + f", tracing {'off' if args.no_recorder else 'on'}"
          + (", artifacts on" if artifacts else "") + ")", flush=True)
    # what is alive now (the model, torch, the service) lives as long as
    # the process: kept out of the collector's full scans, each of which
    # would stop every replica worker for as long as it walks them
    gc.freeze()
    try:
        front.serve_forever()
    except KeyboardInterrupt:
        print("shutting down (draining in-flight requests)", flush=True)
    finally:
        if watcher is not None:
            watcher.stop()
        front.server.server_close()
        if args.trace_dump:
            try:
                path = svc.dump_trace(args.trace_dump)
                if path:
                    print(f"trace dump written to {path}", flush=True)
            except OSError as e:
                print(f"trace dump failed: {e}", flush=True)
        svc.close()
        # the kernels this process launched, by wrapper, and those its
        # bucket graphs' replays ran (what a caller on the card reads to
        # see which path the frozen graph took)
        for name in ("fisher_kernels", "gram_kernels"):
            mod = sys.modules.get(f"keystone_tpu_torch.ops.{name}")
            if mod is not None:
                print(f"{name} launches {dict(mod.LAUNCHES)}", flush=True)
        from keystone_tpu_torch.utils import graphs

        print(f"graph replay launches {dict(graphs.REPLAYED)}", flush=True)
    return 0


def _export_main(argv) -> int:
    """``export``: freeze a saved model for ``--device`` and write its
    artifact bundle into a bundle directory (``--out``) or a registry
    version (``--model-dir``)."""
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in _EXPORT_NOT_PORTED:
            return _refuse(f"export {flag} (the cost-based physical planner)", _EXPORT_NOT_PORTED[flag])
    ap = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.cli export",
        description="freeze a saved model and publish its artifact bundle, so that serve's replicas capture one CUDA "
                    "graph of the frozen apply per padding bucket",
    )
    ap.add_argument("--model", default=None,
                    help="a FittedPipeline saved with save(); with --model-dir it is published with its bundle as a "
                         "new registry version")
    ap.add_argument("--model-dir", default=None, metavar="DIR",
                    help="a model registry: with --model, publish model and bundle as a new version; without, attach "
                         "the bundle to the registry's current version")
    ap.add_argument("--example-shape", required=True, metavar="D0[,D1,...]",
                    help="per-datum input shape the buckets are keyed by (what serve will receive)")
    ap.add_argument("--dtype", default="float32", help="per-datum input dtype (default float32)")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="serve's max_batch: the buckets default to the service's powers of two up to it")
    ap.add_argument("--buckets", default=None, metavar="B0[,B1,...]",
                    help="explicit padding-bucket sizes (overrides --max-batch)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write the bundle here (MANIFEST.json and one blob per bucket, BLAKE2b sidecars)")
    ap.add_argument("--device", default="cuda",
                    help="the device the bundle is for: cuda (default) or cpu (a bundle no CUDA graph installs from)")
    args = ap.parse_args(argv)
    if args.model is None and args.model_dir is None:
        ap.error("pass --model and/or --model-dir")
    if args.out is None and args.model_dir is None:
        ap.error("pass --out or --model-dir (somewhere to write the bundle)")

    import numpy as np

    from keystone_tpu_torch.serve import ModelRegistry
    from keystone_tpu_torch.serve.registry import write_artifact_bundle
    from keystone_tpu_torch.serve.service import default_buckets
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    device = resolve_device(args.device)
    shape = tuple(int(d) for d in args.example_shape.split(","))
    example = np.zeros(shape, np.dtype(args.dtype))
    buckets = tuple(int(b) for b in args.buckets.split(",")) if args.buckets else default_buckets(args.max_batch)
    registry = None if args.model_dir is None else ModelRegistry(args.model_dir)
    version = None
    if args.model is not None:
        fitted = FittedPipeline.load(args.model, map_location=device)
    else:
        fitted, version = registry.load(map_location=device)
    bundle = fitted.freeze(device=device).export_artifacts(example=example, buckets=buckets)
    n = len(bundle["blobs"])
    if registry is not None:
        if version is None:
            version = registry.publish(fitted, artifacts=bundle)
            print(f"published {version} (+{n} bucket entries) to {args.model_dir}")
        else:
            registry.publish_artifacts(version, bundle)
            print(f"wrote {n} bucket entries for existing version {version} in {args.model_dir}")
    if args.out is not None:
        write_artifact_bundle(args.out, bundle, describe="export bundle")
        print(f"wrote bundle ({n} bucket entries) to {args.out}")
    man = bundle["manifest"]
    print(f"buckets={man['buckets']} item_shape={tuple(man['item_shape'])} dtype={man['dtype']} "
          f"torch={man['torch_version']} cuda={man['cuda_version']} device={man['device']} "
          f"signature={man['signature']}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("--list", "-l", "--help", "-h"):
        print("usage: python -m keystone_tpu_torch.cli <PipelineName> [flags]")
        print("       python -m keystone_tpu_torch.cli serve --model model.pt|--model-dir DIR [flags]")
        print("       python -m keystone_tpu_torch.cli export --model model.pt --example-shape D0[,D1,...] [flags]")
        print("pipelines:")
        for name in _PIPELINE_MODULES:
            print(f"  {name}")
        return 0
    name, rest = argv[0], argv[1:]
    if name == "serve":
        return _serve_main(rest)
    if name == "export":
        return _export_main(rest)
    if name in _NOT_PORTED:
        return _refuse(f"the {name!r} subcommand", _NOT_PORTED[name])
    if name not in _PIPELINE_MODULES:
        print(f"unknown pipeline {name!r}; use --list", file=sys.stderr)
        return 2
    state_dir = os.environ.get("KEYSTONE_STATE_DIR")
    if state_dir:
        # saved featurized prefixes (workflow/state.py) reload in this run
        from keystone_tpu_torch.workflow.pipeline import PipelineEnv

        PipelineEnv.state_dir = state_dir
    importlib.import_module(_PIPELINE_MODULES[name]).main(rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
