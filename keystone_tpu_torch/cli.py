"""Command-line entry (counterpart of ``keystone_tpu/cli.py``).

    python -m keystone_tpu_torch.cli <PipelineName> [pipeline flags...]
    python -m keystone_tpu_torch.cli serve --model model.pt [serve flags...]
    python -m keystone_tpu_torch.cli serve --model-dir REG [--watch S [--canary F [--bake-s S]]] [--autoscale MIN:MAX]
    python -m keystone_tpu_torch.cli serve --model model.pt --workers N [--hosts HOST[:SLOTS],... [--lease-s S]]
    python -m keystone_tpu_torch.cli serve --model a=a.pt --model b=b.pt [--model-dir c=REG] [serve flags...]
    python -m keystone_tpu_torch.cli worker --connect HOST:PORT [--name NAME]
    python -m keystone_tpu_torch.cli export --model model.pt --example-shape D0[,D1,...] (--out DIR | --model-dir REG)
                                            [--plan [--plan-seed S]]
    python -m keystone_tpu_torch.cli check <PipelineName> | --all | --model model.pt [--example-shape ...] [--dot OUT]
    python -m keystone_tpu_torch.cli plan --model-dir REG | --bundle DIR | --file plan.json | --model model.pt
    python -m keystone_tpu_torch.cli --list

A pipeline name runs that pipeline's ``main`` (``pipelines/*.py``) with
the remaining flags; ``KEYSTONE_STATE_DIR`` sets ``PipelineEnv.state_dir``
first, so saved featurized prefixes reload.

``serve`` loads a ``FittedPipeline`` saved by the port
(``FittedPipeline.save``), or the deploy pick of a model registry
(``--model-dir``, with the version's artifact bundle unless
``--no-artifacts``), onto ``--device`` (the card unless ``--device
cpu``) and serves it over HTTP through the micro-batching service and
its threaded replica fleet.  ``--workers N`` serves with N worker
processes instead (each loads the model onto ``--device`` and captures
its own bucket graphs; the router keeps the model on the host);
``--hosts`` carries that fleet over TCP with heartbeat leases
(``--lease-s``), its workers dialing ``--listen-host:--listen-port``.
``--watch`` polls the registry and swaps in each new ``CURRENT``
(guarded by a canary with ``--canary``, baked with ``--bake-s``);
``--autoscale`` resizes the fleet under load.  Named entries
(``--model NAME=PATH``, ``--model-dir NAME=DIR``, repeatable) deploy
several models as tenants of one multi-tenant service (``serve_multi``):
a request names its tenant in the body (``"tenant"``), and the tenants'
equal featurization prefixes run once a combined flush.  A multi deploy
walks its graphs (no bucket graphs) and takes neither ``--workers``,
``--hosts`` nor ``--watch``.  SIGINT drains the in-flight requests and
exits 0.

``worker`` runs one network-fleet worker: it dials a router started
with ``serve --hosts``, receives the model over TCP, primes, and serves
under a heartbeat lease, dialing back after a partition.

``export`` freezes a saved model for ``--device`` and writes its artifact
bundle (the padding buckets each replica captures a CUDA graph for)
into a bundle directory (``--out``) or a registry version
(``--model-dir``: a new version with ``--model``, else attached to the
registry's current one).  With ``--plan`` the freeze samples the physical
candidates on seeded rows (``--plan-seed``) first, and the
``PhysicalPlan`` ships in the bundle's manifest: every install of it
serves the planned configuration.

``check`` runs the pre-flight analyzer (``keystone_tpu_torch/analysis``:
shapes, robustness, signatures, the solvers' precision, the installed
plan) over a bundled pipeline, assembled on tiny synthetic data on
``--device``, or over a saved model in apply mode; it prints the findings
with their graph locations, writes the DOT overlay with ``--dot``, and
exits 1 on an error finding; ``--all`` checks every bundled pipeline in
turn.  On the card it also prints the kernel launches and the device
memory allocated around each analysis (none and unchanged: the analyzer
runs on fake tensors).  ``plan`` shows the physical plan a registry
version, a bundle or a plan file ships, or builds one by sampling a saved
model (``--model --example-shape``), and writes it with ``--out``.
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

def _serve_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.cli serve",
        description="serve a saved fitted pipeline (or a model registry's current version) over HTTP with dynamic "
                    "micro-batching, admission control, a threaded replica fleet and registry-driven hot swaps",
    )
    ap.add_argument("--model", action="append", default=None, metavar="[NAME=]PATH",
                    help="a FittedPipeline saved with save(); NAME=PATH (repeatable) deploys it as tenant NAME of "
                         "a multi-tenant service")
    ap.add_argument("--model-dir", action="append", default=None, metavar="[NAME=]DIR",
                    help="a model registry: serve its deploy pick (CURRENT, skipping corrupt and quarantined "
                         "versions) with the version's artifact bundle; NAME=DIR (repeatable) deploys it as tenant "
                         "NAME")
    ap.add_argument("--no-artifacts", action="store_true",
                    help="ignore the version's artifact bundle: every flush walks the frozen graph")
    ap.add_argument("--device", default="cuda", help="where the model serves: cuda (default) or cpu")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving fleet size: one copy of the model a replica, each with its own CUDA stream "
                         "(replicas share the card)")
    ap.add_argument("--workers", type=int, default=0,
                    help="a PROCESS fleet of this many worker processes, each with the model on --device and its "
                         "own bucket graphs (0, the default: the threaded fleet; exclusive with --replicas > 1)")
    ap.add_argument("--hosts", default=None, metavar="HOST[:SLOTS],...",
                    help="the TCP fleet (needs --workers): a host map where workers are spawned, e.g. 'local:2'; "
                         "they dial back to --listen-host:--listen-port and hold a heartbeat lease")
    ap.add_argument("--lease-s", type=float, default=None, metavar="SECONDS",
                    help="the TCP fleet's heartbeat lease (default 5): this much silence declares a worker dead")
    ap.add_argument("--listen-host", default=None, metavar="ADDR",
                    help="the interface the TCP fleet's worker listener binds (default 127.0.0.1)")
    ap.add_argument("--listen-port", type=int, default=None, help="the worker listener's port (default: any free)")
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
    ap = _serve_parser()
    args = ap.parse_args(argv)
    models, model_dirs = list(args.model or []), list(args.model_dir or [])
    if not models and not model_dirs:
        ap.error("at least one of --model / --model-dir is required")
    named = [m for m in models + model_dirs if _named(m)]
    multi = bool(named) or len(models) + len(model_dirs) > 1
    if multi and len(named) != len(models) + len(model_dirs):
        ap.error("multi-tenant deploys name every entry: --model NAME=PATH / --model-dir NAME=DIR")
    if not multi and models and model_dirs:
        ap.error("pass one --model OR one --model-dir, not both")
    if args.watch is not None and (multi or not model_dirs):
        ap.error("--watch requires a single-tenant --model-dir deploy")
    if multi and args.workers:
        ap.error("--workers is single-tenant only (the shared stage pool needs in-process walks)")
    if multi and args.hosts:
        ap.error("--hosts is single-tenant only")
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
    if args.workers and args.replicas > 1:
        ap.error("--workers and --replicas > 1 are exclusive")
    if args.hosts and not args.workers:
        ap.error("--hosts needs --workers >= 1")
    if not args.hosts and any(v is not None for v in (args.lease_s, args.listen_host, args.listen_port)):
        ap.error("--lease-s / --listen-host / --listen-port configure the --hosts fleet")

    import numpy as np

    from torch import device as torch_device

    from keystone_tpu_torch.serve import HttpFrontend, ModelRegistry, serve, serve_multi
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    device = resolve_device(args.device)
    # a worker fleet's router keeps the model on the host: its workers
    # load it onto the device
    load_to = torch_device("cpu") if args.workers else device
    registry = artifacts = None
    tenants: dict = {}
    if multi:
        # each named entry is a saved model (NAME=PATH) or a registry's
        # deploy pick (NAME=DIR), frozen for the device; the walk serves
        # (the multi applier installs no bucket graphs, so the registry's
        # bundles are not read)
        parts = []
        for spec in models:
            name, _, path = spec.partition("=")
            tenants[name] = FittedPipeline.load(path, map_location=device).freeze(device=device)
            parts.append(f"{name}={path}")
        for spec in model_dirs:
            name, _, root = spec.partition("=")
            fitted, ver = ModelRegistry(root).load(map_location=device)
            tenants[name] = fitted.freeze(device=device)
            parts.append(f"{name}={root} ({ver})")
        version, source = "multi", ", ".join(parts)
    elif model_dirs:
        registry = ModelRegistry(model_dirs[0])
        fitted, version = registry.load(map_location=load_to)
        if not args.no_artifacts:
            # best effort: absent or damaged artifacts mean this deploy
            # walks, never that it fails
            artifacts = registry.load_artifacts(version)
        source = f"{model_dirs[0]} ({version})"
    else:
        fitted = FittedPipeline.load(models[0], map_location=load_to)
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
    fleet_kw: dict = dict(replicas=args.replicas, devices=None if args.replicas == 1 else [device] * args.replicas)
    if args.workers:
        # each worker freezes the fitted pipeline for its own device
        worker_opts = {"device": str(device)}
        for key in ("lease_s", "listen_host", "listen_port"):
            if getattr(args, key) is not None:
                worker_opts[key] = getattr(args, key)
        fleet_kw = dict(workers=args.workers, worker_opts=worker_opts, hosts=args.hosts)
    # one replica serves the applier(s) frozen here; more are copies
    svc = (serve_multi if multi else serve)(
        tenants if multi else fitted if args.workers else fitted.freeze(device=device),
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_bound=args.queue_bound,
        deadline_ms=args.deadline_ms,
        example=example,
        **fleet_kw,
        version=version,
        recorder=not args.no_recorder,
        slo_ms=args.slo_ms,
        slo_target=args.slo_target,
        slo_window_s=args.slo_window_s,
        supervise=not args.no_supervise,
        heartbeat_s=args.heartbeat_s,
        restart_limit=args.restart_limit,
        restart_window_s=args.restart_window_s,
        # left unset, a shipped plan's hedge applies
        **({} if args.hedge_ms is None else {"hedge_ms": args.hedge_ms}),
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
    fleet = f"replicas={svc.replicas}"
    if args.workers:
        fleet = f"workers={svc.replicas}" + (f", hosts={args.hosts}, listening on {svc.listen_address}"
                                             if args.hosts else "")
    print(f"serving {source} on http://{args.host}:{front.port} (device={device}, {fleet}, "
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
    ap.add_argument("--plan", action="store_true",
                    help="cost-based physical planning at the freeze (keystone_tpu_torch.planner): sample the "
                         "candidate implementations on seeded rows and ship the PhysicalPlan in the manifest "
                         "(inspect it with the plan subcommand)")
    ap.add_argument("--plan-seed", type=int, default=0, help="the sampling seed of --plan (part of the plan)")
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
    if args.plan:
        from keystone_tpu_torch.planner import build_plan

        rng = np.random.default_rng(args.plan_seed)
        sample = _sample_rows(rng, shape, np.dtype(args.dtype))
        plan = build_plan(fitted, example=sample, max_batch=max(buckets), seed=args.plan_seed, device=device)
        frozen = fitted.freeze(device=device, plan=plan)
        print(f"planned: {plan.fingerprint()} (the plan subcommand shows it)")
    else:
        frozen = fitted.freeze(device=device)
    bundle = frozen.export_artifacts(example=example, buckets=buckets)
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


def _sample_rows(rng, shape, dtype, n: int = 32):
    """Seeded sampling rows for a plan: normal draws, or uniform pixels for
    an integer dtype (images)."""
    import numpy as np

    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.integers(max(info.min, 0), min(info.max, 255) + 1, size=(n,) + shape).astype(dtype)
    return rng.normal(size=(n,) + shape).astype(dtype)


def _check_main(argv) -> int:
    """``check``: the pre-flight analyzer over a bundled pipeline
    (assembled on tiny synthetic data) or a saved fitted model (apply
    mode); prints the findings with their graph locations and exits 1 on
    an error finding: the cheap gate before a long fit or a fleet."""
    ap = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.cli check",
        description="static pre-flight analysis: shape and dtype propagation, the solvers' precision lint, the "
                    "robustness-configuration lint, the signature audit, the installed plan's audit",
    )
    ap.add_argument("pipeline", nargs="?", help="bundled pipeline name (see --list); exclusive with --model")
    ap.add_argument("--all", action="store_true", help="check every bundled pipeline in turn")
    ap.add_argument("--model", help="a FittedPipeline saved with save(); analyzed in apply mode (the freeze and "
                                    "serve contract)")
    ap.add_argument("--example-shape", default=None, metavar="D0[,D1,...]",
                    help="per-datum input shape seeding the shape walk (with --model; bundled pipelines take "
                         "their synthetic training data)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="the intended fit or apply deadline (seconds): enables the deadline-feasibility estimate")
    ap.add_argument("--dot", metavar="OUT", default=None,
                    help="write a Graphviz DOT of the graph with the findings overlaid (red: error, yellow: warning)")
    ap.add_argument("--no-solver-lint", action="store_true", help="skip the precision pass (the solvers' runs)")
    ap.add_argument("--json", action="store_true", help="print the report as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where a bundled pipeline's synthetic data and a model live: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if sum((bool(args.pipeline), bool(args.model), args.all)) != 1:
        ap.error("pass exactly one of <PipelineName>, --all or --model")

    from keystone_tpu_torch.analysis import ALL_PASSES, DEFAULT_PASSES, analyze
    from keystone_tpu_torch.analysis.bundled import BUNDLED, build_bundled
    from keystone_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    passes = DEFAULT_PASSES + ("plan",) if args.no_solver_lint else ALL_PASSES
    targets = list(BUNDLED) if args.all else [args.pipeline or args.model]
    rc = 0
    for target in targets:
        mode = "fit"
        if args.model:
            from keystone_tpu_torch.workflow.pipeline import FittedPipeline

            pipe = FittedPipeline.load(args.model, map_location=device)
            example = tuple(int(d) for d in args.example_shape.split(",")) if args.example_shape else None
            mode = "apply"
        else:
            try:
                pipe, example = build_bundled(target, device=device)
            except ValueError as e:
                print(str(e), file=sys.stderr)
                return 2
        before = _device_work(device)
        report = analyze(pipe, example=example, deadline=args.deadline, passes=passes, mode=mode, device=device)
        after = _device_work(device)
        if args.all:
            print(f"== {target}")
        if args.json:
            import json

            print(json.dumps(report.to_dict(), indent=2))
        else:
            print(report.render())
        if device.type == "cuda":
            launched = {k: after[0][k] - before[0][k] for k in after[0] if after[0][k] != before[0].get(k, 0)}
            print(f"device work during the analysis: kernel launches {launched}, device memory allocated "
                  f"{before[1]} -> {after[1]} bytes")
        if args.dot:
            from keystone_tpu_torch.workflow.viz import to_dot

            dot = args.dot if not args.all else f"{args.dot}.{target}"
            with open(dot, "w") as f:
                f.write(to_dot(pipe.graph, findings=report.findings))
            print(f"wrote findings overlay to {dot}")
        rc = max(rc, 0 if report.ok else 1)
    return rc


def _device_work(device):
    """(the kernel wrappers' launch counts, the device's allocated bytes):
    what an analysis must leave unchanged.  Garbage is collected first, so
    that a pipeline's build leftovers freed meanwhile do not count."""
    import gc

    import torch

    from keystone_tpu_torch.ops import fisher_kernels, gram_kernels

    launches = {**{f"fisher.{k}": v for k, v in fisher_kernels.LAUNCHES.items()},
                **{f"gram.{k}": v for k, v in gram_kernels.LAUNCHES.items()}}
    if device.type == "cuda":
        gc.collect()
        torch.cuda.synchronize(device)
        return launches, torch.cuda.memory_allocated(device)
    return launches, 0


def _plan_main(argv) -> int:
    """``plan``: show (or build) a cost-based ``PhysicalPlan``: each
    stage's candidates, sampled costs, the winner and why, and the serving
    knobs.  Reads the plan a registry version or an exported bundle ships
    in its manifest, a plan file, or builds one by sampling a saved
    model."""
    ap = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.cli plan",
        description="show or build the cost-based physical plan that ships with a model: candidate "
                    "implementations, sampled cost curves, winners and serving knobs",
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-dir", metavar="DIR",
                     help="a model registry: the plan its current (or --version) version's bundle ships")
    src.add_argument("--bundle", metavar="DIR", help="an exported artifact bundle directory (MANIFEST.json)")
    src.add_argument("--file", metavar="PLAN.json", help="a plan file")
    src.add_argument("--model", metavar="MODEL.pt",
                     help="build a plan now by sampling this saved fitted pipeline (needs --example-shape)")
    ap.add_argument("--version", default=None, help="registry version (with --model-dir; default: the latest)")
    ap.add_argument("--example-shape", default=None, metavar="D0[,D1,...]",
                    help="per-datum input shape of --model's sampling rows")
    ap.add_argument("--dtype", default="float32", help="--model's sampling dtype")
    ap.add_argument("--seed", type=int, default=0, help="--model's sampling seed")
    ap.add_argument("--max-batch", type=int, default=32, help="--model's serving max_batch (the bucket knob)")
    ap.add_argument("--device", default="cuda", help="where --model is sampled: cuda (default) or cpu")
    ap.add_argument("--out", default=None, metavar="PLAN.json", help="write the (read or built) plan to this file")
    ap.add_argument("--explain", action="store_true",
                    help="every candidate's samples, fitted curve, cost at the serving batch, and the winner's why")
    ap.add_argument("--json", action="store_true", help="print the plan as JSON")
    args = ap.parse_args(argv)

    import json

    from keystone_tpu_torch.planner import PhysicalPlan, build_plan

    if args.file:
        with open(args.file) as f:
            plan = PhysicalPlan.from_dict(json.load(f))
    elif args.bundle:
        from keystone_tpu_torch.serve.registry import MANIFEST_FILE

        with open(os.path.join(args.bundle, MANIFEST_FILE)) as f:
            manifest = json.load(f)
        if manifest.get("plan") is None:
            print("bundle ships no plan (exported without --plan)", file=sys.stderr)
            return 1
        plan = PhysicalPlan.from_dict(manifest["plan"])
    elif args.model_dir:
        from keystone_tpu_torch.serve import ModelRegistry

        reg = ModelRegistry(args.model_dir)
        version = args.version or (reg.versions() or [None])[-1]
        if version is None:
            print(f"no versions published in {args.model_dir}", file=sys.stderr)
            return 1
        plan_dict = ((reg.load_artifacts(version) or {}).get("manifest") or {}).get("plan")
        if plan_dict is None:
            print(f"version {version} ships no plan", file=sys.stderr)
            return 1
        plan = PhysicalPlan.from_dict(plan_dict)
    else:
        if not args.example_shape:
            ap.error("--model needs --example-shape for its sampling rows")
        import numpy as np

        from keystone_tpu_torch.utils.device import resolve_device
        from keystone_tpu_torch.workflow.pipeline import FittedPipeline

        device = resolve_device(args.device)
        shape = tuple(int(d) for d in args.example_shape.split(","))
        example = _sample_rows(np.random.default_rng(args.seed), shape, np.dtype(args.dtype))
        fitted = FittedPipeline.load(args.model, map_location=device)
        plan = build_plan(fitted, example=example, max_batch=args.max_batch, seed=args.seed, device=device)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(plan.to_dict(), f, indent=2, sort_keys=True)
        print(f"wrote plan {plan.fingerprint()} to {args.out}")
    if args.json:
        print(json.dumps(plan.to_dict(), indent=2, sort_keys=True))
    elif args.explain:
        print(plan.explain())
    else:
        print(f"plan {plan.fingerprint()}  backend={plan.backend} source={plan.source} stages={len(plan.stages)}")
        for st in plan.stages:
            print(f"  {st.gate}: {st.winner}  ({st.why})")
        for k in sorted(plan.knobs):
            print(f"  knob {k} = {plan.knobs[k]}")
        print("(--explain for candidates, sampled costs, and fits)")
    for code, msg in plan.validate(backend=plan.backend):
        print(f"WARNING [{code}] {msg}", file=sys.stderr)
    return 0


def _worker_main(argv) -> int:
    """``worker``: one network-fleet worker.  Dials a router started with
    ``serve --hosts``, receives the model over TCP, loads it onto the
    device the router's deploy names, primes, and serves applies until
    the router says bye, dialing back through partitions and fencing
    itself whenever its heartbeat lease lapses."""
    ap = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.cli worker",
        description="run one network-fleet serving worker: connect to a router's worker listener, receive the "
                    "model over TCP, prime, and serve under a heartbeat lease",
    )
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="the router's worker listener (printed by serve --hosts; service.listen_address)")
    ap.add_argument("--name", default=None, help="the worker's label in the router's logs and metrics")
    ap.add_argument("--connect-attempts", type=int, default=30,
                    help="connect and reconnect attempts (backoff and jitter) before giving up")
    ap.add_argument("--backoff-seed", type=int, default=None, help="seed of the reconnect jitter")
    args = ap.parse_args(argv)
    from keystone_tpu_torch.serve.net import run_worker

    return run_worker(args.connect, name=args.name, connect_attempts=args.connect_attempts,
                      backoff_seed=args.backoff_seed)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("--list", "-l", "--help", "-h"):
        print("usage: python -m keystone_tpu_torch.cli <PipelineName> [flags]")
        print("       python -m keystone_tpu_torch.cli serve --model model.pt|--model-dir DIR [flags]")
        print("       python -m keystone_tpu_torch.cli worker --connect HOST:PORT [flags]")
        print("       python -m keystone_tpu_torch.cli export --model model.pt --example-shape D0[,D1,...] [flags]")
        print("       python -m keystone_tpu_torch.cli check <PipelineName>|--model model.pt [flags]")
        print("       python -m keystone_tpu_torch.cli plan --model-dir DIR|--bundle DIR|--file plan.json|"
              "--model model.pt [flags]")
        print("pipelines:")
        for name in _PIPELINE_MODULES:
            print(f"  {name}")
        return 0
    name, rest = argv[0], argv[1:]
    if name == "serve":
        return _serve_main(rest)
    if name == "export":
        return _export_main(rest)
    if name == "worker":
        return _worker_main(rest)
    if name == "check":
        return _check_main(rest)
    if name == "plan":
        return _plan_main(rest)
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
