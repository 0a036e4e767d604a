"""Where a fit's seconds go (counterpart of ``tools/profile_fit.py``).

Runs ``ImageNetSiftLcsFV.build(...).fit()`` at bench.py's fit leg (2048
synthetic 128×128 images, 64 classes, K = 64, PCA 64, blocks of 4096, 2
epochs) the way ``Pipeline.fit`` runs it, with its wall time split into
the optimizer's rule batches (cse, node-choice, materialize, fusion),
read from the optimizer's own per-rule timings, the fit's pre-flight,
and the estimators' walk in profile mode (each node ended by a device
synchronize, so each node's seconds are its own):

    python -m keystone_tpu_torch.tools.profile_fit               # on the card
    python -m keystone_tpu_torch.tools.profile_fit 256 --repeat  # a second walk, after a first
    python -m keystone_tpu_torch.tools.profile_fit 16 --device cpu --image-size 32

Prints the split as text, then one JSON object on the last line.
"""

from __future__ import annotations

import argparse
import json
import time

# bench.py's fit leg (bench.py:89-95, the widths of :72-77)
FIT_N = 2048
FIT_CLASSES = 64
FIT_GMM_K = 64
FIT_EPOCHS = 2
FIT_SOLVER_BLOCK = 4096
IMAGE_HW = 128
PCA_DIMS = 64


def split_fit(pipe, repeat: bool = False, top: int = 20) -> dict:
    """Optimize and fit ``pipe`` as ``Pipeline.fit`` does: the optimizer's
    own per-rule seconds (``optimizer.rule_seconds``) summed by rule
    batch, the pre-flight, and the estimators' walk in profile mode.
    Returns ``{"batches": {name: seconds}, "preflight": seconds,
    "execute": seconds, "nodes": [[seconds, "id:label"], ...]}`` with the
    ``top`` slowest nodes of the walk.  ``repeat``: time a second walk
    of the optimized graph (the first one's lazy builds and caches warm)."""
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.workflow import profiling
    from keystone_tpu_torch.workflow.executor import GraphExecutor, synchronize
    from keystone_tpu_torch.workflow.pipeline import PipelineEnv, _auto_out_of_core, fit_estimators

    if not metrics.enabled():
        raise RuntimeError("profile_fit reads the optimizer's rule timings: unset KEYSTONE_METRICS=0")
    optimizer = PipelineEnv.get_optimizer()

    def rule_seconds():
        out = {}
        for batch in optimizer.batches:
            for rule in batch.rules:
                h = metrics.REGISTRY.histogram_value("optimizer.rule_seconds", rule=rule.name)
                out[rule.name] = h["sum"] if h else 0.0
        return out

    before = rule_seconds()
    profiling.last_footprint.clear()
    g = optimizer.execute(pipe.graph)
    after = rule_seconds()
    batches = {b.name: sum(after[r.name] - before[r.name] for r in b.rules) for b in optimizer.batches}
    t0 = time.perf_counter()
    g = _auto_out_of_core(g)
    preflight = time.perf_counter() - t0

    def walk():
        ex = GraphExecutor(g, profile=True)
        t0 = time.perf_counter()
        fit_estimators(g, ex)
        synchronize()
        return ex, time.perf_counter() - t0

    ex, seconds = walk()
    if repeat:
        ex, seconds = walk()
    nodes = sorted(((s, f"{n.id}:{g.operators[n].label()}") for n, s in ex.timings.items()), reverse=True)
    return {"batches": batches, "preflight": preflight, "execute": seconds, "nodes": [list(x) for x in nodes[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=FIT_N, help="training images")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--image-size", type=int, default=IMAGE_HW)
    ap.add_argument("--repeat", action="store_true", help="time a second walk of the optimized graph")
    a = ap.parse_args(argv)

    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
    from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV
    from keystone_tpu_torch.utils import precision
    from keystone_tpu_torch.utils.device import resolve_device

    dev = resolve_device(a.device)
    precision.disable_tf32()
    cfg = Config(num_classes=FIT_CLASSES, synthetic_n=a.n, image_size=a.image_size, gmm_k=FIT_GMM_K,
                 pca_dims=PCA_DIMS, num_epochs=FIT_EPOCHS, solver_block_size=FIT_SOLVER_BLOCK)
    t_all = time.perf_counter()
    train = ImageNetLoader.synthetic(a.n, FIT_CLASSES, (a.image_size, a.image_size), seed=1, device=dev)
    t0 = time.perf_counter()
    pipe = ImageNetSiftLcsFV.build(cfg, train.data, train.labels)
    build = time.perf_counter() - t0
    out = split_fit(pipe, repeat=a.repeat)
    out.update(n=a.n, device=str(dev), build=build, total=time.perf_counter() - t_all)
    print(f"n={a.n} on {dev}: total {out['total']:.3f} s, build {build:.3f} s, pre-flight {out['preflight']:.3f} s, "
          f"execute {out['execute']:.3f} s")
    print("optimizer batches:")
    for k, v in out["batches"].items():
        print(f"  {k:<14} {v:8.3f} s")
    print("slowest nodes of the walk (synchronized):")
    for secs, label in out["nodes"]:
        print(f"  {secs:8.3f} s  {label[:100]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
