"""Per-stage roofline of the bench forward on the card (counterpart of the
repo's ``tools/roofline_forward.py``, which reads a TPU profiler trace).

The forward is ``pipelines/imagenet_sift_lcs_fv.py::build_forward`` at
``bench.py``'s widths: batch 128, 128×128×3 images, SIFT step 4 bin 4
with smoothing 6.0, PCA 64, K = 256 through the Fisher-vector kernel (B2,
``csrc/fisher.cu::fv_encode_kernel``), SignedHellinger, NormalizeRows and
1000 classes.  ``--ms`` takes the multi-scale config instead: bins
(4, 6, 8, 10), smoothing 6.0, batch 64 (``bench.py:85-87``).

Each stage runs inside a ``record_function`` region
(``roofline:<stage>#<iteration>``) under ``utils/tracing.py``'s
``torch.profiler`` capture with CUDA activity.  The Chrome trace it
writes is read back here: every kernel, copy and fill is joined by its
correlation id to the launch that made it, and the launch to the region
it sits in.  For each stage the tool reports:

- device µs per batch, the median over 8 traced iterations;
- the flops and bytes of the problem (its shapes, not the kernels that
  run it): flops by ``bench.py::flops_per_image``'s per-stage arithmetic
  (elementwise stages count none, as there), bytes as each input read
  once and each output written once, the FV stage priced by
  ``chip_smoke.py``'s ``fv_cost`` so that B2 and the plain chain
  (``--plain``) are priced at the same work;
- the bound, max(bytes / 3.35 TB/s, flops / peak), the peak that of the
  unit that stage's arithmetic runs on: the FV kernel's 3xTF32 products
  on the tensor cores (495 TFLOP/s, three passes counted), the rest f32
  on the CUDA cores (67 TFLOP/s, TF32 off); which bound limits it; and
  the achieved fraction, bound over time.  A stage over 1.05 of its
  bound is a counting error and raises.

It also reports the device's busy time against the wall-clock marginal
time per batch, the slope between 20- and 60-iteration runs ended by a
synchronize (each length's fastest of three), and the card's name and
power limit (``nvidia-smi``).

    python -m keystone_tpu_torch.tools.roofline_forward [--ms] [--json]
        [--precision {f32,bf16}] [--batch N] [--plain] [--device cpu]

``--precision`` sets the port's matmul mode (``utils/precision.py``): the
descriptor stream f32 or bf16; the apply side is f32 in either
(``precision.apply_mode``).  On a machine without a card the tool
refuses unless ``--device cpu`` is given; there a stage's time is its
region's host time, reported as such and never as device time.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import statistics
import subprocess
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

# bench.py's widths (bench.py:72-77) and its multi-scale leg (:85-87)
BATCH = 128
IMAGE_HW = 128
SIFT_STEP = 4
BIN_SIZE = 4
SMOOTHING = 6.0
GMM_K = 256
PCA_DIMS = 64
NUM_CLASSES = 1000
BLOCK = 4096
SIFT_DIM = 128
MS_BATCH = 64
MS_BIN_SIZES = (4, 6, 8, 10)
MS_SMOOTHING = 6.0

TRACE_ITERS = 8
WALL_ITERS = (20, 60)
WALL_REPS = 3
WARMUP = 3

# H100 SXM, NVIDIA's data sheet, dense, at 700 W (chip_smoke.py's peaks)
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
#: a stage read over this fraction of its bound was counted wrong
OVER_BOUND = 1.05

#: build_forward's stages, in order
STAGES = ("gray", "sift", "pca", "fv", "hellinger", "normalize", "blm")
PREFIX = "roofline:"
#: trace categories of work on the device, and of the host calls that launch it
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class CountingError(RuntimeError):
    """A stage ran faster than the least time its work allows."""


# ------------------------------------------------------------ the problem


def stage_flops_per_image(bin_sizes: Sequence[int] = (BIN_SIZE,), smoothing: bool = True, hw: int = IMAGE_HW,
                          step: int = SIFT_STEP, d: int = PCA_DIMS, k: int = GMM_K,
                          classes: int = NUM_CLASSES) -> Dict[str, float]:
    """``bench.py::flops_per_image`` (2·MACs), split by stage: SIFT's two
    windowing contractions a scale and its banded blur, the PCA
    projection, the FV's four T·d·K contractions, the BLM product; the
    elementwise stages count none."""
    from keystone_tpu_torch.ops.sift import _window_matrix, sift_output_count

    t = sift_output_count(hw, hw, step, bin_sizes)
    sift = 0
    for b in bin_sizes:
        p = _window_matrix(hw, step, b)[0].shape[0]
        sift += 2 * p * hw * hw * 8 + 2 * p * hw * p * 8
    if smoothing:
        sift += len(bin_sizes) * (2 * hw * hw * hw + 2 * hw * hw * hw)
    return {
        "gray": 0.0,
        "sift": float(sift),
        "pca": float(2 * t * SIFT_DIM * d),
        "fv": float(4 * 2 * t * d * k),
        "hellinger": 0.0,
        "normalize": 0.0,
        "blm": float(2 * (2 * k * d) * classes),
    }


def flops_per_image(bin_sizes: Sequence[int] = (BIN_SIZE,), smoothing: bool = True, **widths) -> float:
    return float(sum(stage_flops_per_image(bin_sizes, smoothing, **widths).values()))


def fv_cost(n, t, d, k, d_in=0, desc_bytes=4):
    """(bytes, flops) a Fisher-vector kernel call must move and do
    (``chip_smoke.py::fv_cost``): each input read once, the FV written
    once; four T·d·K contractions per image plus the d_in→d projection."""
    gmm = (k + 2 * k * d) * 4
    if d_in:
        inputs = n * t * d_in * desc_bytes + (d_in * d + d_in) * 4
    else:
        inputs = n * t * d * desc_bytes
    nbytes = inputs + n * t * 4 + gmm + n * 2 * k * d * 4
    flops = n * (8 * t * d * k + 2 * t * d_in * d)
    return nbytes, flops


def stage_costs(n: int, bin_sizes: Sequence[int] = (BIN_SIZE,), smoothing: bool = True, hw: int = IMAGE_HW,
                step: int = SIFT_STEP, d: int = PCA_DIMS, k: int = GMM_K,
                classes: int = NUM_CLASSES) -> Dict[str, dict]:
    """Each stage's bytes, flops and the peak its arithmetic runs at, for
    a batch of ``n`` images, all f32: each input read once (the stage's
    operands and its weights), each output written once."""
    from keystone_tpu_torch.ops.sift import sift_output_count

    t = sift_output_count(hw, hw, step, bin_sizes)
    f = 2 * k * d
    fl = stage_flops_per_image(bin_sizes, smoothing, hw, step, d, k, classes)
    fv_bytes, _ = fv_cost(n, t, d, k)
    nbytes = {
        "gray": n * hw * hw * 3 * 4 + n * hw * hw * 4,
        "sift": n * hw * hw * 4 + n * t * SIFT_DIM * 4 + n * t * 4,
        "pca": n * t * SIFT_DIM * 4 + (SIFT_DIM * d + SIFT_DIM) * 4 + n * t * d * 4,
        "fv": fv_bytes,
        "hellinger": 2 * n * f * 4,
        "normalize": 2 * n * f * 4,
        "blm": n * f * 4 + (-(-f // BLOCK) * BLOCK) * classes * 4 + n * classes * 4,
    }
    out = {}
    for s in STAGES:
        tensor_cores = s == "fv"
        out[s] = {
            "bytes": float(nbytes[s]),
            "flops": float(n * fl[s]),
            "unit": "tensor cores, 3xTF32" if tensor_cores else "CUDA cores, f32",
            # three TF32 products a multiply-add on the tensor cores
            "peak_flops": PEAK_TF32_FLOPS / 3 if tensor_cores else PEAK_F32_FLOPS,
        }
    return out


def roofline(stage_us: Dict[str, float], costs: Dict[str, dict], check: bool = True) -> List[dict]:
    """One row a stage: its µs against its bound.  ``check``: raise
    :class:`CountingError` on a stage over ``OVER_BOUND`` of its bound."""
    rows = []
    for s in STAGES:
        c, us = costs[s], stage_us[s]
        t_bytes = c["bytes"] / PEAK_BYTES * 1e6
        t_ops = c["flops"] / c["peak_flops"] * 1e6
        bound = max(t_bytes, t_ops)
        frac = bound / us if us > 0 else None
        rows.append({"stage": s, "us": us, "flops": c["flops"], "bytes": c["bytes"], "bound_us": bound,
                     "bound_by": "operations" if t_ops > t_bytes else "bytes", "unit": c["unit"],
                     "fraction": frac})
        if check and frac is not None and frac > OVER_BOUND:
            raise CountingError(f"stage {s}: {us:.2f} us against a bound of {bound:.2f} us "
                                f"({frac:.2f} of it): its bytes or flops are counted wrong")
    return rows


# --------------------------------------------------------------- the trace


def load_trace(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def _region(name: str):
    """(stage, iteration) of a ``roofline:<stage>#<i>`` region name."""
    stage, _, it = name[len(PREFIX):].rpartition("#")
    return stage, int(it)


def aggregate(events: List[dict], host: bool = False) -> Dict[str, List[float]]:
    """{stage: [µs in iteration 0, 1, ...]} from a Chrome trace's events.

    On the card (``host=False``) a stage's µs are the durations of the
    device work launched inside its region: each kernel, copy or fill
    joined by its correlation id to its launch, the launch to the region
    of the same thread that holds it.  ``host=True`` (a CPU run) takes
    each region's own duration on the host clock."""
    regions = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
               and str(e.get("name", "")).startswith(PREFIX)]
    acc: Dict[str, Dict[int, float]] = defaultdict(dict)
    for r in regions:
        s, i = _region(r["name"])
        acc[s][i] = float(r["dur"]) if host else 0.0
    if not host:
        by_thread: Dict[tuple, List[dict]] = defaultdict(list)
        for r in regions:
            by_thread[(r.get("pid"), r.get("tid"))].append(r)
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in _LAUNCH_CATS and "correlation" in (e.get("args") or {})}
        for e in events:
            if e.get("cat") not in _DEVICE_CATS:
                continue
            launch = launches.get((e.get("args") or {}).get("correlation"))
            if launch is None:
                continue
            ts = float(launch["ts"])
            holders = [r for r in by_thread.get((launch.get("pid"), launch.get("tid")), ())
                       if float(r["ts"]) <= ts <= float(r["ts"]) + float(r["dur"])]
            if holders:
                inner = max(holders, key=lambda r: float(r["ts"]))
                s, i = _region(inner["name"])
                acc[s][i] += float(e["dur"])
    return {s: [acc[s][i] for i in sorted(acc[s])] for s in acc}


def device_busy_us(events: List[dict]) -> float:
    """Every kernel's, copy's and fill's µs in the trace."""
    return float(sum(float(e["dur"]) for e in events if e.get("cat") in _DEVICE_CATS))


# ------------------------------------------------------------------ the run


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def build(batch: int, bin_sizes: Sequence[int], smoothing: float, device, use_kernel: Optional[bool] = None,
          hw: int = IMAGE_HW, d: int = PCA_DIMS, k: int = GMM_K, classes: int = NUM_CLASSES, seed: int = 0):
    """The bench forward's stages with seeded weights, and a seeded batch."""
    import numpy as np
    import torch

    from keystone_tpu_torch.convert import params_from_numpy
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P

    cfg = P.Config(sift_step=SIFT_STEP, sift_bin_size=bin_sizes[0], pca_dims=d, gmm_k=k, num_classes=classes)
    raw = P.random_params(("sift",), pca_dims=d, gmm_k=k, num_classes=classes, block_size=BLOCK, seed=seed)
    fwd = P.build_forward(params_from_numpy(raw, device=device), cfg, device, use_kernel=use_kernel,
                          bin_sizes=bin_sizes, smoothing_magnif=smoothing)
    stages = list(fwd.stages)
    if len(stages) != len(STAGES):
        raise RuntimeError(f"build_forward has {len(stages)} stages, expected {STAGES}")
    x = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (batch, hw, hw, 3)).astype(np.float32)).to(device)
    return stages, x


def _forward(stages, x, it: Optional[int] = None):
    import torch

    mask = None
    for name, s in zip(STAGES, stages):
        if it is None:
            out = s.apply_batch(x, mask=mask)
        else:
            with torch.profiler.record_function(f"{PREFIX}{name}#{it}"):
                out = s.apply_batch(x, mask=mask)
        x, mask = out if isinstance(out, tuple) else (out, None)
    return x


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_marginal(stages, x, dev, iters=WALL_ITERS) -> float:
    """Seconds a batch at the margin: the slope between runs of ``iters``
    forwards, each ended by a synchronize, from each length's fastest of
    ``WALL_REPS`` runs taken in turns (a host stall only adds time)."""

    def run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            _forward(stages, x)
        _sync(dev)
        return time.perf_counter() - t0

    lo, hi = iters
    t_lo, t_hi = float("inf"), float("inf")
    for _ in range(WALL_REPS):
        t_lo, t_hi = min(t_lo, run(lo)), min(t_hi, run(hi))
    return (t_hi - t_lo) / (hi - lo)


def run(ms: bool = False, batch: Optional[int] = None, precision_mode: str = "f32", device="cuda",
        use_kernel: Optional[bool] = None, trace_iters: int = TRACE_ITERS, wall_iters=WALL_ITERS,
        hw: int = IMAGE_HW, d: int = PCA_DIMS, k: int = GMM_K, classes: int = NUM_CLASSES,
        logdir: Optional[str] = None, built=None) -> dict:
    """Trace the forward and return the roofline (see the module docstring).
    ``logdir`` keeps the Chrome trace there (else a temporary directory is
    removed).  The widths default to bench.py's; tests pass small ones.
    ``built``: the ``(stages, images)`` that :func:`build` made for this
    config, for a caller that goes on using them."""
    import torch

    from keystone_tpu_torch.ops import fisher_kernels
    from keystone_tpu_torch.utils import precision, tracing
    from keystone_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    bins = MS_BIN_SIZES if ms else (BIN_SIZE,)
    smoothing = MS_SMOOTHING if ms else SMOOTHING
    n = batch or (MS_BATCH if ms else BATCH)
    widths = dict(hw=hw, d=d, k=k, classes=classes)
    with precision.matmul(precision_mode), torch.no_grad():
        stages, x = built or build(n, bins, smoothing, dev, use_kernel, **widths)
        for _ in range(WARMUP):
            _forward(stages, x)
        _sync(dev)
        wall = wall_marginal(stages, x, dev, wall_iters)
        keep = logdir is not None
        logdir = logdir or tempfile.mkdtemp(prefix="roofline-")
        before = dict(fisher_kernels.LAUNCHES)
        try:
            with tracing.trace(logdir):
                for it in range(trace_iters):
                    _forward(stages, x, it)
                _sync(dev)
            launches = {key: v - before[key] for key, v in fisher_kernels.LAUNCHES.items() if v != before[key]}
            path = max(glob.glob(os.path.join(logdir, "*.json")), key=os.path.getmtime)
            events = load_trace(path)
        finally:
            if not keep:
                shutil.rmtree(logdir, ignore_errors=True)
    host = dev.type != "cuda"
    per_iter = aggregate(events, host=host)
    missing = [s for s in STAGES if len(per_iter.get(s, ())) != trace_iters]
    if missing:
        raise RuntimeError(f"the trace holds no region for every iteration of {missing}")
    stage_us = {s: statistics.median(per_iter[s]) for s in STAGES}
    if not host and not any(stage_us.values()):
        raise RuntimeError("the trace holds no device time: CUPTI saw no kernel")
    costs = stage_costs(n, bins, smoothing > 0, hw, SIFT_STEP, d, k, classes)
    rows = roofline(stage_us, costs, check=not host)
    fpi = flops_per_image(bins, smoothing > 0, hw=hw, d=d, k=k, classes=classes)
    out = {
        "device": torch.cuda.get_device_name(dev) if not host else "cpu",
        "card": card() if not host else None,
        "clock": "host regions (CPU run)" if host else "device kernels (CUPTI)",
        "config": "multi-scale" if ms else "single-scale",
        "batch": n,
        "bin_sizes": list(bins),
        "smoothing": smoothing,
        "precision": precision_mode,
        "apply_precision": precision.apply_mode(),
        "fv_path": "plain chain" if host or use_kernel is False else "B2 kernel",
        "trace_iters": trace_iters,
        "wall_marginal_us": wall * 1e6,
        "stages_us": sum(stage_us.values()),
        "images_per_sec": n / wall,
        "achieved_tflops": n * fpi / wall / 1e12,
        "flops_per_image": fpi,
        "launches": launches,
        "stages": rows,
        "stage_iters_us": per_iter,
        "peaks": {"bytes_per_s": PEAK_BYTES, "f32_flops": PEAK_F32_FLOPS, "tf32_flops": PEAK_TF32_FLOPS},
    }
    if not host:
        out["device_busy_us"] = device_busy_us(events) / trace_iters
    return out


def render(r: dict) -> str:
    dev = r["device"] + (f" ({r['card']})" if r.get("card") else "")
    busy = (f"device busy {r['device_busy_us']:.1f} us" if "device_busy_us" in r
            else f"host regions {r['stages_us']:.1f} us (a CPU run: no device time)")
    lines = [f"{r['config']} bench forward, batch {r['batch']}, bins {r['bin_sizes']}, precision {r['precision']} "
             f"(apply {r['apply_precision']}), FV by the {r['fv_path']}, on {dev}",
             f"wall marginal {r['wall_marginal_us']:.1f} us/batch ({r['images_per_sec']:.1f} images/s), {busy}, "
             f"stages {r['stages_us']:.1f} us",
             f"{'stage':<10}{'us':>10}{'GFLOP':>9}{'MB':>9}{'bound us':>10}{'by':>11}{'fraction':>9}  unit"]
    for s in r["stages"]:
        frac = "-" if s["fraction"] is None else f"{s['fraction']:.3f}"
        lines.append(f"{s['stage']:<10}{s['us']:>10.1f}{s['flops'] / 1e9:>9.3f}{s['bytes'] / 1e6:>9.2f}"
                     f"{s['bound_us']:>10.2f}{s['bound_by']:>11}{frac:>9}  {s['unit']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="per-stage roofline of the bench forward on the card")
    ap.add_argument("--ms", action="store_true", help="the multi-scale config: bins (4, 6, 8, 10), batch 64")
    ap.add_argument("--batch", type=int, default=None, help="images a batch (default 128, or 64 with --ms)")
    ap.add_argument("--precision", choices=("f32", "bf16"), default="f32",
                    help="the port's matmul mode (utils/precision.py); the apply side is f32")
    ap.add_argument("--plain", action="store_true", help="the FV stage by its plain chain, not B2")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true", help="print the result as one JSON object")
    args = ap.parse_args(argv)
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("roofline_forward: torch sees no CUDA device; pass --device cpu for a CPU run")
        return 2
    r = run(ms=args.ms, batch=args.batch, precision_mode=args.precision, device=args.device,
            use_kernel=False if args.plain else None)
    print(json.dumps(r) if args.json else render(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
