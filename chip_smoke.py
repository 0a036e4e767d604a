"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole check, one card
    python3 chip_smoke.py --profile  # also a profiler breakdown of one scorer batch

Phases, each of which must pass (any failure exits non-zero before the
result line):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every CUDA source of the port compiled by nvcc for sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (f32 and a bf16 descriptor stream), plus a
   ragged T with masked rows, within the stated tolerances;
4. main paths at full width (batch 128, 128×128 RGB, SIFT step 4 → T=784,
   LCS step 6 → T=324, PCA 64, K=256, 1000 classes; seeded random
   weights made as bench.py makes them): the fused two-branch scorer and
   the unfused bench forward, each with its launch counts set to 0 just
   before and read just after, then checked against the same pipeline
   built on the plain versions (scores within tolerance, top-5 ids equal
   on ≥ 99% of images) and timed as images/s;
5. one JSON line of kernel numbers (ms, plain ms, bound, launches), then
   the last line {"ok": true, "device": {...}}.

Imports nothing of JAX; exits non-zero without a result when torch sees
no CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 128
IMAGE_HW = 128
BATCHES = 8  # timed batches per main path (after one warm-up batch)
SIFT_STEP, SIFT_BIN = 4, 4
LCS_STEP, LCS_SUB = 6, 6
PCA_DIMS, GMM_K, NUM_CLASSES = 64, 256, 1000

# tolerances against the plain version on the same inputs, elementwise
# |got − ref| ≤ atol + rtol·|ref|.  atol: the JAX package's own for its
# Pallas kernels (tests/test_pallas.py).  rtol: on the main path's data γ
# concentrates on a few components, whose FV entries reach tens; their
# sums over 784 descriptors, taken in another order than cuBLAS's, round
# at ~1e-6 relative in f32, which an absolute 2e-5 alone does not cover.
TOL_FV = 2e-5
TOL_FUSED = 3e-5
RTOL_F32 = 1e-5
# bf16 descriptor stream against the f32 encode: the JAX package's 5e-2,
# plus bf16's 8-bit mantissa (2^-9 relative) carried into the larger entries
TOL_BF16 = 5e-2
RTOL_BF16 = 1e-2
# class scores: 0.01·normal weights against an L2-normalized 65536-wide
# feature row, so |score| ≲ 0.05; the kernel's FV agrees to ~1e-5
TOL_SCORES = 1e-4
TOP5_AGREEMENT = 0.99

# H100 SXM (NVIDIA data sheet, dense, at 700 W): f32 outside the tensor
# cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
DEVICE = "cuda"


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"[phase] {name} ...", flush=True)
    yield
    print(f"[phase] {name} ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def fv_cost(n, t, d, k, d_in=0, desc_bytes=4):
    """(bytes, flops) a Fisher-vector kernel call must move and do: each
    input read once, the FV written once; four T·d·K contractions per
    image (two posterior gemms, γᵀx, γᵀx²) plus the d_in→d projection."""
    gmm = (k + 2 * k * d) * 4
    if d_in:
        inputs = n * t * d_in * desc_bytes + (d_in * d + d_in) * 4
    else:
        inputs = n * t * d * desc_bytes
    nbytes = inputs + n * t * 4 + gmm + n * 2 * k * d * 4
    flops = n * (8 * t * d * k + 2 * t * d_in * d)
    return nbytes, flops


def bound_ms(nbytes, flops):
    return 1e3 * max(nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def compare(name, got, ref, atol, rtol=RTOL_F32):
    diff = (got.float() - ref.float()).abs()
    err = diff.max().item()
    ratio = (diff / (atol + rtol * ref.float().abs())).max().item()
    print(f"  {name}: max_abs_err={err:.3e} (|ref| max {ref.abs().max().item():.3e}); "
          f"tol {atol:.0e} + {rtol:.0e}·|ref|, worst ratio {ratio:.3f}", flush=True)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(ratio <= 1.0, f"{name}: error above tolerance (worst ratio {ratio:.3f})")
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="profile one scorer batch")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    from keystone_tpu_torch.convert import params_from_numpy
    from keystone_tpu_torch.kernels import build
    from keystone_tpu_torch.ops import fisher_kernels as fk
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P
    from keystone_tpu_torch.utils import precision
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    dev = torch.device(DEVICE)
    precision.disable_tf32()

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        card = smi[0].strip()
        name = torch.cuda.get_device_name(0)
        print(card)
        print(f"  torch: {torch.__version__} cuda {torch.version.cuda}; device 0: {name}; "
              f"count {torch.cuda.device_count()}")

    with phase("build"):
        sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
        t0 = time.perf_counter()
        paths = build.build(sources)
        print(f"  built {sources} in {time.perf_counter() - t0:.1f} s")
        for s in sources:
            regs = [ln.strip() for ln in (build.BUILD_DIR / f"{s}.log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"  {paths[s].name}: " + "; ".join(regs))

    # ---- full-width model, seeded
    cfg = P.Config(sift_step=SIFT_STEP, sift_bin_size=SIFT_BIN, lcs_step=LCS_STEP,
                   lcs_subpatch=LCS_SUB, top_k=5)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.integers(0, 256, ((BATCHES + 1) * BATCH, IMAGE_HW, IMAGE_HW, 3), dtype=np.uint8)
    ).to(dev)
    batches = list(images.split(BATCH))
    # the bench forward takes images already scaled to [0, 1], as bench.py feeds it
    float_batches = [b.float() / 255.0 for b in batches]
    scorer_params = params_from_numpy(
        P.random_params(pca_dims=PCA_DIMS, gmm_k=GMM_K, num_classes=NUM_CLASSES, seed=0), dev)
    fwd_params = params_from_numpy(
        P.random_params(("sift",), pca_dims=PCA_DIMS, gmm_k=GMM_K, num_classes=NUM_CLASSES, seed=1),
        dev)
    scorer = P.build_scorer_from_params(scorer_params, cfg, dev)
    scorer_plain = P.build_scorer_from_params(scorer_params, cfg, dev, use_kernel=False)
    forward = P.build_forward(fwd_params, cfg, dev)
    forward_plain = P.build_forward(fwd_params, cfg, dev, use_kernel=False)

    # the kernels' inputs exactly as the main paths hand them over
    x0 = batches[0]
    xf = scorer.stages[0].apply_batch(x0)  # PixelScaler
    sift_branch, lcs_branch = scorer.stages[1].branches
    sift_raw, sift_mask = Pipeline(list(sift_branch.stages)[:2]).apply_batch(xf)
    lcs_desc, lcs_mask = lcs_branch.stages[0].apply_batch(xf)
    fused_sift, fused_lcs = sift_branch.stages[2], lcs_branch.stages[1]
    fx, fmask = Pipeline(list(forward.stages)[:3]).apply_batch(xf)
    g = forward.stages[3].gmm
    gmm_b2 = (g.weights, g.means, g.variances)

    def fused_args(node, desc, mask, mean):
        gm = node.gmm
        return desc, mask, node.components, mean, gm.weights, gm.means, gm.variances, node.sift_normalize

    errs = {"fisher_encode": 0.0, "fused_forward": 0.0}
    with phase("kernels vs plain versions"):
        check(tuple(fx.shape) == (BATCH, 784, PCA_DIMS), f"B2 input {tuple(fx.shape)}")
        check(tuple(sift_raw.shape) == (BATCH, 784, 128), f"B1 SIFT input {tuple(sift_raw.shape)}")
        check(tuple(lcs_desc.shape) == (BATCH, 324, 96), f"B1 LCS input {tuple(lcs_desc.shape)}")
        e = compare("B2 f32 (128, 784, 64, K=256)", fk.fisher_encode(fx, fmask, *gmm_b2),
                    fk.fisher_encode_ref(fx, fmask, *gmm_b2), TOL_FV)
        errs["fisher_encode"] = max(errs["fisher_encode"], e)
        xb = fx.to(torch.bfloat16)
        got = fk.fisher_encode(xb, fmask, *gmm_b2)
        compare("B2 bf16 stream vs plain on the same bf16 descriptors", got,
                fk.fisher_encode_ref(xb, fmask, *gmm_b2), TOL_FV)
        compare("B2 bf16 stream vs plain f32", got, fk.fisher_encode_ref(fx, fmask, *gmm_b2),
                TOL_BF16, RTOL_BF16)
        mean_sift = torch.from_numpy((0.01 * rng.normal(size=128)).astype(np.float32)).to(dev)
        mean_lcs = torch.from_numpy((0.01 * rng.normal(size=96)).astype(np.float32)).to(dev)
        for label, node, desc, mask, means in (
            ("B1 normalize=True (128, 784, 128->64, K=256)", fused_sift, sift_raw, sift_mask, mean_sift),
            ("B1 normalize=False (128, 324, 96->64, K=256)", fused_lcs, lcs_desc, lcs_mask, mean_lcs),
        ):
            for mlabel, m in (("mean", means), ("no mean", None)):
                a = fused_args(node, desc, mask, m)
                e = compare(f"{label}, {mlabel}", fk.fused_forward(*a), fk.fused_forward_ref(*a), TOL_FUSED)
                errs["fused_forward"] = max(errs["fused_forward"], e)
        # a ragged T (not a multiple of the kernel's 32-row tile) with rows masked off
        n_r, t_r = min(16, BATCH), 301
        mask_r = torch.from_numpy((rng.random((n_r, t_r)) > 0.15).astype(np.float32)).to(dev)
        mask_r[3] = 0.0  # an image with no valid descriptor: count = max(0, 1)
        xr = fx[:n_r, :t_r].contiguous()
        compare("B2 ragged T=301, masked rows", fk.fisher_encode(xr, mask_r, *gmm_b2),
                fk.fisher_encode_ref(xr, mask_r, *gmm_b2), TOL_FV)
        a = fused_args(fused_sift, sift_raw[:n_r, :t_r].contiguous(), mask_r, mean_sift)
        compare("B1 ragged T=301, masked rows", fk.fused_forward(*a), fk.fused_forward_ref(*a), TOL_FUSED)
        torch.cuda.synchronize()

    # ---- the main paths; each one's counts are zeroed just before and read just after
    results = {}
    for label, path, plain, kernel, inputs in (
        ("scorer (fused, two branches)", scorer, scorer_plain, "fused_forward", batches),
        ("bench forward (unfused, SIFT)", forward, forward_plain, "fisher_encode", float_batches),
    ):
        with phase(f"main path: {label}"):
            path(inputs[0])  # warm-up, not counted
            torch.cuda.synchronize()
            fk.reset_launches()
            t0 = time.perf_counter()
            outs = [path(b) for b in inputs[1:]]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(fk.LAUNCHES)
            ips = BATCHES * BATCH / dt
            print(f"  launches {launches}; {ips:.1f} images/s over {BATCHES} batches of {BATCH} "
                  f"({card})", flush=True)
            check(launches[kernel] > 0, f"{kernel} never launched on the main path")
            want = 2 * BATCHES if kernel == "fused_forward" else BATCHES
            check(launches[kernel] == want, f"{kernel} launched {launches[kernel]} times, expected {want}")
            results[kernel] = {"launches": launches[kernel], "images_per_s": ips}

            agree, worst = 0, 0.0
            score_k = P.scores_of(path) if kernel == "fused_forward" else path
            score_p = P.scores_of(plain) if kernel == "fused_forward" else plain
            for b, out in zip(inputs[1:], outs):
                sk, sp = score_k(b), score_p(b)
                check(tuple(sk.shape) == (BATCH, NUM_CLASSES), f"scores shape {tuple(sk.shape)}")
                check(bool(torch.isfinite(sk).all()), "non-finite scores")
                worst = max(worst, max_err(sk, sp))
                tk = torch.topk(sk, 5, dim=1).indices if kernel == "fisher_encode" else out
                check(tuple(tk.shape) == (BATCH, 5), f"top-5 shape {tuple(tk.shape)}")
                tp = torch.topk(sp, 5, dim=1).indices
                agree += int((tk.sort(dim=1).values == tp.sort(dim=1).values).all(dim=1).sum())
            frac = agree / (BATCHES * BATCH)
            print(f"  scores vs plain-version pipeline: max_abs_err={worst:.3e} tol={TOL_SCORES:.0e}; "
                  f"top-5 agreement {frac:.4f}", flush=True)
            check(worst <= TOL_SCORES, f"scores differ by {worst:.3e}")
            check(frac >= TOP5_AGREEMENT, f"top-5 agreement {frac:.4f}")

    with phase("kernel timing"):
        def kernel_line(name, replaces, kernel, plain, calls, shape):
            """Times summed over the kernel's calls in one forward of a
            batch; each call is (arguments, (n, T, d_in))."""
            ms = [cuda_ms(lambda a=a: kernel(*a)) for a, _ in calls]
            plain_ms = [cuda_ms(lambda a=a: plain(*a), reps=5) for a, _ in calls]
            costs = [fv_cost(n, t, PCA_DIMS, GMM_K, d_in=d_in) for _, (n, t, d_in) in calls]
            nbytes, flops = sum(c[0] for c in costs), sum(c[1] for c in costs)
            return {
                "name": name, "route": "cuda", "source": "keystone_tpu_torch/csrc/fisher.cu",
                "replaces": replaces, "launches": results[name]["launches"],
                "max_abs_err": errs[name], "ms": sum(ms), "plain_ms": sum(plain_ms),
                "bound_ms": sum(bound_ms(*c) for c in costs),
                "bound_by": "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES else "bytes",
                # no single PyTorch call computes a Fisher-vector encode
                "library_ms": None,
                "shape": shape, "ms_each_call": ms, "plain_ms_each_call": plain_ms,
            }

        lines = [
            kernel_line("fisher_encode", "keystone_tpu/ops/fisher_pallas.py:204",
                        fk.fisher_encode, fk.fisher_encode_ref,
                        [((fx, fmask, *gmm_b2), (BATCH, 784, 0))],
                        "(128, 784, 64) K=256, per batch"),
            kernel_line("fused_forward", "keystone_tpu/ops/fisher_pallas.py:265",
                        fk.fused_forward, fk.fused_forward_ref,
                        [(fused_args(fused_sift, sift_raw, sift_mask, fused_sift.mean), (BATCH, 784, 128)),
                         (fused_args(fused_lcs, lcs_desc, lcs_mask, fused_lcs.mean), (BATCH, 324, 96))],
                        "SIFT (128, 784, 128->64) + LCS (128, 324, 96->64) K=256, per batch"),
        ]
        for ln in lines:
            print(f"  {ln['name']}: {ln['ms']:.4f} ms (plain {ln['plain_ms']:.4f} ms, bound "
                  f"{ln['bound_ms']:.4f} ms by {ln['bound_by']}) per batch of {BATCH}, {card}")

    if args.profile:
        with phase("profile one scorer batch"):
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                scorer(images[:BATCH])
                torch.cuda.synchronize()
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))

    print(json.dumps({
        "images_per_s": {k: v["images_per_s"] for k, v in results.items()},
        "card": card,
    }))
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
