"""The PCA fit's SVD by cuSOLVER driver, on the card: time and exactness.

    python -m keystone_tpu_torch.tools.svd_drivers

For each of ``torch.linalg.svd``'s CUDA drivers, on three tall f32
samples: the ImageNetSiftLcsFV fit's own PCA samples (``chip_smoke.py``'s
fit geometry: 2048 synthetic 128×128 images, 64 rows an image, SIFT
131 072 × 128 and LCS 131 072 × 96) and two made ones of the SIFT
sample's shape with set singular values, falling from 1 to 1e-6, and the
same with a gap of only 1% between the 64th and the 65th.  Prints each
driver's mean time over 3 calls and the largest error of its rank-64
projector C·Cᵀ against a float64 SVD of the same sample, then one JSON
line.  ``models/pca.py::svd_driver`` picks the driver from these readings.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

DRIVERS = (None, "gesvd", "gesvdj", "gesvda")
DIMS = 64


def _ms(fn, reps=3):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _made(rows, cols, sv, dev, seed):
    """A (rows, cols) f32 sample with singular values ``sv``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u, _ = torch.linalg.qr(torch.randn(rows, cols, generator=g, device=dev, dtype=torch.float64))
    v, _ = torch.linalg.qr(torch.randn(cols, cols, generator=g, device=dev, dtype=torch.float64))
    return ((u * torch.as_tensor(sv, device=dev)) @ v.T).float()


def _fit_samples(dev):
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P

    cfg = P.Config(num_classes=64, synthetic_n=2048, image_size=128, gmm_k=64, pca_dims=DIMS)
    images, _ = ImageNetLoader.synthetic_arrays(2048, 64, (128, 128), seed=1)
    rows = P.sample_descriptors(cfg, torch.from_numpy(images).to(dev), dev, 128)
    return {f"fit {b}": pca_rows for b, (pca_rows, _) in rows.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("svd_drivers: torch sees no CUDA device")
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    samples = _fit_samples(dev)
    falling = np.logspace(0, -6, 128)
    gap = falling.copy()
    gap[DIMS:] = gap[DIMS - 1] / 1.01 * np.logspace(0, -3, 128 - DIMS)
    samples["made, 1 to 1e-6"] = _made(131072, 128, falling, dev, 0)
    samples["made, 1% gap at 64"] = _made(131072, 128, gap, dev, 1)
    out = {"card": card}
    for name, x in samples.items():
        xc = x - x.mean(dim=0)
        v64 = torch.linalg.svd(xc.double(), full_matrices=False).Vh[:DIMS].T
        p64 = v64 @ v64.T
        out[name] = {}
        for drv in DRIVERS:
            vh = torch.linalg.svd(xc, full_matrices=False, driver=drv).Vh[:DIMS].double()
            err = (vh.T @ vh - p64).abs().max().item()
            ms = _ms(lambda drv=drv: torch.linalg.svd(xc, full_matrices=False, driver=drv))
            out[name][str(drv)] = {"ms": ms, "projector_err": err}
            print(f"{name} {tuple(x.shape)}: driver {drv}: {ms:.3f} ms, projector {err:.3e} from float64 ({card})",
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
