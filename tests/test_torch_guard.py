"""Guards on the port: it imports neither JAX nor the JAX package, its
entry points default to the card and refuse a box without one, and its
kernel wrappers take their plain versions only for CPU tensors."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import keystone_tpu_torch
from keystone_tpu_torch.convert import params_from_numpy
from keystone_tpu_torch.ops import fisher_kernels
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as port
from keystone_tpu_torch.utils.device import resolve_device

PKG = Path(keystone_tpu_torch.__file__).parent


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="keystone_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "keystone_tpu_torch.ops.fisher_kernels" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'keystone_tpu' or m.startswith('keystone_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(PKG.parent),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_names_jax_or_the_jax_package():
    pat = re.compile(r"jax|keystone_tpu\.")
    for f in sorted(PKG.rglob("*")):
        if f.suffix in (".py", ".cu", ".cuh") and "_build" not in f.parts:
            hits = [ln for ln in f.read_text().splitlines() if pat.search(ln)]
            assert not hits, (f, hits)


def _small_params():
    return port.random_params(pca_dims=16, gmm_k=8, num_classes=10, block_size=64)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the CPU-only refusal is not observable")
    raw = _small_params()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(raw)
    cpu = params_from_numpy(raw, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.build_scorer_from_params(cpu)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.build_forward(cpu)
    assert all(v.device.type == "cpu" for v in cpu.values())


def test_cpu_path_launches_no_kernel():
    fisher_kernels.reset_launches()
    scorer = port.build_scorer_from_params(
        params_from_numpy(_small_params(), device="cpu"), port.Config(sift_step=8, lcs_step=8),
        device="cpu",
    )
    imgs = np.random.default_rng(0).integers(0, 256, (2, 48, 48, 3), dtype=np.uint8)
    top = scorer(torch.from_numpy(imgs))
    assert top.shape == (2, 5)
    assert fisher_kernels.LAUNCHES == {"fisher_encode": 0, "fused_forward": 0}


def test_params_from_numpy_rejects_bad_input():
    raw = _small_params()
    with pytest.raises(ValueError, match="unknown"):
        params_from_numpy({**raw, "sift.pca.bogus": np.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy({**raw, "lcs.gmm.means": np.zeros((8, 15))}, device="cpu")
    bad = dict(raw)
    del bad["sift.gmm.variances"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(bad, device="cpu")
