"""The solver product (``csrc/solver_gemm.cu``) on the card: the kernel
against its plain version (``err_limit``, entry by entry) at ragged
shapes, strided views and a long split of k, bit for bit across calls,
with planted faults (a dropped chunk of k, truncated operands) outside
that limit; ``KEYSTONE_SOLVER_PRECISION=default``
routing the solvers' products to it and ``float32`` keeping them cuBLAS's;
a scorer on one thread beside a fit under ``default`` on another, bit for
bit its output alone with no TF32 flag turned on; and a checkpointed BCD
under ``default`` resumed bit for bit.

Every test here needs an NVIDIA GPU and skips where torch sees none.  The
file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_solver_cuda.py --noconftest -q
"""

import threading

import numpy as np
import pytest
import torch

from keystone_tpu_torch import faults
from keystone_tpu_torch.convert import params_from_numpy
from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.ops import solver_kernels as sk
from keystone_tpu_torch.parallel import collectives
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.workflow.dataset import Dataset

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the solver kernel has no CPU mode")
    precision.disable_tf32()
    return torch.device("cuda")


@pytest.fixture
def under_default(monkeypatch):
    monkeypatch.setattr(precision, "_SOLVER_PRECISION", "default")


def _randn(dev, *shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dev)


_BOTH = ("a chunk dropped", "operands truncated")
#: (k, m, n, data, the planted faults the limit must catch): ragged tiles,
#: splits of k (131 072 and 2²⁰ rows), k = 1 and 0.  Over 2²⁰ signed terms
#: truncation's error is zero-mean noise, ~√k against the limit's depth·k,
#: so only same-signed sums (a Gramian's diagonal, the EM's posteriors)
#: show it there.
CARD_CASES = [(2048, 256, 256, "signed", _BOTH), (1000, 77, 45, "signed", _BOTH), (131072, 64, 64, "signed", _BOTH),
              (1 << 20, 8, 8, "signed", ("a chunk dropped",)), (1 << 20, 8, 8, "positive", _BOTH),
              (513, 65, 129, "signed", _BOTH), (1, 5, 7, "signed", _BOTH), (0, 5, 7, "signed", ())]


def case_operands(k, m, n, data, device="cpu"):
    """A case's (a, b): standard normal from seeds 1 and 2, or its magnitude."""
    a, b = (np.random.default_rng(s).standard_normal((k, c)).astype(np.float32) for s, c in ((1, m), (2, n)))
    if data == "positive":
        a, b = np.abs(a), np.abs(b)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def planted_faults(a, b):
    """What a broken kernel would return for ``aᵀ·b``: with its first
    chunk of k dropped (a split's partial, or the first k-stage where k is
    not split), and with the operands truncated to TF32 instead of
    rounded (``cvt.rna`` left out: the tensor core drops the low bits).
    None where k is 0."""
    m, n, k = a.shape[1], b.shape[1], a.shape[0]
    if k == 0:
        return {}
    splits, chunk = sk.split_plan(m, n, k)
    c = chunk if splits > 1 else sk.STAGE_ROWS
    ref = sk.tf32_matmul_ref(a, b)
    cut = lambda t: (t.view(torch.int32) & -0x2000).view(torch.float32).double()  # noqa: E731
    return {"a chunk dropped": ref - sk.tf32_matmul_ref(a[:c], b[:c]),
            "operands truncated": (cut(a).T @ cut(b)).to(torch.float32)}


def _held(a, b, catches=_BOTH):
    """The kernel's aᵀ·b against its plain version within ``err_limit``
    entry by entry, bit for bit across two calls; the planted faults
    ``catches`` outside the limit."""
    got, again = sk.tf32_matmul(a, b), sk.tf32_matmul(a, b)
    torch.cuda.synchronize()
    ref, lim = sk.tf32_matmul_ref(a, b).double(), sk.err_limit(a, b)
    err = (got.double() - ref).abs()
    assert bool((err <= lim).all()), (float(err.max()), float((err / lim).nan_to_num(0.0).max()))
    assert torch.equal(got, again)
    faults = planted_faults(a, b)
    for name in catches:
        assert not bool(((faults[name].double() - ref).abs() <= lim).all()), name
    return got


@pytest.mark.parametrize("k, m, n, data, catches", CARD_CASES)
def test_kernel_against_its_plain_version(dev, k, m, n, data, catches):
    """Ragged tiles, splits of k (131 072 and 2²⁰ rows), k = 1 and 0."""
    _held(*case_operands(k, m, n, data, dev), catches)


@pytest.mark.parametrize("form", ["columns of a wider matrix", "unaligned columns", "transposed view", "a @ b"])
def test_kernel_reads_views_in_place(dev, monkeypatch, form):
    big, other = _randn(dev, 2048, 200, seed=3), _randn(dev, 2048, 130, seed=4)
    if form == "columns of a wider matrix":
        _held(big[:, 64:128], other[:, :64])
    elif form == "unaligned columns":
        _held(big[:, 3:70], other[:, 1:30])
    elif form == "transposed view":
        _held(_randn(dev, 50, 600, seed=5).T, _randn(dev, 600, 30, seed=6))
    else:  # sdot's a·b: the kernel's aᵀ·b of the view a.T
        a, b = _randn(dev, 70, 333, seed=7), _randn(dev, 333, 90, seed=8)
        got = _held(a.T, b)
        monkeypatch.setattr(precision, "_SOLVER_PRECISION", "default")
        assert torch.equal(precision.sdot(a, b), got)


def test_the_setting_routes_the_solver_products(dev, monkeypatch):
    a, b = _randn(dev, 3000, 96, seed=9), _randn(dev, 3000, 16, seed=10)
    sk.reset_launches()
    assert torch.equal(collectives.local_matmul(a, b), a.T @ b)  # float32: cuBLAS, true f32
    assert sk.LAUNCHES["solver_gemm"] == 0
    monkeypatch.setattr(precision, "_SOLVER_PRECISION", "default")
    got = collectives.local_matmul(a, b)
    # 3000 rows in 5 chunks: the product and the split's sum, one launch each
    assert sk.LAUNCHES == {"solver_gemm": 1, "solver_reduce": 1} and sk.LAUNCH_SHAPES == {(96, 16, 3000): 1}
    assert torch.equal(got, sk.tf32_matmul(a, b))
    assert torch.equal(precision.sdot_t(a.double(), b.double()), a.double().T @ b.double())  # f64 stays f64
    assert sk.LAUNCHES == {"solver_gemm": 2, "solver_reduce": 2}
    sk.tf32_matmul(_randn(dev, 512, 8, seed=16), _randn(dev, 512, 8, seed=17))  # too short to split
    assert sk.LAUNCHES == {"solver_gemm": 3, "solver_reduce": 2}
    assert not torch.backends.cuda.matmul.allow_tf32


def test_scorer_beside_a_fit_under_default_is_unchanged(dev, under_default):
    """(d) at a small size: one thread scores one batch again and again
    while this one fits under default; no TF32 flag is turned on."""
    cfg = P.Config(num_classes=4, gmm_k=4, pca_dims=8, image_size=32)
    scorer = P.build_scorer_from_params(
        params_from_numpy(P.random_params(pca_dims=8, gmm_k=4, num_classes=4, seed=0), dev), cfg, dev)
    batch = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)).to(dev)
    alone = scorer(batch)
    x, y = _randn(dev, 512, 256, seed=12), torch.sign(_randn(dev, 512, 4, seed=13))
    done, seen = threading.Event(), {"rounds": 0, "differ": 0, "flags": set()}

    def serve():
        while not done.is_set() or seen["rounds"] < 4:
            seen["flags"].add(torch.backends.cuda.matmul.allow_tf32)
            seen["differ"] += int(not torch.equal(scorer(batch), alone))
            seen["rounds"] += 1

    th = threading.Thread(target=serve)
    th.start()
    sk.reset_launches()
    try:
        for _ in range(3):
            BlockWeightedLeastSquaresEstimator(block_size=64, num_iter=2, lam=1e-3).fit_arrays(x, y, device=dev)
    finally:
        done.set()
        th.join(timeout=60)
    assert sk.LAUNCHES["solver_gemm"] == 3 * 2 * 2 * 4
    assert seen["differ"] == 0 and seen["flags"] == {False}
    assert not torch.backends.cuda.matmul.allow_tf32


def test_checkpointed_bcd_under_default_resumes_bit_for_bit(dev, under_default, tmp_path):
    x = Dataset(_randn(dev, 512, 384, seed=14))
    lab = np.random.default_rng(15).integers(0, 8, 512)
    y = -np.ones((512, 8), np.float32)
    y[np.arange(512), lab] = 1.0
    y = Dataset(torch.from_numpy(y).to(dev))
    est = BlockLeastSquaresEstimator(block_size=128, num_iter=3, lam=1e-3)
    sk.reset_launches()
    ref = est.fit_checkpointed(x, y, str(tmp_path / "a"))
    assert sk.LAUNCHES["solver_gemm"] > 0
    with faults.inject("ckpt.save:after=1:times=3:raise"):
        with pytest.raises(faults.FaultInjected):
            est.fit_checkpointed(x, y, str(tmp_path / "b"))
    resumed = est.fit_checkpointed(x, y, str(tmp_path / "b"))
    assert torch.equal(resumed.weights, ref.weights) and torch.equal(resumed.intercept, ref.intercept)
