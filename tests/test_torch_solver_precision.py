"""``KEYSTONE_SOLVER_PRECISION`` in the port (``utils/precision.py``) and
its solver product (``ops/solver_kernels.py``) on the CPU, against the
JAX package: the variable's values and its refusal at import, the TF32
rounding of the kernel's plain version on chosen bit patterns, the split
of k, the dispatch by dtype and device, and, under ``default`` in both
packages (each module's ``_SOLVER_PRECISION`` patched), every solver
that reads the setting and the ImageNetSiftLcsFV fit against the
reference at the tolerances of their existing parity tests.  On the CPU
both packages' default precision is full f32, so ``default`` changes no
number here; the card's TF32 kernel is held to its plain version by
tests/test_torch_solver_cuda.py and ``chip_smoke.py``."""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from test_torch_dense_ops import ATOL_SOLVE, RTOL_SOLVE, _ls_data
from test_torch_fit import ATOL_BCD_REF, ATOL_MU, ATOL_VAR, ATOL_W, _anisotropic, _check_components, _em_setup
from test_torch_fit import _regression_data, _skewed_labels
from test_torch_fit_slice import FIELDS, TOP1_MARGIN
from test_torch_solver_cuda import CARD_CASES, case_operands, planted_faults
from test_torch_parallel import TOL_PROJECTOR_JAX
from test_torch_text_ops import _held, _ls_objective, _sparse_problem

from keystone_tpu.models import lbfgs as jlbfgs
from keystone_tpu.models import linear as jlin
from keystone_tpu.models.block_ls import BlockLeastSquaresEstimator as JBls
from keystone_tpu.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator as JBwls
from keystone_tpu.models.gmm import _em_steps as j_em_steps
from keystone_tpu.models.pca import DistributedPCAEstimator as JDPCA
from keystone_tpu.models.pca import _pca_masked as j_pca_masked
from keystone_tpu.models.zca import ZCAWhitenerEstimator as JZCA
from keystone_tpu.pipelines.imagenet_sift_lcs_fv import ImageNetSiftLcsFV as JApp
from keystone_tpu.utils import precision as jprecision
from keystone_tpu.workflow import Dataset as JDataset
from keystone_tpu_torch.analysis import precision as lint_precision
from keystone_tpu_torch.models import block_ls, block_weighted_ls, gmm, lbfgs, pca
from keystone_tpu_torch.models import linear as lin
from keystone_tpu_torch.models.zca import ZCAWhitenerEstimator
from keystone_tpu_torch.ops import solver_kernels as sk
from keystone_tpu_torch.parallel import collectives
from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV
from keystone_tpu_torch.tools import lint
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.workflow.dataset import Dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture
def under_default(monkeypatch):
    """Both packages under ``KEYSTONE_SOLVER_PRECISION=default``, as each
    reads it at import.  The reference reads its setting when it traces,
    so its compiled programs are dropped on the way in and out."""
    monkeypatch.setattr(jprecision, "_SOLVER_PRECISION", "default")
    monkeypatch.setattr(precision, "_SOLVER_PRECISION", "default")
    jax.clear_caches()
    assert jprecision.solver_precision() == lax.Precision.DEFAULT
    assert precision.solver_precision() == "tf32"
    yield
    jax.clear_caches()


# ---------------------------------------------------------------- the variable


_IMPORT_EACH = """
import importlib, os, sys
import {mod} as m
out = []
for v in sys.argv[1:]:
    os.environ.pop("KEYSTONE_SOLVER_PRECISION", None)
    if v != "unset":
        os.environ["KEYSTONE_SOLVER_PRECISION"] = v
    out.append(str(importlib.reload(m).solver_precision()))
print(",".join(out))
"""


def _import_each(mod, values):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("KEYSTONE_SOLVER_PRECISION", None)
    return subprocess.run([sys.executable, "-c", _IMPORT_EACH.format(mod=mod), *values], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)


def test_values_map_as_the_references():
    """Each value read at import, in both packages: ``default`` is the
    backend's default precision (TF32 on the card), ``float32`` and
    ``highest`` and the unset variable true f32."""
    values = ["unset", "default", "float32", "highest"]
    port = _import_each("keystone_tpu_torch.utils.precision", values)
    ref = _import_each("keystone_tpu.utils.precision", values)
    assert port.returncode == 0 and ref.returncode == 0, (port.stderr, ref.stderr)
    got, want = port.stdout.split()[-1].split(","), ref.stdout.split()[-1].split(",")
    assert got == ["f32", "tf32", "f32", "f32"]
    assert want == [str(lax.Precision.HIGHEST), str(lax.Precision.DEFAULT), str(lax.Precision.HIGHEST),
                    str(lax.Precision.HIGHEST)]


@pytest.mark.parametrize("mod", ["keystone_tpu_torch.utils.precision", "keystone_tpu.utils.precision"])
def test_a_bad_value_raises_at_import(mod):
    env = dict(os.environ, JAX_PLATFORMS="cpu", KEYSTONE_SOLVER_PRECISION="tf32")
    out = subprocess.run([sys.executable, "-c", f"import {mod}"], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode != 0
    assert "ValueError: KEYSTONE_SOLVER_PRECISION must be one of ('default', 'float32', 'highest')" in out.stderr


def test_the_variable_is_registered_and_never_planned():
    from keystone_tpu_torch.planner import registry

    assert "KEYSTONE_SOLVER_PRECISION" in registry.OPERATIONAL_ENV
    assert all(g.get("env") != "KEYSTONE_SOLVER_PRECISION" for g in registry.GATES.values())
    assert all(k.get("env") != "KEYSTONE_SOLVER_PRECISION" for k in registry.KNOBS.values())
    assert "KEYSTONE_SOLVER_PRECISION" in lint.load_gate_env()


def test_the_port_lints_clean_with_the_variable_read():
    path = os.path.join(REPO, "keystone_tpu_torch", "utils", "precision.py")
    assert "KEYSTONE_SOLVER_PRECISION" in open(path).read()
    assert lint.lint_paths([path]) == []


# ---------------------------------------------------------------- TF32 rounding


def _tf32_bits(u: int) -> int:
    """A float32 bit pattern rounded to TF32, bit by bit: NaN stays (any
    NaN); otherwise the 23-bit mantissa keeps 10 bits, rounded to nearest
    with ties away from zero, a carry running into the exponent."""
    sign, mag = u & 0x80000000, u & 0x7FFFFFFF
    if mag > 0x7F800000:
        return u
    kept, dropped = mag >> 13, mag & 0x1FFF
    if dropped >= 0x1000:
        kept += 1
    return sign | (kept << 13)


_PATTERNS = {
    "one": 0x3F800000,
    "below half an ulp": 0x3F800FFF,
    "a tie, even kept bit": 0x3F801000,
    "a tie, odd kept bit": 0x3F803000,
    "above a tie": 0x3F801001,
    "negative tie": 0xBF801000,
    "carry into the exponent": 0x3FFFF000,
    "largest finite to inf": 0x7F7FF000,
    "largest finite": 0x7F7FFFFF,
    "below the overflow tie": 0x7F7FEFFF,
    "smallest subnormal": 0x00000001,
    "subnormal tie": 0x00001000,
    "subnormal to the smallest normal": 0x007FF000,
    "largest subnormal": 0x007FFFFF,
    "negative subnormal": 0x80001800,
    "zero": 0x00000000,
    "negative zero": 0x80000000,
    "inf": 0x7F800000,
    "negative inf": 0xFF800000,
    "quiet NaN": 0x7FC00000,
    "NaN with a low payload": 0x7F800001,
    "negative NaN": 0xFFFFFFFF,
}


@pytest.mark.parametrize("name", list(_PATTERNS))
def test_tf32_rounding_on_bit_patterns(name):
    u = _PATTERNS[name]
    x = torch.from_numpy(np.array([u], dtype=np.uint32).view(np.float32))
    got = sk.tf32_round(x)
    want = np.array([_tf32_bits(u)], dtype=np.uint32).view(np.float32)
    if np.isnan(want[0]):
        assert torch.isnan(got).all()
    else:
        assert got.numpy().view(np.uint32)[0] == want.view(np.uint32)[0], (hex(u), got)


def test_tf32_rounding_of_random_values():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 1e3)
    got = sk.tf32_round(x)
    bits = got.numpy().view(np.uint32)
    assert (bits & 0x1FFF == 0).all()
    assert ((got - x).abs() <= 2.0 ** -11 * x.abs()).all()
    want = np.array([_tf32_bits(int(u)) for u in x.numpy().view(np.uint32)], dtype=np.uint32)
    assert (bits == want).all()
    with pytest.raises(TypeError):
        sk.tf32_round(x.double())


def test_plain_version_rounds_each_operand():
    """``aᵀb`` and ``ab`` of the rounded operands, in float64 and then f32."""
    a = torch.tensor([[1.0 + 2.0 ** -11, 3.0], [2.0, 1.0 + 2.0 ** -12]])
    b = torch.tensor([[1.0], [1.0]])
    assert sk.tf32_matmul_ref(a, b).tolist() == [[1.0 + 2.0 ** -10 + 2.0], [4.0]]
    assert sk.tf32_matmul_ref(a.T, b).tolist() == [[4.0 + 2.0 ** -10], [3.0]]  # a·b: the view aᵀ
    x, y = np.random.default_rng(1).standard_normal((2, 50, 7)).astype(np.float32)
    r64 = np.asarray(sk.tf32_round(_t(x)[0]), np.float64)
    want = (r64.T @ np.asarray(sk.tf32_round(_t(y)[0]), np.float64)).astype(np.float32)
    assert np.array_equal(sk.tf32_matmul(*_t(x, y)).numpy(), want)


# ---------------------------------------------------------------- split of k


@pytest.mark.parametrize("shape, want", [
    ((4096, 4096, 2048), (1, 2048)),  # the weighted BCD's Gramian: 4096 tiles fill the card
    ((4096, 64, 2048), (4, 512)),  # its Aᵀ·target
    ((64, 64, 131072), (256, 512)),  # the EM's statistics over the GMM sample
    ((128, 128, 131072), (66, 2016)),  # the masked PCA's covariance
    ((64, 64, 512), (1, 512)),  # too short to split
    ((5, 7, 0), (1, 0)),
])
def test_split_plan_at_the_main_paths_shapes(shape, want):
    assert sk.split_plan(*shape) == want


def test_split_plan_covers_k_in_stage_multiples():
    rng = np.random.default_rng(2)
    for m, n, k in rng.integers(1, 1 << 14, size=(300, 3)).tolist() + [[8, 8, 1 << 30], [1, 1, 1 << 20]]:
        splits, chunk = sk.split_plan(m, n, k)
        assert 1 <= splits <= 65535
        if splits > 1:
            assert chunk % sk.STAGE_ROWS == 0 and chunk >= sk.MIN_CHUNK
            assert (splits - 1) * chunk < k <= splits * chunk


@pytest.mark.parametrize("shape, depth", [
    ((4096, 4096, 2048), 1 + 64 + 64),  # one chunk of 64 k-stages
    ((4096, 64, 2048), 1 + 64 + 16 + 1 + 7),  # 4 chunks of 16 stages
    ((64, 64, 131072), 1 + 64 + 16 + 32 + 7),  # 256 chunks: 32 partials a thread of the sum
    ((8, 8, 1 << 20), 1 + 64 + 125 + 33 + 7),
    ((5, 7, 1), 1 + 64 + 1),
    ((5, 7, 0), 1 + 64),
])
def test_sum_depth_follows_the_kernels_order_of_additions(shape, depth):
    assert sk.sum_depth(*shape) == depth


@pytest.mark.parametrize("k, m, n, data, catches", CARD_CASES)
def test_the_limit_catches_planted_faults_at_the_card_tests_shapes(k, m, n, data, catches):
    """A dropped chunk (or k-stage) and operands truncated instead of
    rounded each put some entry outside ``err_limit`` of the plain version
    at the card test's cases, as that test requires of them."""
    a, b = case_operands(k, m, n, data)
    ref, lim = sk.tf32_matmul_ref(a, b).double(), sk.err_limit(a, b)
    assert lim.shape == (m, n) and bool((lim >= 0).all())
    faults = planted_faults(a, b)
    assert set(faults) == (set() if k == 0 else {"a chunk dropped", "operands truncated"})
    for name in catches:
        assert not bool(((faults[name].double() - ref).abs() <= lim).all()), name


# ---------------------------------------------------------------- dispatch


def _fake(is_cuda=True, dtype=torch.float32):
    """An operand as the dispatch sees it (its device and dtype); its
    transpose is itself."""
    t = types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype)
    t.T = t
    return t


@pytest.mark.parametrize("setting, operands, kernel", [
    ("default", (_fake(), _fake()), True),
    ("default", (_fake(dtype=torch.float64), _fake(dtype=torch.float64)), False),
    ("default", (_fake(False), _fake(False)), False),
    ("float32", (_fake(), _fake()), False),
    ("highest", (_fake(), _fake()), False),
])
def test_the_route_is_decided_by_setting_dtype_and_device(monkeypatch, setting, operands, kernel):
    monkeypatch.setattr(precision, "_SOLVER_PRECISION", setting)
    calls = []
    monkeypatch.setattr(sk, "tf32_matmul", lambda a, b: calls.append((a, b)) or "kernel")
    assert precision._tf32_product(*operands) is kernel
    if kernel:
        assert precision.sdot_t(*operands) == "kernel" and precision.sdot(*operands) == "kernel"
        assert calls == [operands, operands]


@pytest.mark.parametrize("setting", ["default", "float32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_products_are_plain_under_either_setting(monkeypatch, setting, dtype):
    monkeypatch.setattr(precision, "_SOLVER_PRECISION", setting)
    a, b = (torch.from_numpy(v).to(dtype) for v in np.random.default_rng(3).standard_normal((2, 40, 9)))
    assert torch.equal(precision.sdot_t(a, b), a.T @ b)
    assert torch.equal(precision.sdot(a.T, b), a.T @ b)
    assert torch.equal(collectives.local_matmul(a, b), a.T @ b)
    assert collectives.local_matmul(a, b).dtype == dtype


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.zeros(4, 3)
    with pytest.raises(TypeError):
        sk.tf32_matmul(a.double(), a.double())
    with pytest.raises(ValueError):
        sk.tf32_matmul(a, torch.zeros(5, 2))
    with pytest.raises(ValueError):  # no device but the card and the CPU, and no fallback
        sk.tf32_matmul(a.to("meta"), a.to("meta"))


# ---------------------------------------------------------------- parity under default


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_linear_map_estimator_under_default(under_default, fit_intercept):
    """In memory and streamed (``models/common.py::gram``'s blocks)."""
    x, y = _ls_data()
    est = lin.LinearMapEstimator(lam=1e-2, fit_intercept=fit_intercept)
    jest = jlin.LinearMapEstimator(lam=1e-2, fit_intercept=fit_intercept)
    got, want = est.fit_arrays(x, y, device="cpu"), jest.fit_arrays(x, y)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), atol=ATOL_SOLVE, rtol=RTOL_SOLVE)
    batches = [(x[i:i + 64], y[i:i + 64]) for i in range(0, len(x), 64)]
    streamed = est.fit_stream(lambda: (tuple(_t(a, b)) for a, b in batches))
    np.testing.assert_allclose(streamed.weights.numpy(), np.asarray(jest.fit_stream(batches).weights),
                               atol=ATOL_SOLVE, rtol=RTOL_SOLVE)
    if fit_intercept:
        np.testing.assert_allclose(got.intercept.numpy(), np.asarray(want.intercept), atol=ATOL_SOLVE,
                                   rtol=RTOL_SOLVE)


def test_block_ls_under_default(under_default):
    x, y = _regression_data()
    model = block_ls.BlockLeastSquaresEstimator(block_size=5, num_iter=40, lam=0.1).fit_arrays(x, y, device="cpu")
    ref = JBls(block_size=5, num_iter=40, lam=0.1).fit_arrays(x, y)
    np.testing.assert_allclose(model.weights.numpy(), np.asarray(ref.weights), atol=ATOL_BCD_REF)
    np.testing.assert_allclose(model.intercept.numpy(), np.asarray(ref.intercept), atol=ATOL_BCD_REF)


def test_block_weighted_ls_under_default(under_default):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    _, y = _skewed_labels(rng, 64, 3)
    kw = dict(block_size=8, num_iter=30, lam=0.05, mixture_weight=0.5)
    model = block_weighted_ls.BlockWeightedLeastSquaresEstimator(**kw).fit_arrays(x, y, device="cpu")
    ref = JBwls(**kw).fit_arrays(x, y)
    np.testing.assert_allclose(model.weights.numpy(), np.asarray(ref.weights), atol=ATOL_BCD_REF)
    np.testing.assert_allclose(model.intercept.numpy(), np.asarray(ref.intercept), atol=ATOL_BCD_REF)


@pytest.mark.parametrize("center", [True, False])
def test_masked_pca_under_default(under_default, center):
    rng = np.random.default_rng(1)
    x = _anisotropic(rng, 8 * 40, 16).reshape(8, 40, 16)
    mask = (rng.random((8, 40)) < 0.7).astype(np.float32)
    comp, mean = pca._pca_masked(*_t(x, mask), 6, center)
    j_comp, j_mean = j_pca_masked(jnp.asarray(x), jnp.asarray(mask), 6, center)
    _check_components(comp.numpy(), np.asarray(j_comp))
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), atol=1e-5)


def test_distributed_pca_under_default(under_default):
    rng = np.random.default_rng(3)
    base = rng.normal(size=(200, 6)).astype(np.float32)
    base[:, 2:] *= 0.05
    x = (base @ np.linalg.qr(rng.normal(size=(6, 6)))[0].T).astype(np.float32)
    jc = np.asarray(JDPCA(2).fit_dataset(JDataset(x)).components)
    c = pca.DistributedPCAEstimator(2).fit_dataset(Dataset(x, device="cpu")).components.numpy()
    np.testing.assert_allclose(c @ c.T, jc @ jc.T, atol=TOL_PROJECTOR_JAX)


def test_zca_under_default(under_default):
    x = (np.random.default_rng(9).random((500, 27)) * np.linspace(0.5, 3.0, 27)).astype(np.float32)
    got, want = ZCAWhitenerEstimator(eps=0.1).fit_dataset(Dataset(x, device="cpu")), JZCA(eps=0.1).fit_arrays(x)
    np.testing.assert_allclose(got.whitener.numpy(), np.asarray(want.whitener), atol=ATOL_SOLVE, rtol=RTOL_SOLVE)


@pytest.mark.parametrize("masked", [False, True])
def test_em_steps_under_default(under_default, masked):
    x, w0, mu0, var0 = _em_setup()
    row_ok = np.ones(x.shape[0], np.float32)
    if masked:
        row_ok[150:] = 0.0
    n = float(row_ok.sum())
    got = gmm._em_steps(*_t(x), n, *_t(row_ok, w0, mu0, var0), 10, 1e-6)
    want = j_em_steps(jnp.asarray(x), jnp.float32(n), *(jnp.asarray(a) for a in (row_ok, w0, mu0, var0)), 10, 1e-6)
    for g, w, atol in zip(got, want, (ATOL_W, ATOL_MU, ATOL_VAR)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def test_dense_lbfgs_under_default(under_default):
    _, _, dense, y = _sparse_problem(1)
    m = lbfgs.DenseLBFGSwithL2(lam=1e-2, num_iterations=80).fit_arrays(dense, y, device="cpu")
    jm = jlbfgs.DenseLBFGSwithL2(lam=1e-2, num_iterations=80).fit_arrays(dense, y)
    _held("dense", dense, m.weights.numpy(), None, np.asarray(jm.weights), None,
          lambda w_, b_: _ls_objective(dense, y, w_, b_, 1e-2))


def test_flagship_run_under_default(under_default):
    """ImageNetSiftLcsFV.run at the reference test's config, both packages
    under ``default``: the held-out top-1 error within the slice's margin."""
    got = ImageNetSiftLcsFV.run(Config(**FIELDS), device="cpu")
    want = JApp.run(JApp.Config(**FIELDS))
    assert got["accuracy"] > 0.5, got
    assert abs(got["top1_error"] - want["top1_error"]) <= TOP1_MARGIN, (got, want)


def test_the_solver_precision_lint_stays_clean_under_default(under_default):
    """The port's pass over its solver entries (``analysis/precision.py``):
    the setting dispatches no narrowed contraction and turns no global
    TF32 flag on."""
    assert lint_precision.run() == []
    assert not torch.backends.cuda.matmul.allow_tf32
