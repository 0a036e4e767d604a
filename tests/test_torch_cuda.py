"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips where torch sees none.  The
file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.models.gmm import GaussianMixtureModel
from keystone_tpu_torch.models.pca import PCATransformer
from keystone_tpu_torch.ops import fisher_kernels as fk
from keystone_tpu_torch.ops import gram_kernels as gk
from keystone_tpu_torch.ops.fisher import FisherVector, FusedPcaFisherVector

pytestmark = pytest.mark.cuda

# the JAX package's tolerances for its Pallas kernels, plus a relative
# term: the kernel sums in another order than cuBLAS, ~1e-6 relative f32
# rounding on the larger FV entries (chip_smoke.py states the same)
ATOL_FV, ATOL_FUSED, RTOL = 2e-5, 3e-5, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _gmm(rng, k, d, dev):
    w = rng.random(k).astype(np.float32) + 0.1
    w /= w.sum()
    mu = rng.normal(size=(k, d)).astype(np.float32)
    var = (0.5 + rng.random((k, d))).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (w, mu, var)]


def _mask(rng, n, t, dev):
    m = (rng.random((n, t)) > 0.15).astype(np.float32)
    m[0] = 0.0  # an image with no valid descriptor
    return torch.from_numpy(m).to(dev)


# T off the 32-row tile and off the m16 / k8 tiling of the tensor-core
# products (1, 7, 15, 17, 33: a tail of 1, 7, 15, 17 and 1 rows)
RAGGED_T = [1, 7, 15, 17, 33, 45, 301]


# Held against the plain chain evaluated in float64: at small T the FV
# entries grow (1/T), and the kernel (3xTF32, its constant in two parts)
# and the plain f32 chain round them differently by up to ~3e-5 there,
# while the kernel stays within the tolerance of the float64 chain
# (chip_smoke.py's float64 phase measures both chains' errors)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [784, *RAGGED_T])
def test_fisher_encode_matches_plain(dev, dtype, t):
    rng = np.random.default_rng(t)
    xs = torch.from_numpy(rng.normal(size=(6, t, 64)).astype(np.float32)).to(dev).to(dtype)
    mask = _mask(rng, 6, t, dev)
    w, mu, var = _gmm(rng, 256, 64, dev)
    fk.reset_launches()
    got = fk.fisher_encode(xs, mask, w, mu, var)
    assert fk.LAUNCHES["fisher_encode"] == 1
    torch.testing.assert_close(got.double(), _fv64(xs, mask, w, mu, var), atol=ATOL_FV, rtol=RTOL)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("with_mean", [True, False])
@pytest.mark.parametrize("d_in,t", [(128, 784), (96, 324), (128, 45), (128, 301), (96, 1), (128, 7),
                                     (96, 15), (128, 17), (96, 33)])
def test_fused_forward_matches_plain(dev, normalize, with_mean, d_in, t):
    rng = np.random.default_rng(d_in + t)
    args = _fused_args(rng, 5, t, d_in, 64, 256, dev, normalize, with_mean)
    fk.reset_launches()
    got = fk.fused_forward(*args)
    assert fk.LAUNCHES["fused_forward"] == 1
    torch.testing.assert_close(got, fk.fused_forward_ref(*args), atol=ATOL_FUSED, rtol=RTOL)


def _fused_args(rng, n, t, d_in, d, k, dev, normalize=True, with_mean=True):
    """Raw descriptors (normalized already where ``normalize`` is False),
    an orthonormal projection, a small mean and a GMM: fused_forward's
    arguments."""
    raw = np.abs(rng.normal(size=(n, t, d_in))).astype(np.float32)
    if not normalize:  # the feed is normalized already
        raw /= np.linalg.norm(raw, axis=-1, keepdims=True)
    desc = torch.from_numpy(raw).to(dev)
    mask = _mask(rng, n, t, dev)
    comp = torch.from_numpy(np.linalg.qr(rng.normal(size=(d_in, d)))[0].astype(np.float32)).to(dev)
    mean = torch.from_numpy((0.05 * rng.random(d_in)).astype(np.float32)).to(dev) if with_mean else None
    w, mu, var = _gmm(rng, k, d, dev)
    return desc, mask, comp, mean, w, 0.3 * mu, var, normalize


@pytest.mark.parametrize("t", [324, 17])
def test_fused_forward_bf16_stream(dev, t):
    """bf16 raw descriptors: within the f32 tolerance of the plain chain on
    the same bf16 values (both widen them to f32)."""
    rng = np.random.default_rng(5 + t)
    desc, *rest = _fused_args(rng, 5, t, 128, 64, 256, dev)
    args = (desc.bfloat16(), *rest)
    torch.testing.assert_close(fk.fused_forward(*args), fk.fused_forward_ref(*args), atol=ATOL_FUSED, rtol=RTOL)


def test_small_gmm_shapes(dev):
    """K and d other than the main path's (multiples of 8), and T shorter
    than one tile."""
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.normal(size=(3, 20, 16)).astype(np.float32)).to(dev)
    mask = _mask(rng, 3, 20, dev)
    w, mu, var = _gmm(rng, 8, 16, dev)
    torch.testing.assert_close(
        fk.fisher_encode(xs, mask, w, mu, var), fk.fisher_encode_ref(xs, mask, w, mu, var),
        atol=ATOL_FV, rtol=RTOL,
    )


# K and d other than the main path's: fewer n8 or m16 tiles than warps
# (K = 8, 24), d = 128 (a tile of 16 rows in the fused kernel, d_in = d),
# and the edge of the register budget, (d/8)(K/8) = 255 or 256 statistics
# fragments (K = 2048, d = 8: a tile of 8 rows; K = 680, d = 24: fused, 24)
@pytest.mark.parametrize("k,d", [(8, 16), (24, 8), (128, 128), (2048, 8), (680, 24)])
@pytest.mark.parametrize("t", [17, 301])
def test_other_gmm_shapes(dev, k, d, t):
    rng = np.random.default_rng(k + d + t)
    xs = torch.from_numpy(rng.normal(size=(3, t, d)).astype(np.float32)).to(dev)
    mask = _mask(rng, 3, t, dev)
    w, mu, var = _gmm(rng, k, d, dev)
    got = fk.fisher_encode(xs, mask, w, mu, var)
    torch.testing.assert_close(got.double(), _fv64(xs, mask, w, mu, var), atol=ATOL_FV, rtol=RTOL)
    args = _fused_args(rng, 3, t, d, d, k, dev)
    torch.testing.assert_close(fk.fused_forward(*args).double(), _fused64(*args), atol=ATOL_FUSED, rtol=RTOL)


def _fv64(xs, mask, w, mu, var):
    """fisher_encode_ref's chain in float64 on the same operands."""
    from keystone_tpu_torch.models.gmm import _log_gaussians

    xs, mask, w, mu, var = (a.double() for a in (xs, mask, w, mu, var))
    n, t, d = xs.shape
    lg = _log_gaussians(xs.reshape(n * t, d), mu, var, torch.log(w))
    gamma = torch.softmax(lg, dim=1).reshape(n, t, -1) * mask[..., None]
    tn = torch.clamp(mask.sum(dim=1), min=1.0)[:, None, None]
    s0 = gamma.sum(dim=1)[..., None]
    s1 = torch.einsum("ntk,ntd->nkd", gamma, xs)
    s2 = torch.einsum("ntk,ntd->nkd", gamma, xs * xs)
    phi1 = (s1 - s0 * mu) / torch.sqrt(var) / (tn * torch.sqrt(w)[None, :, None])
    phi2 = ((s2 - 2 * mu * s1 + s0 * mu * mu) / var - s0) / (tn * torch.sqrt(2 * w)[None, :, None])
    return torch.cat([phi1.reshape(n, -1), phi2.reshape(n, -1)], dim=1)


def _fused64(desc, mask, comp, mean, w, mu, var, normalize):
    """fused_forward_ref's chain in float64 on the same operands."""
    z = desc.double()
    if normalize:
        z = fk._sift_normalize(z)
    if mean is not None:
        z = z - mean.double()
    return _fv64(z @ comp.double(), mask, w, mu, var)


def _fitted_like(rng, n, t, k, d, dev):
    """A GMM whose variances fall as a PCA's do (1e-1 to 1e-4 over the
    dims), as a fitted vocabulary's, and descriptors at three times its
    spread around its means, as real ones sit further from a fitted
    vocabulary than its own draws: FV entries reach ~10 and the log
    posterior and Φ² cancel large terms (the plain f32 chain is ~1e-4
    from float64, as on the fit's own GMM)."""
    w = rng.random(k).astype(np.float32) + 0.1
    w /= w.sum()
    sd = np.sqrt(np.logspace(-1, -4, d))
    var = (sd[None, :] ** 2 * (0.5 + rng.random((k, d)))).astype(np.float32)
    mu = (0.3 * rng.normal(size=(k, d)) * sd).astype(np.float32)
    comp = rng.integers(0, k, (n, t))
    xs = (mu[comp] + 3.0 * np.sqrt(var[comp]) * rng.normal(size=(n, t, d))).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (xs, w, mu, var)]


@pytest.mark.parametrize("kind", ["encode", "fused", "encode_fitted_gmm", "encode_general", "fused_general"])
def test_fv_kernels_are_f32_grade(dev, kind):
    """3xTF32 on the tensor cores against a float64 FV chain of the same
    operands: within 2x the plain f32 chain's (TF32 off) largest error,
    where one-pass TF32 is not."""
    rng = np.random.default_rng(13)
    if kind == "encode_fitted_gmm":
        xs, w, mu, var = _fitted_like(rng, 16, 361, 64, 64, dev)
        args = (xs, _mask(rng, 16, 361, dev), w, mu, var)
        kern, plain, exact = fk.fisher_encode, fk.fisher_encode_ref, _fv64(*args)
    elif kind in ("encode", "encode_general"):  # K = 512: the general path
        xs = torch.from_numpy(rng.normal(size=(16, 784, 64)).astype(np.float32)).to(dev)
        mask = _mask(rng, 16, 784, dev)
        args = (xs, mask, *_gmm(rng, 512 if kind == "encode_general" else 256, 64, dev))
        kern, plain, exact = fk.fisher_encode, fk.fisher_encode_ref, _fv64(*args)
    elif kind == "fused_general":  # d_in = 130: the general path
        args = _fused_args(rng, 16, 784, 130, 64, 256, dev)
        kern, plain, exact = fk.fused_forward, fk.fused_forward_ref, _fused64(*args)
    else:
        args = _fused_args(rng, 16, 784, 128, 64, 256, dev)
        kern, plain, exact = fk.fused_forward, fk.fused_forward_ref, _fused64(*args)
    err = (kern(*args).double() - exact).abs().max().item()
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        err_f32 = (plain(*args).double() - exact).abs().max().item()
        torch.backends.cuda.matmul.allow_tf32 = True
        err_tf32 = (plain(*args).double() - exact).abs().max().item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert err <= 2 * err_f32, (err, err_f32)
    assert err_tf32 > 2 * err_f32, (err_tf32, err_f32)


def test_fv_misaligned_inputs(dev):
    """Descriptors and a projection whose data do not start 16-byte aligned
    (the kernels read rows 16 bytes at a time; the wrappers copy them)."""
    rng = np.random.default_rng(9)
    xs = _at_offset(torch.from_numpy(rng.normal(size=(3, 33, 64)).astype(np.float32)).to(dev), 1)
    mask = _mask(rng, 3, 33, dev)
    w, mu, var = _gmm(rng, 256, 64, dev)
    torch.testing.assert_close(fk.fisher_encode(xs, mask, w, mu, var), fk.fisher_encode_ref(xs, mask, w, mu, var),
                               atol=ATOL_FV, rtol=RTOL)
    desc, mask, comp, mean, *rest = _fused_args(rng, 3, 33, 96, 64, 256, dev)
    args = (_at_offset(desc.bfloat16(), 1), mask, _at_offset(comp, 1), mean, *rest)
    torch.testing.assert_close(fk.fused_forward(*args), fk.fused_forward_ref(*args), atol=ATOL_FUSED, rtol=RTOL)


def test_wrappers_raise_instead_of_falling_back(dev):
    rng = np.random.default_rng(2)
    fk.reset_launches()
    xs = torch.from_numpy(rng.normal(size=(2, 40, 12)).astype(np.float32)).to(dev)
    mask = torch.ones((2, 40), device=dev)
    w, mu, var = _gmm(rng, 0, 12, dev)  # K = 0: a GMM no kernel takes
    with pytest.raises(RuntimeError, match="shape not supported"):
        fk.fisher_encode(xs, mask, w, mu, var)
    w, mu, var = _gmm(rng, 8, 16, dev)
    xs = torch.from_numpy(rng.normal(size=(2, 40, 32)).astype(np.float32)).to(dev)
    with pytest.raises(ValueError, match="on cpu"):
        fk.fisher_encode(xs[..., :16].contiguous(), mask.cpu(), w, mu, var)
    with pytest.raises(ValueError, match="contiguous"):
        fk.fisher_encode(xs[..., :16], mask, w, mu, var)
    with pytest.raises(TypeError, match="dtype"):
        fk.fisher_encode(xs[..., :16].contiguous().half(), mask, w, mu, var)
    assert not any(fk.LAUNCHES.values()), fk.LAUNCHES


def test_tiled_kernel_takes_the_main_paths_shapes(dev):
    """The scorer's (K = 256) and the fit's (K = 64) shapes take the tiled
    kernels; K·d over the statistics fragments and d off the 8-tiling take
    the general path."""
    for d_in in (0, 128, 96):
        for k in (256, 64):
            assert fk.tiled(64, k, d_in), (k, d_in)
    for d, k, d_in in ((64, 512, 0), (60, 64, 0), (64, 60, 0), (64, 64, 130), (64, 256, 512)):
        assert not fk.tiled(d, k, d_in), (d, k, d_in)


# GMM shapes the tiled kernels refuse (see test_tiled_kernel_takes_the_main_paths_shapes)
GENERAL_SHAPES = [(512, 64, 128), (64, 60, 128), (60, 64, 96), (64, 64, 130), (256, 64, 512)]


@pytest.mark.parametrize("k,d,d_in", GENERAL_SHAPES)
@pytest.mark.parametrize("t", [301, 7])
def test_transformers_launch_the_general_path_where_the_tile_does_not_fit(dev, k, d, d_in, t):
    """A GMM shape the reference's Pallas kernels encode and the tiled
    kernels refuse: with use_kernel=None the transformers launch the
    general path on the card (the encode too where (K, d) alone is
    refused), held against the plain chain in float64 at the kernels'
    tolerances, and against the plain f32 chain at T = 301 (at T = 7 the
    two f32 chains differ by up to ~8e-5 at K = 512)."""
    rng = np.random.default_rng(k + d + d_in + t)
    xs = torch.from_numpy(rng.normal(size=(4, t, d)).astype(np.float32)).to(dev)
    mask = _mask(rng, 4, t, dev)
    gmm = GaussianMixtureModel(*_gmm(rng, k, d, dev))
    gm = (gmm.weights, gmm.means, gmm.variances)
    fk.reset_launches()
    got = FisherVector(gmm).apply_batch(xs, mask)
    enc = "fisher_encode" if fk.tiled(d, k) else "fisher_encode_general"
    assert fk.LAUNCHES == {**dict.fromkeys(fk.LAUNCHES, 0), enc: 1}
    torch.testing.assert_close(got.double(), _fv64(xs, mask, *gm), atol=ATOL_FV, rtol=RTOL)
    if t > 7:
        torch.testing.assert_close(got, FisherVector(gmm, use_kernel=False).apply_batch(xs, mask), atol=ATOL_FV,
                                   rtol=RTOL)
    xb = xs.bfloat16()  # the bf16 stream on the same path
    torch.testing.assert_close(fk.fisher_encode(xb, mask, *gm).double(), _fv64(xb, mask, *gm), atol=ATOL_FV,
                               rtol=RTOL)
    desc, mask, comp, mean, *_ = _fused_args(rng, 4, t, d_in, d, k, dev)
    fused = FusedPcaFisherVector(PCATransformer(comp, mean), gmm, sift_normalize=True)
    plain = FusedPcaFisherVector(PCATransformer(comp, mean), gmm, sift_normalize=True, use_kernel=False)
    fk.reset_launches()
    got = fused.apply_batch(desc, mask)
    assert fk.LAUNCHES == {**dict.fromkeys(fk.LAUNCHES, 0), "fused_forward_general": 1}
    torch.testing.assert_close(got.double(), _fused64(desc, mask, comp, mean, *gm, True), atol=ATOL_FUSED, rtol=RTOL)
    if t > 7:
        torch.testing.assert_close(got, plain.apply_batch(desc, mask), atol=ATOL_FUSED, rtol=RTOL)


def test_transformers_launch_the_kernel_where_it_takes_the_shape(dev):
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.normal(size=(4, 96, 64)).astype(np.float32)).to(dev)
    mask = _mask(rng, 4, 96, dev)
    gmm = GaussianMixtureModel(*_gmm(rng, 64, 64, dev))  # the fit's K = 64
    fk.reset_launches()
    got = FisherVector(gmm).apply_batch(xs, mask)
    assert fk.LAUNCHES == {"fisher_encode": 1, "fused_forward": 0, "fisher_encode_general": 0,
                           "fused_forward_general": 0}
    torch.testing.assert_close(got, FisherVector(gmm, use_kernel=False).apply_batch(xs, mask), atol=ATOL_FV,
                               rtol=RTOL)


# gram kernels: the JAX package's tolerances (tests/test_gram_pallas.py):
# Gaussian 1e-5 absolute, polynomial 1e-5 absolute + 1e-5 relative, the
# bf16 operand stream 0.06 against the f32 plain version
ATOL_GRAM, RTOL_POLY, ATOL_BF16 = 1e-5, 1e-5, 0.06


def _at_offset(t, offset):
    """``t`` as a contiguous tensor whose data starts ``offset`` elements
    into a fresh buffer: offset 1 of f32 or bf16 is not 16-byte aligned."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _xz(rng, n, m, d, dev, scale=1.0, offset=0):
    x = (scale * rng.normal(size=(n, d))).astype(np.float32)
    z = (scale * rng.normal(size=(m, d))).astype(np.float32)
    return _at_offset(torch.from_numpy(x).to(dev), offset), torch.from_numpy(z).to(dev)


# d = 1, 13, 37: not a multiple of 4 (one-element copies); 440, 3072: the
# main paths' widths, 14 and 96 chunks of the ring; offset 1: x's base is
# not 16-byte aligned, so even d = 256 takes one-element copies; n and m
# off the 128-row tile
GRAM_SHAPES = [(512, 512, 256, 0), (1000, 777, 37, 0), (5, 3, 1, 0), (130, 129, 440, 0),
               (300, 200, 13, 0), (257, 131, 256, 1), (640, 384, 3072, 0), (129, 300, 37, 1)]


@pytest.mark.parametrize("n,m,d,offset", GRAM_SHAPES)
def test_gram_block_matches_plain(dev, n, m, d, offset):
    rng = np.random.default_rng(n + m + d)
    x, z = _xz(rng, n, m, d, dev, offset=offset)
    gamma = 1.0 / d
    gk.reset_launches()
    got = gk.gram_block_kernel(x, z, gamma)
    assert gk.LAUNCHES["gram_block"] == 1
    torch.testing.assert_close(got, gk.gram_block_ref(x, z, gamma), atol=ATOL_GRAM, rtol=0)


# the bf16 stream through the bf16 mma pass, both epilogues: held at 1e-5
# (+ 1e-5 relative for the polynomial) against the plain version on the
# same bf16 operands, whose products are exact in f32, and at 0.06 against
# f32.  d = 440 takes 16-byte copies, d = 37 and offset 1 one-element loads
@pytest.mark.parametrize("epilogue", ["gaussian", "polynomial"])
@pytest.mark.parametrize("n,m,d,offset", [(300, 200, 64, 0), (257, 131, 440, 0), (1000, 777, 37, 0),
                                          (130, 129, 256, 1)])
def test_gram_block_bf16_stream(dev, epilogue, n, m, d, offset):
    rng = np.random.default_rng(7 + d)
    x, z = _xz(rng, n, m, d, dev)
    xb, zb = _at_offset(x.bfloat16(), offset), z.bfloat16()
    if epilogue == "gaussian":
        def kern(a, b):
            return gk.gram_block_kernel(a, b, 1 / d)

        def plain(a, b):
            return gk.gram_block_ref(a, b, 1 / d)
        rtol = 0.0
    else:
        def kern(a, b):
            return gk.poly_block_kernel(a, b, 1 / d, 1.0, 2)

        def plain(a, b):
            return gk.poly_block_ref(a, b, 1 / d, 1.0, 2)
        rtol = RTOL_POLY
    got = kern(xb, zb)
    torch.testing.assert_close(got, plain(xb, zb), atol=ATOL_GRAM, rtol=rtol)
    torch.testing.assert_close(got, plain(x, z), atol=ATOL_BF16, rtol=0)


def _poly64(x, z, alpha, c, degree):
    """The plain polynomial chain in float64 on the same operands."""
    return (alpha * (x.double() @ z.double().T) + c) ** degree


# held against the plain chain in float64: at d = 256 the linear kernel's
# sums of 256 unit products round at ~1e-5 in f32, so the kernel and
# cuBLAS's f32 chain, summing in different orders, can differ by 2e-5
# near 0 (chip_smoke.py's TOL_POLY says the same)
@pytest.mark.parametrize("alpha,c,degree", [(1 / 256, 1.0, 2), (1.0, 0.0, 1), (0.05, -0.5, 3), (0.3, 2.0, 0)])
@pytest.mark.parametrize("n,m,d,offset", [(512, 512, 256, 0), (1000, 777, 37, 0), (300, 200, 13, 0),
                                          (257, 131, 256, 1)])
def test_poly_block_matches_plain(dev, alpha, c, degree, n, m, d, offset):
    rng = np.random.default_rng(n + degree)
    x, z = _xz(rng, n, m, d, dev, offset=offset)
    gk.reset_launches()
    got = gk.poly_block_kernel(x, z, alpha, c, degree)
    assert gk.LAUNCHES["poly_block"] == 1
    torch.testing.assert_close(got.double(), _poly64(x, z, alpha, c, degree), atol=ATOL_GRAM, rtol=RTOL_POLY)


@pytest.mark.parametrize("kind", ["gaussian", "linear"])
def test_gram_kernels_are_f32_grade(dev, kind):
    """3xTF32 against a float64 gram of the same operands: within 2x the
    plain f32 chain's (cuBLAS, TF32 off) largest error, where one-pass TF32
    is not.  z holds x's first rows, so the diagonal's long same-signed
    sums (‖x‖², K = 1 at a cancelling distance) are in the block."""
    rng = np.random.default_rng(11)
    x, _ = _xz(rng, 2048, 1, 256, dev)
    z = x[:256]
    if kind == "gaussian":
        def kern():
            return gk.gram_block_kernel(x, z, 0.002)

        def plain(a, b):
            return gk.gram_block_ref(a, b, 0.002)
        x64, z64 = x.double(), z.double()
        sq = (x64 * x64).sum(1, keepdim=True) - 2 * x64 @ z64.T + (z64 * z64).sum(1)
        exact = torch.exp(-0.002 * sq.clamp(min=0))
    else:
        def kern():
            return gk.poly_block_kernel(x, z, 1.0, 0.0, 1)

        def plain(a, b):
            return gk.poly_block_ref(a, b, 1.0, 0.0, 1)
        exact = x.double() @ z.double().T
    err = (kern().double() - exact).abs().max().item()
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        err_f32 = (plain(x, z).double() - exact).abs().max().item()
        torch.backends.cuda.matmul.allow_tf32 = True
        err_tf32 = (plain(x, z).double() - exact).abs().max().item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert err <= 2 * err_f32, (err, err_f32)
    assert err_tf32 > 2 * err_f32, (err_tf32, err_f32)


def test_gram_wrappers_raise_instead_of_falling_back(dev):
    rng = np.random.default_rng(3)
    x, z = _xz(rng, 40, 30, 16, dev)
    gk.reset_launches()
    with pytest.raises(TypeError, match="share a dtype"):
        gk.gram_block_kernel(x, z.bfloat16(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gram_block_kernel(x[:, :8], z[:, :8].contiguous(), 0.1)
    with pytest.raises(ValueError, match="d="):
        gk.poly_block_kernel(x, z[:, :8].contiguous(), 1.0, 0.0, 1)
    with pytest.raises(ValueError, match="on cpu"):
        gk.gram_block_kernel(x, z.cpu(), 0.1)
    with pytest.raises(TypeError, match="dtype"):
        gk.gram_block_kernel(x.half(), z.half(), 0.1)
    with pytest.raises(ValueError, match="degree"):
        gk.poly_block_kernel(x, z, 1.0, 0.0, -2)
    assert gk.LAUNCHES == {"gram_block": 0, "poly_block": 0}


# ---------------------------------------------------------------- the workflow graph on the card
GRAPH_SMALL = dict(num_classes=4, gmm_k=8, gmm_iters=4, pca_dims=16, descriptor_samples_per_image=32,
                   solver_block_size=512, synthetic_n=160, image_size=48, sift_step=8, lcs_step=8)


def test_graph_run_launches_b2_in_the_fit_and_b1_in_scoring(dev):
    """ImageNetSiftLcsFV.run on the card: the fit's featurization of the
    training set through B2 (FisherVector), scoring through B1 (the FV
    fusion rule's nodes), one launch a branch a chunk of rows."""
    from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV
    from keystone_tpu_torch.workflow import transformer as wt

    cfg = Config(**GRAPH_SMALL)
    chunks = -(-cfg.synthetic_n // wt.APPLY_CHUNK_ROWS)
    fk.reset_launches()
    out = {}
    result = ImageNetSiftLcsFV.run(cfg, device=dev, out=out)
    assert fk.LAUNCHES == {"fisher_encode": 2 * chunks, "fused_forward": 2, "fisher_encode_general": 0,
                           "fused_forward_general": 0}
    assert result["accuracy"] > 0.5, result
    assert out["predictions"].shape == (cfg.synthetic_n // 4, min(cfg.top_k, cfg.num_classes))


def test_graph_fused_scoring_matches_the_unfused_graph(dev):
    """The FV fusion rule's graph (B1) against the same fitted graph with
    the rule off (PCA, then B2), on the card: top-5 ids equal, scores
    within the kernels' f32 rounding carried through the solve."""
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
    from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV
    from keystone_tpu_torch.workflow import optimizer as opt
    from keystone_tpu_torch.workflow.pipeline import PipelineEnv

    cfg = Config(**GRAPH_SMALL)
    train = ImageNetLoader.synthetic(cfg.synthetic_n, cfg.num_classes, (48, 48), seed=1, device=dev)
    test = ImageNetLoader.synthetic(40, cfg.num_classes, (48, 48), seed=2, device=dev)
    fitted = ImageNetSiftLcsFV.build_scorer(cfg, train.data, train.labels).fit()
    fk.reset_launches()
    fused = fitted(test.data).get().array
    assert fk.LAUNCHES["fused_forward"] == 2 and fk.LAUNCHES["fisher_encode"] == 0
    unfused_opt = opt.Optimizer([b for b in opt.default_optimizer().batches if b.name != "fusion"]
                                + [opt.RuleBatch("fusion", opt.Once(), [opt.StageFusionRule()])])
    prev = PipelineEnv.optimizer
    PipelineEnv.set_optimizer(unfused_opt)
    try:
        unfused = fitted(test.data).get().array
    finally:
        PipelineEnv.set_optimizer(prev)
    assert fk.LAUNCHES["fisher_encode"] == 2
    torch.testing.assert_close(fused, unfused, atol=1e-3, rtol=1e-3)
    assert torch.equal(torch.topk(fused, 1).indices, torch.topk(unfused, 1).indices)


def test_blur_above_512_px_is_f32_on_the_card(dev):
    """The >512 px blur (two depthwise cuDNN convolutions) in true f32
    with cuDNN's TF32 flag on, as PyTorch sets it by default: against the
    same blur in float64 on the CPU, at the CPU test's 1e-5."""
    from keystone_tpu_torch.ops.filters import separable_gaussian_blur

    x = torch.from_numpy(np.random.default_rng(6).random((2, 520, 530, 3)).astype(np.float32))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = separable_gaussian_blur(x.to(dev), 1.2)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    want = separable_gaussian_blur(x.double(), 1.2)
    torch.testing.assert_close(got.cpu().double(), want, atol=1e-5, rtol=0)


def test_b1_from_two_threads_at_two_shapes_matches_serial(dev):
    """C10: two threads launch B1 at once, each on its own stream, at
    SIFT's (d_in 128) and LCS's (d_in 96) scorer shapes: two dynamic
    shared-memory sizes of one kernel instantiation.  No launch fails, and
    every output is bit for bit the same launch made serially.  (Set per
    launch, the kernel's process-wide shared-memory attribute could be
    lowered by one thread between the other's set and its launch.)"""
    import threading

    rng = np.random.default_rng(20)
    shapes = {"sift": _fused_args(rng, 8, 784, 128, 64, 256, dev), "lcs": _fused_args(rng, 8, 324, 96, 64, 256, dev)}
    serial = {k: fk.fused_forward(*a) for k, a in shapes.items()}
    torch.cuda.synchronize()
    reps = 400
    outs, errors = {k: [] for k in shapes}, []
    start = threading.Barrier(len(shapes))

    def worker(key):
        try:
            stream = torch.cuda.Stream(device=dev)
            with torch.cuda.stream(stream):
                start.wait()
                for _ in range(reps):
                    outs[key].append(fk.fused_forward(*shapes[key]))
            stream.synchronize()
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in shapes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors[:3]
    assert not any(t.is_alive() for t in threads)
    for k in shapes:
        assert len(outs[k]) == reps
        assert all(torch.equal(o, serial[k]) for o in outs[k]), k
