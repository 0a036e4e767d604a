"""Kernel ridge regression by block coordinate descent (counterpart of
``keystone_tpu/models/kernel_ridge.py``, in-core only).

Block Gauss–Seidel over the dual coefficients (arXiv:1602.05310):

    α_b ← (K_bb + λnI)⁻¹ (Y_b − F_b + K_bb α_b),   F = K·α

Kernel column blocks K(X, X_b) come from the gram kernels
(``ops/gram_kernels.py``): on the card every gram launches a CUDA kernel,
including the in-core sweep's, which the reference left to XLA's fusion
of the generator chain.  The sweeps are Python loops over epochs × blocks;
α and F are updated in place (the port owns them; this saves one (n, k)
copy a block).  The out-of-core sweep (``_oc_*``, ``fit_stream_dataset``,
``fit_store``, ``OutOfCoreKernelBlockLinearMapper``) needs the row-block
store and is not ported (ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from keystone_tpu_torch.models.common import needs_row_block_store, solve_spd
from keystone_tpu_torch.ops.gram_kernels import gram_block, gram_block_ref, poly_block_ref
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.transformer import Transformer

# Each generator's ``__call__`` is the plain version of its gram kernel.
# The reference's ``solver_grade`` flag is not carried over: on the card
# every f32 product here is true f32 (TF32 off), for solvers and scoring
# alike.


@dataclasses.dataclass(frozen=True)
class GaussianKernelGenerator:
    """K(x, z) = exp(−γ‖x−z‖²) via the gemm expansion."""

    gamma: float

    def __call__(self, x, z):
        return gram_block_ref(x, z, self.gamma)


@dataclasses.dataclass(frozen=True)
class LinearKernelGenerator:
    """K(x, z) = x·zᵀ."""

    def __call__(self, x, z):
        return poly_block_ref(x, z, 1.0, 0.0, 1)


@dataclasses.dataclass(frozen=True)
class PolynomialKernelGenerator:
    """K(x, z) = (α·x·zᵀ + c)^degree, integer degree."""

    degree: int = 2
    alpha: float = 1.0
    c: float = 1.0

    def __call__(self, x, z):
        return poly_block_ref(x, z, self.alpha, self.c, self.degree)


class KernelBlockLinearMapper(Transformer):
    """Predicts K(x_test, X_train)·α, streaming over train blocks so the
    test×train kernel never fully materializes.  Gaussian generators only,
    as in the reference."""

    def __init__(self, kernel_gen, train_x, alpha, block_size: int, train_n: int,
                 use_kernel: Optional[bool] = None):
        super().__init__()
        self.kernel_gen = kernel_gen
        self.register_buffer("train_x", train_x)  # (n_rows, d), block-padded
        self.register_buffer("alpha", alpha)  # (n_rows, k); zero on padding rows
        self.block_size = int(block_size)
        self.train_n = int(train_n)
        self.use_kernel = use_kernel

    def apply_batch(self, xs, mask=None):
        if not isinstance(self.kernel_gen, GaussianKernelGenerator):
            raise TypeError(
                f"KernelBlockLinearMapper predicts with Gaussian generators only, "
                f"got {type(self.kernel_gen).__name__}"
            )
        return _krr_predict(xs, self.train_x, self.alpha, self.kernel_gen.gamma,
                            self.block_size, self.use_kernel)


class KernelRidgeRegressionEstimator:
    """``cache_kernel_blocks`` sweeps through a ``BlockKernelMatrix`` that
    keeps every kernel column block, so epochs ≥ 2 reread K instead of
    recomputing its gemms; it needs K (n² f32) within half the card's
    memory.  ``use_kernel=False`` computes every gram by the plain chain
    (the comparison on the card)."""

    def __init__(
        self,
        kernel_gen,
        lam: float = 1e-3,
        block_size: int = 1024,
        num_epochs: int = 1,
        cache_kernel_blocks: bool = False,
        use_kernel: Optional[bool] = None,
    ):
        self.kernel_gen = kernel_gen
        self.lam = float(lam)
        self.block_size = int(block_size)
        self.num_epochs = int(num_epochs)
        self.cache_kernel_blocks = bool(cache_kernel_blocks)
        self.use_kernel = use_kernel

    def fit_stream_dataset(self, *args, **kwargs):
        raise needs_row_block_store("fit_stream_dataset")

    def fit_store(self, *args, **kwargs):
        raise needs_row_block_store("fit_store")

    def fit_arrays(self, x, y, device="cuda") -> KernelBlockLinearMapper:
        """x: (n, d), y: (n, k), numpy or tensors, fitted on ``device``
        (the card unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        return self._fit(x, torch.as_tensor(y, dtype=torch.float32).to(dev), x.shape[0])

    def _fit(self, x, y, n):
        n_rows = x.shape[0]
        bs = self.block_size
        nb = -(-n_rows // bs)
        if nb * bs != n_rows:
            x = F.pad(x, (0, 0, 0, nb * bs - n_rows))
            y = F.pad(y, (0, 0, 0, nb * bs - n_rows))
        x, y = x.contiguous(), y.contiguous()
        if self.cache_kernel_blocks:
            alpha = _krr_fit_cached(x, y, n, self.kernel_gen, self.lam, bs, self.num_epochs,
                                    self.use_kernel)
        else:
            if not isinstance(self.kernel_gen, GaussianKernelGenerator):
                raise TypeError("the in-core sweep takes a GaussianKernelGenerator; "
                                "use cache_kernel_blocks=True for other generators")
            alpha = _krr_fit(x, y, n, self.kernel_gen.gamma, self.lam, bs, self.num_epochs,
                             self.use_kernel)
        return KernelBlockLinearMapper(self.kernel_gen, x, alpha, bs, n, self.use_kernel)


def _row_ok(n_rows, n, device):
    return (torch.arange(n_rows, device=device) < n).to(torch.float32)


def _krr_fit(x, y, n, gamma, lam, bs, num_epochs, use_kernel=None):
    """The in-core sweep: one gram launch per (epoch, block) for the
    (n_rows, bs) kernel column block."""
    n_rows = x.shape[0]
    nb = n_rows // bs
    row_ok = _row_ok(n_rows, n, x.device)
    y = y * row_ok[:, None]
    alpha = torch.zeros_like(y)
    f = torch.zeros_like(y)
    for _ in range(num_epochs):
        for b in range(nb):
            lo = b * bs
            kcol = gram_block(x, x[lo:lo + bs], gamma, use_kernel=use_kernel)
            ab_new, f_delta = _cached_block_update(
                kcol, kcol[lo:lo + bs], row_ok, row_ok[lo:lo + bs], alpha[lo:lo + bs],
                y[lo:lo + bs], f[lo:lo + bs], lam * n,
            )
            alpha[lo:lo + bs] = ab_new
            f += f_delta
    return alpha


def _cached_block_update(kcol, kbb, row_ok, ok_b, ab, yb, fb, lam_n):
    """One Gauss–Seidel block update from the kernel column block K(:, b),
    (n_rows, bs), and its diagonal block; returns (α_b new, the F
    increment).  Both sweeps share it (the reference inlines a copy in
    its jitted in-core sweep); they differ only in where the column block
    comes from."""
    # mask padding rows/cols; the pad diagonal is identity so the solve stays PD
    kcol = kcol * row_ok[:, None] * ok_b[None, :]
    kbb = kbb * ok_b[:, None] * ok_b[None, :] + torch.diag(1.0 - ok_b)
    target = yb - fb + kbb @ ab
    ab_new = solve_spd(kbb, target, reg=lam_n) * ok_b[:, None]
    return ab_new, kcol @ (ab_new - ab)


def _krr_fit_cached(x, y, n, kern, lam, bs, num_epochs, use_kernel=None):
    """Gauss–Seidel sweep through a ``BlockKernelMatrix`` that keeps every
    column block: epoch 1 computes each block once, later epochs reread.
    K beyond the memory budget would need the disk tier (ROADMAP A9)."""
    from keystone_tpu_torch.models.kernel_matrix import BlockKernelMatrix
    from keystone_tpu_torch.workflow.profiling import device_hbm_budget

    n_rows = x.shape[0]
    nb = n_rows // bs
    k_bytes = n_rows * n_rows * 4
    budget = device_hbm_budget(0.5, x.device)
    if k_bytes > budget:
        raise NotImplementedError(
            f"the cached KRR fit keeps K ({k_bytes} bytes) in device memory, over the "
            f"budget of {budget} bytes; spilling column blocks to disk needs "
            "utils/durable, which the port does not have yet (ROADMAP A9)"
        )
    row_ok = _row_ok(n_rows, n, x.device)
    y = y * row_ok[:, None]
    km = BlockKernelMatrix(kern, x, bs, cache_blocks=nb * nb, use_kernel=use_kernel)
    alpha = torch.zeros_like(y)
    f = torch.zeros_like(y)
    for _ in range(num_epochs):
        for b in range(nb):
            lo = b * bs
            kcol = km.column_block(b)
            ab_new, f_delta = _cached_block_update(
                kcol, kcol[lo:lo + bs], row_ok, row_ok[lo:lo + bs], alpha[lo:lo + bs],
                y[lo:lo + bs], f[lo:lo + bs], lam * n,
            )
            alpha[lo:lo + bs] = ab_new
            f += f_delta
    return alpha


def _krr_predict(xs, train_x, alpha, gamma, bs, use_kernel=None):
    """K(xs, X_train)·α, one gram launch per train block."""
    xs = xs.to(torch.float32).contiguous()
    nb = train_x.shape[0] // bs
    out = torch.zeros((xs.shape[0], alpha.shape[1]), dtype=torch.float32, device=xs.device)
    for b in range(nb):
        lo = b * bs
        out += gram_block(xs, train_x[lo:lo + bs], gamma, use_kernel=use_kernel) @ alpha[lo:lo + bs]
    return out


def _krr_objective(y, f, n):
    """Dual residual objective ½‖Y−F‖²/n of a KRR carry."""
    r = y - f
    return 0.5 * torch.sum(r * r) / n


def _oc_krr_fit(*args, **kwargs):
    raise needs_row_block_store("the out-of-core KRR sweep")


class OutOfCoreKernelBlockLinearMapper(Transformer):
    """Prediction with the train rows streamed from a row-block store:
    not ported (ROADMAP A6)."""

    def __init__(self, *args, **kwargs):
        raise needs_row_block_store("OutOfCoreKernelBlockLinearMapper")
