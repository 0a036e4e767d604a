"""Kernel ridge regression by block coordinate descent (counterpart of
``keystone_tpu/models/kernel_ridge.py``).

Block Gauss–Seidel over the dual coefficients (arXiv:1602.05310):

    α_b ← (K_bb + λnI)⁻¹ (Y_b − F_b + K_bb α_b),   F = K·α

Kernel column blocks K(X, X_b) come from the gram kernels
(``ops/gram_kernels.py``): on the card every gram launches a CUDA kernel,
including the in-core sweep's, which the reference left to XLA's fusion
of the generator chain.  The sweeps are Python loops over epochs × blocks;
α and F are updated in place (the port owns them; the reference donates
its carries to each jitted step instead, and bounds its dispatch queue
with a ``tick`` output, which has no counterpart here).

The out-of-core sweep (``_oc_krr_fit``; ``fit_store``,
``fit_stream_dataset``) streams the train rows from a ``RowBlockStore``
and forms every kernel tile from two row blocks, so neither K nor X is
ever resident; ``OutOfCoreKernelBlockLinearMapper`` predicts from the
same store.  Its ``kernel.sweep`` fault site fires once per diagonal
step, each checkpoint save is timed into
``solver.checkpoint_save_seconds``, and the spill runs in a
``solver.spill`` ledger span.  With a run ledger every sweep reports each
epoch's dual objective ½‖Y − F‖²/n (``solver.epoch``, a host read);
without one it reads nothing back.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.faults import fault_point
from keystone_tpu_torch.models.common import solve_spd
from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.ops.gram_kernels import gram_block, gram_block_ref, poly_block_ref
from keystone_tpu_torch.parallel import require_one_rank
from keystone_tpu_torch.utils import durable, precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset, as_dataset
from keystone_tpu_torch.workflow.estimator import LabelEstimator
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


class KernelRidgeRegressionEstimator(LabelEstimator):
    """``cache_kernel_blocks`` sweeps through a ``BlockKernelMatrix`` that
    keeps every kernel column block, so epochs ≥ 2 reread K instead of
    recomputing its gemms: in device memory while K (n² f32) fits half
    the card's, beyond that on disk (``kernel_cache_dir``, else a
    temporary directory deleted after the fit).  A ``StreamDataset``
    reaching ``fit_dataset`` is fitted out of core.  ``use_kernel=False``
    computes every gram by the plain chain (the comparison on the card)."""

    def __init__(
        self,
        kernel_gen,
        lam: float = 1e-3,
        block_size: int = 1024,
        num_epochs: int = 1,
        cache_kernel_blocks: bool = False,
        kernel_cache_dir: Optional[str] = None,
        use_kernel: Optional[bool] = None,
    ):
        self.kernel_gen = kernel_gen
        self.lam = float(lam)
        self.block_size = int(block_size)
        self.num_epochs = int(num_epochs)
        self.cache_kernel_blocks = bool(cache_kernel_blocks)
        self.kernel_cache_dir = kernel_cache_dir
        self.use_kernel = use_kernel

    def params(self):
        return (self.kernel_gen, self.lam, self.block_size, self.num_epochs, self.cache_kernel_blocks)

    def fit_dataset(self, data: Dataset, labels: Optional[Dataset] = None):
        """The fit on the data's device: out of core for a stream."""
        if labels is None:
            raise ValueError("KernelRidgeRegressionEstimator requires labels")
        require_one_rank("KernelRidgeRegressionEstimator")
        if data.is_host:
            raise TypeError("host-payload data reached a kernel solver; featurize to arrays before the fit")
        if isinstance(data, StreamDataset):
            return self.fit_stream_dataset(data, labels)
        x = data.array.to(torch.float32)
        return self._fit(x, labels.array.to(x.device, torch.float32), data.n)

    def fit_stream_dataset(self, data: StreamDataset, labels, spill_dir=None, checkpoint_dir=None
                           ) -> "OutOfCoreKernelBlockLinearMapper":
        """Out-of-core fit: spill the streamed train rows once to a
        ``RowBlockStore`` (a fresh directory under ``spill_dir``, else
        under the system's temporary directory), then sweep it from disk.
        The store backs the fitted model, whose predictions stream it, so
        it is kept after the fit; a failed sweep removes it only when this
        call chose where it went."""
        from keystone_tpu_torch.models.block_ls import _spill_dir
        from keystone_tpu_torch.workflow.blockstore import RowBlockStore

        with ledger.span("solver.spill", solver="krr", n=data.n):
            store = RowBlockStore.from_batches(_spill_dir(spill_dir), data.batches(), data.n, self.block_size)
        try:
            return self.fit_store(store, labels, checkpoint_dir=checkpoint_dir)
        except BaseException:
            if spill_dir is None:
                shutil.rmtree(store.directory, ignore_errors=True)
            raise

    def fit_store(self, store, labels, checkpoint_dir=None) -> "OutOfCoreKernelBlockLinearMapper":
        """The out-of-core sweep (``_oc_krr_fit``) over an existing
        ``RowBlockStore``, on the labels' device (the card for labels not
        yet on one).  With ``checkpoint_dir`` each finished epoch is saved
        and an interrupted fit resumes after the last one saved."""
        if not isinstance(self.kernel_gen, GaussianKernelGenerator):
            raise TypeError("the out-of-core sweep takes a GaussianKernelGenerator")
        require_one_rank("KernelRidgeRegressionEstimator")
        labels = as_dataset(labels)
        if labels.n != store.n:
            raise ValueError(f"labels n={labels.n} != store n={store.n}")
        alpha = _oc_krr_fit(store, labels.array, float(labels.n), self.kernel_gen.gamma, self.lam,
                            self.num_epochs, checkpoint_dir=checkpoint_dir, use_kernel=self.use_kernel)
        return OutOfCoreKernelBlockLinearMapper(self.kernel_gen, store.directory, alpha, labels.n,
                                                use_kernel=self.use_kernel)

    def fit_arrays(self, x, y, device="cuda") -> KernelBlockLinearMapper:
        """x: (n, d), y: (n, k), numpy or tensors, fitted on ``device``
        (the card unless the caller asks for the CPU)."""
        require_one_rank("KernelRidgeRegressionEstimator")
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
                                    cache_dir=self.kernel_cache_dir, use_kernel=self.use_kernel)
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
    observe = ledger.solver_obs()
    for e in range(num_epochs):
        for b in range(nb):
            lo = b * bs
            kcol = gram_block(x, x[lo:lo + bs], gamma, use_kernel=use_kernel)
            ab_new, f_delta = _cached_block_update(
                kcol, kcol[lo:lo + bs], row_ok, row_ok[lo:lo + bs], alpha[lo:lo + bs],
                y[lo:lo + bs], f[lo:lo + bs], lam * n,
            )
            alpha[lo:lo + bs] = ab_new
            f += f_delta
        if observe:
            ledger.solver_epoch("krr", epoch=e, objective=float(_krr_objective(y, f, n)))
    return ledger.device_wait(alpha)


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


def _krr_fit_cached(x, y, n, kern, lam, bs, num_epochs, cache_dir=None, use_kernel=None):
    """Gauss–Seidel sweep through a ``BlockKernelMatrix`` that keeps every
    column block: epoch 1 computes each block once, later epochs reread.
    While K fits half the card's memory the columns stay there; beyond
    it the matrix goes tiered: the columns persist on disk under
    ``cache_dir`` (else a temporary directory, deleted after the fit) and
    as many as fit the budget stay on the device."""
    from keystone_tpu_torch.models.kernel_matrix import BlockKernelMatrix
    from keystone_tpu_torch.workflow.profiling import device_hbm_budget

    n_rows = x.shape[0]
    nb = n_rows // bs
    row_ok = _row_ok(n_rows, n, x.device)
    y = y * row_ok[:, None]
    budget = device_hbm_budget(0.5, x.device)
    tmp_dir = None
    if n_rows * n_rows * 4 <= budget:
        km = BlockKernelMatrix(kern, x, bs, cache_blocks=nb * nb, use_kernel=use_kernel)
    else:
        spill = cache_dir
        if spill is None:
            spill = tmp_dir = tempfile.mkdtemp(prefix="krr_kcache_")
        hbm_cols = max(1, int(budget // max(n_rows * bs * 4, 1)))
        km = BlockKernelMatrix(kern, x, bs, cache_blocks=0, spill_dir=spill, hbm_cols=hbm_cols,
                               use_kernel=use_kernel)
    alpha = torch.zeros_like(y)
    f = torch.zeros_like(y)
    observe = ledger.solver_obs()
    try:
        for e in range(num_epochs):
            t_epoch = time.perf_counter()
            hits0 = km.cache_hits
            for b in range(nb):
                lo = b * bs
                kcol = km.column_block(b)
                ab_new, f_delta = _cached_block_update(
                    kcol, kcol[lo:lo + bs], row_ok, row_ok[lo:lo + bs], alpha[lo:lo + bs],
                    y[lo:lo + bs], f[lo:lo + bs], lam * n,
                )
                alpha[lo:lo + bs] = ab_new
                f += f_delta
            if observe:
                ledger.solver_epoch("krr.cached", epoch=e, objective=float(_krr_objective(y, f, n)),
                                    epoch_seconds=time.perf_counter() - t_epoch, cache_hits=km.cache_hits - hits0)
    finally:
        if tmp_dir is not None:
            shutil.rmtree(tmp_dir, ignore_errors=True)
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


# --------------------------------------------------------------------------
# Out-of-core kernel BCD (train rows streamed from disk).
#
# The rows live in a RowBlockStore; each (epoch, block b) step streams
# the diagonal block X_b, solves for Δα_b, then streams every other row
# block X_i for F_i += K(X_i, X_b)·Δα_b, every tile a gram launch of two
# (bs, d) row blocks.  The stream order is [b, then every i ≠ b] for each
# b, nb² staged blocks an epoch, one block iterator for the whole sweep so
# that the feed never drains at a step boundary.  The device holds two
# row blocks and the (n, k) α, F and labels: nothing n²- or n·d-shaped.
# --------------------------------------------------------------------------


def _oc_krr_diag_step(xb, fb, ab, yb, ok_b, lam_n, gamma, use_kernel=None):
    """One diagonal (solve) step: updates the carried slices α_b and F_b
    in place and returns Δα_b, which the block's off-diagonal steps read."""
    kbb = gram_block(xb, xb, gamma, use_kernel=use_kernel)
    kbb = kbb * ok_b[:, None] * ok_b[None, :] + torch.diag(1.0 - ok_b)
    target = yb - fb + kbb @ ab
    ab_new = solve_spd(kbb, target, reg=lam_n) * ok_b[:, None]
    dab = ab_new - ab
    # diag(1 − ok)·Δα is zero row by row (Δα is masked), so the solve's
    # kbb gives the unregularized tile's F update exactly
    fb += kbb @ dab
    ab.copy_(ab_new)
    return dab


def _oc_krr_offdiag_step(fi, xi, xb, dab, ok_i, ok_b, gamma, use_kernel=None):
    """One off-diagonal step: F_i += K(X_i, X_b)·Δα_b, in place."""
    kib = gram_block(xi, xb, gamma, use_kernel=use_kernel) * ok_i[:, None] * ok_b[None, :]
    fi += kib @ dab


def _block_bytes(blk: torch.Tensor) -> bytes:
    """A row block's bytes as stored (bf16 as its bit patterns)."""
    return (blk.view(torch.int16) if blk.dtype == torch.bfloat16 else blk).numpy().tobytes()


def _oc_problem(store, y, n_rows, k, lam, gamma, n) -> str:
    """The reference's content fingerprint of an out-of-core KRR problem:
    other data, labels, γ, λ or blocking restart the fit, a re-spill of
    the same rows to another directory resumes it.  The first, middle and
    last row blocks and three label probes stand for the content."""
    nb = store.num_blocks
    h = hashlib.sha256()
    for pb in sorted({0, nb // 2, nb - 1}):
        h.update(_block_bytes(store.read_block(pb)))
    fp = hashlib.sha256()
    fp.update(repr((store.n, store.d, store.block_size, (n_rows, k), float(lam), gamma, float(n),
                    h.hexdigest())).encode())
    yh = y.cpu().numpy()
    fp.update(yh[:1].tobytes())
    fp.update(yh[-1:].tobytes())
    fp.update(yh[::max(1, n_rows // 64)].tobytes())
    return fp.hexdigest()


def _oc_krr_fit(store, y, n, gamma, lam, num_epochs, checkpoint_dir=None, use_kernel=None):
    """Kernel BCD sweeps over the row blocks of ``store``, on ``y``'s device.

    ``y``: (n, k) labels; ``n``: the true row count.  Returns α as one
    (nb·bs, k) tensor, zero on padding rows.  With ``checkpoint_dir``, each
    finished epoch saves (epoch, α, F) under the problem's fingerprint
    through ``utils/durable`` (atomic, checksummed, the previous one kept
    as a fallback), and a fit of the same problem resumes after it, bit
    for bit as the uninterrupted fit."""
    bs, nb = store.block_size, store.num_blocks
    n_rows = nb * bs
    gamma = float(gamma)
    y = y.to(torch.float32)
    dev = y.device
    if y.shape[0] > n_rows:
        y = y[:n_rows]
    if y.shape[0] < n_rows:
        y = F.pad(y, (0, 0, 0, n_rows - y.shape[0]))
    k = y.shape[1]
    row_ok = _row_ok(n_rows, n, dev)
    y = y * row_ok[:, None]
    yb, ok = y.reshape(nb, bs, k), row_ok.reshape(nb, bs)
    alpha = torch.zeros((nb, bs, k), dtype=torch.float32, device=dev)
    f = torch.zeros_like(alpha)
    lam_n = float(lam * n)
    start = 0

    ckpt_path = problem = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(checkpoint_dir, "krr_epoch.npz")
        problem = _oc_problem(store, y, n_rows, k, lam, gamma, n)
        loaded = durable.load_npz(
            ckpt_path,
            validate=lambda z: str(z.get("problem")) == problem and z["alpha"].shape == (nb, bs, k)
            and z["f"].shape == (nb, bs, k))
        if loaded is not None:
            z, _ = loaded
            start = int(z["epoch"]) + 1
            alpha.copy_(torch.from_numpy(z["alpha"]))
            f.copy_(torch.from_numpy(z["f"]))

    order = []
    for _ in range(start, num_epochs):
        for b in range(nb):
            order.append(b)
            order.extend(i for i in range(nb) if i != b)
    per_epoch = nb * nb
    epoch = start
    xb = dab = None
    b_cur = -1
    observe = ledger.solver_obs()
    t_epoch = time.perf_counter()
    for i, (j, a) in enumerate(store.iter_device_blocks(order, dev)):
        pos = i % per_epoch
        if pos % nb == 0:  # the diagonal step: X_b stays for this block's F pass
            b_cur, xb = j, a
            fault_point("kernel.sweep", block=str(j))
            dab = _oc_krr_diag_step(xb, f[j], alpha[j], yb[j], ok[j], lam_n, gamma, use_kernel)
        else:
            _oc_krr_offdiag_step(f[j], a, xb, dab, ok[j], ok[b_cur], gamma, use_kernel)
        if pos != per_epoch - 1:
            continue
        save_seconds = None
        if ckpt_path is not None:
            ledger.device_wait((alpha, f), force=True)  # the host copies below read them
            a_host, f_host = alpha.cpu().numpy(), f.cpu().numpy()
            t_save = time.perf_counter()
            durable.save_npz(ckpt_path, {"epoch": epoch, "alpha": a_host, "f": f_host, "problem": problem}, keep=2)
            save_seconds = time.perf_counter() - t_save
            metrics.observe("solver.checkpoint_save_seconds", save_seconds)
        if observe:
            t_dev = time.perf_counter()
            obj = float(_krr_objective(yb, f, n))
            metrics.observe("device.busy_seconds", time.perf_counter() - t_dev)
            ledger.solver_epoch("krr.out_of_core", epoch=epoch, objective=obj,
                                epoch_seconds=time.perf_counter() - t_epoch, checkpoint_save_seconds=save_seconds)
        t_epoch = time.perf_counter()
        epoch += 1
    return ledger.device_wait(alpha).reshape(n_rows, k)


#: test rows a streamed prediction's gram covers: K(x, X_b) stays
#: (_PREDICT_ROWS, block_size) however many rows one sweep scores
_PREDICT_ROWS = 8192


def _oc_krr_predict_block(out, xs, xb, ab, gamma, mxu="f32", use_kernel=None):
    """One streamed prediction accumulation, in place: out += K(xs, X_b)·α_b."""
    out += gram_block(xs, xb, gamma, mxu=mxu, use_kernel=use_kernel) @ ab


class OutOfCoreKernelBlockLinearMapper(Transformer):
    """Predicts K(x_test, X_train)·α with the train rows streamed from a
    ``RowBlockStore``: for a kernel model the train rows are part of the
    model, and out of core they stay on disk at apply time too.  The
    store's directory must live as long as the model; the model keeps its
    path, not its blocks (``torch.save`` carries α and the path, and the
    store reopens lazily).

    ``alpha``: (nb·bs, k), zero on padding rows; a tensor stays on its
    device, other data goes to the card.  Gaussian generators only, as
    in the reference."""

    #: scores a whole dataset in one sweep of the store (``apply_dataset``),
    #: which a fused chain's per-chunk ``apply_batch`` would bypass
    fusable = False

    def __init__(self, kernel_gen, store_directory, alpha, train_n: int, use_kernel: Optional[bool] = None):
        super().__init__()
        if not isinstance(alpha, torch.Tensor):
            alpha = torch.from_numpy(np.asarray(alpha, np.float32)).to(resolve_device())
        self.kernel_gen = kernel_gen
        self.store_directory = str(store_directory)
        self.register_buffer("alpha", alpha.to(torch.float32))
        self.train_n = int(train_n)
        self.use_kernel = use_kernel

    def _store(self):
        st = self.__dict__.get("_store_obj")
        if st is None:
            from keystone_tpu_torch.workflow.blockstore import RowBlockStore

            st = RowBlockStore(self.store_directory)
            self.__dict__["_store_obj"] = st
        return st

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_store_obj", None)  # reopened lazily after a load
        return state

    def apply_batch(self, xs, mask=None):
        st = self._store()
        xs = xs.to(torch.float32).contiguous()
        out = torch.zeros((xs.shape[0], self.alpha.shape[1]), dtype=torch.float32, device=xs.device)
        bs, gamma = st.block_size, float(self.kernel_gen.gamma)
        mxu = precision.apply_mode()
        for b, blk in st.iter_device_blocks(range(st.num_blocks), xs.device):
            ab = self.alpha[b * bs:(b + 1) * bs]
            for i in range(0, xs.shape[0], _PREDICT_ROWS):
                _oc_krr_predict_block(out[i:i + _PREDICT_ROWS], xs[i:i + _PREDICT_ROWS], blk, ab, gamma, mxu,
                                      self.use_kernel)
        return out

    def apply_dataset(self, ds):
        """One sweep of the store for a whole in-memory dataset: the
        inherited path would reread and re-verify every block for each
        of its ``APPLY_CHUNK_ROWS``-row chunks.  A stream is swept once a
        batch."""
        if isinstance(ds, StreamDataset) or ds.is_host:
            return super().apply_dataset(ds)
        return ds.with_array(self.apply_batch(ds.array))
