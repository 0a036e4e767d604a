"""Block coordinate descent ridge regression and block linear scoring
(counterpart of ``keystone_tpu/models/block_ls.py`` § blockify,
BlockLinearMapper, _block_predict, _offset, BlockLeastSquaresEstimator,
finish_block_model, _bcd_epoch_body, _bcd_fit, and the out-of-core
_oc_wmean, _oc_block_step, _check_store_rows, _oc_bcd_fit; the
reference's ``_oc_prefetch`` depth is the block store's ``_PREFETCH``).

Features split into column blocks; each epoch sweeps the blocks Gauss–
Seidel style:

    W_b ← (X_bᵀX_b + nλI)⁻¹ X_bᵀ(Y − P + X_bW_b),   P = Σ_b X_b W_b

The sweep is a Python loop over epochs × blocks of f32 products and
Cholesky solves (``models/common.py::solve_spd``); it computes in the
dtype it is given.  The out-of-core fit (``fit_store``,
``fit_stream_dataset``: a StreamDataset reaching the estimator through
the graph) runs the same sweep over blocks read back from a
``FeatureBlockStore``.

In a job of several ranks (``parallel/``) the fits run across the mesh:
each rank holds its row slice of the features, the labels and the
residual P; every Gramian and right-hand side all-reduces over the data
axis, so every rank solves the same block; the class columns of W and P
are cut over the model axis (columns solve independently, so that axis
needs no collective until the final weights, all-gathered over it).  On
the local mesh the collectives are the identity and the fits are the
single-process ones, bit for bit.

Both fits checkpoint per epoch (``fit_checkpointed`` in core,
``checkpoint_dir`` out of core; an estimator built with
``checkpoint_dir`` passes it to the fits the graph runs): each finished
epoch saves the full (W, P) state through ``utils/durable`` under a
content fingerprint of the problem (the reference's, so either package
resumes the other's checkpoint), and a fit of the same problem resumes
after the last saved epoch, bit for bit as the uninterrupted fit, since
the resumed epoch starts from a full state.  Each save is timed into
``solver.checkpoint_save_seconds``; with a run ledger each epoch reports
its objective (``solver.epoch``).  Across ranks, the state is gathered
whole and rank 0 alone writes it; on resume rank 0 reads it and
broadcasts the epoch and the state, and each rank takes its part; the
fingerprint covers every rank's data probe; and each epoch starts at
``maybe_health_barrier``, so a sick rank aborts the job together.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.models.common import row_mask, solve_spd
from keystone_tpu_torch.obs import ledger, metrics
from keystone_tpu_torch.parallel import collectives, multihost, require_rank_slice
from keystone_tpu_torch.parallel import mesh as _mesh
from keystone_tpu_torch.utils import durable
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset, as_dataset
from keystone_tpu_torch.workflow.estimator import LabelEstimator
from keystone_tpu_torch.workflow.transformer import Transformer, tensor_identity


def blockify(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """(n, d) → (num_blocks, n, block_size), zero-padding d if needed
    (the VectorSplitter analogue)."""
    n, d = x.shape
    nb = -(-d // block_size)
    if nb * block_size != d:
        x = F.pad(x, (0, nb * block_size - d))
    return x.reshape(n, nb, block_size).permute(1, 0, 2)


class BlockLinearMapper(Transformer):
    """Per-block weights summed into one prediction.  ``weights`` is
    (num_blocks, block_size, k); blocks are contiguous column ranges, so
    the sum of per-block partials is one flat product."""

    def __init__(
        self,
        weights: torch.Tensor,
        block_size: int,
        intercept: Optional[torch.Tensor] = None,
        feature_mean: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        self.block_size = int(block_size)
        self.register_buffer("weights", weights)
        self.register_buffer("intercept", intercept)
        self.register_buffer("feature_mean", feature_mean)

    def params(self):
        return (self.block_size, tensor_identity(self.weights, self.intercept, self.feature_mean))

    @property
    def flat_weights(self) -> torch.Tensor:
        nb, bs, k = self.weights.shape
        return self.weights.reshape(nb * bs, k)

    def apply_batch(self, xs, mask=None):
        return _block_predict(xs, self.weights, self.intercept, self.feature_mean)


def _offset(weights, feature_mean, intercept):
    off = 0.0
    if feature_mean is not None:
        nb, bs, k = weights.shape
        pad = nb * bs - feature_mean.shape[0]
        if pad > 0:  # mean given at true d; weights are block-padded
            feature_mean = F.pad(feature_mean, (0, pad))
        off = off - feature_mean @ weights.reshape(nb * bs, k)
    if intercept is not None:
        off = off + intercept
    return off


def _block_predict(xs, weights, intercept, feature_mean):
    xs = xs.to(torch.float32)
    nb, bs, k = weights.shape
    d = xs.shape[-1]
    if nb * bs != d:
        xs = F.pad(xs, (0, nb * bs - d))
    out = torch.matmul(xs, weights.reshape(nb * bs, k))
    return out + _offset(weights, feature_mean, intercept)


class BlockLeastSquaresEstimator(LabelEstimator):
    """Gauss–Seidel block coordinate descent ridge
    (BlockLeastSquares.scala § BlockLeastSquaresEstimator)."""

    def __init__(self, block_size: int = 4096, num_iter: int = 1, lam: float = 0.0,
                 fit_intercept: bool = True, checkpoint_dir: Optional[str] = None):
        self.block_size = int(block_size)
        self.num_iter = int(num_iter)
        self.lam = float(lam)
        self.fit_intercept = fit_intercept
        #: where the fits the graph runs checkpoint each epoch (None: no
        #: checkpoint); where, not what, so it is not a parameter
        self.checkpoint_dir = checkpoint_dir

    def params(self):
        return (self.block_size, self.num_iter, self.lam, self.fit_intercept)

    def fit_dataset(self, data: Dataset, labels: Optional[Dataset] = None) -> BlockLinearMapper:
        """Features (n, d) and targets (n, k), fitted in f32 on the data's
        device; a stream is fitted out of core."""
        if labels is None:
            raise ValueError("BlockLeastSquaresEstimator requires labels")
        if isinstance(data, StreamDataset):
            if self.checkpoint_dir is None:
                return self.fit_stream_dataset(data, labels)
            return self.fit_stream_dataset(data, labels, checkpoint_dir=self.checkpoint_dir)
        if self.checkpoint_dir is not None:
            return self.fit_checkpointed(data, labels, self.checkpoint_dir)
        require_rank_slice(data, "BlockLeastSquaresEstimator")
        return self._fit(data.array.to(torch.float32), labels.array.to(torch.float32), data.n, data.local_n)

    def fit_stream_dataset(self, data: StreamDataset, labels, spill_dir=None, checkpoint_dir=None) -> BlockLinearMapper:
        """Out-of-core fit: spill the streamed features to a block store
        once, then sweep its blocks from disk.  The spill directory is
        deleted after a fit that succeeds and kept after one that fails."""
        return fit_streamed(self, data, labels, spill_dir, checkpoint_dir)

    def fit_store(self, store, labels, checkpoint_dir=None) -> BlockLinearMapper:
        """Fit from a FeatureBlockStore on the labels' device (see
        ``_oc_bcd_fit``), the unweighted case of the weighted sweep."""
        labels = as_dataset(labels)
        require_rank_slice(labels, "BlockLeastSquaresEstimator.fit_store")
        _check_store_rows(store, labels)
        y = labels.array.to(torch.float32)
        alpha = row_mask(y.shape[0], labels, y.device)
        weights, xm, ym = _oc_bcd_fit(store, y, alpha, float(labels.n), self.lam, self.num_iter,
                                      self.fit_intercept, checkpoint_dir=checkpoint_dir)
        return finish_block_model(weights, xm, ym, store.d, self.block_size, self.fit_intercept)

    def fit_checkpointed(self, data, labels, checkpoint_dir: str) -> BlockLinearMapper:
        """The in-core fit with a per-epoch checkpoint and resume: each
        epoch's (W, P) lands in ``checkpoint_dir/bcd_epoch.npz`` (the
        previous one kept as ``.1``, the fallback when the newest is
        found damaged), and a fit of the same problem resumes after the
        last saved epoch.  A StreamDataset goes to the out-of-core fit
        with the same ``checkpoint_dir``.  Data that is not a Dataset
        goes to the card (``as_dataset``).  Across ranks every rank calls
        it with its own slice and the same ``checkpoint_dir``; rank 0
        writes and reads the file."""
        if isinstance(data, StreamDataset):
            return self.fit_stream_dataset(data, labels, checkpoint_dir=checkpoint_dir)
        data = as_dataset(data)
        labels = as_dataset(labels, device=data.device)
        require_rank_slice(data, "BlockLeastSquaresEstimator.fit_checkpointed")
        mesh = _mesh.current_mesh()
        x = data.array.to(torch.float32)
        y = labels.array.to(torch.float32)
        n = data.n
        xm, ym, xc, yc = _center_rows(x, y, n, data.local_n, self.fit_intercept, mesh)
        k = yc.shape[1]
        yc = _model_columns(yc, mesh)
        xb = blockify(xc, self.block_size)
        nb, _, bs = xb.shape
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "bcd_epoch.npz")
        if _mesh.world_size() <= 1:
            problem = _incore_problem(x, y, n, self.lam, self.block_size, self.fit_intercept)
        else:
            # every rank's probe, so that the fingerprint is one on every rank
            digests = multihost.gather_to_host(np.asarray([_probe_digest(x, y)], np.uint64))
            problem = _fingerprint((mesh.data * x.shape[0], x.shape[1]), (mesh.data * y.shape[0], k), n, self.lam,
                                   self.block_size, self.fit_intercept, tuple(int(v) for v in digests))
        w = torch.zeros((nb, bs, yc.shape[1]), dtype=torch.float32, device=x.device)
        p = torch.zeros_like(yc)
        full_p = (mesh.data * yc.shape[0], k)
        start = _resume(path, lambda z: str(z.get("problem")) == problem and z["w"].shape == (nb, bs, k)
                        and z["p"].shape == full_p, w, p, k, mesh)
        observe = ledger.solver_obs()
        for e in range(start, self.num_iter):
            # one sick rank aborts every rank here, before the epoch's collectives
            multihost.maybe_health_barrier("bcd.checkpointed.epoch")
            t_epoch = time.perf_counter()
            _bcd_epoch_body(xb, yc, n, self.lam, w, p, mesh)
            ledger.device_wait((w, p), force=True)  # the host copies below read them
            w_host, p_host = _gather_state(w, p, k, mesh)  # collectives: every rank
            t_save = time.perf_counter()
            if multihost.process_index() == 0:  # one writer
                durable.save_npz(path, {"epoch": e, "w": w_host, "p": p_host, "problem": problem}, keep=2)
            save_seconds = time.perf_counter() - t_save
            metrics.observe("solver.checkpoint_save_seconds", save_seconds)
            if observe:
                ledger.solver_epoch("bcd.checkpointed", epoch=e, objective=float(_bcd_objective(yc, p, n, mesh)),
                                    epoch_seconds=time.perf_counter() - t_epoch,
                                    checkpoint_save_seconds=save_seconds)
        w = _gather_columns(w, k, mesh)
        return finish_block_model(w, xm, ym, x.shape[1], self.block_size, self.fit_intercept)

    @_mesh.on_local_mesh
    def fit_arrays(self, x, y, device="cuda") -> BlockLinearMapper:
        """x: (n, d), y: (n, k), numpy or tensors, fitted in f32 on ``device``."""
        dev = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        return self._fit(x, torch.as_tensor(y, dtype=torch.float32).to(dev), x.shape[0])

    def _fit(self, x, y, n, valid=None) -> BlockLinearMapper:
        """x (rows, d), y (rows, k): ``n`` rows in all (the global count
        across ranks), the first ``valid`` (default ``n``) of these valid."""
        mesh = _mesh.current_mesh()
        xm, ym, xc, yc = _center_rows(x, y, n, n if valid is None else valid, self.fit_intercept, mesh)
        k = yc.shape[1]
        weights = _bcd_fit(blockify(xc, self.block_size), _model_columns(yc, mesh), n, self.lam, self.num_iter,
                           mesh)
        weights = _gather_columns(weights, k, mesh)
        return finish_block_model(weights, xm, ym, x.shape[1], self.block_size, self.fit_intercept)


def _center_rows(x, y, n, valid, fit_intercept, mesh):
    """(x̄, ȳ, xc, yc): the means over the ``n`` rows of every rank (zero
    padding rows add nothing to the sums), and the rows centred with the
    padding masked back to zero (it would become −x̄).  No intercept:
    (None, None, x, y)."""
    if not fit_intercept:
        return None, None, x, y
    sx, sy = collectives.psum_many(torch.sum(x, dim=0), torch.sum(y, dim=0), mesh=mesh)
    xm, ym = sx / n, sy / n
    row_ok = _mesh.local_rows_mask(x.shape[0], valid, x.device, x.dtype)[:, None]
    return xm, ym, (x - xm) * row_ok, (y - ym) * row_ok


def _model_columns(y: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's class columns of y (zero-padded to a multiple of the
    model axis); all of them on a model axis of one."""
    return _mesh.axis_part(y, 1, mesh.model, mesh.model_index)


def _gather_columns(w: torch.Tensor, k: int, mesh) -> torch.Tensor:
    """The model axis's column slices of w (..., k_local) gathered whole
    and trimmed to the ``k`` true classes."""
    if mesh.model == 1:
        return w
    return collectives.all_gather(w, _mesh.MODEL_AXIS, w.ndim - 1, mesh)[..., :k].contiguous()


def _gather_state(w, p, k, mesh):
    """Host copies of a BCD state: W (nb, bs, k) whole, P (data·rows, k)
    gathered over both axes (each slice's padding rows in place).  A
    collective above a world of one: every rank calls it."""
    w_host = _gather_columns(w, k, mesh).cpu().numpy()
    if _mesh.world_size() <= 1:
        return w_host, p.cpu().numpy()
    p_host = multihost.gather_to_host(p, _mesh.data_sharding(ndim=2, feature_axis=1 if mesh.model > 1 else None),
                                      mesh)
    return w_host, p_host[:, :k]


def _resume(path, validate, w, p, k, mesh) -> int:
    """Load a checkpointed (epoch, W, P) into ``w`` and ``p`` (this rank's
    parts) and return the epoch to start from (0: none).  Above a world
    of one, rank 0 reads and broadcasts its decision and the state, so
    that every rank enters the epoch loop at the same epoch (a silent
    local read failure would desynchronize the collectives)."""
    if _mesh.world_size() <= 1:
        loaded = durable.load_npz(path, validate=validate)
        if loaded is None:
            return 0
        z, _ = loaded
        w.copy_(torch.from_numpy(z["w"]))
        # the reference's out-of-core P may carry its mesh's padding rows
        p.copy_(torch.from_numpy(z["p"][:p.shape[0]]))
        return int(z["epoch"]) + 1
    nb, bs = w.shape[0], w.shape[1]
    rows = mesh.data * p.shape[0]
    w_full = torch.zeros((nb, bs, k), dtype=torch.float32, device=w.device)
    p_full = torch.zeros((rows, k), dtype=torch.float32, device=p.device)
    start = torch.zeros((1,), dtype=torch.int64, device=w.device)
    if multihost.process_index() == 0:
        loaded = durable.load_npz(path, validate=validate)
        if loaded is not None:
            z, _ = loaded
            start[0] = int(z["epoch"]) + 1
            w_full.copy_(torch.from_numpy(z["w"]))
            p_full.copy_(torch.from_numpy(z["p"]))
    collectives.broadcast(start)
    begin = int(start.item())
    if begin == 0:
        return 0
    collectives.broadcast(w_full)
    collectives.broadcast(p_full)
    w.copy_(_model_columns(w_full.reshape(nb * bs, k), mesh).reshape(nb, bs, -1))
    p.copy_(_model_columns(_mesh.axis_part(p_full, 0, mesh.data, mesh.data_index), mesh))
    return begin


def finish_block_model(weights, xm, ym, d, block_size, fit_intercept):
    """Fitted block weights as a BlockLinearMapper, with the intercept
    from the (weighted) means when the fit centred its data."""
    nb, bs, k = weights.shape
    if not fit_intercept:
        return BlockLinearMapper(weights, block_size)
    wflat = weights.reshape(nb * bs, k)[:d]
    intercept = ym - xm[:d] @ wflat
    return BlockLinearMapper(
        F.pad(wflat, (0, 0, 0, nb * bs - d)).reshape(nb, bs, k), block_size, intercept=intercept
    )


def _bcd_epoch_body(xb, y, n, lam, w, p, mesh=None):
    """One Gauss–Seidel sweep over all blocks; updates the weights w
    (nb, bs, k) and the running prediction p (n_rows, k) in place.  Each
    block's AᵀA and Aᵀ(target) all-reduce over the mesh's data axis."""
    mesh = mesh or _mesh.current_mesh()
    for b in range(xb.shape[0]):
        a, wb = xb[b], w[b]
        target = y - p + a @ wb  # the residual with this block's part restored
        wb_new = solve_spd(collectives.sharded_gram(a, mesh), collectives.sharded_matmul(a, target, mesh=mesh),
                           reg=lam * n)
        p += a @ (wb_new - wb)
        w[b] = wb_new
    return w, p


def _bcd_fit(xb, y, n, lam, num_iter: int, mesh=None):
    """xb: (nb, n_rows, bs); y: (n_rows, k) → weights (nb, bs, k).  With a
    run ledger, each epoch reports its objective (a host read)."""
    nb, _, bs = xb.shape
    w = torch.zeros((nb, bs, y.shape[1]), dtype=y.dtype, device=y.device)
    p = torch.zeros_like(y)
    observe = ledger.solver_obs()
    for e in range(num_iter):
        _bcd_epoch_body(xb, y, n, lam, w, p, mesh)
        if observe:
            ledger.solver_epoch("bcd", epoch=e, objective=float(_bcd_objective(y, p, n, mesh)))
    return ledger.device_wait(w)


def _bcd_objective(y, p, n, mesh=None):
    """The residual objective ½‖Y − P‖²/n of a BCD state (summed over the
    mesh: every rank's rows and class columns)."""
    r = y - p
    return collectives.mesh_sum(0.5 * torch.sum(r * r) / n, mesh)


def _probe_digest(*arrays) -> int:
    """The reference's probe of an in-core problem: a SHA-256 over the
    first and last rows of each array, as a 64-bit integer."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(a[0].cpu().numpy().tobytes())
        h.update(a[-1].cpu().numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little")


def _incore_problem(x, y, n, lam, block_size, fit_intercept) -> str:
    """The content fingerprint of an in-core BCD problem, the reference's
    byte for byte: other data, labels, λ, blocking or intercept setting
    restart the fit, the same problem resumes it on any device."""
    return _fingerprint(tuple(x.shape), tuple(y.shape), n, lam, block_size, fit_intercept, (_probe_digest(x, y),))


def _fingerprint(x_shape, y_shape, n, lam, block_size, fit_intercept, digests) -> str:
    fp = hashlib.sha256()
    fp.update(repr((tuple(x_shape), tuple(y_shape), int(n), float(lam), int(block_size), bool(fit_intercept),
                    digests)).encode())
    return fp.hexdigest()


# --------------------------------------------------------------------------
# Out-of-core block coordinate descent (features streamed from disk).
#
# Blocks live in a FeatureBlockStore; the device holds one (n × bs)
# block, the (n × k) residual P, the labels and the per-block weights,
# so the feature matrix may exceed device memory by any factor.  The
# unweighted fit is the weighted one with α_i = 1, so one sweep serves
# both solvers and its arithmetic is ``block_weighted_ls._weighted_bcd_fit``'s.
# Across ranks each rank's store holds only its own row slice, spilled to
# its own disk: a block read back is zero-padded to the labels' rows (the
# ranks' common slice length), its weighted sums and products all-reduce
# over the data axis, and no rank ever holds the full matrix.  The
# reference donates the carried residual to each step; here the step
# updates it in place, and the copies' events bound the sweep's lead over
# the card (``FeatureBlockStore.iter_device_blocks``).
# --------------------------------------------------------------------------


def _oc_wmean(alpha, a, wsum, mesh=None):
    return collectives.psum(alpha @ a, mesh=mesh) / wsum


def _oc_block_step(a_raw, xm_b, yc, sa, row_ok, p, wb, lam_n, mesh=None):
    """One block update; returns the block's new weights and adds its
    change to the residual carry ``p`` in place.  Rows that weigh
    nothing are zeroed after centring, so a padding row stays out."""
    a0 = (a_raw - xm_b) * row_ok[:, None]
    a = a0 * sa[:, None]
    target = (yc - p) * sa[:, None] + a @ wb
    wb_new = solve_spd(collectives.sharded_gram(a, mesh), collectives.sharded_matmul(a, target, mesh=mesh),
                       reg=lam_n)
    p += a0 @ (wb_new - wb)
    return wb_new


def _check_store_rows(store, labels) -> None:
    """A single process: the store's rows are the labels'.  A rank slice:
    the store holds the slice's own rows, and the data axis's slices
    together hold every label row (a collective: every rank calls it)."""
    if not labels.is_rank_slice:
        if labels.n != store.n:
            raise ValueError(f"labels n={labels.n} != store n={store.n}")
        return
    if store.n != labels.local_n:
        raise ValueError(f"this rank's store holds {store.n} rows but its label slice {labels.local_n}")
    total = multihost.data_axis_sum(store.n)
    if total != labels.n:
        raise ValueError(f"the ranks' stores hold {total} rows in all, the labels {labels.n}")


def _oc_bcd_fit(store, y, alpha, n, lam, num_iter, fit_intercept, checkpoint_dir=None):
    """BCD sweeps over the blocks of ``store``, on ``y``'s device.

    ``y``: (n_rows, k) labels; ``alpha``: (n_rows,) example weights,
    zero on rows that must weigh nothing; ``n``: the true row count (of
    every rank).  A rank's store holds its own slice's rows: each block
    is zero-padded to ``n_rows`` (its weight there is zero).  Returns
    ``(weights (nb, bs, k), xm (nb·bs,), ym (k,))``.  With
    ``checkpoint_dir``, each finished epoch saves (epoch, W, P) under a
    fingerprint of the problem (rank 0 writes, every rank's data in it),
    and a fit with the same fingerprint resumes after the last saved
    epoch."""
    mesh = _mesh.current_mesh()
    nb, bs = store.num_blocks, store.block_size
    n_rows, k = y.shape
    # the probe: the staged blocks' rows pad to the labels' rows
    pad = n_rows - store.n
    if pad < 0 or (pad and mesh.data == 1):
        raise ValueError(f"store rows {store.n} != label rows {n_rows}: the store must hold the labels' rows "
                         "(this rank's slice in a job of several ranks)")
    dev = y.device
    wsum = collectives.psum(torch.sum(alpha), mesh=mesh)
    sa = torch.sqrt(alpha)
    row_ok = (alpha > 0).to(torch.float32)

    def blocks(order):
        for b, a in store.iter_device_blocks(order, dev):
            yield b, F.pad(a, (0, 0, 0, pad)) if pad else a

    if fit_intercept:
        xm = torch.stack([_oc_wmean(alpha, a, wsum, mesh) for _, a in blocks(range(nb))])
        ym = _oc_wmean(alpha, y, wsum, mesh)
    else:
        xm = torch.zeros((nb, bs), dtype=torch.float32, device=dev)
        ym = torch.zeros((k,), dtype=torch.float32, device=dev)
    yc = _model_columns((y - ym) * row_ok[:, None], mesh)
    w = torch.zeros((nb, bs, yc.shape[1]), dtype=torch.float32, device=dev)
    p = torch.zeros_like(yc)
    start = 0

    ckpt_path = problem = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(checkpoint_dir, "oc_bcd_epoch.npz")
        problem = _oc_problem(store, y, alpha, n_rows, k, lam, n, fit_intercept)
        full_p = (mesh.data * n_rows, k)
        start = _resume(ckpt_path, lambda z: str(z.get("problem")) == problem and z["w"].shape == (nb, bs, k)
                        and z["p"].shape[1:] == full_p[1:] and z["p"].shape[0] >= full_p[0], w, p, k, mesh)

    lam_n = float(lam * n)
    order = [b for _ in range(start, num_iter) for b in range(nb)]
    epoch = start
    observe = ledger.solver_obs()
    t_epoch = time.perf_counter()
    for i, (b, a) in enumerate(blocks(order)):
        w[b] = _oc_block_step(a, xm[b], yc, sa, row_ok, p, w[b], lam_n, mesh)
        if (i + 1) % nb:
            continue
        # the epoch's end: a sick rank aborts every rank before the
        # checkpoint's gathers, which every rank must enter
        multihost.maybe_health_barrier("oc_bcd.epoch")
        save_seconds = None
        if ckpt_path is not None:
            ledger.device_wait((w, p), force=True)  # the host copies below read them
            w_host, p_host = _gather_state(w, p, k, mesh)
            t_save = time.perf_counter()
            if multihost.process_index() == 0:  # one writer
                durable.save_npz(ckpt_path, {"epoch": epoch, "w": w_host, "p": p_host, "problem": problem}, keep=2)
            save_seconds = time.perf_counter() - t_save
            metrics.observe("solver.checkpoint_save_seconds", save_seconds)
        if observe:
            t_dev = time.perf_counter()
            obj = float(_bcd_objective(yc, p, n, mesh))
            metrics.observe("device.busy_seconds", time.perf_counter() - t_dev)
            ledger.solver_epoch("bcd.out_of_core", epoch=epoch, objective=obj,
                                epoch_seconds=time.perf_counter() - t_epoch, checkpoint_save_seconds=save_seconds)
        t_epoch = time.perf_counter()
        epoch += 1
    w = _gather_columns(ledger.device_wait(w), k, mesh)
    return w, xm.reshape(-1), ym


def _oc_problem(store, y, alpha, n_rows, k, lam, n, fit_intercept) -> str:
    """The content fingerprint of an out-of-core BCD problem, the
    reference's byte for byte: other data, labels, weights, λ or
    intercept setting restart the fit, a re-spill of the same data to
    another directory resumes it.  Block 0's first row, the first label
    row and the first 64 weights stand for the content."""
    probe = int.from_bytes(hashlib.sha256(_row_bytes(store.read_block(0)[0])).digest()[:8], "little")
    # across ranks: every rank's probe and first rows (gather_to_host of a
    # host array concatenates them), so that the fingerprint is one
    probes = tuple(int(v) for v in multihost.gather_to_host(np.asarray([probe], np.uint64)))
    fp = hashlib.sha256()
    fp.update(repr((store.n, store.d, store.block_size, (n_rows, k), float(lam), n, bool(fit_intercept),
                    probes)).encode())
    fp.update(multihost.gather_to_host(y[:1].cpu().numpy()).tobytes())
    fp.update(multihost.gather_to_host(alpha[:min(n_rows, 64)].cpu().numpy()).tobytes())
    return fp.hexdigest()


def _row_bytes(row: torch.Tensor) -> bytes:
    """A stored row's bytes (bf16 as its bit patterns)."""
    return (row.view(torch.int16) if row.dtype == torch.bfloat16 else row).numpy().tobytes()


def _spill_dir(hint=None) -> str:
    """A fresh directory for spilled feature blocks: under ``hint``, else
    under the PipelineEnv state directory, else the system's temporary
    directory."""
    from keystone_tpu_torch.workflow.pipeline import PipelineEnv

    base = hint or PipelineEnv.state_dir
    if base is not None:
        os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix="kst_spill_", dir=base)


def fit_streamed(est, data: StreamDataset, labels, spill_dir=None, checkpoint_dir=None):
    """``est.fit_store`` on the stream's features spilled once to a fresh
    f32 block store; the spill is deleted after a fit that succeeds."""
    from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore

    with ledger.span("solver.spill", solver="bcd", n=data.n):
        store = FeatureBlockStore.from_batches(_spill_dir(spill_dir), data.batches(), data.n, est.block_size)
    logging.getLogger(__name__).info("spilled %d x %d features to %s (%d blocks, %d bytes)", store.n, store.d,
                                     store.directory, store.num_blocks, store.nbytes())
    fitted = est.fit_store(store, labels, checkpoint_dir=checkpoint_dir)
    shutil.rmtree(store.directory, ignore_errors=True)
    return fitted
