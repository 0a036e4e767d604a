"""Collective helpers, the treeReduce/treeAggregate replacements
(counterpart of ``keystone_tpu/parallel/collectives.py`` § psum, pmean,
tree_psum, sharded_matmul, sharded_gram).

The reference's only collectives are Spark ``treeReduce``/``treeAggregate``
(per-partition Gramians, gradients and moments summed to the driver) and
``broadcast`` (SURVEY.md §2.9).  Here each is one ``torch.distributed``
call over a mesh axis's group (``parallel/mesh.py``): NCCL on the card,
Gloo on the CPU.  On the local mesh every helper is the identity and
calls nothing.  ``COUNTS`` counts the calls made, by kind.

The k-means++ draw over rows spread across ranks (``categorical``) is
the reference's categorical draw (Gumbel-max over the global row
order) made explicit: every rank draws the noise of every global row
from one seed and keeps its own rows', the ranks agree on the largest
key (``global_argmax``, ties to the lower index), and the owner's row
reaches every rank by one all-reduce of a (1, d) row (``row_at``, the
reference's one-hot contraction ``_row_at``).  R ranks pick the row that
one rank picks over the same rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.parallel import mesh as _mesh
from keystone_tpu_torch.utils import precision

#: collectives issued since ``reset_counts``, by kind (the local mesh's
#: identities are not counted); ``argmax``: the draws' agreements on a
#: winner (each a MAX and a MIN all-reduce of one value, not counted
#: under ``all_reduce``)
COUNTS = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "argmax": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _count(kind: str, axis: str) -> None:
    from keystone_tpu_torch.obs import metrics

    COUNTS[kind] += 1
    metrics.inc("parallel.collectives", kind=kind, axis=axis)


def psum(x: torch.Tensor, axis_name: str = _mesh.DATA_AXIS, mesh: Optional[_mesh.Mesh] = None) -> torch.Tensor:
    """All-reduce sum over a mesh axis, in place; returns ``x``."""
    mesh = mesh or _mesh.current_mesh()
    group = mesh.group(axis_name)
    if group is None:
        return x
    import torch.distributed as dist

    _count("all_reduce", axis_name)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def psum_many(*xs: torch.Tensor, axis_name: str = _mesh.DATA_AXIS, mesh: Optional[_mesh.Mesh] = None):
    """``psum`` of several tensors of one dtype in ONE all-reduce (their
    flat concatenation); returns them summed, in their shapes.  Without a
    group: the tensors as they are, nothing copied."""
    mesh = mesh or _mesh.current_mesh()
    if mesh.group(axis_name) is None:
        return xs
    flat = psum(torch.cat([x.reshape(-1) for x in xs]), axis_name, mesh)
    out, at = [], 0
    for x in xs:
        out.append(flat[at:at + x.numel()].view(x.shape))
        at += x.numel()
    return tuple(out)


def pmin(x: torch.Tensor, axis_name: str = _mesh.DATA_AXIS, mesh: Optional[_mesh.Mesh] = None) -> torch.Tensor:
    """All-reduce minimum over a mesh axis, in place; returns ``x``: a
    value every rank of the axis agrees on (a budget, a limit)."""
    mesh = mesh or _mesh.current_mesh()
    group = mesh.group(axis_name)
    if group is None:
        return x
    import torch.distributed as dist

    _count("all_reduce", axis_name)
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


def mesh_sum(x: torch.Tensor, mesh: Optional[_mesh.Mesh] = None) -> torch.Tensor:
    """``x`` summed over both axes of the mesh (a scalar that each rank
    computed over its rows and its class columns)."""
    mesh = mesh or _mesh.current_mesh()
    for axis in (_mesh.DATA_AXIS, _mesh.MODEL_AXIS):
        (x,) = psum_many(x, axis_name=axis, mesh=mesh)
    return x


def pmean(x: torch.Tensor, axis_name: str = _mesh.DATA_AXIS, mesh: Optional[_mesh.Mesh] = None) -> torch.Tensor:
    mesh = mesh or _mesh.current_mesh()
    return psum(x, axis_name, mesh) / mesh.axis_size(axis_name)


def tree_psum(tree, axis_name: str = _mesh.DATA_AXIS, mesh: Optional[_mesh.Mesh] = None):
    """``psum`` of every tensor of a nested list, tuple or dict."""
    if isinstance(tree, dict):
        return {k: tree_psum(v, axis_name, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_psum(v, axis_name, mesh) for v in tree)
    return psum(tree, axis_name, mesh)


def all_gather(x: torch.Tensor, axis_name: str, dim: int = 0, mesh: Optional[_mesh.Mesh] = None) -> torch.Tensor:
    """The axis's ranks' ``x`` (equal shapes) concatenated along ``dim``,
    in rank order, on every rank of the axis."""
    mesh = mesh or _mesh.current_mesh()
    group = mesh.group(axis_name)
    if group is None:
        return x
    import torch.distributed as dist

    _count("all_gather", axis_name)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axis_name))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank of the world, in place."""
    import torch.distributed as dist

    if _mesh.world_size() == 0:
        return x
    _count("broadcast", "world")
    dist.broadcast(x, src)
    return x


def _f32(t: torch.Tensor) -> torch.Tensor:
    """Narrow floats widened to f32; f32 and f64 as they are."""
    return t if t.dtype in (torch.float32, torch.float64) else t.to(torch.float32)


def local_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.T @ b`` at the solver contractions' precision
    (``utils/precision.sdot_t``): true f32 (f64 operands: f64) by default,
    since the reference computes normal equations in f64 and a TF32 pass
    keeps about three decimal digits; one-pass TF32 on the card under
    ``KEYSTONE_SOLVER_PRECISION=default``, by the solver kernel.  Under
    true f32, TF32 is off unless a caller turned cuBLAS's global flag on,
    and then it is off for this product."""
    a, b = _f32(a), _f32(b)
    if precision.solver_precision() == "tf32" or not (a.is_cuda and torch.backends.cuda.matmul.allow_tf32):
        return precision.sdot_t(a, b)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a.T @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def sharded_matmul(a: torch.Tensor, b: torch.Tensor, out_spec: Optional[_mesh.Placement] = None,
                   mesh: Optional[_mesh.Mesh] = None) -> torch.Tensor:
    """``a.T @ b`` with the rows of ``a`` and ``b`` over 'data': the local
    product, then one all-reduce over the data axis.  This is the single
    communication pattern behind every reference solver (per-partition
    ``AᵀB`` gemm + treeReduce; nodes/learning/LinearMapper.scala §
    LinearMapEstimator).  Zero padding rows add nothing.  The result is
    replicated over 'data'; with ``out_spec`` cutting dim 1 over 'model',
    this rank keeps its model index's column slice."""
    mesh = mesh or _mesh.current_mesh()
    out = psum(local_matmul(a, b), _mesh.DATA_AXIS, mesh)
    if out_spec is not None and out_spec.model_dim is not None:
        out = _mesh.axis_part(out, out_spec.model_dim, mesh.model, mesh.model_index)
    return out


def sharded_gram(a: torch.Tensor, mesh: Optional[_mesh.Mesh] = None) -> torch.Tensor:
    """``a.T @ a`` (the Gramian) over row-sharded ``a``, replicated."""
    return sharded_matmul(a, a, mesh=mesh)


def global_argmax(keys: torch.Tensor, offset: int, axis_name: str = _mesh.DATA_AXIS,
                  mesh: Optional[_mesh.Mesh] = None) -> torch.Tensor:
    """The global index, a (1,) int64 tensor on ``keys``' device, of the
    largest key over every rank of the axis, this rank's keys being rows
    ``offset ..`` of the global order; ties go to the lower index, as
    ``torch.argmax`` takes the first.  Nothing waits on the host."""
    mesh = mesh or _mesh.current_mesh()
    local = torch.argmax(keys).reshape(1)
    idx = local + int(offset)
    group = mesh.group(axis_name)
    if group is None:
        return idx
    import torch.distributed as dist

    _count("argmax", axis_name)
    mine = keys.index_select(0, local).to(torch.float64)
    best = mine.clone()
    dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)
    # the ranks holding the best key offer its index, the others the largest
    cand = torch.where(mine == best, idx, torch.full_like(idx, torch.iinfo(torch.int64).max))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=group)
    return cand


def row_at(x: torch.Tensor, idx: torch.Tensor, offset: int, valid: int, axis_name: str = _mesh.DATA_AXIS,
           mesh: Optional[_mesh.Mesh] = None) -> torch.Tensor:
    """(1, d): global row ``idx`` ((1,) tensor) of rows spread over the
    axis, this rank's first ``valid`` rows of ``x`` being rows ``offset
    ..``: the owner's row, zeros elsewhere, all-reduced (O(d) on the link,
    never a gather of x; exact, every other term a zero)."""
    local = idx - int(offset)
    inside = ((local >= 0) & (local < int(valid))).to(x.dtype)
    row = x.index_select(0, local.clamp(0, max(x.shape[0] - 1, 0))) * inside[:, None]
    return psum(row, axis_name, mesh)


def gumbel_keys(weights: torch.Tensor, gen: torch.Generator, offset: int, valid: int, total: int) -> torch.Tensor:
    """Gumbel-max keys log(w + 1e-30) + G of this rank's rows: the noise
    G = −log(E), E ~ Exp(1), is drawn for all ``total`` global rows from
    ``gen`` (seeded alike on every rank) and rows ``offset .. offset +
    valid`` kept; rows past ``valid`` (a slice's padding) get −inf.  The
    +1e-30 is the reference's: rows of weight 0 still draw, last."""
    e = torch.empty((int(total),), dtype=weights.dtype, device=weights.device).exponential_(generator=gen)
    keys = torch.full_like(weights, float("-inf"))
    keys[:valid] = torch.log(weights[:valid] + 1e-30) - torch.log(e[offset:offset + valid])
    return keys


def categorical(weights: torch.Tensor, gen: torch.Generator, offset: int, valid: int, total: int,
                axis_name: str = _mesh.DATA_AXIS, mesh: Optional[_mesh.Mesh] = None) -> torch.Tensor:
    """A global row index ((1,) int64) drawn ∝ ``weights`` over the rows
    of every rank (this rank's: rows ``offset ..`` of ``total``)."""
    return global_argmax(gumbel_keys(weights, gen, offset, valid, total), offset, axis_name, mesh)
