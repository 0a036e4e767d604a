"""Collective helpers, the treeReduce/treeAggregate replacements
(counterpart of ``keystone_tpu/parallel/collectives.py`` § psum, pmean,
tree_psum, sharded_matmul, sharded_gram).

The reference's only collectives are Spark ``treeReduce``/``treeAggregate``
(per-partition Gramians, gradients and moments summed to the driver) and
``broadcast`` (SURVEY.md §2.9).  Here each is one ``torch.distributed``
call over a mesh axis's group (``parallel/mesh.py``): NCCL on the card,
Gloo on the CPU.  On the local mesh every helper is the identity and
calls nothing.  ``COUNTS`` counts the calls made, by kind.
"""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.parallel import mesh as _mesh

#: collectives issued since ``reset_counts``, by kind (the local mesh's
#: identities are not counted)
COUNTS = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _count(kind: str, axis: str) -> None:
    from keystone_tpu_torch.obs import metrics

    COUNTS[kind] += 1
    metrics.inc(f"parallel.{kind}", axis=axis)


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
    """``a.T @ b`` in true f32 (f64 operands: f64): the solver
    contractions' precision (the reference computes normal equations in
    f64; a TF32 pass keeps about three decimal digits).  TF32 is off
    unless a caller turned it on, and then it is off for this product."""
    a, b = _f32(a), _f32(b)
    if not (a.is_cuda and torch.backends.cuda.matmul.allow_tf32):
        return a.T @ b
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
