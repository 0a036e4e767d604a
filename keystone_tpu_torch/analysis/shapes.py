"""Pass (a): abstract shape and dtype interpretation of the workflow graph
(counterpart of ``keystone_tpu/analysis/shapes.py``).

The reference rejects a mis-wired ``Transformer`` chain at compile time;
here the same walk runs ahead of the fit with *abstract* values: every
dataset literal (and the open source, when the caller gives an example)
becomes an :class:`Aval` (shape, dtype, device), and each device
transformer is pushed through its ``apply_batch`` on fake tensors
(``FakeTensorMode``, as ``workflow/profiling.stage_cost`` prices a
stage: shapes and dtypes, no storage), so stage-to-stage
incompatibilities surface as findings before any device work.  The walk
allocates nothing on the device and launches no kernel: the stages that
launch hand-written kernels (the Fisher-vector and gram stages, whose
wrappers refuse fake tensors) and the eager chains that hold them have
explicit cases that compute their output shapes from their fitted
tensors' shapes, and a stream on the card is not peeked (a peek would
copy a batch to the card): its rows are unknown.

Abstract values (per graph id):

- :class:`ArrayVal`: a device batch (an :class:`Aval` and an optional
  ragged-mask aval), as ``Dataset.array`` / ``Dataset.mask``;
- :class:`HostVal`: a host payload (text, term dicts); ``stream=True``
  marks a host StreamDataset, whose device-transformer consumers raise at
  run time (``Transformer.apply_dataset``) and are errors here;
- :class:`FittedVal`: an estimator node's output (opaque: the fitted
  transformer's output shape is a property of training);
- :data:`UNKNOWN`: propagation gave up (host maps, data-dependent
  stages); nothing downstream of UNKNOWN is reported, so giving up is
  silent, never a false positive.

Findings:

- ``shape-mismatch`` (error): the fake walk failed with a shape, size or
  dtype complaint, or a Fisher-vector stage's input width disagrees with
  its PCA or GMM: the stage cannot accept what its predecessor emits;
- ``not-unary`` / ``bad-delegate`` / ``missing-labels`` /
  ``unfitted-estimator`` / ``gather-host`` / ``gather-mismatch`` /
  ``bad-wiring`` / ``host-stream-device-stage`` (errors): structural
  mis-wirings the executor would hit only at run time;
- ``kernel-shape-mismatch`` / ``kernel-bad-state`` /
  ``bad-kernel-generator`` (errors): the kernel tier's explicit case;
- ``dtype-downcast`` (warning): float64 data entering the graph (a
  source, a dataset literal, a datum) that a stage downstream narrows.
  Torch keeps float64 where it is given it, so the narrowing happens only
  where a port stage casts (``PCATransformer`` computes in f32, the
  kernels read f32 or bf16); the finding is anchored where the wide data
  enters, as the reference's is, and names the stage that narrows it.
  Integers are never narrowed by the port (its default integer is int64);
- ``stage-downcast`` (warning): a stage emits a lower-precision float
  than it consumes (f64→f32, f32→bf16);
- ``gather-promotion`` (warning): gather branches disagree on dtype, so
  the concatenation silently promotes.

Stages that cannot run on fake tensors (host numpy, data-dependent
Python) degrade to UNKNOWN with a debug log, not a finding: the
analyzer's false-positive gate (zero findings over every bundled
pipeline) is part of its contract.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from keystone_tpu_torch.analysis.findings import PASS_SHAPES, Finding
from keystone_tpu_torch.workflow import graph as G

logger = logging.getLogger(__name__)


class Aval(NamedTuple):
    """An abstract tensor: shape, dtype and device, no data."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device = torch.device("cpu")


# ------------------------------------------------------- abstract values
class _Abstract:
    pass


@dataclasses.dataclass(frozen=True)
class ArrayVal(_Abstract):
    aval: Aval
    mask: Optional[Aval] = None
    #: (node id or None, label) where float64 data entered the graph, while
    #: it is still float64 (the dtype-downcast anchor)
    wide_from: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class HostVal(_Abstract):
    stream: bool = False


@dataclasses.dataclass(frozen=True)
class FittedVal(_Abstract):
    label: str = ""


class _Unknown(_Abstract):
    def __repr__(self):
        return "UNKNOWN"


UNKNOWN = _Unknown()

#: substrings that make a fake-walk failure a wiring error rather than
#: mere untraceability (torch's shape errors are RuntimeError, TypeError,
#: ValueError or IndexError mentioning one of these)
_SHAPE_ERROR_MARKERS = (
    "shape",
    "size",
    "dimension",
    "rank",
    "dtype",
    "broadcast",
    "multiplied",
    "must match",
    "reduction dim",
    "incompatible",
    "concatenat",
    "ndim",
    "out of range",
)

#: substrings of failures that only say the stage cannot run on fake
#: tensors (data-dependent Python, a host read, a kernel wrapper)
_UNTRACEABLE_MARKERS = (
    "fake",
    "tensor subclass",
    "data-dependent",
    "data dependent",
    "_local_scalar_dense",
    "data pointer",
    "data_ptr",
    "storage",
    "numpy",
    "nonzero",
)

_WIDE = (torch.float64, torch.complex128)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _aval_of(t) -> Aval:
    """The abstract value of a tensor or array (nothing read, nothing
    moved)."""
    if isinstance(t, torch.Tensor):
        return Aval(tuple(t.shape), t.dtype, t.device)
    arr = np.asarray(t) if not hasattr(t, "dtype") else t
    return Aval(tuple(arr.shape), torch.from_numpy(np.zeros((), np.dtype(str(arr.dtype)))).dtype)


def source_abstract(example, device=None) -> _Abstract:
    """Abstract value of the pipeline's open source from a caller example:
    a Dataset, a batch tensor or array, an :class:`Aval`, or a per-item
    shape tuple (a batch of four float32 items on ``device`` is
    assumed)."""
    from keystone_tpu_torch.workflow.dataset import Dataset

    if example is None:
        return UNKNOWN
    if isinstance(example, _Abstract):
        return example
    dev = torch.device("cpu" if device is None else device)
    if isinstance(example, Dataset):
        return _dataset_abstract(example)
    if isinstance(example, Aval):
        return ArrayVal(example)
    if isinstance(example, tuple) and all(isinstance(d, int) for d in example):
        return ArrayVal(Aval((4,) + example, torch.float32, dev))
    if isinstance(example, torch.Tensor):
        return ArrayVal(_aval_of(example))
    if hasattr(example, "shape") and hasattr(example, "dtype"):
        a = _aval_of(example)
        return ArrayVal(Aval(a.shape, a.dtype, dev))
    if isinstance(example, list):  # a host payload example (texts)
        return HostVal()
    return UNKNOWN


def _wide(aval: Aval, node, label) -> Optional[tuple]:
    return (None if node is None else node.id, label) if aval.dtype in _WIDE else None


def _dataset_abstract(ds, node=None, label=None) -> _Abstract:
    """Abstract value of a bound dataset.  A stream on the CPU is peeked
    (one host batch: the price of validating an out-of-core pipeline); a
    stream on the card is not (the peek would copy a batch there)."""
    from keystone_tpu_torch.workflow.dataset import StreamDataset

    if isinstance(ds, StreamDataset):
        if ds.is_host:
            return HostVal(stream=True)
        if ds.device.type != "cpu":
            return UNKNOWN
        try:
            for arr, mask in ds.device_batches():
                aval = _aval_of(arr)
                return ArrayVal(aval, None if mask is None else _aval_of(mask), _wide(aval, node, label))
            return UNKNOWN  # an empty stream: nothing to propagate
        except Exception as e:
            logger.debug("stream peek failed for %s: %s", label, e)
            return UNKNOWN
    if ds.is_host:
        return HostVal()
    aval = _aval_of(ds.array)
    return ArrayVal(aval, None if ds.mask is None else _aval_of(ds.mask), _wide(aval, node, label))


_FLOAT_ORDER = {torch.bfloat16: 16, torch.float16: 16, torch.float32: 32, torch.float64: 64}


@contextmanager
def _quiet_fake_tensor_log():
    """Fake tensors log every failed op at error level; a failed stage is
    this pass's finding (or its silence), not a log line."""
    lg = logging.getLogger("torch._subclasses.fake_tensor")
    prev = lg.level
    lg.setLevel(logging.CRITICAL)
    try:
        yield
    finally:
        lg.setLevel(prev)


def _fake_apply(t, val: "ArrayVal"):
    """``t.apply_batch`` on fake tensors of ``val``'s avals: the output's
    (aval, mask aval or None)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with _quiet_fake_tensor_log(), FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(val.aval.shape, dtype=val.aval.dtype, device=val.aval.device)
        if val.mask is not None:
            m = torch.empty(val.mask.shape, dtype=val.mask.dtype, device=val.mask.device)
            out = t.apply_batch(x, mask=m)
        else:
            out = t.apply_batch(x)
        if isinstance(out, tuple) and len(out) == 2:
            return _aval_of(out[0]), None if out[1] is None else _aval_of(out[1])
        return _aval_of(out), None


def _untraceable(e: BaseException) -> bool:
    from torch._subclasses import fake_tensor as ft

    kinds = tuple(getattr(ft, k) for k in ("DataDependentOutputException", "DynamicOutputShapeException",
                                            "UnsupportedOperatorException", "UnsupportedFakeTensorException")
                  if hasattr(ft, k))
    if isinstance(e, kinds):
        return True
    low = str(e).lower()
    return any(k in low for k in _UNTRACEABLE_MARKERS)


def _finish(t, label, val: "ArrayVal", out: Aval, out_mask, node, findings: List[Finding]) -> "ArrayVal":
    """The stage's output value, with its narrowing findings."""
    in_dt, out_dt = val.aval.dtype, out.dtype
    narrowed = (in_dt in _FLOAT_ORDER and out_dt in _FLOAT_ORDER and _FLOAT_ORDER[out_dt] < _FLOAT_ORDER[in_dt])
    wide_from = val.wide_from if out_dt in _WIDE else None
    if narrowed:
        if val.wide_from is not None:
            src_node, src_label = val.wide_from
            findings.append(Finding(
                "warning", PASS_SHAPES, "dtype-downcast",
                f"{_dtype_name(in_dt)} data entering here is narrowed to {_dtype_name(out_dt)} by {label} "
                f"(n{node.id}); torch keeps float64 until a stage casts: cast explicitly where the narrowing "
                "is intended",
                node=src_node, label=src_label))
        findings.append(Finding(
            "warning", PASS_SHAPES, "stage-downcast",
            f"{label} narrows {_dtype_name(in_dt)} input to {_dtype_name(out_dt)} output: silent precision "
            "loss unless the stage is under an explicit precision policy",
            node=node.id, label=label))
    return ArrayVal(out, out_mask, wide_from)


def _apply_transformer_abstract(t, val: _Abstract, node, findings: List[Finding]) -> _Abstract:
    """Push one transformer over an abstract input, as
    ``Transformer.apply_dataset`` dispatches."""
    from keystone_tpu_torch.workflow.transformer import Cacher

    label = t.label
    if isinstance(t, Cacher):  # a materialization barrier: identity
        return val
    if isinstance(val, _Unknown):
        return UNKNOWN
    if isinstance(val, FittedVal):
        findings.append(Finding("error", PASS_SHAPES, "bad-wiring",
                                f"{label} is applied to a fitted-transformer value; transformers consume datasets",
                                node=node.id, label=label))
        return UNKNOWN
    if t.is_host:
        # a host transformer maps apply_one over items: its output shape
        # is a property of the host code
        return HostVal(stream=isinstance(val, HostVal) and val.stream)
    if isinstance(val, HostVal):
        if val.stream:
            # Transformer.apply_dataset raises exactly this at run time
            findings.append(Finding("error", PASS_SHAPES, "host-stream-device-stage",
                                    f"{label} is a device transformer but its input is a host-payload stream; "
                                    "featurize to arrays first", node=node.id, label=label))
            return UNKNOWN
        return UNKNOWN  # in-memory host items: applied per item, shape opaque
    assert isinstance(val, ArrayVal)
    # the stages that launch hand-written kernels, and the eager chains
    # that may hold them, get explicit cases: their wrappers refuse fake
    # tensors, and the out-of-core mapper would read its store's blocks
    for case in (_kernel_case, _fv_case, _chain_case):
        out = case(t, val, node, findings)
        if out is not None:
            return out
    try:
        out, out_mask = _fake_apply(t, val)
    except Exception as e:
        msg = str(e)
        low = msg.lower()
        if _untraceable(e):
            logger.debug("stage %s is unanalyzable on fake tensors: %s", label, e)
            return UNKNOWN
        if isinstance(e, (RuntimeError, TypeError, ValueError, IndexError)) and any(
                k in low for k in _SHAPE_ERROR_MARKERS):
            findings.append(Finding(
                "error", PASS_SHAPES, "shape-mismatch",
                f"{label} cannot accept input {tuple(val.aval.shape)}:{_dtype_name(val.aval.dtype)}: "
                + (msg.splitlines()[0] if msg else type(e).__name__)[:300],
                node=node.id, label=label))
        else:
            logger.debug("stage %s is unanalyzable: %s", label, e)
        return UNKNOWN
    return _finish(t, label, val, out, out_mask, node, findings)


def _fv_case(t, val: ArrayVal, node, findings: List[Finding]) -> Optional[_Abstract]:
    """The Fisher-vector stages (``FisherVector``: B2 on the card,
    ``FusedPcaFisherVector``: B1): (n, T, d[_in]) with a mask → (n, 2·K·d)
    float32, their input width checked against the fitted PCA and GMM.
    None when ``t`` is neither."""
    from keystone_tpu_torch.ops.fisher import FisherVector, FusedPcaFisherVector

    if not isinstance(t, (FisherVector, FusedPcaFisherVector)):
        return None
    label = t.label
    k, d = (int(s) for s in t.gmm.means.shape)
    if isinstance(t, FusedPcaFisherVector):
        d_in, d_pca = (int(s) for s in t.components.shape)
        want, what = d_in, "its PCA's input width"
        if d_pca != d:
            findings.append(Finding("error", PASS_SHAPES, "shape-mismatch",
                                    f"{label} projects to {d_pca} dims but its GMM has {d}", node=node.id,
                                    label=label))
            return UNKNOWN
    else:
        want, what = d, "its GMM's width"
    shape = tuple(val.aval.shape)
    if len(shape) not in (2, 3) or shape[-1] != want:
        findings.append(Finding("error", PASS_SHAPES, "shape-mismatch",
                                f"{label} cannot accept input {shape}:{_dtype_name(val.aval.dtype)}: descriptors "
                                f"of {shape[-1] if shape else None} dims against {what}, {want}", node=node.id,
                                label=label))
        return UNKNOWN
    lead = shape[:1] if len(shape) == 3 else ()
    return _finish(t, label, val, Aval(lead + (2 * k * d,), torch.float32, val.aval.device), None, node, findings)


def _chain_case(t, val: ArrayVal, node, findings: List[Finding]) -> Optional[_Abstract]:
    """The eager chains (``FusedTransformer``: stages in turn, the mask
    threaded; ``GatherTransformer``: branches over one input, their dense
    outputs concatenated), walked stage by stage.  None when ``t`` is
    neither."""
    from keystone_tpu_torch.workflow.optimizer import FusedTransformer
    from keystone_tpu_torch.workflow.transformer import GatherTransformer

    if isinstance(t, FusedTransformer):
        cur: _Abstract = val
        for s in t.stages:
            cur = _apply_transformer_abstract(s, cur, node, findings)
        return cur
    if isinstance(t, GatherTransformer):
        outs = [_apply_transformer_abstract(b, val, node, findings) for b in t.branches]
        return _gather_abstract(outs, node, findings)
    return None


def check_kernel_generator(kg, findings: List[Finding], node, label) -> bool:
    """Validate a Gaussian kernel generator's γ: a non-finite or
    non-positive γ makes the kernel degenerate (exp(0) = 1 everywhere) and
    the sweep converges to garbage silently.  Returns True when a finding
    was emitted."""
    gamma = getattr(kg, "gamma", None)
    if gamma is None:
        return False
    try:
        g = float(gamma)
    except (TypeError, ValueError):
        g = float("nan")
    if not math.isfinite(g) or g <= 0.0:
        findings.append(Finding(
            "error", PASS_SHAPES, "bad-kernel-generator",
            f"{label} carries a GaussianKernelGenerator with gamma={gamma!r}; γ must be a finite positive scalar "
            "or every kernel value degenerates to exp(0)=1",
            node=None if node is None else node.id, label=label))
        return True
    return False


def _kernel_case(t, val: ArrayVal, node, findings: List[Finding]) -> Optional[_Abstract]:
    """The kernel tier's fitted mappers (``KernelBlockLinearMapper``,
    ``OutOfCoreKernelBlockLinearMapper``, ``NystromFeatureMap``): None when
    ``t`` is none of them, else the abstract output after the checks the
    fake walk cannot make: the fitted state's consistency, the disk store's
    feature dim (its metadata only, never a block) and the generator."""
    from keystone_tpu_torch.models.kernel_ridge import KernelBlockLinearMapper, OutOfCoreKernelBlockLinearMapper
    from keystone_tpu_torch.models.nystrom import NystromFeatureMap

    if not isinstance(t, (KernelBlockLinearMapper, OutOfCoreKernelBlockLinearMapper, NystromFeatureMap)):
        return None
    label = t.label
    bad = check_kernel_generator(t.kernel_gen, findings, node, label)
    d_in = int(val.aval.shape[-1]) if len(val.aval.shape) else None

    def mismatch(train_d, what):
        findings.append(Finding("error", PASS_SHAPES, "kernel-shape-mismatch",
                                f"{label} computes kernels against {what} with {train_d} features but its input "
                                f"carries {d_in}", node=node.id, label=label))

    out_dev = val.aval.device
    if isinstance(t, NystromFeatureMap):
        m, train_d = (int(s) for s in t.landmarks.shape)
        if d_in is not None and d_in != train_d:
            mismatch(train_d, "landmarks")
            return UNKNOWN
        if tuple(int(s) for s in t.whiten.shape) != (m, m):
            findings.append(Finding("error", PASS_SHAPES, "kernel-bad-state",
                                    f"{label} whitening is {tuple(t.whiten.shape)} for {m} landmarks; the fitted "
                                    "state is inconsistent", node=node.id, label=label))
            return UNKNOWN
        if bad:
            return UNKNOWN
        return ArrayVal(Aval(tuple(val.aval.shape[:-1]) + (m,), torch.float32, out_dev))

    if isinstance(t, KernelBlockLinearMapper):
        rows, train_d = (int(s) for s in t.train_x.shape)
        alpha_rows, k = (int(s) for s in t.alpha.shape)
    else:  # out of core: the store's metadata only, never its blocks
        try:
            st = t._store()
            rows, train_d = st.num_blocks * st.block_size, st.d
        except Exception as e:
            findings.append(Finding("error", PASS_SHAPES, "kernel-bad-state",
                                    f"{label} cannot open its backing row-block store ({t.store_directory}): {e} "
                                    "— the store is part of the fitted model and must outlive it",
                                    node=node.id, label=label))
            return UNKNOWN
        alpha_rows, k = (int(s) for s in t.alpha.shape)
    if alpha_rows != rows:
        findings.append(Finding("error", PASS_SHAPES, "kernel-bad-state",
                                f"{label} holds α with {alpha_rows} rows against {rows} train rows; the fitted "
                                "state is inconsistent", node=node.id, label=label))
        return UNKNOWN
    if d_in is not None and d_in != train_d:
        mismatch(train_d, "the train rows")
        return UNKNOWN
    if bad:
        return UNKNOWN
    return ArrayVal(Aval(tuple(val.aval.shape[:-1]) + (k,), torch.float32, out_dev))


def _gather_abstract(vals, node, findings: List[Finding]) -> _Abstract:
    if any(isinstance(v, _Unknown) for v in vals):
        return UNKNOWN
    if any(isinstance(v, (HostVal, FittedVal)) for v in vals):
        findings.append(Finding("error", PASS_SHAPES, "gather-host",
                                "gather requires device-array branches; a branch produces a host (or "
                                "fitted-transformer) payload", node=node.id, label="Gather"))
        return UNKNOWN
    shapes = [tuple(v.aval.shape) for v in vals]
    ranks = {len(s) for s in shapes}
    leads = {s[:-1] for s in shapes}
    if len(ranks) > 1 or len(leads) > 1:
        findings.append(Finding("error", PASS_SHAPES, "gather-mismatch",
                                f"gather branches disagree on shape outside the feature axis: {sorted(set(shapes))}",
                                node=node.id, label="Gather"))
        return UNKNOWN
    dtypes = {v.aval.dtype for v in vals}
    if len(dtypes) > 1:
        findings.append(Finding("warning", PASS_SHAPES, "gather-promotion",
                                f"gather branches disagree on dtype {sorted(_dtype_name(d) for d in dtypes)}; the "
                                "concatenation silently promotes", node=node.id, label="Gather"))
    dt = vals[0].aval.dtype
    for v in vals[1:]:
        dt = torch.promote_types(dt, v.aval.dtype)
    wide = next((v.wide_from for v in vals if v.wide_from is not None), None) if dt in _WIDE else None
    return ArrayVal(Aval(shapes[0][:-1] + (sum(s[-1] for s in shapes),), dt, vals[0].aval.device), None, wide)


def _literal_abstract(data, node, label) -> _Abstract:
    """A bound dataset literal's abstract value, read without moving it
    (``as_dataset`` would put a numpy array on the card)."""
    from keystone_tpu_torch.workflow.dataset import Dataset

    if isinstance(data, Dataset):
        return _dataset_abstract(data, node=node, label=label)
    if isinstance(data, torch.Tensor) or (hasattr(data, "shape") and hasattr(data, "dtype")):
        aval = _aval_of(data)
        return ArrayVal(aval, None, _wide(aval, node, label))
    if isinstance(data, (list, tuple)):
        return HostVal()
    return UNKNOWN


def run(graph: G.Graph, sources: Optional[Dict[G.SourceId, _Abstract]] = None, mode: str = "fit") -> List[Finding]:
    """Walk ``graph`` with abstract values.  ``sources`` seeds the open
    sources (unseeded ones propagate UNKNOWN).  ``mode="apply"`` also makes
    any remaining EstimatorOperator an error (the freeze and serve
    contract: an unfitted pipeline cannot be applied)."""
    from keystone_tpu_torch.workflow.estimator import LabelEstimator

    findings: List[Finding] = []
    values: Dict[object, _Abstract] = {}
    for s in graph.sources:
        v = (sources or {}).get(s, UNKNOWN)
        if isinstance(v, ArrayVal) and v.aval.dtype in _WIDE and v.wide_from is None:
            v = dataclasses.replace(v, wide_from=(None, f"source {s.id}"))
        values[s] = v

    for n in graph.topological_nodes():
        op = graph.operators[n]
        deps = graph.dependencies[n]
        dvals = [values.get(d, UNKNOWN) for d in deps]
        out: _Abstract = UNKNOWN
        if isinstance(op, G.DatasetOperator):
            try:
                out = _literal_abstract(op.dataset, n, op.label())
            except Exception as e:
                logger.debug("dataset literal unanalyzable at %s: %s", n, e)
        elif isinstance(op, G.DatumOperator):
            datum = op.datum
            if hasattr(datum, "shape") and hasattr(datum, "dtype"):
                a = _aval_of(datum)
                aval = Aval((1,) + a.shape, a.dtype, a.device)
                out = ArrayVal(aval, None, _wide(aval, n, op.label()))
            else:
                out = HostVal()
        elif isinstance(op, G.TransformerOperator):
            if len(deps) != 1:
                findings.append(Finding("error", PASS_SHAPES, "not-unary",
                                        f"{op.label()} has {len(deps)} dependencies; transformers are unary",
                                        node=n.id, label=op.label()))
            else:
                out = _apply_transformer_abstract(op.transformer, dvals[0], n, findings)
        elif isinstance(op, G.EstimatorOperator):
            # kernel estimators carry their generator before the fit: a
            # degenerate γ fails here, not after an epoch of sweeps
            kg = getattr(op.estimator, "kernel_gen", None)
            if kg is not None:
                check_kernel_generator(kg, findings, n, op.label())
            if mode == "apply":
                findings.append(Finding("error", PASS_SHAPES, "unfitted-estimator",
                                        f"{op.label()} is unfitted; fit() the pipeline before freezing or "
                                        "applying it", node=n.id, label=op.label()))
            if isinstance(op.estimator, LabelEstimator) and len(deps) < 2:
                findings.append(Finding("error", PASS_SHAPES, "missing-labels",
                                        f"{op.label()} is a LabelEstimator but its node has no labels dependency",
                                        node=n.id, label=op.label()))
            if dvals and isinstance(dvals[0], FittedVal):
                findings.append(Finding("error", PASS_SHAPES, "bad-wiring",
                                        f"{op.label()} consumes a fitted-transformer value; estimators fit on "
                                        "datasets", node=n.id, label=op.label()))
            out = FittedVal(label=op.label())
        elif isinstance(op, G.DelegatingOperator):
            if not dvals or not isinstance(dvals[0], FittedVal):
                # dependency 0 must be the estimator's output; anything
                # else is the unfitted-estimator-reference class (the
                # executor raises TypeError at run time)
                if not (dvals and isinstance(dvals[0], _Unknown)):
                    findings.append(Finding("error", PASS_SHAPES, "bad-delegate",
                                            "delegating apply expects a fitted transformer as dependency 0 "
                                            "(unfitted-estimator reference?)", node=n.id, label=op.label()))
            out = UNKNOWN  # a fitted output's shape is a training property
        elif isinstance(op, G.GatherOperator):
            out = _gather_abstract(dvals, n, findings)
        values[n] = out
    return _dedup(findings)


def _dedup(findings: List[Finding]) -> List[Finding]:
    """One dtype-downcast a source (each narrowing stage reports its own
    stage-downcast)."""
    seen, out = set(), []
    for f in findings:
        key = (f.code, f.node, f.label) if f.code == "dtype-downcast" else None
        if key is not None:
            if key in seen:
                continue
            seen.add(key)
        out.append(f)
    return out
