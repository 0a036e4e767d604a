"""Transformer — the framework's single extension point (counterpart of
``keystone_tpu/workflow/transformer.py`` § Chainable, Transformer,
LambdaTransformer, transformer, Identity, Cacher).

Reference: workflow/Transformer.scala § Transformer[A,B] — a unary op
with ``apply(a: A): B`` plus ``apply(RDD[A]): RDD[B]``, ``andThen``
composition, and ``Transformer.apply(fn)`` for lambda nodes.

A transformer is an ``nn.Module``: its fitted tensors are registered
buffers (``register_buffer`` also takes None for an optional one), so
``.to(device)`` moves them and ``torch.save`` carries them.  ``apply_batch``
maps a batch ``xs`` (and, for ragged descriptor sets, an (n, T) mask) to a
batch; a stage that keeps the mask returns ``(out, mask)``, one that
reduces the sets to dense rows returns ``out``.  Called on a tensor, a
transformer applies its batch path (``forward``); on a ``Dataset`` it
applies ``apply_dataset``, in row chunks (on a ``StreamDataset``, batch
by batch, lazily); on a pipeline or a lazy result
it chains lazily, as the reference's ``__call__`` does.  A host
transformer (``is_host``: the text chain) maps Python objects item by
item, over a host list or a host stream, and records the chain it
belongs to (``_host_chain``).

The degradation declarations are the reference's: an ``optional`` stage
whose retry or deadline budget is spent, or whose circuit breaker is
open, passes its input through (Identity); one made by ``with_fallback``
applies its substitute instead (``workflow/executor.py``).  The
reference's jit caches (``_JIT_APPLY_CACHE``, ``traced_attrs``,
``stripped_template``) are XLA compile-cache machinery with no
counterpart here.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset

#: rows a chunk of ``Transformer.apply_dataset``.  The reference chunks at
#: 2048 rows to pin its compiled programs' shapes; here a chunk bounds a
#: stage's intermediates instead: SIFT's orientation map of 128 images at
#: 128 px is 67 MB, of the fit's 2048 images a gigabyte.  128 is the
#: scorer's batch, so a dataset's FV kernel launches are the scorer's.
APPLY_CHUNK_ROWS = 128


def tensor_identity(*tensors) -> tuple:
    """A fitted transformer's CSE identity: its tensors' object ids (None
    for an absent one).  Hashing their values would read them back from
    the device; a transformer holds its tensors, so while two nodes of a
    graph live their ids name their values."""
    return tuple(None if t is None else id(t) for t in tensors)


def iter_row_chunks(arr, mask):
    """Yield ``(rows, mask_rows, start)`` in chunks of ``APPLY_CHUNK_ROWS``
    rows (the last one shorter); ``mask_rows`` is None without a mask."""
    for i in range(0, arr.shape[0], APPLY_CHUNK_ROWS):
        yield arr[i:i + APPLY_CHUNK_ROWS], None if mask is None else mask[i:i + APPLY_CHUNK_ROWS], i


class Chainable:
    """Mixin providing ``and_then`` / ``__or__`` composition sugar."""

    def and_then(self, nxt, data=None, labels=None):
        from keystone_tpu_torch.workflow.pipeline import Pipeline

        return Pipeline.of(self).and_then(nxt, data=data, labels=labels)

    def __or__(self, nxt):
        return self.and_then(nxt)


class Transformer(nn.Module, Chainable):
    #: True for ops that run on host Python objects (e.g. tokenizers).
    is_host: bool = False
    #: False keeps the stage out of StageFusionRule's chains (ops that
    #: reduce ragged sets or read a whole dataset).
    fusable: bool = True
    #: graceful degradation (workflow/executor.py): an ``optional`` stage
    #: whose budget is spent, or whose breaker is open, is replaced by
    #: Identity; a ``fallback`` (set by ``with_fallback``) is applied
    #: instead.  Default: neither, and a failure propagates.
    optional: bool = False
    fallback: Optional["Transformer"] = None

    def with_fallback(self, substitute: "Transformer") -> "Transformer":
        """A copy of this transformer that degrades to ``substitute``: when
        the stage's failure budget (retries, deadline) is spent or its
        breaker is open, the executor applies ``substitute`` to the
        stage's input and records a ``degraded`` event instead of failing
        the run.  The copy shares this one's tensors; this one is left
        as it was."""
        c = copy.copy(self)
        # a shallow copy of a module shares its registries: give the copy
        # its own, so that nothing done to one reaches the other
        for reg in ("_parameters", "_buffers", "_modules"):
            c.__dict__[reg] = dict(self.__dict__[reg])
        # a plain attribute, not a submodule: the class default would
        # shadow a registered one
        object.__setattr__(c, "fallback", substitute)
        return c

    @property
    def label(self) -> str:
        return type(self).__name__

    # ---------------------------------------------------------- identity
    def params(self):
        """Hashable parameter tuple for CSE equality; None => never merged."""
        return None

    def signature(self):
        p = self.params()
        if p is None:
            return None
        sig = (type(self).__name__, p)
        if self.optional or self.fallback is not None:
            # degradation declarations are part of a node's identity: CSE
            # merging an optional node with a plain twin would widen (or
            # drop) the degradation contract
            fb = self.fallback
            sig = sig + ("degrade", self.optional, None if fb is None else (fb.signature() or id(fb)))
        return sig

    # Optimizer hook: physical-operator choice (workflow/NodeOptimizationRule).
    def choose_physical(self, sample) -> "Transformer":
        """The best physical implementation of this logical transformer
        given a data sample (shapes).  Default: self."""
        return self

    # ------------------------------------------------------------- apply
    def apply_batch(self, xs, mask=None):
        raise NotImplementedError(type(self).__name__)

    def apply_one(self, x):
        """One item: the batch path on a batch of one."""
        out = self.apply_batch(torch.as_tensor(x)[None])
        if isinstance(out, tuple):
            return tuple(o[0] for o in out)
        return out[0]

    def forward(self, xs, mask=None):
        return self.apply_batch(xs, mask=mask)

    def apply_dataset(self, ds: Dataset) -> Dataset:
        """The batch path over a dataset, ``APPLY_CHUNK_ROWS`` rows at a
        time (the counterpart of ``_apply_dataset_chunked``): a transformer
        is a per-item map, so chunk boundaries change no row.  Over a
        stream it is a lazy map, batch by batch as the stream is swept."""
        if isinstance(ds, StreamDataset):
            if ds.is_host:
                if not self.is_host:
                    raise TypeError(f"{self.label} is a device transformer; this stream carries host objects. "
                                    "Featurize to arrays first.")
                # item by item, batch by batch: the raw corpus never
                # materializes.  The reference fans large batches over a
                # process pool (utils/hostmap.py); here they map in turn
                out = ds.map_batches(lambda batch, _mask: [self.apply_one(x) for x in batch])
                return _with_host_chain(out, ds, self)
            if self.is_host:
                raise TypeError(f"{self.label} is a host transformer; streams carry device batches. "
                                "Featurize to arrays before streaming.")
            return ds.map_batches(self.apply_batch)
        if ds.is_host or self.is_host:
            out = [self.apply_one(x) for x in ds.items]
            if _stackable(out):
                return ds.with_array(torch.stack([torch.as_tensor(o) for o in out]))
            return _with_host_chain(ds.with_items(out), ds, self)
        arr, mask = ds.array, ds.mask
        if arr.shape[0] <= APPLY_CHUNK_ROWS:
            r = self.apply_batch(arr, mask=mask)
            return ds.with_array(*r) if isinstance(r, tuple) else ds.with_array(r)
        vals, masks = [], []
        for a, m, _ in iter_row_chunks(arr, mask):
            r = self.apply_batch(a, mask=m)
            if isinstance(r, tuple):  # (values, mask) for ragged producers
                vals.append(r[0])
                masks.append(r[1])
            else:
                vals.append(r)
        return ds.with_array(torch.cat(vals), mask=torch.cat(masks) if masks else None)

    def __call__(self, x, *args, **kwargs):
        if not isinstance(x, torch.Tensor):
            from keystone_tpu_torch.workflow.pipeline import Pipeline, PipelineDataset

            if isinstance(x, (Pipeline, PipelineDataset)):
                return Pipeline.of(self)(x)
            if isinstance(x, Dataset):
                return self.apply_dataset(x)
        return super().__call__(x, *args, **kwargs)


class LambdaTransformer(Transformer):
    """``Transformer.apply(fn)`` analogue: wrap a function as a node.
    Without ``batch_fn`` the batch path is ``torch.vmap(fn)``."""

    def __init__(self, fn: Callable, batch_fn: Optional[Callable] = None, name: str = "Lambda",
                 host: bool = False):
        super().__init__()
        self._fn = fn
        self._batch_fn = batch_fn
        self._name = name
        self.is_host = host

    @property
    def label(self):
        return self._name

    def apply_one(self, x):
        return self._fn(x)

    def apply_batch(self, xs, mask=None):
        if self._batch_fn is not None:
            return self._batch_fn(xs)
        return torch.vmap(self._fn)(xs)


def transformer(fn=None, *, batch=None, name=None, host=False):
    """Decorator/factory for lambda nodes: ``transformer(lambda x: x * 2)``."""

    def make(f):
        return LambdaTransformer(f, batch_fn=batch, name=name or getattr(f, "__name__", "Lambda"), host=host)

    if fn is not None:
        return make(fn)
    return make


class Identity(Transformer):
    def params(self):
        return ()

    def apply_one(self, x):
        return x

    def apply_batch(self, xs, mask=None):
        return xs if mask is None else (xs, mask)


class Cacher(Transformer):
    """Identity that marks a materialization point — the unit of the
    caching optimizer (nodes/util/Cacher.scala).  The executor memoizes
    every node's result, so here it is a stage boundary for the fusion
    rule and nothing more."""

    fusable = False

    def params(self):
        return None  # each Cacher is its own node; never CSE-merged away

    def apply_one(self, x):
        return x

    def apply_batch(self, xs, mask=None):
        return xs if mask is None else (xs, mask)

    def apply_dataset(self, ds: Dataset) -> Dataset:
        return ds.cache()


class GatherTransformer(Transformer):
    """Branches over one input, their dense outputs concatenated on the
    last axis (the eager counterpart of ``Pipeline.gather``'s
    GatherOperator: workflow/Pipeline.scala § GatherTransformer)."""

    fusable = False

    def __init__(self, branches: Sequence[Transformer]):
        super().__init__()
        self.branches = nn.ModuleList(branches)

    @property
    def label(self) -> str:
        return "Gather[" + ", ".join(b.label for b in self.branches) + "]"

    def apply_batch(self, xs, mask=None):
        outs = []
        for b in self.branches:
            out = b.apply_batch(xs, mask=mask)
            if isinstance(out, tuple):
                raise ValueError(f"gather needs dense branch outputs; {b.label} kept a mask")
            outs.append(out)
        return torch.cat(outs, dim=-1)


def _with_host_chain(out: Dataset, ds: Dataset, t: Transformer) -> Dataset:
    """``out`` with its provenance: the base raw dataset (or stream) and
    the host transformers applied since, so that a featurizer can re-run
    the whole chain natively from the raw documents (``ops/nlp_native.py``)."""
    base, stages = getattr(ds, "_host_chain", None) or (ds, ())
    out._host_chain = (base, stages + (t,))
    return out


def _stackable(out) -> bool:
    return (
        len(out) > 0
        and all(isinstance(o, torch.Tensor) for o in out)
        and len({tuple(o.shape) for o in out}) == 1
    )
