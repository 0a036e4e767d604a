"""The sampling-based cost model: time the candidates, fit curves, pick
winners (counterpart of ``keystone_tpu/planner/cost.py``).

The KeystoneML optimizer loop (ICDE 2017 §4) in miniature: at
``freeze()``, each stage with more than one physical candidate runs on a
few **sampled batch sizes** (rows drawn from the caller's example,
wall-timed, best of two), a linear cost curve ``seconds ≈ a + b·n`` is
fitted per candidate, and the candidate cheapest at the serving batch
size wins.  Winners plus the serving knobs derived from the forward's
curve land in one :class:`~keystone_tpu_torch.planner.plan.PhysicalPlan`.

On the card the ``fused_fv`` gate is the one place where the port times
its own kernels against each other on the user's data: the fused forward
(B1) against PCA then the FV encode (B2), each sampled as
``FvFusionRule`` would install it (where a normalizing ``SIFTExtractor``
feeds the PCA alone, B1 absorbs the normalize and reads the raw
descriptors; the chain normalizes, then PCA, then B2).  ``gram_pallas``
has one candidate on either backend and is pinned, never sampled
(``registry``'s docstring).  The ``matmul`` stage times the whole
forward as it stands, the curve the serving knobs come from.

Determinism: sample indices come from ``np.random.default_rng(seed)``
and candidates are enumerated in the registry's order, so with an
injected ``runner`` (tests) the plan is a pure function of its inputs, as
the reference's is.  The default runner times real executions between
two ``torch.cuda.synchronize()`` calls; each timed run passes the
``plan.sample`` fault site (ctx ``gate=/candidate=/n=``), so an injected
delay inflates exactly one candidate's samples.

Nothing hides a failure here: a candidate that does not run (a kernel
that does not build or launch) fails the plan build with the error, where
the reference records it unsupported and keeps sampling.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch import faults
from keystone_tpu_torch.planner import registry
from keystone_tpu_torch.planner.plan import CandidateCost, PhysicalPlan, StageChoice, stage_signature

logger = logging.getLogger(__name__)

#: a non-default candidate must beat the default by more than this
#: fraction to displace it (sampling noise must not flip a default on a
#: coin toss)
TIE_MARGIN = 0.02


class PlanSamplingError(RuntimeError):
    """A candidate failed to run while the cost model sampled it."""


def fit_curve(samples: Sequence[Tuple[int, float]]) -> Tuple[float, float]:
    """Least-squares ``seconds ≈ a + b·n`` over ``[(n, seconds), ...]``;
    degenerate sample sets collapse to a flat curve through the mean."""
    if not samples:
        return (0.0, 0.0)
    ns = np.asarray([float(n) for n, _ in samples])
    ts = np.asarray([float(t) for _, t in samples])
    if len(samples) == 1 or float(np.ptp(ns)) == 0.0:
        return (float(ts.mean()), 0.0)
    b = float(np.cov(ns, ts, bias=True)[0, 1] / np.var(ns))
    a = float(ts.mean() - b * ns.mean())
    return (max(0.0, a), max(0.0, b))


def price(coeffs: Tuple[float, float], n: int) -> float:
    return float(coeffs[0] + coeffs[1] * float(n))


def _sync() -> None:
    """Wait for the queued device work: the timed region ends when the
    candidate's kernels have run, not when they were queued."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def wall_runner(fn: Callable[[], object], *, gate: str, candidate: str, n: int, reps: int = 2) -> float:
    """Best-of-``reps`` wall seconds for one candidate at batch ``n``,
    each rep between two device synchronizes.  A first untimed call
    absorbs first-use costs (a kernel's shared-memory attributes, the
    allocator's first blocks); each timed rep passes the ``plan.sample``
    fault site."""
    fn()
    _sync()
    best: Optional[float] = None
    for _ in range(max(1, int(reps))):
        t0 = time.perf_counter()
        faults.fault_point("plan.sample", gate=gate, candidate=candidate, n=int(n))
        fn()
        _sync()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return float(best)


def _sample_batch(arr, n: int, rng):
    """``n`` rows drawn with replacement from ``arr`` (a tensor, or an
    ``(array, mask)`` pair): deterministic under the plan seed."""
    base = arr[0] if isinstance(arr, tuple) else arr
    rows = max(1, int(base.shape[0]))
    idx = torch.as_tensor(rng.integers(0, rows, size=int(n)), device=base.device)
    if isinstance(arr, tuple):
        return tuple(None if a is None else a[idx] for a in arr)
    return arr[idx]


def _pick_winner(gate: str, candidates: Dict[str, CandidateCost]) -> Tuple[str, str]:
    """(winner, why): cheapest at full batch, the static default keeping
    ties (:data:`TIE_MARGIN`)."""
    order = [c for c in registry.GATES[gate]["candidates"] if c in candidates]
    runnable = [c for c in order if candidates[c].supported]
    if not runnable:
        return order[0], "no runnable candidate; static default retained"
    if len(runnable) == 1:
        return runnable[0], "single supported candidate on this backend"
    default = runnable[0]
    best = min(runnable, key=lambda c: candidates[c].full_seconds)
    d_cost = candidates[default].full_seconds
    b_cost = candidates[best].full_seconds
    if best != default and d_cost > 0 and (d_cost - b_cost) / d_cost <= TIE_MARGIN:
        return default, f"{best} within {TIE_MARGIN:.0%} of default; default retained"
    if best == default:
        return default, f"default cheapest at n=full ({b_cost * 1e3:.3f}ms)"
    return best, f"beats {default} at full batch ({b_cost * 1e3:.3f}ms vs {d_cost * 1e3:.3f}ms)"


def _sample_gate(gate: str, label: str, signature: str, cand_fns: Dict[str, Optional[Callable]], input_arr,
                 batch_sizes: Sequence[int], full_batch: int, rng, runner: Callable[..., float]) -> StageChoice:
    """Time every candidate of one gate at every sampled batch size and
    choose.  A candidate mapped to None is recorded unsupported; one that
    raises fails the build (:class:`PlanSamplingError`)."""
    costs: Dict[str, CandidateCost] = {}
    for cand, fn in cand_fns.items():
        cc = CandidateCost(name=cand)
        if fn is None:
            cc.supported = False
            cc.note = "not runnable on this backend"
            cc.full_seconds = float("inf")
            costs[cand] = cc
            continue
        for n in batch_sizes:
            x = _sample_batch(input_arr, n, rng)
            try:
                with registry.forced(gate, cand):
                    secs = runner(lambda x=x, fn=fn: fn(x), gate=gate, candidate=cand, n=n)
            except faults.FaultInjected:
                raise
            except Exception as e:
                raise PlanSamplingError(f"plan sampling of {gate}/{cand} at n={n} failed: "
                                        f"{type(e).__name__}: {e}") from e
            cc.samples.append([int(n), float(secs)])
        cc.coeffs = fit_curve(cc.samples)
        cc.full_seconds = price(cc.coeffs, full_batch)
        costs[cand] = cc
    winner, why = _pick_winner(gate, costs)
    # JSON has no Infinity: unsupported candidates price as 0, their
    # supported=False flag carrying the meaning
    for cc in costs.values():
        if not np.isfinite(cc.full_seconds):
            cc.full_seconds = 0.0
    return StageChoice(gate=gate, signature=signature, label=label, winner=winner, why=why,
                       candidates=[costs[c] for c in registry.GATES[gate]["candidates"] if c in costs])


def _matmul_candidates(backend: str) -> Tuple[str, ...]:
    """``auto`` alone on every backend of the port, as the reference
    samples off the TPU: the forward's curve, timed once a size."""
    return ("auto",)


def _as_example(example, device) -> Optional[torch.Tensor]:
    """The example as a batch tensor on ``device`` (one datum becomes a
    batch of one)."""
    if example is None:
        return None
    if isinstance(example, torch.Tensor):
        arr = example.to(device)
    else:
        arr = torch.as_tensor(np.asarray(example)).to(device)
    if arr.ndim == 0:
        arr = arr[None]
    if arr.ndim == 1:
        arr = arr.reshape(1, *arr.shape)
    return arr


def build_plan(pipeline, example=None, batch_sizes: Sequence[int] = (8, 32, 128), full_batch: int = 32,
               max_batch: int = 32, seed: int = 0, runner: Optional[Callable[..., float]] = None,
               candidates: Optional[Dict[str, Sequence[str]]] = None, source: str = "freeze",
               device="cuda") -> PhysicalPlan:
    """A :class:`PhysicalPlan` for a fitted ``pipeline`` on ``device``
    (default the card, which must be there; the CPU only when asked).

    ``example``: a batch of representative input (a tensor or an array);
    the sampled batches are drawn from its rows.  Without it no stage is
    sampled and every gate keeps its static default (the plan still pins
    the serving knobs and the backend).  ``runner``: an injected timing
    function (tests; default :func:`wall_runner`).  ``candidates``: a
    per-gate candidate override (the winner-flip tests); default
    :func:`registry.supported_candidates`."""
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.utils.hashing import pipeline_fingerprint
    from keystone_tpu_torch.workflow import graph as G
    from keystone_tpu_torch.workflow.dataset import Dataset
    from keystone_tpu_torch.workflow.executor import DatasetExpr, GraphExecutor

    dev = resolve_device(device)
    backend = dev.type
    rng = np.random.default_rng(int(seed))
    run = runner or wall_runner
    batch_sizes = tuple(sorted({int(b) for b in batch_sizes}))
    stages: list = []
    forward_coeffs: Optional[Tuple[float, float]] = None
    ex_arr = _as_example(example, dev)

    def cands_for(gate: str) -> Tuple[str, ...]:
        if candidates and gate in candidates:
            return tuple(candidates[gate])
        return registry.supported_candidates(gate, backend=backend)

    graph = pipeline.graph
    bound = ex = None
    if ex_arr is not None:
        bound, _ = graph.replace_source_with_node(pipeline.source, G.DatasetOperator(Dataset(ex_arr)))
        ex = GraphExecutor(bound)

    def input_rows(node):
        """The example's rows as they reach ``node`` (its single
        dependency's output) on the device, with their mask: a tensor or
        an ``(array, mask)`` pair; None for a host payload."""
        deps = bound.dependencies.get(node, ())
        if len(deps) != 1:
            return None
        expr = ex.execute(deps[0])
        if not isinstance(expr, DatasetExpr) or expr.dataset.is_host:
            return None
        ds = expr.dataset
        return ds.array if ds.mask is None else (ds.array, ds.mask)

    # ---------------------------------------------------- per-stage gates
    if bound is not None:
        for node in bound.topological_nodes():
            op = bound.operators.get(node)
            t = getattr(op, "transformer", None)
            if t is None:
                continue
            tname = type(t).__name__
            if tname in ("FisherVector", "FusedPcaFisherVector"):
                choice = _plan_fused_fv(bound, node, t, input_rows, cands_for("fused_fv"), batch_sizes,
                                        full_batch, rng, run)
                if choice is not None:
                    stages.append(choice)
            elif tname in ("KernelBlockLinearMapper", "OutOfCoreKernelBlockLinearMapper"):
                # pinned on either backend: the wrappers launch B3/B4 for
                # every CUDA tensor and the plain chain for every CPU one
                (pinned,) = registry.supported_candidates("gram_pallas", backend=backend)
                stages.append(StageChoice(
                    gate="gram_pallas", signature=stage_signature(t), label=op.label(), winner=pinned,
                    why=f"pinned: the only candidate on {backend} (the wrapper picks by the tensor's device); "
                        "not sampled",
                    candidates=[CandidateCost(name=pinned, note="pinned, not sampled")]))

    # -------------------------------------------- whole-pipeline forward
    mm_cands = tuple(candidates["matmul"]) if candidates and "matmul" in candidates else _matmul_candidates(backend)
    psig = pipeline_fingerprint(pipeline)
    if mm_cands and bound is not None and bound.sink_dependencies.get(pipeline.sink) is not None:

        def forward(x):
            g2, _ = graph.replace_source_with_node(pipeline.source, G.DatasetOperator(Dataset(x)))
            return GraphExecutor(g2).execute(g2.sink_dependencies[pipeline.sink])

        costs: Dict[str, CandidateCost] = {}
        for cand in mm_cands:
            cc = CandidateCost(name=cand)
            for n in batch_sizes:
                x = _sample_batch(ex_arr, n, rng)
                # the forward as it stands: the stage records the curve and
                # switches no precision (registry's docstring)
                secs = run(lambda x=x: forward(x), gate="matmul", candidate=cand, n=n)
                cc.samples.append([int(n), float(secs)])
            cc.coeffs = fit_curve(cc.samples)
            cc.full_seconds = price(cc.coeffs, full_batch)
            costs[cand] = cc
        winner, why = _pick_winner("matmul", costs)
        stages.append(StageChoice(
            gate="matmul", signature=f"pipeline:{psig[:12]}", label="<forward>", winner=winner, why=why,
            candidates=[costs[c] for c in registry.GATES["matmul"]["candidates"] if c in costs]))
        forward_coeffs = costs[winner].coeffs

    _one_choice_per_gate(stages)
    knobs = select_knobs(forward_coeffs, max_batch=max_batch)
    return PhysicalPlan(backend=backend, seed=int(seed), batch_sizes=batch_sizes, full_batch=int(full_batch),
                        stages=stages, knobs=knobs, source=source, pipeline_signature=psig)


def _one_choice_per_gate(stages) -> None:
    """A gate is one switch for the whole graph (``FvFusionRule`` fuses
    every PCA → FV pair or none), so where a gate was sampled at several
    stages (the scorer's SIFT and LCS branches) each stage gets the
    candidate cheapest over all of them: the sum of its full-batch prices,
    by the same rule and tie margin.  A gate sampled at one stage keeps its
    winner (the reference's plans have one such stage)."""
    by_gate: Dict[str, list] = {}
    for st in stages:
        if st.candidates and any(c.samples for c in st.candidates):
            by_gate.setdefault(st.gate, []).append(st)
    for gate, group in by_gate.items():
        if len(group) < 2:
            continue
        total: Dict[str, CandidateCost] = {}
        for st in group:
            for c in st.candidates:
                t = total.setdefault(c.name, CandidateCost(name=c.name))
                t.full_seconds += c.full_seconds
                t.supported = t.supported and c.supported
        winner, why = _pick_winner(gate, total)
        for st in group:
            st.winner, st.why = winner, f"over the gate's {len(group)} stages: {why}"


def _plan_fused_fv(graph, node, fv, input_rows, cands, batch_sizes, full_batch, rng, run) -> Optional[StageChoice]:
    """The ``fused_fv`` gate compares real alternatives: the per-stage
    chain (``chain``: B2 on the card) against the one fused node
    ``FvFusionRule`` would install (``kernel``: B1), sampled on the same
    rows (:func:`fused_fv_candidates`)."""
    if type(fv).__name__ == "FusedPcaFisherVector":
        # already fused (the array builders' eager chains, or a re-plan of
        # an optimized graph): nothing to compare, the standing choice
        return StageChoice(gate="fused_fv", signature=stage_signature(fv), label="FusedPcaFisherVector",
                           winner="kernel", why="graph already carries the fused node")
    found = fused_fv_candidates(graph, node, fv, input_rows, cands)
    if found is None:
        return None
    label, fns, arr = found
    return _sample_gate("fused_fv", label, stage_signature(fv), fns, arr, batch_sizes, full_batch, rng, run)


def fused_fv_candidates(graph, node, fv, input_rows, cands):
    """``(label, {candidate: fn}, rows)`` for the FisherVector at ``node``,
    each candidate built as ``FvFusionRule`` would leave the graph, or None
    where the rule fuses nothing (no PCA feeds the FV alone).

    Where a normalizing ``SIFTExtractor`` feeds the PCA and nothing else
    reads it, the rule swaps the extractor for one that emits raw
    descriptors and folds the normalize into B1: then ``rows`` are the raw
    descriptors, ``kernel`` is ``FusedPcaFisherVector(sift_normalize=
    True)`` and ``chain`` is the normalize, the PCA and the FV.  Elsewhere
    ``rows`` are the PCA's input and both read them as they are."""
    deps = graph.dependencies.get(node, ())
    pca = pca_node = None
    if len(deps) == 1:
        t = getattr(graph.operators.get(deps[0]), "transformer", None)
        if type(t).__name__ == "PCATransformer":
            pca, pca_node = t, deps[0]
    if pca is None:
        return None  # the rule fuses only a PCA → FV pair
    from keystone_tpu_torch.ops.fisher import FusedPcaFisherVector
    from keystone_tpu_torch.ops.sift import _sift_normalize

    feed = graph.dependencies.get(pca_node, ())
    sift = getattr(graph.operators.get(feed[0]), "transformer", None) if len(feed) == 1 else None
    sift_normalize = (type(sift).__name__ == "SIFTExtractor" and sift.normalize
                      and tuple(graph.dependents(feed[0])) == (pca_node,))
    if sift_normalize:
        images = input_rows(feed[0])
        if images is None:
            return None
        raw = copy.copy(sift)
        raw.normalize = False
        arr = raw.apply_batch(*(images if isinstance(images, tuple) else (images,)))
    else:
        arr = input_rows(pca_node)
        if arr is None:
            return None

    def split(x):
        return x if isinstance(x, tuple) else (x, None)

    fns: Dict[str, Optional[Callable]] = {}
    for c in cands:
        if c == "chain":
            def chain(x, pca=pca, fv=fv):
                xs, mask = split(x)
                if sift_normalize:
                    xs = _sift_normalize(xs)
                out = pca.apply_batch(xs, mask=mask)
                xs2, mask2 = out if isinstance(out, tuple) else (out, None)
                return fv.apply_batch(xs2, mask=mask2)

            fns[c] = chain
        elif c == "kernel":
            fused = FusedPcaFisherVector(pca, fv.gmm, sift_normalize=sift_normalize, use_kernel=fv.use_kernel)
            fns[c] = lambda x, fused=fused: fused.apply_batch(*split(x))
        else:
            fns[c] = None
    head = "SIFTExtractor->" if sift_normalize else ""
    return f"{head}{type(pca).__name__}->{type(fv).__name__}", fns, arr


def select_knobs(forward_coeffs: Optional[Tuple[float, float]], max_batch: int = 32) -> dict:
    """Serving knobs from the fitted forward curve (the reference's rules):

    - **buckets**: the power-of-two ladder (the static default; the
      PlanTuner refines it live from observed flush occupancy);
    - **max_wait_ms**: about two fixed overheads ``a`` (waiting longer
      than the amortizable launch cost buys nothing), clamped to [1, 20]
      ms around the static 5 ms;
    - **dispatch_window**: the pool's static default of 2;
    - **hedge_ms**: past ~5× the fitted full-batch time, so that healthy
      flushes never hedge;
    - **pool_budget_bytes**: the resolved device budget, pinned, so that a
      deploy host with other headroom serves what was planned."""
    from keystone_tpu_torch.serve.service import default_buckets
    from keystone_tpu_torch.workflow.profiling import pool_budget_bytes

    knobs = {
        "buckets": [int(b) for b in default_buckets(int(max_batch))],
        "dispatch_window": 2,
        "pool_budget_bytes": int(pool_budget_bytes()),
    }
    if forward_coeffs is None:
        knobs["max_wait_ms"] = 5.0
        return knobs
    a, b = forward_coeffs
    knobs["max_wait_ms"] = round(min(20.0, max(1.0, 2000.0 * a)), 3)
    knobs["hedge_ms"] = round(min(60000.0, max(50.0, 5000.0 * (a + b * max_batch))), 3)
    return knobs
