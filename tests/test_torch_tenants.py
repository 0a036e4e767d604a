"""The port's multi-tenant serving (keystone_tpu_torch/serve/tenants.py,
workflow/cross.py, analysis/signatures.py) against the JAX package's
(keystone_tpu/serve/tenants.py): the reference's tests/test_multitenant.py
case by case on the CPU (the sharing plan, the collision gate, single
tenant and share on/off bit for bit, DRR flushes, quotas, breakers,
containment, dedup, /statusz and HTTP routing, replicas), and what the
port adds: both packages' plans on equal graphs, both packages'
serve_multi on the same numpy inputs, two tenants loaded from two files
sharing their prefix by content, the FV-fused prefix computed once a
combined flush, and the pool left empty after each flush.

Tolerances: ``ATOL_REF`` (tests/test_torch_serve.py's, the port's serve()
against the reference's) between the two packages; every comparison
inside the port is bit for bit.  Every wait is bounded."""

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models.linear import LinearMapper as JLinearMapper
from keystone_tpu.ops.stats import LinearRectifier as JLinearRectifier
from keystone_tpu.ops.stats import NormalizeRows as JNormalizeRows
from keystone_tpu.ops.stats import PaddedFFT as JPaddedFFT
from keystone_tpu.ops.stats import RandomSignNode as JRandomSignNode
from keystone_tpu.serve import serve_multi as jserve_multi
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu.workflow.cross import plan_sharing as jplan_sharing
from keystone_tpu.workflow.transformer import Transformer as JTransformer
from keystone_tpu_torch import faults
from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.ops.stats import LinearRectifier, NormalizeRows, PaddedFFT, RandomSignNode
from keystone_tpu_torch.serve import (
    MultiTenantApplier,
    Overloaded,
    PoisonRequest,
    SharedStagePool,
    UnknownTenant,
    serve,
    serve_http,
    serve_multi,
)
from keystone_tpu_torch.utils import guard
from keystone_tpu_torch.workflow.cross import ContentKeys, plan_sharing
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline
from keystone_tpu_torch.workflow.transformer import Transformer

pytestmark = pytest.mark.serve

DIM = 16
WAIT = 30  # seconds: the bound of every future wait
ATOL_REF = 1e-6  # tests/test_torch_serve.py's: the port's serve() against the reference's


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    """The reference's services turn on JAX's persistent compile cache for
    the process unless KEYSTONE_COMPILE_CACHE says no (tests/test_torch_serve.py)."""
    monkeypatch.setenv("KEYSTONE_COMPILE_CACHE", "0")


def _feat_dim() -> int:
    padded = 1 << (DIM - 1).bit_length()
    return 2 * (padded // 2 + 1) * 2


def _head_weights(classes, seed) -> np.ndarray:
    """The reference test's per-tenant head draw."""
    return np.random.default_rng(seed).normal(size=(_feat_dim(), classes)).astype(np.float32)


_SIGNS: dict = {}


def _signs(i) -> np.ndarray:
    """The reference's RandomSignNode.init(DIM, 1000 + i) draw, carried
    into the port as numpy."""
    if i not in _SIGNS:
        _SIGNS[i] = np.asarray(JRandomSignNode.init(DIM, 1000 + i).signs, np.float32)
    return _SIGNS[i]


def _jtenant(seed, classes=4):
    """The reference test's tenant: a deterministic shared featurization
    prefix and a head of its own."""
    feat = JPipeline.gather([
        JRandomSignNode(jnp.asarray(_signs(i))) | JPaddedFFT() | JLinearRectifier(0.0, alpha=0.01 * (i + 1))
        for i in range(2)
    ])
    return feat | JNormalizeRows() | JLinearMapper(jnp.asarray(_head_weights(classes, seed)))


def _tenant(seed, classes=4):
    """The same tenant in the port, on the reference's draws; each call
    makes new tensors (equal prefixes are equal by content only)."""
    feat = Pipeline.gather([
        RandomSignNode(torch.from_numpy(_signs(i).copy())) | PaddedFFT() | LinearRectifier(0.0, alpha=0.01 * (i + 1))
        for i in range(2)
    ])
    return feat | NormalizeRows() | LinearMapper(torch.from_numpy(_head_weights(classes, seed)))


def _mk(models, pool=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 2.0)
    kw.setdefault("queue_bound", 64)
    kw.setdefault("example", np.zeros((DIM,), np.float32))
    kw.setdefault("devices", ["cpu"])
    return serve_multi(models, pool=pool, **kw)


def _x(seed):
    return np.random.default_rng(seed).normal(size=(DIM,)).astype(np.float32)


def _frontier_labels(graph, node_sigs):
    return sorted(graph.operators[n].label() for n in node_sigs)


# ---------------------------------------------------------- sharing plan
def test_plan_sharing_detects_shared_prefix():
    """Both packages' plans over the same two tenants: the same frontier
    (by label), the same consumer counts, no refusal, and the per-flush
    declaration restricted to the flush's tenants."""
    jplan = jplan_sharing({"a": _jtenant(1).freeze().graph, "b": _jtenant(2).freeze().graph})
    ga, gb = _tenant(1).freeze(device="cpu").graph, _tenant(2).freeze(device="cpu").graph
    plan = plan_sharing({"a": ga, "b": gb})
    assert plan.shared, "equal featurization prefixes are planned shared"
    assert plan.refused == jplan.refused == 0
    assert len(plan.shared) == len(jplan.shared)
    assert sorted(plan.consumers.values()) == sorted(jplan.consumers.values()) == [2] * len(plan.shared)
    assert _frontier_labels(ga, plan.node_sigs["a"]) == ["Gather"]
    assert len(plan.node_sigs["b"]) == len(jplan.node_sigs["b"])
    assert plan.sigs_for(["a", "b"]) and plan.sigs_for(["a"]) == {} == jplan.sigs_for(["a"])


def test_plan_shared_stage_count_matches_the_reference():
    plan = plan_sharing({"a": _tenant(1).freeze(device="cpu").graph, "b": _tenant(2).freeze(device="cpu").graph})
    jplan = jplan_sharing({"a": _jtenant(1).freeze().graph, "b": _jtenant(2).freeze().graph})
    assert plan.shared_stage_count() == len(plan.shared) == jplan.shared_stage_count() > 0
    one = plan_sharing({"a": _tenant(1).freeze(device="cpu").graph})
    assert one.shared_stage_count() == 0 == jplan_sharing({"a": _jtenant(1).freeze().graph}).shared_stage_count()


def test_plan_sharing_single_tenant_empty():
    plan = plan_sharing({"a": _tenant(1).freeze(device="cpu").graph})
    jplan = jplan_sharing({"a": _jtenant(1).freeze().graph})
    assert not plan.shared and plan.node_sigs["a"] == {} == jplan.node_sigs["a"]


class _LeakyStage(Transformer):
    """Deliberately under-specified identity: params() omits ``scale``, so
    two observably different instances report equal signatures."""

    def __init__(self, scale):
        super().__init__()
        self.scale = float(scale)

    def params(self):
        return ("leaky",)

    def apply_batch(self, xs, mask=None):
        return xs * self.scale


class _JLeakyStage(JTransformer):
    def __init__(self, scale):
        self.scale = float(scale)

    def params(self):
        return ("leaky",)

    def apply_one(self, x):
        return x * self.scale

    def apply_batch(self, xs, mask=None):
        return xs * self.scale


class _LeakyTensorStage(Transformer):
    """params() agree, the fitted tensors differ: ``w`` is a registered
    buffer params() does not name."""

    def __init__(self, w):
        super().__init__()
        self.register_buffer("w", torch.as_tensor(w, dtype=torch.float32))

    def params(self):
        return ("leaky-tensor",)

    def apply_batch(self, xs, mask=None):
        return xs * self.w


class _JLeakyTensorStage(JTransformer):
    def __init__(self, w):
        self.w = jnp.asarray(w, jnp.float32)

    def params(self):
        return ("leaky-tensor",)

    def apply_one(self, x):
        return x * self.w

    def apply_batch(self, xs, mask=None):
        return xs * self.w


def test_collision_gate_refuses_unsafe_share():
    jplan = jplan_sharing({"a": JPipeline.of(_JLeakyStage(2.0)).freeze().graph,
                           "b": JPipeline.of(_JLeakyStage(3.0)).freeze().graph})
    plan = plan_sharing({"a": Pipeline.of(_LeakyStage(2.0)).freeze(device="cpu").graph,
                         "b": Pipeline.of(_LeakyStage(3.0)).freeze(device="cpu").graph})
    assert plan.refused == jplan.refused >= 1, "colliding signatures are refused"
    assert not plan.shared
    # end to end: co-served answers stay each tenant's own
    svc = _mk({"a": Pipeline.of(_LeakyStage(2.0)), "b": Pipeline.of(_LeakyStage(3.0))},
              pool=SharedStagePool(budget_bytes=1 << 20))
    try:
        x = np.full((DIM,), 1.0, np.float32)
        np.testing.assert_array_equal(svc.submit(x, tenant="a").result(WAIT), x * 2.0)
        np.testing.assert_array_equal(svc.submit(x, tenant="b").result(WAIT), x * 3.0)
        assert svc.status()["stage_pool"]["collision_refusals"] >= 1
    finally:
        svc.close()


@pytest.mark.parametrize("small", [True, False])
def test_collision_gate_params_agree_tensors_differ(small):
    """Two transformers whose params() agree but whose tensors differ: the
    content signatures agree (params() names no tensor), the gate compares
    the registered buffers (by value up to 4096 elements, by shape and
    dtype beyond: a larger pair differs in shape here) and refuses, as the
    reference's gate refuses its pair."""
    n = DIM if small else 5000
    wa, wb = np.full(n, 2.0, np.float32), np.full(n if small else n + 1, 3.0, np.float32)
    jplan = jplan_sharing({"a": JPipeline.of(_JLeakyTensorStage(wa)).freeze().graph,
                           "b": JPipeline.of(_JLeakyTensorStage(wb)).freeze().graph})
    ga = Pipeline.of(_LeakyTensorStage(wa)).freeze(device="cpu").graph
    gb = Pipeline.of(_LeakyTensorStage(wb)).freeze(device="cpu").graph
    plan = plan_sharing({"a": ga, "b": gb})
    assert plan.refused == jplan.refused == 1 and not plan.shared
    if small:
        svc = _mk({"a": Pipeline.of(_LeakyTensorStage(wa)), "b": Pipeline.of(_LeakyTensorStage(wb))},
                  pool=SharedStagePool(budget_bytes=1 << 20))
        try:
            x = np.ones((DIM,), np.float32)
            np.testing.assert_array_equal(svc.submit(x, tenant="a").result(WAIT), wa)
            np.testing.assert_array_equal(svc.submit(x, tenant="b").result(WAIT), wb)
        finally:
            svc.close()


def test_equal_tensors_share_and_unequal_do_not():
    """Content identity: the same stage over equal buffers made apart is
    shared (no refusal), over unequal ones it is not a candidate."""
    w = np.arange(DIM, dtype=np.float32)

    class Scale(Transformer):
        def __init__(self, v):
            super().__init__()
            self.register_buffer("v", torch.as_tensor(v))

        def params(self):
            return (self.v.shape[0], id(self.v))

        def apply_batch(self, xs, mask=None):
            return xs * self.v

    same = plan_sharing({"a": Pipeline.of(Scale(w)).freeze(device="cpu").graph,
                         "b": Pipeline.of(Scale(w.copy())).freeze(device="cpu").graph})
    assert len(same.shared) == 1 and same.refused == 0
    other = plan_sharing({"a": Pipeline.of(Scale(w)).freeze(device="cpu").graph,
                          "b": Pipeline.of(Scale(w + 1)).freeze(device="cpu").graph})
    assert not other.shared and other.refused == 0


def test_separately_loaded_tenants_share_their_prefix(tmp_path):
    """Two tenants saved and loaded apart hold equal featurizers as
    distinct tensors: their id signatures differ, their content signatures
    agree, and served together the prefix is computed once (pool hits)."""
    for name, seed in (("a", 1), ("b", 2)):
        _tenant(seed).fit().save(str(tmp_path / f"{name}.pt"))
    a = FittedPipeline.load(str(tmp_path / "a.pt"), map_location="cpu")
    b = FittedPipeline.load(str(tmp_path / "b.pt"), map_location="cpu")

    def signs(p):
        """The RandomSignNode stages, inside the fit's fused chains too."""
        stages = [s for op in p.graph.operators.values() if hasattr(op, "transformer")
                  for s in getattr(op.transformer, "stages", [op.transformer])]
        return [s for s in stages if isinstance(s, RandomSignNode)]

    sa, sb = signs(a), signs(b)
    assert len(sa) == len(sb) == 2
    assert sa[0].signs is not sb[0].signs and torch.equal(sa[0].signs, sb[0].signs)
    assert sa[0].signature() != sb[0].signature()
    keys = ContentKeys()
    assert keys.signature(sa[0]) == keys.signature(sb[0])
    pool = SharedStagePool(budget_bytes=1 << 24)
    svc = _mk({"a": a, "b": b}, pool=pool, max_wait_ms=50.0)
    try:
        assert svc.status()["stage_pool"]["shared_stages"] == 1
        h0 = pool.stats()["hits"]
        fa, fb = svc.submit(_x(0), tenant="a"), svc.submit(_x(0), tenant="b")
        fa.result(WAIT), fb.result(WAIT)
        assert pool.stats()["hits"] > h0
    finally:
        svc.close()


# ---------------------------------------------------------- bit identity
def test_single_tenant_with_pool_byte_identical_to_pre_pool():
    """One tenant with the pool answers bit for bit as the port's plain
    serve() over the same pipeline."""
    pool = SharedStagePool(budget_bytes=1 << 24)
    multi = _mk({"only": _tenant(7)}, pool=pool)
    plain = serve(_tenant(7), max_batch=8, max_wait_ms=2.0, queue_bound=64, example=np.zeros((DIM,), np.float32),
                  devices=["cpu"])
    try:
        for seed in range(3):
            x = _x(seed)
            assert np.array_equal(multi.submit(x).result(WAIT), plain.submit(x).result(WAIT))
        st = multi.status()["stage_pool"]
        assert st["shared_stages"] == 0 and st["hits"] == 0 and st["misses"] == 0
    finally:
        multi.close()
        plain.close()


def test_shared_vs_unshared_bit_identical_and_pool_hits():
    pool = SharedStagePool(budget_bytes=1 << 24)
    shared = _mk({"a": _tenant(1), "b": _tenant(2)}, pool=pool)
    unshared = _mk({"a": _tenant(1), "b": _tenant(2)}, share=False)
    try:
        x = _x(5)
        for t in ("a", "b"):
            assert np.array_equal(shared.submit(x, tenant=t).result(WAIT), unshared.submit(x, tenant=t).result(WAIT))
        assert pool.stats()["hits"] >= 1  # the priming flushes already shared
        assert unshared.status()["stage_pool"]["sharing"] is False
    finally:
        shared.close()
        unshared.close()


def test_shared_prefix_computed_once_per_combined_flush():
    """A pair of co-tenant requests in one flush window: the second walk
    hits the pool, and the pool holds no byte of the flush afterwards."""
    pool = SharedStagePool(budget_bytes=1 << 24)
    svc = _mk({"a": _tenant(1), "b": _tenant(2)}, pool=pool, max_wait_ms=50.0)
    try:
        h0 = pool.stats()["hits"]
        fa, fb = svc.submit(_x(0), tenant="a"), svc.submit(_x(0), tenant="b")
        fa.result(WAIT), fb.result(WAIT)
        st = pool.stats()
        assert st["hits"] > h0
        assert st["resident_bytes"] == 0 and st["entries"] == 0
        assert 0 < st["peak_bytes"] <= st["budget_bytes"]
    finally:
        svc.close()


def test_serve_multi_matches_the_reference_serve_multi():
    """Both packages' serve_multi over the same two tenants (the port's on
    the reference's draws) answer the same rows at ATOL_REF."""
    kw = dict(max_batch=8, max_wait_ms=2.0, queue_bound=64, example=np.zeros((DIM,), np.float32))
    xs = np.random.default_rng(11).normal(size=(6, DIM)).astype(np.float32)
    ref = jserve_multi({"a": _jtenant(1), "b": _jtenant(2, classes=6)}, **kw)
    try:
        want = {t: np.stack([np.asarray(f.result(WAIT)) for f in ref.submit_many(xs, tenant=t)]) for t in ("a", "b")}
    finally:
        ref.close()
    svc = serve_multi({"a": _tenant(1), "b": _tenant(2, classes=6)}, devices=["cpu"], **kw)
    try:
        got = {t: np.stack([f.result(WAIT) for f in svc.submit_many(xs, tenant=t)]) for t in ("a", "b")}
    finally:
        svc.close()
    assert got["b"].shape == (6, 6)
    for t in ("a", "b"):
        np.testing.assert_allclose(got[t], want[t], atol=ATOL_REF, rtol=0)


def test_scorer_tenants_match_the_reference_serve_multi():
    """Two small two-branch SIFT/LCS scorers sharing their featurizer, each
    with a head of its own, on the same seeded weights (carried into the
    port by convert.py): both packages' serve_multi share the prefix (pool
    hits) and answer the same raw scores at test_torch_slice.py's
    cross-package tolerance."""
    from test_torch_slice import ATOL_SCORES, CFG, SMALL, _images

    from keystone_tpu.models.block_ls import BlockLinearMapper as JBlm
    from keystone_tpu.models.gmm import GaussianMixtureModel as JGmm
    from keystone_tpu.models.pca import PCATransformer as JPca
    from keystone_tpu.ops.fisher import FusedPcaFisherVector as JFused
    from keystone_tpu.ops.images import GrayScaler as JGray
    from keystone_tpu.ops.images import PixelScaler as JPixel
    from keystone_tpu.ops.lcs import LCSExtractor as JLcs
    from keystone_tpu.ops.sift import SIFTExtractor as JSift
    from keystone_tpu.ops.stats import SignedHellingerMapper as JHell
    from keystone_tpu.workflow.stage_pool import SharedStagePool as JPool
    from keystone_tpu_torch.convert import params_from_numpy
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P

    raws = {}
    for t, seed in (("a", 0), ("b", 5)):
        raws[t] = P.random_params(**SMALL, seed=0)
        head = raws[t]["blm.weights"]
        raws[t]["blm.weights"] = (0.01 * np.random.default_rng(seed).normal(size=head.shape)).astype(np.float32)

    def jscorer(raw):
        a = {k: jnp.asarray(v) for k, v in raw.items()}

        def fused(b, norm):
            return JFused(JPca(a[f"{b}.pca.components"], a[f"{b}.pca.mean"]),
                          JGmm(a[f"{b}.gmm.weights"], a[f"{b}.gmm.means"], a[f"{b}.gmm.variances"]),
                          sift_normalize=norm)

        sift = (JPipeline.of(JPixel(only_if_integer=True)) | JGray()
                | JSift(step=CFG.sift_step, bin_sizes=(CFG.sift_bin_size,), normalize=False) | fused("sift", True)
                | JHell() | JNormalizeRows())
        lcs = (JPipeline.of(JPixel(only_if_integer=True)) | JLcs(CFG.lcs_step, CFG.lcs_subpatch)
               | fused("lcs", False) | JHell() | JNormalizeRows())
        return JPipeline.gather([sift, lcs]) | JBlm(a["blm.weights"], a["blm.weights"].shape[1])

    imgs = _images(n=6)
    kw = dict(max_batch=4, max_wait_ms=5.0, example=imgs[0])
    jpool, pool = JPool(budget_bytes=1 << 26), SharedStagePool(budget_bytes=1 << 26)
    ref = jserve_multi({t: jscorer(r) for t, r in raws.items()}, pool=jpool, **kw)
    try:
        want = {t: np.stack([np.asarray(f.result(120)) for f in ref.submit_many(imgs, tenant=t)]) for t in raws}
    finally:
        ref.close()
    svc = serve_multi({t: P.scorer_pipeline(params_from_numpy(r, device="cpu"), CFG) for t, r in raws.items()},
                      pool=pool, devices=["cpu"], **kw)
    try:
        got = {t: np.stack([f.result(WAIT) for f in svc.submit_many(imgs, tenant=t)]) for t in raws}
    finally:
        svc.close()
    assert jpool.stats()["hits"] > 0 and pool.stats()["hits"] > 0
    for t in raws:
        np.testing.assert_allclose(got[t], want[t], atol=ATOL_SCORES, rtol=0)
    assert not np.allclose(got["a"], got["b"], atol=ATOL_SCORES), "the two heads answer alike"


def test_fv_prefix_fused_for_the_card_and_computed_once(monkeypatch):
    """Three tenants over one two-branch SIFT/LCS → PCA → FV featurizer,
    each with its own head, frozen for a CUDA applier (the device check
    patched to call ``cpu:0`` one): every tenant graph holds both fused FV
    nodes, a combined flush applies them once a branch with the share on
    and three times that with it off, bit for bit."""
    from keystone_tpu_torch.convert import params_from_numpy
    from keystone_tpu_torch.ops.fisher import FusedPcaFisherVector
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P
    from keystone_tpu_torch.workflow import optimizer as O

    cfg = P.Config(sift_step=8, lcs_step=8)
    small = dict(pca_dims=16, gmm_k=8, num_classes=10, block_size=64)
    models = {}
    for i, seed in enumerate((0, 5, 6)):
        p = params_from_numpy(P.random_params(**small, seed=0), "cpu")
        if i:
            w = np.random.default_rng(seed).normal(size=tuple(p["blm.weights"].shape))
            p["blm.weights"] = torch.from_numpy((0.01 * w).astype(np.float32))
        models[f"t{i}"] = P.scorer_pipeline(p, cfg)
    monkeypatch.setattr(O, "device_is_cuda", lambda device: device == torch.device("cpu", 0))
    applies = []
    fused_apply = FusedPcaFisherVector.apply_batch
    monkeypatch.setattr(FusedPcaFisherVector, "apply_batch",
                        lambda self, *a, **k: applies.append(self.label) or fused_apply(self, *a, **k))
    imgs = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 48, 48, 3), dtype=np.uint8))
    outs = {}
    for share in (True, False):
        app = MultiTenantApplier(models, share=share, device="cpu:0", pool=SharedStagePool(budget_bytes=1 << 30))
        for a in app.appliers.values():
            labels = sorted(op.transformer.label for op in a.graph.operators.values()
                            if isinstance(op.transformer if hasattr(op, "transformer") else None, FusedPcaFisherVector))
            assert labels == ["FusedFV[PCA > FV]", "FusedFV[SiftNorm > PCA > FV]"]
        applies.clear()
        outs[share] = {t: d.array for t, d in app(imgs).items()}
        assert len(applies) == (2 if share else 6), applies
        assert app.pool().stats()["resident_bytes"] == 0
    for t in models:
        assert torch.equal(outs[True][t], outs[False][t])
    offline = P.scores_of(P.build_scorer_from_params(params_from_numpy(P.random_params(**small, seed=0), "cpu"),
                                                     cfg, "cpu"))(imgs)
    assert torch.equal(offline, outs[True]["t0"])


# ------------------------------------------------------------- scheduling
def test_drr_pop_forms_fair_mixed_flushes():
    from keystone_tpu_torch.serve.service import _Request

    svc = _mk({"a": _tenant(1), "b": _tenant(2)})
    try:
        with svc._cond:
            for t in ("a", "b"):
                for _ in range(20):
                    svc._tq[t].append(_Request(np.zeros((DIM,)), None, tenant=t))
            batch = svc._drr_pop_locked()
        counts = {"a": 0, "b": 0}
        for r in batch:
            counts[r.tenant] += 1
        assert len(batch) == svc.max_batch
        assert counts["a"] == counts["b"] == svc.max_batch // 2
        seq = [r.tenant for r in batch]
        assert seq in (sorted(seq), sorted(seq, reverse=True)), "each tenant's rows are one contiguous run"
        with svc._cond:
            batch2 = svc._drr_pop_locked()
        assert abs(sum(r.tenant == "a" for r in batch2) - sum(r.tenant == "b" for r in batch2)) <= 1
        for b in (batch, batch2):
            for r in b:
                r.future.cancel()
    finally:
        svc.close(drain=False)


def test_tenant_quota_overload_is_isolated():
    svc = _mk({"a": _tenant(1), "b": _tenant(2)}, tenant_queue_bound={"a": 2, "b": 32}, max_wait_ms=200.0,
              max_batch=64)
    try:
        x = np.zeros((DIM,), np.float32)
        futs = [svc.submit(x, tenant="a") for _ in range(2)]
        with pytest.raises(Overloaded):
            svc.submit(x, tenant="a")
        assert svc.submit(x, tenant="b").result(WAIT) is not None  # b untouched by a's full quota
        for f in futs:
            f.result(WAIT)
    finally:
        svc.close()


def test_unknown_and_missing_tenant_rejected():
    svc = _mk({"a": _tenant(1), "b": _tenant(2)})
    try:
        x = np.zeros((DIM,), np.float32)
        with pytest.raises(UnknownTenant):
            svc.submit(x, tenant="nope")
        with pytest.raises(UnknownTenant):
            svc.submit(x)  # ambiguous with 2 tenants
    finally:
        svc.close()


def test_single_tenant_service_refuses_tenant_kwarg():
    with serve(_tenant(1), max_batch=4, example=np.zeros((DIM,), np.float32), devices=["cpu"]) as plain:
        with pytest.raises(TypeError, match="single-tenant"):
            plain.submit(np.zeros((DIM,), np.float32), tenant="a")


def test_serve_multi_refuses_the_worker_fleets():
    """As the reference's: the shared pool and per-tenant containment need
    the in-process walk."""
    with pytest.raises(NotImplementedError, match="workers="):
        serve_multi({"a": _tenant(1)}, workers=2, example=np.zeros((DIM,), np.float32))
    with pytest.raises(NotImplementedError, match="hosts="):
        serve_multi({"a": _tenant(1)}, hosts="local:2", example=np.zeros((DIM,), np.float32))
    with pytest.raises(ValueError, match="at least one"):
        MultiTenantApplier({}, device="cpu")


# ---------------------------------------------------------- blast radius
def test_tenant_targeted_enqueue_fault_isolated():
    svc = _mk({"a": _tenant(1), "b": _tenant(2)})
    try:
        x = np.zeros((DIM,), np.float32)
        with faults.inject("serve.enqueue:ctx.tenant=a:raise"):
            with pytest.raises(faults.FaultInjected):
                svc.submit(x, tenant="a")
            assert np.all(np.isfinite(svc.submit(x, tenant="b").result(WAIT)))
    finally:
        svc.close()


def test_tenant_targeted_batch_fault_contained_to_tenant():
    """A serve.batch fault matched to ctx.tenant=a fails a's riders of the
    combined flush; b's riders in the same flush deliver."""
    svc = _mk({"a": _tenant(1), "b": _tenant(2)}, max_wait_ms=50.0)
    try:
        with faults.inject("serve.batch:ctx.tenant=a:raise:times=1"):
            fa, fb = svc.submit(_x(1), tenant="a"), svc.submit(_x(1), tenant="b")
            assert np.all(np.isfinite(fb.result(WAIT)))
            with pytest.raises(faults.FaultInjected):
                fa.result(WAIT)
    finally:
        svc.close()


def test_poison_bisected_inside_the_tenant_segment():
    """A content-shaped failure in one tenant's segment of a combined
    flush: bisection isolates the poison rider (PoisonRequest), the
    tenant's innocent riders and the other tenant's deliver."""
    from keystone_tpu_torch.tools.serve_bench import MARK, MarkerGate

    gated = Pipeline.of(MarkerGate()) | NormalizeRows() | LinearMapper(torch.eye(DIM))
    svc = _mk({"a": gated, "b": _tenant(2)}, max_wait_ms=80.0)
    try:
        poison = _x(3)
        poison[0] = MARK
        fa = [svc.submit(_x(i), tenant="a") for i in range(3)] + [svc.submit(poison, tenant="a")]
        fb = [svc.submit(_x(i), tenant="b") for i in range(3)]
        with pytest.raises(PoisonRequest):
            fa[-1].result(WAIT)
        for f in fa[:-1] + fb:
            assert np.all(np.isfinite(f.result(WAIT)))
    finally:
        svc.close()


def test_tenant_breaker_opens_for_failing_tenant_only():
    svc = _mk({"a": _tenant(1), "b": _tenant(2)}, tenant_breaker_threshold=2, max_wait_ms=5.0)
    try:
        x = _x(1)
        with faults.inject("serve.batch:ctx.tenant=a:raise"):
            failures = 0
            for _ in range(6):
                try:
                    svc.submit(x, tenant="a").result(WAIT)
                except guard.CircuitOpenError:
                    break
                except Exception:
                    failures += 1
            else:
                pytest.fail("tenant a's breaker never opened")
            assert failures >= 2
            assert np.all(np.isfinite(svc.submit(x, tenant="b").result(WAIT)))
    finally:
        svc.close()


def test_tenant_breaker_refusal_counts_as_rejected():
    """A tenant-breaker refusal is backpressure (HTTP 429): counted as a
    rejection, never as a tenant error."""
    svc = _mk({"a": _tenant(1), "b": _tenant(2)}, tenant_breaker_threshold=1)
    try:
        x = _x(1)
        with faults.inject("serve.batch:ctx.tenant=a:raise"):
            with pytest.raises(Exception):
                svc.submit(x, tenant="a").result(WAIT)  # opens the breaker
            errs0 = metrics.REGISTRY.counter_value("serve.tenant_errors", tenant="a")
            rej0 = metrics.REGISTRY.counter_value("serve.tenant_rejected", tenant="a")
            with pytest.raises(guard.CircuitOpenError):
                svc.submit(x, tenant="a")
        assert metrics.REGISTRY.counter_value("serve.tenant_rejected", tenant="a") == rej0 + 1
        assert metrics.REGISTRY.counter_value("serve.tenant_errors", tenant="a") == errs0
    finally:
        svc.close()


# --------------------------------------------------------------- surfaces
def test_statusz_tenants_and_pool_sections():
    svc = _mk({"a": _tenant(1), "b": _tenant(2)})
    try:
        svc.submit(np.zeros((DIM,), np.float32), tenant="a").result(WAIT)
        st = svc.status()
        assert set(st["tenants"]) == {"a", "b"}
        ta = st["tenants"]["a"]
        assert ta["counters"]["submitted"] >= 1 and ta["counters"]["completed"] >= 1
        assert "latency_ms" in ta and "quota" in ta
        assert {"hits", "misses", "shared_stages", "collision_refusals", "sharing"} <= set(st["stage_pool"])
    finally:
        svc.close()


def test_http_tenant_routing():
    svc = _mk({"a": _tenant(1), "b": _tenant(2, classes=6)})
    front = serve_http(svc, port=0)
    base = f"http://127.0.0.1:{front.port}"
    try:
        def post(body):
            req = urllib.request.Request(base + "/predict", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=WAIT) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        x = [0.5] * DIM
        code, body = post({"instance": x, "tenant": "b"})
        assert code == 200 and len(body["predictions"][0]) == 6
        assert post({"instance": x, "tenant": "nope"})[0] == 400
        assert post({"instance": x})[0] == 400  # ambiguous
        with urllib.request.urlopen(base + "/statusz", timeout=WAIT) as r:
            st = json.loads(r.read())
        assert set(st["tenants"]) == {"a", "b"} and "stage_pool" in st
    finally:
        front.stop()
        svc.close()


def test_http_tenant_breaker_answers_429_and_co_tenants_answer():
    """A tenant whose own admission breaker is open is refused with 429 and
    a Retry-After (the reference's front end), and the co-served tenant
    keeps answering 200."""
    svc = _mk({"a": _tenant(1), "b": _tenant(2)}, tenant_breaker_threshold=1)
    front = serve_http(svc, port=0)
    base = f"http://127.0.0.1:{front.port}"

    def post(body):
        req = urllib.request.Request(base + "/predict", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=WAIT) as r:
                return r.status, dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers)

    try:
        x = [0.5] * DIM
        with faults.inject("serve.batch:ctx.tenant=a:raise"):
            assert post({"instance": x, "tenant": "a"})[0] == 500  # the failure opens a's breaker
            code, hdrs = post({"instance": x, "tenant": "a"})
        assert code == 429 and hdrs.get("Retry-After") == "1"
        assert post({"instance": x, "tenant": "b"})[0] == 200
    finally:
        front.stop()
        svc.close()


def test_replicated_multi_tenant_serving():
    """Each replica is one deep copy of the whole applier, every tenant
    graph placed; the plan carries over, the private pool is found again
    by its token, and the clones' flush walks hit it."""
    pool = SharedStagePool(budget_bytes=1 << 24)
    svc = _mk({"a": _tenant(1), "b": _tenant(2)}, pool=pool, replicas=2, devices=["cpu", "cpu"])
    try:
        clones = [r.applier for r in svc._pool.replicas]
        assert clones[0] is not clones[1] and all(c.pool() is pool for c in clones)
        assert clones[0].plan.node_sigs == clones[1].plan.node_sigs
        x = _x(2)
        outs = [(svc.submit(x, tenant="a").result(WAIT), svc.submit(x, tenant="b").result(WAIT)) for _ in range(4)]
        for ya, yb in outs[1:]:
            assert np.array_equal(ya, outs[0][0]) and np.array_equal(yb, outs[0][1])
        assert pool.stats()["hits"] >= 1
    finally:
        svc.close()


def test_autoscaler_reads_the_pool_hit_rate():
    from keystone_tpu_torch.serve import Autoscaler

    pool = SharedStagePool(budget_bytes=1 << 24)
    svc = _mk({"a": _tenant(1), "b": _tenant(2)}, pool=pool)
    try:
        sig = Autoscaler(svc).sample()
        assert sig.pool_hit_rate == pool.hit_rate() > 0.0  # the priming flushes shared
    finally:
        svc.close()
    with serve(_tenant(1), max_batch=4, example=np.zeros((DIM,), np.float32), devices=["cpu"]) as plain:
        assert Autoscaler(plain).sample().pool_hit_rate is None


# ------------------------------------------------------------- dedup
def test_dedup_identical_inflight_payloads_computed_once():
    """dedup=True: identical concurrent payloads of one tenant ride one
    computation and resolve bit for bit, each with its own copy."""
    svc = _mk({"a": _tenant(1)}, dedup=True, max_wait_ms=25.0)
    try:
        h0 = metrics.REGISTRY.counter_total("serve.dedup_hits")
        futs = [svc.submit(_x(2), tenant="a") for _ in range(6)]
        outs = [np.asarray(f.result(WAIT)) for f in futs]
        for o in outs[1:]:
            assert o.tobytes() == outs[0].tobytes()
        assert metrics.REGISTRY.counter_total("serve.dedup_hits") - h0 >= 4
        outs[1][:] = 0
        assert outs[2].tobytes() == outs[0].tobytes()
    finally:
        svc.close()


def test_dedup_never_crosses_tenants():
    svc = _mk({"a": _tenant(1), "b": _tenant(2)}, dedup=True, max_wait_ms=25.0)
    try:
        fa, fb = svc.submit(_x(3), tenant="a"), svc.submit(_x(3), tenant="b")
        assert np.asarray(fa.result(WAIT)).tobytes() != np.asarray(fb.result(WAIT)).tobytes()
    finally:
        svc.close()


def test_dedup_off_by_default():
    svc = _mk({"a": _tenant(1)}, max_wait_ms=10.0)
    try:
        h0 = metrics.REGISTRY.counter_total("serve.dedup_hits")
        outs = [np.asarray(f.result(WAIT)) for f in [svc.submit(_x(4), tenant="a") for _ in range(4)]]
        for o in outs[1:]:
            assert o.tobytes() == outs[0].tobytes()
        assert metrics.REGISTRY.counter_total("serve.dedup_hits") - h0 == 0
    finally:
        svc.close()


def test_dedup_map_drains_after_resolution():
    import time

    svc = _mk({"a": _tenant(1)}, dedup=True)
    try:
        for f in [svc.submit(_x(i), tenant="a") for i in range(8)]:
            f.result(WAIT)
        deadline = time.monotonic() + 5.0
        while svc._dedup_inflight and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not svc._dedup_inflight
    finally:
        svc.close()
