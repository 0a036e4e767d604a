"""The port's serving service (keystone_tpu_torch/serve/service.py) and
``Pipeline.freeze`` against the JAX package's (keystone_tpu/serve): the
micro-batcher state machine, admission control, deadline shedding, the
serve.* fault sites, degradation on the serve path, the same rows from
both packages' services (the reference's tests/test_serve.py, on the
CPU), and freeze's FV fusion by the applier's device.

Every wait is bounded (``result(timeout=...)``, ``close(timeout=...)``):
a hang fails in seconds."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models.linear import LinearMapper as JLinearMapper
from keystone_tpu.ops.stats import NormalizeRows as JNormalizeRows
from keystone_tpu.serve import serve as jserve
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu_torch import faults
from keystone_tpu_torch.models.linear import LinearMapEstimator, LinearMapper
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.ops.stats import NormalizeRows
from keystone_tpu_torch.serve import Overloaded, PipelineService, ServiceClosed, default_buckets, serve, wire
from keystone_tpu_torch.serve.service import pad_rows
from keystone_tpu_torch.utils import guard
from keystone_tpu_torch.workflow import optimizer as O
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import FrozenApplier, NotPortedError, Pipeline
from keystone_tpu_torch.workflow.transformer import Transformer

pytestmark = pytest.mark.serve


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    """The reference's serve() turns on JAX's persistent compilation cache
    for the whole process unless KEYSTONE_COMPILE_CACHE says no; kept off
    here, so that these tests leave no state behind for the next test file
    a worker runs."""
    monkeypatch.setenv("KEYSTONE_COMPILE_CACHE", "0")


DIM = 6
WAIT = 30  # seconds: the bound of every future wait


def _pipeline(scale: float = 2.0) -> Pipeline:
    return Pipeline.of(NormalizeRows()) | LinearMapper(torch.eye(DIM) * scale)


def _service(pipe=None, **kw) -> PipelineService:
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 30.0)
    kw.setdefault("queue_bound", 64)
    kw.setdefault("example", np.zeros(DIM, np.float32))
    kw.setdefault("devices", ["cpu"])
    return serve(_pipeline() if pipe is None else pipe, **kw)


def _offline(x, scale=2.0):
    return _pipeline(scale)(Dataset(x, device="cpu")).get().numpy()


def _counter(name: str) -> float:
    return metrics.REGISTRY.counter_total(name)


# ------------------------------------------------------------- correctness
def test_serve_matches_offline_apply():
    """The padded-bucket serve path returns the offline batch apply's rows."""
    x = np.random.default_rng(0).normal(size=(5, DIM)).astype(np.float32)
    with _service() as svc:
        got = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(x)])
    np.testing.assert_allclose(got, _offline(x), rtol=1e-6, atol=1e-7)


def test_same_rows_as_the_reference_service():
    """The NormalizeRows → LinearMapper pipeline on the same seeded numpy
    weights, served by the reference's serve() (JAX on the CPU) and the
    port's: the same rows at 1e-6."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(DIM, 4)).astype(np.float32)
    x = rng.normal(size=(13, DIM)).astype(np.float32)
    kw = dict(max_batch=8, max_wait_ms=5.0, queue_bound=64, example=np.zeros(DIM, np.float32))
    with jserve(JPipeline.of(JNormalizeRows()) | JLinearMapper(jnp.asarray(w)), **kw) as ref:
        want = np.stack([np.asarray(f.result(timeout=WAIT)) for f in ref.submit_many(x)])
    with serve(Pipeline.of(NormalizeRows()) | LinearMapper(torch.from_numpy(w)), devices=["cpu"], **kw) as svc:
        got = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(x)])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_freeze_rejects_unfitted_pipeline():
    x = np.random.default_rng(0).normal(size=(8, DIM)).astype(np.float32)
    y = np.eye(DIM, dtype=np.float32)[np.arange(8) % DIM]
    pipe = Pipeline.of(NormalizeRows()).and_then(
        LinearMapEstimator(lam=1e-3), Dataset(x, device="cpu"), Dataset(y, device="cpu"))
    with pytest.raises(TypeError, match="call fit"):
        FrozenApplier(pipe, device="cpu")
    with pytest.raises(TypeError, match="call fit"):
        pipe.freeze(device="cpu")
    # fitted, the same pipeline freezes and serves
    with serve(pipe.fit(), max_batch=4, max_wait_ms=5.0, example=x[0], devices=["cpu"]) as svc:
        out = svc.submit(x[0]).result(timeout=WAIT)
    assert np.asarray(out).shape == (DIM,)


def test_frozen_applier_binds_each_batch_and_pickles():
    import pickle

    x = np.random.default_rng(1).normal(size=(3, DIM)).astype(np.float32)
    app = _pipeline().freeze(device="cpu")
    assert app.device == torch.device("cpu") and not app._degradable
    np.testing.assert_allclose(app(x).numpy(), _offline(x), rtol=1e-6)
    clone = pickle.loads(pickle.dumps(app))
    np.testing.assert_allclose(clone(torch.from_numpy(x)).numpy(), _offline(x), rtol=1e-6)


def test_pad_rows_and_default_buckets():
    rows = np.arange(6, dtype=np.float32).reshape(3, 2)
    padded = pad_rows(rows, 8)
    assert padded.shape == (8, 2) and not padded[3:].any()
    np.testing.assert_array_equal(padded[:3], rows)
    assert pad_rows(rows, 3) is rows
    assert default_buckets(32) == (8, 16, 32)
    assert default_buckets(24) == (8, 16, 24)
    assert default_buckets(4) == (4,)
    assert default_buckets(1) == (1,)


def test_flush_pads_to_the_bucket_on_the_replica_device():
    """A lone datum rides the smallest bucket's batch, built on the
    replica's device (never a per-datum shape)."""
    seen = []
    with _service(buckets=(4, 8), max_wait_ms=2.0) as svc:
        rep = svc._pool.replicas[0]
        inner = rep.applier

        def spy(ds, deadline=None):
            seen.append((tuple(ds.array.shape), ds.n, ds.array.device.type))
            return inner(ds, deadline=deadline)

        rep.applier = spy
        svc.submit(np.ones(DIM, np.float32)).result(timeout=WAIT)
        [f.result(timeout=WAIT) for f in svc.submit_many(np.ones((6, DIM), np.float32))]
    assert seen[0] == ((4, DIM), 1, "cpu")
    assert {s[0] for s in seen} <= {(4, DIM), (8, DIM)}


# --------------------------------------------------- batcher state machine
def test_flush_on_max_batch():
    before = _counter("serve.batches")
    with _service(max_batch=4, max_wait_ms=10_000.0) as svc:
        t0 = time.monotonic()
        [f.result(timeout=WAIT) for f in svc.submit_many(np.ones((4, DIM), np.float32))]
        elapsed = time.monotonic() - t0
    assert elapsed < 5.0  # nowhere near the 10 s timer
    assert _counter("serve.batches") == before + 1


def test_flush_on_timer():
    with _service(max_batch=8, max_wait_ms=50.0) as svc:
        out = svc.submit(np.ones(DIM, np.float32)).result(timeout=WAIT)
    assert np.asarray(out).shape == (DIM,)


def test_fifo_order_preserved():
    xs = [np.full(DIM, float(i + 1), np.float32) for i in range(20)]
    with _service(max_batch=4, max_wait_ms=5.0) as svc:
        futs = [svc.submit(x) for x in xs]
        outs = [np.asarray(f.result(timeout=WAIT)) for f in futs]
    ref = _offline(np.stack(xs))
    for i, out in enumerate(outs):
        np.testing.assert_allclose(out, ref[i], rtol=1e-6, atol=1e-7)


def test_deadline_expired_request_is_shed():
    shed0 = _counter("serve.shed")
    with _service(max_batch=8, max_wait_ms=30.0) as svc:
        doomed = svc.submit(np.ones(DIM, np.float32), deadline=-0.01)
        live = svc.submit(np.ones(DIM, np.float32), deadline=30.0)
        with pytest.raises(guard.DeadlineExceeded):
            doomed.result(timeout=WAIT)
        assert np.asarray(live.result(timeout=WAIT)).shape == (DIM,)
    assert _counter("serve.shed") == shed0 + 1


def test_queue_bound_rejects_with_overloaded():
    rej0 = _counter("serve.rejected")
    svc = _service(max_batch=64, max_wait_ms=10_000.0, queue_bound=2)
    try:
        f1 = svc.submit(np.ones(DIM, np.float32))
        f2 = svc.submit(np.ones(DIM, np.float32))
        with pytest.raises(Overloaded):
            svc.submit(np.ones(DIM, np.float32))
        assert _counter("serve.rejected") == rej0 + 1
    finally:
        svc.close(timeout=WAIT)  # drain flushes the two queued requests
    assert np.asarray(f1.result(timeout=5)).shape == (DIM,)
    assert np.asarray(f2.result(timeout=5)).shape == (DIM,)


def test_clean_shutdown_drains_in_flight():
    svc = _service(max_batch=4, max_wait_ms=10_000.0)
    futs = [svc.submit(np.ones(DIM, np.float32)) for _ in range(10)]
    svc.close(timeout=WAIT)
    for f in futs:
        assert np.asarray(f.result(timeout=5)).shape == (DIM,)
    with pytest.raises(ServiceClosed):
        svc.submit(np.ones(DIM, np.float32))


def test_close_without_drain_fails_queued():
    svc = _service(max_batch=64, max_wait_ms=10_000.0)
    futs = [svc.submit(np.ones(DIM, np.float32)) for _ in range(3)]
    svc.close(drain=False, timeout=WAIT)
    for f in futs:
        with pytest.raises(ServiceClosed):
            f.result(timeout=5)


def test_cancelled_future_does_not_kill_batcher():
    with _service(max_batch=4, max_wait_ms=50.0) as svc:
        doomed = svc.submit(np.ones(DIM, np.float32))
        assert doomed.cancel()  # still queued: cancel succeeds
        later = svc.submit(np.ones(DIM, np.float32))
        assert np.asarray(later.result(timeout=WAIT)).shape == (DIM,)
        again = svc.submit(np.ones(DIM, np.float32))
        assert np.asarray(again.result(timeout=WAIT)).shape == (DIM,)


def test_rejected_first_call_does_not_fix_item_shape():
    with serve(_pipeline(), max_batch=4, max_wait_ms=5.0, queue_bound=2, devices=["cpu"]) as svc:
        with pytest.raises(Overloaded):
            svc.submit_many(np.ones((3, DIM + 1), np.float32))
        assert svc.queue_depth == 0  # atomic: nothing orphaned
        out = svc.submit(np.ones(DIM, np.float32)).result(timeout=WAIT)
        assert np.asarray(out).shape == (DIM,)


def test_shed_predictor_recovers_from_outlier_batch():
    with _service(max_batch=8, max_wait_ms=2.0) as svc:
        svc._ewma_batch_s = 5.0  # one 5 s outlier sample
        out = None
        for _ in range(30):  # decay: 5.0 * 0.7^n < 1.0 within ~5 flushes
            try:
                out = svc.submit(np.ones(DIM, np.float32), deadline=1.0).result(timeout=WAIT)
                break
            except guard.DeadlineExceeded:
                continue
        assert out is not None, "predictor never recovered"
        assert svc._ewma_batch_s < 1.0


def test_shape_mismatch_rejected_at_submit():
    with _service() as svc:
        good = svc.submit(np.ones(DIM, np.float32))
        with pytest.raises(TypeError, match="item shape"):
            svc.submit(np.ones(DIM + 1, np.float32))
        assert np.asarray(good.result(timeout=WAIT)).shape == (DIM,)


def _block(pool, x):
    """``x``'s rows in one shared-memory admission block (wire.alloc_block)."""
    blk = wire.alloc_block(pool, x.shape[0], x.shape[1:], x.dtype)
    blk.array[: x.shape[0]] = x
    return blk


def test_submit_batch_admits_a_block_atomically():
    x = np.random.default_rng(4).normal(size=(5, DIM)).astype(np.float32)
    pool = wire.SlabPool(prefix="t_submit_batch")
    try:
        with _service(max_batch=8, max_wait_ms=5.0, queue_bound=5) as svc:
            got = np.stack([f.result(timeout=WAIT) for f in svc.submit_batch(_block(pool, x))])
            with pytest.raises(TypeError, match="admission block"):
                svc.submit_batch(x)
        np.testing.assert_allclose(got, _offline(x), rtol=1e-6, atol=1e-7)
        svc = _service(max_batch=64, max_wait_ms=10_000.0, queue_bound=4)
        try:
            with pytest.raises(Overloaded):
                svc.submit_batch(_block(pool, x))
            assert svc.queue_depth == 0
        finally:
            svc.close(timeout=WAIT)
    finally:
        pool.close()


# ----------------------------------------------------------------- chaos
@pytest.mark.chaos
def test_chaos_enqueue_fault_backpressures_caller():
    with _service(max_batch=2, max_wait_ms=5.0) as svc:
        with faults.inject("serve.enqueue:times=1:raise"):
            with pytest.raises(faults.FaultInjected):
                svc.submit(np.ones(DIM, np.float32))
            assert np.asarray(svc.submit(np.ones(DIM, np.float32)).result(timeout=WAIT)).shape == (DIM,)


@pytest.mark.chaos
def test_chaos_batch_fault_fails_batch_not_service():
    err0 = _counter("serve.batch_errors")
    with _service(max_batch=2, max_wait_ms=5.0) as svc:
        with faults.inject("serve.batch:times=1:raise"):
            for f in svc.submit_many(np.ones((2, DIM), np.float32)):
                with pytest.raises(faults.FaultInjected):
                    f.result(timeout=WAIT)
            assert np.asarray(svc.submit(np.ones(DIM, np.float32)).result(timeout=WAIT)).shape == (DIM,)
    assert _counter("serve.batch_errors") == err0 + 1


@pytest.mark.chaos
@pytest.mark.hangs
def test_chaos_batch_stall_sheds_waiting_deadlines():
    with _service(max_batch=1, max_wait_ms=2.0, queue_bound=8) as svc:
        with faults.inject("serve.batch:times=1:delay=0.4"):
            slow = svc.submit(np.ones(DIM, np.float32), deadline=10.0)
            time.sleep(0.05)  # the worker is now inside the stalled flush
            doomed = svc.submit(np.ones(DIM, np.float32), deadline=0.05)
            assert np.asarray(slow.result(timeout=WAIT)).shape == (DIM,)
            with pytest.raises(guard.DeadlineExceeded):
                doomed.result(timeout=WAIT)


@pytest.mark.chaos
def test_walk_out_of_deadline_is_a_late_shed_not_a_replica_failure():
    """A flush whose walk runs past its riders' deadline fails them typed
    but leaves the replica's breaker closed: more such flushes than the
    breaker's threshold, and the lone replica still admits and serves."""
    shed0 = _counter("serve.shed")
    with _service(max_batch=1, max_wait_ms=0.0) as svc:
        rep = svc._pool.replicas[0]
        n = rep.breaker.threshold + 1
        with faults.inject("executor.stage:delay=0.3"):
            for _ in range(n):
                with pytest.raises(guard.DeadlineExceeded):
                    svc.submit(np.ones(DIM, np.float32), deadline=0.05).result(timeout=WAIT)
        assert rep.breaker.state() == "closed"
        assert rep.errors == 0
        out = svc.submit(np.ones(DIM, np.float32), deadline=WAIT).result(timeout=WAIT)
        assert np.asarray(out).shape == (DIM,)
    assert _counter("serve.shed") == shed0 + n


class _Flaky(Transformer):
    optional = True

    def apply_batch(self, xs, mask=None):
        raise RuntimeError("boom")


def test_optional_stage_degrades_on_serve_path():
    pipe = Pipeline.of(_Flaky()) | LinearMapper(torch.eye(DIM) * 3.0)
    deg0 = _counter("executor.degraded")
    x = np.random.default_rng(2).normal(size=(DIM,)).astype(np.float32)
    with _service(pipe, max_batch=4, max_wait_ms=5.0) as svc:
        assert svc._pool.replicas[0].applier._degradable
        out = np.asarray(svc.submit(x, request_id="deg-1").result(timeout=WAIT))
        tr = svc.recorder.request("deg-1")
    np.testing.assert_allclose(out, x * 3.0, rtol=1e-6)
    assert _counter("executor.degraded") > deg0
    assert tr["outcome"] == "degraded" and tr["events"][-1]["name"] == "serve.degraded"


# --------------------------------------------------------------- overload
@pytest.mark.hangs
def test_overload_keeps_accepting_with_bounded_queue():
    """Offered load above capacity (a serve.batch delay emulates a heavier
    model): the service keeps completing work, sheds or rejects the
    excess, and every completed request beats its deadline."""
    from keystone_tpu_torch.tools import serve_bench

    svc, item_shape = serve_bench.build_service(dim=16, max_batch=8, max_wait_ms=2.0, queue_bound=32,
                                                deadline_ms=500.0, device="cpu")
    try:
        rep = serve_bench.run_bench(svc, item_shape, qps=600.0, duration=1.5, deadline_ms=500.0,
                                    batch_delay_ms=15.0)
    finally:
        svc.close(timeout=WAIT)
    assert rep["completed"] > 0
    assert rep["mean_batch_occupancy"] > 1.0
    assert rep["shed"] + rep["rejected"] > 0
    assert rep["errors"] == 0
    assert rep["deadline_miss"] == 0
    assert rep["p99_ms"] is not None and rep["p99_ms"] < 500.0


@pytest.mark.parametrize("mode", ["threads", "processes"])
def test_host_profile_times_each_flush_step(mode):
    """tools/serve_hostprof on a narrow scorer: every request answered,
    each of the worker's steps timed, their sum a flush within the
    window's wall, each thread group's CPU read, and the wrappers gone
    afterwards."""
    from keystone_tpu_torch.serve import service as S
    from keystone_tpu_torch.tools import serve_hostprof as H

    submit = S.PipelineService.submit
    svc, images = H.build_scorer_service("cpu", small=True)
    try:
        r = H.run(svc, images, mode, n=32, clients=2, window=4)
    finally:
        svc.close(timeout=WAIT)
    assert r["requests"] == 32 and r["flushes"] >= 1 and r["p99_ms"] > 0
    steps = r["flush_ms"]
    assert all(steps[k] > 0 for k in ("stack", "to_device", "walk", "read", "deliver", "recorder"))
    assert steps["flush"] <= r["wall_ms_per_flush"]
    assert r["cpu_s"]["replica"] > 0 and r["cpu_s"]["client" if mode == "threads" else "front"] > 0
    assert r["client_submit_ms"] > 0
    assert S.PipelineService.submit is submit and S.pad_rows.__name__ == "pad_rows"


# ---------------------------------------------------- freeze: the FV fusion
def _fv_nodes(g):
    """The Fisher-vector stages of a graph, inside fused chains too."""
    out = []
    for op in g.operators.values():
        t = getattr(op, "transformer", None)
        for s in getattr(t, "stages", [t]):
            if s is not None and ("FV" in s.label or s.label == "FisherVector"):
                out.append(s.label)
    return sorted(out)


@pytest.fixture(scope="module")
def fitted_fv():
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
    from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV

    cfg = Config(num_classes=4, synthetic_n=16, image_size=32, gmm_k=4, pca_dims=8, gmm_iters=2, num_epochs=1)
    train = ImageNetLoader.synthetic(16, 4, (32, 32), seed=1, device="cpu")
    test = ImageNetLoader.synthetic(8, 4, (32, 32), seed=2, device="cpu")
    return ImageNetSiftLcsFV.build(cfg, train.data, train.labels).fit(), test


def test_freeze_fuses_fv_for_a_cuda_applier_only(fitted_fv, monkeypatch):
    """Freeze decides FV fusion by the applier's device: not for the CPU;
    for CUDA (the device check patched to call the applier's ``cpu:0`` a
    CUDA device, and not the test data's ``cpu``) both PCA → FV pairs
    fuse and SIFT's normalize moves into the fused node.  Either graph
    serves the offline top-k; ``Pipeline.apply`` on CPU data is
    unchanged."""
    fitted, test = fitted_fv
    want = fitted(test.data).get().numpy()
    cpu = fitted.freeze(device="cpu")
    assert _fv_nodes(cpu.graph) == ["FisherVector", "FisherVector"]
    monkeypatch.setattr(O, "device_is_cuda", lambda device: device == torch.device("cpu", 0))
    fused = fitted.freeze(device="cpu:0")
    assert _fv_nodes(fused.graph) == ["FusedFV[PCA > FV]", "FusedFV[SiftNorm > PCA > FV]"]
    assert _fv_nodes(O.default_optimizer().execute(fitted(test.data).graph)) == ["FisherVector", "FisherVector"]
    imgs = test.data.array
    np.testing.assert_array_equal(cpu(imgs).numpy(), want)
    np.testing.assert_array_equal(fused(imgs).numpy(), want)
    with serve(fused, max_batch=8, max_wait_ms=5.0, example=imgs[0].numpy()) as svc:
        got = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(imgs.numpy())])
    np.testing.assert_array_equal(got, want)


def test_small_scorer_served_as_the_reference_serves_it():
    """A small two-branch ImageNetSiftLcsFV scorer on the same seeded
    weights (carried across by convert.py), served by the reference's
    serve() (its rewritten fused chain, JAX on the CPU) and by the port's:
    raw scores within test_torch_slice.py's cross-package tolerance, and
    the same top-k ids."""
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
    from keystone_tpu_torch.convert import params_from_numpy
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as port

    raw = port.random_params(**SMALL)
    a = {k: jnp.asarray(v) for k, v in raw.items()}

    def fused(b, norm):
        return JFused(JPca(a[f"{b}.pca.components"], a[f"{b}.pca.mean"]),
                      JGmm(a[f"{b}.gmm.weights"], a[f"{b}.gmm.means"], a[f"{b}.gmm.variances"]), sift_normalize=norm)

    sift = (JPipeline.of(JPixel(only_if_integer=True)) | JGray()
            | JSift(step=CFG.sift_step, bin_sizes=(CFG.sift_bin_size,), normalize=False) | fused("sift", True)
            | JHell() | JNormalizeRows())
    lcs = (JPipeline.of(JPixel(only_if_integer=True)) | JLcs(CFG.lcs_step, CFG.lcs_subpatch) | fused("lcs", False)
           | JHell() | JNormalizeRows())
    jscores = JPipeline.gather([sift, lcs]) | JBlm(a["blm.weights"], a["blm.weights"].shape[1])
    imgs = _images(n=6)
    kw = dict(max_batch=4, max_wait_ms=5.0, example=imgs[0])
    with jserve(jscores, **kw) as ref:
        want = np.stack([np.asarray(f.result(timeout=120)) for f in ref.submit_many(imgs)])
    scorer = port.build_scorer_from_params(params_from_numpy(raw, device="cpu"), CFG, device="cpu")
    with serve(Pipeline.of(port.scores_of(scorer)), devices=["cpu"], **kw) as svc:
        got = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(imgs)])
    with serve(Pipeline.of(scorer), devices=["cpu"], **kw) as svc:
        top = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(imgs)])
    np.testing.assert_allclose(got, want, atol=ATOL_SCORES, rtol=0)
    np.testing.assert_array_equal(top, np.argsort(-want, axis=1, kind="stable")[:, :CFG.top_k])


def test_unported_options_name_their_roadmap_item():
    # the process and network fleets are ported: what they refuse is
    # their own argument errors, before anything is spawned
    for kw, why in ((dict(workers=2), "devices= applies to the thread fleet only"),
                    (dict(hosts="local:2"), "needs workers>=1"),
                    (dict(worker_opts={"device": "cpu"}), "workers>=1")):
        with pytest.raises(ValueError, match=why):
            serve(_pipeline(), devices=["cpu"], **kw)
    with pytest.raises(NotPortedError, match="A10"):
        _pipeline().freeze(device="cpu", validate=True)
    with pytest.raises(NotPortedError, match="A10"):
        _pipeline().freeze(device="cpu", plan=True)
    with _service() as svc:
        with pytest.raises(TypeError, match="A11d"):
            svc.submit(np.ones(DIM, np.float32), tenant="t1")


def test_artifacts_and_autoscale_options_serve():
    """``artifacts=`` and ``autoscale=`` are taken (the lifecycle slice):
    on the CPU the bundle is refused as backend skew and counted, the walk
    serves, and the autoscaler reports in /statusz."""
    app = _pipeline().freeze(device="cpu")
    bundle = app.export_artifacts(example=np.zeros(DIM, np.float32), buckets=(8,))
    assert bundle["manifest"]["signature"] == app.fingerprint() and app.install_artifacts(bundle) == 0
    f0 = _counter("serve.artifact_fallbacks")
    x = np.random.default_rng(0).normal(size=(3, DIM)).astype(np.float32)
    with _service(artifacts=bundle, autoscale={"min_workers": 1, "max_workers": 2}) as svc:
        got = np.stack([f.result(timeout=WAIT) for f in svc.submit_many(x)])
        st = svc.status()
        info = svc.swap(_pipeline(3.0), artifacts=bundle)
    np.testing.assert_allclose(got, _offline(x), rtol=1e-6, atol=1e-7)
    assert _counter("serve.artifact_fallbacks") >= f0 + 2  # the replica's install, the staged one's
    assert st["artifacts"]["configured"] and st["artifacts"]["installed_buckets"] == 0
    assert st["autoscaler"]["max_workers"] == 2 and info["replicas"] == 1
