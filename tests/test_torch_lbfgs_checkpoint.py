"""The port's checkpointed L-BFGS (keystone_tpu_torch/models/lbfgs.py
§ lbfgs_minimize_resumable, fit_checkpointed) against the JAX package's,
scenario by scenario as tests/test_lbfgs_checkpoint.py holds its own:
the chunked loop follows the plain fit, an interrupted fit resumes from
the saved carry (not from scratch) and lands on the uninterrupted fit, a
different problem's checkpoint is not resumed, and the sparse path
round-trips at vocabulary scale.  Each resumed fit lands on the
reference's uninterrupted ``fit_checkpointed`` within the L-BFGS parity
test's tolerances (tests/test_torch_text_ops.py), and the port resumes
dense and sparse checkpoints the reference wrote mid-fit."""

import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import keystone_tpu_torch.models.lbfgs as lb
from keystone_tpu.models import lbfgs as jlb
from keystone_tpu.workflow import Dataset as JDataset
from keystone_tpu_torch.models.lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
from keystone_tpu_torch.workflow.dataset import Dataset

TOL_WEIGHTS = 1e-3  # tests/test_torch_text_ops.py's, of the largest weight
RTOL_OBJECTIVE = 1e-5  # the same test's


def _cpu(a):
    return Dataset(a, device="cpu")


def _dense_problem(n=96, d=12, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    return x, (x @ w + 0.01 * rng.normal(size=(n, k))).astype(np.float32)


def _objective(x, y, w, lam):
    x, y, w = x.astype(np.float64), y.astype(np.float64), w.astype(np.float64)
    r = x @ w - y
    return 0.5 * np.sum(r * r) / x.shape[0] + 0.5 * lam * np.sum(w * w)


def _held(x, y, w, jw, lam):
    assert np.abs(w - jw).max() <= TOL_WEIGHTS * np.abs(jw).max()
    f, jf = _objective(x, y, w, lam), _objective(x, y, jw, lam)
    assert abs(f - jf) <= RTOL_OBJECTIVE * abs(jf)


def test_dense_checkpointed_matches_plain_fit(tmp_path):
    x, y = _dense_problem()
    est = DenseLBFGSwithL2(lam=1e-3, num_iterations=25, history=5)
    plain = est.fit_dataset(_cpu(x), _cpu(y))
    ckpt = est.fit_checkpointed(_cpu(x), _cpu(y), checkpoint_dir=str(tmp_path), checkpoint_every=7)
    assert torch.equal(ckpt.weights, plain.weights)  # the same steps, cut into chunks
    assert os.path.exists(tmp_path / "lbfgs_dense.npz")
    jm = jlb.DenseLBFGSwithL2(lam=1e-3, num_iterations=25, history=5).fit_checkpointed(
        JDataset(x), JDataset(y), checkpoint_dir=str(tmp_path / "j"), checkpoint_every=7)
    _held(x, y, ckpt.weights.numpy(), np.asarray(jm.weights), 1e-3)


def _crash_after(chunks):
    """``lbfgs_minimize_resumable`` that raises after ``chunks`` saves."""
    orig = lb.lbfgs_minimize_resumable
    state = {"chunks": 0}

    def crashing(fun, x0, **kw):
        real_save = kw["save_cb"]

        def counting_save(it, carry):
            real_save(it, carry)
            state["chunks"] += 1
            if state["chunks"] == chunks:
                raise RuntimeError("injected mid-fit kill")

        kw["save_cb"] = counting_save
        return orig(fun, x0, **kw)

    return orig, crashing


def _counting_callbacks(saves):
    orig = lb._lbfgs_checkpoint_callbacks

    def counting(*a, **kw):
        load_cb, save_cb = orig(*a, **kw)

        def save(it, carry):
            saves.append(it)
            save_cb(it, carry)

        return load_cb, save

    return orig, counting


def test_dense_interrupted_resumes_and_matches(tmp_path, monkeypatch):
    x, y = _dense_problem()
    est = DenseLBFGSwithL2(lam=1e-3, num_iterations=24, history=5)
    control = est.fit_checkpointed(_cpu(x), _cpu(y), checkpoint_dir=str(tmp_path / "control"), checkpoint_every=6)
    _, crashing = _crash_after(2)
    with monkeypatch.context() as m:
        m.setattr(lb, "lbfgs_minimize_resumable", crashing)
        with pytest.raises(RuntimeError, match="injected"):
            est.fit_checkpointed(_cpu(x), _cpu(y), checkpoint_dir=str(tmp_path / "crash"), checkpoint_every=6)
    with np.load(tmp_path / "crash" / "lbfgs_dense.npz") as z:
        assert int(z["it"]) == 12 and int(z["count"]) > 0
    saves = []
    _, counting = _counting_callbacks(saves)
    with monkeypatch.context() as m:
        m.setattr(lb, "_lbfgs_checkpoint_callbacks", counting)
        resumed = est.fit_checkpointed(_cpu(x), _cpu(y), checkpoint_dir=str(tmp_path / "crash"),
                                       checkpoint_every=6)
    assert saves == [18, 24]
    assert torch.equal(resumed.weights, control.weights)
    jm = jlb.DenseLBFGSwithL2(lam=1e-3, num_iterations=24, history=5).fit_checkpointed(
        JDataset(x), JDataset(y), checkpoint_dir=str(tmp_path / "j"), checkpoint_every=6)
    _held(x, y, resumed.weights.numpy(), np.asarray(jm.weights), 1e-3)


@pytest.mark.parametrize("intercept", [False, True])
def test_dense_resumes_the_references_checkpoint(tmp_path, monkeypatch, intercept):
    """The dense fingerprint and carry are the reference's: the port
    resumes a carry the reference saved after 12 of 24 iterations."""
    x, y = _dense_problem(seed=2)
    ckpt = str(tmp_path / "ckpt")
    jlb.DenseLBFGSwithL2(lam=1e-3, num_iterations=12, history=5, fit_intercept=intercept).fit_checkpointed(
        JDataset(x), JDataset(y), checkpoint_dir=ckpt, checkpoint_every=6)
    saves = []
    _, counting = _counting_callbacks(saves)
    with monkeypatch.context() as m:
        m.setattr(lb, "_lbfgs_checkpoint_callbacks", counting)
        got = DenseLBFGSwithL2(lam=1e-3, num_iterations=24, history=5, fit_intercept=intercept).fit_checkpointed(
            _cpu(x), _cpu(y), checkpoint_dir=ckpt, checkpoint_every=6)
    assert saves == [18, 24]
    jm = jlb.DenseLBFGSwithL2(lam=1e-3, num_iterations=24, history=5, fit_intercept=intercept).fit_checkpointed(
        JDataset(x), JDataset(y), checkpoint_dir=str(tmp_path / "j"), checkpoint_every=6)
    _held(x, y, got.weights.numpy(), np.asarray(jm.weights), 1e-3)
    if intercept:
        np.testing.assert_allclose(got.intercept.numpy(), np.asarray(jm.intercept), atol=TOL_WEIGHTS)


def test_checkpoint_rejected_for_different_problem(tmp_path):
    x, y = _dense_problem(seed=0)
    est = DenseLBFGSwithL2(lam=1e-3, num_iterations=10, history=4)
    est.fit_checkpointed(_cpu(x), _cpu(y), checkpoint_dir=str(tmp_path), checkpoint_every=5)
    x2, y2 = _dense_problem(seed=7)
    plain = est.fit_dataset(_cpu(x2), _cpu(y2))
    ckpt = est.fit_checkpointed(_cpu(x2), _cpu(y2), checkpoint_dir=str(tmp_path), checkpoint_every=5)
    assert torch.equal(ckpt.weights, plain.weights)
    est2 = DenseLBFGSwithL2(lam=1e-1, num_iterations=10, history=4)
    assert torch.equal(est2.fit_checkpointed(_cpu(x2), _cpu(y2), checkpoint_dir=str(tmp_path),
                                             checkpoint_every=5).weights,
                       est2.fit_dataset(_cpu(x2), _cpu(y2)).weights)


def test_completed_checkpoint_not_reused_for_shorter_fit(tmp_path):
    x, y = _dense_problem()
    long_model = DenseLBFGSwithL2(lam=1e-3, num_iterations=16, history=4).fit_checkpointed(
        _cpu(x), _cpu(y), checkpoint_dir=str(tmp_path), checkpoint_every=4)
    short = DenseLBFGSwithL2(lam=1e-3, num_iterations=8, history=4)
    got = short.fit_checkpointed(_cpu(x), _cpu(y), checkpoint_dir=str(tmp_path), checkpoint_every=4)
    assert torch.equal(got.weights, short.fit_dataset(_cpu(x), _cpu(y)).weights)
    assert (got.weights - long_model.weights).abs().max() > 1e-6


def _sparse_rows(n=192, d=50_000, k=3, nnz=8, seed=1):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        idx = rng.choice(d, size=nnz, replace=False)
        rows.append(sps.csr_matrix((rng.normal(size=nnz).astype(np.float32), (np.zeros(nnz), idx)), shape=(1, d)))
    return rows, rng.normal(size=(n, k)).astype(np.float32)


@pytest.mark.parametrize("intercept", [False, True])
def test_sparse_checkpointed_vocab_scale_resumes(tmp_path, monkeypatch, intercept):
    rows, y = _sparse_rows()
    est = SparseLBFGSwithL2(lam=1e-2, num_iterations=12, history=4, fit_intercept=intercept)
    plain = est.fit_dataset(_cpu(rows), _cpu(y))
    control = est.fit_checkpointed(_cpu(rows), _cpu(y), checkpoint_dir=str(tmp_path / "control"),
                                   checkpoint_every=4)
    # the same steps; the gradient's sums in the plan's order
    np.testing.assert_allclose(control.weights.numpy(), plain.weights.numpy(), rtol=0,
                               atol=1e-5 * float(plain.weights.abs().max()))
    orig = lb._lbfgs_checkpoint_callbacks

    def crashing_callbacks(*a, **kw):
        load_cb, save_cb = orig(*a, **kw)

        def save(it, carry):
            save_cb(it, carry)
            if it == 4:
                raise RuntimeError("injected mid-fit kill")

        return load_cb, save

    with monkeypatch.context() as m:
        m.setattr(lb, "_lbfgs_checkpoint_callbacks", crashing_callbacks)
        with pytest.raises(RuntimeError, match="injected"):
            est.fit_checkpointed(_cpu(rows), _cpu(y), checkpoint_dir=str(tmp_path / "crash"), checkpoint_every=4)
    with np.load(tmp_path / "crash" / "lbfgs_sparse.npz") as z:
        assert int(z["it"]) == 4
    resumed = est.fit_checkpointed(_cpu(rows), _cpu(y), checkpoint_dir=str(tmp_path / "crash"),
                                   checkpoint_every=4)
    assert torch.equal(resumed.weights, control.weights)
    jm = jlb.SparseLBFGSwithL2(lam=1e-2, num_iterations=12, history=4, fit_intercept=intercept).fit_checkpointed(
        JDataset(rows), JDataset(y), checkpoint_dir=str(tmp_path / "j"), checkpoint_every=4)
    w, jw = resumed.weights.numpy(), np.asarray(jm.weights)
    assert np.abs(w - jw).max() <= TOL_WEIGHTS * np.abs(jw).max()


def test_sparse_resumes_the_references_checkpoint(tmp_path, monkeypatch):
    """The sparse fingerprint (bucket shapes, first bucket row, indices
    as int32) and the carry are the reference's too."""
    rows, y = _sparse_rows(seed=3)
    ckpt = str(tmp_path / "ckpt")
    jlb.SparseLBFGSwithL2(lam=1e-2, num_iterations=4, history=4).fit_checkpointed(
        JDataset(rows), JDataset(y), checkpoint_dir=ckpt, checkpoint_every=4)
    saves = []
    _, counting = _counting_callbacks(saves)
    with monkeypatch.context() as m:
        m.setattr(lb, "_lbfgs_checkpoint_callbacks", counting)
        got = SparseLBFGSwithL2(lam=1e-2, num_iterations=12, history=4).fit_checkpointed(
            _cpu(rows), _cpu(y), checkpoint_dir=ckpt, checkpoint_every=4)
    assert saves == [8, 12]
    jm = jlb.SparseLBFGSwithL2(lam=1e-2, num_iterations=12, history=4).fit_checkpointed(
        JDataset(rows), JDataset(y), checkpoint_dir=str(tmp_path / "j"), checkpoint_every=4)
    w, jw = got.weights.numpy(), np.asarray(jm.weights)
    assert np.abs(w - jw).max() <= TOL_WEIGHTS * np.abs(jw).max()


def test_fixed_order_gradient_repeats_and_matches_the_scatter_add():
    """The checkpointed sparse path's gradient (a plan's segment sums)
    repeats bit for bit and is ``index_add_``'s to f32 rounding, in one
    row chunk and in several, duplicate and padding entries included."""
    from keystone_tpu_torch.ops import sparse

    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 40, (300, 6)))
    idx[:, -1] = idx[:, 0]  # a duplicate in every row
    vals = torch.from_numpy(rng.normal(size=(300, 6)).astype(np.float32))
    vals[::7, 2] = 0.0  # padding entries
    r = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    want = sparse.sparse_grad(idx, vals, r, 50)
    for budget in (sparse._CHUNK_BUDGET, 1):  # one chunk; chunks of 128 rows
        old, sparse._CHUNK_BUDGET = sparse._CHUNK_BUDGET, budget
        try:
            plan = sparse.scatter_plan(idx, 3)
            assert len(plan) == (1 if budget > 1 else 3)
            got = sparse.sparse_grad(idx, vals, r, 50, plan)
            assert torch.equal(got, sparse.sparse_grad(idx, vals, r, 50, plan))
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-5)
        finally:
            sparse._CHUNK_BUDGET = old


def test_chunk_telemetry_under_a_ledger(tmp_path):
    """With a run ledger each chunk reports its objective, gradient norm
    and save seconds, as the reference's ``lbfgs.chunk`` series."""
    import json

    from keystone_tpu_torch.obs import ledger

    x, y = _dense_problem()
    led = ledger.start_run(str(tmp_path / "obs"))
    try:
        DenseLBFGSwithL2(lam=1e-3, num_iterations=12, history=4).fit_checkpointed(
            _cpu(x), _cpu(y), checkpoint_dir=str(tmp_path / "c"), checkpoint_every=4)
    finally:
        ledger.stop_run()
    events = [json.loads(line) for line in open(led.path)]
    chunks = [e["attrs"] for e in events if e["name"] == "solver.epoch" and e["attrs"]["solver"] == "lbfgs.chunk"]
    assert [c["it"] for c in chunks] == [4, 8, 12]
    assert all(c["checkpoint_save_seconds"] >= 0 and c["grad_norm"] >= 0 for c in chunks)
