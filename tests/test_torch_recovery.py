"""Recovery in the port (keystone_tpu_torch/workflow/recovery.py,
workflow/state.py, the executor's stage retries): the scenarios of the
JAX package's tests/test_faulttol.py and tests/test_savedstate.py that
belong to one process (its Gloo cases go with the multi-process slice),
plus a fit killed by an ``exit`` fault in a child process and relaunched,
which resumes from its epoch checkpoint and ends where the uninterrupted
fit ends.  The child processes run this file as a script (``__main__``
below)."""

import glob
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.executor import GraphExecutor
from keystone_tpu_torch.workflow.pipeline import Pipeline, PipelineEnv
from keystone_tpu_torch.workflow.recovery import _world_size, fit_with_recovery
from keystone_tpu_torch.workflow.transformer import Transformer

REPO = Path(__file__).resolve().parents[1]


def _cpu(a, name=None):
    return Dataset(np.asarray(a, np.float32), name=name, device="cpu")


def _problem(seed=0, n=128, d=24, k=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(n, k)).astype(np.float32)


class _Flaky(Transformer):
    fails = 0
    budget = 0

    def params(self):
        return ()

    def apply_dataset(self, ds):
        if _Flaky.fails < _Flaky.budget:
            _Flaky.fails += 1
            raise RuntimeError("transient device loss")
        return ds.with_array(ds.array + 1.0)


def test_executor_stage_retry_recovers_transient_failure():
    _Flaky.fails, _Flaky.budget = 0, 2
    lazy = Pipeline.of(_Flaky())(_cpu(np.ones((4, 2))))
    out = GraphExecutor(lazy.graph, node_retries=2).execute(lazy.graph.sinks[0])
    np.testing.assert_allclose(out.dataset.array.numpy(), 2.0)
    _Flaky.fails, _Flaky.budget = 0, 3
    lazy = Pipeline.of(_Flaky())(_cpu(np.ones((4, 2))))
    with pytest.raises(RuntimeError, match="transient"):
        GraphExecutor(lazy.graph, node_retries=2).execute(lazy.graph.sinks[0])
    prev = PipelineEnv.node_retries
    PipelineEnv.node_retries = 2
    try:
        _Flaky.fails, _Flaky.budget = 0, 2
        np.testing.assert_allclose(Pipeline.of(_Flaky())(_cpu(np.ones((4, 2)))).get().array.numpy(), 2.0)
    finally:
        PipelineEnv.node_retries = prev


def test_stage_retries_env_parsing(monkeypatch):
    monkeypatch.setattr(PipelineEnv, "node_retries", None)
    monkeypatch.setenv("KEYSTONE_STAGE_RETRIES", "3")
    assert PipelineEnv.stage_retries() == 3
    monkeypatch.setenv("KEYSTONE_STAGE_RETRIES", "two")
    assert PipelineEnv.stage_retries() == 0
    monkeypatch.setenv("KEYSTONE_STAGE_RETRIES", "-4")
    assert PipelineEnv.stage_retries() == 0
    monkeypatch.setattr(PipelineEnv, "node_retries", 5)
    assert PipelineEnv.stage_retries() == 5


def test_single_process_world():
    assert _world_size() == 1


class Expensive(Transformer):
    """A featurizer whose executions are counted (the prefix worth saving)."""

    calls = 0

    def __init__(self, tag: str):
        super().__init__()
        self.tag = tag

    def params(self):
        return (self.tag,)

    def apply_batch(self, xs, mask=None):
        Expensive.calls += 1
        return xs * 2.0


def _recovery_with_saved_prefix(pkg, tmp_path):
    """The reference's composed recovery story in either package: a
    featurize prefix saved by ``save_pipeline_state`` is reloaded (not
    recomputed) by the attempt that ``fit_with_recovery`` restarts."""
    x, y = _problem(n=32, d=6, k=2)
    state_dir = str(tmp_path / pkg)
    if pkg == "port":
        from keystone_tpu_torch.models.linear import LinearMapEstimator
        from keystone_tpu_torch.workflow.state import save_pipeline_state

        E, P, fwr, LM = Expensive, Pipeline, fit_with_recovery, LinearMapEstimator

        def ds(a, name=None):
            return _cpu(a, name)

        def calls():
            return Expensive.calls
    else:
        from test_aux import Expensive as E
        from test_aux import expensive_calls as calls

        from keystone_tpu.models import LinearMapEstimator as LM
        from keystone_tpu.workflow import Dataset as JD
        from keystone_tpu.workflow import Pipeline as P
        from keystone_tpu.workflow import fit_with_recovery as fwr
        from keystone_tpu.workflow.state import save_pipeline_state

        def ds(a, name=None):
            return JD(a, name=name)
    featurizer = P.of(E("prefix"))
    E.calls = 0
    assert save_pipeline_state(featurizer(ds(x, "rec-train")), state_dir) >= 1
    assert calls() >= 1
    attempt = {"n": 0}

    def build():
        attempt["n"] += 1
        if attempt["n"] == 1:
            raise RuntimeError("injected pre-fit failure")
        return featurizer.and_then(LM(lam=1e-3), ds(x, "rec-train"), ds(y))

    E.calls = 0
    fitted, attempts = fwr(build, state_dir=state_dir, max_restarts=2)
    assert attempts == 1 and calls() == 0, calls()
    return np.asarray(fitted(ds(x, "rec-train")).get().numpy())


def test_fit_with_recovery_reuses_saved_featurize_prefix(tmp_path):
    got = _recovery_with_saved_prefix("port", tmp_path)
    want = _recovery_with_saved_prefix("reference", tmp_path)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert PipelineEnv.state_dir is None  # restored after the call


def test_fit_with_recovery_restarts_and_resumes(tmp_path, monkeypatch):
    """A first attempt that dies after two epoch sweeps is restarted; the
    epoch checkpoint makes the second attempt resume (three sweeps, not
    five) and the model equals an uninterrupted fit."""
    import keystone_tpu_torch.models.block_ls as bls

    x, y = _problem()
    ckpt = str(tmp_path / "solver-ckpt")
    est = BlockLeastSquaresEstimator(block_size=8, num_iter=5, lam=1e-3, fit_intercept=False, checkpoint_dir=ckpt)
    reference = BlockLeastSquaresEstimator(block_size=8, num_iter=5, lam=1e-3, fit_intercept=False).fit_arrays(
        x, y, device="cpu")
    state = {"sweeps": 0, "crashed": False}
    orig = bls._bcd_epoch_body

    def flaky_epoch(*args):
        if state["sweeps"] == 2 and not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("injected mid-fit failure")
        state["sweeps"] += 1
        return orig(*args)

    monkeypatch.setattr(bls, "_bcd_epoch_body", flaky_epoch)
    fitted, attempts = fit_with_recovery(lambda: est.with_data(_cpu(x), _cpu(y)), max_restarts=1)
    assert attempts == 1 and state["sweeps"] == 5
    got = fitted(_cpu(x)).get().numpy()
    np.testing.assert_allclose(got, reference(torch.from_numpy(x)).numpy(), atol=1e-5)


def test_fit_with_recovery_quarantines_corrupt_state_between_attempts(tmp_path):
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.utils import durable

    state_dir = tmp_path / "state"
    state_dir.mkdir()
    bad = str(state_dir / "junk.npz")
    durable.save_npz(bad, {"w": np.ones(8)})
    with open(bad, "r+b") as f:
        f.seek(os.path.getsize(bad) // 2)
        f.write(b"\xff\xff")
    x, y = _problem(1, n=32, d=8, k=2)
    est = BlockLeastSquaresEstimator(block_size=4, num_iter=1, lam=1e-3)
    with faults.inject("executor.stage:times=1:raise"):
        _, attempts = fit_with_recovery(lambda: est.with_data(_cpu(x), _cpu(y)), state_dir=str(state_dir),
                                        max_restarts=1)
    assert attempts == 1
    assert os.path.exists(bad + ".corrupt") and not os.path.exists(bad)


def _child(phase, *args, env=None):
    e = dict(os.environ, PYTHONPATH=str(REPO))
    e.pop("KEYSTONE_FAULTS", None)
    e.update(env or {})
    return subprocess.run([sys.executable, __file__, phase, *args], capture_output=True, text=True, timeout=300,
                          env=e, cwd=str(REPO))


def test_saved_prefixes_reload_in_new_process(tmp_path):
    """A later run in a new process reloads the prefixes an earlier one
    saved (named datasets keep their signatures stable)."""
    state = str(tmp_path / "state")
    save = _child("save-state", state)
    assert save.returncode == 0, save.stderr[-2000:]
    assert "SAVED n=" in save.stdout and "SAVED n=0" not in save.stdout
    load = _child("load-state", state)
    assert load.returncode == 0, load.stderr[-2000:]
    assert "reloaded saved prefix" in load.stderr + load.stdout
    assert re.search(r"checksum=(\S+)", load.stdout).group(1) == re.search(r"checksum=(\S+)", save.stdout).group(1)


def test_killed_fit_is_relaunched_and_resumes(tmp_path):
    """The port's process-level story: a streamed fit under
    ``fit_with_recovery`` is killed by ``exit`` at its second epoch
    checkpoint (a stage and a stream batch fail first and are survived);
    the relaunch resumes the out-of-core BCD after epoch 1 and its model
    equals the uninterrupted fit bit for bit."""
    work = str(tmp_path / "work")
    obs = str(tmp_path / "obs")
    plan = "executor.stage:times=1:raise;stream.batch:after=2:times=1:raise;ckpt.save:after=1:exit=17"
    first = _child("fit", work, env={"KEYSTONE_FAULTS": plan, "KEYSTONE_OBS_DIR": obs})
    assert first.returncode == 17, first.stderr[-2000:]
    assert "FITTED" not in first.stdout
    second = _child("fit", work, env={"KEYSTONE_OBS_DIR": obs})
    assert second.returncode == 0, second.stderr[-2000:]
    assert re.search(r"RESUMED_FROM 1\b", second.stdout), second.stdout
    straight = _child("fit", str(tmp_path / "straight"))
    digest = re.compile(r"FITTED digest=(\w+)")
    assert digest.search(second.stdout).group(1) == digest.search(straight.stdout).group(1)
    events = [json.loads(line) for p in glob.glob(os.path.join(obs, "run_*.jsonl")) for line in open(p)]
    names = {e["name"] for e in events}
    assert {"pipeline.fit", "executor.stage", "executor.retry", "solver.spill"} <= names


# ----------------------------------------------------------- child side


def _child_state(phase, state_dir):
    from keystone_tpu_torch.ops.stats import LinearRectifier

    logging.basicConfig(level=logging.INFO)
    x = np.random.default_rng(3).normal(size=(64, 16)).astype(np.float32)
    data = _cpu(x, name="saved-state-train")
    pipe = Pipeline.of(Expensive("a")).and_then(LinearRectifier(0.0))
    if phase == "save-state":
        from keystone_tpu_torch.workflow.state import save_pipeline_state

        result = pipe(data)
        saved = save_pipeline_state(result, state_dir)
        out = result.get().numpy()
        print(f"SAVED n={saved} checksum={np.abs(out).sum():.4f}", flush=True)
    else:
        PipelineEnv.state_dir = state_dir
        out = pipe(data).get().numpy()
        print(f"LOADED checksum={np.abs(out).sum():.4f}", flush=True)


def _child_fit(work):
    import hashlib

    from keystone_tpu_torch.loaders.stream import batched
    from keystone_tpu_torch.utils import durable
    from keystone_tpu_torch.workflow.dataset import StreamDataset

    x, y = _problem(4, n=96, d=32)
    ckpt = os.path.join(work, "ckpt")
    path = os.path.join(ckpt, "oc_bcd_epoch.npz")
    loaded = durable.load_npz(path)
    if loaded is not None:
        print(f"RESUMED_FROM {int(loaded[0]['epoch']) + 1}", flush=True)
    est = BlockLeastSquaresEstimator(block_size=8, num_iter=3, lam=1e-3, checkpoint_dir=ckpt)
    PipelineEnv.node_retries = 1

    def build():
        stream = StreamDataset(batched(x, 16), n=96, retries=2, device="cpu")
        return Pipeline.of(Expensive("f")).and_then(est, stream, _cpu(y))

    fitted, _ = fit_with_recovery(build, state_dir=os.path.join(work, "state"))
    pred = fitted(_cpu(x)).get().numpy()
    print(f"FITTED digest={hashlib.sha256(pred.tobytes()).hexdigest()}", flush=True)


if __name__ == "__main__":
    import logging

    if sys.argv[1] == "fit":
        _child_fit(sys.argv[2])
    else:
        _child_state(sys.argv[1], sys.argv[2])
