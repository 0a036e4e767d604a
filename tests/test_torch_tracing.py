"""The port's tracing helpers against the JAX package's, on the CPU
(tests/test_tracing.py:28-67): ``stage_timings`` labels the nodes of a
lazy result as the reference's does, a fit node's solve is charged to
the fit node, ``trace()`` writes a trace, and ``profile_fit`` splits a
tiny fit by rule batch.
"""

import json
import os

import numpy as np

from keystone_tpu.ops import LinearRectifier as JLinearRectifier
from keystone_tpu.ops import RandomSignNode as JRandomSignNode
from keystone_tpu.utils import tracing as jtracing
from keystone_tpu.workflow import Dataset as JDataset
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu_torch.models.linear import LinearMapEstimator
from keystone_tpu_torch.ops.stats import LinearRectifier, RandomSignNode
from keystone_tpu_torch.ops.util import ClassLabelIndicators
from keystone_tpu_torch.tools import profile_fit
from keystone_tpu_torch.utils import tracing
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import Pipeline

X = np.random.default_rng(0).normal(size=(32, 16)).astype(np.float32)


def _toy_results():
    pipe = Pipeline.of(RandomSignNode.init(16, seed=0, device="cpu")).and_then(LinearRectifier(0.0))
    jpipe = JPipeline.of(JRandomSignNode.init(16, seed=0)).and_then(JLinearRectifier(0.0))
    return pipe(Dataset(X, device="cpu")), jpipe(JDataset(X))


def _labels(timings):
    return sorted(k.split(":", 1)[1] for k in timings)


def test_stage_timings_labels_every_node_as_the_reference():
    result, jresult = _toy_results()
    got, want = tracing.stage_timings(result), jtracing.stage_timings(jresult)
    assert got and _labels(got) == _labels(want)
    labels = " ".join(got)
    assert "RandomSignNode" in labels and "LinearRectifier" in labels
    assert all(t >= 0 for t in got.values())


def test_stage_timings_charge_the_fit_node():
    rng = np.random.default_rng(0)
    x = Dataset(rng.normal(size=(512, 128)).astype(np.float32), device="cpu")
    y = ClassLabelIndicators(4)(Dataset(rng.integers(0, 4, size=(512,)).astype(np.int32), device="cpu"))
    timings = tracing.stage_timings(Pipeline.of(LinearRectifier(0.0)).and_then(LinearMapEstimator(lam=1e-2), x, y)(x))
    # NodeChoiceRule may swap the small problem to the local solve
    fit_keys = [k for k in timings if "LeastSquares" in k or "LinearMap" in k]
    assert fit_keys, f"fit node missing from timings: {list(timings)}"
    assert timings[fit_keys[0]] >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tracing.trace(logdir, annotation="toy-pipeline"):
        with tracing.step_annotation(0):
            _toy_results()[0].get()
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "toy-pipeline" in names and "step#0" in names
    tracing.start_trace(logdir)
    path = tracing.stop_trace()
    assert os.path.isfile(path) and len(os.listdir(logdir)) == 2


def test_profile_fit_splits_a_tiny_fit(capsys):
    assert profile_fit.main(["8", "--device", "cpu", "--image-size", "32"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out["batches"]) == ["cse", "node-choice", "materialize", "fusion"]
    assert all(v >= 0 for v in out["batches"].values()) and out["execute"] > 0
    assert any("fit[BlockWeightedLeastSquaresEstimator]" in label for _, label in out["nodes"])
