"""The port's per-stage roofline of the bench forward
(keystone_tpu_torch/tools/roofline_forward.py) on the CPU: its per-stage
flops sum to bench.py::flops_per_image (the reference's count) in both
configurations, its byte counts are the stages' real tensors, the trace
aggregation joins device work to its stage on a recorded trace, and a CPU
run reports host time as host time.  Device times come from the card
alone (chip_smoke.py).

Tolerances: none; counts are compared exactly."""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

import bench  # noqa: E402

from keystone_tpu_torch.tools import roofline_forward as R  # noqa: E402

SMALL = dict(hw=32, d=8, k=4, classes=5)


@pytest.mark.parametrize("bins", [(4,), (4, 6, 8, 10)], ids=["single-scale", "multi-scale"])
@pytest.mark.parametrize("smoothing", [True, False])
def test_stage_flops_sum_to_the_references(bins, smoothing):
    per_stage = R.stage_flops_per_image(bins, smoothing)
    assert set(per_stage) == set(R.STAGES)
    assert sum(per_stage.values()) == bench.flops_per_image(bins, smoothing=smoothing)
    assert R.flops_per_image(bins, smoothing) == bench.flops_per_image(bins, smoothing=smoothing)
    for s in ("gray", "hellinger", "normalize"):
        assert per_stage[s] == 0.0  # elementwise work, uncounted as in bench.py


def test_fv_stage_is_priced_as_the_kernel_line():
    """The FV stage's bytes and flops are chip_smoke.py's fv_cost at the
    forward's shape (the kernels line's B2 row)."""
    c = R.stage_costs(128)["fv"]
    t = 784
    assert (c["bytes"], c["flops"]) == tuple(map(float, R.fv_cost(128, t, 64, 256)))
    # B2's tensor-core bound at (128, 784, 64) K = 256: 0.0797 ms
    assert 3 * c["flops"] / R.PEAK_TF32_FLOPS == pytest.approx(c["flops"] / c["peak_flops"])


@pytest.mark.parametrize("ms", [False, True], ids=["single-scale", "multi-scale"])
def test_stage_bytes_are_the_stages_tensors(ms):
    """Each stage's bytes: its inputs and weights read once, its outputs
    written once, as the stages' real tensors on a CPU run size them."""
    bins = R.MS_BIN_SIZES if ms else (R.BIN_SIZE,)
    n = 2
    stages, x = R.build(n, bins, 6.0, torch.device("cpu"), **SMALL)
    costs = R.stage_costs(n, bins, True, **{k: v for k, v in SMALL.items()})
    mask = None
    with torch.no_grad():
        for name, stage in zip(R.STAGES, stages):
            ins = x.nbytes + (mask.nbytes if mask is not None and name in ("fv",) else 0)
            weights = sum(t.nbytes for t in stage.buffers()) + sum(t.nbytes for t in stage.parameters())
            out = stage.apply_batch(x, mask=mask)
            x, mask = out if isinstance(out, tuple) else (out, None)
            outs = x.nbytes + (mask.nbytes if name == "sift" else 0)
            assert costs[name]["bytes"] == ins + weights + outs, name


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid, "ts": ts, "dur": dur, "args": args}


def test_aggregation_joins_device_work_to_its_stage(tmp_path):
    """A trace written as torch.profiler writes one on the card: regions
    on the host thread, launches inside them, kernels on the device
    joined by correlation id; a launch outside every region and one from
    another thread count for no stage."""
    events = []
    corr = 0
    for it in range(2):
        base = 1000.0 * it
        for j, stage in enumerate(("sift", "fv")):
            t0 = base + 100.0 * j
            events.append(_ev("user_annotation", f"{R.PREFIX}{stage}#{it}", t0, 90.0))
            for m in range(2):
                corr += 1
                events.append(_ev("cuda_runtime", "cudaLaunchKernel", t0 + 10 + 30 * m, 5.0, correlation=corr))
                events.append(_ev("kernel", f"k{stage}", t0 + 500 + 30 * m, 10.0 + it + m, tid=20, correlation=corr))
    corr += 1
    events.append(_ev("cuda_runtime", "cudaLaunchKernel", 5000.0, 5.0, correlation=corr))
    events.append(_ev("kernel", "stray", 5200.0, 77.0, tid=20, correlation=corr))
    corr += 1
    events.append(_ev("cuda_runtime", "cudaMemcpyAsync", 15.0, 5.0, tid=2, correlation=corr))
    events.append(_ev("gpu_memcpy", "Memcpy HtoD", 600.0, 50.0, tid=21, correlation=corr))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = R.aggregate(R.load_trace(str(path)))
    assert got == {"sift": [21.0, 23.0], "fv": [21.0, 23.0]}
    assert R.device_busy_us(R.load_trace(str(path))) == 2 * (21.0 + 23.0) + 77.0 + 50.0
    assert R.aggregate(R.load_trace(str(path)), host=True) == {"sift": [90.0, 90.0], "fv": [90.0, 90.0]}


def test_a_cpu_run_reports_host_regions_from_its_own_trace(tmp_path):
    """The CPU run records a real trace into tmp_path through
    utils/tracing.py and reads its regions back: every stage of every
    iteration, on the host clock, named as such, with no device field."""
    r = R.run(batch=2, device="cpu", trace_iters=2, wall_iters=(1, 2), logdir=str(tmp_path), **SMALL)
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1
    events = R.load_trace(str(traces[0]))
    assert R.aggregate(events, host=True) == r["stage_iters_us"]
    assert [s["stage"] for s in r["stages"]] == list(R.STAGES)
    assert all(len(v) == 2 and all(u > 0 for u in v) for v in r["stage_iters_us"].values())
    assert r["device"] == "cpu" and r["clock"].startswith("host") and "device_busy_us" not in r
    assert r["fv_path"] == "plain chain" and r["launches"] == {}
    assert r["flops_per_image"] == R.flops_per_image((4,), True, **SMALL)


def test_a_stage_faster_than_its_bound_is_a_counting_error():
    costs = R.stage_costs(128)
    fast = {s: 1e6 for s in R.STAGES}
    rows = R.roofline(fast, costs)
    assert all(r["fraction"] < 1 for r in rows)
    fv = next(r for r in rows if r["stage"] == "fv")
    assert fv["bound_by"] == "operations" and fv["bound_us"] == pytest.approx(79.7, abs=0.1)
    fast["fv"] = fv["bound_us"] / 1.2
    with pytest.raises(R.CountingError):
        R.roofline(fast, costs)
    assert R.roofline(fast, costs, check=False)[3]["fraction"] == pytest.approx(1.2)


def test_the_tool_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    assert R.main([]) == 2
    assert "--device cpu" in capsys.readouterr().out
