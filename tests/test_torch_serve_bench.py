"""serve_bench's modes on the CPU (``keystone_tpu_torch/tools/serve_bench.py``
against the reference's ``tools/serve_bench.py``): every flag of the
reference's ``main``, each mode run with ``--device cpu``, sub-second legs
and one round, with the reference's report keys and pass conditions;
``GilBurnFeature`` bit for bit with the reference's; the zoo replay's
digest equal to the reference's; the cold-start arms without a fallback
and with one prediction digest; and the ingress A/B's ``ok`` with its
exit code."""

import json

import numpy as np
import pytest
import torch

from keystone_tpu_torch.tools import serve_bench
from keystone_tpu_torch.tools.gilburn import GilBurnFeature

# the reference's report keys (tools/serve_bench.py), mode by mode
REF_KEYS = {
    "overhead": {"offered_qps", "duration_s", "rounds", "batch_delay_ms", "recorder_on", "recorder_off", "overhead"},
    "straggler": {"offered_qps", "duration_s", "rounds", "replicas", "straggler_ms", "hedge_ms", "hedged", "unhedged",
                  "hedging"},
    "procs": {"offered_qps", "duration_s", "rounds", "workers", "cores", "burn_rounds", "thread_qps", "process_qps",
              "thread_p99_ms", "process_p99_ms", "speedup", "achievable_speedup", "cores_limited",
              "predictions_identical", "prediction_sha", "ok", "note"},
    "ingress": {"mode", "duration_s", "rounds", "dim", "max_batch", "shards", "bin_batch", "http", "binary", "speedup",
                "predictions_identical", "preformed_flushes", "bytes_copied", "ok"},
    "autoscale": {"offered_qps", "duration_s", "submitted", "completed", "errors", "hung", "peak_workers",
                  "final_workers", "workers_track", "scaled_up", "scaled_down", "autoscaler", "ok"},
    "cold_start": {"rounds", "dim", "max_batch", "first_prediction_s", "ready_s", "predictions_match", "samples",
                   "prime_sources"},
    "cold_start_arm": {"arm", "model_load_s", "ready_s", "first_prediction_s", "prime_sources", "artifact_hits",
                       "artifact_fallbacks", "prediction_sha", "prediction_head"},
    "restart": {"rounds", "dim", "max_batch", "restart_to_rejoin_s", "predictions_match", "samples"},
    "restart_arm": {"arm", "restart_to_rejoin_s", "reason", "restarts", "prediction_sha", "prediction_head"},
    "scenario": {"scenario", "wall_seconds", "outcomes", "submitted_rows", "qps_achieved", "p50_ms", "p99_ms"},
}


def _run_main(capsys, *argv):
    rc = serve_bench.main(list(argv))
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("rounds,dim", [(1, 8), (300, 64), (17, 33)])
def test_gilburn_is_the_references_bit_for_bit(rounds, dim):
    from keystone_tpu.workflow import Dataset as JDataset
    from tools.gilburn import GilBurnFeature as JGilBurn

    x = np.random.default_rng(rounds).normal(size=(9, dim)).astype(np.float32)
    want = np.asarray(JGilBurn(rounds).apply_dataset(JDataset(x, shard=False)).array)
    feat = GilBurnFeature(rounds)
    got = feat.apply_batch(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.numpy().tobytes() == want.tobytes()
    assert feat.apply_one(torch.from_numpy(x[2])).numpy().tobytes() == want[2].tobytes()
    assert feat.params() == (rounds,) and not feat.fusable


def test_main_takes_every_flag_of_the_reference(monkeypatch, capsys):
    """Each mode's flags reach its runner (the runners stubbed): the
    reference's names, the port's --rounds/--shards aliases and --device."""
    calls = {}

    def stub(name, ok=True):
        def run(*args, **kw):
            calls[name] = (args, kw)
            return {"ok": ok}
        return run

    for fn in ("run_scenario", "run_ingress_ab", "run_procs_ab", "run_autoscale_scenario", "run_cold_start_ab",
               "run_restart_ab", "run_plan_ab", "run_tenants_ab", "run_cold_start", "run_restart"):
        monkeypatch.setattr(serve_bench, fn, stub(fn))
    assert serve_bench.main(["--scenario", "drift", "--scenario-seed", "7", "--duration", "0.5", "--qps", "90",
                             "--replicas", "2", "--device", "cpu"]) == 0
    assert calls["run_scenario"][0] == ("drift",) and calls["run_scenario"][1]["seed"] == 7
    assert calls["run_scenario"][1]["replicas"] == 2 and calls["run_scenario"][1]["device"] == "cpu"
    assert serve_bench.main(["--ingress-ab", "--ab-rounds", "3", "--ingress-shards", "1", "--http-clients", "5",
                             "--bin-clients", "2", "--workers", "1"]) == 0
    kw = calls["run_ingress_ab"][1]
    assert (kw["rounds"], kw["shards"], kw["http_clients"], kw["bin_clients"], kw["workers"]) == (3, 1, 5, 2, 1)
    assert serve_bench.main(["--ingress-ab", "--rounds", "4", "--shards", "3"]) == 0  # the port's aliases
    assert (calls["run_ingress_ab"][1]["rounds"], calls["run_ingress_ab"][1]["shards"]) == (4, 3)
    assert serve_bench.main(["--procs-ab", "--burn-rounds", "50", "--ab-rounds", "1"]) == 0
    kw = calls["run_procs_ab"][1]
    assert (kw["workers"], kw["burn_rounds"], kw["rounds"], kw["device"]) == (2, 50, 1, "cuda")
    assert serve_bench.main(["--autoscale-scenario", "--burn-rounds", "60", "--qps", "10"]) == 0
    assert calls["run_autoscale_scenario"][1]["burn_rounds"] == 60
    assert serve_bench.main(["--cold-start", "--ab-rounds", "1", "--dim", "8", "--max-batch", "16"]) == 0
    assert calls["run_cold_start_ab"][1]["rounds"] == 1 and calls["run_restart_ab"][1]["max_batch"] == 16
    assert serve_bench.main(["--tenants", "2", "--tenant-branches", "3", "--rounds", "1"]) == 0
    assert calls["run_tenants_ab"][1]["branches"] == 3 and calls["run_tenants_ab"][1]["rounds"] == 1
    assert serve_bench.main(["--plan-ab", "--ab-rounds", "2"]) == 0 and calls["run_plan_ab"][1]["rounds"] == 2
    for flag, fn in (("--cold-start-arm", "run_cold_start"), ("--restart-arm", "run_restart")):
        assert serve_bench.main([flag, "compile", "--registry", "/nowhere", "--dim", "8", "--max-batch", "16",
                                 "--device", "cpu", "--example-shape", "4,4,3", "--dtype", "uint8"]) == 0
        args, kw = calls[fn]
        assert args == ("compile", "/nowhere") and kw["item_shape"] == (4, 4, 3) and kw["dtype"] == np.uint8
    capsys.readouterr()


@pytest.mark.parametrize("flag", ["--ingress-ab", "--procs-ab", "--autoscale-scenario"])
def test_a_gated_mode_exits_1_when_not_ok(monkeypatch, capsys, flag):
    for fn in ("run_ingress_ab", "run_procs_ab", "run_autoscale_scenario"):
        monkeypatch.setattr(serve_bench, fn, lambda **kw: {"ok": False, "speedup": 1.0})
    rc, rep = _run_main(capsys, flag, "--device", "cpu")
    assert rc == 1 and rep["ok"] is False


def test_ingress_ab_carries_the_references_ok(capsys):
    rc, rep = _run_main(capsys, "--ingress-ab", "--device", "cpu", "--duration", "0.3", "--rounds", "1", "--dim",
                        "16", "--max-batch", "8", "--shards", "1", "--http-clients", "2", "--bin-clients", "2")
    assert REF_KEYS["ingress"] <= set(rep)
    assert rep["ok"] == (rep["predictions_identical"] and rep["speedup"] >= serve_bench.INGRESS_MIN_SPEEDUP)
    assert rc == (0 if rep["ok"] else 1)
    assert rep["predictions_identical"] and rep["http"]["errors"] == 0 and rep["binary"]["errors"] == 0
    assert rep["http"]["per_datum_qps_wall"] > 0 and rep["binary"]["per_datum_qps_wall"] > 0


def test_overhead_pair_on_the_cpu():
    rep = serve_bench.run_overhead_pair(qps=150.0, duration=0.3, rounds=1, dim=16, device="cpu")
    assert REF_KEYS["overhead"] <= set(rep) and rep["rounds"] == 2  # max(2, rounds) measured, as the reference's
    for arm in ("recorder_on", "recorder_off"):
        assert set(rep[arm]) == {"achieved_qps", "p50_ms", "p95_ms", "p99_ms"} and rep[arm]["achieved_qps"] > 0
    assert set(rep["overhead"]) == {"achieved_qps_ratio", "p99_ratio"}
    assert rep["overhead"]["achieved_qps_ratio"] == rep["recorder_on"]["achieved_qps"] / rep["recorder_off"][
        "achieved_qps"]


def test_straggler_ab_hedges_around_the_stalled_replica_on_the_cpu():
    rep = serve_bench.run_straggler_ab(qps=150.0, duration=0.3, rounds=1, straggler_ms=30.0, hedge_ms=5.0, dim=16,
                                       device="cpu")
    assert REF_KEYS["straggler"] <= set(rep)
    assert rep["hedged"]["hedges"] > 0 and rep["hedged"]["hedge_wins"] > 0
    assert set(rep["hedging"]) == {"p99_ratio", "qps_cost"}
    assert rep["hedging"]["p99_ratio"] == rep["hedged"]["p99_ms"] / rep["unhedged"]["p99_ms"]


def test_procs_ab_on_the_cpu(capsys):
    rc, rep = _run_main(capsys, "--procs-ab", "--device", "cpu", "--duration", "0.3", "--ab-rounds", "1", "--qps",
                        "400", "--burn-rounds", "200", "--dim", "16")
    assert REF_KEYS["procs"] <= set(rep)
    assert rep["predictions_identical"] and rep["prediction_sha"]["thread"] == rep["prediction_sha"]["process"]
    floor = serve_bench.PROCS_MIN_SPEEDUP if rep["cores"] >= 2 else serve_bench.PROCS_ONE_CORE_FLOOR
    assert rep["ok"] == (rep["speedup"] >= floor) and rc == (0 if rep["ok"] else 1)
    assert rep["achievable_speedup"] == min(2, rep["cores"]) and rep["cores_limited"] == (rep["cores"] < 2)


def test_autoscale_scenario_scales_up_and_back_down_on_the_cpu(capsys):
    # a featurizer heavy enough that one worker falls behind the offered load
    rc, rep = _run_main(capsys, "--autoscale-scenario", "--device", "cpu", "--duration", "1", "--qps", "1000",
                        "--burn-rounds", "20000", "--dim", "16")
    assert REF_KEYS["autoscale"] <= set(rep)
    assert rep["errors"] == 0 and rep["hung"] == 0 and rep["completed"] == rep["submitted"]
    assert rep["scaled_up"] and rep["scaled_down"] and rep["ok"] and rc == 0


def test_cold_start_arms_on_the_cpu(capsys):
    rc, rep = _run_main(capsys, "--cold-start", "--device", "cpu", "--ab-rounds", "1", "--dim", "16",
                        "--max-batch", "16")
    assert rc == 0
    for key in ("cold_start", "restart"):
        ab = rep[key]
        assert REF_KEYS[key] <= set(ab) and ab["predictions_match"] and ab["artifact_fallbacks"] == 0
        samples = [s for arm in ("artifact", "compile") for s in ab["samples"][arm]]
        assert len(samples) == 2 and len({s["prediction_sha"] for s in samples}) == 1
        for s in samples:
            assert REF_KEYS[f"{key}_arm"] <= set(s)
            # a bundle needs the card: on the CPU neither arm has one
            assert not s["bundle"] and s.get("artifact_fallbacks", 0) == 0
    assert rep["cold_start"]["prime_sources"]["compile"]["compile"] > 0
    assert rep["restart"]["samples"]["artifact"][0]["restarts"] >= 1


@pytest.mark.parametrize("name,seed", [("bursty", 3), ("poison_flood", 1), ("tenant_skewed", 0)])
def test_scenario_replay_digest_is_the_references(capsys, name, seed):
    from tools import workloads as jzoo

    rc, rep = _run_main(capsys, "--scenario", name, "--scenario-seed", str(seed), "--duration", "0.4", "--qps",
                        "150", "--dim", "16", "--device", "cpu")
    want = jzoo.make_scenario(name, seed=seed, duration_s=0.4, qps=150.0, dim=16).summary()
    assert rc == 0 and REF_KEYS["scenario"] <= set(rep)
    assert rep["scenario"] == want and rep["scenario"]["digest"] == want["digest"]
    assert rep["submitted_rows"] == want["rows"] and rep["outcomes"]["errors"] == 0
    assert sum(rep["outcomes"].values()) == want["rows"]


def test_open_loop_flags_swap_recorder_straggler_hedge_on_the_cpu(capsys):
    rc, rep = _run_main(capsys, "--device", "cpu", "--replicas", "2", "--swap-mid-run", "--no-recorder",
                        "--straggler-ms", "30", "--straggler-replica", "1", "--hedge-ms", "5", "--duration", "0.6",
                        "--qps", "150", "--dim", "16")
    assert rc == 0 and rep["recorder"] is False and rep["straggler_ms"] == 30.0
    assert rep["swap"]["version"] == "bench-swap" and "error" not in rep["swap"]
    assert rep["hedges"] > 0 and rep["errors"] == 0 and rep["completed"] > 0
