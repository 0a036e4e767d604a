"""The port's shared stage pool (keystone_tpu_torch/workflow/stage_pool.py)
against the JAX package's (keystone_tpu/workflow/stage_pool.py): the
reference's pool cases of tests/test_multitenant.py (eviction under
budget pressure, the oversized entry, refcounts across tenants, the
single-reader signature, flush tokens, registered tenants evicted last),
each driving both packages' pools with the same sequence of calls and
requiring the same answers, hits, misses, evictions and resident bytes;
then the budget, the byte count of a device result, the token registry
and the pin placement.  No tolerance: every compared value is exact."""

import gc

import numpy as np
import pytest
import torch

from keystone_tpu.workflow import stage_pool as jsp
from keystone_tpu_torch.workflow import profiling
from keystone_tpu_torch.workflow import stage_pool as sp
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.executor import DatasetExpr

#: the counters both pools keep (the port adds peak_bytes)
_COMMON = ("entries", "resident_bytes", "budget_bytes", "hits", "misses", "hit_rate", "evictions", "pinned_sigs",
           "registered_sigs")


def _drive(pool, calls):
    """Run ``calls`` (method name, args, kwargs) on ``pool``; returns each
    call's answer and the pool's common counters after it."""
    out = []
    for name, args, kw in calls:
        got = getattr(pool, name)(*args, **kw)
        stats = pool.stats()
        out.append((got, {k: stats[k] for k in _COMMON}))
    return out


def _both(budget, calls):
    ref = _drive(jsp.SharedStagePool(budget_bytes=budget), calls)
    got = _drive(sp.SharedStagePool(budget_bytes=budget), calls)
    assert got == ref
    return got


def _c(name, *args, **kw):
    return (name, args, kw)


def test_pool_eviction_under_budget_pressure():
    tok = "t1"
    trace = _both(100, [
        _c("begin_flush", tok, {"A": 2, "B": 2}),
        _c("put", ("A", tok), "va", nbytes=60),
        _c("put", ("B", tok), "vb", nbytes=60),  # evicts A (LRU)
        _c("get", ("A", tok)),
        _c("get", ("B", tok)),
        _c("end_flush", tok),
    ])
    assert trace[3][0] == (False, None), "an evicted entry misses (recomputed, never wrong)"
    assert trace[4][0] == (True, "vb")
    assert trace[4][1]["evictions"] >= 1
    assert trace[-1][1]["entries"] == 0


def test_pool_oversized_entry_never_resident():
    trace = _both(100, [_c("begin_flush", "t", {"A": 2}), _c("put", ("A", "t"), "v", nbytes=1000)])
    assert trace[1][0] is False and trace[1][1]["resident_bytes"] == 0


def test_pool_refcount_frees_at_zero():
    """An entry is freed when its last declared reader reads it, not at
    the flush's end."""
    tok = 9
    trace = _both(1 << 20, [
        _c("begin_flush", tok, {"S": 3}),  # the producer and 2 readers
        _c("put", ("S", tok), "val", nbytes=10),
        _c("get", ("S", tok)),
        _c("get", ("S", tok)),
        _c("get", ("S", tok)),
    ])
    assert [t[1]["entries"] for t in trace[1:]] == [1, 1, 0, 0]
    assert [t[0][0] for t in trace[2:]] == [True, True, False]


def test_pool_single_consumer_sig_not_stored():
    trace = _both(1 << 20, [_c("begin_flush", "t", {"S": 1}), _c("put", ("S", "t"), "v", nbytes=10)])
    assert trace[1][0] is False and trace[1][1]["entries"] == 0


def test_pool_tokens_isolate_flushes():
    """An entry never leaks into another flush token (request batch)."""
    trace = _both(1 << 20, [
        _c("begin_flush", "t1", {"S": 2}),
        _c("put", ("S", "t1"), "flush1", nbytes=8),
        _c("begin_flush", "t2", {"S": 2}),
        _c("get", ("S", "t2")),
        _c("end_flush", "t1"),
        _c("end_flush", "t2"),
    ])
    assert trace[3][0] == (False, None)
    assert trace[-1][1]["entries"] == 0


def test_pool_registered_tenant_entries_evict_last():
    tok = "t"
    trace = _both(100, [
        _c("register_tenant", "a", ["KEEP"]),
        _c("begin_flush", tok, {"KEEP": 2, "DROP": 2}),
        _c("put", ("KEEP", tok), "k", nbytes=50),
        _c("put", ("DROP", tok), "d", nbytes=50),
        # a third entry forces an eviction: the unregistered one goes
        _c("begin_flush", "t2", {"X": 2}),
        _c("put", ("X", "t2"), "x", nbytes=50),
        _c("get", ("KEEP", tok)),
        _c("get", ("DROP", tok)),
        _c("unregister_tenant", "a"),
        _c("sig_refcount", "KEEP"),
    ])
    assert trace[6][0] == (True, "k"), "a registered tenant's entry outlives an unregistered one"
    assert trace[7][0] == (False, None)
    assert trace[-1][0] == 0


def test_pool_auto_pin_and_pinned_evicted_last():
    """Pins are placed as the reference places them (tenants − 1 over the
    observed bytes, under half the budget), and a pinned entry outlives an
    unpinned one of the same registration."""
    trace = _both(1000, [
        _c("register_tenant", "a", ["P", "Q"]),
        _c("register_tenant", "b", ["P", "Q"]),
        _c("begin_flush", "t", {"P": 2, "Q": 2}),
        _c("put", ("P", "t"), "p", nbytes=100),
        _c("put", ("Q", "t"), "q", nbytes=450),
        _c("auto_pin"),
        _c("end_flush", "t"),
        _c("begin_flush", "u", {"P": 2, "Q": 2, "R": 2}),
        _c("put", ("Q", "u"), "q", nbytes=450),
        _c("put", ("P", "u"), "p", nbytes=100),
        _c("put", ("R", "u"), "r", nbytes=500),
        _c("get", ("P", "u")),
        _c("get", ("Q", "u")),
    ])
    # P ranks first (1/100 > 1/450) and takes 100 of the 500-byte pin
    # budget; Q's 450 no longer fits
    assert trace[5][0] == 1
    assert trace[11][0] == (True, "p"), "the pinned entry is evicted last"
    assert trace[12][0] == (False, None)


def test_pool_pin_by_hand_and_name():
    """``pin(sig)`` by hand, as the reference's pool takes it: the same
    answers and counters after every call; ``name`` labels the pool."""
    trace = _both(500, [
        _c("register_tenant", "a", ["P", "Q"]),
        _c("register_tenant", "b", ["P", "Q"]),
        _c("pin", "Q"),
        _c("begin_flush", "t", {"P": 2, "Q": 2}),
        _c("put", ("Q", "t"), "q", nbytes=200),
        _c("put", ("P", "t"), "p", nbytes=200),
        _c("begin_flush", "u", {"P": 2, "Q": 2, "R": 2}),
        _c("put", ("R", "u"), "r", nbytes=200),
        _c("get", ("Q", "t")),
        _c("get", ("P", "t")),
    ])
    assert trace[2][1]["pinned_sigs"] == 1
    assert sp.SharedStagePool(budget_bytes=1).name == "serve" == jsp.SharedStagePool(budget_bytes=1).name
    assert sp.SharedStagePool(budget_bytes=1, name="batch").name == "batch"


def test_pool_budget_is_a_quarter_of_the_device_budget(monkeypatch):
    """``pool_budget_bytes``: a quarter of the port's device budget
    (``device_hbm_budget``), the reference's on a device without memory
    stats (16 GiB), and ``KEYSTONE_POOL_BUDGET_BYTES`` outright."""
    from keystone_tpu.workflow.profiling import pool_budget_bytes as jbudget

    monkeypatch.delenv("KEYSTONE_POOL_BUDGET_BYTES", raising=False)
    monkeypatch.delenv("KEYSTONE_HBM_BUDGET_BYTES", raising=False)
    assert profiling.pool_budget_bytes() == profiling.device_hbm_budget(0.25, device="cpu") == 4 << 30
    assert jbudget() == 4 << 30
    monkeypatch.setenv("KEYSTONE_HBM_BUDGET_BYTES", str(1 << 30))
    assert profiling.pool_budget_bytes() == 1 << 28
    monkeypatch.setenv("KEYSTONE_POOL_BUDGET_BYTES", "12345")
    assert profiling.pool_budget_bytes() == jbudget() == 12345
    assert sp.SharedStagePool().budget_bytes == 12345


def test_expr_nbytes_counts_numel_times_element_size():
    x = torch.zeros((5, 7), dtype=torch.float32)
    assert sp.expr_nbytes(DatasetExpr(Dataset(x, device="cpu"))) == 5 * 7 * 4
    assert sp.expr_nbytes(DatasetExpr(Dataset(x.to(torch.bfloat16), device="cpu"))) == 5 * 7 * 2
    assert sp.expr_nbytes(DatasetExpr(Dataset(["a", "b"], device="cpu"))) == 0  # host payload
    assert sp.expr_nbytes("not an expr") == 0
    # put() without nbytes counts the device result itself
    pool = sp.SharedStagePool(budget_bytes=1 << 20)
    pool.begin_flush("t", {"S": 2})
    assert pool.put(("S", "t"), DatasetExpr(Dataset(x, device="cpu")))
    assert pool.stats()["resident_bytes"] == pool.stats()["peak_bytes"] == 140
    pool.end_flush("t")
    assert pool.stats()["resident_bytes"] == 0 and pool.stats()["peak_bytes"] == 140


def test_pool_by_token_and_default_pool():
    pool = sp.SharedStagePool(budget_bytes=64)
    assert sp.pool_by_token(pool.token) is pool
    assert sp.pool_by_token(None) is None
    tok = pool.token
    del pool
    gc.collect()
    assert sp.pool_by_token(tok) is None, "a retired pool dies with its service"
    assert sp.default_pool() is sp.default_pool()
    assert set(sp.default_pool().stats()) >= set(_COMMON)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_call_sequences_match_the_reference(seed):
    """Seeded random sequences of begin/put/get/end over a small budget:
    both pools answer every call alike."""
    rng = np.random.default_rng(seed)
    calls = []
    for step in range(60):
        tok = f"t{rng.integers(3)}"
        sig = f"s{rng.integers(4)}"
        op = rng.integers(4)
        if op == 0:
            calls.append(_c("begin_flush", tok, {f"s{i}": int(rng.integers(1, 4)) for i in range(4)}))
        elif op == 1:
            calls.append(_c("put", (sig, tok), f"v{step}", nbytes=int(rng.integers(10, 80))))
        elif op == 2:
            calls.append(_c("get", (sig, tok)))
        else:
            calls.append(_c("end_flush", tok))
    _both(150, calls)
