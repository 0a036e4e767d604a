"""The port's host_map (keystone_tpu_torch/utils/hostmap.py) against the
reference's (keystone_tpu/utils/hostmap.py): tests/test_hostmap.py's
cases, each run on the same numpy-made documents through both packages.
The pooled map equals the sequential one, order and content; an
unpicklable callable, a small input and a broken pool map in turn; a
data error propagates unchanged; the trivial ops opt out of the pool;
and the text chain through the workflow maps pooled to the rows the
reference's chain makes.  With a CUDA context live, chip_smoke.py holds
the pooled rows bit for bit to the sequential ones.

Tolerances: none; rows are compared exactly."""

import numpy as np
import pytest
import torch

from keystone_tpu.ops import nlp as ref_nlp
from keystone_tpu.utils import hostmap as ref_hostmap
from keystone_tpu.workflow import Dataset as RefDataset
from keystone_tpu_torch.ops import nlp
from keystone_tpu_torch.utils import hostmap
from keystone_tpu_torch.utils.hostmap import host_map, host_workers
from keystone_tpu_torch.workflow.dataset import Dataset


def _docs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(200)]
    return [" ".join(rng.choice(vocab, size=30)) for _ in range(n)]


def test_host_map_pool_matches_sequential_and_the_reference():
    docs = _docs(64)
    seq = [nlp.Tokenizer().apply_one(d) for d in docs]
    par = host_map(nlp.Tokenizer().apply_one, docs, workers=2, min_items=2)
    ref = [ref_nlp.Tokenizer().apply_one(d) for d in docs]
    assert par == seq == ref  # order and content
    assert hostmap.pool_workers() == 2


@pytest.mark.parametrize("mod", [hostmap, ref_hostmap], ids=["port", "reference"])
def test_host_map_unpicklable_falls_back(mod):
    captured = []
    fn = lambda x: (captured.append(x), x * 2)[1]  # noqa: E731
    assert mod.host_map(fn, list(range(10)), workers=4, min_items=2) == [i * 2 for i in range(10)]
    assert len(captured) == 10  # ran in this process


@pytest.mark.parametrize("mod", [hostmap, ref_hostmap], ids=["port", "reference"])
def test_host_map_small_input_stays_sequential(mod, monkeypatch):
    monkeypatch.setattr(mod, "_get_executor", lambda w: pytest.fail("a small input reached the pool"))
    tok = (nlp if mod is hostmap else ref_nlp).Tokenizer()
    assert mod.host_map(tok.apply_one, ["a b", "c d"], workers=4, min_items=1024) == [["a", "b"], ["c", "d"]]


@pytest.mark.parametrize("value, want", [("3", 3), ("nope", 1), ("0", 1)])
def test_host_workers_env(value, want, monkeypatch):
    monkeypatch.setenv("KEYSTONE_HOST_WORKERS", value)
    assert host_workers() == ref_hostmap.host_workers() == want


def test_host_workers_is_a_registered_operational_variable():
    from keystone_tpu_torch.planner import registry

    assert "KEYSTONE_HOST_WORKERS" in registry.OPERATIONAL_ENV


def _boom(x):
    if x == 3:
        raise ValueError("bad doc 3")
    return x * 2


def test_host_map_fn_error_propagates():
    """A data error fn raises propagates unchanged, and the pool survives
    it: the next map still runs pooled.  (``int`` stands for the
    reference's ``_boom``: a callable the workers import cheaply.)"""
    with pytest.raises(ValueError, match="invalid literal"):
        host_map(int, ["0", "1", "2", "bad doc 3"], workers=2, min_items=2)
    assert host_map(int, ["0", "1", "2"], workers=2, min_items=2) == [0, 1, 2]
    assert hostmap.pool_workers() == 2


@pytest.mark.parametrize("mod", [hostmap, ref_hostmap], ids=["port", "reference"])
def test_host_map_broken_pool_falls_back_sequentially(mod, monkeypatch):
    """A killed worker (BrokenProcessPool, a RuntimeError) completes the
    map in turn and tears the pool down for the next call."""
    from concurrent.futures.process import BrokenProcessPool

    class _DeadFuture:
        def result(self):
            raise BrokenProcessPool("A process in the process pool was terminated abruptly")

    class _DeadPool:
        def submit(self, *a, **k):
            return _DeadFuture()

        def shutdown(self, **k):
            pass

    torn = []
    monkeypatch.setattr(mod, "_get_executor", lambda w: (_DeadPool(), w))
    monkeypatch.setattr(mod, "shutdown", lambda: torn.append(True))
    assert mod.host_map(_boom, [0, 1, 2], workers=2, min_items=2) == [0, 2, 4]
    assert torn == [True]


@pytest.mark.parametrize("op", ["Trimmer", "LowerCase"])
def test_trivial_host_ops_opt_out_of_pool(op, monkeypatch):
    """One str method an item: parallel_host=False keeps them in turn,
    as the reference's do."""
    assert getattr(nlp, op).parallel_host is False and getattr(ref_nlp, op).parallel_host is False
    monkeypatch.setattr(hostmap, "host_map", lambda *a, **k: pytest.fail("a trivial op reached the pool"))
    got = getattr(nlp, op)().apply_dataset(Dataset(["  a ", " B"], device="cpu")).items
    want = getattr(ref_nlp, op)().apply_dataset(RefDataset(["  a ", " B"])).items
    assert got == want


def _chain(mod):
    return mod.Tokenizer().and_then(mod.NGramsFeaturizer((1, 2))).and_then(mod.TermFrequency(mod.log_tf))


def test_text_chain_pooled_matches_sequential_and_the_reference(monkeypatch):
    """The wired paths: the tokenize → n-gram → tf chain over an
    in-memory host dataset, then CommonSparseFeatures' rows, under forced
    2-worker pooling, equal the sequential rows and the reference's."""
    docs = _docs(48, seed=3)
    terms = _chain(nlp)(Dataset(docs, device="cpu")).get()
    csf = nlp.CommonSparseFeatures(512, sparse_output=True).fit_dataset(terms)
    seq_rows = csf.apply_dataset(terms)

    calls = []
    real = hostmap.host_map

    def pooled(fn, items, workers=None, min_items=512):
        calls.append(len(items))
        return real(fn, items, workers=2, min_items=2)

    monkeypatch.setattr(hostmap, "host_map", pooled)
    par_terms = _chain(nlp)(Dataset(docs, device="cpu")).get()
    par_rows = csf.apply_dataset(par_terms)
    assert calls and all(n == 48 for n in calls)
    assert list(par_terms.items) == list(terms.items)
    ref_terms = _chain(ref_nlp)(RefDataset(docs)).get()
    ref_rows = ref_nlp.CommonSparseFeatures(512, sparse_output=True).fit_dataset(ref_terms).apply_dataset(ref_terms)
    assert list(par_terms.items) == list(ref_terms.items)
    for a, b, c in zip(par_rows.items, seq_rows.items, ref_rows.items):
        np.testing.assert_array_equal(a.toarray(), b.toarray())
        np.testing.assert_array_equal(a.toarray(), c.toarray())


def test_host_stream_maps_pooled_batch_by_batch(monkeypatch):
    """Over a host stream each batch of a host op goes through host_map;
    the trivial ops map in turn; the rows equal the reference's stream."""
    from keystone_tpu.workflow.dataset import StreamDataset as RefStream
    from keystone_tpu_torch.workflow.dataset import StreamDataset

    docs = _docs(40, seed=5)
    batches = [docs[i:i + 16] for i in range(0, 40, 16)]
    calls = []
    real = hostmap.host_map

    def pooled(fn, items, workers=None, min_items=512):
        calls.append((type(fn.__self__).__name__, len(items)))
        return real(fn, items, workers=2, min_items=2)

    monkeypatch.setattr(hostmap, "host_map", pooled)
    stream = StreamDataset(batches, n=40, host=True, device="cpu")
    out = nlp.Trimmer().apply_dataset(stream)
    for t in (nlp.Tokenizer(), nlp.NGramsFeaturizer((1, 2)), nlp.TermFrequency(nlp.log_tf)):
        out = t.apply_dataset(out)
    got = [row for b in out.batches() for row in b]
    assert sorted(set(calls)) == [(n, k) for n in ("NGramsFeaturizer", "TermFrequency", "Tokenizer")
                                  for k in (8, 16)]
    ref = RefStream(lambda: iter(batches), n=40, host=True)
    ref_out = ref_nlp.Trimmer().apply_dataset(ref)
    for t in (ref_nlp.Tokenizer(), ref_nlp.NGramsFeaturizer((1, 2)), ref_nlp.TermFrequency(ref_nlp.log_tf)):
        ref_out = t.apply_dataset(ref_out)
    assert got == [row for b in ref_out.batches() for row in b]


def test_bench_text_defaults_to_the_card_and_counts_both_chains():
    """bench_text runs for the card unless asked for the CPU; on the CPU a
    small corpus goes through both chains, every document counted."""
    from keystone_tpu_torch.tools import bench_text

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench_text.run(8)
    r = bench_text.run(64, 32, device="cpu")
    assert r["native"]["docs"] == 64 and r["python"]["docs"] == 32
    assert r["hash_native"]["docs"] == 64 and r["hash_python"]["docs"] == 32
    assert all(r[k]["two_pass_docs_per_s"] > 0 for k in ("native", "python"))
