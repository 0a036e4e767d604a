"""The port's text ops, sparse rows and sparse solvers against the JAX
package on the CPU, at small sizes, inputs made by numpy from a seed:

- the native text chain (``csrc/text.cpp``) against the reference's
  native chain (``make -C native`` builds it): tokens, df top-N with its
  order, CSR rows (indices and values) and ``stable_term_hash`` bit for
  bit, through ``CommonSparseFeatures`` in memory and over a host stream
  and through ``HashingTF``, dense and sparse;
- the Python chain, where ``chain_config`` refuses the chain (a
  non-default token pattern), identical to the reference's;
- ``sparse_matmul``/``sparse_grad``, unchunked and chunked, at ATOL_SPARSE;
  ``BucketedSparseRows``' caps, permutation and row order equal;
- naive Bayes on sparse and dense rows at the reference's own limits
  (tests/test_sparse.py:179-203);
- the L-BFGS solvers (dense, sparse, sparse with an intercept) and
  logistic regression (dense, sparse) on the reference's problems: the
  objective at the port's weights within RTOL_OBJECTIVE of the
  reference's, the weights within TOL_WEIGHTS·max|w|, the argmax
  predictions agreeing on ≥ 99% of rows;
- the node choice, Densify/Sparsify/FloatToDouble, the binary evaluator;
- the C4 repair (Pooler, Windower, both Convolver forms on an image
  smaller than the window) and C5 (GrayScaler on integer images).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from keystone_tpu.evaluation.evaluators import BinaryClassifierEvaluator as JBinary
from keystone_tpu.models import lbfgs as jlbfgs
from keystone_tpu.models import linear as jlin
from keystone_tpu.models import logistic as jlog
from keystone_tpu.models import naive_bayes as jnb
from keystone_tpu.ops import images as jimg
from keystone_tpu.ops import nlp as jnlp
from keystone_tpu.ops import nlp_native as jnative
from keystone_tpu.ops import sparse as jsparse
from keystone_tpu.ops import util as jutil
from keystone_tpu.workflow import Dataset as JDataset
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu.workflow.dataset import StreamDataset as JStream
from keystone_tpu.workflow.optimizer import NodeChoiceRule as JNodeChoiceRule
from keystone_tpu_torch.evaluation.evaluators import BinaryClassifierEvaluator
from keystone_tpu_torch.models import lbfgs
from keystone_tpu_torch.models import linear as lin
from keystone_tpu_torch.models import logistic
from keystone_tpu_torch.models import naive_bayes as nb
from keystone_tpu_torch.ops import images as img
from keystone_tpu_torch.ops import nlp
from keystone_tpu_torch.ops import nlp_native
from keystone_tpu_torch.ops import sparse
from keystone_tpu_torch.ops import util
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.optimizer import NodeChoiceRule
from keystone_tpu_torch.workflow.pipeline import Pipeline

# sums over ≤ 13·5 products of unit normals in another order (XLA's, torch's)
ATOL_SPARSE = 1e-5
# two f32 L-BFGS runs of one problem, each to its optimum: the objective
# agrees to f32's resolution at the optimum, the weights to 1e-3 of their
# scale (the reference holds sparse vs dense at 2e-2, tests/test_sparse.py:60)
RTOL_OBJECTIVE = 1e-5
TOL_WEIGHTS = 1e-3
ARGMAX_AGREEMENT = 0.99

WORDS = ["alpha", "Beta", "gamma", "it's", "don't", "DELTA", "eps1lon", "zeta", "café", "x", "y", "42"]


def _docs(n, seed):
    """Documents of 0-29 words of WORDS, separated by spaces, punctuation
    and padding, made by numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    seps = [" ", ", ", "; ", "!  ", "\n", " - "]
    docs = []
    for _ in range(n):
        k = int(rng.integers(0, 30))
        parts = []
        for _ in range(k):
            parts.append(WORDS[int(rng.integers(0, len(WORDS)))])
            parts.append(seps[int(rng.integers(0, len(seps)))])
        docs.append("  " * int(rng.integers(0, 2)) + "".join(parts))
    return docs


def _chain(mod, pattern=None, fn="log"):
    tok = mod.Tokenizer() if pattern is None else mod.Tokenizer(pattern)
    tf = mod.TermFrequency(mod.log_tf if fn == "log" else None)
    return [mod.Trimmer(), mod.LowerCase(), tok, mod.NGramsFeaturizer((1, 2)), tf]


def _through(stages, ds):
    for t in stages:
        ds = t.apply_dataset(ds)
    return ds


def _stream(cls, docs, batch, **kw):
    def src():
        for i in range(0, len(docs), batch):
            yield docs[i:i + batch]

    return cls(src, n=len(docs), host=True, **kw)


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.data, w.data)
        assert g.data.dtype == w.data.dtype == np.float32


def test_native_chain_is_the_references():
    assert jnative.available()  # the comparison is against the reference's native path
    assert nlp_native.available()
    docs = _docs(64, 0)
    cfg = nlp_native.chain_config(_chain(nlp))
    assert cfg == jnative.chain_config(_chain(jnlp)) == {"orders_mask": 3, "log_tf": 1, "lower": 1, "trim": 1}
    # tokens: the Python tokenizers the native chain mirrors
    assert [nlp.Tokenizer().apply_one(d.lower()) for d in docs] == [jnlp.Tokenizer().apply_one(d.lower())
                                                                   for d in docs]
    # df top-N, its order included, in two batches
    acc, jacc = nlp_native.DfAccumulator(cfg), jnative.DfAccumulator(cfg)
    for part in (docs[:30], docs[30:]):
        acc.update(part)
        jacc.update(part)
    assert acc.topn(50) == jacc.topn(50)
    acc.close()
    jacc.close()
    # vocabulary rows and hashed rows
    vocab = {t: i for i, (t, _) in enumerate(jnlp.CommonSparseFeatures(40).fit_dataset(
        _through(_chain(jnlp), JDataset(docs))).vocab.items())}
    blob, offs, vs = nlp_native.pack_vocab(vocab)
    jblob, joffs, jvs = jnative.pack_vocab(vocab)
    assert blob == jblob and vs == jvs
    np.testing.assert_array_equal(offs, joffs)
    _rows_equal(nlp_native.featurize_docs(docs, blob, offs, vs, cfg, 40, True),
                jnative.featurize_docs(docs, jblob, joffs, jvs, cfg, 40, True))
    np.testing.assert_array_equal(nlp_native.featurize_docs(docs, blob, offs, vs, cfg, 40, False),
                                  jnative.featurize_docs(docs, jblob, joffs, jvs, cfg, 40, False))
    _rows_equal(nlp_native.hashtf_docs(docs, cfg, 97, True), jnative.hashtf_docs(docs, cfg, 97, True))


@pytest.mark.parametrize("term", [("it's",), ("alpha", "beta"), ("café",), ("a", "b", "c"), ("don't", "x")])
def test_stable_term_hash_is_the_references(term):
    assert nlp.stable_term_hash(term) == jnlp.stable_term_hash(term)


@pytest.mark.parametrize("mode", ["memory", "stream"])
@pytest.mark.parametrize("sparse_output", [False, True])
def test_common_sparse_features_native_matches_the_reference(mode, sparse_output):
    docs = _docs(80, 1)
    calls = []
    if mode == "memory":
        ds, jds = Dataset(docs, device="cpu"), JDataset(docs)
    else:
        ds, jds = _stream(StreamDataset, docs, 16, device="cpu"), _stream(JStream, docs, 16)
    td, jtd = _through(_chain(nlp), ds), _through(_chain(jnlp), jds)
    model = nlp.CommonSparseFeatures(60, sparse_output).fit_dataset(td)
    jmodel = jnlp.CommonSparseFeatures(60, sparse_output).fit_dataset(jtd)
    assert list(model.vocab.items()) == list(jmodel.vocab.items())
    orig = nlp_native.featurize_docs
    try:
        nlp_native.featurize_docs = lambda *a, **k: calls.append(1) or orig(*a, **k)
        out, jout = model.apply_dataset(td), jmodel.apply_dataset(jtd)
        if sparse_output:
            assert out.is_host
            _rows_equal(out.items, jout.items)
        elif mode == "memory":
            np.testing.assert_array_equal(out.numpy(), jout.numpy())
        else:
            np.testing.assert_array_equal(np.concatenate(list(out.batches())),
                                          np.concatenate([np.asarray(b) for b in jout.batches()]))
    finally:
        nlp_native.featurize_docs = orig
    assert calls  # the native chain made the rows


@pytest.mark.parametrize("mode", ["memory", "stream"])
@pytest.mark.parametrize("sparse_output", [False, True])
def test_hashing_tf_native_matches_the_reference(mode, sparse_output):
    docs = _docs(50, 2)
    if mode == "memory":
        ds, jds = Dataset(docs, device="cpu"), JDataset(docs)
    else:
        ds, jds = _stream(StreamDataset, docs, 16, device="cpu"), _stream(JStream, docs, 16)
    out = nlp.HashingTF(128, sparse_output).apply_dataset(_through(_chain(nlp), ds))
    jout = jnlp.HashingTF(128, sparse_output).apply_dataset(_through(_chain(jnlp), jds))
    if sparse_output:
        _rows_equal(out.items, jout.items)
    elif mode == "memory":
        np.testing.assert_array_equal(out.numpy(), jout.numpy())
    else:
        np.testing.assert_array_equal(np.concatenate(list(out.batches())),
                                      np.concatenate([np.asarray(b) for b in jout.batches()]))


@pytest.mark.parametrize("sparse_output", [False, True])
def test_python_chain_on_a_refused_pattern_is_the_references(sparse_output, monkeypatch):
    docs = _docs(60, 3)
    pattern = r"[\s,;!\-]+"
    assert nlp_native.chain_config(_chain(nlp, pattern)) is None
    monkeypatch.setattr(nlp_native, "featurize_docs", lambda *a, **k: pytest.fail("native path taken"))
    monkeypatch.setattr(nlp_native, "DfAccumulator", lambda *a, **k: pytest.fail("native path taken"))
    td = _through(_chain(nlp, pattern), Dataset(docs, device="cpu"))
    jtd = _through(_chain(jnlp, pattern), JDataset(docs))
    assert td.items == jtd.items
    model = nlp.CommonSparseFeatures(30, sparse_output).fit_dataset(td)
    jmodel = jnlp.CommonSparseFeatures(30, sparse_output).fit_dataset(jtd)
    assert list(model.vocab.items()) == list(jmodel.vocab.items())
    out, jout = model.apply_dataset(td), jmodel.apply_dataset(jtd)
    if sparse_output:
        _rows_equal(out.items, jout.items)
    else:
        np.testing.assert_array_equal(out.numpy(), jout.numpy())
    hashed = nlp.HashingTF(64, sparse_output).apply_dataset(
        _through(_chain(nlp, pattern, fn=None), Dataset(docs, device="cpu")))
    jhashed = jnlp.HashingTF(64, sparse_output).apply_dataset(_through(_chain(jnlp, pattern, fn=None),
                                                                      JDataset(docs)))
    if sparse_output:
        _rows_equal(hashed.items, jhashed.items)
    else:
        np.testing.assert_array_equal(hashed.numpy(), jhashed.numpy())


def test_ngram_counts_and_stupid_backoff_match_the_reference():
    docs = [d.lower().split() for d in _docs(30, 4)]
    ngrams = [nlp.NGramsFeaturizer((1, 2, 3)).apply_one(t) for t in docs]
    assert ngrams == [jnlp.NGramsFeaturizer((1, 2, 3)).apply_one(t) for t in docs]
    counts = nlp.NGramsCounts().apply_dataset(Dataset(ngrams, device="cpu")).items[0]
    assert counts == jnlp.NGramsCounts().apply_dataset(JDataset(ngrams)).items[0]
    lm, jlm = nlp.StupidBackoffLM(counts), jnlp.StupidBackoffLM(counts)
    for g in list(counts)[:40] + [("unseen", "alpha,"), ("x", "y", "zz")]:
        assert lm.score(g) == jlm.score(g)
    ix, jix = nlp.NGramIndexer(), jnlp.NGramIndexer()
    for g in list(counts)[:40]:
        assert ix.pack(g) == jix.pack(g)
        assert ix.unpack(ix.pack(g), len(g)) == g


# ---------------------------------------------------------------- sparse rows
def _coo(rng, rows, nnz, d):
    idx = rng.integers(0, d, size=(rows, nnz)).astype(np.int32)
    vals = rng.normal(size=(rows, nnz)).astype(np.float32)
    return idx, vals


@pytest.mark.parametrize("chunked", [False, True])
def test_sparse_matmul_and_grad_match_the_reference(chunked, monkeypatch):
    rng = np.random.default_rng(3)
    rows, nnz, d, k = 300, 13, 70, 5
    idx, vals = _coo(rng, rows, nnz, d)
    w = rng.normal(size=(d, k)).astype(np.float32)
    r = rng.normal(size=(rows, k)).astype(np.float32)
    if chunked:
        monkeypatch.setattr(jsparse, "_auto_chunk", lambda *a: 64)
        monkeypatch.setattr(sparse, "_auto_chunk", lambda *a: 64)
    ti, tv = torch.from_numpy(idx).long(), torch.from_numpy(vals)
    got_mm = sparse.sparse_matmul(ti, tv, torch.from_numpy(w)).numpy()
    got_g = sparse.sparse_grad(ti, tv, torch.from_numpy(r), d).numpy()
    np.testing.assert_allclose(got_mm, np.asarray(jsparse.sparse_matmul(idx, vals, w)), rtol=0, atol=ATOL_SPARSE)
    np.testing.assert_allclose(got_g, np.asarray(jsparse.sparse_grad(idx, vals, r, d)), rtol=0, atol=ATOL_SPARSE)


def _csr_rows(rng, n, d, nnz):
    rows = []
    for i in range(n):
        cols = np.sort(rng.choice(d, size=int(nnz[i]), replace=False))
        rows.append(sps.csr_matrix((rng.normal(size=len(cols)).astype(np.float32), (np.zeros(len(cols)), cols)),
                                   shape=(1, d)))
    return rows


@pytest.mark.parametrize("max_buckets", [6, 3])
def test_bucketed_rows_match_the_reference(max_buckets):
    rng = np.random.default_rng(5)
    n, d = 90, 300
    rows = _csr_rows(rng, n, d, rng.integers(1, 120, size=n))
    b = sparse.BucketedSparseRows.from_scipy_rows(rows, max_buckets=max_buckets, device="cpu")
    jb = jsparse.BucketedSparseRows.from_scipy_rows(rows, max_buckets=max_buckets)
    np.testing.assert_array_equal(b.perm, jb.perm)
    assert [(x.n, x.nnz_max) for x in b.buckets] == [(x.n, x.nnz_max) for x in jb.buckets]
    for x, jx in zip(b.buckets, jb.buckets):
        np.testing.assert_array_equal(x.indices.numpy(), np.asarray(jx.indices)[:jx.n])
        np.testing.assert_array_equal(x.values.numpy(), np.asarray(jx.values)[:jx.n])
    w = rng.normal(size=(d, 4)).astype(np.float32)
    dense = np.concatenate([r.toarray() for r in rows]).astype(np.float32)
    got = b.matmul(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, jb.matmul(w), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, dense @ w, rtol=0, atol=1e-4)  # the row order restored
    np.testing.assert_allclose(sparse.PaddedSparseRows.from_scipy_rows(rows, device="cpu").toarray(), dense)
    with pytest.raises(ValueError, match="width"):
        sparse.BucketedSparseRows.from_scipy_rows(rows, num_features=d + 1, device="cpu")


# ---------------------------------------------------------------- naive Bayes
def _nb_problem(seed, n=120, d=200, k=4):
    rng = np.random.default_rng(seed)
    rows = _csr_rows(rng, n, d, rng.integers(1, 40, size=n))
    rows = [abs(r) for r in rows]  # counts-like features
    y = rng.integers(0, k, size=n).astype(np.int32)
    return rows, y, k


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_naive_bayes_matches_the_reference(form):
    rows, y, k = _nb_problem(6)
    if form == "sparse":
        data, jdata = Dataset(rows, device="cpu"), JDataset(rows)
    else:
        dense = np.concatenate([r.toarray() for r in rows]).astype(np.float32)
        data, jdata = Dataset(dense, device="cpu"), JDataset(dense)
    m = nb.NaiveBayesEstimator(k, lam=1.0).fit_dataset(data, Dataset(y, device="cpu"))
    jm = jnb.NaiveBayesEstimator(k, lam=1.0).fit_dataset(jdata, JDataset(y))
    np.testing.assert_allclose(m.log_prior.numpy(), np.asarray(jm.log_prior), rtol=1e-6)
    np.testing.assert_allclose(m.log_cond.numpy(), np.asarray(jm.log_cond), rtol=1e-5, atol=1e-5)
    scores = m.apply_dataset(data).numpy()
    jscores = np.asarray(jm.apply_dataset(jdata).numpy())
    np.testing.assert_allclose(scores, jscores, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------- L-BFGS
def _sparse_problem(seed, n=256, d=400, k=4, nnz=12):
    """The reference's sparse least-squares problem (tests/test_sparse.py:19)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(d, size=nnz, replace=False) for _ in range(n)])
    val = rng.normal(size=(n, nnz)).astype(np.float32)
    w_true = rng.normal(size=(d, k)).astype(np.float32) * 0.3
    dense = np.zeros((n, d), np.float32)
    for i in range(n):
        dense[i, idx[i]] = val[i]
    y = (dense @ w_true + 0.05 * rng.normal(size=(n, k))).astype(np.float32)
    return idx.astype(np.int32), val, dense, y


def _ls_objective(x, y, w, b, lam):
    x, y, w = x.astype(np.float64), y.astype(np.float64), w.astype(np.float64)
    r = x @ w + (0.0 if b is None else b.astype(np.float64)) - y
    return 0.5 * np.sum(r * r) / x.shape[0] + 0.5 * lam * np.sum(w * w)


def _held(label, x, w, b, jw, jb, objective):
    f, jf = objective(w, b), objective(jw, jb)
    scale = np.abs(jw).max()
    werr = np.abs(w - jw).max() / scale
    agree = np.mean(np.argmax(x @ w, 1) == np.argmax(x @ jw, 1))
    assert abs(f - jf) <= RTOL_OBJECTIVE * abs(jf), (label, f, jf)
    assert werr <= TOL_WEIGHTS, (label, werr)
    assert agree >= ARGMAX_AGREEMENT, (label, agree)
    if b is not None:
        assert np.abs(b - jb).max() <= TOL_WEIGHTS * max(1.0, np.abs(jb).max()), label


@pytest.mark.parametrize("solver", ["dense", "sparse", "sparse_intercept"])
def test_lbfgs_solvers_match_the_reference(solver):
    idx, val, dense, y = _sparse_problem(1)
    lam, iters = 1e-2, 80
    intercept = solver == "sparse_intercept"
    if intercept:
        y = y + np.float32(0.7)
    if solver == "dense":
        m = lbfgs.DenseLBFGSwithL2(lam=lam, num_iterations=iters).fit_arrays(dense, y, device="cpu")
        jm = jlbfgs.DenseLBFGSwithL2(lam=lam, num_iterations=iters).fit_arrays(dense, y)
    else:
        sp_ = sparse.PaddedSparseRows(idx, val, 400, device="cpu")
        m = lbfgs.SparseLBFGSwithL2(lam=lam, num_iterations=iters, fit_intercept=intercept).fit_sparse(sp_, y)
        jm = jlbfgs.SparseLBFGSwithL2(lam=lam, num_iterations=iters, fit_intercept=intercept).fit_sparse(
            jsparse.PaddedSparseRows(idx, val, 400), y)
    w, jw = m.weights.numpy(), np.asarray(jm.weights)
    b = None if m.intercept is None else m.intercept.numpy()
    jb = None if jm.intercept is None else np.asarray(jm.intercept)
    _held(solver, dense, w, b, jw, jb, lambda w_, b_: _ls_objective(dense, y, w_, b_, lam))


def _ce_objective(x, onehot, w, lam):
    x, w = x.astype(np.float64), w.astype(np.float64)
    z = x @ w
    zmax = z.max(1, keepdims=True)
    lse = (zmax + np.log(np.exp(z - zmax).sum(1, keepdims=True)))[:, 0]
    return -np.sum(np.sum(z * onehot, 1) - lse) / x.shape[0] + 0.5 * lam * np.sum(w * w)


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_logistic_regression_matches_the_reference(form):
    idx, val, dense, _ = _sparse_problem(2, k=3)
    rng = np.random.default_rng(7)
    labels = np.argmax(dense @ rng.normal(size=(400, 3)).astype(np.float32), 1).astype(np.int32)
    onehot = np.eye(3, dtype=np.float32)[labels]
    lam, iters = 1e-3, 60
    if form == "dense":
        m = logistic.LogisticRegressionEstimator(3, lam=lam, num_iters=iters).fit_arrays(dense, labels,
                                                                                          device="cpu")
        jm = jlog.LogisticRegressionEstimator(3, lam=lam, num_iters=iters).fit_arrays(dense, labels)
    else:
        rows = [sps.csr_matrix(dense[i:i + 1]) for i in range(dense.shape[0])]
        m = logistic.LogisticRegressionEstimator(3, lam=lam, num_iters=iters).fit_dataset(
            Dataset(rows, device="cpu"), Dataset(labels, device="cpu"))
        jm = jlog.LogisticRegressionEstimator(3, lam=lam, num_iters=iters).fit_dataset(JDataset(rows),
                                                                                       JDataset(labels))
        scores = m.apply_dataset(Dataset(rows, device="cpu")).numpy()
        np.testing.assert_allclose(scores, dense @ m.weights.numpy(), rtol=0, atol=1e-5)
    _held(form, dense, m.weights.numpy(), None, np.asarray(jm.weights), None,
          lambda w_, _b: _ce_objective(dense, onehot, w_, lam))


def test_lbfgs_counts_its_host_reads():
    idx, val, _, y = _sparse_problem(3, n=64, d=50, k=2, nnz=5)
    lbfgs.reset_stats()
    lbfgs.SparseLBFGSwithL2(lam=1e-2, num_iterations=7).fit_sparse(
        sparse.PaddedSparseRows(idx, val, 50, device="cpu"), y)
    s = dict(lbfgs.STATS)
    # one read an iteration, one a line-search test (no trial reaches the cap here)
    assert s["iterations"] == 7 and s["host_reads"] == s["iterations"] + s["trials"], s


# ---------------------------------------------------------------- node choice
@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_node_choice_picks_the_references_estimators(form):
    rng = np.random.default_rng(8)
    rows = _csr_rows(rng, 40, 3000, rng.integers(1, 20, size=40))
    y = rng.normal(size=(40, 2)).astype(np.float32)
    if form == "sparse":
        x, jx = Dataset(rows, device="cpu"), JDataset(rows)
    else:
        dense = np.concatenate([r.toarray() for r in rows]).astype(np.float32)
        x, jx = Dataset(dense, device="cpu"), JDataset(dense)

    def chosen(graph):
        return sorted(type(op.estimator).__name__ for op in graph.operators.values() if hasattr(op, "estimator"))

    for est, jest in ((lin.LinearMapEstimator(1e-3), jlin.LinearMapEstimator(1e-3)),
                      (lbfgs.DenseLBFGSwithL2(1e-3), jlbfgs.DenseLBFGSwithL2(1e-3))):
        pipe = Pipeline.of(util.FloatToDouble()).and_then(est, x, Dataset(y, device="cpu"))
        jpipe = JPipeline.of(jutil.FloatToDouble()).and_then(jest, jx, JDataset(y))
        if form == "sparse":  # the host rows skip the device cast: the estimator sees them directly
            pipe = Pipeline.from_estimator(est, x, Dataset(y, device="cpu"))
            jpipe = JPipeline.from_estimator(jest, jx, JDataset(y)) if hasattr(JPipeline, "from_estimator") \
                else jest.with_data(jx, JDataset(y))
        got, want = chosen(NodeChoiceRule().apply(pipe.graph)), chosen(JNodeChoiceRule().apply(jpipe.graph))
        assert got == want, (form, got, want)
        if form == "sparse":
            assert got == ["SparseLBFGSwithL2"]
            assert type(est.choose_physical(x)).__name__ == type(jest.choose_physical(jx)).__name__


def test_sparse_route_fits_like_the_reference():
    """LinearMapEstimator given CSR rows outside any optimizer: the sparse
    L-BFGS fit, against the reference's same route."""
    idx, val, dense, y = _sparse_problem(4, n=128, d=200, k=3, nnz=8)
    rows = [sps.csr_matrix(dense[i:i + 1]) for i in range(dense.shape[0])]
    m = lin.LinearMapEstimator(1e-2, fit_intercept=False).fit_dataset(Dataset(rows, device="cpu"),
                                                                       Dataset(y, device="cpu"))
    jm = jlin.LinearMapEstimator(1e-2, fit_intercept=False).fit_dataset(JDataset(rows), JDataset(y))
    _held("route", dense, m.weights.numpy(), None, np.asarray(jm.weights), None,
          lambda w_, b_: _ls_objective(dense, y, w_, b_, 1e-2))
    scores = m.apply_dataset(Dataset(rows, device="cpu")).numpy()
    np.testing.assert_allclose(scores, dense @ m.weights.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------- casts, evaluator
def test_densify_sparsify_float_to_double_match_the_reference():
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(12, 9)) * (rng.random((12, 9)) > 0.6)).astype(np.float32)
    rows = util.Sparsify().apply_dataset(Dataset(x, device="cpu"))
    jrows = jutil.Sparsify().apply_dataset(JDataset(x))
    _rows_equal([r.tocsr() for r in rows.items], [r.tocsr() for r in jrows.items])
    back = util.Densify().apply_dataset(rows)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jutil.Densify().apply_dataset(jrows).numpy()))
    np.testing.assert_array_equal(back.numpy(), x)
    x64 = x.astype(np.float64)
    got = util.FloatToDouble().apply_batch(torch.from_numpy(x64))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jutil.FloatToDouble().apply_batch(x)))


@pytest.mark.parametrize("seed", [0, 1])
def test_binary_classifier_evaluator_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    pred, lab = rng.integers(0, 2, 57), rng.integers(0, 2, 57)
    m, jm = BinaryClassifierEvaluator().evaluate(pred, lab), JBinary().evaluate(pred, lab)
    assert (m.tp, m.fp, m.tn, m.fn) == (jm.tp, jm.fp, jm.tn, jm.fn)
    assert (m.accuracy, m.precision, m.recall, m.f1) == (jm.accuracy, jm.precision, jm.recall, jm.f1)


# ---------------------------------------------------------------- C4, C5
_SMALL = np.random.default_rng(10).integers(0, 256, (2, 5, 5, 3)).astype(np.uint8)


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_pooler_on_an_image_smaller_than_its_window(mode):
    got = img.Pooler(2, 6, pool_mode=mode).apply_batch(torch.from_numpy(_SMALL))
    want = np.asarray(jimg.Pooler(2, 6, pool_mode=mode).apply_batch(_SMALL))
    assert tuple(got.shape) == want.shape == (2, 0, 0, 3)
    assert got.dtype == torch.float32


def test_windower_on_an_image_smaller_than_its_window():
    got = img.Windower(1, 6).apply_batch(torch.from_numpy(_SMALL))
    want = np.asarray(jimg.Windower(1, 6).apply_batch(_SMALL))
    assert tuple(got.shape) == want.shape == (2, 0, 6 * 6 * 3)


@pytest.mark.parametrize("strategy", ["direct", "im2col"])
def test_convolver_on_an_image_smaller_than_its_filters(strategy):
    filters = np.random.default_rng(11).normal(size=(4, 6, 6, 3)).astype(np.float32)
    got = img.Convolver(torch.from_numpy(filters), strategy=strategy).apply_batch(torch.from_numpy(_SMALL))
    want = np.asarray(jimg.Convolver(filters).apply_batch(_SMALL.astype(np.float32)))
    assert tuple(got.shape) == want.shape == (2, 0, 0, 4)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_grayscaler_averages_integer_images_in_f32(dtype):
    x = _SMALL.astype(dtype)
    got = img.GrayScaler().apply_batch(torch.from_numpy(x))
    want = np.asarray(jimg.GrayScaler().apply_batch(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    one = img.GrayScaler().apply_batch(torch.from_numpy(x[..., :1]))
    assert one.dtype == torch.from_numpy(x).dtype and tuple(one.shape) == (2, 5, 5)
    assert np.asarray(jimg.GrayScaler().apply_batch(x[..., :1])).dtype == x.dtype


def test_bench_forward_first_stage_takes_uint8():
    from keystone_tpu_torch.convert import params_from_numpy
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as port

    fwd = port.build_forward(params_from_numpy(port.random_params(("sift",), pca_dims=8, gmm_k=4, num_classes=3,
                                                                  block_size=64), device="cpu"),
                             port.Config(sift_step=8), device="cpu")
    x = np.random.default_rng(12).integers(0, 256, (2, 24, 24, 3)).astype(np.uint8)
    gray = fwd.stages[0].apply_batch(torch.from_numpy(x))
    np.testing.assert_allclose(gray.numpy(), np.asarray(jimg.GrayScaler().apply_batch(x)), rtol=1e-6)


def test_a_failed_build_of_the_text_library_raises(tmp_path, monkeypatch):
    """No fallback: where csrc/text.cpp does not build, the featurizers
    raise (the reference drops to its Python chain, whose df ties order
    otherwise)."""
    from keystone_tpu_torch.kernels import build

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "text.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    td = _through(_chain(nlp), Dataset(_docs(8, 13), device="cpu"))
    with pytest.raises(RuntimeError, match="text.cpp"):
        nlp.CommonSparseFeatures(10).fit_dataset(td)
    with pytest.raises(RuntimeError, match="text.cpp"):
        nlp.HashingTF(32, True).apply_dataset(td)
