"""The port's text apps (NewsgroupsPipeline with its ``nb`` and ``ls``
heads, AmazonReviewsPipeline) against the JAX package on the CPU, at
``num_features`` ≥ 16384, where the features are CSR rows and the heads
fit sparse:

- each ``run`` against the reference's ``run`` on the synthetic corpus:
  test error, accuracy and f1 within one test document;
- the fitted pipelines against the reference's: the vocabulary equal (the
  native chain is the reference's), naive Bayes within the reference's
  own limits (tests/test_sparse.py:179-203), the L-BFGS heads' objective
  within 1e-5 relative, weights within 1e-3·max|w|, predictions equal;
  the reference's fitted state carried across by ``convert`` scores the
  test set as the reference does;
- ``stream`` against in memory, from a directory tree (Newsgroups) and a
  JSON-lines file (Amazon) written in tmp_path: the vocabulary equal,
  naive Bayes bit for bit, the L-BFGS weights within 1e-5·max|w|;
- a ``data_path``-only split, and both ``main``s with ``--device cpu``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from keystone_tpu.loaders.amazon import AmazonReviewsDataLoader as JAmazon
from keystone_tpu.loaders.newsgroups import NewsgroupsDataLoader as JNews
from keystone_tpu.pipelines import amazon_reviews as jam
from keystone_tpu.pipelines import newsgroups as jng
from keystone_tpu.workflow import graph as JG
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders.amazon import synthetic_reviews, write_jsonl
from keystone_tpu_torch.loaders.newsgroups import NewsgroupsDataLoader, synthetic_texts, write_tree
from keystone_tpu_torch.models import lbfgs
from keystone_tpu_torch.models.linear import LinearMapper
from keystone_tpu_torch.models.logistic import LogisticRegressionModel
from keystone_tpu_torch.models.naive_bayes import NaiveBayesModel
from keystone_tpu_torch.ops.nlp import CommonSparseFeaturesModel
from keystone_tpu_torch.pipelines import amazon_reviews as pam
from keystone_tpu_torch.pipelines import newsgroups as png
from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.optimizer import FusedTransformer

NEWS = dict(num_features=16384, synthetic_n=240, num_classes=4)
AMAZON = dict(num_features=16384, synthetic_n=320)
RTOL_OBJECTIVE, TOL_WEIGHTS = 1e-5, 1e-3
# a streamed fit against the in-memory fit of one package: the same rows
TOL_STREAM_WEIGHTS = 1e-5


def _stages(fitted):
    out = []
    for op in fitted.graph.operators.values():
        t = getattr(op, "transformer", None)
        out.extend(t.stages if isinstance(t, FusedTransformer) else [t])
    return out


def _stage(fitted, cls):
    found = [s for s in _stages(fitted) if isinstance(s, cls)]
    assert len(found) == 1, (cls, _stages(fitted))
    return found[0]


def _jstage(jfitted, name):
    found = []
    for op in jfitted.graph.operators.values():
        t = getattr(op, "transformer", None)
        found.extend(s for s in getattr(t, "stages", [t]) if type(s).__name__ == name)
    assert len(found) == 1, name
    return found[0]


def _within_one(a, b, n):
    assert abs(a - b) <= 1.0 / n + 1e-12, (a, b, n)


@pytest.mark.parametrize("head", ["nb", "ls"])
def test_newsgroups_run_matches_the_reference(head):
    res = png.NewsgroupsPipeline.run(png.Config(head=head, **NEWS), device="cpu")
    jres = jng.NewsgroupsPipeline.run(jng.Config(head=head, **NEWS))
    n_test = NEWS["synthetic_n"] // 4
    for key in ("test_error", "accuracy"):
        _within_one(res[key], jres[key], n_test)
    assert res["accuracy"] >= 0.9 and not res["model_loaded"]


def test_amazon_run_matches_the_reference():
    res = pam.AmazonReviewsPipeline.run(pam.Config(**AMAZON), device="cpu")
    jres = jam.AmazonReviewsPipeline.run(jam.Config(**AMAZON))
    n_test = AMAZON["synthetic_n"] // 4
    _within_one(res["accuracy"], jres["accuracy"], n_test)
    # one document moves f1 by at most 2/(2·tp + fp + fn) ≤ 2/positives
    assert abs(res["f1"] - jres["f1"]) <= 2.0 / (0.25 * n_test)
    assert res["accuracy"] >= 0.9


def _ls_objective(x, y, w, lam):
    r = x @ w - y
    return 0.5 * np.sum(r * r) / x.shape[0] + 0.5 * lam * np.sum(w * w)


@pytest.mark.parametrize("head", ["nb", "ls"])
def test_newsgroups_fitted_pipeline_matches_the_reference(head):
    cfg, jcfg = png.Config(head=head, **NEWS), jng.Config(head=head, **NEWS)
    train = NewsgroupsDataLoader.synthetic(NEWS["synthetic_n"], 4, seed=1, device="cpu")
    test = NewsgroupsDataLoader.synthetic(NEWS["synthetic_n"] // 4, 4, seed=2, device="cpu")
    jtrain, jtest = JNews.synthetic(NEWS["synthetic_n"], 4, seed=1), JNews.synthetic(NEWS["synthetic_n"] // 4, 4,
                                                                                    seed=2)
    assert train.data.items == jtrain.data.items and test.data.items == jtest.data.items
    lbfgs.reset_stats()
    fitted = png.NewsgroupsPipeline.build(cfg, train.data, train.labels).fit()
    jfitted = jng.NewsgroupsPipeline.build(jcfg, jtrain.data, jtrain.labels).fit()
    csf, jcsf = _stage(fitted, CommonSparseFeaturesModel), _jstage(jfitted, "CommonSparseFeaturesModel")
    assert list(csf.vocab.items()) == list(jcsf.vocab.items())
    preds = fitted(test.data).get().numpy()
    jpreds = np.asarray(jfitted(jtest.data).get().numpy())
    assert np.sum(preds != jpreds) <= 1
    feats = np.concatenate([r.toarray() for r in csf.apply_dataset(
        png.text_featurizer(2).fit()(Dataset(test.data.items, device="cpu")).get()).items])
    if head == "nb":
        m, jm = _stage(fitted, NaiveBayesModel), _jstage(jfitted, "NaiveBayesModel")
        np.testing.assert_allclose(m.log_prior.numpy(), np.asarray(jm.log_prior), rtol=1e-6)
        np.testing.assert_allclose(m.log_cond.numpy(), np.asarray(jm.log_cond), rtol=1e-5, atol=1e-5)
        # the reference's fitted state, carried across, scores as the reference
        carried = convert.naive_bayes_model_from_numpy(np.asarray(jm.log_prior), np.asarray(jm.log_cond),
                                                       device="cpu")
        want = feats @ np.asarray(jm.log_cond).T + np.asarray(jm.log_prior)
    else:
        assert lbfgs.STATS["iterations"] > 0  # the node choice took the sparse solver
        m, jm = _stage(fitted, LinearMapper), _jstage(jfitted, "LinearMapper")
        assert m.intercept is None and jm.intercept is None
        w, jw = m.weights.numpy(), np.asarray(jm.weights)
        assert np.abs(w - jw).max() <= TOL_WEIGHTS * np.abs(jw).max()
        x = np.concatenate([r.toarray() for r in csf.apply_dataset(
            png.text_featurizer(2).fit()(Dataset(train.data.items, device="cpu")).get()).items])
        y = np.where(np.eye(4)[train.labels.numpy()] > 0, 1.0, -1.0)
        f, jf = _ls_objective(x, y, w.astype(np.float64), cfg.ls_lam), _ls_objective(x, y, jw.astype(np.float64),
                                                                                    cfg.ls_lam)
        assert abs(f - jf) <= RTOL_OBJECTIVE * abs(jf), (f, jf)
        carried = convert.linear_mapper_from_numpy(jw, device="cpu")
        want = feats @ jw
    vocab = convert.common_sparse_features_model_from_vocab(dict(jcsf.vocab), cfg.num_features, True)
    rows = vocab.apply_dataset(png.text_featurizer(2).fit()(Dataset(test.data.items, device="cpu")).get())
    got = carried.apply_dataset(rows).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_amazon_fitted_pipeline_matches_the_reference():
    cfg = pam.Config(**AMAZON)
    train = pam.AmazonReviewsDataLoader.synthetic(AMAZON["synthetic_n"], seed=1, device="cpu")
    jtrain = JAmazon.synthetic(AMAZON["synthetic_n"], seed=1)
    assert train.data.items == jtrain.data.items
    fitted = pam.AmazonReviewsPipeline.build(cfg, train.data, train.labels).fit()
    jfitted = jam.AmazonReviewsPipeline.build(jam.Config(**AMAZON), jtrain.data, jtrain.labels).fit()
    m, jm = _stage(fitted, LogisticRegressionModel), _jstage(jfitted, "LogisticRegressionModel")
    w, jw = m.weights.numpy(), np.asarray(jm.weights)
    assert np.abs(w - jw).max() <= TOL_WEIGHTS * np.abs(jw).max()
    hashed = convert.hashing_tf_from_reference(cfg.num_features, True).apply_dataset(
        png.text_featurizer(2).fit()(Dataset(train.data.items, device="cpu")).get())
    x = np.concatenate([r.toarray() for r in hashed.items]).astype(np.float64)
    onehot = np.eye(2)[train.labels.numpy()]

    def ce(w_):
        z = x @ w_.astype(np.float64)
        lse = np.log(np.exp(z - z.max(1, keepdims=True)).sum(1)) + z.max(1)
        return -np.mean(np.sum(z * onehot, 1) - lse) + 0.5 * cfg.lam * np.sum(w_.astype(np.float64) ** 2)

    assert abs(ce(w) - ce(jw)) <= RTOL_OBJECTIVE * abs(ce(jw))
    carried = convert.logistic_regression_model_from_numpy(jw, device="cpu")
    np.testing.assert_allclose(carried.apply_dataset(hashed).numpy(), x @ jw, rtol=1e-5, atol=1e-5)
    assert np.mean(np.argmax(x @ w, 1) == np.argmax(x @ jw, 1)) >= 0.99


def _news_tree(tmp_path, n, seed, name):
    groups = [f"group{c}" for c in range(4)]
    texts, labels = synthetic_texts(n, 4, seed)
    write_tree(str(tmp_path / name), texts, labels, groups)
    return str(tmp_path / name)


@pytest.mark.parametrize("head", ["nb", "ls"])
def test_newsgroups_stream_matches_in_memory(head, tmp_path):
    train_dir, test_dir = _news_tree(tmp_path, 200, 1, "train"), _news_tree(tmp_path, 60, 2, "test")
    base = png.Config(data_path=train_dir, test_path=test_dir, head=head, num_features=16384, stream_batch_size=48)
    outs = {}
    for stream in (False, True):
        out = {}
        res = png.NewsgroupsPipeline.run(dataclasses.replace(base, stream=stream), device="cpu", out=out)
        outs[stream] = (res, out)
    (res, out), (sres, sout) = outs[False], outs[True]
    assert res["accuracy"] == sres["accuracy"] and res["accuracy"] >= 0.9
    np.testing.assert_array_equal(out["predictions"], sout["predictions"])
    csf, scsf = _stage(out["fitted"], CommonSparseFeaturesModel), _stage(sout["fitted"], CommonSparseFeaturesModel)
    assert list(csf.vocab.items()) == list(scsf.vocab.items())
    if head == "nb":
        m, sm = _stage(out["fitted"], NaiveBayesModel), _stage(sout["fitted"], NaiveBayesModel)
        assert torch.equal(m.log_prior, sm.log_prior) and torch.equal(m.log_cond, sm.log_cond)
    else:
        w, sw = _stage(out["fitted"], LinearMapper).weights, _stage(sout["fitted"], LinearMapper).weights
        assert (w - sw).abs().max() <= TOL_STREAM_WEIGHTS * w.abs().max()
    # the reference reads the same tree to the same vocabulary
    jtrain = JNews.load(train_dir, groups=sorted(f"group{c}" for c in range(4)))
    jfitted = jng.NewsgroupsPipeline.build(jng.Config(head=head, num_features=16384), jtrain.data,
                                           jtrain.labels).fit()
    assert list(_jstage(jfitted, "CommonSparseFeaturesModel").vocab.items()) == list(csf.vocab.items())


def test_amazon_stream_matches_in_memory(tmp_path):
    texts, labels = synthetic_reviews(300, 1)
    ttexts, tlabels = synthetic_reviews(80, 2)
    write_jsonl(str(tmp_path / "train.jsonl"), texts, labels)
    write_jsonl(str(tmp_path / "test.jsonl"), ttexts, tlabels)
    base = pam.Config(data_path=str(tmp_path / "train.jsonl"), test_path=str(tmp_path / "test.jsonl"),
                      stream_batch_size=64)
    outs = {}
    for stream in (False, True):
        out = {}
        outs[stream] = (pam.AmazonReviewsPipeline.run(dataclasses.replace(base, stream=stream), device="cpu",
                                                      out=out), out)
    (res, out), (sres, sout) = outs[False], outs[True]
    assert res["accuracy"] == sres["accuracy"] >= 0.9 and res["f1"] == sres["f1"]
    w = _stage(out["fitted"], LogisticRegressionModel).weights
    sw = _stage(sout["fitted"], LogisticRegressionModel).weights
    assert (w - sw).abs().max() <= TOL_STREAM_WEIGHTS * w.abs().max()
    jres = jam.AmazonReviewsPipeline.run(jam.Config(data_path=base.data_path, test_path=base.test_path))
    _within_one(res["accuracy"], jres["accuracy"], 80)
    assert JAmazon.load(base.data_path).labels.numpy().tolist() == labels


def test_data_path_only_splits_match_the_reference(tmp_path):
    tree = _news_tree(tmp_path, 150, 3, "all")
    res = png.NewsgroupsPipeline.run(png.Config(data_path=tree, num_features=16384), device="cpu")
    jres = jng.NewsgroupsPipeline.run(jng.Config(data_path=tree, num_features=16384))
    _within_one(res["accuracy"], jres["accuracy"], 30)
    texts, labels = synthetic_reviews(200, 4)
    write_jsonl(str(tmp_path / "all.jsonl"), texts, labels)
    ares = pam.AmazonReviewsPipeline.run(pam.Config(data_path=str(tmp_path / "all.jsonl")), device="cpu")
    jares = jam.AmazonReviewsPipeline.run(jam.Config(data_path=str(tmp_path / "all.jsonl")))
    _within_one(ares["accuracy"], jares["accuracy"], 40)
    with pytest.raises(ValueError, match="test-path"):
        png.NewsgroupsPipeline.run(png.Config(data_path=tree, stream=True), device="cpu")
    with pytest.raises(ValueError, match="test-path"):
        pam.AmazonReviewsPipeline.run(pam.Config(data_path=str(tmp_path / "all.jsonl"), stream=True), device="cpu")


def test_mains_on_the_cpu(tmp_path, capsys):
    train_dir, test_dir = _news_tree(tmp_path, 80, 1, "train"), _news_tree(tmp_path, 20, 2, "test")
    png.main(["--device", "cpu", "--data-path", train_dir, "--test-path", test_dir, "--head", "ls", "--stream",
              "--stream-batch-size", "32", "--num-features", "16384"])
    assert "'pipeline': 'NewsgroupsPipeline'" in capsys.readouterr().out
    png.main(["--device", "cpu", "--synthetic-n", "80", "--model-path", str(tmp_path / "m.pt")])
    png.main(["--device", "cpu", "--synthetic-n", "80", "--model-path", str(tmp_path / "m.pt")])
    assert "'model_loaded': True" in capsys.readouterr().out
    pam.main(["--device", "cpu", "--synthetic-n", "120", "--stream", "--stream-batch-size", "50"])
    assert "'pipeline': 'AmazonReviewsPipeline'" in capsys.readouterr().out


def test_fitted_graph_keeps_the_host_chain_unfused():
    train = NewsgroupsDataLoader.synthetic(60, 4, seed=1, device="cpu")
    fitted = png.NewsgroupsPipeline.build(png.Config(num_features=16384), train.data, train.labels).fit()
    labels = [getattr(op, "transformer", None).label for op in fitted.graph.operators.values()
              if isinstance(op, G.TransformerOperator)]
    jtrain = JNews.synthetic(60, 4, seed=1)
    jfitted = jng.NewsgroupsPipeline.build(jng.Config(num_features=16384), jtrain.data, jtrain.labels).fit()
    jlabels = [op.transformer.label for op in jfitted.graph.operators.values() if isinstance(op, JG.TransformerOperator)]
    assert labels == jlabels
