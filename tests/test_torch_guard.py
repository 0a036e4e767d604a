"""Guards on the port: it imports neither JAX nor the JAX package, its
entry points default to the card and refuse a box without one, and its
kernel wrappers take their plain versions only for CPU tensors."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import keystone_tpu_torch
from keystone_tpu_torch.convert import (
    kernel_timit_params_from_numpy,
    krr_params_from_numpy,
    params_from_numpy,
)
from keystone_tpu_torch.models import kernel_ridge as kr
from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.models.gmm import GaussianMixtureModelEstimator
from keystone_tpu_torch.models.kmeans import KMeansPlusPlusEstimator
from keystone_tpu_torch.models.nystrom import NystromFeatures
from keystone_tpu_torch.models.pca import PCAEstimator
from keystone_tpu_torch.ops import fisher_kernels, gram_kernels
from keystone_tpu_torch.ops.stats import StandardScaler
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as port
from keystone_tpu_torch.pipelines import kernel_timit
from keystone_tpu_torch.utils.device import resolve_device

PKG = Path(keystone_tpu_torch.__file__).parent


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="keystone_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    for m in ("ops.fisher_kernels", "ops.gram_kernels", "models.kernel_ridge", "models.kernel_matrix",
              "models.nystrom", "pipelines.kernel_timit", "workflow.profiling", "loaders.timit",
              "models.pca", "models.kmeans", "models.gmm", "models.block_ls", "models.block_weighted_ls",
              "ops.stats", "evaluation.evaluators", "loaders.imagenet", "pipelines.imagenet_sift_lcs_fv",
              "workflow.graph", "workflow.dataset", "workflow.transformer", "workflow.estimator",
              "workflow.executor", "workflow.optimizer", "workflow.pipeline", "loaders.labeled", "ops.images",
              "ops.filters", "workflow.blockstore", "loaders.stream", "loaders.jpeg", "utils.durable",
              "loaders.cifar", "pipelines.kernel_cifar", "ops.nlp", "ops.nlp_native",
              "ops.sparse", "ops.util", "models.lbfgs", "models.logistic", "models.naive_bayes", "models.linear",
              "loaders.newsgroups", "loaders.amazon", "pipelines.newsgroups", "pipelines.amazon_reviews",
              "convert", "obs", "obs.metrics", "obs.ledger", "faults", "utils.guard", "workflow.state",
              "workflow.recovery", "obs.recorder", "serve", "serve.service", "serve.fleet", "serve.http", "cli",
              "tools.serve_bench", "serve.registry", "serve.rollout", "serve.autoscale", "utils.hashing",
              "utils.graphs", "workflow.stage_pool", "workflow.cross", "analysis", "analysis.signatures",
              "serve.tenants", "tools.chaos", "tools.workloads"):
        assert f"keystone_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'keystone_tpu' or m.startswith('keystone_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(PKG.parent),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_names_jax_or_the_jax_package():
    pat = re.compile(r"jax|keystone_tpu\.")
    for f in sorted(PKG.rglob("*")):
        if f.suffix in (".py", ".cu", ".cuh") and "_build" not in f.parts:
            hits = [ln for ln in f.read_text().splitlines() if pat.search(ln)]
            assert not hits, (f, hits)


def _small_params():
    return port.random_params(pca_dims=16, gmm_k=8, num_classes=10, block_size=64)


def test_no_source_imports_the_repo_tools_or_jax():
    """Neither the port nor chip_smoke.py imports the repo's ``tools/``
    (the chaos tool and the workload zoo have their own copies in
    ``keystone_tpu_torch/tools``), JAX or the JAX package."""
    tools = re.compile(r"^\s*(from|import)\s+tools(\.|\s|$)")
    jax = re.compile(r"^\s*(from|import)\s+(jax|keystone_tpu)(\.|\s|$)")
    files = [f for f in sorted(PKG.rglob("*.py")) if "_build" not in f.parts] + [PKG.parent / "chip_smoke.py"]
    for f in files:
        hits = [ln for ln in f.read_text().splitlines() if tools.search(ln) or jax.search(ln)]
        assert not hits, (f, hits)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the CPU-only refusal is not observable")
    raw = _small_params()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(raw)
    cpu = params_from_numpy(raw, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.build_scorer_from_params(cpu)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.build_forward(cpu)
    assert all(v.device.type == "cpu" for v in cpu.values())
    # the planner's public entry point: the card, never a quiet CPU plan
    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.planner import build_plan
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    with pytest.raises(RuntimeError, match="CUDA"):
        build_plan(Pipeline.of(NormalizeRows()).fit())
    assert build_plan(Pipeline.of(NormalizeRows()).fit(), device="cpu").backend == "cpu"


def test_cpu_path_launches_no_kernel():
    fisher_kernels.reset_launches()
    scorer = port.build_scorer_from_params(
        params_from_numpy(_small_params(), device="cpu"), port.Config(sift_step=8, lcs_step=8),
        device="cpu",
    )
    imgs = np.random.default_rng(0).integers(0, 256, (2, 48, 48, 3), dtype=np.uint8)
    top = scorer(torch.from_numpy(imgs))
    assert top.shape == (2, 5)
    assert not any(fisher_kernels.LAUNCHES.values()), fisher_kernels.LAUNCHES


def test_params_from_numpy_rejects_bad_input():
    raw = _small_params()
    with pytest.raises(ValueError, match="unknown"):
        params_from_numpy({**raw, "sift.pca.bogus": np.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy({**raw, "lcs.gmm.means": np.zeros((8, 15))}, device="cpu")
    bad = dict(raw)
    del bad["sift.gmm.variances"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(bad, device="cpu")


def _small_kernel_timit():
    cfg = kernel_timit.Config(num_landmarks=16)
    return cfg, kernel_timit.random_params(cfg, block_size=8, scaler_frames=64, device="cpu")


def test_kernel_tier_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the CPU-only refusal is not observable")
    cfg, raw = _small_kernel_timit()
    x = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    y = np.ones((8, 1), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_timit.random_params(cfg, block_size=8, scaler_frames=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_timit_params_from_numpy(raw)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_timit.build_scorer_from_params(kernel_timit_params_from_numpy(raw, device="cpu"), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        krr_params_from_numpy({"krr.train_x": x, "krr.alpha": y})
    for fit in (
        lambda: kr.KernelRidgeRegressionEstimator(kr.GaussianKernelGenerator(0.1), block_size=4).fit_arrays(x, y),
        lambda: NystromFeatures(kr.GaussianKernelGenerator(0.1), num_landmarks=4).fit_arrays(x),
        lambda: StandardScaler().fit_arrays(x),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            fit()


def test_kernel_tier_cpu_paths_launch_no_kernel():
    gram_kernels.reset_launches()
    cfg, raw = _small_kernel_timit()
    scorer = kernel_timit.build_scorer_from_params(kernel_timit_params_from_numpy(raw, device="cpu"), cfg,
                                                   device="cpu")
    frames = np.random.default_rng(1).normal(size=(5, 440)).astype(np.float32)
    assert scorer(torch.from_numpy(frames)).shape == (5,)
    x = np.random.default_rng(2).normal(size=(24, 3)).astype(np.float32)
    for gen in (kr.GaussianKernelGenerator(0.1), kr.PolynomialKernelGenerator(2, 0.5, 1.0)):
        est = kr.KernelRidgeRegressionEstimator(gen, block_size=8, cache_kernel_blocks=True)
        est.fit_arrays(x, x[:, :1], device="cpu")
    assert gram_kernels.LAUNCHES == {"gram_block": 0, "poly_block": 0}


def test_kernel_tier_converters_reject_bad_input():
    _, raw = _small_kernel_timit()
    with pytest.raises(ValueError, match="unknown"):
        kernel_timit_params_from_numpy({**raw, "nystrom.bogus": np.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        kernel_timit_params_from_numpy({**raw, "nystrom.whiten": np.zeros((16, 15))}, device="cpu")
    bad = dict(raw)
    del bad["nystrom.landmarks"]
    with pytest.raises(ValueError, match="missing"):
        kernel_timit_params_from_numpy(bad, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        krr_params_from_numpy({"krr.train_x": np.zeros((8, 3)), "krr.alpha": np.zeros((7, 1))}, device="cpu")


TINY_FIT = port.Config(num_classes=3, gmm_k=4, gmm_iters=2, pca_dims=8, descriptor_samples_per_image=8,
                       solver_block_size=64, synthetic_n=12, image_size=40, sift_step=8, lcs_step=8)


def test_fit_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the CPU-only refusal is not observable")
    x = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    y = -np.ones((16, 2), np.float32)
    y[:, 0] = 1.0
    imgs = np.zeros((2, 40, 40, 3), np.uint8)
    for fit in (
        lambda: PCAEstimator(2).fit_arrays(x),
        lambda: KMeansPlusPlusEstimator(2).fit_arrays(x),
        lambda: GaussianMixtureModelEstimator(2).fit_arrays(x),
        lambda: BlockLeastSquaresEstimator(block_size=2).fit_arrays(x, y),
        lambda: BlockWeightedLeastSquaresEstimator(block_size=2).fit_arrays(x, y),
        lambda: port.fit_params(TINY_FIT, imgs, np.zeros(2, np.int32)),
        lambda: port.run_synthetic(TINY_FIT),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            fit()


def test_checkpointed_fits_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the CPU-only refusal is not observable")
    from keystone_tpu_torch.models.lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
    from keystone_tpu_torch.workflow.recovery import fit_with_recovery

    x = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    y = np.ones((16, 2), np.float32)
    ckpt = str(tmp_path / "ckpt")
    for fit in (
        lambda: BlockLeastSquaresEstimator(block_size=2).fit_checkpointed(x, y, ckpt),
        lambda: DenseLBFGSwithL2(num_iterations=2).fit_checkpointed(x, y, checkpoint_dir=ckpt),
        lambda: SparseLBFGSwithL2(num_iterations=2).fit_checkpointed(x, y, checkpoint_dir=ckpt),
        lambda: fit_with_recovery(lambda: BlockLeastSquaresEstimator(block_size=2).with_data(x, y),
                                  max_restarts=0),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            fit()


def test_fit_on_the_cpu_launches_no_kernel():
    fisher_kernels.reset_launches()
    result = port.run_synthetic(TINY_FIT, device="cpu")
    assert 0.0 <= result["top1_error"] <= 1.0
    assert not any(fisher_kernels.LAUNCHES.values()), fisher_kernels.LAUNCHES


@pytest.mark.parametrize("field", ["augmented_eval", "model_path", "stream"])
def test_run_synthetic_refuses_what_is_not_ported(field):
    import dataclasses

    cfg = dataclasses.replace(TINY_FIT, **{field: "model.pt" if field == "model_path" else True})
    with pytest.raises(NotImplementedError, match="ROADMAP A[35]"):
        port.run_synthetic(cfg, device="cpu")


def test_graph_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the CPU-only refusal is not observable")
    from keystone_tpu_torch.loaders import jpeg
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader, _decode_entry_batch
    from keystone_tpu_torch.loaders.labeled import LabeledData
    from keystone_tpu_torch.workflow.dataset import Dataset, as_dataset
    from keystone_tpu_torch.workflow.pipeline import Pipeline
    from keystone_tpu_torch.convert import kernel_cifar_params_from_numpy, oc_krr_mapper_from_numpy
    from keystone_tpu_torch.loaders import cifar
    from keystone_tpu_torch.loaders.cifar import CifarLoader
    from keystone_tpu_torch.loaders.timit import TimitFeaturesDataLoader
    from keystone_tpu_torch.pipelines import kernel_cifar
    from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore, RowBlockStore
    from keystone_tpu_torch.workflow.transformer import Identity

    x = np.ones((4, 3), np.float32)
    store = FeatureBlockStore.from_array(str(tmp_path / "store"), x, block_size=2)
    rows = RowBlockStore.from_array(str(tmp_path / "rows"), x, block_size=2)
    np.save(tmp_path / "f.npy", np.ones((4, 440), np.float32))
    np.save(tmp_path / "l.npy", np.zeros(4, np.int32))
    cifar.write_records(str(tmp_path / "c.bin"), np.zeros((2, 32, 32, 3), np.float32), np.zeros(2, np.int32))
    feats, labs, rec = str(tmp_path / "f.npy"), str(tmp_path / "l.npy"), str(tmp_path / "c.bin")
    gen = kr.GaussianKernelGenerator(0.1)
    _, kt_raw = _small_kernel_timit()
    tars = str(Path(__file__).parent / "data" / "imagenet_tars")
    entries = ImageNetLoader.index(tars)[:2]
    for call in (
        lambda: port.ImageNetSiftLcsFV.run(TINY_FIT),
        lambda: ImageNetLoader.synthetic(2),
        lambda: Dataset(x),
        lambda: Dataset([x[0], x[1]]),
        lambda: as_dataset(x),
        lambda: LabeledData.of(x, np.zeros(4, np.int64)),
        lambda: PCAEstimator(2).fit(x),
        lambda: Pipeline.of(Identity())(x),
        # the streamed path's feeds: the block store's and the decoders
        lambda: next(store.iter_device_blocks([0])),
        lambda: jpeg.decode(*jpeg.pack([b"x"]), (8, 8)),
        lambda: _decode_entry_batch(entries, (8, 8)),
        lambda: ImageNetLoader.stream(tars, size=(8, 8)),
        lambda: ImageNetLoader.load(tars, size=(8, 8)),
        lambda: ImageNetLoader.synthetic_stream(4, 2, (16, 16)),
        # the kernel tier: both pipelines' runs, their loaders, the row store's
        # feed, the out-of-core fit and its model, and the converters
        lambda: kernel_timit.KernelTimitPipeline.run(kernel_timit.Config(num_landmarks=8, synthetic_n=64)),
        lambda: kernel_cifar.KernelCifarPipeline.run(kernel_cifar.Config(num_landmarks=8, synthetic_n=32)),
        lambda: TimitFeaturesDataLoader.load(feats, labs),
        lambda: TimitFeaturesDataLoader.stream(feats, labs),
        lambda: TimitFeaturesDataLoader.synthetic(8),
        lambda: CifarLoader.load(rec),
        lambda: CifarLoader.stream(rec),
        lambda: CifarLoader.synthetic(8),
        lambda: next(rows.iter_device_blocks([0])),
        lambda: kr.KernelRidgeRegressionEstimator(gen, block_size=2).fit_store(rows, np.ones((4, 1), np.float32)),
        lambda: kr.OutOfCoreKernelBlockLinearMapper(gen, rows.directory, np.zeros((4, 1), np.float32), 4),
        lambda: oc_krr_mapper_from_numpy(np.zeros((4, 1), np.float32), rows.directory, 0.1),
        lambda: kernel_cifar_params_from_numpy(kt_raw),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # a tensor stays where it is; a host payload stays on the host
    assert Dataset(torch.from_numpy(x)).device.type == "cpu"
    assert Dataset([torch.zeros(2), torch.ones(2)]).device.type == "cpu"
    assert Dataset(["a", "b"]).is_host
    assert Pipeline.of(Identity())(Dataset(x, device="cpu")).get().device.type == "cpu"


def test_graph_run_on_the_cpu_launches_no_kernel():
    fisher_kernels.reset_launches()
    result = port.ImageNetSiftLcsFV.run(TINY_FIT, device="cpu")
    assert 0.0 <= result["top1_error"] <= 1.0
    assert not any(fisher_kernels.LAUNCHES.values()), fisher_kernels.LAUNCHES


@pytest.mark.parametrize("stream", [False, True])
def test_kernel_pipeline_runs_on_the_cpu_launch_no_kernel(stream):
    from keystone_tpu_torch.pipelines import kernel_cifar

    gram_kernels.reset_launches()
    kernel_timit.KernelTimitPipeline.run(kernel_timit.Config(num_landmarks=16, solver_block_size=16, num_epochs=1,
                                                             synthetic_n=128, stream=stream, stream_batch_size=50),
                                         device="cpu")
    kernel_cifar.KernelCifarPipeline.run(kernel_cifar.Config(num_landmarks=16, solver_block_size=16, num_epochs=1,
                                                             synthetic_n=64, stream=stream, stream_batch_size=20),
                                         device="cpu")
    assert gram_kernels.LAUNCHES == {"gram_block": 0, "poly_block": 0} and not gram_kernels.LAUNCH_SHAPES


def test_text_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the CPU-only refusal is not observable")
    import scipy.sparse as sps

    from keystone_tpu_torch.convert import logistic_regression_model_from_numpy, naive_bayes_model_from_numpy
    from keystone_tpu_torch.loaders.amazon import AmazonReviewsDataLoader, write_jsonl
    from keystone_tpu_torch.loaders.newsgroups import NewsgroupsDataLoader, write_tree
    from keystone_tpu_torch.models.lbfgs import DenseLBFGSwithL2
    from keystone_tpu_torch.models.logistic import LogisticRegressionEstimator
    from keystone_tpu_torch.models.naive_bayes import NaiveBayesEstimator
    from keystone_tpu_torch.ops.sparse import BucketedSparseRows, PaddedSparseRows
    from keystone_tpu_torch.pipelines import amazon_reviews, newsgroups
    from keystone_tpu_torch.workflow.dataset import Dataset

    write_tree(str(tmp_path / "news"), ["a b", "c d"], [0, 1], ["g0", "g1"])
    write_jsonl(str(tmp_path / "r.jsonl"), ["good", "bad"], [1, 0])
    news, reviews = str(tmp_path / "news"), str(tmp_path / "r.jsonl")
    rows = [sps.csr_matrix(np.ones((1, 3), np.float32))] * 2
    x, y = np.ones((2, 3), np.float32), np.zeros(2, np.int64)
    for call in (
        lambda: newsgroups.NewsgroupsPipeline.run(newsgroups.Config(synthetic_n=8)),
        lambda: amazon_reviews.AmazonReviewsPipeline.run(amazon_reviews.Config(synthetic_n=8)),
        lambda: NewsgroupsDataLoader.load(news),
        lambda: NewsgroupsDataLoader.stream(news),
        lambda: NewsgroupsDataLoader.synthetic(4),
        lambda: AmazonReviewsDataLoader.load(reviews),
        lambda: AmazonReviewsDataLoader.stream(reviews),
        lambda: AmazonReviewsDataLoader.synthetic(4),
        lambda: PaddedSparseRows(np.zeros((2, 1), np.int32), np.ones((2, 1), np.float32), 3),
        lambda: PaddedSparseRows.from_scipy_rows(rows),
        lambda: BucketedSparseRows.from_scipy_rows(rows),
        # a host payload's features go to the card unless it was given the CPU
        lambda: NaiveBayesEstimator(2).fit_dataset(Dataset(rows), Dataset(y, device="cpu")),
        lambda: DenseLBFGSwithL2().fit_arrays(x, x),
        lambda: LogisticRegressionEstimator(2).fit_arrays(x, y),
        lambda: NaiveBayesEstimator(2).fit_arrays(x, y),
        lambda: naive_bayes_model_from_numpy(np.zeros(2), np.zeros((2, 3))),
        lambda: logistic_regression_model_from_numpy(np.zeros((3, 2))),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_text_runs_on_the_cpu_launch_no_kernel():
    from keystone_tpu_torch.pipelines import amazon_reviews, newsgroups

    fisher_kernels.reset_launches()
    gram_kernels.reset_launches()
    for head in ("nb", "ls"):
        res = newsgroups.NewsgroupsPipeline.run(newsgroups.Config(synthetic_n=80, head=head, stream=head == "ls",
                                                                  stream_batch_size=32), device="cpu")
        assert 0.0 <= res["accuracy"] <= 1.0
    assert 0.0 <= amazon_reviews.AmazonReviewsPipeline.run(amazon_reviews.Config(synthetic_n=80),
                                                           device="cpu")["accuracy"] <= 1.0
    assert not any(fisher_kernels.LAUNCHES.values()) and not any(gram_kernels.LAUNCHES.values())


def test_serve_entry_points_default_to_the_card(tmp_path):
    """serve(pipeline), FrozenApplier(pipeline) and ``cli serve`` without
    a device take the card, and refuse a box without one."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the CPU-only refusal is not observable")
    from keystone_tpu_torch import cli
    from keystone_tpu_torch.models.linear import LinearMapper
    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.serve import serve
    from keystone_tpu_torch.workflow.pipeline import FrozenApplier, Pipeline

    pipe = Pipeline.of(NormalizeRows()) | LinearMapper(torch.eye(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        FrozenApplier(pipe)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipe.freeze()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(pipe)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(pipe, replicas=2)
    # a process fleet's workers take the card too: refused before a spawn
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(pipe, workers=1)
    path = tmp_path / "m.pt"
    pipe.fit().save(str(path))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve", "--model", str(path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve", "--model", str(path), "--workers", "1"])


def test_multi_tenant_entry_points_default_to_the_card(tmp_path):
    """serve_multi(models), the multi-tenant applier, ``cli serve`` with
    named models, the chaos tool and serve_bench's tenant A/B take the
    card unless asked for the CPU, and refuse a box without one."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the CPU-only refusal is not observable")
    from keystone_tpu_torch import cli
    from keystone_tpu_torch.models.linear import LinearMapper
    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.serve import MultiTenantApplier, serve_multi
    from keystone_tpu_torch.tools import chaos, serve_bench
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    pipe = Pipeline.of(NormalizeRows()) | LinearMapper(torch.eye(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_multi({"a": pipe, "b": pipe})
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiTenantApplier({"a": pipe})
    for name in ("a", "b"):
        pipe.fit().save(str(tmp_path / f"{name}.pt"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve", "--model", f"a={tmp_path / 'a.pt'}", "--model", f"b={tmp_path / 'b.pt'}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        chaos.main(["--workload", "tenants", "--plan", "serve.batch:ctx.tenant=a:raise"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_bench.main(["--tenants", "2", "--dim", "8"])


def test_library_import_path_excludes_serve():
    """``import keystone_tpu_torch`` (and its workflow) imports nothing of
    the serving package, as the reference pins for its own."""
    code = ("import sys, keystone_tpu_torch, keystone_tpu_torch.workflow.pipeline; "
            "print(sorted(m for m in sys.modules if m.startswith('keystone_tpu_torch.serve')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
