"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole check, one card
    python3 chip_smoke.py --profile  # also a profiler breakdown of each main path

Phases, each of which must pass (any failure exits non-zero before the
result line):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every CUDA source of the port compiled by nvcc for sm_90a, and
   the host text chain (csrc/text.cpp) by g++, all at once;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (f32 and a bf16 descriptor stream), plus a
   ragged T with masked rows, within the stated tolerances; then the
   f32-grade check of the FV kernels (3xTF32 on the tensor cores): at B2's
   shape and both of B1's main-path calls, each kernel's largest error
   against a float64 FV chain of the same operands within 2x the plain
   f32 chain's, which one-pass TF32 must fail; then the FV kernels'
   general path, at GMM shapes the tiled kernels refuse (B2 at K = 512,
   B1 at d = 60), held and timed the same way;
4. main paths at full width (batch 128, 128×128 RGB, SIFT step 4 → T=784,
   LCS step 6 → T=324, PCA 64, K=256, 1000 classes; seeded random
   weights made as bench.py makes them): the fused two-branch scorer and
   the unfused bench forward, each with its launch counts set to 0 just
   before and read just after, then checked against the same pipeline
   built on the plain versions (scores within tolerance, top-5 ids equal
   on ≥ 99% of images) and timed as images/s;
5. gram kernels (B3 Gaussian, B4 polynomial/linear) against their plain
   versions on the card: the main paths' shapes in f32 and a bf16 stream,
   d = 3072 and ragged shapes, within the stated tolerances; then the
   f32-grade check: at the serving shape and the KRR column block each
   kernel's largest error against a float64 gram of the same operands
   within 2x the plain f32 chain's, which one-pass TF32 must fail;
6. main path, Kernel TIMIT scoring at full width (d = 440, 2048
   landmarks, γ = 0.015, 147 classes, batches of 8192 frames; seeded
   parameters, the whitening fitted on the card): one gram launch a batch,
   scores against the plain-version pipeline, argmax agreement ≥ 99.9%,
   frames/s;
7. main path, kernel ridge regression at bench.py's kernel-leg geometry
   (n = 8192, d = 256, k = 8, block 512, 2 epochs, γ = 0.002, λ = 1e-4):
   the in-core and cached Gaussian fits, the cached polynomial and linear
   fits, predict and BlockKernelMatrix.matvec, each with its launch
   counts, against the same fits on the plain versions (the polynomial
   and linear fits' α, where it leaves the plain fit's tolerance, against
   a float64 fit); fit seconds and the sweep's TFLOP/s;
8. main path, the ImageNetSiftLcsFV fit at bench.py's fit leg (2048
   synthetic 128×128 images, 64 classes, K = 64, PCA 64, blocks of 4096,
   2 epochs): fit_params with its launch counts (B1 featurizes the
   training set) and seconds by stage, held-out top-1/top-5 error on 512
   test images, then the same fit on the plain versions (vocabulary
   equal, held-out scores within tolerance, top-1 agreement), the card's
   PCA, EM and weighted BCD against float64 on the same inputs (EM and
   BCD with one-pass TF32 products must leave those limits), and B1
   against its plain version at the fit's shape (K = 64; f32-grade where
   f32 itself leaves the tolerance, which one-pass TF32 must fail);
9. main path, ImageNetSiftLcsFV.run through the workflow graph at the
   same fit leg, after a small warm-up run: the graph fit (CSE-merged
   featurization, in-graph PCA/GMM fits, the weighted BCD) with B2
   launched on the training set and SIFT and LCS each applied once to
   it, then scoring with B1 through the optimizer's FV fusion rule (two
   fused nodes in the optimized scoring graph), the held-out top-1 error
   under the gate; the graph-fitted scorer's held-out scores against
   fit_params' scorer (same config and seeds) within tolerance with
   top-1 agreement; a model_path save/load round trip with identical
   top-k; B2 at the graph fit's shape against its plain version
   (f32-grade against float64 where f32 itself leaves the tolerance);
10. main path, ImageNetSiftLcsFV.run with ``stream=True`` (the
   out-of-core fit) at the same fit leg: the training images a
   StreamDataset of synthetic_stream's batches of 64, made on a producer
   thread; the spill (rows, columns, blocks, bytes on disk), B2 launched
   on each streamed batch in the fit and B1 in scoring (the general path
   0), the SIFT and LCS sweeps over the training stream against the
   prediction (three each), no stage materializing the stream;
   against phase 9's in-memory graph fit (same config and seeds): the
   vocabularies equal, the held-out scores within tolerance with top-1
   agreement 1.0, `Pipeline.fit` seconds and peak device memory of both
   fits, the streamed peak below the in-memory one; then
   ``iter_device_blocks`` (pinned buffers, the side copy stream, events)
   against ``read_block`` bit for bit at the fit's block shape, f32 and
   bf16, under a slow consumer;
10b. main path, the fit's planning layer at the same fit leg
   (build_scorer's ``Pipeline.fit`` and its held-out scoring, each with
   its launch counts, seconds, peak device memory and the pre-flight's
   predicted bytes): the default optimizer's profiled materialization
   pass (its ``optimizer.cache_placement`` event under a run ledger, the
   budget half of the card's memory, the fit split by rule batch through
   ``tools/profile_fit.split_fit``) against the structural pass, bit for
   bit; every shared node demoted by a 1-byte budget and recomputed for
   each consumer, bit for bit; the fit auto-spilled by its pre-flight
   (KEYSTONE_HBM_BUDGET_BYTES below the image source): one source
   converted, B2 over its 512-row batches, the spill and the out-of-core
   BCD, its peak below the in-memory fit's, held to it at the streamed
   fit's limits; then ``PreflightOOMError`` on the card's real memory
   (KEYSTONE_AUTO_SPILL=0, a uint8 source of 0.46 of the card) before any
   featurization beyond the profiled pass's sample.  Every graph fit of
   the script prints the pre-flight's prediction beside its peak, and
   no fit may take the profiled pass's structural fallback (the passes
   and their seconds are printed before the kernels' line);
11. the tar loader on the committed fixture (tests/data/imagenet_tars),
   decoded on the card by nvJPEG: ``index``, ``load`` and ``stream``
   agree (the undecodable member skipped by ``load``, a zero image with
   its label in ``stream``), the pixels within the stated difference of
   the reference's libjpeg decode committed beside the fixture, and
   ``run`` from the tars with ``stream`` at accuracy above 0.9;
12. main path, KernelTimitPipeline.run through the graph at its Config's
   full width (d = 440, 2048 landmarks, γ = 0.015, 147 classes, blocks of
   1024, 3 epochs) on 262 144 synthetic frames (seed 1; 65 536 held out,
   seed 2): in memory, then with ``stream`` from an .npy written here in
   batches of 8192; each with its B3 launches by shape, ``Pipeline.fit``
   seconds (the spill and the out-of-core solve apart), frames/s and peak
   device memory; the two runs' landmarks equal bit for bit, held-out
   scores within tolerance, classes agreeing; the whitening against
   float64;
13. main path, KernelCifarPipeline.run the same way on CIFAR-10's split
   sizes (50 000 + 10 000 synthetic images written as CIFAR-10 binary
   records; ``load`` and ``stream`` against the records' bytes), then B3
   at its d = 3072 shapes against its plain version and float64;
14. main path, the out-of-core KRR fit at the KRR geometry above:
   ``fit_store`` on a RowBlockStore against the in-core fit (α, α against
   float64, prediction r², 2·16² B3 launches, spill and sweep seconds,
   peak device memory), the streamed fit through a Pipeline with a
   save/load round trip, a checkpointed fit resumed bit for bit;
15. main path, the BlockKernelMatrix disk tier at that geometry (B3 and
   B4, one column on the card): two sweeps, the second rereading every
   column from disk without a launch; the cached KRR fit taking the tier
   under a budget below K, its α bit for bit as the in-memory cached fit;
16. main path, MnistRandomFFT.run through the graph at its Config (4 FFT
   branches, λ 1e-2) on MNIST's 60 000 + 10 000 rows (synthetic, written
   as the MNIST CSV here), in memory and streamed from the CSV in batches
   of 4096: no kernel launched, fit seconds and peak device memory, the
   two fits' weights and held-out scores together, the scores against
   the float64 normal equations on the same features (one-pass TF32
   control);
17. main path, LinearPixels.run the same way on phase 13's CIFAR-10
   record files (50 000 + 10 000), streamed in batches of 1024;
18. main path, RandomPatchCifar.run at its Config (256 filters of 6×6×3,
   10 patches an image, pool 13/13, α 0.25, blocks of 1024, 2
   iterations, ZCA ε 0.1) on the same files: the Convolver's two forms
   against each other and a float64 conv, timed at 32×32×3 and
   128×128×3, and the whitened filter patches against a float64 eigh;
19. main path, TimitPipeline.run at its Config (4096 cosine features in
   blocks of 1024, γ 0.05, λ 1e-3, mixture weight 0.5, blocks of 1024,
   3 epochs, 147 classes) on phase 12's .npy frames (262 144 + 65 536),
   in memory and streamed in batches of 8192: scores and classes
   together, the cosine features' phase against float64;
20. main path, VOCSIFTFisher.run at its Config (SIFT step 6, bin 4, PCA
   64, K = 16, 10 EM iterations, 64 descriptors an image, λ 1e-4,
   mixture 0.25, blocks of 4096, 2 epochs, 64 px) on VOC 2007's 5011
   trainval images (synthetic; run's own test set, then VOC's 4952 test
   images scored by the fitted pipeline): in memory with B2 launched in
   the fit and B1 in scoring through FvFusionRule (one fused node; the
   general path 0), the same run on the plain FV chains, streamed in
   batches of 32; the vocabularies, scores and mean AP of the three
   against each other; B1 and B2 at VOC's shape against their plain
   versions and float64; then the committed VOC fixture
   (tests/data/voc) through nvJPEG against the reference's libjpeg
   pixels, and run from its directories, in memory and streamed;
21. main path, NewsgroupsPipeline.run at its Config (100 000 features,
   bigrams, nb λ 1.0, ls λ 1e-2) on 20 Newsgroups' bydate split sizes
   (11 314 + 7 532 synthetic documents in 20 groups, written as
   root/<group>/<doc> trees), both heads in memory and streamed in
   batches of 512, each under the profiler: no kernel launched, the
   vocabulary, fit seconds and documents/s, the host text, bucketing and
   device seconds apart, the L-BFGS iterations, line-search trials and
   host reads, the idle share and peak device memory; sparse_matmul and
   sparse_grad at its bucket shapes against a float64 torch.sparse.mm of
   the same rows, naive Bayes against float64 counts, the card's ls fit
   against the same fit on the CPU, streamed against in memory;
22. main path, AmazonReviewsPipeline.run at its Config (16 384 hashed
   features as CSR rows, λ 1e-4, 40 iterations) on 100 000 + 25 000
   synthetic reviews written as JSON lines, in memory and streamed in
   batches of 1024, printed and held the same way, the logistic fit in
   place of the ls fit;
23. main path, the operations layer of a fit, each part with its own
   temporary directories: the streamed ImageNetSiftLcsFV fit at phase
   10's leg three ways (nothing attached, a run ledger, an empty fault
   plan: seconds against phase 10's, B1/B2 launches, the three fits bit
   for bit, the ledger's span and event counts); ``fit_with_recovery``
   of that fit in two child processes of this script (``--recovery-child``)
   with a state_dir and the solver's checkpoint_dir, attempt 1 under a
   KEYSTONE_FAULTS plan (a stage, two stream batches and two block reads
   raised and survived, injected = survived per site; ``exit`` at the
   second epoch save), attempt 2 relaunched, resuming the BCD from epoch
   1, its vocabularies, weights and held-out scores equal to the
   uninterrupted fit's bit for bit, the ledger of both attempts; the
   in-core ``fit_checkpointed`` at the fit leg's BCD geometry interrupted
   at a save and resumed, then a damaged newest checkpoint falling back,
   both bit for bit; the checkpointed L-BFGS, sparse on Newsgroups' ls
   rows (the plain fit's two-run spread beside it) and dense on
   MnistRandomFFT's features, each interrupted at a save and resumed bit
   for bit; the out-of-core KRR under ``kernel.sweep`` (a raise at a
   diagonal step of epoch 2, resumed from epoch 1; a damaged newest
   checkpoint; α bit for bit; B3 counted); ``Pipeline.fit(deadline=...)``
   on the streamed fit, then the next fit bit for bit; a hung stage
   under a deadline leaving no memory; an optional stage's breaker
   opening and degrading to its fallback;
24. main path, serving (the serving slice): B1 against its plain
   version at the smallest and largest padding bucket (8 and 128 rows)
   on the served scorer's weights; S1, the full-width scorer behind
   ``serve()`` on the card (one replica, buckets 8..128): closed loops of
   single-image submits from 8 threads at saturation (32 outstanding a
   thread) and at low concurrency (one), and submit_batch calls of 50,
   every answer's top-5 ids against the offline ``scorer(x)`` (equal, or
   a near-tie within B1's tolerance), B1 twice a flush and no B2, images/s,
   requests a flush, p50/p99 latency, and under the profiler the device
   ms a flush against its host-clock ms (the idle share) at saturation
   and at low concurrency, with the buckets the flushes padded to; the
   served raw scores (``scores_of``) within B1's
   tolerance; S1b, the unfused bench forward behind ``serve()`` (B2 once
   a flush); S2, phase 9's graph-fitted model saved and served by
   ``python -m keystone_tpu_torch.cli serve`` in a child process: held-out
   images POSTed in requests of 1..16 against the in-process fitted(x), a
   400 on a mis-shaped body, the echoed X-Request-Id, /requestz, /statusz,
   the child's launch counts (FvFusionRule fused at freeze: B1, no B2),
   SIGINT drains and exits 0; S3, two replicas on the card under fault
   plans (a crashed worker restarted with no future lost, a failed flush,
   a poison row bisected out) and two replicas of the scorer hot-swapped
   under load to other weights (nothing lost, answers after the commit
   from the new weights), a draining close; S4, serve_bench's open-loop
   generator at 50% and 90% of S1's saturation rate (p50/p99/p99.9, sheds,
   queue depth); S5, the model lifecycle: the scorer's raw scores
   exported at buckets 8..128 and published with S3's weights to a
   temporary registry (v0001, v0002), v0001 served from it on two
   replicas with one CUDA graph a bucket captured at prime (pool bytes by
   bucket, B1 twice in each graph), each replica's replay at each bucket
   bit for bit against its own walk, the served scores against the
   offline scorer; S1's saturation loop with the graphs on and off
   (images/s, p50/p99, the worker's ms a flush by step from
   tools/serve_hostprof.py); ``cli serve --model-dir --watch --canary
   --bake-s`` in a child under POSTed traffic: v0002 committed by the
   canary and baked, a marker-gated v0003 rolled back and quarantined,
   ``POST /rollback`` to v0001, the three episodes in /rolloutz, the
   answers of each phase from its version's weights, nothing lost,
   SIGINT exit 0; the autoscaler (1..3) under an open-loop burst at 1.5x
   S1's saturation growing the fleet, each new replica primed from the
   graphs, and shrinking back to 1 when idle; no artifact fallback
   anywhere, B1's launches by the wrapper and by replays;
25. one JSON line of kernel numbers (ms, plain ms, bounds on the CUDA
   cores and on the tensor cores, launches (bucket-graph replays
   included), float64 errors) for all four kernels, B3's and B4's times at the new paths' shapes and B1's and
   B2's at VOC's among them, then the last line {"ok": true, "device":
   {...}}.  The card's name and power limit and scipy's version are
   printed first.

Imports nothing of JAX; exits non-zero without a result when torch sees
no CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 128
IMAGE_HW = 128
BATCHES = 8  # timed batches per main path (after one warm-up batch)
SIFT_STEP, SIFT_BIN = 4, 4
LCS_STEP, LCS_SUB = 6, 6
PCA_DIMS, GMM_K, NUM_CLASSES = 64, 256, 1000

# tolerances against the plain version on the same inputs, elementwise
# |got − ref| ≤ atol + rtol·|ref|.  atol: the JAX package's own for its
# Pallas kernels (tests/test_pallas.py).  rtol: on the main path's data γ
# concentrates on a few components, whose FV entries reach tens; their
# sums over 784 descriptors, taken in another order than cuBLAS's, round
# at ~1e-6 relative in f32, which an absolute 2e-5 alone does not cover.
TOL_FV = 2e-5
TOL_FUSED = 3e-5
RTOL_F32 = 1e-5
# bf16 descriptor stream against the f32 encode: the JAX package's 5e-2,
# plus bf16's 8-bit mantissa (2^-9 relative) carried into the larger entries
TOL_BF16 = 5e-2
RTOL_BF16 = 1e-2
# class scores: 0.01·normal weights against an L2-normalized 65536-wide
# feature row, so |score| ≲ 0.05; the kernel's FV agrees to ~1e-5
TOL_SCORES = 1e-4
TOP5_AGREEMENT = 0.99

# H100 SXM (NVIDIA data sheet, dense, at 700 W): f32 outside the tensor
# cores and HBM3 bandwidth; the card these runs get reports itself as
# "NVIDIA H100 80GB HBM3", the SXM part
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the tensor cores, dense: TF32 and bf16 (the gram kernels' 3xTF32 f32
# products take three TF32 products a multiply-add, bf16 operands one)
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
DEVICE = "cuda"

# ---- kernel tier
FRAMES = 8192  # Kernel TIMIT batch: the reference Config's stream_batch_size
NUM_TIMIT_CLASSES = 147
KRR_N, KRR_D, KRR_K, KRR_BLOCK, KRR_EPOCHS = 8192, 256, 8, 512, 2  # bench.py kernel leg
KRR_GAMMA, KRR_LAM, KRR_TEST = 0.002, 1e-4, 512
CIFAR_GAMMA = 2e-4  # the reference kernel_cifar Config's γ at d = 3072
# gram tolerances, the JAX package's (tests/test_gram_pallas.py): Gaussian
# f32 1e-5 absolute, polynomial 1e-5 absolute + 1e-5 relative, the bf16
# operand stream 0.06 against the f32 plain version.  0.06 tests nothing
# where every entry is below it (the serving shape's are ≲ 6e-3): there
# the bf16 stream is held at 1e-5 against the plain version on the same
# bf16-rounded operands, and 0.06 against f32 only at the KRR column
# block, whose entries are ~0.36 (γ·‖x − z‖² ≈ 1) and 1 on its diagonal
TOL_GRAM = 1e-5
# On a fitted pipeline's own operands (scaled TIMIT frames, ‖x‖² to ~545)
# K_LL's diagonal is exp(−γ·(‖x‖² − 2x·x + ‖x‖²)), a cancellation that the
# plain f32 chain rounds up to 1.4e-5 below 1 (an H100, 700 W), itself
# outside TOL_GRAM against float64: there it is no reference at 1e-5.
# Where the kernel leaves TOL_GRAM against the plain f32 chain and that
# chain itself leaves it against float64, the kernel is held at the same
# TOL_GRAM against the plain chain evaluated in float64, as B4 is below.
TOL_POLY, RTOL_POLY = 1e-5, 1e-5
TOL_GRAM_BF16 = 0.06
# The polynomial kernel's cross term at d = 256 is a sum of 256 products
# of size ~1 that rounds at ~1e-5 in f32: the kernel (3xTF32, tensor-core
# order) and the plain chain (cuBLAS's f32 SGEMM) round it in different
# orders and can differ by 2e-5 where |ref| ~ 0, so the f32 chain is no
# reference at 1e-5 absolute.  B4 is held at the same tolerance against
# the plain chain evaluated in float64 on the same operands.  Where the
# plain f32 chain itself leaves that tolerance against float64 (the
# linear kernel at the KRR column block: |x.z| to ~330 from partial sums
# of that size), it is below f32's rounding, and the case is held
# f32-grade instead, as below.
# f32-grade: a kernel's largest error against a float64 gram of the same
# operands may be at most F64_RATIO times the plain f32 chain's (cuBLAS,
# TF32 off); one-pass TF32 must exceed it, or the check could not tell.
F64_RATIO = 2.0
# Kernel TIMIT scores: K(x, L) entries ≲ 6e-3 (γ·‖x − l‖² ≥ 5 between
# scaled frames), a well-conditioned whitening and 0.01·normal weights put
# |score| ≲ 1e-3; the kernel's gram agrees with the plain one to ~1e-9
TOL_KT_SCORES = 1e-6
ARGMAX_AGREEMENT = 0.999
# KRR dual coefficients: the JAX package's 2e-5 (tests/test_gram_pallas.py)
# plus the f32 relative term used above for sums taken in another order.
# The polynomial and linear fits solve K_bb + λn·I with λn = 0.82 and
# K_bb of rank ≤ 256 (linear, d = 256) or nearly so: the solve amplifies
# the f32 rounding of K, so two f32 fits whose grams round differently
# may leave this tolerance with neither wrong.  Where one does, each f32
# fit's α is held against a float64 fit of the same data: the kernel
# fit's largest error at most F64_RATIO times the plain fit's.
TOL_ALPHA, RTOL_ALPHA = 2e-5, 1e-5
PRED_R2 = 0.9999

# ---- the fit: bench.py's fit leg (bench.py:89-95, measure_fit at :462-495):
# 2048 synthetic 128×128 images (seed 1), 64 classes, K = 64, PCA 64, the
# reference Config's defaults otherwise (SIFT/LCS step 6, 64 samples an
# image, 10 EM iterations, λ = 1e-4, mixture weight 0.25), blocks of 4096
# (16 384 features: 4 blocks), 2 epochs; 512 held-out images (seed 2)
FIT_N, FIT_TEST_N, FIT_CLASSES, FIT_GMM_K, FIT_BLOCK, FIT_EPOCHS = 2048, 512, 64, 64, 4096, 2
FIT_BATCH = 128
FIT_SIFT_T, FIT_LCS_T = 361, 324  # descriptors an image at step 6 on 128 px
# the kernel fit against the plain fit.  The PCA and GMM fits run no
# kernel: equal up to 1e-6.  B1 rounds the training features otherwise
# than the plain chain (~1e-5 at FV entries of tens); the power
# normalization's √ turns such an error at an entry near 0 into ~3e-3,
# and the solve carries it into the weights, so held-out scores (|s| ≲ 2)
# are held at 1e-3 + 1e-3·|ref|, and their top-1 class agree on ≥ 99.9%
TOL_VOCAB = 1e-6
TOL_FIT_SCORES, RTOL_FIT_SCORES = 1e-3, 1e-3
FIT_TOP1_AGREEMENT = 0.999
# held-out top-1 error well under chance (1 − 1/64 = 0.984)
FIT_TOP1_ERROR_MAX = 0.5
# the card's f32 fits against the same computations in float64 on the
# same inputs.  PCA: the projector C·Cᵀ against a float64 SVD of the
# sample (a CPU rehearsal at n = 256 read 3e-6).  EM from the same start:
# the reference's own EM tolerances, f32 against its double-accumulating
# native EM (tests/test_native.py:235-237; the rehearsal read 1.6e-5 in
# μ).  Weighted BCD: the weights within 1e-3 of their largest entry, the
# held-out predictions (|p| ≲ 2) within 3e-5 (the rehearsal: 6e-5, 3e-6).
# EM and BCD also run with one-pass TF32 products, which must leave these
# limits: on the card an f32 solve's predictions read 6.5e-6 from float64
# and a TF32 solve's 8.9e-5, past an earlier 1e-4 limit on neither side
TOL_PROJECTOR = 1e-4
TOL_EM_W, TOL_EM_MU, TOL_EM_VAR = 2e-5, 2e-4, 2e-4
RTOL_BCD_W, TOL_BCD_PRED = 1e-3, 3e-5

# ---- the graph: ImageNetSiftLcsFV.run at the same fit leg, after a warm-up
# run on GRAPH_WARMUP_N training images.  Against fit_params' scorer (same
# config, seeds and draws): the vocabulary is fitted on the same sampled
# rows, but the graph featurizes the training set with B2 on normalized,
# projected SIFT where fit_params runs B1 on raw SIFT, two kernels that
# round the FV otherwise (on a fitted GMM the FV kernels and the plain f32
# chain differ by up to ~7e-3 at entries ~10); the power normalization and
# the solve carry that into the weights as between the kernel fit and the
# plain fit above, so the held-out scores are held at that fit's
# 1e-3 + 1e-3·|ref|, and their top-1 classes agree on ≥ 99%
GRAPH_WARMUP_N = 256
TOL_GRAPH_SCORES, RTOL_GRAPH_SCORES = 1e-3, 1e-3
GRAPH_TOP1_AGREEMENT = 0.99

# ---- the streamed fit: ImageNetSiftLcsFV.run with stream=True at the same
# fit leg, the training images in batches of STREAM_BATCH (the reference
# Config's stream_batch_size).  Predicted before its first run (PERF.md):
# each consumer of the training stream re-runs it, so each branch's
# extractor sweeps it STREAM_SWEEPS times (its two samplers and the
# solver's spill).  Against phase 9's fit (same images, draws and seeds):
# the vocabularies are fitted on the same rows (below); the features are
# the same up to the roundings of batches of 64 in place of chunks of 128
# and of the solve's means taken a block at a time, which the solve
# carries into the held-out scores (|s| ≲ 2): held at phase 9's 1e-3 +
# 1e-3·|ref| for two fits whose features round apart (a CPU rehearsal at
# 96 images and K = 4 read 6.4e-4 at |ref| 2.9), and their top-1 classes
# agree on every image
STREAM_BATCH = 64
STREAM_SWEEPS = 3
# the vocabularies: the same rows are sampled, but an extractor's products
# over a batch of 64 and a chunk of 128 may round apart in the last bit
# (the libraries pick their kernels by shape; on the CPU, SIFT of 16 and of
# 96 images differed by 1.5e-8 on 0.01% of entries), which the PCA passes
# on at that size and ten EM iterations amplify: the projector is held at
# 1e-5, the PCA mean at TOL_VOCAB, the GMM at the reference's own EM
# tolerances (TOL_EM_*); whether they came out bit for bit is printed
TOL_STREAM_PROJECTOR = 1e-5
TOL_STREAM_SCORES, RTOL_STREAM_SCORES = TOL_GRAPH_SCORES, RTOL_GRAPH_SCORES
STREAM_TOP1_AGREEMENT = 1.0

# ---- the fit's planning layer at the same fit leg (build_scorer's
# Pipeline.fit, its held-out scores on the 512 images): the default
# optimizer's profiled materialization pass (its sample of
# materialize_sample() rows, the cache budget half of the card's memory)
# against the structural pass, bit for bit (a Cacher is an identity); every
# shared node demoted (a budget of 1 byte) and recomputed for each
# consumer, bit for bit; the fit auto-spilled by its pre-flight with the
# device's memory overridden to SPILL_OVERRIDE, below the 96 MiB image
# source: the source a stream of KEYSTONE_SPILL_BATCH's 512-row batches,
# B2 over each, the features spilled and the BCD out of core.  That fit's
# extractors run over batches of 512 where the in-memory fit runs chunks
# of 128, which the libraries may round otherwise (as the streamed fit's
# batches of 64): it is held at the streamed fit's limits, with top-1
# agreement on every image, and whether it came out bit for bit is
# printed.  Then the refusal on the card's real memory: with
# KEYSTONE_AUTO_SPILL=0 a uint8 source of REFUSAL_FRACTION of the card
# (over the pre-flight's 0.45) is refused before any featurization of it
SPILL_OVERRIDE = 64 << 20
SPILL_BATCH = 512
REFUSAL_FRACTION = 0.46

# ---- the tar loader: the committed fixture (tests/data/make_imagenet_tars.py),
# decoded on the card by nvJPEG, against the reference's libjpeg pixels.
# nvJPEG's IDCT and chroma upsampling are not libjpeg's: on this fixture
# (32×32, 4:2:0, quality 95) its pixels were at most 10 levels from
# libjpeg's (mean 1.28 on an H100; PERF.md); the resize adds nothing.
# The limit leaves room above that for another nvJPEG build, and stays
# below two thirds of what a wrong decode reads, measured on the same output:
# channels swapped, chroma dropped (luma only), or shifted by one pixel
# (the last read 27-38 levels an image from libjpeg's pixels on this
# fixture, the others 99-171 over it)
REPO = Path(__file__).resolve().parent
TARS = REPO / "tests" / "data" / "imagenet_tars"
TAR_PIXELS = REPO / "tests" / "data" / "imagenet_tars_decoded.npy"
TAR_SIZE, TAR_MEMBERS, TAR_BAD = (32, 32), 13, 6
NVJPEG_MAX_DIFF = 16
TAR_ACCURACY_MIN = 0.9

# ---- the kernel pipelines, fitted through the graph at their Configs' full
# width: KernelTimitPipeline on a quarter of TIMIT's training frames
# (262 144; the test set, as the reference's run makes it, a quarter of
# that), KernelCifarPipeline on CIFAR-10's split sizes.  Each runs in
# memory, then streamed (TIMIT from an .npy in batches of its Config's
# 8192, CIFAR from a record file in batches of 1024); the two runs draw
# the same landmarks bit for bit (the scaler's float64 moments round to
# the same f32 over a stream), and their held-out scores differ only as
# the in-core and out-of-core BCD round their sums; held at the graph
# phases' 1e-3 + 1e-3·|ref|, predicted classes agreeing on ≥ 99.9%.
# The whitening is held f32-grade against float64 (kernel fit's error at
# most F64_RATIO times the plain f32 chain's) or within TOL_WHITEN.
KT_N, KT_TEST_N, KT_BATCH = 262_144, 65_536, 8192
CIFAR_N, CIFAR_TEST_N = 50_000, 10_000
TOL_PIPE_SCORES, RTOL_PIPE_SCORES, PIPE_AGREEMENT = 1e-3, 1e-3, 0.999
PIPE_ACCURACY_MIN = 0.5  # the reference's own gate on both pipelines (tests/test_pipelines.py)
TOL_WHITEN = 1e-5
# ---- the dense apps, each fitted through the graph by its ``run`` at its
# Config's widths: MnistRandomFFT on MNIST's split sizes (synthetic rows
# written as the MNIST CSV), LinearPixels and RandomPatchCifar on
# CIFAR-10's (the kernel CIFAR phase's record files), TimitPipeline on the
# kernel TIMIT phase's frames, VOCSIFTFisher on VOC 2007's 5011 trainval
# images (synthetic, 64 px; run's own test set is max(8, n // 3) images,
# then VOC's 4952 test images are scored by the fitted pipeline).
# Accuracy gates: the reference's own (tests/test_pipelines.py): 0.8
# MNIST and LinearPixels, 0.6 RandomPatchCifar, 0.5 TIMIT, mean AP 0.2
# VOC.  Streamed fits against in-memory ones: the linear apps' weights
# within the app's TOL_LINEAR_W of the largest weight (Gramians summed
# over stream batches and over 4096-row views, each with Kahan steps,
# through a solve regularized by λn), scores as the kernel pipelines'
# above; each fit's weights against the float64 normal equations on the
# same features within that limit too, and the same fit with one-pass
# TF32 products must leave it.  Each limit lies between the app's sound
# readings and its TF32 one, on an H100 (700 W): MNIST 6.3e-5 and 6.2e-5
# from float64, 4.3e-5 apart, TF32 2.28e-4; LinearPixels 1.6e-4 and
# 6.4e-5, 1.8e-4 apart, TF32 6.67e-4 (over 50 000+ rows an f32
# Gramian's error is mostly its accumulation's, which one-pass TF32
# inputs, 2⁻¹¹ a row averaging out, raise only 3.6x and 4.1x).  Without a
# kernel on the path, a path is held against float64 instead: its f32
# error within the stated tolerance and at most 1/TF32_MARGIN of the
# same computation's with one-pass TF32 products.
MNIST_N, MNIST_TEST_N = 60_000, 10_000
VOC_N, VOC_TEST_N = 5011, 4952
DENSE_CHUNK = 128
DENSE_ACCURACY_MIN, PATCH_ACCURACY_MIN, VOC_MAP_MIN = 0.8, 0.6, 0.2
TOL_LINEAR_W = {"MnistRandomFFT": 1.5e-4, "LinearPixels": 3.5e-4}
TF32_MARGIN = 4.0
# a conv of 108-term sums, relative to the largest |output|: f32 rounds at
# ~1e-7 a term (7e-7 to 9e-7 on an H100), one-pass TF32 at ~5e-4
TOL_CONV_REL = 1e-5
# the whitened filter patches, relative to the largest: an f32
# eigendecomposition of the 108×108 covariance is exact to ~108·2⁻²⁴·‖C‖
# (‖C‖ ≈ 1.8), which (λ + ε)^(−1/2) at ε = 0.1 carries into the map ×12
# at most, ~1e-4; on an H100 3.2e-5, one-pass TF32 7.9e-4
TOL_ZCA_REL = 1e-4
# cos of a phase of ~1 (γ = 0.05 over 440 scaled dims): f32 ~1e-6
TOL_COSINE = 1e-5
# the Convolver's forms timed at RandomPatchCifar's images and a larger one
CONV_SIZES = (32, 64, 96, 128, 160)
# the mean AP of two fits whose features round apart (kernel and plain,
# streamed and in memory) over 4952 images
VOC_MAP_AGREE = 5e-3
VOC_DIRS = {"images_dir": str(REPO / "tests" / "data" / "voc" / "JPEGImages"),
            "annotations_dir": str(REPO / "tests" / "data" / "voc" / "Annotations")}
VOC_PIXELS = REPO / "tests" / "data" / "voc_decoded.npy"
VOC_FIXTURE_SIZE, VOC_FIXTURE_N, VOC_FIXTURE_MAP_MIN = (48, 48), 31, 0.5
# nvJPEG against libjpeg on the VOC fixture (40–72 px colour gratings, 4:2:0,
# quality 90, resized to 48 px by the same bilinear code): on an H100
# (700 W) up to 29 levels (mean 3.2) at the gratings' edges, where the
# decoders' chroma upsampling differs; a wrong decode reads 132 or more
# there (``wrong_decodes``)
VOC_NVJPEG_MAX_DIFF = 40
# ---- the out-of-core kernel tier at the KRR geometry above: α of the
# out-of-core sweep against the in-core sweep, the reference's 1e-5
# (tests/test_kernel_oc.py:107), and its prediction r²
TOL_OC_ALPHA, OC_R2 = 1e-5, 0.999


# ---- the text apps, each fitted through the graph by its ``run`` at its
# Config's width: NewsgroupsPipeline (100 000 features, bigrams, nb λ 1.0,
# ls λ 1e-2) on 20 Newsgroups' "bydate" split sizes, 11 314 training and
# 7 532 test documents of the reference's synthetic corpus at 20 groups
# (seeds 1 and 2), written here as root/<group>/<doc> trees: both heads in
# memory and streamed in batches of 512; AmazonReviewsPipeline (16 384
# hashed features as CSR rows, λ 1e-4, 40 iterations) on 100 000 synthetic
# reviews and the Config's quarter, 25 000, for test (seeds 1 and 2),
# written here as JSON lines: in memory and streamed in batches of 1024.
# No kernel lies on these paths: the gathers, scatter-adds and the L-BFGS
# loop are torch's own ops, as XLA's are in the reference.
NEWS_N, NEWS_TEST_N, NEWS_CLASSES, NEWS_BATCH = 11_314, 7_532, 20, 512
AMAZON_N, AMAZON_BATCH = 100_000, 1024
TEXT_ACCURACY_MIN = 0.9
# the sparse ops at the apps' bucket shapes against a float64
# torch.sparse.mm of the same CSR rows: an f32 sum of m terms in any order
# is within m·2⁻²⁴·Σ|terms| of the exact sum (about √m times less in
# practice); held elementwise at 1e-5·Σ|terms| (m ≤ 11 314 rows in a
# gradient's column, 2⁻²⁴·m = 6.7e-4 at worst)
TOL_SPARSE_REL = 1e-5
# naive Bayes' log conditionals against float64 counts (scipy), and two
# card fits against each other: the reference's own f32 limits
# (tests/test_sparse.py:179-203)
TOL_NB_RTOL, TOL_NB_ATOL = 1e-5, 1e-5
# two L-BFGS fits of one problem whose f32 sums are taken in other orders
# (the card's index_add_ adds in no fixed order, the CPU's in row order).
# Where both took the same line-search path (equal trial counts), the
# weights within 1e-4 of the largest.  Near the optimum the Armijo test
# compares objective changes with the objective's own f32 rounding, so a
# trial can go either way; where the paths parted (unequal counts), the
# fits are two points of the optimum's f32 noise floor, and the weights
# are held at the reference's own limit for fits whose paths differ,
# 2e-2 of the largest (tests/test_sparse.py:60).  Either way both fits
# must satisfy the strong-convexity certificates of the objective (λ-
# strongly convex, in float64): ‖w_a − w_b‖ ≤ (‖∇f(w_a)‖ + ‖∇f(w_b)‖)/λ
# and |f(w_a) − f(w_b)| ≤ max ‖∇f‖²/(2λ), and their argmax agree on
# ≥ 99.9% of the test documents
TOL_TEXT_W, TOL_PARTED_W, TEXT_AGREEMENT = 1e-4, 2e-2, 0.999


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"[phase] {name} ...", flush=True)
    yield
    print(f"[phase] {name} ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def fv_cost(n, t, d, k, d_in=0, desc_bytes=4):
    """(bytes, flops) a Fisher-vector kernel call must move and do: each
    input read once, the FV written once; four T·d·K contractions per
    image (two posterior gemms, γᵀx, γᵀx²) plus the d_in→d projection."""
    gmm = (k + 2 * k * d) * 4
    if d_in:
        inputs = n * t * d_in * desc_bytes + (d_in * d + d_in) * 4
    else:
        inputs = n * t * d * desc_bytes
    nbytes = inputs + n * t * 4 + gmm + n * 2 * k * d * 4
    flops = n * (8 * t * d * k + 2 * t * d_in * d)
    return nbytes, flops


def gram_cost(n, m, d, operand_bytes=4, degree=None):
    """(bytes, flops) of one gram block: each operand read once, the (n, m)
    f32 block written once; the 2·n·m·d cross product plus, for the
    Gaussian, the row norms (2·(n+m)·d) and a 5-operation epilogue
    (two subtractions, the clamp, the scale, the exp), for the polynomial
    the affine step and degree − 1 multiplications."""
    nbytes = (n + m) * d * operand_bytes + n * m * 4
    flops = 2 * n * m * d
    if degree is None:
        flops += 2 * (n + m) * d + 5 * n * m
    else:
        flops += n * m * (2 + max(degree - 1, 0))
    return nbytes, flops


def kernel_flops(n_rows, d, k, bs, epochs):
    """The blockwise KRR sweep's FLOPs, bench.py::kernel_flops: per epoch
    and block the (n × bs) column gemm, the F update, the block target
    and the bs³/3 Cholesky."""
    nb = -(-n_rows // bs)
    per_epoch = nb * (2 * n_rows * bs * d + 2 * n_rows * bs * k + 2 * bs * bs * k + bs**3 / 3)
    return float(epochs * per_epoch)


def bound_by(nbytes, flops):
    return "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES else "bytes"


def bound_ms(nbytes, flops):
    return 1e3 * max(nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS)


def fv_bound_ms_tc(n, t, d, k, d_in=0):
    """The least time of one FV kernel call on the tensor cores: its bytes
    (``fv_cost``) over the memory rate, or its flops as three TF32 passes."""
    nbytes, flops = fv_cost(n, t, d, k, d_in=d_in)
    return 1e3 * max(nbytes / PEAK_BYTES, 3 * flops / PEAK_TF32_FLOPS)


def bound_ms_tc(n, m, d, bf16=False):
    """The least time of one gram block on the tensor cores: its bytes
    (``gram_cost``) over the memory rate, or its 2·n·m·d product flops
    as three TF32 passes (f32 operands) or one bf16 pass."""
    nbytes, _ = gram_cost(n, m, d, 2 if bf16 else 4)
    flops = 2 * n * m * d
    ops = flops / PEAK_BF16_FLOPS if bf16 else 3 * flops / PEAK_TF32_FLOPS
    return 1e3 * max(nbytes / PEAK_BYTES, ops)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def within(name, got, ref, atol, rtol=RTOL_F32):
    """(largest error, worst ratio to atol + rtol·|ref|), printed; a float64
    ref keeps its precision."""
    dt = torch.float64 if ref.dtype == torch.float64 else torch.float32
    diff = (got.to(dt) - ref).abs()
    err = diff.max().item()
    ratio = (diff / (atol + rtol * ref.abs())).max().item()
    print(f"  {name}: max_abs_err={err:.3e} (|ref| max {ref.abs().max().item():.3e}); "
          f"tol {atol:.0e} + {rtol:.0e}·|ref|, worst ratio {ratio:.3f}", flush=True)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    return err, ratio


def compare(name, got, ref, atol, rtol=RTOL_F32):
    err, ratio = within(name, got, ref, atol, rtol)
    check(ratio <= 1.0, f"{name}: error above tolerance (worst ratio {ratio:.3f})")
    return err


def gram_f64(x, z, gamma):
    """The Gaussian plain chain in float64 on the same operands."""
    x, z = x.double(), z.double()
    sq = (x * x).sum(1, keepdim=True) - 2.0 * x @ z.T + (z * z).sum(1)
    return torch.exp(-gamma * sq.clamp(min=0.0))


def poly_f64(x, z, alpha, c, degree):
    """The polynomial plain chain in float64 on the same operands."""
    return (alpha * (x.double() @ z.double().T) + c) ** int(degree)


def fv_f64(xs, mask, w, mu, var):
    """The FV plain chain (``fisher_encode_ref``'s math) in float64 on the
    same operands; ``fisher_encode_ref`` itself computes in f32."""
    from keystone_tpu_torch.models.gmm import _log_gaussians

    xs, mask, w, mu, var = (a.double() for a in (xs, mask, w, mu, var))
    n, t, d = xs.shape
    lg = _log_gaussians(xs.reshape(n * t, d), mu, var, torch.log(w))
    gamma = torch.softmax(lg, dim=1).reshape(n, t, -1) * mask[..., None]
    tnorm = torch.clamp(mask.sum(dim=1), min=1.0)[:, None, None]
    s0 = gamma.sum(dim=1)[..., None]
    s1 = torch.einsum("ntk,ntd->nkd", gamma, xs)
    s2 = torch.einsum("ntk,ntd->nkd", gamma, xs * xs)
    phi1 = (s1 - s0 * mu) / torch.sqrt(var) / (tnorm * torch.sqrt(w)[None, :, None])
    phi2 = ((s2 - 2.0 * mu * s1 + s0 * mu * mu) / var - s0) / (tnorm * torch.sqrt(2.0 * w)[None, :, None])
    return torch.cat([phi1.reshape(n, -1), phi2.reshape(n, -1)], dim=1)


def fused_f64(desc, mask, components, mean, w, mu, var, normalize=True):
    """``fused_forward_ref``'s chain in float64 on the same operands."""
    from keystone_tpu_torch.ops.sift import _sift_normalize

    z = desc.double()
    if normalize:
        z = _sift_normalize(z)
    if mean is not None:
        z = z - mean.double()
    return fv_f64(z @ components.double(), mask, w, mu, var)


@contextlib.contextmanager
def tf32_matmul():
    """One-pass TF32 for f32 torch.matmul (the negative control), restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def max_err64(a, ref64) -> float:
    return (a.double() - ref64).abs().max().item()


def fv_launches(encode=0, fused=0) -> dict:
    """The FV kernels' launch counts of a path that takes the tiled kernels only."""
    return {"fisher_encode": encode, "fused_forward": fused, "fisher_encode_general": 0,
            "fused_forward_general": 0}


def reset_all(*modules) -> None:
    for m in modules:
        m.reset_launches()


def gram_checks(gk, dev, rng, serving, krr_x):
    """B3 and B4 against their plain versions on the card, then the
    f32-grade check against float64; returns the largest error of each
    kernel and of the bf16 stream (against the plain version on the same
    bf16 operands, and against f32), and the float64 errors by case."""
    xs, lmk, gamma = serving
    xb = krr_x[:KRR_BLOCK]
    errs = {"gram_block": 0.0, "poly_block": 0.0, "gram_block_bf16": 0.0, "gram_block_bf16_vs_f32": 0.0,
            "poly_block_bf16": 0.0}

    def t(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def gauss(label, x, z, g, key="gram_block", atol=TOL_GRAM, want=None):
        got = gk.gram_block_kernel(x, z, g)
        want = gk.gram_block_ref(x, z, g) if want is None else want
        errs[key] = max(errs[key], compare(label, got, want, atol, 0.0))

    def poly(label, x, z, a, c, deg, key="poly_block"):
        got = gk.poly_block_kernel(x, z, a, c, deg)
        want = poly_f64(x, z, a, c, deg)
        err, ratio = within(f"{label} vs the plain chain in float64", got, want, TOL_POLY, RTOL_POLY)
        if ratio > 1.0:  # see TOL_POLY: only where f32 itself cannot meet the tolerance
            e_plain, r_plain = within("  the plain f32 chain", gk.poly_block_ref(x, z, a, c, deg), want,
                                      TOL_POLY, RTOL_POLY)
            print(f"  below f32's rounding here: held f32-grade instead, error {err / e_plain:.3f} "
                  f"of the plain f32 chain's (at most {F64_RATIO})", flush=True)
            check(x.dtype == torch.float32 and r_plain > 1.0 and err <= F64_RATIO * e_plain,
                  f"{label}: error above tolerance (worst ratio {ratio:.3f})")
        errs[key] = max(errs[key], err)

    with phase("gram kernels vs plain versions"):
        serving_shape = (xs.shape[0], lmk.shape[0], xs.shape[1])
        column_shape = (krr_x.shape[0], xb.shape[0], krr_x.shape[1])
        gauss(f"B3 f32 serving {serving_shape}", xs, lmk, gamma)
        gauss(f"B3 bf16 stream vs plain on the same bf16 operands, serving {serving_shape}",
              xs.bfloat16(), lmk.bfloat16(), gamma, "gram_block_bf16")
        gauss(f"B3 f32 KRR column block {column_shape}", krr_x, xb, KRR_GAMMA)
        gauss(f"B3 bf16 stream vs plain f32, KRR column block {column_shape}", krr_x.bfloat16(),
              xb.bfloat16(), KRR_GAMMA, "gram_block_bf16_vs_f32", TOL_GRAM_BF16,
              gk.gram_block_ref(krr_x, xb, KRR_GAMMA))
        cx = t((2048, 3072))
        gauss("B3 f32 d=3072 (1024, 1024, 3072)", cx[:1024], cx[1024:], CIFAR_GAMMA)
        rx, rz = t((1000, 37)), t((777, 37))
        gauss("B3 f32 ragged (1000, 777, 37)", rx, rz, 0.1)
        poly(f"B4 degree 2, α=1/{KRR_D}, c=1 {column_shape}", krr_x, xb, 1.0 / KRR_D, 1.0, 2)
        poly(f"B4 linear (1, 0, 1) {column_shape}", krr_x, xb, 1.0, 0.0, 1)
        poly(f"B4 degree 3, α=0.05, c=-0.5 {column_shape}", krr_x, xb, 0.05, -0.5, 3)
        poly("B4 ragged degree 2, α=0.3, c=0.5 (1000, 777, 37)", rx, rz, 0.3, 0.5, 2)
        poly(f"B4 bf16 stream degree 2 on the same bf16 operands {column_shape}", krr_x.bfloat16(),
             xb.bfloat16(), 1.0 / KRR_D, 1.0, 2, "poly_block_bf16")
        torch.cuda.synchronize()

    f64 = {"gram_block": {}, "poly_block": {}}
    with phase("gram kernels: f32-grade against float64"):
        for key, where, kern, plain, exact in (
            ("gram_block", "serving", lambda: gk.gram_block_kernel(xs, lmk, gamma),
             lambda: gk.gram_block_ref(xs, lmk, gamma), lambda: gram_f64(xs, lmk, gamma)),
            ("gram_block", "krr_column", lambda: gk.gram_block_kernel(krr_x, xb, KRR_GAMMA),
             lambda: gk.gram_block_ref(krr_x, xb, KRR_GAMMA), lambda: gram_f64(krr_x, xb, KRR_GAMMA)),
            ("poly_block", "degree 2 krr_column", lambda: gk.poly_block_kernel(krr_x, xb, 1.0 / KRR_D, 1.0, 2),
             lambda: gk.poly_block_ref(krr_x, xb, 1.0 / KRR_D, 1.0, 2),
             lambda: poly_f64(krr_x, xb, 1.0 / KRR_D, 1.0, 2)),
            ("poly_block", "linear krr_column", lambda: gk.poly_block_kernel(krr_x, xb, 1.0, 0.0, 1),
             lambda: gk.poly_block_ref(krr_x, xb, 1.0, 0.0, 1), lambda: poly_f64(krr_x, xb, 1.0, 0.0, 1)),
            ("poly_block", "linear serving", lambda: gk.poly_block_kernel(xs, lmk, 1.0, 0.0, 1),
             lambda: gk.poly_block_ref(xs, lmk, 1.0, 0.0, 1), lambda: poly_f64(xs, lmk, 1.0, 0.0, 1)),
        ):
            ref = exact()
            e_kernel, e_plain = max_err64(kern(), ref), max_err64(plain(), ref)
            with tf32_matmul():
                e_tf32 = max_err64(plain(), ref)
            print(f"  {key} {where}: largest error against float64: kernel {e_kernel:.3e}, plain f32 chain "
                  f"{e_plain:.3e} (ratio {e_kernel / e_plain:.3f}, at most {F64_RATIO}); one-pass TF32 "
                  f"{e_tf32:.3e} (ratio {e_tf32 / e_plain:.1f}, must exceed {F64_RATIO})", flush=True)
            check(e_kernel <= F64_RATIO * e_plain, f"{key} {where}: not f32-grade against float64")
            check(e_tf32 > F64_RATIO * e_plain, f"{key} {where}: the check cannot tell TF32 from f32")
            f64[key][where] = {"kernel": e_kernel, "plain_f32": e_plain, "tf32": e_tf32}
            del ref
        torch.cuda.synchronize()
    return errs, f64


def kernel_timit_setup(dev):
    """Full-width seeded Kernel TIMIT scorer and its plain twin, and the
    timed frames (9 batches of 8192)."""
    from keystone_tpu_torch.convert import kernel_timit_params_from_numpy
    from keystone_tpu_torch.loaders import timit
    from keystone_tpu_torch.loaders.timit import TimitFeaturesDataLoader
    from keystone_tpu_torch.ops import gram_kernels as gk
    from keystone_tpu_torch.pipelines import kernel_timit as KT

    cfg = KT.Config()
    gk.reset_launches()
    raw = KT.random_params(cfg, device=dev)
    check(gk.LAUNCHES["gram_block"] == 1, f"whitening fit launched {gk.LAUNCHES}")
    params = kernel_timit_params_from_numpy(raw, dev)
    scorer = KT.build_scorer_from_params(params, cfg, dev)
    plain = KT.build_scorer_from_params(params, cfg, dev, use_kernel=False)
    frames, _ = TimitFeaturesDataLoader.synthetic_arrays((BATCHES + 1) * FRAMES, cfg.num_classes, seed=3)
    batches = list(torch.from_numpy(frames).to(dev).split(FRAMES))
    xs = scorer.stages[0](batches[0])  # the scaled frames the gram kernel is given
    lmk = params["nystrom.landmarks"]
    check(tuple(xs.shape) == (FRAMES, timit.DIM) and tuple(lmk.shape) == (cfg.num_landmarks, timit.DIM),
          f"B3 serving input {tuple(xs.shape)} against {tuple(lmk.shape)}")
    return scorer, plain, batches, (xs, lmk, cfg.gamma)


def kernel_timit_path(card, scorer, plain, batches, kt_mod, gk, fk):
    with phase("main path: kernel TIMIT scoring"):
        scorer(batches[0])  # warm-up, not counted
        torch.cuda.synchronize()
        reset_all(gk, fk)
        t0 = time.perf_counter()
        outs = [scorer(b) for b in batches[1:]]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(gk.LAUNCHES)
        fps = BATCHES * FRAMES / dt
        print(f"  launches {launches}; {fps:.1f} frames/s over {BATCHES} batches of {FRAMES} ({card})",
              flush=True)
        check(launches == {"gram_block": BATCHES, "poly_block": 0},
              f"gram launches {launches}, expected one a batch")
        check(not any(fk.LAUNCHES.values()), f"FV kernels launched {fk.LAUNCHES}")
        worst, agree = 0.0, 0
        for b, out in zip(batches[1:], outs):
            sk, sp = kt_mod.scores_of(scorer)(b), kt_mod.scores_of(plain)(b)
            check(tuple(sk.shape) == (FRAMES, NUM_TIMIT_CLASSES), f"scores shape {tuple(sk.shape)}")
            check(bool(torch.isfinite(sk).all()), "non-finite scores")
            check(tuple(out.shape) == (FRAMES,), f"predictions shape {tuple(out.shape)}")
            worst = max(worst, max_err(sk, sp))
            agree += int((out == torch.argmax(sp, dim=1)).sum())
        frac = agree / (BATCHES * FRAMES)
        print(f"  scores vs plain-version pipeline: max_abs_err={worst:.3e} tol={TOL_KT_SCORES:.0e}; "
              f"argmax agreement {frac:.5f}", flush=True)
        check(worst <= TOL_KT_SCORES, f"scores differ by {worst:.3e}")
        check(frac >= ARGMAX_AGREEMENT, f"argmax agreement {frac:.5f}")
    return {"frames_per_s": fps, "launches": launches["gram_block"], "seconds": dt}


def krr_data(dev):
    """Seeded train rows, labels and test rows, made as bench.py makes them."""
    n, d, k = KRR_N, KRR_D, KRR_K
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    y = np.tanh(x @ w / np.sqrt(d)).astype(np.float32)
    xt = rng.normal(size=(KRR_TEST, d)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, y, xt))


def krr_alpha_f64(kern64, x, y):
    """α of the blockwise sweep (the cached fits' Gauss–Seidel over column
    blocks, straightforwardly, no padding at n = 8192) in float64, with the
    float64 kernel ``kern64``."""
    x, y = x.double(), y.double()
    n, bs = x.shape[0], KRR_BLOCK
    cols = [kern64(x, x[lo:lo + bs]) for lo in range(0, n, bs)]
    reg = KRR_LAM * n * torch.eye(bs, dtype=torch.float64, device=x.device)
    alpha, f = torch.zeros_like(y), torch.zeros_like(y)
    for _ in range(KRR_EPOCHS):
        for b, lo in enumerate(range(0, n, bs)):
            kbb, ab = cols[b][lo:lo + bs], alpha[lo:lo + bs]
            new = torch.linalg.solve(kbb + reg, y[lo:lo + bs] - f[lo:lo + bs] + kbb @ ab)
            f += cols[b] @ (new - ab)
            alpha[lo:lo + bs] = new
    return alpha


def krr_path(dev, card, gk, fk, data):
    """The bench.py kernel-leg geometry: four fits, predict and matvec,
    each against the same computation on the plain versions."""
    from keystone_tpu_torch.models import kernel_ridge as KR
    from keystone_tpu_torch.models.kernel_matrix import BlockKernelMatrix

    n, d, k, bs, ep = KRR_N, KRR_D, KRR_K, KRR_BLOCK, KRR_EPOCHS
    nb = n // bs
    xd, yd, xtd = data
    gens = {
        "gaussian": KR.GaussianKernelGenerator(KRR_GAMMA),
        "polynomial": KR.PolynomialKernelGenerator(2, 1.0 / d, 1.0),
        "linear": KR.LinearKernelGenerator(),
    }
    kern64 = {"polynomial": lambda a, b: poly_f64(a, b, 1.0 / d, 1.0, 2),
              "linear": lambda a, b: poly_f64(a, b, 1.0, 0.0, 1)}
    flops = kernel_flops(n, d, k, bs, ep)
    fits, models = {}, {}
    for label, gen, cached, kname, want in (
        ("in-core gaussian", "gaussian", False, "gram_block", ep * nb),
        ("cached gaussian", "gaussian", True, "gram_block", nb),
        ("cached polynomial", "polynomial", True, "poly_block", nb),
        ("cached linear", "linear", True, "poly_block", nb),
    ):
        with phase(f"main path: KRR fit, {label}"):
            kw = dict(lam=KRR_LAM, block_size=bs, num_epochs=ep, cache_kernel_blocks=cached)
            est = KR.KernelRidgeRegressionEstimator(gens[gen], **kw)
            est.fit_arrays(xd, yd, device=dev)  # warm-up, not counted
            torch.cuda.synchronize()
            reset_all(gk, fk)
            t0 = time.perf_counter()
            model = est.fit_arrays(xd, yd, device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(gk.LAUNCHES)
            print(f"  launches {launches}; fit {dt:.4f} s, sweep {flops / dt / 1e12:.3f} TFLOP/s ({card})",
                  flush=True)
            other = "poly_block" if kname == "gram_block" else "gram_block"
            check(launches[kname] == want and launches[other] == 0,
                  f"{label}: launches {launches}, expected {want} {kname}")
            ref = KR.KernelRidgeRegressionEstimator(gens[gen], use_kernel=False, **kw).fit_arrays(
                xd, yd, device=dev)
            check(bool(torch.isfinite(model.alpha).all()), f"{label}: non-finite α")
            fits[label] = {"seconds": dt, "tflops": flops / dt / 1e12, "launches": launches[kname]}
            if gen == "gaussian":
                err = compare(f"α, {label}, vs the plain fit", model.alpha, ref.alpha, TOL_ALPHA, RTOL_ALPHA)
            else:  # see TOL_ALPHA
                err, ratio = within(f"α, {label}, vs the plain fit", model.alpha, ref.alpha, TOL_ALPHA,
                                    RTOL_ALPHA)
                a64 = krr_alpha_f64(kern64[gen], xd, yd)
                e_kernel, e_plain = max_err64(model.alpha, a64), max_err64(ref.alpha, a64)
                held = ratio > 1.0
                print(f"  α against a float64 fit: kernel fit {e_kernel:.3e}, plain f32 fit {e_plain:.3e} "
                      f"(ratio {e_kernel / e_plain:.3f}, at most {F64_RATIO}"
                      f"{', held: the plain-fit tolerance is left' if held else ', not needed'})", flush=True)
                if held:
                    check(e_kernel <= F64_RATIO * e_plain, f"{label}: α further from float64 than the plain fit's")
                fits[label]["alpha_f64"] = {"kernel": e_kernel, "plain_f32": e_plain, "held": held}
            fits[label]["alpha_max_abs_err"] = err
            models[label] = (model, ref)
    with phase("main path: KRR in-core vs cached"):
        compare("α in-core vs cached, both on the kernel", models["in-core gaussian"][0].alpha,
                models["cached gaussian"][0].alpha, TOL_ALPHA, RTOL_ALPHA)
    with phase("main path: KRR predict"):
        model, ref = models["in-core gaussian"]
        model(xtd)  # warm-up, not counted
        torch.cuda.synchronize()
        reset_all(gk, fk)
        t0 = time.perf_counter()
        p = model(xtd)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(gk.LAUNCHES)
        check(launches == {"gram_block": nb, "poly_block": 0}, f"predict launches {launches}")
        pp = ref(xtd)
        check(tuple(p.shape) == (KRR_TEST, k) and bool(torch.isfinite(p).all()), "predictions")
        r2 = 1.0 - float(((p - pp) ** 2).sum() / ((pp - pp.mean(dim=0)) ** 2).sum())
        print(f"  launches {launches}; {dt * 1e3:.3f} ms for {KRR_TEST} rows; r² vs the plain "
              f"model {r2:.8f}; max_abs_err {max_err(p, pp):.3e} ({card})", flush=True)
        check(r2 >= PRED_R2, f"prediction r² {r2}")
        fits["predict"] = {"seconds": dt, "launches": launches["gram_block"], "r2": r2}
    with phase("main path: BlockKernelMatrix.matvec"):
        v = models["in-core gaussian"][0].alpha
        for gen, kname in (("gaussian", "gram_block"), ("polynomial", "poly_block"), ("linear", "poly_block")):
            km = BlockKernelMatrix(gens[gen], xd, bs, cache_blocks=nb * nb)
            reset_all(gk, fk)
            got = km.matvec(v)
            torch.cuda.synchronize()
            launches = dict(gk.LAUNCHES)
            check(launches[kname] == nb and sum(launches.values()) == nb, f"matvec launches {launches}")
            want = BlockKernelMatrix(gens[gen], xd, bs, cache_blocks=nb * nb, use_kernel=False).matvec(v)
            # sums of 8192 kernel-weighted α in another order: relative to the largest entry
            scale = want.abs().max().item()
            compare(f"matvec, {gen}", got, want, 1e-5 * scale, RTOL_POLY)
            fits[f"matvec {gen}"] = {"launches": launches[kname]}
    return fits


def fit_setup(dev, P):
    """The fit leg's Config, training images and labels (the images on the
    card, as set-up) and the held-out set."""
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader

    cfg = fit_setup_config(P)
    size = (IMAGE_HW, IMAGE_HW)
    tx, ty = ImageNetLoader.synthetic_arrays(FIT_N, FIT_CLASSES, size, seed=1)
    vx, vy = ImageNetLoader.synthetic_arrays(FIT_TEST_N, FIT_CLASSES, size, seed=2)
    return cfg, torch.from_numpy(tx).to(dev), ty, torch.from_numpy(vx).to(dev), vy


def held_out_scores(P, scorer, vx):
    return torch.cat([P.scores_of(scorer)(b) for b in vx.split(FIT_BATCH)])


def fit_path(dev, card, P, fk, setup):
    """The fit with the kernels (launch counts zeroed just before, read
    after the held-out scoring), then on the plain versions."""
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator

    cfg, tx, ty, vx, vy = setup
    nb_train, nb_test = -(-FIT_N // FIT_BATCH), -(-FIT_TEST_N // FIT_BATCH)
    out = {}
    with phase("main path: ImageNetSiftLcsFV fit"):
        P.fit_params(cfg, tx, ty, dev, batch_size=FIT_BATCH)  # warm-up, not counted
        torch.cuda.synchronize()
        fk.reset_launches()
        stages = {}
        t0 = time.perf_counter()
        params = P.fit_params(cfg, tx, ty, dev, batch_size=FIT_BATCH, stage_seconds=stages)
        fit_s = time.perf_counter() - t0
        fit_launches = dict(fk.LAUNCHES)
        scorer = P.build_scorer_from_params(params, cfg, dev)
        top = P.predict_top_k(scorer, vx, dev, FIT_BATCH)
        torch.cuda.synchronize()
        launches = dict(fk.LAUNCHES)
        m = MulticlassClassifierEvaluator(FIT_CLASSES).evaluate(top[:, 0], vy)
        top5_err = float(1.0 - (top == vy[:, None]).any(axis=1).mean())
        print(f"  launches: fit {fit_launches}, fit and held-out scoring {launches}", flush=True)
        print("  fit " + ", ".join(f"{k} {v:.4f} s" for k, v in stages.items())
              + f"; total {fit_s:.4f} s, {FIT_N / fit_s:.1f} images/s ({card})", flush=True)
        print(f"  held-out ({FIT_TEST_N} images): top-1 error {m.total_error:.4f}, top-5 error {top5_err:.4f} "
              f"(at most {FIT_TOP1_ERROR_MAX} top-1; chance {1 - 1 / FIT_CLASSES:.4f})", flush=True)
        check(fit_launches == fv_launches(fused=2 * nb_train),
              f"fit launches {fit_launches}, expected B1 twice a training batch")
        check(launches == fv_launches(fused=2 * (nb_train + nb_test)),
              f"launches {launches}, expected B1 twice a batch")
        check(tuple(top.shape) == (FIT_TEST_N, 5), f"top-5 shape {tuple(top.shape)}")
        check(m.total_error <= FIT_TOP1_ERROR_MAX, f"held-out top-1 error {m.total_error:.4f}")
        out.update({"seconds": fit_s, "stage_seconds": stages, "images_per_s": FIT_N / fit_s,
                    "launches": launches["fused_forward"], "top1_error": m.total_error,
                    "top5_error": top5_err})
    with phase("fit: the kernel fit against the plain fit"):
        params_p = P.fit_params(cfg, tx, ty, dev, use_kernel=False, batch_size=FIT_BATCH)
        vocab = [k for k in params if not k.startswith("blm.")]
        worst = max(max_err(params[k], params_p[k]) for k in vocab)
        print(f"  PCA and GMM arrays: largest difference {worst:.3e} (at most {TOL_VOCAB:.0e}); BLM weights "
              f"{max_err(params['blm.weights'], params_p['blm.weights']):.3e}, intercept "
              f"{max_err(params['blm.intercept'], params_p['blm.intercept']):.3e}", flush=True)
        check(worst <= TOL_VOCAB, f"the vocabulary differs by {worst:.3e} between the two fits")
        scorer_p = P.build_scorer_from_params(params_p, cfg, dev, use_kernel=False)
        sk, sp = held_out_scores(P, scorer, vx), held_out_scores(P, scorer_p, vx)
        check(bool(torch.isfinite(sk).all()) and tuple(sk.shape) == (FIT_TEST_N, FIT_CLASSES), "held-out scores")
        out["scores_max_abs_err"] = compare("held-out scores, kernel fit vs plain fit", sk, sp, TOL_FIT_SCORES,
                                            RTOL_FIT_SCORES)
        top_p = P.predict_top_k(scorer_p, vx, dev, FIT_BATCH)
        agree = float((top[:, 0] == top_p[:, 0]).mean())
        print(f"  top-1 agreement {agree:.5f} (at least {FIT_TOP1_AGREEMENT})", flush=True)
        check(agree >= FIT_TOP1_AGREEMENT, f"top-1 agreement {agree:.5f}")
        out["top1_agreement"] = agree
    out["f64"] = fit_f64_checks(dev, card, P, cfg, tx, vx, ty, params)
    return out, params


def fit_f64_checks(dev, card, P, cfg, tx, vx, ty, params):
    """The card's PCA, EM and weighted BCD of the fit, recomputed from
    their inputs (each equal to the fit's own), against the port's same
    functions in float64.  EM and BCD are also run with one-pass TF32
    matrix products, which their limits must catch."""
    from keystone_tpu_torch.models import gmm as G
    from keystone_tpu_torch.models import kmeans as KM
    from keystone_tpu_torch.models import pca as PC
    from keystone_tpu_torch.models.block_weighted_ls import _weighted_bcd_fit, class_weights
    from keystone_tpu_torch.ops.util import ClassLabelIndicators

    out = {"svd_ms": {}}
    with phase("fit: PCA and EM against float64"):
        rows = P.sample_descriptors(cfg, tx, dev, FIT_BATCH)
        for b, (pca_rows, gmm_rows) in rows.items():
            pca = PC.PCAEstimator(PCA_DIMS).fit_arrays(pca_rows, device=dev)
            check(max_err(pca.components, params[f"{b}.pca.components"]) <= TOL_VOCAB,
                  f"{b}: the PCA of the sample is not the fit's")
            xc = pca_rows - pca_rows.mean(dim=0)
            v64 = torch.linalg.svd(xc.double(), full_matrices=False).Vh[:PCA_DIMS].T
            p64 = v64 @ v64.T
            out["svd_ms"][b] = cuda_ms(
                lambda: torch.linalg.svd(xc, full_matrices=False, driver=PC.svd_driver(xc)), reps=3)
            c = pca.components.double()
            err = (c @ c.T - p64).abs().max().item()
            print(f"  {b} PCA {tuple(pca_rows.shape)}: projector against a float64 SVD {err:.3e} (at most "
                  f"{TOL_PROJECTOR:.0e}); SVD (driver {PC.svd_driver(xc)}) {out['svd_ms'][b]:.3f} ms ({card})",
                  flush=True)
            check(err <= TOL_PROJECTOR, f"{b}: PCA projector {err:.3e} from float64")
            out[f"{b}_projector_err"] = err
            z = pca(gmm_rows)
            g = G.GaussianMixtureModelEstimator(cfg.gmm_k, max_iterations=cfg.gmm_iters,
                                                seed=cfg.seed + P.BRANCH_SEED_OFFSET[b])
            m0 = KM._kmeans_fit(z, torch.ones(z.shape[0], device=dev), g.k, g.kmeans_iters,
                                KM.generator(g.seed, dev))
            fit32 = G._gmm_fit(z, z.shape[0], None, g.k, g.max_iterations, g.min_variance, g.seed,
                               g.kmeans_iters, init_means=m0)
            fit64 = G._gmm_fit(z.double(), z.shape[0], None, g.k, g.max_iterations, g.min_variance, g.seed,
                               g.kmeans_iters, init_means=m0.double())
            for name, a, key in zip(("weights", "means", "variances"), fit32, ("w", "mu", "var")):
                check(max_err(a, params[f"{b}.gmm.{name}"]) <= TOL_VOCAB, f"{b}: the EM input is not the fit's")
            with tf32_matmul():
                fit_tf32 = G._gmm_fit(z, z.shape[0], None, g.k, g.max_iterations, g.min_variance, g.seed,
                                      g.kmeans_iters, init_means=m0)
            caught = []
            for name, a, a_t, ref, tol in zip(("w", "mu", "var"), fit32, fit_tf32, fit64,
                                               (TOL_EM_W, TOL_EM_MU, TOL_EM_VAR)):
                e, e_t = max_err64(a, ref), max_err64(a_t, ref)
                print(f"  {b} EM {name}: {e:.3e} from float64 (at most {tol:.0e}; |ref| max "
                      f"{ref.abs().max().item():.3e}); one-pass TF32 {e_t:.3e}", flush=True)
                check(e <= tol, f"{b}: EM {name} {e:.3e} from float64")
                caught.append(e_t > tol)
                out[f"{b}_em_{name}_err"], out[f"{b}_em_{name}_err_tf32"] = e, e_t
            check(any(caught), f"{b}: the EM limits cannot tell TF32 from f32")
        torch.cuda.synchronize()
    with phase("fit: weighted BCD against float64"):
        feats = P.featurize(params, cfg, tx, dev, batch_size=FIT_BATCH)
        test_feats = P.featurize(params, cfg, vx, dev, batch_size=FIT_BATCH)
        y = ClassLabelIndicators(FIT_CLASSES)(torch.from_numpy(ty).to(dev))
        alpha = class_weights(y, FIT_N, cfg.mixture_weight)
        kw = dict(n=FIT_N, lam=cfg.lam, num_iter=cfg.num_epochs, block_size=cfg.solver_block_size,
                  fit_intercept=True)
        w32, xm32, ym32 = _weighted_bcd_fit(feats, y, alpha, **kw)
        check(max_err(w32, params["blm.weights"]) <= TOL_VOCAB, "the solve's input is not the fit's")
        w64, xm64, ym64 = _weighted_bcd_fit(feats.double(), y.double(), alpha.double(), **kw)
        e_w = max_err64(w32, w64)
        scale = w64.abs().max().item()

        def predict(w, xm, ym):
            return (test_feats.to(w.dtype) - xm) @ w.reshape(-1, FIT_CLASSES) + ym

        p64 = predict(w64, xm64, ym64)
        e_p = max_err64(predict(w32, xm32, ym32), p64)
        print(f"  weights {e_w:.3e} from float64 (at most {RTOL_BCD_W:.0e}·{scale:.3e}); held-out predictions "
              f"{e_p:.3e} (at most {TOL_BCD_PRED:.0e}; |ref| max {p64.abs().max().item():.3e})", flush=True)
        with tf32_matmul():
            wt_, xmt, ymt = _weighted_bcd_fit(feats, y, alpha, **kw)
        e_wt, e_pt = max_err64(wt_, w64), max_err64(predict(wt_, xmt, ymt), p64)
        print(f"  one-pass TF32: weights {e_wt:.3e}, held-out predictions {e_pt:.3e}", flush=True)
        check(e_w <= RTOL_BCD_W * scale, f"BCD weights {e_w:.3e} from float64")
        check(e_p <= TOL_BCD_PRED, f"BCD held-out predictions {e_p:.3e} from float64")
        check(e_wt > RTOL_BCD_W * scale or e_pt > TOL_BCD_PRED, "the BCD limits cannot tell TF32 from f32")
        out.update({"bcd_weights_err": e_w, "bcd_weights_max": scale, "bcd_predictions_err": e_p,
                    "bcd_weights_err_tf32": e_wt, "bcd_predictions_err_tf32": e_pt})
        torch.cuda.synchronize()
    return out


def materialize_sample() -> int:
    """The rows of the profiled materialization pass's sample."""
    from keystone_tpu_torch.workflow.optimizer import ProfiledMaterializeRule

    return ProfiledMaterializeRule.sample_size


@contextlib.contextmanager
def fit_probe(fk):
    """Instruments ImageNetSiftLcsFV.run for the graph phases: the seconds
    of ``Pipeline.fit`` (ended by a synchronize), its peak device memory
    (the peak reset just before it), the pre-flight's predicted resident
    bytes and the FV launches at its end, and the rows each descriptor
    extractor was applied to inside the fit's walk, inside the profiled
    materialization passes' samples (``profile``, the fit's and the
    scoring's) and in scoring.  The profiled pass's pricing runs the
    extractors on fake tensors, which read no rows and are not counted.
    The methods are restored on exit."""
    from torch._subclasses.fake_tensor import FakeTensor

    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.ops.lcs import LCSExtractor
    from keystone_tpu_torch.ops.sift import SIFTExtractor
    from keystone_tpu_torch.workflow import profiling
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    probe = {"in_fit": False, "in_profile": False, "rows": {"fit": {}, "profile": {}, "scoring": {}}}
    saved = [(Pipeline, "fit", Pipeline.fit), (profiling, "profile_graph", profiling.profile_graph),
             (SIFTExtractor, "apply_batch", SIFTExtractor.apply_batch),
             (LCSExtractor, "apply_batch", LCSExtractor.apply_batch)]

    def fit(self):
        probe["in_fit"] = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fitted = saved[0][2](self)
        torch.cuda.synchronize()
        probe["fit_seconds"] = time.perf_counter() - t0
        probe["peak_bytes"] = torch.cuda.max_memory_allocated()
        probe["predicted_bytes"] = metrics.REGISTRY.gauge_value("pipeline.preflight_predicted_bytes")
        probe["fit_launches"] = dict(fk.LAUNCHES)
        probe["in_fit"] = False
        return fitted

    def profile_graph(*a, **kw):
        probe["in_profile"] = True
        try:
            return saved[1][2](*a, **kw)
        finally:
            probe["in_profile"] = False

    def counted(name, orig):
        def apply_batch(self, xs, mask=None):
            if not isinstance(xs, FakeTensor):
                key = "profile" if probe["in_profile"] else "fit" if probe["in_fit"] else "scoring"
                probe["rows"][key][name] = probe["rows"][key].get(name, 0) + xs.shape[0]
            return orig(self, xs, mask)
        return apply_batch

    Pipeline.fit, profiling.profile_graph = fit, profile_graph
    for cls, name, orig in saved[2:]:
        setattr(cls, name, counted(cls.__name__, orig))
    try:
        yield probe
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


def fitted_vocabulary(fitted):
    """{branch: (PCATransformer, FisherVector)} of a graph-fitted pipeline
    (branch by the descriptor width the PCA takes)."""
    from keystone_tpu_torch.models.pca import PCATransformer
    from keystone_tpu_torch.ops.fisher import FisherVector

    g, out = fitted.graph, {}
    for n, op in g.operators.items():
        fv = getattr(op, "transformer", None)
        if isinstance(fv, FisherVector):
            pca = g.operators[g.dependencies[n][0]].transformer
            check(isinstance(pca, PCATransformer), f"the FV node's input is {pca.label}")
            out["sift" if pca.components.shape[0] == 128 else "lcs"] = (pca, fv)
    check(sorted(out) == ["lcs", "sift"], f"fitted branches {sorted(out)}")
    return out


def vocabulary_diff(label, fitted, reference):
    """Two graph fits' vocabularies (PCA projector and mean, GMM) against
    each other: the largest differences by branch, held at the streamed
    fit's limits (the same rows sampled, their extractors' products
    rounded over other batch shapes), and whether they are bit for bit."""
    va, vb = fitted_vocabulary(fitted), fitted_vocabulary(reference)
    vocab, bitwise = {}, True
    for b in ("sift", "lcs"):
        (pa, fa), (pb, fb) = va[b], vb[b]
        pairs = {"projector": (pa.components @ pa.components.T, pb.components @ pb.components.T),
                 "pca_mean": (pa.mean, pb.mean)}
        pairs.update({a: (getattr(fa.gmm, a), getattr(fb.gmm, a)) for a in ("weights", "means", "variances")})
        vocab[b] = {k: max_err(a, c) for k, (a, c) in pairs.items()}
        bitwise = bitwise and torch.equal(pa.components, pb.components) and all(
            torch.equal(a, c) for k, (a, c) in pairs.items() if k != "projector")
    print(f"  {label}: vocabularies, largest differences {vocab}; bit for bit: {bitwise}", flush=True)
    for b, d in vocab.items():
        for k, tol in (("projector", TOL_STREAM_PROJECTOR), ("pca_mean", TOL_VOCAB), ("weights", TOL_EM_W),
                       ("means", TOL_EM_MU), ("variances", TOL_EM_VAR)):
            check(d[k] <= tol, f"{label}, {b}: the {k} is {d[k]:.3e} from the reference fit's (at most {tol})")
    return vocab, bitwise


def graph_path(dev, card, P, fk, setup, params):
    """ImageNetSiftLcsFV.run through the workflow graph at the fit leg: the
    timed run (launch counts zeroed just before, read after its scoring),
    the graph-fitted scorer against fit_params' (``params``), a model_path
    round trip, and B2 at the graph fit's shape."""
    from keystone_tpu_torch.ops.fisher import FusedPcaFisherVector
    from keystone_tpu_torch.ops.images import GrayScaler, PixelScaler
    from keystone_tpu_torch.ops.lcs import LCSExtractor
    from keystone_tpu_torch.ops.sift import SIFTExtractor
    from keystone_tpu_torch.workflow import transformer as WT
    from keystone_tpu_torch.workflow.dataset import Dataset
    from keystone_tpu_torch.workflow.pipeline import PipelineEnv

    cfg, tx, ty, vx, vy = setup
    G = P.ImageNetSiftLcsFV
    # the graph applies its transformers to a dataset in row chunks
    chunk = WT.APPLY_CHUNK_ROWS
    nb_train, nb_test = -(-FIT_N // chunk), -(-FIT_TEST_N // chunk)
    out = {}
    with phase("main path: ImageNetSiftLcsFV.run through the workflow graph"):
        G.run(dataclasses.replace(cfg, synthetic_n=GRAPH_WARMUP_N), dev)  # warm-up, not counted
        torch.cuda.synchronize()
        fk.reset_launches()
        detail = {}
        with fit_probe(fk) as probe:
            res = G.run(cfg, dev, out=detail)
            torch.cuda.synchronize()
        launches = dict(fk.LAUNCHES)
        fit_l = probe["fit_launches"]
        score_l = {k: launches[k] - fit_l[k] for k in launches}
        rows = probe["rows"]
        print(f"  launches: fit {fit_l}, scoring {score_l}; extractor rows {rows}", flush=True)
        print(f"  Pipeline.fit {probe['fit_seconds']:.4f} s, {FIT_N / probe['fit_seconds']:.1f} images/s; run's "
              f"fit_seconds (the training images' making included, as the reference's) {res['fit_seconds']:.4f} s; "
              f"peak device memory in the fit {probe['peak_bytes'] / 2**30:.4f} GiB ({card})", flush=True)
        print(f"  held-out ({FIT_TEST_N} images): top-1 error {res['top1_error']:.4f}, top-5 error "
              f"{res['top5_error']:.4f} (at most {FIT_TOP1_ERROR_MAX} top-1; chance {1 - 1 / FIT_CLASSES:.4f})",
              flush=True)
        check(fit_l == fv_launches(encode=2 * nb_train), f"fit launches {fit_l}, expected B2 twice a chunk")
        check(score_l == fv_launches(fused=2 * nb_test), f"scoring launches {score_l}, expected B1 twice a chunk")
        once = {"SIFTExtractor": FIT_N, "LCSExtractor": FIT_N}
        check(rows["fit"] == once, f"the fit's extractor rows {rows['fit']}, expected each once over the set")
        check(rows["profile"] == {k: materialize_sample() for k in once},
              f"the profiled pass's extractor rows {rows['profile']}, expected each once over its sample")
        check(rows["scoring"] == {k: FIT_TEST_N for k in once}, f"scoring's extractor rows {rows['scoring']}")
        print(f"  the pre-flight's predicted resident bytes (source + shared) {probe['predicted_bytes'] / 2**30:.4f} "
              f"GiB against the fit's peak {probe['peak_bytes'] / 2**30:.4f} GiB: peak / predicted "
              f"{probe['peak_bytes'] / probe['predicted_bytes']:.3f} ({card})", flush=True)
        check(not res["model_loaded"], "the timed run loaded a model")
        check(res["top1_error"] <= FIT_TOP1_ERROR_MAX, f"held-out top-1 error {res['top1_error']:.4f}")
        pred = detail["predictions"]
        check(pred.shape == (FIT_TEST_N, 5), f"top-5 shape {pred.shape}")
        g = PipelineEnv.get_optimizer().execute(detail["fitted"](Dataset(vx)).graph)
        fused = [op.transformer for op in g.operators.values()
                 if isinstance(getattr(op, "transformer", None), FusedPcaFisherVector)]
        print(f"  optimized scoring graph: {[f.label for f in fused]}", flush=True)
        check(sorted(f.sift_normalize for f in fused) == [False, True],
              "the scoring graph lacks its two fused FV nodes (SIFT with its normalize, LCS)")
        top_p = P.predict_top_k(P.build_scorer_from_params(params, cfg, dev), vx, dev, FIT_BATCH)
        agree = float((pred[:, 0] == top_p[:, 0]).mean())
        print(f"  top-1 agreement with fit_params' scorer {agree:.5f} (at least {GRAPH_TOP1_AGREEMENT})", flush=True)
        check(agree >= GRAPH_TOP1_AGREEMENT, f"top-1 agreement {agree:.5f}")
        out.update({"fit_seconds": probe["fit_seconds"], "run_fit_seconds": res["fit_seconds"],
                    "peak_bytes": probe["peak_bytes"], "predicted_bytes": probe["predicted_bytes"],
                    "images_per_s": FIT_N / probe["fit_seconds"], "top1_error": res["top1_error"],
                    "top5_error": res["top5_error"], "launches_fit": fit_l, "launches_scoring": score_l,
                    "extractor_rows": rows, "top1_agreement": agree})
    with phase("graph: the graph-fitted scorer against fit_params' scorer"):
        labels = Dataset(torch.from_numpy(ty).to(dev))
        scorer_g = G.build_scorer(cfg, Dataset(tx), labels).fit()
        sg = scorer_g(Dataset(vx)).get().array
        sp = held_out_scores(P, P.build_scorer_from_params(params, cfg, dev), vx)
        check(tuple(sg.shape) == (FIT_TEST_N, FIT_CLASSES), f"scores shape {tuple(sg.shape)}")
        out["scores_max_abs_err"] = compare("held-out scores, graph fit vs fit_params", sg, sp, TOL_GRAPH_SCORES,
                                            RTOL_GRAPH_SCORES)
        vocab = {}
        for b, (pca, fv) in fitted_vocabulary(scorer_g).items():
            c, cp = pca.components, params[f"{b}.pca.components"]
            vocab[b] = {"projector": max_err(c @ c.T, cp @ cp.T),
                        "gmm": max(max_err(getattr(fv.gmm, a), params[f"{b}.gmm.{a}"])
                                   for a in ("weights", "means", "variances"))}
        print(f"  vocabulary against fit_params' (largest differences): {vocab}", flush=True)
        out["vocabulary_vs_fit_params"] = vocab
    with phase("graph: model_path save and load"):
        tmp = Path(tempfile.mkdtemp(prefix="graph_model_", dir=Path(__file__).resolve().parent))
        try:
            path = str(tmp / "imagenet_sift_lcs_fv.pt")
            saved, loaded = {}, {}
            r1 = G.run(dataclasses.replace(cfg, model_path=path), dev, out=saved)
            r2 = G.run(dataclasses.replace(cfg, model_path=path), dev, out=loaded)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        same = bool(np.array_equal(saved["predictions"], loaded["predictions"]))
        print(f"  fitted and saved: loaded={r1['model_loaded']}, top-1 error {r1['top1_error']:.4f}; loaded: "
              f"loaded={r2['model_loaded']}, top-1 error {r2['top1_error']:.4f}, {r2['fit_seconds']:.4f} s; "
              f"top-5 ids identical: {same}", flush=True)
        check(not r1["model_loaded"] and r2["model_loaded"], "the round trip did not save, then load")
        check(same, "the loaded model's top-5 ids differ from the saved one's")
        out["round_trip"] = {"identical_top_k": same, "load_seconds": r2["fit_seconds"]}
    out["b2_fit_shape"] = b2_fitted_check("graph: B2 at the graph fit's shape against its plain version",
                                          "the graph fit's shape", fk, cfg, tx[:chunk], detail["fitted"])
    return out, detail


def fv_shape_check(label, kern, plain, exact, args, tol):
    """A FV kernel on a fitted GMM at a path's shape: against the plain
    chain in float64 (a fitted GMM leaves small variances, so the log
    posterior and Φ² cancel terms of μ²/σ² ≫ 1, and two f32 chains
    summing in other orders differ beyond the scorer's tolerance),
    f32-grade (error ≤ F64_RATIO × the plain f32 chain's) where f32
    itself leaves the tolerance, which one-pass TF32 must fail.  Returns
    (the largest difference from the plain f32 chain, the f64 record)."""
    got, p = kern(*args), plain(*args)
    ref = exact(*args)
    e_plain_f32 = max_err(got, p)
    err, ratio = within(f"{label} vs the plain chain in float64", got, ref, tol)
    e_p = max_err64(p, ref)
    with tf32_matmul():
        e_t = max_err64(plain(*args), ref)
    print(f"  largest error against float64: kernel {err:.3e}, plain f32 chain {e_p:.3e} (ratio {err / e_p:.3f}, at "
          f"most {F64_RATIO}{' where the tolerance is left' if ratio > 1 else ''}); one-pass TF32 {e_t:.3e} (ratio "
          f"{e_t / e_p:.1f}, must exceed {F64_RATIO}); kernel against the plain f32 chain {e_plain_f32:.3e}",
          flush=True)
    if ratio > 1.0:
        check(err <= F64_RATIO * e_p, f"{label}: not f32-grade against float64")
    check(e_t > F64_RATIO * e_p, f"{label}: the check cannot tell TF32 from f32")
    return e_plain_f32, {"kernel": err, "plain_f32": e_p, "tf32": e_t}


def b2_fitted_check(phase_name, where, fk, cfg, images, fitted):
    """B2 on a fitted GMM at a fit's shape: ``images`` (one chunk or batch
    of the training set), normalized SIFT and LCS projected by the fitted
    PCA.  As B1's fit-shape check: against the plain chain in float64,
    f32-grade where f32 itself misses the tolerance."""
    from keystone_tpu_torch.ops.images import GrayScaler, PixelScaler
    from keystone_tpu_torch.ops.lcs import LCSExtractor
    from keystone_tpu_torch.ops.sift import SIFTExtractor

    b2 = {"f64_check": {}, "max_abs_err": 0.0, "calls": []}
    with phase(phase_name):
        xf = PixelScaler(only_if_integer=True)(images)
        extract = {"sift": lambda: SIFTExtractor(cfg.sift_step, (cfg.sift_bin_size,))(GrayScaler()(xf)),
                   "lcs": lambda: LCSExtractor(cfg.lcs_step, cfg.lcs_subpatch)(xf)}
        for b, (pca, fv) in fitted_vocabulary(fitted).items():
            z, zm = pca(*extract[b]())
            gm = fv.gmm
            a = (z, zm, gm.weights, gm.means, gm.variances)
            n, t, d = z.shape
            e, f64 = fv_shape_check(f"B2 at {where}, {b} ({n}, {t}, {d}), K={FIT_GMM_K}", fk.fisher_encode,
                                    fk.fisher_encode_ref, fv_f64, a, TOL_FV)
            b2["max_abs_err"] = max(b2["max_abs_err"], e)
            b2["f64_check"][f"{b} ({n}, {t}, {d}) K={FIT_GMM_K}"] = f64
            b2["calls"].append((a, (n, t)))
        torch.cuda.synchronize()
    return b2


def split_at(fitted, cls):
    """(a fitted pipeline that computes the input of the ``cls`` stage of
    the sink's node, that stage): with the prediction head, the raw class
    scores; with the model, its features (the stage may be fused into a
    chain there)."""
    from keystone_tpu_torch.workflow import graph as WG
    from keystone_tpu_torch.workflow.optimizer import FusedTransformer
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    g = fitted.graph
    node = g.sink_dependencies[fitted.sink]
    t = g.operators[node].transformer
    stages = list(getattr(t, "stages", [t]))
    at = [j for j, st in enumerate(stages) if isinstance(st, cls)]
    check(len(at) == 1, f"the fitted pipeline's last node is {t.label}, with no one {cls.__name__}")
    if at[0] == 0:
        g = g.replace_dependency(node, g.dependencies[node][0]).remove_node(node)
    else:
        g = g.set_operator(node, WG.TransformerOperator(FusedTransformer(stages[:at[0]])))
    return FittedPipeline(g, fitted.source, fitted.sink), stages[at[0]]


def scores_pipeline(fitted):
    """A fitted pipeline that ends in TopKClassifier, without it: the raw
    class scores."""
    from keystone_tpu_torch.ops.util import TopKClassifier

    return split_at(fitted, TopKClassifier)[0]


class LogWatch(logging.Handler):
    """Collects the warnings whose message holds ``needle``."""

    def __init__(self, needle):
        super().__init__(logging.WARNING)
        self.needle, self.messages = needle, []

    def emit(self, record):
        if self.needle in record.getMessage():
            self.messages.append(record.getMessage())


@contextlib.contextmanager
def watching(logger_name, needle):
    watch = LogWatch(needle)
    logging.getLogger(logger_name).addHandler(watch)
    try:
        yield watch.messages
    finally:
        logging.getLogger(logger_name).removeHandler(watch)


def stream_path(dev, card, P, fk, setup, graph_out, graph_detail):
    """ImageNetSiftLcsFV.run with stream=True at the fit leg (launch counts
    zeroed just before, read after its scoring), against phase 9's
    in-memory graph fit; then the device block feed against read_block."""
    from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator as BWLS
    from keystone_tpu_torch.workflow import transformer as WT
    from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore
    from keystone_tpu_torch.workflow.dataset import Dataset

    cfg, tx, ty, vx, vy = setup
    scfg = dataclasses.replace(cfg, stream=True, stream_batch_size=STREAM_BATCH)
    nb_train, nb_test = -(-FIT_N // STREAM_BATCH), -(-FIT_TEST_N // WT.APPLY_CHUNK_ROWS)
    feat_d = 2 * 2 * FIT_GMM_K * PCA_DIMS
    out = {}
    with phase("main path: ImageNetSiftLcsFV.run --stream (the out-of-core fit)"):
        # the spill (the solver's sweep of the stream, its features written
        # to disk) and the out-of-core solve (three reads of the store and
        # the BCD) timed apart; the rest of the fit is the samplers' sweeps
        # and the vocabulary fits
        spills, solve_s = [], []
        orig, orig_solve = FeatureBlockStore.from_batches.__func__, BWLS.fit_store

        def spy(cls, directory, batches, n, block_size, dtype="float32"):
            t0 = time.perf_counter()
            store = orig(cls, directory, batches, n, block_size, dtype)
            spills.append({"rows": store.n, "columns": store.d, "blocks": store.num_blocks,
                           "bytes": store.nbytes(), "dtype": store.dtype, "seconds": time.perf_counter() - t0})
            return store

        def timed_solve(self, *a, **kw):
            t0 = time.perf_counter()
            fitted = orig_solve(self, *a, **kw)
            torch.cuda.synchronize()
            solve_s.append(time.perf_counter() - t0)
            return fitted

        watch = LogWatch("materializing StreamDataset")
        logging.getLogger("keystone_tpu_torch.workflow.dataset").addHandler(watch)
        FeatureBlockStore.from_batches, BWLS.fit_store = classmethod(spy), timed_solve
        torch.cuda.synchronize()
        fk.reset_launches()
        detail = {}
        try:
            with fit_probe(fk) as probe:
                res = P.ImageNetSiftLcsFV.run(scfg, dev, out=detail)
                torch.cuda.synchronize()
        finally:
            FeatureBlockStore.from_batches, BWLS.fit_store = classmethod(orig), orig_solve
            logging.getLogger("keystone_tpu_torch.workflow.dataset").removeHandler(watch)
        launches = dict(fk.LAUNCHES)
        fit_l = probe["fit_launches"]
        score_l = {k: launches[k] - fit_l[k] for k in launches}
        rows = probe["rows"]
        peak, peak_mem = probe["peak_bytes"], graph_out["peak_bytes"]
        print(f"  spill {spills}; out-of-core solve {solve_s} s; making the {FIT_N} training images once took "
              f"{graph_out['run_fit_seconds'] - graph_out['fit_seconds']:.4f} s in phase 9's run ({card})", flush=True)
        print(f"  launches: fit {fit_l}, scoring {score_l}; extractor rows {rows} (predicted {STREAM_SWEEPS} sweeps "
              f"of {FIT_N} in the fit)", flush=True)
        print(f"  Pipeline.fit {probe['fit_seconds']:.4f} s streamed, {graph_out['fit_seconds']:.4f} s in memory "
              f"(phase 9); peak device memory in the fit {peak / 2**30:.4f} GiB streamed, {peak_mem / 2**30:.4f} GiB "
              f"in memory ({card})", flush=True)
        print(f"  held-out ({FIT_TEST_N} images): top-1 error {res['top1_error']:.4f}, top-5 error "
              f"{res['top5_error']:.4f} (at most {FIT_TOP1_ERROR_MAX} top-1)", flush=True)
        spill_s = [sp.pop("seconds") for sp in spills]
        check(spills == [{"rows": FIT_N, "columns": feat_d, "blocks": -(-feat_d // FIT_BLOCK),
                          "bytes": FIT_N * feat_d * 4, "dtype": "float32"}], f"spill {spills}")
        check(len(solve_s) == 1, f"out-of-core solves {solve_s}")
        check(fit_l == fv_launches(encode=2 * nb_train), f"fit launches {fit_l}, expected B2 twice a streamed batch")
        check(score_l == fv_launches(fused=2 * nb_test), f"scoring launches {score_l}, expected B1 twice a chunk")
        swept = {"SIFTExtractor": STREAM_SWEEPS * FIT_N, "LCSExtractor": STREAM_SWEEPS * FIT_N}
        check(rows["fit"] == swept, f"the fit's extractor rows {rows['fit']}, predicted {swept}")
        check(rows["profile"] == {k: materialize_sample() for k in swept},
              f"the profiled pass's extractor rows {rows['profile']}, expected each over the stream's head")
        check(rows["scoring"] == {k: FIT_TEST_N for k in swept}, f"scoring's extractor rows {rows['scoring']}")
        check(not watch.messages, f"a stage materialized the stream: {watch.messages}")
        check(not res["model_loaded"], "the streamed run loaded a model")
        check(res["top1_error"] <= FIT_TOP1_ERROR_MAX, f"held-out top-1 error {res['top1_error']:.4f}")
        check(peak < peak_mem, f"streamed peak {peak} bytes is not below the in-memory fit's {peak_mem}")
        out.update({"fit_seconds": probe["fit_seconds"], "run_fit_seconds": res["fit_seconds"],
                    "in_memory_fit_seconds": graph_out["fit_seconds"], "peak_bytes": peak,
                    "in_memory_peak_bytes": peak_mem, "spill": spills[0], "spill_seconds": spill_s[0],
                    "solve_seconds": solve_s[0], "launches_fit": fit_l,
                    "launches_scoring": score_l, "extractor_rows": rows, "top1_error": res["top1_error"],
                    "top5_error": res["top5_error"]})
    with phase("stream: the streamed fit against the in-memory graph fit"):
        vocab, bitwise = vocabulary_diff("the streamed fit", detail["fitted"], graph_detail["fitted"])
        ss = scores_pipeline(detail["fitted"])(Dataset(vx)).get().array
        sm = scores_pipeline(graph_detail["fitted"])(Dataset(vx)).get().array
        check(tuple(ss.shape) == (FIT_TEST_N, FIT_CLASSES) and bool(torch.isfinite(ss).all()), "held-out scores")
        out["scores_max_abs_err"] = compare("held-out scores, streamed fit vs in-memory fit", ss, sm,
                                            TOL_STREAM_SCORES, RTOL_STREAM_SCORES)
        agree = float((detail["predictions"][:, 0] == graph_detail["predictions"][:, 0]).mean())
        print(f"  top-1 agreement {agree:.5f} (at least {STREAM_TOP1_AGREEMENT})", flush=True)
        check(agree >= STREAM_TOP1_AGREEMENT, f"top-1 agreement {agree:.5f}")
        out.update({"vocabulary_max_abs_err": vocab, "vocabulary_bitwise": bitwise, "top1_agreement": agree})
    # the kernel at the streamed batch's shape (phase 9 holds it at the
    # graph's chunk of 128): one batch of the training stream
    b2s = b2_fitted_check("stream: B2 at the streamed batch's shape against its plain version",
                          "the streamed batch's shape", fk, cfg, tx[:STREAM_BATCH], detail["fitted"])
    out["b2_batch_shape"] = {"f64_check": b2s["f64_check"], "max_abs_err": b2s["max_abs_err"]}
    with phase("stream: iter_device_blocks on the copy stream against read_block"):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(FIT_N, feat_d)).astype(np.float32)
        tmp = Path(tempfile.mkdtemp(prefix="blocks_", dir=REPO))
        feed = {}
        try:
            for dtype in ("float32", "bfloat16"):
                store = FeatureBlockStore.from_array(str(tmp / dtype), x, FIT_BLOCK, dtype=dtype)
                refs = [store.read_block(b).to(dev).to(torch.float32) for b in range(store.num_blocks)]
                order = list(range(store.num_blocks)) * 3
                bad = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b, a in store.iter_device_blocks(order, dev):
                    torch.cuda._sleep(5_000_000)  # a consumer slower than the copies
                    bad.append((a != refs[b]).sum())
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                bad = [int(v) for v in bad]
                print(f"  {dtype}: {len(order)} blocks of ({FIT_N}, {FIT_BLOCK}), mismatched entries {bad}; "
                      f"{dt:.4f} s ({card})", flush=True)
                check(not any(bad), f"{dtype}: iter_device_blocks differs from read_block: {bad}")
                feed[dtype] = {"blocks": len(order), "mismatches": sum(bad), "seconds": dt}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        out["device_feed"] = feed
    return out


def planning_path(dev, card, P, fk, setup):
    """The fit's planning layer at the fit leg: the profiled pass against
    the structural one, every shared node demoted, the auto-spilled fit,
    the refusal on the card's real memory (see the constants above).
    Each fit's launch counts are zeroed just before it and read after its
    held-out scoring."""
    from keystone_tpu_torch.obs import ledger, metrics
    from keystone_tpu_torch.tools.profile_fit import split_fit
    from keystone_tpu_torch.workflow import optimizer as O
    from keystone_tpu_torch.workflow import profiling
    from keystone_tpu_torch.workflow import transformer as WT
    from keystone_tpu_torch.workflow.dataset import Dataset
    from keystone_tpu_torch.workflow.pipeline import PipelineEnv, PreflightOOMError

    cfg, tx, ty, vx, vy = setup
    labels = Dataset(torch.from_numpy(ty).to(dev))
    nb_test = -(-FIT_TEST_N // WT.APPLY_CHUNK_ROWS)
    once = ("SIFTExtractor", "LCSExtractor")

    def build(x=tx, y=labels):
        return P.ImageNetSiftLcsFV.build_scorer(cfg, Dataset(x), y)

    def with_materialize(rule):
        return O.Optimizer([b if b.name != "materialize" else O.RuleBatch("materialize", O.Once(), [rule])
                            for b in O.default_optimizer().batches])

    def timed_fit(label, optimizer=None):
        """build().fit() and its held-out scores: seconds, peak device
        memory, prediction, FV launches (fit, scoring), extractor rows."""
        PipelineEnv.set_optimizer(optimizer)
        try:
            torch.cuda.synchronize()
            fk.reset_launches()
            demoted = metrics.REGISTRY.counter_value("optimizer.no_memoize_demotions")
            with fit_probe(fk) as probe, fit_timer() as ft:
                fitted = build().fit()
                scores = fitted(Dataset(vx)).get().array
                torch.cuda.synchronize()
        finally:
            PipelineEnv.set_optimizer(None)
        fit_l = probe["fit_launches"]
        r = {"fitted": fitted, "scores": scores, "seconds": probe["fit_seconds"], "peak_bytes": probe["peak_bytes"],
             "predicted_bytes": probe["predicted_bytes"], "launches_fit": fit_l,
             "launches_scoring": {k: fk.LAUNCHES[k] - fit_l[k] for k in fk.LAUNCHES}, "rows": probe["rows"],
             "spill_seconds": ft["spill"], "oc_solve_seconds": ft["solve"],
             "demotions": metrics.REGISTRY.counter_value("optimizer.no_memoize_demotions") - demoted}
        print(f"  {label}: Pipeline.fit {r['seconds']:.4f} s, peak device memory {r['peak_bytes'] / 2**30:.4f} GiB, "
              f"predicted (source + shared) {r['predicted_bytes'] / 2**30:.4f} GiB; spill {ft['spill']:.4f} s, "
              f"out-of-core solve {ft['solve']:.4f} s; launches: fit {fit_l}, scoring {r['launches_scoring']}; "
              f"no_memoize demotions {r['demotions']:g}; extractor rows {r['rows']} ({card})", flush=True)
        check(tuple(scores.shape) == (FIT_TEST_N, FIT_CLASSES) and bool(torch.isfinite(scores).all()),
              f"{label}: held-out scores")
        check(r["launches_scoring"] == fv_launches(fused=2 * nb_test),
              f"{label}: scoring launches {r['launches_scoring']}, expected B1 twice a chunk")
        return r

    def same_fit(label, got, want):
        vocab, bitwise = vocabulary_diff(label, got["fitted"], want["fitted"])
        same = bitwise and torch.equal(got["scores"], want["scores"])
        print(f"  {label}: held-out scores {max_err(got['scores'], want['scores']):.3e} apart; vocabularies and "
              f"scores bit for bit: {same}", flush=True)
        return vocab, same

    out = {}
    with phase("fit planning: the profiled materialization pass against the structural pass, in memory"):
        structural = timed_fit("structural pass", with_materialize(O.AutoMaterializeRule()))
        led_dir = Path(tempfile.mkdtemp(prefix="planning_ledger_", dir=REPO))
        try:
            ledger.start_run(str(led_dir))
            try:
                PipelineEnv.get_optimizer().execute(build().graph)
            finally:
                ledger.stop_run()
            events = [json.loads(line) for f in led_dir.glob("run_*.jsonl") for line in f.read_text().splitlines()]
        finally:
            shutil.rmtree(led_dir, ignore_errors=True)
        placement = [e["attrs"] for e in events if e["kind"] == "event" and e["name"] == "optimizer.cache_placement"]
        print(f"  optimizer.cache_placement {placement}; the card's memory {torch.cuda.mem_get_info(dev)[1]} bytes "
              f"({card})", flush=True)
        check(len(placement) == 1, f"cache placement events {placement}: the profiled pass did not run")
        check(placement[0]["budget_bytes"] == profiling.device_hbm_budget(device=dev),
              f"the budget {placement[0]['budget_bytes']} is not half the card's memory")
        check(placement[0]["no_memoize_demotions"] == 0, "the fit leg's shared outputs do not fit half the card")
        profiled = timed_fit("profiled pass (the default)")
        split = split_fit(build())
        print(f"  the fit split by rule batch: {split['batches']}, pre-flight {split['preflight']:.4f} s, the "
              f"walk {split['execute']:.4f} s; Pipeline.fit {profiled['seconds']:.4f} s with the profiled pass, "
              f"{structural['seconds']:.4f} s with the structural pass ({card})", flush=True)
        _, same = same_fit("profiled against structural", profiled, structural)
        check(same, "the profiled pass's fit differs from the structural pass's")
        for r, label in ((profiled, "profiled"), (structural, "structural")):
            check(r["launches_fit"] == fv_launches(encode=2 * -(-FIT_N // WT.APPLY_CHUNK_ROWS)),
                  f"{label}: fit launches {r['launches_fit']}, expected B2 twice a chunk")
        check(profiled["rows"]["fit"] == {k: FIT_N for k in once}, f"extractor rows {profiled['rows']}")
        out["in_memory"] = {"placement": placement[0], "split": split, "seconds": profiled["seconds"],
                            "structural_seconds": structural["seconds"], "peak_bytes": profiled["peak_bytes"],
                            "predicted_bytes": profiled["predicted_bytes"], "bitwise": same}
    with phase("fit planning: every shared node demoted (a budget of 1 byte), recomputed for each consumer"):
        demoted = timed_fit("demoted", with_materialize(profiling.ProfilingAutoCacheRule(
            budget_bytes=1, sample_size=materialize_sample(), static_cost=True)))
        _, same = same_fit("demoted against the default", demoted, profiled)
        check(demoted["demotions"] > 0, "nothing was demoted")
        check(same, "the demoted fit differs from the default fit")
        out["demoted"] = {k: demoted[k] for k in ("seconds", "peak_bytes", "demotions", "rows")}
        out["demoted"]["bitwise"] = same
    with phase("fit planning: the auto-spilled fit (the pre-flight streams the source, B2 over its batches)"):
        with env_var("KEYSTONE_HBM_BUDGET_BYTES", str(SPILL_OVERRIDE)), \
                watching("keystone_tpu_torch.workflow.pipeline", "converted to a stream") as converted, \
                watching("keystone_tpu_torch.workflow.dataset", "materializing StreamDataset") as materialized:
            spilled = timed_fit("auto-spilled")
        print(f"  pre-flight: {converted}", flush=True)
        check(len(converted) == 1, f"the pre-flight converted {len(converted)} sources, expected the images")
        check(not materialized, f"a stage materialized the auto-spill stream: {materialized}")
        check(spilled["spill_seconds"] > 0 and spilled["oc_solve_seconds"] > 0, "the fit did not spill out of core")
        check(spilled["launches_fit"] == fv_launches(encode=2 * -(-FIT_N // SPILL_BATCH)),
              f"fit launches {spilled['launches_fit']}, expected B2 twice a {SPILL_BATCH}-row batch")
        check(spilled["rows"]["fit"] == {k: STREAM_SWEEPS * FIT_N for k in once},
              f"the fit's extractor rows {spilled['rows']['fit']}, predicted {STREAM_SWEEPS} sweeps")
        check(spilled["peak_bytes"] < profiled["peak_bytes"], "the auto-spilled fit's peak is not below in memory")
        vocab, same = same_fit("auto-spilled against in memory", spilled, profiled)
        err = compare("held-out scores, auto-spilled fit vs in-memory fit", spilled["scores"], profiled["scores"],
                      TOL_STREAM_SCORES, RTOL_STREAM_SCORES)
        agree = float((spilled["scores"].argmax(1) == profiled["scores"].argmax(1)).float().mean())
        print(f"  top-1 agreement {agree:.5f} (at least {STREAM_TOP1_AGREEMENT})", flush=True)
        check(agree >= STREAM_TOP1_AGREEMENT, f"top-1 agreement {agree:.5f}")
        out["auto_spill"] = {k: spilled[k] for k in ("seconds", "peak_bytes", "predicted_bytes", "launches_fit",
                                                     "launches_scoring", "spill_seconds", "oc_solve_seconds")}
        out["auto_spill"].update(bitwise=same, vocabulary_max_abs_err=vocab, scores_max_abs_err=err,
                                 top1_agreement=agree)
    with phase("fit planning: the refusal on the card's real memory (KEYSTONE_AUTO_SPILL=0)"):
        gc.collect()
        torch.cuda.empty_cache()
        total = torch.cuda.mem_get_info(dev)[1]
        n_big = int(REFUSAL_FRACTION * total) // (IMAGE_HW * IMAGE_HW * 3) + 1
        big = torch.empty((n_big, IMAGE_HW, IMAGE_HW, 3), dtype=torch.uint8, device=dev)
        big[:FIT_N] = tx  # the samples read the head
        big_labels = Dataset(torch.from_numpy(np.resize(ty, n_big)).to(dev))
        try:
            with env_var("KEYSTONE_AUTO_SPILL", "0"), env_var("KEYSTONE_HBM_BUDGET_BYTES", None), \
                    fit_probe(fk) as probe:
                t0 = time.perf_counter()
                try:
                    build(big, big_labels).fit()
                    refused = None
                except PreflightOOMError as e:
                    refused = str(e)
                dt = time.perf_counter() - t0
        finally:
            del big, big_labels
            gc.collect()
            torch.cuda.empty_cache()
        print(f"  a {n_big} x {IMAGE_HW} x {IMAGE_HW} x 3 uint8 source ({n_big * IMAGE_HW * IMAGE_HW * 3 / 1e9:.2f} "
              f"GB of the card's {total / 1e9:.2f} GB): refused in {dt:.3f} s; extractor rows {probe['rows']}; "
              f"{refused} ({card})", flush=True)
        check(refused is not None, "fit() was not refused")
        check("GB" in refused and "--stream" in refused, f"the refusal's message: {refused}")
        check(not probe["rows"]["fit"] and probe["rows"]["profile"] == {k: materialize_sample() for k in once},
              f"the refused fit featurized more than the profiled pass's sample: {probe['rows']}")
        out["refusal"] = {"source_bytes": n_big * IMAGE_HW * IMAGE_HW * 3, "total_bytes": total, "seconds": dt,
                          "message": refused}
    out["launches"] = {k: sum(r[p][k] for r in (structural, profiled, demoted, spilled)
                              for p in ("launches_fit", "launches_scoring")) for k in fk.LAUNCHES}
    return out


def wrong_decodes(got, ref, limit) -> dict:
    """What a wrong decode would read from ``ref``, made from the same
    output ``got``: channels swapped, chroma dropped, shifted one pixel.
    A decoder's limit must stay below two thirds of each, so that it
    tells a wrong decode from a sound one."""
    good, ref = got.to(torch.int32), ref.to(torch.int32)
    luma = torch.round(good.to(torch.float32) @ torch.tensor([0.299, 0.587, 0.114], device=good.device))
    wrong = {"channels_swapped": int((good.flip(-1) - ref).abs().max()),
             "chroma_dropped": int((luma[..., None].to(torch.int32) - ref).abs().max()),
             "shifted_one_pixel": int((good.roll(1, dims=2) - ref).abs().max())}
    print(f"  a wrong decode would read {wrong} levels (the limit {limit} must stay below two thirds of each)",
          flush=True)
    check(1.5 * limit < min(wrong.values()), f"the limit cannot tell a wrong decode: {wrong}")
    return wrong


def tar_path(dev, card, P):
    """The ImageNet tar loader on the committed fixture, decoded on the card."""
    from keystone_tpu_torch.loaders import jpeg
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader

    out = {}
    with phase("tar loader: the committed fixture through nvJPEG"):
        ref = torch.from_numpy(np.load(TAR_PIXELS)).to(dev)
        entries = ImageNetLoader.index(str(TARS))
        jpeg.reset_launches()
        st = ImageNetLoader.stream(str(TARS), size=TAR_SIZE, batch_size=5, device=dev)
        got = torch.cat([a for a, _ in st.data.device_batches()])
        mem = ImageNetLoader.load(str(TARS), size=TAR_SIZE, device=dev)
        keep = torch.tensor([i for i in range(TAR_MEMBERS) if i != TAR_BAD], device=dev)
        diff = (got.to(torch.int32) - ref.to(torch.int32)).abs()
        print(f"  index {len(entries)} members; stream {st.data.n} ({tuple(got.shape)} on {got.device}), load "
              f"{mem.data.n}; nvJPEG against libjpeg: largest difference {int(diff.max())} levels (at most "
              f"{NVJPEG_MAX_DIFF}), mean {diff.float().mean().item():.4f}; decoder launches {jpeg.LAUNCHES}",
              flush=True)
        check(len(entries) == TAR_MEMBERS and st.data.n == TAR_MEMBERS, "the index's member count")
        check(got.is_cuda and tuple(got.shape) == (TAR_MEMBERS, *TAR_SIZE, 3), f"stream pixels {tuple(got.shape)}")
        check(not bool(got[TAR_BAD].any()), "the undecodable member is not a zero image in the stream")
        check(st.labels.numpy().tolist() == [0] * 4 + [1] * 5 + [2] * 4, "the stream's labels")
        check(mem.data.n == TAR_MEMBERS - 1 and mem.labels.numpy().tolist() == [0] * 4 + [1] * 4 + [2] * 4,
              "load did not skip the undecodable member alone")
        check(torch.equal(mem.data.array, got[keep]), "load and stream decode differently")
        check(int(diff.max()) <= NVJPEG_MAX_DIFF, f"nvJPEG's pixels {int(diff.max())} levels from libjpeg's")
        wrong = wrong_decodes(got[keep], ref[keep], NVJPEG_MAX_DIFF)
        check(jpeg.LAUNCHES["nvjpeg"] > 0 and jpeg.LAUNCHES["libjpeg"] == 0, f"decoders {jpeg.LAUNCHES}")
        cfg = P.Config(num_classes=3, image_size=TAR_SIZE[0], gmm_k=4, pca_dims=16, num_epochs=2,
                       descriptor_samples_per_image=16, solver_block_size=64, stream=True, stream_batch_size=5,
                       train_path=str(TARS), test_path=str(TARS))
        res = P.ImageNetSiftLcsFV.run(cfg, dev)
        print(f"  run from the tars with stream: accuracy {res['accuracy']:.4f} (above {TAR_ACCURACY_MIN}), "
              f"top-5 error {res['top5_error']:.4f}", flush=True)
        check(res["accuracy"] > TAR_ACCURACY_MIN, f"accuracy {res['accuracy']:.4f} from the tars")
        out.update({"members": len(entries), "loaded": mem.data.n, "nvjpeg_max_diff": int(diff.max()),
                    "nvjpeg_mean_diff": diff.float().mean().item(),
                    "nvjpeg_max_diff_limit": NVJPEG_MAX_DIFF, "wrong_decode_max_diff": wrong, "run_accuracy": res["accuracy"]})
    return out


# ---------------------------------------------------------------- the kernel pipelines


def fitted_stages(fitted) -> list:
    """A fitted pipeline's transformers in topological order, fused chains
    expanded into their stages."""
    g = fitted.graph
    ts = [getattr(g.operators.get(n), "transformer", None) for n in g.topological_nodes()]
    return [s for t in ts if t is not None for s in getattr(t, "stages", [t])]


def scores_head(fitted):
    """The fitted pipeline's stages before its MaxClassifier, as one
    transformer: the raw class scores."""
    from keystone_tpu_torch.ops.util import MaxClassifier
    from keystone_tpu_torch.workflow.optimizer import FusedTransformer

    stages = fitted_stages(fitted)
    check(isinstance(stages[-1], MaxClassifier), f"the fitted pipeline ends in {stages[-1].label}")
    return FusedTransformer(stages[:-1])


def nystrom_of(fitted):
    from keystone_tpu_torch.models.nystrom import NystromFeatureMap

    maps = [s for s in fitted_stages(fitted) if isinstance(s, NystromFeatureMap)]
    check(len(maps) == 1, f"{len(maps)} Nyström maps in the fitted pipeline")
    return maps[0]


def counted_run(label, gk, fk, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after, the peak device memory above what was allocated before it,
    and its host-clock seconds; returns (result, gram launches by shape,
    peak bytes, seconds)."""
    torch.cuda.synchronize()
    reset_all(gk, fk)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    shapes = {f"{k[0]} ({k[1]}, {k[2]}, {k[3]})": v for k, v in sorted(gk.LAUNCH_SHAPES.items())}
    check(not any(fk.LAUNCHES.values()), f"{label}: FV kernels launched {fk.LAUNCHES}")
    check(gk.LAUNCHES["gram_block"] > 0, f"{label}: B3 never launched")
    return res, dict(gk.LAUNCHES), shapes, peak, dt


@contextlib.contextmanager
def fit_timer():
    """Times ``Pipeline.fit`` (ended by a synchronize) and, inside it, the
    block solvers' spill to a FeatureBlockStore and their out-of-core solve,
    and reads the fit pre-flight's predicted resident bytes after it; the
    methods are restored on exit."""
    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator as BLS
    from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator as BWLS
    from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    from keystone_tpu_torch.obs import metrics

    t = {"fit": 0.0, "spill": 0.0, "solve": 0.0, "predicted": None}
    fit, spill, solve, wsolve = Pipeline.fit, FeatureBlockStore.from_batches.__func__, BLS.fit_store, BWLS.fit_store

    def timed(key, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            t[key] += time.perf_counter() - t0
            if key == "fit":  # the fit pre-flight's prediction: source + shared bytes
                t["predicted"] = metrics.REGISTRY.gauge_value("pipeline.preflight_predicted_bytes")
            return out
        return wrapper

    Pipeline.fit, BLS.fit_store, BWLS.fit_store = timed("fit", fit), timed("solve", solve), timed("solve", wsolve)
    FeatureBlockStore.from_batches = classmethod(timed("spill", spill))
    try:
        yield t
    finally:
        Pipeline.fit, BLS.fit_store, BWLS.fit_store = fit, solve, wsolve
        FeatureBlockStore.from_batches = classmethod(spill)


def print_prediction(predicted, peak, card) -> None:
    """The fit pre-flight's predicted resident bytes (the sources and the
    profiled pass's shared outputs; a stream source counts nothing)
    beside the measured peak: the card's own reading of how far the
    estimate undercounts, which KEYSTONE_OOC_FRACTION's 0.45 must cover."""
    check(predicted is not None, "no fit pre-flight ran")
    print(f"  the pre-flight's predicted resident bytes (source + shared) {predicted / 2**30:.4f} GiB against the "
          f"peak {peak / 2**30:.4f} GiB: peak / predicted {peak / max(predicted, 1):.3f} ({card})", flush=True)


def chunk_launches(rows, chunk, m, d):
    """Gram launches of ``rows`` rows applied ``chunk`` rows at a time
    against m landmarks of width d, by the key ``counted_run`` prints."""
    out = {}
    for lo in range(0, rows, chunk):
        key = f"gram_block ({min(chunk, rows - lo)}, {m}, {d})"
        out[key] = out.get(key, 0) + 1
    return out


def merged(*dicts) -> dict:
    out = {}
    for dd in dicts:
        for k, v in dd.items():
            out[k] = out.get(k, 0) + v
    return dict(sorted(out.items()))


def whiten_check(label, nys, reg, gamma):
    """A fitted whitening (K_LL + reg·m·I)^{−1/2} against float64 on the
    same landmarks: the kernel fit's error at most F64_RATIO times the
    plain f32 chain's (or below TOL_WHITEN), each printed."""
    from keystone_tpu_torch.models.nystrom import _nystrom_whiten

    lmk = nys.landmarks
    m = lmk.shape[0]
    k64 = gram_f64(lmk, lmk, gamma)
    k64 = 0.5 * (k64 + k64.T) + reg * m * torch.eye(m, dtype=torch.float64, device=lmk.device)
    ev, vec = torch.linalg.eigh(k64)
    w64 = (vec * torch.rsqrt(ev.clamp(min=1e-12))[None, :]) @ vec.T
    plain = _nystrom_whiten(lmk, gamma, reg, use_kernel=False)
    e_kernel, e_plain = max_err64(nys.whiten, w64), max_err64(plain, w64)
    print(f"  {label}: whitening ({m}, {m}) against float64 (|ref| max {w64.abs().max().item():.3e}, K_LL's "
          f"eigenvalues {ev.min().item():.3e}..{ev.max().item():.3e}): kernel fit {e_kernel:.3e}, plain f32 "
          f"chain {e_plain:.3e} (at most {F64_RATIO}x it, or {TOL_WHITEN:.0e})", flush=True)
    check(e_kernel <= max(F64_RATIO * e_plain, TOL_WHITEN), f"{label}: the whitening is not f32-grade")
    return {"kernel": e_kernel, "plain_f32": e_plain}


def b3_operand_checks(gk, gamma, cases):
    """B3 on a path's own operands against its plain version (TOL_GRAM) and
    against float64 (at most F64_RATIO times the plain f32 chain's error),
    each printed with the entry where the two f32 chains differ most;
    ``cases``: (label, x, z).  Returns the errors by label and shape."""
    out = {}
    for label, x, z in cases:
        where = f"{label} {(x.shape[0], z.shape[0], x.shape[1])}"
        got, plain = gk.gram_block_kernel(x, z, gamma), gk.gram_block_ref(x, z, gamma)
        ref = gram_f64(x, z, gamma)
        err, ratio = within(f"B3 {where} vs its plain version", got, plain, TOL_GRAM, 0.0)
        i, j = divmod(int((got - plain).abs().argmax()), got.shape[1])
        e_kernel, e_plain = max_err64(got, ref), max_err64(plain, ref)
        print(f"  B3 {where} against float64: kernel {e_kernel:.3e}, plain f32 chain {e_plain:.3e} (ratio "
              f"{e_kernel / e_plain:.3f}, at most {F64_RATIO}); the chains differ most at ({i}, {j}): kernel "
              f"{got[i, j].item():.9f}, plain {plain[i, j].item():.9f}, float64 {ref[i, j].item():.9f}", flush=True)
        entry = {"max_abs_err": err, "f64_check": {"kernel": e_kernel, "plain_f32": e_plain}}
        if ratio > 1.0:  # see the note under TOL_GRAM
            err64, _ = within(f"B3 {where} vs the plain chain in float64", got, ref, TOL_GRAM, 0.0)
            check(err64 <= TOL_GRAM and e_plain > TOL_GRAM,
                  f"B3 {where} vs its plain version: error above tolerance (worst ratio {ratio:.3f})")
            entry["max_abs_err_vs_f64"] = err64
        check(e_kernel <= F64_RATIO * e_plain, f"B3 {where}: not f32-grade against float64")
        out[where] = entry
    return out


def pipeline_pair(label, card, gk, fk, run, cfg, stream_cfg, n, expected, expected_stream, test_x, tol, rtol):
    """One kernel pipeline's run in memory, then with ``stream``: each with
    its launch counts (held to ``expected``), fit seconds, frames a second
    and peak device memory; then the two held together: the landmarks bit
    for bit, the held-out scores within ``tol`` + ``rtol``·|ref| and their
    classes, the accuracy."""
    out = {}
    fitted = {}
    for mode, c, want in (("in memory", cfg, expected), ("stream", stream_cfg, expected_stream)):
        with phase(f"main path: {label}.run, {mode}"):
            detail = {}
            with fit_timer() as ft:
                res, launches, shapes, peak, dt = counted_run(label, gk, fk, lambda: run(c, out=detail))
            print(f"  Pipeline.fit {ft['fit']:.3f} s ({n / ft['fit']:.1f} training items/s; of it the solver's spill "
                  f"{ft['spill']:.3f} s, its out-of-core solve {ft['solve']:.3f} s); run's fit_seconds (loading or "
                  f"making the training set included, as the reference's) {res['fit_seconds']:.3f} s, the whole run "
                  f"{dt:.3f} s; held-out accuracy {res['accuracy']:.4f}; peak device memory {peak / 2**30:.3f} GiB "
                  f"above the run's start ({card})", flush=True)
            print(f"  B3 launches by shape {shapes}", flush=True)
            print_prediction(ft["predicted"], peak, card)
            check(launches["poly_block"] == 0, f"{mode}: B4 launched {launches}")
            check(shapes == want, f"{mode}: launches by shape {shapes}, expected {want}")
            check(not res["model_loaded"], f"{mode}: loaded a model")
            check(res["accuracy"] >= PIPE_ACCURACY_MIN, f"{mode}: held-out accuracy {res['accuracy']:.4f}")
            fitted[mode] = detail["fitted"]
            out[mode] = {"fit_seconds": ft["fit"], "spill_seconds": ft["spill"], "oc_solve_seconds": ft["solve"],
                         "run_fit_seconds": res["fit_seconds"], "run_seconds": dt, "items_per_s": n / ft["fit"],
                         "accuracy": res["accuracy"], "peak_bytes": peak, "predicted_bytes": ft["predicted"],
                         "launches": launches["gram_block"],
                         "launches_by_shape": shapes, "predictions": detail["predictions"]}
    with phase(f"{label}: the streamed fit against the in-memory fit"):
        a, b = nystrom_of(fitted["in memory"]), nystrom_of(fitted["stream"])
        same_l = bool(torch.equal(a.landmarks, b.landmarks))
        same_w = bool(torch.equal(a.whiten, b.whiten))
        print(f"  landmarks bit for bit: {same_l}; whitening bit for bit: {same_w}", flush=True)
        check(same_l, "the streamed fit drew other landmarks")
        sa = torch.cat([scores_head(fitted["in memory"])(t) for t in test_x.split(KT_BATCH)])
        sb = torch.cat([scores_head(fitted["stream"])(t) for t in test_x.split(KT_BATCH)])
        err = compare("held-out scores, stream vs in memory", sb, sa, tol, rtol)
        pa, pb = out["in memory"].pop("predictions"), out["stream"].pop("predictions")
        agree = float((pa == pb).mean())
        print(f"  predicted classes agree on {agree:.6f} of {len(pa)}; accuracy {out['in memory']['accuracy']:.4f} "
              f"in memory, {out['stream']['accuracy']:.4f} streamed", flush=True)
        check(agree >= PIPE_AGREEMENT, f"predicted classes agree on {agree:.6f}")
        check(bool(torch.isfinite(sa).all()), "non-finite scores")
        out["agreement"] = {"landmarks_equal": same_l, "whitening_equal": same_w, "scores_max_abs_err": err,
                            "classes": agree}
    return out, fitted["in memory"]


def kernel_timit_pipeline_path(dev, card, gk, fk, tmp):
    """KernelTimitPipeline.run at its Config's full width on KT_N synthetic
    frames, in memory and then streamed from an .npy written here."""
    from keystone_tpu_torch.loaders.timit import DIM, TimitFeaturesDataLoader
    from keystone_tpu_torch.ops.stats import StandardScalerModel
    from keystone_tpu_torch.pipelines import kernel_timit as KT
    from keystone_tpu_torch.workflow import transformer as WT

    cfg = KT.Config(synthetic_n=KT_N)
    m, chunk = cfg.num_landmarks, WT.APPLY_CHUNK_ROWS
    with phase("kernel TIMIT pipeline: set-up (a warm-up run, the frames written as .npy)"):
        KT.KernelTimitPipeline.run(dataclasses.replace(cfg, synthetic_n=4 * m), dev)  # warm-up, not counted
        t0 = time.perf_counter()
        paths = {}
        for key, n, seed in (("features", KT_N, 1), ("test_features", KT_TEST_N, 2)):
            x, labels = TimitFeaturesDataLoader.synthetic_arrays(n, cfg.num_classes, seed)
            paths[f"{key}_path"] = str(tmp / f"{key}.npy")
            paths[f"{key.replace('features', 'labels')}_path"] = str(tmp / f"{key}_labels.npy")
            np.save(paths[f"{key}_path"], x)
            np.save(paths[f"{key.replace('features', 'labels')}_path"], labels)
        test_x = torch.from_numpy(x).to(dev)
        print(f"  {KT_N} + {KT_TEST_N} frames of {DIM} written in {time.perf_counter() - t0:.2f} s", flush=True)
    kll = {f"gram_block ({m}, {m}, {DIM})": 1}
    test_l = chunk_launches(KT_TEST_N, chunk, m, DIM)
    expected = merged(kll, chunk_launches(KT_N, chunk, m, DIM), test_l)
    expected_stream = merged(kll, chunk_launches(KT_N, cfg.stream_batch_size, m, DIM), test_l)
    stream_cfg = dataclasses.replace(cfg, stream=True, **paths)

    def run(c, out):
        return KT.KernelTimitPipeline.run(c, dev, out=out)

    out, fitted = pipeline_pair("KernelTimitPipeline", card, gk, fk, run, cfg, stream_cfg, KT_N, expected,
                                expected_stream, test_x, TOL_PIPE_SCORES, RTOL_PIPE_SCORES)
    with phase("kernel TIMIT pipeline: B3 at d = 440 against its plain version and float64; the whitening"):
        nys = nystrom_of(fitted)
        scaler = [s for s in fitted_stages(fitted) if isinstance(s, StandardScalerModel)][0]
        xs, lmk = scaler(test_x[:chunk]).contiguous(), nys.landmarks
        out["b3_operands"] = b3_operand_checks(gk, cfg.gamma, (("K_nm chunk", xs, lmk), ("K_LL", lmk, lmk)))
        out["whitening_f64"] = whiten_check("KernelTimitPipeline", nys, cfg.nystrom_reg, cfg.gamma)
    return out


def kernel_cifar_pipeline_path(dev, card, gk, fk, tmp):
    """KernelCifarPipeline.run at its Config's full width on CIFAR-10's split
    sizes, written as CIFAR-10 binary files: load and stream on them, the
    run in memory and streamed, and B3 at the pipeline's d = 3072 shapes."""
    from keystone_tpu_torch.loaders import cifar
    from keystone_tpu_torch.ops.stats import StandardScalerModel
    from keystone_tpu_torch.pipelines import kernel_cifar as KC
    from keystone_tpu_torch.workflow import transformer as WT

    cfg = KC.Config(synthetic_n=CIFAR_N)
    m, chunk, d = cfg.num_landmarks, WT.APPLY_CHUNK_ROWS, cifar.H * cifar.W * cifar.C
    out = {}
    with phase("kernel CIFAR pipeline: the record files, load and stream"):
        KC.KernelCifarPipeline.run(dataclasses.replace(cfg, synthetic_n=4 * m), dev)  # warm-up, not counted
        t0 = time.perf_counter()
        paths = {}
        for key, n, seed in (("train_path", CIFAR_N, 1), ("test_path", CIFAR_TEST_N, 2)):
            paths[key] = str(tmp / f"{key}.bin")
            cifar.write_records(paths[key], *cifar.CifarLoader.synthetic_arrays(n, seed))
        made = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = cifar.CifarLoader.load(paths["train_path"], device=dev)
        t_load = time.perf_counter() - t0
        streamed = cifar.CifarLoader.stream(paths["train_path"], batch_size=cfg.stream_batch_size, device=dev)
        t0 = time.perf_counter()
        bad, rows = 0, 0
        for a, _ in streamed.data.device_batches():
            bad += int((a != loaded.data.array[rows:rows + a.shape[0]]).sum())
            rows += a.shape[0]
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t0
        raw = np.fromfile(paths["train_path"], np.uint8).reshape(-1, cifar.RECORD)
        px = torch.from_numpy(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32)).to(dev)
        exact = bool(torch.equal(loaded.data.array * 255.0, px.round()))  # 255·(b/255) rounds back to b
        same_labels = bool(np.array_equal(loaded.labels.numpy(), raw[:, 0])) and \
            bool(np.array_equal(streamed.labels.numpy(), raw[:, 0]))
        print(f"  {CIFAR_N} + {CIFAR_TEST_N} records written in {made:.2f} s ({os.path.getsize(paths['train_path'])} "
              f"bytes of training records); load {t_load:.2f} s, one stream sweep {t_stream:.2f} s; stream vs load: "
              f"{rows} rows, {bad} entries differ; pixels are the records' bytes/255: {exact}; labels: {same_labels}",
              flush=True)
        check(rows == CIFAR_N and bad == 0 and exact and same_labels, "load and stream disagree with the records")
        del loaded, streamed, px
        test_x = cifar.CifarLoader.load(paths["test_path"], device=dev).data.array.reshape(CIFAR_TEST_N, -1)
    kll = {f"gram_block ({m}, {m}, {d})": 1}
    test_l = chunk_launches(CIFAR_TEST_N, chunk, m, d)
    expected = merged(kll, chunk_launches(CIFAR_N, chunk, m, d), test_l)
    expected_stream = merged(kll, chunk_launches(CIFAR_N, cfg.stream_batch_size, m, d), test_l)
    cfg = dataclasses.replace(cfg, **paths)

    def run(c, out):
        return KC.KernelCifarPipeline.run(c, dev, out=out)

    # the scores head takes vectorized images: the test set as (n, 3072)
    pair, fitted = pipeline_pair("KernelCifarPipeline", card, gk, fk, run, cfg,
                                 dataclasses.replace(cfg, stream=True), CIFAR_N, expected, expected_stream,
                                 test_x.reshape(CIFAR_TEST_N, 32, 32, 3), TOL_PIPE_SCORES, RTOL_PIPE_SCORES)
    out.update(pair)
    nys = nystrom_of(fitted)
    with phase("kernel CIFAR pipeline: B3 at d = 3072 against its plain version and float64"):
        scaler = [s for s in fitted_stages(fitted) if isinstance(s, StandardScalerModel)][0]
        xs, lmk = scaler(test_x[:chunk]).contiguous(), nys.landmarks
        out["b3_operands"] = b3_operand_checks(gk, cfg.gamma, (("K_nm chunk", xs, lmk), ("K_LL", lmk, lmk)))
        out["whitening_f64"] = whiten_check("KernelCifarPipeline", nys, cfg.nystrom_reg, cfg.gamma)
    return out


# ---------------------------------------------------------------- the out-of-core kernel tier


def oc_krr_path(dev, card, gk, fk, data, tmp):
    """The out-of-core KRR fit at bench.py's kernel-leg geometry against the
    in-core fit: fit_store on a RowBlockStore, the streamed fit through a
    Pipeline with a save/load round trip, and a checkpoint resume."""
    from keystone_tpu_torch.loaders.stream import batched
    from keystone_tpu_torch.models import kernel_ridge as KR
    from keystone_tpu_torch.workflow.blockstore import RowBlockStore
    from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline

    n, d, k, bs, ep = KRR_N, KRR_D, KRR_K, KRR_BLOCK, KRR_EPOCHS
    nb = n // bs
    xd, yd, xtd = data
    est = KR.KernelRidgeRegressionEstimator(KR.GaussianKernelGenerator(KRR_GAMMA), lam=KRR_LAM, block_size=bs,
                                            num_epochs=ep)
    out = {}
    with phase("main path: out-of-core KRR, fit_store against the in-core fit"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        in_core = est.fit_arrays(xd, yd, device=dev)
        torch.cuda.synchronize()
        t_in = time.perf_counter() - t0
        t0 = time.perf_counter()
        store = RowBlockStore.from_array(str(tmp / "rows"), xd, bs)
        t_spill = time.perf_counter() - t0
        labels = Dataset(yd)
        est.fit_store(store, labels)  # warm-up, not counted
        oc, launches, shapes, peak, dt = counted_run("out-of-core KRR", gk, fk, lambda: est.fit_store(store, labels))
        resident = 2 * bs * d * 4 + 3 * nb * bs * k * 4  # bench.py's resident figure
        print(f"  spill {t_spill:.3f} s ({store.nbytes()} bytes, {nb} row blocks of ({bs}, {d})); sweep {dt:.4f} s "
              f"against the in-core fit's {t_in:.4f} s; peak device memory {peak / 2**20:.3f} MiB above the "
              f"sweep's start (bench.py's resident figure 2·bs·d·4 + 3·nb·bs·k·4 = {resident / 2**20:.3f} MiB) "
              f"({card})", flush=True)
        print(f"  launches {launches}, by shape {shapes}", flush=True)
        check(launches == {"gram_block": ep * nb * nb, "poly_block": 0},
              f"launches {launches}, expected {ep * nb * nb} B3 (epochs · nb²)")
        err = compare("α, out-of-core vs in-core, both on the kernel", oc.alpha, in_core.alpha, TOL_OC_ALPHA, 0.0)
        a64 = krr_alpha_f64(lambda a, b: gram_f64(a, b, KRR_GAMMA), xd, yd)
        e_oc, e_in = max_err64(oc.alpha, a64), max_err64(in_core.alpha, a64)
        print(f"  α against the float64 fit: out-of-core {e_oc:.3e}, in-core {e_in:.3e} (at most {F64_RATIO}x it)",
              flush=True)
        check(e_oc <= F64_RATIO * e_in, "the out-of-core α is further from float64 than the in-core fit's")
        reset_all(gk, fk)
        p_oc = oc(xtd)
        torch.cuda.synchronize()
        predict_launches = gk.LAUNCHES["gram_block"]
        p_in = in_core(xtd)
        r2 = 1.0 - float(((p_oc - p_in) ** 2).sum() / ((p_in - p_in.mean(dim=0)) ** 2).sum())
        print(f"  predictions on {KRR_TEST} rows: r² vs the in-core model {r2:.8f} (at least {OC_R2}); "
              f"B3 launches {predict_launches}", flush=True)
        check(r2 >= OC_R2 and predict_launches == nb, f"r² {r2}, predict launches {predict_launches}")
        tiles = [store.read_block(b).to(dev) for b in (0, 1)]
        out["b3_operands"] = b3_operand_checks(gk, KRR_GAMMA, (("sweep tile K_00", tiles[0], tiles[0]),
                                                               ("sweep tile K_01", tiles[0], tiles[1])))
        out.update({"spill_seconds": t_spill, "sweep_seconds": dt, "in_core_seconds": t_in,
                    "store_bytes": store.nbytes(), "peak_bytes": peak, "resident_bytes_bench": resident,
                    "launches": launches["gram_block"], "predict_launches": predict_launches,
                    "alpha_max_abs_err": err, "alpha_f64": {"out_of_core": e_oc, "in_core": e_in}, "r2": r2,
                    "tile": (bs, bs, d)})
    with phase("out-of-core KRR: fit_dataset on a StreamDataset through a Pipeline, save and load"):
        sd = StreamDataset(batched(xd.cpu().numpy(), 1000), n=n, device=dev)
        fitted = Pipeline.from_estimator(est, sd, labels).fit()
        reads = []
        read = RowBlockStore.read_block
        RowBlockStore.read_block = lambda self, b: reads.append(b) or read(self, b)
        try:
            got, launches, _, _, t_score = counted_run("out-of-core KRR scoring through the graph", gk, fk,
                                                       lambda: fitted(Dataset(xtd)).get().array)
        finally:
            RowBlockStore.read_block = read
        mapper = [s for s in fitted_stages(fitted) if isinstance(s, KR.OutOfCoreKernelBlockLinearMapper)]
        check(len(mapper) == 1 and os.path.isdir(mapper[0].store_directory), "the fitted model's store")
        path = str(tmp / "oc_krr.pt")
        fitted.save(path)
        again = FittedPipeline.load(path, map_location=dev)(Dataset(xtd)).get().array
        same = bool(torch.equal(again, got))
        r2s = 1.0 - float(((got - p_in) ** 2).sum() / ((p_in - p_in.mean(dim=0)) ** 2).sum())
        print(f"  the streamed fit's predictions: r² vs the in-core model {r2s:.8f}; after save and load identical: "
              f"{same}; the model's store {mapper[0].store_directory}", flush=True)
        print(f"  scoring {KRR_TEST} rows through the fitted pipeline: {t_score:.4f} s, {len(reads)} block reads, "
              f"B3 launches {launches['gram_block']} ({card})", flush=True)
        check(same and r2s >= OC_R2, "the streamed fit's model")
        check(len(reads) == nb and launches["gram_block"] == nb,
              f"graph scoring read {len(reads)} blocks and launched {launches}: one sweep of {nb} expected")
        shutil.rmtree(mapper[0].store_directory, ignore_errors=True)
        out["stream_pipeline"] = {"r2": r2s, "save_load_identical": same, "score_seconds": t_score,
                                  "score_block_reads": len(reads), "score_launches": launches["gram_block"]}
    with phase("out-of-core KRR: a checkpointed fit resumed"):
        ck = str(tmp / "ck")
        KR.KernelRidgeRegressionEstimator(KR.GaussianKernelGenerator(KRR_GAMMA), lam=KRR_LAM, block_size=bs,
                                          num_epochs=1).fit_store(store, labels, checkpoint_dir=ck)
        resumed = est.fit_store(store, labels, checkpoint_dir=ck).alpha
        same = bool(torch.equal(resumed, oc.alpha))
        print(f"  1 epoch checkpointed, resumed to {ep}: α bit for bit as the uninterrupted fit: {same}", flush=True)
        check(same, "the resumed fit's α differs from the uninterrupted fit's")
        out["checkpoint_resume_identical"] = same
    return out


def disk_tier_path(dev, card, gk, fk, data, tmp):
    """BlockKernelMatrix with its disk tier (one column on the card) at the
    KRR geometry, Gaussian (B3) and degree-2 polynomial (B4): two sweeps
    against the in-memory matrix; then the cached KRR fit taking the tier
    under a budget below K, against the in-memory cached fit."""
    from keystone_tpu_torch.models import kernel_ridge as KR
    from keystone_tpu_torch.models.kernel_matrix import BlockKernelMatrix
    from keystone_tpu_torch.workflow import profiling

    n, bs = KRR_N, KRR_BLOCK
    nb = n // bs
    xd, yd, _ = data
    gens = {"gaussian": (KR.GaussianKernelGenerator(KRR_GAMMA), "gram_block"),
            "polynomial": (KR.PolynomialKernelGenerator(2, 1.0 / KRR_D, 1.0), "poly_block")}
    out = {}
    for label, (gen, kname) in gens.items():
        with phase(f"main path: BlockKernelMatrix disk tier, {label}"):
            mem = BlockKernelMatrix(gen, xd, bs, cache_blocks=nb * nb)
            want = [mem.column_block(j) for j in range(nb)]
            km = BlockKernelMatrix(gen, xd, bs, cache_blocks=0, spill_dir=str(tmp / f"spill_{label}"), hbm_cols=1)
            epochs = []
            for e in range(2):
                torch.cuda.synchronize()
                reset_all(gk, fk)
                t0 = time.perf_counter()
                bad = sum(int((km.column_block(j) != want[j]).sum()) for j in range(nb))
                torch.cuda.synchronize()
                epochs.append({"seconds": time.perf_counter() - t0, "launches": dict(gk.LAUNCHES), "mismatches": bad,
                               "spill_reads": km.spill_reads, "spill_writes": km.spill_writes})
            print(f"  {nb} columns of ({n}, {bs}) twice, one on the card: {epochs} ({card})", flush=True)
            check(epochs[0]["launches"][kname] == nb and epochs[1]["launches"] == {"gram_block": 0, "poly_block": 0},
                  f"launches {[ep['launches'] for ep in epochs]}: epoch 1 computes each column, epoch 2 none")
            check(km.spill_reads == nb and km.spill_writes == nb and not any(ep["mismatches"] for ep in epochs),
                  "the disk tier's columns differ from the in-memory matrix's, or were not reread")
            out[label] = {"epochs": epochs, "launches": nb, "kernel": kname}
            del mem, want
    with phase("main path: the cached KRR fit over the budget, through the disk tier"):
        kw = dict(lam=KRR_LAM, block_size=bs, num_epochs=KRR_EPOCHS, cache_kernel_blocks=True)
        est = KR.KernelRidgeRegressionEstimator(gens["gaussian"][0], **kw)
        in_memory = est.fit_arrays(xd, yd, device=dev).alpha
        # a budget one byte short of K, through the device-memory override
        # (the fit reads half of it): the fit takes the tier, nb − 1
        # columns on the card
        with env_var("KEYSTONE_HBM_BUDGET_BYTES", str(2 * (n * n * 4 - 1))):
            check(profiling.device_hbm_budget(0.5, dev) == n * n * 4 - 1, "the budget override")
            cache = tmp / "kcache"
            tiered, launches, shapes, peak, dt = counted_run(
                "cached KRR fit over the budget", gk, fk,
                lambda: KR.KernelRidgeRegressionEstimator(gens["gaussian"][0], kernel_cache_dir=str(cache),
                                                          **kw).fit_arrays(xd, yd, device=dev).alpha)
        spilled = sorted(p.name for p in cache.glob("kcol_*.npy"))
        same = bool(torch.equal(tiered, in_memory))
        print(f"  launches {launches}; {len(spilled)} columns spilled; {dt:.4f} s; peak device memory "
              f"{peak / 2**20:.1f} MiB above the fit's start; α bit for bit as the in-memory cached fit: {same} "
              f"({card})", flush=True)
        check(launches == {"gram_block": nb, "poly_block": 0} and len(spilled) == nb,
              f"launches {launches}, {len(spilled)} spilled columns")
        check(same, "the tiered fit's α differs from the in-memory cached fit's")
        out["cached_fit"] = {"launches": launches["gram_block"], "seconds": dt, "peak_bytes": peak,
                             "alpha_identical": same}
    return out


@contextlib.contextmanager
def env_var(name, value):
    """``name`` set to ``value`` (None: unset) inside the block, restored after."""
    before = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = before


def gram_shape_times(gk, cases):
    """B3's and B4's times at the new paths' shapes on seeded operands
    (the times do not depend on the values), with their plain versions'
    and bounds; ``cases``: (label, kernel name, (n, m, d), scalars)."""
    g = torch.Generator(device=DEVICE).manual_seed(11)
    out = {}
    for label, kname, (n, m, d), scal in cases:
        x = torch.randn((n, d), generator=g, device=DEVICE) / d ** 0.5
        z = torch.randn((m, d), generator=g, device=DEVICE) / d ** 0.5
        if kname == "gram_block":
            kern, plain, cost = gk.gram_block_kernel, gk.gram_block_ref, gram_cost(n, m, d)
        else:
            kern, plain, cost = gk.poly_block_kernel, gk.poly_block_ref, gram_cost(n, m, d, degree=scal[-1])
        out[label] = {"shape": (n, m, d), "ms": cuda_ms(lambda: kern(x, z, *scal)),
                      "plain_ms": cuda_ms(lambda: plain(x, z, *scal), reps=5), "bound_ms": bound_ms(*cost),
                      "bound_by": bound_by(*cost), "bound_ms_tc": bound_ms_tc(n, m, d)}
    return out


def gram_lines(gk, serving, krr_x, errs, f64, results):
    """The kernels-line entries of B3 and B4: times at the main paths'
    shapes, the plain versions', one torch.matmul of the same operands
    (the gemm the fused kernel should approach), bounds and launches."""
    xs, lmk, gamma = serving
    xb = krr_x[:KRR_BLOCK]
    krr = results["krr"]
    gram_launches = {"kernel TIMIT": results["kernel_timit"]["launches"],
                     **{k: v["launches"] for k, v in krr.items()
                        if k in ("in-core gaussian", "cached gaussian", "predict", "matvec gaussian")}}
    poly_launches = {k: v["launches"] for k, v in krr.items()
                     if k in ("cached polynomial", "cached linear", "matvec polynomial", "matvec linear")}
    kt, kc = results["kernel_timit_pipeline"], results["kernel_cifar_pipeline"]
    oc, disk = results["oc_krr"], results["disk_tier"]
    gram_launches.update({
        "KernelTimitPipeline in memory": kt["in memory"]["launches"],
        "KernelTimitPipeline stream": kt["stream"]["launches"],
        "KernelCifarPipeline in memory": kc["in memory"]["launches"],
        "KernelCifarPipeline stream": kc["stream"]["launches"],
        "out-of-core KRR sweep": oc["launches"], "out-of-core KRR predict": oc["predict_launches"],
        "disk tier gaussian": disk["gaussian"]["launches"], "cached fit over the budget": disk["cached_fit"]["launches"],
        "out-of-core KRR under kernel.sweep": results["operations"]["oc_krr_sweep_fault"]["launches"],
    })
    poly_launches["disk tier polynomial"] = disk["polynomial"]["launches"]
    paths = (("KernelTimitPipeline", kt["b3_operands"]), ("KernelCifarPipeline", kc["b3_operands"]),
             ("out-of-core KRR", oc["b3_operands"]))
    timit_d, cifar_d, m_l = 440, 3072, 2048
    new_shapes = gram_shape_times(gk, [
        ("KernelTimitPipeline K_LL", "gram_block", (m_l, m_l, timit_d), (0.015,)),
        ("KernelTimitPipeline K_nm chunk", "gram_block", (128, m_l, timit_d), (0.015,)),
        ("KernelCifarPipeline K_LL", "gram_block", (m_l, m_l, cifar_d), (CIFAR_GAMMA,)),
        ("KernelCifarPipeline K_nm chunk", "gram_block", (128, m_l, cifar_d), (CIFAR_GAMMA,)),
        ("KernelCifarPipeline K_nm stream batch", "gram_block", (1024, m_l, cifar_d), (CIFAR_GAMMA,)),
        ("out-of-core KRR tile", "gram_block", (KRR_BLOCK, KRR_BLOCK, KRR_D), (KRR_GAMMA,)),
        ("disk tier polynomial column", "poly_block", (KRR_N, KRR_BLOCK, KRR_D), (1.0 / KRR_D, 1.0, 2)),
    ])
    n, d = xs.shape
    m = lmk.shape[0]
    serving_cost = gram_cost(n, m, d)
    column_cost = gram_cost(KRR_N, KRR_BLOCK, KRR_D)
    poly_cost = gram_cost(KRR_N, KRR_BLOCK, KRR_D, degree=2)
    linear_cost = gram_cost(KRR_N, KRR_BLOCK, KRR_D, degree=1)
    gemm_column = cuda_ms(lambda: torch.matmul(krr_x, xb.T))
    xs16, lmk16, krr16, xb16 = (t.bfloat16() for t in (xs, lmk, krr_x, xb))
    gram = {
        "name": "gram_block", "route": "cuda", "source": "keystone_tpu_torch/csrc/gram.cu",
        "replaces": "keystone_tpu/ops/gram_pallas.py:89",
        "launches": sum(gram_launches.values()), "launches_by_path": gram_launches,
        "max_abs_err": errs["gram_block"], "max_abs_err_bf16": errs["gram_block_bf16"],
        "max_abs_err_bf16_vs_f32": errs["gram_block_bf16_vs_f32"], "f64_check": f64["gram_block"],
        "ms": cuda_ms(lambda: gk.gram_block_kernel(xs, lmk, gamma)),
        "plain_ms": cuda_ms(lambda: gk.gram_block_ref(xs, lmk, gamma), reps=5),
        "bound_ms": bound_ms(*serving_cost), "bound_by": bound_by(*serving_cost),
        "bound_ms_tc": bound_ms_tc(n, m, d), "bound_ms_tc_bf16": bound_ms_tc(n, m, d, bf16=True),
        # no single PyTorch call computes a Gaussian gram
        "library_ms": None, "gemm_ms": cuda_ms(lambda: torch.matmul(xs, lmk.T)),
        "shape": f"({n}, {m}, {d}) f32, one Kernel TIMIT batch",
        # the bf16 operands cast before timing: the kernel alone
        "ms_bf16": cuda_ms(lambda: gk.gram_block_kernel(xs16, lmk16, gamma)),
        "ms_bf16_krr_column": cuda_ms(lambda: gk.gram_block_kernel(krr16, xb16, KRR_GAMMA)),
        "ms_krr_column": cuda_ms(lambda: gk.gram_block_kernel(krr_x, xb, KRR_GAMMA)),
        "plain_ms_krr_column": cuda_ms(lambda: gk.gram_block_ref(krr_x, xb, KRR_GAMMA), reps=5),
        "gemm_ms_krr_column": gemm_column, "bound_ms_krr_column": bound_ms(*column_cost),
        "bound_ms_tc_krr_column": bound_ms_tc(KRR_N, KRR_BLOCK, KRR_D),
        "bound_ms_tc_bf16_krr_column": bound_ms_tc(KRR_N, KRR_BLOCK, KRR_D, bf16=True),
        "shapes": {k: v for k, v in new_shapes.items() if not k.startswith("disk tier")},
        "max_abs_err_by_path": {f"{name} {k}": v["max_abs_err"] for name, r in paths for k, v in r.items()},
        "f64_check_by_path": {f"{name} {k}": v["f64_check"] for name, r in paths for k, v in r.items()},
    }
    poly = {
        "name": "poly_block", "route": "cuda", "source": "keystone_tpu_torch/csrc/gram.cu",
        "replaces": "keystone_tpu/ops/gram_pallas.py:207",
        "launches": sum(poly_launches.values()), "launches_by_path": poly_launches,
        "max_abs_err": errs["poly_block"], "max_abs_err_bf16": errs["poly_block_bf16"],
        "f64_check": f64["poly_block"],
        "ms": cuda_ms(lambda: gk.poly_block_kernel(krr_x, xb, 1.0 / KRR_D, 1.0, 2)),
        "plain_ms": cuda_ms(lambda: gk.poly_block_ref(krr_x, xb, 1.0 / KRR_D, 1.0, 2), reps=5),
        "bound_ms": bound_ms(*poly_cost), "bound_by": bound_by(*poly_cost),
        "bound_ms_tc": bound_ms_tc(KRR_N, KRR_BLOCK, KRR_D),
        "ms_bf16": cuda_ms(lambda: gk.poly_block_kernel(krr16, xb16, 1.0 / KRR_D, 1.0, 2)),
        "bound_ms_tc_bf16": bound_ms_tc(KRR_N, KRR_BLOCK, KRR_D, bf16=True),
        # the linear case (1, 0, 1) is one PyTorch call: x @ zᵀ (TF32 off)
        "library_ms": gemm_column, "gemm_ms": gemm_column,
        "shape": f"({KRR_N}, {KRR_BLOCK}, {KRR_D}) f32 degree 2, one KRR column block",
        "ms_linear": cuda_ms(lambda: gk.poly_block_kernel(krr_x, xb, 1.0, 0.0, 1)),
        "plain_ms_linear": cuda_ms(lambda: gk.poly_block_ref(krr_x, xb, 1.0, 0.0, 1), reps=5),
        "bound_ms_linear": bound_ms(*linear_cost),
        "bound_ms_tc_linear": bound_ms_tc(KRR_N, KRR_BLOCK, KRR_D),
        "shapes": {k: v for k, v in new_shapes.items() if k.startswith("disk tier")},
    }
    return [gram, poly]


# ---------------------------------------------------------------- the dense apps


def cuda_storages(min_bytes=0) -> dict:
    """The CUDA storages that live Python tensors hold, of at least
    ``min_bytes``: data pointer → (bytes, the largest view's shape)."""
    out = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            if st.nbytes() >= min_bytes and (st.data_ptr() not in out or o.numel() > np.prod(out[st.data_ptr()][1])):
                out[st.data_ptr()] = (st.nbytes(), tuple(o.shape))
    return out


@contextlib.contextmanager
def solve_memory_probe():
    """The device memory at the dense apps' solver.  On entry to the first
    ``Pipeline.fit``, the peak so far (loading and building).  On entry to
    the solver's outermost ``fit_dataset``: the bytes live (the featurized
    training set and what else the run holds), the peak so far (the
    featurization's) and the largest CUDA storages that live tensors
    hold; on its exit the peak again (the solve's, where it is higher).
    ``seconds`` is the probe's own time, for the caller to take off the
    fit's; the methods are restored on exit."""
    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator as BLS
    from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator as BWLS
    from keystone_tpu_torch.models.linear import LinearMapEstimator, LocalLeastSquaresEstimator
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    rec = {"seconds": 0.0}
    depth = [0]
    classes = (BLS, BWLS, LinearMapEstimator, LocalLeastSquaresEstimator)
    own = {cls: cls.__dict__.get("fit_dataset") for cls in classes}
    fit = Pipeline.fit

    def fit_entry(*a, **kw):
        if "peak_before_fit" not in rec:
            torch.cuda.synchronize()
            rec["peak_before_fit"] = torch.cuda.max_memory_allocated()
        return fit(*a, **kw)

    def wrap(fn):
        def wrapper(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            rec["live_at_solve"] = torch.cuda.memory_allocated()
            rec["peak_before_solve"] = torch.cuda.max_memory_allocated()
            rec["storages"] = cuda_storages(64 * 2**20)
            rec["seconds"] += time.perf_counter() - t0
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
                torch.cuda.synchronize()
                rec["peak_after_solve"] = torch.cuda.max_memory_allocated()
        return wrapper

    for cls in classes:
        cls.fit_dataset = wrap(cls.fit_dataset)
    Pipeline.fit = fit_entry
    try:
        yield rec
    finally:
        Pipeline.fit = fit
        for cls, fn in own.items():
            if fn is None:
                delattr(cls, "fit_dataset")
            else:
                cls.fit_dataset = fn


def app_run(label, card, gk, fk, run, cfg, n):
    """One dense app's ``run`` on the card, every launch count set to 0 just
    before and read just after: its ``Pipeline.fit`` seconds (the spill and
    the out-of-core solve apart), the whole run's, the peak device memory
    above the run's start, and where it peaks: the featurization's peak,
    the bytes live when the solver starts (with the largest storages the
    run made) and the solve's peak.  Returns (result, detail, record,
    launches)."""
    detail = {}
    before = cuda_storages()
    with fit_timer() as ft, solve_memory_probe() as mp:
        torch.cuda.synchronize()
        reset_all(gk, fk)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run(cfg, out=detail)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0 - mp["seconds"]
        peak = torch.cuda.max_memory_allocated() - base
    fit_s = ft["fit"] - mp["seconds"]
    launches = {**fk.LAUNCHES, **gk.LAUNCHES}
    metric = "mean_ap" if "mean_ap" in res else "accuracy"
    print(f"  Pipeline.fit {fit_s:.3f} s ({n / fit_s:.1f} training items/s; of it the solver's spill "
          f"{ft['spill']:.3f} s, its out-of-core solve {ft['solve']:.3f} s); run's fit_seconds (making or loading "
          f"the training set, and building, included) {res['fit_seconds']:.3f} s, the whole run {dt:.3f} s; "
          f"held-out {metric} {res[metric]:.4f}; peak device memory {peak / 2**30:.3f} GiB above the run's start "
          f"({card})", flush=True)
    gib = 2.0 ** 30
    made = sorted(((b, shape) for ptr, (b, shape) in mp["storages"].items() if ptr not in before), reverse=True)
    where = {"build_peak": mp["peak_before_fit"] - base, "featurize_peak": mp["peak_before_solve"] - base,
             "live_at_solve": mp["live_at_solve"] - base, "solve_peak": mp["peak_after_solve"] - base,
             "largest_at_solve": [[b, list(sh)] for b, sh in made[:8]]}
    print(f"  where it peaks (above the run's start): loading and building {where['build_peak'] / gib:.3f} GiB; "
          f"with the featurization {where['featurize_peak'] / gib:.3f} GiB; live when the solver starts "
          f"{where['live_at_solve'] / gib:.3f} GiB, of it the run's storages of 64 MiB or more: "
          + (", ".join(f"{sh} {b / gib:.3f}" for b, sh in made[:8]) or "none")
          + f"; the solve's peak {where['solve_peak'] / gib:.3f} GiB", flush=True)
    print(f"  launches {launches}", flush=True)
    print_prediction(ft["predicted"], peak, card)
    check(not res["model_loaded"], f"{label}: loaded a model")
    record = {"fit_seconds": fit_s, "spill_seconds": ft["spill"], "oc_solve_seconds": ft["solve"],
              "run_fit_seconds": res["fit_seconds"], "run_seconds": dt, "items_per_s": n / fit_s,
              metric: res[metric], "peak_bytes": peak, "predicted_bytes": ft["predicted"], "peak_by_stage": where}
    return res, detail, record, launches


def no_launch(label, launches) -> None:
    check(not any(launches.values()), f"{label}: a kernel launched on a path without one: {launches}")


def f32_grade(label, f32_err, tf32_err, tol) -> dict:
    """A dense path without a kernel against float64: its f32 error within
    ``tol`` and at most 1/TF32_MARGIN of the same computation's with
    one-pass TF32 products (which tells that TF32 is off)."""
    print(f"  {label} against float64: f32 {f32_err:.3e} (at most {tol:.0e}); one-pass TF32 {tf32_err:.3e} (at "
          f"least {TF32_MARGIN}x the f32 error)", flush=True)
    check(f32_err <= tol, f"{label}: {f32_err:.3e} from float64")
    check(tf32_err >= TF32_MARGIN * f32_err, f"{label}: the check cannot tell TF32 from f32")
    return {"f32": f32_err, "tf32": tf32_err}


@contextlib.contextmanager
def tf32_everything():
    """One-pass TF32 for f32 matmuls and cuDNN convolutions (a negative
    control), restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tf32_matmul():
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def applied(fitted, x):
    """A fitted pipeline's output on the tensor x, through the graph."""
    from keystone_tpu_torch.workflow.dataset import Dataset

    return fitted(Dataset(x)).get().array


def ridge_f64(feats, y, lam):
    """The centred ridge solution in float64 (the normal equations of
    ``models/linear.py``): (W, b)."""
    x, y = feats.double(), y.double()
    xm, ym = x.mean(0), y.mean(0)
    xc, yc = x - xm, y - ym
    w = torch.linalg.solve(xc.T @ xc + lam * x.shape[0] * torch.eye(x.shape[1], dtype=torch.float64,
                                                                      device=x.device), xc.T @ yc)
    return w, ym - xm @ w


def linear_app_pair(label, card, gk, fk, run, cfg, stream_cfg, n, test_x, train_x, train_y, num_classes):
    """A linear app (MnistRandomFFT, LinearPixels) in memory, then streamed:
    launches (none), fit seconds, peak memory; the two fits' weights and
    held-out scores held together; both fits' weights and the in-memory
    scores against the float64 normal equations on the same features,
    with a one-pass TF32 control that must leave the app's limit."""
    from keystone_tpu_torch.models.linear import LinearMapEstimator, LinearMapper
    from keystone_tpu_torch.ops.util import ClassLabelIndicators

    tol = TOL_LINEAR_W[label]
    out, fitted = {}, {}
    for mode, c in (("in memory", cfg), ("stream", stream_cfg)):
        with phase(f"main path: {label}.run, {mode}"):
            res, detail, rec, launches = app_run(f"{label} {mode}", card, gk, fk, run, c, n)
            no_launch(f"{label} {mode}", launches)
            check(res["accuracy"] >= DENSE_ACCURACY_MIN, f"{label} {mode}: accuracy {res['accuracy']:.4f}")
            fitted[mode] = detail["fitted"]
            out[mode] = {**rec, "predictions": detail["predictions"]}
    with phase(f"{label}: the streamed fit against the in-memory fit; both against float64"):
        feat, lm = split_at(fitted["in memory"], LinearMapper)
        feat_s, lm_s = split_at(fitted["stream"], LinearMapper)
        feats = applied(feat, train_x)
        y = ClassLabelIndicators(num_classes)(train_y)
        w64, b64 = ridge_f64(feats, y, cfg.lam)
        scale = w64.abs().max().item()
        with tf32_matmul():
            w_t = LinearMapEstimator(cfg.lam).fit_arrays(feats, y, device=feats.device).weights
        e_t = max_err64(w_t, w64) / scale
        print(f"  {label} weights with one-pass TF32 products against the float64 normal equations: {e_t:.3e} of "
              f"|w| max {scale:.3e} (must exceed {tol:.1e})", flush=True)
        check(e_t > tol, f"{label}: the weight limit cannot tell TF32 from f32 ({e_t:.3e})")
        out["f64_check"] = {"tf32": e_t, "limit": tol}
        for mode, m in (("in memory", lm), ("stream", lm_s)):
            e = max_err64(m.weights, w64) / scale
            print(f"  {label} weights, {mode}, against the float64 normal equations: {e:.3e} of |w| max {scale:.3e} "
                  f"(at most {tol:.1e})", flush=True)
            check(e <= tol, f"{label} weights, {mode}: {e:.3e} from float64")
            out["f64_check"][mode] = e
        w_err = max_err(lm_s.weights, lm.weights) / scale
        print(f"  weights, stream vs in memory: largest difference {w_err:.3e} of the largest weight (at most "
              f"{tol:.1e})", flush=True)
        check(w_err <= tol, f"{label}: the streamed weights differ by {w_err:.3e}")
        test_feats = applied(feat, test_x)
        sa, sb = lm(test_feats), lm_s(applied(feat_s, test_x))
        err = compare("held-out scores, stream vs in memory", sb, sa, TOL_PIPE_SCORES, RTOL_PIPE_SCORES)
        s64 = test_feats.double() @ w64 + b64
        e_s = compare("held-out scores, in memory vs the float64 fit", sa, s64, TOL_PIPE_SCORES, RTOL_PIPE_SCORES)
        pa, pb = out["in memory"].pop("predictions"), out["stream"].pop("predictions")
        agree = float((pa == pb).mean())
        print(f"  predicted classes agree on {agree:.6f} of {len(pa)}", flush=True)
        check(agree >= PIPE_AGREEMENT, f"{label}: classes agree on {agree:.6f}")
        out["agreement"] = {"weights_rel": w_err, "scores_max_abs_err": err, "scores_vs_f64": e_s, "classes": agree}
        del feats, test_feats
    return out


def mnist_path(dev, card, gk, fk, tmp):
    """MnistRandomFFT.run at its Config (4 FFT branches, λ 1e-2) on MNIST's
    split sizes, synthetic rows written as the MNIST CSV: in memory
    (``load``) and streamed from the CSV in batches of 4096."""
    from keystone_tpu_torch.loaders.mnist import MnistLoader, write_csv
    from keystone_tpu_torch.pipelines import mnist_random_fft as M

    with phase("MnistRandomFFT: the CSV files"):
        M.MnistRandomFFT.run(M.Config(synthetic_n=1024), dev)  # warm-up, not counted
        t0 = time.perf_counter()
        paths = {}
        for key, n, seed in (("train_path", MNIST_N, 1), ("test_path", MNIST_TEST_N, 2)):
            paths[key] = str(tmp / f"{key}.csv")
            write_csv(paths[key], *MnistLoader.synthetic_arrays(n, seed))
        print(f"  {MNIST_N} + {MNIST_TEST_N} rows written in {time.perf_counter() - t0:.2f} s "
              f"({os.path.getsize(paths['train_path'])} bytes of training CSV)", flush=True)
        train = MnistLoader.load(paths["train_path"], device=dev)
        test_x = MnistLoader.load(paths["test_path"], device=dev).data.array
    cfg = M.Config(**paths)

    def run(c, out):
        return M.MnistRandomFFT.run(c, dev, out=out)

    return linear_app_pair("MnistRandomFFT", card, gk, fk, run, cfg,
                           dataclasses.replace(cfg, stream=True, stream_batch_size=cfg.stream_batch_size), MNIST_N,
                           test_x, train.data.array, train.labels.array, 10)


def linear_pixels_path(dev, card, gk, fk, cifar_paths):
    """LinearPixels.run at its Config (λ 1e-3) on the CIFAR record files of
    the kernel CIFAR phase: in memory and streamed in batches of 1024."""
    from keystone_tpu_torch.loaders.cifar import CifarLoader
    from keystone_tpu_torch.pipelines import linear_pixels as LP

    LP.LinearPixels.run(LP.Config(synthetic_n=1024), dev)  # warm-up, not counted
    cfg = LP.Config(**cifar_paths)
    train = CifarLoader.load(cifar_paths["train_path"], device=dev)
    test_x = CifarLoader.load(cifar_paths["test_path"], device=dev).data.array

    def run(c, out):
        return LP.LinearPixels.run(c, dev, out=out)

    return linear_app_pair("LinearPixels", card, gk, fk, run, cfg, dataclasses.replace(cfg, stream=True), CIFAR_N,
                           test_x, train.data.array, train.labels.array, 10)


def conv_f64(x, filters, offset, stride=1):
    out = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2), filters.double().permute(0, 3, 1, 2),
                                     stride=stride).permute(0, 2, 3, 1)
    return out if offset is None else out + offset.double()


def convolver_forms(card, conv):
    """The Convolver's two forms on ``conv``'s filters at RandomPatchCifar's
    shape (a chunk of 128 32×32×3 images) and at 128×128×3: against each
    other and a float64 conv (f32-grade, with a one-pass TF32 control),
    and each form's device time."""
    from keystone_tpu_torch.ops.images import Convolver, _pick_conv_strategy

    g = torch.Generator(device=DEVICE).manual_seed(5)
    out = {}
    for hw in CONV_SIZES:
        x = torch.rand((DENSE_CHUNK, hw, hw, 3), generator=g, device=DEVICE)
        forms = {s: Convolver(conv.filters, offset=conv.offset, strategy=s) for s in ("direct", "im2col")}
        got = {s: f(x) for s, f in forms.items()}
        ref = conv_f64(x, conv.filters, conv.offset)
        scale = ref.abs().max().item()
        # each form with one-pass TF32 products: cuDNN's conv (the Convolver
        # itself turns its TF32 off), the im2col product
        with tf32_everything():
            tf32 = {"direct": torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv.filters.permute(0, 3, 1, 2))
                    .permute(0, 2, 3, 1) + conv.offset, "im2col": forms["im2col"](x)}
        label = f"({DENSE_CHUNK}, {hw}, {hw}, 3) * {tuple(conv.filters.shape)}"
        entry = {"shape": label}
        for s, o in got.items():
            entry[s] = {"f64_check": f32_grade(f"Convolver {s} {label}, relative to |ref| max {scale:.3e}",
                                               max_err64(o, ref) / scale, max_err64(tf32[s], ref) / scale,
                                               TOL_CONV_REL),
                        "ms": cuda_ms(lambda f=forms[s]: f(x), reps=10)}
        diff = max_err(got["direct"], got["im2col"]) / scale
        print(f"  {label}: direct {entry['direct']['ms']:.4f} ms, im2col {entry['im2col']['ms']:.4f} ms; the forms "
              f"{diff:.3e} apart (relative); auto picks {_pick_conv_strategy(hw, hw, tuple(conv.filters.shape), 1)} "
              f"({card})", flush=True)
        check(diff <= TOL_CONV_REL, f"the Convolver's forms differ by {diff:.3e} at {label}")
        entry["forms_rel_diff"] = diff
        out[f"{hw}x{hw}x3"] = entry
        del x, got, ref, tf32
    return out


def random_patch_path(dev, card, gk, fk, cifar_paths):
    """RandomPatchCifar.run at its Config on the CIFAR record files; the
    Convolver's two forms; the ZCA whitening against float64."""
    from keystone_tpu_torch.loaders.cifar import CifarLoader
    from keystone_tpu_torch.models.zca import ZCAWhitenerEstimator, _zca_fit
    from keystone_tpu_torch.ops.images import Convolver, RandomPatcher, _pick_conv_strategy
    from keystone_tpu_torch.pipelines import random_patch_cifar as RP

    RP.RandomPatchCifar.run(RP.Config(synthetic_n=1024), dev)  # warm-up, not counted
    cfg = RP.Config(**cifar_paths)
    out = {}
    with phase("main path: RandomPatchCifar.run"):
        res, detail, rec, launches = app_run("RandomPatchCifar", card, gk, fk,
                                             lambda c, out: RP.RandomPatchCifar.run(c, dev, out=out), cfg, CIFAR_N)
        no_launch("RandomPatchCifar", launches)
        check(res["accuracy"] >= PATCH_ACCURACY_MIN, f"accuracy {res['accuracy']:.4f}")
        conv = [st for st in fitted_stages(detail["fitted"]) if isinstance(st, Convolver)]
        check(len(conv) == 1, f"{len(conv)} Convolvers in the fitted pipeline")
        # "auto" resolves per images' shape when a batch is applied
        form = conv[0].strategy
        if form == "auto":
            form = _pick_conv_strategy(32, 32, tuple(conv[0].filters.shape), 1)
        print(f"  the fitted Convolver's strategy {conv[0].strategy!r}: the {form} form on 32×32 images", flush=True)
        out.update(rec, strategy=form)
    with phase("RandomPatchCifar: the Convolver's two forms against each other and float64; times"):
        out["convolver"] = convolver_forms(card, conv[0])
    with phase("RandomPatchCifar: the ZCA whitening against float64"):
        train = CifarLoader.load(cifar_paths["train_path"], device=dev)
        patches = RandomPatcher(cfg.patches_per_image, cfg.patch_size, cfg.patch_size, seed=cfg.seed).apply_dataset(
            train.data).array
        del train
        filt = patches[:cfg.num_filters]
        white = ZCAWhitenerEstimator(eps=cfg.zca_eps).fit_arrays(patches, device=dev)
        x64 = patches.double()
        mean64 = x64.mean(0)
        xc = x64 - mean64
        ev, vec = torch.linalg.eigh(xc.T @ xc / x64.shape[0])
        w64 = (vec / torch.sqrt(ev.clamp(min=0.0) + cfg.zca_eps)) @ vec.T
        ref = (filt.double() - mean64) @ w64  # the whitened patches the filters are made of
        scale = ref.abs().max().item()
        e32 = max_err64(white(filt), ref) / scale
        with tf32_matmul():
            wt, mt = _zca_fit(patches, cfg.zca_eps)
            e_t = max_err64((filt - mt) @ wt, ref) / scale
        print(f"  {tuple(patches.shape)} patches; covariance eigenvalues {ev.min().item():.3e}..{ev.max().item():.3e}; "
              f"the whitener against float64: {max_err64(white.whitener, w64):.3e}", flush=True)
        out["zca_f64_check"] = f32_grade(f"the {cfg.num_filters} whitened filter patches, relative to |ref| max "
                                         f"{scale:.3e}", e32, e_t, TOL_ZCA_REL)
        del patches, x64, xc
    return out


def timit_path(dev, card, gk, fk, timit_dir):
    """TimitPipeline.run at its Config on the kernel TIMIT phase's .npy
    frames (262 144 + 65 536): in memory, then streamed in batches of
    8192; the cosine features' phase against float64."""
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures, StandardScalerModel
    from keystone_tpu_torch.ops.util import MaxClassifier
    from keystone_tpu_torch.pipelines import timit as T

    paths = {"features_path": str(timit_dir / "features.npy"), "labels_path": str(timit_dir / "features_labels.npy"),
             "test_features_path": str(timit_dir / "test_features.npy"),
             "test_labels_path": str(timit_dir / "test_features_labels.npy")}
    T.TimitPipeline.run(T.Config(synthetic_n=4096), dev)  # warm-up, not counted
    cfg = T.Config(**paths)
    out, fitted = {}, {}
    for mode, c in (("in memory", cfg), ("stream", dataclasses.replace(cfg, stream=True))):
        with phase(f"main path: TimitPipeline.run, {mode}"):
            res, detail, rec, launches = app_run(f"TimitPipeline {mode}", card, gk, fk,
                                                 lambda c, out: T.TimitPipeline.run(c, dev, out=out), c, KT_N)
            no_launch(f"TimitPipeline {mode}", launches)
            check(res["accuracy"] >= PIPE_ACCURACY_MIN, f"{mode}: accuracy {res['accuracy']:.4f}")
            fitted[mode] = detail["fitted"]
            out[mode] = {**rec, "predictions": detail["predictions"]}
    test_x = torch.from_numpy(np.load(paths["test_features_path"])).to(dev)
    with phase("TimitPipeline: the streamed fit against the in-memory fit; the phase against float64"):
        sa = applied(split_at(fitted["in memory"], MaxClassifier)[0], test_x)
        sb = applied(split_at(fitted["stream"], MaxClassifier)[0], test_x)
        err = compare("held-out scores, stream vs in memory", sb, sa, TOL_PIPE_SCORES, RTOL_PIPE_SCORES)
        pa, pb = out["in memory"].pop("predictions"), out["stream"].pop("predictions")
        agree = float((pa == pb).mean())
        print(f"  predicted classes agree on {agree:.6f} of {len(pa)}", flush=True)
        check(agree >= PIPE_AGREEMENT, f"classes agree on {agree:.6f}")
        out["agreement"] = {"scores_max_abs_err": err, "classes": agree}
        stages = fitted_stages(fitted["in memory"])
        scaler = [s for s in stages if isinstance(s, StandardScalerModel)][0]
        crf = [s for s in stages if isinstance(s, CosineRandomFeatures)]
        check(len(crf) == cfg.num_cosine_features // cfg.cosine_block_size, f"{len(crf)} cosine feature blocks")
        xs = scaler(test_x[:DENSE_CHUNK])
        ref = torch.cos(xs.double() @ crf[0].w.double().T + crf[0].b.double())
        e32 = max_err64(crf[0](xs), ref)
        with tf32_matmul():
            e_t = max_err64(crf[0](xs), ref)
        out["cosine_f64_check"] = f32_grade(f"cos(x·Wᵀ + b) on {DENSE_CHUNK} scaled frames", e32, e_t, TOL_COSINE)
    return out


@contextlib.contextmanager
def plain_fv():
    """The FV nodes on their plain chains (``ops/fisher._use_kernel`` says
    no), restored after: the comparison run of a graph path."""
    from keystone_tpu_torch.ops import fisher

    saved = fisher._use_kernel
    fisher._use_kernel = lambda flag, xs: False
    try:
        yield
    finally:
        fisher._use_kernel = saved


def voc_vocabulary(fitted):
    """(PCATransformer, FisherVector) of a fitted VOCSIFTFisher."""
    from keystone_tpu_torch.models.pca import PCATransformer
    from keystone_tpu_torch.ops.fisher import FisherVector

    stages = fitted_stages(fitted)
    pca = [s for s in stages if isinstance(s, PCATransformer)]
    fv = [s for s in stages if isinstance(s, FisherVector)]
    check(len(pca) == len(fv) == 1, f"{len(pca)} PCA and {len(fv)} FV nodes in the fitted VOC pipeline")
    return pca[0], fv[0]


def voc_path(dev, card, gk, fk):
    """VOCSIFTFisher.run at its Config on VOC 2007's counts (5011 synthetic
    trainval images; run's own test set, then VOC's 4952 held out): in
    memory with B2 in the fit and B1 in scoring through FvFusionRule, the
    same run on the plain FV chains, streamed in batches of 32; B1 and B2
    at VOC's shape against their plain versions and float64."""
    from keystone_tpu_torch.evaluation.evaluators import MeanAveragePrecisionEvaluator
    from keystone_tpu_torch.loaders.voc import NUM_CLASSES, VOCLoader
    from keystone_tpu_torch.ops.fisher import FusedPcaFisherVector
    from keystone_tpu_torch.ops.images import GrayScaler, PixelScaler
    from keystone_tpu_torch.ops.sift import SIFTExtractor
    from keystone_tpu_torch.pipelines import voc_sift_fisher as V
    from keystone_tpu_torch.workflow import transformer as WT
    from keystone_tpu_torch.workflow.dataset import Dataset
    from keystone_tpu_torch.workflow.pipeline import PipelineEnv

    chunk = WT.APPLY_CHUNK_ROWS
    cfg = V.Config(synthetic_n=VOC_N)
    size = (cfg.image_size, cfg.image_size)
    run_test_n = max(8, VOC_N // 3)
    V.VOCSIFTFisher.run(V.Config(synthetic_n=256), dev)  # warm-up, not counted
    held = VOCLoader.synthetic(VOC_TEST_N, size=size, seed=3, device=dev)
    evaluator = MeanAveragePrecisionEvaluator(NUM_CLASSES)
    out, fitted, scores = {}, {}, {}

    def run(c, out):
        return V.VOCSIFTFisher.run(c, dev, out=out)

    modes = (("in memory", cfg, fv_launches(encode=-(-VOC_N // chunk)), contextlib.nullcontext),
             ("plain FV chains", cfg, fv_launches(), plain_fv),
             ("stream", dataclasses.replace(cfg, stream=True), fv_launches(encode=-(-VOC_N // cfg.stream_batch_size)),
              contextlib.nullcontext))
    for mode, c, want_fit, ctx in modes:
        with phase(f"main path: VOCSIFTFisher.run, {mode}"):
            with ctx():
                with fit_probe(fk) as probe:
                    res, detail, rec, launches = app_run(f"VOCSIFTFisher {mode}", card, gk, fk, run, c, VOC_N)
                fit_l = probe["fit_launches"]
                score_l = {k: fk.LAUNCHES[k] - fit_l[k] for k in fk.LAUNCHES}
                want_score = fv_launches() if mode.startswith("plain") else fv_launches(fused=-(-run_test_n // chunk))
                print(f"  FV launches: fit {fit_l}, scoring {score_l}; SIFT rows {probe['rows']}", flush=True)
                check(fit_l == want_fit, f"{mode}: fit launches {fit_l}, expected {want_fit}")
                check(score_l == want_score, f"{mode}: scoring launches {score_l}, expected {want_score}")
                check(not any(gk.LAUNCHES.values()), f"{mode}: gram kernels launched {gk.LAUNCHES}")
                check(res["mean_ap"] >= VOC_MAP_MIN, f"{mode}: mean AP {res['mean_ap']:.4f}")
                # VOC 2007's test count, scored by the fitted pipeline
                reset_all(fk)
                s = detail["fitted"](held.data).get().array
                torch.cuda.synchronize()
                held_l = dict(fk.LAUNCHES)
                want_held = fv_launches() if mode.startswith("plain") else fv_launches(fused=-(-VOC_TEST_N // chunk))
                check(held_l == want_held, f"{mode}: held-out scoring launches {held_l}, expected {want_held}")
                m_held = evaluator.evaluate(s.cpu().numpy(), held.labels.numpy())
                print(f"  {VOC_TEST_N} held-out images: mean AP {m_held:.4f}, FV launches {held_l}", flush=True)
            g = PipelineEnv.get_optimizer().execute(detail["fitted"](held.data).graph)
            fused = [op.transformer for op in g.operators.values()
                     if isinstance(getattr(op, "transformer", None), FusedPcaFisherVector)]
            check([f.sift_normalize for f in fused] == [True], "the scoring graph lacks its one fused FV node")
            fitted[mode], scores[mode] = detail["fitted"], (torch.from_numpy(detail["scores"]).to(dev), s)
            out[mode] = {**rec, "held_out_mean_ap": m_held, "launches_fit": fit_l, "launches_scoring": score_l,
                         "launches_held_out": held_l, "sift_rows": probe["rows"]}
    with phase("VOCSIFTFisher: the kernel run against the plain run and the streamed run"):
        pk, fv = voc_vocabulary(fitted["in memory"])
        for other in ("plain FV chains", "stream"):
            po, fo = voc_vocabulary(fitted[other])
            vocab = {"projector": max_err(pk.components @ pk.components.T, po.components @ po.components.T),
                     **{a: max_err(getattr(fv.gmm, a), getattr(fo.gmm, a)) for a in ("weights", "means", "variances")}}
            limits = {"projector": TOL_STREAM_PROJECTOR, "weights": TOL_EM_W, "means": TOL_EM_MU,
                      "variances": TOL_EM_VAR}
            print(f"  {other}: vocabulary against the kernel run's (largest differences) {vocab}, limits {limits}",
                  flush=True)
            check(all(vocab[k] <= limits[k] for k in limits), f"{other}: the vocabulary differs {vocab}")
            errs = [compare(f"{other} vs the kernel run, {what} scores", so, sk, TOL_GRAPH_SCORES, RTOL_GRAPH_SCORES)
                    for what, so, sk in zip(("run's held-out", f"{VOC_TEST_N} held-out"), scores[other],
                                            scores["in memory"])]
            d_map = abs(out[other]["held_out_mean_ap"] - out["in memory"]["held_out_mean_ap"])
            print(f"  mean AP {out[other]['held_out_mean_ap']:.4f} against the kernel run's "
                  f"{out['in memory']['held_out_mean_ap']:.4f} (at most {VOC_MAP_AGREE} apart)", flush=True)
            check(d_map <= VOC_MAP_AGREE, f"{other}: mean AP {d_map:.4f} apart")
            out[f"vs_{other.replace(' ', '_')}"] = {"vocabulary": vocab, "scores_max_abs_err": max(errs),
                                                     "mean_ap_diff": d_map}
    with phase("VOCSIFTFisher: B1 and B2 at VOC's shape against their plain versions and float64"):
        imgs = VOCLoader.synthetic(chunk, size=size, seed=1, device=dev).data.array
        xf = PixelScaler(only_if_integer=True)(imgs)
        raw, mask = SIFTExtractor(cfg.sift_step, (cfg.sift_bin_size,), normalize=False)(GrayScaler()(xf))
        z, zm = pk(*SIFTExtractor(cfg.sift_step, (cfg.sift_bin_size,))(GrayScaler()(xf)))
        gm = fv.gmm
        n, t, d = z.shape
        b2_args = (z, zm, gm.weights, gm.means, gm.variances)
        b1_args = (raw.contiguous(), mask, pk.components, pk.mean, gm.weights, gm.means, gm.variances, True)
        check(tuple(raw.shape) == (n, t, 128) and d == cfg.pca_dims, f"VOC's shapes {tuple(raw.shape)}, {d}")
        b2_err, b2_f64 = fv_shape_check(f"B2 at VOC's shape ({n}, {t}, {d}), K={cfg.gmm_k}", fk.fisher_encode,
                                        fk.fisher_encode_ref, fv_f64, b2_args, TOL_FV)
        b1_err, b1_f64 = fv_shape_check(f"B1 at VOC's shape ({n}, {t}, 128->{d}), K={cfg.gmm_k}", fk.fused_forward,
                                        fk.fused_forward_ref, fused_f64, b1_args, TOL_FUSED)
        b2_cost, b1_cost = fv_cost(n, t, d, cfg.gmm_k), fv_cost(n, t, d, cfg.gmm_k, d_in=128)
        out["b2_voc_shape"] = {"shape": f"({n}, {t}, {d}) K={cfg.gmm_k}, a training chunk", "max_abs_err": b2_err,
                               "f64_check": b2_f64, "ms": cuda_ms(lambda: fk.fisher_encode(*b2_args)),
                               "plain_ms": cuda_ms(lambda: fk.fisher_encode_ref(*b2_args), reps=5),
                               "bound_ms": bound_ms(*b2_cost), "bound_by": bound_by(*b2_cost),
                               "bound_ms_tc": fv_bound_ms_tc(n, t, d, cfg.gmm_k)}
        out["b1_voc_shape"] = {"shape": f"({n}, {t}, 128->{d}) K={cfg.gmm_k}, a scoring chunk",
                               "max_abs_err": b1_err, "f64_check": b1_f64,
                               "ms": cuda_ms(lambda: fk.fused_forward(*b1_args)),
                               "plain_ms": cuda_ms(lambda: fk.fused_forward_ref(*b1_args), reps=5),
                               "bound_ms": bound_ms(*b1_cost), "bound_by": bound_by(*b1_cost),
                               "bound_ms_tc": fv_bound_ms_tc(n, t, d, cfg.gmm_k, d_in=128)}
        for key in ("b2_voc_shape", "b1_voc_shape"):
            r = out[key]
            print(f"  {key} {r['shape']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                  f"ms by {r['bound_by']}, on the tensor cores {r['bound_ms_tc']:.4f} ms), {card}", flush=True)
        torch.cuda.synchronize()
    return out


def voc_fixture_path(dev, card):
    """The committed VOC fixture (tests/data/voc) on the card: nvJPEG's
    pixels against the reference's libjpeg pixels, and VOCSIFTFisher.run
    from its directories, in memory and streamed."""
    from keystone_tpu_torch.loaders import jpeg
    from keystone_tpu_torch.loaders.voc import VOCLoader
    from keystone_tpu_torch.pipelines import voc_sift_fisher as V

    out = {}
    with phase("VOC fixture: nvJPEG against libjpeg, and run from the directories"):
        ref = torch.from_numpy(np.load(VOC_PIXELS)).to(dev)
        jpeg.reset_launches()
        got = VOCLoader.load(**VOC_DIRS, size=VOC_FIXTURE_SIZE, device=dev)
        st = VOCLoader.stream(**VOC_DIRS, size=VOC_FIXTURE_SIZE, batch_size=8, device=dev)
        streamed = torch.cat([a for a, _ in st.data.device_batches()])
        diff = (got.data.array.to(torch.int32) - ref.to(torch.int32)).abs()
        print(f"  {got.data.n} images; nvJPEG against libjpeg: largest difference {int(diff.max())} levels (at most "
              f"{VOC_NVJPEG_MAX_DIFF}), mean {diff.float().mean().item():.4f}; decoder launches {jpeg.LAUNCHES}",
              flush=True)
        check(got.data.n == VOC_FIXTURE_N and got.data.device.type == dev.type, f"{got.data.n} fixture images")
        check(int(diff.max()) <= VOC_NVJPEG_MAX_DIFF, f"nvJPEG's pixels {int(diff.max())} levels from libjpeg's")
        wrong = wrong_decodes(got.data.array[:-1], ref[:-1], VOC_NVJPEG_MAX_DIFF)
        check(not bool(got.data.array[-1].any()), "the undecodable file is not a zero image")
        check(torch.equal(streamed, got.data.array), "load and stream decode differently")
        check(jpeg.LAUNCHES["nvjpeg"] > 0 and jpeg.LAUNCHES["libjpeg"] == 0, f"decoders {jpeg.LAUNCHES}")
        cfg = V.Config(**VOC_DIRS, image_size=VOC_FIXTURE_SIZE[0])
        sout, mout = {}, {}
        res = V.VOCSIFTFisher.run(cfg, dev, out=mout)
        res_s = V.VOCSIFTFisher.run(dataclasses.replace(cfg, stream=True, stream_batch_size=8), dev, out=sout)
        print(f"  run from the directories: mean AP {res['mean_ap']:.4f} (above {VOC_FIXTURE_MAP_MIN}); streamed "
              f"{res_s['mean_ap']:.4f}", flush=True)
        check(res["mean_ap"] > VOC_FIXTURE_MAP_MIN, f"mean AP {res['mean_ap']:.4f} from the fixture")
        err = compare("held-out scores, stream vs in memory", torch.from_numpy(sout["scores"]),
                      torch.from_numpy(mout["scores"]), TOL_GRAPH_SCORES, RTOL_GRAPH_SCORES)
        out.update({"images": got.data.n, "nvjpeg_max_diff": int(diff.max()), "wrong_decode_max_diff": wrong,
                    "nvjpeg_mean_diff": diff.float().mean().item(), "mean_ap": res["mean_ap"],
                    "mean_ap_stream": res_s["mean_ap"], "scores_stream_max_abs_err": err})
    return out


def device_busy_ms(prof) -> float:
    """The kernels' own device time in a profiler trace (an operator's
    self device time repeats its kernels')."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3


class TextClock:
    """Exclusive wall seconds of a text app's run by part: ``load`` (the
    loaders reading the files, and a stream's consumer waiting for its
    producer thread's next batch), ``text`` (the host chain: the Python host transformers, the vocabulary fit, the
    native chain and its CSR rows), ``bucket`` (CSR rows into nnz buckets
    and onto the card) and ``device`` (the heads' fits and the sparse
    scoring, each ended by a synchronize).  A region nested in another
    counts to its own part only."""

    def __init__(self):
        self.seconds = {"load": 0.0, "text": 0.0, "bucket": 0.0, "device": 0.0}
        self._stack = []

    def wrap(self, key, fn, sync=False, when=None):
        def wrapper(*a, **kw):
            if when is not None and not when(*a):
                return fn(*a, **kw)
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                out = fn(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                el = time.perf_counter() - t0
                self.seconds[key] += el - self._stack.pop()
                if self._stack:
                    self._stack[-1] += el
        return wrapper


@contextlib.contextmanager
def text_clock():
    """A TextClock over the text apps' functions, restored on exit."""
    from keystone_tpu_torch.loaders import stream as stream_mod
    from keystone_tpu_torch.loaders.amazon import AmazonReviewsDataLoader
    from keystone_tpu_torch.loaders.newsgroups import NewsgroupsDataLoader
    from keystone_tpu_torch.models.lbfgs import SparseLBFGSwithL2
    from keystone_tpu_torch.models.logistic import LogisticRegressionEstimator
    from keystone_tpu_torch.models.naive_bayes import NaiveBayesEstimator
    from keystone_tpu_torch.ops import nlp, nlp_native, sparse
    from keystone_tpu_torch.workflow.transformer import Transformer

    clock = TextClock()
    loaders = [(cls, name) for cls in (NewsgroupsDataLoader, AmazonReviewsDataLoader) for name in ("load", "stream")]
    patches = [
        (nlp_native, "featurize_docs", "text", False, None), (nlp_native, "hashtf_docs", "text", False, None),
        (nlp_native.DfAccumulator, "update", "text", False, None),
        (nlp_native.DfAccumulator, "topn", "text", False, None),
        (Transformer, "apply_dataset", "text", False, lambda self, *_: self.is_host),
        (nlp._RowFeaturizer, "apply_dataset", "text", False, None),
        (nlp.CommonSparseFeatures, "fit_dataset", "text", False, None),
        (sparse, "bucketize_with_labels", "bucket", False, None),
        (NaiveBayesEstimator, "fit_dataset", "device", True, None),
        (SparseLBFGSwithL2, "fit_dataset", "device", True, None),
        (LogisticRegressionEstimator, "fit_dataset", "device", True, None),
        (sparse, "score_sparse_dataset", "device", True, None),
    ]
    saved = [(obj, name, obj.__dict__[name]) for obj, name, *_ in patches]
    for obj, name, key, sync, when in patches:
        setattr(obj, name, clock.wrap(key, obj.__dict__[name], sync, when))
    statics = [(sparse.BucketedSparseRows, "from_scipy_rows", "bucket")] + [(c, n, "load") for c, n in loaders]
    saved += [(obj, name, obj.__dict__[name]) for obj, name, _ in statics]
    for obj, name, key in statics:
        setattr(obj, name, staticmethod(clock.wrap(key, obj.__dict__[name].__func__)))
    prefetched = stream_mod.prefetched
    saved.append((stream_mod, "prefetched", prefetched))

    def timed_prefetched(source, prefetch=2):
        inner = prefetched(source, prefetch=prefetch)
        take = clock.wrap("load", next)

        def gen():
            it, done = inner(), object()
            try:
                while (item := take(it, done)) is not done:
                    yield item
            finally:
                it.close()
        return gen

    stream_mod.prefetched = timed_prefetched
    try:
        yield clock
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def text_run(label, card, gk, fk, run, cfg, n):
    """One text app's ``run`` on the card, every launch count and the
    L-BFGS counters set to 0 just before and read just after, under the
    profiler (device activity only, for the idle share: 1 − the kernels'
    busy time over the run's host-clock time, profiler overhead included,
    so it reads high): ``Pipeline.fit`` seconds, documents a second, the
    host text, bucketing and device seconds apart, the L-BFGS iterations,
    line-search trials and host reads, and the peak device memory above
    the run's start.  Returns (result, detail, record)."""
    from torch.profiler import ProfilerActivity, profile

    from keystone_tpu_torch.models import lbfgs

    detail = {}
    with text_clock() as clock:
        torch.cuda.synchronize()
        reset_all(gk, fk)
        lbfgs.reset_stats()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run(cfg, DEVICE, out=detail)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
    busy = device_busy_ms(prof) / 1e3
    stats = dict(lbfgs.STATS)
    launches = {**fk.LAUNCHES, **gk.LAUNCHES}
    no_launch(label, launches)
    check(not res["model_loaded"], f"{label}: loaded a model")
    parts = dict(clock.seconds)
    parts["other"] = wall - sum(parts.values())
    idle = max(0.0, 1.0 - busy / wall)
    print(f"  Pipeline.fit (with the build) {res['fit_seconds']:.3f} s, {n / res['fit_seconds']:.1f} training "
          f"documents/s; the whole run {wall:.3f} s: loading {parts['load']:.3f} s, host text {parts['text']:.3f} "
          f"s, bucketing onto the card {parts['bucket']:.3f} s, device work {parts['device']:.3f} s, the rest (the "
          f"graph, the evaluation) {parts['other']:.3f} s; L-BFGS {stats['iterations']} iterations, {stats['trials']} line-search "
          f"trials, {stats['host_reads']} host reads; device busy {busy:.3f} s, idle share {idle:.4f} (one "
          f"window, profiler overhead included); peak device memory {peak / 2**30:.4f} GiB above the run's "
          f"start; held-out accuracy {res['accuracy']:.4f} ({card})", flush=True)
    check(res["accuracy"] >= TEXT_ACCURACY_MIN, f"{label}: accuracy {res['accuracy']:.4f}")
    record = {"fit_seconds": res["fit_seconds"], "docs_per_s": n / res["fit_seconds"], "run_seconds": wall,
              "seconds_by_part": parts, "lbfgs": stats, "device_busy_seconds": busy, "idle_share": idle,
              "peak_bytes": peak, **{k: res[k] for k in ("accuracy", "test_error", "f1") if k in res}}
    return res, detail, record


def csr_torch(rows, dtype, dev, transpose=False):
    """scipy CSR rows (or their transpose) as one torch sparse CSR matrix."""
    import warnings

    import scipy.sparse as sps

    m = sps.vstack(rows).tocsr()
    if transpose:
        m = m.T.tocsr()
    m.sort_indices()
    with warnings.catch_warnings():  # torch's sparse CSR is "beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(torch.from_numpy(m.indptr.astype(np.int64)),
                                       torch.from_numpy(m.indices.astype(np.int64)),
                                       torch.from_numpy(m.data).to(dtype), size=m.shape).to(dev)


def sparse_op_checks(label, rows, k, dev, card):
    """``sparse_matmul`` and ``sparse_grad`` at the app's own bucket shapes
    (its training rows bucketed as its fit buckets them) against a float64
    ``torch.sparse.mm`` of the same CSR rows, elementwise within
    TOL_SPARSE_REL of Σ|terms|; both timed beside ``torch.sparse.mm`` in
    f32 (a check and a yardstick: the port uses no library call)."""
    from keystone_tpu_torch.ops import sparse

    sp = sparse.BucketedSparseRows.from_scipy_rows(rows, device=dev)
    d = sp.num_features
    gen = torch.Generator(device=dev).manual_seed(11)
    w = torch.randn((d, k), generator=gen, device=dev)
    out, start, worst = [], 0, 0.0
    for b in sp.buckets:
        brows = [rows[i] for i in sp.perm[start:start + b.n]]
        start += b.n
        r = torch.randn((b.n, k), generator=gen, device=dev)
        x64, xt64 = csr_torch(brows, torch.float64, dev), csr_torch(brows, torch.float64, dev, transpose=True)
        ax64, axt64 = torch.sparse_csr_tensor(x64.crow_indices(), x64.col_indices(), x64.values().abs(),
                                              size=x64.shape), \
            torch.sparse_csr_tensor(xt64.crow_indices(), xt64.col_indices(), xt64.values().abs(), size=xt64.shape)
        got_mm = sparse.sparse_matmul(b.indices, b.values, w)
        got_g = sparse.sparse_grad(b.indices, b.values, r, d)
        for what, got, ref, bound in (
            ("sparse_matmul", got_mm, torch.sparse.mm(x64, w.double()), torch.sparse.mm(ax64, w.abs().double())),
            ("sparse_grad", got_g, torch.sparse.mm(xt64, r.double()), torch.sparse.mm(axt64, r.abs().double())),
        ):
            diff = (got.double() - ref).abs()
            check(bool(torch.isfinite(got).all()), f"{label} {what}: non-finite output")
            ok = bool((diff <= TOL_SPARSE_REL * bound).all())
            ratio = (diff / (TOL_SPARSE_REL * bound).clamp_min(1e-300)).max().item()
            worst = max(worst, ratio)
            check(ok, f"{label} {what} at ({b.n}, {b.nnz_max}): worst ratio {ratio:.3f}")
        x32, xt32 = csr_torch(brows, torch.float32, dev), csr_torch(brows, torch.float32, dev, transpose=True)
        t = {"rows": b.n, "nnz_cap": b.nnz_max,
             "matmul_ms": cuda_ms(lambda b=b: sparse.sparse_matmul(b.indices, b.values, w), reps=10),
             "grad_ms": cuda_ms(lambda b=b, r=r: sparse.sparse_grad(b.indices, b.values, r, d), reps=10),
             "library_matmul_ms": cuda_ms(lambda x32=x32: torch.sparse.mm(x32, w), reps=10),
             "library_grad_ms": cuda_ms(lambda xt32=xt32, r=r: torch.sparse.mm(xt32, r), reps=10)}
        out.append(t)
        print(f"  {label} bucket ({b.n}, {b.nnz_max}) x ({d}, {k}): sparse_matmul {t['matmul_ms']:.4f} ms "
              f"(torch.sparse.mm f32 {t['library_matmul_ms']:.4f} ms), sparse_grad {t['grad_ms']:.4f} ms "
              f"(torch.sparse.mm of the transpose {t['library_grad_ms']:.4f} ms), {card}", flush=True)
    print(f"  {label}: both ops within {TOL_SPARSE_REL:.0e}·Σ|terms| of float64 on every bucket (worst ratio "
          f"{worst:.3f})", flush=True)
    return {"buckets": out, "worst_ratio": worst}


def ls_objective(x, y, lam):
    """The least-squares objective and its gradient in float64 on the
    host: 1/(2n)·‖XW − Y‖² + λ/2·‖W‖² (x scipy CSR)."""
    def f(w):
        w = w.double().cpu().numpy()
        r = x @ w - y
        return 0.5 * np.sum(r * r) / x.shape[0] + 0.5 * lam * np.sum(w * w), x.T @ r / x.shape[0] + lam * w
    return f


def ce_objective(x, onehot, lam):
    """The softmax cross-entropy objective and its gradient in float64."""
    def f(w):
        w = w.double().cpu().numpy()
        z = x @ w
        z = z - z.max(1, keepdims=True)
        lse = np.log(np.exp(z).sum(1, keepdims=True))
        p = np.exp(z - lse)
        val = -np.sum(np.sum((z - lse) * onehot, 1)) / x.shape[0] + 0.5 * lam * np.sum(w * w)
        return val, x.T @ (p - onehot) / x.shape[0] + lam * w
    return f


def lbfgs_pair(label, w, trials, w_ref, trials_ref, objective, lam, x_test):
    """Two L-BFGS fits of one problem held as TOL_TEXT_W/TOL_PARTED_W
    say: the weights by their line-search paths, both fits by the
    strong-convexity certificates in float64, the argmax on the test rows
    (scipy CSR) agreeing on TEXT_AGREEMENT."""
    w, w_ref = w.double().cpu(), w_ref.double().cpu()
    scale = w_ref.abs().max().item()
    err = (w - w_ref).abs().max().item() / scale
    parted = trials != trials_ref
    tol = TOL_PARTED_W if parted else TOL_TEXT_W
    (f_a, g_a), (f_b, g_b) = objective(w), objective(w_ref)
    na, nb = float(np.linalg.norm(g_a)), float(np.linalg.norm(g_b))
    dist = float(torch.linalg.vector_norm(w - w_ref))
    dist_bound, f_bound = (na + nb) / lam, max(na, nb) ** 2 / (2 * lam)
    a = np.argmax(x_test @ w.numpy(), 1)
    b = np.argmax(x_test @ w_ref.numpy(), 1)
    agree = float((a == b).mean())
    print(f"  {label}: line searches of {trials} and {trials_ref} trials ({'parted' if parted else 'one path'}); "
          f"weights {err:.3e} of the largest ({scale:.3e}; at most {tol:.0e}); ‖Δw‖ {dist:.3e} (certificate "
          f"{dist_bound:.3e}); objective {f_a:.9e} and {f_b:.9e}, {abs(f_a - f_b):.3e} apart (certificate "
          f"{f_bound:.3e}); gradient norms {na:.3e}, {nb:.3e}; argmax agreement {agree:.6f} over {len(a)} test "
          f"documents", flush=True)
    check(err <= tol, f"{label}: weights {err:.3e} apart")
    check(dist <= dist_bound, f"{label}: the fits are farther apart than their gradients allow")
    check(abs(f_a - f_b) <= f_bound, f"{label}: the objectives are farther apart than their gradients allow")
    check(agree >= TEXT_AGREEMENT, f"{label}: argmax agreement {agree:.6f}")
    return {"weights_rel": err, "tolerance": tol, "trials": [trials, trials_ref], "distance": dist,
            "distance_certificate": dist_bound, "objective": [f_a, f_b], "objective_certificate": f_bound,
            "grad_norms": [na, nb], "argmax_agreement": agree}


def newsgroups_path(dev, card, gk, fk, tmp):
    """NewsgroupsPipeline.run at its Config, both heads, in memory and
    streamed from the trees written here; the sparse ops at its bucket
    shapes, naive Bayes against float64 counts, the card's least-squares
    fit against the same fit on the CPU, streamed against in memory."""
    import scipy.sparse as sps

    from keystone_tpu_torch.loaders.newsgroups import NEWSGROUPS, NewsgroupsDataLoader, synthetic_texts, write_tree
    from keystone_tpu_torch.models import lbfgs
    from keystone_tpu_torch.models.lbfgs import SparseLBFGSwithL2
    from keystone_tpu_torch.models.linear import LinearMapper
    from keystone_tpu_torch.models.naive_bayes import NaiveBayesModel
    from keystone_tpu_torch.ops.nlp import CommonSparseFeaturesModel
    from keystone_tpu_torch.pipelines import newsgroups as NG
    from keystone_tpu_torch.workflow.dataset import Dataset

    out = {}
    with phase("text: the Newsgroups trees (20 Newsgroups' bydate split sizes)"):
        groups = sorted(NEWSGROUPS)
        texts, labels = synthetic_texts(NEWS_N, NEWS_CLASSES, 1)
        ttexts, tlabels = synthetic_texts(NEWS_TEST_N, NEWS_CLASSES, 2)
        write_tree(str(tmp / "train"), texts, labels, groups)
        write_tree(str(tmp / "test"), ttexts, tlabels, groups)
    base = NG.Config(data_path=str(tmp / "train"), test_path=str(tmp / "test"), stream_batch_size=NEWS_BATCH)
    fitted = {}
    for head in ("nb", "ls"):
        for mode in ("in memory", "stream"):
            with phase(f"main path: NewsgroupsPipeline.run, {head}, {mode}"):
                cfg = dataclasses.replace(base, head=head, stream=mode == "stream")
                res, detail, rec = text_run(f"Newsgroups {head} {mode}", card, gk, fk, NG.NewsgroupsPipeline.run,
                                            cfg, NEWS_N)
                vocab = next(s for s in fitted_stages(detail["fitted"]) if isinstance(s, CommonSparseFeaturesModel))
                rec["vocabulary"] = len(vocab.vocab)
                print(f"  vocabulary {len(vocab.vocab)} terms (the Config's {cfg.num_features}); test error "
                      f"{res['test_error']:.6f}", flush=True)
                out[f"{head} {mode}"] = rec
                fitted[head, mode] = (detail["fitted"], vocab, detail["predictions"], res)
    with phase("Newsgroups: the vocabulary, the sparse ops at its bucket shapes, naive Bayes against float64"):
        vocab = fitted["nb", "in memory"][1]
        distinct = len(NG.CommonSparseFeatures(10**7).fit_dataset(
            NG.text_featurizer(2).fit()(Dataset(texts, device=dev)).get()).vocab)
        print(f"  the training corpus has {distinct} distinct terms (unigrams and bigrams); the vocabulary keeps "
              f"{len(vocab.vocab)} of them, at most the Config's {base.num_features}; the rows are "
              f"{base.num_features} wide", flush=True)
        check(len(vocab.vocab) == min(distinct, base.num_features), f"vocabulary of {len(vocab.vocab)} terms")
        check(vocab.num_features == base.num_features, f"rows {vocab.num_features} wide")
        out["distinct_terms"], out["vocabulary"] = distinct, len(vocab.vocab)
        # the rows in the loader's order (group by group), as the fits take them
        train = NewsgroupsDataLoader.load(base.data_path, groups=groups, device=dev)
        test = NewsgroupsDataLoader.load(base.test_path, groups=groups, device=dev)
        labels = train.labels.numpy()
        feat, nbm = split_at(fitted["nb", "in memory"][0], NaiveBayesModel)
        rows = feat(train.data).get().items
        trows = feat(test.data).get().items
        x, xt = sps.vstack(rows).tocsr().astype(np.float64), sps.vstack(trows).tocsr().astype(np.float64)
        out["sparse_ops"] = sparse_op_checks("Newsgroups", rows, NEWS_CLASSES, dev, card)
        onehot = np.eye(NEWS_CLASSES)[labels]
        counts = np.asarray((x.T @ onehot).T) + base.nb_lam
        lc64 = np.log(counts) - np.log(counts.sum(1, keepdims=True))
        lp64 = np.log(onehot.sum(0)) - np.log(NEWS_N)
        e_lc = compare("naive Bayes log_cond against float64 counts", nbm.log_cond.cpu(),
                       torch.from_numpy(lc64), TOL_NB_ATOL, TOL_NB_RTOL)
        e_lp = compare("naive Bayes log_prior against float64", nbm.log_prior.cpu(), torch.from_numpy(lp64),
                       TOL_NB_ATOL, TOL_NB_RTOL)
        out["nb_f64"] = {"log_cond": e_lc, "log_prior": e_lp}
    with phase("Newsgroups: the card's ls fit against the same fit on the CPU; streamed against in memory"):
        lm = split_at(fitted["ls", "in memory"][0], LinearMapper)[1]
        y = np.where(np.eye(NEWS_CLASSES)[labels] > 0, 1.0, -1.0).astype(np.float32)
        out["ls_problem"] = (rows, y, base.ls_lam)  # the checkpointed L-BFGS phase's, popped by main
        objective = ls_objective(x, y.astype(np.float64), base.ls_lam)
        lbfgs.reset_stats()
        t0 = time.perf_counter()
        cpu = SparseLBFGSwithL2(lam=base.ls_lam, num_iterations=100, fit_intercept=False).fit_dataset(
            Dataset(rows, device="cpu"), Dataset(torch.from_numpy(y)))
        cpu_s, cpu_stats = time.perf_counter() - t0, dict(lbfgs.STATS)
        print(f"  the CPU fit: {cpu_s:.3f} s, {cpu_stats}", flush=True)
        card_trials = out["ls in memory"]["lbfgs"]["trials"]
        out["ls_card_vs_cpu"] = {**lbfgs_pair("ls weights, card vs CPU", lm.weights, card_trials, cpu.weights,
                                              cpu_stats["trials"], objective, base.ls_lam, xt),
                                 "cpu_fit_seconds": cpu_s}
        agree = {}
        for head in ("nb", "ls"):
            (fm, vm, pm, rm), (fs, vs, ps, rs) = fitted[head, "in memory"], fitted[head, "stream"]
            check(list(vm.vocab.items()) == list(vs.vocab.items()), f"{head}: the streamed vocabulary differs")
            derr = abs(rm["test_error"] - rs["test_error"]) * NEWS_TEST_N
            print(f"  {head}: vocabularies equal; test error {rm['test_error']:.6f} in memory, "
                  f"{rs['test_error']:.6f} streamed ({derr:.1f} documents apart, at most 1)", flush=True)
            check(derr <= 1.0 + 1e-9, f"{head}: streamed test error {derr:.1f} documents off")
            if head == "nb":
                a, b = split_at(fm, NaiveBayesModel)[1], split_at(fs, NaiveBayesModel)[1]
                e = compare("nb log_cond, stream vs in memory", b.log_cond, a.log_cond, TOL_NB_ATOL, TOL_NB_RTOL)
                agree[head] = {"log_cond_max_abs_err": e, "test_error_docs": derr}
            else:
                a, b = split_at(fm, LinearMapper)[1], split_at(fs, LinearMapper)[1]
                agree[head] = {**lbfgs_pair("ls weights, stream vs in memory", b.weights,
                                            out["ls stream"]["lbfgs"]["trials"], a.weights,
                                            out["ls in memory"]["lbfgs"]["trials"], objective, base.ls_lam, xt),
                               "test_error_docs": derr}
        out["stream_vs_memory"] = agree
    return out


def amazon_path(dev, card, gk, fk, tmp):
    """AmazonReviewsPipeline.run at its Config, in memory and streamed from
    the JSON-lines file written here; the sparse ops at its bucket shapes,
    the card's logistic fit against the same fit on the CPU, streamed
    against in memory."""
    import scipy.sparse as sps

    from keystone_tpu_torch.loaders.amazon import synthetic_reviews, write_jsonl
    from keystone_tpu_torch.models import lbfgs
    from keystone_tpu_torch.models.logistic import LogisticRegressionEstimator, LogisticRegressionModel
    from keystone_tpu_torch.pipelines import amazon_reviews as AR
    from keystone_tpu_torch.workflow.dataset import Dataset

    out = {}
    with phase("text: the Amazon reviews files"):
        texts, labels = synthetic_reviews(AMAZON_N, 1)
        ttexts, tlabels = synthetic_reviews(AMAZON_N // 4, 2)
        write_jsonl(str(tmp / "train.jsonl"), texts, labels)
        write_jsonl(str(tmp / "test.jsonl"), ttexts, tlabels)
        labels = np.asarray(labels)
    base = AR.Config(data_path=str(tmp / "train.jsonl"), test_path=str(tmp / "test.jsonl"),
                     stream_batch_size=AMAZON_BATCH)
    fitted = {}
    for mode in ("in memory", "stream"):
        with phase(f"main path: AmazonReviewsPipeline.run, {mode}"):
            res, detail, rec = text_run(f"Amazon {mode}", card, gk, fk, AR.AmazonReviewsPipeline.run,
                                        dataclasses.replace(base, stream=mode == "stream"), AMAZON_N)
            print(f"  f1 {res['f1']:.6f}", flush=True)
            out[mode] = rec
            fitted[mode] = (detail["fitted"], res)
    with phase("Amazon: the sparse ops at its bucket shapes; the card's fit against the CPU's; stream vs memory"):
        feat, lr = split_at(fitted["in memory"][0], LogisticRegressionModel)
        rows = feat(Dataset(texts, device=dev)).get().items
        trows = feat(Dataset(ttexts, device=dev)).get().items
        xt = sps.vstack(trows).tocsr().astype(np.float64)
        used = len(np.unique(sps.vstack(rows).tocsr().indices))
        print(f"  {used} of the {base.num_features} hashed columns in use", flush=True)
        out["hashed_columns_used"] = used
        out["sparse_ops"] = sparse_op_checks("Amazon", rows, 2, dev, card)
        x = sps.vstack(rows).tocsr().astype(np.float64)
        objective = ce_objective(x, np.eye(2)[labels], base.lam)
        lbfgs.reset_stats()
        t0 = time.perf_counter()
        cpu = LogisticRegressionEstimator(2, lam=base.lam, num_iters=base.num_iters).fit_dataset(
            Dataset(rows, device="cpu"), Dataset(torch.from_numpy(labels)))
        cpu_s, cpu_stats = time.perf_counter() - t0, dict(lbfgs.STATS)
        print(f"  the CPU fit: {cpu_s:.3f} s, {cpu_stats}", flush=True)
        out["card_vs_cpu"] = {**lbfgs_pair("logistic weights, card vs CPU", lr.weights,
                                           out["in memory"]["lbfgs"]["trials"], cpu.weights, cpu_stats["trials"],
                                           objective, base.lam, xt), "cpu_fit_seconds": cpu_s}
        (fm, rm), (fs, rs) = fitted["in memory"], fitted["stream"]
        n_test = AMAZON_N // 4
        dacc = abs(rm["accuracy"] - rs["accuracy"]) * n_test
        print(f"  accuracy {rm['accuracy']:.6f} in memory, {rs['accuracy']:.6f} streamed ({dacc:.1f} documents "
              f"apart, at most 1); f1 {rm['f1']:.6f} and {rs['f1']:.6f}", flush=True)
        check(dacc <= 1.0 + 1e-9, f"streamed accuracy {dacc:.1f} documents off")
        # one document moves f1 = 2tp/(2tp + fp + fn) by at most 2/(positives − 1)
        check(abs(rm["f1"] - rs["f1"]) <= 2.0 / (int(np.sum(tlabels)) - 1), "streamed f1 more than one document off")
        b = split_at(fs, LogisticRegressionModel)[1]
        out["stream_vs_memory"] = {**lbfgs_pair("logistic weights, stream vs in memory", b.weights,
                                                out["stream"]["lbfgs"]["trials"], lr.weights,
                                                out["in memory"]["lbfgs"]["trials"], objective, base.lam, xt),
                                   "accuracy_docs": dacc}
    return out


# ---- the operations layer: fault plans, durable checkpoints and
# resume, recovery, deadlines, breakers and the run ledger on the card.
#
# The recovery of the streamed ImageNetSiftLcsFV fit at the fit leg
# (2048 images, K = 64, PCA 64, batches of 64, blocks of 4096, 2 epochs):
# fit_with_recovery with a state_dir and the solver's checkpoint_dir, in a
# child process of this script, under one KEYSTONE_FAULTS plan: the first
# stage raises once (node_retries=1 absorbs it), the training stream's
# 6th and 7th fetches raise (its 2 retries a batch absorb them), the 3rd
# and 4th block reads raise (the I/O layer's 2 retries absorb them), and
# the second epoch checkpoint's save ends the process (exit 75).  The
# relaunched child resumes the BCD from the epoch-1 checkpoint; its
# vocabularies, BCD weights and held-out scores must equal an
# uninterrupted fit's (the hooks-at-rest fit with nothing attached) bit for
# bit: the dense path has no atomics, and the resumed epoch starts from
# the full (W, P) state
RECOVERY_EXIT = 75
RECOVERY_PLAN = ("executor.stage:times=1:raise;stream.batch:after=5:times=2:raise;"
                 "blockstore.read:after=2:times=2:raise;ckpt.save:after=1:exit=75")
# the sites the plan's raises hit, and the counter that records each
# absorbed one: injected must equal survived at every site
SURVIVED_BY = {"executor.stage": "executor.stage_retries", "stream.batch": "stream.retries",
               "blockstore.read": "blockstore.read_retries"}
# hooks at rest: the streamed fit's seconds with nothing attached against
# phase 10's, on the host clock, which moved by up to a third between
# runs of one tree (PERF.md §2)
HOOK_RATIO = 1.5
# Pipeline.fit(deadline=...) on the streamed fit (~20 s on an H100): a
# budget a tenth of it; the executor splits it over the stages, so the
# raise comes at the first stage to overrun its share, within the budget
# plus DEADLINE_SLACK (the watchdog's join and the raise take
# microseconds; the slack leaves room for a busy host)
DEADLINE_BUDGET, DEADLINE_SLACK = 2.0, 0.25
BREAKER_THRESHOLD = 2
# the in-core checkpointed BCD at the fit leg's geometry: 2048 x 16 384
# features (random, seed 11), 64 classes, blocks of 4096, 2 epochs
CKPT_N, CKPT_D = FIT_N, 2 * 2 * FIT_GMM_K * PCA_DIMS
# the dense checkpointed L-BFGS on MnistRandomFFT's features (60 000 x
# 4104, 10 classes): the reference test's λ and history
# (tests/test_lbfgs_checkpoint.py:32), 25 iterations, a checkpoint every 5
LBFGS_LAM, LBFGS_HISTORY, LBFGS_ITERS, LBFGS_EVERY = 1e-3, 5, 25, 5
# the sparse one on Newsgroups' ls rows: its Config's λ and 100
# iterations, a checkpoint every 10.  Its scatter-adds run in a fixed
# order there (ops/sparse.py: scatter_plan, segment sums), so a
# resumed fit is held to the uninterrupted one bit for bit; the two-run
# spread of the plain (atomic) fit is measured and printed beside it
SPARSE_EVERY = 10


def streamed_build(P, dev, cfg):
    """The streamed ImageNetSiftLcsFV pipeline, as ``run`` builds it."""
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader

    train = ImageNetLoader.synthetic_stream(cfg.synthetic_n, cfg.num_classes, (cfg.image_size, cfg.image_size),
                                            seed=1, batch_size=cfg.stream_batch_size, device=dev,
                                            retries=cfg.stream_retries)
    return P.ImageNetSiftLcsFV.build(cfg, train.data, train.labels)


def fitted_arrays(fitted, vx) -> dict:
    """A fitted ImageNetSiftLcsFV's vocabularies, BCD weights and held-out
    class scores, as host arrays."""
    from keystone_tpu_torch.models.block_ls import BlockLinearMapper
    from keystone_tpu_torch.workflow.dataset import Dataset

    out = {}
    for b, (pca, fv) in fitted_vocabulary(fitted).items():
        out[f"{b}.pca.components"], out[f"{b}.pca.mean"] = pca.components, pca.mean
        for a in ("weights", "means", "variances"):
            out[f"{b}.gmm.{a}"] = getattr(fv.gmm, a)
    bl = split_at(fitted, BlockLinearMapper)[1]
    out["bcd.weights"], out["bcd.intercept"] = bl.weights, bl.intercept
    out["scores"] = scores_pipeline(fitted)(Dataset(vx)).get().array
    return {k: v.detach().cpu().numpy() for k, v in out.items() if v is not None}


def held_out_images(dev):
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader

    vx, _ = ImageNetLoader.synthetic_arrays(FIT_TEST_N, FIT_CLASSES, (IMAGE_HW, IMAGE_HW), seed=2)
    return torch.from_numpy(vx).to(dev)


def watch_materialize() -> dict:
    """Wraps the default optimizer's profiled materialization pass for the
    rest of this process; the dict returned counts its passes, their
    seconds, and the passes that took the structural fallback (each
    counted by ``optimizer.materialize_fallbacks``)."""
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.workflow.optimizer import ProfiledMaterializeRule

    stats = {"passes": 0, "seconds": 0.0, "fallbacks": 0}
    apply = ProfiledMaterializeRule.apply

    def counted(self, graph, device=None):
        before = metrics.REGISTRY.counter_value("optimizer.materialize_fallbacks")
        t0 = time.perf_counter()
        out = apply(self, graph, device=device)
        stats["seconds"] += time.perf_counter() - t0
        stats["passes"] += 1
        stats["fallbacks"] += int(metrics.REGISTRY.counter_value("optimizer.materialize_fallbacks") - before)
        return out

    ProfiledMaterializeRule.apply = counted
    return stats


def recovery_child(work: str) -> int:
    """One attempt of the recovered fit, in a process of its own: builds the
    kernels (the parent's build, cached), runs fit_with_recovery and scores
    the held-out images.  Prints a STATS line at every checkpoint save (the
    last one before an ``exit`` fault is the attempt's record) and, when
    the fit completes, a DONE line; the arrays go to ``work/fitted.npz``."""
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.kernels import build
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.ops import fisher_kernels as fk
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P
    from keystone_tpu_torch.utils import durable, precision
    from keystone_tpu_torch.workflow import state as WS
    from keystone_tpu_torch.workflow.pipeline import PipelineEnv
    from keystone_tpu_torch.workflow.recovery import fit_with_recovery

    dev = torch.device(DEVICE)
    precision.disable_tf32()
    build.build(["fisher"])
    materialize = watch_materialize()
    cfg = dataclasses.replace(fit_setup_config(P), stream=True, stream_batch_size=STREAM_BATCH,
                              checkpoint_dir=os.path.join(work, "ckpt"), stream_retries=2)
    ckpt = os.path.join(cfg.checkpoint_dir, "oc_bcd_epoch.npz")
    loaded = durable.load_npz(ckpt)
    print("RESUME " + json.dumps({"from_epoch": None if loaded is None else int(loaded[0]["epoch"]) + 1}),
          flush=True)
    save = durable.save_npz

    def recorded_save(path, arrays, **kw):
        rec = {"epoch": int(arrays["epoch"]) if "epoch" in arrays else None, "launches": dict(fk.LAUNCHES),
               "faults": faults.stats(),
               "survived": {s: metrics.REGISTRY.counter_value(c) for s, c in SURVIVED_BY.items()},
               "materialize_fallbacks": materialize["fallbacks"]}
        print("STATS " + json.dumps(rec), flush=True)
        return save(path, arrays, **kw)

    durable.save_npz = recorded_save
    reloaded = []
    load_rule = WS.SavedStateLoadRule.apply

    def recorded_apply(self, graph, device=None):
        seen = len(self.reloaded)
        graph = load_rule(self, graph, device=device)
        reloaded.extend(self.reloaded[seen:])
        return graph

    WS.SavedStateLoadRule.apply = recorded_apply
    PipelineEnv.node_retries = 1
    fk.reset_launches()
    t0 = time.perf_counter()
    fitted, attempts = fit_with_recovery(lambda: streamed_build(P, dev, cfg), state_dir=os.path.join(work, "state"))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(fk.LAUNCHES)
    arrays = fitted_arrays(fitted, held_out_images(dev))
    np.savez(os.path.join(work, "fitted.npz"), **arrays)
    print("DONE " + json.dumps({"attempts": attempts, "fit_seconds": fit_s, "launches_fit": fit_launches,
                                "launches": dict(fk.LAUNCHES), "reloaded_prefixes": reloaded,
                                "faults": faults.stats(), "materialize": materialize}), flush=True)
    return 0


def fit_setup_config(P):
    return P.Config(num_classes=FIT_CLASSES, synthetic_n=FIT_N, image_size=IMAGE_HW, gmm_k=FIT_GMM_K,
                    pca_dims=PCA_DIMS, num_epochs=FIT_EPOCHS, solver_block_size=FIT_BLOCK)


def run_child(work, env_extra, timeout=900):
    """This script's ``--recovery-child`` mode in a process of its own,
    with the environment's plan and ledger replaced by ``env_extra``."""
    env = {k: v for k, v in os.environ.items() if k not in ("KEYSTONE_FAULTS", "KEYSTONE_OBS_DIR")}
    env.update(env_extra)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--recovery-child", work],
                         capture_output=True, text=True, timeout=timeout, env=env, cwd=str(REPO))
    lines = {}
    for ln in out.stdout.splitlines():
        key, _, rest = ln.partition(" ")
        if key in ("RESUME", "STATS", "DONE"):
            lines.setdefault(key, []).append(json.loads(rest))
    return out, lines, time.perf_counter() - t0


def ledger_counts(directory) -> dict:
    """Span and event counts by name over a ledger directory's runs."""
    counts = {"spans": {}, "events": {}, "runs": 0}
    for path in sorted(Path(directory).glob("run_*.jsonl")):
        counts["runs"] += 1
        for ln in path.read_text().splitlines():
            e = json.loads(ln)
            key = {"span_start": "spans", "event": "events"}.get(e["kind"])
            if key:
                counts[key][e["name"]] = counts[key].get(e["name"], 0) + 1
    return counts


def bitwise(label, got: dict, want: dict) -> dict:
    """Each array of ``got`` against ``want``'s: their largest differences,
    and a check that all are 0."""
    diffs = {k: float(np.abs(got[k].astype(np.float64) - want[k].astype(np.float64)).max()) for k in want}
    check(set(got) == set(want), f"{label}: arrays {sorted(got)} vs {sorted(want)}")
    print(f"  {label}: largest differences {diffs}", flush=True)
    check(all(np.array_equal(got[k], want[k]) for k in want), f"{label}: not bit for bit")
    return diffs


def hooks_at_rest(dev, card, P, fk, stream_out, tmp):
    """The streamed fit three ways (nothing attached, a run ledger, an empty
    fault plan), each timed with its B1/B2 launches; the first is the
    uninterrupted fit the recovery is held to."""
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.obs import ledger

    cfg = dataclasses.replace(fit_setup_config(P), stream=True, stream_batch_size=STREAM_BATCH)
    vx = held_out_images(dev)
    out, arrays = {}, {}
    for mode in ("nothing attached", "a run ledger", "an empty fault plan"):
        with phase(f"operations: the streamed fit with {mode}"):
            ctx = contextlib.nullcontext()
            if mode == "a run ledger":
                ledger.start_run(str(tmp / "ledger"))
            elif mode == "an empty fault plan":
                ctx = faults.inject(faults.FaultPlan([]))
            torch.cuda.synchronize()
            fk.reset_launches()
            try:
                with ctx:
                    t0 = time.perf_counter()
                    fitted = streamed_build(P, dev, cfg).fit()
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
            finally:
                ledger.stop_run()
            fit_l = dict(fk.LAUNCHES)
            arrays[mode] = fitted_arrays(fitted, vx)
            launches = dict(fk.LAUNCHES)
            print(f"  Pipeline.fit {secs:.4f} s with {mode} (phase 10: {stream_out['fit_seconds']:.4f} s); "
                  f"launches fit {fit_l}, with scoring {launches} ({card})", flush=True)
            check(fit_l == fv_launches(encode=2 * -(-FIT_N // STREAM_BATCH)), f"fit launches {fit_l}")
            out[mode] = {"fit_seconds": secs, "launches_fit": fit_l, "launches": launches}
            del fitted
    ratio = out["nothing attached"]["fit_seconds"] / stream_out["fit_seconds"]
    print(f"  nothing attached / phase 10: {ratio:.4f} (within 1/{HOOK_RATIO} .. {HOOK_RATIO}); ledger "
          f"{out['a run ledger']['fit_seconds'] / out['nothing attached']['fit_seconds']:.4f}x, empty plan "
          f"{out['an empty fault plan']['fit_seconds'] / out['nothing attached']['fit_seconds']:.4f}x of it",
          flush=True)
    check(1 / HOOK_RATIO <= ratio <= HOOK_RATIO, f"the inert streamed fit took {ratio:.3f}x phase 10's")
    led = ledger_counts(tmp / "ledger")
    print(f"  the ledger of the observed fit: {led}", flush=True)
    check(led["spans"].get("pipeline.fit") == 1 and led["spans"].get("solver.spill") == 1,
          f"ledger spans {led['spans']}")
    check(led["events"].get("solver.epoch", 0) >= FIT_EPOCHS, f"ledger events {led['events']}")
    out["ledger"] = led
    for mode in ("a run ledger", "an empty fault plan"):
        bitwise(f"the fit with {mode} against the one with nothing attached", arrays[mode],
                arrays["nothing attached"])
    return out, arrays["nothing attached"]


def recovery_path(card, tmp, reference):
    """The recovered fit: attempt 1 under the plan, killed at its second
    epoch checkpoint; attempt 2 relaunched with the same directories."""
    work, obs = tmp / "work", tmp / "obs"
    work.mkdir()
    out = {}
    with phase("operations: fit_with_recovery, attempt 1 under the fault plan (killed at a checkpoint)"):
        p1, l1, s1 = run_child(str(work), {"KEYSTONE_FAULTS": RECOVERY_PLAN, "KEYSTONE_OBS_DIR": str(obs)})
        stats = l1.get("STATS", [])
        print(f"  exit code {p1.returncode} after {s1:.2f} s; saves seen {len(stats)}; last record "
              f"{stats[-1] if stats else None}", flush=True)
        check(p1.returncode == RECOVERY_EXIT, f"attempt 1 exited {p1.returncode}: {p1.stderr[-3000:]}")
        check("DONE" not in l1 and len(stats) == 2, f"attempt 1 records {l1}")
        last = stats[-1]
        for site, survived in last["survived"].items():
            inj = last["faults"].get(site, {}).get("injected", 0)
            print(f"  {site}: injected {inj}, survived {survived:.0f}", flush=True)
            check(inj == survived > 0, f"{site}: injected {inj}, survived {survived}")
        # the record precedes the killing save: one save made, none injected
        check(last["faults"]["ckpt.save"] == {"calls": 1, "injected": 0}, f"ckpt.save {last['faults']}")
        check(last["epoch"] == 1 and stats[0]["epoch"] == 0, f"saves {[s['epoch'] for s in stats]}")
        check(last["materialize_fallbacks"] == 0, "attempt 1's fit took the structural materialization fallback")
        out["attempt_1"] = {"exit_code": p1.returncode, "seconds": s1, "faults_at_kill": last["faults"],
                            "survived": last["survived"], "launches_at_kill": last["launches"]}
    with phase("operations: fit_with_recovery, attempt 2 relaunched (resumes the BCD from epoch 1)"):
        p2, l2, s2 = run_child(str(work), {"KEYSTONE_OBS_DIR": str(obs)})
        check(p2.returncode == 0, f"attempt 2 exited {p2.returncode}: {p2.stderr[-3000:]}")
        done, resume = l2["DONE"][0], l2["RESUME"][0]
        print(f"  {s2:.2f} s; resumed from epoch {resume['from_epoch']}; saves {len(l2.get('STATS', []))}; "
              f"launches in the fit {done['launches_fit']}, with scoring {done['launches']}; prefixes "
              f"reloaded {done['reloaded_prefixes']}; faults {done['faults']} ({card})", flush=True)
        check(resume["from_epoch"] == 1 and len(l2.get("STATS", [])) == 1, f"attempt 2 {resume} {l2.get('STATS')}")
        check(done["materialize"]["passes"] > 0 and done["materialize"]["fallbacks"] == 0,
              f"attempt 2's profiled materialization {done['materialize']}")
        check(done["launches_fit"] == fv_launches(encode=2 * -(-FIT_N // STREAM_BATCH)),
              f"attempt 2 fit launches {done['launches_fit']}")
        got = dict(np.load(work / "fitted.npz"))
        out["attempt_2"] = {"seconds": s2, "fit_seconds": done["fit_seconds"], "resumed_from_epoch": 1,
                            "launches_fit": done["launches_fit"], "launches": done["launches"],
                            "reloaded_prefixes": done["reloaded_prefixes"],
                            "max_abs_diff": bitwise("the resumed fit against the uninterrupted fit", got, reference)}
        led = ledger_counts(obs)
        print(f"  the ledger over both attempts: {led}", flush=True)
        check(led["runs"] == 2 and led["spans"].get("pipeline.fit") == 2, f"ledger {led}")
        check(led["events"].get("executor.retry", 0) == 1, f"ledger events {led['events']}")
        out["ledger"] = led
        out["launches"] = {k: out["attempt_1"]["launches_at_kill"].get(k, 0) + done["launches"].get(k, 0)
                           for k in done["launches"]}
    return out


def checkpointed_bcd_path(dev, card):
    """The in-core fit_checkpointed at the fit leg's BCD geometry: an
    uninterrupted fit, one interrupted at its epoch-2 save and resumed,
    one whose newest checkpoint is damaged and which falls back."""
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.workflow.dataset import Dataset

    rng = np.random.default_rng(11)
    x = Dataset(torch.from_numpy(rng.normal(size=(CKPT_N, CKPT_D)).astype(np.float32)).to(dev))
    lab = rng.integers(0, FIT_CLASSES, CKPT_N)
    y = -np.ones((CKPT_N, FIT_CLASSES), np.float32)
    y[np.arange(CKPT_N), lab] = 1.0
    y = Dataset(torch.from_numpy(y).to(dev))
    est = BlockLeastSquaresEstimator(block_size=FIT_BLOCK, num_iter=FIT_EPOCHS, lam=1e-4)
    tmp = Path(tempfile.mkdtemp(prefix="ckpt_bcd_", dir=REPO))
    out = {}
    try:
        with phase("operations: the in-core fit_checkpointed (2048 x 16384, blocks of 4096, 2 epochs)"):
            metrics.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = est.fit_checkpointed(x, y, str(tmp / "a"))
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            saves = metrics.snapshot()["histograms"]["solver.checkpoint_save_seconds"]
            with faults.inject("ckpt.save:after=1:times=3:raise"):
                try:
                    est.fit_checkpointed(x, y, str(tmp / "b"))
                    check(False, "the ckpt.save raise did not stop the fit")
                except faults.FaultInjected:
                    pass
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resumed = est.fit_checkpointed(x, y, str(tmp / "b"))
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            with faults.inject("ckpt.save:after=1:times=1:corrupt"):
                est.fit_checkpointed(x, y, str(tmp / "c"))
            fallback = est.fit_checkpointed(x, y, str(tmp / "c"))
            e1 = float((resumed.weights - ref.weights).abs().max())
            e2 = float((fallback.weights - ref.weights).abs().max())
            print(f"  uninterrupted {fit_s:.4f} s ({saves['count']} saves, {saves['sum']:.4f} s in all of "
                  f"{FIT_EPOCHS} x {(CKPT_D * FIT_CLASSES + CKPT_N * FIT_CLASSES) * 4} bytes); resumed after "
                  f"epoch 1 in {resume_s:.4f} s; resumed vs uninterrupted {e1:.3e}, fallback vs uninterrupted "
                  f"{e2:.3e} ({card})", flush=True)
            check(torch.equal(resumed.weights, ref.weights) and torch.equal(resumed.intercept, ref.intercept),
                  "the resumed in-core fit is not the uninterrupted one bit for bit")
            check(torch.equal(fallback.weights, ref.weights), "the fallback fit is not the uninterrupted one")
            out = {"fit_seconds": fit_s, "resume_seconds": resume_s, "saves": saves["count"],
                   "save_seconds": saves["sum"], "resumed_max_abs_diff": e1, "fallback_max_abs_diff": e2}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def lbfgs_checkpoint_path(dev, card, ls_problem):
    """The checkpointed L-BFGS at the text apps' shapes: the sparse fit on
    Newsgroups' ls rows (``ls_problem``: the rows, ±1 labels and λ of the
    newsgroups phase) and the dense fit on MnistRandomFFT's features, each
    interrupted at a checkpoint save and resumed."""
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.loaders.mnist import MnistLoader
    from keystone_tpu_torch.models import lbfgs
    from keystone_tpu_torch.models.lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
    from keystone_tpu_torch.ops.sparse import BucketedSparseRows
    from keystone_tpu_torch.ops.util import ClassLabelIndicators
    from keystone_tpu_torch.pipelines import mnist_random_fft as M
    from keystone_tpu_torch.workflow.dataset import Dataset

    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="ckpt_lbfgs_", dir=REPO))

    def timed(fn):
        torch.cuda.synchronize()
        lbfgs.reset_stats()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, dict(lbfgs.STATS)

    try:
        with phase("operations: the checkpointed sparse L-BFGS on Newsgroups' ls rows"):
            rows, y, lam = ls_problem
            sp = BucketedSparseRows.from_scipy_rows(rows, device=dev)
            est = SparseLBFGSwithL2(lam=lam, num_iterations=100, fit_intercept=False)
            plain = [timed(lambda: est.fit_sparse(sp, y)) for _ in range(2)]
            spread = float((plain[0][0].weights - plain[1][0].weights).abs().max())
            scale = float(plain[0][0].weights.abs().max())
            ref, ref_s, ref_stats = timed(lambda: est.fit_sparse(sp, y, checkpoint_dir=str(tmp / "s0"),
                                                                  checkpoint_every=SPARSE_EVERY))
            twice, _, _ = timed(lambda: est.fit_sparse(sp, y, checkpoint_dir=str(tmp / "s1"),
                                                       checkpoint_every=SPARSE_EVERY))
            with faults.inject("ckpt.save:after=4:times=3:raise"):
                try:
                    est.fit_sparse(sp, y, checkpoint_dir=str(tmp / "s2"), checkpoint_every=SPARSE_EVERY)
                    check(False, "the ckpt.save raise did not stop the sparse fit")
                except faults.FaultInjected:
                    pass
            resumed, res_s, res_stats = timed(lambda: est.fit_sparse(sp, y, checkpoint_dir=str(tmp / "s2"),
                                                                     checkpoint_every=SPARSE_EVERY))
            e = float((resumed.weights - ref.weights).abs().max())
            print(f"  {len(rows)} rows x {sp.num_features}: two plain fits {plain[0][1]:.3f} and {plain[1][1]:.3f} s "
                  f"(trials {plain[0][2]['trials']}, {plain[1][2]['trials']}), apart by {spread:.3e} "
                  f"({spread / scale:.3e} of the largest weight {scale:.3e}); the checkpointed fit (a fixed "
                  f"scatter order) {ref_s:.3f} s, {ref_stats}; twice apart by "
                  f"{float((twice.weights - ref.weights).abs().max()):.3e}; interrupted at the iteration-50 save "
                  f"and resumed from iteration 40 in {res_s:.3f} s ({res_stats['iterations']} iterations run), apart by {e:.3e} ({card})", flush=True)
            check(torch.equal(twice.weights, ref.weights), "two checkpointed sparse fits differ")
            check(torch.equal(resumed.weights, ref.weights), "the resumed sparse fit is not bit for bit")
            out["sparse"] = {"rows": len(rows), "features": sp.num_features, "plain_seconds": [p[1] for p in plain],
                             "plain_trials": [p[2]["trials"] for p in plain], "plain_spread": spread,
                             "plain_spread_rel": spread / scale, "checkpointed_seconds": ref_s,
                             "checkpointed_stats": ref_stats, "resume_seconds": res_s, "resumed_max_abs_diff": e}
            del sp, rows
        with phase("operations: the checkpointed dense L-BFGS on MnistRandomFFT's features (60000 x 4104)"):
            mn = MnistLoader.synthetic(MNIST_N, seed=1, device=dev)
            cfg = M.Config()
            feats = M.MnistRandomFFT.featurizer(cfg, mn.data.item_shape[0], dev)(mn.data).get()
            labels = ClassLabelIndicators(10)(mn.labels)
            check(tuple(feats.array.shape) == (MNIST_N, 4104), f"MNIST features {tuple(feats.array.shape)}")
            est = DenseLBFGSwithL2(lam=LBFGS_LAM, num_iterations=LBFGS_ITERS, history=LBFGS_HISTORY)
            ref, ref_s, ref_stats = timed(lambda: est.fit_checkpointed(feats, labels, checkpoint_dir=str(tmp / "d0"),
                                                                       checkpoint_every=LBFGS_EVERY))
            with faults.inject("ckpt.save:after=1:times=3:raise"):
                try:
                    est.fit_checkpointed(feats, labels, checkpoint_dir=str(tmp / "d1"), checkpoint_every=LBFGS_EVERY)
                    check(False, "the ckpt.save raise did not stop the dense fit")
                except faults.FaultInjected:
                    pass
            resumed, res_s, res_stats = timed(lambda: est.fit_checkpointed(
                feats, labels, checkpoint_dir=str(tmp / "d1"), checkpoint_every=LBFGS_EVERY))
            e = float((resumed.weights - ref.weights).abs().max())
            print(f"  uninterrupted {ref_s:.3f} s, {ref_stats}; interrupted at the iteration-10 save and resumed "
                  f"from iteration 5 in {res_s:.3f} s "
                  f"({res_stats['iterations']} iterations run); apart by {e:.3e} ({card})", flush=True)
            check(torch.equal(resumed.weights, ref.weights), "the resumed dense fit is not bit for bit")
            out["dense"] = {"fit_seconds": ref_s, "stats": ref_stats, "resume_seconds": res_s,
                            "resumed_max_abs_diff": e}
            del feats, mn
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def oc_krr_sweep_fault_path(dev, card, gk, data):
    """The out-of-core KRR at the KRR geometry under ``kernel.sweep``: an
    uninterrupted checkpointed fit, one interrupted at a diagonal step of
    epoch 2 and resumed from epoch 1, then a damaged newest checkpoint
    falling back; every α bit for bit the uninterrupted one's."""
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.models import kernel_ridge as KR
    from keystone_tpu_torch.workflow.blockstore import RowBlockStore
    from keystone_tpu_torch.workflow.dataset import Dataset

    tmp = Path(tempfile.mkdtemp(prefix="krr_sweep_", dir=REPO))
    nb = KRR_N // KRR_BLOCK
    est = KR.KernelRidgeRegressionEstimator(KR.GaussianKernelGenerator(KRR_GAMMA), lam=KRR_LAM,
                                            block_size=KRR_BLOCK, num_epochs=KRR_EPOCHS)
    try:
        with phase("operations: the out-of-core KRR under kernel.sweep (n=8192, d=256, blocks of 512, 2 epochs)"):
            store = RowBlockStore.from_array(str(tmp / "rows"), data[0], KRR_BLOCK)
            labels = Dataset(data[1])
            gk.reset_launches()
            ref = est.fit_store(store, labels, checkpoint_dir=str(tmp / "a")).alpha
            faults.reset_stats()
            with faults.inject(f"kernel.sweep:after={nb + 3}:times=1:raise"):
                try:
                    est.fit_store(store, labels, checkpoint_dir=str(tmp / "b"))
                    check(False, "the kernel.sweep raise did not stop the sweep")
                except faults.FaultInjected:
                    pass
            interrupted = faults.stats()["kernel.sweep"]
            faults.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resumed = est.fit_store(store, labels, checkpoint_dir=str(tmp / "b")).alpha
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            steps = faults.stats()["kernel.sweep"]["calls"]
            with faults.inject("ckpt.save:after=1:times=1:corrupt"):
                est.fit_store(store, labels, checkpoint_dir=str(tmp / "c"))
            fallback = est.fit_store(store, labels, checkpoint_dir=str(tmp / "c")).alpha
            launches = gk.LAUNCHES["gram_block"]
            print(f"  the fault at diagonal step {nb + 4} ({interrupted}); the resumed sweep ran {steps} diagonal "
                  f"steps in {resume_s:.4f} s; α resumed vs uninterrupted "
                  f"{float((resumed - ref).abs().max()):.3e}, fallback {float((fallback - ref).abs().max()):.3e}; "
                  f"B3 launches {launches} ({card})", flush=True)
            check(interrupted == {"calls": nb + 4, "injected": 1}, f"kernel.sweep {interrupted}")
            check(steps == nb, f"the resumed sweep ran {steps} diagonal steps, not epoch 2's {nb}")
            check(torch.equal(resumed, ref) and torch.equal(fallback, ref), "α is not the uninterrupted one")
            check(launches > 0, "B3 never launched")
            return {"launches": launches, "interrupted_at_step": nb + 4, "resume_seconds": resume_s,
                    "resumed_steps": steps}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def deadline_breaker_path(dev, card, P, stream_seconds):
    """Pipeline.fit(deadline=...) far below the streamed fit's time raises
    within the slack, and the next fit on the device equals the one before
    bit for bit; a hung stage under a deadline gives the allocator its
    memory back; an optional stage past KEYSTONE_BREAKER_THRESHOLD opens
    its breaker and degrades to its fallback."""
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator, BlockLinearMapper
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.ops.stats import LinearRectifier
    from keystone_tpu_torch.utils import guard
    from keystone_tpu_torch.workflow.dataset import Dataset
    from keystone_tpu_torch.workflow.pipeline import Pipeline, PipelineEnv
    from keystone_tpu_torch.workflow.transformer import Transformer

    out = {}
    rng = np.random.default_rng(13)
    x = Dataset(torch.from_numpy(rng.normal(size=(CKPT_N, CKPT_D)).astype(np.float32)).to(dev))
    y = Dataset(torch.from_numpy(rng.normal(size=(CKPT_N, FIT_CLASSES)).astype(np.float32)).to(dev))
    est = BlockLeastSquaresEstimator(block_size=FIT_BLOCK, num_iter=FIT_EPOCHS, lam=1e-4)
    cfg = dataclasses.replace(fit_setup_config(P), stream=True, stream_batch_size=STREAM_BATCH)
    with phase("operations: the streamed Pipeline.fit(deadline=...) below its time, then the next fit"):
        check(DEADLINE_BUDGET * 5 < stream_seconds, f"the budget {DEADLINE_BUDGET} s is not far below the fit's "
              f"{stream_seconds:.1f} s")
        ref = est.with_data(x, y).fit().block_until_ready()
        pipe = streamed_build(P, dev, cfg)
        t0 = time.perf_counter()
        try:
            pipe.fit(deadline=DEADLINE_BUDGET)
            check(False, "the deadline did not fire")
        except guard.DeadlineExceeded as e:
            raised = time.perf_counter() - t0
            site, worker = str(e), e.worker
        t0 = time.perf_counter()
        if worker is not None:
            worker.join(120.0)
            check(not worker.is_alive(), "the abandoned stage never finished")
        torch.cuda.synchronize()
        drained = time.perf_counter() - t0
        after = est.with_data(x, y).fit().block_until_ready()
        wr, wa = split_at(ref, BlockLinearMapper)[1], split_at(after, BlockLinearMapper)[1]
        print(f"  the streamed fit {stream_seconds:.4f} s; budget {DEADLINE_BUDGET} s raised after {raised:.4f} s "
              f"({site}; slack {DEADLINE_SLACK} s); the abandoned stage drained in {drained:.4f} s; the next fit "
              f"equal to the one before bit for bit: {torch.equal(wr.weights, wa.weights)} ({card})", flush=True)
        check(raised <= DEADLINE_BUDGET + DEADLINE_SLACK, f"the deadline raised after {raised:.3f} s")
        check(torch.equal(wr.weights, wa.weights), "the fit after the deadline differs")
        out["deadline"] = {"fit_seconds": stream_seconds, "budget": DEADLINE_BUDGET, "raised_after": raised,
                           "drained_seconds": drained}
        del pipe
    with phase("operations: a hung stage under a deadline leaves no memory behind"):
        os.environ[guard.ENV_HANG_SECONDS] = "2"
        try:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            with faults.inject("executor.stage:after=2:times=1:hang"):
                try:
                    est.with_data(x, y).fit(deadline=0.5)
                    check(False, "the hung stage did not raise")
                except guard.DeadlineExceeded as e:
                    if e.worker is not None:
                        e.worker.join(30.0)
            gc.collect()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - before
        finally:
            del os.environ[guard.ENV_HANG_SECONDS]
        print(f"  device memory allocated after the hung attempt, less before it: {held} bytes", flush=True)
        check(held <= 0, f"the hung attempt left {held} bytes allocated")
        out["hang_bytes_held"] = held

    class Failing(Transformer):
        """A stage that fails on the card every time."""

        def apply_batch(self, xs, mask=None):
            raise OSError("failing stage")

    with phase("operations: an optional stage's breaker opens and it degrades to its fallback"):
        os.environ[guard.ENV_BREAKER_THRESHOLD] = str(BREAKER_THRESHOLD)
        guard.reset_breakers()
        metrics.reset()
        try:
            pipe = Pipeline.of(Failing().with_fallback(LinearRectifier(0.0)))
            want = LinearRectifier(0.0).apply_batch(x.array[:256])
            outs = []
            for _ in range(3):
                PipelineEnv.node_retries = 1
                try:
                    outs.append(pipe(Dataset(x.array[:256])).get().array)
                finally:
                    PipelineEnv.node_retries = None
            opens = metrics.REGISTRY.counter_total("breaker.opens")
            degraded = metrics.REGISTRY.counter_total("executor.degraded")
        finally:
            del os.environ[guard.ENV_BREAKER_THRESHOLD]
            guard.reset_breakers()
        print(f"  three runs: breaker opens {opens:.0f}, degraded {degraded:.0f}; outputs equal the fallback's: "
              f"{all(torch.equal(o, want) for o in outs)}", flush=True)
        check(opens == 1 and degraded == 3, f"breaker opens {opens}, degraded {degraded}")
        check(all(torch.equal(o, want) for o in outs), "a degraded output is not the fallback's")
        out["breaker"] = {"opens": opens, "degraded": degraded}
    return out


def operations_path(dev, card, P, fk, gk, stream_out, krr, ls_problem):
    """The operations layer's phases, in order: hooks at rest, the recovered
    streamed fit, the in-core checkpointed BCD, the checkpointed L-BFGS,
    the out-of-core KRR under kernel.sweep, deadlines and breakers."""
    tmp = Path(tempfile.mkdtemp(prefix="operations_", dir=REPO))
    try:
        out, reference = hooks_at_rest(dev, card, P, fk, stream_out, tmp)
        out["recovery"] = recovery_path(card, tmp, reference)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["fv_launches"] = {k: sum(out[m]["launches"].get(k, 0) for m in
                                 ("nothing attached", "a run ledger", "an empty fault plan"))
                          + out["recovery"]["launches"].get(k, 0) for k in ("fisher_encode", "fused_forward")}
    out["checkpointed_bcd"] = checkpointed_bcd_path(dev, card)
    out["lbfgs_checkpoint"] = lbfgs_checkpoint_path(dev, card, ls_problem)
    out["oc_krr_sweep_fault"] = oc_krr_sweep_fault_path(dev, card, gk, krr)
    out["deadlines_breakers"] = deadline_breaker_path(dev, card, P, out["nothing attached"]["fit_seconds"])
    return out


# ---- serving (the serving slice): the full-width scorer behind serve() on
# the card.  Flushes pad to buckets of 8..128 rows; B1 runs twice a flush
# (one launch a branch), B2 never.  Served rows against the offline
# scorer(x) on the same images: the padded batch changes the BLM product's
# shape in cuBLAS, so scores need not match bit for bit: they are held at
# B1's stated tolerance (2e-5 + 1e-5·|ref|, TOL_SERVE_SCORES), and top-5
# ids must be equal, or differ only where the offline scores of the
# swapped classes lie within that tolerance (a near-tie, counted)
SERVE_BUCKETS = (8, 16, 32, 64, 128)
SERVE_CLIENTS = 8
SERVE_SAT_N = 4096  # saturation: 8 client threads, 32 requests outstanding each
SERVE_SAT_WINDOW = 32
SERVE_LOW_N = 512  # low concurrency: 8 client threads, one request outstanding each
SERVE_PROFILED_N = 1024  # the saturation window traced for the idle share
SERVE_BLOCKS, SERVE_BLOCK = 4, 50  # submit_batch calls
SERVE_WAIT_MS = 1.0
TOL_SERVE_SCORES, RTOL_SERVE_SCORES = 2e-5, 1e-5
SERVE_FWD_N = 256  # the unfused bench forward behind serve(): B2
SERVE_HTTP_N = 128  # held-out images POSTed to `cli serve`
SERVE_HTTP_MAX_BATCH = 16
SERVE_RESULT_S = 120.0  # the bound of every wait on a served future
SERVE_S4_FRACTIONS = (0.5, 0.9)  # open-loop offered load, fractions of S1's saturation rate
SERVE_S4_SECONDS = 3.0
SERVE_S4_BURST = 8
SERVE_S4_DEADLINE_MS = 250.0


def serve_closed_loop(svc, rows, n, window, clients=SERVE_CLIENTS, submit=None):
    """``clients`` threads submit rows[i % len(rows)] for i < n, each keeping
    ``window`` requests outstanding (closed loop).  Returns (outputs by
    index, latency seconds by index, wall seconds)."""
    import threading

    submit = submit or svc.submit
    outs, lat = [None] * n, [0.0] * n
    nxt = iter(range(n))
    lock = threading.Lock()
    errors = []

    def client():
        pending = []
        while True:
            while len(pending) < window:
                with lock:
                    i = next(nxt, None)
                if i is None:
                    break
                t0 = time.perf_counter()
                try:
                    fut = submit(rows[i % len(rows)])
                except Exception as e:  # reported below
                    errors.append(e)
                    return

                def done(f, i=i, t0=t0):
                    lat[i] = time.perf_counter() - t0

                fut.add_done_callback(done)
                pending.append((i, fut))
            if not pending:
                return
            i, fut = pending.pop(0)
            try:
                outs[i] = fut.result(timeout=SERVE_RESULT_S)
            except Exception as e:  # reported below
                errors.append(e)
                return

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE_RESULT_S * 2)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a serve client thread hung")
    check(not errors, f"served requests failed: {errors[:3]}")
    return outs, np.asarray(lat), wall


def serve_counters(metrics_mod) -> dict:
    reg = metrics_mod.REGISTRY
    return {k: reg.counter_total(f"serve.{k}") for k in ("batches", "completed", "shed", "batch_errors")}


def top5_check(label, served, offline_ids, offline_scores):
    """Served top-5 ids against the offline scorer's: equal, or a near-tie
    (every served id scores within TOL_SERVE_SCORES of the offline 5th
    score or above it, in order within it)."""
    served = np.asarray(served)
    equal = (served == offline_ids).all(axis=1)
    ties = 0
    for r in np.nonzero(~equal)[0]:
        s, ids = offline_scores[r], served[r]
        tol = TOL_SERVE_SCORES + RTOL_SERVE_SCORES * np.abs(s[ids])
        ok = (s[ids] >= s[offline_ids[r][-1]] - tol).all() and (s[ids][:-1] >= s[ids][1:] - tol[1:]).all()
        check(bool(ok), f"{label}: served top-5 {ids} on image {r} is not the offline {offline_ids[r]} "
                        f"within the tolerance")
        ties += 1
    print(f"  {label}: top-5 ids equal on {int(equal.sum())} of {len(equal)} requests, near-ties {ties}", flush=True)
    return {"equal": int(equal.sum()), "near_ties": ties, "n": int(len(equal))}


def serve_path(dev, card, P, fk, scorer, forward, images, float_batches, b1_args):
    """S1 and S1b: the full-width scorer, then the unfused bench forward,
    behind serve() on the card, one replica; B1 at the smallest and largest
    bucket against its plain version on the served scorer's weights."""
    from torch.profiler import ProfilerActivity, profile

    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.serve import RowBlock, serve
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    out = {}
    imgs = images.cpu().numpy()
    with phase("serve S1: B1 at the smallest and largest bucket on the served scorer's weights"):
        out["b1_buckets"] = {}
        for rows in (SERVE_BUCKETS[0], SERVE_BUCKETS[-1]):
            x = images[:rows]
            errs = [compare(f"B1 at the {rows}-row bucket, {name}", fk.fused_forward(*a), fk.fused_forward_ref(*a),
                            TOL_FUSED) for name, a in b1_args(x)]
            out["b1_buckets"][rows] = max(errs)
        torch.cuda.synchronize()
    with phase("serve S1: the offline scorer on the served images"):
        off_ids = torch.cat([scorer(b) for b in images.split(BATCH)]).cpu().numpy()
        off_scores = torch.cat([P.scores_of(scorer)(b) for b in images.split(BATCH)]).cpu().numpy()
        torch.cuda.synchronize()
    with phase("serve S1: the full-width scorer behind serve() (one replica, buckets 8..128)"):
        t0 = time.perf_counter()
        svc = serve(Pipeline.of(scorer).freeze(device=dev), max_batch=BATCH, buckets=SERVE_BUCKETS,
                    max_wait_ms=SERVE_WAIT_MS, queue_bound=4 * SERVE_CLIENTS * SERVE_SAT_WINDOW, example=imgs[0], name="s1")
        print(f"  built and primed ({len(SERVE_BUCKETS)} buckets) in {time.perf_counter() - t0:.2f} s", flush=True)
        try:
            rep = svc._pool.replicas[0]
            check(rep.device.type == dev.type and (rep.stream is not None) == (dev.type == "cuda"),
                  f"replica on {rep.device}, stream {rep.stream}")
            torch.cuda.synchronize()
            fk.reset_launches()
            c0 = serve_counters(metrics)
            regimes = {}
            for regime, n, window in (("saturation", SERVE_SAT_N, SERVE_SAT_WINDOW), ("low", SERVE_LOW_N, 1)):
                r0 = serve_counters(metrics)
                outs, lat, wall = serve_closed_loop(svc, imgs, n, window)
                r1 = serve_counters(metrics)
                flushes = r1["batches"] - r0["batches"]
                regimes[regime] = {
                    "requests": n, "clients": SERVE_CLIENTS, "outstanding_per_client": window, "seconds": wall,
                    "images_per_s": n / wall, "flushes": flushes, "requests_per_flush": n / max(1, flushes),
                    "p50_ms": float(np.percentile(lat, 50) * 1e3), "p99_ms": float(np.percentile(lat, 99) * 1e3),
                    "top5": top5_check(f"{regime} ({n} requests)", outs, off_ids[np.arange(n) % len(imgs)],
                                       off_scores[np.arange(n) % len(imgs)]),
                }
                print(f"  {regime}: {n} requests from {SERVE_CLIENTS} threads ({window} outstanding each) in "
                      f"{wall:.3f} s: {n / wall:.1f} images/s, {flushes} flushes, {n / max(1, flushes):.2f} "
                      f"requests a flush, latency p50 {regimes[regime]['p50_ms']:.3f} ms, p99 "
                      f"{regimes[regime]['p99_ms']:.3f} ms ({card})", flush=True)
            block_outs = []
            for j in range(SERVE_BLOCKS):
                rows = imgs[j * SERVE_BLOCK:(j + 1) * SERVE_BLOCK]
                block_outs += [f.result(timeout=SERVE_RESULT_S) for f in svc.submit_batch(RowBlock(rows))]
            regimes["submit_batch"] = {"top5": top5_check(f"{SERVE_BLOCKS} submit_batch calls of {SERVE_BLOCK}",
                                                          block_outs, off_ids[:len(block_outs)],
                                                          off_scores[:len(block_outs)])}
            torch.cuda.synchronize()
            c1 = serve_counters(metrics)
            launches = dict(fk.LAUNCHES)
            flushes = c1["batches"] - c0["batches"]
            print(f"  launches {launches} over {flushes} flushes", flush=True)
            check(launches == fv_launches(fused=2 * flushes), f"launches {launches}: expected B1 twice a flush, no B2")
            check(c1["shed"] == c0["shed"] and c1["batch_errors"] == c0["batch_errors"], "a request was shed or failed")
            # the idle share: device busy time (profiler, CUDA activity only)
            # against host-clock time, per flush, at the 128- and 8-row buckets
            idle = {}
            for regime, n, window in (("saturation", SERVE_PROFILED_N, SERVE_SAT_WINDOW),
                                      ("low concurrency", SERVE_PROFILED_N // 4, 1)):
                r0 = serve_counters(metrics)
                seen = {b["batch"] for b in svc.recorder.dump()["batches"]}
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    _, _, wall = serve_closed_loop(svc, imgs, n, window)
                    torch.cuda.synchronize()
                fl = serve_counters(metrics)["batches"] - r0["batches"]
                # the buckets this window's flushes padded to (the recorder's batch records)
                mix = {}
                for b in svc.recorder.dump()["batches"]:
                    if b["batch"] not in seen and "bucket" in b:
                        mix[b["bucket"]] = mix.get(b["bucket"], 0) + 1
                busy = device_busy_ms(prof)
                # one replica, one stream: busy time past the wall means kernels counted twice
                check(busy <= wall * 1e3 * 1.05, f"{regime}: device busy {busy:.3f} ms past the wall {wall * 1e3:.3f} ms")
                idle[regime] = {"flushes": fl, "requests_per_flush": n / max(1, fl), "buckets": mix,
                                "device_ms_per_flush": busy / fl, "wall_ms_per_flush": wall * 1e3 / fl,
                                "idle_share": 1.0 - busy / (wall * 1e3)}
                print(f"  {regime} (profiled): {fl} flushes of {n / max(1, fl):.2f} requests (flushes by bucket "
                      f"{dict(sorted(mix.items()))}), device {busy / fl:.4f} ms a flush against {wall * 1e3 / fl:.4f} "
                      f"ms of host clock, idle share {idle[regime]['idle_share']:.4f} ({card})", flush=True)
            out["s1"] = {"regimes": regimes, "idle": idle, "launches": launches, "flushes": flushes,
                         "status": {k: svc.status()[k] for k in ("latency_ms", "batch_ms", "counters")}}
            out["launches_fused_forward"] = launches["fused_forward"]
        finally:
            svc.close(timeout=SERVE_RESULT_S)
    with phase("serve S1: raw scores served (scores_of(scorer), submit_batch of 50)"):
        svc = serve(Pipeline.of(P.scores_of(scorer)).freeze(device=dev), max_batch=BATCH, buckets=SERVE_BUCKETS,
                    max_wait_ms=SERVE_WAIT_MS, example=imgs[0], name="s1_scores")
        try:
            fk.reset_launches()
            got = []
            for j in range(SERVE_BLOCKS):
                rows = imgs[j * SERVE_BLOCK:(j + 1) * SERVE_BLOCK]
                got += [f.result(timeout=SERVE_RESULT_S) for f in svc.submit_batch(RowBlock(rows))]
            got += [f.result(timeout=SERVE_RESULT_S) for f in [svc.submit(x) for x in imgs[:SERVE_BLOCK]]]
            torch.cuda.synchronize()
            n = len(got)
            ref = torch.from_numpy(np.concatenate([off_scores[:SERVE_BLOCKS * SERVE_BLOCK], off_scores[:SERVE_BLOCK]]))
            out["scores_max_abs_err"] = compare(f"{n} served raw scores against the offline scores_of(scorer)",
                                                torch.from_numpy(np.stack(got)), ref, TOL_SERVE_SCORES,
                                                RTOL_SERVE_SCORES)
            out["launches_fused_forward"] += fk.LAUNCHES["fused_forward"]
            check(fk.LAUNCHES["fisher_encode"] == 0, f"B2 launched: {dict(fk.LAUNCHES)}")
        finally:
            svc.close(timeout=SERVE_RESULT_S)
    with phase("serve S1b: the unfused bench forward behind serve() (B2 through the frozen walk)"):
        fbat = float_batches[:-(-SERVE_FWD_N // BATCH)]
        fimgs = torch.cat(fbat).cpu().numpy()
        ref = torch.cat([forward(b) for b in fbat]).cpu()
        svc = serve(Pipeline.of(forward).freeze(device=dev), max_batch=BATCH, buckets=SERVE_BUCKETS,
                    max_wait_ms=SERVE_WAIT_MS, queue_bound=4 * SERVE_CLIENTS * SERVE_SAT_WINDOW, example=fimgs[0],
                    name="s1b")
        try:
            torch.cuda.synchronize()
            fk.reset_launches()
            c0 = serve_counters(metrics)
            outs, lat, wall = serve_closed_loop(svc, fimgs, SERVE_FWD_N, SERVE_SAT_WINDOW)
            torch.cuda.synchronize()
            flushes = serve_counters(metrics)["batches"] - c0["batches"]
            launches = dict(fk.LAUNCHES)
            print(f"  {SERVE_FWD_N} requests in {wall:.3f} s ({SERVE_FWD_N / wall:.1f} images/s), {flushes} flushes, "
                  f"launches {launches} ({card})", flush=True)
            check(launches == fv_launches(encode=flushes), f"launches {launches}: expected B2 once a flush, no B1")
            compare("served bench-forward scores against the offline forward", torch.from_numpy(np.stack(outs)),
                    ref[:SERVE_FWD_N], TOL_SERVE_SCORES, RTOL_SERVE_SCORES)
            out["s1b"] = {"requests": SERVE_FWD_N, "flushes": flushes, "images_per_s": SERVE_FWD_N / wall,
                          "launches": launches}
            out["launches_fisher_encode"] = launches["fisher_encode"]
        finally:
            svc.close(timeout=SERVE_RESULT_S)
    return out


def http_call(url, payload=None, headers=None, timeout=SERVE_RESULT_S):
    """(status, body as JSON or text, headers) of one HTTP request."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw, hdrs = resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        status, raw, hdrs = e.code, e.read(), dict(e.headers)
    try:
        return status, json.loads(raw), hdrs
    except ValueError:
        return status, raw.decode(), hdrs


def serve_http_path(dev, card, graph_fitted, vx):
    """S2: the graph-fitted ImageNetSiftLcsFV model (phase 9's fit leg,
    K = 64) saved, served by ``python -m keystone_tpu_torch.cli serve`` in a
    child process on the card, and held-out images POSTed in requests of 1
    to 16 against the in-process fitted(x); the child's own launch counts
    show FvFusionRule fused at freeze (B1, no B2)."""
    import re
    import signal

    from keystone_tpu_torch.workflow.dataset import Dataset

    out = {}
    with phase("serve S2: a saved graph-fitted model through `cli serve`, over HTTP"):
        x = vx[:SERVE_HTTP_N]
        want = graph_fitted(Dataset(x)).get().numpy()
        want_scores = scores_pipeline(graph_fitted)(Dataset(x)).get().numpy()
        xf = (x.float() / 255.0).cpu().numpy()
        tmp = Path(tempfile.mkdtemp(prefix="serve_model_", dir=REPO))
        proc = None
        try:
            path = tmp / "imagenet_sift_lcs_fv.pt"
            graph_fitted.save(str(path))
            cmd = [sys.executable, "-m", "keystone_tpu_torch.cli", "serve", "--model", str(path), "--device", DEVICE,
                   "--port", "0",
                   "--max-batch", str(SERVE_HTTP_MAX_BATCH), "--max-wait-ms", "2", "--example-shape",
                   f"{IMAGE_HW},{IMAGE_HW},3"]
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(REPO),
                                    env={**os.environ, "PYTHONPATH": str(REPO)})
            line, lines = "", []
            while "serving" not in line and proc.poll() is None and time.perf_counter() - t0 < 600:
                line = proc.stdout.readline()
                lines.append(line)
            check("serving" in line, f"`cli serve` did not start: {''.join(lines)[-2000:]}")
            base = line.split(" on ", 1)[1].split(" ", 1)[0]
            status, health, _ = http_call(base + "/healthz")
            check(status == 200 and health["status"] == "ok", f"/healthz {status} {health}")
            print(f"  `cli serve` up in {time.perf_counter() - t0:.2f} s at {base}", flush=True)
            got, sizes, i, t0 = [], [], 0, time.perf_counter()
            while i < SERVE_HTTP_N:
                k = min(1 + len(sizes) % SERVE_HTTP_MAX_BATCH, SERVE_HTTP_N - i)
                rid = f"s2-{len(sizes)}"
                status, body, hdrs = http_call(base + "/predict", {"instances": xf[i:i + k].tolist()},
                                               headers={"X-Request-Id": rid})
                check(status == 200, f"/predict answered {status}: {str(body)[:300]}")
                check(hdrs.get("X-Request-Id") == rid and body["request_id"] == rid, "X-Request-Id not echoed")
                got += body["predictions"]
                sizes.append(k)
                i += k
            http_s = time.perf_counter() - t0
            top = top5_check(f"{SERVE_HTTP_N} held-out images over HTTP in {len(sizes)} requests of 1..16",
                             np.asarray(got), want, want_scores)
            status, body, hdrs = http_call(base + "/predict", {"instance": [[0.0] * 3] * 5},
                                           headers={"X-Request-Id": "s2-bad"})
            check(status == 400 and hdrs.get("X-Request-Id") == "s2-bad", f"mis-shaped body answered {status}")
            status, tr, _ = http_call(base + "/requestz/s2-0")
            check(status == 200 and tr["outcome"] == "completed", f"/requestz/s2-0: {status} {str(tr)[:300]}")
            status, st, _ = http_call(base + "/statusz")
            check(status == 200 and st["counters"]["completed"] >= SERVE_HTTP_N, f"/statusz {status}")
            status, text, _ = http_call(base + "/metrics")
            batches = float(re.search(r"^serve_batches_total (\S+)$", text, re.M).group(1))
            proc.send_signal(signal.SIGINT)
            tail, _ = proc.communicate(timeout=120)
            check(proc.returncode == 0, f"`cli serve` exited {proc.returncode} on SIGINT: {tail[-2000:]}")
            m = re.search(r"fisher_kernels launches (\{.*\})", tail)
            check(m is not None, f"no launch counts printed: {tail[-2000:]}")
            launches = json.loads(m.group(1).replace("'", '"'))
            primes = 2  # default buckets of max batch 16: 8 and 16
            print(f"  {len(sizes)} requests in {http_s:.2f} s; child's launches {launches} over {int(batches)} flushes "
                  f"and {primes} primes; SIGINT: exit 0 ({card})", flush=True)
            check(launches == fv_launches(fused=2 * (int(batches) + primes)),
                  f"launches {launches}: FvFusionRule did not fuse at freeze (expected B1 twice a flush, no B2)")
            out = {"requests": len(sizes), "images": SERVE_HTTP_N, "http_seconds": http_s, "top5": top,
                   "flushes": int(batches), "launches": launches}
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def fleet_path(dev, card, P, fk, scorer, images, params_b):
    """S3: two replicas on cuda:0 of serve_bench's pipeline behind a
    finite-row gate under fault plans (a crashed worker, a failed flush, a
    poison row), then two replicas of the full-width scorer hot-swapped
    under load to other weights, and a draining close."""
    import threading

    from keystone_tpu_torch import faults
    from keystone_tpu_torch.serve import PoisonRequest, serve
    from keystone_tpu_torch.tools import serve_bench
    from keystone_tpu_torch.workflow.pipeline import Pipeline
    from keystone_tpu_torch.workflow.transformer import Transformer

    class FiniteGate(Transformer):
        """Refuses a batch holding a non-finite row: a content fault."""

        def params(self):
            return ()

        def apply_batch(self, xs, mask=None):
            if not bool(torch.isfinite(xs).all()):
                raise ValueError("a non-finite row")
            return xs

    out = {}
    with phase("serve S3: fleet and self-healing, two replicas on one card"):
        pipe = Pipeline.of(FiniteGate()) | serve_bench.build_pipeline(device=dev)
        svc = serve(pipe, replicas=2, devices=[dev, dev], max_batch=32, max_wait_ms=2.0, queue_bound=1024, example=np.zeros(64, np.float32),
                    name="s3", supervise_interval_s=0.1, heartbeat_s=30.0)
        try:
            reps = svc._pool.replicas
            check([r.device for r in reps] == [dev, dev] and (dev.type != "cuda" or reps[0].stream is not reps[1].stream),
                  "the replicas are not two streams on one device")
            rows = np.random.default_rng(5).normal(size=(256, 64)).astype(np.float32)
            ref = svc.submit_many(rows)
            ref = np.stack([f.result(timeout=SERVE_RESULT_S) for f in ref])
            r0 = svc.supervisor.restarts_total
            with faults.inject("serve.worker:after=3:times=1:raise"):
                futs = []
                for j in range(0, 256, 16):
                    futs += svc.submit_many(rows[j:j + 16])
                    time.sleep(0.002)
                got = np.stack([f.result(timeout=SERVE_RESULT_S) for f in futs])
            deadline = time.monotonic() + 30
            while svc.supervisor.restarts_total == r0 and time.monotonic() < deadline:
                time.sleep(0.05)
            check(svc.supervisor.restarts_total > r0, "the crashed replica was not restarted")
            check(np.array_equal(got, ref), "answers across the worker crash differ")
            print(f"  serve.worker crash: restarted ({svc.supervisor.last_restart}), 256 of 256 futures resolved",
                  flush=True)
            with faults.inject("serve.batch:times=1:raise"):
                errs = [f.exception(timeout=SERVE_RESULT_S) for f in svc.submit_many(rows[:16])]
            check(all(isinstance(e, faults.FaultInjected) for e in errs), f"serve.batch: {errs[:2]}")
            after = np.stack([f.result(timeout=SERVE_RESULT_S) for f in svc.submit_many(rows[:16])])
            check(np.array_equal(after, ref[:16]), "the service did not live on after a failed flush")
            bad = rows[:8].copy()
            bad[3, 0] = np.nan
            futs = svc.submit_many(bad)
            excs = [f.exception(timeout=SERVE_RESULT_S) for f in futs]
            check(isinstance(excs[3], PoisonRequest) and all(e is None for i, e in enumerate(excs) if i != 3),
                  f"poison bisection: {excs}")
            mates = np.stack([futs[i].result() for i in range(8) if i != 3])
            check(np.array_equal(mates, np.delete(ref[:8], 3, axis=0)), "batch-mates of the poison row differ")
            print("  serve.batch fault failed one flush, the next served; the NaN row was bisected out "
                  "(PoisonRequest), its 7 batch-mates answered", flush=True)
            pending = svc.submit_many(rows[:64])
            svc.close(drain=True, timeout=SERVE_RESULT_S)
            check(all(f.done() and f.exception() is None for f in pending), "close(drain=True) left a future")
            out["faults"] = {"restarts": svc.supervisor.restarts_total - r0, "poison_isolated": True}
        finally:
            svc.close(timeout=SERVE_RESULT_S)
        # the hot swap, on the full-width scorer: two replicas, new weights
        imgs = images.cpu().numpy()
        new_scorer = P.build_scorer_from_params(params_b, P.Config(sift_step=SIFT_STEP, sift_bin_size=SIFT_BIN,
                                                                   lcs_step=LCS_STEP, lcs_subpatch=LCS_SUB), dev)
        new_ids = torch.cat([new_scorer(b) for b in images.split(BATCH)]).cpu().numpy()
        new_scores = torch.cat([P.scores_of(new_scorer)(b) for b in images.split(BATCH)]).cpu().numpy()
        fk.reset_launches()
        svc = serve(Pipeline.of(scorer), replicas=2, devices=[dev, dev], max_batch=BATCH, buckets=SERVE_BUCKETS, max_wait_ms=2.0,
                    queue_bound=1024, example=imgs[0], name="s3_swap")
        try:
            stop, futs, errors = threading.Event(), [], []

            def load():
                i = 0
                while not stop.is_set():
                    try:
                        futs.append((i, svc.submit(imgs[i % len(imgs)])))
                    except Exception as e:  # overload backs off; anything else fails the phase
                        if type(e).__name__ != "Overloaded":
                            errors.append(e)
                            return
                        time.sleep(0.001)
                    i += 1

            gen = threading.Thread(target=load)
            gen.start()
            time.sleep(0.5)
            info = svc.swap(Pipeline.of(new_scorer), version="green")
            t_commit = len(futs)
            time.sleep(0.5)
            stop.set()
            gen.join(SERVE_RESULT_S)
            check(not gen.is_alive() and not errors, f"swap load generator: {errors[:2]}")
            lost = [i for i, f in futs if f.exception(timeout=SERVE_RESULT_S) is not None]
            check(not lost, f"{len(lost)} requests failed across the swap")
            after = [(i, f.result()) for i, f in futs[t_commit:]]
            top = top5_check(f"{len(after)} answers after the commit against the new weights",
                             np.stack([r for _, r in after]), new_ids[[i % len(imgs) for i, _ in after]],
                             new_scores[[i % len(imgs) for i, _ in after]])
            print(f"  swap under load: {len(futs)} requests, none lost; pause {info['pause_seconds'] * 1e3:.4f} ms, "
                  f"prime {info['prime_seconds']:.3f} s ({card})", flush=True)
            out["swap"] = {"requests": len(futs), "after_commit": len(after), "pause_seconds": info["pause_seconds"],
                           "prime_seconds": info["prime_seconds"], "top5_after": top}
        finally:
            svc.close(timeout=SERVE_RESULT_S)
        # the swap service's launches, its two generations' primes included
        out["launches"] = dict(fk.LAUNCHES)
        check(out["launches"]["fisher_encode"] == 0 and out["launches"]["fused_forward"] > 0,
              f"swap service launches {out['launches']}")
    return out


def open_loop_path(dev, card, fk, scorer, images, saturation_ips):
    """S4: serve_bench's open-loop generator against the full-width scorer
    at fractions of S1's saturation rate: latency percentiles, sheds, the
    queue depth (sampled every millisecond)."""
    import threading

    from keystone_tpu_torch.serve import serve
    from keystone_tpu_torch.tools import serve_bench
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    out = {}
    imgs = images.cpu().numpy()
    with phase("serve S4: open-loop load at fractions of the saturation rate"):
        fk.reset_launches()
        svc = serve(Pipeline.of(scorer).freeze(device=dev), max_batch=BATCH, buckets=SERVE_BUCKETS, max_wait_ms=2.0,
                    queue_bound=4096, example=imgs[0], deadline_ms=SERVE_S4_DEADLINE_MS, name="s4")
        try:
            for frac in SERVE_S4_FRACTIONS:
                depth, stop = [], threading.Event()

                def sample():
                    while not stop.wait(0.001):
                        depth.append(svc.queue_depth)

                sampler = threading.Thread(target=sample)
                sampler.start()
                try:
                    rep = serve_bench.run_bench(svc, imgs.shape[1:], qps=frac * saturation_ips,
                                                duration=SERVE_S4_SECONDS, burst=SERVE_S4_BURST,
                                                deadline_ms=SERVE_S4_DEADLINE_MS, payload=imgs)
                finally:
                    stop.set()
                    sampler.join(10)
                rep["queue_depth_mean"] = float(np.mean(depth)) if depth else 0.0
                rep["queue_depth_max"] = int(max(depth)) if depth else 0
                check(rep["errors"] == 0, f"open loop at {frac}: {rep['errors']} errors")
                # a walk that outruns its riders' deadlines is a late shed:
                # the lone replica's breaker stays closed under the load
                breakers = [st["breaker"] for st in svc.replica_statuses()]
                check(breakers == ["closed"], f"open loop at {frac}: breakers {breakers}")
                print(f"  offered {rep['offered_qps']:.1f}/s ({frac:.0%} of saturation) for {SERVE_S4_SECONDS} s in "
                      f"bursts of {SERVE_S4_BURST}: achieved {rep['achieved_qps']:.1f}/s, p50 {rep['p50_ms']:.3f} ms, "
                      f"p99 {rep['p99_ms']:.3f} ms, p99.9 {rep['p999_ms']:.3f} ms, shed {rep['shed']}, rejected "
                      f"{rep['rejected']}, queue depth mean {rep['queue_depth_mean']:.1f} max {rep['queue_depth_max']}, "
                      f"{rep['mean_batch_occupancy']:.2f} requests a flush ({card})", flush=True)
                out[f"{frac:.2f}"] = rep
        finally:
            svc.close(timeout=SERVE_RESULT_S)
        out["launches"] = dict(fk.LAUNCHES)
        check(out["launches"]["fisher_encode"] == 0, f"open-loop launches {out['launches']}")
    return out


# ---- the model lifecycle (S5): the full-width scorer's raw scores exported
# at the serving buckets and published to a temporary registry (v0001; S3's
# other weights v0002), served from it on two replicas with their bucket
# graphs (captured at prime, replayed a flush), S1's saturation loop with
# the graphs on and off, the registry watcher with a canary and a bake in
# a `cli serve` child under POSTed traffic (v0002 committed, a bad v0003
# rolled back and quarantined, POST /rollback to v0001), then the
# autoscaler under an open-loop burst.  A bucket graph replays the walk's
# kernels on the same inputs: its rows are held to the walk's bit for bit;
# served rows against the offline scorer at TOL_SERVE_SCORES, as S1's.
# The phase fails if serve.artifact_fallbacks moves at all.
S5_WATCH_S, S5_CANARY, S5_BAKE_S = 0.2, 0.25, 2.0
S5_HTTP_CLIENTS = 2
S5_HTTP_MAX_BATCH = 16
S5_EPISODE_S = 90.0  # the bound of each wait on a rollout episode
S5_AUTOSCALE = {"min_workers": 1, "max_workers": 3, "interval_s": 0.1, "up_cooldown_s": 0.5,
                "down_cooldown_s": 1.0, "down_ticks": 5}
S5_OVERLOAD = 1.5  # the burst's offered load, a multiple of S1's saturation rate
S5_BURST_S = 3.0


def _marked(i: int) -> np.ndarray:
    """Request image ``i`` of the S5 HTTP traffic: seeded, distinct for
    every i, with the rollout drill's marker in its first pixel (the bad
    version's gate fails it; the good versions serve it)."""
    x = np.random.default_rng(10_000 + i).integers(0, 256, (IMAGE_HW, IMAGE_HW, 3), dtype=np.uint8)
    x[0, 0, 0] = 123
    return x


class _HttpTraffic:
    """Client threads POSTing one marked image a request to ``base`` until
    stopped; every request's (index, status, body, sent, answered)."""

    def __init__(self, base: str, clients: int):
        import threading

        self.base, self.log, self._lock = base, [], threading.Lock()
        self._next = iter(range(10 ** 9))
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, daemon=True) for _ in range(clients)]

    def _run(self):
        while not self._stop.is_set():
            with self._lock:
                i = next(self._next)
            t0 = time.monotonic()
            try:
                # pixels as JSON integers: a body the server parses without
                # a float object per pixel
                status, body, _ = http_call(self.base + "/predict", {"instances": [_marked(i).tolist()]},
                                            headers={"X-Request-Id": f"s5-{i}"})
            except Exception as e:  # a lost request: reported by the phase
                status, body = None, f"{type(e).__name__}: {e}"
            with self._lock:
                self.log.append((i, status, body, t0, time.monotonic()))

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(SERVE_RESULT_S)

    def since(self, t: float) -> list:
        with self._lock:
            return [e for e in self.log if e[3] >= t]


def lifecycle_path(dev, card, P, fk, scorer, images, params_b, saturation_ips):
    """S5: the model lifecycle on the card (see the comment above)."""
    import re
    import signal
    import threading

    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.serve import ModelRegistry, serve
    from keystone_tpu_torch.tools import serve_bench, serve_hostprof
    from keystone_tpu_torch.utils import graphs
    from keystone_tpu_torch.workflow.dataset import Dataset
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    out = {}
    t_s5 = time.perf_counter()
    reg_counter = metrics.REGISTRY.counter_total
    fb0 = reg_counter("serve.artifact_fallbacks")

    def no_fallback(where):
        fb = reg_counter("serve.artifact_fallbacks") - fb0
        check(fb == 0, f"S5 {where}: serve.artifact_fallbacks moved by {fb}")

    def prime_count(source):
        h = metrics.REGISTRY.histogram_value("serve.prime_seconds", source=source) or {}
        return int(h.get("count") or 0)

    imgs = images.cpu().numpy()
    cfg = P.Config(sift_step=SIFT_STEP, sift_bin_size=SIFT_BIN, lcs_step=LCS_STEP, lcs_subpatch=LCS_SUB)
    scorer_b = P.build_scorer_from_params(params_b, cfg, dev)
    scores_a, scores_b = P.scores_of(scorer), P.scores_of(scorer_b)
    v1_pipe, v2_pipe = Pipeline.of(scores_a).fit(), Pipeline.of(scores_b).fit()
    v3_pipe = (Pipeline.of(serve_bench.MarkerGate()) | scores_b).fit()
    off_scores = torch.cat([scores_a(b) for b in images.split(BATCH)]).cpu().numpy()
    off_ids = torch.cat([scorer(b) for b in images.split(BATCH)]).cpu().numpy()
    tmp = Path(tempfile.mkdtemp(prefix="serve_registry_", dir=REPO))
    fk.reset_launches()
    graphs.reset_replayed()
    try:
        with phase("serve S5: export the scorer at the serving buckets, publish v0001 and v0002 with artifacts"):
            reg = ModelRegistry(str(tmp / "registry"))
            t0 = time.perf_counter()
            bundle_a = v1_pipe.freeze(device=dev).export_artifacts(example=imgs[0], buckets=SERVE_BUCKETS)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            v1 = reg.publish(v1_pipe, artifacts=bundle_a)
            publish_s = time.perf_counter() - t0
            bundle_b = v2_pipe.freeze(device=dev).export_artifacts(example=imgs[0], buckets=SERVE_BUCKETS)
            v2 = reg.publish(v2_pipe, artifacts=bundle_b, set_current=False)
            man = bundle_a["manifest"]
            check(reg.versions() == [v1, v2] and reg.current() == v1, f"registry {reg.versions()} {reg.current()}")
            check(reg.load_artifacts(v1)["manifest"] == man and man["buckets"] == list(SERVE_BUCKETS),
                  "the published manifest differs from the exported one")
            check(man["signature"] != bundle_b["manifest"]["signature"], "two weight sets share a signature")
            print(f"  export {export_s:.3f} s, publish {publish_s:.3f} s; manifest: torch {man['torch_version']}, "
                  f"CUDA {man['cuda_version']}, {man['device']}, kernels {man['kernels']}, signature "
                  f"{man['signature']}, buckets {man['buckets']} of {tuple(man['item_shape'])} {man['dtype']}",
                  flush=True)
            out["export"] = {"export_s": export_s, "publish_s": publish_s, "manifest": man}

        with phase("serve S5: v0001 from the registry on two replicas with its bucket graphs"):
            fitted, ver = reg.load(map_location=dev)
            check(ver == v1, f"the deploy pick is {ver}")
            a0, c0 = prime_count("artifact"), prime_count("compile")
            t0 = time.perf_counter()
            svc = serve(fitted.freeze(device=dev), replicas=2, devices=[dev, dev], max_batch=BATCH,
                        buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS, queue_bound=4 * SERVE_CLIENTS * SERVE_SAT_WINDOW,
                        example=imgs[0], version=ver, artifacts=reg.load_artifacts(ver), name="s5")
            build_s = time.perf_counter() - t0
            try:
                no_fallback("build and prime")
                check(prime_count("artifact") - a0 == 2 * len(SERVE_BUCKETS) and prime_count("compile") == c0,
                      "a bucket primed without its graph")
                pools = {}
                for r in svc._pool.replicas:
                    st = r.applier.graph_stats()
                    check(sorted(st) == list(SERVE_BUCKETS), f"replica {r.index} graphs {sorted(st)}")
                    for b, g in st.items():
                        check(g["captured"] and g["launches"] == {"fused_forward": 2},
                              f"replica {r.index} bucket {b}: {g} (B1 twice a graph expected)")
                    pools[r.index] = {b: g["pool_bytes"] for b, g in st.items()}
                    print(f"  replica {r.index}: graph pool bytes by bucket {pools[r.index]} "
                          f"({sum(pools[r.index].values()) / 2 ** 20:.1f} MiB)", flush=True)
                print(f"  built, installed and captured {2 * len(SERVE_BUCKETS)} graphs in {build_s:.3f} s "
                      f"({card})", flush=True)
                # each replica, each bucket: one flush's apply through the
                # service's path (pad, pinned copy, replay, read-back) against
                # the same applier's walk, bit for bit
                for r in svc._pool.replicas:
                    for b in SERVE_BUCKETS:
                        got = svc._apply_rows(imgs[:b], replica=r)
                        with r.on_stream():
                            want = r.applier._walk(Dataset(torch.from_numpy(imgs[:b]).to(r.device))).array
                            want = want.cpu().numpy()
                        check(got.tobytes() == want.tobytes(), f"replica {r.index} bucket {b}: replay != walk")
                for r in svc._pool.replicas:
                    check(all(g["replays"] >= 1 for g in r.applier.graph_stats().values()),
                          f"replica {r.index}: a bucket never replayed")
                # through the batcher: one flush a bucket, against the offline scorer
                served, start = [], 0
                for b in SERVE_BUCKETS:
                    served += [f.result(timeout=SERVE_RESULT_S) for f in svc.submit_many(list(imgs[start:start + b]))]
                    start += b
                served = np.stack(served)
                err = compare(f"{len(served)} served raw scores (one flush a bucket) against the offline scores",
                              torch.from_numpy(served), torch.from_numpy(off_scores[:len(served)]), TOL_SERVE_SCORES,
                              RTOL_SERVE_SCORES)
                top = top5_check("S5 top-5 of the served scores", np.argsort(-served, axis=1, kind="stable")[:, :5],
                                 off_ids[:len(served)], off_scores[:len(served)])
                no_fallback("serving")
                out["registry_serve"] = {"build_s": build_s, "pool_bytes": pools, "scores_max_abs_err": err,
                                         "top5": top, "bit_equal_buckets": list(SERVE_BUCKETS)}
            finally:
                svc.close(timeout=SERVE_RESULT_S)

        with phase("serve S5: S1's saturation closed loop, bucket graphs on and off (one replica each)"):
            svcs = {}
            for mode in ("on", "off"):
                svcs[mode] = serve(fitted.freeze(device=dev), max_batch=BATCH, buckets=SERVE_BUCKETS,
                                   max_wait_ms=SERVE_WAIT_MS, queue_bound=4 * SERVE_CLIENTS * SERVE_SAT_WINDOW,
                                   example=imgs[0], version=ver, name=f"s5_{mode}",
                                   artifacts=reg.load_artifacts(ver) if mode == "on" else None)
            loops = {"on": [], "off": []}
            try:
                check(svcs["on"]._pool.replicas[0].applier.installed_buckets() == len(SERVE_BUCKETS)
                      and svcs["off"]._pool.replicas[0].applier.installed_buckets() == 0, "graph tiers")
                for mode in ("on", "off", "off", "on"):
                    svc = svcs[mode]
                    r0 = serve_counters(metrics)
                    outs, lat, wall = serve_closed_loop(svc, imgs, SERVE_SAT_N, SERVE_SAT_WINDOW)
                    flushes = serve_counters(metrics)["batches"] - r0["batches"]
                    got = np.stack(outs)
                    idx = np.arange(SERVE_SAT_N) % len(imgs)
                    err = compare(f"closed loop, graphs {mode}: {SERVE_SAT_N} served raw scores", torch.from_numpy(got),
                                  torch.from_numpy(off_scores[idx]), TOL_SERVE_SCORES, RTOL_SERVE_SCORES)
                    prof = serve_hostprof.run(svc, imgs, "threads", SERVE_SAT_N, SERVE_CLIENTS, SERVE_SAT_WINDOW)
                    rec = {"images_per_s": SERVE_SAT_N / wall, "flushes": flushes,
                           "requests_per_flush": SERVE_SAT_N / max(1, flushes),
                           "p50_ms": float(np.percentile(lat, 50) * 1e3), "p99_ms": float(np.percentile(lat, 99) * 1e3),
                           "max_abs_err": err, "hostprof": {k: prof[k] for k in (
                               "images_per_s", "requests_per_flush", "wall_ms_per_flush", "flush_ms", "cpu_s")}}
                    loops[mode].append(rec)
                    fm = prof["flush_ms"]
                    print(f"  graphs {mode}: {rec['images_per_s']:.1f} images/s, {rec['requests_per_flush']:.2f} "
                          f"requests a flush, p50 {rec['p50_ms']:.3f} ms, p99 {rec['p99_ms']:.3f} ms; profiled loop "
                          f"{prof['images_per_s']:.1f} images/s, the worker's ms a flush: "
                          + ", ".join(f"{k} {v:.3f}" for k, v in fm.items()) + f" ({card})", flush=True)
                no_fallback("closed loops")
                rep = svcs["on"]._pool.replicas[0].applier
                check(all(g["replays"] > 0 for b, g in rep.graph_stats().items() if b == BATCH),
                      "the 128-row bucket never replayed in the closed loop")
            finally:
                for svc in svcs.values():
                    svc.close(timeout=SERVE_RESULT_S)
            out["closed_loop"] = loops

        with phase("serve S5: `cli serve --model-dir --watch --canary --bake-s`: commit, rollback, /rollback"):
            scores_v = {v1: scores_a, v2: scores_b}

            def offline(i, version):
                x = torch.from_numpy(_marked(i)[None]).to(dev)
                return scores_v[version](x)[0].cpu().numpy()

            def answered_by(entries, version, label):
                """Every 200 answer among ``entries`` is ``version``'s scores."""
                ok = [e for e in entries if e[1] == 200]
                check(ok, f"{label}: no answer")
                for i, _, body, _, _ in ok[:: max(1, len(ok) // 16)]:
                    got = np.asarray(body["predictions"][0], np.float32)
                    want = offline(i, version)
                    err = np.abs(got - want).max()
                    check(bool(np.all(np.abs(got - want) <= TOL_SERVE_SCORES + RTOL_SERVE_SCORES * np.abs(want))),
                          f"{label}: request {i} differs from {version}'s scores by {err:.3e}")
                return len(ok)

            cmd = [sys.executable, "-m", "keystone_tpu_torch.cli", "serve", "--model-dir", reg.root, "--device",
                   DEVICE, "--port", "0", "--max-batch", str(S5_HTTP_MAX_BATCH), "--max-wait-ms", "2",
                   "--example-shape", f"{IMAGE_HW},{IMAGE_HW},3", "--watch", str(S5_WATCH_S), "--canary",
                   str(S5_CANARY), "--bake-s", str(S5_BAKE_S)]
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(REPO),
                                    env={**os.environ, "PYTHONPATH": str(REPO)})
            try:
                line, lines = "", []
                while "serving" not in line and proc.poll() is None and time.perf_counter() - t0 < 600:
                    line = proc.stdout.readline()
                    lines.append(line)
                check("serving" in line and "artifacts on" in line, f"`cli serve` did not start: {''.join(lines)[-2000:]}")
                base = line.split(" on ", 1)[1].split(" ", 1)[0]
                # drain the child's log as it comes: a full pipe would stall it
                drain = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
                drain.start()
                print(f"  `cli serve --model-dir` up in {time.perf_counter() - t0:.2f} s at {base}", flush=True)

                def rolloutz():
                    return http_call(base + "/rolloutz")[1]

                def wait_episode(version, verdict):
                    deadline = time.monotonic() + S5_EPISODE_S
                    while time.monotonic() < deadline:
                        hist = rolloutz()["history"]
                        hit = [h for h in hist if h["version"] == version and h["verdict"] == verdict]
                        if hit:
                            return hit[-1]
                        time.sleep(0.1)
                    raise AssertionError(f"no {verdict} episode of {version} in {S5_EPISODE_S} s: {rolloutz()}")

                episodes = {}
                with _HttpTraffic(base, S5_HTTP_CLIENTS) as traffic:
                    time.sleep(1.0)
                    answered_by(traffic.since(0.0), v1, "before the first publish")
                    t_pub2 = time.monotonic()
                    reg.set_current(v2)
                    episodes["v0002"] = wait_episode(v2, "committed")
                    t_commit = time.monotonic()
                    print(f"  v0002 published: committed in {t_commit - t_pub2:.2f} s ({episodes['v0002']['reason']}, "
                          f"canary {episodes['v0002']['canary']})", flush=True)
                    deadline = time.monotonic() + S5_BAKE_S + 10.0
                    while rolloutz()["active"] is not None and time.monotonic() < deadline:
                        time.sleep(0.1)  # the bake
                    check(rolloutz()["active"] is None and rolloutz()["version"] == v2, f"the bake: {rolloutz()}")
                    t_baked = time.monotonic()
                    time.sleep(0.5)
                    n2 = answered_by(traffic.since(t_baked), v2, "after v0002's commit")
                    t_pub3 = time.monotonic()
                    v3 = reg.publish(v3_pipe)
                    episodes["v0003"] = wait_episode(v3, "rolled_back")
                    t_rb = time.monotonic()
                    check(reg.quarantined(v3) is not None and reg.current() == v2,
                          f"v0003 quarantined {reg.quarantined(v3)}, CURRENT {reg.current()}")
                    print(f"  v0003 (marker gate) published: rolled back in {t_rb - t_pub3:.2f} s "
                          f"({episodes['v0003']['reason']}, canary {episodes['v0003']['canary']}); BAD "
                          f"{reg.quarantined(v3)!r}, CURRENT {reg.current()}", flush=True)
                    time.sleep(1.0)
                    n3 = answered_by(traffic.since(t_rb + 0.2), v2, "after v0003's rollback")
                    status, info, _ = http_call(base + "/rollback", {})
                    check(status == 200 and info.get("rolled_back_to") == v1, f"/rollback: {status} {info}")
                    t_manual = time.monotonic()
                    time.sleep(1.0)
                    n1 = answered_by(traffic.since(t_manual + 0.2), v1, "after POST /rollback")
                hist = rolloutz()["history"]
                check([(h["version"], h["verdict"]) for h in hist] == [(v2, "committed"), (v3, "rolled_back"),
                                                                       (v1, "rolled_back")], f"/rolloutz {hist}")
                log = traffic.log
                lost = [e for e in log if e[1] is None]
                check(not lost, f"{len(lost)} requests lost: {lost[:2]}")
                refused = [e for e in log if e[1] != 200]
                check(all(e[1] == 422 and t_pub3 <= e[3] <= t_rb for e in refused),
                      f"answers other than 200 outside v0003's canary: {[(e[0], e[1]) for e in refused[:4]]}")
                status, st, _ = http_call(base + "/statusz")
                check(status == 200 and st["counters"]["artifact_fallbacks"] == 0 and st["version"] == v1,
                      f"/statusz {st.get('counters')} {st.get('version')}")
                proc.send_signal(signal.SIGINT)
                proc.wait(timeout=120)
                drain.join(30)
                tail = "".join(lines)
                check(proc.returncode == 0, f"`cli serve` exited {proc.returncode} on SIGINT: {tail[-2000:]}")
                m = re.search(r"fisher_kernels launches (\{.*\})", tail)
                r = re.search(r"graph replay launches (\{.*\})", tail)
                check(m is not None and r is not None, f"no launch counts printed: {tail[-2000:]}")
                launches = json.loads(m.group(1).replace("'", '"'))
                replayed = json.loads(r.group(1).replace("'", '"'))
                print(f"  {len(log)} requests from {S5_HTTP_CLIENTS} threads, none lost, {len(refused)} refused by "
                      f"v0003's gate in its canary (422); answers checked: v0002 {n2}, after the rollback {n3}, after "
                      f"/rollback {n1}; child's launches {launches}, graph replays {replayed}; SIGINT: exit 0 "
                      f"({card})", flush=True)
                check(replayed.get("fused_forward", 0) > 0, "the child replayed no bucket graph")
                out["watcher"] = {"requests": len(log), "refused_422": len(refused), "episodes": hist,
                                  "commit_s": t_commit - t_pub2, "rollback_s": t_rb - t_pub3,
                                  "launches": launches, "replayed": replayed}
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)

        with phase("serve S5: autoscale 1..3 under an open-loop burst, then idle"):
            a0, c0 = prime_count("artifact"), prime_count("compile")
            ups0, downs0 = reg_counter("serve.scale_ups"), reg_counter("serve.scale_downs")
            svc = serve(reg.load(v1, map_location=dev)[0].freeze(device=dev), max_batch=BATCH, buckets=SERVE_BUCKETS,
                        max_wait_ms=SERVE_WAIT_MS, queue_bound=8192, example=imgs[0], version=v1,
                        artifacts=reg.load_artifacts(v1), name="s5_autoscale", autoscale=dict(S5_AUTOSCALE))
            try:
                sizes, stop = [], threading.Event()

                def sample():
                    while not stop.wait(0.01):
                        sizes.append(svc.replicas)

                sampler = threading.Thread(target=sample)
                sampler.start()
                try:
                    t0 = time.perf_counter()
                    rep = serve_bench.run_bench(svc, imgs.shape[1:], qps=S5_OVERLOAD * saturation_ips,
                                                duration=S5_BURST_S, burst=SERVE_S4_BURST, payload=imgs)
                    burst_s = time.perf_counter() - t0
                    peak = max(sizes) if sizes else svc.replicas
                    deadline = time.monotonic() + 60.0
                    while svc.replicas > 1 and time.monotonic() < deadline:
                        time.sleep(0.05)
                    idle_s = time.perf_counter() - t0 - burst_s
                finally:
                    stop.set()
                    sampler.join(10)
                ups, downs = reg_counter("serve.scale_ups") - ups0, reg_counter("serve.scale_downs") - downs0
                check(rep["errors"] == 0 and rep["shed"] == 0 and rep["completed"] + rep["rejected"] == rep["n_requests"],
                      f"autoscale burst lost futures: {rep}")
                check(peak >= 2 and svc.replicas == 1, f"the fleet peaked at {peak} and ended at {svc.replicas}")
                check(prime_count("artifact") - a0 == len(SERVE_BUCKETS) * (1 + ups) and prime_count("compile") == c0,
                      "a scale-up primed a bucket without its graph")
                no_fallback("autoscale")
                st = svc.status()["autoscaler"]
                print(f"  offered {rep['offered_qps']:.1f}/s ({S5_OVERLOAD:g}x saturation) for {S5_BURST_S} s: "
                      f"completed {rep['completed']}, rejected {rep['rejected']}, errors 0, achieved "
                      f"{rep['achieved_qps']:.1f}/s, p99 {rep['p99_ms']:.3f} ms; fleet 1 -> {peak} -> {svc.replicas} "
                      f"({ups:g} up, {downs:g} down, each new replica's {len(SERVE_BUCKETS)} buckets primed from its "
                      f"graphs), back to 1 in {idle_s:.2f} s idle; last action {st['last_action']} ({card})",
                      flush=True)
                out["autoscale"] = {"burst": rep, "peak_replicas": peak, "ups": ups, "downs": downs,
                                    "idle_to_one_s": idle_s}
            finally:
                svc.close(timeout=SERVE_RESULT_S)
        out["launches"] = dict(fk.LAUNCHES)
        out["replayed"] = dict(graphs.REPLAYED)
        check(out["replayed"].get("fused_forward", 0) > 0 and out["launches"]["fisher_encode"] == 0
              and out["replayed"].get("fisher_encode", 0) == 0, f"S5 launches {out['launches']} {out['replayed']}")
        out["seconds"] = time.perf_counter() - t_s5
        print(f"  S5 took {out['seconds']:.1f} s; B1 launched {out['launches']['fused_forward']} times by its wrapper "
              f"and {out['replayed']['fused_forward']} times by graph replays in this process ({card})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def profile_once(fn) -> None:
    """Device time by operator over one call of ``fn`` (after a warm-up
    call), and two idle shares.  One window: the device's busy time
    against the host-clock time of that same call, traced on the device
    only; it includes the profiler's own host overhead, so it reads high.
    Two calls: that busy time against the host-clock time of an
    unprofiled call; it assumes both calls kept the device equally busy."""
    from torch.profiler import ProfilerActivity, profile

    busy_ms = device_busy_ms
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_ms(prof)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12))
    print(f"  device busy {busy:.3f} ms of {wall * 1e3:.3f} ms host-clock time in the same call, "
          f"traced on the device only (one-window idle share {max(0.0, 1.0 - busy / (wall * 1e3)):.3f}); "
          f"the call unprofiled {bare * 1e3:.3f} ms (two-call idle share "
          f"{max(0.0, 1.0 - busy / (bare * 1e3)):.3f}); device busy in the operator-traced call "
          f"{busy_ms(prof):.3f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one batch or fit of each main path (after the checks)")
    ap.add_argument("--recovery-child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if args.recovery_child:
        return recovery_child(args.recovery_child)

    from keystone_tpu_torch.convert import params_from_numpy
    from keystone_tpu_torch.kernels import build
    from keystone_tpu_torch.ops import fisher_kernels as fk
    from keystone_tpu_torch.ops import gram_kernels as gk
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P
    from keystone_tpu_torch.pipelines import kernel_timit as KT
    from keystone_tpu_torch.utils import precision
    from keystone_tpu_torch.workflow.optimizer import FusedTransformer

    dev = torch.device(DEVICE)
    precision.disable_tf32()

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        card = smi[0].strip()
        name = torch.cuda.get_device_name(0)
        print(card)
        import scipy

        print(f"  scipy {scipy.__version__}")
        print(f"  torch: {torch.__version__} cuda {torch.version.cuda}; device 0: {name}; "
              f"count {torch.cuda.device_count()}")

    materialize = watch_materialize()
    with phase("build"):
        # every CUDA source with nvcc and the host text chain with g++, all
        # compilers started together (jpeg.cpp needs libjpeg, which the
        # card's machine lacks: the CPU decoder is not on a card path)
        sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
        t0 = time.perf_counter()
        paths = build.build(sources + ["text"])
        print(f"  built {sources + ['text']} in {time.perf_counter() - t0:.1f} s")
        for s in sources:
            regs = [ln.strip() for ln in (build.BUILD_DIR / f"{s}.log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"  {paths[s].name}: " + "; ".join(regs))

    # ---- full-width model, seeded
    cfg = P.Config(sift_step=SIFT_STEP, sift_bin_size=SIFT_BIN, lcs_step=LCS_STEP,
                   lcs_subpatch=LCS_SUB, top_k=5)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.integers(0, 256, ((BATCHES + 1) * BATCH, IMAGE_HW, IMAGE_HW, 3), dtype=np.uint8)
    ).to(dev)
    batches = list(images.split(BATCH))
    # the bench forward takes images already scaled to [0, 1], as bench.py feeds it
    float_batches = [b.float() / 255.0 for b in batches]
    scorer_params = params_from_numpy(
        P.random_params(pca_dims=PCA_DIMS, gmm_k=GMM_K, num_classes=NUM_CLASSES, seed=0), dev)
    fwd_params = params_from_numpy(
        P.random_params(("sift",), pca_dims=PCA_DIMS, gmm_k=GMM_K, num_classes=NUM_CLASSES, seed=1),
        dev)
    scorer = P.build_scorer_from_params(scorer_params, cfg, dev)
    scorer_plain = P.build_scorer_from_params(scorer_params, cfg, dev, use_kernel=False)
    forward = P.build_forward(fwd_params, cfg, dev)
    forward_plain = P.build_forward(fwd_params, cfg, dev, use_kernel=False)

    # the kernels' inputs exactly as the main paths hand them over
    x0 = batches[0]
    xf = scorer.stages[0].apply_batch(x0)  # PixelScaler
    sift_branch, lcs_branch = scorer.stages[1].branches
    sift_raw, sift_mask = FusedTransformer(list(sift_branch.stages)[:2]).apply_batch(xf)
    lcs_desc, lcs_mask = lcs_branch.stages[0].apply_batch(xf)
    fused_sift, fused_lcs = sift_branch.stages[2], lcs_branch.stages[1]
    fx, fmask = FusedTransformer(list(forward.stages)[:3]).apply_batch(xf)
    g = forward.stages[3].gmm
    gmm_b2 = (g.weights, g.means, g.variances)

    def fused_args(node, desc, mask, mean):
        gm = node.gmm
        return desc, mask, node.components, mean, gm.weights, gm.means, gm.variances, node.sift_normalize

    errs = {"fisher_encode": 0.0, "fused_forward": 0.0}
    with phase("kernels vs plain versions"):
        check(tuple(fx.shape) == (BATCH, 784, PCA_DIMS), f"B2 input {tuple(fx.shape)}")
        check(tuple(sift_raw.shape) == (BATCH, 784, 128), f"B1 SIFT input {tuple(sift_raw.shape)}")
        check(tuple(lcs_desc.shape) == (BATCH, 324, 96), f"B1 LCS input {tuple(lcs_desc.shape)}")
        e = compare("B2 f32 (128, 784, 64, K=256)", fk.fisher_encode(fx, fmask, *gmm_b2),
                    fk.fisher_encode_ref(fx, fmask, *gmm_b2), TOL_FV)
        errs["fisher_encode"] = max(errs["fisher_encode"], e)
        xb = fx.to(torch.bfloat16)
        got = fk.fisher_encode(xb, fmask, *gmm_b2)
        compare("B2 bf16 stream vs plain on the same bf16 descriptors", got,
                fk.fisher_encode_ref(xb, fmask, *gmm_b2), TOL_FV)
        compare("B2 bf16 stream vs plain f32", got, fk.fisher_encode_ref(fx, fmask, *gmm_b2),
                TOL_BF16, RTOL_BF16)
        mean_sift = torch.from_numpy((0.01 * rng.normal(size=128)).astype(np.float32)).to(dev)
        mean_lcs = torch.from_numpy((0.01 * rng.normal(size=96)).astype(np.float32)).to(dev)
        for label, node, desc, mask, means in (
            ("B1 normalize=True (128, 784, 128->64, K=256)", fused_sift, sift_raw, sift_mask, mean_sift),
            ("B1 normalize=False (128, 324, 96->64, K=256)", fused_lcs, lcs_desc, lcs_mask, mean_lcs),
        ):
            for mlabel, m in (("mean", means), ("no mean", None)):
                a = fused_args(node, desc, mask, m)
                e = compare(f"{label}, {mlabel}", fk.fused_forward(*a), fk.fused_forward_ref(*a), TOL_FUSED)
                errs["fused_forward"] = max(errs["fused_forward"], e)
        # a ragged T (not a multiple of the kernel's 32-row tile) with rows masked off
        n_r, t_r = min(16, BATCH), 301
        mask_r = torch.from_numpy((rng.random((n_r, t_r)) > 0.15).astype(np.float32)).to(dev)
        mask_r[3] = 0.0  # an image with no valid descriptor: count = max(0, 1)
        xr = fx[:n_r, :t_r].contiguous()
        compare("B2 ragged T=301, masked rows", fk.fisher_encode(xr, mask_r, *gmm_b2),
                fk.fisher_encode_ref(xr, mask_r, *gmm_b2), TOL_FV)
        a = fused_args(fused_sift, sift_raw[:n_r, :t_r].contiguous(), mask_r, mean_sift)
        compare("B1 ragged T=301, masked rows", fk.fused_forward(*a), fk.fused_forward_ref(*a), TOL_FUSED)
        torch.cuda.synchronize()

    fv64 = {"fisher_encode": {}, "fused_forward": {}}
    with phase("FV kernels: f32-grade against float64"):
        for key, where, kern, plain, inputs, exact in (
            ("fisher_encode", "(128, 784, 64) K=256", fk.fisher_encode, fk.fisher_encode_ref, (fx, fmask, *gmm_b2),
             fv_f64),
            ("fused_forward", "SIFT (128, 784, 128->64) K=256", fk.fused_forward, fk.fused_forward_ref,
             fused_args(fused_sift, sift_raw, sift_mask, fused_sift.mean), fused_f64),
            ("fused_forward", "LCS (128, 324, 96->64) K=256", fk.fused_forward, fk.fused_forward_ref,
             fused_args(fused_lcs, lcs_desc, lcs_mask, fused_lcs.mean), fused_f64),
        ):
            ref = exact(*inputs)
            e_kernel, e_plain = max_err64(kern(*inputs), ref), max_err64(plain(*inputs), ref)
            with tf32_matmul():
                e_tf32 = max_err64(plain(*inputs), ref)
            print(f"  {key} {where}: largest error against float64 (|ref| max {ref.abs().max().item():.3e}): "
                  f"kernel {e_kernel:.3e}, plain f32 chain {e_plain:.3e} (ratio {e_kernel / e_plain:.3f}, at "
                  f"most {F64_RATIO}); one-pass TF32 {e_tf32:.3e} (ratio {e_tf32 / e_plain:.1f}, must exceed "
                  f"{F64_RATIO})", flush=True)
            check(e_kernel <= F64_RATIO * e_plain, f"{key} {where}: not f32-grade against float64")
            check(e_tf32 > F64_RATIO * e_plain, f"{key} {where}: the check cannot tell TF32 from f32")
            fv64[key][where] = {"kernel": e_kernel, "plain_f32": e_plain, "tf32": e_tf32}
            del ref
        torch.cuda.synchronize()

    # The general path: GMM shapes the tiled kernels refuse, which the
    # reference's Pallas kernels take.  B2 at K = 512 (K·d over the tiled
    # kernel's statistics fragments) on the bench forward's descriptors,
    # B1 at d = 60 (off the 8-tiling) on the scorer's SIFT descriptors;
    # held as the tiled kernels are, against the plain chain and f32-grade
    # against float64.  Not on a main path: its launches here are checks.
    general = {}
    with phase("FV kernels: the general path (shapes the tiled kernels refuse)"):
        gp = params_from_numpy(P.random_params(("sift",), pca_dims=PCA_DIMS, gmm_k=512, num_classes=8, seed=2), dev)
        gq = params_from_numpy(P.random_params(("sift",), pca_dims=60, gmm_k=GMM_K, num_classes=8, seed=3), dev)
        gmm512 = (gp["sift.gmm.weights"], gp["sift.gmm.means"], gp["sift.gmm.variances"])
        gmm60 = (gq["sift.gmm.weights"], gq["sift.gmm.means"], gq["sift.gmm.variances"])
        for key, where, kern, plain, inputs, exact, tol, (d, k, d_in) in (
            ("fisher_encode", f"({BATCH}, 784, 64) K=512", fk.fisher_encode, fk.fisher_encode_ref,
             (fx, fmask, *gmm512), fv_f64, TOL_FV, (64, 512, 0)),
            ("fused_forward", f"SIFT ({BATCH}, 784, 128->60) K={GMM_K}", fk.fused_forward, fk.fused_forward_ref,
             (sift_raw, sift_mask, gq["sift.pca.components"], gq["sift.pca.mean"], *gmm60, True), fused_f64,
             TOL_FUSED, (60, GMM_K, 128)),
        ):
            check(not fk.tiled(d, k, d_in), f"{key} {where}: the tiled kernel takes it")
            cost = fv_cost(BATCH, 784, d, k, d_in=d_in)
            fk.reset_launches()
            got = kern(*inputs)
            check(fk.LAUNCHES[f"{key}_general"] == 1 and fk.LAUNCHES[key] == 0,
                  f"{key} {where}: launches {fk.LAUNCHES}")
            e = compare(f"{key} general path {where}", got, plain(*inputs), tol)
            ref = exact(*inputs)
            e_kernel, e_plain = max_err64(got, ref), max_err64(plain(*inputs), ref)
            with tf32_matmul():
                e_tf32 = max_err64(plain(*inputs), ref)
            print(f"  largest error against float64 (|ref| max {ref.abs().max().item():.3e}): kernel {e_kernel:.3e}, "
                  f"plain f32 chain {e_plain:.3e} (ratio {e_kernel / e_plain:.3f}, at most {F64_RATIO}); one-pass "
                  f"TF32 {e_tf32:.3e} (ratio {e_tf32 / e_plain:.1f}, must exceed {F64_RATIO})", flush=True)
            check(e_kernel <= F64_RATIO * e_plain, f"{key} general path {where}: not f32-grade against float64")
            check(e_tf32 > F64_RATIO * e_plain, f"{key} general path {where}: the check cannot tell TF32 from f32")
            del ref
            ms, plain_ms = cuda_ms(lambda: kern(*inputs)), cuda_ms(lambda: plain(*inputs), reps=5)
            general[key] = {"shape": where, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(*cost),
                            "bound_by": bound_by(*cost), "max_abs_err": e,
                            "f64_check": {"kernel": e_kernel, "plain_f32": e_plain, "tf32": e_tf32}}
            print(f"  {key} general path {where}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
                  f"{general[key]['bound_ms']:.4f} ms by {general[key]['bound_by']}), {card}", flush=True)
        fk.reset_launches()
        torch.cuda.synchronize()

    # ---- the main paths; each one's counts are zeroed just before and read just after
    results = {}
    for label, path, plain, kernel, inputs in (
        ("scorer (fused, two branches)", scorer, scorer_plain, "fused_forward", batches),
        ("bench forward (unfused, SIFT)", forward, forward_plain, "fisher_encode", float_batches),
    ):
        with phase(f"main path: {label}"):
            path(inputs[0])  # warm-up, not counted
            torch.cuda.synchronize()
            fk.reset_launches()
            t0 = time.perf_counter()
            outs = [path(b) for b in inputs[1:]]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(fk.LAUNCHES)
            ips = BATCHES * BATCH / dt
            print(f"  launches {launches}; {ips:.1f} images/s over {BATCHES} batches of {BATCH} "
                  f"({card})", flush=True)
            check(launches[kernel] > 0, f"{kernel} never launched on the main path")
            want = fv_launches(fused=2 * BATCHES) if kernel == "fused_forward" else fv_launches(encode=BATCHES)
            check(launches == want, f"launches {launches}, expected {want}")
            results[kernel] = {"launches": launches[kernel], "images_per_s": ips}

            agree, worst = 0, 0.0
            score_k = P.scores_of(path) if kernel == "fused_forward" else path
            score_p = P.scores_of(plain) if kernel == "fused_forward" else plain
            for b, out in zip(inputs[1:], outs):
                sk, sp = score_k(b), score_p(b)
                check(tuple(sk.shape) == (BATCH, NUM_CLASSES), f"scores shape {tuple(sk.shape)}")
                check(bool(torch.isfinite(sk).all()), "non-finite scores")
                worst = max(worst, max_err(sk, sp))
                tk = torch.topk(sk, 5, dim=1).indices if kernel == "fisher_encode" else out
                check(tuple(tk.shape) == (BATCH, 5), f"top-5 shape {tuple(tk.shape)}")
                tp = torch.topk(sp, 5, dim=1).indices
                agree += int((tk.sort(dim=1).values == tp.sort(dim=1).values).all(dim=1).sum())
            frac = agree / (BATCHES * BATCH)
            print(f"  scores vs plain-version pipeline: max_abs_err={worst:.3e} tol={TOL_SCORES:.0e}; "
                  f"top-5 agreement {frac:.4f}", flush=True)
            check(worst <= TOL_SCORES, f"scores differ by {worst:.3e}")
            check(frac >= TOP5_AGREEMENT, f"top-5 agreement {frac:.4f}")

    # ---- the kernel tier: the gram kernels, then its two main paths
    with phase("kernel TIMIT parameters (whitening fitted on the card)"):
        kt_scorer, kt_plain, frame_batches, serving = kernel_timit_setup(dev)
    data = krr_data(dev)
    gram_errs, gram_f64s = gram_checks(gk, dev, rng, serving, data[0])
    results["kernel_timit"] = kernel_timit_path(card, kt_scorer, kt_plain, frame_batches, KT, gk, fk)
    results["krr"] = krr_path(dev, card, gk, fk, data)
    fit_data = fit_setup(dev, P)
    results["fit"], fitted = fit_path(dev, card, P, fk, fit_data)
    results["graph"], graph_detail = graph_path(dev, card, P, fk, fit_data, fitted)
    results["stream"] = stream_path(dev, card, P, fk, fit_data, results["graph"], graph_detail)
    results["planning"] = planning_path(dev, card, P, fk, fit_data)
    graph_fitted = graph_detail["fitted"]  # served over HTTP by the serving phases
    del graph_detail
    results["tar"] = tar_path(dev, card, P)
    tier_tmp = Path(tempfile.mkdtemp(prefix="kernel_tier_", dir=REPO))
    try:
        for sub in ("timit", "cifar", "oc", "disk", "mnist"):
            (tier_tmp / sub).mkdir()
        results["kernel_timit_pipeline"] = kernel_timit_pipeline_path(dev, card, gk, fk, tier_tmp / "timit")
        results["kernel_cifar_pipeline"] = kernel_cifar_pipeline_path(dev, card, gk, fk, tier_tmp / "cifar")
        results["oc_krr"] = oc_krr_path(dev, card, gk, fk, data, tier_tmp / "oc")
        results["disk_tier"] = disk_tier_path(dev, card, gk, fk, data, tier_tmp / "disk")
        # the dense apps; LinearPixels, RandomPatchCifar and TimitPipeline
        # read the kernel pipelines' files
        cifar_paths = {k: str(tier_tmp / "cifar" / f"{k}.bin") for k in ("train_path", "test_path")}
        results["mnist"] = mnist_path(dev, card, gk, fk, tier_tmp / "mnist")
        results["linear_pixels"] = linear_pixels_path(dev, card, gk, fk, cifar_paths)
        results["random_patch_cifar"] = random_patch_path(dev, card, gk, fk, cifar_paths)
        results["timit"] = timit_path(dev, card, gk, fk, tier_tmp / "timit")
    finally:
        shutil.rmtree(tier_tmp, ignore_errors=True)
    results["voc"] = voc_path(dev, card, gk, fk)
    results["voc_fixture"] = voc_fixture_path(dev, card)
    # the text apps: trees and JSON lines written here
    text_tmp = Path(tempfile.mkdtemp(prefix="text_apps_", dir=REPO))
    try:
        (text_tmp / "news").mkdir()
        results["newsgroups"] = newsgroups_path(dev, card, gk, fk, text_tmp / "news")
        results["amazon"] = amazon_path(dev, card, gk, fk, text_tmp)
    finally:
        shutil.rmtree(text_tmp, ignore_errors=True)
    # the operations layer: the recovered streamed fit, the checkpointed
    # solvers, deadlines and breakers (phase 10's fit seconds, phase 14's data)
    results["operations"] = operations_path(dev, card, P, fk, gk, results["stream"], data,
                                            results["newsgroups"].pop("ls_problem"))

    # the serving path: S1 the full-width scorer behind serve(), S1b the
    # bench forward, S2 a saved graph-fitted model through `cli serve`, S3
    # the fleet's self-healing and a hot swap, S4 open-loop latency
    def b1_args(x):
        """B1's two calls on images ``x``, as the served scorer makes them."""
        xf = scorer.stages[0].apply_batch(x)
        raw, mask = FusedTransformer(list(sift_branch.stages)[:2]).apply_batch(xf)
        desc, dmask = lcs_branch.stages[0].apply_batch(xf)
        return [("SIFT", fused_args(fused_sift, raw, mask, fused_sift.mean)),
                ("LCS", fused_args(fused_lcs, desc, dmask, fused_lcs.mean))]

    served = serve_path(dev, card, P, fk, scorer, forward, images, float_batches, b1_args)
    served["s2"] = serve_http_path(dev, card, graph_fitted, fit_data[3])
    del graph_fitted
    params_swap = params_from_numpy(P.random_params(pca_dims=PCA_DIMS, gmm_k=GMM_K, num_classes=NUM_CLASSES, seed=4),
                                    dev)
    served["s3"] = fleet_path(dev, card, P, fk, scorer, images, params_swap)
    saturation_ips = served["s1"]["regimes"]["saturation"]["images_per_s"]
    served["s4"] = open_loop_path(dev, card, fk, scorer, images, saturation_ips)
    served["s5"] = lifecycle_path(dev, card, P, fk, scorer, images, params_swap, saturation_ips)
    del params_swap
    results["serve"] = served

    with phase("the profiled materialization passes of this process"):
        print(f"  {materialize['passes']} passes, {materialize['seconds']:.3f} s in all, "
              f"{materialize['fallbacks']} taken by the structural fallback ({card})", flush=True)
        check(materialize["passes"] > 0 and materialize["fallbacks"] == 0,
              f"profiled materialization {materialize}: a fit took the structural fallback")
        results["materialize"] = dict(materialize)
    with phase("kernel timing"):
        def kernel_line(name, replaces, kernel, plain, calls, shape):
            """Times summed over the kernel's calls in one forward of a
            batch; each call is (arguments, (n, T, d_in))."""
            ms = [cuda_ms(lambda a=a: kernel(*a)) for a, _ in calls]
            plain_ms = [cuda_ms(lambda a=a: plain(*a), reps=5) for a, _ in calls]
            costs = [fv_cost(n, t, PCA_DIMS, GMM_K, d_in=d_in) for _, (n, t, d_in) in calls]
            nbytes, flops = sum(c[0] for c in costs), sum(c[1] for c in costs)
            return {
                "name": name, "route": "cuda", "source": "keystone_tpu_torch/csrc/fisher.cu",
                "replaces": replaces, "launches": results[name]["launches"],
                "max_abs_err": errs[name], "ms": sum(ms), "plain_ms": sum(plain_ms),
                "bound_ms": sum(bound_ms(*c) for c in costs),
                "bound_by": "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES else "bytes",
                # 3xTF32 on the tensor cores: the bound the kernel is held to
                "bound_ms_tc": sum(fv_bound_ms_tc(n, t, PCA_DIMS, GMM_K, d_in=d_in) for _, (n, t, d_in) in calls),
                "f64_check": fv64[name],
                # no single PyTorch call computes a Fisher-vector encode,
                # and no one gemm is its floor
                "library_ms": None, "gemm_ms": None,
                "shape": shape, "ms_each_call": ms, "plain_ms_each_call": plain_ms,
            }

        lines = [
            kernel_line("fisher_encode", "keystone_tpu/ops/fisher_pallas.py:204",
                        fk.fisher_encode, fk.fisher_encode_ref,
                        [((fx, fmask, *gmm_b2), (BATCH, 784, 0))],
                        "(128, 784, 64) K=256, per batch"),
            kernel_line("fused_forward", "keystone_tpu/ops/fisher_pallas.py:265",
                        fk.fused_forward, fk.fused_forward_ref,
                        [(fused_args(fused_sift, sift_raw, sift_mask, fused_sift.mean), (BATCH, 784, 128)),
                         (fused_args(fused_lcs, lcs_desc, lcs_mask, fused_lcs.mean), (BATCH, 324, 96))],
                        "SIFT (128, 784, 128->64) + LCS (128, 324, 96->64) K=256, per batch"),
        ]
        # B1 at the fit's shape: one training batch of its featurizer, K = 64
        cfg_fit, tx = fit_data[0], fit_data[1]
        fit_feat = P.build_featurizer(fitted, cfg_fit, dev)
        xf_fit = fit_feat.stages[0](tx[:FIT_BATCH])
        fit_sift, fit_lcs = fit_feat.stages[1].branches
        fit_calls = [
            (fused_args(fit_sift.stages[2], *FusedTransformer(list(fit_sift.stages)[:2])(xf_fit),
                        fit_sift.stages[2].mean),
             (FIT_BATCH, FIT_SIFT_T, 128)),
            (fused_args(fit_lcs.stages[1], *fit_lcs.stages[0](xf_fit), fit_lcs.stages[1].mean),
             (FIT_BATCH, FIT_LCS_T, 96)),
        ]
        # B1 against its plain version at the fit's shape, on the fitted
        # GMM: PCA leaves small variances, so the log posterior and Φ²
        # cancel terms of μ²/σ² ≫ 1, and two f32 chains summing in other
        # orders differ beyond the scorer's tolerance.  Held against the
        # plain chain in float64 as the scorer's calls are, f32-grade
        # where f32 itself misses that tolerance (as B4's linear case)
        for ln in lines:
            ln["general_path"] = general[ln["name"]]
        b1 = lines[1]
        b1["f64_check_fit"], b1["max_abs_err_fit"] = {}, 0.0
        for a, (n, t, d_in) in fit_calls:
            check(tuple(a[0].shape) == (n, t, d_in), f"B1 fit input {tuple(a[0].shape)}")
            e, f64 = fv_shape_check(f"B1 at the fit's shape ({n}, {t}, {d_in}->{PCA_DIMS}), K={FIT_GMM_K}",
                                    fk.fused_forward, fk.fused_forward_ref, fused_f64, a, TOL_FUSED)
            b1["max_abs_err_fit"] = max(b1["max_abs_err_fit"], e)
            b1["f64_check_fit"][f"({n}, {t}, {d_in}->{PCA_DIMS}) K={FIT_GMM_K}"] = f64
        graph = results["graph"]
        stream = results["stream"]
        b1["launches"] += (results["fit"]["launches"] + graph["launches_scoring"]["fused_forward"]
                           + stream["launches_scoring"]["fused_forward"])
        b1["launches_by_path"] = {"scorer": results["fused_forward"]["launches"], "fit": results["fit"]["launches"],
                                  "graph_scoring": graph["launches_scoring"]["fused_forward"],
                                  "stream_scoring": stream["launches_scoring"]["fused_forward"]}
        # B2 at the graph fit's shape: one chunk of the training set a branch
        b2, b2g = lines[0], graph.pop("b2_fit_shape")
        b2["launches"] += graph["launches_fit"]["fisher_encode"] + stream["launches_fit"]["fisher_encode"]
        b2["launches_by_path"] = {"bench_forward": results["fisher_encode"]["launches"],
                                  "graph_fit": graph["launches_fit"]["fisher_encode"],
                                  "stream_fit": stream["launches_fit"]["fisher_encode"]}
        # the fit planning phases: the structural, profiled, demoted and
        # auto-spilled fits (B2 in each fit, B1 in each one's scoring)
        for ln, kname in ((b1, "fused_forward"), (b2, "fisher_encode")):
            c = results["planning"]["launches"][kname]
            ln["launches_by_path"]["fit planning (four fits and their scoring)"] = c
            ln["launches"] += c
        # the operations phases: the three hooks-at-rest fits and both
        # attempts of the recovered fit (the child processes' counts)
        for ln, kname in ((b1, "fused_forward"), (b2, "fisher_encode")):
            c = results["operations"]["fv_launches"][kname]
            ln["launches_by_path"]["operations (streamed fits and their recovery)"] = c
            ln["launches"] += c
        # the serving phases: B1 in every flush of the served scorer (S1,
        # its raw scores, the `cli serve` child's graph-fitted model, the
        # swap service's two generations, the open loop, the lifecycle's
        # walks and its bucket graphs' replays, in this process and in its
        # `cli serve` child), B2 in the served bench forward's
        s5 = served["s5"]
        for ln, kname, parts in (
            (b1, "fused_forward", (("serve S1 scorer and raw scores", served["launches_fused_forward"]),
                                   ("serve S2 `cli serve` child", served["s2"]["launches"]["fused_forward"]),
                                   ("serve S3 swap service", served["s3"]["launches"]["fused_forward"]),
                                   ("serve S4 open loop", served["s4"]["launches"]["fused_forward"]),
                                   ("serve S5 lifecycle, by the wrapper", s5["launches"]["fused_forward"]),
                                   ("serve S5 lifecycle, by bucket-graph replays", s5["replayed"]["fused_forward"]),
                                   ("serve S5 `cli serve --watch` child, by the wrapper",
                                    s5["watcher"]["launches"]["fused_forward"]),
                                   ("serve S5 `cli serve --watch` child, by bucket-graph replays",
                                    s5["watcher"]["replayed"].get("fused_forward", 0)))),
            (b2, "fisher_encode", (("serve S1b bench forward", served["launches_fisher_encode"]),)),
        ):
            for label, c in parts:
                ln["launches_by_path"][label] = c
                ln["launches"] += c
        b1["serve_bucket_checks"] = served["b1_buckets"]
        b1["graph_replays"] = s5["replayed"]["fused_forward"] + s5["watcher"]["replayed"].get("fused_forward", 0)
        # VOCSIFTFisher: B2 featurizes the training set in the fit, B1 (one
        # fused node) scores run's test set and VOC's 4952
        voc = results["voc"]
        for ln, kname, key in ((b1, "fused_forward", "b1_voc_shape"), (b2, "fisher_encode", "b2_voc_shape")):
            for mode in ("in memory", "stream"):
                for part in ("launches_fit", "launches_scoring", "launches_held_out"):
                    c = voc[mode][part][kname]
                    if c:
                        ln["launches_by_path"][f"VOCSIFTFisher {mode} {part[9:].replace('_', ' ')}"] = c
                        ln["launches"] += c
            ln["voc_shape"] = voc[key]
        b2["f64_check_graph_fit"], b2["max_abs_err_graph_fit"] = b2g["f64_check"], b2g["max_abs_err"]
        b2["f64_check_stream_fit"] = stream["b2_batch_shape"]["f64_check"]
        b2["max_abs_err_stream_fit"] = stream["b2_batch_shape"]["max_abs_err"]
        b2["ms_graph_fit_each_call"] = [cuda_ms(lambda a=a: fk.fisher_encode(*a)) for a, _ in b2g["calls"]]
        b2["plain_ms_graph_fit_each_call"] = [cuda_ms(lambda a=a: fk.fisher_encode_ref(*a), reps=5)
                                             for a, _ in b2g["calls"]]
        b2["ms_graph_fit"] = sum(b2["ms_graph_fit_each_call"])
        b2["plain_ms_graph_fit"] = sum(b2["plain_ms_graph_fit_each_call"])
        g_costs = [fv_cost(n, t, PCA_DIMS, FIT_GMM_K) for _, (n, t) in b2g["calls"]]
        b2["bound_ms_graph_fit"] = sum(bound_ms(*c) for c in g_costs)
        b2["bound_ms_tc_graph_fit"] = sum(fv_bound_ms_tc(n, t, PCA_DIMS, FIT_GMM_K) for _, (n, t) in b2g["calls"])
        b2["shape_graph_fit"] = (f"SIFT ({FIT_BATCH}, {FIT_SIFT_T}, 64) + LCS ({FIT_BATCH}, {FIT_LCS_T}, 64) "
                                 f"K={FIT_GMM_K}, per training chunk of the graph fit")
        b1["ms_fit_each_call"] = [cuda_ms(lambda a=a: fk.fused_forward(*a)) for a, _ in fit_calls]
        b1["plain_ms_fit_each_call"] = [cuda_ms(lambda a=a: fk.fused_forward_ref(*a), reps=5) for a, _ in fit_calls]
        b1["ms_fit"], b1["plain_ms_fit"] = sum(b1["ms_fit_each_call"]), sum(b1["plain_ms_fit_each_call"])
        fit_costs = [fv_cost(n, t, PCA_DIMS, FIT_GMM_K, d_in=d_in) for _, (n, t, d_in) in fit_calls]
        b1["bound_ms_fit"] = sum(bound_ms(*c) for c in fit_costs)
        b1["bound_ms_tc_fit"] = sum(
            1e3 * max(c[0] / PEAK_BYTES, 3 * c[1] / PEAK_TF32_FLOPS) for c in fit_costs)
        b1["shape_fit"] = (f"SIFT ({FIT_BATCH}, {FIT_SIFT_T}, 128->64) + LCS ({FIT_BATCH}, {FIT_LCS_T}, 96->64) "
                           f"K={FIT_GMM_K}, per training batch of the fit")
        for ln in lines:
            print(f"  {ln['name']}: {ln['ms']:.4f} ms (plain {ln['plain_ms']:.4f} ms, bound "
                  f"{ln['bound_ms']:.4f} ms by {ln['bound_by']}, on the tensor cores {ln['bound_ms_tc']:.4f} ms) "
                  f"per batch of {BATCH}, {card}")
        print(f"  fisher_encode at the graph fit's shape: {b2['ms_graph_fit']:.4f} ms (plain "
              f"{b2['plain_ms_graph_fit']:.4f} ms, bound {b2['bound_ms_graph_fit']:.4f} ms, on the tensor cores "
              f"{b2['bound_ms_tc_graph_fit']:.4f} ms) per training chunk of {FIT_BATCH}, {card}")
        print(f"  fused_forward at the fit's shape: {b1['ms_fit']:.4f} ms (plain {b1['plain_ms_fit']:.4f} ms, bound "
              f"{b1['bound_ms_fit']:.4f} ms, on the tensor cores {b1['bound_ms_tc_fit']:.4f} ms) per training "
              f"batch of {FIT_BATCH}, {card}")
        lines += gram_lines(gk, serving, data[0], gram_errs, gram_f64s, results)
        for ln in lines[2:]:
            print(f"  {ln['name']}: {ln['ms']:.4f} ms (plain {ln['plain_ms']:.4f} ms, gemm "
                  f"{ln['gemm_ms']:.4f} ms, bound {ln['bound_ms']:.4f} ms by {ln['bound_by']}, on the "
                  f"tensor cores {ln['bound_ms_tc']:.4f} ms) at {ln['shape']}, {card}")
            for label, t in ln["shapes"].items():
                print(f"  {ln['name']} at {label} {t['shape']}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, "
                      f"bound {t['bound_ms']:.4f} ms by {t['bound_by']}, on the tensor cores "
                      f"{t['bound_ms_tc']:.4f} ms), {card}")

    if args.profile:
        from keystone_tpu_torch.loaders.timit import TimitFeaturesDataLoader
        from keystone_tpu_torch.models import kernel_ridge as KR
        from keystone_tpu_torch.workflow.blockstore import RowBlockStore
        from keystone_tpu_torch.workflow.dataset import Dataset

        krr_est = KR.KernelRidgeRegressionEstimator(
            KR.GaussianKernelGenerator(KRR_GAMMA), lam=KRR_LAM, block_size=KRR_BLOCK, num_epochs=KRR_EPOCHS)
        prof_tmp = Path(tempfile.mkdtemp(prefix="profile_", dir=REPO))
        rows = RowBlockStore.from_array(str(prof_tmp / "rows"), data[0], KRR_BLOCK)
        kt_cfg = KT.Config(synthetic_n=KT_N)
        kt_train = TimitFeaturesDataLoader.synthetic(KT_N, kt_cfg.num_classes, seed=1, device=dev)
        for label, fn in (
            ("one scorer batch", lambda: scorer(images[:BATCH])),
            ("one kernel TIMIT batch", lambda: kt_scorer(frame_batches[1])),
            ("one in-core KRR fit", lambda: krr_est.fit_arrays(data[0], data[1], device=dev)),
            ("one ImageNetSiftLcsFV fit",
             lambda: P.fit_params(fit_data[0], fit_data[1], fit_data[2], dev, batch_size=FIT_BATCH)),
            ("one ImageNetSiftLcsFV graph fit (Pipeline.fit)", lambda: P.ImageNetSiftLcsFV.build(
                fit_data[0], Dataset(fit_data[1]), Dataset(torch.from_numpy(fit_data[2]).to(dev))).fit()),
            ("one KernelTimitPipeline graph fit in memory (Pipeline.fit)",
             lambda: KT.KernelTimitPipeline.build(kt_cfg, kt_train.data, kt_train.labels).fit()),
            ("one out-of-core KRR sweep (fit_store)", lambda: krr_est.fit_store(rows, Dataset(data[1]))),
        ):
            with phase(f"profile {label}"):
                profile_once(fn)
        # the dense apps' graph fits in memory, each pipeline built once
        # (RandomPatchCifar learns its filters in the build)
        from keystone_tpu_torch.loaders.cifar import CifarLoader
        from keystone_tpu_torch.loaders.mnist import MnistLoader
        from keystone_tpu_torch.loaders.voc import VOCLoader
        from keystone_tpu_torch.pipelines import linear_pixels, mnist_random_fft, random_patch_cifar, timit
        from keystone_tpu_torch.pipelines import voc_sift_fisher

        mn = MnistLoader.synthetic(MNIST_N, seed=1, device=dev)
        cf = CifarLoader.synthetic(CIFAR_N, seed=1, device=dev)
        vo = VOCLoader.synthetic(VOC_N, seed=1, device=dev)
        for app, mod, ld in ((mnist_random_fft.MnistRandomFFT, mnist_random_fft, mn),
                             (linear_pixels.LinearPixels, linear_pixels, cf),
                             (random_patch_cifar.RandomPatchCifar, random_patch_cifar, cf),
                             (timit.TimitPipeline, timit, kt_train),
                             (voc_sift_fisher.VOCSIFTFisher, voc_sift_fisher, vo)):
            pipe = app.build(mod.Config(), ld.data, ld.labels)
            with phase(f"profile one {app.name} graph fit in memory (Pipeline.fit)"):
                profile_once(pipe.fit)
            del pipe
        shutil.rmtree(prof_tmp, ignore_errors=True)

    print(json.dumps({
        "images_per_s": {k: results[k]["images_per_s"] for k in ("fused_forward", "fisher_encode")},
        "frames_per_s": results["kernel_timit"]["frames_per_s"],
        "krr": results["krr"],
        "fit": results["fit"],
        "graph": results["graph"],
        "stream": results["stream"],
        "tar": results["tar"],
        "kernel_timit_pipeline": results["kernel_timit_pipeline"],
        "kernel_cifar_pipeline": results["kernel_cifar_pipeline"],
        "oc_krr": results["oc_krr"],
        "disk_tier": results["disk_tier"],
        "dense_apps": {k: results[k] for k in ("mnist", "linear_pixels", "random_patch_cifar", "timit", "voc",
                                                "voc_fixture")},
        "text_apps": {k: results[k] for k in ("newsgroups", "amazon")},
        "operations": results["operations"],
        "serve": results["serve"],
        "card": card,
    }))
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
