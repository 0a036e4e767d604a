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
10c. A19, the solver product (``csrc/solver_gemm.cu``, one-pass TF32 by
   ``mma.sync``, per call) after the flagship fit's phases: (a) the
   kernel at the main path's products (the weighted BCD's Gramian and
   AᵀY on S9's problem, the EM's rᵀx on the fit's SIFT GMM sample, the
   masked PCA's xcᵀxc on its descriptor sample) against its plain
   version (float64 on the TF32-rounded operands) within
   ``solver_kernels.err_limit`` entry by entry (h·2⁻²⁴·(|a|ᵀ|b|), h the
   depth of the kernel's f32 sums), with a dropped chunk of k and
   truncated operands planted outside it, bit for bit across two calls,
   its and cuBLAS f32's distance from float64, its ms against its bound
   (a Gramian's symmetric half), the plain version and torch.matmul in
   f32 and with the TF32 flag; (b) the graph fit that
   ImageNetSiftLcsFV.run makes (``Pipeline.fit`` of
   ``ImageNetSiftLcsFV.build``) on the fit leg's images, in a child
   process under ``KEYSTONE_SOLVER_PRECISION=default`` (the solver
   kernel's launches counted there, more than 0, and the split's sum
   once for each split product): held-out top-1 error within 0.01 of
   phase 9's f32 fit and under the gate (a guard against gross failure:
   the synthetic classes separate at either precision), top-5, top-1
   agreement, and ``Pipeline.fit`` and ``fit_params``' stage seconds
   under ``float32`` and ``default`` by turns in that one child; (c)
   S9's weighted BCD
   problem in this process under default: the weights against float64
   beside the f32 fit's, the objective within 1e-3 relative of f32's,
   seconds; (d) the scorer on one batch in a thread beside (c)'s fit
   under default, bit for bit its output alone, the TF32 flags False
   before, during and after;
11. the tar loader on the committed fixture (tests/data/imagenet_tars),
   decoded on the card by nvJPEG: ``index``, ``load`` and ``stream``
   agree (the undecodable member skipped by ``load``, a zero image with
   its label in ``stream``), the pixels within the stated difference of
   the reference's libjpeg decode committed beside the fixture, and
   ``run`` from the tars with ``stream`` at accuracy above 0.9;
12. main path, KernelTimitPipeline.run through the graph at its Config's
   full width (d = 440, 2048 landmarks, γ = 0.015, 147 classes, blocks of
   1024; its solve swept once, of the Config's 3 epochs) on 262 144
   synthetic frames (seed 1; 65 536 held out, seed 2): in memory, then with ``stream`` from an .npy written here in
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
14b. A18, the loaders' and out-of-core solvers' knobs, after phase 14 on
   the data already made: (a) the tar fixture through nvJPEG with
   ``label_map`` (the synsets reversed) and ``limit=7`` at ``prefetch`` 1
   and 4, bit for bit the default stream's first 7, and ``load(limit=7)``
   giving members 0-5 and 7; (b) ``_oc_bcd_fit`` on a FeatureBlockStore at
   S9's width (2048 x 16 384 f32 from ``--seed``, blocks of 4096, 64
   classes, 2 epochs) at ``prefetch`` 1, 2, 4, ``window`` 1, 4 and
   ``KEYSTONE_VERIFY_BLOCKS=0``, each bit for bit the default, and both
   estimators' ``spill_dtype="bfloat16"`` streamed fits (half the spill's
   bytes, weights and intercept within 2e-2 of the f32 fit); (c) phase
   14's out-of-core KRR at ``prefetch=3`` and ``KEYSTONE_OC_PREFETCH=4``,
   α bit for bit phase 14's default fit with equal B3 launches; (d) ``KEYSTONE_APPLY_CHUNK``
   unset (128), 0, 100 and 512 over the bench forward's featurization of
   512 images, ⌈512/chunk⌉ B2 launches each; its figures on an ``a18``
   line before the kernels line;
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
   3 epochs, 147 classes) on the first eighth of phase 12's .npy frames
   (32 768 + 8192), in memory and streamed in batches of 8192: scores and classes
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
   bigrams, nb λ 1.0, ls λ 1e-2) on a quarter of 20 Newsgroups' bydate
   split sizes (2828 + 1883 synthetic documents in 20 groups, written as
   root/<group>/<doc> trees), both heads in memory and streamed in
   batches of 512, each under the profiler: no kernel launched, the
   vocabulary, fit seconds and documents/s, the host text, bucketing and
   device seconds apart, the L-BFGS iterations, line-search trials and
   host reads, the idle share and peak device memory; sparse_matmul and
   sparse_grad at its bucket shapes against a float64 torch.sparse.mm of
   the same rows, naive Bayes against float64 counts, the card's ls fit
   against the same fit on the CPU, streamed against in memory;
22. main path, AmazonReviewsPipeline.run at its Config (16 384 hashed
   features as CSR rows, λ 1e-4, 40 iterations) on 25 000 + 6250
   synthetic reviews written as JSON lines, in memory and streamed in
   batches of 1024, printed and held the same way, the logistic fit in
   place of the ls fit;
23. main path, the operations layer of a fit, each part with its own
   temporary directories: the streamed ImageNetSiftLcsFV fit at phase
   10's leg on a quarter of its images three ways (nothing attached, a
   run ledger, an empty fault plan: seconds an image against phase 10's,
   B1/B2 launches, the three fits bit for bit, the ledger's span and
   event counts); ``fit_with_recovery``
   of that fit with a state_dir and the solver's checkpoint_dir, attempt
   1 in a child process of this script (``--recovery-child``) under a
   KEYSTONE_FAULTS plan (a stage, two stream batches and two block reads
   raised and survived, injected = survived per site; ``exit`` at the
   second epoch save), attempt 2 relaunched in this process (holding
   nothing of attempt 1 but its files), resuming the BCD from epoch 1, its vocabularies, weights and held-out scores equal to the
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
   generator at 50% and 90% of S1's saturation rate, 1.5 s each (p50/p99/p99.9, sheds,
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
   the larger of S1's and the graphs-on loop's saturation growing the fleet, each new replica primed from the
   graphs, and shrinking back to 1 when idle; no artifact fallback
   anywhere, B1's launches by the wrapper and by replays; S6, the process
   and network fleets: B1 at the serving buckets 8..64 (times, bounds,
   errors); the raw scorer with its bundle behind ``serve(workers=2)``,
   each worker on the card with its own bucket graphs (spawn and ready
   seconds, its peak reserved memory), the served scores against the
   offline ones with top-5 equal, one full 128-row slab block through it
   and through the threaded fleet (``replicas=1``) bit for bit, a worker
   SIGKILLed under the closed loop (no future lost, the slot healed, the
   replacement's graphs captured), S1's saturation loop once on
   the threaded fleet and on workers=2 (images/s, p50/p99, requests
   a flush, the flushes in flight on the router and the share of the wall
   each worker spent in its applies, nvidia-smi's utilization as a coarse counter),
   the binary ingress in front of workers=2 (bit for bit the HTTP JSON
   answers, no byte copied on the slab-direct path), serve_bench's
   ingress A/B at full width in front of the threaded fleet and of
   workers=2 (per-datum HTTP JSON against binary 128-image batches),
   the network fleet of two ``cli worker`` children
   over loopback with one link partitioned past its lease mid-load
   (nothing lost, healed, bit for bit the process fleet's); the
   workers' B1 launches and replays, as they reported them, and none in
   the router while they serve; S7, multi-tenant serving: three tenants
   over S1's featurizer, each with a head of its own, as workflow graphs
   saved and loaded apart (the sharing plan keys them by content), the
   card's freeze fusing each PCA -> FV pair; one padded batch of 128
   through MultiTenantApplier with the share on and off (B1 2 and 6
   times, bit for bit, pool hits, peak under the budget, 0 bytes left);
   serve_multi's closed loop (each tenant's scores against its offline
   scorer, top-5, B1 twice a combined flush); a serve.batch fault aimed
   at one tenant failing its riders only; one tenant against serve()
   bit for bit; ``cli serve`` with three named models over HTTP (an
   unknown tenant 400; the child's B1 twice a flush); serve_bench's
   tenant A/B in short legs (rates printed); then the chaos tool on the
   card: the ``tenants`` workload and a seeded 2 s soak over two worker
   processes, each exiting 0; S8, the pre-flight analyzer and the physical
   planner: ``cli check --all`` in a child on the card (every bundled
   pipeline, no finding, no launch, no device memory moved around each
   analysis); a mis-wired FV pipeline and a bad fault plan refused by
   ``fit(validate=True)`` before any launch; S1's scorer as a graph
   frozen with ``plan=True`` (the ``fused_fv`` gate's candidates, B1
   against PCA then B2, sampled at 8, 32 and 128 rows: samples, curves,
   winner), its output bit for bit a freeze with the winner forced and no
   plan, the two candidates within the scorer's tolerance; a fresh
   applier frozen under the other choice installing the plan's bundle,
   re-optimized and its bucket graph captured under the plan; a
   ``plan.sample`` delay flipping the winner; ``cli plan`` and ``cli
   export --plan``, a ``cli serve --model-dir`` child serving the shipped
   plan (/statusz source ``artifacts``); serve_bench's plan A/B (1 s legs,
   1 round) and its drift retune (no future lost);
25. S9, the parallel layer (``keystone_tpu_torch/parallel/``), in rank
   processes of this script (``--parallel-rank``; the three launches
   start together, each leg's work waits for the one before) at the operations
   layer's in-core fit width (2048 x 16 384 features from ``--seed``,
   blocks of 4096, 64 classes, 2 epochs): one rank over NCCL (the
   checkpointed BCD and the weighted BCD bit for bit the fits with no
   group, their all-reduces counted and traced, DistributedPCAEstimator
   at 131 072 x 128 -> 64 against PCAEstimator's projector); two ranks
   over Gloo on CUDA tensors, 1024 rows each, under a ``multihost.init``
   fault retried once (the fits f32-grade against one rank and float64,
   a per-rank store of 512 rows through the weighted ``fit_store``
   against the in-memory fit, a sick rank aborting both at the health
   barrier), then rank 1 killed before its second epoch and both
   relaunched (resumed from epoch 1, bit for bit the uninterrupted
   two-rank fit);
   each leg's seconds and the fit's at one rank against two;
26. the read side and the debug helpers (A9b), each phase timed: after the
   text apps, ``tools/roofline_forward.py`` single-scale at batch 128
   and multi-scale (bins 4, 6, 8, 10) at batch 64, each stage's device µs
   (torch.profiler, median of 8 traced iterations) against its bound, no
   stage over 1.05 of it, the stages' sum within 1.05x the wall marginal
   a batch, the FV stage within 10% of B2 timed here at that shape, B2
   launched once a traced iteration; ``tools/obs_report.py`` over the
   recovered fit's ledger and ``tools/trace_report.py`` over S4's
   recorder dump, each a child exiting 0 with its sections and counts
   those the phase recorded; after the roofline, ``host_map`` over two
   forkserver workers with this process's CUDA context live, the Python
   text chain's rows bit for bit the sequential ones, and
   ``tools/bench_text.py``'s docs/s for the Python and native chains on
   the same pool;
27. the host float64 reference (A12, ``ops/fisher_ffi.py`` → g++'s
   ``csrc/keystone_ffi.cpp``), after the FV kernels' checks: the encode of
   8 images at the scorer's B2 shape against the plain chain in float64
   on the card, and B2 and the plain f32 chain against it (B2 within 2x
   the plain chain's error); 5 EM steps at 16 384 rows of S9's GMM sample
   (d = 64, K = 64) against the port's EM in float64 and in f32 on the
   card; then DAISY and SIFT's conv windowing (A17) on the card at
   bench.py's batch and image size, against the same chains in float64
   and the conv form against the matmul form, each timed;
28. S10, serve_bench's modes (A9c) at the tool's defaults with one round
   and 1 s legs, after S8: the recorder on against off, hedging around a
   stalled replica, threads against worker processes on the GIL-held
   featurizer (bit for bit), the autoscale scenario (nothing lost or
   hung, back to one worker), cold start and restart with bucket graphs
   against none (each sample a fresh process; no fallback, one
   prediction digest) and a zoo replay; in S5, the cold-start A/B once
   against its published full-width scorer;
29. the whole script's seconds; a ``host_ref`` line of A12's figures; one
   JSON line of kernel numbers (ms, plain ms, bounds on the CUDA
   cores and on the tensor cores, launches (bucket-graph replays
   included), float64 errors) for all four kernels and A19's solver
   product, B3's and B4's times at the new paths' shapes and B1's and
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
import hashlib
import json
import logging
import os
import shutil
import socket
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
# KernelTimitPipeline's runs, in memory and streamed, sweep their solve
# once (the Config has 3): the streamed run's out-of-core solve rereads
# its 2 GiB spill each epoch (33.4 s of the 61.2 s run at 3 epochs on an
# H100 80GB HBM3, 700 W); the landmarks, K_LL and the features do not
# depend on it
KT_PIPE_EPOCHS = 1
# TimitPipeline on the first eighth of those frames (both runs, and the
# streamed one in 4 batches of its Config's 8192): its streamed run read
# all 262 144 in 96.4 s of the script's 1200 s limit on an H100
TIMIT_PIPE_N, TIMIT_PIPE_TEST_N = KT_N // 8, KT_TEST_N // 8
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
# ls λ 1e-2) on a quarter of 20 Newsgroups' "bydate" split sizes, 2828
# training and 1883 test documents of the reference's synthetic corpus
# at 20 groups (seeds 1 and 2), written here as root/<group>/<doc> trees:
# both heads in memory and streamed in batches of 512;
# AmazonReviewsPipeline (16 384 hashed features as CSR rows, λ 1e-4, 40
# iterations) on 25 000 synthetic reviews and the Config's quarter,
# 6250, for test (seeds 1 and 2), written here as JSON lines: in memory
# and streamed in batches of 1024.  The document counts are a quarter
# of the datasets' (the whole ones until the parallel layer's second
# slice, then half; a quarter since the script needed more room under
# its time limit): these paths run on the host, and a slow host stretched
# them from ~120 to ~265 s of the script on an H100 80GB HBM3, 700 W.  No kernel lies on
# these paths: the gathers, scatter-adds and the L-BFGS loop are torch's
# own ops, as XLA's are in the reference.
NEWS_N, NEWS_TEST_N, NEWS_CLASSES, NEWS_BATCH = 11_314 // 4, 7_532 // 4, 20, 512
NEWS_CPU_N = NEWS_N // 4  # the card-vs-CPU ls pair's documents
AMAZON_N, AMAZON_BATCH = 100_000 // 4, 1024
TEXT_ACCURACY_MIN = 0.9
# the sparse ops at the apps' bucket shapes against a float64
# torch.sparse.mm of the same CSR rows: an f32 sum of m terms in any order
# is within m·2⁻²⁴·Σ|terms| of the exact sum (about √m times less in
# practice); held elementwise at 1e-5·Σ|terms| (m ≤ 5657 rows in a
# gradient's column, 2⁻²⁴·m = 3.4e-4 at worst)
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


#: the script's start, for its total seconds
T_START = time.perf_counter()


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
    """The FV plain chain (``fisher_encode_ref``) in float64 on the same
    operands."""
    from keystone_tpu_torch.ops.fisher_kernels import fisher_encode_ref

    return fisher_encode_ref(*(a.double() for a in (xs, mask, w, mu, var)))


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

    cfg = KT.Config(synthetic_n=KT_N, num_epochs=KT_PIPE_EPOCHS)
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
    Pipeline with a save/load round trip, and a checkpoint resume.  Returns
    (figures, the default fit's α), the latter for phase 14b."""
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
    return out, oc.alpha


# A18: the knobs.  (b)'s store is S9's problem; the bf16 spill is held at
# the reference's 2e-2 (tests/test_outofcore.py).  (d)'s featurizations
# are held against the default chunk at B2's own tolerance: another chunk
# is another M for the PCA product, which cuBLAS may run by another
# algorithm, and B2's per-image sums do not depend on the batch.
A18_PREFETCHES, A18_WINDOWS = (1, 2, 4), (1, 4)
TOL_BF16_SPILL = 2e-2
A18_APPLY_N = 512
A18_CHUNKS = (None, "0", "100", "512")  # None: KEYSTONE_APPLY_CHUNK unset


def a18_tar(dev):
    """(a): label_map, limit and prefetch on the tar fixture through nvJPEG."""
    from keystone_tpu_torch.loaders import jpeg
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader

    out = {}
    with phase("A18 (a): label_map, limit and prefetch on the tar fixture through nvJPEG"):
        t0 = time.perf_counter()
        full = ImageNetLoader.stream(str(TARS), size=TAR_SIZE, batch_size=5, device=dev)
        every = torch.cat([a for a, _ in full.data.device_batches()])
        synsets = sorted(os.path.splitext(f)[0] for f in os.listdir(TARS) if f.endswith(".tar"))
        label_map = {s: i for i, s in enumerate(reversed(synsets))}
        jpeg.reset_launches()
        for p in (1, 4):
            st = ImageNetLoader.stream(str(TARS), label_map=label_map, size=TAR_SIZE, batch_size=5, limit=7,
                                       prefetch=p, device=dev)
            got = torch.cat([a for a, _ in st.data.device_batches()])
            labels = st.labels.numpy().tolist()
            check(st.data.n == 7 and torch.equal(got, every[:7]), f"stream(limit=7, prefetch={p}): pixels")
            check(labels == [2, 2, 2, 2, 1, 1, 1], f"stream(label_map=reversed, prefetch={p}): labels {labels}")
        mem = ImageNetLoader.load(str(TARS), size=TAR_SIZE, limit=7, device=dev)
        members = [0, 1, 2, 3, 4, 5, 7]
        check(torch.equal(mem.data.array, every[members]), "load(limit=7) is not members 0-5 and 7")
        check(mem.labels.numpy().tolist() == [0, 0, 0, 0, 1, 1, 1], "load(limit=7)'s labels")
        check(jpeg.LAUNCHES["nvjpeg"] > 0 and jpeg.LAUNCHES["libjpeg"] == 0, f"decoders {jpeg.LAUNCHES}")
        out.update({"stream_limit7_equal_default": True, "load_limit7_members": members,
                    "decoder_launches": dict(jpeg.LAUNCHES), "seconds": time.perf_counter() - t0})
        print(f"  stream(limit=7, label_map=reversed) at prefetch 1 and 4: the default stream's first 7 bit for "
              f"bit, labels [2, 2, 2, 2, 1, 1, 1]; load(limit=7): members {members}; decoders {jpeg.LAUNCHES}",
              flush=True)
    return out


def a18_oc_bcd(dev, card, tmp, seed):
    """(b): the out-of-core BCD's prefetch, window, KEYSTONE_VERIFY_BLOCKS
    and spill_dtype at S9's width."""
    from keystone_tpu_torch.loaders.stream import batched
    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator, _oc_bcd_fit, finish_block_model
    from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore
    from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset

    out = {}
    with phase(f"A18 (b): the out-of-core BCD's knobs at {S9_N} x {S9_D}, blocks of {S9_BLOCK}"):
        x, y = s9_problem(seed)
        store = FeatureBlockStore.from_array(str(tmp / "bcd"), x, S9_BLOCK)
        yd = torch.from_numpy(y).to(dev)
        alpha = torch.ones(S9_N, device=dev)

        def fit(**kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = _oc_bcd_fit(store, yd, alpha, float(S9_N), S9_LAM, S9_EPOCHS, True, **kw)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0

        def same(a, b):
            return all(torch.equal(u, v) for u, v in zip(a, b))

        base, t_base = fit()  # warm already: phase 8's fit solved blocks of this width
        seconds = {"default": t_base}
        for p in A18_PREFETCHES:
            res, seconds[f"prefetch={p}"] = fit(prefetch=p)
            check(same(res, base), f"_oc_bcd_fit at prefetch={p} differs from the default")
        for w in A18_WINDOWS:
            store.iter_device_blocks = lambda order, device, w=w, **kw: FeatureBlockStore.iter_device_blocks(
                store, order, device, window=w, **kw)
            try:
                res, seconds[f"window={w}"] = fit()
            finally:
                del store.iter_device_blocks
            check(same(res, base), f"_oc_bcd_fit at window={w} differs from the default")
        with env_var("KEYSTONE_VERIFY_BLOCKS", "0"):
            res, seconds["KEYSTONE_VERIFY_BLOCKS=0"] = fit()
        check(same(res, base), "_oc_bcd_fit with KEYSTONE_VERIFY_BLOCKS=0 differs from the default")
        print(f"  bit for bit the default at prefetch {A18_PREFETCHES}, window {A18_WINDOWS} and "
              f"KEYSTONE_VERIFY_BLOCKS=0; sweep seconds {_rounded(seconds, 4)} ({card})", flush=True)
        out.update({"store_bytes": store.nbytes(), "sweep_seconds": seconds,
                    "verify_blocks_seconds": {"on": t_base, "off": seconds["KEYSTONE_VERIFY_BLOCKS=0"]}})

        spills = []
        raw = FeatureBlockStore.__dict__["from_batches"]

        def spy(*a, **kw):
            st = raw.__func__(FeatureBlockStore, *a, **kw)
            files = sum(os.path.getsize(os.path.join(st.directory, f)) for f in os.listdir(st.directory)
                        if f.endswith(".npy"))
            spills.append({"dtype": st.dtype, "payload_bytes": st.nbytes(), "file_bytes": files})
            return st

        labels = Dataset(yd)
        sd = StreamDataset(batched(x, 512), n=S9_N, device=dev)
        kw = dict(block_size=S9_BLOCK, num_iter=S9_EPOCHS, lam=S9_LAM)
        unweighted_f32 = finish_block_model(*base, store.d, S9_BLOCK, True)
        FeatureBlockStore.from_batches = spy
        try:
            weighted_f32 = BlockWeightedLeastSquaresEstimator(mixture_weight=S9_MIX, **kw).fit_stream_dataset(
                sd, labels, spill_dir=str(tmp / "spill"))
            pairs = {"BlockLeastSquaresEstimator": (BlockLeastSquaresEstimator(spill_dtype="bfloat16", **kw),
                                                    unweighted_f32),
                     "BlockWeightedLeastSquaresEstimator": (BlockWeightedLeastSquaresEstimator(
                         mixture_weight=S9_MIX, spill_dtype="bfloat16", **kw), weighted_f32)}
            dist = {}
            for name, (est, f32) in pairs.items():
                bf = est.fit_stream_dataset(sd, labels, spill_dir=str(tmp / "spill"))
                dist[name] = {"weights": max_err(bf.flat_weights, f32.flat_weights),
                              "intercept": max_err(bf.intercept, f32.intercept)}
        finally:
            FeatureBlockStore.from_batches = raw
        f32_spill, bf16_spills = spills[0], spills[1:]
        print(f"  spills {spills}; bf16 against f32, largest |difference|: "
              f"{ {k: _rounded(v, 6) for k, v in dist.items()} } (at most "
              f"{TOL_BF16_SPILL}) ({card})", flush=True)
        check(f32_spill["dtype"] == "float32" and f32_spill["payload_bytes"] == store.nbytes(), f"f32 spill {spills}")
        for sp in bf16_spills:
            check(sp["dtype"] == "bfloat16" and 2 * sp["payload_bytes"] == f32_spill["payload_bytes"],
                  f"bf16 spill {sp} is not half of the f32 spill's bytes")
        for name, d in dist.items():
            check(max(d.values()) <= TOL_BF16_SPILL, f"{name}: the bf16 spill's model {d} from the f32 fit's")
        out.update({"spills": spills, "bf16_vs_f32": dist, "tolerance_bf16": TOL_BF16_SPILL})
        shutil.rmtree(store.directory, ignore_errors=True)
    return out


def a18_oc_krr(dev, card, gk, fk, data, rows_dir, default_alpha):
    """(c): the out-of-core KRR on phase 14's store at prefetch=3 and
    KEYSTONE_OC_PREFETCH=4, against phase 14's fit at the default depth."""
    from keystone_tpu_torch.models import kernel_ridge as KR
    from keystone_tpu_torch.workflow.blockstore import RowBlockStore
    from keystone_tpu_torch.workflow.dataset import Dataset

    out = {}
    with phase("A18 (c): the out-of-core KRR at prefetch=3 and KEYSTONE_OC_PREFETCH=4"):
        store, labels = RowBlockStore(str(rows_dir)), Dataset(data[1])
        est = KR.KernelRidgeRegressionEstimator(KR.GaussianKernelGenerator(KRR_GAMMA), lam=KRR_LAM,
                                                block_size=KRR_BLOCK, num_epochs=KRR_EPOCHS)
        runs = {}
        for label, env, kw in (("prefetch=3", None, {"prefetch": 3}), ("KEYSTONE_OC_PREFETCH=4", "4", {})):
            with env_var("KEYSTONE_OC_PREFETCH", env):
                torch.cuda.synchronize()
                reset_all(gk, fk)
                t0 = time.perf_counter()
                alpha = est.fit_store(store, labels, **kw).alpha
                torch.cuda.synchronize()
                runs[label] = (alpha, gk.LAUNCHES["gram_block"], time.perf_counter() - t0)
        l0 = KRR_EPOCHS * store.num_blocks ** 2  # phase 14's count at the default depth, as checked there
        for label, (a, n_launch, _) in runs.items():
            check(torch.equal(a, default_alpha), f"out-of-core KRR α at {label} differs from phase 14's fit")
            check(n_launch == l0, f"B3 launches at {label}: {n_launch}, the default's {l0}")
        seconds = {k: v[2] for k, v in runs.items()}
        print(f"  α bit for bit phase 14's fit at the default depth, {l0} B3 launches each; sweep seconds "
              f"{_rounded(seconds, 4)} ({card})", flush=True)
        out.update({"launches_each": l0, "launches": sum(v[1] for v in runs.values()), "sweep_seconds": seconds})
    return out


def a18_apply_chunk(dev, card, fk, forward, float_batches):
    """(d): KEYSTONE_APPLY_CHUNK over the bench forward's featurization."""
    from keystone_tpu_torch.workflow import transformer as WT
    from keystone_tpu_torch.workflow.dataset import Dataset
    from keystone_tpu_torch.workflow.optimizer import FusedTransformer

    out = {"seconds": {}, "b2_launches": {}, "max_abs_err": {}}
    with phase(f"A18 (d): KEYSTONE_APPLY_CHUNK over the bench forward's featurization of {A18_APPLY_N} images"):
        feat = FusedTransformer(list(forward.stages)[:6])  # GrayScaler ... NormalizeRows
        x = torch.cat(float_batches)[:A18_APPLY_N]  # in [0, 1], as bench.py feeds the forward
        check(tuple(x.shape) == (A18_APPLY_N, IMAGE_HW, IMAGE_HW, 3), f"A18 images {tuple(x.shape)}")
        with env_var("KEYSTONE_APPLY_CHUNK", None):
            feat.apply_dataset(Dataset(x))  # warm-up
            ref = feat.apply_dataset(Dataset(x)).array
        for setting in A18_CHUNKS:
            with env_var("KEYSTONE_APPLY_CHUNK", setting):
                chunk = WT._apply_chunk_rows()
                torch.cuda.synchronize()
                reset_all(fk)
                t0 = time.perf_counter()
                got = feat.apply_dataset(Dataset(x)).array
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            label = "unset" if setting is None else setting
            launches = fk.LAUNCHES["fisher_encode"]
            want = -(-A18_APPLY_N // chunk) if chunk else 1
            check(launches == want, f"KEYSTONE_APPLY_CHUNK={label}: {launches} B2 launches, expected {want}")
            out["max_abs_err"][label] = compare(f"featurization at KEYSTONE_APPLY_CHUNK={label} (chunk {chunk}) "
                                                f"against the default", got, ref, TOL_FV)
            out["seconds"][label], out["b2_launches"][label] = dt, launches
        out["launches"] = sum(out["b2_launches"].values())
        print(f"  B2 launches {out['b2_launches']}; seconds {_rounded(out['seconds'], 4)} ({card})", flush=True)
    return out


def knobs_path(dev, card, gk, fk, data, tmp, oc_alpha, seed, forward, float_batches):
    """A18: the knobs on the card (phase 14b); ``tmp`` holds phase 14's
    row store under ``rows``, and ``oc_alpha`` is its default fit's α."""
    t0 = time.perf_counter()
    out = {"tar": a18_tar(dev), "oc_bcd": a18_oc_bcd(dev, card, tmp, seed),
           "oc_krr": a18_oc_krr(dev, card, gk, fk, data, tmp / "rows", oc_alpha),
           "apply_chunk": a18_apply_chunk(dev, card, fk, forward, float_batches)}
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card
    print(f"  A18 took {out['seconds']:.1f} s ({card})", flush=True)
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
        "A18 out-of-core KRR at prefetch=3 and KEYSTONE_OC_PREFETCH=4": results["knobs"]["oc_krr"]["launches"],
    })
    poly_launches["disk tier polynomial"] = disk["polynomial"]["launches"]
    # S9: the KRR fits across ranks (one NCCL rank, two Gloo ranks: every
    # rank's counts)
    s9 = results["parallel"]["a8b"]
    gram_launches["S9 in-core KRR fit and predict (every rank)"] = s9["launches"]["gram_block"]
    poly_launches["S9 cached degree-2 KRR fit (every rank)"] = s9["launches"]["poly_block"]
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
    by_rank = {k: v["gram"] for k, v in s9["by_rank"].items()}
    gram = {
        "name": "gram_block", "route": "cuda", "source": "keystone_tpu_torch/csrc/gram.cu",
        "replaces": "keystone_tpu/ops/gram_pallas.py:89",
        "launches": sum(gram_launches.values()), "launches_by_path": gram_launches,
        "launches_s9_by_rank": {k: {f: c["gram_block"] for f, c in v.items() if c.get("gram_block")}
                                for k, v in by_rank.items()},
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
        "launches_s9_by_rank": {k: {f: c["poly_block"] for f, c in v.items() if c.get("poly_block")}
                                for k, v in by_rank.items()},
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


def write_mnist_csv(path, images, labels) -> None:
    """The bytes of ``loaders/mnist.py::write_csv`` (``np.savetxt``, fmt
    "%d"), made by numpy at once: savetxt formats row by row, 14 s for
    MNIST's 70 000 rows on an H100's host.  Values 0..999, as MNIST's."""
    rows = np.concatenate([np.asarray(labels, np.int32)[:, None], np.rint(images).astype(np.int32)], axis=1)
    check(rows.size == 0 or (rows.min() >= 0 and rows.max() <= 999), "MNIST CSV values outside 0..999")
    chars = np.empty(rows.shape + (4,), np.uint8)
    for i, place in enumerate((100, 10, 1)):
        chars[..., i] = rows // place % 10 + ord("0")
    chars[..., 3] = ord(",")
    chars[:, -1, 3] = ord("\n")
    keep = np.ones(chars.shape, bool)
    keep[..., 0], keep[..., 1] = rows >= 100, rows >= 10
    Path(path).write_bytes(chars[keep].tobytes())


def mnist_path(dev, card, gk, fk, tmp):
    """MnistRandomFFT.run at its Config (4 FFT branches, λ 1e-2) on MNIST's
    split sizes, synthetic rows written as the MNIST CSV: in memory
    (``load``) and streamed from the CSV in batches of 4096."""
    from keystone_tpu_torch.loaders.mnist import MnistLoader
    from keystone_tpu_torch.pipelines import mnist_random_fft as M

    with phase("MnistRandomFFT: the CSV files"):
        M.MnistRandomFFT.run(M.Config(synthetic_n=1024), dev)  # warm-up, not counted
        t0 = time.perf_counter()
        paths = {}
        for key, n, seed in (("train_path", MNIST_N, 1), ("test_path", MNIST_TEST_N, 2)):
            paths[key] = str(tmp / f"{key}.csv")
            write_mnist_csv(paths[key], *MnistLoader.synthetic_arrays(n, seed))
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
    """TimitPipeline.run at its Config on the first TIMIT_PIPE_N +
    TIMIT_PIPE_TEST_N of the kernel TIMIT phase's .npy frames: in memory,
    then streamed in batches of 8192; the cosine features' phase against
    float64."""
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures, StandardScalerModel
    from keystone_tpu_torch.ops.util import MaxClassifier
    from keystone_tpu_torch.pipelines import timit as T

    paths = {}
    for key, src, n in (("features_path", "features", TIMIT_PIPE_N), ("labels_path", "features_labels", TIMIT_PIPE_N),
                        ("test_features_path", "test_features", TIMIT_PIPE_TEST_N),
                        ("test_labels_path", "test_features_labels", TIMIT_PIPE_TEST_N)):
        paths[key] = str(timit_dir / f"pipe_{src}.npy")
        np.save(paths[key], np.load(timit_dir / f"{src}.npy", mmap_mode="r")[:n])
    T.TimitPipeline.run(T.Config(synthetic_n=4096), dev)  # warm-up, not counted
    cfg = T.Config(**paths)
    out, fitted = {}, {}
    for mode, c in (("in memory", cfg), ("stream", dataclasses.replace(cfg, stream=True))):
        with phase(f"main path: TimitPipeline.run, {mode}"):
            res, detail, rec, launches = app_run(f"TimitPipeline {mode}", card, gk, fk,
                                                 lambda c, out: T.TimitPipeline.run(c, dev, out=out), c, TIMIT_PIPE_N)
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

    def timed_prefetched(source, transform=None, prefetch=2):
        inner = prefetched(source, transform=transform, prefetch=prefetch)
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
    with phase("text: the Newsgroups trees (a quarter of 20 Newsgroups' bydate split sizes)"):
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
    with phase(f"Newsgroups: the ls fit on the card against the same fit on the CPU (the first {NEWS_CPU_N} "
               "documents); streamed against in memory"):
        y = np.where(np.eye(NEWS_CLASSES)[labels] > 0, 1.0, -1.0).astype(np.float32)
        out["ls_problem"] = (rows, y, base.ls_lam)  # the checkpointed L-BFGS phase's, popped by main
        objective = ls_objective(x, y.astype(np.float64), base.ls_lam)
        # the card-vs-CPU pair on a part of the documents (the whole set's
        # CPU fit took 28-37 s of the script), each fit alike
        part_objective = ls_objective(x[:NEWS_CPU_N], y[:NEWS_CPU_N].astype(np.float64), base.ls_lam)
        pair = {}
        for where in (dev, torch.device("cpu")):
            lbfgs.reset_stats()
            t0 = time.perf_counter()
            m = SparseLBFGSwithL2(lam=base.ls_lam, num_iterations=100, fit_intercept=False).fit_dataset(
                Dataset(rows[:NEWS_CPU_N], device=where), Dataset(torch.from_numpy(y[:NEWS_CPU_N]).to(where)))
            pair[where.type] = (m, time.perf_counter() - t0, dict(lbfgs.STATS))
        (card_m, card_s, card_stats), (cpu, cpu_s, cpu_stats) = pair[dev.type], pair["cpu"]
        print(f"  the card's fit: {card_s:.3f} s, {card_stats}; the CPU fit: {cpu_s:.3f} s, {cpu_stats}", flush=True)
        out["ls_card_vs_cpu"] = {**lbfgs_pair("ls weights, card vs CPU", card_m.weights, card_stats["trials"],
                                              cpu.weights, cpu_stats["trials"], part_objective, base.ls_lam, xt),
                                 "cpu_fit_seconds": cpu_s, "card_fit_seconds": card_s, "documents": NEWS_CPU_N}
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
# the operations layer's streamed fits (hooks at rest, the recovered fit)
# on a quarter of the fit leg's images: the phases took 231.7 s of the
# script's 1200 s on an H100 on all of them, 131.6 s on half (the
# recovered fit's two children 63.3 s of it), before the planner's phase
# S8 needed the room; the deadline phase keeps the fit leg's streamed fit
OPS_N = FIT_N // 4
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
# the sparse one on Newsgroups' ls rows: its Config's λ, a checkpoint
# every 10 iterations.  Its scatter-adds run in a fixed
# order there (ops/sparse.py: scatter_plan, segment sums), so a
# resumed fit is held to the uninterrupted one bit for bit; the two-run
# spread of the plain (atomic) fit is measured and printed beside it
SPARSE_EVERY = 10
# its iterations (100 took 44.1 s over its five fits on an H100;
# the cut keeps every fit), and the save it is interrupted at: the third,
# so it resumes from the second
SPARSE_ITERS, SPARSE_STOP_SAVE = 40, 3


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
    """Attempt 1 of the recovered fit, in a process of its own: builds the
    kernels (the parent's build, cached) and runs ``recovery_attempt``,
    printing its records as RESUME, STATS and DONE lines."""
    from keystone_tpu_torch.kernels import build
    from keystone_tpu_torch.utils import precision

    precision.disable_tf32()
    build.build(["fisher"])
    materialize = watch_materialize()

    def emit(key, rec):
        print(f"{key} " + json.dumps(rec), flush=True)

    recovery_attempt(work, materialize, emit)
    return 0


def recovery_attempt(work: str, materialize: dict, emit) -> None:
    """One attempt of the recovered fit: fit_with_recovery on the streamed
    fit and the held-out scores.  ``emit(key, record)`` gets a RESUME
    record, a STATS record at every checkpoint save (the last one before
    an ``exit`` fault is the attempt's record) and, when the fit
    completes, a DONE record; the arrays go to ``work/fitted.npz``.
    ``materialize``: the counts of ``watch_materialize`` this attempt
    reads (their change over the attempt is its own).  The patches it
    makes are undone before it returns, so that it can run in this
    script's own process as well as in a child."""
    from keystone_tpu_torch import faults
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.ops import fisher_kernels as fk
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P
    from keystone_tpu_torch.utils import durable
    from keystone_tpu_torch.workflow import state as WS
    from keystone_tpu_torch.workflow.pipeline import PipelineEnv
    from keystone_tpu_torch.workflow.recovery import fit_with_recovery

    dev = torch.device(DEVICE)
    base = dict(materialize)
    faults_before = faults.stats()

    def own(stats):
        return {k: stats[k] - base[k] for k in base}

    def faults_since():
        return {site: {k: v - faults_before.get(site, {}).get(k, 0) for k, v in rec.items()}
                for site, rec in faults.stats().items()}

    cfg = dataclasses.replace(fit_setup_config(P), synthetic_n=OPS_N, stream=True, stream_batch_size=STREAM_BATCH,
                              checkpoint_dir=os.path.join(work, "ckpt"), stream_retries=2)
    ckpt = os.path.join(cfg.checkpoint_dir, "oc_bcd_epoch.npz")
    loaded = durable.load_npz(ckpt)
    emit("RESUME", {"from_epoch": None if loaded is None else int(loaded[0]["epoch"]) + 1})
    save = durable.save_npz

    def recorded_save(path, arrays, **kw):
        rec = {"epoch": int(arrays["epoch"]) if "epoch" in arrays else None, "launches": dict(fk.LAUNCHES),
               "faults": faults_since(),
               "survived": {s: metrics.REGISTRY.counter_value(c) for s, c in SURVIVED_BY.items()},
               "materialize_fallbacks": own(materialize)["fallbacks"]}
        emit("STATS", rec)
        return save(path, arrays, **kw)

    reloaded = []
    load_rule = WS.SavedStateLoadRule.apply

    def recorded_apply(self, graph, device=None):
        seen = len(self.reloaded)
        graph = load_rule(self, graph, device=device)
        reloaded.extend(self.reloaded[seen:])
        return graph

    retries = PipelineEnv.node_retries
    durable.save_npz, WS.SavedStateLoadRule.apply, PipelineEnv.node_retries = recorded_save, recorded_apply, 1
    try:
        fk.reset_launches()
        t0 = time.perf_counter()
        fitted, attempts = fit_with_recovery(lambda: streamed_build(P, dev, cfg),
                                             state_dir=os.path.join(work, "state"))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        durable.save_npz, WS.SavedStateLoadRule.apply, PipelineEnv.node_retries = save, load_rule, retries
    fit_launches = dict(fk.LAUNCHES)
    arrays = fitted_arrays(fitted, held_out_images(dev))
    np.savez(os.path.join(work, "fitted.npz"), **arrays)
    emit("DONE", {"attempts": attempts, "fit_seconds": fit_s, "launches_fit": fit_launches,
                  "launches": dict(fk.LAUNCHES), "reloaded_prefixes": reloaded, "faults": faults_since(),
                  "materialize": own(materialize)})


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

    cfg = dataclasses.replace(fit_setup_config(P), synthetic_n=OPS_N, stream=True, stream_batch_size=STREAM_BATCH)
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
            print(f"  Pipeline.fit {secs:.4f} s on {OPS_N} images with {mode} (phase 10: "
                  f"{stream_out['fit_seconds']:.4f} s on {FIT_N}); launches fit {fit_l}, with scoring {launches} "
                  f"({card})", flush=True)
            check(fit_l == fv_launches(encode=2 * -(-OPS_N // STREAM_BATCH)), f"fit launches {fit_l}")
            out[mode] = {"fit_seconds": secs, "launches_fit": fit_l, "launches": launches}
            del fitted
    # seconds an image: the streamed fit's stages all scale with its images
    ratio = (out["nothing attached"]["fit_seconds"] / OPS_N) / (stream_out["fit_seconds"] / FIT_N)
    print(f"  nothing attached / phase 10, an image: {ratio:.4f} (within 1/{HOOK_RATIO} .. {HOOK_RATIO}); ledger "
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


def recovery_path(card, tmp, reference, materialize):
    """The recovered fit: attempt 1 under the plan, in a child process,
    killed at its second epoch checkpoint; attempt 2 relaunched with the
    same directories, in this script's own process (which holds nothing
    of attempt 1 but what it left on disk: one child's start-up, about 20
    s, cut for the parallel phase S9's room)."""
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
        from keystone_tpu_torch.obs import ledger

        l2 = {}
        t0 = time.perf_counter()
        ledger.start_run(str(obs))
        try:
            recovery_attempt(str(work), materialize, lambda key, rec: l2.setdefault(key, []).append(rec))
        finally:
            ledger.stop_run()
        s2 = time.perf_counter() - t0
        done, resume = l2["DONE"][0], l2["RESUME"][0]
        print(f"  {s2:.2f} s; resumed from epoch {resume['from_epoch']}; saves {len(l2.get('STATS', []))}; "
              f"launches in the fit {done['launches_fit']}, with scoring {done['launches']}; prefixes "
              f"reloaded {done['reloaded_prefixes']}; faults {done['faults']} ({card})", flush=True)
        check(resume["from_epoch"] == 1 and len(l2.get("STATS", [])) == 1, f"attempt 2 {resume} {l2.get('STATS')}")
        check(done["materialize"]["passes"] > 0 and done["materialize"]["fallbacks"] == 0,
              f"attempt 2's profiled materialization {done['materialize']}")
        check(done["launches_fit"] == fv_launches(encode=2 * -(-OPS_N // STREAM_BATCH)),
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
    with phase("obs_report: the recovered fit's ledger, both attempts"):
        out["obs_report"] = obs_report_checks(obs, led)
    return out


def obs_report_checks(obs, led) -> dict:
    """``tools/obs_report.py`` as a child over each run of ``obs`` (and the
    directory, which names the newest): exit 0, the sections the fit
    writes, and its counts those read off the same files here (the
    killed attempt's open stage has a start and no end: stages count by
    their ends)."""
    runs = sorted(Path(obs).glob("run_*.jsonl"))
    totals = {"stage_runs": 0, "retry_events": 0, "epochs": 0, "fault_restarts": 0, "events": 0}
    stage_ends = 0
    for path in runs:
        s, text = report_child("obs_report", path, "--top", 1000)
        lines = [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]
        stage_ends += sum(1 for e in lines if e["kind"] == "span_end" and e["name"] == "executor.stage")
        check(s["events"] == len(lines), f"obs_report read {s['events']} events of {len(lines)} in {path.name}")
        check(bool(s["stage_top"]) and "== top stages by time ==" in text, f"{path.name}: no stages section")
        totals["stage_runs"] += sum(st["count"] for st in s["stage_top"])
        totals["retry_events"] += s["retries"]["executor_retry_events"]
        totals["epochs"] += sum(len(v) for v in s["convergence"].values())
        totals["fault_restarts"] += len(s["fault_restarts"])
        totals["events"] += s["events"]
    newest, _ = report_child("obs_report", obs)
    check(newest["path"] == str(max(runs, key=os.path.getmtime)), f"obs_report picked {newest['path']}")
    want = {"stage_runs": stage_ends, "retry_events": led["events"].get("executor.retry", 0),
            "epochs": led["events"].get("solver.epoch", 0), "fault_restarts": led["events"].get("faults.stats", 0)}
    print(f"  {len(runs)} runs: {totals}; the ledger's own counts {want}", flush=True)
    check(all(totals[k] == v for k, v in want.items()) and totals["epochs"] > 0,
          f"obs_report {totals} against the ledger's {want}")
    return totals


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
            est = SparseLBFGSwithL2(lam=lam, num_iterations=SPARSE_ITERS, fit_intercept=False)
            plain = [timed(lambda: est.fit_sparse(sp, y)) for _ in range(2)]
            spread = float((plain[0][0].weights - plain[1][0].weights).abs().max())
            scale = float(plain[0][0].weights.abs().max())
            ref, ref_s, ref_stats = timed(lambda: est.fit_sparse(sp, y, checkpoint_dir=str(tmp / "s0"),
                                                                  checkpoint_every=SPARSE_EVERY))
            twice, _, _ = timed(lambda: est.fit_sparse(sp, y, checkpoint_dir=str(tmp / "s1"),
                                                       checkpoint_every=SPARSE_EVERY))
            with faults.inject(f"ckpt.save:after={SPARSE_STOP_SAVE - 1}:times=3:raise"):
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
                  f"{float((twice.weights - ref.weights).abs().max()):.3e}; interrupted at the iteration-"
                  f"{SPARSE_STOP_SAVE * SPARSE_EVERY} save and resumed from iteration "
                  f"{(SPARSE_STOP_SAVE - 1) * SPARSE_EVERY} in {res_s:.3f} s ({res_stats['iterations']} iterations "
                  f"run), apart by {e:.3e} ({card})", flush=True)
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


def operations_path(dev, card, P, fk, gk, stream_out, krr, ls_problem, materialize):
    """The operations layer's phases, in order: hooks at rest, the recovered
    streamed fit, the in-core checkpointed BCD, the checkpointed L-BFGS,
    the out-of-core KRR under kernel.sweep, deadlines and breakers."""
    tmp = Path(tempfile.mkdtemp(prefix="operations_", dir=REPO))
    try:
        out, reference = hooks_at_rest(dev, card, P, fk, stream_out, tmp)
        out["recovery"] = recovery_path(card, tmp, reference, materialize)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["fv_launches"] = {k: sum(out[m]["launches"].get(k, 0) for m in
                                 ("nothing attached", "a run ledger", "an empty fault plan"))
                          + out["recovery"]["launches"].get(k, 0) for k in ("fisher_encode", "fused_forward")}
    out["checkpointed_bcd"] = checkpointed_bcd_path(dev, card)
    out["lbfgs_checkpoint"] = lbfgs_checkpoint_path(dev, card, ls_problem)
    out["oc_krr_sweep_fault"] = oc_krr_sweep_fault_path(dev, card, gk, krr)
    out["deadlines_breakers"] = deadline_breaker_path(dev, card, P, stream_out["fit_seconds"])
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
SERVE_S4_SECONDS = 1.5  # 3.0 until S10 (serve_bench's modes) needed the room
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
    from keystone_tpu_torch.serve import serve, wire
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    out = {}
    imgs = images.cpu().numpy()
    pool = wire.SlabPool(prefix="s1")

    def admit_block(svc, rows):
        """``rows`` admitted as one shared-memory admission block
        (``submit_batch``); the block returns to the pool with its answers."""
        blk = wire.alloc_block(pool, len(rows), rows.shape[1:], rows.dtype)
        blk.array[:] = rows
        try:
            return [f.result(timeout=SERVE_RESULT_S) for f in svc.submit_batch(blk)]
        finally:
            blk.close()

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
                block_outs += admit_block(svc, rows)
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
                got += admit_block(svc, rows)
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
    pool.close()
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


# ---- C10: B1 launched from two threads at once, at SIFT's and LCS's
# scorer shapes (d_in 128 and 96: two dynamic shared-memory sizes of one
# kernel instantiation), each thread on its own stream; every output bit
# for bit the same launch made serially.  Before the repair each launch
# set the kernel's process-wide shared-memory attribute to its own size,
# and a thread could launch under the other's smaller limit
# (cudaErrorInvalidValue: S3's hot swap lost 128 requests once so)
C10_ROWS, C10_REPS = 8, 400


def concurrent_b1_path(dev, card, fk):
    import threading

    with phase(f"C10: B1 from two threads at once, SIFT (d_in 128) and LCS (d_in 96), {C10_REPS} launches each, "
               "against the same launches made serially"):
        g = torch.Generator(device=dev).manual_seed(10)

        def args(t, d_in):
            raw = torch.rand((C10_ROWS, t, d_in), generator=g, device=dev)
            mask = (torch.rand((C10_ROWS, t), generator=g, device=dev) > 0.1).float()
            comp = torch.linalg.qr(torch.randn((d_in, PCA_DIMS), generator=g, device=dev))[0].contiguous()
            mean = 0.05 * torch.rand((d_in,), generator=g, device=dev)
            w = torch.rand((GMM_K,), generator=g, device=dev) + 0.1
            mu = 0.3 * torch.randn((GMM_K, PCA_DIMS), generator=g, device=dev)
            var = 0.5 + torch.rand((GMM_K, PCA_DIMS), generator=g, device=dev)
            return raw, mask, comp, mean, w / w.sum(), mu, var, True

        shapes = {"sift": args(784, 128), "lcs": args(324, 96)}
        serial = {k: fk.fused_forward(*a) for k, a in shapes.items()}
        torch.cuda.synchronize()
        outs, errors = {k: [] for k in shapes}, []
        start = threading.Barrier(len(shapes))

        def worker(key):
            try:
                stream = torch.cuda.Stream(device=dev)
                with torch.cuda.stream(stream):
                    start.wait()
                    for _ in range(C10_REPS):
                        outs[key].append(fk.fused_forward(*shapes[key]))
                stream.synchronize()
            except BaseException as e:  # reported below, not swallowed
                errors.append(f"{key}: {type(e).__name__}: {e}")

        fk.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(k,)) for k in shapes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        secs = time.perf_counter() - t0
        launches = dict(fk.LAUNCHES)
        same = {k: sum(bool(torch.equal(o, serial[k])) for o in outs[k]) for k in shapes}
        print(f"  {secs:.3f} s; errors {errors[:3]}; outputs bit for bit the serial launch's: {same} of {C10_REPS} "
              f"each; launches {launches} ({card})", flush=True)
        check(not errors and not any(t.is_alive() for t in threads), f"concurrent B1 launches failed: {errors[:3]}")
        check(all(v == C10_REPS for v in same.values()), f"concurrent B1 outputs differ from serial: {same}")
        check(launches["fused_forward"] == len(shapes) * C10_REPS, f"launches {launches}")
        return {"seconds": secs, "errors": errors, "bitwise": same, "launches": launches}


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
            dump_dir = Path(tempfile.mkdtemp(prefix="s4_trace_", dir=REPO))
            dump = svc.dump_trace(str(dump_dir))
            finished = svc.recorder.stats()["finished"]
        finally:
            svc.close(timeout=SERVE_RESULT_S)
        out["launches"] = dict(fk.LAUNCHES)
        check(out["launches"]["fisher_encode"] == 0, f"open-loop launches {out['launches']}")
    with phase("trace_report: S4's flight-recorder dump"):
        try:
            out["trace_report"] = trace_report_checks(dump, finished, [v for k, v in out.items() if k[0].isdigit()])
        finally:
            shutil.rmtree(dump_dir, ignore_errors=True)
    return out


def trace_report_checks(dump, finished, reps) -> dict:
    """``tools/trace_report.py`` as a child over a recorder dump: exit 0,
    its sections, its requests and outcomes those of the dump's traces,
    each outcome at most what the open loop counted, every flush of the
    dump on a replica timeline."""
    from collections import Counter

    r, text = report_child("trace_report", dump, "--top", 5, "--timeline", 10 ** 6)
    d = json.loads(Path(dump).read_text())
    outcomes = Counter(t.get("outcome") or "open" for t in d["traces"])
    riders = sum(b["riders"] for tl in r["replica_timelines"].values() for b in tl)
    counted = {k: sum(rep[k] for rep in reps) for k in ("completed", "shed", "rejected")}
    print(f"  {r['requests']} traces of {finished} finished; outcomes {dict(r['outcomes'])}; the open loop's "
          f"{counted}; {sum(len(tl) for tl in r['replica_timelines'].values())} flushes, {riders} riders; "
          f"critical path (mean) {r['critical_path_mean']}", flush=True)
    check("top 5 slow requests:" in text and "timeline" in text, "trace_report: a section is missing")
    check(r["requests"] == len(d["traces"]) and r["outcomes"] == dict(outcomes),
          f"trace_report {r['requests']} {r['outcomes']} against the dump's {len(d['traces'])} {dict(outcomes)}")
    check(r["requests"] <= finished and all(r["outcomes"].get(k, 0) <= v for k, v in counted.items()),
          f"trace_report {r['outcomes']} over the open loop's {counted}")
    check(sum(len(tl) for tl in r["replica_timelines"].values()) == len(d["batches"]) and riders > 0,
          f"timelines against the dump's {len(d['batches'])} flushes")
    return {"requests": r["requests"], "outcomes": r["outcomes"], "finished": finished, "flushes": len(d["batches"]),
            "riders": riders, "critical_path_mean": r["critical_path_mean"]}


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
# the burst's offered load: a multiple of the larger of S1's saturation
# rate and the graphs-on closed loop's best (the autoscaled service
# replays graphs; at S1's rate alone it may not be overloaded at all)
S5_OVERLOAD = 1.5
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

        with phase("serve S5: serve_bench's cold-start A/B against this registry (v0001, fresh processes)"):
            ab = serve_bench.run_cold_start_ab(max_batch=SERVE_BUCKETS[-1], rounds=1, registry_root=str(tmp / "registry"),
                                               device=dev, publish=False, item_shape=imgs.shape[1:], dtype=imgs.dtype)
            arms = ab["samples"]
            check(ab["predictions_match"] and ab["artifact_fallbacks"] == 0,
                  f"the cold-start arms: digests {[s['prediction_sha'] for a in arms.values() for s in a]}, "
                  f"fallbacks {ab['artifact_fallbacks']}")
            check(all(s["version"] == v1 for a in arms.values() for s in a), "the arms served another version")
            check(ab["prime_sources"]["artifact"]["artifact"] == len(SERVE_BUCKETS)
                  and ab["prime_sources"]["compile"]["artifact"] == 0, f"prime sources {ab['prime_sources']}")
            print(f"  first prediction: bucket graphs {ab['first_prediction_s']['artifact']:.3f} s, none "
                  f"{ab['first_prediction_s']['compile']:.3f} s; ready {ab['ready_s']}; one digest, no fallback "
                  f"({card})", flush=True)
            out["cold_start_ab"] = ab

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
                    capacity = max([saturation_ips] + [r["images_per_s"] for r in out["closed_loop"]["on"]])
                    rep = serve_bench.run_bench(svc, imgs.shape[1:], qps=S5_OVERLOAD * capacity,
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
                print(f"  offered {rep['offered_qps']:.1f}/s ({S5_OVERLOAD:g}x the graphs-on or S1 saturation, the "
                      f"larger) for {S5_BURST_S} s: "
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


# ---- S6, the process and network fleets: S1's full-width raw scorer
# (scores_of) with its artifact bundle at S1's buckets, served by worker
# processes that each load it onto cuda:0, capture their own bucket graphs
# (B1 twice in each) and report their kernels back; the router (this
# process) holds no weights for them and launches nothing while they serve.
# Several processes on one card take turns on it (no MPS daemon): the
# gain is on the host.  Each saturation loop runs S6_SAT_REPS times.  What
# keeps a slot busy is read from host-clock spans over a loop's wall time:
# each worker's `worker.apply` spans (the router's merge of its telemetry,
# the device's wait inside) and the router's flush spans (their sum over
# the wall: the flushes in flight).  No device trace
# reaches into the workers: nvidia-smi's utilization.gpu, sampled every
# S6_SMI_MS, stands beside them as a coarse counter (the share of sample
# periods in which a kernel of any process ran), not a trace.
# S1's saturation loop on each process fleet: the fleets of 1 and 4
# workers (spawned for this loop alone, ~30 s) went for the parallel
# phase S9's room; no ranking of threads against 1, 2 or 4 workers held
# across calls while they ran (PERF.md)
S6_WORKERS = (2,)
# runs of each configuration's saturation loop (3 until the parallel
# phase S9 needed the room: no ranking held across the three, PERF.md)
S6_SAT_REPS = 1
# the ingress A/B: seconds a leg, measured rounds of both legs (1.5 s and
# 3 rounds before they were cut for the script's time)
S6_AB_S, S6_AB_ROUNDS = 1.0, 1  # 2 rounds until S9 needed the room
S6_B1_BUCKETS = (8, 16, 32, 64)  # B1 timed at the serving buckets below S1's batch
S6_SCORED_N = 1024  # served through the two-worker fleet against the offline scores
S6_KILL_N = 2048  # the closed loop one worker is SIGKILLed under
S6_KILL_AFTER_S = 0.2
S6_NET_N = 1024  # the closed loop the network fleet's partition lands in
S6_LEASE_S = 1.0
S6_PARTITION_S = 2.5  # past the lease: the victim's flush forfeits, it fences
S6_HEAL_S = 120.0  # the bound of every wait for a heal
S6_SMI_MS = 100


class _SmiSampler:
    """nvidia-smi's utilization.gpu every S6_SMI_MS while the block runs
    (the mean of its samples is the card's busy share over the block)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits", f"--loop-ms={S6_SMI_MS}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate(timeout=10)
        self.samples = [float(v) for v in out.split() if v.strip().replace(".", "", 1).isdigit()]

    @property
    def busy_share(self):
        return None if not self.samples else sum(self.samples) / (100.0 * len(self.samples))


def _rounded(d, places=3):
    """A dict's or a list's numbers rounded, for a printed line."""
    if isinstance(d, dict):
        return {k: round(v, places) for k, v in d.items()}
    return [round(v, places) for v in d]


def _kernel_delta(before: dict, after: dict) -> dict:
    out = {}
    for part in ("launches", "replayed"):
        out[part] = {k: after[part].get(k, 0) - before.get(part, {}).get(k, 0) for k in after[part]}
    return out


def _worker_peaks(svc) -> dict:
    """Each worker process's peak reserved device memory (MiB) from its
    last kernel report, by worker name and pid."""
    return {f"{w}/{pid}": rep["peak_reserved_bytes"] / 2 ** 20
            for (w, pid), rep in svc.telemetry.kernel_reports().items()}


def process_fleet_path(dev, card, P, fk, scorer, images, b1_args):
    """S6: B1 at the serving buckets, then the process and network fleets
    on the card (see the comment above)."""
    import signal
    import threading
    import urllib.request

    from keystone_tpu_torch import faults
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.serve import serve, wire
    from keystone_tpu_torch.serve.ingress import BinaryClient, serve_ingress
    from keystone_tpu_torch.tools import serve_bench
    from keystone_tpu_torch.utils import graphs
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    out = {}
    t_s6 = time.perf_counter()
    imgs = images.cpu().numpy()
    reg = metrics.REGISTRY
    with phase("serve S6: B1 at the serving buckets 8..64 on the served scorer's weights"):
        out["b1_buckets"] = {}
        for rows in S6_B1_BUCKETS:
            calls = b1_args(images[:rows])
            errs = [compare(f"B1 at the {rows}-row bucket, {name}", fk.fused_forward(*a), fk.fused_forward_ref(*a),
                            TOL_FUSED) for name, a in calls]
            ms = sum(cuda_ms(lambda a=a: fk.fused_forward(*a)) for _, a in calls)
            plain = sum(cuda_ms(lambda a=a: fk.fused_forward_ref(*a), reps=5) for _, a in calls)
            shapes = ((rows, 784, 128), (rows, 324, 96))
            costs = [fv_cost(n, t, PCA_DIMS, GMM_K, d_in=d_in) for n, t, d_in in shapes]
            nbytes, flops = sum(c[0] for c in costs), sum(c[1] for c in costs)
            rec = {"ms": ms, "plain_ms": plain, "bound_ms": sum(bound_ms(*c) for c in costs),
                   "bound_by": bound_by(nbytes, flops),
                   "bound_ms_tc": sum(fv_bound_ms_tc(n, t, PCA_DIMS, GMM_K, d_in=d_in) for n, t, d_in in shapes),
                   "max_abs_err": max(errs)}
            out["b1_buckets"][rows] = rec
            print(f"  B1 at {rows} rows (SIFT ({rows}, 784, 128->64) + LCS ({rows}, 324, 96->64) K=256): "
                  f"{ms:.4f} ms (plain {plain:.4f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}, on the "
                  f"tensor cores {rec['bound_ms_tc']:.4f} ms), max_abs_err {rec['max_abs_err']:.3e} ({card})",
                  flush=True)
        torch.cuda.synchronize()

    scores_pipe = Pipeline.of(P.scores_of(scorer)).fit()
    bundle = scores_pipe.freeze(device=dev).export_artifacts(example=imgs[0], buckets=SERVE_BUCKETS)
    off_scores = torch.cat([P.scores_of(scorer)(b) for b in images.split(BATCH)]).cpu().numpy()
    off_ids = torch.cat([scorer(b) for b in images.split(BATCH)]).cpu().numpy()
    torch.cuda.synchronize()
    kw = dict(max_batch=BATCH, buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS,
              queue_bound=4 * SERVE_CLIENTS * SERVE_SAT_WINDOW, example=imgs[0], artifacts=bundle)
    fb0 = reg.counter_total("serve.artifact_fallbacks")
    services, totals = [], {"launches": {}, "replayed": {}}

    def add_totals(svc, before):
        d = _kernel_delta(before, svc.telemetry.kernel_totals())
        for part in d:
            for k, v in d[part].items():
                totals[part][k] = totals[part].get(k, 0) + v

    def spawn(label, **fleet):
        t0 = time.perf_counter()
        svc = serve(scores_pipe, name=label, supervise_interval_s=0.2, restart_limit=1000, **fleet, **kw)
        services.append(svc)
        took = time.perf_counter() - t0
        workers = {}
        for r in svc._pool.replicas:
            h, kern = r.handle, r.handle.kernels or {}
            workers[h.name] = {"pid": h.pid, "ready_s": h.spawn_seconds,
                               "startup_s": h.ready_info.get("startup_seconds"),
                               "graphs": h.ready_info.get("artifact_buckets"), "device": kern.get("device"),
                               "peak_reserved_mib": (kern.get("peak_reserved_bytes") or 0) / 2 ** 20}
            check(h.ready_info.get("artifact_buckets") == len(SERVE_BUCKETS) and kern.get("device") == "cuda:0",
                  f"{label} {h.name}: ready {h.ready_info}")
            check(kern["launches"]["fused_forward"] == 2 * len(SERVE_BUCKETS),
                  f"{label} {h.name}: B1 launched {kern['launches']} at prime, not twice a bucket graph's capture")
        print(f"  {label}: {len(workers)} worker(s) spawned, primed and captured in {took:.3f} s: "
              + "; ".join(f"{n} pid {w['pid']} ready {w['ready_s']:.3f} s (startup {w['startup_s']} s), "
                          f"{w['graphs']} bucket graphs, peak reserved {w['peak_reserved_mib']:.1f} MiB"
                          for n, w in workers.items()) + f" ({card})", flush=True)
        return svc, {"build_s": took, "workers": workers}

    def hist_sums(name):
        """(count, sum) of each label set of one histogram series."""
        return {tuple(sorted(lb.items())): (h["count"], h["sum"]) for lb, h in reg.histogram_series(name)}

    def mean_ms(before, after):
        """Mean ms of the samples a histogram took between two reads, by
        label set (the worker name for the workers' apply spans)."""
        out = {}
        for key, (c, t) in after.items():
            c0, t0 = before.get(key, (0, 0.0))
            if c > c0:
                out[dict(key).get("worker", "router")] = 1e3 * (t - t0) / (c - c0)
        return out

    def span_share(before, after, wall):
        """The seconds of a histogram's samples between two reads over
        ``wall``, by label set: the share of the loop a slot spent in
        those spans."""
        out = {}
        for key, (c, t) in after.items():
            c0, t0 = before.get(key, (0, 0.0))
            if c > c0:
                out[dict(key).get("worker", "router")] = (t - t0) / wall
        return out

    def loop(label, svc, n):
        r0 = serve_counters(metrics)
        fl0, ap0 = hist_sums("serve.batch_seconds"), hist_sums("serve.fleet.apply_seconds")
        with _SmiSampler() as smi:
            outs, lat, wall = serve_closed_loop(svc, imgs, n, SERVE_SAT_WINDOW)
        flushes = serve_counters(metrics)["batches"] - r0["batches"]
        # a flush's mean ms on the router (the apply, over the wire for a
        # process fleet) and in each worker (its apply span, the device's
        # wait included); the router's flush seconds over the wall are the
        # mean number of flushes in flight, a worker's apply seconds its
        # busy share
        fl1, ap1 = hist_sums("serve.batch_seconds"), hist_sums("serve.fleet.apply_seconds")
        flush_ms = mean_ms(fl0, fl1).get("router")
        apply_ms = mean_ms(ap0, ap1)
        in_flight = span_share(fl0, fl1, wall).get("router")
        apply_share = span_share(ap0, ap1, wall)
        idx = np.arange(n) % len(imgs)
        got = np.stack(outs)
        err = compare(f"{label}: {n} served raw scores against the offline scores", torch.from_numpy(got),
                      torch.from_numpy(off_scores[idx]), TOL_SERVE_SCORES, RTOL_SERVE_SCORES)
        rec = {"requests": n, "seconds": wall, "images_per_s": n / wall, "flushes": flushes,
               "requests_per_flush": n / max(1, flushes), "p50_ms": float(np.percentile(lat, 50) * 1e3),
               "p99_ms": float(np.percentile(lat, 99) * 1e3), "smi_util": smi.busy_share,
               "smi_samples": len(smi.samples), "scores_max_abs_err": err, "flush_ms": flush_ms,
               "worker_apply_ms": apply_ms, "flushes_in_flight": in_flight, "worker_apply_share": apply_share}
        print(f"  {label}: {n} requests from {SERVE_CLIENTS} threads ({SERVE_SAT_WINDOW} outstanding each) in "
              f"{wall:.3f} s: {rec['images_per_s']:.1f} images/s, {flushes} flushes, "
              f"{rec['requests_per_flush']:.2f} requests a flush, p50 {rec['p50_ms']:.3f} ms, p99 "
              f"{rec['p99_ms']:.3f} ms; a flush {flush_ms} ms on the router ({in_flight} flushes in flight on "
              f"the mean), the workers' apply {_rounded(apply_ms)} ms (in applies {_rounded(apply_share)} of the wall); "
              f"nvidia-smi utilization.gpu {rec['smi_util']} over {len(smi.samples)} samples, a coarse "
              f"counter ({card})", flush=True)
        return rec, got

    def sat_loops(label, svc):
        """S6_SAT_REPS runs of S1's saturation loop on ``svc``, and their
        median images/s."""
        runs = [loop(f"{label}, run {i + 1} of {S6_SAT_REPS}", svc, SERVE_SAT_N)[0] for i in range(S6_SAT_REPS)]
        ips = [r["images_per_s"] for r in runs]
        print(f"  {label}: images/s over {S6_SAT_REPS} runs {[round(v, 1) for v in ips]}, median "
              f"{float(np.median(ips)):.1f} ({card})", flush=True)
        return {"runs": runs, "images_per_s": ips, "images_per_s_median": float(np.median(ips))}

    def ab(label, svc):
        """serve_bench's ingress A/B at full width in front of ``svc``:
        per-datum HTTP JSON clients against binary clients sending one
        full 128-image batch a frame."""
        rep = serve_bench.ingress_ab(svc, imgs[:BATCH], duration=S6_AB_S, rounds=S6_AB_ROUNDS)
        check(rep["predictions_identical"], f"{label}: binary != HTTP JSON on the A/B's {BATCH} images")
        check(rep["http"]["errors"] == 0 and rep["binary"]["errors"] == 0,
              f"{label}: failed requests {rep['http']['errors']} HTTP, {rep['binary']['errors']} binary")
        check(rep["bytes_copied"].get("binary", 0) == 0, f"{label}: the binary arm copied {rep['bytes_copied']}")
        print(f"  ingress A/B in front of {label} ({S6_AB_ROUNDS} rounds of {S6_AB_S} s a leg): per-datum "
              f"requests/s HTTP JSON {_rounded(rep['http']['runs_qps'], 1)} (median {rep['http']['per_datum_qps']:.1f}, "
              f"p50 {rep['http']['p50_ms']:.3f} ms, p99 {rep['http']['p99_ms']:.3f} ms) against binary "
              f"{_rounded(rep['binary']['runs_qps'], 1)} (median {rep['binary']['per_datum_qps']:.1f}, a "
              f"{BATCH}-image frame p50 {rep['binary']['frame_p50_ms']:.3f} ms, p99 "
              f"{rep['binary']['frame_p99_ms']:.3f} ms): {rep['speedup']:.2f}x; bit for bit; bytes copied at "
              f"admission {rep['bytes_copied']}; {rep['preformed_flushes']} preformed flushes ({card})", flush=True)
        return rep

    def heal(svc, n_workers, restarts0, what):
        deadline = time.monotonic() + S6_HEAL_S
        while time.monotonic() < deadline:
            alive = [r for r in svc.replica_statuses() if r.get("worker_alive")]
            if svc.supervisor.restarts_total > restarts0 and len(alive) == n_workers:
                return
            time.sleep(0.1)
        raise AssertionError(f"{what}: the fleet did not heal to {n_workers} live workers in {S6_HEAL_S} s: "
                             f"{svc.replica_statuses()}")

    def full_block(svc, pool):
        blk = wire.alloc_block(pool, BATCH, imgs.shape[1:], imgs.dtype)
        blk.array[:] = imgs[:BATCH]
        blk.retain(BATCH)
        futs = svc.submit_batch(blk)
        for f in futs:
            f.add_done_callback(blk.release_one)
        return np.stack([f.result(timeout=SERVE_RESULT_S) for f in futs])

    pool = wire.SlabPool(prefix="s6")
    torch.cuda.synchronize()
    # the workers allocate in their own processes: what this process's
    # caching allocator holds unused after the earlier phases goes back to
    # the card first
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  this process holds {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved before the workers "
          f"start ({card})", flush=True)
    fk.reset_launches()
    graphs.reset_replayed()
    try:
        with phase("serve S6: serve(workers=2) on the card, each worker with its own bucket graphs"):
            p2, out["workers_2"] = spawn("s6_p2", workers=2)
            k2 = {}  # the two-worker fleet's counts are taken once, at the end
            check(p2.device.type == "cpu", f"the process fleet's router places models on {p2.device}")
            rec, got = loop("process fleet, 2 workers, first loop", p2, S6_SCORED_N)
            top = top5_check("S6 top-5 of the served scores", np.argsort(-got, axis=1, kind="stable")[:, :5],
                             off_ids[np.arange(S6_SCORED_N) % len(imgs)], off_scores[np.arange(S6_SCORED_N) % len(imgs)])
            out["scored"] = dict(rec, top5=top)
            pre0, disp0 = reg.counter_total("serve.preformed_flushes"), reg.counter_total("dispatch.bytes_copied")
            proc_block = full_block(p2, pool)
            check(reg.counter_total("serve.preformed_flushes") == pre0 + 1
                  and reg.counter_total("dispatch.bytes_copied") == disp0,
                  "the full 128-row block was not one preformed flush shipped by reference")
        with phase("serve S6: the same full 128-row block through the threaded fleet (replicas=1), bit for bit"):
            parent0 = (dict(fk.LAUNCHES), dict(graphs.REPLAYED))
            check(parent0[0]["fused_forward"] == 0 and not parent0[1].get("fused_forward"),
                  f"the router launched B1 while the process fleet served: {parent0}")
            thr = serve(scores_pipe.freeze(device=dev), name="s6_threads", **kw)
            services.append(thr)
            thr_block = full_block(thr, pool)
            check(thr_block.tobytes() == proc_block.tobytes(),
                  f"process fleet != threaded fleet on one full bucket: max diff "
                  f"{np.abs(thr_block - proc_block).max():.3e}")
            print(f"  one full {BATCH}-row slab block: process fleet and threaded fleet bit for bit ({card})",
                  flush=True)
            out["full_block_bit_equal"] = True
        with phase("serve S6: SIGKILL one worker under the closed loop; the supervisor heals the slot"):
            restarts0 = p2.supervisor.restarts_total
            victim = p2._pool.replicas[0].handle.pid
            killed = []

            def killer():
                time.sleep(S6_KILL_AFTER_S)
                os.kill(victim, signal.SIGKILL)
                killed.append(time.monotonic())

            t = threading.Thread(target=killer)
            t.start()
            crashes0 = reg.counter_total("serve.worker_crashes")
            rec, _ = loop("process fleet, 2 workers, one SIGKILLed", p2, S6_KILL_N)
            t.join(30)
            check(bool(killed), "the killer never fired")
            t0 = time.monotonic()
            heal(p2, 2, restarts0, "after the SIGKILL")
            fresh = next(r for r in p2._pool.replicas if r.index == 0)
            check(fresh.handle.pid != victim and fresh.handle.ready_info.get("artifact_buckets") == len(SERVE_BUCKETS),
                  f"replacement {fresh.handle.pid} ready {fresh.handle.ready_info}")
            out["kill"] = dict(rec, victim_pid=victim, replacement_pid=fresh.handle.pid,
                               heal_s=time.monotonic() - killed[0], worker_crashes=reg.counter_total(
                                   "serve.worker_crashes") - crashes0, restarts=p2.supervisor.restarts_total - restarts0,
                               replacement_graphs=fresh.handle.ready_info.get("artifact_buckets"))
            print(f"  pid {victim} SIGKILLed {S6_KILL_AFTER_S} s into the loop: no future lost, "
                  f"{out['kill']['worker_crashes']:g} flush(es) re-run, healed by pid {fresh.handle.pid} "
                  f"({out['kill']['replacement_graphs']} bucket graphs captured) {out['kill']['heal_s']:.2f} s after "
                  f"the kill ({t0 - killed[0]:.2f} s of it after the loop) ({card})", flush=True)
        with phase("serve S6: S1's saturation loop, threaded fleet (replicas=1) against workers=2"):
            sat = {}
            sat["threads"] = sat_loops("threaded fleet, replicas=1", thr)
            out["ingress_ab"] = {"threads": ab("the threaded fleet (replicas=1)", thr)}
            thr.close(timeout=SERVE_RESULT_S)
            services.remove(thr)
            out["threaded_launches"] = {"launches": dict(fk.LAUNCHES), "replayed": dict(graphs.REPLAYED)}
            fk.reset_launches()
            graphs.reset_replayed()
            for n in S6_WORKERS:
                if n == 2:
                    svc = p2
                else:
                    svc, out[f"workers_{n}"] = spawn(f"s6_p{n}", workers=n)
                sat[f"workers_{n}"] = sat_loops(f"process fleet, workers={n}", svc)
                sat[f"workers_{n}"]["peak_reserved_mib"] = _worker_peaks(svc)
                print(f"  workers={n}: each worker's peak reserved memory (MiB) "
                      f"{ {k: round(v, 1) for k, v in sat[f'workers_{n}']['peak_reserved_mib'].items()} } ({card})",
                      flush=True)
                if n != 2:
                    add_totals(svc, {})
                    svc.close(timeout=SERVE_RESULT_S)
                    services.remove(svc)
            out["saturation"] = sat
        with phase("serve S6: the binary ingress in front of workers=2"):
            front = serve_ingress(p2, port=0, shards=1)
            try:
                few = imgs[:SERVE_BUCKETS[0]]
                with BinaryClient("127.0.0.1", front.port) as c:
                    got_bin = c.predict(few)
                    ing0, pre0 = reg.counter_total("ingress.bytes_copied"), reg.counter_total("serve.preformed_flushes")
                    disp0 = reg.counter_total("dispatch.bytes_copied")
                    got_block = c.predict(imgs[:BATCH])
                    copied = reg.counter_total("ingress.bytes_copied") - ing0
                    dispatched = reg.counter_total("dispatch.bytes_copied") - disp0
                    preformed = reg.counter_total("serve.preformed_flushes") - pre0
                req = urllib.request.Request(f"http://127.0.0.1:{front.port}/predict",
                                             data=json.dumps({"instances": few.tolist()}).encode(),
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=SERVE_RESULT_S) as resp:
                    got_http = np.asarray(json.loads(resp.read())["predictions"], np.float32)
            finally:
                front.stop()
            check(got_bin.tobytes() == got_http.tobytes(), "binary ingress != HTTP JSON on the same 8 rows")
            check(copied == 0 and dispatched == 0 and preformed == 1,
                  f"slab-direct path: ingress.bytes_copied {copied}, dispatch.bytes_copied {dispatched}, "
                  f"preformed flushes {preformed}")
            check(got_block.tobytes() == proc_block.tobytes(), "the binary 128-row batch != the slab block's answers")
            out["ingress"] = {"bit_equal_http": True, "slab_direct_bytes_copied": copied,
                              "slab_direct_dispatch_bytes": dispatched, "preformed": preformed}
            print(f"  BinaryClient over loopback: {len(few)} rows bit for bit the HTTP JSON answers; a {BATCH}-row "
                  f"batch slab-direct: ingress.bytes_copied +{copied:g}, dispatch.bytes_copied +{dispatched:g}, "
                  f"{preformed:g} preformed flush, bit for bit the slab block's ({card})", flush=True)
            out["ingress_ab"]["workers_2"] = ab("workers=2", p2)
        add_totals(p2, k2)
        with phase("serve S6: the network fleet, two `cli worker` children over loopback, a partition mid-load"):
            net, out["net"] = spawn("s6_net", workers=2, hosts=["local", "local"],
                                    worker_opts={"lease_s": S6_LEASE_S, "spawn_grace_s": 5.0})
            check(net.listen_address is not None, "no worker listener")
            net_block = np.stack([f.result(timeout=SERVE_RESULT_S) for f in net.submit_many(list(imgs[:BATCH]))])
            check(net_block.tobytes() == proc_block.tobytes(), "network fleet != process fleet on one full bucket")
            victim = net._pool.replicas[0].handle.name
            plan = f"serve.net.send:ctx.link={victim}:partition;serve.net.recv:ctx.link={victim}:partition"
            restarts0, retrans0 = net.supervisor.restarts_total, reg.counter_total("serve.net.retransmits")
            result = {}

            def drive():
                try:
                    result["loop"] = loop("network fleet, 2 workers, one partitioned", net, S6_NET_N)[0]
                except BaseException as e:  # raised below
                    result["error"] = e

            t = threading.Thread(target=drive)
            t.start()
            time.sleep(0.1)
            with faults.inject(plan):
                time.sleep(S6_PARTITION_S)
            t.join(SERVE_RESULT_S * 3)
            check(not t.is_alive(), "the partitioned loop hung")
            if "error" in result:
                raise result["error"]
            heal(net, 2, restarts0, "after the partition")
            healed_block = np.stack([f.result(timeout=SERVE_RESULT_S)
                                     for f in net.submit_many(list(imgs[:BATCH]))])
            check(healed_block.tobytes() == proc_block.tobytes(), "the healed network fleet's answers moved")
            out["net"].update(result["loop"], partition_s=S6_PARTITION_S, lease_s=S6_LEASE_S, victim=victim,
                              restarts=net.supervisor.restarts_total - restarts0,
                              retransmits=reg.counter_total("serve.net.retransmits") - retrans0,
                              bit_equal_process_fleet=True)
            print(f"  {victim} partitioned both ways for {S6_PARTITION_S} s (lease {S6_LEASE_S} s) in a loop of "
                  f"{S6_NET_N}: none lost, {out['net']['restarts']} restart(s), {out['net']['retransmits']:g} "
                  f"retransmits, healed to 2 leased workers; a full bucket bit for bit the process fleet's before and "
                  f"after ({card})", flush=True)
            add_totals(net, {})
        check(reg.counter_total("serve.artifact_fallbacks") == fb0, "a worker's bundle was refused")
        parent = {"launches": dict(fk.LAUNCHES), "replayed": dict(graphs.REPLAYED)}
        check(parent["launches"]["fused_forward"] == 0 and not parent["replayed"].get("fused_forward"),
              f"the router launched B1 while its workers served: {parent}")
        check(totals["launches"].get("fisher_encode", 0) == 0 and totals["replayed"].get("fisher_encode", 0) == 0,
              f"B2 ran in a worker: {totals}")
        check(totals["replayed"].get("fused_forward", 0) > 0, f"no worker replayed a bucket graph: {totals}")
        out["parent"], out["workers_kernels"] = parent, totals
        out["seconds"] = time.perf_counter() - t_s6
        print(f"  S6 took {out['seconds']:.1f} s; the workers' B1: {totals['launches'].get('fused_forward', 0)} by "
              f"the wrapper, {totals['replayed'].get('fused_forward', 0)} by bucket-graph replays; this process's: "
              f"{parent['launches']['fused_forward']} and {parent['replayed'].get('fused_forward', 0)}; the threaded "
              f"comparison's {out['threaded_launches']} ({card})", flush=True)
    finally:
        for svc in services:
            svc.close(timeout=SERVE_RESULT_S)
        pool.close()
    return out


# ---- serving S7 (the multi-tenant slice): three tenants over S1's
# full-width featurizer, each with a BlockLinearMapper head of its own
# (S1's, and two seeded 0.01·normal draws at its shape), built as workflow
# graphs (P.scorer_pipeline), saved to a file each and loaded apart, so
# their equal featurizers are distinct tensors the sharing plan keys by
# content.  Frozen for the card, FvFusionRule puts B1 in the shared prefix:
# a combined flush launches it once a branch with the share on, three
# times that with it off.  Served scores against each tenant's offline
# eager scorer at S1's tolerance (TOL_SERVE_SCORES), top-5 equal or a
# near-tie; share on against off and one tenant against serve(), bit for
# bit.  Then `cli serve` with three named models over HTTP, serve_bench's
# tenant A/B in short legs (rates printed, nothing claimed), and the chaos
# tool on the card: the `tenants` workload and a seeded 2 s soak over two
# worker processes.
S7_TENANTS = ("t0", "t1", "t2")
S7_SERVED_N = 384  # requests a tenant in the closed loop (3 x 128 images)
S7_HTTP_N = 4  # images POSTed a tenant to the `cli serve` child
S7_AB = {"qps": 8000.0, "duration": 1.0, "rounds": 2, "max_batch": BATCH}
S7_SOAK_S, S7_SOAK_WORKERS = 2, 2  # a 20 s soak, then 10 s, until S9, then 5 s, until S10 needed the room


def s7_models(P, cfg, scorer_params, dev, tmp):
    """The three tenants saved apart; returns {tenant: path} and each
    tenant's params (its head differs)."""
    paths, params = {}, {}
    head = scorer_params["blm.weights"]
    for i, t in enumerate(S7_TENANTS):
        p = dict(scorer_params)
        if i:
            g = torch.Generator(device=dev).manual_seed(100 + i)
            p["blm.weights"] = 0.01 * torch.randn(tuple(head.shape), generator=g, device=dev, dtype=head.dtype)
        params[t] = p
        paths[t] = tmp / f"tenant_{t}.pt"
        P.scorer_pipeline(p, cfg).save(str(paths[t]))
    return paths, params


def tenants_path(dev, card, P, fk, cfg, scorer_params, images):
    """S7: multi-tenant serving on the card, then the chaos tool."""
    import re
    import signal

    from keystone_tpu_torch import faults
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.serve import MultiTenantApplier, SharedStagePool, serve, serve_multi
    from keystone_tpu_torch.tools import serve_bench
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline
    from keystone_tpu_torch.workflow.profiling import pool_budget_bytes

    out = {}
    t_s7 = time.perf_counter()
    imgs = images.cpu().numpy()
    tmp = Path(tempfile.mkdtemp(prefix="tenants_", dir=REPO))
    proc = None
    try:
        torch.cuda.synchronize()
        fk.reset_launches()
        with phase("serve S7: three tenants saved apart and loaded; offline scorers; the sharing plan"):
            paths, params = s7_models(P, cfg, scorer_params, dev, tmp)

            def load_all():
                return {t: FittedPipeline.load(str(paths[t]), map_location=dev) for t in S7_TENANTS}

            models = load_all()
            offline = {t: P.scores_of(P.build_scorer_from_params(params[t], cfg, dev)) for t in S7_TENANTS}
            off = {t: torch.cat([offline[t](b) for b in images[:S7_SERVED_N].split(BATCH)]).cpu().numpy()
                   for t in S7_TENANTS}
            budget = pool_budget_bytes()
            pool = SharedStagePool(budget_bytes=budget)
            t0 = time.perf_counter()
            on = MultiTenantApplier(models, pool=pool, share=True, device=dev)
            plan_s = time.perf_counter() - t0
            off_app = MultiTenantApplier(models, share=False, device=dev)
            fused = {t: sorted(op.transformer.label for op in a.graph.operators.values()
                               if "FusedFV" in getattr(getattr(op, "transformer", None), "label", ""))
                     for t, a in on.appliers.items()}
            print(f"  plan in {plan_s:.3f} s (each tensor read back once): {len(on.plan.shared)} shared stage(s), "
                  f"{on.plan.refused} refused; fused FV nodes a tenant {fused['t0']}; pool budget "
                  f"{budget / 2**30:.2f} GiB (a quarter of the card's)", flush=True)
            check(all(v == ["FusedFV[PCA > FV]", "FusedFV[SiftNorm > PCA > FV]"] for v in fused.values()),
                  f"the card's freeze did not fuse each PCA -> FV pair: {fused}")
            check(len(on.plan.shared) == 1 and on.plan.refused == 0, f"plan {on.plan.shared} refused {on.plan.refused}")
            out["plan"] = {"seconds": plan_s, "shared_stages": len(on.plan.shared), "refused": on.plan.refused}
        with phase("serve S7: share on against share off, one padded batch of 128 through MultiTenantApplier"):
            x = images[:BATCH]
            got = {}
            for label, app, want_b1 in (("on", on, 2), ("off", off_app, 6)):
                app(x)  # warm-up
                torch.cuda.synchronize()
                before = dict(fk.LAUNCHES)
                h0 = pool.stats()["hits"]
                t0 = time.perf_counter()
                res = app(x)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                b1 = fk.LAUNCHES["fused_forward"] - before["fused_forward"]
                got[label] = {t: d.array.cpu() for t, d in res.items()}
                print(f"  share {label}: B1 launched {b1} times in the combined flush (expected {want_b1}), "
                      f"{dt * 1e3:.3f} ms of host clock, pool hits {pool.stats()['hits'] - h0} ({card})", flush=True)
                check(b1 == want_b1 and fk.LAUNCHES["fisher_encode"] == before["fisher_encode"],
                      f"share {label}: B1 {b1}, expected {want_b1}; launches {dict(fk.LAUNCHES)}")
                out[f"share_{label}"] = {"b1_launches": b1, "ms": dt * 1e3}
            for t in S7_TENANTS:
                check(torch.equal(got["on"][t], got["off"][t]), f"tenant {t}: share on differs from share off")
            st = pool.stats()
            print(f"  share on == share off bit for bit for {list(S7_TENANTS)}; pool {st}", flush=True)
            check(st["hits"] > 0 and st["resident_bytes"] == 0 and 0 < st["peak_bytes"] <= budget, f"pool {st}")
            out["pool_direct"] = st
            del on, off_app, got
        with phase("serve S7: serve_multi over the three tenants (closed loop, 8 clients)"):
            svc = serve_multi({t: m.freeze(device=dev) for t, m in models.items()}, pool=pool, max_batch=BATCH, buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS,
                              queue_bound=4 * SERVE_CLIENTS * SERVE_SAT_WINDOW, example=imgs[0], name="s7")
            try:
                c0 = serve_counters(metrics)
                b0, h0 = fk.LAUNCHES["fused_forward"], pool.stats()["hits"]
                order = [S7_TENANTS[i % 3] for i in range(3 * S7_SERVED_N)]
                rows = [(order[i], imgs[i // 3]) for i in range(3 * S7_SERVED_N)]
                served, lat, wall = serve_closed_loop(
                    svc, list(range(len(rows))), len(rows), SERVE_SAT_WINDOW,
                    submit=lambda i: svc.submit(rows[i][1], tenant=rows[i][0]))
                c1 = serve_counters(metrics)
                flushes = c1["batches"] - c0["batches"]
                b1 = fk.LAUNCHES["fused_forward"] - b0
                per = {}
                for t in S7_TENANTS:
                    idx = [i for i in range(len(rows)) if rows[i][0] == t]
                    sc = np.stack([served[i] for i in idx])
                    ids = np.argsort(-off[t], axis=1, kind="stable")[:, :5]
                    err = compare(f"tenant {t}: {len(idx)} served raw scores against its offline scorer",
                                  torch.from_numpy(sc), torch.from_numpy(off[t][:len(idx)]), TOL_SERVE_SCORES,
                                  RTOL_SERVE_SCORES)
                    top = top5_check(f"tenant {t}", np.argsort(-sc, axis=1, kind="stable")[:, :5], ids, off[t])
                    per[t] = {"max_abs_err": err, "top5": top}
                st = svc.status()
                print(f"  {len(rows)} requests in {wall:.3f} s ({len(rows) / wall:.1f} images/s), {flushes} flushes "
                      f"({len(rows) / max(1, flushes):.1f} requests a flush), B1 {b1} = 2 a flush; p50 "
                      f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 {np.percentile(lat, 99) * 1e3:.3f} ms; pool "
                      f"{st['stage_pool']} ({card})", flush=True)
                check(b1 == 2 * flushes, f"B1 {b1} over {flushes} combined flushes: expected 2 a flush")
                check(st["stage_pool"]["hits"] > h0 and st["stage_pool"]["resident_bytes"] == 0,
                      f"pool {st['stage_pool']}")
                out["serve_multi"] = {"requests": len(rows), "seconds": wall, "images_per_s": len(rows) / wall,
                                      "flushes": flushes, "b1_launches": b1, "tenants": per,
                                      "p50_ms": float(np.percentile(lat, 50) * 1e3),
                                      "p99_ms": float(np.percentile(lat, 99) * 1e3), "pool": st["stage_pool"]}
                # containment: a serve.batch fault aimed at t1 fails t1's riders only
                with faults.inject("serve.batch:ctx.tenant=t1:raise:times=1"):
                    futs = {t: [svc.submit(imgs[i], tenant=t) for i in range(4)] for t in S7_TENANTS}
                    failed = {t: 0 for t in S7_TENANTS}
                    for t, fs in futs.items():
                        ok = []
                        for i, f in enumerate(fs):
                            try:
                                ok.append((i, f.result(timeout=SERVE_RESULT_S)))
                            except faults.FaultInjected:
                                failed[t] += 1
                        if ok:
                            compare(f"tenant {t}: {len(ok)} answers under the fault against its offline scorer",
                                    torch.from_numpy(np.stack([y for _, y in ok])),
                                    torch.from_numpy(off[t][[i for i, _ in ok]]), TOL_SERVE_SCORES, RTOL_SERVE_SCORES)
                print(f"  serve.batch fault aimed at t1: failed riders {failed}", flush=True)
                check(failed["t0"] == failed["t2"] == 0 and failed["t1"] >= 1, f"containment {failed}")
                out["containment"] = failed
            finally:
                svc.close(timeout=SERVE_RESULT_S)
        with phase("serve S7: one tenant through serve_multi against serve() over the same pipeline"):
            kw = dict(max_batch=BATCH, buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS, example=imgs[0])
            one = serve_multi({"t0": models["t0"].freeze(device=dev)}, name="s7_one", **kw)
            plain = serve(FittedPipeline.load(str(paths["t0"]), map_location=dev).freeze(device=dev), name="s7_plain",
                          **kw)
            try:
                a = [f.result(timeout=SERVE_RESULT_S) for f in one.submit_many(imgs[:16])]
                b = [f.result(timeout=SERVE_RESULT_S) for f in plain.submit_many(imgs[:16])]
            finally:
                one.close(timeout=SERVE_RESULT_S)
                plain.close(timeout=SERVE_RESULT_S)
            same = all(np.array_equal(u, v) for u, v in zip(a, b))
            print(f"  16 images, one tenant: bit for bit {same}", flush=True)
            check(same, "one tenant through serve_multi differs from serve()")
        with phase("serve S7: `cli serve --model t0=.. --model t1=.. --model t2=..` over HTTP"):
            cmd = [sys.executable, "-m", "keystone_tpu_torch.cli", "serve", "--device", DEVICE, "--port", "0",
                   "--max-batch", str(SERVE_HTTP_MAX_BATCH), "--max-wait-ms", "2", "--example-shape",
                   f"{IMAGE_HW},{IMAGE_HW},3"]
            for t in S7_TENANTS:
                cmd += ["--model", f"{t}={paths[t]}"]
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(REPO),
                                    env={**os.environ, "PYTHONPATH": str(REPO)})
            line, lines = "", []
            while "serving" not in line and proc.poll() is None and time.perf_counter() - t0 < 600:
                line = proc.stdout.readline()
                lines.append(line)
            check("serving" in line, f"`cli serve` did not start: {''.join(lines)[-2000:]}")
            base = "http" + line.split(" on http", 1)[1].split(" ", 1)[0]
            print(f"  `cli serve` with three named models up in {time.perf_counter() - t0:.2f} s", flush=True)
            xf = (images[:S7_HTTP_N].float() / 255.0).cpu().numpy()
            xf_scores = {t: torch.cat([offline[t](images[:S7_HTTP_N].float() / 255.0)]).cpu().numpy()
                         for t in S7_TENANTS}
            http = {}
            for t in S7_TENANTS:
                status, body, _ = http_call(base + "/predict", {"instances": xf.tolist(), "tenant": t})
                check(status == 200, f"tenant {t}: /predict answered {status}: {str(body)[:300]}")
                http[t] = compare(f"tenant {t}: {S7_HTTP_N} images over HTTP against its offline scorer",
                                  torch.tensor(body["predictions"]), torch.from_numpy(xf_scores[t]),
                                  TOL_SERVE_SCORES, RTOL_SERVE_SCORES)
            status, body, _ = http_call(base + "/predict", {"instances": xf[:1].tolist(), "tenant": "nope"})
            check(status == 400, f"an unknown tenant answered {status}")
            status, st, _ = http_call(base + "/statusz")
            check(status == 200 and set(st["tenants"]) == set(S7_TENANTS), f"/statusz {status}")
            status, text, _ = http_call(base + "/metrics")
            batches = float(re.search(r"^serve_batches_total (\S+)$", text, re.M).group(1))
            proc.send_signal(signal.SIGINT)
            tail, _ = proc.communicate(timeout=120)
            check(proc.returncode == 0, f"`cli serve` exited {proc.returncode} on SIGINT: {tail[-2000:]}")
            m = re.search(r"fisher_kernels launches (\{.*\})", tail)
            check(m is not None, f"no launch counts printed: {tail[-2000:]}")
            child = json.loads(m.group(1).replace("'", '"'))
            primes = 2  # buckets of max batch 16: 8 and 16, every tenant's walk sharing the prefix
            print(f"  an unknown tenant: 400; the child's launches {child} over {int(batches)} flushes and {primes} "
                  f"primes (B1 twice each: the prefix once a combined flush); SIGINT: exit 0 ({card})", flush=True)
            check(child == fv_launches(fused=2 * (int(batches) + primes)), f"the child's launches {child}")
            out["cli"] = {"http_max_abs_err": http, "flushes": int(batches), "launches": child,
                          "pool": st["stage_pool"]}
        with phase("serve S7: serve_bench's tenant A/B at full width (share on against off, short legs)"):
            ab = serve_bench.run_tenants_ab(models_fn=load_all, payload=imgs[:64], item_shape=imgs.shape[1:],
                                            dtype=imgs.dtype, device=dev, **S7_AB)
            print(f"  images/s: share on {_rounded(ab['runs_qps_shared'], 1)}, off "
                  f"{_rounded(ab['runs_qps_unshared'], 1)} (medians {ab['aggregate_qps_shared']:.1f}, "
                  f"{ab['aggregate_qps_unshared']:.1f}); the shared arm's pool hit rate "
                  f"{ab['pool']['hit_rate']}; bit for bit {ab['predictions_identical']} ({card})", flush=True)
            check(ab["predictions_identical"], "serve_bench's A/B arms answered differently")
            out["serve_bench_ab"] = {k: ab[k] for k in ("runs_qps_shared", "runs_qps_unshared", "aggregate_qps_shared",
                                                         "aggregate_qps_unshared", "speedup", "fairness_p99_ratio",
                                                         "pool")}
        torch.cuda.synchronize()
        out["launches"] = dict(fk.LAUNCHES)
        check(out["launches"]["fisher_encode"] == 0, f"S7 launched B2: {out['launches']}")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_s7
    chaos_s = time.perf_counter()
    for label, argv in (("the tenants workload", ["--workload", "tenants", "--plan", "serve.batch:ctx.tenant=a:raise"]),
                        (f"a seeded {S7_SOAK_S} s soak over {S7_SOAK_WORKERS} worker processes",
                         ["--soak", str(S7_SOAK_S), "--seed", "0", "--soak-workers", str(S7_SOAK_WORKERS)])):
        with phase(f"chaos on the card: {label}"):
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", "keystone_tpu_torch.tools.chaos", *argv], capture_output=True,
                                 text=True, timeout=600, cwd=str(REPO), env={**os.environ, "PYTHONPATH": str(REPO)})
            check(res.returncode == 0, f"chaos {argv} exited {res.returncode}: {res.stdout[-2000:]} {res.stderr[-2000:]}")
            rep = json.loads(res.stdout)
            if "--soak" in argv:
                summary = {k: rep[k] for k in ("iterations", "submitted", "completed", "failed_typed", "rejected",
                                               "hung", "process_kills", "healthy_after_soak")}
                check(rep["ok"] and rep["hung"] == 0, f"soak {summary}")
            else:
                summary = {"sites": rep["sites"], "device": rep["device"]}
                check(rep["completed"] and rep["sites"]["serve.batch"]["verdict"] == "survived", f"chaos {summary}")
            print(f"  exit 0 in {time.perf_counter() - t0:.2f} s: {summary} ({card})", flush=True)
            out["chaos_" + ("soak" if "--soak" in argv else "tenants")] = {"seconds": time.perf_counter() - t0,
                                                                          **summary}
    out["chaos_seconds"] = time.perf_counter() - chaos_s
    print(f"  S7 {out['seconds']:.1f} s, chaos {out['chaos_seconds']:.1f} s", flush=True)
    return out


S8_EXAMPLE_N = 64  # the planned freeze's example images (its sampled batches of 8, 32, 128 are drawn from them)
S8_FLIP_DELAY_S = 0.05  # the plan.sample delay injected into the winner's timed samples
# one round of each leg since the solver-precision phase needed the room (its
# one gate, the drift retune's, reads no round)
S8_AB = {"qps": 2000.0, "duration": 1.0, "rounds": 1, "max_batch": BATCH, "deadline_ms": 2000.0,
         "drift_duration": 2.0, "drift_qps": 400.0}
S8_HTTP_N = 4  # images POSTed to the `cli serve --model-dir` child
# the live bucket retune: a service over the planned freeze with bucket
# graphs at 8 and 32 rows, offered 12-row requests; the retune adds 16
S8_RETUNE = {"buckets": (8, 32), "retuned": (8, 16, 32), "added": 16, "rows": 12, "load_s": 0.4}


def planner_path(dev, card, P, fk, gk, cfg, scorer_params, images):
    """S8: the pre-flight analyzer and the cost-based physical planner on
    the card."""
    import re
    import signal

    from keystone_tpu_torch import cli, faults, planner
    from keystone_tpu_torch.analysis import PipelineValidationError
    from keystone_tpu_torch.models.gmm import GaussianMixtureModel
    from keystone_tpu_torch.models.linear import LinearMapEstimator
    from keystone_tpu_torch.models.pca import PCATransformer
    from keystone_tpu_torch.ops.fisher import FisherVector
    from keystone_tpu_torch.ops.images import GrayScaler, PixelScaler
    from keystone_tpu_torch.ops.sift import SIFTExtractor
    from keystone_tpu_torch.serve.registry import ModelRegistry
    from keystone_tpu_torch.tools import serve_bench
    from keystone_tpu_torch.workflow.dataset import Dataset
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    out = {}
    t_s8 = time.perf_counter()
    imgs = images.cpu().numpy()
    tmp = Path(tempfile.mkdtemp(prefix="planner_", dir=REPO))
    proc = None
    child_launches = {"fused_forward": 0, "fisher_encode": 0}
    try:
        planner.clear_plan()
        torch.cuda.synchronize()
        fk.reset_launches()
        gk.reset_launches()
        with phase("S8: `cli check --all` over every bundled pipeline, in a child process on the card"):
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", "keystone_tpu_torch.cli", "check", "--all", "--device",
                                  DEVICE], capture_output=True, text=True, timeout=600, cwd=str(REPO),
                                 env={**os.environ, "PYTHONPATH": str(REPO)})
            text = res.stdout
            names = re.findall(r"^== (\S+)$", text, re.M)
            work = re.findall(r"^device work during the analysis: kernel launches (\{.*\}), device memory allocated "
                              r"(\d+) -> (\d+) bytes$", text, re.M)
            clean = text.count("analysis: no findings")
            print(f"  exit {res.returncode} in {time.perf_counter() - t0:.2f} s: {len(names)} pipelines, {clean} with "
                  f"no findings; launches around each analysis {sorted({w[0] for w in work})}, allocated bytes "
                  f"unchanged in {sum(a == b for _, a, b in work)} of {len(work)} ({card})", flush=True)
            check(res.returncode == 0, f"`cli check --all` exited {res.returncode}: {text[-3000:]} {res.stderr[-2000:]}")
            from keystone_tpu_torch.cli import _PIPELINE_MODULES

            check(sorted(names) == sorted(_PIPELINE_MODULES) and clean == len(names),
                  f"`cli check --all`: {names}, {clean} clean: {text[-3000:]}")
            check(len(work) == len(names) and all(w[0] == "{}" and w[1] == w[2] for w in work),
                  f"the analysis launched a kernel or moved device memory: {work}")
            out["check"] = {"seconds": time.perf_counter() - t0, "pipelines": len(names), "no_findings": clean}
        with phase("S8: a mis-wired pipeline and a bad fault plan refused by fit(validate=True) before any launch"):
            x, labels = images[:64], torch.zeros((64, NUM_CLASSES), device=dev)
            gm = GaussianMixtureModel(scorer_params["sift.gmm.weights"], scorer_params["sift.gmm.means"],
                                      scorer_params["sift.gmm.variances"])

            def fv_pipeline(dims):
                comp = scorer_params["sift.pca.components"][:, :dims].contiguous()
                return (Pipeline.of(PixelScaler(only_if_integer=True)).and_then(GrayScaler())
                        .and_then(SIFTExtractor(cfg.sift_step, (cfg.sift_bin_size,)))
                        .and_then(PCATransformer(comp, scorer_params["sift.pca.mean"])).and_then(FisherVector(gm))
                        .and_then(LinearMapEstimator(lam=1e-3), Dataset(x), Dataset(labels)))

            refused = {}
            before = dict(fk.LAUNCHES)
            m0 = torch.cuda.memory_allocated()
            for label, pipe, env in (("PCA of 32 dims into a GMM of 64", fv_pipeline(PCA_DIMS // 2), None),
                                     ("KEYSTONE_FAULTS naming no site", fv_pipeline(PCA_DIMS), "executor.stag:raise")):
                with env_var("KEYSTONE_FAULTS", env):
                    try:
                        pipe.fit(validate=True)
                        codes = None
                    except PipelineValidationError as e:
                        codes = sorted({f.code for f in e.report.errors})
                refused[label] = codes
            torch.cuda.synchronize()
            print(f"  refused with {refused}; B1/B2 launches {fk.LAUNCHES} (before {before}), device memory "
                  f"allocated {m0} -> {torch.cuda.memory_allocated()} bytes ({card})", flush=True)
            check(list(refused.values()) == [["shape-mismatch"], ["bad-fault-plan"]], f"refusals {refused}")
            check(dict(fk.LAUNCHES) == before and not any(gk.LAUNCHES.values()), "a refused fit launched a kernel")
            out["refused"] = refused
        scorer = P.scorer_pipeline(scorer_params, cfg)  # the graph form: PCA -> FV pairs the freeze may fuse
        example = imgs[:S8_EXAMPLE_N]
        with phase("S8: S1's scorer frozen with plan=True (the fused_fv gate sampled: B1 against PCA then B2)"):
            b0 = dict(fk.LAUNCHES)
            t0 = time.perf_counter()
            frozen = scorer.freeze(device=dev, plan=True, example=example)
            plan_s = time.perf_counter() - t0
            plan = frozen.plan
            sampled = {k: fk.LAUNCHES[k] - b0[k] for k in ("fused_forward", "fisher_encode")}
            stages = [s_ for s_ in plan.stages if s_.gate == "fused_fv"]
            for st in stages:
                for c in st.candidates:
                    print(f"  fused_fv {st.label}: {c.name}: samples (rows, ms) "
                          f"{[(n, round(sec * 1e3, 4)) for n, sec in c.samples]}; a = {c.coeffs[0] * 1e3:.4f} ms, "
                          f"b = {c.coeffs[1] * 1e6:.4f} us a row; {c.full_seconds * 1e3:.4f} ms at "
                          f"{plan.full_batch} rows", flush=True)
                print(f"  winner {st.winner} ({st.why})", flush=True)
            winner = plan.choice_for("fused_fv")
            print(f"  plan {plan.fingerprint()} built in {plan_s:.2f} s (sampling launched {sampled}); knobs "
                  f"{plan.knobs}; the frozen graph's choice {frozen.physical_choices} ({card})", flush=True)
            check(len(stages) == 2 and all(len(st.candidates) == 2 and all(c.samples for c in st.candidates)
                                           for st in stages), f"the fused_fv stages {[s_.to_dict() for s_ in stages]}")
            check(sampled["fused_forward"] > 0 and sampled["fisher_encode"] > 0,
                  f"the sampling did not launch both candidates: {sampled}")
            check(frozen.physical_choices == {"fused_fv": winner}, f"choices {frozen.physical_choices}")
            out["plan"] = {"seconds": plan_s, "winner": winner, "sampling_launches": sampled,
                           "knobs": plan.knobs, "stages": [s_.to_dict() for s_ in plan.stages]}
        with phase("S8: the planned freeze against a freeze with the winner forced and no plan; the candidates"):
            x = images[:BATCH]
            planned = frozen(x).array
            planner.clear_plan()
            frozen_by = {}
            for cand in ("kernel", "chain"):
                with env_var("KEYSTONE_FUSED_FV", "1" if cand == "kernel" else "0"):
                    frozen_by[cand] = scorer.freeze(device=dev)
            forced = frozen_by[winner](x).array
            same = bool(torch.equal(planned, forced))
            ka, kb = frozen_by["kernel"](x).array, frozen_by["chain"](x).array
            err = compare("scores: the fused kernel (B1) against PCA then B2", ka, kb, TOL_SCORES)
            top = (torch.topk(ka, 5).indices.sort(dim=1).values == torch.topk(kb, 5).indices.sort(dim=1).values)
            agree = float(top.all(dim=1).float().mean())
            print(f"  planned == forced {winner} bit for bit: {same}; the candidates' top-5 agree on {agree:.4f} "
                  f"({card})", flush=True)
            check(same, "the planned freeze differs from the freeze with its winner forced")
            check(agree >= TOP5_AGREEMENT, f"the candidates' top-5 agree on {agree}")
            out["candidates"] = {"max_abs_err": err, "top5_agreement": agree, "planned_equals_forced": same}
            del frozen_by, ka, kb
        with phase("S8: the bucket graphs captured under the shipped plan (a fresh applier, the bundle installed)"):
            bundle = frozen.export_artifacts(example=imgs[0], buckets=(8,))
            check(bundle["manifest"]["plan"] == plan.to_dict(), "the manifest ships no plan")
            planner.clear_plan()
            with env_var("KEYSTONE_FUSED_FV", "0" if winner == "kernel" else "1"):
                fresh = scorer.freeze(device=dev)  # frozen under the other choice
            other = fresh.physical_choices["fused_fv"]
            n_inst = fresh.install_artifacts(bundle, strict=True)
            xb = images[:8]
            with torch.cuda.stream(torch.cuda.Stream()):
                walked = fresh._walk(Dataset(xb)).array
                first = fresh(xb).array  # captures
                replay = fresh(xb).array
                torch.cuda.synchronize()
            stats = fresh.graph_stats()[8]
            want_kernel = "fused_forward" if winner == "kernel" else "fisher_encode"
            print(f"  frozen under {other}, the bundle's plan reinstalled ({planner.plan_status()['source']}), "
                  f"re-optimized to {fresh.physical_choices}; {n_inst} bucket graph, launches in it "
                  f"{stats['launches']}; replay == walk bit for bit {bool(torch.equal(replay, walked))} ({card})",
                  flush=True)
            check(planner.plan_status()["source"] == "artifacts" and fresh.physical_choices == {"fused_fv": winner},
                  f"the shipped plan: {planner.plan_status()}, {fresh.physical_choices}")
            check(n_inst == 1 and stats["captured"] and stats["launches"] == {want_kernel: 2},
                  f"the bucket graph {stats}: expected {want_kernel} twice")
            check(bool(torch.equal(replay, walked)) and bool(torch.equal(first, walked)), "replay differs from walk")
            out["graphs"] = {"frozen_under": other, "launches": stats["launches"]}
            del fresh
        with phase("S8: a live bucket retune under load: the added bucket walks, prime captures it, replay == walk"):
            out["retune"] = retune_under_load(dev, card, frozen, imgs, images)
        with phase("S8: the plan.sample fault: a delay in the winner's timed samples flips the winner"):
            spec = f"plan.sample:ctx.gate=fused_fv:ctx.candidate={winner}:delay={S8_FLIP_DELAY_S}"
            t0 = time.perf_counter()
            with faults.inject(spec):
                flipped = planner.build_plan(scorer, example=example, device=dev, candidates={"matmul": ()})
            now = flipped.choice_for("fused_fv")
            print(f"  under {spec}: winner {now} (was {winner}), in {time.perf_counter() - t0:.2f} s; "
                  f"{[c.full_seconds * 1e3 for c in flipped.stages[0].candidates]} ms ({card})", flush=True)
            check(now != winner and all(s_.winner == now for s_ in flipped.stages if s_.gate == "fused_fv"),
                  f"the delay did not flip the winner: {[s_.to_dict() for s_ in flipped.stages]}")
            out["flip"] = {"winner": now, "seconds": time.perf_counter() - t0}
        with phase("S8: `cli plan` writes the JSON; `cli export --plan` ships it; a fresh `cli serve` installs it"):
            model, plan_json, reg_dir = tmp / "scorer.pt", tmp / "plan.json", tmp / "registry"
            scorer.save(str(model))
            shape = f"{IMAGE_HW},{IMAGE_HW},3"
            check(cli.main(["plan", "--model", str(model), "--example-shape", shape, "--dtype", "uint8", "--max-batch",
                            str(SERVE_HTTP_MAX_BATCH), "--out", str(plan_json), "--device", DEVICE]) == 0,
                  "`cli plan` failed")
            written = planner.PhysicalPlan.from_json(plan_json.read_text())
            check(cli.main(["export", "--model", str(model), "--example-shape", shape, "--dtype", "uint8", "--buckets",
                            "8,16", "--model-dir", str(reg_dir), "--plan", "--device", DEVICE]) == 0,
                  "`cli export --plan` failed")
            reg = ModelRegistry(str(reg_dir))
            shipped = planner.PhysicalPlan.from_dict(reg.load_artifacts(reg.versions()[-1])["manifest"]["plan"])
            print(f"  `cli plan`: {written.fingerprint()} ({written.choice_for('fused_fv')}); `cli export --plan`: "
                  f"{shipped.fingerprint()} ({shipped.choice_for('fused_fv')}) in the manifest", flush=True)
            planner.clear_plan()
            cmd = [sys.executable, "-m", "keystone_tpu_torch.cli", "serve", "--device", DEVICE, "--port", "0",
                   "--model-dir", str(reg_dir), "--max-batch", "16", "--max-wait-ms", "2", "--example-shape", shape]
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(REPO),
                                    env={**os.environ, "PYTHONPATH": str(REPO)})
            line, lines = "", []
            while "serving" not in line and proc.poll() is None and time.perf_counter() - t0 < 600:
                line = proc.stdout.readline()
                lines.append(line)
            check("serving" in line, f"`cli serve` did not start: {''.join(lines)[-2000:]}")
            base = "http" + line.split(" on http", 1)[1].split(" ", 1)[0]
            status, body, _ = http_call(base + "/predict", {"instances": imgs[:S8_HTTP_N].tolist()})
            check(status == 200, f"/predict answered {status}: {str(body)[:300]}")
            want = frozen(images[:S8_HTTP_N]).array.cpu()
            http_err = compare(f"{S8_HTTP_N} images over HTTP against the planned freeze", torch.tensor(body["predictions"]),
                               want, TOL_SERVE_SCORES, RTOL_SERVE_SCORES)
            status, st, _ = http_call(base + "/statusz")
            proc.send_signal(signal.SIGINT)
            tail, _ = proc.communicate(timeout=120)
            check(proc.returncode == 0, f"`cli serve` exited {proc.returncode} on SIGINT: {tail[-2000:]}")
            m = re.search(r"fisher_kernels launches (\{.*\})", tail)
            r = re.search(r"graph replay launches (\{.*\})", tail)
            check(m is not None and r is not None, f"no launch counts printed: {tail[-2000:]}")
            launched = json.loads(m.group(1).replace("'", '"'))
            replayed = json.loads(r.group(1).replace("'", '"'))
            for k in child_launches:
                child_launches[k] += launched.get(k, 0) + replayed.get(k, 0)
            src = (st.get("plan") or {}).get("source")
            print(f"  the child's /statusz plan: {st.get('plan')}; launches {launched}, replays {replayed}; "
                  f"artifact fallbacks {st['counters']['artifact_fallbacks']} ({card})", flush=True)
            check(st["plan"] is not None and st["plan"]["fingerprint"] == shipped.fingerprint() and src == "artifacts",
                  f"the fresh process's plan {st.get('plan')}")
            check(st["counters"]["artifact_fallbacks"] == 0, "the child fell back from its bundle")
            out["cli"] = {"plan_json": written.fingerprint(), "manifest": shipped.fingerprint(), "statusz_plan": st["plan"],
                          "http_max_abs_err": http_err, "launches": launched, "replayed": replayed}
        with phase(f"S8: serve_bench's plan A/B at S1's width ({S8_AB['duration']:g} s legs, {S8_AB['rounds']} "
                   "round(s)) and the drift retune"):
            ab = serve_bench.run_plan_ab(fitted=scorer, payload=imgs[:256], item_shape=imgs.shape[1:], device=dev,
                                         **S8_AB)
            drift = ab["drift_retune"]
            print(f"  plan {ab['plan']['stages']} in {ab['plan']['seconds']:.2f} s; forward images/s static "
                  f"{ab['forward']['static_ips']:.1f}, planned {ab['forward']['planned_ips']:.1f}; open loop achieved "
                  f"{[r['achieved_qps'] for r in ab['serve']['static']]} static, "
                  f"{[r['achieved_qps'] for r in ab['serve']['planned']]} planned; drift: {drift['outcomes']}, "
                  f"retunes {drift['retunes']} (commits {drift['commits']}, reverts {drift['reverts']}), last "
                  f"{drift['last_action']}, p99 {drift['p99_ms_first_half']} / {drift['p99_ms_second_half']} ms, "
                  f"retuned-bucket walks {drift['retuned_bucket_walks']} ({card})", flush=True)
            check(drift["lost_futures"] == 0, f"the drift retune lost futures: {drift['outcomes']}")
            out["plan_ab"] = ab
        torch.cuda.synchronize()
        out["launches"] = dict(fk.LAUNCHES)
        out["child_launches"] = child_launches
        check(not any(gk.LAUNCHES.values()), f"S8 launched a gram kernel: {gk.LAUNCHES}")
    finally:
        planner.clear_plan()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_s8
    print(f"  S8 {out['seconds']:.1f} s ({card})", flush=True)
    return out


def retune_under_load(dev, card, frozen, imgs, images) -> dict:
    """``retune_buckets`` on a service over the planned freeze, its bucket
    graphs installed, while requests flow: the added bucket walks the
    executor (``serve.retuned_bucket_walks``, no artifact fallback) until
    ``prime`` captures its graph, which then replays the walk bit for
    bit, and later flushes of that bucket walk no more."""
    import threading

    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.serve import serve
    from keystone_tpu_torch.workflow.dataset import Dataset

    reg = metrics.REGISTRY
    cfg = S8_RETUNE
    k, new = cfg["rows"], cfg["added"]
    bundle = frozen.export_artifacts(example=imgs[0], buckets=cfg["buckets"])
    walks0, fb0 = reg.counter_total("serve.retuned_bucket_walks"), reg.counter_total("serve.artifact_fallbacks")
    svc = serve(frozen, max_batch=max(cfg["buckets"]), buckets=cfg["buckets"], max_wait_ms=2.0, example=imgs[0],
                artifacts=bundle, name="s8_retune", devices=[dev], recorder=False, supervise=False)
    try:
        svc.prime()
        app = svc._pool.replicas[0].applier
        futs, stop = [], threading.Event()

        def load():
            i = 0
            while not stop.is_set():
                futs.extend(svc.submit_many(list(imgs[i:i + k])))
                i = (i + k) % (len(imgs) - k)
                time.sleep(0.005)

        th = threading.Thread(target=load, name="s8-retune-load")
        th.start()
        time.sleep(cfg["load_s"] / 2)
        ladder = svc.retune_buckets(cfg["retuned"])
        time.sleep(cfg["load_s"] / 2)
        stop.set()
        th.join()
        answers = [f.result(timeout=120) for f in futs]
        walks = reg.counter_total("serve.retuned_bucket_walks") - walks0
        had_graph = app.has_bucket_program((new,) + imgs.shape[1:], imgs.dtype)
        svc.prime()
        xb = images[:new]
        with torch.cuda.stream(torch.cuda.Stream()):
            walked = app._walk(Dataset(xb)).array
            replay = app(xb).array
            torch.cuda.synchronize()
        stats = app.graph_stats()[new]
        w1 = reg.counter_total("serve.retuned_bucket_walks")
        after = [f.result(timeout=120) for f in svc.submit_many(list(imgs[:k]))]
        walks_after = reg.counter_total("serve.retuned_bucket_walks") - w1
        fallbacks = reg.counter_total("serve.artifact_fallbacks") - fb0
    finally:
        svc.close()
    same = bool(torch.equal(replay, walked))
    print(f"  ladder {cfg['buckets']} -> {ladder} under {len(futs)} requests of {k} rows ({len(answers)} answered): "
          f"{walks} retuned-bucket walks, {fallbacks} artifact fallbacks; graph for {new} before prime {had_graph}, "
          f"after {stats}; replay == walk bit for bit {same}; walks after prime {walks_after} ({card})", flush=True)
    check(len(answers) == len(futs) and all(np.all(np.isfinite(a)) for a in answers + after),
          "a request under the retune went unanswered or not finite")
    check(ladder == tuple(cfg["retuned"]) and walks >= 1 and fallbacks == 0 and not had_graph,
          f"the retune: ladder {ladder}, {walks} walks, {fallbacks} fallbacks, graph before prime {had_graph}")
    check(stats["captured"] and stats["replays"] >= 1 and same, f"the retuned bucket's graph {stats}, same {same}")
    check(walks_after == 0, f"{walks_after} walks of the retuned bucket after prime")
    return {"ladder": list(ladder), "requests": len(futs), "walks": walks, "fallbacks": fallbacks,
            "graph": stats, "replay_equals_walk": same, "walks_after_prime": walks_after}


# ---- S9, the parallel layer: the port's torch.distributed mesh on the
# card at the operations layer's in-core fit_checkpointed width (2048 x
# 16 384 features made from --seed with numpy, blocks of 4096, 64 classes,
# 2 epochs, f32), each leg in rank processes of this script
# (``--parallel-rank``), each ending with destroy_process_group so that no
# group reaches a later phase.  One card: NCCL refuses two ranks on one
# device, so the world of one runs NCCL and the world of two Gloo on CUDA
# tensors (all_reduce, broadcast and all_gather take CUDA tensors there,
# probed on the card's torch 2.11).  Two ranks sum in another order than
# one, so they are held to one rank f32-grade: within S9_F32_GRADE times
# the one-rank fit's own largest distance from a float64 fit of the same
# data (the f64 fit made here, on the card); a resumed job and its
# uninterrupted control (both two ranks) bit for bit.
S9_N, S9_D, S9_K = CKPT_N, CKPT_D, FIT_CLASSES
S9_BLOCK, S9_EPOCHS, S9_LAM, S9_MIX = FIT_BLOCK, FIT_EPOCHS, 1e-4, 0.5
S9_STORE_N = FIT_N // 2  # the per-rank stores: 512 of these rows each
S9_F32_GRADE = 2.0
# the two-rank fit_store against the in-memory fit of its rows: the
# reference's own bound (tests/multihost_oc_worker.py:63)
TOL_S9_STORE = 5e-4
# DistributedPCAEstimator on the fit's PCA shape (a SIFT sample, 131 072
# x 128 -> 64, models/pca.py::svd_driver): made rows with singular values
# 1 .. 0.5 over the top 64 and 0.05 .. 0.01 below (a gap at the 64th, as
# a descriptor sample's PCA needs one to be defined), offset by a mean;
# its projector C·Cᵀ against PCAEstimator's (the SVD, gesvda) within
# TOL_S9_PCA: the covariance's f32 Gramian over 131 072 rows perturbs it
# by about ε·√n/gap ≈ 1e-4
S9_PCA_N, S9_PCA_D, S9_PCA_K = 131072, 128, 64
TOL_S9_PCA = 1e-3
S9_PLAN = "multihost.init:after=0:times=1:raise"  # each Gloo rank's init retried once
S9_TIMEOUT = 300  # each rank process's own bound
S9_CRASH_EXIT = 42
# the rest of the parallel layer (A8b) in the same legs, each fit on the
# world of one (NCCL) and on two Gloo ranks, each rank its slice:
# k-means++ and the GMM at the fit's GMM sample (2048 images x 64 samples,
# PCA 64 -> 131 072 x 64 rows, K = 64, 10 EM iterations), naive Bayes and
# logistic regression at 8192 rows (dense 8192 x 1024 counts and features;
# sparse rows of 64 entries over 65 536 terms, 20 classes), the in-core KRR
# and its prediction at bench.py's kernel leg (8192 x 256, k = 8, blocks of
# 512, 2 epochs; 512 test rows) and one cached degree-2 KRR there, a
# sharded save, and ImageNetSiftLcsFV.run at the fit leg (two ranks: 1024
# training images each).  Two ranks against one: the k-means++ seeds bit
# for bit; each fit f32-grade (within S9_F32_GRADE times the one-rank fit's
# distance from a float64 computation of the same data made in the parent,
# plus S9_F64_FLOOR; the EM from the k-means++ seeds at the tests' own
# tolerances, S9_EM_ATOL, against one rank and float64); the logistic
# fits, whose L-BFGS paths may part near the optimum, at S9_LR_WEIGHTS of the largest weight with objectives
# within S9_LR_OBJECTIVE (the text phases' bounds); the run's held-out
# top-1 against the one-process run's (graph phase) on FIT_TOP1_AGREEMENT
# of the images, its error at most FIT_TOP1_ERROR_MAX
S9_GMM_N, S9_GMM_D, S9_GMM_K, S9_GMM_ITERS = FIT_N * 64, PCA_DIMS, FIT_GMM_K, 10
S9_TEXT_N, S9_TEXT_D, S9_TEXT_NNZ, S9_TEXT_K, S9_DENSE_D = 8192, 65536, 64, 20, 1024
S9_LR_ITERS, S9_LR_LAM = 20, 1e-3
S9_F64_FLOOR = 1e-6
S9_EM_ATOL = (2e-5, 2e-4, 2e-4)  # the EM's weights, means, variances (tests/test_torch_fit.py)
S9_LR_WEIGHTS, S9_LR_OBJECTIVE = 2e-2, 1e-4
S9_STATE_D = 1024  # the sharded save: NormalizeRows of the fit's first 1024 feature columns
# the sparse fits sum by index_add_, whose atomics add in no fixed order
# on the card (ROADMAP §C "Not faults"): two fits with no group differ in
# the last bits as well, so the world of one is held to the fit with no
# group within S9_SCATTER_MARGIN times the spread of two fits with no group
# (both relative to the largest value), plus S9_SCATTER_FLOOR, a few f32
# ulps, for a run whose two fits happen to add alike; logistic
# regression's objectives besides, within S9_SCATTER_OBJECTIVE relative
S9_SCATTERED = ("nb_sparse", "logistic_sparse")
S9_SCATTER_MARGIN, S9_SCATTER_FLOOR, S9_SCATTER_OBJECTIVE = 10.0, 1e-6, 1e-6


def s9_problem(seed: int):
    """The fit's features (S9_N, S9_D) and ±1 labels (S9_N, S9_K), host f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S9_N, S9_D), dtype=np.float32)
    lab = rng.integers(0, S9_K, S9_N)
    y = -np.ones((S9_N, S9_K), np.float32)
    y[np.arange(S9_N), lab] = 1.0
    return x, y


def s9_estimators():
    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
    from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator

    return (BlockLeastSquaresEstimator(block_size=S9_BLOCK, num_iter=S9_EPOCHS, lam=S9_LAM),
            BlockWeightedLeastSquaresEstimator(block_size=S9_BLOCK, num_iter=S9_EPOCHS, lam=S9_LAM,
                                               mixture_weight=S9_MIX))


def s9_flat(model) -> np.ndarray:
    """A block model's weights and intercept as one host array."""
    return torch.cat([model.flat_weights.reshape(-1), model.intercept.reshape(-1)]).cpu().numpy()


def s9_digest(w) -> str:
    return hashlib.sha256(np.ascontiguousarray(w).tobytes()).hexdigest()[:16]


def parallel_rank(spec: str) -> int:
    """One rank of an S9 leg (``--parallel-rank``): ``spec`` is JSON with
    the leg, world, rank, port, work directory and seed.  Prints one S9
    record; arrays go to ``<work>/<leg>_rank<r>.npz``."""
    import torch.distributed as dist

    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.parallel import collectives, multihost
    from keystone_tpu_torch.utils import precision

    a = json.loads(spec)
    leg, world, rank, work = a["leg"], a["world"], a["rank"], a["work"]
    precision.disable_tf32()
    multihost.initialize(f"127.0.0.1:{a['port']}", num_processes=world, process_id=rank,
                         backend=None if leg == "nccl" else "gloo", device=DEVICE, initialization_timeout=120)
    rec = {"leg": leg, "rank": rank, "backend": dist.get_backend(), "world": dist.get_world_size(),
           "ready_seconds": time.perf_counter() - T_START,
           "init_attempts": metrics.REGISTRY.counter_value("multihost.init_attempts")}
    arrays = {}
    try:
        x, y = s9_problem(a["seed"])
        if a.get("go"):  # started early: the start-up overlaps the leg before; the work waits for it
            deadline = time.monotonic() + S9_TIMEOUT
            while not os.path.exists(a["go"]):
                check(time.monotonic() < deadline, f"S9 {leg} rank {rank}: no go in {S9_TIMEOUT} s")
                time.sleep(0.05)
        rec["go_seconds"] = time.perf_counter() - T_START
        if leg == "nccl":
            s9_nccl_leg(x, y, work, rec, arrays, a["seed"])
        elif leg == "gloo":
            s9_gloo_leg(x, y, work, rank, rec, arrays, a["seed"])
        else:
            s9_resume_leg(x, y, work, rank, leg, rec, arrays)
        rec["collectives"] = dict(collectives.COUNTS)
        np.savez(os.path.join(work, f"{leg}_rank{rank}.npz"), **arrays)
        rec["leg_seconds"] = time.perf_counter() - T_START - rec["go_seconds"]
        print("S9 " + json.dumps(rec), flush=True)
        if leg == "gloo":  # then the kill, in the same processes: rank 1 exits mid-fit
            s9_resume_leg(x, y, work, rank, "crash", {}, {})
    finally:
        multihost.shutdown()
    return 0


def s9_gmm_sample(rng) -> np.ndarray:
    """The fit's GMM sample's shape (S9_GMM_N x S9_GMM_D) drawn around
    S9_GMM_K centres; S9's A8b data start with it."""
    centres = 2.0 * rng.standard_normal((S9_GMM_K, S9_GMM_D), dtype=np.float32)
    return centres[rng.integers(0, S9_GMM_K, S9_GMM_N)] + rng.standard_normal((S9_GMM_N, S9_GMM_D),
                                                                              dtype=np.float32)


def s9_a8b_problems(seed: int) -> dict:
    """The A8b fits' host data, the same on every rank (numpy, ``seed``)."""
    rng = np.random.default_rng(seed + 20)
    gmm = s9_gmm_sample(rng)
    counts = (rng.random((S9_TEXT_N, S9_DENSE_D)) < 0.05) * rng.integers(1, 5, (S9_TEXT_N, S9_DENSE_D))
    w_true = rng.standard_normal((S9_DENSE_D, S9_TEXT_K)).astype(np.float32)
    feats = rng.standard_normal((S9_TEXT_N, S9_DENSE_D), dtype=np.float32) / np.sqrt(S9_DENSE_D)
    idx = np.stack([rng.choice(S9_TEXT_D, S9_TEXT_NNZ, replace=False) for _ in range(S9_TEXT_N)])
    vals = rng.random((S9_TEXT_N, S9_TEXT_NNZ)).astype(np.float32)
    krr_x = rng.standard_normal((KRR_N, KRR_D), dtype=np.float32)
    krr_w = rng.standard_normal((KRR_D, KRR_K), dtype=np.float32) / np.sqrt(KRR_D)
    return {"gmm": gmm, "counts": counts.astype(np.float32), "feats": feats,
            "feat_labels": np.argmax(feats @ w_true, 1).astype(np.int64), "idx": idx, "vals": vals,
            "text_labels": rng.integers(0, S9_TEXT_K, S9_TEXT_N), "krr_x": krr_x,
            "krr_y": np.tanh(krr_x @ krr_w).astype(np.float32),
            "krr_test": rng.standard_normal((KRR_TEST, KRR_D), dtype=np.float32)}


def s9_sparse_rows(p, sl):
    import scipy.sparse as sparse

    r = range(S9_TEXT_N)[sl]
    return [sparse.csr_matrix((p["vals"][i], (np.zeros(S9_TEXT_NNZ), p["idx"][i])), shape=(1, S9_TEXT_D)) for i in r]


def s9_a8b_fits(p, seed, rec, arrays, bitwise: bool) -> None:
    """The A8b fits on this rank's slice (every row at a world of one),
    each timed, its collectives and kernel launches counted; with
    ``bitwise``, each again on the local mesh (no group), held bit for
    bit."""
    from keystone_tpu_torch.models import gmm as G
    from keystone_tpu_torch.models import kernel_ridge as KR
    from keystone_tpu_torch.models import kmeans as KM
    from keystone_tpu_torch.models.logistic import LogisticRegressionEstimator
    from keystone_tpu_torch.models.naive_bayes import NaiveBayesEstimator
    from keystone_tpu_torch.ops import gram_kernels as gk
    from keystone_tpu_torch.parallel import collectives, mesh, multihost

    dev = torch.device(DEVICE)

    def rows(a, n=None):
        n = len(a) if n is None else n
        return multihost.make_global_dataset(a[multihost.process_batch_slice(n)], n, device=dev)

    def flat(*ts):
        return np.concatenate([t.detach().cpu().numpy().ravel() for t in ts])

    x = rows(p["gmm"])
    row_ok = mesh.local_rows_mask(x.array.shape[0], x.local_n, dev)
    text = multihost.make_global_dataset(s9_sparse_rows(p, multihost.process_batch_slice(S9_TEXT_N)), S9_TEXT_N,
                                         device=dev)
    fits = {
        "kmeans_seeds": lambda: KM._kmeans_seed(x.array, row_ok, S9_GMM_K, KM.generator(seed, dev),
                                                span=(x.rank_offset, x.local_n, x.n)),
        "gmm": lambda: flat(*G.GaussianMixtureModelEstimator(S9_GMM_K, max_iterations=S9_GMM_ITERS,
                                                             seed=seed).fit_dataset(x).buffers()),
        "nb_dense": lambda: flat(*NaiveBayesEstimator(S9_TEXT_K).fit_dataset(
            rows(p["counts"]), rows(p["text_labels"])).buffers()),
        "nb_sparse": lambda: flat(*NaiveBayesEstimator(S9_TEXT_K).fit_dataset(text, rows(p["text_labels"])).buffers()),
        "logistic_dense": lambda: flat(LogisticRegressionEstimator(
            S9_TEXT_K, lam=S9_LR_LAM, num_iters=S9_LR_ITERS).fit_dataset(rows(p["feats"]),
                                                                          rows(p["feat_labels"])).weights),
        "logistic_sparse": lambda: flat(LogisticRegressionEstimator(
            S9_TEXT_K, lam=S9_LR_LAM, num_iters=S9_LR_ITERS).fit_dataset(text, rows(p["text_labels"])).weights),
    }
    krr = {}

    def krr_fit(key, gen, cached):
        est = KR.KernelRidgeRegressionEstimator(gen, lam=KRR_LAM, block_size=KRR_BLOCK, num_epochs=KRR_EPOCHS,
                                                cache_kernel_blocks=cached)
        xd = rows(p["krr_x"])
        m = est.fit_dataset(xd, rows(p["krr_y"]))
        krr[key] = m
        return flat(m.alpha[:xd.local_n])

    fits["krr"] = lambda: krr_fit("krr", KR.GaussianKernelGenerator(KRR_GAMMA), False)
    fits["krr_predict"] = lambda: flat(krr["krr"](torch.from_numpy(p["krr_test"]).to(dev)))
    fits["krr_cached_poly"] = lambda: krr_fit("poly", KR.PolynomialKernelGenerator(2, 1.0 / KRR_D, 1.0), True)
    rec["a8b"] = {}
    for key, fn in fits.items():
        collectives.reset_counts()
        gk.reset_launches()
        out, secs = s9_timed(fn)
        if key == "kmeans_seeds":
            seeds = out
            out = flat(out)
        arrays[key] = out
        rec["a8b"][key] = {"seconds": secs, "collectives": dict(collectives.COUNTS),
                           "gram_launches": dict(gk.LAUNCHES)}
        if key == "kmeans_seeds":  # the EM from these seeds, held against float64 in the parent
            collectives.reset_counts()
            em, secs = s9_timed(lambda: flat(*G._gmm_fit(
                x.array, x.n, None, S9_GMM_K, S9_GMM_ITERS, 1e-6, seed, 0, init_means=seeds,
                span=(x.rank_offset, x.local_n, x.n))))
            arrays["gmm_em"] = em
            rec["a8b"]["gmm_em"] = {"seconds": secs, "collectives": dict(collectives.COUNTS), "gram_launches": {}}
        if bitwise:
            with mesh.use_mesh(mesh.local_mesh()):
                alone = fn() if key != "krr_predict" else flat(krr["krr"](torch.from_numpy(p["krr_test"]).to(dev)))
                alone = flat(alone) if key == "kmeans_seeds" else alone
                if key in S9_SCATTERED:  # the scatter-add's atomics: two fits with no group differ too
                    again = fn()
                    rec["a8b"][key]["alone_twice_bitwise"] = bool(np.array_equal(alone, again))
                    rec["a8b"][key]["alone_twice_rel"] = float(np.abs(alone - again).max()
                                                               / max(np.abs(alone).max(), 1e-30))
                    arrays[f"{key}_alone"] = alone
            rec["a8b"][key]["bitwise"] = bool(np.array_equal(alone, out))
            rec["a8b"][key]["vs_alone_rel"] = float(np.abs(alone - out).max() / max(np.abs(alone).max(), 1e-30))


def s9_run_leg(x, rec, arrays, work) -> None:
    """ImageNetSiftLcsFV.run at the fit leg as a job of these ranks, its
    B1/B2 launches on this rank counted; then a sharded save of a named
    rank slice's prefix."""
    from keystone_tpu_torch.ops import fisher_kernels as fk
    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.parallel import multihost
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P
    from keystone_tpu_torch.workflow import state
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.models.gmm import GaussianMixtureModelEstimator
    from keystone_tpu_torch.models.pca import PCAEstimator

    dev = torch.device(DEVICE)
    fk.reset_launches()
    detail = {}
    # the seconds of the fit's estimators, each ended by a synchronize
    spent = {"pca": 0.0, "gmm": 0.0, "solver": 0.0}
    fits = {"pca": PCAEstimator, "gmm": GaussianMixtureModelEstimator, "solver": BlockWeightedLeastSquaresEstimator}
    originals = {k: c.fit_dataset for k, c in fits.items()}

    def timed(key):
        def fit_dataset(*a, **kw):
            t0 = time.perf_counter()
            out = originals[key](*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return fit_dataset

    try:
        for k, c in fits.items():
            c.fit_dataset = timed(k)
        with fit_timer() as ft:
            res, secs = s9_timed(lambda: P.ImageNetSiftLcsFV.run(fit_setup_config(P), dev, out=detail))
    finally:
        for k, c in fits.items():
            c.fit_dataset = originals[k]
    rec["run"] = {"seconds": secs, "fit_seconds": res["fit_seconds"], "pipeline_fit_seconds": ft["fit"],
                  "estimator_seconds": spent, "top1_error": res["top1_error"], "top5_error": res["top5_error"],
                  "launches": dict(fk.LAUNCHES)}
    arrays["run_predictions"] = np.asarray(detail["predictions"])
    sl = multihost.process_batch_slice(S9_N)
    d = multihost.make_global_dataset(x[sl, :S9_STATE_D], S9_N, device=dev, name="s9-state")
    rec["state_saved"] = state.save_pipeline_state(Pipeline.of(NormalizeRows())(d), os.path.join(work, "state"))


def s9_timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def s9_nccl_leg(x, y, work, rec, arrays, seed) -> None:
    """A world of one over NCCL: the two fits bit for bit with no group
    (an all-reduce of one rank is the identity), their all-reduces counted
    and traced as NCCL kernels, and DistributedPCAEstimator."""
    from torch.profiler import ProfilerActivity, profile

    from keystone_tpu_torch.models.pca import DistributedPCAEstimator, PCAEstimator
    from keystone_tpu_torch.parallel import collectives, mesh
    from keystone_tpu_torch.workflow.dataset import Dataset

    dev = torch.device(DEVICE)
    xd, yd = Dataset(torch.from_numpy(x).to(dev)), Dataset(torch.from_numpy(y).to(dev))
    est, west = s9_estimators()
    collectives.reset_counts()
    grp, rec["fit_seconds"] = s9_timed(lambda: est.fit_checkpointed(xd, yd, os.path.join(work, "nccl_group")))
    rec["fit_all_reduces"] = collectives.COUNTS["all_reduce"]
    wgrp = west.fit_dataset(xd, yd)
    with mesh.use_mesh(mesh.local_mesh()):
        alone = est.fit_checkpointed(xd, yd, os.path.join(work, "nccl_alone"))
        walone = west.fit_dataset(xd, yd)
    rec["bitwise"] = {"bcd": bool(torch.equal(grp.weights, alone.weights) and torch.equal(grp.intercept,
                                                                                            alone.intercept)),
                      "weighted": bool(torch.equal(wgrp.weights, walone.weights)
                                       and torch.equal(wgrp.intercept, walone.intercept))}
    arrays["bcd"], arrays["weighted"] = s9_flat(grp), s9_flat(wgrp)
    # the fit again, warm (the first call also made the NCCL communicator
    # and the cuBLAS/cuSOLVER handles), under the profiler
    _, rec["warm_fit_seconds"] = s9_timed(lambda: est.fit_checkpointed(xd, yd, os.path.join(work, "nccl_warm")))
    before = collectives.COUNTS["all_reduce"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        est.fit_dataset(xd, yd)
        torch.cuda.synchronize()
    rec["profiled_all_reduces"] = collectives.COUNTS["all_reduce"] - before
    from torch.autograd import DeviceType

    events = prof.key_averages()
    rec["nccl_ops"] = {e.key: e.count for e in events if "nccl" in e.key.lower() and e.device_type != DeviceType.CUDA}
    rec["nccl_device_kernels"] = {e.key: e.count for e in events
                                  if "nccl" in e.key.lower() and e.device_type == DeviceType.CUDA}
    rec["device_kernels_traced"] = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
    del xd, yd
    # DistributedPCAEstimator at the fit's PCA shape
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    q, _ = torch.linalg.qr(torch.randn(S9_PCA_N, S9_PCA_D, generator=g, device=dev))
    v, _ = torch.linalg.qr(torch.randn(S9_PCA_D, S9_PCA_D, generator=g, device=dev))
    top = S9_PCA_K
    sv = torch.cat([torch.linspace(1.0, 0.5, top, device=dev), torch.linspace(0.05, 0.01, S9_PCA_D - top, device=dev)])
    sample = (q * (sv * S9_PCA_N ** 0.5)) @ v.T + 2.0 * torch.randn(S9_PCA_D, generator=g, device=dev)
    del q
    before = collectives.COUNTS["all_reduce"]
    dist_pca, rec["pca_seconds"] = s9_timed(lambda: DistributedPCAEstimator(S9_PCA_K).fit_dataset(Dataset(sample)))
    rec["pca_all_reduces"] = collectives.COUNTS["all_reduce"] - before
    svd_pca, rec["svd_pca_seconds"] = s9_timed(lambda: PCAEstimator(S9_PCA_K).fit_dataset(Dataset(sample)))
    s64 = sample.double()
    c64 = s64 - s64.mean(dim=0)
    _, ev = torch.linalg.eigh(c64.T @ c64 / S9_PCA_N)
    p64 = ev[:, -top:] @ ev[:, -top:].T
    pd = dist_pca.components.double() @ dist_pca.components.double().T
    ps = svd_pca.components.double() @ svd_pca.components.double().T
    rec["pca_projector"] = {"distributed_vs_svd": float((pd - ps).abs().max()),
                            "distributed_vs_f64": float((pd - p64).abs().max()),
                            "svd_vs_f64": float((ps - p64).abs().max())}
    del sample, s64, c64
    s9_a8b_fits(s9_a8b_problems(seed), seed, rec, arrays, bitwise=True)


def s9_gloo_leg(x, y, work, rank, rec, arrays, seed) -> None:
    """Two ranks over Gloo on CUDA tensors, each its 1024 rows: the
    checkpointed BCD (the kill test's control), the weighted BCD, the
    weighted fit_store over a store of this rank's 512 rows, the A8b fits
    and ImageNetSiftLcsFV.run on this rank's slices, a sharded save, the
    sick barrier."""
    from keystone_tpu_torch.parallel import SickHostError, health_barrier, multihost
    from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore

    dev = torch.device(DEVICE)
    est, west = s9_estimators()
    sl = multihost.process_batch_slice(S9_N)
    xd = multihost.make_global_dataset(x[sl], S9_N, device=dev)
    yd = multihost.make_global_dataset(y[sl], S9_N, device=dev)
    rec["rows"] = len(range(S9_N)[sl])
    bcd, rec["fit_seconds"] = s9_timed(lambda: est.fit_checkpointed(xd, yd, os.path.join(work, "control")))
    _, rec["warm_fit_seconds"] = s9_timed(lambda: est.fit_checkpointed(xd, yd, os.path.join(work, f"warm{rank}")))
    wbcd, rec["weighted_seconds"] = s9_timed(lambda: west.fit_dataset(xd, yd))
    arrays["bcd"], arrays["weighted"] = s9_flat(bcd), s9_flat(wbcd)
    rec["digest"] = s9_digest(arrays["bcd"])
    del xd, yd
    ss = multihost.process_batch_slice(S9_STORE_N)
    store = FeatureBlockStore.from_array(os.path.join(work, f"store{rank}"), x[:S9_STORE_N][ss], S9_BLOCK)
    labels = multihost.make_global_dataset(y[:S9_STORE_N][ss], S9_STORE_N, device=dev)
    oc, rec["store_seconds"] = s9_timed(lambda: west.fit_store(store, labels))
    rec["store_rows"] = store.n
    arrays["store"] = s9_flat(oc)
    arrays["in_memory"] = s9_flat(west.fit_arrays(x[:S9_STORE_N], y[:S9_STORE_N], device=dev))
    rec["store_vs_in_memory"] = float(np.abs(arrays["store"] - arrays["in_memory"]).max())
    s9_a8b_fits(s9_a8b_problems(seed), seed, rec, arrays, bitwise=False)
    s9_run_leg(x, rec, arrays, work)
    try:
        health_barrier(ok=rank != 1, timeout=60.0, tag="s9")
        rec["sick_raised"] = False
    except SickHostError as e:
        rec["sick_raised"] = "[1]" in str(e)


def s9_resume_leg(x, y, work, rank, leg, rec, arrays) -> None:
    """``crash`` (after the Gloo leg, in its processes): rank 1 exits
    before its second epoch, between the collectives of a checkpointed
    fit; ``resume``: both relaunched on the same directory resume from
    rank 0's checkpoint."""
    import keystone_tpu_torch.models.block_ls as bls
    from keystone_tpu_torch.parallel import multihost

    dev = torch.device(DEVICE)
    ckpt = os.path.join(work, "ckpt")
    if leg == "crash" and rank == 1:
        orig = bls._bcd_epoch_body

        calls = {"n": 0}

        def epoch_body(*args, **kw):
            calls["n"] += 1
            if calls["n"] > 1:
                sys.stdout.flush()
                os._exit(S9_CRASH_EXIT)
            return orig(*args, **kw)

        bls._bcd_epoch_body = epoch_body
    if leg == "resume":  # the epoch it resumes at: the one after rank 0's last saved
        with np.load(os.path.join(ckpt, "bcd_epoch.npz")) as z:
            rec["resumes_at_epoch"] = int(z["epoch"]) + 1
    sl = multihost.process_batch_slice(S9_N)
    est, _ = s9_estimators()
    model, rec["fit_seconds"] = s9_timed(lambda: est.fit_checkpointed(
        multihost.make_global_dataset(x[sl], S9_N, device=dev), multihost.make_global_dataset(y[sl], S9_N, device=dev),
        ckpt))
    arrays["bcd"] = s9_flat(model)
    rec["digest"] = s9_digest(arrays["bcd"])


def s9_a8b_checks(dev, card, seed, tmp, r1, r2, one_process_predictions):
    """The A8b fits of the legs: bit for bit at the world of one, the
    seeds equal across worlds, each two-rank fit against the one-rank fit
    and float64 (computed here), the collectives and launches on each
    rank, the two-rank run against the one-process run, the sharded save
    loaded at another world size."""
    from keystone_tpu_torch.models import gmm as G
    from keystone_tpu_torch.models import kernel_ridge as KR
    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.parallel import mesh
    from keystone_tpu_torch.workflow import state

    out = {}
    one = dict(np.load(tmp / "nccl_rank0.npz"))
    twos = [dict(np.load(tmp / f"gloo_rank{r}.npz")) for r in range(2)]
    with phase("S9: the A8b fits, one rank (NCCL) bit for bit with no group, two (Gloo) against one and float64"):
        a1 = r1["a8b"]
        for key, v in a1.items():
            print(f"  one rank {key}: {v['seconds']:.4f} s, bit for bit with no group {v.get('bitwise')} "
                  f"({v.get('vs_alone_rel', 0.0):.3e} of the largest apart; two fits with no group bit for bit "
                  f"{v.get('alone_twice_bitwise', '-')}), collectives {v['collectives']}, gram launches "
                  f"{v['gram_launches']} ({card})", flush=True)
        for r in r2:
            for key, v in r["a8b"].items():
                print(f"  rank {r['rank']} of two {key}: {v['seconds']:.4f} s, collectives {v['collectives']}, "
                      f"gram launches {v['gram_launches']} ({card})", flush=True)
        check(all(v["bitwise"] for k, v in a1.items() if "bitwise" in v and k not in S9_SCATTERED),
              f"the world of one is not the A8b fits with no group bit for bit: "
              f"{ {k: v.get('bitwise') for k, v in a1.items()} }")
        scatter = {k: (a1[k]["vs_alone_rel"], S9_SCATTER_MARGIN * a1[k]["alone_twice_rel"] + S9_SCATTER_FLOOR)
                   for k in S9_SCATTERED}
        print(f"  the sparse fits at the world of one against no group (apart, limit): {scatter} ({card})",
              flush=True)
        check(all(e <= lim for e, lim in scatter.values()),
              f"the sparse fits at the world of one against no group: {scatter}")
        check(all(np.array_equal(t["kmeans_seeds"], one["kmeans_seeds"]) for t in twos),
              "the two ranks' k-means++ seeds differ from the one rank's")
        nb = -(-KRR_N // KRR_BLOCK)
        for r in r2:
            c = {k: v["collectives"] for k, v in r["a8b"].items()}
            check(c["kmeans_seeds"]["argmax"] == S9_GMM_K and c["kmeans_seeds"]["all_reduce"] == S9_GMM_K,
                  f"k-means++ collectives {c['kmeans_seeds']}")
            check(c["gmm_em"]["all_reduce"] == 2 + S9_GMM_ITERS and c["gmm_em"]["all_gather"] == 0,
                  f"the EM's collectives {c['gmm_em']}")
            check(c["krr"]["all_reduce"] == KRR_EPOCHS * nb and c["krr"]["all_gather"] == 0,
                  f"the KRR sweep's collectives {c['krr']}")
            launches = {k: v["gram_launches"] for k, v in r["a8b"].items()}
            check(launches["krr"]["gram_block"] == 2 * KRR_EPOCHS * nb and launches["krr_predict"]["gram_block"] > 0
                  and launches["krr_cached_poly"]["poly_block"] == 2 * nb,
                  f"rank {r['rank']}'s gram launches {launches}")
        check(a1["krr"]["gram_launches"]["gram_block"] == KRR_EPOCHS * nb
              and a1["krr_cached_poly"]["gram_launches"]["poly_block"] > 0, f"one rank's gram launches")
        for key in one:
            # the KRR's: each rank's own α rows; the *_alone: the world of one's only
            if key in ("bcd", "weighted", "krr", "krr_cached_poly") or key.endswith("_alone"):
                continue
            check(all(np.array_equal(twos[0][key], t[key]) for t in twos), f"the two ranks' {key} differ")
        # float64 computations of the same data, here
        p = s9_a8b_problems(seed)
        x64 = torch.from_numpy(p["gmm"]).to(dev).double()
        seeds64 = torch.from_numpy(one["kmeans_seeds"].reshape(S9_GMM_K, S9_GMM_D)).to(dev).double()
        with mesh.use_mesh(mesh.local_mesh()):
            em64 = np.concatenate([a.cpu().numpy().ravel() for a in G._gmm_fit(
                x64, S9_GMM_N, None, S9_GMM_K, S9_GMM_ITERS, 1e-6, seed, 0, init_means=seeds64)])
            del x64
            kx = torch.from_numpy(p["krr_x"]).to(dev).double()
            ky = torch.from_numpy(p["krr_y"]).to(dev).double()
            # the plain grams in float64 (a generator the gram kernels do
            # not route: it is called as it is)
            a64 = KR._krr_fit_ranks(kx, ky, KRR_N, 0, lambda a, z: gram_f64(a, z, KRR_GAMMA), KRR_LAM,
                                    KRR_BLOCK, KRR_EPOCHS)
            pred64 = gram_f64(torch.from_numpy(p["krr_test"]).to(dev).double(), kx, KRR_GAMMA) @ a64
            poly64 = KR._krr_fit_ranks(kx, ky, KRR_N, 0, lambda a, z: poly_f64(a, z, 1.0 / KRR_D, 1.0, 2),
                                       KRR_LAM, KRR_BLOCK, KRR_EPOCHS)
        onehot = np.eye(S9_TEXT_K)[p["text_labels"]]
        cls = onehot.sum(0)
        feat = np.zeros((S9_TEXT_K, S9_TEXT_D))
        np.add.at(feat, (np.repeat(p["text_labels"], S9_TEXT_NNZ), p["idx"].ravel()), p["vals"].ravel())

        def nb64(class_counts, feat_counts):
            sm = feat_counts + 1.0
            return np.concatenate([(np.log(np.maximum(class_counts, 1e-10)) - np.log(S9_TEXT_N)).ravel(),
                                   (np.log(sm) - np.log(sm.sum(1, keepdims=True))).ravel()])

        ref64 = {"gmm_em": em64, "krr": a64.cpu().numpy().ravel(), "krr_predict": pred64.cpu().numpy().ravel(),
                 "krr_cached_poly": poly64.cpu().numpy().ravel(),
                 "nb_dense": nb64(cls, onehot.T @ p["counts"].astype(np.float64)), "nb_sparse": nb64(cls, feat)}
        del kx, ky, a64, poly64
        errs = {}
        # the EM from the same seeds as the tests hold it (tests/test_torch_fit.py,
        # the reference's tests/test_native.py:235-237): weights, means and
        # variances each at its own tolerance, two ranks against one rank and
        # both against float64
        k, kd = S9_GMM_K, S9_GMM_K * S9_GMM_D
        parts = ((slice(0, k), S9_EM_ATOL[0]), (slice(k, k + kd), S9_EM_ATOL[1]), (slice(k + kd, None), S9_EM_ATOL[2]))
        em = {"two_vs_one": [float(np.abs(t["gmm_em"][sl] - one["gmm_em"][sl]).max()) for t in twos[:1]
                             for sl, _ in parts],
              "one_vs_f64": [float(np.abs(one["gmm_em"][sl] - em64[sl]).max()) for sl, _ in parts],
              "two_vs_f64": [float(np.abs(twos[0]["gmm_em"][sl] - em64[sl]).max()) for sl, _ in parts]}
        errs["gmm_em"] = em
        print(f"  gmm_em (weights, means, variances): two ranks against one {em['two_vs_one']}, one rank against "
              f"float64 {em['one_vs_f64']}, two {em['two_vs_f64']} (limits {S9_EM_ATOL}) ({card})", flush=True)
        check(all(e <= tol for key in em for e, (_, tol) in zip(em[key], parts)), f"the EM: {em}")
        del ref64["gmm_em"]
        for key, r64 in ref64.items():
            e1 = float(np.abs(one[key] - r64).max())
            e2 = max(float(np.abs(t[key] - r64).max()) if t[key].size == r64.size else
                     float(np.abs(np.concatenate([twos[0][key], twos[1][key]]) - r64).max()) for t in twos)
            errs[key] = {"one_vs_f64": e1, "two_vs_f64": e2}
            print(f"  {key}: one rank {e1:.3e} from float64, two ranks {e2:.3e} (limit {S9_F32_GRADE:g}x + "
                  f"{S9_F64_FLOOR:g}) ({card})", flush=True)
            check(e2 <= S9_F32_GRADE * e1 + S9_F64_FLOOR, f"{key}: two ranks {e2:.3e} from float64, one {e1:.3e}")

        def lr_objective(w, dense):
            w = torch.from_numpy(w.reshape(-1, S9_TEXT_K)).to(dev).double()
            if dense:
                z, lab = torch.from_numpy(p["feats"]).to(dev).double() @ w, p["feat_labels"]
            else:
                z = (torch.from_numpy(p["vals"]).to(dev).double()[..., None]
                     * w[torch.from_numpy(p["idx"]).to(dev)]).sum(1)
                lab = p["text_labels"]
            ll = z[torch.arange(S9_TEXT_N), torch.from_numpy(lab).to(dev)] - torch.logsumexp(z, 1)
            return float(-ll.mean() + 0.5 * S9_LR_LAM * (w * w).sum())

        f_one, f_alone = lr_objective(one["logistic_sparse"], False), lr_objective(one["logistic_sparse_alone"], False)
        print(f"  logistic_sparse at the world of one: objective {f_one:.9f}, with no group {f_alone:.9f} "
              f"(limit {S9_SCATTER_OBJECTIVE:g} relative) ({card})", flush=True)
        check(abs(f_one - f_alone) <= S9_SCATTER_OBJECTIVE * abs(f_alone),
              f"logistic_sparse at the world of one: objective {f_one} against {f_alone} with no group")
        for key in ("logistic_dense", "logistic_sparse"):
            f1, f2 = lr_objective(one[key], key.endswith("dense")), lr_objective(twos[0][key], key.endswith("dense"))
            werr = float(np.abs(twos[0][key] - one[key]).max() / np.abs(one[key]).max())
            errs[key] = {"objective_one": f1, "objective_two": f2, "weights_rel": werr}
            print(f"  {key}: objective one rank {f1:.8f}, two {f2:.8f}; weights {werr:.3e} of the largest apart "
                  f"(limits {S9_LR_OBJECTIVE:g}, {S9_LR_WEIGHTS:g}) ({card})", flush=True)
            check(abs(f2 - f1) <= S9_LR_OBJECTIVE * abs(f1) and werr <= S9_LR_WEIGHTS, f"{key}: {errs[key]}")
        out["errors"] = errs
    with phase("S9: ImageNetSiftLcsFV.run at two ranks against the one-process run; the sharded save loaded "
               "at one rank and at two"):
        runs = [r["run"] for r in r2]
        agree = float((twos[0]["run_predictions"][:, 0] == one_process_predictions[:, 0]).mean())
        for r in r2:
            print(f"  rank {r['rank']}: run {r['run']['seconds']:.2f} s (fit_seconds {r['run']['fit_seconds']:.2f} s, "
                  f"the training images' making included; Pipeline.fit {r['run']['pipeline_fit_seconds']:.3f} s, of "
                  f"it the estimators {_rounded(r['run']['estimator_seconds'], 3)}), "
                  f"top-1 error {r['run']['top1_error']:.4f}, top-5 {r['run']['top5_error']:.4f}, launches "
                  f"{r['run']['launches']}; sharded prefixes saved {r['state_saved']} ({card})", flush=True)
        print(f"  top-1 agreement with the one-process run {agree:.5f} (at least {FIT_TOP1_AGREEMENT})", flush=True)
        check(np.array_equal(twos[0]["run_predictions"], twos[1]["run_predictions"]),
              "the two ranks' held-out predictions differ")
        check(agree >= FIT_TOP1_AGREEMENT, f"top-1 agreement {agree:.5f}")
        check(all(r["top1_error"] <= FIT_TOP1_ERROR_MAX for r in runs), f"two-rank run errors {runs}")
        check(all(r["launches"]["fused_forward"] > 0 and r["launches"]["fisher_encode"] > 0 for r in runs),
              f"B1/B2 launches on the ranks {[r['launches'] for r in runs]}")
        x, _ = s9_problem(seed)
        want = NormalizeRows().apply_batch(torch.from_numpy(np.ascontiguousarray(x[:, :S9_STATE_D])).to(dev))
        keys = sorted({f.split(".")[0] for f in os.listdir(tmp / "state") if ".d2." in f})
        check(len(keys) == 1 and all(r["state_saved"] == 1 for r in r2), f"sharded save {keys}")
        with mesh.use_mesh(mesh.local_mesh()):
            whole = state.load_prefix(str(tmp / "state"), keys[0], dev)
        e_whole = max_err(whole.array, want)
        e_part = 0.0
        for r in range(2):
            with mesh.use_mesh(mesh.Mesh(data=2, rank=r)):
                part = state.load_prefix(str(tmp / "state"), keys[0], dev)
            sl = mesh.slice_rows(S9_N, 2, r)
            e_part = max(e_part, max_err(part.array[:part.local_n], want[sl]))
        print(f"  the sharded save loaded at one rank: {tuple(whole.array.shape)}, {e_whole:.3e} from the rows "
              f"normalized here; at two: {e_part:.3e} ({card})", flush=True)
        check(whole.n == S9_N and e_whole <= 1e-6 and e_part <= 1e-6, "the sharded save's rows")
        out["run"] = {"ranks": runs, "top1_agreement": agree}
        out["launches"] = {
            "fused_forward": sum(r["launches"]["fused_forward"] for r in runs),
            "fisher_encode": sum(r["launches"]["fisher_encode"] for r in runs),
            "gram_block": sum(v["gram_launches"].get("gram_block", 0) for r in [r1, *r2] for v in r["a8b"].values()),
            "poly_block": sum(v["gram_launches"].get("poly_block", 0) for r in [r1, *r2] for v in r["a8b"].values())}
        out["by_rank"] = {f"{r['leg']} rank {r['rank']}": {
            "run": r.get("run", {}).get("launches"),
            "gram": {k: v["gram_launches"] for k, v in r["a8b"].items() if v["gram_launches"]}} for r in [r1, *r2]}
        out["seconds"] = {f"{r['leg']} rank {r['rank']}": {k: v["seconds"] for k, v in r["a8b"].items()}
                          for r in [r1, *r2]}
    return out


def s9_start(leg, world, work, seed, env_extra=None, go=None):
    """The leg's ranks as processes of this script, started; with ``go``
    (a path), each rank initializes its group and makes its data, then
    waits for the file before its work."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("KEYSTONE_FAULTS", "MASTER_ADDR", "WORLD_SIZE")}
    env.update(env_extra or {})
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--parallel-rank",
                               json.dumps({"leg": leg, "world": world, "rank": r, "port": port, "work": str(work),
                                           "seed": seed, "go": None if go is None else str(go)})],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(REPO))
             for r in range(world)]
    return {"leg": leg, "procs": procs, "t0": time.perf_counter()}


def s9_finish(started, expect_exit=None):
    """A started leg's S9 records, its seconds since its start and each
    rank's exit code.  Each rank has its own timeout; whatever is left is
    killed.  ``expect_exit``: the last rank is to exit with it, and the
    others' codes are not held (they fail, or are killed, once their peer
    is gone)."""
    leg, procs = started["leg"], started["procs"]
    world = len(procs)
    outs = [None] * world
    try:
        # a crash leg waits for the rank that exits first; its survivor,
        # parked in (or failing out of) a collective whose peer is gone,
        # is then killed after 30 s, as a scheduler would
        for i in (range(world) if expect_exit is None else reversed(range(world))):
            try:
                o, e = procs[i].communicate(timeout=S9_TIMEOUT if expect_exit is None or i else 30)
            except subprocess.TimeoutExpired:
                procs[i].kill()
                o, e = procs[i].communicate()
            outs[i] = (procs[i].returncode, o, e)
    finally:
        s9_kill(started)
    secs = time.perf_counter() - started["t0"]
    recs = [json.loads(ln[3:]) for _, o, _ in outs for ln in o.splitlines() if ln.startswith("S9 ")]
    for r, (rc, o, e) in enumerate(outs):
        if expect_exit is None or r == world - 1:
            want = 0 if expect_exit is None else expect_exit
            check(rc == want, f"S9 {leg} rank {r} exited {rc} (not {want}):\n{o[-2000:]}\n{e[-4000:]}")
    return recs, secs, [rc for rc, _, _ in outs]


def s9_kill(started) -> None:
    for p in started["procs"]:
        if p.poll() is None:
            p.kill()
            p.communicate()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_path(dev, card, seed, one_process_predictions):
    """S9's four legs, then the comparisons against float64 made here.
    ``one_process_predictions``: the graph phase's held-out top-5 of
    ImageNetSiftLcsFV.run at the fit leg, in this process."""
    from keystone_tpu_torch.parallel import mesh

    tmp = Path(tempfile.mkdtemp(prefix="parallel_", dir=REPO))
    out = {}
    t_s9 = time.perf_counter()
    # the three launches start together; the Gloo pair and the relaunched
    # pair make their groups and data, then wait for the leg before them
    # to end, so that no two legs' work shares the card
    go_gloo, go_resume = tmp / "go_gloo", tmp / "go_resume"
    legs = [s9_start("nccl", 1, tmp, seed), s9_start("gloo", 2, tmp, seed, {"KEYSTONE_FAULTS": S9_PLAN}, go_gloo),
            s9_start("resume", 2, tmp, seed, go=go_resume)]
    try:
        with phase("S9: one rank over NCCL: the fits bit for bit with no group, NCCL kernels, DistributedPCAEstimator"):
            (r1,), s1, _ = s9_finish(legs[0])
            go_gloo.touch()
            # NCCL's one-rank in-place all-reduce launches no device kernel:
            # the c10d ops are what the trace shows of it
            nccl_ops = sum(n for k, n in r1["nccl_ops"].items() if "all_reduce" in k.lower())
            print(f"  backend {r1['backend']}, world {r1['world']}, initialized {r1['ready_seconds']:.2f} s after the "
                  f"script loaded; fit_checkpointed {r1['fit_seconds']:.4f} s cold, {r1['warm_fit_seconds']:.4f} s "
                  f"warm, with {r1['fit_all_reduces']} all-reduces (1 for the means, 2 a block: "
                  f"{1 + 2 * S9_EPOCHS * (S9_D // S9_BLOCK)}); bit for bit with no group: {r1['bitwise']}; the "
                  f"profiled fit's {r1['profiled_all_reduces']} all-reduces: NCCL ops {r1['nccl_ops']}, NCCL device "
                  f"kernels {r1['nccl_device_kernels']} of {r1['device_kernels_traced']} kernels traced ({card})",
                  flush=True)
            check(r1["backend"] == "nccl" and r1["world"] == 1, f"leg 1 {r1['backend']} {r1['world']}")
            check(all(r1["bitwise"].values()), f"the world of one is not the fit with no group bit for bit: "
                                               f"{r1['bitwise']}")
            check(r1["fit_all_reduces"] == 1 + 2 * S9_EPOCHS * (S9_D // S9_BLOCK), f"all-reduces {r1['fit_all_reduces']}")
            check(nccl_ops == r1["profiled_all_reduces"] > 0, f"NCCL ops {r1['nccl_ops']}")
            pp = r1["pca_projector"]
            print(f"  DistributedPCAEstimator ({S9_PCA_N} x {S9_PCA_D} -> {S9_PCA_K}) {r1['pca_seconds']:.4f} s with "
                  f"{r1['pca_all_reduces']} all-reduces, PCAEstimator (SVD) {r1['svd_pca_seconds']:.4f} s; projector "
                  f"C·Cᵀ largest differences {pp} (tol {TOL_S9_PCA:g} against the SVD's) ({card})", flush=True)
            check(pp["distributed_vs_svd"] <= TOL_S9_PCA, f"DistributedPCAEstimator's projector {pp}")
            out["nccl"] = dict(r1, seconds=s1)
        with phase("S9: two ranks over Gloo on the card, 1024 rows each: the fits, a per-rank store, a sick rank, "
                   "then rank 1 killed before its second epoch"):
            r2, s2, rcs = s9_finish(legs[1], expect_exit=S9_CRASH_EXIT)
            go_resume.touch()
            for r in r2:
                print(f"  rank {r['rank']}: backend {r['backend']}, {r['init_attempts']:.0f} init attempts under "
                      f"{S9_PLAN!r}; {r['rows']} rows; fit_checkpointed {r['fit_seconds']:.4f} s cold, "
                      f"{r['warm_fit_seconds']:.4f} s warm, weighted "
                      f"{r['weighted_seconds']:.4f} s, fit_store over {r['store_rows']} rows {r['store_seconds']:.4f} s "
                      f"(against the in-memory fit of the {S9_STORE_N} rows {r['store_vs_in_memory']:.3e}, tol "
                      f"{TOL_S9_STORE:g}); "
                      f"collectives {r['collectives']}; sick barrier raised {r['sick_raised']} ({card})", flush=True)
            check(len(r2) == 2 and all(r["backend"] == "gloo" and r["init_attempts"] == 2 for r in r2),
                  f"leg 2 records {r2}")
            check(all(r["sick_raised"] for r in r2), "a sick rank did not abort both ranks")
            check(all(r["store_rows"] == S9_STORE_N // 2 for r in r2), "a rank's store holds other rows")
            check(all(r["store_vs_in_memory"] <= TOL_S9_STORE for r in r2), "fit_store against the in-memory fit")
            check(r2[0]["digest"] == r2[1]["digest"], "the two ranks' weights differ")
            print(f"  the kill: exit codes {rcs} (rank 1 exited before its second epoch; rank 0 failed in the "
                  f"collective it was left in, or was killed) ({card})", flush=True)
            out["gloo"] = {"records": r2, "seconds": s2, "exit_codes": rcs}
        with phase("S9: both ranks relaunched on the killed fit's checkpoint: the resume"):
            r4, s4, _ = s9_finish(legs[2])
            at = [r["resumes_at_epoch"] for r in r4]
            print(f"  RESUMED_FROM epoch {at}, digests {[r['digest'] for r in r4]} against the uninterrupted "
                  f"control's {r2[0]['digest']} in {s4:.2f} s ({card})", flush=True)
            check(len(r4) == 2 and all(e >= 1 for e in at), f"resume records {r4}")
            check(all(r["digest"] == r2[0]["digest"] for r in r4), "the resumed fit is not the control bit for bit")
            out["kill_resume"] = {"crash_exit_codes": rcs, "resume_seconds": s4, "resumed_at_epoch": at}
        with phase("S9: one rank against two, each against a float64 fit of the same data (made here)"):
            x, y = s9_problem(seed)
            one, two = (dict(np.load(tmp / f"{leg}_rank0.npz")) for leg in ("nccl", "gloo"))
            est, west = s9_estimators()
            with mesh.use_mesh(mesh.local_mesh()):
                x64, y64 = torch.from_numpy(x).to(dev).double(), torch.from_numpy(y).to(dev).double()
                ref = {"bcd": s9_flat(est._fit(x64, y64, S9_N)), "weighted": s9_flat(west._fit(x64, y64, S9_N))}
                ref["in_memory"] = s9_flat(west._fit(x64[:S9_STORE_N], y64[:S9_STORE_N], S9_STORE_N))
                del x64, y64
            errs = {}
            for key, a1, a2 in (("bcd", one["bcd"], two["bcd"]), ("weighted", one["weighted"], two["weighted"]),
                                ("store", two["in_memory"], two["store"])):
                r64 = ref["in_memory" if key == "store" else key]
                e1, e2 = float(np.abs(a1 - r64).max()), float(np.abs(a2 - r64).max())
                errs[key] = {"one_vs_f64": e1, "two_vs_f64": e2, "two_vs_one": float(np.abs(a2 - a1).max())}
                print(f"  {key}: {'the in-memory fit' if key == 'store' else 'one rank'} {e1:.3e} from float64, "
                      f"{'the two-rank fit_store' if key == 'store' else 'two ranks'} {e2:.3e} (limit "
                      f"{S9_F32_GRADE:g}x), {errs[key]['two_vs_one']:.3e} apart ({card})", flush=True)
                check(e2 <= S9_F32_GRADE * e1, f"{key}: two ranks {e2:.3e} from float64, one rank {e1:.3e}")
            out["errors"] = errs
        out["a8b"] = s9_a8b_checks(dev, card, seed, tmp, r1, r2, one_process_predictions)
        # each leg from its go to its last record (its start-up overlapped the leg before)
        secs = {"nccl": r1["leg_seconds"], "gloo": max(r["leg_seconds"] for r in r2),
                "resume": max(r["leg_seconds"] for r in r4)}
        out["seconds"] = dict(secs, all=time.perf_counter() - t_s9, launch_to_exit={"nccl": s1, "gloo_and_kill": s2,
                                                                                    "resume": s4})
        two_fit, two_warm = (max(r[k] for r in r2) for k in ("fit_seconds", "warm_fit_seconds"))
        print(f"  S9 legs' seconds from their go {_rounded(secs, 2)}, from their launch "
              f"{_rounded(out['seconds']['launch_to_exit'], 2)}; S9 {out['seconds']['all']:.1f} s; the checkpointed fit "
              f"{r1['fit_seconds']:.4f} s cold, {r1['warm_fit_seconds']:.4f} s warm at one rank (NCCL) against "
              f"{two_fit:.4f} s cold, {two_warm:.4f} s warm at two (Gloo on CUDA tensors, one card: no speed-up "
              f"is claimed) ({card})", flush=True)
        out["fit_seconds"] = {"one_rank_nccl": r1["fit_seconds"], "one_rank_nccl_warm": r1["warm_fit_seconds"],
                              "two_ranks_gloo": two_fit, "two_ranks_gloo_warm": two_warm}
    finally:
        for started in legs:
            s9_kill(started)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---- the host float64 reference (A12): ops/fisher_ffi.py over g++'s
# csrc/keystone_ffi.cpp, the port's copy of the reference's EncEval-tier
# encode and EM.  It runs on the host by design and is no TPU kernel: its
# figures go to the host_ref line, not the kernels line.  The encode takes
# HOST_REF_N images at B2's main-path shape (its host seconds grow with
# n·T·K·d); the EM HOST_EM_ITERS steps at HOST_EM_ROWS rows of S9's GMM
# sample, each against the port's chains on the card in float64 (the same
# arithmetic summed in another order: TOL_HOST_F64 of the largest value);
# the card's f32 EM's distance from it is printed beside (five steps of
# 16 384-row f32 sums through the gemm expansion: ~1e-3 on the means).
HOST_REF_N = 8
HOST_EM_ROWS, HOST_EM_ITERS = 16384, 5
TOL_HOST_F64 = 1e-9
# A17 on the card: DAISY and SIFT's conv windowing in f32 against the same
# chains in float64 (descriptors are L2-normalized histograms), and the
# conv form against the matmul form (the reference's own windowing bound,
# tests/test_ops.py:592)
TOL_LEFT_OUT_F64 = 1e-5
ATOL_WINDOWING = 1e-6


def host_ref_path(dev, card, fk, fx, fmask, gmm_b2, seed) -> dict:
    """A12 on this machine: the host float64 encode and EM against the
    card's chains (see the comment above)."""
    from keystone_tpu_torch.models.gmm import _em_steps
    from keystone_tpu_torch.ops import fisher_ffi

    out = {}
    with phase("host reference (A12): the float64 FV encode on the host against the card's chains"):
        t0 = time.perf_counter()
        check(fisher_ffi.ffi_available() and fisher_ffi.ffi_available("em"),
              "the host FV library (csrc/keystone_ffi.cpp) did not build")
        out["build_load_s"] = time.perf_counter() - t0
        xs, m = fx[:HOST_REF_N].contiguous(), fmask[:HOST_REF_N].contiguous()
        g64 = [a.double() for a in gmm_b2]
        t0 = time.perf_counter()
        host = fisher_ffi.fisher_encode_ffi(xs.double(), m.double(), *g64)
        out["encode_s"] = time.perf_counter() - t0
        check(host.dtype == torch.float64 and host.device.type == "cpu"
              and tuple(host.shape) == (HOST_REF_N, 2 * GMM_K * PCA_DIMS), f"host encode {host.dtype} {host.shape}")
        host = host.to(dev)
        plain64 = fv_f64(xs, m, *gmm_b2)
        scale = max(1.0, host.abs().max().item())
        e_host = max_err64(host, plain64)
        e_kernel = max_err64(fk.fisher_encode(xs, m, *gmm_b2), host)
        e_plain = max_err64(fk.fisher_encode_ref(xs, m, *gmm_b2), host)
        b2_ms = cuda_ms(lambda: fk.fisher_encode(xs, m, *gmm_b2))
        print(f"  ({HOST_REF_N}, 784, {PCA_DIMS}) K={GMM_K}: host float64 encode {out['encode_s']:.3f} s (build and "
              f"load {out['build_load_s']:.1f} s) against B2 {b2_ms:.4f} ms on the same images; host against the "
              f"plain chain in float64 on the card {e_host:.3e} (|ref| max {scale:.3e}, at most "
              f"{TOL_HOST_F64:.0e} of it); against the host's float64: B2 {e_kernel:.3e}, the plain f32 chain "
              f"{e_plain:.3e} (ratio {e_kernel / e_plain:.3f}, at most {F64_RATIO}) ({card})", flush=True)
        check(e_host <= TOL_HOST_F64 * scale, f"host encode against the plain chain in float64: {e_host:.3e}")
        check(e_kernel <= F64_RATIO * e_plain, "B2 is not f32-grade against the host float64 encode")
        out["encode"] = {"shape": f"({HOST_REF_N}, 784, {PCA_DIMS}) K={GMM_K}", "host_s": out.pop("encode_s"),
                         "b2_ms": b2_ms, "host_vs_plain_f64": e_host, "ref_abs_max": scale,
                         "b2_vs_host": e_kernel, "plain_f32_vs_host": e_plain}

    with phase(f"host reference (A12): {HOST_EM_ITERS} EM steps at {HOST_EM_ROWS} rows of the GMM sample against "
               "the card's EM"):
        rng = np.random.default_rng(seed + 20)
        x = torch.from_numpy(s9_gmm_sample(rng)[:HOST_EM_ROWS])
        k = FIT_GMM_K
        mu0 = x[np.random.default_rng(seed + 21).choice(HOST_EM_ROWS, k, replace=False)]
        var0 = x.double().var(dim=0, unbiased=False).clamp(min=1e-6)[None, :].repeat(k, 1)
        w0, mask = torch.full((k,), 1.0 / k, dtype=torch.float64), torch.ones(HOST_EM_ROWS, dtype=torch.float64)
        t0 = time.perf_counter()
        host = fisher_ffi.gmm_em_ffi(x.double(), mask, w0, mu0.double(), var0, iters=HOST_EM_ITERS)
        em_s = time.perf_counter() - t0
        errs = {}
        for label, dt in (("float64", torch.float64), ("f32", torch.float32)):
            a = [t.to(device=dev, dtype=dt) for t in (x, mask, w0, mu0, var0)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card_em = _em_steps(a[0], float(HOST_EM_ROWS), a[1], a[2], a[3], a[4], HOST_EM_ITERS, 1e-6)
            torch.cuda.synchronize()
            errs[label] = {"seconds": time.perf_counter() - t0,
                           "errors": [max_err64(c, h.to(dev)) for c, h in zip(card_em, host)]}
        print(f"  host float64 EM {em_s:.3f} s; the card's EM in float64 {errs['float64']['seconds']:.3f} s, "
              f"largest differences (weights, means, variances) {[f'{e:.3e}' for e in errs['float64']['errors']]}; "
              f"in f32 {errs['f32']['seconds']:.3f} s, {[f'{e:.3e}' for e in errs['f32']['errors']]} (f32's "
              f"distance from float64, not gated) ({card})",
              flush=True)
        check(max(errs["float64"]["errors"]) <= TOL_HOST_F64, f"the card's float64 EM {errs['float64']}")
        check(abs(float(host[0].sum()) - 1.0) < 1e-12, "the host EM's weights do not sum to 1")
        out["em"] = {"rows": HOST_EM_ROWS, "d": PCA_DIMS, "k": k, "iters": HOST_EM_ITERS, "host_s": em_s,
                     "card": errs}
    return out


def left_out_ops_path(dev, card, images) -> dict:
    """A17 on the card: DAISY and SIFT's conv windowing at bench.py's batch
    and image size, each against its chain in float64, the conv form
    against the matmul form, each timed."""
    from keystone_tpu_torch.ops import daisy as daisy_mod
    from keystone_tpu_torch.ops import sift as sift_mod
    from keystone_tpu_torch.ops.images import GrayScaler

    out = {}
    gray = GrayScaler().apply_batch(images[:BATCH].float() / 255.0)
    with phase(f"left-out ops (A17): DAISY and SIFT's conv windowing on the card ({BATCH}, {IMAGE_HW}, {IMAGE_HW})"):
        ext = daisy_mod.DaisyExtractor()
        d32 = ext.apply_batch(gray)[0]
        d64 = daisy_mod._daisy(gray.double(), ext.step, ext.radius, ext.rings, ext.ring_points, ext.orientations)
        check(tuple(d32.shape) == tuple(d64.shape) and d32.shape[1] > 0 and d32.shape[2] == ext.descriptor_dim,
              f"DAISY {tuple(d32.shape)}")
        check(bool(torch.isfinite(d32).all()), "non-finite DAISY descriptors")
        e_daisy = max_err64(d32, d64)
        sigma = sift_mod.SIFTExtractor(SIFT_STEP, (SIFT_BIN,))._sigma(SIFT_BIN)
        sift = {w: sift_mod._dsift(gray, SIFT_STEP, SIFT_BIN, sigma=sigma, windowing=w) for w in ("conv", "matmul")}
        sift64 = {w: sift_mod._dsift(gray.double(), SIFT_STEP, SIFT_BIN, sigma=sigma, windowing=w)
                  for w in ("conv", "matmul")}
        check(tuple(sift["conv"].shape) == (BATCH, 784, 128), f"SIFT conv {tuple(sift['conv'].shape)}")
        e = {w: max_err64(sift[w], sift64[w]) for w in sift}
        e_forms, e_forms64 = max_err(sift["conv"], sift["matmul"]), max_err64(sift64["conv"], sift64["matmul"])
        ms = {"daisy": cuda_ms(lambda: ext.apply_batch(gray), reps=5)}
        for w in ("conv", "matmul"):
            ext_w = sift_mod.SIFTExtractor(SIFT_STEP, (SIFT_BIN,), windowing=w)
            ms[f"sift_{w}"] = cuda_ms(lambda ext_w=ext_w: ext_w.apply_batch(gray), reps=5)
        print(f"  DAISY {tuple(d32.shape)}: {ms['daisy']:.3f} ms a batch, against float64 {e_daisy:.3e}; SIFT "
              f"(step {SIFT_STEP}, bin {SIFT_BIN}, σ {sigma:.3f}) conv {ms['sift_conv']:.3f} ms, matmul "
              f"{ms['sift_matmul']:.3f} ms a batch; against float64 conv {e['conv']:.3e}, matmul {e['matmul']:.3e} "
              f"(at most {TOL_LEFT_OUT_F64:.0e}); conv against matmul {e_forms:.3e} (at most {ATOL_WINDOWING:.0e}), "
              f"in float64 {e_forms64:.3e} ({card})", flush=True)
        check(e_daisy <= TOL_LEFT_OUT_F64, f"DAISY against float64: {e_daisy:.3e}")
        check(max(e.values()) <= TOL_LEFT_OUT_F64, f"SIFT against float64: {e}")
        check(e_forms <= ATOL_WINDOWING, f"SIFT conv against matmul: {e_forms:.3e}")
        out = {"daisy_shape": list(d32.shape), "ms": ms, "daisy_vs_f64": e_daisy, "sift_vs_f64": e,
               "sift_conv_vs_matmul": e_forms, "sift_conv_vs_matmul_f64": e_forms64}
    return out


# ---- S10, serve_bench's modes (A9c) at the tool's defaults, one round
# and S10_LEG_S legs, on its synthetic workloads on the card: the gates are
# the answers (bit for bit where the reference pins it, nothing lost or
# hung, no artifact fallback); the reference's speed claims (the recorder
# within 5%, hedging's p99 under 1, processes 1.8x threads, the scale-up)
# are measured and printed with their `ok`, not gated: they are the
# host's, and a card's machine shares its cores.  The autoscale
# scenario's idle wait is S10_IDLE_S (the reference's default 60 s).
S10_LEG_S = 1.0
S10_ROUNDS = 1
S10_IDLE_S = 30.0
S10_SCENARIO = "bursty"


def serve_bench_path(dev, card) -> dict:
    """S10 (see the comment above)."""
    from keystone_tpu_torch.tools import serve_bench as sb

    out = {}
    t_s10 = time.perf_counter()
    with phase("serve S10: serve_bench's flight recorder on against off"):
        rep = sb.run_overhead_pair(duration=S10_LEG_S, rounds=S10_ROUNDS, device=dev)
        on, off = rep["recorder_on"], rep["recorder_off"]
        check(bool(on["achieved_qps"]) and bool(off["achieved_qps"]), f"the recorder pair served nothing: {rep}")
        print(f"  achieved QPS on {on['achieved_qps']:.1f} / off {off['achieved_qps']:.1f}, p99 on {on['p99_ms']:.3f} "
              f"/ off {off['p99_ms']:.3f} ms: ratios {rep['overhead']} (the reference's budget: within 5% of 1) "
              f"({card})", flush=True)
        out["recorder"] = rep
    with phase("serve S10: hedged dispatch against one stalled replica"):
        rep = sb.run_straggler_ab(duration=S10_LEG_S, rounds=S10_ROUNDS, device=dev)
        check(rep["hedged"]["hedges"] > 0 and rep["hedged"]["achieved_qps"] and rep["unhedged"]["achieved_qps"],
              f"the hedging A/B hedged nothing: {rep['hedged']}")
        print(f"  p99 hedged {rep['hedged']['p99_ms']:.3f} against unhedged {rep['unhedged']['p99_ms']:.3f} ms "
              f"(straggler {rep['straggler_ms']} ms, hedge {rep['hedge_ms']} ms): {rep['hedging']}; "
              f"{rep['hedged']['hedges']} hedges, {rep['hedged']['hedge_wins']} won ({card})", flush=True)
        out["straggler"] = rep
    with phase("serve S10: threads against processes on the GIL-held featurizer"):
        rep = sb.run_procs_ab(duration=S10_LEG_S, rounds=S10_ROUNDS, device=dev)
        check(rep["predictions_identical"], f"threads and processes answered differently: {rep['prediction_sha']}")
        print(f"  threads {rep['thread_qps']:.1f} against processes {rep['process_qps']:.1f} QPS: {rep['speedup']:.3f}x "
              f"(achievable {rep['achievable_speedup']} on {rep['cores']} cores; the reference's ok: {rep['ok']}); "
              f"p99 {rep['thread_p99_ms']:.3f} / {rep['process_p99_ms']:.3f} ms; bit for bit ({card})", flush=True)
        out["procs"] = rep
    with phase("serve S10: the autoscale scenario (one worker process up under load, back down idle)"):
        rep = sb.run_autoscale_scenario(duration=S10_LEG_S, idle_timeout=S10_IDLE_S, device=dev)
        check(rep["errors"] == 0 and rep["hung"] == 0 and rep["completed"] == rep["submitted"],
              f"the autoscale scenario lost requests: {rep}")
        check(rep["final_workers"] == 1, f"the fleet did not come back to one worker in {S10_IDLE_S} s: {rep}")
        print(f"  {rep['submitted']} requests, all answered; workers peak {rep['peak_workers']}, final "
              f"{rep['final_workers']}; ups {rep['autoscaler'].get('ups')}, downs {rep['autoscaler'].get('downs')} "
              f"(the reference's ok: {rep['ok']}) ({card})", flush=True)
        out["autoscale"] = rep
    with phase("serve S10: cold start and restart, bucket graphs against none, each sample a fresh process"):
        for key, fn in (("cold_start", sb.run_cold_start_ab), ("restart", sb.run_restart_ab)):
            rep = fn(rounds=S10_ROUNDS, device=dev)
            check(rep["predictions_match"] and rep["artifact_fallbacks"] == 0,
                  f"{key}: digests {[s['prediction_sha'] for a in rep['samples'].values() for s in a]}, "
                  f"fallbacks {rep['artifact_fallbacks']}")
            check(all(s["bundle"] for s in rep["samples"]["artifact"]), f"{key}: the artifact arm had no bundle")
            out[key] = rep
        cs, rs = out["cold_start"], out["restart"]
        check(cs["prime_sources"]["artifact"]["artifact"] > 0 and cs["prime_sources"]["compile"]["artifact"] == 0,
              f"cold start prime sources {cs['prime_sources']}")
        print(f"  first prediction: artifact {cs['first_prediction_s']['artifact']:.3f} s, none "
              f"{cs['first_prediction_s']['compile']:.3f} s ({cs['first_prediction_s'].get('speedup')}x); ready "
              f"{cs['ready_s']}; restart to rejoin {rs['restart_to_rejoin_s']}; prime sources {cs['prime_sources']}; "
              f"one prediction digest, no fallback ({card})", flush=True)
    with phase(f"serve S10: the zoo's {S10_SCENARIO} replay"):
        rep = sb.run_scenario(S10_SCENARIO, duration=S10_LEG_S, device=dev)
        check(rep["outcomes"]["errors"] == 0 and sum(rep["outcomes"].values()) == rep["submitted_rows"],
              f"the replay's outcomes {rep['outcomes']}")
        print(f"  digest {rep['scenario']['digest']}: {rep['outcomes']}, p50 {rep['p50_ms']:.3f} ms, p99 "
              f"{rep['p99_ms']:.3f} ms ({card})", flush=True)
        out["scenario"] = rep
    out["seconds"] = time.perf_counter() - t_s10
    print(f"  S10 took {out['seconds']:.1f} s ({card})", flush=True)
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


# ---- A9b: the read side and the helpers.  The roofline's FV stage is held
# to B2 timed here at its shape within the scorer's host-clock spread
# (PERF.md §2, ~10%): the stage is B2's one launch on the PCA's output.
ROOFLINE_FV_AGREE = 0.10
ROOFLINE_WALL_SLACK = 1.05
HOST_MAP_DOCS, HOST_MAP_WORKERS = 2048, 2
BENCH_TEXT_DOCS, BENCH_TEXT_PY_DOCS = 4096, 1024


def roofline_path(dev, card, fk) -> dict:
    """The bench forward's per-stage roofline (``tools/roofline_forward.py``)
    single-scale at batch 128 and multi-scale at batch 64: no stage over
    1.05 of its bound (the tool raises), the stages' device time within
    the wall marginal a batch, the FV stage agreeing with B2 timed on the
    stage's own input, and B2 launched once a traced iteration.  The
    counts are zeroed just before each run and read just after."""
    from keystone_tpu_torch.tools import roofline_forward as RF

    out = {"launches": 0}
    for ms in (False, True):
        label = "multi-scale, bins (4, 6, 8, 10), batch 64" if ms else "single-scale, batch 128"
        with phase(f"roofline: the bench forward's stages ({label})"):
            n, bins = (RF.MS_BATCH, RF.MS_BIN_SIZES) if ms else (RF.BATCH, (RF.BIN_SIZE,))
            stages, x = RF.build(n, bins, RF.MS_SMOOTHING if ms else RF.SMOOTHING, dev)
            fk.reset_launches()
            r = RF.run(ms=ms, device=dev, built=(stages, x))
            launches = dict(fk.LAUNCHES)
            print(RF.render(r), flush=True)
            want = RF.WARMUP + RF.WALL_REPS * sum(RF.WALL_ITERS) + RF.TRACE_ITERS
            check(launches == fv_launches(encode=want), f"roofline launches {launches}, expected {want} of B2")
            check(r["launches"] == {"fisher_encode": RF.TRACE_ITERS},
                  f"B2 launches over the traced iterations {r['launches']}, expected {RF.TRACE_ITERS}")
            worst = max(s["fraction"] for s in r["stages"])
            check(worst <= RF.OVER_BOUND, f"a stage at {worst:.3f} of its bound")
            check(r["stages_us"] <= ROOFLINE_WALL_SLACK * r["wall_marginal_us"],
                  f"stages {r['stages_us']:.1f} us over the wall marginal {r['wall_marginal_us']:.1f} us")
            # B2 on the FV stage's own input, timed by CUDA events (a
            # comparison: its launches are not the path's)
            with torch.no_grad():
                xs, mask = x, None
                for s in stages[:3]:
                    o = s.apply_batch(xs, mask=mask)
                    xs, mask = o if isinstance(o, tuple) else (o, None)
                g = stages[3].gmm
                b2_us = 1e3 * cuda_ms(lambda: fk.fisher_encode(xs, mask, g.weights, g.means, g.variances))
            fv_us = next(s["us"] for s in r["stages"] if s["stage"] == "fv")
            print(f"  FV stage {fv_us:.1f} us against B2 timed here at {tuple(xs.shape)} K={g.means.shape[0]}: "
                  f"{b2_us:.1f} us ({fv_us / b2_us:.3f}x; within {ROOFLINE_FV_AGREE:.0%}); stages "
                  f"{r['stages_us']:.1f} us of a wall marginal {r['wall_marginal_us']:.1f} us; {card}", flush=True)
            check(abs(fv_us - b2_us) <= ROOFLINE_FV_AGREE * b2_us, f"FV stage {fv_us:.1f} us against B2 {b2_us:.1f} us")
            del stages, x, xs, mask
            r["b2_us_at_stage_shape"] = b2_us
            out["multi_scale" if ms else "single_scale"] = r
            out["launches"] += launches["fisher_encode"]
            fk.reset_launches()
            torch.cuda.synchronize()
    return out


def host_text_path(card) -> dict:
    """``host_map`` with this process's CUDA context live: two forkserver
    workers map the Python text chain over a few thousand documents, each
    stage's rows bit for bit the sequential ones; then
    ``tools/bench_text.py``'s docs/s for the Python and native chains, the
    Python chain on the same pool (one pool a process: a pool's start-up,
    seconds, is paid once)."""
    from keystone_tpu_torch.ops import nlp
    from keystone_tpu_torch.tools import bench_text
    from keystone_tpu_torch.utils import hostmap

    out = {}
    with phase(f"host_map: the Python text chain over {HOST_MAP_WORKERS} workers, a CUDA context live"):
        check(torch.cuda.is_initialized(), "no CUDA context in this process")
        hostmap.shutdown()  # a pool an earlier phase made may hold another number of workers
        docs = bench_text.corpus(HOST_MAP_DOCS)
        seq = docs
        t_seq = t_par = 0.0
        for stage in (nlp.Trimmer(), nlp.LowerCase(), nlp.Tokenizer(), nlp.NGramsFeaturizer((1, 2)),
                      nlp.TermFrequency(nlp.log_tf)):
            t0 = time.perf_counter()
            want = [stage.apply_one(d) for d in seq]
            t1 = time.perf_counter()
            got = hostmap.host_map(stage.apply_one, seq, workers=HOST_MAP_WORKERS)
            t_seq, t_par = t_seq + t1 - t0, t_par + time.perf_counter() - t1
            check(got == want, f"{stage.label}: the pooled rows differ from the sequential ones")
            seq = want
        model = nlp.CommonSparseFeatures(bench_text.NUM_FEATURES, sparse_output=True).fit_arrays(seq)
        want = [model.apply_one(t) for t in seq]
        got = hostmap.host_map(model.apply_one, seq, workers=HOST_MAP_WORKERS)
        check(len(got) == len(want) and all((a != b).nnz == 0 and a.dtype == b.dtype for a, b in zip(got, want)),
              "CommonSparseFeatures: the pooled rows differ from the sequential ones")
        pool_workers = hostmap.pool_workers()
        # a pool that broke would have been shut down and the maps run in turn
        check(pool_workers == HOST_MAP_WORKERS, f"the pool has {pool_workers} workers (0: none, maps in turn)")
        out["host_map"] = {"docs": HOST_MAP_DOCS, "workers": pool_workers, "bit_for_bit": True,
                           "sequential_seconds": t_seq, "pooled_seconds": t_par}
        print(f"  {HOST_MAP_DOCS} documents, six stages bit for bit over {pool_workers} workers; the chain "
              f"{t_seq:.2f} s in turn, {t_par:.2f} s pooled (worker start-up included) ({card})", flush=True)
    with phase(f"bench_text: docs/s of the Python and native chains ({BENCH_TEXT_DOCS} documents)"):
        r = bench_text.run(BENCH_TEXT_DOCS, BENCH_TEXT_PY_DOCS)
        hostmap.shutdown()
        print(bench_text.render(r) + f"\n  ({card})", flush=True)
        check(r["native"]["docs"] == BENCH_TEXT_DOCS and r["python"]["docs"] == BENCH_TEXT_PY_DOCS
              and r["host_workers"] == HOST_MAP_WORKERS,
              f"bench_text documents {r['native']['docs']}, {r['python']['docs']}, workers {r['host_workers']}")
        out["bench_text"] = r
    return out


def report_child(tool: str, *args) -> tuple:
    """``python -m keystone_tpu_torch.tools.<tool> args`` as a child, with
    ``--json`` and without, each to exit 0: (its JSON, its text)."""
    cmd = [sys.executable, "-m", f"keystone_tpu_torch.tools.{tool}", *map(str, args)]
    j = subprocess.run(cmd + ["--json"], capture_output=True, text=True, timeout=120, cwd=REPO)
    t = subprocess.run(cmd, capture_output=True, text=True, timeout=120, cwd=REPO)
    check(j.returncode == 0 and t.returncode == 0, f"{tool}: exit {j.returncode}, {t.returncode}: "
                                                    f"{(j.stderr or t.stderr)[-2000:]}")
    return json.loads(j.stdout), t.stdout


# ---- A19: KEYSTONE_SOLVER_PRECISION=default, the solvers' products in
# one-pass TF32 by the hand-written solver kernel (csrc/solver_gemm.cu),
# per call and with no global flag.  (a) The kernel against its plain
# version (the product in float64 on the TF32-rounded operands) within
# solver_kernels.err_limit entry by entry: h·2⁻²⁴·(|a|ᵀ|b|), h the depth
# of the kernel's f32 sums (a k-stage in the tensor core, the stages of a
# chunk, the split's sum), not k; the planted faults (the first chunk of
# k dropped, the operands truncated instead of rounded) each outside it;
# and bit for bit across two calls (a fixed split of k, no atomics).  (b)
# The flagship fit under `default` through its entry, in a child process
# whose environment sets the variable: its held-out top-1 error within
# A19_TOP1_MARGIN of phase 9's f32 fit and under FIT_TOP1_ERROR_MAX, a
# guard against gross failure only (the synthetic classes are separated
# at either precision); its seconds against the f32 fit's in the same
# child, by turns (A19_TIMED_PAIRS pairs).  (c) S9's weighted BCD problem in
# this process: the training objective within A19_OBJECTIVE_RTOL of the
# f32 fit's.  (d) The scorer beside (c)'s fit bit for bit its output
# alone, cuBLAS's and cuDNN's TF32 flags False throughout.
A19_TOP1_MARGIN = 0.01
A19_OBJECTIVE_RTOL = 1e-3
A19_SCORER_MIN_ROUNDS = 4
A19_FITS_BESIDE = 3
A19_TIMED_PAIRS = 2


@contextlib.contextmanager
def solver_setting(value: str = "default"):
    """``KEYSTONE_SOLVER_PRECISION=value`` inside the block, in this
    process: the value ``utils/precision`` read at import, set and then
    restored (the child of (b) takes ``default`` from its environment)."""
    from keystone_tpu_torch.utils import precision

    prev = precision._SOLVER_PRECISION
    precision._SOLVER_PRECISION = value
    try:
        yield
    finally:
        precision._SOLVER_PRECISION = prev


def a19_operands(dev, P, fit_data, params, seed) -> dict:
    """The solver products' operands as the main path hands them over:
    the weighted BCD's first block step on S9's problem (A = √α·(X − x̄)
    of block 0 and its target √α·(Y − ȳ)); the EM's last step on the fit's
    SIFT GMM sample (the posteriors at the fitted mixture, the projected
    rows); the masked PCA's centred SIFT descriptor sample.  {label: (a,
    b, the Gramian's a is b)}."""
    from keystone_tpu_torch.models import gmm as G
    from keystone_tpu_torch.models.block_weighted_ls import class_weights

    x, y = (torch.from_numpy(v).to(dev) for v in s9_problem(seed))
    alpha = class_weights(y, S9_N, S9_MIX)
    sa = torch.sqrt(alpha)[:, None]
    xm, ym = (alpha @ x) / alpha.sum(), (alpha @ y) / alpha.sum()
    a = ((x[:, :S9_BLOCK] - xm[:S9_BLOCK]) * sa).contiguous()
    target = (y - ym) * sa
    cfg, tx = fit_data[0], fit_data[1]
    pca_rows, gmm_rows = P.sample_descriptors(cfg, tx, dev, FIT_BATCH)["sift"]
    comp, mean = params["sift.pca.components"], params["sift.pca.mean"]
    z = (gmm_rows - mean) @ comp
    lg = G._log_gaussians(z, params["sift.gmm.means"], params["sift.gmm.variances"],
                          torch.log(params["sift.gmm.weights"]))
    r = torch.exp(lg - torch.logsumexp(lg, dim=1, keepdim=True))
    xc = pca_rows - pca_rows.mean(dim=0)
    return {
        f"BCD Gramian AᵀA ({S9_N} x {S9_BLOCK})": (a, a),
        f"BCD AᵀY ({S9_N} x {S9_BLOCK}, {S9_K})": (a, target),
        f"EM rᵀx ({z.shape[0]} x {z.shape[1]}, K={r.shape[1]})": (r, z),
        f"masked PCA xcᵀxc ({xc.shape[0]} x {xc.shape[1]})": (xc, xc),
    }


def a19_planted_faults(sk, a, b) -> dict:
    """What a broken kernel would return for ``aᵀ·b``: its first chunk of
    k dropped (a split's partial, or the first k-stage where k is not
    split), and the operands truncated to TF32 instead of rounded."""
    splits, chunk = sk.split_plan(a.shape[1], b.shape[1], a.shape[0])
    c = chunk if splits > 1 else sk.STAGE_ROWS
    cut = lambda t: (t.view(torch.int32) & -0x2000).view(torch.float32).double()  # noqa: E731
    return {"a chunk dropped": sk.tf32_matmul_ref(a, b).double() - sk.tf32_matmul_ref(a[:c], b[:c]).double(),
            "operands truncated": (cut(a).T @ cut(b)).float().double()}


def a19_product_checks(card, sk, operands) -> dict:
    """(a): each product against its plain version within ``err_limit``
    entry by entry, the planted faults outside it, float64 and cuBLAS,
    bit for bit across two calls, timed (CUDA events, 20 launches)."""
    out = {}
    for label, (a, b) in operands.items():
        k, m, n = a.shape[0], a.shape[1], b.shape[1]
        got, again = sk.tf32_matmul(a, b), sk.tf32_matmul(a, b)
        torch.cuda.synchronize()
        plain, lim = sk.tf32_matmul_ref(a, b).double(), sk.err_limit(a, b)
        dist = (got.double() - plain).abs()
        err, limit = dist.max().item(), lim.max().item()
        ratio = (dist / lim).nan_to_num(0.0).max().item()
        faults = {name: ((bad - plain).abs() / lim).nan_to_num(0.0).max().item()
                  for name, bad in a19_planted_faults(sk, a, b).items()}
        exact = a.double().T @ b.double()
        e64, e64_f32 = max_err64(got, exact), max_err64(a.T @ b, exact)
        same = torch.equal(got, again)
        del exact, plain, lim, dist
        ms = cuda_ms(lambda: sk.tf32_matmul(a, b))
        plain_ms = cuda_ms(lambda: sk.tf32_matmul_ref(a, b), reps=5)
        f32_ms = cuda_ms(lambda: a.T @ b)
        with tf32_matmul():  # the one PyTorch call of the same function, timed alone
            tf32_ms = cuda_ms(lambda: a.T @ b)
        # AᵀA (a is b) needs only its symmetric half: a once, m(m+1)/2 dots
        nbytes = 4 * (k * m + (0 if a is b else k * n) + m * n)
        flops = (m * (m + 1) if a is b else 2.0 * m * n) * k
        bound = 1e3 * max(nbytes / PEAK_BYTES, flops / PEAK_TF32_FLOPS)
        by = "operations" if flops / PEAK_TF32_FLOPS > nbytes / PEAK_BYTES else "bytes"
        print(f"  {label}: against the plain version {err:.3e}, at most {ratio:.3e} of its entry's limit "
              f"h·2⁻²⁴·(|a|ᵀ|b|) (h = {sk.sum_depth(m, n, k)}, largest {limit:.3e}); planted faults at most "
              + ", ".join(f"{name} {r:.3e}" for name, r in faults.items())
              + f" of the limit; from float64 on the unrounded operands {e64:.3e}, cuBLAS f32 {e64_f32:.3e}; "
              f"two calls bit for bit: {same}; {ms:.4f} ms (bound {bound:.4f} ms by {by}; plain {plain_ms:.4f}; "
              f"torch.matmul f32 {f32_ms:.4f}, with the TF32 flag {tf32_ms:.4f}), {card}", flush=True)
        check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (m, n), f"{label}: output")
        check(ratio <= 1.0, f"{label}: {err:.3e} from the plain version, {ratio:.3e} of its entry's limit")
        for name, r in faults.items():
            check(r > 1.0, f"{label}: the limit lets a kernel with {name} pass ({r:.3e} of it)")
        check(same, f"{label}: two calls differ")
        out[label] = {"m": m, "n": n, "k": k, "max_abs_err": err, "err_limit": limit, "err_to_limit": ratio,
                      "sum_depth": sk.sum_depth(m, n, k), "planted_faults_to_limit": faults, "f64_err": e64,
                      "f64_err_cublas_f32": e64_f32, "bitwise": same, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": by, "library_ms": tf32_ms, "cublas_f32_ms": f32_ms}
    return out


def a19_child(work: str) -> int:
    """(b) in a process of its own, whose environment sets
    ``KEYSTONE_SOLVER_PRECISION=default``, on the fit leg's images saved by
    the parent (``work/images.npz``): the graph fit (``Pipeline.fit`` of
    ``ImageNetSiftLcsFV.build``, what ``run`` fits), the solver kernel's
    counts zeroed just before and read just after its held-out
    predictions; then, in this one process and so warm, the graph fit and
    ``fit_params`` under ``float32`` and ``default`` by turns
    (A19_TIMED_PAIRS pairs), so that their seconds compare like with like.
    Writes its figures to ``work/a19.json``."""
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.kernels import build
    from keystone_tpu_torch.ops import solver_kernels as sk
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P
    from keystone_tpu_torch.utils import precision
    from keystone_tpu_torch.workflow.dataset import Dataset

    check(precision.solver_precision() == "tf32", "the child did not read KEYSTONE_SOLVER_PRECISION=default")
    precision.disable_tf32()
    build.build(["fisher", "solver_gemm"])
    dev = torch.device(DEVICE)
    cfg = fit_setup_config(P)
    with np.load(Path(work, "images.npz")) as f:
        tx, ty, vx, vy = (f[k] for k in ("tx", "ty", "vx", "vy"))
    tx_d, vx_d, ty_d = (torch.from_numpy(v).to(dev) for v in (tx, vx, ty))
    G = P.ImageNetSiftLcsFV
    sk.reset_launches()
    fitted = G.build(cfg, Dataset(tx_d), Dataset(ty_d)).fit()
    pred = fitted(Dataset(vx_d)).get().numpy()
    torch.cuda.synchronize()
    launches, shapes = dict(sk.LAUNCHES), {f"{m}x{n}x{k}": c for (m, n, k), c in sk.LAUNCH_SHAPES.items()}
    m = MulticlassClassifierEvaluator(cfg.num_classes).evaluate(pred[:, 0], vy)
    turns = {"float32": {"fit": [], "fit_params": []}, "default": {"fit": [], "fit_params": []}}
    for _ in range(A19_TIMED_PAIRS):
        for setting, got in turns.items():
            with solver_setting(setting):
                t0 = time.perf_counter()
                G.build(cfg, Dataset(tx_d), Dataset(ty_d)).fit()
                torch.cuda.synchronize()
                got["fit"].append(time.perf_counter() - t0)
                st = {}
                P.fit_params(cfg, tx_d, ty, dev, batch_size=FIT_BATCH, stage_seconds=st)
                torch.cuda.synchronize()
                got["fit_params"].append(st)
    Path(work, "a19.json").write_text(json.dumps({
        "top1_error": m.total_error, "top5_error": float(1.0 - (pred == vy[:, None]).any(axis=1).mean()),
        "predictions": pred.tolist(), "launches": launches["solver_gemm"],
        "reduce_launches": launches["solver_reduce"], "launch_shapes": shapes,
        "same_process": {s_: {"fit_seconds": min(v["fit"]), "fit_params_stage_seconds":
                              {k: min(st[k] for st in v["fit_params"]) for k in v["fit_params"][0]}}
                         for s_, v in turns.items()},
        "allow_tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]}))
    return 0


def a19_fit_under_default(card, sk, fit_data, graph, graph_predictions) -> dict:
    """(b): the child's fit against phase 9's f32 graph fit (top-1, top-5,
    agreement), and its seconds and fit_params stages under either
    setting, by turns in the child."""
    _, tx, ty, vx, vy = fit_data
    work = Path(tempfile.mkdtemp(prefix="a19_", dir=REPO))
    try:
        np.savez(work / "images.npz", tx=tx.cpu().numpy(), ty=ty, vx=vx.cpu().numpy(), vy=vy)
        env = {k: v for k, v in os.environ.items() if k not in ("KEYSTONE_FAULTS", "KEYSTONE_OBS_DIR")}
        env["KEYSTONE_SOLVER_PRECISION"] = "default"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--a19-child", str(work)],
                              capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO))
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
        check(proc.returncode == 0, f"the A19 child exited {proc.returncode}")
        got = json.loads((work / "a19.json").read_text())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    pred = np.asarray(got.pop("predictions"))
    check(pred.shape == (FIT_TEST_N, 5), f"top-5 shape {pred.shape}")
    agree = float((pred[:, 0] == graph_predictions[:, 0]).mean())
    print(f"  the graph fit under default (a child, {child_s:.1f} s with its start-up): held-out top-1 error "
          f"{got['top1_error']:.4f} (f32 fit {graph['top1_error']:.4f}; at most +{A19_TOP1_MARGIN} and "
          f"{FIT_TOP1_ERROR_MAX}), top-5 {got['top5_error']:.4f} (f32 {graph['top5_error']:.4f}); top-1 agreement "
          f"with the f32 fit {agree:.5f}", flush=True)
    same = got["same_process"]
    print(f"  solver kernel launches {got['launches']} by shape {got['launch_shapes']}, the split's sum "
          f"{got['reduce_launches']}", flush=True)
    print(f"  in the child, by turns ({A19_TIMED_PAIRS} pairs, the least of each): Pipeline.fit under default "
          f"{same['default']['fit_seconds']:.4f} s, float32 {same['float32']['fit_seconds']:.4f} s; fit_params by "
          "stage, default against float32: " + ", ".join(
              f"{k} {v:.4f}/{same['float32']['fit_params_stage_seconds'][k]:.4f}"
              for k, v in same["default"]["fit_params_stage_seconds"].items()) + f" s ({card})", flush=True)
    check(got["launches"] > 0, "the fit under default launched no solver kernel")
    split_calls = sum(c for shape, c in got["launch_shapes"].items()
                      if sk.split_plan(*map(int, shape.split("x")))[0] > 1)
    check(got["reduce_launches"] == split_calls,
          f"the split's sum ran {got['reduce_launches']} times for {split_calls} split products")
    check(got["top1_error"] <= graph["top1_error"] + A19_TOP1_MARGIN,
          f"top-1 error {got['top1_error']:.4f} against the f32 fit's {graph['top1_error']:.4f}")
    check(got["top1_error"] <= FIT_TOP1_ERROR_MAX, f"top-1 error {got['top1_error']:.4f}")
    check(got["allow_tf32"] == [False, False], f"the child's TF32 flags {got['allow_tf32']}")
    got.update({"top1_agreement": agree, "child_seconds": child_s, "f32_top1_error": graph["top1_error"]})
    return got


def a19_bcd(dev, seed) -> dict:
    """(c)'s problem, its float64 weights and the objective of a fit."""
    from keystone_tpu_torch.models.block_weighted_ls import _weighted_bcd_fit, class_weights

    x, y = (torch.from_numpy(v).to(dev) for v in s9_problem(seed))
    alpha = class_weights(y, S9_N, S9_MIX)
    kw = dict(n=S9_N, lam=S9_LAM, num_iter=S9_EPOCHS, block_size=S9_BLOCK, fit_intercept=True)
    w64, xm64, ym64 = _weighted_bcd_fit(x.double(), y.double(), alpha.double(), **kw)
    w64 = w64.reshape(-1, S9_K)[:S9_D]
    sa = torch.sqrt(alpha.double())[:, None]

    def objective(w):
        r = ((x.double() - xm64) @ w.double() - (y.double() - ym64)) * sa
        return (0.5 * torch.sum(r * r) / S9_N + 0.5 * S9_LAM * torch.sum(w.double() ** 2)).item()

    return {"x": x, "y": y, "w64": w64, "objective": objective}


def a19_estimator():
    from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator

    return BlockWeightedLeastSquaresEstimator(block_size=S9_BLOCK, num_iter=S9_EPOCHS, lam=S9_LAM,
                                              mixture_weight=S9_MIX)


def a19_timed_fit(dev, prob) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = a19_estimator().fit_arrays(prob["x"], prob["y"], device=dev)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def a19_s9_bcd(dev, card, sk, prob) -> dict:
    """(c): the f32 and the default fit (each after a warm-up fit), their
    weights against float64 and their objectives."""
    a19_timed_fit(dev, prob)
    m32, s32 = a19_timed_fit(dev, prob)
    with solver_setting():
        a19_timed_fit(dev, prob)
        sk.reset_launches()
        mtf, stf = a19_timed_fit(dev, prob)
        launches = sk.LAUNCHES["solver_gemm"]
    w64 = prob["w64"]
    scale = w64.abs().max().item()
    rel32, reltf = max_err64(m32.flat_weights[:S9_D], w64) / scale, max_err64(mtf.flat_weights[:S9_D], w64) / scale
    f32_obj, tf_obj = prob["objective"](m32.flat_weights[:S9_D]), prob["objective"](mtf.flat_weights[:S9_D])
    rel_obj = abs(tf_obj - f32_obj) / abs(f32_obj)
    print(f"  S9's weighted BCD ({S9_N} x {S9_D}, blocks of {S9_BLOCK}, {S9_K} classes, {S9_EPOCHS} epochs): the "
          f"weights {reltf:.3e} of the largest from float64 under default, {rel32:.3e} in f32; the objective "
          f"{tf_obj:.9e} against f32's {f32_obj:.9e} ({rel_obj:.3e} relative, at most {A19_OBJECTIVE_RTOL}); "
          f"the fit {stf:.4f} s against f32's {s32:.4f} s; solver kernel launches {launches} ({card})", flush=True)
    check(launches == 2 * S9_EPOCHS * (S9_D // S9_BLOCK),
          f"the default fit launched the solver kernel {launches} times")
    check(rel_obj <= A19_OBJECTIVE_RTOL, f"the objective under default is {rel_obj:.3e} from f32's")
    return {"weights_rel_err_f64": reltf, "weights_rel_err_f64_f32": rel32, "objective": tf_obj,
            "objective_f32": f32_obj, "objective_rel": rel_obj, "seconds": stf, "seconds_f32": s32,
            "launches": launches}


def a19_no_global_flag(dev, card, scorer, batch, prob) -> dict:
    """(d): one thread runs the scorer on one batch again and again while
    this one runs (c)'s fit under default; every output must be bit for bit
    its output alone, and the TF32 flags False before, during and after."""
    import threading

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)  # noqa: E731
    before = flags()
    alone = scorer(batch)
    torch.cuda.synchronize()
    done, started = threading.Event(), threading.Event()
    seen = {"rounds": 0, "differ": 0, "flags": set()}

    def serve():
        while not done.is_set() or seen["rounds"] < A19_SCORER_MIN_ROUNDS:
            seen["flags"].add(flags())
            out = scorer(batch)
            seen["differ"] += int(not torch.equal(out, alone))
            seen["rounds"] += 1
            started.set()

    th = threading.Thread(target=serve, name="a19-scorer")
    th.start()
    try:
        check(started.wait(timeout=120), "the scorer thread did not start")
        with solver_setting():
            r0 = seen["rounds"]
            for _ in range(A19_FITS_BESIDE):
                seen["flags"].add(flags())
                a19_timed_fit(dev, prob)
            during = seen["rounds"] - r0
    finally:
        done.set()
        th.join(timeout=120)
    torch.cuda.synchronize()
    after = flags()
    print(f"  the scorer beside {A19_FITS_BESIDE} fits under default: {seen['rounds']} rounds ({during} during the "
          f"fits), {seen['differ']} not bit for bit its output alone; TF32 flags (cuBLAS, cuDNN) before {before}, "
          f"during {sorted(seen['flags'])}, after {after} ({card})", flush=True)
    check(not th.is_alive(), "the scorer thread did not finish")
    check(during > 0, "no scorer round ran during the fits")
    check(seen["differ"] == 0, f"{seen['differ']} scorer outputs changed beside the fit")
    check({before, after} | seen["flags"] == {(False, False)}, "a TF32 flag was on")
    return {"rounds": seen["rounds"], "rounds_during_fits": during, "differ": seen["differ"], "flags_on": False}


def solver_path(dev, card, P, scorer, batch, fit_data, graph, graph_predictions, params, seed) -> dict:
    """A19, after the flagship fit's phases: (a) the solver kernel at the
    main path's products, (b) the flagship fit under default in a child,
    (c) S9's BCD under default, (d) no global flag.  Returns the kernel
    line's entry."""
    from keystone_tpu_torch.ops import solver_kernels as sk

    with phase("A19: the solver product (a): the kernel against its plain version at the main path's products"):
        shapes = a19_product_checks(card, sk, a19_operands(dev, P, fit_data, params, seed))
        torch.cuda.synchronize()
    with phase("A19: the solver product (b): the flagship fit under KEYSTONE_SOLVER_PRECISION=default"):
        fit = a19_fit_under_default(card, sk, fit_data, graph, graph_predictions)
    with phase("A19: the solver product (c): S9's weighted BCD under default against f32 and float64"):
        prob = a19_bcd(dev, seed)
        bcd = a19_s9_bcd(dev, card, sk, prob)
    with phase("A19: the solver product (d): the scorer beside a fit under default"):
        flag = a19_no_global_flag(dev, card, scorer, batch, prob)
    del prob
    sk.reset_launches()
    head = shapes[next(iter(shapes))]  # the Gramian: the largest of the path's products
    return {
        "name": "solver_gemm", "route": "cuda", "source": "keystone_tpu_torch/csrc/solver_gemm.cu",
        "replaces": "keystone_tpu/utils/precision.py:213::sdot (no Pallas counterpart, A19)",
        "launches": fit["launches"], "reduce_launches": fit["reduce_launches"],
        "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "cublas_f32_ms": head["cublas_f32_ms"],
        "shape": next(iter(shapes)), "shapes": shapes, "fit_under_default": fit, "s9_bcd": bcd,
        "no_global_flag": flag,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one batch or fit of each main path (after the checks)")
    ap.add_argument("--seed", type=int, default=0, help="the seed of S9's data (numpy)")
    ap.add_argument("--recovery-child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--parallel-rank", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--a19-child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if args.recovery_child:
        return recovery_child(args.recovery_child)
    if args.parallel_rank:
        return parallel_rank(args.parallel_rank)
    if args.a19_child:
        return a19_child(args.a19_child)

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
        # every CUDA source with nvcc, and the host text chain and the host
        # float64 FV reference with g++, all compilers started together
        # (jpeg.cpp needs libjpeg, which the card's machine lacks: the CPU
        # decoder is not on a card path)
        sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
        t0 = time.perf_counter()
        paths = build.build(sources + ["text", "keystone_ffi"])
        print(f"  built {sources + ['text', 'keystone_ffi']} in {time.perf_counter() - t0:.1f} s")
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

    def b1_args(x):
        """B1's two calls on images ``x``, as the served scorer makes them."""
        xf = scorer.stages[0].apply_batch(x)
        raw, mask = FusedTransformer(list(sift_branch.stages)[:2]).apply_batch(xf)
        desc, dmask = lcs_branch.stages[0].apply_batch(xf)
        return [("SIFT", fused_args(fused_sift, raw, mask, fused_sift.mean)),
                ("LCS", fused_args(fused_lcs, desc, dmask, fused_lcs.mean))]

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

    # ---- A12's host float64 reference and A17's ops, checked on the card
    host_ref = host_ref_path(dev, card, fk, fx, fmask, gmm_b2, args.seed)
    left_out = left_out_ops_path(dev, card, images)
    fk.reset_launches()

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
    graph_predictions = graph_detail["predictions"]  # S9's two-rank run is held to them
    del graph_detail
    # A19: the solver product under KEYSTONE_SOLVER_PRECISION=default, after the flagship fit's phases
    solver_line = solver_path(dev, card, P, scorer, batches[0], fit_data, results["graph"], graph_predictions,
                              fitted, args.seed)
    results["tar"] = tar_path(dev, card, P)
    tier_tmp = Path(tempfile.mkdtemp(prefix="kernel_tier_", dir=REPO))
    try:
        for sub in ("timit", "cifar", "oc", "disk", "mnist"):
            (tier_tmp / sub).mkdir()
        results["kernel_timit_pipeline"] = kernel_timit_pipeline_path(dev, card, gk, fk, tier_tmp / "timit")
        results["kernel_cifar_pipeline"] = kernel_cifar_pipeline_path(dev, card, gk, fk, tier_tmp / "cifar")
        results["oc_krr"], oc_alpha = oc_krr_path(dev, card, gk, fk, data, tier_tmp / "oc")
        results["knobs"] = knobs_path(dev, card, gk, fk, data, tier_tmp / "oc", oc_alpha, args.seed, forward,
                                      float_batches)
        del oc_alpha
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
    # after the text apps, whose profiler windows have loaded CUPTI
    results["roofline"] = roofline_path(dev, card, fk)
    results["host_text"] = host_text_path(card)
    # the operations layer: the recovered streamed fit, the checkpointed
    # solvers, deadlines and breakers (phase 10's fit seconds, phase 14's data)
    results["operations"] = operations_path(dev, card, P, fk, gk, results["stream"], data,
                                            results["newsgroups"].pop("ls_problem"), materialize)

    # the serving path: S1 the full-width scorer behind serve(), S1b the
    # bench forward, S2 a saved graph-fitted model through `cli serve`, S3
    # the fleet's self-healing and a hot swap, S4 open-loop latency, S5 the
    # model lifecycle, S6 the process and network fleets
    served = serve_path(dev, card, P, fk, scorer, forward, images, float_batches, b1_args)
    served["s2"] = serve_http_path(dev, card, graph_fitted, fit_data[3])
    del graph_fitted
    params_swap = params_from_numpy(P.random_params(pca_dims=PCA_DIMS, gmm_k=GMM_K, num_classes=NUM_CLASSES, seed=4),
                                    dev)
    served["s3"] = fleet_path(dev, card, P, fk, scorer, images, params_swap)
    served["c10"] = concurrent_b1_path(dev, card, fk)
    saturation_ips = served["s1"]["regimes"]["saturation"]["images_per_s"]
    served["s4"] = open_loop_path(dev, card, fk, scorer, images, saturation_ips)
    served["s5"] = lifecycle_path(dev, card, P, fk, scorer, images, params_swap, saturation_ips)
    del params_swap
    served["s6"] = process_fleet_path(dev, card, P, fk, scorer, images, b1_args)
    served["s7"] = tenants_path(dev, card, P, fk, cfg, scorer_params, images)
    served["s8"] = planner_path(dev, card, P, fk, gk, cfg, scorer_params, images)
    served["s10"] = serve_bench_path(dev, card)
    results["serve"] = served
    # S9, the parallel layer: rank processes of this script over NCCL and Gloo
    results["parallel"] = parallel_path(dev, card, args.seed, graph_predictions)

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
        # A18: the bench forward's featurization at four apply chunks
        b2["launches_by_path"]["A18 KEYSTONE_APPLY_CHUNK featurizations"] = results["knobs"]["apply_chunk"]["launches"]
        b2["launches"] += results["knobs"]["apply_chunk"]["launches"]
        # the bench forward's roofline: its warm-up, wall and traced iterations
        b2["launches_by_path"]["roofline (single- and multi-scale)"] = results["roofline"]["launches"]
        b2["launches"] += results["roofline"]["launches"]
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
        s5, s6 = served["s5"], served["s6"]
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
                                    s5["watcher"]["replayed"].get("fused_forward", 0)),
                                   ("serve S6 worker processes, by the wrapper",
                                    s6["workers_kernels"]["launches"].get("fused_forward", 0)),
                                   ("serve S6 worker processes, by bucket-graph replays",
                                    s6["workers_kernels"]["replayed"].get("fused_forward", 0)),
                                   ("serve S6 this process (the router)", s6["parent"]["launches"]["fused_forward"]
                                    + s6["parent"]["replayed"].get("fused_forward", 0)),
                                   ("serve S6 threaded comparison, by the wrapper",
                                    s6["threaded_launches"]["launches"]["fused_forward"]),
                                   ("serve S6 threaded comparison, by bucket-graph replays",
                                    s6["threaded_launches"]["replayed"].get("fused_forward", 0)),
                                   ("serve S7 multi-tenant (direct flushes, serve_multi, serve(), the tenant A/B, "
                                    "the offline scorers)", served["s7"]["launches"]["fused_forward"]),
                                   ("serve S7 `cli serve` child with three named models",
                                    served["s7"]["cli"]["launches"]["fused_forward"]),
                                   ("S8 planner (the fused_fv gate's samples, the planned and forced freezes, the "
                                    "bucket retune's walks, the plan A/B)", served["s8"]["launches"]["fused_forward"]),
                                   ("S8 `cli serve --model-dir` child, by the wrapper and by replays",
                                    served["s8"]["child_launches"]["fused_forward"]))),
            (b2, "fisher_encode", (("serve S1b bench forward", served["launches_fisher_encode"]),
                                   ("S8 planner (the chain candidate's samples, the forced chain freeze, the bucket "
                                    "retune's walks when the chain wins, the plan A/B)", served["s8"]["launches"]["fisher_encode"]),
                                   ("S8 `cli serve --model-dir` child, by the wrapper and by replays",
                                    served["s8"]["child_launches"]["fisher_encode"]))),
        ):
            for label, c in parts:
                ln["launches_by_path"][label] = c
                ln["launches"] += c
        # S9: ImageNetSiftLcsFV.run as a job of two Gloo ranks (B2 in each
        # rank's featurization, B1 in each rank's scoring), counted in the
        # rank processes
        s9 = results["parallel"]["a8b"]
        for ln, kname in ((b1, "fused_forward"), (b2, "fisher_encode")):
            ln["launches_by_path"]["S9 ImageNetSiftLcsFV.run at two Gloo ranks (both ranks' counts)"] = \
                s9["launches"][kname]
            ln["launches"] += s9["launches"][kname]
            ln["launches_s9_by_rank"] = {k: v["run"][kname] for k, v in s9["by_rank"].items() if v["run"]}
        b1["serve_bucket_checks"] = served["b1_buckets"]
        b1["concurrent_check"] = served["c10"]  # C10: checks, not counted as the main path's launches
        b1["graph_replays"] = (s5["replayed"]["fused_forward"] + s5["watcher"]["replayed"].get("fused_forward", 0)
                               + s6["workers_kernels"]["replayed"].get("fused_forward", 0)
                               + s6["threaded_launches"]["replayed"].get("fused_forward", 0))
        # B1 at the serving buckets below S1's batch (S6's first phase)
        b1["serve_buckets"] = s6["b1_buckets"]
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
        # B2 against A12's host float64 encode of the scorer's first images
        enc = host_ref["encode"]
        b2["f64_check_host_ref"] = {"shape": enc["shape"], "kernel": enc["b2_vs_host"],
                                    "plain_f32": enc["plain_f32_vs_host"]}
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
        # A19's solver product, timed in its own phase at the main path's products
        lines.append(solver_line)
        for label, t in solver_line["shapes"].items():
            print(f"  solver_gemm at {label}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms by {t['bound_by']}, torch.matmul with the TF32 flag "
                  f"{t['library_ms']:.4f} ms, in f32 {t['cublas_f32_ms']:.4f} ms), {card}")

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
        "parallel": results["parallel"],
        "roofline": results["roofline"],
        "host_text": results["host_text"],
        "left_out_ops": left_out,
        "card": card,
    }))
    print(f"chip_smoke: the whole script took {time.perf_counter() - T_START:.1f} s ({card})", flush=True)
    # A12 runs on the host and is no TPU kernel: its line stands apart
    print("host_ref " + json.dumps(dict(host_ref, source="keystone_tpu_torch/csrc/keystone_ffi.cpp",
                                        replaces="native/keystone_ffi.cpp:33,157", card=card)))
    print(json.dumps({"a18": results["knobs"]}))
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
