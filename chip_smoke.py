"""Smoke run of rift_tpu_torch on one CUDA card: build the kernels, hold each
against its plain PyTorch version, register 16 scan pairs of 1024 points at
the flagship width and with bench.py's headline model in bf16, train the
flagship classifier on batches of 16 clouds of 1024 points with the
registration probe, run the flagship's registration evaluation (100 pairs,
flip hypotheses, TEASER), the reference's recommended reg_noise preset
(cube trunk, RANSAC and point-to-plane ICP) and, through the command
line, its reg_icl_nuim preset on the indoor sequence's adjacent scans;
then the classifier's own workflow: bf16 training of the reference's
default preset through the command line, `evaluate-cls` of its
checkpoint, and the data-parallel step on a one-rank NCCL group; then
ShapeNet part segmentation training through the command line at the
`shapenet_seg` preset's full width; and compare every path with its CPU
run.

    python3 chip_smoke.py

Phases (each prints one line with its wall time):
  1. device  — nvidia-smi's name and power limit, torch's device name;
               exits non-zero when CUDA is not available.
  2. build   — nvcc builds rift_tpu_torch/csrc/*.cu for sm_90a.
  3. kernels — K1-K5 against their plain versions at the main paths'
               shapes, with times, bounds and the library yardsticks: K2 on
               f32 and bf16 features, K3 on f32 and bf16 grids, K2-K4 also
               on indices s and s + 1 (dropped, as -1 is), K4 against K3 by
               the adjoint identity, and K5 (the bf16 3x3x3 Conv3d) at the
               bench model's four shapes, every element within one bf16
               step of its plain version, beside cuDNN's bf16 Conv3d, and
               at each other r the kernel takes and couts of 40 and 96.
               K2 and K4 called twice on the same inputs must be bit-equal,
               and are timed also back to back (20 calls between two
               events, no synchronize: device time without each call's
               host enqueue), as are their library yardsticks.
               Then K1, K2 and K4 on clouds of 2048, 5000 and 16384 points
               (past K1_SHARED_POINTS, the largest cloud any of them keeps
               in one block's shared memory): neighbour counts equal,
               the same tolerances, K4 as K3's adjoint; K2 and K4 on a
               cloud of 16384 points all in one voxel and on one whose
               indices are all -1 (timed), and at r = 16, 64 and 128.
  4. main    — register_batch on 16 SyntheticPairs(mode="noise", seed=0)
               pairs, flagship width (mn40_sph_pt_r4), seeded random weights;
               one warm-up and 3 timed batches; every launch counter must rise.
  5. parity  — the first 8 pairs of the timed batch against the same path
               with device="cpu"; GNC-TLS and Kabsch on the card against
               the CPU on the CPU run's matches.
  5b. large  — register_batch with the flagship on 4 pairs of 2048 points
               (ShapeNet's size), then its parity phase on all 4 pairs.
  6. bench   — the same 16 pairs through bench.py's headline model
               (models.bench_model: sph_dg, global PPF, reference LRF,
               bf16) with seeded weights: ms/batch and pairs/s, K5 launched
               4 times a batch, then its parity phase against the CPU under
               the bf16 tolerances below.
  7. stages  — one staged batch of each model (normals, features, mutual
               NN, GNC-TLS, each ended by a synchronize).
  8. train   — train() of the mn40_sph_pt_r4 preset on a small synthetic
               ModelNet40 split (4 steps of 16 x 1024, one validation pass
               with the registration probe, reg_probe_interval 1: its
               best_reg_* metrics finite and best_reg_rre.pt written;
               checkpoints), seeded weights; then 10 more steps on one
               fixed batch: finite losses, K2, K3 and K4 each launched twice
               per step, the last 3 losses below the first 3; ms/step,
               clouds/s, and the forward/backward/optimizer split.
  9. train parity — one step on 4 clouds from the same weights, dropout
               off, on the card and on the CPU: loss, gradients, BN stats.
 10. evaluate — evaluate_registration of the mn40_sph_pt_r4 preset with its
               evaluate section unchanged (100 noise pairs x 1024 points, 64
               a batch, teaserpp, flip hypotheses, canonical voxels) from a
               seeded checkpoint in a temp train.ckpt_dir: K1, K2, K3
               launched 1, 2, 2 times a batch, finite results, pairs/s, peak
               memory; then a 64-pair batch timed and staged (normals, the
               5b forward, consensus, TEASER core, rotation, polish,
               metrics), 4 of its pairs against the CPU (EVAL_PARITY), and
               K2 and K3 at the 5b forward's shapes.
 11. evaluate reg_noise — evaluate_registration of the reg_noise preset
               unchanged (cube trunk, dgcnn_kernel, global PPF, reference
               LRF; ransac+picp with 1000 hypotheses; 100 noise pairs x
               1024 points, 64 a batch, flips, canonical voxels) from a
               seeded checkpoint: K1, K2, K3 launched 2, 2, 2 times a batch,
               finite results, pairs/s, peak memory; a 64-pair batch timed,
               profiled and staged (normals, the 5b forward, consensus, RANSAC
               sampling, RANSAC scoring + refit + IRLS, ICP point-to-point,
               normals of the targets, ICP point-to-plane, errors; the
               consensus, RANSAC and both ICPs under sync debug mode
               "error"), 4 of its pairs against the CPU on the same RANSAC
               samples (reg_parity), every method name on 16 pairs
               (SWEEP), and K1, K2 and K3 at this path's cube shapes.
 12. evaluate reg_icl_nuim — the same for the reg_icl_nuim preset
               unchanged (ransac+picp with 4000 hypotheses, threshold 0.07,
               noise bound 0.05; 100 adjacent-scan pairs of the synthetic
               indoor sequence x 1024 points, 64 a batch), run through the
               command line in this process (cli.main(["evaluate",
               "--preset", "reg_icl_nuim", "--ckpt", DIR]) on a seeded
               checkpoint): launches, results, pairs/s, peak memory and
               RANSAC's own, the staged and profiled batch, 4 scan pairs
               against the CPU (reg_parity), and K1 (with its neighbours per
               query on the room's scans), K2 and K3 at its shapes; no
               method sweep.
 13. train bf16 — `cli.main(["train", "--preset", "mn40_sph_dg", ...,
               "model.dtype=bfloat16"])` (BF16_OVERRIDES: the split cut to
               64/16/16, one epoch of 4 steps of 16 x 1024): K2, K3, K4
               launched twice a step and K2, K3, K5 2, 2, 4 times a
               validation batch, the checkpoint's snapshot bf16; then 10
               steps of its model on one fixed batch as in 8 (ms/step,
               clouds/s, the split, a profiled step, peak memory, the loss
               falling); K2/K3 (bf16) and K4 at its training shapes
               against their plain versions; furthest_point_sample at
               [16, 1024, 3] -> 512 equal to the CPU's.
 14. train bf16 parity — one bf16 step on 4 clouds, card vs CPU, beside
               the CPU's f32 step (BF16_PARITY rules).
 15. evaluate-cls — `cli.main(["evaluate-cls", "--ckpt", DIR, "--sweep"])`
               on that checkpoint with the preset's 128-item test split:
               the hard tier, the 6 sweep levels and 4 rotations; the whole
               call's seconds, the forwards' clouds/s, peak memory, K2, K3,
               K5 launched 2, 2, 4 times a forward; K2/K3 at its test and
               hard-tier batches and K5 at its four convolutions (b = 32)
               against their plain versions; 8 test clouds' logits against
               the CPU's.
 16. train dp — make_sharded_train_step on a one-rank NCCL group against
               train_step, one step of the f32 flagship at 16 x 1024:
               loss, accuracy, parameters and BN statistics bit for bit;
               both steps' ms; the group destroyed.
 17. train-seg — `cli.main(["train-seg", "--preset", "shapenet_seg", ...])`
               at the preset's full width (SEG_OVERRIDES: one epoch of 4
               steps of 8 x 2048 on the synthetic split, the 32 test items
               evaluated as one batch): K2, K3, K4 launched twice a step,
               K2, K3 twice an eval forward, best_iou and common written;
               then 10 steps on one fixed batch (ms/step, clouds/s,
               points/s, the split, a profiled step, peak memory, the loss
               falling), the eval forward at 32 x 2048 timed, card vs CPU
               on 2 clouds (logits, one step), and K2/K3/K4 at its shapes.
 18. map-sequence — `cli.main(["map-sequence", "--preset", MAP_PRESET,
               "--ckpt", DIR])` on a seeded checkpoint, the preset unchanged
               (the cube trunk at full width, teaserpp, noise bound 0.05;
               the sequence's 24 scans x 1024 points, loop stride 6: 29
               edges, one gated round, 10 GN and 8 BA iterations), twice
               (the second call warm), then with evaluate.method=
               ransac+picp, then with sequence.num_scans=96 (125 edges, a
               576 x 576 pose system): each call's seconds and its stages
               (features, both registration passes, refresh, both pose
               graphs, landmarks on the host, BA; each ended by a
               synchronize), peak memory, K1-K3 launches equal to
               map_launches, every metric finite; K1 on a feature chunk of
               16 scans and K2/K3 on its 4-flip stack against their plain
               versions.
 19. map parity — map_sequence on oracle features (world coordinates) of
               the 24 x 1024 sequence on the card against its CPU run
               (MAP_TOL); optimize_pose_graph and bundle_adjust on the CPU
               run's own inputs within SOLVE_TOL of its poses' scale, two
               card calls bit-equal, both under sync debug mode "error";
               map_sequence with --mesh's group (one NCCL rank) bit-equal
               to the unsharded card run.
 20. evaluate --methods — `cli.main(["evaluate", "--preset", SWEEP_PRESET,
               "--ckpt", DIR, "--methods", ...])` (100 pairs, 64 a batch):
               per-method reg_time and pairs/s, the match pass's ms a batch
               (median of TIMED_BATCHES), K1-K3 launches a batch; the
               teaserpp row's poses bit-equal to register_eval_batch's on
               the same batch; K1-K3 at its shapes.
Then one JSON line of per-kernel numbers, and the result line
{"ok": true, "device": {...}} last. Any failure exits non-zero before it.

Imports only torch, numpy and rift_tpu_torch (no JAX).
"""
from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and f32 outside the
# tensor cores. Bounds below are stated against these at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12  # dense, on the tensor cores

NUM_PAIRS = 16
NUM_POINTS = 1024
PARITY_PAIRS = 8
TIMED_BATCHES = 3

# Tolerances of the kernel checks (kernel vs plain version on the card).
# K1: neighbour counts must be equal (both compute d² with the same
# unfused expansion, so the radius masks agree bit for bit); the moments
# are sums of up to n terms in another order: relative error <= 1e-5 of
# the largest moment. K2: counts equal; means differ only by summation
# order (index_add_ uses atomics on the card): <= 1e-5 of the largest
# value. K3: same corner order and unfused multiply-add as the plain
# version: <= 1e-6 of the largest value.
# K4: the kernel sums each voxel's products in (p, k) order, unfused, as the
# plain version does on the CPU; on the card index_add_ adds them with
# atomics in another order: <= 1e-5 of the largest value.
# K2 and K3 on bf16 inputs sum the exact bf16 values in f32: the same
# tolerances. K5 (conv3d_same) is held in bf16 steps: both round an f32 sum
# of the same exact bf16 products once to bf16, in another order, so each
# output is equal or one bf16 step (2^-8 relative) away; near 0, where the
# f32 rounding of a cancelling sum can exceed a step of the tiny result,
# the step is taken at K5_FLOOR of the largest output.
TOL = {"normals_moments": 1e-5, "scatter_mean": 1e-5, "corner_gather": 1e-6,
       "corner_scatter": 1e-5, "conv3d_same": 1.0}
K5_FLOOR = 2.0 ** -8
# The bench model's convolutions at b = 2·16 clouds, r = 32: (cin, cout).
K5_SHAPES = ((71, 64), (64, 64), (64, 128), (128, 128))
# K5 at every other r the kernel takes and at couts that are no multiple
# of 64: (b, r, cin, cout), held within one bf16 step like the above.
K5_OTHER_SHAPES = ((4, 16, 64, 64), (2, 64, 64, 128), (1, 128, 64, 64), (4, 32, 64, 96),
                   (4, 32, 71, 40))
# Clouds past the model's 1024 points: (b, n). 16384 exceeds
# K1_SHARED_POINTS, the largest cloud K1 stages in one block's shared
# memory (csrc/normals_moments.cu; K2 and K4 keep none there), so it runs
# K1's streaming path; K1's plain version there goes LARGE_QUERY_CHUNK
# queries at a time.
LARGE_CLOUDS = ((2, 2048), (2, 5000), (1, 16384))
K1_SHARED_POINTS = 12288
LARGE_QUERY_CHUNK = 2048
# K2 and K4 on degenerate clouds of DEGENERATE_POINTS points (b = 1):
# every point in one voxel, and every index -1. They are held against the
# plain versions on the CPU, which add a voxel's entries in the kernels'
# order (the card's index_add_ would add these 16384 or 131072 terms of
# one voxel in atomic order), under the same TOL.
DEGENERATE_POINTS = 16384
# K2 and K4 at the other resolutions the model takes: (r, b).
OTHER_R = ((16, 2), (64, 2), (128, 1))
# Calls between two events for the back-to-back and device-only times.
B2B_CALLS = 20
# dev_ms queues its calls behind torch.cuda._sleep for twice their host
# enqueue time plus DEV_SLEEP_MARGIN_S, at DEV_SLEEP_CYCLES_PER_S (at or
# above the H100's top SM clock, so the sleep lasts at least that long).
DEV_SLEEP_MARGIN_S = 1e-3
DEV_SLEEP_CYCLES_PER_S = 2.0e9
# K1 on clouds built to be hard, (case, b, n, k, r²), each with its
# neighbour counts equal to the plain version's: "duplicates" is the CPU
# tests' cloud (20 copies of point 0, >= k points at distance 0: the empty
# bracket rule, and a 1e-4 cluster); "shell" puts hundreds of points at
# nearly one small distance from a few queries, so the bracket left by the
# 32 bisection steps holds several values and its min is not the exact
# k-th smallest (the replay must give the bracket's answer); k >= n and
# k > 32 (no lane-minimum threshold) take the select's other branches;
# n = 2048 takes the large-cloud kernel, where the shell's 600 candidates
# overflow its list.
K1_HARD = (("duplicates", 2, 1024, 16, 0.01), ("duplicates", 1, 2048, 16, 0.01),
           ("shell", 2, 1024, 16, 1e-6), ("shell", 1, 2048, 16, 1e-6),
           ("shell", 1, 2048, 40, 1e-6), ("k = n", 2, 1024, 1024, 0.01),
           ("k > n", 2, 10, 16, 0.01), ("k > n", 1, 2048, 3000, 0.01),
           ("k > 32", 2, 1024, 40, 0.01))
# K3 on shapes off the main path, (case, c, grid type): c = 67 (no whole
# 16-byte vectors: the scalar tail), c = 40 (10 f32 or 5 bf16 vectors a
# row), and a grid or index pointer 4 or 8 bytes off 16-byte alignment
# (the scalar tail, the scalar staging).
K3_OTHER = (("c=67", 67, "f32"), ("c=67", 67, "bf16"), ("c=40", 40, "f32"),
            ("c=40", 40, "bf16"), ("misaligned grid", 64, "f32"),
            ("misaligned indices", 64, "f32"))
# register_batch with the flagship on clouds of ShapeNet's 2048 points.
LARGE_PAIRS, LARGE_POINTS = 4, 2048
# K4 against K3: <K4(dout), grid> and <dout, K3(grid)> (sums in f64 of the
# f32 kernel outputs) within 1e-5 relative.
ADJOINT_TOL = 1e-5
# End-to-end parity, card vs CPU: share of points whose feature differs by
# more than 1e-3 of the largest feature (a one-ulp change in a voxel
# boundary or a ball-query radius test moves single points) <= 1%; share of
# mutual-NN mask entries that agree >= 0.99. Poses, for every pair whose
# pose the inputs determine: within 1e-3 (max abs entry) for Kabsch on the
# card at the CPU run's final GNC weights, for GNC-TLS on the same matches,
# and end to end where the masks agree. A pair is not determined when
# GNC-TLS on the CPU moves its pose by more than 1e-3 once the matches are
# nudged by 1e-6 (about 10 ulps): with one or two inliers (random weights)
# the optimum is not unique, and rounding picks the fixed point on either
# device. At least half of the pairs must be determined. Residuals, for
# every pair: over the matches both runs share, the card pose's TLS cost
# Σ min(r², c²)/c² may exceed the CPU pose's by at most 1 (one match's
# worth): both must be equally good TLS solutions.
FEAT_POINT_TOL, FEAT_POINT_SHARE = 1e-3, 0.01
MASK_AGREE = 0.99
# The bf16 bench model, card vs CPU (the same code; the sums of K2, K5 and
# the bf16 GEMMs run in another order, and a one-step bf16 difference at
# any layer travels on): share of points whose feature differs by more than
# 2e-2 of the largest feature <= 1%, and mutual-NN agreement >= 0.95. On
# the CPU the port and the reference, both bf16, differ by at most 9.2e-3
# of the largest feature at small widths, and bf16 rounding alone moves
# about 4% of the mutual-NN decisions of a random-weight model (the
# reference's bf16 run against its f32 run). Poses: the f32 rules above.
FEAT_POINT_TOL_BF16, FEAT_POINT_SHARE_BF16 = 2e-2, 0.01
MASK_AGREE_BF16 = 0.95
TRANSFORM_TOL = 1e-3
NUDGE, NUDGE_TRIES = 1e-6, 4
TLS_COST_SLACK = 1.0

# Training: the mn40_sph_pt_r4 preset on a small split. train() takes
# TRAIN_LOOP_STEPS steps of TRAIN_BATCH clouds and one validation pass with
# the registration probe (reg_probe_interval 1: the preset's 16 noise
# pairs of 1024 points, PROBE_LAUNCHES); then TRAIN_STEPS steps on one
# fixed batch.
TRAIN_BATCH = 16
TRAIN_ITEMS = {"train": 64, "valid": 16, "test": 16}
TRAIN_LOOP_STEPS = 4
TRAIN_STEPS = 10
# Kernel launches per training step (two PVConv blocks) and per eval batch,
# and per registration batch of the f32 flagship and the bf16 bench model
# (two PVConv blocks of two convolutions each).
STEP_LAUNCHES = {"scatter_mean": 2, "corner_gather": 2, "corner_scatter": 2}
EVAL_LAUNCHES = {"scatter_mean": 2, "corner_gather": 2}
REGISTER_LAUNCHES = {"normals_moments": 1, "scatter_mean": 2, "corner_gather": 2}
PROBE_LAUNCHES = REGISTER_LAUNCHES  # the probe: normals, one 2b forward, mutual NN, GNC-TLS
BENCH_LAUNCHES = {"normals_moments": 1, "scatter_mean": 2, "corner_gather": 2,
                  "conv3d_same": 4}
# The flagship's registration evaluation (train/loop.py:evaluate_registration)
# runs the mn40_sph_pt_r4 preset's evaluate section as it is: 100 noise
# pairs of 1024 points, 64 a batch (the tail padded), teaserpp, flip
# hypotheses (one [5b, n, 6] forward a batch) and canonical voxels. Kernel
# launches per batch; the run makes one warm-up batch and ceil(100/64)
# timed ones.
EVALUATE_LAUNCHES = {"normals_moments": 1, "scatter_mean": 2, "corner_gather": 2}
# Card vs CPU on the first EVAL_PARITY_PAIRS pairs of a staged batch
# (EVAL_PARITY): features of every hypothesis and of the targets under
# FEAT_POINT_TOL and FEAT_POINT_SHARE; the same hypothesis wherever the
# CPU's top rigidity score leads the runner-up by more than SCORE_MARGIN of
# the top (the mutual-NN masks agree on >= MASK_AGREE of the points, and a
# match that changes moves a score by at most twice its share: 2%), and
# mutual-NN agreement >= MASK_AGREE where the hypotheses agree. TEASER on
# the card on the CPU run's matches: kept sets agree on >= MASK_AGREE of
# the matches (a compatibility test within rounding of 2·noise_bound may
# flip); poses within TRANSFORM_TOL where a NUDGE of the matches leaves the
# CPU's TEASER pose in place (end to end where the matches are the same),
# and everywhere the card pose's TLS cost over the matches both keep at
# most TLS_COST_SLACK above the CPU pose's.
EVAL_PARITY_PAIRS = 4
SCORE_MARGIN = 0.05
# The reference's recommended registration preset, run unchanged by
# evaluate_registration: reg_noise (cube trunk, dgcnn_kernel, 4 global-PPF
# channels, reference LRF; 'ransac+picp' with 1000 hypotheses, inlier
# threshold 0.08, 3 IRLS steps; 100 noise pairs of 1024 points, 64 a batch;
# flips and canonical voxels). Kernel launches per batch: K1 on the 2b
# clouds and on the b targets ('+picp's normals), K2 and K3 twice.
REG_PRESET = "reg_noise"
REG_LAUNCHES = {"normals_moments": 2, "scatter_mean": 2, "corner_gather": 2}
# Card vs CPU on the first EVAL_PARITY_PAIRS pairs of a staged reg_noise
# batch (reg_parity), on the card's RANSAC samples: features, hypotheses
# and mutual-NN agreement by the EVAL_PARITY rules; where the matches are
# the same, RANSAC's scores on the same samples, and its winner equal
# wherever the scores are (the first maximum; a residual on the 0.08
# threshold may round a score apart, and then the card's winner scores
# within one inlier of the CPU's best on the CPU). Poses, RANSAC's and the
# '+picp' pose after it, each: the solver on the CPU run's matches and
# samples on the card within TRANSFORM_TOL of the CPU's, and end to end
# where the matches and the winner are the same, on every pair whose CPU
# pose a NUDGE of the targets leaves within TRANSFORM_TOL (REG_NUDGE_TRIES
# tries). RANSAC's pose must be determined on at least half of the pairs;
# the '+picp' pose need not be: with random weights the matches are noise,
# RANSAC's start is arbitrary, and from it ICP's nearest neighbours flip
# under the nudge (by 1.7 on a pair of a CPU run at 256 points).
REG_NUDGE_TRIES = 2
# The recommended ICL-NUIM preset, run unchanged through the command line
# (`cli.main(["evaluate", "--preset", ICL_PRESET, "--ckpt", DIR])`):
# reg_icl_nuim (the trunk of reg_noise; 'ransac+picp' with 4000
# hypotheses, inlier threshold 0.07, noise bound 0.05; 100 adjacent-scan
# pairs of the synthetic indoor sequence, 1024 points, 64 a batch; flips,
# canonical voxels). The same launches per batch as reg_noise, the same
# staged batch and parity rules (reg_parity on 4 scan pairs); no method
# sweep.
ICL_PRESET = "reg_icl_nuim"
# The method sweep (SWEEP): all 13 names on SWEEP_PAIRS pairs' consensus
# matches, each finite; on the first SWEEP_CPU_PAIRS of them, card vs CPU
# within TRANSFORM_TOL where SWEEP_NUDGE_TRIES nudges leave the CPU pose in
# place, with at least SWEEP_MIN_DETERMINED of the pairs determined: 'fgr'
# on the same matches (64 fixed smooth iterations), 'icp' from the
# identity (pairs turned by up to 360 degrees land in arbitrary local
# minima: no minimum), and refine_pose's '+icp', '+picp' and '+pl' from one
# init, the ground truth turned by SWEEP_INIT_DEG degrees and shifted by
# SWEEP_INIT_SHIFT, as a recovered RANSAC start. The point-to-plane step is
# no contraction along a surface's free directions (the reference's too,
# tests/test_torch_solvers.py), so '+picp' and '+pl' need one pair only
# (2 of 4 were determined in a CPU run at 256 points). The CPU's
# solvers are slow at 1024 points (seconds an ICP of 4 pairs), hence the
# few pairs and nudges.
SWEEP_PAIRS, SWEEP_CPU_PAIRS, SWEEP_NUDGE_TRIES = 16, 4, 1
SWEEP_INIT_DEG, SWEEP_INIT_SHIFT = 2.0, 0.02
SWEEP_MIN_DETERMINED = {"fgr": 0.5, "icp": 0.0, "+icp": 0.5, "+picp": 0.25, "+pl": 0.25}
# Card vs CPU, one step on PARITY_CLOUDS clouds from the same weights:
# loss within 1e-3 relative; BN running statistics within 1e-3 of each
# buffer's largest value; per parameter, the gradients' cosine >= 0.999
# where the gradient's norm is at least GRAD_NORM_FLOOR of the largest
# parameter gradient's norm. Below that floor a gradient is cancellation
# with no direction to compare: a bias in front of a train-mode BatchNorm
# has an exact gradient of 0, and so, nearly, has a BN bias whose channel a
# later BatchNorm centres (norms 1e-9..3e-6 of the largest at this width).
# Those are held by |card - CPU| <= GRAD_DIFF_TOL of the largest norm
# instead, and each is printed with its norm and cosine.
PARITY_CLOUDS = 4
LOSS_RTOL, STATS_RTOL = 1e-3, 1e-3
GRAD_COS, GRAD_NORM_FLOOR, GRAD_DIFF_TOL = 0.999, 1e-4, 1e-5
# bf16 training: `cli train --preset mn40_sph_dg` (the reference's default
# training preset: spherical, dgcnn_kernel, reference LRF, local PPF,
# blocks 64/128/256/512) with the bf16 model, its synthetic split cut to
# TRAIN_ITEMS, one epoch of TRAIN_LOOP_STEPS steps of TRAIN_BATCH clouds;
# then TRAIN_STEPS steps on one fixed batch. Validation runs the bf16 eval
# model: K5 for its 4 convolutions (BF16_EVAL_LAUNCHES a batch); training
# runs cuDNN's bf16 Conv3d and K2/K3/K4 as STEP_LAUNCHES.
BF16_PRESET = "mn40_sph_dg"
BF16_OVERRIDES = ["model.dtype=bfloat16", f"train.batch_size={TRAIN_BATCH}",
                  f"train.steps_per_epoch={TRAIN_LOOP_STEPS}", "optim.num_epochs=1",
                  f"dataset.synthetic_items={TRAIN_ITEMS!r}"]
BF16_EVAL_LAUNCHES = {"scatter_mean": 2, "corner_gather": 2, "conv3d_same": 4}
# bf16 step, card vs CPU (BF16_PARITY), one step on PARITY_CLOUDS clouds
# from the same weights, dropout off, beside the CPU's f32 step from those
# weights, the function both bf16 steps approximate (tests/test_torch_train
# .py's rule: bf16 gradients of this model miss the f32 ones by a large
# share of their norm, so each is held to be as accurate as the other).
# Per parameter whose f32 gradient has a norm of at least BF16_FLOOR of the
# largest: |card - f32| within BF16_RATIO times |CPU bf16 - f32| plus
# BF16_SLACK of |f32|; below the floor |card - f32| within BF16_ZERO_TOL of
# the largest norm. The loss within BF16_LOSS_RTOL of the CPU's. Updated
# parameters: Adam's first step moves an element by ±lr from the sign of
# its gradient, so within 2.1 lr everywhere and within SETTLED_PARAM_TOL
# where the two gradients agree within SETTLED of the CPU's.
BF16_FLOOR, BF16_RATIO, BF16_SLACK, BF16_ZERO_TOL = 5e-2, 1.5, 0.05, 0.05
BF16_LOSS_RTOL = 1e-2
SETTLED, SETTLED_PARAM_TOL = 1e-2, 2e-5
# ops/sampling.furthest_point_sample on the card, [TRAIN_BATCH, NUM_POINTS,
# 3] -> FPS_SAMPLES indices, equal to the CPU's.
FPS_SAMPLES = 512
# `cli evaluate-cls --ckpt DIR --sweep` on the bf16 checkpoint, the test
# split restored to the preset's 128 items: the test split, the hard tier
# (512 points), the 6 sweep levels (32 clouds a batch), and CLS_ROTATIONS
# (the command's default) forwards of 64 clouds for the rotation meter;
# K2, K3, K5 as BF16_EVAL_LAUNCHES a forward. Parity: the logits of the
# first CLS_PARITY_CLOUDS test clouds, card vs CPU (K5 against its plain
# version at every layer: each bf16 output within one bf16 step), within
# CLS_LOGIT_TOL of the largest logit; predictions equal wherever the CPU's
# top-2 margin exceeds that.
CLS_OVERRIDES = ["dataset.synthetic_items={'train': 16, 'valid': 16, 'test': 128}"]
CLS_ROTATIONS = 4
CLS_PARITY_CLOUDS = 8
CLS_LOGIT_TOL = 5e-2
# The data-parallel step on a one-rank NCCL group: bit-equal to the plain
# step, then DP_STEPS of each in turns for their ms/step.
DP_STEPS = 5
# Part segmentation: `cli train-seg --preset shapenet_seg` at the preset's
# full width (8 clouds x 2048 points, 22 channels, blocks 64/128 spherical
# r = 32 dgcnn_kernel without SE or coefficient, then 256 and 512; local
# PPF with k = 128; 50 parts) on the synthetic ShapeNet split (the
# reference's 128 train / 32 test items; the command line passes no data
# directory), cut to one epoch of SEG_LOOP_STEPS steps (SEG_OVERRIDES);
# its evaluation runs the 32 test items as one eval_batch_size batch. K2,
# K3, K4 launched STEP_LAUNCHES a step and K2, K3 EVAL_LAUNCHES an eval
# forward, as in the classifier (two PVConv blocks). Then TRAIN_STEPS
# steps on one fixed batch of its seeded model (as in 8), SEG_EVAL_CALLS
# timed eval forwards at 32 x 2048, and,
# card vs CPU on SEG_PARITY_CLOUDS test clouds from the same seeded
# weights: the eval logits (at most SEG_LOGIT_SHARE of the points differ by
# more than SEG_LOGIT_TOL of the largest logit — a ball-query radius test
# or a voxel boundary one ulp apart moves single points —, the median
# point within SEG_LOGIT_MEDIAN, the argmax equal at SEG_ARGMAX_SHARE of
# the points) and one train step, dropout off, by train_parity's rule.
SEG_PRESET = "shapenet_seg"
SEG_BATCH, SEG_POINTS, SEG_LOOP_STEPS = 8, 2048, 4
SEG_OVERRIDES = [f"train.steps_per_epoch={SEG_LOOP_STEPS}", "optim.num_epochs=1"]
SEG_EVAL_CALLS = 5
SEG_PARITY_CLOUDS = 2
SEG_LOGIT_TOL, SEG_LOGIT_SHARE, SEG_LOGIT_MEDIAN, SEG_ARGMAX_SHARE = 1e-3, 0.01, 1e-5, 0.99


def tls_cost(transform, src, dst, mask, noise_bound: float):
    """Σ over the masked matches of min(r², c²)/c² under each pose [b]."""
    import torch

    moved = src @ transform[..., :3, :3].transpose(-1, -2) + transform[..., None, :3, 3]
    r2 = ((moved - dst) ** 2).sum(-1) / noise_bound ** 2
    return torch.where(mask, torch.clamp(r2, max=1.0), torch.zeros_like(r2)).sum(-1)

# Multi-scan mapping, `cli map-sequence --preset MAP_PRESET` unchanged, then
# with each of MAP_RUNS' overrides. K1 runs once per feature chunk of
# MAP_CHUNK scans (extract_features_flips) and, with '+picp', once per edge
# batch of MAP_EDGE_BATCH in each of the 2 registration passes (the
# targets' normals); K2 and K3 twice per chunk's 4-flip forward.
MAP_PRESET = "reg_icl_nuim_teaserpp_cu_dg"
# (label, path in the kernels line, overrides); the second call is warm.
MAP_RUNS = (("teaserpp", "map_sequence", []),
            ("teaserpp, warm", "map_sequence_warm", []),
            ("ransac+picp", "map_sequence_ransac_picp", ["evaluate.method=ransac+picp"]),
            ("96 scans", "map_sequence_96", ["sequence.num_scans=96"]))
MAP_CHUNK, MAP_EDGE_BATCH, MAP_LOOP_STRIDE = 16, 16, 6
# map parity: the pipeline on oracle features, card vs CPU, within MAP_TOL
# (measurements, graph and BA poses, ATEs; tests/test_torch_sequence.py's
# tolerance against the reference); the two solves on the CPU run's own
# inputs within SOLVE_TOL of the largest pose entry.
MAP_TOL, SOLVE_TOL = 1e-3, 1e-5
# The method sweep through the command line, from a seeded checkpoint of
# SWEEP_PRESET (the cube trunk, 100 noise pairs of 1024 points, 64 a batch,
# flips, canonical voxels). K1 on the 2b clouds and, for '+picp', on the b
# targets; K2 and K3 twice: SWEEP_LAUNCHES a batch.
SWEEP_PRESET = "reg_noise_teaserpp_cu_dg"
SWEEP_METHODS = ("ransac", "fgr", "teaserpp", "ransac+picp")
SWEEP_LAUNCHES = {"normals_moments": 2, "scatter_mean": 2, "corner_gather": 2}


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {time.perf_counter() - t0:.3f} s  {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of fn() after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(sorted(times)[len(times) // 2])


def b2b_ms(fn, calls: int = B2B_CALLS) -> float:
    """Device ms per call of `calls` back-to-back calls of fn() between two
    CUDA events, with no synchronize between them, after one warm-up: the
    device time without each call's host enqueue (which cuda_time_ms
    includes)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def dev_ms(fn, calls: int = B2B_CALLS) -> float:
    """Device ms per call of `calls` calls of fn() queued behind
    torch.cuda._sleep, after one warm-up. The sleep lasts twice their
    measured host enqueue time (plus a margin), so every call is queued
    before the card reaches the first: the two events around them time the
    device alone, even for a call shorter than its enqueue, where b2b_ms
    times the host's enqueue rate. Fails if the sleep ended before the last
    call was queued, at each of 3 lengths."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int((2 * host_s + DEV_SLEEP_MARGIN_S) * DEV_SLEEP_CYCLES_PER_S))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        covered = not start.query()  # the card was still asleep when the last call was queued
        end.synchronize()
        if covered:
            return start.elapsed_time(end) / calls
        host_s *= 4
    fail("dev_ms: the sleep ended before the calls were queued, at 3 lengths")
    return 0.0


def short(t) -> list:
    """A tensor's values at 3 significant digits, for the log."""
    return [float(f"{float(x):.3g}") for x in t]


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error over the largest |want|)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def bf16_step(t):
    """The spacing of bf16 numbers (8 significant bits) at |t|, f64."""
    import torch

    _, e = torch.frexp(t.abs().double())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float64), e - 8)


def seeded_model(seed: int, model=None):
    """`model`, by default the flagship model (PVCNNClassifier's defaults
    are the configuration of checkpoints/mn40_sph_pt_r4), with weights and
    BN statistics drawn from a seeded torch.Generator (BN means around 0,
    variances in [0.5, 1.5])."""
    import torch

    from rift_tpu_torch.models import PVCNNClassifier

    model = PVCNNClassifier() if model is None else model
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("coefficient"):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
            elif ".bn" in name or ".bns." in name:
                base = 1.0 if name.endswith("weight") else 0.0
                p.copy_(base + 0.1 * (torch.rand(p.shape, generator=gen) - 0.5))
            elif p.dim() > 1:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) * math.sqrt(2.0 / fan_in))
            else:
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.2 * (torch.rand(buf.shape, generator=gen) - 0.5))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    return model.eval()


def check_kernels(clouds, report: dict) -> None:
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from rift_tpu_torch.ops.cuda import normals_kernel as nk
    from rift_tpu_torch.ops.cuda import onehot_ops as oh
    from rift_tpu_torch.ops.spherical import (normalize_coords_sphere,
                                              spherical_corner_weights,
                                              spherical_voxel_indices)

    dev = clouds.device
    b, n, _ = clouds.shape
    r = 32
    s = r ** 3
    gen = torch.Generator(device=dev).manual_seed(1)

    # K1 at [2B, 1024, 3], k = 16, r² = 0.01.
    k, r2 = 16, 0.01
    got = nk.neighborhood_moments(clouds, k, r2)
    want = nk.neighborhood_moments_plain(clouds, k, r2)
    torch.cuda.synchronize()
    if not torch.equal(got[2], want[2]):
        fail(f"K1 neighbour counts differ at {int((got[2] != want[2]).sum())} queries")
    e1 = rel_err(torch.cat([g.reshape(b, n, -1) for g in got[:2]], -1),
                 torch.cat([w.reshape(b, n, -1) for w in want[:2]], -1))[1]
    abs1 = max(rel_err(got[0], want[0])[0], rel_err(got[1], want[1])[0])
    total_nbrs = float(want[2].sum())
    # The function's least work: per (query, point) d² 9 operations, one
    # step of an exact selection and the radius test; 22 per neighbour for
    # the 13 moments. (The bisection's own work, the earlier bound: d² 9,
    # 32 steps x (compare, add), the bracket min 3 and the mask 1.) Unfused
    # f32 operations run at most at half of PEAK_F32_FLOP_PER_S, which
    # counts a fused multiply-add as two.
    flops = b * n * n * (9 + 1 + 1) + 22 * total_nbrs
    bisection_flops = b * n * n * (9 + 64 + 3 + 1) + 22 * total_nbrs
    bytes_ = b * n * 3 * 4 + b * n * 13 * 4
    report["normals_moments"] = dict(
        source="rift_tpu_torch/csrc/normals_moments.cu",
        replaces="rift_tpu/ops/pallas/normals_kernel.py:40",
        shapes=f"points [{b},{n},3] k={k}",
        max_abs_err=abs1, max_rel_err=e1, tol=TOL["normals_moments"],
        ms=cuda_time_ms(lambda: nk.neighborhood_moments(clouds, k, r2)),
        dev_ms=dev_ms(lambda: nk.neighborhood_moments(clouds, k, r2)),
        plain_ms=cuda_time_ms(lambda: nk.neighborhood_moments_plain(clouds, k, r2)),
        flops=flops, bytes=bytes_, library_ms=None, library_dev_ms=None,
        bisection_bound_ms=bisection_flops / PEAK_F32_FLOP_PER_S * 1e3,
        neighbours_per_query=total_nbrs / (b * n))

    # K2 at c = 67 and c = 64 over the clouds' spherical voxel indices.
    norm = normalize_coords_sphere(clouds)
    inds, _ = spherical_voxel_indices(norm, r)
    inds32 = inds.to(torch.int32)
    valid = inds >= 0
    trash = torch.where(valid, inds, torch.full_like(inds, s))
    flat = (trash + torch.arange(b, device=dev)[:, None] * (s + 1)).reshape(-1)
    k2 = dict(max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
              b2b_ms=0.0, library_b2b_ms=0.0, dev_ms=0.0, library_dev_ms=0.0, bytes=0,
              flops=0, bit_equal=True)
    for c in (67, 64):
        feat = torch.randn((b, n, c), generator=gen, device=dev)
        out, cnt = oh.scatter_mean(feat, inds32, s)
        again = oh.scatter_mean(feat, inds32, s)
        want_out, want_cnt = oh.scatter_mean_plain(feat, inds, s)
        torch.cuda.synchronize()
        if not torch.equal(cnt, want_cnt):
            fail(f"K2 counts differ at c={c}")
        if not (torch.equal(out, again[0]) and torch.equal(cnt, again[1])):
            fail(f"K2 is not deterministic: two calls differ at c={c}")
        a, rel = rel_err(out, want_out)
        k2["max_abs_err"] = max(k2["max_abs_err"], a)
        k2["max_rel_err"] = max(k2["max_rel_err"], rel)
        k2["ms"] += cuda_time_ms(lambda: oh.scatter_mean(feat, inds32, s))
        k2["b2b_ms"] += b2b_ms(lambda: oh.scatter_mean(feat, inds32, s))
        k2["dev_ms"] += dev_ms(lambda: oh.scatter_mean(feat, inds32, s))
        k2["plain_ms"] += cuda_time_ms(lambda: oh.scatter_mean_plain(feat, inds, s))
        rows = feat.reshape(b * n, c)

        def library():  # one PyTorch call: index_reduce_ 'mean' into a trash row
            return torch.zeros((b * (s + 1), c), device=dev).index_reduce_(
                0, flat, rows, "mean", include_self=False)

        lib_out = library().reshape(b, s + 1, c)[:, :s]
        if rel_err(lib_out, want_out)[1] > TOL["scatter_mean"]:
            fail("K2 library yardstick disagrees with the plain version")
        k2["library_ms"] += cuda_time_ms(library)
        k2["library_b2b_ms"] += b2b_ms(library)
        k2["library_dev_ms"] += dev_ms(library)
        k2["bytes"] += b * n * c * 4 + b * n * 4 + b * s * c * 4 + b * s * 4
        k2["flops"] += int(valid.sum()) * c + b * s * c
    # The bf16 model's inputs (c = 71 and 64), and indices s and s + 1 in
    # cloud 0, which must drop out as -1 does.
    k2["bf16"] = dict(max_rel_err=0.0, ms=0.0, b2b_ms=0.0, dev_ms=0.0, plain_ms=0.0)
    for c in (71, 64):
        feat = torch.randn((b, n, c), generator=gen, device=dev).to(torch.bfloat16)
        out, cnt = oh.scatter_mean(feat, inds32, s)
        again = oh.scatter_mean(feat, inds32, s)
        want_out, want_cnt = oh.scatter_mean_plain(feat, inds, s)
        torch.cuda.synchronize()
        if out.dtype != torch.float32 or not torch.equal(cnt, want_cnt):
            fail(f"K2 on bf16 features: type {out.dtype}, counts equal "
                 f"{torch.equal(cnt, want_cnt)} at c={c}")
        if not (torch.equal(out, again[0]) and torch.equal(cnt, again[1])):
            fail(f"K2 on bf16 features is not deterministic: two calls differ at c={c}")
        k2["bf16"]["max_rel_err"] = max(k2["bf16"]["max_rel_err"], rel_err(out, want_out)[1])
        k2["bf16"]["ms"] += cuda_time_ms(lambda: oh.scatter_mean(feat, inds32, s))
        k2["bf16"]["b2b_ms"] += b2b_ms(lambda: oh.scatter_mean(feat, inds32, s))
        k2["bf16"]["dev_ms"] += dev_ms(lambda: oh.scatter_mean(feat, inds32, s))
        k2["bf16"]["plain_ms"] += cuda_time_ms(lambda: oh.scatter_mean_plain(feat, inds, s))
    k2["max_rel_err"] = max(k2["max_rel_err"], k2["bf16"]["max_rel_err"])
    far = inds32.clone()
    far[0, :2] = torch.tensor([s, s + 1], device=dev)
    out, cnt = oh.scatter_mean(feat, far, s)
    want_out, want_cnt = oh.scatter_mean_plain(feat, far, s)
    torch.cuda.synchronize()
    k2["far_rel_err"] = rel_err(out, want_out)[1]
    if not torch.equal(cnt, want_cnt) or k2["far_rel_err"] > TOL["scatter_mean"]:
        fail(f"K2 on indices s, s + 1: counts equal {torch.equal(cnt, want_cnt)}, "
             f"rel err {k2['far_rel_err']:.3e}")
    report["scatter_mean"] = dict(
        source="rift_tpu_torch/csrc/voxel_ops.cu",
        replaces="rift_tpu/ops/pallas/onehot_ops.py:44",
        shapes=f"features [{b},{n},67] and [{b},{n},64] -> [{b},{s},c] (f32; bf16 "
               f"[{b},{n},71] and [{b},{n},64] in 'bf16')",
        tol=TOL["scatter_mean"], **k2)

    # K3 at c = 64 and c = 128 with the clouds' corner indices (int64, as
    # spherical_corner_weights gives them and the path passes them) and
    # weights; the same call on int32 indices must give the same bits.
    idx, w = spherical_corner_weights(norm, inds, r)
    idx32 = idx.to(torch.int32)
    touched = int(torch.unique((idx + torch.arange(b, device=dev)[:, None, None] * s)
                               [idx >= 0]).numel())
    k3 = dict(max_abs_err=0.0, max_rel_err=0.0, ms=0.0, dev_ms=0.0, plain_ms=0.0,
              library_ms=0.0, library_dev_ms=0.0, int32_dev_ms=0.0, bytes=0, flops=0)
    bag_idx = (torch.clamp(idx, min=0) + torch.arange(b, device=dev)[:, None, None] * s
               ).reshape(-1)
    bag_w = torch.where(idx >= 0, w, torch.zeros_like(w)).reshape(-1)
    offsets = torch.arange(0, b * n * 8, 8, device=dev)
    for c in (64, 128):
        grid = torch.randn((b, s, c), generator=gen, device=dev)
        out = oh.corner_gather(grid, idx, w)
        out32 = oh.corner_gather(grid, idx32, w)
        want_out = oh.corner_gather_plain(grid, idx, w)
        torch.cuda.synchronize()
        if not torch.equal(out, out32):
            fail(f"K3 at c={c}: int64 and int32 indices give different bits")
        a, rel = rel_err(out, want_out)
        k3["max_abs_err"] = max(k3["max_abs_err"], a)
        k3["max_rel_err"] = max(k3["max_rel_err"], rel)
        k3["ms"] += cuda_time_ms(lambda: oh.corner_gather(grid, idx, w))
        k3["dev_ms"] += dev_ms(lambda: oh.corner_gather(grid, idx, w))
        k3["int32_dev_ms"] += dev_ms(lambda: oh.corner_gather(grid, idx32, w))
        k3["plain_ms"] += cuda_time_ms(lambda: oh.corner_gather_plain(grid, idx, w))
        table = grid.reshape(b * s, c)

        def library():  # one PyTorch call: a weighted-sum embedding bag
            return F.embedding_bag(bag_idx, table, offsets, mode="sum",
                                   per_sample_weights=bag_w)

        if rel_err(library().reshape(b, n, c), want_out)[1] > 1e-5:
            fail("K3 library yardstick disagrees with the plain version")
        k3["library_ms"] += cuda_time_ms(library)
        k3["library_dev_ms"] += dev_ms(library)
        # Grid rows this run's corners touch, once each; indices, weights
        # and the output once.
        k3["bytes"] += touched * c * 4 + b * n * 8 * (idx.element_size() + 4) + b * n * c * 4
        k3["flops"] += int((idx >= 0).sum()) * c * 2
    k3["bf16"] = dict(max_rel_err=0.0, ms=0.0, dev_ms=0.0, plain_ms=0.0)
    for c in (64, 128):
        grid = torch.randn((b, s, c), generator=gen, device=dev).to(torch.bfloat16)
        out = oh.corner_gather(grid, idx, w)
        out32 = oh.corner_gather(grid, idx32, w)
        want_out = oh.corner_gather_plain(grid, idx, w)
        torch.cuda.synchronize()
        if out.dtype != torch.float32 or not torch.equal(out, out32):
            fail(f"K3 on a bf16 grid wrote {out.dtype}; int64 and int32 indices equal "
                 f"{torch.equal(out, out32)}")
        k3["bf16"]["max_rel_err"] = max(k3["bf16"]["max_rel_err"], rel_err(out, want_out)[1])
        k3["bf16"]["ms"] += cuda_time_ms(lambda: oh.corner_gather(grid, idx, w))
        k3["bf16"]["dev_ms"] += dev_ms(lambda: oh.corner_gather(grid, idx, w))
        k3["bf16"]["plain_ms"] += cuda_time_ms(lambda: oh.corner_gather_plain(grid, idx, w))
    k3["max_rel_err"] = max(k3["max_rel_err"], k3["bf16"]["max_rel_err"])
    # Indices s, s + 1 and -1 drop out: two corners of point 0, all of
    # point 1 (s + 1) and of point 2 (-1), one of point 3.
    far = idx.clone()
    far[0, 0, :2] = torch.tensor([s, s + 1], device=dev)
    far[0, 1, :] = s + 1
    far[0, 2, :] = -1
    far[0, 3, 3] = -1
    out = oh.corner_gather(grid, far, w)
    want_out = oh.corner_gather_plain(grid, far, w)
    torch.cuda.synchronize()
    k3["far_rel_err"] = rel_err(out, want_out)[1]
    if k3["far_rel_err"] > TOL["corner_gather"] or bool(out[0, 1:3].any()):
        fail(f"K3 on indices s, s + 1, -1: rel err {k3['far_rel_err']:.3e}, "
             f"dropped rows zero {not bool(out[0, 1:3].any())}")
    k3["other"] = check_corner_gather_other(idx, w, s, gen)
    report["corner_gather"] = dict(
        source="rift_tpu_torch/csrc/voxel_ops.cu",
        replaces="rift_tpu/ops/pallas/onehot_ops.py:101",
        shapes=f"grid [{b},{s},64] and [{b},{s},128], corners [{b},{n},8] int64 (f32; the "
               f"same shapes bf16 in 'bf16')",
        tol=TOL["corner_gather"], **k3)

    # K4 at the training batch (the first TRAIN_BATCH clouds), c = 64 and
    # c = 128, over the same corners; undefined points give idx = -1 rows.
    bt = TRAIN_BATCH
    idx4, w4 = idx[:bt], w[:bt]
    idx4_32 = idx4.to(torch.int32)
    valid4 = idx4 >= 0
    rows4 = (torch.where(valid4, idx4, torch.full_like(idx4, bt * s))
             + torch.where(valid4, torch.arange(bt, device=dev)[:, None, None] * s,
                           torch.zeros_like(idx4))).reshape(-1)
    w4_masked = torch.where(valid4, w4, torch.zeros_like(w4))
    k4 = dict(max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
              b2b_ms=0.0, library_b2b_ms=0.0, dev_ms=0.0, library_dev_ms=0.0, bytes=0, flops=0,
              adjoint_rel_err=0.0,
              bit_equal=True, skipped_rows=int((~valid4).all(-1).sum()))
    for c in (64, 128):
        dout = torch.randn((bt, n, c), generator=gen, device=dev)
        got = oh.corner_scatter(dout, idx4_32, w4, s)
        again = oh.corner_scatter(dout, idx4_32, w4, s)
        want_out = oh.corner_scatter_plain(dout, idx4, w4, s)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"K4 is not deterministic: two calls differ at c={c}")
        a, rel = rel_err(got, want_out)
        k4["max_abs_err"] = max(k4["max_abs_err"], a)
        k4["max_rel_err"] = max(k4["max_rel_err"], rel)
        grid = torch.randn((bt, s, c), generator=gen, device=dev)
        lhs = float((got.double() * grid.double()).sum())
        rhs = float((dout.double() * oh.corner_gather(grid, idx4_32, w4).double()).sum())
        k4["adjoint_rel_err"] = max(k4["adjoint_rel_err"], abs(lhs - rhs) / abs(rhs))
        k4["ms"] += cuda_time_ms(lambda: oh.corner_scatter(dout, idx4_32, w4, s))
        k4["b2b_ms"] += b2b_ms(lambda: oh.corner_scatter(dout, idx4_32, w4, s))
        k4["dev_ms"] += dev_ms(lambda: oh.corner_scatter(dout, idx4_32, w4, s))
        k4["plain_ms"] += cuda_time_ms(lambda: oh.corner_scatter_plain(dout, idx4, w4, s))

        def library():  # w·dout rows, then index_add_ into a flat grid with a trash row
            rows = (w4_masked[..., None] * dout[:, :, None, :]).reshape(-1, c)
            return torch.zeros((bt * s + 1, c), device=dev).index_add_(0, rows4, rows)

        if rel_err(library()[:bt * s].reshape(bt, s, c), want_out)[1] > TOL["corner_scatter"]:
            fail("K4 library yardstick disagrees with the plain version")
        k4["library_ms"] += cuda_time_ms(library)
        k4["library_b2b_ms"] += b2b_ms(library)
        k4["library_dev_ms"] += dev_ms(library)
        # dout, corner indices and weights read once; the dense dgrid written once.
        k4["bytes"] += bt * n * c * 4 + bt * n * 8 * 8 + bt * s * c * 4
        k4["flops"] += int(valid4.sum()) * c * 2
    # At one channel the dense write is 1/64 of the c = 64 one: what is left
    # is mostly each block's pass over the cloud's corner list and its
    # grouping of the kept entries.
    dout1 = torch.randn((bt, n, 1), generator=gen, device=dev)
    k4["one_channel_ms"] = cuda_time_ms(lambda: oh.corner_scatter(dout1, idx4_32, w4, s))
    if k4["adjoint_rel_err"] > ADJOINT_TOL:
        fail(f"K4 is not K3's adjoint: relative difference {k4['adjoint_rel_err']:.3e}")
    far = idx4_32.clone()
    far[0, 0, :2] = torch.tensor([s, s + 1], device=dev)
    far[0, 1, :] = s + 1
    got = oh.corner_scatter(dout, far, w4, s)
    want_out = oh.corner_scatter_plain(dout, far, w4, s)
    torch.cuda.synchronize()
    k4["far_rel_err"] = rel_err(got, want_out)[1]
    if k4["far_rel_err"] > TOL["corner_scatter"]:
        fail(f"K4 on indices s, s + 1: rel err {k4['far_rel_err']:.3e}")
    report["corner_scatter"] = dict(
        source="rift_tpu_torch/csrc/voxel_ops.cu",
        replaces="rift_tpu/ops/pallas/onehot_ops.py:155",
        shapes=f"dout [{bt},{n},64] and [{bt},{n},128], corners [{bt},{n},8] -> [{bt},{s},c] "
               f"({k4['skipped_rows']} rows of idx -1)",
        tol=TOL["corner_scatter"], **k4)

    check_conv3d(report)

    for name, rep in report.items():
        bound_bytes = rep["bytes"] / PEAK_BYTES_PER_S * 1e3
        bound_ops = rep["flops"] / rep.get("peak_flops", PEAK_F32_FLOP_PER_S) * 1e3
        rep["bound_ms"] = max(bound_bytes, bound_ops)
        rep["bound_by"] = "bytes" if bound_bytes >= bound_ops else "operations"
        held = rep.get("max_steps", rep["max_rel_err"])
        if held > rep["tol"]:
            fail(f"{name}: error {held:.3e} > {rep['tol']:.0e}")
        extra = ""
        if "adjoint_rel_err" in rep:
            extra += (f"; adjoint rel err {rep['adjoint_rel_err']:.3e} (tol {ADJOINT_TOL:g}), "
                      f"{rep['one_channel_ms']:.4f} ms at one channel")
        if "b2b_ms" in rep:
            extra += (f"; back to back: kernel {rep['b2b_ms']:.4f} ms, library "
                      f"{rep['library_b2b_ms']:.4f} ms; two calls bit-equal")
        if "bf16" in rep:
            extra += (f"; bf16 input: rel err {rep['bf16']['max_rel_err']:.3e}, kernel "
                      f"{rep['bf16']['ms']:.4f} ms"
                      + (f" ({rep['bf16']['b2b_ms']:.4f} back to back)" if "b2b_ms" in rep["bf16"]
                         else "") + f", plain {rep['bf16']['plain_ms']:.4f} ms")
        if "far_rel_err" in rep:
            extra += f"; indices s, s + 1: rel err {rep['far_rel_err']:.3e}"
        if "max_steps" in rep:
            extra += (f"; max {rep['max_steps']:.3f} bf16 steps (tol {rep['tol']:g}), "
                      f"bit-equal share {rep['equal_share']:.6f}, library max "
                      f"{rep['library_steps']:.3f} steps")
        if "bisection_bound_ms" in rep:
            extra += (f"; bisection's work {rep['bisection_bound_ms']:.4f} ms; "
                      f"{rep['neighbours_per_query']:.2f} neighbours a query")
        if "int32_dev_ms" in rep:
            extra += f"; int32 indices {rep['int32_dev_ms']:.4f} ms device only"
        if "bf16" in rep and "dev_ms" in rep["bf16"]:
            extra += f"; bf16 device only {rep['bf16']['dev_ms']:.4f} ms"
        tol = "" if "max_steps" in rep else f" (tol {rep['tol']:g})"
        print(f"  {name}: {rep['shapes']}: max abs err {rep['max_abs_err']:.3e}, "
              f"rel {rep['max_rel_err']:.3e}{tol}; kernel {rep['ms']:.4f} ms per call, "
              f"{rep['dev_ms']:.4f} device only, plain {rep['plain_ms']:.4f} ms, library "
              f"{rep['library_ms']} ms ({rep['library_dev_ms']} device only), bound "
              f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}), share of bound "
              f"{rep['bound_ms'] / rep['dev_ms']:.3f} device only{extra}", flush=True)


def check_corner_gather_other(idx, w, s: int, gen) -> list:
    """K3 at the K3_OTHER shapes (the tail path, vectors of 10 or 5 a row,
    misaligned pointers) on the main path's corners: within TOL of the
    plain version and bit-equal on int64 and int32 indices."""
    import torch

    from rift_tpu_torch.ops.cuda import onehot_ops as oh

    b = idx.shape[0]
    rows = []
    for case, c, kind in K3_OTHER:
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        grid = torch.randn((b, s, c), generator=gen, device=idx.device).to(dtype)
        i64 = idx
        if case == "misaligned grid":  # 4 bytes past a 16-byte boundary
            grid = torch.cat([grid.new_zeros(1), grid.reshape(-1)])[1:].view(b, s, c)
        if case == "misaligned indices":  # 8 bytes past a 16-byte boundary
            i64 = torch.cat([idx.new_zeros(1), idx.reshape(-1)])[1:].view(idx.shape)
        out = oh.corner_gather(grid, i64, w)
        out32 = oh.corner_gather(grid, i64.to(torch.int32), w)
        want = oh.corner_gather_plain(grid, i64, w)
        torch.cuda.synchronize()
        row = dict(case=case, c=c, grid=kind, max_rel_err=rel_err(out, want)[1],
                   int64_equals_int32=torch.equal(out, out32),
                   grid_offset=grid.data_ptr() % 16, index_offset=i64.data_ptr() % 16)
        print(f"    corner_gather {case} ({kind}, c={c}; pointer offsets {row['grid_offset']}, "
              f"{row['index_offset']} bytes): rel err {row['max_rel_err']:.3e} (tol "
              f"{TOL['corner_gather']:g}), int64 and int32 indices bit-equal "
              f"{row['int64_equals_int32']}", flush=True)
        if row["max_rel_err"] > TOL["corner_gather"] or not row["int64_equals_int32"]:
            fail(f"K3 {case}: {row}")
        rows.append(row)
    return rows


def check_large_clouds(report: dict) -> None:
    """K1, K2 and K4 against their plain versions on the LARGE_CLOUDS sizes
    (SyntheticPairs source clouds, seed 3): K1 neighbour counts equal, every
    error within TOL, K4 also K3's adjoint. Adds a "large" list to each
    kernel's report; then check_degenerate and check_other_r."""
    import torch

    from rift_tpu_torch.data import SyntheticPairs
    from rift_tpu_torch.ops.cuda import normals_kernel as nk
    from rift_tpu_torch.ops.cuda import onehot_ops as oh
    from rift_tpu_torch.ops.spherical import (normalize_coords_sphere,
                                              spherical_corner_weights,
                                              spherical_voxel_indices)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    r, k, r2, c = 32, 16, 0.01, 64
    s = r ** 3
    for name in ("normals_moments", "scatter_mean", "corner_scatter"):
        report[name]["large"] = []
    for b, n in LARGE_CLOUDS:
        pts = torch.as_tensor(SyntheticPairs(num_pairs=b, num_points=n, mode="noise",
                                             seed=3).arrays()[0], device=dev)
        got = nk.neighborhood_moments(pts, k, r2)
        want = nk.neighborhood_moments_plain(pts, k, r2, query_chunk=LARGE_QUERY_CHUNK)
        torch.cuda.synchronize()
        if not torch.equal(got[2], want[2]):
            fail(f"K1 at b={b}, n={n}: neighbour counts differ at "
                 f"{int((got[2] != want[2]).sum())} queries")
        e1 = max(rel_err(got[0], want[0])[1], rel_err(got[1], want[1])[1])
        del want
        report["normals_moments"]["large"].append(dict(
            b=b, n=n, max_rel_err=e1,
            ms=cuda_time_ms(lambda: nk.neighborhood_moments(pts, k, r2), reps=5),
            dev_ms=dev_ms(lambda: nk.neighborhood_moments(pts, k, r2))))

        norm = normalize_coords_sphere(pts)
        inds, _ = spherical_voxel_indices(norm, r)
        idx, w = spherical_corner_weights(norm, inds, r)
        inds = inds.clone()
        inds[0, :3] = torch.tensor([s, s + 1, -1], device=dev)
        inds32 = inds.to(torch.int32)
        feat = torch.randn((b, n, c), generator=gen, device=dev)
        out, cnt = oh.scatter_mean(feat, inds32, s)
        want_out, want_cnt = oh.scatter_mean_plain(feat, inds, s)
        torch.cuda.synchronize()
        if not torch.equal(cnt, want_cnt):
            fail(f"K2 at b={b}, n={n}: counts differ")
        report["scatter_mean"]["large"].append(dict(
            b=b, n=n, max_rel_err=rel_err(out, want_out)[1],
            ms=cuda_time_ms(lambda: oh.scatter_mean(feat, inds32, s), reps=5),
            dev_ms=dev_ms(lambda: oh.scatter_mean(feat, inds32, s))))

        idx = idx.clone()
        idx[0, 0, :2] = torch.tensor([s, s + 1], device=dev)
        idx32 = idx.to(torch.int32)
        dout = torch.randn((b, n, c), generator=gen, device=dev)
        got4 = oh.corner_scatter(dout, idx32, w, s)
        want4 = oh.corner_scatter_plain(dout, idx, w, s)
        grid = torch.randn((b, s, c), generator=gen, device=dev)
        lhs = float((got4.double() * grid.double()).sum())
        rhs = float((dout.double() * oh.corner_gather(grid, idx32, w).double()).sum())
        torch.cuda.synchronize()
        report["corner_scatter"]["large"].append(dict(
            b=b, n=n, max_rel_err=rel_err(got4, want4)[1], adjoint_rel_err=abs(lhs - rhs) / abs(rhs),
            ms=cuda_time_ms(lambda: oh.corner_scatter(dout, idx32, w, s), reps=5),
            dev_ms=dev_ms(lambda: oh.corner_scatter(dout, idx32, w, s))))
        for name in ("normals_moments", "scatter_mean", "corner_scatter"):
            row = report[name]["large"][-1]
            print(f"    {name} at b={b}, n={n}: rel err {row['max_rel_err']:.3e} (tol "
                  f"{TOL[name]:g}), kernel {row['ms']:.4f} ms ({row['dev_ms']:.4f} device only)"
                  + (f", adjoint {row['adjoint_rel_err']:.3e}" if name == "corner_scatter"
                     else ", counts equal"), flush=True)
            if row["max_rel_err"] > TOL[name] or row.get("adjoint_rel_err", 0.0) > ADJOINT_TOL:
                fail(f"{name} at b={b}, n={n}: {row}")
    check_k1_hard(report)
    check_degenerate(report)
    check_other_r(report)


def hard_cloud(case: str, b: int, n: int, seed: int):
    """A K1_HARD cloud [b, n, 3] f32 on the card, from numpy's seeded
    generator: uniform in [-1, 1]³, then "duplicates": points 1-20 copies of
    point 0, points 40-59 within 1e-4 of point 40 (the CPU tests' cloud);
    "shell": query 0 at the origin (so d² near it rounds on a fine grid)
    and 600 points around it at distance 0.01·(1 + 1e-6·u), u uniform in
    [-1, 1], in random directions: their d² lie within a few hundred ulps
    of 1e-4, inside one bisection bracket, with ties."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1.0, 1.0, (b, n, 3)).astype(np.float32)
    if case == "duplicates":
        pts[:, 1:21] = pts[:, :1]
        pts[:, 40:60] = pts[:, 40:41] + 1e-4 * rng.randn(b, 20, 3).astype(np.float32)
    elif case == "shell":
        u = rng.randn(b, 600, 3)
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        rho = 0.01 * (1.0 + 1e-6 * rng.uniform(-1.0, 1.0, (b, 600, 1)))
        pts[:, 0] = 0.0
        pts[:, 1:601] = (rho * u).astype(np.float32)
    return torch.as_tensor(pts, device="cuda")


def check_k1_hard(report: dict) -> None:
    """K1 on the K1_HARD clouds: neighbour counts equal to the plain
    version's, moments within TOL. Prints, for each, the queries whose
    exact k-th smallest d² differs from the bisection's bracket min (where
    the replay, not the selection alone, gives the answer). Adds a "hard"
    list to K1's report."""
    import torch

    from rift_tpu_torch.ops.cuda import normals_kernel as nk

    report["normals_moments"]["hard"] = []
    for seed, (case, b, n, k, r2) in enumerate(K1_HARD):
        pts = hard_cloud(case, b, n, seed)
        got = nk.neighborhood_moments(pts, k, r2)
        want = nk.neighborhood_moments_plain(pts, k, r2, query_chunk=LARGE_QUERY_CHUNK)
        d2 = nk.point_sqdist(pts[:, :LARGE_QUERY_CHUNK], pts)
        bisection = nk._hybrid_radius_sq(d2, k, r2)
        exact = torch.kthvalue(d2, min(k, n), dim=-1).values if k <= n else None
        torch.cuda.synchronize()
        replayed = (0 if exact is None else
                    int((torch.clamp(exact * torch.tensor(1.0 + 1e-6, device=pts.device),
                                     min=r2) != bisection).sum()))
        row = dict(case=case, b=b, n=n, k=k, radius_sq=r2,
                   counts_equal=torch.equal(got[2], want[2]),
                   max_rel_err=max(rel_err(got[0], want[0])[1], rel_err(got[1], want[1])[1]),
                   queries_where_exact_kth_differs=replayed,
                   mean_neighbours=float(want[2].mean()))
        print(f"    normals_moments on {case} (b={b}, n={n}, k={k}, r²={r2:g}): counts equal "
              f"{row['counts_equal']}, rel err {row['max_rel_err']:.3e} (tol "
              f"{TOL['normals_moments']:g}), {row['mean_neighbours']:.2f} neighbours a query; "
              f"r² from the exact k-th smallest differs from the bisection's at {replayed} of "
              f"the first {min(n, LARGE_QUERY_CHUNK) * b} queries", flush=True)
        if not row["counts_equal"]:
            fail(f"K1 on {case} (b={b}, n={n}, k={k}): neighbour counts differ at "
                 f"{int((got[2] != want[2]).sum())} queries")
        if row["max_rel_err"] > TOL["normals_moments"]:
            fail(f"K1 on {case}: {row}")
        report["normals_moments"]["hard"].append(row)


def check_degenerate(report: dict) -> None:
    """K2 (c = 67 and 64) and K4 (c = 64) on one cloud of DEGENERATE_POINTS
    points all in one voxel, and on one whose indices are all -1: two calls
    bit-equal, counts equal, within TOL of the plain version on the CPU,
    timed. Adds a "degenerate" list to both reports."""
    import torch

    from rift_tpu_torch.ops.cuda import onehot_ops as oh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    n, s = DEGENERATE_POINTS, 32 ** 3
    for name in ("scatter_mean", "corner_scatter"):
        report[name]["degenerate"] = []
    for case, voxel in (("one voxel", s // 2 + 16), ("all -1", -1)):
        inds = torch.full((1, n), voxel, dtype=torch.int32, device=dev)
        for c in (67, 64):
            feat = torch.randn((1, n, c), generator=gen, device=dev)
            out, cnt = oh.scatter_mean(feat, inds, s)
            again = oh.scatter_mean(feat, inds, s)
            want_out, want_cnt = oh.scatter_mean_plain(feat.cpu(), inds.cpu(), s)
            torch.cuda.synchronize()
            if not (torch.equal(out, again[0]) and torch.equal(cnt, again[1])):
                fail(f"K2 on {case}, c={c}: two calls differ")
            if not torch.equal(cnt.cpu(), want_cnt):
                fail(f"K2 on {case}, c={c}: counts differ")
            report["scatter_mean"]["degenerate"].append(dict(
                case=case, n=n, c=c, max_rel_err=rel_err(out.cpu(), want_out)[1],
                equal_to_plain=torch.equal(out.cpu(), want_out),
                ms=cuda_time_ms(lambda: oh.scatter_mean(feat, inds, s), reps=3)))
        idx = torch.full((1, n, 8), voxel, dtype=torch.int32, device=dev)
        w = torch.rand((1, n, 8), generator=gen, device=dev)
        dout = torch.randn((1, n, 64), generator=gen, device=dev)
        got = oh.corner_scatter(dout, idx, w, s)
        again = oh.corner_scatter(dout, idx, w, s)
        want = oh.corner_scatter_plain(dout.cpu(), idx.cpu(), w.cpu(), s)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"K4 on {case}: two calls differ")
        report["corner_scatter"]["degenerate"].append(dict(
            case=case, n=n, c=64, max_rel_err=rel_err(got.cpu(), want)[1],
            equal_to_plain=torch.equal(got.cpu(), want),
            ms=cuda_time_ms(lambda: oh.corner_scatter(dout, idx, w, s), reps=3)))
    for name in ("scatter_mean", "corner_scatter"):
        for row in report[name]["degenerate"]:
            print(f"    {name} on {row['case']} (b=1, n={n}, c={row['c']}): rel err "
                  f"{row['max_rel_err']:.3e} (tol {TOL[name]:g}), bit-equal to the plain "
                  f"version {row['equal_to_plain']}, kernel {row['ms']:.4f} ms", flush=True)
            if row["max_rel_err"] > TOL[name]:
                fail(f"{name} on {row['case']}: {row}")


def check_other_r(report: dict) -> None:
    """K2 (c = 67, counts equal) and K4 (c = 64, also K3's adjoint) against
    their plain versions at the OTHER_R resolutions, on SyntheticPairs
    clouds of NUM_POINTS (seed 4). Adds an "other_r" list to both
    reports."""
    import torch

    from rift_tpu_torch.data import SyntheticPairs
    from rift_tpu_torch.ops.cuda import onehot_ops as oh
    from rift_tpu_torch.ops.spherical import (normalize_coords_sphere,
                                              spherical_corner_weights,
                                              spherical_voxel_indices)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    for name in ("scatter_mean", "corner_scatter"):
        report[name]["other_r"] = []
    for r, b in OTHER_R:
        s = r ** 3
        pts = torch.as_tensor(SyntheticPairs(num_pairs=b, num_points=NUM_POINTS, mode="noise",
                                             seed=4).arrays()[0], device=dev)
        norm = normalize_coords_sphere(pts)
        inds, _ = spherical_voxel_indices(norm, r)
        idx, w = spherical_corner_weights(norm, inds, r)
        inds32, idx32 = inds.to(torch.int32), idx.to(torch.int32)
        feat = torch.randn((b, NUM_POINTS, 67), generator=gen, device=dev)
        out, cnt = oh.scatter_mean(feat, inds32, s)
        want_out, want_cnt = oh.scatter_mean_plain(feat, inds, s)
        torch.cuda.synchronize()
        if not torch.equal(cnt, want_cnt):
            fail(f"K2 at r={r}: counts differ")
        report["scatter_mean"]["other_r"].append(dict(
            r=r, b=b, c=67, max_rel_err=rel_err(out, want_out)[1],
            ms=cuda_time_ms(lambda: oh.scatter_mean(feat, inds32, s), reps=5)))
        del out, want_out
        dout = torch.randn((b, NUM_POINTS, 64), generator=gen, device=dev)
        got = oh.corner_scatter(dout, idx32, w, s)
        want = oh.corner_scatter_plain(dout, idx, w, s)
        grid = torch.randn((b, s, 64), generator=gen, device=dev)
        lhs = float((got.double() * grid.double()).sum())
        rhs = float((dout.double() * oh.corner_gather(grid, idx32, w).double()).sum())
        torch.cuda.synchronize()
        report["corner_scatter"]["other_r"].append(dict(
            r=r, b=b, c=64, max_rel_err=rel_err(got, want)[1],
            adjoint_rel_err=abs(lhs - rhs) / abs(rhs),
            ms=cuda_time_ms(lambda: oh.corner_scatter(dout, idx32, w, s), reps=5)))
        del got, want, grid
        for name in ("scatter_mean", "corner_scatter"):
            row = report[name]["other_r"][-1]
            print(f"    {name} at r={r} (s={s}), b={b}, c={row['c']}: rel err "
                  f"{row['max_rel_err']:.3e} (tol {TOL[name]:g}), kernel {row['ms']:.4f} ms"
                  + (f", adjoint {row['adjoint_rel_err']:.3e}" if name == "corner_scatter"
                     else ", counts equal"), flush=True)
            if row["max_rel_err"] > TOL[name] or row.get("adjoint_rel_err", 0.0) > ADJOINT_TOL:
                fail(f"{name} at r={r}: {row}")


def k5_held(gen, bx: int, rx: int, cin: int, cout: int):
    """K5 on a seeded x [bx, rx, rx, rx, cin] (laid out by `padded_bf16`, as
    the model gives it) and w [cout, cin, 3, 3, 3], against its plain
    version: (x, w, plain output f32, bf16 step per output, max bf16
    steps, bit-equal share, max abs error, max rel error)."""
    import torch

    from rift_tpu_torch.ops.cuda import conv3d as k5

    dev = torch.device("cuda")
    x = k5.padded_bf16(torch.randn((bx, rx, rx, rx, cin), generator=gen, device=dev))
    w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev)
         * math.sqrt(2.0 / (27 * cin))).to(torch.bfloat16)
    got = k5.conv3d_same(x, w)
    want = k5.conv3d_same_plain(x, w)
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16 or got.shape != want.shape:
        fail(f"K5 gave {got.dtype} {tuple(got.shape)}, expected bf16 {tuple(want.shape)}")
    want_f = want.float()
    step = bf16_step(torch.clamp(want_f.abs(), min=K5_FLOOR * float(want_f.abs().max())))
    steps = float(((got.float() - want_f).abs().double() / step).max())
    equal = float((got == want).double().mean())
    a, rel = rel_err(got.float(), want_f)
    return x, w, want_f, step, steps, equal, a, rel


def check_conv3d(report: dict) -> None:
    """K5 against its plain version at the bench model's four shapes, with
    cuDNN's bf16 Conv3d on channels_last_3d tensors as the yardstick, then
    at K5_OTHER_SHAPES. x is laid out as the model gives it to K5
    (`padded_bf16`: a voxel stride of 72 for 71 channels)."""
    import torch
    import torch.nn.functional as F

    from rift_tpu_torch.ops.cuda import conv3d as k5

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    b, r = 2 * NUM_PAIRS, 32
    rep = dict(source="rift_tpu_torch/csrc/conv3d.cu",
               replaces="scripts/conv3d_kernel_experiment.py:61",
               shapes=f"x [{b},{r},{r},{r},cin] bf16, (cin, cout) in {list(K5_SHAPES)}",
               tol=TOL["conv3d_same"], peak_flops=PEAK_BF16_FLOP_PER_S,
               max_abs_err=0.0, max_rel_err=0.0, max_steps=0.0, equal_share=1.0,
               library_steps=0.0, ms=0.0, dev_ms=0.0, plain_ms=0.0, library_ms=0.0,
               library_dev_ms=0.0, flops=0, bytes=0,
               per_shape=[], other_shapes=[])

    def held(bx, rx, cin, cout):
        return k5_held(gen, bx, rx, cin, cout)

    for cin, cout in K5_SHAPES:
        x, w, want_f, step, steps, equal, a, rel = held(b, r, cin, cout)
        xc = x.contiguous().permute(0, 4, 1, 2, 3)  # a channels_last_3d view of x
        wc = w.contiguous(memory_format=torch.channels_last_3d)

        def library():  # one PyTorch call: cuDNN's bf16 Conv3d, no bias
            return F.conv3d(xc, wc, padding=1)

        lib_steps = float(((library().permute(0, 2, 3, 4, 1).float() - want_f).abs().double()
                           / step).max())
        if lib_steps > 4:
            fail(f"K5 library yardstick is {lib_steps:.1f} bf16 steps from the plain version")
        del want_f, step
        shape = dict(cin=cin, cout=cout, max_steps=steps, equal_share=equal, max_abs_err=a,
                     max_rel_err=rel,
                     ms=cuda_time_ms(lambda: k5.conv3d_same(x, w)),
                     dev_ms=dev_ms(lambda: k5.conv3d_same(x, w)),
                     plain_ms=cuda_time_ms(lambda: k5.conv3d_same_plain(x, w)),
                     library_ms=cuda_time_ms(library), library_dev_ms=dev_ms(library),
                     flops=2 * 27 * r ** 3 * cin * cout * b,
                     bytes=b * r ** 3 * (cin + cout) * 2 + 27 * cin * cout * 2)
        shape["bound_ms"] = max(shape["flops"] / PEAK_BF16_FLOP_PER_S,
                                shape["bytes"] / PEAK_BYTES_PER_S) * 1e3
        shape["bound_share"] = shape["bound_ms"] / shape["ms"]
        print(f"    K5 {cin}->{cout}: max {steps:.3f} bf16 steps, bit-equal {equal:.6f}, max abs "
              f"err {a:.3e} (rel {rel:.3e}); kernel {shape['ms']:.4f} ms ({shape['dev_ms']:.4f} "
              f"device only, cuDNN {shape['library_dev_ms']:.4f}), bound "
              f"{shape['bound_ms']:.4f} ms, share of bound {shape['bound_share']:.3f}, cuDNN "
              f"bf16 {shape['library_ms']:.4f} ms ({lib_steps:.3f} steps), plain "
              f"{shape['plain_ms']:.4f} ms", flush=True)
        rep["per_shape"].append(shape)
        rep["library_steps"] = max(rep["library_steps"], lib_steps)
        for key in ("ms", "dev_ms", "plain_ms", "library_ms", "library_dev_ms", "flops", "bytes"):
            rep[key] += shape[key]
        for key, worst in (("max_steps", max), ("equal_share", min), ("max_abs_err", max),
                           ("max_rel_err", max)):
            rep[key] = worst(rep[key], shape[key])
    for bx, rx, cin, cout in K5_OTHER_SHAPES:
        x, w, _, _, steps, equal, a, rel = held(bx, rx, cin, cout)
        ms = cuda_time_ms(lambda: k5.conv3d_same(x, w), reps=5)
        print(f"    K5 b={bx} r={rx} {cin}->{cout}: max {steps:.3f} bf16 steps, bit-equal "
              f"{equal:.6f}; kernel {ms:.4f} ms", flush=True)
        rep["other_shapes"].append(dict(b=bx, r=rx, cin=cin, cout=cout, max_steps=steps,
                                        equal_share=equal, ms=ms))
        rep["max_steps"] = max(rep["max_steps"], steps)
    report["conv3d_same"] = rep


def path_stages(model, src, dst):
    """The stages of register_batch up to the matches: (normals, features,
    match indices into dst, mutual-NN mask)."""
    import torch

    from rift_tpu_torch.ops.neighbors import mutual_nearest_neighbors
    from rift_tpu_torch.ops.normals import estimate_normals
    from rift_tpu_torch.ops.precision import f32_geometry

    with torch.no_grad(), f32_geometry():
        clouds = torch.cat([src, dst], 0)
        normals = estimate_normals(clouds)
        feats = model(torch.cat([clouds, normals], -1))
        b = src.shape[0]
        _, idx2, mask = mutual_nearest_neighbors(feats[:b], feats[b:])
    return normals, feats, idx2, mask


def register_phase(model, src, dst, wrappers: dict, per_batch: dict,
                   timed: int = TIMED_BATCHES):
    """register_batch on the card: one warm-up and `timed` timed batches
    with every launch count set to 0 just before and read just after; each
    kernel must have launched per_batch[name] times a batch. Returns
    (transforms, median ms per batch, launch counts)."""
    import torch

    from rift_tpu_torch.registration import register_batch

    for fn in wrappers.values():
        fn.launches = 0
    est = register_batch(model, src, dst)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(timed):
        t1 = time.perf_counter()
        est = register_batch(model, src, dst)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = read_counts(wrappers)
    batches = timed + 1
    for name in wrappers:
        want = per_batch.get(name, 0) * batches
        if launches[name] != want:
            fail(f"{name} launched {launches[name]} times in {batches} batches, expected {want}")
    if not bool(torch.isfinite(est).all()) or tuple(est.shape) != (src.shape[0], 4, 4):
        fail(f"register_batch gave non-finite or misshapen transforms {tuple(est.shape)}")
    return est, sorted(times)[len(times) // 2] * 1e3, launches


def parity(model, src, dst, est, feat_tol: float, feat_share: float, mask_agree: float,
           pairs: int = PARITY_PAIRS) -> str:
    """The first `pairs` pairs of the timed batch against the same path
    with device="cpu", and GNC-TLS and Kabsch on the card against the CPU
    on the CPU run's matches (the tolerances are set out at the top)."""
    import torch

    from rift_tpu_torch.ops.precision import f32_geometry
    from rift_tpu_torch.registration import gnc_pose, register_batch, weighted_kabsch
    from rift_tpu_torch.registration.pipeline import NOISE_BOUND

    dev = src.device
    p, b = pairs, src.shape[0]
    cpu_model = copy.deepcopy(model).cpu()
    # Card side: the timed batch's shapes (16 pairs), sliced to the first p.
    n_g, f_g, idx_g, m_g = path_stages(model, src, dst)
    clouds = torch.cat([torch.arange(p), b + torch.arange(p)]).to(dev)
    n_g, f_g, t_g = n_g[clouds].cpu(), f_g[clouds].cpu(), est[:p].cpu()
    idx_g, m_g = idx_g[:p].cpu(), m_g[:p].cpu()
    src_c, dst_c = src[:p].cpu(), dst[:p].cpu()
    n_c, f_c, idx_c, m_c = path_stages(cpu_model, src_c, dst_c)
    t_c = register_batch(cpu_model, src_c, dst_c, device="cpu")
    # The solver alone on the CPU run's matches: on the card, and on the
    # CPU with the matches nudged, to find the pairs the inputs determine.
    matched_c = torch.gather(dst_c, 1, idx_c[..., None].expand(-1, -1, 3))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad(), f32_geometry():
        t_solver = gnc_pose(src[:p], matched_c.to(dev), m_c.to(dev),
                            noise_bound=NOISE_BOUND)[0].cpu()
        _, w_c = gnc_pose(src_c, matched_c, m_c, noise_bound=NOISE_BOUND)
        t_step = weighted_kabsch(src[:p], matched_c.to(dev), w_c.to(dev)).cpu()
        spread = torch.zeros(p)
        for _ in range(NUDGE_TRIES):
            nudged = matched_c + NUDGE * torch.randn(matched_c.shape, generator=gen)
            t_n = gnc_pose(src_c, nudged, m_c, noise_bound=NOISE_BOUND)[0]
            spread = torch.maximum(spread, (t_n - t_c).abs().amax((-2, -1)))
    determined = spread <= TRANSFORM_TOL
    normal_cos = float((n_g * n_c).sum(-1).abs().min())
    feat_abs, feat_rel = rel_err(f_g, f_c)
    point_err = (f_g - f_c).abs().amax(-1) / float(f_c.abs().max())
    bad_share = float((point_err > feat_tol).float().mean())
    agree = float((m_g == m_c).float().mean())
    same_mask = (m_g == m_c).all(-1)
    t_diff = (t_g - t_c).abs().amax((-2, -1))
    solver_diff = (t_solver - t_c).abs().amax((-2, -1))
    step_diff = (t_step - t_c).abs().amax((-2, -1))
    shared = m_g & m_c & (idx_g == idx_c)
    cost_c = tls_cost(t_c, src_c, matched_c, shared, NOISE_BOUND)
    cost_g = tls_cost(t_g, src_c, matched_c, shared, NOISE_BOUND)
    cost_solver_c = tls_cost(t_c, src_c, matched_c, m_c, NOISE_BOUND)
    cost_solver_g = tls_cost(t_solver, src_c, matched_c, m_c, NOISE_BOUND)
    worse = torch.maximum(cost_g - cost_c, cost_solver_g - cost_solver_c)
    msg = (f"{p} pairs: min |cos| between normals {normal_cos:.6f}; features max abs err "
           f"{feat_abs:.3e} (rel {feat_rel:.3e}), median point err {float(point_err.median()):.3e}"
           f", share of points off by > {feat_tol:g} {bad_share:.4f} (tol {feat_share}); "
           f"mutual-NN agreement {agree:.4f} (tol {mask_agree}); transform max abs diff, Kabsch "
           f"at the CPU's GNC weights {short(step_diff)}, GNC-TLS on "
           f"the same matches {short(solver_diff)}, end to end "
           f"{short(t_diff)} (tol {TRANSFORM_TOL}; CPU pose spread "
           f"under a {NUDGE:g} nudge {short(spread)}, determined "
           f"{determined.tolist()}, masks agree {same_mask.tolist()}, CPU GNC inliers "
           f"{(w_c > 0.5).sum(-1).tolist()} of {m_c.sum(-1).tolist()} matches); TLS "
           f"cost over shared matches, card minus CPU, end to end "
           f"{short(cost_g - cost_c)}, solver "
           f"{short(cost_solver_g - cost_solver_c)} (tol {TLS_COST_SLACK})")
    if bad_share > feat_share or agree < mask_agree or not bool(torch.isfinite(t_c).all()):
        fail("parity: " + msg)
    if int(determined.sum()) * 2 < p or bool((worse > TLS_COST_SLACK).any()) \
            or bool((step_diff[determined] > TRANSFORM_TOL).any()) \
            or bool((solver_diff[determined] > TRANSFORM_TOL).any()) \
            or bool((t_diff[determined & same_mask] > TRANSFORM_TOL).any()):
        fail("parity: " + msg)
    return msg


def stage_split(model, src, dst) -> dict:
    """One batch of register_batch's stages, each ended by a synchronize:
    wall ms of normals, features, mutual NN and GNC-TLS."""
    import torch

    from rift_tpu_torch.ops.neighbors import mutual_nearest_neighbors
    from rift_tpu_torch.ops.normals import estimate_normals
    from rift_tpu_torch.ops.precision import f32_geometry
    from rift_tpu_torch.registration import gnc_pose
    from rift_tpu_torch.registration.pipeline import NOISE_BOUND

    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t1) * 1e3
        return result

    b = src.shape[0]
    with torch.no_grad(), f32_geometry():
        clouds = torch.cat([src, dst], 0)
        normals = timed("normals", lambda: estimate_normals(clouds))
        feats = timed("features", lambda: model(torch.cat([clouds, normals], -1)))
        _, idx2, mask = timed("mutual NN",
                              lambda: mutual_nearest_neighbors(feats[:b], feats[b:]))
        matched = torch.gather(dst, 1, idx2[..., None].expand(-1, -1, 3))
        timed("GNC-TLS", lambda: gnc_pose(src, matched, mask, noise_bound=NOISE_BOUND))
    out["total"] = sum(out.values())
    return out


# --- The flagship's registration evaluation (train/loop.py) ---------------


def eval_checkpoint(ckpt_dir: str, preset: str = "mn40_sph_pt_r4", seed: int = 0):
    """The preset's model (the flagship's classifier by default) with seeded
    weights, saved by the port's CheckpointManager as `common` in
    `ckpt_dir` (with the preset as its config snapshot): the checkpoint
    evaluate_registration restores from train.ckpt_dir. Returns the preset
    with that train.ckpt_dir."""
    import torch

    from rift_tpu_torch.train import build_model, create_state, get_config
    from rift_tpu_torch.train.checkpoint import CheckpointManager

    cfg = get_config(preset)
    cfg.train.ckpt_dir = ckpt_dir
    state = create_state(build_model(cfg), cfg, 1, torch.device("cpu"), seed=seed)
    seeded_model(seed, state.model)
    CheckpointManager(ckpt_dir).save_common(state, {}, cfg)
    return cfg


def run_stage(name: str, fn, cuda: bool, timed: dict | None, sync_free: bool = False):
    """fn() as one stage of a staged batch: on the card, ended by a
    synchronize (and begun after one), and, when `sync_free`, run under sync
    debug mode "error", where a host sync inside it (an .item(), a bool() of
    a tensor, a copy of constants from the host) fails the run. Its wall ms
    is added to `timed` under `name` when given."""
    import torch

    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if cuda and sync_free:
        torch.cuda.set_sync_debug_mode("error")
    try:
        result = fn()
    except RuntimeError as e:
        if cuda and sync_free and "synchroniz" in str(e):
            fail(f"the {name} stage synchronized with the host: {e}")
        raise
    finally:
        if cuda and sync_free:
            torch.cuda.set_sync_debug_mode("default")
    if cuda:
        torch.cuda.synchronize()
    if timed is not None:
        timed[name] = timed.get(name, 0.0) + (time.perf_counter() - t1) * 1e3
    return result


def eval_stages(model, src, dst, noise_bound: float, timed: dict | None = None) -> dict:
    """register_eval_batch on b pairs, split at its stages: the shipped
    functions it composes, called in its order, each stage ended by a
    synchronize and its wall ms added to `timed` when given: normals,
    flip_features (the [5b, n, 6] forward), consensus (hypothesis_matches,
    whose rigidity scores the parity rule reads, and choose_hypothesis,
    which consensus_match composes), then teaser_pose's core
    (compatibility_core), rotation (_tim_pose) and polish (gnc_pose).
    The metrics are the caller's. Returns the intermediate tensors."""
    import torch

    from rift_tpu_torch.ops.neighbors import gather_rows
    from rift_tpu_torch.ops.normals import estimate_normals
    from rift_tpu_torch.ops.precision import f32_geometry
    from rift_tpu_torch.registration import (choose_hypothesis, compatibility_core, gnc_pose,
                                             hypothesis_matches)
    from rift_tpu_torch.registration.gnc import _tim_pose
    from rift_tpu_torch.train.loop import flip_features

    def stage(name, fn, sync_free=False):
        return run_stage(name, fn, src.device.type == "cuda", timed, sync_free)

    b, n = src.shape[:2]
    with torch.no_grad(), f32_geometry():
        clouds = torch.cat([src, dst], 0)
        normals = stage("normals", lambda: estimate_normals(clouds))
        x = torch.cat([clouds, normals], -1)
        feats = stage("forward 5b", lambda: flip_features(model, x, b))
        f_src_h, f_dst = feats[:4 * b].reshape(b, 4, n, -1), feats[4 * b:]

        def consensus():
            hyp = hypothesis_matches(src, dst, f_src_h, f_dst, tau=2.0 * noise_bound)
            return hyp[3], choose_hypothesis(*hyp)

        scores, (i1, i2, mask, h) = stage("consensus", consensus, sync_free=True)
        s_src, s_dst = gather_rows(src, i1), gather_rows(dst, i2)
        keep, deg = stage("TEASER core",
                          lambda: compatibility_core(s_src, s_dst, mask, noise_bound),
                          sync_free=True)
        init = stage("TEASER rotation", lambda: _tim_pose(s_src, s_dst, keep, deg, noise_bound),
                     sync_free=True)
        transform, _ = stage("TEASER polish", lambda: gnc_pose(
            s_src, s_dst, keep, noise_bound=noise_bound, init_transform=init))
    return dict(normals=normals, feats=feats, scores=scores, h=h, i1=i1, i2=i2, mask=mask,
                keep=keep, transform=transform)


def eval_phase(wrappers: dict) -> dict:
    """evaluate_registration of the mn40_sph_pt_r4 preset, its evaluate
    section unchanged, on the card from a seeded checkpoint; then one batch
    of batch_pairs pairs timed (median of TIMED_BATCHES), profiled and
    staged (the stages of eval_stages, per-batch launches checked), its
    parity with the CPU, and K2 and K3 at the 5b forward's shapes."""
    import torch

    from rift_tpu_torch.data import get_pairs
    from rift_tpu_torch.registration import pair_errors
    from rift_tpu_torch.train import evaluate_registration, resolve_extractor
    from rift_tpu_torch.train.loop import register_eval_batch

    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = eval_checkpoint(ckpt_dir)
        ev = cfg.evaluate
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        results = evaluate_registration(cfg)  # device=None: the card
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = read_counts(wrappers)
        batches = 1 + -(-ev.num_pairs // ev.batch_pairs)  # the warm-up and the timed ones
        for name in wrappers:
            want = EVALUATE_LAUNCHES.get(name, 0) * batches
            if launches[name] != want:
                fail(f"evaluate_registration: {name} launched {launches[name]} times in "
                     f"{batches} batches, expected {want}")
        if not all(math.isfinite(v) for v in results.values()):
            fail(f"evaluate_registration gave non-finite results {results}")
        model = resolve_extractor(cfg)
    if not model.use_new_coords_for_voxel or model.head is not None:
        fail("the restored extractor does not voxelize in the canonical frame")

    dev = torch.device("cuda")
    batch = next(get_pairs(ev.pairs_path, ev.num_points, ev.pairs_mode,
                           ev.num_pairs).batches(ev.batch_pairs))
    src, dst, gt = (torch.as_tensor(a, device=dev)
                    for a in (batch.source, batch.target, batch.transform))
    times = []
    for _ in range(TIMED_BATCHES):
        t1 = time.perf_counter()
        est = register_eval_batch(model, src, dst, ev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    ms = sorted(times)[len(times) // 2] * 1e3
    profile = profile_step(lambda: register_eval_batch(model, src, dst, ev))
    split: dict = {}
    before = read_counts(wrappers)
    stages = eval_stages(model, src, dst, ev.noise_bound, timed=split)
    after = read_counts(wrappers)
    per_batch = {k: after[k] - before[k] for k in after}
    if any(per_batch[k] != EVALUATE_LAUNCHES.get(k, 0) for k in per_batch):
        fail(f"staged batch: launches {per_batch}, expected {EVALUATE_LAUNCHES}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    errs = pair_errors(src, gt, stages["transform"])
    torch.cuda.synchronize()
    split["metrics"] = (time.perf_counter() - t1) * 1e3
    split["total"] = sum(split.values())
    staged_diff = float((stages["transform"] - est).abs().max())
    if not torch.equal(stages["transform"], est):  # the split times register_eval_batch itself
        fail(f"the staged batch's poses differ from register_eval_batch's by {staged_diff:.3e}")
    parity_msg = eval_parity(model, src, dst, stages, ev.noise_bound)
    kernels = eval_kernel_times(model, src, dst)
    return dict(results=results, run_s=run_s, peak_gb=peak_gb, launches=launches,
                batches=batches, ms_per_batch=ms, batch_pairs=ev.batch_pairs, split=split,
                per_batch=per_batch, staged_diff=staged_diff, parity=parity_msg, profile=profile,
                kernels=kernels, median_rre=float(errs["rre"].median()))


def eval_parity(model, src, dst, stages: dict, noise_bound: float,
                pairs: int = EVAL_PARITY_PAIRS) -> str:
    """The first `pairs` pairs of the staged batch against eval_stages on
    the CPU (a copy of the model), and TEASER on the card against the CPU
    on the CPU run's matches, under the rules at the top (EVAL_PARITY)."""
    import torch

    from rift_tpu_torch.ops.precision import f32_geometry
    from rift_tpu_torch.registration import compatibility_core, teaser_pose

    p, b = pairs, src.shape[0]
    cpu_model = copy.deepcopy(model).cpu()
    src_c, dst_c = src[:p].cpu(), dst[:p].cpu()
    c = eval_stages(cpu_model, src_c, dst_c, noise_bound)
    # Card side, sliced to the same clouds: the sources' 4 hypotheses and
    # the targets.
    clouds = torch.cat([torch.arange(4 * p), 4 * b + torch.arange(p)]).to(src.device)
    f_g = stages["feats"][clouds].cpu()
    g = {k: stages[k][:p].cpu() for k in ("scores", "h", "i2", "mask", "keep", "transform")}
    point_err = (f_g - c["feats"]).abs().amax(-1) / float(c["feats"].abs().max())
    bad_share = float((point_err > FEAT_POINT_TOL).float().mean())
    top2 = torch.topk(c["scores"].double(), 2, dim=-1).values
    lead = (top2[:, 0] - top2[:, 1]) / top2[:, 0].clamp(min=1.0)
    decided = lead > SCORE_MARGIN
    same_h = g["h"] == c["h"]
    same = same_h & (g["mask"] == c["mask"]).all(-1) & (g["i2"] == c["i2"]).all(-1)
    agree = float((g["mask"] == c["mask"])[same_h].float().mean()) if bool(same_h.any()) else 1.0
    # TEASER alone on the CPU run's matches: on the card, and on the CPU with
    # the matches nudged, to find the pairs whose pose the matches determine.
    m_src = torch.gather(src_c, 1, c["i1"][..., None].expand(-1, -1, 3))
    m_dst = torch.gather(dst_c, 1, c["i2"][..., None].expand(-1, -1, 3))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad(), f32_geometry():
        t_solver = teaser_pose(m_src.to(src.device), m_dst.to(src.device),
                               c["mask"].to(src.device), noise_bound=noise_bound)[0].cpu()
        keep_solver = compatibility_core(m_src.to(src.device), m_dst.to(src.device),
                                         c["mask"].to(src.device), noise_bound)[0].cpu()
        spread = torch.zeros(p)
        for _ in range(NUDGE_TRIES):
            nudged = m_dst + NUDGE * torch.randn(m_dst.shape, generator=gen)
            t_n = teaser_pose(m_src, nudged, c["mask"], noise_bound=noise_bound)[0]
            spread = torch.maximum(spread, (t_n - c["transform"]).abs().amax((-2, -1)))
    determined = spread <= TRANSFORM_TOL
    keep_agree = float((keep_solver == c["keep"]).float().mean())
    solver_diff = (t_solver - c["transform"]).abs().amax((-2, -1))
    t_diff = (g["transform"] - c["transform"]).abs().amax((-2, -1))
    kept = keep_solver & c["keep"]
    worse_solver = (tls_cost(t_solver, m_src, m_dst, kept, noise_bound)
                    - tls_cost(c["transform"], m_src, m_dst, kept, noise_bound))
    shared = c["keep"] & g["keep"] & (g["i2"] == c["i2"]) & same_h[:, None]
    worse_e2e = (tls_cost(g["transform"], m_src, m_dst, shared, noise_bound)
                 - tls_cost(c["transform"], m_src, m_dst, shared, noise_bound))
    msg = (f"{p} pairs ({4 * p + p} clouds): features, share of points off by > "
           f"{FEAT_POINT_TOL:g} {bad_share:.4f} (tol {FEAT_POINT_SHARE}), median point err "
           f"{float(point_err.median()):.3e}; hypothesis card {g['h'].tolist()} CPU "
           f"{c['h'].tolist()}, CPU scores {c['scores'].tolist()} (lead "
           f"{short(lead)}, decided above {SCORE_MARGIN}: {decided.tolist()}); mutual-NN "
           f"agreement {agree:.4f} (tol {MASK_AGREE}), same matches {same.tolist()}; "
           f"TEASER on the CPU's matches: kept sets agree {keep_agree:.4f} (tol {MASK_AGREE}), "
           f"kept {c['keep'].sum(-1).tolist()}, transform max abs diff {short(solver_diff)}, "
           f"end to end {short(t_diff)} (tol {TRANSFORM_TOL}; CPU pose spread under a "
           f"{NUDGE:g} nudge {short(spread)}, determined {determined.tolist()}); TLS cost, "
           f"card minus CPU, solver {short(worse_solver)}, end to end {short(worse_e2e)} "
           f"(tol {TLS_COST_SLACK})")
    if bad_share > FEAT_POINT_SHARE or bool((~same_h & decided).any()) or agree < MASK_AGREE \
            or keep_agree < MASK_AGREE or not bool(torch.isfinite(c["transform"]).all()):
        fail("evaluate parity: " + msg)
    if bool((worse_solver > TLS_COST_SLACK).any()) or bool((worse_e2e > TLS_COST_SLACK).any()) \
            or bool((solver_diff[determined] > TRANSFORM_TOL).any()) \
            or bool((t_diff[determined & same] > TRANSFORM_TOL).any()):
        fail("evaluate parity: " + msg)
    return msg


def k1_row(clouds) -> dict:
    """K1 on `clouds` [B, n, 3] as estimate_normals calls it (k = 16,
    r² = 0.1²) against its plain version (neighbour counts equal, TOL),
    timed per call and on the device alone, with its bound."""
    import torch

    from rift_tpu_torch.ops.cuda import normals_kernel as nk

    k, r2 = 16, 0.1 * 0.1
    got = nk.neighborhood_moments(clouds, k, r2)
    want = nk.neighborhood_moments_plain(clouds, k, r2)
    torch.cuda.synchronize()
    cb, n = clouds.shape[:2]
    err = rel_err(torch.cat([g.reshape(cb, n, -1) for g in got[:2]], -1),
                  torch.cat([w.reshape(cb, n, -1) for w in want[:2]], -1))[1]
    if not torch.equal(got[2], want[2]) or err > TOL["normals_moments"]:
        fail(f"K1 at the evaluate shape [{cb},{n},3]: neighbour counts differ at "
             f"{int((got[2] != want[2]).sum())} queries, rel err {err:.3e}")
    # The least work, as in check_kernels: per (query, point) d² 9
    # operations, a step of an exact selection and the radius test; 22 per
    # neighbour for the 13 moments; the points read and the moments written.
    bound_ops = (cb * n * n * (9 + 1 + 1) + 22 * float(want[2].sum())) / PEAK_F32_FLOP_PER_S
    bound_bytes = (cb * n * 3 * 4 + cb * n * 13 * 4) / PEAK_BYTES_PER_S
    return dict(
        shape=f"points [{cb},{n},3] k={k}", max_rel_err=err,
        neighbours_per_query=float(want[2].float().mean()),
        ms=cuda_time_ms(lambda: nk.neighborhood_moments(clouds, k, r2), reps=5),
        dev_ms=dev_ms(lambda: nk.neighborhood_moments(clouds, k, r2), calls=5),
        bound_ms=max(bound_ops, bound_bytes) * 1e3,
        bound_by="operations" if bound_ops > bound_bytes else "bytes")


def eval_kernel_times(model, src, dst, targets_k1: bool = False) -> dict:
    """K1, K2 and K3 at this path's shapes, against their plain versions
    (TOL), timed per call and on the device alone, with their bounds. K1 on
    the [2b, n, 3] clouds (`k1_row`), and with `targets_k1` also on the
    [b, n, 3] targets ('+picp's normals); K2 and K3 on the canonical
    coordinates of the [5b, n] clouds (each source under its 4 flips) in
    the model's voxel grid, spherical or cube, K2 at the two blocks' input
    widths and K3 at their output widths."""
    import torch

    from rift_tpu_torch.ops.cuda import onehot_ops as oh
    from rift_tpu_torch.ops.lrf import change_coords, lrf_basis, lrf_flip_hypotheses
    from rift_tpu_torch.ops.spherical import (normalize_coords_sphere,
                                              spherical_corner_weights,
                                              spherical_voxel_indices)
    from rift_tpu_torch.ops.voxelize import (cube_corner_weights, cube_voxel_indices,
                                             normalize_coords_cube)

    b = src.shape[0]
    clouds = torch.cat([src, dst], 0)
    rows = {"normals_moments": [k1_row(clouds)] + ([k1_row(dst)] if targets_k1 else []),
            "scatter_mean": [], "corner_gather": []}
    blocks = [model.layers[name] for name in model._backbone if name.startswith("PVConv")]
    r = blocks[0].resolution
    s = r ** 3
    with torch.no_grad():
        centred = clouds - clouds.mean(-2, keepdim=True)
        basis = lrf_basis(centred, model.lrf_kind)
        lrf_all = torch.cat([lrf_flip_hypotheses(basis[:b]).reshape(-1, 3, 3), basis[b:]], 0)
        pts = torch.cat([centred[:b].repeat_interleave(4, dim=0), centred[b:]], 0)
        canonical = change_coords(pts, lrf_all)
        if blocks[0].cube:
            grid_coords = normalize_coords_cube(canonical, r, normalize=blocks[0].normalize)
            inds = cube_voxel_indices(grid_coords, r)
            idx, w = cube_corner_weights(grid_coords, r)
        else:
            norm = normalize_coords_sphere(canonical)
            inds, _ = spherical_voxel_indices(norm, r)
            idx, w = spherical_corner_weights(norm, inds, r)
    bb, n = inds.shape
    gen = torch.Generator(device=src.device).manual_seed(5)
    touched = int(torch.unique((idx + torch.arange(bb, device=src.device)[:, None, None] * s)
                               [idx >= 0]).numel())
    for block in blocks:
        c_in, c_out = block.convs[0].in_channels, block.convs[0].out_channels
        feat = torch.randn((bb, n, c_in), generator=gen, device=src.device)
        out, cnt = oh.scatter_mean(feat, inds, s)
        want, want_cnt = oh.scatter_mean_plain(feat, inds, s)
        torch.cuda.synchronize()
        err = rel_err(out, want)[1]
        if not torch.equal(cnt, want_cnt) or err > TOL["scatter_mean"]:
            fail(f"K2 at the 5b shape [{bb},{n},{c_in}]: counts equal "
                 f"{torch.equal(cnt, want_cnt)}, rel err {err:.3e}")
        del out, cnt, want, want_cnt
        nbytes = bb * n * c_in * 4 + bb * n * 8 + bb * s * c_in * 4 + bb * s * 4
        rows["scatter_mean"].append(dict(
            shape=f"[{bb},{n},{c_in}] -> [{bb},{s},{c_in}]", max_rel_err=err,
            ms=cuda_time_ms(lambda: oh.scatter_mean(feat, inds, s), reps=5),
            dev_ms=dev_ms(lambda: oh.scatter_mean(feat, inds, s), calls=5),
            bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes"))
        del feat
        grid = torch.randn((bb, s, c_out), generator=gen, device=src.device)
        out = oh.corner_gather(grid, idx, w)
        want = oh.corner_gather_plain(grid, idx, w)
        torch.cuda.synchronize()
        err = rel_err(out, want)[1]
        if err > TOL["corner_gather"]:
            fail(f"K3 at the 5b shape [{bb},{s},{c_out}]: rel err {err:.3e}")
        del out, want
        nbytes = touched * c_out * 4 + bb * n * 8 * (idx.element_size() + 4) + bb * n * c_out * 4
        rows["corner_gather"].append(dict(
            shape=f"[{bb},{s},{c_out}] at [{bb},{n},8] -> [{bb},{n},{c_out}]", max_rel_err=err,
            ms=cuda_time_ms(lambda: oh.corner_gather(grid, idx, w), reps=5),
            dev_ms=dev_ms(lambda: oh.corner_gather(grid, idx, w), calls=5),
            bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes"))
        del grid
    for name, rs in rows.items():
        for row in rs:
            if "neighbours_per_query" in row:
                print(f"    normals_moments at {row['shape']}: "
                      f"{row['neighbours_per_query']:.2f} neighbours per query", flush=True)
            print(f"    {name} at the evaluate shape {row['shape']}: rel err "
                  f"{row['max_rel_err']:.3e} (tol {TOL[name]:g}); kernel {row['ms']:.4f} ms per "
                  f"call, {row['dev_ms']:.4f} device only, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}), share {row['bound_ms'] / row['dev_ms']:.3f}", flush=True)
    return rows


def reg_stages(model, src, dst, ev, generator=None, samples=None,
               timed: dict | None = None) -> dict:
    """register_eval_batch with a 'ransac+picp' evaluate section (the
    reg_noise preset's), split at its stages: the shipped functions it
    composes, in its order, each stage ended by a synchronize and its wall
    ms added to `timed` when given: normals, flip_features, consensus, then
    register_pair_from_matches' RANSAC (ransac_samples from `generator`,
    or the given `samples` [b, K, 3]; ransac_from_samples), and
    refine_pose's '+picp' (icp_pose, estimate_normals of the targets,
    icp_plane_pose with the 0.05 gate). On the card, the consensus, RANSAC
    and both ICPs run under sync debug mode "error". The metrics are the
    caller's. Returns the intermediate tensors."""
    import torch

    from rift_tpu_torch.ops.neighbors import gather_rows
    from rift_tpu_torch.ops.normals import estimate_normals
    from rift_tpu_torch.ops.precision import f32_geometry
    from rift_tpu_torch.registration import (choose_hypothesis, hypothesis_matches, icp_plane_pose,
                                             icp_pose, ransac_from_samples, ransac_samples)
    from rift_tpu_torch.train.loop import flip_features

    def stage(name, fn, sync_free=False):
        return run_stage(name, fn, src.device.type == "cuda", timed, sync_free)

    b, n = src.shape[:2]
    nb = ev.noise_bound
    with torch.no_grad(), f32_geometry():
        clouds = torch.cat([src, dst], 0)
        normals = stage("normals", lambda: estimate_normals(clouds))
        x = torch.cat([clouds, normals], -1)
        feats = stage("forward 5b", lambda: flip_features(model, x, b))
        f_src_h, f_dst = feats[:4 * b].reshape(b, 4, n, -1), feats[4 * b:]

        def consensus():
            hyp = hypothesis_matches(src, dst, f_src_h, f_dst, tau=2.0 * nb)
            return hyp[3], choose_hypothesis(*hyp)

        scores, (i1, i2, mask, h) = stage("consensus", consensus, sync_free=True)
        s_src, s_dst = gather_rows(src, i1), gather_rows(dst, i2)
        if samples is None:
            samples = stage("RANSAC sampling",
                            lambda: ransac_samples(mask, ev.num_hypotheses, generator),
                            sync_free=True)
        t_ransac, inliers, rscore = stage(
            "RANSAC scoring, refit, IRLS",
            lambda: ransac_from_samples(s_src, s_dst, mask, samples, ev.inlier_threshold,
                                        irls_iterations=ev.ransac_irls,
                                        irls_shrink=ev.ransac_irls_shrink), sync_free=True)
        t_icp = stage("ICP point-to-point", lambda: icp_pose(src, dst, init_transform=t_ransac),
                      sync_free=True)
        dst_normals = stage("normals of the targets", lambda: estimate_normals(dst))
        transform = stage("ICP point-to-plane", lambda: icp_plane_pose(
            src, dst, dst_normals, init_transform=t_icp, max_correspondence_distance=0.05),
            sync_free=True)
    return dict(feats=feats, scores=scores, h=h, i1=i1, i2=i2, mask=mask, samples=samples,
                rscore=rscore, t_ransac=t_ransac, t_icp=t_icp, transform=transform)


def run_cli_evaluate(preset: str, ckpt_dir: str) -> dict:
    """`python -m rift_tpu_torch.cli evaluate --preset P --ckpt DIR` in this
    process (device: the card, the CLI's default): its `key: value` lines
    as a dict."""
    import contextlib
    import io

    from rift_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main(["evaluate", "--preset", preset, "--ckpt", ckpt_dir])
    if code != 0:
        fail(f"cli evaluate --preset {preset} exited {code}: {out.getvalue()}")
    print(out.getvalue(), end="", flush=True)
    return {k: float(v) for k, v in (line.split(": ") for line in out.getvalue().splitlines())}


def reg_phase(wrappers: dict, preset: str = REG_PRESET, through_cli: bool = False,
              sweep: bool = True) -> dict:
    """evaluate_registration of a cube-trunk 'ransac+picp' preset unchanged
    (reg_noise by default: dgcnn_kernel, global PPF, reference LRF; 100
    noise pairs of 1024 points, 64 a batch; flips, canonical voxels) on the
    card from a seeded checkpoint, called directly or, `through_cli`, as
    the command line's `evaluate --ckpt`; then one batch timed (median of
    TIMED_BATCHES), profiled, staged (reg_stages: pose bit-equal to
    register_eval_batch's from the same generator state; per-batch launches
    checked), its parity with the CPU (reg_parity), with `sweep` every
    method name on 16 of its pairs (method_sweep), and K1, K2 and K3 at
    this path's shapes."""
    import torch

    from rift_tpu_torch.data import get_pairs
    from rift_tpu_torch.ops.neighbors import gather_rows
    from rift_tpu_torch.ops.precision import f32_geometry
    from rift_tpu_torch.registration import pair_errors, ransac_from_samples
    from rift_tpu_torch.train import evaluate_registration, resolve_extractor
    from rift_tpu_torch.train.loop import register_eval_batch

    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = eval_checkpoint(ckpt_dir, preset)
        ev = cfg.evaluate
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        # device=None / the CLI's default: the card
        results = (run_cli_evaluate(preset, ckpt_dir) if through_cli
                   else evaluate_registration(cfg))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = read_counts(wrappers)
        batches = 1 + -(-ev.num_pairs // ev.batch_pairs)  # the warm-up and the timed ones
        for name in wrappers:
            want = REG_LAUNCHES.get(name, 0) * batches
            if launches[name] != want:
                fail(f"evaluate {preset}: {name} launched {launches[name]} times in "
                     f"{batches} batches, expected {want}")
        if not all(math.isfinite(v) for v in results.values()):
            fail(f"evaluate {preset} gave non-finite results {results}")
        model = resolve_extractor(cfg)
    first = model.layers["PVConv_0"]
    if not (model.use_new_coords_for_voxel and first.cube and first.dgcnn and model.global_ppf):
        fail(f"the {preset} extractor is not the cube dgcnn trunk with global PPF and "
             "canonical voxels")

    dev = torch.device("cuda")
    batch = next(get_pairs(ev.pairs_path, ev.num_points, ev.pairs_mode,
                           ev.num_pairs).batches(ev.batch_pairs))
    src, dst, gt = (torch.as_tensor(a, device=dev)
                    for a in (batch.source, batch.target, batch.transform))
    gen = torch.Generator(device=dev)
    times = []
    for _ in range(TIMED_BATCHES):
        gen.manual_seed(cfg.seed)
        t1 = time.perf_counter()
        est = register_eval_batch(model, src, dst, ev, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    ms = sorted(times)[len(times) // 2] * 1e3
    profile = profile_step(lambda: register_eval_batch(model, src, dst, ev,
                                                       gen.manual_seed(cfg.seed)))
    split: dict = {}
    before = read_counts(wrappers)
    stages = reg_stages(model, src, dst, ev, gen.manual_seed(cfg.seed), timed=split)
    after = read_counts(wrappers)
    per_batch = {k: after[k] - before[k] for k in after}
    if any(per_batch[k] != REG_LAUNCHES.get(k, 0) for k in per_batch):
        fail(f"staged {preset} batch: launches {per_batch}, expected {REG_LAUNCHES}")
    # RANSAC's own peak over what is allocated before it.
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), f32_geometry():
        ransac_from_samples(gather_rows(src, stages["i1"]), gather_rows(dst, stages["i2"]),
                            stages["mask"], stages["samples"], ev.inlier_threshold,
                            irls_iterations=ev.ransac_irls, irls_shrink=ev.ransac_irls_shrink)
    ransac_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    t1 = time.perf_counter()
    errs = pair_errors(src, gt, stages["transform"])
    torch.cuda.synchronize()
    split["errors"] = (time.perf_counter() - t1) * 1e3
    split["total"] = sum(split.values())
    staged_diff = float((stages["transform"] - est).abs().max())
    if not torch.equal(stages["transform"], est):
        fail(f"the staged {preset} batch's poses differ from register_eval_batch's by "
             f"{staged_diff:.3e}")
    parity_msg = reg_parity(model, src, dst, stages, ev, preset)
    sweep_msg = method_sweep(src, dst, gt, stages, ev) if sweep else "not run"
    kernels = eval_kernel_times(model, src, dst, targets_k1=True)
    return dict(results=results, run_s=run_s, peak_gb=peak_gb, ransac_gb=ransac_gb,
                launches=launches, batches=batches, ms_per_batch=ms, split=split,
                profile=profile, per_batch=per_batch, parity=parity_msg, sweep=sweep_msg,
                kernels=kernels, evaluate=ev,
                median_rre=float(errs["rre"].median()))


def ransac_picp(src, dst, i1, i2, mask, samples, ev):
    """RANSAC on the given samples, then '+picp' from its pose: both poses,
    stacked [2, b, 4, 4]."""
    import torch

    from rift_tpu_torch.ops.neighbors import gather_rows
    from rift_tpu_torch.ops.precision import f32_geometry
    from rift_tpu_torch.registration import ransac_from_samples
    from rift_tpu_torch.registration.pipeline import refine_pose

    with torch.no_grad(), f32_geometry():
        t, _, _ = ransac_from_samples(gather_rows(src, i1), gather_rows(dst, i2), mask, samples,
                                      ev.inlier_threshold, irls_iterations=ev.ransac_irls,
                                      irls_shrink=ev.ransac_irls_shrink)
        return torch.stack([t, refine_pose(src, dst, t, "+picp", ev.noise_bound)])


def nudge_spread(fn, dst, tries: int, seed: int):
    """The largest change (max abs entry of each [4, 4] pose) of fn(dst')
    from fn(dst) over `tries` copies dst' of the CPU targets moved by NUDGE
    noise: (fn(dst), spread)."""
    import torch

    base = fn(dst)
    gen = torch.Generator().manual_seed(seed)
    spread = torch.zeros(base.shape[:-2])
    for _ in range(tries):
        moved = fn(dst + NUDGE * torch.randn(dst.shape, generator=gen))
        spread = torch.maximum(spread, (moved - base).abs().amax((-2, -1)))
    return base, spread


def reg_parity(model, src, dst, stages: dict, ev, name: str,
               pairs: int = EVAL_PARITY_PAIRS) -> str:
    """The first `pairs` pairs of the staged batch of preset `name` against
    reg_stages on the CPU (a copy of the model) on the card's RANSAC
    samples, under the rules at the top (reg_parity)."""
    import torch

    p, b = pairs, src.shape[0]
    cpu_model = copy.deepcopy(model).cpu()
    src_c, dst_c = src[:p].cpu(), dst[:p].cpu()
    samples = stages["samples"][:p].cpu()
    c = reg_stages(cpu_model, src_c, dst_c, ev, samples=samples)
    clouds = torch.cat([torch.arange(4 * p), 4 * b + torch.arange(p)]).to(src.device)
    f_g = stages["feats"][clouds].cpu()
    g = {k: stages[k][:p].cpu() for k in ("scores", "h", "i1", "i2", "mask", "rscore",
                                          "t_ransac", "transform")}
    point_err = (f_g - c["feats"]).abs().amax(-1) / float(c["feats"].abs().max())
    bad_share = float((point_err > FEAT_POINT_TOL).float().mean())
    top2 = torch.topk(c["scores"].double(), 2, dim=-1).values
    lead = (top2[:, 0] - top2[:, 1]) / top2[:, 0].clamp(min=1.0)
    decided = lead > SCORE_MARGIN
    same_h = g["h"] == c["h"]
    same = same_h & (g["mask"] == c["mask"]).all(-1) & (g["i2"] == c["i2"]).all(-1)
    agree = float((g["mask"] == c["mask"])[same_h].float().mean()) if bool(same_h.any()) else 1.0
    # RANSAC on the same matches and samples: the scores, and the winner.
    score_off = (g["rscore"] != c["rscore"]).sum(-1)
    win_g, win_c = g["rscore"].argmax(-1), c["rscore"].argmax(-1)
    # On equal scores the winner must be equal (the first maximum); where a
    # residual on the threshold rounded a score apart, the card's winner
    # must score within one inlier of the CPU's best on the CPU.
    win_ok = (win_g == win_c) | ((score_off > 0) & (
        torch.gather(c["rscore"], 1, win_g[:, None])[:, 0] >= c["rscore"].amax(-1) - 1))
    # The poses of RANSAC and of '+picp' after it, on the CPU run's matches
    # and samples, on the card and on the CPU with the targets nudged.
    base, spread = nudge_spread(
        lambda d: ransac_picp(src_c, d, c["i1"], c["i2"], c["mask"], samples, ev),
        dst_c, REG_NUDGE_TRIES, 3)
    t_solver = ransac_picp(src[:p], dst[:p], c["i1"].to(src.device), c["i2"].to(src.device),
                           c["mask"].to(src.device), samples.to(src.device), ev).cpu()
    determined = spread <= TRANSFORM_TOL  # [2, p]: RANSAC, then '+picp'
    solver_diff = (t_solver - base).abs().amax((-2, -1))
    t_diff = torch.stack([(g[k] - c[k]).abs().amax((-2, -1)) for k in ("t_ransac", "transform")])
    held = determined & (same & (win_g == win_c))[None]
    msg = (f"{p} pairs ({5 * p} clouds): features, share of points off by > "
           f"{FEAT_POINT_TOL:g} {bad_share:.4f} (tol {FEAT_POINT_SHARE}), median point err "
           f"{float(point_err.median()):.3e}; hypothesis card {g['h'].tolist()} CPU "
           f"{c['h'].tolist()} (lead {short(lead)}, decided above {SCORE_MARGIN}: "
           f"{decided.tolist()}); mutual-NN agreement {agree:.4f} (tol {MASK_AGREE}), same "
           f"matches {same.tolist()}; RANSAC on the same samples: hypotheses scored apart "
           f"{score_off.tolist()} of {g['rscore'].shape[1]}, winner card {win_g.tolist()} CPU "
           f"{win_c.tolist()} (best score {c['rscore'].amax(-1).tolist()}); on the CPU's "
           f"matches, RANSAC's pose max abs diff {short(solver_diff[0])} and after +picp "
           f"{short(solver_diff[1])}; end to end {short(t_diff[0])} and {short(t_diff[1])} "
           f"(tol {TRANSFORM_TOL}; CPU pose spread under a {NUDGE:g} nudge of the targets "
           f"{short(spread[0])} and {short(spread[1])}, determined {determined.tolist()})")
    if bad_share > FEAT_POINT_SHARE or bool((~same_h & decided).any()) or agree < MASK_AGREE \
            or not bool(torch.isfinite(c["transform"]).all()):
        fail(f"{name} parity: " + msg)
    if bool((~win_ok & same).any()) or int(determined[0].sum()) * 2 < p \
            or bool((solver_diff[determined] > TRANSFORM_TOL).any()) \
            or bool((t_diff[held] > TRANSFORM_TOL).any()):
        fail(f"{name} parity: " + msg)
    return msg


def method_sweep(src, dst, gt, stages: dict, ev, pairs: int = SWEEP_PAIRS,
                 cpu_pairs: int = SWEEP_CPU_PAIRS) -> str:
    """Every method name once on the card, through
    register_pair_from_matches on the staged batch's consensus matches of
    `pairs` pairs: each transform finite. The deterministic ones are held
    against the CPU on the first `cpu_pairs` of them, under SWEEP."""
    import torch

    from rift_tpu_torch.ops.precision import f32_geometry
    from rift_tpu_torch.ops.se3 import exp_so3
    from rift_tpu_torch.registration import METHODS, register_pair_from_matches
    from rift_tpu_torch.registration.pipeline import refine_pose

    s, d = src[:pairs], dst[:pairs]
    i1, i2, mask = (stages[k][:pairs] for k in ("i1", "i2", "mask"))
    gen = torch.Generator(device=src.device).manual_seed(0)
    kw = dict(noise_bound=ev.noise_bound, inlier_threshold=ev.inlier_threshold,
              num_hypotheses=ev.num_hypotheses, irls_iterations=ev.ransac_irls,
              irls_shrink=ev.ransac_irls_shrink)
    finite = {}
    with torch.no_grad():
        for method in METHODS:
            t, inl = register_pair_from_matches(s, d, i1, i2, mask, method, generator=gen, **kw)
            finite[method] = bool(torch.isfinite(t).all()) and t.shape == (pairs, 4, 4) \
                and inl.shape == mask.shape
    if not all(finite.values()):
        fail(f"method sweep: non-finite or misshapen results {finite}")

    p = cpu_pairs
    axis = torch.tensor([0.3, -0.5, 0.8])
    tilt = exp_so3(axis / axis.norm() * math.radians(SWEEP_INIT_DEG))
    init = gt[:p].cpu().clone()
    init[:, :3, :3] = init[:, :3, :3] @ tilt
    init[:, :3, 3] += SWEEP_INIT_SHIFT
    cpu = [x[:p].cpu() for x in (s, i1, i2, mask)]
    card = [x[:p] for x in (s, i1, i2, mask)]

    def solve(name, src_, dst_, i1_, i2_, mask_, init_):
        with torch.no_grad(), f32_geometry():
            if name in ("fgr", "icp"):
                return register_pair_from_matches(src_, dst_, i1_, i2_, mask_, name, **kw)[0]
            return refine_pose(src_, dst_, init_, name, ev.noise_bound)

    parts, bad = [], []
    for name in ("fgr", "icp", "+icp", "+picp", "+pl"):
        base, spread = nudge_spread(lambda d_: solve(name, cpu[0], d_, *cpu[1:], init),
                                    d[:p].cpu(), SWEEP_NUDGE_TRIES, 4)
        got = solve(name, card[0], d[:p], *card[1:], init.to(src.device)).cpu()
        determined = spread <= TRANSFORM_TOL
        diff = (got - base).abs().amax((-2, -1))
        worst = float(diff[determined].max()) if bool(determined.any()) else float("nan")
        parts.append(f"{name} determined {int(determined.sum())}/{p}, max diff there "
                     f"{worst:.3e}")
        few = int(determined.sum()) < SWEEP_MIN_DETERMINED[name] * p
        if few or bool((diff[determined] > TRANSFORM_TOL).any()):
            bad.append(name)
    msg = (f"{len(METHODS)} methods finite on {pairs} pairs; card vs CPU on {p} (tol "
           f"{TRANSFORM_TOL}, {SWEEP_NUDGE_TRIES} nudge(s) of {NUDGE:g}): " + "; ".join(parts))
    if bad:
        fail(f"method sweep: {bad}: " + msg)
    return msg


def train_config():
    """The mn40_sph_pt_r4 preset cut to a small split: one epoch of
    TRAIN_LOOP_STEPS steps of TRAIN_BATCH clouds."""
    from rift_tpu_torch.train import get_config

    cfg = get_config("mn40_sph_pt_r4")
    cfg.dataset.synthetic_items = dict(TRAIN_ITEMS)
    cfg.train.batch_size = TRAIN_BATCH
    cfg.train.steps_per_epoch = TRAIN_LOOP_STEPS
    cfg.optim.num_epochs = 1
    return cfg


def read_counts(wrappers: dict) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def train_phase(wrappers: dict) -> dict:
    """train() on the card, then TRAIN_STEPS steps on one fixed batch."""
    import torch

    from rift_tpu_torch.train import get_config, train

    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = train_config()
        cfg.train.ckpt_dir = ckpt_dir
        cfg.train.reg_probe_interval = 1
        for fn in wrappers.values():
            fn.launches = 0
        t1 = time.perf_counter()
        out = train(cfg)  # device=None: the card
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t1
        launches = read_counts(wrappers)
        eval_batches = -(-TRAIN_ITEMS["valid"] // cfg.train.eval_batch_size)
        for name in wrappers:
            want = (STEP_LAUNCHES.get(name, 0) * TRAIN_LOOP_STEPS
                    + EVAL_LAUNCHES.get(name, 0) * eval_batches + PROBE_LAUNCHES.get(name, 0))
            if launches[name] != want:
                fail(f"train(): {name} launched {launches[name]} times, expected {want}")
        probe = {k: v for k, v in out["best"].items() if k.startswith("reg_")}
        if out["state"].step != TRAIN_LOOP_STEPS or not math.isfinite(out["loss"]) \
                or "acc" not in out["best"] or len(probe) != 6 \
                or not all(math.isfinite(v) for v in probe.values()) \
                or not os.path.isfile(os.path.join(ckpt_dir, "common.pt")) \
                or not os.path.isfile(os.path.join(ckpt_dir, "best_reg_rre.pt")):
            fail(f"train(): step {out['state'].step}, loss {out['loss']}, best {out['best']}, "
                 f"files {sorted(os.listdir(ckpt_dir))}")

    # The fixed-batch steps start from the seeded weights with the preset's
    # own schedule (120 epochs of its 2048-item split), whose learning rate
    # stays near 1e-3 over these steps; train() above decayed to 0 in its
    # one epoch.
    fixed = fixed_batch_steps(cfg, get_config("mn40_sph_pt_r4"), wrappers)
    for name in wrappers:
        launches[name] += fixed["launches"][name]
    return dict(fixed, loop_s=loop_s, launches=launches, best=out["best"])


def fixed_batch_steps(cfg, full, wrappers: dict) -> dict:
    """TRAIN_STEPS train steps of `cfg`'s classifier from its seeded init,
    with the optimizer and schedule of the preset `full` (its whole split),
    on one fixed batch of TRAIN_BATCH clouds of cfg's train split
    (`steps_on_batch`)."""
    import torch

    from rift_tpu_torch.data.modelnet40 import ModelNet40
    from rift_tpu_torch.train import build_model
    from rift_tpu_torch.train.steps import create_state

    dev = torch.device("cuda")
    steps_per_epoch = full.dataset.synthetic_items["train"] // full.train.batch_size
    state = create_state(build_model(cfg), full, steps_per_epoch, dev, seed=cfg.seed)
    clouds, labels = next(ModelNet40(cfg.dataset, "train").batches(TRAIN_BATCH, seed=0))
    return steps_on_batch(state, torch.as_tensor(clouds, device=dev),
                          torch.as_tensor(labels, device=dev), wrappers, cfg.seed,
                          STEP_LAUNCHES)


def steps_on_batch(state, clouds, labels, wrappers: dict, seed: int,
                   step_launches: dict) -> dict:
    """TRAIN_STEPS train steps of `state` on one batch on the card: finite
    losses, each kernel launched `step_launches` times a step, the last 3
    losses below the first 3; ms/step (median of steps 2-TRAIN_STEPS),
    clouds/s, peak memory, one more step split by CUDA events into forward,
    backward and optimizer, and a profiled step."""
    import torch

    from rift_tpu_torch.ops.precision import f32_geometry
    from rift_tpu_torch.train.steps import cross_entropy, train_step

    gen = torch.Generator(device=clouds.device)
    losses, times, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        before = read_counts(wrappers)
        gen.manual_seed(seed * 1_000_003 + state.step)
        t1 = time.perf_counter()
        metrics = train_step(state, clouds, labels, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(metrics["loss"])
        after = read_counts(wrappers)
        per_step.append({k: after[k] - before[k] for k in after})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {}
    for name in wrappers:
        fixed = [d[name] for d in per_step]
        if any(d != step_launches.get(name, 0) for d in fixed):
            fail(f"fixed-batch steps: {name} launched {fixed} times per step, expected "
                 f"{step_launches.get(name, 0)}")
        launches[name] = sum(fixed)
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        fail(f"training losses not finite: {losses}")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not last < first:
        fail(f"training loss did not fall on a fixed batch: first 3 {first:.4f}, "
             f"last 3 {last:.4f} ({short(losses)})")

    # One more step, split by CUDA events into forward, backward and
    # optimizer (the parts of train_step; the clip is off in these presets).
    model = state.model
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with f32_geometry():
        events[0].record()
        loss = cross_entropy(model(clouds, generator=gen), labels)
        events[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        events[2].record()
        state.optimizer.step()
        events[3].record()
    torch.cuda.synchronize()
    split = [events[i].elapsed_time(events[i + 1]) for i in range(3)]
    profile = profile_step(lambda: train_step(state, clouds, labels, gen))
    ms = sorted(times[1:])[len(times[1:]) // 2] * 1e3
    return dict(ms_per_step=ms, clouds_per_s=clouds.shape[0] / ms * 1e3, losses=losses,
                split_ms=split, peak_gb=peak_gb, launches=launches, profile=profile)


# Kernel names of cuDNN's convolutions (fprop, dgrad, wgrad: its own
# engines and the xmma implicit GEMMs) and of its layout transforms.
CONV_KERNEL_MARKS = ("conv", "xmma", "implicit_gemm", "wgrad", "dgrad", "fprop", "cudnn")


def profile_step(step) -> dict:
    """One call of step() under torch.profiler: wall ms, device ms (kernel
    events only: an aten op also reports its kernels' time), the device's
    busy share, cuDNN's convolution kernels' ms and share of the device
    time (CONV_KERNEL_MARKS), and the 8 kernels with the most device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
                   if "CUDA" in str(ev.device_type) and ev.self_device_time_total > 0),
                  reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    if device_ms <= 0.0:
        fail("torch.profiler recorded no device time for a profiled step")
    conv_ms = sum(r[0] for r in rows if any(m in r[1].lower() for m in CONV_KERNEL_MARKS)) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "conv_ms": conv_ms, "conv_share": conv_ms / device_ms,
            "top": [(k[:80], round(us / 1e3, 3), c) for us, k, c in rows[:8]]}


def train_parity() -> str:
    """One step of the flagship on PARITY_CLOUDS clouds from the same
    weights, dropout off, on the card and on the CPU (`step_parity`)."""
    import torch

    from rift_tpu_torch.data.modelnet40 import ModelNet40
    from rift_tpu_torch.train import build_model
    from rift_tpu_torch.train.steps import TrainState, create_state, make_optimizer

    cfg = train_config()
    clouds, labels = next(ModelNet40(cfg.dataset, "valid").batches(PARITY_CLOUDS, seed=1))
    cpu = create_state(build_model(cfg), cfg, TRAIN_LOOP_STEPS, torch.device("cpu"),
                       seed=cfg.seed + 1)
    cpu.model.dropout = 0.0
    card_model = copy.deepcopy(cpu.model).cuda()
    card = TrainState(card_model, *make_optimizer(card_model, cfg, TRAIN_LOOP_STEPS))
    return step_parity(cpu, card, clouds, labels, f"{PARITY_CLOUDS} clouds x {NUM_POINTS}")


def step_parity(cpu, card, clouds, labels, what: str) -> str:
    """One train_step of the CPU state `cpu` and of its copy `card` on the
    card, on the batch (clouds, labels) (numpy): the loss, the gradients
    (GRAD_COS above GRAD_NORM_FLOOR, GRAD_DIFF_TOL below, a line printed per
    parameter below the floor) and the BN statistics (STATS_RTOL)."""
    import torch

    from rift_tpu_torch.train.steps import train_step

    out_g = train_step(card, torch.as_tensor(clouds, device="cuda"),
                       torch.as_tensor(labels, device="cuda"))
    out_c = train_step(cpu, torch.as_tensor(clouds), torch.as_tensor(labels))
    loss_g, loss_c = float(out_g["loss"]), float(out_c["loss"])
    grads_c = {name: p.grad.double().flatten() for name, p in cpu.model.named_parameters()}
    grads_g = {name: p.grad.double().cpu().flatten()
               for name, p in card.model.named_parameters()}
    top = max(float(g.norm()) for g in grads_c.values())
    rows = []  # (cosine, |g| over the largest |g|, |g_card - g_cpu| over the largest |g|, name)
    for name, want in grads_c.items():
        g = grads_g[name]
        cos = float(torch.dot(g, want) / (g.norm() * want.norm()).clamp(min=1e-300))
        rows.append((cos, float(want.norm()) / top, float((g - want).norm()) / top, name))
    directed = [r for r in rows if r[1] >= GRAD_NORM_FLOOR]
    floor = [r for r in rows if r[1] < GRAD_NORM_FLOOR]
    worst_cos = min(directed)
    worst_floor = max(floor, key=lambda r: r[2], default=(1.0, 0.0, 0.0, "none"))
    for cos, norm, diff, name in sorted(floor, key=lambda r: r[1]):
        print(f"  below the floor: {name}: norm {norm:.3e}, cosine {cos:.6f}, "
              f"|card - CPU| {diff:.3e}", flush=True)
    bufs_c = dict(cpu.model.named_buffers())
    worst_stat, worst_stat_name = 0.0, ""
    for name, buf in card.model.named_buffers():
        err = float((buf.cpu() - bufs_c[name]).abs().max()) / float(bufs_c[name].abs().max())
        if err > worst_stat:
            worst_stat, worst_stat_name = err, name
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    msg = (f"{what}: loss card {loss_g:.6f} CPU {loss_c:.6f} "
           f"(rel {loss_rel:.3e}, tol {LOSS_RTOL:g}); gradients (norms relative to the "
           f"largest parameter gradient's): min cosine {worst_cos[0]:.6f} at {worst_cos[3]} "
           f"over the {len(directed)} with norm >= {GRAD_NORM_FLOOR:g} (tol {GRAD_COS}); "
           f"below the floor ({len(floor)}), max |card - CPU| {worst_floor[2]:.3e} at "
           f"{worst_floor[3]} (tol {GRAD_DIFF_TOL:g}); BN running stats max rel diff "
           f"{worst_stat:.3e} at {worst_stat_name} (tol {STATS_RTOL:g})")
    if loss_rel > LOSS_RTOL or worst_cos[0] < GRAD_COS or worst_floor[2] > GRAD_DIFF_TOL \
            or worst_stat > STATS_RTOL:
        fail("train parity: " + msg)
    return msg


def bf16_config(ckpt_dir: str | None = None):
    """The BF16_PRESET preset with BF16_OVERRIDES applied (and a checkpoint
    directory), as `cli train` builds it."""
    from rift_tpu_torch.train import apply_overrides, get_config

    cfg = apply_overrides(get_config(BF16_PRESET), BF16_OVERRIDES)
    if ckpt_dir is not None:
        cfg.train.ckpt_dir = ckpt_dir
    return cfg


def voxel_kernel_rows(model, coords, k4: bool) -> dict:
    """K2 and K3 (and K4 with `k4`) at the shapes `model`'s PVConv blocks
    give them on the clouds `coords` [b, n, 3] (spherical grid of the raw
    centred coordinates, as training and classification run it), in the
    model's compute type (bf16 features and grids for a bf16 model; K4's
    cotangent is f32), against their plain versions (TOL), timed per call
    and on the device alone, with their byte bounds."""
    import torch

    from rift_tpu_torch.ops.cuda import onehot_ops as oh
    from rift_tpu_torch.ops.spherical import (normalize_coords_sphere,
                                              spherical_corner_weights,
                                              spherical_voxel_indices)

    from rift_tpu_torch.nn import PVConv

    dtype = getattr(model, "dtype", None) or torch.float32
    size = torch.tensor([], dtype=dtype).element_size()
    blocks = [m for m in model.modules() if isinstance(m, PVConv)]
    r = blocks[0].resolution
    s = r ** 3
    with torch.no_grad():
        norm = normalize_coords_sphere(coords - coords.mean(-2, keepdim=True))
        inds, _ = spherical_voxel_indices(norm, r)
        idx, w = spherical_corner_weights(norm, inds, r)
    b, n = inds.shape
    dev = coords.device
    gen = torch.Generator(device=dev).manual_seed(6)
    touched = int(torch.unique((idx + torch.arange(b, device=dev)[:, None, None] * s)
                               [idx >= 0]).numel())
    rows = {"scatter_mean": [], "corner_gather": [], "corner_scatter": []}
    for block in blocks:
        c_in, c_out = block.convs[0].in_channels, block.convs[0].out_channels
        feat = torch.randn((b, n, c_in), generator=gen, device=dev).to(dtype)
        out, cnt = oh.scatter_mean(feat, inds, s)
        want, want_cnt = oh.scatter_mean_plain(feat, inds, s)
        torch.cuda.synchronize()
        err = rel_err(out, want)[1]
        if not torch.equal(cnt, want_cnt) or err > TOL["scatter_mean"]:
            fail(f"K2 at [{b},{n},{c_in}] {dtype}: counts equal {torch.equal(cnt, want_cnt)}, "
                 f"rel err {err:.3e}")
        nbytes = b * n * c_in * size + b * n * 8 + b * s * c_in * 4 + b * s * 4
        rows["scatter_mean"].append(dict(
            shape=f"[{b},{n},{c_in}] {str(dtype)[6:]} -> [{b},{s},{c_in}]", max_rel_err=err,
            ms=cuda_time_ms(lambda: oh.scatter_mean(feat, inds, s), reps=5),
            dev_ms=dev_ms(lambda: oh.scatter_mean(feat, inds, s), calls=5),
            bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes"))
        grid = torch.randn((b, s, c_out), generator=gen, device=dev).to(dtype)
        out = oh.corner_gather(grid, idx, w)
        want = oh.corner_gather_plain(grid, idx, w)
        torch.cuda.synchronize()
        err = rel_err(out, want)[1]
        if err > TOL["corner_gather"]:
            fail(f"K3 at [{b},{s},{c_out}] {dtype}: rel err {err:.3e}")
        nbytes = touched * c_out * size + b * n * 8 * (idx.element_size() + 4) + b * n * c_out * 4
        rows["corner_gather"].append(dict(
            shape=f"[{b},{s},{c_out}] {str(dtype)[6:]} at [{b},{n},8] -> [{b},{n},{c_out}]",
            max_rel_err=err,
            ms=cuda_time_ms(lambda: oh.corner_gather(grid, idx, w), reps=5),
            dev_ms=dev_ms(lambda: oh.corner_gather(grid, idx, w), calls=5),
            bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes"))
        if k4:
            dout = torch.randn((b, n, c_out), generator=gen, device=dev)
            out = oh.corner_scatter(dout, idx, w, s)
            want = oh.corner_scatter_plain(dout, idx, w, s)
            torch.cuda.synchronize()
            err = rel_err(out, want)[1]
            if err > TOL["corner_scatter"]:
                fail(f"K4 at [{b},{n},{c_out}] -> [{b},{s},{c_out}]: rel err {err:.3e}")
            nbytes = b * n * c_out * 4 + b * n * 8 * 8 + b * s * c_out * 4
            rows["corner_scatter"].append(dict(
                shape=f"[{b},{n},{c_out}] f32 at [{b},{n},8] -> [{b},{s},{c_out}]",
                max_rel_err=err,
                ms=cuda_time_ms(lambda: oh.corner_scatter(dout, idx, w, s), reps=5),
                dev_ms=dev_ms(lambda: oh.corner_scatter(dout, idx, w, s), calls=5),
                bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes"))
    rows = {k: v for k, v in rows.items() if v}
    for name, rs in rows.items():
        for row in rs:
            print(f"    {name} at {row['shape']}: rel err {row['max_rel_err']:.3e} (tol "
                  f"{TOL[name]:g}); kernel {row['ms']:.4f} ms per call, {row['dev_ms']:.4f} "
                  f"device only, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), share "
                  f"{row['bound_ms'] / row['dev_ms']:.3f}", flush=True)
    return rows


def fps_check() -> str:
    """ops/sampling.furthest_point_sample on the card at [TRAIN_BATCH,
    NUM_POINTS, 3] -> FPS_SAMPLES: indices equal to the CPU's, timed."""
    import torch

    from rift_tpu_torch.data.modelnet40 import ModelNet40
    from rift_tpu_torch.ops.sampling import furthest_point_sample

    clouds, _ = next(ModelNet40(bf16_config().dataset, "train").batches(TRAIN_BATCH, seed=0))
    pts = torch.as_tensor(clouds[..., :3], device="cuda")
    got = furthest_point_sample(pts, FPS_SAMPLES)
    want = furthest_point_sample(pts.cpu(), FPS_SAMPLES)
    if not torch.equal(got.cpu(), want):
        fail(f"furthest_point_sample: the card's indices differ from the CPU's at "
             f"{int((got.cpu() != want).sum())} of {want.numel()}")
    ms = cuda_time_ms(lambda: furthest_point_sample(pts, FPS_SAMPLES), reps=3)
    return (f"furthest_point_sample [{TRAIN_BATCH},{NUM_POINTS},3] -> {FPS_SAMPLES}: indices "
            f"equal to the CPU's; {ms:.2f} ms")


def bf16_train_phase(wrappers: dict, ckpt_dir: str) -> dict:
    """`cli train` of the BF16_PRESET preset in bf16 on the card, then the
    fixed-batch steps of its model, K2/K3/K4 at its training shapes, and
    furthest point sampling."""
    import contextlib
    import io

    import torch

    from rift_tpu_torch import cli
    from rift_tpu_torch.data.modelnet40 import ModelNet40
    from rift_tpu_torch.train import build_model, get_config
    from rift_tpu_torch.train.checkpoint import CheckpointManager

    cfg = bf16_config(ckpt_dir)
    for fn in wrappers.values():
        fn.launches = 0
    out = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = cli.main(["train", "--preset", BF16_PRESET, "--device", "cuda", "--no-resume",
                         f"train.ckpt_dir={ckpt_dir}", *BF16_OVERRIDES])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t1
    launches = read_counts(wrappers)
    if code != 0:
        fail(f"cli train --preset {BF16_PRESET} exited {code}")
    eval_batches = -(-TRAIN_ITEMS["valid"] // cfg.train.eval_batch_size)
    for name in wrappers:
        want = (STEP_LAUNCHES.get(name, 0) * TRAIN_LOOP_STEPS
                + BF16_EVAL_LAUNCHES.get(name, 0) * eval_batches)
        if launches[name] != want:
            fail(f"cli train bf16: {name} launched {launches[name]} times, expected {want}")
    meta = CheckpointManager(ckpt_dir).load_meta()
    with open(os.path.join(ckpt_dir, f"{BF16_PRESET}.metrics.jsonl")) as f:
        log = [json.loads(line) for line in f]
    train_loss = [r["loss"] for r in log if r["split"] == "train"]
    if meta is None or meta["config"]["model"]["dtype"] != "bfloat16" \
            or len(train_loss) != 1 or not math.isfinite(train_loss[0]) \
            or not os.path.isfile(os.path.join(ckpt_dir, "best_acc.pt")):
        fail(f"cli train bf16: meta {meta and meta['config']['model']}, log {log}, files "
             f"{sorted(os.listdir(ckpt_dir))}")
    full = get_config(BF16_PRESET)  # the preset's whole split sets the schedule
    full.model.dtype = "bfloat16"
    fixed = fixed_batch_steps(cfg, full, wrappers)
    for name in wrappers:
        launches[name] += fixed["launches"][name]
    model = build_model(cfg).to("cuda")
    clouds, _ = next(ModelNet40(cfg.dataset, "train").batches(TRAIN_BATCH, seed=0))
    rows = voxel_kernel_rows(model, torch.as_tensor(clouds[..., :3], device="cuda"), k4=True)
    return dict(fixed, loop_s=loop_s, launches=launches, train_loss=train_loss[0],
                best=meta["best"], kernels=rows, fps=fps_check())


def bf16_train_parity() -> str:
    """One bf16 step on PARITY_CLOUDS clouds from the same weights, dropout
    off, on the card and on the CPU, beside the CPU's f32 step as the
    function both approximate (BF16_PARITY rules)."""
    import dataclasses

    import torch

    from rift_tpu_torch.data.modelnet40 import ModelNet40
    from rift_tpu_torch.train import build_model
    from rift_tpu_torch.train.steps import (TrainState, create_state, forward_backward,
                                            make_optimizer, train_step)

    cfg = bf16_config()
    clouds, labels = next(ModelNet40(cfg.dataset, "valid").batches(PARITY_CLOUDS, seed=1))
    cpu = create_state(build_model(cfg), cfg, TRAIN_LOOP_STEPS, torch.device("cpu"),
                       seed=cfg.seed + 1)
    cpu.model.dropout = 0.0
    card_model = copy.deepcopy(cpu.model).cuda()
    card = TrainState(card_model, *make_optimizer(card_model, cfg, TRAIN_LOOP_STEPS))
    f32 = build_model(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=None)))
    f32.load_state_dict(cpu.model.state_dict())
    f32.dropout = 0.0
    exact = TrainState(f32, *make_optimizer(f32, cfg, TRAIN_LOOP_STEPS))
    out_g = train_step(card, torch.as_tensor(clouds, device="cuda"),
                       torch.as_tensor(labels, device="cuda"))
    out_c = train_step(cpu, torch.as_tensor(clouds), torch.as_tensor(labels))
    forward_backward(exact, torch.as_tensor(clouds), torch.as_tensor(labels))
    loss_g, loss_c = float(out_g["loss"]), float(out_c["loss"])
    g32 = {n: p.grad.double() for n, p in exact.model.named_parameters()}
    g_cpu = {n: p.grad.double() for n, p in cpu.model.named_parameters()}
    top = max(float(g.norm()) for g in g32.values())
    lr = cpu.schedule(0)
    worst_ratio, worst_zero, worst_param, worst_settled, held = (0.0, ""), (0.0, ""), 0.0, 0.0, 0
    p_cpu = dict(cpu.model.named_parameters())
    for name, p in card.model.named_parameters():
        want = g32[name]
        g = p.grad.double().cpu()
        err = float((g - want).norm())
        if float(want.norm()) >= BF16_FLOOR * top:
            cpu_err = float((g_cpu[name] - want).norm())
            ratio = (err - BF16_SLACK * float(want.norm())) / max(cpu_err, 1e-30)
            worst_ratio = max(worst_ratio, (ratio, name))
            held += 1
        else:
            worst_zero = max(worst_zero, (err / top, name))
        off = (p.detach().cpu() - p_cpu[name].detach()).abs()
        settled = (g - g_cpu[name]).abs() <= SETTLED * g_cpu[name].abs()
        worst_settled = max(worst_settled, float(torch.where(settled, off, 0.0).max()))
        worst_param = max(worst_param, float(off.max()) / lr)
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    msg = (f"{PARITY_CLOUDS} clouds x {NUM_POINTS}, {BF16_PRESET} bf16: loss card {loss_g:.6f} "
           f"CPU {loss_c:.6f} (rel {loss_rel:.3e}, tol {BF16_LOSS_RTOL:g}); gradients against "
           f"the CPU's f32 step, on the {held} with norm >= {BF16_FLOOR:g} of the largest: "
           f"max (|card - f32| - {BF16_SLACK:g}|f32|) / |CPU bf16 - f32| {worst_ratio[0]:.3f} at "
           f"{worst_ratio[1]} (tol {BF16_RATIO:g}); below: max |card - f32| {worst_zero[0]:.3e} "
           f"of the largest at {worst_zero[1]} (tol {BF16_ZERO_TOL:g}); updated parameters: "
           f"max |card - CPU| {worst_param:.3f} lr (tol 2.1), {worst_settled:.3e} where the "
           f"gradients agree within {SETTLED:g} (tol {SETTLED_PARAM_TOL:g})")
    if loss_rel > BF16_LOSS_RTOL or worst_ratio[0] > BF16_RATIO \
            or worst_zero[0] > BF16_ZERO_TOL or worst_param > 2.1 \
            or worst_settled > SETTLED_PARAM_TOL or held < 10:
        fail("bf16 train parity: " + msg)
    return msg


def cls_eval_phase(wrappers: dict, ckpt_dir: str) -> dict:
    """`cli evaluate-cls --ckpt DIR --sweep` on the checkpoint of the bf16
    training phase, with CLS_OVERRIDES (the preset's 128-item test split):
    the whole call's seconds, the forwards' clouds/s (each forward timed,
    synchronized), peak memory, K2/K3/K5 launches; then K2/K3 at its
    shapes, K5 at its batch, and CLS_PARITY_CLOUDS test clouds' logits
    against the CPU's."""
    import contextlib
    import io

    import torch

    import rift_tpu_torch.train.loop as loop
    from rift_tpu_torch import cli
    from rift_tpu_torch.data.modelnet40 import ModelNet40
    from rift_tpu_torch.ops.cuda.conv3d import conv3d_same
    from rift_tpu_torch.train import apply_overrides, build_model, load_trained_state
    from rift_tpu_torch.train.config import ModelConfig

    forwards = {"s": 0.0, "clouds": 0, "calls": 0}
    eval_step = loop.eval_step

    def timed_eval_step(state, clouds):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = eval_step(state, clouds)
        torch.cuda.synchronize()
        forwards["s"] += time.perf_counter() - t1
        forwards["clouds"] += clouds.shape[0]
        forwards["calls"] += 1
        return logits

    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    loop.eval_step = timed_eval_step
    try:
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = cli.main(["evaluate-cls", "--ckpt", ckpt_dir, "--sweep", *CLS_OVERRIDES])
        run_s = time.perf_counter() - t1
    finally:
        loop.eval_step = eval_step
    launches = read_counts(wrappers)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if code != 0:
        fail(f"cli evaluate-cls exited {code}: {out.getvalue()}")
    print(out.getvalue(), end="", flush=True)
    results = {k: float(v) for k, v in (line.split(": ") for line in out.getvalue().splitlines())}
    want_keys = ["acc", "acc_hard", *[f"sweep_acc_l{i}" for i in range(6)], "sweep_auc",
                 "rot_agree", "logit_drift"]
    if list(results) != want_keys or not all(math.isfinite(v) for v in results.values()):
        fail(f"cli evaluate-cls printed {results}")
    # Forwards: the test split and the hard tier, each in batches of
    # eval_batch_size, the 6 sweep levels likewise, and one forward of
    # min(64, items) clouds per rotation.
    raw, snapshot = load_trained_state(ckpt_dir)
    cfg = bf16_config()
    cfg.model = ModelConfig(**snapshot["model"])
    for key, value in snapshot["dataset"].items():
        setattr(cfg.dataset, key, value)
    apply_overrides(cfg, CLS_OVERRIDES)
    items = cfg.dataset.synthetic_items["test"]
    want_calls = 8 * -(-items // cfg.train.eval_batch_size) + CLS_ROTATIONS
    if forwards["calls"] != want_calls:
        fail(f"cli evaluate-cls ran {forwards['calls']} forwards, expected {want_calls}")
    for name in wrappers:
        want = BF16_EVAL_LAUNCHES.get(name, 0) * want_calls
        if launches[name] != want:
            fail(f"cli evaluate-cls: {name} launched {launches[name]} times, expected {want}")

    model = build_model(cfg)
    model.load_state_dict(raw["model"])
    model = model.eval().cuda()
    test = ModelNet40(cfg.dataset, "test")
    clouds, _ = next(test.batches(cfg.train.eval_batch_size, seed=0, shuffle=False,
                                        drop_last=False))
    rows = voxel_kernel_rows(model, torch.as_tensor(clouds[..., :3], device="cuda"), k4=False)
    hard = ModelNet40(loop.hard_tier_dataset(cfg.dataset), "test")
    hard_clouds, _ = next(hard.batches(cfg.train.eval_batch_size, seed=0, shuffle=False,
                                        drop_last=False))
    for name, rs in voxel_kernel_rows(model, torch.as_tensor(hard_clouds[..., :3],
                                                             device="cuda"), k4=False).items():
        rows[name] += rs
    gen = torch.Generator(device="cuda").manual_seed(7)
    k5_rows = []
    b = cfg.train.eval_batch_size
    for block in (model.layers[n] for n in model._backbone if n.startswith("PVConv")):
        for conv in block.convs:
            cin, cout = conv.in_channels, conv.out_channels
            x, w, _, _, steps, equal, a, rel = k5_held(gen, b, block.resolution, cin, cout)
            flops = 2 * 27 * block.resolution ** 3 * cin * cout * b
            nbytes = b * block.resolution ** 3 * (cin + cout) * 2 + 27 * cin * cout * 2
            row = dict(shape=f"[{b},{block.resolution}^3,{cin}] -> {cout}", max_steps=steps,
                       equal_share=equal, max_abs_err=a, max_rel_err=rel,
                       ms=cuda_time_ms(lambda: conv3d_same(x, w), reps=5),
                       dev_ms=dev_ms(lambda: conv3d_same(x, w), calls=5),
                       bound_ms=max(flops / PEAK_BF16_FLOP_PER_S,
                                    nbytes / PEAK_BYTES_PER_S) * 1e3, bound_by="operations")
            print(f"    conv3d_same at {row['shape']}: max {steps:.3f} bf16 steps (tol "
                  f"{TOL['conv3d_same']:g}), bit-equal {equal:.6f}; kernel {row['ms']:.4f} ms "
                  f"per call, {row['dev_ms']:.4f} device only, bound {row['bound_ms']:.4f} ms, "
                  f"share {row['bound_ms'] / row['dev_ms']:.3f}", flush=True)
            if steps > TOL["conv3d_same"]:
                fail(f"K5 at {row['shape']}: {steps:.3f} bf16 steps from its plain version")
            k5_rows.append(row)
    rows["conv3d_same"] = k5_rows

    # Parity: the card's logits against the CPU's on the first test clouds.
    x = torch.as_tensor(clouds[:CLS_PARITY_CLOUDS], device="cuda")
    with torch.no_grad():
        card = loop.eval_step(loop.TrainState(model, None, None), x).cpu()
        cpu = loop.eval_step(loop.TrainState(copy.deepcopy(model).cpu(), None, None),
                             x.cpu())
    scale = float(cpu.abs().max())
    logit_err = float((card - cpu).abs().max()) / scale
    top2 = cpu.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > CLS_LOGIT_TOL * scale
    same = card.argmax(-1) == cpu.argmax(-1)
    parity = (f"{CLS_PARITY_CLOUDS} test clouds: max |card - CPU| logit {logit_err:.3e} of the "
              f"largest (tol {CLS_LOGIT_TOL:g}); predictions equal on {int(same.sum())}, "
              f"{int(clear.sum())} of them with a top-2 margin above the tolerance")
    if logit_err > CLS_LOGIT_TOL or not bool(same[clear].all()):
        fail("evaluate-cls parity: " + parity)
    return dict(results=results, run_s=run_s, forward_s=forwards["s"],
                clouds=forwards["clouds"], calls=forwards["calls"], peak_gb=peak_gb,
                launches=launches, kernels=rows, parity=parity)


def dp_phase(wrappers: dict) -> dict:
    """make_sharded_train_step on a one-rank NCCL group against train_step:
    one step of the f32 flagship (train_config) from one seeded init on
    the same batch, loss, accuracy, parameters and BN statistics bit for
    bit (cuDNN deterministic in both); then DP_STEPS of each, in turns,
    for their ms/step. The group is destroyed before the next phase."""
    import socket

    import torch
    import torch.distributed as dist

    from rift_tpu_torch.data.modelnet40 import ModelNet40
    from rift_tpu_torch.parallel import make_sharded_train_step
    from rift_tpu_torch.train import build_model
    from rift_tpu_torch.train.steps import create_state, train_step

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        dev = torch.device("cuda")
        cfg = train_config()
        clouds, labels = next(ModelNet40(cfg.dataset, "train").batches(TRAIN_BATCH, seed=0))
        clouds = torch.as_tensor(clouds, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        states = [create_state(build_model(cfg), cfg, TRAIN_LOOP_STEPS, dev, seed=cfg.seed)
                  for _ in range(2)]
        steps = [train_step, make_sharded_train_step(dist.group.WORLD)]
        gen = torch.Generator(device=dev)
        outs = []
        for i, (state, step) in enumerate(zip(states, steps)):
            if i == 1:
                for fn in wrappers.values():
                    fn.launches = 0
            gen.manual_seed(cfg.seed)
            outs.append(step(state, clouds, labels, gen))
            torch.cuda.synchronize()
        launches = read_counts(wrappers)
        for name in wrappers:
            if launches[name] != STEP_LAUNCHES.get(name, 0):
                fail(f"train dp: {name} launched {launches[name]} times, expected "
                     f"{STEP_LAUNCHES.get(name, 0)}")
        (plain, sharded), (sp, sd) = outs, states
        diff = [k for k, v in sp.model.state_dict().items()
                if not torch.equal(v, sd.model.state_dict()[k])]
        if not (torch.equal(plain["loss"], sharded["loss"])
                and torch.equal(plain["acc"], sharded["acc"])) or diff:
            fail(f"train dp: the one-rank sharded step differs from train_step: loss "
                 f"{float(plain['loss'])!r} vs {float(sharded['loss'])!r}, acc "
                 f"{float(plain['acc'])} vs {float(sharded['acc'])}, tensors {diff[:5]}")
        times = ([], [])
        for _ in range(DP_STEPS):
            for i in (0, 1):
                gen.manual_seed(cfg.seed)
                t1 = time.perf_counter()
                steps[i](states[i], clouds, labels, gen)
                torch.cuda.synchronize()
                times[i].append((time.perf_counter() - t1) * 1e3)
        ms = [sorted(t)[len(t) // 2] for t in times]
        return dict(launches=launches, plain_ms=ms[0], dp_ms=ms[1],
                    loss=float(plain["loss"]), tensors=len(sp.model.state_dict()))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()


def seg_phase(wrappers: dict) -> dict:
    """`cli train-seg` of SEG_PRESET on the card with SEG_OVERRIDES (its
    checkpoints in a temp dir), then the fixed-batch steps of its seeded
    model, the eval forward's clouds/s and launches at eval_batch_size,
    card-vs-CPU parity of logits and of one step, and K2/K3/K4 at its
    shapes."""
    import contextlib
    import io

    import torch

    from rift_tpu_torch import cli
    from rift_tpu_torch.data.shapenet import ShapeNetConfig, get_shapenet
    from rift_tpu_torch.train import apply_overrides, build_seg_model, get_config
    from rift_tpu_torch.train.checkpoint import CheckpointManager
    from rift_tpu_torch.train.steps import create_state, eval_step

    cfg = apply_overrides(get_config(SEG_PRESET), SEG_OVERRIDES)
    data = get_shapenet(ShapeNetConfig(num_points=cfg.dataset.num_points))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        for fn in wrappers.values():
            fn.launches = 0
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = cli.main(["train-seg", "--preset", SEG_PRESET, "--device", "cuda",
                             f"train.ckpt_dir={ckpt_dir}", *SEG_OVERRIDES])
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t1
        launches = read_counts(wrappers)
        if code != 0:
            fail(f"cli train-seg exited {code}")
        eval_batches = -(-len(data["test"]) // cfg.train.eval_batch_size)
        for name in wrappers:
            want = (STEP_LAUNCHES.get(name, 0) * SEG_LOOP_STEPS
                    + EVAL_LAUNCHES.get(name, 0) * eval_batches)
            if launches[name] != want:
                fail(f"cli train-seg: {name} launched {launches[name]} times, expected {want}")
        meta = CheckpointManager(ckpt_dir).load_meta()
        with open(os.path.join(ckpt_dir, f"{SEG_PRESET}.metrics.jsonl")) as f:
            log = [json.loads(line) for line in f]
        if meta is None or meta["config"]["name"] != SEG_PRESET or len(log) != 1 \
                or log[0]["step"] != SEG_LOOP_STEPS or not math.isfinite(log[0]["loss"]) \
                or not 0.0 <= log[0]["iou"] <= 1.0 \
                or not os.path.isfile(os.path.join(ckpt_dir, "best_iou.pt")) \
                or not os.path.isfile(os.path.join(ckpt_dir, "common.pt")):
            fail(f"cli train-seg: meta {meta and meta['best']}, log {log}, files "
                 f"{sorted(os.listdir(ckpt_dir))}")

    dev = torch.device("cuda")
    steps_per_epoch = len(data["train"]) // cfg.train.batch_size  # the preset's schedule
    state = create_state(build_seg_model(cfg), get_config(SEG_PRESET), steps_per_epoch, dev,
                         seed=cfg.seed)
    clouds, labels = next(data["train"].batches(SEG_BATCH, seed=0))
    clouds = torch.as_tensor(clouds, device=dev)
    fixed = steps_on_batch(state, clouds, torch.as_tensor(labels, device=dev), wrappers,
                           cfg.seed, STEP_LAUNCHES)
    for name in wrappers:
        launches[name] += fixed["launches"][name]

    test, _ = next(data["test"].batches(cfg.train.eval_batch_size, seed=0, shuffle=False,
                                        drop_last=False))
    test = torch.as_tensor(test, device=dev)
    eval_step(state, test)
    torch.cuda.synchronize()
    before = read_counts(wrappers)
    times = []
    for _ in range(SEG_EVAL_CALLS):
        t1 = time.perf_counter()
        logits = eval_step(state, test)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    after = read_counts(wrappers)
    per_forward = {k: (after[k] - before[k]) / SEG_EVAL_CALLS for k in after}
    for name in wrappers:
        if per_forward[name] != EVAL_LAUNCHES.get(name, 0):
            fail(f"train-seg eval forward: {name} launched {per_forward[name]} times a "
                 f"forward, expected {EVAL_LAUNCHES.get(name, 0)}")
    if tuple(logits.shape) != (test.shape[0], SEG_POINTS, 50) \
            or not bool(torch.isfinite(logits).all()):
        fail(f"train-seg eval logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    eval_ms = sorted(times)[len(times) // 2] * 1e3
    rows = voxel_kernel_rows(state.model, clouds[..., :3], k4=True)
    return dict(fixed, loop_s=loop_s, launches=launches, log=log[0], best=meta["best"],
                eval_ms=eval_ms, eval_clouds=test.shape[0], test_items=len(data["test"]),
                per_forward=per_forward,
                kernels=rows, parity=seg_parity(cfg, data["test"]))


def seg_parity(cfg, test) -> str:
    """The segmentation model with seeded weights on SEG_PARITY_CLOUDS test
    clouds, card vs CPU: the eval logits (SEG_LOGIT_* rules) and one train
    step, dropout off (`step_parity`)."""
    import torch

    from rift_tpu_torch.train import build_seg_model
    from rift_tpu_torch.train.steps import TrainState, eval_step, make_optimizer

    clouds, labels = next(test.batches(SEG_PARITY_CLOUDS, seed=1, shuffle=False))
    cpu_model = seeded_model(2, build_seg_model(cfg))
    cpu_model.dropout = 0.0
    card_model = copy.deepcopy(cpu_model).cuda()
    cpu = TrainState(cpu_model, *make_optimizer(cpu_model, cfg, SEG_LOOP_STEPS))
    card = TrainState(card_model, *make_optimizer(card_model, cfg, SEG_LOOP_STEPS))
    got = eval_step(card, torch.as_tensor(clouds, device="cuda")).cpu().double()
    want = eval_step(cpu, torch.as_tensor(clouds)).double()
    err = (got - want).abs().amax(-1) / want.abs().max()
    share = float((err > SEG_LOGIT_TOL).double().mean())
    median = float(err.median())
    agree = float((got.argmax(-1) == want.argmax(-1)).double().mean())
    msg = (f"eval logits of {SEG_PARITY_CLOUDS} clouds x {SEG_POINTS}: max |card - CPU| "
           f"{float(err.max()):.3e} of the largest logit, {share:.4f} of the points above "
           f"{SEG_LOGIT_TOL:g} (tol {SEG_LOGIT_SHARE}), median {median:.3e} (tol "
           f"{SEG_LOGIT_MEDIAN:g}), argmax equal at {agree:.4f} (tol {SEG_ARGMAX_SHARE})")
    if share > SEG_LOGIT_SHARE or median > SEG_LOGIT_MEDIAN or agree < SEG_ARGMAX_SHARE:
        fail("train-seg parity: " + msg)
    return msg + "; one step, " + step_parity(cpu, card, clouds, labels,
                                               f"{SEG_PARITY_CLOUDS} clouds x {SEG_POINTS}")


# --- Multi-scan mapping and the method sweep (registration/sequence.py) ----

# The reference's map-sequence result keys, in its order.
MAP_KEYS = ["num_edges", "mean_edge_inliers", "ate_odometry", "ate_graph", "ate_ba",
            "mean_step_rre", "max_step_rre", "step_rre_odom", "step_rre_graph", "mean_edge_rre"]
RESULT_KEYS = ["rre", "rte", "rmse", "succ", "rmse_succ", "reg_time"]


def run_cli(argv: list, logger_name: str | None = None) -> tuple[dict, list]:
    """`cli.main(argv)` in this process (device: the card, the CLI's
    default): its `key: value` lines as a dict, and the arguments of the
    records that the preset's logger `logger_name` wrote during the call."""
    import contextlib
    import io
    import logging

    from rift_tpu_torch import cli
    from rift_tpu_torch.train.utils import get_logger

    records: list = []
    handler = logging.Handler()
    handler.emit = records.append
    log = get_logger(logger_name) if logger_name else None
    if log is not None:
        log.addHandler(handler)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            code = cli.main(argv)
    finally:
        if log is not None:
            log.removeHandler(handler)
    if code != 0:
        fail(f"cli {' '.join(argv)} exited {code}: {out.getvalue()}")
    results = {k: float(v) for k, v in (line.split(": ") for line in out.getvalue().splitlines())}
    return results, records


def map_launches(num_scans: int, picp: bool) -> dict:
    """The reckoned K1-K3 launches of one map-sequence call."""
    from rift_tpu_torch.registration import build_edges

    chunks = -(-num_scans // MAP_CHUNK)
    batches = -(-len(build_edges(num_scans, MAP_LOOP_STRIDE)[0]) // MAP_EDGE_BATCH)
    return {"normals_moments": chunks + (2 * batches if picp else 0),
            "scatter_mean": 2 * chunks, "corner_gather": 2 * chunks}


def map_phase(wrappers: dict) -> dict:
    """`cli map-sequence` of MAP_PRESET on the card from a seeded checkpoint,
    once per MAP_RUNS entry: the call's seconds, its stages' seconds (the
    'map-sequence seconds' record of run_map_sequence), peak memory,
    launches against map_launches, and its metrics (the reference's keys,
    finite); then K1, K2 and K3 at a feature chunk's shapes."""
    import torch

    from rift_tpu_torch.data import get_sequence
    from rift_tpu_torch.train import resolve_extractor

    runs = []
    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = eval_checkpoint(ckpt_dir, MAP_PRESET)
        for label, path, overrides in MAP_RUNS:
            for fn in wrappers.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            metrics, records = run_cli(["map-sequence", "--preset", MAP_PRESET, "--ckpt",
                                        ckpt_dir, *overrides], cfg.name)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t1
            launches = read_counts(wrappers)
            num_scans = 96 if "sequence.num_scans=96" in overrides else cfg.sequence.num_scans
            want = map_launches(num_scans, any("+picp" in o for o in overrides))
            if any(launches[name] != want.get(name, 0) for name in wrappers):
                fail(f"map-sequence ({label}): launches {launches}, reckoned {want}")
            if list(metrics) != MAP_KEYS or not all(math.isfinite(v) for v in metrics.values()):
                fail(f"map-sequence ({label}) printed {metrics}")
            seconds = [r.args if isinstance(r.args, dict) else r.args[0] for r in records
                       if str(r.msg).startswith("map-sequence seconds")]
            if len(seconds) != 1:
                fail(f"map-sequence ({label}) logged no stage seconds")
            method = next((o.split("=", 1)[1] for o in overrides
                           if o.startswith("evaluate.method=")), cfg.evaluate.method)
            runs.append(dict(label=label, path=path, method=method, run_s=run_s,
                             seconds=seconds[0], launches=launches,
                             reckoned=want, metrics=metrics, num_scans=num_scans,
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        model = resolve_extractor(cfg)
    scans = torch.as_tensor(get_sequence(cfg.sequence).scans[:MAP_CHUNK], device="cuda")
    return dict(runs=runs, kernels=eval_kernel_times(model, scans, scans[:0]), config=cfg)


def oracle_features(seq):
    """World coordinates as each scan point's descriptor: the nearest
    physical point is the nearest feature."""
    import numpy as np

    return np.stack([s @ p[:3, :3].T + p[:3, 3]
                     for s, p in zip(seq.scans, seq.gt_poses)]).astype(np.float32)


def map_parity() -> str:
    """map_sequence of MAP_PRESET's settings on oracle features of its
    sequence, card vs CPU (MAP_TOL); the pose graph and BA on the CPU run's
    own inputs on the card, twice under sync debug mode "error": bit-equal,
    within SOLVE_TOL of the CPU's poses' scale; then with the one-rank
    group `--mesh` makes (NCCL), graph and BA bit-equal to the card run."""
    import numpy as np
    import torch

    from rift_tpu_torch.data import get_sequence
    from rift_tpu_torch.parallel.mesh import mesh_group
    from rift_tpu_torch.registration import bundle_adjust, map_sequence, optimize_pose_graph
    from rift_tpu_torch.train import get_config

    cfg = get_config(MAP_PRESET)
    ev = cfg.evaluate
    seq = get_sequence(cfg.sequence)
    feats = oracle_features(seq)
    kw = dict(gt_poses=seq.gt_poses, method=ev.method, noise_bound=ev.noise_bound,
              num_hypotheses=ev.num_hypotheses, inlier_threshold=ev.inlier_threshold,
              loop_stride=MAP_LOOP_STRIDE, seed=cfg.seed)
    t1 = time.perf_counter()
    card = map_sequence(seq.scans, feats, device="cuda", **kw)
    card_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    cpu = map_sequence(seq.scans, feats, device="cpu", **kw)
    cpu_s = time.perf_counter() - t1
    diffs = {k: float(np.abs(getattr(card, k) - getattr(cpu, k)).max())
             for k in ("measurements", "graph", "ba")}
    diffs.update({k: abs(card.metrics[k] - cpu.metrics[k])
                  for k in ("ate_odometry", "ate_graph", "ate_ba")})
    if max(diffs.values()) > MAP_TOL or not np.array_equal(card.edges[0], cpu.edges[0]):
        fail(f"map parity: card vs CPU on oracle features {diffs} (tol {MAP_TOL})")

    dev = torch.device("cuda")
    g = {k: torch.as_tensor(v, device=dev) for k, v in cpu.inputs["graph"].items()}
    b = {k: torch.as_tensor(v, device=dev) for k, v in cpu.inputs["ba"].items()}
    edges = (g["i_idx"], g["j_idx"], g["measurements"], b["edge_weights"])

    def graph_solve():
        return optimize_pose_graph(g["poses"], g["i_idx"], g["j_idx"], g["measurements"],
                                   g["weights"], num_iterations=10)

    def ba_solve():
        return bundle_adjust(b["poses"], b["landmarks"], b["obs_pose"], b["obs_local"],
                             num_iterations=8, huber_delta=1.5 * ev.noise_bound, edges=edges)

    graph_solve(), ba_solve()  # warm-up outside the sync check
    times, outs = {"graph": [], "ba": []}, {"graph": [], "ba": []}
    for _ in range(2):
        for name, fn in (("graph", graph_solve), ("ba", ba_solve)):
            outs[name].append(run_stage(name, fn, True, None, sync_free=True))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t1) * 1e3)
    (g1, g2), (b1, b2) = outs["graph"], outs["ba"]
    if not (torch.equal(g1, g2) and torch.equal(b1[0], b2[0]) and torch.equal(b1[1], b2[1])):
        fail("map parity: two card solves on the same inputs differ")
    scale = max(1.0, float(np.abs(cpu.graph).max()))
    solve_err = {"graph": float(np.abs(g1.cpu().numpy() - cpu.graph).max()),
                 "ba": float(np.abs(b1[0].cpu().numpy() - cpu.ba).max())}
    if max(solve_err.values()) > SOLVE_TOL * scale:
        fail(f"map parity: the card's solves on the CPU's inputs miss its poses by "
             f"{solve_err} (tol {SOLVE_TOL} x {scale:.3f})")

    with mesh_group(dev) as group:
        backend = torch.distributed.get_backend(group)
        mesh = map_sequence(seq.scans, feats, device="cuda", group=group, **kw)
    if not (np.array_equal(mesh.graph, card.graph) and np.array_equal(mesh.ba, card.ba)):
        fail(f"map parity: --mesh's one-rank {backend} solves differ from the unsharded ones "
             f"by {float(np.abs(mesh.graph - card.graph).max()):.3e} (graph), "
             f"{float(np.abs(mesh.ba - card.ba).max()):.3e} (BA)")
    n_lm = cpu.inputs["ba"]["landmarks"].shape[0]
    return (f"oracle features, {len(seq)} x {seq.scans.shape[1]}: card {card_s:.2f} s, CPU "
            f"{cpu_s:.2f} s, card vs CPU max diffs {json.dumps({k: float(f'{v:.3g}') for k, v in diffs.items()})} "
            f"(tol {MAP_TOL}); ATE odometry/graph/BA {card.metrics['ate_odometry']:.4f}/"
            f"{card.metrics['ate_graph']:.4f}/{card.metrics['ate_ba']:.4f} (CPU "
            f"{cpu.metrics['ate_ba']:.4f}); on the CPU's inputs ({len(edges[0])} edges, {n_lm} "
            f"landmarks): pose graph {sorted(times['graph'])[0]:.2f} ms, BA "
            f"{sorted(times['ba'])[0]:.2f} ms (best of 2), max diff to the CPU "
            f"{solve_err['graph']:.2e}/{solve_err['ba']:.2e} (tol {SOLVE_TOL * scale:.2e}), "
            f"two calls bit-equal, no host sync; --mesh ({backend}, one rank) bit-equal")


def sweep_phase(wrappers: dict) -> dict:
    """`cli evaluate --methods` of SWEEP_PRESET on the card from a seeded
    checkpoint: per-method results (finite), launches (SWEEP_LAUNCHES a
    batch); then on its first batch the match pass timed (median of
    TIMED_BATCHES), one staged batch's launches, the teaserpp row's poses
    bit-equal to register_eval_batch's, and K1-K3 at its shapes."""
    import dataclasses

    import torch

    from rift_tpu_torch.data import get_pairs
    from rift_tpu_torch.train import resolve_extractor
    from rift_tpu_torch.train.loop import match_eval_batch, register_eval_batch, solve_eval_batch

    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = eval_checkpoint(ckpt_dir, SWEEP_PRESET)
        ev = cfg.evaluate
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        results, _ = run_cli(["evaluate", "--preset", SWEEP_PRESET, "--ckpt", ckpt_dir,
                              "--methods", ",".join(SWEEP_METHODS)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = read_counts(wrappers)
        batches = 1 + -(-ev.num_pairs // ev.batch_pairs)  # the warm-up and the timed ones
        if any(launches[k] != SWEEP_LAUNCHES.get(k, 0) * batches for k in wrappers):
            fail(f"evaluate --methods: launches {launches} in {batches} batches, expected "
                 f"{SWEEP_LAUNCHES} a batch")
        want_keys = [f"{m.replace('+', '_')}_{k}" for m in SWEEP_METHODS for k in RESULT_KEYS]
        if list(results) != want_keys or not all(math.isfinite(v) for v in results.values()):
            fail(f"evaluate --methods printed {results}")
        model = resolve_extractor(cfg)
    dev = torch.device("cuda")
    batch = next(get_pairs(ev.pairs_path, ev.num_points, ev.pairs_mode,
                           ev.num_pairs).batches(ev.batch_pairs))
    src, dst = (torch.as_tensor(a, device=dev) for a in (batch.source, batch.target))
    times = []
    for _ in range(TIMED_BATCHES):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        matches = match_eval_batch(model, src, dst, ev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    before = read_counts(wrappers)
    matches = match_eval_batch(model, src, dst, ev)
    gen = torch.Generator(device=dev)
    ests = {m: solve_eval_batch(src, dst, matches, ev, m, gen.manual_seed(cfg.seed))
            for m in SWEEP_METHODS}
    after = read_counts(wrappers)
    per_batch = {k: after[k] - before[k] for k in after}
    if any(per_batch[k] != SWEEP_LAUNCHES.get(k, 0) for k in per_batch):
        fail(f"evaluate --methods: a staged batch launched {per_batch}, expected "
             f"{SWEEP_LAUNCHES}")
    est = register_eval_batch(model, src, dst, dataclasses.replace(ev, method="teaserpp"))
    if not torch.equal(ests["teaserpp"], est):
        fail(f"evaluate --methods: the teaserpp row's poses differ from register_eval_batch's "
             f"by {float((ests['teaserpp'] - est).abs().max()):.3e}")
    return dict(results=results, run_s=run_s, peak_gb=peak_gb, launches=launches,
                batches=batches, per_batch=per_batch, match_ms=sorted(times)[len(times) // 2],
                kernels=eval_kernel_times(model, src, dst, targets_k1=True), evaluate=ev)


def reg_lines(preset: str, rg: dict, smi: str, t0: float) -> None:
    """The result lines of a reg_phase run of `preset`."""
    res, ev = rg["results"], rg["evaluate"]
    print(f"evaluate {preset}: {smi}: {ev.method} ({ev.num_hypotheses} hypotheses, inlier "
          f"threshold {ev.inlier_threshold}, noise bound {ev.noise_bound}), cube trunk (dgcnn, "
          f"global PPF, reference LRF), {ev.num_pairs} {ev.pairs_mode} pairs x "
          f"{ev.num_points} points, flips, canonical voxels, {ev.batch_pairs} pairs a batch: "
          f"{1.0 / res['reg_time']:.2f} pairs/s by reg_time ({res['reg_time'] * 1e3:.2f} ms a "
          f"pair), {rg['ms_per_batch']:.2f} ms per {ev.batch_pairs}-pair batch (median of "
          f"{TIMED_BATCHES}), {ev.batch_pairs / rg['ms_per_batch'] * 1e3:.2f} pairs/s; whole "
          f"call {rg['run_s']:.2f} s for {rg['batches']} batches with the warm-up; peak "
          f"{rg['peak_gb']:.2f} GB (RANSAC alone {rg['ransac_gb']:.2f} GB); staged batch: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in rg["split"].items())
          + f"; result (seeded weights: information only) "
          f"{json.dumps({k: round(v, 6) for k, v in res.items()})}", flush=True)
    print(f"evaluate {preset} profile (one batch): {json.dumps(rg['profile'])}", flush=True)
    phase(f"evaluate {preset}", t0,
          f"launches {rg['launches']} in {rg['batches']} batches, {rg['per_batch']} in the "
          f"staged one; staged pose bit-equal to register_eval_batch's; median RRE of the "
          f"staged batch {rg['median_rre']:.3f} deg; parity: {rg['parity']}; methods: "
          f"{rg['sweep']}")


def main() -> int:
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke needs one CUDA card",
              file=sys.stderr, flush=True)
        return 2
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        smi = "nvidia-smi not available"
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    phase("device", t0, f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
                        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    from rift_tpu_torch.data import SyntheticPairs
    from rift_tpu_torch.models import bench_model
    from rift_tpu_torch.ops.cuda import build, kernel_wrappers
    from rift_tpu_torch.registration import pair_errors

    build.load()
    phase("build", t0, f"{build.lib_path} built in {build.build_seconds:.2f} s")

    dev = torch.device("cuda")
    src_np, dst_np, gt_np = SyntheticPairs(num_pairs=NUM_PAIRS, num_points=NUM_POINTS,
                                           mode="noise", seed=0).arrays()
    src = torch.as_tensor(src_np, device=dev)
    dst = torch.as_tensor(dst_np, device=dev)
    gt = torch.as_tensor(gt_np, device=dev)

    t0 = time.perf_counter()
    report: dict = {}
    check_kernels(torch.cat([src, dst], 0), report)
    check_large_clouds(report)
    phase("kernels", t0, "all kernels agree with their plain versions")

    t0 = time.perf_counter()
    model = seeded_model(0).to(dev)
    wrappers = kernel_wrappers()
    est, ms, launches = register_phase(model, src, dst, wrappers, REGISTER_LAUNCHES)
    errs = pair_errors(src, gt, est)
    phase("main", t0, f"{NUM_PAIRS} pairs x {NUM_POINTS} points: {ms:.2f} ms/batch "
                      f"(median of {TIMED_BATCHES}), {NUM_PAIRS / ms * 1e3:.2f} pairs/s; "
                      f"median RRE {float(errs['rre'].median()):.3f} deg, "
                      f"RTE {float(errs['rte'].median()):.4f} (random weights: "
                      f"information only); launches {launches}")

    t0 = time.perf_counter()
    phase("parity", t0, parity(model, src, dst, est, FEAT_POINT_TOL, FEAT_POINT_SHARE,
                               MASK_AGREE))

    t0 = time.perf_counter()
    src_l, dst_l, _ = (torch.as_tensor(a, device=dev) for a in SyntheticPairs(
        num_pairs=LARGE_PAIRS, num_points=LARGE_POINTS, mode="noise", seed=1).arrays())
    est_l, ms_l, launches_l = register_phase(model, src_l, dst_l, wrappers, REGISTER_LAUNCHES,
                                             timed=1)
    phase("large", t0, f"{LARGE_PAIRS} pairs x {LARGE_POINTS} points, flagship: {ms_l:.2f} "
                       f"ms/batch; launches {launches_l}; parity: "
                       + parity(model, src_l, dst_l, est_l, FEAT_POINT_TOL, FEAT_POINT_SHARE,
                                MASK_AGREE, pairs=LARGE_PAIRS))

    t0 = time.perf_counter()
    bench = seeded_model(0, bench_model("dgcnn")).to(dev)
    est_b, ms_b, launches_b = register_phase(bench, src, dst, wrappers, BENCH_LAUNCHES)
    errs = pair_errors(src, gt, est_b)
    print(f"bench: {smi}: bench.py's model (sph_dg, bf16): {ms_b:.2f} ms/batch, "
          f"{NUM_PAIRS / ms_b * 1e3:.2f} pairs/s at {NUM_PAIRS} pairs x {NUM_POINTS} points "
          f"(median of {TIMED_BATCHES}); f32 flagship (sph_pt): {ms:.2f} ms/batch, "
          f"{NUM_PAIRS / ms * 1e3:.2f} pairs/s", flush=True)
    phase("bench", t0, f"median RRE {float(errs['rre'].median()):.3f} deg, RTE "
                       f"{float(errs['rte'].median()):.4f} (random weights: information "
                       f"only); launches {launches_b}")
    t0 = time.perf_counter()
    phase("bench parity", t0, parity(bench, src, dst, est_b, FEAT_POINT_TOL_BF16,
                                     FEAT_POINT_SHARE_BF16, MASK_AGREE_BF16))

    t0 = time.perf_counter()
    for label, m in (("f32 flagship", model), ("bf16 bench", bench)):
        split = stage_split(m, src, dst)
        print(f"stages: {label}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items()),
              flush=True)
    phase("stages", t0, "one staged batch of each model")
    del bench

    t0 = time.perf_counter()
    tr = train_phase(wrappers)
    print(f"train: {smi}: {tr['ms_per_step']:.2f} ms/step (median of steps 2-{TRAIN_STEPS} "
          f"on a fixed batch), {tr['clouds_per_s']:.2f} clouds/s at {TRAIN_BATCH} x "
          f"{NUM_POINTS}; forward {tr['split_ms'][0]:.2f} ms, backward "
          f"{tr['split_ms'][1]:.2f} ms, optimizer {tr['split_ms'][2]:.2f} ms; peak "
          f"{tr['peak_gb']:.2f} GB", flush=True)
    print(f"train profile (one step): {json.dumps(tr['profile'])}", flush=True)
    phase("train", t0, f"train() {TRAIN_LOOP_STEPS} steps + validation in "
                       f"{tr['loop_s']:.2f} s (best {tr['best']}); fixed-batch losses "
                       f"{short(tr['losses'])}; launches {tr['launches']}")

    t0 = time.perf_counter()
    phase("train parity", t0, train_parity())
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ev = eval_phase(wrappers)
    res = ev["results"]
    print(f"evaluate: {smi}: flagship evaluation (teaserpp, flips, canonical voxels), "
          f"{ev['batch_pairs']} pairs a batch: {1.0 / res['reg_time']:.2f} pairs/s by reg_time "
          f"({res['reg_time'] * 1e3:.2f} ms a pair), {ev['ms_per_batch']:.2f} ms per "
          f"{ev['batch_pairs']}-pair batch (median of {TIMED_BATCHES}), "
          f"{ev['batch_pairs'] / ev['ms_per_batch'] * 1e3:.2f} pairs/s; whole call "
          f"{ev['run_s']:.2f} s for {ev['batches']} batches with the warm-up; peak "
          f"{ev['peak_gb']:.2f} GB; staged batch: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ev["split"].items())
          + f"; result (seeded weights: information only) "
          f"{json.dumps({k: round(v, 6) for k, v in res.items()})}", flush=True)
    print(f"evaluate profile (one batch): {json.dumps(ev['profile'])}", flush=True)
    phase("evaluate", t0, f"launches {ev['launches']} in {ev['batches']} batches, "
                          f"{ev['per_batch']} in the staged one; staged pose bit-equal to "
                          f"register_eval_batch's (max abs diff {ev['staged_diff']:.3e}); median "
                          f"RRE of the staged batch {ev['median_rre']:.3f} deg; parity: "
                          + ev["parity"])
    for name, rows in ev["kernels"].items():
        report[name]["eval_5b"] = rows
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rg = reg_phase(wrappers)
    reg_lines(REG_PRESET, rg, smi, t0)
    for name, rows in rg["kernels"].items():
        report[name]["eval_cube"] = rows
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    icl = reg_phase(wrappers, ICL_PRESET, through_cli=True, sweep=False)
    reg_lines(ICL_PRESET, icl, smi, t0)
    for name, rows in icl["kernels"].items():
        report[name]["eval_icl"] = rows

    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as bf16_dir:
        t0 = time.perf_counter()
        bf = bf16_train_phase(wrappers, bf16_dir)
        print(f"train bf16: {smi}: {BF16_PRESET} bf16 (cli train): {bf['ms_per_step']:.2f} "
              f"ms/step (median of steps 2-{TRAIN_STEPS} on a fixed batch), "
              f"{bf['clouds_per_s']:.2f} clouds/s at {TRAIN_BATCH} x {NUM_POINTS}; forward "
              f"{bf['split_ms'][0]:.2f} ms, backward {bf['split_ms'][1]:.2f} ms, optimizer "
              f"{bf['split_ms'][2]:.2f} ms; peak {bf['peak_gb']:.2f} GB", flush=True)
        print(f"train bf16 profile (one step): {json.dumps(bf['profile'])}", flush=True)
        phase("train bf16", t0, f"cli train {TRAIN_LOOP_STEPS} steps + validation in "
                                f"{bf['loop_s']:.2f} s (epoch loss {bf['train_loss']:.4f}, best "
                                f"{bf['best']}); fixed-batch losses {short(bf['losses'])}; "
                                f"launches {bf['launches']}; {bf['fps']}")
        t0 = time.perf_counter()
        phase("train bf16 parity", t0, bf16_train_parity())
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ce = cls_eval_phase(wrappers, bf16_dir)
        print(f"evaluate-cls: {smi}: {BF16_PRESET} bf16 checkpoint, {ce['calls']} forwards of "
              f"{ce['clouds']} clouds: whole call {ce['run_s']:.2f} s, forwards "
              f"{ce['forward_s']:.2f} s, {ce['clouds'] / ce['forward_s']:.2f} clouds/s; peak "
              f"{ce['peak_gb']:.2f} GB; result (seeded, barely trained weights: information "
              f"only) {json.dumps({k: round(v, 6) for k, v in ce['results'].items()})}",
              flush=True)
        phase("evaluate-cls", t0, f"launches {ce['launches']}; parity: {ce['parity']}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dp = dp_phase(wrappers)
    print(f"train dp: {smi}: one-rank NCCL group, f32 flagship at {TRAIN_BATCH} x "
          f"{NUM_POINTS}: sharded step {dp['dp_ms']:.2f} ms/step, plain step "
          f"{dp['plain_ms']:.2f} ms/step (medians of {DP_STEPS}, in turns)", flush=True)
    phase("train dp", t0, f"loss {dp['loss']:.6f}, accuracy, and the {dp['tensors']} "
                          f"parameters and buffers bit-equal to train_step's; launches "
                          f"{dp['launches']}; group destroyed")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sg = seg_phase(wrappers)
    print(f"train-seg: {smi}: {SEG_PRESET} (cli train-seg, {SEG_LOOP_STEPS} steps + "
          f"evaluation of the {sg['test_items']} test items): whole call "
          f"{sg['loop_s']:.2f} s, epoch loss {sg['log']['loss']:.4f}, best mIoU "
          f"{sg['best']['iou']:.4f} (seeded weights, {SEG_LOOP_STEPS} steps: information "
          f"only); fixed batch {sg['ms_per_step']:.2f} "
          f"ms/step (median of steps 2-{TRAIN_STEPS}), {sg['clouds_per_s']:.2f} clouds/s, "
          f"{sg['clouds_per_s'] * SEG_POINTS:.0f} points/s at {SEG_BATCH} x {SEG_POINTS}; "
          f"forward {sg['split_ms'][0]:.2f} ms, backward {sg['split_ms'][1]:.2f} ms, "
          f"optimizer {sg['split_ms'][2]:.2f} ms; peak {sg['peak_gb']:.2f} GB; eval forward "
          f"{sg['eval_ms']:.2f} ms at {sg['eval_clouds']} x {SEG_POINTS} "
          f"({sg['eval_clouds'] / sg['eval_ms'] * 1e3:.2f} clouds/s)", flush=True)
    print(f"train-seg profile (one step): {json.dumps(sg['profile'])}", flush=True)
    phase("train-seg", t0, f"fixed-batch losses {short(sg['losses'])}; launches "
                           f"{sg['launches']}, {sg['per_forward']} an eval forward; parity: "
                           f"{sg['parity']}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mp = map_phase(wrappers)
    for run in mp["runs"]:
        print(f"map-sequence ({run['label']}): {smi}: {MAP_PRESET} (cube trunk, flips, "
              f"{run['method']}), {run['num_scans']} scans x {mp['config'].sequence.num_points} points, "
              f"{int(run['metrics']['num_edges'])} edges: whole call {run['run_s']:.2f} s; "
              f"stages " + ", ".join(f"{k} {v:.3f} s" for k, v in run["seconds"].items())
              + f"; peak {run['peak_gb']:.2f} GB; launches {run['launches']} (reckoned "
              f"{run['reckoned']}); metrics (seeded weights: information only) "
              f"{json.dumps({k: round(v, 6) for k, v in run['metrics'].items()})}", flush=True)
    phase("map-sequence", t0, f"{len(mp['runs'])} calls of cli map-sequence, launches as "
                              "reckoned, metrics finite")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase("map parity", t0, map_parity())
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sw = sweep_phase(wrappers)
    ev_sw = sw["evaluate"]
    print(f"evaluate --methods: {smi}: {SWEEP_PRESET} ({', '.join(SWEEP_METHODS)} on one "
          f"matching pass), {ev_sw.num_pairs} {ev_sw.pairs_mode} pairs x {ev_sw.num_points} "
          f"points, {ev_sw.batch_pairs} a batch: whole call {sw['run_s']:.2f} s for "
          f"{sw['batches']} batches with the warm-up; matching {sw['match_ms']:.2f} ms a batch "
          f"(median of {TIMED_BATCHES}); " + "; ".join(
              f"{m} reg_time {sw['results'][m.replace('+', '_') + '_reg_time'] * 1e3:.3f} ms a "
              f"pair ({1.0 / sw['results'][m.replace('+', '_') + '_reg_time']:.2f} pairs/s), "
              f"rre {sw['results'][m.replace('+', '_') + '_rre']:.3f}"
              for m in SWEEP_METHODS)
          + f"; peak {sw['peak_gb']:.2f} GB (seeded weights: information only)", flush=True)
    phase("evaluate --methods", t0, f"launches {sw['launches']} in {sw['batches']} batches, "
                                    f"{sw['per_batch']} in a staged one; teaserpp row "
                                    "bit-equal to register_eval_batch's")
    for path, res in (("train_bf16", bf), ("evaluate_cls", ce), ("train_seg", sg),
                      ("map_sequence", mp), ("evaluate_methods", sw)):
        for name, rows in res["kernels"].items():
            report[name][path] = rows

    paths = {"register": launches, "register_2048": launches_l, "register_bf16": launches_b,
             "train": tr["launches"], "evaluate": ev["launches"],
             "evaluate_reg_noise": rg["launches"], "evaluate_reg_icl_nuim": icl["launches"],
             "train_bf16": bf["launches"], "evaluate_cls": ce["launches"],
             "train_dp": dp["launches"], "train_seg": sg["launches"],
             **{run["path"]: run["launches"] for run in mp["runs"]},
             "evaluate_methods": sw["launches"]}
    kernels = []
    for name, rep in report.items():
        kernels.append({
            "name": name, "route": "cuda", "source": rep["source"],
            "replaces": rep["replaces"],
            "launches": sum(counts[name] for counts in paths.values()),
            "launches_by_path": {path: counts[name] for path, counts in paths.items()},
            "max_abs_err": rep["max_abs_err"], "max_err": rep["max_abs_err"],
            "max_rel_err": rep["max_rel_err"], "tol": rep["tol"],
            "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "shapes": rep["shapes"],
            "dev_ms": rep["dev_ms"], "library_dev_ms": rep["library_dev_ms"],
            **{k: rep[k] for k in ("b2b_ms", "library_b2b_ms", "bit_equal", "adjoint_rel_err",
                                   "far_rel_err", "bf16", "max_steps", "equal_share",
                                   "library_steps", "per_shape", "other_shapes", "large",
                                   "degenerate", "other_r", "bisection_bound_ms",
                                   "neighbours_per_query", "int32_dev_ms", "other", "hard",
                                   "eval_5b", "eval_cube", "eval_icl", "train_bf16",
                                   "evaluate_cls", "train_seg", "map_sequence",
                                   "evaluate_methods")
               if k in rep}})
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
