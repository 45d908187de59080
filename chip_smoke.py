#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepvcp_tpu_torch) on one CUDA card.

Drives the port's five paths at full width (N = 10 000 points, 64
keypoints, 216 candidates, 32 neighbours): serving,
`pretrained.registrar("kitti25-rot")` on 16 held-out synthetic lidar pairs;
training, 12 fine-tuning steps of `kitti25-rot` through `train.Trainer`
under the recipe that trained it; global registration of pairs with
any rotation, `initializer.so3_global_init` then
`pretrained.cascade("modelnet-cascade")`, on two held sets of 16 pairs
(B = 2); the two-level candidate grouping, serving and fine-tuning
`kitti25` through kernels K4/K5; and LiDAR odometry, campaign_r5h's
12-frame sequence written as KITTI files, through
`pretrained.cascade("kitti-cascade")` and `kitti25-rot`, the pose graph,
the odometry CLI, `Registrar.stream` and `pretrained.routed_registrar`; and
the non-default engines: campaign_r4b's model_q5w under the windowed and
the dense engine (N = 2048), campaign_r4's model_r1c (keypoints branch),
`kitti25-rot` on the static band and in bf16, the plain two-level gather,
SetAbstractionMSG / FeaturePropagation, windowed training and the training
CLI's --save-vis; and the multi-device modules over a process group of one
NCCL rank: the sharded train step, ring_knn, the sharded pose graph and BA,
Trainer.fit with a heartbeat, plot and profile_stages; and the examples,
the trained-checkpoint regression and a 350-step convergence run, with K3
and the flat KNN held to the native host oracles; and the headline bench
(`python -m deepvcp_tpu_torch.bench`) at B = 1, 2, 4, 8; and, where 2 or more
cards are visible, the multi-device paths across them, one rank a card over
NCCL. It checks on the way:

  1. device      a CUDA card is present; prints nvidia-smi's name and power limit
  2. build       builds every CUDA kernel of the paths from csrc/ with nvcc
  3. kernels     K1 and K2 against their plain PyTorch versions at the
                 serving shapes and at the cascade's (phase 13's clouds,
                 B = 2), with each shape family's slab per 32-point tile
                 (max / mean; K2 also per 64-point tile and the share of a
                 slab within radius of its tile) and in-radius pairs: K1
                 max abs difference 0.0; K2 0.0 with integer cotangents
                 (also with forced ties), two calls bitwise equal, and with
                 Gaussian ones <= 1e-5 at the serving shapes and, at the
                 cascade's (sums of thousands of terms), within the bound
                 of any f32 order of summation of float64 sums; both also
                 at C = 8, 24, 40 and 128; median times per call and
                 behind a device hold
  4. registrar   16 pairs, GT-free RRE / RTE against the identity-init errors;
                 mean RRE <= 1.0 deg and mean RTE <= 0.05 m
  5. paths       kernel path against plain path on pair 0: same keypoints,
                 |dR| <= 1e-4, |dt| <= 1e-4 m, |dscores| <= 1e-5
  6. launches    K1 ran 6 times per Registrar call in step 4
  7. timing      per-call latency and a CUDA-event stage split (printed only)
  8. training    12 steps from kitti25-rot: finite loss and grad norm, step 0
                 (warmup lr 0) leaves the parameters as they were and later
                 steps change them, 6 K1 and 6 K2 launches per step. The 12
                 steps again from the same start, by default and twice under
                 deterministic algorithms: whether the two deterministic
                 runs end bit-identical, the time a step of each mode, the
                 GT-free accuracy after each run (printed only)
  9. train paths one step from kitti25-rot through the kernels against the
                 same step through the plain versions, under deterministic
                 algorithms: loss
                 within 1e-5 relative, every gradient tensor within 1e-4 of
                 its max (a cancelling sum, max below 1e-3 of the global
                 norm: of the norm), running statistics within 1e-6; the
                 kernel path run twice agrees with itself exactly
 10. train time  step time, forward / loss+backward+clip / Adam / metrics
                 split, profiler busy time, peak memory, and the fine-tuned
                 model's GT-free RRE / RTE on the 16 held pairs (printed only)
 12. K3          FPS kernel against its plain version at the global path's
                 shapes ([2, 10 000, 3] at npoint 4096 and 128; [2, 256, 3] at
                 64, the salient_fps shape), on a lattice cloud with every
                 point twice, and at N = 16 385, 40 000 and 70 000 (past the
                 cluster's registers: streamed): indices identical, one launch
                 each; median times; the pick protocol alone at cluster sizes
                 1-16 and the serial floor it sets an init
 13. global      so3_global_init + modelnet-cascade on the 16 lidar-like and
                 16 uniform-cube pairs: every lidar-like init RRE < 10 deg
                 and refined median RRE < 2 deg; at least 13 of 16 cube
                 inits < 10 deg; every stage's returned pose scores its
                 block's minimum, at most its column 0 (the guard); 2 K3
                 launches per init call, 12 K1 launches per cascade call
 14. global paths kernel path against plain path on the first batch of each
                 set: FPS indices equal, init R and t within 1e-6, cascade
                 pose within 1e-4
 15. global time  init and cascade latency, a CUDA-event split of the init
                 (FPS / coarse ICP sweep / fine rescore / fine ICP), busy time,
                 idle share, peak memory (printed only)
 16. K4/K5       one-hot gather and its scatter-add backward against their
                 plain versions at the two-level path's table and indices
                 (kitti25, pair 0), with every query into 8 rows and into
                 one row, at D = 5, at T = 600, at T = 3001 (K5's row
                 groups) and at a Q that is not a
                 multiple of K4's block: K4 identical to torch.gather; K5
                 0.0 with integer and with Gaussian cotangents, equal to
                 itself run twice; the path's per-64-row-group load; median
                 times of the kernels, the plain versions and torch.gather /
                 torch.scatter_add, per call and behind a device hold, warm
                 and with L2 flushed
 17. two-level   campaign_r5b W3: kitti25 with tgt_knn="two_level", T=512, on
                 phase 4's 16 pairs: mean RRE <= 1.0 deg and RTE <= 0.05 m, 2 K4
                 and 6 K1 launches per call; flat kitti25 and T=1024 on the
                 same pairs (printed only); recall against exact flat k-NN at
                 W2's operating point (extent-20 uniform cloud) >= 0.95
 18. two-level paths  kernel path against plain path on pair 0, as phase 5;
                 then latency beside flat kitti25's, the stage split (level 1,
                 level 2, the K4 gather, DFE + CPG), busy time and idle share
                 (printed only)
 19. two-level training  4 fine-tuning steps of kitti25 with the two-level
                 grouping under kitti25-rot's recipe: finite loss and grad
                 norm, 1 K4, 1 K5, 6 K1 and 6 K2 launches per step; one step
                 kernel path against plain path with phase 9's check; step
                 time and split (printed only)
 20. odometry    campaign_r5h's sequence (one 25 m lidar-like scene, seed
                 11, 12 frames yawing 1.5 deg and moving 0.8 + 0.15 i m a
                 frame) written as KITTI .bin scans and poses/00.txt, read
                 back identical through load_sequence_scans /
                 load_kitti_poses; warm-started register_sequence with O1
                 (kitti-cascade) and O2 (kitti25-rot, refine_iters 2): mean
                 t error <= 0.03 m and r error <= 2.5 deg for both; O1's
                 pose graph with skip edges (30 GN iterations) on the card
                 within 1e-4 of the same call on the CPU; run_odometry on 4
                 frames through the kernels within 1e-4 of the plain path;
                 the odometry CLI (a Trainer checkpoint of kitti25-rot's
                 weights): 12 frames, a finite ATE; stream(depth=4) on
                 phase 4's pairs bit-identical to per-call; the routed
                 registrar on campaign_r5d G3's held sets (N = 10 000):
                 every uniform batch voted low and every lidar-like one
                 high, each pose equal to its expert's Registrar within
                 1e-5; 6 K1 launches per stage call in every run; per-frame
                 latency, stream vs per call, the pose-graph solve and the
                 routing's cost (printed only)
 21. engines     model_q5w (campaign_r4b, windowed engine) on campaign_r4's 16
                 held uniform_small pairs at N = 2048, under the windowed and
                 the dense engine: finite poses; pair 0 on the card against
                 the CPU (TF32 off): the first SA stage's neighbour sets
                 identical but for queries with a point within 1e-5 of r^2
                 (counted), FE features and saliency within 1e-4 of their
                 max, keypoint sets equal (or swapped only at a saliency
                 near-tie), then the served pose within 1e-4, the CPU's
                 candidate selections pinned to the card's after each
                 differing row is checked to be a near-tie of the k-th
                 distance (the bf16 tile's ties break differently on the
                 two devices; the rows are counted); the preflight's
                 occupancy verdict and the GT-free RRE / RTE beside the
                 campaign's (printed). model_r1c (campaign_r4, keypoints
                 branch) at N = 10 000 on uniform_small: 6 K1 launches a
                 call, kernel vs plain path as phase 5. kitti25-rot with
                 use_pallas_band_max=False on phase 4's pairs: 0 K1
                 launches, each SA stage's static band on pair 0's inputs
                 bit-identical on the card and the CPU, and the card-vs-CPU
                 checks above (features and saliency at 3e-4 of their max on
                 these 25 m clouds, and closer to each other than the CPU's
                 f32 forward is to a float64 run). kitti25-rot in bf16: 6 K1 launches a call,
                 kernel vs plain path bit-identical. kitti25 two-level with
                 the plain gather: 0 K4 / K5 launches, pose bit-identical to
                 the K4 path's. SetAbstractionMSG [2, 10 000, 3] -> 1024 and
                 FeaturePropagation back: 1 K3 launch, kernel vs plain path
                 identical. 2 windowed Trainer steps of model_q5w: finite
                 loss and grad norm, step 0 (warmup lr 0) leaves the
                 parameters, step 1 moves them. The training CLI
                 --eval-only --save-vis on a kitti25-rot checkpoint: a .npy
                 pair per test pair and vis.pcd, pair 0 the registrar's
                 transformed source. Latency, busy time and idle share per
                 engine (printed)
 22. multi-device a process group of one NCCL rank and its 1 x 1 ("data",
                 "point") mesh. kitti25-rot at N = 10 000: one step of
                 make_train_step(mesh=...) against make_train_step() from one
                 state on one B = 2 batch (deterministic algorithms, jittered
                 warm start, step 100 so that lr > 0): loss within LOSS_RTOL,
                 grad norm and every gradient tensor within GRAD_RTOL (phase
                 9's rule), running statistics within STAT_ATOL, parameters
                 within 2.5 lr; 6 K1 and 6 K2 launches. ring_knn over one
                 point rank on pair 0's 13 824 candidates x 10 000 points, k =
                 32: the exact knn's neighbours but for distance ties
                 (counted). optimize_pose_graph_sharded and
                 optimize_landmark_ba(mesh=...) on phase 20's 12-frame graph
                 (64 landmarks seen from every frame): within 0.1 deg / 5e-3
                 and 0.05 deg / 2e-3 of the unsharded solves. Trainer.fit,
                 2 steps under the process group with heartbeat_interval
                 0.5: the heartbeat file, the watchdog's scan, rank 0's
                 checkpoints, 6 + 6 launches a step; plot --summary on its
                 metrics file; profile_stages on kitti25-rot beside the
                 registrar's busy time (printed, with the stages whose
                 device holds ran out). Then two gloo ranks sharing cuda:0
                 (NCCL takes one rank a card): all_reduce, broadcast and
                 all_gather of CUDA tensors give their values in each; B =
                 1 each of the same batch,
                 against the single-process B = 2 step: loss within rel
                 1e-4, grad norm rel 1e-3, RRE 0.05 deg, parameters 2.5 lr,
                 running statistics 1e-5 of their max, 6 K1 and 6 K2 a rank
                 (printed by each); the sharded solves over both ranks
                 within the bounds above. Then the point-partitioned step
                 on a 1 x 2 mesh, both ranks the whole B = 2 batch and each
                 half of the per-point work (models.point_partition: the
                 model's gate must pass), against the same single-process
                 step with the same bounds, the ranks equal, 6 K1 and 6 K2
                 a rank; each rank's peak memory beside the single-process
                 step's, its synced step time and the card's name and power
                 limit (printed). A rank that fails or outlasts its
                 timeout fails the run. ring_knn over more than one rank
                 runs in phase 25 over NCCL: gloo takes no CUDA tensors for
                 its point-to-point sends (batch_isend_irecv)
 23. oracles and examples  the native host library (native/pointcloud.cc,
                 built by the port) against the card: K3 on cloud 0 of each
                 of phase 12's clouds against the native FPS, indices
                 identical; the flat candidate KNN (approx_knn in f32, TF32
                 off) on pair 0's 13 824 candidates x 10 000 points, k = 32,
                 against the native knn: the same neighbour set on every row
                 but those whose k-th and (k+1)-th squared distances lie
                 within the matmul expansion's error bound (counted), with
                 the host oracle's time beside the card's. The
                 register_pair example in its three modes at N = 2048: finite
                 poses, 2 K3 launches with --full-so3; train_synthetic
                 --tiny --steps 3: 18 K1 + 18 K2. campaign_r4-fine at N =
                 1024 under tests/test_trained_checkpoint.py's assertions
                 (RRE <= 5 deg, RTE <= 0.15, the guard monotone), the pose
                 within 1e-4 of the CPU's (selections pinned). The 350-step
                 overfit run of tests/test_convergence.py: the pose
                 recovered GT-free, 6 K1 + 6 K2 a step, its time printed
 24. bench       the port's headline bench, deepvcp_tpu_torch.bench.run, at
                 N = 10 000 and B = 1, 2, 4, 8 (default config, random init
                 from a seed, SyntheticDataset pairs of extent 10): 6 K1
                 and 1 + refine_iters K6 bf16 launches a call and no other
                 kernel; finite outputs of the
                 batch's shapes; each pair of a B-pair call against its own
                 B = 1 call (the same keypoints; candidate selection rows
                 that differ must be near-ties of the k-th distance, counted
                 and pinned; then R, t, vcps, scores within 1e-4); at B = 4
                 every K1 call of the path bit-exact against the plain
                 version and the call through the plain versions within
                 1e-4. Per B, printed: per-call latency (median, min, max),
                 stream pairs/s, the first call's time, profiler busy time
                 and idle share, peak device memory. Then `python -m
                 deepvcp_tpu_torch.bench --iters 3 --warmup 1` as a
                 subprocess: exit 0 and the four-key JSON line last
 25. several cards  one rank a card over NCCL (parallel.initialize_multihost
                 binds rank r to card LOCAL_RANK). On any host: a one-rank
                 NCCL group of run_ranks(device="cuda") on cuda:0, and two
                 NCCL ranks that see one card refused with
                 initialize_multihost's RuntimeError. With 2 or more cards
                 visible, worlds of 2 and (with 4 cards) 4 ranks, each a
                 fresh run_ranks, against one card's result in this process:
                 a. rank r on card r, P distinct PCI bus ids (nvidia-smi's
                 topology, card 0's NVLink status, NCCL's version and its
                 channels by transport printed); b. ring_knn over the P
                 cards on pair 0's 13 824 candidates x 10 000 points, k = 32:
                 the exact knn's neighbours but for distance ties (counted),
                 distances exact, its CUDA-event time beside knn's after an
                 untimed first call; c. (4 ranks) the kitti25-rot registrar
                 with knn_mesh = 1 x 4 on phase 4's 16 pairs against the
                 single card: the same keypoints, the single card's candidate
                 selections pinned to the ring's after a near-tie check,
                 then R, t within 1e-4, 6 K1 launches a call on each rank;
                 d. train steps of kitti25-rot under its recipe (phase 22's
                 inputs) on 2 x 1 and 1 x 2 (2 ranks), 4 x 1 at B = 4, 1 x 4
                 and 2 x 2 at B = 2 (4 ranks; knn_mesh on every point group
                 of more than one rank) against the single-card step at the
                 same global B with phase 22's data-parallel bounds, the
                 point split's gate passed, the ranks equal, 6 K1 and 6 K2
                 a rank; each rank's step time and peak on its own card and
                 the scaling, the device's busy time and the NCCL kernels'
                 time (printed); e. (4 ranks) the sharded pose graph
                 and BA on phase 20's graph over a 4 x 1 mesh within phase
                 22's bounds; f. graft_entry.dryrun_multichip over the ranks:
                 every rank the same loss. A rank that fails or outlasts its
                 timeout fails the run
 26. K6          (run after phase 7) the k <= 32 nearest-point kernel
                 (ops/kernels/knn_select.py) on the benchmark's stream-b8
                 pairs (benchmark/generate.py, seed K6_SEED) against its
                 plain version (knn_select_reference: torch.topk of
                 square_distance's tile): the flat stage's candidates at
                 [8, 13 824] and [1, 13 824] queries and encode's 64
                 keypoints at [8, 64] and [1, 64], x 10 000 points, k =
                 32: every d2 and every row, in order, equal to the plain
                 version's, at each shape (exact ties counted); one launch
                 a call; median times of the kernel,
                 the plain version and square_distance + torch.topk (per
                 call and held) beside the kernel's bound; then 1 + 3
                 launches a kitti25-rot registrar call at B = 8 and B = 1
 27. K6 bf16     (run after phase 26) K6's bf16 arm (knn_select_bf16) on
                 lidar-fine's bf16 selection tile: the benchmark's
                 stream-b8-1m pairs (seed K6_SEED), the flat stage's
                 candidates at [8, 21 952] and [1, 21 952] queries and
                 encode's 64 keypoints at [8, 64] and [1, 64], and a
                 lattice cloud of many equal distances, x 10 000 points,
                 k = 32, against torch.topk of the bf16 tile chunked as
                 approx_knn chunks it: every bf16 d2 bit and every index
                 row, in order, equal, or the phase fails; the rows with a
                 tie at the k-th key and inside the list counted; one launch
                 a call; the kernel and the plain tile timed in turns beside
                 the kernel's bound; then 1 + 3 launches of the bf16 arm
                 (and none of the f32 arm) a lidar-fine registrar call
 11. no jax      neither jax nor the JAX package deepvcp_tpu was imported
                 (checked last)

Any failure exits non-zero. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels as JSON.
Run from the root of a checkout, with no arguments:  python3 chip_smoke.py

With --multicard (2 or more cards, else it exits 1 with the reason on
standard error) it runs phases 1-2, K1 and K2 at the serving shapes (the
first part of phase 3: the kernels line's numbers) and phase 25 alone, on
phase 20's pose graph computed for it; its kernels line holds K1 and K2
with their launches on the ranks' cards:
    python3 chip_smoke.py --multicard
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

N_POINTS = 10000
N_PAIRS = 16
SA_SHAPES = ((16, 0.1), (32, 0.2), (64, 0.4))   # (C, radius) of the 3 SA stages
LAUNCHES_PER_CALL = 2 * len(SA_SHAPES)           # 3 SA stages x 2 clouds
RRE_LIMIT_DEG, RTE_LIMIT_M = 1.0, 0.05
TRAIN_STEPS = 12
K2_GAUSS_LIMIT = 1e-5      # K2 vs plain with Gaussian cotangents (order of summation)
LOSS_RTOL, GRAD_RTOL, STAT_ATOL = 1e-5, 1e-4, 1e-6   # kernel vs plain train step
CANCEL_FRAC = 1e-3         # a gradient tensor below this share of |g| is a cancelling sum
# the global path: campaign_r5f W6, the JAX package's validation of it
GLOBAL_BATCHES, GLOBAL_B = 8, 2                  # 16 pairs per held set
FPS_SHAPES = ((2, N_POINTS, 4096), (2, N_POINTS, 128), (2, 256, 64))   # (B, N, npoint)
# past the old 16 384-point limit; 70 000 exceeds 16 blocks' registers
FPS_LARGE = ((2, 16385, 512), (2, 40000, 512), (2, 70000, 256))
EXTRA_CHANNELS = (8, 24, 40, 128)                # K1/K2 widths outside the SA stages'
SLAB_TILE = 32                                   # K1's queries per block
K3_PER_INIT = 2                                  # one FPS per cloud
K1_PER_CASCADE = 2 * LAUNCHES_PER_CALL           # two stages
INIT_BASIN_DEG, REFINED_MEDIAN_DEG, CUBE_IN_BASIN = 10.0, 2.0, 13
INIT_PATH_ATOL, CASCADE_PATH_ATOL = 1e-6, 1e-4   # kernel vs plain path
# the two-level path: campaign_r5b W3 (kitti25 at T=512 on phase 4's pairs)
# and W2 (recall at the bench operating point)
TWO_LEVEL = {"tgt_knn": "two_level", "tgt_knn_table": 512}
K4_PER_CALL = 2            # kitti25's refine_iters
TWO_LEVEL_STEPS = 4
RECALL_LIMIT = 0.95
# H100 SXM published peaks (NVIDIA datasheet): HBM bytes/s and
# float32 (non-tensor-core) operations/s, for the kernels' bounds
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
HOLD_CYCLES = 20_000_000   # ~10 ms of the card's clock: see hold_device
# odometry: campaign_r5h O1 / O2 (scripts/campaign_r5h.py:47-185) and the
# routed registrar on campaign_r5d G3's held sets (scripts/campaign_r5d.py:74-81)
ODO_FRAMES, ODO_SEED, ODO_RANGE = 12, 11, 25.0
ODO_T_LIMIT_M, ODO_R_LIMIT_DEG = 0.03, 2.5     # loose: they catch a broken path
ODO_GN_ITERS = 30
ODO_PATH_ATOL = GRAPH_ATOL = 1e-4              # kernel vs plain path; card vs CPU
ROUTE_B, ROUTE_BATCHES = 2, 8                  # 16 clouds per held set
ROUTE_ATOL = 1e-5                              # routed pose vs the chosen expert's
# phase 21, the engines: campaign_r4's held uniform_small pairs
# (scripts/campaign_r4_common.py:142-144); card vs CPU with TF32 off
ENGINE_PAIRS = 16
NEAR_TIE_D2 = 1e-5         # |d^2 - r^2| within which f32 rounding may flip a neighbour
CARD_CPU_RTOL = 1e-4       # FE features and saliency, of their max (unit-scale clouds)
# the same on 25 m clouds: a banded stage's first layer subtracts per-point
# projections of coordinates up to 25 m (max_u - p), which amplifies the
# matmuls' rounding. On phase 4's pair 0 cuBLAS against the CPU moves
# kitti25-rot's saliency by 1.112e-4 of its max, while each device's f32
# forward is further from a float64 run (static_band prints both; PERF.md,
# Findings): the limit is ~3x the card-vs-CPU reading
CARD_CPU_RTOL_25M = 3e-4
CARD_CPU_POSE = 1e-4       # R and t where the keypoint sets are equal
MSG_NPOINT = 1024
# phase 22, multi-device: the sharded step's parameters after one fresh-Adam
# step may differ by ~lr where a gradient element is rounding-sized
# (tests/test_parallel.py's bound); the solves' bounds are
# tests/test_distributed_ba.py's and test_landmark_ba.py's
SHARDED_PARAM_LR = 2.5
SHARD_GRAPH_DEG, SHARD_GRAPH_ATOL = 0.1, 5e-3
SHARD_BA_DEG, SHARD_BA_ATOL = 0.05, 2e-3
TOOLING_STEPS = 2
DP_STEP = 100              # kitti25_recipe's warmup_steps: lr at its peak
# two gloo ranks against the single-process step: tests/test_parallel.py's
# bounds, and the running statistics within 1e-5 of each tensor's max
DP_LOSS_RTOL, DP_GRAD_RTOL, DP_RRE_ATOL, DP_STAT_RTOL = 1e-4, 1e-3, 0.05, 1e-5
DP_BOUNDS = (DP_LOSS_RTOL, DP_GRAD_RTOL, DP_RRE_ATOL, DP_STAT_RTOL)
# bf16 against bf16. The single-process bf16 step is itself chaotic: one
# f32 ulp of one cloud's coordinates flips bf16 roundings through the
# model and moves its loss and grad norm by more than one bf16 step (2^-8)
# (engine_refs prints by how much), and the split's BatchNorm statistics,
# summed over the ranks in another order, move those roundings as much.
# So a bf16 split is held to BF16_SPREAD_X times the single-process step's
# own spread under such a nudge, measured in the same run, never to less
# than the data-parallel bounds
BF16_SPREAD_X = 4.0
F32_ULP = 2.0 ** -23
# phase 22's point splits beyond the exact slab in f32, each against the
# single-process step of its config: (checkpoint, config changes, its K1
# and K2 launches a rank a step)
ENGINE_SPLITS = {
    "windowed": ("campaign_r4b-q5w", {}, 0),
    "dense": ("campaign_r4b-q5w", {"neighbor_method": "dense"}, 0),
    "static band": ("kitti25-rot", {"use_pallas_band_max": False}, 0),
    "bf16": ("kitti25-rot", {"compute_dtype": "bfloat16"}, LAUNCHES_PER_CALL),
}
Q5W_POINTS = 2048          # campaign_r4b-q5w's trained N
TWO_RANK_TIMEOUT_S = 420
# phase 23: the examples' cloud size (register_pair's default) and
# tests/test_convergence.py's overfit run
EXAMPLE_POINTS = 2048
CONVERGENCE_STEPS = 350
# phase 24: the port's headline bench (deepvcp_tpu_torch.bench) at these
# batch sizes, each run with these timed calls and warmup; a pair alone vs in
# the batch (R, t, vcps, scores), and B = BENCH_PLAIN_B through the plain
# versions
BENCH_BATCHES = (1, 2, 4, 8)
BENCH_ITERS, BENCH_WARMUP = 5, 2
BENCH_ATOL = 1e-4
BENCH_PLAIN_B = 4
# phase 25, several cards: one rank a card over NCCL (run_ranks(device=
# "cuda"): rank r on card r), each path against one card's result. The
# train steps' meshes in a world of 2 and of 4 ranks, as (data, point,
# global B); a point group of P > 1 runs the candidate KNN as the ring
MULTI_STEPS = {2: ((2, 1, 2), (1, 2, 2)), 4: ((4, 1, 4), (1, 4, 2), (2, 2, 2))}
MULTI_TIMEOUT_S = 600
RING_REPS = 10
NCCL_REFUSED = "an NCCL group takes one card a rank"   # initialize_multihost's refusal
# phase 26, kernel K6: the benchmark's stream-b8 pairs of this seed
# (benchmark/generate.py), read from the checkout around this script
K6_SEED = 1234567891
# phase 27, K6's bf16 arm: the benchmark's stream-b8-1m pairs of the same
# seed, and a lattice of this step (m) over the 1 m clouds' box
K6_BF16_TRAFFIC = "stream-b8-1m"
LATTICE_STEP = 0.05
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def hold_device(torch) -> None:
    """Keep the card busy for ~10 ms, so that the launches enqueued next
    wait in the stream and run back to back: CUDA events around each then
    time the device's work alone, not the host's time to issue it."""
    torch.cuda._sleep(HOLD_CYCLES)


def cuda_median_ms(torch, fn, reps: int, warmup: int = 3, hold: bool = False) -> float:
    """Median time of fn() over `reps` runs, from CUDA events around each
    call. A call whose host work outlasts its device work is timed by the
    host's (the card waits for it); with `hold`, the runs are enqueued behind
    hold_device and the events time the device's work alone."""
    for _ in range(warmup):
        fn()
    if hold:
        hold_device(torch)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def issue_ms(torch, fn, reps: int) -> float:
    """Host time to issue one call of fn(), the mean over `reps` calls
    enqueued behind hold_device, so that the card never makes the host
    wait."""
    fn()
    torch.cuda.synchronize()
    hold_device(torch)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def turns_ms(torch, fns: dict, reps: int, rounds: int = 4, hold: bool = False,
             timer=None) -> dict:
    """Times of each of `fns` ({name: fn}), taken in turns (a, b, b, a, ...)
    over `rounds` rounds of `reps` runs each: {name: the rounds' medians}.
    A round is timed by timer(torch, fn, reps) where given (host_median_ms:
    synced wall time), else by CUDA events (cuda_median_ms, behind a device
    hold with `hold`)."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(timer(torch, fns[name], reps) if timer else
                               cuda_median_ms(torch, fns[name], reps=reps, hold=hold))
    return times


def host_median_ms(torch, fn, reps: int) -> float:
    """Median wall time of fn() followed by a device synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_time_per_call(torch, fn, calls: int, top: int = 8):
    """Device busy time per call of fn() from torch.profiler: the union of
    the intervals of every kernel, copy and fill on the card. User-annotation
    ranges (such as the optimizer's step) enclose kernels that are counted
    already and are left out. Also returns the `top` kernels (None: all)
    that take most of the time, (name, ms a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def on_device(e):
        return e.device_type == DeviceType.CUDA and not e.is_user_annotation

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy_us, reached = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in prof.events() if on_device(e)):
        if end > reached:
            busy_us += end - max(start, reached)
            reached = end
    rows = [(e.key[:60], e.self_device_time_total / 1e3 / calls)
            for e in prof.key_averages() if on_device(e)]
    return busy_us / 1e3 / calls, sorted(rows, key=lambda r: -r[1])[:top]


def host_syncs(torch, fn) -> list:
    """The lines of the port that make the card synchronise with the host
    in one call of fn(), with their counts, from
    torch.cuda.set_sync_debug_mode("warn") (which covers most, not all,
    synchronising operations)."""
    import collections

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return where.most_common()


def stage_split(torch, reg, src, tgt) -> dict:
    """Device time of each stage of one Registrar call, replaying its steps
    through the model's public pieces between CUDA events. The candidates'
    neighbourhoods are one stage on the flat path (KNN and gather), three on
    the two-level path (level-1 tables, level-2 selection, the K4 gather)."""
    from deepvcp_tpu_torch.loss import svd_refine
    from deepvcp_tpu_torch.ops.two_level import (
        gather_table_rows, keypoint_tables, table_neighbors)

    m = reg.model
    cfg = m.cfg
    marks = []

    def mark(stage=None):
        """End the stage running since the last mark (None: not counted)."""
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((stage, e))

    with torch.no_grad():
        mark()
        m.features(src)
        m.features(tgt)
        mark("fe_x2")
        enc = m.encode(src, tgt)   # runs FE x2 again; the difference is the rest
        mark("encode")
        B = src.shape[0]
        R = torch.eye(3, device=src.device).expand(B, 3, 3)
        t = torch.zeros(B, 3, device=src.device)
        best = reg.score(enc.keypoints, enc.tgt_xyz, R, t)
        for _ in range(reg.refine_iters):
            mark()
            kp_warm, cand = m.candidates(enc, R, t)
            if cfg.use_two_level_tgt_knn:
                args = m.two_level_args()
                table = keypoint_tables(enc.tgt_xyz, enc.tgt_table, kp_warm, args["table_size"],
                                        args["center_select_dtype"])
                mark("level1_tables")
                l_idx = table_neighbors(table[..., :3], kp_warm, cand, cfg.num_neighbors,
                                        args["select_dtype"])
                mark("level2_select")
                tnb = gather_table_rows(table, l_idx, args["use_kernel"])
                tnb = tnb.reshape(B, -1, cfg.num_neighbors, tnb.shape[-1])
                mark("k4_gather")
            else:
                tnb = m.candidate_neighbors(enc, kp_warm, cand)
                mark("candidate_knn_gather")
            vcp, _ = m.match(enc, cand, tnb, R)
            mark("dfe_cpg")
            w = enc.keypoint_saliency if reg.use_saliency_weights else None
            ref = svd_refine(enc.keypoints, vcp, reg.inlier_ratio, w)
            s = reg.score(enc.keypoints, enc.tgt_xyz, ref.R, ref.t)
            better = s < best
            R = torch.where(better[:, None, None], ref.R, R)
            t = torch.where(better[:, None], ref.t, t)
            best = torch.minimum(s, best)
            mark("svd_solve_guard")
    torch.cuda.synchronize()
    stages = {}
    for (_, a), (stage, b) in zip(marks, marks[1:]):
        if stage:
            stages[stage] = stages.get(stage, 0.0) + a.elapsed_time(b)
    stages["keypoints_src_dfe"] = stages.pop("encode") - stages["fe_x2"]
    return stages


def kitti25_recipe():
    """The recipe that trained kitti25-rot (scripts/campaign_r5g.py with
    campaign_r4_common.residual_tcfg): B=1, Adam at 1e-3, clip 10, cosine
    with warmup 100 over 21 760 steps, VCP and rotation (3.0) terms,
    saliency-weighted solves, jittered warm starts of 6 deg / 0.5 m."""
    from deepvcp_tpu_torch.train import TrainConfig

    return TrainConfig(batch_size=1, learning_rate=1e-3, grad_clip_norm=10.0,
                       lr_schedule="cosine", warmup_steps=100, total_steps=21760,
                       vcp_loss_weight=1.0, rot_loss_weight=3.0, use_saliency_weights=True,
                       init_translation="gt", init_rot_jitter_deg=6.0, init_trans_jitter=0.5,
                       log_every=1)


def train_step_split(torch, step_fn, state, model, batch):
    """Device time of the phases of one call of the train step, between CUDA
    events that hooks record: the model's forward; the loss, backward and
    clip (up to Adam's step); Adam; the metrics. Returns the new state and
    the split."""
    ev = []

    def mark(*_):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append(e)

    opt = state.optimizer
    hooks = [model.register_forward_hook(mark), opt.register_step_pre_hook(mark),
             opt.register_step_post_hook(mark)]
    try:
        mark()
        state, _ = step_fn(state, *batch)
        mark()
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    phases = ("forward", "loss_backward_clip", "adam", "metrics")
    if len(ev) != len(phases) + 1:
        fail(f"the train step split recorded {len(ev)} marks, expected {len(phases) + 1}")
    return state, {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(phases)}


def train_phase(torch, dev, pairs) -> dict:
    """Phases 8-10: fine-tune kitti25-rot for TRAIN_STEPS steps through the
    Trainer, hold one step's kernel path against its plain path, and time
    the step; then the fine-tuning steps again, by default and twice under
    deterministic algorithms (fine_tuning_repeats, printed). Returns the K1,
    K2 and K6 launch counts of the 12 gated steps."""
    import numpy as np

    from deepvcp_tpu_torch.ops.kernels import band_max
    from deepvcp_tpu_torch.ops.kernels.knn_select import knn_select, knn_select_bf16
    from deepvcp_tpu_torch.train import build_train_step
    from deepvcp_tpu_torch.train.optim import learning_rate_schedule

    trainer, tcfg, records, batches, saved = fine_tuning("kitti25-rot", {}, TRAIN_STEPS, dev)
    params0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}

    # 8. the main path: TRAIN_STEPS steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    band_max.banded_masked_max.launches = 0
    band_max.banded_masked_max_grad.launches = 0
    knn_select.launches = knn_select_bf16.launches = 0
    trainer.train_epoch(iter(batches[:1]), epoch=0)
    torch.cuda.synchronize()
    moved0 = [n for n, p in trainer.model.named_parameters() if not torch.equal(p, params0[n])]
    trainer.train_epoch(iter(batches[1:]), epoch=0)
    torch.cuda.synchronize()
    k1, k2 = band_max.banded_masked_max.launches, band_max.banded_masked_max_grad.launches
    k6, k6b = knn_select.launches, knn_select_bf16.launches
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    steps = [r for r in records if r["kind"] == "train"]
    for i, r in enumerate(steps):
        print(f"train step {i:2d}: loss {r['loss']:.5f}, l1 {r['l1']:.5f}, vcp_l1 "
              f"{r['vcp_l1']:.5f}, rre {r['rre_deg']:.4f} deg, rte {r['rte']:.5f} m, "
              f"grad_norm {r['grad_norm']:.4f}")
    if len(steps) != TRAIN_STEPS:
        fail(f"expected {TRAIN_STEPS} logged train steps, got {len(steps)}")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in steps):
        fail("a train step's loss or grad_norm is not finite")
    moved = sum(not torch.equal(p, params0[n]) for n, p in trainer.model.named_parameters())
    print(f"parameters changed by step 0 (warmup lr 0): {len(moved0)}; after "
          f"{TRAIN_STEPS} steps: {moved} of {len(params0)}")
    if moved0 or moved == 0:
        fail("step 0 changed the parameters, or the later steps changed none")
    print(f"launches over the {TRAIN_STEPS} train steps: K1 {k1}, K2 {k2}, K6 {k6} "
          f"({k1 / TRAIN_STEPS:g} and {k2 / TRAIN_STEPS:g} per step); {wall:.2f} s in all, "
          f"the first step's cold start included; peak device memory {peak:.1f} MiB")
    if k1 != LAUNCHES_PER_CALL * TRAIN_STEPS or k2 != LAUNCHES_PER_CALL * TRAIN_STEPS:
        fail(f"expected {LAUNCHES_PER_CALL} K1 and K2 launches per train step")

    # the fine-tuned model through the Registrar on the held pairs (not gated)
    rre, rte = held_accuracy(torch, dev, trainer.model, pairs)
    print(f"after {TRAIN_STEPS} fine-tuning steps, GT-free over {len(pairs)} held pairs: "
          f"mean RRE {rre:.4f} deg, mean RTE {rte:.5f} m")
    fine_tuning_repeats(torch, dev, pairs)

    # 9. one step through the kernels against the same step through the
    # plain versions, from kitti25-rot as loaded, with a fresh Adam
    step_fn = build_train_step(trainer.model, learning_rate_schedule(tcfg), tcfg)
    train_paths_agree(torch, trainer, step_fn, saved,
                      tuple(torch.from_numpy(a).to(dev) for a in batches[0]), "train step")

    # 10. timing (not gated)
    time_train_step(torch, trainer, step_fn, batches, dev, "train step", reps=10, plain_reps=3,
                    profile=True)
    return {"k1": k1, "k2": k2, "k6": k6, "k6b": k6b}


def held_accuracy(torch, dev, model, pairs) -> tuple:
    """GT-free mean RRE (deg) and RTE (m) of `model`'s weights through the
    kitti25-rot Registrar on the held pairs."""
    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.data import rotation_geodesic_deg, translation_error

    reg = pretrained.registrar("kitti25-rot", device=dev)
    reg.model.load_state_dict(model.state_dict(), strict=True)
    rre, rte = [], []
    for src, tgt, R_gt, t_gt in pairs:
        out = reg(src, tgt)
        rre.append(rotation_geodesic_deg(out.R, R_gt).item())
        rte.append(translation_error(out.t, t_gt).item())
    return statistics.mean(rre), statistics.mean(rte)


def fine_tuning_repeats(torch, dev, pairs) -> None:
    """Phase 8's TRAIN_STEPS fine-tuning steps four more times from
    kitti25-rot as loaded, in turns: as phase 8 runs them, twice under
    deterministic algorithms, and as phase 8 again (printed, not gated).
    Whether the two runs of each mode end at the same parameters bit for
    bit, each run's synced time a step after its first (the host reads each
    step's metrics, as in phase 8), and the fine-tuned model's GT-free
    accuracy on the held pairs."""
    runs = {}
    for what, det in (("default", False), ("deterministic", True),
                      ("deterministic, again", True), ("default, again", False)):
        trainer, _, _, batches, _ = fine_tuning("kitti25-rot", {}, TRAIN_STEPS, dev)
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                trainer.train_epoch(iter(batches[:1]), epoch=0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_epoch(iter(batches[1:]), epoch=0)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - 1)
        finally:
            torch.use_deterministic_algorithms(False)
        rre, rte = held_accuracy(torch, dev, trainer.model, pairs)
        runs[what] = ({n: p.detach().clone() for n, p in trainer.model.named_parameters()}, ms)
        print(f"{TRAIN_STEPS} fine-tuning steps, {what}: {ms:.3f} ms a step (synced, after "
              f"the first), then GT-free over {len(pairs)} held pairs: mean RRE {rre:.4f} deg, "
              f"mean RTE {rte:.5f} m")
    for mode in ("deterministic", "default"):
        a, b = runs[mode][0], runs[f"{mode}, again"][0]
        d = max((a[n] - b[n]).abs().max().item() for n in a)
        print(f"two {mode} runs of the {TRAIN_STEPS} steps: parameters bit-identical "
              f"{all(torch.equal(a[n], b[n]) for n in a)} (max|d| {d:.3e})")
    det_ms = runs["deterministic"][1] + runs["deterministic, again"][1]
    print(f"deterministic mode: {det_ms / (runs['default'][1] + runs['default, again'][1]):.3f}x "
          f"the default's time a step (both runs of each)")


def fine_tuning(name: str, cfg_changes: dict, steps: int, dev):
    """A Trainer under kitti25_recipe() on the registry checkpoint `name`
    (its config changed by `cfg_changes`), and the first `steps` clouds of
    the campaign's 256 (same rng stream). Returns (trainer, recipe, the list
    its logger appends to, the batches, the state the train-path check
    starts from: model and optimizer state dicts and step count)."""
    import copy
    import dataclasses

    from deepvcp_tpu_torch import convert, pretrained
    from deepvcp_tpu_torch.data import LidarLikeDataset, batch_iterator
    from deepvcp_tpu_torch.train import MetricsLogger, Trainer

    records = []

    class Records(MetricsLogger):
        def log(self, record):
            records.append(record)

    cfg, variables = pretrained.load(name, num_points=N_POINTS)
    tcfg = kitti25_recipe()
    trainer = Trainer(dataclasses.replace(cfg, **cfg_changes), tcfg, device=dev,
                      metrics=Records(None, echo=False))
    trainer.setup()
    trainer.model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    data = LidarLikeDataset(num_clouds=steps, num_points=N_POINTS, max_range=25.0, seed=10)
    batches = list(batch_iterator(data, 1, epoch=0, seed=0))
    # the train-path check starts from here, not from where the gated steps
    # (not reproducible bit for bit: gather's atomics) end
    saved = (copy.deepcopy(trainer.model.state_dict()),
             copy.deepcopy(trainer.state.optimizer.state_dict()), trainer.state.step)
    return trainer, tcfg, records, batches, saved


def train_paths_agree(torch, trainer, step_fn, saved, batch, what: str) -> None:
    """Phase 9's check: one train step from `saved` (model and optimizer
    state dicts, step count) on `batch` with the warm start (R_gt, t_gt +
    0.2), through the kernels twice and through the plain versions once,
    under deterministic algorithms. Fails unless the loss agrees within
    LOSS_RTOL, every gradient tensor within GRAD_RTOL of its max (a
    cancelling sum: of |g|), the running statistics within STAT_ATOL, and
    the kernel path with itself exactly."""
    from deepvcp_tpu_torch.ops.kernels import reference_path

    src, tgt, R, t = batch
    R_init, t_init = R, t + 0.2

    def one_step():
        trainer.model.load_state_dict(saved[0])
        trainer.state.optimizer.load_state_dict(saved[1])
        trainer.state.step = saved[2]
        trainer.state, m = step_fn(trainer.state, src, tgt, R, t, R_init, t_init)
        torch.cuda.synchronize()
        return (float(m["loss"]), float(m["grad_norm"]),
                {n: p.grad.clone() for n, p in trainer.model.named_parameters()},
                {n: b.clone() for n, b in trainer.model.named_buffers() if "running" in n})

    # Deterministic algorithms (gather's backward without atomics; cuBLAS
    # under CUBLAS_WORKSPACE_CONFIG, set in main), so that two runs of one
    # path agree bit for bit and what differs between the paths is the
    # kernels'. An op with no deterministic version warns and is named.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loss_k, norm_k, grads_k, stats_k = one_step()
            _, _, grads_k2, _ = one_step()
            with reference_path():
                loss_p, norm_p, grads_p, stats_p = one_step()
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught if "deterministic" in str(w.message)})
    print(f"ops without a deterministic version in the {what}: {nondet or 'none'}")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)

    def err(a, b):
        return {n: (a[n] - b[n]).abs().max().item() for n in b}

    # Each gradient tensor within GRAD_RTOL of its own max |g|. A tensor
    # whose max is below CANCEL_FRAC of the global norm is a sum that
    # (nearly) cancels: a bias ahead of a training-mode BatchNorm, exactly
    # 0 but for rounding, or sa1's bias0 and BatchNorm terms, summed over
    # every point behind a BatchNorm's mean. K2's order of summation alone
    # moves such a tensor by 3e-4 of its max up to more than its max, so it
    # is held to GRAD_RTOL of the global norm instead.
    own = {n: g.abs().max().item() for n, g in grads_p.items()}
    err_kp, err_kk = err(grads_k, grads_p), err(grads_k, grads_k2)
    rel_kp, cancelling = grad_rel_errors(err_kp, own, norm_p)
    worst = sorted(rel_kp, key=rel_kp.get)[-4:]
    for n in (sorted(rel_kp) if max(rel_kp.values()) > GRAD_RTOL else worst):
        print(f"  grad {n}: max|g| {own[n]:.3e}, max|dg| kernel vs plain {err_kp[n]:.3e} "
              f"= {rel_kp[n]:.2e} of {'|g|' if n in cancelling else 'its max'}, kernel vs "
              f"kernel {err_kk[n]:.3e}")
    grad_rel = max(rel_kp.values())
    kk_err = max(err_kk.values())
    stat_err = max((stats_k[n] - stats_p[n]).abs().max().item() for n in stats_p)
    print(f"{what}, kernel vs plain path: loss {loss_k:.7f} vs {loss_p:.7f} (rel "
          f"{loss_rel:.2e}), every gradient within {grad_rel:.2e} of its max ({len(cancelling)} "
          f"cancelling sums of |g|: {', '.join(cancelling)}), kernel vs kernel max |dg| "
          f"{kk_err:.3e}, |g| {norm_k:.6f} vs {norm_p:.6f}, max running-stat err {stat_err:.2e}")
    if loss_rel > LOSS_RTOL or grad_rel > GRAD_RTOL or stat_err > STAT_ATOL or kk_err != 0.0:
        fail(f"the {what}'s kernel path and plain path disagree, or the kernel path "
             "disagrees with itself")


def grad_rel_errors(errors: dict, own: dict, norm: float) -> tuple:
    """Phase 9's rule for gradient tensors: each tensor's max |error| over
    its own max |g|, or over the global norm where its max is below
    CANCEL_FRAC of the norm (a cancelling sum). Returns ({name: relative
    error}, the cancelling sums' names)."""
    scale = {n: own[n] if own[n] >= CANCEL_FRAC * norm else norm for n in own}
    return ({n: e / scale[n] for n, e in errors.items()},
            sorted(n for n in own if scale[n] == norm))


def time_train_step(torch, trainer, step_fn, batches, dev, what: str, reps: int,
                    plain_reps: int, profile: bool) -> None:
    """Print the median synced step time through the kernels and the plain
    versions, the CUDA-event split of the step and, with `profile`, the
    profiler's busy time and top kernels (not gated)."""
    from deepvcp_tpu_torch.ops.kernels import reference_path

    feed = itertools.cycle([tuple(torch.from_numpy(a).to(dev) for a in b) for b in batches])

    def timed_step():
        trainer.state, _ = step_fn(trainer.state, *next(feed))

    step_ms = host_median_ms(torch, timed_step, reps=reps)
    with reference_path():
        step_plain_ms = host_median_ms(torch, timed_step, reps=plain_reps)
    print(f"{what}, B=1, N={N_POINTS}: kernel path {step_ms:.3f} ms, plain path "
          f"{step_plain_ms:.3f} ms (median of synced steps)")
    splits = []
    for _ in range(6):
        trainer.state, split = train_step_split(torch, step_fn, trainer.state, trainer.model,
                                                next(feed))
        splits.append(split)
    split = {k: statistics.median(s[k] for s in splits[1:]) for k in splits[0]}
    print(f"{what} split (CUDA events, ms, median of 5 steps): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f" | sum {sum(split.values()):.3f}")
    if not profile:
        return
    busy, top = device_time_per_call(torch, timed_step, calls=3)
    if busy > 0:
        print(f"device busy per {what} (torch.profiler, union of kernel intervals): "
              f"{busy:.3f} ms of {step_ms:.3f} ms, idle share {1 - busy / step_ms:.3f}")
        print(f"top kernels of the {what} (ms per step): "
              + "; ".join(f"{k} {v:.3f}" for k, v in top))
    else:
        print(f"device busy per {what}: not measured (the profiler saw no device time)")


def bound_ms(bytes_moved: float, ops: float) -> tuple:
    """(least time in ms, what bounds it) for work that moves `bytes_moved`
    bytes and does `ops` float32 operations, at the card's published peaks."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def in_radius_pairs(torch, x, radius: float) -> int:
    """Ordered pairs (q, n), q == n included, within `radius` in the cloud
    x [B, N, 3], under the kernels' f32 test: the work K1 and K2 must do."""
    from deepvcp_tpu_torch.ops.kernels.band_max import radius_squared

    r2, count = radius_squared(radius), 0
    for s in range(0, x.shape[1], 1024):
        d = x[:, None, :, :] - x[:, s:s + 1024, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        count += int((d2 <= r2).sum())
    return count


def slab_stats(torch, x, radius: float, tile: int = SLAB_TILE) -> tuple:
    """(max, mean) over the tiles of `tile` sorted queries (K1) or receivers
    (K2) of the slab each scans in the x-sorted clouds x [B, N, 3]: the
    points whose x lies within radius of the tile's x range."""
    keys = x[..., 0].contiguous()
    N = keys.shape[1]
    first = torch.arange(0, N, tile, device=x.device)
    last = torch.clamp(first + tile - 1, max=N - 1)
    lo = torch.searchsorted(keys, keys[:, first] - radius)
    hi = torch.searchsorted(keys, keys[:, last] + radius, right=True)
    length = (hi - lo).float()
    return int(length.max()), float(length.mean())


def rows_touched(torch, x, radius: float, tile: int) -> tuple:
    """(points within radius of some point of their tile, slab points), each
    summed over the tiles of `tile` sorted points of the x-sorted clouds x
    [B, N, 3], under the kernels' f32 test: the share of a K2 tile's slab
    whose out and g rows it reads."""
    from deepvcp_tpu_torch.ops.kernels.band_max import radius_squared

    r2, touched = radius_squared(radius), 0
    B, N = x.shape[:2]
    span = 32 * tile
    for s in range(0, N, span):
        m = min(span, N - s)
        d = x[:, None, :, :] - x[:, s:s + m, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        hit = d2 <= r2                                          # [B, m, N]
        pad = (-m) % tile
        if pad:
            hit = torch.cat([hit, hit.new_zeros(B, pad, N)], dim=1)
        touched += int(hit.view(B, -1, tile, N).any(dim=2).sum())
    _, mean = slab_stats(torch, x, radius, tile)
    return touched, mean * B * ((N + tile - 1) // tile)


def band_phase(torch, dev, serving_only: bool = False) -> dict:
    """Phase 3: K1 and K2 against their plain versions at the serving
    shapes (one FE pass of kitti25-rot on a 25 m lidar-like cloud) and at
    the cascade's (phase 13's first batch of each held set, B = 2), K2
    also with forced ties and run twice, and both at C outside the SA
    stages' widths; times per call and behind a device hold; slabs and
    bounds. With `serving_only` (--multicard), the serving shapes alone.
    Returns the serving sums for the kernels line."""
    import numpy as np

    from deepvcp_tpu_torch.data import lidar_like_cloud
    from deepvcp_tpu_torch.ops.kernels.band_max import (
        banded_masked_max, banded_masked_max_grad, banded_masked_max_grad_reference,
        banded_masked_max_reference)

    def sort_x(c):
        return torch.stack([b[torch.sort(b[:, 0], stable=True).indices] for b in c])

    rng = np.random.default_rng(0)
    xyz = lidar_like_cloud(rng, N_POINTS, max_range=25.0).astype(np.float32)
    serving = torch.from_numpy(xyz[np.argsort(xyz[:, 0], kind="stable")][None]).to(dev)
    families = {"serving": serving}
    if not serving_only:
        batches = global_batches(torch, dev)
        families.update({"cascade lidar_like": sort_x(batches["lidar_like"][0][0][..., :3]),
                         "cascade uniform_cube": sort_x(batches["uniform_cube"][0][0][..., :3])})
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"k1_err": 0.0, "k2_err": 0.0}
    for fam, x in families.items():
        ms_sum = held_sum = plain_sum = 0.0
        work = [0, 0]
        for C, r in SA_SHAPES:
            u = torch.randn(*x.shape[:2], C, device=dev, generator=gen)
            got = banded_masked_max(x, u, r)
            want = banded_masked_max_reference(x, u, r)
            err = (got - want).abs().max().item()
            if not torch.isfinite(got).all() or err != 0.0:
                fail(f"K1 disagrees with its plain version at {fam} C={C}, r={r}: max abs {err}")
            ms = cuda_median_ms(torch, lambda: banded_masked_max(x, u, r), reps=50)
            held = cuda_median_ms(torch, lambda: banded_masked_max(x, u, r), reps=50, hold=True)
            plain = cuda_median_ms(torch, lambda: banded_masked_max_reference(x, u, r),
                                   reps=20 if fam == "serving" else 3)
            slab_max, slab_mean = slab_stats(torch, x, r)
            pairs_r = in_radius_pairs(torch, x, r)
            # bytes: each input read once, the output written once;
            # operations: per in-radius pair, the f32 distance test (9) and C max
            nbytes, ops = 4 * x.shape[0] * x.shape[1] * (3 + 2 * C), pairs_r * (9 + C)
            bound, by = bound_ms(nbytes, ops)
            print(f"K1 banded_masked_max {fam} [{x.shape[0]}, {x.shape[1]}] C={C} r={r}: "
                  f"max_abs_err {err} | kernel {ms:.4f} ms per call, {held:.4f} behind a hold, "
                  f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by}) | slab per {SLAB_TILE}-query "
                  f"tile max {slab_max} mean {slab_mean:.1f} (max / mean "
                  f"{slab_max / slab_mean:.2f})"
                  f", {pairs_r} in-radius pairs")
            res["k1_err"] = max(res["k1_err"], err)
            ms_sum, held_sum, plain_sum = ms_sum + ms, held_sum + held, plain_sum + plain
            work = [work[0] + nbytes, work[1] + ops]
        bound, by = bound_ms(*work)
        print(f"K1 {fam}, the 3 SA shapes: kernel {ms_sum:.4f} ms per call, {held_sum:.4f} behind "
              f"a hold, plain {plain_sum:.4f} ms, bound {bound:.5f} ms ({by})")
        if fam == "serving":
            res.update(k1_ms=ms_sum, k1_plain_ms=plain_sum, k1_bound=(bound, by))

    # K2 at the serving and the cascade's shapes, cotangents of the
    # forward's output: integer ones (every sum exact), forced ties (u of 3
    # levels), Gaussian ones, and Gaussian twice for determinism. Gaussian
    # sums are also taken in float64 (rounded once): the cascade's run over
    # hundreds of terms up to ~235 in size, where the plain version's own
    # f32 sums are ~2e-5 from them, so K2_GAUSS_LIMIT holds at the serving
    # shapes and the cascade's are held to the bound of any f32 order of
    # summation instead: gamma(m - 1) * sum |g_i| over an element's m terms,
    # plus the rounding of the exact sum
    for fam, x in families.items():
        ms_sum = held_sum = plain_sum = 0.0
        work = [0, 0]
        for C, r in SA_SHAPES:
            shape = (*x.shape[:2], C)
            u = torch.randn(shape, device=dev, generator=gen)
            u_tie = torch.randint(0, 3, shape, device=dev, generator=gen).float()
            out, out_tie = banded_masked_max(x, u, r), banded_masked_max(x, u_tie, r)
            g_int = torch.randint(-8, 9, shape, device=dev, generator=gen).float()
            g = torch.randn(shape, device=dev, generator=gen)
            err_int = max(
                (banded_masked_max_grad(x, uu, oo, g_int, r)
                 - banded_masked_max_grad_reference(x, uu, oo, g_int, r)).abs().max().item()
                for uu, oo in ((u, out), (u_tie, out_tie)))
            got = banded_masked_max_grad(x, u, out, g, r)
            again = banded_masked_max_grad(x, u, out, g, r)
            plain = banded_masked_max_grad_reference(x, u, out, g, r)
            exact = banded_masked_max_grad_reference(x, u, out, g.double(), r)
            err, err_exact = ((got - plain).abs().max().item(),
                              (got - exact).abs().max().item())
            if fam == "serving":
                ok_gauss, held_to = err <= K2_GAUSS_LIMIT, f"<= {K2_GAUSS_LIMIT}"
            else:
                terms = banded_masked_max_grad_reference(x, u, out, torch.ones_like(g), r)
                mag = banded_masked_max_grad_reference(x, u, out, g.abs().double(), r)
                um = (terms - 1).clamp(min=0) * 2.0**-24
                limit = um / (1 - um) * mag + 2.0**-23 * exact.abs()
                ratio = ((got - exact).abs() / limit.clamp(min=1e-30)).max().item()
                ok_gauss = ratio <= 1.0
                held_to = (f"{ratio:.3f} of its summation bound (up to {int(terms.max())} terms, "
                           f"bound max {limit.max().item():.3e})")
            print(f"K2 {fam} C={C} r={r}: Gaussian g, kernel vs plain {err:.3e}, vs exact sums "
                  f"{err_exact:.3e}, plain vs exact sums "
                  f"{(plain - exact).abs().max().item():.3e}; held to {held_to}")
            if not torch.isfinite(got).all() or err_int != 0.0 or not ok_gauss:
                fail(f"K2 disagrees with its plain version at {fam} C={C}, r={r}: max abs "
                     f"{err_int} (integer cotangents, forced ties too, must be 0), Gaussian "
                     f"{err} (held to {held_to})")
            if not torch.equal(got, again):
                fail(f"K2 is not deterministic at {fam} C={C}, r={r}: two calls differ by "
                     f"{(got - again).abs().max().item()}")
            ms = cuda_median_ms(torch, lambda: banded_masked_max_grad(x, u, out, g, r), reps=50)
            held = cuda_median_ms(torch, lambda: banded_masked_max_grad(x, u, out, g, r),
                                  reps=50, hold=True)
            plain_ms = cuda_median_ms(
                torch, lambda: banded_masked_max_grad_reference(x, u, out, g, r),
                reps=20 if fam == "serving" else 3)
            pairs_r = in_radius_pairs(torch, x, r)
            # bytes: each input read once, the output written once;
            # operations: per in-radius pair, the test (9), C compares, C adds
            nbytes, ops = 4 * x.shape[0] * x.shape[1] * (3 + 4 * C), pairs_r * (9 + 2 * C)
            bound, by = bound_ms(nbytes, ops)
            tiles = ", ".join(
                f"per {t}-receiver tile max {m} mean {a:.1f}, rows read {rows / n_slab:.3f}"
                for t in (32, 64)
                for (m, a), (rows, n_slab) in [(slab_stats(torch, x, r, t),
                                                rows_touched(torch, x, r, t))])
            print(f"K2 banded_masked_max_grad {fam} [{x.shape[0]}, {x.shape[1]}] C={C} r={r}: "
                  f"max_abs_err {err_int} (integer g, forced ties too), {err:.3e} (Gaussian g), "
                  f"two calls bitwise equal | kernel {ms:.4f} ms per call, {held:.4f} behind a "
                  f"hold, plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by}) | slab {tiles} "
                  f"(share of the slab's points within radius of a tile's receiver), {pairs_r} "
                  f"in-radius pairs")
            if fam == "serving":
                res["k2_err"] = max(res["k2_err"], err)
            ms_sum, held_sum, plain_sum = ms_sum + ms, held_sum + held, plain_sum + plain_ms
            work = [work[0] + nbytes, work[1] + ops]
        bound, by = bound_ms(*work)
        print(f"K2 {fam}, the 3 SA shapes: kernel {ms_sum:.4f} ms per call, {held_sum:.4f} behind "
              f"a hold, plain {plain_sum:.4f} ms, bound {bound:.5f} ms ({by})")
        if fam == "serving":
            res.update(k2_ms=ms_sum, k2_plain_ms=plain_sum, k2_bound=(bound, by))

    if serving_only:
        return res
    # K1 and K2 at widths outside the SA stages' (any C): a 3 000-point
    # slice of the cube cloud at r = 0.2
    x = families["cascade uniform_cube"][:1, :3000].contiguous()
    for C in EXTRA_CHANNELS:
        u = torch.randn(1, x.shape[1], C, device=dev, generator=gen)
        k1, k2 = banded_masked_max.launches, banded_masked_max_grad.launches
        out = banded_masked_max(x, u, 0.2)
        err1 = (out - banded_masked_max_reference(x, u, 0.2)).abs().max().item()
        g_int = torch.randint(-8, 9, u.shape, device=dev, generator=gen).float()
        g = torch.randn(u.shape, device=dev, generator=gen)
        err_int = (banded_masked_max_grad(x, u, out, g_int, 0.2)
                   - banded_masked_max_grad_reference(x, u, out, g_int, 0.2)).abs().max().item()
        err = (banded_masked_max_grad(x, u, out, g, 0.2)
               - banded_masked_max_grad_reference(x, u, out, g, 0.2)).abs().max().item()
        launched = (banded_masked_max.launches - k1, banded_masked_max_grad.launches - k2)
        print(f"C={C}: K1 max_abs_err {err1}, K2 {err_int} (integer g), {err:.3e} (Gaussian g); "
              f"launches K1 {launched[0]}, K2 {launched[1]}")
        if err1 != 0.0 or err_int != 0.0 or err > K2_GAUSS_LIMIT or launched != (1, 2):
            fail(f"K1/K2 at C={C}: errors {err1}, {err_int}, {err} or launches {launched}")
        res["k1_err"], res["k2_err"] = max(res["k1_err"], err1), max(res["k2_err"], err)
    return res


def fps_cases() -> list:
    """K3's test clouds, (name, xyz [B, N, 3] numpy, npoint): B 1 m
    lidar-like clouds per FPS_SHAPES and FPS_LARGE entry, then a lattice
    with every point twice (exact distance ties)."""
    import numpy as np

    from deepvcp_tpu_torch.data import lidar_like_cloud

    rng = np.random.default_rng(1)
    g = np.arange(17, dtype=np.float32) * 0.125
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    lattice = np.concatenate([lattice, lattice])[rng.permutation(2 * len(lattice))]
    cases = [(f"[{B}, {N}, 3] npoint {k}",
              np.stack([lidar_like_cloud(rng, N, max_range=1.0) for _ in range(B)]), k)
             for B, N, k in FPS_SHAPES + FPS_LARGE]
    cases.append((f"tie cloud [1, {len(lattice)}, 3] (a 17^3 lattice, every point twice) "
                  f"npoint 4096", lattice[None], 4096))
    return cases


def k3_phase(torch, dev) -> dict:
    """Phase 12: K3 against its plain version at the global path's shapes,
    on a tie cloud and past the old 16 384-point limit; median CUDA-event
    times; the pick protocol alone at each cluster size. Returns the
    numbers of the two shapes one so3_global_init call runs ([2, N, 3] at
    4096 and 128)."""
    import numpy as np

    from deepvcp_tpu_torch.ops.kernels import fps
    from deepvcp_tpu_torch.ops.kernels.fps import (
        farthest_point_sample, farthest_point_sample_reference)

    init = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "max_abs_err": 0}
    for name, xyz, k in fps_cases():
        x = torch.from_numpy(np.ascontiguousarray(xyz, dtype=np.float32)).to(dev)
        B, N, _ = x.shape
        before = farthest_point_sample.launches
        got = farthest_point_sample(x, k)
        launched = farthest_point_sample.launches - before
        want = farthest_point_sample_reference(x, k)
        err = int((got - want).abs().max())
        if err != 0 or launched != 1:
            bad = int((got != want).nonzero()[0, 1]) if err else -1
            fail(f"K3 at {name}: {launched} launches (want 1), disagrees with its plain version "
                 f"first at pick {bad}")
        ms = cuda_median_ms(torch, lambda: farthest_point_sample(x, k), reps=10, warmup=1)
        plain = cuda_median_ms(torch, lambda: farthest_point_sample_reference(x, k), reps=3,
                               warmup=1)
        # bytes: the cloud read once, the indices written once; operations:
        # each pick, 3 sub, 3 mul, 2 add, a min and a max-compare per point
        nbytes, ops = B * N * 12 + B * k * 8, B * k * N * 10
        bound, by = bound_ms(nbytes, ops)
        cs = fps.cluster_size(N)
        print(f"K3 farthest_point_sample {name}: indices identical, {launched} launch, cluster of "
              f"{cs} blocks{' (streamed)' if fps.streams(N, cs) else ''}"
              f" | kernel {ms:.4f} ms, plain {plain:.4f} ms (median, CUDA events), bound "
              f"{bound:.4f} ms ({by})")
        if B == GLOBAL_B and N == N_POINTS:
            init["ms"] += ms
            init["plain_ms"] += plain
            init["bytes"] += nbytes
            init["ops"] += ops
            init["max_abs_err"] = max(init["max_abs_err"], err)
    init["bound_ms"], init["bound_by"] = bound_ms(init["bytes"], init["ops"])

    # the pick protocol alone (two warp reductions, the records to every
    # block of the cluster, the wait for this block's, the slot reduction):
    # a floor per pick that no cluster of this design beats; beside it the
    # same records through a cluster barrier and DSMEM round trip a pick
    iters = 4096
    per_pick = {False: {}, True: {}}
    for barrier in (False, True):
        for cs in (1, 2, 4, 8, 16):
            smid = torch.empty(GLOBAL_B * cs, dtype=torch.int32, device=dev)
            ms = cuda_median_ms(torch, lambda: fps.pick_probe(smid, GLOBAL_B, cs, iters, barrier),
                                reps=5)
            per_pick[barrier][cs] = ms / iters * 1e3
    cs = fps.cluster_size(N_POINTS)
    picks = sum(k for B, N, k in FPS_SHAPES if N == N_POINTS) - 2   # the first pick is free
    for barrier, what in ((False, "K3's pick protocol alone (st.async + mbarrier)"),
                          (True, "a cluster barrier + DSMEM round trip a pick")):
        print(f"{what}, us per pick (median, CUDA events): " + ", ".join(
            f"{c} blocks {us:.4f}" for c, us in per_pick[barrier].items()))
    print(f"K3 serial floor of one init at {cs} blocks ({picks} dependent picks x the protocol "
          f"alone): {picks * per_pick[False][cs] / 1e3:.4f} ms, beside its operations bound "
          f"{init['bound_ms']:.4f} ms")
    return init


def init_split(torch, src, tgt) -> dict:
    """Device time of the phases of one so3_global_init call at its
    defaults, replaying it through the initializer's public pieces between
    CUDA events: FPS and centring; the coarse ICP sweep; the fine rescore
    of every hypothesis; top-p, fine ICP and the final pick."""
    import inspect

    from deepvcp_tpu_torch import initializer as gi

    kw = {k: v.default for k, v in inspect.signature(gi.so3_global_init).parameters.items()
          if v.default is not inspect.Parameter.empty}
    ev = []

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append(e)

    B = src.shape[0]
    with torch.no_grad():
        mark()
        lv = gi.centred_levels(src, tgt, kw["n_src"], kw["n_tgt"], kw["n_coarse"],
                               kw["inlier_ratio"])
        mark()
        chunks = gi.hypothesis_chunks(kw["n_rotations"], kw["sweep_chunk"], device=src.device)
        cg = chunks.shape[1]
        Rc, tc, sc = [], [], []
        for g in chunks:
            mark()
            R, t = gi.icp(lv, g.expand(B, cg, 3, 3), torch.zeros(B, cg, 3, device=src.device),
                          lv.coarse, kw["icp_coarse_iters"])
            mark()
            sc.append(gi.score(lv, R, t, lv.fine))
            Rc.append(R)
            tc.append(t)
        mark()
        Rc, tc, sc = torch.cat(Rc, 1), torch.cat(tc, 1), torch.cat(sc, 1)
        best = torch.topk(sc[:, :kw["n_rotations"]], kw["top_p"], dim=-1, largest=False).indices
        rows = torch.arange(B, device=src.device)[:, None]
        Rf, tf = gi.icp(lv, Rc[rows, best], tc[rows, best], lv.fine, kw["icp_iters"])
        torch.argmin(gi.score(lv, Rf, tf, lv.fine), dim=-1)
        mark()
    torch.cuda.synchronize()
    n = len(chunks)
    return {"fps_centre": ev[0].elapsed_time(ev[1]),
            "coarse_icp_sweep": sum(ev[2 + 2 * i].elapsed_time(ev[3 + 2 * i]) for i in range(n)),
            "fine_rescore": sum(ev[3 + 2 * i].elapsed_time(ev[4 + 2 * i]) for i in range(n)),
            "fine_icp_pick": ev[-2].elapsed_time(ev[-1])}


def global_batches(torch, dev) -> dict:
    """campaign_r5f W6's two held sets, 8 batches of B = 2 pairs each on the
    card: {name: [(src, tgt, R, t), ...]}."""
    from deepvcp_tpu_torch.data import LidarLikeDataset, SyntheticDataset, batch_iterator

    held = {
        "lidar_like": LidarLikeDataset(num_clouds=GLOBAL_B * GLOBAL_BATCHES,
                                       num_points=N_POINTS, max_range=1.0, seed=103,
                                       noise_std=0.01),
        "uniform_cube": SyntheticDataset(num_clouds=GLOBAL_B * GLOBAL_BATCHES,
                                         num_points=N_POINTS, extent=1.0, seed=102,
                                         noise_std=0.01),
    }
    return {name: [tuple(torch.from_numpy(a).to(dev) for a in b) for b in
                   batch_iterator(ds, GLOBAL_B, epoch=0, seed=777, shuffle=False)]
            for name, ds in held.items()}


def global_phase(torch, dev) -> dict:
    """Phases 13-15: so3_global_init + modelnet-cascade on the two held sets
    of campaign_r5f W6, the kernel path against the plain path, and timing.
    Returns the K1, K3 and K6 launch counts of the gated run."""
    import numpy as np

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.data import rotation_geodesic_deg, translation_error
    from deepvcp_tpu_torch.initializer import so3_global_init
    from deepvcp_tpu_torch.ops import farthest_point_sample
    from deepvcp_tpu_torch.ops.kernels import band_max, fps, reference_path
    from deepvcp_tpu_torch.ops.kernels.knn_select import knn_select, knn_select_bf16

    casc = pretrained.cascade("modelnet-cascade", device="cuda")   # the current card, dev
    batches = global_batches(torch, dev)

    # 13. the main path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fps.farthest_point_sample.launches = 0
    band_max.banded_masked_max.launches = 0
    knn_select.launches = knn_select_bf16.launches = 0
    runs = {name: [] for name in batches}
    for name, bs in batches.items():
        for src, tgt, _, _ in bs:
            init = so3_global_init(src, tgt)
            runs[name].append((init, casc(src, tgt, init.R, init.t)))
    torch.cuda.synchronize()
    k3, k1 = fps.farthest_point_sample.launches, band_max.banded_masked_max.launches
    k6, k6b = knn_select.launches, knn_select_bf16.launches
    peak = torch.cuda.max_memory_allocated() / 2**20
    n_calls = sum(len(v) for v in runs.values())
    last = casc.stages[-1]
    last_cols = last.refine_iters + 1
    summary = {}
    for name, bs in batches.items():
        rre0, rre_init, rre_ref, rte_ref = [], [], [], []
        for i, ((src, tgt, R_gt, t_gt), (init, out)) in enumerate(zip(bs, runs[name])):
            for field, val, shape in (("init R", init.R, (GLOBAL_B, 3, 3)),
                                      ("init t", init.t, (GLOBAL_B, 3)),
                                      ("R", out.R, (GLOBAL_B, 3, 3)), ("t", out.t, (GLOBAL_B, 3)),
                                      ("scores", out.scores, (GLOBAL_B, 3 + last_cols))):
                if tuple(val.shape) != shape or not torch.isfinite(val).all():
                    fail(f"{name} batch {i}: {field} has shape {tuple(val.shape)} "
                         f"(want {shape}) or non-finite values")
            # the guard: the returned pose scores the last block's minimum,
            # which is at most the block's column 0 (the incoming pose)
            final = last.score(out.keypoints, tgt[..., :3], out.R, out.t)
            block = out.scores[:, -last_cols:]
            if ((final - block.min(dim=-1).values).abs() > 1e-6).any() or \
                    (block.min(dim=-1).values > block[:, 0]).any():
                fail(f"{name} batch {i}: the returned pose scores {final.tolist()}, its block "
                     f"{block.tolist()}: the guard did not hold")
            eye = torch.eye(3, device=dev).expand(GLOBAL_B, 3, 3)
            for b in range(GLOBAL_B):
                rre0.append(rotation_geodesic_deg(eye[b:b + 1], R_gt[b:b + 1]).item())
                rre_init.append(rotation_geodesic_deg(init.R[b:b + 1], R_gt[b:b + 1]).item())
                rre_ref.append(rotation_geodesic_deg(out.R[b:b + 1], R_gt[b:b + 1]).item())
                rte_ref.append(translation_error(out.t[b:b + 1], t_gt[b:b + 1]).item())
                print(f"{name} pair {2 * i + b:2d}: RRE identity {rre0[-1]:8.3f} deg | init "
                      f"{rre_init[-1]:8.3f} deg | refined {rre_ref[-1]:8.4f} deg, RTE "
                      f"{rte_ref[-1]:.5f} | score col 0 {out.scores[b, 0].item():.5f}, final "
                      f"{final[b].item():.5f}")
        in_basin = sum(r < INIT_BASIN_DEG for r in rre_init)
        med = statistics.median(rre_ref)
        summary[name] = (in_basin, med)
        print(f"{name}: inits under {INIT_BASIN_DEG:g} deg {in_basin}/{len(rre_init)}, init "
              f"median {statistics.median(rre_init):.3f} deg; refined median {med:.4f} deg, "
              f"under 2 deg {sum(r < 2 for r in rre_ref)}/{len(rre_ref)}, median RTE "
              f"{statistics.median(rte_ref):.5f}; identity median "
              f"{statistics.median(rre0):.2f} deg")
    lid_basin, lid_med = summary["lidar_like"]
    if lid_basin != GLOBAL_B * GLOBAL_BATCHES or lid_med >= REFINED_MEDIAN_DEG:
        fail(f"lidar_like: {lid_basin} inits in the basin (want all), refined median "
             f"{lid_med} deg (want < {REFINED_MEDIAN_DEG})")
    if summary["uniform_cube"][0] < CUBE_IN_BASIN:
        fail(f"uniform_cube: {summary['uniform_cube'][0]} inits in the basin "
             f"(want >= {CUBE_IN_BASIN})")
    print(f"launches in the global run: K3 {k3} over {n_calls} init calls ({k3 / n_calls:g} "
          f"per call), K1 {k1} over {n_calls} cascade calls ({k1 / n_calls:g} per call); "
          f"peak device memory {peak:.1f} MiB")
    if k3 != K3_PER_INIT * n_calls or k1 != K1_PER_CASCADE * n_calls:
        fail(f"expected {K3_PER_INIT} K3 launches per init and {K1_PER_CASCADE} K1 "
             f"launches per cascade call")

    # 14. kernel path vs plain path on the first batch of each set
    n_src, n_tgt = 128, 4096   # so3_global_init's defaults
    for name, bs in batches.items():
        src, tgt = bs[0][0], bs[0][1]

        def path():
            idx = (farthest_point_sample(src, n_src), farthest_point_sample(tgt, n_tgt))
            init = so3_global_init(src, tgt)
            return idx, init, casc(src, tgt, init.R, init.t)

        idx_k, init_k, out_k = path()
        with reference_path():
            idx_p, init_p, out_p = path()
        if not all(torch.equal(a, b) for a, b in zip(idx_k, idx_p)):
            fail(f"{name}: the kernel and plain paths' FPS indices differ")
        dRi = (init_k.R - init_p.R).abs().max().item()
        dti = (init_k.t - init_p.t).abs().max().item()
        dR = (out_k.R - out_p.R).abs().max().item()
        dt = (out_k.t - out_p.t).abs().max().item()
        print(f"{name} batch 0, kernel vs plain path: FPS indices identical, init max|dR| "
              f"{dRi:.3e} max|dt| {dti:.3e}, cascade max|dR| {dR:.3e} max|dt| {dt:.3e}")
        if max(dRi, dti) > INIT_PATH_ATOL or max(dR, dt) > CASCADE_PATH_ATOL:
            fail(f"{name}: the global path's kernel and plain paths disagree")

    # 15. timing (not gated)
    src, tgt = batches["lidar_like"][0][:2]
    init = so3_global_init(src, tgt)
    init_ms = host_median_ms(torch, lambda: so3_global_init(src, tgt), reps=5)
    casc_ms = host_median_ms(torch, lambda: casc(src, tgt, init.R, init.t), reps=10)
    print(f"global path, B={GLOBAL_B}, N={N_POINTS}: so3_global_init {init_ms:.3f} ms, "
          f"modelnet-cascade {casc_ms:.3f} ms (median of synced calls)")
    splits = [init_split(torch, src, tgt) for _ in range(4)][1:]
    split = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    print("so3_global_init split (CUDA events, ms, median of 3): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f" | sum {sum(split.values()):.3f}")
    for what, fn, calls, wall in (
            ("so3_global_init", lambda: so3_global_init(src, tgt), 2, init_ms),
            ("modelnet-cascade", lambda: casc(src, tgt, init.R, init.t), 5, casc_ms)):
        syncs = host_syncs(torch, fn)
        print(f"host syncs in one {what} call: {sum(n for _, n in syncs)} ("
              + "; ".join(f"{where} x{n}" for where, n in syncs) + ")")
        busy, top = device_time_per_call(torch, fn, calls=calls)
        if busy > 0:
            print(f"device busy per {what} call (torch.profiler, union of kernel intervals): "
                  f"{busy:.3f} ms of {wall:.3f} ms, idle share {1 - busy / wall:.3f}")
            print(f"top kernels of {what} (ms per call): "
                  + "; ".join(f"{k} {v:.3f}" for k, v in top))
        else:
            print(f"device busy per {what} call: not measured (the profiler saw no device time)")
    return {"k1": k1, "k3": k3, "k6": k6, "k6b": k6b}


def pose_errors(torch, outs, pairs, refine_iters: int, what: str) -> tuple:
    """Check the Registrar outputs `outs` of `pairs` (B = 1): every field's
    shape, finite values, R a rotation. Returns the GT-free RRE (deg) and
    RTE (m) lists."""
    from deepvcp_tpu_torch.data import rotation_geodesic_deg, translation_error

    rre, rte = [], []
    eye = torch.eye(3, device=pairs[0][0].device)
    for i, (out, (_, _, R_gt, t_gt)) in enumerate(zip(outs, pairs)):
        shapes = {"R": (1, 3, 3), "t": (1, 3), "keypoints": (1, 64, 3), "vcps": (1, 64, 3),
                  "saliency": (1, N_POINTS), "scores": (1, refine_iters + 1)}
        for field, shape in shapes.items():
            val = getattr(out, field)
            if tuple(val.shape) != shape or not torch.isfinite(val).all():
                fail(f"{what} pair {i}: {field} has shape {tuple(val.shape)} (want {shape}) "
                     f"or non-finite values")
        if (out.R[0] @ out.R[0].T - eye).abs().max() > 1e-4 or abs(torch.det(out.R[0]) - 1) > 1e-4:
            fail(f"{what} pair {i}: R is not a rotation")
        rre.append(rotation_geodesic_deg(out.R, R_gt).item())
        rte.append(translation_error(out.t, t_gt).item())
    return rre, rte


def registrar_paths_agree(torch, reg, src, tgt, what: str) -> None:
    """The Registrar through the kernels against the same call through the
    plain versions: the same keypoints, |dR|, |dt| <= 1e-4, scores <= 1e-5."""
    from deepvcp_tpu_torch.ops.kernels import reference_path

    with torch.no_grad():
        enc_k = reg.model.encode(src, tgt)
        out_k = reg(src, tgt)
        with reference_path():
            enc_p = reg.model.encode(src, tgt)
            out_p = reg(src, tgt)
    if not torch.equal(enc_k.keypoint_idx, enc_p.keypoint_idx):
        fail(f"{what}: kernel and plain paths chose different keypoints")
    if not torch.equal(out_k.keypoints, out_p.keypoints):
        fail(f"{what}: kernel and plain paths returned different keypoints")
    dR = (out_k.R - out_p.R).abs().max().item()
    dt = (out_k.t - out_p.t).abs().max().item()
    ds = (out_k.scores - out_p.scores).abs().max().item()
    print(f"{what} kernel vs plain path, pair 0: keypoint indices identical, max|dR| {dR:.3e}, "
          f"max|dt| {dt:.3e} m, max|dscores| {ds:.3e}")
    if dR > 1e-4 or dt > 1e-4 or ds > 1e-5:
        fail(f"{what}: kernel path and plain path disagree")


def registrar_timing(torch, reg, src, tgt, what: str, reps: int, plain_reps: int) -> float:
    """Print a Registrar's median synced latency through the kernels and the
    plain versions, its CUDA-event stage split, and the profiler's busy
    time, idle share and top kernels (not gated). Returns the latency."""
    from deepvcp_tpu_torch.ops.kernels import reference_path

    lat = host_median_ms(torch, lambda: reg(src, tgt), reps=reps)
    with reference_path():
        lat_plain = host_median_ms(torch, lambda: reg(src, tgt), reps=plain_reps)
    print(f"{what} Registrar per-call latency, B=1, N={N_POINTS}: kernel path {lat:.3f} ms, "
          f"plain path {lat_plain:.3f} ms (median of synced calls)")
    splits = [stage_split(torch, reg, src, tgt) for _ in range(6)][1:]
    split = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    print(f"{what} stage split (device ms, median of 5 replays): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f" | sum {sum(split.values()):.3f}")
    busy, top = device_time_per_call(torch, lambda: reg(src, tgt), calls=5)
    if busy > 0:
        print(f"{what} device busy per call (torch.profiler, union of kernel intervals): "
              f"{busy:.3f} ms of {lat:.3f} ms latency, idle share {1 - busy / lat:.3f}")
        print(f"{what} top kernels (ms per call): "
              + "; ".join(f"{k} {v:.3f}" for k, v in top))
    else:
        print(f"{what} device busy per call: not measured (the profiler saw no device time)")
    return lat


def flushed_median_ms(torch, fn, reps: int, flush, hold: bool = False) -> float:
    """Median CUDA-event time of fn() with L2 flushed before each launch by
    writing the buffer `flush` (larger than L2); the events enclose fn()
    alone. `hold` as in cuda_median_ms."""
    fn()
    if hold:
        hold_device(torch)
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def k6_inputs(torch, dev, reg, traffic_name: str = "stream-b8") -> tuple:
    """Phase 26's and 27's inputs: the benchmark's first 8 pairs of the
    traffic `traffic_name` (benchmark/generate.py, seed K6_SEED) on dev, and
    {name: (ref, query)} for the flat candidate KNN (the candidates of the
    identity warm start against the target cloud: 13 824 a pair for
    kitti25-rot, 21 952 for lidar-fine) and encode's source KNN
    (the 64 keypoints against the source cloud), at B = 8 and at B = 1
    (pair 0), encoded by `reg`."""
    from benchmark.generate import make_pool

    with open(os.path.join(ROOT, "benchmark", "traffic", f"{traffic_name}.json")) as fh:
        traffic = json.load(fh)
    pool = make_pool(K6_SEED, traffic, N_POINTS)
    B = int(traffic["batch"])
    src = torch.from_numpy(pool.src[:B]).to(dev)
    tgt = torch.from_numpy(pool.tgt[:B]).to(dev)
    with torch.no_grad():
        enc = reg.model.encode(src, tgt)
        _, cand = reg.model.candidates(enc, torch.eye(3, device=dev).expand(B, 3, 3),
                                       torch.zeros(B, 3, device=dev))
    cases = {"flat": (enc.tgt_xyz, cand.reshape(B, -1, 3)), "encode": (src, enc.keypoints)}
    return (src, tgt), {f"{name} B={b}": (ref[:b].contiguous(), query[:b].contiguous())
                        for b in (B, 1) for name, (ref, query) in cases.items()}


def k6_compare(torch, wrapper, plain, key, ref, query, k: int, chunk: int, what: str) -> dict:
    """One call of a K6 arm's `wrapper` on (ref, query) against its plain
    version `plain` (torch.topk of the arm's tile: knn_select_reference,
    knn_select_bf16_reference), `chunk` queries at a time: elements whose
    d2 differs by `key` (the order torch.topk ranks by: the f32 values,
    bf16_keys of the bf16 bits), rows whose index lists differ, in order,
    rows with a tie at the k-th key (the k-th and (k+1)-th keys equal) or
    inside the list (two of the first k + 1 keys equal), rows holding a
    negative d2, and the largest |d2 error|. Fails unless the call made one
    launch and every d2 and row is the plain version's."""
    before = wrapper.launches
    got_d2, got_idx = wrapper(ref, query, k)
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        fail(f"{what}: {wrapper.launches - before} launches, not 1")
    out = dict.fromkeys(("d2_bits", "rows_vs_plain", "kth_ties", "list_ties", "rows",
                         "negative", "max_abs_err"), 0)
    for s in range(0, query.shape[1], chunk):
        q = query[:, s:s + chunk].contiguous()
        d2, idx = got_d2[:, s:s + chunk], got_idx[:, s:s + chunk]
        want = plain(ref, q, k)
        out["d2_bits"] += int((key(want[0]) != key(d2)).sum())
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float((d2.float() - want[0].float()).abs().max()))
        out["rows_vs_plain"] += int((want[1] != idx).any(-1).sum())
        # the ties from k + 1 entries (torch.topk orders ties by its sort of
        # the set, another sort past 32 entries: the rows above at k)
        v = key(plain(ref, q, k + 1)[0])
        out["kth_ties"] += int((v[..., k - 1] == v[..., k]).sum())
        out["list_ties"] += int((v[..., 1:] == v[..., :-1]).any(-1).sum())
        out["negative"] += int((d2 < 0).any(-1).sum())
        out["rows"] += q.shape[0] * q.shape[1]
        del want, v
    if out["d2_bits"] or out["rows_vs_plain"]:
        fail(f"{what}: {out['d2_bits']} d2 unlike the plain version's, {out['rows_vs_plain']} "
             f"rows unlike its (torch.topk's of the tile), max |d2 error| "
             f"{out['max_abs_err']:.3e}")
    return out


def knn_select_phase(torch, dev, reg) -> dict:
    """Phase 26: kernel K6 (ops/kernels/knn_select.py) on the benchmark's
    pairs (k6_inputs: the flat stage at [8, 13 824] and [1, 13 824]
    queries, encode's source KNN at [8, 64] and [1, 64], x 10 000 points,
    k = 32) against its plain version (knn_select_reference: torch.topk of
    square_distance's tile, k6_compare): every d2 and every index row, in
    order, equal, or the phase fails; the exact ties counted; one launch a
    call. Median times of the kernel, of the plain version (under
    reference_path, chunked as approx_knn chunks it) and of the library
    yardstick (knn_select_reference, square_distance + torch.topk, over
    the same chunks: the port's f32 selection before K6), per call and
    behind a device hold, beside the kernel's bound (tile_ops' 10
    operations a pair; the inputs read and the [B, M, k] result written
    once) and, for the flat stage,
    benchmark/work.py::candidates_bound_ms (the whole stage, its gather
    included). Then kitti25-rot's registrar on the 8 pairs and on pair 0:
    one launch for encode's source KNN and one a refinement's flat stage.
    Returns {case: numbers}."""
    from benchmark.work import bound_ms, candidates_bound_ms, tile_ops
    from deepvcp_tpu_torch.ops.distance import map_query_chunks
    from deepvcp_tpu_torch.ops.kernels import knn_select as k6
    from deepvcp_tpu_torch.ops.kernels import reference_path
    from deepvcp_tpu_torch.ops.knn import approx_knn

    sel = reg.model.select_args(chunked=True)
    if sel["select_dtype"] is not None:
        fail("kitti25-rot's candidate KNN does not select in f32")
    k, chunk = reg.model.cfg.num_neighbors, sel["chunk"]
    with open(os.path.join(ROOT, "benchmark", "configs", "kitti25-rot.json")) as fh:
        model = json.load(fh)["model"]
    (src, tgt), cases = k6_inputs(torch, dev, reg)
    results = {}
    for name, (ref, query) in cases.items():
        B, M, _ = query.shape
        N = ref.shape[1]
        cmp = k6_compare(torch, k6.knn_select, k6.knn_select_reference, lambda v: v, ref, query,
                         k, chunk, f"K6 {name}")

        def kernel():
            return k6.knn_select(ref, query, k)

        def plain():
            with reference_path():
                return approx_knn(ref, query, k, chunk=chunk)

        def library():
            return map_query_chunks(lambda q: k6.knn_select_reference(ref, q, k), query, chunk)

        times = {"ms": cuda_median_ms(torch, kernel, reps=20),
                 "held_ms": cuda_median_ms(torch, kernel, reps=20, hold=True),
                 "plain_ms": cuda_median_ms(torch, plain, reps=5, warmup=1),
                 "library_ms": cuda_median_ms(torch, library, reps=5, warmup=1),
                 "library_held_ms": cuda_median_ms(torch, library, reps=5, warmup=1, hold=True)}
        bound = bound_ms(4 * (B * N * 4 + B * M * 4) + 12 * B * M * k, tile_ops(B * M, N))
        stage = candidates_bound_ms(model, B) if name.startswith("flat") else None
        print(f"K6 {name}: [{B}, {M}] x {N}, k = {k} | d2 unlike the tile's {cmp['d2_bits']} of {cmp['rows'] * k}; rows unlike "
              f"the plain version's (torch.topk's) {cmp['rows_vs_plain']}; exact ties at the k-th {cmp['kth_ties']}, in the list "
              f"{cmp['list_ties']}, of {cmp['rows']} rows | kernel {times['ms']:.4f} ms (held "
              f"{times['held_ms']:.4f}), plain {times['plain_ms']:.3f}, library "
              f"{times['library_ms']:.3f} (held {times['library_held_ms']:.3f}) | bound "
              f"{bound[0]:.5f} ms ({bound[1]}), {100 * bound[0] / times['held_ms']:.2f}% of it"
              + ("" if stage is None else f"; the stage's candidates_bound_ms {stage:.5f}"))
        results[name] = {**cmp, **times, "bound": bound, "stage_bound_ms": stage}

    for b in (src.shape[0], 1):
        before = k6.knn_select.launches
        with torch.no_grad():
            reg(src[:b], tgt[:b])
        torch.cuda.synchronize()
        n = k6.knn_select.launches - before
        print(f"K6 launches in a kitti25-rot call at B = {b}: {n} (encode's source KNN and "
              f"{reg.refine_iters} flat stages)")
        if n != 1 + reg.refine_iters:
            fail(f"K6: {n} launches in a B = {b} call, not {1 + reg.refine_iters}")
    return results


def bf16_keys(torch, d2):
    """torch.topk's radix key of each bf16 value (int32, 0..65535): the
    bits inverted where negative, the sign bit set where not (-0 below +0)."""
    bits = d2.view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(bits >= 0x8000, bits ^ 0xFFFF, bits | 0x8000)


def knn_select_bf16_phase(torch, dev) -> dict:
    """Phase 27: K6's bf16 arm (knn_select_bf16) on lidar-fine's bf16
    selection tile, on the benchmark's stream-b8-1m pairs (k6_inputs: the
    flat stage at [8, 21 952] and [1, 21 952] queries, encode's source KNN
    at [8, 64] and [1, 64], x 10 000 points, k = 32) and on a lattice cloud
    (8 clouds of 10 000 points and 4 608 queries on a LATTICE_STEP grid of
    the 1 m box: equal distances everywhere), against torch.topk of the bf16
    tile (knn_select_bf16_reference, chunked as approx_knn chunks it): every
    bf16 d2 bit and every index row, in order, equal, or the phase fails;
    the rows with a tie at the k-th key and inside the list counted (the
    ties exercised); one launch a call. The kernel and the plain tile arm
    (approx_knn under reference_path: the route before the kernel) timed
    in turns, per call and held, beside the kernel's bound (tile_ops'
    operations a pair; the inputs read and the [B, M, k] result written
    once). Then a
    lidar-fine registrar call on the 8 pairs: 1 + 3 launches of the bf16
    arm (encode's source KNN and one a refinement), none of the f32 arm.
    Returns {case: numbers}."""
    from benchmark.work import bound_ms, tile_ops
    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.ops.kernels import knn_select as k6
    from deepvcp_tpu_torch.ops.kernels import reference_path
    from deepvcp_tpu_torch.ops.knn import approx_knn

    reg = pretrained.registrar("lidar-fine", device=dev, num_points=N_POINTS)
    sel = reg.model.select_args(chunked=True)
    if sel["select_dtype"] != "bfloat16":
        fail("lidar-fine's candidate KNN does not select on the bf16 tile")
    k, chunk = reg.model.cfg.num_neighbors, sel["chunk"]
    (src, tgt), cases = k6_inputs(torch, dev, reg, K6_BF16_TRAFFIC)
    g = torch.Generator(dev).manual_seed(K6_SEED)
    cases["lattice B=8"] = tuple(
        torch.round((torch.rand(8, n, 3, device=dev, generator=g) - 0.5) / LATTICE_STEP)
        * LATTICE_STEP for n in (N_POINTS, 4608))
    results = {}
    for name, (ref, query) in cases.items():
        B, M, _ = query.shape
        N = ref.shape[1]
        cmp = k6_compare(torch, k6.knn_select_bf16, k6.knn_select_bf16_reference,
                         lambda v: bf16_keys(torch, v), ref, query, k, chunk, f"K6 bf16 {name}")

        def kernel():
            return k6.knn_select_bf16(ref, query, k)

        def plain():
            with reference_path():
                return approx_knn(ref, query, k, chunk=chunk, select_dtype="bfloat16")

        turns = turns_ms(torch, {"kernel": kernel, "plain": plain}, reps=5)
        held = turns_ms(torch, {"kernel": kernel, "plain": plain}, reps=5, hold=True)
        times = {"ms": statistics.median(turns["kernel"]),
                 "held_ms": statistics.median(held["kernel"]),
                 "plain_ms": statistics.median(turns["plain"]),
                 "plain_held_ms": statistics.median(held["plain"])}
        bound = bound_ms(4 * (B * N * 4 + B * M * 4) + 10 * B * M * k, tile_ops(B * M, N))
        print(f"K6 bf16 {name}: [{B}, {M}] x {N}, k = {k} | d2 bits unlike the bf16 tile's "
              f"{cmp['d2_bits']} of {cmp['rows'] * k}; rows unlike torch.topk's "
              f"{cmp['rows_vs_plain']}; rows with a tie at the k-th key {cmp['kth_ties']}, in "
              f"the list {cmp['list_ties']}, with a negative d2 {cmp['negative']}, of "
              f"{cmp['rows']} rows | in turns: kernel {times['ms']:.4f} ms (held "
              f"{times['held_ms']:.4f}), plain tile {times['plain_ms']:.3f} (held "
              f"{times['plain_held_ms']:.3f}) | bound {bound[0]:.5f} ms ({bound[1]}), "
              f"{100 * bound[0] / times['held_ms']:.2f}% of it")
        results[name] = {**cmp, **times, "bound": bound}

    with torch.no_grad():
        _, counts = counted_all(torch, lambda: reg(src, tgt))
    n, n32 = counts["k6b"], counts["k6"]
    print(f"K6 bf16 launches in a lidar-fine call at B = {src.shape[0]}: {n} (encode's source "
          f"KNN and {reg.refine_iters} flat stages); f32 K6 launches: {n32}")
    if n != 1 + reg.refine_iters or n32:
        fail(f"K6 bf16: {n} launches of the bf16 arm and {n32} of the f32 arm in a lidar-fine "
             f"call, not {1 + reg.refine_iters} and 0")
    results["registrar_launches"] = n
    return results


def onehot_phase(torch, dev, reg, pair) -> tuple:
    """Phase 16: K4 and K5 against their plain versions and the library
    calls (torch.gather, torch.scatter_add): at the path's table and
    indices (the two-level registrar's first refinement of `pair`, identity
    warm start), with every query into 8 rows, with every query into one
    row (the longest add chain), at D = 5 (K4's generic D), at a T that is
    not a multiple of 64, at a T = 3001 whose row sums K5 splits over two
    groups of rows, and at a Q that is not a multiple of K4's 256-query block
    or K5's 512-query tile. The path's per-64-row-group load. Median
    CUDA-event times at the path's case, per call and behind a device hold,
    warm and with L2 flushed. Returns K4's and K5's numbers there (per
    call)."""
    from deepvcp_tpu_torch.ops.kernels import onehot_gather as og
    from deepvcp_tpu_torch.ops.two_level import keypoint_tables, table_neighbors

    m = reg.model
    args = m.two_level_args()
    with torch.no_grad():
        enc = m.encode(pair[0], pair[1])
        kp_warm, cand = m.candidates(enc, torch.eye(3, device=dev)[None],
                                     torch.zeros(1, 3, device=dev))
        table = keypoint_tables(enc.tgt_xyz, enc.tgt_table, kp_warm, args["table_size"],
                                args["center_select_dtype"]).contiguous()
        l_idx = table_neighbors(table[..., :3], kp_warm, cand, m.cfg.num_neighbors,
                                args["select_dtype"])
    B, K, C, k = l_idx.shape
    idx = l_idx.reshape(B, K, C * k).contiguous()
    Q = C * k
    T, D = table.shape[2:]
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [(f"the path's [{B}, {K}, {T}, {D}] table, Q = {Q}", table, idx),
             ("the same, every query into 8 rows", table,
              torch.randint(0, 8, idx.shape, device=dev, generator=gen)),
             ("the same, every query into row 0", table, torch.zeros_like(idx)),
             (f"[{B}, {K}, {T}, 5], the path's indices",
              torch.randn(B, K, T, 5, device=dev, generator=gen), idx),
             (f"[1, 8, 600, {D}], Q = {Q}", torch.randn(1, 8, 600, D, device=dev, generator=gen),
              torch.randint(0, 600, (1, 8, Q), device=dev, generator=gen)),
             (f"[{B}, {K}, 3001, {D}], Q = {Q} (K5 in two groups of rows)",
              torch.randn(B, K, 3001, D, device=dev, generator=gen),
              torch.randint(0, 3001, idx.shape, device=dev, generator=gen)),
             ("[2, 3, 136, 7], Q = 1000", torch.randn(2, 3, 136, 7, device=dev, generator=gen),
              torch.randint(0, 136, (2, 3, 1000), device=dev, generator=gen))]
    k4_err = k5_err = 0.0
    for name, tb, ix in cases:
        Tc, Dc = tb.shape[2:]
        expand = ix[..., None].expand(-1, -1, -1, Dc)
        got = og.onehot_gather(tb, ix)
        want = og.onehot_gather_reference(tb, ix)
        if not (torch.equal(got, want) and torch.equal(got, torch.gather(tb, 2, expand))):
            fail(f"K4 differs from torch.gather at {name}")
        k4_err = max(k4_err, (got - want).abs().max().item())
        shape = (*ix.shape, Dc)
        g_int = torch.randint(-8, 9, shape, device=dev, generator=gen).float()
        g = torch.randn(shape, device=dev, generator=gen)
        err_int = (og.onehot_scatter_add(g_int, ix, Tc)
                   - og.onehot_scatter_add_reference(g_int, ix, Tc)).abs().max().item()
        got = og.onehot_scatter_add(g, ix, Tc)
        err = (got - og.onehot_scatter_add_reference(g, ix, Tc)).abs().max().item()
        err_lib = (got - torch.scatter_add(torch.zeros_like(tb), 2, expand, g)).abs().max().item()
        again = torch.equal(got, og.onehot_scatter_add(g, ix, Tc))
        fullest = int(torch.zeros(ix.shape[:2] + (Tc,), dtype=torch.int64, device=dev)
                      .scatter_add_(2, ix, torch.ones_like(ix)).max())
        print(f"K4/K5 at {name} (fullest row {fullest} queries): K4 identical to torch.gather; "
              f"K5 vs plain max_abs_err {err_int} (integer g), {err} (Gaussian g), vs "
              f"scatter_add {err_lib:.3e}, run twice identical: {again}")
        if err_int != 0.0 or err != 0.0 or not again:
            fail(f"K5 disagrees with its plain version or with itself at {name}")
        k5_err = max(k5_err, err)

    # the load of the first K5 design's blocks (64 rows each): the rows
    # nearest each keypoint come first in its table and are the fullest
    rows = torch.zeros(B * K, T, dtype=torch.int64, device=dev).scatter_add_(
        1, idx.reshape(B * K, Q), torch.ones_like(idx.reshape(B * K, Q)))
    groups = rows[:, :T // 64 * 64].reshape(B * K, -1, 64).sum(-1).float()
    print(f"the path's per-64-row-group query counts: max {groups.max().item():.0f}, mean "
          f"{groups.mean().item():.1f} (max / mean {(groups.max() / groups.mean()).item():.2f}); "
          f"group 0 holds {(groups[:, 0].sum() / groups.sum()).item():.4f} of the queries; "
          f"rows: max {rows.max().item()}, mean {rows.float().mean().item():.2f}")

    expand = idx[..., None].expand(-1, -1, -1, D)
    dout = torch.randn((*idx.shape, D), device=dev, generator=gen)
    zeros = torch.zeros_like(table)
    fns = {"K4": lambda: og.onehot_gather(table, idx),
           "torch.gather": lambda: torch.gather(table, 2, expand),
           "K5": lambda: og.onehot_scatter_add(dout, idx, T),
           "torch.scatter_add": lambda: torch.scatter_add(zeros, 2, expand, dout)}
    # each kernel and its library call in turns (a, b, b, a, ...): per call,
    # the host's time to issue a call included where it outlasts the
    # device's (the `ms` of the kernels line, as in every kernel's row), and
    # behind a device hold, the device's time alone
    warm, held = {}, {}
    for pair_ in (("K4", "torch.gather"), ("K5", "torch.scatter_add")):
        warm.update(turns_ms(torch, {n: fns[n] for n in pair_}, reps=50))
        held.update(turns_ms(torch, {n: fns[n] for n in pair_}, reps=50, hold=True))
    issue = {n: statistics.median(issue_ms(torch, fn, 50) for _ in range(4))
             for n, fn in fns.items()}
    flush = torch.empty(64 * 2**20 // 4, device=dev)
    cold = {(n, hold): flushed_median_ms(torch, fn, 50, flush, hold)
            for n, fn in fns.items() for hold in (False, True)}
    del flush
    k4 = {"max_abs_err": k4_err, "ms": statistics.median(warm["K4"]),
          "library_ms": statistics.median(warm["torch.gather"]),
          "plain_ms": cuda_median_ms(torch, lambda: og.onehot_gather_reference(table, idx),
                                     reps=50)}
    k5 = {"max_abs_err": k5_err, "ms": statistics.median(warm["K5"]),
          "library_ms": statistics.median(warm["torch.scatter_add"]),
          "plain_ms": cuda_median_ms(
              torch, lambda: og.onehot_scatter_add_reference(dout, idx, T), reps=5)}
    # bytes: each input read once (the table or dout, int64 indices), the
    # output written once; operations: K5's one add per dout element
    k4["bound_ms"], k4["bound_by"] = bound_ms(4 * table.numel() + 8 * idx.numel()
                                              + 4 * dout.numel(), 0)
    k5["bound_ms"], k5["bound_by"] = bound_ms(4 * dout.numel() + 8 * idx.numel()
                                              + 4 * table.numel(), dout.numel())

    def rounds(t: list) -> str:
        return f"{statistics.median(t):.4f} ms (rounds {min(t):.4f}-{max(t):.4f})"

    for name, r, lib in (("K4 onehot_gather", k4, "torch.gather"),
                         ("K5 onehot_scatter_add", k5, "torch.scatter_add")):
        kn = name[:2]
        print(f"{name} at the path's shapes, in 4 turns of 50 with {lib} (medians, CUDA "
              f"events): per call, host time included: kernel {rounds(warm[kn])}, library "
              f"{rounds(warm[lib])}, kernel / library {r['ms'] / r['library_ms']:.3f}; behind "
              f"a device hold: kernel {rounds(held[kn])}, library {rounds(held[lib])}, kernel / "
              f"library {statistics.median(held[kn]) / statistics.median(held[lib]):.3f}")
        print(f"{name}: plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of it reached per call, "
              f"{r['bound_ms'] / statistics.median(held[kn]):.3f} behind the hold; with L2 "
              f"flushed before each launch: kernel {cold[kn, False]:.4f} ms, library "
              f"{cold[lib, False]:.4f} ms per call, kernel {cold[kn, True]:.4f} ms, library "
              f"{cold[lib, True]:.4f} ms behind the hold")
    print("host time to issue one call (median of 4 means of 50 calls behind a device hold): "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in issue.items()))
    return k4, k5


def w2_recall(torch, dev) -> float:
    """Recall of two_level_rows (T=512, bf16 level 2) against exact flat
    k-NN at campaign_r5b W2's operating point: a uniform cloud of extent 20,
    N=10 000, 64 keypoints within +-8, 216 candidates within the grid reach
    of each, 32 neighbours. Every candidate is counted."""
    import numpy as np

    from deepvcp_tpu_torch.config import DeepVCPConfig
    from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator
    from deepvcp_tpu_torch.ops import knn
    from deepvcp_tpu_torch.ops.two_level import two_level_rows

    base = DeepVCPConfig(num_points=N_POINTS, use_normal=False)
    ds = SyntheticDataset(num_clouds=1, num_points=N_POINTS, use_normal=False, extent=10.0)
    tgt = torch.from_numpy(next(batch_iterator(ds, 1, epoch=0, seed=0))[1]).to(dev)
    K, C, k = base.num_keypoints, base.num_candidates, base.num_neighbors
    kp = np.random.default_rng(1).uniform(-8.0, 8.0, (1, K, 3)).astype(np.float32)
    cand = kp[:, :, None, :] + np.random.default_rng(2).uniform(
        -base.grid_reach, base.grid_reach, (1, K, C, 3)).astype(np.float32)
    kp, cand = torch.from_numpy(kp).to(dev), torch.from_numpy(cand).to(dev)
    ids = torch.arange(N_POINTS, device=dev, dtype=torch.float32)[None, :, None]
    with torch.no_grad():
        out = two_level_rows(tgt, torch.cat([tgt, ids], dim=-1), kp, cand, k,
                             table_size=base.tgt_knn_table, select_dtype="bfloat16")
        _, exact = knn(tgt, cand.reshape(1, K * C, 3), k, chunk=base.knn_query_chunk)
    got = out[..., -1].long().reshape(1, K * C, k)
    return (got[..., :, None] == exact[..., None, :]).any(-1).float().mean().item()


def two_level_phase(torch, dev, pairs) -> dict:
    """Phases 16-18: K4/K5 against their plain versions; the registrar of
    campaign_r5b W3 (kitti25, tgt_knn="two_level", T=512) on phase 4's 16
    pairs, with flat kitti25 and T=1024 beside it, and the recall at W2's
    operating point; kernel path against plain path; timing. Returns the
    K1, K4 and K6 launch counts of the gated run and K4's and K5's numbers."""
    import dataclasses

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.ops.kernels import band_max
    from deepvcp_tpu_torch.ops.kernels import onehot_gather as og
    from deepvcp_tpu_torch.ops.kernels.knn_select import knn_select, knn_select_bf16
    from deepvcp_tpu_torch.registration import Registrar

    flat = pretrained.registrar("kitti25", device=dev)
    variables = pretrained.load_variables("kitti25")

    def variant(**changes):
        return Registrar(dataclasses.replace(flat.cfg, **changes), variables, dev,
                         use_saliency_weights=flat.use_saliency_weights,
                         refine_iters=flat.refine_iters)

    reg = variant(**TWO_LEVEL)
    two = reg.model.two_level_args()
    print(f"two-level kitti25: T={two['table_size']}, level-1 selection "
          f"{two['center_select_dtype'] or 'float32'}, level-2 "
          f"{two['select_dtype'] or 'float32'}, refine_iters={reg.refine_iters}")

    # 16. K4 and K5
    k4, k5 = onehot_phase(torch, dev, reg, pairs[0])

    # 17. the main path: 16 pairs through the two-level registrar
    torch.cuda.synchronize()
    og.onehot_gather.launches = 0
    band_max.banded_masked_max.launches = 0
    knn_select.launches = knn_select_bf16.launches = 0
    outs = [reg(src, tgt) for src, tgt, _, _ in pairs]
    torch.cuda.synchronize()
    k4_runs, k1_runs = og.onehot_gather.launches, band_max.banded_masked_max.launches
    k6_runs, k6b_runs = knn_select.launches, knn_select_bf16.launches
    rre, rte = pose_errors(torch, outs, pairs, reg.refine_iters, "two-level kitti25")
    for i in range(len(pairs)):
        print(f"two-level pair {i:2d}: RRE {rre[i]:.4f} deg, RTE {rte[i]:.5f} m")
    mean_rre, mean_rte = statistics.mean(rre), statistics.mean(rte)
    print(f"two-level kitti25 (T={reg.cfg.tgt_knn_table}) GT-free over {len(pairs)} pairs: "
          f"mean RRE {mean_rre:.4f} deg, mean RTE {mean_rte:.5f} m")
    for name, other in (("flat kitti25", flat),
                        ("two-level kitti25 at T=1024", variant(tgt_knn="two_level",
                                                                tgt_knn_table=1024))):
        o_rre, o_rte = pose_errors(torch, [other(s, t) for s, t, _, _ in pairs], pairs,
                                   other.refine_iters, name)
        print(f"{name} GT-free over the same pairs (not gated): mean RRE "
              f"{statistics.mean(o_rre):.4f} deg, mean RTE {statistics.mean(o_rte):.5f} m")
    if not (mean_rre <= RRE_LIMIT_DEG and mean_rte <= RTE_LIMIT_M):
        fail(f"two-level accuracy: mean RRE {mean_rre} > {RRE_LIMIT_DEG} or RTE {mean_rte} > "
             f"{RTE_LIMIT_M}")
    print(f"launches in the two-level run: K4 {k4_runs}, K1 {k1_runs}, K6 {k6_runs} over {len(pairs)} "
          f"Registrar calls ({k4_runs / len(pairs):g} and {k1_runs / len(pairs):g} per call)")
    if k4_runs != K4_PER_CALL * len(pairs) or k1_runs != LAUNCHES_PER_CALL * len(pairs):
        fail(f"expected {K4_PER_CALL} K4 and {LAUNCHES_PER_CALL} K1 launches per call")
    recall = w2_recall(torch, dev)
    print(f"two-level recall against exact flat k-NN at W2's operating point: {recall:.4f}")
    if recall < RECALL_LIMIT:
        fail(f"two-level recall {recall} < {RECALL_LIMIT}")

    # 18. kernel path vs plain path
    src, tgt = pairs[0][0], pairs[0][1]
    registrar_paths_agree(torch, reg, src, tgt, "two-level kitti25")

    # timing (not gated): flat kitti25 in turns with the two-level registrar
    flat_ms = host_median_ms(torch, lambda: flat(src, tgt), reps=10)
    registrar_timing(torch, reg, src, tgt, "two-level kitti25", reps=10, plain_reps=5)
    flat_ms2 = host_median_ms(torch, lambda: flat(src, tgt), reps=10)
    print(f"flat kitti25 Registrar per-call latency beside it: {flat_ms:.3f} ms before, "
          f"{flat_ms2:.3f} ms after (median of synced calls)")
    splits = [stage_split(torch, flat, src, tgt) for _ in range(4)][1:]
    print("flat kitti25 stage split (device ms, median of 3 replays): " + ", ".join(
        f"{k} {statistics.median(s[k] for s in splits):.3f}" for k in splits[0]))
    return {"k1": k1_runs, "k4": k4_runs, "k6": k6_runs, "k6b": k6b_runs, "K4": k4, "K5": k5}


def two_level_training(torch, dev) -> dict:
    """Phase 19: fine-tune kitti25 with tgt_knn="two_level" (T=512) for
    TWO_LEVEL_STEPS steps through the Trainer under kitti25_recipe(): finite
    loss and grad norm, 1 K4 and 1 K5 launch per step (and 6 K1, 6 K2);
    one step through the kernels against the plain versions (phase 9's
    check); the step time and its split. Returns the launch counts."""
    import numpy as np

    from deepvcp_tpu_torch.train import build_train_step
    from deepvcp_tpu_torch.train.optim import learning_rate_schedule

    trainer, tcfg, records, batches, saved = fine_tuning("kitti25", TWO_LEVEL, TWO_LEVEL_STEPS,
                                                         dev)
    t0 = time.perf_counter()
    _, counts = counted_all(torch, lambda: trainer.train_epoch(iter(batches), epoch=0))
    wall = time.perf_counter() - t0
    steps = [r for r in records if r["kind"] == "train"]
    for i, r in enumerate(steps):
        print(f"two-level train step {i}: loss {r['loss']:.5f}, vcp_l1 {r['vcp_l1']:.5f}, "
              f"rre {r['rre_deg']:.4f} deg, rte {r['rte']:.5f} m, grad_norm {r['grad_norm']:.4f}")
    if len(steps) != TWO_LEVEL_STEPS:
        fail(f"expected {TWO_LEVEL_STEPS} logged two-level train steps, got {len(steps)}")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in steps):
        fail("a two-level train step's loss or grad_norm is not finite")
    print(f"launches over the {TWO_LEVEL_STEPS} two-level train steps: " + ", ".join(
        f"{k.upper()} {v}" for k, v in counts.items()) + f"; {wall:.2f} s in all, the first "
          f"step's cold start included")
    want = {"k1": LAUNCHES_PER_CALL, "k2": LAUNCHES_PER_CALL, "k4": 1, "k5": 1}
    if any(counts[k] != n * TWO_LEVEL_STEPS for k, n in want.items()):
        fail(f"expected {want} launches per two-level train step")
    step_fn = build_train_step(trainer.model, learning_rate_schedule(tcfg), tcfg)
    train_paths_agree(torch, trainer, step_fn, saved,
                      tuple(torch.from_numpy(a).to(dev) for a in batches[0]),
                      "two-level train step")
    time_train_step(torch, trainer, step_fn, batches, dev, "two-level train step", reps=6,
                    plain_reps=2, profile=False)
    return counts


def odometry_sequence():
    """campaign_r5h's sequence (scripts/campaign_r5h.py:57-79): one 25 m
    lidar-like scene (seed 11) seen from ODO_FRAMES frames that yaw 1.5 deg
    and move 0.8 + 0.15 i m a frame. Returns (scans [F, N, 3], the true
    relative poses R [F - 1, 3, 3], t [F - 1, 3]), numpy float32."""
    import numpy as np

    from deepvcp_tpu_torch.data import lidar_like_cloud
    from deepvcp_tpu_torch.utils import axis_angle_to_matrix

    cloud = lidar_like_cloud(np.random.default_rng(ODO_SEED), N_POINTS,
                             max_range=ODO_RANGE).astype(np.float32)
    R_abs, t_abs = [np.eye(3, dtype=np.float32)], [np.zeros(3, dtype=np.float32)]
    R_rel, t_rel = [], []
    for i in range(ODO_FRAMES - 1):
        Rr = axis_angle_to_matrix(np.array([0.0, 0.0, 1.0]), np.radians(1.5)).astype(np.float32)
        tr = np.array([0.8 + 0.15 * i, 0.05, 0.0], np.float32)
        R_rel.append(Rr)
        t_rel.append(tr)
        R_abs.append(Rr @ R_abs[-1])
        t_abs.append(Rr @ t_abs[-1] + tr)
    scans = np.stack([cloud @ R.T + t for R, t in zip(R_abs, t_abs)]).astype(np.float32)
    return scans, np.stack(R_rel), np.stack(t_rel)


def write_kitti_sequence(root: str, scans, R_rel, t_rel) -> None:
    """The sequence in KITTI's layout under root: sequences/00/velodyne/
    NNNNNN.bin (float32 x, y, z, reflectance 0) and poses/00.txt (the
    chained true poses, frame i into frame 0, as 3x4 rows)."""
    import numpy as np
    import torch

    from deepvcp_tpu_torch.odometry import chain_poses

    vdir = os.path.join(root, "sequences", "00", "velodyne")
    os.makedirs(vdir)
    for i, scan in enumerate(scans):
        np.concatenate([scan, np.zeros((len(scan), 1), np.float32)], axis=-1).tofile(
            os.path.join(vdir, f"{i:06d}.bin"))
    R, t = (a.numpy() for a in chain_poses(torch.from_numpy(R_rel), torch.from_numpy(t_rel)))
    os.makedirs(os.path.join(root, "poses"))
    np.savetxt(os.path.join(root, "poses", "00.txt"),
               np.concatenate([R, t[:, :, None]], axis=-1).reshape(len(R), 12))


def check_k1(what: str, counts: dict, stage_calls: int) -> dict:
    """Gate a run's K1 launches (counts from counted_all) at
    LAUNCHES_PER_CALL a stage call (one FE pass on each cloud); returns
    the counts."""
    launches = counts["k1"]
    print(f"K1 launches in {what}: {launches} over {stage_calls} stage calls "
          f"({launches / stage_calls:g} per stage call)")
    if launches != LAUNCHES_PER_CALL * stage_calls:
        fail(f"{what}: expected {LAUNCHES_PER_CALL} K1 launches per stage call, got "
             f"{launches / stage_calls:g}")
    return counts


def odometry_errors(R_est, t_est, R_true, t_true, what: str) -> tuple:
    """Print campaign_r5h's per-frame translation and rotation errors of the
    relative poses (numpy); returns (mean t error m, mean r error deg). The
    rotation error is rotation_geodesic_deg in float64, resolved below the
    0.03 deg at which the campaign's arccos of the trace rounds to 0."""
    import numpy as np
    import torch

    from deepvcp_tpu_torch.data import rotation_geodesic_deg

    terr = np.linalg.norm(t_est - t_true, axis=-1)
    rerr = rotation_geodesic_deg(torch.from_numpy(R_est).double(),
                                 torch.from_numpy(R_true).double()).numpy()
    print(f"{what} per-frame t error (m): " + " ".join(f"{x:.4f}" for x in terr))
    print(f"{what} per-frame r error (deg): " + " ".join(f"{x:.3f}" for x in rerr))
    return float(terr.mean()), float(rerr.mean())


def o1_edges(torch, dev, casc, scans) -> tuple:
    """O1 over `scans` [F, N, 3]: `casc` (kitti-cascade) warm-started frame
    to frame, then a skip edge i -> i + 2 for each i, warm-started from the
    two estimates composed. Returns (R1, t1 numpy, the skip edges
    [(i, j, R, t)], the K1 launches of the sequence and of the skip edges)."""
    from deepvcp_tpu_torch.odometry import register_sequence

    (R1, t1), c_seq = counted_all(torch, lambda: register_sequence(casc, scans, warm_start=True))

    def skip_edges():
        edges = []
        for i in range(len(scans) - 2):
            Ra, ta, Rb, tb = R1[i], t1[i], R1[i + 1], t1[i + 1]
            o = casc(*(torch.from_numpy(a).to(dev) for a in (
                scans[i:i + 1], scans[i + 2:i + 3], (Rb @ Ra)[None], (Rb @ ta + tb)[None])))
            edges.append((i, i + 2, o.R[0].cpu().numpy(), o.t[0].cpu().numpy()))
        return edges
    extra, c_skip = counted_all(torch, skip_edges)
    return R1, t1, extra, c_seq, c_skip


def odometry_phase(torch, dev, reg, pairs, card: str) -> dict:
    """Phase 20: LiDAR odometry (campaign_r5h O1 and O2) on a sequence
    written as KITTI files and read back through the port's loaders,
    the pose graph on the card against the CPU, the odometry CLI, stream
    against per-call, and the routed registrar on campaign_r5d G3's held
    sets. Returns the K1 launch count of its gated runs."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from deepvcp_tpu_torch import convert, pretrained
    from deepvcp_tpu_torch.config import TrainConfig
    from deepvcp_tpu_torch.data import (
        LidarLikeDataset, SyntheticDataset, batch_iterator, rotation_geodesic_deg,
        translation_error)
    from deepvcp_tpu_torch.odometry import (
        absolute_trajectory_error, build_graph, chain_poses, load_kitti_poses,
        load_sequence_scans, optimize_pose_graph, register_sequence, run_odometry)
    from deepvcp_tpu_torch.odometry.__main__ import main as odometry_cli
    from deepvcp_tpu_torch.ops.kernels import reference_path
    from deepvcp_tpu_torch.train import Trainer

    total = {}
    scans_true, R_true, t_true = odometry_sequence()
    F = ODO_FRAMES
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kitti")
        write_kitti_sequence(root, scans_true, R_true, t_true)
        scans = load_sequence_scans(root, "00", N_POINTS)
        R_gt, t_gt = load_kitti_poses(os.path.join(root, "poses", "00.txt"))
        if not np.array_equal(scans, scans_true):
            fail("the velodyne scans read back differ from the ones written")
        print(f"odometry sequence: {F} frames of {N_POINTS} points written as KITTI files and "
              f"read back identical; ground truth from poses/00.txt")
        R_gt_t, t_gt_t = (torch.as_tensor(a, dtype=torch.float32) for a in (R_gt, t_gt))

        # O1: kitti-cascade, warm-started frame to frame
        casc = pretrained.cascade("kitti-cascade", device=dev, num_points=N_POINTS)
        R1, t1, extra, c, c_skip = o1_edges(torch, dev, casc, scans)
        add_counts(total, check_k1("O1's sequence", c, len(casc.stages) * (F - 1)))
        o1 = odometry_errors(R1, t1, R_true, t_true, "O1 kitti-cascade")
        R_ch, t_ch = chain_poses(torch.from_numpy(R1), torch.from_numpy(t1))
        ate1 = float(absolute_trajectory_error(t_ch, t_gt_t))
        add_counts(total, check_k1("O1's skip edges", c_skip, len(casc.stages) * (F - 2)))
        graph_cpu = build_graph(torch.from_numpy(R1), torch.from_numpy(t1), extra_edges=extra)
        graph_dev = graph_cpu._replace(**{k: v.to(dev) for k, v in graph_cpu._asdict().items()})
        R_opt, t_opt = optimize_pose_graph(graph_dev, R_ch.to(dev), t_ch.to(dev),
                                           num_iters=ODO_GN_ITERS)
        R_opt_c, t_opt_c = optimize_pose_graph(graph_cpu, R_ch, t_ch, num_iters=ODO_GN_ITERS)
        ate1_opt = float(absolute_trajectory_error(t_opt.cpu(), t_gt_t))
        d_graph = max((R_opt.cpu() - R_opt_c).abs().max().item(),
                      (t_opt.cpu() - t_opt_c).abs().max().item())
        print(f"O1 kitti-cascade: mean t error {o1[0]:.4f} m, mean r error {o1[1]:.3f} deg, "
              f"raw-chain ATE {ate1:.4f}, pose-graph ATE {ate1_opt:.4f} ({len(extra)} skip "
              f"edges, {ODO_GN_ITERS} GN iterations) | the JAX campaign's (TPU, approx_min_k "
              f"selection): 0.0063 m, 1.038 deg, 0.0226, 0.0302")
        print(f"pose graph on the card vs the CPU, {F} nodes, {F - 1 + len(extra)} edges: "
              f"max|d| {d_graph:.3e}")
        if d_graph > GRAPH_ATOL:
            fail(f"optimize_pose_graph on the card and on the CPU differ by {d_graph}")

        # O2: kitti25-rot at refine_iters 2
        rot = pretrained.registrar("kitti25-rot", device=dev, num_points=N_POINTS,
                                  refine_iters=2)
        (R2, t2), c = counted_all(torch, lambda: register_sequence(rot, scans, warm_start=True))
        add_counts(total, check_k1("O2's sequence", c, F - 1))
        o2 = odometry_errors(R2, t2, R_true, t_true, "O2 kitti25-rot")
        ate2 = float(absolute_trajectory_error(
            chain_poses(torch.from_numpy(R2), torch.from_numpy(t2))[1], t_gt_t))
        print(f"O2 kitti25-rot: mean t error {o2[0]:.4f} m, mean r error {o2[1]:.3f} deg, "
              f"raw-chain ATE {ate2:.4f} | the JAX campaign's (TPU, approx_min_k selection): "
              f"0.0071 m, 0.488 deg, 0.055")
        for what, (te, re) in (("O1", o1), ("O2", o2)):
            if not (te <= ODO_T_LIMIT_M and re <= ODO_R_LIMIT_DEG):
                fail(f"{what}: mean t error {te} m > {ODO_T_LIMIT_M} or mean r error {re} deg "
                     f"> {ODO_R_LIMIT_DEG}")

        # run_odometry through the kernels against the plain path, 4 frames
        short = scans[:4]
        got, c = counted_all(torch, lambda: run_odometry(rot, short, gt_poses=(R_gt, t_gt)))
        add_counts(total, check_k1("run_odometry on 4 frames", c, 3))
        with reference_path():
            want = run_odometry(rot, short, gt_poses=(R_gt, t_gt))
        d_rel = max(np.abs(got[k] - want[k]).max() for k in ("R_rel", "t_rel"))
        print(f"run_odometry on 4 frames, kernel vs plain path: relative poses max|d| "
              f"{d_rel:.3e}; ATE {got['ate_rmse']:.5f} vs {want['ate_rmse']:.5f}")
        if d_rel > ODO_PATH_ATOL:
            fail(f"run_odometry's kernel and plain paths differ by {d_rel}")

        # the CLI on the written sequence, with a checkpoint the Trainer saves
        trainer = Trainer(pretrained.config("kitti25-rot", N_POINTS),
                          TrainConfig(checkpoint_dir=os.path.join(tmp, "ck"),
                                      metrics_path=os.path.join(tmp, "m.jsonl")), device=dev)
        trainer.setup()
        trainer.model.load_state_dict(
            convert.flax_to_torch(pretrained.load_variables("kitti25-rot")))
        ckpt = trainer.save_checkpoint("kitti25-rot")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _, c = counted_all(torch, lambda: odometry_cli([
                "--device", dev.type, "--root", root, "--sequence", "00", "--checkpoint", ckpt,
                "--num-points", str(N_POINTS), "--out", os.path.join(tmp, "trajectory.npz")]))
        add_counts(total, check_k1("the odometry CLI", c, F - 1))
        line = [l for l in out.getvalue().splitlines() if l.startswith("{")][-1]
        print(f"odometry CLI: {line}")
        metrics = json.loads(line)
        if metrics.get("frames") != F or not np.isfinite(metrics.get("ate_rmse", np.nan)):
            fail(f"the odometry CLI printed {metrics}")
        traj = np.load(os.path.join(tmp, "trajectory.npz"))
        if sorted(traj.files) != sorted(["R_rel", "t_rel", "R_abs", "t_abs", "R_opt", "t_opt"]):
            fail(f"the odometry CLI wrote {traj.files}")

    # stream against per-call on phase 4's pairs
    held = [(src, tgt) for src, tgt, _, _ in pairs]
    per_call, c = counted_all(torch, lambda: [reg(*p) for p in held])
    add_counts(total, check_k1("the per-call run", c, len(held)))
    streamed, c = counted_all(torch, lambda: list(reg.stream(iter(held), depth=4)))
    add_counts(total, check_k1("the stream run", c, len(held)))
    for i, (a, b) in enumerate(zip(per_call, streamed)):
        if not all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields):
            fail(f"stream's output {i} differs from the per-call output")
    if len(streamed) != len(held):
        fail(f"stream yielded {len(streamed)} outputs for {len(held)} pairs")
    print(f"stream(depth=4) on {len(held)} pairs: every output bit-identical to the per-call "
          f"one, in order")

    # the routed registrar on campaign_r5d G3's held sets
    routed = pretrained.routed_registrar(device=dev, num_points=N_POINTS)
    experts = {False: pretrained.registrar("modelnet-fine", device=dev, num_points=N_POINTS),
               True: pretrained.registrar("lidar-fine", device=dev, num_points=N_POINTS)}
    kw = dict(num_clouds=ROUTE_B * ROUTE_BATCHES, num_points=N_POINTS, max_rotation_deg=10.0,
              max_translation=0.5)
    sets = {"uniform_small": SyntheticDataset(extent=1.0, seed=100, **kw),
            "lidar_small": LidarLikeDataset(max_range=1.0, seed=101, **kw)}
    batches = {name: [tuple(torch.from_numpy(a).to(dev) for a in b)
                      for b in batch_iterator(ds, ROUTE_B, epoch=0, seed=777, shuffle=False)]
               for name, ds in sets.items()}
    routed_out, c = counted_all(torch, lambda: {
        name: [routed(src, tgt) for src, tgt, _, _ in bs] for name, bs in batches.items()})
    add_counts(total, check_k1("the routed run", c, ROUTE_BATCHES * len(sets)))
    g3 = {"uniform_small": (0.80, 0.026), "lidar_small": (2.12, 0.041)}
    worst = 0.0
    for name, bs in batches.items():
        rre, rte = [], []
        for (src, tgt, R_gt_b, t_gt_b), out in zip(bs, routed_out[name]):
            high = bool(routed.route(src))
            stat = routed.route_statistic(src).tolist()
            if high != (name == "lidar_small"):
                fail(f"{name}: the vote sent a batch {'high' if high else 'low'} (statistic "
                     f"{stat})")
            alone = experts[high](src, tgt)
            worst = max(worst, (out.R - alone.R).abs().max().item(),
                        (out.t - alone.t).abs().max().item())
            rre.append(rotation_geodesic_deg(out.R, R_gt_b).mean().item())
            rte.append(translation_error(out.t, t_gt_b).mean().item())
        print(f"routed {name}: every vote {'high' if name == 'lidar_small' else 'low'}; GT-free "
              f"RRE {statistics.mean(rre):.4f} deg, RTE {statistics.mean(rte):.5f} over "
              f"{len(bs)} batches of {ROUTE_B} | the JAX campaign's G3 (TPU, approx_min_k "
              f"selection): {g3[name][0]} deg, {g3[name][1]}")
    print(f"routed pose against the chosen expert's Registrar: max|d| {worst:.3e}")
    if worst > ROUTE_ATOL:
        fail(f"the routed pose differs from its expert's by {worst}")

    # timing (not gated)
    print(f"odometry timing on {card}:")
    frame = [torch.from_numpy(a).to(dev) for a in (scans[5:6], scans[6:7], R2[4:5], t2[4:5])]
    for what, r in (("O1 kitti-cascade", casc), ("O2 kitti25-rot", rot)):
        ms = host_median_ms(torch, lambda: register_sequence(r, scans, warm_start=True),
                            reps=3) / (F - 1)
        busy, _ = device_time_per_call(torch, lambda: r(*frame), calls=5)
        print(f"  {what}: {ms:.3f} ms per frame (warm-started register_sequence over {F} "
              f"frames, median of 3 synced runs); one warm-started frame's device busy time "
              f"{busy:.3f} ms, idle share {1 - busy / ms:.3f}")
    def per_call_run():
        for p in held:
            reg(*p).R.cpu()

    def stream_run():
        for _ in reg.stream(iter(held), depth=4):
            pass
    ms = turns_ms(torch, {"per call": per_call_run, "stream(depth=4)": stream_run}, reps=1,
                  timer=host_median_ms)
    print(f"  kitti25-rot on phase 4's {len(held)} pairs, ms per pair in 4 turns: " + "; ".join(
        f"{k} {statistics.median(v) / len(held):.3f} (rounds {min(v) / len(held):.3f}-"
        f"{max(v) / len(held):.3f})" for k, v in ms.items()))
    g_ms = host_median_ms(torch, lambda: optimize_pose_graph(
        graph_dev, R_ch.to(dev), t_ch.to(dev), num_iters=ODO_GN_ITERS), reps=3)
    busy, _ = device_time_per_call(torch, lambda: optimize_pose_graph(
        graph_dev, R_ch.to(dev), t_ch.to(dev), num_iters=ODO_GN_ITERS), calls=2)
    print(f"  optimize_pose_graph, {F} nodes, {graph_dev.edges_i.numel()} edges, "
          f"{ODO_GN_ITERS} iterations: {g_ms:.3f} ms ({g_ms / ODO_GN_ITERS:.3f} per "
          f"iteration), device busy {busy:.3f} ms")
    src, tgt = batches["lidar_small"][0][:2]
    sel_ms = cuda_median_ms(torch, lambda: routed.weights(routed.route(src)), reps=50)
    sel_held = cuda_median_ms(torch, lambda: routed.weights(routed.route(src)), reps=50, hold=True)
    ms = turns_ms(torch, {"routed": lambda: routed(src, tgt),
                          "expert": lambda: experts[True](src, tgt)}, reps=5, timer=host_median_ms)
    r_ms, e_ms = (statistics.median(ms[k]) for k in ("routed", "expert"))
    print(f"  routed registrar, B={ROUTE_B}: vote + weight selection {sel_ms:.4f} ms per call "
          f"({sel_held:.4f} behind a device hold); routed call {r_ms:.3f} ms against its "
          f"expert's {e_ms:.3f} ms (medians of synced calls, 4 turns of 5)")
    return {"k1": total["k1"], "k6": total["k6"], "k6b": total["k6b"],
            "graph": (graph_cpu, R_ch, t_ch)}


def kernel_counters() -> dict:
    """Each kernel's wrapper, whose `launches` attribute counts its launches."""
    from deepvcp_tpu_torch.ops.kernels import band_max, fps, knn_select
    from deepvcp_tpu_torch.ops.kernels import onehot_gather as og

    return {"k1": band_max.banded_masked_max, "k2": band_max.banded_masked_max_grad,
            "k3": fps.farthest_point_sample, "k4": og.onehot_gather,
            "k5": og.onehot_scatter_add, "k6": knn_select.knn_select,
            "k6b": knn_select.knn_select_bf16}


def counted_all(torch, fn):
    """(fn(), {kernel: launches during it}): every count set to 0 just before
    fn and read just after it, the device synchronised on both sides."""
    counters = kernel_counters()
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in counters.items()}


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def uniform_small_pairs(torch, dev, n_points: int) -> list:
    """campaign_r4's held uniform_small set (scripts/campaign_r4_common.py:
    142-144) at n_points, drawn as the campaign's eval batches draw it (seed
    777, in order), B = 1, on dev."""
    from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator

    held = SyntheticDataset(num_clouds=ENGINE_PAIRS, num_points=n_points, extent=1.0, seed=100,
                            max_rotation_deg=10.0, max_translation=0.5)
    return [tuple(torch.from_numpy(a.astype("float32")).to(dev) for a in b)
            for b in batch_iterator(held, 1, epoch=0, seed=777, shuffle=False)]


def gt_free_errors(torch, outs, pairs, what: str) -> tuple:
    """Check each Registrar output's pose is finite and a rotation; return
    the mean GT-free RRE (deg) and RTE."""
    from deepvcp_tpu_torch.data import rotation_geodesic_deg, translation_error

    rre, rte = [], []
    eye = torch.eye(3, device=outs[0].R.device)
    for i, (out, (_, _, R_gt, t_gt)) in enumerate(zip(outs, pairs)):
        if not (torch.isfinite(out.R).all() and torch.isfinite(out.t).all()):
            fail(f"{what} pair {i}: a non-finite pose")
        if (out.R[0] @ out.R[0].T - eye).abs().max() > 1e-4:
            fail(f"{what} pair {i}: R is not a rotation")
        rre.append(rotation_geodesic_deg(out.R.double(), R_gt.double()).item())
        rte.append(translation_error(out.t, t_gt).item())
    return statistics.mean(rre), statistics.mean(rte)


def run_engine(torch, reg, pairs, what: str, total: dict, k1_per_call=None) -> tuple:
    """The main path of one engine: reg on every pair, its launches counted
    (and K1's gated at k1_per_call a call where given). Returns (outputs,
    mean RRE, mean RTE, counts)."""
    outs, counts = counted_all(torch, lambda: [reg(src, tgt) for src, tgt, _, _ in pairs])
    add_counts(total, counts)
    rre, rte = gt_free_errors(torch, outs, pairs, what)
    print(f"{what}: {len(pairs)} pairs, launches " + ", ".join(
        f"{k.upper()} {v}" for k, v in counts.items()) + f"; GT-free mean RRE {rre:.4f} deg, "
        f"mean RTE {rte:.5f}")
    if k1_per_call is not None and counts["k1"] != k1_per_call * len(pairs):
        fail(f"{what}: expected {k1_per_call} K1 launches a call, got "
             f"{counts['k1'] / len(pairs):g}")
    return outs, rre, rte, counts


def engine_timing(torch, reg, src, tgt, what: str) -> float:
    """Print a Registrar's synced latency, device busy time and idle share
    (not gated); returns the latency."""
    lat = host_median_ms(torch, lambda: reg(src, tgt), reps=10)
    busy, top = device_time_per_call(torch, lambda: reg(src, tgt), calls=3)
    idle = f"{1 - busy / lat:.3f}" if busy > 0 else "not measured"
    print(f"{what} per call: {lat:.3f} ms (median of 10 synced calls), device busy "
          f"{busy:.3f} ms, idle share {idle}; top kernels: "
          + "; ".join(f"{k} {v:.3f}" for k, v in top[:4]))
    return lat


def near_tie_rows(xyz, queries, rows, radius: float) -> list:
    """For each query row in `rows`, whether some point of xyz lies within
    NEAR_TIE_D2 of radius^2 from it (float64 squared distances)."""
    import numpy as np

    x = xyz.double().cpu().numpy()
    q = queries.double().cpu().numpy()
    out = []
    for b, s in rows:
        d2 = ((x[b] - q[b, s]) ** 2).sum(-1)
        out.append(bool(np.any(np.abs(d2 - radius * radius) < NEAR_TIE_D2)))
    return out


def neighbours_agree(torch, fn, xyz_dev, radius: float, what: str) -> None:
    """fn(xyz) -> (idx, count) of the first SA stage's neighbour query, run
    on the card and on the CPU: identical, or different only in queries with
    a point within NEAR_TIE_D2 of the radius (counted and printed)."""
    idx_d, cnt_d = fn(xyz_dev)
    idx_c, cnt_c = fn(xyz_dev.cpu())
    differ = ((idx_d.cpu() != idx_c).any(-1) | (cnt_d.cpu() != cnt_c)).nonzero().tolist()
    ties = near_tie_rows(xyz_dev, xyz_dev, differ, radius)
    print(f"{what}: first SA stage's neighbour sets, card vs CPU: {idx_d.shape[1]} queries, "
          f"{len(differ)} differ, {sum(ties)} of them with a point within {NEAR_TIE_D2:g} of "
          f"r^2 = {radius * radius:g}")
    if not all(ties):
        fail(f"{what}: neighbour sets differ away from the radius")


def selection_d2(model, ref, query, b: int, m: int, center=None):
    """Query row (b, m)'s squared distances to ref[b] [N], ranked as the
    model's selection ranks them (its select_args' dtype): the
    reduced-precision tile (ops/kernels/knn_select.py::tile_d2) of the
    clouds centred on `center`, by default ref[b]'s mean, or
    square_distance's f32 tile."""
    import torch

    from deepvcp_tpu_torch.ops.distance import square_distance
    from deepvcp_tpu_torch.ops.kernels import knn_select as k6

    select_dtype = model.select_args()["select_dtype"]
    r, q = ref[b], query[b, m][None]
    if select_dtype is None:
        return square_distance(q, r)[0]
    sel = getattr(torch, select_dtype)
    r, q = k6.centred(r, q) if center is None else (r - center, q - center)
    return k6.tile_d2(k6.tile_terms(r, sel), k6.tile_terms(q, sel), sel)[0]


def selection_near_tie(model, ref, query, b: int, m: int, k: int, swapped: list,
                       center=None) -> bool:
    """Whether the points `swapped` between two selections of the k
    nearest of ref to query row (b, m) all lie at a near-tie of the k-th
    distance, ranked by selection_d2. The two computations' f32 sums differ
    in their last bits, so a bf16 value rounds to the same number or the
    next one on each, and a swap lies within 2 bf16 steps of the k-th; in
    f32, within 2 x 8 ulps of |q|^2 + max |r|^2, the scale of the terms the
    matmul form adds."""
    import math

    import torch

    d2 = selection_d2(model, ref, query, b, m, center)
    kth = torch.sort(d2.float()).values[k - 1].item()
    if d2.dtype == torch.float32:
        q, r = query[b, m], ref[b]
        tol = 16 * 2.0 ** -24 * ((q * q).sum() + (r * r).sum(-1).max()).item()
    else:
        tol = 2 * 2.0 ** (math.floor(math.log2(max(kth, 1e-30))) - 7)
    return (d2.float()[swapped] - kth).abs().max().item() <= tol


def pinned_pose(torch, reg, reg_cpu, src, tgt, what: str):
    """reg on the card and reg_cpu on the CPU on one pair, the CPU's
    candidate selections (each call of the model's _knn) replaced by the
    card's after checking that they differ only at near-ties of the k-th
    distance (selection_near_tie): both are then valid selections, and the
    rest of the served path is held card vs CPU. Returns (card output, CPU
    output)."""
    from deepvcp_tpu_torch.models.deepvcp import DeepVCP

    picked = []

    def record(ref, query, chunked, parts=1):
        out = DeepVCP._knn(reg.model, ref, query, chunked, parts)
        picked.append(out[1])
        return out

    reg.model._knn = record
    try:
        out_d = reg(src, tgt)
    finally:
        del reg.model._knn
    card = iter(picked)
    reg_cpu.model._knn, n = pinned_knn(torch, reg_cpu.model, card)
    try:
        out_c = reg_cpu(src.cpu(), tgt.cpu())
    finally:
        del reg_cpu.model._knn
    if len(picked) == 0 or next(card, None) is not None:
        fail(f"{what}: the card and the CPU made different numbers of candidate selections")
    print(f"{what} pair 0: candidate selections, card vs CPU: {len(picked)} calls, {n['rows']} "
          f"query rows differ, {n['ties']} of them only at a near-tie of the k-th distance "
          f"(the CPU then takes the card's rows)")
    if n["ties"] != n["rows"]:
        fail(f"{what}: candidate selections differ away from a near-tie")
    return out_d, out_c


def pinned_knn(torch, model, picked, rows=None):
    """A stand-in for model._knn that returns the selections `picked` (an
    iterator of index tensors, one a call) in place of the model's own,
    after counting the query rows that differ ("rows") and those that
    differ only at a near-tie of the k-th distance ("ties",
    selection_near_tie): then both are valid selections. Where `rows` is
    given, a call whose query has another number of rows keeps the model's
    own. Returns (the stand-in, the counts)."""
    from deepvcp_tpu_torch.models.deepvcp import DeepVCP

    n = {"rows": 0, "ties": 0}

    def pin(ref, query, chunked, parts=1):
        dist, idx = DeepVCP._knn(model, ref, query, chunked, parts)
        if rows is not None and query.shape[1] != rows:
            return dist, idx
        idx_p = next(picked).to(idx.device, torch.long)
        differ = (torch.sort(idx, -1).values != torch.sort(idx_p, -1).values).any(-1)
        for b, m in differ.nonzero().tolist():
            swapped = sorted(set(idx[b, m].tolist()) ^ set(idx_p[b, m].tolist()))
            n["rows"] += 1
            n["ties"] += selection_near_tie(model, ref, query, b, m, idx.shape[-1], swapped)
        return dist, idx_p

    return pin, n


def model_card_vs_cpu(torch, reg, reg_cpu, src, tgt, what: str,
                      rtol: float = CARD_CPU_RTOL, reg64=None) -> None:
    """Pair 0 through the model on the card and on the CPU (TF32 off): FE
    features and saliency within rtol of their max (with reg64, a float64
    copy on the CPU, also within the CPU's own f32 distance from it: the
    devices agree better than f32 agrees with exact arithmetic); the
    keypoint sets equal, or different only at saliency near-ties (within
    rtol of the K-th); where equal, the served pose within CARD_CPU_POSE,
    the candidate selections pinned (pinned_pose)."""
    with torch.no_grad():
        enc_d, enc_c = reg.model.encode(src, tgt), reg_cpu.model.encode(src.cpu(), tgt.cpu())
    # the target cloud's FE features (tgt_table is xyz ++ features) and the
    # source cloud's saliency
    f_d, f_c = enc_d.tgt_table[..., 3:].float().cpu(), enc_c.tgt_table[..., 3:].float()
    s_d, s_c = enc_d.saliency.float().cpu(), enc_c.saliency.float()

    def rel(a, b):
        return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()

    df, ds = rel(f_d, f_c), rel(s_d, s_c)
    kd = set(enc_d.keypoint_idx[0].tolist())
    kc = set(enc_c.keypoint_idx[0].tolist())
    print(f"{what} pair 0, card vs CPU: FE features max|d| {df:.3e} of their max, saliency "
          f"{ds:.3e}; keypoint sets {'equal' if kd == kc else 'differ'}")
    if df > rtol or ds > rtol:
        fail(f"{what}: FE features or saliency differ between the card and the CPU by more "
             f"than {rtol:g} of their max")
    if reg64 is not None:
        with torch.no_grad():
            enc64 = reg64.model.encode(src.cpu().double(), tgt.cpu().double())
        f64, s64 = enc64.tgt_table[..., 3:], enc64.saliency
        off = {"card": (rel(f_d, f64), rel(s_d, s64)), "CPU": (rel(f_c, f64), rel(s_c, s64))}
        print(f"{what} pair 0 against a float64 CPU run: " + "; ".join(
            f"{k} FE features {a:.3e}, saliency {b:.3e} of their max" for k, (a, b) in off.items()))
        if df > off["CPU"][0] or ds > off["CPU"][1]:
            fail(f"{what}: the card and the CPU differ by more than the CPU's own f32 forward "
                 f"differs from float64")
    if kd != kc:
        sal = s_c[0].double()
        kth = torch.sort(sal, descending=True).values[len(kd) - 1].item()
        swapped = sorted(kd ^ kc)
        gaps = [abs(sal[i].item() - kth) / kth for i in swapped]
        print(f"{what}: {len(swapped)} keypoints swapped, saliency within "
              f"{max(gaps):.3e} of the K-th (relative)")
        if max(gaps) > rtol:
            fail(f"{what}: keypoints differ away from a saliency near-tie")
        return
    out_d, out_c = pinned_pose(torch, reg, reg_cpu, src, tgt, what)
    dR = (out_d.R.cpu() - out_c.R).abs().max().item()
    dt = (out_d.t.cpu() - out_c.t).abs().max().item()
    print(f"{what} pair 0, card vs CPU: max|dR| {dR:.3e}, max|dt| {dt:.3e}")
    if dR > CARD_CPU_POSE or dt > CARD_CPU_POSE:
        fail(f"{what}: the pose differs between the card and the CPU")


def gather_engines(torch, dev, total: dict) -> dict:
    """Phase 21, windowed and dense: campaign_r4b's model_q5w (trained on
    the windowed engine) at N = 2048 on campaign_r4's held uniform_small
    pairs, under its engine and under the dense one."""
    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.ops import query_ball_point
    from deepvcp_tpu_torch.ops.neighbors import (
        slab_occupancy_stats, sort_cloud, window_for, windowed_ball_query)

    name = "campaign_r4b-q5w"
    entry = pretrained.CAMPAIGN[name]
    pairs = uniform_small_pairs(torch, dev, entry["num_points"])
    lat = {}
    for engine in ("windowed", "dense"):
        what = f"model_q5w {engine}"
        kw = dict(cfg_changes={"neighbor_method": engine}, guard=False)
        reg = pretrained.campaign_registrar(name, device=dev, **kw)
        cfg = reg.cfg.resolve()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, rre, rte, _ = run_engine(torch, reg, pairs, what, total)
        audit = [str(w.message) for w in caught if "window" in str(w.message)]
        ref = entry["gt_free"]["uniform_small" if engine == "windowed" else "uniform_small_dense"]
        print(f"{what}: GT-free RRE {rre:.4f} deg / RTE {rte:.5f} beside the campaign's "
              f"{ref[0]} deg / {ref[1]} (TPU, approx_min_k selection; the port selects exactly)")
        src, tgt = pairs[0][0], pairs[0][1]
        layer = cfg.sa_layers[0]
        if engine == "windowed":
            N = cfg.num_points
            occ = [(l.radius, window_for(N, l.radius, cfg.spatial_extent, cfg.window_safety),
                    slab_occupancy_stats(src[..., :3], l.radius)["max"]) for l in cfg.sa_layers]
            print(f"{what}: preflight (first call): {audit[0] if audit else 'no warning'}; per SA "
                  "radius (window, max slab on pair 0): " + ", ".join(
                      f"r {r}: ({w}, {m})" for r, w, m in occ))
            w0 = occ[0][1]

            def first_stage(x):
                cloud = sort_cloud(x[..., :3])
                return windowed_ball_query(cloud, cloud.xyz, layer.radius, layer.nsample, w0,
                                           return_count=True)
            xyz0 = sort_cloud(src[..., :3]).xyz
        else:
            def first_stage(x):
                return query_ball_point(layer.radius, layer.nsample, x, x,
                                        chunk=cfg.query_chunk, return_count=True)
            xyz0 = src[..., :3]
        neighbours_agree(torch, first_stage, xyz0, layer.radius, what)
        model_card_vs_cpu(torch, reg, pretrained.campaign_registrar(name, device="cpu", **kw),
                          src, tgt, what)
        lat[engine] = engine_timing(torch, reg, src, tgt, what)
    return {"latency": lat}


def keypoints_branch(torch, dev, total: dict) -> dict:
    """Phase 21, keypoints branch: campaign_r4's model_r1c (banded engine,
    dfe_src_neighbors="keypoints", uncentred grid, no derotation) at
    N = 10 000 on uniform_small; K1 in every FE pass."""
    from deepvcp_tpu_torch import pretrained

    name = "campaign_r4-r1c"
    pairs = uniform_small_pairs(torch, dev, N_POINTS)
    reg = pretrained.campaign_registrar(name, device=dev, guard=False)
    _, rre, rte, _ = run_engine(torch, reg, pairs, "model_r1c keypoints branch", total,
                                k1_per_call=LAUNCHES_PER_CALL)
    ref = pretrained.CAMPAIGN[name]["gt_free"]["uniform_small"]
    print(f"model_r1c: GT-free RRE {rre:.4f} deg / RTE {rte:.5f} beside the campaign's "
          f"{ref[0]} deg / {ref[1]} (TPU, approx_min_k selection)")
    src, tgt = pairs[0][0], pairs[0][1]
    registrar_paths_agree(torch, reg, src, tgt, "model_r1c")
    return {"pairs": pairs, "latency": engine_timing(torch, reg, src, tgt, "model_r1c")}


def static_band(torch, dev, pairs, total: dict, exact: dict) -> dict:
    """Phase 21, static band: kitti25-rot with use_pallas_band_max=False on
    phase 4's pairs. No kernel: plain PyTorch on the card."""
    import dataclasses

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.models import fused_sa
    from deepvcp_tpu_torch.registration import Registrar

    cfg, variables = pretrained.load("kitti25-rot", num_points=N_POINTS)
    cfg = dataclasses.replace(cfg, use_pallas_band_max=False)
    kw = dict(use_saliency_weights=True, refine_iters=pretrained.REGISTRY["kitti25-rot"]
              ["refine_iters"])
    reg = Registrar(cfg, variables, dev, **kw)
    _, rre, rte, counts = run_engine(torch, reg, pairs, "kitti25-rot static band", total,
                                     k1_per_call=0)
    src, tgt = pairs[0][0], pairs[0][1]
    # the static band of each SA stage on pair 0's inputs, card vs CPU
    seen, pool = [], fused_sa.static_band_max_pool

    def record(xyz, u, radius, window, tile):
        seen.append((xyz, u, radius, window, tile))
        return pool(xyz, u, radius, window, tile)

    fused_sa.static_band_max_pool = record
    try:
        with torch.no_grad():
            reg.model.features(src)
    finally:
        fused_sa.static_band_max_pool = pool
    for i, (xyz, u, radius, window, tile) in enumerate(seen):
        d = fused_sa.static_band_max(xyz, u, radius, window, tile)
        c = fused_sa.static_band_max(xyz.cpu(), u.cpu(), radius, window, tile)
        same = torch.equal(d.cpu(), c)
        print(f"static band, SA stage {i + 1} (C = {u.shape[-1]}, r = {radius}, window "
              f"{window}, tile {tile}): card vs CPU {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail("the static band differs between the card and the CPU")
    reg64 = Registrar(cfg, variables, "cpu", **kw)
    reg64.model.double()
    model_card_vs_cpu(torch, reg, Registrar(cfg, variables, "cpu", **kw), src, tgt,
                      "kitti25-rot static band", rtol=CARD_CPU_RTOL_25M, reg64=reg64)
    lat = engine_timing(torch, reg, src, tgt, "kitti25-rot static band")
    print(f"kitti25-rot static band vs exact slab (phase 4): mean RRE {rre:.4f} vs "
          f"{exact['rre']:.4f} deg, RTE {rte:.5f} vs {exact['rte']:.5f} m; latency {lat:.3f} "
          f"vs {exact['latency']:.3f} ms")
    return {"latency": lat}


def bf16_path(torch, dev, pairs, total: dict, exact: dict) -> dict:
    """Phase 21, bf16: kitti25-rot under compute_dtype="bfloat16" on phase
    4's pairs; K1 on f32 copies of the bf16 values."""
    import dataclasses

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.ops.kernels import reference_path
    from deepvcp_tpu_torch.registration import Registrar

    cfg, variables = pretrained.load("kitti25-rot", num_points=N_POINTS)
    reg = Registrar(dataclasses.replace(cfg, compute_dtype="bfloat16"), variables, dev,
                    use_saliency_weights=True,
                    refine_iters=pretrained.REGISTRY["kitti25-rot"]["refine_iters"])
    _, rre, rte, _ = run_engine(torch, reg, pairs, "kitti25-rot bf16", total,
                                k1_per_call=LAUNCHES_PER_CALL)
    print(f"kitti25-rot bf16 vs f32 (phase 4): mean RRE {rre:.4f} vs {exact['rre']:.4f} deg, "
          f"RTE {rte:.5f} vs {exact['rte']:.5f} m")
    src, tgt = pairs[0][0], pairs[0][1]
    out_k = reg(src, tgt)
    with reference_path():
        out_p = reg(src, tgt)
    same = all(torch.equal(getattr(out_k, f), getattr(out_p, f))
               for f in ("keypoints", "R", "t", "scores"))
    print(f"kitti25-rot bf16 kernel vs plain path, pair 0: keypoints, pose and scores "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        fail("bf16: the kernel and plain paths differ")
    return {"latency": engine_timing(torch, reg, src, tgt, "kitti25-rot bf16")}


def plain_two_level(torch, dev, pairs, total: dict) -> None:
    """Phase 21, plain two-level gather: kitti25 two-level with
    use_pallas_onehot_gather=False (torch.gather, 0 K4 launches) against the
    K4 path on pair 0."""
    import dataclasses

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.registration import Registrar

    cfg, variables = pretrained.load("kitti25", num_points=N_POINTS)
    cfg = dataclasses.replace(cfg, **TWO_LEVEL)
    kw = dict(use_saliency_weights=True, refine_iters=pretrained.REGISTRY["kitti25"]
              ["refine_iters"])
    plain = Registrar(dataclasses.replace(cfg, use_pallas_onehot_gather=False), variables, dev,
                      **kw)
    k4 = Registrar(cfg, variables, dev, **kw)
    _, _, _, counts = run_engine(torch, plain, pairs[:4], "kitti25 two-level, plain gather",
                                 total, k1_per_call=LAUNCHES_PER_CALL)
    if counts["k4"] or counts["k5"]:
        fail("the plain two-level gather launched K4 or K5")
    src, tgt = pairs[0][0], pairs[0][1]
    out_p, out_k = plain(src, tgt), k4(src, tgt)
    same = torch.equal(out_p.R, out_k.R) and torch.equal(out_p.t, out_k.t)
    print(f"kitti25 two-level pair 0, torch.gather vs K4: pose "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        fail("the plain two-level gather's pose differs from the K4 path's")
    engine_timing(torch, plain, src, tgt, "kitti25 two-level, plain gather")


def msg_fp(torch, dev, clouds, total: dict) -> None:
    """Phase 21, MSG / FP: SetAbstractionMSG on [2, 10 000, 3] to 1024
    centroids (3 scales), then FeaturePropagation back to the 10 000 points,
    random weights from a seed; kernel path against plain path."""
    from deepvcp_tpu_torch.models import FeaturePropagation, SetAbstractionMSG
    from deepvcp_tpu_torch.ops.kernels import reference_path

    torch.manual_seed(21)
    msg = SetAbstractionMSG(MSG_NPOINT, (0.05, 0.1, 0.2), (16, 32, 64),
                            ((16, 16, 32), (32, 32, 64), (32, 48, 64))).to(dev).eval()
    fp = FeaturePropagation((128, 64), in_features=32 + 64 + 64).to(dev).eval()

    def run():
        with torch.no_grad():
            new_xyz, feats = msg(clouds, None)
            return new_xyz, feats, fp(clouds, new_xyz, None, feats)

    got, counts = counted_all(torch, run)
    add_counts(total, counts)
    with reference_path():
        want = run()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"SetAbstractionMSG {tuple(clouds.shape)} -> {tuple(got[1].shape)}, "
          f"FeaturePropagation -> {tuple(got[2].shape)}: K3 launches {counts['k3']}; kernel vs "
          f"plain path {'identical' if same else 'DIFFERENT'}")
    if counts["k3"] != 1 or not same or not all(torch.isfinite(x).all() for x in got):
        fail("MSG / FP: expected 1 K3 launch and identical, finite outputs on both paths")
    ms = host_median_ms(torch, run, reps=5)
    print(f"MSG + FP per call: {ms:.3f} ms (median of 5 synced calls)")


def q5w_trainer(dev, cfg_changes: dict, metrics=None):
    """A Trainer of model_q5w (its config changed by `cfg_changes`) under
    its campaign recipe (residual_tcfg, scripts/campaign_r4_common.py:85),
    its weights loaded: (trainer, recipe)."""
    from deepvcp_tpu_torch import convert, pretrained
    from deepvcp_tpu_torch.train import TrainConfig, Trainer

    tcfg = TrainConfig(batch_size=1, learning_rate=1e-3, vcp_loss_weight=1.0,
                       lr_schedule="cosine", warmup_steps=100, total_steps=768,
                       use_saliency_weights=True, init_translation="gt",
                       init_rot_jitter_deg=12.0, init_trans_jitter=0.5, log_every=1)
    name = "campaign_r4b-q5w"
    trainer = Trainer(pretrained.campaign_config(name, **cfg_changes), tcfg, device=dev,
                      metrics=metrics)
    trainer.setup()
    trainer.model.load_state_dict(convert.flax_to_torch(pretrained.load_variables(name)),
                                  strict=True)
    return trainer, tcfg


def windowed_training(torch, dev, total: dict) -> None:
    """Phase 21, windowed training: 2 Trainer steps of model_q5w at N = 2048
    under its campaign recipe (residual_tcfg,
    scripts/campaign_r4_common.py:85) on the first 2 of its training clouds."""
    import numpy as np

    from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator
    from deepvcp_tpu_torch.train import MetricsLogger

    records = []

    class Records(MetricsLogger):
        def log(self, record):
            records.append(record)

    trainer, _ = q5w_trainer(dev, {}, metrics=Records(None, echo=False))
    data = SyntheticDataset(num_clouds=2, num_points=Q5W_POINTS, extent=1.0, seed=0)
    batches = list(batch_iterator(data, 1, epoch=0, seed=0))
    params0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}

    def steps():
        trainer.train_epoch(iter(batches[:1]), epoch=0)
        torch.cuda.synchronize()
        moved0 = sum(not torch.equal(p, params0[n]) for n, p in trainer.model.named_parameters())
        trainer.train_epoch(iter(batches[1:]), epoch=0)
        return moved0

    moved0, counts = counted_all(torch, steps)
    add_counts(total, counts)
    moved = sum(not torch.equal(p, params0[n]) for n, p in trainer.model.named_parameters())
    logged = [r for r in records if r["kind"] == "train"]
    for i, r in enumerate(logged):
        print(f"model_q5w windowed train step {i}: loss {r['loss']:.5f}, grad_norm "
              f"{r['grad_norm']:.4f}")
    print(f"model_q5w windowed training: parameters changed by step 0 (warmup lr 0) {moved0}, "
          f"after step 1 {moved} of {len(params0)}; launches " + ", ".join(
              f"{k.upper()} {v}" for k, v in counts.items()))
    if len(logged) != 2 or not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                                   for r in logged):
        fail("windowed training: expected 2 steps with finite loss and grad norm")
    if moved0 or not moved:
        fail("windowed training: step 0 changed the parameters, or step 1 changed none")


def save_vis_cli(torch, dev, total: dict) -> None:
    """Phase 21, --save-vis: the training CLI with --eval-only --save-vis on
    a Trainer checkpoint of kitti25-rot's weights, on the card."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from deepvcp_tpu_torch import convert, pretrained
    from deepvcp_tpu_torch.data import batch_iterator
    from deepvcp_tpu_torch.ops import apply_rigid
    from deepvcp_tpu_torch.registration import Registrar
    from deepvcp_tpu_torch.train import TrainConfig, Trainer
    from deepvcp_tpu_torch.train.cli import build_parser, configs_from_args, main, make_dataset
    from deepvcp_tpu_torch.utils.vis import load_cloud_pairs

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(pretrained.config("kitti25-rot", N_POINTS),
                          TrainConfig(checkpoint_dir=os.path.join(tmp, "ck")), device=dev)
        trainer.setup()
        trainer.model.load_state_dict(
            convert.flax_to_torch(pretrained.load_variables("kitti25-rot")))
        ckpt = trainer.save_checkpoint("kitti25-rot")
        vis = os.path.join(tmp, "vis")
        argv = ["--device", dev.type, "-d", "synthetic", "--num-points", str(N_POINTS),
                "--metrics-path", os.path.join(tmp, "m.jsonl"), "--eval-only", "-r", ckpt]
        with contextlib.redirect_stdout(io.StringIO()), warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the CLI's config is not the checkpoint's
            _, counts = counted_all(torch, lambda: main(argv + ["--save-vis", vis]))
        add_counts(total, counts)
        args = build_parser().parse_args(argv)
        model_cfg, train_cfg = configs_from_args(args)
        test = make_dataset(args, model_cfg, "test")
        files = sorted(os.listdir(vis))
        want_files = sorted([f"{i}_{k}.npy" for i in range(len(test)) for k in ("gt", "pred")]
                            + ["vis.pcd"])
        src, tgt, _, _ = next(batch_iterator(test, 1, epoch=0, seed=train_cfg.seed + 1,
                                             shuffle=False))
        state = torch.load(ckpt, map_location=dev, weights_only=True)["model"]
        reg = Registrar(model_cfg, state, dev)
        src_t = torch.from_numpy(src).to(dev)
        r = reg(src_t, torch.from_numpy(tgt).to(dev))
        pred = apply_rigid(src_t[..., :3], r.R, r.t)[0].cpu().numpy()
        gt0, pred0 = load_cloud_pairs(vis)[0]
        same = np.array_equal(pred0, pred) and np.array_equal(gt0, tgt[0, :, :3])
        print(f"--save-vis: {len(files)} files for {len(test)} test pairs ({files[0]} ... "
              f"{files[-1]}); pair 0 read back {'equals' if same else 'DIFFERS FROM'} the "
              f"registrar's transformed source; launches " + ", ".join(
                  f"{k.upper()} {v}" for k, v in counts.items()))
        if files != want_files or not same:
            fail("--save-vis wrote the wrong files, or pair 0 is not the registrar's")


def engines_phase(torch, dev, pairs, exact: dict) -> dict:
    """Phase 21: the non-default engines and paths. Returns each kernel's
    launches in their main-path runs."""
    t0 = time.perf_counter()
    total = {}
    gather = gather_engines(torch, dev, total)
    kp = keypoints_branch(torch, dev, total)
    sb = static_band(torch, dev, pairs, total, exact)
    bf = bf16_path(torch, dev, pairs, total, exact)
    plain_two_level(torch, dev, pairs, total)
    msg_fp(torch, dev, torch.cat([p[0] for p in kp["pairs"][:2]]), total)
    windowed_training(torch, dev, total)
    save_vis_cli(torch, dev, total)
    print("phase 21 latency per call (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in (
        ("windowed N=2048", gather["latency"]["windowed"]),
        ("dense N=2048", gather["latency"]["dense"]), ("keypoints branch", kp["latency"]),
        ("static band", sb["latency"]), ("bf16", bf["latency"]),
        ("exact slab (phase 4)", exact["latency"]))))
    print(f"phase 21 launches: " + ", ".join(f"{k.upper()} {v}" for k, v in total.items())
          + f"; {time.perf_counter() - t0:.1f} s")
    return total


def dp_setup(torch, dev, split=None, batch: int = 2):
    """Phase 22's step inputs, the same in every process: kitti25-rot under
    its recipe (fine_tuning), one B = `batch` (2) batch of 25 m lidar-like
    pairs, at step DP_STEP (past the warmup: lr > 0); or, for an
    ENGINE_SPLITS name, its checkpoint and config under its recipe,
    model_q5w on a batch of its training clouds. Returns (trainer, recipe,
    the saved model and optimizer state, the batch on dev)."""
    import copy

    from deepvcp_tpu_torch.data import LidarLikeDataset, SyntheticDataset, batch_iterator
    from deepvcp_tpu_torch.train import MetricsLogger

    name, changes = ("kitti25-rot", {}) if split is None else ENGINE_SPLITS[split][:2]
    if name == "kitti25-rot":
        trainer, tcfg, _, _, saved = fine_tuning(name, changes, 1, dev)
        data = LidarLikeDataset(num_clouds=batch, num_points=N_POINTS, max_range=25.0, seed=12)
    else:
        trainer, tcfg = q5w_trainer(dev, changes, metrics=MetricsLogger(None, echo=False))
        saved = (copy.deepcopy(trainer.model.state_dict()),
                 copy.deepcopy(trainer.state.optimizer.state_dict()), trainer.state.step)
        data = SyntheticDataset(num_clouds=batch, num_points=Q5W_POINTS, extent=1.0, seed=0)
    pairs = tuple(torch.from_numpy(a).to(dev) for a in next(batch_iterator(data, batch, seed=0)))
    return trainer, tcfg, saved, pairs


def step_result(torch, trainer, step_fn, saved, batch) -> dict:
    """One step of step_fn from `saved` at DP_STEP on `batch`: its metrics,
    and the gradients, parameters and running statistics after it (on the
    CPU)."""
    model = trainer.model
    model.load_state_dict(saved[0])
    trainer.state.optimizer.load_state_dict(saved[1])
    trainer.state.step = DP_STEP
    trainer.state, m = step_fn(trainer.state, *batch)
    torch.cuda.synchronize()
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "stats": {n: b.cpu() for n, b in model.named_buffers() if "running" in n}}


def sharded_step_agrees(torch, dev, mesh) -> tuple:
    """Phase 22, the step: make_train_step(mesh=1 x 1) against
    make_train_step(mesh=None) from one saved kitti25-rot state on one B = 2
    batch, under deterministic algorithms, with the recipe's jittered warm
    start. Fails unless the loss agrees within LOSS_RTOL, the grad norm
    within GRAD_RTOL, every gradient tensor by phase 9's rule, the running
    statistics within STAT_ATOL, the parameters after the step within
    SHARDED_PARAM_LR x lr, and the sharded step launches LAUNCHES_PER_CALL
    K1 and K2. Returns (its launches, the unsharded step's result with its
    step_peak under "peak", lr)."""
    from deepvcp_tpu_torch.train import make_train_step
    from deepvcp_tpu_torch.train.optim import learning_rate_schedule

    trainer, tcfg, saved, batch = dp_setup(torch, dev)
    schedule = learning_rate_schedule(tcfg)
    model = trainer.model
    plain = make_train_step(model, schedule, tcfg)
    with deterministic(torch):
        ref = step_result(torch, trainer, plain, saved, batch)
        sharded = make_train_step(model, schedule, tcfg, mesh=mesh)
        got, counts = counted_all(
            torch, lambda: step_result(torch, trainer, sharded, saved, batch))
        ms = {what: host_median_ms(torch, lambda: step_result(torch, trainer, fn, saved, batch),
                                   reps=3)
              for what, fn in (("unsharded", plain), ("sharded", sharded))}
    # the unsharded B = 2 step's memory, as the gloo ranks of part 2 measure theirs
    _, ref["peak"] = step_peak(torch, lambda: step_result(torch, trainer, plain, saved, batch))
    ref["ms"] = ms["unsharded"]
    lr = schedule(DP_STEP)
    m_p, m_s = ref["metrics"], got["metrics"]
    own = {n: g.abs().max().item() for n, g in ref["grads"].items()}
    rel, cancelling = grad_rel_errors(
        {n: (got["grads"][n] - g).abs().max().item() for n, g in ref["grads"].items()},
        own, m_p["grad_norm"])
    loss_rel = abs(m_s["loss"] - m_p["loss"]) / abs(m_p["loss"])
    norm_rel = abs(m_s["grad_norm"] - m_p["grad_norm"]) / m_p["grad_norm"]
    param_err = max((got["params"][n] - p).abs().max().item() for n, p in ref["params"].items())
    stat_err = max((got["stats"][n] - s).abs().max().item() for n, s in ref["stats"].items())
    print(f"sharded train step on a 1 x 1 NCCL mesh vs the unsharded step, kitti25-rot, B=2, "
          f"N={N_POINTS}, step {DP_STEP} (lr {lr:.3e}): loss {m_s['loss']:.7f} vs "
          f"{m_p['loss']:.7f} (rel {loss_rel:.2e}), grad norm {m_s['grad_norm']:.6f} vs "
          f"{m_p['grad_norm']:.6f} (rel {norm_rel:.2e}), every gradient within "
          f"{max(rel.values()):.2e} of its max ({len(cancelling)} cancelling sums of |g|), "
          f"parameters after the step max|d| {param_err:.3e}, running statistics max|d| "
          f"{stat_err:.2e}")
    print(f"launches in the sharded step: K1 {counts['k1']}, K2 {counts['k2']}; synced step "
          f"time: sharded {ms['sharded']:.3f} ms, unsharded {ms['unsharded']:.3f} ms (median "
          f"of 3)")
    if (loss_rel > LOSS_RTOL or norm_rel > GRAD_RTOL or max(rel.values()) > GRAD_RTOL
            or stat_err > STAT_ATOL or param_err > SHARDED_PARAM_LR * lr):
        fail("the sharded step on a 1 x 1 mesh and the unsharded step disagree")
    if counts["k1"] != LAUNCHES_PER_CALL or counts["k2"] != LAUNCHES_PER_CALL:
        fail(f"expected {LAUNCHES_PER_CALL} K1 and K2 launches in the sharded step")
    return counts, ref, lr


@contextlib.contextmanager
def deterministic(torch):
    """Within the block, deterministic algorithms (gather's backward without
    atomics; cuBLAS under CUBLAS_WORKSPACE_CONFIG, set in main and inherited
    by the ranks), their warnings silenced: a step run twice is the same
    bit for bit."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def step_peak(torch, fn) -> tuple:
    """(fn(), (MiB allocated above fn's start at its peak, the process's
    peak torch.cuda.max_memory_allocated in MiB)), the peak counters reset
    just before fn."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, ((peak - base) / 2**20, peak / 2**20)


def ring_on_card(torch, dev, reg, pair, mesh) -> None:
    """Phase 22, the op: ring_knn over a point group of one rank on
    kitti25-rot's candidate query of pair 0 against the port's exact knn
    (ring_reference, ring_run, ring_agrees)."""
    want = ring_reference(torch, reg, pair)
    ring_agrees(torch, [ring_run(torch, mesh, dev, want["inputs"])], want, card_line())


def solve_inputs(torch, graph, dev) -> tuple:
    """Phase 22's solves' inputs on dev: phase 20's graph and chained poses
    (numpy), and 64 points of the sequence's scene seen from every frame at
    the true poses with 5 mm noise, started 5 cm off: (graph, R0, t0,
    landmarks0, observations)."""
    import numpy as np

    from deepvcp_tpu_torch.odometry import LandmarkObs, PoseGraph, chain_poses

    g_np, R0, t0 = graph
    g = PoseGraph(*(torch.from_numpy(a).to(dev) for a in g_np))
    scans, R_rel, t_rel = odometry_sequence()
    R_abs, t_abs = chain_poses(torch.from_numpy(R_rel), torch.from_numpy(t_rel))
    rng = np.random.default_rng(ODO_SEED)
    lms = torch.from_numpy(scans[0][rng.choice(N_POINTS, 64, replace=False)])
    F, L = R_abs.shape[0], lms.shape[0]
    frame, lm = torch.arange(F).repeat_interleave(L), torch.arange(L).repeat(F)
    xyz = torch.einsum("oba,ob->oa", R_abs[frame], lms[lm] - t_abs[frame])
    xyz = xyz + torch.from_numpy(rng.normal(0, 0.005, xyz.shape).astype(np.float32))
    obs = LandmarkObs(frame.to(dev), lm.to(dev), xyz.to(dev), torch.ones(F * L, device=dev))
    lm0 = lms + torch.from_numpy(rng.normal(0, 0.05, lms.shape).astype(np.float32))
    return g, torch.from_numpy(R0).to(dev), torch.from_numpy(t0).to(dev), lm0.to(dev), obs


def solves(torch, inputs, mesh) -> dict:
    """The pose graph (ODO_GN_ITERS iterations) and the landmark BA with the
    graph (6 iterations), sharded over `mesh` or not (None); on the CPU."""
    from deepvcp_tpu_torch.odometry import (
        optimize_landmark_ba, optimize_pose_graph, optimize_pose_graph_sharded)

    g, R0, t0, lm0, obs = inputs
    if mesh is None:
        graph = optimize_pose_graph(g, R0, t0, num_iters=ODO_GN_ITERS)
    else:
        graph = optimize_pose_graph_sharded(g, R0, t0, mesh, num_iters=ODO_GN_ITERS)
    ba = optimize_landmark_ba(g, R0, t0, lm0, obs, mesh=mesh, num_iters=6)
    return {"graph": tuple(a.cpu() for a in graph), "ba": tuple(a.cpu() for a in ba)}


def solves_agree(torch, got: dict, want: dict, what: str) -> None:
    """Fail unless the sharded solves are within SHARD_GRAPH_DEG /
    SHARD_GRAPH_ATOL (pose graph) and SHARD_BA_DEG / SHARD_BA_ATOL (BA) of
    the unsharded ones."""
    from deepvcp_tpu_torch.data import rotation_geodesic_deg

    g_deg = rotation_geodesic_deg(got["graph"][0], want["graph"][0]).max().item()
    g_err = (got["graph"][1] - want["graph"][1]).abs().max().item()
    ba_deg = rotation_geodesic_deg(got["ba"][0], want["ba"][0]).max().item()
    ba_err = max((a - b).abs().max().item() for a, b in zip(got["ba"][1:], want["ba"][1:]))
    print(f"{what} vs the unsharded solves: pose graph {g_deg:.2e} deg, max|dt| {g_err:.2e}; "
          f"landmark BA {ba_deg:.2e} deg, max|d| {ba_err:.2e}")
    if not (g_deg < SHARD_GRAPH_DEG and g_err <= SHARD_GRAPH_ATOL and ba_deg < SHARD_BA_DEG
            and ba_err <= SHARD_BA_ATOL):
        fail(f"{what} differ from the unsharded solves")


def gloo_on_card(torch, dist, dev) -> None:
    """In each of two gloo ranks on `dev`: all_reduce and broadcast of CUDA
    tensors (the collectives of the data-parallel step, BatchNorm, the loss
    and the sharded solves) and all_gather (ring_knn's, of its index
    shards; the point split's, of f32 and bf16 rows) give the values they
    must; raises otherwise, which fails the rank and the phase."""
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    y = torch.full((4,), float(rank + 1), device=dev)
    dist.broadcast(y, 0)
    parts = [torch.empty(4, device=dev) for _ in range(world)]
    dist.all_gather(parts, torch.full((4,), float(rank), device=dev))
    # bf16, bit for bit: the point split gathers bf16 features as they are
    def bf16_of(r):
        return (torch.tensor([1.0, 3.0039, -7.1e-3, 2.0 ** -130], device=dev)
                * (r + 1)).to(torch.bfloat16)

    halves = [torch.empty(4, dtype=torch.bfloat16, device=dev) for _ in range(world)]
    dist.all_gather(halves, bf16_of(rank))
    want = world * (world + 1) / 2
    bf16_right = all(torch.equal(h.view(torch.int16), bf16_of(r).view(torch.int16))
                     for r, h in enumerate(halves))
    if not (bool((x == want).all()) and bool((y == 1.0).all()) and all(
            bool((p == r).all()) for r, p in enumerate(parts)) and bf16_right):
        raise RuntimeError(f"gloo collectives on CUDA tensors gave all_reduce {x.tolist()}, "
                           f"broadcast {y.tolist()}, all_gather {[p.tolist() for p in parts]}, "
                           f"bf16 all_gather {[h.tolist() for h in halves]}")
    print(f"rank {rank}: gloo all_reduce, broadcast and all_gather (f32, bf16 bit for bit) on "
          f"{dev} tensors: right", flush=True)


def partitioned_step(torch, dist, trainer, tcfg, saved, batch, mesh, what: str) -> dict:
    """In one of phase 22's two gloo ranks: the whole B = 2 batch through
    make_train_step(mesh=...) on the 1 x 2 `mesh`, the point group's
    per-point work split over the two ranks (K1 / K2 launches counted, the
    step's peak memory, whether the model's gate passed); then its synced
    time, median of 3."""
    from deepvcp_tpu_torch.parallel import shard_batch
    from deepvcp_tpu_torch.train import make_train_step
    from deepvcp_tpu_torch.train.optim import learning_rate_schedule

    step = make_train_step(trainer.model, learning_rate_schedule(tcfg), tcfg, mesh=mesh)
    args = shard_batch(mesh, batch)
    split = trainer.model.partitions(mesh, args[0].shape[1], args[1].shape[1])
    (result, peak), counts = counted_all(torch, lambda: step_peak(
        torch, lambda: step_result(torch, trainer, step, saved, args)))
    ms = host_median_ms(torch, lambda: step_result(torch, trainer, step, saved, args), reps=3)
    print(f"rank {dist.get_rank()}: {what} point-partitioned step on a 1 x 2 mesh "
          f"(B={args[0].shape[0]}, N={args[0].shape[1]}, gate passed: {split}): K1 "
          f"{counts['k1']}, K2 {counts['k2']} launches, peak {peak[0]:.1f} MiB above the "
          f"step's start ({peak[1]:.1f} MiB in all), {ms:.3f} ms a step", flush=True)
    return {**result, "counts": counts, "split": split, "peak": peak, "ms": ms}


def two_rank_body(graph) -> dict:
    """One of phase 22's two gloo ranks on cuda:0 (run by
    parallel.launch.run_ranks): first gloo_on_card's check of the
    collectives on CUDA tensors, then a 2 x 1 mesh; this rank's B = 1 of
    dp_setup's batch through make_train_step(mesh=...) (its K1 / K2
    launches counted and printed), the sharded solves, and the point-
    partitioned step on a 1 x 2 mesh (partitioned_step), on the exact slab
    in f32 and under each of ENGINE_SPLITS."""
    import torch
    import torch.distributed as dist

    from deepvcp_tpu_torch.parallel import make_mesh, shard_batch
    from deepvcp_tpu_torch.train import make_train_step
    from deepvcp_tpu_torch.train.optim import learning_rate_schedule

    dev = torch.device("cuda", 0)
    gloo_on_card(torch, dist, dev)
    mesh = make_mesh(device=dev)
    trainer, tcfg, saved, batch = dp_setup(torch, dev)
    step = make_train_step(trainer.model, learning_rate_schedule(tcfg), tcfg, mesh=mesh)
    local = shard_batch(mesh, batch)
    (result, peak), counts = counted_all(torch, lambda: step_peak(
        torch, lambda: step_result(torch, trainer, step, saved, local)))
    print(f"rank {dist.get_rank()}: K1 {counts['k1']}, K2 {counts['k2']} launches in its step "
          f"(B={local[0].shape[0]}), peak {peak[0]:.1f} MiB above the step's start", flush=True)
    point_mesh = make_mesh(1, 2, device=dev)
    out = {**result, "counts": counts, "peak": peak,
           **solves(torch, solve_inputs(torch, graph, dev), mesh),
           "partitioned": partitioned_step(torch, dist, trainer, tcfg, saved, batch,
                                           point_mesh, "kitti25-rot exact slab")}
    del trainer
    return {**out, "splits": engine_splits(torch, dist, dev, point_mesh)}


def engine_splits(torch, dist, dev, mesh) -> dict:
    """In one of phase 22's two gloo ranks: partitioned_step on the 1 x 2
    `mesh` under each of ENGINE_SPLITS, under deterministic algorithms as
    engine_refs' steps: {name: its result}."""
    splits = {}
    for name, (ckpt, *_) in ENGINE_SPLITS.items():
        with deterministic(torch):
            splits[name] = partitioned_step(torch, dist, *dp_setup(torch, dev, name), mesh,
                                            f"{ckpt} {name}")
        torch.cuda.empty_cache()
    return splits


def engine_refs(torch, dev) -> dict:
    """Phase 22's single-process B = 2 steps of ENGINE_SPLITS, each from its
    saved state at DP_STEP (step_result) under deterministic algorithms (so
    that a run's deviations repeat in the next), with its step_peak under
    "peak", its synced time under "ms" (median of 3), its lr and the bounds
    its split is held to: DP_BOUNDS in f32; in bf16, BF16_SPREAD_X times
    the step's own deviation (the larger of two) when the source cloud's
    coordinates are nudged up by one f32 ulp or the target's down, no less
    than DP_BOUNDS. {name: result}."""
    from deepvcp_tpu_torch.train import make_train_step
    from deepvcp_tpu_torch.train.optim import learning_rate_schedule

    refs = {}
    for name, (ckpt, changes, _) in ENGINE_SPLITS.items():
        trainer, tcfg, saved, batch = dp_setup(torch, dev, name)
        plain = make_train_step(trainer.model, learning_rate_schedule(tcfg), tcfg)
        with deterministic(torch):
            ref, peak = step_peak(torch, lambda: step_result(torch, trainer, plain, saved, batch))
            ms = host_median_ms(torch, lambda: step_result(torch, trainer, plain, saved, batch),
                                reps=3)
            nudges = []
            if changes.get("compute_dtype") == "bfloat16":
                src, tgt, R, t = batch
                nudges = [step_deviation(step_result(torch, trainer, plain, saved, nudged), ref)
                          for nudged in ((src * (1 + F32_ULP), tgt, R, t),
                                         (src, tgt * (1 - F32_ULP), R, t))]
        bounds = DP_BOUNDS
        if nudges:
            spread = [max(d) for d in zip(*nudges)]
            bounds = (max(DP_LOSS_RTOL, BF16_SPREAD_X * spread[0]),
                      max(DP_GRAD_RTOL, BF16_SPREAD_X * spread[1]), DP_RRE_ATOL,
                      max(DP_STAT_RTOL, BF16_SPREAD_X * spread[4]))
            print(f"single-process {ckpt} {name} step nudged by one f32 ulp of a cloud's "
                  f"coordinates: loss rel {spread[0]:.2e}, grad norm rel {spread[1]:.2e}, RRE "
                  f"{spread[2]:.2e} deg, parameters {spread[3]:.3e}, statistics {spread[4]:.2e} "
                  f"of their max; its split held to loss rel {bounds[0]:.2e}, grad norm rel "
                  f"{bounds[1]:.2e}, statistics {bounds[3]:.2e}")
        refs[name] = {**ref, "peak": peak, "ms": ms, "bounds": bounds,
                      "lr": learning_rate_schedule(tcfg)(DP_STEP)}
        print(f"single-process {ckpt} {name} step, B=2, N={batch[0].shape[1]}: peak "
              f"{peak[0]:.1f} MiB above the step's start ({peak[1]:.1f} in all), {ms:.3f} ms "
              f"a step")
        del trainer, plain
        torch.cuda.empty_cache()
    return refs


def step_deviation(got: dict, ref: dict) -> tuple:
    """How far step `got` is from `ref`: (loss, grad norm, each relative to
    its own size; RRE in degrees; the parameters' max|d|; the running
    statistics' max|d| over each tensor's max)."""
    m, m_p = got["metrics"], ref["metrics"]
    return (abs(m["loss"] - m_p["loss"]) / abs(m_p["loss"]),
            abs(m["grad_norm"] - m_p["grad_norm"]) / m_p["grad_norm"],
            abs(m["rre_deg"] - m_p["rre_deg"]),
            max((got["params"][n] - p).abs().max().item() for n, p in ref["params"].items()),
            max((got["stats"][n] - s).abs().max().item() / s.abs().max().item()
                for n, s in ref["stats"].items()))


def dp_step_agrees(torch, got: dict, ref: dict, lr: float, what: str,
                   launches: int = LAUNCHES_PER_CALL, bounds=DP_BOUNDS) -> None:
    """Fail unless a rank's step `got` is the single-process step `ref` at
    the same global batch (B = 2 in phase 22) within `bounds` (loss, grad
    norm, of their own size; RRE in degrees; running statistics, of each
    tensor's max: DP_BOUNDS, the data-parallel bounds, unless given), the
    parameters within SHARDED_PARAM_LR x lr, and launched `launches` K1 and
    K2; print it, with its peak memory beside `ref`'s."""
    loss_tol, norm_tol, rre_tol, stat_tol = bounds
    m, m_p = got["metrics"], ref["metrics"]
    loss_rel, norm_rel, rre_err, param_err, stat_rel = step_deviation(got, ref)
    print(f"{what} vs the single-process step: loss {m['loss']:.7f} vs {m_p['loss']:.7f} "
          f"(rel {loss_rel:.2e}), grad norm rel {norm_rel:.2e}, RRE {m['rre_deg']:.4f} vs "
          f"{m_p['rre_deg']:.4f} deg, parameters max|d| {param_err:.3e} ({param_err / lr:.3f} "
          f"lr), running statistics within {stat_rel:.2e} of their max; peak {got['peak'][0]:.1f} "
          f"MiB above the step's start ({got['peak'][1]:.1f} in all) against the single-process "
          f"step's {ref['peak'][0]:.1f} ({got['peak'][0] / ref['peak'][0]:.3f}x)")
    if (loss_rel > loss_tol or norm_rel > norm_tol or rre_err > rre_tol
            or param_err > SHARDED_PARAM_LR * lr or stat_rel > stat_tol):
        fail(f"{what} disagrees with the single-process step")
    if got["counts"]["k1"] != launches or got["counts"]["k2"] != launches:
        fail(f"{what}: expected {launches} K1 and K2 launches in its step")


def ranks_equal(torch, ranks: list, names, what: str) -> None:
    """Fail unless every rank reports rank 0's metrics and parameters."""
    if any(got["metrics"] != ranks[0]["metrics"] or any(
            not torch.equal(got["params"][n], ranks[0]["params"][n]) for n in names)
           for got in ranks[1:]):
        fail(f"the ranks took different {what} steps")


def partitioned_agree(torch, what: str, part: list, ref: dict, launches: int,
                      card: str) -> None:
    """Fail unless both ranks' point-partitioned steps `part` passed the
    gate, each is the single-process step `ref` within its "bounds" (its
    "lr" and "ms" beside it) with `launches` K1 and K2 (dp_step_agrees),
    and the ranks are equal."""
    for r, got in enumerate(part):
        if not got["split"]:
            fail(f"rank {r}: the point partition's gate refused the 1 x 2 {what} step")
        dp_step_agrees(torch, got, ref, ref["lr"],
                       f"rank {r} of 2 (gloo, cuda:0, 1 x 2 point-partitioned, {what}, B=2, "
                       f"{got['ms']:.3f} ms a step against the single process's "
                       f"{ref['ms']:.3f}; {card})", launches, ref["bounds"])
    ranks_equal(torch, part, ref["params"], f"point-partitioned {what}")


def two_ranks_on_card(torch, ref: dict, lr: float, graph, solved: dict, refs: dict) -> dict:
    """Phase 22, part 2: two gloo ranks sharing cuda:0 (gloo takes CUDA
    tensors for all_reduce, broadcast and all_gather, the only collectives
    of these paths). Against the single-process B = 2 step `ref`
    (dp_step_agrees), the ranks equal: the data-parallel step on a 2 x 1
    mesh, each rank B = 1 of the B = 2 batch; and the point-partitioned
    step on a 1 x 2 mesh, both ranks the whole batch, each its half of the
    per-point work (the model's gate must pass), with each rank's peak
    memory beside the single-process step's and its synced time (printed);
    the same for each of ENGINE_SPLITS against its own single-process step
    in `refs` (engine_refs), with its launches and bounds. The sharded
    solves against the unsharded `solved`. A rank that fails or outlasts
    TWO_RANK_TIMEOUT_S fails the phase. Returns the two ranks' launches."""
    from deepvcp_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    # "cuda:0" binds both ranks to card 0 on a host with more cards too
    ranks = run_ranks("chip_smoke:two_rank_body", 2, kwargs={"graph": graph}, device="cuda:0",
                      backend="gloo", timeout_s=TWO_RANK_TIMEOUT_S, echo=True)
    card = card_line()
    print(f"card: {card}")
    for r, got in enumerate(ranks):
        dp_step_agrees(torch, got, ref, lr, f"rank {r} of 2 (gloo, cuda:0, 2 x 1, B=1 each)")
        solves_agree(torch, got, solved, f"rank {r}'s sharded solves over 2 ranks")
    ranks_equal(torch, ranks, ref["params"], "data-parallel")
    partitioned_agree(torch, "kitti25-rot exact slab", [got["partitioned"] for got in ranks],
                      {**ref, "lr": lr, "bounds": DP_BOUNDS}, LAUNCHES_PER_CALL, card)
    for name, (ckpt, _, launches) in ENGINE_SPLITS.items():
        partitioned_agree(torch, f"{ckpt} {name}", [got["splits"][name] for got in ranks],
                          refs[name], launches, card)
    print(f"two gloo ranks on cuda:0: {time.perf_counter() - t0:.1f} s, process starts included "
          f"(two processes share one card: their step times say nothing of two cards)")
    return {k: sum(got["counts"][k] + got["partitioned"]["counts"][k]
                   + sum(s["counts"][k] for s in got["splits"].values()) for got in ranks)
            for k in ("k1", "k2", "k6", "k6b")}


def tooling_on_card(torch, dev, reg, pair) -> dict:
    """Phase 22, the tooling: one epoch of TOOLING_STEPS Trainer steps of
    kitti25-rot under the process group of one rank with heartbeat_interval
    0.5 (heartbeat file written, the epoch's watchdog scan passed, rank 0's
    checkpoints written; LAUNCHES_PER_CALL K1 and K2 a step), `plot
    --summary` on the epoch's metrics file, and profile_stages on
    kitti25-rot at N = 10 000 beside the registrar's device busy time (a
    stage whose device holds all ran out is named). Returns the steps'
    launches."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    import numpy as np

    from deepvcp_tpu_torch import convert, plot, pretrained
    from deepvcp_tpu_torch.data import LidarLikeDataset, batch_iterator
    from deepvcp_tpu_torch.profile_stages import profile_stages, report
    from deepvcp_tpu_torch.train import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        tcfg = dataclasses.replace(kitti25_recipe(), num_epochs=1, heartbeat_interval=0.5,
                                   checkpoint_dir=os.path.join(tmp, "ck"),
                                   metrics_path=os.path.join(tmp, "metrics.jsonl"))
        trainer = Trainer(pretrained.config("kitti25-rot", N_POINTS), tcfg, device=dev)
        trainer.setup()
        trainer.model.load_state_dict(
            convert.flax_to_torch(pretrained.load_variables("kitti25-rot")), strict=True)
        data = LidarLikeDataset(num_clouds=TOOLING_STEPS, num_points=N_POINTS, max_range=25.0,
                                seed=10)
        batches = list(batch_iterator(data, 1, epoch=0, seed=0))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _, counts = counted_all(torch, lambda: trainer.fit(lambda epoch: iter(batches)))
        hb = os.path.join(tcfg.checkpoint_dir, "heartbeats", "heartbeat_0.json")
        beat = json.load(open(hb)) if os.path.exists(hb) else None
        wrote = sorted(f for f in os.listdir(tcfg.checkpoint_dir) if f != "heartbeats")
        print(f"Trainer.fit under the process group, {TOOLING_STEPS} steps, heartbeat 0.5 s: "
              f"last beat {beat}, the epoch's watchdog scan passed, rank 0 wrote {wrote}; "
              f"launches K1 {counts['k1']}, K2 {counts['k2']}")
        if beat is None or beat["process_id"] != 0 or "latest.json" not in wrote:
            fail("Trainer.fit with a heartbeat wrote no heartbeat or no checkpoint")
        if counts["k1"] != LAUNCHES_PER_CALL * TOOLING_STEPS or \
                counts["k2"] != LAUNCHES_PER_CALL * TOOLING_STEPS:
            fail(f"expected {LAUNCHES_PER_CALL} K1 and K2 launches per Trainer step")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            plot.main([tcfg.metrics_path, "--summary"])
        summary = [json.loads(line) for line in out.getvalue().splitlines()]
        print(f"plot --summary: {summary}")
        if [r["kind"] for r in summary] != ["epoch"] or not np.isfinite(summary[0]["loss"]):
            fail(f"plot --summary printed {summary}")

    result = profile_stages(reg.model, 1, dev, reps=10)
    print(f"profile_stages, kitti25-rot, N={N_POINTS}, B=1 (CUDA events behind a device hold):")
    print(report(result))
    host = [n for n, r in result["roofline"].items() if r["bound"] == "host"]
    print(f"profile_stages: stages timed by the host (every hold ran out): {host or 'none'}")
    src, tgt = pair[0], pair[1]
    busy, _ = device_time_per_call(torch, lambda: reg(src, tgt), calls=3)
    print(f"profile_stages sum {sum(result['stages_ms'].values()):.3f} ms (each stage once; the "
          f"flat and the two-level grouping both) | kitti25-rot registrar call, refine_iters "
          f"{reg.refine_iters}: device busy {busy:.3f} ms")
    return counts


def multi_device_phase(torch, dev, reg, pairs, odo) -> dict:
    """Phase 22: the multi-device modules on one card. Part 1, a process
    group of one NCCL rank and its 1 x 1 ("data", "point") mesh: the
    sharded train step, ring_knn, the sharded pose graph and BA, and the
    tooling. Part 2, two gloo ranks sharing cuda:0: the data-parallel step
    and the sharded solves across ranks (NCCL takes one rank a card; ring_knn
    over more than one point rank needs point-to-point sends, which gloo
    does not take on CUDA tensors: phase 25 runs it over NCCL).
    Returns the K1 / K2 launches of its gated steps."""
    import torch.distributed as dist

    from deepvcp_tpu_torch.parallel import initialize_multihost, make_mesh
    from deepvcp_tpu_torch.parallel.launch import free_port

    t0 = time.perf_counter()
    g_cpu, R_ch, t_ch = odo["graph"]
    graph = (tuple(a.numpy() for a in g_cpu), R_ch.numpy(), t_ch.numpy())
    initialize_multihost(f"localhost:{free_port()}", 1, 0, device=dev, timeout_s=120)
    try:
        print(f"process group: backend {dist.get_backend()}, world {dist.get_world_size()}")
        mesh = make_mesh(1, 1, device=dev)
        step, ref, lr = sharded_step_agrees(torch, dev, mesh)
        ring_on_card(torch, dev, reg, pairs[0], mesh)
        inputs = solve_inputs(torch, graph, dev)
        solved = solves(torch, inputs, None)
        solves_agree(torch, solves(torch, inputs, mesh), solved,
                     f"sharded solves on a 1 x 1 mesh ({inputs[0].edges_i.numel()} edges, "
                     f"{inputs[4].frame.numel()} landmark observations)")
        tools = tooling_on_card(torch, dev, reg, pairs[0])
    finally:
        dist.destroy_process_group()
    two = two_ranks_on_card(torch, ref, lr, graph, solved, engine_refs(torch, dev))
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")
    return {k: step[k] + tools[k] + two[k] for k in ("k1", "k2", "k6", "k6b")}


def k3_vs_native(torch, dev) -> None:
    """Phase 23: K3 on cloud 0 of each of phase 12's clouds against the
    native FPS on the host: indices identical (both compute ((dx*dx) +
    (dy*dy)) + (dz*dz) rounded step by step, and a tie goes to the lowest
    index). Launches made here only compare and are not counted."""
    from deepvcp_tpu_torch import native
    from deepvcp_tpu_torch.ops.kernels.fps import farthest_point_sample

    for name, xyz, k in fps_cases():
        cloud = xyz[0].astype("float32")
        x = torch.from_numpy(cloud)[None].to(dev)
        got = farthest_point_sample(x, k)[0].cpu().numpy()
        t0 = time.perf_counter()
        want = native.farthest_point_sample(cloud, k)
        host_ms = (time.perf_counter() - t0) * 1e3
        card_ms = cuda_median_ms(torch, lambda: farthest_point_sample(x, k), reps=5, warmup=1)
        same = bool((got == want).all())
        print(f"K3 vs the native FPS, cloud 0 of {name}: indices "
              f"{'identical' if same else 'DIFFER'} | card {card_ms:.4f} ms, host oracle "
              f"{host_ms:.3f} ms")
        if not same:
            fail(f"K3 disagrees with the native FPS on cloud 0 of {name}, first at pick "
                 f"{int((got != want).nonzero()[0][0])}")


def expansion_bound(q64, r64, d2_kth):
    """Per query row, how far two of its squared distances can move apart
    between the matmul expansion (ops/distance.py: |q|^2 + |r|^2 - 2 q.r
    in f32, each dot of 3 terms) and the exact value, plus the elementwise
    f32 oracle's own error: each expansion term carries gamma_3 of its
    size, the two sums u each, so |err| <= gamma_6 (|q| + |r|)^2 for any r
    (|r| <= the cloud's largest norm); the oracle's three rounded squares
    and two sums give gamma_5 d^2. Two distances cross only where their
    gap is at most twice the sum."""
    import numpy as np

    u = 2.0 ** -24

    def gamma(n):
        return n * u / (1 - n * u)

    r_max = np.linalg.norm(r64, axis=-1).max()
    return 2 * (gamma(6) * (np.linalg.norm(q64, axis=-1) + r_max) ** 2 + gamma(5) * d2_kth)


def flat_knn_vs_native(torch, dev, reg, pair) -> None:
    """Phase 23: the flat candidate KNN (ops/knn.py::approx_knn in f32, the
    kitti25-rot path's own call and chunk, TF32 off) on pair 0's K * C
    candidates of the identity-init refinement against the native knn: the
    same neighbour set on every row but those whose oracle k-th and
    (k+1)-th squared distances lie within expansion_bound (counted)."""
    import numpy as np

    from deepvcp_tpu_torch import native
    from deepvcp_tpu_torch.ops.knn import approx_knn

    cfg, sel = reg.model.cfg, reg.model.select_args(chunked=True)
    if sel["select_dtype"] is not None:
        fail("kitti25-rot's candidate KNN does not select in f32")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the card's distances would not be f32")
    src, tgt = pair[0], pair[1]
    with torch.no_grad():
        enc = reg.model.encode(src, tgt)
        _, cand = reg.model.candidates(enc, torch.eye(3, device=dev)[None],
                                       torch.zeros(1, 3, device=dev))
    ref, query, k = enc.tgt_xyz, cand.reshape(1, -1, 3), cfg.num_neighbors

    def run():
        return approx_knn(ref, query, k, **sel)

    idx = run()[1][0].cpu().numpy()
    card_ms = cuda_median_ms(torch, run, reps=10)
    ref_np, q_np = ref[0].cpu().numpy(), query[0].cpu().numpy()
    t0 = time.perf_counter()
    _, want = native.knn(ref_np, q_np, k + 1)
    host_ms = (time.perf_counter() - t0) * 1e3
    r64, q64 = ref_np.astype(np.float64), q_np.astype(np.float64)
    d2 = [((r64[want[:, j]] - q64) ** 2).sum(-1) for j in (k - 1, k)]
    bound = expansion_bound(q64, r64, d2[1])
    near = d2[1] - d2[0] <= bound
    differ = (np.sort(idx, -1) != np.sort(want[:, :k], -1)).any(-1)
    print(f"flat candidate KNN vs the native knn, {q_np.shape[0]} candidates x "
          f"{ref_np.shape[0]} points, k = {k}: rows differing {int(differ.sum())}, near-ties "
          f"exempt {int(near.sum())} (their k-th and (k+1)-th squared distances within the "
          f"expansion's bound, {float(bound.min()):.3e}-{float(bound.max()):.3e} m^2 at "
          f"coordinates up to {float(np.abs(q64).max()):.1f} m), differing outside them "
          f"{int((differ & ~near).sum())} | card {card_ms:.3f} ms (CUDA events), host oracle "
          f"{host_ms:.1f} ms (one thread)")
    if (differ & ~near).any():
        fail("the flat candidate KNN's neighbour sets differ from the native knn's away from "
             "near-ties")


def cpu_flag(dev) -> list:
    """The examples' --cpu where dev is the CPU (a rehearsal of the phase)."""
    return ["--cpu"] if dev.type == "cpu" else []


def register_pair_on_card(torch, dev, total: dict) -> None:
    """Phase 23: the register_pair example in its three modes at N =
    EXAMPLE_POINTS (the example's default) on
    the card: finite poses, K3 launched in --full-so3 (one so3_global_init:
    2), K1 in every mode; RRE / RTE printed by the example."""
    from deepvcp_tpu_torch.examples import register_pair

    for flags in ([], ["--full-so3"], ["--kitti"]):
        what = "register_pair " + (" ".join(flags) or "(modelnet-fine)")
        print(f"{what}:")
        res, counts = counted_all(torch, lambda: register_pair.main(
            ["--num-points", str(EXAMPLE_POINTS), *flags, *cpu_flag(dev)]))
        add_counts(total, counts)
        out = res["out"]
        finite = bool(torch.isfinite(out.R).all() and torch.isfinite(out.t).all())
        print(f"  mean RRE {res['rre'].mean():.4f} deg, mean RTE {res['rte'].mean():.5f}; "
              f"launches K1 {counts['k1']}, K3 {counts['k3']}")
        if not finite or counts["k1"] == 0:
            fail(f"{what}: pose not finite or no K1 launch")
        if ("--full-so3" in flags) != (counts["k3"] == 2):
            fail(f"{what}: {counts['k3']} K3 launches (2 with --full-so3, else 0)")


def train_synthetic_on_card(torch, dev, total: dict) -> None:
    """Phase 23: the train_synthetic example, --tiny --steps 3, on the card:
    finite summary, a metrics line a step, 6 K1 + 6 K2 a step."""
    import math
    import tempfile

    from deepvcp_tpu_torch.examples import train_synthetic

    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "synthetic_metrics.jsonl")
        summary, counts = counted_all(torch, lambda: train_synthetic.main(
            ["--tiny", "--steps", "3", "--metrics", metrics, *cpu_flag(dev)]))
        with open(metrics) as fh:
            lines = fh.read().splitlines()
    add_counts(total, counts)
    print(f"train_synthetic --tiny --steps 3: {len(lines)} metrics lines; launches K1 "
          f"{counts['k1']}, K2 {counts['k2']}")
    values = [v for end in ("first", "last") for v in summary[end].values()]
    if len(lines) != 3 or not all(math.isfinite(v) for v in values) or \
            (counts["k1"], counts["k2"]) != (18, 18):
        fail("train_synthetic: want 3 finite steps, 18 K1 and 18 K2 launches")


def trained_checkpoint_on_card(torch, dev, total: dict) -> None:
    """Phase 23: campaign_r4-fine at N = 1024 on tests/test_trained_
    checkpoint.py's held sample (identity init, guard, refine_iters 2, one
    B = 2 call): RRE <= 5 deg and RTE <= 0.15 per pair, the best-so-far
    score non-increasing and below the identity's; the card's pose within
    CARD_CPU_POSE of the CPU's, the CPU's candidate selections pinned to the
    card's after the near-tie check (pinned_pose: the bf16 tile)."""
    import numpy as np

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator, rotation_geodesic_deg

    n = 1024

    def registrar(device):
        return pretrained.campaign_registrar(
            "campaign_r4-fine", device=device, cfg_changes={"num_points": n},
            use_saliency_weights=True, refine_iters=2)

    ds = SyntheticDataset(num_clouds=2, num_points=n, extent=1.0, seed=100,
                          max_rotation_deg=10.0, max_translation=0.5)
    src, tgt, R, t = (torch.from_numpy(a).to(dev)
                      for a in next(batch_iterator(ds, 2, epoch=0, seed=0)))
    reg = registrar(dev)
    out, counts = counted_all(torch, lambda: reg(src, tgt))
    add_counts(total, counts)
    rre = rotation_geodesic_deg(out.R, R).cpu().numpy()
    rte = torch.linalg.norm(out.t - t, dim=-1).cpu().numpy()
    sc = out.scores.cpu().numpy()
    best = np.minimum.accumulate(sc, axis=1)
    print(f"campaign_r4-fine, N = {n}, GT-free: RRE {rre} deg, RTE {rte}, guard scores "
          f"{sc.tolist()}; K1 {counts['k1']}")
    if rre.max() > 5.0 or rte.max() > 0.15:
        fail("campaign_r4-fine: RRE > 5 deg or RTE > 0.15")
    if not ((np.diff(best, axis=1) <= 1e-7).all() and (best[:, -1] < sc[:, 0] - 1e-4).all()):
        fail("campaign_r4-fine: the guard's best score rose, or did not beat the identity's")
    out_d, out_c = pinned_pose(torch, reg, registrar("cpu"), src, tgt, "campaign_r4-fine")
    dR = (out_d.R.cpu() - out_c.R).abs().max().item()
    dt = (out_d.t.cpu() - out_c.t).abs().max().item()
    print(f"campaign_r4-fine card vs CPU: max|dR| {dR:.3e}, max|dt| {dt:.3e}")
    if dR > CARD_CPU_POSE or dt > CARD_CPU_POSE:
        fail("campaign_r4-fine: the pose differs between the card and the CPU")


def convergence_on_card(torch, dev, total: dict) -> None:
    """Phase 23: tests/test_convergence.py::test_overfit_recovers_pose_gt_free's
    recipe on the card (tiny, N = 64, B = 2, vcp_loss_weight 1, cosine over
    CONVERGENCE_STEPS steps) and its assertions on the eval-mode
    identity-init solve: RTE below a quarter of its start and below 0.1,
    RRE below 2 deg; 6 K1 + 6 K2 a step."""
    import math

    from deepvcp_tpu_torch.config import DeepVCPConfig, TrainConfig
    from deepvcp_tpu_torch.data import (
        SyntheticDataset, batch_iterator, rotation_geodesic_deg, translation_error)
    from deepvcp_tpu_torch.loss import svd_refine
    from deepvcp_tpu_torch.train import Trainer

    steps = CONVERGENCE_STEPS
    trainer = Trainer(DeepVCPConfig.tiny(num_points=64, use_normal=False), TrainConfig(
        num_epochs=1, batch_size=2, learning_rate=3e-3, metrics_path=None, log_every=10000,
        vcp_loss_weight=1.0, lr_schedule="cosine", total_steps=steps,
        use_saliency_weights=True), dev)
    trainer.setup()
    ds = SyntheticDataset(num_clouds=2, num_points=64, extent=2.0, max_rotation_deg=5.0,
                          max_translation=0.4)
    src, tgt, R_gt, t_gt = (torch.from_numpy(a).to(dev)
                            for a in next(batch_iterator(ds, 2, epoch=0, seed=0)))

    def gt_free():
        model = trainer.model.eval()
        with torch.no_grad():
            kp, vcp, _ = model(src, tgt, torch.eye(3, device=dev).expand(2, 3, 3),
                               torch.zeros_like(t_gt))
            ref = svd_refine(kp, vcp)
        model.train()
        return (torch.mean(rotation_geodesic_deg(ref.R, R_gt)).item(),
                torch.mean(translation_error(ref.t, t_gt)).item())

    def run():
        rre0, rte0 = gt_free()
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.state, m = trainer._train_step(trainer.state, src, tgt, R_gt, t_gt)
        loss = m["loss"].item()
        return rre0, rte0, time.perf_counter() - t0, loss, *gt_free()

    (rre0, rte0, seconds, loss, rre1, rte1), counts = counted_all(torch, run)
    add_counts(total, counts)
    print(f"convergence ({steps} steps, tiny, N = 64, B = 2): GT-free RRE {rre0:.4f} -> "
          f"{rre1:.4f} deg, RTE {rte0:.5f} -> {rte1:.5f}, last loss {loss:.5f}; "
          f"{seconds:.2f} s ({seconds / steps * 1e3:.2f} ms a step); K1 {counts['k1']}, K2 "
          f"{counts['k2']}")
    if not (math.isfinite(loss) and rte1 < 0.25 * rte0 and rte1 < 0.1 and rre1 < 2.0):
        fail("convergence: the overfit pair's pose was not recovered GT-free")
    if (counts["k1"], counts["k2"]) != (6 * steps + 12, 6 * steps):
        fail(f"convergence: want {6 * steps + 12} K1 and {6 * steps} K2 launches")


def oracle_phase(torch, dev, reg, pairs) -> dict:
    """Phase 23: K3 and the flat candidate KNN against the native host
    oracles, then the examples, the trained checkpoint and the convergence
    run on the card. Returns each kernel's launches in those runs."""
    from deepvcp_tpu_torch import native

    t0 = time.perf_counter()
    if not native.available():
        fail("the native host library did not build or load")
    k3_vs_native(torch, dev)
    flat_knn_vs_native(torch, dev, reg, pairs[0])
    total = {}
    register_pair_on_card(torch, dev, total)
    train_synthetic_on_card(torch, dev, total)
    trained_checkpoint_on_card(torch, dev, total)
    convergence_on_card(torch, dev, total)
    print(f"phase 23 launches: " + ", ".join(f"{k.upper()} {v}" for k, v in total.items())
          + f"; phase 23: {time.perf_counter() - t0:.1f} s")
    return total


def batch_rows_agree(torch, reg, src, tgt, what: str) -> None:
    """Each pair of one B-pair Registrar call against the pair's own B = 1
    call: the same keypoints, then the B = 1 call's candidate selections
    (each call of the model's _knn) replaced by the B-pair call's rows
    after checking that each row that differs is explained by rounding:
    its swapped points lie at a near-tie of the k-th distance
    (selection_near_tie: a B-row product may round differently from a
    single-row one), or the bf16 tile centred on the batch's cloud mean (a
    B-row reduction, whose last bits may differ from the pair's own, and a
    coordinate at a bf16 rounding boundary then rounds the other way)
    gives the batch's row up to such near-ties. Then R, t, vcps and scores
    within BENCH_ATOL."""
    from deepvcp_tpu_torch.models.deepvcp import DeepVCP

    model = reg.model
    picked = []

    def record(ref, query, chunked, parts=1):
        out = DeepVCP._knn(model, ref, query, chunked, parts)
        picked.append((out[1], ref.mean(dim=-2, keepdim=True)))
        return out

    with torch.no_grad():
        kp_b = model.encode(src, tgt).keypoint_idx
    model._knn = record
    try:
        out_b = reg(src, tgt)
    finally:
        del model._knn
    rows = ties = recentred = centres = 0
    worst = 0.0
    for b in range(src.shape[0]):
        with torch.no_grad():
            kp_1 = model.encode(src[b:b + 1], tgt[b:b + 1]).keypoint_idx
        if not torch.equal(torch.sort(kp_1[0]).values, torch.sort(kp_b[b]).values):
            fail(f"{what}: pair {b} picks other keypoints alone than in the batch")
        batch = iter(picked)

        def pin(ref, query, chunked, parts=1):
            nonlocal rows, ties, recentred, centres
            dist, idx = DeepVCP._knn(model, ref, query, chunked, parts)
            want, centre = next(batch)
            want, centre, k = want[b:b + 1], centre[b], idx.shape[-1]
            centres += not torch.equal(centre, ref.mean(dim=-2, keepdim=True)[0])
            differ = (torch.sort(idx, -1).values != torch.sort(want, -1).values).any(-1)
            for _, m in differ.nonzero().tolist():
                rows += 1
                swapped = sorted(set(idx[0, m].tolist()) ^ set(want[0, m].tolist()))
                if selection_near_tie(model, ref, query, 0, m, k, swapped):
                    ties += 1
                    continue
                redo = torch.topk(selection_d2(model, ref, query, 0, m, centre), k, largest=False)
                left = sorted(set(redo.indices.tolist()) ^ set(want[0, m].tolist()))
                recentred += not left or selection_near_tie(model, ref, query, 0, m, k, left,
                                                            centre)
            return dist, want

        model._knn = pin
        try:
            out_1 = reg(src[b:b + 1], tgt[b:b + 1])
        finally:
            del model._knn
        if next(batch, None) is not None:
            fail(f"{what}: pair {b} made fewer candidate selections alone than in the batch")
        for field in ("R", "t", "vcps", "scores"):
            d = (getattr(out_1, field)[0] - getattr(out_b, field)[b]).abs().max().item()
            worst = max(worst, d)
    print(f"{what}: each pair alone vs in the batch: keypoints identical; {rows} candidate "
          f"selection rows differ: {ties} at a near-tie of the k-th distance, {recentred} "
          f"reproduced by the batch's cloud mean as the tile's centre (the mean's bits differ "
          f"alone and in the batch in {centres} of {len(picked) * src.shape[0]} selections); "
          f"pinned to the batch's rows, max|d| of R, t, vcps, scores {worst:.3e}")
    if ties + recentred != rows:
        fail(f"{what}: candidate selections differ between a pair alone and in the batch "
             f"beyond rounding")
    if worst > BENCH_ATOL:
        fail(f"{what}: a pair's pose alone differs from its pose in the batch by {worst:.3e}")


def k1_exact_on_path(torch, reg, src, tgt, what: str) -> None:
    """Every K1 call of one Registrar call against the plain version on the
    same inputs, bit for bit."""
    from deepvcp_tpu_torch.models import fused_sa
    from deepvcp_tpu_torch.ops.kernels.band_max import banded_masked_max_reference

    seen = []
    kernel = fused_sa.banded_masked_max

    def record(xyz, u, radius):
        out = kernel(xyz, u, radius)
        seen.append((xyz, u, radius, out))
        return out

    fused_sa.banded_masked_max = record
    try:
        reg(src, tgt)
    finally:
        fused_sa.banded_masked_max = kernel
    differ = sum(not torch.equal(out, banded_masked_max_reference(xyz, u, r))
                 for xyz, u, r, out in seen)
    print(f"{what}: K1 against its plain version on the path's {len(seen)} calls "
          f"({', '.join(str(tuple(u.shape)) for _, u, _, _ in seen)}): {differ} differ")
    if differ or not seen:
        fail(f"{what}: K1 is not bit-exact against its plain version on the path")


def bench_cli(dev) -> None:
    """`python -m deepvcp_tpu_torch.bench --iters 3 --warmup 1` from the
    root of the checkout: exit 0 and a last standard-output line of the
    four keys with a finite positive value."""
    import math

    cmd = [sys.executable, "-m", "deepvcp_tpu_torch.bench", "--iters", "3", "--warmup", "1"]
    if dev.type == "cpu":   # a rehearsal of the phase
        cmd += ["--cpu", "--num-points", str(N_POINTS)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    tail = " | ".join(proc.stderr.strip().splitlines()[-3:])
    print(f"bench CLI ({' '.join(cmd[1:])}): exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; {tail}")
    if proc.returncode != 0 or not lines:
        fail(f"the bench CLI failed: {proc.stderr[-2000:]}")
    last = json.loads(lines[-1])
    print(f"bench CLI last line: {lines[-1]}")
    if set(last) != {"metric", "value", "unit", "vs_baseline"} or not (
            math.isfinite(last["value"]) and last["value"] > 0):
        fail(f"the bench CLI's last line is not the four-key result: {lines[-1]}")


def bench_phase(torch, dev, card: str) -> dict:
    """Phase 24: the port's headline bench (deepvcp_tpu_torch.bench.run) at
    N = 10 000 and B = 1, 2, 4, 8 under the default config with a random
    init: K1 and K6 bf16 launches a call, per-call latency and its spread, stream
    pairs/s, profiler busy time and idle share, peak device memory (above
    what earlier phases hold); each
    pair of a call alone vs in the batch (batch_rows_agree), B = 4 through
    the kernels vs the plain versions (K1 bit-exact, pose within 1e-4), and
    the CLI. Returns each kernel's launches in the bench runs."""
    from deepvcp_tpu_torch import bench

    t0 = time.perf_counter()
    total = {}
    for B in BENCH_BATCHES:
        what = f"bench B={B}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res, counts = counted_all(torch, lambda: bench.run(N_POINTS, B, BENCH_ITERS,
                                                           BENCH_WARMUP, dev))
        peak = torch.cuda.max_memory_allocated() - base
        add_counts(total, counts)
        calls = res["calls"]
        reg, src, tgt, out = res["registrar"], res["src"], res["tgt"], res["out"]
        # the default config selects on the bf16 tile: K6's bf16 arm, in
        # encode's source KNN and each candidate stage
        want = {"k1": LAUNCHES_PER_CALL, "k6b": 1 + reg.refine_iters}
        if any(v != want.get(k, 0) * calls for k, v in counts.items()):
            fail(f"{what}: launches {counts} over {calls} calls, want {want} a call and no "
                 f"other kernel")
        shapes = {"R": (B, 3, 3), "t": (B, 3), "keypoints": (B, 64, 3), "vcps": (B, 64, 3),
                  "saliency": (B, N_POINTS), "scores": (B, reg.refine_iters + 1)}
        for field, shape in shapes.items():
            val = getattr(out, field)
            if tuple(val.shape) != shape or not torch.isfinite(val).all():
                fail(f"{what}: {field} has shape {tuple(val.shape)} (want {shape}) or "
                     f"non-finite values")
        lat = res["latency_ms"]
        med = statistics.median(lat)
        busy, _ = device_time_per_call(torch, lambda: reg(src, tgt), calls=5)
        idle = f"{1 - busy / med:.3f}" if busy > 0 else "not measured"
        print(f"{what}, N={N_POINTS}: K1 {counts['k1'] / calls:g}, K6 bf16 "
              f"{counts['k6b'] / calls:g} a call over {calls} calls; "
              f"per-call latency median {med:.3f} ms (min {min(lat):.3f}, max {max(lat):.3f}, "
              f"{len(lat)} calls), stream {res['stream_ms']:.3f} ms a call = {res['value']} "
              f"pairs/s ({res['stream_ms'] / med:.3f}x per call); first call "
              f"{res['first_call_s']:.2f} s; busy {busy:.3f} ms a call (torch.profiler), idle "
              f"share {idle}; peak device memory {peak / 2**20:.1f} MiB above the phase's "
              f"start | {card}")
        batch_rows_agree(torch, reg, src, tgt, what)
        if B == BENCH_PLAIN_B:
            k1_exact_on_path(torch, reg, src, tgt, what)
            registrar_paths_agree(torch, reg, src, tgt, what)
        del res, reg, src, tgt, out
        torch.cuda.empty_cache()
    bench_cli(dev)
    print(f"phase 24 launches: " + ", ".join(f"{k.upper()} {v}" for k, v in total.items())
          + f"; phase 24: {time.perf_counter() - t0:.1f} s")
    return total


def held_pairs(torch, dev) -> list:
    """Phase 4's 16 held-out 25 m lidar-like pairs (seed 110) on dev, one
    (src, tgt, R, t) of B = 1 each."""
    from deepvcp_tpu_torch.data import LidarLikeDataset, batch_iterator

    held = LidarLikeDataset(num_clouds=N_PAIRS, num_points=N_POINTS, max_range=25.0,
                            seed=110, max_rotation_deg=5.0, max_translation=0.5)
    return [tuple(torch.from_numpy(a).to(dev) for a in batch)
            for batch in batch_iterator(held, 1, epoch=0, seed=0, shuffle=False)]


def o1_graph(torch, dev) -> tuple:
    """Phase 20's pose graph without the rest of phase 20 (--multicard):
    O1's relative poses and skip edges (o1_edges) over odometry_sequence()'s
    scans as build_graph's PoseGraph on the CPU, and the chained poses:
    (graph, R_ch, t_ch)."""
    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.odometry import build_graph, chain_poses

    scans, _, _ = odometry_sequence()
    casc = pretrained.cascade("kitti-cascade", device=dev, num_points=N_POINTS)
    R1, t1, extra, _, _ = o1_edges(torch, dev, casc, scans)
    R_ch, t_ch = chain_poses(torch.from_numpy(R1), torch.from_numpy(t1))
    return build_graph(torch.from_numpy(R1), torch.from_numpy(t1), extra_edges=extra), R_ch, t_ch


def rank_placement(torch, dist) -> dict:
    """In a rank of run_ranks(device="cuda"): its card (current device,
    name, PCI bus id) and one all_reduce of ones over the group on it.
    Raises unless rank r is bound to card r (initialize_multihost, by
    LOCAL_RANK) and that card is current, which fails the rank and the
    phase: every rank body of phase 25 starts here."""
    from deepvcp_tpu_torch.parallel.multihost import bound_card

    rank, world = dist.get_rank(), dist.get_world_size()
    cur = torch.cuda.current_device()
    props = torch.cuda.get_device_properties(cur)
    bus = (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:{props.pci_device_id:02x}"
           if hasattr(props, "pci_bus_id") else str(props.uuid))
    ones = torch.ones(1, device=torch.device("cuda", cur))
    dist.all_reduce(ones)
    print(f"rank {rank} of {world}: current device cuda:{cur} ({props.name}, PCI bus id {bus}), "
          f"bound to {bound_card()}, backend {dist.get_backend()}, all_reduce of ones "
          f"{ones.item():g}", flush=True)
    if cur != rank or bound_card() != torch.device("cuda", rank) or ones.item() != world:
        raise RuntimeError(f"rank {rank} is on cuda:{cur} (bound to {bound_card()}), not on its "
                           f"card cuda:{rank}, or its all_reduce gave {ones.item()}")
    return {"rank": rank, "device": cur, "bus": bus, "backend": dist.get_backend()}


def placement_body() -> dict:
    """A rank of phase 25's one-card checks: rank_placement alone."""
    import torch
    import torch.distributed as dist

    return rank_placement(torch, dist)


def one_card_checks() -> None:
    """Phase 25 on any host: a one-rank NCCL group of run_ranks(device=
    "cuda") binds its rank to card 0 (rank_placement); two NCCL ranks that
    see one card (CUDA_VISIBLE_DEVICES) are refused by initialize_multihost
    with its RuntimeError before a group starts, which fails both ranks."""
    from deepvcp_tpu_torch.parallel.launch import run_ranks

    (one,) = run_ranks("chip_smoke:placement_body", 1, device="cuda", timeout_s=120, echo=True)
    if one["device"] != 0 or one["backend"] != "nccl":
        fail(f"a one-rank NCCL group ran on {one}, not NCCL on cuda:0")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    try:
        run_ranks("chip_smoke:placement_body", 2, device="cuda", timeout_s=120,
                  env={"CUDA_VISIBLE_DEVICES": visible})
    except RuntimeError as e:
        said = [line.strip() for line in str(e).splitlines() if NCCL_REFUSED in line]
        if not said:
            fail(f"two NCCL ranks on one card failed without initialize_multihost's refusal: {e}")
    else:
        fail("two NCCL ranks on one card were not refused")
    print(f"two NCCL ranks seeing one card (CUDA_VISIBLE_DEVICES={visible}): refused, "
          f"{said[-1]}")


def ring_reference(torch, reg, pair) -> dict:
    """Phase 25b's inputs and reference on one card: kitti25-rot's
    candidate query of pair 0 (K * C = 13 824 queries) over its 10 000
    target points, k = num_neighbors, and the exact knn on them with its
    CUDA-event time (median of RING_REPS)."""
    from deepvcp_tpu_torch.ops import knn

    model = reg.model
    src, tgt, R_gt, t_gt = pair
    with torch.no_grad():
        enc = model.encode(src, tgt)
        _, cand = model.candidates(enc, R_gt, t_gt)
    query = cand.reshape(cand.shape[0], -1, 3)
    k = model.cfg.num_neighbors
    d, i = knn(enc.tgt_xyz, query, k)
    ms = cuda_median_ms(torch, lambda: knn(enc.tgt_xyz, query, k), reps=RING_REPS)
    return {"inputs": {"ref": enc.tgt_xyz.cpu().numpy(), "query": query.cpu().numpy(), "k": k},
            "dist": d.cpu(), "idx": i.cpu(), "ms": ms}


def ring_run(torch, mesh, dev, ring: dict) -> dict:
    """ring_knn over the point group of `mesh` on ring_reference's inputs
    `ring` on dev: the gathered result, the wall time of a first call (for
    NCCL, which sets up its point-to-point channels on it) and then the
    CUDA-event time (median of RING_REPS)."""
    from deepvcp_tpu_torch.ops.distributed import ring_knn

    ref, query = (torch.from_numpy(ring[k]).to(dev) for k in ("ref", "query"))

    def run():
        return ring_knn(mesh, ref, query, ring["k"])

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    d, i = run()
    ms = cuda_median_ms(torch, run, reps=RING_REPS)
    return {"dist": d.cpu(), "idx": i.cpu(), "ms": ms, "first_ms": first}


def ring_rank(torch, dist, ring: dict) -> dict:
    """Phase 25b in a rank: ring_run over a 1 x P mesh of every rank (NCCL's
    batch_isend_irecv between cards)."""
    from deepvcp_tpu_torch.parallel import make_mesh
    from deepvcp_tpu_torch.parallel.mesh import rank_card

    world = dist.get_world_size()
    out = ring_run(torch, make_mesh(1, world, device="cuda"), rank_card("cuda"), ring)
    print(f"rank {dist.get_rank()}: ring_knn over {world} cards, "
          f"{ring['query'].shape[1] // world} queries x {ring['ref'].shape[1] // world} points "
          f"a rank: first call {out['first_ms']:.1f} ms, then {out['ms']:.3f} ms (CUDA events)",
          flush=True)
    return out


def ring_agrees(torch, rings: list, want: dict, card: str) -> None:
    """Fail unless every rank's ring_run result `rings` is rank 0's, and
    rank 0's is the one-card knn `want`: neighbour sets equal but for rows
    whose differing members tie in distance (counted), the distances
    exact."""
    d_r, i_r = rings[0]["dist"], rings[0]["idx"]
    same = all(torch.equal(r["idx"], i_r) and torch.equal(r["dist"], d_r) for r in rings)
    differ = (torch.sort(i_r, dim=-1).values != torch.sort(want["idx"], dim=-1).values).any(-1)
    d_err = (d_r - want["dist"]).abs().max().item()
    ties_ok = bool(torch.equal(torch.sort(d_r[differ], -1).values,
                               torch.sort(want["dist"][differ], -1).values))
    ms = [r["ms"] for r in rings]
    each = ", ".join(f"{m:.3f}" for m in ms)
    print(f"ring_knn over {len(rings)} rank(s), one a card, vs knn on one card, "
          f"{i_r.shape[1]} queries, k={i_r.shape[-1]}: ranks equal {same}, rows differing "
          f"{int(differ.sum())} (each a distance tie: {ties_ok}), distances max|d| {d_err:.2e}; "
          f"ring {max(ms):.3f} ms a call (slowest rank; {each}), first call "
          f"{max(r['first_ms'] for r in rings):.1f} ms, against knn's {want['ms']:.3f} ms "
          f"(CUDA events; {card})")
    if not same or d_err > 0 or not ties_ok:
        fail(f"ring_knn over {len(rings)} rank(s) differs from the exact knn beyond distance "
             f"ties")


def ring_forward_rank(torch, dist, mesh) -> dict:
    """Phase 25c in a rank: the kitti25-rot registrar on this rank's card
    with knn_mesh = `mesh` (1 x P: its candidate KNN is the ring over the P
    cards, the serving form) on phase 4's 16 held pairs, B = 1: each
    pair's R, t and keypoints, the ring's selections (rank 0 only, int16
    indices), the K1 launches and pair 0's synced latency (median of 5)."""
    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.ops import distributed
    from deepvcp_tpu_torch.parallel.mesh import rank_card

    dev = rank_card("cuda")
    reg = pretrained.registrar("kitti25-rot", device=dev, num_points=N_POINTS)
    reg.model.knn_mesh = mesh
    pairs = held_pairs(torch, dev)
    ring, picked = distributed.ring_knn, []

    def record(*args, **kw):
        out = ring(*args, **kw)
        picked.append(out[1].to(torch.int16).cpu())
        return out

    distributed.ring_knn = record
    try:
        outs, counts = counted_all(torch, lambda: [reg(src, tgt) for src, tgt, _, _ in pairs])
    finally:
        distributed.ring_knn = ring
    ms = host_median_ms(torch, lambda: reg(pairs[0][0], pairs[0][1]), reps=5)
    print(f"rank {dist.get_rank()}: kitti25-rot registrar with the ring over {mesh.shape[1]} "
          f"cards, {len(pairs)} pairs: K1 {counts['k1']} launches, {len(picked)} ring "
          f"selections, pair 0 {ms:.3f} ms a call (synced, median of 5)", flush=True)
    return {"R": [o.R.cpu() for o in outs], "t": [o.t.cpu() for o in outs],
            "keypoints": [o.keypoints.cpu() for o in outs], "counts": counts, "ms": ms,
            "selections": picked if dist.get_rank() == 0 else None}


def ring_forward_agrees(torch, reg, pairs, ranks: list, card: str) -> None:
    """Phase 25c against the single-card registrar `reg` on the same pairs:
    every rank rank 0's poses and keypoints; the single card's candidate
    selections replaced by the ring's after checking that each differing
    row differs only at a near-tie of the k-th distance
    (selection_near_tie, as pinned_pose); then the same keypoints and R, t
    within CARD_CPU_POSE. The source side's selections (another query
    size) are the single card's own."""
    fwd = [r["forward"] for r in ranks]
    for r, got in enumerate(fwd[1:], 1):
        if not all(torch.equal(a, b) for key in ("R", "t", "keypoints")
                   for a, b in zip(got[key], fwd[0][key])):
            fail(f"rank {r}'s ring forward differs from rank 0's")
    for r, got in enumerate(fwd):
        if got["counts"]["k1"] != LAUNCHES_PER_CALL * len(pairs):
            fail(f"rank {r}: expected {LAUNCHES_PER_CALL} K1 launches a ring forward call")
    ring = iter(fwd[0]["selections"])
    reg.model._knn, n = pinned_knn(torch, reg.model, ring,
                                   rows=fwd[0]["selections"][0].shape[1])
    try:
        with torch.no_grad():
            outs = [reg(src, tgt) for src, tgt, _, _ in pairs]
    finally:
        del reg.model._knn
    if next(ring, None) is not None:
        fail("the ring forward made more candidate selections than the single card")
    kp_same = all(torch.equal(o.keypoints.cpu(), k) for o, k in zip(outs, fwd[0]["keypoints"]))
    dR = max((o.R.cpu() - R).abs().max().item() for o, R in zip(outs, fwd[0]["R"]))
    dt = max((o.t.cpu() - t).abs().max().item() for o, t in zip(outs, fwd[0]["t"]))
    print(f"kitti25-rot ring forward over {len(ranks)} cards vs the single-card registrar, "
          f"{len(pairs)} pairs: ranks equal; keypoints {'equal' if kp_same else 'DIFFER'}; "
          f"candidate selections: {n['rows']} query rows differ, {n['ties']} of them only at a "
          f"near-tie of the k-th distance (the single card then takes the ring's rows); max|dR| "
          f"{dR:.3e}, max|dt| {dt:.3e}; pair 0 {max(f['ms'] for f in fwd):.3f} ms a call "
          f"(slowest rank; {card})")
    if not kp_same or n["ties"] != n["rows"] or dR > CARD_CPU_POSE or dt > CARD_CPU_POSE:
        fail("the ring forward disagrees with the single-card registrar")


def step_refs(torch, dev) -> dict:
    """Phase 25d's single-card steps: kitti25-rot under its recipe from
    DP_STEP (dp_setup) at each global B of MULTI_STEPS, under deterministic
    algorithms: {B: step_result with its step_peak ("peak"), synced time
    ("ms", median of 3), device busy time ("busy") and lr}."""
    from deepvcp_tpu_torch.train import make_train_step
    from deepvcp_tpu_torch.train.optim import learning_rate_schedule

    refs = {}
    for B in sorted({shape[2] for shapes in MULTI_STEPS.values() for shape in shapes}):
        trainer, tcfg, saved, batch = dp_setup(torch, dev, batch=B)
        plain = make_train_step(trainer.model, learning_rate_schedule(tcfg), tcfg)
        with deterministic(torch):
            ref, peak = step_peak(torch, lambda: step_result(torch, trainer, plain, saved, batch))
            ms = host_median_ms(torch, lambda: step_result(torch, trainer, plain, saved, batch),
                                reps=3)
            busy, _ = device_time_per_call(
                torch, lambda: step_result(torch, trainer, plain, saved, batch), calls=2)
        refs[B] = {**ref, "peak": peak, "ms": ms, "busy": busy,
                   "lr": learning_rate_schedule(tcfg)(DP_STEP)}
        print(f"single-card kitti25-rot step, B={B}, N={N_POINTS}: {ms:.3f} ms a step, device "
              f"busy {busy:.3f} ms, peak {peak[0]:.1f} MiB above its start ({peak[1]:.1f} MiB "
              f"in all)")
        del trainer, plain
        torch.cuda.empty_cache()
    return refs


def mesh_steps(torch, dist, shapes) -> dict:
    """Phase 25d in a rank: for each (data, point, B) of `shapes`, one step
    of make_train_step(mesh=data x point) from dp_setup's state on its
    B-pair batch (shard_batch: this rank's rows), under deterministic
    algorithms; a point group of P > 1 splits the per-point work
    (point_partition) and runs the candidate KNN as the ring (knn_mesh).
    {shape: step_result with the gate's verdict, K1 / K2 launches, the
    step's peak on this rank's card, its synced time (median of 3), and
    the device's busy time and the NCCL kernels' time a step
    (device_time_per_call over 2 steps)}."""
    from deepvcp_tpu_torch.parallel import make_mesh, shard_batch
    from deepvcp_tpu_torch.parallel.mesh import rank_card
    from deepvcp_tpu_torch.train import make_train_step
    from deepvcp_tpu_torch.train.optim import learning_rate_schedule

    dev, rank, setups, out = rank_card("cuda"), dist.get_rank(), {}, {}
    for data, point, B in shapes:
        if B not in setups:
            setups[B] = dp_setup(torch, dev, batch=B)
        trainer, tcfg, saved, batch = setups[B]
        mesh = make_mesh(data, point, device="cuda")
        trainer.model.knn_mesh = mesh if point > 1 else None
        step = make_train_step(trainer.model, learning_rate_schedule(tcfg), tcfg, mesh=mesh)
        args = shard_batch(mesh, batch)
        split = point > 1 and trainer.model.partitions(mesh, args[0].shape[1], args[1].shape[1])
        with deterministic(torch):
            (result, peak), counts = counted_all(torch, lambda: step_peak(
                torch, lambda: step_result(torch, trainer, step, saved, args)))
            ms = host_median_ms(torch, lambda: step_result(torch, trainer, step, saved, args),
                                reps=3)
            busy, kernels = device_time_per_call(
                torch, lambda: step_result(torch, trainer, step, saved, args), calls=2, top=None)
        nccl = sum(t for name, t in kernels if "nccl" in name.lower())
        trainer.model.knn_mesh = None
        print(f"rank {rank} on {dev}: {data} x {point} mesh, B={B} ({args[0].shape[0]} pairs a "
              f"rank, point split {split}): K1 {counts['k1']}, K2 {counts['k2']} launches, peak "
              f"{peak[0]:.1f} MiB above the step's start ({peak[1]:.1f} MiB in all), {ms:.3f} ms "
              f"a step, device busy {busy:.3f} ms (NCCL kernels {nccl:.3f})", flush=True)
        out[(data, point, B)] = {**result, "counts": counts, "split": split, "peak": peak,
                                 "ms": ms, "busy": busy, "nccl": nccl}
    return out


def steps_agree(torch, world: int, ranks: list, refs: dict, card: str) -> dict:
    """Phase 25d's gates: each rank's step of each mesh against the
    single-card step at its global B (dp_step_agrees: DP_BOUNDS, 6 K1 + 6
    K2), the point split's gate passed where the point group has P > 1,
    every rank equal; prints the scaling (the single card's time over the
    slowest rank's, and over P times it). Returns the ranks' K1 / K2 / K6."""
    total = {"k1": 0, "k2": 0, "k6": 0, "k6b": 0}
    for data, point, B in MULTI_STEPS[world]:
        got = [r["steps"][(data, point, B)] for r in ranks]
        ref, what = refs[B], f"{data} x {point} mesh over {world} cards (NCCL), B={B}"
        for r, g in enumerate(got):
            if point > 1 and not g["split"]:
                fail(f"rank {r}: the point partition's gate refused the {what} step")
            dp_step_agrees(torch, g, ref, ref["lr"], f"rank {r} of the {what}")
        ranks_equal(torch, got, ref["params"], what)
        ms = max(g["ms"] for g in got)
        each = ", ".join(f"{g['ms']:.3f}" for g in got)
        busy = ", ".join(f"{g['busy']:.3f} ({g['nccl']:.3f})" for g in got)
        print(f"{what}: {ms:.3f} ms a step (slowest rank; {each}), device busy (NCCL kernels) "
              f"{busy} ms, peak {max(g['peak'][1] for g in got):.1f} MiB on a card; single card "
              f"at B={B} {ref['ms']:.3f} ms (busy {ref['busy']:.3f}), peak {ref['peak'][1]:.1f} "
              f"MiB: speed-up {ref['ms'] / ms:.3f}x, {ref['ms'] / (world * ms):.3f} of {world} "
              f"cards ({card})")
        for k in total:
            total[k] += sum(g["counts"][k] for g in got)
    return total


def multicard_body(ring: dict, graph, forward: bool) -> dict:
    """One rank of phase 25's multi-card part (run_ranks(device="cuda"):
    NCCL, rank r on card r): a. its placement (rank_placement); b. ring_knn
    over every rank (ring_rank); c. with `forward`, the registrar's ring
    forward over a 1 x P mesh (ring_forward_rank); d. the train steps of
    MULTI_STEPS[P] (mesh_steps); e. with `graph`, the sharded pose graph
    and BA over a P x 1 mesh (solves)."""
    import torch
    import torch.distributed as dist

    from deepvcp_tpu_torch.parallel import make_mesh
    from deepvcp_tpu_torch.parallel.mesh import rank_card

    world = dist.get_world_size()
    out = {"placement": rank_placement(torch, dist), "ring": ring_rank(torch, dist, ring)}
    if forward:
        out["forward"] = ring_forward_rank(torch, dist, make_mesh(1, world, device="cuda"))
    out["steps"] = mesh_steps(torch, dist, MULTI_STEPS[world])
    if graph is not None:
        out["solves"] = solves(torch, solve_inputs(torch, graph, rank_card("cuda")),
                               make_mesh(world, 1, device="cuda"))
    return out


def multicard_phase(torch, dev, reg, pairs, graph, card: str) -> dict:
    """Phase 25: the multi-device paths on several cards, one rank a card
    over NCCL. On any host, one_card_checks. With 2 or more cards visible,
    for a world of 2 ranks and, with 4 or more cards, of 4 (each a fresh
    run_ranks(device="cuda")) against one card's result in this process:
    a. every rank on its own card (distinct PCI bus ids; nvidia-smi's
    topology and NCCL's channels printed); b. ring_knn over
    all the ranks vs the exact knn (ring_agrees); c. (4 ranks) the
    registrar's ring forward vs the single-card registrar
    (ring_forward_agrees); d. the train steps of MULTI_STEPS vs the
    single-card step at the same global B (steps_agree); e. (4 ranks) the
    sharded solves on phase 20's `graph` vs the unsharded ones
    (solves_agree); f. dryrun_multichip over the ranks, one loss. Returns
    the ranks' K1 / K2 launches."""
    import collections
    import tempfile

    from deepvcp_tpu_torch.graft_entry import dryrun_multichip
    from deepvcp_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    one_card_checks()
    cards = torch.cuda.device_count()
    total = {"k1": 0, "k2": 0, "k6": 0, "k6b": 0}
    if cards < 2:
        print(f"phase 25: 1 card visible: the one-card checks only; "
              f"{time.perf_counter() - t0:.1f} s")
        return total
    worlds = [w for w in MULTI_STEPS if w <= cards]
    print(f"phase 25: {cards} cards visible: the one-card checks and the multi-card part over "
          f"{' and '.join(map(str, worlds))} ranks")
    for cmd in (["topo", "-m"], ["topo", "-p2p", "n"], ["nvlink", "-s", "-i", "0"]):
        out = subprocess.run(["nvidia-smi", *cmd], capture_output=True, text=True, timeout=60)
        print(f"nvidia-smi {' '.join(cmd)}:\n" + (out.stdout or out.stderr).rstrip())
    print(f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}")
    g_cpu, R_ch, t_ch = graph
    graph = (tuple(a.numpy() for a in g_cpu), R_ch.numpy(), t_ch.numpy())
    ring = ring_reference(torch, reg, pairs[0])
    refs = step_refs(torch, dev)
    solved = solves(torch, solve_inputs(torch, graph, dev), None)
    torch.cuda.empty_cache()
    for world in worlds:
        big = world == max(MULTI_STEPS)
        with tempfile.TemporaryDirectory() as tmp:
            # NCCL's record of the channels it set up between the cards
            ranks = run_ranks("chip_smoke:multicard_body", world,
                              kwargs={"ring": ring["inputs"], "graph": graph if big else None,
                                      "forward": big},
                              device="cuda", timeout_s=MULTI_TIMEOUT_S, echo=True,
                              env={"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,P2P",
                                   "NCCL_DEBUG_FILE": os.path.join(tmp, "nccl.%h.%p")})
            via = collections.Counter(
                line.split(" via ", 1)[1].split()[0] for name in os.listdir(tmp)
                for line in open(os.path.join(tmp, name)) if " via " in line)
        buses = [r["placement"]["bus"] for r in ranks]
        print(f"{world} ranks: cards {[r['placement']['device'] for r in ranks]}, PCI bus ids "
              f"{buses}; NCCL's channels between them, by transport: {dict(via) or 'none logged'}")
        if [r["placement"]["device"] for r in ranks] != list(range(world)) or \
                len(set(buses)) != world:
            fail(f"the {world} ranks are not each on their own card")
        ring_agrees(torch, [r["ring"] for r in ranks], ring, card)
        if big:
            ring_forward_agrees(torch, reg, pairs, ranks, card)
            for k in ("k1", "k6", "k6b"):
                total[k] += sum(r["forward"]["counts"][k] for r in ranks)
            for r, got in enumerate(ranks):
                solves_agree(torch, got["solves"], solved,
                             f"rank {r}'s sharded solves over {world} cards (NCCL)")
        for k, v in steps_agree(torch, world, ranks, refs, card).items():
            total[k] += v
    world = max(worlds)
    try:
        loss = dryrun_multichip(world, device="cuda", timeout_s=MULTI_TIMEOUT_S)
    except (AssertionError, RuntimeError) as e:
        fail(f"dryrun_multichip over {world} cards: {e}")
    print(f"dryrun_multichip({world}, device='cuda'): every rank's loss {loss:.6f}")
    print(f"phase 25: {time.perf_counter() - t0:.1f} s; K1 {total['k1']}, K2 {total['k2']} "
          f"launches on the ranks' cards")
    return total


def band_entries(band: dict, k1: int, k2: int) -> list:
    """The kernels line's K1 and K2 entries: band_phase's serving sums and
    the launches k1, k2."""
    return [{
        "name": "banded_masked_max",
        "route": "cuda",
        "source": "deepvcp_tpu_torch/csrc/band_max.cu",
        "replaces": "deepvcp_tpu/ops/pallas/band_max_kernel.py:148",
        "launches": k1,
        "max_abs_err": band["k1_err"],
        "ms": band["k1_ms"],
        "plain_ms": band["k1_plain_ms"],
        "bound_ms": band["k1_bound"][0],
        "bound_by": band["k1_bound"][1],
        "library_ms": None,
    }, {
        "name": "banded_masked_max_grad",
        "route": "cuda",
        "source": "deepvcp_tpu_torch/csrc/band_max_grad.cu",
        "replaces": "deepvcp_tpu/ops/pallas/band_max_kernel.py:267",
        "launches": k2,
        "max_abs_err": band["k2_err"],
        "ms": band["k2_ms"],
        "plain_ms": band["k2_plain_ms"],
        "bound_ms": band["k2_bound"][0],
        "bound_by": band["k2_bound"][1],
        "library_ms": None,
    }]


def finish(torch, started: float, card: str, kernels: list) -> None:
    """Check 11 (neither jax nor the JAX package was imported), then the
    last lines: the card, the kernels line and the contract's line."""
    imported = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "deepvcp_tpu"))
    if imported:
        fail(f"jax or the JAX package was imported: {imported[:8]}")
    print("jax imported: no; deepvcp_tpu imported: no")
    print(f"smoke run: {time.perf_counter() - started:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def multicard_main(torch, dev, card: str, started: float) -> None:
    """python3 chip_smoke.py --multicard, after phases 1-2: K1 and K2 at
    the serving shapes (phase 3 without the cascade's clouds: the kernels
    line's numbers), then phase 25 on phase 4's registrar and pairs and
    phase 20's pose graph (o1_graph). The kernels line holds K1 and K2, the
    kernels of phase 25's paths, with their launches on the ranks' cards."""
    from deepvcp_tpu_torch import pretrained

    band = band_phase(torch, dev, serving_only=True)
    reg = pretrained.registrar("kitti25-rot", device=dev, num_points=N_POINTS)
    multi = multicard_phase(torch, dev, reg, held_pairs(torch, dev), o1_graph(torch, dev), card)
    finish(torch, started, card, band_entries(band, multi["k1"], multi["k2"]))


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description="Smoke run of the port on CUDA cards.")
    p.add_argument("--multicard", action="store_true",
                   help="phases 1-2 and phase 25 only; needs 2 or more cards")
    args = p.parse_args()
    started = time.perf_counter()
    # cuBLAS reads this when it starts; the train-path comparison (phase 9)
    # runs under deterministic algorithms, which need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if args.multicard and torch.cuda.device_count() < 2:
        print(f"chip_smoke.py --multicard: {torch.cuda.device_count()} CUDA card visible; phase "
              f"25's multi-card part needs 2 or more", file=sys.stderr)
        sys.exit(1)

    # the port itself: an ImportError here (no checkout around the script)
    # ends the run before anything is printed
    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.data import rotation_geodesic_deg, translation_error
    from deepvcp_tpu_torch.ops.kernels import _build
    from deepvcp_tpu_torch.ops.kernels.band_max import banded_masked_max
    from deepvcp_tpu_torch.ops.kernels.knn_select import knn_select, knn_select_bf16

    card = card_line()
    print(f"card: {card}")
    print(f"toolchain: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({_build.build()})")
    if args.multicard:
        multicard_main(torch, dev, card, started)
        return

    # 3. K1 and K2 against their plain versions
    band = band_phase(torch, dev)

    # 4. the main path: Registrar on kitti25-rot, 16 held-out pairs
    reg = pretrained.registrar("kitti25-rot", device=dev)
    pairs = held_pairs(torch, dev)
    torch.cuda.synchronize()
    banded_masked_max.launches = 0
    knn_select.launches = knn_select_bf16.launches = 0
    outs = [reg(src, tgt) for src, tgt, _, _ in pairs]
    torch.cuda.synchronize()
    launches, k6_launches = banded_masked_max.launches, knn_select.launches
    k6b_launches = knn_select_bf16.launches
    rre, rte = pose_errors(torch, outs, pairs, reg.refine_iters, "kitti25-rot")
    eye = torch.eye(3, device=dev)[None]
    rre0 = [rotation_geodesic_deg(eye, R_gt).item() for _, _, R_gt, _ in pairs]
    rte0 = [translation_error(torch.zeros_like(t_gt), t_gt).item() for _, _, _, t_gt in pairs]
    for i, out in enumerate(outs):
        print(f"pair {i:2d}: RRE {rre[i]:.4f} deg, RTE {rte[i]:.5f} m | identity init "
              f"{rre0[i]:.4f} deg, {rte0[i]:.5f} m | best score {out.scores.min().item():.5f}")
    mean_rre, mean_rte = statistics.mean(rre), statistics.mean(rte)
    print(f"kitti25-rot GT-free over {N_PAIRS} pairs (refine_iters={reg.refine_iters}, "
          f"exact selection): mean RRE {mean_rre:.4f} deg, mean RTE {mean_rte:.5f} m | "
          f"identity init {statistics.mean(rre0):.4f} deg, {statistics.mean(rte0):.5f} m")
    if not (mean_rre <= RRE_LIMIT_DEG and mean_rte <= RTE_LIMIT_M):
        fail(f"accuracy: mean RRE {mean_rre} > {RRE_LIMIT_DEG} or RTE {mean_rte} > {RTE_LIMIT_M}")

    # 5. kernel path vs plain path, pair 0
    src, tgt = pairs[0][0], pairs[0][1]
    registrar_paths_agree(torch, reg, src, tgt, "kitti25-rot")

    # 6. launch count of the main-path run in step 4
    print(f"K1 launches in the main-path run: {launches} over {N_PAIRS} Registrar calls "
          f"({launches / N_PAIRS:g} per call)")
    if launches != LAUNCHES_PER_CALL * N_PAIRS:
        fail(f"expected {LAUNCHES_PER_CALL} K1 launches per call, got {launches / N_PAIRS:g}")
    print(f"K6 launches in the main-path run: {k6_launches} ({k6_launches / N_PAIRS:g} per "
          f"call: encode's source KNN and {reg.refine_iters} flat stages)")
    if k6_launches != (1 + reg.refine_iters) * N_PAIRS:
        fail(f"expected {1 + reg.refine_iters} K6 launches per call, got "
             f"{k6_launches / N_PAIRS:g}")

    # 7. timing (not gated)
    exact = {"rre": mean_rre, "rte": mean_rte, "latency": registrar_timing(
        torch, reg, src, tgt, "kitti25-rot", reps=20, plain_reps=10)}
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # 26. K6 against its plain version on the benchmark's pairs, and its
    # launches on the registrar's path
    k6 = knn_select_phase(torch, dev, reg)["flat B=8"]

    # 27. K6's bf16 arm against torch.topk of the bf16 tile on lidar-fine's
    # shapes and a lattice, and its launches on lidar-fine's registrar
    k6_bf16 = knn_select_bf16_phase(torch, dev)

    # 8-10. the training path
    train = train_phase(torch, dev, pairs)

    # 12-15. FPS and the global path
    k3 = k3_phase(torch, dev)
    glob = global_phase(torch, dev)

    # 16-19. the two-level path: K4/K5, serving, paths, training
    two = two_level_phase(torch, dev, pairs)
    two_train = two_level_training(torch, dev)

    # 20. odometry, the CLI, stream and routing
    odo = odometry_phase(torch, dev, reg, pairs, card)

    # 21. the engines: windowed, dense, keypoints branch, static band, bf16,
    # plain two-level gather, MSG / FP, windowed training, --save-vis
    eng = engines_phase(torch, dev, pairs, exact)

    # 22. multi-device: the sharded step, ring_knn, the sharded solves and
    # the tooling over a process group of one NCCL rank
    multi = multi_device_phase(torch, dev, reg, pairs, odo)

    # 23. the native oracles against K3 and the flat KNN; the examples, the
    # trained checkpoint and the convergence run
    ora = oracle_phase(torch, dev, reg, pairs)

    # 24. the headline bench at N = 10 000 and B = 1, 2, 4, 8, and its CLI
    bnch = bench_phase(torch, dev, card)

    # 25. several cards: the one-card checks of one rank a card over NCCL,
    # and with 2 or more cards the multi-device paths across them
    mc = multicard_phase(torch, dev, reg, pairs, odo["graph"], card)

    (k1_bound, k1_by), (k2_bound, k2_by) = band["k1_bound"], band["k2_bound"]
    print(f"bounds at the 3 serving SA shapes: K1 {k1_bound:.5f} ms ({k1_by}), K2 {k2_bound:.5f} "
          f"ms ({k2_by}); K3 at one init call's 2 shapes {k3['bound_ms']:.5f} ms "
          f"({k3['bound_by']})")

    # 11. no jax, nothing of the JAX package; then the last lines.
    # ms / plain_ms / bound_ms: K1 and K2 sums at the 3 SA shapes (one FE
    # pass, or one FE backward), K3 sums at the 2 shapes of one init call,
    # K4 and K5 at the two-level path's shapes (library_ms: torch.gather,
    # torch.scatter_add), K6 at the flat stage's [8, 13 824] x 10 000
    # (library_ms: square_distance + torch.topk), its bf16 arm at
    # lidar-fine's [8, 21 952] x 10 000 (max_abs_err: the largest |d2| gap
    # to the bf16 tile's over phase 27's cases); launches: the main-path
    # runs' (serving, training, global, two-level serving and training,
    # odometry, the engines, multi-device, the examples, the trained
    # checkpoint and convergence, the bench, the ranks of several cards;
    # phase 27's lidar-fine registrar call; the wrappers' own calls in
    # phases 26 and 27 left out), each counted from 0 just before its run
    finish(torch, started, card, band_entries(
        band,
        launches + train["k1"] + glob["k1"] + two["k1"] + two_train["k1"] + odo["k1"]
        + eng["k1"] + multi["k1"] + ora.get("k1", 0) + bnch["k1"] + mc["k1"],
        train["k2"] + two_train["k2"] + eng["k2"] + multi["k2"] + ora.get("k2", 0) + mc["k2"],
    ) + [{
        "name": "farthest_point_sample",
        "route": "cuda",
        "source": "deepvcp_tpu_torch/csrc/fps.cu",
        "replaces": "deepvcp_tpu/ops/pallas/fps_kernel.py:81",
        "launches": glob["k3"] + eng["k3"] + ora.get("k3", 0),
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "deepvcp_tpu_torch/csrc/onehot_gather.cu",
        "replaces": f"deepvcp_tpu/ops/pallas/onehot_gather.py:{line}",
        "launches": launches_,
        **{key: two[k][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
    } for name, k, line, launches_ in (
        ("onehot_gather", "K4", 74, two["k4"] + two_train["k4"] + eng["k4"]),
        ("onehot_scatter_add", "K5", 156, two_train["k5"] + eng["k5"]))] + [{
        "name": "knn_select",
        "route": "cuda",
        "source": "deepvcp_tpu_torch/csrc/knn_select.cu",
        "replaces": None,   # XLA's approx_min_k (deepvcp_tpu/ops/knn.py:117), no Pallas kernel
        "launches": k6_launches + train["k6"] + glob["k6"] + two["k6"] + two_train["k6"]
        + odo["k6"] + eng.get("k6", 0) + multi["k6"] + ora.get("k6", 0) + bnch.get("k6", 0)
        + mc["k6"],
        **{key: k6[key] for key in ("max_abs_err", "ms", "plain_ms", "library_ms")},
        "bound_ms": k6["bound"][0],
        "bound_by": k6["bound"][1],
    }, {
        "name": "knn_select_bf16",
        "route": "cuda",
        "source": "deepvcp_tpu_torch/csrc/knn_select.cu",
        "replaces": None,   # as knn_select
        # every call in this process but phase 27's own calls of the wrapper
        "launches": k6b_launches + k6_bf16["registrar_launches"] + train["k6b"] + glob["k6b"]
        + two["k6b"] + two_train.get("k6b", 0) + odo["k6b"] + eng.get("k6b", 0) + multi["k6b"]
        + ora.get("k6b", 0) + bnch.get("k6b", 0) + mc["k6b"],
        "max_abs_err": max(r["max_abs_err"] for r in k6_bf16.values() if isinstance(r, dict)),
        "ms": k6_bf16["flat B=8"]["ms"],
        "plain_ms": k6_bf16["flat B=8"]["plain_ms"],
        "library_ms": None,
        "bound_ms": k6_bf16["flat B=8"]["bound"][0],
        "bound_by": k6_bf16["flat B=8"]["bound"][1],
    }])


if __name__ == "__main__":
    main()
