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
Trainer.fit with a heartbeat, plot and profile_stages. It checks on the
way:

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
                 steps change them, 6 K1 and 6 K2 launches per step
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
                 within the bounds above; a rank that fails or outlasts its
                 timeout fails the run. ring_knn over more than one rank is
                 not run on the card: gloo takes no CUDA tensors for its
                 point-to-point sends (batch_isend_irecv)
 11. no jax      neither jax nor the JAX package deepvcp_tpu was imported
                 (checked last)

Any failure exits non-zero. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels as JSON.
Run from the root of a checkout, with no arguments:  python3 chip_smoke.py
"""

from __future__ import annotations

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
TWO_RANK_TIMEOUT_S = 240


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


def device_time_per_call(torch, fn, calls: int):
    """Device busy time per call of fn() from torch.profiler: the union of
    the intervals of every kernel, copy and fill on the card. User-annotation
    ranges (such as the optimizer's step) enclose kernels that are counted
    already and are left out. Also returns the 8 kernels that take most of
    the time."""
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
    return busy_us / 1e3 / calls, sorted(rows, key=lambda r: -r[1])[:8]


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
    the step. Returns the K1 and K2 launch counts of the 12 gated steps."""
    import numpy as np

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.data import rotation_geodesic_deg, translation_error
    from deepvcp_tpu_torch.ops.kernels import band_max
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
    trainer.train_epoch(iter(batches[:1]), epoch=0)
    torch.cuda.synchronize()
    moved0 = [n for n, p in trainer.model.named_parameters() if not torch.equal(p, params0[n])]
    trainer.train_epoch(iter(batches[1:]), epoch=0)
    torch.cuda.synchronize()
    k1, k2 = band_max.banded_masked_max.launches, band_max.banded_masked_max_grad.launches
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
    print(f"launches over the {TRAIN_STEPS} train steps: K1 {k1}, K2 {k2} "
          f"({k1 / TRAIN_STEPS:g} and {k2 / TRAIN_STEPS:g} per step); {wall:.2f} s in all, "
          f"the first step's cold start included; peak device memory {peak:.1f} MiB")
    if k1 != LAUNCHES_PER_CALL * TRAIN_STEPS or k2 != LAUNCHES_PER_CALL * TRAIN_STEPS:
        fail(f"expected {LAUNCHES_PER_CALL} K1 and K2 launches per train step")

    # the fine-tuned model through the Registrar on the held pairs (not gated)
    reg = pretrained.registrar("kitti25-rot", device=dev)
    reg.model.load_state_dict(trainer.model.state_dict(), strict=True)
    rre, rte = [], []
    for src, tgt, R_gt, t_gt in pairs:
        out = reg(src, tgt)
        rre.append(rotation_geodesic_deg(out.R, R_gt).item())
        rte.append(translation_error(out.t, t_gt).item())
    print(f"after {TRAIN_STEPS} fine-tuning steps, GT-free over {len(pairs)} held pairs: "
          f"mean RRE {statistics.mean(rre):.4f} deg, mean RTE {statistics.mean(rte):.5f} m")

    # 9. one step through the kernels against the same step through the
    # plain versions, from kitti25-rot as loaded, with a fresh Adam
    step_fn = build_train_step(trainer.model, learning_rate_schedule(tcfg), tcfg)
    train_paths_agree(torch, trainer, step_fn, saved,
                      tuple(torch.from_numpy(a).to(dev) for a in batches[0]), "train step")

    # 10. timing (not gated)
    time_train_step(torch, trainer, step_fn, batches, dev, "train step", reps=10, plain_reps=3,
                    profile=True)
    return {"k1": k1, "k2": k2}


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


def band_phase(torch, dev) -> dict:
    """Phase 3: K1 and K2 against their plain versions at the serving
    shapes (one FE pass of kitti25-rot on a 25 m lidar-like cloud) and at
    the cascade's (phase 13's first batch of each held set, B = 2), K2
    also with forced ties and run twice, and both at C outside the SA
    stages' widths; times per call and behind a device hold; slabs and
    bounds. Returns the serving sums for the kernels line."""
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
    batches = global_batches(torch, dev)
    families = {"serving": serving,
                "cascade lidar_like": sort_x(batches["lidar_like"][0][0][..., :3]),
                "cascade uniform_cube": sort_x(batches["uniform_cube"][0][0][..., :3])}
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


def k3_phase(torch, dev) -> dict:
    """Phase 12: K3 against its plain version at the global path's shapes,
    on a tie cloud and past the old 16 384-point limit; median CUDA-event
    times; the pick protocol alone at each cluster size. Returns the
    numbers of the two shapes one so3_global_init call runs ([2, N, 3] at
    4096 and 128)."""
    import numpy as np

    from deepvcp_tpu_torch.data import lidar_like_cloud
    from deepvcp_tpu_torch.ops.kernels import fps
    from deepvcp_tpu_torch.ops.kernels.fps import (
        farthest_point_sample, farthest_point_sample_reference)

    rng = np.random.default_rng(1)
    g = np.arange(17, dtype=np.float32) * 0.125
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    lattice = np.concatenate([lattice, lattice])[rng.permutation(2 * len(lattice))]
    cases = [(f"[{B}, {N}, 3] npoint {k}",
              np.stack([lidar_like_cloud(rng, N, max_range=1.0) for _ in range(B)]), k)
             for B, N, k in FPS_SHAPES + FPS_LARGE]
    cases.append((f"tie cloud [1, {len(lattice)}, 3] (a 17^3 lattice, every point twice) "
                  f"npoint 4096", lattice[None], 4096))
    init = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "max_abs_err": 0}
    for name, xyz, k in cases:
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
    Returns the K1 and K3 launch counts of the gated run."""
    import numpy as np

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.data import rotation_geodesic_deg, translation_error
    from deepvcp_tpu_torch.initializer import so3_global_init
    from deepvcp_tpu_torch.ops import farthest_point_sample
    from deepvcp_tpu_torch.ops.kernels import band_max, fps, reference_path

    casc = pretrained.cascade("modelnet-cascade", device="cuda")   # the current card, dev
    batches = global_batches(torch, dev)

    # 13. the main path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fps.farthest_point_sample.launches = 0
    band_max.banded_masked_max.launches = 0
    runs = {name: [] for name in batches}
    for name, bs in batches.items():
        for src, tgt, _, _ in bs:
            init = so3_global_init(src, tgt)
            runs[name].append((init, casc(src, tgt, init.R, init.t)))
    torch.cuda.synchronize()
    k3, k1 = fps.farthest_point_sample.launches, band_max.banded_masked_max.launches
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
    return {"k1": k1, "k3": k3}


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
    K1 and K4 launch counts of the gated run and K4's and K5's numbers."""
    import dataclasses

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.ops.kernels import band_max
    from deepvcp_tpu_torch.ops.kernels import onehot_gather as og
    from deepvcp_tpu_torch.registration import Registrar

    flat = pretrained.registrar("kitti25", device=dev)
    variables = pretrained.load_variables("kitti25")

    def variant(**changes):
        return Registrar(dataclasses.replace(flat.cfg, **changes), variables, dev,
                         use_saliency_weights=flat.use_saliency_weights,
                         refine_iters=flat.refine_iters)

    reg = variant(**TWO_LEVEL)
    print(f"two-level kitti25: T={reg.cfg.tgt_knn_table}, level-1 selection "
          f"{reg.cfg.knn_select_dtype_effective or 'float32'}, level-2 "
          f"{reg.cfg.knn_select_dtype}, refine_iters={reg.refine_iters}")

    # 16. K4 and K5
    k4, k5 = onehot_phase(torch, dev, reg, pairs[0])

    # 17. the main path: 16 pairs through the two-level registrar
    torch.cuda.synchronize()
    og.onehot_gather.launches = 0
    band_max.banded_masked_max.launches = 0
    outs = [reg(src, tgt) for src, tgt, _, _ in pairs]
    torch.cuda.synchronize()
    k4_runs, k1_runs = og.onehot_gather.launches, band_max.banded_masked_max.launches
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
    print(f"launches in the two-level run: K4 {k4_runs}, K1 {k1_runs} over {len(pairs)} "
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
    return {"k1": k1_runs, "k4": k4_runs, "K4": k4, "K5": k5}


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


def check_k1(what: str, counts: dict, stage_calls: int) -> int:
    """Gate a run's K1 launches (counts from counted_all) at
    LAUNCHES_PER_CALL a stage call (one FE pass on each cloud); returns
    the count."""
    launches = counts["k1"]
    print(f"K1 launches in {what}: {launches} over {stage_calls} stage calls "
          f"({launches / stage_calls:g} per stage call)")
    if launches != LAUNCHES_PER_CALL * stage_calls:
        fail(f"{what}: expected {LAUNCHES_PER_CALL} K1 launches per stage call, got "
             f"{launches / stage_calls:g}")
    return launches


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

    k1 = 0
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
        (R1, t1), c = counted_all(torch, lambda: register_sequence(casc, scans, warm_start=True))
        k1 += check_k1("O1's sequence", c, len(casc.stages) * (F - 1))
        o1 = odometry_errors(R1, t1, R_true, t_true, "O1 kitti-cascade")
        R_ch, t_ch = chain_poses(torch.from_numpy(R1), torch.from_numpy(t1))
        ate1 = float(absolute_trajectory_error(t_ch, t_gt_t))

        def skip_edges():
            edges = []
            for i in range(F - 2):
                Ra, ta, Rb, tb = R1[i], t1[i], R1[i + 1], t1[i + 1]
                o = casc(*(torch.from_numpy(a).to(dev) for a in (
                    scans[i:i + 1], scans[i + 2:i + 3], (Rb @ Ra)[None], (Rb @ ta + tb)[None])))
                edges.append((i, i + 2, o.R[0].cpu().numpy(), o.t[0].cpu().numpy()))
            return edges
        extra, c = counted_all(torch, skip_edges)
        k1 += check_k1("O1's skip edges", c, len(casc.stages) * (F - 2))
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
        k1 += check_k1("O2's sequence", c, F - 1)
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
        k1 += check_k1("run_odometry on 4 frames", c, 3)
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
        k1 += check_k1("the odometry CLI", c, F - 1)
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
    k1 += check_k1("the per-call run", c, len(held))
    streamed, c = counted_all(torch, lambda: list(reg.stream(iter(held), depth=4)))
    k1 += check_k1("the stream run", c, len(held))
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
    k1 += check_k1("the routed run", c, ROUTE_BATCHES * len(sets))
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
    return {"k1": k1, "graph": (graph_cpu, R_ch, t_ch)}


def kernel_counters() -> dict:
    """Each kernel's wrapper, whose `launches` attribute counts its launches."""
    from deepvcp_tpu_torch.ops.kernels import band_max, fps
    from deepvcp_tpu_torch.ops.kernels import onehot_gather as og

    return {"k1": band_max.banded_masked_max, "k2": band_max.banded_masked_max_grad,
            "k3": fps.farthest_point_sample, "k4": og.onehot_gather,
            "k5": og.onehot_scatter_add}


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


def selection_near_tie(cfg, ref, query, b: int, m: int, k: int, swapped: list) -> bool:
    """Whether the points `swapped` between the card's and the CPU's k
    nearest of ref to query row (b, m) all lie at a near-tie of the k-th
    distance, ranked as the model's selection ranks them: approx_knn's bf16
    tile (centred, bf16 inputs, f32 product, cast to bf16) or knn's f32
    matmul form. The devices' f32 sums differ in their last bits, so a bf16
    value rounds to the same number or the next one on each, and a swap
    lies within 2 bf16 steps of the k-th; in f32, within 2 x 8 ulps of
    |q|^2 + max |r|^2, the scale of the terms the matmul form adds."""
    import math

    import torch

    from deepvcp_tpu_torch.ops.distance import square_distance

    sel = cfg.knn_select_dtype_effective if cfg.use_approx_knn else None
    if sel is None:
        q, r = query[b, m][None], ref[b]
        d2 = square_distance(q, r)[0]
        tol = 16 * 2.0 ** -24 * ((q * q).sum() + (r * r).sum(-1).max()).item()
    else:
        sel = getattr(torch, sel)
        center = ref[b].mean(dim=0, keepdim=True)
        qc, rc = query[b, m][None] - center, ref[b] - center
        cross = qc.to(sel).float() @ rc.to(sel).float().T
        d2 = ((qc * qc).sum(-1)[:, None] + (rc * rc).sum(-1)[None] - 2.0 * cross).to(sel)[0]
        tol = None
    kth = torch.sort(d2.float()).values[k - 1].item()
    if tol is None:
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

    def record(ref, query, chunked):
        out = DeepVCP._knn(reg.model, ref, query, chunked)
        picked.append(out[1])
        return out

    reg.model._knn = record
    try:
        out_d = reg(src, tgt)
    finally:
        del reg.model._knn
    cfg, card = reg_cpu.model.cfg, iter(picked)
    rows = ties = 0

    def pin(ref, query, chunked):
        nonlocal rows, ties
        dist, idx = DeepVCP._knn(reg_cpu.model, ref, query, chunked)
        idx_d = next(card).cpu()
        differ = (torch.sort(idx, -1).values != torch.sort(idx_d, -1).values).any(-1)
        for b, m in differ.nonzero().tolist():
            swapped = sorted(set(idx[b, m].tolist()) ^ set(idx_d[b, m].tolist()))
            rows += 1
            ties += selection_near_tie(cfg, ref, query, b, m, idx.shape[-1], swapped)
        return dist, idx_d

    reg_cpu.model._knn = pin
    try:
        out_c = reg_cpu(src.cpu(), tgt.cpu())
    finally:
        del reg_cpu.model._knn
    if len(picked) == 0 or next(card, None) is not None:
        fail(f"{what}: the card and the CPU made different numbers of candidate selections")
    print(f"{what} pair 0: candidate selections, card vs CPU: {len(picked)} calls, {rows} "
          f"query rows differ, {ties} of them only at a near-tie of the k-th distance "
          f"(the CPU then takes the card's rows)")
    if ties != rows:
        fail(f"{what}: candidate selections differ away from a near-tie")
    return out_d, out_c


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


def windowed_training(torch, dev, total: dict) -> None:
    """Phase 21, windowed training: 2 Trainer steps of model_q5w at N = 2048
    under its campaign recipe (residual_tcfg,
    scripts/campaign_r4_common.py:85) on the first 2 of its training clouds."""
    import numpy as np

    from deepvcp_tpu_torch import convert, pretrained
    from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator
    from deepvcp_tpu_torch.train import MetricsLogger, TrainConfig, Trainer

    records = []

    class Records(MetricsLogger):
        def log(self, record):
            records.append(record)

    tcfg = TrainConfig(batch_size=1, learning_rate=1e-3, vcp_loss_weight=1.0,
                       lr_schedule="cosine", warmup_steps=100, total_steps=768,
                       use_saliency_weights=True, init_translation="gt",
                       init_rot_jitter_deg=12.0, init_trans_jitter=0.5, log_every=1)
    name = "campaign_r4b-q5w"
    trainer = Trainer(pretrained.campaign_config(name), tcfg, device=dev,
                      metrics=Records(None, echo=False))
    trainer.setup()
    trainer.model.load_state_dict(convert.flax_to_torch(pretrained.load_variables(name)),
                                  strict=True)
    data = SyntheticDataset(num_clouds=2, num_points=2048, extent=1.0, seed=0)
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


def dp_setup(torch, dev):
    """Phase 22's step inputs, the same in every process: kitti25-rot under
    its recipe (fine_tuning), one B = 2 batch of 25 m lidar-like pairs, at
    step DP_STEP (past the warmup: lr > 0). Returns (trainer, recipe, the
    saved model and optimizer state, the batch on dev)."""
    from deepvcp_tpu_torch.data import LidarLikeDataset, batch_iterator

    trainer, tcfg, _, _, saved = fine_tuning("kitti25-rot", {}, 1, dev)
    data = LidarLikeDataset(num_clouds=2, num_points=N_POINTS, max_range=25.0, seed=12)
    batch = tuple(torch.from_numpy(a).to(dev) for a in next(batch_iterator(data, 2, seed=0)))
    return trainer, tcfg, saved, batch


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
    K1 and K2. Returns (its launches, the unsharded step's result, lr)."""
    from deepvcp_tpu_torch.train import make_train_step
    from deepvcp_tpu_torch.train.optim import learning_rate_schedule

    trainer, tcfg, saved, batch = dp_setup(torch, dev)
    schedule = learning_rate_schedule(tcfg)
    model = trainer.model
    plain = make_train_step(model, schedule, tcfg)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = step_result(torch, trainer, plain, saved, batch)
            sharded = make_train_step(model, schedule, tcfg, mesh=mesh)
            got, counts = counted_all(
                torch, lambda: step_result(torch, trainer, sharded, saved, batch))
            ms = {what: host_median_ms(torch, lambda: step_result(torch, trainer, fn, saved, batch),
                                       reps=3)
                  for what, fn in (("unsharded", plain), ("sharded", sharded))}
    finally:
        torch.use_deterministic_algorithms(False)
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


def ring_on_card(torch, dev, reg, pair, mesh) -> None:
    """Phase 22, the op: ring_knn over a point group of one rank on
    kitti25-rot's candidate query of pair 0 (K * C = 13 824 queries, N =
    10 000, k = num_neighbors) against the port's exact knn: the neighbour
    sets equal but for rows whose differing members tie in distance
    (counted)."""
    from deepvcp_tpu_torch.ops import knn
    from deepvcp_tpu_torch.ops.distributed import ring_knn

    model = reg.model
    src, tgt, R_gt, t_gt = pair
    with torch.no_grad():
        enc = model.encode(src, tgt)
        _, cand = model.candidates(enc, R_gt, t_gt)
    query = cand.reshape(cand.shape[0], -1, 3)
    k = model.cfg.num_neighbors
    d_r, i_r = ring_knn(mesh, enc.tgt_xyz, query, k)
    d_k, i_k = knn(enc.tgt_xyz, query, k)
    differ = (torch.sort(i_r, dim=-1).values != torch.sort(i_k, dim=-1).values).any(-1)
    d_err = (d_r - d_k).abs().max().item()
    ties_ok = bool(torch.equal(torch.sort(d_r[differ], -1).values,
                               torch.sort(d_k[differ], -1).values))
    ring_ms = cuda_median_ms(torch, lambda: ring_knn(mesh, enc.tgt_xyz, query, k), reps=10)
    knn_ms = cuda_median_ms(torch, lambda: knn(enc.tgt_xyz, query, k), reps=10)
    print(f"ring_knn, one point rank, {query.shape[1]} queries x {enc.tgt_xyz.shape[1]} points, "
          f"k={k}: rows differing from knn {int(differ.sum())} (each a distance tie: {ties_ok}), "
          f"distances max|d| {d_err:.2e}; {ring_ms:.3f} ms against knn's {knn_ms:.3f} ms "
          f"(CUDA events)")
    if d_err > 0 or not ties_ok:
        fail("ring_knn over one rank differs from the exact knn beyond distance ties")


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
    shards) give the values they must; raises otherwise, which fails the
    rank and the phase."""
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    y = torch.full((4,), float(rank + 1), device=dev)
    dist.broadcast(y, 0)
    parts = [torch.empty(4, device=dev) for _ in range(world)]
    dist.all_gather(parts, torch.full((4,), float(rank), device=dev))
    want = world * (world + 1) / 2
    if not (bool((x == want).all()) and bool((y == 1.0).all()) and all(
            bool((p == r).all()) for r, p in enumerate(parts))):
        raise RuntimeError(f"gloo collectives on CUDA tensors gave all_reduce {x.tolist()}, "
                           f"broadcast {y.tolist()}, all_gather {[p.tolist() for p in parts]}")
    print(f"rank {rank}: gloo all_reduce, broadcast and all_gather on {dev} tensors: right",
          flush=True)


def two_rank_body(graph) -> dict:
    """One of phase 22's two gloo ranks on cuda:0 (run by
    parallel.launch.run_ranks): first gloo_on_card's check of the
    collectives on CUDA tensors, then a 2 x 1 mesh; this rank's B = 1 of
    dp_setup's batch through make_train_step(mesh=...) (its K1 / K2
    launches counted and printed), and the sharded solves."""
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
    result, counts = counted_all(torch, lambda: step_result(torch, trainer, step, saved, local))
    print(f"rank {dist.get_rank()}: K1 {counts['k1']}, K2 {counts['k2']} launches in its step "
          f"(B={local[0].shape[0]})", flush=True)
    return {**result, "counts": counts, **solves(torch, solve_inputs(torch, graph, dev), mesh)}


def two_ranks_on_card(torch, ref: dict, lr: float, graph, solved: dict) -> dict:
    """Phase 22, part 2: two gloo ranks sharing cuda:0 (gloo takes CUDA
    tensors for all_reduce and broadcast, the only collectives of these
    paths). The data-parallel step, each rank B = 1 of the B = 2 batch,
    against the single-process B = 2 step `ref`: loss within DP_LOSS_RTOL,
    grad norm within DP_GRAD_RTOL, RRE within DP_RRE_ATOL, parameters
    within SHARDED_PARAM_LR x lr, running statistics within DP_STAT_RTOL of
    each tensor's max, the ranks equal, LAUNCHES_PER_CALL K1 and K2 a rank;
    the sharded solves against the unsharded `solved`. A rank that fails or
    outlasts TWO_RANK_TIMEOUT_S fails the phase. Returns the two ranks'
    launches."""
    from deepvcp_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks("chip_smoke:two_rank_body", 2, kwargs={"graph": graph}, device="cuda",
                      backend="gloo", timeout_s=TWO_RANK_TIMEOUT_S, echo=True)
    m_p = ref["metrics"]
    for r, got in enumerate(ranks):
        m = got["metrics"]
        loss_rel = abs(m["loss"] - m_p["loss"]) / abs(m_p["loss"])
        norm_rel = abs(m["grad_norm"] - m_p["grad_norm"]) / m_p["grad_norm"]
        rre_err = abs(m["rre_deg"] - m_p["rre_deg"])
        param_err = max((got["params"][n] - p).abs().max().item()
                        for n, p in ref["params"].items())
        stat_rel = max((got["stats"][n] - s).abs().max().item() / s.abs().max().item()
                       for n, s in ref["stats"].items())
        print(f"rank {r} of 2 (gloo, cuda:0, B=1 each) vs the single-process B=2 step: loss "
              f"{m['loss']:.7f} vs {m_p['loss']:.7f} (rel {loss_rel:.2e}), grad norm rel "
              f"{norm_rel:.2e}, RRE {m['rre_deg']:.4f} vs {m_p['rre_deg']:.4f} deg, parameters "
              f"max|d| {param_err:.3e} ({param_err / lr:.3f} lr), running statistics within "
              f"{stat_rel:.2e} of their max")
        if (loss_rel > DP_LOSS_RTOL or norm_rel > DP_GRAD_RTOL or rre_err > DP_RRE_ATOL
                or param_err > SHARDED_PARAM_LR * lr or stat_rel > DP_STAT_RTOL):
            fail(f"rank {r}'s data-parallel step disagrees with the single-process step")
        if got["counts"]["k1"] != LAUNCHES_PER_CALL or got["counts"]["k2"] != LAUNCHES_PER_CALL:
            fail(f"rank {r}: expected {LAUNCHES_PER_CALL} K1 and K2 launches in its step")
        solves_agree(torch, got, solved, f"rank {r}'s sharded solves over 2 ranks")
    if ranks[0]["metrics"] != ranks[1]["metrics"] or any(
            not torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]) for n in ref["params"]):
        fail("the two ranks took different steps")
    print(f"two gloo ranks on cuda:0: {time.perf_counter() - t0:.1f} s, process starts included")
    return {k: sum(got["counts"][k] for got in ranks) for k in ("k1", "k2")}


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
    does not take on CUDA tensors, so it is held on the CPU by the tests).
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
    two = two_ranks_on_card(torch, ref, lr, graph, solved)
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")
    return {k: step[k] + tools[k] + two[k] for k in ("k1", "k2")}


def main() -> None:
    started = time.perf_counter()
    # cuBLAS reads this when it starts; the train-path comparison (phase 9)
    # runs under deterministic algorithms, which need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")

    # the port itself: an ImportError here (no checkout around the script)
    # ends the run before anything is printed
    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.data import (
        LidarLikeDataset, batch_iterator, rotation_geodesic_deg, translation_error)
    from deepvcp_tpu_torch.ops.kernels import _build
    from deepvcp_tpu_torch.ops.kernels.band_max import banded_masked_max

    card = card_line()
    print(f"card: {card}")
    print(f"toolchain: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({_build.build()})")

    # 3. K1 and K2 against their plain versions
    band = band_phase(torch, dev)

    # 4. the main path: Registrar on kitti25-rot, 16 held-out pairs
    reg = pretrained.registrar("kitti25-rot", device=dev)
    held = LidarLikeDataset(num_clouds=N_PAIRS, num_points=N_POINTS, max_range=25.0,
                            seed=110, max_rotation_deg=5.0, max_translation=0.5)
    pairs = [tuple(torch.from_numpy(a).to(dev) for a in batch)
             for batch in batch_iterator(held, 1, epoch=0, seed=0, shuffle=False)]
    torch.cuda.synchronize()
    banded_masked_max.launches = 0
    outs = [reg(src, tgt) for src, tgt, _, _ in pairs]
    torch.cuda.synchronize()
    launches = banded_masked_max.launches
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

    # 7. timing (not gated)
    exact = {"rre": mean_rre, "rte": mean_rte, "latency": registrar_timing(
        torch, reg, src, tgt, "kitti25-rot", reps=20, plain_reps=10)}
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

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

    (k1_bound, k1_by), (k2_bound, k2_by) = band["k1_bound"], band["k2_bound"]
    print(f"bounds at the 3 serving SA shapes: K1 {k1_bound:.5f} ms ({k1_by}), K2 {k2_bound:.5f} "
          f"ms ({k2_by}); K3 at one init call's 2 shapes {k3['bound_ms']:.5f} ms "
          f"({k3['bound_by']})")

    # 11. no jax, nothing of the JAX package
    imported = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "deepvcp_tpu"))
    if imported:
        fail(f"jax or the JAX package was imported: {imported[:8]}")
    print("jax imported: no; deepvcp_tpu imported: no")
    print(f"smoke run: {time.perf_counter() - started:.1f} s")

    print(card)
    # ms / plain_ms / bound_ms: K1 and K2 sums at the 3 SA shapes (one FE
    # pass, or one FE backward), K3 sums at the 2 shapes of one init call,
    # K4 and K5 at the two-level path's shapes (library_ms: torch.gather,
    # torch.scatter_add); launches: the main-path runs' (serving, training,
    # global, two-level serving and training, odometry, the engines,
    # multi-device)
    print(json.dumps({"kernels": [{
        "name": "banded_masked_max",
        "route": "cuda",
        "source": "deepvcp_tpu_torch/csrc/band_max.cu",
        "replaces": "deepvcp_tpu/ops/pallas/band_max_kernel.py:148",
        "launches": (launches + train["k1"] + glob["k1"] + two["k1"] + two_train["k1"]
                     + odo["k1"] + eng["k1"] + multi["k1"]),
        "max_abs_err": band["k1_err"],
        "ms": band["k1_ms"],
        "plain_ms": band["k1_plain_ms"],
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
    }, {
        "name": "banded_masked_max_grad",
        "route": "cuda",
        "source": "deepvcp_tpu_torch/csrc/band_max_grad.cu",
        "replaces": "deepvcp_tpu/ops/pallas/band_max_kernel.py:267",
        "launches": train["k2"] + two_train["k2"] + eng["k2"] + multi["k2"],
        "max_abs_err": band["k2_err"],
        "ms": band["k2_ms"],
        "plain_ms": band["k2_plain_ms"],
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
    }, {
        "name": "farthest_point_sample",
        "route": "cuda",
        "source": "deepvcp_tpu_torch/csrc/fps.cu",
        "replaces": "deepvcp_tpu/ops/pallas/fps_kernel.py:81",
        "launches": glob["k3"] + eng["k3"],
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
        ("onehot_scatter_add", "K5", 156, two_train["k5"] + eng["k5"]))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
