#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepvcp_tpu_torch) on one CUDA card.

Drives the port's four paths at full width (N = 10 000 points, 64
keypoints, 216 candidates, 32 neighbours): serving,
`pretrained.registrar("kitti25-rot")` on 16 held-out synthetic lidar pairs;
training, 12 fine-tuning steps of `kitti25-rot` through `train.Trainer`
under the recipe that trained it; global registration of pairs with
any rotation, `initializer.so3_global_init` then
`pretrained.cascade("modelnet-cascade")`, on two held sets of 16 pairs
(B = 2); and the two-level candidate grouping, serving and fine-tuning
`kitti25` through kernels K4/K5. It checks on the way:

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


def turns_ms(torch, fns: dict, reps: int, rounds: int = 4, hold: bool = False) -> dict:
    """CUDA-event times of each of `fns` ({name: fn}), taken in turns (a, b,
    b, a, ...) over `rounds` rounds of `reps` runs each: {name: the rounds'
    medians}."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(cuda_median_ms(torch, fns[name], reps=reps, hold=hold))
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
                tnb = gather_table_rows(table, l_idx)
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
    scale = {n: own[n] if own[n] >= CANCEL_FRAC * norm_p else norm_p for n in own}
    rel_kp = {n: e / scale[n] for n, e in err_kp.items()}
    cancelling = sorted(n for n in own if scale[n] == norm_p)
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

    from deepvcp_tpu_torch.ops.kernels import band_max
    from deepvcp_tpu_torch.ops.kernels import onehot_gather as og
    from deepvcp_tpu_torch.train import build_train_step
    from deepvcp_tpu_torch.train.optim import learning_rate_schedule

    trainer, tcfg, records, batches, saved = fine_tuning("kitti25", TWO_LEVEL, TWO_LEVEL_STEPS,
                                                         dev)
    wrappers = {"k1": band_max.banded_masked_max, "k2": band_max.banded_masked_max_grad,
                "k4": og.onehot_gather, "k5": og.onehot_scatter_add}
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    trainer.train_epoch(iter(batches), epoch=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
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


def main() -> None:
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
    registrar_timing(torch, reg, src, tgt, "kitti25-rot", reps=20, plain_reps=10)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # 8-10. the training path
    train = train_phase(torch, dev, pairs)

    # 12-15. FPS and the global path
    k3 = k3_phase(torch, dev)
    glob = global_phase(torch, dev)

    # 16-19. the two-level path: K4/K5, serving, paths, training
    two = two_level_phase(torch, dev, pairs)
    two_train = two_level_training(torch, dev)

    (k1_bound, k1_by), (k2_bound, k2_by) = band["k1_bound"], band["k2_bound"]
    print(f"bounds at the 3 serving SA shapes: K1 {k1_bound:.5f} ms ({k1_by}), K2 {k2_bound:.5f} "
          f"ms ({k2_by}); K3 at one init call's 2 shapes {k3['bound_ms']:.5f} ms "
          f"({k3['bound_by']})")

    # 11. no jax, nothing of the JAX package
    imported = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "deepvcp_tpu"))
    if imported:
        fail(f"jax or the JAX package was imported: {imported[:8]}")
    print("jax imported: no; deepvcp_tpu imported: no")

    print(card)
    # ms / plain_ms / bound_ms: K1 and K2 sums at the 3 SA shapes (one FE
    # pass, or one FE backward), K3 sums at the 2 shapes of one init call,
    # K4 and K5 at the two-level path's shapes (library_ms: torch.gather,
    # torch.scatter_add); launches: the main-path runs' (serving, training,
    # global, two-level serving and training)
    print(json.dumps({"kernels": [{
        "name": "banded_masked_max",
        "route": "cuda",
        "source": "deepvcp_tpu_torch/csrc/band_max.cu",
        "replaces": "deepvcp_tpu/ops/pallas/band_max_kernel.py:148",
        "launches": launches + train["k1"] + glob["k1"] + two["k1"] + two_train["k1"],
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
        "launches": train["k2"] + two_train["k2"],
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
        "launches": glob["k3"],
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
        ("onehot_gather", "K4", 74, two["k4"] + two_train["k4"]),
        ("onehot_scatter_add", "K5", 156, two_train["k5"]))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
