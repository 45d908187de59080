#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepvcp_tpu_torch) on one CUDA card.

Drives the port's serving path, `pretrained.registrar("kitti25-rot")` at full
width (N = 10 000 points, 64 keypoints, 216 candidates, 32 neighbours), on 16
held-out synthetic lidar pairs, and checks on the way:

  1. device      a CUDA card is present; prints nvidia-smi's name and power limit
  2. build       builds every CUDA kernel of the path from csrc/ with nvcc
  3. kernels     each kernel against its plain PyTorch version at the path's
                 shapes: max abs difference (must be 0.0) and median times
  4. registrar   16 pairs, GT-free RRE / RTE against the identity-init errors;
                 mean RRE <= 1.0 deg and mean RTE <= 0.05 m
  5. paths       kernel path against plain path on pair 0: same keypoints,
                 |dR| <= 1e-4, |dt| <= 1e-4 m, |dscores| <= 1e-5
  6. launches    the kernel ran 6 times per Registrar call in step 4
  7. timing      per-call latency and a CUDA-event stage split (printed only)
  8. no jax      jax was never imported

Any failure exits non-zero. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels as JSON.
Run from the root of a checkout, with no arguments:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N_POINTS = 10000
N_PAIRS = 16
SA_SHAPES = ((16, 0.1), (32, 0.2), (64, 0.4))   # (C, radius) of the 3 SA stages
LAUNCHES_PER_CALL = 2 * len(SA_SHAPES)           # 3 SA stages x 2 clouds
RRE_LIMIT_DEG, RTE_LIMIT_M = 1.0, 0.05


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


def cuda_median_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` runs, from CUDA events."""
    for _ in range(warmup):
        fn()
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
    """Kernel time per call of fn() from torch.profiler (summed over every
    CUDA kernel), and the 8 kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key[:60], e.self_device_time_total / 1e3 / calls)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(ms for _, ms in rows), sorted(rows, key=lambda r: -r[1])[:8]


def stage_split(torch, reg, src, tgt) -> dict:
    """Device time of each stage of one Registrar call, replaying its steps
    through the model's public pieces between CUDA events."""
    from deepvcp_tpu_torch.loss import svd_refine

    m = reg.model
    ev = []

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append(e)

    stages = {"fe_x2": 0.0, "keypoints_src_dfe": 0.0, "candidate_knn": 0.0,
              "gather_dfe_cpg": 0.0, "svd_solve_guard": 0.0}
    with torch.no_grad():
        mark()
        m.features(src)
        m.features(tgt)
        mark()
        enc = m.encode(src, tgt)   # runs FE x2 again; the difference is the rest
        mark()
        B = src.shape[0]
        R = torch.eye(3, device=src.device).expand(B, 3, 3)
        t = torch.zeros(B, 3, device=src.device)
        best = reg.score(enc.keypoints, enc.tgt_xyz, R, t)
        spans = []
        for _ in range(reg.refine_iters):
            s0 = len(ev)
            mark()
            cand = m.candidates(enc, R, t)
            idx = m.candidate_neighbors(enc, cand)
            mark()
            vcp, _ = m.match(enc, cand, idx, R)
            mark()
            w = enc.keypoint_saliency if reg.use_saliency_weights else None
            ref = svd_refine(enc.keypoints, vcp, reg.inlier_ratio, w)
            s = reg.score(enc.keypoints, enc.tgt_xyz, ref.R, ref.t)
            better = s < best
            R = torch.where(better[:, None, None], ref.R, R)
            t = torch.where(better[:, None], ref.t, t)
            best = torch.minimum(s, best)
            mark()
            spans.append(s0)
    torch.cuda.synchronize()
    fe = ev[0].elapsed_time(ev[1])
    stages["fe_x2"] = fe
    stages["keypoints_src_dfe"] = ev[1].elapsed_time(ev[2]) - fe
    for s0 in spans:
        stages["candidate_knn"] += ev[s0].elapsed_time(ev[s0 + 1])
        stages["gather_dfe_cpg"] += ev[s0 + 1].elapsed_time(ev[s0 + 2])
        stages["svd_solve_guard"] += ev[s0 + 2].elapsed_time(ev[s0 + 3])
    return stages


def main() -> None:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")

    # the port itself: an ImportError here (no checkout around the script)
    # ends the run before anything is printed
    import numpy as np

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.data import (
        LidarLikeDataset, batch_iterator, lidar_like_cloud,
        rotation_geodesic_deg, translation_error)
    from deepvcp_tpu_torch.ops.kernels import _build, band_max
    from deepvcp_tpu_torch.ops.kernels.band_max import (
        banded_masked_max, banded_masked_max_reference)

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

    # 3. kernel vs plain at the three SA shapes
    rng = np.random.default_rng(0)
    xyz = lidar_like_cloud(rng, N_POINTS, max_range=25.0).astype(np.float32)
    x = torch.from_numpy(xyz[np.argsort(xyz[:, 0], kind="stable")][None]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    k1_err, k1_ms, k1_plain_ms = 0.0, 0.0, 0.0
    for C, r in SA_SHAPES:
        u = torch.randn(1, N_POINTS, C, device=dev, generator=gen)
        got = banded_masked_max(x, u, r)
        want = banded_masked_max_reference(x, u, r)
        err = (got - want).abs().max().item()
        if not torch.isfinite(got).all() or err != 0.0:
            fail(f"K1 disagrees with its plain version at C={C}, r={r}: max abs {err}")
        ms = cuda_median_ms(torch, lambda: banded_masked_max(x, u, r), reps=50)
        plain = cuda_median_ms(torch, lambda: banded_masked_max_reference(x, u, r), reps=20)
        print(f"K1 banded_masked_max N={N_POINTS} C={C} r={r}: max_abs_err {err} | "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms (median, CUDA events)")
        k1_err = max(k1_err, err)
        k1_ms += ms
        k1_plain_ms += plain

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
    rre, rte, rre0, rte0 = [], [], [], []
    for i, (out, (src, tgt, R_gt, t_gt)) in enumerate(zip(outs, pairs)):
        shapes = {"R": (1, 3, 3), "t": (1, 3), "keypoints": (1, 64, 3), "vcps": (1, 64, 3),
                  "saliency": (1, N_POINTS), "scores": (1, reg.refine_iters + 1)}
        for field, shape in shapes.items():
            val = getattr(out, field)
            if tuple(val.shape) != shape or not torch.isfinite(val).all():
                fail(f"pair {i}: {field} has shape {tuple(val.shape)} (want {shape}) "
                     f"or non-finite values")
        eye = torch.eye(3, device=dev)
        if (out.R[0] @ out.R[0].T - eye).abs().max() > 1e-4 or abs(torch.det(out.R[0]) - 1) > 1e-4:
            fail(f"pair {i}: R is not a rotation")
        rre.append(rotation_geodesic_deg(out.R, R_gt).item())
        rte.append(translation_error(out.t, t_gt).item())
        rre0.append(rotation_geodesic_deg(eye[None], R_gt).item())
        rte0.append(translation_error(torch.zeros_like(t_gt), t_gt).item())
        print(f"pair {i:2d}: RRE {rre[-1]:.4f} deg, RTE {rte[-1]:.5f} m | identity init "
              f"{rre0[-1]:.4f} deg, {rte0[-1]:.5f} m | best score {out.scores.min().item():.5f}")
    mean_rre, mean_rte = statistics.mean(rre), statistics.mean(rte)
    print(f"kitti25-rot GT-free over {N_PAIRS} pairs (refine_iters={reg.refine_iters}, "
          f"exact selection): mean RRE {mean_rre:.4f} deg, mean RTE {mean_rte:.5f} m | "
          f"identity init {statistics.mean(rre0):.4f} deg, {statistics.mean(rte0):.5f} m")
    if not (mean_rre <= RRE_LIMIT_DEG and mean_rte <= RTE_LIMIT_M):
        fail(f"accuracy: mean RRE {mean_rre} > {RRE_LIMIT_DEG} or RTE {mean_rte} > {RTE_LIMIT_M}")

    # 5. kernel path vs plain path, pair 0
    src, tgt = pairs[0][0], pairs[0][1]
    with torch.no_grad():
        enc_k = reg.model.encode(src, tgt)
        out_k = reg(src, tgt)
        with band_max.reference_path():
            enc_p = reg.model.encode(src, tgt)
            out_p = reg(src, tgt)
    if not torch.equal(enc_k.keypoint_idx, enc_p.keypoint_idx):
        fail("kernel and plain paths chose different keypoints")
    if not torch.equal(out_k.keypoints, out_p.keypoints):
        fail("kernel and plain paths returned different keypoints")
    dR = (out_k.R - out_p.R).abs().max().item()
    dt = (out_k.t - out_p.t).abs().max().item()
    ds = (out_k.scores - out_p.scores).abs().max().item()
    print(f"kernel vs plain path, pair 0: keypoint indices identical, max|dR| {dR:.3e}, "
          f"max|dt| {dt:.3e} m, max|dscores| {ds:.3e}")
    if dR > 1e-4 or dt > 1e-4 or ds > 1e-5:
        fail("kernel path and plain path disagree")

    # 6. launch count of the main-path run in step 4
    print(f"K1 launches in the main-path run: {launches} over {N_PAIRS} Registrar calls "
          f"({launches / N_PAIRS:g} per call)")
    if launches != LAUNCHES_PER_CALL * N_PAIRS:
        fail(f"expected {LAUNCHES_PER_CALL} K1 launches per call, got {launches / N_PAIRS:g}")

    # 7. timing (not gated)
    lat = host_median_ms(torch, lambda: reg(src, tgt), reps=20)
    with band_max.reference_path():
        lat_plain = host_median_ms(torch, lambda: reg(src, tgt), reps=10)
    print(f"Registrar per-call latency, B=1, N={N_POINTS}: kernel path {lat:.3f} ms, "
          f"plain path {lat_plain:.3f} ms (median of synced calls)")
    splits = [stage_split(torch, reg, src, tgt) for _ in range(6)][1:]
    split = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    print("stage split (device ms, median of 5 replays): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f" | sum {sum(split.values()):.3f}")
    busy, top = device_time_per_call(torch, lambda: reg(src, tgt), calls=5)
    if busy > 0:
        print(f"device busy per call (torch.profiler kernel time): {busy:.3f} ms of "
              f"{lat:.3f} ms latency, idle share {1 - busy / lat:.3f}")
        print("top kernels (ms per call): " + "; ".join(f"{k} {v:.3f}" for k, v in top))
    else:
        print("device busy per call: not measured (the profiler saw no device time)")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # 8. no jax
    if "jax" in sys.modules:
        fail("jax was imported")
    print("jax imported: no")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "banded_masked_max",
        "route": "cuda",
        "source": "deepvcp_tpu_torch/csrc/band_max.cu",
        "replaces": "deepvcp_tpu/ops/pallas/band_max_kernel.py:148",
        "launches": launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,         # sum of the medians at the 3 SA shapes: one FE pass
        "plain_ms": k1_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
