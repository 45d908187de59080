"""Per-stage latency and roofline report of the registration forward (port
of deepvcp_tpu/profile_stages.py): the same stages, each timed alone on
synthetic inputs of its shapes and scored against the H100's published
peaks.

    python -m deepvcp_tpu_torch.profile_stages --num-points 10000 [--batch B]
        [--cpu] [--tiny]

`profile_stages(model, batch, device)` profiles any DeepVCP (chip_smoke
phase 22 passes the kitti25-rot registrar's); the CLI's is randomly
initialised, as the JAX script's.

Timing: on the card each stage is called `reps` times behind a device hold
(torch.cuda._sleep), with CUDA events around each call, so that the events
time the device's work and not the host's issue; the median is reported
(chip_smoke.cuda_median_ms with hold=True). An event recorded right after
the hold tells whether the hold was still running when the last call had
been issued; if it was not, the calls may have waited for the host, and
the stage is timed again behind a hold 4 times as long, up to
HOLD_TRIES holds. A stage whose longest hold ran out too (one that waits
for the device within a call, as voxelize's copy to the card does) keeps that
reading with the bound "host" and no roofline shares: its time is not the
device's alone. On the CPU, the median wall time of a
call.

Counting (torch has no counterpart of XLA's cost_analysis, so each stage's
work is counted from the code and its shapes, not from the data):
- bytes: every input read once and every output written once (a gather's
  output rows are also its reads);
- operations: 2 per multiply-add of a dense layer, convolution or distance
  product; 3 per pair of a distance tile for the |a|^2 + |b|^2 - 2ab
  combination and 1 per compared element of a top-k, max or softmax; the
  band max of an SA stage compares each channel of a point with the
  2 * window + 1 points of its sorted window (window_for of the stage's N,
  the static band's coverage); the pose solve counts the products of its two
  Kabsch solves and residuals (a 3x3 SVD as 0).
The bound column names the larger share of the H100's HBM rate and f32
(non-tensor-core) rate; a stage under 5% of both is "overhead". On the CPU
the shares are not computed (null, bound "cpu"), nor for a stage whose
holds all ran out (null, bound "host").
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA datasheet): HBM3 bytes/s and float32
# (non-tensor-core) operations/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
HOLD_CYCLES = 20_000_000   # ~10 ms of the card's clock; each retry holds 4x longer
HOLD_TRIES = 4


def card_name() -> str:
    """nvidia-smi's name and power limit of the first card, or "no card"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no card"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no card"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _mlp_ops(rows: int, widths, in_features: int) -> int:
    ops, prev = 0, in_features
    for w in widths:
        ops += 2 * rows * prev * w
        prev = w
    return ops


def _fe_ops(cfg, B: int, N: int) -> int:
    from deepvcp_tpu_torch.ops.neighbors import window_for

    ops, prev = 0, 0
    for layer in cfg.sa_layers:
        c0 = layer.mlp[0]
        ops += 2 * B * N * (3 + prev) * c0                      # per-point projections
        window = window_for(N, layer.radius, cfg.spatial_extent, cfg.window_safety)
        ops += B * N * (2 * window + 1) * c0                    # band max compares
        ops += _mlp_ops(B * N, layer.mlp[1:], c0)
        prev = layer.mlp[-1]
    return ops + 2 * B * N * prev * cfg.feat_dim


def _tile_ops(rows: int, cols: int, k_select: bool = True) -> int:
    """A distance tile's product (2 x 3 per pair), combination (3) and
    selection (1 per element)."""
    return rows * cols * (6 + 3 + (1 if k_select else 0))


def _time(fn: Callable, reps: int, device: torch.device) -> Tuple[float, bool]:
    """(median ms of a call, whether the device's work alone was timed:
    always False on the CPU; on the card, whether a hold outlasted the
    issue of every call)."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), False
    for attempt in range(HOLD_TRIES):
        torch.cuda.synchronize(device)
        torch.cuda._sleep(HOLD_CYCLES * 4 ** attempt)
        held = torch.cuda.Event()
        held.record()
        events = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        ran_out = held.query()
        torch.cuda.synchronize(device)
        ms = statistics.median(s.elapsed_time(e) for s, e in events)
        if not ran_out:
            return ms, True
    return ms, False


@torch.no_grad()
def profile_stages(model, batch: int, device: torch.device, reps: int = 10,
                   seed: int = 0) -> Dict:
    """Time every stage of `model`'s forward (a DeepVCP in eval mode on
    `device`) at its config's N and `batch`, and count its work.
    Returns {"batch", "stages_ms", "roofline"} as the JAX report's JSON."""
    from deepvcp_tpu_torch.loss import svd_refine
    from deepvcp_tpu_torch.ops import approx_knn, index_points, voxelize
    from deepvcp_tpu_torch.ops.two_level import two_level_rows

    cfg = model.cfg
    B, N = batch, cfg.num_points
    K, ns, C, F = cfg.num_keypoints, cfg.num_neighbors, cfg.num_candidates, cfg.feat_dim
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, uniform=False):
        a = rng.uniform(-10, 10, shape) if uniform else scale * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(device)

    src, tgt = t(B, N, 3, uniform=True), t(B, N, 3, uniform=True)
    feats = t(B, N, F)
    kp = src[:, :K].contiguous()
    cand = voxelize(kp, cfg.search_radius, cfg.voxel_len, centered=cfg.centered_grid)
    cand_flat = cand.reshape(B, K * C, 3)
    table = torch.cat([tgt, feats], dim=-1)
    rows_idx = torch.from_numpy(rng.integers(0, N, (B, K * C, ns))).to(device)
    src_cat, tgt_cat = t(B, K, ns, 3 + F), t(B, K, C, ns, 3 + F)
    src_desc, tgt_desc = t(B, K, F), t(B, K, C, F)
    vcp = kp + t(B, K, 3, scale=0.1)
    T = min(cfg.tgt_knn_table, N)
    two = model.two_level_args()
    dfe_out = cfg.dfe_mlp[-1]
    conv_ops, prev = 0, dfe_out
    for ch in cfg.cpg_channels:
        conv_ops += 2 * B * K * C * 27 * prev * ch
        prev = ch
    kabsch_ops = 2 * (2 * B * K * 3 * 3 + 2 * B * K * 3) + 2 * B * K * 9

    # name: (call, the inputs it reads whole, operations)
    stages: Dict[str, Tuple[Callable, tuple, int]] = {
        "fe(src)": (lambda: model.fe(src, None), (src,), _fe_ops(cfg, B, N)),
        "fe(tgt)": (lambda: model.fe(tgt, None), (tgt,), _fe_ops(cfg, B, N)),
        "weighting": (lambda: model.wl(feats), (feats,), _mlp_ops(B * N, cfg.wl_mlp, F)),
        "candidate knn": (
            lambda: approx_knn(tgt, cand_flat, ns, **model.select_args(chunked=True)),
            (tgt, cand_flat), _tile_ops(B * K * C, N)),
        "row gather": (lambda: index_points(table, rows_idx), (rows_idx,), 0),
        "two-level rows": (
            lambda: two_level_rows(tgt, table, kp, cand, ns, table_size=two["table_size"],
                                   select_dtype=two["select_dtype"],
                                   center_select_dtype=two["center_select_dtype"],
                                   use_kernel=two["use_kernel"]),
            (tgt, kp, cand), _tile_ops(B * K, N) + _tile_ops(B * K * C, T)),
        "dfe(src)": (lambda: model.dfe(src_cat), (src_cat,),
                     _mlp_ops(B * K * ns, cfg.dfe_mlp, 3 + F) + B * K * ns * dfe_out),
        "dfe(tgt)": (lambda: model.dfe(tgt_cat), (tgt_cat,),
                     _mlp_ops(B * K * C * ns, cfg.dfe_mlp, 3 + F) + B * K * C * ns * dfe_out),
        "cpg": (lambda: model.cpg(src_desc, tgt_desc, cand), (src_desc, tgt_desc, cand),
                2 * B * K * C * dfe_out + conv_ops + 3 * B * K * C + 2 * B * K * C * 3),
        "svd solve": (lambda: svd_refine(kp, vcp)[:2], (kp, vcp), kabsch_ops),
    }
    best, table_out = {}, {}
    for name, (fn, inputs, ops) in stages.items():
        out = fn()
        outs = out if isinstance(out, tuple) else (out,)
        moved = _nbytes(*inputs) + _nbytes(*outs)
        if name == "row gather":
            moved += _nbytes(*outs)          # the gathered rows are read too
        ms, on_device = _time(fn, reps, device)
        best[name] = ms
        sec = ms / 1e3
        pf = pb = None
        bound = "cpu" if device.type != "cuda" else "host"
        if on_device:
            pf = 100.0 * ops / sec / PEAK_FLOPS
            pb = 100.0 * moved / sec / PEAK_BYTES
            bound = "compute" if pf >= max(pb, 5.0) else "bandwidth" if pb >= 5.0 else "overhead"
        table_out[name] = {"ms": ms, "gflop": ops / 1e9, "gb": moved / 1e9,
                           "pct_peak_flops": pf, "pct_peak_bw": pb, "bound": bound}
    return {"batch": B, "stages_ms": best, "roofline": table_out}


def report(result: Dict) -> str:
    rows = result["roofline"]
    total = sum(result["stages_ms"].values())
    lines = [f"{'stage':16s} {'ms':>8s} {'%':>6s} {'GFLOP':>9s} {'GB':>8s}"
             f" {'TFLOP/s':>8s} {'GB/s':>7s} {'%flops':>7s} {'%bw':>6s}  bound"]
    for name, r in rows.items():
        sec = r["ms"] / 1e3
        shares = ("" if r["pct_peak_flops"] is None else
                  f" {r['pct_peak_flops']:7.2f} {r['pct_peak_bw']:6.1f}")
        lines.append(
            f"{name:16s} {r['ms']:8.3f} {100 * r['ms'] / total:6.1f} {r['gflop']:9.3f}"
            f" {r['gb']:8.4f} {r['gflop'] / sec / 1e3:8.3f} {r['gb'] / sec:7.1f}"
            f"{shares or ' ' * 15}  {r['bound']}")
    lines.append(f"{'total':16s} {total:8.3f}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-points", type=int, default=10000)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--reps", type=int, default=10, help="timed calls per stage")
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    p.add_argument("--tiny", action="store_true", help="DeepVCPConfig.tiny")
    args = p.parse_args(argv)

    from deepvcp_tpu_torch.config import DeepVCPConfig
    from deepvcp_tpu_torch.models import DeepVCP

    device = torch.device("cpu") if args.cpu else torch.device("cuda", torch.cuda.current_device())
    cfg = (DeepVCPConfig.tiny(args.num_points, use_normal=False) if args.tiny
           else DeepVCPConfig(num_points=args.num_points, use_normal=False))
    torch.manual_seed(0)
    model = DeepVCP(cfg).to(device).eval()
    print(f"card: {card_name()}; peaks for the roofline: H100 SXM {PEAK_BYTES:.3g} B/s, "
          f"{PEAK_FLOPS:.3g} f32 op/s")
    result = profile_stages(model, args.batch, device, reps=args.reps)
    print(report(result))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
