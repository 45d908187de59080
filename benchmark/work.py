"""Work counts: the operations and bytes a call of the configuration's path
needs, counted from its shapes and, for the in-radius pooling (K1), from the
cell's own clouds, and the least time they take at the card's published
peaks. The rooflines and the mfu metrics read these; they live here, beside
the harness, so that a change to the program cannot move the yardstick.

Copies, with one fix, of the port's arithmetic: chip_smoke.py's bound_ms and
in_radius_pairs, and deepvcp_tpu_torch/profile_stages.py's _mlp_ops,
_tile_ops, _fe_ops and its DFE, CPG and Kabsch counts. The fix: the exact
slab (K1) compares each channel once per in-radius pair, not once per point
of a static band of 2 * window + 1 (profile_stages' _fe_ops counts the
static band, which the configurations here do not run).

Conventions (profile_stages'): 2 operations per multiply-add of a dense
layer, convolution or distance product; 3 per pair of a distance tile for
the |a|^2 + |b|^2 - 2ab combination and 1 per compared element of a top-k,
max or softmax; a 3x3 SVD counts 0. Bytes: every input read once and every
output written once.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound_ms(bytes_moved: float, ops: float) -> Tuple[float, str]:
    """(least time in ms, what bounds it) for work that moves `bytes_moved`
    bytes and does `ops` float32 operations, at the published peaks."""
    t_bytes, t_ops = bytes_moved / PEAK_HBM_BYTES, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


@torch.no_grad()
def in_radius_pairs(xyz: torch.Tensor, radii: Sequence[float]) -> np.ndarray:
    """[B, len(radii)] int64: the ordered pairs (q, n), q == n included,
    within each radius in each cloud of xyz [B, N, 3], under the kernels'
    f32 test (d^2 = ((dx*dx)+(dy*dy))+(dz*dz) <= r^2, r^2 rounded once to
    f32): the pairs K1 visits."""
    B, N, _ = xyz.shape
    r2 = [float(np.float32(float(r) ** 2)) for r in radii]
    counts = torch.zeros(B, len(r2), dtype=torch.int64, device=xyz.device)
    chunk = max(1, (1 << 26) // max(B * N, 1))
    for s in range(0, N, chunk):
        d = xyz[:, None, :, :] - xyz[:, s:s + chunk, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        for j, r in enumerate(r2):
            counts[:, j] += (d2 <= r).sum(dim=(1, 2))
    return counts.cpu().numpy()


def mlp_ops(rows: int, widths: Sequence[int], in_features: int) -> int:
    ops, prev = 0, in_features
    for w in widths:
        ops += 2 * rows * prev * w
        prev = w
    return ops


def tile_ops(rows: int, cols: int, select: bool = True) -> int:
    """A distance tile's product (2 x 3 per pair), combination (3) and
    selection (1 per element)."""
    return rows * cols * (6 + 3 + (1 if select else 0))


def fe_ops(model: dict, N: int, pairs: Sequence[int]) -> int:
    """One cloud's feature extraction on the exact slab: the per-point
    projections, one compare per channel of each in-radius pair (`pairs[i]`
    of stage i), the MLP tail and the final projection."""
    ops, prev = 0, 0
    for layer, n_pairs in zip(model["sa_layers"], pairs):
        c0 = layer["mlp"][0]
        ops += 2 * N * (3 + prev) * c0
        ops += int(n_pairs) * c0
        ops += mlp_ops(N, layer["mlp"][1:], c0)
        prev = layer["mlp"][-1]
    return ops + 2 * N * prev * model["feat_dim"]


def band_max_bound_ms(model: dict, N: int, pairs: Sequence[int]) -> float:
    """The least time of one cloud's K1 launches (one a stage): each reads
    the cloud and u and writes the max, 4 * N * (3 + 2C) bytes, and does 9
    operations for a pair's d^2 test and one compare a channel of each
    in-radius pair."""
    total = 0.0
    for layer, n_pairs in zip(model["sa_layers"], pairs):
        C = layer["mlp"][0]
        total += bound_ms(4 * N * (3 + 2 * C), int(n_pairs) * (9 + C))[0]
    return total


def grid_candidates(model: dict) -> int:
    return (int(round(2.0 * model["search_radius"] / model["voxel_len"])) + 1) ** 3


def candidates_bound_ms(model: dict, B: int) -> float:
    """The least time of one flat candidate stage (candidate_neighbors) of
    a call of B pairs: B*K*C queries against N points at 10 operations a
    pair (tile_ops); bytes: the target cloud, the candidates and the target
    table [N, 3 + F] read once, the gathered rows [K*C, ns, 3 + F] written
    once. The same work whatever implements the stage."""
    N, K, ns, F = (model["num_points"], model["num_keypoints"], model["num_neighbors"],
                   model["feat_dim"])
    KC = K * grid_candidates(model)
    ops = tile_ops(B * KC, N)
    nbytes = 4 * (B * N * 3 + B * KC * 3 + B * N * (3 + F) + B * KC * ns * (3 + F))
    return bound_ms(nbytes, ops)[0]


def pair_flops(config: dict, src_pairs: Sequence[int], tgt_pairs: Sequence[int]) -> int:
    """The operations of one pair's registration on the configuration's path:
    both FE passes, the weighting, the source k-NN and DFE, the score of the
    init pose, and per refinement the candidate selection (flat tile, or
    the two levels), the target DFE, the CPG, the two Kabsch solves and the
    guard's score."""
    m, r = config["model"], config["registrar"]
    N, K, ns, F = m["num_points"], m["num_keypoints"], m["num_neighbors"], m["feat_dim"]
    C = grid_candidates(m)
    dfe_out = m["dfe_mlp"][-1]
    ops = fe_ops(m, N, src_pairs) + fe_ops(m, N, tgt_pairs)
    ops += mlp_ops(N, m["wl_mlp"], F)
    ops += tile_ops(K, N)                                            # source k-NN
    ops += mlp_ops(K * ns, m["dfe_mlp"], 3 + F) + K * ns * dfe_out   # source DFE
    ops += tile_ops(K, N)                                            # score of the init
    if m["tgt_knn"] == "two_level":
        select = tile_ops(K, N) + tile_ops(K * C, min(m["tgt_knn_table"], N))
    else:
        select = tile_ops(K * C, N)
    conv_ops, prev = 0, dfe_out
    for ch in m["cpg_channels"]:
        conv_ops += 2 * K * C * 27 * prev * ch
        prev = ch
    cpg = 2 * K * C * dfe_out + conv_ops + 3 * K * C + 2 * K * C * 3
    kabsch = 2 * (2 * K * 3 * 3 + 2 * K * 3) + 2 * K * 9
    per_refinement = (select + mlp_ops(K * C * ns, m["dfe_mlp"], 3 + F)
                      + K * C * ns * dfe_out + cpg + kabsch + tile_ops(K, N))
    return ops + r["refine_iters"] * per_refinement


def radii(config: dict) -> list:
    return [layer["radius"] for layer in config["model"]["sa_layers"]]


def pool_work(config: dict, src: torch.Tensor, tgt: torch.Tensor) -> Dict[str, np.ndarray]:
    """Per pair of the pool (src, tgt [P, N, 3] on the device): its
    registration's operations ("flops") and the least time of its K1
    launches ("band_max_bound_ms", both clouds)."""
    N = config["model"]["num_points"]
    rs = radii(config)
    src_pairs, tgt_pairs = in_radius_pairs(src, rs), in_radius_pairs(tgt, rs)
    flops = np.array([pair_flops(config, s, t) for s, t in zip(src_pairs, tgt_pairs)],
                     dtype=np.float64)
    band = np.array([band_max_bound_ms(config["model"], N, s)
                     + band_max_bound_ms(config["model"], N, t)
                     for s, t in zip(src_pairs, tgt_pairs)])
    return {"flops": flops, "band_max_bound_ms": band}
