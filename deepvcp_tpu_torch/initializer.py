"""Global SO(3) initializer (port of deepvcp_tpu/initializer.py): a coarse
pose for pairs with any rotation, to warm-start a Registrar or a
CascadeRegistrar.

The DeepVCP network is a local refiner: its candidate grid reaches
+/-search_radius around the warm-started keypoints, so a pair rotated far
from the identity is out of its reach. This module brings any pair into
its basin, with no data-dependent control flow:

  1. subsample both clouds by farthest-point sampling (kernel K3 on the
     card) into a coarse and a fine target level, centred on the full-cloud
     centroids;
  2. run trimmed-nearest-neighbour Kabsch ICP at the coarse level from
     EVERY rotation of a fixed super-Fibonacci grid (Alexa, CVPR 2022),
     all hypotheses batched, `sweep_chunk` at a time;
  3. rescore every converged hypothesis at the fine level, run fine ICP on
     the `top_p` best and return the best final score.

The JAX docstring gives the measured reasons for this design (no
correspondence-free pre-ranking: it cannot tell a near-symmetric cloud from
its symmetry twins). The returned pose feeds the registrars as (R_init,
t_init); their guard scores it as column 0, so a bad init cannot worsen
their output.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from deepvcp_tpu_torch.ops import farthest_point_sample, kabsch, square_distance


class GlobalInit(NamedTuple):
    R: torch.Tensor       # [B, 3, 3] coarse rotation
    t: torch.Tensor       # [B, 3] coarse translation
    score: torch.Tensor   # [B] final trimmed-NN score (a distance) of the pose


def super_fibonacci_rotations(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """n near-uniformly covering rotations [n, 3, 3] (super-Fibonacci
    spirals; deterministic, no RNG). Built on the host in float64, as the
    JAX package builds it, then cast and moved."""
    s = np.arange(n, dtype=np.float64) + 0.5
    phi = 1.533751168755204288118041  # psi: the positive root of x^4 = x + 4
    r = np.sqrt(s / n)
    rr = np.sqrt(1.0 - s / n)
    alpha = 2.0 * np.pi * s / np.sqrt(2.0)
    beta = 2.0 * np.pi * s / phi
    q = np.stack([r * np.sin(alpha), r * np.cos(alpha),
                  rr * np.sin(beta), rr * np.cos(beta)], axis=-1)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(n, 3, 3)
    return torch.from_numpy(R).to(dtype=dtype, device=device)


def _trimmed_score(d2_min: torch.Tensor, keep: int) -> torch.Tensor:
    """Mean of the `keep` smallest squared NN distances of each row (robust
    to partial overlap). d2_min [..., S] -> [...]."""
    best = torch.topk(d2_min, keep, dim=-1, largest=False).values
    return torch.mean(torch.clamp_min(best, 0.0), dim=-1)


def _gather_hyp(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, P, ...] at hypothesis indices idx [B, Q] -> [B, Q, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class Levels(NamedTuple):
    """The subsampled, centred clouds of a batch of pairs."""

    src: torch.Tensor        # [B, S, 3] source FPS points minus the source centroid
    fine: torch.Tensor       # [B, T, 3] target FPS points minus the target centroid
    coarse: torch.Tensor     # [B, T', 3] the first n_coarse of `fine`
    src_mean: torch.Tensor   # [B, 1, 3] full-cloud centroids
    tgt_mean: torch.Tensor   # [B, 1, 3]
    keep: int                # correspondences kept by the trimmed solves


def centred_levels(src_xyz: torch.Tensor, tgt_xyz: torch.Tensor, n_src: int, n_tgt: int,
                   n_coarse: int, inlier_ratio: float) -> Levels:
    """FPS subsample of both clouds (FPS: coverage beats uniform for
    scoring), centred on the full-cloud centroids. One FPS pass per cloud:
    the coarse level is the FPS prefix of the fine one (FPS orderings nest).
    Sizes are clamped to the clouds'."""
    n_src = min(n_src, src_xyz.shape[-2])
    n_tgt = min(n_tgt, tgt_xyz.shape[-2])
    s_sub = _gather_hyp(src_xyz, farthest_point_sample(src_xyz, n_src))
    t_sub = _gather_hyp(tgt_xyz, farthest_point_sample(tgt_xyz, n_tgt))
    s_mean = torch.mean(src_xyz, dim=-2, keepdim=True)
    t_mean = torch.mean(tgt_xyz, dim=-2, keepdim=True)
    t_c = t_sub - t_mean
    return Levels(src=s_sub - s_mean, fine=t_c, coarse=t_c[:, :min(n_coarse, n_tgt)],
                  src_mean=s_mean, tgt_mean=t_mean, keep=max(int(n_src * inlier_ratio), 3))


def _nn_d2(lv: Levels, R: torch.Tensor, t: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """The posed source under [B, P] hypotheses against a level [B, T, 3]:
    squared distances [B, P, S, T]."""
    y = lv.src[:, None] @ R.transpose(-1, -2) + t[..., None, :]
    return square_distance(y, level[:, None])


def icp(lv: Levels, R: torch.Tensor, t: torch.Tensor, level: torch.Tensor,
        iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`iters` trimmed-NN Kabsch steps from each of the [B, P] hypotheses
    (R [B, P, 3, 3], t [B, P, 3]) against a target level."""
    B, P = R.shape[:2]
    src = lv.src[:, None].expand(B, P, *lv.src.shape[1:])
    rows = torch.arange(B, device=R.device)[:, None, None]
    for _ in range(iters):
        nn_d, nn_ix = torch.min(_nn_d2(lv, R, t, level), dim=-1)        # [B, P, S]
        # trimmed weights: keep the `keep` closest correspondences
        thresh = torch.topk(nn_d, lv.keep, dim=-1, largest=False).values[..., -1:]
        R, t = kabsch(src, level[rows, nn_ix], weights=(nn_d <= thresh).to(R.dtype))
    return R, t


def score(lv: Levels, R: torch.Tensor, t: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """Trimmed score [B, P] (a mean squared distance) of [B, P] hypotheses."""
    return _trimmed_score(torch.amin(_nn_d2(lv, R, t, level), dim=-1), lv.keep)


def hypothesis_chunks(n_rotations: int, sweep_chunk: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """The rotation grid in chunks [n_chunks, chunk, 3, 3], the last chunk
    padded with identities (whose scores the sweep sets to +inf)."""
    grid = super_fibonacci_rotations(n_rotations, dtype, device)
    cg = min(sweep_chunk, n_rotations)
    n_chunks = -(-n_rotations // cg)
    pad = n_chunks * cg - n_rotations
    if pad:
        grid = torch.cat([grid, torch.eye(3, dtype=dtype, device=device).expand(pad, 3, 3)])
    return grid.reshape(n_chunks, cg, 3, 3)


@torch.no_grad()
def so3_global_init(
    src: torch.Tensor,
    tgt: torch.Tensor,
    n_rotations: int = 4096,
    n_src: int = 128,
    n_tgt: int = 4096,
    n_coarse: int = 256,
    top_p: int = 64,
    icp_iters: int = 4,
    icp_coarse_iters: int = 3,
    inlier_ratio: float = 0.7,
    sweep_chunk: int = 64,
) -> GlobalInit:
    """Coarse global alignment of [B, N, 3(+C)] cloud pairs: x_tgt ~= R x_src + t.

    Each hypothesis is solved on its own, so the result does not depend on
    `sweep_chunk`, which only bounds memory: a chunk's fine rescore holds a
    [B, chunk, n_src, n_tgt] distance tile."""
    src_xyz, tgt_xyz = src[..., :3], tgt[..., :3]
    B, dtype, dev = src_xyz.shape[0], src_xyz.dtype, src_xyz.device
    lv = centred_levels(src_xyz, tgt_xyz, n_src, n_tgt, n_coarse, inlier_ratio)

    # coarse ICP from every grid rotation, chunk by chunk; the fine rescore
    # separates the true optimum from its symmetry twins
    chunks = hypothesis_chunks(n_rotations, sweep_chunk, dtype, dev)
    cg = chunks.shape[1]
    Rc, tc, sc = [], [], []
    for g in chunks:
        R, t = icp(lv, g.expand(B, cg, 3, 3), torch.zeros(B, cg, 3, dtype=dtype, device=dev),
                   lv.coarse, icp_coarse_iters)
        Rc.append(R)
        tc.append(t)
        sc.append(score(lv, R, t, lv.fine))
    Rc, tc, sc = torch.cat(Rc, 1), torch.cat(tc, 1), torch.cat(sc, 1)
    sc = torch.where(torch.arange(sc.shape[1], device=dev) < n_rotations, sc, torch.inf)
    best = torch.topk(sc, top_p, dim=-1, largest=False).indices             # [B, P]

    # fine ICP on the survivors and the final pick
    Rf, tf = icp(lv, _gather_hyp(Rc, best), _gather_hyp(tc, best), lv.fine, icp_iters)
    final = score(lv, Rf, tf, lv.fine)                                        # [B, P]
    pick = torch.argmin(final, dim=-1, keepdim=True)                          # [B, 1]
    Rb, tb = _gather_hyp(Rf, pick)[:, 0], _gather_hyp(tf, pick)[:, 0]
    sb = torch.gather(final, 1, pick)[:, 0]
    # un-centre: x_tgt = R (x_src - s_mean) + t + t_mean
    t_full = tb + lv.tgt_mean[:, 0] - torch.einsum("bj,bij->bi", lv.src_mean[:, 0], Rb)
    return GlobalInit(R=Rb, t=t_full, score=torch.sqrt(torch.clamp_min(sb, 0.0)))
