"""DeepVCP forward (port of deepvcp_tpu/models/deepvcp.py): features from
the banded, windowed or dense FE engine (models/layers.py), top-K or
salient-FPS keypoints, source neighbourhoods from the full source cloud
(D13) or, with dfe_src_neighbors="keypoints", among the keypoints (the
reference's), the candidates' target neighbourhoods from the flat candidate
KNN and the fused [N, 3+F] gather, or from the two-level grouping
(`tgt_knn="two_level"`, ops/two_level.py, kernels K4/K5 or, with
use_pallas_onehot_gather=False, torch.gather), and derotated target
neighbourhoods (D14). With a `knn_mesh` whose "point" group has more than
one rank, the candidate KNN runs as the ring over that group
(ops/distributed.ring_knn), ahead of the two-level and flat branches, as in
JAX. compute_dtype="bfloat16" runs the MLPs, the DFE and
the CPG in bf16 with f32 parameters, as flax's dtype=bf16 modules do.

The forward is split at the warm start. `encode` is everything that does not
depend on the pose (both FE passes, saliency, keypoints and the source
descriptors); `correspond` is everything after it. `forward` is
`correspond(encode(...))`. The JAX Registrar re-emits the whole forward per
refinement iteration and relies on XLA to dedupe the pose-free prefix;
eager PyTorch would run it again, so the port's Registrar encodes once.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from deepvcp_tpu_torch.config import DeepVCPConfig
from deepvcp_tpu_torch.models.layers import (
    CPG, FeatEmbedding, FeatureExtraction, WeightingLayer, compute_dtype)
from deepvcp_tpu_torch.ops import (
    apply_rigid, approx_knn, farthest_point_sample, group_neighbors, index_points, knn, voxelize)
from deepvcp_tpu_torch.ops.two_level import two_level_rows

_EPS = 1e-8


class Encoding(NamedTuple):
    """The pose-independent half of a forward pass."""

    keypoints: torch.Tensor          # [B, K, 3]
    keypoint_idx: torch.Tensor       # [B, K] int64
    keypoint_saliency: torch.Tensor  # [B, K]
    saliency: torch.Tensor           # [B, N]
    src_descriptors: torch.Tensor    # [B, K, F]
    tgt_xyz: torch.Tensor            # [B, N, 3]
    tgt_table: torch.Tensor          # [B, N, 3+F]: xyz and features, one gather


class DeepVCP(nn.Module):
    """forward(src, tgt, R_init, t_init) -> (keypoints [B,K,3], vcp [B,K,3], aux).

    src/tgt [B, N, 3] or [B, N, 6] (xyz + normals), channels last; R_init
    [B, 3, 3], t_init [B, 3] warm-start pose. Under `eval()` it computes the
    JAX `apply(..., train=False)`; under `train()` the JAX `apply(...,
    train=True, mutable=["batch_stats"])`: BatchNorm on batch statistics,
    with the shared FE's running statistics updated once per cloud, source
    first, as the two FE calls of the JAX forward do.

    `knn_mesh`: an optional ("data", "point") mesh (parallel.make_mesh).
    Where its point group has P > 1 ranks that divide N and K*C (and
    ns <= N / P), the candidate KNN runs as the exact ring KNN over that
    group; other shapes take the single-device engines, as JAX's static
    gate does. A rank passes
    its own pairs (in the sharded train step, its data shard), so the ring
    runs over the point group only: JAX's batch_axis="data" makes its
    shard_map compose with a batch already split over "data", which a
    rank's arrays are here. Every rank of the point group gets every
    candidate's neighbours for the gather that follows."""

    def __init__(self, cfg: DeepVCPConfig, knn_mesh=None):
        super().__init__()
        cfg = cfg.resolve()
        self.cfg = cfg
        self.knn_mesh = knn_mesh
        dt = compute_dtype(cfg)
        self.fe = FeatureExtraction(cfg)
        self.wl = WeightingLayer(cfg.wl_mlp, cfg.feat_dim, dtype=dt)
        self.dfe = FeatEmbedding(cfg.dfe_mlp, 3 + cfg.feat_dim, activation=cfg.dfe_activation,
                                 dtype=dt)
        self.cpg = CPG(cfg.cpg_channels, cfg.grid_size, cfg.dfe_mlp[-1], dtype=dt)

    def _knn(self, ref: torch.Tensor, query: torch.Tensor, chunked: bool):
        cfg = self.cfg
        if cfg.use_approx_knn:
            return approx_knn(ref, query, cfg.num_neighbors,
                              chunk=cfg.knn_query_chunk if chunked else None,
                              select_dtype=cfg.knn_select_dtype_effective)
        return knn(ref, query, cfg.num_neighbors,
                   chunk=cfg.query_chunk if chunked else None)

    def _use_ring(self, n_ref: int, n_query: int, k: int) -> bool:
        """The ring's gate: a point group of P > 1 ranks that divides both
        clouds, with k <= n_ref / P."""
        if self.knn_mesh is None:
            return False
        from deepvcp_tpu_torch.parallel.mesh import POINT_AXIS, axis_size

        p = axis_size(self.knn_mesh, POINT_AXIS)
        return p > 1 and n_ref % p == 0 and n_query % p == 0 and k <= n_ref // p

    def features(self, pts: torch.Tensor) -> torch.Tensor:
        """FE of one cloud [B, N, 3(+3)] -> [B, N, F]."""
        nrm = pts[..., 3:6] if self.cfg.use_normal else None
        return self.fe(pts[..., :3], nrm)

    def encode(self, src: torch.Tensor, tgt: torch.Tensor) -> Encoding:
        cfg = self.cfg
        src_xyz = src[..., :3]
        src_feat = self.features(src)
        saliency = self.wl(src_feat)
        K = cfg.num_keypoints
        if cfg.keypoint_selection == "salient_fps":
            # FPS of K over the top-(pool_mult*K) saliency pool: salient
            # points, spread out (kernel K3 on the card)
            P = min(cfg.keypoint_pool_mult * K, src_xyz.shape[1])
            pool_sal, pool_idx = torch.topk(saliency, P, dim=-1)
            sel = farthest_point_sample(index_points(src_xyz, pool_idx), K)
            kp_idx = torch.gather(pool_idx, 1, sel)
            kp_saliency = torch.gather(pool_sal, 1, sel)
        else:
            kp_saliency, kp_idx = torch.topk(saliency, K, dim=-1)
        kp_xyz = index_points(src_xyz, kp_idx)
        if cfg.dfe_src_neighbors == "cloud":
            # D13: source neighbourhoods from the keypoint's ns-NN in the
            # full source cloud, the same construction as the target branch
            _, nb_idx = self._knn(src_xyz, kp_xyz, chunked=False)
            snb = index_points(torch.cat([src_xyz, src_feat.to(src_xyz.dtype)], dim=-1), nb_idx)
            local_xyz = snb[..., :3] - kp_xyz[:, :, None, :]
            nb_feat = snb[..., 3:]
        else:
            # the reference's: keypoints grouped among themselves within
            # group_radius, their own features gathered (D8), a zero-hit
            # row masked (self-inclusion makes it impossible here)
            _, local_xyz, nb_idx, nb_count = group_neighbors(
                cfg.group_radius, cfg.num_neighbors, kp_xyz, kp_xyz, return_count=True)
            kp_feat = index_points(src_feat, kp_idx)
            nb_feat = torch.where((nb_count > 0)[..., None, None],
                                  index_points(kp_feat, nb_idx), 0.0)
        d_src = torch.linalg.norm(local_xyz, dim=-1)
        w_src = d_src / (torch.sum(d_src, dim=-1, keepdim=True) + _EPS)
        src_cat = torch.cat([local_xyz, nb_feat * w_src[..., None]], dim=-1)
        tgt_xyz = tgt[..., :3]
        tgt_feat = self.features(tgt)
        return Encoding(
            keypoints=kp_xyz, keypoint_idx=kp_idx, keypoint_saliency=kp_saliency,
            saliency=saliency, src_descriptors=self.dfe(src_cat),
            tgt_xyz=tgt_xyz, tgt_table=torch.cat([tgt_xyz, tgt_feat.to(tgt_xyz.dtype)], dim=-1))

    def candidates(self, enc: Encoding, R_init: torch.Tensor,
                   t_init: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Warm-start the keypoints and lay the voxel grid around them:
        (warm keypoints [B, K, 3], candidates [B, K, C, 3])."""
        cfg = self.cfg
        kp_warm = apply_rigid(enc.keypoints, R_init, t_init)
        return kp_warm, voxelize(kp_warm, cfg.search_radius, cfg.voxel_len,
                                 centered=cfg.centered_grid)

    def two_level_args(self) -> Dict:
        """two_level_rows' table size and selection dtypes under this config.
        Level 2 selects in knn_select_dtype, NOT the extent-gated effective
        dtype: keypoint-local coordinates stay small (as JAX)."""
        cfg = self.cfg
        return dict(table_size=cfg.tgt_knn_table, select_dtype=cfg.knn_select_dtype,
                    use_kernel=cfg.use_pallas_onehot_gather,
                    center_select_dtype=cfg.knn_select_dtype_effective)

    def candidate_neighbors(self, enc: Encoding, kp_warm: torch.Tensor,
                            candidates: torch.Tensor) -> torch.Tensor:
        """Each candidate's ns nearest target rows (xyz ++ features):
        [B, K*C, ns, 3+F], from the ring KNN over the knn_mesh's point
        group, the flat KNN over the whole target cloud or the two-level
        per-keypoint tables."""
        cfg = self.cfg
        B, K, C, _ = candidates.shape
        if self._use_ring(enc.tgt_xyz.shape[1], K * C, cfg.num_neighbors):
            from deepvcp_tpu_torch.ops.distributed import ring_knn

            _, idx = ring_knn(self.knn_mesh, enc.tgt_xyz, candidates.reshape(B, K * C, 3),
                              cfg.num_neighbors)
            return index_points(enc.tgt_table, idx)
        if cfg.use_two_level_tgt_knn:
            rows = two_level_rows(enc.tgt_xyz, enc.tgt_table, kp_warm, candidates,
                                  cfg.num_neighbors, **self.two_level_args())
            return rows.reshape(B, K * C, cfg.num_neighbors, -1)
        _, idx = self._knn(enc.tgt_xyz, candidates.reshape(B, K * C, 3), chunked=True)
        return index_points(enc.tgt_table, idx)

    def match(self, enc: Encoding, candidates: torch.Tensor, tnb: torch.Tensor,
              R_init: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Derotate and weight the candidates' neighbourhoods tnb
        [B, K*C, ns, 3+F], embed them and run the CPG: (vcp [B, K, 3],
        candidate weights [B, K, C])."""
        B, K, C, _ = candidates.shape
        local_t = tnb[..., :3] - candidates.reshape(B, K * C, 1, 3)
        if self.cfg.derotate_tgt_neighborhoods:
            # D14: row-vector form of R_init^T v, into the source frame
            local_t = local_t @ R_init[:, None]
        nb_dist = torch.linalg.norm(local_t, dim=-1)
        w_tgt = nb_dist / (torch.sum(nb_dist, dim=-1, keepdim=True) + _EPS)
        tgt_cat = torch.cat([local_t, tnb[..., 3:] * w_tgt[..., None]], dim=-1)
        tgt_desc = self.dfe(tgt_cat.reshape(B, K, C, tnb.shape[-2], -1))
        return self.cpg(enc.src_descriptors, tgt_desc, candidates)

    def correspond(self, enc: Encoding, R_init: torch.Tensor,
                   t_init: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        kp_warm, candidates = self.candidates(enc, R_init, t_init)
        tnb = self.candidate_neighbors(enc, kp_warm, candidates)
        vcp, cand_weights = self.match(enc, candidates, tnb, R_init)
        aux = {
            "saliency": enc.saliency,
            "keypoint_idx": enc.keypoint_idx,
            "keypoint_saliency": enc.keypoint_saliency,
            "candidate_weights": cand_weights,
            "src_descriptors": enc.src_descriptors,
        }
        return enc.keypoints, vcp, aux

    def forward(self, src: torch.Tensor, tgt: torch.Tensor, R_init: torch.Tensor,
                t_init: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        return self.correspond(self.encode(src, tgt), R_init, t_init)
