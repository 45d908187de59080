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

Inside `with point_partition(mesh)` (the sharded train step opens it) a
forward whose shapes pass DeepVCP.partitions splits its per-point work over
the mesh's point group, as GSPMD splits the JAX step's, under every FE
engine and compute dtype: each rank runs the SA stages on its rows of each
cloud, sorted (banded, windowed) or as given (dense)
(models/layers.py::FeatureExtraction): the projections and tails, the
gather engines' neighbour search, grouping and MLP for its queries, and
the static band's pooling over the tiles that hold its rows; then the
saliency on its rows, and the source descriptors, candidate
neighbourhoods, DFE and CPG for its keypoints. The features, the
saliency, the VCPs and the candidate weights are all-gathered
(parallel.mesh.gather_points), and what needs the whole set (the sort, K1,
top-K, the loss) runs whole on every rank.

The forward is split at the warm start. `encode` is everything that does not
depend on the pose (both FE passes, saliency, keypoints and the source
descriptors); `correspond` is everything after it. `forward` is
`correspond(encode(...))`. The JAX Registrar re-emits the whole forward per
refinement iteration and relies on XLA to dedupe the pose-free prefix;
eager PyTorch would run it again, so the port's Registrar encodes once.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from deepvcp_tpu_torch.config import DeepVCPConfig
from deepvcp_tpu_torch.models.layers import (
    CPG, FeatEmbedding, FeatureExtraction, WeightingLayer, compute_dtype)
from deepvcp_tpu_torch.ops import (
    apply_rigid, approx_knn, farthest_point_sample, group_neighbors, index_points, voxelize)
from deepvcp_tpu_torch.ops.two_level import two_level_rows
from deepvcp_tpu_torch.utils.profiling import annotate

_EPS = 1e-8
# the mesh whose point group a forward may split its per-point work over
_POINT_MESH: contextvars.ContextVar = contextvars.ContextVar("point_partition", default=None)


@contextlib.contextmanager
def point_partition(mesh):
    """Within the block, a DeepVCP forward that passes its gate
    (DeepVCP.partitions) splits its per-point work over `mesh`'s point
    group (None: no split). Each rank of the group passes the same pairs and
    gets the whole forward's outputs; their gradients are each rank's share
    when it backpropagates 1 / P of the loss, so the train step that opens
    the block scales its loss by 1 / P and sums the gradients over the
    group (train/trainer.py)."""
    token = _POINT_MESH.set(mesh)
    try:
        yield
    finally:
        _POINT_MESH.reset(token)


class Encoding(NamedTuple):
    """The pose-independent half of a forward pass."""

    keypoints: torch.Tensor          # [B, K, 3]
    keypoint_idx: torch.Tensor       # [B, K] int64
    keypoint_saliency: torch.Tensor  # [B, K]
    saliency: torch.Tensor           # [B, N]
    src_descriptors: torch.Tensor    # [B, K, F]; this rank's [B, K / P, F] under a partition
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
    candidate's neighbours for the gather that follows, or, under a point
    partition over the same group (point_partition), its own keypoints'."""

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

    def select_args(self, chunked: bool = False, parts: int = 1) -> Dict:
        """approx_knn's selection dtype and query chunk for the source and
        flat candidate k-NN under this config: the extent-gated
        knn_select_dtype_effective and knn_query_chunk on the approx_knn
        contract, else f32 and query_chunk. `chunked`: the chunk, divided
        by `parts` (a point group's size, so that each rank of a partition
        holds 1 / parts of the distance tile; the neighbours are the same),
        else none."""
        cfg = self.cfg
        if cfg.use_approx_knn:
            select_dtype, chunk = cfg.knn_select_dtype_effective, cfg.knn_query_chunk
        else:
            select_dtype, chunk = None, cfg.query_chunk
        return dict(select_dtype=select_dtype, chunk=-(-chunk // parts) if chunked else None)

    def _knn(self, ref: torch.Tensor, query: torch.Tensor, chunked: bool, parts: int = 1):
        return approx_knn(ref, query, self.cfg.num_neighbors, **self.select_args(chunked, parts))

    def _use_ring(self, n_ref: int, n_query: int, k: int) -> bool:
        """The ring's gate: a point group of P > 1 ranks that divides both
        clouds, with k <= n_ref / P."""
        if self.knn_mesh is None:
            return False
        from deepvcp_tpu_torch.parallel.mesh import POINT_AXIS, axis_size

        p = axis_size(self.knn_mesh, POINT_AXIS)
        return p > 1 and n_ref % p == 0 and n_query % p == 0 and k <= n_ref // p

    def partitions(self, mesh, *n_points: int) -> bool:
        """The point partition's gate, static as the ring's: a point group
        of P > 1 ranks that divides K and each cloud's N, and SA stages that
        keep every point as a centroid (npoint >= N on the banded engine,
        which never samples; npoint == N on the gather engines, whose FPS
        and centroids are not split). Any FE engine (banded on the exact
        slab or the static band, windowed, dense) and compute dtype. Other
        shapes run the whole forward on every rank of the group."""
        from deepvcp_tpu_torch.parallel.mesh import POINT_AXIS, axis_size

        cfg = self.cfg
        p = axis_size(mesh, POINT_AXIS)
        banded = cfg.neighbor_method == "banded"
        return (p > 1 and cfg.num_keypoints % p == 0 and all(n % p == 0 for n in n_points)
                and all(layer.npoint >= n if banded else layer.npoint == n
                        for layer in cfg.sa_layers for n in n_points))

    def _point_mesh(self, *n_points: int):
        """The mesh of the enclosing point_partition if this forward's
        shapes pass the gate, else None."""
        mesh = _POINT_MESH.get()
        return mesh if mesh is not None and self.partitions(mesh, *n_points) else None

    def features(self, pts: torch.Tensor, mesh=None) -> torch.Tensor:
        """FE of one cloud [B, N, 3(+3)] -> [B, N, F] (split over `mesh`'s
        point group, whole on every rank: FeatureExtraction)."""
        with annotate("deepvcp.features"):
            nrm = pts[..., 3:6] if self.cfg.use_normal else None
            return self.fe(pts[..., :3], nrm, mesh=mesh)

    def encode(self, src: torch.Tensor, tgt: torch.Tensor) -> Encoding:
        with annotate("deepvcp.encode"):
            cfg = self.cfg
            mesh = self._point_mesh(src.shape[1], tgt.shape[1])
            src_xyz = src[..., :3]
            src_feat = self.features(src, mesh)
            if mesh is None:
                saliency = self.wl(src_feat)
            else:
                from deepvcp_tpu_torch.parallel.mesh import gather_points, point_shard

                saliency = gather_points(self.wl(point_shard(src_feat, mesh)), mesh)
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
            # the keypoints whose descriptors this rank computes
            kp_own = kp_xyz if mesh is None else point_shard(kp_xyz, mesh)
            if cfg.dfe_src_neighbors == "cloud":
                # D13: source neighbourhoods from the keypoint's ns-NN in the
                # full source cloud, the same construction as the target branch
                _, nb_idx = self._knn(src_xyz, kp_own, chunked=False)
                snb = index_points(torch.cat([src_xyz, src_feat.to(src_xyz.dtype)], dim=-1), nb_idx)
                local_xyz = snb[..., :3] - kp_own[:, :, None, :]
                nb_feat = snb[..., 3:]
            else:
                # the reference's: keypoints grouped among themselves within
                # group_radius, their own features gathered (D8), a zero-hit
                # row masked (self-inclusion makes it impossible here)
                _, local_xyz, nb_idx, nb_count = group_neighbors(
                    cfg.group_radius, cfg.num_neighbors, kp_xyz, kp_own, return_count=True)
                kp_feat = index_points(src_feat, kp_idx)
                nb_feat = torch.where((nb_count > 0)[..., None, None],
                                      index_points(kp_feat, nb_idx), 0.0)
            d_src = torch.linalg.norm(local_xyz, dim=-1)
            w_src = d_src / (torch.sum(d_src, dim=-1, keepdim=True) + _EPS)
            src_cat = torch.cat([local_xyz, nb_feat * w_src[..., None]], dim=-1)
            tgt_xyz = tgt[..., :3]
            tgt_feat = self.features(tgt, mesh)
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
                            candidates: torch.Tensor, mesh=None) -> torch.Tensor:
        """Each candidate's ns nearest target rows (xyz ++ features):
        [B, K*C, ns, 3+F], from the ring KNN over the knn_mesh's point
        group, the flat KNN over the whole target cloud or the two-level
        per-keypoint tables. Under a point partition over `mesh` the
        candidates are this rank's keypoints' (K / P of them), and the
        ring's query shard is exactly these (knn_mesh must be `mesh`)."""
        with annotate("deepvcp.candidate_neighbors"):
            cfg = self.cfg
            B, K, C, _ = candidates.shape
            P = 1
            if mesh is not None:
                from deepvcp_tpu_torch.parallel.mesh import POINT_AXIS, axis_peers, axis_size

                P = axis_size(mesh, POINT_AXIS)
            if self._use_ring(enc.tgt_xyz.shape[1], K * C * P, cfg.num_neighbors):
                from deepvcp_tpu_torch.ops.distributed import ring_knn

                if mesh is not None and axis_peers(self.knn_mesh, POINT_AXIS) != axis_peers(
                        mesh, POINT_AXIS):
                    raise ValueError("the ring's point group must be the partition's")
                _, idx = ring_knn(self.knn_mesh, enc.tgt_xyz, candidates.reshape(B, K * C, 3),
                                  cfg.num_neighbors, gather=mesh is None)
                return index_points(enc.tgt_table, idx)
            if cfg.use_two_level_tgt_knn:
                rows = two_level_rows(enc.tgt_xyz, enc.tgt_table, kp_warm, candidates,
                                      cfg.num_neighbors, **self.two_level_args())
                return rows.reshape(B, K * C, cfg.num_neighbors, -1)
            _, idx = self._knn(enc.tgt_xyz, candidates.reshape(B, K * C, 3), chunked=True, parts=P)
            return index_points(enc.tgt_table, idx)

    def match(self, enc: Encoding, candidates: torch.Tensor, tnb: torch.Tensor,
              R_init: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Derotate and weight the candidates' neighbourhoods tnb
        [B, K*C, ns, 3+F], embed them and run the CPG: (vcp [B, K, 3],
        candidate weights [B, K, C])."""
        with annotate("deepvcp.match"):
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
        with annotate("deepvcp.correspond"):
            mesh = self._point_mesh(enc.saliency.shape[1], enc.tgt_xyz.shape[1])
            kp_warm, candidates = self.candidates(enc, R_init, t_init)
            src_desc = enc.src_descriptors
            if mesh is not None:
                from deepvcp_tpu_torch.parallel.mesh import point_shard

                kp_warm, candidates = point_shard(kp_warm, mesh), point_shard(candidates, mesh)
            tnb = self.candidate_neighbors(enc, kp_warm, candidates, mesh)
            vcp, cand_weights = self.match(enc, candidates, tnb, R_init)
            if mesh is not None:
                from deepvcp_tpu_torch.parallel.mesh import gather_points

                vcp, cand_weights, src_desc = (gather_points(a, mesh)
                                               for a in (vcp, cand_weights, src_desc))
            aux = {
                "saliency": enc.saliency,
                "keypoint_idx": enc.keypoint_idx,
                "keypoint_saliency": enc.keypoint_saliency,
                "candidate_weights": cand_weights,
                "src_descriptors": src_desc,
            }
            return enc.keypoints, vcp, aux

    def forward(self, src: torch.Tensor, tgt: torch.Tensor, R_init: torch.Tensor,
                t_init: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        return self.correspond(self.encode(src, tgt), R_init, t_init)


def create_deepvcp(cfg: DeepVCPConfig, knn_mesh=None) -> DeepVCP:
    """The model of cfg (counterpart of the JAX `create_deepvcp(cfg,
    axis_name)`: the ring KNN's axis there is the point group of
    `knn_mesh` here)."""
    return DeepVCP(cfg, knn_mesh=knn_mesh)
