"""Model and training configuration of the port: its own copy of
deepvcp_tpu/config.py (SALayerConfig, DeepVCPConfig, TrainConfig), with
every field, default, property and `resolve()` check, and the `tiny` and
`kitti_scale` presets. The port imports nothing of the JAX package, so the
two copies are held equal by tests/test_torch_config.py. The meaning of
each field is documented at length in the JAX file; the notes here say
what the port does with it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SALayerConfig:
    """One PointNet++ set-abstraction stage."""

    npoint: int          # number of sampled centroids (== N means "keep all")
    radius: float        # ball-query radius
    nsample: int         # neighbors per centroid
    mlp: Tuple[int, ...] # per-group 1x1-conv channel widths


@dataclasses.dataclass(frozen=True)
class DeepVCPConfig:
    """Full model spec. Defaults are the reference's constants for
    10k-point clouds."""

    num_points: int = 10000          # N, points per cloud
    use_normal: bool = True          # ModelNet has normals, KITTI does not
    num_keypoints: int = 64          # K
    num_neighbors: int = 32          # nsample for keypoint grouping & tgt KNN
    group_radius: float = 1.0        # keypoint ball-query radius
    search_radius: float = 1.0       # r: candidate search radius
    voxel_len: float = 0.4           # s: candidate voxel edge
    feat_dim: int = 32               # per-point descriptor width
    sa_layers: Tuple[SALayerConfig, ...] = (
        SALayerConfig(npoint=-1, radius=0.1, nsample=256, mlp=(16, 16, 32)),
        SALayerConfig(npoint=-1, radius=0.2, nsample=128, mlp=(32, 64)),
        SALayerConfig(npoint=-1, radius=0.4, nsample=64, mlp=(64, 64)),
    )
    wl_mlp: Tuple[int, ...] = (16, 8, 1)        # weighting layer widths
    dfe_mlp: Tuple[int, ...] = (32, 32, 32)     # DFE widths
    cpg_channels: Tuple[int, ...] = (16, 4, 1)  # CPG Conv3d widths
    dfe_activation: bool = True      # ReLU between DFE layers
    use_batchnorm: bool = True       # BatchNorm in the SA stacks
    query_chunk: int = 2048          # queries per block of the exact KNN
    compute_dtype: str = "float32"   # the port runs "float32" only (M10)
    # FE neighbour engine: "banded" (the port's), "windowed", "dense"
    neighbor_method: str = "banded"
    # cloud diameter hint: gates the bf16 candidate selection below
    spatial_extent: float = 20.0
    window_safety: float = 4.0       # static-band width (JAX CPU path)
    knn_window: int = 512            # windowed-engine width
    knn_query_chunk: int = 4608      # queries per candidate-KNN tile
    # distance-tile dtype of the candidate-KNN selection (None = f32)
    knn_select_dtype: str = "bfloat16"
    # above this spatial_extent the selection runs in f32 whatever
    # knn_select_dtype says
    knn_select_f32_extent: float = 50.0
    band_tile: int = 256             # static-band tile (JAX CPU path)
    centered_grid: bool = True       # D12: candidate grid centred on the keypoint
    dfe_src_neighbors: str = "cloud"  # D13: "cloud" or "keypoints"
    derotate_tgt_neighborhoods: bool = True  # D14
    # "topk" or "salient_fps" (FPS of K over the top pool_mult*K saliency pool)
    keypoint_selection: str = "topk"
    keypoint_pool_mult: int = 4
    use_pallas_band_max: bool = True  # exact-slab SA pooling (kernels K1/K2)
    candidate_knn: str = "auto"      # "auto", "exact" or "approx"
    tgt_knn: str = "flat"            # "flat", "two_level" or "auto"
    tgt_knn_table: int = 512         # two-level table rows per keypoint
    use_pallas_onehot_gather: bool = True

    @property
    def in_channels(self) -> int:
        return 6 if self.use_normal else 3

    @property
    def knn_select_dtype_effective(self):
        """The selection dtype the model actually uses: knn_select_dtype,
        gated on the declared cloud scale (knn_select_f32_extent)."""
        if self.spatial_extent <= self.knn_select_f32_extent:
            return self.knn_select_dtype
        return None

    @property
    def use_approx_knn(self) -> bool:
        """Whether candidate/source k-NN selection takes the approx_knn
        contract (see candidate_knn)."""
        if self.candidate_knn == "auto":
            return self.neighbor_method in ("windowed", "banded")
        return self.candidate_knn == "approx"

    @property
    def grid_reach(self) -> float:
        """Half-extent of the candidate cube around a warm keypoint."""
        return self.search_radius + (
            0.0 if self.centered_grid else self.voxel_len / 2.0)

    @property
    def use_two_level_tgt_knn(self) -> bool:
        """Whether the target branch groups candidates through the
        two-level per-keypoint table (see tgt_knn)."""
        if self.tgt_knn == "flat":
            return False
        if self.tgt_knn == "two_level":
            return True
        return (
            self.use_approx_knn
            and self.spatial_extent >= 8.0 * max(self.grid_reach, 1e-6)
        )

    @property
    def grid_size(self) -> int:
        return int(round(2.0 * self.search_radius / self.voxel_len)) + 1

    @property
    def num_candidates(self) -> int:
        return self.grid_size ** 3

    def resolve(self) -> "DeepVCPConfig":
        """Replace npoint=-1 sentinels with num_points; validate the
        enum-like string fields and the banded engine's geometry."""
        if self.neighbor_method not in ("banded", "windowed", "dense"):
            raise ValueError(
                f"neighbor_method must be one of 'banded'/'windowed'/'dense'"
                f", got {self.neighbor_method!r}"
            )
        if self.keypoint_selection not in ("topk", "salient_fps"):
            raise ValueError(
                f"keypoint_selection must be 'topk' (reference parity) or "
                f"'salient_fps', got {self.keypoint_selection!r}"
            )
        if self.keypoint_pool_mult < 1:
            raise ValueError(
                f"keypoint_pool_mult must be >= 1, got "
                f"{self.keypoint_pool_mult}"
            )
        if self.candidate_knn not in ("auto", "exact", "approx"):
            raise ValueError(
                f"candidate_knn must be 'auto'/'exact'/'approx', got "
                f"{self.candidate_knn!r}"
            )
        if self.tgt_knn not in ("auto", "two_level", "flat"):
            raise ValueError(
                f"tgt_knn must be 'auto'/'two_level'/'flat', got "
                f"{self.tgt_knn!r}"
            )
        if self.tgt_knn_table < 1:
            raise ValueError(
                f"tgt_knn_table must be >= 1, got {self.tgt_knn_table}"
            )
        if self.dfe_src_neighbors not in ("cloud", "keypoints"):
            raise ValueError(
                f"dfe_src_neighbors must be 'cloud' (D13 fix) or "
                f"'keypoints' (reference parity), got "
                f"{self.dfe_src_neighbors!r}"
            )
        if self.neighbor_method == "banded":
            rmax = max(l.radius for l in self.sa_layers)
            if 2.0 * rmax >= self.spatial_extent:
                raise ValueError(
                    f"banded neighbor engine requires spatial_extent > "
                    f"2*max(SA radius) = {2.0 * rmax} (got "
                    f"{self.spatial_extent}); raise spatial_extent or use "
                    f"neighbor_method='windowed'/'dense'"
                )
        layers = tuple(
            dataclasses.replace(l, npoint=self.num_points) if l.npoint == -1 else l
            for l in self.sa_layers
        )
        return dataclasses.replace(self, sa_layers=layers)

    @staticmethod
    def kitti_scale(
        num_points: int = 10000, use_normal: bool = False
    ) -> "DeepVCPConfig":
        """The velodyne-scale operating point: meter coordinates, ~25 m
        range; spatial_extent 55 puts the candidate selection in f32."""
        return DeepVCPConfig(
            num_points=num_points,
            use_normal=use_normal,
            spatial_extent=55.0,
        )

    @staticmethod
    def tiny(num_points: int = 128, use_normal: bool = True) -> "DeepVCPConfig":
        """Small config for tests (same topology, tiny N)."""
        return DeepVCPConfig(
            num_points=num_points,
            use_normal=use_normal,
            num_keypoints=16,
            num_neighbors=8,
            sa_layers=(
                SALayerConfig(npoint=-1, radius=0.4, nsample=16, mlp=(16, 16, 32)),
                SALayerConfig(npoint=-1, radius=0.8, nsample=16, mlp=(32, 64)),
                SALayerConfig(npoint=-1, radius=1.2, nsample=8, mlp=(64, 64)),
            ),
            query_chunk=64,
            spatial_extent=4.0,
            knn_window=min(128, num_points),
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (see the JAX file for each one's story)."""

    num_epochs: int = 10
    batch_size: int = 1
    learning_rate: float = 1e-3
    alpha: float = 0.5               # loss balancing factor
    inlier_ratio: float = 0.8        # SVD outlier rejection keep-fraction
    vcp_loss_weight: float = 0.0     # direct per-keypoint VCP L1 term
    rot_loss_weight: float = 0.0     # rotation term on the solved pose
    freeze_batch_stats: bool = False  # BatchNorm on the running statistics
    lr_schedule: str = "constant"    # "constant" or "cosine"
    warmup_steps: int = 100
    total_steps: int = 0             # required for lr_schedule="cosine"
    grad_clip_norm: float = 10.0     # global-norm clip; 0 disables
    use_saliency_weights: bool = False  # saliency-weighted Kabsch solves
    # warm-start distribution: "zero" or "gt" (t_gt + uniform jitter), and
    # a rotation jitter of up to init_rot_jitter_deg about a uniform axis
    init_translation: str = "zero"
    init_rot_jitter_deg: float = 0.0
    init_trans_jitter: float = 0.0
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    checkpoint_every_epochs: int = 1
    metrics_path: str = "metrics.jsonl"
    log_every: int = 5
    heartbeat_interval: float = 0.0  # > 0: heartbeat and watchdog in Trainer.fit
    heartbeat_stale_after: float = 120.0
