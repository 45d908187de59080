"""Geometry ops of the port: plain PyTorch, plus the hand-written kernels
under ops/kernels/. Exports what deepvcp_tpu/ops/__init__.py exports, and the
port's own additions (approx_knn, the sorted-cloud helpers)."""

from deepvcp_tpu_torch.ops.distance import map_query_chunks, square_distance  # noqa: F401
from deepvcp_tpu_torch.ops.grouping import (  # noqa: F401
    group_all, group_neighbors, index_points, pc_normalize, query_ball_point, sample_and_group)
from deepvcp_tpu_torch.ops.kabsch import apply_rigid, kabsch  # noqa: F401
from deepvcp_tpu_torch.ops.knn import approx_knn, knn, nearest_neighbor_dist  # noqa: F401
from deepvcp_tpu_torch.ops.sampling import farthest_point_sample  # noqa: F401
from deepvcp_tpu_torch.ops.neighbors import SortedCloud, sort_cloud, window_for  # noqa: F401
from deepvcp_tpu_torch.ops.voxelize import candidate_offsets, voxelize  # noqa: F401
