"""Geometry ops of the port: plain PyTorch, plus the hand-written kernels
under ops/kernels/."""

from deepvcp_tpu_torch.ops.distance import map_query_chunks, square_distance  # noqa: F401
from deepvcp_tpu_torch.ops.grouping import index_points  # noqa: F401
from deepvcp_tpu_torch.ops.kabsch import apply_rigid, kabsch  # noqa: F401
from deepvcp_tpu_torch.ops.knn import approx_knn, knn  # noqa: F401
from deepvcp_tpu_torch.ops.sampling import farthest_point_sample  # noqa: F401
from deepvcp_tpu_torch.ops.neighbors import SortedCloud, sort_cloud, window_for  # noqa: F401
from deepvcp_tpu_torch.ops.voxelize import candidate_offsets, voxelize  # noqa: F401
