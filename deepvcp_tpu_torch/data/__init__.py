"""JAX-free data for the port."""

from deepvcp_tpu_torch.data.synthetic import (  # noqa: F401
    LidarLikeDataset,
    SyntheticDataset,
    batch_iterator,
    lidar_like_cloud,
    rotation_geodesic_deg,
    translation_error,
)
