"""JAX-free data for the port: synthetic and file datasets, pair
construction and the pose metrics."""

from deepvcp_tpu_torch.data.datasets import (  # noqa: F401
    KITTIDataset,
    ModelNet40Dataset,
    RegistrationPair,
    read_velodyne_bin,
)
from deepvcp_tpu_torch.data.synthetic import (  # noqa: F401
    LidarLikeDataset,
    SyntheticDataset,
    batch_iterator,
    lidar_like_cloud,
)
from deepvcp_tpu_torch.data.transforms import make_pair, random_pose, resample  # noqa: F401
from deepvcp_tpu_torch.utils.rotations import (  # noqa: F401
    rotation_geodesic_deg,
    translation_error,
)
