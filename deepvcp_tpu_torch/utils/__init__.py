"""Small helpers of the port: rotations and pose metrics."""

from deepvcp_tpu_torch.utils.rotations import (  # noqa: F401
    axis_angle_to_matrix,
    euler_error_deg,
    euler_to_matrix,
    euler_xyz_deg,
    random_bounded_rotation,
    random_rotation,
    random_small_rotation,
    rot_x,
    rot_y,
    rot_z,
    rotation_geodesic_deg,
    translation_error,
)
