"""Small helpers of the port."""

from deepvcp_tpu_torch.utils.rotations import random_small_rotation  # noqa: F401
