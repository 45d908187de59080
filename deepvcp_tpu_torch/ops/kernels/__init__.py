"""Hand-written Hopper kernels (CUDA C++ in deepvcp_tpu_torch/csrc/), each
beside its plain PyTorch version. Nothing CUDA-specific happens at import.
`reference_path()` sends every wrapper to its plain version on the card."""

from deepvcp_tpu_torch.ops.kernels._plain import reference_path  # noqa: F401
from deepvcp_tpu_torch.ops.kernels.band_max import (  # noqa: F401
    banded_masked_max,
    banded_masked_max_grad,
    banded_masked_max_grad_reference,
    banded_masked_max_reference,
)
from deepvcp_tpu_torch.ops.kernels.fps import (  # noqa: F401
    farthest_point_sample,
    farthest_point_sample_reference,
)
# K4/K5 stay in their module, `ops.kernels.onehot_gather`: a function of
# the same name exported here would hide it
