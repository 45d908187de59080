"""Hand-written Hopper kernels (CUDA C++ in deepvcp_tpu_torch/csrc/), each
beside its plain PyTorch version. Nothing CUDA-specific happens at import."""

from deepvcp_tpu_torch.ops.kernels.band_max import (  # noqa: F401
    banded_masked_max,
    banded_masked_max_grad,
    banded_masked_max_grad_reference,
    banded_masked_max_reference,
)
