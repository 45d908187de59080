"""PyTorch modules of the port."""

from deepvcp_tpu_torch.models.deepvcp import DeepVCP, Encoding  # noqa: F401
