"""Pose solves and the training loss of the port."""

from deepvcp_tpu_torch.loss.registration import (  # noqa: F401
    RefineResult,
    RegistrationResult,
    deepvcp_loss,
    svd_refine,
)
