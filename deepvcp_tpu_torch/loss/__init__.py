"""Pose solves of the port."""

from deepvcp_tpu_torch.loss.registration import RefineResult, svd_refine  # noqa: F401
