"""PyTorch modules of the port (the exports of deepvcp_tpu/models)."""

from deepvcp_tpu_torch.models.deepvcp import (  # noqa: F401
    DeepVCP, Encoding, create_deepvcp, point_partition)
from deepvcp_tpu_torch.models.extra_layers import (  # noqa: F401
    FeaturePropagation, SetAbstractionMSG)
from deepvcp_tpu_torch.models.fused_sa import (  # noqa: F401
    BandedSetAbstraction, batch_norm_group)
from deepvcp_tpu_torch.models.layers import (  # noqa: F401
    CPG, FeatEmbedding, FeatureExtraction, SetAbstraction, WeightingLayer)
