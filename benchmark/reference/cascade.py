"""The plain reference of a cascade (the port's CascadeRegistrar): one
plain DeepVCP reference (benchmark/reference/deepvcp.py) a stage of the
configuration, each on its own weights, model and registrar settings, each
starting from the previous stage's pose (the first from the pose it is
given, the identity where none), the `scores` blocks of the stages
concatenated in order. It imports nothing of the port."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import manifest
from benchmark.reference import deepvcp


class Reference:
    """Registration of a configuration file's stages under their weights
    (`params`: one load_npz dict a stage, in order), on `device`."""

    def __init__(self, config: dict, params: List[Dict[str, np.ndarray]], device,
                 allow_tf32: bool = False):
        stages = manifest.stages(config)
        if len(params) != len(stages):
            raise ValueError(f"{len(stages)} stages and {len(params)} weight sets")
        self.stages = [deepvcp.Reference(stage, p, device, allow_tf32=allow_tf32)
                       for stage, p in zip(stages, params)]

    def register(self, src: torch.Tensor, tgt: torch.Tensor, R_init: Optional[torch.Tensor] = None,
                 t_init: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """src, tgt [B, N, 3] -> the last stage's {"R", "t", "keypoints",
        "vcps", "saliency"}, with "scores" [B, sum of (refine_iters + 1)]."""
        blocks = []
        for stage in self.stages:
            out = stage.register(src, tgt, R_init, t_init)
            R_init, t_init = out["R"], out["t"]
            blocks.append(out["scores"])
        return dict(out, scores=torch.cat(blocks, dim=-1))
