"""The inference contract (port of deepvcp_tpu/registration.py: Registrar
and CascadeRegistrar):

    register(src_cloud, tgt_cloud, init_pose) -> (R, t, keypoints, vcps, ...)

Ground-truth-free: the pose comes from the two-pass trimmed Kabsch solve
(loss/registration.py::svd_refine), refined `refine_iters` times from the
best pose so far, with a guard that accepts an iteration's pose only where it
lowers the trimmed keypoint-to-target 1-NN distance. A CascadeRegistrar
chains Registrars, each warm-started from the previous stage's pose.
"""

from __future__ import annotations

import warnings
from typing import Any, Mapping, NamedTuple, Optional

import torch

from deepvcp_tpu_torch.config import DeepVCPConfig
from deepvcp_tpu_torch import convert
from deepvcp_tpu_torch.loss.registration import svd_refine
from deepvcp_tpu_torch.models import DeepVCP
from deepvcp_tpu_torch.ops import apply_rigid, square_distance


class RegistrationOutput(NamedTuple):
    R: torch.Tensor           # [B, 3, 3] estimated rotation
    t: torch.Tensor           # [B, 3] estimated translation
    keypoints: torch.Tensor   # [B, K, 3] selected source keypoints
    vcps: torch.Tensor        # [B, K, 3] predicted corresponding points
    inlier_idx: torch.Tensor  # [B, K'] inlier keypoint indices
    saliency: torch.Tensor    # [B, N] per-point saliency
    scores: torch.Tensor      # [B, refine_iters + 1]: score of the init pose
                              # (col 0) and of each iteration's candidate pose;
                              # (R, t) realises the row-wise minimum when guarded


class Registrar:
    """End-to-end registration with a trained model, on one device.

    `variables` are flax-layout {"params", "batch_stats"} arrays (what
    pretrained.load returns); they are converted and loaded strictly.
    See the JAX Registrar for the meaning of inlier_ratio,
    use_saliency_weights, refine_iters and guard."""

    def __init__(
        self,
        cfg: DeepVCPConfig,
        variables: Mapping[str, Any],
        device: torch.device,
        inlier_ratio: float = 0.8,
        use_saliency_weights: bool = False,
        refine_iters: int = 1,
        guard: bool = True,
    ):
        if refine_iters < 1:
            raise ValueError(f"refine_iters must be >= 1, got {refine_iters}")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" means the current card; tensors on it report its index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = DeepVCP(cfg)
        self.model.load_state_dict(convert.flax_to_torch(variables), strict=True)
        self.model.to(self.device).eval().requires_grad_(False)
        self.inlier_ratio = inlier_ratio
        self.use_saliency_weights = use_saliency_weights
        self.refine_iters = refine_iters
        self.guard = guard
        self._extent_checked = False

    def score(self, kp, tgt_xyz, R, t) -> torch.Tensor:
        """Trimmed mean 1-NN distance of the posed keypoints into the target
        cloud, [B]: the GT-free acceptance metric. The keypoints do not
        depend on the pose, so scores of different poses compare."""
        nn_d2 = torch.amin(square_distance(apply_rigid(kp, R, t), tgt_xyz), dim=-1)
        k_in = max(int(nn_d2.shape[-1] * self.inlier_ratio), 3)
        best, _ = torch.topk(nn_d2, k_in, dim=-1, largest=False)
        return torch.sqrt(torch.mean(torch.clamp_min(best, 0.0), dim=-1))

    @torch.no_grad()
    def __call__(
        self,
        src: torch.Tensor,
        tgt: torch.Tensor,
        R_init: Optional[torch.Tensor] = None,
        t_init: Optional[torch.Tensor] = None,
    ) -> RegistrationOutput:
        """src/tgt [B, N, 3(+3)] channels-last clouds on the registrar's
        device. The init pose defaults to identity."""
        for name, x in (("src", src), ("tgt", tgt), ("R_init", R_init), ("t_init", t_init)):
            if x is not None and x.device != self.device:
                raise ValueError(f"{name} is on {x.device}, the registrar on {self.device}")
        B = src.shape[0]
        self._check_extent(src)
        if R_init is None:
            R_init = torch.eye(3, dtype=src.dtype, device=self.device).expand(B, 3, 3)
        if t_init is None:
            t_init = torch.zeros(B, 3, dtype=src.dtype, device=self.device)
        enc = self.model.encode(src, tgt)
        kp = enc.keypoints
        R_best, t_best = R_init, t_init
        score_best = self.score(kp, enc.tgt_xyz, R_init, t_init)
        scores = [score_best]
        for _ in range(self.refine_iters):
            kp, vcp, aux = self.model.correspond(enc, R_best, t_best)
            weights = aux["keypoint_saliency"] if self.use_saliency_weights else None
            ref = svd_refine(kp, vcp, self.inlier_ratio, weights)
            if self.guard:
                s = self.score(kp, enc.tgt_xyz, ref.R, ref.t)
                scores.append(s)
                better = s < score_best
                R_best = torch.where(better[:, None, None], ref.R, R_best)
                t_best = torch.where(better[:, None], ref.t, t_best)
                score_best = torch.minimum(s, score_best)
            else:
                R_best, t_best = ref.R, ref.t
                score_best = self.score(kp, enc.tgt_xyz, R_best, t_best)
                scores.append(score_best)
        return RegistrationOutput(
            R=R_best, t=t_best, keypoints=kp, vcps=vcp, inlier_idx=ref.inlier_idx,
            saliency=enc.saliency, scores=torch.stack(scores, dim=-1))

    def _check_extent(self, src: torch.Tensor) -> None:
        """One-time data preflight: warn when the cloud's extent exceeds the
        declared cfg.spatial_extent, which gates the reduced-precision
        candidate selection. (The JAX preflight also audits static-window
        occupancy; the port always scans the exact slab, so that audit has
        nothing to check.)"""
        if self._extent_checked:
            return
        self._extent_checked = True
        xyz = src[..., :3]
        actual = float(torch.amax(torch.amax(xyz, dim=-2) - torch.amin(xyz, dim=-2)))
        cfg = self.cfg.resolve()
        if actual > 1.5 * cfg.spatial_extent:
            warnings.warn(
                f"cloud extent {actual:.1f} exceeds cfg.spatial_extent="
                f"{cfg.spatial_extent:g}: candidate-KNN selection precision is "
                f"sized for the declared extent — set spatial_extent to the "
                f"real cloud scale (bf16 selection auto-disables above "
                f"{cfg.knn_select_f32_extent:g})",
                stacklevel=3,
            )


class CascadeRegistrar:
    """Coarse-to-fine registration: a sequence of Registrar stages on one
    device, each warm-started from the previous stage's pose. Each stage
    keeps its own guard and scores the incoming pose as its column 0, so
    the cascade never returns a pose worse than its init under any stage's
    keypoint metric. `scores` concatenates the stages' blocks:
    [B, sum_i (refine_iters_i + 1)]. Stages may differ in grid geometry and
    weights but must share the input contract (num_points, use_normal)."""

    def __init__(self, stages):
        if not stages:
            raise ValueError("CascadeRegistrar needs at least one stage")
        for a, b in zip(stages[:-1], stages[1:]):
            if (a.cfg.num_points, a.cfg.use_normal) != (b.cfg.num_points, b.cfg.use_normal):
                raise ValueError(
                    "cascade stages disagree on the input contract: "
                    f"{(a.cfg.num_points, a.cfg.use_normal)} vs "
                    f"{(b.cfg.num_points, b.cfg.use_normal)}")
            if a.device != b.device:
                raise ValueError(f"cascade stages on {a.device} and {b.device}")
        self.stages = list(stages)

    @property
    def cfg(self) -> DeepVCPConfig:
        """The last stage's config, under which the output pose was solved."""
        return self.stages[-1].cfg

    def __call__(
        self,
        src: torch.Tensor,
        tgt: torch.Tensor,
        R_init: Optional[torch.Tensor] = None,
        t_init: Optional[torch.Tensor] = None,
    ) -> RegistrationOutput:
        blocks = []
        for reg in self.stages:
            out = reg(src, tgt, R_init, t_init)
            R_init, t_init = out.R, out.t
            blocks.append(out.scores)
        return out._replace(scores=torch.cat(blocks, dim=-1))
