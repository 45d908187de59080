"""The inference contract (port of deepvcp_tpu/registration.py: Registrar,
CascadeRegistrar and RoutedRegistrar):

    register(src_cloud, tgt_cloud, init_pose) -> (R, t, keypoints, vcps, ...)

Ground-truth-free: the pose comes from the two-pass trimmed Kabsch solve
(loss/registration.py::svd_refine), refined `refine_iters` times from the
best pose so far, with a guard that accepts an iteration's pose only where it
lowers the trimmed keypoint-to-target 1-NN distance. A CascadeRegistrar
chains Registrars, each warm-started from the previous stage's pose; a
RoutedRegistrar sends each batch to one of two experts' weights. `stream`
pipelines calls over an iterable of pairs.
"""

from __future__ import annotations

import collections
import warnings
from typing import Any, Iterable, Iterator, Mapping, NamedTuple, Optional

import torch

from deepvcp_tpu_torch.config import DeepVCPConfig
from deepvcp_tpu_torch import convert
from deepvcp_tpu_torch.loss.registration import svd_refine
from deepvcp_tpu_torch.models import DeepVCP
from deepvcp_tpu_torch.ops import apply_rigid, square_distance
from deepvcp_tpu_torch.ops.neighbors import slab_occupancy_stats, window_for
from deepvcp_tpu_torch.utils.profiling import annotate


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
    pretrained.load returns), converted, or the model's own state dict (what
    the port's Trainer saves under "model"); either loads strictly.
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
        state = convert.flax_to_torch(variables) if "params" in variables else variables
        self.model.load_state_dict(state, strict=True)
        self.model.to(self.device).eval().requires_grad_(False)
        self.inlier_ratio = inlier_ratio
        self.use_saliency_weights = use_saliency_weights
        self.refine_iters = refine_iters
        self.guard = guard
        # the extent monitor: the last extent warned about, and the extents
        # of earlier calls still on their way to the host
        self._declared_extent = cfg.resolve().spatial_extent
        self._warned_extent: Optional[float] = None
        self._pending_extents = collections.deque()
        self._audited = False

    def score(self, kp, tgt_xyz, R, t) -> torch.Tensor:
        """Trimmed mean 1-NN distance of the posed keypoints into the target
        cloud, [B]: the GT-free acceptance metric. The keypoints do not
        depend on the pose, so scores of different poses compare."""
        with annotate("deepvcp.score"):
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
        with annotate("deepvcp.register"):
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
        """Extent monitor, as the JAX Registrar's: warn when the cloud's
        extent exceeds 1.5x the declared cfg.spatial_extent, which gates the
        reduced-precision candidate selection, and warn again only when it
        has moved more than 1.5x from the extent last warned about. Without
        a host sync: on the card the extent is reduced on the device, copied
        to pinned host memory behind an event, and judged at a later call
        once the event has completed (so a warning may come one call late);
        on the CPU it is judged at once. The first call also runs the JAX
        preflight's slab-occupancy audit (_audit_windows)."""
        with annotate("deepvcp.extent"):
            if not self._audited:
                self._audited = True
                self._audit_windows(src)
            lo, hi = torch.aminmax(src[..., :3], dim=-2)
            extent = torch.amax(hi - lo)
            if extent.device.type == "cpu":
                self._judge_extent(float(extent))
                return
            while self._pending_extents and self._pending_extents[0][0].query():
                self._judge_extent(float(self._pending_extents.popleft()[1]))
            host = torch.empty((), dtype=extent.dtype, pin_memory=True)
            host.copy_(extent, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(extent.device))
            self._pending_extents.append((done, host))

    def _audit_windows(self, src: torch.Tensor) -> None:
        """The JAX preflight's slab-occupancy audit, once: the windowed
        engine and the static band (use_pallas_band_max=False) see only a
        window of window_for(N, r, spatial_extent, window_safety) sorted
        points around each query, sized for uniform density. Where a slab of
        this cloud holds more, warn with the window_safety that would cover
        it. The exact slab (K1) needs no audit. Reads the cloud on the host:
        one sync, on the first call only, and only for those engines."""
        cfg = self.cfg.resolve()
        if not (cfg.neighbor_method == "windowed" or (
                cfg.neighbor_method == "banded" and not cfg.use_pallas_band_max)):
            return
        xyz = src[..., :3].detach().cpu().numpy()
        N = xyz.shape[-2]
        worst = 0.0
        for layer in cfg.sa_layers:
            w = window_for(N, layer.radius, cfg.spatial_extent, cfg.window_safety)
            if w >= N:
                continue
            occ = slab_occupancy_stats(xyz, layer.radius)
            if occ["max"] > w:
                # the safety at which window_for's expected occupancy covers
                # the measured one (not the current safety scaled by occ / w,
                # which under-estimates where w was raised to its minimum)
                expected = N * min(2.0 * layer.radius / max(cfg.spatial_extent, 1e-6), 1.0)
                worst = max(worst, occ["max"] / max(expected, 1e-6))
        if worst > 0:
            warnings.warn(
                f"static neighbor windows under-cover this cloud's density "
                f"peaks (slab occupancy exceeds the window sized by "
                f"window_safety={cfg.window_safety:g}); over-dense queries "
                f"lose in-radius neighbors (zero-hit rows are masked, not "
                f"polluted). Raise window_safety to ~{worst:.1f}, or use "
                f"neighbor_method='banded' with use_pallas_band_max (exact "
                f"slab bounds) or 'dense'",
                stacklevel=4,
            )

    def _judge_extent(self, actual: float) -> None:
        declared = self._declared_extent
        if actual <= 1.5 * declared:
            return
        last = self._warned_extent
        if last is not None and last / 1.5 < actual < last * 1.5:
            return
        self._warned_extent = actual
        warnings.warn(
            f"cloud extent {actual:.1f} exceeds cfg.spatial_extent="
            f"{declared:g}: candidate-KNN selection precision is "
            f"sized for the declared extent — set spatial_extent to the "
            f"real cloud scale (bf16 selection auto-disables above "
            f"{self.cfg.resolve().knn_select_f32_extent:g})",
            stacklevel=4,
        )

    def stream(self, pairs: Iterable, depth: int = 4) -> Iterator[RegistrationOutput]:
        """Pipelined registration over an iterable of (src, tgt[, R_init,
        t_init]) tuples on the registrar's device: outputs in input order,
        with at most `depth` calls in flight. Each call's own host syncs
        (the candidate grid's copy to the card in every refinement,
        ops/voxelize.py) bound what the pipeline can overlap."""
        return _stream(self, pairs, depth)


def _stream(register, pairs: Iterable, depth: int) -> Iterator[RegistrationOutput]:
    """Yield register(*pair) for each pair, in input order, with at most
    `depth` calls issued and not yet drained. A call is drained by copying
    its R to the host, which waits for the device's work on it: on the card
    the later calls are issued while the earlier ones run."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    inflight = collections.deque()

    def drain():
        out = inflight.popleft()
        with annotate("deepvcp.drain"):
            out.R.cpu()
        return out

    for pair in pairs:
        inflight.append(register(*pair))
        if len(inflight) >= depth:
            yield drain()
    while inflight:
        yield drain()


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

    @property
    def device(self) -> torch.device:
        return self.stages[0].device

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

    def stream(self, pairs: Iterable, depth: int = 4) -> Iterator[RegistrationOutput]:
        """Pipelined cascade (see Registrar.stream): every stage of up to
        `depth` pairs is issued before the oldest pair is drained."""
        return _stream(self, pairs, depth)


class _Call(torch.nn.Module):
    """The Registrar's call as a module around its model, so that
    torch.func.functional_call can run it under other weights."""

    def __init__(self, registrar: Registrar):
        super().__init__()
        self.model = registrar.model
        self._registrar = [registrar]   # in a list: not a submodule

    def forward(self, src, tgt, R_init, t_init):
        return self._registrar[0](src, tgt, R_init, t_init)


class RoutedRegistrar:
    """Mixture of experts: each batch goes to the weights of the expert
    trained on its distribution (counterpart of the JAX RoutedRegistrar).

    The router statistic is the coefficient of variation of 1-NN distances
    over a strided 512-point subsample of each source cloud (uniform clouds
    measure 0.51-0.58, lidar-like ones 0.92-1.15); the batch's mean against
    `threshold` is one vote per batch: above it, the "high" weights.

    Both experts' weights stay on the device as one flat buffer each. A
    call selects between them with one torch.where on the vote, which stays
    on the device (no host sync, as JAX selects in-graph), and runs the one
    model under the selected weights through torch.func.functional_call."""

    def __init__(self, cfg: DeepVCPConfig, variants: Mapping[str, Any], device: torch.device,
                 threshold: float = 0.75, **registrar_kwargs):
        """variants: {"low": variables, "high": variables}, flax layout."""
        if set(variants) != {"low", "high"}:
            raise ValueError(f"variants must have keys 'low'/'high', got {sorted(variants)}")
        self._reg = Registrar(cfg, variants["low"], device, **registrar_kwargs)
        self._call = _Call(self._reg)
        self.threshold = threshold
        low, high = (convert.flax_to_torch(variants[k]) for k in ("low", "high"))
        self._names = [k for k, v in low.items() if v.is_floating_point()]
        self._shapes = [low[k].shape for k in self._names]
        self._sizes = [low[k].numel() for k in self._names]
        self._experts = torch.stack([
            torch.cat([state[k].reshape(-1) for k in self._names]) for state in (low, high)
        ]).to(self._reg.device)                           # [2, P]: low, high

    @property
    def cfg(self) -> DeepVCPConfig:
        return self._reg.cfg

    @property
    def device(self) -> torch.device:
        return self._reg.device

    def route_statistic(self, src: torch.Tensor) -> torch.Tensor:
        """The router statistic of each cloud, [B]."""
        xyz = src[..., :3]
        step = max(xyz.shape[-2] // 512, 1)
        sub = xyz[:, ::step][:, :512]
        d2 = square_distance(sub, sub)
        d2 = torch.where(d2 <= 1e-12, torch.inf, d2)   # drop the self-match
        nn = torch.sqrt(torch.amin(d2, dim=-1))
        return torch.std(nn, dim=-1, correction=0) / (torch.mean(nn, dim=-1) + 1e-12)

    def route(self, src: torch.Tensor) -> torch.Tensor:
        """The batch's vote, a bool scalar tensor on the device: True sends
        it to the "high" expert."""
        return torch.mean(self.route_statistic(src)) > self.threshold

    def weights(self, is_high: torch.Tensor) -> dict:
        """The model's floating-point parameters and buffers of the expert
        the vote picks, by name, as views of one selected buffer."""
        flat = torch.where(is_high, self._experts[1], self._experts[0])
        return {f"model.{name}": part.view(shape) for name, shape, part in
                zip(self._names, self._shapes, torch.split(flat, self._sizes))}

    @torch.no_grad()
    def __call__(
        self,
        src: torch.Tensor,
        tgt: torch.Tensor,
        R_init: Optional[torch.Tensor] = None,
        t_init: Optional[torch.Tensor] = None,
    ) -> RegistrationOutput:
        return torch.func.functional_call(
            self._call, self.weights(self.route(src)), (src, tgt, R_init, t_init))

    def stream(self, pairs: Iterable, depth: int = 4) -> Iterator[RegistrationOutput]:
        """Pipelined routed registration (see Registrar.stream)."""
        return _stream(self, pairs, depth)
