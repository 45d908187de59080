"""The plain reference of DeepVCP registration (Lu et al., ICCV 2019,
https://arxiv.org/abs/1905.04153) under a configuration file of
benchmark/configs: plain PyTorch, no kernel, no cache, no batching beyond the
call's own, float32.

It is a frozen copy of the arithmetic of the port's plain path
(deepvcp_tpu_torch: the banded feature extraction on the exact in-radius
slab, the weighting layer and top-K keypoints, the source neighbourhoods from
the keypoint's k-NN in the whole source cloud, the centred voxel candidates,
the flat or the two-level candidate k-NN, the derotated and distance-weighted
target neighbourhoods, the shared DFE, the CPG cost volume with its softmax,
the two-pass trimmed Kabsch solve and the guarded refinement), written
against the flax parameter names of the exported weights. It imports
nothing of the port: the port's kernels K1 (the in-radius max) and K4 (the
table gather) are written out here as their definitions, and each op is
the one the port's plain path issues, in the same order, so that on one card
the two agree to rounding.

The precision is the configuration's: float32 with TF32 off for matmuls and
convolutions. `Reference(..., allow_tf32=True)` computes the same in TF32:
the control that benchmark/control.py holds against the comparison.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

NEG = -1e30
BN_EPS = 1e-5
EPS = 1e-8
BAND_CHUNK = 64          # queries per [B, chunk, N, C] block of the in-radius max
# the path this reference implements: a configuration must set these fields so
PATH = {"neighbor_method": "banded", "use_pallas_band_max": True, "use_normal": False,
        "use_batchnorm": True, "compute_dtype": "float32", "keypoint_selection": "topk",
        "dfe_src_neighbors": "cloud", "derotate_tgt_neighborhoods": True,
        "centered_grid": True, "candidate_knn": "auto"}


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """The exported weights, by flax path ("params/fe/sa1/proj_xyz/kernel")."""
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


@contextlib.contextmanager
def tf32(enabled: bool):
    """Within the block, float32 matmuls and cuDNN convolutions run in TF32
    iff `enabled`; the previous settings come back after it."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] x [..., M, 3] -> [..., N, M]: |a|^2 + |b|^2 - 2 a.b,
    clamped at 0."""
    a2 = torch.sum(a * a, dim=-1)
    b2 = torch.sum(b * b, dim=-1)
    cross = a @ b.transpose(-1, -2)
    return torch.clamp_min(a2[..., :, None] + b2[..., None, :] - 2.0 * cross, 0.0)


def knn_idx(ref: torch.Tensor, query: torch.Tensor, k: int, chunk: Optional[int] = None,
            select_dtype: Optional[str] = None) -> torch.Tensor:
    """Indices [B, M, k] of the k nearest points of ref [B, N, 3] to each
    query [B, M, 3], ascending: an exact selection over a distance tile,
    `chunk` queries at a time. With `select_dtype` the tile is the
    reduced-precision one: coordinates centred on ref's mean, products of
    inputs rounded to that dtype accumulated in f32, d^2 rounded to it."""
    sel = getattr(torch, select_dtype) if select_dtype else None
    if sel is not None:
        center = ref.mean(dim=-2, keepdim=True)
        ref = ref - center
        query = query - center
    r2 = torch.sum(ref * ref, dim=-1)

    def run(q):
        if sel is not None:
            s2 = torch.sum(q * q, dim=-1)
            cross = q.to(sel).float() @ ref.to(sel).float().transpose(-1, -2)
            d2 = (s2[..., :, None] + r2[..., None, :] - 2.0 * cross).to(sel)
        else:
            d2 = square_distance(q, ref)
        return torch.topk(d2, k, dim=-1, largest=False).indices

    if chunk is None or query.shape[1] <= chunk:
        return run(query)
    return torch.cat([run(q) for q in torch.split(query, chunk, dim=1)], dim=1)


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] -> [B, *idx.shape[1:], C]."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def in_radius_max(xyz: torch.Tensor, u: torch.Tensor, radius: float) -> torch.Tensor:
    """out[b, q, c] = max of u[b, n, c] over every n with |x_n - x_q|^2 <= r^2
    (r^2 rounded once to f32; d^2 = ((dx*dx)+(dy*dy))+(dz*dz) in f32),
    -1e30 where none: the definition of the exact slab's pooling."""
    r2 = float(np.float32(float(radius) ** 2))
    out = torch.empty_like(u)
    for s in range(0, xyz.shape[1], BAND_CHUNK):
        q = xyz[:, s:s + BAND_CHUNK]
        d = xyz[:, None, :, :] - q[:, :, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        inside = (d2 <= r2)[..., None]
        out[:, s:s + BAND_CHUNK] = torch.where(inside, u[:, None], NEG).amax(dim=2)
    return out


def apply_rigid(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return points @ R.transpose(-1, -2) + t[..., None, :]


def kabsch(x: torch.Tensor, y: torch.Tensor, weights: Optional[torch.Tensor]):
    """Weighted Kabsch with the reflection fix: (R, t) minimising the
    weighted squared residual of x @ R.T + t against y."""
    w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device) if weights is None \
        else weights.to(x.dtype)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-12)
    cx = torch.einsum("...n,...nc->...c", w, x)
    cy = torch.einsum("...n,...nc->...c", w, y)
    dx = x - cx[..., None, :]
    dy = y - cy[..., None, :]
    H = torch.einsum("...na,...n,...nb->...ab", dx, w, dy)
    u, _, vt = torch.linalg.svd(H)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(v @ ut))
    z = torch.ones(x.shape[:-2] + (3,), dtype=x.dtype, device=x.device)
    z[..., 2] = d
    R = (v * z[..., None, :]) @ ut
    return R, cy - torch.einsum("...ab,...b->...a", R, cx)


def trimmed_kabsch(x: torch.Tensor, y: torch.Tensor, inlier_ratio: float,
                   weights: Optional[torch.Tensor]):
    """Kabsch on (x, y), keep the inlier_ratio best-fitting pairs by their
    residual to that fit, and solve again on them."""
    R1, t1 = kabsch(x, y, weights)
    resid = torch.sum(torch.square(y - apply_rigid(x, R1, t1)), dim=-1)
    num_in = max(int(x.shape[-2] * inlier_ratio), 3)
    _, in_idx = torch.topk(resid, num_in, dim=-1, largest=False)
    def take(a):
        return torch.gather(a, -2, in_idx[..., None].expand(-1, -1, a.shape[-1]))

    w_in = torch.gather(weights, -1, in_idx) if weights is not None else None
    return kabsch(take(x), take(y), w_in)


class Reference:
    """Registration of a configuration file's model under its weights
    (`params`: load_npz's dict), on `device`."""

    def __init__(self, config: dict, params: Dict[str, np.ndarray], device,
                 allow_tf32: bool = False):
        other = {k: config["model"].get(k) for k, v in PATH.items() if config["model"].get(k) != v}
        if other or config["model"]["tgt_knn"] not in ("flat", "two_level"):
            raise ValueError(f"the reference implements {PATH} and tgt_knn flat or two_level; "
                             f"the configuration sets {other or config['model']['tgt_knn']}")
        self.m = config["model"]
        self.r = config["registrar"]
        self.allow_tf32 = allow_tf32
        self.p = {k: torch.as_tensor(v, device=device) for k, v in params.items()}
        # Dense kernels [in, out] as linear weights [out, in]; Conv kernels
        # [kd, kh, kw, in, out] as conv3d weights [out, in, kd, kh, kw]
        for k, v in list(self.p.items()):
            if k.endswith("/kernel"):
                self.p[k] = (v.T if v.dim() == 2 else v.permute(4, 3, 0, 1, 2)).contiguous()
        gs = int(round(2.0 * self.m["search_radius"] / self.m["voxel_len"])) + 1
        ax = self.m["voxel_len"] * (np.arange(gs) - (gs - 1) / 2.0)
        grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
        self.grid_size = gs
        self.offsets = torch.as_tensor(grid.astype(np.float32), device=device)

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        bias = self.p.get(f"params/{name}/bias")
        return F.linear(x, self.p[f"params/{name}/kernel"], bias)

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        y = F.batch_norm(x.reshape(-1, shape[-1]), self.p[f"batch_stats/{name}/mean"],
                         self.p[f"batch_stats/{name}/var"], self.p[f"params/{name}/scale"],
                         self.p[f"params/{name}/bias"], training=False, eps=BN_EPS)
        return y.reshape(shape)

    def features(self, xyz: torch.Tensor) -> torch.Tensor:
        """[B, N, 3] -> [B, N, feat_dim]: the SA stages on the cloud sorted
        along x (stable), pooled over each point's exact in-radius set, then
        the projection, back in the input order."""
        perm = torch.argsort(xyz[..., 0], dim=-1, stable=True)
        xyz = torch.gather(xyz, 1, perm[..., None].expand(-1, -1, 3))
        feats = None
        for i, layer in enumerate(self.m["sa_layers"]):
            sa = f"fe/sa{i + 1}"
            p = self.dense(f"{sa}/proj_xyz", xyz)
            u = p if feats is None else p + self.dense(f"{sa}/proj_feat", feats)
            h = torch.relu(in_radius_max(xyz, u, layer["radius"]) - p
                           + self.p[f"params/{sa}/bias0"])
            h = self.bn(f"{sa}/bn0", h)
            for j in range(1, len(layer["mlp"])):
                h = torch.relu(self.bn(f"{sa}/bn{j}", self.dense(f"{sa}/dense{j}", h)))
            feats = h
        feats = self.dense("fe/proj", feats)
        B, N = perm.shape
        inv = torch.empty_like(perm).scatter_(1, perm, torch.arange(N, device=perm.device)
                                              .expand(B, N))
        return gather_rows(feats, inv)

    def dfe(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.m["dfe_mlp"])
        for i in range(n):
            x = self.dense(f"dfe/Dense_{i}", x)
            if self.m["dfe_activation"] and i + 1 < n:
                x = torch.relu(x)
        return torch.amax(x, dim=-2)

    def saliency(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats
        n = len(self.m["wl_mlp"])
        for i in range(n - 1):
            x = torch.relu(self.dense(f"wl/Dense_{i}", x))
        return F.softplus(self.dense(f"wl/Dense_{n - 1}", x))[..., 0]

    def select_dtype(self) -> Optional[str]:
        """The flat tile's selection dtype: the configured one, in f32 above
        knn_select_f32_extent."""
        m = self.m
        return m["knn_select_dtype"] if m["spatial_extent"] <= m["knn_select_f32_extent"] \
            else None

    def encode(self, src: torch.Tensor, tgt: torch.Tensor) -> dict:
        m = self.m
        src_feat = self.features(src)
        saliency = self.saliency(src_feat)
        kp_sal, kp_idx = torch.topk(saliency, m["num_keypoints"], dim=-1)
        kp = gather_rows(src, kp_idx)
        nb_idx = knn_idx(src, kp, m["num_neighbors"], select_dtype=self.select_dtype())
        snb = gather_rows(torch.cat([src, src_feat], dim=-1), nb_idx)
        local = snb[..., :3] - kp[:, :, None, :]
        d = torch.linalg.norm(local, dim=-1)
        w = d / (torch.sum(d, dim=-1, keepdim=True) + EPS)
        src_desc = self.dfe(torch.cat([local, snb[..., 3:] * w[..., None]], dim=-1))
        table = torch.cat([tgt, self.features(tgt)], dim=-1)
        return dict(saliency=saliency, keypoints=kp, keypoint_saliency=kp_sal,
                    src_desc=src_desc, tgt=tgt, table=table)

    def neighbors(self, enc: dict, kp_warm: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        """Each candidate's num_neighbors nearest target rows, [B, K*C, ns, D]."""
        m = self.m
        B, K, C, _ = cand.shape
        ns = m["num_neighbors"]
        if m["tgt_knn"] == "two_level":
            T = min(m["tgt_knn_table"], enc["tgt"].shape[1])
            t_idx = knn_idx(enc["tgt"], kp_warm, T, select_dtype=self.select_dtype())
            table = gather_rows(enc["table"], t_idx)                       # [B, K, T, D]
            local_t = table[..., :3] - kp_warm[:, :, None, :]
            local_c = cand - kp_warm[:, :, None, :]
            s2 = torch.sum(local_c * local_c, dim=-1)[..., :, None]
            r2 = torch.sum(local_t * local_t, dim=-1)[..., None, :]
            sel = getattr(torch, m["knn_select_dtype"])
            cross = local_c.to(sel).float() @ local_t.to(sel).float().transpose(-1, -2)
            l_idx = torch.topk((s2 + r2 - 2.0 * cross).to(sel), ns, dim=-1,
                               largest=False).indices                     # [B, K, C, ns]
            flat = l_idx.reshape(B, K, C * ns)
            rows = torch.gather(table, 2, flat[..., None].expand(-1, -1, -1, table.shape[-1]))
            return rows.reshape(B, K * C, ns, -1)
        idx = knn_idx(enc["tgt"], cand.reshape(B, K * C, 3), ns, chunk=m["knn_query_chunk"],
                      select_dtype=self.select_dtype())
        return gather_rows(enc["table"], idx)

    def correspond(self, enc: dict, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The virtual corresponding points [B, K, 3] from the pose (R, t)."""
        m = self.m
        kp_warm = apply_rigid(enc["keypoints"], R, t)
        cand = kp_warm[..., None, :] + self.offsets
        B, K, C, _ = cand.shape
        tnb = self.neighbors(enc, kp_warm, cand)
        local = tnb[..., :3] - cand.reshape(B, K * C, 1, 3)
        local = local @ R[:, None]                     # derotated into the source frame
        d = torch.linalg.norm(local, dim=-1)
        w = d / (torch.sum(d, dim=-1, keepdim=True) + EPS)
        tgt_cat = torch.cat([local, tnb[..., 3:] * w[..., None]], dim=-1)
        tgt_desc = self.dfe(tgt_cat.reshape(B, K, C, tnb.shape[-2], -1))
        gs = self.grid_size
        cost = torch.square(enc["src_desc"][:, :, None, :] - tgt_desc)
        x = cost.reshape(B * K, gs, gs, gs, cost.shape[-1]).permute(0, 4, 1, 2, 3)
        for i in range(len(m["cpg_channels"])):
            x = F.conv3d(x, self.p[f"params/cpg/Conv_{i}/kernel"],
                         self.p[f"params/cpg/Conv_{i}/bias"], padding=1)
        weights = torch.softmax(x.reshape(B, K, C), dim=-1)
        return torch.einsum("bkc,bkcd->bkd", weights, cand)

    def score(self, kp: torch.Tensor, tgt: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
        """Trimmed mean 1-NN distance of the posed keypoints into the target."""
        nn_d2 = torch.amin(square_distance(apply_rigid(kp, R, t), tgt), dim=-1)
        k_in = max(int(nn_d2.shape[-1] * self.r["inlier_ratio"]), 3)
        best, _ = torch.topk(nn_d2, k_in, dim=-1, largest=False)
        return torch.sqrt(torch.mean(torch.clamp_min(best, 0.0), dim=-1))

    @torch.no_grad()
    def register(self, src: torch.Tensor, tgt: torch.Tensor) -> Dict[str, torch.Tensor]:
        """src, tgt [B, N, 3] from the identity pose -> {"R", "t", "keypoints",
        "vcps", "saliency", "scores"} of the guarded refinement."""
        with tf32(self.allow_tf32):
            return self._register(src, tgt)

    def _register(self, src, tgt):
        r = self.r
        B = src.shape[0]
        enc = self.encode(src, tgt)
        kp = enc["keypoints"]
        R = torch.eye(3, dtype=src.dtype, device=src.device).expand(B, 3, 3)
        t = torch.zeros(B, 3, dtype=src.dtype, device=src.device)
        best = self.score(kp, tgt, R, t)
        scores = [best]
        weights = enc["keypoint_saliency"] if r["use_saliency_weights"] else None
        for _ in range(r["refine_iters"]):
            vcp = self.correspond(enc, R, t)
            R_new, t_new = trimmed_kabsch(kp, vcp, r["inlier_ratio"], weights)
            s = self.score(kp, tgt, R_new, t_new)
            scores.append(s)
            if r["guard"]:
                better = s < best
                R = torch.where(better[:, None, None], R_new, R)
                t = torch.where(better[:, None], t_new, t)
                best = torch.minimum(s, best)
            else:
                R, t, best = R_new, t_new, s
        return dict(R=R, t=t, keypoints=kp, vcps=vcp, saliency=enc["saliency"],
                    scores=torch.stack(scores, dim=-1))
