"""Sequence odometry's geometry: SO(3) maps, pose chaining, pose-graph
optimisation, landmark bundle adjustment and trajectory metrics (port of
deepvcp_tpu/odometry/pose_graph.py).

Poses: an absolute pose (R_i, t_i) maps frame i into frame 0; an edge
(i, j) measures x_j = R_ij x_i + t_ij. The optimiser minimises, over all
edges,
    |log(R_ij_meas^T (R_j^T R_i))|^2 + |R_j^T (t_i - t_j) - t_ij_meas|^2
by damped Gauss-Newton on right-multiplicative so(3) increments and
additive translations, node 0 pinned, in float32 (TF32 is off for the
package). The Jacobian is taken in forward mode (torch.func.jacfwd), as JAX
does: log_so3's branches at theta = 0 hold an infinite arccos derivative,
which forward mode's torch.where selects away and reverse mode would
multiply by 0 into NaN. Solves use torch.linalg.solve_ex / inv_ex, so the
card does not wait on an error check each iteration.

The sharded variants split the edges (or the landmark observations) over a
mesh's "data" group: each rank builds the normal equations of its shard,
they are all-reduced (summed) over the group, and every rank solves the
whole system, as the JAX package's psum over its "data" axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deepvcp_tpu_torch.ops import apply_rigid, kabsch

# --- SO(3) -------------------------------------------------------------------


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat map: [..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vectors [..., 3] -> rotations [..., 3, 3]."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    small = theta < 1e-8
    safe = torch.where(small, 1.0, theta)
    A = torch.where(small, 1.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5, (1.0 - torch.cos(safe)) / (safe * safe))
    return eye + A * K + B * (K @ K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotations [..., 3, 3] -> rotation vectors [..., 3]."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta < 1e-7
    s = torch.where(small, 1.0, 2.0 * torch.sin(theta))
    scale = torch.where(small[..., None], 0.5, (theta / s)[..., None])
    return w * scale


# --- trajectory assembly -------------------------------------------------------


def chain_poses(R_rel: torch.Tensor, t_rel: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose relative poses (x_{i+1} = R_rel[i] x_i + t_rel[i]) into
    absolute ones mapping frame i into frame 0: R_0 = I,
    R_{i+1} = R_i R_rel[i]^T, t_{i+1} = t_i - R_{i+1} t_rel[i].
    [M, 3, 3], [M, 3] -> [M + 1, 3, 3], [M + 1, 3]."""
    R = [torch.eye(3, dtype=R_rel.dtype, device=R_rel.device)]
    t = [torch.zeros(3, dtype=R_rel.dtype, device=R_rel.device)]
    for Rr, tr in zip(R_rel, t_rel):
        R.append(R[-1] @ Rr.T)
        t.append(t[-1] - R[-1] @ tr)
    return torch.stack(R), torch.stack(t)


# --- pose graph ------------------------------------------------------------------


class PoseGraph(NamedTuple):
    edges_i: torch.Tensor   # [E] int64 source node
    edges_j: torch.Tensor   # [E] int64 target node
    R_meas: torch.Tensor    # [E, 3, 3] measured R_ij (frame i -> frame j)
    t_meas: torch.Tensor    # [E, 3]
    weights: torch.Tensor   # [E] edge confidence


def build_graph(
    R_rel: torch.Tensor,
    t_rel: torch.Tensor,
    extra_edges: Optional[Sequence[Tuple[int, int, np.ndarray, np.ndarray]]] = None,
    weights: Optional[torch.Tensor] = None,
) -> PoseGraph:
    """Sequential edges i -> i + 1 from the relative poses, then the extra
    (loop-closure or skip) edges (i, j, R_ij, t_ij), each measuring
    x_j = R_ij x_i + t_ij; on R_rel's device, float32."""
    dev = R_rel.device
    M = R_rel.shape[0]
    ei, ej = list(range(M)), list(range(1, M + 1))
    Rm = [R_rel.to(torch.float32)]
    tm = [t_rel.to(torch.float32)]
    for i, j, R_ij, t_ij in extra_edges or []:
        ei.append(i)
        ej.append(j)
        Rm.append(torch.as_tensor(np.asarray(R_ij), dtype=torch.float32, device=dev)[None])
        tm.append(torch.as_tensor(np.asarray(t_ij), dtype=torch.float32, device=dev)[None])
    E = len(ei)
    w = weights if weights is not None else torch.ones(E, dtype=torch.float32, device=dev)
    return PoseGraph(edges_i=torch.tensor(ei, device=dev), edges_j=torch.tensor(ej, device=dev),
                     R_meas=torch.cat(Rm), t_meas=torch.cat(tm), weights=w)


def _edge_residuals(graph: PoseGraph, R_abs: torch.Tensor, t_abs: torch.Tensor):
    """Rotation and translation residuals of every edge, weighted: [E, 3]
    each. The predicted edge is R_ij = R_j^T R_i, t_ij = R_j^T (t_i - t_j)."""
    Ri, Rj = R_abs[graph.edges_i], R_abs[graph.edges_j]
    ti, tj = t_abs[graph.edges_i], t_abs[graph.edges_j]
    R_pred = torch.einsum("eba,ebc->eac", Rj, Ri)
    t_pred = torch.einsum("eba,eb->ea", Rj, ti - tj)
    r_rot = log_so3(torch.einsum("eba,ebc->eac", graph.R_meas, R_pred))
    w = graph.weights[:, None]
    return r_rot * w, (t_pred - graph.t_meas) * w


def _pinned(num_nodes: int, device) -> torch.Tensor:
    """[num_nodes, 1] mask that holds node 0 (the gauge) fixed."""
    mask = torch.ones(num_nodes, 1, dtype=torch.float32, device=device)
    mask[0] = 0.0
    return mask


def _graph_normal_equations(graph: PoseGraph, R_abs, t_abs, pin, rot_weight: float):
    """J^T J [6F, 6F] and J^T r [6F] of the graph's stacked residual at the
    current poses, J by forward mode over the [F, 6] increment."""
    F = R_abs.shape[0]

    def residual_vec(delta):
        dw, dt = delta[:, :3] * pin, delta[:, 3:] * pin
        r_rot, r_trans = _edge_residuals(graph, R_abs @ exp_so3(dw), t_abs + dt)
        return torch.cat([rot_weight * r_rot.reshape(-1), r_trans.reshape(-1)])

    delta0 = torch.zeros(F, 6, dtype=torch.float32, device=R_abs.device)
    J = torch.func.jacfwd(residual_vec)(delta0).reshape(-1, F * 6)
    r = residual_vec(delta0)
    return J.T @ J, J.T @ r


def _solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(H, g[:, None])[0][:, 0]


def optimize_pose_graph(
    graph: PoseGraph,
    R_init: torch.Tensor,
    t_init: torch.Tensor,
    num_iters: int = 50,
    lr: float = 0.0,
    damping: float = 1e-3,
    rot_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine absolute poses by `num_iters` damped Gauss-Newton steps on a
    dense [6F, 6F] system, node 0 pinned; on the graph's device, float32.
    Returns (R_abs [F, 3, 3], t_abs [F, 3]). `lr` is unused, as in JAX."""
    F = R_init.shape[0]
    dev = R_init.device
    pin = _pinned(F, dev)
    damp = damping * torch.eye(F * 6, dtype=torch.float32, device=dev)
    R_abs, t_abs = R_init.to(torch.float32), t_init.to(torch.float32)
    for _ in range(num_iters):
        H, g = _graph_normal_equations(graph, R_abs, t_abs, pin, rot_weight)
        delta = -_solve(H + damp, g).reshape(F, 6)
        R_abs = R_abs @ exp_so3(delta[:, :3] * pin)
        t_abs = t_abs + delta[:, 3:] * pin
    return R_abs, t_abs


def _data_shard(mesh):
    """(group, size, index) of this rank along the mesh's "data" dim."""
    from deepvcp_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, axis_index, axis_size

    return axis_group(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)


def _my_shard(parts: Sequence[torch.Tensor], pads: Sequence[torch.Tensor], size: int,
              index: int) -> list:
    """Each of `parts` (a leading entry axis of one length E) padded with
    the matching `pads` row repeated to a multiple of `size` entries, and
    this rank's contiguous 1/size of it."""
    E = parts[0].shape[0]
    pad = (-E) % size
    per = (E + pad) // size
    return [torch.cat([a, p.expand(pad, *p.shape).to(a)])[index * per:(index + 1) * per]
            for a, p in zip(parts, pads)]


def _sum_over(group, tensors: Sequence[torch.Tensor]) -> list:
    """`tensors` summed over the process group, in one all-reduce."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.view_as(t) for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors]))]


def optimize_pose_graph_sharded(
    graph: PoseGraph,
    R_init: torch.Tensor,
    t_init: torch.Tensor,
    mesh,
    num_iters: int = 20,
    damping: float = 1e-3,
    rot_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """optimize_pose_graph with the edges split over the mesh's "data"
    group: every rank passes the whole graph and initial poses, builds
    H = sum_e J_e^T J_e and g = sum_e J_e^T r_e over its shard of the edges,
    the parts are summed over the group, and every rank solves the dense
    system. Edges are padded to a multiple of the group's size with
    zero-weight self-edges (0, 0, I, 0, w = 0), exact no-ops. Returns the
    same (R_abs, t_abs) on every rank."""
    group, size, index = _data_shard(mesh)
    F = R_init.shape[0]
    dev = R_init.device
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    zero_i = torch.zeros((), dtype=graph.edges_i.dtype, device=dev)
    shard = PoseGraph(*_my_shard(
        [graph.edges_i, graph.edges_j, graph.R_meas.to(torch.float32),
         graph.t_meas.to(torch.float32), graph.weights.to(torch.float32)],
        [zero_i, zero_i, eye, zero.expand(3), zero], size, index))
    pin = _pinned(F, dev)
    damp = damping * torch.eye(F * 6, dtype=torch.float32, device=dev)
    R_abs, t_abs = R_init.to(torch.float32), t_init.to(torch.float32)
    for _ in range(num_iters):
        H, g = _sum_over(group, _graph_normal_equations(shard, R_abs, t_abs, pin, rot_weight))
        delta = -_solve(H + damp, g).reshape(F, 6)
        R_abs = R_abs @ exp_so3(delta[:, :3] * pin)
        t_abs = t_abs + delta[:, 3:] * pin
    return R_abs, t_abs


# --- trajectory metrics --------------------------------------------------------------


def absolute_trajectory_error(t_pred: torch.Tensor, t_true: torch.Tensor,
                              align: bool = True) -> torch.Tensor:
    """ATE: RMSE of the translations, after a rigid (Kabsch) alignment of
    the predicted trajectory to the true one when `align`."""
    if align:
        R, t = kabsch(t_pred[None], t_true[None])
        t_pred = apply_rigid(t_pred[None], R, t)[0]
    err = torch.linalg.norm(t_pred - t_true, dim=-1)
    return torch.sqrt(torch.mean(err * err))


def relative_pose_errors(R_pred: torch.Tensor, t_pred: torch.Tensor, R_true: torch.Tensor,
                         t_true: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """RPE between consecutive frames of two absolute trajectories: rotation
    (deg) and translation errors, [F - 1] each."""
    def rel(R, t):
        R_ij = torch.einsum("eba,ebc->eac", R[1:], R[:-1])
        t_ij = torch.einsum("eba,eb->ea", R[1:], t[:-1] - t[1:])
        return R_ij, t_ij

    Rp, tp = rel(R_pred, t_pred)
    Rt, tt = rel(R_true, t_true)
    dR = torch.einsum("eba,ebc->eac", Rp, Rt)
    ang = torch.rad2deg(torch.linalg.norm(log_so3(dR), dim=-1))
    return ang, torch.linalg.norm(tp - tt, dim=-1)


# --- landmark bundle adjustment (Schur complement) -----------------------------------


class LandmarkObs(NamedTuple):
    """Landmark lm[k] seen in frame frame[k] at frame-local xyz[k]."""

    frame: torch.Tensor    # [O] int64 node index
    lm: torch.Tensor       # [O] int64 landmark index
    xyz: torch.Tensor      # [O, 3] observed position in frame coordinates
    weights: torch.Tensor  # [O] confidence


def _segment_sum(values: torch.Tensor, segments: torch.Tensor, num: int) -> torch.Tensor:
    out = torch.zeros((num,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_add_(0, segments, values)


def _ba_normal_equations(R_abs, t_abs, landmarks, obs: LandmarkObs, num_nodes: int,
                         num_lm: int):
    """The landmark residuals' normal-equation blocks, r = R_f^T (p_l - t_f)
    - obs, with analytic Jacobians under the pose graph's increments:
    dr/ddw = hat(R_f^T (p_l - t_f)), dr/ddt = -R_f^T, dr/dp = R_f^T.
    Returns (Hpp [N, 6, 6], Hpl [N * L, 6, 3], Hll [L, 3, 3], gp [N, 6],
    gl [L, 3]), each summed over the observations."""
    Rf, tf = R_abs[obs.frame], t_abs[obs.frame]
    y = torch.einsum("oba,ob->oa", Rf, landmarks[obs.lm] - tf)
    r = y - obs.xyz
    w = obs.weights[:, None, None]
    Jl = Rf.transpose(-1, -2)
    Jp = torch.cat([hat(y), -Jl], dim=-1)            # [O, 3, 6]
    JpT, JlT = Jp.transpose(-1, -2), Jl.transpose(-1, -2)
    Hpp = _segment_sum(w * (JpT @ Jp), obs.frame, num_nodes)
    Hll = _segment_sum(w * (JlT @ Jl), obs.lm, num_lm)
    Hpl = _segment_sum(w * (JpT @ Jl), obs.frame * num_lm + obs.lm, num_nodes * num_lm)
    gp = _segment_sum(w[..., 0] * (JpT @ r[..., None])[..., 0], obs.frame, num_nodes)
    gl = _segment_sum(w[..., 0] * (JlT @ r[..., None])[..., 0], obs.lm, num_lm)
    return Hpp, Hpl, Hll, gp, gl


def optimize_landmark_ba(
    graph: Optional[PoseGraph],
    R_init: torch.Tensor,
    t_init: torch.Tensor,
    landmarks_init: torch.Tensor,
    obs: LandmarkObs,
    mesh=None,
    num_iters: int = 20,
    damping: float = 1e-3,
    rot_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint pose and landmark bundle adjustment by Gauss-Newton on the
    Schur complement: each step solves the reduced [6N, 6N] system
        S = Hpp - Hpl Hll^-1 Hlp,  S dx_p = -(gp - Hpl Hll^-1 gl)
    then back-substitutes dx_l = -Hll^-1 (gl + Hlp dx_p). The optional pose
    graph adds its edges' terms to Hpp / gp. Node 0 is pinned. Returns
    (R_abs, t_abs, landmarks).

    With a `mesh`, the observations are split over its "data" group (padded
    to a multiple of its size with zero-weight observations of landmark 0
    in frame 0), each rank sums its shard's blocks Hpp, Hpl, Hll, gp and gl,
    they are summed over the group, and every rank solves the reduced
    system; every rank passes all the observations and gets the same
    result."""
    N, L = R_init.shape[0], landmarks_init.shape[0]
    dev = R_init.device
    group = None
    if mesh is not None:
        group, size, index = _data_shard(mesh)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        zero_i = torch.zeros((), dtype=obs.frame.dtype, device=dev)
        obs = LandmarkObs(*_my_shard(
            [obs.frame, obs.lm, obs.xyz.to(torch.float32), obs.weights.to(torch.float32)],
            [zero_i, zero_i.to(obs.lm.dtype), zero.expand(3), zero], size, index))
    pin = _pinned(N, dev)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    damp = damping * torch.eye(N * 6, dtype=torch.float32, device=dev)
    idx = torch.arange(N, device=dev)
    R_abs, t_abs = R_init.to(torch.float32), t_init.to(torch.float32)
    lms = landmarks_init.to(torch.float32)
    for _ in range(num_iters):
        Hpp_o, Hpl, Hll, gp, gl = _ba_normal_equations(R_abs, t_abs, lms, obs, N, L)
        if group is not None:
            Hpp_o, Hpl, Hll, gp, gl = _sum_over(group, (Hpp_o, Hpl, Hll, gp, gl))
        # node 0 is pinned: its landmark-term blocks are zero by definition
        Hpp_o, gp = Hpp_o * pin[:, :, None], gp * pin
        Hpl = Hpl.reshape(N, L, 6, 3) * pin[:, :, None, None]
        if graph is None:
            Hg = torch.zeros(N * 6, N * 6, dtype=torch.float32, device=dev)
            gg = torch.zeros(N * 6, dtype=torch.float32, device=dev)
        else:
            Hg, gg = _graph_normal_equations(graph, R_abs, t_abs, pin, rot_weight)
        Hpp = Hg.reshape(N, 6, N, 6).clone()
        Hpp[idx, :, idx, :] += Hpp_o
        Hpp = Hpp.reshape(N * 6, N * 6) + damp
        g_p = gg + gp.reshape(-1)
        Hll_inv = torch.linalg.inv_ex(Hll + damping * eye3)[0]
        W = torch.einsum("nlab,lbc->nlac", Hpl, Hll_inv)
        S = Hpp - torch.einsum("nlac,mlbc->namb", W, Hpl).reshape(N * 6, N * 6)
        g_corr = torch.einsum("nlac,lc->na", W, gl).reshape(-1)
        dxp = _solve(S, -(g_p - g_corr)).reshape(N, 6) * pin
        dxl = -torch.einsum("lab,lb->la", Hll_inv,
                            gl + torch.einsum("nlab,na->lb", Hpl, dxp))
        R_abs = R_abs @ exp_so3(dxp[:, :3])
        t_abs = t_abs + dxp[:, 3:]
        lms = lms + dxl
    return R_abs, t_abs, lms
