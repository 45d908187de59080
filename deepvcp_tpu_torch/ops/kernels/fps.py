"""Kernel K3: farthest-point sampling.

    out[:, 0] = start_idx; dist = +inf
    out[:, i] = argmax (first maximum) of dist after
                dist = min(dist, |x - x[out[:, i-1]]|^2)

On a CUDA tensor `farthest_point_sample` launches the hand-written Hopper
kernel in `csrc/fps.cu` (replacing the TPU kernel
`deepvcp_tpu/ops/pallas/fps_kernel.py::farthest_point_sample_pallas`); on a
CPU tensor, or within `ops.kernels.reference_path()`, it runs the plain
PyTorch version `farthest_point_sample_reference`. The two are
bit-identical: the same f32
expression ((dx*dx) + (dy*dy)) + (dz*dz), without FMA contraction, and the
same first-maximum rule (torch.argmax's, jnp.argmax's), so duplicate points
and lattice clouds give the lowest index. A point already taken has
distance 0 and is taken again only once every distance is 0; index 0 then
wins, as in JAX.
"""

from __future__ import annotations

import torch

from deepvcp_tpu_torch.ops.kernels import _build, _plain

THREADS = 256          # csrc/fps.cu: threads of a block; a cluster of blocks per cloud
MAX_CLUSTER = 16       # blocks per cluster, at most (16 is non-portable)
SHARE_PER_THREAD = 5   # the cluster grows until a block holds at most this many points a thread
REG_POINTS = 16 * THREADS   # a block's share held in registers; a larger one streams


def cluster_size(N: int) -> int:
    """Blocks of the cluster that samples one N-point cloud: the smallest
    power of two (up to MAX_CLUSTER) whose blocks hold at most
    SHARE_PER_THREAD points a thread, so a small cloud (salient_fps's 256
    points) runs on one block and the path's 10 000 points on 8, the
    fastest at that size (PERF.md §6)."""
    cs = 1
    while cs < MAX_CLUSTER and -(-N // cs) > SHARE_PER_THREAD * THREADS:
        cs *= 2
    return cs


def streams(N: int, cluster: int) -> bool:
    """Whether a block's share of the cloud exceeds its registers, so that
    the kernel streams points and distances through global scratch."""
    return -(-N // cluster) > REG_POINTS


@torch.no_grad()
def farthest_point_sample_reference(
    xyz: torch.Tensor, npoint: int, start_idx: int = 0
) -> torch.Tensor:
    """Plain PyTorch FPS: a loop over the npoint picks, vectorised over the
    batch and the cloud. xyz [B, N, 3] -> [B, npoint] int64."""
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    dist = torch.full((B, N), float("inf"), dtype=xyz.dtype, device=xyz.device)
    far = torch.full((B,), start_idx, dtype=torch.int64, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        d = xyz - xyz[rows, far][:, None, :]
        # ((dx*dx) + (dy*dy)) + (dz*dz): the kernel's exact f32 expression
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        dist = torch.minimum(dist, d2)
        far = torch.argmax(dist, dim=-1)   # the first maximum
    return out


def _check(xyz: torch.Tensor, npoint: int, start_idx: int) -> None:
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.shape[1] < 1:
        raise ValueError(f"xyz must be [B, N, 3] with N >= 1, got {tuple(xyz.shape)}")
    if xyz.dtype != torch.float32:
        raise TypeError(f"float32 only, got {xyz.dtype}")
    if npoint < 1:
        raise ValueError(f"npoint must be >= 1, got {npoint}")
    if not 0 <= start_idx < xyz.shape[1]:
        raise ValueError(f"start_idx {start_idx} outside [0, {xyz.shape[1]})")


def farthest_point_sample(
    xyz: torch.Tensor, npoint: int, start_idx: int = 0
) -> torch.Tensor:
    """[B, N, 3] float32 -> [B, npoint] int64 indices of the FPS picks.

    A CPU tensor runs the plain reference; a CUDA tensor launches the Hopper
    kernel (contiguous input, any N) or raises.
    `farthest_point_sample.launches` counts kernel launches."""
    _check(xyz, npoint, start_idx)
    if xyz.device.type == "cpu" or _plain.active():
        return farthest_point_sample_reference(xyz, npoint, start_idx)
    if not xyz.is_cuda:
        raise ValueError(f"no kernel for device {xyz.device}")
    if not xyz.is_contiguous():
        raise ValueError("the FPS kernel needs a contiguous input")
    B, N, _ = xyz.shape
    cluster = cluster_size(N)
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    scratch = torch.empty((B, N), dtype=torch.float32, device=xyz.device) \
        if streams(N, cluster) else None
    _build.launch(_build.library().fps_f32, xyz, xyz.data_ptr(), out.data_ptr(),
                  0 if scratch is None else scratch.data_ptr(), B, N, npoint, start_idx, cluster)
    farthest_point_sample.launches += 1
    return out


def pick_probe(smid: torch.Tensor, B: int, cluster: int, iters: int,
               barrier: bool = False) -> None:
    """The kernel's pick protocol alone (no distances), `iters` picks on B
    clusters of `cluster` blocks: its time per pick is the floor of a pick
    at that cluster size. `barrier`: the same records exchanged through one
    cluster barrier a pick instead. smid (int32, B * cluster, on the card)
    receives each block's SM."""
    _build.launch(_build.library().fps_pick_probe, smid, B, cluster, iters, int(barrier),
                  smid.data_ptr())


farthest_point_sample.launches = 0
