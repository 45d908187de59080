"""Kernels K4 and K5: row gather from per-keypoint tables, and its backward.

    K4  out[b, k, q, :]    = table[b, k, idx[b, k, q], :]
    K5  dtable[b, k, t, :] = sum over q with idx[b, k, q] == t of dout[b, k, q, :]

The last stage of the two-level candidate grouping (ops/two_level.py): each
candidate's neighbour rows come out of its keypoint's T-row table. On a CUDA
tensor `onehot_gather` launches the hand-written Hopper kernel in
`csrc/onehot_gather.cu` (replacing the TPU kernel
`deepvcp_tpu/ops/pallas/onehot_gather.py::onehot_gather`) and
`onehot_scatter_add` the one beside it (replacing `_scatter_add` of the same
file, the backward of `onehot_gather_vjp`); on a CPU tensor, or within
`ops.kernels.reference_path()`, each runs its plain PyTorch version
(`*_reference`). `onehot_gather_vjp` is the differentiable gather: K4
forward, K5 backward, no gradient for the indices.

Both kernels take the indices as int64, the dtype `torch.topk` returns, so
nothing is cast. K4 is a copy and bit-identical to `torch.gather`. K5 is
deterministic: it streams dout in ascending q and adds each query to its
row's sum in shared memory, so every table row sums its queries in
ascending q, starting from 0. The plain version adds in the same order (a
stable sort groups each row's queries; step j adds every row's j-th entry,
a loop as long as the fullest row), so the two agree bit for bit;
`index_add_` and `scatter_add_` use atomics on the card and are not
deterministic there. An index outside [0, T) gives a NaN row in K4 (the
plain `torch.gather` raises) and adds to no row in K5.
"""

from __future__ import annotations

import torch

from deepvcp_tpu_torch.ops.kernels import _build, _plain

# csrc/onehot_gather.cu: K4's grid has at most 65535 blocks of 256 queries
# per keypoint. K5 holds only a 512-query tile of a keypoint's queries on
# chip at a time (its shared memory holds the table rows' sums), so Q
# bounds nothing but its loop there; it takes K4's bound. Each row still
# sums in ascending q, a chain of adds as long as the row's list.
MAX_GATHER_QUERIES = 65535 * 256
MAX_SCATTER_QUERIES = MAX_GATHER_QUERIES


@torch.no_grad()
def onehot_gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K4: torch.gather along the table rows.
    table [B, K, T, D], idx [B, K, Q] int64 -> [B, K, Q, D]."""
    return torch.gather(table, 2, idx[..., None].expand(-1, -1, -1, table.shape[-1]))


@torch.no_grad()
def onehot_scatter_add_reference(dout: torch.Tensor, idx: torch.Tensor, T: int) -> torch.Tensor:
    """Plain PyTorch K5, deterministic: a stable sort of the indices groups
    each row's queries in ascending q; step j adds every row's j-th entry.
    dout [B, K, Q, D], idx [B, K, Q] int64 -> dtable [B, K, T, D]."""
    B, K, Q, D = dout.shape
    sidx, order = torch.sort(idx, dim=-1, stable=True)
    rows = torch.gather(dout, 2, order[..., None].expand(-1, -1, -1, D))
    t = torch.arange(T, device=idx.device).expand(B, K, T).contiguous()
    start = torch.searchsorted(sidx, t)
    count = torch.searchsorted(sidx, t, right=True) - start
    out = torch.zeros((B, K, T, D), dtype=dout.dtype, device=dout.device)
    for j in range(int(count.max())):
        add = torch.gather(rows, 2, (start + j).clamp_max(Q - 1)[..., None].expand(-1, -1, -1, D))
        out = torch.where((count > j)[..., None], out + add, out)
    return out


def _check(rows: torch.Tensor, idx: torch.Tensor, what: str) -> None:
    if rows.dim() != 4 or idx.dim() != 3 or min(rows.shape) < 1:
        raise ValueError(f"{what} must be [B, K, *, D] and idx [B, K, Q], non-empty, got "
                         f"{tuple(rows.shape)} and {tuple(idx.shape)}")
    if rows.shape[:2] != idx.shape[:2] or idx.shape[-1] < 1:
        raise ValueError(f"{what} {tuple(rows.shape)} and idx {tuple(idx.shape)} disagree on "
                         f"[B, K], or Q is 0")
    if rows.dtype != torch.float32:
        raise TypeError(f"float32 only, got {rows.dtype}")
    if idx.dtype != torch.int64:
        raise TypeError(f"int64 indices only, got {idx.dtype}")
    if rows.device != idx.device:
        raise ValueError(f"tensors on {rows.device} and {idx.device}")


def _kernel_args(*tensors: torch.Tensor) -> None:
    """Raise unless the CUDA kernels take these tensors as they are."""
    if not tensors[0].is_cuda:
        raise ValueError(f"no kernel for device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the one-hot gather kernels need contiguous inputs")


def onehot_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, k, q] = table[b, k, idx[b, k, q]]: table [B, K, T, D] float32,
    idx [B, K, Q] int64 -> [B, K, Q, D]. A CPU tensor runs the plain
    reference; a CUDA tensor launches the Hopper kernel (contiguous inputs)
    or raises. Records no autograd graph (onehot_gather_vjp does).
    `onehot_gather.launches` counts kernel launches."""
    _check(table, idx, "table")
    if table.device.type == "cpu" or _plain.active():
        return onehot_gather_reference(table, idx)
    _kernel_args(table, idx)
    B, K, T, D = table.shape
    Q = idx.shape[-1]
    if Q > MAX_GATHER_QUERIES:
        raise ValueError(f"Q={Q} exceeds the gather kernel's {MAX_GATHER_QUERIES}")
    out = table.new_empty((B, K, Q, D))
    _build.launch(_build.library().onehot_gather_f32, table, table.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), B * K, T, Q, D)
    onehot_gather.launches += 1
    return out


onehot_gather.launches = 0


def onehot_scatter_add(dout: torch.Tensor, idx: torch.Tensor, T: int) -> torch.Tensor:
    """dtable[b, k, t] = sum over q with idx[b, k, q] == t of dout[b, k, q]:
    dout [B, K, Q, D] float32, idx [B, K, Q] int64 -> [B, K, T, D], the
    gradient of onehot_gather with respect to the table. A CPU tensor runs
    the plain reference; a CUDA tensor launches the Hopper kernel
    (contiguous inputs, Q <= MAX_SCATTER_QUERIES) or raises.
    `onehot_scatter_add.launches` counts kernel launches."""
    _check(dout, idx, "dout")
    if dout.shape[2] != idx.shape[2]:
        raise ValueError(f"dout {tuple(dout.shape)} and idx {tuple(idx.shape)} disagree on Q")
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if dout.device.type == "cpu" or _plain.active():
        return onehot_scatter_add_reference(dout, idx, T)
    _kernel_args(dout, idx)
    B, K, Q, D = dout.shape
    if Q > MAX_SCATTER_QUERIES:
        raise ValueError(f"Q={Q} exceeds the scatter-add kernel's {MAX_SCATTER_QUERIES}")
    dtable = dout.new_empty((B, K, T, D))
    _build.launch(_build.library().onehot_scatter_add_f32, dout, dout.data_ptr(),
                  idx.data_ptr(), dtable.data_ptr(), B * K, T, Q, D)
    onehot_scatter_add.launches += 1
    return dtable


onehot_scatter_add.launches = 0


class _OnehotGather(torch.autograd.Function):
    """K4 forward, K5 backward; the indices take no gradient."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[2]
        return onehot_gather(table, idx)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        return onehot_scatter_add(dout.contiguous(), idx, ctx.num_rows), None


def onehot_gather_vjp(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """onehot_gather, differentiable with respect to the table: its gradient
    is onehot_scatter_add of the output's (as the JAX onehot_gather_vjp)."""
    return _OnehotGather.apply(table, idx)
