"""Kernel K6, the k <= 32 nearest points with the tile kept on chip
(deepvcp_tpu_torch/ops/kernels/knn_select.py): the plain PyTorch version
against square_distance and torch.topk, its tie rule, the wrapper's checks,
and approx_knn's routing; on a CUDA card, the Hopper kernel
against the plain version.

No JAX here, so that the card-only tests run where jax is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_knn_select.py
"""

import numpy as np
import pytest
import torch

from deepvcp_tpu_torch import ops
from deepvcp_tpu_torch.ops.distance import square_distance
from deepvcp_tpu_torch.ops.kernels import knn_select as k6
from deepvcp_tpu_torch.ops.kernels import reference_path

torch.set_num_threads(2)


def _clouds(seed, B, M, N, scale=5.0):
    rng = np.random.default_rng(seed)
    ref = (rng.uniform(-1, 1, (B, N, 3)) * scale).astype(np.float32)
    query = (rng.uniform(-1, 1, (B, M, 3)) * scale).astype(np.float32)
    return torch.from_numpy(ref), torch.from_numpy(query)


def _lexsorted(d2, k):
    """Numpy oracle of the tie rule: per row the k smallest (d2, index)."""
    n = np.arange(d2.shape[-1])
    order = np.stack([np.lexsort((n, row)) for row in d2.reshape(-1, d2.shape[-1])])
    return order.reshape(d2.shape[:-1] + (-1,))[..., :k]


@pytest.mark.parametrize("M", [1, 37, 90])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_reference_is_square_distance_and_topk(k, M):
    """On a tie-free cloud: d2 bit for bit square_distance's at the chosen
    indices, and the same points in the same (ascending) order as
    torch.topk."""
    ref, query = _clouds(k * 100 + M, 2, M, 300)
    tile = square_distance(query, ref)
    top = torch.topk(tile, k + 1, dim=-1, largest=False)
    assert not (top.values[..., 1:] == top.values[..., :-1]).any(), "the cloud has ties"
    d2, idx = k6.knn_select_reference(ref, query, k)
    assert d2.dtype == torch.float32 and idx.dtype == torch.int64
    assert d2.shape == idx.shape == (2, M, k)
    assert torch.equal(torch.gather(tile, -1, idx), d2)
    assert torch.equal(idx, top.indices[..., :k])
    assert torch.equal(d2, top.values[..., :k])
    got = k6.knn_select(ref, query, k)
    assert torch.equal(got[0], d2) and torch.equal(got[1], idx)


def _duplicated_lattice(seed, B, M, n_base, scale=2.0):
    """Every point twice (indices i and i + n_base) on a half-unit lattice,
    queries on the lattice too: d2 ties everywhere, also at the k-th."""
    rng = np.random.default_rng(seed)
    base = np.round(rng.uniform(-scale, scale, (B, n_base, 3)) * 2) / 2
    ref = torch.from_numpy(np.concatenate([base, base], 1).astype(np.float32))
    query = np.round(rng.uniform(-scale, scale, (B, M, 3)) * 2) / 2
    return ref, torch.from_numpy(query.astype(np.float32))


@pytest.mark.parametrize("k", [1, 5, 32])
def test_duplicated_points_give_the_tiles_topk(k):
    """With d2 ties everywhere the plain version is torch.topk of
    square_distance's tile, values and indices in its order: k smallest
    values, ascending, each at its index."""
    ref, query = _duplicated_lattice(4, 2, 25, 60)
    tile = square_distance(query, ref)
    assert (torch.sort(tile, -1).values[..., k - 1:k + 1].diff(dim=-1) == 0).any(), "no k-th tie"
    d2, idx = k6.knn_select(ref, query, k)
    top = torch.topk(tile, k, dim=-1, largest=False)
    assert torch.equal(d2, top.values) and torch.equal(idx, top.indices)
    assert torch.equal(d2, torch.sort(tile, -1).values[..., :k])
    assert torch.equal(torch.gather(tile, -1, idx), d2)


def test_wrapper_checks_inputs():
    ref, query = _clouds(1, 2, 10, 40)
    with pytest.raises(ValueError, match=r"k must lie"):
        k6.knn_select(ref, query, 33)
    with pytest.raises(ValueError, match=r"k must lie"):
        k6.knn_select(ref[:, :20].contiguous(), query, 21)
    with pytest.raises(ValueError, match=r"k must lie"):
        k6.knn_select(ref, query, 0)
    with pytest.raises(TypeError, match="float32"):
        k6.knn_select(ref.double(), query.double(), 8)
    with pytest.raises(TypeError, match="float32"):
        k6.knn_select(ref, query.to(torch.bfloat16), 8)
    with pytest.raises(ValueError, match="contiguous"):
        k6.knn_select(ref.transpose(1, 2).contiguous().transpose(1, 2), query, 8)
    with pytest.raises(ValueError, match="contiguous"):
        k6.knn_select(ref, torch.cat([query, query], 1)[:, ::2], 8)
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        k6.knn_select(ref[0], query, 8)
    with pytest.raises(ValueError, match="disagree on B"):
        k6.knn_select(ref[:1], query, 8)
    with pytest.raises(ValueError, match="no kernel"):
        k6.knn_select(ref.to("meta"), query.to("meta"), 8)


def test_approx_knn_routes(monkeypatch):
    """On the CPU every case keeps the unchanged code (chunked
    square_distance + torch.topk) and never reaches knn_select; where the
    kernel runs, f32 with k <= 32 makes one knn_select call with every
    query, whatever the chunk, and returns its list with sqrt(d2)."""
    ref, query = _clouds(2, 2, 90, 300)
    seen = []
    plain = k6.knn_select_reference

    def recorded(r, q, k):
        seen.append(q.shape[1])
        return plain(r, q, k)

    monkeypatch.setattr(k6, "knn_select", recorded)
    want = torch.topk(square_distance(query, ref), 8, dim=-1, largest=False)
    d, idx = ops.approx_knn(ref, query, 8, chunk=32)
    assert seen == []
    assert torch.equal(idx, want.indices) and torch.equal(d, torch.sqrt(want.values))
    monkeypatch.setattr(k6, "uses_kernel", lambda t: True)
    d, idx = ops.approx_knn(ref, query, 8, chunk=32)
    assert seen == [90]
    assert torch.equal(idx, want.indices) and torch.equal(d, torch.sqrt(want.values))


def _fall_through_case(name):
    ref, query = _clouds(6, 2, 40, 300)
    kw = dict(k=8, chunk=16)
    if name == "k33":
        kw["k"] = 33
    elif name == "k40":
        kw["k"] = 40
    elif name in ("bfloat16", "float16"):
        kw["select_dtype"] = name
    elif name == "float64":
        ref, query = ref.double(), query.double()
    elif name == "2-D clouds":
        ref, query = ref[0], query[0]
    elif name == "one ref, two query clouds":
        ref = ref[:1]
    elif name == "two ref clouds, one query":
        query = query[:1]
    return ref, query, kw


@pytest.mark.parametrize("name", ["k33", "k40", "bfloat16", "float16", "float64", "2-D clouds",
                                  "one ref, two query clouds", "two ref clouds, one query"])
def test_approx_knn_falls_through_where_the_kernel_does_not_apply(monkeypatch, name):
    """k > 32, a reduced-precision selection tile, f64, 2-D clouds and
    clouds broadcast over B keep the unchanged code even where the kernel
    runs: knn_select is never called, nothing is launched, and the result
    is the CPU route's."""
    ref, query, kw = _fall_through_case(name)
    want = ops.approx_knn(ref, query, **kw)
    counted = k6.knn_select
    launches = counted.launches

    def refuse(*args):
        raise AssertionError("knn_select called")

    monkeypatch.setattr(k6, "uses_kernel", lambda t: True)
    monkeypatch.setattr(k6, "knn_select", refuse)
    got = ops.approx_knn(ref, query, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert counted.launches == launches


def test_approx_knn_k_above_32_unchanged():
    """k > 32 selects on the f32 tile with torch.topk, as before K6."""
    ref, query = _clouds(3, 2, 40, 300)
    d, idx = ops.approx_knn(ref, query, 40, chunk=16)
    want = torch.topk(square_distance(query, ref), 40, dim=-1, largest=False)
    assert torch.equal(idx, want.indices)
    assert torch.equal(d, torch.sqrt(torch.clamp_min(want.values, 0.0)))


def test_cpu_tensors_never_count_launches():
    ref, query = _clouds(5, 1, 20, 100)
    before = k6.knn_select.launches
    k6.knn_select(ref, query, 4)
    with reference_path():
        k6.knn_select(ref, query, 4)
    assert k6.knn_select.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_reference_on_card(cuda):
    """Identical d2 and indices, in the same order, to the plain version
    (torch.topk of square_distance's tile) at the benchmark's batch and
    on few queries, past a chunk of points, at k = 1..32 and N = k, and
    on a lattice cloud with every point twice (ties everywhere: a tie at the
    k-th distance to the lower index); one launch a call, none under
    reference_path. At a B = 1 call of few queries cuBLAS sums the tile's
    product without FMAs (PERF.md, K6), so the cases run at B >= 2 there."""
    cases = [(8, 13824 // 8, 10000, 32), (1, 64, 10000, 32), (2, 700, 2500, 17),
             (3, 50, 1000, 1), (2, 7, 33, 32), (2, 40, 31, 31), (1, 1, 1, 1)]
    for i, (B, M, N, k) in enumerate(cases):
        ref, query = (t.to(cuda) for t in _clouds(i, B, M, N, scale=25.0))
        for tie in (False, True):
            r = ref
            if tie:
                half = torch.round(ref[:, : max(1, N // 2)] * 2) / 2
                r = torch.cat([half, half], 1)[:, :N].contiguous()
                if r.shape[1] < k:
                    continue
            before = k6.knn_select.launches
            d2, idx = k6.knn_select(r, query, k)
            torch.cuda.synchronize()
            assert k6.knn_select.launches == before + 1
            want = k6.knn_select_reference(r, query, k)
            assert torch.equal(idx, want[1]), (B, M, N, k, tie)
            assert torch.equal(d2, want[0]), (B, M, N, k, tie)
            if tie:  # the set: the k smallest (d2, index)
                lex = _lexsorted(square_distance(query, r).cpu().numpy(), k)
                np.testing.assert_array_equal(np.sort(idx.cpu().numpy(), -1), np.sort(lex, -1))
            with reference_path():
                got = k6.knn_select(r, query, k)
            assert torch.equal(got[1], want[1])
            assert k6.knn_select.launches == before + 1


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
    ref, query = (t.to(cuda) for t in _clouds(7, 1, 10, 100))
    with pytest.raises(ValueError, match="contiguous"):
        k6.knn_select(ref, torch.cat([query, query], 1)[:, ::2], 4)
    with pytest.raises(ValueError, match="k must lie"):
        k6.knn_select(ref, query, 33)
