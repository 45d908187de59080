"""Kernel K6, the k <= 32 nearest points with the tile kept on chip
(deepvcp_tpu_torch/ops/kernels/knn_select.py): the plain PyTorch versions
against square_distance and torch.topk and against approx_knn's bf16 tile
arm, the tie rule, the wrappers' checks, k6.applies against them, and the
routing of ops/knn.py::select and its faces knn and approx_knn; on a CUDA
card, the Hopper kernel's f32 and bf16 arms against their plain versions,
and on knn's and the ring's shapes.

No JAX here, so that the card-only tests run where jax is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_knn_select.py
"""

import importlib

import numpy as np
import pytest
import torch

from deepvcp_tpu_torch import ops
from deepvcp_tpu_torch.ops.distance import square_distance
from deepvcp_tpu_torch.ops.kernels import knn_select as k6
from deepvcp_tpu_torch.ops.kernels import reference_path

knn_mod = importlib.import_module("deepvcp_tpu_torch.ops.knn")

torch.set_num_threads(2)


def _clouds(seed, B, M, N, scale=5.0):
    rng = np.random.default_rng(seed)
    ref = (rng.uniform(-1, 1, (B, N, 3)) * scale).astype(np.float32)
    query = (rng.uniform(-1, 1, (B, M, 3)) * scale).astype(np.float32)
    return torch.from_numpy(ref), torch.from_numpy(query)


def _recorder(fn, seen):
    def recorded(r, q, k):
        seen.append(q.shape[1])
        return fn(r, q, k)
    return recorded


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


@pytest.mark.parametrize("fn", ["knn", "approx_knn"])
def test_approx_knn_routes(monkeypatch, fn):
    """knn and approx_knn in f32 are select's: on the CPU every case takes
    the plain tile (chunked square_distance + torch.topk) and never reaches
    knn_select; where the kernel runs, k <= 32 makes one knn_select call
    with every query, whatever the chunk, and returns its list with
    sqrt(d2); select returns the list itself."""
    ref, query = _clouds(2, 2, 90, 300)
    seen = []
    monkeypatch.setattr(k6, "knn_select", _recorder(k6.knn_select_reference, seen))
    want = torch.topk(square_distance(query, ref), 8, dim=-1, largest=False)
    face = getattr(ops, fn)
    d, idx = face(ref, query, 8, chunk=32)
    assert seen == [] and not k6.applies(ref, query, 8)
    assert torch.equal(idx, want.indices) and torch.equal(d, torch.sqrt(want.values))
    monkeypatch.setattr(k6, "uses_kernel", lambda t: True)
    assert k6.applies(ref, query, 8)
    d, idx = face(ref, query, 8, chunk=32)
    assert seen == [90]
    assert torch.equal(idx, want.indices) and torch.equal(d, torch.sqrt(want.values))
    d2, idx = knn_mod.select(ref, query, 8, chunk=32)
    assert seen == [90, 90]
    assert torch.equal(idx, want.indices) and torch.equal(d2, want.values)


def _fall_through_case(name):
    ref, query = _clouds(6, 2, 40, 300)
    kw = dict(k=8, chunk=16)
    if name.startswith("bfloat16"):
        kw["select_dtype"] = "bfloat16"
        name = name[len("bfloat16"):].lstrip(", ")
    if name == "k33":
        kw["k"] = 33
    elif name == "k40":
        kw["k"] = 40
    elif name == "float16":
        kw["select_dtype"] = name
    elif name == "float64":
        ref, query = ref.double(), query.double()
    elif name == "2-D clouds":
        ref, query = ref[0], query[0]
    elif name == "one ref, two query clouds":
        ref = ref[:1]
    elif name == "two ref clouds, one query":
        query = query[:1]
    elif name == "N = 65 537":
        ref = torch.cat([ref] * 219, 1)[:, :65537].contiguous()
    return ref, query, kw


FALL_THROUGH = ["k33", "k40", "float64", "2-D clouds", "one ref, two query clouds",
                "two ref clouds, one query"]
BF16_FALL_THROUGH = ["bfloat16", "float16", "bfloat16, k33", "bfloat16, float64",
                     "bfloat16, 2-D clouds", "bfloat16, one ref, two query clouds",
                     "bfloat16, two ref clouds, one query", "bfloat16, N = 65 537"]


@pytest.mark.parametrize("fn,name", [("approx_knn", n) for n in FALL_THROUGH + BF16_FALL_THROUGH]
                         + [("knn", n) for n in FALL_THROUGH])
def test_approx_knn_falls_through_where_the_kernel_does_not_apply(monkeypatch, fn, name):
    """k > 32, an f16 selection tile, f64, 2-D clouds, clouds broadcast over
    B and, on the bf16 tile, more than 65 536 points keep the plain tile
    even where the kernel runs: k6.applies is false, neither wrapper is
    called, nothing is launched, and the result is the CPU route's. The
    bf16 tile with k <= 32 on [B, N, 3] f32 clouds ("bfloat16") makes one
    knn_select_bf16 call with every query, and never calls the f32
    knn_select."""
    ref, query, kw = _fall_through_case(name)
    face = getattr(ops, fn)
    want = face(ref, query, **kw)
    counted = (k6.knn_select, k6.knn_select_bf16)
    launches = [fn.launches for fn in counted]

    def refuse(*args):
        raise AssertionError("knn_select called")

    seen = []
    routed = name == "bfloat16"
    monkeypatch.setattr(k6, "uses_kernel", lambda t: True)
    monkeypatch.setattr(k6, "knn_select", refuse)
    monkeypatch.setattr(k6, "knn_select_bf16", _recorder(k6.knn_select_bf16_reference, seen)
                        if routed else refuse)
    sel = getattr(torch, kw["select_dtype"]) if "select_dtype" in kw else None
    assert k6.applies(ref, query, kw["k"], sel) == routed
    got = face(ref, query, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert seen == ([query.shape[1]] if routed else [])
    assert [fn.launches for fn in counted] == launches


def _applies_case(name):
    ref, query = _clouds(13, 2, 10, 40)
    k = {"k0": 0, "k33": 33, "k above N": 41}.get(name, 8)
    if name == "float64":
        ref, query = ref.double(), query.double()
    elif name == "bfloat16 clouds":
        ref, query = ref.to(torch.bfloat16), query.to(torch.bfloat16)
    elif name == "2-D clouds":
        ref, query = ref[0], query[0]
    elif name == "4 channels":
        ref, query = torch.cat([ref, ref[..., :1]], -1), torch.cat([query, query[..., :1]], -1)
    elif name == "B disagrees":
        ref = ref[:1]
    elif name == "N = 0":
        ref = ref[:, :0]
    elif name == "two devices":
        ref = ref.to("meta")
    elif name == "B = 65 536":
        ref, query = torch.zeros(65536, 1, 3), torch.zeros(65536, 1, 3)
        k = 1
    elif name == "N = 65 537":
        ref = torch.zeros(2, 65537, 3)
    return ref, query, k


@pytest.mark.parametrize("sel", [None, torch.bfloat16])
@pytest.mark.parametrize("name", ["fits", "k0", "k33", "k above N", "float64", "bfloat16 clouds",
                                  "2-D clouds", "4 channels", "B disagrees", "N = 0",
                                  "two devices", "B = 65 536", "N = 65 537"])
def test_applies_is_what_the_wrappers_accept(monkeypatch, sel, name):
    """Where the kernel runs, k6.applies holds exactly where the arm's
    wrapper takes the (contiguous) clouds to its launch: here, on CPU
    tensors, that launch refuses the device, and every other case is
    refused earlier by the wrapper's checks."""
    ref, query, k = _applies_case(name)
    wrapper = k6.knn_select if sel is None else k6.knn_select_bf16
    monkeypatch.setattr(k6, "uses_kernel", lambda t: True)
    with pytest.raises((ValueError, TypeError)) as refused:
        wrapper(ref.contiguous(), query.contiguous(), k)
    accepted = str(refused.value).startswith("no kernel for device")
    assert k6.applies(ref, query, k, sel) == accepted
    assert accepted == (name == "fits" or (name == "N = 65 537" and sel is None))


def _bf16_case(name, B=2, M=70, N=400):
    """Clouds for the bf16 tile: uniform in a 1 m box, every point twice,
    or queries a hair from ref points (near points whose bf16 d2 is
    negative)."""
    ref, query = _clouds(11, B, M, N, scale=1.0)
    if name == "duplicated":
        ref = torch.cat([ref[:, : N // 2]] * 2, 1).contiguous()
    elif name == "negative d2":
        noise = torch.from_numpy(np.random.default_rng(12).normal(0, 1e-3, (B, M, 3)))
        query = (ref[:, :M] + noise.float()).contiguous()
    return ref, query


@pytest.mark.parametrize("chunk", [None, 32])
@pytest.mark.parametrize("name", ["uniform", "duplicated", "negative d2"])
def test_bf16_reference_is_the_tile_arm(name, chunk):
    """knn_select_bf16_reference, all queries at once, equals approx_knn's
    bf16 tile arm (chunked or not) bit for bit: the indices, and the
    distances after the arm's clamp and sqrt. Both run the one tile
    definition (centred, tile_terms, tile_topk), so this holds the chunking
    and the wrapper's CPU route to it."""
    ref, query = _bf16_case(name)
    for k in (1, 8, 32):
        dist, idx = ops.approx_knn(ref, query, k, chunk=chunk, select_dtype="bfloat16")
        d2, idx2 = k6.knn_select_bf16_reference(ref, query, k)
        assert d2.dtype == torch.bfloat16 and idx2.dtype == torch.int64
        assert d2.shape == idx2.shape == (2, 70, k)
        assert torch.equal(idx2, idx)
        assert torch.equal(torch.sqrt(torch.clamp_min(d2, 0.0).float()), dist)
        got = k6.knn_select_bf16(ref, query, k)
        assert torch.equal(got[0], d2) and torch.equal(got[1], idx2)
    if name == "negative d2":
        assert (d2 < 0).any(), "no negative bf16 d2"
    if name == "duplicated":
        assert (d2[..., 1:] == d2[..., :-1]).any(), "no ties in a list"


def test_approx_knn_routes_bf16(monkeypatch):
    """Where the kernel runs, the bf16 tile with k <= 32 makes one
    knn_select_bf16 call with every query, whatever the chunk, inside one
    deepvcp.select_tile range, never calls the f32 knn_select, and returns
    the tile arm's distances and indices."""
    import contextlib

    ref, query = _bf16_case("negative d2", M=90)
    want = ops.approx_knn(ref, query, 32, chunk=32, select_dtype="bfloat16")
    events = []

    @contextlib.contextmanager
    def annotate(name):
        events.append(("open", name))
        yield
        events.append(("close", name))

    def recorded(r, q, k):
        events.append(("bf16", q.shape[1]))
        return k6.knn_select_bf16_reference(r, q, k)

    def refuse(*args):
        raise AssertionError("knn_select called")

    monkeypatch.setattr(knn_mod, "annotate", annotate)
    monkeypatch.setattr(k6, "uses_kernel", lambda t: True)
    monkeypatch.setattr(k6, "knn_select", refuse)
    monkeypatch.setattr(k6, "knn_select_bf16", recorded)
    got = ops.approx_knn(ref, query, 32, chunk=32, select_dtype="bfloat16")
    assert events == [("open", "deepvcp.select_tile"), ("bf16", 90),
                      ("close", "deepvcp.select_tile")]
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_bf16_wrapper_checks_inputs():
    ref, query = _clouds(1, 2, 10, 40)
    with pytest.raises(ValueError, match=r"k must lie"):
        k6.knn_select_bf16(ref, query, 33)
    with pytest.raises(ValueError, match=r"k must lie"):
        k6.knn_select_bf16(ref, query, 0)
    with pytest.raises(TypeError, match="float32"):
        k6.knn_select_bf16(ref.double(), query.double(), 8)
    with pytest.raises(TypeError, match="float32"):
        k6.knn_select_bf16(ref.to(torch.bfloat16), query.to(torch.bfloat16), 8)
    with pytest.raises(ValueError, match="contiguous"):
        k6.knn_select_bf16(ref, torch.cat([query, query], 1)[:, ::2], 8)
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        k6.knn_select_bf16(ref[0], query, 8)
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        k6.knn_select_bf16(ref[..., :2].contiguous(), query[..., :2].contiguous(), 8)
    with pytest.raises(ValueError, match="disagree on B"):
        k6.knn_select_bf16(ref[:1], query, 8)
    with pytest.raises(ValueError, match="exceeds the bf16 arm's 65536"):
        k6.knn_select_bf16(torch.zeros(1, 65537, 3), query[:1], 8)
    with pytest.raises(ValueError, match="no kernel"):
        k6.knn_select_bf16(ref.to("meta"), query.to("meta"), 8)


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
    before = k6.knn_select_bf16.launches
    k6.knn_select_bf16(ref, query, 4)
    with reference_path():
        k6.knn_select_bf16(ref, query, 4)
    assert k6.knn_select_bf16.launches == before


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
def test_knn_and_ring_blocks_take_the_kernel_on_card(cuda):
    """knn (the dense engine's selections) and select (ring_knn's block
    step) on the card take K6's f32 arm, one launch a call whatever the
    chunk, and return the plain tile's lists (select under reference_path,
    chunked alike) bit for bit: at the dense engine's shapes (N = 2 048:
    64 keypoints, 13 824 candidates, B = 1 and 2) and at a ring block's
    (13 824 / P candidates x 10 000 / P points, P = 1, 2, 4)."""
    cases = [(1, 64, 2048), (1, 13824, 2048), (2, 13824, 2048), (1, 13824, 10000),
             (1, 6912, 5000), (1, 3456, 2500)]
    k = 32
    for i, (B, M, N) in enumerate(cases):
        ref, query = (t.to(cuda) for t in _clouds(200 + i, B, M, N, scale=25.0))
        for chunk in (None, 2048):
            before = k6.knn_select.launches
            d2, idx = knn_mod.select(ref, query, k, chunk=chunk)
            dist, idx_knn = ops.knn(ref, query, k, chunk=chunk)
            torch.cuda.synchronize()
            assert k6.knn_select.launches == before + 2
            with reference_path():
                want = knn_mod.select(ref, query, k, chunk=chunk)
            assert torch.equal(idx, want[1]) and torch.equal(d2, want[0]), (B, M, N, chunk)
            assert torch.equal(idx_knn, want[1]), (B, M, N, chunk)
            assert torch.equal(dist, torch.sqrt(want[0])), (B, M, N, chunk)


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
    ref, query = (t.to(cuda) for t in _clouds(7, 1, 10, 100))
    with pytest.raises(ValueError, match="contiguous"):
        k6.knn_select(ref, torch.cat([query, query], 1)[:, ::2], 4)
    with pytest.raises(ValueError, match="k must lie"):
        k6.knn_select(ref, query, 33)


def _bf16_topk_order(d2, idx, ref, query, k):
    """The set of each row: the k smallest (torch.topk's radix key of the
    bf16 d2, index), checked against a numpy lexsort of the whole tile."""
    tile = k6.knn_select_bf16_reference(ref, query, ref.shape[1])[0]
    bits = tile.view(torch.int16).cpu().numpy().astype(np.int32) & 0xFFFF
    key = np.where(bits & 0x8000, bits ^ 0xFFFF, bits | 0x8000)
    order = k6.knn_select_bf16_reference(ref, query, ref.shape[1])[1].cpu().numpy()
    keys = np.take_along_axis(key, np.argsort(order, -1), -1)  # key by point index
    lex = _lexsorted(keys, k)
    np.testing.assert_array_equal(np.sort(idx.cpu().numpy(), -1), np.sort(lex, -1))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8])
def test_bf16_kernel_matches_topk_of_the_bf16_tile_on_card(cuda, B):
    """The bf16 arm against torch.topk of the bf16 tile on the card
    (knn_select_bf16_reference): identical bf16 d2 bits and indices, in the
    same order, at M = 64 / 3 520 / 4 608 queries x N = 10 000 points of a
    1 m cloud and k = 1, 8, 32; also with queries a hair from ref points
    (negative d2) and on a lattice (ties everywhere), where the set is the
    k smallest (key, index). One launch a call, none under reference_path."""
    for i, M in enumerate((64, 3520, 4608)):
        ref, query = (t.to(cuda) for t in _clouds(100 + i, B, M, 10000, scale=1.0))
        near = (ref[:, :M] + 1e-3 * torch.randn(B, M, 3, device=cuda,
                                                generator=torch.Generator(cuda).manual_seed(i)))
        lattice = torch.round(ref * 20) / 20
        for what, r, q in (("uniform", ref, query), ("near", ref, near.contiguous()),
                           ("lattice", lattice, torch.round(query * 20) / 20)):
            for k in (1, 8, 32):
                before = k6.knn_select_bf16.launches
                d2, idx = k6.knn_select_bf16(r, q, k)
                torch.cuda.synchronize()
                assert k6.knn_select_bf16.launches == before + 1
                want = k6.knn_select_bf16_reference(r, q, k)
                assert torch.equal(d2.view(torch.int16), want[0].view(torch.int16)), (B, M, what, k)
                assert torch.equal(idx, want[1]), (B, M, what, k)
                with reference_path():
                    got = k6.knn_select_bf16(r, q, k)
                assert torch.equal(got[1], want[1])
                assert k6.knn_select_bf16.launches == before + 1
            if what == "lattice" and M == 64:
                _bf16_topk_order(d2, idx, r, q, 32)


@pytest.mark.gpu
def test_bf16_kernel_refuses_what_it_cannot_take(cuda):
    ref, query = (t.to(cuda) for t in _clouds(7, 1, 10, 100))
    with pytest.raises(ValueError, match="contiguous"):
        k6.knn_select_bf16(ref, torch.cat([query, query], 1)[:, ::2], 4)
    with pytest.raises(ValueError, match="k must lie"):
        k6.knn_select_bf16(ref, query, 33)
    with pytest.raises(ValueError, match="exceeds the bf16 arm's"):
        k6.knn_select_bf16(torch.zeros(1, 65537, 3, device=cuda), query, 4)
