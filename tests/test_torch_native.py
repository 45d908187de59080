"""The port's host geometry oracles (deepvcp_tpu_torch/native.py: knn,
farthest_point_sample, query_ball_point, make_pair), counterparts of
tests/test_native.py's oracle tests. Each runs on seeded numpy inputs
through the port's native binding, the JAX package's binding, the port's
numpy route (its `_load` patched to None) and the port's device function
on the CPU.

Tolerances: indices are equal everywhere. Distances of the port's native
and numpy routes are equal bit for bit (both round ((dx*dx) + (dy*dy)) +
(dz*dz) step by step: the port builds with -ffp-contract=off). The JAX
binding is built with -march=native (native/build.sh), where GCC may
contract those products into FMAs: its distances are held within 2 ulp.
The device knn computes distances through the matmul expansion
|q|^2 + |r|^2 - 2 q.r: held at 1e-5 absolute on unit-scale clouds.
"""

import numpy as np
import pytest
import torch

from deepvcp_tpu import native as jnative
from deepvcp_tpu_torch import native
from deepvcp_tpu_torch.data import transforms
from deepvcp_tpu_torch.ops.grouping import query_ball_point
from deepvcp_tpu_torch.ops.knn import knn
from deepvcp_tpu_torch.ops.sampling import farthest_point_sample

JAX_ULP = 2          # JAX binding's FMA-contracted distances against the port's
DEVICE_ATOL = 1e-5   # the matmul expansion's distances, unit-scale clouds


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available(), "the port's native library failed to build"
    assert jnative.available(), "the JAX package's native library failed to build"


def numpy_route(monkeypatch, fn, *args, **kwargs):
    """fn through the port's numpy route: the library reported unavailable."""
    with monkeypatch.context() as m:
        m.setattr(native, "_load", lambda: None)
        assert not native.available()
        return fn(*args, **kwargs)


@pytest.mark.parametrize("n_ref,n_query,k,seed", [(100, 17, 5, 3), (2000, 300, 32, 13)])
def test_knn(monkeypatch, n_ref, n_query, k, seed):
    """300 queries span two of the numpy route's chunks."""
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((n_ref, 3)).astype(np.float32)
    query = rng.standard_normal((n_query, 3)).astype(np.float32)
    dist, idx = native.knn(ref, query, k)
    assert dist.dtype == np.float32 and idx.dtype == np.int32 and idx.shape == (n_query, k)
    # the exact oracle: ascending distances to the k nearest
    d = np.sqrt(np.sum((query[:, None] - ref[None]) ** 2, -1))
    np.testing.assert_array_equal(idx, np.argsort(d, -1, kind="stable")[:, :k])
    j_dist, j_idx = jnative.knn(ref, query, k)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_max_ulp(dist, j_dist, maxulp=JAX_ULP)
    n_dist, n_idx = numpy_route(monkeypatch, native.knn, ref, query, k)
    np.testing.assert_array_equal(idx, n_idx)
    np.testing.assert_array_equal(dist.view(np.uint32), n_dist.view(np.uint32))
    t_dist, t_idx = knn(torch.from_numpy(ref)[None], torch.from_numpy(query)[None], k)
    np.testing.assert_array_equal(idx, t_idx[0].numpy())
    np.testing.assert_allclose(t_dist[0].numpy(), dist, rtol=0, atol=DEVICE_ATOL)


def test_knn_tie_keeps_lower_index(monkeypatch):
    """A tie at the k-th distance keeps the lower index on both routes."""
    ref = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, 0, 2]], np.float32)
    query = np.zeros((1, 3), np.float32)
    for dist, idx in (native.knn(ref, query, 2), numpy_route(monkeypatch, native.knn, ref, query, 2)):
        np.testing.assert_array_equal(idx, [[0, 1]])
        np.testing.assert_array_equal(dist, [[1, 1]])


def _lattice(n_side: int) -> np.ndarray:
    """Integer lattice with every point twice: exact distance ties."""
    g = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([g, g]).astype(np.float32)


@pytest.mark.parametrize("case", ["normal", "large", "lattice"])
def test_farthest_point_sample(monkeypatch, case):
    """Identical indices: the port's binding, JAX's, the numpy route and
    K3's plain version (ops.sampling on the CPU), ties to the lowest index."""
    rng = np.random.default_rng(4)
    xyz, npoint, start = {
        "normal": (rng.standard_normal((60, 3)).astype(np.float32), 12, 0),
        "large": (rng.uniform(-25, 25, (3000, 3)).astype(np.float32), 256, 17),
        "lattice": (_lattice(5), 100, 3),
    }[case]
    got = native.farthest_point_sample(xyz, npoint, start)
    assert got.dtype == np.int32 and got.shape == (npoint,) and got[0] == start
    np.testing.assert_array_equal(got, jnative.farthest_point_sample(xyz, npoint, start))
    np.testing.assert_array_equal(
        got, numpy_route(monkeypatch, native.farthest_point_sample, xyz, npoint, start))
    want = farthest_point_sample(torch.from_numpy(xyz)[None], npoint, start)[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius,nsample,seed", [(0.9, 6, 5), (0.3, 16, 6), (0.05, 4, 7)])
def test_query_ball_point(monkeypatch, radius, nsample, seed):
    """Identical indices on all four routes; radius 0.05 leaves queries of
    other clouds without hits (padded with N - 1)."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((50, 3)).astype(np.float32)
    queries = np.concatenate([xyz[:13], rng.standard_normal((5, 3)).astype(np.float32)])
    got = native.query_ball_point(xyz, queries, radius, nsample)
    assert got.dtype == np.int32 and got.shape == (18, nsample)
    np.testing.assert_array_equal(got, jnative.query_ball_point(xyz, queries, radius, nsample))
    np.testing.assert_array_equal(
        got, numpy_route(monkeypatch, native.query_ball_point, xyz, queries, radius, nsample))
    want = query_ball_point(radius, nsample, torch.from_numpy(xyz)[None],
                            torch.from_numpy(queries)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    if radius == 0.05:
        assert (got[13:] == xyz.shape[0] - 1).all()


def test_make_pair(monkeypatch):
    """Rigid and deterministic on both routes. The native route equals the
    JAX binding's; the numpy route is data.transforms.make_pair on
    default_rng(seed), equal to the JAX package's numpy route."""
    rng = np.random.default_rng(6)
    src = rng.uniform(-2, 2, (80, 3)).astype(np.float32)
    tgt, R, t = native.make_pair(src, seed=7, max_translation=0.5)
    assert tgt.dtype == R.dtype == t.dtype == np.float32 and R.shape == (3, 3)
    np.testing.assert_allclose(tgt, src @ R.T + t, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    assert np.abs(t).max() <= 0.5
    for a, b in zip((tgt, R, t), native.make_pair(src, seed=7, max_translation=0.5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip((tgt, R, t), jnative.make_pair(src, seed=7, max_translation=0.5)):
        np.testing.assert_array_equal(a, b)

    n_tgt, n_R, n_t = numpy_route(monkeypatch, native.make_pair, src, 7, max_translation=0.5)
    np.testing.assert_allclose(n_tgt, src @ n_R.T + n_t, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(n_R), 1.0, atol=1e-5)
    _, w_tgt, w_R, w_t = transforms.make_pair(src, np.random.default_rng(7), max_translation=0.5)
    for a, b in zip((n_tgt, n_R, n_t), (w_tgt, w_R, w_t)):
        np.testing.assert_array_equal(a, b)
    with monkeypatch.context() as m:
        m.setattr(jnative, "_load", lambda: None)
        j = jnative.make_pair(src, 7, max_translation=0.5)
    for a, b in zip((n_tgt, n_R, n_t), j):
        np.testing.assert_array_equal(a, b)


def test_rejects_what_the_library_cannot_read():
    """Shapes and ranges the C loops would read past are refused on both
    routes, before the library is called."""
    xyz = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError):
        native.knn(xyz, xyz, 11)
    with pytest.raises(ValueError):
        native.knn(xyz[None], xyz, 2)
    with pytest.raises(ValueError):
        native.farthest_point_sample(xyz, 4, start_idx=10)
    with pytest.raises(ValueError):
        native.query_ball_point(xyz[:, :2], xyz, 0.5, 4)
    with pytest.raises(ValueError):
        native.make_pair(np.zeros((10, 6), np.float32), seed=0)
