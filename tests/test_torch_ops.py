"""Geometry ops of the PyTorch port against the JAX package, on the same
numpy inputs (deepvcp_tpu_torch/ops vs deepvcp_tpu/ops)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu import ops as jops
from deepvcp_tpu_torch import ops

# the package re-exports functions under these modules' names
jknn = importlib.import_module("deepvcp_tpu.ops.knn")
jneighbors = importlib.import_module("deepvcp_tpu.ops.neighbors")

torch.set_num_threads(2)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rotation(rng, deg):
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    a = np.radians(deg)
    return (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K).astype(np.float32)


def test_square_distance():
    rng = np.random.default_rng(0)
    a = rng.uniform(-3, 3, (2, 50, 3)).astype(np.float32)
    b = rng.uniform(-3, 3, (2, 70, 3)).astype(np.float32)
    want = np.asarray(jops.square_distance(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(ops.square_distance(_t(a), _t(b)).numpy(), want, atol=ATOL)


def test_map_query_chunks_matches_unchunked():
    rng = np.random.default_rng(1)
    ref = _t(rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32))
    q = _t(rng.uniform(-1, 1, (2, 53, 3)).astype(np.float32))
    fn = lambda x: (ops.square_distance(x, ref), x.sum(-1, keepdim=True))  # noqa: E731
    whole = fn(q)
    for got, want in zip(ops.map_query_chunks(fn, q, 16), whole):
        assert torch.equal(got, want)


def test_index_points():
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((2, 30, 5)).astype(np.float32)
    idx = rng.integers(0, 30, (2, 4, 7))
    want = np.asarray(jops.index_points(jnp.asarray(pts), jnp.asarray(idx, jnp.int32)))
    np.testing.assert_array_equal(ops.index_points(_t(pts), _t(idx)).numpy(), want)


def test_sort_cloud_is_stable_like_jax():
    """Coordinates on a coarse grid give many equal keys: the stable torch
    argsort must give jnp.argsort's permutation exactly."""
    rng = np.random.default_rng(3)
    xyz = np.round(rng.uniform(-2, 2, (2, 200, 3)), 1).astype(np.float32)
    want = jneighbors.sort_cloud(jnp.asarray(xyz))
    got = ops.sort_cloud(_t(xyz))
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    np.testing.assert_array_equal(got.key.numpy(), np.asarray(want.key))


@pytest.mark.parametrize("n,r,extent", [(128, 0.4, 4.0), (10000, 0.1, 55.0), (10000, 0.4, 55.0),
                                        (500, 1.2, 4.0)])
def test_window_for(n, r, extent):
    assert ops.window_for(n, r, extent, 4.0) == jneighbors.window_for(n, r, extent, 4.0)


@pytest.mark.parametrize("centered", [True, False])
@pytest.mark.parametrize("radius,voxel", [(1.0, 0.4), (0.6, 0.2)])
def test_voxelize(centered, radius, voxel):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 5, (2, 6, 3)).astype(np.float32)
    want = np.asarray(jops.voxelize(jnp.asarray(pts), radius, voxel, centered=centered))
    got = ops.voxelize(_t(pts), radius, voxel, centered=centered)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch_and_apply_rigid(weighted):
    rng = np.random.default_rng(5)
    x = rng.uniform(-2, 2, (3, 40, 3)).astype(np.float32)
    R = np.stack([_rotation(rng, d) for d in (5, 60, 170)])
    t = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    y = (x @ R.transpose(0, 2, 1) + t[:, None] + rng.normal(0, 0.05, x.shape)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (3, 40)).astype(np.float32) if weighted else None
    Rj, tj = jops.kabsch(jnp.asarray(x), jnp.asarray(y), None if w is None else jnp.asarray(w))
    Rt, tt = ops.kabsch(_t(x), _t(y), None if w is None else _t(w))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=ATOL)
    assert np.allclose(np.linalg.det(Rt.numpy()), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        ops.apply_rigid(_t(x), _t(R), _t(t)).numpy(),
        np.asarray(jops.apply_rigid(jnp.asarray(x), jnp.asarray(R), jnp.asarray(t))), atol=ATOL)


def test_kabsch_reflection_fix():
    """A mirrored target must still give a proper rotation (det +1)."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (1, 30, 3)).astype(np.float32)
    y = x * np.array([1, 1, -1], np.float32)
    Rt, _ = ops.kabsch(_t(x), _t(y))
    Rj, _ = jops.kabsch(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=ATOL)
    assert np.allclose(np.linalg.det(Rt.numpy()), 1.0, atol=1e-5)


def _knn_inputs(seed, scale):
    rng = np.random.default_rng(seed)
    ref = (rng.uniform(-1, 1, (2, 300, 3)) * scale).astype(np.float32)
    query = (rng.uniform(-1, 1, (2, 90, 3)) * scale).astype(np.float32)
    return ref, query


@pytest.mark.parametrize("chunk", [None, 32])
@pytest.mark.parametrize("fn", ["knn", "approx_knn"])
def test_knn_f32(fn, chunk):
    """Same neighbour sets and sorted distances as the JAX op; index order
    within equal distances may differ (lax.top_k and torch.topk break ties
    differently)."""
    ref, query = _knn_inputs(7, 4.0)
    dj, ij = getattr(jknn, fn)(jnp.asarray(ref), jnp.asarray(query), 8, chunk=chunk)
    dt, it = getattr(ops, fn)(_t(ref), _t(query), 8, chunk=chunk)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4)
    np.testing.assert_array_equal(np.sort(it.numpy(), -1), np.sort(np.asarray(ij), -1))


@pytest.mark.parametrize("chunk", [None, 32])
def test_approx_knn_bf16_selection(chunk):
    """bf16 selection semantics. The f32 values before the cast to bf16
    differ in the last bit between the two frameworks (summation order), so
    a few land on the other side of a bf16 rounding boundary: distances
    agree within one bf16 step (up to 2^-7 relative on d^2, 2^-8 on d), and
    each side's neighbours that lie clear of its k-th distance by more than
    that step are among the other side's k."""
    ref, query = _knn_inputs(8, 20.0)
    ref += 100.0  # far from the origin: the centring must matter
    query += 100.0
    k = 8
    dj, ij = jknn.approx_knn(jnp.asarray(ref), jnp.asarray(query), k, chunk=chunk,
                             select_dtype="bfloat16")
    dt, it = ops.approx_knn(_t(ref), _t(query), k, chunk=chunk, select_dtype="bfloat16")
    dj, ij, dt, it = np.asarray(dj), np.asarray(ij), dt.numpy(), it.numpy()
    step = 2.0 ** -8
    np.testing.assert_allclose(dt, dj, rtol=step)
    for b in range(2):
        for m in range(query.shape[1]):
            for (d1, i1), i2 in (((dj[b, m], ij[b, m]), it[b, m]),
                                 ((dt[b, m], it[b, m]), ij[b, m])):
                clear = i1[d1 < d1[-1] * (1 - 2 * step)]
                assert set(clear) <= set(i2), (b, m)
