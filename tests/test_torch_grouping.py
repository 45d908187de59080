"""The port's ball-query grouping and helpers (deepvcp_tpu_torch/ops/grouping.py,
ops/knn.py::nearest_neighbor_dist) against deepvcp_tpu/ops on the same numpy
inputs.

Indices and counts: identical (tolerance 0). Both packages take squared
distances from the matmul expansion |a|^2 + |b|^2 - 2 a.b, whose f32
rounding may differ between XLA and torch, so a pair whose float64 squared
distance lies within NEAR_TIE of r^2 may fall on either side: a query with
such a pair is exempt from the index comparison, and the tests assert that
such queries are rare. Coordinates and features: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu import ops as jops
from deepvcp_tpu_torch import ops as tops

torch.set_num_threads(2)

NEAR_TIE = 1e-5    # |d^2 - r^2| under which the in-radius test is f32 rounding
ATOL = 1e-6


def _cloud(seed, B=2, N=256, scale=1.0):
    return np.random.default_rng(seed).uniform(-scale, scale, (B, N, 3)).astype(np.float32)


def _near_tie_queries(xyz, q, radius):
    """[B, S] bool: queries with a point whose float64 squared distance is
    within NEAR_TIE of r^2."""
    d2 = np.sum((q[:, :, None, :].astype(np.float64) - xyz[:, None].astype(np.float64)) ** 2, -1)
    return np.any(np.abs(d2 - radius * radius) < NEAR_TIE, axis=-1)


def _assert_rows_equal(got, want, exempt):
    keep = ~exempt
    np.testing.assert_array_equal(np.asarray(got)[keep], np.asarray(want)[keep])
    assert exempt.mean() < 0.05, f"{exempt.sum()} near-tie queries"


@pytest.mark.parametrize("radius,nsample,chunk", [(0.2, 16, None), (0.4, 32, 100), (0.05, 8, 64)])
def test_query_ball_point(radius, nsample, chunk):
    """The nsample lowest in-radius indices, padded with the first; foreign
    queries far from the cloud have zero hits, a count of 0 and index N-1."""
    xyz = _cloud(0)
    rng = np.random.default_rng(1)
    q = np.concatenate([xyz[:, :150], rng.uniform(2.5, 3.0, (2, 10, 3))], axis=1).astype(np.float32)
    idx_j, cnt_j = jops.query_ball_point(radius, nsample, jnp.asarray(xyz), jnp.asarray(q),
                                         chunk=chunk, return_count=True)
    idx_t, cnt_t = tops.query_ball_point(radius, nsample, torch.from_numpy(xyz),
                                         torch.from_numpy(q), chunk=chunk, return_count=True)
    exempt = _near_tie_queries(xyz, q, radius)
    _assert_rows_equal(idx_t.numpy(), idx_j, exempt)
    _assert_rows_equal(cnt_t.numpy(), cnt_j, exempt)
    far = cnt_t.numpy()[:, 150:]
    assert (far == 0).all() and (idx_t.numpy()[:, 150:] == xyz.shape[1] - 1).all()
    np.testing.assert_array_equal(idx_t.numpy(), tops.query_ball_point(
        radius, nsample, torch.from_numpy(xyz), torch.from_numpy(q)).numpy())


@pytest.mark.parametrize("with_features", [False, True])
def test_group_neighbors(with_features):
    """Grouped local xyz and features, zero rows for zero-hit queries."""
    xyz = _cloud(2)
    feats = np.random.default_rng(3).standard_normal((2, 256, 5)).astype(np.float32)
    q = np.concatenate([xyz[:, ::4], np.full((2, 4, 3), 5.0, np.float32)], axis=1)
    f = feats if with_features else None
    gj, lj, ij, cj = jops.group_neighbors(0.3, 12, jnp.asarray(xyz), jnp.asarray(q),
                                          None if f is None else jnp.asarray(f), chunk=32,
                                          return_count=True)
    gt, lt, it, ct = tops.group_neighbors(0.3, 12, torch.from_numpy(xyz), torch.from_numpy(q),
                                          None if f is None else torch.from_numpy(f), chunk=32,
                                          return_count=True)
    exempt = _near_tie_queries(xyz, q, 0.3)
    _assert_rows_equal(it.numpy(), ij, exempt)
    _assert_rows_equal(ct.numpy(), cj, exempt)
    keep = ~exempt
    np.testing.assert_allclose(gt.numpy()[keep], np.asarray(gj)[keep], atol=ATOL)
    np.testing.assert_allclose(lt.numpy()[keep], np.asarray(lj)[keep], atol=ATOL)
    assert gt.shape[-1] == (8 if with_features else 3)
    assert (gt.numpy()[:, -4:] == 0).all()


def test_sample_and_group():
    """FPS of 64 centroids (the port's plain FPS loop on the CPU, the JAX jnp
    loop), then grouping; npoint == N skips FPS."""
    xyz = _cloud(4, N=200)
    feats = np.random.default_rng(5).standard_normal((2, 200, 4)).astype(np.float32)
    for npoint in (64, 200):
        nj, gj, ij = jops.sample_and_group(npoint, 0.35, 16, jnp.asarray(xyz), jnp.asarray(feats))
        nt, gt, it = tops.sample_and_group(npoint, 0.35, 16, torch.from_numpy(xyz),
                                           torch.from_numpy(feats))
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        exempt = _near_tie_queries(xyz, nt.numpy(), 0.35)
        _assert_rows_equal(it.numpy(), ij, exempt)
        np.testing.assert_allclose(gt.numpy()[~exempt], np.asarray(gj)[~exempt], atol=ATOL)


@pytest.mark.parametrize("with_features", [False, True])
def test_group_all(with_features):
    xyz = _cloud(6, N=50)
    f = np.random.default_rng(7).standard_normal((2, 50, 6)).astype(np.float32) \
        if with_features else None
    nj, gj = jops.group_all(jnp.asarray(xyz), None if f is None else jnp.asarray(f))
    nt, gt = tops.group_all(torch.from_numpy(xyz), None if f is None else torch.from_numpy(f))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


@pytest.mark.parametrize("shape", [(100, 3), (2, 100, 3)])
def test_pc_normalize(shape):
    pc = (np.random.default_rng(8).standard_normal(shape) * 3 + 1).astype(np.float32)
    got = tops.pc_normalize(torch.from_numpy(pc)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.pc_normalize(jnp.asarray(pc))), atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1).max(axis=-1), 1.0, atol=ATOL)


@pytest.mark.parametrize("chunk", [None, 30])
def test_nearest_neighbor_dist(chunk):
    ref, q = _cloud(9, N=120), _cloud(10, N=70)
    want = np.asarray(jops.nearest_neighbor_dist(jnp.asarray(ref), jnp.asarray(q), chunk=chunk))
    got = tops.nearest_neighbor_dist(torch.from_numpy(ref), torch.from_numpy(q), chunk=chunk)
    assert got.shape == (2, 70)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_ops_exports_match_jax():
    """Every name the JAX package's ops exports, the port's exports too."""
    missing = [n for n in jops.__all__ if not hasattr(tops, n)]
    assert not missing, missing
