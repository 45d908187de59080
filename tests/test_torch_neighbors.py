"""The port's sorted-cloud neighbour search (deepvcp_tpu_torch/ops/neighbors.py)
against deepvcp_tpu/ops/neighbors.py on the same numpy inputs. Indices and
counts must be identical (tolerance 0): both compute each squared distance
as ((dx*dx) + (dy*dy)) + (dz*dz) in f32, so every in-radius mask agrees bit
for bit. Window distances to 1e-6 (a sqrt of identical squares).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu.ops import neighbors as jnb
from deepvcp_tpu_torch.ops import neighbors as tnb

torch.set_num_threads(2)


def _uniform(seed, B=2, N=300, scale=1.0):
    return np.random.default_rng(seed).uniform(-scale, scale, (B, N, 3)).astype(np.float32)


def _density_gradient(seed, B=2, N=400):
    """A cloud whose density along x grows ~20x from one end to the other:
    the window sized for uniform density under-covers its dense end."""
    rng = np.random.default_rng(seed)
    x = rng.power(4.0, (B, N)) * 2.0 - 1.0
    yz = rng.uniform(-1.0, 1.0, (B, N, 2))
    return np.concatenate([x[..., None], yz], axis=-1).astype(np.float32)


def _clouds(xyz):
    """(JAX SortedCloud, port SortedCloud) of the same points."""
    return jnb.sort_cloud(jnp.asarray(xyz)), tnb.sort_cloud(torch.from_numpy(xyz))


def test_sort_cloud_matches_jax():
    xyz = _uniform(0)
    jc, tc = _clouds(xyz)
    np.testing.assert_array_equal(tc.perm.numpy(), np.asarray(jc.perm))
    np.testing.assert_array_equal(tc.xyz.numpy(), np.asarray(jc.xyz))


@pytest.mark.parametrize("dup", [False, True])
def test_searchsorted_batched(dup):
    """The lower bound of every query, including queries equal to a value,
    below the first and above the last, and rows with repeated values."""
    rng = np.random.default_rng(1)
    vals = np.sort(rng.uniform(-1, 1, (3, 50)).astype(np.float32), axis=-1)
    if dup:
        vals = np.sort(np.round(vals * 4) / 4, axis=-1).astype(np.float32)
    queries = np.concatenate([vals[:, ::7], rng.uniform(-1.5, 1.5, (3, 20))],
                             axis=-1).astype(np.float32)
    want = np.asarray(jnb.searchsorted_batched(jnp.asarray(vals), jnp.asarray(queries)))
    got = tnb.searchsorted_batched(torch.from_numpy(vals), torch.from_numpy(queries))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 5, 40])
def test_select_first_k(k):
    """Rows with many, few and no hits: positions and counts identical. An
    empty row gives W - 1 (the clamped lower bound) in both packages; the
    JAX docstring's "returns 0" is not what its code does."""
    rng = np.random.default_rng(k)
    mask = rng.uniform(size=(4, 6, 32)) < np.array([0.9, 0.3, 0.05, 0.0])[:, None, None]
    pos_j, cnt_j = jnb.select_first_k(jnp.asarray(mask), k)
    pos_t, cnt_t = tnb.select_first_k(torch.from_numpy(mask), k)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert (cnt_t[3] == 0).all() and (pos_t[3] == 31).all()


@pytest.mark.parametrize("cloud,radius,nsample,window", [
    ("uniform", 0.2, 16, 128),
    ("uniform", 0.5, 64, 256),
    ("gradient", 0.15, 32, 64),   # the window under-covers the dense end
])
def test_windowed_ball_query(cloud, radius, nsample, window):
    xyz = _uniform(2) if cloud == "uniform" else _density_gradient(3)
    jc, tc = _clouds(xyz)
    rng = np.random.default_rng(4)
    # the cloud's own points (in sorted order) and foreign queries, some of
    # them far from every point (zero hits)
    foreign = rng.uniform(-1.6, 1.6, (2, 40, 3)).astype(np.float32)
    queries = np.concatenate([np.asarray(jc.xyz), foreign], axis=1)
    idx_j, cnt_j = jnb.windowed_ball_query(jc, jnp.asarray(queries), radius, nsample, window,
                                           return_count=True)
    idx_t, cnt_t = tnb.windowed_ball_query(tc, torch.from_numpy(queries), radius, nsample,
                                           window, return_count=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert (cnt_t == 0).any(), "no zero-hit query exercised"
    if cloud == "gradient":
        occ = tnb.slab_occupancy_stats(xyz, radius)
        assert occ["max"] > window, occ


@pytest.mark.parametrize("k,window", [(8, 64), (16, 300)])
def test_windowed_knn(k, window):
    xyz = _uniform(5)
    jc, tc = _clouds(xyz)
    q = np.random.default_rng(6).uniform(-1, 1, (2, 30, 3)).astype(np.float32)
    d_j, i_j = jnb.windowed_knn(jc, jnp.asarray(q), k, window)
    d_t, i_t = tnb.windowed_knn(tc, torch.from_numpy(q), k, window)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)


@pytest.mark.parametrize("cloud", ["uniform", "gradient"])
@pytest.mark.parametrize("radius", [0.1, 0.4])
def test_slab_occupancy_stats(cloud, radius):
    """Host numpy on both sides: the same dict, from numpy and from a tensor."""
    xyz = _uniform(7) if cloud == "uniform" else _density_gradient(8)
    want = jnb.slab_occupancy_stats(xyz, radius)
    assert tnb.slab_occupancy_stats(xyz, radius) == want
    assert tnb.slab_occupancy_stats(torch.from_numpy(xyz), radius) == want
    assert tnb.slab_occupancy_stats(xyz[0], radius) == jnb.slab_occupancy_stats(xyz[0], radius)


@pytest.mark.parametrize("n,r,extent,safety", [
    (10000, 0.1, 55.0, 4.0), (2048, 0.1, 2.5, 6.0), (2048, 0.4, 2.5, 6.0), (128, 0.4, 4.0, 4.0)])
def test_window_for_matches_jax(n, r, extent, safety):
    assert tnb.window_for(n, r, extent, safety) == jnb.window_for(n, r, extent, safety)


def test_window_d2_sums_in_order():
    """The window distances equal ((dx*dx)+(dy*dy))+(dz*dz) in f32 exactly."""
    xyz = _uniform(9)
    _, tc = _clouds(xyz)
    q = torch.from_numpy(np.random.default_rng(10).uniform(-1, 1, (2, 7, 3)).astype(np.float32))
    idx = torch.arange(20).expand(2, 7, 20)
    got = tnb._window_d2(tc, q, idx)
    pts = tc.xyz.numpy()[:, :20]
    d = pts[:, None] - q.numpy()[:, :, None]
    want = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    np.testing.assert_array_equal(got.numpy(), want)
    jc = jnb.sort_cloud(jnp.asarray(xyz))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jnb._window_d2(jc, jnp.asarray(q.numpy()), jnp.asarray(idx.numpy(), jnp.int32))))
