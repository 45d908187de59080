"""The port's pose solve and Registrar (deepvcp_tpu_torch/loss,
registration.py) against the JAX package on the same inputs and weights:
at DeepVCPConfig.tiny(), and with the kitti25-rot checkpoint on a 128-point
cloud, where the JAX CPU path's static band covers every point."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu import DeepVCPConfig
from deepvcp_tpu import pretrained as jpretrained
from deepvcp_tpu.loss.registration import svd_refine as jsvd_refine
from deepvcp_tpu.models import DeepVCP as JDeepVCP
from deepvcp_tpu.registration import Registrar as JRegistrar
from deepvcp_tpu_torch.data.synthetic import LidarLikeDataset, batch_iterator
from deepvcp_tpu_torch.loss import svd_refine
from deepvcp_tpu_torch.registration import Registrar

torch.set_num_threads(2)

POSE_ATOL = 1e-4   # R and t after two Kabsch solves per refinement
SCORE_ATOL = 1e-5  # trimmed mean 1-NN distances


@pytest.mark.parametrize("weighted", [False, True])
def test_svd_refine(weighted):
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (2, 20, 3)).astype(np.float32)
    a = np.radians(7.0)
    R = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]], np.float32)
    y = x @ R.T + np.float32(0.3) + rng.normal(0, 0.01, x.shape).astype(np.float32)
    y[:, :3] += rng.uniform(-1, 1, (2, 3, 3)).astype(np.float32)   # outliers
    w = rng.uniform(0.2, 1.0, (2, 20)).astype(np.float32) if weighted else None
    want = jsvd_refine(jnp.asarray(x), jnp.asarray(y), 0.8, None if w is None else jnp.asarray(w))
    got = svd_refine(torch.from_numpy(x), torch.from_numpy(y), 0.8,
                     None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=POSE_ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=POSE_ATOL)
    for b in range(2):
        assert set(got.inlier_idx[b].tolist()) == set(np.asarray(want.inlier_idx[b]).tolist())
        assert not set(got.inlier_idx[b].tolist()) & {0, 1, 2}


def _compare(out_t, out_j):
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.scores.numpy(), np.asarray(out_j.scores), atol=SCORE_ATOL)
    np.testing.assert_array_equal(out_t.keypoints.numpy(), np.asarray(out_j.keypoints))
    np.testing.assert_allclose(out_t.vcps.numpy(), np.asarray(out_j.vcps), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.saliency.numpy(), np.asarray(out_j.saliency), atol=1e-4)
    for b in range(out_t.R.shape[0]):
        assert set(out_t.inlier_idx[b].tolist()) == set(np.asarray(out_j.inlier_idx[b]).tolist())


@pytest.fixture(scope="module")
def tiny():
    """Tiny config (f32 selection), flax-initialised variables and a pair."""
    cfg = dataclasses.replace(DeepVCPConfig.tiny(use_normal=False), knn_select_dtype=None)
    ds = LidarLikeDataset(num_clouds=2, num_points=cfg.num_points, max_range=1.5, seed=3,
                          max_rotation_deg=4.0, max_translation=0.1)
    src, tgt, _, _ = next(batch_iterator(ds, 2, shuffle=False))
    variables = jax.device_get(jax.jit(JDeepVCP(cfg=cfg).init)(
        jax.random.key(0), src, tgt, np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
        np.zeros((2, 3), np.float32)))
    return cfg, variables, src, tgt


@pytest.mark.parametrize("guard,saliency", [(True, True), (False, False)])
def test_registrar_tiny(tiny, guard, saliency):
    cfg, variables, src, tgt = tiny
    kw = dict(refine_iters=2, guard=guard, use_saliency_weights=saliency)
    out_j = JRegistrar(cfg, variables, **kw)(jnp.asarray(src), jnp.asarray(tgt))
    out_t = Registrar(cfg, variables, "cpu", **kw)(torch.from_numpy(src), torch.from_numpy(tgt))
    assert out_t.scores.shape == (2, 3)
    _compare(out_t, out_j)


def test_registrar_kitti25_rot_small_cloud():
    """The committed checkpoint through the whole slice: both packages'
    registry registrar (refine_iters 3, saliency weights, guard) on a
    128-point lidar-like pair, with a non-identity init. The cloud has a
    1 m range so that SA neighbourhoods hold more than the point itself: at
    25 m a 128-point cloud leaves most points alone in their 0.1 m ball,
    their features and saliencies then tie exactly, and the two top-K
    break those ties differently."""
    N = 128
    cfg_j, variables = jpretrained.load("kitti25-rot", num_points=N)
    ds = LidarLikeDataset(num_clouds=1, num_points=N, max_range=1.0, seed=110,
                          max_rotation_deg=5.0, max_translation=0.5)
    src, tgt, R_gt, t_gt = next(batch_iterator(ds, 1, shuffle=False))
    R0, t0 = R_gt.copy(), (t_gt + 0.05).astype(np.float32)
    kw = dict(refine_iters=3, use_saliency_weights=True)
    out_j = JRegistrar(cfg_j, variables, **kw)(*map(jnp.asarray, (src, tgt, R0, t0)))
    from deepvcp_tpu_torch import pretrained

    reg = pretrained.registrar("kitti25-rot", device="cpu", num_points=N)
    assert (reg.refine_iters, reg.use_saliency_weights, reg.guard) == (3, True, True)
    out_t = reg(*map(torch.from_numpy, (src, tgt, R0, t0)))
    _compare(out_t, out_j)


def test_registrar_checks_device_and_warns_once_on_extent(tiny):
    cfg, variables, src, _ = tiny
    reg = Registrar(cfg, variables, "cpu")
    with pytest.raises(ValueError, match="registrar on cpu"):
        reg(torch.zeros(1, cfg.num_points, 3, device="meta"), torch.from_numpy(src))
    big = torch.from_numpy(src[:1] * 10.0)   # extent ~30 > 1.5 x spatial_extent 4
    with pytest.warns(UserWarning, match="spatial_extent"):
        reg(big, big)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        reg(big, big)


def test_extent_warnings_match_jax(tiny):
    """The extent monitor against JAX's on one sequence of clouds: in
    scale, 10x, 10x again (within 1.5x of the extent warned about: no new
    warning), 100x. Both registrars give the same number of warnings naming
    spatial_extent. On the CPU the port judges each call at once; on a card
    it judges a call's extent at a later call (no host sync), so its warning
    may come at most one call later: the count is taken after the whole
    sequence."""
    cfg, variables, src, tgt = tiny
    scales = (1.0, 10.0, 10.0, 100.0)
    j_reg = JRegistrar(cfg, variables)
    t_reg = Registrar(cfg, variables, "cpu")
    counts = []
    for call in (lambda s: jax.block_until_ready(j_reg(jnp.asarray(src * s), jnp.asarray(tgt))),
                 lambda s: t_reg(torch.from_numpy(src * s), torch.from_numpy(tgt))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for scale in scales:
                call(np.float32(scale))
            jax.effects_barrier()
        counts.append(sum("spatial_extent" in str(w.message) for w in caught
                          if issubclass(w.category, UserWarning)))
    assert counts == [2, 2], counts


CASCADE_N = 128   # where the JAX CPU static band covers the slab at SA radii 0.1-0.4


@pytest.fixture(scope="module")
def cascade_pair():
    """A 128-point lidar-like pair in a 1 m range (ModelNet scale), rotated
    up to 10 deg: inside the cascade's basin from the identity."""
    ds = LidarLikeDataset(num_clouds=2, num_points=CASCADE_N, max_range=1.0, seed=103,
                          noise_std=0.01, max_rotation_deg=10.0, max_translation=0.1)
    return next(batch_iterator(ds, 2, epoch=0, seed=777, shuffle=False))


def _cascades(select_dtype="bfloat16"):
    """modelnet-cascade in both packages, built stage by stage as both
    pretrained.cascade build it, with the given candidate-selection dtype."""
    from deepvcp_tpu.registration import CascadeRegistrar as JCascadeRegistrar
    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.registration import CascadeRegistrar

    jstages, tstages = [], []
    for name, iters in jpretrained.CASCADES["modelnet-cascade"]["stages"]:
        cfg_j, variables = jpretrained.load(name, num_points=CASCADE_N)
        cfg_t = pretrained.config(name, num_points=CASCADE_N)
        kw = dict(refine_iters=iters, use_saliency_weights=True)
        jstages.append(JRegistrar(dataclasses.replace(cfg_j, knn_select_dtype=select_dtype),
                                  variables, **kw))
        tstages.append(Registrar(dataclasses.replace(cfg_t, knn_select_dtype=select_dtype),
                                 variables, "cpu", **kw))
    return JCascadeRegistrar(jstages), CascadeRegistrar(tstages)


def test_cascade_f32_selection_matches_jax(cascade_pair):
    """modelnet-cascade (coarse @2, fine @1) with f32 candidate selection:
    every stage's pose, scores and inliers as in JAX. Keypoints are held as
    sets: equal saliencies of the fine stage may come out of the two top-K
    in another order, which changes neither the solve nor the score."""
    src, tgt, _, _ = cascade_pair
    jc, tc = _cascades(select_dtype=None)
    out_j = jc(jnp.asarray(src), jnp.asarray(tgt))
    out_t = tc(torch.from_numpy(src), torch.from_numpy(tgt))
    assert out_t.scores.shape == (2, 3 + 2)
    assert tc.cfg.search_radius == 0.6 and tc.cfg.voxel_len == 0.2   # the last stage's
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.scores.numpy(), np.asarray(out_j.scores), atol=SCORE_ATOL)
    for b in range(2):
        assert sorted(map(tuple, out_t.keypoints[b].tolist())) == \
            sorted(map(tuple, np.asarray(out_j.keypoints[b]).tolist()))


def test_cascade_bf16_selection_near_jax(cascade_pair):
    """The registered modelnet-cascade, which selects candidates on the bf16
    tile (spatial_extent 2.5), against JAX. The two frameworks' f32 tiles
    differ in the last bit before the cast to bf16 (summation order) and
    their top-k break ties differently, so neighbour sets differ, but only
    at the k-th distance: measured on this pair, 17% of the 27 648 candidate
    queries of the first refinement swap about one neighbour each (at most
    4 of 32), and no neighbour clear of the k-th distance by two bf16 steps
    differs (checked below). A swapped neighbour moves a VCP a little; the
    pose is held to 1 deg and 0.01 (measured 0.3 deg and 0.004), and the
    identity init's score (column 0, before any selection) to SCORE_ATOL."""
    from deepvcp_tpu.ops.knn import approx_knn as japprox_knn
    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.data import rotation_geodesic_deg
    from deepvcp_tpu_torch.ops import approx_knn

    src, tgt, _, _ = cascade_pair
    jc, _ = _cascades()
    tc = pretrained.cascade("modelnet-cascade", device="cpu", num_points=CASCADE_N)
    assert tc.stages[0].cfg.knn_select_dtype_effective == "bfloat16"
    out_j = jc(jnp.asarray(src), jnp.asarray(tgt))
    out_t = tc(torch.from_numpy(src), torch.from_numpy(tgt))
    drot = rotation_geodesic_deg(out_t.R, torch.from_numpy(np.array(out_j.R)))
    assert (drot < 1.0).all(), drot
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=0.01)
    np.testing.assert_allclose(out_t.scores[:, 0].numpy(), np.asarray(out_j.scores[:, 0]),
                               atol=SCORE_ATOL)
    # the first refinement's candidate queries, through both selections
    model = tc.stages[0].model
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(src), torch.from_numpy(tgt))
        eye = torch.eye(3).expand(2, 3, 3)
        q = model.candidates(enc, eye, torch.zeros(2, 3))[1].reshape(2, -1, 3)
    k = model.cfg.num_neighbors
    dt, it = (a.numpy() for a in approx_knn(enc.tgt_xyz, q, k, select_dtype="bfloat16"))
    dj, ij = (np.asarray(a) for a in japprox_knn(jnp.asarray(enc.tgt_xyz.numpy()),
                                                 jnp.asarray(q.numpy()), k,
                                                 select_dtype="bfloat16"))
    step = 2.0 ** -8
    differ = 0
    for b in range(2):
        for m in range(q.shape[1]):
            if set(it[b, m]) == set(ij[b, m]):
                continue
            differ += 1
            for (d1, i1), i2 in (((dj[b, m], ij[b, m]), it[b, m]),
                                 ((dt[b, m], it[b, m]), ij[b, m])):
                assert set(i1[d1 < d1[-1] * (1 - 2 * step)]) <= set(i2), (b, m)
    assert differ < 0.3 * q.shape[0] * q.shape[1]


def test_cascade_checks_its_stages(tiny):
    from deepvcp_tpu_torch.registration import CascadeRegistrar

    cfg, variables, _, _ = tiny
    with pytest.raises(ValueError, match="at least one"):
        CascadeRegistrar([])
    a = Registrar(cfg, variables, "cpu")
    b = Registrar(dataclasses.replace(cfg, num_points=2 * cfg.num_points), variables, "cpu")
    with pytest.raises(ValueError, match="input contract"):
        CascadeRegistrar([a, b])


def test_pretrained_cascade_defaults():
    from deepvcp_tpu_torch import pretrained

    casc = pretrained.cascade("modelnet-cascade", device="cpu", num_points=256)
    assert [r.refine_iters for r in casc.stages] == [2, 1]
    assert all(r.use_saliency_weights and r.guard for r in casc.stages)
    assert casc.cfg == casc.stages[-1].cfg
    assert set(pretrained.available_cascades()) == {"kitti-cascade", "modelnet-cascade"}
    with pytest.raises(KeyError):
        pretrained.cascade("no-such-cascade", device="cpu")


def _pairs(src, tgt, n):
    """n (src, tgt) tensor pairs: the batch rolled by one point a pair."""
    return [(torch.from_numpy(np.roll(src, i, axis=1)), torch.from_numpy(tgt)) for i in range(n)]


@pytest.mark.parametrize("kind", ["registrar", "cascade"])
@pytest.mark.parametrize("depth", [1, 3])
def test_stream_order_and_depth(tiny, kind, depth):
    """stream yields each pair's output in input order, equal to the call's
    own, and has at most `depth` calls issued but not yet yielded."""
    from deepvcp_tpu_torch.registration import CascadeRegistrar

    cfg, variables, src, tgt = tiny
    reg = Registrar(cfg, variables, "cpu", refine_iters=2)
    if kind == "cascade":
        reg = CascadeRegistrar([reg, Registrar(cfg, variables, "cpu", refine_iters=1)])
    pairs = _pairs(src, tgt, 5)
    issued = []

    def feed():
        for i, pair in enumerate(pairs):
            issued.append(i)
            yield pair

    for k, out in enumerate(reg.stream(feed(), depth=depth)):
        assert len(issued) <= k + depth, (k, len(issued))
        want = reg(*pairs[k])
        for field in ("R", "t", "keypoints", "vcps", "scores"):
            assert torch.equal(getattr(out, field), getattr(want, field)), (k, field)
    assert k == len(pairs) - 1
    with pytest.raises(ValueError, match="depth"):
        next(reg.stream(iter(pairs), depth=0))


ROUTE_N = 128   # where the JAX CPU static band covers the slab


def _route_batch(kind, n):
    """A batch of 2 of campaign_r5d G3's held sets (extent 1): uniform
    (seed 100) or lidar-like (seed 101)."""
    from deepvcp_tpu_torch.data import SyntheticDataset

    kw = dict(num_clouds=2, num_points=n, max_rotation_deg=10.0, max_translation=0.5)
    ds = (SyntheticDataset(extent=1.0, seed=100, **kw) if kind == "uniform"
          else LidarLikeDataset(max_range=1.0, seed=101, **kw))
    return next(batch_iterator(ds, 2, epoch=0, seed=777, shuffle=False))


@pytest.mark.parametrize("n", [ROUTE_N, 1024])
def test_route_statistic_matches_jax(n):
    """The router statistic against JAX's evaluated op by op, within 1e-6
    relative. Under jax.jit, XLA rounds the self-distances |a|^2 + |a|^2 -
    2 a.a of some points to exactly 0 and others not, so which self-matches
    the <= 1e-12 test drops (and the statistic: 0.38 jitted against 0.58
    op by op on one uniform cloud) depends on its fusion; the port's eager
    ops give JAX's op-by-op values."""
    from deepvcp_tpu.registration import RoutedRegistrar as JRoutedRegistrar
    from deepvcp_tpu_torch import pretrained

    routed = pretrained.routed_registrar(device="cpu", num_points=n)
    cfg, low = jpretrained.load("modelnet-fine", num_points=n)
    _, high = jpretrained.load("lidar-fine", num_points=n)
    jrouted = JRoutedRegistrar(cfg, {"low": low, "high": high})
    for kind in ("uniform", "lidar"):
        src = _route_batch(kind, n)[0]
        got = routed.route_statistic(torch.from_numpy(src)).numpy()
        with jax.disable_jit():
            want = np.asarray(jrouted.route_statistic(jnp.asarray(src)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert bool(routed.route(torch.from_numpy(src))) == (kind == "lidar")


def test_routed_pose_matches_jax():
    """pretrained.routed_registrar's experts (modelnet-fine low, lidar-fine
    high, refine_iters 3) with f32 candidate selection, on one uniform and
    one lidar-like batch: each votes as JAX's routed registrar does, and the
    pose equals JAX's within POSE_ATOL and the chosen expert's own
    Registrar's exactly."""
    from deepvcp_tpu.registration import RoutedRegistrar as JRoutedRegistrar
    from deepvcp_tpu_torch.registration import RoutedRegistrar

    cfg_j, low = jpretrained.load("modelnet-fine", num_points=ROUTE_N)
    _, high = jpretrained.load("lidar-fine", num_points=ROUTE_N)
    cfg_j = dataclasses.replace(cfg_j, knn_select_dtype=None)
    from deepvcp_tpu_torch import pretrained

    cfg_t = dataclasses.replace(pretrained.config("modelnet-fine", ROUTE_N), knn_select_dtype=None)
    kw = dict(refine_iters=3, use_saliency_weights=True)
    jrouted = JRoutedRegistrar(cfg_j, {"low": low, "high": high}, **kw)
    routed = RoutedRegistrar(cfg_t, {"low": low, "high": high}, "cpu", **kw)
    for kind, expert in (("uniform", low), ("lidar", high)):
        src, tgt, _, _ = _route_batch(kind, ROUTE_N)
        assert (float(jnp.mean(jrouted.route_statistic(jnp.asarray(src)))) > 0.75) == \
            (kind == "lidar")
        out_j = jrouted(jnp.asarray(src), jnp.asarray(tgt))
        out_t = routed(torch.from_numpy(src), torch.from_numpy(tgt))
        np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=POSE_ATOL)
        np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=POSE_ATOL)
        np.testing.assert_allclose(out_t.scores.numpy(), np.asarray(out_j.scores),
                                   atol=SCORE_ATOL)
        alone = Registrar(cfg_t, expert, "cpu", **kw)(torch.from_numpy(src), torch.from_numpy(tgt))
        assert torch.equal(out_t.R, alone.R) and torch.equal(out_t.t, alone.t)
    with pytest.raises(ValueError, match="low"):
        RoutedRegistrar(cfg_t, {"low": low}, "cpu")


def test_kitti_cascade_matches_jax():
    """kitti-cascade (kitti25 @2, kitti25-fine @1, kitti25-ultra @2; f32
    selection at spatial_extent 55) on a 128-point 1 m lidar-like pair,
    where the static band covers the slab: the pose, every stage's scores
    and the last stage's keypoints as in JAX."""
    from deepvcp_tpu_torch import pretrained

    ds = LidarLikeDataset(num_clouds=1, num_points=CASCADE_N, max_range=1.0, seed=110,
                          max_rotation_deg=5.0, max_translation=0.2)
    src, tgt, _, _ = next(batch_iterator(ds, 1, shuffle=False))
    out_j = jpretrained.cascade("kitti-cascade", num_points=CASCADE_N)(
        jnp.asarray(src), jnp.asarray(tgt))
    casc = pretrained.cascade("kitti-cascade", device="cpu", num_points=CASCADE_N)
    out_t = casc(torch.from_numpy(src), torch.from_numpy(tgt))
    assert out_t.scores.shape == (1, 3 + 2 + 3)
    assert casc.cfg.search_radius == 0.3 and casc.cfg.voxel_len == 0.1
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.scores.numpy(), np.asarray(out_j.scores), atol=SCORE_ATOL)
    assert sorted(map(tuple, out_t.keypoints[0].tolist())) == \
        sorted(map(tuple, np.asarray(out_j.keypoints[0]).tolist()))
