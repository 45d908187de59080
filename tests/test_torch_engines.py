"""The port's non-default engines against the JAX package on the CPU, on the
same numpy inputs and the same weights (flax init, perturbed, converted by
convert.flax_to_torch, or a campaign checkpoint):

- the gather-path SetAbstraction, windowed and dense, eval and training-mode
  BatchNorm, forward and gradients;
- the static band (use_pallas_band_max=False), forward and backward against
  xla_banded_max and its custom VJP, including N <= band_tile, where the band
  holds its one tile three times and the JAX formula triples the gradient:
  the port reproduces that as the reference's own behaviour;
- DeepVCP in training mode under each non-default branch, loss gradients;
- campaign_r4b's windowed checkpoint at N = 2048 under the windowed and the
  dense engine;
- the Registrar's slab-occupancy warning.

Tolerances: indices exact; f32 features, descriptors and VCPs 1e-5 of their
max magnitude (FEAT_RTOL); gradients 1e-4 of each tensor's max (GRAD_RTOL)
with BatchNorm on its running statistics. With training-mode BatchNorm,
TRAIN_GRAD_RTOL = 5e-3: on the windowed SA stage below, a float64 run of
the port puts its f32 gradients within 2.1e-6 of each tensor's max and
JAX's within 3.1e-3 (XLA's CPU sums the batch statistics over ~10^4
elements in f32 in order; test_train_mode_gradients_against_float64). A gradient tensor whose max is below CANCEL_FRAC of the largest
(a bias ahead of a training-mode BatchNorm: 0 but for rounding) is held to
the tolerance times the largest tensor's max. BatchNorm running statistics
after a training-mode forward: STAT_RTOL = 1e-4 of their max (the same
sums). Candidate weights (a softmax over 216): WEIGHT_ATOL = 1e-6.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu import DeepVCPConfig
from deepvcp_tpu.config import SALayerConfig
from deepvcp_tpu import pretrained as jpretrained
from deepvcp_tpu.data import SyntheticDataset, batch_iterator
from deepvcp_tpu.models import DeepVCP as JDeepVCP
from deepvcp_tpu.models import fused_sa as jfused_sa
from deepvcp_tpu.models import layers as jlayers
from deepvcp_tpu.ops import neighbors as jnb
from deepvcp_tpu.registration import Registrar as JRegistrar
from deepvcp_tpu_torch import config as tconfig
from deepvcp_tpu_torch import pretrained
from deepvcp_tpu_torch.convert import flax_to_torch
from deepvcp_tpu_torch.models import DeepVCP, fused_sa, layers
from deepvcp_tpu_torch.ops import neighbors as tnb
from deepvcp_tpu_torch.ops.kernels import banded_masked_max_grad_reference
from deepvcp_tpu_torch.registration import Registrar

torch.set_num_threads(2)

FEAT_RTOL = 1e-5
GRAD_RTOL = 1e-4
TRAIN_GRAD_RTOL = 5e-3
STAT_RTOL = 1e-4
WEIGHT_ATOL = 1e-6
CANCEL_FRAC = 1e-3


def _perturb(variables, seed):
    """Random BN statistics and nonzero biases, so every converted tensor
    matters (flax init leaves biases 0 and statistics 0 / 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in jax.device_get(variables).items():
        def leaf(path, a, col=col):
            a = np.asarray(a)
            if col == "batch_stats" and path[-1].key == "var":
                return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[col] = jax.tree_util.tree_map_with_path(leaf, tree)
    return out


def _close(got, want, rtol=FEAT_RTOL, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=rtol * max(np.abs(want).max(), 1e-12),
                               rtol=0, err_msg=what)


def _grads_close(module, jgrads, rtol):
    want = {k: v.numpy() for k, v in flax_to_torch({"params": jgrads}).items()}
    top = max(np.abs(w).max() for w in want.values())
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        got, w = p.grad.numpy(), want[name]
        scale = top if np.abs(w).max() < CANCEL_FRAC * top else np.abs(w).max()
        np.testing.assert_allclose(got, w, atol=rtol * scale, rtol=0, err_msg=name)


def _cloud(seed, B, N, scale=1.5):
    return np.random.default_rng(seed).uniform(-scale, scale, (B, N, 3)).astype(np.float32)


# --- the gather-path SetAbstraction ------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("engine", ["windowed", "dense"])
def test_gather_set_abstraction(engine, train):
    """One SA stage (npoint == N, 24 neighbours, mlp 16-16-32) on 2 x 200
    points with 8 input features, forward (eval: running statistics; train:
    batch statistics and their update) and the gradients of every parameter
    for a fixed cotangent. Windowed: a 128-point window, so some slabs
    overflow it; dense: 64-query chunks."""
    layer = SALayerConfig(npoint=200, radius=0.5, nsample=24, mlp=(16, 16, 32))
    xyz = _cloud(0, 2, 200)
    feats = np.random.default_rng(1).standard_normal((2, 200, 8)).astype(np.float32)
    g = np.random.default_rng(2).standard_normal((2, 200, 32)).astype(np.float32)
    window = 128 if engine == "windowed" else None
    if engine == "windowed":
        xyz = np.asarray(jnb.sort_cloud(jnp.asarray(xyz)).xyz)
    jm = jlayers.SetAbstraction(layer, query_chunk=64, window=window)

    def japply(v, x, f):
        cloud = jnb.sort_cloud(x) if engine == "windowed" else None
        out = jm.apply(v, x, f, train, sorted_cloud=cloud,
                       mutable=["batch_stats"] if train else False)
        return out if train else (out, None)

    v = _perturb(jm.init(jax.random.key(0), xyz, feats), 0)
    ((new_j, out_j), upd_j) = japply(v, jnp.asarray(xyz), jnp.asarray(feats))
    jgrads = jax.grad(lambda p: jnp.sum(japply({"params": p, "batch_stats": v["batch_stats"]},
                                               jnp.asarray(xyz), jnp.asarray(feats))[0][1] * g))(
        v["params"])

    tm = layers.SetAbstraction(layer, 8, query_chunk=64)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    tm.train(train)
    x = torch.from_numpy(xyz)
    cloud = tnb.sort_cloud(x) if engine == "windowed" else None
    new_t, out_t = tm(x, torch.from_numpy(feats), sorted_cloud=cloud, window=window)
    np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
    _close(out_t.detach().numpy(), out_j, what="features")
    (out_t * torch.from_numpy(g)).sum().backward()
    _grads_close(tm, jgrads, TRAIN_GRAD_RTOL if train else GRAD_RTOL)
    if train:
        stats = flax_to_torch({"params": {}, "batch_stats": upd_j["batch_stats"]})
        for name, b in tm.named_buffers():
            if not name.endswith("num_batches_tracked"):
                _close(b.numpy(), stats[name].numpy(), STAT_RTOL, what=name)


def test_train_mode_gradients_against_float64():
    """The windowed case of test_gather_set_abstraction in training mode,
    against a float64 run of the port: the port's f32 gradients within
    1e-5 of each tensor's max (measured 2.1e-6), JAX's within
    TRAIN_GRAD_RTOL (measured 3.1e-3), cancelling sums of the largest max."""
    layer = SALayerConfig(npoint=200, radius=0.5, nsample=24, mlp=(16, 16, 32))
    xyz = np.asarray(jnb.sort_cloud(jnp.asarray(_cloud(0, 2, 200))).xyz)
    feats = np.random.default_rng(1).standard_normal((2, 200, 8)).astype(np.float32)
    g = np.random.default_rng(2).standard_normal((2, 200, 32)).astype(np.float32)
    jm = jlayers.SetAbstraction(layer, query_chunk=64, window=128)
    v = _perturb(jm.init(jax.random.key(0), xyz, feats), 0)
    jgrads = jax.grad(lambda p: jnp.sum(jm.apply(
        {"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(xyz), jnp.asarray(feats),
        True, sorted_cloud=jnb.sort_cloud(jnp.asarray(xyz)), mutable=["batch_stats"])[0][1] * g))(
        v["params"])
    grads = {}
    for dt in (torch.float32, torch.float64):
        tm = layers.SetAbstraction(layer, 8, query_chunk=64)
        tm.load_state_dict(flax_to_torch(v), strict=True)
        tm.to(dt).train()
        x = torch.from_numpy(xyz).to(dt)
        _, out = tm(x, torch.from_numpy(feats).to(dt), sorted_cloud=tnb.sort_cloud(x), window=128)
        (out * torch.from_numpy(g).to(dt)).sum().backward()
        grads[dt] = {n: p.grad.double().numpy() for n, p in tm.named_parameters()}
    ref = grads[torch.float64]
    jax_g = {n: t.double().numpy() for n, t in flax_to_torch({"params": jgrads}).items()}
    top = max(np.abs(r).max() for r in ref.values())
    for name, r in ref.items():
        scale = top if np.abs(r).max() < CANCEL_FRAC * top else np.abs(r).max()
        np.testing.assert_allclose(grads[torch.float32][name], r, atol=1e-5 * scale, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(jax_g[name], r, atol=TRAIN_GRAD_RTOL * scale, rtol=0,
                                   err_msg=name)


def test_gather_set_abstraction_samples_with_fps():
    """npoint < N: FPS picks the centroids (the port's plain FPS loop here,
    kernel K3 on the card), then the dense grouping around them."""
    layer = SALayerConfig(npoint=64, radius=0.6, nsample=16, mlp=(16, 32))
    xyz = _cloud(3, 2, 256)
    jm = jlayers.SetAbstraction(layer, query_chunk=None)
    v = _perturb(jm.init(jax.random.key(1), xyz, None), 1)
    new_j, out_j = jm.apply(v, jnp.asarray(xyz), None)
    tm = layers.SetAbstraction(layer, None).eval()
    tm.load_state_dict(flax_to_torch(v), strict=True)
    with torch.no_grad():
        new_t, out_t = tm(torch.from_numpy(xyz), None)
    np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
    _close(out_t.numpy(), out_j)


# --- the static band ----------------------------------------------------------

def _bf16_step(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


STATIC_BAND_SHAPES = [
    (128, 128, 256, 16),    # tiny(): the band is 3 copies of the one tile
    (700, 128, 64, 8),      # 11 tiles, 2 a side: under-covers the slab
    (700, 384, 128, 5),     # 6 tiles, 3 a side: a tile twice in the band
]


def _static_band_pair(N, window, tile, C, dtype):
    """(JAX's banded_max_pool forward and its VJP's gradient, the port's
    static_band_max_pool output and u's gradient) on the same inputs in
    `dtype`, all as float32 numpy (float32 values of bf16 ones)."""
    xyz = np.asarray(jnb.sort_cloud(jnp.asarray(_cloud(4, 2, N, 1.0))).xyz)
    u = np.random.default_rng(5).standard_normal((2, N, C)).astype(np.float32)
    g = np.random.default_rng(6).standard_normal((2, N, C)).astype(np.float32)
    radius = 0.3
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out_j, vjp = jax.vjp(lambda a: jfused_sa.banded_max_pool(
        jnp.asarray(xyz).astype(jdt), a, radius, window, tile, False), jnp.asarray(u).astype(jdt))
    (grad_j,) = vjp(jnp.asarray(g).astype(jdt))
    x_t = torch.from_numpy(xyz).to(tdt)
    u_t = torch.from_numpy(u).to(tdt).requires_grad_()
    out_t = fused_sa.static_band_max_pool(x_t, u_t, radius, window, tile)
    out_t.backward(torch.from_numpy(g).to(tdt))
    assert out_t.dtype == tdt and u_t.grad.dtype == tdt
    return ([np.asarray(a.astype(jnp.float32)) for a in (out_j, grad_j)],
            [a.detach().float().numpy() for a in (out_t, u_t.grad)],
            (x_t, u_t.detach(), torch.from_numpy(g), radius))


@pytest.mark.parametrize("N,window,tile,C", STATIC_BAND_SHAPES)
def test_static_band_forward_backward(N, window, tile, C):
    """The port's static band equals xla_banded_max (max: exactly) and its
    backward the JAX custom VJP's static-band formula (sums in another
    order: 1e-5 of max). At N <= tile the band holds its tile 3 times and
    the gradient is 3x the exact slab's (the JAX formula's behaviour,
    reproduced)."""
    (out_j, grad_j), (out_t, grad_t), (x_t, u_t, g_t, radius) = _static_band_pair(
        N, window, tile, C, "float32")
    np.testing.assert_array_equal(out_t, out_j)
    _close(grad_t, grad_j, what="grad_u")
    if N <= tile:
        copies = 2 * -(-window // N) + 1    # one tile, half = ceil(window / N) a side
        assert copies == 3
        exact = banded_masked_max_grad_reference(x_t, u_t, torch.from_numpy(out_t), g_t, radius)
        _close(grad_t, copies * exact.numpy(), what="tripled")


def _bf16_step(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("N,window,tile,C", STATIC_BAND_SHAPES)
def test_static_band_bf16_matches_jax(N, window, tile, C):
    """compute_dtype="bfloat16" on the static band: both packages take bf16
    differences and squares, sum them in f32 and round d^2 to bf16 (XLA's
    CPU sums bf16 in f32), so the masks and the max are the same bits; the
    backward's f32 sums, rounded to bf16, are held to one bf16 step of
    their max. JAX runs op by op here: under jax.jit XLA may keep d^2 in
    f32, which moves the mask."""
    (out_j, grad_j), (out_t, grad_t), _ = _static_band_pair(N, window, tile, C, "bfloat16")
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_allclose(grad_t, grad_j, atol=_bf16_step(np.abs(grad_j).max()), rtol=0)


def test_static_band_blocks_match_one_block(monkeypatch):
    """The port pools the band a block of tiles at a time; blocks of one
    tile give the same bits as one block of all tiles. band_of, the whole
    band at once, equals JAX's."""
    xyz = np.asarray(jnb.sort_cloud(jnp.asarray(_cloud(7, 1, 900, 1.0))).xyz)
    u = np.random.default_rng(8).standard_normal((1, 900, 12)).astype(np.float32)
    tiles = fused_sa.pad_to_tiles(torch.from_numpy(u), 64, 0.0).reshape(1, 15, 64, 12)
    np.testing.assert_array_equal(
        fused_sa.band_of(tiles, 2).numpy(),
        np.asarray(jfused_sa.band_of(jnp.asarray(tiles.numpy()), 2)))
    args = (torch.from_numpy(xyz), torch.from_numpy(u), 0.25, 256, 64)
    whole = fused_sa.static_band_max(*args)
    monkeypatch.setattr(fused_sa, "_BAND_BLOCK", 1)
    np.testing.assert_array_equal(fused_sa.static_band_max(*args).numpy(), whole.numpy())


# --- DeepVCP under each branch, training mode --------------------------------

BRANCHES = {
    "windowed": {"neighbor_method": "windowed"},
    # query_chunk = N: one block (tests/test_torch_grouping.py covers chunks;
    # JAX compiles a lax.map of 64-query chunks slowly under grad)
    "dense": {"neighbor_method": "dense", "query_chunk": 128},
    "static_band": {"use_pallas_band_max": False},
    "keypoints": {"dfe_src_neighbors": "keypoints", "use_pallas_band_max": False},
    "two_level_plain": {"tgt_knn": "two_level", "use_pallas_onehot_gather": False,
                        "use_pallas_band_max": False},
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_deepvcp_branch_trains_like_jax(branch):
    """DeepVCP at tiny() (f32 candidate selection) in training mode (batch
    statistics) under each branch: outputs, updated running statistics and
    the gradients of a loss on the VCPs and saliencies. The banded branches
    run the static band in both packages, whose JAX backward is the
    reference here (tripled at N <= band_tile, reproduced)."""
    cfg = dataclasses.replace(DeepVCPConfig.tiny(use_normal=True), knn_select_dtype=None,
                              **BRANCHES[branch]).resolve()
    rng = np.random.default_rng(20)
    # 6 channels, xyz and (unnormalised) normals: the normals make every
    # point's features distinct, so no two saliencies tie (on 128 points at
    # these radii many points are alone in their ball, and xyz alone gives
    # them equal features that top-K orders by its own tie rule)
    src = np.random.default_rng(21).uniform(-1.5, 1.5, (2, cfg.num_points, 6)).astype(np.float32)
    tgt = (src + rng.normal(0, 0.02, src.shape)).astype(np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy()
    t = rng.uniform(-0.1, 0.1, (2, 3)).astype(np.float32)
    jm = JDeepVCP(cfg=cfg)
    v = _perturb(jm.init(jax.random.key(20), src, tgt, R, t), 20)

    def jloss(params):
        (kp, vcp, aux), upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                                       src, tgt, R, t, train=True, mutable=["batch_stats"])
        return jnp.sum(vcp ** 2) + jnp.sum(aux["keypoint_saliency"]), (vcp, aux, upd)

    (_, (vcp_j, aux_j, upd_j)), jgrads = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    tm = DeepVCP(cfg)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    tm.train()
    _, vcp_t, aux_t = tm(*map(torch.from_numpy, (src, tgt, R, t)))
    np.testing.assert_array_equal(aux_t["keypoint_idx"].numpy(), np.asarray(aux_j["keypoint_idx"]))
    _close(vcp_t.detach().numpy(), vcp_j, what="vcp")
    _close(aux_t["src_descriptors"].detach().numpy(), aux_j["src_descriptors"], what="desc")
    (vcp_t.square().sum() + aux_t["keypoint_saliency"].sum()).backward()
    _grads_close(tm, jgrads, TRAIN_GRAD_RTOL)
    stats = flax_to_torch({"params": {}, "batch_stats": upd_j["batch_stats"]})
    for name, b in tm.named_buffers():
        if not name.endswith("num_batches_tracked"):
            _close(b.numpy(), stats[name].numpy(), what=name)


@pytest.mark.parametrize("change", [{"neighbor_method": "windowed"},
                                    {"use_pallas_band_max": False, "band_tile": 64}])
def test_window_follows_the_cloud(change):
    """cfg.num_points = 128, clouds of 512 points: both packages size each
    stage's window from the call's N (window_for(512, ...) = 512 here, where
    the config's N would give 128), so the windowed engine and the static
    band (8 tiles of 64, 8 a side rather than 2) agree with JAX at any N.
    The stages keep all 512 points (npoint = 512), so every windowed stage
    runs the windowed query. Eval mode: keypoints exact, the rest FEAT_RTOL
    of its max."""
    N = 512
    tiny = DeepVCPConfig.tiny(use_normal=True)
    cfg = dataclasses.replace(
        tiny, knn_select_dtype=None, sa_layers=tuple(
            dataclasses.replace(layer, npoint=N) for layer in tiny.sa_layers),
        **change).resolve()
    for layer in cfg.sa_layers:
        assert tnb.window_for(N, layer.radius, cfg.spatial_extent, cfg.window_safety) > \
            tnb.window_for(cfg.num_points, layer.radius, cfg.spatial_extent, cfg.window_safety)
    rng = np.random.default_rng(22)
    src = rng.uniform(-1.5, 1.5, (1, N, 6)).astype(np.float32)
    tgt = (src + rng.normal(0, 0.02, src.shape)).astype(np.float32)
    R = np.eye(3, dtype=np.float32)[None]
    t = rng.uniform(-0.1, 0.1, (1, 3)).astype(np.float32)
    jm = JDeepVCP(cfg=cfg)
    v = _perturb(jm.init(jax.random.key(22), src, tgt, R, t), 22)
    _, vcp_j, aux_j = jm.apply(v, src, tgt, R, t)
    tm = DeepVCP(cfg)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    with torch.no_grad():
        _, vcp_t, aux_t = tm.eval()(*map(torch.from_numpy, (src, tgt, R, t)))
    np.testing.assert_array_equal(aux_t["keypoint_idx"].numpy(), np.asarray(aux_j["keypoint_idx"]))
    for name in ("saliency", "src_descriptors"):
        _close(aux_t[name].numpy(), aux_j[name], what=name)
    _close(vcp_t.numpy(), vcp_j, what="vcp")


# --- campaign_r4b's windowed checkpoint at N = 2048 ---------------------------

@functools.lru_cache(maxsize=None)
def _q5w_pairs():
    """campaign_r4's held uniform_small set at N = 2048
    (scripts/campaign_r4_common.py:142-144), its first 2 pairs as the
    campaign's eval batches draw them (seed 777)."""
    ds = SyntheticDataset(num_clouds=16, num_points=2048, extent=1.0, seed=100,
                          max_rotation_deg=10.0, max_translation=0.5)
    return [b for _, b in zip(range(2), batch_iterator(ds, 1, epoch=0, seed=777, shuffle=False))]


@pytest.mark.parametrize("engine", ["windowed", "dense"])
def test_q5w_checkpoint_matches_jax(engine):
    """model_q5w's exported weights under its windowed engine and under the
    dense one, against JAX's forward on the same 2 pairs from identity.
    Candidate selection in f32 in both packages (knn_select_dtype=None), so
    that no bf16 near-tie swaps a neighbour (a documented difference of the
    selection, not of the engines)."""
    cfg_t = pretrained.campaign_config("campaign_r4b-q5w", neighbor_method=engine,
                                       knn_select_dtype=None)
    path = pretrained.CAMPAIGN["campaign_r4b-q5w"]["path"]
    fields = dataclasses.asdict(cfg_t)
    cfg_j = DeepVCPConfig(**{**fields, "sa_layers": tuple(
        SALayerConfig(**layer) for layer in fields["sa_layers"])})
    variables = jpretrained.load_variables(f"{pretrained._ROOT}/{path}")
    jm = JDeepVCP(cfg=cfg_j)
    tm = DeepVCP(cfg_t)
    tm.load_state_dict(flax_to_torch(pretrained.load_variables("campaign_r4b-q5w")), strict=True)
    tm.eval()
    eye, zero = np.eye(3, dtype=np.float32)[None], np.zeros((1, 3), np.float32)
    for src, tgt, _, _ in _q5w_pairs():
        src, tgt = src.astype(np.float32), tgt.astype(np.float32)
        kp_j, vcp_j, aux_j = jm.apply(variables, src, tgt, eye, zero)
        with torch.no_grad():
            kp_t, vcp_t, aux_t = tm(*map(torch.from_numpy, (src, tgt, eye, zero)))
        np.testing.assert_array_equal(aux_t["keypoint_idx"].numpy(),
                                      np.asarray(aux_j["keypoint_idx"]))
        for name in ("saliency", "src_descriptors"):
            _close(aux_t[name].numpy(), aux_j[name], what=name)
        np.testing.assert_allclose(aux_t["candidate_weights"].numpy(),
                                   np.asarray(aux_j["candidate_weights"]), atol=WEIGHT_ATOL)
        _close(vcp_t.numpy(), vcp_j, what="vcp")


# --- the slab-occupancy preflight ---------------------------------------------

@pytest.mark.parametrize("change", [{"neighbor_method": "windowed"},
                                    {"use_pallas_band_max": False}, {}])
def test_occupancy_warning_matches_jax(change):
    """On a cloud whose density along x grows ~40x, the windowed engine and
    the static band warn with the same message and suggested window_safety
    as the JAX preflight; the exact slab does not warn. The port audits on
    the first call only."""
    cfg = dataclasses.replace(DeepVCPConfig(num_points=2000, use_normal=False,
                                            spatial_extent=2.5, window_safety=2.0), **change)
    rng = np.random.default_rng(30)
    x = rng.power(6.0, (1, 2000)) * 2.0 - 1.0
    src = np.concatenate([x[..., None], rng.uniform(-1, 1, (1, 2000, 2))], -1).astype(np.float32)
    jreg = JRegistrar.__new__(JRegistrar)   # the preflight reads only cfg
    jreg.cfg = cfg
    tcfg = tconfig.DeepVCPConfig(**{**dataclasses.asdict(cfg), "sa_layers": tuple(
        tconfig.SALayerConfig(**layer) for layer in dataclasses.asdict(cfg)["sa_layers"])})
    treg = Registrar(tcfg, DeepVCP(tcfg).state_dict(), "cpu")
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jreg._check_extent(jnp.asarray(src))
        jreg._check_extent(jnp.asarray(src))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        treg._check_extent(torch.from_numpy(src))
        treg._check_extent(torch.from_numpy(src))
    jmsg = [str(w.message) for w in jw]
    tmsg = [str(w.message) for w in tw]
    assert tmsg == jmsg
    assert len(tmsg) == (1 if change else 0)
    if change:
        assert "Raise window_safety to ~" in tmsg[0]


# --- every single-device branch constructs; bf16 training --------------------

@pytest.mark.parametrize("method", ["banded", "windowed", "dense"])
def test_every_branch_constructs(method):
    """Every value DeepVCPConfig.resolve() accepts for the branch fields
    builds a port DeepVCP (the multi-device paths are M11's)."""
    import itertools

    base = tconfig.DeepVCPConfig.tiny()
    for kp, src_nb, band, tgt, gather, dtype, cand in itertools.product(
            ("topk", "salient_fps"), ("cloud", "keypoints"), (True, False),
            ("flat", "two_level", "auto"), (True, False), ("float32", "bfloat16"),
            ("auto", "exact", "approx")):
        cfg = dataclasses.replace(base, neighbor_method=method, keypoint_selection=kp,
                                  dfe_src_neighbors=src_nb, use_pallas_band_max=band,
                                  tgt_knn=tgt, use_pallas_onehot_gather=gather,
                                  compute_dtype=dtype, candidate_knn=cand)
        assert DeepVCP(cfg).cfg == cfg.resolve()


def test_bf16_training_pools_on_f32_copies(monkeypatch):
    """compute_dtype="bfloat16" in training mode: the pool's backward (K2's
    plain version here, kernel K2 on the card) runs on f32 copies of the
    bf16 values, and every parameter (f32) gets a finite f32 gradient."""
    seen = []
    grad = fused_sa.banded_masked_max_grad

    def record(xyz, u, out, g, radius):
        seen.append((xyz.dtype, u.dtype, out.dtype, g.dtype))
        return grad(xyz, u, out, g, radius)

    monkeypatch.setattr(fused_sa, "banded_masked_max_grad", record)
    cfg = dataclasses.replace(tconfig.DeepVCPConfig.tiny(), compute_dtype="bfloat16")
    model = DeepVCP(cfg).train()
    src = torch.from_numpy(np.random.default_rng(40).uniform(-1.5, 1.5, (2, 128, 6))
                           .astype(np.float32))
    eye = torch.eye(3).expand(2, 3, 3)
    _, vcp, aux = model(src, src + 0.01, eye, torch.zeros(2, 3))
    assert aux["saliency"].dtype == torch.bfloat16 and vcp.dtype == torch.float32
    (vcp.square().sum() + aux["keypoint_saliency"].float().sum()).backward()
    assert len(seen) == 6 and all(d == (torch.float32,) * 4 for d in seen)
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
