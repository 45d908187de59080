"""The port's modules (deepvcp_tpu_torch/models) against the flax modules,
with the same weights (flax init, perturbed, converted by
convert.flax_to_torch) and the same numpy inputs.

At DeepVCPConfig.tiny() (N=128) the JAX CPU path's static band covers every
point (window_for(...) == N), so its SA pooling equals the exact in-radius
slab that the port computes; candidate selection runs in f32
(knn_select_dtype=None) so that no bf16 near-tie can flip a neighbour.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu import DeepVCPConfig
from deepvcp_tpu.models import DeepVCP as JDeepVCP
from deepvcp_tpu.models import fused_sa as jfused_sa
from deepvcp_tpu.models import layers as jlayers
from deepvcp_tpu_torch import ops
from deepvcp_tpu_torch.convert import flax_to_torch
from deepvcp_tpu_torch.models import DeepVCP
from deepvcp_tpu_torch.models import fused_sa, layers

torch.set_num_threads(2)

FEAT_ATOL = 1e-4   # features, descriptors, VCPs: f32 through several MLP layers
WEIGHT_ATOL = 1e-5  # softmax candidate weights


def _cfg(use_normal):
    return dataclasses.replace(DeepVCPConfig.tiny(use_normal=use_normal),
                               knn_select_dtype=None).resolve()


def _perturb(variables, seed):
    """Random BN statistics and nonzero biases, so every converted tensor
    matters (flax init leaves biases 0 and statistics 0 / 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in jax.device_get(variables).items():
        def leaf(path, a, col=col):
            a = np.asarray(a)
            name = path[-1].key
            if col == "batch_stats" and name == "var":
                return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[col] = jax.tree_util.tree_map_with_path(leaf, tree)
    return out


def _torch_module(module, variables):
    module.load_state_dict(flax_to_torch(variables), strict=True)
    return module.eval()


def _cloud(rng, B, N, C):
    return rng.uniform(-1.5, 1.5, (B, N, C)).astype(np.float32)


def test_tiny_band_covers_the_slab():
    """The condition under which the JAX CPU path and the port agree."""
    cfg = _cfg(True)
    for layer in cfg.sa_layers:
        assert ops.window_for(cfg.num_points, layer.radius, cfg.spatial_extent,
                              cfg.window_safety) >= cfg.num_points


@pytest.mark.parametrize("with_features", [False, True])
@pytest.mark.parametrize("stage", [0, 2])
def test_banded_set_abstraction(stage, with_features):
    cfg = _cfg(True)
    layer = cfg.sa_layers[stage]
    rng = np.random.default_rng(stage)
    xyz = np.asarray(ops.sort_cloud(torch.from_numpy(_cloud(rng, 2, 128, 3))).xyz)
    feats = rng.standard_normal((2, 128, 8)).astype(np.float32) if with_features else None
    jm = jfused_sa.BandedSetAbstraction(layer, window=128, tile=cfg.band_tile, use_pallas=True)
    v = _perturb(jm.init(jax.random.key(0), xyz, feats), stage)
    want = np.asarray(jm.apply(v, xyz, feats))
    tm = _torch_module(fused_sa.BandedSetAbstraction(layer, 8 if with_features else None), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(xyz), None if feats is None else torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), want, atol=FEAT_ATOL)


@pytest.mark.parametrize("use_normal", [True, False])
def test_feature_extraction(use_normal):
    cfg = _cfg(use_normal)
    rng = np.random.default_rng(3)
    pts = _cloud(rng, 2, cfg.num_points, 6)
    nrm = pts[..., 3:] if use_normal else None
    jm = jlayers.FeatureExtraction(cfg)
    v = _perturb(jm.init(jax.random.key(1), pts[..., :3], nrm), 3)
    want = np.asarray(jm.apply(v, pts[..., :3], nrm))
    tm = _torch_module(layers.FeatureExtraction(cfg), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(pts[..., :3].copy()),
                 None if nrm is None else torch.from_numpy(nrm.copy()))
    np.testing.assert_allclose(got.numpy(), want, atol=FEAT_ATOL)


def test_weighting_layer():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 50, 32)).astype(np.float32)
    jm = jlayers.WeightingLayer((16, 8, 1))
    v = _perturb(jm.init(jax.random.key(2), x), 4)
    tm = _torch_module(layers.WeightingLayer((16, 8, 1), 32), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, x)), atol=FEAT_ATOL)


@pytest.mark.parametrize("shape", [(2, 5, 8, 35), (1, 3, 27, 8, 35)])
def test_feat_embedding(shape):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = jlayers.FeatEmbedding((32, 32, 32))
    v = _perturb(jm.init(jax.random.key(3), x), 5)
    tm = _torch_module(layers.FeatEmbedding((32, 32, 32), 35), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, x)), atol=FEAT_ATOL)


def test_cpg():
    rng = np.random.default_rng(6)
    B, K, gs, F = 2, 3, 6, 32
    src = rng.standard_normal((B, K, F)).astype(np.float32)
    tgt = rng.standard_normal((B, K, gs ** 3, F)).astype(np.float32)
    cand = rng.uniform(-1, 1, (B, K, gs ** 3, 3)).astype(np.float32)
    jm = jlayers.CPG((16, 4, 1), grid_size=gs)
    v = _perturb(jm.init(jax.random.key(4), src, tgt, cand), 6)
    vcp_j, w_j = jm.apply(v, src, tgt, cand)
    tm = _torch_module(layers.CPG((16, 4, 1), gs, F), v)
    with torch.no_grad():
        vcp_t, w_t = tm(*map(torch.from_numpy, (src, tgt, cand)))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=WEIGHT_ATOL)
    np.testing.assert_allclose(vcp_t.numpy(), np.asarray(vcp_j), atol=FEAT_ATOL)


def _pair(cfg, seed):
    rng = np.random.default_rng(seed)
    C = 6 if cfg.use_normal else 3
    src = _cloud(rng, 2, cfg.num_points, C)
    tgt = (src + rng.normal(0, 0.02, src.shape)).astype(np.float32)
    a = np.radians(3.0)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    R = np.stack([R, R.T])
    t = rng.uniform(-0.1, 0.1, (2, 3)).astype(np.float32)
    return src, tgt, R, t


@functools.lru_cache(maxsize=None)
def _models(use_normal, keypoint_selection="topk"):
    """(flax model, its perturbed variables, the converted port model, inputs)."""
    cfg = dataclasses.replace(_cfg(use_normal), keypoint_selection=keypoint_selection)
    seed = 10 + use_normal
    src, tgt, R, t = _pair(cfg, seed)
    jm = JDeepVCP(cfg=cfg)
    v = _perturb(jm.init(jax.random.key(seed), src, tgt, R, t), seed)
    return jm, v, _torch_module(DeepVCP(cfg), v), (src, tgt, R, t)


def _forward_parity(jm, v, tm, inputs):
    kp_j, vcp_j, aux_j = jm.apply(v, *map(jnp.asarray, inputs))
    with torch.no_grad():
        kp_t, vcp_t, aux_t = tm(*map(torch.from_numpy, inputs))
    np.testing.assert_array_equal(aux_t["keypoint_idx"].numpy(), np.asarray(aux_j["keypoint_idx"]))
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_j))
    for name in ("saliency", "keypoint_saliency", "src_descriptors"):
        np.testing.assert_allclose(aux_t[name].numpy(), np.asarray(aux_j[name]),
                                   atol=FEAT_ATOL, err_msg=name)
    np.testing.assert_allclose(aux_t["candidate_weights"].numpy(),
                               np.asarray(aux_j["candidate_weights"]), atol=WEIGHT_ATOL)
    np.testing.assert_allclose(vcp_t.numpy(), np.asarray(vcp_j), atol=FEAT_ATOL)


@pytest.mark.parametrize("use_normal", [True, False])
def test_deepvcp_forward(use_normal):
    _forward_parity(*_models(use_normal))


def test_deepvcp_forward_salient_fps():
    """keypoint_selection="salient_fps": FPS of 16 keypoints over the top-64
    saliency pool of a 128-point cloud, through the port's FPS (the plain
    version on the CPU) and the JAX jnp loop. The cloud is dense (uniform in
    a 3 m cube at SA radii 0.4-1.2), so no two saliencies tie and both
    top-K pick the same pool in the same order; keypoint indices must then
    be equal."""
    jm, v, tm, inputs = _models(False, "salient_fps")
    _forward_parity(jm, v, tm, inputs)
    with torch.no_grad():
        sal = tm.encode(*map(torch.from_numpy, inputs[:2])).saliency
    top = torch.topk(sal, 65, dim=-1).values
    assert (top[:, :-1] > top[:, 1:]).all(), "tied saliencies in the pool"
    # the selection is not the plain top-K
    with torch.no_grad():
        _, _, aux = tm(*map(torch.from_numpy, inputs))
    assert not torch.equal(torch.sort(aux["keypoint_idx"]).values,
                           torch.sort(torch.topk(sal, 16, dim=-1).indices).values)


def test_encode_correspond_equals_forward():
    _, _, tm, inputs = _models(False)
    src, tgt, R, t = map(torch.from_numpy, inputs)
    with torch.no_grad():
        kp, vcp, aux = tm(src, tgt, R, t)
        kp2, vcp2, aux2 = tm.correspond(tm.encode(src, tgt), R, t)
    assert torch.equal(kp, kp2) and torch.equal(vcp, vcp2)
    assert torch.equal(aux["candidate_weights"], aux2["candidate_weights"])


def test_forward_tracks_gradients():
    """A forward under autograd reaches every parameter (the SA stages
    through the pool's K2 backward) with finite gradients, and in eval()
    leaves the BatchNorm statistics as they were."""
    _, v, _, inputs = _models(False)
    tm = _torch_module(DeepVCP(_cfg(False)), v)
    stats = {name: b.clone() for name, b in tm.named_buffers()}
    _, vcp, aux = tm(*map(torch.from_numpy, inputs))
    (vcp.square().sum() + aux["keypoint_saliency"].sum()).backward()
    for name, p in tm.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    for stage in ("sa1", "sa2", "sa3"):
        assert getattr(tm.fe, stage).proj_xyz.weight.grad.abs().max() > 0, stage
    for name, b in tm.named_buffers():
        assert torch.equal(b, stats[name]), name


def test_two_level_builds_and_auto_selects_it():
    """tgt_knn="two_level" builds; "auto" takes it at the bench operating
    point (extent 20, reach 1.0) and not at ModelNet scale, under exact
    candidate selection or with "flat" (the gate of test_two_level.py)."""
    from deepvcp_tpu_torch.config import DeepVCPConfig as PortConfig

    assert DeepVCP(dataclasses.replace(PortConfig.tiny(), tgt_knn="two_level")).cfg \
        .use_two_level_tgt_knn
    base = PortConfig(num_points=1024, use_normal=False)
    auto = dataclasses.replace(base, tgt_knn="auto")
    assert not base.use_two_level_tgt_knn and auto.use_two_level_tgt_knn
    assert DeepVCP(dataclasses.replace(auto, num_points=128)).cfg.use_two_level_tgt_knn
    assert not dataclasses.replace(auto, spatial_extent=2.5).use_two_level_tgt_knn
    assert not dataclasses.replace(auto, candidate_knn="exact").use_two_level_tgt_knn
    assert not dataclasses.replace(base, tgt_knn="flat").use_two_level_tgt_knn


BF16_STEPS = 4   # bf16 values: within 4 bf16 steps (2^-7 relative) of their max


def _bf16_step(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("change", [
    {"neighbor_method": "windowed"},
    {"dfe_src_neighbors": "keypoints"},
    {"use_pallas_band_max": False},
    {"tgt_knn": "two_level", "use_pallas_onehot_gather": False},
    {"compute_dtype": "bfloat16"},
    {"compute_dtype": "bfloat16", "use_pallas_band_max": False},
])
def test_formerly_unported_branches_match_jax(monkeypatch, change):
    """The branches that raised before the port had them, against the flax
    model on the same weights and inputs (use_normal, so no saliencies tie):
    f32 as test_deepvcp_forward (exact keypoints, FEAT_ATOL, WEIGHT_ATOL).

    bfloat16 on the exact slab: the JAX model's SA pooling runs the Pallas
    kernel (interpret mode) on f32 copies of the bf16 values, the TPU
    dispatch the port follows with K1. bfloat16 on the static band: JAX's
    own CPU dispatch, xla_banded_max on the bf16 values, which the port's
    static band follows (bf16 distances). The weighting layer's last kernel is scaled 30x so that the saliencies
    spread out: the top-16 set is then clear of the 17th by more than two
    bf16 steps (asserted), so both packages pick the same keypoints, though
    torch.topk and lax.top_k may order bf16 ties among them differently.
    Saliencies are held to BF16_STEPS bf16 steps of their max, and the
    per-keypoint descriptors, candidate weights and VCPs, compared by
    keypoint index, likewise (VCPs: f32 centroids of bf16 weights)."""
    cfg = dataclasses.replace(_cfg(True), **change)
    src, tgt, R, t = _pair(cfg, 11)
    jm = JDeepVCP(cfg=cfg)
    v = _perturb(jm.init(jax.random.key(11), src, tgt, R, t), 11)
    if "compute_dtype" not in change:
        _forward_parity(jm, v, _torch_module(DeepVCP(cfg), v), (src, tgt, R, t))
        return
    v["params"]["wl"]["Dense_2"]["kernel"] = v["params"]["wl"]["Dense_2"]["kernel"] * 30
    if cfg.use_pallas_band_max:
        monkeypatch.setattr(jfused_sa, "_use_band_kernel", lambda use_kernel: use_kernel)
    kp_j, vcp_j, aux_j = jm.apply(v, *map(jnp.asarray, (src, tgt, R, t)))
    with torch.no_grad():
        kp_t, vcp_t, aux_t = _torch_module(DeepVCP(cfg), v)(*map(torch.from_numpy,
                                                                 (src, tgt, R, t)))
    assert aux_t["saliency"].dtype == torch.bfloat16 and vcp_t.dtype == torch.float32
    sal_j = np.asarray(aux_j["saliency"]).astype(np.float32)
    top = np.sort(sal_j, axis=-1)[:, ::-1]
    K = cfg.num_keypoints
    assert (top[:, K - 1] - top[:, K] > 2 * _bf16_step(top[:, K - 1])).all(), "top-K not clear"

    def close(got, want, what):
        want = np.asarray(want).astype(np.float32)
        atol = BF16_STEPS * _bf16_step(np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0, err_msg=what)

    close(aux_t["saliency"], sal_j, "saliency")
    idx_j = np.asarray(aux_j["keypoint_idx"])
    idx_t = aux_t["keypoint_idx"].numpy()
    oj, ot = np.argsort(idx_j, axis=-1), np.argsort(idx_t, axis=-1)
    np.testing.assert_array_equal(np.take_along_axis(idx_t, ot, 1),
                                  np.take_along_axis(idx_j, oj, 1))
    by_t = lambda x: torch.from_numpy(np.take_along_axis(  # noqa: E731
        x.float().numpy(), ot.reshape(ot.shape + (1,) * (x.dim() - 2)), 1))
    by_j = lambda x: np.take_along_axis(  # noqa: E731
        np.asarray(x).astype(np.float32), oj.reshape(oj.shape + (1,) * (x.ndim - 2)), 1)
    close(by_t(aux_t["src_descriptors"]), by_j(aux_j["src_descriptors"]), "src_descriptors")
    close(by_t(aux_t["candidate_weights"]), by_j(aux_j["candidate_weights"]), "weights")
    close(by_t(vcp_t), by_j(vcp_j), "vcp")
