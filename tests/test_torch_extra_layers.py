"""SetAbstractionMSG and FeaturePropagation of the port
(deepvcp_tpu_torch/models/extra_layers.py) against the flax modules of
deepvcp_tpu/models/extra_layers.py, with the same weights (flax init,
perturbed, converted by convert.flax_to_torch) and the same numpy inputs.
Sampled centroids exact (the port's plain FPS loop and JAX's); features
within 1e-5 of their max magnitude with BatchNorm on its running statistics,
2e-4 in training mode (XLA's CPU sums the batch statistics in f32 in order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu.models import extra_layers as jextra
from deepvcp_tpu_torch.convert import flax_to_torch
from deepvcp_tpu_torch.models import FeaturePropagation, SetAbstractionMSG

torch.set_num_threads(2)

RTOL = {False: 1e-5, True: 2e-4}


def _perturb(variables, seed):
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


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _apply(jm, v, train, *args):
    if train:
        return jm.apply(v, *args, train=True, mutable=["batch_stats"])[0]
    return jm.apply(v, *args)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("npoint,with_features", [(48, True), (48, False), (200, True)])
def test_set_abstraction_msg(npoint, with_features, train):
    """Two scales (r 0.3 / 0.6, 8 / 16 neighbours) on 2 x 200 points:
    FPS to 48 centroids, or all 200 (no FPS)."""
    rng = np.random.default_rng(npoint)
    xyz = rng.uniform(-1, 1, (2, 200, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 200, 5)).astype(np.float32) if with_features else None
    kw = dict(npoint=npoint, radius_list=(0.3, 0.6), nsample_list=(8, 16),
              mlp_list=((16, 32), (16, 16, 24)))
    jm = jextra.SetAbstractionMSG(**kw)
    v = _perturb(jm.init(jax.random.key(0), xyz, feats), 1)
    new_j, out_j = _apply(jm, v, train, jnp.asarray(xyz), None if feats is None else jnp.asarray(feats))
    tm = SetAbstractionMSG(**kw, in_features=5 if with_features else 0)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    tm.train(train)
    new_t, out_t = tm(torch.from_numpy(xyz), None if feats is None else torch.from_numpy(feats))
    np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
    assert out_t.shape == (2, npoint, 32 + 24)
    _close(out_t, out_j, RTOL[train])


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("S,with_dense", [(40, True), (40, False), (1, True)])
def test_feature_propagation(S, with_dense, train):
    """Inverse-distance 3-NN interpolation from S sparse points onto 150
    dense ones (S = 1: every dense point takes the one feature), with and
    without the dense points' own features, then the unit MLP."""
    rng = np.random.default_rng(S)
    dense = rng.uniform(-1, 1, (2, 150, 3)).astype(np.float32)
    sparse = dense[:, :S].copy()
    fd = rng.standard_normal((2, 150, 4)).astype(np.float32) if with_dense else None
    fs = rng.standard_normal((2, S, 6)).astype(np.float32)
    jm = jextra.FeaturePropagation(mlp=(32, 16))
    v = _perturb(jm.init(jax.random.key(2), dense, sparse, fd, fs), 3)
    out_j = _apply(jm, v, train, jnp.asarray(dense), jnp.asarray(sparse),
                   None if fd is None else jnp.asarray(fd), jnp.asarray(fs))
    tm = FeaturePropagation((32, 16), in_features=6 + (4 if with_dense else 0))
    tm.load_state_dict(flax_to_torch(v), strict=True)
    tm.train(train)
    out_t = tm(torch.from_numpy(dense), torch.from_numpy(sparse),
               None if fd is None else torch.from_numpy(fd), torch.from_numpy(fs))
    assert out_t.shape == (2, 150, 16)
    _close(out_t, out_j, RTOL[train])
