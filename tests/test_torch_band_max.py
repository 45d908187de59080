"""Kernels K1 and K2 (deepvcp_tpu_torch/ops/kernels/band_max.py): the plain
PyTorch versions against the Pallas TPU kernels in interpret mode and a
numpy oracle, and, on a CUDA card, the Hopper kernels against the plain
versions.

JAX is imported inside the tests that use it, so that the card-only tests of
this file run where jax is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_band_max.py
"""

import numpy as np
import pytest
import torch

from deepvcp_tpu_torch.data.synthetic import lidar_like_cloud
from deepvcp_tpu_torch.ops.kernels import band_max, reference_path
from deepvcp_tpu_torch.models.fused_sa import banded_max_pool
from deepvcp_tpu_torch.ops.kernels.band_max import (
    banded_masked_max,
    banded_masked_max_grad,
    banded_masked_max_grad_reference,
    banded_masked_max_reference,
)

torch.set_num_threads(2)


def _sorted_cloud(rng, B, N, spread):
    xyz = rng.uniform(-spread, spread, (B, N, 3)).astype(np.float32)
    order = np.argsort(xyz[..., 0], axis=1, kind="stable")
    return np.take_along_axis(xyz, order[..., None], axis=1)


def _pallas(xyz, u, radius):
    import jax
    import jax.numpy as jnp

    from deepvcp_tpu.ops.pallas import banded_masked_max as pallas_max

    jax.config.update("jax_platforms", "cpu")
    return np.asarray(pallas_max(jnp.asarray(xyz), jnp.asarray(u), float(radius),
                                 tile=128, chunk=512, interpret=True))


@pytest.mark.parametrize("C", [16, 64])
@pytest.mark.parametrize("N", [300, 700])
@pytest.mark.parametrize("B", [1, 2])
def test_reference_matches_pallas(B, N, C):
    """Exact equality with the TPU kernel's semantics (fused_sa.py calls it
    with tile=128, chunk=512), at radii from sparse to half the cloud."""
    rng = np.random.default_rng(100 * B + N + C)
    xyz = _sorted_cloud(rng, B, N, 2.0)
    u = rng.standard_normal((B, N, C)).astype(np.float32)
    for radius in (0.15, 0.4, 1.1):
        want = _pallas(xyz, u, radius)
        got = banded_masked_max(torch.from_numpy(xyz), torch.from_numpy(u), radius)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"radius={radius}")


def test_self_neighbor_and_empty_rows():
    """At a radius below every pairwise gap each point pools only itself;
    the value -1e30 is reserved for rows with no point in radius, which the
    self-neighbour makes impossible for real queries."""
    rng = np.random.default_rng(2)
    xyz = _sorted_cloud(rng, 1, 150, 3.0)
    u = rng.standard_normal((1, 150, 8)).astype(np.float32)
    got = banded_masked_max(torch.from_numpy(xyz), torch.from_numpy(u), 1e-4).numpy()
    np.testing.assert_array_equal(got, u)
    np.testing.assert_array_equal(got, _pallas(xyz, u, 1e-4))


def _grad_oracle(xyz, u, g, radius):
    """numpy: the exact in-radius max and its VJP, each tie taking the full
    cotangent (tests/test_pallas.py's oracle)."""
    B, N, C = u.shape
    out = np.full((B, N, C), -1e30, np.float32)
    grad = np.zeros((B, N, C), np.float32)
    for b in range(B):
        for q in range(N):
            hit = np.sum((xyz[b] - xyz[b, q]) ** 2, axis=-1) <= radius * radius
            out[b, q] = u[b, hit].max(axis=0)
            for n in np.nonzero(hit)[0]:
                grad[b, n] += np.where(u[b, n] == out[b, q], g[b, q], 0.0)
    return out, grad


def _pallas_grad(xyz, u, out, g, radius):
    import jax
    import jax.numpy as jnp

    from deepvcp_tpu.ops.pallas import banded_masked_max_grad as pallas_grad

    jax.config.update("jax_platforms", "cpu")
    return np.asarray(pallas_grad(jnp.asarray(xyz), jnp.asarray(u), jnp.asarray(out),
                                  jnp.asarray(g), float(radius), tile=128, interpret=True))


@pytest.mark.parametrize("B,N,C,spread,radius", [
    (2, 200, 8, 5.0, 1.0),
    # dense cluster: the in-radius slab spans about half the cloud
    (1, 256, 8, 1.0, 0.8),
    # wide radius, N padded to an odd multiple of 128: the shape at which the
    # TPU kernel's clamped last chunk once counted queries twice
    (1, 300, 4, 6.0, 5.0),
])
def test_grad_reference_matches_pallas_and_oracle(B, N, C, spread, radius):
    """The plain K2 against the Pallas backward (as fused_sa.py calls it:
    tile=128, default chunk) and the numpy oracle, atol 1e-5 (sums in
    another order)."""
    rng = np.random.default_rng(7)
    xyz = _sorted_cloud(rng, B, N, spread)
    u = rng.standard_normal((B, N, C)).astype(np.float32)
    g = rng.standard_normal((B, N, C)).astype(np.float32)
    out, want = _grad_oracle(xyz, u, g, radius)
    got_out = banded_masked_max(torch.from_numpy(xyz), torch.from_numpy(u), radius)
    np.testing.assert_array_equal(got_out.numpy(), out)
    got = banded_masked_max_grad(*map(torch.from_numpy, (xyz, u, out, g)), radius).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, _pallas_grad(xyz, u, out, g, radius), atol=1e-5)


@pytest.mark.parametrize("levels", [2, 5])
def test_grad_reference_forced_ties(levels):
    """u drawn from a few integers, so most queries' maxima are tied among
    several points, and integer cotangents, so every sum is exact: the plain
    K2 equals the oracle and the Pallas backward exactly."""
    rng = np.random.default_rng(levels)
    xyz = _sorted_cloud(rng, 2, 300, 2.0)
    u = rng.integers(0, levels, (2, 300, 16)).astype(np.float32)
    g = rng.integers(-4, 5, (2, 300, 16)).astype(np.float32)
    out, want = _grad_oracle(xyz, u, g, 0.6)
    got = banded_masked_max_grad(*map(torch.from_numpy, (xyz, u, out, g)), 0.6).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _pallas_grad(xyz, u, out, g, 0.6))


def test_wrapper_takes_inputs_that_require_grad():
    """The raw wrappers take inputs that require grad (autograd.Function
    hands them over so) and, like the kernels, record no graph; the
    differentiable pool's backward is K2."""
    rng = np.random.default_rng(4)
    xyz = torch.from_numpy(_sorted_cloud(rng, 1, 90, 1.0))
    u = torch.from_numpy(rng.standard_normal((1, 90, 16)).astype(np.float32))
    out = banded_masked_max(xyz, u.clone().requires_grad_(True), 0.3)
    assert not out.requires_grad
    g = torch.randn(1, 90, 16, generator=torch.Generator().manual_seed(0))
    ut = u.clone().requires_grad_(True)
    (banded_max_pool(xyz, ut, 0.3) * g).sum().backward()
    assert torch.equal(ut.grad, banded_masked_max_grad_reference(xyz, u, out, g, 0.3))


def test_wrapper_checks_inputs():
    with pytest.raises(TypeError):
        banded_masked_max(torch.zeros(1, 8, 3, dtype=torch.float64), torch.zeros(1, 8, 4), 0.5)
    with pytest.raises(ValueError):
        banded_masked_max(torch.zeros(1, 8, 3), torch.zeros(1, 9, 4), 0.5)


def test_cpu_tensors_never_count_launches():
    before = banded_masked_max.launches, banded_masked_max_grad.launches
    z = torch.zeros(1, 8, 4)
    banded_masked_max(torch.zeros(1, 8, 3), z, 0.5)
    banded_masked_max_grad(torch.zeros(1, 8, 3), z, z, z, 0.5)
    assert (banded_masked_max.launches, banded_masked_max_grad.launches) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_reference_on_card(cuda):
    """Bit-identical to the plain version, at the slice's shapes (N=10 000,
    (C, r) = (16, 0.1), (32, 0.2), (64, 0.4) on a 25 m lidar-like cloud) and
    at small ragged ones."""
    rng = np.random.default_rng(0)
    xyz = lidar_like_cloud(rng, 10000, max_range=25.0).astype(np.float32)
    xyz = xyz[np.argsort(xyz[:, 0], kind="stable")][None]
    cases = [(xyz, C, r) for C, r in ((16, 0.1), (32, 0.2), (64, 0.4))]
    for B, N, C, r in ((2, 700, 64, 1.1), (1, 37, 16, 0.5), (3, 300, 32, 0.3)):
        cases.append((_sorted_cloud(rng, B, N, 2.0), C, r))
    for pts, C, r in cases:
        x = torch.from_numpy(pts).to(cuda)
        u = torch.randn(pts.shape[0], pts.shape[1], C, device=cuda)
        before = banded_masked_max.launches
        got = banded_masked_max(x, u, r)
        torch.cuda.synchronize()
        assert banded_masked_max.launches == before + 1
        want = banded_masked_max_reference(x, u, r)
        assert torch.equal(got, want), (pts.shape, C, r, (got - want).abs().max().item())
        with reference_path():
            assert torch.equal(banded_masked_max(x, u, r), want)
        assert banded_masked_max.launches == before + 1


@pytest.mark.gpu
def test_grad_kernel_matches_reference_on_card(cuda):
    """K2 against its plain version at the slice's shapes and small ragged
    ones: bit-identical with integer cotangents (every sum exact in f32) and
    with forced ties, within 1e-5 with Gaussian cotangents (another order of
    summation)."""
    rng = np.random.default_rng(1)
    xyz = lidar_like_cloud(rng, 10000, max_range=25.0).astype(np.float32)
    xyz = xyz[np.argsort(xyz[:, 0], kind="stable")][None]
    cases = [(xyz, C, r) for C, r in ((16, 0.1), (32, 0.2), (64, 0.4))]
    for B, N, C, r in ((2, 700, 64, 1.1), (1, 37, 16, 0.5), (3, 300, 32, 0.3)):
        cases.append((_sorted_cloud(rng, B, N, 2.0), C, r))
    gen = torch.Generator(device=cuda).manual_seed(0)
    for pts, C, r in cases:
        x = torch.from_numpy(pts).to(cuda)
        shape = (pts.shape[0], pts.shape[1], C)
        for u in (torch.randn(shape, device=cuda, generator=gen),
                  torch.randint(0, 3, shape, device=cuda, generator=gen).float()):
            out = banded_masked_max(x, u, r)
            g_int = torch.randint(-8, 9, shape, device=cuda, generator=gen).float()
            g_gauss = torch.randn(shape, device=cuda, generator=gen)
            before = banded_masked_max_grad.launches
            got = banded_masked_max_grad(x, u, out, g_int, r)
            torch.cuda.synchronize()
            assert banded_masked_max_grad.launches == before + 1
            want = banded_masked_max_grad_reference(x, u, out, g_int, r)
            assert torch.equal(got, want), (shape, r, (got - want).abs().max().item())
            err = (banded_masked_max_grad(x, u, out, g_gauss, r)
                   - banded_masked_max_grad_reference(x, u, out, g_gauss, r)).abs().max().item()
            assert err <= 1e-5, (shape, r, err)
            with reference_path():
                assert torch.equal(banded_masked_max_grad(x, u, out, g_int, r), want)
            assert banded_masked_max_grad.launches == before + 2
