"""Kernel K1 (deepvcp_tpu_torch/ops/kernels/band_max.py): the plain PyTorch
version against the Pallas TPU kernel in interpret mode (exact equality),
and, on a CUDA card, the Hopper kernel against the plain version.

JAX is imported inside the tests that use it, so that the card-only tests of
this file run where jax is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_band_max.py
"""

import numpy as np
import pytest
import torch

from deepvcp_tpu_torch.data.synthetic import lidar_like_cloud
from deepvcp_tpu_torch.ops.kernels import band_max
from deepvcp_tpu_torch.ops.kernels.band_max import (
    banded_masked_max,
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


def test_wrapper_refuses_requires_grad():
    xyz = torch.zeros(1, 8, 3)
    u = torch.zeros(1, 8, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K2"):
        banded_masked_max(xyz, u, 0.5)


def test_wrapper_checks_inputs():
    with pytest.raises(TypeError):
        banded_masked_max(torch.zeros(1, 8, 3, dtype=torch.float64), torch.zeros(1, 8, 4), 0.5)
    with pytest.raises(ValueError):
        banded_masked_max(torch.zeros(1, 8, 3), torch.zeros(1, 9, 4), 0.5)


def test_cpu_tensors_never_count_launches():
    before = banded_masked_max.launches
    banded_masked_max(torch.zeros(1, 8, 3), torch.zeros(1, 8, 4), 0.5)
    assert banded_masked_max.launches == before


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
        with band_max.reference_path():
            assert torch.equal(banded_masked_max(x, u, r), want)
        assert banded_masked_max.launches == before + 1
