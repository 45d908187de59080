"""Kernel K3, farthest-point sampling (deepvcp_tpu_torch/ops/kernels/fps.py,
ops/sampling.py): the plain PyTorch version against the JAX package's jnp
loop and its Pallas TPU kernel in interpret mode, and, on a CUDA card, the
Hopper kernel against the plain version. Indices must be equal: FPS has no
tolerance, a near-tie taken the other way changes every later pick.

JAX is imported inside the tests that use it, so that the card-only tests of
this file run where jax is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sampling.py
"""

import numpy as np
import pytest
import torch

from deepvcp_tpu_torch.ops import farthest_point_sample
from deepvcp_tpu_torch.ops.kernels import fps, reference_path
from deepvcp_tpu_torch.ops.kernels.fps import farthest_point_sample_reference

torch.set_num_threads(2)


def _lattice_with_duplicates(rng, n_side=5, copies=2):
    """A 3-D lattice (every distance repeats many times), each point present
    `copies` times, shuffled: FPS meets exact ties at every step."""
    g = np.arange(n_side, dtype=np.float32) * 0.25
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([pts] * copies)
    return pts[rng.permutation(len(pts))][None]


def _clouds():
    rng = np.random.default_rng(0)
    cases = []
    for B, N, npoint, start in ((1, 7, 7, 0), (3, 7, 5, 3), (1, 300, 64, 0),
                                (3, 300, 32, 17), (1, 2048, 96, 0), (3, 2048, 40, 1500)):
        cases.append((f"uniform-B{B}-N{N}-k{npoint}-s{start}",
                      rng.uniform(-2, 2, (B, N, 3)).astype(np.float32), npoint, start))
    lat = _lattice_with_duplicates(rng)   # 250 points, 125 distinct
    cases.append(("lattice-dup", lat, 140, 0))        # past the distinct points
    cases.append(("lattice-dup-s9", np.concatenate([lat, lat[:, ::-1]]), 60, 9))
    cases.append(("one-point", np.ones((2, 12, 3), np.float32), 5, 4))
    return cases


CLOUDS = _clouds()


@pytest.mark.parametrize("name,xyz,npoint,start", CLOUDS, ids=[c[0] for c in CLOUDS])
def test_reference_matches_jax_loop(name, xyz, npoint, start):
    from deepvcp_tpu import ops as jops

    want = np.asarray(jops.farthest_point_sample(xyz, npoint, start, use_pallas=False))
    got = farthest_point_sample(torch.from_numpy(xyz), npoint, start)
    assert got.dtype == torch.int64 and got.shape == (xyz.shape[0], npoint)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,xyz,npoint,start", CLOUDS, ids=[c[0] for c in CLOUDS])
def test_reference_matches_pallas_kernel(name, xyz, npoint, start):
    """The TPU kernel itself, through the Pallas interpreter (as
    tests/test_pallas.py runs it)."""
    from deepvcp_tpu.ops.pallas import farthest_point_sample_pallas

    want = np.asarray(farthest_point_sample_pallas(xyz, npoint, start, interpret=True))
    got = farthest_point_sample_reference(torch.from_numpy(xyz), npoint, start)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reference_matches_jax_loop_past_the_old_limit():
    """The plain FPS at N = 20 000 (past the 16 384 points the kernel once
    refused) against the JAX package's jnp loop, as the JAX tests run it
    on the CPU."""
    from deepvcp_tpu import ops as jops

    xyz = np.random.default_rng(5).uniform(-3, 3, (1, 20000, 3)).astype(np.float32)
    want = np.asarray(jops.farthest_point_sample(xyz, 64, 0, use_pallas=False))
    np.testing.assert_array_equal(farthest_point_sample(torch.from_numpy(xyz), 64).numpy(), want)


@pytest.mark.parametrize("N", [1, 7, 256, 1024, 1025, 5000, 10000, 16385, 40000, 65536, 65537,
                               200000])
def test_cluster_plan_covers_the_cloud(N):
    """The kernel's plan: a power-of-two cluster of at most 16 blocks, each
    block taking ceil(N / cluster) points, so the shares cover [0, N) once;
    salient_fps's 256 points on one block; a block's share in registers
    (at most 16 points a thread) unless the kernel streams it."""
    cs = fps.cluster_size(N)
    assert cs in (1, 2, 4, 8, 16)
    share = -(-N // cs)
    owned = [min(max(N - r * share, 0), share) for r in range(cs)]
    assert sum(owned) == N and all(o > 0 for o in owned[:-(-N // share)])
    assert fps.streams(N, cs) == (share > fps.REG_POINTS)
    if cs < fps.MAX_CLUSTER:
        assert share <= fps.SHARE_PER_THREAD * fps.THREADS
    assert fps.cluster_size(256) == 1


def test_ties_take_the_lowest_index():
    """Duplicates: the first pick's twin has distance 0 and is never taken
    while any distance is positive; once every distance is 0, index 0."""
    xyz = torch.tensor([[[0., 0, 0], [1, 0, 0], [1, 0, 0], [0, 0, 0], [-1, 0, 0]]])
    got = farthest_point_sample(xyz, 5, start_idx=0)
    # from 0: 1 and 4 tie at distance 1 (the lower, 1, wins); then 4; then
    # every distance is 0 and index 0 repeats
    assert got.tolist() == [[0, 1, 4, 0, 0]]


def test_sampling_casts_and_copies():
    """ops.farthest_point_sample takes float64 and strided clouds (the
    kernel takes contiguous float32 only)."""
    rng = np.random.default_rng(3)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 64)).astype(np.float64)).transpose(1, 2)
    want = farthest_point_sample_reference(xyz.float().contiguous(), 16, 2)
    assert torch.equal(farthest_point_sample(xyz, 16, 2), want)


def test_wrapper_checks_inputs():
    x = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        fps.farthest_point_sample(torch.zeros(8, 3), 2)
    with pytest.raises(TypeError, match="float32"):
        fps.farthest_point_sample(x.double(), 2)
    with pytest.raises(ValueError, match="start_idx"):
        fps.farthest_point_sample(x, 2, start_idx=8)
    with pytest.raises(ValueError, match="npoint"):
        fps.farthest_point_sample(x, 0)
    with pytest.raises(ValueError, match="no kernel"):
        fps.farthest_point_sample(torch.zeros(1, 8, 3, device="meta"), 2)


def test_cpu_tensors_never_count_launches():
    before = fps.farthest_point_sample.launches
    farthest_point_sample(torch.rand(2, 50, 3), 10)
    with reference_path():
        farthest_point_sample(torch.rand(2, 50, 3), 10)
    assert fps.farthest_point_sample.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_reference_on_card(cuda):
    """Identical indices at the path's shapes ([2, 10 000, 3] at npoint 4096
    and 128, [2, 256, 3] at 64), at every points-per-thread variant of the
    kernel, and on tie clouds."""
    rng = np.random.default_rng(0)
    cases = [(rng.uniform(-1, 1, (2, 10000, 3)), 4096, 0),
             (rng.uniform(-1, 1, (2, 10000, 3)), 128, 0),
             (rng.uniform(-1, 1, (2, 256, 3)), 64, 0)]
    for N in (1, 1000, 1025, 3000, 7000, 16384):
        cases.append((rng.standard_normal((3, N, 3)), min(N, 200), N // 2))
    cases += [(c[1], c[2], c[3]) for c in CLOUDS if c[0].startswith(("lattice", "one"))]
    for xyz, npoint, start in cases:
        x = torch.from_numpy(np.asarray(xyz, np.float32)).to(cuda)
        before = fps.farthest_point_sample.launches
        got = fps.farthest_point_sample(x, npoint, start)
        torch.cuda.synchronize()
        assert fps.farthest_point_sample.launches == before + 1
        want = farthest_point_sample_reference(x, npoint, start)
        assert torch.equal(got, want), (x.shape, npoint, start)
        with reference_path():
            assert torch.equal(fps.farthest_point_sample(x, npoint, start), want)
        assert fps.farthest_point_sample.launches == before + 1


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
    """Any N runs on the kernel: past the 16 384 points it once refused the
    indices are bit-identical to the plain version's, also where a block's
    share streams through global scratch; only a strided cloud is refused."""
    rng = np.random.default_rng(6)
    for N, npoint in ((16385, 300), (70000, 64)):
        x = torch.from_numpy(rng.standard_normal((2, N, 3)).astype(np.float32)).to(cuda)
        before = fps.farthest_point_sample.launches
        got = fps.farthest_point_sample(x, npoint, 7)
        torch.cuda.synchronize()
        assert fps.farthest_point_sample.launches == before + 1
        assert torch.equal(got, farthest_point_sample_reference(x, npoint, 7)), N
    with pytest.raises(ValueError, match="contiguous"):
        fps.farthest_point_sample(torch.zeros(1, 3, 64, device=cuda).transpose(1, 2), 4)
