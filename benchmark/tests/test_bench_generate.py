"""The traffic generator's frozen copy equals the port's LidarLikeDataset
and make_pair bit for bit."""

import numpy as np
import pytest

from benchmark import generate


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 5])
def test_pool_equals_the_ports_dataset(seed):
    from deepvcp_tpu_torch.data.synthetic import LidarLikeDataset

    traffic = {"pool": 3, "max_range": 25.0, "max_rotation_deg": 5.0, "max_translation": 0.5}
    pool = generate.make_pool(seed, traffic, 200)
    ds = LidarLikeDataset(num_clouds=3, num_points=200, max_range=25.0, seed=seed,
                          max_rotation_deg=5.0, max_translation=0.5)
    for i in range(3):
        pair = ds.sample(i, np.random.default_rng((seed, 0, i)))
        for mine, theirs in zip(pool, (pair.src, pair.tgt, pair.R, pair.t)):
            assert mine[i].dtype == theirs.dtype
            np.testing.assert_array_equal(mine[i], theirs)


def test_every_seed_gives_the_same_sizes():
    traffic = {"pool": 4, "max_range": 25.0, "max_rotation_deg": 5.0, "max_translation": 0.5}
    a, b = generate.make_pool(1, traffic, 100), generate.make_pool(2, traffic, 100)
    assert [x.shape for x in a] == [x.shape for x in b]
    assert not np.array_equal(a.src, b.src)
