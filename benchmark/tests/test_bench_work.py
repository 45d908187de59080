"""The work counts against hand counts."""

import numpy as np
import pytest
import torch

from benchmark import work


def test_in_radius_pairs_by_hand():
    # points on a line at x = 0, 0.1, 0.25, 1.0: within 0.15 the ordered pairs
    # are the 4 self pairs and (0, 0.1), (0.1, 0.25) both ways
    x = torch.tensor([[[0.0, 0, 0], [0.1, 0, 0], [0.25, 0, 0], [1.0, 0, 0]]])
    counts = work.in_radius_pairs(x, [0.15, 0.3, 2.0])
    assert counts.tolist() == [[8, 10, 16]]


def test_in_radius_pairs_uses_f32_radius_squared():
    # 0.1 ** 2 in f32 is 0.010000000707805157, so a point at d^2 = 0.01 is in
    x = torch.tensor([[[0.0, 0, 0], [0.1, 0, 0]]])
    d2 = float((x[0, 1, 0] - x[0, 0, 0]) ** 2)
    assert (d2 <= float(np.float32(0.01))) == (work.in_radius_pairs(x, [0.1])[0, 0] == 4)


def test_bound_ms():
    ms, by = work.bound_ms(3.35e9, 1.0)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = work.bound_ms(1.0, 67e9)
    assert ms == pytest.approx(1.0) and by == "operations"


def test_counts_by_hand():
    assert work.mlp_ops(10, (4, 2), 3) == 2 * 10 * 3 * 4 + 2 * 10 * 4 * 2
    assert work.tile_ops(5, 7) == 5 * 7 * 10 and work.tile_ops(5, 7, select=False) == 5 * 7 * 9
    model = {"sa_layers": [{"mlp": [2, 3]}, {"mlp": [4]}], "feat_dim": 5}
    # stage 1: projections 2*N*3*2, 11 pairs x 2 channels, tail 2*N*2*3;
    # stage 2: projections 2*N*(3+3)*4, 13 pairs x 4; the final 2*N*4*5
    N = 6
    assert work.fe_ops(model, N, [11, 13]) == (2 * N * 3 * 2 + 22 + 2 * N * 2 * 3
                                               + 2 * N * 6 * 4 + 52 + 2 * N * 4 * 5)
    bound = work.band_max_bound_ms(model, N, [11, 13])
    assert bound == pytest.approx(work.bound_ms(4 * N * 7, 11 * 11)[0]
                                  + work.bound_ms(4 * N * 11, 13 * 13)[0])


def test_candidate_stage_bound():
    model = {"num_points": 100, "num_keypoints": 2, "num_neighbors": 3, "feat_dim": 4,
             "search_radius": 1.0, "voxel_len": 1.0}        # a 3^3 grid
    KC = 2 * 27
    ops = 2 * KC * 100 * 10
    nbytes = 4 * (2 * 100 * 3 + 2 * KC * 3 + 2 * 100 * 7 + 2 * KC * 3 * 7)
    assert work.candidates_bound_ms(model, 2) == pytest.approx(work.bound_ms(nbytes, ops)[0])


def test_pair_flops_two_level_is_cheaper():
    from benchmark import manifest

    bench = manifest.load()
    flat = manifest.config(bench, "kitti25-rot")
    two = manifest.config(bench, "kitti25-two-level")
    pairs = [12000, 25000, 98000]
    f_flat, f_two = work.pair_flops(flat, pairs, pairs), work.pair_flops(two, pairs, pairs)
    # the flat tile: 64 * 216 queries x 10 000 points at 10 operations, three refinements
    assert f_flat - 3 * work.tile_ops(64 * 216, 10000) == pytest.approx(
        f_two / 2 * 3 - 3 * (work.tile_ops(64, 10000) + work.tile_ops(64 * 216, 512)), rel=0.05)
    assert f_two < f_flat
