"""Two-level candidate grouping in the port (deepvcp_tpu_torch/ops/two_level.py)
and its kernels K4/K5 (ops/kernels/onehot_gather.py) against the JAX
package: the plain gather and scatter-add against the Pallas kernel and its
VJP (interpret mode on the CPU), `two_level_rows` with f32 and bf16
selection, its recall against exact flat KNN, and the model forward, the
Registrar and one train step with `tgt_knn="two_level"`. On a CUDA card, the
Hopper kernels against their plain versions.

JAX is imported inside the tests that use it, so that the card-only tests of
this file run where jax is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_two_level.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepvcp_tpu_torch.ops import knn
from deepvcp_tpu_torch.ops.kernels import onehot_gather as og
from deepvcp_tpu_torch.ops.kernels import reference_path
from deepvcp_tpu_torch.ops.two_level import gather_table_rows, two_level_rows

torch.set_num_threads(2)

GAUSS_RTOL = 1e-6   # K5 with Gaussian cotangents against the one-hot matmul: summation order
VCP_ATOL = 1e-5     # model VCPs, f32 selection at both levels
POSE_ATOL = 1e-4    # Registrar R and t after two Kabsch solves per refinement
BF16_STEP = 2.0 ** -8

SHAPES = [((1, 2, 64, 35), 300), ((2, 3, 136, 7), 300), ((1, 1, 32, 4), 130)]
SHAPE_IDS = ["64x35-q300", "136x7-q300", "32x4-q130"]


def _table_idx(shape, Q, seed):
    rng = np.random.default_rng(seed)
    B, K, T, _ = shape
    return (rng.normal(size=shape).astype(np.float32), rng.integers(0, T, (B, K, Q)), rng)


def _cotangent(rng, shape, kind):
    if kind == "integer":
        return rng.integers(-8, 9, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


# -- K4 and K5, plain versions ------------------------------------------------

@pytest.mark.parametrize("shape,Q", SHAPES, ids=SHAPE_IDS)
def test_gather_reference_matches_jax(shape, Q):
    """Bit-exact against the Pallas kernel (interpret mode) and
    take_along_axis, at test_two_level.py's shapes."""
    import jax.numpy as jnp
    from deepvcp_tpu.ops.pallas.onehot_gather import onehot_gather as jonehot_gather

    table, idx, _ = _table_idx(shape, Q, 0)
    got = og.onehot_gather(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    jidx = jnp.asarray(idx.astype(np.int32))
    np.testing.assert_array_equal(got, np.asarray(jonehot_gather(jnp.asarray(table), jidx,
                                                                 block_q=128)))
    np.testing.assert_array_equal(got, np.asarray(jnp.take_along_axis(
        jnp.asarray(table), jidx[..., None], axis=-2)))


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("shape,Q", SHAPES, ids=SHAPE_IDS)
def test_scatter_add_reference_matches_jax_vjp(shape, Q, kind):
    """The VJP of the JAX onehot_gather_vjp (Pallas scatter-add kernel,
    interpret mode) for the same cotangent: bit-exact with integer
    cotangents (every sum exact), within GAUSS_RTOL of the largest entry
    with Gaussian ones (the one-hot matmul sums in another order)."""
    import jax
    import jax.numpy as jnp
    from deepvcp_tpu.ops.pallas.onehot_gather import onehot_gather_vjp as jvjp

    table, idx, rng = _table_idx(shape, Q, 1)
    B, K, T, D = shape
    g = _cotangent(rng, (B, K, Q, D), kind)
    jidx = jnp.asarray(idx.astype(np.int32))
    _, pullback = jax.vjp(lambda tb: jvjp(tb, jidx, 128), jnp.asarray(table))
    want = np.asarray(pullback(jnp.asarray(g))[0])
    got = og.onehot_scatter_add(torch.from_numpy(g), torch.from_numpy(idx), T).numpy()
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= GAUSS_RTOL * np.abs(want).max()


def test_scatter_add_reference_sums_in_ascending_q():
    """Every row's sum runs in ascending q from 0, the kernel's order: equal
    bit for bit to numpy's sequential np.add.at, with Gaussian cotangents,
    on a duplicate-heavy case (all queries into 8 rows) and with indices
    outside [0, T), which add to no row."""
    rng = np.random.default_rng(2)
    B, K, T, Q, D = 2, 3, 40, 500, 5
    for idx in (rng.integers(0, 8, (B, K, Q)), rng.integers(-3, T + 3, (B, K, Q))):
        g = rng.normal(size=(B, K, Q, D)).astype(np.float32)
        want = np.zeros((B, K, T, D), np.float32)
        for b in range(B):
            for k in range(K):
                ok = (idx[b, k] >= 0) & (idx[b, k] < T)
                np.add.at(want[b, k], idx[b, k][ok], g[b, k][ok])
        got = og.onehot_scatter_add(torch.from_numpy(g), torch.from_numpy(idx), T)
        np.testing.assert_array_equal(got.numpy(), want)


def test_gather_vjp_gradient_matches_jax():
    """The autograd.Function's gradient of sum(sin(gather)) against JAX's
    through onehot_gather_vjp (test_two_level.py's case): within
    GAUSS_RTOL."""
    import jax
    import jax.numpy as jnp
    from deepvcp_tpu.ops.pallas.onehot_gather import onehot_gather_vjp as jvjp

    table, idx, _ = _table_idx((1, 2, 40, 7), 130, 7)
    jidx = jnp.asarray(idx.astype(np.int32))
    want = np.asarray(jax.grad(lambda tb: jnp.sum(jnp.sin(jvjp(tb, jidx))))(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    torch.sin(og.onehot_gather_vjp(t, torch.from_numpy(idx))).sum().backward()
    assert t.grad is not None
    assert np.abs(t.grad.numpy() - want).max() <= GAUSS_RTOL * np.abs(want).max()


def test_wrappers_check_inputs():
    table, idx = torch.zeros(1, 2, 8, 3), torch.zeros(1, 2, 5, dtype=torch.int64)
    with pytest.raises(TypeError, match="int64"):
        og.onehot_gather(table, idx.int())
    with pytest.raises(TypeError, match="float32"):
        og.onehot_gather(table.double(), idx)
    with pytest.raises(ValueError, match="disagree"):
        og.onehot_gather(table, torch.zeros(1, 3, 5, dtype=torch.int64))
    with pytest.raises(ValueError, match="disagree on Q"):
        og.onehot_scatter_add(torch.zeros(1, 2, 4, 3), idx, 8)
    with pytest.raises(ValueError, match="T must be"):
        og.onehot_scatter_add(torch.zeros(1, 2, 5, 3), idx, 0)
    with pytest.raises(ValueError, match="no kernel"):
        og.onehot_gather(table.to("meta"), idx.to("meta"))


def test_cpu_tensors_never_count_launches():
    before = (og.onehot_gather.launches, og.onehot_scatter_add.launches)
    table, idx, _ = _table_idx((1, 2, 16, 4), 40, 3)
    t = torch.from_numpy(table).requires_grad_(True)
    og.onehot_gather_vjp(t, torch.from_numpy(idx)).sum().backward()
    with reference_path():
        og.onehot_gather(t.detach(), torch.from_numpy(idx))
    assert (og.onehot_gather.launches, og.onehot_scatter_add.launches) == before


# -- two_level_rows -----------------------------------------------------------

def _scene(seed, B=1, N=512, K=4, C=27, extent=20.0, reach=1.2):
    """Uniform target cloud, keypoint centres inside it, candidates in the
    +-reach cube of each; rows carry the point index in their last channel,
    so an output row names its point."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-extent / 2, extent / 2, (B, N, 3)).astype(np.float32)
    feat = rng.normal(size=(B, N, 4)).astype(np.float32)
    ids = np.broadcast_to(np.arange(N, dtype=np.float32)[None, :, None], (B, N, 1))
    rows = np.concatenate([tgt, feat, ids], axis=-1)
    centers = rng.uniform(-0.8 * extent / 2, 0.8 * extent / 2, (B, K, 3)).astype(np.float32)
    cand = (centers[:, :, None, :]
            + rng.uniform(-reach, reach, (B, K, C, 3))).astype(np.float32)
    return tgt, rows, centers, cand


def _both(scene, k, T, select_dtype, jax_use_pallas):
    import jax.numpy as jnp
    from deepvcp_tpu.ops.two_level import two_level_rows as jtwo_level_rows

    want = np.asarray(jtwo_level_rows(*map(jnp.asarray, scene), k, table_size=T,
                                      select_dtype=select_dtype, use_pallas=jax_use_pallas))
    got = two_level_rows(*map(torch.from_numpy, scene), k, table_size=T,
                         select_dtype=select_dtype).numpy()
    return got, want


@pytest.mark.parametrize("jax_use_pallas", [False, True])
def test_two_level_rows_matches_jax_f32(jax_use_pallas):
    """f32 selection at both levels: the same rows in the same order,
    tolerance 0. The port gathers through K4's plain version here; JAX
    through take_along_axis (False) or the Pallas kernel in interpret mode
    (True)."""
    got, want = _both(_scene(4), k=8, T=128, select_dtype=None, jax_use_pallas=jax_use_pallas)
    assert got.shape == (1, 4, 27, 8, 8)
    np.testing.assert_array_equal(got, want)


def test_gather_table_rows_refuses_non_f32_tables():
    """The row gather has one route, K4: a table K4 does not take raises
    rather than going to torch.gather."""
    table, l_idx = torch.zeros(1, 2, 8, 3, dtype=torch.float64), torch.zeros(
        1, 2, 3, 4, dtype=torch.int64)
    with pytest.raises(TypeError, match="float32"):
        gather_table_rows(table, l_idx)
    assert gather_table_rows(table.float(), l_idx).shape == (1, 2, 3, 4, 3)


def test_two_level_rows_bf16_selection_near_jax():
    """bf16 level-2 selection: the two packages' bf16 tiles differ in the
    last f32 bit before the cast and the two top-k break ties differently,
    so a candidate's neighbour set may differ, but only in points whose
    distance lies within two bf16 steps of the k-th distance (ROADMAP Queue
    3, as for the flat path); every neighbour clear of that band is in both
    sets, and the row values of each point are equal."""
    scene = _scene(5, N=1024, K=6)
    got, want = _both(scene, k=8, T=256, select_dtype="bfloat16", jax_use_pallas=True)
    tgt, _, _, cand = scene
    differ = 0
    for kk in range(cand.shape[1]):
        for c in range(cand.shape[2]):
            ids_t = got[0, kk, c, :, -1].astype(int)
            ids_j = want[0, kk, c, :, -1].astype(int)
            if set(ids_t) == set(ids_j):
                continue
            differ += 1
            for ids_a, ids_b in ((ids_t, ids_j), (ids_j, ids_t)):
                d2 = np.sum((tgt[0, ids_a].astype(np.float64) - cand[0, kk, c]) ** 2, axis=-1)
                clear = ids_a[d2 < d2.max() * (1 - 2 * BF16_STEP)]
                assert set(clear) <= set(ids_b), (kk, c)
    assert differ < 0.3 * cand.shape[1] * cand.shape[2]
    rows = scene[1][0]
    np.testing.assert_array_equal(got[0], rows[got[0, ..., -1].astype(int)])


def test_recall_at_bench_scale():
    """The port's copy of test_two_level.py's recall test: extent-20 uniform
    cloud, N=2048, K=8, C=27, k=8, T=256, bf16 level 2; the two-level
    neighbour sets hold at least 95% of the exact flat k-NN."""
    tgt, rows, centers, cand = _scene(3, N=2048, K=8, C=27, extent=20.0, reach=1.2)
    out = two_level_rows(*map(torch.from_numpy, (tgt, rows, centers, cand)), 8,
                         table_size=256, select_dtype="bfloat16")
    B, K, C = cand.shape[:3]
    _, idx = knn(torch.from_numpy(tgt), torch.from_numpy(cand).reshape(B, K * C, 3), 8)
    got = out[..., -1].long().reshape(B, K * C, 8)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got[0], idx[0]))
    recall = hits / (K * C * 8)
    assert recall >= 0.95, recall


# -- the model, the Registrar and the train step ------------------------------

def _two_level(cfg, **kw):
    return dataclasses.replace(cfg, tgt_knn="two_level", knn_select_dtype=None, **kw)


def test_model_forward_two_level_matches_jax():
    """DeepVCP(tgt_knn="two_level") at tiny() (N=128, static band covering
    the slab) with a 64-row table and f32 selection, from perturbed flax
    weights: keypoints equal, VCPs and candidate weights within VCP_ATOL."""
    import jax
    import jax.numpy as jnp
    from deepvcp_tpu import DeepVCPConfig
    from deepvcp_tpu.models import DeepVCP as JDeepVCP

    from deepvcp_tpu_torch.convert import flax_to_torch
    from deepvcp_tpu_torch.models import DeepVCP

    cfg = _two_level(DeepVCPConfig.tiny(use_normal=False), tgt_knn_table=64)
    assert cfg.use_two_level_tgt_knn
    rng = np.random.default_rng(11)
    src = rng.uniform(-1.5, 1.5, (2, 128, 3)).astype(np.float32)
    tgt = (src + rng.normal(0, 0.02, src.shape)).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    t = rng.uniform(-0.1, 0.1, (2, 3)).astype(np.float32)
    jm = JDeepVCP(cfg=cfg)
    v = jax.device_get(jax.jit(jm.init)(jax.random.key(0), src, tgt, R, t))
    v = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), v)
    kp_j, vcp_j, aux_j = jm.apply(v, *map(jnp.asarray, (src, tgt, R, t)))
    tm = DeepVCP(cfg)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    with torch.no_grad():
        kp_t, vcp_t, aux_t = tm.eval()(*map(torch.from_numpy, (src, tgt, R, t)))
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_j))
    np.testing.assert_allclose(aux_t["candidate_weights"].numpy(),
                               np.asarray(aux_j["candidate_weights"]), atol=VCP_ATOL)
    np.testing.assert_allclose(vcp_t.numpy(), np.asarray(vcp_j), atol=VCP_ATOL)


def test_registrar_two_level_kitti25_matches_jax():
    """The kitti25 checkpoint with tgt_knn="two_level" (table 64) and f32
    selection, through both packages' Registrar (refine_iters 2, saliency
    weights, guard) on a 128-point lidar-like pair of 1 m range (denser
    than 25 m, so saliencies do not tie): pose within POSE_ATOL."""
    import jax.numpy as jnp
    from deepvcp_tpu import pretrained as jpretrained
    from deepvcp_tpu.registration import Registrar as JRegistrar

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.data.synthetic import LidarLikeDataset, batch_iterator
    from deepvcp_tpu_torch.registration import Registrar

    N = 128
    cfg_j, variables = jpretrained.load("kitti25", num_points=N)
    cfg_t, variables_t = pretrained.load("kitti25", num_points=N)
    cfg_j, cfg_t = (_two_level(c, tgt_knn_table=64) for c in (cfg_j, cfg_t))
    ds = LidarLikeDataset(num_clouds=1, num_points=N, max_range=1.0, seed=110,
                          max_rotation_deg=5.0, max_translation=0.5)
    src, tgt, R_gt, t_gt = next(batch_iterator(ds, 1, shuffle=False))
    R0, t0 = R_gt.copy(), (t_gt + 0.05).astype(np.float32)
    kw = dict(refine_iters=2, use_saliency_weights=True, guard=True)
    out_j = JRegistrar(cfg_j, variables, **kw)(*map(jnp.asarray, (src, tgt, R0, t0)))
    out_t = Registrar(cfg_t, variables_t, "cpu", **kw)(*map(torch.from_numpy, (src, tgt, R0, t0)))
    np.testing.assert_array_equal(out_t.keypoints.numpy(), np.asarray(out_j.keypoints))
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.vcps.numpy(), np.asarray(out_j.vcps), atol=POSE_ATOL)


def test_train_step_two_level_matches_jax(monkeypatch):
    """One train step of tiny() with tgt_knn="two_level" (table 64, f32
    selection) under the fine-tune recipe, against JAX build_train_step with
    its SA pooling routed through the Pallas kernels in interpret mode (the
    exact slab; tests/test_torch_train.py says why). The JAX model gathers
    with take_along_axis on the CPU, whose gradient is K5's function; the
    port goes through onehot_gather_vjp (K4/K5's plain versions here).
    Tolerances of test_torch_train.py: loss and metrics 1e-5 relative, each
    gradient tensor 2e-3 of its max |g| (floored at 1% of the global norm),
    BatchNorm statistics 1e-6."""
    import jax
    import jax.numpy as jnp
    import optax
    from deepvcp_tpu import DeepVCPConfig
    from deepvcp_tpu.config import TrainConfig
    from deepvcp_tpu.loss import deepvcp_loss as jdeepvcp_loss
    from deepvcp_tpu.models import DeepVCP as JDeepVCP
    from deepvcp_tpu.models import fused_sa as jfused_sa
    from deepvcp_tpu.train import trainer as jtrainer

    from deepvcp_tpu_torch.convert import flax_to_torch
    from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator
    from deepvcp_tpu_torch.models import DeepVCP
    from deepvcp_tpu_torch.train import TrainState, build_train_step
    from deepvcp_tpu_torch.train.optim import learning_rate_schedule, make_adam

    tcfg = TrainConfig(vcp_loss_weight=1.0, rot_loss_weight=3.0, lr_schedule="cosine",
                       warmup_steps=100, total_steps=21760, use_saliency_weights=True,
                       init_translation="gt", init_rot_jitter_deg=6.0, init_trans_jitter=0.5)
    cfg = _two_level(DeepVCPConfig.tiny(use_normal=True), tgt_knn_table=64)
    data = SyntheticDataset(num_clouds=2, num_points=128, use_normal=True, extent=1.5,
                            max_translation=0.3, max_rotation_deg=10.0, noise_std=0.01, seed=40)
    src, tgt, R, t = next(batch_iterator(data, 2, epoch=0, seed=40))
    jm = JDeepVCP(cfg=cfg)
    jstate, tx = jtrainer.create_train_state(jm, tcfg, (src, tgt, R, t))
    monkeypatch.setattr(jfused_sa, "_use_band_kernel", lambda use_kernel: use_kernel)
    rng = np.random.default_rng(6)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    v = {col: jax.tree_util.tree_map_with_path(perturb, tree) for col, tree in
         jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats}).items()}
    jstate = jtrainer.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                                 opt_state=tx.init(v["params"]), step=jnp.int32(0))
    R_init, t_init = jtrainer._train_init_pose(tcfg, jnp.int32(0), jnp.asarray(R), jnp.asarray(t))

    def loss_fn(params):
        (kp, vcp, aux), _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                                     src, tgt, R_init, t_init, train=True,
                                     mutable=["batch_stats"])
        return jdeepvcp_loss(kp, vcp, R, t, alpha=tcfg.alpha, inlier_ratio=tcfg.inlier_ratio,
                             weights=aux["keypoint_saliency"], vcp_weight=tcfg.vcp_loss_weight,
                             rot_weight=tcfg.rot_loss_weight).loss

    clip = optax.clip_by_global_norm(tcfg.grad_clip_norm)
    want_g = flax_to_torch({"params": jax.jit(
        lambda p: clip.update(jax.grad(loss_fn)(p), optax.EmptyState())[0])(v["params"])})
    jstate, jmetrics = jax.jit(jtrainer.build_train_step(jm, tx, tcfg))(jstate, src, tgt, R, t)

    model = DeepVCP(cfg)
    model.load_state_dict(flax_to_torch(v), strict=True)
    schedule = learning_rate_schedule(tcfg)
    step_fn = build_train_step(model, schedule, tcfg)
    _, metrics = step_fn(TrainState(optimizer=make_adam(model.parameters(), schedule(0)), step=0),
                         *map(torch.from_numpy, (src, tgt, R, t)),
                         torch.tensor(np.asarray(R_init)), torch.tensor(np.asarray(t_init)))
    for key in ("loss", "l1", "mean_residual", "vcp_l1", "rte"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=2e-3)
    floor = 0.01 * float(jmetrics["grad_norm"])
    for name, p in model.named_parameters():
        want = want_g[name].numpy()
        err = np.abs(p.grad.numpy() - want).max() / max(np.abs(want).max(), floor)
        assert err < 2e-3, (name, err)
    want_state = flax_to_torch({"params": jstate.params, "batch_stats": jstate.batch_stats})
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want_state[name].numpy(), atol=1e-6,
                                       err_msg=name)


# -- K4 and K5 on the card ----------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_cases(device):
    """The path's shapes (64 keypoints, T=512, Q=216*32, D=35), every query
    into 8 rows, and a Q that is not a multiple of K4's 256-query block."""
    gen = torch.Generator(device=device).manual_seed(0)
    cases = []
    for name, (B, K, T, Q, D), hi in (("path", (1, 64, 512, 6912, 35), 512),
                                      ("8 rows", (1, 64, 512, 6912, 35), 8),
                                      ("ragged Q", (2, 3, 136, 1000, 7), 136)):
        table = torch.randn(B, K, T, D, device=device, generator=gen)
        idx = torch.randint(0, hi, (B, K, Q), device=device, generator=gen)
        cases.append((name, table, idx))
    return cases


@pytest.mark.gpu
def test_gather_kernel_matches_reference_on_card(cuda):
    for name, table, idx in _card_cases(cuda):
        before = og.onehot_gather.launches
        got = og.onehot_gather(table, idx)
        torch.cuda.synchronize()
        assert og.onehot_gather.launches == before + 1
        assert torch.equal(got, og.onehot_gather_reference(table, idx)), name
        with reference_path():
            og.onehot_gather(table, idx)
        assert og.onehot_gather.launches == before + 1


@pytest.mark.gpu
def test_scatter_add_kernel_matches_reference_on_card(cuda):
    """Integer cotangents: equal. Gaussian ones: equal too, since both sum
    each row in ascending q (the gate elsewhere is 1e-5); and the kernel
    agrees with itself run to run."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    for name, table, idx in _card_cases(cuda):
        T = table.shape[2]
        shape = (*idx.shape, table.shape[-1])
        for g in (torch.randint(-8, 9, shape, device=cuda, generator=gen).float(),
                  torch.randn(shape, device=cuda, generator=gen)):
            before = og.onehot_scatter_add.launches
            got = og.onehot_scatter_add(g, idx, T)
            again = og.onehot_scatter_add(g, idx, T)
            torch.cuda.synchronize()
            assert og.onehot_scatter_add.launches == before + 2
            assert torch.equal(got, again), name
            assert torch.equal(got, og.onehot_scatter_add_reference(g, idx, T)), name


@pytest.mark.gpu
def test_kernels_on_indices_outside_the_table_on_card(cuda):
    """An index outside [0, T) gives a NaN row in K4 and adds to no row in
    K5 (equal to the plain K5, which ignores it too)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    table = torch.randn(2, 3, 40, 5, device=cuda, generator=gen)
    idx = torch.randint(-3, 43, (2, 3, 700), device=cuda, generator=gen)
    ok = (idx >= 0) & (idx < 40)
    got = og.onehot_gather(table, idx)
    want = og.onehot_gather_reference(table, idx.clamp(0, 39))
    assert torch.isnan(got[~ok]).all()
    assert torch.equal(got[ok], want[ok])
    g = torch.randn(*idx.shape, 5, device=cuda, generator=gen)
    assert torch.equal(og.onehot_scatter_add(g, idx, 40),
                       og.onehot_scatter_add_reference(g, idx, 40))


@pytest.mark.gpu
def test_gather_vjp_runs_both_kernels_on_card(cuda):
    table, idx = _card_cases(cuda)[0][1:]
    t = table.clone().requires_grad_(True)
    before = (og.onehot_gather.launches, og.onehot_scatter_add.launches)
    torch.sin(og.onehot_gather_vjp(t, idx)).sum().backward()
    torch.cuda.synchronize()
    assert (og.onehot_gather.launches, og.onehot_scatter_add.launches) == \
        (before[0] + 1, before[1] + 1)
    want = og.onehot_scatter_add_reference(torch.cos(og.onehot_gather_reference(table, idx)),
                                           idx, table.shape[2])
    assert torch.equal(t.grad, want)
