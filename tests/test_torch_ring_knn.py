"""The port's ring KNN (deepvcp_tpu_torch.ops.distributed.ring_knn) and the
model's ring candidate KNN (DeepVCP(knn_mesh=...)) over 4 gloo ranks on the
CPU, against the JAX package's ring_knn and DeepVCP(knn_mesh=...) on its CPU
devices, on the same inputs.

ring_knn: distances within 1e-5, indices equal except at exact distance
ties (checked through each index's float64 distance). The model's ring
forward: keypoints within 1e-5, VCPs within 1e-4. A shape that fails the
ring's gate takes the single-device engines. Every ring case of the file
runs in one run of 4 ranks (tests/torch_ranks.py).

The forwards select every neighbour set in f32 (knn_select_dtype=None): the
tiny config's bf16 source-neighbourhood tile breaks a tie at the k-th
distance differently in JAX and the port on the B = 2 batch, which moves one
keypoint's VCP by 1.5e-4 whatever the candidate KNN (the repo's cascade
parity tests select in f32 for the same reason).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu import DeepVCPConfig as JConfig
from deepvcp_tpu.models import DeepVCP as JDeepVCP
from deepvcp_tpu.ops.distributed import ring_knn as jring_knn
from deepvcp_tpu.parallel import make_mesh as jmake_mesh
from deepvcp_tpu_torch.config import DeepVCPConfig
from deepvcp_tpu_torch.convert import flax_to_torch
from deepvcp_tpu_torch.models import DeepVCP
from deepvcp_tpu_torch.ops import knn
from deepvcp_tpu_torch.parallel.launch import run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
DIST_ATOL, TIE_ATOL = 1e-5, 1e-6
KP_ATOL, VCP_ATOL = 1e-5, 1e-4


def _clouds(seed, B, N, M, scale):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (B, N, 3)).astype(np.float32),
            rng.uniform(-scale, scale, (B, M, 3)).astype(np.float32))


REF, QUERY = _clouds(0, 2, 256, 64, 5.0)
BREF, BQUERY = _clouds(2, 4, 128, 64, 5.0)
SELF = _clouds(1, 1, 128, 1, 3.0)[0]


def _model_batch(seed, B, N):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    tgt = rng.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    return src, tgt, R, np.zeros((B, 3), np.float32)


BATCHES = {"B2 N128": _model_batch(3, 2, 128), "B1 N126": _model_batch(4, 1, 126)}


@pytest.fixture(scope="module")
def variables():
    cfg = _jcfg(128)
    src, tgt, R, t = (jnp.asarray(a) for a in BATCHES["B2 N128"])
    return jax.device_get(JDeepVCP(cfg=cfg).init(jax.random.key(0), src, tgt, R, t))


def _cfg(N):
    return dataclasses.replace(DeepVCPConfig.tiny(num_points=N, use_normal=False),
                               knn_select_dtype=None)


def _jcfg(N):
    return dataclasses.replace(JConfig.tiny(num_points=N, use_normal=False),
                               knn_select_dtype=None)


@pytest.fixture(scope="module")
def ranks(variables):
    """Every ring case over 4 gloo ranks: {case: [each rank's result]}."""
    state = {k: v.numpy() for k, v in flax_to_torch(variables).items()}
    cases = {
        "P2": ("ring_knn", dict(shape=(2, 2), ref=REF, query=QUERY, k=8)),
        "P4": ("ring_knn", dict(shape=(1, 4), ref=REF, query=QUERY, k=8)),
        "self": ("ring_knn", dict(shape=(1, 4), ref=SELF, query=SELF, k=4)),
        "replicated": ("ring_knn", dict(shape=(2, 2), ref=BREF, query=BQUERY, k=8)),
        "batch_axis": ("ring_knn", dict(shape=(2, 2), ref=BREF, query=BQUERY, k=8,
                                        batch_axis="data")),
        "forward (2, 2)": ("ring_forward", dict(shape=(2, 2), cfg=_cfg(128), state=state,
                                                batch=BATCHES["B2 N128"])),
        "forward (1, 4)": ("ring_forward", dict(shape=(1, 4), cfg=_cfg(128), state=state,
                                                batch=BATCHES["B2 N128"])),
        "B1 ring (2, 2)": ("ring_forward", dict(shape=(2, 2), cfg=_cfg(126), state=state,
                                                batch=BATCHES["B1 N126"])),
        "B1 gate fails (1, 4)": ("ring_forward", dict(shape=(1, 4), cfg=_cfg(126),
                                                      state=state, batch=BATCHES["B1 N126"])),
    }
    per_rank = run_ranks("torch_ranks:run_cases", 4, kwargs={"cases": cases}, device="cpu",
                         sys_path=[HERE], timeout_s=150)
    return {name: [r[name] for r in per_rank] for name in cases}


def _assert_same_knn(got, want, ref, query):
    """Distances within DIST_ATOL; an index that differs must be an exact
    tie: its float64 distance equal to the other's within TIE_ATOL."""
    (d_got, i_got), (d_want, i_want) = got, want
    np.testing.assert_allclose(d_got, d_want, atol=DIST_ATOL)
    d = np.sqrt(np.sum((query.astype(np.float64)[:, :, None] - ref[:, None]) ** 2, -1))
    by_got = np.take_along_axis(d, i_got.astype(np.int64), -1)
    by_want = np.take_along_axis(d, np.asarray(i_want, np.int64), -1)
    differ = i_got != np.asarray(i_want)
    np.testing.assert_allclose(by_got[differ], by_want[differ], atol=TIE_ATOL)


@pytest.mark.parametrize("case,shape", [("P2", (2, 2)), ("P4", (1, 4))])
def test_ring_knn_matches_jax(ranks, case, shape):
    """[2, 256, 3] references, [2, 64, 3] queries, k = 8, over 2 and 4 point
    ranks, against JAX's ring over as many devices; every rank holds the
    whole result."""
    P = shape[1]
    want = jring_knn(jmake_mesh(devices=jax.devices()[:P], data=1, point=P),
                     jnp.asarray(REF), jnp.asarray(QUERY), k=8)
    want = tuple(np.asarray(a) for a in want)
    for got in ranks[case]:
        _assert_same_knn(got, want, REF, QUERY)
        np.testing.assert_array_equal(got[1], ranks[case][0][1])


def test_ring_knn_self_query_finds_self(ranks):
    """Every point's nearest is itself, at the distance the port's knn
    gives (the |a|^2 + |b|^2 - 2ab expansion leaves up to ~1e-3 of
    cancellation at coordinates of 3)."""
    d_knn, _ = knn(torch.from_numpy(SELF), torch.from_numpy(SELF), 4)
    for d, i in ranks["self"]:
        np.testing.assert_array_equal(i[0, :, 0], np.arange(128))
        np.testing.assert_allclose(d[0, :, 0], d_knn[0, :, 0].numpy(), atol=DIST_ATOL)
        assert d[0, :, 0].max() < 2e-3


def test_ring_knn_batch_axis_equals_replicated(ranks):
    """batch_axis="data": each data rank computes its rows and the rows are
    all-gathered, the replicated form's result."""
    for (d_rep, i_rep), (d_dp, i_dp) in zip(ranks["replicated"], ranks["batch_axis"]):
        np.testing.assert_allclose(d_dp, d_rep, atol=DIST_ATOL)
        np.testing.assert_array_equal(i_dp, i_rep)


def _jax_forward(variables, batch, point):
    N = batch[0].shape[1]
    mesh = jmake_mesh(devices=jax.devices()[:point], data=1, point=point)
    model = JDeepVCP(cfg=_jcfg(N), knn_mesh=mesh)
    kp, vcp, _ = model.apply(variables, *(jnp.asarray(a) for a in batch), train=False)
    return np.asarray(kp), np.asarray(vcp)


@pytest.mark.parametrize("case", ["forward (2, 2)", "forward (1, 4)", "B1 ring (2, 2)"])
def test_model_ring_forward_matches_jax(variables, ranks, case):
    """The model's ring candidate KNN at tiny N = 128, B = 2 (and N = 126 at
    B = 1, whose 126 points divide 2 ranks) against JAX's
    DeepVCP(knn_mesh=...) on a point axis of 2 devices, same weights."""
    batch = BATCHES["B1 N126" if case.startswith("B1") else "B2 N128"]
    kp_want, vcp_want = _jax_forward(variables, batch, point=2)
    for kp, vcp, ring in ranks[case]:
        assert ring
        np.testing.assert_allclose(kp, kp_want, atol=KP_ATOL)
        np.testing.assert_allclose(vcp, vcp_want, atol=VCP_ATOL)


def test_model_shape_off_the_gate_takes_single_device_engine(variables, ranks):
    """N = 126 over 4 point ranks fails the gate (126 % 4): the forward is
    the single-device model's, bit for bit, at B = 1."""
    model = DeepVCP(_cfg(126))
    model.load_state_dict(flax_to_torch(variables))
    model.eval()
    with torch.no_grad():
        kp, vcp, _ = model(*(torch.from_numpy(a) for a in BATCHES["B1 N126"]))
    for kp_r, vcp_r, ring in ranks["B1 gate fails (1, 4)"]:
        assert not ring
        np.testing.assert_array_equal(kp_r, kp.numpy())
        np.testing.assert_array_equal(vcp_r, vcp.numpy())
