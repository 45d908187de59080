"""The Kabsch solve's SVD (deepvcp_tpu_torch/ops/svd.py): where `svd` takes
cuSOLVER's batched Jacobi SVD without a host sync and where it keeps
torch.linalg.svd, on the CPU; on a CUDA card, gesvdj_batched against
torch.linalg.svd bit for bit (U, S, Vh and their strides), then kabsch's R
and t and svd_refine's R, t and inlier_idx against the same calls under
reference_path(), with no sync under torch.cuda.set_sync_debug_mode("error").

No JAX here, so that the card-only tests run where jax is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kabsch_svd.py
"""

import numpy as np
import pytest
import torch

from deepvcp_tpu_torch.loss import deepvcp_loss, svd_refine
from deepvcp_tpu_torch.ops import apply_rigid, kabsch
from deepvcp_tpu_torch.ops import svd as svd_mod
from deepvcp_tpu_torch.ops.kernels import reference_path

torch.set_num_threads(2)


def _pair(seed, batch, K, dtype=torch.float32, weighted=False, device="cpu"):
    """Keypoints x [*batch, K, 3], their noisy rigid images y and, if
    weighted, saliency-like weights [*batch, K]."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10, 10, batch + (K, 3))
    angle = rng.uniform(-0.1, 0.1, batch + (3,))
    R = torch.linalg.matrix_exp(torch.from_numpy(np.stack([
        np.stack([np.zeros(batch), -angle[..., 2], angle[..., 1]], -1),
        np.stack([angle[..., 2], np.zeros(batch), -angle[..., 0]], -1),
        np.stack([-angle[..., 1], angle[..., 0], np.zeros(batch)], -1)], -2)))
    y = apply_rigid(torch.from_numpy(x), R, torch.from_numpy(rng.uniform(-1, 1, batch + (3,))))
    y = y + torch.from_numpy(rng.normal(0, 0.05, y.shape))
    w = torch.from_numpy(rng.uniform(0, 1, batch + (K,))).to(dtype).to(device) if weighted else None
    return torch.from_numpy(x).to(dtype).to(device), y.to(dtype).to(device), w


def _torch_svd_recorder(seen):
    def recorded(H):
        seen.append(tuple(H.shape))
        return torch.linalg.svd(H.detach())
    return recorded


# (what H is, whether svd takes gesvdj_batched) with on_card forced true,
# but for "cpu"
ROUTES = {
    "cpu": False,
    "card f32": True,
    "card f64": True,
    "card [B, P]": True,
    "card single matrix": True,
    "reference_path": False,
    "grad recorded": False,
    "grad off": True,
    "4 x 4": False,
    "f16": False,
    "empty batch": False,
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_svd_route(monkeypatch, case):
    """svd takes gesvdj_batched exactly where `applies` holds: a card
    tensor [..., 3, 3] of f32 or f64, outside reference_path(), with no
    gradient to record; else torch.linalg.svd, whose result it returns."""
    seen = []
    monkeypatch.setattr(svd_mod, "gesvdj_batched", _torch_svd_recorder(seen))
    if case != "cpu":
        monkeypatch.setattr(svd_mod, "on_card", lambda t: True)
    shape, dtype = (8, 3, 3), torch.float32
    if case == "card f64":
        dtype = torch.float64
    elif case == "card [B, P]":
        shape = (2, 16, 3, 3)
    elif case == "card single matrix":
        shape = (3, 3)
    elif case == "4 x 4":
        shape = (8, 4, 4)
    elif case == "f16":
        dtype = torch.float16
    elif case == "empty batch":
        shape = (0, 3, 3)
    H = torch.from_numpy(np.random.default_rng(1).normal(size=shape)).to(dtype)
    routed = ROUTES[case]
    if case.startswith("grad"):
        H.requires_grad_(True)
    if case == "f16":   # torch.linalg.svd takes no f16 on the CPU: the route alone
        assert not svd_mod.applies(H)
        return
    if case == "reference_path":
        with reference_path():
            assert not svd_mod.applies(H)
            got = svd_mod.svd(H)
    elif case == "grad off":
        with torch.no_grad():
            assert svd_mod.applies(H)
            got = svd_mod.svd(H)
    else:
        assert svd_mod.applies(H) == routed
        got = svd_mod.svd(H)
    assert seen == ([tuple(shape)] if routed else [])
    want = torch.linalg.svd(H.detach())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].requires_grad == (case == "grad recorded")


def test_gesvdj_batched_refuses_what_it_cannot_take():
    """The wrapper raises on a CPU tensor, a shape other than [..., 3, 3],
    another dtype and an empty batch."""
    for H in (torch.zeros(2, 3, 3), torch.zeros(2, 4, 4), torch.zeros(0, 3, 3),
              torch.zeros(2, 3, 3, dtype=torch.float16), torch.zeros(3)):
        with pytest.raises(ValueError):
            svd_mod.gesvdj_batched(H)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("B", [1, 8])
def test_svd_refine_routes_each_pass(monkeypatch, B, weighted):
    """With the card forced, svd_refine under no_grad sends both Kabsch
    passes' H [B, 3, 3] to gesvdj_batched, and its R, t and inlier_idx are
    those of torch.linalg.svd's route."""
    x, y, w = _pair(B, (B,), 64, weighted=weighted)
    want = svd_refine(x, y, 0.8, w)
    seen = []
    monkeypatch.setattr(svd_mod, "gesvdj_batched", _torch_svd_recorder(seen))
    monkeypatch.setattr(svd_mod, "on_card", lambda t: True)
    with torch.no_grad():
        got = svd_refine(x, y, 0.8, w)
    assert seen == [(B, 3, 3)] * 2
    for name in ("R", "t", "inlier_idx"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("weighted", [False, True])
def test_deepvcp_loss_gradients_keep_torch_svd(monkeypatch, weighted):
    """Training's loss backpropagates through both SVDs: with the card
    forced, the route still declines them (gesvdj_batched is never called)
    and the gradients equal those of the CPU's torch.linalg.svd."""
    x, y, w = _pair(5, (4,), 64, weighted=weighted)
    R_true = torch.eye(3).expand(4, 3, 3)
    t_true = torch.zeros(4, 3)

    def grads():
        y_pred = y.clone().requires_grad_(True)
        wt = None if w is None else w.clone().requires_grad_(True)
        loss = deepvcp_loss(x, y_pred, R_true, t_true, weights=wt, vcp_weight=0.1,
                            rot_weight=0.1).loss
        return torch.autograd.grad(loss, [y_pred] + ([wt] if wt is not None else []))

    want = grads()

    def refuse(H):
        raise AssertionError("gesvdj_batched called where autograd records the SVD")

    monkeypatch.setattr(svd_mod, "gesvdj_batched", refuse)
    monkeypatch.setattr(svd_mod, "on_card", lambda t: True)
    got = grads()
    for g, wg in zip(got, want):
        assert torch.equal(g, wg)
    assert torch.isfinite(got[0]).all() and got[0].abs().sum() > 0


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the route calls cuSOLVER on the card")
    return torch.device("cuda")


def _matrices(dtype, device):
    """[name, H] cases: random at B = 1 and 8, the initializer's [B, P]
    batch, and degenerate ones."""
    rng = np.random.default_rng(24)
    Q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    a, b = rng.normal(size=3), rng.normal(size=3)
    c = rng.normal(size=3)
    cases = {
        "random B=1": rng.normal(size=(1, 3, 3)),
        "random B=8": rng.normal(size=(8, 3, 3)) * 50.0,
        "initializer [2, 1024]": rng.normal(size=(2, 1024, 3, 3)),
        "zero": np.zeros((2, 3, 3)),
        "rank 1": np.outer(a, b)[None],
        "rank 2": (np.outer(a, b) + np.outer(c, a))[None],
        "repeated singular values": (Q @ np.diag([2.0, 2.0, 1.0]) @ Q.T)[None],
        "all singular values equal": 3.0 * np.eye(3)[None],
        "reflection (det < 0)": (Q @ np.diag([1.0, 1.0, -1.0]))[None] * 7.0,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype).to(device)
            for k, v in cases.items()}


def _same_bits(a, b):
    """Equal bit for bit, NaNs included."""
    as_int = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return a.dtype == b.dtype and torch.equal(a.view(as_int), b.view(as_int))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gesvdj_batched_is_torch_svd_on_card(cuda, dtype):
    """U, S and Vh equal torch.linalg.svd's bit for bit, with its strides, on
    random and degenerate matrices, one launch a call, info 0 everywhere.
    A NaN in one matrix of a batch leaves info at 0 too, in cuSOLVER's
    gesvdj, so torch re-runs nothing there and raises nothing: the bits
    still agree, NaNs and all."""
    cases = _matrices(dtype, cuda)
    nan = cases["random B=8"].clone()
    nan[3, 1, 2] = float("nan")
    cases["a NaN in matrix 3 of 8"] = nan
    for name, H in cases.items():
        before = svd_mod.gesvdj_batched.launches
        got = svd_mod.gesvdj_batched(H)
        want = torch.linalg.svd(H)
        assert svd_mod.gesvdj_batched.launches == before + 1
        for g, w, part in zip(got, want, "USV"):
            assert g.shape == w.shape and g.stride() == w.stride(), (name, part)
            assert _same_bits(g, w), (name, part, (g - w).abs().max().item())
        assert svd_mod.gesvdj_batched.info.shape == H.shape[:-2]
        assert int(svd_mod.gesvdj_batched.info.abs().max()) == 0, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("B", [1, 8])
def test_kabsch_and_svd_refine_keep_their_bits_on_card(cuda, B, weighted, dtype):
    """kabsch's R and t and svd_refine's R, t and inlier_idx (K = 64) equal
    those under reference_path() (torch.linalg.svd) bit for bit; svd_refine
    syncs nowhere (set_sync_debug_mode("error")) and launches one SVD a
    pass; the initializer's [B, P] Kabsch too."""
    x, y, w = _pair(B, (B,), 64, dtype=dtype, weighted=weighted, device=cuda)
    with torch.no_grad():
        with reference_path():
            want_k = kabsch(x, y, w)
            want = svd_refine(x, y, 0.8, w)
        got_k = kabsch(x, y, w)
        for g, wk in zip(got_k, want_k):
            assert torch.equal(g, wk)
        before = svd_mod.gesvdj_batched.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = svd_refine(x, y, 0.8, w)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert svd_mod.gesvdj_batched.launches == before + 2
        for name in ("R", "t", "inlier_idx"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        # the initializer's icp: [B, P] hypotheses, trimmed 0/1 weights
        xs, ys, ws = _pair(B + 100, (2, 256), 64, dtype=dtype, weighted=True, device=cuda)
        ws = (ws > 0.3).to(dtype)
        with reference_path():
            want_p = kabsch(xs, ys, ws)
        got_p = kabsch(xs, ys, ws)
        for g, wp in zip(got_p, want_p):
            assert torch.equal(g, wp)
