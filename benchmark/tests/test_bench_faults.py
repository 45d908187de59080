"""A run with the timed path broken underneath comes out not correct: the
harness's own path past the card check, on the CPU at a small size, once for
each fault a registration cell can have (an answer altered where it is
produced; half of a batch left out, the rest's results in its place), and
once sound."""

import pytest
import torch

from benchmark.tests.helpers import cpu_run


def test_sound_run_is_correct():
    res = cpu_run("kitti25-rot.pair-b1")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0.0 for c in res["checks"].values())
    assert set(res["metrics"]) == {"latency_p50_ms", "setup_s"}   # p95 needs 20 calls


@pytest.mark.parametrize("cell", ["kitti25-rot.pair-b1", "kitti25-two-level.stream-b8"])
def test_altered_answer_is_caught(cell, monkeypatch):
    from deepvcp_tpu_torch import registration

    original = registration.svd_refine

    def shifted(*args, **kwargs):
        ref = original(*args, **kwargs)
        return ref._replace(t=ref.t + 1e-3)

    monkeypatch.setattr(registration, "svd_refine", shifted)
    res = cpu_run(cell)
    assert not res["correct"]
    assert res["checks"]["t_m"]["value"] > res["checks"]["t_m"]["limit"]


def test_half_batch_left_out_is_caught(monkeypatch):
    from deepvcp_tpu_torch.registration import Registrar

    original = Registrar.__call__

    def half(self, src, tgt, R_init=None, t_init=None):
        h = src.shape[0] // 2
        out = original(self, src[:h], tgt[:h])
        return out._replace(**{k: torch.cat([v, v]) for k, v in out._asdict().items()})

    monkeypatch.setattr(Registrar, "__call__", half)
    res = cpu_run("kitti25-rot.stream-b8")
    assert not res["correct"]


def test_non_finite_pose_fails(monkeypatch):
    from deepvcp_tpu_torch.registration import Registrar

    original = Registrar.__call__
    monkeypatch.setattr(Registrar, "__call__", lambda *a, **k: original(*a, **k)._replace(
        t=torch.full((1, 3), float("nan"))))
    res = cpu_run("kitti25-rot.pair-b1")
    assert not res["correct"] and res["failed"] >= 1
