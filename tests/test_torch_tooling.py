"""The port's tooling: utils/profiling (StageTimer, annotate, trace,
enable_nan_checks), the plot CLI, profile_stages on the CPU at a tiny size,
and graft_entry (entry, and dryrun_multichip over 2 gloo ranks)."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from deepvcp_tpu_torch import graft_entry, plot
from deepvcp_tpu_torch.train import MetricsLogger, load_metrics
from deepvcp_tpu_torch.utils.profiling import StageTimer, annotate, enable_nan_checks, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_stage_timer_records_each_stage():
    timer = StageTimer()
    with timer.stage("sleep", sync=torch.device("cpu")):
        time.sleep(0.02)
    out = timer.timeit("matmul", torch.matmul, torch.ones(4, 4), torch.ones(4, 4))
    assert torch.equal(out, torch.full((4, 4), 4.0))
    times = timer.as_dict()
    assert list(times) == ["sleep", "matmul"]
    assert times["sleep"] >= 0.02
    report = timer.report()
    assert "sleep" in report and "matmul" in report and "total" in report


def test_trace_writes_annotated_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        with annotate("my_stage"):
            torch.ones(8).sum()
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "my_stage" for e in events)


def test_enable_nan_checks_raises_in_backward():
    x = torch.tensor([-1.0], requires_grad=True)
    enable_nan_checks(True)
    try:
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        enable_nan_checks(False)


def _metrics(path):
    log = MetricsLogger(str(path), echo=False)
    for epoch in range(2):
        for i in range(4):
            log.log({"kind": "train", "epoch": epoch, "batch": i, "loss": 1.0 / (i + 1),
                     "rre_deg": 0.5, "rte": 0.1})
        log.log({"kind": "epoch", "epoch": epoch, "loss": 0.52, "rre_deg": 0.5, "rte": 0.1})
    log.log({"kind": "eval", "epoch": 1, "loss": 0.6, "rre_deg": 0.7, "rte": 0.2})
    log.close()


def test_plot_summary_and_out(tmp_path, capsys):
    """--summary prints the epoch and eval averages as JSON lines and draws
    nothing; --out draws the curves."""
    m = tmp_path / "metrics.jsonl"
    _metrics(m)
    plot.main([str(m), "--summary"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["kind"], r["epoch"]) for r in lines] == [("epoch", 0), ("epoch", 1), ("eval", 1)]
    assert lines[0]["loss"] == 0.52
    assert not (tmp_path / "loss.png").exists()
    out = tmp_path / "curves.png"
    plot.main([str(m), "--out", str(out), "--smooth", "2", "--summary"])
    assert out.stat().st_size > 0
    assert f"plot saved to {out}" in capsys.readouterr().out
    assert len(load_metrics(str(m))) == 11


def test_profile_stages_cpu_tiny_prints_json():
    proc = subprocess.run(
        [sys.executable, "-m", "deepvcp_tpu_torch.profile_stages", "--cpu", "--tiny",
         "--num-points", "128", "--reps", "2"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    stages = ["fe(src)", "fe(tgt)", "weighting", "candidate knn", "row gather",
              "two-level rows", "dfe(src)", "dfe(tgt)", "cpg", "svd solve"]
    assert list(result["stages_ms"]) == stages
    assert all(v > 0 for v in result["stages_ms"].values())
    assert all(r["bound"] == "cpu" and r["gb"] > 0 for r in result["roofline"].values())
    assert "total" in proc.stdout


def test_graft_entry_forward_and_dryrun_multichip():
    """entry()'s forward on the CPU, and one train step over a 1 x 2 mesh
    of gloo ranks at N = 1024 (the ring candidate KNN over the point group):
    both ranks report the same finite loss."""
    fn, example = graft_entry.entry(device="cpu")
    kp, vcp = fn(*example)
    assert kp.shape == vcp.shape == (1, 16, 3)
    assert torch.isfinite(vcp).all()
    loss = graft_entry.dryrun_multichip(2, device="cpu", timeout_s=240)
    assert np.isfinite(loss)
