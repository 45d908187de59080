"""The port's examples (deepvcp_tpu_torch/examples/, counterparts of
examples/register_pair.py and examples/train_synthetic.py), each through
its main(argv) with --cpu at a small size: the three registration modes at
256 points and three tiny training steps. They print what the JAX scripts
print; the registrations must be accurate on their easy pairs."""

import json

import numpy as np
import pytest
import torch

from deepvcp_tpu_torch.examples import register_pair, train_synthetic

torch.set_num_threads(2)

# (flags, RRE bound deg, RTE bound) per mode at 256 points; measured here
# 2.08 deg / 0.0254, 0.133 / 0.0021 and 0.0022 / 0.0027
MODES = [([], 5.0, 0.1), (["--full-so3"], 2.0, 0.05), (["--kitti"], 1.0, 0.05)]


@pytest.mark.parametrize("flags,rre_max,rte_max", MODES, ids=["modelnet-fine", "full-so3", "kitti"])
def test_register_pair(capsys, flags, rre_max, rte_max):
    res = register_pair.main(["--cpu", "--num-points", "256", *flags])
    printed = capsys.readouterr().out
    for prefix in ("RRE (deg): ", "RTE:       ", "guard scores (col 0 = init): ",
                   "keypoints (2, 64, 3), vcps (2, 64, 3)"):
        assert prefix in printed, prefix
    assert ("global init RRE:" in printed) == ("--full-so3" in flags)
    out = res["out"]
    assert torch.isfinite(out.R).all() and torch.isfinite(out.t).all()
    assert res["rre"].shape == res["rte"].shape == (2,)
    assert res["rre"].max() <= rre_max and res["rte"].max() <= rte_max, (res["rre"], res["rte"])


def test_train_synthetic(tmp_path, capsys):
    metrics = tmp_path / "synthetic_metrics.jsonl"
    summary = train_synthetic.main(["--cpu", "--tiny", "--steps", "3", "--num-points", "256",
                                    "--metrics", str(metrics)])
    last_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last_line) == summary
    assert summary["steps"] == 3 and summary["steps_per_sec"] > 0
    for end in ("first", "last"):
        assert set(summary[end]) == {"loss", "rre_deg", "rte"}
        assert np.isfinite(list(summary[end].values())).all()
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1, 2]
    assert {"kind", "loss", "l1", "mean_residual", "vcp_l1", "rre_deg", "rte",
            "grad_norm"} <= set(records[0])
