"""The control on the card: the reference computed in TF32 (the precision
below the configurations' float32 with TF32 off), put in the program's
place, fails the cell's limits, and the program on the same seed passes
them. Card only; run with
python -m pytest -p no:cacheprovider -q -m gpu benchmark/tests/test_bench_control.py"""

import pytest
import torch

from benchmark import check, control, manifest


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's own size")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["kitti25-rot.pair-b1", "kitti25-rot.stream-b8",
                                  "kitti25-two-level.stream-b8"])
def test_control_fails_and_program_passes(cell, card):
    bench = manifest.load()
    w = manifest.workload(bench, cell)
    config = manifest.config(bench, w["config"])
    rows = control.readings(config, manifest.traffic(w["traffic"]), [2 ** 33 + 3],
                            {2 ** 33 + 3}, card)
    by_side = {r["side"]: r for r in rows}
    assert check.judge(by_side["program"], config["limits"])[0]
    assert not check.judge(by_side["control"], config["limits"])[0]
