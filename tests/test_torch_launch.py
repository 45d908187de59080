"""The port's rank launcher (deepvcp_tpu_torch.parallel.launch.run_ranks):
a run whose ranks reach the end of their bodies at different times.

Rank 0 hosts the run's TCPStore. A rank that builds its mesh's groups after
rank 0 has returned needs that store, so no rank may tear down its process
group before every rank is done (a barrier in the launcher); without it
the late rank fails with a broken pipe.
"""

import os

from deepvcp_tpu_torch.parallel.launch import run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))


def test_late_rank_builds_its_mesh_after_the_others_finish():
    """4 gloo ranks; the last sleeps 3 s before make_mesh(1, 4) and none
    issues a collective after it: every rank returns its coordinate."""
    coords = run_ranks("torch_ranks:late_mesh", 4, kwargs={"shape": (1, 4), "delay_s": 3.0},
                       device="cpu", sys_path=[HERE], timeout_s=120)
    assert [list(c) for c in coords] == [[0, p] for p in range(4)]
