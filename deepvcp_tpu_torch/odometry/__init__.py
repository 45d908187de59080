"""Sequence odometry of the port: chained pairwise registration, pose-graph
optimisation, landmark bundle adjustment and trajectory metrics
(counterpart of deepvcp_tpu/odometry). CLI:
python -m deepvcp_tpu_torch.odometry --device cuda --root KITTI --sequence 00"""

from deepvcp_tpu_torch.odometry.pipeline import (  # noqa: F401
    load_kitti_poses,
    load_sequence_scans,
    register_sequence,
    run_odometry,
)
from deepvcp_tpu_torch.odometry.pose_graph import (  # noqa: F401
    LandmarkObs,
    PoseGraph,
    absolute_trajectory_error,
    build_graph,
    chain_poses,
    exp_so3,
    hat,
    log_so3,
    optimize_landmark_ba,
    optimize_pose_graph,
    optimize_pose_graph_sharded,
    relative_pose_errors,
)
