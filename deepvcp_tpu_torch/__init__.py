"""deepvcp_tpu_torch — the PyTorch + CUDA port of deepvcp_tpu for NVIDIA
Hopper (H100).

The JAX package deepvcp_tpu stays the reference; this package mirrors its
layout (ops/, models/, loss/, registration.py, pretrained.py, config.py,
initializer.py) and keeps its own copy of the configs. It imports torch and
numpy, never jax and nothing of deepvcp_tpu. Every Pallas kernel on the
ported path is a hand-written CUDA kernel under csrc/, built with nvcc on
first use (ops/kernels/_build.py), beside a plain PyTorch version that CPU
tensors run.

Layout:
    ops/          geometry ops; ops/kernels/ the CUDA kernel wrappers
    models/       banded set abstraction, FE, heads, DeepVCP forward
    loss/         the trimmed Kabsch pose solve and the training loss
    config        DeepVCPConfig, TrainConfig (copies of the JAX package's)
    registration  Registrar, CascadeRegistrar, RoutedRegistrar: the inference
                  contract, with stream() for pipelined calls
    initializer   so3_global_init, the coarse pose for any rotation
    pretrained    registry checkpoints exported to weights/*.npz
    convert       flax variables (and optax Adam state) -> torch
    data/         synthetic, KITTI and ModelNet40 datasets, pair construction
    native        ctypes binding of native/pointcloud.cc (velodyne reading)
    odometry/     sequence odometry, pose graph, bundle adjustment, CLI
                  (python -m deepvcp_tpu_torch.odometry)
    train/        train and eval steps, Trainer, CLI (python -m deepvcp_tpu_torch.train)
    utils/        rotations, pose metrics, warm-start jitter
"""

import torch

from deepvcp_tpu_torch.config import DeepVCPConfig, SALayerConfig, TrainConfig  # noqa: F401

# float32 must mean float32 on the card, as in the JAX reference: matmuls
# are full f32 by default, but cuDNN runs f32 convolutions (the CPG Conv3d)
# in TF32 unless told not to.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
