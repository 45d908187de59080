"""Walkthroughs of the port (counterparts of the repo's examples/*.py):

    python -m deepvcp_tpu_torch.examples.register_pair [--cpu] [--num-points N]
                                                       [--full-so3] [--kitti]
    python -m deepvcp_tpu_torch.examples.train_synthetic [--cpu] [--tiny] [--steps S]

Each runs on the card unless given --cpu, and prints what its JAX
counterpart prints."""
