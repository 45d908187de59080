"""The benchmark of deepvcp_tpu_torch (the PyTorch + CUDA port) on NVIDIA
cards: one command, `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`, driven by BENCHMARK.json at the root of the
checkout. See benchmark/README.md for the layout and how to add a cell.

Nothing here imports jax, jaxlib, flax or the JAX package deepvcp_tpu. The
port (deepvcp_tpu_torch) is imported only by the modules that build and
drive the system under test (system.py, drive.py), never by the reference
(reference/, each file loaded by the path a configuration names) or the
yardstick (generate.py, work.py, check.py).
"""
