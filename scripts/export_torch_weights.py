"""Export registry checkpoints to the PyTorch port's weight files.

Reads an orbax checkpoint through the JAX package (deepvcp_tpu.pretrained)
and writes its parameters and batch statistics, unchanged, to
deepvcp_tpu_torch/weights/<name>.npz, keyed by flax path
("params/fe/sa1/proj_xyz/kernel"). The port loads these files without jax,
flax or orbax. Needs the JAX package's dependencies; runs on the CPU:

    python scripts/export_torch_weights.py kitti25-rot [more names ...]
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def flatten(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from flatten(val, path)
        else:
            yield path, np.asarray(val)


def main(names):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from deepvcp_tpu import pretrained

    out_dir = os.path.join(ROOT, "deepvcp_tpu_torch", "weights")
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        _, variables = pretrained.load(name)
        arrays = dict(flatten(jax.device_get(variables)))
        path = os.path.join(out_dir, f"{name}.npz")
        np.savez(path, **arrays)
        n = sum(a.size for a in arrays.values())
        print(f"{name}: {len(arrays)} arrays, {n} values -> {path}")


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: export_torch_weights.py NAME [NAME ...]")
    main(sys.argv[1:])
