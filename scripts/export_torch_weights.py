"""Export checkpoints to the PyTorch port's weight files.

Reads an orbax checkpoint through the JAX package (deepvcp_tpu.pretrained)
and writes its parameters and batch statistics, unchanged, to
deepvcp_tpu_torch/weights/<name>.npz, keyed by flax path
("params/fe/sa1/proj_xyz/kernel"). The port loads these files without jax,
flax or orbax. Needs the JAX package's dependencies; runs on the CPU:

    python scripts/export_torch_weights.py kitti25-rot [more registry names ...]
    python scripts/export_torch_weights.py --path artifacts/campaign_r4b/model_q5w/final \
        --name campaign_r4b-q5w

A registry name is loaded with pretrained.load; --path DIR --name NAME
exports any checkpoint directory under NAME (pretrained.load_variables).
"""

from __future__ import annotations

import argparse
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


def export(name: str, variables, out_dir: str) -> None:
    import jax

    arrays = dict(flatten(jax.device_get(variables)))
    path = os.path.join(out_dir, f"{name}.npz")
    np.savez(path, **arrays)
    n = sum(a.size for a in arrays.values())
    print(f"{name}: {len(arrays)} arrays, {n} values -> {path}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("names", nargs="*", help="registry names")
    p.add_argument("--path", help="a checkpoint directory to export under --name")
    p.add_argument("--name", help="the weight file's name for --path")
    args = p.parse_args(argv)
    if bool(args.path) != bool(args.name) or not (args.names or args.path):
        p.error("give registry names, or --path DIR --name NAME")

    import jax

    jax.config.update("jax_platforms", "cpu")
    from deepvcp_tpu import pretrained

    out_dir = os.path.join(ROOT, "deepvcp_tpu_torch", "weights")
    os.makedirs(out_dir, exist_ok=True)
    for name in args.names:
        export(name, pretrained.load(name)[1], out_dir)
    if args.path:
        path = args.path if os.path.isabs(args.path) else os.path.join(ROOT, args.path)
        export(args.name, pretrained.load_variables(path), out_dir)


if __name__ == "__main__":
    main()
