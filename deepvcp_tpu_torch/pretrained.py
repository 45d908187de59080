"""Named pretrained checkpoints for the port (counterpart of
deepvcp_tpu/pretrained.py).

The registry itself is the JAX package's (`REGISTRY`, imported: one list,
no drift). The checkpoints are the JAX package's checkpoint directories,
which the port does not read; their parameters are exported once to
`deepvcp_tpu_torch/weights/<name>.npz` by scripts/export_torch_weights.py,
keyed by flax path ("params/fe/sa1/proj_xyz/kernel"). Only the exported
names load.

    from deepvcp_tpu_torch import pretrained
    reg = pretrained.registrar("kitti25-rot", device="cuda")
    out = reg(src, tgt)
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any, Dict, Tuple

import numpy as np
import torch

from deepvcp_tpu.config import DeepVCPConfig
from deepvcp_tpu.pretrained import _ARCH_FIELDS, REGISTRY
from deepvcp_tpu_torch.registration import Registrar

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")


def config(name: str, num_points: int = 10000, use_normal: bool = False) -> DeepVCPConfig:
    """The DeepVCPConfig of a registry checkpoint, built as the JAX
    pretrained.load builds it: the entry's cfg, then the checkpoint's
    `.arch.json` provenance (flat fields and the SA radii)."""
    if name not in REGISTRY:
        raise KeyError(f"unknown pretrained model {name!r}; available: {sorted(REGISTRY)}")
    entry = REGISTRY[name]
    cfg = DeepVCPConfig(num_points=num_points, use_normal=use_normal, **entry["cfg"])
    arch_path = os.path.join(_ROOT, entry["path"]) + ".arch.json"
    if not os.path.exists(arch_path):
        return cfg
    with open(arch_path) as fh:
        arch = json.load(fh)
    cfg = dataclasses.replace(cfg, **{k: arch[k] for k in _ARCH_FIELDS if k in arch})
    if "sa_radii" in arch:
        radii = arch["sa_radii"]
        if len(radii) != len(cfg.sa_layers):
            raise ValueError(
                f"{name!r} provenance records {len(radii)} SA radii but the "
                f"config has {len(cfg.sa_layers)} SA layers")
        cfg = dataclasses.replace(cfg, sa_layers=tuple(
            dataclasses.replace(l, radius=r) for l, r in zip(cfg.sa_layers, radii)))
    unapplied = set(arch) - set(_ARCH_FIELDS) - {"sa_radii"}
    if unapplied:
        warnings.warn(
            f"{name!r} arch provenance has keys this loader does not apply: "
            f"{sorted(unapplied)} — extend pretrained.config", stacklevel=2)
    return cfg


def load_variables(name: str) -> Dict[str, Any]:
    """{"params": ..., "batch_stats": ...} nested dicts of numpy arrays from
    weights/<name>.npz."""
    path = os.path.join(WEIGHTS_DIR, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no exported weights for {name!r} at {path}; run "
            f"scripts/export_torch_weights.py {name} with the JAX package installed")
    variables: Dict[str, Any] = {}
    with np.load(path) as npz:
        for key in npz.files:
            *parents, leaf = key.split("/")
            node = variables
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = npz[key]
    return variables


def load(name: str, num_points: int = 10000, use_normal: bool = False
         ) -> Tuple[DeepVCPConfig, Dict[str, Any]]:
    """(DeepVCPConfig, flax-layout variables) for an exported checkpoint."""
    return config(name, num_points, use_normal), load_variables(name)


def registrar(name: str, *, device: torch.device, num_points: int = 10000,
              use_normal: bool = False, **registrar_kwargs) -> Registrar:
    """A ready Registrar on a named checkpoint, on `device`, with the JAX
    package's defaults: saliency weights on, refine_iters 2 for "kitti25"
    and 3 otherwise."""
    cfg, variables = load(name, num_points=num_points, use_normal=use_normal)
    registrar_kwargs.setdefault("use_saliency_weights", True)
    registrar_kwargs.setdefault("refine_iters", 2 if name == "kitti25" else 3)
    return Registrar(cfg, variables, device, **registrar_kwargs)
