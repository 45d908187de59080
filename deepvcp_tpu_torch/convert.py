"""flax variables -> PyTorch state dict for the port's modules.

The port's submodules carry the flax names, so the conversion is a renaming
plus two layout changes:
    Dense kernel [in, out]               -> Linear weight [out, in]
    Conv kernel [kd, kh, kw, in, out]    -> Conv3d weight [out, in, kd, kh, kw]
    BatchNorm scale / bias               -> weight / bias
    batch_stats mean / var               -> running_mean / running_var
    bias0 (banded SA first-layer bias)   -> bias0
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_PARAM_NAMES = {"bias": "bias", "scale": "weight", "bias0": "bias0"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def flax_to_torch(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} nested mappings of arrays (numpy,
    or anything np.asarray takes) -> a state dict for DeepVCP.load_state_dict
    (strict)."""
    state: Dict[str, torch.Tensor] = {}
    for path, val in _walk(variables["params"]):
        arr = np.asarray(val, dtype=np.float32)
        *mod, leaf = path
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)
            else:
                raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")
            name = "weight"
        elif leaf in _PARAM_NAMES:
            name = _PARAM_NAMES[leaf]
        else:
            raise ValueError(f"unknown parameter {'/'.join(path)}")
        state[".".join(mod + [name])] = torch.tensor(arr)
    for path, val in _walk(variables.get("batch_stats", {})):
        *mod, leaf = path
        if leaf not in _STAT_NAMES:
            raise ValueError(f"unknown batch stat {'/'.join(path)}")
        state[".".join(mod + [_STAT_NAMES[leaf]])] = torch.tensor(
            np.asarray(val, dtype=np.float32))
        # torch's BatchNorm buffer; the port never updates running stats
        state[".".join(mod + ["num_batches_tracked"])] = torch.tensor(0)
    return state
