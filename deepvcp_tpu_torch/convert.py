"""flax variables -> PyTorch state dict for the port's modules.

The port's submodules carry the flax names, so the conversion is a renaming
plus two layout changes:
    Dense kernel [in, out]               -> Linear weight [out, in]
    Conv kernel [kd, kh, kw, in, out]    -> Conv3d weight [out, in, kd, kh, kw]
    BatchNorm scale / bias               -> weight / bias
    batch_stats mean / var               -> running_mean / running_var
    bias0 (banded SA first-layer bias)   -> bias0

The gather-path SA stages of the windowed and dense engines
(models/layers.py::SetAbstraction) carry sa*/proj_xyz/{kernel,bias},
sa*/proj_feat/kernel, sa*/dense*/{kernel,bias} and sa*/bn*, and the MSG / FP
stages b{i}_dense{j}, b{i}_bn{j}, dense{j}, bn{j}: the same rules cover them.

and the Adam state of an optax chain maps onto torch.optim.Adam's with the
same layout changes (optax_adam_to_torch).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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
        # torch's BatchNorm buffer, unused: the port's BatchNorm keeps flax's
        # fixed momentum and never counts batches
        state[".".join(mod + ["num_batches_tracked"])] = torch.tensor(0)
    return state


def _find_adam_state(tree: Any) -> Optional[Any]:
    """The first node of an optax state tree (nested tuples) with `count`,
    `mu` and `nu`: the ScaleByAdamState."""
    if all(hasattr(tree, f) for f in ("count", "mu", "nu")):
        return tree
    if isinstance(tree, (tuple, list)):
        for child in tree:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def optax_adam_to_torch(opt_state: Any, model: torch.nn.Module
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The Adam moments of an optax state (e.g. the
    chain(clip_by_global_norm, adam) state of the JAX trainer) as
    torch.optim.Adam per-parameter state, keyed by the model's parameter
    names: count -> step, mu -> exp_avg, nu -> exp_avg_sq, each moment with
    its parameter's layout change. Install with
    train.optim.load_adam_state."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    mu = flax_to_torch({"params": adam.mu})
    nu = flax_to_torch({"params": adam.nu})
    out = {}
    for name, p in model.named_parameters():
        if mu[name].shape != p.shape:
            raise ValueError(f"{name}: moment {tuple(mu[name].shape)} vs parameter "
                             f"{tuple(p.shape)}")
        out[name] = {"step": step.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    return out
