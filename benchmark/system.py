"""The system under test, built from a configuration file of
benchmark/configs: one stage is the port's Registrar (deepvcp_tpu_torch),
several (`stages`) its CascadeRegistrar over one Registrar a stage, each on
its own weights. The benchmark reads the weights itself and hands the same
arrays to the port and to the reference, which `reference` loads from the
file the configuration names."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Union

import numpy as np

from benchmark import manifest
from benchmark.reference.deepvcp import load_npz

ROOT = Path(__file__).resolve().parents[1]

Params = Dict[str, np.ndarray]


def params(config: dict, root: Path = ROOT) -> Union[Params, List[Params]]:
    """The configuration's weights as the file lays them out: load_npz's
    dict of its `weights`, or a list of one such dict a stage."""
    if "stages" in config:
        return [load_npz(str(root / s["weights"])) for s in config["stages"]]
    return load_npz(str(root / config["weights"]))


def flax_variables(params: Dict[str, np.ndarray]) -> dict:
    """The flat npz dict ("params/fe/sa1/proj_xyz/kernel" -> array) as the
    nested {"params": ..., "batch_stats": ...} the Registrar takes."""
    variables: dict = {}
    for key, value in params.items():
        *parents, leaf = key.split("/")
        node = variables
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return variables


def model_config(config: dict):
    """The port's DeepVCPConfig of a configuration file's (or a stage's) "model"."""
    from deepvcp_tpu_torch.config import DeepVCPConfig, SALayerConfig

    fields = dict(config["model"])
    fields["sa_layers"] = tuple(SALayerConfig(**{**layer, "mlp": tuple(layer["mlp"])})
                                for layer in fields["sa_layers"])
    for key, value in fields.items():
        if isinstance(value, list):
            fields[key] = tuple(value)
    return DeepVCPConfig(**fields)


def registrar(config: dict, params: Dict[str, np.ndarray], device):
    """The port's Registrar of the configuration (or one stage) on `device`."""
    from deepvcp_tpu_torch.registration import Registrar

    return Registrar(model_config(config), flax_variables(params), device,
                     **config["registrar"])


def build(config: dict, params, device):
    """The system under test on `device`, from `params` as `params()` gives
    them: the one stage's Registrar, or a CascadeRegistrar of the stages'."""
    if "stages" not in config:
        return registrar(config, params, device)
    from deepvcp_tpu_torch.registration import CascadeRegistrar

    return CascadeRegistrar([registrar(s, p, device) for s, p in zip(config["stages"], params)])


def models(built) -> list:
    """The model of each stage of a system that `build` made, in order."""
    return [stage.model for stage in getattr(built, "stages", [built])]


def reference(config: dict, params, device, allow_tf32: bool = False, root: Path = ROOT):
    """The plain reference that the configuration names, on the same
    `params`; with `allow_tf32` computed in TF32 (the control)."""
    return manifest.reference(config, root)(config, params, device, allow_tf32=allow_tf32)
