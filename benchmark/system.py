"""The system under test: the port's Registrar (deepvcp_tpu_torch), built
from a configuration file of benchmark/configs and the weights it names.
The benchmark reads the weights itself and hands the same arrays to the port
and to the reference."""

from __future__ import annotations

from typing import Dict

import numpy as np


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
    """The port's DeepVCPConfig of a configuration file's "model"."""
    from deepvcp_tpu_torch.config import DeepVCPConfig, SALayerConfig

    fields = dict(config["model"])
    fields["sa_layers"] = tuple(SALayerConfig(**{**layer, "mlp": tuple(layer["mlp"])})
                                for layer in fields["sa_layers"])
    for key, value in fields.items():
        if isinstance(value, list):
            fields[key] = tuple(value)
    return DeepVCPConfig(**fields)


def registrar(config: dict, params: Dict[str, np.ndarray], device):
    """The port's Registrar of the configuration on `device`."""
    from deepvcp_tpu_torch.registration import Registrar

    return Registrar(model_config(config), flax_variables(params), device,
                     **config["registrar"])
