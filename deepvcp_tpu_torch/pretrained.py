"""Named pretrained checkpoints for the port (counterpart of
deepvcp_tpu/pretrained.py).

The registry is the port's own copy of the JAX package's (`REGISTRY`,
`CASCADES`, `_ARCH_FIELDS`; tests/test_torch_config.py holds the two
equal). The checkpoints are the JAX package's checkpoint directories, which
the port does not read; their parameters are exported once to
`deepvcp_tpu_torch/weights/<name>.npz` by scripts/export_torch_weights.py,
keyed by flax path ("params/fe/sa1/proj_xyz/kernel"); every registry name
is exported. The configs read each checkpoint's `.arch.json` beside it.

    from deepvcp_tpu_torch import pretrained
    reg = pretrained.registrar("kitti25-rot", device="cuda")
    out = reg(src, tgt)
    casc = pretrained.cascade("modelnet-cascade", device="cuda")
    out = casc(src, tgt, init.R, init.t)   # init = so3_global_init(src, tgt)
    routed = pretrained.routed_registrar(device="cuda")   # modelnet-fine / lidar-fine
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepvcp_tpu_torch.config import DeepVCPConfig
from deepvcp_tpu_torch.registration import CascadeRegistrar, Registrar, RoutedRegistrar

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")

# fields of the arch fingerprint that map 1:1 onto DeepVCPConfig fields
_ARCH_FIELDS = (
    "centered_grid", "keypoint_selection", "dfe_src_neighbors",
    "derotate_tgt_neighborhoods", "group_radius", "search_radius",
    "voxel_len", "num_keypoints", "num_neighbors", "keypoint_pool_mult",
)

# name -> the Registrar's default refine_iters (the JAX pretrained.registrar
# special-cases it: 2 for kitti25, 3 otherwise), checkpoint directory (the
# `.arch.json` beside it is read), config fields, the GT-free (RRE deg, RTE)
# the JAX package measured for it on its held sets, and a note
REGISTRY: Dict[str, Dict[str, Any]] = {
    "modelnet-coarse": {
        "refine_iters": 3,
        "path": "artifacts/campaign_r4/model_r1/final",
        "cfg": {"spatial_extent": 2.5},
        "gt_free": {"uniform_small": (2.43, 0.058)},
        "notes": "residual-recipe base model, reference grid "
                 "(r=1.0, s=0.4); best with refine_iters>=2",
    },
    "modelnet-fine": {
        "refine_iters": 3,
        "path": "artifacts/campaign_r4/model_fine/final",
        "cfg": {"spatial_extent": 2.5},
        "gt_free": {"uniform_small": (0.80, 0.026),
                    "lidar_small": (7.47, 0.092)},
        "notes": "fine-grid precision stage (r=0.6, s=0.2) fine-tuned "
                 "from modelnet-coarse; headline ModelNet-scale model, "
                 "refine_iters=3",
    },
    "lidar-fine": {
        "refine_iters": 3,
        "path": "artifacts/campaign_r4c/model_lfine/final",
        "cfg": {"spatial_extent": 2.5},
        "gt_free": {"lidar_small": (2.12, 0.041),
                    "uniform_small": (5.60, 0.31)},
        "notes": "modelnet-fine fine-tuned on a lidar-heavy (25/75) "
                 "mix — the lidar specialist; see README 'lidar gap'",
    },
    "kitti25": {
        "refine_iters": 2,
        "path": "artifacts/campaign_r4b/model_k1/final",
        "cfg": {"spatial_extent": 55.0},
        "gt_free": {"lidar25_small": (0.27, 0.0097)},
        "notes": "velodyne-scale (25 m range, meter coordinates, f32 "
                 "selection gate); use for odometry, refine_iters=2",
    },
    "kitti25-rot": {
        "refine_iters": 3,
        "path": "artifacts/campaign_r5g/model_k7_w3/final",
        "cfg": {"spatial_extent": 55.0},
        "gt_free": {"lidar25_small": (0.2365, 0.0071)},
        "notes": "kitti25 continued with the explicit rotation loss "
                 "term (rot_loss_weight=3) — the ROTATION headline: "
                 "0.24 deg/0.0071 at refine_iters=2, and stable under "
                 "further iteration where kitti25 degraded "
                 "(campaign_r5g E7; rot_weight=10 overshoots). The "
                 "round-5 rotation-wall fix: the point-space loss is "
                 "translation-dominated at 25 m range, so rotation was "
                 "under-supervised",
    },
    "kitti25-fine": {
        "refine_iters": 3,
        "path": "artifacts/campaign_r5/model_k5/final",
        "cfg": {"spatial_extent": 55.0},
        "gt_free": {"lidar25_small_cascade": (0.384, 0.0064)},
        "notes": "fine-grid KITTI-scale stage (r=0.6, s=0.2 m) trained "
                 "on the cascade hand-off jitter ball (1.5 deg/0.15 m, "
                 "in-reach at the 25 m lever arm); meant as the second "
                 "stage of kitti-cascade, not for identity-init use",
    },
    "kitti25-ultra": {
        "refine_iters": 3,
        "path": "artifacts/campaign_r5/model_k6/final",
        "cfg": {"spatial_extent": 55.0},
        "gt_free": {"lidar25_small_cascade": (0.447, 0.0027)},
        "notes": "ultra-fine KITTI-scale stage (r=0.3, s=0.1 m, "
                 "0.6 deg/0.07 m ball) — third stage of kitti-cascade",
    },
}

# coarse-to-fine compositions (registration.CascadeRegistrar): each entry
# lists (registry model, refine_iters) in execution order
CASCADES: Dict[str, Dict[str, Any]] = {
    "kitti-cascade": {
        "stages": [("kitti25", 2), ("kitti25-fine", 1),
                   ("kitti25-ultra", 2)],
        "gt_free": {"lidar25_small": (0.447, 0.0027)},
        "notes": "the RTE-optimal KITTI-scale stack (campaign_r5 C3: "
                 "0.45 deg / 0.0027 m — 26x under the paper's 0.071 m "
                 "bar). Rotation-optimal is kitti25 alone at "
                 "refine_iters=2 (0.27 deg / 0.0097): the trimmed-NN "
                 "guard is rotation-blind below ~0.4 deg at 25 m "
                 "range, so fine stages trade a little rotation for "
                 "3.6x translation (campaign_r5c/e refuted every "
                 "eval-time rotation lever: deeper iteration, more "
                 "keypoints, guard-off all measure WORSE)",
    },
    "modelnet-cascade": {
        "stages": [("modelnet-coarse", 2), ("modelnet-fine", 1)],
        "gt_free": {},
        "notes": "the ModelNet-scale cascade (campaign_r4 part 1 "
                 "measured 1.93 deg/0.025 vs 2.43/0.058 coarse-only)",
    },
}


# Campaign checkpoints outside the registry (REGISTRY stays equal to the JAX
# package's), exported because they run the non-default engines or carry
# the trained-checkpoint regression (campaign_r4-fine): name ->
# checkpoint directory (its `.arch.json` applies), the point count and the
# config fields of the script that trained it, and the GT-free (RRE deg,
# RTE) of that campaign's eval step (one identity-init forward and the
# unweighted trimmed Kabsch solve; a TPU with approx_min_k selection) on
# `uniform_small`, printed for orientation only.
CAMPAIGN: Dict[str, Dict[str, Any]] = {
    "campaign_r4b-q5w": {
        "path": "artifacts/campaign_r4b/model_q5w/final",
        "num_points": 2048,
        "cfg": {"spatial_extent": 2.5, "neighbor_method": "windowed", "window_safety": 6.0,
                "knn_window": 512},
        "source": "scripts/campaign_r4b.py:269-283 (cfg_q5w)",
        "gt_free": {"uniform_small": (7.287, 0.3653),
                    "uniform_small_dense": (7.2267, 0.3687)},
        "notes": "trained on the windowed engine at N = 2048; the same weights also "
                 "run under neighbor_method='dense'",
    },
    "campaign_r4-r1c": {
        "path": "artifacts/campaign_r4/model_r1c/final",
        "num_points": 10000,
        "cfg": {"spatial_extent": 2.5},
        "source": "scripts/campaign_r4.py:75-85 (cfg_ref_sem)",
        "gt_free": {"uniform_small": (9.0655, 0.1942)},
        "notes": "the reference-semantics ablation: banded engine, "
                 "dfe_src_neighbors='keypoints', uncentred grid, no derotation "
                 "(from its .arch.json)",
    },
    "campaign_r4-fine": {
        "path": "artifacts/campaign_r4/model_fine/final",
        "num_points": 10000,
        "cfg": {"spatial_extent": 2.5, "search_radius": 0.6, "voxel_len": 0.2},
        # registry "modelnet-fine" serves the same checkpoint: its export is this one's,
        # byte for byte
        "weights": "modelnet-fine",
        "source": "scripts/campaign_r4.py:245-249 (cfg_fine of cfg_fixed, :76-78; fine_src "
                  "model_r1 in artifacts/campaign_r4/summary.json)",
        "gt_free": {"uniform_small": (2.5199, 0.067)},
        "notes": "the fine-grid fine-tune of model_r1 (banded engine, r = 0.6, s = 0.2); "
                 "the trained-checkpoint regression runs it at N = 1024 with the guard "
                 "and refine_iters 2",
    },
}


def available() -> Dict[str, str]:
    """Name -> one-line description of each registry checkpoint."""
    return {k: v["notes"] for k, v in REGISTRY.items()}


def available_cascades() -> Dict[str, str]:
    """Name -> one-line description of each registry cascade."""
    return {k: v["notes"] for k, v in CASCADES.items()}


def config(name: str, num_points: int = 10000, use_normal: bool = False) -> DeepVCPConfig:
    """The DeepVCPConfig of a registry checkpoint, built as the JAX
    pretrained.load builds it: the entry's cfg, then the checkpoint's
    `.arch.json` provenance (flat fields and the SA radii)."""
    if name not in REGISTRY:
        raise KeyError(f"unknown pretrained model {name!r}; available: {sorted(REGISTRY)}")
    entry = REGISTRY[name]
    cfg = DeepVCPConfig(num_points=num_points, use_normal=use_normal, **entry["cfg"])
    return _apply_arch(name, cfg, entry["path"])


def campaign_config(name: str, **changes) -> DeepVCPConfig:
    """The DeepVCPConfig of a CAMPAIGN checkpoint: its script's fields, then
    its `.arch.json`, then `changes` (e.g. neighbor_method="dense")."""
    if name not in CAMPAIGN:
        raise KeyError(f"unknown campaign model {name!r}; available: {sorted(CAMPAIGN)}")
    entry = CAMPAIGN[name]
    cfg = DeepVCPConfig(num_points=entry["num_points"], use_normal=False, **entry["cfg"])
    return dataclasses.replace(_apply_arch(name, cfg, entry["path"]), **changes)


def campaign_registrar(name: str, *, device: torch.device,
                       cfg_changes: Optional[Dict[str, Any]] = None,
                       **registrar_kwargs) -> Registrar:
    """A Registrar on a CAMPAIGN checkpoint, on `device`, with the
    Registrar's own defaults (refine_iters 1, unweighted solve; with
    guard=False it computes the campaign eval step's GT-free pose)."""
    cfg = campaign_config(name, **(cfg_changes or {}))
    return Registrar(cfg, load_variables(name), device, **registrar_kwargs)


def _apply_arch(name: str, cfg: DeepVCPConfig, path: str) -> DeepVCPConfig:
    """cfg with the `.arch.json` provenance beside checkpoint `path` applied."""
    arch_path = os.path.join(_ROOT, path) + ".arch.json"
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
            f"{sorted(unapplied)} — extend pretrained.config", stacklevel=3)
    return cfg


def load_variables(name: str) -> Dict[str, Any]:
    """{"params": ..., "batch_stats": ...} nested dicts of numpy arrays from
    weights/<name>.npz (a REGISTRY or a CAMPAIGN name; a CAMPAIGN entry with
    "weights" reads that file, the export of the same checkpoint)."""
    path = os.path.join(WEIGHTS_DIR, f"{CAMPAIGN.get(name, {}).get('weights', name)}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no exported weights for {name!r} at {path}; run "
            f"scripts/export_torch_weights.py with the JAX package installed")
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
    package's defaults: saliency weights on, the entry's refine_iters."""
    cfg, variables = load(name, num_points=num_points, use_normal=use_normal)
    registrar_kwargs.setdefault("use_saliency_weights", True)
    registrar_kwargs.setdefault("refine_iters", REGISTRY[name]["refine_iters"])
    return Registrar(cfg, variables, device, **registrar_kwargs)


def cascade(name: str, *, device: torch.device, num_points: int = 10000,
            use_normal: bool = False, **registrar_kwargs) -> CascadeRegistrar:
    """A ready CascadeRegistrar over a named stage composition (CASCADES),
    every stage on `device`, with the JAX package's defaults: each stage's
    refine_iters from the entry, saliency weights on; other Registrar
    kwargs apply to every stage."""
    if name not in CASCADES:
        raise KeyError(f"unknown cascade {name!r}; available: {sorted(CASCADES)}")
    registrar_kwargs.setdefault("use_saliency_weights", True)
    stages = []
    for stage_name, iters in CASCADES[name]["stages"]:
        cfg, variables = load(stage_name, num_points=num_points, use_normal=use_normal)
        stages.append(Registrar(cfg, variables, device, refine_iters=iters,
                                **registrar_kwargs))
    return CascadeRegistrar(stages)


def routed_registrar(low: str = "modelnet-fine", high: str = "lidar-fine", *,
                     device: torch.device, num_points: int = 10000, use_normal: bool = False,
                     **registrar_kwargs) -> RoutedRegistrar:
    """A ready RoutedRegistrar on `device`: each batch goes to `low`
    (uniform-density clouds) or `high` (lidar-like clouds) by the router
    statistic, with the JAX package's defaults (saliency weights on,
    refine_iters 3). The experts must share one config."""
    cfg_l, v_l = load(low, num_points=num_points, use_normal=use_normal)
    cfg_h, v_h = load(high, num_points=num_points, use_normal=use_normal)
    if cfg_l != cfg_h:
        raise ValueError(
            f"experts {low!r} and {high!r} have different architectures: routing "
            f"swaps the weights of one model")
    registrar_kwargs.setdefault("use_saliency_weights", True)
    registrar_kwargs.setdefault("refine_iters", 3)
    return RoutedRegistrar(cfg_l, {"low": v_l, "high": v_h}, device, **registrar_kwargs)
