"""The comparison that decides `correct`: the outputs of a sample of the
window's calls, drawn from the seed, against the plain reference
(benchmark/reference) run on the same inputs once the window has closed.

Each number is the worst over the sampled pairs:
- saliency_rel: max |saliency - reference| / max |reference| of a pair;
- keypoints_m: the largest distance between a keypoint and the reference's
  keypoint of the same rank;
- vcps_m: the largest distance between a virtual corresponding point of the
  last refinement and the reference's;
- rot_deg: the angle between the pose's rotation and the reference's;
- t_m: the distance between the translations;
- scores_m: the largest gap between the guard's scores (the trimmed mean
  1-NN distance of the posed keypoints, for the init and each refinement).
A configuration file's "limits" gives each its limit; PERF.md gives the
readings each limit was set from. A sample that is missing, or a number that
is not finite, fails.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

NUMBERS = ("saliency_rel", "keypoints_m", "vcps_m", "rot_deg", "t_m", "scores_m")


def _rot_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """The angle between rotations, 2 asin(|Ra - Rb|_F / (2 sqrt 2)), in
    degrees, resolved at small angles."""
    fro = torch.linalg.norm((Ra - Rb).double(), dim=(-2, -1))
    return torch.rad2deg(2.0 * torch.arcsin(torch.clamp(fro / (2.0 * 2.0 ** 0.5), 0.0, 1.0)))


def readings(out: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers of one call's outputs against the reference's (both
    dicts of [B, ...] tensors on the same device)."""
    d = {k: (out[k].double(), ref[k].double()) for k in
         ("saliency", "keypoints", "vcps", "t", "scores")}
    sal_o, sal_r = d["saliency"]
    scale = sal_r.abs().amax(dim=-1).clamp_min(1e-30)
    return {
        "saliency_rel": float(((sal_o - sal_r).abs().amax(dim=-1) / scale).max()),
        "keypoints_m": float(
            torch.linalg.norm(d["keypoints"][0] - d["keypoints"][1], dim=-1).max()),
        "vcps_m": float(torch.linalg.norm(d["vcps"][0] - d["vcps"][1], dim=-1).max()),
        "rot_deg": float(_rot_deg(out["R"], ref["R"]).max()),
        "t_m": float(torch.linalg.norm(d["t"][0] - d["t"][1], dim=-1).max()),
        "scores_m": float((d["scores"][0] - d["scores"][1]).abs().max()),
    }


def worst(per_call: List[Dict[str, float]]) -> Dict[str, float]:
    """The worst of each number over the calls (NaN if any is NaN; NaN if
    there are no calls)."""
    out = {}
    for name in NUMBERS:
        vals = [r[name] for r in per_call]
        out[name] = (float("nan") if not vals or any(math.isnan(v) for v in vals)
                     else max(vals))
    return out


def compare(reference, sample, batches) -> Dict[str, float]:
    """The worst numbers over the sampled calls: `sample` is a list of
    (batch index, outputs dict) and `batches` the pool's (src, tgt) batches;
    the reference registers each sampled batch again."""
    per_call = []
    for b, out in sample:
        ref = reference.register(*batches[b])
        per_call.append(readings({k: v.to(ref["R"].device) for k, v in out.items()}, ref))
    return worst(per_call)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}) for the numbers that have a
    limit: correct iff each is finite and at most its limit."""
    checks = {name: {"value": numbers.get(name, float("nan")), "limit": limit}
              for name, limit in limits.items()}
    ok = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
