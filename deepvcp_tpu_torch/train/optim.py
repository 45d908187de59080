"""The optimizer of deepvcp_tpu/train/trainer.py::create_train_state, in
torch: optax's global-norm clip, then Adam (b1 0.9, b2 0.999, eps 1e-8)
with a constant or warmup-cosine learning rate.

optax evaluates the schedule at the count BEFORE the update, so under
warmup step 0 moves no parameter (its learning rate is 0); the train step
sets the Adam learning rate from `schedule(step)` before each update to
match."""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List

import torch

from deepvcp_tpu_torch.config import TrainConfig

ADAM_BETAS = (0.9, 0.999)  # optax.adam's defaults
ADAM_EPS = 1e-8


def warmup_cosine_decay(step: int, init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int, end_value: float) -> float:
    """optax.warmup_cosine_decay_schedule(...)(step): linear from init_value
    to peak_value over warmup_steps, then cosine to end_value at
    decay_steps (which counts the warmup), constant after."""
    if step < warmup_steps:
        frac = 1.0 - max(step, 0) / warmup_steps
        return (init_value - peak_value) * frac + peak_value
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"the cosine schedule needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")
    count = min(step - warmup_steps, span)
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = 0.5 * (1.0 + math.cos(math.pi * count / span))
    return peak_value * ((1.0 - alpha) * cosine + alpha)


def learning_rate_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """step -> learning rate, as create_train_state builds it."""
    if cfg.lr_schedule == "cosine":
        if cfg.total_steps <= 0:
            raise ValueError("lr_schedule='cosine' requires total_steps > 0")
        warmup = min(cfg.warmup_steps, max(cfg.total_steps // 10, 1))
        return lambda step: warmup_cosine_decay(
            step, 0.0, cfg.learning_rate, warmup, cfg.total_steps, cfg.learning_rate * 0.01)
    if cfg.lr_schedule == "constant":
        return lambda step: cfg.learning_rate
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def make_adam(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every entry (a 0-d
    tensor on the grads' device; no host sync)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: each g becomes (g / norm) *
    max_norm where norm >= max_norm, in that order (clip_grad_norm_ adds
    1e-6 to the norm and would not match). Returns the norm before the
    clip."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def load_adam_state(optimizer: torch.optim.Adam, model: torch.nn.Module,
                    state: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Install per-parameter Adam state keyed by parameter name (what
    convert.optax_adam_to_torch returns) into `optimizer`."""
    for name, p in model.named_parameters():
        optimizer.state[p] = {k: v.to(p.device) if k != "step" else v.clone()
                              for k, v in state[name].items()}
