"""Annealing schedules for the SVGD repulsion term (port of
``sigsvgd_tpu/utils/schedulers.py``).

Each factory returns ``schedule(step) -> value``, a pure function of the
step (an int or a 0-d tensor); the value is an fp32 tensor on the step's
device.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def constant(value: float = 1.0) -> Schedule:
    def schedule(step):
        return torch.full((), value, dtype=torch.float32, device=_step(step).device)

    return schedule


def square_root(base: float) -> Schedule:
    """``ρ_t = ρ₀ (t+1)^(-1/2)``."""

    def schedule(step):
        return base * (_step(step) + 1.0) ** -0.5

    return schedule


def factor(base: float, gamma: float, minimum: float = 1e-7) -> Schedule:
    """``ρ_t = max(ρ_min, ρ₀ γ^t)``."""

    def schedule(step):
        return torch.clamp_min(base * gamma ** _step(step), minimum)

    return schedule


def cosine(base: float, target: float, final_step: int,
           warmup_steps: int = 0) -> Schedule:
    """Cosine anneal with a warm-up plateau:
    ``ρ_t = ρ_T + (ρ₀-ρ_T)/2 (1 + cos(π (t-warmup)/T))`` for
    ``warmup < t ≤ final_step``, ``ρ₀`` before and ``ρ_T`` after (the phase
    is divided by ``final_step``, as in the JAX package and its reference)."""

    def schedule(step):
        step = _step(step)
        phase = math.pi * (step - warmup_steps) / final_step
        mid = target + 0.5 * (base - target) * (1.0 + torch.cos(phase))
        val = torch.where(step <= warmup_steps, torch.full_like(mid, base), mid)
        return torch.where(step > final_step, torch.full_like(val, target), val)

    return schedule
