"""Particle mixtures (port of ``sigsvgd_tpu/utils/distributions.py``).

Only the tuple the DuSt prior needs; sampling arrives with the resample roll
strategy (ROADMAP queue 1, M1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ParticleGMM(NamedTuple):
    """Equal-bandwidth mixture over particles (the DuSt policy prior)."""

    means: torch.Tensor  # [k, p]
    var: torch.Tensor  # scalar or [p]
    weights: torch.Tensor  # [k]
