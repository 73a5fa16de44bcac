"""Carry controller state across from the JAX package.

The flagship path has no learned weights: the robot comes from the URDF, the
scene from its tables and the occupancy is the exact SDF. What crosses is the
DuSt controller state, taken out of a JAX ``DuStState`` as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .controllers.dust import DuStState
from .inference.svgd import AdamState, SVGDState


def dust_state_from_numpy(pol_mean, prior_weights, adam_count, adam_mu,
                          adam_nu, step, device=None) -> DuStState:
    """Port ``DuStState`` from numpy arrays: ``pol_mean [n, H, a]``,
    ``prior_weights [n]``, optax Adam's ``count``/``mu``/``nu`` and the SVGD
    ``step``."""
    device = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=device)

    return DuStState(
        pol_mean=f32(pol_mean),
        prior_weights=f32(prior_weights),
        svgd_state=SVGDState(
            opt_state=AdamState(count=i32(adam_count), mu=f32(adam_mu),
                                nu=f32(adam_nu)),
            step=i32(step),
        ),
    )
