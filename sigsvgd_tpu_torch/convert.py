"""Carry state and weights across from the JAX package.

The flagship path has no learned weights: the robot comes from the URDF, the
scene from its tables and the occupancy is the exact SDF. What crosses there
is the DuSt controller state, taken out of a JAX ``DuStState`` as numpy
arrays. The arm-planning sweep's learned occupancy and self-collision models
cross as a flax ``ProbMLP``'s params, as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .controllers.dust import DuStState
from .inference.svgd import AdamState, SVGDState
from .models.learning.mlp import ProbMLP, ProbModel


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


def prob_model_from_numpy(params, features, device=None) -> ProbModel:
    """Port a flax ``ProbMLP``'s params (``{"Dense_i": {"kernel": [in, out],
    "bias": [out]}}``, numpy) of widths ``features``: each kernel becomes the
    transposed ``nn.Linear`` weight, each bias is copied."""
    in_dim = np.asarray(params["Dense_0"]["kernel"]).shape[0]
    module = ProbMLP(in_dim, features, device=resolve_device(device))
    module.load_flax_params(params)
    return ProbModel(module=module)
