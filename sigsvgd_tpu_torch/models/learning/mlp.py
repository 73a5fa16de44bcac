"""Learned collision models (port of ``sigsvgd_tpu/models/learning/mlp.py``):
small ReLU MLPs with a sigmoid head, ``R³ → [0, 1]`` (world-point occupancy
probability) and ``R^dof → [0, 1]`` (self-collision probability), trained
with class-weighted binary cross-entropy.

The layers are ``nn.Linear``: the JAX package's flax ``Dense`` layers are
plain XLA dots, not kernels of its own. Weights start in flax's
``lecun_normal`` / zero-bias form, drawn from a ``torch.Generator``; a
checkpoint is ``torch.save`` of the state dict with ``in_dim`` and
``features``. Training is a Python loop over the steps, where JAX scans.
"""
from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..._device import resolve_device
from ...inference.svgd import Adam

# flax's truncated-normal variance scaling: the unit normal truncated to
# [-2, 2] has this standard deviation
_TRUNC_STD = 0.87962566103423978


class ProbMLP(nn.Module):
    """ReLU MLP of widths ``features`` and a 1-wide head (a sigmoid unless
    ``logits=True``)."""

    def __init__(self, in_dim: int, features: Sequence[int] = (200,) * 5,
                 device=None):
        super().__init__()
        self.in_dim = int(in_dim)
        self.features = tuple(int(f) for f in features)
        widths = (self.in_dim,) + self.features + (1,)
        # no default init: it would draw from torch's global generator
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, a, b, device=device)
            for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor, logits: bool = False) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        x = self.layers[-1](x)
        return x if logits else torch.sigmoid(x)

    def init_lecun_normal(self, generator: torch.Generator) -> None:
        """flax ``Dense``'s defaults: weights truncated-normal with variance
        ``1/fan_in``, biases zero."""
        with torch.no_grad():
            for layer in self.layers:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                layer.bias.zero_()

    def load_flax_params(self, params) -> None:
        """Copy a flax ``ProbMLP``'s params (numpy, ``Dense_i/kernel [in,
        out]`` and ``bias [out]``) into the layers (``weight [out, in]``)."""
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                p = params[f"Dense_{i}"]
                layer.weight.copy_(torch.tensor(np.asarray(p["kernel"], np.float32)).T)
                layer.bias.copy_(torch.tensor(np.asarray(p["bias"], np.float32)))


@dataclasses.dataclass(frozen=True, eq=False)
class ProbModel:
    """A trained probability model: ``model(x) -> [..., 1]``. When it came
    from :func:`train_prob_model`, ``epoch_losses`` holds each epoch's mean
    loss and ``train_wall_s`` the training's wall seconds."""

    module: ProbMLP
    epoch_losses: Optional[np.ndarray] = None
    train_wall_s: Optional[float] = None

    @property
    def device(self) -> torch.device:
        return self.module.layers[0].weight.device

    def __call__(self, x, logits: bool = False) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return self.module(x, logits=logits)

    def save(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save({"in_dim": self.module.in_dim, "features": list(self.module.features),
                    "state_dict": self.module.state_dict()}, path)

    @staticmethod
    def load(path, in_dim: Optional[int] = None, features=None, device=None) -> "ProbModel":
        blob = torch.load(path, map_location="cpu", weights_only=True)
        if in_dim is not None and int(in_dim) != blob["in_dim"]:
            raise ValueError(f"{path} holds a model of in_dim {blob['in_dim']}, not {in_dim}")
        if features is not None and tuple(features) != tuple(blob["features"]):
            raise ValueError(f"{path} holds features {blob['features']}, not {features}")
        module = ProbMLP(blob["in_dim"], blob["features"], device=resolve_device(device))
        module.load_state_dict(blob["state_dict"])
        return ProbModel(module=module)


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``."""
    return (-labels * nn.functional.logsigmoid(logits)
            - (1.0 - labels) * nn.functional.logsigmoid(-logits))


def train_prob_model(generator: Optional[torch.Generator], inputs, labels, *,
                     features: Sequence[int] = (200,) * 5, batch_size: int = 4096,
                     epochs: int = 20, lr: float = 1e-3,
                     pos_weight: Optional[float] = None, log_every: int = 0,
                     device=None, init_params=None, indices=None) -> ProbModel:
    """Class-weighted BCE training with optax's ``adam(lr)``:
    ``epochs × max(n // batch_size, 1)`` steps, each on ``batch_size``
    indices drawn with replacement. ``pos_weight=None`` weights the positive
    class by the inverse frequency ``(1 - p)/p``. ``generator`` (on
    ``device``) draws the initial weights and the indices; ``init_params``
    (numpy, flax's layout) and ``indices`` (``[n_steps, batch_size]``) take
    their place when given."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    labels_np = np.asarray(torch.as_tensor(labels).cpu(), np.float32).reshape(-1)
    x_dev = torch.as_tensor(np.asarray(torch.as_tensor(inputs).cpu(), np.float32),
                            device=device)
    y_dev = torch.as_tensor(labels_np, device=device)
    n = x_dev.shape[0]
    if pos_weight is None:
        pos_frac = max(labels_np.mean(), 1e-6)
        pos_weight = float((1.0 - pos_frac) / pos_frac)

    module = ProbMLP(x_dev.shape[1], features, device=device)
    if init_params is not None:
        module.load_flax_params(init_params)
    elif generator is None:
        raise ValueError("train_prob_model draws its initial weights: pass a "
                         "generator or init_params")
    else:
        module.init_lecun_normal(generator)

    steps_per_epoch = max(n // batch_size, 1)
    n_steps = epochs * steps_per_epoch
    if indices is None:
        if generator is None:
            raise ValueError("train_prob_model draws its batches: pass a generator "
                             "or indices")
        indices = torch.randint(0, n, (n_steps, batch_size), generator=generator,
                                device=device)
    if not isinstance(indices, torch.Tensor):
        indices = torch.tensor(np.asarray(indices))
    indices = indices.to(device=device, dtype=torch.long)
    if tuple(indices.shape) != (n_steps, batch_size):
        raise ValueError(f"indices must be [{n_steps}, {batch_size}], got "
                         f"{list(indices.shape)}")

    params = list(module.parameters())
    adam = Adam(lr)
    states = [adam.init(p.detach()) for p in params]
    losses = []
    for step in range(n_steps):
        idx = indices[step]
        xb, yb = x_dev[idx], y_dev[idx]
        logits = module(xb, logits=True)[..., 0]
        w = torch.where(yb > 0.5, torch.full_like(yb, pos_weight), torch.ones_like(yb))
        loss = torch.mean(w * _bce_with_logits(logits, yb))
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                upd, states[i] = adam.update(g, states[i])
                p.add_(upd)
        losses.append(loss.detach())
    epoch_losses = (torch.stack(losses).reshape(epochs, steps_per_epoch).mean(1)
                    .cpu().numpy())
    if log_every:
        for e in range(0, epochs, log_every):
            print(f"epoch {e + 1}: loss {epoch_losses[e]:.4f}")
    return ProbModel(module=module, epoch_losses=epoch_losses,
                     train_wall_s=time.perf_counter() - t0)
